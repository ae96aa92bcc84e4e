"""Build the port's CUDA sources with nvcc at first use and load them.

Every ``csrc/*.cu`` is compiled to an object by its own nvcc, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), cached under
``build/repro_torch/`` at the root of the checkout by a hash of the sources
(``*.cu`` and the ``*.cuh`` they include) and flags, and loaded with ctypes.
Nothing is built at import time: the first kernel launch calls
`load_library`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
# name -> (argtypes, restype); every pointer and the stream are c_void_p, or
# ctypes would pass them as 32-bit ints
_SIGNATURES = {
    # (a, b, c_in, out, M, N, K, sam, sak, sbk, sbn, scm, scn, alpha, beta,
    #  in_dtype, out_dtype, path, bm, bn, bk, splits, segments, b_nk, a_mn,
    #  split_of, s_plane, workspace, counters, stream) -> cudaError_t
    "repro_tiled_matmul": ([_P] * 4 + [_I64] * 9 + [_F32] * 2 + [_I32] * 11
                           + [_I64] + [_P] * 3, _I32),
    # (src, R, C, sr, sc, out, ld, plane, stream) -> cudaError_t
    "repro_split3": ([_P] + [_I64] * 4 + [_P] + [_I64] * 2 + [_P], _I32),
    # (path, in_dtype, bm, bn, bk) -> shared memory bytes of one block, or -1
    "repro_tiled_matmul_smem": ([_I32] * 5, _I32),
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """Where the library is, and what building it cost (0 s when cached)."""

    path: Path
    built: bool
    seconds: float
    log: str


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path() -> Path:
    """The cached library's path for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def _run(procs) -> str:
    """Wait for every (command, process); the output of all, or raise with
    the first that failed."""
    log, failed = "", None
    for cmd, proc in procs:
        out, err = proc.communicate()
        log += out + err
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                      f"{out}{err}")
    if failed:
        raise RuntimeError(failed)
    return log


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` into the cached library unless it exists: one
    nvcc per source, in parallel, then one link.

    The library is written to a temporary name and renamed into place, so
    concurrent builders never load a half-written file."""
    path = library_path()
    if path.exists():
        return BuildInfo(path, False, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in _sources():
            obj = str(Path(tmpdir) / f"{src.stem}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        log = _run(procs)
        tmp = str(Path(tmpdir) / path.name)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
        log += _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, path)
    return BuildInfo(path, True, time.perf_counter() - t0, log)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's C types."""
    lib = ctypes.CDLL(str(build().path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
