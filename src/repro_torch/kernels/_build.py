"""Build the port's CUDA sources with nvcc at first use and load them.

Every ``csrc/*.cu`` is compiled into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), cached under
``build/repro_torch/`` at the root of the checkout by a hash of the sources
and flags, and loaded with ctypes. Nothing is built at import time: the
first kernel launch calls `load_library`.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
# name -> (argtypes, restype); every pointer and the stream are c_void_p, or
# ctypes would pass them as 32-bit ints
_SIGNATURES = {
    # (a, b, c_in, out, M, N, K, sam, sak, sbk, sbn, scm, scn, alpha, beta,
    #  in_dtype, out_dtype, bm, bn, bk, stream) -> cudaError_t
    "repro_tiled_matmul": ([_P] * 4 + [_I64] * 9 + [_F32] * 2 + [_I32] * 5
                           + [_P], _I32),
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
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` into the cached library unless it exists.

    The library is written to a temporary name and renamed into place, so
    concurrent builders never load a half-written file."""
    path = library_path()
    if path.exists():
        return BuildInfo(path, False, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildInfo(path, True, time.perf_counter() - t0,
                     proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's C types."""
    lib = ctypes.CDLL(str(build().path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
