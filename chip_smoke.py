#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout on a machine with an H100, the CUDA toolkit and a CUDA
build of PyTorch. Phases, each fatal on failure:

1. the card (nvidia-smi name and power limit, torch and CUDA versions);
2. build: the hand-written GEMM compiled from ``src/repro_torch/csrc`` by
   nvcc, with the seconds it took, ptxas's register/spill/shared-memory
   report per kernel, and each tile's shared memory held against
   `BlockConfig.smem_bytes`;
3. the kernel against its plain version (`matmul_ref`) on the card: the
   shapes, layouts, alpha/beta, bf16-in/f32-out and K=4096 cases of the
   JAX package's kernel tests plus the fast paths' boundary cases (M around
   8, 64 and 128, ragged N and K, split K), on every path that takes each
   case, with each fast-path result bit-identical over two launches;
4. serve: full-width, full-depth qwen2-7b with seeded random weights; the
   continuous-batching engine answers 10 requests (prompts of 16-300
   tokens, 8-32 new tokens); the kernel's launch counter must equal 197 x
   the chunk and decode forwards dispatched, every one of them on the
   stream or wgmma path and none on the general path;
5. every distinct GEMM shape the serving run issued, held against the plain
   version and timed: the kernel on the path `plan` chose, the general path
   at the same shape ("v3_ms", the first version of the kernel), the plain
   version and torch.matmul (a yardstick only; the port never calls it),
   beside the H100's bound for that shape, and the sums per path;
6. where a step's time goes: one decode step and one chunk call timed with
   CUDA events, then traced with torch.profiler (device idle share, in-step
   GEMM time, the largest non-GEMM kernels), and one traced engine run for
   the idle share of serving as a whole;
7. full-width logits of one chunk call, through the kernel and with every
   product through `matmul_ref`.

It prints a JSON line of per-kernel numbers and, last, the device line.
Without a GPU, or without the repository beside it, it exits non-zero.
"""

from __future__ import annotations

import collections
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a GEMM is the
# larger of its FLOPs over the tensor-core (bf16) or CUDA-core (f32) rate and
# its bytes (inputs read once, output written once) over the HBM rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
# kernel vs plain version: the tolerances of the JAX package's kernel tests;
# the absolute one is scaled by the output's largest magnitude, since the two
# sum in different orders and the error grows with the partial sums
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# full-width logits, kernel vs every product through matmul_ref: the two
# differ only in summation order inside each GEMM, but each GEMM output is
# rounded to bf16, so an order difference flips some outputs by one bf16
# step (2^-8 relative) and 28 layers carry that on. A wrong kernel gives a
# relative error near 1 and chance top-1 agreement.
LOGITS_REL_L2_MAX = 5e-2
LOGITS_TOP1_MIN = 0.75
# the kernels of csrc/tiled_matmul.cu: stream, wgmma, general (bf16, f32)
GEMM_KERNELS = ("gemm_stream_kernel", "gemm_wgmma_kernel", "gemm_bf16_kernel",
                "gemm_f32_kernel")


def _say(*parts) -> None:
    print(*parts, flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _close(got: torch.Tensor, want: torch.Tensor, in_dtype) -> tuple:
    """(max abs err, max rel err, ok) under the stated tolerance."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    tol = TOL[in_dtype]
    scale = max(1.0, want.abs().max().item()) if want.numel() else 1.0
    ok = bool((diff <= tol * scale + tol * want.abs()).all())
    rel = (diff / want.abs().clamp_min(1e-6)).max().item() if diff.numel() else 0.0
    return (diff.max().item() if diff.numel() else 0.0), rel, ok


def _bound_s(m: int, n: int, k: int, in_dtype, out_dtype) -> tuple:
    """(operations time, bytes time) of one GEMM at the card's peaks."""
    isz = torch.tensor([], dtype=in_dtype).element_size()
    osz = torch.tensor([], dtype=out_dtype).element_size()
    ops_s = 2.0 * m * n * k / PEAK_FLOPS[in_dtype]
    bytes_s = ((m * k + k * n) * isz + m * n * osz) / HBM_BYTES_PER_S
    return ops_s, bytes_s


def _time_ms(fn, flush: torch.Tensor, reps: int) -> float:
    """Median milliseconds of `fn` over `reps` runs, CUDA events, with the
    L2 cache flushed (a 256 MB write) before each run. A ~1 ms device sleep
    after the flush keeps the card busy while the host issues `fn`, so the
    host's time in the wrapper never shows up as idle time between the
    events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _forward_gemms(cfg, rows: int, head_rows: int) -> collections.Counter:
    """{(M, N, K, in dtype, out dtype): launches} of one forward over `rows`
    token rows that unembeds `head_rows` of them: q, k, v, o, up, gate and
    down per layer, then the f32-out LM head."""
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.hd, cfg.kv_heads * cfg.hd
    dt = getattr(torch, cfg.activation_dtype)
    out = collections.Counter()
    for n, k in ((q, d), (kv, d), (kv, d), (d, q), (f, d), (f, d), (d, f)):
        out[(rows, n, k, dt, dt)] += cfg.n_layers
    out[(head_rows, cfg.vocab, d, dt, torch.float32)] += 1
    return out


def _gemm_inputs(dev, g, m: int, n: int, k: int, dtype) -> tuple:
    """Random (M, K) activations and (K, N) weights scaled to O(1) outputs."""
    a = torch.randn((m, k), generator=g, device=dev).to(dtype)
    b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(dtype)
    return a, b


def phase_build() -> None:
    """Build the port's CUDA sources with nvcc (timed) and load them; print
    ptxas's registers, spills and static shared memory for every kernel,
    and check each compiled tile's shared memory against `BlockConfig`."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.tiled_matmul import (_PATH_CODE, BlockConfig,
                                                  TILE_SHAPES)

    info = _build.build()
    lib = _build.load_library()
    _say(f"[build] {info.path.name}: {'built' if info.built else 'cached'} "
         f"in {info.seconds:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, report in _ptxas_report(info.log):
        _say(f"[build]   {name}: {report}")
    wrong = []
    for tile in TILE_SHAPES:
        cfg = BlockConfig(*tile)
        for dt, code in ((torch.bfloat16, 1), (torch.float32, 0)):
            if code == 0 and cfg.path != "general":
                continue
            have = lib.repro_tiled_matmul_smem(_PATH_CODE[cfg.path], code,
                                               *tile)
            want = cfg.smem_bytes(torch.tensor([], dtype=dt).element_size())
            _say(f"[build] {cfg.path} tile {tile} {str(dt).split('.')[-1]}: "
                 f"{have} bytes of shared memory per block (BlockConfig "
                 f"says {want})")
            if have != want:
                wrong.append((tile, dt))
    if wrong:
        raise SystemExit(f"BlockConfig.smem_bytes disagrees with the kernel "
                         f"for {wrong}")


def _ptxas_report(log: str) -> list:
    """(kernel, "registers ...; spills ...") per compiled kernel from the
    `-Xptxas -v` log, with each mangled name cut to the kernel and its
    template arguments (output type, the integers, the vector-tile flag)."""
    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            base = re.search(r"gemm_\w+?_kernel", mangled)
            ints = re.findall(r"Li(\d+)E", mangled)
            name = (f"{base.group(0) if base else mangled}<"
                    f"{'bf16' if 'bfloat16' in mangled else 'f32'} out"
                    f"{''.join(',' + i for i in ints)}"
                    f"{',vector tiles' if 'Lb1E' in mangled else ''}>")
            spills = ""
        elif name and "spill" in line:
            spills = line.split(":", 1)[-1].strip()
        elif name and "registers" in line:
            out.append((name, line.split(":", 1)[-1].strip() + "; " + spills))
            name = None
    return out


def _run_path(fn, *args, **kw):
    """(path, result) of one tiled_matmul call: the path whose launch
    counter moved."""
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    before = dict(tiled_matmul.launches_by_path)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    moved = [p for p, n in tiled_matmul.launches_by_path.items()
             if n != before[p]]
    if len(moved) != 1:
        raise SystemExit(f"one call moved the path counters {moved}")
    return moved[0], out


def phase_kernel_cases(dev) -> None:
    """The JAX package's kernel-test cases and each path's boundary cases,
    kernel vs plain version, on every path and tile that takes the case:
    the path `plan` chooses, the general path forced, and every fast-path
    tile of `candidate_tiles` forced where `plan` chose a fast path. Each
    fast-path result must also be bit-identical over two launches."""
    from repro_torch.kernels.ref import matmul_ref
    from repro_torch.kernels.tiled_matmul import (DEFAULT_CONFIG,
                                                  candidate_tiles,
                                                  tiled_matmul)

    g = torch.Generator(dev).manual_seed(0)
    bf16 = torch.bfloat16

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cases = []   # (label, in dtype, kwargs for both functions, a, b, c)
    for dt in (torch.float32, bf16):
        for m, n, k in [(16, 128, 128), (32, 256, 256), (40, 200, 300),
                        (1, 128, 512), (128, 1, 64), (17, 129, 257)]:
            cases.append((f"shape {m}x{n}x{k} {dt}", dt, {},
                          rand((m, k), dt), rand((k, n), dt), None))
    for ta in (False, True):
        for tb in (False, True):
            m, n, k = 48, 160, 96
            cases.append((f"layout ta={ta} tb={tb}", torch.float32,
                          dict(transpose_a=ta, transpose_b=tb),
                          rand((k, m) if ta else (m, k), torch.float32),
                          rand((n, k) if tb else (k, n), torch.float32), None))
    for alpha, beta in [(2.0, 0.0), (0.5, 0.5), (1.0, 1.0)]:
        cases.append((f"alpha={alpha} beta={beta} with C", torch.float32,
                      dict(alpha=alpha, beta=beta),
                      rand((32, 64), torch.float32),
                      rand((64, 128), torch.float32),
                      rand((32, 128), torch.float32)))
    cases.append(("bf16 in, f32 out", bf16, dict(out_dtype=torch.float32),
                  rand((32, 64), bf16), rand((64, 128), bf16), None))
    cases.append(("bf16 in, bf16 out, f32 C, beta=0.3", bf16, dict(beta=0.3),
                  rand((16, 32), bf16), rand((32, 128), bf16),
                  rand((16, 128), torch.float32)))
    cases.append(("bf16 16-byte vector tiles 64x256x512", bf16, {},
                  rand((64, 512), bf16), rand((512, 256), bf16), None))
    cases.append(("bf16 views of 16-byte rows, ragged last vector", bf16, {},
                  rand((70, 296), bf16)[:, :293],
                  rand((293, 208), bf16)[:, :203], None))
    cases.append(("bf16 view off a 16-byte boundary", bf16, {},
                  rand((20, 136), bf16)[:, 1:129], rand((128, 72), bf16),
                  None))
    cases.append(("K=4096 f32", torch.float32, {},
                  rand((8, 4096), torch.float32),
                  rand((4096, 128), torch.float32), None))
    cases.append(("K=4096 bf16 0.01s, f32 out", bf16,
                  dict(out_dtype=torch.float32),
                  torch.full((8, 4096), 0.01, dtype=bf16, device=dev),
                  torch.full((4096, 128), 0.01, dtype=bf16, device=dev), None))
    # the fast paths' boundaries: M around the 8-row stream tiles, the
    # stream/wgmma threshold and the 128-row wgmma tile; N = 200 and 136
    # not a multiple of any tile; K = 296 (4.6 K tiles, split in 2) and
    # K = 40 (one short K tile); beta with C; f32 and bf16 out
    for m in (1, 4, 8, 63, 64, 65, 127, 128, 129):
        cases.append((f"edge M={m} N=200 K=296, alpha=0.5 beta=0.5 with f32 "
                      "C, f32 out", bf16,
                      dict(alpha=0.5, beta=0.5, out_dtype=torch.float32),
                      rand((m, 296), bf16), rand((296, 200), bf16),
                      rand((m, 200), torch.float32)))
    for m in (4, 65, 129):
        cases.append((f"edge M={m} N=136 K=40, bf16 out", bf16, {},
                      rand((m, 40), bf16), rand((40, 136), bf16), None))
    for m in (8, 128):
        cases.append((f"split-K M={m} N=520 K=3584, beta=1 with bf16 C", bf16,
                      dict(beta=1.0), rand((m, 3584), bf16),
                      rand((3584, 520), bf16), rand((m, 520), bf16)))
    failed, seen = [], collections.Counter()
    for label, dt, kw, a, b, c in cases:
        c_ref = c.to(kw.get("out_dtype") or a.dtype) if c is not None else c
        want = matmul_ref(a, b, c_ref, **kw)
        chosen, _ = _run_path(tiled_matmul, a, b, c, **kw)
        configs = [None, DEFAULT_CONFIG]
        if chosen != "general":
            configs += candidate_tiles(want.shape[0])
        for cfg in configs:
            path, got = _run_path(tiled_matmul, a, b, c, config=cfg, **kw)
            err, rel, ok = _close(got, want, dt)
            same = True
            if path != "general":
                same = torch.equal(got, _run_path(tiled_matmul, a, b, c,
                                                  config=cfg, **kw)[1])
            how = "chosen by plan" if cfg is None else f"forced {cfg.as_tuple()}"
            _say(f"[kernel {path}] {label} ({how}): max_abs {err:.3g} "
                 f"max_rel {rel:.3g} tol {TOL[dt]:g}"
                 f"{'' if path == 'general' else f', rerun bit-identical {same}'}"
                 f" {'ok' if ok and same else 'FAIL'}")
            seen[path] += 1
            if not (ok and same):
                failed.append((path, label))
    _say(f"[kernel] cases run per path: {dict(seen)}")
    if failed:
        raise SystemExit(f"kernel disagrees with its plain version: {failed}")
    if set(seen) != {"stream", "wgmma", "general"}:
        raise SystemExit(f"a path ran no case: {dict(seen)}")


def phase_serve(dev):
    """Serve 10 requests on full qwen2-7b; returns (engine, params, cfg,
    the GEMM shapes the run issued with their launch counts, the launches
    per kernel path)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config("qwen2-7b")
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    _say(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model},"
         f" heads {cfg.n_heads}/{cfg.kv_heads}, d_ff {cfg.d_ff}, vocab "
         f"{cfg.vocab}, {cfg.param_dtype}; {n_params / 1e9:.3f} B params, "
         f"{n_bytes / 1e9:.2f} GB, random init in "
         f"{time.perf_counter() - t0:.1f} s")
    eng = ServingEngine(api, params, cfg, max_batch=4, max_len=512,
                        chunk_tokens=64, device=dev)
    rng = np.random.default_rng(0)
    prompt_lens = [16, 300, 45, 130, 64, 250, 23, 77, 190, 31]
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
                np.int32), max_new_tokens=int(rng.integers(8, 33)))
            for i, n in enumerate(prompt_lens)]
    for r in reqs:
        eng.submit(r)

    # record the GEMM shapes the serving path issues; the launches are
    # counted by the kernel's own wrapper, reset just before the run
    shapes: collections.Counter = collections.Counter()

    def recording(a, b, c=None, **kw):
        k, n = b.shape[::-1] if kw.get("transpose_b") else b.shape
        shapes[(a.shape[0], n, k, a.dtype, kw.get("out_dtype") or a.dtype)] += 1
        return tiled_matmul(a, b, c, **kw)

    ops.tiled_matmul = recording
    try:
        tiled_matmul.launches = 0
        tiled_matmul.launches_by_path.update(
            dict.fromkeys(tiled_matmul.launches_by_path, 0))
        results = eng.run_until_empty()
        torch.cuda.synchronize()
        launches = tiled_matmul.launches
        by_path = dict(tiled_matmul.launches_by_path)
    finally:
        ops.tiled_matmul = tiled_matmul
    rep = eng.report()
    per_forward = sum(_forward_gemms(cfg, 1, 1).values())
    forwards = rep["chunk_steps"] + rep["decode_steps"]
    _say(f"[serve] {rep['requests']} requests, {rep['generated_tokens']} "
         f"tokens, {rep['chunk_steps']} chunk steps, {rep['decode_steps']} "
         f"decode steps, wall {rep['wall_s']:.3f} s, "
         f"{rep['tokens_per_s']:.2f} tokens/s, mean TTFT "
         f"{statistics.mean(r.ttft_s for r in results):.3f} s, max TTFT "
         f"{max(r.ttft_s for r in results):.3f} s, slot occupancy "
         f"{rep['slot_occupancy']:.3f}, lane rebuilds {rep['lane_rebuilds']}")
    _say(f"[serve] kernel launches {launches} = {per_forward} x {forwards} "
         f"forwards? {launches == per_forward * forwards}")
    if launches != per_forward * forwards or launches == 0:
        raise SystemExit("the serving path did not launch the kernel "
                         f"{per_forward} times per forward")
    _say(f"[serve] launches per path: stream {by_path['stream']}, wgmma "
         f"{by_path['wgmma']}, general {by_path['general']} (every bf16 "
         f"serving GEMM must take a fast path)")
    if (by_path["general"] != 0 or by_path["stream"] == 0
            or by_path["wgmma"] == 0 or sum(by_path.values()) != launches):
        raise SystemExit(f"serving launches by path {by_path}: expected all "
                         "on stream and wgmma, none on general")
    by_uid = {r.uid: r for r in results}
    if sorted(by_uid) != [r.uid for r in reqs]:
        raise SystemExit(f"requests unanswered: {sorted(by_uid)}")
    for r in reqs:
        res = by_uid[r.uid]
        budget = min(r.max_new_tokens, eng.max_len - len(r.prompt))
        if (res.n_tokens != budget or len(res.tokens) != budget
                or not ((0 <= res.tokens) & (res.tokens < cfg.vocab)).all()):
            raise SystemExit(f"request {r.uid}: {res.n_tokens} tokens, "
                             f"budget {budget}")
    return eng, params, cfg, shapes, by_path


def phase_serving_shapes(dev, shapes) -> dict:
    """Hold the kernel against its plain version at every serving shape, on
    the path `plan` chooses and on the general path (the first version of
    the kernel, "v3"), and time both beside the plain version and
    torch.matmul. Returns {path: per-kernel JSON entry}, times summed over
    the serving run's launches of the shapes that took that path."""
    from repro_torch.kernels.ref import matmul_ref
    from repro_torch.kernels.tiled_matmul import (DEFAULT_CONFIG,
                                                  candidate_tiles, plan,
                                                  tiled_matmul)

    g = torch.Generator(dev).manual_seed(1)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    tot: dict = collections.defaultdict(collections.Counter)
    worst: dict = collections.Counter()
    failed = []
    _say("[shapes] M N K out count path kernel_ms v3_ms plain_ms library_ms "
         "bound_ms bound_by bound/kernel library/kernel max_abs max_rel")
    for key, count in sorted(shapes.items(), key=lambda kv: kv[0][:3]):
        m, n, k, in_dt, out_dt = key
        a, b = _gemm_inputs(dev, g, m, n, k, in_dt)
        want = matmul_ref(a, b, out_dtype=out_dt)
        path, got = _run_path(tiled_matmul, a, b, out_dtype=out_dt)
        err, rel, ok = _close(got, want, in_dt)
        v3_ok = _close(tiled_matmul(a, b, config=DEFAULT_CONFIG,
                                    out_dtype=out_dt), want, in_dt)[2]
        torch.cuda.synchronize()
        worst[path] = max(worst[path], err)
        if not (ok and v3_ok):
            failed.append((m, n, k, path if not ok else "general"))
        del got, want
        kernel_ms = _time_ms(lambda: tiled_matmul(a, b, out_dtype=out_dt),
                             flush, 10)
        v3_ms = _time_ms(lambda: tiled_matmul(a, b, config=DEFAULT_CONFIG,
                                              out_dtype=out_dt), flush, 10)
        plain_ms = _time_ms(lambda: matmul_ref(a, b, out_dtype=out_dt),
                            flush, 5)
        library_ms = _time_ms(lambda: torch.matmul(a, b), flush, 10)
        ops_s, bytes_s = _bound_s(m, n, k, in_dt, out_dt)
        bound_ms = 1e3 * max(ops_s, bytes_s)
        _say(f"[shapes] {m} {n} {k} {str(out_dt).split('.')[-1]} {count} "
             f"{path} {kernel_ms:.4f} {v3_ms:.4f} {plain_ms:.4f} "
             f"{library_ms:.4f} {bound_ms:.4f} "
             f"{'operations' if ops_s > bytes_s else 'bytes'} "
             f"{bound_ms / kernel_ms:.3f} {library_ms / kernel_ms:.3f} "
             f"{err:.3g} {rel:.3g}")
        # every compiled fast tile that can take the shape, forced: the
        # candidates an autotuner would choose among
        sweep = []
        for cfg in candidate_tiles(m):
            p = plan(m, n, k, a.stride(), b.stride(), 0, 0, in_dt, out_dt,
                     config=cfg)
            ok = _close(tiled_matmul(a, b, config=cfg, out_dtype=out_dt),
                        matmul_ref(a, b, out_dtype=out_dt), in_dt)[2]
            if not ok:
                failed.append((m, n, k, cfg.as_tuple()))
            t_ms = _time_ms(lambda: tiled_matmul(a, b, config=cfg,
                                                 out_dtype=out_dt), flush, 10)
            sweep.append(f"{p.path} {cfg.as_tuple()} x{p.splits} {t_ms:.4f}")
        _say(f"[sweep] {m} {n} {k}: " + "; ".join(sweep))
        for t in (tot[path], tot["all"]):
            t["ms"] += count * kernel_ms
            t["v3_ms"] += count * v3_ms
            t["plain_ms"] += count * plain_ms
            t["library_ms"] += count * library_ms
            t["bound_ms"] += count * bound_ms
            t["ops_ms"] += count * 1e3 * ops_s
            t["bytes_ms"] += count * 1e3 * bytes_s
    if failed:
        raise SystemExit(f"kernel disagrees at serving shapes {failed}")
    entries = {}
    for path, t in sorted(tot.items()):
        _say(f"[shapes] summed over the serving run's launches ({path}): "
             f"kernel {t['ms']:.2f} ms, v3 (general path) {t['v3_ms']:.2f} "
             f"ms, plain {t['plain_ms']:.2f} ms, torch.matmul "
             f"{t['library_ms']:.2f} ms, bound {t['bound_ms']:.2f} ms "
             f"(operations {t['ops_ms']:.2f} ms, bytes {t['bytes_ms']:.2f} "
             "ms)")
        if path == "all":
            continue
        entries[path] = {
            "ms": t["ms"], "v3_ms": t["v3_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("operations" if t["ops_ms"] > t["bytes_ms"]
                         else "bytes"),
            "library_ms": t["library_ms"], "max_abs_err": worst[path]}
    _say(f"[shapes] fast paths against the general path over the serving "
         f"launches: {tot['all']['ms']:.2f} ms against "
         f"{tot['all']['v3_ms']:.2f} ms (x{tot['all']['v3_ms'] / tot['all']['ms']:.2f})")
    return entries


def _is_gemm(name: str) -> bool:
    """Whether a traced kernel is one of the hand-written GEMM's kernels."""
    return any(k in name for k in GEMM_KERNELS)


def _busy_us(intervals: list) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            busy += e - max(s, reach)
            reach = e
    return busy


def _trace(runs: list) -> dict:
    """Run each (label, fn) of `runs` in order under torch.profiler (host
    and device activity), each inside a `record_function` range and
    followed by a synchronisation. Returns {label: [one dict per run]}:
    window (range start to the run's last device event), host (the range's
    own length: the host's time to issue the run), busy (union of kernels,
    copies and sets), idle share, GEMM kernel time and count, kernel count,
    and device time per kernel name. An empty dict means the profiler saw
    no device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tags = [f"{label}#{i}" for i, (label, _) in enumerate(runs)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for tag, (_, fn) in zip(tags, runs):
            with record_function(tag):
                fn()
            torch.cuda.synchronize()
    path = ROOT / "build" / "chip_smoke_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    ranges = sorted((float(e["ts"]), float(e["dur"]), e["name"])
                    for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") in tags)
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"], e["cat"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not device or len(ranges) != len(tags):
        return {}
    out: dict = collections.defaultdict(list)
    for i, (ts, dur, tag) in enumerate(ranges):
        nxt = ranges[i + 1][0] if i + 1 < len(ranges) else float("inf")
        mine = [d for d in device if ts <= d[0] < nxt]
        if not mine:
            return {}
        window = max(d[1] for d in mine) - ts
        busy = _busy_us([d[:2] for d in mine])
        per_name = collections.Counter()
        for s, e, name, cat in mine:
            per_name[name if cat == "kernel" else cat] += e - s
        gemm = [d for d in mine if d[3] == "kernel" and _is_gemm(d[2])]
        out[tag.rsplit("#", 1)[0]].append(dict(
            window_ms=window / 1e3, host_ms=dur / 1e3, busy_ms=busy / 1e3,
            idle=1.0 - busy / window,
            gemm_ms=sum(e - s for s, e, *_ in gemm) / 1e3, n_gemm=len(gemm),
            n_kernels=sum(d[3] == "kernel" for d in mine),
            per_name=per_name))
    return out


def _short(name: str) -> str:
    """A kernel's demangled name cut to its template head."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0][-60:]


def phase_forwards(dev, eng, params, cfg) -> None:
    """Where a step's time goes. One decode step over the full slot table
    and one 8x64 chunk call, each timed without a profiler (CUDA-event
    span, host issue time) and then traced with torch.profiler, 3 runs
    each: per run, the device's busy time and idle share within the run's
    window, the in-step GEMM kernel time and count (197 expected), and the
    non-GEMM kernels that take the most time. Then an engine run (4
    requests of 64 prompt tokens, 8 new tokens each), untraced and then
    traced, gives the idle share of serving as a whole, host sampling and
    copies included. The profiler slows the host's issue, so each idle
    share is also given against the untraced span."""
    from repro_torch.serving.engine import Request

    B, W, C = eng.max_batch, 8, 64
    rng = np.random.default_rng(3)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, B), device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (W, C)), device=dev)
    lens = torch.full((W,), C, device=dev)
    dstate = eng.model.init_state(cfg, B, eng.max_len, device=dev)
    dstate["index"].fill_(256)
    cstate = eng.model.init_state(cfg, W, eng.max_len, device=dev)

    def decode():
        eng.model.decode_step(params, tok, dict(dstate), cfg)

    def chunk():
        eng.model.prefill_chunk(params, toks, lens, dict(cstate), cfg)

    def serve(first_uid):
        for uid in range(first_uid, first_uid + 4):
            eng.submit(Request(uid=uid, prompt=rng.integers(
                0, cfg.vocab, C).astype(np.int32), max_new_tokens=8))
        eng.run_until_empty()

    labels = {"decode": f"decode step, {B} slots at position 256",
              "chunk": f"chunk call {W}x{C}",
              "serve": "engine run, 4 requests x (64 prompt + 8 new) tokens"}
    untraced = {}
    for key, fn in (("decode", decode), ("chunk", chunk)):
        fn()
        torch.cuda.synchronize()
        spans, hosts = [], []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            hosts.append(1e3 * (time.perf_counter() - t0))
            end.record()
            end.synchronize()
            spans.append(start.elapsed_time(end))
        untraced[key] = (statistics.median(spans), statistics.median(hosts))
        _say(f"[forward] {labels[key]}, no profiler: device span "
             f"{untraced[key][0]:.2f} ms, host issue {untraced[key][1]:.2f} "
             f"ms (medians of 5)")
    t0 = time.perf_counter()
    serve(1000)
    torch.cuda.synchronize()
    untraced["serve"] = (1e3 * (time.perf_counter() - t0), None)
    _say(f"[forward] {labels['serve']}, no profiler: wall "
         f"{untraced['serve'][0]:.2f} ms")
    traced = _trace([("decode", decode)] * 3 + [("chunk", chunk)] * 3
                    + [("serve", lambda: serve(2000))])
    if not traced:
        _say("[trace] the profiler recorded no device activity: idle share "
             "and in-step GEMM time not measured")
        return
    for key, runs in traced.items():
        for r in runs:
            _say(f"[trace] {labels[key]}: window {r['window_ms']:.2f} ms, "
                 f"host issue {r['host_ms']:.2f} ms, device busy "
                 f"{r['busy_ms']:.2f} ms, idle share {r['idle']:.4f}, GEMM "
                 f"kernels {r['gemm_ms']:.2f} ms over {r['n_gemm']} launches "
                 f"({100 * r['gemm_ms'] / r['window_ms']:.1f}% of the "
                 f"window), {r['n_kernels']} kernels in all")
        total = sum((r["per_name"] for r in runs), collections.Counter())
        top = [(n, t) for n, t in total.most_common() if not _is_gemm(n)]
        _say(f"[trace] {labels[key]}: top non-GEMM device time per run: "
             + "; ".join(f"{_short(n)} {t / 1e3 / len(runs):.2f} ms"
                         for n, t in top[:6]))
        # the profiler slows the host, not the card: the traced busy time
        # over the untraced span is the idle share without the profiler
        busy = statistics.median(r["busy_ms"] for r in runs)
        _say(f"[trace] {labels[key]}: idle share without the profiler, 1 - "
             f"busy {busy:.2f} ms / untraced {untraced[key][0]:.2f} ms = "
             f"{1 - busy / untraced[key][0]:.4f}")
    per_forward = sum(_forward_gemms(cfg, 1, 1).values())
    for key in ("decode", "chunk"):
        if any(r["n_gemm"] != per_forward for r in traced[key]):
            raise SystemExit(f"the traced {key} forward did not launch the "
                             f"kernel {per_forward} times")


def phase_logits(dev, eng, params, cfg) -> None:
    """One chunk call at full width through the kernel, then with every
    product through `matmul_ref`."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    W, C = 16, 64
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (W, C)), device=dev)
    lens = torch.as_tensor(rng.integers(1, C + 1, W), device=dev)

    def run():
        state = eng.model.init_state(cfg, W, eng.max_len, device=dev)
        logits, _ = eng.model.prefill_chunk(params, toks, lens, state, cfg)
        torch.cuda.synchronize()
        return logits

    def plain(a, b, c=None, *, config=None, **kw):
        return matmul_ref(a, b, c, **kw)

    got = run()
    ops.tiled_matmul = plain
    try:
        want = run()
    finally:
        ops.tiled_matmul = tiled_matmul
    rel = ((got - want).norm() / want.norm()).item()
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(got).all())
    _say(f"[logits] chunk call {W}x{C}: logits {tuple(got.shape)} "
         f"{got.dtype}, finite {finite}, relative L2 {rel:.3e} (max "
         f"{LOGITS_REL_L2_MAX:g}), top-1 agreement {top1:.3f} (min "
         f"{LOGITS_TOP1_MIN:g})")
    if (not finite or got.shape != (W, cfg.vocab) or rel > LOGITS_REL_L2_MAX
            or top1 < LOGITS_TOP1_MIN):
        raise SystemExit("full-width logits disagree with the plain version")


def main() -> int:
    """Run every phase; returns the exit code."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = _nvidia_smi()
    _say(f"[card] {smi}; torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
         f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    phase_build()
    phase_kernel_cases(dev)
    eng, params, cfg, shapes, by_path = phase_serve(dev)
    entries = phase_serving_shapes(dev, shapes)
    phase_forwards(dev, eng, params, cfg)
    phase_logits(dev, eng, params, cfg)
    _say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    _say(_nvidia_smi())
    # one entry per path the serving run takes; the general path serves no
    # bf16 projection (phase 4 checks 0 launches there), and its time at the
    # same shapes is each entry's v3_ms
    _say(json.dumps({"kernels": [{
        "name": f"tiled_matmul[{path}]", "route": "cuda",
        "source": "src/repro_torch/csrc/tiled_matmul.cu",
        "replaces": "src/repro/kernels/tiled_matmul.py:57",
        "launches": by_path[path], **entries[path]}
        for path in ("stream", "wgmma")]}))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
