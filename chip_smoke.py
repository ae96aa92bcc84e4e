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
   product through `matmul_ref`;
8. the paper's loop on the card: profile the compiled tiles over the H100
   sweep with CUDA events (`profiler.card_measure_fn`), fit the Random
   Forest predictor (the JAX package's tuner mode: residual on the roofline
   anchor) on the paper's 2,076-row split and report its held-out runtime
   R2 and errors, hold the float64 torch scorer on the card against numpy
   `predict` bit for bit, tune the serving engine's GEMM fleet with the
   predictor (every candidate verified on the card), time every serving
   shape at its tuned tile, `plan`'s tile and the general path, and serve
   the same 10 requests with
   `ServingEngine(pretune=True)`: every launch on its tuned tile,
   full-width logits within phase 7's bounds;
9. the energy half of the loop: read the card through NVML (name, enforced
   power limit, idle power, the energy counter's period), measure a
   stratified sample of phase 8's rows for power (`card_measure_fn(
   power=True)`: whole counter periods of back-to-back launches), fit the
   Random Forest on 80% of them and hold its held-out power R2 (at least
   0.5) and median error beside the paper's, tune the serving fleet for
   energy (every candidate measured for power on the card) and give each
   serving shape's joules at its energy-tuned tile, `plan`'s tile and the
   general path, then serve the 10 requests with the energy-tuned and the
   runtime-tuned engine, each run metered by the energy counter: the
   engine's modelled J/token and model clock (the "h100" model) beside the
   measured J/token and mean power.

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
# phase 8: the paper's split needs 2,076 + 519 measured rows; a runtime R2
# below 0.8 on the held-out rows means the pipeline is broken (a broken one
# gives about 0). The paper's own figures (RTX 4070, its Table IV) are
# printed beside the card's, never in their place.
LOOP_MIN_ROWS = 2076 + 519
LOOP_MIN_R2 = 0.8
PAPER_RUNTIME_R2, PAPER_RUNTIME_MEAN_PCT = 0.98, 15.57
# phase 9: rows measured for power (fewer if the probed counter period would
# take the sweep past its budget), and the held-out power R2 below which the
# pipeline is broken (swapped columns or the simulator's power give about 0
# or below). The paper's power figures on its RTX 4070 are printed beside
# the card's.
POWER_ROWS = 1000
POWER_SWEEP_BUDGET_S = 540.0
POWER_MIN_R2 = 0.5
# the largest compute- and memory-bound rows are measured again over this
# many counter periods, beside their sweep window
LONG_WINDOW_PERIODS = 20
PAPER_POWER_R2, PAPER_POWER_MEDIAN_PCT = 0.78, 5.42
# a decode step's host issue time with the tuned lookup may not exceed
# plan's rule's by more than this factor (one dictionary hit per GEMM
# costs microseconds; per-call tuning would cost far more)
HOST_ISSUE_MAX_RATIO = 1.5
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
    """Serve 10 requests on full qwen2-7b; returns (engine, model API,
    params, cfg, the GEMM launches the run issued by (M, N, K, in dtype,
    out dtype, None), the launches per kernel path)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import ServingEngine

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
    shapes: collections.Counter = collections.Counter()
    by_path, _ = _serve_requests("serve", eng, cfg, shapes)
    _say(f"[serve] launches per path: stream {by_path['stream']}, wgmma "
         f"{by_path['wgmma']}, general {by_path['general']} (every bf16 "
         f"serving GEMM must take a fast path)")
    if (by_path["general"] != 0 or by_path["stream"] == 0
            or by_path["wgmma"] == 0):
        raise SystemExit(f"serving launches by path {by_path}: expected all "
                         "on stream and wgmma, none on general")
    return eng, api, params, cfg, shapes, by_path


def _requests(cfg) -> list:
    """The 10 requests every serving run answers: prompts of 16-300
    tokens, 8-32 new tokens each, from a seeded generator."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(0)
    prompt_lens = [16, 300, 45, 130, 64, 250, 23, 77, 190, 31]
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
                np.int32), max_new_tokens=int(rng.integers(8, 33)))
            for i, n in enumerate(prompt_lens)]


def _recording(log: collections.Counter):
    """A stand-in for `ops.tiled_matmul` that counts each launch under
    (M, N, K, in dtype, out dtype, the tile it was given) in `log`."""
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    def recording(a, b, c=None, **kw):
        k, n = b.shape[::-1] if kw.get("transpose_b") else b.shape
        cfg = kw.get("config")
        log[(a.shape[0], n, k, a.dtype, kw.get("out_dtype") or a.dtype,
             cfg.as_tuple() if cfg is not None else None)] += 1
        return tiled_matmul(a, b, c, **kw)

    return recording


def _serve_requests(tag: str, eng, cfg, log: collections.Counter) -> tuple:
    """Answer the 10 requests of `_requests` on `eng`, recording every GEMM
    launch in `log` (see `_recording`); the launch counters are set to 0
    just before the run and read just after. Checks every request finishes
    at its budget and the kernel launched 197 times per forward; returns
    (the launches per path, the results)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    reqs = _requests(cfg)
    for r in reqs:
        eng.submit(r)
    shapes: collections.Counter = collections.Counter()
    ops.tiled_matmul = _recording(shapes)
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
    log.update(shapes)
    rep = eng.report()
    per_forward = sum(_forward_gemms(cfg, 1, 1).values())
    forwards = rep["chunk_steps"] + rep["decode_steps"]
    _say(f"[{tag}] {rep['requests']} requests, {rep['generated_tokens']} "
         f"tokens, {rep['chunk_steps']} chunk steps, {rep['decode_steps']} "
         f"decode steps, wall {rep['wall_s']:.3f} s, "
         f"{rep['tokens_per_s']:.2f} tokens/s, mean TTFT "
         f"{statistics.mean(r.ttft_s for r in results):.3f} s, max TTFT "
         f"{max(r.ttft_s for r in results):.3f} s, slot occupancy "
         f"{rep['slot_occupancy']:.3f}, lane rebuilds {rep['lane_rebuilds']}")
    _say(f"[{tag}] kernel launches {launches} = {per_forward} x {forwards} "
         f"forwards? {launches == per_forward * forwards}")
    if (launches != per_forward * forwards or launches == 0
            or sum(by_path.values()) != launches):
        raise SystemExit("the serving path did not launch the kernel "
                         f"{per_forward} times per forward")
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
    return by_path, results


def phase_serving_shapes(dev, shapes) -> dict:
    """Hold the kernel against its plain version at every serving shape, on
    the path `plan` chooses and on the general path (the first version of
    the kernel, "v3"), and time both beside the plain version and
    torch.matmul. Returns {path: per-kernel JSON entry}, times summed over
    the serving run's launches of the shapes that took that path."""
    from repro_torch.core.profiler import time_ms
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
        m, n, k, in_dt, out_dt, _ = key
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
        kernel_ms = time_ms(lambda: tiled_matmul(a, b, out_dtype=out_dt),
                             flush, 10)
        v3_ms = time_ms(lambda: tiled_matmul(a, b, config=DEFAULT_CONFIG,
                                              out_dtype=out_dt), flush, 10)
        plain_ms = time_ms(lambda: matmul_ref(a, b, out_dtype=out_dt),
                            flush, 5)
        library_ms = time_ms(lambda: torch.matmul(a, b), flush, 10)
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
            t_ms = time_ms(lambda: tiled_matmul(a, b, config=cfg,
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


def _forward_fns(dev, eng, params, cfg, W: int, C: int, rng) -> tuple:
    """(decode, chunk): one decode step over the engine's full slot table
    at position 256, and one W x C chunk call, on tokens drawn from
    `rng`."""
    B = eng.max_batch
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

    return decode, chunk


def _untraced_ms(fn, runs: int = 5) -> tuple:
    """(device span, host issue time) of `fn` in ms, medians of `runs`
    after one warm-up: CUDA events around the run, and the host clock
    around the call alone."""
    fn()
    torch.cuda.synchronize()
    spans, hosts = [], []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        hosts.append(1e3 * (time.perf_counter() - t0))
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    return statistics.median(spans), statistics.median(hosts)


def phase_forwards(dev, eng, params, cfg) -> dict:
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
    decode, chunk = _forward_fns(dev, eng, params, cfg, W, C, rng)

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
        untraced[key] = _untraced_ms(fn)
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
        return untraced
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
    return untraced


def phase_logits(dev, eng, params, cfg, W: int = 16, tag: str = "logits",
                 log: collections.Counter | None = None) -> None:
    """One W x 64 chunk call at full width through the kernel, then with
    every product through `matmul_ref`; the kernel's launches are recorded
    in `log` (see `_recording`) when one is given."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    C = 64
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

    if log is not None:
        ops.tiled_matmul = _recording(log)
    try:
        got = run()
        ops.tiled_matmul = plain
        want = run()
    finally:
        ops.tiled_matmul = tiled_matmul
    rel = ((got - want).norm() / want.norm()).item()
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(got).all())
    _say(f"[{tag}] chunk call {W}x{C}: logits {tuple(got.shape)} "
         f"{got.dtype}, finite {finite}, relative L2 {rel:.3e} (max "
         f"{LOGITS_REL_L2_MAX:g}), top-1 agreement {top1:.3f} (min "
         f"{LOGITS_TOP1_MIN:g})")
    if (not finite or got.shape != (W, cfg.vocab) or rel > LOGITS_REL_L2_MAX
            or top1 < LOGITS_TOP1_MIN):
        raise SystemExit("full-width logits disagree with the plain version")


def phase_loop(dev, api, params, cfg, shapes, untraced) -> tuple:
    """The paper's loop on the card: profile, fit, score, tune, serve.
    Returns (the profiled table, the tuner, its runtime winners, the
    serving fleet)."""
    from repro_torch.core.autotuner import (H100_VERIFY_TOP_K, GemmAutotuner,
                                            set_tuner)
    from repro_torch.core.features import (features_matrix,
                                           graph_candidate_features)
    from repro_torch.core.hwsim import GemmConfig
    from repro_torch.core.predictor import PerfPredictor
    from repro_torch.core.profiler import (card_measure_fn,
                                           h100_sweep_configs, paper_split,
                                           profile_configs, tile_stages,
                                           time_ms)
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import (DEFAULT_CONFIG, TILE_PATHS,
                                                  TILE_SHAPES, plan,
                                                  tiled_matmul)
    from repro_torch.serving.engine import ServingEngine

    t_phase = time.perf_counter()
    # 1. profile the compiled tiles over the H100 sweep
    cfgs = h100_sweep_configs()
    t0 = time.perf_counter()
    table = profile_configs(cfgs, chip="h100",
                            measure_fn=card_measure_fn(device=dev))
    prof_s = time.perf_counter() - t0
    rows = len(table["runtime_ms"])
    per_path = collections.Counter(
        f"{TILE_PATHS[(int(a), int(b), int(c))]}/{d}" for a, b, c, d in zip(
            table["block_m"], table["block_n"], table["block_k"],
            table["dtype"]))
    rt = table["runtime_ms"]
    _say(f"[loop] profiled {len(cfgs)} configs of the H100 sweep in "
         f"{prof_s:.1f} s: {rows} valid rows ({len(cfgs) - rows} tiles "
         f"refused by plan); rows per path/dtype {dict(sorted(per_path.items()))};"
         f" runtime {rt.min():.4f}-{rt.max():.4f} ms, median "
         f"{np.median(rt):.4f}; power_source "
         f"{sorted(set(table['power_source']))}")
    if rows < LOOP_MIN_ROWS:
        raise SystemExit(f"{rows} valid rows, fewer than {LOOP_MIN_ROWS}")

    # 2. fit the paper's Random Forest (100 trees, depth 6) on the paper's
    # split, in the mode of the JAX package's tuner predictor: log targets
    # as residuals on a roofline anchor
    tr, te = paper_split(table)
    t0 = time.perf_counter()
    pred = PerfPredictor(model="rf", residual=True, chip="h100").fit(tr)
    fit_s = time.perf_counter() - t0
    rep = pred.evaluate(te)
    r2 = rep["runtime_ms"]["r2"]
    _say(f"[loop] Random Forest (100 trees, depth 6, residual=True) fitted "
         f"on {len(tr['runtime_ms'])} rows in {fit_s:.1f} s; held out "
         f"{len(te['runtime_ms'])} rows, runtime_ms: R2 {r2:.4f} (min "
         f"{LOOP_MIN_R2:g}), mean error "
         f"{rep['runtime_ms']['mean_pct_err']:.2f}%, median error "
         f"{rep['runtime_ms']['median_pct_err']:.2f}%; tflops R2 "
         f"{rep['tflops']['r2']:.4f} (the paper on the RTX 4070: R2 "
         f"{PAPER_RUNTIME_R2:g}, mean error {PAPER_RUNTIME_MEAN_PCT:g}%. "
         "Power and energy in this table are the simulator's; phase 9 "
         "measures power on the card)")
    if not r2 >= LOOP_MIN_R2:
        raise SystemExit(f"held-out runtime R2 {r2:.4f} < {LOOP_MIN_R2}")

    # 3. the float64 torch scorer on the card against numpy predict
    tuner = GemmAutotuner(pred, chip="h100", device=dev,
                          verify_top_k=H100_VERIFY_TOP_K)
    fleet = ops.serving_gemm_fleet(cfg, max_batch=4, max_len=512,
                                   chunk_tokens=64, lane_width=8)
    scorer = pred.torch_predictor(device=dev, x64=True)
    X_te = np.stack([te[k] for k in pred.feature_names], axis=1)
    same_te = np.array_equal(scorer(X_te).cpu().numpy(),
                             pred.predict_matrix(te))
    cands, X_c = tuner.candidate_table(512, 18944, 3584, "bf16")
    same_c = np.array_equal(
        scorer(X_c).cpu().numpy(), pred.predict_matrix(
            {k: X_c[:, i] for i, k in enumerate(pred.feature_names)}))
    stages = [tile_stages(t) for t in TILE_SHAPES]
    grid, _ = graph_candidate_features(fleet, TILE_SHAPES, "h100", "bf16",
                                       device=dev, stages=stages)
    want_grid = features_matrix(
        [GemmConfig(m=m, n=n, k=k, block_m=t[0], block_n=t[1],
                    block_k=t[2], stages=tile_stages(t))
         for m, n, k in fleet for t in TILE_SHAPES],
        chip="h100").reshape(grid.shape)
    same_grid = np.array_equal(grid.cpu().numpy(), want_grid)
    tuner.rank_in_graph(fleet)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tops, _ = tuner.rank_in_graph(fleet)
    rank_ms = 1e3 * (time.perf_counter() - t0)
    trace_tops = [[cands_[j] for j in
                   tuner.rank(cands_, features=X_)[:tuner.verify_top_k]]
                  for cands_, X_ in (tuner.candidate_table(m, n, k, "bf16")
                                     for m, n, k in fleet)]
    same_rank = tops == trace_tops
    _say(f"[loop] float64 torch scorer on the card vs numpy predict: "
         f"{len(X_te)} held-out rows bit-identical {same_te}; the "
         f"{len(cands)} candidates of (512, 18944, 3584) bit-identical "
         f"{same_c}; the feature grid of {len(fleet)} fleet shapes x "
         f"{len(TILE_SHAPES)} tiles bit-identical {same_grid}; "
         f"rank_in_graph over the fleet {rank_ms:.2f} ms, its top "
         f"{tuner.verify_top_k} equal to the trace-time ranking's "
         f"{same_rank}")
    if not (same_te and same_c and same_grid and same_rank):
        raise SystemExit("the torch scorer on the card disagrees with numpy")

    # 4. tune the serving fleet, timing every candidate on the card
    set_tuner(tuner)
    t0 = time.perf_counter()
    tuned = ops.warm_gemm_cache(fleet, strict=True)
    tune_s = time.perf_counter() - t0
    _say(f"[loop] tuned {len(tuned)} fleet shapes in {tune_s:.1f} s (top "
         f"{tuner.verify_top_k} of the ranking, every candidate, timed on "
         "the card per shape)")
    if sorted(tuned) != sorted(fleet):
        raise SystemExit("the tuner left fleet shapes untuned")
    g = torch.Generator(dev).manual_seed(4)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    sums = collections.Counter()
    _say("[tuned] M N K out launches plan_tile tuned_tile plan_ms tuned_ms "
         "general_ms")
    for key, count in sorted(shapes.items(), key=lambda kv: kv[0][:3]):
        m, n, k, in_dt, out_dt, _ = key
        a, b = _gemm_inputs(dev, g, m, n, k, in_dt)
        p = plan(m, n, k, a.stride(), b.stride(), a.data_ptr() % 16,
                 b.data_ptr() % 16, in_dt, out_dt)
        tiles = {"plan": None, "tuned": tuned[(m, n, k)],
                 "general": DEFAULT_CONFIG}
        ms = {}
        for name, conf in tiles.items():
            ms[name] = time_ms(lambda: tiled_matmul(
                a, b, config=conf, out_dtype=out_dt), flush, 10)
            sums[name] += count * ms[name]
        _say(f"[tuned] {m} {n} {k} {str(out_dt).split('.')[-1]} {count} "
             f"{p.path}{p.tile.as_tuple()} "
             f"{TILE_PATHS[tiles['tuned'].as_tuple()]}"
             f"{tiles['tuned'].as_tuple()} "
             + " ".join(f"{ms[t]:.4f}" for t in tiles))
    _say(f"[tuned] summed over the serving run's launches: tuned "
         f"{sums['tuned']:.2f} ms, plan's rule {sums['plan']:.2f} ms, the "
         f"general path {sums['general']:.2f} ms (general / tuned x"
         f"{sums['general'] / sums['tuned']:.2f}, plan / tuned x"
         f"{sums['plan'] / sums['tuned']:.3f})")

    # 5. serve the same requests with the tuned tiles
    eng = ServingEngine(api, params, cfg, max_batch=4, max_len=512,
                        chunk_tokens=64, pretune=True, device=dev)
    if any(eng.pretuned.get(s_) != tuned[s_] for s_ in fleet):
        raise SystemExit("the engine's pretuned tiles differ from the fleet's")
    log: collections.Counter = collections.Counter()
    by_path, _ = _serve_requests("tuned serve", eng, cfg, log)
    _say(f"[tuned serve] launches per path: {by_path}")
    phase_logits(dev, eng, params, cfg, W=8, tag="tuned logits", log=log)
    off = {key: c for key, c in log.items()
           if key[5] is None or key[5] != eng.pretuned.get(
               key[:3], DEFAULT_CONFIG).as_tuple()}
    _say(f"[tuned serve] {sum(log.values())} launches recorded over "
         f"{len(log)} (shape, tile) pairs; on a tile other than their "
         f"shape's tuned one: {sum(off.values())}")
    if off:
        raise SystemExit(f"launches off their tuned tile: {off}")
    decode, _ = _forward_fns(dev, eng, params, cfg, 8, 64,
                             np.random.default_rng(3))
    installed = dict(ops._TUNED)
    host = collections.defaultdict(list)
    for name in ("plan", "tuned", "tuned", "plan"):
        ops._TUNED.clear()
        if name == "tuned":
            ops._TUNED.update(installed)
        host[name].append(_untraced_ms(decode)[1])
    ops._TUNED.update(installed)
    ratio = statistics.median(host["tuned"]) / max(host["plan"])
    _say(f"[tuned serve] decode step untraced host issue (medians of 5, "
         f"in turns): tuned lookup {host['tuned'][0]:.2f}, "
         f"{host['tuned'][1]:.2f} ms; plan's rule {host['plan'][0]:.2f}, "
         f"{host['plan'][1]:.2f} ms; phase 6 {untraced['decode'][1]:.2f} ms;"
         f" tuned / slowest plan run {ratio:.3f} (max "
         f"{HOST_ISSUE_MAX_RATIO:g})")
    if ratio > HOST_ISSUE_MAX_RATIO:
        raise SystemExit("the tuned lookup slowed the decode step's issue")
    _say(f"[loop] phase 8 took {time.perf_counter() - t_phase:.1f} s on "
         f"{_nvidia_smi()}")
    return table, tuner, tuned, fleet


def _next_step(card) -> int:
    """The energy counter's value at its next step (raises after 5 s
    without one)."""
    first, t0 = card.energy_mj(), time.perf_counter()
    while (now := card.energy_mj()) == first:
        if time.perf_counter() - t0 > 5.0:
            raise SystemExit("the energy counter stopped stepping")
    return now


def _metered(card, fn):
    """(fn's result, joules, seconds): `fn` run from one step of the energy
    counter, and the card metered to the first step after it finished (so
    up to one counter period of idle tail is counted with it)."""
    start = _next_step(card)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    end = _next_step(card)
    return out, (end - start) / 1e3, time.perf_counter() - t0


def _long_window(dev, card, period: float, m: int, n: int, k: int,
                 tile: tuple, dtype: str):
    """One power window of `LONG_WINDOW_PERIODS` counter periods of a
    row-major (m, n, k) GEMM in `dtype` ("bf16" or "f32") at `tile`:
    whether a sweep row's short window reads the power the card holds."""
    from repro_torch.core import nvml
    from repro_torch.core.profiler import graph_pump, time_ms
    from repro_torch.kernels.tiled_matmul import BlockConfig, tiled_matmul

    a, b = _gemm_inputs(dev, torch.Generator(dev).manual_seed(5), m, n, k,
                        torch.float32 if dtype == "f32" else torch.bfloat16)

    def fn():
        return tiled_matmul(a, b, config=BlockConfig(*tile))

    ms = time_ms(fn, torch.empty(2 ** 28, dtype=torch.uint8, device=dev), 3)
    pump, _ = graph_pump(fn, ms)
    win = nvml.measure_window(card.energy_mj, pump, period_s=period,
                              periods=LONG_WINDOW_PERIODS)
    torch.cuda.synchronize()
    return win


def phase_energy(dev, api, params, cfg, shapes, table, tuner, runtime_won,
                 fleet) -> None:
    """The energy half of the paper's loop on the card: NVML, a power
    sweep, the power target, the energy objective, and serving joules,
    modelled against measured."""
    from repro_torch.core import nvml
    from repro_torch.core.chips import get_chip
    from repro_torch.core.predictor import PerfPredictor
    from repro_torch.core.profiler import (card_measure_fn, paper_split,
                                           power_sample, probe_energy_period,
                                           profile_configs)
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import (DEFAULT_CONFIG, TILE_PATHS,
                                                  plan)
    from repro_torch.serving.engine import ServingEngine

    t_phase = time.perf_counter()
    # 1. the card through NVML
    card = nvml.open_card(dev)
    limit = card.power_limit_w()
    t0 = time.perf_counter()
    for _ in range(10):
        card.energy_mj()
    read_ms = 1e3 * (time.perf_counter() - t0) / 10
    _say(f"[nvml] {card.name()} (PCI {card.key}): enforced power limit "
         f"{limit:.2f} W; nvidia-smi says {_nvidia_smi()}; "
         f"temperature {card.temperature_c():.0f} C; one energy-counter "
         f"read {read_ms:.2f} ms")
    torch.cuda.synchronize()
    period = probe_energy_period(card, dev)
    idle = nvml.measure_window(card.energy_mj, lambda: 0, period_s=period)
    _say(f"[nvml] energy counter period {1e3 * period:.2f} ms (median "
         f"step while a GEMM runs back to back); idle power "
         f"{idle.watts:.2f} W over {idle.seconds:.3f} s with nothing "
         f"running (the card warm from phases 1-8; NVML's own power "
         f"reading then {card.power_w():.2f} W); a power window lasts "
         f"{nvml.window_seconds(period):.3f} s after a warm-up of about "
         "one period")

    # 2. the power sweep: a stratified sample of phase 8's rows
    spec = get_chip("h100")
    row_s = (nvml.WINDOW_PERIODS + 1) * period + 0.05
    n = min(POWER_ROWS, int(POWER_SWEEP_BUDGET_S / row_s))
    sample = power_sample(table, n, seed=0)
    t0 = time.perf_counter()
    ptable = profile_configs(sample, chip="h100", measure_fn=card_measure_fn(
        device=dev, power=True, period_s=period))
    sweep_s = time.perf_counter() - t0
    pw, tc = ptable["power_w"], ptable["temperature_c"]
    lb = ptable["launch_bound"]
    per_path = collections.Counter(
        TILE_PATHS[(int(a), int(b), int(c))] for a, b, c in zip(
            ptable["block_m"], ptable["block_n"], ptable["block_k"]))
    _say(f"[power] measured {len(pw)} of {len(table['runtime_ms'])} rows "
         f"for power (stratified by path and M; {n} asked at about "
         f"{row_s:.2f} s a row) in {sweep_s:.1f} s; rows per path "
         f"{dict(sorted(per_path.items()))}; power {pw.min():.1f}-"
         f"{pw.max():.1f} W, median {np.median(pw):.1f} W; temperature "
         f"{np.nanmin(tc):.0f}-{np.nanmax(tc):.0f} C; busy share "
         f"{ptable['busy_share'].min():.3f}-{ptable['busy_share'].max():.3f},"
         f" {int(lb.sum())} rows flagged launch_bound (below 0.9); "
         f"{int((pw > limit).sum())} rows above the enforced limit of "
         f"{limit:g} W; power_source {sorted(set(ptable['power_source']))}")
    if set(ptable["power_source"]) != {"nvml"}:
        raise SystemExit("rows of the power table are not the card's")
    if len(pw) < 0.9 * n or not (np.isfinite(pw).all() and (pw > 0).all()):
        raise SystemExit("the power sweep lost rows or read no power")
    flops = ptable["m"] * ptable["n"] * ptable["k"]
    for bound, size, what in (("compute", flops, "2MNK"),
                              ("memory", ptable["bytes_accessed"], "bytes")):
        idx = np.flatnonzero(ptable["bound"] == bound)
        if not idx.size:
            _say(f"[power] no {bound}-bound row in the sample")
            continue
        i = idx[np.argmax(size[idx])]
        m, n, k = (int(ptable[d][i]) for d in "mnk")
        tile = tuple(int(ptable[f"block_{d}"][i]) for d in "mnk")
        long = _long_window(dev, card, period, m, n, k, tile,
                            str(ptable["dtype"][i]))
        _say(f"[power] largest {bound}-bound row (by {what}): {m}x{n}x{k} "
             f"{ptable['dtype'][i]} tile {tile} "
             f"{ptable['runtime_ms'][i]:.4f} ms at {pw[i]:.1f} W over "
             f"{nvml.WINDOW_PERIODS} counter periods, {long.watts:.1f} W over "
             f"{LONG_WINDOW_PERIODS} ({long.seconds:.2f} s) (the h100 spec's "
             f"estimates: idle {spec.idle_power_w:g} W, idle + mxu "
             f"{spec.idle_power_w + spec.mxu_power_w:g} W, idle + hbm "
             f"{spec.idle_power_w + spec.hbm_power_w:g} W)")

    # 3. the power target: the Random Forest on 80% of the measured rows
    tr, te = paper_split(ptable)
    t0 = time.perf_counter()
    pred = PerfPredictor(model="rf", residual=True, chip="h100").fit(tr)
    fit_s = time.perf_counter() - t0
    rep = pred.evaluate(te)
    r2 = rep["power_w"]["r2"]
    _say(f"[power] Random Forest (100 trees, depth 6, residual=True) fitted "
         f"on {len(tr['power_w'])} rows in {fit_s:.1f} s; held out "
         f"{len(te['power_w'])} rows: power_w R2 {r2:.4f} (min "
         f"{POWER_MIN_R2:g}), median error "
         f"{rep['power_w']['median_pct_err']:.2f}%, mean error "
         f"{rep['power_w']['mean_pct_err']:.2f}%; energy_j R2 "
         f"{rep['energy_j']['r2']:.4f}, median error "
         f"{rep['energy_j']['median_pct_err']:.2f}%; runtime_ms R2 "
         f"{rep['runtime_ms']['r2']:.4f} (the paper on the RTX 4070: power "
         f"R2 {PAPER_POWER_R2:g}, median error {PAPER_POWER_MEDIAN_PCT:g}%)")
    if not POWER_MIN_R2 <= r2 < 0.99999:
        raise SystemExit(f"held-out power R2 {r2:.4f} outside "
                         f"[{POWER_MIN_R2}, 1)")

    # 4. the energy objective: tune the fleet, every candidate measured for
    # power on the card
    t0 = time.perf_counter()
    won = ops.warm_gemm_cache(fleet, objective="energy", strict=True)
    tune_s = time.perf_counter() - t0
    flat, tel = tuner.last_verification
    measured = {(c.m, c.n, c.k, c.block_m, c.block_n, c.block_k):
                (tel["runtime_ms"][i], tel["power_w"][i], tel["energy_j"][i])
                for i, c in enumerate(flat)}
    differ = [s_ for s_ in fleet if won[s_] != runtime_won[s_]]
    _say(f"[energy] tuned {len(won)} fleet shapes for energy in "
         f"{tune_s:.1f} s ({len(flat)} candidates measured for power); "
         f"{len(differ)} shapes won by another tile than for runtime: "
         + "; ".join(f"{s_} {runtime_won[s_].as_tuple()}->"
                     f"{won[s_].as_tuple()}" for s_ in differ))
    if sorted(won) != sorted(fleet):
        raise SystemExit("the energy tuner left fleet shapes untuned")
    _say("[energy] M N K launches | tile ms W mJ/launch for: energy-tuned; "
         "plan's; general")
    sums = collections.Counter()
    for key, count in sorted(shapes.items(), key=lambda kv: kv[0][:3]):
        m, n, k, in_dt, out_dt, _ = key
        rule = plan(m, n, k, (k, 1), (n, 1), 0, 0, in_dt, in_dt).tile
        cols = []
        for name, tile in (("energy", won[(m, n, k)]), ("plan", rule),
                           ("general", DEFAULT_CONFIG)):
            got = measured.get((m, n, k, *tile.as_tuple()))
            if got is None:
                raise SystemExit(f"{(m, n, k)}: tile {tile.as_tuple()} was "
                                 "not measured for power")
            ms, watts, joules = got
            sums[name] += count * joules
            cols.append(f"{tile.as_tuple()} {ms:.4f} {watts:.1f} "
                        f"{1e3 * joules:.4f}")
        _say(f"[energy] {m} {n} {k} {count} | " + "; ".join(cols))
    _say(f"[energy] joules summed over the serving run's launches: "
         f"energy-tuned {sums['energy']:.3f} J, plan's tile "
         f"{sums['plan']:.3f} J, general path {sums['general']:.3f} J "
         f"(energy-tuned / plan {sums['energy'] / sums['plan']:.3f}, "
         f"general / energy-tuned {sums['general'] / sums['energy']:.2f})")

    # 5. serving joules, modelled against measured
    for objective, winners in (("energy", won), ("runtime", runtime_won)):
        tag = f"{objective} serve"
        eng = ServingEngine(api, params, cfg, max_batch=4, max_len=512,
                            chunk_tokens=64, pretune=True,
                            tune_objective=objective, device=dev)
        if any(eng.pretuned.get(s_) != winners[s_] for s_ in fleet):
            raise SystemExit(f"the {objective} engine's tiles differ from "
                             "the fleet's")
        log: collections.Counter = collections.Counter()
        (by_path, results), joules, secs = _metered(
            card, lambda: _serve_requests(tag, eng, cfg, log))
        srep = eng.report()
        toks = srep["generated_tokens"]
        off = {key: c for key, c in log.items()
               if key[5] is None or key[5] != eng.pretuned.get(
                   key[:3], DEFAULT_CONFIG).as_tuple()}
        attributed = sum(r.energy_j for r in results)
        _say(f"[{tag}] the h100 model: {srep['j_per_token']:.4f} J/token, "
             f"{srep['model_tokens_per_s']:.1f} tokens/s on the model clock,"
             f" mean TTFT {statistics.mean(r.ttft_model_s for r in results):.4f}"
             f" s on the model clock, {srep['energy_j']:.3f} J modelled "
             f"({srep['idle_energy_j']:.3f} J of it idle shares)")
        _say(f"[{tag}] the card (NVML): {joules:.3f} J over {secs:.3f} s "
             f"metered for {toks} tokens = {joules / toks:.4f} J/token, mean "
             f"power {joules / secs:.1f} W; measured / modelled J/token "
             f"{joules / toks / srep['j_per_token']:.2f}; launches per path "
             f"{by_path}, off their tuned tile {sum(off.values())}")
        if off:
            raise SystemExit(f"launches off their tuned tile: {off}")
        if not all(r.energy_j > 0 for r in results):
            raise SystemExit("a request was attributed no energy")
        if abs(srep["energy_j"] - attributed - srep["idle_energy_j"]) > \
                1e-9 * srep["energy_j"]:
            raise SystemExit("the report's joules are not the requests' "
                             "plus the idle shares")
    _say(f"[energy] phase 9 took {time.perf_counter() - t_phase:.1f} s on "
         f"{_nvidia_smi()}")


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
    eng, api, params, cfg, shapes, by_path = phase_serve(dev)
    entries = phase_serving_shapes(dev, shapes)
    untraced = phase_forwards(dev, eng, params, cfg)
    phase_logits(dev, eng, params, cfg)
    loop = phase_loop(dev, api, params, cfg, shapes, untraced)
    phase_energy(dev, api, params, cfg, shapes, *loop)
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
