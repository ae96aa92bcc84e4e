"""The port on the card: the hand-written GEMM against its plain version,
and the smoke model and engine running through it.

Every test here needs an NVIDIA GPU and nvcc (the kernel builds at first
use) and skips elsewhere. Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.ref import matmul_ref
from repro_torch.kernels._build import load_library
from repro_torch.kernels.tiled_matmul import (_PATH_CODE, DEFAULT_CONFIG,
                                              BlockConfig, TILE_SHAPES, plan,
                                              tiled_matmul)
from repro_torch.models.bridge import params_from_numpy, params_to_numpy
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Request, ServingEngine

pytestmark = pytest.mark.cuda

# kernel vs plain version: f32 1e-5, bf16 2e-2 (the JAX package's kernel
# tests), absolute parts scaled by the output's largest magnitude since the
# two sum in different orders
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel runs only on the card")
    return torch.device("cuda")


def _assert_close(got, want, tol):
    scale = max(1.0, want.abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * scale)


FORCE = {"general": DEFAULT_CONFIG, "wgmma": BlockConfig(128, 128, 64),
         "stream": None}
# (path, m): shapes that land on each path; the fast paths take bf16 with
# untransposed operands, the general path every dtype and layout
PATH_CASES = ([("general", 70)]
              + [("stream", m) for m in (1, 5, 64)]
              + [("wgmma", m) for m in (65, 70, 200)])


def _path_of(fn):
    before = dict(tiled_matmul.launches_by_path)
    out = fn()
    torch.cuda.synchronize()
    moved = [p for p, n in tiled_matmul.launches_by_path.items()
             if n != before[p]]
    assert len(moved) == 1, moved
    return moved[0], out


def _cases():
    for path, m in PATH_CASES:
        layouts = ([(False, False), (False, True), (True, False), (True, True)]
                   if path == "general" else [(False, False)])
        dtypes = ([torch.float32, torch.bfloat16] if path == "general"
                  else [torch.bfloat16])
        for dtype in dtypes:
            for out_dtype in (torch.float32, torch.bfloat16):
                for ta, tb in layouts:
                    yield path, m, dtype, out_dtype, ta, tb


@pytest.mark.parametrize("path,m,dtype,out_dtype,ta,tb", list(_cases()))
def test_kernel_matches_plain_version(dev, path, m, dtype, out_dtype, ta, tb):
    n, k = 200, 296                 # ragged against every tile; K = 4.6 K
    g = torch.Generator(dev).manual_seed(0)   # tiles, split where few tiles
    a = torch.randn((k, m) if ta else (m, k), generator=g, device=dev)
    b = torch.randn((n, k) if tb else (k, n), generator=g, device=dev)
    c = torch.randn((m, n), generator=g, device=dev)
    a, b = a.to(dtype), b.to(dtype)
    before = tiled_matmul.launches
    took, got = _path_of(lambda: tiled_matmul(
        a, b, c, config=FORCE[path], transpose_a=ta, transpose_b=tb,
        alpha=0.5, beta=0.5, out_dtype=out_dtype))
    assert took == path
    assert tiled_matmul.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    want = matmul_ref(a, b, c.to(out_dtype), transpose_a=ta, transpose_b=tb,
                      alpha=0.5, beta=0.5, out_dtype=out_dtype)
    _assert_close(got, want, TOL[torch.bfloat16 if torch.bfloat16 in
                                 (dtype, out_dtype) else torch.float32])


@pytest.mark.parametrize("path", ["general", "stream", "wgmma"])
@pytest.mark.parametrize("m,n,k,view", [
    (64, 256, 512, False),      # contiguous, aligned: 16-byte vector tiles
    (70, 203, 293, True),       # views of wider rows: ragged last vectors
    (5, 152, 3584, False),      # decode-like: few rows, deep K, split K
    (8, 3584, 3584, False),     # a decode projection, split K
    (256, 3584, 3584, False),   # a chunk projection
])
def test_kernel_vector_tiles_match_plain_version(dev, path, m, n, k, view):
    if path == "stream" and m > 64:
        m = 64                  # the stream path holds at most 64 rows
    g = torch.Generator(dev).manual_seed(1)
    pad = (3, 5) if view else (0, 0)
    a = torch.randn((m, k + pad[0]), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((k, n + pad[1]), generator=g, device=dev).to(torch.bfloat16)
    # views keep row strides that are multiples of 8 while the shapes end
    # mid-vector
    a, b = a[:, :k], b[:, :n]
    assert a.stride(0) % 8 == 0 and b.stride(0) % 8 == 0
    cfg = FORCE[path] if path != "stream" or m > 64 else None
    took, got = _path_of(lambda: tiled_matmul(a, b, config=cfg,
                                              out_dtype=torch.float32))
    assert took == path
    want = matmul_ref(a, b, out_dtype=torch.float32)
    _assert_close(got, want, TOL[torch.bfloat16])


@pytest.mark.parametrize("m,n,k", [(4, 512, 3584), (8, 3584, 18944),
                                   (64, 200, 296), (128, 520, 3584),
                                   (512, 3584, 3584)])
def test_fast_paths_are_bit_identical_run_to_run(dev, m, n, k):
    """Split K is reduced in a fixed order: two launches on the same inputs
    give the same bits."""
    g = torch.Generator(dev).manual_seed(2)
    a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(
        torch.bfloat16)
    p = plan(m, n, k, a.stride(), b.stride(), 0, 0, a.dtype, a.dtype)
    assert p.path in ("stream", "wgmma")
    first = tiled_matmul(a, b)
    second = tiled_matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_kernel_rejects_uncompiled_tiles(dev):
    a = torch.ones(8, 8, device=dev)
    with pytest.raises(ValueError, match="not compiled"):
        tiled_matmul(a, a, config=BlockConfig(32, 32, 32))


def test_fast_tile_rejects_what_its_path_cannot_take(dev):
    a = torch.ones(8, 64, device=dev)      # f32: general only
    with pytest.raises(ValueError, match="general path"):
        tiled_matmul(a, a.T.contiguous(), config=BlockConfig(128, 128, 64))


def test_block_config_smem_matches_the_kernel(dev):
    lib = load_library()
    for tile in TILE_SHAPES:
        cfg = BlockConfig(*tile)
        have = lib.repro_tiled_matmul_smem(_PATH_CODE[cfg.path], 1, *tile)
        assert have == cfg.smem_bytes(), tile


def _smoke_pair(dev):
    """The f32 smoke model on the CPU and the same weights on the card."""
    cfg = get_config("qwen2-7b", smoke=True)
    api = get_model(cfg)
    cpu = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, api, cpu, params_from_numpy(params_to_numpy(cpu), cfg, dev)


def test_smoke_model_on_card_matches_cpu(dev):
    """Two chunk calls and two decode steps: every projection a kernel
    launch on the card, the plain version on the CPU. f32 logits agree to
    1e-4 (the bf16 KV cache can flip one entry by a bf16 step)."""
    cfg, api, cpu, gpu = _smoke_pair(dev)
    rng = np.random.default_rng(0)
    states = {d: api.init_state(cfg, 3, 32, device=d) for d in ("cpu", dev)}
    before = tiled_matmul.launches
    for step in range(2):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 8)))
        lens = torch.tensor([8, 3, 0])
        out = {}
        for d, p in (("cpu", cpu), (dev, gpu)):
            out[d], states[d] = api.prefill_chunk(p, toks.to(d), lens.to(d),
                                                  states[d], cfg)
        _assert_close(out[dev].cpu(), out["cpu"], 1e-4)
    for step in range(2):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, 3))
        for d, p in (("cpu", cpu), (dev, gpu)):
            out[d], states[d] = api.decode_step(p, tok.to(d), states[d], cfg)
        _assert_close(out[dev].cpu(), out["cpu"], 1e-4)
    torch.cuda.synchronize()
    assert tiled_matmul.launches - before == 4 * (7 * cfg.n_layers + 1)


def test_engine_on_card_launches_the_kernel(dev):
    cfg, api, _, gpu = _smoke_pair(dev)
    eng = ServingEngine(api, gpu, cfg, max_batch=2, max_len=64,
                        chunk_tokens=16, device=dev)
    rng = np.random.default_rng(1)
    for uid in range(5):
        eng.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab, int(rng.integers(4, 40))).astype(np.int32),
            max_new_tokens=6))
    before = tiled_matmul.launches
    res = eng.run_until_empty()
    rep = eng.report()
    assert sorted(r.uid for r in res) == list(range(5))
    assert all(r.n_tokens == 6 for r in res)
    assert tiled_matmul.launches - before == (7 * cfg.n_layers + 1) * (
        rep["chunk_steps"] + rep["decode_steps"])


def test_engine_bf16_launches_take_the_fast_paths(dev):
    """The smoke engine with bf16 weights and activations: every projection
    takes the stream or the wgmma path, none the general one."""
    cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    api = get_model(cfg)
    params = api.init(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    eng = ServingEngine(api, params, cfg, max_batch=4, max_len=256,
                        chunk_tokens=128, device=dev)
    rng = np.random.default_rng(2)
    for uid in range(6):
        eng.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab, int(rng.integers(40, 200))).astype(np.int32),
            max_new_tokens=4))
    before = dict(tiled_matmul.launches_by_path)
    res = eng.run_until_empty()
    torch.cuda.synchronize()
    moved = {p: tiled_matmul.launches_by_path[p] - before[p] for p in before}
    rep = eng.report()
    assert sorted(r.uid for r in res) == list(range(6))
    assert moved["general"] == 0
    assert moved["stream"] > 0 and moved["wgmma"] > 0
    assert moved["stream"] + moved["wgmma"] == (7 * cfg.n_layers + 1) * (
        rep["chunk_steps"] + rep["decode_steps"])


# ---------------------------------------------------------------------------
# the paper's loop on the card: scorer, runner, tuned launches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def h100_table():
    from repro_torch.core.profiler import collect_dataset

    return collect_dataset(n_configs=600, seed=0, chip="h100")


@pytest.mark.parametrize("model", ("rf", "gbdt", "linreg", "stacking"))
def test_torch_scorer_on_card_is_bit_identical_to_numpy(dev, h100_table,
                                                         model):
    """float64 on the card: every family, descaling, exp and residual
    anchors included, gives numpy `predict`'s bits."""
    from repro_torch.core.mlperf.torchpredict import TorchEstimator
    from repro_torch.core.predictor import PerfPredictor

    pred = PerfPredictor(model=model, residual=True, fast=True,
                         chip="h100").fit(h100_table)
    X = np.stack([h100_table[k] for k in pred.feature_names], axis=1)
    got = pred.torch_predictor(device=dev, x64=True)(X)
    assert got.is_cuda and got.dtype == torch.float64
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  pred.predict_matrix(h100_table))
    Xs = pred.scaler.transform(X)
    np.testing.assert_array_equal(
        TorchEstimator(pred.model, x64=True, device=dev).predict(Xs),
        np.asarray(pred.model.predict(Xs)).reshape(len(Xs), -1))


def test_card_measure_fn_times_each_compiled_tile(dev):
    """A valid row, timed, for every compiled tile on a layout its path
    takes; an invalid row, launching nothing, for tiles that cannot take
    the config."""
    from repro_torch.core.hwsim import GemmConfig
    from repro_torch.core.profiler import card_measure_fn, tile_stages

    measure = card_measure_fn(device=dev, reps=3)
    assert measure.power_source == "model"
    for tile in TILE_SHAPES:
        general = BlockConfig(*tile).path == "general"
        cfg = GemmConfig(m=min(tile[0], 64), n=512, k=1024, block_m=tile[0],
                         block_n=tile[1], block_k=tile[2],
                         dtype="f32" if general else "bf16",
                         layout="tn" if general else "nn", alpha=0.5,
                         beta=1.0, stages=tile_stages(tile))
        before = tiled_matmul.launches
        tel = measure(cfg)
        assert tel.valid and np.isfinite(tel.runtime_ms), tile
        assert 0.0 < tel.runtime_ms < 50.0
        assert tel.tflops == pytest.approx(
            2 * cfg.m * cfg.n * cfg.k / tel.runtime_ms / 1e9)
        assert np.isfinite(tel.power_w) and tel.power_w > 0
        assert tiled_matmul.launches - before == 4   # warm-up + 3 runs
    before = tiled_matmul.launches
    for bad in (GemmConfig(m=65, n=512, k=1024, block_m=64, block_n=64,
                           block_k=64),                     # stream, M > 64
                GemmConfig(m=128, n=512, k=1024, block_m=128, block_n=128,
                           block_k=64, layout="nt")):       # wgmma, B^T
        tel = measure(bad)
        assert not tel.valid and np.isnan(tel.runtime_ms)
    assert tiled_matmul.launches == before


def test_matmul_launches_the_installed_winner(dev, h100_table):
    from repro_torch.core.autotuner import GemmAutotuner, set_tuner
    from repro_torch.core.predictor import PerfPredictor
    from repro_torch.kernels import ops

    g = torch.Generator(dev).manual_seed(0)
    a = torch.randn((64, 3584), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((3584, 512), generator=g, device=dev) / 60).to(
        torch.bfloat16)
    try:
        # a winner forced into the table: plan would take stream here
        ops._TUNED[(64, 512, 3584, torch.bfloat16, "runtime")] = \
            BlockConfig(128, 64, 64)
        before = dict(tiled_matmul.launches_by_path)
        got = ops.matmul(a, w)
        torch.cuda.synchronize()
        assert tiled_matmul.launches_by_path["wgmma"] == before["wgmma"] + 1
        _assert_close(got, matmul_ref(a, w), TOL[torch.bfloat16])
        # a tuner's winner, verified on the card, installed and launched
        ops._TUNED.clear()
        pred = PerfPredictor(model="rf", residual=True, fast=True,
                             chip="h100").fit(h100_table)
        set_tuner(GemmAutotuner(pred, chip="h100", device=dev,
                                verify_top_k=2))
        best = ops.warm_gemm_cache([(64, 512, 3584)], strict=True)[
            (64, 512, 3584)]
        assert ops._tuned_config(64, 512, 3584, torch.bfloat16) == best
        before = dict(tiled_matmul.launches_by_path)
        ops.matmul(a, w)
        torch.cuda.synchronize()
        assert tiled_matmul.launches_by_path[best.path] == \
            before[best.path] + 1
    finally:
        ops._TUNED.clear()
        set_tuner(None)


def test_power_window_of_a_large_gemm_reads_the_card(dev):
    """NVML on the card: one power window of a large bf16 GEMM reads
    between the idle power and 1.1 x the enforced limit, the energy counter
    only grows, and the power runner tags its rows "nvml"."""
    from repro_torch.core import nvml
    from repro_torch.core.hwsim import GemmConfig
    from repro_torch.core.profiler import (card_measure_fn, graph_pump,
                                           probe_energy_period, time_ms)

    card = nvml.open_card(dev)
    limit = card.power_limit_w()
    assert 100.0 < limit <= 1000.0
    period = probe_energy_period(card, dev)
    assert 0.0 < period < 1.0
    reads = []

    def read():
        reads.append(card.energy_mj())
        return reads[-1]

    idle = nvml.measure_window(read, lambda: 0, period_s=period)
    g = torch.Generator(dev).manual_seed(0)
    a = torch.randn((4096, 4096), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((4096, 4096), generator=g, device=dev).to(torch.bfloat16)
    fn = lambda: tiled_matmul(a, b)
    ms = time_ms(fn, torch.empty(2 ** 28, dtype=torch.uint8, device=dev), 3)
    pump, per_unit = graph_pump(fn, ms)
    busy = nvml.measure_window(read, pump, period_s=period)
    torch.cuda.synchronize()
    assert 0.0 < idle.watts < busy.watts < 1.1 * limit
    assert busy.seconds >= nvml.window_seconds(period) - period
    assert busy.units * per_unit * ms / 1e3 > 0.9 * busy.seconds
    assert all(x <= y for x, y in zip(reads, reads[1:]))
    measure = card_measure_fn(device=dev, power=True, period_s=period)
    assert measure.power_source == "nvml"
    tel = measure(GemmConfig(m=2048, n=4096, k=4096, block_m=128,
                             block_n=256, block_k=64, stages=4))
    assert idle.watts < tel.power_w < 1.1 * limit
    assert tel.energy_j == pytest.approx(tel.power_w * tel.runtime_ms / 1e3)
    assert np.isfinite(tel.temperature_c) and not tel.launch_bound
