"""The port on the card: the hand-written GEMM against its plain version,
and the smoke model and engine running through it.

Every test here needs an NVIDIA GPU and nvcc (the kernel builds at first
use) and skips elsewhere. Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.ref import matmul_ref
from repro_torch.kernels.tiled_matmul import (BlockConfig, TILE_SHAPES,
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


@pytest.mark.parametrize("tile", TILE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)])
def test_kernel_matches_plain_version(dev, tile, dtype, out_dtype, ta, tb):
    m, n, k = 70, 200, 300          # ragged in every dimension
    g = torch.Generator(dev).manual_seed(0)
    a = torch.randn((k, m) if ta else (m, k), generator=g, device=dev)
    b = torch.randn((n, k) if tb else (k, n), generator=g, device=dev)
    c = torch.randn((m, n), generator=g, device=dev)
    a, b = a.to(dtype), b.to(dtype)
    before = tiled_matmul.launches
    got = tiled_matmul(a, b, c, config=BlockConfig(*tile), transpose_a=ta,
                       transpose_b=tb, alpha=0.5, beta=0.5,
                       out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    want = matmul_ref(a, b, c.to(out_dtype), transpose_a=ta, transpose_b=tb,
                      alpha=0.5, beta=0.5, out_dtype=out_dtype)
    _assert_close(got, want, TOL[torch.bfloat16 if torch.bfloat16 in
                                 (dtype, out_dtype) else torch.float32])


@pytest.mark.parametrize("tile", TILE_SHAPES)
@pytest.mark.parametrize("m,n,k,view", [
    (64, 256, 512, False),      # contiguous, aligned: 16-byte vector tiles
    (70, 203, 293, True),       # views of wider rows: ragged last vectors
    (5, 152, 3584, False),      # decode-like: few rows, deep K
])
def test_kernel_vector_tiles_match_plain_version(dev, tile, m, n, k, view):
    g = torch.Generator(dev).manual_seed(1)
    pad = (3, 5) if view else (0, 0)
    a = torch.randn((m, k + pad[0]), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((k, n + pad[1]), generator=g, device=dev).to(torch.bfloat16)
    # views keep row strides that are multiples of 8 while the shapes end
    # mid-vector
    a, b = a[:, :k], b[:, :n]
    assert a.stride(0) % 8 == 0 and b.stride(0) % 8 == 0
    got = tiled_matmul(a, b, config=BlockConfig(*tile), out_dtype=torch.float32)
    want = matmul_ref(a, b, out_dtype=torch.float32)
    _assert_close(got, want, TOL[torch.bfloat16])


def test_kernel_rejects_uncompiled_tiles(dev):
    a = torch.ones(8, 8, device=dev)
    with pytest.raises(ValueError, match="not compiled"):
        tiled_matmul(a, a, config=BlockConfig(32, 32, 32))


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
