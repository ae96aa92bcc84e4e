"""The port's GEMM surface against the JAX package's.

On the CPU the port's `tiled_matmul` runs its plain version; the JAX side
runs the Pallas kernel in interpret mode and its `matmul_ref` oracle. The
same inputs, made from a seed with numpy, go into both. Tolerances are those
of tests/test_tiled_matmul.py: f32 1e-5, bf16 2e-2 (one bf16 rounding of
the output). Across the two frameworks the f32 sums run in different orders,
which moves a result by about sqrt(K) * 2^-24 times the size of its partial
sums, so each absolute tolerance is taken relative to the output's largest
magnitude (never below its stated value).

The kernel itself runs only on the card: tests/test_torch_cuda.py holds it
against the plain version there.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import matmul_ref as jmatmul_ref
from repro.kernels.tiled_matmul import BlockConfig as JBlockConfig
from repro.kernels.tiled_matmul import tiled_matmul as jtiled_matmul
from repro_torch.kernels import ops
from repro_torch.kernels.tiled_matmul import (BlockConfig, DEFAULT_CONFIG,
                                              TILE_SHAPES, tiled_matmul)

jax.config.update("jax_enable_x64", False)

JSMALL = JBlockConfig(block_m=16, block_n=128, block_k=128)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(shape, dtype: str, seed: int):
    """The same seeded values as a JAX array and a CPU torch tensor."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype: str) -> dict:
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=1e-5, atol=1e-5))


def _check(got: torch.Tensor, jax_outs, tol: dict) -> None:
    for want in jax_outs:
        want = _np(want)
        scale = max(1.0, float(np.abs(want).max(initial=0.0)))
        np.testing.assert_allclose(_np(got), want, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "m,n,k",
    [(16, 128, 128), (32, 256, 256), (40, 200, 300), (1, 128, 512),
     (128, 1, 64), (17, 129, 257)],
)
def test_shapes_match_jax(m, n, k, dtype):
    (ja, ta), (jb, tb) = _pair((m, k), dtype, 0), _pair((k, n), dtype, 1)
    got = tiled_matmul(ta, tb)
    assert got.shape == (m, n) and got.dtype == TDT[dtype]
    _check(got, [jtiled_matmul(ja, jb, config=JSMALL, interpret=True),
                 jmatmul_ref(ja, jb)], _tol(dtype))


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)])
def test_layouts_match_jax(ta, tb):
    m, n, k = 48, 160, 96
    ja, a = _pair((k, m) if ta else (m, k), "float32", 2)
    jb, b = _pair((n, k) if tb else (k, n), "float32", 3)
    got = tiled_matmul(a, b, transpose_a=ta, transpose_b=tb)
    _check(got, [jtiled_matmul(ja, jb, config=JSMALL, transpose_a=ta,
                               transpose_b=tb, interpret=True),
                 jmatmul_ref(ja, jb, transpose_a=ta, transpose_b=tb)],
           _tol("float32"))


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (2.0, 0.0), (0.5, 0.5),
                                        (1.0, 1.0)])
def test_alpha_beta_match_jax(alpha, beta):
    m, n, k = 32, 128, 64
    (ja, a), (jb, b) = _pair((m, k), "float32", 4), _pair((k, n), "float32", 5)
    jc, c = _pair((m, n), "float32", 6)
    got = ops.gemm(a, b, c, alpha=alpha, beta=beta)
    _check(got, [jtiled_matmul(ja, jb, jc, config=JSMALL, alpha=alpha,
                               beta=beta, interpret=True),
                 jmatmul_ref(ja, jb, jc, alpha=alpha, beta=beta)],
           _tol("float32"))


def test_c_rounded_to_out_dtype_before_beta():
    """f32 C with a bf16 output: C is rounded to bf16 before the beta term,
    as the Pallas wrapper does (its `c.astype(out_dtype)`). A is zero, so
    the product is exact and the outputs can be compared bit for bit."""
    ja, a = jnp.zeros((16, 32), jnp.bfloat16), torch.zeros(16, 32,
                                                            dtype=torch.bfloat16)
    jb, b = _pair((32, 128), "bfloat16", 22)
    jc, c = _pair((16, 128), "float32", 23)
    got = tiled_matmul(a, b, c, beta=0.3)
    want = jtiled_matmul(ja, jb, jc, config=JSMALL, beta=0.3, interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    # rounding C only at the end would give other values
    assert (_np(got) != _np((0.3 * c).to(torch.bfloat16))).any()


def test_bf16_in_f32_out_matches_jax():
    (ja, a), (jb, b) = (_pair((32, 64), "bfloat16", 7),
                        _pair((64, 128), "bfloat16", 8))
    got = tiled_matmul(a, b, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _check(got, [jtiled_matmul(ja, jb, config=JSMALL, out_dtype=jnp.float32,
                               interpret=True),
                 jmatmul_ref(ja, jb, out_dtype=jnp.float32)],
           dict(rtol=2e-2, atol=2e-2))


def test_fp32_accumulation_not_bf16():
    """K large enough that bf16 accumulation would visibly drift."""
    k = 4096
    a = torch.full((8, k), 0.01, dtype=torch.bfloat16)
    b = torch.full((k, 128), 0.01, dtype=torch.bfloat16)
    got = tiled_matmul(a, b, out_dtype=torch.float32)
    x = np.float32(np.asarray(jnp.bfloat16(0.01), np.float32))
    np.testing.assert_allclose(_np(got), np.full((8, 128), k * x * x),
                               rtol=1e-3)
    want = jtiled_matmul(jnp.full((8, k), 0.01, jnp.bfloat16),
                         jnp.full((k, 128), 0.01, jnp.bfloat16),
                         config=JBlockConfig(8, 128, 512),
                         out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5)


@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (3, 70, 5), (70, 160, 200)])
def test_ragged_shapes_match_jax(m, n, k):
    (ja, a), (jb, b) = _pair((m, k), "float32", m + n), _pair((k, n),
                                                               "float32", k)
    got = tiled_matmul(a, b)
    _check(got, [jtiled_matmul(ja, jb, config=JBlockConfig(8, 128, 128),
                               interpret=True)], dict(rtol=1e-4, atol=1e-4))


class TestWrapperChecks:
    def test_contraction_mismatch_raises(self):
        with pytest.raises(ValueError, match="contraction"):
            tiled_matmul(torch.zeros(4, 8), torch.zeros(9, 4))

    def test_rank_raises(self):
        with pytest.raises(ValueError, match="rank-2"):
            tiled_matmul(torch.zeros(2, 4, 8), torch.zeros(8, 4))

    def test_beta_without_c_raises(self):
        with pytest.raises(ValueError, match="beta"):
            tiled_matmul(torch.zeros(4, 8), torch.zeros(8, 4), beta=1.0)

    def test_mixed_or_unsupported_dtypes_raise(self):
        with pytest.raises(TypeError):
            tiled_matmul(torch.zeros(4, 8), torch.zeros(8, 4,
                                                        dtype=torch.bfloat16))
        with pytest.raises(TypeError):
            tiled_matmul(torch.zeros(4, 8, dtype=torch.float16),
                         torch.zeros(8, 4, dtype=torch.float16))

    def test_cpu_path_does_not_count_launches(self):
        before = tiled_matmul.launches
        tiled_matmul(torch.ones(4, 8), torch.ones(8, 4))
        assert tiled_matmul.launches == before

    def test_block_config_shapes(self):
        assert DEFAULT_CONFIG.as_tuple() in TILE_SHAPES
        big = BlockConfig(128, 128, 32)
        # 128x40 + 32x136 bf16 tiles + 8 warps x 16x16 f32 staging
        assert big.smem_bytes() == 2 * (128 * 40 + 32 * 136) + 8192
        assert big.smem_bytes(4) == 4 * (128 * 33 + 32 * 128)
        assert all(BlockConfig(*t).smem_bytes() < 48 * 1024
                   for t in TILE_SHAPES)


class TestOps:
    def test_matmul_lead_dims_matches_jax(self):
        jx, x = _pair((2, 3, 64), "float32", 11)
        jw, w = _pair((64, 32), "float32", 12)
        y = ops.matmul(x, w)
        assert y.shape == (2, 3, 32)
        np.testing.assert_allclose(_np(y), _np(jops.matmul(jx, jw)),
                                   rtol=1e-5, atol=1e-5)

    def test_matmul_transpose_b_f32_out_matches_jax(self):
        jx, x = _pair((2, 5, 64), "bfloat16", 13)
        jw, w = _pair((96, 64), "bfloat16", 14)
        y = ops.matmul(x, w, transpose_b=True, out_dtype=torch.float32)
        assert y.shape == (2, 5, 96) and y.dtype == torch.float32
        want = jops.matmul(jx, jw, transpose_b=True, out_dtype=jnp.float32)
        np.testing.assert_allclose(_np(y), _np(want), rtol=1e-5, atol=1e-5)

    def test_linear_bias_matches_jax(self):
        jx, x = _pair((4, 16), "float32", 15)
        jw, w = _pair((16, 8), "float32", 16)
        jb, b = _pair((8,), "float32", 17)
        np.testing.assert_allclose(_np(ops.linear(x, w, b)),
                                   _np(jops.linear(jx, jw, jb)),
                                   rtol=1e-5, atol=1e-5)

    def test_matmul_contraction_mismatch_raises(self):
        with pytest.raises(ValueError):
            ops.matmul(torch.zeros(2, 3, 8), torch.zeros(9, 4))

    @pytest.mark.parametrize("max_len", [1, 6, 8, 16, 64, 100, 512, 4096])
    @pytest.mark.parametrize("grain", [8, 32])
    def test_buckets_match_jax(self, max_len, grain):
        assert ops.prefill_buckets(max_len, grain) == \
            jops.prefill_buckets(max_len, grain)
        for chunk in (1, 8, 24, 64, 256, 10_000):
            assert ops.chunk_buckets(max_len, chunk, grain) == \
                jops.chunk_buckets(max_len, chunk, grain)
