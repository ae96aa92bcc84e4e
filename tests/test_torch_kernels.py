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
from repro_torch.kernels.tiled_matmul import (
    DEFAULT_CONFIG, GENERAL, SPREAD_MAX_CTAS, STREAM, TILE_SHAPES, WAVE_CTAS,
    WGMMA, BlockConfig, candidate_tiles, k_segments, plan, tiled_matmul)

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
        assert DEFAULT_CONFIG.path == GENERAL
        assert {BlockConfig(*t).path for t in TILE_SHAPES} == {
            GENERAL, STREAM, WGMMA}
        # general: 64x40 + 32x72 bf16 tiles + 8 warps x 16x16 f32 staging,
        # static and under 48 KB
        assert DEFAULT_CONFIG.smem_bytes() == 2 * (64 * 40 + 32 * 72) + 8192
        assert DEFAULT_CONFIG.smem_bytes(4) == 4 * (64 * 33 + 32 * 64)
        assert DEFAULT_CONFIG.smem_bytes() < 48 * 1024
        # stream: 4 stages of a 64x64 weight tile and a 64x64 activation
        # tile, plus the split flag: dynamic, above 48 KB
        assert BlockConfig(64, 64, 64).smem_bytes() == \
            4 * (64 * 64 + 64 * 64) * 2 + 16 > 48 * 1024
        assert BlockConfig(8, 64, 64).smem_bytes() == \
            4 * (64 * 64 + 8 * 64) * 2 + 16
        # wgmma: 1024-byte alignment slack, 4 stages of 128x64 A and 64x128
        # B, two mbarriers per stage and the flag
        big = BlockConfig(128, 128, 64)
        assert big.smem_bytes() == 1024 + 4 * (128 * 64 + 64 * 128) * 2 \
            + 4 * 16 + 16
        assert 48 * 1024 < big.smem_bytes() <= 227 * 1024
        assert BlockConfig(128, 128, 32).path is None

    def test_uncompiled_config_raises(self):
        with pytest.raises(ValueError, match="not compiled"):
            tiled_matmul(torch.ones(4, 8), torch.ones(8, 4),
                         config=BlockConfig(32, 32, 32))
        with pytest.raises(ValueError, match="not compiled"):
            _plan(4, 512, 3584, config=BlockConfig(128, 128, 32))
        with pytest.raises(ValueError, match="not compiled"):
            ops.matmul(torch.ones(2, 8), torch.ones(8, 4),
                       config=BlockConfig(16, 16, 16))


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


SIX_ARCHS = ("qwen2-7b", "qwen2.5-14b", "codeqwen1.5-7b", "starcoder2-3b",
             "olmoe-1b-7b", "deepseek-v2-236b")
QWEN2_7B_SERVING_NK = [(512, 3584), (3584, 3584), (18944, 3584),
                       (3584, 18944), (152064, 3584)]


def _plan(m, n, k, *, a_strides=None, b_strides=None, a_mod=0, b_mod=0,
          dtype=torch.bfloat16, out_dtype=torch.bfloat16, config=None):
    return plan(m, n, k, a_strides or (k, 1), b_strides or (n, 1), a_mod,
                b_mod, dtype, out_dtype, config=config)


class TestPlan:
    """`plan` is the path rule: a pure function of shapes, strides,
    alignment and dtypes, so it is held here on the CPU."""

    @pytest.mark.parametrize("n,k", QWEN2_7B_SERVING_NK)
    @pytest.mark.parametrize("m", [4, 8, 64, 128, 256, 512])
    def test_serving_shapes_take_a_fast_path_that_fills_the_card(self, m, n,
                                                                 k):
        p = _plan(m, n, k)
        assert p.path == (STREAM if m <= 64 else WGMMA)
        assert p.tile.path == p.path
        assert p.segments == k_segments(n, k)
        if p.path == STREAM:
            # one CTA per segment, and a wave of them
            assert p.splits == p.segments
            assert p.tiles(m, n) * p.splits >= WAVE_CTAS
        elif p.splits > 1:
            # wgmma spreads segments only over tiles under half a wave
            assert p.splits == p.segments
            assert p.tiles(m, n) < WAVE_CTAS // 2
            assert p.tiles(m, n) * p.splits <= SPREAD_MAX_CTAS
        else:
            # and walks them where the tiles cover half a wave, or where
            # spreading would take more than 4 waves of CTAs
            assert (p.tiles(m, n) >= WAVE_CTAS // 2
                    or p.tiles(m, n) * p.segments > SPREAD_MAX_CTAS)
        # every segment is at least 2 K tiles of 64 deep
        assert -(-k // p.tile.block_k) // p.segments >= 2
        if p.path == STREAM:
            assert p.tile.block_m >= m and (p.tile.block_m // 2 < m
                                            or p.tile.block_m == 8)

    def test_decode_k_v_keeps_more_than_100_ctas_busy(self):
        p = _plan(4, 512, 3584)
        assert p.tiles(4, 512) * p.splits > 100

    def test_the_lm_head_and_wide_shapes_need_no_split(self):
        assert _plan(4, 152064, 3584).splits == 1
        assert _plan(512, 18944, 3584).splits == 1

    @pytest.mark.parametrize("m,n,k,tile,splits", [
        # too few tiles for half a wave: the 64-wide tile, its 28 segments
        # spread over 224 CTAs
        (128, 512, 3584, (128, 64, 64), 28),
        # spreading would take more than 4 waves: one CTA walks the segments
        (128, 3584, 3584, (128, 64, 64), 1),
        (512, 512, 3584, (128, 64, 64), 1),
        # half a wave of 64-wide tiles: walked
        (256, 3584, 3584, (128, 64, 64), 1),
        # wide N covers a wave with wider tiles; two segments, so 128 x 128
        # where the rule would take 128 x 256
        (128, 18944, 3584, (128, 128, 64), 1),
        (256, 18944, 3584, (128, 128, 64), 1),
        (512, 18944, 3584, (128, 128, 64), 1),
        # one segment (the LM head): 128 x 256 stays
        (512, 152064, 3584, (128, 256, 64), 1),
        # bound by operations: no 64-wide tile; 112 128-wide tiles walked
        (512, 3584, 18944, (128, 128, 64), 1),
        (512, 3584, 3584, (128, 128, 64), 1),
    ])
    def test_wgmma_tile_rule(self, m, n, k, tile, splits):
        p = _plan(m, n, k)
        assert (p.path, p.tile.as_tuple(), p.splits) == (WGMMA, tile, splits)

    # plan's (path, tile, splits) for every serving shape of the other
    # dense configs: the chunked fleet (max_batch 4, max_len 512, chunk 64,
    # lane 8) and the serial one, by (N, K) and then M. A stream tile is
    # named by its rows, a wgmma tile (128 rows) by its width; splits are
    # the CTAs a tile's K segments are spread over (1: walked)
    OTHER_DENSE_PLANS = {
        "qwen2.5-14b": {
            (152064, 5120): {m: ("s", 8, 1) for m in (1, 2, 4, 8)},
            (1024, 5120): {4: ("s", 8, 33), 8: ("s", 8, 33),
                           16: ("s", 16, 33), 32: ("s", 32, 33),
                           64: ("s", 64, 33), 128: ("w", 64, 33),
                           256: ("w", 64, 1), 512: ("w", 128, 1),
                           2048: ("w", 128, 1)},
            (5120, 5120): {4: ("s", 8, 7), 8: ("s", 8, 7), 16: ("s", 16, 7),
                           32: ("s", 32, 7), 64: ("s", 64, 7),
                           128: ("w", 64, 1), 256: ("w", 64, 1),
                           512: ("w", 128, 1), 2048: ("w", 128, 1)},
            (5120, 13824): {4: ("s", 8, 7), 8: ("s", 8, 7),
                            16: ("s", 16, 7), 32: ("s", 32, 7),
                            64: ("s", 64, 7), 128: ("w", 64, 1),
                            256: ("w", 64, 1), 512: ("w", 128, 1),
                            2048: ("w", 128, 1)},
            (13824, 5120): {4: ("s", 8, 3), 8: ("s", 8, 3),
                            16: ("s", 16, 3), 32: ("s", 32, 3),
                            64: ("s", 64, 3), 128: ("w", 64, 1),
                            256: ("w", 128, 1), 512: ("w", 128, 1),
                            2048: ("w", 128, 1)},
        },
        "codeqwen1.5-7b": {
            (92416, 4096): {m: ("s", 8, 1) for m in (1, 2, 4, 8)},
            (4096, 4096): {4: ("s", 8, 9), 8: ("s", 8, 9), 16: ("s", 16, 9),
                           32: ("s", 32, 9), 64: ("s", 64, 9),
                           128: ("w", 64, 1), 256: ("w", 64, 1),
                           512: ("w", 128, 1), 2048: ("w", 128, 1)},
            (4096, 13440): {4: ("s", 8, 9), 8: ("s", 8, 9),
                            16: ("s", 16, 9), 32: ("s", 32, 9),
                            64: ("s", 64, 9), 128: ("w", 64, 1),
                            256: ("w", 64, 1), 512: ("w", 128, 1),
                            2048: ("w", 128, 1)},
            (13440, 4096): {4: ("s", 8, 3), 8: ("s", 8, 3),
                            16: ("s", 16, 3), 32: ("s", 32, 3),
                            64: ("s", 64, 3), 128: ("w", 64, 1),
                            256: ("w", 128, 1), 512: ("w", 128, 1),
                            2048: ("w", 128, 1)},
        },
        "starcoder2-3b": {
            (49152, 3072): {m: ("s", 8, 1) for m in (1, 2, 4, 8)},
            (256, 3072): {4: ("s", 8, 24), 8: ("s", 8, 24),
                          16: ("s", 16, 24), 32: ("s", 32, 24),
                          64: ("s", 64, 24), 128: ("w", 64, 24),
                          256: ("w", 64, 24), 512: ("w", 64, 24),
                          2048: ("w", 64, 1)},
            (3072, 3072): {4: ("s", 8, 11), 8: ("s", 8, 11),
                           16: ("s", 16, 11), 32: ("s", 32, 11),
                           64: ("s", 64, 11), 128: ("w", 64, 11),
                           256: ("w", 64, 1), 512: ("w", 128, 1),
                           2048: ("w", 128, 1)},
            (3072, 12288): {4: ("s", 8, 11), 8: ("s", 8, 11),
                            16: ("s", 16, 11), 32: ("s", 32, 11),
                            64: ("s", 64, 11), 128: ("w", 64, 11),
                            256: ("w", 64, 1), 512: ("w", 128, 1),
                            2048: ("w", 128, 1)},
            (12288, 3072): {4: ("s", 8, 3), 8: ("s", 8, 3),
                            16: ("s", 16, 3), 32: ("s", 32, 3),
                            64: ("s", 64, 3), 128: ("w", 64, 1),
                            256: ("w", 128, 1), 512: ("w", 128, 1),
                            2048: ("w", 128, 1)},
        },
    }

    @pytest.mark.parametrize("arch", sorted(OTHER_DENSE_PLANS))
    def test_other_dense_serving_shapes_take_their_pinned_plan(self, arch):
        """Every GEMM the chunked or serial engine issues for qwen2.5-14b,
        codeqwen1.5-7b and starcoder2-3b takes a fast path (the LM head
        with f32 out), none the general one, at the pinned tile and
        splits."""
        from repro_torch.configs import get_config

        cfg = get_config(arch)
        fleet = set(ops.serving_gemm_fleet(
            cfg, max_batch=4, max_len=512, chunk_tokens=64, lane_width=8))
        fleet |= set(ops.serving_gemm_fleet(cfg, max_batch=4, max_len=512))
        want = self.OTHER_DENSE_PLANS[arch]
        assert fleet == {(m, n, k) for (n, k), ms in want.items()
                         for m in ms}
        for m, n, k in sorted(fleet):
            out = torch.float32 if n == cfg.vocab else torch.bfloat16
            p = _plan(m, n, k, out_dtype=out)
            path, size, splits = want[(n, k)][m]
            assert p.path == {"s": STREAM, "w": WGMMA}[path], (m, n, k)
            assert p.tile.as_tuple() == ((size, 64, 64) if path == "s"
                                         else (128, size, 64)), (m, n, k)
            assert p.splits == splits, (m, n, k)
            assert p.segments == k_segments(n, k), (m, n, k)
            assert -(-k // p.tile.block_k) // p.segments >= 2

    def test_candidate_tiles(self):
        assert [t.as_tuple() for t in candidate_tiles(4)] == [
            (8, 64, 64), (128, 256, 64), (128, 128, 64), (128, 64, 64)]
        assert [t.as_tuple() for t in candidate_tiles(65)] == [
            (128, 256, 64), (128, 128, 64), (128, 64, 64)]
        for m in (1, 33, 64, 65, 512):
            for t in candidate_tiles(m):
                assert _plan(m, 3584, 3584, config=t).tile == t

    def test_f32_out_keeps_the_fast_path(self):
        assert _plan(4, 152064, 3584, out_dtype=torch.float32).path == STREAM

    @pytest.mark.parametrize("case", [
        "f32", "transpose_a", "transpose_b", "unaligned_a", "unaligned_b",
        "row_stride_a", "row_stride_b", "broadcast_rows", "k0"])
    def test_everything_else_takes_general(self, case):
        m, n, k = 8, 512, 3584
        kw = {
            "f32": dict(dtype=torch.float32, out_dtype=torch.float32),
            # op(A) of a (K, M) tensor: M-contiguous
            "transpose_a": dict(a_strides=(1, m)),
            # op(B) of an (N, K) tensor: K-contiguous
            "transpose_b": dict(b_strides=(1, k)),
            "unaligned_a": dict(a_mod=2),
            "unaligned_b": dict(b_mod=8),
            # a view of rows 3587 wide: not a multiple of 8 elements
            "row_stride_a": dict(a_strides=(3587, 1)),
            "row_stride_b": dict(b_strides=(515, 1)),
            "broadcast_rows": dict(a_strides=(0, 1)),
        }.get(case, {})
        p = _plan(m, n, 0 if case == "k0" else k, **kw)
        assert (p.path, p.tile, p.splits) == (GENERAL, DEFAULT_CONFIG, 1)

    def test_wrapper_strides_route_transposes_to_general(self):
        """The wrapper hands `plan` op(A)'s and op(B)'s strides; transposed
        operands of contiguous tensors are not K- or N-contiguous there."""
        a = torch.zeros(3584, 8, dtype=torch.bfloat16)        # (K, M)
        b = torch.zeros(512, 3584, dtype=torch.bfloat16)      # (N, K)
        assert plan(8, 512, 3584, a.stride()[::-1], (512, 1), 0, 0,
                    a.dtype, a.dtype).path == GENERAL
        assert plan(8, 512, 3584, (3584, 1), b.stride()[::-1], 0, 0,
                    a.dtype, a.dtype).path == GENERAL
        view = torch.zeros(70, 296, dtype=torch.bfloat16)[:, 1:294]
        assert view.stride() == (296, 1)      # aligned stride, odd base:
        assert plan(70, 64, 293, view.stride(), (64, 1),        # general
                    view.storage_offset() * 2 % 16, 0, view.dtype,
                    view.dtype).path == GENERAL

    def test_views_of_16_byte_rows_take_the_fast_paths(self):
        """A [:, :293] view of 296-wide rows keeps 16-byte aligned rows and
        base: the fast paths take it and mask the ragged edge."""
        assert _plan(70, 203, 293, a_strides=(296, 1),
                     b_strides=(208, 1)).path == WGMMA
        assert _plan(5, 203, 293, a_strides=(296, 1),
                     b_strides=(208, 1)).path == STREAM

    def test_config_forces_its_tile_or_raises(self):
        p = _plan(8, 512, 3584, config=BlockConfig(128, 128, 64))
        assert (p.path, p.tile) == (WGMMA, BlockConfig(128, 128, 64))
        assert _plan(8, 512, 3584, config=DEFAULT_CONFIG).path == GENERAL
        with pytest.raises(ValueError, match="at most 8 rows"):
            _plan(9, 512, 3584, config=BlockConfig(8, 64, 64))
        with pytest.raises(ValueError, match="general path"):
            _plan(8, 512, 3584, dtype=torch.float32,
                  out_dtype=torch.float32, config=BlockConfig(64, 64, 64))
        with pytest.raises(ValueError, match="general path"):
            _plan(200, 512, 3584, a_mod=4, config=BlockConfig(128, 64, 64))

    @pytest.mark.parametrize("m", [1, 4, 8, 9, 16, 17, 32, 33, 63, 64])
    def test_stream_tile_is_the_narrowest_that_holds_m(self, m):
        p = _plan(m, 3584, 3584)
        want = next(r for r in (8, 16, 32, 64) if r >= m)
        assert (p.path, p.tile.block_m) == (STREAM, want)

    @pytest.mark.parametrize("m,n,k", [(65, 200, 296), (129, 520, 3584),
                                       (512, 512, 3584), (1, 200, 40)])
    def test_splits_never_exceed_the_k_tiles(self, m, n, k):
        p = _plan(m, n, k)
        assert 1 <= p.splits <= max(1, -(-k // 64) // 2)
        assert 1 <= p.segments <= max(1, -(-k // 64) // 2)
        assert p.splits in (1, p.segments)

    @pytest.mark.parametrize("arch", SIX_ARCHS)
    def test_segments_do_not_depend_on_m(self, arch):
        """Fault C1: for every serving (N, K) of the config (the engine's
        fleet, plus what it launches beyond the reference's count: the
        router with f32 out and deepseek's shared-expert SwiGLU), the K
        segment count is one number for every M in 1..512 and both output
        dtypes, on whichever fast path and tile `plan` picks."""
        from repro_torch.configs import get_config

        cfg = get_config(arch)
        fleet = set(ops.serving_gemm_fleet(
            cfg, max_batch=4, max_len=512, chunk_tokens=64, lane_width=8))
        nk = {(n, k) for _, n, k in fleet}
        if cfg.n_experts:
            f = cfg.d_ff_expert * cfg.n_shared_experts
            nk |= {(cfg.n_experts, cfg.d_model)}
            nk |= {(f, cfg.d_model), (cfg.d_model, f)} if f else set()
        for n, k in sorted(nk):
            seen = {_plan(m, n, k, out_dtype=out).segments
                    for m in range(1, 513)
                    for out in (torch.bfloat16, torch.float32)}
            assert seen == {k_segments(n, k)}, (n, k, seen)

    def test_plan_is_deterministic(self):
        assert _plan(64, 3584, 18944) == _plan(64, 3584, 18944)
