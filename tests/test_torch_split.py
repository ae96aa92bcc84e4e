"""The split pair: an f32 operand's three bf16 terms and the mixed
f32 x bf16 product they feed.

The backward of an f32-out product of bf16 operands (the LM head, the MoE
router) multiplies the f32 cotangent by a bf16 operand. On the card the
cotangent is split once into hi = bf16(x), mid = bf16(x - hi) and
lo = bf16(x - hi - mid) (`split3`), and the wgmma kernel sums the three
terms' products, each exact in fp32, in one fp32 accumulator: the f32
product's result up to the order of the additions. Here, on the CPU, the
plain split is held to that arithmetic and the mixed wrapper to the JAX
package's `matmul_ref` of the same operands (which promotes the bf16 one to
f32, as the JAX transpose of its ``dot_general`` does). The kernels run
only on the card: `tests/test_torch_cuda.py` holds them against these plain
versions there.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.ref import matmul_ref as jmatmul_ref
from repro_torch.kernels import ops
from repro_torch.kernels.ref import matmul_ref, split3_ref
from repro_torch.kernels.tiled_matmul import (Split3, split3, tiled_matmul)

# normal f32 magnitudes whose three terms stay normal in bf16 (the lowest
# term reaches 2^-24 of the value; bf16's smallest normal is 2^-126) and
# whose rounding to bf16 cannot overflow (bf16's largest finite value is
# about 3.39e38)
LO, HI = 2.0 ** -100, 2.0 ** 127
MAGNITUDES = st.floats(min_value=LO, max_value=HI, width=32,
                       allow_subnormal=False)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(MAGNITUDES, st.booleans()), min_size=1,
                max_size=64))
def test_three_terms_reconstruct_normal_f32_values_exactly(values):
    x = torch.tensor([v if pos else -v for v, pos in values],
                     dtype=torch.float32).reshape(1, -1)
    terms = split3_ref(x)
    assert terms.shape == (3, *x.shape) and terms.dtype == torch.bfloat16
    # in float64 the three bf16 values add up exactly
    assert torch.equal(terms.double().sum(0), x.double())
    # each term is the bf16 rounding of what the terms before it left
    hi, mid, lo = terms.float()
    assert torch.equal(hi, x.bfloat16().float())
    assert torch.equal(mid, (x - hi).bfloat16().float())
    assert torch.equal(lo, (x - hi - mid).bfloat16().float())


def test_terms_shrink_by_a_bf16_significand_each():
    """|mid| <= 2^-8 |hi| and |lo| <= 2^-8 |mid| (round to nearest): each
    term holds the next 8 bits of the significand."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 96)).astype(np.float32))
    hi, mid, lo = split3_ref(x).float().abs()
    assert (mid <= hi * 2.0 ** -8).all() and (lo <= mid * 2.0 ** -8).all()


def test_split3_on_the_cpu_is_the_plain_version():
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(17, 43)).astype(np.float32))
    before = split3.launches
    s = split3(x)
    assert isinstance(s, Split3) and s.x is x
    assert torch.equal(s.terms, split3_ref(x))
    assert (s.shape, s.dtype, s.device, s.dim()) == (
        x.shape, torch.float32, x.device, 2)
    assert split3(s) is s
    assert split3.launches == before


@pytest.mark.parametrize("bad", [torch.zeros(4, 4, dtype=torch.bfloat16),
                                 torch.zeros(2, 4, 4)])
def test_split3_takes_an_f32_matrix(bad):
    with pytest.raises(TypeError):
        split3(bad)


def _mixed(seed, m, n, k, ta, tb, f32_side):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(k, m) if ta else (m, k)).astype(np.float32)
    b = (rng.normal(size=(n, k) if tb else (k, n)) / np.sqrt(k)).astype(
        np.float32)
    dts = {"a": (torch.float32, torch.bfloat16),
           "b": (torch.bfloat16, torch.float32)}[f32_side]
    return (torch.from_numpy(a).to(dts[0]), torch.from_numpy(b).to(dts[1]))


@pytest.mark.parametrize("f32_side", ["a", "b"])
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_mixed_wrapper_equals_matmul_ref_of_both_upcast(f32_side, ta, tb,
                                                        out_dtype):
    """One f32 and one bf16 operand, as a tensor or as a `Split3`, in every
    layout, with alpha and beta: on the CPU the plain version of both
    upcast, bit for bit, and no launch counted."""
    a, b = _mixed(2, 40, 72, 56, ta, tb, f32_side)
    c = torch.from_numpy(np.random.default_rng(3).normal(
        size=(40, 72)).astype(np.float32))
    kw = dict(transpose_a=ta, transpose_b=tb, alpha=0.5, beta=0.5,
              out_dtype=out_dtype)
    want = matmul_ref(a.float(), b.float(), c.to(out_dtype), **kw)
    before = dict(tiled_matmul.launches_by_path)
    assert torch.equal(tiled_matmul(a, b, c, **kw), want)
    split_a, split_b = ((split3(a), b) if f32_side == "a"
                        else (a, split3(b)))
    assert torch.equal(tiled_matmul(split_a, split_b, c, **kw), want)
    assert tiled_matmul.launches_by_path == before


@pytest.mark.parametrize("f32_side", ["a", "b"])
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False)])
def test_mixed_wrapper_matches_jax(f32_side, ta, tb):
    """The JAX package's `matmul_ref` of the same f32 and bf16 operands
    (``dot_general`` promotes the bf16 one), rounded to bf16: within one
    bf16 step of the output's magnitude."""
    a, b = _mixed(4, 33, 130, 200, ta, tb, f32_side)
    ja = jnp.asarray(a.float().numpy(), jnp.float32 if f32_side == "a"
                     else jnp.bfloat16)
    jb = jnp.asarray(b.float().numpy(), jnp.float32 if f32_side == "b"
                     else jnp.bfloat16)
    want = np.asarray(jmatmul_ref(ja, jb, transpose_a=ta, transpose_b=tb,
                                  out_dtype=jnp.bfloat16), np.float32)
    got = tiled_matmul(a, b, transpose_a=ta, transpose_b=tb,
                       out_dtype=torch.bfloat16).float().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * scale)


@pytest.mark.parametrize("tied", [False, True])
def test_f32_out_backward_splits_the_cotangent_once(monkeypatch, tied):
    """`ops.matmul`'s backward of an f32-out product of bf16 operands: the
    cotangent is split once (`split3`) and its terms feed both gradients,
    which equal `matmul_ref` of the f32 cotangent and the bf16 operands;
    a tied head's layout (B stored (N, K)) too."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(24, 64)).astype(
        np.float32)).bfloat16().requires_grad_(True)
    w = torch.from_numpy((rng.normal(size=(96, 64) if tied else (64, 96))
                          / 8).astype(np.float32)).bfloat16()
    w.requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(24, 96)).astype(np.float32))
    splits, operands = [], []
    real_split, real_mm = ops.split3, ops.tiled_matmul

    def counting_split(t):
        splits.append(t.shape)
        return real_split(t)

    def recording(a, b, c=None, **kw):
        operands.append((type(a).__name__, type(b).__name__))
        return real_mm(a, b, c, **kw)

    monkeypatch.setattr(ops, "split3", counting_split)
    monkeypatch.setattr(ops, "tiled_matmul", recording)
    out = ops.matmul(x, w, transpose_b=tied, out_dtype=torch.float32)
    dx, dw = torch.autograd.grad(out, [x, w], g)
    assert splits == [g.shape]
    assert operands[1:] == ([("Split3", "Tensor")] * 2 if tied
                            else [("Split3", "Tensor"), ("Tensor", "Split3")])
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert torch.equal(dx, matmul_ref(g, w, transpose_b=not tied,
                                      out_dtype=torch.bfloat16))
    want_dw = (matmul_ref(g, x, transpose_a=True, out_dtype=torch.bfloat16)
               if tied else matmul_ref(x, g, transpose_a=True,
                                       out_dtype=torch.bfloat16))
    assert torch.equal(dw, want_dw)


def test_bf16_out_backward_does_not_split():
    x = torch.ones(8, 16, dtype=torch.bfloat16, requires_grad=True)
    w = torch.ones(16, 24, dtype=torch.bfloat16, requires_grad=True)
    before = split3.launches
    dx, dw = torch.autograd.grad(ops.matmul(x, w).sum(), [x, w])
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert torch.equal(dx, torch.full((8, 16), 24.0, dtype=torch.bfloat16))
    assert split3.launches == before
