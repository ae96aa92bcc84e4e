"""`distributed.compress` against the JAX package's and on two ranks, on
the CPU: the reference's `TestCompression` cases (`tests/test_runtime.py`)
on the port, and `compressed_psum` over the "data" axis of two gloo rank
processes: int8 on the wire, the mean within one quantisation step of the
exact mean, and x = q * scale + residual, the residual carried into the
next call."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_train_ranks as R
from repro.distributed import compress as jcompress
from repro_torch.distributed import compress
from repro_torch.launch.mesh import Mesh, RankPool


@pytest.fixture(scope="module")
def pool():
    with RankPool(2, timeout_s=120, threads=1) as p:
        yield p


def test_quantize_roundtrip_error_bounded():
    """The reference's case: within one quantisation step; and with the
    reference's own noise passed in, the reference's codes and scale."""
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(256,)),
                        dtype=torch.float32)
    q, scale = compress._quantize(x, torch.Generator().manual_seed(0))
    err = (q.float() * scale - x).abs()
    assert q.dtype == torch.int8
    assert float(err.max()) <= float(scale) * 1.01
    key = jax.random.key(0)
    jq, jscale = jcompress._quantize(jnp.asarray(x.numpy()), key)
    noise = jax.random.uniform(key, x.shape, jnp.float32, -0.5, 0.5)
    q2, s2 = compress._quantize(x, noise=torch.as_tensor(np.asarray(noise)))
    np.testing.assert_array_equal(q2.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s2), float(jscale), rtol=1e-6)


def test_wire_bytes_saved():
    """The reference's case: 1000 values from 16 to 8 bits save 1000
    bytes."""
    grads = {"w": torch.zeros((1000,))}
    assert compress.wire_bytes_saved(grads, bits=8, from_bits=16) == 1000
    assert compress.wire_bytes_saved(grads, bits=8, from_bits=16) == \
        jcompress.wire_bytes_saved({"w": jnp.zeros((1000,))}, 8, 16)


def test_a_mesh_without_the_axis_returns_the_grads_unchanged():
    """The port's meshes have "data" and "model": over "pod" the tree and
    residuals come back as they went in, as the reference returns them."""
    grads = {"w": torch.ones(3)}
    out, res = compress.compressed_allreduce_tree(grads, Mesh(None, 0, 1),
                                                  axis="pod")
    assert out is grads and res is None


def test_compressed_psum_on_two_ranks(pool):
    """Two ranks' tensors of one max-abs (one scale): the int8 mean is
    within one quantisation step of the exact mean on both ranks, each
    rank's x (plus its residual) is q * scale + its new residual, and a
    second call with the residuals carried keeps both properties."""
    rng = np.random.default_rng(1)
    xs = [rng.normal(size=(64,)).astype(np.float32) for _ in range(2)]
    for x in xs:
        x[0] = 3.0
    noises = [rng.uniform(-0.5, 0.5, (64,)).astype(np.float32)
              for _ in range(2)]
    residuals = None
    for _ in range(2):
        ranks = pool.run(R.compressed_mean, xs, noises, residuals)
        inputs = xs if residuals is None else [
            x + r for x, r in zip(xs, residuals)]
        exact = np.mean(inputs, axis=0)
        step = max(out["scale"] for out in ranks)
        for r, out in enumerate(ranks):
            assert out["q"].dtype == np.int8
            assert np.abs(out["mean"] - exact).max() <= step
            np.testing.assert_allclose(
                out["q"].astype(np.float32) * out["scale"] + out["residual"],
                inputs[r], rtol=0, atol=1e-6)
            np.testing.assert_array_equal(out["mean"], ranks[0]["mean"])
        residuals = [out["residual"] for out in ranks]
