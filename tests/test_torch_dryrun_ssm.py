"""The dry-run against the JAX package's for the SSM and hybrid families
(falcon-mamba-7b, zamba2-2.7b; see `test_torch_dryrun_dense.py` for how
each side is counted). Their scans compute some products otherwise than
the reference's, so the dot FLOPs are equal after named terms, each
computed from the config and the cell: the products one side's scan
contracts as a dot and the other's does not."""

from __future__ import annotations

import pytest

from repro_torch.configs import SHAPE_DEFS, get_config, input_specs
from repro_torch.models import ssm
from test_torch_dryrun_dense import port_flops, ref_flops


def _cell(arch: str, shape: str) -> tuple:
    """(smoke config, step kind, B, tokens a row)."""
    cfg = get_config(arch, smoke=True)
    step = SHAPE_DEFS[shape]["step"]
    specs = input_specs(arch, shape, smoke=True)
    if step == "decode":
        return cfg, step, specs["token"].shape[0], 1
    return cfg, step, *specs["tokens"].shape


def mamba1_c_dot(arch: str, shape: str) -> int:
    """Reference only. Its Mamba1 output y = C . h
    (``einsum("qbds,bqs->bqd")``, decode ``einsum("bds,bs->bd")``) is a
    dot over d_state; the port sums the product over the last axis
    (`models/ssm.py`: a row's bits must not depend on its batch), no dot.
    2 x B x T x d_inner x d_state a layer, T the step's tokens a row; a
    train step adds the C cotangent (a dot over d_inner; h's cotangent is
    an outer product, which XLA rewrites into a multiply)."""
    cfg, step, B, T = _cell(arch, shape)
    assert not cfg.remat
    passes = 2 if step == "train" else 1
    return (passes * 2 * B * T * cfg.d_inner * cfg.ssm_state
            * cfg.n_layers)


def ssd_serving_dots(arch: str, shape: str) -> int:
    """Reference only. A serving scan (prefill, blocks of the serving
    chunk q) contracts four products a block as dots: the scores C.B over
    N, the intra-block outputs over the block's q steps, the block's own
    state over its steps and the carried state's outputs over N. The
    port's serving scan (``ssd_scan(rowwise=True)``) sums each as a
    product over the last axis, no dot. A decode step has the last one
    only (``einsum("bn,bhnp->bhp")``; its state update is an outer
    product, a multiply in XLA). Per Mamba2 layer: 2 B q^2 N + 2 B q^2 di
    + 2 x 2 B q N di a block; 2 B N di a decode step."""
    cfg, step, B, T = _cell(arch, shape)
    N, di = cfg.ssm_state, cfg.d_inner
    if step == "decode":
        return 2 * B * N * di * cfg.n_layers
    assert step == "prefill"
    q = ssm.serve_chunk(cfg)
    blocks = -(-T // q)
    return (blocks * (2 * B * q * q * N + 2 * B * q * q * di
                      + 2 * 2 * B * q * N * di) * cfg.n_layers)


def ssd_training_terms(arch: str) -> tuple[int, int]:
    """(port only, reference only) of a smoke train step, whose S tokens
    are one block of CHUNK (the state starts at zero and the loss never
    reads the final one). Port only: the carried state's outputs
    C . h0 over N (``einsum("bcqn,bchnp->bcqhp")``) and its C cotangent,
    2 x 2 B S N di a layer: XLA folds the product with the zero initial
    state away. Reference only: its scan differentiates the carried state
    it threads through the blocks, three contractions of 2 B S N di (the
    block state's B and x cotangents and the carried outputs' state
    cotangent) and two of 2 B S di (the decay factors' cotangents, over
    headdim); the port's autograd skips what the loss does not read."""
    cfg, step, B, S = _cell(arch, "train_4k")
    assert step == "train" and S <= ssm.CHUNK and not cfg.remat
    N, di, L = cfg.ssm_state, cfg.d_inner, cfg.n_layers
    port_only = 2 * 2 * B * S * N * di * L
    ref_only = (3 * 2 * B * S * N * di + 2 * 2 * B * S * di) * L
    return port_only, ref_only


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_mamba1_dot_flops_equal_the_reference_after_the_c_dot(shape):
    cost = port_flops("falcon-mamba-7b", shape)
    assert cost.flops + mamba1_c_dot("falcon-mamba-7b", shape) == ref_flops(
        "falcon-mamba-7b", shape)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_hybrid_serving_dot_flops_equal_the_reference_after_the_ssd_dots(
        shape):
    cost = port_flops("zamba2-2.7b", shape)
    assert cost.flops + ssd_serving_dots("zamba2-2.7b", shape) == ref_flops(
        "zamba2-2.7b", shape)


def test_hybrid_training_dot_flops_equal_the_reference_after_the_terms():
    port_only, ref_only = ssd_training_terms("zamba2-2.7b")
    cost = port_flops("zamba2-2.7b", "train_4k")
    assert cost.flops - port_only + ref_only == ref_flops("zamba2-2.7b",
                                                          "train_4k")


def test_the_terms_are_the_motivations_differences():
    """The smoke cells' differences (port minus reference)."""
    assert -mamba1_c_dot("falcon-mamba-7b", "train_4k") == -1_048_576
    port_only, ref_only = ssd_training_terms("zamba2-2.7b")
    assert port_only - ref_only == -2_359_296
