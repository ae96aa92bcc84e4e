"""The dry-run against the JAX package's for the MoE and MLA families
(olmoe-1b-7b, deepseek-v2-236b): equal dot FLOPs on every smoke cell (see
`test_torch_dryrun_dense.py` for how each side is counted)."""

from __future__ import annotations

import pytest

from test_torch_dryrun_dense import port_flops, ref_flops


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_dot_flops_equal_the_reference(arch, shape):
    """The routers and shared experts through the kernel, the routed
    experts' einsums (dense dispatch over every expert's capacity) and
    MLA's attention through aten: the same products as the reference's."""
    cost = port_flops(arch, shape)
    assert cost.flops == ref_flops(arch, shape)
    assert cost.gemm_flops > 0
