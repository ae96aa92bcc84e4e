"""The dry-run against the JAX package's for the encoder-decoder and
vision families (seamless-m4t-medium, qwen2-vl-2b): equal dot FLOPs on
every smoke cell but one, whose difference is the port's cache layout (see
`test_torch_dryrun_dense.py` for how each side is counted)."""

from __future__ import annotations

import pytest

from repro_torch.configs import get_config, input_specs
from repro_torch.configs.seamless_m4t_medium import src_len
from test_torch_dryrun_dense import port_flops, ref_flops


def cross_kv_rows(arch: str, shape: str) -> int:
    """The port's decode attends over its cross-KV of S rows (the state's
    ``xk``/``xv`` share the row's length budget, `configs.common`), the
    reference's over its src_len(S) rows: both cross-attention products
    (scores and values, 2 x B x H*hd a key each) over the S - src_len(S)
    extra rows, in every decoder layer. 0 for every other cell."""
    if get_config(arch).kind != "encdec" or shape != "decode_32k":
        return 0
    cfg = get_config(arch, smoke=True)
    B, = input_specs(arch, shape, smoke=True)["token"].shape
    S = input_specs(arch, shape, smoke=True)["state"]["kv"]["k"].shape[2]
    extra = S - src_len(S)
    return 2 * 2 * B * cfg.n_heads * cfg.hd * extra * cfg.n_layers


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-2b"])
def test_dot_flops_equal_the_reference(arch, shape):
    cost = port_flops(arch, shape)
    assert cost.flops == ref_flops(arch, shape) + cross_kv_rows(arch, shape)
    assert cost.gemm_flops > 0


def test_the_cross_kv_term_is_the_only_difference():
    assert cross_kv_rows("seamless-m4t-medium", "decode_32k") == 49152
    assert cross_kv_rows("qwen2-vl-2b", "decode_32k") == 0
