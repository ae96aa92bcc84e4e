"""The port's cell table and input specs against the JAX package's
(`repro_torch.configs`, `configs.common`, `data.pipeline.smoke_batch`),
and the leftovers of the reference's `tests/test_arch_smoke.py`: full
configs built on meta at every supported cell, parameter counts, the
long-context cell only for sub-quadratic archs, the MoE router's balance
and prefill/decode consistency, on the port."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import smoke_batch as jsmoke_batch
from repro.models.registry import get_model as jget_model
from repro_torch import configs
from repro_torch.configs.common import INDEX_DTYPE, Spec, meta_tree
from repro_torch.data.pipeline import smoke_batch
from repro_torch.models.registry import get_model

ARCHS = configs.list_archs()
CELLS = configs.all_cells()

# the decode state's leaves where the port's layout differs from the
# reference's (`configs.common`'s docstring): {path: the port's (shape,
# dtype) as a function of (config, B, S)}
PORT_ONLY = {
    ("state", "index"): lambda cfg, B, S: ((B,), INDEX_DTYPE),
    ("state", "pos_off"): lambda cfg, B, S: ((B,), INDEX_DTYPE),
    ("state", "src_len"): lambda cfg, B, S: ((B,), INDEX_DTYPE),
    ("state", "kv", "xk"): lambda cfg, B, S: (
        (cfg.n_layers, B, S, cfg.kv_heads, cfg.hd), torch.bfloat16),
    ("state", "kv", "xv"): lambda cfg, B, S: (
        (cfg.n_layers, B, S, cfg.kv_heads, cfg.hd), torch.bfloat16),
}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_cell_table_equals_the_reference():
    assert configs.SHAPES == jconfigs.SHAPES
    assert configs.SHAPE_DEFS == jconfigs.SHAPE_DEFS
    assert configs.all_cells() == jconfigs.all_cells()
    for arch in ARCHS:
        assert configs.supported_cells(arch) == jconfigs.supported_cells(arch)
    # 8 archs x 3 shapes, and the two sub-quadratic ones' long_500k
    assert len(CELLS) == 32


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape, smoke):
    """Every leaf has the reference's shape and dtype, except the port's
    decode-state leaves listed in `configs.common`."""
    got = dict(_leaves(configs.input_specs(arch, shape, smoke)))
    want = dict(_leaves(jconfigs.input_specs(arch, shape, smoke)))
    assert set(got) == set(want)
    cfg = configs.get_config(arch, smoke=smoke)
    d = configs.SHAPE_DEFS[shape]
    B, S = ((2, min(d["seq_len"], 64)) if smoke
            else (d["global_batch"], d["seq_len"]))
    for path, spec in got.items():
        assert isinstance(spec, Spec)
        if path in PORT_ONLY:
            shape_, dtype = PORT_ONLY[path](cfg, B, S)
        else:
            ref = want[path]
            shape_ = tuple(ref.shape)
            dtype = getattr(torch, np.dtype(ref.dtype).name)
        assert spec.shape == shape_, (path, spec, shape_)
        assert spec.dtype == dtype, (path, spec, dtype)
        m = spec.meta()
        assert m.device.type == "meta" and tuple(m.shape) == shape_


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_batch_equals_the_reference(arch, shape):
    cfg, batch = smoke_batch(arch, shape, seed=3)
    jcfg, want = jsmoke_batch(arch, shape, seed=3)
    assert cfg.name == jcfg.name
    assert list(batch) == list(want)
    for k, v in batch.items():
        assert v.dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_instantiable_on_meta(arch):
    """The published config's parameters build on meta at full width and
    depth (no storage, no draws), leaf for leaf as many elements as the
    reference's ``jax.eval_shape(model.init)``, and every supported cell's
    inputs build as meta tensors."""
    cfg = configs.get_config(arch)
    assert cfg.n_params() > 1e8, f"{arch}: implausibly few params"
    params = get_model(cfg).init(cfg, None, device="meta")
    ps = list(params.parameters())
    assert all(p.device.type == "meta" for p in ps)
    jcfg = jconfigs.get_config(arch)
    jparams = jax.eval_shape(lambda k: jget_model(jcfg).init(k, jcfg),
                             jax.random.key(0))
    assert sum(p.numel() for p in ps) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))
    for shape in configs.supported_cells(arch):
        inputs = meta_tree(configs.input_specs(arch, shape))
        assert all(t.device.type == "meta" for _, t in _leaves(inputs))


def test_meta_init_needs_no_generator_and_other_devices_do():
    cfg = configs.get_config("qwen2-7b", smoke=True)
    api = get_model(cfg)
    assert api.init(cfg, None, device="meta").device.type == "meta"
    with pytest.raises(ValueError, match="generator"):
        api.init(cfg, None, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_reference(arch):
    assert (configs.get_config(arch).n_params()
            == jconfigs.get_config(arch).n_params())
    assert (configs.get_config(arch).n_active_params()
            == jconfigs.get_config(arch).n_active_params())


def test_long_500k_only_subquadratic():
    for arch in ARCHS:
        cells = configs.supported_cells(arch)
        assert ("long_500k" in cells) == (
            arch in ("falcon-mamba-7b", "zamba2-2.7b"))


def test_moe_router_balanced_under_uniform_tokens():
    """With random tokens the port's aux loss sits near its floor of
    router_aux_coef a layer (perfect balance) and well below 2x."""
    cfg, batch = smoke_batch("olmoe-1b-7b", "train_4k")
    api = get_model(cfg)
    params = api.init(cfg, torch.Generator("cpu").manual_seed(1),
                      device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        _, metrics = api.loss(params, batch, cfg)
    aux_per_layer = float(metrics["aux_loss"]) / cfg.n_layers
    assert cfg.router_aux_coef * 0.5 < aux_per_layer < cfg.router_aux_coef * 2


def _prefill_decode(arch):
    """Prefill S - 1 tokens, decode token S; against a prefill of all S
    (the reference's `_prefill_decode`, on the port)."""
    cfg, batch = smoke_batch(arch, "train_4k")
    api = get_model(cfg)
    params = api.init(cfg, torch.Generator("cpu").manual_seed(0),
                      device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in batch.items()
             if k not in ("labels", "loss_mask")}
    toks = batch["tokens"]
    B, S = toks.shape
    cut = S - 1
    n_patch = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    max_len = n_patch + S + 8

    def part(n):
        out = dict(batch, tokens=toks[:, :n])
        if "positions_3d" in batch:
            out["positions_3d"] = batch["positions_3d"][:, :n_patch + n]
        return out

    _, state = api.prefill(params, part(cut), cfg, max_len=max_len)
    got, _ = api.decode_step(params, toks[:, cut], state, cfg)
    want, _ = api.prefill(params, part(S), cfg, max_len=max_len)
    return got.numpy(), want.numpy()


@pytest.mark.parametrize("arch", [
    "qwen2-7b", "olmoe-1b-7b", "deepseek-v2-236b", "falcon-mamba-7b",
    "zamba2-2.7b", "seamless-m4t-medium", "qwen2-vl-2b",
])
def test_prefill_decode_consistency(arch):
    got, want = _prefill_decode(arch)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
