"""Tensor parallelism's layout and pricing against the JAX package, on the
CPU and in this process (no rank processes): which shard of every
parameter and decode-state leaf a rank holds (`distributed.sharding`)
against the reference's `param_pspecs`/`serving_state_pspecs` on an
abstract (1, tp) mesh, the per-rank GEMM fleet (`gemm_shape_counts(tp=)`)
and ring traffic (`collective_wire_bytes`) against the reference's, the
tp engine's step estimate against the reference's `gemm_fleet_energy`
with the same terms, and the engine's refusals. The streams are
`test_torch_tp_serving.py`'s, `test_torch_tp_dense4.py`'s and
`test_torch_tp_ssm.py`'s (which also holds the SSM leaves' part-wise cuts
and decode-state shapes, where the port departs from the reference's
global rules).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_tp_ranks as R
from repro.core import energy as jenergy
from repro.distributed import sharding as jsharding
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import collective_wire_bytes as jwire
from repro.models.config import gemm_shape_counts as jcounts
from repro.models.config import kv_cache_bytes as jkv_bytes
from repro.models.registry import get_model as jget_model
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import Mesh
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.models.config import collective_wire_bytes, gemm_shape_counts
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import ServingEngine

# the families whose every leaf the reference's rules cut as the port
# does (the SSM families' concatenated leaves are cut by parts)
SERVED_TP = ("dense", "moe", "mla_moe", "vlm", "encdec")
ALL_KINDS = ("dense", "moe", "mla_moe", "mamba1", "mamba2", "hybrid",
             "encdec", "vlm")


def _jax_tree(kind: str, **over):
    jcfg = JModelConfig(**R.config_kw(kind, **over))
    return jcfg, jget_model(jcfg).init(jax.random.key(0), jcfg)


@pytest.fixture
def jax_specs():
    """The reference's PartitionSpecs on an abstract (1, tp) mesh, its
    thread's mesh rules cleared after (`param_pspecs` installs them)."""
    def specs(fn, tree, tp: int, **kw):
        mesh = jax.sharding.AbstractMesh((1, tp), ("data", "model"))
        return fn(tree, mesh, **kw)

    yield specs
    jsharding.set_mesh_rules(None)


def _flat(tree) -> dict:
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        out["/".join(str(p.key) for p in path)] = leaf
    return out


def _flat_dict(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} of a nested dict whose leaves may be None."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_dict(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jax_path(name: str) -> str:
    """A port parameter name as its stacked JAX leaf's path: the layer
    index dropped ("blocks.1.attn.wq" -> "blocks/attn/wq")."""
    return "/".join(p for p in name.split(".") if not p.isdigit())


def _model_axis(spec, lead: int) -> int | None:
    """The axis of a JAX PartitionSpec on "model", counted on the port's
    per-layer leaf (`lead` stacked axes dropped), or None."""
    axes = [i - lead for i, ax in enumerate(spec) if ax == "model"]
    return axes[0] if axes else None


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", SERVED_TP)
def test_param_axes_are_the_references_pspecs(kind, tp, jax_specs):
    """Every parameter's sharded axis (gather mode) is the one the
    reference's `param_pspecs(..., tp_reduce="gather")` puts on "model",
    for the families served at tp > 1 (the rules are copied whole). At
    tp=4 the smoke config's 2 KV heads of 16 split inside a head in both
    packages' rules; the reference's global view serves that, the port's
    engine refuses it (`test_engine_refuses_split_heads`). (Not the SSM
    families: on their 1-D per-layer leaves, A_log and D, the reference's
    rules shard a stacked layer axis, which a rank's per-layer leaf cannot
    hold, and a contiguous block of a concatenated in_proj or conv is
    another function on a local rank: `test_torch_tp_ssm.py`.)"""
    jcfg, jparams = _jax_tree(kind)
    shapes = jax.eval_shape(lambda: jparams)
    want = _flat(jax_specs(jsharding.param_pspecs, shapes, tp,
                           tp_reduce="gather"))
    jshape = {k: v.shape for k, v in _flat(shapes).items()}
    cfg = ModelConfig(**R.config_kw(kind))
    model = get_model(cfg).init(cfg, None, device="meta")
    got = sharding.param_axes(model, tp)
    assert got, kind
    for name, p in model.named_parameters():
        path = _jax_path(name)
        lead = len(jshape[path]) - p.dim()   # stacked axes (hybrid: 2)
        assert _model_axis(want[path], lead) == got[name], (name, want[path])


@pytest.mark.parametrize("kind", SERVED_TP)
def test_each_ranks_shard_is_the_references_slice(kind, jax_specs):
    """The bridged JAX weights, cut by `shard_params` for each rank of a
    (1, 2) mesh, hold exactly the slice of each leaf that the reference's
    spec gives that rank (its block of the "model" axis); every other leaf
    whole."""
    tp = 2
    jcfg, jparams = _jax_tree(kind)
    tree = jax.tree.map(np.asarray, jparams)
    want = _flat(jax_specs(jsharding.param_pspecs, tree, tp,
                           tp_reduce="gather"))
    flat = _flat(tree)
    cfg = ModelConfig(**R.config_kw(kind))
    for rank in range(tp):
        model = sharding.shard_params(params_from_numpy(tree, cfg, "cpu"),
                                      Mesh(None, rank, tp))
        for name, p in model.named_parameters():
            path = _jax_path(name)
            idx = [int(s) for s in name.split(".") if s.isdigit()]
            whole = flat[path][tuple(idx)]
            ax = _model_axis(want[path], len(idx))
            if ax is not None:
                n = whole.shape[ax] // tp
                whole = np.take(whole, range(rank * n, (rank + 1) * n), ax)
            np.testing.assert_array_equal(p.numpy(), whole, err_msg=name)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", SERVED_TP)
def test_state_axes_are_the_references_serving_pspecs(kind, tp, jax_specs):
    """The decode state's head axis, dense and the paged pool, is the one
    the reference's `serving_state_pspecs` shards; a cache allocated under
    a tp mesh has that axis divided (`local_state_shape`)."""
    over = dict(n_heads=8, n_kv_heads=4) if tp == 4 else {}
    jcfg = JModelConfig(**R.config_kw(kind, **over))
    japi = jget_model(jcfg)
    cfg = ModelConfig(**R.config_kw(kind, **over))
    api = get_model(cfg)
    pairs = [(jax.eval_shape(lambda: japi.init_state(jcfg, 2, 16)),
              lambda: api.init_state(cfg, 2, 16, device="meta"))]
    if japi.init_page_pool is not None:
        pairs.append((jax.eval_shape(lambda: japi.init_page_pool(jcfg, 5, 8)),
                      lambda: api.init_page_pool(cfg, 5, 8, device="meta")))
    for jstate, make in pairs:
        want = _flat(jax_specs(jsharding.serving_state_pspecs, jstate, tp))
        whole = _flat_dict(make())
        axes = _flat_dict(sharding.state_axes(make(), tp))
        assert set(axes) == set(want) == set(whole)
        sharding.set_mesh(Mesh(None, 0, tp))
        try:
            local = _flat_dict(make())
        finally:
            sharding.set_mesh(None)
        for path, spec in want.items():
            assert axes[path] == _model_axis(spec, 0), (path, spec)
            shape = list(whole[path].shape)
            if axes[path] is not None:
                shape[axes[path]] //= tp
            assert tuple(local[path].shape) == tuple(shape), path


def _configs() -> list:
    """Every published config and every smoke family config, in both
    packages."""
    from repro.configs import get_config as jget_config

    out = [(get_config(a), jget_config(a)) for a in list_archs()]
    out += [(ModelConfig(**R.config_kw(k)), JModelConfig(**R.config_kw(k)))
            for k in sorted(R.FAMILY_KW)]
    return out


@pytest.mark.parametrize("tp", [2, 4])
def test_fleet_and_wire_bytes_equal_the_references(tp):
    """`gemm_shape_counts(tp=)` and `collective_wire_bytes` equal the
    reference's for every config, over decode, chunk, prefill and
    admission token counts."""
    for cfg, jcfg in _configs():
        for t, kw in ((4, {}), (64, dict(head_tokens=4)),
                      (512, dict(head_tokens=1, kv_rows=2048)),
                      (0, dict(head_tokens=0, src_tokens=96))):
            assert gemm_shape_counts(cfg, t, tp=tp, **kw) == jcounts(
                jcfg, t, tp=tp, **kw), (cfg.name, t, kw)
            wkw = {k: v for k, v in kw.items() if k != "kv_rows"}
            assert collective_wire_bytes(cfg, t, tp, **wkw) == jwire(
                jcfg, t, tp, **wkw), (cfg.name, t, kw)


def _tp_engine(kind: str = "dense", tp: int = 2, **kw):
    """A tp engine of `kind`'s smoke config for rank 0 of a (1, tp) mesh
    with no process group: it cuts its shard and prices, nothing runs."""
    cfg = ModelConfig(**R.config_kw(kind))
    api = get_model(cfg)
    params = api.init(cfg, torch.Generator("cpu").manual_seed(0),
                      device="cpu")
    return ServingEngine(api, params, cfg, device="cpu", max_batch=2,
                         max_len=64, tp=tp, mesh=Mesh(None, 0, tp), **kw)


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_step_estimate_is_the_references_with_the_tp_terms(kind):
    """A tp=2 engine's decode and chunk estimates (priced on the TPU v5e,
    where the two energy models agree) equal the reference's
    `gemm_fleet_energy` over its per-shard fleet with its ring bytes,
    collective count, tp chips, overlap chunks and the KV reads of one
    rank (the whole latent cache for MLA), for every family; the fleet
    is priced on 2 chips with wire time, its idle floor doubled."""
    eng = _tp_engine(kind, chip="tpu_v5e")
    jcfg = dataclasses.replace(JModelConfig(**R.config_kw(kind)),
                               tp_collectives="explicit", tp_reduce="gather",
                               tp_overlap_chunks=4)
    scale = 2.0 if kind == "encdec" else 1.0
    # a rank reads its heads' half of the KV cache; MLA's latent cache is
    # whole on every rank, as the reference prices it
    shard = 1 if kind == "mla_moe" else 2
    for key, n, head, rows in ((("decode", 2), 2, None, 2),
                               (("chunk", 2, 16), 32, 2, 2)):
        got = eng._step_energy(key, n, head, batch_rows=rows)
        wire, n_coll = jwire(jcfg, n, 2, head_tokens=head)
        want = jenergy.gemm_fleet_energy(
            jcounts(jcfg, n, head_tokens=head, kv_rows=rows * 64, tp=2),
            chip="tpu_v5e", dtype=jcfg.activation_dtype,
            extra_hbm_bytes=scale * jkv_bytes(jcfg, rows * 64) / shard, tp=2,
            collective_bytes=wire, n_collectives=n_coll, overlap_chunks=4,
            name=f"{jcfg.name}:{key}")
        for f in ("energy_j", "step_s", "power_w", "n_chips",
                  "collective_s", "exposed_collective_s", "overlap_factor"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-9, err_msg=f"{key} {f}")
        assert got.n_chips == 2 and got.collective_s > 0
    assert eng.idle_power_w == 2 * eng.chip_spec.idle_power_w
    assert eng.tp == 2 and eng.cfg.tp_reduce == "gather"


def test_engine_refuses_split_heads():
    """A rank holds whole heads: tp=4 over the smoke config's 2 KV heads
    raises (the reference's GSPMD would split a head's columns)."""
    with pytest.raises(ValueError, match="whole heads"):
        _tp_engine("dense", tp=4)


def test_engine_takes_its_own_shard_back():
    """A second engine on params an earlier engine cut serves the same
    shard (no second cut); params of another config's shapes raise."""
    eng = _tp_engine()
    shapes = {n: p.shape for n, p in eng.params.named_parameters()}
    again = ServingEngine(eng.model, eng.params,
                          ModelConfig(**R.config_kw("dense")), device="cpu",
                          tp=2, mesh=Mesh(None, 0, 2))
    assert {n: p.shape for n, p in again.params.named_parameters()} == shapes
    wider = ModelConfig(**R.config_kw("dense", d_ff=256))
    with pytest.raises(ValueError, match="neither"):
        ServingEngine(eng.model, eng.params, wider, device="cpu", tp=2,
                      mesh=Mesh(None, 0, 2))
