"""Rank entry points of the tensor-parallel CPU tests
(`test_torch_tp_serving.py`, `test_torch_tp_dense4.py`).

Not a test file: the tests import it by name (pytest puts `tests/` on the
path), and `launch.mesh.RankPool` runs its functions in rank processes,
which import this module and `repro_torch`, never JAX or the test module.
Every function takes the rank's `Mesh` first and returns picklable data.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import tp as TP
from repro_torch.distributed.sharding import set_mesh
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Request, ServingEngine

# the JAX package's tensor-parallel smoke configs and workload
# (`tests/test_tp_serving.py`): every family's kwargs over one base, five
# requests of (prompt seed, prompt length, budget), and each admit family's
# modality input per uid
BASE = dict(name="tp-test", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, vocab=128, param_dtype="float32",
            activation_dtype="float32", remat=False)
FAMILY_KW = {
    "dense": dict(d_ff=128),
    "moe": dict(d_ff=0, n_experts=4, top_k=2, d_ff_expert=64,
                capacity_factor=16.0),
    "mla_moe": dict(d_ff=128, n_experts=4, top_k=2, d_ff_expert=64,
                    capacity_factor=16.0, n_shared_experts=1,
                    kv_lora_rank=16, rope_head_dim=8),
    "mamba1": dict(d_ff=0, ssm_state=8, expand=2, d_conv=4),
    "mamba2": dict(d_ff=0, ssm_state=8, expand=2, d_conv=4,
                   ssm_headdim=16, ssm_ngroups=1),
    "hybrid": dict(d_ff=128, ssm_state=8, expand=2, d_conv=4,
                   ssm_headdim=16, ssm_ngroups=1, attn_every=2),
    "encdec": dict(d_ff=128, n_encoder_layers=2, gated_mlp=False),
    "vlm": dict(d_ff=128, qkv_bias=True, mrope=True,
                mrope_sections=(4, 2, 2)),
}
SPECS = [(0, 11, 10), (1, 7, 8), (2, 19, 6), (3, 5, 12), (4, 13, 4)]


def config_kw(kind: str, **over) -> dict:
    """The ModelConfig keyword arguments of `kind`'s smoke config (both
    packages' ModelConfig take them)."""
    return {**BASE, "kind": kind, **FAMILY_KW[kind], **over}


def extras(kind: str, d_model: int, uid: int):
    """Request `uid`'s modality input for an admit family, else None."""
    rng = np.random.default_rng(900 + uid)
    if kind == "encdec":
        t = 5 + 2 * (uid % 3)
        return {"src_embeds": rng.standard_normal(
            (t, d_model)).astype(np.float32)}
    if kind == "vlm":
        grid = [(4, 4), (2, 3), None][uid % 3]
        if grid is None:
            return None
        gh, gw = grid
        return {"patch_embeds": rng.standard_normal(
            (gh * gw, d_model)).astype(np.float32), "grid_hw": grid}
    return None


def requests(kind: str, d_model: int, vocab: int, specs=SPECS) -> list:
    """(uid, prompt, max_new_tokens, extras) of the workload."""
    return [(uid, np.random.default_rng(seed).integers(0, vocab, n).astype(
                np.int32), mnt, extras(kind, d_model, uid))
            for uid, (seed, n, mnt) in enumerate(specs)]


# the report entries the tests read
REPORT_KEYS = ("tp", "requests", "generated_tokens", "decode_steps",
               "chunk_steps", "model_s", "collective_wire_s",
               "overlap_factor", "energy_j", "j_per_token")


def serve(mesh, cfg, tree: dict, requests: list, engine_kw: dict,
          drains: int = 1, device: str = "cpu") -> dict:
    """Bridge the JAX parameter tree (numpy) into the port on `device`,
    build an engine at the mesh's tp (the engine cuts this rank's shard)
    and serve `requests` ((uid, prompt, max_new_tokens, extras)) to
    completion, `drains` times over (uids shifted by 100 per repeat).
    Returns the streams of each drain, the report's entries, the decode
    step's estimate, each parameter's and decode-state leaf's local shape
    and, on the paged layout, the allocator's counters after the last
    drain."""
    params = params_from_numpy(tree, cfg, device=device)
    eng = ServingEngine(get_model(cfg), params, cfg, device=device,
                        tp=mesh.tp, mesh=mesh if mesh.tp > 1 else None,
                        **engine_kw)
    streams = []
    for rep in range(drains):
        for uid, prompt, mnt, extras in requests:
            eng.submit(Request(uid=uid + 100 * rep, prompt=prompt.copy(),
                               max_new_tokens=mnt, extras=extras))
        streams.append({r.uid - 100 * rep: r.tokens.tolist()
                        for r in eng.run_until_empty()})
    report = eng.report()
    est = eng.decode_step_estimate()
    eng._activate()
    state = eng._init_state(eng.max_batch)
    out = {"streams": streams,
           "report": {k: report[k] for k in REPORT_KEYS},
           "estimate": {"n_chips": est.n_chips,
                        "collective_s": est.collective_s,
                        "energy_j": est.energy_j},
           "params": {n: tuple(p.shape)
                      for n, p in params.named_parameters()},
           "state": _shapes(state)}
    if eng._allocator is not None:
        alloc = eng._allocator
        out["paging"] = {"in_use": alloc.in_use,
                         "held": int((alloc.refs > 0).sum()),
                         "min_ref": int(alloc.refs.min()),
                         "pool": {k: tuple(v.shape)
                                  for k, v in eng._pool.items()}}
    return out


def _shapes(tree) -> dict:
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def logits(mesh, cfg, tree: dict, tokens: np.ndarray,
           f32_state: bool = False) -> np.ndarray:
    """The f32 logits of one chunk call over `tokens` (B, S) from a zero
    state (its caches widened to f32 with `f32_state`), at the mesh's tp
    (the whole vocabulary, gathered)."""
    params = params_from_numpy(tree, cfg, device="cpu")
    eng = ServingEngine(get_model(cfg), params, cfg, device="cpu",
                        max_batch=tokens.shape[0], max_len=64,
                        tp=mesh.tp, mesh=mesh if mesh.tp > 1 else None)
    eng._activate()
    state = eng._init_state(tokens.shape[0])
    if f32_state:
        state = _widen(state)
    with torch.no_grad():
        out, _ = eng.model.prefill_chunk(
            eng.params, torch.as_tensor(tokens),
            torch.full((tokens.shape[0],), tokens.shape[1]), state, eng.cfg)
    return out.numpy()


def _widen(tree):
    """A state tree with its floating leaves in f32."""
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


# what `tp.tp_enabled` and `tp.replicate_for_parity` read of a config
_GATHER = type("GatherMode", (), dict(tp_collectives="explicit",
                                      tp_reduce="gather"))


def layers(mesh, x: np.ndarray, w: np.ndarray, table: np.ndarray,
           tokens: np.ndarray, chunks: int) -> dict:
    """The tp primitives on this rank's shards of whole operands: the
    column-parallel product's columns, `row_parallel_gather` of a sharded
    and of a whole input (with `chunks` chunks), `row_parallel` (psum mode)
    of the row shards, gather mode's `replicate_for_parity` of the sharded
    input, the vocab-sharded embedding lookup and head."""
    set_mesh(mesh)
    TP.collectives.calls = 0
    tp, r = mesh.tp, mesh.rank
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    n, k = wt.shape[1], wt.shape[0]
    cols = wt[:, r * n // tp:(r + 1) * n // tp].contiguous()
    rows = wt[r * k // tp:(r + 1) * k // tp].contiguous()
    x_loc = xt[..., r * k // tp:(r + 1) * k // tp].contiguous()
    tab = torch.as_tensor(table)
    v = tab.shape[0]
    tab_loc = tab[r * v // tp:(r + 1) * v // tp].contiguous()
    try:
        return {
            "column": TP.column_parallel(xt, cols, n).numpy(),
            "gather": TP.row_parallel_gather(x_loc, cols, n, chunks).numpy(),
            "gather_whole": TP.row_parallel_gather(xt, cols, n,
                                                   chunks).numpy(),
            "psum": TP.row_parallel(x_loc, rows, chunks).numpy(),
            "replicated": TP.replicate_for_parity(x_loc, -1, _GATHER).numpy(),
            "embed": TP.embed_lookup(tab_loc, torch.as_tensor(tokens),
                                     v).numpy(),
            "head": TP.unembed(xt, tab_loc, v, transpose_b=True).numpy(),
            "collectives": TP.collectives.calls,
        }
    finally:
        set_mesh(None)


def fail_on(mesh, rank: int | None) -> int:
    """Raise on rank `rank`; return this rank otherwise."""
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return mesh.rank


def host_mesh(mesh, model_parallel: int) -> tuple:
    """`make_host_mesh(model_parallel)` over the pool's ranks: its shape,
    this rank's "model" rank, and the global ranks its row's group holds
    (one all-gather over the group)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    m = make_host_mesh(model_parallel)
    me = torch.tensor([dist.get_rank()])
    parts = [torch.empty_like(me) for _ in range(m.tp)]
    dist.all_gather(parts, me, group=m.group)
    return m.shape, m.rank, [int(p) for p in parts]
