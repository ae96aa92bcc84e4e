"""Training the SSM, hybrid, encoder-decoder and vision families under
tensor parallelism (psum mode) against the JAX package at tp=1, on the
CPU.

The port trains in rank processes (one `RankPool` of four gloo ranks for
the module: a tp=4 mesh, two copies of a tp=2 mesh, or a (data 2, model 2)
one; their entry points are `tests/torch_tp_train_ranks.py`), each rank
holding its shard of the weights bridged from JAX. The smoke configs,
f32: mamba1 (falcon-mamba-7b: x_proj's rows cut, its partial product
summed both ways), mamba2 (B and C whole in in_proj and the conv, the
gated norm's sum of squares summed both ways), hybrid (zamba2-2.7b: the
Mamba2 groups and the shared attention block), encdec
(seamless-m4t-medium: the encoder, the cross-attention's entries) and vlm
(qwen2-vl-2b: M-RoPE, q/k/v biases, 2 KV heads whole at tp=4). The loss,
its metrics and every gathered gradient leaf against
`jax.value_and_grad`, and three steps of `make_train_step` against
``jax.jit(make_train_step)``, at the f32 tolerance with its absolute part
scaled by max(1, max|reference leaf|); every leaf and part "model" leaves
whole has the same gradient bits on every rank, and the global norm is
tp=1's. Then remat over the hybrid's groups in another thread (autograd's
device thread on the card), an encdec vocab that tp=4 does not divide and
tp=2 cuts into 127 columns, the hybrid at (data 2, model 2) with ZeRO-1,
a checkpoint written at tp=2 restored at tp=1 and tp=4, the launcher's
``--tp 2`` for the SSM kinds, and `train_config`'s divisibility rule.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_tp_train_ranks as R
from repro.models.registry import get_model as jget_model
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import Mesh, RankPool
from repro_torch.models import bridge
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as tstep
from torch_train_families import OPT, batches, cfgs, close, tbatch, to_numpy

# case -> (kind, config changes); encdec-v254: a vocab tp=4 does not divide
# and tp=2 cuts into 127 columns, not a multiple of 8
CASES = {"mamba1": ("mamba1", {}), "mamba2": ("mamba2", {}),
         "hybrid": ("hybrid", {}), "encdec": ("encdec", {}),
         "vlm": ("vlm", {}), "encdec-v254": ("encdec", {"vocab": 254})}
KINDS = ("mamba1", "mamba2", "hybrid", "encdec", "vlm")


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, timeout_s=240, threads=1) as p:
        yield p


def _cfgs(case: str) -> tuple:
    kind, changes = CASES[case]
    return cfgs(kind, **changes)


@pytest.fixture(scope="module")
def reference():
    """{case: the JAX package's tp=1 numbers}, each made once, jitted: the
    weights (numpy), one batch's loss, metrics, gradients (by the port's
    names) and their global norm, and three train steps' metrics and
    final state (by flat checkpoint key)."""
    out = {}

    def get(case: str) -> dict:
        if case in out:
            return out[case]
        jcfg, cfg = _cfgs(case)
        japi = jget_model(jcfg)
        jstate = jax.jit(lambda key: jstep.init_train_state(
            key, japi, jcfg))(jax.random.key(0))
        batch = batches(cfg, 1)[0]
        (jl, jm), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True),
                               static_argnums=2)(jstate["params"], batch,
                                                 jcfg)
        steps = batches(cfg, 3, seed=7)
        tree = to_numpy(jstate["params"])
        jfn = jax.jit(jstep.make_train_step(japi, jcfg,
                                            jadamw.AdamWConfig(**OPT)))
        metrics = []
        for b in steps:
            jstate, m = jfn(jstate, b)
            metrics.append({k: float(v) for k, v in m.items()})
        final = to_numpy(jstate)
        flat = {f"params__{n}": t for n, t in bridge.named_from_numpy(
            final["params"], cfg, "cpu").items()}
        for k in ("master", "m", "v"):
            flat.update({f"opt__{k}__{n}": t for n, t in
                         bridge.named_from_numpy(final["opt"][k], cfg,
                                                 "cpu").items()})
        grads = bridge.named_from_numpy(to_numpy(jg), cfg, "cpu")
        norm = float(np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                                 for g in grads.values())))
        out[case] = {
            "cfg": cfg, "tree": tree, "batch": batch, "loss": float(jl),
            "metrics": {k: float(v) for k, v in jm.items()},
            "grads": grads, "grad_norm": norm, "steps": steps,
            "step_metrics": metrics, "final": flat}
        return out[case]

    return get


@pytest.fixture(scope="module")
def grads_at(pool, reference):
    """{(case, tp): every rank's `R.loss_and_grads` of the case's batch},
    each run once."""
    runs = {}

    def get(case: str, tp: int) -> list:
        if (case, tp) not in runs:
            ref = reference(case)
            runs[case, tp] = pool.run(R.loss_and_grads, (1, tp), ref["cfg"],
                                      ref["tree"], ref["batch"])
        return runs[case, tp]

    return get


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_every_gradient_leaf_match_jax(case, tp, grads_at,
                                                reference):
    """Every rank's loss and metrics and the gathered gradient of every
    leaf (the parts a leaf holds whole once) equal `jax.value_and_grad`'s
    at tp=1."""
    ref = reference(case)
    for out in grads_at(case, tp):
        close(out["loss"], ref["loss"], what="loss")
        assert set(out["metrics"]) == set(ref["metrics"])
        for k, v in ref["metrics"].items():
            close(out["metrics"][k], v, what=k)
        assert set(out["grads"]) == set(ref["grads"])
        for n, g in ref["grads"].items():
            close(out["grads"][n], g, what=n)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_whole_leaves_and_parts_have_one_gradient_on_every_rank(
        kind, tp, grads_at, reference):
    """The leaves "model" leaves whole (norms; the vlm's wk, wv, bk and bv
    at tp=4) and the parts a leaf cut by parts holds whole (Mamba2's B and
    C columns of in_proj and rows of its conv, summed over "model" after
    the backward) have the same gradient bits on every rank, and every
    rank's global norm is tp=1's."""
    ranks = grads_at(kind, tp)
    ref = reference(kind)
    whole, parts = ranks[0]["whole_leaves"], ranks[0]["whole_parts"]
    assert whole
    if kind in ("mamba2", "hybrid"):
        assert parts and all(n.endswith(("in_proj", "conv_w", "conv_b"))
                             for n in parts)
        assert len(parts) == 3 * ref["cfg"].n_layers
    else:
        assert not parts
    if kind == "vlm" and tp == 4:
        assert {"blocks.0.attn.wk", "blocks.0.attn.bv"} <= set(whole)
    for out in ranks:
        close(out["grad_norm"], ref["grad_norm"], what="grad norm")
    for out in ranks[1:]:
        for n, g in whole.items():
            np.testing.assert_array_equal(out["whole_leaves"][n], g,
                                          err_msg=n)
        for n, blocks in parts.items():
            for got, want in zip(out["whole_parts"][n], blocks):
                np.testing.assert_array_equal(got, want, err_msg=n)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_three_train_steps_match_jax(case, tp, pool, reference):
    """Three steps of `make_train_step` on the tp mesh against
    ``jax.jit(make_train_step)`` at tp=1: each step's metrics (loss, the
    global grad norm, lr, clip scale), then the whole gathered params,
    master, m and v."""
    ref = reference(case)
    out = pool.run(R.train_steps, (1, tp), ref["cfg"], ref["tree"],
                   ref["steps"], OPT)[0]
    assert out["step"] == 3
    for got, want in zip(out["metrics"], ref["step_metrics"]):
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], what=k)
    assert set(out["state"]) >= set(ref["final"])
    for k, want in ref["final"].items():
        close(out["state"][k], want, what=k)


def test_hybrid_remat_recomputes_its_groups_collectives_in_another_thread(
        pool, reference):
    """With remat over the hybrid's groups (its Mamba2 blocks and the
    shared block), the backward run in a thread of its own (autograd's
    device thread on the card, where the thread's mesh is not set) gives
    tp=1's gradients at tp=2, and makes per group: the recomputation's
    two all-reduces of each Mamba2 block (the gated norm's sum, out_proj)
    and the shared block's wo (it stops after the block's last saved
    tensor, w_down's input), the backward's two of each Mamba2 block (its
    entry, the norm's sum) and the shared block's two entries; then the
    vocab-parallel head's entry."""
    ref = reference("hybrid")
    cfg = dataclasses.replace(ref["cfg"], remat=True)
    E = cfg.attn_every
    ranks = pool.run(R.loss_and_grads, (1, 2), cfg, ref["tree"],
                     ref["batch"], True)
    for out in ranks:
        close(out["loss"], ref["loss"], what="loss")
        for n, g in ref["grads"].items():
            close(out["grads"][n], g, what=n)
        groups = cfg.n_layers // E
        assert out["backward_collectives"] == groups * (4 * E + 3) + 1


@pytest.mark.parametrize("tp,cols", [(2, 127), (4, 254)])
def test_an_uneven_vocab_is_cut_or_kept_whole(tp, cols):
    """encdec at vocab 254: tp=2 cuts the head into 127 columns a rank (on
    storage rows padded to 128, so the GEMM's fast paths read them) and
    the table into 127 rows; tp=4 does not divide it, so both stay whole
    (the head then goes through `transformer._unembed`)."""
    _, cfg = _cfgs("encdec-v254")
    tcfg = dataclasses.replace(cfg, tp_collectives="explicit",
                               tp_reduce="psum")
    model = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    sharding.shard_params(model, Mesh(None, 1, tp), "psum", cfg=tcfg)
    assert tuple(model.head["w"].shape) == (cfg.d_model, cols)
    assert tuple(model.embed["table"].shape) == (cols, cfg.d_model)
    if tp == 2:
        assert model.head["w"].stride(0) == 128


def test_hybrid_data_and_zero1_match_jax(pool, reference):
    """The hybrid at (data 2, model 2) with ZeRO-1: three steps equal the
    JAX package's at tp=1, and no leaf's optimizer state is cut over
    "data" on the axis "model" cuts by parts (in_proj's columns, the
    conv's channels)."""
    ref = reference("hybrid")
    ranks = pool.run(R.train_steps, (2, 2), ref["cfg"], ref["tree"],
                     ref["steps"], OPT, True)
    for got, want in zip(ranks[0]["metrics"], ref["step_metrics"]):
        for k in want:
            close(got[k], want[k], what=k)
    for k, want in ref["final"].items():
        close(ranks[0]["state"][k], want, what=k)
    cut = {"ssm.in_proj": 1, "ssm.conv_w": 0, "ssm.conv_b": 0}
    for out in ranks:
        for name, held in out["local"]["m"].items():
            shp = out["params_local"][name]
            axis = cut.get(name.split(".", 2)[-1])
            if axis is not None:
                assert held[axis] == shp[axis], name


def test_a_checkpoint_written_at_tp2_restores_at_tp1_and_tp4(pool,
                                                            reference,
                                                            tmp_path):
    """The hybrid trained two steps at tp=2 and saved (whole leaves, B and
    C once), then `launch.elastic.resume_elastic` on the pool's four ranks
    at tp=4 and in this process at tp=1: the step comes back, every whole
    leaf of the state equals tp=1's bit for bit, and the loss of a probe
    batch equals tp=1's within the f32 tolerance."""
    ref = reference("hybrid")
    cfg, tree = ref["cfg"], ref["tree"]
    steps = ref["steps"][:2]
    probe = batches(cfg, 1, seed=4)[0]
    ckpt = str(tmp_path / "ck")
    assert pool.run(R.save_state, (1, 2), cfg, tree, steps, OPT, ckpt,
                    5) == [5] * 4
    four = pool.run(R.resume_loss, ckpt, cfg, probe, 4)
    one = R.resume_loss(None, ckpt, cfg, probe, 16)
    assert [out["shape"] for out in four] == [{"data": 1, "model": 4}] * 4
    assert one["shape"] == {"data": 1, "model": 1}
    api = get_model(cfg)
    state = tstep.shard_state(bridge.params_from_numpy(tree, cfg, "cpu"),
                              api, cfg)
    fn = tstep.make_train_step(api, cfg, AdamWConfig(**OPT))
    for b in steps:
        state, _ = fn(state, b)
    with torch.no_grad():
        want = float(api.loss(state["params"], tbatch(probe), cfg)[0])
    for out in (*four, one):
        assert out["step"] == 5
        close(out["loss"], want, what="loss")
        assert set(out["state"]) == set(one["state"])
        for k, v in one["state"].items():
            np.testing.assert_array_equal(out["state"][k], v, err_msg=k)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_the_launchers_tp2_trains_the_ssm_kinds_as_tp1(arch, tmp_path):
    """``--tp 2 --device cpu --smoke`` for Mamba1 and the hybrid against
    ``--tp 1``: the same losses and grad norms, step for step, at the f32
    tolerance."""
    common = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
              "--batch", "4", "--seq", "16", "--log-every", "1"]
    _, one = launch.main(common + ["--ckpt-dir", str(tmp_path / "one")],
                         log_fn=lambda _: None)
    state, two = launch.main(common + ["--tp", "2", "--ckpt-dir",
                                       str(tmp_path / "two")],
                             log_fn=lambda _: None)
    assert state is None and two["final_step"] == 2
    close(two["loss_curve"], one["loss_curve"], what="loss")
    close(two["grad_norms"], one["grad_norms"], what="norms")


@pytest.mark.parametrize("kind,tp", [("mamba1", 2), ("hybrid", 2),
                                     ("hybrid", 4)])
def test_a_ranks_params_count_the_whole_parts_once(kind, tp):
    """`launch.train._rank_params` equals a rank's shard as
    `sharding.shard_params` cuts it: Mamba2's B and C held whole."""
    _, cfg = cfgs(kind)
    tcfg = dataclasses.replace(cfg, tp_collectives="explicit",
                               tp_reduce="psum")
    model = get_model(cfg).init(cfg, None, device="meta")
    sharding.shard_params(model, Mesh(None, 0, tp), "psum", cfg=tcfg)
    held = sum(p.numel() for p in model.parameters())
    assert launch._rank_params(cfg, tp) == held < cfg.n_params()


def test_train_config_takes_falcon_mambas_unused_heads():
    """falcon-mamba-7b's ``n_heads=1`` (unused by Mamba1) does not stop
    tp=2: the rule is what the kind shards, its 8192 d_inner channels."""
    cfg = get_config("falcon-mamba-7b")
    assert cfg.n_heads == 1
    tcfg = tstep.train_config(cfg, Mesh(None, 0, 2))
    assert (tcfg.tp_collectives, tcfg.tp_reduce) == ("explicit", "psum")


@pytest.mark.parametrize("kind,tp,what", [
    ("mamba1", 3, "d_inner=128"),
    ("mamba2", 16, "ssd_heads=8"),
    ("hybrid", 8, "n_heads=4"),
    ("encdec", 8, "n_heads=4"),
], ids=["mamba1-channels", "mamba2-heads", "hybrid-heads", "encdec-heads"])
def test_train_config_refuses_a_split_block(kind, tp, what):
    """A tp that does not divide what the kind shards raises ValueError
    naming it, through the serving engine's rule: Mamba1's 128 d_inner
    channels at tp=3, Mamba2's 8 SSD heads at tp=16 (which divides its
    128 channels: a head would be split), the hybrid's and the
    encoder-decoder's 4 attention heads at tp=8."""
    _, cfg = cfgs(kind)
    with pytest.raises(ValueError, match=f"{what}.*whole heads"):
        tstep.train_config(cfg, Mesh(None, 0, tp))
