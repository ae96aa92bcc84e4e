"""Data parallelism and ZeRO-1 in the port's train step, on the CPU, and
the launcher's tensor-parallel path.

One `RankPool` of four gloo ranks for the module holds a (data 2, model 1)
mesh twice over or one (2, 2) mesh (`tests/torch_tp_train_ranks.py`).
ZeRO-1 (the reference's `zero1_shardings`: master, m and v cut over
"data") must give the unsharded optimizer's state bit for bit, each rank
holding a data-th of every cut leaf; the loss over a masked batch whose
shards hold different token counts is the whole batch's (the global
masked sum over the global count, not a mean of the shards' means), as
the port computes it at tp=1. The launcher's ``--tp 2`` (its own two rank
processes) trains the smoke config to the same losses as ``--tp 1``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_tp_train_ranks as R
from repro_torch.configs import get_config
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import RankPool
from repro_torch.models import bridge
from repro_torch.models.registry import get_model
from torch_train_families import OPT, batches, close, tbatch

ARCH = "qwen2-7b"


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, timeout_s=240, threads=1) as p:
        yield p


@pytest.fixture(scope="module")
def weights():
    cfg = get_config(ARCH, smoke=True)
    model = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    return cfg, bridge.params_to_numpy(model)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_zero1_equals_the_unsharded_optimizer_bit_for_bit(shape, pool,
                                                          weights):
    """Three steps with ZeRO-1 on and off: the same metrics and the same
    whole params, master, m and v, bit for bit; with it on each rank holds
    half of a cut leaf's f32 state on one axis (the first that "model"
    does not shard and 2 divides), every weight matrix cut, and without
    it the whole of its shard."""
    cfg, tree = weights
    steps = batches(cfg, 3, seed=5)
    on = pool.run(R.train_steps, shape, cfg, tree, steps, OPT, True)
    off = pool.run(R.train_steps, shape, cfg, tree, steps, OPT, False)
    assert on[0]["metrics"] == off[0]["metrics"]
    assert set(on[0]["state"]) == set(off[0]["state"])
    for k, v in off[0]["state"].items():
        np.testing.assert_array_equal(on[0]["state"][k], v, err_msg=k)
    for out in on:
        for name, shp in out["params_local"].items():
            held = out["local"]["m"][name]
            assert out["local"]["master"][name] == held
            cut = [i for i, (a, b) in enumerate(zip(held, shp)) if a != b]
            assert cut == [] or (len(cut) == 1
                                 and held[cut[0]] * 2 == shp[cut[0]]), name
            if len(shp) == 2:
                assert len(cut) == 1, name
    assert all(out["local"]["m"] == {n: tuple(s) for n, s in
                                     out["params_local"].items()}
               for out in off)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_a_masked_batch_gives_the_global_loss(shape, pool, weights):
    """A loss mask whose two data shards hold 30 and 9 tokens: the loss,
    nll and accuracy on every rank are the whole batch's at tp=1 (which a
    mean of the shards' means misses), and so are the gradients."""
    cfg, tree = weights
    batch = dict(batches(cfg, 1, seed=9)[0])
    mask = np.zeros((4, 16), np.float32)
    mask[:2, :15] = 1.0
    mask[2:, :4] = 1.0
    mask[3, 4] = 1.0
    batch["loss_mask"] = mask
    api = get_model(cfg)
    params = bridge.params_from_numpy(tree, cfg, device="cpu")
    for p in params.parameters():
        p.requires_grad_(True)
    loss, metrics = api.loss(params, tbatch(batch), cfg)
    grads = dict(zip([n for n, _ in params.named_parameters()],
                     torch.autograd.grad(loss, list(params.parameters()))))
    halves = [float(api.loss(params, tbatch({k: v[i:i + 2] for k, v in
                                             batch.items()}), cfg)[0])
              for i in (0, 2)]
    assert abs(np.mean(halves) - float(loss)) > 1e-3
    for out in pool.run(R.loss_and_grads, shape, cfg, tree, batch):
        close(out["loss"], loss, what="loss")
        for k in ("nll", "accuracy"):
            close(out["metrics"][k], metrics[k], what=k)
        for n, g in grads.items():
            close(out["grads"][n], g, what=n)


def test_the_launchers_tp2_trains_as_tp1(tmp_path):
    """``--tp 2 --device cpu --smoke`` (two rank processes over gloo)
    against ``--tp 1``: the same losses and grad norms, step for step, at
    the f32 tolerance; ``--tp 2 --dp 2 --zero1`` too."""
    common = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
              "--batch", "4", "--seq", "16", "--log-every", "1"]
    _, one = launch.main(common + ["--ckpt-dir", str(tmp_path / "one")],
                         log_fn=lambda _: None)
    for extra in (["--tp", "2"], ["--tp", "2", "--dp", "2", "--zero1"]):
        state, two = launch.main(common + extra + [
            "--ckpt-dir", str(tmp_path / "-".join(extra))])
        assert state is None and two["final_step"] == 3
        close(two["loss_curve"], one["loss_curve"], what=f"{extra} loss")
        close(two["grad_norms"], one["grad_norms"], what=f"{extra} norms")
