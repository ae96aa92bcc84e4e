"""Elastic restart on the port, after the JAX package's
`tests/test_elastic.py`: a state trained and saved on four ranks (a
(1, 4) mesh: qwen2-7b's smoke config, whose 2 KV heads stay whole at
tp=4), then `launch.elastic.resume_elastic` on two ranks (prefer_model=2:
a (1, 2) mesh) and on one: the step comes back, every whole leaf of the
state equals what was saved, and the loss equals tp=1's within the f32
tolerance."""

from __future__ import annotations

import numpy as np
import torch

import torch_tp_train_ranks as R
from repro_torch.configs import get_config
from repro_torch.launch.elastic import best_mesh_for
from repro_torch.launch.mesh import RankPool
from repro_torch.models import bridge
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as tstep
from torch_train_families import OPT, batches, close, tbatch


def test_save_on_4_ranks_resume_on_2_and_on_1(tmp_path):
    cfg = get_config("qwen2-7b", smoke=True)
    api = get_model(cfg)
    model = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tree = bridge.params_to_numpy(model)
    steps = batches(cfg, 2, seed=3)
    probe = batches(cfg, 1, seed=4)[0]
    ckpt = str(tmp_path / "ck")
    # tp=1 in this process: the same two steps, then the probe's loss
    state = tstep.shard_state(bridge.params_from_numpy(tree, cfg, "cpu"),
                              api, cfg)
    fn = tstep.make_train_step(api, cfg, AdamWConfig(**OPT))
    for b in steps:
        state, _ = fn(state, b)
    with torch.no_grad():
        want = float(api.loss(state["params"], tbatch(probe), cfg)[0])
    with RankPool(4, timeout_s=240, threads=1) as pool:
        saved = pool.run(R.save_state, (1, 4), cfg, tree, steps, OPT, ckpt,
                         7)
    assert saved == [7] * 4
    with RankPool(2, timeout_s=240, threads=1) as pool:
        two = pool.run(R.resume_loss, ckpt, cfg, probe, 2)
    one = R.resume_loss(None, ckpt, cfg, probe, 16)
    assert [out["shape"] for out in two] == [{"data": 1, "model": 2}] * 2
    assert one["shape"] == {"data": 1, "model": 1}
    assert best_mesh_for(prefer_model=16).shape == one["shape"]
    for out in (*two, one):
        assert out["step"] == 7
        close(out["loss"], want, what="loss")
        assert set(out["state"]) == set(one["state"])
        for k, v in one["state"].items():
            np.testing.assert_array_equal(out["state"][k], v, err_msg=k)
