"""The port's training runtime on the CPU: the data pipeline (its batches
are the JAX package's bit for bit), checkpoints, the training loop with
resume, and the launcher; the JAX package's `tests/test_runtime.py` cases
(`TestDataPipeline`, `TestCheckpoint`, `TestTrainLoopEndToEnd`) on the
port, and a JAX-written checkpoint carried over through the bridge.

Token batches and integer state are compared exactly; a resumed port run
bit for bit against an uninterrupted one; the port continuing a JAX run
against JAX continuing it at f32 1e-5, the absolute part scaled by the
larger of 1 and the reference leaf's largest magnitude (as in
`test_torch_train.py`).
"""

from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipeline
from repro.models.registry import get_model as jget_model
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import (DataConfig, DataLoader, PipelineState,
                                       SyntheticLMDataset)
from repro_torch.launch import train as launch
from repro_torch.models import bridge
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, resume_or_init, run_train_loop
from repro_torch.train.step import init_train_state, make_train_step

TOL_F32 = 1e-5


def _close(got, want, tol: float, what: str = "") -> None:
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _tree_close(got: dict, want: dict, tol: float, where: str = "") -> None:
    assert set(got) == set(want), where
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], tol, f"{where}/{k}")
        else:
            _close(got[k], want[k], tol, f"{where}/{k}")


def _states_equal(a: dict, b: dict) -> None:
    """Two port train states bit for bit: params, optimizer state, rng."""
    pa, pb = dict(a["params"].named_parameters()), dict(
        b["params"].named_parameters())
    assert pa.keys() == pb.keys()
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
    assert torch.equal(a["opt"]["step"], b["opt"]["step"])
    for k in ("master", "m", "v"):
        for n in pa:
            assert torch.equal(a["opt"][k][n], b["opt"][k][n]), (k, n)
    assert torch.equal(a["rng"], b["rng"])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


class TestDataPipeline:
    """The JAX package's `TestDataPipeline` on the port."""

    def test_deterministic_across_restarts(self):
        ds = SyntheticLMDataset(DataConfig(seq_len=16, global_batch=4,
                                           vocab=100, seed=3))
        a, b = ds.batch_at(5), ds.batch_at(5)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_host_sharding_partitions_batch(self):
        ds = SyntheticLMDataset(DataConfig(seq_len=8, global_batch=8,
                                           vocab=50))
        h0 = ds.batch_at(0, host_id=0, n_hosts=2)
        h1 = ds.batch_at(0, host_id=1, n_hosts=2)
        assert h0["tokens"].shape == (4, 8)
        assert not np.array_equal(h0["tokens"], h1["tokens"])
        with pytest.raises(ValueError, match="split"):
            ds.batch_at(0, n_hosts=3)

    def test_loader_resume(self):
        ds = SyntheticLMDataset(DataConfig(seq_len=8, global_batch=2,
                                           vocab=50))
        l1 = DataLoader(ds)
        for _ in range(3):
            l1.next()
        ckpt = l1.checkpoint()
        b_next = l1.next()
        l2 = DataLoader(ds)
        l2.restore(ckpt)
        np.testing.assert_array_equal(l2.next()["tokens"], b_next["tokens"])

    def test_labels_are_shifted_tokens(self):
        ds = SyntheticLMDataset(DataConfig(seq_len=8, global_batch=2,
                                           vocab=50))
        b = ds.batch_at(0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("seed,vocab,seq,batch,hosts", [
    (0, 256, 32, 4, 1), (3, 49152, 64, 8, 2), (7, 100, 17, 6, 3)])
def test_batches_equal_jax_bit_for_bit(seed, vocab, seq, batch, hosts):
    kw = dict(seq_len=seq, global_batch=batch, vocab=vocab, seed=seed)
    ds = SyntheticLMDataset(DataConfig(**kw))
    jds = jpipeline.SyntheticLMDataset(jpipeline.DataConfig(**kw))
    np.testing.assert_array_equal(ds.probs, jds.probs)
    for step in (0, 1, 9):
        for host in range(hosts):
            got = ds.batch_at(step, host_id=host, n_hosts=hosts)
            want = jds.batch_at(step, host_id=host, n_hosts=hosts)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_loader_and_its_state_equal_jax():
    kw = dict(seq_len=8, global_batch=4, vocab=50, seed=1)
    loader = DataLoader(SyntheticLMDataset(DataConfig(**kw)), host_id=1,
                        n_hosts=2, prefetch=3)
    jloader = jpipeline.DataLoader(
        jpipeline.SyntheticLMDataset(jpipeline.DataConfig(**kw)), host_id=1,
        n_hosts=2, prefetch=3)
    for _ in range(4):
        np.testing.assert_array_equal(loader.next()["tokens"],
                                      jloader.next()["tokens"])
    assert loader.checkpoint() == jloader.checkpoint() == {"step": 4}
    assert PipelineState.from_dict({"step": "5"}).step == 5


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


class TestCheckpoint:
    """The JAX package's `TestCheckpoint` on the port, and bf16 leaves."""

    def _state(self, x=1.0):
        return {"params": {"w": torch.full((3, 3), x)},
                "opt": {"step": torch.tensor(7, dtype=torch.int32)}}

    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(10, self._state(2.5), data_state={"step": 10},
                 blocking=True)
        state, ds = mgr.restore()
        assert float(state["params"]["w"][0, 0]) == 2.5
        assert int(state["opt"]["step"]) == 7
        assert state["opt"]["step"].dtype == torch.int32
        assert ds["step"] == 10
        assert mgr.latest_step() == 10

    def test_async_save_then_wait(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, self._state(), blocking=False)
        mgr.wait()
        assert mgr.latest_step() == 1

    def test_gc_keeps_newest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in [1, 2, 3, 4]:
            mgr.save(s, self._state(float(s)), blocking=True)
        assert mgr.all_steps() == [3, 4]

    def test_restore_specific_step(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=5)
        for s in [1, 2]:
            mgr.save(s, self._state(float(s)), blocking=True)
        state, _ = mgr.restore(step=1)
        assert float(state["params"]["w"][0, 0]) == 1.0

    def test_atomic_no_partial_on_missing(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        with pytest.raises(FileNotFoundError):
            mgr.restore()

    def test_async_save_holds_the_values_at_save_time(self, tmp_path):
        """The host copy is taken by `save`: an in-place update while the
        writer runs does not reach the file."""
        mgr = CheckpointManager(str(tmp_path))
        state = self._state(1.0)
        mgr.save(1, state)
        state["params"]["w"].fill_(9.0)
        mgr.wait()
        assert float(mgr.restore()[0]["params"]["w"][0, 0]) == 1.0

    def test_bf16_leaves_restore_bit_exact(self, tmp_path):
        g = torch.Generator().manual_seed(0)
        w = torch.randn((5, 7), generator=g).bfloat16()
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(3, {"w": w, "u": torch.zeros(2, dtype=torch.uint32)},
                 blocking=True)
        manifest = json.loads((tmp_path / "step_000000003" /
                               "manifest.json").read_text())
        assert manifest["dtypes"] == {"w": "bfloat16", "u": "uint32"}
        assert manifest["keys"] == ["u", "w"]
        state, _ = mgr.restore()
        assert state["w"].dtype == torch.bfloat16
        assert torch.equal(state["w"], w)
        assert state["u"].dtype == torch.uint32

    def test_layout_and_restore_into_a_train_state(self, tmp_path):
        cfg = get_config("qwen2-7b", smoke=True)
        api = get_model(cfg)
        state = init_train_state(torch.Generator().manual_seed(0), api, cfg,
                                 device="cpu")
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(2, state, data_state={"step": 2}, blocking=True)
        assert (tmp_path / "LATEST").read_text() == "step_000000002"
        with np.load(tmp_path / "step_000000002" / "shard_0.npz") as z:
            keys = set(z.files)
        assert {"params__blocks.1.attn.wq", "opt__master__ln_f.scale",
                "opt__step", "rng"} <= keys
        fresh = init_train_state(torch.Generator().manual_seed(1), api, cfg,
                                 device="cpu")
        back, ds = mgr.restore(into=fresh)
        assert back is fresh and ds == {"step": 2}
        _states_equal(back, state)
        state["opt"]["m"]["ln_f.scale"] = torch.zeros(3)
        mgr.save(3, state, blocking=True)
        with pytest.raises(ValueError, match="ln_f.scale"):
            mgr.restore(into=fresh)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def _loop(cfg, ckpt_dir, steps: int, *, total: int, ckpt_every: int = 100,
          seed: int = 0) -> tuple:
    """Run the port's loop from its checkpoint or a seeded init up to
    `total` steps (at most `steps` of them)."""
    api = get_model(cfg)
    loader = DataLoader(SyntheticLMDataset(DataConfig(
        seq_len=32, global_batch=4, vocab=cfg.vocab, seed=0)))
    ckpt = CheckpointManager(str(ckpt_dir))
    state, start = resume_or_init(
        ckpt=ckpt, loader=loader,
        init_fn=lambda: init_train_state(torch.Generator().manual_seed(seed),
                                         api, cfg, device="cpu"))
    step_fn = make_train_step(api, cfg, AdamWConfig(lr=1e-3, warmup_steps=5,
                                                    decay_steps=100))
    state, summary = run_train_loop(
        train_step=step_fn, state=state, loader=loader, ckpt=ckpt,
        loop_cfg=LoopConfig(total_steps=min(total, start + steps),
                            ckpt_every=ckpt_every, log_every=1000),
        start_step=start, log_fn=lambda s: None,
        install_signal_handlers=False)
    return state, summary, start, loader


class TestTrainLoopEndToEnd:
    """The JAX package's `TestTrainLoopEndToEnd` on the port."""

    def test_loss_decreases_and_resumes(self, tmp_path):
        cfg = get_config("qwen2-7b", smoke=True)
        state, summary, _, _ = _loop(cfg, tmp_path, 30, total=30,
                                     ckpt_every=10)
        curve = summary["loss_curve"]
        assert curve[-5:].mean() < curve[:5].mean(), "loss did not decrease"
        assert summary["final_step"] == 30
        assert len(summary["grad_norms"]) == len(summary["step_times_s"]) \
            == 30
        assert np.isfinite(summary["grad_norms"]).all()
        # restart from checkpoint: resumes at step 30
        state2, _, start, loader2 = _loop(cfg, tmp_path, 0, total=30)
        assert start == 30
        assert loader2.state.step == 30
        _states_equal(state2, state)


def test_a_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """4 steps, against 2 steps, a checkpoint, a restore into a fresh state
    (other seed) and 2 more: params, optimizer state, rng and losses bit for
    bit."""
    cfg = get_config("starcoder2-3b", smoke=True)
    whole, s_whole, _, _ = _loop(cfg, tmp_path / "a", 4, total=4)
    _, s1, _, _ = _loop(cfg, tmp_path / "b", 2, total=4, ckpt_every=2)
    resumed, s2, start, _ = _loop(cfg, tmp_path / "b", 2, total=4, seed=9)
    assert start == 2
    _states_equal(resumed, whole)
    np.testing.assert_array_equal(
        np.concatenate([s1["loss_curve"], s2["loss_curve"]]),
        s_whole["loss_curve"])


def test_a_jax_checkpoint_continues_like_jax(tmp_path):
    """The JAX package trains 2 steps of qwen2-7b's f32 smoke config and
    checkpoints; the port restores that checkpoint through the bridge and
    takes 2 more steps beside JAX: losses and whole states agree."""
    jcfg, cfg = jget_config("qwen2-7b", smoke=True), get_config(
        "qwen2-7b", smoke=True)
    japi = jget_model(jcfg)
    opt = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
    jstep = jax.jit(jmake_train_step(japi, jcfg, JAdamWConfig(**opt)))
    ds = jpipeline.SyntheticLMDataset(jpipeline.DataConfig(
        seq_len=16, global_batch=4, vocab=jcfg.vocab, seed=2))
    jstate = jinit_train_state(jax.random.key(0), japi, jcfg)
    for s in range(2):
        jstate, _ = jstep(jstate, ds.batch_at(s))
    JCheckpointManager(str(tmp_path)).save(2, jstate, data_state={"step": 2},
                                           blocking=True)
    tree, data_state = CheckpointManager(str(tmp_path)).restore()
    assert data_state == {"step": 2}
    state = bridge.train_state_from_numpy(tree, cfg, device="cpu")
    step = make_train_step(get_model(cfg), cfg, AdamWConfig(**opt))
    for s in range(2, 4):
        jstate, jm = jstep(jstate, ds.batch_at(s))
        state, m = step(state, ds.batch_at(s))
        for k in jm:
            _close(m[k], jm[k], TOL_F32, k)
    got = bridge.train_state_to_numpy(state, cfg)
    want = jax.tree.map(np.asarray, jstate)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 4
    np.testing.assert_array_equal(got["rng"], want["rng"])
    _tree_close(got["params"], want["params"], TOL_F32, "params")
    for k in ("master", "m", "v"):
        _tree_close(got["opt"][k], want["opt"][k], TOL_F32, k)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_the_smoke_config_on_the_cpu(tmp_path):
    lines = []
    state, summary = launch.main(
        ["--arch", "starcoder2-3b", "--smoke", "--device", "cpu",
         "--steps", "3", "--batch", "2", "--seq", "16", "--log-every", "1",
         "--ckpt-every", "3", "--ckpt-dir", str(tmp_path)],
        log_fn=lines.append)
    assert summary["final_step"] == 3
    assert np.isfinite(summary["loss_curve"]).all()
    assert int(state["opt"]["step"]) == 3
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
    assert lines[0].startswith("arch=starcoder2-3b-smoke")
    assert sum(line.startswith("step ") for line in lines) == 3
    assert "tokens/s" in lines[1] and "grad_norm" in lines[1]
    # a second launch resumes at step 3 and has nothing left to do
    _, again = launch.main(
        ["--arch", "starcoder2-3b", "--smoke", "--device", "cpu",
         "--steps", "3", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path)], log_fn=lines.append)
    assert again["final_step"] == 3 and len(again["loss_curve"]) == 0


H100_BYTES = 80e9


def test_the_full_config_guard_admits_starcoder2_and_refuses_qwen2():
    """By the arithmetic alone, at 8 x 512 on an 80 GB card: starcoder2-3b
    (3.18 B params, 50.9 GB of state) fits, qwen2-7b (7.62 B, 121.8 GB)
    does not, and the refusal names both sizes."""
    star = get_config("starcoder2-3b")
    state, acts = launch.train_memory_bytes(star, 8, 512)
    assert state == 16 * star.n_params()
    assert 2e9 < acts < 10e9
    launch.check_fits(star, 8, 512, H100_BYTES)
    qwen = get_config("qwen2-7b")
    with pytest.raises(SystemExit, match=r"121\.8 GB.*GB"):
        launch.check_fits(qwen, 8, 512, H100_BYTES)
    # without remat every block's working set stays live
    no_remat = launch.train_memory_bytes(
        dataclasses.replace(star, remat=False), 8, 512)[1]
    assert no_remat > acts


def test_the_launcher_trains_full_configs_on_the_card_only():
    with pytest.raises(SystemExit, match="card"):
        launch.main(["--arch", "starcoder2-3b", "--device", "cpu"])
