"""The other families' training through the launcher and the kernel, on the
CPU: the memory guard by kind, the launcher on every LM kind (and its
refusal of the modality kinds, whose batches its pipeline cannot make),
every GEMM of a step and both of its gradients through `ops.matmul`, and
the loop's preemption save (the JAX package's
`tests/test_train_ft.py::test_sigterm_triggers_final_blocking_save` on
the port's loop).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.configs.seamless_m4t_medium import _src_len as jsrc_len
from repro_torch.configs import get_config
from repro_torch.configs.seamless_m4t_medium import src_len
from repro_torch.kernels import ops
from repro_torch.launch import train as launch
from repro_torch.optim import adamw
from repro_torch.train import step as tstep
from repro_torch.models.registry import get_model
from torch_train_families import (FAMILIES, OPT, batches, cfgs, jax_state,
                                  port_state)

H100_BYTES = 80e9


@pytest.mark.parametrize("arch,layers,batch,seq,fits", [
    ("zamba2-2.7b", None, 8, 512, True),
    ("qwen2-vl-2b", None, 2, 2048, True),
    ("seamless-m4t-medium", None, 8, 512, True),
    ("olmoe-1b-7b", 8, 8, 512, True),
    ("olmoe-1b-7b", None, 8, 512, False),
    ("falcon-mamba-7b", None, 8, 512, False),
    ("deepseek-v2-236b", 1, 8, 512, False)])
def test_the_guard_admits_and_refuses_each_family(arch, layers, batch, seq,
                                                  fits):
    """By the arithmetic alone on an 80 GB card: zamba2-2.7b, qwen2-vl-2b
    (2 x 2048: its 1,024 patches and as many text tokens) and
    seamless-m4t-medium train at full depth, olmoe-1b-7b at 8 of its 16
    layers; full olmoe-1b-7b and falcon-mamba-7b are refused, and
    deepseek-v2-236b even at one layer (its embedding and one MoE layer of
    160 experts are 80.3 GB of state)."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if fits:
        launch.check_fits(cfg, batch, seq, H100_BYTES)
    else:
        with pytest.raises(SystemExit, match="does not train on one card"):
            launch.check_fits(cfg, batch, seq, H100_BYTES)


def test_each_kind_brings_its_working_set():
    """The activation estimate holds each kind's own working set: Mamba1's
    (B, S, d_inner, d_state) f32 scan tensors, the SSD scan's intra-block
    temporaries, the MoE dispatch buffer (E, B x capacity, d) in f32 and
    the encoder over its source; remat keeps one unit's, not every one's."""
    t = 8 * 512
    falcon = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=8)
    di, ds = falcon.d_inner, falcon.ssm_state
    assert launch.train_memory_bytes(falcon, 8, 512)[1] > 10 * t * di * ds * 4
    olmoe = get_config("olmoe-1b-7b")
    cap = int(olmoe.capacity_factor * 512 * olmoe.top_k / olmoe.n_experts)
    dispatch = olmoe.n_experts * 8 * cap * olmoe.d_model * 4
    dense = dataclasses.replace(olmoe, kind="dense", d_ff=1)
    assert (launch.train_memory_bytes(olmoe, 8, 512)[1]
            - launch.train_memory_bytes(dense, 8, 512)[1]) > dispatch
    seamless = get_config("seamless-m4t-medium")
    no_encoder = dataclasses.replace(seamless, n_encoder_layers=0)
    assert (launch.train_memory_bytes(seamless, 8, 512)[1]
            > launch.train_memory_bytes(no_encoder, 8, 512)[1])
    for arch in ("zamba2-2.7b", "qwen2-vl-2b", "falcon-mamba-7b"):
        cfg = get_config(arch)
        remat = launch.train_memory_bytes(cfg, 8, 512)[1]
        every = launch.train_memory_bytes(
            dataclasses.replace(cfg, remat=False), 8, 512)[1]
        assert every > remat


@pytest.mark.parametrize("seq", [1, 16, 31, 32, 512, 4096])
def test_source_length_rule_equals_the_reference(seq):
    assert src_len(seq) == jsrc_len(seq)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b",
                                  "falcon-mamba-7b", "zamba2-2.7b"])
def test_launcher_trains_each_lm_kind_on_the_cpu(arch, tmp_path):
    lines = []
    state, summary = launch.main(
        ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--log-every", "1",
         "--ckpt-dir", str(tmp_path)], log_fn=lines.append)
    assert summary["final_step"] == 2 and int(state["opt"]["step"]) == 2
    assert np.isfinite(summary["loss_curve"]).all()
    assert np.isfinite(summary["grad_norms"]).all()
    assert sum(line.startswith("step ") for line in lines) == 2


@pytest.mark.parametrize("arch,needs", [
    ("seamless-m4t-medium", "src_embeds"),
    ("qwen2-vl-2b", "patch_embeds")])
def test_launcher_refuses_the_modality_kinds(arch, needs, tmp_path):
    """The JAX launcher gives encdec and vlm no modality inputs; the port's
    says so instead of failing inside the loss."""
    with pytest.raises(SystemExit, match=needs):
        launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path)])


def _forward_gemms(cfg) -> int:
    """One forward's products through `ops.matmul`, from the structure:
    per layer moe q, k, v, o and the router; mla_moe w_dq and w_uq (or
    w_uq alone), w_dkv, w_kpe, w_uk, w_uv, wo, the router and the shared
    experts' gate, up and down; mamba1 in_proj, x_proj, dt_proj, out_proj;
    mamba2 in_proj and out_proj, and hybrid each application of the shared
    block; encdec's encoder layers, decoder layers and their cross-KV; vlm
    a dense block; then the head."""
    mlp = 3 if cfg.gated_mlp else 2
    L = cfg.n_layers
    per_kind = {
        "moe": 5 * L,
        "mla_moe": L * ((2 if cfg.q_lora_rank else 1) + 6
                        + (3 if cfg.n_shared_experts else 0)),
        "mamba1": 4 * L,
        "mamba2": 2 * L,
        "hybrid": 2 * L + (L // cfg.attn_every) * (4 + mlp),
        "encdec": (cfg.n_encoder_layers * (4 + mlp) + L * (6 + mlp)
                   + 2 * L),
        "vlm": L * (4 + mlp),
    }
    return per_kind[cfg.kind] + 1


@pytest.mark.parametrize("kind", FAMILIES)
def test_every_gemm_and_both_gradients_go_through_the_kernel(kind,
                                                             monkeypatch):
    """A train step with remat: every product once forward and (but the
    head) again in the recompute, then ``da`` (B read transposed, or, for
    the tied head, not) and ``db`` (A read transposed), all launches of
    the kernel; nothing else multiplies through it."""
    jcfg, cfg = cfgs(kind)
    cfg = dataclasses.replace(cfg, remat=True)
    state = port_state(jax_state(jcfg), cfg)
    calls = []
    real = ops.tiled_matmul

    def counting(a, b, c=None, **kw):
        calls.append((bool(kw.get("transpose_a")),
                      bool(kw.get("transpose_b"))))
        return real(a, b, c, **kw)

    monkeypatch.setattr(ops, "tiled_matmul", counting)
    step = tstep.make_train_step(get_model(cfg), cfg,
                                 adamw.AdamWConfig(**OPT))
    step(state, batches(cfg, 1)[0])
    fwd = _forward_gemms(cfg)
    # a tied head's forward reads B transposed and its da does not
    assert calls.count((False, False)) == 2 * fwd - 1
    assert calls.count((False, True)) == fwd
    assert calls.count((True, False)) == fwd
    assert len(calls) == 4 * fwd - 1


_ENV = {**os.environ,
        "PYTHONPATH": os.path.join(os.path.dirname(__file__), "..", "src")}


def test_sigterm_triggers_final_blocking_save():
    """SIGTERM mid-run makes the port's `run_train_loop` cut the run short
    with one final blocking checkpoint save (the preemption contract: the
    state on disk is the state the summary reports). The port's loop logs
    each step's grad norm and tokens, so its step and batch carry them."""
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent("""
        import os, signal
        import numpy as np
        from repro_torch.train.loop import LoopConfig, run_train_loop

        class Loader:
            def next(self):
                return {"tokens": np.zeros((1, 1), np.int32)}
            def checkpoint(self):
                return {"pos": 0}

        class Ckpt:
            saves = []
            def save(self, step, state, data_state=None, blocking=False):
                self.saves.append((step, bool(blocking)))
            def wait(self):
                pass

        def train_step(state, batch):
            state["n"] += 1
            if state["n"] == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, {"loss": np.float32(0.5),
                           "grad_norm": np.float32(1.0)}

        ckpt = Ckpt()
        state, summary = run_train_loop(
            train_step=train_step, state={"n": 0}, loader=Loader(),
            ckpt=ckpt, loop_cfg=LoopConfig(total_steps=100,
                                           ckpt_every=1000),
            log_fn=lambda msg: None)
        assert summary["preempted"], summary
        assert summary["final_step"] == 3, summary
        assert ckpt.saves == [(3, True)], ckpt.saves
        print("SAVED", ckpt.saves)
    """)], capture_output=True, text=True, timeout=120, env=_ENV)
    assert proc.returncode == 0, proc.stderr
    assert "SAVED [(3, True)]" in proc.stdout
