"""Shared pieces of the `tests/test_torch_train_*.py` files: the families
whose training the port holds against the JAX package, their smoke configs
in both packages, seeded batches, and the comparisons.

Every family but dense: moe and mla_moe (olmoe-1b-7b and
deepseek-v2-236b), mamba1 (falcon-mamba-7b, tied head), mamba2 (no config
of its own: the reference's chunked-prefill family sizes), hybrid
(zamba2-2.7b), encdec (seamless-m4t-medium) and vlm (qwen2-vl-2b). The
batches are built here as the JAX package's `data.pipeline.smoke_batch`
builds them: int tokens and labels; encdec's float ``src_embeds`` of
``max(S // 4, 8)`` frames; vlm's patch prefix on a 4 x 4 grid with its
M-RoPE ``positions_3d`` and a ``loss_mask`` of 0 on the patches.

Tolerances: ROADMAP's f32 1e-5, relative plus absolute, the absolute part
scaled by the larger of 1 and the reference's largest magnitude.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models.config import ModelConfig as JModelConfig
from repro.models.registry import get_model as jget_model
from repro.models.vlm import build_mrope_positions
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.models import bridge
from repro_torch.models.config import ModelConfig

TOL_F32 = 1e-5
FAMILIES = ("moe", "mla_moe", "mamba1", "mamba2", "hybrid", "encdec", "vlm")
ARCH = {"moe": "olmoe-1b-7b", "mla_moe": "deepseek-v2-236b",
        "mamba1": "falcon-mamba-7b", "hybrid": "zamba2-2.7b",
        "encdec": "seamless-m4t-medium", "vlm": "qwen2-vl-2b"}
MAMBA2 = dict(name="mamba2-smoke", kind="mamba2", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=0, vocab=128, ssm_state=8,
              expand=2, d_conv=4, ssm_headdim=16, ssm_ngroups=1,
              param_dtype="float32", activation_dtype="float32",
              remat=False)
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10, eps=1e-5)
VLM_GRID = (4, 4)


def cfgs(kind: str, **changes) -> tuple:
    """(JAX config, port config) of `kind`'s smoke size, with `changes`."""
    if kind == "mamba2":
        jcfg, cfg = JModelConfig(**MAMBA2), ModelConfig(**MAMBA2)
    else:
        jcfg = jget_config(ARCH[kind], smoke=True)
        cfg = get_config(ARCH[kind], smoke=True)
    return (dataclasses.replace(jcfg, **changes),
            dataclasses.replace(cfg, **changes))


def batches(cfg, n: int, B: int = 4, S: int = 16, seed: int = 0) -> list:
    """`n` seeded training batches of `cfg`'s kind: B rows of S tokens (the
    vlm's S text tokens after its 16 patches)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)}
        if cfg.kind == "vlm":
            P = VLM_GRID[0] * VLM_GRID[1]
            batch["patch_embeds"] = rng.normal(
                size=(B, P, cfg.d_model)).astype(np.float32)
            batch["positions_3d"] = np.broadcast_to(
                build_mrope_positions(P, VLM_GRID, S), (B, P + S, 3)).astype(
                np.int32)
            mask = np.ones((B, P + S), np.float32)
            mask[:, :P] = 0.0
            batch["loss_mask"] = mask
            S = P + S
        elif cfg.kind == "encdec":
            batch["src_embeds"] = rng.normal(
                size=(B, max(S // 4, 8), cfg.d_model)).astype(np.float32)
        batch["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        out.append(batch)
    return out


def tbatch(batch: dict) -> dict:
    """A numpy batch as CPU tensors."""
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def to_numpy(tree):
    """A JAX pytree with numpy leaves."""
    return jax.tree.map(np.asarray, tree)


def jax_state(jcfg, seed: int = 0) -> dict:
    """The JAX package's train state of `jcfg` from ``key(seed)``."""
    return jstep.init_train_state(jax.random.key(seed), jget_model(jcfg),
                                  jcfg)


def port_state(jstate, cfg) -> dict:
    """The port's train state from the JAX one, on the CPU."""
    return bridge.train_state_from_numpy(to_numpy(jstate), cfg,
                                         device="cpu")


def grads(api, params, batch: dict, cfg) -> tuple:
    """(loss, metrics, {name: gradient}) of one batch through the port."""
    loss, metrics = api.loss(params, tbatch(batch), cfg)
    names = [n for n, _ in params.named_parameters()]
    gs = torch.autograd.grad(loss, list(params.parameters()))
    return loss.detach(), metrics, dict(zip(names, gs))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol: float = TOL_F32, what: str = "") -> None:
    """`got` within `tol` of `want`, the absolute part scaled by
    max(1, max|want|)."""
    got, want = _np(got), _np(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def tree_close(got: dict, want: dict, tol: float = TOL_F32,
               where: str = "") -> None:
    """`close` over every leaf of two trees of the same keys."""
    assert set(got) == set(want), (where, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            tree_close(got[k], want[k], tol, f"{where}/{k}")
        else:
            close(got[k], want[k], tol, f"{where}/{k}")
