"""Training launcher of the port, the JAX package's `repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --steps 4 --batch 8 --seq 512 --ckpt-dir build/train

Trains on the card (``--device cpu`` runs the kernels' plain versions);
--smoke trains the reduced config, with the same code path (checkpoints,
fault tolerance, resume). A full config trains whole on the one card: the
JAX package refuses full configs without its 16-device production mesh,
and this launcher refuses one whose training state (params and gradients
in the param dtype, f32 master, m and v: 16 bytes a bf16 parameter) and
activations (`train_memory_bytes`, by kind) do not fit the card's memory:
at 8 x 512 starcoder2-3b, zamba2-2.7b and seamless-m4t-medium fit (and
qwen2-vl-2b at 2 x 2048), while qwen2-7b, olmoe-1b-7b, falcon-mamba-7b and
deepseek-v2-236b (at any depth) are refused.

The launcher trains the LM kinds (dense, moe, mla_moe, mamba1, mamba2,
hybrid) on the synthetic token pipeline, as the JAX package's does. Its
pipeline makes no source frames or image patches, so encdec and vlm are
refused here and train through `train.step.make_train_step` on batches
that carry them.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, DataLoader, SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, resume_or_init, run_train_loop
from repro_torch.train.step import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[3]
# bytes a logit of the head's split cotangent takes: three bf16 terms
SPLIT_BYTES = 3 * 2


def _attention_bytes(cfg: ModelConfig, batch: int, seq: int,
                     keys: int | None = None) -> int:
    """One attention layer's f32 working set over batch x seq queries and
    `keys` keys (default seq): the projections' outputs and the scores four
    times over (scores, mask, softmax and its gradient)."""
    t, d = batch * seq, cfg.d_model
    return (t * (4 * d + 2 * cfg.kv_heads * cfg.hd) * 4
            + 4 * batch * cfg.n_heads * seq * (keys or seq) * 4)


def _dense_block_bytes(cfg: ModelConfig, batch: int, seq: int) -> int:
    """A dense block's f32 working set: attention and the FFN's hidden."""
    return (_attention_bytes(cfg, batch, seq)
            + batch * seq * 3 * cfg.d_ff * 4)


def _moe_bytes(cfg: ModelConfig, batch: int, seq: int) -> int:
    """The MoE FFN's working set: the f32 dispatch buffer (E, B * capacity,
    d) and its gradient, the experts' activations and their gradients, the
    per-token copies and outputs (T * top_k, d) in f32, the router's f32
    logits, probabilities and gradients, and the shared experts."""
    E, K, d, f = (cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff_expert)
    a = torch_dtype(cfg.activation_dtype).itemsize
    t = batch * seq
    rows = batch * max(1, int(cfg.capacity_factor * seq * K / E))
    return (2 * E * rows * d * 4 + 2 * E * rows * (2 * d + 3 * f) * a
            + 3 * t * K * d * 4 + 4 * t * E * 4
            + t * 3 * f * cfg.n_shared_experts * 4)


def _mla_bytes(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Multi-head latent attention's f32 working set: queries, the latent,
    the decompressed keys and values of every head, and the scores."""
    t, d, H, hd = batch * seq, cfg.d_model, cfg.n_heads, cfg.hd
    return (t * (4 * d + H * (3 * hd + cfg.rope_head_dim)
                 + cfg.kv_lora_rank) * 4
            + 4 * batch * H * seq * seq * 4)


def _mamba1_bytes(cfg: ModelConfig, batch: int, seq: int) -> int:
    """A Mamba1 block's working set: the scan's (B, S, d_inner, d_state)
    f32 tensors (decay and input, the in-block products and states as
    steps and stacked, the states and their product with C) and their
    gradients, ten in all, besides the (B, S, d_inner) activations."""
    t, di = batch * seq, cfg.d_inner
    return 10 * t * di * cfg.ssm_state * 4 + 8 * t * di * 4


def _mamba2_bytes(cfg: ModelConfig, batch: int, seq: int) -> int:
    """A Mamba2 block's working set: the in_proj and conv outputs in f32,
    and the SSD scan's intra-block temporaries (the decay weights and
    their products, (B, S, q, H) f32 each, three with the gradient)."""
    from repro_torch.models.ssm import CHUNK

    t, di = batch * seq, cfg.d_inner
    H = di // cfg.ssm_headdim
    conv_ch = di + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return (t * (2 * di + conv_ch + H) * 4 * 3 + 8 * t * di * 4
            + 3 * t * min(CHUNK, seq) * H * 4)


def _units(cfg: ModelConfig, batch: int, seq: int) -> list:
    """The forward's units of recomputation, in order: (count, rows in, one
    unit's working set in bytes). Remat keeps each unit's input and
    recomputes one unit at a time; the JAX package checkpoints a block of
    the LM kinds and vlm, a group of Mamba2 blocks and the shared block
    for hybrid, and an encoder or decoder layer for encdec (whose source
    is ``configs.seamless_m4t_medium.src_len(seq)`` frames)."""
    kind = cfg.kind
    if kind == "mamba1":
        return [(cfg.n_layers, batch * seq, _mamba1_bytes(cfg, batch, seq))]
    if kind == "mamba2":
        return [(cfg.n_layers, batch * seq, _mamba2_bytes(cfg, batch, seq))]
    if kind == "hybrid":
        group = (cfg.attn_every * _mamba2_bytes(cfg, batch, seq)
                 + _dense_block_bytes(cfg, batch, seq))
        return [(cfg.n_layers // cfg.attn_every, batch * seq, group)]
    if kind == "moe":
        return [(cfg.n_layers, batch * seq, _attention_bytes(cfg, batch, seq)
                 + _moe_bytes(cfg, batch, seq))]
    if kind == "mla_moe":
        return [(cfg.n_layers, batch * seq, _mla_bytes(cfg, batch, seq)
                 + _moe_bytes(cfg, batch, seq))]
    if kind == "encdec":
        from repro_torch.configs.seamless_m4t_medium import src_len

        T = src_len(seq)
        dec = (_dense_block_bytes(cfg, batch, seq)
               + _attention_bytes(cfg, batch, seq, keys=T)
               + 2 * batch * T * cfg.d_model * 4)
        return [(cfg.n_encoder_layers, batch * T,
                 _dense_block_bytes(cfg, batch, T)),
                (cfg.n_layers, batch * seq, dec)]
    return [(cfg.n_layers, batch * seq, _dense_block_bytes(cfg, batch, seq))]


def train_memory_bytes(cfg: ModelConfig, batch: int, seq: int
                       ) -> tuple[int, int]:
    """(state bytes, activation bytes) of one train step of `cfg` over a
    batch x seq token batch on one card (vlm: seq counts the patches too).

    State: params and gradients in ``cfg.param_dtype`` and the f32 master,
    m and v. Activations, an estimate from the shapes (`_units`): each
    unit's input where ``cfg.remat`` (the backward recomputes one unit at a
    time) and one unit's working set, or every unit's working set where
    not; plus the LM head's f32 logits four times over (logits, softmax,
    their gradient, a spare) and the three bf16 terms of their gradient
    (`kernels.tiled_matmul.split3`, 6 bytes a logit), which the head's
    backward pair reads on the card."""
    p = torch_dtype(cfg.param_dtype).itemsize
    a = torch_dtype(cfg.activation_dtype).itemsize
    state = cfg.n_params() * (2 * p + 12)
    units = _units(cfg, batch, seq)
    if cfg.remat:
        acts = (sum(n * rows * cfg.d_model * a for n, rows, _ in units)
                + max(ws for _, _, ws in units))
    else:
        acts = sum(n * ws for n, _, ws in units)
    return state, acts + (4 * 4 + SPLIT_BYTES) * batch * seq * cfg.vocab


def check_fits(cfg: ModelConfig, batch: int, seq: int,
               capacity_bytes: int) -> None:
    """Raise SystemExit, naming both sizes, where training `cfg` would not
    fit `capacity_bytes` of device memory."""
    state, acts = train_memory_bytes(cfg, batch, seq)
    if state + acts > capacity_bytes:
        raise SystemExit(
            f"{cfg.name} does not train on one card: its training state is "
            f"{state / 1e9:.1f} GB ({cfg.n_params() / 1e9:.2f} B params) and "
            f"its activations at {batch} x {seq} about {acts / 1e9:.1f} GB, "
            f"against the card's {capacity_bytes / 1e9:.1f} GB; use --smoke "
            "or a smaller config (tensor parallelism is ROADMAP A7)")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=str(ROOT / "build" / "train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    return ap


def main(argv: list[str] | None = None,
         log_fn: Callable[[str], None] = print) -> tuple[dict, dict]:
    """Parse `argv`, train, and return (final state, loop summary)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if not args.smoke:
        if dev.type != "cuda":
            raise SystemExit("full configs train on the card; use --smoke "
                             "with --device cpu")
        check_fits(cfg, args.batch, args.seq,
                   torch.cuda.get_device_properties(dev).total_memory)
    if cfg.kind in ("encdec", "vlm"):
        raise SystemExit(
            f"{cfg.name} ({cfg.kind}) trains on batches with "
            + ("src_embeds" if cfg.kind == "encdec" else
               "patch_embeds, positions_3d and loss_mask")
            + "; the launcher's synthetic pipeline makes token batches "
            "only: use train.step.make_train_step")
    model = get_model(cfg)
    log_fn(f"arch={cfg.name} params~{cfg.n_params() / 1e9:.2f}B "
           f"device={dev}")
    ds = SyntheticLMDataset(DataConfig(seq_len=args.seq,
                                       global_batch=args.batch,
                                       vocab=cfg.vocab))
    loader = DataLoader(ds)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    step_fn = make_train_step(
        model, cfg, AdamWConfig(lr=args.lr, warmup_steps=10,
                                decay_steps=args.steps))
    state, start = resume_or_init(
        ckpt=ckpt,
        init_fn=lambda: init_train_state(
            torch.Generator(dev).manual_seed(0), model, cfg,
            device=dev),
        loader=loader)
    state, summary = run_train_loop(
        train_step=step_fn, state=state, loader=loader, ckpt=ckpt,
        loop_cfg=LoopConfig(total_steps=args.steps,
                            ckpt_every=args.ckpt_every,
                            log_every=args.log_every),
        start_step=start, log_fn=log_fn)
    log_fn(f"final step={summary['final_step']} "
           f"loss={summary['final_loss']:.4f}")
    return state, summary


if __name__ == "__main__":
    main()
