"""Training launcher of the port, the JAX package's `repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --steps 4 --batch 8 --seq 512 --ckpt-dir build/train

Trains on the card (``--device cpu`` runs the kernels' plain versions);
--smoke trains the reduced config, with the same code path (checkpoints,
fault tolerance, resume). A full config trains whole on the one card: the
JAX package refuses full configs without its 16-device production mesh,
and this launcher refuses one whose training state (params and gradients
in the param dtype, f32 master, m and v: 16 bytes a bf16 parameter) and
activations (`train_memory_bytes`) do not fit the card's memory, so
starcoder2-3b trains and qwen2-7b is refused.
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


def train_memory_bytes(cfg: ModelConfig, batch: int, seq: int
                       ) -> tuple[int, int]:
    """(state bytes, activation bytes) of one train step of `cfg` over a
    batch x seq token batch on one card.

    State: params and gradients in ``cfg.param_dtype`` and the f32 master,
    m and v. Activations, an estimate from the shapes: each block's input
    where ``cfg.remat`` (the backward recomputes one block at a time) or
    every block's working set where not; one block's working set in f32
    (its projections' outputs, the FFN's hidden and the attention scores
    four times over: scores, mask, softmax and its gradient); the LM head's
    f32 logits four times over (logits, softmax, their gradient, a spare).
    """
    p = torch_dtype(cfg.param_dtype).itemsize
    state = cfg.n_params() * (2 * p + 12)
    t, d = batch * seq, cfg.d_model
    a = torch_dtype(cfg.activation_dtype).itemsize
    block = (t * (4 * d + 2 * cfg.kv_heads * cfg.hd + 3 * cfg.d_ff) * 4
             + 4 * batch * cfg.n_heads * seq * seq * 4)
    head = 4 * t * cfg.vocab * 4
    layers = cfg.n_layers * (t * d * a if cfg.remat else block)
    return state, layers + (block if cfg.remat else 0) + head


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
