"""Training launcher of the port, the JAX package's `repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --steps 4 --batch 8 --seq 512 --ckpt-dir build/train

Trains on the card (``--device cpu`` runs the kernels' plain versions);
--smoke trains the reduced config, with the same code path (checkpoints,
fault tolerance, resume). The JAX package refuses full configs without
its 16-device production mesh; this launcher refuses one whose training
state (params and gradients in the param dtype, f32 master, m and v: 16
bytes a bf16 parameter) and activations (`train_memory_bytes`, by kind)
do not fit a rank's share of the card's memory: at 8 x 512 on one rank
starcoder2-3b, zamba2-2.7b and seamless-m4t-medium fit (and qwen2-vl-2b at
2 x 2048), while qwen2-7b, olmoe-1b-7b, falcon-mamba-7b and
deepseek-v2-236b (at any depth) are refused.

``--tp N --dp M`` trains on a (data M, model N) mesh of N x M rank
processes (`launch.mesh.RankPool`, gloo; ``--device cpu`` for the CPU,
else rank r on card r modulo the cards, several ranks sharing one card
where there are fewer): tensor parallelism in psum mode for every kind
the launcher trains, the batch cut over "data", ``--zero1`` cutting the
optimizer state over "data" (`train.step`) and ``--sequence-parallel``
running the residual stream on each rank's 1/tp of the sequence
(Megatron-SP). Every rank draws the whole model from the same seed and
keeps its shard, so the weights are tp=1's; its checkpoints hold whole
leaves (`checkpoint.manager`), written by rank 0. The fit check sizes
one rank's share.

The launcher trains the LM kinds (dense, moe, mla_moe, mamba1, mamba2,
hybrid) on the synthetic token pipeline, as the JAX package's does. Its
pipeline makes no source frames or image patches, so encdec and vlm are
refused here and train through `train.step.make_train_step` on batches
that carry them.
"""

from __future__ import annotations

import argparse
import dataclasses
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


def _rank_params(cfg: ModelConfig, tp: int) -> int:
    """One rank's parameters at tp: each leaf psum mode shards (`sharding.
    param_axes` of the whole model, on ``meta``) a tp-th of each part it
    cuts, and the whole of each part it holds whole (`sharding.
    axis_parts`: Mamba2's B and C)."""
    from repro_torch.distributed.sharding import (axis_parts, local_size,
                                                  param_axes)

    if tp == 1:
        return cfg.n_params()
    model = get_model(cfg).init(cfg, None, device="meta")
    axes = param_axes(model, tp, "psum", cfg)
    total = 0
    for n, p in model.named_parameters():
        ax = axes[n]
        if ax is None:
            total += p.numel()
            continue
        parts = axis_parts(n.rsplit(".", 1)[-1], p.shape[ax], cfg)
        total += p.numel() // p.shape[ax] * local_size(parts, tp)
    return total


def train_memory_bytes(cfg: ModelConfig, batch: int, seq: int, *,
                       tp: int = 1, dp: int = 1, zero1: bool = False
                       ) -> tuple[int, int]:
    """(state bytes, activation bytes) of one train step of `cfg` over a
    batch x seq token batch on one rank of a (dp, tp) mesh (vlm: seq
    counts the patches too).

    State: params and gradients in ``cfg.param_dtype`` and the f32 master,
    m and v, of the rank's shards (`_rank_params`; the f32 state a dp-th
    of it under ZeRO-1). Activations, an estimate from the shapes
    (`_units`) of the rank's batch / dp rows: each unit's input where
    ``cfg.remat`` (the backward recomputes one unit at a time; whole on
    every rank) and one unit's working set (a tp-th of it: its heads and
    hidden columns), or every unit's working set where not; plus the LM
    head's f32 logits four times over (logits, softmax, their gradient, a
    spare) and the three bf16 terms of their gradient
    (`kernels.tiled_matmul.split3`, 6 bytes a logit), which the head's
    backward pair reads on the card, of the rank's vocab shard (the whole
    vocab where tp does not divide it: the head stays whole)."""
    p = torch_dtype(cfg.param_dtype).itemsize
    a = torch_dtype(cfg.activation_dtype).itemsize
    params = _rank_params(cfg, tp)
    state = params * 2 * p + params * 12 // (dp if zero1 else 1)
    batch = max(batch // dp, 1)
    units = _units(cfg, batch, seq)
    if cfg.remat:
        acts = (sum(n * rows * cfg.d_model * a for n, rows, _ in units)
                + max(ws for _, _, ws in units) // tp)
    else:
        acts = sum(n * ws for n, _, ws in units) // tp
    vocab = cfg.vocab // tp if cfg.vocab % tp == 0 else cfg.vocab
    return state, acts + (4 * 4 + SPLIT_BYTES) * batch * seq * vocab


def check_fits(cfg: ModelConfig, batch: int, seq: int,
               capacity_bytes: int, *, tp: int = 1, dp: int = 1,
               zero1: bool = False) -> None:
    """Raise SystemExit, naming both sizes, where one rank's share of
    training `cfg` on a (dp, tp) mesh would not fit `capacity_bytes` of
    device memory."""
    state, acts = train_memory_bytes(cfg, batch, seq, tp=tp, dp=dp,
                                     zero1=zero1)
    if state + acts > capacity_bytes:
        where = ("on one card" if tp * dp == 1 else
                 f"on a rank of a (data {dp}, model {tp}) mesh")
        raise SystemExit(
            f"{cfg.name} does not train {where}: its training state is "
            f"{state / 1e9:.1f} GB ({cfg.n_params() / 1e9:.2f} B params in "
            f"all) and its activations at {batch} x {seq} about "
            f"{acts / 1e9:.1f} GB, against {capacity_bytes / 1e9:.1f} GB; "
            "use --smoke, a smaller config or a larger --tp")


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
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (the mesh's model axis)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks (the mesh's data axis)")
    ap.add_argument("--zero1", action="store_true",
                    help="cut the optimizer state over the data axis")
    ap.add_argument("--sequence-parallel", action="store_true",
                    help="Megatron sequence parallelism over the model axis")
    return ap


def train_rank(mesh, argv: list[str] | None = None,
               log_fn: Callable[[str], None] | None = print, *,
               every_rank: bool = False) -> tuple[dict, dict]:
    """One rank's training run of the launcher's `argv` on `mesh` (None:
    one process, no mesh): returns (this rank's final state, the loop's
    summary). Only global rank 0 logs, unless `every_rank` (`log_fn`
    None: none). Every rank of the mesh runs it at once (`RankPool`, or
    `main`)."""
    args = _parser().parse_args(argv)
    world = args.tp * args.dp
    if mesh is not None and (mesh.tp, mesh.data) != (args.tp, args.dp):
        raise ValueError(f"mesh {mesh.shape} for --tp {args.tp} --dp "
                         f"{args.dp}")
    rank = 0
    if mesh is not None:
        import torch.distributed as dist

        rank = dist.get_rank()
    dev = resolve_device(args.device)
    if dev.type == "cuda" and world > 1:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    say = (log_fn if log_fn is not None and (rank == 0 or every_rank)
           else (lambda _: None))
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.sequence_parallel:
        cfg = dataclasses.replace(cfg, sequence_parallel=True)
    if not args.smoke:
        if dev.type != "cuda":
            raise SystemExit("full configs train on the card; use --smoke "
                             "with --device cpu")
        share = torch.cuda.get_device_properties(dev).total_memory
        share //= max(world // torch.cuda.device_count(), 1)
        check_fits(cfg, args.batch, args.seq, share, tp=args.tp,
                   dp=args.dp, zero1=args.zero1)
    if cfg.kind in ("encdec", "vlm"):
        raise SystemExit(
            f"{cfg.name} ({cfg.kind}) trains on batches with "
            + ("src_embeds" if cfg.kind == "encdec" else
               "patch_embeds, positions_3d and loss_mask")
            + "; the launcher's synthetic pipeline makes token batches "
            "only: use train.step.make_train_step")
    model = get_model(cfg)
    layout = None
    if mesh is not None:
        from repro_torch.distributed.sharding import train_layout
        from repro_torch.train.step import train_config

        tcfg = train_config(cfg, mesh)
        layout = train_layout(model.init(tcfg, None, device="meta"), mesh,
                              tcfg, args.zero1)
    say(f"arch={cfg.name} params~{cfg.n_params() / 1e9:.2f}B "
        f"device={dev}" + (f" mesh={mesh.shape}" if mesh else ""))
    ds = SyntheticLMDataset(DataConfig(seq_len=args.seq,
                                       global_batch=args.batch,
                                       vocab=cfg.vocab))
    loader = DataLoader(ds)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3, layout=layout)
    step_fn = make_train_step(
        model, cfg, AdamWConfig(lr=args.lr, warmup_steps=10,
                                decay_steps=args.steps),
        mesh=mesh, zero1=args.zero1)
    state, start = resume_or_init(
        ckpt=ckpt,
        init_fn=lambda: init_train_state(
            torch.Generator(dev).manual_seed(0), model, cfg,
            device=dev, mesh=mesh, zero1=args.zero1),
        loader=loader)
    state, summary = run_train_loop(
        train_step=step_fn, state=state, loader=loader, ckpt=ckpt,
        loop_cfg=LoopConfig(total_steps=args.steps,
                            ckpt_every=args.ckpt_every,
                            log_every=args.log_every),
        start_step=start, log_fn=say,
        install_signal_handlers=mesh is None)
    say(f"final step={summary['final_step']} "
        f"loss={summary['final_loss']:.4f}")
    return state, summary


def _pool_rank(mesh, argv: list[str]) -> dict:
    """A rank process's run (`RankPool`): the summary, its logs from rank
    0 only, printed there."""
    return train_rank(mesh, argv)[1]


def main(argv: list[str] | None = None,
         log_fn: Callable[[str], None] = print) -> tuple[dict | None, dict]:
    """Parse `argv`, train, and return (final state, loop summary). With
    ``--tp``/``--dp`` above 1 the ranks train in their own processes
    (rank 0 prints the log) and the state stays there: (None, rank 0's
    summary); a rank that fails or exits with another code than 0 raises
    RuntimeError."""
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.tp * args.dp == 1:
        return train_rank(None, argv, log_fn)
    from repro_torch.launch.mesh import RankPool

    pool = RankPool(args.tp, data=args.dp, backend="gloo",
                    threads=1 if args.device == "cpu" else None,
                    timeout_s=3600.0)
    try:
        summaries = pool.run(_pool_rank, argv)
    finally:
        codes = pool.close()
    if any(codes):
        raise RuntimeError(f"rank processes exited with {codes}")
    return None, summaries[0]


if __name__ == "__main__":
    main()
