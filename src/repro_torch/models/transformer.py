"""Decoder-only LM stack: the module holding the weights, its
initialisation, the caches (dense and paged KV, SSM state), and the serving
forwards (prefill, chunked prefill, decode).

The counterpart of the JAX package's `repro.models.transformer` at tp=1,
for dense, MoE (`moe.moe_block_apply`), MLA-MoE (`moe.mla_moe_block_apply`),
Mamba1 and Mamba2 (`ssm.mamba1_block_apply`, `ssm.mamba2_block_apply`)
blocks. The parameter tree mirrors the JAX one — ``embed.table``, per layer
``ln1/attn/ln2`` and ``mlp`` or ``moe`` (``router``, ``experts``,
``shared_mlp``), or ``ln/ssm``, ``ln_f.scale``, ``head.w`` — except that
layers are a list of modules rather than leaves stacked on an L axis (the
port runs a Python loop where JAX runs ``lax.scan``).

The serving forwards write the cache of the state they are given in place
(JAX donates and rebinds it) and return the state with its advanced
``index``. `lm_loss` is the training forward.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import fsdp
from repro_torch.distributed import tp as TP
from repro_torch.distributed.sharding import (current_mesh,
                                              local_state_shape, set_mesh)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import frozen_params as _params
from repro_torch.models.layers import torch_dtype as _dtype


def _mlp_shapes(cfg: ModelConfig, d_ff: int) -> dict:
    """The (SwiGLU or GELU) FFN's weight shapes at hidden width `d_ff`."""
    d = cfg.d_model
    mlp = dict(w_up=(d, d_ff), w_down=(d_ff, d))
    if cfg.gated_mlp:
        mlp["w_gate"] = (d, d_ff)
    return mlp


def _gqa_shapes(cfg: ModelConfig) -> dict:
    """GQA attention's projections (and QKV biases)."""
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.kv_heads
    attn = dict(wq=(d, H * hd), wk=(d, KV * hd), wv=(d, KV * hd),
                wo=(H * hd, d))
    if cfg.qkv_bias:
        attn.update(bq=(H * hd,), bk=(KV * hd,), bv=(KV * hd,))
    return attn


def _mla_shapes(cfg: ModelConfig) -> dict:
    """Multi-head latent attention's projections (`moe.mla_apply`)."""
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    r, rq, pe = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.rope_head_dim
    attn = dict(w_dkv=(d, r), w_kpe=(d, pe), w_uk=(r, H * hd),
                w_uv=(r, H * hd), wo=(H * hd, d))
    if rq:
        attn.update(w_dq=(d, rq), w_uq=(rq, H * (hd + pe)))
    else:
        attn["w_uq"] = (d, H * (hd + pe))
    return attn


def _moe_groups(cfg: ModelConfig, device, dt) -> nn.ModuleDict:
    """The MoE FFN's groups: ``router.w`` (d, E), ``experts`` stacked on E,
    and ``shared_mlp`` (a SwiGLU of n_shared x d_ff_expert) if any."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    groups = {"router": _params(device, dt, w=(d, E)),
              "experts": _params(device, dt, w_gate=(E, d, f),
                                 w_up=(E, d, f), w_down=(E, f, d))}
    if cfg.n_shared_experts:
        groups["shared_mlp"] = _params(
            device, dt, **_mlp_shapes(cfg, f * cfg.n_shared_experts))
    return nn.ModuleDict(groups)


class DenseBlock(nn.Module):
    """One pre-norm block: RMSNorm -> GQA attention -> RMSNorm -> SwiGLU."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        """Allocate the block's parameters, uninitialised, on `device`."""
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        self.ln1 = _params(device, dt, scale=(cfg.d_model,))
        self.attn = _params(device, dt, **_gqa_shapes(cfg))
        self.ln2 = _params(device, dt, scale=(cfg.d_model,))
        self.mlp = _params(device, dt, **_mlp_shapes(cfg, cfg.d_ff))


class MoEBlock(nn.Module):
    """OLMoE block: RMSNorm -> GQA attention -> RMSNorm -> MoE FFN."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        """Allocate the block's parameters, uninitialised, on `device`."""
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        self.ln1 = _params(device, dt, scale=(cfg.d_model,))
        self.attn = _params(device, dt, **_gqa_shapes(cfg))
        self.ln2 = _params(device, dt, scale=(cfg.d_model,))
        self.moe = _moe_groups(cfg, device, dt)


class MLAMoEBlock(nn.Module):
    """DeepSeek-V2 block: RMSNorm -> multi-head latent attention ->
    RMSNorm -> MoE FFN with shared experts."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        """Allocate the block's parameters, uninitialised, on `device`."""
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        self.ln1 = _params(device, dt, scale=(cfg.d_model,))
        self.attn = _params(device, dt, **_mla_shapes(cfg))
        self.ln2 = _params(device, dt, scale=(cfg.d_model,))
        self.moe = _moe_groups(cfg, device, dt)


# the block module of each kind `TransformerLM` holds (hybrid and encdec
# have their own modules, `hybrid.HybridLM` and `encdec.EncDecLM`; vlm is a
# dense stack with M-RoPE)
BLOCKS = {"dense": DenseBlock, "moe": MoEBlock, "mla_moe": MLAMoEBlock,
          "mamba1": ssm.Mamba1Block, "mamba2": ssm.Mamba2Block,
          "vlm": DenseBlock}


def head_params(device, dt, d_model: int, vocab: int) -> nn.ParameterDict:
    """The untied LM head ``w`` (d_model, vocab). Its storage rows are
    padded to a multiple of 8 columns and ``w`` is the (d_model, vocab)
    view of them, so the GEMM's fast paths, which read B rows whose
    stride is a multiple of 8 elements, take it whatever the vocab
    (seamless-m4t-medium's 256206 is not a multiple of 8: stored
    contiguously its head would take ``general``). Only the view is a
    parameter: what the bridge and `init_weights` see."""
    store = torch.empty((d_model, -(-vocab // 8) * 8), dtype=dt,
                        device=device)
    return nn.ParameterDict({"w": nn.Parameter(store[:, :vocab],
                                               requires_grad=False)})


class TransformerLM(nn.Module):
    """The weights of a decoder-only LM of a kind in `BLOCKS` (dense, MoE,
    MLA-MoE, Mamba1 or Mamba2 blocks), allocated uninitialised on `device`
    (the card unless the caller asks for the CPU). Fill them with `lm_init`
    or `bridge.params_from_numpy`."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        """Allocate every parameter, uninitialised, on `device`."""
        super().__init__()
        if cfg.kind not in BLOCKS:
            raise ValueError(f"TransformerLM holds {sorted(BLOCKS)} blocks, "
                             f"not kind={cfg.kind!r}")
        dev = resolve_device(device)
        dt = _dtype(cfg.param_dtype)
        self.embed = _params(dev, dt, table=(cfg.vocab, cfg.d_model))
        self.blocks = nn.ModuleList(
            BLOCKS[cfg.kind](cfg, dev) for _ in range(cfg.n_layers))
        self.ln_f = _params(dev, dt, scale=(cfg.d_model,))
        self.head = (None if cfg.tie_embeddings
                     else head_params(dev, dt, cfg.d_model, cfg.vocab))

    @property
    def device(self) -> torch.device:
        """Where the weights live."""
        return self.embed["table"].device


@torch.no_grad()
def init_weights(model: nn.Module, cfg: ModelConfig,
                 generator: torch.Generator | None) -> nn.Module:
    """Fill `model`'s parameters from `generator` (which must live on the
    model's device) with the JAX package's scales: every projection
    N(0, 1/d_in), d_in its second-to-last axis (``wo`` over H*hd,
    ``w_down`` over d_ff, the experts (E, d, f) over d and (E, f, d) over
    f, the router over d), N(0, 0.02) embeddings, unit norms, zero biases,
    and the SSM leaves as `ssm.init_ssm_leaf` sets them. Each tensor is
    drawn in f32 on the device and cast on its own, so no f32 copy of the
    whole model ever exists (the largest transient is one tensor: a
    deepseek-v2-236b layer's (160, 5120, 1536) experts, 5.0 GB).

    A model on the ``meta`` device is returned as it is: its parameters
    have shapes and dtypes and no storage, so there is nothing to draw and
    `generator` may be None (the dry-run's counterpart of the reference's
    ``jax.eval_shape(model.init)``)."""
    if model.device.type == "meta":
        return model
    if generator is None or generator.device.type != model.device.type:
        raise ValueError(f"generator on "
                         f"{None if generator is None else generator.device}"
                         f", model on {model.device}")
    for name, w in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            w.fill_(1.0)
        elif leaf in ("bq", "bk", "bv"):
            w.zero_()
        elif not ssm.init_ssm_leaf(name, w, cfg, generator):
            scale = 0.02 if name == "embed.table" else (
                1.0 / math.sqrt(w.shape[-2]))
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=w.device,
                                dtype=torch.float32).mul_(scale))
    return model


def lm_init(cfg: ModelConfig, generator: torch.Generator | None, *,
            device: str | torch.device = "cuda") -> TransformerLM:
    """A `TransformerLM` on `device` with random weights drawn from
    `generator` (see `init_weights`; on ``meta``, shapes only)."""
    return init_weights(TransformerLM(cfg, device), cfg, generator)


def dense_block_apply(blk: DenseBlock, x: torch.Tensor, cfg: ModelConfig, *,
                      positions: torch.Tensor, cache: dict | None = None,
                      cache_index=None, seq_lens=None):
    """One block; returns (x, cache, aux) (aux is 0: the uniform block
    API of the JAX package). `seq_lens` masks a right-padded chunk's KV
    write to each row's valid tokens.

    Under sequence parallelism (`tp.sequence_parallel` over the
    positions: `x` is this rank's block of the sequence) the reference's
    Megatron-SP structure: the
    residual stream and both norms on the block, the normed activations
    all-gathered before the qkv and gate/up products
    (`tp.gather_from_sequence`), and the wo and w_down partial sums
    reduce-scattered back to the block before the residual add."""
    sp = TP.sequence_parallel(cfg, positions.shape[1])
    h = L.rmsnorm(blk.ln1, x, cfg.norm_eps)
    if sp:
        h = TP.gather_from_sequence(h)
    attn_out, new_cache = L.attention_apply(
        blk.attn, h, cfg, positions=positions, kv_cache=cache,
        cache_index=cache_index, seq_lens=seq_lens, sp=sp)
    x = x + attn_out
    h = L.rmsnorm(blk.ln2, x, cfg.norm_eps)
    if sp:
        h = TP.gather_from_sequence(h)
    return (x + L.swiglu_apply(blk.mlp, h, cfg, cfg.d_ff, sp=sp),
            new_cache, 0.0)


def block_apply(cfg: ModelConfig):
    """The block function of ``cfg.kind`` (for hybrid: its Mamba2
    backbone's)."""
    from repro_torch.models import moe

    return {"dense": dense_block_apply, "moe": moe.moe_block_apply,
            "mla_moe": moe.mla_moe_block_apply,
            "mamba1": ssm.mamba1_block_apply,
            "mamba2": ssm.mamba2_block_apply,
            "hybrid": ssm.mamba2_block_apply,
            "vlm": dense_block_apply}[cfg.kind]


def _embed(model: TransformerLM, tokens: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """The token embeddings in the activation dtype (a vocab-sharded table
    looks up through `tp.embed_lookup`)."""
    table = fsdp.leaf(model.embed["table"])
    return TP.embed_lookup(table, tokens, cfg.vocab).to(
        _dtype(cfg.activation_dtype))


def enter_sequence(model: nn.Module, x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """The embeddings `x` (B, S, d) as the block stack takes them: under
    sequence parallelism (`tp.sequence_parallel`) this rank's block of
    the sequence, cut with its gradient zero outside the block where the
    table is whole (each rank's share of the table's gradient), or
    gathered back (`tp.split_to_model`) where the table is cut by vocab
    (each rank's rows take every token's cotangent), else `x`."""
    if not TP.sequence_parallel(cfg, x.shape[1], TP.SP_STACK_KINDS):
        return x
    if model.embed["table"].shape[0] == cfg.vocab:
        return TP.sequence_block(x)
    return TP.split_to_model(x, 1)


def _unembed(model: TransformerLM, x: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """f32 logits over the whole vocabulary (a vocab-sharded head gathers
    its columns, `tp.unembed`)."""
    if cfg.tie_embeddings:
        return TP.unembed(x, fsdp.leaf(model.embed["table"]), cfg.vocab,
                          transpose_b=True)
    return TP.unembed(x, fsdp.leaf(model.head["w"]), cfg.vocab)


def _run_blocks(model: TransformerLM, x: torch.Tensor, cfg: ModelConfig, *,
                positions, cache: dict, cache_index, seq_lens=None,
                block=None, blocks=None):
    """Every block in order (`blocks`, default ``model.blocks``, through
    `block`, default the block function of ``cfg.kind``) over per-layer
    views of `cache` (written in place). Every leaf of `cache` is
    stacked on a leading layer axis: the dense cache's "k"/"v" (MLA:
    "c_kv"/"k_pe"), or the paged cache's pools ("k_pages"/"v_pages", MLA:
    "c_kv_pages"/"k_pe_pages") and its "table" (one table per layer, as in
    the JAX package, usually a broadcast view of one). The blocks' aux
    losses are dropped: serving has no use for them. Under sequence
    parallelism (a prefill on the dry-run's psum-mode rank) the blocks
    run on this rank's block of the sequence, gathered at the end."""
    apply = block or block_apply(cfg)
    sp = TP.sequence_parallel(cfg, x.shape[1], TP.SP_STACK_KINDS)
    if sp:
        x = TP.sequence_block(x)
    for i, blk in enumerate(model.blocks if blocks is None else blocks):
        layer_cache = {name: leaf[i] for name, leaf in cache.items()}
        x = apply(fsdp.gathered(blk), x, cfg, positions=positions,
                  cache=layer_cache, cache_index=cache_index,
                  seq_lens=seq_lens)[0]
    return TP.gather_from_model(x, 1) if sp else x


def _under_mesh(mesh, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with `mesh` installed on this thread."""
    prev = current_mesh()
    set_mesh(mesh)
    try:
        return fn(*args, **kwargs)
    finally:
        set_mesh(prev)


def remat(cfg: ModelConfig, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, under non-reentrant activation
    checkpointing where ``cfg.remat`` and autograd records (the counterpart
    of the JAX package's ``jax.checkpoint`` around a scan body): only the
    inputs stay live, and the backward recomputes the forward, whose GEMM
    launches come out bit for bit as the first time (the kernel is
    deterministic). The recomputation runs under the mesh of the first
    forward: on the card autograd runs the backward in a thread of its
    own, where the thread's mesh (`sharding.current_mesh`) is not set, and
    a block recomputed without it would drop its collectives."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(_under_mesh, current_mesh(), fn, *args,
                          use_reentrant=False, preserve_rng_state=False,
                          **kwargs)
    return fn(*args, **kwargs)


def _train_block(apply, blk, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> tuple:
    """One block of the training forward (no cache): (x, aux loss). Its
    leaves cut over "data" are gathered here, inside what `remat`
    recomputes (FSDP: `distributed.fsdp`)."""
    x, _, aux = apply(fsdp.gathered(blk), x, cfg, positions=positions)
    return x, aux


def train_stack(blocks, x: torch.Tensor, cfg: ModelConfig, *, positions,
                block) -> tuple[torch.Tensor, torch.Tensor]:
    """Every block of `blocks` in order through `block` with no cache,
    each under `remat`: (x, the sum of the blocks' aux losses)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in blocks:
        x, a = remat(cfg, _train_block, block, blk, x, cfg, positions)
        aux = aux + a
    return x, aux


def head_loss(model: nn.Module, x: torch.Tensor, batch: dict,
              cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """``ln_f``, the LM head over every position, and
    `layers.cross_entropy` against ``batch["labels"]`` (weighted by
    ``batch["loss_mask"]`` where given): (loss, {"nll", "accuracy"}).
    In psum mode a vocab-sharded head is vocab-parallel: this rank's f32
    logits of its vocab columns go into the sharded cross entropy, and no
    rank gathers the whole logits. Under sequence parallelism of the stack
    (`tp.sequence_parallel` over the labels, `SP_STACK_KINDS`) `x` is this
    rank's block of the sequence: ``ln_f`` runs on it, and it is gathered
    before the head (`tp.gather_from_sequence` into a vocab-sharded head;
    into a whole head `tp.gather_from_model`, the logits passing their
    gradient only within the block, `tp.sequence_share`)."""
    sp = TP.sequence_parallel(cfg, batch["labels"].shape[1],
                              TP.SP_STACK_KINDS)
    x = L.rmsnorm(model.ln_f, x, cfg.norm_eps)
    tied = cfg.tie_embeddings
    w = fsdp.leaf(model.embed["table"] if tied else model.head["w"])
    cols = w.shape[0] if tied else w.shape[-1]
    if TP.psum_mode(cfg) and cols != cfg.vocab:
        xe = TP.gather_from_sequence(x) if sp else TP.copy_to_model(x)
        logits = ops.matmul(xe, w, transpose_b=tied,
                            out_dtype=torch.float32, segments_n=cfg.vocab)
        return L.cross_entropy(logits, batch["labels"],
                               batch.get("loss_mask"),
                               vocab_start=TP.current_mesh().rank * cols)
    if sp:
        logits = TP.sequence_share(
            _unembed(model, TP.gather_from_model(x, 1), cfg))
    else:
        logits = _unembed(model, x, cfg)
    return L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


def lm_loss(model: TransformerLM, batch: dict, cfg: ModelConfig,
            block=None) -> tuple[torch.Tensor, dict]:
    """The training forward over ``batch["tokens"]`` (B, S): embed, every
    block (through `block`, default the block function of ``cfg.kind``;
    each under `remat`), then `head_loss`, plus the blocks' aux losses
    (the MoE kinds' load-balancing loss; 0 for the others). Returns (loss,
    metrics: nll, accuracy, aux_loss, loss), the metrics detached."""
    tokens = batch["tokens"].long()
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x, aux = train_stack(model.blocks,
                         enter_sequence(model, _embed(model, tokens, cfg),
                                        cfg), cfg,
                         positions=positions,
                         block=block or block_apply(cfg))
    loss, metrics = head_loss(model, x, batch, cfg)
    loss = loss + aux
    metrics["aux_loss"] = aux.detach()
    metrics["loss"] = loss.detach()
    return loss, metrics


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16, *,
                  device: str | torch.device = "cuda") -> dict:
    """Zeroed KV cache, (L, B, max_len, KV, hd) per leaf (KV/tp heads
    under tensor parallelism: `sharding.local_state_shape`). bf16 by
    default whatever the activation dtype, as in the JAX package: keys and
    values are rounded to bf16 on write and converted back on read."""
    shape = local_state_shape(
        "k", (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hd))
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: str | torch.device = "cuda") -> dict:
    """The zeroed dense cache of ``cfg.kind``: the MLA latent cache
    (`moe.init_mla_cache`) for mla_moe, the f32 SSM state for mamba1 and
    mamba2 (O(1) per row: `max_len` is not used), else the KV cache."""
    if cfg.kind == "mamba1":
        return ssm.init_mamba1_cache(cfg, batch, device=device)
    if cfg.kind == "mamba2":
        return ssm.init_mamba2_cache(cfg, batch, device=device)
    if cfg.kind == "mla_moe":
        from repro_torch.models.moe import init_mla_cache

        return init_mla_cache(cfg, batch, max_len, device=device)
    return init_kv_cache(cfg, batch, max_len, device=device)


def init_page_pool(cfg: ModelConfig, num_pages: int, page_size: int, *,
                   device: str | torch.device = "cuda") -> dict:
    """The zeroed page pool of ``cfg.kind``: the MLA latent pool
    (`moe.init_mla_page_pool`) for mla_moe, else the KV pool."""
    if cfg.kind == "mla_moe":
        from repro_torch.models.moe import init_mla_page_pool

        return init_mla_page_pool(cfg, num_pages, page_size, device=device)
    return init_kv_page_pool(cfg, num_pages, page_size, device=device)


def init_kv_page_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                      dtype: torch.dtype = torch.bfloat16, *,
                      device: str | torch.device = "cuda") -> dict:
    """Zeroed paged KV pool: `num_pages` shared pages of `page_size` tokens
    per layer, (L, P, T, KV, hd) per leaf (KV/tp heads under tensor
    parallelism; page 0 reserved as the null page, see `serving.paging`).
    The engine pairs it with a per-row page table to form the paged decode
    cache {"k_pages", "v_pages", "table"}."""
    shape = local_state_shape("k_pages", (cfg.n_layers, num_pages,
                                          page_size, cfg.kv_heads, cfg.hd))
    dev = resolve_device(device)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=dev),
            "v_pages": torch.zeros(shape, dtype=dtype, device=dev)}


@torch.no_grad()
def lm_prefill(model: TransformerLM, batch: dict, cfg: ModelConfig,
               max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward filling the KV cache; returns last logits.

    Without ``batch["lengths"]`` every row is S tokens: returns the logits
    at position S-1 and a shared scalar ``index = S``. With a (B,) tensor of
    true lengths over right-padded rows: returns each row's logits at
    ``lengths[b] - 1`` and a per-row ``index = lengths`` (pad keys sit after
    every valid query, so right-padding is causal-safe)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    lengths = batch.get("lengths")
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=dev).expand(B, S)
    cache = batch.get("cache")
    if cache is None:
        cache = init_cache(cfg, B, max_len or S, device=dev)
    x = _run_blocks(model, _embed(model, tokens, cfg), cfg,
                    positions=positions, cache=cache, cache_index=0,
                    seq_lens=None if lengths is None else lengths.long())
    x = L.rmsnorm(model.ln_f, x, cfg.norm_eps)
    if lengths is None:
        logits = _unembed(model, x[:, -1:], cfg)
        return logits[:, 0], {"kv": cache,
                              "index": torch.tensor(S, device=dev)}
    lengths = lengths.long()
    last = x[torch.arange(B, device=dev), lengths - 1][:, None]
    logits = _unembed(model, last, cfg)
    return logits[:, 0], {"kv": cache, "index": lengths}


@torch.no_grad()
def lm_prefill_chunk(model: TransformerLM, tokens: torch.Tensor,
                     lengths: torch.Tensor, state: dict, cfg: ModelConfig,
                     positions: torch.Tensor | None = None, *,
                     block=None, blocks=None
                     ) -> tuple[torch.Tensor, dict]:
    """One admission-prefill chunk of the serving loop.

    tokens: (B, S), each row's next `lengths[b]` prompt tokens right-padded
    to the chunk bucket S; state: {"kv", "index"} with a per-row ``index``
    holding each row's chunk base (tokens already written). KV rows are
    written in place at ``index[b] .. index[b] + lengths[b]``; a zero-length
    row writes nothing. Returns each row's logits at its last valid position
    (clamped to 0 for zero-length rows) and the state with
    ``index + lengths``. Prefilling a prompt in chunks gives the logits of a
    single `lm_prefill` over the whole prompt. `positions` overrides the
    rotary positions (vlm's M-RoPE triples), `block` and `blocks` the block
    function and stack (encdec's decoder; see `_run_blocks`)."""
    B, S = tokens.shape
    dev = tokens.device
    base = state["index"].long()
    lengths = lengths.long()
    if positions is None:
        positions = base[:, None] + torch.arange(S, device=dev)[None, :]
    x = _run_blocks(model, _embed(model, tokens, cfg), cfg,
                    positions=positions, cache=state["kv"], cache_index=base,
                    seq_lens=lengths, block=block, blocks=blocks)
    x = L.rmsnorm(model.ln_f, x, cfg.norm_eps)
    last = x[torch.arange(B, device=dev), (lengths - 1).clamp(min=0)][:, None]
    logits = _unembed(model, last, cfg)
    return logits[:, 0], {"kv": state["kv"], "index": base + lengths}


@torch.no_grad()
def lm_decode_step(model: TransformerLM, token: torch.Tensor, state: dict,
                   cfg: ModelConfig, positions: torch.Tensor | None = None,
                   *, block=None, blocks=None
                   ) -> tuple[torch.Tensor, dict]:
    """One-token decode. token: (B,) int; state: {"kv", "index"}, where
    ``index`` is a scalar (every row at one position) or (B,) (each slot at
    its own position). Returns (logits (B, V) f32, state with index + 1).
    `positions`, `block` and `blocks` as in `lm_prefill_chunk`."""
    B = token.shape[0]
    idx = state["index"]
    if positions is None:
        positions = (idx.long().expand(B) if idx.dim() == 0
                     else idx.long())[:, None]
    x = _run_blocks(model, _embed(model, token[:, None], cfg), cfg,
                    positions=positions, cache=state["kv"], cache_index=idx,
                    block=block, blocks=blocks)
    x = L.rmsnorm(model.ln_f, x, cfg.norm_eps)
    logits = _unembed(model, x, cfg)
    return logits[:, 0], {"kv": state["kv"], "index": idx + 1}
