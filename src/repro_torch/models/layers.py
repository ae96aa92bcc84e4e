"""Dense transformer building blocks (bf16 activations, fp32 math).

The counterparts of the dense parts of the JAX package's
`repro.models.layers`, with its layouts: weights are (d_in, d_out) with
``y = x @ w``, activations (B, S, ...), KV caches (B, max_len, KV, hd) per
layer. Every projection goes through `kernels.ops.matmul`, so on the card
each one is a launch of the hand-written GEMM. Attention, norms and RoPE are
plain PyTorch, as the JAX package leaves them to XLA.

Where the JAX package is functional, the port writes KV state in place:
`cache_update` and `insert_slot_state` modify the tensors they are given.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

Params = Mapping[str, torch.Tensor]


# ---------------- norms ----------------

def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS-normalize in f32, apply the learned scale, cast back."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


# ---------------- rotary embeddings ----------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Rotary base frequencies for a head dim (theta^(-2i/hd)), f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. Split halves, f32 math."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    ang = positions[..., None].float() * freqs                # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------- attention ----------------

Q_CHUNK = 1024  # query-block size for memory-bounded exact attention


def _per_row(v: torch.Tensor | int, device) -> torch.Tensor:
    """A scalar or (B,) offset as a (Bm, 1, 1) tensor (Bm = 1 or B)."""
    t = torch.as_tensor(v, device=device)
    return t[:, None, None] if t.dim() else t.reshape(1, 1, 1)


def attention_mask(Sq: int, Sk: int, *, causal: bool,
                   q_offset: torch.Tensor | int = 0,
                   kv_len: torch.Tensor | int | None = None,
                   device: torch.device | str = "cpu"
                   ) -> torch.Tensor | None:
    """(Bm, Sq, Sk) boolean mask (Bm broadcasts over batch).

    `q_offset` and `kv_len` may be scalars (whole batch) or (B,) tensors
    (per row: every continuous-batching slot sits at its own position)."""
    mask = None
    if causal:
        qpos = (torch.arange(Sq, device=device)[None, :, None]
                + _per_row(q_offset, device))                  # (Bm, Sq, 1)
        mask = torch.arange(Sk, device=device)[None, None, :] <= qpos
    if kv_len is not None:
        valid = (torch.arange(Sk, device=device)[None, None, :]
                 < _per_row(kv_len, device))                   # (Bm, 1, Sk)
        mask = valid if mask is None else (mask & valid)
    return mask


def _sdpa_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, q_offset: torch.Tensor | int = 0,
                kv_len: torch.Tensor | int | None = None) -> torch.Tensor:
    """One query block. q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd).

    Both products take the input values exactly and accumulate in f32 (the
    JAX package's ``preferred_element_type=float32``); softmax in f32; the
    weights are rounded to q's dtype before the PV product."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    scores = torch.einsum("bqgrh,bkgh->bgrqk", qg.float(),
                          k.float()) / math.sqrt(hd)
    mask = attention_mask(Sq, Sk, causal=causal, q_offset=q_offset,
                          kv_len=kv_len, device=q.device)
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgh->bqgrh", w.to(q.dtype).float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool, q_offset: torch.Tensor | int = 0,
          kv_len: torch.Tensor | int | None = None) -> torch.Tensor:
    """Exact attention, query-chunked so peak score memory is
    O(Q_CHUNK x Sk) instead of O(Sq x Sk)."""
    Sq = q.shape[1]
    if Sq <= Q_CHUNK or Sq % Q_CHUNK != 0:
        return _sdpa_block(q, k, v, causal=causal, q_offset=q_offset,
                           kv_len=kv_len)
    return torch.cat([
        _sdpa_block(q[:, i:i + Q_CHUNK], k, v, causal=causal,
                    q_offset=q_offset + i, kv_len=kv_len)
        for i in range(0, Sq, Q_CHUNK)], dim=1)


def cache_update(cache: torch.Tensor, update: torch.Tensor,
                 index: torch.Tensor | int,
                 update_lens: torch.Tensor | None = None) -> torch.Tensor:
    """Write `update` (B, S, ...) into `cache` (B, L, ...) **in place** at
    sequence position `index` — an int or 0-dim tensor (all rows at one
    position) or (B,) (each row at its own position). Returns `cache`.

    Starts are clamped to ``[0, L - S]`` as the JAX package's
    ``dynamic_update_slice`` clamps them, so a retired row whose index ran
    past the end writes inside its own row and never out of bounds.

    `update_lens` (B,), with a per-row `index`, limits row b's write to its
    first ``update_lens[b]`` update rows (the chunked-prefill contract):
    positions past a row's valid tokens keep their cached values, so a
    zero-length row writes nothing."""
    B, S = update.shape[:2]
    L = cache.shape[1]
    update = update.to(cache.dtype)
    hi = max(L - S, 0)
    if not torch.is_tensor(index) or index.dim() == 0:
        start = min(max(int(index), 0), hi)
        cache[:, start:start + S] = update
        return cache
    ar = torch.arange(S, device=cache.device)
    rows = torch.arange(B, device=cache.device)[:, None]
    start = index.long().clamp(0, hi)
    pos = start[:, None] + ar[None, :]                    # (B, S), distinct
    if update_lens is None:
        cache[rows, pos] = update
        return cache
    # realign update rows to their true positions inside the clamped
    # window; positions outside [index, index + len) keep the cache's value
    src = ar[None, :] - (index.long() - start)[:, None]
    valid = (src >= 0) & (src < update_lens.long()[:, None])
    shifted = update[rows, src.clamp(0, S - 1)]
    valid = valid.reshape(valid.shape + (1,) * (cache.dim() - 2))
    cache[rows, pos] = torch.where(valid, shifted, cache[rows, pos])
    return cache


def attention_apply(
    p: Params,
    x: torch.Tensor,
    config: ModelConfig,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    kv_cache: dict | None = None,
    cache_index: torch.Tensor | int | None = None,
    seq_lens: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """GQA self-attention with RoPE and an optional dense KV cache.

    With `kv_cache` ({"k", "v"}: (B, max_len, KV, hd) each) the new keys and
    values are written in place at `cache_index` (scalar or per row;
    `seq_lens` masks a chunk's write to each row's valid tokens) and the
    queries attend over the cached prefix. Returns (y, cache)."""
    B, S, _ = x.shape
    H, KV, hd = config.n_heads, config.kv_heads, config.hd
    q = ops.matmul(x, p["wq"])
    k = ops.matmul(x, p["wk"])
    v = ops.matmul(x, p["wv"])
    if config.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = apply_rope(q.reshape(B, S, H, hd), positions, config.rope_theta)
    k = apply_rope(k.reshape(B, S, KV, hd), positions, config.rope_theta)
    v = v.reshape(B, S, KV, hd)

    new_cache = None
    if kv_cache is not None:
        ck = cache_update(kv_cache["k"], k, cache_index, update_lens=seq_lens)
        cv = cache_update(kv_cache["v"], v, cache_index, update_lens=seq_lens)
        new_cache = {"k": ck, "v": cv}
        # the cache may be stored narrower than the activations (a bf16
        # cache under an f32 config): convert at read
        out = _sdpa(q, ck.to(q.dtype), cv.to(q.dtype), causal=True,
                    q_offset=cache_index, kv_len=cache_index + S)
    else:
        out = _sdpa(q, k, v, causal=causal)
    y = ops.matmul(out.reshape(B, S, H * hd), p["wo"])
    return y, new_cache


# ---------------- MLPs ----------------

def swiglu_apply(p: Params, x: torch.Tensor,
                 config: ModelConfig | None = None) -> torch.Tensor:
    """SwiGLU FFN (plain GELU FFN when there is no `w_gate`)."""
    u = ops.matmul(x, p["w_up"])
    if "w_gate" in p:
        g = ops.matmul(x, p["w_gate"])
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    return ops.matmul(h, p["w_down"])


# ---------------- decode-state slot surgery ----------------
#
# Continuous batching keeps one batched decode state of `max_batch` slots
# and retires/refills single slots mid-decode. A state is a nested dict of
# tensors whose batch axis differs per leaf (KV caches (L, B, S, ...), the
# per-row index (B,)), so the axis is found structurally by comparing the
# state's shapes at two batch sizes.


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map `fn` over the leaves of nested dicts with the same keys."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def state_batch_axes(tree_b1, tree_b2):
    """Per-leaf batch axis of a decode-state tree, from the same state built
    at two batch sizes (-1 for leaves that do not depend on batch). Raises
    if a leaf differs along more than one axis."""

    def axis(a, b):
        diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if len(a.shape) != len(b.shape) or len(diff) > 1:
            raise ValueError(f"ambiguous batch axis: {a.shape} vs {b.shape}")
        return diff[0] if diff else -1

    return tree_map(axis, tree_b1, tree_b2)


def take_slot_state(batch_state, axes, slot: int):
    """Row `slot` of `batch_state` as a batch-1 state of views (no copy)."""
    return tree_map(lambda big, ax: big if ax < 0 else big.narrow(ax, slot, 1),
                    batch_state, axes)


def insert_slot_state(batch_state, slot_state, axes, slot: int):
    """Copy the batch-1 `slot_state` into row `slot` of `batch_state`, in
    place (cast to the batched leaf's dtype). Returns `batch_state`."""

    def insert(big, small, ax):
        if ax >= 0:
            big.narrow(ax, slot, 1).copy_(small)

    tree_map(insert, batch_state, slot_state, axes)
    return batch_state
