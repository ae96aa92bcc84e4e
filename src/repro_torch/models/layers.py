"""Dense transformer building blocks (bf16 activations, fp32 math).

The counterparts of the dense parts of the JAX package's
`repro.models.layers`, with its layouts: weights are (d_in, d_out) with
``y = x @ w``, activations (B, S, ...), KV caches (B, max_len, KV, hd) per
layer. Every projection goes through `kernels.ops.matmul`, so on the card
each one is a launch of the hand-written GEMM. Attention, norms, RoPE and
the paged-KV primitives are plain PyTorch, as the JAX package leaves them to
XLA.

Where the JAX package is functional, the port writes KV state in place:
`cache_update`, `paged_cache_update`, `copy_pool_pages` and
`insert_slot_state` modify the tensors they are given.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import torch
import torch.nn.functional as F

from repro_torch.distributed import tp as TP
from repro_torch.models.config import ModelConfig

Params = Mapping[str, torch.Tensor]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's spelling ("bfloat16", "float32")."""
    return getattr(torch, name)


def frozen_params(device, dtype, **shapes) -> torch.nn.ParameterDict:
    """Uninitialised, frozen parameters of the given shapes (serving
    differentiates nothing; `train.step.init_train_state` turns them on)."""
    return torch.nn.ParameterDict({
        name: torch.nn.Parameter(torch.empty(shape, dtype=dtype,
                                             device=device),
                                 requires_grad=False)
        for name, shape in shapes.items()})


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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (B, S, H, hd); positions: (B, S, 3)
    (t, h, w) ids. The hd/2 frequency channels are cut into (t, h, w)
    sections, each rotated by its own position stream; angles in f32, split
    halves as `apply_rope`."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])        # (hd/2,)
    ang = positions.float().index_select(-1, sec) * freqs     # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------- attention ----------------

Q_CHUNK = 1024  # query-block size for memory-bounded exact attention
# On the card cuBLAS picks a batched GEMM's kernel, and with it the order in
# which each dot product is summed, by shape: calls of fewer than 32 query
# rows (a decode step, an 8- or 16-token chunk) get other kernels than every
# longer call, and other ones from one batch size to the next, so a row's
# scores and output would depend on the call it rides in (measured on the
# H100: `chip_smoke.py` phase 12). There the queries are padded to
# Q_MIN_CUDA rows and the pad cut off after: every call sums a row alike.
Q_MIN_CUDA = 32
# Likewise a product of one matrix takes other kernels than a batch of
# several: one rank's single KV head at batch 1 (qwen2-7b at tp = 4) summed
# its scores otherwise than the same head beside the others (measured on
# the H100: `chip_smoke.py` phase 3's tensor-parallel head check). There a
# call whose batch x KV heads is 1 runs on a batch of two copies, the copy
# dropped after.
BATCH_MIN_CUDA = 2


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
                kv_len: torch.Tensor | int | None = None,
                kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    """One query block. q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd).

    Both products take the input values exactly and accumulate in f32 (the
    JAX package's ``preferred_element_type=float32``); softmax in f32; the
    weights are rounded to q's dtype before the PV product. `kv_valid`
    (B, Sk) ANDs an extra key-validity mask in: the paged-KV page-table
    mask."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    scores = torch.einsum("bqgrh,bkgh->bgrqk", qg.float(),
                          k.float()) / math.sqrt(hd)
    mask = attention_mask(Sq, Sk, causal=causal, q_offset=q_offset,
                          kv_len=kv_len, device=q.device)
    if kv_valid is not None:
        kvm = kv_valid[:, None, :]                        # (B, 1, Sk)
        mask = kvm if mask is None else (mask & kvm)
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgh->bqgrh", w.to(q.dtype).float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _twice(t):
    """`t` stacked twice on its batch axis (a scalar or None as it is)."""
    if torch.is_tensor(t) and t.dim():
        return torch.cat([t, t])
    return t


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool, q_offset: torch.Tensor | int = 0,
          kv_len: torch.Tensor | int | None = None,
          kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Exact attention, query-chunked so peak score memory is
    O(Q_CHUNK x Sk) instead of O(Sq x Sk); on the card, fewer than
    `Q_MIN_CUDA` queries are zero-padded to that many, and a call of one
    row and one KV head runs twice over (`BATCH_MIN_CUDA`; see there). The
    key count needs no such padding: a row's bits do not depend on it on
    the card (the encoder's keys are its admission bucket, 8-512 at
    max_len 512; `chip_smoke.py` phase 3's encoder attention line)."""
    Sq = q.shape[1]
    if q.is_cuda and q.shape[0] * k.shape[2] < BATCH_MIN_CUDA:
        return _sdpa(*map(_twice, (q, k, v)), causal=causal,
                     q_offset=_twice(q_offset), kv_len=_twice(kv_len),
                     kv_valid=_twice(kv_valid))[:1]
    if q.is_cuda and Sq < Q_MIN_CUDA:
        pad = q.new_zeros((q.shape[0], Q_MIN_CUDA - Sq, *q.shape[2:]))
        return _sdpa(torch.cat([q, pad], dim=1), k, v, causal=causal,
                     q_offset=q_offset, kv_len=kv_len,
                     kv_valid=kv_valid)[:, :Sq]
    if Sq <= Q_CHUNK or Sq % Q_CHUNK != 0:
        return _sdpa_block(q, k, v, causal=causal, q_offset=q_offset,
                           kv_len=kv_len, kv_valid=kv_valid)
    return torch.cat([
        _sdpa_block(q[:, i:i + Q_CHUNK], k, v, causal=causal,
                    q_offset=q_offset + i, kv_len=kv_len, kv_valid=kv_valid)
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


# ---------------- paged KV cache ----------------
#
# The paged layout replaces each row's dense (max_len, ...) cache with a
# shared pool of fixed-size pages, (P, T, ...) per layer, plus a per-row
# page table (B, n) of physical page ids mapping logical page slot j to
# pool page table[b, j]. Page 0 is the reserved null page (see
# `serving.paging.NULL_PAGE`): rows point unreserved slots — and dead or
# padded rows their whole table — at it, writes through it are dropped, and
# reads from it are masked by `page_valid_mask`. Attention gathers each
# row's pages back into a dense (B, n*T, ...) view per layer, so with
# n*T == max_len the masked score tensor is bit-identical to the dense
# path's (everything behind the mask is replaced by the same -1e30): the
# engine's paged-vs-dense parity rests on this.


def paged_gather(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Gather a dense per-row view from the page pool.

    pages: (P, T, ...) one layer's pool; table: (B, n) integer physical
    page ids. Returns (B, n*T, ...): row b's logical positions in order (a
    transient copy; the resident footprint stays the pool's)."""
    B, n = table.shape
    T = pages.shape[1]
    out = pages[table.long()]                               # (B, n, T, ...)
    return out.reshape((B, n * T) + tuple(pages.shape[2:]))


def paged_cache_update(pages: torch.Tensor, update: torch.Tensor,
                       table: torch.Tensor, index: torch.Tensor | int,
                       update_lens: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Scatter `update` (B, S, ...) into the page pool **in place** at each
    row's logical positions ``index[b] .. index[b] + S`` (translated through
    `table`). Returns `pages`.

    The paged counterpart of `cache_update`: `index` is scalar or (B,),
    `update_lens` (B,) limits each row's write to its valid tokens. Invalid
    positions — past `update_lens`, past the table, or mapping to the null
    page (dead rows) — write nothing, so pad junk and dead slots never
    corrupt a shared page. Live rows write only pages they own alone (the
    allocator's copy-on-write contract), so valid writes never collide.

    Torch has no dropping scatter (the JAX package routes invalid positions
    out of bounds with ``mode="drop"``), and filtering them out by a mask
    would cost a device-to-host sync per call. Instead every invalid
    position is pointed at the null page's first row and writes back that
    row's own value, read before the scatter: the null page keeps its bytes
    exactly, the scatter's shape is fixed, and nothing waits on the host."""
    B, S = update.shape[:2]
    P, T = pages.shape[:2]
    n = table.shape[1]
    dev = pages.device
    index = torch.as_tensor(index, device=dev).long()
    if index.dim() == 0:
        index = index.expand(B)
    pos = index[:, None] + torch.arange(S, device=dev)[None, :]   # (B, S)
    slot = torch.div(pos, T, rounding_mode="floor")      # logical page slot
    phys = torch.gather(table.long(), 1, slot.clamp(0, n - 1))
    valid = (slot < n) & (phys != 0)
    if update_lens is not None:
        valid &= (torch.arange(S, device=dev)[None, :]
                  < update_lens.long()[:, None])
    flat_pool = pages.view((P * T,) + tuple(pages.shape[2:]))
    flat = torch.where(valid, phys * T + pos % T, 0).reshape(B * S)
    upd = update.reshape((B * S,) + tuple(update.shape[2:])).to(pages.dtype)
    keep = valid.reshape((B * S,) + (1,) * (upd.dim() - 1))
    flat_pool[flat] = torch.where(keep, upd, flat_pool[0])
    return pages


def page_valid_mask(table: torch.Tensor, Sk: int) -> torch.Tensor:
    """(B, Sk) bool — True where a gathered view position maps to a real
    (non-null) page. Sk must equal n*T for the (B, n) table."""
    B, n = table.shape
    return (table != 0).repeat_interleave(Sk // n, dim=1)


def paged_attention_mask(Sq: int, Sk: int, table: torch.Tensor, *,
                         causal: bool,
                         q_offset: torch.Tensor | int = 0,
                         kv_len: torch.Tensor | int | None = None
                         ) -> torch.Tensor:
    """`attention_mask` AND page-table validity: the paged-KV mask. Where
    every in-range logical position has a real page (the allocator reserves
    a request's full capacity up front) it equals the dense mask on every
    unmasked position."""
    mask = attention_mask(Sq, Sk, causal=causal, q_offset=q_offset,
                          kv_len=kv_len, device=table.device)
    pv = page_valid_mask(table, Sk)[:, None, :]            # (B, 1, Sk)
    return pv if mask is None else (mask & pv)


def copy_pool_pages(pool: dict, src: torch.Tensor,
                    dst: torch.Tensor) -> dict:
    """Copy pool pages src[i] -> dst[i] on every leaf and every layer,
    **in place**: the device half of the allocator's copy-on-write fork and
    partial-page snapshot. Leaves are (L, P, T, ...), src/dst (C,) integer
    page ids; a ``"table"`` leaf is left alone. The source pages are read
    whole before any is written. Returns `pool`."""
    src, dst = src.long(), dst.long()
    for name, leaf in pool.items():
        if name != "table":
            leaf[:, dst] = leaf[:, src]
    return pool


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
    kv_lens: torch.Tensor | None = None,
    sp: bool = False,
) -> tuple[torch.Tensor, dict | None]:
    """GQA self-attention with RoPE (M-RoPE where ``config.mrope``, with
    (B, S, 3) `positions`) and an optional KV cache, dense or paged.

    With a dense `kv_cache` ({"k", "v"}: (B, max_len, KV, hd) each) the new
    keys and values are written in place at `cache_index` (scalar or per
    row; `seq_lens` masks a chunk's write to each row's valid tokens) and the
    queries attend over the cached prefix. A paged `kv_cache` ({"k_pages",
    "v_pages"}: (P, T, KV, hd) pools, "table": (B, n) page ids) is written in
    place through the table and read back as each row's gathered (B, n*T)
    view under the page-validity mask, with the same contracts.

    Without a cache, `kv_lens` (B,) masks each row's keys to its valid
    rows. Causal attention hides right-pad keys by itself (they sit after
    every valid query); non-causal attention over a right-padded batch (the
    encoder) must pass `kv_lens`, or the pad keys take softmax weight.
    Returns (y, cache).

    Under tensor parallelism (`distributed.tp`) q, k and v are this rank's
    heads' columns (the weights, biases and cache hold H/tp and KV/tp
    heads, whole heads, contiguous), attention runs over the local heads,
    and the output projection makes the whole output on every rank
    (`tp_row`: gathered in gather mode, summed in psum mode). In psum mode
    the block's input enters through `tp.enter`, and where tp does not
    divide the KV heads (training only) ``wk`` and ``wv`` are whole and a
    rank uses its query heads' KV heads. Under `sp` (sequence
    parallelism: `x` is the whole sequence, gathered by
    `tp.gather_from_sequence`, whose backward sums the ranks' shares) no
    input enters through a copy, and the output is this rank's block of
    the sequence (`tp_row`'s reduce-scatter)."""
    B, S, d = x.shape
    hd = config.hd
    n_q, n_kv = config.n_heads * hd, config.kv_heads * hd
    xe = TP.enter(x, config, p["wq"], n_q, sp)
    q = TP.tp_column(xe, p["wq"], config, n_q)
    H = q.shape[-1] // hd                            # this rank's heads
    # psum mode where tp does not divide the KV heads (training only,
    # `sharding.HEAD_LEAVES`): wk and wv are whole, every rank computes the
    # whole keys and values from the block's input and takes its query
    # heads' KV heads, entering there (its gradient of them is its share)
    whole_kv = (TP.psum_mode(config) and H != config.n_heads
                and p["wk"].shape[-1] == n_kv)
    kv_in = x if whole_kv else xe
    k = TP.tp_column(kv_in, p["wk"], config, n_kv)
    v = TP.tp_column(kv_in, p["wv"], config, n_kv)
    if config.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if whole_kv:
        group = config.n_heads // config.kv_heads
        rank = TP.current_mesh().rank
        span = slice(rank * H // group * hd,
                     (((rank + 1) * H - 1) // group + 1) * hd)
        if not sp:
            k, v = TP.copy_to_model(k), TP.copy_to_model(v)
        k, v = k[..., span], v[..., span]
    KV = k.shape[-1] // hd
    def rope(t):
        if config.mrope:
            return apply_mrope(t, positions, config.rope_theta,
                               config.mrope_sections)
        return apply_rope(t, positions, config.rope_theta)

    q = rope(q.reshape(B, S, H, hd))
    k = rope(k.reshape(B, S, KV, hd))
    v = v.reshape(B, S, KV, hd)

    new_cache = None
    if kv_cache is not None and "k_pages" in kv_cache:
        table = kv_cache["table"]
        ck = paged_cache_update(kv_cache["k_pages"], k, table, cache_index,
                                update_lens=seq_lens)
        cv = paged_cache_update(kv_cache["v_pages"], v, table, cache_index,
                                update_lens=seq_lens)
        new_cache = {"k_pages": ck, "v_pages": cv, "table": table}
        ck_d, cv_d = paged_gather(ck, table), paged_gather(cv, table)
        out = _sdpa(q, ck_d.to(q.dtype), cv_d.to(q.dtype), causal=True,
                    q_offset=cache_index, kv_len=cache_index + S,
                    kv_valid=page_valid_mask(table, ck_d.shape[1]))
    elif kv_cache is not None:
        ck = cache_update(kv_cache["k"], k, cache_index, update_lens=seq_lens)
        cv = cache_update(kv_cache["v"], v, cache_index, update_lens=seq_lens)
        new_cache = {"k": ck, "v": cv}
        # the cache may be stored narrower than the activations (a bf16
        # cache under an f32 config): convert at read
        out = _sdpa(q, ck.to(q.dtype), cv.to(q.dtype), causal=True,
                    q_offset=cache_index, kv_len=cache_index + S)
    else:
        out = _sdpa(q, k, v, causal=causal, kv_len=kv_lens)
    y = TP.tp_row(out.reshape(B, S, H * hd), p["wo"], config, d, n_q,
                  sp=sp)
    return y, new_cache


# ---------------- MLPs ----------------

def swiglu_apply(p: Params, x: torch.Tensor,
                 config: ModelConfig | None = None,
                 d_ff: int | None = None, sp: bool = False) -> torch.Tensor:
    """SwiGLU FFN (plain GELU FFN when there is no `w_gate`). Under tensor
    parallelism the up and gate projections are column-parallel and the
    down projection row-parallel (`distributed.tp`); `d_ff` is the whole
    hidden width (default ``w_down``'s rows, which gather mode and one
    rank keep whole; psum mode cuts them, so its callers pass it). Under
    `sp`, `x` (B, S, d) is the gathered sequence and the output this
    rank's block of it, as in `attention_apply`."""
    d_ff = d_ff or p["w_down"].shape[0]
    x = TP.enter(x, config, p["w_up"], d_ff, sp)
    u = TP.tp_column(x, p["w_up"], config, d_ff)
    if "w_gate" in p:
        g = TP.tp_column(x, p["w_gate"], config, d_ff)
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    return TP.tp_row(h, p["w_down"], config, x.shape[-1], d_ff, sp=sp)


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


def state_structures_match(a, b) -> bool:
    """True when two decode-state trees (tensors, or meta tensors of the
    same shapes) share their keys, per-leaf shapes and dtypes: the check
    before a checkpointed batch-1 row is spliced into another engine's
    state (`ServingEngine.adopt`), where a family or geometry mismatch
    shows as a key or shape difference before any device op runs."""
    if isinstance(a, Mapping) or isinstance(b, Mapping):
        return (isinstance(a, Mapping) and isinstance(b, Mapping)
                and a.keys() == b.keys()
                and all(state_structures_match(a[k], b[k]) for k in a))
    return (torch.is_tensor(a) and torch.is_tensor(b)
            and tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype)


# ---------------- losses ----------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  z_loss: float = 1e-4, vocab_start: int | None = None
                  ) -> tuple[torch.Tensor, dict]:
    """Token-level cross entropy with a z-loss (``z_loss * lse**2``), the
    softmax in f32; `mask` (B, S) weights each token (default: all 1).
    Returns (loss, {"nll", "accuracy"}), the metrics detached.

    With `vocab_start`, `logits` are this rank's vocab shard, columns
    [vocab_start, vocab_start + V/tp) (the vocab-parallel head: no rank
    holds the whole logits): the max, the sum of exponentials and the
    target logit are all-reduced over "model" (`tp.reduce_from_model`:
    each rank's gradient of its shard's logits comes out of its own
    terms), and accuracy's argmax across shards sends a tie to the lower
    index, as one argmax over the whole row does. Under a mesh whose
    "data" axis has more than one rank, the mean over tokens is global:
    the masked sums and the mask count are summed over "data" before the
    division (a mean of the shards' means is wrong wherever their counts
    differ), and each data rank's gradient is its tokens' share."""
    lf = logits.float()
    lab = labels.long()
    if vocab_start is None:
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, lab[..., None])[..., 0]
        with torch.no_grad():
            pred = lf.argmax(-1)
    else:
        import torch.distributed as dist

        n_loc = lf.shape[-1]
        with torch.no_grad():
            top, arg = lf.max(-1)
            m = TP.all_reduce(top, op=dist.ReduceOp.MAX)
            cand = torch.where(top == m, arg + vocab_start,
                               torch.iinfo(torch.long).max)
            pred = TP.all_reduce(cand, op=dist.ReduceOp.MIN)
        total = TP.reduce_from_model(torch.exp(lf - m[..., None]).sum(-1))
        lse = m + torch.log(total)
        own = (lab >= vocab_start) & (lab < vocab_start + n_loc)
        mine = torch.gather(lf, -1, (lab - vocab_start).clamp(
            0, n_loc - 1)[..., None])[..., 0]
        ll = TP.reduce_from_model(torch.where(own, mine,
                                              torch.zeros_like(mine)))
    nll = lse - ll
    per_tok = nll + z_loss * lse ** 2
    mask = torch.ones_like(per_tok) if mask is None else mask.float()
    with torch.no_grad():
        hits = (pred == lab).float()
        sums = torch.stack([mask.sum(), (nll * mask).sum(),
                            (hits * mask).sum()])
        if TP.data_size() > 1:
            sums = TP.all_reduce_data(sums.contiguous())
        denom = sums[0].clamp_min(1.0)
    loss = TP.reduce_over_data((per_tok * mask).sum()) / denom
    metrics = {"nll": sums[1] / denom, "accuracy": sums[2] / denom}
    return loss, metrics
