"""State-space blocks: Mamba1 (Falcon-Mamba) and Mamba2/SSD (Zamba2's
backbone).

The counterpart of the JAX package's `repro.models.ssm`. Every
projection (in_proj, x_proj, dt_proj, out_proj) goes through
`kernels.ops.matmul`, so on the card each is a launch of the hand-written
GEMM; the causal conv and both scans are plain torch, as the reference
leaves them to XLA.

Under tensor-parallel serving (gather mode, `distributed.tp`) a rank holds
its block of the channels (Mamba1) or SSD heads (Mamba2) of every leaf,
cut by parts (`sharding.axis_parts`: in_proj's x and z, and Mamba2's dt,
each cut apart; the group-shared B and C whole): in_proj is
column-parallel, the conv and the scans run over the rank's channels or
heads, and out_proj gathers its input and its columns. Two reductions run
over the whole d_inner, in the reference's gather-mode order: Mamba1's
x_proj, whose input is gathered first (the reference's
`replicate_for_parity`), and Mamba2's gated RMSNorm, whose gated input is
gathered before the mean (the concatenation of the ranks' heads is the
tp=1 tensor, so the mean adds in tp=1's order, and out_proj then needs no
gather of its own). The sizes a block runs at are its weights' shapes,
never the config's, and the cache allocators take their local shapes
from `sharding.local_state_shape`.

Under tensor-parallel training (psum mode) the block's input enters
in_proj (`tp.enter`), x_proj's rows and the gated norm's scale are this
rank's channels, and both reductions over d_inner are sums across ranks
whose gradients are summed too (`tp.reduce_to_model`: x_proj's partial
product, the norm's sum of squares); out_proj's rows are cut and its
partial products all-reduced (`tp.tp_row`). Mamba2's B and C, whole on
every rank, get each rank's heads' share of their weights' gradient,
which the train step sums (`tp.sum_whole_parts`).

The scans. The reference runs an associative scan inside each block of q
steps and a sequential `lax.scan` across blocks. A literal port would issue
O(S / q) small launches per op per layer, so the port reorders the same
arithmetic across independent elements only:

* every block's in-block prefix (the decay products ``A`` and the state
  ``B`` reached from a zero state; for SSD the intra-block outputs and the
  block's own state contribution) is computed for all blocks at once, from
  the identity, since it does not depend on the carried state;
* the carry is then folded across blocks in order (one small op per block
  on the state alone), and each block's states are formed from its
  incoming state in one op for all blocks.

A block's arithmetic does not depend on how many blocks share the call, so
the reference's contract holds bit for bit inside the port: a prefill split
at any multiple of q, carrying the state, equals the unsplit one, and
identity-padded tails (decay 1, input 0) are invisible. Against the JAX
package the scans agree to f32 rounding (its associative scan adds in
another order).

Batch independence. Each contraction (``y = C . h`` over d_state, the SSD
terms over d_state or the block's steps) is an elementwise product summed
over a contiguous last axis, never a batched einsum or bmm, whose cuBLAS
algorithm may change with the batch: a row's bits do not depend on its
neighbours, so a request's stream does not depend on who shares its batch.
Training (no cache) needs no such independence, and there the SSD scan's
contractions are einsums, as in the reference, whose temporaries stay the
size of their operands. Both scans build their in-block prefixes as lists
of steps, so autograd can differentiate them.

States: a mamba1 layer keeps ``conv`` (B, K-1, d_inner) and ``ssm``
(B, d_inner, d_state); a mamba2 layer ``conv`` (B, K-1, conv_ch) and ``ssm``
(B, H, d_state, headdim); both in f32. The blocks write the cache they are
given in place (JAX returns a new one).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.distributed import tp as TP
from repro_torch.distributed.sharding import local_state_shape
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

CHUNK = 128

# Serving-prefill scan block. Chunked admission feeds a prompt through the
# decode loop in bucketed chunks and must carry the SSM state across chunk
# boundaries bit-exactly; a scan split at a multiple of its block size
# executes the same arithmetic, so every serving-path scan uses this block
# size, which divides every chunk bucket (`ops.prefill_buckets`), and an
# unchunked serving prefill is bit-identical to any chunking of it.
# Without a cache (training) the wide CHUNK blocks are used.
SERVE_CHUNK = 8


def serve_chunk(cfg: ModelConfig) -> int:
    """Serving-scan block size: `cfg.ssm_serve_grain` when set, else
    `SERVE_CHUNK`. The engine validates that `chunk_tokens` is a multiple,
    so the bit-parity argument above still applies."""
    return int(getattr(cfg, "ssm_serve_grain", 0) or 0) or SERVE_CHUNK


# ---------------- the blocks' weights ----------------

def _ssm_params(device, dt, shapes: dict, f32: dict) -> nn.ParameterDict:
    """The ``ssm`` group: `shapes` in the parameter dtype, `f32` (A_log and
    D) in float32 whatever it is, as in the reference."""
    group = L.frozen_params(device, dt, **shapes)
    group.update(L.frozen_params(device, torch.float32, **f32))
    return group


class Mamba1Block(nn.Module):
    """Falcon-Mamba block: RMSNorm -> in_proj -> causal conv -> selective
    scan (x_proj, dt_proj) -> gate -> out_proj, residual."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        """Allocate the block's parameters, uninitialised, on `device`."""
        super().__init__()
        d, di, ds, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.d_conv
        r = max(1, d // 16)  # dt_rank
        dt = L.torch_dtype(cfg.param_dtype)
        self.ln = L.frozen_params(device, dt, scale=(d,))
        self.ssm = _ssm_params(
            device, dt,
            dict(in_proj=(d, 2 * di), conv_w=(di, K), conv_b=(di,),
                 x_proj=(di, r + 2 * ds), dt_proj=(r, di), dt_bias=(di,),
                 out_proj=(di, d)),
            dict(A_log=(di, ds), D=(di,)))


class Mamba2Block(nn.Module):
    """Mamba2 (SSD) block: RMSNorm -> in_proj (z, xBC, dt) -> causal conv
    -> SSD scan -> gated RMSNorm -> out_proj, residual."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        """Allocate the block's parameters, uninitialised, on `device`."""
        super().__init__()
        d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
        G, H = cfg.ssm_ngroups, cfg.d_inner // cfg.ssm_headdim
        conv_ch = di + 2 * G * ds
        dt = L.torch_dtype(cfg.param_dtype)
        self.ln = L.frozen_params(device, dt, scale=(d,))
        self.ssm = _ssm_params(
            device, dt,
            dict(in_proj=(d, 2 * di + 2 * G * ds + H),
                 conv_w=(conv_ch, cfg.d_conv), conv_b=(conv_ch,),
                 dt_bias=(H,), norm_scale=(di,), out_proj=(di, d)),
            dict(A_log=(H,), D=(H,)))


@torch.no_grad()
def init_ssm_leaf(name: str, w: torch.Tensor, cfg: ModelConfig,
                  generator: torch.Generator) -> bool:
    """Fill an SSM leaf with the reference's initialisation, or return
    False for a leaf that is a plain projection (N(0, 1/d_in), drawn by the
    caller): conv weights N(0, 1/K), zero conv bias, dt_bias
    softplus^-1(0.01) = -4.6, A_log the S4D-real log(1..d_state) (Mamba1)
    or 0 (Mamba2), D and the gated norm's scale 1."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "conv_w":
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device,
                            dtype=torch.float32).div_(math.sqrt(w.shape[-1])))
    elif leaf == "conv_b":
        w.zero_()
    elif leaf == "dt_bias":
        w.fill_(-4.6)
    elif leaf == "A_log":
        if cfg.kind == "mamba1":
            w.copy_(torch.log(torch.arange(
                1, w.shape[-1] + 1, dtype=torch.float32,
                device=w.device)).expand(w.shape))
        else:
            w.zero_()
    elif leaf in ("D", "norm_scale"):
        w.fill_(1.0)
    else:
        return False
    return True


# ---------------- causal depthwise conv ----------------

def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                history: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, S, C); w: (C, K); history: (B, K-1, C) carried state (zeros
    if None). Returns the conv in f32 cast to ``x.dtype``."""
    B, S, C = x.shape
    K = w.shape[1]
    if history is None:
        history = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([history.float(), x.float()], dim=1)   # (B, S+K-1, C)
    wf = w.float()
    out = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + S] * wf[:, i]
    out = out + b.float()
    return out.to(x.dtype)


def conv_history(history: torch.Tensor, x: torch.Tensor,
                 seq_lens: torch.Tensor) -> torch.Tensor:
    """Carried conv state over a right-padded chunk: the last K-1 *valid*
    inputs per row (pad positions must not enter the next chunk's receptive
    field). `seq_lens`: (B,) valid token count per row; a row with 0 valid
    tokens keeps its history. Returned in f32 (the concatenation's type, as
    in the reference)."""
    Km1 = history.shape[1]
    xp = torch.cat([history.float(), x.float()], dim=1)   # (B, Km1+S, C)
    idx = seq_lens.long()[:, None] + torch.arange(Km1, device=x.device)
    return xp[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _seq_mask(seq_lens: torch.Tensor, S: int) -> torch.Tensor:
    """(B, S) validity mask for right-padded chunk rows."""
    return (torch.arange(S, device=seq_lens.device)[None, :]
            < seq_lens.long()[:, None])


# ---------------- first-order recurrence (blocked) ----------------

def _block_prefix(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """In-block h_t = a_t h_{t-1} + b_t from the identity, for every block
    at once. a, b: (B, nc, q, ...). Returns (A, Bc): A_t = a_1 ... a_t and
    Bc_t the state at t from a zero state, so that h_t = Bc_t + A_t h0.
    Each step is a new tensor, stacked at the end: autograd keeps the
    step it multiplies, so no step may be written over in place. The
    steps of `a` and `b` are taken by one `unbind`, whose backward stacks
    their gradients once (indexing step t would make each step's gradient
    a zero-filled tensor the size of `a`, 2.1 GB for falcon-mamba-7b at
    8 x 512, and add 128 of them)."""
    a_t, b_t = a.unbind(2), b.unbind(2)
    A, Bc = [a_t[0]], [b_t[0]]
    for t in range(1, len(a_t)):
        A.append(A[-1] * a_t[t])
        Bc.append(Bc[-1] * a_t[t] + b_t[t])
    return torch.stack(A, dim=2), torch.stack(Bc, dim=2)


def _pad_time(t: torch.Tensor, pad: int, value: float) -> torch.Tensor:
    """`t` (B, S, ...) with `pad` steps of `value` appended on axis 1."""
    if not pad:
        return t
    tail = torch.full((t.shape[0], pad, *t.shape[2:]), value, dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, tail], dim=1)


def mamba1_scan(decay: torch.Tensor, inp: torch.Tensor, C: torch.Tensor,
                h0: torch.Tensor, chunk: int = CHUNK
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """decay/inp: (B, S, di, ds); C: (B, S, ds); h0: (B, di, ds). Returns
    y: (B, S, di) = C_t . h_t, and the final state.

    A non-divisible tail is identity-padded (decay 1, input 0) to a multiple
    of the block size, which leaves every real position's value as it is."""
    B, S, di, ds = decay.shape
    q = min(chunk, S)
    pad = (-S) % q
    nc = (S + pad) // q
    a = _pad_time(decay, pad, 1.0).reshape(B, nc, q, di, ds)
    b = _pad_time(inp, pad, 0.0).reshape(B, nc, q, di, ds)
    Cm = _pad_time(C, pad, 0.0).reshape(B, nc, q, 1, ds)
    A, Bc = _block_prefix(a, b)
    # the state entering each block, folded in order (from the blocks'
    # last steps, taken once: see `_block_prefix` on indexing)
    A_last, Bc_last = A[:, :, -1], Bc[:, :, -1]
    starts, h = [h0], h0
    for c in range(nc - 1):
        h = Bc_last[:, c] + A_last[:, c] * h
        starts.append(h)
    h_all = Bc + A * torch.stack(starts, dim=1)[:, :, None]
    y = (h_all * Cm).sum(-1).reshape(B, nc * q, di)
    return y[:, :S], h_all[:, -1, -1]


# ---------------- Mamba1 block ----------------

def selective_scan(x_conv: torch.Tensor, dt: torch.Tensor, s,
                   Bm: torch.Tensor, Cm: torch.Tensor, h0: torch.Tensor, *,
                   single_step: bool = False,
                   seq_mask: torch.Tensor | None = None, chunk: int = CHUNK
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba1's selective scan over the channels of `x_conv` (B, S, di):
    `dt` (B, S, di) is dt_proj's output, `s` holds the channels' dt_bias,
    A_log (di, ds) and D, `Bm`/`Cm` (B, S, ds) are shared by every channel
    and `h0` is (B, di, ds). Returns (y + D x in f32, h_final). Every
    channel's arithmetic is its own, so a rank's channels give the whole
    call's bits for them.

    `seq_mask` (B, S) marks the valid positions of a right-padded chunk: pad
    steps become the identity update (decay 1, input 0), so the carried
    state stops at each row's last valid token."""
    dtv = F.softplus(dt + s["dt_bias"].float())              # (B, S, di)
    A = -torch.exp(s["A_log"].float())                       # (di, ds)
    decay = torch.exp(dtv[..., None] * A)                    # (B, S, di, ds)
    xf = x_conv.float()
    inp = (dtv * xf)[..., None] * Bm.float()[:, :, None, :]
    if seq_mask is not None:
        m = seq_mask[..., None, None]
        decay = torch.where(m, decay, 1.0)
        inp = torch.where(m, inp, 0.0)
    if single_step:
        h = decay[:, 0] * h0 + inp[:, 0]                     # (B, di, ds)
        y = (h * Cm[:, 0].float()[:, None, :]).sum(-1)[:, None]
        h_final = h
    else:
        y, h_final = mamba1_scan(decay, inp, Cm.float(), h0, chunk=chunk)
    return y + s["D"].float() * xf, h_final


def _mamba1_core(s, x_conv: torch.Tensor, cfg: ModelConfig, h0: torch.Tensor,
                 **kw):
    """x_conv: post-conv activations (B, S, di), this rank's channels under
    tensor parallelism. Returns (y f32, h_final) over the same channels
    (`selective_scan`, which takes `kw`)."""
    ds = cfg.ssm_state
    r = max(1, cfg.d_model // 16)
    if TP.psum_mode(cfg) and s["x_proj"].shape[0] != cfg.d_inner:
        # psum mode: x_proj's rows are this rank's channels, so each rank's
        # product is a partial sum; every rank uses the whole sum only in
        # part (its dt_proj columns, its channels' scan), so the sum's
        # gradient is summed as well (`tp.reduce_to_model`)
        proj = TP.reduce_to_model(ops.matmul(x_conv, s["x_proj"]))
    else:
        # x_proj contracts the whole d_inner: gathered first in gather mode
        proj = ops.matmul(TP.replicate_for_parity(x_conv, -1, cfg),
                          s["x_proj"])                        # (B, S, r+2ds)
    # dt_low is a strided view of proj (row stride r + 2 ds)
    dt_low, Bm, Cm = proj[..., :r], proj[..., r:r + ds], proj[..., r + ds:]
    dt = TP.tp_column(dt_low, s["dt_proj"], cfg, cfg.d_inner).float()
    return selective_scan(x_conv, dt, s, Bm, Cm, h0, **kw)


def mamba1_block_apply(blk: Mamba1Block, x: torch.Tensor, cfg: ModelConfig,
                       *, positions=None, cache: dict | None = None,
                       cache_index=None, seq_lens=None):
    """One Mamba1 block; returns (x, cache, aux) (aux is 0: the uniform
    block API). `cache` {"conv": (B, K-1, di), "ssm": (B, di, ds)} is
    written in place. `seq_lens` (B,) marks each row's valid tokens in a
    right-padded chunk: conv history and SSM state advance over them
    only. Under tensor parallelism `cache` and every activation between
    in_proj and out_proj hold this rank's channels."""
    B, S, _ = x.shape
    s = blk.ssm
    h = TP.enter(L.rmsnorm(blk.ln, x, cfg.norm_eps), cfg, s["in_proj"],
                 2 * cfg.d_inner)
    x_, z = TP.tp_column(h, s["in_proj"], cfg,
                         2 * cfg.d_inner).chunk(2, dim=-1)
    if cache is not None:
        x_conv = causal_conv(x_, s["conv_w"], s["conv_b"], cache["conv"])
        if seq_lens is None:
            hist = torch.cat([cache["conv"].float(), x_.float()],
                             dim=1)[:, -(cfg.d_conv - 1):]
        else:
            hist = conv_history(cache["conv"], x_, seq_lens)
        x_conv = F.silu(x_conv.float()).to(x.dtype)
        y, h_final = _mamba1_core(
            s, x_conv, cfg, cache["ssm"].float(), single_step=(S == 1),
            seq_mask=None if seq_lens is None else _seq_mask(seq_lens, S),
            chunk=serve_chunk(cfg))
        cache["conv"].copy_(hist)
        cache["ssm"].copy_(h_final)
    else:
        x_conv = causal_conv(x_, s["conv_w"], s["conv_b"])
        x_conv = F.silu(x_conv.float()).to(x.dtype)
        h0 = torch.zeros((B, x_.shape[-1], cfg.ssm_state),
                         dtype=torch.float32, device=x.device)
        y, _ = _mamba1_core(s, x_conv, cfg, h0)
    y = y * F.silu(z.float())
    out = TP.tp_row(y.to(x.dtype), s["out_proj"], cfg, cfg.d_model,
                    cfg.d_inner)
    return x + out, cache, 0.0


def init_mamba1_cache(cfg: ModelConfig, batch: int, *,
                      device: str | torch.device = "cuda") -> dict:
    """Zeroed f32 Mamba1 state, stacked on a leading layer axis (this
    rank's channels under tensor parallelism)."""
    dev = resolve_device(device)
    L_ = cfg.n_layers
    shapes = {"conv": (L_, batch, cfg.d_conv - 1, cfg.d_inner),
              "ssm": (L_, batch, cfg.d_inner, cfg.ssm_state)}
    return {k: torch.zeros(local_state_shape(k, v, cfg), dtype=torch.float32,
                           device=dev) for k, v in shapes.items()}


# ---------------- Mamba2 (SSD) ----------------

def _cumsum_steps(a: torch.Tensor) -> torch.Tensor:
    """Prefix sums over axis 2, added in step order (a fixed order: a
    torch scan may pick its tree by the tensor's size), each step a new
    tensor as in `_block_prefix`."""
    a_t = a.unbind(2)
    out = [a_t[0]]
    for t in range(1, len(a_t)):
        out.append(out[-1] + a_t[t])
    return torch.stack(out, dim=2)


def ssd_scan(x: torch.Tensor, a_log: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, h0: torch.Tensor, chunk: int = CHUNK,
             rowwise: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD blocked recurrence.

    x: (B, S, H, P) inputs already scaled by dt; a_log: (B, S, H) per-step
    log decay (<= 0); Bm/Cm: (B, S, N) state in/out projections (ngroups 1,
    broadcast over heads); h0: (B, H, N, P). Returns y (B, S, H, P) and the
    final state. A non-divisible tail is identity-padded (zero input, B, C
    and log decay).

    `rowwise` (serving) writes the three contractions (the intra-block
    outputs over the block's steps, each block's own state and the carried
    state's outputs, both over N) as products summed over the last axis,
    so a row's bits do not depend on its batch; their temporaries are the
    size of the product, (B, nc, q, H, P, q) and (B, nc, q or H, ..., N),
    about 11 and 5 GB a layer for zamba2-2.7b at 8 x 512. Without it
    (training) they are einsums, as in the JAX package, and nothing larger
    than the (B, nc, q, q, H) decay weights is made."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    q = min(chunk, S)
    pad = (-S) % q
    nc = (S + pad) // q
    xr = _pad_time(x, pad, 0.0).reshape(Bsz, nc, q, H, P)
    ar = _pad_time(a_log, pad, 0.0).reshape(Bsz, nc, q, H)
    Br = _pad_time(Bm, pad, 0.0).reshape(Bsz, nc, q, N)
    Cr = _pad_time(Cm, pad, 0.0).reshape(Bsz, nc, q, N)
    la = _cumsum_steps(ar)                                   # (B, nc, q, H)
    # intra-block: attention-like causal products with decay weights
    if rowwise:
        scores = (Cr[:, :, :, None, :] * Br[:, :, None, :, :]).sum(-1)
    else:
        scores = torch.einsum("bcqn,bckn->bcqk", Cr, Br)
    decay_qk = torch.exp(la[:, :, :, None, :] - la[:, :, None, :, :])
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    w = torch.where(causal[None, None, :, :, None],
                    scores[..., None] * decay_qk, 0.0)       # (B,nc,q,k,H)
    # y_intra[q, h, p] = sum_k w[q, k, h] x[k, h, p]
    if rowwise:
        y = (w.permute(0, 1, 2, 4, 3)[:, :, :, :, None, :]
             * xr.permute(0, 1, 3, 4, 2)[:, :, None]).sum(-1)
    else:
        y = torch.einsum("bcqkh,bckhp->bcqhp", w, xr)        # (B,nc,q,H,P)
    # each block's own state: s_c[h, n, p] = sum_k B[k, n] x[k, h, p] rem
    rem = torch.exp(la[:, :, -1:, :] - la)                   # (B, nc, q, H)
    if rowwise:
        xw = (xr * rem[..., None]).permute(0, 1, 3, 4, 2)    # (B,nc,H,P,k)
        s_c = (Br.permute(0, 1, 3, 2)[:, :, None, :, None, :]
               * xw[:, :, :, None]).sum(-1)                  # (B,nc,H,N,P)
    else:
        s_c = torch.einsum("bckn,bckhp->bchnp", Br, xr * rem[..., None])
    dec = torch.exp(la[:, :, -1])[..., None, None]           # (B,nc,H,1,1)
    # the state entering each block, folded in order
    starts, h = [h0], h0
    for c in range(nc):
        h = dec[:, c] * h + s_c[:, c]
        if c < nc - 1:
            starts.append(h)
    H0 = torch.stack(starts, dim=1)                          # (B,nc,H,N,P)
    # inter-block: y_inter[q, h, p] = sum_n C[q, n] h0[h, n, p] e^la[q, h]
    if rowwise:
        y_inter = (Cr[:, :, :, None, None, :]
                   * H0.permute(0, 1, 2, 4, 3)[:, :, None]).sum(-1)
    else:
        y_inter = torch.einsum("bcqn,bchnp->bcqhp", Cr, H0)
    y = y + y_inter * torch.exp(la)[..., None]
    return y.reshape(Bsz, nc * q, H, P)[:, :S], h


def _mamba2_split(cfg: ModelConfig, proj: torch.Tensor, heads: int
                  ) -> tuple:
    """in_proj's output over `heads` SSD heads (this rank's under tensor
    parallelism) as (z, xBC, dt)."""
    di = heads * cfg.ssm_headdim
    return proj.split([di, di + 2 * cfg.ssm_ngroups * cfg.ssm_state, heads],
                      dim=-1)


def ssd_heads(xs: torch.Tensor, dt_raw: torch.Tensor, s, Bm: torch.Tensor,
              Cm: torch.Tensor, h0: torch.Tensor, *, seq_lens=None,
              single_step: bool = False, chunk: int = CHUNK,
              rowwise: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2's SSD over the heads of `xs` (B, S, H, P): `dt_raw` (B, S,
    H) is in_proj's dt, `s` holds the heads' dt_bias, A_log and D, `Bm`/
    `Cm` (B, S, N) are shared by every head, `h0` is (B, H, N, P). One
    step (`single_step`, a decode with a cache) or `ssd_scan` in blocks of
    `chunk`. Returns (y + D x (B, S, H, P) in f32, h_final). Every head's
    arithmetic is its own, so a rank's heads give the whole call's bits
    for them. `seq_lens` (B,) masks a right-padded chunk: pad steps carry
    zero input, B and log decay (the identity update)."""
    S = xs.shape[1]
    dtv = F.softplus(dt_raw.float() + s["dt_bias"].float())  # (B, S, H)
    a_log = -torch.exp(s["A_log"].float()) * dtv
    x_dt = xs.float() * dtv[..., None]
    Bm_f = Bm.float()
    if seq_lens is not None:
        mask = _seq_mask(seq_lens, S)
        a_log = torch.where(mask[..., None], a_log, 0.0)
        x_dt = torch.where(mask[..., None, None], x_dt, 0.0)
        Bm_f = torch.where(mask[..., None], Bm_f, 0.0)
    if single_step:
        decay = torch.exp(a_log[:, 0])[..., None, None]     # (B, H, 1, 1)
        upd = Bm_f[:, 0][:, None, :, None] * x_dt[:, 0][:, :, None, :]
        h_final = decay * h0 + upd                           # (B, H, N, P)
        y = (Cm[:, 0].float()[:, None, None, :]
             * h_final.transpose(-1, -2)).sum(-1)[:, None]   # (B, 1, H, P)
    else:
        y, h_final = ssd_scan(x_dt, a_log, Bm_f, Cm.float(), h0,
                              chunk=chunk, rowwise=rowwise)
    return y + s["D"].float()[None, None, :, None] * xs.float(), h_final


def mamba2_block_apply(blk: Mamba2Block, x: torch.Tensor, cfg: ModelConfig,
                       *, positions=None, cache: dict | None = None,
                       cache_index=None, seq_lens=None):
    """One Mamba2 block; returns (x, cache, aux). `cache` {"conv": (B, K-1,
    conv_ch), "ssm": (B, H, N, P)} is written in place. `seq_lens` (B,)
    marks each row's valid tokens: pad steps carry zero input, B and log
    decay (the identity update). Under tensor parallelism `cache` and the
    scan hold this rank's heads (B and C whole) and the gated norm's input
    is gathered to the whole d_inner."""
    B, S, _ = x.shape
    ds, G = cfg.ssm_state, cfg.ssm_ngroups
    P = cfg.ssm_headdim
    s = blk.ssm
    H = s["A_log"].shape[0]                 # this rank's heads
    di = H * P
    n_proj = 2 * cfg.d_inner + 2 * G * ds + cfg.d_inner // P
    # in psum mode a rank's gradient of hin is its columns' share, B and
    # C's included (each rank's is its heads' share of theirs): `enter`
    # sums it once, and (sum_r dBC_r) W_BC^T is what the sum of the ranks'
    # dBC_r W_BC^T gives, so B and C's input gradient is not summed again
    hin = TP.enter(L.rmsnorm(blk.ln, x, cfg.norm_eps), cfg, s["in_proj"],
                   n_proj)
    proj = TP.tp_column(hin, s["in_proj"], cfg, n_proj)
    z, xBC, dt_raw = _mamba2_split(cfg, proj, H)
    hist = None
    if cache is not None:
        xBC_c = causal_conv(xBC, s["conv_w"], s["conv_b"], cache["conv"])
        if seq_lens is None:
            hist = torch.cat([cache["conv"].float(), xBC.float()],
                             dim=1)[:, -(cfg.d_conv - 1):]
        else:
            hist = conv_history(cache["conv"], xBC, seq_lens)
    else:
        xBC_c = causal_conv(xBC, s["conv_w"], s["conv_b"])
    xBC_c = F.silu(xBC_c.float()).to(x.dtype)
    xs, Bm, Cm = xBC_c.split([di, G * ds, G * ds], dim=-1)
    h0 = (cache["ssm"].float() if cache is not None else
          torch.zeros((B, H, ds, P), dtype=torch.float32, device=x.device))
    y, h_final = ssd_heads(xs.reshape(B, S, H, P), dt_raw, s, Bm, Cm, h0,
                           seq_lens=seq_lens,
                           single_step=cache is not None and S == 1,
                           chunk=serve_chunk(cfg) if cache is not None
                           else CHUNK, rowwise=cache is not None)
    if cache is not None:
        cache["conv"].copy_(hist)
        cache["ssm"].copy_(h_final)
    y = y.reshape(B, S, di) * F.silu(z.float())
    # gated RMSNorm (mamba2), its mean over the whole d_inner
    if TP.psum_mode(cfg) and di != cfg.d_inner:
        # psum mode: this rank's channels; the sum of squares is summed
        # over "model", and since each rank scales only its own channels
        # by it, so is its gradient (`tp.reduce_to_model`)
        var = TP.reduce_to_model((y * y).sum(-1, keepdim=True)) / cfg.d_inner
    else:
        y = TP.replicate_for_parity(y, -1, cfg)
        var = (y * y).mean(-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps)
    y = y * s["norm_scale"].float()
    out = TP.tp_row(y.to(x.dtype), s["out_proj"], cfg, cfg.d_model,
                    cfg.d_inner)
    return x + out, cache, 0.0


def init_mamba2_cache(cfg: ModelConfig, batch: int, *,
                      device: str | torch.device = "cuda") -> dict:
    """Zeroed f32 Mamba2 state, stacked on a leading layer axis (this
    rank's heads, and their x channels beside the whole B and C in the
    conv history, under tensor parallelism)."""
    di, ds, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
    H = di // cfg.ssm_headdim
    L_ = cfg.n_layers
    dev = resolve_device(device)
    shapes = {"conv": (L_, batch, cfg.d_conv - 1, di + 2 * G * ds),
              "ssm": (L_, batch, H, ds, cfg.ssm_headdim)}
    return {k: torch.zeros(local_state_shape(k, v, cfg), dtype=torch.float32,
                           device=dev) for k, v in shapes.items()}
