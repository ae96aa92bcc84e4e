"""Explicit-collective tensor-parallel layers over `torch.distributed`.

The JAX package's `repro.distributed.tp` in PyTorch's SPMD idiom: every
rank runs this code on its own shards (`distributed.sharding`) and the
collectives are written out. The residual stream, the norms and every
activation between blocks are whole on every rank; what is sharded is a
projection's output columns and the attention heads behind them.

  column_parallel:  y_loc = x @ w_loc           (w column-sharded)
      no collective; y_loc is this rank's columns.
  row_parallel_gather:  y = gather(gather(x_loc) @ w_loc)
      (w COLUMN-sharded; the serving engine's gather mode): x is
      all-gathered on its last axis, each rank computes its N/tp output
      columns with the full contraction, and the columns are all-gathered.
      No sum ever crosses ranks, so every output element is the unsharded
      product's, bit for bit, where the GEMM gives a column the same bits
      at every width it is computed in (`ops.matmul`'s ``segments_n``:
      every sharded product here reckons its K segments from the whole
      projection's N).
  row_parallel:  y = all_reduce(x_loc @ w_loc)   (w row-sharded; psum
      mode, training's lowest-wire form: a sum across ranks, which
      re-associates the fp32 accumulation).

Both row-parallel forms split the local product into `_n_chunks` column
chunks: in serving chunk c's collective is posted (``async_op=True``)
before chunk c+1's product is launched, so the wire overlaps the GEMM; the
columns are then put back in the unsharded product's order (shard-major).

The backward (training, psum mode) follows Megatron's split into four
`torch.autograd.Function`s, each a collective one way and its transpose
the other, so that every GEMM of the backward is `ops.matmul`'s own (a
launch of the hand-written kernel) and every activation that is whole on
every rank also has its whole gradient, the same on every rank:

  copy_to_model:     forward identity, backward all-reduce over "model"
      (the entry of a column-parallel block: each rank's dx is partial);
  reduce_from_model: forward all-reduce, backward identity (the exit of a
      row-parallel block, the vocab-parallel loss's sums);
  split_to_model:    forward this rank's block, backward all-gather;
  gather_from_model: forward all-gather, backward this rank's block;

and one of the port's own, which Megatron's blocks never need:

  reduce_to_model:   forward all-reduce, backward all-reduce (a partial
      sum over a sharded contraction whose whole result every rank then
      uses only in part: Mamba1's x_proj, whose dt, B and C feed this
      rank's dt_proj columns and scan channels, and Mamba2's gated-norm
      sum of squares, which scales this rank's channels). Each rank's
      gradient of the whole result is its own consumers' share, so it is
      summed before it flows back into the sharded producer;
      `reduce_from_model`'s identity backward is right only where the
      result is used whole.

Two invariants hold the backward to tp=1's: an activation whole on every
rank has its whole gradient, the same on every rank; and a tensor whole
on every rank whose consumers on each rank are partial has a partial
gradient there, summed over "model" before it flows back into a sharded
producer (`enter`, `reduce_to_model`). A weight part that every rank
holds whole inside a sharded leaf (Mamba2's B and C columns of in_proj
and rows of its conv) is such a tensor too: its gradient is each rank's
heads' share, summed after the backward (`sum_whole_parts`).

A block enters through `enter` (a copy only where its weights are
sharded), so the reference's `_col_bwd` (dx cast to the activation dtype,
then summed over "model": the cotangent arrives in the activation's
dtype), `_row_bwd` (no collective) and `_row_gather_bwd` (dx summed, then
this rank's block) come out of the composition; dW stays sharded like W.
The data-axis gradient reduction (the reference's psum of dW over the dp
axes, in the gradient's dtype) is the train step's
(`all_reduce_data`), and `reduce_over_data` sums a loss's parts over
"data" (backward identity).

Megatron sequence parallelism (``cfg.sequence_parallel`` in psum mode,
`sequence_parallel`) keeps the residual stream and the norms on this
rank's 1/tp of the sequence between the sharded products:

  gather_from_sequence:  forward all-gather on the sequence, backward
      reduce-scatter (each rank's gradient of the whole sequence is its
      heads' or columns' share: summed, this rank's block kept);
  scatter_to_sequence:   forward reduce-scatter (a row-parallel product's
      partial sums, this rank's block of the sum), backward all-gather.

They replace a block's `enter` and `tp_row`'s all-reduce. A computation
every rank repeats whole on the whole sequence (a head or a block tp does
not divide, the router, the aux loss) passes its gradient only through
this rank's block (`sequence_block`, `sequence_share`), so that the
gradient of every leaf "model" does not cut is each rank's share under SP,
summed over "model" by the train step. Experts cut over "data"
(``cfg.moe_expert_axis="data"``) take their tokens by `all_to_all_data`,
whose backward is the same exchange back.

FSDP (``cfg.fsdp`` on a mesh whose "data" axis has more than one rank)
cuts a leaf over "data" as well (`sharding.fsdp_axes`); `gather_from_data`
all-gathers such a leaf over "data" before use, and its backward
reduce-scatters the gradient (`distributed.fsdp` applies it a block at a
time).

Every collective goes through `_Pending`, `_all_reduce_`, `_gather`,
`_reduce_scatter_` or `_all_to_all`, which count it (calls and operand bytes by op) and the
host time spent posting and waiting for it (`collectives`). On a dry mesh (`launch.mesh.DryGroup`
groups) nothing is posted: each collective makes its output's meta tensor
and appends (op, operand bytes, group size, axis, elements) to the log of
`record_collectives` (the dry-run's count; `collectives` is not touched).
With gloo, a CUDA tensor is staged through host memory inside the
collective: the transport of several ranks on one card (NCCL refuses two
ranks on one device).
"""

from __future__ import annotations

import contextlib
import threading
import time
import types

import torch

from repro_torch.distributed.sharding import (SP_STACK_KINDS, current_mesh,
                                              model_size, whole_spans)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import DryGroup


# the collectives this process posted: calls, the host seconds spent
# posting and waiting for them, and {op: {"calls", "bytes"}} (operand
# bytes: an all-gather's input, an all-reduce's tensor, a reduce-scatter's
# whole input); `reset_collectives` sets them to 0 before a run
collectives = types.SimpleNamespace(calls=0, host_s=0.0, by_op={})

# the thread's dry collectives' log while `record_collectives` is open
_DRY = threading.local()


def reset_collectives() -> None:
    """Set `collectives` to 0."""
    collectives.calls, collectives.host_s = 0, 0.0
    collectives.by_op = {}


@contextlib.contextmanager
def record_collectives():
    """A list that collects (op, operand bytes, group size, axis, operand
    elements) of every collective this thread posts on a dry mesh while
    the context is open."""
    prev = getattr(_DRY, "log", None)
    _DRY.log = []
    try:
        yield _DRY.log
    finally:
        _DRY.log = prev


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _count(op: str, x: torch.Tensor, t0: float) -> None:
    """Count a posted collective of operand `x`."""
    collectives.calls += 1
    collectives.host_s += time.perf_counter() - t0
    tally = collectives.by_op.setdefault(op, {"calls": 0, "bytes": 0})
    tally["calls"] += 1
    tally["bytes"] += _nbytes(x)


def _dry(group, op: str, x: torch.Tensor) -> bool:
    """Whether `group` is a dry mesh's; if so, log the collective."""
    if not isinstance(group, DryGroup):
        return False
    log = getattr(_DRY, "log", None)
    if log is not None:
        log.append((op, _nbytes(x), group.size, group.axis, x.numel()))
    return True


def _n_chunks(n_cols: int, chunks: int) -> int:
    """Largest chunk count <= `chunks` that divides the column extent."""
    c = max(min(chunks, n_cols), 1)
    while n_cols % c:
        c -= 1
    return c


class _Pending:
    """A posted all-gather: `wait` returns the ranks' parts in rank
    order."""

    def __init__(self, x: torch.Tensor, mesh):
        import torch.distributed as dist

        x = x.contiguous()
        self.parts = [torch.empty_like(x) for _ in range(mesh.tp)]
        self.work = None
        if _dry(mesh.group, "all-gather", x):
            return
        t = time.perf_counter()
        self.work = dist.all_gather(self.parts, x, group=mesh.group,
                                    async_op=True)
        _count("all-gather", x, t)

    def wait(self) -> list[torch.Tensor]:
        if self.work is not None:
            t = time.perf_counter()
            self.work.wait()
            collectives.host_s += time.perf_counter() - t
        return self.parts


def _gather(x: torch.Tensor, dim: int, mesh, group=None,
            n: int | None = None) -> torch.Tensor:
    """The `n` ranks' `x` of `group` (default: the "model" group)
    concatenated along `dim` in rank order."""
    import torch.distributed as dist

    group = mesh.group if group is None else group
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n or mesh.tp)]
    if not _dry(group, "all-gather", x):
        t = time.perf_counter()
        dist.all_gather(parts, x, group=group)
        _count("all-gather", x, t)
    return torch.cat(parts, dim=dim)


def _all_reduce_(y: torch.Tensor, group, op=None) -> torch.Tensor:
    """All-reduce `y` in place over `group` (sum unless `op`), counted."""
    import torch.distributed as dist

    if _dry(group, "all-reduce", y):
        return y
    t = time.perf_counter()
    dist.all_reduce(y, op=op or dist.ReduceOp.SUM, group=group)
    _count("all-reduce", y, t)
    return y


def _reduce_scatter_(x: torch.Tensor, dim: int, group, n: int
                     ) -> torch.Tensor:
    """This rank's block (of `n` in `group`) along `dim` of the sum of the
    ranks' `x`."""
    import torch.distributed as dist

    size = x.shape[dim] // n
    if _dry(group, "reduce-scatter", x):
        return torch.empty_like(x.narrow(dim, 0, size),
                                memory_format=torch.contiguous_format)
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((size, *front.shape[1:]))
    t = time.perf_counter()
    dist.reduce_scatter_tensor(out, front, group=group)
    _count("reduce-scatter", front, t)
    return out.movedim(0, dim).contiguous()


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The exchange of equal blocks of `x`'s leading axis over `group`:
    block j goes to rank j, and the output's block i is rank i's block
    for this rank (``all_to_all_single``), counted as one all-to-all of
    the whole operand."""
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    if _dry(group, "all-to-all", x):
        return out
    t = time.perf_counter()
    dist.all_to_all_single(out, x, group=group)
    _count("all-to-all", x, t)
    return out


def all_gather(x: torch.Tensor, dim: int = -1, mesh=None) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim` in rank order."""
    mesh = mesh or current_mesh()
    return torch.cat(_Pending(x, mesh).wait(), dim=dim)


def all_reduce(x: torch.Tensor, mesh=None, op=None) -> torch.Tensor:
    """The sum (or `op`: ``torch.distributed.ReduceOp.MAX``, ...) of the
    ranks' `x` over "model" (a new tensor; no gradient)."""
    mesh = mesh or current_mesh()
    return _all_reduce_(x.detach().clone(), mesh.group, op)


def all_reduce_data(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The sum of the ranks' `x` over the data-parallel axes ("pod" and
    "data"), in place and in `x`'s dtype (the gradients' reduction; `x` as
    it is on a mesh of one data rank)."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.dp == 1:
        return x
    return _all_reduce_(x, mesh.batch_group)


def all_reduce_pod(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The sum of the ranks' `x` over "pod", in place (`x` as it is on a
    mesh of one pod)."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.pod == 1:
        return x
    return _all_reduce_(x, mesh.pod_group)


def _block(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's block of `x` along `dim`, a fresh tensor."""
    n = x.shape[dim] // mesh.tp
    return x.narrow(dim, mesh.rank * n, n).contiguous()


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward: the gradient all-reduced over the
    group (in its own dtype)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitToModel(torch.autograd.Function):
    """This rank's block along `dim` forward; backward: the blocks'
    gradients all-gathered."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _block(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.mesh), None, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along `dim` forward; backward: this rank's block of the
    gradient (which is whole, and the same, on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _gather(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.mesh), None, None


class _ReduceToModel(torch.autograd.Function):
    """All-reduce over the group forward, and the gradient all-reduced
    over it backward (in its own dtype)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.group), None


class _GatherFromSequence(torch.autograd.Function):
    """All-gather along `dim` over "model" forward; backward: the ranks'
    gradients reduce-scattered along `dim` (each rank's is its share of
    the whole, partial: summed, and this rank's block kept)."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _gather(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return _reduce_scatter_(g, ctx.dim, m.group, m.tp), None, None


class _ScatterToSequence(torch.autograd.Function):
    """Reduce-scatter along `dim` over "model" forward (this rank's block
    of the ranks' sum); backward: the blocks' gradients all-gathered."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _reduce_scatter_(x, dim, mesh.group, mesh.tp)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.mesh), None, None


class _SequenceShare(torch.autograd.Function):
    """Identity forward; backward: the gradient within this rank's block
    along `dim`, zero outside it."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.mesh.tp
        lo = ctx.mesh.rank * n
        out = torch.zeros_like(g)
        out.narrow(ctx.dim, lo, n).copy_(g.narrow(ctx.dim, lo, n))
        return out, None, None


class _AllToAllData(torch.autograd.Function):
    """`_all_to_all` over "data" forward; backward: the gradient's blocks
    sent back the same way (the exchange is its own transpose)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_to_all(x, mesh.data_group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh.data_group), None


# the kinds whose blocks run under sequence parallelism (the hybrid: its
# shared block)
SP_KINDS = SP_STACK_KINDS + ("hybrid",)


def sequence_parallel(cfg, seq_len: int, kinds: tuple = SP_KINDS) -> bool:
    """Whether a call over `seq_len` positions runs under Megatron-SP:
    ``cfg.sequence_parallel`` in psum mode on more than one "model" rank,
    for a kind in `kinds` (default `SP_KINDS`, the kinds whose blocks take
    it: dense, moe, mla_moe, vlm, and the hybrid's shared block; Mamba1,
    Mamba2 and the encoder-decoder ignore the flag, as their reference
    blocks do; `SP_STACK_KINDS` where the question is whether the stack
    between the embedding and the head runs on the block, which the
    hybrid gathers at each group's edge), more than one position, and tp
    dividing them. Otherwise the call runs without it, as the reference's
    `sanitize_spec` drops the sequence's axis (decode, a prefill chunk tp
    does not divide). Every block, the stack's ends and the train step
    decide it here."""
    return (bool(getattr(cfg, "sequence_parallel", False))
            and getattr(cfg, "kind", None) in kinds
            and psum_mode(cfg) and seq_len > 1
            and seq_len % model_size() == 0)


def gather_from_sequence(x: torch.Tensor, dim: int = 1, mesh=None
                         ) -> torch.Tensor:
    """The whole sequence (the ranks' blocks along `dim` concatenated)
    before the column-parallel products; its gradient, each rank's
    partial share, is reduce-scattered back to this rank's block. The
    dense MoE gathers its experts' outputs on E the same way under SP."""
    return _GatherFromSequence.apply(x, dim, mesh or current_mesh())


def scatter_to_sequence(x: torch.Tensor, dim: int = 1, mesh=None
                        ) -> torch.Tensor:
    """This rank's block along `dim` of the ranks' sum of `x` (a
    row-parallel product's partial sums, reduce-scattered in `x`'s
    dtype); its gradient is all-gathered."""
    return _ScatterToSequence.apply(x, dim, mesh or current_mesh())


def sequence_block(x: torch.Tensor, dim: int = 1, mesh=None
                   ) -> torch.Tensor:
    """This rank's block of `x` along `dim` with no collective (`x` whole
    on every rank); its gradient is zero outside the block."""
    mesh = mesh or current_mesh()
    n = x.shape[dim] // mesh.tp
    return x.narrow(dim, mesh.rank * n, n)


def sequence_share(x: torch.Tensor, dim: int = 1, mesh=None
                   ) -> torch.Tensor:
    """`x` as it is (whole, the same on every rank); its gradient passes
    only within this rank's block along `dim` (`_SequenceShare`), so a
    leaf that every rank uses whole on the whole sequence gets each
    rank's share, summed over "model" by the train step."""
    return _SequenceShare.apply(x, dim, mesh or current_mesh())


def all_to_all_data(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The exchange over "data" of the equal blocks of `x`'s leading axis
    (block j to data rank j; the output's block i from data rank i):
    the dispatch of tokens to the ranks holding their experts, and back.
    Its gradient goes back the same way. `x` as it is on a mesh of one
    data rank."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.data == 1:
        return x
    return _AllToAllData.apply(x, mesh)


def copy_to_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """`x` as it is; its gradient is summed over "model"."""
    mesh = mesh or current_mesh()
    return _CopyToModel.apply(x, mesh.group)


def reduce_from_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The sum of the ranks' `x` over "model"; its gradient passes as it
    is."""
    mesh = mesh or current_mesh()
    return _ReduceFromModel.apply(x, mesh.group)


def reduce_to_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The sum of the ranks' partial `x` over "model", a whole tensor that
    each rank then uses only in part: its gradient, each rank's share, is
    summed over "model" too."""
    mesh = mesh or current_mesh()
    return _ReduceToModel.apply(x, mesh.group)


def sum_over_model(grads: dict, names, mesh=None) -> None:
    """Sum over "model", in place, the gradients of the leaves `names`
    (each rank's share: the leaves "model" does not cut, used under
    sequence parallelism), one all-reduce per dtype of them all packed."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.tp == 1 or not names:
        return
    views: dict = {}
    for name in sorted(names):
        views.setdefault(grads[name].dtype, []).append(grads[name])
    for group in views.values():
        flat = _all_reduce_(torch.cat([v.reshape(-1) for v in group]),
                            mesh.group)
        for v, part in zip(group, flat.split([v.numel() for v in group])):
            v.copy_(part.view(v.shape))


def sum_whole_parts(grads: dict, parts: dict, mesh=None) -> None:
    """Sum over "model", in place, each gradient's slices of the parts
    its leaf holds whole: `parts` is {name: (axis, parts at a rank's
    sizes)} (`sharding.TrainLayout.whole_parts`). A rank's gradient of
    such a part is its heads' share (Mamba2's B and C, which every head
    reads); the sums are one all-reduce per dtype of all the slices
    packed, equal on every rank."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.tp == 1 or not parts:
        return
    views: dict = {}
    for name, (axis, local) in parts.items():
        g = grads[name]
        for lo, size in whole_spans(local):
            views.setdefault(g.dtype, []).append(g.narrow(axis, lo, size))
    for group in views.values():
        flat = _all_reduce_(torch.cat([v.reshape(-1) for v in group]),
                            mesh.group)
        for v, part in zip(group, flat.split([v.numel() for v in group])):
            v.copy_(part.view(v.shape))


def split_to_model(x: torch.Tensor, dim: int, mesh=None) -> torch.Tensor:
    """This rank's block of `x` along `dim`; its gradient is gathered."""
    return _SplitToModel.apply(x, dim, mesh or current_mesh())


def gather_from_model(x: torch.Tensor, dim: int, mesh=None
                      ) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim`; its gradient is this
    rank's block."""
    return _GatherFromModel.apply(x, dim, mesh or current_mesh())


def reduce_over_data(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The sum of the ranks' `x` over the data-parallel axes (its gradient
    passes as it is; `x` as it is on a mesh of one data rank)."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.dp == 1:
        return x
    return _ReduceFromModel.apply(x, mesh.batch_group)


def data_size(mesh=None) -> int:
    """The ranks over the data-parallel axes of `mesh` (default: the
    current mesh); 1 without one."""
    mesh = mesh if mesh is not None else current_mesh()
    return 1 if mesh is None else int(mesh.dp)


class _GatherFromData(torch.autograd.Function):
    """FSDP's use of a leaf cut over "data": all-gather along `dim`
    forward; backward, the gradient reduce-scattered over "data" (each
    data rank's share of the whole leaf's gradient summed, this rank's
    block kept)."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _gather(x, dim, mesh, mesh.data_group, mesh.data)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return (_reduce_scatter_(g, ctx.dim, m.data_group, m.data),
                None, None)


def gather_from_data(x: torch.Tensor, dim: int, mesh=None) -> torch.Tensor:
    """The whole of a leaf cut over "data" along `dim` (FSDP): its
    gradient is reduce-scattered back to this rank's block."""
    mesh = mesh or current_mesh()
    if _differentiable(x):
        return _GatherFromData.apply(x, dim, mesh)
    return _gather(x, dim, mesh, mesh.data_group, mesh.data)


def _differentiable(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def column_parallel(x: torch.Tensor, w: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """x: (..., K) whole, as it enters the block (`enter`: in psum mode
    its gradient is summed over "model" there); w: (K, N/tp) this rank's
    columns of a (K, n) projection. Returns this rank's (..., N/tp)
    columns, each summed as the whole product sums it."""
    return ops.matmul(x, w, segments_n=n)


def row_parallel_gather(x: torch.Tensor, w: torch.Tensor, n: int,
                        chunks: int = 1, mesh=None) -> torch.Tensor:
    """x: (..., K) whole, or (..., K/tp) sharded on its last axis (then
    all-gathered first); w: (K, n/tp) this rank's columns. Returns the
    whole (..., n) product, bit-identical to the unsharded one: each of
    the `_n_chunks` column chunks is one full-contraction product whose
    gather is posted while the next chunk's product runs, and the gathered
    columns are restored to shard-major order. Differentiable (the
    reference's `_row_gather_bwd`: dx summed over "model", then this
    rank's block; dW this rank's columns), with the same forward bits and
    collectives."""
    mesh = mesh or current_mesh()
    tp = mesh.tp
    n_loc = w.shape[-1]
    c = _n_chunks(n_loc, chunks)
    width = n_loc // c
    if _differentiable(x, w):
        if x.shape[-1] != w.shape[0]:
            x = gather_from_model(x, -1, mesh)
        x = copy_to_model(x, mesh)
        outs = [gather_from_model(ops.matmul(
            x, w[:, i * width:(i + 1) * width], segments_n=n), -1, mesh)
            for i in range(c)]
        return torch.cat([outs[i][..., j * width:(j + 1) * width]
                          for j in range(tp) for i in range(c)], dim=-1)
    if x.shape[-1] != w.shape[0]:
        x = all_gather(x, -1, mesh)
    posted = [_Pending(ops.matmul(x, w[:, i * width:(i + 1) * width],
                                  segments_n=n), mesh)
              for i in range(c)]
    parts = [p.wait() for p in posted]          # parts[chunk][rank]
    # the gathered chunk i holds columns [rank j, chunk i]; the unsharded
    # product's order is rank-major, then chunk
    return torch.cat([parts[i][j] for j in range(tp) for i in range(c)],
                     dim=-1)


def row_parallel(x: torch.Tensor, w: torch.Tensor, chunks: int = 1,
                 mesh=None) -> torch.Tensor:
    """x: (..., K/tp) sharded on its last axis; w: (K/tp, N) this rank's
    rows. Returns the (..., N) all-reduced sum, chunk by chunk, each cast
    to x's dtype before the wire (psum mode: the sum across ranks
    re-associates the fp32 accumulation, so the bits may differ from the
    unsharded product's). Differentiable: the reference's `_row_bwd`, no
    collective (the cotangent is whole on every rank)."""
    mesh = mesh or current_mesh()
    c = _n_chunks(w.shape[-1], chunks)
    width = w.shape[-1] // c
    return torch.cat([reduce_from_model(ops.matmul(
        x, w[:, i * width:(i + 1) * width]), mesh) for i in range(c)],
        dim=-1)


def tp_enabled(cfg) -> bool:
    """Whether `cfg` asks for explicit collectives and a mesh of more than
    one rank is current."""
    return (getattr(cfg, "tp_collectives", "auto") == "explicit"
            and model_size() > 1)


def psum_mode(cfg) -> bool:
    """Tensor parallelism in psum mode (training): row-parallel products
    all-reduce their partial sums, and blocks `enter` through a copy."""
    return tp_enabled(cfg) and getattr(cfg, "tp_reduce", "psum") != "gather"


def enter(x: torch.Tensor, cfg, w: torch.Tensor, n: int,
          sp: bool = False) -> torch.Tensor:
    """`x` as it enters a column-parallel block whose first projection is
    `w` of whole width `n`: in psum mode, where `w` is sharded, through
    `copy_to_model` (each rank's gradient of it is partial: its columns'
    share); `x` itself otherwise (gather mode, one rank, a block tp does
    not divide, which every rank computes whole, or under `sp`, where
    `gather_from_sequence`'s backward sums the shares)."""
    if psum_mode(cfg) and not sp and w.shape[-1] != n:
        return copy_to_model(x)
    return x


def replicate(x: torch.Tensor, dim: int, cfg) -> torch.Tensor:
    """`x` whole along `dim`: all-gathered where `x` holds this rank's
    block of it under tensor parallelism, else `x` as it is. (The
    reference's `replicate` constrains a GSPMD sharding; here a tensor is
    local, so the caller names the axis its shard lies on.)"""
    if not tp_enabled(cfg):
        return x
    if _differentiable(x):
        return gather_from_model(x, dim)
    return all_gather(x, dim)


def replicate_for_parity(x: torch.Tensor, dim: int, cfg) -> torch.Tensor:
    """`replicate` only in gather mode: an activation headed into a
    contraction or reduction over its sharded axis is made whole first, so
    the sum runs in the unsharded order (psum mode keeps the shard)."""
    if getattr(cfg, "tp_reduce", "psum") == "gather":
        return replicate(x, dim, cfg)
    return x


def tp_column(x: torch.Tensor, w: torch.Tensor, cfg, n: int
              ) -> torch.Tensor:
    """A column-parallel projection of whole width `n`: this rank's
    columns of ``x @ w`` where `w` is sharded (narrower than `n`; in psum
    mode `x` came through `enter`), the plain product where it is whole
    (one rank, or a width tp does not divide)."""
    if tp_enabled(cfg) and w.shape[-1] != n:
        return column_parallel(x, w, n)
    return ops.matmul(x, w)


def tp_row(x: torch.Tensor, w: torch.Tensor, cfg, n: int,
           k: int | None = None, sp: bool = False) -> torch.Tensor:
    """The projection that closes a sharded block, of whole output width
    `n` and whole contraction width `k`, whole on every rank: gather
    mode's `row_parallel_gather` where `w` is column-sharded, psum mode's
    `row_parallel` where `w` holds fewer than `k` rows (`x` this rank's
    block of the contraction), else the plain product of the all-gathered
    input. Under `sp` (`x` over the whole sequence) the result is this
    rank's block of the sequence: the row-parallel sum reduce-scattered
    (`scatter_to_sequence`), a whole product cut (`sequence_block`)."""
    if not tp_enabled(cfg):
        return ops.matmul(x, w)
    chunks = max(int(getattr(cfg, "tp_overlap_chunks", 1)), 1)
    if getattr(cfg, "tp_reduce", "psum") == "gather":
        if w.shape[-1] != n:
            return row_parallel_gather(x, w, n, chunks)
    elif k is not None and w.shape[0] != k:
        if sp:
            return scatter_to_sequence(ops.matmul(x, w))
        return row_parallel(x, w, chunks)
    if x.shape[-1] != w.shape[0]:
        x = replicate(x, -1, cfg)
    y = ops.matmul(x, w)
    return sequence_block(y) if sp else y


class _OwnedRows(torch.autograd.Function):
    """The vocab-sharded embedding's lookup: forward, every rank's rows
    (the others zeroed) all-gathered and each token's owner picked (rows
    copied, never summed: the whole table's bits); backward, the gradient
    of this rank's rows is the cotangent of the tokens it owns (zero
    elsewhere), with no collective: the cotangent is whole on every
    rank."""

    @staticmethod
    def forward(ctx, local, owner, mesh):
        ctx.save_for_backward(owner)
        ctx.rank = mesh.rank
        parts = torch.stack(_Pending(local, mesh).wait())
        idx = owner[None, ..., None].expand(1, *local.shape)
        return parts.gather(0, idx)[0]

    @staticmethod
    def backward(ctx, g):
        owner, = ctx.saved_tensors
        mine = (owner == ctx.rank)[..., None]
        return torch.where(mine, g, torch.zeros_like(g)), None, None


class _TakeRows(torch.autograd.Function):
    """``table[idx]`` whose backward sums each row's cotangents in f32 and
    rounds the sum once to the table's dtype. Indexing's own backward adds
    a repeated row's cotangents in the table's dtype one at a time: in
    bf16 a token repeated across a batch (the Zipf-drawn training data's
    frequent ones) loses the small addends: the embedding's gradient of
    qwen2.5-14b (2 layers, 4 x 512 tokens) read 1.9% low in norm against
    f32 on an H100 (``tools/grad_gap.py``). The rows are sorted and summed by segment
    (fixed shapes, so the dry-run's meta tensors take it too)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        flat = idx.reshape(-1).long()
        g = g.reshape(flat.numel(), *ctx.shape[1:])
        rows, order = torch.sort(flat)
        new = torch.ones_like(rows, dtype=torch.bool)
        new[1:] = rows[1:] != rows[:-1]
        seg = torch.cumsum(new, 0) - 1
        sums = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        sums.index_put_((seg,), g[order].float(), accumulate=True)
        # each segment's row; a segment past the last holds a zero sum
        row_of = torch.zeros_like(rows).scatter_(0, seg, rows)
        out = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        out.index_put_((row_of,), sums.to(g.dtype), accumulate=True)
        return out, None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``; where autograd records, with the backward of
    `_TakeRows` (each row's cotangents summed in f32)."""
    if _differentiable(table):
        return _TakeRows.apply(table, idx)
    return table[idx]


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, vocab: int
                 ) -> torch.Tensor:
    """Rows `tokens` of an embedding table of `vocab` rows: this rank
    holds rows [rank V/tp, (rank + 1) V/tp) (or all of them). A sharded
    lookup takes each rank's rows with the others zeroed, all-gathers the
    ranks' results and picks each token's owner: rows are copied, never
    summed, so the result is the whole table's bit for bit. Its backward
    (`_OwnedRows`) gives each rank's rows the cotangent of its tokens."""
    rows = table.shape[0]
    if rows == vocab:
        return take_rows(table, tokens)
    mesh = current_mesh()
    tok = tokens.long()
    lo = mesh.rank * rows
    mine = (tok >= lo) & (tok < lo + rows)
    local = take_rows(table, (tok - lo).clamp(0, rows - 1))
    local = torch.where(mine[..., None], local, torch.zeros_like(local))
    owner = torch.div(tok, rows, rounding_mode="floor")
    return _OwnedRows.apply(local, owner, mesh)


def unembed(x: torch.Tensor, w: torch.Tensor, vocab: int, *,
            transpose_b: bool = False) -> torch.Tensor:
    """f32 logits of a head over `vocab` columns: ``w`` (d, V), or the
    tied table (V, d) with `transpose_b`, whole or this rank's vocab
    shard. A sharded head computes its columns (K segments of the whole
    head) and all-gathers them, so every rank samples from the same
    bits."""
    cols = w.shape[0] if transpose_b else w.shape[-1]
    if cols == vocab:
        return ops.matmul(x, w, transpose_b=transpose_b,
                          out_dtype=torch.float32)
    return all_gather(ops.matmul(x, w, transpose_b=transpose_b,
                                 out_dtype=torch.float32, segments_n=vocab))
