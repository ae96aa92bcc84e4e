"""Explicit-collective tensor-parallel layers over `torch.distributed`.

The forward of the JAX package's `repro.distributed.tp` in PyTorch's SPMD
idiom: every rank runs this code on its own shards (`distributed.sharding`)
and the collectives are written out. The residual stream, the norms and
every activation between blocks are whole on every rank; what is sharded
is a projection's output columns and the attention heads behind them.

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
chunks: chunk c's collective is posted (``async_op=True``) before chunk
c+1's product is launched, so the wire overlaps the GEMM; the columns are
then put back in the unsharded product's order (shard-major).

Every collective goes through `_Pending` or `all_reduce`, which count it
and the host time spent posting and waiting for it (`collectives`). With
gloo, a CUDA tensor is staged through host memory inside the collective:
the transport of several ranks on one card (NCCL refuses two ranks on one
device).

The backward (training under tp) is not ported yet (ROADMAP A7).
"""

from __future__ import annotations

import time
import types

import torch

from repro_torch.distributed.sharding import current_mesh, model_size
from repro_torch.kernels import ops


# the collectives this process posted and the host seconds spent posting
# and waiting for them (set both to 0 before a run to read its own)
collectives = types.SimpleNamespace(calls=0, host_s=0.0)


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
        t = time.perf_counter()
        self.work = dist.all_gather(self.parts, x, group=mesh.group,
                                    async_op=True)
        collectives.calls += 1
        collectives.host_s += time.perf_counter() - t

    def wait(self) -> list[torch.Tensor]:
        t = time.perf_counter()
        self.work.wait()
        collectives.host_s += time.perf_counter() - t
        return self.parts


def all_gather(x: torch.Tensor, dim: int = -1, mesh=None) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim` in rank order."""
    mesh = mesh or current_mesh()
    return torch.cat(_Pending(x, mesh).wait(), dim=dim)


def all_reduce(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The sum of the ranks' `x` (a new tensor)."""
    import torch.distributed as dist

    mesh = mesh or current_mesh()
    y = x.clone()
    t = time.perf_counter()
    dist.all_reduce(y, group=mesh.group)
    collectives.calls += 1
    collectives.host_s += time.perf_counter() - t
    return y


def column_parallel(x: torch.Tensor, w: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """x: (..., K) whole; w: (K, N/tp) this rank's columns of a (K, n)
    projection. Returns this rank's (..., N/tp) columns, each summed as
    the whole product sums it."""
    return ops.matmul(x, w, segments_n=n)


def row_parallel_gather(x: torch.Tensor, w: torch.Tensor, n: int,
                        chunks: int = 1, mesh=None) -> torch.Tensor:
    """x: (..., K) whole, or (..., K/tp) sharded on its last axis (then
    all-gathered first); w: (K, n/tp) this rank's columns. Returns the
    whole (..., n) product, bit-identical to the unsharded one: each of
    the `_n_chunks` column chunks is one full-contraction product whose
    gather is posted while the next chunk's product runs, and the gathered
    columns are restored to shard-major order."""
    mesh = mesh or current_mesh()
    tp = mesh.tp
    if x.shape[-1] != w.shape[0]:
        x = all_gather(x, -1, mesh)
    n_loc = w.shape[-1]
    c = _n_chunks(n_loc, chunks)
    width = n_loc // c
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
    rows. Returns the (..., N) all-reduced sum, chunk by chunk (psum mode:
    the sum across ranks re-associates the fp32 accumulation, so the bits
    may differ from the unsharded product's)."""
    mesh = mesh or current_mesh()
    c = _n_chunks(w.shape[-1], chunks)
    width = w.shape[-1] // c
    return torch.cat([all_reduce(ops.matmul(
        x, w[:, i * width:(i + 1) * width]), mesh) for i in range(c)],
        dim=-1)


def tp_enabled(cfg) -> bool:
    """Whether `cfg` asks for explicit collectives and a mesh of more than
    one rank is current."""
    return (getattr(cfg, "tp_collectives", "auto") == "explicit"
            and model_size() > 1)


def replicate(x: torch.Tensor, dim: int, cfg) -> torch.Tensor:
    """`x` whole along `dim`: all-gathered where `x` holds this rank's
    block of it under tensor parallelism, else `x` as it is. (The
    reference's `replicate` constrains a GSPMD sharding; here a tensor is
    local, so the caller names the axis its shard lies on.)"""
    return all_gather(x, dim) if tp_enabled(cfg) else x


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
    columns of ``x @ w`` where `w` is sharded (narrower than `n`), the
    plain product where it is whole (one rank, or a width tp does not
    divide)."""
    if tp_enabled(cfg) and w.shape[-1] != n:
        return column_parallel(x, w, n)
    return ops.matmul(x, w)


def tp_row(x: torch.Tensor, w: torch.Tensor, cfg, n: int) -> torch.Tensor:
    """The projection that closes a sharded block, of whole output width
    `n`, whole on every rank: gather mode's `row_parallel_gather` where `w`
    is column-sharded, else the plain product of the all-gathered input.
    psum mode (training under tp, whose row-sharded weights take
    `row_parallel`) waits for the training slice (ROADMAP A7)."""
    if not tp_enabled(cfg):
        return ops.matmul(x, w)
    if getattr(cfg, "tp_reduce", "psum") != "gather":
        raise NotImplementedError(
            "tensor-parallel psum mode (training) is ROADMAP A7; serving "
            "runs tp_reduce='gather'")
    if w.shape[-1] != n:
        chunks = max(int(getattr(cfg, "tp_overlap_chunks", 1)), 1)
        return row_parallel_gather(x, w, n, chunks)
    if x.shape[-1] != w.shape[0]:
        x = all_gather(x, -1)
    return ops.matmul(x, w)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, vocab: int
                 ) -> torch.Tensor:
    """Rows `tokens` of an embedding table of `vocab` rows: this rank
    holds rows [rank V/tp, (rank + 1) V/tp) (or all of them). A sharded
    lookup takes each rank's rows with the others zeroed, all-gathers the
    ranks' results and picks each token's owner: rows are copied, never
    summed, so the result is the whole table's bit for bit."""
    rows = table.shape[0]
    if rows == vocab:
        return table[tokens]
    mesh = current_mesh()
    tok = tokens.long()
    lo = mesh.rank * rows
    mine = (tok >= lo) & (tok < lo + rows)
    local = table[(tok - lo).clamp(0, rows - 1)]
    local = torch.where(mine[..., None], local, torch.zeros_like(local))
    parts = torch.stack(_Pending(local, mesh).wait())
    owner = torch.div(tok, rows, rounding_mode="floor")
    idx = owner[None, ..., None].expand(1, *local.shape)
    return parts.gather(0, idx)[0]


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
