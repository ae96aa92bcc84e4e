"""What one step costs, counted op by op as it runs: the port's counterpart
of the JAX package's `repro.core.hloanalyze`, which reads the optimized
HLO of a compiled step. Torch has no HLO; the port runs eager, so its
program is the sequence of aten ops one call of the step dispatches, and
`analyze_step` watches them with a `TorchDispatchMode`. Run on meta
tensors (the dry-run) it costs no device memory and computes nothing.

    cost = analyze_step(step, state, batch)
    cost.flops, cost.hbm_bytes, cost.gemms["wgmma"].launches

* FLOPs: dot FLOPs only, as `analyze_hlo` counts them: ``mm``, ``addmm``,
  ``bmm`` and ``baddbmm`` (einsum's products, the attention's among them,
  reach these) and the hand-written GEMM's launches
  (`kernels.tiled_matmul`'s meta records, 2MNK each).
* HBM bytes: the port's own traffic. Each aten op that launches a kernel
  reads its inputs and writes its outputs once (a broadcast input counts
  the elements it holds). Views, reshapes, allocations and metadata ops
  are free. ``copy_`` reads its source and writes its destination (an
  in-place slice write, the KV cache update, charges only the slice); a
  gather (``index``, ``gather``, ``index_select``) reads and writes what
  it gathers and its indices; an index write (``index_put``,
  ``index_add_``, ``scatter_add``) reads its values and indices and
  writes (adding: reads and writes) as many elements. The hand-written
  kernels' records are priced here, once (`launch_cost`): a `tiled_matmul`
  launch charges A + B (+ C) + out (the split pair's f32 operand as the
  three bf16 planes it reads), a `split3` launch its f32 matrix and the
  three planes it writes.
* Collectives: every collective the step posts on a dry mesh
  (`launch.mesh.make_production_mesh`; `distributed.tp` logs each one's
  op, operand bytes and group size instead of posting it), per chip:
  calls and operand bytes by op, and wire bytes by the reference's ring
  model (`hloanalyze._collective_wire`, copied in `collective_wire`): an
  all-reduce 2 x operand x (g-1)/g, an all-gather operand x (g-1), a
  reduce-scatter operand x (g-1)/g (its operand the whole input). A step
  on one card, or on real ranks, counts none here (real ranks count
  what they post in `tp.collectives`).
* Memory, in place of XLA's ``memory_analysis``: the bytes of the
  arguments' and the outputs' distinct storages, and a peak-live
  estimate: the arguments plus the most bytes of storages made during the
  call alive at once (each freed when its last tensor dies; autograd's
  saved tensors hold theirs).

`analyze_hlo`'s ``while_trips`` has no counterpart: the port's loops are
Python loops, and each pass dispatches its ops again, so every op is
counted as often as it runs (``n_ops``).

On a CUDA or CPU step it counts the same way (the aten ops and their
shapes), but a CPU step's GEMMs are the plain version's ``mm`` and a CUDA
step's launches leave no record: only meta steps see the hand-written
GEMM's paths.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import tp as TP
from repro_torch.kernels.tiled_matmul import (HBM_BYTES_PER_S,
                                              PEAK_BF16_FLOPS, MetaLaunch,
                                              record_meta)

aten = torch.ops.aten
# the H100 SXM's dense f32 rate outside the tensor cores (NVIDIA data
# sheet): the rate of an f32 x f32 product on the `general` path
PEAK_F32_FLOPS = 67e12

# the dot ops whose FLOPs count, with `torch.utils.flop_counter`'s formulas
# (einsum's products and the port's attention reach them)
_DOTS = {p: flop_registry[p]
         for p in (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)}

# the port's ops that launch nothing: allocations and metadata (views are
# found by their schema, `OpOverload.is_view`)
_FREE = {aten.empty, aten.empty_like, aten.detach, aten.alias,
         aten._unsafe_view}
_GATHERS = {aten.index, aten.gather, aten.index_select}
# index writes: (position of the written values, whether they are added)
_INDEX_WRITES = {aten.index_put_: (2, "accumulate"),
                 aten.index_put: (2, "accumulate"),
                 aten.index_add_: (3, True), aten.scatter_add: (3, True)}


def gemm_bytes(m: int, n: int, k: int, *, a_dtype, b_dtype, out_dtype,
               c: bool = False) -> int:
    """The bytes one (m, n, k) GEMM moves: A and B read once, the output
    written once (and C read, where `c`, in the output's dtype). In a
    mixed f32 x bf16 pair (the split pair) the card reads the f32 operand
    as its three bf16 planes: 6 bytes an element."""
    def size(dt) -> int:
        return 6 if a_dtype != b_dtype and dt == torch.float32 else (
            dt.itemsize)

    out = m * n * out_dtype.itemsize
    return (m * k * size(a_dtype) + k * n * size(b_dtype) + out
            + (out if c else 0))


def gemm_bound_s(m: int, n: int, k: int, *, a_dtype, b_dtype, out_dtype,
                 c: bool = False) -> tuple[float, float]:
    """(operations time, bytes time) of one (m, n, k) GEMM at the card's
    peaks: 2MNK over the tensor-core rate where an operand is bf16 (the
    split pair too: 2MNK at the bf16 rate is the floor of any f32-accurate
    product on the card), else the f32 rate; `gemm_bytes` over the HBM
    rate. The GEMM's bound is the larger of the two."""
    bf16 = torch.bfloat16 in (a_dtype, b_dtype)
    ops_s = 2.0 * m * n * k / (PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)
    nbytes = gemm_bytes(m, n, k, a_dtype=a_dtype, b_dtype=b_dtype,
                        out_dtype=out_dtype, c=c)
    return ops_s, nbytes / HBM_BYTES_PER_S


def launch_cost(rec: MetaLaunch) -> tuple[float, int, float]:
    """(dot FLOPs, bytes, bound in seconds) of one recorded launch: a GEMM
    2MNK, `gemm_bytes` and the larger of `gemm_bound_s`'s times; a split3
    no FLOPs, its f32 matrix read and three bf16 planes written."""
    if rec.path == "split3":
        nbytes = rec.m * rec.n * (4 + 3 * 2)
        return 0.0, nbytes, nbytes / HBM_BYTES_PER_S
    dt = dict(a_dtype=rec.a_dtype, b_dtype=rec.b_dtype,
              out_dtype=rec.out_dtype, c=rec.c)
    return (2.0 * rec.m * rec.n * rec.k,
            gemm_bytes(rec.m, rec.n, rec.k, **dt),
            max(gemm_bound_s(rec.m, rec.n, rec.k, **dt)))


def collective_wire(op: str, operand: float, group: int) -> float:
    """Wire bytes per chip of one collective of `operand` bytes over a
    group of `group` ranks: the reference's ring model
    (`repro.core.hloanalyze._collective_wire`)."""
    g = group
    ring = (g - 1) / g if g > 1 else 0.0
    if op == "all-reduce":
        return 2.0 * operand * ring
    if op == "all-gather":
        return operand * (g - 1)
    if op == "reduce-scatter":
        return operand * ring
    if op == "all-to-all":
        return operand * ring
    return operand  # collective-permute


def _touched(t: torch.Tensor) -> int:
    """The bytes of the elements `t` holds: a broadcast (stride 0) axis
    counts once."""
    if t.numel() == 0:
        return 0
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    """Every tensor in `tree`: nested dicts, lists and tuples, and modules
    (their parameters and buffers)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _storage_bytes(tensors) -> tuple[dict, int]:
    """({storage key: bytes}, their sum) over the distinct storages."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen.setdefault(st._cdata, st.nbytes())
    return seen, sum(seen.values())


@dataclasses.dataclass
class GemmTally:
    """One kernel path's meta launches in a step: how many, their dot
    FLOPs and bytes, and the sum of each launch's bound (the larger of its
    operations and bytes times, `gemm_bound_s`)."""

    launches: int = 0
    flops: float = 0.0
    bytes: float = 0.0
    bound_s: float = 0.0


@dataclasses.dataclass
class StepCost:
    """One step's cost (`analyze_step`). ``flops``, ``hbm_bytes``,
    ``collective_bytes`` and ``collective_by_op`` (wire bytes per chip)
    are `HloCost`'s fields; ``collective_calls`` and
    ``collective_operand_bytes`` count the collectives by op, and
    ``collective_log`` lists each as `tp.record_collectives` logs it;
    ``gemm_flops`` is the hand-written GEMM's share of ``flops`` and
    ``gemms`` its launches by path ("stream", "wgmma", "split",
    "general", and "split3" for the split kernel)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_op: dict = dataclasses.field(default_factory=dict)
    collective_calls: dict = dataclasses.field(default_factory=dict)
    collective_operand_bytes: dict = dataclasses.field(default_factory=dict)
    collective_log: list = dataclasses.field(default_factory=list)
    gemm_flops: float = 0.0
    gemms: dict = dataclasses.field(default_factory=dict)
    n_ops: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_live_bytes: int = 0


class _Counter(TorchDispatchMode):
    """Counts every aten op dispatched inside it into a `StepCost`."""

    def __init__(self, cost: StepCost, known: dict):
        super().__init__()
        self.cost = cost
        self.known = dict(known)   # argument storages: never temporaries
        self.made: dict = {}       # storages made here and alive: bytes
        self.live = 0

    def _track(self, out) -> None:
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known or key in self.made:
                continue
            self.made[key] = st.nbytes()
            self.live += self.made[key]
            self.cost.peak_live_bytes = max(self.cost.peak_live_bytes,
                                            self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self.made.pop(key, 0)

    def _bytes(self, packet, args, kwargs, out) -> int:
        if packet is aten.copy_:
            return _touched(args[0]) + _touched(args[1])
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if packet in _GATHERS:
            idx = sum(_touched(t) for t in ins[1:]
                      if not t.is_floating_point())
            return 2 * sum(_touched(t) for t in outs) + idx
        if packet in _INDEX_WRITES:
            pos, add = _INDEX_WRITES[packet]
            if isinstance(add, str):
                add = bool(kwargs.get(add, args[3] if len(args) > 3
                                      else False))
            vals = args[pos]
            idx = sum(_touched(t) for t in tree_flatten(args[1:pos])[0]
                      if isinstance(t, torch.Tensor))
            return _touched(vals) * (3 if add else 2) + idx
        uniq = {id(t): t for t in ins}
        return (sum(_touched(t) for t in uniq.values())
                + sum(_touched(t) for t in outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        self._track(out)
        if func.is_view or packet in _FREE:
            return out
        cost = self.cost
        cost.n_ops += 1
        if packet in _DOTS:
            cost.flops += float(_DOTS[packet](*args, **kwargs, out_val=out))
        cost.hbm_bytes += self._bytes(packet, args, kwargs, out)
        return out


def analyze_step(fn, *args, **kwargs) -> StepCost:
    """Run ``fn(*args, **kwargs)`` once, counting its aten ops and the
    hand-written kernels' meta records into a `StepCost` (the module
    docstring says what is counted)."""
    cost = StepCost()
    known, cost.argument_bytes = _storage_bytes(_tensors((args, kwargs)))
    mode = _Counter(cost, known)
    with record_meta() as log, TP.record_collectives() as posted, mode:
        out = fn(*args, **kwargs)
    _, cost.output_bytes = _storage_bytes(_tensors(out))
    cost.peak_live_bytes += cost.argument_bytes
    del out
    for rec in log:
        flops, nbytes, bound_s = launch_cost(rec)
        g = cost.gemms.setdefault(rec.path, GemmTally())
        g.launches += 1
        g.flops += flops
        g.bytes += nbytes
        g.bound_s += bound_s
        cost.gemm_flops += flops
        cost.hbm_bytes += nbytes
    cost.flops += cost.gemm_flops
    cost.collective_log = list(posted)
    for op, nbytes, group, *_ in posted:
        wire = collective_wire(op, nbytes, group)
        cost.collective_calls[op] = cost.collective_calls.get(op, 0) + 1
        cost.collective_operand_bytes[op] = (
            cost.collective_operand_bytes.get(op, 0) + nbytes)
        cost.collective_by_op[op] = cost.collective_by_op.get(op, 0.0) + wire
        cost.collective_bytes += wire
    return cost
