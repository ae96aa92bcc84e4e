"""Meshes and the rank processes that hold them.

The counterpart of the JAX package's `repro.launch.mesh` in PyTorch's SPMD
idiom: one process per rank, each with a `torch.distributed` process group,
instead of one process driving several devices. A `Mesh` is this rank's
place on the ("data", "model") axes and a process group along each: the
"model" group (its row: the ranks that hold the shards of one copy of the
weights) and the "data" group (its column: the ranks that hold the same
shard and see other rows of the batch). A serving mesh is (1, tp): the
batch stays whole on every rank (decode-slot surgery stays local) and the
`tp` ranks of the group are the "model" axis; training takes (data, tp)
(`make_host_mesh`).

`RankPool` starts ``data x tp`` rank processes (``spawn``) under a
`FileStore` and runs functions in all of them at once. The backend is the caller's:
"gloo" on the CPU, and also for several ranks on one card (gloo carries
CUDA tensors, staged through host memory inside its collectives; NCCL
refuses two ranks on one device); "nccl" is what a deployment with one
card per rank passes, and no test or script of the repository runs it. A
rank's device is its function's business: the entry points take
``device=``.

`make_production_mesh` is the reference's dry-run mesh, (16, 16) over
("data", "model") or (2, 16, 16) over ("pod", "data", "model"), as one
rank sees it: a *dry* `Mesh` at rank (0, ..., 0) whose groups are
`DryGroup` sentinels naming an axis and its size. It makes no
`torch.distributed` call; `distributed.tp` records each collective posted
on a dry group (op, operand bytes, group size) and makes its output's
meta tensor instead (`core.opanalyze.analyze_step` counts them). The
batch and the gradients go over `dp_axes` ("pod" and "data"); FSDP and
ZeRO-1 cut over "data" alone, as the reference's rules do.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import tempfile
import time
import traceback

AXIS_NAMES = ("data", "model")
POD_AXIS_NAMES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class DryGroup:
    """The group along `axis` of a dry mesh: `size` ranks that no process
    holds (`distributed.tp` records what is posted on it)."""

    axis: str
    size: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, tp) or (pod, data, tp) mesh: the "model" `group` (None:
    the default group, or no group at all when the axis has one rank),
    this process's `rank` on the "model" axis, the axis sizes, the "data"
    axis's `data_group` and this process's `data_rank` on it, and the
    "pod" axis's. `dp_group` spans "pod" and "data" (the batch's axes,
    `dp_axes`); on a mesh without pods it is the "data" group."""

    group: object
    rank: int
    tp: int
    data: int = 1
    axis_names: tuple[str, ...] = AXIS_NAMES
    data_group: object = None
    data_rank: int = 0
    pod: int = 1
    pod_group: object = None
    pod_rank: int = 0
    dp_group: object = None

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, as a JAX mesh's ``shape``."""
        sizes = {"pod": self.pod, "data": self.data, "model": self.tp}
        return {a: sizes[a] for a in self.axis_names}

    @property
    def size(self) -> int:
        """The ranks of the mesh."""
        return self.pod * self.data * self.tp

    @property
    def dp(self) -> int:
        """The ranks over `dp_axes`: the batch's and the gradients'."""
        return self.pod * self.data

    @property
    def dp_rank(self) -> int:
        """This rank's place over `dp_axes` (pod-major)."""
        return self.pod_rank * self.data + self.data_rank

    @property
    def batch_group(self):
        """The group over `dp_axes`."""
        return self.data_group if self.pod == 1 else self.dp_group


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of `mesh`: "pod" and "data" where present
    (the reference's `dp_axes`)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_dry_mesh(shape: tuple[int, ...]) -> Mesh:
    """The dry mesh of `shape`, (data, model) or (pod, data, model), at
    rank (0, ..., 0): no process group, no `torch.distributed` call."""
    if len(shape) not in (2, 3):
        raise ValueError(f"a dry mesh is 2-D or 3-D, not {shape}")
    names = AXIS_NAMES if len(shape) == 2 else POD_AXIS_NAMES
    sizes = dict(zip(names, (int(n) for n in shape)))
    pod, data, tp = sizes.get("pod", 1), sizes["data"], sizes["model"]
    return Mesh(DryGroup("model", tp), 0, tp, data=data, axis_names=names,
                data_group=DryGroup("data", data), pod=pod,
                pod_group=DryGroup("pod", pod) if pod > 1 else None,
                dp_group=DryGroup("dp", pod * data))


def make_production_mesh(multi_pod: bool = False) -> Mesh:
    """The reference's production mesh as rank (0, ..., 0) sees it, dry:
    (16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model") with `multi_pod`."""
    return make_dry_mesh((2, 16, 16) if multi_pod else (16, 16))


def make_serving_mesh(tp: int = 1, group=None) -> Mesh:
    """The (1, tp) mesh of a tensor-parallel serving engine over `group`
    (default: the initialised default group), whose size must be `tp`.
    tp = 1 needs no process group."""
    tp = max(int(tp), 1)
    if tp == 1:
        return Mesh(None, 0, 1)
    import torch.distributed as dist

    if not dist.is_initialized():
        raise ValueError(f"tp={tp} needs an initialised torch.distributed "
                         "process group (see RankPool)")
    size = dist.get_world_size(group)
    if size != tp:
        raise ValueError(f"tp={tp} needs a group of {tp} ranks, have {size}")
    return Mesh(group, dist.get_rank(group), tp)


# the meshes `make_host_mesh` made in this process, by (model, data): a
# process group is made collectively once and reused
_HOST_MESHES: dict[tuple[int, int], Mesh] = {}


def make_host_mesh(model_parallel: int = 1,
                   data_parallel: int | None = None) -> Mesh:
    """The (data_parallel, model_parallel) mesh over the ranks of the
    initialised default group (one rank without one); `data_parallel`
    defaults to world / model_parallel. Ranks are laid out row-major: rank
    ``d * model_parallel + m`` sits at (d, m), its row the "model" group and
    its column the "data" group. A world larger than data x model holds
    that many independent copies of the mesh, one after the other (each
    computes alone: the CPU tests run a tp=2 mesh on a pool of four). Every
    rank must call it with the same arguments (the groups are made
    collectively, once per process)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if model_parallel != 1 or (data_parallel or 1) != 1:
            raise ValueError("a mesh of more than one rank needs an "
                             "initialised process group")
        return Mesh(None, 0, 1)
    world, me = dist.get_world_size(), dist.get_rank()
    mp = int(model_parallel)
    dp = int(data_parallel) if data_parallel else world // mp
    if dp < 1 or world % (mp * dp):
        raise ValueError(f"{world} ranks do not hold meshes of {dp} x {mp}")
    key = (mp, dp)
    if key not in _HOST_MESHES:
        rows, cols = {}, {}
        for base in range(0, world, mp * dp):
            for d in range(dp):
                ranks = [base + d * mp + m for m in range(mp)]
                group = dist.new_group(ranks)
                rows.update(dict.fromkeys(ranks, group))
            for m in range(mp):
                ranks = [base + d * mp + m for d in range(dp)]
                group = dist.new_group(ranks)
                cols.update(dict.fromkeys(ranks, group))
        local = me % (mp * dp)
        _HOST_MESHES[key] = Mesh(rows[me], local % mp, mp, data=dp,
                                 data_group=cols[me],
                                 data_rank=local // mp, dp_group=cols[me])
    return _HOST_MESHES[key]


def _rank_main(rank: int, tp: int, data: int, backend: str,
               store_path: str, timeout_s: float, threads: int | None,
               inbox, outbox) -> None:
    """A rank process: join the group, then run each (fn, args) from
    `inbox` as ``fn(mesh, *args)`` and put (rank, ok, result or
    traceback) on `outbox`, until None arrives."""
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)

    world = tp * data
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    mesh = make_serving_mesh(tp) if data == 1 else make_host_mesh(tp, data)
    try:
        while True:
            job = inbox.get()
            if job is None:
                break
            fn, args = job
            try:
                outbox.put((rank, True, fn(mesh, *args)))
            except Exception:
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``data x tp`` rank processes with one process group between them,
    started once and reused: ``pool.run(fn, *args)`` runs ``fn(mesh,
    *args)`` on every rank (`mesh` the (1, tp) serving mesh, or the (data,
    tp) `make_host_mesh` where `data` > 1) (`fn` importable by name, so that it pickles; the rank
    processes import nothing of the caller's module but `fn`'s) and
    returns the results in rank order. A rank that raises, dies or takes
    longer than `timeout_s` makes `run` raise RuntimeError; the pool is
    then stopped and the next `run` starts a fresh one. `threads` sets each
    rank's torch intra-op threads (default: torch's, every core; ranks of
    small CPU work beside each other run faster on one each). Use as a
    context manager, or call `close`."""

    def __init__(self, tp: int, backend: str = "gloo",
                 timeout_s: float = 300.0, threads: int | None = None,
                 data: int = 1):
        self.tp = int(tp)
        self.data = int(data)
        self.world = self.tp * self.data
        self.backend = backend
        self.timeout_s = float(timeout_s)
        self.threads = threads
        self.exitcodes: list = []
        self._procs: list = []
        self._inboxes: list = []
        self._outbox = None
        self._tmp = None

    def _start(self) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._tmp = tempfile.TemporaryDirectory(prefix="rankpool")
        store = os.path.join(self._tmp.name, "store")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(self.world)]
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, self.tp, self.data, self.backend, store, self.timeout_s,
                  self.threads, self._inboxes[r], self._outbox))
            for r in range(self.world)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, timeout_s: float | None = None) -> list:
        """``fn(mesh, *args)`` on every rank; the results in rank order."""
        if not self._procs:
            self._start()
        for box in self._inboxes:
            box.put((fn, args))
        limit = self.timeout_s if timeout_s is None else float(timeout_s)
        deadline = time.monotonic() + limit
        got: dict[int, object] = {}
        try:
            while len(got) < self.world:
                try:
                    rank, ok, res = self._outbox.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in self._procs
                            if p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"a rank process exited with "
                                           f"{dead[0]}") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"{fn.__name__} took more than "
                                           f"{limit:.0f} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{res}")
                got[rank] = res
        except BaseException:
            self.close(kill=True)
            raise
        return [got[r] for r in range(self.world)]

    def close(self, kill: bool = False) -> list:
        """Stop the rank processes (at once with `kill`, else after their
        current job), remove the store, and return the processes' exit
        codes in rank order (also kept as `exitcodes`; a rank that had to
        be killed after 30 s reads non-zero)."""
        for box in self._inboxes if not kill else []:
            box.put(None)
        for p in self._procs:
            if kill:
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if self._procs:
            self.exitcodes = [p.exitcode for p in self._procs]
        self._procs, self._inboxes, self._outbox = [], [], None
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None
        return self.exitcodes

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
