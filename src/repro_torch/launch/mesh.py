"""Serving meshes and the rank processes that hold them.

The counterpart of the JAX package's `repro.launch.mesh` in PyTorch's SPMD
idiom: one process per rank, each with a `torch.distributed` process group,
instead of one process driving several devices. A `Mesh` is the process
group, this rank, and the ("data", "model") axes at shape (1, tp): the
batch stays whole on every rank (decode-slot surgery stays local) and the
`tp` ranks of the group are the "model" axis.

`RankPool` starts `tp` rank processes (``spawn``) under a `FileStore` and
runs functions in all of them at once. The backend is the caller's:
"gloo" on the CPU, and also for several ranks on one card (gloo carries
CUDA tensors, staged through host memory inside its collectives; NCCL
refuses two ranks on one device); "nccl" is what a deployment with one
card per rank passes, and no test or script of the repository runs it. A
rank's device is its function's business: the entry points take
``device=``.

The reference's `make_production_mesh` (256 TPU chips for the dry-run)
has no counterpart yet (ROADMAP A7).
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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, tp) mesh over a process group: `group` (None: the default
    group, or no group at all when the mesh has one rank), this process's
    `rank` on the "model" axis, and the axis sizes."""

    group: object
    rank: int
    tp: int
    data: int = 1
    axis_names: tuple[str, str] = AXIS_NAMES

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, as a JAX mesh's ``shape``."""
        return {"data": self.data, "model": self.tp}


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


def make_host_mesh(model_parallel: int = 1) -> Mesh:
    """The mesh over every rank of the initialised default group (one rank
    without one): (world / model_parallel, model_parallel), ranks laid out
    row-major, this process's "model" group its row. Every rank must call
    it (each row's group is created collectively)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if model_parallel != 1:
            raise ValueError("model_parallel > 1 needs an initialised "
                             "process group")
        return Mesh(None, 0, 1)
    world, me = dist.get_world_size(), dist.get_rank()
    if world % model_parallel:
        raise ValueError(f"{world} ranks do not split into rows of "
                         f"{model_parallel}")
    mine = None
    for row in range(world // model_parallel):
        ranks = list(range(row * model_parallel, (row + 1) * model_parallel))
        group = dist.new_group(ranks)
        if me in ranks:
            mine = group
    return Mesh(mine, me % model_parallel, model_parallel,
                data=world // model_parallel)


def _rank_main(rank: int, tp: int, backend: str, store_path: str,
               timeout_s: float, threads: int | None, inbox, outbox) -> None:
    """A rank process: join the group, then run each (fn, args) from
    `inbox` as ``fn(mesh, *args)`` and put (rank, ok, result or
    traceback) on `outbox`, until None arrives."""
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)

    store = dist.FileStore(store_path, tp)
    dist.init_process_group(backend, store=store, rank=rank, world_size=tp,
                            timeout=datetime.timedelta(seconds=timeout_s))
    mesh = make_serving_mesh(tp)
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
    """`tp` rank processes with one process group between them, started
    once and reused: ``pool.run(fn, *args)`` runs ``fn(mesh, *args)`` on
    every rank (`fn` importable by name, so that it pickles; the rank
    processes import nothing of the caller's module but `fn`'s) and
    returns the results in rank order. A rank that raises, dies or takes
    longer than `timeout_s` makes `run` raise RuntimeError; the pool is
    then stopped and the next `run` starts a fresh one. `threads` sets each
    rank's torch intra-op threads (default: torch's, every core; ranks of
    small CPU work beside each other run faster on one each). Use as a
    context manager, or call `close`."""

    def __init__(self, tp: int, backend: str = "gloo",
                 timeout_s: float = 300.0, threads: int | None = None):
        self.tp = int(tp)
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
        self._inboxes = [ctx.Queue() for _ in range(self.tp)]
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, self.tp, self.backend, store, self.timeout_s,
                  self.threads, self._inboxes[r], self._outbox))
            for r in range(self.tp)]
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
            while len(got) < self.tp:
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
        return [got[r] for r in range(self.tp)]

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
