#!/usr/bin/env python3
"""Time gloo's collectives between two rank processes on one card.

    python3 tools/gloo_probe.py

Two spawned processes on ``cuda:0`` join a gloo group (NCCL refuses two
ranks on one device) and time 50 calls each of what tensor-parallel
serving posts (`repro_torch.distributed.tp`): an all-gather of an
8 x 3584 bf16 CUDA tensor (a qwen2-7b decode step's row-parallel
output), the same posted with ``async_op=True`` and waited for, in f32,
an all-reduce, ``all_gather_into_tensor`` and a barrier, plus the
all-gather staged by hand through a pinned host buffer. Each rank prints
one dict of milliseconds a call ("FAIL" and the error where gloo refuses
a CUDA tensor), then the exit codes. Needs a CUDA device.
"""

from __future__ import annotations

import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANKS = 2
CALLS = 50


def _time(fn, x) -> str:
    """Milliseconds a call of ``fn(x)`` over `CALLS` calls after one
    warm-up, or the error."""
    try:
        fn(x)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(CALLS):
            fn(x)
        torch.cuda.synchronize()
        return f"ok {(time.perf_counter() - t) / CALLS * 1e3:.3f} ms"
    except Exception as e:      # a refused collective is the finding
        return "FAIL " + repr(e)[:300]


def _rank(rank: int, path: str, q) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=RANKS)
    dev = torch.device("cuda", 0)

    def parts(x):
        return [torch.empty_like(x) for _ in range(RANKS)]

    cases = {
        "all_gather_bf16": lambda x: dist.all_gather(parts(x), x),
        "all_gather_async": lambda x: dist.all_gather(
            parts(x), x, async_op=True).wait(),
        "all_gather_f32": lambda x: dist.all_gather(parts(x.float()),
                                                    x.float()),
        "all_reduce_bf16": lambda x: dist.all_reduce(x.clone()),
        "all_gather_into_tensor": lambda x: dist.all_gather_into_tensor(
            torch.empty((RANKS * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                        device=x.device), x),
        "barrier": lambda x: dist.barrier(),
    }
    res = {"rank": rank}
    for name, fn in cases.items():
        x = torch.full((8, 3584), float(rank + 1), dtype=torch.bfloat16,
                       device=dev)
        res[name] = _time(fn, x)
    x = torch.full((2, 3), float(rank + 1), dtype=torch.bfloat16, device=dev)
    got = parts(x)
    dist.all_gather(got, x)
    res["gathered"] = torch.cat(got)[:, 0].tolist()
    host = torch.empty((8, 3584), dtype=torch.bfloat16, pin_memory=True)
    host_parts = parts(host)
    x = torch.ones((8, 3584), dtype=torch.bfloat16, device=dev)
    t = time.perf_counter()
    for _ in range(CALLS):
        host.copy_(x)
        dist.all_gather(host_parts, host)
        torch.cat(host_parts).to(dev, non_blocking=True)
    torch.cuda.synchronize()
    res["staged_all_gather"] = (
        f"{(time.perf_counter() - t) / CALLS * 1e3:.3f} ms")
    q.put(res)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    t = time.time()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    path = tempfile.mktemp()
    procs = [ctx.Process(target=_rank, args=(r, path, q))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    for _ in procs:
        print(q.get(timeout=300))
    for p in procs:
        p.join(60)
    print("exit", [p.exitcode for p in procs], time.time() - t)
    return max(p.exitcode or 0 for p in procs)


if __name__ == "__main__":
    sys.exit(main())
