#!/usr/bin/env python3
"""Time one serving run's GEMM launches with the hand-written GEMM of
several checkouts, in turns, on one card.

    python3 tools/gemm_sums.py SHAPES_JSON ROOT [ROOT ...]
    python3 tools/gemm_sums.py --from-log LOG PATH OUT_JSON

SHAPES_JSON is what `chip_smoke.py` writes to ``build/serving_shapes.json``:
per model, every (M, N, K, in dtype, out dtype) its serving run launched
and how often. ``--from-log`` writes such a file from the per-shape lines
of a `chip_smoke.py` log (``[shapes]``, ``[dense shapes <model>]`` and the
like: M N K out dtype count path ...), keeping the shapes that took PATH
(``stream`` or ``wgmma``), one entry per line tag: every serving phase's
launches on that path. Each ROOT is a checkout (this one is ``.``); list a pair as
``A B B A`` to time them in turns. For each ROOT in order a fresh process
imports that checkout's `repro_torch` (so its `plan` picks the path, tile
and K split), builds its kernel, and times every shape with CUDA events
(median of 10 runs, the L2 flushed before each) beside torch.matmul; then
the sums over the run's launches are printed, per model and per path,
with the card's bound (bytes or operations at 3.35 TB/s and 989 TFLOP/s
bf16). The last line is one JSON object of all the sums.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

PEAK_BF16_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12


def _worker(shapes_json: str, root: str) -> dict:
    """Time every shape with `root`'s kernel; {model: {path: sums}}."""
    import torch

    sys.path.insert(0, str(Path(root).resolve() / "src"))
    from repro_torch.core.profiler import time_ms
    from repro_torch.kernels.tiled_matmul import plan, tiled_matmul

    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(1)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = {}
    for model, rows in json.loads(Path(shapes_json).read_text()).items():
        tot = collections.defaultdict(collections.Counter)
        for m, n, k, in_dt, out_dt, count in rows:
            in_dt, out_dt = getattr(torch, in_dt), getattr(torch, out_dt)
            a = torch.randn((m, k), generator=g, device=dev).to(in_dt)
            b = (torch.randn((k, n), generator=g, device=dev)
                 / k ** 0.5).to(in_dt)
            path = plan(m, n, k, a.stride(), b.stride(), 0, 0, in_dt,
                        out_dt).path
            ms = time_ms(lambda: tiled_matmul(a, b, out_dtype=out_dt),
                         flush, 10)
            lib = time_ms(lambda: torch.matmul(a, b), flush, 10)
            osz = 4 if out_dt == torch.float32 else 2
            bound = 1e3 * max(2.0 * m * n * k / PEAK_BF16_FLOPS,
                              (2 * (m * k + k * n) + osz * m * n)
                              / HBM_BYTES_PER_S)
            for key in (path, "all"):
                tot[key]["ms"] += count * ms
                tot[key]["library_ms"] += count * lib
                tot[key]["bound_ms"] += count * bound
                tot[key]["launches"] += count
        out[model] = {p: dict(t) for p, t in tot.items()}
    return out


def shapes_from_log(log: str, path: str) -> dict:
    """{tag: [[M, N, K, "bfloat16", out dtype, count], ...]} of the shapes
    that took `path` in a `chip_smoke.py` log's per-shape lines (the
    serving phases run bf16 operands)."""
    out = collections.defaultdict(list)
    for line in log.splitlines():
        hit = re.match(r"\[((?:[\w.-]+ )?shapes(?: [\w.-]+)?)\] (\d+) (\d+) "
                       r"(\d+) (\w+) (\d+) (\w+) ", line)
        if hit and hit[7] == path:
            m, n, k, count = (int(hit[i]) for i in (2, 3, 4, 6))
            out[hit[1]].append([m, n, k, "bfloat16", hit[5], count])
    return dict(out)


def main(argv: list[str]) -> int:
    """Run one worker per root in order; print the sums."""
    if len(argv) >= 3 and argv[0] == "--worker":
        print(json.dumps(_worker(argv[1], argv[2])))
        return 0
    if len(argv) == 4 and argv[0] == "--from-log":
        shapes = shapes_from_log(Path(argv[1]).read_text(), argv[2])
        Path(argv[3]).write_text(json.dumps(shapes))
        print(f"{sum(map(len, shapes.values()))} shapes on {argv[2]} in "
              f"{len(shapes)} runs to {argv[3]}")
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    shapes, roots = argv[0], argv[1:]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    runs = []
    for i, root in enumerate(roots):
        res = subprocess.run([sys.executable, __file__, "--worker", shapes,
                              root], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        sums = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"turn": i, "root": root, "sums": sums})
        for model, paths in sums.items():
            for path, t in sorted(paths.items()):
                print(f"[gemm sums] turn {i} {root} {model} {path}: "
                      f"{int(t['launches'])} launches, kernel "
                      f"{t['ms']:.2f} ms, torch.matmul {t['library_ms']:.2f} "
                      f"ms, bound {t['bound_ms']:.2f} ms", flush=True)
    print(f"[gemm sums] {card}")
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
