#!/usr/bin/env python3
"""Do the `stream` and `wgmma` paths give a row the same bits when they sum
the same K segments? (Fault C1's question, asked of the card.)

    python3 tools/c1_probe.py

For each (N, K) of a list of serving projections and both output dtypes
(bf16, f32), and for several segment counts, it launches the hand-written
GEMM with the segments forced equal on every path and tile, each segment
its own CTA: `stream` on the 8-, 16- and 64-row tiles and `wgmma` on the
128 x 64, 128 and 256 tiles, at 1 to 512 rows, and compares rows 0-3 with
those of the 8-row stream tile's 4-row call, bit for bit. Prints one line
per case ('=' where the rows are bit-equal, DIFFn with the count of
differing elements where not) and, last, one JSON object with the count
of cases and of mismatches. Needs the card; builds the kernel at first
use.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# (N, K): qwen2-7b's projections and LM head, qwen2.5-14b's K/V, olmoe's
# attention, router and LM head, deepseek-v2-236b's router, w_kpe, w_dkv,
# w_dq, w_uq, w_uk/w_uv and wo; and two ragged shapes
SHAPES = [(3584, 3584), (512, 3584), (18944, 3584), (3584, 18944),
          (152064, 3584), (1024, 5120), (2048, 2048), (64, 2048),
          (160, 5120), (64, 5120), (512, 5120), (1536, 5120), (24576, 1536),
          (16384, 512), (5120, 16384), (50304, 2048), (200, 296), (136, 40)]
# (label, rows, path, tile)
RUNS = [("s8m1", 1, "stream", (8, 64, 64)), ("s16m16", 16, "stream", (16, 64, 64)),
        ("s64m64", 64, "stream", (64, 64, 64)),
        ("w64m128", 128, "wgmma", (128, 64, 64)),
        ("w128m128", 128, "wgmma", (128, 128, 64)),
        ("w128m65", 65, "wgmma", (128, 128, 64)),
        ("w256m512", 512, "wgmma", (128, 256, 64))]


def main() -> int:
    """Run every case; exit 1 if any rows differ."""
    import torch

    from repro_torch.kernels import tiled_matmul as tm

    if not torch.cuda.is_available():
        print("c1_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(0)

    def run(a, b, out_dtype, path, tile, segments):
        m, k = a.shape
        out = torch.empty((m, b.shape[1]), dtype=out_dtype, device=dev)
        p = tm.Plan(path, tm.BlockConfig(*tile), segments, segments)
        tm._launch(a, b, None, out, m, b.shape[1], k, a.stride(), b.stride(),
                   (0, 0), 1.0, 0.0, p)
        return out

    cases = mismatches = 0
    for n, k in SHAPES:
        a = torch.randn((512, k), generator=g, device=dev).to(torch.bfloat16)
        b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(
            torch.bfloat16)
        most = max(1, -(-k // 64) // 2)
        for out_dt in (torch.bfloat16, torch.float32):
            for s in sorted({1, 2, 3, 5, 9, min(28, most)} & set(
                    range(1, most + 1))):
                want = run(a[:4], b, out_dt, "stream", (8, 64, 64), s)
                line = []
                for label, rows, path, tile in RUNS:
                    got = run(a[:rows], b, out_dt, path, tile, s)
                    r = min(rows, 4)
                    diff = int((got[:r] != want[:r]).sum())
                    cases += 1
                    mismatches += diff > 0
                    line.append(f"{label}:{'=' if not diff else f'DIFF{diff}'}")
                torch.cuda.synchronize()
                print(f"({n}, {k}, {str(out_dt).split('.')[-1]}, {s} "
                      f"segments) " + " ".join(line), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(json.dumps({"cases": cases, "mismatches": mismatches,
                      "card": card}))
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
