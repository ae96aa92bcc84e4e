#!/usr/bin/env python3
"""Try the tensor-parallel SSM, hybrid and MLA path on one card, fast.

    python3 tools/tp_probe.py

Runs, from `chip_smoke.py`, the build, phase 3's part-wise shard check
(`_shard_parts`) and scan and head check (`_shard_scans`), then serves
`TP_UIDS` of falcon-mamba-7b, zamba2-2.7b and deepseek-v2-236b (at
`DEEPSEEK_LAYERS`) at tp=1 in this process and hands those streams to
phase 17's second part (`phase_tp_families`), while phases 15 (e)'s and
16 (d)'s meta analyses run ahead (`_analyse_ahead`); last, two of those
analyses are made again and compared with the ahead ones. A failing
check prints FAILED and the probe goes on. About two minutes of command
time on an H100, against the whole script's sixteen. Needs a CUDA
device.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402


def main() -> int:
    """Run the probe; returns the exit code."""
    if not torch.cuda.is_available():
        print("tp_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.opanalyze import analyze_step
    from repro_torch.serving.engine import ServingEngine

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    C._say(C._nvidia_smi())
    C.phase_build()
    g = torch.Generator(dev).manual_seed(0)
    for fn in (C._shard_parts, C._shard_scans):
        try:
            fn(dev, g)
        except SystemExit as e:
            print("FAILED", str(e)[:2000], flush=True)
    wants = {}
    for arch, layers in (("falcon-mamba-7b", None), ("zamba2-2.7b", None),
                         ("deepseek-v2-236b", C.DEEPSEEK_LAYERS)):
        t1 = time.perf_counter()
        cfg, api, params = C._init_model(dev, arch, "probe", layers)
        eng = ServingEngine(api, params, cfg, max_batch=4, max_len=512,
                            chunk_tokens=64, device=dev)
        for u in C.TP_UIDS:
            eng.submit(C._requests(cfg)[u])
        res = eng.run_until_empty()
        wants[arch] = {r.uid: r.tokens.tolist() for r in res}
        C._say(f"[probe] {arch} tp=1: {wants[arch]} in "
               f"{time.perf_counter() - t1:.1f} s")
        del eng, params, res
        C._free()
    ahead = C._analyse_ahead(dev)
    try:
        C.phase_tp_families(wants)
    except SystemExit as e:
        print("FAILED", str(e)[:3000], flush=True)
    t_join = time.perf_counter()
    ahead.join()
    made = [(k, v if isinstance(v, str) else round(v[1], 1))
            for k, v in C._DRY_AHEAD.items()]
    C._say(f"[probe] ahead: {made}, waited "
           f"{time.perf_counter() - t_join:.1f} s")
    for tag, cfg, batch in C._train_checks(dev)[:2]:
        fn, args = C._train_cell(cfg, batch)
        t1 = time.perf_counter()
        fresh = analyze_step(fn, *args)
        old = C._DRY_AHEAD[tag][0]
        same = (fresh.flops == old.flops and fresh.hbm_bytes == old.hbm_bytes
                and fresh.peak_live_bytes == old.peak_live_bytes
                and {p: (t.launches, t.flops) for p, t in fresh.gemms.items()}
                == {p: (t.launches, t.flops) for p, t in old.gemms.items()})
        C._say(f"[probe] {tag}: fresh analysis in "
               f"{time.perf_counter() - t1:.1f} s equals the ahead one "
               f"{same}")
    C._say(f"[probe] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
