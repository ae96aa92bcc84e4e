"""Where a one-rank train step's gradient norm differs between one
whole-batch backward and the same batch in microbatches, on the card.

Phase 18 (d) of ``chip_smoke.py`` holds its FSDP ranks (each data rank's
rows, their gradients summed) to a one-rank step of the same model over
the same rows. This script takes that model (`chip_smoke._fsdp_cfg`:
full-width qwen2.5-14b cut to 2 layers, seeded init) and that batch
(4 x 512 tokens) and computes, for each leaf, the gradient of the
whole-batch backward and of 2 microbatches (summed in f32 and averaged,
as `train.step.make_train_step` does), in the config's bf16 and again
with the same weights in f32 (parameters and activations), where the f32
whole-batch gradient is the reference. It prints one JSON line a leaf,
the leaves with the largest share of the norm's gap first, and the
global norms, and writes them to ``chiprun_out/grad_gap.json``.

    python tools/grad_gap.py
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke  # noqa: E402
from repro_torch.kernels._build import load_library  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train.step import _value_and_grad  # noqa: E402

ROWS, SEQ, SPLITS = chip_smoke.FSDP_ROWS, chip_smoke.FSDP_SEQ, 2


def grads(api, params, cfg, batch, splits: int) -> tuple[float, dict]:
    """(loss, {leaf: f32 gradient}) of `batch` in `splits` microbatches
    (summed in f32 and averaged), or whole at 1."""
    names = [n for n, _ in params.named_parameters()]
    total = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.named_parameters()}
    loss = 0.0
    for i in range(splits):
        mb = {k: v.reshape(splits, v.shape[0] // splits, *v.shape[1:])[i]
              for k, v in batch.items()}
        lo, _, g = _value_and_grad(api, params, names, mb, cfg)
        for n in names:
            total[n] += g[n].float()
        loss += float(lo)
        del g
    return loss / splits, {n: g / splits for n, g in total.items()}


def main() -> None:
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    load_library()
    cfg = chip_smoke._fsdp_cfg()
    api = get_model(cfg)
    params = api.init(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    for p in params.parameters():
        p.requires_grad_(True)
    batch = chip_smoke._family_batch(dev, cfg, ROWS, SEQ, 0)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    params32 = copy.deepcopy(params).float()
    runs = {}
    for tag, (p, c) in {"bf16": (params, cfg), "f32": (params32, cfg32)}.items():
        for splits in (1, SPLITS):
            loss, g = grads(api, p, c, batch, splits)
            runs[f"{tag} x{splits}"] = (loss, {n: t.cpu() for n, t in g.items()})
            del g
            torch.cuda.empty_cache()
    ref = runs["f32 x1"][1]
    sq = {k: {n: float(t.double().square().sum()) for n, t in g.items()}
          for k, (_, g) in runs.items()}
    rows = []
    for n, r in ref.items():
        row = {"leaf": n, "shape": list(r.shape)}
        for k, (_, g) in runs.items():
            row[f"norm {k}"] = sq[k][n] ** 0.5
            row[f"rel diff {k} vs f32 x1"] = float(
                (g[n].double() - r.double()).norm() / r.double().norm())
        row["sq gap bf16 x2 - x1"] = sq["bf16 x2"][n] - sq["bf16 x1"][n]
        rows.append(row)
    rows.sort(key=lambda r: -abs(r["sq gap bf16 x2 - x1"]))
    summary = {k: {"loss": loss, "grad_norm": sum(sq[k].values()) ** 0.5}
               for k, (loss, _) in runs.items()}
    summary["card"] = chip_smoke._nvidia_smi()
    summary["seconds"] = time.perf_counter() - t0
    for r in rows:
        print(json.dumps(r))
    print(json.dumps(summary))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "grad_gap.json"), "w") as f:
        json.dump({"leaves": rows, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
