"""Dry-run of every (arch, shape) cell on one H100: what each step should
cost, counted from the port's own ops on meta tensors, with no card and no
device memory.

    python -m repro_torch.launch.dryrun                      # all cells
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k

The port's counterpart of the JAX package's `repro.launch.dryrun`. There
a cell is lowered and compiled for a TPU mesh and its HLO analysed; here
the parameters are built on ``meta`` at the config's full width and depth
(`ModelApi.init(cfg, None, device="meta")`, the counterpart of
``jax.eval_shape(model.init)``), the inputs are the cell's `input_specs`
as meta tensors, and one call of the step runs under
`core.opanalyze.analyze_step`: train cells the port's whole train step
with AdamW (`train.step.make_train_step`), prefill cells ``prefill``,
decode cells ``decode_step`` on the meta decode state. The hand-written
GEMM's wrappers take meta operands on their shape-only path (the
counterpart of the reference's ``ops.force_mode("xla")``): each product
is recorded under the path, tile and K segments `plan` gives the card.

Mesh: one card, ``h100x1``; the dry-run's mesh is ROADMAP A7.3.
One JSON per cell goes to ``artifacts/dryrun_torch/h100x1/<arch>_<shape>.json``
with the reference's keys, less the XLA-only ones:
``lower_s`` and ``compile_s`` (here ``build_s`` and ``analyze_s``),
``while_trip_counts`` (the port's loops are Python loops, counted as they
run), ``xla_cost_analysis_flops_raw``, ``xla_cost_analysis_bytes_raw``
and ``memory_analysis.generated_code_size_in_bytes``. ``memory_analysis``
holds the arguments' and outputs' bytes and, as
``temp_size_in_bytes``, the peak-live estimate less the arguments. Added:
``roofline`` (`core.roofline.roofline_from_cost` on the ``h100`` spec),
``gemms`` (the GEMM's launches, FLOPs, bytes and summed bound per path),
``gemm_flops`` and ``n_ops``.

Only the reference's default cell runs (its ``variant`` key is null).
``--variant`` takes the reference's other variant names and refuses each:
its sharding and collective variants change only a mesh and raise a
ValueError naming ROADMAP A7.3; its cache-dtype variants (``kv_fp8``,
``kv_batch_fp8``) raise too, since the port's caches stay bf16 (the
hand-written GEMM writes no float8, and MLA's latent decompression is a
GEMM whose output takes the cache's dtype).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import SHAPE_DEFS, all_cells, get_config, input_specs
from repro_torch.configs.common import meta_tree
from repro_torch.core.opanalyze import analyze_step
from repro_torch.core.roofline import roofline_from_cost
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
MESH = "h100x1"


# the reference's variants other than its default cell: they change only a
# mesh's sharding or collectives, or store the cache in float8
MESH_VARIANTS = ("sp", "ep_data", "kv_batch", "sp_ep_data", "moe_smap",
                 "moe_smap_sp", "tpx", "tpx_sp")
FP8_VARIANTS = ("kv_fp8", "kv_batch_fp8")


def refuse_variant(variant: str) -> None:
    """Raise a ValueError saying why the port runs no cell of `variant`."""
    if variant in MESH_VARIANTS:
        raise ValueError(f"variant {variant!r} changes a mesh's sharding or "
                         "collectives; the port's dry-run runs one card "
                         "until it has a mesh (ROADMAP A7.3)")
    if variant in FP8_VARIANTS:
        raise ValueError(f"variant {variant!r} stores the cache in float8; "
                         "the port's caches are bf16 (its GEMM writes no "
                         "float8)")
    raise ValueError(f"unknown variant {variant!r}; the reference's are "
                     f"{list(MESH_VARIANTS + FP8_VARIANTS)}")


def build_cell(arch: str, shape: str, *, cfg=None,
               specs: dict | None = None) -> tuple:
    """(fn, args, cfg) of one cell on meta: ``fn(*args)`` is its step.
    `cfg` and `specs` override the cell's config and input specs (a cut
    depth or another batch: how ``chip_smoke.py`` rebuilds the steps it
    ran on the card)."""
    cfg = cfg or get_config(arch)
    api = get_model(cfg)
    specs = specs if specs is not None else input_specs(arch, shape)
    step = SHAPE_DEFS[shape]["step"]
    inputs = meta_tree(specs)
    if step == "train":
        state = init_train_state(None, api, cfg, device="meta")
        return make_train_step(api, cfg, AdamWConfig()), (state, inputs), cfg
    params = api.init(cfg, None, device="meta")
    if step == "prefill":
        def prefill(params, batch):
            return api.prefill(params, batch, cfg)[0]

        return prefill, (params, inputs), cfg

    def decode(params, token, state):
        return api.decode_step(params, token, state, cfg)

    return decode, (params, inputs["token"], inputs["state"]), cfg


def model_flops(cfg, shape: str) -> tuple[float, int]:
    """(model FLOPs, tokens) of one step of `shape`, the reference's
    formula: (6 if training else 2) x active params x tokens, a decode
    step's tokens one a row."""
    d = SHAPE_DEFS[shape]
    tokens = d["global_batch"] * (d["seq_len"] if d["step"] != "decode"
                                  else 1)
    return ((6 if d["step"] == "train" else 2) * cfg.n_active_params()
            * tokens, tokens)


def run_cell(arch: str, shape: str, *, out_dir: str | Path = ARTIFACTS,
             force: bool = False) -> dict:
    """Dry-run one cell and write its JSON (the module docstring lists its
    keys; an existing one is returned as it is unless `force`)."""
    out = Path(out_dir) / MESH
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{arch}_{shape}.json"
    if path.exists() and not force:
        return json.loads(path.read_text())
    t0 = time.perf_counter()
    fn, args, cfg = build_cell(arch, shape)
    t1 = time.perf_counter()
    cost = analyze_step(fn, *args)
    t2 = time.perf_counter()
    del fn, args
    mf, tokens = model_flops(cfg, shape)
    report = roofline_from_cost(f"{arch}_{shape}", cost, model_flops=mf)
    result = {
        "arch": arch,
        "shape": shape,
        "variant": None,
        "mesh": MESH,
        "n_chips": 1,
        "step": SHAPE_DEFS[shape]["step"],
        "build_s": round(t1 - t0, 3),
        "analyze_s": round(t2 - t1, 3),
        "flops_per_chip": float(cost.flops),
        "bytes_per_chip": float(cost.hbm_bytes),
        "collective_wire_bytes_per_chip": float(cost.collective_bytes),
        "collective_wire_bytes_by_op": dict(cost.collective_by_op),
        "model_flops": float(mf),
        "tokens_per_step": tokens,
        "memory_analysis": {
            "argument_size_in_bytes": cost.argument_bytes,
            "output_size_in_bytes": cost.output_bytes,
            "temp_size_in_bytes": cost.peak_live_bytes - cost.argument_bytes,
        },
        "roofline": report.as_row(),
        "gemm_flops": float(cost.gemm_flops),
        "gemms": {p: dataclasses.asdict(g) for p, g in cost.gemms.items()},
        "n_ops": cost.n_ops,
    }
    path.write_text(json.dumps(result, indent=1))
    return result


def main(argv: list[str] | None = None) -> int:
    """Dry-run the selected cells; exit 1 if any fails."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description="dry-run on one H100 (meta)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--variant", default=None,
                    help="a reference variant: each is refused (docstring)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    if args.variant is not None:
        refuse_variant(args.variant)
    cells = all_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    failures = []
    for arch, shape in cells:
        tag = f"{arch} x {shape} x {MESH}"
        try:
            t0 = time.perf_counter()
            r = run_cell(arch, shape, out_dir=args.out, force=args.force)
            roof = r["roofline"]
            print(f"[ok] {tag}: flops={r['flops_per_chip']:.4e} "
                  f"bytes={r['bytes_per_chip']:.4e} "
                  f"bound={roof['bound_s']:.4e}s ({roof['dominant']}) "
                  f"args={r['memory_analysis']['argument_size_in_bytes'] / 2**30:.2f}GiB "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
        except Exception as e:
            failures.append((tag, repr(e)))
            print(f"[FAIL] {tag}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(f"  {t}: {e}")
        return 1
    print(f"\nall {len(cells)} dry-run cells passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
