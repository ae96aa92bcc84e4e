"""The JAX package's dry-run cells at smoke size on a (2, 2) ("data",
"model") mesh of four forced host devices, for `test_torch_dryrun_mesh.py`.

Not a test file: the test runs it in a subprocess (the device count is
fixed when JAX starts), ``python tests/torch_mesh_reference.py in.json
out.json``. Each case of ``in.json`` ({"arch", "shape", "changes"}) is
built as the reference's `repro.launch.dryrun.build_cell` builds it, on
the smoke config with `changes` (``dataclasses.replace``):
``param_shardings(fsdp=cfg.fsdp)``, ``batch_shardings``,
``zero1_shardings`` for training, and compiled as its `run_cell` compiles
it. ``out.json`` holds per case ``analyze_hlo(hlo, 4)``'s FLOPs and
collective wire bytes by op per chip (and the same split into tensors and
scalar sums, ``wire_split``), and the global and shard shapes of every
parameter (by "/"-joined path) and input leaf.
"""

from __future__ import annotations

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402

import jax  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

jax.devices()   # the backend starts with 4 devices before dryrun's import

from repro.configs import SHAPE_DEFS, get_config, input_specs  # noqa: E402
from repro.core import hloanalyze  # noqa: E402
from repro.core.hloanalyze import analyze_hlo  # noqa: E402
from repro.distributed.sharding import (param_shardings,  # noqa: E402
                                        set_mesh_rules)
from repro.kernels import ops  # noqa: E402
from repro.launch.dryrun import batch_shardings  # noqa: E402
from repro.models.registry import get_model  # noqa: E402
from repro.optim.adamw import (AdamWConfig, init_opt_state,  # noqa: E402
                               zero1_shardings)
from repro.train.step import make_train_step  # noqa: E402


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _shapes(tree, shardings) -> dict:
    """{path: [global shape, shard shape]} of every leaf."""
    out = {}
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    for (path, leaf), sh in zip(leaves, shs):
        out[_path(path)] = [list(leaf.shape),
                            list(sh.shard_shape(leaf.shape))]
    return out


# fewer elements than this: a scalar sum (a loss part, a metric, a norm's
# square sum), kept apart from the tensors in the wire bytes
SCALAR = 8


def _wire_split(hlo: str) -> dict:
    """{op: [tensor wire bytes, scalar wire bytes]} per chip, as
    ``analyze_hlo`` counts them (each while body times its trips), each
    instruction's wire split over its operands in proportion to their
    bytes (the ring formulas are linear in them)."""
    comps, symtab = hloanalyze.parse_hlo(hlo)
    entry = next(c for c in comps.values() if c.is_entry)
    out: dict = {}

    def walk(name, mult, stack=()):
        if name not in comps or name in stack:
            return
        for ins in comps[name].instrs:
            wire = hloanalyze._collective_wire(ins, 4, symtab)
            if wire:
                shapes = hloanalyze._operand_shapes(ins, symtab)
                sizes = [(hloanalyze._shape_bytes(d, ",".join(map(str, s))),
                          math.prod(s)) for d, s in shapes]
                total = sum(b for b, _ in sizes)
                t = out.setdefault(ins.opcode.replace("-start", ""),
                                   [0.0, 0.0])
                for b, n in sizes:
                    t[n < SCALAR] += wire * b / total * mult
            if ins.opcode == "while":
                body = re.search(r"body=%?([\w.\-]+)", ins.line)
                cond = re.search(r"condition=%?([\w.\-]+)", ins.line)
                trips = (hloanalyze._trip_count(comps[cond.group(1)])
                         if cond and cond.group(1) in comps else 1)
                if body:
                    walk(body.group(1), mult * trips, stack + (name,))
            elif ins.opcode in ("fusion", "call", "conditional",
                                "custom-call"):
                for m in re.finditer(r"(?:calls|to_apply)=%?([\w.\-]+)",
                                     ins.line):
                    walk(m.group(1), mult, stack + (name,))
                for m in re.finditer(r"branch_computations=\{([^}]*)\}",
                                     ins.line):
                    for sub in m.group(1).replace("%", "").split(","):
                        walk(sub.strip(), mult, stack + (name,))

    walk(entry.name, 1)
    return out


def run(case: dict, mesh) -> dict:
    arch, shape = case["arch"], case["shape"]
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              **case.get("changes", {}))
    model = get_model(cfg)
    set_mesh_rules(mesh, fsdp=cfg.fsdp, expert_axis=cfg.moe_expert_axis)
    specs = input_specs(arch, shape, smoke=True)
    step = SHAPE_DEFS[shape]["step"]
    params = jax.eval_shape(lambda k: model.init(k, cfg), jax.random.key(0))
    p_sh = param_shardings(params, mesh, fsdp=cfg.fsdp)
    b_sh = batch_shardings(arch, shape, mesh, specs, cfg=cfg)
    if step == "train":
        opt = jax.eval_shape(init_opt_state, params)
        state = {"params": params, "opt": opt,
                 "rng": jax.eval_shape(
                     lambda: jax.random.key_data(jax.random.key(0)))}
        state_sh = {"params": p_sh,
                    "opt": zero1_shardings(params, p_sh, mesh),
                    "rng": NamedSharding(mesh, P())}
        fn = make_train_step(model, cfg, AdamWConfig())
        args, in_sh, out_sh, donate = ((state, specs), (state_sh, b_sh),
                                       (state_sh, None), (0,))
    elif step == "prefill":
        def fn(p, b):
            return model.prefill(p, b, cfg)[0]

        args, in_sh, out_sh, donate = (params, specs), (p_sh, b_sh), None, ()
    else:
        def fn(p, t, s):
            return model.decode_step(p, t, s, cfg)

        args = (params, specs["token"], specs["state"])
        in_sh = (p_sh, b_sh["token"], b_sh["state"])
        out_sh, donate = (None, b_sh["state"]), (2,)
    with mesh:
        kw = {"out_shardings": out_sh} if out_sh is not None else {}
        hlo = jax.jit(fn, in_shardings=in_sh, donate_argnums=donate,
                      **kw).lower(*args).compile().as_text()
    hc = analyze_hlo(hlo, 4)
    return {"flops": float(hc.flops),
            "collective_by_op": {k: float(v)
                                 for k, v in hc.collective_by_op.items()},
            "wire_split": _wire_split(hlo),
            "params": _shapes(params, p_sh),
            "inputs": _shapes(specs, b_sh)}


def main() -> None:
    cases = json.load(open(sys.argv[1]))
    ops.force_mode("xla")
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    json.dump({key: run(case, mesh) for key, case in cases.items()},
              open(sys.argv[2], "w"))


if __name__ == "__main__":
    main()
