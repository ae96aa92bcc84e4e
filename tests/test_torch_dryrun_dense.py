"""The dry-run against the JAX package's, for the dense family: each smoke
cell's dot FLOPs counted by `core.opanalyze.analyze_step` on meta tensors
equal `core.hloanalyze.analyze_hlo` over the reference's compiled step on
one CPU device (its kernels forced to "xla", as its dry-run forces them).
Also `model_flops` and `tokens_per_step` for every cell, the cell's JSON
and the variants. The other families' files import `ref_flops` and
`port_flops` from here.

`repro.launch.dryrun` is not imported: it sets XLA_FLAGS to 512 host
devices when imported. The reference's step is built here as its
`build_cell` builds it, without a mesh."""

from __future__ import annotations

import json

import jax
import pytest

from repro import configs as jconfigs
from repro.core.hloanalyze import analyze_hlo
from repro.kernels import ops as jops
from repro.models.registry import get_model as jget_model
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.core.opanalyze import analyze_step
from repro_torch.launch import dryrun


def ref_flops(arch: str, shape: str) -> float:
    """`analyze_hlo`'s FLOPs of the reference's smoke cell: its train step
    with AdamW, its prefill's logits or its decode step, jit-compiled on
    one CPU device with every kernel on "xla"."""
    before = jops._MODE
    jops.force_mode("xla")
    try:
        cfg = jconfigs.get_config(arch, smoke=True)
        model = jget_model(cfg)
        specs = jconfigs.input_specs(arch, shape, smoke=True)
        params = jax.eval_shape(lambda k: model.init(k, cfg),
                                jax.random.key(0))
        step = jconfigs.SHAPE_DEFS[shape]["step"]
        if step == "train":
            state = {"params": params,
                     "opt": jax.eval_shape(jinit_opt_state, params),
                     "rng": jax.eval_shape(
                         lambda: jax.random.key_data(jax.random.key(0)))}
            fn = jmake_train_step(model, cfg, JAdamWConfig())
            args = (state, specs)
        elif step == "prefill":
            def fn(p, b):
                return model.prefill(p, b, cfg)[0]

            args = (params, specs)
        else:
            def fn(p, t, s):
                return model.decode_step(p, t, s, cfg)

            args = (params, specs["token"], specs["state"])
        hlo = jax.jit(fn).lower(*args).compile().as_text()
    finally:
        jops.force_mode(before)
    return analyze_hlo(hlo, 1).flops


def port_flops(arch: str, shape: str):
    """The port's smoke cell (the dry-run's step on meta): its
    `StepCost`."""
    fn, args, _ = dryrun.build_cell(
        arch, shape, cfg=configs.get_config(arch, smoke=True),
        specs=configs.input_specs(arch, shape, smoke=True))
    return analyze_step(fn, *args)


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-7b", "train_4k"), ("qwen2.5-14b", "train_4k"),
    ("codeqwen1.5-7b", "train_4k"), ("starcoder2-3b", "train_4k"),
    ("qwen2-7b", "prefill_32k"), ("qwen2-7b", "decode_32k")])
def test_dot_flops_equal_the_reference(arch, shape):
    """The dense smoke cells compute the same products in both packages:
    the dot FLOPs are equal exactly (the GEMMs through the kernel's meta
    records, attention through aten's bmm)."""
    cost = port_flops(arch, shape)
    assert cost.flops == ref_flops(arch, shape)
    assert cost.gemm_flops > 0 and cost.flops > cost.gemm_flops


@pytest.mark.parametrize("arch,shape", configs.all_cells())
def test_model_flops_and_tokens_follow_the_reference(arch, shape):
    """(6 if training else 2) x active params x tokens, one token a row
    for decode (the reference's `run_cell`)."""
    d = jconfigs.SHAPE_DEFS[shape]
    tokens = d["global_batch"] * (d["seq_len"] if d["step"] != "decode"
                                  else 1)
    want = ((6 if d["step"] == "train" else 2)
            * jconfigs.get_config(arch).n_active_params() * tokens)
    assert dryrun.model_flops(configs.get_config(arch), shape) == (want,
                                                                   tokens)


# the reference's JSON keys that only XLA has (`launch/dryrun.py`'s
# docstring), and the keys the port adds
XLA_ONLY = {"lower_s", "compile_s", "while_trip_counts",
            "xla_cost_analysis_flops_raw", "xla_cost_analysis_bytes_raw"}
REFERENCE_KEYS = {
    "arch", "shape", "variant", "mesh", "n_chips", "step", "lower_s",
    "compile_s", "flops_per_chip", "bytes_per_chip",
    "collective_wire_bytes_per_chip", "collective_wire_bytes_by_op",
    "while_trip_counts", "xla_cost_analysis_flops_raw",
    "xla_cost_analysis_bytes_raw", "model_flops", "tokens_per_step",
    "memory_analysis"}
ADDED = {"build_s", "analyze_s", "roofline", "gemms", "gemm_flops", "n_ops"}


def test_run_cell_writes_the_reference_keys(tmp_path):
    """A full-width, full-depth cell on meta: one JSON with the
    reference's keys less the XLA-only ones, its GEMMs all on the fast
    paths (197 launches of qwen2-7b's decode step), a memory-bound bound
    over the weights' bytes."""
    r = dryrun.run_cell("qwen2-7b", "decode_32k", out_dir=tmp_path)
    path = tmp_path / "h100x1" / "qwen2-7b_decode_32k.json"
    assert json.loads(path.read_text()) == r
    assert set(r) == (REFERENCE_KEYS - XLA_ONLY) | ADDED
    assert set(r["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes"}
    assert r["mesh"] == "h100x1" and r["n_chips"] == 1
    assert r["collective_wire_bytes_per_chip"] == 0.0
    assert {p: g["launches"] for p, g in r["gemms"].items()} == {
        "wgmma": 197}
    cfg = configs.get_config("qwen2-7b")
    weights = 2 * cfg.n_params()
    assert r["memory_analysis"]["argument_size_in_bytes"] > weights
    assert r["roofline"]["dominant"] == "memory"
    assert r["roofline"]["bound_s"] > weights / 3.35e12
    # a second call reads the file
    assert dryrun.run_cell("qwen2-7b", "decode_32k", out_dir=tmp_path) == r


@pytest.mark.parametrize("variant", ["tpx", "kv_batch", "moe_smap"])
def test_honoured_variants_run_on_the_mesh(variant, tmp_path):
    """``tpx``, ``kv_batch`` and ``moe_smap`` run a full-size decode cell
    on the 16x16 mesh. ``tpx`` is the port's own psum mode: its artifact
    is the default cell's but for ``variant`` and the times. ``kv_batch``
    cuts the cache on the batch alone: qwen2-7b's 4 KV heads do not divide
    tp = 16, so the default's sequence cut over "model" is a departure and
    kv_batch's is not."""
    arch = "olmoe-1b-7b" if variant == "moe_smap" else "qwen2-7b"
    assert dryrun.main(["--arch", arch, "--shape", "decode_32k", "--mesh",
                        "single", "--variant", variant, "--out",
                        str(tmp_path)]) == 0
    got = dryrun.run_cell(arch, "decode_32k", mesh="single",
                          variant=variant, out_dir=tmp_path)
    assert got["variant"] == variant and got["n_chips"] == 256
    assert got["collective_wire_bytes_per_chip"] > 0
    base = dryrun.run_cell(arch, "decode_32k", mesh="single",
                           out_dir=tmp_path)
    timing = {"variant", "build_s", "analyze_s", "roofline"}
    if variant == "tpx":
        assert ({k: v for k, v in got.items() if k not in timing}
                == {k: v for k, v in base.items() if k not in timing})
    if variant == "kv_batch":
        leaves = {d["leaf"] for d in base["departures"]}
        assert {"state/kv/k", "state/kv/v"} <= leaves
        assert not {"state/kv/k", "state/kv/v"} & {
            d["leaf"] for d in got["departures"]}


@pytest.mark.parametrize("variant", dryrun.SP_EP_VARIANTS)
def test_mesh_variants_wait_for_tensor_parallelism(variant, tmp_path):
    """The reference's Megatron-SP and experts-over-"data" variants,
    which waited for the port's sequence parallelism and experts over
    "data", run a full-size olmoe-1b-7b cell on the 16x16 mesh (a
    prefill; ``ep_data`` a decode step, which SP never takes): the SP
    variants post reduce-scatters, the experts-over-"data" ones
    all-to-alls. The rank holds every leaf as the reference's chip does
    but, under experts over "data", the three expert leaves: it holds
    them (E/dp, d, f/tp) as the reference's rules say, its compiled chip
    (E/tp, d, f), and ``departures`` lists them with that reason."""
    shape = "decode_32k" if variant == "ep_data" else "prefill_32k"
    assert dryrun.main(["--arch", "olmoe-1b-7b", "--shape", shape, "--mesh",
                        "single", "--variant", variant, "--out",
                        str(tmp_path)]) == 0
    got = dryrun.run_cell("olmoe-1b-7b", shape, mesh="single",
                          variant=variant, out_dir=tmp_path)
    assert got["variant"] == variant and got["n_chips"] == 256
    calls = got["collective_calls_by_op"]
    assert ("reduce-scatter" in calls) == ("sp" in variant)
    assert ("all-to-all" in calls) == ("ep_data" in variant)
    want = []
    if "ep_data" in variant:
        cfg = configs.get_config("olmoe-1b-7b")
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
        want = [{"leaf": f"blocks.*.moe.experts.{w}", "port": port,
                 "reference": ref, "reason": dryrun.EXPERTS_RESET}
                for w, port, ref in (
                    ("w_down", [E // 16, f // 16, d], [E // 16, f, d]),
                    ("w_gate", [E // 16, d, f // 16], [E // 16, d, f]),
                    ("w_up", [E // 16, d, f // 16], [E // 16, d, f]))]
    assert sorted(got["departures"], key=lambda r: r["leaf"]) == want


@pytest.mark.parametrize("variant", dryrun.FP8_VARIANTS)
def test_fp8_variants_are_refused(variant):
    with pytest.raises(ValueError, match="bf16"):
        dryrun.main(["--arch", "qwen2-7b", "--shape", "decode_32k",
                     "--variant", variant])


def test_main_runs_the_selected_cells(tmp_path, capsys):
    assert dryrun.main(["--arch", "starcoder2-3b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[ok] starcoder2-3b x decode_32k x h100x1" in out
    assert "all 1 dry-run cells passed" in out
