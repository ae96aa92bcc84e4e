"""The port's chip registry, simulator, features and profiler against the
JAX package's, on the CPU.

All of these are numpy copies: on the reference's chips ("tpu_v5e",
"rtx4070") every table must be bit-identical. The port adds the "h100"
spec, the torch feature grid the tuner ranks on a device (held against the
numpy feature builder bit for bit), the card's runner (which raises without
a card) and the H100 sweep (checked here for what it holds, since it only
runs on the card).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import itertools
import pathlib

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import chips as jchips
from repro.core import features as jfeatures
from repro.core import hwsim as jhwsim
from repro.core import profiler as jprofiler
from repro.kernels import ops as jops
from repro.models.config import gemm_shape_counts as jgemm_shape_counts
from repro_torch.configs import get_config
from repro_torch.core import chips, features, hwsim, profiler
from repro_torch.kernels import ops
from repro_torch.kernels.tiled_matmul import (TILE_PATHS, TILE_SHAPES,
                                              BlockConfig, plan)
from repro_torch.models.config import gemm_shape_counts

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_CHIPS = ("tpu_v5e", "rtx4070")


def _assert_tables_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


def _cfgs(pkg, n: int = 300, seed: int = 0):
    mod = jprofiler if pkg == "jax" else profiler
    return mod.sweep_configs(n_configs=n, seed=seed)


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_chip_specs_equal_the_reference(chip):
    assert (dataclasses.asdict(chips.get_chip(chip))
            == dataclasses.asdict(jchips.get_chip(chip)))


def test_h100_spec_and_torch_dtype_names():
    h = chips.get_chip("h100")
    assert h.name == "h100" and h.n_compute_units == 132
    assert h.peak_flops == {"bf16": 989e12, "f32": 67e12}
    assert h.hbm_bw == 3.35e12 and h.hbm_bytes == 80e9 and h.tdp_w == 700.0
    assert h.vmem_bytes == 227 * 1024 * 132
    assert "h100" in chips.available_chips()
    assert chips.canon_dtype(str(torch.bfloat16)) == "bf16"
    assert chips.canon_dtype(str(torch.float32)) == "f32"
    for name in ("bfloat16", "float32", "int8", "bf16"):
        assert chips.canon_dtype(name) == jchips.canon_dtype(name)
    assert chips.DTYPE_BYTES == jchips.DTYPE_BYTES
    with pytest.raises(ValueError, match="unknown chip"):
        chips.get_chip("bogus")


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_simulator_tables_are_bit_identical(chip):
    cfgs, jcfgs = _cfgs("torch"), _cfgs("jax")
    assert [c.key() for c in cfgs] == [c.key() for c in jcfgs]
    sim = hwsim.TpuGemmSimulator(chip=chip, seed=5)
    jsim = jhwsim.TpuGemmSimulator(chip=chip, seed=5)
    _assert_tables_equal(sim.analyze_batch(cfgs), jsim.analyze_batch(jcfgs))
    for _ in range(2):   # the RNG and thermal state walk alike
        _assert_tables_equal(sim.measure_batch(cfgs),
                             jsim.measure_batch(jcfgs))
    assert (dataclasses.asdict(sim.measure(cfgs[0]))
            == dataclasses.asdict(jsim.measure(jcfgs[0])))


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_collective_and_parked_costs_equal_the_reference(chip):
    asdict = dataclasses.asdict
    for tp, chunks in ((1, 1), (4, 1), (4, 4)):
        kw = dict(chip=chip, tp=tp, n_collectives=3, overlap_chunks=chunks,
                  compute_s=1e-4)
        assert (asdict(hwsim.collective_cost(3e6, **kw))
                == asdict(jhwsim.collective_cost(3e6, **kw)))
    assert (asdict(hwsim.parked_cost(2.5, chip=chip, n_chips=4))
            == asdict(jhwsim.parked_cost(2.5, chip=chip, n_chips=4)))


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_features_are_bit_identical(chip):
    cfgs, jcfgs = _cfgs("torch", seed=1), _cfgs("jax", seed=1)
    _assert_tables_equal(features.config_features_batch(cfgs, chip=chip),
                         jfeatures.config_features_batch(jcfgs, chip=chip))
    np.testing.assert_array_equal(features.features_matrix(cfgs, chip=chip),
                                  jfeatures.features_matrix(jcfgs, chip=chip))
    _assert_tables_equal(features.table_from_configs(cfgs, chip=chip),
                         jfeatures.table_from_configs(jcfgs, chip=chip))
    assert (features.config_features(cfgs[3], chip=chip)
            == jfeatures.config_features(jcfgs[3], chip=chip))
    assert features.NUMERIC_FEATURES == jfeatures.NUMERIC_FEATURES
    assert features.TARGETS == jfeatures.TARGETS


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_collect_dataset_is_bit_identical(chip):
    _assert_tables_equal(
        profiler.collect_dataset(n_configs=500, seed=2, chip=chip),
        jprofiler.collect_dataset(n_configs=500, seed=2, chip=chip))


@pytest.mark.parametrize("chip", REF_CHIPS + ("h100",))
@pytest.mark.parametrize("dtype", ("bf16", "f32"))
def test_torch_feature_grid_is_bit_identical_to_numpy(chip, dtype):
    """The grid the tuner ranks on a device, float64, against the numpy
    builder over the same candidate configs (ring depths per block)."""
    rng = np.random.default_rng(0)
    shapes = [tuple(int(x) for x in rng.integers(1, 20000, 3))
              for _ in range(12)] + [(4, 152064, 3584), (2048, 18944, 3584)]
    blocks = list(itertools.product((8, 64, 128, 512), (64, 256, 1024),
                                    (32, 128, 2048)))
    stages = [2 + i % 3 for i in range(len(blocks))]
    got, valid = features.graph_candidate_features(
        shapes, blocks, chip, dtype, device="cpu", stages=stages)
    cfgs = [hwsim.GemmConfig(m=m, n=n, k=k, block_m=b[0], block_n=b[1],
                             block_k=b[2], dtype=dtype, stages=s)
            for m, n, k in shapes for b, s in zip(blocks, stages)]
    want = features.features_matrix(cfgs, chip=chip)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.reshape(-1, got.shape[-1]).numpy(),
                                  want)
    f32, _ = features.graph_candidate_features(
        shapes, blocks, chip, dtype, device="cpu", stages=stages,
        float64=False)
    assert f32.dtype == torch.float32
    np.testing.assert_array_equal(f32.numpy(), got.numpy().astype(np.float32))
    # the validity mask is the reference's candidate rule
    vmem = hwsim.TpuGemmSimulator(chip=chip).analyze_batch(cfgs)["valid"]
    rule = np.array([b[0] <= 2 * max(8, -(-m // 8) * 8)
                     and b[1] <= 2 * max(128, -(-n // 128) * 128)
                     and b[2] <= 2 * max(128, -(-k // 128) * 128)
                     for m, n, k in shapes for b in blocks])
    np.testing.assert_array_equal(valid.reshape(-1).numpy(), rule & vmem)


def test_gemm_shape_counts_equal_the_reference():
    cfg, jcfg = get_config("qwen2-7b"), jget_config("qwen2-7b")
    for kw in ({}, {"head_tokens": 4}, {"head_tokens": 1}):
        for t in (0, 1, 4, 64, 2048):
            assert gemm_shape_counts(cfg, t, **kw) == jgemm_shape_counts(
                jcfg, t, **kw)
    with pytest.raises(NotImplementedError, match="dense"):
        gemm_shape_counts(dataclasses.replace(cfg, kind="mamba1"), 4)


@pytest.mark.parametrize("kw", (
    dict(max_batch=4, max_len=512, chunk_tokens=64),
    dict(max_batch=4, max_len=512, chunk_tokens=64, lane_width=8),
    dict(max_batch=2, max_len=64, chunk_tokens=64),
    dict(max_batch=3, max_len=128, chunk_tokens=32, include_slot_prefill=False),
))
def test_serving_gemm_fleet_equals_the_reference(kw):
    assert (ops.serving_gemm_fleet(get_config("qwen2-7b"), **kw)
            == jops.serving_gemm_fleet(jget_config("qwen2-7b"), **kw))


def test_paper_split_equals_the_reference():
    spec = importlib.util.spec_from_file_location(
        "bench_common", ROOT / "benchmarks" / "common.py")
    common = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(common)
    table = profiler.collect_dataset(n_configs=4000, seed=0, chip="tpu_v5e")
    for got, want in zip(profiler.paper_split(table),
                         common.paper_split(table)):
        _assert_tables_equal(got, want)
    tr, te = profiler.paper_split(table)
    assert len(tr["runtime_ms"]) == 2076 and len(te["runtime_ms"]) == 519


def test_h100_sweep_holds_the_compiled_tiles_at_their_ring_depths():
    cfgs = profiler.h100_sweep_configs()
    assert {(c.block_m, c.block_n, c.block_k) for c in cfgs} == set(
        TILE_SHAPES)
    for c in cfgs[:500]:
        tile = (c.block_m, c.block_n, c.block_k)
        assert c.stages == (2 if TILE_PATHS[tile] == "general" else 4)
    assert {c.m for c in cfgs} == set(profiler.H100_M_CHOICES)
    # the serving engine's rows and qwen2-7b's projections are swept
    assert {4, 8, 64, 128, 256, 512, 2048} <= {c.m for c in cfgs}
    nk = {(c.n, c.k) for c in cfgs if c.dtype == "bf16"}
    assert {(512, 3584), (3584, 3584), (18944, 3584), (3584, 18944),
            (152064, 3584)} <= nk
    for c in cfgs:
        assert 2 * c.m * c.n * c.k <= profiler.H100_MAX_FLOPS[c.dtype]
        if c.dtype == "f32":
            assert c.n in profiler.DIM_CHOICES and c.k in profiler.DIM_CHOICES
    assert len({c.layout for c in cfgs}) == 4
    assert len({(c.alpha, c.beta) for c in cfgs}) == 4
    assert cfgs == profiler.h100_sweep_configs()


def test_h100_sweep_has_the_rows_for_the_paper_split():
    """Enough configs that `plan` accepts (the card measures only those)
    for the paper's 2,076 / 519 split, on every path."""
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    paths = {}
    for c in profiler.h100_sweep_configs():
        ta, tb = c.layout[0] == "t", c.layout[1] == "t"
        try:
            p = plan(c.m, c.n, c.k, (1, c.m) if ta else (c.k, 1),
                     (1, c.k) if tb else (c.n, 1), 0, 0, dts[c.dtype],
                     dts[c.dtype], config=BlockConfig(c.block_m, c.block_n,
                                                      c.block_k))
        except ValueError:
            continue
        paths[p.path] = paths.get(p.path, 0) + 1
    assert sum(paths.values()) >= 2076 + 519
    assert set(paths) == {"stream", "wgmma", "general"}


def test_profile_configs_marks_a_modelled_power_source():
    """A runner that says its power is a model's tags every row so; rows
    it marks invalid are dropped, as the simulator path drops them."""
    sim = hwsim.TpuGemmSimulator(chip="h100", seed=0)
    cfgs = profiler.h100_sweep_configs()[:60]

    def measure(cfg):
        tel = hwsim.telemetry_row(sim.measure_batch([cfg]), 0)
        return dataclasses.replace(tel, valid=cfg.block_m != 8)

    measure.power_source = "model"
    table = profiler.profile_configs(cfgs, chip="h100", measure_fn=measure)
    n = sum(c.block_m != 8 for c in cfgs)
    assert len(table["runtime_ms"]) == n
    assert list(table["power_source"]) == ["model"] * n
    del measure.power_source
    assert "power_source" not in profiler.profile_configs(
        cfgs, chip="h100", measure_fn=measure)


def test_card_runner_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="GPU"):
        profiler.card_measure_fn()
    with pytest.raises(ValueError, match="cuda"):
        profiler.card_measure_fn(device="cpu")
