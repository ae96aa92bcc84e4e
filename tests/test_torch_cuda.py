"""The port on the card: the hand-written GEMM against its plain version,
and the smoke model and engine running through it.

Every test here needs an NVIDIA GPU and nvcc (the kernel builds at first
use) and skips elsewhere. Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.ref import matmul_ref
from repro_torch.kernels._build import load_library
from repro_torch.kernels.tiled_matmul import (_PATH_CODE, DEFAULT_CONFIG,
                                              BlockConfig, TILE_SHAPES, plan,
                                              tiled_matmul)
from repro_torch.models.bridge import params_from_numpy, params_to_numpy
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Request, ServingEngine

pytestmark = pytest.mark.cuda

# kernel vs plain version: f32 1e-5, bf16 2e-2 (the JAX package's kernel
# tests), absolute parts scaled by the output's largest magnitude since the
# two sum in different orders
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel runs only on the card")
    return torch.device("cuda")


def _assert_close(got, want, tol):
    scale = max(1.0, want.abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * scale)


FORCE = {"general": DEFAULT_CONFIG, "wgmma": BlockConfig(128, 128, 64),
         "split": BlockConfig(128, 128, 64), "stream": None}
# (path, m): shapes that land on each path; stream takes bf16 with
# untransposed operands, wgmma bf16 in the four layouts, the split pair one
# f32 and one bf16 operand in the four layouts, the general path every
# dtype and layout
PATH_CASES = ([("general", 70)]
              + [("stream", m) for m in (1, 5, 64)]
              + [("wgmma", m) for m in (65, 70, 200)]
              + [("split", m) for m in (8, 70, 200)])


def _path_of(fn):
    before = dict(tiled_matmul.launches_by_path)
    out = fn()
    torch.cuda.synchronize()
    moved = [p for p, n in tiled_matmul.launches_by_path.items()
             if n != before[p]]
    assert len(moved) == 1, moved
    return moved[0], out


def _cases():
    for path, m in PATH_CASES:
        layouts = ([(False, False)] if path == "stream" else
                   [(False, False), (False, True), (True, False), (True, True)])
        dtypes = {"general": [torch.float32, torch.bfloat16],
                  # the split pair: the operand that is f32
                  "split": ["a f32", "b f32"]}.get(path, [torch.bfloat16])
        for dtype in dtypes:
            for out_dtype in (torch.float32, torch.bfloat16):
                for ta, tb in layouts:
                    yield path, m, dtype, out_dtype, ta, tb


def _rows(shape, g, dev, dtype=torch.float32):
    """A random `dtype` view of rows padded to a multiple of 8 elements
    (16 bytes in bf16): the alignment the fast paths' transposed layouts
    need (a conversion after the slice would give unpadded rows)."""
    r, c = shape
    return torch.randn((r, -(-c // 8) * 8), generator=g,
                       device=dev).to(dtype)[:, :c]


@pytest.mark.parametrize("path,m,dtype,out_dtype,ta,tb", list(_cases()))
def test_kernel_matches_plain_version(dev, path, m, dtype, out_dtype, ta, tb):
    n, k = 200, 296                 # ragged against every tile; K = 4.6 K
    g = torch.Generator(dev).manual_seed(0)   # tiles, split where few tiles
    dta = dtb = dtype
    if path == "split":
        dta, dtb = ((torch.float32, torch.bfloat16) if dtype == "a f32"
                    else (torch.bfloat16, torch.float32))
    a = _rows((k, m) if ta else (m, k), g, dev, dta)
    b = _rows((n, k) if tb else (k, n), g, dev, dtb)
    c = torch.randn((m, n), generator=g, device=dev)
    before = tiled_matmul.launches
    took, got = _path_of(lambda: tiled_matmul(
        a, b, c, config=FORCE[path], transpose_a=ta, transpose_b=tb,
        alpha=0.5, beta=0.5, out_dtype=out_dtype))
    assert took == path
    assert tiled_matmul.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    want = matmul_ref(a, b, c.to(out_dtype), transpose_a=ta, transpose_b=tb,
                      alpha=0.5, beta=0.5, out_dtype=out_dtype)
    # f32 inputs with f32 out meet the f32 tolerance; so does the split
    # pair, which keeps the f32 product's accuracy
    f32_in = dtype in (torch.float32, "a f32", "b f32")
    _assert_close(got, want, TOL[torch.float32 if f32_in and out_dtype ==
                                 torch.float32 else torch.bfloat16])


def _meta_like(t):
    """A meta tensor with `t`'s shape, strides, offset and dtype."""
    base = torch.empty((t.untyped_storage().nbytes() // t.element_size(),),
                       dtype=t.dtype, device="meta")
    return base.as_strided(t.shape, t.stride(), t.storage_offset())


@pytest.mark.parametrize("forced", [False, True], ids=["plan", "forced"])
@pytest.mark.parametrize("path,m,dtype,out_dtype,ta,tb", list(_cases()))
def test_meta_record_is_the_launched_plan(dev, monkeypatch, forced, path, m,
                                          dtype, out_dtype, ta, tb):
    """The dry-run's record of a meta call (`record_meta`) carries the
    Plan the card launches for the same shapes, strides and tile: path,
    tile, CTA splits, K segments and layouts; the meta call launches
    nothing."""
    from repro_torch.kernels import tiled_matmul as tm

    n, k = 200, 296
    g = torch.Generator(dev).manual_seed(0)
    dta = dtb = dtype
    if path == "split":
        dta, dtb = ((torch.float32, torch.bfloat16) if dtype == "a f32"
                    else (torch.bfloat16, torch.float32))
    a = _rows((k, m) if ta else (m, k), g, dev, dta)
    b = _rows((n, k) if tb else (k, n), g, dev, dtb)
    kw = dict(config=FORCE[path] if forced else None, transpose_a=ta,
              transpose_b=tb, out_dtype=out_dtype)
    launched = []
    real = tm._launch
    monkeypatch.setattr(tm, "_launch", lambda *args: (
        launched.append(args[12]), real(*args))[1])
    tiled_matmul(a, b, **kw)
    torch.cuda.synchronize()
    before = (tiled_matmul.launches, dict(tiled_matmul.launches_by_path))
    with tm.record_meta() as log:
        out = tiled_matmul(_meta_like(a), _meta_like(b), **kw)
    assert (tiled_matmul.launches, tiled_matmul.launches_by_path) == before
    assert out.device.type == "meta" and tuple(out.shape) == (m, n)
    recs = [r for r in log if r.path != "split3"]
    assert len(launched) == 1 and len(recs) == 1
    assert recs[0].plan == launched[0]
    assert recs[0].path == launched[0].path


@pytest.mark.parametrize("path", ["general", "stream", "wgmma"])
@pytest.mark.parametrize("m,n,k,view", [
    (64, 256, 512, False),      # contiguous, aligned: 16-byte vector tiles
    (70, 203, 293, True),       # views of wider rows: ragged last vectors
    (5, 152, 3584, False),      # decode-like: few rows, deep K, split K
    (8, 3584, 3584, False),     # a decode projection, split K
    (256, 3584, 3584, False),   # a chunk projection
])
def test_kernel_vector_tiles_match_plain_version(dev, path, m, n, k, view):
    if path == "stream" and m > 64:
        m = 64                  # the stream path holds at most 64 rows
    g = torch.Generator(dev).manual_seed(1)
    pad = (3, 5) if view else (0, 0)
    a = torch.randn((m, k + pad[0]), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((k, n + pad[1]), generator=g, device=dev).to(torch.bfloat16)
    # views keep row strides that are multiples of 8 while the shapes end
    # mid-vector
    a, b = a[:, :k], b[:, :n]
    assert a.stride(0) % 8 == 0 and b.stride(0) % 8 == 0
    cfg = FORCE[path] if path != "stream" or m > 64 else None
    took, got = _path_of(lambda: tiled_matmul(a, b, config=cfg,
                                              out_dtype=torch.float32))
    assert took == path
    want = matmul_ref(a, b, out_dtype=torch.float32)
    _assert_close(got, want, TOL[torch.bfloat16])


@pytest.mark.parametrize("m,n,k", [(4, 512, 3584), (8, 3584, 18944),
                                   (64, 200, 296), (128, 520, 3584),
                                   (512, 3584, 3584)])
def test_fast_paths_are_bit_identical_run_to_run(dev, m, n, k):
    """Split K is reduced in a fixed order: two launches on the same inputs
    give the same bits."""
    g = torch.Generator(dev).manual_seed(2)
    a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(
        torch.bfloat16)
    p = plan(m, n, k, a.stride(), b.stride(), 0, 0, a.dtype, a.dtype)
    assert p.path in ("stream", "wgmma")
    first = tiled_matmul(a, b)
    second = tiled_matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("layout", ["nt", "tn", "tt", "split a", "split b"])
@pytest.mark.parametrize("m,n,k", [(129, 520, 3584), (512, 3072, 4096)])
def test_transposed_layouts_and_split_pair_are_bit_identical_run_to_run(
        dev, layout, m, n, k):
    """wgmma's transposed layouts and the split pair at split-K and
    training-like shapes: two launches on the same inputs give the same
    bits."""
    from repro_torch.kernels.tiled_matmul import split3

    g = torch.Generator(dev).manual_seed(8)
    ta, tb = layout in ("tn", "tt", "split b"), layout in ("nt", "tt")
    dta = torch.float32 if layout == "split a" else torch.bfloat16
    dtb = torch.float32 if layout == "split b" else torch.bfloat16
    a = _rows((k, m) if ta else (m, k), g, dev, dta)
    b = _rows((n, k) if tb else (k, n), g, dev, dtb)
    a = split3(a) if layout == "split a" else a
    b = split3(b) if layout == "split b" else b
    run = lambda: tiled_matmul(a, b, transpose_a=ta,  # noqa: E731
                               transpose_b=tb, out_dtype=torch.bfloat16)
    took, first = _path_of(run)
    assert took == ("split" if layout.startswith("split") else "wgmma")
    assert torch.equal(first, run())


@pytest.mark.parametrize("r,c", [(37, 203), (4096, 49152)])
def test_split3_kernel_is_bit_equal_to_its_plain_version(dev, r, c):
    """The split kernel and `split3_ref` do the same roundings: the same
    bits, and the three terms add up to the f32 matrix exactly."""
    from repro_torch.kernels.ref import split3_ref
    from repro_torch.kernels.tiled_matmul import split3

    g = torch.Generator(dev).manual_seed(9)
    x = torch.randn((r, c + 24), generator=g, device=dev)[:, :c] * 4.0
    before = split3.launches
    s = split3(x)
    assert split3.launches == before + 1
    assert s.terms.stride(1) % 8 == 0 and s.terms.data_ptr() % 16 == 0
    assert torch.equal(s.terms, split3_ref(x))
    assert torch.equal(s.terms.double().sum(0), x.double())


# (N, K) of serving projections: qwen2-7b's five (the LM head with f32
# out), olmoe-1b-7b's router (f32 out) and attention, deepseek-v2-236b's
# MLA projections and router; and a ragged one
ROW_INVARIANCE_NK = [
    (512, 3584, torch.bfloat16), (3584, 3584, torch.bfloat16),
    (18944, 3584, torch.bfloat16), (3584, 18944, torch.bfloat16),
    (152064, 3584, torch.float32), (64, 2048, torch.float32),
    (2048, 2048, torch.bfloat16), (160, 5120, torch.float32),
    (64, 5120, torch.bfloat16), (512, 5120, torch.bfloat16),
    (24576, 1536, torch.bfloat16), (16384, 512, torch.bfloat16),
    (5120, 16384, torch.bfloat16), (200, 296, torch.bfloat16)]


@pytest.mark.parametrize("n,k,out_dtype", ROW_INVARIANCE_NK)
def test_a_rows_bits_do_not_depend_on_m(dev, n, k, out_dtype):
    """The rows of an M = 4 call are bit-equal to the same rows inside
    M = 1, 8, 64, 65, 128 and 512 calls: across the stream tiles, the
    stream/wgmma boundary and the wgmma tiles, spread or walking (`plan`'s
    K segments depend on N and K only)."""
    g = torch.Generator(dev).manual_seed(3)
    a = torch.randn((512, k), generator=g, device=dev).to(torch.bfloat16)
    b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(
        torch.bfloat16)
    want = tiled_matmul(a[:4], b, out_dtype=out_dtype)
    for m in (1, 8, 64, 65, 128, 512):
        got = tiled_matmul(a[:m], b, out_dtype=out_dtype)
        r = min(m, 4)
        assert torch.equal(got[:r], want[:r]), m
    torch.cuda.synchronize()


# qwen2-7b's serving (N, K): q, k and v, o, gate and up, down, the head
TP_NK = [(3584, 3584, torch.bfloat16), (512, 3584, torch.bfloat16),
         (18944, 3584, torch.bfloat16), (3584, 18944, torch.bfloat16),
         (152064, 3584, torch.float32)]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("n,k,out_dtype", TP_NK)
def test_a_shards_columns_are_the_whole_products(dev, n, k, out_dtype, tp):
    """Tensor parallelism's bits: each rank's contiguous column shard of
    the weight (`sharding.local_copy`), whole and cut into the 4 column
    chunks `tp.row_parallel_gather` launches (views of the shard),
    launched with ``segments_n`` = N, gives bit for bit the same columns
    as the unsharded product, at M = 1, 4, 8, 64, 65 and 128."""
    from repro_torch.distributed.sharding import local_copy
    from repro_torch.distributed.tp import _n_chunks

    g = torch.Generator(dev).manual_seed(8)
    a = torch.randn((128, k), generator=g, device=dev).to(torch.bfloat16)
    b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(
        torch.bfloat16)
    want = {m: tiled_matmul(a[:m], b, out_dtype=out_dtype)
            for m in (1, 4, 8, 64, 65, 128)}
    for rank in range(tp):
        w = local_copy(b, 1, rank, tp)
        n_loc = w.shape[1]
        for chunks in (1, 4):
            c = _n_chunks(n_loc, chunks)
            width = n_loc // c
            for i in range(c):
                lo = rank * n_loc + i * width
                for m, full in want.items():
                    got = tiled_matmul(a[:m], w[:, i * width:(i + 1) * width],
                                       out_dtype=out_dtype, segments_n=n)
                    assert torch.equal(got, full[:, lo:lo + width]), \
                        (rank, chunks, i, m)
    torch.cuda.synchronize()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_a_ranks_scan_is_the_whole_scans(dev, kind, tp):
    """Tensor-parallel SSM serving's bits: a rank's Mamba1 channels
    (falcon-mamba-7b's 8192 of d_state 16) through `ssm.selective_scan`,
    and a rank's SSD heads (zamba2-2.7b's 80 of headdim 64, d_state 64)
    through `ssm.ssd_heads`, give bit for bit the whole scan's outputs and
    states for those channels or heads: a 64-token prefill chunk of
    right-padded rows from a carried state (the serve grain 8) and a
    single decode step, at batch 1 and 4."""
    from repro_torch.models import ssm

    g = torch.Generator(dev).manual_seed(11)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    bf16 = torch.bfloat16
    for nb in (1, 4):
        for S in (64, 1):
            lens = torch.randint(1, S + 1, (nb,), generator=g, device=dev)
            if kind == "mamba1":
                cfg = get_config("falcon-mamba-7b")
                n, ds = cfg.d_inner, cfg.ssm_state
                x, dt = rnd(nb, S, n, dtype=bf16), rnd(nb, S, n)
                s = {"dt_bias": rnd(n, dtype=bf16), "D": rnd(n),
                     "A_log": torch.log(torch.arange(
                         1, ds + 1, dtype=torch.float32,
                         device=dev)).expand(n, ds).contiguous()}
                Bm, Cm = rnd(nb, S, ds, dtype=bf16), rnd(nb, S, ds, dtype=bf16)
                h0 = rnd(nb, n, ds)
                mask = None if S == 1 else ssm._seq_mask(lens, S)

                def run(sl):
                    return ssm.selective_scan(
                        x[..., sl], dt[..., sl],
                        {k: v[sl] for k, v in s.items()}, Bm, Cm, h0[:, sl],
                        single_step=S == 1, seq_mask=mask,
                        chunk=ssm.SERVE_CHUNK)

                def part(out, sl):
                    return out[0][..., sl], out[1][:, sl]
            else:
                cfg = get_config("zamba2-2.7b")
                P, N = cfg.ssm_headdim, cfg.ssm_state
                n = cfg.d_inner // P
                xs, dt = rnd(nb, S, n, P, dtype=bf16), rnd(nb, S, n, dtype=bf16)
                s = {"dt_bias": rnd(n, dtype=bf16), "A_log": rnd(n) / 2,
                     "D": rnd(n)}
                Bm, Cm = rnd(nb, S, N, dtype=bf16), rnd(nb, S, N, dtype=bf16)
                h0 = rnd(nb, n, N, P)

                def run(sl):
                    return ssm.ssd_heads(
                        xs[:, :, sl], dt[..., sl],
                        {k: v[sl] for k, v in s.items()}, Bm, Cm, h0[:, sl],
                        seq_lens=None if S == 1 else lens,
                        single_step=S == 1, chunk=ssm.SERVE_CHUNK)

                def part(out, sl):
                    return out[0][:, :, sl], out[1][:, sl]
            whole = run(slice(None))
            for r in range(tp):
                sl = slice(r * n // tp, (r + 1) * n // tp)
                for got, want in zip(run(sl), part(whole, sl)):
                    assert torch.equal(got, want), (nb, S, r)
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["mamba2", "mla_moe"])
def test_tp2_ranks_on_card_serve_tp1s_streams(dev, kind):
    """Two gloo rank processes on the one card (NCCL refuses two ranks on
    one device) serve the tensor-parallel CPU tests' smoke config of
    `kind` in bf16 at tp=2 (SSD heads, or MLA heads, experts and the
    shared experts' columns sharded) and give
    the tp=1 engine's streams on the card, token for token, on both
    ranks."""
    import sys
    from pathlib import Path

    from repro_torch.launch.mesh import Mesh, RankPool

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_tp_ranks as R

    from repro_torch.models.config import ModelConfig

    load_library()
    cfg = ModelConfig(**R.config_kw(kind, param_dtype="bfloat16",
                                    activation_dtype="bfloat16"))
    api = get_model(cfg)
    tree = params_to_numpy(api.init(cfg, torch.Generator().manual_seed(0),
                                    device="cpu"))
    reqs = R.requests(kind, cfg.d_model, cfg.vocab)
    engine = dict(max_batch=2, max_len=64)
    one = R.serve(Mesh(None, 0, 1), cfg, tree, reqs, engine, 1, "cuda")
    with RankPool(2, backend="gloo", timeout_s=300) as pool:
        ranks = pool.run(R.serve, cfg, tree, reqs, engine, 1, "cuda")
    for out in ranks:
        assert out["streams"] == one["streams"]
        assert out["report"]["tp"] == 2
    assert ranks[0]["params"]["embed.table"] == (cfg.vocab // 2, cfg.d_model)


def test_tp2_column_and_row_backward_on_card_give_tp1s_gradients(dev):
    """Psum mode's autograd collectives at tp=2 (two gloo rank processes
    on the one card): a column-parallel product entered through
    `tp.copy_to_model`, GELU and a row-parallel product, in bf16; the
    output and the gradients of the input (summed over "model" at the
    block's entry) and of both weights (each rank's shard, gathered) equal
    tp=1's through the kernel within the bf16 tolerance (a psum
    re-associates the sum of bf16 partials), every launch on wgmma."""
    import sys
    from pathlib import Path

    from repro_torch.launch.mesh import Mesh, RankPool

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_tp_train_ranks as R

    load_library()
    rng = np.random.default_rng(2)
    arrays = {"x": rng.normal(size=(256, 512)),
              "w_up": rng.normal(size=(512, 1024)) / 512 ** 0.5,
              "w_down": rng.normal(size=(1024, 512)) / 1024 ** 0.5,
              "cot": rng.normal(size=(256, 512))}
    one = R.block_grads(Mesh(None, 0, 1), arrays, "cuda")
    with RankPool(2, backend="gloo", timeout_s=300) as pool:
        ranks = pool.run(R.block_grads, arrays, "cuda")
    for out in (one, *ranks):
        assert out["launches"]["wgmma"] == 6, out["launches"]
        assert sum(out["launches"].values()) == 6, out["launches"]
    for out in ranks:
        for k in ("y", "gx", "w_up", "w_down"):
            err = np.abs(out[k] - one[k]).max() / np.abs(one[k]).max()
            assert err <= 2e-2, (k, err)


@pytest.mark.parametrize("m", [1, 4, 8, 9, 64])
@pytest.mark.parametrize("n,k", [(65024, 4096), (200, 296)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_transpose_b_stream_matches_plain_version(dev, m, n, k, out_dtype):
    """A tied LM head's layout, B stored (N, K) K-contiguous, on stream
    (ragged N and K included): the plain version's result, bit-identical
    over two launches, and bit-equal to the (K, N) layout's."""
    g = torch.Generator(dev).manual_seed(6)
    a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    table = (torch.randn((n, k), generator=g, device=dev) / k ** 0.5).to(
        torch.bfloat16)
    run = lambda: tiled_matmul(a, table, transpose_b=True,  # noqa: E731
                               out_dtype=out_dtype)
    took, got = _path_of(run)
    assert took == "stream"
    want = matmul_ref(a, table, transpose_b=True, out_dtype=out_dtype)
    _assert_close(got, want, TOL[torch.bfloat16])
    assert torch.equal(got, run())
    assert torch.equal(got, tiled_matmul(a, table.T.contiguous(),
                                         out_dtype=out_dtype))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_transpose_b_rows_bits_do_not_depend_on_m(dev, out_dtype):
    """On the (N, K) layout the rows of an M = 4 call are bit-equal to the
    same rows of M = 1, 8 and 64 calls."""
    g = torch.Generator(dev).manual_seed(7)
    n, k = 65024, 4096
    a = torch.randn((64, k), generator=g, device=dev).to(torch.bfloat16)
    table = (torch.randn((n, k), generator=g, device=dev) / k ** 0.5).to(
        torch.bfloat16)
    want = tiled_matmul(a[:4], table, transpose_b=True, out_dtype=out_dtype)
    for m in (1, 8, 64):
        got = tiled_matmul(a[:m], table, transpose_b=True,
                           out_dtype=out_dtype)
        r = min(m, 4)
        assert torch.equal(got[:r], want[:r]), m
    torch.cuda.synchronize()


@pytest.mark.parametrize("H,KV,hd", [(32, 32, 80), (28, 4, 128),
                                     (40, 8, 128)])
def test_attention_row_does_not_depend_on_the_call(dev, H, KV, hd):
    """Row 0's attention output, at one position over the same keys, is the
    same bits in a decode step (1 query), 8- and 16-token chunks and a
    300-query prefill, at batch 1 to 8: cuBLAS sums a short call's dot
    products in another order, so the card pads short calls to
    `Q_MIN_CUDA` queries."""
    from repro_torch.models.layers import _sdpa

    g = torch.Generator(dev).manual_seed(8)
    q = torch.randn((8, 512, H, hd), generator=g, device=dev).to(
        torch.bfloat16)
    k = torch.randn((8, 512, KV, hd), generator=g, device=dev).to(
        torch.bfloat16)
    v = torch.randn((8, 512, KV, hd), generator=g, device=dev).to(
        torch.bfloat16)
    pos = 200
    want = _sdpa(q[:4, :300], k[:4], v[:4], causal=True, q_offset=0,
                 kv_len=300)[0, pos]
    for B in (1, 2, 3, 4, 8):
        for Sq in (1, 8, 16, 64):
            off = torch.full((B,), pos, device=dev)
            got = _sdpa(q[:B, pos:pos + Sq], k[:B], v[:B], causal=True,
                        q_offset=off, kv_len=off + Sq)[0, 0]
            assert torch.equal(got, want), (B, Sq)


def test_encoder_attention_row_does_not_depend_on_the_call(dev):
    """Non-causal attention over keys masked by a per-row `kv_len` (the
    encoder's, seamless-m4t-medium's 16 heads of 64) gives row 0 the same
    bits whatever the call's key count (its admission bucket, 8 to 512)
    and batch (1 to 8)."""
    from repro_torch.models.layers import _sdpa

    g = torch.Generator(dev).manual_seed(9)
    H, hd = 16, 64
    q, k, v = (torch.randn((8, 512, H, hd), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    for n in (6, 24, 200):
        lens = torch.randint(1, 513, (8,), generator=g, device=dev)
        want = None
        for sk in (8, 16, 32, 64, 128, 256, 512):
            if sk < n:
                continue
            for B in (1, 2, 3, 4, 8):
                kl = lens[:B].clamp(max=sk)
                kl[0] = n
                got = _sdpa(q[:B, :sk], k[:B, :sk], v[:B, :sk], causal=False,
                            kv_len=kl)[0, :n]
                if want is None:
                    want = got
                assert torch.equal(got, want), (n, sk, B)


def test_apply_mrope_on_card_matches_cpu(dev):
    """qwen2-vl-2b's M-RoPE (sections 16/24/24 of 128) on the card against
    the CPU at 1e-5: f32 angles, cos and sin may differ in the last bit."""
    from repro_torch.models.layers import apply_mrope

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 40, 12, 128)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 2048, (2, 40, 3)))
    want = apply_mrope(x, pos, 1e6, (16, 24, 24))
    got = apply_mrope(x.to(dev), pos.to(dev), 1e6, (16, 24, 24))
    _assert_close(got.cpu(), want, 1e-5)


def test_padded_head_takes_stream_and_keeps_a_rows_bits(dev):
    """seamless-m4t-medium's LM head (N = 256206, K = 1024, f32 out) on its
    padded rows (ldb 256208, `transformer.head_params`): ``stream``, against
    the plain version, and row 0-3's bits the same at M = 1, 4 and 64 (the
    split-K epilogue's scalar tail, N % 4 = 2)."""
    from repro_torch.models.transformer import head_params

    n, k = 256206, 1024
    w = head_params(dev, torch.bfloat16, k, n)["w"]
    assert w.stride() == (256208, 1)
    g = torch.Generator(dev).manual_seed(10)
    w.copy_(torch.randn((k, n), generator=g, device=dev) / k ** 0.5)
    a = torch.randn((64, k), generator=g, device=dev).to(torch.bfloat16)
    want4 = None
    for m in (1, 4, 64):
        p = plan(m, n, k, a.stride(), w.stride(), 0, 0, a.dtype,
                 torch.float32)
        assert p.path == "stream"
        before = tiled_matmul.launches_by_path["stream"]
        got = tiled_matmul(a[:m], w, out_dtype=torch.float32)
        assert tiled_matmul.launches_by_path["stream"] == before + 1
        _assert_close(got, matmul_ref(a[:m], w, out_dtype=torch.float32),
                      TOL[torch.float32])
        if m == 4:
            want4 = got
    assert torch.equal(got[:1], tiled_matmul(a[:1], w,
                                             out_dtype=torch.float32))
    assert torch.equal(got[:4], want4)


@pytest.mark.parametrize("d", [2048, 3584, 5120])
def test_rmsnorm_row_does_not_depend_on_the_row_count(dev, d):
    """rmsnorm gives row 0 the same bits at 1, 4, 16 and 512 rows: with the
    GEMM's row invariance, what keeps a request's stream independent of
    its batch on the card."""
    from repro_torch.models.layers import rmsnorm

    g = torch.Generator(dev).manual_seed(4)
    x = torch.randn((512, d), generator=g, device=dev).to(torch.bfloat16)
    p = {"scale": torch.ones(d, dtype=torch.bfloat16, device=dev)}
    want = rmsnorm(p, x[:1], 1e-6)[0]
    for m in (4, 16, 512):
        assert torch.equal(rmsnorm(p, x[:m], 1e-6)[0], want), m


def test_kernel_rejects_uncompiled_tiles(dev):
    a = torch.ones(8, 8, device=dev)
    with pytest.raises(ValueError, match="not compiled"):
        tiled_matmul(a, a, config=BlockConfig(32, 32, 32))


def test_fast_tile_rejects_what_its_path_cannot_take(dev):
    a = torch.ones(8, 64, device=dev)      # f32: general only
    with pytest.raises(ValueError, match="general path"):
        tiled_matmul(a, a.T.contiguous(), config=BlockConfig(128, 128, 64))


def test_block_config_smem_matches_the_kernel(dev):
    lib = load_library()
    for tile in TILE_SHAPES:
        cfg = BlockConfig(*tile)
        have = lib.repro_tiled_matmul_smem(_PATH_CODE[cfg.path], 1, *tile)
        assert have == cfg.smem_bytes(), tile


def _smoke_pair(dev):
    """The f32 smoke model on the CPU and the same weights on the card."""
    cfg = get_config("qwen2-7b", smoke=True)
    api = get_model(cfg)
    cpu = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, api, cpu, params_from_numpy(params_to_numpy(cpu), cfg, dev)


def test_smoke_model_on_card_matches_cpu(dev):
    """Two chunk calls and two decode steps: every projection a kernel
    launch on the card, the plain version on the CPU. f32 logits agree to
    1e-4 (the bf16 KV cache can flip one entry by a bf16 step)."""
    cfg, api, cpu, gpu = _smoke_pair(dev)
    rng = np.random.default_rng(0)
    states = {d: api.init_state(cfg, 3, 32, device=d) for d in ("cpu", dev)}
    before = tiled_matmul.launches
    for step in range(2):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 8)))
        lens = torch.tensor([8, 3, 0])
        out = {}
        for d, p in (("cpu", cpu), (dev, gpu)):
            out[d], states[d] = api.prefill_chunk(p, toks.to(d), lens.to(d),
                                                  states[d], cfg)
        _assert_close(out[dev].cpu(), out["cpu"], 1e-4)
    for step in range(2):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, 3))
        for d, p in (("cpu", cpu), (dev, gpu)):
            out[d], states[d] = api.decode_step(p, tok.to(d), states[d], cfg)
        _assert_close(out[dev].cpu(), out["cpu"], 1e-4)
    torch.cuda.synchronize()
    assert tiled_matmul.launches - before == 4 * (7 * cfg.n_layers + 1)


def test_engine_on_card_launches_the_kernel(dev):
    cfg, api, _, gpu = _smoke_pair(dev)
    eng = ServingEngine(api, gpu, cfg, max_batch=2, max_len=64,
                        chunk_tokens=16, device=dev)
    rng = np.random.default_rng(1)
    for uid in range(5):
        eng.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab, int(rng.integers(4, 40))).astype(np.int32),
            max_new_tokens=6))
    before = tiled_matmul.launches
    res = eng.run_until_empty()
    rep = eng.report()
    assert sorted(r.uid for r in res) == list(range(5))
    assert all(r.n_tokens == 6 for r in res)
    assert tiled_matmul.launches - before == (7 * cfg.n_layers + 1) * (
        rep["chunk_steps"] + rep["decode_steps"])


def test_engine_bf16_launches_take_the_fast_paths(dev):
    """The smoke engine with bf16 weights and activations: every projection
    takes the stream or the wgmma path, none the general one."""
    cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    api = get_model(cfg)
    params = api.init(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    eng = ServingEngine(api, params, cfg, max_batch=4, max_len=256,
                        chunk_tokens=128, device=dev)
    rng = np.random.default_rng(2)
    for uid in range(6):
        eng.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab, int(rng.integers(40, 200))).astype(np.int32),
            max_new_tokens=4))
    before = dict(tiled_matmul.launches_by_path)
    res = eng.run_until_empty()
    torch.cuda.synchronize()
    moved = {p: tiled_matmul.launches_by_path[p] - before[p] for p in before}
    rep = eng.report()
    assert sorted(r.uid for r in res) == list(range(6))
    assert moved["general"] == 0
    assert moved["stream"] > 0 and moved["wgmma"] > 0
    assert moved["stream"] + moved["wgmma"] == (7 * cfg.n_layers + 1) * (
        rep["chunk_steps"] + rep["decode_steps"])


# ---------------------------------------------------------------------------
# the paged KV cache on the card
# ---------------------------------------------------------------------------


def test_paged_cache_update_keeps_the_null_page_without_a_sync(dev):
    """Writes through a dead row, past a row's length and onto a null
    table entry are dropped: page 0 keeps its bytes, every other page
    equals the CPU's result, and the scatter makes no host sync."""
    from repro_torch.models import layers as L

    g = torch.Generator(dev).manual_seed(3)
    P, T, KV, hd = 9, 8, 2, 16
    pool = torch.randn((P, T, KV, hd), generator=g, device=dev).to(
        torch.bfloat16)
    upd = torch.randn((3, 12, KV, hd), generator=g, device=dev).to(
        torch.bfloat16)
    # row 0 live across a page boundary, row 1 dead (all null), row 2
    # running onto a null entry of its table
    table = torch.tensor([[1, 2, 3, 4], [0, 0, 0, 0], [5, 6, 0, 0]],
                         device=dev)
    index = torch.tensor([3, 0, 10], device=dev)
    lens = torch.tensor([12, 12, 9], device=dev)
    cpu = pool.cpu()
    L.paged_cache_update(cpu, upd.cpu(), table.cpu(), index.cpu(),
                         lens.cpu())
    page0 = pool[0].clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = L.paged_cache_update(pool, upd, table, index, lens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out is pool
    assert torch.equal(pool[0], page0)
    assert torch.equal(pool.cpu(), cpu)


def test_paged_engine_streams_equal_the_dense_engine_on_card(dev):
    """The smoke engine on the card over the paged KV layout, with and
    without prefix reuse, generates the dense layout's streams."""
    cfg, api, _, gpu = _smoke_pair(dev)
    rng = np.random.default_rng(4)
    shared = rng.integers(0, cfg.vocab, 20)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 3 + i)])
               if i % 2 == 0 else rng.integers(0, cfg.vocab, 6 + 3 * i)
               for i in range(7)]

    def serve(**kw):
        eng = ServingEngine(api, gpu, cfg, max_batch=2, max_len=64,
                            chunk_tokens=16, device=dev, **kw)
        out = {}
        for first, last in ((0, 1), (1, 7)):   # request 0 registers first
            for uid in range(first, last):
                eng.submit(Request(uid=uid, prompt=prompts[uid].astype(
                    np.int32), max_new_tokens=6))
            out.update({r.uid: r.tokens.tolist()
                        for r in eng.run_until_empty()})
        return out, eng.report()

    dense, _ = serve()
    for prefix_cache in (False, True):
        paged, rep = serve(kv_layout="paged", page_size=8,
                           prefix_cache=prefix_cache)
        assert paged == dense
        assert (rep["paging"]["prefix_hits"] > 0) == prefix_cache

# ---------------------------------------------------------------------------
# the paper's loop on the card: scorer, runner, tuned launches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def h100_table():
    from repro_torch.core.profiler import collect_dataset

    return collect_dataset(n_configs=600, seed=0, chip="h100")


@pytest.mark.parametrize("model", ("rf", "gbdt", "linreg", "stacking"))
def test_torch_scorer_on_card_is_bit_identical_to_numpy(dev, h100_table,
                                                         model):
    """float64 on the card: every family, descaling, exp and residual
    anchors included, gives numpy `predict`'s bits."""
    from repro_torch.core.mlperf.torchpredict import TorchEstimator
    from repro_torch.core.predictor import PerfPredictor

    pred = PerfPredictor(model=model, residual=True, fast=True,
                         chip="h100").fit(h100_table)
    X = np.stack([h100_table[k] for k in pred.feature_names], axis=1)
    got = pred.torch_predictor(device=dev, x64=True)(X)
    assert got.is_cuda and got.dtype == torch.float64
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  pred.predict_matrix(h100_table))
    Xs = pred.scaler.transform(X)
    np.testing.assert_array_equal(
        TorchEstimator(pred.model, x64=True, device=dev).predict(Xs),
        np.asarray(pred.model.predict(Xs)).reshape(len(Xs), -1))


def test_card_measure_fn_times_each_compiled_tile(dev):
    """A valid row, timed, for every compiled tile on a layout its path
    takes; an invalid row, launching nothing, for tiles that cannot take
    the config."""
    from repro_torch.core.hwsim import GemmConfig
    from repro_torch.core.profiler import card_measure_fn, tile_stages

    measure = card_measure_fn(device=dev, reps=3)
    assert measure.power_source == "model"
    for tile in TILE_SHAPES:
        general = BlockConfig(*tile).path == "general"
        cfg = GemmConfig(m=min(tile[0], 64), n=512, k=1024, block_m=tile[0],
                         block_n=tile[1], block_k=tile[2],
                         dtype="f32" if general else "bf16",
                         layout="tn" if general else "nn", alpha=0.5,
                         beta=1.0, stages=tile_stages(tile))
        before = tiled_matmul.launches
        tel = measure(cfg)
        assert tel.valid and np.isfinite(tel.runtime_ms), tile
        assert 0.0 < tel.runtime_ms < 50.0
        assert tel.tflops == pytest.approx(
            2 * cfg.m * cfg.n * cfg.k / tel.runtime_ms / 1e9)
        assert np.isfinite(tel.power_w) and tel.power_w > 0
        assert tiled_matmul.launches - before == 4   # warm-up + 3 runs
    before = tiled_matmul.launches
    for bad in (GemmConfig(m=65, n=512, k=1024, block_m=64, block_n=64,
                           block_k=64),                     # stream, M > 64
                GemmConfig(m=128, n=512, k=1024, block_m=128, block_n=128,
                           block_k=64, dtype="f32")):       # wgmma, f32
        tel = measure(bad)
        assert not tel.valid and np.isnan(tel.runtime_ms)
    assert tiled_matmul.launches == before


def test_matmul_launches_the_installed_winner(dev, h100_table):
    from repro_torch.core.autotuner import GemmAutotuner, set_tuner
    from repro_torch.core.predictor import PerfPredictor
    from repro_torch.kernels import ops

    g = torch.Generator(dev).manual_seed(0)
    a = torch.randn((64, 3584), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((3584, 512), generator=g, device=dev) / 60).to(
        torch.bfloat16)
    try:
        # a winner forced into the table: plan would take stream here
        ops._TUNED[(64, 512, 3584, torch.bfloat16, "runtime")] = \
            BlockConfig(128, 64, 64)
        before = dict(tiled_matmul.launches_by_path)
        got = ops.matmul(a, w)
        torch.cuda.synchronize()
        assert tiled_matmul.launches_by_path["wgmma"] == before["wgmma"] + 1
        _assert_close(got, matmul_ref(a, w), TOL[torch.bfloat16])
        # a tuner's winner, verified on the card, installed and launched
        ops._TUNED.clear()
        pred = PerfPredictor(model="rf", residual=True, fast=True,
                             chip="h100").fit(h100_table)
        set_tuner(GemmAutotuner(pred, chip="h100", device=dev,
                                verify_top_k=2))
        best = ops.warm_gemm_cache([(64, 512, 3584)], strict=True)[
            (64, 512, 3584)]
        assert ops._tuned_config(64, 512, 3584, torch.bfloat16) == best
        before = dict(tiled_matmul.launches_by_path)
        ops.matmul(a, w)
        torch.cuda.synchronize()
        assert tiled_matmul.launches_by_path[best.path] == \
            before[best.path] + 1
    finally:
        ops._TUNED.clear()
        set_tuner(None)


def test_power_window_of_a_large_gemm_reads_the_card(dev):
    """NVML on the card: one power window of a large bf16 GEMM reads
    between the idle power and 1.1 x the enforced limit, the energy counter
    only grows, and the power runner tags its rows "nvml". The busy window
    is the power runner's: given the card's limit, it runs on to one cycle
    of the card's power control if its 4 periods read above the limit."""
    from repro_torch.core import nvml
    from repro_torch.core.hwsim import GemmConfig
    from repro_torch.core.profiler import (card_measure_fn, graph_pump,
                                           probe_energy_period, time_ms)

    card = nvml.open_card(dev)
    limit = card.power_limit_w()
    assert 100.0 < limit <= 1000.0
    period = probe_energy_period(card, dev)
    assert 0.0 < period < 1.0
    reads = []

    def read():
        reads.append(card.energy_mj())
        return reads[-1]

    idle = nvml.measure_window(read, lambda: 0, period_s=period)
    g = torch.Generator(dev).manual_seed(0)
    a = torch.randn((4096, 4096), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((4096, 4096), generator=g, device=dev).to(torch.bfloat16)
    fn = lambda: tiled_matmul(a, b)
    ms = time_ms(fn, torch.empty(2 ** 28, dtype=torch.uint8, device=dev), 3)
    pump, per_unit = graph_pump(fn, ms)
    busy = nvml.measure_window(read, pump, period_s=period, limit_w=limit)
    torch.cuda.synchronize()
    assert 0.0 < idle.watts < busy.watts < 1.1 * limit
    assert busy.seconds >= nvml.window_seconds(period) - period
    assert busy.units * per_unit * ms / 1e3 > 0.9 * busy.seconds
    assert all(x <= y for x, y in zip(reads, reads[1:]))
    measure = card_measure_fn(device=dev, power=True, period_s=period)
    assert measure.power_source == "nvml"
    tel = measure(GemmConfig(m=2048, n=4096, k=4096, block_m=128,
                             block_n=256, block_k=64, stages=4))
    assert idle.watts < tel.power_w < 1.1 * limit
    assert tel.energy_j == pytest.approx(tel.power_w * tel.runtime_ms / 1e3)
    assert np.isfinite(tel.temperature_c) and not tel.launch_bound


@pytest.mark.parametrize("arch,per_forward", [("falcon-mamba-7b", 4 * 2 + 1),
                                              ("zamba2-2.7b",
                                               2 * 4 + 7 * 2 + 1)])
def test_ssm_smoke_models_on_card_match_cpu(dev, arch, per_forward):
    """The SSM and hybrid smoke models: two chunk calls (one row at 0
    tokens) and two decode steps on the card and on the CPU, the same
    weights; f32 logits agree to 1e-4, and every projection and head is a
    kernel launch on the card."""
    cfg = get_config(arch, smoke=True)
    api = get_model(cfg)
    cpu = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = params_from_numpy(params_to_numpy(cpu), cfg, dev)
    rng = np.random.default_rng(5)
    states = {d: api.init_state(cfg, 3, 32, device=d) for d in ("cpu", dev)}
    before = tiled_matmul.launches
    out = {}
    for _ in range(2):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 8)))
        lens = torch.tensor([8, 3, 0])
        for d, p in (("cpu", cpu), (dev, gpu)):
            out[d], states[d] = api.prefill_chunk(p, toks.to(d), lens.to(d),
                                                  states[d], cfg)
        _assert_close(out[dev].cpu(), out["cpu"], 1e-4)
    for _ in range(2):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, 3))
        for d, p in (("cpu", cpu), (dev, gpu)):
            out[d], states[d] = api.decode_step(p, tok.to(d), states[d], cfg)
        _assert_close(out[dev].cpu(), out["cpu"], 1e-4)
    torch.cuda.synchronize()
    assert tiled_matmul.launches - before == 4 * per_forward


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-2b"])
def test_admit_smoke_models_on_card_match_cpu(dev, arch):
    """The encdec and vlm smoke models: one admission (two rows, one vlm row
    text-only), two chunk calls (one row at 0 tokens) and two decode steps
    on the card and on the CPU, the same weights; f32 logits agree to 1e-4,
    and every projection of the admission, the chunks and the steps is a
    kernel launch on the card."""
    cfg = get_config(arch, smoke=True)
    api = get_model(cfg)
    cpu = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = params_from_numpy(params_to_numpy(cpu), cfg, dev)
    rng = np.random.default_rng(6)
    if cfg.kind == "encdec":
        extras = [{"src_embeds": rng.normal(size=(t, cfg.d_model)).astype(
            np.float32)} for t in (12, 5)]
    else:
        extras = [{"patch_embeds": rng.normal(size=(6, cfg.d_model)).astype(
            np.float32), "grid_hw": (2, 3)}, None]
    mlp = 3 if cfg.gated_mlp else 2
    per_forward = cfg.n_layers * (4 + mlp + (2 if cfg.kind == "encdec"
                                             else 0)) + 1
    per_admit = (cfg.n_encoder_layers * (4 + mlp) + 2 * cfg.n_layers
                 if cfg.kind == "encdec" else cfg.n_layers * (4 + mlp))
    before = tiled_matmul.launches
    states = {}
    for d, p in (("cpu", cpu), (dev, gpu)):
        # f32 caches: a bf16 cache rounds a key written and read in one
        # call on either side of a bf16 step where the card's and the CPU's
        # f32 sums differ in the last bit, which moves the logits past 1e-4
        st = api.init_state(cfg, 2, 32, device=d)
        st["kv"] = {k: v.float() for k, v in st["kv"].items()}
        states[d] = api.admit(p, api.pack_admit(cfg, extras, 2, 16, device=d),
                              st, cfg)
    out = {}
    for _ in range(2):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 8)))
        lens = torch.tensor([8, 0])
        for d, p in (("cpu", cpu), (dev, gpu)):
            out[d], states[d] = api.prefill_chunk(p, toks.to(d), lens.to(d),
                                                  states[d], cfg)
        _assert_close(out[dev].cpu(), out["cpu"], 1e-4)
    for _ in range(2):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, 2))
        for d, p in (("cpu", cpu), (dev, gpu)):
            out[d], states[d] = api.decode_step(p, tok.to(d), states[d], cfg)
        _assert_close(out[dev].cpu(), out["cpu"], 1e-4)
    torch.cuda.synchronize()
    assert tiled_matmul.launches - before == per_admit + 4 * per_forward


# ---------------------------------------------------------------------------
# the fleet scheduler and fault recovery on the card
# ---------------------------------------------------------------------------


def _bf16_smoke(dev):
    """The smoke config in bf16 (its projections take the fast paths) with
    random weights on the card, and a seeded workload of 7 requests."""
    cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    api = get_model(cfg)
    params = api.init(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(8)
    reqs = [(uid, rng.integers(0, cfg.vocab, int(rng.integers(4, 70))
                               ).astype(np.int32), int(rng.integers(4, 24)))
            for uid in range(7)]
    return cfg, api, params, reqs


def _bf16_engine(dev, cfg, api, params, **kw):
    kw.setdefault("max_batch", 2)
    return ServingEngine(api, params, cfg, max_len=128, chunk_tokens=32,
                         device=dev, **kw)


def _streams(eng, reqs) -> dict:
    for uid, prompt, mnt in reqs:
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=mnt))
    return {r.uid: r.tokens.tolist() for r in eng.run_until_empty()}


def test_fleet_streams_do_not_depend_on_the_member(dev):
    """A two-member fleet on one set of bf16 weights (one member priced on
    the h100, one on the RTX 4070): the fleet and each member alone give
    the streams of one engine serving alone."""
    from repro_torch.serving.scheduler import FleetScheduler, SLAClass

    cfg, api, params, reqs = _bf16_smoke(dev)
    want = _streams(_bf16_engine(dev, cfg, api, params), reqs)
    for route_to in (None, "h100", "ada"):
        sched = FleetScheduler(
            {name: _bf16_engine(dev, cfg, api, params, chip=chip)
             for name, chip in (("h100", "h100"), ("ada", "rtx4070"))},
            sla={"i": SLAClass("i", 1e-3)}, default_sla="i",
            route_to=route_to)
        for uid, prompt, mnt in reqs:
            sched.submit(Request(uid=uid, prompt=prompt, max_new_tokens=mnt))
        got = {r.uid: r.tokens.tolist() for r in sched.run_until_empty()}
        assert got == want, route_to
        if route_to is None:
            assert set(sched.routed_to.values()) == {"h100", "ada"}


def test_migrated_row_continues_bit_for_bit(dev):
    """Rows checkpointed off an engine of 2 slots mid-decode and adopted by
    one of 4 that is already decoding other rows (the rest replayed there)
    finish with the streams of an engine that never failed."""
    cfg, api, params, reqs = _bf16_smoke(dev)
    want = _streams(_bf16_engine(dev, cfg, api, params), reqs)
    src = _bf16_engine(dev, cfg, api, params)
    dst = _bf16_engine(dev, cfg, api, params, max_batch=4)
    for uid, prompt, mnt in reqs[:4]:
        src.submit(Request(uid=uid, prompt=prompt, max_new_tokens=mnt))
    for uid, prompt, mnt in reqs[4:]:
        dst.submit(Request(uid=uid, prompt=prompt, max_new_tokens=mnt))
    done = []
    for _ in range(3):
        done += dst.serve_step()
    while not (src._live and any(s is not None and len(s.tokens) > 2
                                 for s in src._live.slots)):
        done += src.serve_step()
    records = src.checkpoint_inflight()
    assert dst.state_compatible(src) and not src.has_work
    moved = 0
    for rec in records:
        if rec["state"] is not None:
            dst.adopt(rec)
            moved += 1
        else:
            rec["req"].replay = rec["tokens"] or None
            dst.submit(rec["req"])
    assert moved >= 1
    while dst.has_work:
        done += dst.serve_step()
    assert dst.report()["adopted_in"] == moved
    assert {r.uid: r.tokens.tolist() for r in done} == want


def test_replayed_request_equals_its_fault_free_stream(dev):
    """A request replayed with 20 emitted tokens (written back in chunks of
    32, where the first attempt wrote them one decode step at a time) gives
    its fault-free stream, the forced prefix first."""
    cfg, api, params, _ = _bf16_smoke(dev)
    prompt = np.random.default_rng(9).integers(0, cfg.vocab, 45).astype(
        np.int32)
    eng = _bf16_engine(dev, cfg, api, params)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=40))
    (ref,) = eng.run_until_empty()
    again = _bf16_engine(dev, cfg, api, params)
    again.submit(Request(uid=0, prompt=prompt, max_new_tokens=40,
                         replay=ref.tokens[:20].tolist()))
    out = []
    while again.has_work:
        out += again.serve_step()
    assert out[0].tokens.tolist() == ref.tokens.tolist()


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["da (N, K) B", "dW transposed A",
                                    "head f32 pair"])
def test_backward_layouts_match_the_plain_version(dev, layout):
    """`ops.matmul`'s backward at training shapes (M = 256 rows, M > 64):
    ``da`` reads the (K, N) weight as an (N, K) B, ``dW`` the activations as
    a transposed A, both on wgmma; the LM head's f32 cotangent is split
    once into three bf16 terms that feed both gradients on the split path.
    Each gradient is one launch, and equals `matmul_ref` on the same
    operands."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import split3

    g = torch.Generator(dev).manual_seed(3)
    m, k, n = 256, 192, 320
    head = layout == "head f32 pair"
    x = torch.randn((m, k), generator=g, device=dev).bfloat16()
    w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).bfloat16()
    x.requires_grad_(True)
    w.requires_grad_(True)
    out_dt = torch.float32 if head else torch.bfloat16
    out = ops.matmul(x, w, out_dtype=out_dt)
    dout = torch.randn((m, n), generator=g, device=dev).to(out_dt)
    before = dict(tiled_matmul.launches_by_path)
    splits = split3.launches
    dx, dw = torch.autograd.grad(out, [x, w], dout)
    torch.cuda.synchronize()
    moved = {p: tiled_matmul.launches_by_path[p] - before[p] for p in before}
    assert moved == {"general": 0, "stream": 0, "wgmma": 0 if head else 2,
                     "split": 2 if head else 0}
    assert split3.launches - splits == (1 if head else 0)
    assert dx.dtype == dw.dtype == torch.bfloat16
    cast = (lambda t: t.detach().float()) if head else (lambda t: t.detach())
    want_dx = matmul_ref(dout, cast(w), transpose_b=True,
                         out_dtype=torch.bfloat16)
    want_dw = matmul_ref(cast(x), dout, transpose_a=True,
                         out_dtype=torch.bfloat16)
    # both sum in f32 and round to bf16 once, in other orders
    _assert_close(dx, want_dx, TOL[torch.bfloat16])
    _assert_close(dw, want_dw, TOL[torch.bfloat16])


# the tensor-parallel training shards of the SSM and encoder-decoder
# families at full width: (K, N, the whole projection's N for its K
# segments, or None for a row shard)
FAMILY_SHARDS = {
    # falcon-mamba-7b's x_proj, rows cut: K = d_inner / tp, N = 256 + 2 x 16
    "mamba1 x_proj tp=2": (4096, 288, None),
    "mamba1 x_proj tp=4": (2048, 288, None),
    # zamba2-2.7b's in_proj cut by parts at tp=2: z and x 1280 each, B and C
    # 128 whole, dt 40, of the whole 5288 columns
    "mamba2 in_proj parts tp=2": (2560, 2728, 5288),
    # seamless-m4t-medium's cross-attention wo, rows cut: 8 of 16 heads
    "cross-attention wo tp=2": (512, 1024, None),
}


@pytest.mark.parametrize("case", sorted(FAMILY_SHARDS))
def test_family_shard_gemms_and_their_backward_match_the_plain_version(
        dev, case):
    """The shard shapes tensor-parallel training gives the SSM and
    encoder-decoder families (Mamba1's row-sharded x_proj at tp=2 and 4,
    Mamba2's in_proj cut by parts, the cross-attention's row-parallel wo)
    through `ops.matmul` over 512 rows: the forward, ``da`` and ``dW`` are
    each one launch on wgmma and equal `matmul_ref` within the bf16
    tolerance."""
    from repro_torch.kernels import ops

    k, n, whole = FAMILY_SHARDS[case]
    g = torch.Generator(dev).manual_seed(7)
    m = 512
    x = torch.randn((m, k), generator=g, device=dev).bfloat16()
    w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).bfloat16()
    x.requires_grad_(True)
    w.requires_grad_(True)
    before = dict(tiled_matmul.launches_by_path)
    out = ops.matmul(x, w, segments_n=whole)
    dout = torch.randn((m, n), generator=g, device=dev).bfloat16()
    dx, dw = torch.autograd.grad(out, [x, w], dout)
    torch.cuda.synchronize()
    moved = {p: tiled_matmul.launches_by_path[p] - before[p] for p in before}
    assert moved == {"general": 0, "stream": 0, "wgmma": 3, "split": 0}
    tol = TOL[torch.bfloat16]
    _assert_close(out, matmul_ref(x.detach(), w.detach()), tol)
    _assert_close(dx, matmul_ref(dout, w.detach(), transpose_b=True), tol)
    _assert_close(dw, matmul_ref(x.detach(), dout, transpose_a=True), tol)


def _train_smoke(dev):
    """starcoder2-3b's smoke config in bf16 (its forward takes the fast
    paths, its backward the general one) and a seeded data set."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset

    cfg = dataclasses.replace(get_config("starcoder2-3b", smoke=True),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16", remat=True)
    ds = SyntheticLMDataset(DataConfig(seq_len=64, global_batch=4,
                                       vocab=cfg.vocab, seed=0))
    return cfg, get_model(cfg), ds


def _train_state(dev, cfg, api, seed=0):
    from repro_torch.train.step import init_train_state

    return init_train_state(torch.Generator(dev).manual_seed(seed), api, cfg,
                            device=dev)


def _same_state(a, b):
    pa = dict(a["params"].named_parameters())
    pb = dict(b["params"].named_parameters())
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
        for k in ("master", "m", "v"):
            assert torch.equal(a["opt"][k][n], b["opt"][k][n]), (k, n)
    assert torch.equal(a["opt"]["step"], b["opt"]["step"])


def test_two_identical_train_steps_give_the_same_bits(dev):
    """Two states from one seed take two steps each on the same batches:
    every gradient path (the kernel's forward, its recompute under remat,
    both backward GEMMs, the embedding gather's backward) is
    deterministic, so losses, params and optimizer state agree bit for
    bit. Each step launches the 6 L + 1 forward GEMMs, the 6 L of the
    recompute and the blocks' 2 x 6 L gradients on ``wgmma``, and the
    head's f32 pair on ``split``; none on ``general``."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step

    cfg, api, ds = _train_smoke(dev)
    step = make_train_step(api, cfg, AdamWConfig(lr=1e-3, warmup_steps=1))
    states = [_train_state(dev, cfg, api) for _ in range(2)]
    losses = [[], []]
    for s in range(2):
        for i in range(2):
            before = dict(tiled_matmul.launches_by_path)
            states[i], m = step(states[i], ds.batch_at(s))
            losses[i].append(float(m["loss"]))
            moved = {p: tiled_matmul.launches_by_path[p] - before[p]
                     for p in before}
            fwd = 6 * cfg.n_layers + 1
            assert moved["wgmma"] == fwd + 6 * cfg.n_layers + 2 * (fwd - 1)
            assert moved["split"] == 2
            assert moved["general"] == 0 and moved["stream"] == 0
    assert losses[0] == losses[1]
    assert all(np.isfinite(losses[0]))
    _same_state(states[0], states[1])


def test_a_resumed_run_equals_an_uninterrupted_one_on_the_card(dev,
                                                               tmp_path):
    """4 steps against 2 steps, a checkpoint, a restore into a fresh state
    and 2 more, through the port's loop: bit for bit."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import DataLoader
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import (LoopConfig, resume_or_init,
                                        run_train_loop)
    from repro_torch.train.step import make_train_step

    cfg, api, ds = _train_smoke(dev)
    step = make_train_step(api, cfg, AdamWConfig(lr=1e-3, warmup_steps=1))

    def run(d, steps, total, seed=0, every=100):
        ckpt = CheckpointManager(str(tmp_path / d))
        loader = DataLoader(ds)
        state, start = resume_or_init(
            ckpt=ckpt, loader=loader,
            init_fn=lambda: _train_state(dev, cfg, api, seed))
        return run_train_loop(
            train_step=step, state=state, loader=loader, ckpt=ckpt,
            loop_cfg=LoopConfig(total_steps=min(total, start + steps),
                                ckpt_every=every, log_every=1000),
            start_step=start, log_fn=lambda s: None,
            install_signal_handlers=False)

    whole, s_whole = run("a", 4, 4)
    _, s1 = run("b", 2, 4, every=2)
    resumed, s2 = run("b", 2, 4, seed=5)
    _same_state(resumed, whole)
    assert (list(s1["loss_curve"]) + list(s2["loss_curve"])
            == list(s_whole["loss_curve"]))


@pytest.mark.parametrize("arch,per_forward,f32_outs", [
    ("zamba2-2.7b", 2 * 4 + 2 * 7 + 1, 1),    # in/out_proj, 2 shared, head
    ("olmoe-1b-7b", 5 * 2 + 1, 2 + 1)])       # q, k, v, o, router; head
def test_family_gradients_through_the_kernel_match_the_plain_version(
        dev, arch, per_forward, f32_outs):
    """A bf16 smoke model of another family than dense, remat on, over
    4 x 64 tokens (every product at M > 64): the hybrid's Mamba2 blocks
    and its shared block (reused, so its gradient sums over both groups),
    or the MoE blocks' router (f32 logits, an f32 backward pair). Every
    gradient leaf through the kernel is within phase 15's relative L2 of
    5e-2 of the plain version's, and the step's launches are the forward
    on ``wgmma``, its recompute (all but the head) too, two gradients per
    bf16-out product on ``wgmma`` and the f32-out products' (the head, the
    routers) on ``split``; none on ``general``."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16", remat=True)
    api = get_model(cfg)
    params = _train_state(dev, cfg, api)["params"]
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             SyntheticLMDataset(DataConfig(seq_len=64, global_batch=4,
                                           vocab=cfg.vocab)).batch_at(0)
             .items()}

    def grads():
        loss, _ = api.loss(params, batch, cfg)
        return loss.detach(), torch.autograd.grad(loss,
                                                  list(params.parameters()))

    before = dict(tiled_matmul.launches_by_path)
    loss, got = grads()
    torch.cuda.synchronize()
    moved = {p: tiled_matmul.launches_by_path[p] - before[p] for p in before}
    assert moved == {"stream": 0,
                     "wgmma": 2 * per_forward - 1 + 2 * (per_forward
                                                         - f32_outs),
                     "split": 2 * f32_outs, "general": 0}
    # the plain version: every product through matmul_ref, an f32
    # cotangent as it is (nothing split)
    split3 = ops.split3
    ops.tiled_matmul = lambda a, b, c=None, *, config=None, **kw: (
        matmul_ref(a, b, c, **kw))
    ops.split3 = lambda x: x
    try:
        want_loss, want = grads()
    finally:
        ops.tiled_matmul, ops.split3 = tiled_matmul, split3
    assert abs(loss.item() - want_loss.item()) <= 5e-2 * abs(want_loss.item())
    for (name, _), g, w in zip(params.named_parameters(), got, want):
        assert torch.isfinite(g).all(), name
        rel = ((g.float() - w.float()).norm()
               / w.float().norm().clamp_min(1e-30)).item()
        assert rel <= 5e-2, (name, rel)
