"""`core.opanalyze`, the port's counterpart of the JAX package's
`core.hloanalyze` (its tests are `tests/test_hloanalyze.py`): FLOPs, bytes
and launches counted as a step's ops run; the meta path of the
hand-written GEMM's wrappers (`kernels.tiled_matmul`); and
`core.roofline.roofline_from_cost`."""

from __future__ import annotations

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.opanalyze import (PEAK_F32_FLOPS, analyze_step,
                                        gemm_bound_s)
from repro_torch.core.roofline import CollectiveStats, roofline_from_cost
from repro_torch.kernels import ops
from repro_torch.kernels.tiled_matmul import (HBM_BYTES_PER_S,
                                              PEAK_BF16_FLOPS, Split3, plan,
                                              record_meta, split3,
                                              tiled_matmul)

BF16, F32 = torch.bfloat16, torch.float32
from repro_torch.models.layers import cache_update

M, K, N = 96, 256, 128


def _counts():
    return (tiled_matmul.launches, dict(tiled_matmul.launches_by_path),
            split3.launches)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_loop_of_n_matmuls_counts_n_times(device):
    w = torch.zeros((K, K), device=device)

    def f(x):
        for _ in range(5):
            x = x @ w
        return x

    cost = analyze_step(f, torch.zeros((M, K), device=device))
    assert cost.flops == 5 * 2 * M * K * K
    assert cost.gemm_flops == 0 and cost.gemms == {}


def test_checkpoint_counts_the_recompute():
    """A rematerialised block's forward runs again in the backward (the
    reference's test_grad_with_remat_counts_recompute)."""
    w1 = torch.zeros((K, K), device="meta", requires_grad=True)
    w2 = torch.zeros((K, K), device="meta", requires_grad=True)

    def block(x):
        return torch.tanh(x @ w1) @ w2

    def step(x, remat):
        y = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        y.sum().backward()

    x = torch.zeros((M, K), device="meta", requires_grad=True)
    plain = analyze_step(step, x, False).flops
    remat = analyze_step(step, x, True).flops
    gemm = 2 * M * K * K
    assert plain == 3 * 2 * gemm       # forward, and two products a GEMM
    # the backward recomputes what it saved: tanh(x @ w1), one product
    # (the non-reentrant checkpoint stops once the saved tensors are back)
    assert remat == plain + gemm


def test_a_gemms_bytes_are_a_b_and_out():
    a = torch.zeros((M, K), device="meta")
    b = torch.zeros((K, N), device="meta")
    cost = analyze_step(torch.mm, a, b)
    assert cost.hbm_bytes == 4 * (M * K + K * N + M * N)
    assert cost.argument_bytes == 4 * (M * K + K * N)
    assert cost.output_bytes == 4 * M * N
    assert cost.peak_live_bytes == 4 * (M * K + K * N + M * N)


def test_views_are_free():
    x = torch.zeros((8, 16, 32), device="meta")

    def views(x):
        return (x.view(8, 512), x.reshape(128, 32), x.transpose(0, 1),
                x[:, 3:5], x.unsqueeze(0), x.expand(2, 8, 16, 32)[0])

    cost = analyze_step(views, x)
    assert cost.hbm_bytes == 0 and cost.n_ops == 0 and cost.flops == 0


def test_a_broadcast_operand_counts_the_elements_it_holds():
    x = torch.zeros((64, 32), device="meta")
    row = torch.zeros((32,), device="meta")
    cost = analyze_step(torch.add, x, row)
    assert cost.hbm_bytes == 4 * (64 * 32 + 32 + 64 * 32)


@pytest.mark.parametrize("per_row", [False, True])
def test_a_kv_slice_write_charges_the_slice(per_row):
    """Writing S new positions into a (B, L, KV, hd) cache charges the
    update (read) and the slice (written), not the whole cache (the
    reference's test_kv_cache_dus_not_charged_full)."""
    B, L, S, KV, hd = 4, 4096, 2, 8, 128
    cache = torch.zeros((B, L, KV, hd), dtype=torch.bfloat16, device="meta")
    upd = torch.zeros((B, S, KV, hd), dtype=torch.bfloat16, device="meta")
    index = (torch.zeros((B,), dtype=torch.int64, device="meta") if per_row
             else 100)
    cost = analyze_step(cache_update, cache, upd, index)
    slice_bytes = 2 * B * S * KV * hd
    assert 2 * slice_bytes <= cost.hbm_bytes < 3 * slice_bytes
    assert cost.hbm_bytes < cache.numel() * 2 / 100


def test_meta_matmul_counts_once_under_plans_path_forward_and_backward():
    """A meta `ops.matmul` is the kernel's forward launch, and its
    backward the two gradient launches: 3 on ``plan``'s path (wgmma at
    M > 64), 3 x 2MNK FLOPs, counted once (no aten product besides)."""
    a = torch.zeros((M, K), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    w = torch.zeros((K, N), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)

    def step(a, w):
        ops.matmul(a, w).float().sum().backward()

    before = _counts()
    cost = analyze_step(step, a, w)
    assert _counts() == before            # a meta call is not a launch
    assert {p: g.launches for p, g in cost.gemms.items()} == {"wgmma": 3}
    assert cost.flops == cost.gemm_flops == 3 * 2 * M * N * K
    g = cost.gemms["wgmma"]
    bound = gemm_bound_s(M, N, K, a_dtype=BF16, b_dtype=BF16, out_dtype=BF16)
    assert g.bound_s == pytest.approx(3 * max(bound))


@pytest.mark.parametrize("m,k,n", [(M, K, N), (4, 3584, 152064)])
def test_a_bf16_product_with_f32_out_is_priced_by_hand(m, k, n):
    """A bf16 x bf16 -> f32 product (an LM head's logits; the second shape
    is qwen2-7b's decode head): A and B read at 2 bytes an element, the f32
    output written at 4, 2MNK at the bf16 tensor rate."""
    a = torch.zeros((m, k), dtype=BF16, device="meta")
    b = torch.zeros((k, n), dtype=BF16, device="meta")
    cost = analyze_step(lambda a, b: tiled_matmul(a, b, out_dtype=F32), a, b)
    (path, g), = cost.gemms.items()
    nbytes = 2 * m * k + 2 * k * n + 4 * m * n
    assert (g.launches, g.flops, g.bytes) == (1, 2.0 * m * n * k, nbytes)
    assert g.bound_s == pytest.approx(max(2 * m * n * k / PEAK_BF16_FLOPS,
                                          nbytes / HBM_BYTES_PER_S))
    assert cost.hbm_bytes == nbytes


@pytest.mark.parametrize("side", ["a", "b"])
def test_the_split_pair_is_priced_by_hand(side):
    """The split pair (one f32 operand, one bf16; f32 out): split3 reads
    the f32 matrix (4 bytes an element) and writes its three bf16 planes
    (6), the GEMM reads those planes (6), the bf16 operand (2) and writes
    the f32 output (4), at 2MNK on the bf16 tensor rate, not the f32
    rate."""
    a = torch.zeros((M, K), dtype=F32 if side == "a" else BF16,
                    device="meta")
    b = torch.zeros((K, N), dtype=BF16 if side == "a" else F32,
                    device="meta")
    cost = analyze_step(lambda a, b: tiled_matmul(a, b, out_dtype=F32), a, b)
    f32_elems = M * K if side == "a" else K * N
    bf16_elems = K * N if side == "a" else M * K
    assert {p: t.launches for p, t in cost.gemms.items()} == {
        "split3": 1, "split": 1}
    s3, pair = cost.gemms["split3"], cost.gemms["split"]
    assert (s3.flops, s3.bytes) == (0.0, 10 * f32_elems)
    assert s3.bound_s == pytest.approx(10 * f32_elems / HBM_BYTES_PER_S)
    nbytes = 6 * f32_elems + 2 * bf16_elems + 4 * M * N
    assert (pair.flops, pair.bytes) == (2.0 * M * N * K, nbytes)
    assert pair.bound_s == pytest.approx(max(2 * M * N * K / PEAK_BF16_FLOPS,
                                             nbytes / HBM_BYTES_PER_S))
    assert cost.hbm_bytes == 10 * f32_elems + nbytes


def test_an_f32_product_is_priced_at_the_f32_rate():
    ops_s, bytes_s = gemm_bound_s(M, N, K, a_dtype=F32, b_dtype=F32,
                                  out_dtype=F32, c=True)
    assert ops_s == 2 * M * N * K / PEAK_F32_FLOPS
    assert bytes_s == 4 * (M * K + K * N + 2 * M * N) / HBM_BYTES_PER_S


def test_meta_f32_out_product_backward_takes_the_split_pair():
    """The LM head's f32-out product: its backward splits the f32
    cotangent once (one split3) and takes the split pair twice."""
    a = torch.zeros((M, K), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    w = torch.zeros((K, N), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)

    def step(a, w):
        ops.matmul(a, w, out_dtype=torch.float32).sum().backward()

    cost = analyze_step(step, a, w)
    assert {p: g.launches for p, g in cost.gemms.items()} == {"wgmma": 1, "split": 2, "split3": 1}
    assert cost.gemms["split3"].flops == 0
    assert cost.gemms["split3"].bytes == 10 * M * N


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)])
@pytest.mark.parametrize("m,out_dtype", [(4, torch.bfloat16),
                                         (64, torch.float32),
                                         (200, torch.bfloat16)])
def test_meta_record_is_plans_choice(m, out_dtype, ta, tb):
    """A meta call records what `plan` gives the same shapes and strides,
    returns an empty meta result of the right shape and dtype, and moves
    no counter; the rows padded to 16 bytes as the port stores them."""
    n, k = 200, 296
    a = torch.empty((k, m) if ta else (m, k), dtype=torch.bfloat16,
                    device="meta")
    b = torch.empty((n, 304) if tb else (k, 200 + 8),
                    dtype=torch.bfloat16, device="meta")
    b = b[:, :k] if tb else b[:, :n]
    before = _counts()
    with record_meta() as log:
        out = tiled_matmul(a, b, transpose_a=ta, transpose_b=tb,
                           out_dtype=out_dtype)
    assert _counts() == before
    assert out.device.type == "meta" and out.dtype == out_dtype
    assert tuple(out.shape) == (m, n)
    (rec,) = log
    sa = a.stride()[::-1] if ta else a.stride()
    sb = b.stride()[::-1] if tb else b.stride()
    assert rec.plan == plan(m, n, k, sa, sb, 0, 0, torch.bfloat16, out_dtype)
    assert rec.path == rec.plan.path
    assert (rec.m, rec.n, rec.k) == (m, n, k)
    assert (rec.a_dtype, rec.b_dtype, rec.out_dtype, rec.c) == (
        BF16, BF16, out_dtype, False)


def test_meta_split3_records_and_pads_rows():
    x = torch.empty((37, 203), dtype=torch.float32, device="meta")
    before = _counts()
    with record_meta() as log:
        s = split3(x)
    assert _counts() == before
    assert isinstance(s, Split3) and tuple(s.terms.shape) == (3, 37, 203)
    assert s.terms.stride() == (37 * 208, 208, 1)
    (rec,) = log
    assert (rec.path, rec.plan, rec.m, rec.n, rec.k) == (
        "split3", None, 37, 203, 0)


def test_cpu_operands_take_the_plain_version_and_record_nothing():
    g = torch.Generator().manual_seed(0)
    a = torch.randn((M, K), generator=g).bfloat16()
    b = torch.randn((K, N), generator=g).bfloat16()
    before = _counts()
    with record_meta() as log:
        got = tiled_matmul(a, b)
    assert log == [] and _counts() == before
    assert got.device.type == "cpu"
    torch.testing.assert_close(got.float(), (a.float() @ b.float()),
                               rtol=2e-2, atol=2e-2)


def test_roofline_from_cost_terms():
    a = torch.zeros((M, K), dtype=torch.bfloat16, device="meta")
    w = torch.zeros((K, N), dtype=torch.bfloat16, device="meta")
    cost = analyze_step(ops.matmul, a, w)
    r = roofline_from_cost("one gemm", cost, model_flops=2 * M * N * K)
    assert r.chip == "h100" and r.n_chips == 1
    assert r.compute_s == pytest.approx(2 * M * N * K / PEAK_BF16_FLOPS)
    assert r.memory_s == pytest.approx(cost.hbm_bytes / HBM_BYTES_PER_S)
    assert r.collective_s == 0.0 and r.dominant == "memory"
    assert r.bound_s == max(r.compute_s, r.memory_s)
    assert r.useful_flops_fraction == 1.0
    assert isinstance(r.collectives, CollectiveStats)
    assert r.collectives.total_wire_bytes == 0.0
    assert r.bytes_per_device == cost.peak_live_bytes
