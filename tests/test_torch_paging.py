"""The port's paged KV cache against the JAX package's, on the CPU.

Two halves: the page allocator (`serving/paging.py`, a numpy copy of the
reference's) driven through the same seeded admit / register / release /
evict sequences as the reference's, with page lists, bases, copies,
refcounts and reports exactly equal; and the five paged primitives of
`models/layers.py` against the JAX ones on the same seeded inputs. The
primitives move values without arithmetic, so they are held exactly; the
paged attention output is f32 and held to 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro.serving import paging as jpaging
from repro_torch.models import layers as L
from repro_torch.serving import paging
from repro_torch.serving.paging import NULL_PAGE, PageAllocator, PageCacheFull

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def prompt(seed: int, n: int, vocab: int = 97) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


# ---------------------------------------------------------------------------
# the allocator against the reference's
# ---------------------------------------------------------------------------


def _state(alloc) -> tuple:
    """Everything observable of an allocator: refcounts, free list,
    registry, counters, report."""
    return (alloc.refs.tolist(), list(alloc._free),
            {k: (e.page, e.n_tokens, e.last_hit)
             for k, e in alloc._chains.items()},
            {k: (t, e.page, e.n_tokens, e.last_hit)
             for k, (t, e) in alloc._partials.items()},
            dict(alloc.stats), alloc.report())


def _drive(mod, seed: int, num_pages: int, page_size: int,
           prefix_cache: bool) -> list:
    """A seeded sequence of admissions (most sharing one of three system
    prompts, some repeating an earlier prompt whole), registrations,
    releases in a random order, shed registries, squeezes and explicit
    allocations, with every outcome and state recorded."""
    rng = np.random.default_rng(seed)
    alloc = mod.PageAllocator(num_pages, page_size, prefix_cache=prefix_cache)
    systems = [rng.integers(0, 50, int(rng.integers(page_size, 4 * page_size)))
               for _ in range(3)]
    seen: list = []
    live: list = []
    log: list = []
    for step in range(60):
        op = rng.choice(["admit", "release", "shed", "squeeze", "alloc"],
                        p=[.6, .25, .05, .05, .05])
        if op == "admit":
            own = rng.integers(0, 50, int(rng.integers(1, 2 * page_size)))
            p = (np.concatenate([systems[rng.integers(3)], own])
                 if rng.random() < 0.6 else own).astype(np.int32)
            if seen and rng.random() < 0.25:
                p = seen[int(rng.integers(len(seen)))]
            seen.append(p)
            budget = int(rng.integers(1, page_size + 2))
            try:
                a = alloc.admit(p, budget)
            except mod.PageCacheFull:
                log.append((step, "full"))
            else:
                copies = alloc.register(p, a.pages, len(p))
                live.append(a.pages)
                log.append((step, "admit", a.pages, a.base, a.copies,
                            copies))
        elif op == "release" and live:
            pages = live.pop(int(rng.integers(len(live))))
            alloc.release(pages)
            log.append((step, "release", pages))
        elif op == "shed":
            log.append((step, "shed", alloc.shed_registry()))
        elif op == "squeeze":
            n = alloc.squeeze(int(rng.integers(0, 3)))
            log.append((step, "squeeze", n, alloc.unsqueeze()))
        elif op == "alloc":
            try:
                got = alloc.alloc(int(rng.integers(1, 3)))
            except mod.PageCacheFull:
                log.append((step, "alloc full"))
            else:
                live.append(got)
                log.append((step, "alloc", got))
        log.append(_state(alloc))
    return log


@pytest.mark.parametrize("seed,num_pages,page_size,prefix_cache", [
    (0, 24, 4, True), (1, 12, 4, True), (2, 40, 8, True), (3, 9, 2, True),
    (4, 24, 4, False)])
def test_allocator_equals_the_reference(seed, num_pages, page_size,
                                        prefix_cache):
    """Pools from roomy to tight enough that admissions evict, shed and
    fail: every page list, base, copy, refcount and report equal."""
    got = _drive(paging, seed, num_pages, page_size, prefix_cache)
    want = _drive(jpaging, seed, num_pages, page_size, prefix_cache)
    assert got == want


def test_seeded_sequences_reach_every_allocator_path():
    """The sequences above fork pages, evict, shed the registry, refuse
    admissions and hit prefixes: the parity covers those paths."""
    stats = [_drive(paging, *case)[-1][4] for case in (
        (0, 24, 4, True), (1, 12, 4, True), (2, 40, 8, True),
        (3, 9, 2, True))]
    for key in ("cow_forks", "evictions", "registry_sheds", "prefix_hits"):
        assert sum(s[key] for s in stats) > 0, key
    assert any(e[1] == "full" for e in _drive(paging, 1, 12, 4, True)
               if isinstance(e[1], str))


# the reference's `tests/test_paged_kv.py::TestPageAllocator`, on the port


class TestPageAllocator:
    def test_null_page_reserved(self):
        alloc = PageAllocator(8, 4)
        pages = alloc.alloc(7)
        assert NULL_PAGE not in pages
        assert sorted(pages) == list(range(1, 8))

    def test_exhaustion_raises_and_rolls_back(self):
        alloc = PageAllocator(5, 4)
        held = alloc.alloc(2)
        free_before = alloc.free_pages
        with pytest.raises(PageCacheFull):
            alloc.alloc(3)
        assert alloc.free_pages == free_before
        alloc.release(held)
        assert alloc.free_pages == 4

    def test_refcount_frees_only_with_last_reader(self):
        alloc = PageAllocator(8, 4)
        (page,) = alloc.alloc(1)
        alloc.retain([page])
        alloc.release([page])
        assert alloc.refs[page] == 1
        assert page not in alloc._free
        alloc.release([page])
        assert alloc.refs[page] == 0
        assert page in alloc._free
        with pytest.raises(AssertionError):
            alloc.release([page])

    def test_admit_register_match_roundtrip(self):
        alloc = PageAllocator(64, 8)
        p1 = np.arange(20, dtype=np.int32)
        a1 = alloc.admit(p1, budget=4)
        assert a1.base == 0 and len(a1.pages) == 3
        copies = alloc.register(p1, a1.pages, len(p1))
        assert len(copies) == 1
        p2 = np.concatenate([p1, 50 + np.arange(6, dtype=np.int32)])
        a2 = alloc.admit(p2, budget=4)
        assert a2.base == 20
        assert a2.pages[:2] == a1.pages[:2]
        assert alloc.stats["cow_forks"] == 1
        assert alloc.stats["prefix_hits"] == 1
        assert alloc.stats["prefix_hit_tokens"] == 20

    def test_cow_fork_when_prefix_diverges_mid_page(self):
        alloc = PageAllocator(64, 8)
        p1 = np.arange(12, dtype=np.int32)
        a1 = alloc.admit(p1, budget=4)
        alloc.register(p1, a1.pages, len(p1))
        snap = alloc._partials[alloc._key(p1, 8)][1].page
        p2 = np.concatenate([p1, 90 + np.arange(3, dtype=np.int32)])
        a2 = alloc.admit(p2, budget=4)
        assert a2.base == 12
        assert alloc.stats["cow_forks"] == 1
        assert a2.copies == [(snap, a2.pages[1])]
        assert a2.pages[1] != snap
        assert alloc.refs[snap] == 1

    def test_fully_matched_prompt_recomputes_last_token(self):
        alloc = PageAllocator(64, 8)
        p1 = np.arange(16, dtype=np.int32)
        a1 = alloc.admit(p1, budget=4)
        alloc.register(p1, a1.pages, len(p1))
        a2 = alloc.admit(p1.copy(), budget=4)
        assert a2.base == 15
        assert alloc.stats["cow_forks"] == 1

    def test_eviction_reclaims_lru_registry_pages(self):
        alloc = PageAllocator(6, 4)
        pa = alloc.admit(np.arange(4, dtype=np.int32), budget=1)
        alloc.register(np.arange(4, dtype=np.int32), pa.pages, 4)
        alloc.release(pa.pages)
        pb = alloc.admit(100 + np.arange(4, dtype=np.int32), budget=1)
        alloc.register(100 + np.arange(4, dtype=np.int32), pb.pages, 4)
        alloc.alloc(alloc.free_pages + 1)
        assert alloc.stats["evictions"] == 1
        assert len(alloc._chains) == 1
        with pytest.raises(PageCacheFull):
            alloc.alloc(1)

    def test_shed_registry_frees_sole_owner_pages(self):
        alloc = PageAllocator(16, 4)
        p = np.arange(10, dtype=np.int32)
        a = alloc.admit(p, budget=2)
        alloc.register(p, a.pages, len(p))
        alloc.release(a.pages)
        assert alloc.in_use == 3            # two chain pages + a snapshot
        assert alloc.shed_registry() == 3
        assert alloc.in_use == 0 and alloc.stats["registry_sheds"] == 3


# ---------------------------------------------------------------------------
# the paged primitives against the JAX ones
# ---------------------------------------------------------------------------


def _pool_and_table(B=2, n=4, T=8, d=4, seed=0):
    """The same random pool (page 0 included) and a table of distinct real
    pages, in both packages."""
    P = B * n + 1
    pool = np.random.default_rng(seed).normal(size=(P, T, d)).astype(
        np.float32)
    table = np.arange(1, B * n + 1, dtype=np.int32).reshape(B, n)
    return pool, table


@pytest.mark.parametrize("idx,S", [(0, 8), (5, 8), (7, 1), (8, 1), (6, 4),
                                   (15, 2), (30, 4)])
def test_scatter_and_gather_equal_jax(idx, S):
    """`paged_cache_update` then `paged_gather` for (index, length)
    straddling page boundaries and running past the table; the port writes
    in place."""
    B, n, T, d = 2, 4, 8, 4
    pool, table = _pool_and_table(B, n, T, d)
    upd = np.random.default_rng(1).normal(size=(B, S, d)).astype(np.float32)
    lens = np.array([S, max(S - 1, 1)], np.int32)
    index = np.full((B,), idx, np.int32)
    want = JL.paged_cache_update(jnp.asarray(pool), jnp.asarray(upd),
                                 jnp.asarray(table), jnp.asarray(index),
                                 jnp.asarray(lens))
    t_pool = torch.from_numpy(pool.copy())
    got = L.paged_cache_update(t_pool, torch.from_numpy(upd),
                               torch.from_numpy(table),
                               torch.from_numpy(index), torch.from_numpy(lens))
    assert got is t_pool
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(
        _np(L.paged_gather(got, torch.from_numpy(table))),
        _np(JL.paged_gather(want, jnp.asarray(table))))


def test_scatter_scalar_index_equals_jax():
    pool, table = _pool_and_table()
    upd = np.random.default_rng(2).normal(size=(2, 3, 4)).astype(np.float32)
    want = JL.paged_cache_update(jnp.asarray(pool), jnp.asarray(upd),
                                 jnp.asarray(table), jnp.asarray(6))
    got = L.paged_cache_update(torch.from_numpy(pool.copy()),
                               torch.from_numpy(upd), torch.from_numpy(table),
                               6)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_null_page_rows_drop_writes():
    """A dead row (all-null table) and a row running onto a null entry
    write nothing there: page 0 keeps its bytes, as in the JAX package."""
    B, n, T, d = 3, 2, 4, 4
    pool, _ = _pool_and_table(B, n, T, d, seed=3)
    table = np.array([[1, 2], [0, 0], [3, 0]], np.int32)
    upd = np.ones((B, T + 2, d), np.float32)
    index = np.array([0, 0, 2], np.int32)
    want = JL.paged_cache_update(jnp.asarray(pool), jnp.asarray(upd),
                                 jnp.asarray(table), jnp.asarray(index))
    got = L.paged_cache_update(torch.from_numpy(pool.copy()),
                               torch.from_numpy(upd), torch.from_numpy(table),
                               torch.from_numpy(index))
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got[NULL_PAGE]), pool[NULL_PAGE])
    assert not np.array_equal(_np(got[1]), pool[1])


@pytest.mark.parametrize("kv_len", [7, 8, 9, 16, 24, 31, 32])
def test_mask_parity_at_page_boundaries(kv_len):
    """With every page real, the paged mask equals the dense mask in both
    packages, at lengths straddling each page boundary."""
    B, n, T, Sq = 2, 4, 8, 1
    Sk = n * T
    table = np.arange(1, B * n + 1, dtype=np.int32).reshape(B, n)
    off = np.array([kv_len - 1, max(kv_len - 2, 0)], np.int32)
    kl = off + Sq
    got = L.paged_attention_mask(Sq, Sk, torch.from_numpy(table),
                                 causal=True, q_offset=torch.from_numpy(off),
                                 kv_len=torch.from_numpy(kl))
    dense = L.attention_mask(Sq, Sk, causal=True,
                             q_offset=torch.from_numpy(off),
                             kv_len=torch.from_numpy(kl))
    want = JL.paged_attention_mask(Sq, Sk, jnp.asarray(table), causal=True,
                                   q_offset=jnp.asarray(off),
                                   kv_len=jnp.asarray(kl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), dense.numpy())


def test_mask_blocks_null_pages():
    n, T, Sq = 4, 8, 1
    Sk = n * T
    table = np.array([[1, 2, NULL_PAGE, NULL_PAGE], [3, 0, 4, 0]], np.int32)
    got = L.page_valid_mask(torch.from_numpy(table), Sk)
    want = JL.page_valid_mask(jnp.asarray(table), Sk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    m = L.paged_attention_mask(Sq, Sk, torch.from_numpy(table[:1]),
                               causal=True, q_offset=torch.tensor([Sk - 1]),
                               kv_len=torch.tensor([Sk]))
    assert m[0, 0, :2 * T].all() and not m[0, 0, 2 * T:].any()


def test_copy_pool_pages_equals_jax_and_skips_table():
    """Overlapping copies (a page both read and written) read every source
    before writing, as the functional JAX version does."""
    pool = {"k_pages": np.arange(2 * 5 * 2 * 2, dtype=np.float32
                                 ).reshape(2, 5, 2, 2),
            "v_pages": -np.arange(2 * 5 * 2 * 2, dtype=np.float32
                                  ).reshape(2, 5, 2, 2),
            "table": np.ones((2, 1, 5), np.int32)}
    src, dst = np.array([1, 2, 0]), np.array([2, 3, 0])
    want = JL.copy_pool_pages({k: jnp.asarray(v) for k, v in pool.items()},
                              jnp.asarray(src), jnp.asarray(dst))
    t_pool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    got = L.copy_pool_pages(t_pool, torch.from_numpy(src),
                            torch.from_numpy(dst))
    assert got is t_pool
    for k in pool:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]))


def test_paged_sdpa_equals_jax_and_the_dense_layout():
    """Attention over a gathered view with the page-validity mask: equal to
    the JAX package's `_sdpa(kv_valid=...)` (f32, 1e-5) and bit-identical to
    the dense layout's attention over the same written positions."""
    rng = np.random.default_rng(4)
    B, n, T, H, KV, hd = 2, 4, 4, 4, 2, 8
    Sk = n * T
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    dense_k = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    dense_v = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    table = np.array([[3, 1, 4, 0], [2, 5, 0, 0]], np.int32)
    pool_k = rng.normal(size=(6, T, KV, hd)).astype(np.float32)
    pool_v = rng.normal(size=(6, T, KV, hd)).astype(np.float32)
    for b in range(B):
        for j, page in enumerate(table[b]):
            if page:
                pool_k[page] = dense_k[b, j * T:(j + 1) * T]
                pool_v[page] = dense_v[b, j * T:(j + 1) * T]
    off = np.array([11, 6], np.int64)
    tk = L.paged_gather(torch.from_numpy(pool_k), torch.from_numpy(table))
    tv = L.paged_gather(torch.from_numpy(pool_v), torch.from_numpy(table))
    valid = L.page_valid_mask(torch.from_numpy(table), Sk)
    got = L._sdpa(torch.from_numpy(q), tk, tv, causal=True,
                  q_offset=torch.from_numpy(off),
                  kv_len=torch.from_numpy(off + 1), kv_valid=valid)
    want = JL._sdpa(jnp.asarray(q), JL.paged_gather(jnp.asarray(pool_k),
                                                    jnp.asarray(table)),
                    JL.paged_gather(jnp.asarray(pool_v), jnp.asarray(table)),
                    causal=True, q_offset=jnp.asarray(off),
                    kv_len=jnp.asarray(off + 1),
                    kv_valid=JL.page_valid_mask(jnp.asarray(table), Sk))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    dense = L._sdpa(torch.from_numpy(q), torch.from_numpy(dense_k),
                    torch.from_numpy(dense_v), causal=True,
                    q_offset=torch.from_numpy(off),
                    kv_len=torch.from_numpy(off + 1))
    assert torch.equal(got, dense)
