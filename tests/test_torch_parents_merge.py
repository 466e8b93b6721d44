"""K5's merge-path schedule written out in numpy, block by block and thread
by thread, on the CPU.

``csrc/resample_gather.cu`` ``resample_parents_kernel`` (K5) inverts m
sorted cumulative counts into n parents,
``parent(j) = min(#{i : counts_i ≤ j}, m − 1)``, as a merge of the counts
with the slots 0..n−1 (ties count-first): count i lands at position
counts_i + i, and a slot's parent is the number of counts merged before
it. Below, the steps are the kernel's, in its order and with its
constants (read from the source): each block owns ``kThreads · kItems``
merged positions and clears its marks; warps 0 and 1 find its two ends by
the 32-way search of ``merge_split`` (32 probes a round, the ballot's
count of probes below the answer); the block's counts mark their
positions; each thread reads the marks of its positions, a block scan
(shuffles up within a warp, the warps' totals through shared memory)
gives it the counts merged before them, and it walks its positions,
writing its slots' parents into an array seeded so that a slot no thread
wrote, or one written twice, shows.

The schedule is held, index for index, to the port's plain version (the
scatter form ``utils.resampling._scatter_counts_to_parents``), to the JAX
package's scatter form and, where m = n, to the JAX entry point
``windowed_parents`` in Pallas interpret mode (its kernel where its window
covers a tile's parents, its scatter fallback where not): at the five
weight profiles of ``testing.PARENT_PROFILES``, n = 1, a stretch plus one,
5,000 and 8,192, the Gaussian-sum reductions' (m, n) = (200, 50), (32, 8)
and (64, 16), ties at counts_i = j and the tail clamp. The CUDA kernel
runs only on the card (tests/test_torch_cuda.py).
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu.ops import resample_gather as jrg
from bayesianfiltering_tpu.utils import resampling as jrs
from bayesianfiltering_tpu_torch import testing
from bayesianfiltering_tpu_torch.ops import resample_gather as rg
from bayesianfiltering_tpu_torch.utils import resampling as rs

pl = pytest.importorskip("jax.experimental.pallas")
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

SOURCE = (Path(__file__).resolve().parents[1] / "bayesianfiltering_tpu_torch"
          / "csrc" / "resample_gather.cu")


def _constant(name):
    found = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert found, name
    return int(found[1])


THREADS, ITEMS, WARP = (_constant(n) for n in ("kThreads", "kItems",
                                               "kWarp"))
STRETCH = THREADS * ITEMS
UNWRITTEN = -(1 << 40)
PROFILES = testing.PARENT_PROFILES


def merge_split(counts, m, n, d):
    """``merge_split``: a(d) = #{i : counts_i + i < d} by the warp's
    32-way search. Returns a(d) and the rounds it took (dependent reads)."""
    lo, hi = max(0, d - n), min(d, m)
    rounds = 0
    lanes = np.arange(WARP)
    while lo < hi:
        step = (hi - lo + WARP - 1) // WARP
        i = lo + lanes * step
        safe = np.minimum(i, m - 1)
        below = (i < hi) & (counts[safe] + i < d)
        k = int(below.sum())
        assert below[:k].all()  # the probes below the answer: a prefix
        if k == 0:
            hi = lo
        else:
            top = lo + k * step
            lo += (k - 1) * step + 1
            hi = min(top, hi)
        rounds += 1
    return lo, rounds


def k5_model(counts, n):
    """``resample_parents_kernel`` over int32 counts (m,) clipped to
    [0, n]: the parents (n,)."""
    counts = np.asarray(counts, np.int64)
    m = len(counts)
    total = m + n
    warps = THREADS // WARP
    lane = np.arange(WARP)
    parents = np.full(n, UNWRITTEN, np.int64)
    for blk in range(-(-total // STRETCH)):
        d0 = blk * STRETCH
        d1 = min(d0 + STRETCH, total)
        # every thread clears its marks, q · kThreads + thread
        mark = np.full(STRETCH, UNWRITTEN, np.int64)
        for q in range(ITEMS):
            mark[q * THREADS + np.arange(THREADS)] = 0
        a0, _ = merge_split(counts, m, n, d0)
        a1, _ = merge_split(counts, m, n, d1)
        b0 = d0 - a0
        nb = (d1 - a1) - b0
        # the block's counts mark their positions (block-relative)
        k = np.arange(a1 - a0)
        pos = counts[a0:a1] + k - b0
        assert ((pos >= 0) & (pos < d1 - d0)).all()
        assert len(np.unique(pos)) == len(pos)
        mark[pos] = 1
        # each thread's marks, and the block scan of their counts
        t0 = np.arange(THREADS) * ITEMS
        marks = mark[t0[:, None] + np.arange(ITEMS)[None, :]]
        assert ((marks == 0) | (marks == 1)).all()
        own = marks.sum(axis=1)
        incl = own.reshape(warps, WARP).copy()
        o = 1
        while o < WARP:  # __shfl_up_sync: lane reads lane − o
            up = np.zeros_like(incl)
            up[:, o:] = incl[:, :-o]
            incl = incl + np.where(lane >= o, up, 0)
            o *= 2
        warp_counts = incl[:, -1]
        before = (incl.reshape(-1) - own
                  + np.repeat(np.cumsum(warp_counts) - warp_counts, WARP))
        # each thread walks its positions; its slots' parents over the marks
        # (here into a fresh array, so that a slot written by no thread, or
        # twice, shows: the kernel's store reads marks 0 .. nb − 1)
        out = np.full(STRETCH, UNWRITTEN, np.int64)
        for th in range(THREADS):
            kk = int(before[th])
            for q in range(ITEMS):
                t = t0[th] + q
                if d0 + t >= d1:
                    continue
                if marks[th, q]:
                    kk += 1
                else:
                    assert out[t - kk] == UNWRITTEN  # one writer a slot
                    out[t - kk] = min(a0 + kk, m - 1)
        assert (out[:nb] != UNWRITTEN).all() and (out[nb:] == UNWRITTEN).all()
        assert (parents[b0:b0 + nb] == UNWRITTEN).all()
        parents[b0:b0 + nb] = out[:nb]
    assert (parents != UNWRITTEN).all()
    return parents


def as_i32(counts, n):
    return np.clip(np.asarray(counts), 0, n).astype(np.int32)


def plain(counts, n):
    return rg.windowed_parents(torch.as_tensor(counts), n).numpy()


def jax_scatter(counts, n):
    return np.asarray(jrs._scatter_counts_to_parents(
        jnp.asarray(as_i32(counts, n)), n))


@functools.lru_cache(maxsize=None)
def jax_windowed(n):
    """The JAX entry point in interpret mode, compiled once per n."""
    with pltpu.force_tpu_interpret_mode():
        return jax.jit(functools.partial(
            jrg.windowed_parents, num_samples=n)).lower(
                jnp.zeros(n, jnp.float32)).compile()


def assert_all_equal(counts, n, jax_refs=("scatter", "windowed")):
    """The schedule against the plain version and the count formula, and
    against the JAX references named."""
    got = k5_model(as_i32(counts, n), n)
    want = plain(counts, n)
    assert want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    c = as_i32(counts, n)
    np.testing.assert_array_equal(got, np.minimum(
        np.searchsorted(c, np.arange(n), side="right"), len(c) - 1))
    if "scatter" in jax_refs:
        np.testing.assert_array_equal(got, jax_scatter(counts, n))
    if "windowed" in jax_refs:
        np.testing.assert_array_equal(
            got, np.asarray(jax_windowed(n)(jnp.asarray(counts, jnp.float32))))
    return got


def test_the_constants_are_the_wrapper_s():
    """The block's stretch and the int32 limit that the wrapper checks."""
    assert rg.STRETCH == STRETCH and ITEMS % 2 == 1
    assert rg.MAX_POSITIONS == 2 ** 31 - 1 - STRETCH


@pytest.mark.parametrize("n", [STRETCH + 1, 5000, 8192])
@pytest.mark.parametrize("profile", PROFILES)
def test_the_schedule_equals_the_scatter_and_the_jax_kernel(profile, n):
    counts = testing.resampling_counts(profile, n, np.random.default_rng(n))
    assert_all_equal(counts, n)


@pytest.mark.parametrize("m,n", [(200, 50), (32, 8), (64, 16), (1, 1),
                                 (3, 1), (1, 5)])
def test_the_reductions_keep_n_of_m(m, n):
    """The AGSF [50,2,2], [8,2,2] and UAGSF [16,2,2] reductions, and the
    edges m = 1 and n = 1: the schedule against both scatter forms."""
    rng = np.random.default_rng(m + n)
    w = torch.as_tensor(rng.dirichlet(np.full(m, 0.5)))
    counts = rs.systematic_counts(w, n, u=torch.tensor(0.37)).numpy()
    assert_all_equal(counts, n, jax_refs=("scatter",))


@pytest.mark.parametrize("counts", [[0], [1], [0, 1], [1, 1], [0, 0]])
def test_one_slot(counts):
    assert_all_equal(np.asarray(counts, np.float64), 1, jax_refs=())


def test_ties_at_counts_equal_to_the_slot():
    """Integer counts with runs of ties at every value, and counts at n
    (children past the end): count i is merged before slot j when
    counts_i = j, so slot j's parent skips the tied counts."""
    n = 2 * STRETCH + 7
    rng = np.random.default_rng(5)
    counts = np.sort(rng.integers(0, n + 1, n)).astype(np.float64)
    counts[-50:] = n
    counts[100:140] = counts[100]
    got = assert_all_equal(counts, n, jax_refs=())
    j = int(counts[100])
    assert got[j] == min(int(np.searchsorted(counts, j, side="right")),
                         n - 1)


def test_the_tail_slot_is_clamped():
    """The last count at n − 1 ("tail", the float rounding edge): the count
    formula gives m at the last slot, the kernel clamps it to m − 1; and a
    reduction whose last count falls short of n."""
    n = STRETCH + 1
    counts = testing.resampling_counts("tail", n, np.random.default_rng(9))
    assert counts[-1] == n - 1
    assert assert_all_equal(counts, n)[-1] == n - 1
    short = np.concatenate([np.zeros(20), np.full(10, 6.0)])  # m = 30, n = 8
    got = assert_all_equal(short, 8, jax_refs=())
    assert (got[6:] == 29).all() and (got[:6] == 20).all()


@pytest.mark.parametrize("n", [STRETCH - 1, STRETCH, 2 * STRETCH - 1])
def test_stretch_edges(n):
    """m + n just below, at and above a multiple of the stretch: the last
    block's partial stretch, and a block that owns no slot or no count."""
    for profile in ("dirichlet", "first", "last"):
        counts = testing.resampling_counts(profile, n,
                                           np.random.default_rng(n))
        assert_all_equal(counts, n, jax_refs=())


def test_the_block_search_takes_four_rounds_at_a_million():
    """a(d) at n = m = 2²⁰ equals the bisection's, in at most four
    dependent rounds of 32 probes."""
    n = 1 << 20
    c = as_i32(testing.resampling_counts("dirichlet", n,
                                         np.random.default_rng(2)), n)
    keys = c.astype(np.int64) + np.arange(n)
    for d in np.random.default_rng(3).integers(0, 2 * n + 1, 64):
        a, rounds = merge_split(c, n, n, int(d))
        assert a == int(np.searchsorted(keys, d, side="left"))
        assert rounds <= 4
