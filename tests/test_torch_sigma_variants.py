"""The sigma-point kernels' variant rules and schedules, on the CPU.

``ops/fused_ut.py`` runs K6 and K7 (one block per element, the workspace
in shared memory) where their workspace fits in a block's shared memory,
and their tiled variants K6t and K7t otherwise. The rules are held at
their edges with the H100's shared-memory opt-in (232,448 bytes per
block) and with a smaller one.

K6t (``csrc/sigma_tiled.cu``) factors P with the one-launch blocked
Cholesky of ``csrc/tiled_chol.cuh`` (``testing.square_factor``: its first
touch reads lower(P), its steps run every trailing tile with its own panel
tiles, the look-ahead factors the next diagonal tile; the blocks take their
tasks in turns) and writes the points in that launch's epilogue, NaN
throughout unless the factor's flag is clear; or it runs 14 Newton–Schulz
rounds of three products and a points pass. K7t factors P over the batch
and the shared C side by side in one such launch (``testing.run_factors``:
both problems' tasks in every phase, their look-ahead diagonal tiles
first), whose epilogue writes the four blocks of the augmented points,
each block NaN where its factor's flag is set; by Newton–Schulz it pairs
P's and C's rounds. Both schedules are written out below in numpy, phase
by phase,
on scratch seeded with NaN (the factor never writes the strict upper part
of its off-diagonal tiles, so a read of it would show; the model also
checks that no task reads what another task of its phase writes), and
held to the JAX package's XLA twins (``fused_ut._sigma_xla``,
``_sigma_aug_xla``) at n = 33, 64, 241, 512 and 1,024 (ragged last panels
at 33 and 241). The C functions that size the factor's scratch and its
phases (``AugLayout``, ``step_tasks``, ``factor_tasks`` of one problem
and of two, ``factor_elems``), and ``tiled.cuh``'s split rules, compiled
by the host compiler, are held to ``testing``'s mirror at config 5 and at
the band's edges. K6's and K7's own in-block factor (``csrc/common.cuh``
``block_cholesky_panels``: one warp factors each 32-column diagonal
block, each thread substitutes whole rows below it, then a lower trailing
update) is written out too and held to ``torch.linalg.cholesky_ex``. The
CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).

Tolerances (relative to max(1, max|reference|)): float64 1e-10, float32
1e-3 (the bound chip_smoke.py holds every kernel to): the same factor in
another order.
"""
import functools
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu.ops import fused_ut as jfu
from bayesianfiltering_tpu_torch import testing
from bayesianfiltering_tpu_torch.ops import fused_ut as fu

torch.set_num_threads(1)

H100_OPTIN = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100
TOL = {"float64": 1e-10, "float32": 1e-3}
NS_ITERS = 14
NB = 32


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def assert_close(got, want, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jax_run(fn, *args):
    args = [jnp.asarray(a, jnp.float64) for a in args]
    return np.asarray(jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args))

def _jax_each(fn, *args, in_axes=None, wide=True):
    """``fn`` (one element's twin) over the batch in float64. Where
    ``wide`` (a factored dimension above 16) and the batch is at most 4:
    element by element, eagerly, stacked; on a concrete single element the
    JAX package factors by its native route
    (``utils/linalg._effectively_unbatched``), where the jitted, vmapped
    batch unrolls its blocked factorisation and compiled for 10-20 s at the
    wide shapes; the two agree to rounding. Else vmapped and jitted (the
    unrolled factor of a small matrix runs slowly op by op)."""
    in_axes = in_axes or (0,) * len(args)
    B = next(a.shape[0] for a, ax in zip(args, in_axes) if ax == 0)
    if not wide or B > 4:
        return _jax_run(jax.vmap(fn, in_axes=in_axes), *args)
    f64 = lambda a: jnp.asarray(a, jnp.float64)
    outs = [fn(*(f64(a[b]) if ax == 0 else f64(a)
                 for a, ax in zip(args, in_axes)))
            for b in range(B)]
    if not isinstance(outs[0], (tuple, list)):
        return np.stack([np.asarray(o) for o in outs])
    return [np.stack([np.asarray(o[k]) for o in outs])
            for k in range(len(outs[0]))]



@functools.lru_cache(maxsize=None)
def sigma_case(B, n, method):
    """(m, P), the scale, and JAX's points."""
    m, P = testing.sigma_inputs(np.random.default_rng(n), B, n)
    scale = 1.3
    want = _jax_each(lambda a, b: jfu._sigma_xla(a, b, scale, method), m,
                     P, wide=n > 16)
    return (m, P), scale, want


@functools.lru_cache(maxsize=None)
def aug_case(B, dx, dn, method):
    """(m, P, bias, C), the scale, and JAX's augmented points."""
    args = testing.sigma_aug_inputs(np.random.default_rng(dx + dn), B, dx,
                                    dn)
    scale = 0.9
    want = _jax_each(lambda m, P, b, C: jfu._sigma_aug_xla(
        m, P, b, C, scale, method), *args, in_axes=(0, 0, None, None),
        wide=max(dx, dn) > 16)
    return args, scale, want


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,method,itemsize,optin,want", [
    (64, "cholesky", 4, H100_OPTIN, "K6"),     # the batched Lorenz-96 UKF
    (64, "cholesky", 8, H100_OPTIN, "K6"),
    (64, "sqrtm", 4, H100_OPTIN, "K6"),
    (64, "sqrtm", 8, H100_OPTIN, "K6"),
    (4, "cholesky", 4, H100_OPTIN, "K6"),      # the banks
    (240, "cholesky", 4, H100_OPTIN, "K6"),    # 57,600 elements
    (241, "cholesky", 4, H100_OPTIN, "K6T"),   # 58,081
    (170, "cholesky", 8, H100_OPTIN, "K6"),    # 28,900
    (171, "cholesky", 8, H100_OPTIN, "K6T"),   # 29,241
    (128, "sqrtm", 4, H100_OPTIN, "K6"),       # 3 × 128 × 128 = 49,152
    (129, "sqrtm", 4, H100_OPTIN, "K6T"),      # past _NS_MAX (63,360)
    (96, "sqrtm", 8, H100_OPTIN, "K6"),        # 3 × 96 × 96 = 27,648
    (97, "sqrtm", 8, H100_OPTIN, "K6T"),       # 3 × 100 × 128 = 38,400
    (512, "cholesky", 4, H100_OPTIN, "K6T"),   # config 5
    (512, "cholesky", 8, H100_OPTIN, "K6T"),
    (64, "cholesky", 4, 16 * 1024, "K6T"),     # a card with less
    (63, "cholesky", 4, 16 * 1024, "K6"),
])
def test_sigma_variant_rule(n, method, itemsize, optin, want):
    assert fu.sigma_kernel(n, method, itemsize, optin) is getattr(fu, want)


@pytest.mark.parametrize("dx,dn,method,itemsize,optin,want", [
    (64, 64, "cholesky", 4, H100_OPTIN, "K7"),   # L96 predict
    (64, 32, "cholesky", 8, H100_OPTIN, "K7"),   # L96 update
    (64, 64, "sqrtm", 8, H100_OPTIN, "K7"),      # 20,480 elements
    (4, 2, "cholesky", 4, H100_OPTIN, "K7"),     # the UGSF/UAGSF banks
    (223, 64, "cholesky", 4, H100_OPTIN, "K7"),  # 57,921
    (224, 64, "cholesky", 4, H100_OPTIN, "K7T"),  # 58,368
    (144, 64, "cholesky", 8, H100_OPTIN, "K7"),  # 28,928
    (145, 64, "cholesky", 8, H100_OPTIN, "K7T"),  # 29,217
    (1, 128, "sqrtm", 4, H100_OPTIN, "K7"),      # the noise launch: 49,152
    (1, 129, "sqrtm", 4, H100_OPTIN, "K7T"),     # past _NS_MAX
    (512, 512, "cholesky", 4, H100_OPTIN, "K7T"),  # config 5 augmented
    (512, 256, "cholesky", 8, H100_OPTIN, "K7T"),
    (64, 64, "cholesky", 4, 32 * 1024, "K7T"),
])
def test_sigma_aug_variant_rule(dx, dn, method, itemsize, optin, want):
    assert fu.sigma_aug_kernel(dx, dn, method, itemsize,
                               optin) is getattr(fu, want)


def test_the_sigma_rules_flip_once_along_each_dimension():
    for itemsize in (4, 8):
        for method in ("cholesky", "sqrtm"):
            picks = [fu.sigma_kernel(n, method, itemsize, H100_OPTIN).name
                     for n in range(1, 1025)]
            flip = picks.index(fu.K6T.name)
            assert set(picks[:flip]) == {fu.K6.name}
            assert set(picks[flip:]) == {fu.K6T.name}
            for dn in (1, 32, 64):
                picks = [fu.sigma_aug_kernel(dx, dn, method, itemsize,
                                             H100_OPTIN).name
                         for dx in range(1, 1025 - dn)]
                flip = picks.index(fu.K7T.name)
                assert set(picks[:flip]) == {fu.K7.name}
                assert set(picks[flip:]) == {fu.K7T.name}
            for dx in (1, 64):
                picks = [fu.sigma_aug_kernel(dx, dn, method, itemsize,
                                             H100_OPTIN).name
                         for dn in range(1, 1025 - dx)]
                flip = picks.index(fu.K7T.name)
                assert set(picks[:flip]) == {fu.K7.name}
                assert set(picks[flip:]) == {fu.K7T.name}


# ---------------------------------------------------------------------------
# K6t's and K7t's schedules
# ---------------------------------------------------------------------------

def tiled_factor(P, method, blocks=132):
    """One element's factor as K6t computes it, on scratch seeded with NaN:
    (the row-major lower L (the strict upper part of its off-diagonal tiles
    unwritten) and the factor's failed-pivot flag) or (the Newton–Schulz
    root, False)."""
    n = P.shape[-1]
    if method == "cholesky":
        f = testing.square_factor(P[None], blocks)
        return f.L[0], bool(f.flag[0])
    # trace pass, 14 rounds of three products, the root pass
    s = np.trace(P) + P.dtype.type(1e-30)
    Y = (P.dtype.type(0.5) * (P + P.T)) / s
    Z = np.eye(n, dtype=P.dtype)
    for _ in range(NS_ITERS):
        T = P.dtype.type(-0.5) * (Z @ Y) + P.dtype.type(1.5) * np.eye(n)
        Y, Z = Y @ T, T @ Z
    rs = np.sqrt(s)
    return P.dtype.type(0.5) * (Y * rs + Y.T * rs), False


def offsets(F, scale, lower, bad=False):
    """scale·F read as the points are written: entry (r, c) is
    scale·F[c][r], zero where c < r for a Cholesky factor (never read),
    NaN throughout where ``bad`` (the factor's flag, in K6t's and K7t's
    epilogues)."""
    n = F.shape[-1]
    if not lower:
        return scale * F.T
    if bad:
        return np.full_like(F, np.nan)
    keep = np.tri(n, dtype=bool)  # F[c][r] with c ≥ r
    return np.where(keep, F, 0).T * scale


def tiled_sigma(m, P, scale, method):
    """K6t over a batch: the factor of every element in one model (the
    launch's task order over the batch), then the points."""
    if method == "cholesky":
        f = testing.square_factor(P)
        factors = [(f.L[b], bool(f.flag[b])) for b in range(m.shape[0])]
    else:
        factors = [tiled_factor(P[b], method) for b in range(m.shape[0])]
    out = []
    for b, (F, bad) in enumerate(factors):
        off = offsets(F, scale, method == "cholesky", bad)
        out.append(np.concatenate([m[b] + off, m[b] - off]))
    return np.stack(out)


def tiled_sigma_aug(m, P, bias, C, scale, method):
    """K7t: by Cholesky, one launch that factors P (per element) and C
    (once) side by side (``testing.square_factor_pair``), each block NaN
    where its factor's flag is set; by Newton–Schulz, both roots (their
    rounds paired in grouped launches: the same arithmetic). Then the
    assembly of [mA + off; mA − off], off = blkdiag(state, noise)."""
    lower = method == "cholesky"
    if lower:
        fp, fc = testing.square_factor_pair(P, C)
        state = [(fp.L[b], bool(fp.flag[b])) for b in range(m.shape[0])]
        noise = offsets(fc.L[0], scale, True, bool(fc.flag[0]))
    else:
        state = [tiled_factor(P[b], method) for b in range(m.shape[0])]
        noise = offsets(tiled_factor(C, method)[0], scale, False)
    dx, dn = m.shape[-1], bias.shape[-1]
    out = []
    for b, (F, bad) in enumerate(state):
        off = np.zeros((dx + dn, dx + dn), m.dtype)
        off[:dx, :dx] = offsets(F, scale, lower, bad)
        off[dx:, dx:] = noise
        mA = np.concatenate([m[b], bias])
        out.append(np.concatenate([mA + off, mA - off]))
    return np.stack(out)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,n", [(2, 33), (2, 64), (1, 512), (3, 241),
                                 (1, 1024)])
def test_tiled_sigma_schedule_matches_jax(dtype, B, n):
    """One panel and one more column, two panels, config 5's sixteen, eight
    with a ragged last panel over a batch of three, the band's 32."""
    (m, P), scale, want = sigma_case(B, n, "cholesky")
    got = tiled_sigma(m.astype(dtype), P.astype(dtype), scale, "cholesky")
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_tiled_newton_schulz_schedule_matches_jax(dtype):
    """n = 130: above K6's fit in both dtypes; JAX takes the eigh root
    there, which 14 rounds reach to rounding."""
    (m, P), scale, want = sigma_case(2, 130, "sqrtm")
    got = tiled_sigma(m.astype(dtype), P.astype(dtype), scale, "sqrtm")
    assert_close(got, want, dtype)


@pytest.mark.parametrize("fail_at", [0, 40, 69])
def test_tiled_sigma_schedule_gives_nan_everywhere_on_a_non_pd_p(fail_at):
    """A negative pivot in the first panel, the middle one or only in the
    last (ragged) one: the factor NaNs only from the failing diagonal tile
    on and sets the element's flag, the points epilogue NaNs all of them,
    as the port's plain version does."""
    m, P = testing.sigma_inputs(np.random.default_rng(3), 2, 70)
    P[1, fail_at, fail_at] = -1e3
    L, bad = tiled_factor(P[1], "cholesky")
    assert bad and not tiled_factor(P[0], "cholesky")[1]
    assert np.isnan(np.diag(L)[fail_at:]).all()
    start = fail_at // NB * NB  # the failing tile's first column
    assert np.isfinite(np.tril(L)[:start, :start]).all()
    got = tiled_sigma(m, P, 1.0, "cholesky")
    want = fu._sigma_plain(torch.as_tensor(m), torch.as_tensor(P), 1.0,
                           "cholesky").numpy()
    assert np.isnan(got[1]).all() and np.isnan(want[1]).all()
    assert_close(got[0], want[0], "float64")


def test_the_factor_hands_out_its_tasks_in_turns():
    """Over 5 blocks, a batch of 3 at n = 241 (8 panels): every phase's
    tasks go to the blocks in turns, each task once, the order reversed
    every other round; the look-ahead's diagonal tiles, handed out first,
    go to blocks 0–2, which take no second task of a step that has at
    most 2·5 − 3 tasks; the result does not depend on the blocks' number
    (the model checks that no task reads what another of its phase
    writes)."""
    P = testing.sigma_inputs(np.random.default_rng(7), 3, 241)[1]
    f5 = testing.square_factor(P, blocks=5)
    f132 = testing.square_factor(P, blocks=132)
    np.testing.assert_array_equal(np.nan_to_num(f5.L, nan=7.0),
                                  np.nan_to_num(f132.L, nan=7.0))
    assert len(f5.owner) == testing.tiles_of(241)  # first phase + 7 steps
    for k, owner in enumerate(f5.owner[1:]):
        total = 3 * testing.step_tasks(k, 241, 241)
        assert sorted(owner) == list(range(total))
        for p, g in owner.items():
            rnd, off = divmod(p, 5)
            assert g == (4 - off if rnd % 2 else off)
        assert [owner[b] for b in range(3)] == [0, 1, 2]
        if total <= 2 * 5 - 3:
            assert all(g > 2 for p, g in owner.items() if p >= 3)
    assert testing.block_tasks(7, 3) == [[0, 5, 6], [1, 4], [2, 3]]


@pytest.mark.parametrize("dx,dn,B", [(100, 45, 2), (40, 130, 1)])
def test_the_pair_factor_runs_both_chains_side_by_side(dx, dn, B):
    """K7t's one launch over 7 blocks: P's chain (B elements) and C's (one)
    share every phase, the longer setting the phases' number; a step
    hands out both problems' look-ahead diagonal tiles first (P's, then
    C's), then P's other tiles, then C's; a chain that has ended adds no
    task; the factors equal those of each problem alone (the model checks
    that no task reads what another of its phase writes, across both)."""
    _, P, _, C = testing.sigma_aug_inputs(np.random.default_rng(dx), B, dx,
                                          dn)
    fp, fc = testing.square_factor_pair(P, C, blocks=7)
    alone = (testing.square_factor(P, blocks=7),
             testing.square_factor(C[None], blocks=7))
    for f, g in zip((fp, fc), alone):
        np.testing.assert_array_equal(np.nan_to_num(f.L, nan=7.0),
                                      np.nan_to_num(g.L, nan=7.0))
        assert (f.flag == 0).all()
    ntp, ntn = testing.tiles_of(dx), testing.tiles_of(dn)
    assert len(fp.owner) == max(ntp, ntn) and fp.owner is fc.owner
    assert sorted(fp.owner[0]) == list(range(B + 1))
    for k, owner in enumerate(fp.owner[1:]):
        sp, sn = (testing.step_tasks(k, n, n) for n in (dx, dn))
        assert sorted(owner) == list(range(B * sp + sn))
        diag = (B if sp else 0) + (1 if sn else 0)
        rnd0 = [g for p, g in sorted(owner.items()) if p < diag]
        assert rnd0 == list(range(diag))
    assert testing.factor_tasks(dx, dx, B, (dn, 1)) == max(
        [B + 1] + [B * testing.step_tasks(k, dx, dx)
                   + testing.step_tasks(k, dn, dn)
                   for k in range(max(ntp, ntn) - 1)])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,dx,dn,method", [(2, 40, 33, "cholesky"),
                                            (1, 70, 5, "cholesky"),
                                            (2, 9, 90, "sqrtm")])
def test_tiled_sigma_aug_assembly_matches_jax(dtype, B, dx, dn, method):
    args, scale, want = aug_case(B, dx, dn, method)
    got = tiled_sigma_aug(*(a.astype(dtype) for a in args), scale, method)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("part", ["P", "C"])
def test_tiled_sigma_aug_nans_only_the_failing_block(part):
    """A non-PD P NaNs that element's state block, a non-PD C every noise
    block; the rest stays finite, as in the plain points_blockdiag."""
    m, P, bias, C = testing.sigma_aug_inputs(np.random.default_rng(5), 2,
                                             40, 35)
    if part == "P":
        P[0, 36, 36] = -1e3
    else:
        C[34, 34] = -1e3
    got = tiled_sigma_aug(m, P, bias, C, 1.0, "cholesky")
    want = fu._sigma_aug_plain(*(torch.as_tensor(a) for a in (m, P, bias, C)),
                               1.0, "cholesky").numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any() and np.isfinite(got).any()
    finite = np.isfinite(want)
    assert_close(got[finite], want[finite], "float64")


# ---------------------------------------------------------------------------
# K6's and K7's in-block factor
# ---------------------------------------------------------------------------

def block_cholesky_panels(P):
    """``block_cholesky_panels`` of csrc/common.cuh on one element, panel by
    panel, the strict upper part seeded with NaN. Returns (A, bad, parked):
    A's lower triangle holds L, bad says whether a pivot failed, parked
    marks the strict-upper slots where each panel's pivot reciprocals wait
    for the rows below it (column k + 32, rows k..k+31)."""
    n = P.shape[-1]
    A = np.full((n, n), np.nan)
    lower = np.tri(n, dtype=bool)
    A[lower] = P[lower]
    parked = np.zeros((n, n), bool)
    bad = False
    for k in range(0, n, NB):
        nb = min(NB, n - k)
        D = A[k:k + nb, k:k + nb]
        # warp 0: the diagonal block in registers, a row a lane
        a = np.tril(np.nan_to_num(D, nan=0.0))
        for j in range(nb):
            d = a[j, j]
            bad = bad or not d > 0
            ljj = np.sqrt(d) if d > 0 else np.nan
            col = np.where(np.arange(nb) > j, a[:, j] / ljj, 0.0)
            col[j] = ljj
            a[:, j] = col
            a[j + 1:, j + 1:] -= np.tril(np.outer(col[j + 1:], col[j + 1:]))
        D[np.tri(nb, dtype=bool)] = a[np.tri(nb, dtype=bool)]
        below = k + nb
        if below >= n:
            break
        A[k:below, below] = 1.0 / np.diag(D)  # warp 0 parks 1/l_cc
        parked[k:below, below] = True
        # rows below: forward substitution, column by column, a row a thread
        x = A[below:, k:below].copy()
        for c in range(nb):
            x[:, c] *= A[k + c, below]
            x[:, c + 1:] -= np.outer(x[:, c], D[c + 1:, c])
        A[below:, k:below] = x
        # lower trailing update
        upd = x @ x.T
        sub = A[below:, below:]
        tri = np.tri(n - below, dtype=bool)
        sub[tri] -= upd[tri]
    return A, bad, parked


@pytest.mark.parametrize("n", [12, 33, 64])
def test_in_block_panel_factor_matches_cholesky_ex(n):
    P = testing.spd(np.random.default_rng(n), 1, n)[0]
    A, bad, parked = block_cholesky_panels(P)
    want = torch.linalg.cholesky_ex(torch.as_tensor(P))[0].numpy()
    lower = np.tri(n, dtype=bool)
    assert not bad
    # the rest of the strict upper part is never written; the points read
    # all of it as zero
    assert np.isnan(A[~lower & ~parked]).all()
    assert parked.sum() == NB * ((n - 1) // NB)
    assert_close(np.where(lower, A, 0.0), want, "float64")


@pytest.mark.parametrize("fail_at", [0, 40])
def test_in_block_panel_factor_flags_a_failing_pivot(fail_at):
    P = testing.spd(np.random.default_rng(4), 1, 64)[0]
    P[fail_at, fail_at] = -1e3
    _, bad, _ = block_cholesky_panels(P)
    assert bad
    assert torch.linalg.cholesky_ex(torch.as_tensor(P))[1] != 0


def block_newton_schulz(P, dtype):
    """K6's and K7's in-block Newton–Schulz root (csrc/fused_ut.cu
    ``block_factor`` with kNs > 0) in numpy: Y, Z and T, each of
    round_up(n, 4) rows and leading dimension round_up(n, 32), seeded with
    NaN; T = (3I − Z Y)/2 in the first product's epilogue, Y T and T Z
    stored over Y and Z (``tile_mm_held``: every tile computed before any
    is stored), each product ``testing.tile_mm``'s tiles and stored mask;
    the root sym(Y·√s) into T. Returns the root at T's stride."""
    n = P.shape[0]
    rows, ld = -(-n // 4) * 4, -(-n // NB) * NB
    Y, Z, T = (np.full((rows, ld), np.nan, dtype) for _ in range(3))
    s = dtype(np.sum(np.diag(P))) + dtype(1e-30)
    Y[:n, :n] = (dtype(0.5) * (P + P.T)) / s
    Z[:n, :n] = np.eye(n, dtype=dtype)
    eye = np.eye(rows, ld, dtype=dtype)
    for _ in range(NS_ITERS):
        C, mask = testing.tile_mm(Z, Y, n, n, n, at=False)
        testing.put(T, C, mask, lambda c: dtype(0.5) * (3 * eye - c))
        C, mask = testing.tile_mm(Y, T, n, n, n, at=False)
        testing.put(Y, C, mask)
        C, mask = testing.tile_mm(T, Z, n, n, n, at=False)
        testing.put(Z, C, mask)
    rs = np.sqrt(s)
    T[:n, :n] = dtype(0.5) * (Y[:n, :n] * rs + Y[:n, :n].T * rs)
    return T


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [1, 5, 37, 64, 65, 128])
def test_in_block_newton_schulz_matches_jax(dtype, n):
    """One super-tile a thread to n = 64, 2 × 2 to 128; ragged n and n = 1
    read their pad only into outputs that no epilogue stores."""
    (m, P), scale, want = sigma_case(1, n, "sqrtm")
    F = block_newton_schulz(P[0].astype(dtype), np.dtype(dtype).type)
    assert np.isfinite(F[:n, :n]).all()
    root = F[:n, :n].astype(np.float64)
    got = np.concatenate([m[0] + scale * root.T, m[0] - scale * root.T])
    assert_close(got, want[0], dtype)


# ---------------------------------------------------------------------------
# The wrappers at K6t's and K7t's shapes (the plain versions on CPU tensors)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,n,method", [(1, 512, "cholesky"),
                                        (2, 130, "sqrtm")])
def test_sigma_wrapper_at_tiled_shapes_matches_jax(dtype, B, n, method):
    assert fu.sigma_kernel(n, method, 4, H100_OPTIN) is fu.K6T
    (m, P), scale, want = sigma_case(B, n, method)
    got = fu.fused_sigma(torch.as_tensor(m.astype(dtype)),
                         torch.as_tensor(P.astype(dtype)), scale, method)
    assert_close(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sigma_aug_wrapper_at_a_tiled_shape_matches_jax(dtype):
    assert fu.sigma_aug_kernel(300, 45, "cholesky", 4, H100_OPTIN) is fu.K7T
    args, scale, want = aug_case(1, 300, 45, "cholesky")
    got = fu.fused_sigma_aug(*(torch.as_tensor(a.astype(dtype))
                               for a in args), scale, "cholesky")
    assert_close(got.numpy(), want, dtype)


# ---------------------------------------------------------------------------
# The factor's launch and scratch, held to the CUDA source
# ---------------------------------------------------------------------------

CSRC = (Path(__file__).resolve().parents[1] / "bayesianfiltering_tpu_torch"
        / "csrc")


def _cxx_block(src: str, head: str) -> str:
    """The definition that starts with the line matching ``head`` (a
    regular expression), to its closing brace (and ';' for a struct)."""
    found = re.search(rf"^{head}[^;{{]*{{", src, re.M)
    assert found is not None, f"no definition matching {head}"
    start, depth, i = found.start(), 0, found.end() - 1
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            end = src[start:i + 1]
            return end + (";" if head.startswith("struct") else "")
        i += 1


# (kind, shape): config 5's and the bands' edges (K1 to dy = 512, K6–K9 to
# every dimension 1,024)
PLAN_CASES = [("k6t", (1, 512, "cholesky")), ("k6t", (1, 1024, "cholesky")),
              ("k6t", (3, 241, "cholesky")), ("k6t", (1, 512, "sqrtm")),
              ("k6t", (1, 1024, "sqrtm")), ("k7t", (1, 512, 512, "cholesky")),
              ("k7t", (2, 1000, 24, "cholesky")),
              ("k7t", (1, 512, 256, "cholesky")),
              ("k7t", (145, 64, 64, "cholesky")),
              ("k7t", (1, 512, 512, "sqrtm")), ("k7t", (2, 300, 45, "sqrtm")),
              ("k9t", (1, 1024, 512)), ("k9t", (1, 2048, 1024)),
              ("k9t", (3, 600, 300)), ("k1t", (512, 256)),
              ("k1t", (512, 128)), ("k1t", (64, 512)), ("k1t", (512, 512)),
              ("k1t", (9, 1)), ("k8t", (1024, 512, 256)),
              ("k8t", (2048, 1024, 1024)), ("k8t", (130, 100, 33)),
              ("k2t", (512, 512)), ("k2t", (200, 70)), ("k2t", (100, 1)),
              ("k2t", (33, 97))]
# (dy, height, B, dn, B2) of the factor's task plan: K6t, K1t and K8t
# alone (B2 = 0), K7t's P and C side by side at config 5's dn = 512 and
# 256, at dx ≠ dn both ways and ragged
TASK_CASES = [(512, 512, 1, 0, 0), (1024, 1024, 1, 0, 0), (241, 241, 3, 0, 0),
              (256, 1025, 1, 0, 0), (128, 897, 1, 0, 0), (512, 1089, 1, 0, 0),
              (33, 99, 2, 0, 0), (1, 11, 1, 0, 0), (256, 769, 1, 0, 0),
              (1024, 2049, 1, 0, 0), (33, 134, 2, 0, 0),
              (512, 512, 1, 512, 1), (512, 512, 1, 256, 1),
              (64, 64, 145, 64, 1), (121, 121, 1, 512, 1),
              (100, 100, 2, 45, 1), (5, 5, 3, 70, 1)]
# (dy, height, k) of ``step_tasks``: the first, a middle and the last
# steps, past the chain's end, and with rows under S
STEP_CASES = [(512, 512, 0), (512, 512, 7), (512, 512, 14), (512, 512, 15),
              (256, 256, 9), (241, 241, 3), (256, 769, 0), (33, 99, 0),
              (1, 11, 0)]
# (ta, tb, K, SMs) of gemm2's split: K2t at config 5 (128 + 128 tiles of
# 64 × 32), at dx = 200, dq = 70, K7t's Newton–Schulz pairs at dn = 512,
# 256 and 45 (dx = 300), the edges of the split-of-2 rule
PAIR_CASES = [(128, 128, 512, 132), (28, 12, 200, 132),
              (128, 32, 512, 132), (45, 2, 300, 132), (132, 33, 512, 132),
              (132, 34, 512, 132), (133, 20, 512, 132), (100, 40, 64, 132),
              (100, 40, 128, 132)]
# (tiles, K, SMs) of tiled.cuh's k-split rule: K2t's two products grouped
# and apart, K8t's moments and covariance, K9t's product (config 5's 72
# lower tiles over 1,024 rows), K1t's gain, the edges
SPLIT_CASES = [(256, 512, 132), (128, 512, 132), (84, 1024, 132),
               (72, 1024, 132), (20, 256, 132), (33, 256, 132),
               (34, 256, 132), (132, 64, 132), (133, 4096, 132),
               (8, 63, 132), (8, 64, 132), (8, 127, 132), (8, 128, 132),
               (1, 1, 132), (30, 512, 114)]


@pytest.fixture(scope="module")
def cuda_plan(tmp_path_factory):
    """The scratch sizes and the factor's task counts as the CUDA sources
    compute them (``AugLayout``, ``step_tasks``, ``factor_tasks`` of one
    problem or two, ``factor_elems``, the update scratches, K2t's and
    K9t's), and tiled.cuh's k-split rules (``gemm_split``,
    ``pair_split``), compiled by the host compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    chol = (CSRC / "tiled_chol.cuh").read_text()
    sigma = (CSRC / "sigma_tiled.cu").read_text()
    ekf = (CSRC / "ekf_tiled.cu").read_text()
    ut = (CSRC / "ut_tiled.cu").read_text()
    tiled = (CSRC / "tiled.cuh").read_text()
    lines = []
    for kind, shape in PLAN_CASES:
        if kind in ("k6t", "k7t"):
            *dims, method = shape
            code = 1 if method == "sqrtm" else 0
            args = ", ".join(map(str, dims))
            fn = "factor_elems" if kind == "k6t" else "aug_elems"
            lines.append(f'  std::printf("%lld\\n", {fn}({args}, {code}));')
        elif kind == "k1t":
            lines.append('  std::printf("%lld\\n", UpdateScratch({}, {}).f.'
                         'total);'.format(*shape))
        elif kind == "k2t":
            lines.append('  std::printf("%lld\\n", predict_scratch({}, {}));'
                         .format(*shape))
        elif kind == "k9t":
            lines.append('  std::printf("%lld\\n", predict_scratch_elems({}, '
                         '{}, {}));'.format(*shape))
        else:
            lines.append('  std::printf("%lld\\n", UtUpdateScratch({}, {}, '
                         '{}).f.total);'.format(*shape))
    for dy, h, B, dn, B2 in TASK_CASES:
        lines.append(f'  std::printf("%lld\\n", factor_tasks(AugLayout(0, '
                     f'{dy}, {h}), {B}, AugLayout(0, {dn}, {dn}), {B2}));')
    for tiles, K, sms in SPLIT_CASES:
        lines.append(f'  std::printf("%lld\\n", (long long)gemm_split('
                     f'{tiles}, {K}, {sms}));')
    for dy, h, k in STEP_CASES:
        lines.append(f'  std::printf("%lld\\n", step_tasks(AugLayout(0, '
                     f'{dy}, {h}), {k}));')
    for ta, tb, K, sms in PAIR_CASES:
        lines.append(f'  std::printf("%lld\\n", (long long)pair_split('
                     f'{ta}, {tb}, {K}, {sms}));')
    prog = "\n".join(
        ["#include <cstdio>", "#define __host__", "#define __device__",
         "constexpr int kNb = 32;", "constexpr int kSqrtm = 1;",
         "constexpr int kGemmBK = 16;", "constexpr int kMaxSplit = 4;",
         _cxx_block(tiled, r"inline int gemm_split"),
         _cxx_block(tiled, r"inline int pair_split"),
         _cxx_block(chol, r"__host__ __device__ inline int tiles_of"),
         _cxx_block(chol, r"struct AugLayout"),
         _cxx_block(chol, r"__host__ __device__ inline long long step_tasks"),
         _cxx_block(chol, r"inline long long factor_tasks"),
         _cxx_block(sigma, r"__host__ __device__ inline long long ns_stride"),
         _cxx_block(sigma, r"long long factor_stride"),
         _cxx_block(sigma, r"long long factor_elems"),
         "long long aug_elems(int B, int dx, int dn, int method) {",
         "  return factor_elems(B, dx, method) + factor_elems(1, dn, "
         "method);", "}",
         _cxx_block(ekf, r"struct UpdateScratch"),
         _cxx_block(ekf, r"long long predict_scratch"),
         _cxx_block(ut, r"struct UtUpdateScratch"),
         _cxx_block(ut, r"long long predict_scratch_elems"),
         "int main() {"] + lines + ["}"])
    tmp = tmp_path_factory.mktemp("plan")
    (tmp / "plan.cpp").write_text(prog)
    subprocess.run([cxx, "-std=c++17", "-o", str(tmp / "plan"),
                    str(tmp / "plan.cpp")], check=True)
    out = subprocess.run([str(tmp / "plan")], check=True, capture_output=True,
                         text=True).stdout.split()
    values = iter(map(int, out))
    got = [{case: next(values) for case in cases}
           for cases in (PLAN_CASES, TASK_CASES, SPLIT_CASES, STEP_CASES,
                         PAIR_CASES)]
    assert next(values, None) is None
    return got


MIRRORS = {"k6t": testing.k6t_scratch, "k7t": testing.k7t_scratch,
           "k1t": testing.k1t_scratch, "k8t": testing.k8t_scratch,
           "k2t": testing.k2t_scratch, "k9t": testing.k9t_scratch}


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_the_scratch_mirror_matches_the_cuda_source(cuda_plan, case):
    kind, shape = case
    assert MIRRORS[kind](*shape) == cuda_plan[0][case]


def test_the_task_counts_match_the_cuda_source(cuda_plan):
    for (dy, h, B, dn, B2), got in cuda_plan[1].items():
        assert testing.factor_tasks(dy, h, B, (dn, B2) if B2 else None) == got


def test_the_product_split_matches_the_cuda_source(cuda_plan):
    for (tiles, K, sms), got in cuda_plan[2].items():
        assert testing.gemm_split(tiles, K, sms) == got


def test_the_step_tasks_match_the_cuda_source(cuda_plan):
    for (dy, h, k), got in cuda_plan[3].items():
        assert testing.step_tasks(k, dy, h) == got


def test_the_pair_split_matches_the_cuda_source(cuda_plan):
    """gemm2's split: K2t at config 5 keeps 1, K7t's Newton–Schulz pair at
    dn = 256 takes 2."""
    got = cuda_plan[4]
    for (ta, tb, K, sms), split in got.items():
        assert testing.pair_split(ta, tb, K, sms) == split
    assert got[(128, 128, 512, 132)] == 1 and got[(128, 32, 512, 132)] == 2


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("dy,height,B,epi,blocks,barriers,in_l2", [
    (512, 512, 1, "points", 132, 16, (True, True)),   # K6t, config 5
    (512, 512, 1, "points:512", 132, 16, (True, True)),  # K7t, P and C
    (256, 1025, 1, "gain", 132, 9, (True, True)),     # K1t, config 5
    (128, 897, 1, "gain", 81, 5, (True, True)),       # update_chunk=128
    (256, 1281, 1, "gain", 132, 9, (True, True)),     # K1t at dx = 768
    (1024, 1024, 1, "points", 132, 32, (True, True)),  # K6t, band's edge
    (512, 1089, 1, "gain", 132, 17, (True, True)),    # K1t, dx=64, dy=512
    (1024, 3073, 1, "gain", 132, 33, (True, True)),   # I rows at 1,024²
    (241, 241, 3, "points", 132, 8, (True, True)),    # a batch, ragged
])
def test_the_factor_launch_at_config_5_and_the_edges(itemsize, dy, height,
                                                      B, epi, blocks,
                                                      barriers, in_l2):
    """One cooperative launch on min(SMs, tasks) blocks, one barrier a
    panel (and one before the epilogue where a last phase runs), in both
    dtypes; W and L stay in the H100's 50 MiB L2 at every shape of the band
    (K8t's edge in float64 takes 48 MiB of it)."""
    epi, _, dn = epi.partition(":")
    plan = testing.factor_launch(dy, height, B, itemsize, epi,
                                 dn=int(dn or 0))
    assert plan == {"route": "grid", "launches": 1, "blocks": blocks,
                    "barriers": barriers,
                    "in_l2": in_l2[itemsize == 8]}


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("dx,dy,B,blocks,barriers", [
    (512, 256, 1, 132, 9),     # config 5: W of 769 rows
    (1024, 1024, 1, 132, 33),  # the band's edge: 2,049 rows
    (100, 33, 2, 26, 3),       # ragged: 134 rows; the epilogue's 202 warps
    (9, 1, 3, 4, 2),           # one pivot: the last phase alone
])
def test_the_k8t_factor_launch_has_no_identity_rows(itemsize, dx, dy, B,
                                                    blocks, barriers):
    """K8t's W = [S; Cᵀ; innovᵀ] (dy + dx + 1 rows): one cooperative
    launch, with the gain's epilogue over its dx rows of Zᵀ, in L2."""
    height = dy + dx + 1
    plan = testing.factor_launch(dy, height, B, itemsize, "gain",
                                 identity=False)
    assert plan == {"route": "grid", "launches": 1, "blocks": blocks,
                    "barriers": barriers, "in_l2": True}
    assert testing.k8t_layout(1, dx, dy)["l"] == height * dy
