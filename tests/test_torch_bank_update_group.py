"""The bank update K3 and bank predict K4 (d ≤ 8) written out in numpy,
group by group, on the CPU.

``csrc/bank_update.cu`` ``bank_update_kernel`` (K3) and
``bank_predict_cov_kernel`` (K4) give each component a group of MX threads
(MX = 4 where every dimension is ≤ 4, else 8) on ``csrc/lane_group.cuh``,
thread i holding row i of each of the component's matrices. Below, the
numpy model ``testing.Group`` stands for the groups (one array row a
thread, shuffles as index exchanges, the board seeded with NaN so that a
read of an entry no thread wrote shows), and the steps are the kernels',
in their order and with their slots and bounds: K3's H P and
X = Rt + (H P) Hᵀ, S = sym(X) from a column read, the relative floor
from a butterfly maximum, the factor (over the dy real pivots in the
groups of 4 threads, over all 8 with unit padded pivots in those of 8), each
thread's forward and back substitution on its column of H P with L's rows
from the board, A = I − K H, the Joseph form and its symmetrisation; K4's
(Fx P) Fxᵀ + (Fq Q) Fqᵀ and its symmetrisation.

Each schedule is held to the JAX package's XLA twins
``bank_update._update_xla`` and ``_predict_cov_xla`` (float64) at
(dx, dy or dq) = (4, 1), (4, 2), (1, 1), (3, 3), (5, 7) and (8, 8), in
float64 and float32; a non-positive-definite S makes every output of its
lane NaN and leaves the others as they were; the launch covers every
component once; the 16-byte and the scalar loads read the same values for
each operand's row width; the boards' reads fall in distinct banks. The
CUDA kernels run only on the card (tests/test_torch_cuda.py).

Tolerances (relative to max(1, max|reference|)): float64 1e-10, float32
1e-3 (the bound chip_smoke.py holds every kernel to): the same function in
another order of summation.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu.ops import bank_update as jbu
from bayesianfiltering_tpu_torch import testing
from bayesianfiltering_tpu_torch.ops import ekf as tekf
from bayesianfiltering_tpu_torch.testing import Group

TOL = {"float64": 1e-10, "float32": 1e-3}
WIDTHS = ((4, 1), (4, 2), (1, 1), (3, 3), (5, 7), (8, 8))
GROUP_THREADS = 64   # csrc/lane_group.cuh kGroupThreads
UPDATE_SLOTS = 6     # csrc/bank_update.cu kUpdateSlots
PREDICT_SLOTS = 5    # kPredictSlots
ELEMENTS_SLOTS = 4   # csrc/bank_combine.cu kElementsSlots (K11)
LOG_2PI = math.log(2.0 * math.pi)
REL_JITTER = 1e-6    # csrc/common.cuh kRelJitter
LANES = 6
JITTER = 1e-4


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
_COMPILED = {}


def _jax_run(fn, *args):
    """``fn(*args)`` in float64, compiled once per function and shapes."""
    args = [jnp.asarray(a, jnp.float64) for a in args]
    key = (fn, tuple(a.shape for a in args))
    if key not in _COMPILED:
        _COMPILED[key] = jax.jit(fn).lower(*args).compile(FAST_COMPILE)
    out = _COMPILED[key](*args)
    return [np.asarray(o) for o in (out if isinstance(out, (tuple, list))
                                    else (out,))]


def _update_xla(m, P, Hx, Rt, innov):
    return jbu._update_xla(m, P, Hx, Rt, innov, JITTER)


def group_width(*dims):
    """MX: the threads of a component's group (the kernels' template
    width)."""
    return 4 if max(dims) <= 4 else 8


# ---------------------------------------------------------------------------
# K3 and K4, step by step
# ---------------------------------------------------------------------------

def k3_model(m, P, Hx, Rt, innov, jitter, dtype):
    """``bank_update_kernel`` over M = len(m) components. Returns
    ``(ll, mean, cov, gain)``."""
    M, dx = m.shape
    dy = innov.shape[-1]
    mx = group_width(dx, dy)
    ny = dy if mx == 4 else mx  # the bound of the factor, solves, products
    g = Group(M, mx, dx, dtype, slots=UPDATE_SLOTS)
    lanes = np.arange(M)
    p, h, r = (g.load(x, lanes) for x in (P, Hx, Rt))
    mi, ei = g.load(m, lanes), g.load(innov, lanes)
    i = g.i[None, :]
    own = (g.i[:, None] == g.i[None, :])[None]      # thread i's entry i
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        # first exchange: P, H, Rt | innov
        g.put_row(0, p)
        g.put_row(1, h)
        g.put_row(2, r)
        g.put_el(2, ei)
        hp = g.rowmul(h, 0)                            # H P
        x = (r + g.rowmul_t(hp, 1, ny)).astype(dtype)  # Rt + (H P) Hᵀ
        # second exchange: H P, X
        g.put_row(3, hp)
        g.put_row(4, x)
        s = (dtype(0.5) * (x + g.get_col(4))).astype(dtype)
        hpc = g.get_col(3)                             # column i of H P
        smax = g.group_max(np.where(i < dy, np.abs(g.diag(s)), 0)
                           .astype(dtype))
        s_floor = (dtype(jitter) + dtype(REL_JITTER) * smax).astype(dtype)
        s = np.where(own, np.where((i < dy)[..., None],
                                   s + s_floor[..., None], 1), s).astype(dtype)
        L, ok, rinv = g.chol(s, ny)
        L = np.where(ok[:, None, None], L, np.nan).astype(dtype)
        rinv = np.where(ok[:, None], rinv, np.nan).astype(dtype)
        # third exchange: L | 1/diag(L); the substitutions on each thread
        g.put_row(5, L)
        g.put_el(5, rinv)
        rl, inn = g.get_vec(5), g.get_vec(2)
        y = np.zeros((M, mx, mx), dtype)   # each thread's y, then its k
        z = np.zeros((M, mx, mx), dtype)
        logdet = np.zeros((M, mx), dtype)
        for j in range(ny):
            lj = g.get_row(5, j)
            a, b = hpc[..., j], inn[..., j]
            for k in range(j):
                a = a - lj[..., k] * y[..., k]
                b = b - lj[..., k] * z[..., k]
            y[..., j] = a * rl[..., j]
            z[..., j] = b * rl[..., j]
            logdet = (logdet + np.log(lj[..., j])).astype(dtype)
        for j in reversed(range(ny)):
            lj = g.get_row(5, j)
            y[..., j] = y[..., j] * rl[..., j]
            for k in range(j):
                y[..., k] = y[..., k] - lj[..., k] * y[..., j]
        a = (g.eye() - g.rowmul(y, 1, ny)).astype(dtype)   # I − K H
        # fourth exchange: A, K
        g.put_row(3, a)
        g.put_row(4, y)
        ap = g.rowmul(a, 0)
        kr = g.rowmul(y, 2, ny)
        cr = (g.rowmul_t(ap, 3) + g.rowmul_t(kr, 4)).astype(dtype)
        # fifth exchange: C
        g.put_row(5, cr)
        cov = dtype(0.5) * (cr + g.get_col(5))
        mean = (mi + g.dot(y, inn)).astype(dtype)
        zsq = g.dot(z, z)
        ll = (dtype(-0.5) * (dtype(dy * LOG_2PI) + dtype(2) * logdet + zsq))
    return (ll[:, 0].astype(dtype), mean[:, :dx], cov[:, :dx, :dx],
            y[:, :dx, :dy])


def k4_model(Fx, P, Fq, Q, dtype):
    """``bank_predict_cov_kernel`` over M = len(Fx) components, Q shared."""
    M, dx = Fx.shape[:2]
    dq = Fq.shape[-1]
    mx = group_width(dx, dq)
    g = Group(M, mx, dx, dtype, slots=PREDICT_SLOTS)
    lanes = np.arange(M)
    fx, p, fq = (g.load(x, lanes) for x in (Fx, P, Fq))
    q = g.load(np.broadcast_to(Q, (M,) + Q.shape), lanes)
    with np.errstate(invalid="ignore", over="ignore"):
        g.put_row(0, p)
        g.put_row(1, q)
        g.put_row(2, fx)
        g.put_row(3, fq)
        fp = g.rowmul(fx, 0)                                  # Fx P
        fqq = g.rowmul(fq, 1, dq if mx == 4 else mx)          # Fq Q
        cr = (g.rowmul_t(fp, 2) + g.rowmul_t(fqq, 3)).astype(dtype)
        g.put_row(4, cr)
        cov = dtype(0.5) * (cr + g.get_col(4))
    return cov[:, :dx, :dx]


# ---------------------------------------------------------------------------
# Against the JAX twins
# ---------------------------------------------------------------------------

def assert_matches(got, want, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


@functools.lru_cache(maxsize=None)
def update_case(dx, dy):
    raw = testing.update_inputs(np.random.default_rng(10 * dx + dy), LANES,
                                dx, dy)
    return raw, _jax_run(_update_xla, *raw)


@functools.lru_cache(maxsize=None)
def predict_case(dx, dq):
    raw = testing.predict_inputs(np.random.default_rng(100 + 10 * dx + dq),
                                 LANES, dx, dq)
    return raw, _jax_run(jbu._predict_cov_xla, *raw)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dx,dy", WIDTHS)
def test_k3_schedule_matches_jax(dx, dy, dtype):
    raw, want = update_case(dx, dy)
    dt = np.dtype(dtype).type
    got = k3_model(*raw, JITTER, dt)
    for gv, w in zip(got, want):
        assert gv.dtype == np.dtype(dtype)
        assert_matches(gv, w, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dx,dq", WIDTHS)
def test_k4_schedule_matches_jax(dx, dq, dtype):
    raw, (want,) = predict_case(dx, dq)
    got = k4_model(*raw, np.dtype(dtype).type)
    assert got.dtype == np.dtype(dtype)
    assert_matches(got, want, dtype)


@pytest.mark.parametrize("dx,dy,fail_at", [(4, 1, 0), (4, 2, 1), (5, 7, 6),
                                           (8, 8, 0)])
def test_k3_non_pd_s_makes_its_lane_nan(dx, dy, fail_at):
    """Rt with −1e3 at pivot ``fail_at`` of lane 2: S fails there (at its
    last real pivot for fail_at = dy − 1), every output of lane 2 is NaN,
    as the plain version's (``cholesky_nan``), and the other lanes match
    the plain version."""
    m, P, Hx, Rt, innov = testing.update_inputs(np.random.default_rng(dy),
                                                LANES, dx, dy)
    Rt = Rt.copy()
    Rt[2, fail_at, fail_at] = -1e3
    got = k3_model(m, P, Hx, Rt, innov, JITTER, np.float64)
    want = tekf.chol_update_precomputed(
        *(torch.as_tensor(a) for a in (m, P, Hx, Rt, innov)), JITTER)
    for gv, w in zip(got, want):
        w = w.numpy()
        assert np.isnan(gv[2]).all() and np.isnan(w[2]).all()
        keep = np.arange(LANES) != 2
        np.testing.assert_allclose(gv[keep], w[keep], rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# The launch, the loads and the board
# ---------------------------------------------------------------------------

def launch(M, mx):
    """(blocks, [(block, group, lane, live)]) of a launch over M
    components: GROUP_THREADS / MX groups a block, a group past M computing
    on lane M − 1 without storing; a warp whose groups are all past M
    returns."""
    per_block = GROUP_THREADS // mx
    blocks = -(-M // per_block)
    groups = []
    for blk in range(blocks):
        for w in range(GROUP_THREADS // 32):
            if blk * per_block + w * (32 // mx) >= M:
                continue  # the whole warp returns
            for gi in range(w * (32 // mx), (w + 1) * (32 // mx)):
                m0 = blk * per_block + gi
                groups.append((blk, gi, min(m0, M - 1), m0 < M))
    return blocks, groups


@pytest.mark.parametrize("mx", [4, 8])
@pytest.mark.parametrize("M", [1, 50, 200, 4096])
def test_the_launch_covers_every_component_once(M, mx):
    blocks, groups = launch(M, mx)
    live = sorted(lane for *_, lane, ok in groups if ok)
    assert live == list(range(M))
    assert all(lane == M - 1 for *_, lane, ok in groups if not ok)
    if (M, mx) == (200, 4):
        assert blocks == 13  # the AGSF [50,2,2] update: 13 SMs, not 2


def vec_path(cols, itemsize, offsets):
    """An operand's flag (``rows_vec``): 16-byte row loads where its rows
    of ``cols`` elements are a multiple of 16 bytes and every pointer of
    the flag starts on a 16-byte boundary."""
    return (cols * itemsize) % 16 == 0 and all(o % 16 == 0 for o in offsets)


def row_index_map(rows, cols, mx, itemsize, lane, vec):
    """Thread i's flat element indices of its row of lane ``lane``'s
    rows × cols matrix, one list a load instruction, padded slots None."""
    nv = 16 // itemsize if vec else 1
    base = lane * rows * cols
    out = []
    for i in range(mx):
        loads = []
        for c in range(mx // nv):
            if vec:
                live = i < rows and c * nv < cols
                loads.append([base + i * cols + c * nv + e if live else None
                              for e in range(nv)])
            else:
                j = c
                loads.append([base + i * cols + j
                              if i < rows and j < cols else None])
        out.append(loads)
    return out


def gather(flat, index_map, dtype):
    return np.asarray([[flat[k] if k is not None else 0.0
                        for ld in loads for k in ld]
                       for loads in index_map], dtype)


# (rows, cols) of each operand at the main path's widths and the band
# edge: K3's P (dx × dx), H (dy × dx), Rt (dy × dy), gain (dx × dy); K4's
# Fq (dx × dq), Q (dq × dq)
SHAPES = [(4, 4), (1, 4), (2, 4), (1, 1), (4, 1), (4, 2), (2, 2), (8, 8),
          (7, 5), (5, 7), (8, 4)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("rows,cols", SHAPES)
def test_the_16_byte_and_scalar_loads_read_the_same_values(rows, cols,
                                                           itemsize):
    """Where the operand's flag holds, both index maps fill the same
    registers and every 16-byte load starts on a 16-byte boundary; where
    it does not (dy = 1 rows of Rt and the gain, dq = 2 in float32), only
    the scalar map is taken."""
    mx = group_width(rows, cols)
    dtype = np.float32 if itemsize == 4 else np.float64
    flat = np.random.default_rng(rows * cols).standard_normal(
        6 * rows * cols)
    flag = vec_path(cols, itemsize, [0, rows * cols * itemsize * 3])
    assert flag == ((cols * itemsize) % 16 == 0)
    for lane in range(6):
        scalar = gather(flat, row_index_map(rows, cols, mx, itemsize, lane,
                                            False), dtype)
        want = np.zeros((mx, mx), dtype)
        want[:rows, :cols] = flat[lane * rows * cols:(lane + 1) * rows
                                  * cols].reshape(rows, cols)
        np.testing.assert_array_equal(scalar, want)
        if not flag:
            continue
        vec = row_index_map(rows, cols, mx, itemsize, lane, True)
        np.testing.assert_array_equal(gather(flat, vec, dtype), scalar)
        for loads in vec:
            for ld in loads:
                if ld[0] is not None:
                    assert ld == list(range(ld[0], ld[0] + len(ld)))
                    assert (ld[0] * itemsize) % 16 == 0


@pytest.mark.parametrize("dx,dy,itemsize,want", [
    (4, 1, 4, (True, False)),   # the bearings-only update in float32
    (4, 2, 4, (True, False)),
    (4, 2, 8, (True, True)),
    (3, 3, 4, (False, False)),
    (8, 4, 4, (True, True)),
    (5, 7, 8, (False, False)),
])
def test_the_flags_are_per_operand(dx, dy, itemsize, want):
    """K3's two flags: rows of dx (P, H, the covariance) and rows of dy
    (Rt, the gain)."""
    assert (vec_path(dx, itemsize, [0]), vec_path(dy, itemsize, [0])) == want


def board_len(mx, slots):
    """``board_len<MX, Slots>``: a group's board, one MX more where the
    slot count is even."""
    return slots * mx * (mx + 1) + (mx if slots % 2 == 0 else 0)


@pytest.mark.parametrize("slots", [UPDATE_SLOTS, PREDICT_SLOTS,
                                   ELEMENTS_SLOTS])
@pytest.mark.parametrize("mx", [4, 8])
def test_a_warps_board_reads_fall_in_distinct_banks(mx, slots):
    """Float32 words: a warp's column read (thread i of group g at
    g·len + k·MX + i) touches 32 distinct banks, and a row read's groups
    (16 bytes each, one address a group, eight threads a phase) start in
    distinct banks within each phase."""
    stride = board_len(mx, slots)
    assert (stride * 4) % 16 == 0
    groups = 32 // mx
    for k in range(mx):
        col = [(g * stride + k * mx + i) % 32 for g in range(groups)
               for i in range(mx)]
        assert len(set(col)) == 32
    phase = 8 // mx  # groups a phase of eight 16-byte reads
    for k in range(mx):
        for start in range(0, groups, phase):
            banks = [((g * stride + k * mx) % 32) // 4
                     for g in range(start, start + phase)]
            assert len(set(banks)) == len(banks)
