"""The lane combines K10 and K12 (dx ≤ 8) written out in numpy, group by
group, on the CPU.

``csrc/bank_combine.cu`` ``bank_combine_kernel`` (K10) and
``bank_smoother_combine_kernel`` (K12) give each lane a group of MX
threads (MX = 4 for dx ≤ 4, 8 above), thread i of a group holding row i
of every matrix of its lane. Below, every array has one row a "thread":
registers are (lanes, MX, MX) or (lanes, MX) arrays, a shuffle is an
index exchange inside the group, and the group's board (the kernel's
shared memory: five slots of an MX × MX matrix and an MX-vector) is a
(lanes, 5, MX(MX + 1)) array seeded with NaN, so that a read of an entry
no thread wrote shows. The steps are the kernel's, in its order and with
its slots: the trace by a butterfly of shuffles, the Cholesky factors as
a column sweep (the pivot and the column shuffled from their owners, one
reciprocal square root a column), the forward substitution over the
group, the products with their right operand's rows read from the board
and a transposed operand's column read from it. Rows past dx are zero
padding with a unit diagonal in the factored matrix C1 + εI.

Each schedule is held to the JAX package's XLA twins
``bank_combine._combine_xla`` and ``bank_smoother._scombine_xla``
(float64) at dx = 1, 2, 3, 4, 5 and 8, in float64 and float32, with the
left operand broadcast (Ml < M), the right operand broadcast (Mr < M),
and neither; K10 with a guard lane (C1 with a negative eigenvalue below
ε: U zeroed), a C1 with an infinite entry, a NaN in b1 and a NaN in J2
(the inner factor fails: the lane is NaN throughout), each with the
twin's non-finite entries. The 16-byte and the scalar load paths are two
index maps over the same memory, and the launch's groups cover every
lane once. The CUDA kernels run only on the card
(tests/test_torch_cuda.py).

Tolerances (relative to max(1, max|reference|) over the finite entries):
float64 1e-10, float32 1e-3 (the bound chip_smoke.py holds every kernel
to): the same function in another order of summation.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesianfiltering_tpu.ops import bank_combine as jbc
from bayesianfiltering_tpu.ops import bank_smoother as jbs
from bayesianfiltering_tpu_torch import testing
from bayesianfiltering_tpu_torch.testing import Group

TOL = {"float64": 1e-10, "float32": 1e-3}
DXS = (1, 2, 3, 4, 5, 8)
GROUP_THREADS = 64  # csrc/bank_combine.cu kGroupThreads
H100_SMS = 132
M, P = 8, 4         # lanes, and the lanes of a broadcast operand


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
    return [np.asarray(o) for o in _COMPILED[key](*args)]


def _combine_xla(*a):
    return jbc._combine_xla(a[:5], a[5:])


def _scombine_xla(*a):
    return jbs._scombine_xla(a[:3], a[3:])


def group_width(dx):
    """MX: the threads of a lane's group (the kernel's template width)."""
    return 4 if dx <= 4 else 8


# ---------------------------------------------------------------------------
# The launch and the loads
# ---------------------------------------------------------------------------

def launch(M, mx):
    """(blocks, [(block, group, lane, live)]) of a launch over M lanes:
    GROUP_THREADS / MX groups a block, a group past M computing on lane
    M − 1 without storing; a warp whose groups are all past M returns."""
    per_block = GROUP_THREADS // mx
    blocks = -(-M // per_block)
    groups = []
    for blk in range(blocks):
        for w in range(GROUP_THREADS // 32):
            first = blk * per_block + w * (32 // mx)
            if first >= M:
                continue  # the whole warp returns
            for g in range(w * (32 // mx), (w + 1) * (32 // mx)):
                m0 = blk * per_block + g
                groups.append((blk, g, min(m0, M - 1), m0 < M))
    return blocks, groups


@pytest.mark.parametrize("M,mx", [(1, 4), (62, 4), (7_813, 4), (1, 8),
                                  (129, 8)])
def test_the_launch_covers_every_lane_once(M, mx):
    blocks, groups = launch(M, mx)
    live = sorted(lane for *_, lane, ok in groups if ok)
    assert live == list(range(M))
    assert all(lane == M - 1 for *_, lane, ok in groups if not ok)
    if M == 7_813:
        # path B's in-chunk level spreads over every SM of an H100
        assert blocks == 489 and blocks >= 3 * H100_SMS


def vec_path(dx, itemsize, offsets):
    """The kernel's ``vec`` flag: 16-byte row loads and stores where a
    row's bytes are a multiple of 16 and every operand starts on a
    16-byte boundary (``offsets``: their byte offsets)."""
    return (dx * itemsize) % 16 == 0 and all(o % 16 == 0 for o in offsets)


def row_index_map(dx, mx, itemsize, lane, vec):
    """Thread i's flat element indices of its row of lane ``lane``'s
    dx × dx matrix, one list a load instruction, padded slots None: the
    16-byte path loads 16 / itemsize consecutive elements an instruction,
    the scalar path one."""
    nv = 16 // itemsize if vec else 1
    base = lane * dx * dx
    rows = []
    for i in range(mx):
        loads = []
        for c in range(mx // nv):
            live = i < dx and c * nv < dx
            loads.append([base + i * dx + c * nv + e if live else None
                          for e in range(nv)])
        rows.append(loads)
    return rows


def gather(flat, index_map, dtype):
    """The (MX, MX) registers the index map fills from ``flat``."""
    out = []
    for loads in index_map:
        row = [flat[k] if k is not None else 0.0 for ld in loads for k in ld]
        out.append(row)
    return np.asarray(out, dtype)


@pytest.mark.parametrize("dx,itemsize", [(4, 4), (8, 4), (2, 8), (4, 8),
                                         (6, 8), (8, 8)])
def test_the_16_byte_and_scalar_loads_read_the_same_values(dx, itemsize):
    """Where the flag holds, both index maps fill the same registers, every
    16-byte load starts on a 16-byte boundary, and a warp's first loads
    of one matrix read one contiguous stretch."""
    mx = group_width(dx)
    dtype = np.float32 if itemsize == 4 else np.float64
    flat = np.random.default_rng(dx).standard_normal(6 * dx * dx)
    assert vec_path(dx, itemsize, [0, 64 * 4])
    for lane in range(6):
        vec = row_index_map(dx, mx, itemsize, lane, True)
        scalar = row_index_map(dx, mx, itemsize, lane, False)
        np.testing.assert_array_equal(gather(flat, vec, dtype),
                                      gather(flat, scalar, dtype))
        for loads in vec:
            for ld in loads:
                if ld[0] is not None:
                    assert ld == list(range(ld[0], ld[0] + len(ld)))
                    assert (ld[0] * itemsize) % 16 == 0
    # a warp's groups take consecutive lanes: its loads of one matrix read
    # one stretch without gaps (with one load a row, a single instruction
    # reads it: 512 bytes at dx = 4 in float32)
    warp = [row_index_map(dx, mx, itemsize, lane, True)
            for lane in range(32 // mx)]
    every = sorted(k for rows in warp for loads in rows for ld in loads
                   for k in ld if k is not None)
    assert every == list(range((32 // mx) * dx * dx))
    if dx * itemsize == 16:
        first = sorted(k for rows in warp for loads in rows
                       for k in loads[0] if k is not None)
        assert first == every


@pytest.mark.parametrize("dx,itemsize,offsets,want", [
    (3, 4, [0], False),        # 12-byte rows: scalar
    (5, 8, [0], False),        # float64 at an odd width
    (4, 4, [0, 8], False),     # an operand off its 16-byte boundary
    (4, 4, [0, 64 * 7], True),  # a broadcast operand's lanes start where
                                # any lane does
    (2, 4, [0], False),
    (2, 8, [0], True),
])
def test_the_vector_flag(dx, itemsize, offsets, want):
    assert vec_path(dx, itemsize, offsets) == want


# ---------------------------------------------------------------------------
# The group's operations
# ---------------------------------------------------------------------------

def store(out, R, dx):
    """The real dx × dx block (or dx entries) of the threads' rows."""
    if R.ndim == 3:
        out[:] = R[:, :dx, :dx]
    else:
        out[:] = R[:, :dx]


# ---------------------------------------------------------------------------
# K10 and K12, step by step
# ---------------------------------------------------------------------------

def k10_model(left, right, dtype):
    """``bank_combine_kernel`` over M = max(Ml, Mr) lanes, the left operand
    read at lane m mod Ml and the right at m mod Mr."""
    dx = left[0].shape[-1]
    Ml, Mr = left[0].shape[0], right[0].shape[0]
    Mo = max(Ml, Mr)
    mx = group_width(dx)
    g = Group(Mo, mx, dx, dtype)
    lanes = np.arange(Mo)
    lrow, rrow = lanes % Ml, lanes % Mr
    A1, C1, J1 = (g.load(left[k], lrow) for k in (0, 2, 3))
    b1, e1 = (g.load(left[k], lrow) for k in (1, 4))
    A2, C2, J2 = (g.load(right[k], rrow) for k in (0, 2, 3))
    b2, e2 = (g.load(right[k], rrow) for k in (1, 4))
    i = g.i[None, :]
    real = i < dx
    with np.errstate(invalid="ignore", over="ignore"):
        # ε = 1e-7·tr(C1)/dx + 1e-30; U = chol(C1 + εI), unit pad diagonal
        tr = g.group_sum(np.where(real, g.diag(C1), 0).astype(dtype))
        eps = (dtype(1e-7) * tr / dtype(dx) + dtype(1e-30)).astype(dtype)
        u = C1 + g.eye() * np.where(real, eps, 1)[..., None]
        u, ok, _ = g.chol(u.astype(dtype))
        u = np.where(ok[:, None, None], u, 0).astype(dtype)
        # first exchange: U, J2; b1, η2
        g.put_row(0, u)
        g.put_row(1, J2)
        g.put_el(0, b1)
        g.put_el(1, e2)
        j2u = g.rowmul(J2, 0)
        ucol = g.get_col(0)
        b1v, e2v = g.get_vec(0), g.get_vec(1)
        g.put_row(2, j2u)
        G = g.rowmul(ucol, 2)                      # Uᵀ (J2 U)
        jucol = g.get_col(2)
        g.put_row(3, G)
        inner = (dtype(0.5) * (G + g.get_col(3)) + g.eye()).astype(dtype)
        lin, _, rinv = g.chol(inner)
        # [X | Y] = Lin⁻¹ [Uᵀ | (J2 U)ᵀ], row k final at step k
        rx, ry = ucol.copy(), jucol.copy()
        for k in range(mx):
            own = (i == k)[..., None]
            rx = np.where(own, rx * rinv[..., None], rx).astype(dtype)
            ry = np.where(own, ry * rinv[..., None], ry).astype(dtype)
            g.put_row(0, rx, only=k)
            g.put_row(2, ry, only=k)
            if k + 1 < mx:
                xk, yk = g.get_row(0, k), g.get_row(2, k)
                below = (i > k)[..., None]
                lik = lin[..., k:k + 1]
                rx = np.where(below, rx - lik * xk, rx).astype(dtype)
                ry = np.where(below, ry - lik * yk, ry).astype(dtype)
        # M⁻¹ = I − Xᵀ Y
        minv = (g.eye() - g.rowmul(g.get_col(0), 2)).astype(dtype)
        g.put_row(3, minv)
        g.put_row(4, A1)
        a2m = g.rowmul(A2, 3)                      # A2 M⁻¹
        mcol, a1col = g.get_col(3), g.get_col(4)
        A = g.rowmul(a2m, 4)                       # (A2 M⁻¹) A1
        v = (b1 + g.dot(C1, e2v)).astype(dtype)    # b1 + C1 η2
        w = (e2 - g.dot(J2, b1v)).astype(dtype)    # η2 − J2 b1
        kr = g.rowmul(mcol, 1)                     # M⁻ᵀ J2
        p = g.rowmul(kr, 4)                        # M⁻ᵀ J2 A1
        # second exchange: C1, P; v, w
        g.put_row(0, C1)
        g.put_row(2, p)
        g.put_el(0, v)
        g.put_el(2, w)
        xc = g.rowmul(a2m, 0)                      # A2 M⁻¹ C1
        b = (g.dot(a2m, g.get_vec(0)) + b2).astype(dtype)
        t = g.dot(mcol, g.get_vec(2))              # M⁻ᵀ w
        q = g.rowmul(a1col, 2)                     # A1ᵀ M⁻ᵀ J2 A1
        # third exchange: A2, Q, J1; t
        g.put_row(1, A2)
        g.put_row(3, q)
        g.put_row(4, J1)
        g.put_el(1, t)
        wr = g.rowmul_t(xc, 1)                     # A2 M⁻¹ C1 A2ᵀ
        J = dtype(0.5) * ((q + g.get_col(3)) + (J1 + g.get_col(4)))
        eta = (g.dot(a1col, g.get_vec(1)) + e1).astype(dtype)
        # fourth exchange: W, C2
        g.put_row(0, wr)
        g.put_row(2, C2)
        C = dtype(0.5) * ((wr + g.get_col(0)) + (C2 + g.get_col(2)))
    out = [np.empty((Mo, dx, dx), dtype), np.empty((Mo, dx), dtype),
           np.empty((Mo, dx, dx), dtype), np.empty((Mo, dx, dx), dtype),
           np.empty((Mo, dx), dtype)]
    for o, R in zip(out, (A, b, C, J, eta)):
        store(o, R, dx)
    return out


def k12_model(earlier, later, dtype):
    """``bank_smoother_combine_kernel``: E = E1 E2, g = E1 g2 + g1,
    L = sym(E1 L2 E1ᵀ + L1)."""
    dx = earlier[0].shape[-1]
    Ml, Mr = earlier[0].shape[0], later[0].shape[0]
    Mo = max(Ml, Mr)
    mx = group_width(dx)
    g = Group(Mo, mx, dx, dtype)
    lanes = np.arange(Mo)
    E1, L1 = (g.load(earlier[k], lanes % Ml) for k in (0, 2))
    g1 = g.load(earlier[1], lanes % Ml)
    E2, L2 = (g.load(later[k], lanes % Mr) for k in (0, 2))
    g2 = g.load(later[1], lanes % Mr)
    with np.errstate(invalid="ignore", over="ignore"):
        g.put_row(0, E2)
        g.put_row(1, L2)
        g.put_row(2, E1)
        g.put_row(3, L1)
        g.put_el(0, g2)
        E = g.rowmul(E1, 0)
        gv = (g.dot(E1, g.get_vec(0)) + g1).astype(dtype)
        x = g.rowmul(E1, 1)                        # E1 L2
        y = g.rowmul_t(x, 2)                       # (E1 L2) E1ᵀ
        g.put_row(4, y)
        L = dtype(0.5) * ((y + g.get_col(4)) + (L1 + g.get_col(3)))
    out = [np.empty((Mo, dx, dx), dtype), np.empty((Mo, dx), dtype),
           np.empty((Mo, dx, dx), dtype)]
    for o, R in zip(out, (E, gv, L)):
        store(o, R, dx)
    return out


# ---------------------------------------------------------------------------
# Against the JAX twins
# ---------------------------------------------------------------------------

def assert_matches(got, want, dtype):
    """The same non-finite entries; the finite ones within TOL."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    bad = ~np.isfinite(want)
    np.testing.assert_array_equal(~np.isfinite(got), bad)
    if (~bad).any():
        scale = max(1.0, float(np.abs(want[~bad]).max()))
        np.testing.assert_allclose(got[~bad], want[~bad], rtol=0,
                                   atol=TOL[dtype] * scale)


def tiled(x, reps):
    return np.concatenate([x] * reps)


def filter_left(rng, lanes, dx):
    """Left elements with the guard lanes 0 (a −1e-8 eigenvalue) and 1 (an
    infinite entry of C1) and a NaN in b1 of lane 2."""
    left = testing.guard_lanes(rng, testing.filter_elements(rng, lanes, dx))
    left[1][2, 0] = np.nan
    return left


def filter_right(rng, lanes, dx):
    """Right elements with a NaN in J2 of lane 3 (its inner factor fails)."""
    right = tuple(np.array(x, copy=True)
                  for x in testing.filter_elements(rng, lanes, dx))
    right[3][3, 0, 0] = np.nan
    return right


@functools.lru_cache(maxsize=None)
def combine_case(dx, side):
    """(left, right, JAX's combine over the expanded operands): ``side`` is
    the broadcast one, read at m mod P."""
    rng = np.random.default_rng(dx)
    if side == "left":
        left, right = filter_left(rng, P, dx), filter_right(rng, M, dx)
        full = [tiled(x, M // P) for x in left] + list(right)
    else:
        left, right = filter_left(rng, M, dx), filter_right(rng, P, dx)
        full = list(left) + [tiled(x, M // P) for x in right]
    return left, right, _jax_run(_combine_xla, *full), full


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("dx", DXS)
def test_k10_schedule_matches_jax(dx, side, dtype):
    """The broadcast operand read in place, and the same operands
    expanded (no broadcast); the guard lanes, the NaN in b1 (b and η
    non-finite) and in J2 (the lane NaN throughout) as in the twin."""
    left, right, want, full = combine_case(dx, side)
    dt = np.dtype(dtype).type
    for got in (k10_model(left, right, dt),
                k10_model(tuple(full[:5]), tuple(full[5:]), dt)):
        for gv, w in zip(got, want):
            assert_matches(gv, w, dtype)
    # the guard lane is finite, the NaN-J2 lane NaN throughout
    got = k10_model(tuple(full[:5]), tuple(full[5:]), dt)
    assert all(np.isfinite(o[0]).all() for o in got)
    assert all(np.isnan(o[3]).all() for o in got)


@pytest.mark.parametrize("dx", [4, 8])
def test_k10_guard_zeroes_u(dx):
    """Lane 0's factor fails on the group (a −1e-8 eigenvalue below ε) in
    both dtypes, so its M⁻¹ is I: A = A2 A1 exactly as the twin's."""
    left, right, want, _ = combine_case(dx, "right")
    for dtype in ("float64", "float32"):
        dt = np.dtype(dtype).type
        g = Group(1, group_width(dx), dx, dt)
        C1 = g.load(left[2], [0])
        i = g.i[None, :]
        tr = g.group_sum(np.where(i < dx, g.diag(C1), 0).astype(dt))
        eps = dt(1e-7) * tr / dt(dx) + dt(1e-30)
        _, ok, _ = g.chol((C1 + g.eye() * np.where(i < dx, eps, 1)[
            ..., None]).astype(dt))
        assert not ok[0]
        A = k10_model(left, right, dt)[0][0]
        np.testing.assert_allclose(A, (right[0][0] @ left[0][0]),
                                   rtol=0, atol=TOL[dtype] * 10)


@functools.lru_cache(maxsize=None)
def smoother_case(dx, side):
    rng = np.random.default_rng(100 + dx)
    make = lambda lanes: tuple(np.array(x, copy=True) for x in
                               testing.smoother_elements(rng, lanes, dx))
    if side == "left":
        earlier, later = make(P), make(M)
        later[0][2, 0, dx - 1] = np.nan  # E's column dx − 1 of lane 2
        full = [tiled(x, M // P) for x in earlier] + list(later)
    else:
        earlier, later = make(M), make(P)
        earlier[2][1, 0, 0] = np.nan     # L1 of lane 1
        full = list(earlier) + [tiled(x, M // P) for x in later]
    return earlier, later, _jax_run(_scombine_xla, *full), full


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("dx", DXS)
def test_k12_schedule_matches_jax(dx, side, dtype):
    earlier, later, want, full = smoother_case(dx, side)
    dt = np.dtype(dtype).type
    for got in (k12_model(earlier, later, dt),
                k12_model(tuple(full[:3]), tuple(full[3:]), dt)):
        for gv, w in zip(got, want):
            assert_matches(gv, w, dtype)
