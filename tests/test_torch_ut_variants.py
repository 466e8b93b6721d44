"""The UT kernels' variant rule and the tiled kernels' schedules, on the CPU.

``ops/fused_ut.py`` runs the per-element kernels K8/K9 where their
workspace fits in a block's shared memory and the tiled variants K8t/K9t
otherwise. The rule is held at its edges with the H100's shared-memory
opt-in (232,448 bytes per block) and with smaller ones.

K8t (``csrc/ut_tiled.cu``) is four launches: it centres the sigma points
side by side, V = [Yc | Xc], forms [S; Cᵀ] = lower(w_side·Vᵀ Yc +
w0c·[d0; 0] d0ᵀ) as one product straight into W's rows, factors
W = [S; Cᵀ; innovᵀ] (no I rows) with K1t's one-launch blocked Cholesky
(``testing.augmented_factor``), and forms the covariance as
sym(P) − lower(Zᵀ Z), mirrored, one product over L's rows of Zᵀ whose
epilogue adds ½(P + Pᵀ): the grouped Joseph form, since K = Zᵀ L⁻¹. K9t
is two launches: one pass forms μ (each column summed by row groups in
order, the groups added in a fixed tree), Xc and d0; one product, split
along the points over a cluster at config 5, forms
lower(w_side·Xcᵀ Xc + w0c·d0 d0ᵀ) + sym(Q), mirrored. Both schedules are
written out in numpy, step for step as the launches compute them, on
scratch seeded with NaN and addressed as the kernels address it (the
products block by block, ``testing.run_gemms``; K9t's whole schedule is
``testing.tiled_ut_predict``), and
held to the JAX package's XLA twins (``fused_ut._ut_update_xla``,
``_ut_predict_xla``) at shapes that are not multiples of the panel (32) or
of a tile, with and without R or Q, with points wider than the state
(augmented points), with negative centre weights (``ParamsUKF(0.5, 2,
0)``: w0m = −3, w0c = −0.25), and with a non-positive-definite S failing
in the first, a middle or the last panel. The port's wrappers on CPU tensors (the plain
versions) are held to JAX at shapes the rule sends to the tiled variants.
The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).

The references run in float64. Tolerances (relative to max(1,
max|reference|)): float64 1e-9, float32 1e-4, as
tests/test_torch_ekf_variants.py: the same formulas in another order, and
float32 rounding through a Cholesky of S. At config 5's shapes in float32
the schedules' error against the float64 reference is held to 1.25× that
of the port's float32 plain version: sym(P) − ZᵀZ (against the Joseph
form) and K9t's row split cost no accuracy.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu.ops import fused_ut as jfu
from bayesianfiltering_tpu_torch import testing
from bayesianfiltering_tpu_torch.ops import fused_ut as fu
from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF, ut_weights

torch.set_num_threads(1)

H100_OPTIN = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100
TOL = {"float64": 1e-9, "float32": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def assert_close(got, want, dtype):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.nanmax(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


# the JAX references compile at XLA's lowest optimisation level (their
# blocked factorisations unroll) and once per shape, in float64
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jax_run(fn, *args):
    args = [jnp.asarray(a, jnp.float64) for a in args]
    compiled = jax.jit(fn).lower(*args).compile(FAST_COMPILE)
    return [np.asarray(x) for x in compiled(*args)]

def _jax_update_each(pts, hpts, cy, m, P, R, y, w, add_r):
    """``fused_ut._ut_update_xla`` in float64. Above dy = 16, for a few
    elements, element by element, eagerly, stacked: on a concrete single
    element the JAX package factors S by its native route
    (``utils/linalg._effectively_unbatched``), where the jitted, vmapped
    batch unrolls its blocked factorisation and compiled for 10-20 s at the
    wide shapes; the two agree to rounding. Else vmapped and jitted (the
    unrolled factor of a small S runs slowly op by op)."""
    if y.shape[-1] <= 16 or m.shape[0] > 4:
        update = jax.vmap(
            lambda p, h, c, m_, P_, R_, y_: jfu._ut_update_xla(
                p, h, c, m_, P_, R_, y_, w, add_r),
            in_axes=(0, 0, 0, 0, 0, None, 0))
        return _jax_run(update, pts, hpts, cy, m, P, R, y)
    f64 = lambda a: jnp.asarray(a, jnp.float64)
    outs = [jfu._ut_update_xla(f64(pts[b]), f64(hpts[b]), f64(cy[b]),
                               f64(m[b]), f64(P[b]), f64(R), f64(y[b]), w,
                               add_r)
            for b in range(m.shape[0])]
    return [np.stack([np.asarray(o[k]) for o in outs])
            for k in range(len(outs[0]))]



def weights(rows):
    """(w_side, w0m, w0c) of a UT over rows/2 dimensions (α = 1, β = 2)."""
    return ut_weights(rows // 2, ParamsUKF(1.0, 2.0, 0.0))[1]


@functools.lru_cache(maxsize=None)
def update_case(B, rows, ld, dx, dy, add_r):
    """The update's inputs (pts, hpts, center_y, mu_y, m, P, R, innov) with
    μy and the innovation of the JAX twin, the weights, and the JAX
    reference (ll, mean, cov)."""
    rng = np.random.default_rng(rows + dx + dy)
    pts, hpts, cy, _, m, P, R, _ = testing.ut_update_inputs(rng, B, rows, ld,
                                                            dx, dy)
    y = rng.standard_normal((B, dy))
    w = weights(rows)
    mu_y = w[0] * hpts.sum(-2) + w[1] * cy
    args = (pts, hpts, cy, mu_y, m, P, R, y - mu_y)
    want = _jax_update_each(pts[..., :dx], hpts, cy, m, P, R, y, w, add_r)
    return args, w, want


@functools.lru_cache(maxsize=None)
def predict_case(B, rows, dx, add_q, alpha=1.0):
    """The predict's inputs (fpts, center, Q) with an asymmetric Q, the
    weights (α = 0.5 gives non-zero, negative centre weights: w0m = −3,
    w0c = −0.25), and the JAX reference (μ, Σ)."""
    rng = np.random.default_rng(rows + dx)
    fpts, center, Q = testing.ut_predict_inputs(rng, B, rows, dx)
    Q = Q + 0.1 * np.triu(rng.standard_normal((dx, dx)), 1)
    w = ut_weights(rows // 2, ParamsUKF(alpha, 2.0, 0.0))[1]
    predict = jax.vmap(lambda f, c, q: jfu._ut_predict_xla(f, c, q, w, add_q),
                       in_axes=(0, 0, None))
    return (fpts, center, Q), w, _jax_run(predict, fpts, center, Q)


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dx,dy,itemsize,optin,want", [
    (64, 32, 4, H100_OPTIN, "K8"),     # the batched Lorenz-96 UKF
    (64, 32, 8, H100_OPTIN, "K8"),
    (4, 2, 4, H100_OPTIN, "K8"),       # the UGSF/UAGSF banks
    (4, 2, 8, H100_OPTIN, "K8"),
    (188, 32, 4, H100_OPTIN, "K8"),    # 57,888 elements
    (189, 32, 4, H100_OPTIN, "K8T"),   # 58,080
    (105, 32, 8, H100_OPTIN, "K8"),    # 29,024
    (106, 32, 8, H100_OPTIN, "K8T"),   # 29,152
    (96, 128, 4, H100_OPTIN, "K8"),    # 56,800
    (97, 128, 4, H100_OPTIN, "K8T"),   # 62,080
    (512, 256, 4, H100_OPTIN, "K8T"),  # config 5
    (512, 256, 8, H100_OPTIN, "K8T"),
    (1, 256, 4, H100_OPTIN, "K8T"),    # S alone fills the block
    (64, 32, 4, 32 * 1024, "K8T"),     # a card with less shared memory
])
def test_update_variant_rule(dx, dy, itemsize, optin, want):
    assert fu.update_kernel(dx, dy, itemsize, optin) is getattr(fu, want)


@pytest.mark.parametrize("dx,itemsize,optin,want", [
    (64, 4, H100_OPTIN, "K9"),
    (64, 8, H100_OPTIN, "K9"),
    (192, 4, H100_OPTIN, "K9"),        # 49,792 elements
    (193, 4, H100_OPTIN, "K9T"),       # 58,272
    (128, 8, H100_OPTIN, "K9"),        # 25,088
    (129, 8, H100_OPTIN, "K9T"),       # 31,456
    (512, 4, H100_OPTIN, "K9T"),       # config 5
    (1024, 8, H100_OPTIN, "K9T"),      # the band's edge
    (64, 4, 16 * 1024, "K9T"),
])
def test_predict_variant_rule(dx, itemsize, optin, want):
    assert fu.predict_kernel(dx, itemsize, optin) is getattr(fu, want)


def test_the_rule_flips_once_along_each_dimension():
    """Growing any dimension moves a shape from the per-element kernel to
    the tiled one and never back."""
    for itemsize in (4, 8):
        for dy in (1, 33, 128):
            picks = [fu.update_kernel(dx, dy, itemsize, H100_OPTIN).name
                     for dx in range(1, 1025)] + [fu.K8T.name]
            flip = picks.index(fu.K8T.name)
            assert set(picks[:flip]) <= {fu.K8.name}
            assert set(picks[flip:]) == {fu.K8T.name}
        for dx in (1, 100, 512):
            picks = [fu.update_kernel(dx, dy, itemsize, H100_OPTIN).name
                     for dy in range(1, 300)]
            flip = picks.index(fu.K8T.name)
            assert set(picks[:flip]) <= {fu.K8.name}
            assert set(picks[flip:]) == {fu.K8T.name}
        picks = [fu.predict_kernel(dx, itemsize, H100_OPTIN).name
                 for dx in range(1, 1025)]
        flip = picks.index(fu.K9T.name)
        assert set(picks[:flip]) == {fu.K9.name}
        assert set(picks[flip:]) == {fu.K9T.name}


# ---------------------------------------------------------------------------
# K8t's and K9t's schedules
# ---------------------------------------------------------------------------

def tiled_ut_update(pts, hpts, center_y, mu_y, m, P, R, innov, w, add_r):
    """One element of K8t, launch by launch, on its scratch
    (``testing.k8t_layout``) seeded with NaN, in the inputs' dtype."""
    w_side, _, w0c = w
    dt = m.dtype
    rows, dx, dy = hpts.shape[0], m.shape[-1], hpts.shape[-1]
    wd = dy + dx
    lay = testing.k8t_layout(rows, dx, dy)
    ws = np.full(lay["total"], np.nan, dt)
    Mat = testing.Mat
    # 1. centre: V = [Yc | Xc], [d0; 0]
    ws[lay["v"]:lay["d0"]] = np.concatenate(
        [hpts - mu_y, pts[:, :dx] - m], axis=1).ravel()
    ws[lay["d0"]:lay["total"]] = np.concatenate([center_y - mu_y,
                                                 np.zeros(dx, dt)])
    # 2. [G; Cᵀ] = lower(w_side·Vᵀ Yc + w0c·[d0; 0] d0ᵀ) into W's rows
    testing.run_gemms([testing.Gemm(
        wd, dy, 1, (rows, 1),
        (Mat(ws, lay["v"], wd, 0, True), Mat(ws, lay["d0"], 1, 0)),
        (Mat(ws, lay["v"], wd, 0), Mat(ws, lay["d0"], wd, 0)),
        (w_side, w0c), ws, lay["w"], dy, 0, tri=testing.LOWER)])
    # 3. the factor of W = [S; Cᵀ; innovᵀ] (S = G + sym(R) + floor and Cᵀ
    #    read at the first touch), ll and μ = m + Zᵀ z
    W = ws[lay["w"]:lay["w"] + wd * dy].reshape(wd, dy)
    f = testing.augmented_factor(W[None, :dy], W[None, dy:], innov[None],
                                 R if add_r else None, identity=False)
    ll, mean = f.gain(dx, m[None])
    ws[lay["l"]:lay["l"] + (wd + 1) * dy] = f.L[0].ravel()
    # 4. Σ = sym(P) − lower(Zᵀ Z), mirrored; Zᵀ is L's rows dy … dy + dx
    cov = np.full(dx * dx, np.nan, dt)
    zt = lay["l"] + dy * dy
    testing.run_gemms([testing.Gemm(
        dx, dx, 1, (dy, 0), (Mat(ws, zt, dy, 0), None),
        (Mat(ws, zt, dy, 0, True), None), (-1.0, 0.0), cov, 0, dx, 0,
        Cin=Mat(np.ascontiguousarray(P).ravel(), 0, dx, 0), beta=1.0,
        sym_cin=True, tri=testing.LOWER_MIRROR)])
    return ll[0], mean[0], cov.reshape(dx, dx)


def _update_batch(args, w, add_r):
    pts, hpts, cy, mu_y, m, P, R, innov = args
    outs = [tiled_ut_update(pts[b], hpts[b], cy[b], mu_y[b], m[b], P[b], R,
                            innov[b], w, add_r)
            for b in range(m.shape[0])]
    return [np.stack(x) for x in zip(*outs)]


def _predict_batch(args, w, add_q):
    """K9t over the batch, launch by launch (``testing.tiled_ut_predict``:
    the mean-and-centre pass, then the product, split along the rows at
    config 5): (μ, Σ)."""
    return testing.tiled_ut_predict(*args, w, add_q)[:2]


# (B, rows, ld, dx, dy, add_r): one panel of 1 row and of 33 (a panel and
# one more), 100 columns (no tile's multiple), points wider than the state
UPDATE_SHAPES = [(3, 18, 9, 9, 1, True), (2, 130, 100, 100, 33, True),
                 (1, 90, 45, 40, 33, False), (2, 130, 120, 100, 33, False)]


@pytest.mark.parametrize("B,rows,ld,dx,dy,add_r", UPDATE_SHAPES)
def test_tiled_ut_update_schedule_matches_the_reference(B, rows, ld, dx, dy,
                                                        add_r):
    args, w, want = update_case(B, rows, ld, dx, dy, add_r)
    for g, wt in zip(_update_batch(args, w, add_r), want):
        assert_close(g, wt, "float64")


@pytest.mark.parametrize("B,rows,ld,dx,dy,add_r",
                         [(1, 40, 20, 20, 97, True), (2, 64, 40, 7, 64, False)])
def test_tiled_ut_update_schedule_over_more_panels_matches_the_plain_version(
        B, rows, ld, dx, dy, add_r):
    """Four and two panels (the port's plain version is held to JAX above
    and in tests/test_torch_ukf.py; JAX's unrolled factorisation compiles
    slowly at these widths)."""
    rng = np.random.default_rng(dy)
    args = testing.ut_update_inputs(rng, B, rows, ld, dx, dy)
    w = weights(rows)
    want = fu._ut_update_plain(*(torch.as_tensor(a) for a in args), w[0],
                               w[2], add_r)
    for g, wt in zip(_update_batch(args, w, add_r), want):
        assert_close(g, wt, "float64")


@pytest.mark.parametrize("fail_at", [0, 40, 69])
def test_tiled_ut_update_schedule_gives_nan_on_a_non_pd_s(fail_at):
    """A negative pivot in the first panel, the middle one or only in the
    last (ragged) one: every output is NaN, as in the plain version."""
    args = list(testing.ut_update_inputs(np.random.default_rng(3), 2, 24, 12,
                                         12, 70))
    args[6] = args[6].copy()
    args[6][fail_at, fail_at] = -1e3
    w = weights(24)
    got = _update_batch(args, w, True)
    want = fu._ut_update_plain(*(torch.as_tensor(a) for a in args), w[0],
                               w[2], True)
    for g, wt in zip(got, want):
        assert np.isnan(g).all() and torch.isnan(wt).all()


def test_tiled_ut_update_schedule_at_config_5_costs_no_float32_accuracy():
    """Config 5's update (1,024 points, dx = 512, dy = 256, R added) in
    float32: each output of the schedule (sym(P) − ZᵀZ) is as close to the
    float64 JAX twin as the port's float32 plain version (the grouped
    Joseph form P − KC − (KC)ᵀ + (KL)(KL)ᵀ), within a factor 1.25."""
    args, w, want = update_case(1, 1024, 512, 512, 256, True)
    f32 = [np.asarray(a, np.float32) for a in args]
    got = _update_batch(f32, w, True)
    plain = fu._ut_update_plain(*(torch.as_tensor(a) for a in f32), w[0],
                                w[2], True)
    for g, pl, wt in zip(got, plain, want):
        err = np.abs(np.asarray(g, np.float64) - wt).max()
        err_plain = np.abs(pl.double().numpy() - wt).max()
        assert np.isfinite(g).all() and err <= 1.25 * err_plain, (
            err, err_plain)


PREDICT_SHAPES = [(3, 18, 9, True), (2, 130, 100, True), (1, 70, 33, False)]


@pytest.mark.parametrize("B,rows,dx,add_q", PREDICT_SHAPES)
def test_tiled_ut_predict_schedule_matches_the_reference(B, rows, dx, add_q):
    args, w, want = predict_case(B, rows, dx, add_q)
    for g, wt in zip(_predict_batch(args, w, add_q), want):
        assert_close(g, wt, "float64")


@pytest.mark.parametrize("B,rows,dx,add_q", PREDICT_SHAPES)
def test_tiled_ut_predict_schedule_at_negative_centre_weights(B, rows, dx,
                                                             add_q):
    """``ParamsUKF(0.5, 2, 0)``'s weights: w0m = −3 and w0c = −0.25 (at
    any n), so the centre point's terms subtract."""
    args, w, want = predict_case(B, rows, dx, add_q, 0.5)
    assert w[1] == -3.0 and w[2] == -0.25
    for g, wt in zip(_predict_batch(args, w, add_q), want):
        assert_close(g, wt, "float64")


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_tiled_ut_predict_schedule_at_config_5_costs_no_float32_accuracy(
        alpha):
    """Config 5's predict (1,024 points, dx = 512, Q added) in float32, at
    the UKF's weights (w0m = 0, w0c = 2) and at negative centre weights:
    the schedule's row split is a cluster of 2 on 64 × 32 lower tiles, and
    each output is as close to the float64 JAX twin as the port's float32
    plain version, within a factor 1.25."""
    args, w, want = predict_case(1, 1024, 512, True, alpha)
    f32 = [np.asarray(a, np.float32) for a in args]
    mu, cov, plan = testing.tiled_ut_predict(*f32, w, True)
    assert plan["tile"] == (64, 32) and plan["split"] == 2
    plain = fu._ut_predict_plain(*(torch.as_tensor(a) for a in f32), *w,
                                 True)
    for g, pl, wt in zip((mu, cov), plain, want):
        err = np.abs(np.asarray(g, np.float64) - wt).max()
        err_plain = np.abs(pl.double().numpy() - wt).max()
        assert np.isfinite(g).all() and err <= 1.25 * err_plain, (
            err, err_plain)


def test_the_mean_pass_sums_in_a_fixed_order():
    """K9t's first pass: the row groups (32 in float32, a strip of 8
    columns; 64 in float64, 4 columns) each sum their rows in order and the
    tree adds the groups, so that a float32 run is bit for bit the same
    whatever the column; Xc and d0 come from the same μ."""
    rng = np.random.default_rng(11)
    fpts = rng.standard_normal((2, 100, 9)).astype(np.float32)
    center = rng.standard_normal((2, 9)).astype(np.float32)
    mu, xc, d0 = testing.k9t_mean_centre(fpts, center, 0.01, -0.5)
    groups = np.zeros((2, 32, 9), np.float32)
    for r in range(100):
        groups[:, r % 32] += fpts[:, r]
    h = 16
    while h:
        groups[:, :h] = groups[:, :h] + groups[:, h:2 * h]
        h //= 2
    want = np.float32(0.01) * groups[:, 0] + np.float32(-0.5) * center
    np.testing.assert_array_equal(mu, want)
    np.testing.assert_array_equal(xc, fpts - mu[:, None])
    np.testing.assert_array_equal(d0, center - mu)
    f64 = testing.k9t_mean_centre(fpts.astype(np.float64),
                                  center.astype(np.float64), 0.01, -0.5)[0]
    np.testing.assert_allclose(f64, 0.01 * fpts.astype(np.float64).sum(1)
                               - 0.5 * center, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# The wrappers at K8t's and K9t's shapes (the plain versions on CPU tensors)
# ---------------------------------------------------------------------------

# tiled on an H100: the update at dx = 200 in both dtypes and at dy = 128
# in float64 only; the predict at dx = 162 in float64 only, at 233 in both
WRAPPER_UPDATE_SHAPES = [(1, 400, 240, 200, 40, False),
                         (2, 300, 150, 57, 128, True)]
WRAPPER_PREDICT_SHAPES = [(2, 324, 162, True), (1, 466, 233, False)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,rows,ld,dx,dy,add_r", WRAPPER_UPDATE_SHAPES)
def test_update_wrapper_at_tiled_shapes_matches_jax(dtype, B, rows, ld, dx,
                                                    dy, add_r):
    assert fu.update_kernel(dx, dy, 8, H100_OPTIN) is fu.K8T
    args, w, want = update_case(B, rows, ld, dx, dy, add_r)
    got = fu.fused_ut_update(*(torch.as_tensor(np.asarray(a, dtype))
                               for a in args), w[0], w[2], add_r)
    for g, wt in zip(got, want):
        assert_close(g, wt, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,rows,dx,add_q", WRAPPER_PREDICT_SHAPES)
def test_predict_wrapper_at_tiled_shapes_matches_jax(dtype, B, rows, dx,
                                                     add_q):
    assert fu.predict_kernel(dx, 8, H100_OPTIN) is fu.K9T
    args, w, want = predict_case(B, rows, dx, add_q)
    got = fu.fused_ut_predict(*(torch.as_tensor(np.asarray(a, dtype))
                                for a in args), *w, add_q)
    for g, wt in zip(got, want):
        assert_close(g, wt, dtype)
