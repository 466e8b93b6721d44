"""The port's CUDA kernels on the card: each kernel against its plain
twin, and the filters' kernel path against their plain path on the CPU.

Needs a CUDA device; every test skips without one. Covers K1–K12, with
the tiled variants K1t/K2t and K6t–K9t (and the one-launch blocked factor
under K6t, K7t, K1t and K8t at config 5, the bands' edges and a failing
pivot in the first, a middle or the last panel; K7t's P and C side by
side at dx ≠ dn; K9t at negative centre weights), the block variants of
K10–K12 and the wide bands of K1 and K6–K9, and the smoothing side and
the AGSF's options against the CPU in float64. This file imports no
JAX, so it also runs where JAX is not installed (the repository's
conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Tolerances (relative to max(1, max|twin|)): float64 1e-10 — the kernel and
its twin differ only in summation order; float32 1e-4 at these small,
well-conditioned shapes.
"""
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu_torch import _build, inference, testing
from bayesianfiltering_tpu_torch.models import zoo
from bayesianfiltering_tpu_torch.ops import associative as tas
from bayesianfiltering_tpu_torch.ops import bank_combine as bc
from bayesianfiltering_tpu_torch.ops import bank_smoother as bs
from bayesianfiltering_tpu_torch.ops import bank_update as bu
from bayesianfiltering_tpu_torch.ops import fused_ekf as fe
from bayesianfiltering_tpu_torch.ops import fused_ut as fu
from bayesianfiltering_tpu_torch.ops import linear
from bayesianfiltering_tpu_torch.ops import resample_gather as rg
from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF, ut_weights

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def assert_close(got, want, tol):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol * scale


# K3 and K4 also at the mixture paths' banks (M = 1, 17, 50, 200 at the
# bearings-only widths), and at dx = 5 beside 7 and dx = 8 beside 8 (groups
# of 8 threads)
BANK_SHAPES = [(1, 4), (17, 4), (50, 4), (200, 4), (50, 5), (50, 8)]
UPDATE_CASES = [(fe.K1, fe.fused_update, 5, 16, 8), (fe.K1T, fe.fused_update, 2, 130, 70),
                (bu.K3, bu.bank_chol_update, 300, 4, 1),
                (bu.K3, bu.bank_chol_update, 129, 8, 7)] + [
    (bu.K3, bu.bank_chol_update, M, dx, {4: 1, 5: 7, 8: 8}[dx])
    for M, dx in BANK_SHAPES]
PREDICT_CASES = [(fe.K2, fe.fused_predict_cov, 5, 16, 9),
                 (bu.K4, bu.bank_predict_cov, 300, 4, 2),
                 (bu.K4, bu.bank_predict_cov, 129, 7, 8)] + [
    (bu.K4, bu.bank_predict_cov, M, dx, {4: 2, 5: 7, 8: 8}[dx])
    for M, dx in BANK_SHAPES]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel,wrapper,B,dx,dy", UPDATE_CASES)
def test_update_kernel_matches_twin(dev, dtype, kernel, wrapper, B, dx, dy):
    raw = testing.update_inputs(np.random.default_rng(B + dx), B, dx, dy)
    args = [testing.to_torch(a, dtype, dev) for a in raw]
    before = kernel.launches
    got = wrapper(*args, 1e-4)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for g, w in zip(got, fe._update_plain(*args, 1e-4)):
        assert torch.isfinite(g).all()
        assert_close(g, w, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel,wrapper,B,dx,dq", PREDICT_CASES)
def test_predict_kernel_matches_twin(dev, dtype, kernel, wrapper, B, dx, dq):
    raw = testing.predict_inputs(np.random.default_rng(B + dx), B, dx, dq)
    args = [testing.to_torch(a, dtype, dev) for a in raw]
    before = kernel.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert_close(got, fe._predict_plain(*args), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx,dy,fail_at", [(4, 1, 0), (4, 2, 1), (5, 7, 6),
                                           (8, 8, 0)])
def test_bank_update_non_pd_lane_is_nan(dev, dtype, dx, dy, fail_at):
    """S failing at pivot ``fail_at`` of lane 2 (its last real pivot where
    fail_at = dy − 1): every output of that lane is NaN, the other lanes
    match the plain version."""
    m, P, Hx, Rt, innov = testing.update_inputs(np.random.default_rng(dy),
                                                 6, dx, dy)
    Rt[2, fail_at, fail_at] = -1e3
    args = [testing.to_torch(a, dtype, dev) for a in (m, P, Hx, Rt, innov)]
    before = bu.K3.launches
    got = bu.bank_chol_update(*args, 1e-4)
    torch.cuda.synchronize()
    assert bu.K3.launches == before + 1
    keep = torch.arange(6, device=dev) != 2
    for g, w in zip(got, fe._update_plain(*args, 1e-4)):
        assert torch.isnan(g[2]).all()
        assert torch.isfinite(g[keep]).all()
        assert_close(g[keep], w[keep], TOL[dtype])


def test_backward_through_a_kernel_matches_cpu(dev):
    raw = testing.update_inputs(np.random.default_rng(0), 3, 5, 2)
    grads = []
    for device in (dev, "cpu"):
        args = [testing.to_torch(a, torch.float64, device).requires_grad_()
                for a in raw]
        ll, mean, cov, gain = fe.fused_update(*args)
        (ll.sum() + mean.sum() + cov.sum() + gain.sum()).backward()
        grads.append([a.grad for a in args])
    for g, w in zip(*grads):
        assert_close(g, w, 1e-10)


def test_ekf_kernel_path_matches_plain_path(dev):
    _, params, _ = zoo.lorenz96(16, 8, dtype=torch.float64, device=dev)
    model, data_params, _ = zoo.lorenz96(16, 8, integrator="rk4",
                                         dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    _, emissions = model.sample(data_params, 25, generator=gen,
                                batch_shape=(4,))
    _build.reset_launch_counts()
    got = inference.extended_kalman_filter(params, emissions, num_iter=2)
    torch.cuda.synchronize()
    assert fe.K1.launches == 25 * 2 and fe.K2.launches == 25
    _, cpu_params, _ = zoo.lorenz96(16, 8, dtype=torch.float64,
                                    device="cpu")
    want = inference.extended_kalman_filter(cpu_params, emissions.cpu(),
                                            num_iter=2)
    assert_close(got.filtered_means, want.filtered_means, 1e-9)
    assert_close(got.marginal_loglik, want.marginal_loglik, 1e-9)


def test_agsf_kernel_path_matches_plain_path(dev):
    T = 10
    model, params, _ = zoo.bearings_only_tracking(dtype=torch.float64,
                                                  device="cpu")
    inputs = zoo.bot_maneuver_inputs(T, device="cpu")
    gen = torch.Generator().manual_seed(1)
    _, emissions = model.sample(params, T, inputs=inputs, generator=gen)
    draws = inference.agsf_draws(gen, T, [6, 2, 2], 4, "systematic",
                                 emissions)
    _, gpu_params, _ = zoo.bearings_only_tracking(dtype=torch.float64,
                                                  device=dev)
    _build.reset_launch_counts()
    got, _ = inference.augmented_gaussian_sum_filter(
        gpu_params, emissions.to(dev), [6, 2, 2], inputs=inputs.to(dev),
        reduction="systematic",
        draws=inference.AGSFDraws(*(d.to(dev) for d in draws)))
    torch.cuda.synchronize()
    assert (bu.K3.launches, bu.K4.launches, rg.K5.launches) == (T, T, T)
    want, _ = inference.augmented_gaussian_sum_filter(
        params, emissions, [6, 2, 2], inputs=inputs, reduction="systematic",
        draws=draws)
    for name in ("means", "weights", "marginal_loglik"):
        assert_close(getattr(got, name), getattr(want, name), 1e-8)


def test_outside_the_kernel_band_raises(dev):
    """The band is dx ≤ 512, dy ≤ 512: a CUDA input outside it raises
    instead of falling back to the plain twin."""
    raw = testing.update_inputs(np.random.default_rng(1), 1, 4, 513)
    args = [testing.to_torch(a, torch.float32, dev) for a in raw]
    before = fe.K1.launches, fe.K1T.launches
    with pytest.raises(NotImplementedError):
        fe.fused_update(*args)
    assert (fe.K1.launches, fe.K1T.launches) == before


UT_CASES = [
    (fu.K6, lambda r: testing.sigma_inputs(r, 5, 16),
     lambda *a: fu.fused_sigma(*a, 2.0, "cholesky"),
     lambda *a: fu._sigma_plain(*a, 2.0, "cholesky")),
    # Newton–Schulz at n = 128 does not fit K6's workspace: K6t
    (fu.K6T, lambda r: testing.sigma_inputs(r, 3, 128),
     lambda *a: fu.fused_sigma(*a, 2.0, "sqrtm"),
     lambda *a: fu._sigma_plain(*a, 2.0, "sqrtm")),
    (fu.K7, lambda r: testing.sigma_aug_inputs(r, 7, 12, 5),
     lambda *a: fu.fused_sigma_aug(*a, 1.5, "sqrtm"),
     lambda *a: fu._sigma_aug_plain(*a, 1.5, "sqrtm")),
    (fu.K7, lambda r: testing.sigma_aug_inputs(r, 33, 4, 2),
     lambda *a: fu.fused_sigma_aug(*a, 1.5, "cholesky"),
     lambda *a: fu._sigma_aug_plain(*a, 1.5, "cholesky")),
    (fu.K8, lambda r: testing.ut_update_inputs(r, 5, 40, 20, 20, 6),
     lambda *a: fu.fused_ut_update(*a, 1 / 40, 0.3, True),
     lambda *a: fu._ut_update_plain(*a, 1 / 40, 0.3, True)),
    (fu.K8, lambda r: testing.ut_update_inputs(r, 33, 12, 6, 4, 2),
     lambda *a: fu.fused_ut_update(*a, 1 / 12, 0.0, False),
     lambda *a: fu._ut_update_plain(*a, 1 / 12, 0.0, False)),
    (fu.K9, lambda r: testing.ut_predict_inputs(r, 5, 36, 18),
     lambda *a: fu.fused_ut_predict(*a, 1 / 36, 0.1, 0.4, True),
     lambda *a: fu._ut_predict_plain(*a, 1 / 36, 0.1, 0.4, True)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", range(len(UT_CASES)))
def test_ut_kernel_matches_plain(dev, dtype, case):
    kernel, make, wrapper, plain = UT_CASES[case]
    args = [testing.to_torch(a, dtype, dev)
            for a in make(np.random.default_rng(case))]
    before = kernel.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert_close(g, w, TOL[dtype])


@pytest.mark.parametrize("additive", [True, False])
def test_ukf_kernel_path_matches_plain_path(dev, additive):
    _, params, _ = zoo.lorenz96(16, 8, dtype=torch.float64, device=dev)
    model, data_params, _ = zoo.lorenz96(16, 8, integrator="rk4",
                                         dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    _, emissions = model.sample(data_params, 20, generator=gen,
                                batch_shape=(4,))
    up = ParamsUKF(1.0, 0.0, 0.0, "cholesky")
    _build.reset_launch_counts()
    got = inference.unscented_kalman_filter(params, up, emissions,
                                            additive=additive)
    torch.cuda.synchronize()
    sigma = fu.K6 if additive else fu.K7
    assert (sigma.launches, fu.K8.launches, fu.K9.launches) == (40, 20, 20)
    _, cpu_params, _ = zoo.lorenz96(16, 8, dtype=torch.float64,
                                    device="cpu")
    want = inference.unscented_kalman_filter(cpu_params, up, emissions.cpu(),
                                             additive=additive)
    assert_close(got.filtered_means, want.filtered_means, 1e-9)
    assert_close(got.marginal_loglik, want.marginal_loglik, 1e-9)


def test_uagsf_kernel_path_matches_plain_path(dev):
    T = 10
    model, params, _ = zoo.range_bearing_tracking(dtype=torch.float64,
                                                  device="cpu")
    inputs = zoo.bot_experiment_inputs(T, device="cpu")
    gen = torch.Generator().manual_seed(1)
    _, emissions = model.sample(params, T, inputs=inputs, generator=gen)
    draws = inference.agsf_draws(gen, T, [6, 2, 2], 4, "systematic",
                                 emissions)
    _, gpu_params, _ = zoo.range_bearing_tracking(dtype=torch.float64,
                                                  device=dev)
    up = ParamsUKF(1.0, 0.0, 0.0)
    _build.reset_launch_counts()
    got, _ = inference.unscented_agsf(
        gpu_params, up, emissions.to(dev), [6, 2, 2], inputs=inputs.to(dev),
        opt_args=(0.9, 0.9), reduction="systematic",
        draws=inference.AGSFDraws(*(d.to(dev) for d in draws)))
    torch.cuda.synchronize()
    assert (fu.K7.launches, fu.K8.launches, fu.K9.launches,
            rg.K5.launches) == (2 * T, T, T, T)
    want, _ = inference.unscented_agsf(
        params, up, emissions, [6, 2, 2], inputs=inputs, opt_args=(0.9, 0.9),
        reduction="systematic", draws=draws)
    for name in ("means", "weights", "marginal_loglik"):
        assert_close(getattr(got, name), getattr(want, name), 1e-8)


def test_ut_outside_the_band_raises(dev):
    m, P = testing.sigma_inputs(np.random.default_rng(3), 1, 1025)
    args = [testing.to_torch(a, torch.float32, dev) for a in (m, P)]
    before = fu.K6.launches, fu.K6T.launches
    with pytest.raises(NotImplementedError):
        fu.fused_sigma(*args, 1.0, "cholesky")
    assert (fu.K6.launches, fu.K6T.launches) == before


# ---------------------------------------------------------------------------
# K5: parents from cumulative counts
# ---------------------------------------------------------------------------


# K5's merge path: m + n at and off a multiple of its stretch (rg.STRETCH
# merged positions a block: 2 · 1,408 = one stretch exactly)
@pytest.mark.parametrize("n", [1408, 4097, 65536, 70001])
@pytest.mark.parametrize("profile", testing.PARENT_PROFILES)
def test_parents_kernel_equals_plain(dev, n, profile):
    counts = testing.to_torch(
        testing.resampling_counts(profile, n, np.random.default_rng(n)),
        device=dev)
    before = rg.K5.launches
    got = rg.windowed_parents(counts, n)
    torch.cuda.synchronize()
    assert rg.K5.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), rg.windowed_parents(counts.cpu(), n))


@pytest.mark.parametrize("m,n", [(200, 200), (200, 50), (24, 6), (32, 8),
                                 (64, 16), (1, 1), (1, 5), (9000, 1000)])
def test_small_resampling_runs_the_kernel(dev, m, n):
    """The Gaussian-sum reductions keep n of m components: K5 runs there
    too (it has no size gate), with the CPU's int64 indices."""
    w = torch.rand(m, device=dev, dtype=torch.float64)
    before = rg.K5.launches
    idx = inference._rs.systematic_resample(w / w.sum(), n,
                                            u=torch.tensor(0.3))
    torch.cuda.synchronize()
    assert rg.K5.launches == before + 1 and idx.dtype == torch.int64
    want = inference._rs.systematic_resample((w / w.sum()).cpu(), n,
                                             u=torch.tensor(0.3))
    assert torch.equal(idx.cpu(), want)


def test_bpf_kernel_path_matches_plain_path(dev):
    P, T = 65536, 8
    _, _, bpf = zoo.lorenz96(4, 2, dtype=torch.float64, device=dev)
    model, data_params, _ = zoo.lorenz96(4, 2, integrator="rk4",
                                         dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    _, emissions = model.sample(data_params, T, generator=gen)
    draws = inference.bpf_draws(gen, T, P, 4, 4, "systematic", emissions)
    _build.reset_launch_counts()
    got = inference.bootstrap_particle_filter(
        bpf, emissions, P, store="summary", ess_threshold=2.0, draws=draws)
    torch.cuda.synchronize()
    assert rg.K5.launches == T
    cpu_bpf = zoo.lorenz96(4, 2, dtype=torch.float64, device="cpu")[2]
    want = inference.bootstrap_particle_filter(
        cpu_bpf, emissions.cpu(), P, store="summary", ess_threshold=2.0,
        draws=inference.BPFDraws(*(d.cpu() for d in draws)))
    for name in ("means", "ess"):
        assert_close(got[name], want[name], 1e-9)


# ---------------------------------------------------------------------------
# K10–K12: the parallel Kalman smoother's combines and elements
# ---------------------------------------------------------------------------


def _dev(arrays, dtype, dev):
    return [testing.to_torch(a, dtype, dev) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx,M", [(4, 130), (8, 129), (1, 5), (3, 1)])
def test_filter_combine_kernel_matches_plain(dev, dtype, dx, M):
    rng = np.random.default_rng(dx * M)
    left = _dev(testing.filter_elements(rng, M, dx, singular_head=M // 4),
                dtype, dev)
    right = _dev(testing.filter_elements(rng, M, dx), dtype, dev)
    before = bc.K10.launches
    got = bc.bank_filter_combine(left, right)
    torch.cuda.synchronize()
    assert bc.K10.launches == before + 1
    for g, w in zip(got, tas._combine(left, right)):
        assert torch.isfinite(g).all()
        assert_close(g, w, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_combine_kernels_broadcast_the_left_operand(dev, dtype):
    """The chunked scan's step 4: (1, G) against (chunk, G), read in place
    (lane m mod G), not materialised."""
    rng = np.random.default_rng(1)
    G, C = 7, 5
    for make, wrap, plain, n in (
            (testing.filter_elements, bc.bank_filter_combine, tas._combine,
             5),
            (testing.smoother_elements, bs.bank_smoother_combine,
             tas._smoother_combine, 3)):
        left = [x[None] for x in _dev(make(rng, G, 4), dtype, dev)]
        right = [x.reshape((C, G) + x.shape[1:])
                 for x in _dev(make(rng, C * G, 4), dtype, dev)]
        got = wrap(left, right)
        torch.cuda.synchronize()
        for g, w in zip(got, plain(left, right)):
            assert g.shape[:2] == (C, G)
            assert_close(g, w, TOL[dtype])
        assert len(got) == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_filter_combine_guard_lanes(dev, dtype):
    """A C1 with a −1e-8 eigenvalue and one with an infinite entry: both
    factors are zeroed on both sides, and the outputs are non-finite in the
    same places."""
    rng = np.random.default_rng(2)
    left = _dev(testing.guard_lanes(rng, testing.filter_elements(rng, 64, 4)),
                dtype, dev)
    right = _dev(testing.filter_elements(rng, 64, 4), dtype, dev)
    got = bc.bank_filter_combine(left, right)
    want = tas._combine(left, right)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        bad = ~torch.isfinite(w)
        assert torch.equal(bad, ~torch.isfinite(g))
        assert torch.isfinite(g[0]).all()
        assert_close(torch.where(bad, 0, g), torch.where(bad, 0, w),
                     TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx,M,shared", [(4, 1000, True), (8, 129, False),
                                         (2, 7, True)])
def test_elements_kernel_matches_plain(dev, dtype, dx, M, shared):
    fm, fP, pm, pP, F = _dev(
        testing.smoother_element_inputs(np.random.default_rng(dx), M, dx),
        dtype, dev)
    if shared:
        F = F[0].expand(M, dx, dx)
    before = bs.K11.launches
    got = bs.bank_smoother_elements(fm, fP, pm, pP, F)
    torch.cuda.synchronize()
    assert bs.K11.launches == before + 1
    for g, w in zip(got, bs._elements_plain(fm, fP, pm, pP, F)):
        assert_close(g, w, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx", range(1, 9))
def test_elements_kernel_every_width_with_f_banked(dev, dtype, dx):
    """K11's groups of 4 (dx ≤ 4) and 8 threads, the padded and the full
    widths, F per lane; one launch a call."""
    M = 257
    fm, fP, pm, pP, F = _dev(
        testing.smoother_element_inputs(np.random.default_rng(40 + dx), M,
                                        dx), dtype, dev)
    before = bs.K11.launches
    got = bs.bank_smoother_elements(fm, fP, pm, pP, F)
    torch.cuda.synchronize()
    assert bs.K11.launches == before + 1
    for g, w in zip(got, bs._elements_plain(fm, fP, pm, pP, F)):
        assert torch.isfinite(g).all()
        assert_close(g, w, TOL[dtype])
    assert torch.equal(got[2], got[2].mT)  # L exactly symmetric


@pytest.mark.parametrize("dx", [1, 3, 4, 5, 8])
def test_elements_kernel_nan_on_one_non_pd_lane(dev, dx):
    """A Pp failing at its last pivot NaNs its own lane only."""
    fm, fP, pm, pP, F = _dev(
        testing.smoother_element_inputs(np.random.default_rng(dx), 70, dx),
        torch.float64, dev)
    pP[33, dx - 1, dx - 1] = -1e3
    keep = torch.arange(70, device=dev) != 33
    for g, w in zip(bs.bank_smoother_elements(fm, fP, pm, pP, F),
                    bs._elements_plain(fm, fP, pm, pP, F)):
        assert torch.isnan(g[33]).all() and torch.isnan(w[33]).all()
        assert torch.isfinite(g[keep]).all()
        assert_close(g[keep], w[keep], TOL[torch.float64])


def test_elements_kernel_nan_on_non_pd(dev):
    fm, fP, pm, pP, F = _dev(
        testing.smoother_element_inputs(np.random.default_rng(3), 9, 4),
        torch.float64, dev)
    pP = -pP
    for g, w in zip(bs.bank_smoother_elements(fm, fP, pm, pP, F),
                    bs._elements_plain(fm, fP, pm, pP, F)):
        assert torch.isnan(g).all() and torch.isnan(w).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx,M", [(4, 300), (8, 129)])
def test_smoother_combine_kernel_matches_plain(dev, dtype, dx, M):
    rng = np.random.default_rng(dx + M)
    e1 = _dev(testing.smoother_elements(rng, M, dx), dtype, dev)
    e2 = _dev(testing.smoother_elements(rng, M, dx), dtype, dev)
    before = bs.K12.launches
    got = bs.bank_smoother_combine(e1, e2)
    torch.cuda.synchronize()
    assert bs.K12.launches == before + 1
    for g, w in zip(got, tas._smoother_combine(e1, e2)):
        assert_close(g, w, TOL[dtype])


# K10 and K12 run a lane over a group of 4 (dx ≤ 4) or 8 threads: every
# width of the band, at one lane, path B's 62 and 7,813, and with each side
# broadcast ((1, 62) against (3, 62), read in place at lane m mod 62)
LANE_SHAPES = [(1, None), (62, None), (7_813, None), (62, "left"),
               (62, "right")]


def _lane_operands(make, rng, G, dx, side, dtype, dev):
    """(left, right) over G lanes, or (1, G) against (3, G) with ``side``
    the one of a single row."""
    if side is None:
        return (_dev(make(rng, G, dx), dtype, dev),
                _dev(make(rng, G, dx), dtype, dev))
    one = [x[None] for x in _dev(make(rng, G, dx), dtype, dev)]
    many = [x.reshape((3, G) + x.shape[1:])
            for x in _dev(make(rng, 3 * G, dx), dtype, dev)]
    return (one, many) if side == "left" else (many, one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx", range(1, 9))
@pytest.mark.parametrize("G,side", LANE_SHAPES)
@pytest.mark.parametrize("kind", ["combine", "smoother"])
def test_lane_combines_match_plain(dev, kind, G, side, dx, dtype):
    make, wrap, plain, kernel = (
        (testing.filter_elements, bc.bank_filter_combine, tas._combine,
         bc.K10) if kind == "combine" else
        (testing.smoother_elements, bs.bank_smoother_combine,
         tas._smoother_combine, bs.K12))
    rng = np.random.default_rng(G * 10 + dx)
    left, right = _lane_operands(make, rng, G, dx, side, dtype, dev)
    _build.reset_launch_counts()
    got = wrap(left, right)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    assert all(k.launches == 0 for k in COMBINE_KERNELS if k is not kernel)
    for g, w in zip(got, plain(left, right)):
        assert g.shape == w.shape
        assert torch.isfinite(g).all()
        assert_close(g, w, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx", range(1, 9))
def test_lane_combine_guard_lanes_at_every_width(dev, dtype, dx):
    """K10's guard on the groups: lane 0's C1 with a −1e-8 eigenvalue and
    lane 1's with an infinite entry fail their factor on both sides (U
    zeroed), a NaN in b1 of lane 2 and in J2 of lane 3 reach the same
    entries; the rest agree."""
    rng = np.random.default_rng(20 + dx)
    left = testing.guard_lanes(rng, testing.filter_elements(rng, 62, dx))
    right = [np.array(x, copy=True)
             for x in testing.filter_elements(rng, 62, dx)]
    left[1][2, 0] = np.nan
    right[3][3, 0, 0] = np.nan
    left, right = _dev(left, dtype, dev), _dev(right, dtype, dev)
    got = bc.bank_filter_combine(left, right)
    want = tas._combine(left, right)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        bad = ~torch.isfinite(w)
        assert torch.equal(bad, ~torch.isfinite(g))
        assert torch.isfinite(g[0]).all() and torch.isnan(g[3]).all()
        assert_close(torch.where(bad, 0, g), torch.where(bad, 0, w),
                     TOL[dtype])


def test_parallel_smoother_kernel_path_matches_plain_path(dev):
    """T=1000, chunk 16: 16 + 16 + 4 + 1 + 1 = 38 combines of each kind."""
    rng = np.random.default_rng(4)
    dx, dy, T = 4, 2, 1000
    fields = (np.zeros(dx), np.eye(dx),
              0.99 * np.eye(dx) + 0.01 * rng.standard_normal((dx, dx)) / dx,
              0.1 * np.eye(dx), rng.standard_normal((dy, dx)) / dx,
              0.1 * np.eye(dy))
    ys = rng.standard_normal((T, dy))
    runs = []
    for device in (dev, "cpu"):
        params = linear.ParamsLGSSM(*_dev(fields, torch.float64, device))
        _build.reset_launch_counts()
        runs.append(tas.parallel_kalman_smoother(
            params, testing.to_torch(ys, torch.float64, device), chunk=16))
        torch.cuda.synchronize()
        if device == dev:
            assert (bc.K10.launches, bs.K11.launches,
                    bs.K12.launches) == (38, 1, 38)
    got, want = runs
    for name in ("filtered_means", "filtered_covariances", "smoothed_means",
                 "smoothed_covariances", "marginal_loglik"):
        assert_close(getattr(got, name), getattr(want, name), 1e-9)


@pytest.mark.parametrize("dx,dtype", [(513, torch.float64),
                                      (4, torch.float16)])
def test_outside_the_combine_band_raises(dev, dx, dtype):
    """dx = 513, or a half-precision operand, is outside K10–K12's band
    (lane kernels to dx = 8, block kernels to 512): a CUDA input raises
    instead of running the plain version."""
    rng = np.random.default_rng(5)
    fl = lambda: _dev(testing.filter_elements(rng, 4, dx), dtype, dev)
    sm = lambda: _dev(testing.smoother_elements(rng, 4, dx), dtype, dev)
    el = _dev(testing.smoother_element_inputs(rng, 4, dx), dtype, dev)
    _build.reset_launch_counts()
    for call in (lambda: bc.bank_filter_combine(fl(), fl()),
                 lambda: bs.bank_smoother_combine(sm(), sm()),
                 lambda: bs.bank_smoother_elements(*el)):
        with pytest.raises(NotImplementedError, match="band"):
            call()
    assert all(k.launches == 0 for k in COMBINE_KERNELS)


# ---------------------------------------------------------------------------
# The wide bands: K1 to dy = 512, K6–K9 to 1,024, K10–K12's block variants
# (8 < dx ≤ 512). Tolerances at these widths: float64 1e-10 as above;
# float32 1e-3, the bound chip_smoke.py holds every kernel to, since a
# float32 factor of a 256–1,024-wide S or P loses more digits than the
# small shapes above.
# ---------------------------------------------------------------------------

COMBINE_KERNELS = (bc.K10, bs.K11, bs.K12, bc.K10B, bs.K11B, bs.K12B)
WIDE_TOL = {torch.float64: 1e-10, torch.float32: 1e-3}

WIDE_CASES = [
    # (kernel, make inputs, wrapper, plain)
    (fe.K1T, lambda r: testing.update_inputs(r, 2, 512, 256),
     lambda *a: fe.fused_update(*a, 0.0), lambda *a: fe._update_plain(*a)),
    (fe.K1T, lambda r: testing.update_inputs(r, 1, 64, 512),
     lambda *a: fe.fused_update(*a, 0.0), lambda *a: fe._update_plain(*a)),
    # K6 and K7 hand these shapes to their tiled variants
    (fu.K6T, lambda r: testing.sigma_inputs(r, 2, 512),
     lambda *a: fu.fused_sigma(*a, 1.0, "cholesky"),
     lambda *a: fu._sigma_plain(*a, 1.0, "cholesky")),
    (fu.K6T, lambda r: testing.sigma_inputs(r, 1, 1024),
     lambda *a: fu.fused_sigma(*a, 1.0, "cholesky"),
     lambda *a: fu._sigma_plain(*a, 1.0, "cholesky")),
    (fu.K7T, lambda r: testing.sigma_aug_inputs(r, 2, 512, 512),
     lambda *a: fu.fused_sigma_aug(*a, 1.0, "cholesky"),
     lambda *a: fu._sigma_aug_plain(*a, 1.0, "cholesky")),
    # K8 and K9 hand these shapes to their tiled variants
    (fu.K8T, lambda r: testing.ut_update_inputs(r, 1, 1024, 512, 512, 256),
     lambda *a: fu.fused_ut_update(*a, 1 / 1024, 0.0, True),
     lambda *a: fu._ut_update_plain(*a, 1 / 1024, 0.0, True)),
    (fu.K8T, lambda r: testing.ut_update_inputs(r, 1, 1536, 768, 512, 256),
     lambda *a: fu.fused_ut_update(*a, 1 / 1536, 0.0, False),
     lambda *a: fu._ut_update_plain(*a, 1 / 1536, 0.0, False)),
    (fu.K9T, lambda r: testing.ut_predict_inputs(r, 2, 1024, 512),
     lambda *a: fu.fused_ut_predict(*a, 1 / 1024, 0.0, 0.0, True),
     lambda *a: fu._ut_predict_plain(*a, 1 / 1024, 0.0, 0.0, True)),
    (fu.K9T, lambda r: testing.ut_predict_inputs(r, 1, 2048, 1024),
     lambda *a: fu.fused_ut_predict(*a, 1 / 2048, 0.0, 0.0, False),
     lambda *a: fu._ut_predict_plain(*a, 1 / 2048, 0.0, 0.0, False)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", range(len(WIDE_CASES)))
def test_wide_band_kernel_matches_plain(dev, dtype, case):
    kernel, make, wrapper, plain = WIDE_CASES[case]
    args = _dev(make(np.random.default_rng(case)), dtype, dev)
    before = kernel.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert_close(g, w, WIDE_TOL[dtype])


# ---------------------------------------------------------------------------
# The one-launch blocked factor (csrc/tiled_chol.cuh) under K6t, K7t, K1t
# and K8t: config 5's shapes, ragged last panels, batches, the bands'
# edges, a non-PD P or S failing in the first, a middle or the last panel.
# One wrapper call is one launch of its kernel and of no other.
# ---------------------------------------------------------------------------

def _one_launch(kernel, wrapper, args):
    before = {k.name: k.launches for k in _build.KERNELS}
    got = wrapper(*args)
    torch.cuda.synchronize()
    after = {k.name: k.launches for k in _build.KERNELS}
    assert after[kernel.name] == before[kernel.name] + 1
    assert all(after[n] == before[n] for n in after if n != kernel.name)
    return got if isinstance(got, tuple) else (got,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["cholesky", "sqrtm"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n", [241, 512, 1024])
def test_tiled_sigma_points_match_plain(dev, dtype, method, B, n):
    args = _dev(testing.sigma_inputs(np.random.default_rng(n + B), B, n),
                dtype, dev)
    assert fu.sigma_kernel(n, method, args[0].element_size(),
                           _build.smem_optin(dev)) is fu.K6T
    got = _one_launch(fu.K6T, lambda *a: fu.fused_sigma(*a, 1.2, method),
                      args)
    want = fu._sigma_plain(*args, 1.2, method)
    assert torch.isfinite(got[0]).all()
    assert_close(got[0], want, WIDE_TOL[dtype])


FACTOR_UPDATES = [(1, 512, 256), (1, 512, 128), (1, 64, 512), (3, 130, 97)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,dx,dy", FACTOR_UPDATES)
def test_tiled_ekf_update_at_config_5_and_the_edge(dev, dtype, B, dx, dy):
    args = _dev(testing.update_inputs(np.random.default_rng(dy), B, dx, dy),
                dtype, dev)
    got = _one_launch(fe.K1T, lambda *a: fe.fused_update(*a, 1e-4), args)
    for g, w in zip(got, fe._update_plain(*args, 1e-4)):
        assert torch.isfinite(g).all()
        assert_close(g, w, WIDE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dn", [512, 256])
def test_tiled_sigma_aug_at_config_5(dev, dtype, dn):
    args = _dev(testing.sigma_aug_inputs(np.random.default_rng(dn), 1, 512,
                                         dn), dtype, dev)
    got = _one_launch(fu.K7T,
                      lambda *a: fu.fused_sigma_aug(*a, 0.9, "cholesky"),
                      args)
    want = fu._sigma_aug_plain(*args, 0.9, "cholesky")
    assert torch.isfinite(got[0]).all()
    assert_close(got[0], want, WIDE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("add_r", [True, False])
def test_tiled_ut_update_at_config_5(dev, dtype, add_r):
    args = _dev(testing.ut_update_inputs(np.random.default_rng(5), 1, 1024,
                                         512, 512, 256), dtype, dev)
    got = _one_launch(fu.K8T, lambda *a: fu.fused_ut_update(
        *a, 1 / 1024, 0.1, add_r), args)
    want = fu._ut_update_plain(*args, 1 / 1024, 0.1, add_r)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert_close(g, w, WIDE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fail_at", [0, 150, 299])
def test_tiled_factor_nans_a_non_pd_element(dev, dtype, fail_at):
    """A failing pivot in the first, a middle or the last (ragged) panel:
    K6t NaNs that element's points, K1t and K8t every output of theirs; the
    other element stays finite and equal to its plain version."""
    rng = np.random.default_rng(fail_at)
    m, P = _dev(testing.sigma_inputs(rng, 2, 300), dtype, dev)
    P[1, fail_at, fail_at] = -1e3
    got = _one_launch(fu.K6T, lambda *a: fu.fused_sigma(*a, 1.0, "cholesky"),
                      (m, P))[0]
    want = fu._sigma_plain(m, P, 1.0, "cholesky")
    assert torch.isnan(got[1]).all() and torch.isnan(want[1]).all()
    assert_close(got[0], want[0], WIDE_TOL[dtype])
    a = _dev(testing.update_inputs(rng, 2, 40, 300), dtype, dev)
    a[3][1, fail_at, fail_at] = -1e3
    got = _one_launch(fe.K1T, lambda *x: fe.fused_update(*x, 0.0), a)
    for g, w in zip(got, fe._update_plain(*a, 0.0)):
        assert torch.isnan(g[1]).all() and torch.isnan(w[1]).all()
        assert_close(g[0], w[0], WIDE_TOL[dtype])
    u = _dev(testing.ut_update_inputs(rng, 1, 600, 300, 300, 300), dtype, dev)
    u[6][fail_at, fail_at] = -1e3
    got = _one_launch(fu.K8T, lambda *x: fu.fused_ut_update(
        *x, 1 / 600, 0.0, True), u)
    for g in got:
        assert torch.isnan(g).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx,M", [(9, 130), (64, 33), (200, 3), (512, 2)])
def test_block_filter_combine_matches_plain(dev, dtype, dx, M):
    rng = np.random.default_rng(dx * M)
    left = _dev(testing.filter_elements(rng, M, dx, dx // 2, M // 4, True),
                dtype, dev)
    right = _dev(testing.filter_elements(rng, M, dx, dx // 2,
                                         normalized=True), dtype, dev)
    _build.reset_launch_counts()
    got = bc.bank_filter_combine(left, right)
    torch.cuda.synchronize()
    assert (bc.K10.launches, bc.K10B.launches) == (0, 1)
    for g, w in zip(got, tas._combine(left, right)):
        assert torch.isfinite(g).all()
        assert_close(g, w, WIDE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_filter_combine_guard_lanes(dev, dtype):
    """K10's guard in the block variant at dx = 64: the same non-finite
    entries as the plain version, lane 0 (a negative eigenvalue: −1e-8 in
    float64, −1e-4 in float32, whose rounding at this width reaches
    1e-8) finite throughout."""
    rng = np.random.default_rng(6)
    neg = -1e-8 if dtype == torch.float64 else -1e-4
    left = _dev(testing.guard_lanes(
        rng, testing.filter_elements(rng, 40, 64, 32, normalized=True),
        neg=neg), dtype, dev)
    right = _dev(testing.filter_elements(rng, 40, 64, 32, normalized=True),
                 dtype, dev)
    before = bc.K10B.launches
    got = bc.bank_filter_combine(left, right)
    want = tas._combine(left, right)
    torch.cuda.synchronize()
    assert bc.K10B.launches == before + 1
    for g, w in zip(got, want):
        bad = ~torch.isfinite(w)
        assert torch.equal(bad, ~torch.isfinite(g))
        assert torch.isfinite(g[0]).all()
        assert_close(torch.where(bad, 0, g), torch.where(bad, 0, w),
                     WIDE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_combines_broadcast_the_left_operand(dev, dtype):
    """The chunked scan's step 4 at dx = 64: (1, G) against (chunk, G)."""
    rng = np.random.default_rng(7)
    G, C, dx = 5, 4, 64
    for make, wrap, plain, kernel in (
            (lambda r, M: testing.filter_elements(r, M, dx, 32,
                                                  normalized=True),
             bc.bank_filter_combine, tas._combine, bc.K10B),
            (lambda r, M: testing.smoother_elements(r, M, dx),
             bs.bank_smoother_combine, tas._smoother_combine, bs.K12B)):
        left = [x[None] for x in _dev(make(rng, G), dtype, dev)]
        right = [x.reshape((C, G) + x.shape[1:])
                 for x in _dev(make(rng, C * G), dtype, dev)]
        before = kernel.launches
        got = wrap(left, right)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for g, w in zip(got, plain(left, right)):
            assert g.shape[:2] == (C, G)
            assert_close(g, w, WIDE_TOL[dtype])


# K11b (csrc/bank_combine.cu block_smoother_elements_kernel): the band's
# edges, F shared and banked, the shared-memory tile (dx ≤ 64) and the
# global route (dx = 65, 100, 512), widths that are not a multiple of the
# panels (32 in float32, 16 in float64) or the register tiles
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx,M,shared", [(9, 130, True), (33, 70, False),
                                         (64, 40, False), (64, 300, True),
                                         (65, 20, True), (100, 9, True),
                                         (512, 2, True)])
def test_block_elements_kernel_matches_plain(dev, dtype, dx, M, shared):
    fm, fP, pm, pP, F = _dev(
        testing.smoother_element_inputs(np.random.default_rng(dx + M), M,
                                        dx), dtype, dev)
    if shared:
        F = F[0].expand(M, dx, dx)
    _build.reset_launch_counts()
    got = bs.bank_smoother_elements(fm, fP, pm, pP, F)
    torch.cuda.synchronize()
    assert (bs.K11.launches, bs.K11B.launches) == (0, 1)
    for g, w in zip(got, bs._elements_plain(fm, fP, pm, pP, F)):
        assert_close(g, w, WIDE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_elements_kernel_nan_on_non_pd(dev, dtype):
    fm, fP, pm, pP, F = _dev(
        testing.smoother_element_inputs(np.random.default_rng(8), 5, 64),
        dtype, dev)
    pP = -pP
    got = bs.bank_smoother_elements(fm, fP, pm, pP, F)
    torch.cuda.synchronize()
    assert bs.K11B.launches > 0
    for g, w in zip(got, bs._elements_plain(fm, fP, pm, pP, F)):
        assert torch.isnan(g).all() and torch.isnan(w).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx,M", [(9, 300), (64, 70), (512, 2)])
def test_block_smoother_combine_matches_plain(dev, dtype, dx, M):
    rng = np.random.default_rng(dx + M)
    e1 = _dev(testing.smoother_elements(rng, M, dx), dtype, dev)
    e2 = _dev(testing.smoother_elements(rng, M, dx), dtype, dev)
    _build.reset_launch_counts()
    got = bs.bank_smoother_combine(e1, e2)
    torch.cuda.synchronize()
    assert (bs.K12.launches, bs.K12B.launches) == (0, 1)
    for g, w in zip(got, tas._smoother_combine(e1, e2)):
        assert_close(g, w, WIDE_TOL[dtype])


# K10b and K12b (csrc/bank_combine.cu tiled_*_kernel): every route and
# block size (the shared-memory tile 64 and global scratch; K10b's 512
# threads a block at M ≤ the SM count in float32) at the band's edges and
# at widths that are not a multiple of the 32-wide panels or the register
# tiles
TILED_DXS = (9, 31, 33, 63, 64, 65, 96, 128, 512)
TILED_CASES = [(dx, M) for dx in TILED_DXS for M in (1, 4, 130, 512)
               if not (dx >= 128 and M == 512)]


def _tiled_pair(kind, rng, M, dx, dtype, dev, chunk=None):
    """Left and right operands of K10b ("combine") or K12b, over M lanes,
    or the chunked scan's (1, M) against (chunk, M)."""
    if kind == "combine":
        make = lambda k: testing.filter_elements(rng, k, dx, max(1, dx // 2),
                                                 normalized=True)
    else:
        make = lambda k: testing.smoother_elements(rng, k, dx)
    if chunk is None:
        return _dev(make(M), dtype, dev), _dev(make(M), dtype, dev)
    left = [x[None] for x in _dev(make(M), dtype, dev)]
    right = [x.reshape((chunk, M) + x.shape[1:])
             for x in _dev(make(chunk * M), dtype, dev)]
    return left, right


TILED_OPS = {"combine": (bc.bank_filter_combine, tas._combine, bc.K10B),
             "smoother": (bs.bank_smoother_combine, tas._smoother_combine,
                          bs.K12B)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx,M", TILED_CASES)
@pytest.mark.parametrize("kind", ["combine", "smoother"])
def test_tiled_combines_match_plain(dev, kind, dx, M, dtype):
    wrap, plain, kernel = TILED_OPS[kind]
    left, right = _tiled_pair(kind, np.random.default_rng(dx * M), M, dx,
                              dtype, dev)
    _build.reset_launch_counts()
    got = wrap(left, right)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    assert sum(k.launches for k in _build.KERNELS) == 1
    for g, w in zip(got, plain(left, right)):
        assert torch.isfinite(g).all()
        assert_close(g, w, WIDE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx,G", [(9, 7), (64, 512), (65, 5), (96, 3)])
@pytest.mark.parametrize("kind", ["combine", "smoother"])
def test_tiled_combines_broadcast_the_left_operand(dev, kind, dx, G, dtype):
    """The chunked scan's step 4: (1, G) against (chunk, G), path C's own
    (1, 512) × (4, 512) among them."""
    wrap, plain, kernel = TILED_OPS[kind]
    left, right = _tiled_pair(kind, np.random.default_rng(dx + G), G, dx,
                              dtype, dev, chunk=4)
    before = kernel.launches
    got = wrap(left, right)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for g, w in zip(got, plain(left, right)):
        assert g.shape[:2] == (4, G)
        assert_close(g, w, WIDE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx,M", [(33, 4), (64, 40), (100, 3)])
def test_tiled_combine_nan_on_a_failed_inner_factor(dev, dx, M, dtype):
    """J2 = −1e3·I: the inner matrix I + sym(Uᵀ J2 U) is not positive
    definite, and every output is NaN on both sides (cholesky_nan)."""
    left, right = _tiled_pair("combine", np.random.default_rng(dx), M, dx,
                              dtype, dev)
    right[3] = -1e3 * torch.eye(dx, dtype=dtype, device=dev).expand(
        M, dx, dx).contiguous()
    before = bc.K10B.launches
    got = bc.bank_filter_combine(left, right)
    want = tas._combine(left, right)
    torch.cuda.synchronize()
    assert bc.K10B.launches == before + 1
    for g, w in zip(got, want):
        assert torch.isnan(g).all() and torch.isnan(w).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx", [9, 33, 96, 200])
def test_tiled_combine_guard_lanes(dev, dx, dtype):
    """K10's guard on every route: lane 0's C1 with a negative eigenvalue
    (−1e-8 in float64, −1e-4 in float32) and lane 1's with an infinite
    pair fail their factor on both sides (U = 0, M⁻¹ = I): the same
    non-finite entries, lane 0 finite throughout."""
    rng = np.random.default_rng(dx + 6)
    neg = -1e-8 if dtype == torch.float64 else -1e-4
    make = lambda: testing.filter_elements(rng, 6, dx, max(1, dx // 2),
                                           normalized=True)
    left = _dev(testing.guard_lanes(rng, make(), neg=neg), dtype, dev)
    right = _dev(make(), dtype, dev)
    got = bc.bank_filter_combine(left, right)
    want = tas._combine(left, right)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        bad = ~torch.isfinite(w)
        assert torch.equal(bad, ~torch.isfinite(g))
        assert torch.isfinite(g[0]).all()
        assert_close(torch.where(bad, 0, g), torch.where(bad, 0, w),
                     WIDE_TOL[dtype])


@pytest.mark.parametrize("solver,combines", [("woodbury", 262),
                                             ("native", 0)])
def test_path_c_launches(dev, solver, combines):
    """Path C (the smoother on zoo.linear_gaussian_lgssm(64, 32) at
    T = 65,536, chunk 128, float32): exactly 262 K10b launches with the
    Woodbury solver (none with the native one), one K11b and 262 K12b,
    nothing else; finite outputs."""
    params = zoo.linear_gaussian_lgssm(64, 32, dtype=torch.float32,
                                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ys = torch.randn(65_536, 32, generator=gen, device=dev)
    _build.reset_launch_counts()
    post = tas.parallel_kalman_smoother(params, ys, solver=solver, chunk=128)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in _build.KERNELS if k.launches}
    assert counts == {**({"bft_block_combine": combines} if combines
                         else {}),
                      "bft_block_smoother_elements": 1,
                      "bft_block_smoother_combine": 262}
    assert torch.isfinite(post.smoothed_means).all()
    assert torch.isfinite(post.smoothed_covariances).all()


def _smoother_run(dx, dy, T, solver, device, chunk=16):
    rng = np.random.default_rng(dx)
    fields = testing.lgssm_fields(rng, dx, dy)
    ys = rng.standard_normal((T, dy))
    params = linear.ParamsLGSSM(**{k: testing.to_torch(v, torch.float64,
                                                       device)
                                   for k, v in fields.items()})
    _build.reset_launch_counts()
    out = tas.parallel_kalman_smoother(
        params, testing.to_torch(ys, torch.float64, device), solver=solver,
        chunk=chunk)
    if device != "cpu":
        torch.cuda.synchronize()
    return out, {k.name: k.launches for k in COMBINE_KERNELS}


def test_the_band_picks_lane_kernels_at_8_and_block_kernels_at_9(dev):
    """One schedule, two widths: dx = 8 launches only the lane kernels,
    dx = 9 only the block kernels, the same number of times."""
    _, lane = _smoother_run(8, 3, 200, "woodbury", dev)
    _, block = _smoother_run(9, 3, 200, "woodbury", dev)
    names = [k.name for k in COMBINE_KERNELS]
    assert [lane[n] for n in names[3:]] == [0, 0, 0]
    assert [block[n] for n in names[:3]] == [0, 0, 0]
    assert [block[n] for n in names[3:]] == [lane[n] for n in names[:3]]
    assert lane["bft_bank_smoother_elements"] == 1
    assert lane["bft_bank_combine"] > 1


@pytest.mark.parametrize("solver", ["woodbury", "native"])
def test_block_parallel_smoother_matches_plain_path(dev, solver):
    """dx = 24 through the block kernels (the native solver's filter has no
    kernel; its smoother still runs K11 and K12) against the CPU."""
    got, counts = _smoother_run(24, 12, 700, solver, dev)
    want, _ = _smoother_run(24, 12, 700, solver, "cpu")
    assert counts["bft_block_combine"] == (0 if solver == "native" else
                                           counts["bft_block_smoother_combine"])
    assert counts["bft_block_smoother_elements"] == 1
    assert counts["bft_bank_combine"] == counts["bft_bank_smoother_combine"] == 0
    for name in ("filtered_means", "filtered_covariances", "smoothed_means",
                 "smoothed_covariances", "marginal_loglik"):
        assert_close(getattr(got, name), getattr(want, name), 1e-9)


@pytest.mark.parametrize("update_chunk", [None, 128])
def test_wide_ekf_kernel_path_matches_plain_path(dev, update_chunk):
    """Lorenz-96 at dx = 512, dy = 256, one sequence: K1t once per step, or
    twice with ``update_chunk=128``, K2t once, and no K1/K2."""
    T = 3
    data_model, data_params, _ = zoo.lorenz96(512, 256, integrator="rk4",
                                              dtype=torch.float64,
                                              device="cpu")
    _, emissions = data_model.sample(data_params, T,
                                     generator=torch.Generator().manual_seed(9))
    runs = []
    for device in (dev, "cpu"):
        _, params, _ = zoo.lorenz96(512, 256, dtype=torch.float64,
                                    device=device)
        _build.reset_launch_counts()
        runs.append(inference.extended_kalman_filter(
            params, emissions.to(device), update_chunk=update_chunk))
        if device == dev:
            torch.cuda.synchronize()
            assert (fe.K1T.launches, fe.K2T.launches) == (
                T * (1 if update_chunk is None else 2), T)
            assert fe.K1.launches == fe.K2.launches == 0
    got, want = runs
    assert_close(got.filtered_means, want.filtered_means, 1e-9)
    assert_close(got.marginal_loglik, want.marginal_loglik, 1e-9)


def test_wide_ukf_kernel_path_matches_plain_path(dev):
    """The additive UKF at dx = 512, dy = 256: K6t twice, K8t and K9t once
    per step, and no K6/K8/K9 (their workspace does not fit in shared
    memory)."""
    T = 2
    up = ParamsUKF(1.0, 0.0, 0.0, "cholesky")
    data_model, data_params, _ = zoo.lorenz96(512, 256, integrator="rk4",
                                              dtype=torch.float64,
                                              device="cpu")
    _, emissions = data_model.sample(data_params, T,
                                     generator=torch.Generator().manual_seed(10))
    runs = []
    for device in (dev, "cpu"):
        _, params, _ = zoo.lorenz96(512, 256, dtype=torch.float64,
                                    device=device)
        _build.reset_launch_counts()
        runs.append(inference.unscented_kalman_filter(
            params, up, emissions.to(device), additive=True))
        if device == dev:
            torch.cuda.synchronize()
            assert (fu.K6T.launches, fu.K8T.launches, fu.K9T.launches) == (
                2 * T, T, T)
            assert fu.K6.launches == fu.K8.launches == fu.K9.launches == 0
    got, want = runs
    assert_close(got.filtered_means, want.filtered_means, 1e-9)
    assert_close(got.marginal_loglik, want.marginal_loglik, 1e-9)


# ---------------------------------------------------------------------------
# K1t and K2t, the tiled variants of K1 and K2: the shape rule picks the
# variant (per element where the workspace fits in shared memory, tiled
# otherwise); every case asserts that the kernel the rule names launched
# and the other did not. Shapes: config 5, the bands' edges, sizes that
# are not multiples of a tile or a panel, and both sides of the rule's
# edge (at dx = 117/118, dy = 40 in float32, 75/76 at dy = 32 in float64;
# K2 at dx = dq = 96/97 in float32, 64/65 in float64).
# ---------------------------------------------------------------------------

VARIANT_UPDATE_SHAPES = [(1, 512, 256), (1, 512, 128), (2, 512, 512),
                         (1, 511, 33), (3, 511, 1), (3, 100, 33),
                         (3, 65, 300), (1, 117, 40), (1, 118, 40),
                         (1, 75, 32), (1, 76, 32)]
VARIANT_PREDICT_SHAPES = [(1, 512, 512), (2, 511, 1), (3, 65, 200),
                          (1, 96, 96), (1, 97, 97), (1, 64, 64), (1, 65, 65),
                          (3, 100, 33)]


def _expect_one(pair, want):
    """Exactly ``want`` of the two kernels in ``pair`` launched, once."""
    assert {k.name: k.launches for k in pair} == {
        k.name: int(k is want) for k in pair}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,dx,dy", VARIANT_UPDATE_SHAPES)
def test_update_variant_matches_twin(dev, dtype, B, dx, dy):
    args = _dev(testing.update_inputs(np.random.default_rng(dx + dy), B, dx,
                                      dy), dtype, dev)
    want_kernel = fe.update_kernel(dx, dy, args[0].element_size(),
                                   _build.smem_optin(dev))
    _build.reset_launch_counts()
    got = fe.fused_update(*args, 1e-4)
    torch.cuda.synchronize()
    _expect_one((fe.K1, fe.K1T), want_kernel)
    for g, w in zip(got, fe._update_plain(*args, 1e-4)):
        assert torch.isfinite(g).all()
        assert_close(g, w, WIDE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,dx,dq", VARIANT_PREDICT_SHAPES)
def test_predict_variant_matches_twin(dev, dtype, B, dx, dq):
    args = _dev(testing.predict_inputs(np.random.default_rng(dx + dq), B, dx,
                                       dq), dtype, dev)
    want_kernel = fe.predict_kernel(dx, dq, args[0].element_size(),
                                    _build.smem_optin(dev))
    _build.reset_launch_counts()
    got = fe.fused_predict_cov(*args)
    torch.cuda.synchronize()
    _expect_one((fe.K2, fe.K2T), want_kernel)
    assert_close(got, fe._predict_plain(*args), WIDE_TOL[dtype])


def test_the_rule_sends_config_5_to_the_tiled_kernels(dev):
    optin = _build.smem_optin(dev)
    for itemsize in (4, 8):
        assert fe.update_kernel(512, 256, itemsize, optin) is fe.K1T
        assert fe.update_kernel(512, 128, itemsize, optin) is fe.K1T
        assert fe.predict_kernel(512, 512, itemsize, optin) is fe.K2T
        assert fe.update_kernel(64, 32, itemsize, optin) is fe.K1
        assert fe.predict_kernel(64, 64, itemsize, optin) is fe.K2


@pytest.mark.parametrize("fail_at", [0, 69])
def test_tiled_update_nan_on_non_pd(dev, fail_at):
    """A negative pivot in K1t's first panel, or only in its third: every
    output is NaN on both sides."""
    raw = testing.update_inputs(np.random.default_rng(3), 2, 200, 70)
    raw[3][:, fail_at, fail_at] = -1e3
    args = _dev(raw, torch.float64, dev)
    _build.reset_launch_counts()
    got = fe.fused_update(*args)
    torch.cuda.synchronize()
    assert fe.K1T.launches == 1
    for g, w in zip(got, fe._update_plain(*args)):
        assert torch.isnan(g).all() and torch.isnan(w).all()


def test_batched_lorenz96_keeps_the_per_element_kernels(dev):
    """The batched filter (B = 512, dx = 64, dy = 32) runs K1 and K2, never
    the tiled variants."""
    _, params, _ = zoo.lorenz96(64, 32, dtype=torch.float32, device=dev)
    model, data_params, _ = zoo.lorenz96(64, 32, integrator="rk4",
                                         dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    _, emissions = model.sample(data_params, 3, generator=gen,
                                batch_shape=(512,))
    _build.reset_launch_counts()
    post = inference.extended_kalman_filter(params, emissions)
    torch.cuda.synchronize()
    assert (fe.K1.launches, fe.K2.launches) == (3, 3)
    assert fe.K1T.launches == fe.K2T.launches == 0
    assert torch.isfinite(post.filtered_means).all()


# ---------------------------------------------------------------------------
# K8t and K9t, the tiled variants of K8 and K9, picked by the same kind of
# shape rule: config 5 at B = 1, 2, 3, the band's edges, sizes that are not
# multiples of a tile or a panel, no R or Q, an asymmetric Q, and both
# sides of the rule's edge (K8 at dx = 188 | 189, dy = 32 in float32 and
# 105 | 106 in float64; K9 at dx = 192 | 193 and 128 | 129).
# ---------------------------------------------------------------------------

UT_VARIANT_UPDATE_SHAPES = [  # (B, rows, ld, dx, dy, add_r)
    (1, 1024, 512, 512, 256, True), (2, 1024, 512, 512, 256, True),
    (3, 1024, 512, 512, 256, True), (3, 1536, 768, 512, 256, False),
    (1, 2048, 1024, 1024, 1024, True), (2, 300, 150, 100, 129, False),
    (1, 376, 188, 188, 32, True), (1, 378, 189, 189, 32, True),
    (1, 210, 105, 105, 32, True), (1, 212, 106, 106, 32, True)]
UT_VARIANT_PREDICT_SHAPES = [  # (B, rows, dx, add_q)
    (1, 1024, 512, True), (2, 1024, 512, True), (3, 1024, 512, False),
    (1, 2048, 1024, True), (3, 600, 300, True), (1, 384, 192, True),
    (1, 386, 193, True), (1, 256, 128, False), (1, 258, 129, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,rows,ld,dx,dy,add_r", UT_VARIANT_UPDATE_SHAPES)
def test_ut_update_variant_matches_plain(dev, dtype, B, rows, ld, dx, dy,
                                         add_r):
    args = _dev(testing.ut_update_inputs(np.random.default_rng(dx + dy), B,
                                         rows, ld, dx, dy), dtype, dev)
    want_kernel = fu.update_kernel(dx, dy, args[0].element_size(),
                                   _build.smem_optin(dev))
    static = (1 / rows, 2.0, add_r)
    _build.reset_launch_counts()
    got = fu.fused_ut_update(*args, *static)
    torch.cuda.synchronize()
    _expect_one((fu.K8, fu.K8T), want_kernel)
    for g, w in zip(got, fu._ut_update_plain(*args, *static)):
        assert torch.isfinite(g).all()
        assert_close(g, w, WIDE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,rows,dx,add_q", UT_VARIANT_PREDICT_SHAPES)
def test_ut_predict_variant_matches_plain(dev, dtype, B, rows, dx, add_q):
    rng = np.random.default_rng(dx)
    fpts, center, Q = testing.ut_predict_inputs(rng, B, rows, dx)
    Q = Q + 0.1 * np.triu(rng.standard_normal((dx, dx)), 1)  # asymmetric
    args = _dev((fpts, center, Q), dtype, dev)
    want_kernel = fu.predict_kernel(dx, args[0].element_size(),
                                    _build.smem_optin(dev))
    static = (1 / rows, 0.1, 2.0, add_q)
    _build.reset_launch_counts()
    got = fu.fused_ut_predict(*args, *static)
    torch.cuda.synchronize()
    _expect_one((fu.K9, fu.K9T), want_kernel)
    for g, w in zip(got, fu._ut_predict_plain(*args, *static)):
        assert_close(g, w, WIDE_TOL[dtype])


def test_the_rule_sends_config_5_to_the_tiled_ut_kernels(dev):
    optin = _build.smem_optin(dev)
    for itemsize in (4, 8):
        assert fu.update_kernel(512, 256, itemsize, optin) is fu.K8T
        assert fu.predict_kernel(512, itemsize, optin) is fu.K9T
        assert fu.update_kernel(64, 32, itemsize, optin) is fu.K8
        assert fu.predict_kernel(64, itemsize, optin) is fu.K9


@pytest.mark.parametrize("fail_at", [0, 69])
def test_tiled_ut_update_nan_on_non_pd(dev, fail_at):
    """A negative pivot in K8t's first panel, or only in its third: every
    output is NaN on both sides."""
    raw = testing.ut_update_inputs(np.random.default_rng(3), 2, 400, 200,
                                   200, 70)
    raw[6][fail_at, fail_at] = -1e3
    args = _dev(raw, torch.float64, dev)
    _build.reset_launch_counts()
    got = fu.fused_ut_update(*args, 1 / 400, 2.0, True)
    torch.cuda.synchronize()
    assert fu.K8T.launches == 1
    for g, w in zip(got, fu._ut_update_plain(*args, 1 / 400, 2.0, True)):
        assert torch.isnan(g).all() and torch.isnan(w).all()


# K8t as sym(P) − ZᵀZ and K2t's grouped first launch: config 5's shapes
# and ragged ones (a last panel of 1 or 6, tiles cut by dx and dq), B = 1
# and 3; the covariance exactly symmetric, one wrapper launch a call
K8T_SHAPES = [(1, 1024, 512, 512, 256, True), (3, 400, 200, 190, 33, True),
              (1, 400, 240, 200, 70, False), (2, 300, 150, 130, 97, True),
              (3, 1024, 512, 512, 256, False)]
K2T_SHAPES = [(1, 512, 512), (3, 512, 512), (3, 200, 70), (2, 511, 1),
              (3, 130, 97), (1, 129, 200)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,rows,ld,dx,dy,add_r", K8T_SHAPES)
def test_tiled_ut_update_matches_plain(dev, dtype, B, rows, ld, dx, dy,
                                       add_r):
    args = _dev(testing.ut_update_inputs(np.random.default_rng(rows + dy), B,
                                         rows, ld, dx, dy), dtype, dev)
    assert fu.update_kernel(dx, dy, args[0].element_size(),
                            _build.smem_optin(dev)) is fu.K8T
    static = (1 / rows, 2.0, add_r)
    got = _one_launch(fu.K8T, lambda *a: fu.fused_ut_update(*a, *static),
                      args)
    assert torch.equal(got[2], got[2].mT)
    for g, w in zip(got, fu._ut_update_plain(*args, *static)):
        assert torch.isfinite(g).all()
        assert_close(g, w, WIDE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,dx,dq", K2T_SHAPES)
def test_tiled_predict_matches_plain(dev, dtype, B, dx, dq):
    args = _dev(testing.predict_inputs(np.random.default_rng(dx + dq), B, dx,
                                       dq), dtype, dev)
    assert fe.predict_kernel(dx, dq, args[0].element_size(),
                             _build.smem_optin(dev)) is fe.K2T
    got = _one_launch(fe.K2T, fe.fused_predict_cov, args)[0]
    assert torch.isfinite(got).all() and torch.equal(got, got.mT)
    assert_close(got, fe._predict_plain(*args), WIDE_TOL[dtype])


# K8 and K9 at the batched Lorenz-96 UKF's augmented shapes (192 rows,
# ld = 96; 256 rows), with a ragged S (dy = 33: C starts at column 36), at
# dy = 33, dx = 65 with rows that are not a multiple of the 64-row chunk,
# and on both sides of K8's narrow panel (dy = 8 | 9)
UT_BLOCK_UPDATE_SHAPES = [(512, 192, 96, 64, 32, False),
                          (512, 192, 96, 64, 33, False),
                          (3, 130, 70, 65, 33, True),
                          (5, 40, 20, 12, 8, True), (5, 40, 20, 12, 9, True)]
UT_BLOCK_PREDICT_SHAPES = [(512, 256, 64, False), (3, 130, 65, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,rows,ld,dx,dy,add_r", UT_BLOCK_UPDATE_SHAPES)
def test_ut_update_kernel_at_lorenz96_shapes_matches_plain(
        dev, dtype, B, rows, ld, dx, dy, add_r):
    args = _dev(testing.ut_update_inputs(np.random.default_rng(dx + dy), B,
                                         rows, ld, dx, dy), dtype, dev)
    assert fu.update_kernel(dx, dy, args[0].element_size(),
                            _build.smem_optin(dev)) is fu.K8
    static = (1 / rows, 2.0, add_r)
    _build.reset_launch_counts()
    got = fu.fused_ut_update(*args, *static)
    torch.cuda.synchronize()
    _expect_one((fu.K8, fu.K8T), fu.K8)
    for g, w in zip(got, fu._ut_update_plain(*args, *static)):
        assert torch.isfinite(g).all()
        assert_close(g, w, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,rows,dx,add_q", UT_BLOCK_PREDICT_SHAPES)
def test_ut_predict_kernel_at_lorenz96_shapes_matches_plain(
        dev, dtype, B, rows, dx, add_q):
    rng = np.random.default_rng(dx)
    fpts, center, Q = testing.ut_predict_inputs(rng, B, rows, dx)
    Q = Q + 0.1 * np.triu(rng.standard_normal((dx, dx)), 1)  # asymmetric
    args = _dev((fpts, center, Q), dtype, dev)
    static = (1 / rows, 0.1, 2.0, add_q)
    _build.reset_launch_counts()
    got = fu.fused_ut_predict(*args, *static)
    torch.cuda.synchronize()
    _expect_one((fu.K9, fu.K9T), fu.K9)
    assert torch.equal(got[1], got[1].mT)  # mirrored tiles: exactly symmetric
    for g, w in zip(got, fu._ut_predict_plain(*args, *static)):
        assert_close(g, w, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dy,fail_at", [(32, 31), (70, 0), (70, 69),
                                        (2, 1), (8, 7)])
def test_ut_update_kernel_nan_on_non_pd(dev, dtype, dy, fail_at):
    """A negative pivot in K8's only panel (of 32, or of 8 at dy ≤ 8), or
    in the first or the third of three: the pivots' reciprocals are NaN,
    so every output is NaN on both sides."""
    raw = testing.ut_update_inputs(np.random.default_rng(4), 4, 100, 50, 40,
                                   dy)
    raw[6][fail_at, fail_at] = -1e3
    args = _dev(raw, dtype, dev)
    _build.reset_launch_counts()
    got = fu.fused_ut_update(*args, 1 / 100, 2.0, True)
    torch.cuda.synchronize()
    _expect_one((fu.K8, fu.K8T), fu.K8)
    for g, w in zip(got, fu._ut_update_plain(*args, 1 / 100, 2.0, True)):
        assert torch.isnan(g).all() and torch.isnan(w).all()


def test_batched_lorenz96_keeps_the_per_element_ut_kernels(dev):
    """The batched UKF (B = 512, dx = 64, dy = 32) runs K8 and K9, never the
    tiled variants."""
    _, params, _ = zoo.lorenz96(64, 32, dtype=torch.float32, device=dev)
    model, data_params, _ = zoo.lorenz96(64, 32, integrator="rk4",
                                         dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    _, emissions = model.sample(data_params, 3, generator=gen,
                                batch_shape=(512,))
    _build.reset_launch_counts()
    post = inference.unscented_kalman_filter(
        params, ParamsUKF(1.0, 2.0, 0.0, "cholesky"), emissions,
        additive=True)
    torch.cuda.synchronize()
    assert (fu.K8.launches, fu.K9.launches) == (3, 3)
    assert fu.K8T.launches == fu.K9T.launches == 0
    assert torch.isfinite(post.filtered_means).all()


# ---------------------------------------------------------------------------
# K6t and K7t, the tiled variants of K6 and K7, picked by the same kind of
# rule: both sides of each edge (K6's Cholesky at n = 240 | 241 in float32
# and 170 | 171 in float64, Newton–Schulz at 120 | 121 and 85 | 86; K7's
# Cholesky at dx = 223 | 224 and 144 | 145 with dn = 64), config 5 and the
# band's edge; a non-PD P failing in the first or a later panel.
# ---------------------------------------------------------------------------

SIGMA_VARIANT_SHAPES = [  # (B, n, method)
    (2, 240, "cholesky"), (2, 241, "cholesky"), (2, 170, "cholesky"),
    (2, 171, "cholesky"), (2, 120, "sqrtm"), (2, 121, "sqrtm"),
    (2, 85, "sqrtm"), (2, 86, "sqrtm"), (1, 512, "cholesky"),
    (3, 512, "cholesky"), (1, 1024, "cholesky"), (512, 64, "cholesky")]
SIGMA_AUG_VARIANT_SHAPES = [  # (B, dx, dn, method)
    (2, 223, 64, "cholesky"), (2, 224, 64, "cholesky"),
    (2, 144, 64, "cholesky"), (2, 145, 64, "cholesky"),
    (1, 512, 512, "cholesky"), (2, 300, 45, "sqrtm"),
    (512, 64, 64, "cholesky"), (512, 64, 32, "cholesky"), (33, 4, 2, "sqrtm")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,method", SIGMA_VARIANT_SHAPES)
def test_sigma_variant_matches_plain(dev, dtype, B, n, method):
    args = _dev(testing.sigma_inputs(np.random.default_rng(n), B, n), dtype,
                dev)
    want_kernel = fu.sigma_kernel(n, method, args[0].element_size(),
                                  _build.smem_optin(dev))
    _build.reset_launch_counts()
    got = fu.fused_sigma(*args, 1.3, method)
    torch.cuda.synchronize()
    _expect_one((fu.K6, fu.K6T), want_kernel)
    assert torch.isfinite(got).all()
    assert_close(got, fu._sigma_plain(*args, 1.3, method), WIDE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,dx,dn,method", SIGMA_AUG_VARIANT_SHAPES)
def test_sigma_aug_variant_matches_plain(dev, dtype, B, dx, dn, method):
    args = _dev(testing.sigma_aug_inputs(np.random.default_rng(dx + dn), B,
                                         dx, dn), dtype, dev)
    want_kernel = fu.sigma_aug_kernel(dx, dn, method, args[0].element_size(),
                                      _build.smem_optin(dev))
    _build.reset_launch_counts()
    got = fu.fused_sigma_aug(*args, 0.9, method)
    torch.cuda.synchronize()
    _expect_one((fu.K7, fu.K7T), want_kernel)
    assert torch.isfinite(got).all()
    assert_close(got, fu._sigma_aug_plain(*args, 0.9, method),
                 WIDE_TOL[dtype])


def test_the_rule_sends_config_5_to_the_tiled_sigma_kernels(dev):
    optin = _build.smem_optin(dev)
    for itemsize in (4, 8):
        assert fu.sigma_kernel(512, "cholesky", itemsize, optin) is fu.K6T
        assert fu.sigma_aug_kernel(512, 512, "cholesky", itemsize,
                                   optin) is fu.K7T
        assert fu.sigma_kernel(64, "cholesky", itemsize, optin) is fu.K6
        assert fu.sigma_aug_kernel(64, 64, "cholesky", itemsize,
                                   optin) is fu.K7


@pytest.mark.parametrize("n,fail_at", [(512, 0), (512, 300), (64, 0),
                                       (64, 40)])
def test_sigma_nan_on_non_pd(dev, n, fail_at):
    """A negative pivot in the first panel or a later one: element 1's
    points are NaN throughout on both sides, element 0's finite (K6t at
    n = 512, K6 at 64)."""
    raw = testing.sigma_inputs(np.random.default_rng(7), 2, n)
    raw[1][1, fail_at, fail_at] = -1e3
    args = _dev(raw, torch.float64, dev)
    _build.reset_launch_counts()
    got = fu.fused_sigma(*args, 1.0, "cholesky")
    torch.cuda.synchronize()
    assert (fu.K6T if n > 170 else fu.K6).launches == 1
    want = fu._sigma_plain(*args, 1.0, "cholesky")
    assert torch.isnan(got[1]).all() and torch.isnan(want[1]).all()
    assert_close(got[0], want[0], WIDE_TOL[torch.float64])


@pytest.mark.parametrize("dx,dn,part,fail_at", [
    (512, 512, "P", 0), (512, 512, "P", 400), (512, 512, "C", 100),
    (64, 32, "P", 40), (64, 32, "C", 0)])
def test_sigma_aug_nan_on_non_pd(dev, dx, dn, part, fail_at):
    """A non-PD P NaNs that element's state block, a non-PD C the noise
    block of every element, in the same places as the plain version (K7t
    at dx = dn = 512, K7 at 64 | 32)."""
    raw = list(testing.sigma_aug_inputs(np.random.default_rng(8), 2, dx, dn))
    if part == "P":
        raw[1][0, fail_at, fail_at] = -1e3
    else:
        raw[3][fail_at, fail_at] = -1e3
    args = _dev(raw, torch.float64, dev)
    _build.reset_launch_counts()
    got = fu.fused_sigma_aug(*args, 1.0, "cholesky")
    torch.cuda.synchronize()
    assert (fu.K7T if dx > 144 else fu.K7).launches == 1
    want = fu._sigma_aug_plain(*args, 1.0, "cholesky")
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and nan.any()
    assert_close(torch.where(nan, 0, got), torch.where(nan, 0, want),
                 WIDE_TOL[torch.float64])


@pytest.mark.parametrize("additive", [True, False])
def test_batched_lorenz96_keeps_the_per_element_sigma_kernels(dev,
                                                              additive):
    """The batched UKF (B = 512, dx = 64, dy = 32) runs K6 (additive) or K7
    (augmented), never K6t/K7t."""
    _, params, _ = zoo.lorenz96(64, 32, dtype=torch.float32, device=dev)
    model, data_params, _ = zoo.lorenz96(64, 32, integrator="rk4",
                                         dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    _, emissions = model.sample(data_params, 3, generator=gen,
                                batch_shape=(512,))
    _build.reset_launch_counts()
    post = inference.unscented_kalman_filter(
        params, ParamsUKF(1.0, 0.0, 0.0, "cholesky"), emissions,
        additive=additive)
    torch.cuda.synchronize()
    sigma = fu.K6 if additive else fu.K7
    assert sigma.launches == 6
    assert fu.K6T.launches == fu.K7T.launches == 0
    assert torch.isfinite(post.filtered_means).all()


# ---------------------------------------------------------------------------
# K9t at non-zero, negative centre weights (``ParamsUKF(0.5, 2, 0)``:
# w0m = −3, w0c = −0.25), and K7t's one launch at dx ≠ dn both ways, with
# a non-PD P or C: the NaN block on both sides in the same places.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,rows,dx,add_q", [(1, 1024, 512, True),
                                             (2, 600, 300, False),
                                             (1, 2048, 1024, True)])
def test_tiled_ut_predict_at_negative_centre_weights(dev, dtype, B, rows, dx,
                                                     add_q):
    w = ut_weights(rows // 2, ParamsUKF(0.5, 2.0, 0.0))[1]
    assert (w[1], w[2]) == (-3.0, -0.25)
    args = _dev(testing.ut_predict_inputs(np.random.default_rng(rows), B,
                                          rows, dx), dtype, dev)
    got = _one_launch(fu.K9T, lambda *a: fu.fused_ut_predict(*a, *w, add_q),
                      args)
    for g, want in zip(got, fu._ut_predict_plain(*args, *w, add_q)):
        assert torch.isfinite(g).all()
        assert_close(g, want, WIDE_TOL[dtype])


K7T_PAIRS = [(1, 512, 256), (2, 121, 512), (3, 300, 45), (1, 64, 200)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,dx,dn", K7T_PAIRS)
@pytest.mark.parametrize("part", ["none", "P", "C"])
def test_tiled_sigma_aug_factors_p_and_c_side_by_side(dev, dtype, B, dx, dn,
                                                      part):
    """One launch factors P and C, of different sizes, side by side; a
    non-PD P (element 0, its last pivot) NaNs that element's state block,
    a non-PD C (a pivot in its first panel) every noise block, as the
    plain version does on the CPU, where ``cholesky_ex`` flags every
    failing pivot."""
    raw = list(testing.sigma_aug_inputs(np.random.default_rng(dx + dn), B,
                                        dx, dn))
    if part == "P":
        raw[1][0, dx - 1, dx - 1] = -1e3
    elif part == "C":
        raw[3][2, 2] = -1e3
    args = _dev(raw, dtype, dev)
    assert fu.sigma_aug_kernel(dx, dn, "cholesky", args[0].element_size(),
                               _build.smem_optin(dev)) is fu.K7T
    got = _one_launch(fu.K7T,
                      lambda *a: fu.fused_sigma_aug(*a, 0.9, "cholesky"),
                      args)[0]
    want = fu._sigma_aug_plain(*(a.cpu() for a in args), 0.9,
                               "cholesky").to(dev)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert bool(nan.any()) == (part != "none")
    assert_close(torch.where(nan, 0, got), torch.where(nan, 0, want),
                 WIDE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,dx,dn", K7T_PAIRS[:2])
def test_tiled_sigma_aug_newton_schulz_pairs_the_rounds(dev, dtype, B, dx,
                                                        dn):
    """K7t by Newton–Schulz, P's and C's rounds in grouped launches (each
    product with its own batch), against the plain version."""
    args = _dev(testing.sigma_aug_inputs(np.random.default_rng(dx), B, dx,
                                         dn), dtype, dev)
    got = _one_launch(fu.K7T, lambda *a: fu.fused_sigma_aug(*a, 1.1, "sqrtm"),
                      args)[0]
    assert torch.isfinite(got).all()
    assert_close(got, fu._sigma_aug_plain(*args, 1.1, "sqrtm"),
                 WIDE_TOL[dtype])


# ---------------------------------------------------------------------------
# The smoothing side and the AGSF's options on the card against the CPU,
# float64 at 1e-8 (as chip_smoke.py's phase 4), small T and 2 iterations:
# the time-varying parallel smoother, ERTS and URTS, the parallel iterated
# smoothers (IEKS plain and LM, IPLS), the steady-state filter and
# smoother, and the AGSF with "trace" and "sdp" splitting and with the
# optimal reduction, each with the kernels it should launch.
# ---------------------------------------------------------------------------

SMOOTH_TOL = 1e-8
F64 = torch.float64
SMOOTHED = ("filtered_means", "filtered_covariances", "smoothed_means",
            "smoothed_covariances", "marginal_loglik")
MIXTURE = ("means", "covariances", "weights", "marginal_loglik")


def _field(x, name):
    return x[name] if isinstance(x, dict) else getattr(x, name)


def _card_vs_cpu(run, names, launched, quiet=()):
    """run(device) on the card (every counter reset before it) and on the
    CPU: each field finite and within SMOOTH_TOL; the kernels in
    ``launched`` launched, those in ``quiet`` not."""
    _build.reset_launch_counts()
    got = run("cuda")
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in _build.KERNELS}
    assert all(counts[k.name] > 0 for k in launched), counts
    assert all(counts[k.name] == 0 for k in quiet), counts
    want = run("cpu")
    for n in names:
        g, w = _field(got, n), _field(want, n)
        assert torch.isfinite(g).all(), n
        assert_close(g, w, SMOOTH_TOL)


def _tv_arrays(T, dx, dy):
    """A random time-varying model and emissions (chip_smoke.py's
    ``tv_problem``): (m0, P0, Fs, cs, Qs, Hs, ds, Rs, ys)."""
    rng = np.random.default_rng(dx * 100 + T)
    f = 1.0 / np.sqrt(dx)
    eye = np.eye(dx)
    mats = f * rng.standard_normal((T, dx, dx))
    em = rng.standard_normal((T, dy, dy)) / np.sqrt(dy)
    return (rng.standard_normal(dx), eye,
            0.7 * eye + 0.1 * f * rng.standard_normal((T, dx, dx)),
            0.1 * rng.standard_normal((T, dx)),
            0.5 * mats @ np.swapaxes(mats, -1, -2) + eye,
            f * rng.standard_normal((T, dy, dx)),
            0.1 * rng.standard_normal((T, dy)),
            0.5 * em @ np.swapaxes(em, -1, -2) + np.eye(dy),
            rng.standard_normal((T, dy)))


@pytest.mark.parametrize("dx,dy,chunk,kernels", [
    (4, 2, "auto", (bc.K10, bs.K11, bs.K12)),
    (12, 5, 8, (bc.K10B, bs.K11B, bs.K12B))])
def test_tv_smoother_kernel_path_matches_cpu(dev, dx, dy, chunk, kernels):
    arrays = _tv_arrays(40, dx, dy)
    other = [k for k in (bc.K10, bs.K11, bs.K12, bc.K10B, bs.K11B, bs.K12B)
             if k not in kernels]
    _card_vs_cpu(lambda d: tas.parallel_kalman_smoother_tv(
        *_dev(arrays, F64, dev if d == "cuda" else "cpu"), chunk=chunk),
        SMOOTHED, kernels, other)


@pytest.fixture(scope="module")
def rb_track():
    """Range-bearing tracking at T = 30, sampled on the CPU from a seed:
    (the model's parameters on the card and on the CPU, inputs,
    emissions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    T = 30
    model, cpu, _ = zoo.range_bearing_tracking(dtype=F64, device="cpu")
    card = zoo.range_bearing_tracking(dtype=F64, device="cuda")[1]
    inputs = zoo.bot_experiment_inputs(T, device="cpu")
    _, em = model.sample(cpu, T, inputs=inputs,
                         generator=torch.Generator().manual_seed(30))
    return {"cuda": card, "cpu": cpu}, inputs, em


UP = ParamsUKF(1.0, 0.0, 0.0, "cholesky")
ITERATED = {
    "ieks": lambda p, u, e: inference.parallel_iterated_extended_smoother(
        p, e, num_iter=2, inputs=u, nominal="filter", damping=0.7)[0],
    "lm-ieks": lambda p, u, e: inference.parallel_iterated_extended_smoother(
        p, e, num_iter=2, inputs=u, nominal="filter", lm_lambda=100.0)[0],
    "ipls": lambda p, u, e: inference.parallel_iterated_sigma_point_smoother(
        p, UP, e, num_iter=2, inputs=u, nominal="filter")[0],
    "erts": lambda p, u, e: inference.extended_rts_smoother(p, e, inputs=u),
    "urts": lambda p, u, e: inference.unscented_rts_smoother(p, UP, e,
                                                             inputs=u),
}
ITERATED_KERNELS = {"ieks": (fe.K1, fe.K2, bc.K10, bs.K11, bs.K12),
                    "erts": (fe.K1, fe.K2), "urts": (fu.K7, fu.K8, fu.K9)}


@pytest.mark.parametrize("label", list(ITERATED))
def test_nonlinear_smoother_kernel_path_matches_cpu(dev, rb_track, label):
    params, inputs, em = rb_track
    run = ITERATED[label]
    kernels = ITERATED_KERNELS.get(label, ITERATED_KERNELS["ieks"])
    _card_vs_cpu(lambda d: run(params[d], inputs.to(d), em.to(d)), SMOOTHED,
                 kernels)


@pytest.mark.parametrize("kind", ["filter", "smoother"])
def test_steady_state_kalman_matches_cpu(dev, kind):
    """Path B's model at T = 400 (a head of 64, then the steady gain): no
    kernel launches."""
    from bayesianfiltering_tpu_torch.ops import steady_state as ss

    rng = np.random.default_rng(40)
    fields = testing.lgssm_fields(rng, 4, 2)
    ys = rng.standard_normal((400, 2))

    def run(d):
        params = linear.ParamsLGSSM(**{k: testing.to_torch(v, F64, d)
                                       for k, v in fields.items()})
        return getattr(ss, f"steady_state_kalman_{kind}")(
            params, testing.to_torch(ys, F64, d))
    names = SMOOTHED if kind == "smoother" else (
        "filtered_means", "filtered_covariances", "marginal_loglik")
    _card_vs_cpu(run, names, (), _build.KERNELS)


@pytest.mark.parametrize("autocov", ["trace", "sdp"])
def test_agsf_splitting_rules_match_cpu(dev, autocov):
    """The AGSF [3,2,2] on the quadratic-measurement model (f = 0.8·x + q,
    g = 0.1·x² + r; T = 20, opt_args (0.8, 1.0), the top-k reduction, as
    tests/test_torch_agsf_options.py) with the same draws on both sides.
    (Experiment A's sin(10x) stretches a last-digit difference tenfold a
    step: its "sdp" run parted from the CPU's within 20 steps.)"""
    T = 20
    model, cpu, _ = zoo.quadratic_measurement(dtype=F64, device="cpu")
    card = zoo.quadratic_measurement(dtype=F64, device="cuda")[1]
    _, em = model.sample(cpu, T, generator=torch.Generator().manual_seed(20))
    draws = inference.agsf_draws(torch.Generator().manual_seed(21), T,
                                 [3, 2, 2], 1, "topk", em)

    def run(d):
        moved = type(draws)(*(None if x is None else x.to(d) for x in draws))
        return inference.augmented_gaussian_sum_filter(
            card if d == "cuda" else cpu, em.to(d), [3, 2, 2],
            opt_args=(0.8, 1.0), autocov=autocov, reduction="topk",
            draws=moved)[0]
    _card_vs_cpu(run, MIXTURE, (bu.K3, bu.K4))


def test_agsf_optimal_matches_cpu(dev):
    """The AGSF-optimal [4,2,2] on the stochastic-volatility model, its
    regime input switching at T/2 (T = 20), with the same draws."""
    T, M = 20, 4
    model, cpu, _ = zoo.stochastic_volatility(dtype=F64, device="cpu")
    card = zoo.stochastic_volatility(dtype=F64, device="cuda")[1]
    inputs = torch.cat([torch.zeros(T // 2), torch.ones(T - T // 2)])
    _, em = model.sample(cpu, T, inputs=inputs,
                         generator=torch.Generator().manual_seed(22))
    draws = inference.agsf_draws(torch.Generator().manual_seed(23), T,
                                 [M, 2, 2], 3, "optimal", em)

    def run(d):
        moved = type(draws)(*(None if x is None else x.to(d) for x in draws))
        return inference.augmented_gaussian_sum_filter_optimal(
            card if d == "cuda" else cpu, em.to(d), [M, 2, 2],
            opt_args=(0.1, 0.1), inputs=inputs.to(d), draws=moved)[0]
    _card_vs_cpu(run, MIXTURE, (bu.K3, bu.K4))
