"""The port's CUDA kernels on the card: each kernel against its plain
twin, and the filters' kernel path against their plain path on the CPU.

Needs a CUDA device; every test skips without one. This file imports no
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
from bayesianfiltering_tpu_torch.ops import bank_update as bu
from bayesianfiltering_tpu_torch.ops import fused_ekf as fe

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


UPDATE_CASES = [(fe.K1, fe.fused_update, 5, 16, 8), (fe.K1, fe.fused_update, 2, 130, 70),
                (bu.K3, bu.bank_chol_update, 300, 4, 1),
                (bu.K3, bu.bank_chol_update, 129, 8, 7)]
PREDICT_CASES = [(fe.K2, fe.fused_predict_cov, 5, 16, 9),
                 (bu.K4, bu.bank_predict_cov, 300, 4, 2),
                 (bu.K4, bu.bank_predict_cov, 129, 7, 8)]


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
    _, cpu_params, _ = zoo.lorenz96(16, 8, dtype=torch.float64)
    want = inference.extended_kalman_filter(cpu_params, emissions.cpu(),
                                            num_iter=2)
    assert_close(got.filtered_means, want.filtered_means, 1e-9)
    assert_close(got.marginal_loglik, want.marginal_loglik, 1e-9)


def test_agsf_kernel_path_matches_plain_path(dev):
    T = 10
    model, params, _ = zoo.bearings_only_tracking(dtype=torch.float64)
    inputs = zoo.bot_maneuver_inputs(T)
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
    assert bu.K3.launches == T and bu.K4.launches == T
    want, _ = inference.augmented_gaussian_sum_filter(
        params, emissions, [6, 2, 2], inputs=inputs, reduction="systematic",
        draws=draws)
    for name in ("means", "weights", "marginal_loglik"):
        assert_close(getattr(got, name), getattr(want, name), 1e-8)


def test_outside_the_kernel_band_raises(dev):
    """The band is the TPU package's (dx ≤ 512, dy ≤ 128): a CUDA input
    outside it raises instead of falling back to the plain twin."""
    raw = testing.update_inputs(np.random.default_rng(1), 1, 4, 129)
    args = [testing.to_torch(a, torch.float32, dev) for a in raw]
    before = fe.K1.launches
    with pytest.raises(NotImplementedError):
        fe.fused_update(*args)
    assert fe.K1.launches == before
