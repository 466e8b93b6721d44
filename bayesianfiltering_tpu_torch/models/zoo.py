"""Model zoo on the main path
(counterpart of ``bayesianfiltering_tpu/models/zoo.py``).

Each constructor returns ``(model, params, bpf_params)``. Model functions
use the non-additive convention ``f(x, q, u)`` / ``h(x, r, u)`` and act on
a trailing state axis, so they take a batch of states as they are. Their
constant matrices follow the dtype and device of the state they are given.
Components are taken as width-1 slices, never as 0-dim scalars:
``torch.func.jacfwd`` promotes a python float times a 0-dim float32 tensor
to float64.

Every constructor builds on the card unless ``device`` names another
(:func:`~bayesianfiltering_tpu_torch.config.resolve_device`; without a card
an unnamed device raises).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bayesianfiltering_tpu_torch.config import resolve_device
from bayesianfiltering_tpu_torch.distributions import mvn_logpdf
from bayesianfiltering_tpu_torch.models.nonlinear import NonlinearSSM
from bayesianfiltering_tpu_torch.models.params import ParamsBPF, ParamsNLSSM
from bayesianfiltering_tpu_torch.utils.angles import angular_residual


def _like(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return c.to(dtype=x.dtype, device=x.device)


def _bundle(state_dim, state_noise_dim, emission_dim, emission_noise_dim,
            mu0, Sigma0, f, Q, h, R, log_prob=None, **extras):
    model = NonlinearSSM(state_dim, state_noise_dim, emission_dim,
                         emission_noise_dim)
    params = ParamsNLSSM(
        initial_mean=mu0,
        initial_covariance=Sigma0,
        dynamics_function=f,
        dynamics_noise_bias=torch.zeros_like(Q[0]),
        dynamics_noise_covariance=Q,
        emission_function=h,
        emission_noise_bias=torch.zeros_like(R[0]),
        emission_noise_covariance=R,
        **extras,
    )
    if log_prob is None:
        r0 = params.emission_noise_bias
        log_prob = lambda x, y, u: mvn_logpdf(y, h(x, r0, u), R)
    bpf_params = ParamsBPF(*params[:8], emission_distribution_log_prob=log_prob)
    return model, params, bpf_params


def linear_gaussian(state_dim: int = 3, emission_dim: int = 3,
                    a: float = 0.8, h_scale: float = 0.1,
                    q: float = 1.0, r: float = 0.1,
                    dtype: torch.dtype = torch.float32, device=None):
    """Linear-Gaussian SSM x' = a·x + q, y = h_scale·I x + r."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    A = a * torch.eye(state_dim, **kw)
    H = h_scale * torch.eye(emission_dim, state_dim, **kw)
    f = lambda x, qn, u: x @ _like(A, x).mT + qn
    h = lambda x, rn, u: x @ _like(H, x).mT + rn
    return _bundle(state_dim, state_dim, emission_dim, emission_dim,
                   torch.zeros(state_dim, **kw), torch.eye(state_dim, **kw),
                   f, q * torch.eye(state_dim, **kw), h,
                   r * torch.eye(emission_dim, **kw))


def linear_gaussian_lgssm(state_dim: int = 3, emission_dim: int = 3,
                          a: float = 0.8, h_scale: float = 0.1,
                          q: float = 1.0, r: float = 0.1,
                          dtype: torch.dtype = torch.float32, device=None):
    """The model of :func:`linear_gaussian` as a
    :class:`~bayesianfiltering_tpu_torch.ops.linear.ParamsLGSSM`, for the
    exact Kalman filter."""
    from bayesianfiltering_tpu_torch.ops.linear import ParamsLGSSM

    kw = dict(dtype=dtype, device=resolve_device(device))
    return ParamsLGSSM(
        initial_mean=torch.zeros(state_dim, **kw),
        initial_covariance=torch.eye(state_dim, **kw),
        dynamics_matrix=a * torch.eye(state_dim, **kw),
        dynamics_covariance=q * torch.eye(state_dim, **kw),
        emission_matrix=h_scale * torch.eye(emission_dim, state_dim, **kw),
        emission_covariance=r * torch.eye(emission_dim, **kw),
    )


def _input(u, x):
    """The input's first component as a width-1 slice in ``x``'s dtype."""
    return torch.as_tensor(u).to(x).reshape(-1)[0:1]


def _sq_norm(x):
    """xᵀx over the trailing axis, kept as a width-1 axis."""
    return (x * x).sum(-1, keepdim=True)


def quadratic_measurement(a: float = 0.8, b: float = 0.1, q: float = 1.0,
                          r: float = 1.0, dtype: torch.dtype = torch.float32,
                          device=None):
    """The 1-D model f = a·x + q, g = b·x² + r of the ICASSP-2023
    experiment."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    f = lambda x, qn, u: a * x + qn
    h = lambda x, rn, u: b * x ** 2 + rn
    return _bundle(1, 1, 1, 1, torch.zeros(1, **kw), torch.eye(1, **kw), f,
                   q * torch.eye(1, **kw), h, r * torch.eye(1, **kw))


def sine_quadratic(a: float = 10.0, q: float = 1.0, r: float = 1.0,
                   dtype: torch.dtype = torch.float32, device=None):
    """The 1-D "Experiment A" model f = sin(a·x) + q, g = x·x + r: the
    dynamics fold the state into [−1, 1] and the quadratic emission hides
    its sign, a multimodal posterior."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    f = lambda x, qn, u: torch.sin(a * x) + qn
    h = lambda x, rn, u: _sq_norm(x) + rn
    return _bundle(1, 1, 1, 1, torch.zeros(1, **kw), torch.eye(1, **kw), f,
                   q * torch.eye(1, **kw), h, r * torch.eye(1, **kw))


def scalar_growth(q: float = 10.0, r: float = 1.0,
                  dtype: torch.dtype = torch.float32, device=None):
    """Univariate nonlinear growth model (UNGM), the classic EKF stress
    test: x' = x/2 + 25x/(1 + x²) + 8cos(1.2u) + q, y = x²/20 + r. The
    input u is read as its first component, a width-1 slice."""
    kw = dict(dtype=dtype, device=resolve_device(device))

    def f(x, qn, u):
        u = _input(u, x)
        return (0.5 * x + 25.0 * x / (1.0 + x ** 2)
                + 8.0 * torch.cos(1.2 * u) + qn)

    def h(x, rn, u):
        return x ** 2 / 20.0 + rn

    return _bundle(1, 1, 1, 1, torch.zeros(1, **kw), 5.0 * torch.eye(1, **kw),
                   f, q * torch.eye(1, **kw), h, r * torch.eye(1, **kw))


def _parts(x):
    return x[..., 0:1], x[..., 1:2], x[..., 2:3], x[..., 3:4]


def _cv(dt: float, scale: float = 1.0):
    """Constant-velocity step of (px, vx, py, vy), times ``scale``."""
    def cv(x):
        px, vx, py, vy = _parts(x)
        return scale * torch.cat([px + dt * vx, vx, py + dt * vy, vy], dim=-1)
    return cv


def _ct(dt: float):
    """Coordinated-turn step at rate ω = 0.1·a/|v|."""
    def ct(x, a):
        px, vx, py, vy = _parts(x)
        w = 0.1 * a / torch.sqrt(vx ** 2 + vy ** 2)
        s, c = torch.sin(dt * w), torch.cos(dt * w)
        return torch.cat([px + s / w * vx - (1 - c) / w * vy,
                          c * vx - s * vy,
                          (1 - c) / w * vx + py + s / w * vy,
                          s * vx + c * vy], dim=-1)
    return ct


def _noise(q):
    """G q with G = [[0.5, 0], [1, 0], [0, 0.5], [0, 1]]."""
    q0, q1 = q[..., 0:1], q[..., 1:2]
    return torch.cat([0.5 * q0, q0, 0.5 * q1, q1], dim=-1)


def _maneuver_dynamics(cv, ct, acc: float):
    """CV / left turn / right turn blended by the maneuver input u ∈ {0, 1,
    2}, plus G q."""
    def f(x, q, u):
        u = torch.as_tensor(u).to(x).reshape(-1)
        return (0.5 * (u - 1) * (u - 2) * cv(x)
                - u * (u - 2) * ct(x, acc)
                + 0.5 * u * (u - 1) * ct(x, -acc)) + _noise(q)
    return f


def bearings_only_tracking(dt: float = 0.5, acc: float = 0.5,
                           maneuvering: bool = True, r: float = 25e-6,
                           wrap_bearing: bool = True,
                           dtype: torch.dtype = torch.float32, device=None):
    """Bearing-only tracking with maneuver inputs u ∈ {0, 1, 2}: state
    (px, vx, py, vy), constant-velocity / coordinated-turn dynamics blended
    by u, bearing atan2(py, px); ``wrap_bearing`` wraps the bearing
    innovation to (−π, π]."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    cv, ct = _cv(dt), _ct(dt)

    if maneuvering:
        f = _maneuver_dynamics(cv, ct, acc)
    else:
        def f(x, q, u):
            return cv(x) + _noise(q)

    def h(x, rn, u):
        return torch.atan2(x[..., 2:3], x[..., 0:1]) + rn

    extras = {}
    if wrap_bearing:
        extras["emission_residual"] = angular_residual((0,))
    return _bundle(4, 2, 1, 1, torch.ones(4, **kw),
                   torch.diag(torch.tensor([0.1, 0.005, 0.1, 0.01], **kw)),
                   f, torch.eye(2, **kw), h, r * torch.eye(1, **kw), **extras)


def bot_maneuver_inputs(seq_length: int, device=None) -> torch.Tensor:
    """The three-phase maneuver schedule 1…1, 0…0, 2…2."""
    third = seq_length // 3
    return torch.tensor([1] * third + [0] * third
                        + [2] * (seq_length - 2 * third),
                        device=resolve_device(device))


# The reference builds the range-bearing model's CV matrix as 1.05 times a
# float32 array, so its entries carry float32(1.05) even in float64 runs.
_CV_GROWTH = float(np.float32(1.05))


def range_bearing_tracking(dt: float = 0.5, acc: float = 0.5,
                           q: float = 1e-5, r: float = 25e-6,
                           wrap_bearing: bool = True,
                           dtype: torch.dtype = torch.float32, device=None):
    """The T=500 BOT experiment's model: mildly unstable maneuvering
    dynamics (1.05·CV), Q = q·I₂, and range + bearing observations
    (atan2(py, px), √(px² + py²)) with R = r·I₂ and analytic emission
    Jacobians; ``wrap_bearing`` wraps the bearing innovation."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    f = _maneuver_dynamics(_cv(dt, _CV_GROWTH), _ct(dt), acc)

    def h(x, rn, u):
        px, _, py, _ = _parts(x)
        return torch.cat([torch.atan2(py, px),
                          torch.sqrt(px ** 2 + py ** 2)], dim=-1) + rn

    def h_jac_x(x, rn, u):
        px, _, py, _ = _parts(x)
        rho2 = px ** 2 + py ** 2
        rho = torch.sqrt(rho2)
        zero = torch.zeros_like(px)
        return torch.stack([
            torch.cat([-py / rho2, zero, px / rho2, zero], dim=-1),
            torch.cat([px / rho, zero, py / rho, zero], dim=-1)], dim=-2)

    def h_jac_r(x, rn, u):
        return torch.eye(2, dtype=x.dtype, device=x.device)

    extras = {}
    if wrap_bearing:
        extras["emission_residual"] = angular_residual((0,))
    return _bundle(4, 2, 2, 2, torch.tensor([-0.05, 0.001, 0.7, -0.05], **kw),
                   torch.diag(torch.tensor([0.1, 0.005, 0.1, 0.01], **kw)),
                   f, q * torch.eye(2, **kw), h, r * torch.eye(2, **kw),
                   emission_jacobian_x=h_jac_x, emission_jacobian_r=h_jac_r,
                   **extras)


def bot_experiment_inputs(seq_length: int, device=None) -> torch.Tensor:
    """The 2/5–1/5–2/5 maneuver schedule 1…1, 0…0, 2…2 of the T=500 BOT
    experiment."""
    two_fifth = int(2 * seq_length / 5)
    fifth = int(seq_length / 5)
    return torch.tensor([1] * two_fifth + [0] * fifth
                        + [2] * (seq_length - two_fifth - fifth),
                        device=resolve_device(device))


def _lorenz63_step(sigma: float, rho: float, beta: float, dt: float):
    """One Euler step of the Lorenz-63 vector field."""
    def step(x):
        x0, x1, x2 = x[..., 0:1], x[..., 1:2], x[..., 2:3]
        return torch.cat([x0 + dt * sigma * (x1 - x0),
                          x1 + dt * (x0 * rho - x1 - x0 * x2),
                          x2 + dt * (x0 * x1 - beta * x2)], dim=-1)
    return step


def tsp_lorenz63(q: float = 20.0, r: float = 0.1, obs_scale: float = 0.001,
                 dt: float = 0.01, dtype: torch.dtype = torch.float32,
                 device=None):
    """The TSP-2023 experiment's model: Lorenz-63 Euler dynamics
    (σ, ρ, β = 10, 28, 2.667) with Q = q·I₃ and the weak quadratic
    observation y = obs_scale·xᵀx + r, R = r, μ₀ = 0, Σ₀ = I₃."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    step = _lorenz63_step(10.0, 28.0, 2.667, dt)
    f = lambda x, qn, u: step(x) + qn
    h = lambda x, rn, u: obs_scale * _sq_norm(x) + rn
    return _bundle(3, 3, 1, 1, torch.zeros(3, **kw), torch.eye(3, **kw), f,
                   q * torch.eye(3, **kw), h, r * torch.eye(1, **kw))


def stochastic_volatility(state_dim: int = 3, sigma: float = 5.0,
                          beta: float = 0.5, phi: float = 0.8,
                          q: float = 20.0, r: float = 1e-3,
                          dtype: torch.dtype = torch.float32, device=None):
    """Markov-switching stochastic volatility: x' = φ x + q, and the
    emission ``u·β·exp(x/σ)·r + (1 − u)(H0 x + r)`` (H0 = 0.1·I) switched by
    the regime input u ∈ {0, 1}, multiplicative noise for u = 1. The BPF's
    log-density uses the covariance M R Mᵀ, M = u·β·diag(exp(x/σ)) +
    (1 − u)·I, over a batch of particles."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    Phi = phi * torch.eye(state_dim, **kw)
    H0 = 0.1 * torch.eye(state_dim, **kw)
    R = r * torch.eye(state_dim, **kw)
    eye = torch.eye(state_dim, **kw)

    f = lambda x, qn, u: x @ _like(Phi, x).mT + qn

    def h(x, rn, u):
        u = _input(u, x)
        return (u * beta * torch.exp(x / sigma) * rn
                + (1 - u) * (x @ _like(H0, x).mT + rn))

    def log_prob(x, y, u):
        u = _input(u, x)
        M = (u[..., None] * beta * torch.diag_embed(torch.exp(x / sigma))
             + (1 - u)[..., None] * _like(eye, x))
        r0 = torch.zeros_like(x)
        return mvn_logpdf(y, h(x, r0, u), M @ _like(R, x) @ M.mT)

    return _bundle(state_dim, state_dim, state_dim, state_dim,
                   torch.zeros(state_dim, **kw), torch.eye(state_dim, **kw),
                   f, q * torch.eye(state_dim, **kw), h, R,
                   log_prob=log_prob)


def lorenz63(sigma: float = 10.0, rho: float = 28.0, beta: float = 2.667,
             dt: float = 0.01, q: float = 0.1, r: float = 1.0,
             dtype: torch.dtype = torch.float32, device=None):
    """Lorenz-63 (Euler step) with the quadratic-norm observation
    y = xᵀx + r, μ₀ = 1."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    step = _lorenz63_step(sigma, rho, beta, dt)
    f = lambda x, qn, u: step(x) + qn
    h = lambda x, rn, u: _sq_norm(x) + rn
    return _bundle(3, 3, 1, 1, torch.ones(3, **kw), torch.eye(3, **kw), f,
                   q * torch.eye(3, **kw), h, r * torch.eye(1, **kw))


def lorenz96(state_dim: int = 40, emission_dim: Optional[int] = None,
             alpha: float = 1.0, beta: float = 1.0, gamma: float = 8.0,
             dt: float = 0.01, q: float = 0.1, r: float = 1.0,
             integrator: str = "euler",
             dtype: torch.dtype = torch.float32, device=None):
    """Lorenz-96, dx_i = α(x_{i+1} − x_{i−2}) x_{i−1} − β x_i + γ, with
    strided linear observations y_i = x_{2i}. ``integrator`` is "euler"
    (the reference's step; unstable at dt=0.01 for long noisy runs) or
    "rk4" (stable; used to generate benchmark data)."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    if emission_dim is None:
        emission_dim = state_dim // 2
    H = torch.zeros(emission_dim, state_dim, **kw)
    rows = torch.arange(emission_dim)
    keep = 2 * rows < state_dim  # rows past the state stay zero, as in JAX
    H[rows[keep], 2 * rows[keep]] = 1.0
    R = r * torch.eye(emission_dim, **kw)

    def vf(x):
        adv = alpha * (torch.roll(x, -1, -1) - torch.roll(x, 2, -1)) \
            * torch.roll(x, 1, -1)
        return adv - beta * x + gamma

    if integrator == "rk4":
        def f(x, qn, u):
            k1 = vf(x)
            k2 = vf(x + 0.5 * dt * k1)
            k3 = vf(x + 0.5 * dt * k2)
            k4 = vf(x + dt * k3)
            return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4) + qn
    elif integrator == "euler":
        def f(x, qn, u):
            return x + dt * vf(x) + qn
    else:
        raise ValueError(f"unknown integrator {integrator!r}")

    def h(x, rn, u):
        return x @ _like(H, x).mT + rn

    return _bundle(state_dim, state_dim, emission_dim, emission_dim,
                   gamma * torch.ones(state_dim, **kw),
                   torch.eye(state_dim, **kw), f, q * torch.eye(state_dim, **kw),
                   h, R)


# ---------------------------------------------------------------------------
# Nonlinearity test functions, each with its Jacobian and Hessian where the
# reference gives them; they act on the trailing axis of x
# ---------------------------------------------------------------------------

def power_nonlinearity(p: float):
    """f(x) = (1 + ‖x‖²)^(p/2) with J and H."""
    def f(x):
        return (1 + (x * x).sum(-1)) ** (p / 2)

    def J(x):
        return (p * (1 + (x * x).sum(-1)) ** (p / 2 - 1))[..., None] * x

    def H(x):
        s = 1 + (x * x).sum(-1)
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        return ((2 * p * (p / 2 - 1) * s ** (p / 2 - 2))[..., None, None]
                * x[..., :, None] * x[..., None, :]
                + eye * (p * s ** (p / 2 - 1))[..., None, None])
    return f, J, H


def sinc_nonlinearity():
    """f(x) = sin(‖x‖²)/‖x‖²."""
    def f(x):
        s = (x * x).sum(-1)
        return torch.sin(s) / s
    return f


def linear_nonlinear_product():
    """f(x) = x₀ sin(x₁) with J and H."""
    f = lambda x: x[..., 0] * torch.sin(x[..., 1])

    def J(x):
        return torch.stack([torch.sin(x[..., 1]),
                            x[..., 0] * torch.cos(x[..., 1])], dim=-1)

    def H(x):
        c = torch.cos(x[..., 1])
        return torch.stack([
            torch.stack([torch.zeros_like(c), c], dim=-1),
            torch.stack([c, -x[..., 0] * torch.sin(x[..., 1])], dim=-1)],
            dim=-2)
    return f, J, H


def linear_nonlinear_sum():
    """f(x) = x₀ + sin(x₁) with J and H."""
    f = lambda x: x[..., 0] + torch.sin(x[..., 1])

    def J(x):
        return torch.stack([torch.ones_like(x[..., 0]),
                            torch.cos(x[..., 1])], dim=-1)

    def H(x):
        zero = torch.zeros_like(x[..., 0])
        return torch.stack([torch.stack([zero, zero], dim=-1),
                            torch.stack([zero, -torch.sin(x[..., 1])],
                                        dim=-1)], dim=-2)
    return f, J, H


def quadratic_form(a: float = 1.0, b: float = 1.0):
    """f(x) = xᵀAx/2 with A = diag(a, b), J = A x, H = A."""
    def A(x):
        return torch.tensor([[a, 0.0], [0.0, b]], dtype=x.dtype,
                            device=x.device)

    f = lambda x: (x * (x @ A(x).mT)).sum(-1) / 2
    J = lambda x: x @ A(x).mT
    H = lambda x: A(x).expand(x.shape[:-1] + (2, 2))
    return f, J, H


__all__ = ["quadratic_measurement", "sine_quadratic", "scalar_growth",
           "linear_gaussian", "linear_gaussian_lgssm",
           "bearings_only_tracking", "bot_maneuver_inputs",
           "range_bearing_tracking", "bot_experiment_inputs", "tsp_lorenz63",
           "stochastic_volatility", "lorenz63", "lorenz96",
           "power_nonlinearity", "sinc_nonlinearity",
           "linear_nonlinear_product", "linear_nonlinear_sum",
           "quadratic_form"]
