"""Model zoo on the main path
(counterpart of ``bayesianfiltering_tpu/models/zoo.py``).

Each constructor returns ``(model, params, bpf_params)``. Model functions
use the non-additive convention ``f(x, q, u)`` / ``h(x, r, u)`` and act on
a trailing state axis, so they take a batch of states as they are. Their
constant matrices follow the dtype and device of the state they are given.
"""
from __future__ import annotations

from typing import Optional

import torch

from bayesianfiltering_tpu_torch.distributions import mvn_logpdf
from bayesianfiltering_tpu_torch.models.nonlinear import NonlinearSSM
from bayesianfiltering_tpu_torch.models.params import ParamsBPF, ParamsNLSSM
from bayesianfiltering_tpu_torch.utils.angles import angular_residual


def _like(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return c.to(dtype=x.dtype, device=x.device)


def _bundle(state_dim, state_noise_dim, emission_dim, emission_noise_dim,
            mu0, Sigma0, f, Q, h, R, **extras):
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
    r0 = params.emission_noise_bias
    log_prob = lambda x, y, u: mvn_logpdf(y, h(x, r0, u), R)
    bpf_params = ParamsBPF(*params[:8], emission_distribution_log_prob=log_prob)
    return model, params, bpf_params


def linear_gaussian(state_dim: int = 3, emission_dim: int = 3,
                    a: float = 0.8, h_scale: float = 0.1,
                    q: float = 1.0, r: float = 0.1,
                    dtype: torch.dtype = torch.float32, device=None):
    """Linear-Gaussian SSM x' = a·x + q, y = h_scale·I x + r."""
    kw = dict(dtype=dtype, device=device)
    A = a * torch.eye(state_dim, **kw)
    H = h_scale * torch.eye(emission_dim, state_dim, **kw)
    f = lambda x, qn, u: x @ _like(A, x).mT + qn
    h = lambda x, rn, u: x @ _like(H, x).mT + rn
    return _bundle(state_dim, state_dim, emission_dim, emission_dim,
                   torch.zeros(state_dim, **kw), torch.eye(state_dim, **kw),
                   f, q * torch.eye(state_dim, **kw), h,
                   r * torch.eye(emission_dim, **kw))


def bearings_only_tracking(dt: float = 0.5, acc: float = 0.5,
                           maneuvering: bool = True, r: float = 25e-6,
                           wrap_bearing: bool = True,
                           dtype: torch.dtype = torch.float32, device=None):
    """Bearing-only tracking with maneuver inputs u ∈ {0, 1, 2}: state
    (px, vx, py, vy), constant-velocity / coordinated-turn dynamics blended
    by u, bearing atan2(py, px); ``wrap_bearing`` wraps the bearing
    innovation to (−π, π]."""
    kw = dict(dtype=dtype, device=device)
    # Components are taken as width-1 slices, never as 0-dim scalars:
    # torch.func.jacfwd promotes a python float times a 0-dim float32 tensor
    # to float64.
    def parts(x):
        return x[..., 0:1], x[..., 1:2], x[..., 2:3], x[..., 3:4]

    def cv(x):
        px, vx, py, vy = parts(x)
        return torch.cat([px + dt * vx, vx, py + dt * vy, vy], dim=-1)

    def ct(x, a):
        # coordinated turn at rate ω = 0.1·a/|v|
        px, vx, py, vy = parts(x)
        w = 0.1 * a / torch.sqrt(vx ** 2 + vy ** 2)
        s, c = torch.sin(dt * w), torch.cos(dt * w)
        return torch.cat([px + s / w * vx - (1 - c) / w * vy,
                          c * vx - s * vy,
                          (1 - c) / w * vx + py + s / w * vy,
                          s * vx + c * vy], dim=-1)

    def noise(q):
        q0, q1 = q[..., 0:1], q[..., 1:2]
        return torch.cat([0.5 * q0, q0, 0.5 * q1, q1], dim=-1)

    if maneuvering:
        def f(x, q, u):
            u = torch.as_tensor(u).to(x).reshape(-1)
            return (0.5 * (u - 1) * (u - 2) * cv(x)
                    - u * (u - 2) * ct(x, acc)
                    + 0.5 * u * (u - 1) * ct(x, -acc)) + noise(q)
    else:
        def f(x, q, u):
            return cv(x) + noise(q)

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
                        + [2] * (seq_length - 2 * third), device=device)


def lorenz96(state_dim: int = 40, emission_dim: Optional[int] = None,
             alpha: float = 1.0, beta: float = 1.0, gamma: float = 8.0,
             dt: float = 0.01, q: float = 0.1, r: float = 1.0,
             integrator: str = "euler",
             dtype: torch.dtype = torch.float32, device=None):
    """Lorenz-96, dx_i = α(x_{i+1} − x_{i−2}) x_{i−1} − β x_i + γ, with
    strided linear observations y_i = x_{2i}. ``integrator`` is "euler"
    (the reference's step; unstable at dt=0.01 for long noisy runs) or
    "rk4" (stable; used to generate benchmark data)."""
    kw = dict(dtype=dtype, device=device)
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


__all__ = ["linear_gaussian", "bearings_only_tracking", "bot_maneuver_inputs",
           "lorenz96"]
