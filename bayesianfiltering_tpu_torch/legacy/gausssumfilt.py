"""Legacy (v0) standalone Gaussian-sum and augmented Gaussian-sum filters
(counterpart of ``bayesianfiltering_tpu/legacy/gausssumfilt.py``).

The EKF-bank :class:`GaussSumFilt` and the original :class:`AugGaussSumFilt`
(M → M·N → M·N·L → M a step) with the string-mode splitting-covariance
selection of ``set_aug_selection_params``: ``prop``, ``opt_lip``,
``opt_max_grad`` (through :func:`sdp_opt_legacy`), ``input`` and ``test``
(through :func:`sdp_opt_test`). The components run as one batch; outputs
are time-major ``(T, M, ...)``.

Randomness: a ``torch.Generator`` or :class:`AugDraws` made beforehand.
Plain PyTorch on the device of the model's tensors, as the JAX package's
are plain XLA.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from bayesianfiltering_tpu_torch.containers import (
    GaussianSum,
    split_gaussian_sum,
)
from bayesianfiltering_tpu_torch.distributions import (
    mvn_logpdf,
    mvn_sample,
    standard_normal,
)
from bayesianfiltering_tpu_torch.legacy.gaussfilt import (
    SSM,
    as_tensor,
    hessian_fn,
    jacobian_fn,
)
from bayesianfiltering_tpu_torch.utils.linalg import (
    project_to_psd,
    psd_solve,
    symmetrize,
)
from bayesianfiltering_tpu_torch.utils.resampling import multinomial_resample
from bayesianfiltering_tpu_torch.utils.sdp import sdp_opt_legacy, sdp_opt_test

# the "test" selection samples this many points whatever the model
_TEST_POINTS = 3

vmap = torch.func.vmap


def _ekf_moments(f, jac, m, P, Q):
    """One batched EKF predict of means (B, dx) under covariances (B, dx,
    dx): ``(f(m), sym(F P Fᵀ + Q), F)``."""
    F = vmap(jac)(m)
    return vmap(f)(m), symmetrize(F @ P @ F.mT + Q), F


def _ekf_update(g, jac, m, P, y, R):
    """One batched EKF update; returns ``(m⁺, P⁺, ll, H)``."""
    H = vmap(jac)(m)
    mu_y = vmap(g)(m)
    Sy = symmetrize(R + H @ P @ H.mT)
    gain = psd_solve(Sy, (P @ H.mT).mT).mT  # P Hᵀ Sy⁻¹
    y = torch.atleast_1d(y)
    m_f = m + (gain @ (y - mu_y)[..., None])[..., 0]
    P_f = symmetrize(P - gain @ Sy @ gain.mT)
    return m_f, P_f, mvn_logpdf(y, mu_y, Sy), H


class GaussSumFilt:
    """Standalone EKF-bank Gaussian-sum filter; the initial means are
    m0 + N(0, I) (``generator`` or ``init_eps`` (M, dx) in ``run``)."""

    def __init__(self, ssm: SSM, M: int):
        self.f = lambda x: torch.atleast_1d(ssm.f(x))
        self.g = lambda x: torch.atleast_1d(ssm.g(x))
        self.Q, self.R = ssm.Q, ssm.R
        self.dx, self.dy = ssm.dx, ssm.dy
        self.M = M
        self.f_jacobian = jacobian_fn(ssm.f, self.dx, self.dx)
        self.g_jacobian = jacobian_fn(ssm.g, self.dy, self.dx)

    def __str__(self):
        return "GSF"

    def run(self, ys, m0, P0, verbose: bool = False,
            generator: Optional[torch.Generator] = None,
            init_eps: Optional[torch.Tensor] = None):
        """Returns ``(means (T, M, dx), covs (T, M, dx, dx), weights (T, M),
        point_est (T, dx))``."""
        dev = self.Q.device
        ys = as_tensor(ys, dev)
        m0, P0 = as_tensor(m0, dev), as_tensor(P0, dev)
        M = self.M
        means = m0 + standard_normal((M, self.dx), m0, generator, init_eps)
        covs = P0.expand(M, self.dx, self.dx)
        w = m0.new_full((M,), 1.0 / M)
        out = []
        for t in range(ys.shape[0]):
            m_p, P_p, _ = _ekf_moments(self.f, self.f_jacobian, means, covs,
                                       self.Q)
            means, covs, lls, _ = _ekf_update(self.g, self.g_jacobian, m_p,
                                              P_p, ys[t], self.R)
            w = w * torch.exp(lls - lls.max())
            w = w / w.sum()
            out.append((means, covs, w, w @ means))
        return tuple(torch.stack(o) for o in zip(*out))


class AugDraws(NamedTuple):
    """The randomness of one :class:`AugGaussSumFilt` run, per step: the
    standard normals of the predict's "test" points ``select1`` (T, M, 3,
    dx), of the first split ``split1`` (T, M, N, dx), of the update's
    "test" points ``select2`` (T, M·N, 3, dx), of the second split
    ``split2`` (T, M·N, L, dx), and the multinomial reduction's uniforms
    ``reduce`` (T, M). ``select1``/``select2`` are read only in "test"
    mode and may be None otherwise."""

    select1: Optional[torch.Tensor]
    split1: torch.Tensor
    select2: Optional[torch.Tensor]
    split2: torch.Tensor
    reduce: torch.Tensor


class AugGaussSumFilt:
    """The original augmented Gaussian-sum filter. Per step: a splitting
    covariance Δ per component by the predict's selection mode, each of M
    components split into N means from N(m, P − Δ) and EKF-predicted with
    Δ; Λ by the update's mode, each of the M·N split into L and
    EKF-updated with Λ; weights by the innovation likelihoods; a
    multinomial reduction M·N·L → M."""

    def __init__(self, ssm: SSM, M: int, N: int, L: int,
                 generator: Optional[torch.Generator] = None):
        self.f = lambda x: torch.atleast_1d(ssm.f(x))
        self.g = lambda x: torch.atleast_1d(ssm.g(x))
        self.Q, self.R = ssm.Q, ssm.R
        self.dx, self.dy = ssm.dx, ssm.dy
        self.M, self.N, self.L = M, N, L
        self.f_jacobian = jacobian_fn(ssm.f, self.dx, self.dx)
        self.f_hessian = hessian_fn(ssm.f, self.dx, self.dx)
        self.g_jacobian = jacobian_fn(ssm.g, self.dy, self.dx)
        self.g_hessian = hessian_fn(ssm.g, self.dy, self.dx)
        self.generator = generator
        self.set = False

    def __str__(self):
        return "AGSF"

    def set_aug_selection_params(self, *args, **selection_mode):
        """Keyword order gives (predict-mode, update-mode); ``args`` carries
        the matching scalar (proportionality constant, Lipschitz constant,
        gradient factor) or an explicit matrix for 'input'."""
        modes = list(selection_mode.values())
        self.pred_mode, self.upd_mode = modes[0], modes[1]
        self.pred_arg = args[0] if len(args) > 0 else 0.1
        self.upd_arg = args[1] if len(args) > 1 else 0.1
        self.set = True

    def _select(self, mode, arg, m, P, hessian, num, max_grad, eps):
        """One splitting covariance per component (m (B, dx), P (B, dx,
        dx)) by the legacy mode table."""
        if mode == "prop":
            return arg * P
        if mode == "input":
            mat = as_tensor(arg, P.device).to(P.dtype).expand(P.shape)
            # clip to the feasible cone: Δ ⪯ P
            return P - project_to_psd(P - mat)
        if mode in ("opt_lip", "opt_max_grad"):
            avg_hessian = vmap(hessian)(m).sum(1)
            lip = arg if mode == "opt_lip" else arg * max_grad
            return sdp_opt_legacy(self.dx, num, lip, P, P, avg_hessian, 10,
                                  0.01)
        if mode == "test":
            sample = mvn_sample(m, P, (_TEST_POINTS,), eps=eps.transpose(0, 1))
            hess = vmap(vmap(hessian))(sample.transpose(0, 1))
            return sdp_opt_test(self.dx, hess.shape[-3], _TEST_POINTS, 0.1, P,
                                P, hess, 10, 0.1)
        raise ValueError(f"unknown selection mode {mode!r}")

    def _draws(self, like, need_select):
        M, N, L, dx = self.M, self.N, self.L, self.dx
        normal = lambda *shape: standard_normal(shape, like, self.generator)
        return AugDraws(
            normal(M, _TEST_POINTS, dx) if need_select[0] else None,
            normal(M, N, dx),
            normal(M * N, _TEST_POINTS, dx) if need_select[1] else None,
            normal(M * N, L, dx),
            torch.rand((M,), generator=self.generator, dtype=like.dtype,
                       device=like.device))

    def run(self, ys, m0, P0, verbose: bool = False,
            draws: Optional[AugDraws] = None):
        """Returns ``(means (T, M, dx), covs (T, M, dx, dx), point_est (T,
        dx), Deltas (T, M, dx, dx), Lambdas (T, M·N, dx, dx))``."""
        if not self.set:
            self.set_aug_selection_params(0.1, 0.1, mode1="prop", mode2="prop")
        dev = self.Q.device
        ys = as_tensor(ys, dev)
        m0, P0 = as_tensor(m0, dev), as_tensor(P0, dev)
        M, N, L, dx = self.M, self.N, self.L, self.dx
        need_select = (self.pred_mode == "test", self.upd_mode == "test")
        if draws is None and self.generator is None:
            raise ValueError("pass a torch.Generator or the draws made "
                             "beforehand")

        means = m0.expand(M, dx)
        covs = P0.expand(M, dx, dx)
        w = m0.new_full((M,), 1.0 / M)
        max_grad_p = max_grad_u = 1.0
        out = []
        for t in range(ys.shape[0]):
            d = (self._draws(m0, need_select) if draws is None else
                 AugDraws(*(None if x is None else x[t] for x in draws)))
            deltas = self._select(self.pred_mode, self.pred_arg, means, covs,
                                  self.f_hessian, N, max_grad_p, d.select1)
            branched = split_gaussian_sum(GaussianSum(means, covs, w),
                                          deltas, N, eps=d.split1)
            pm, pP, F = _ekf_moments(self.f, self.f_jacobian, branched.means,
                                     branched.covariances, self.Q)
            lambdas = self._select(self.upd_mode, self.upd_arg, pm, pP,
                                   self.g_hessian, L, max_grad_u, d.select2)
            branched2 = split_gaussian_sum(
                GaussianSum(pm, pP, branched.weights), lambdas, L,
                eps=d.split2)
            um, uP, lls, H = _ekf_update(self.g, self.g_jacobian,
                                         branched2.means,
                                         branched2.covariances, ys[t], self.R)
            new_w = branched2.weights * torch.exp(lls - lls.max())
            new_w = new_w / new_w.sum()
            idx = multinomial_resample(new_w, M, u=d.reduce)
            means, covs = um[idx], uP[idx]
            w = m0.new_full((M,), 1.0 / M)
            max_grad_p = F.abs().amax(dim=(-2, -1)).max()
            max_grad_u = H.abs().amax(dim=(-2, -1)).max()
            out.append((means, covs, means.mean(0), deltas, lambdas))
        return tuple(torch.stack(o) for o in zip(*out))


__all__ = ["GaussSumFilt", "AugGaussSumFilt", "AugDraws"]
