"""Oldest-generation ALA API
(counterpart of ``bayesianfiltering_tpu/legacy/ala.py``):

    ssm = StateSpaceModel(dx, dy, f, g)
    states, obs = ssm.simulate(T, x0, params)
    means, covs = ssm.extended_kalman_filter(ys, jacob_dyn, jacob_obs, params, init)
    means, covs = ssm.latent_ekf(ys, num_comp, latent_cov, jacob_dyn, jacob_obs, params, init)
    means, covs = ssm.unscented_kalman_filter(ys, init, params, kappa, beta, alpha)

``latent_ekf`` is the original "latent EKF", the ALA precursor of the AGSF:
each step draws ``num_comp`` linearization points from the deflated prior
N(m, P − Λ), runs an EKF update at each with covariance Λ and moment-matches
the mixture back to one Gaussian. ``f``/``g`` are the deterministic maps;
the noise covariances come from ``params``.

The JAX package computes in float32 throughout; so does this class unless
it is given another ``dtype``. Randomness: a ``torch.Generator`` or the
standard normals drawn beforehand (``simulate``'s ``draws``,
``latent_ekf``'s ``eps`` (T, num_comp, dx)). Tensors are made on
``device``, or where the inputs are, or on the card.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from bayesianfiltering_tpu_torch.config import resolve_device
from bayesianfiltering_tpu_torch.distributions import (
    mvn_logpdf,
    mvn_sample,
    standard_normal,
)
from bayesianfiltering_tpu_torch.legacy.gaussfilt import SimulateDraws
from bayesianfiltering_tpu_torch.utils.linalg import (
    cholesky_guarded,
    psd_solve,
    symmetrize,
)
from bayesianfiltering_tpu_torch.utils.metrics import collapse
from bayesianfiltering_tpu_torch.utils.sigma_points import split_to_sigma_points


class LinearModelParameters(NamedTuple):
    """(A, H, Q, R) noise/linear parameters."""

    A: object
    H: object
    Q: object
    R: object


class StateSpaceModel:
    def __init__(self, dx: int, dy: int, f: Callable, g: Callable,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        self.dx = dx
        self.dy = dy
        self.dtype = dtype
        self.device = device
        self.f = lambda x: torch.atleast_1d(self._t(f(x), x))
        self.g = lambda x: torch.atleast_1d(self._t(g(x), x))
        self.generator = generator

    def _t(self, x, like=None) -> torch.Tensor:
        """``x`` in the model's dtype, on its device (else ``like``'s, else
        ``x``'s if a tensor, else the card's)."""
        if self.device is not None:
            dev = torch.device(self.device)
        elif isinstance(like, torch.Tensor):
            dev = like.device
        elif isinstance(x, torch.Tensor):
            dev = x.device
        else:
            dev = resolve_device(None)
        return torch.as_tensor(x, dtype=self.dtype, device=dev)

    def _cov(self, x, d: int, like) -> torch.Tensor:
        x = self._t(x, like)
        if x.ndim == 0:
            return x.clamp_min(1e-12) * torch.eye(d, dtype=x.dtype,
                                                  device=x.device)
        return x

    def _jac(self, jac: Callable, out_dim: int, in_dim: int):
        return lambda x: self._t(jac(x), x).reshape(out_dim, in_dim)

    def simulate(self, T: int, x0, params: LinearModelParameters = None,
                 Q=None, R=None, draws: Optional[SimulateDraws] = None):
        """Roll out T steps; noise covariances from ``params`` or Q/R;
        ``draws`` the standard normals ((T, dx), (T, dy))."""
        x = self._t(x0)
        Q = self._cov(params.Q if Q is None else Q, self.dx, x)
        R = self._cov(params.R if R is None else R, self.dy, x)
        zx, zy = x.new_zeros(self.dx), x.new_zeros(self.dy)
        xs, ys = [], []
        for t in range(T):
            ex, ey = (None, None) if draws is None else (draws.state[t],
                                                         draws.emission[t])
            x = self.f(x) + mvn_sample(zx, Q, (), self.generator, ex)
            y = self.g(x) + mvn_sample(zy, R, (), self.generator, ey)
            xs.append(x)
            ys.append(y)
        return torch.stack(xs), torch.stack(ys)

    def _setup(self, ys, params, init):
        m0 = self._t(init[0])
        P0 = self._t(init[1], m0)
        ys = self._t(ys, m0)
        Q = self._cov(params.Q, self.dx, m0)
        R = self._cov(params.R, self.dy, m0)
        return ys, m0, P0, Q, R

    def extended_kalman_filter(self, ys, jacob_dyn, jacob_obs,
                               params: LinearModelParameters, init: Sequence):
        """Plain EKF over (f, g) with the caller's Jacobians. Returns
        (means, covs)."""
        ys, m, P, Q, R = self._setup(ys, params, init)
        Fj = self._jac(jacob_dyn, self.dx, self.dx)
        Hj = self._jac(jacob_obs, self.dy, self.dx)
        means, covs = [], []
        for t in range(ys.shape[0]):
            F = Fj(m)
            m_pred = self.f(m)
            P_pred = symmetrize(F @ P @ F.T + Q)
            H = Hj(m_pred)
            S = symmetrize(H @ P_pred @ H.T + R)
            K = psd_solve(S, H @ P_pred).T
            m = m_pred + K @ (torch.atleast_1d(ys[t]) - self.g(m_pred))
            P = symmetrize(P_pred - K @ S @ K.T)
            means.append(m)
            covs.append(P)
        return torch.stack(means), torch.stack(covs)

    def latent_ekf(self, ys, num_comp: int, latent_cov, jacob_dyn, jacob_obs,
                   params: LinearModelParameters, init: Sequence,
                   generator: Optional[torch.Generator] = None, eps=None):
        """The latent EKF: predict through the dynamics, draw ``num_comp``
        points from N(m⁻, P⁻ − Λ) (``eps`` (T, num_comp, dx), else from
        ``generator`` or the model's), EKF-update each with prior
        covariance Λ, weigh by the innovation likelihoods, collapse to one
        Gaussian. Returns (means, covs)."""
        gen = self.generator if generator is None else generator
        ys, m, P, Q, R = self._setup(ys, params, init)
        Lam = self._cov(latent_cov, self.dx, m)
        Fj = self._jac(jacob_dyn, self.dx, self.dx)
        Hj = self._jac(jacob_obs, self.dy, self.dx)
        g = torch.func.vmap(self.g)
        means, covs = [], []
        for t in range(ys.shape[0]):
            y = torch.atleast_1d(ys[t])
            F = Fj(m)
            m_pred = self.f(m)
            P_pred = symmetrize(F @ P @ F.T + Q)
            chol = cholesky_guarded(P_pred - Lam)
            e = standard_normal((num_comp, self.dx), m, gen,
                                None if eps is None else eps[t])
            latents = m_pred + e @ chol.T
            H = torch.func.vmap(Hj)(latents)
            S = symmetrize(H @ Lam @ H.mT + R)
            K = psd_solve(S, H @ Lam).mT
            gx = g(latents)
            mean = latents + (K @ (y - gx)[..., None])[..., 0]
            cov = symmetrize(Lam - K @ S @ K.mT)
            lls = mvn_logpdf(y, gx, S)
            w = torch.exp(lls - lls.max())
            w = w / w.sum()
            m, P_new = collapse(mean, cov, w)
            P = symmetrize(P_new)
            means.append(m)
            covs.append(P_new)
        return torch.stack(means), torch.stack(covs)

    def unscented_kalman_filter(self, ys, init: Sequence,
                                params: LinearModelParameters,
                                kappa: float, beta: float, alpha: float):
        """The legacy-signature UKF. Returns (means, covs)."""
        ys, m, P, Q, R = self._setup(ys, params, init)
        n = self.dx
        lam = alpha ** 2 * (n + kappa) - n
        w0m = lam / (n + lam)
        wim = 1.0 / (2.0 * (n + lam))
        w0c = w0m + 1.0 - alpha ** 2 + beta

        def moments(m, P, func, cov):
            pts = split_to_sigma_points(m, P, lam)
            new = torch.func.vmap(func)(pts)
            mu = w0m * new[0] + wim * new[1:].sum(0)
            d0 = new[0] - mu
            di = new[1:] - mu
            S = cov + w0c * torch.outer(d0, d0) + wim * di.T @ di
            s0 = pts[0] - m
            si = pts[1:] - m
            C = w0c * torch.outer(s0, d0) + wim * si.T @ di
            return mu, symmetrize(S), C

        means, covs = [], []
        for t in range(ys.shape[0]):
            m_pred, P_pred, _ = moments(m, P, self.f, Q)
            mu_y, S, C = moments(m_pred, P_pred, self.g, R)
            K = psd_solve(S, C.T).T
            m = m_pred + K @ (torch.atleast_1d(ys[t]) - mu_y)
            P = symmetrize(P_pred - K @ S @ K.T)
            means.append(m)
            covs.append(P)
        return torch.stack(means), torch.stack(covs)


__all__ = ["StateSpaceModel", "LinearModelParameters"]
