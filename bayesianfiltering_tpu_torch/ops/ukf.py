"""Unscented-transform step primitives, additive and non-additive noise
(counterpart of ``bayesianfiltering_tpu/ops/ukf.py``).

The weights are the textbook UT's: ``W₀ᵐ = λ/(n+λ)``, ``Wᵢᵐ = 1/(2(n+λ))``,
``W₀ᶜ = W₀ᵐ + 1 − α² + β``, with the center point handled analytically
(:func:`ut_weights`; ``ops.fused_ut`` builds its kernels' plain versions
on the same weight and moment helpers). As in the JAX package, the additive predict's center term is an outer
product (the reference computes a scalar there by mistake).

Every function takes a leading batch axis: ``m`` (B, dx), ``P``
(B, dx, dx). The model callables act on one state; they are evaluated over
the sigma points with ``torch.func.vmap``. These are the plain versions of
the UT kernels K6–K9 (``ops.fused_ut``); the iterated posterior-
linearization update (``num_iter > 1``) has no kernel and runs here.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

from bayesianfiltering_tpu_torch.ops.ekf import _REL_JITTER, _residual
from bayesianfiltering_tpu_torch.utils.linalg import (
    cholesky_nan,
    psd_solve,
    symmetrize,
)
from bayesianfiltering_tpu_torch.utils.sigma_points import (
    factor,
    points_blockdiag,
    points_from_factor,
)

_LOG_2PI = math.log(2.0 * math.pi)


class ParamsUKF(NamedTuple):
    """Unscented-transform parameters. ``sqrt_method`` picks the
    sigma-point factor: "sqrtm" (Newton–Schulz PSD square root) or
    "cholesky"."""

    alpha: float = 1e-3
    beta: float = 2.0
    kappa: float = 0.0
    sqrt_method: str = "sqrtm"


def ut_weights(n_aug: int, uparams: ParamsUKF):
    """``(scale, (w_side, w0m, w0c))``: the sigma-point scale √(n+λ), the
    weight of each of the 2n points, and the center's mean and covariance
    weights."""
    alpha = float(uparams.alpha)
    lamda = alpha ** 2 * (n_aug + float(uparams.kappa)) - n_aug
    w_side = 1.0 / (2.0 * (lamda + n_aug))
    w0m = lamda / (lamda + n_aug)
    w0c = w0m + 1.0 - alpha ** 2 + float(uparams.beta)
    return math.sqrt(n_aug + lamda), (w_side, w0m, w0c)


def eval_rows(fn: Callable, x: torch.Tensor, noise, u) -> torch.Tensor:
    """``fn(x_i, noise, u)`` for every row of ``x`` (..., n), the noise
    shared; returns (..., d_out)."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    out = torch.func.vmap(fn, in_dims=(0, None, None))(flat, noise, u)
    return out.reshape(lead + (-1,))


def eval_aug_rows(fn: Callable, xa: torch.Tensor, dx: int, u) -> torch.Tensor:
    """``fn(x, noise, u)`` for every augmented row ``[x; noise]`` of ``xa``
    (..., dx + dn); returns (..., d_out). The two parts are made contiguous
    first: on CUDA, a strided x turns a model's ``x @ Hᵀ`` into a batched
    matrix-vector product per row."""
    lead = xa.shape[:-1]
    flat = xa.reshape(-1, xa.shape[-1])
    out = torch.func.vmap(fn, in_dims=(0, 0, None))(
        flat[:, :dx].contiguous(), flat[:, dx:].contiguous(), u)
    return out.reshape(lead + (-1,))


def eval_step_rows(fn: Callable, x: torch.Tensor, noise, u) -> torch.Tensor:
    """``fn(x_ij, noise_i, u_i)`` for every row j of step i: ``x``
    (n, k, dx), ``noise`` and ``u`` with the same leading step axis;
    returns (n, k, d_out). The smoothers' quadratures take a model input
    per step."""
    rows = torch.func.vmap(fn, in_dims=(0, None, None))
    return torch.func.vmap(rows, in_dims=(0, 0, 0))(x, noise, u)


def eval_step_aug_rows(fn: Callable, xa: torch.Tensor, dx: int,
                       u) -> torch.Tensor:
    """``fn(x, noise, u_i)`` for every augmented row ``[x; noise]`` of step
    i of ``xa`` (n, k, dx + dn), the two parts made contiguous first (see
    :func:`eval_aug_rows`); returns (n, k, d_out)."""
    rows = torch.func.vmap(fn, in_dims=(0, 0, None))
    return torch.func.vmap(rows, in_dims=(0, 0, 0))(
        xa[..., :dx].contiguous(), xa[..., dx:].contiguous(), u)


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., :, None] * b[..., None, :]


def ut_mean(center_out, pts_out, w_side, w0m):
    """Weighted mean of the transformed points (..., 2n, d) and the
    transformed center (..., d)."""
    return w_side * pts_out.sum(-2) + w0m * center_out


def ut_cov(center_out, pts_out, mu, w_side, w0c):
    """Weighted covariance of the transformed points and center about
    ``mu``, and the centred points."""
    centered = pts_out - mu[..., None, :]
    d0 = center_out - mu
    cov = w_side * (centered.mT @ centered) + w0c * _outer(d0, d0)
    return cov, centered


def ut_cross(centered, pts, m, w_side):
    """(d, dx) cross-covariance of the centred transformed points with the
    state part (first dx columns) of the sigma points ``pts``."""
    dx = m.shape[-1]
    return w_side * (centered.mT @ (pts[..., :dx] - m[..., None, :]))


def _ut_moments(center_out, pts_out, weights):
    """Mean and covariance of the transformed points (..., 2n, d) and the
    transformed center (..., d) under ``weights = (w_side, w0m, w0c)``;
    also the centred points."""
    w_side, w0m, w0c = weights
    mu = ut_mean(center_out, pts_out, w_side, w0m)
    cov, centered = ut_cov(center_out, pts_out, mu, w_side, w0c)
    return mu, cov, centered


def _augment(m, P, bias, noise_cov):
    """The augmented Gaussian ``[m; bias]``, ``blkdiag(P, noise_cov)``,
    batched over ``m`` and ``P``."""
    dx, dn = m.shape[-1], bias.shape[-1]
    batch = m.shape[:-1]
    mA = torch.cat([m, bias.expand(batch + (dn,))], dim=-1)
    PA = P.new_zeros(batch + (dx + dn, dx + dn))
    PA[..., :dx, :dx] = P
    PA[..., dx:, dx:] = noise_cov
    return mA, PA


def ukf_predict_additive(m, P, f: Callable, u, Q, uparams: ParamsUKF, q0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """UT predict, additive noise (evaluated at the zero noise point)."""
    dx = m.shape[-1]
    q0 = m.new_zeros(dx)
    scale, weights = ut_weights(dx, uparams)
    pts = points_from_factor(m, factor(P, uparams.sqrt_method), scale)
    new_pts = eval_rows(f, pts, q0, u)
    center = eval_rows(f, m, q0, u)
    mu, cov, _ = _ut_moments(center, new_pts, weights)
    return mu, symmetrize(cov + Q)


def ukf_predict_nonadditive(m, P, f: Callable, u, Q, uparams: ParamsUKF, q0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """UT predict, non-additive noise via state-noise augmentation."""
    dx = m.shape[-1]
    scale, weights = ut_weights(dx + q0.shape[-1], uparams)
    pts = points_blockdiag(m, P, q0, Q, scale, uparams.sqrt_method)
    new_pts = eval_aug_rows(f, pts, dx, u)
    center = eval_rows(f, m, q0, u)
    mu, cov, _ = _ut_moments(center, new_pts, weights)
    return mu, symmetrize(cov)


def ukf_gain_update(m, P, S, C, innov):
    """The shared Cholesky gain and likelihood on a given innovation:
    K = (S⁻¹C)ᵀ after the relative floor 1e-6·max|diag S|, the grouped
    Joseph form ``P − KC − (KC)ᵀ + (KL)(KL)ᵀ``, μ = m + K·innov and
    log N(innov | 0, S). Returns ``(ll, mean, cov)``; a non-PD S gives
    NaN."""
    dy = S.shape[-1]
    eye = torch.eye(dy, dtype=S.dtype, device=S.device)
    floor = _REL_JITTER * torch.diagonal(S, dim1=-2, dim2=-1).abs().amax(-1)
    S = S + floor[..., None, None] * eye
    chol = cholesky_nan(S)
    linv = torch.linalg.solve_triangular(chol, eye.expand(S.shape),
                                         upper=False)
    K = (linv.mT @ (linv @ C)).mT
    KC = K @ C
    KL = K @ chol
    cov = symmetrize(P - KC - KC.mT + KL @ KL.mT)
    mean = m + (K @ innov[..., None])[..., 0]
    z = (linv @ innov[..., None])[..., 0]
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    ll = -0.5 * (dy * _LOG_2PI + logdet + (z ** 2).sum(-1))
    return ll, mean, cov


def _ukf_gain_update(m, P, mu_y, S, C, y, residual_fn=None):
    """:func:`ukf_gain_update` on the innovation ``y ⊖ μy``."""
    return ukf_gain_update(m, P, S, C, _residual(y, mu_y, residual_fn))


def ukf_condition_on_additive(m, P, h: Callable, R, u, y,
                              uparams: ParamsUKF, r0=None, residual_fn=None):
    """UT measurement update, additive noise. Returns ``(ll, mean, cov)``."""
    dx = m.shape[-1]
    y = torch.atleast_1d(y)
    r0 = m.new_zeros(y.shape[-1])
    scale, weights = ut_weights(dx, uparams)
    pts = points_from_factor(m, factor(P, uparams.sqrt_method), scale)
    new_pts = eval_rows(h, pts, r0, u)
    center = eval_rows(h, m, r0, u)
    mu_y, S, centered = _ut_moments(center, new_pts, weights)
    S = symmetrize(S + R)
    C = ut_cross(centered, pts, m, weights[0])
    return _ukf_gain_update(m, P, mu_y, S, C, y, residual_fn)


def _ut_emission_moments(m, P, h: Callable, R, u, uparams: ParamsUKF, r0):
    """UT moments of the emission at (m, P), non-additive noise: ``(μy, S,
    C)`` with C the (dy, dx) cross-covariance."""
    dx = m.shape[-1]
    scale, weights = ut_weights(dx + r0.shape[-1], uparams)
    pts = points_blockdiag(m, P, r0, R, scale, uparams.sqrt_method)
    new_pts = eval_aug_rows(h, pts, dx, u)
    center = eval_rows(h, m, r0, u)
    mu_y, S, centered = _ut_moments(center, new_pts, weights)
    C = ut_cross(centered, pts, m, weights[0])
    return mu_y, symmetrize(S), C


def ukf_condition_on_nonadditive(m, P, h: Callable, R, u, y,
                                 uparams: ParamsUKF, r0=None,
                                 residual_fn=None):
    """UT measurement update, non-additive noise via augmentation. Returns
    ``(ll, mean, cov)``."""
    y = torch.atleast_1d(y)
    mu_y, S, C = _ut_emission_moments(m, P, h, R, u, uparams, r0)
    return _ukf_gain_update(m, P, mu_y, S, C, y, residual_fn)


def ukf_condition_on_nonadditive_iterated(m, P, h: Callable, R, u, y,
                                          uparams: ParamsUKF, r0,
                                          num_iter: int = 1,
                                          residual_fn=None):
    """Iterated posterior-linearization UKF update (IPLF). ``num_iter=1`` is
    :func:`ukf_condition_on_nonadditive`; each further iteration
    statistically linearizes the emission around the current posterior
    ``(m_i, P_i)`` — ``H = C P_i⁻¹``, residual ``Ω = S − H P_i Hᵀ`` — and
    re-runs the Kalman update of the prior ``(m, P)``. Returns
    ``(ll, mean, cov)``."""
    num_iter = int(num_iter)
    if num_iter <= 1:
        return ukf_condition_on_nonadditive(m, P, h, R, u, y, uparams, r0,
                                            residual_fn)
    y = torch.atleast_1d(y)
    dx = m.shape[-1]
    eye = torch.eye(dx, dtype=P.dtype, device=P.device)
    m_i, P_i, ll = m, P, None
    for _ in range(num_iter):
        mu_y, S_i, C = _ut_emission_moments(m_i, P_i, h, R, u, uparams, r0)
        H = psd_solve(P_i, C.mT).mT                         # (B, dy, dx)
        omega = symmetrize(S_i - H @ P_i @ H.mT)
        S = symmetrize(H @ P @ H.mT + omega)
        dy = S.shape[-1]
        eye_y = torch.eye(dy, dtype=S.dtype, device=S.device)
        floor = 1e-6 * torch.diagonal(S, dim1=-2, dim2=-1).abs().amax(-1)
        S = S + floor[..., None, None] * eye_y
        chol = cholesky_nan(S)
        linv = torch.linalg.solve_triangular(chol, eye_y.expand(S.shape),
                                             upper=False)
        K = (linv.mT @ (linv @ (H @ P))).mT
        innov = _residual(y, mu_y + (H @ (m - m_i)[..., None])[..., 0],
                          residual_fn)
        m_new = m + (K @ innov[..., None])[..., 0]
        A = eye - K @ H
        P_new = symmetrize(A @ P @ A.mT + K @ omega @ K.mT)
        z = (linv @ innov[..., None])[..., 0]
        logdet = 2.0 * torch.log(
            torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
        ll = -0.5 * (dy * _LOG_2PI + logdet + (z ** 2).sum(-1))
        m_i, P_i = m_new, P_new
    return ll, m_i, P_i


__all__ = [
    "ParamsUKF",
    "eval_rows",
    "eval_aug_rows",
    "eval_step_rows",
    "eval_step_aug_rows",
    "ut_weights",
    "ut_mean",
    "ut_cov",
    "ut_cross",
    "ukf_gain_update",
    "ukf_predict_additive",
    "ukf_predict_nonadditive",
    "ukf_condition_on_additive",
    "ukf_condition_on_nonadditive",
    "ukf_condition_on_nonadditive_iterated",
]
