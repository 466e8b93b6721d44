"""Closed-form linear-Gaussian Kalman filtering and RTS smoothing
(counterpart of ``bayesianfiltering_tpu/ops/linear.py``).

The sequential filter and smoother: a Python loop over time, one small
update and predict per step, with ``torch.linalg.cholesky_ex`` and
``solve_triangular`` where the JAX package uses its blocked factorizations.
They are the exactness oracle of the temporally parallel versions in
:mod:`~bayesianfiltering_tpu_torch.ops.associative` and run no kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from bayesianfiltering_tpu_torch.utils.linalg import (
    cholesky_nan,
    psd_solve,
    symmetrize,
)

_LOG_2PI = math.log(2.0 * math.pi)


class ParamsLGSSM(NamedTuple):
    """Time-invariant linear-Gaussian SSM:
    ``x_t = F x_{t-1} + c + q``, ``y_t = H x_t + d + r``."""

    initial_mean: torch.Tensor
    initial_covariance: torch.Tensor
    dynamics_matrix: torch.Tensor
    dynamics_covariance: torch.Tensor
    emission_matrix: torch.Tensor
    emission_covariance: torch.Tensor
    dynamics_bias: Optional[torch.Tensor] = None
    emission_bias: Optional[torch.Tensor] = None


class PosteriorKalman(NamedTuple):
    marginal_loglik: torch.Tensor
    filtered_means: torch.Tensor
    filtered_covariances: torch.Tensor
    predicted_means: torch.Tensor
    predicted_covariances: torch.Tensor
    smoothed_means: Optional[torch.Tensor] = None
    smoothed_covariances: Optional[torch.Tensor] = None


def _biases(params: ParamsLGSSM):
    F, H = params.dynamics_matrix, params.emission_matrix
    c, d = params.dynamics_bias, params.emission_bias
    c = F.new_zeros(F.shape[-1]) if c is None else c
    d = F.new_zeros(H.shape[-2]) if d is None else d
    return c, d


def kalman_filter(params: ParamsLGSSM, emissions: torch.Tensor) -> PosteriorKalman:
    """Standard Kalman filter over ``emissions`` of shape (T, dy).

    The first observation updates the prior (no propagation before t=0),
    then predict follows update, as in the JAX package.
    """
    F, Q = params.dynamics_matrix, params.dynamics_covariance
    H, R = params.emission_matrix, params.emission_covariance
    c, d = _biases(params)
    dy = H.shape[-2]
    m, P = params.initial_mean, params.initial_covariance
    ll = emissions.new_zeros(())
    fm, fP, pm, pP = [], [], [], []
    for y in emissions:
        # update
        S = symmetrize(H @ P @ H.T + R)
        chol = cholesky_nan(S)
        linv = torch.linalg.solve_triangular(
            chol, torch.eye(dy, dtype=S.dtype, device=S.device), upper=False)
        K = (linv.T @ (linv @ (H @ P))).T
        innov = y - (H @ m + d)
        m = m + K @ innov
        P = symmetrize(P - K @ S @ K.T)
        z = linv @ innov
        logdet = 2.0 * torch.log(torch.diagonal(chol)).sum()
        ll = ll - 0.5 * (dy * _LOG_2PI + logdet + (z * z).sum())
        fm.append(m)
        fP.append(P)
        # predict
        m = F @ m + c
        P = symmetrize(F @ P @ F.T + Q)
        pm.append(m)
        pP.append(P)
    return PosteriorKalman(ll, torch.stack(fm), torch.stack(fP),
                           torch.stack(pm), torch.stack(pP))


def kalman_smoother(params: ParamsLGSSM, emissions: torch.Tensor) -> PosteriorKalman:
    """Rauch–Tung–Striebel smoother built on :func:`kalman_filter`."""
    post = kalman_filter(params, emissions)
    F = params.dynamics_matrix
    fm, fP = post.filtered_means, post.filtered_covariances
    pm, pP = post.predicted_means, post.predicted_covariances
    sm, sP = [fm[-1]], [fP[-1]]
    # predicted entries at index t belong to the t -> t+1 transition
    for t in range(len(fm) - 2, -1, -1):
        G = psd_solve(pP[t], F @ fP[t]).T              # P_f Fᵀ P_p⁻¹
        sm.append(fm[t] + G @ (sm[-1] - pm[t]))
        sP.append(symmetrize(fP[t] + G @ (sP[-1] - pP[t]) @ G.T))
    return post._replace(smoothed_means=torch.stack(sm[::-1]),
                         smoothed_covariances=torch.stack(sP[::-1]))


__all__ = ["ParamsLGSSM", "PosteriorKalman", "kalman_filter", "kalman_smoother"]
