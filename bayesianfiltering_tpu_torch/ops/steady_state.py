"""Steady-state Kalman filtering and smoothing: past an exact head, the
time recursion with a frozen gain as a few constant-matrix products
(counterpart of ``bayesianfiltering_tpu/ops/steady_state.py``).

For a time-invariant linear-Gaussian SSM the Kalman gain converges to its
Riccati fixed point. Once the gain is frozen, the filtered-mean recursion
``m_t = A m_{t-1} + u_t`` (``A = (I − K∞H) F`` constant) is an affine scan
with a CONSTANT matrix, evaluated in ⌈log2 T⌉ rounds of one
``(T, dx) @ (dx, dx)`` product each (Kogge–Stone doubling: round k adds
``A^{2^k} v[t − 2^k]``). The first ``head`` steps run the exact
time-varying filter of :mod:`~bayesianfiltering_tpu_torch.ops.linear`, so
the transient is exact; past the head the frozen gain differs from the
exact one only by the decaying Riccati residual (``rel_delta`` of
:func:`steady_state_gains`). An approximation with no counterpart in the
reference; the exact tool for a model whose transient outlives
``num_iters`` is :func:`~bayesianfiltering_tpu_torch.ops.associative.parallel_kalman_filter`.

No kernel runs here: the rounds are ``torch.matmul`` (the JAX package
computes them outside any Pallas kernel), the head and the Riccati
iteration Python loops, and the factorizations the library ones.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bayesianfiltering_tpu_torch.ops.linear import (
    ParamsLGSSM,
    PosteriorKalman,
    _biases,
    kalman_filter,
    kalman_smoother,
)
from bayesianfiltering_tpu_torch.utils.linalg import (
    cholesky_nan,
    psd_solve,
    symmetrize,
)

_LOG_2PI = math.log(2.0 * math.pi)


class SteadyStateGains(NamedTuple):
    """Riccati fixed point of the filter and the smoother's companions.
    ``rel_delta`` is ``‖P_k − P_{k−1}‖_F / ‖P_k‖_F`` of the predicted
    covariance at the last iteration: the convergence certificate."""

    predicted_covariance: torch.Tensor   # P∞ (before the update)
    filtered_covariance: torch.Tensor    # (I − KH) P∞
    innovation_covariance: torch.Tensor  # S∞ = H P∞ Hᵀ + R
    gain: torch.Tensor                   # K∞
    closed_loop: torch.Tensor            # A = (I − K∞H) F
    smoother_gain: torch.Tensor          # G∞ = P_f∞ Fᵀ P∞⁻¹
    smoothed_covariance: torch.Tensor    # fixed point of the RTS recursion
    rel_delta: torch.Tensor


def steady_state_gains(params: ParamsLGSSM,
                       num_iters: int = 128) -> SteadyStateGains:
    """Iterate the filter's covariance recursion ``num_iters`` times from
    the model's ``initial_covariance`` (data-independent), then derive every
    steady-state quantity from the fixed point."""
    F, Q = params.dynamics_matrix, params.dynamics_covariance
    H, R = params.emission_matrix, params.emission_covariance

    def ric(P_pred):
        S = symmetrize(H @ P_pred @ H.T + R)
        K = psd_solve(S, H @ P_pred).T
        P_filt = symmetrize(P_pred - K @ S @ K.T)
        return symmetrize(F @ P_filt @ F.T + Q)

    P1 = params.initial_covariance
    for _ in range(num_iters - 1):
        P1 = ric(P1)
    P_pred = ric(P1)
    rel_delta = (torch.linalg.norm(P_pred - P1)
                 / torch.linalg.norm(P_pred).clamp_min(1e-30))

    S = symmetrize(H @ P_pred @ H.T + R)
    K = psd_solve(S, H @ P_pred).T
    P_filt = symmetrize(P_pred - K @ S @ K.T)
    A = F - K @ (H @ F)
    G = psd_solve(P_pred, F @ P_filt).T

    sP = P_filt
    for _ in range(num_iters):
        sP = symmetrize(P_filt + G @ (sP - P_pred) @ G.T)
    return SteadyStateGains(P_pred, P_filt, S, K, A, G, sP, rel_delta)


def _affine_scan_constant(A: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``v_t = A v_{t−1} + u_t`` (``v_{−1} = 0``) with a
    constant matrix, in ⌈log2 T⌉ rounds of one ``(T, dx) @ (dx, dx)``
    product each: round k adds ``A^{2^k} v[t − 2^k]``."""
    T = u.shape[0]
    v = u
    Ak_T = A.T
    offset = 1
    while offset < T:
        v = torch.cat([v[:offset], v[offset:] + v[:-offset] @ Ak_T], dim=0)
        Ak_T = Ak_T @ Ak_T
        offset *= 2
    return v


def _resolve_head(head: int, T: int) -> int:
    if head < 1:
        raise ValueError(f"head must be >= 1, got {head}")
    return min(head, T)


def steady_state_kalman_filter(params: ParamsLGSSM, emissions: torch.Tensor,
                               head: int = 64,
                               num_iters: int = 128) -> PosteriorKalman:
    """Kalman filter of ``emissions`` (T, dy) with the gain frozen at its
    steady state past an exact head.

    The first ``head`` steps run :func:`~bayesianfiltering_tpu_torch.ops.linear.kalman_filter`
    (exact gains, covariances and log-likelihood); from step ``head`` on
    the gain is the ``max(num_iters, head)``-step Riccati fixed point, the
    means come from :func:`_affine_scan_constant` and the covariances are
    the steady-state matrices, broadcast. ``T ≤ head`` is the exact filter.
    """
    T = emissions.shape[0]
    head = _resolve_head(head, T)
    if T <= head:
        return kalman_filter(params, emissions)

    F, H = params.dynamics_matrix, params.emission_matrix
    c, d = _biases(params)
    dy = H.shape[-2]
    ss = steady_state_gains(params, num_iters=max(num_iters, head))

    post_head = kalman_filter(params, emissions[:head])
    m_pred_head = post_head.predicted_means[-1]   # the prediction of `head`

    # tail filtered means: m_t = A m_{t−1} + u_t with
    # u_t = (I − KH) c + K (y_t − d); the first folds in the exact head's
    # last prediction
    K, A = ss.gain, ss.closed_loop
    ys = emissions[head:]
    u = (c - K @ (H @ c)) + (ys - d) @ K.T
    u0 = m_pred_head - K @ (H @ m_pred_head) + K @ (ys[0] - d)
    u = torch.cat([u0[None], u[1:]], dim=0)
    m_filt_tail = _affine_scan_constant(A, u)
    m_pred_tail = m_filt_tail @ F.T + c             # the prediction of t+1

    # tail log-likelihood: innovations against the steady S∞; the
    # prediction of tail step t is m_pred_tail[t−1], m_pred_head at t = head
    pm_prev = torch.cat([m_pred_head[None], m_pred_tail[:-1]], dim=0)
    innov = ys - pm_prev @ H.T - d
    chol = cholesky_nan(ss.innovation_covariance)
    linv = torch.linalg.solve_triangular(
        chol, torch.eye(dy, dtype=chol.dtype, device=chol.device),
        upper=False)
    z = innov @ linv.T
    logdet = 2.0 * torch.log(torch.diagonal(chol)).sum()
    n_tail = T - head
    ll_tail = -0.5 * (n_tail * (dy * _LOG_2PI + logdet) + (z * z).sum())

    def bcast(M):
        return M.expand((n_tail,) + M.shape)

    return PosteriorKalman(
        post_head.marginal_loglik + ll_tail,
        torch.cat([post_head.filtered_means, m_filt_tail], dim=0),
        torch.cat([post_head.filtered_covariances,
                   bcast(ss.filtered_covariance)], dim=0),
        torch.cat([post_head.predicted_means, m_pred_tail], dim=0),
        torch.cat([post_head.predicted_covariances,
                   bcast(ss.predicted_covariance)], dim=0),
    )


def steady_state_kalman_smoother(params: ParamsLGSSM, emissions: torch.Tensor,
                                 head: int = 64,
                                 num_iters: int = 128) -> PosteriorKalman:
    """RTS smoother on top of :func:`steady_state_kalman_filter`.

    Past the head the smoothed-mean deviation ``w_t = s_t − m_f,t`` obeys
    ``w_t = G (w_{t+1} + m_f,t+1 − m_p,t)`` with the constant steady
    smoother gain: the same constant-matrix scan, reversed. Smoothed
    covariances are the steady Stein fixed point in the interior, the
    exact backward recursion over the last ``min(head, T − head − 1)``
    steps and over the head (its time-varying gains). ``T ≤ 2·head`` is
    the exact smoother."""
    T = emissions.shape[0]
    head = _resolve_head(head, T)
    if T <= 2 * head:
        return kalman_smoother(params, emissions)

    F = params.dynamics_matrix
    post = steady_state_kalman_filter(params, emissions, head=head,
                                      num_iters=num_iters)
    ss = steady_state_gains(params, num_iters=max(num_iters, head))
    G = ss.smoother_gain
    fm, pm = post.filtered_means, post.predicted_means
    fP, pP = post.filtered_covariances, post.predicted_covariances

    # backward means over t ≥ head with the frozen G (exact there: the
    # filter's covariances are steady); g_t = G (m_f[t+1] − m_p[t]), the
    # predicted mean at t being the prediction OF t+1
    g = (fm[head + 1:] - pm[head:-1]) @ G.T           # T − head − 1 of them
    w_tail = torch.flip(_affine_scan_constant(G, torch.flip(g, [0])), [0])
    sm_tail = torch.cat([fm[head:-1] + w_tail, fm[-1:]], dim=0)

    # the exact backward pass over the head (time-varying gains), from the
    # tail's smoothed mean and the steady smoothed covariance at t = head
    sm_next, sP_next = sm_tail[0], ss.smoothed_covariance
    sm_head, sP_head = [], []
    for t in range(head - 1, -1, -1):
        Gt = psd_solve(pP[t], F @ fP[t]).T
        sm_next = fm[t] + Gt @ (sm_next - pm[t])
        sP_next = symmetrize(fP[t] + Gt @ (sP_next - pP[t]) @ Gt.T)
        sm_head.append(sm_next)
        sP_head.append(sP_next)

    # the covariance transient at the end: sP_{T−1} = P_f∞, relaxing
    # backward to the Stein fixed point; steady in between
    n_end = min(head, T - head - 1)
    sP, sP_end = ss.filtered_covariance, []
    for _ in range(n_end):
        sP = symmetrize(ss.filtered_covariance
                        + G @ (sP - ss.predicted_covariance) @ G.T)
        sP_end.append(sP)
    n_mid = T - head - n_end - 1
    sP_mid = ss.smoothed_covariance.expand(
        (n_mid,) + ss.smoothed_covariance.shape)
    pieces = [sP_mid] + ([torch.stack(sP_end[::-1])] if n_end else [])
    sP_tail = torch.cat(pieces + [ss.filtered_covariance[None]], dim=0)

    return post._replace(
        smoothed_means=torch.cat([torch.stack(sm_head[::-1]), sm_tail],
                                 dim=0),
        smoothed_covariances=torch.cat([torch.stack(sP_head[::-1]), sP_tail],
                                       dim=0),
    )


__all__ = [
    "SteadyStateGains",
    "steady_state_gains",
    "steady_state_kalman_filter",
    "steady_state_kalman_smoother",
]
