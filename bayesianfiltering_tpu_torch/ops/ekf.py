"""Extended-Kalman-filter step primitives, non-additive noise
(counterpart of ``bayesianfiltering_tpu/ops/ekf.py``).

predict:   μ⁺ = f(m, q₀, u),  Σ⁺ = F_x P F_xᵀ + F_q Q F_qᵀ
condition: S = H_r R H_rᵀ + H_x P H_xᵀ,  K = (S⁻¹ H_x P)ᵀ,
           Σ = (I − K H_x) P (I − K H_x)ᵀ + K H_r R H_rᵀ Kᵀ (Joseph form),
           μ = m + K (y ⊖ h(m, r₀, u)),  ll = log N(y ⊖ h | 0, S)

Every function here takes a leading batch axis: ``m`` (B, dx), ``P``
(B, dx, dx). The model callables act on one state; they are evaluated over
the batch with ``torch.func.vmap``. :func:`chol_update_precomputed` is the
one update implementation — the plain twin of the update kernels (K1, K3)
and their backward pass.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

from bayesianfiltering_tpu_torch.utils.linalg import cholesky_nan, symmetrize

_LOG_2PI = math.log(2.0 * math.pi)

# Relative floor on the innovation-covariance diagonal, a few ULPs of the
# largest diagonal entry: keeps the Cholesky alive when rounding drives a
# collapsed S slightly indefinite. The kernels use the same constant.
_REL_JITTER = 1e-6


class EKFUpdate(NamedTuple):
    log_likelihood: torch.Tensor  # (B,)
    mean: torch.Tensor            # (B, dx)
    cov: torch.Tensor             # (B, dx, dx)
    jacobian: torch.Tensor        # (B, dy, dx), H_x at the linearization
    gain: torch.Tensor            # (B, dx, dy)


def batched(fn: Callable) -> Callable:
    """Evaluate a per-state model callable ``fn(x, noise, u)`` over a
    leading batch axis of ``x``."""
    return torch.func.vmap(fn, in_dims=(0, None, None))


def chol_update_precomputed(m, P, Hx, Rt, innov, jitter=0.0):
    """Joseph-form Cholesky measurement update on precomputed
    linearizations, batched over leading dimensions. Returns
    ``(ll, mean, cov, gain)``; a non-PD S gives NaN."""
    dy, dx = innov.shape[-1], P.shape[-1]
    S = symmetrize(Rt + Hx @ P @ Hx.mT)
    floor = _REL_JITTER * torch.diagonal(S, dim1=-2, dim2=-1).abs().amax(-1)
    eye_y = torch.eye(dy, dtype=S.dtype, device=S.device)
    S = S + (jitter + floor)[..., None, None] * eye_y
    chol = cholesky_nan(S)
    hp = Hx @ P
    W = torch.linalg.solve_triangular(
        chol.mT, torch.linalg.solve_triangular(chol, hp, upper=False),
        upper=True)                                   # S⁻¹ H P = Kᵀ
    K = W.mT
    A = torch.eye(dx, dtype=P.dtype, device=P.device) - K @ Hx
    cov = symmetrize(A @ P @ A.mT + K @ Rt @ K.mT)
    mean = m + (K @ innov[..., None])[..., 0]
    z = torch.linalg.solve_triangular(chol, innov[..., None], upper=False)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    ll = -0.5 * (dy * _LOG_2PI + logdet + (z[..., 0] ** 2).sum(-1))
    return ll, mean, cov, K


def predict_cov_precomputed(Fx, P, Fq, Q):
    """Σ⁺ = sym(F_x P F_xᵀ + F_q Q F_qᵀ), batched; the plain twin of the
    predict kernels (K2, K4)."""
    return symmetrize(Fx @ P @ Fx.mT + Fq @ Q @ Fq.mT)


def _residual(y, yhat, residual_fn=None):
    """Innovation ``y ⊖ ŷ``: plain subtraction unless the model supplies a
    residual (e.g. wrapped bearings)."""
    y, yhat = torch.atleast_1d(y), torch.atleast_1d(yhat)
    return y - yhat if residual_fn is None else residual_fn(y, yhat)


def _degenerate_update(m, P, y) -> EKFUpdate:
    """num_iter=0: the prior passes through unchanged."""
    B, dx = m.shape
    dy = y.shape[-1]
    return EKFUpdate(m.new_zeros(B), m, P, P.new_zeros(B, dy, dx),
                     P.new_zeros(B, dx, dy))


def ekf_condition_on_iterated(m, P, h, H_x, H_r, R, r0, u, y, num_iter=1,
                              jitter=0.0, residual_fn=None,
                              update: Callable = chol_update_precomputed
                              ) -> EKFUpdate:
    """(Iterated) EKF measurement update over a batch, relinearizing
    ``num_iter`` times around the current posterior mean. ``y`` is (B, dy)
    or (dy,) shared by the batch. The linear algebra is
    ``update(m, P, Hx, Rt, innov, jitter)`` — the plain twin here, a kernel
    wrapper in ``ops.fused_ekf`` and ``ops.bank_update``. The likelihood,
    gain and Jacobian reported are those of the last linearization."""
    y = torch.atleast_1d(y)
    if int(num_iter) <= 0:
        return _degenerate_update(m, P, y)
    B, dx = m.shape
    lin, out = m, None
    for it in range(int(num_iter)):
        Hx = batched(H_x)(lin, r0, u).reshape(B, -1, dx)
        Hr = batched(H_r)(lin, r0, u).reshape(B, Hx.shape[1], -1)
        yhat = batched(h)(lin, r0, u).reshape(B, -1)
        if it > 0:
            # IEKF correction for the shift between linearization point
            # and prior mean (zero at the first iteration)
            yhat = yhat + (Hx @ (m - lin)[..., None])[..., 0]
        Rt = Hr @ R @ Hr.mT
        innov = _residual(y, yhat, residual_fn)
        ll, mean, cov, K = update(m, P, Hx, Rt, innov, jitter)
        lin = mean
        out = EKFUpdate(ll, mean, cov, Hx, K)
    return out


def ekf_condition_on(m, P, h, H_x, H_r, R, r0, u, y, jitter=0.0,
                     residual_fn=None) -> EKFUpdate:
    """First-order EKF update (plain linear algebra)."""
    return ekf_condition_on_iterated(m, P, h, H_x, H_r, R, r0, u, y, 1,
                                     jitter, residual_fn)


def ekf_condition_on_ref(m, P, h, H_x, H_r, R, r0, u, y) -> EKFUpdate:
    """The reference's EKF update with its quirks, for golden parity: the
    gain from an LU solve of ``S + 1e-6`` with the scalar added to EVERY
    entry, the covariance in the difference form ``P − K S Kᵀ`` and the
    log-likelihood on the unperturbed ``S``; the innovation is plain
    subtraction. Batched as :func:`ekf_condition_on_iterated`, plain
    linear algebra (the JAX package runs it in XLA, with no kernel)."""
    y = torch.atleast_1d(y)
    B, dx = m.shape
    Hx = batched(H_x)(m, r0, u).reshape(B, -1, dx)
    Hr = batched(H_r)(m, r0, u).reshape(B, Hx.shape[1], -1)
    S = Hr @ R @ Hr.mT + Hx @ P @ Hx.mT
    # solve_ex: no synchronisation for an error check
    K = torch.linalg.solve_ex(S + 1e-6, Hx @ P)[0].mT
    cov = P - K @ S @ K.mT
    innov = y - batched(h)(m, r0, u).reshape(B, -1)
    mean = m + (K @ innov[..., None])[..., 0]
    chol = cholesky_nan(S)
    z = torch.linalg.solve_triangular(chol, innov[..., None], upper=False)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    ll = -0.5 * (innov.shape[-1] * _LOG_2PI + logdet
                 + (z[..., 0] ** 2).sum(-1))
    return EKFUpdate(ll, mean, cov, Hx, K)


def ekf_predict(m, P, f, F_x, F_q, Q, q0, u,
                predict_cov: Callable = predict_cov_precomputed
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """First-order EKF predict over a batch, the covariance propagation done
    by ``predict_cov(Fx, P, Fq, Q)`` (the plain twin here, a kernel wrapper
    in ``ops.fused_ekf`` and ``ops.bank_update``). Returns
    ``(μ⁺, Σ⁺, F_x(m))``."""
    Fx = batched(F_x)(m, q0, u)
    Fq = batched(F_q)(m, q0, u)
    mu = batched(f)(m, q0, u)
    return mu, predict_cov(Fx, P, Fq, Q), Fx


def ekf_step(m, P, f, F_x, F_q, Q, q0, u, h, H_x, H_r, R, r0, y,
             jitter=0.0):
    """Predict, then update on ``y``, over a batch: the covariance
    propagation and the update run in K2 and K1 on CUDA tensors
    (``ops.fused_ekf``). Returns ``(ll, mean, cov)``."""
    from bayesianfiltering_tpu_torch.ops import fused_ekf

    mu, Sigma, _ = fused_ekf.fused_ekf_predict(m, P, f, F_x, F_q, Q, q0, u)
    out = fused_ekf.fused_ekf_condition_on_iterated(
        mu, Sigma, h, H_x, H_r, R, r0, u, y, 1, jitter)
    return out.log_likelihood, out.mean, out.cov


__all__ = [
    "EKFUpdate",
    "batched",
    "chol_update_precomputed",
    "predict_cov_precomputed",
    "ekf_predict",
    "ekf_condition_on",
    "ekf_condition_on_iterated",
    "ekf_condition_on_ref",
    "ekf_step",
]
