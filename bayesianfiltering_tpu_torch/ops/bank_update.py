"""EKF update and predict over a bank of M Gaussians through the CUDA
kernels K3 and K4 (counterpart of ``bayesianfiltering_tpu/ops/bank_update.py``).

K3 (``csrc/bank_update.cu``, ``bank_update_kernel``) replaces the TPU
kernel ``_bank_update_kernel`` (``bayesianfiltering_tpu/ops/bank_update.py:60``),
K4 (``bank_predict_cov_kernel``) replaces ``_bank_predict_kernel``
(``:329``): the same math as K1/K2, each component a lane over a group
of 4 or 8 threads (``csrc/lane_group.cuh``), for dx, dy, dq ≤ 8. A bank
with a larger dimension goes to K1/K2 with the batch axis = M. Tensors stay (M, d, d) row-major; the TPU's bank-major lane
layout is not carried over. On CPU tensors the plain twins run.
"""
from __future__ import annotations

import torch

from bayesianfiltering_tpu_torch import _build
from bayesianfiltering_tpu_torch.ops.ekf import (
    EKFUpdate,
    chol_update_precomputed,
    ekf_condition_on_iterated,
    ekf_predict,
    predict_cov_precomputed,
)
from bayesianfiltering_tpu_torch.ops.fused_ekf import (
    fused_predict_cov,
    fused_update,
)

_BANK_MAX = 8

K3 = _build.register("bft_bank_update",
                     "bayesianfiltering_tpu_torch/csrc/bank_update.cu",
                     "bayesianfiltering_tpu/ops/bank_update.py:60")
K4 = _build.register("bft_bank_predict_cov",
                     "bayesianfiltering_tpu_torch/csrc/bank_update.cu",
                     "bayesianfiltering_tpu/ops/bank_update.py:329")

_update_plain = chol_update_precomputed
_predict_cov_plain = predict_cov_precomputed


def _launch_update(m, P, Hx, Rt, innov, jitter):
    M, dx = m.shape
    dy = innov.shape[-1]
    _build.check_operands(K3, (m, (M, dx)), (P, (M, dx, dx)),
                          (Hx, (M, dy, dx)), (Rt, (M, dy, dy)),
                          (innov, (M, dy)))
    ll, mean = m.new_empty(M), torch.empty_like(m)
    cov, gain = torch.empty_like(P), m.new_empty(M, dx, dy)
    if M:
        with torch.cuda.device(m.device):
            err = _build.symbol(K3, m)(
                m.data_ptr(), P.data_ptr(), Hx.data_ptr(), Rt.data_ptr(),
                innov.data_ptr(), ll.data_ptr(), mean.data_ptr(),
                cov.data_ptr(), gain.data_ptr(), M, dx, dy, jitter,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, K3)
        K3.launches += 1
    return ll, mean, cov, gain


def _launch_predict(Fx, P, Fq, Q):
    M, dx = Fx.shape[:2]
    dq = Fq.shape[-1]
    _build.check_operands(K4, (Fx, (M, dx, dx)), (P, (M, dx, dx)),
                          (Fq, (M, dx, dq)), (Q, (dq, dq)))
    cov = torch.empty_like(P)
    if M:
        with torch.cuda.device(P.device):
            err = _build.symbol(K4, P)(
                Fx.data_ptr(), P.data_ptr(), Fq.data_ptr(), Q.data_ptr(),
                cov.data_ptr(), M, dx, dq,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, K4)
        K4.launches += 1
    return cov


_bank_update = _build.kernel_op(_update_plain, _launch_update, 5)
_bank_predict_cov = _build.kernel_op(_predict_cov_plain, _launch_predict, 4)


def bank_chol_update(m, P, Hx, Rt, innov, jitter=0.0):
    """Joseph-form update over a bank: ``m`` (M, dx), ``P`` (M, dx, dx),
    ``Hx`` (M, dy, dx), ``Rt`` (M, dy, dy), ``innov`` (M, dy). Returns
    ``(ll, mean, cov, gain)`` shaped (M,), (M, dx), (M, dx, dx),
    (M, dx, dy). K3 for dx, dy ≤ 8, otherwise K1 over the bank."""
    dx, dy = P.shape[-1], innov.shape[-1]
    if dx > _BANK_MAX or dy > _BANK_MAX:
        return fused_update(m, P, Hx, Rt, innov, jitter)
    return _bank_update(m.contiguous(), P.contiguous(), Hx.contiguous(),
                        Rt.contiguous(), innov.contiguous(), float(jitter))


def bank_predict_cov(Fx, P, Fq, Q):
    """Σ⁺[m] = sym(F_x[m] P[m] F_x[m]ᵀ + F_q[m] Q F_q[m]ᵀ) with ``Q``
    (dq, dq) shared by the bank. K4 for dx, dq ≤ 8, otherwise K2."""
    dx, dq = P.shape[-1], Fq.shape[-1]
    if dx > _BANK_MAX or dq > _BANK_MAX:
        return fused_predict_cov(Fx, P, Fq, Q)
    return _bank_predict_cov(Fx.contiguous(), P.contiguous(),
                             Fq.contiguous(), Q.contiguous())


def bank_ekf_predict(ms, Ps, f, F_x, F_q, Q, q0, u):
    """Bank EKF predict. Returns ``(μ⁺, Σ⁺, F_x)``, banked."""
    return ekf_predict(ms, Ps, f, F_x, F_q, Q, q0, u,
                       predict_cov=bank_predict_cov)


def bank_ekf_condition_on_iterated(ms, Ps, h, H_x, H_r, R, r0, u, y,
                                   num_iter=1, jitter=0.0,
                                   residual_fn=None) -> EKFUpdate:
    """Bank (iterated) EKF update on one emission ``y`` (dy,); one kernel
    launch per iteration."""
    return ekf_condition_on_iterated(ms, Ps, h, H_x, H_r, R, r0, u, y,
                                     num_iter, jitter, residual_fn,
                                     update=bank_chol_update)


__all__ = [
    "bank_chol_update",
    "bank_predict_cov",
    "bank_ekf_predict",
    "bank_ekf_condition_on_iterated",
]
