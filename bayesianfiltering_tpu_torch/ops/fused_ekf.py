"""Batched EKF update and predict through the CUDA kernels K1 and K2
(counterpart of ``bayesianfiltering_tpu/ops/fused_ekf.py``).

K1 (``csrc/fused_ekf.cu``, ``ekf_update_kernel``) replaces the TPU kernel
``_update_kernel`` (``bayesianfiltering_tpu/ops/fused_ekf.py:61``): S,
chol(S), L⁻¹, Kᵀ = S⁻¹ H P, the Joseph covariance, the mean and the
log-likelihood in one launch. K2 (``ekf_predict_cov_kernel``) replaces
``_predict_kernel`` (``:146``): Σ⁺ = sym(F_x P F_xᵀ + F_q Q F_qᵀ). Unlike
the TPU kernels, both take a leading batch axis (one thread block per
element), so the batched filter runs through them.

On CUDA tensors the wrappers launch the kernel or raise; on CPU tensors
they run the plain twins beside them. The band is dx, dy ≤ 512 for the
update and dx, dq ≤ 512 for the predict; a CUDA input outside it raises
NotImplementedError. (The TPU package caps its update kernel at dy ≤ 128,
where its in-kernel factorisation was verified on the TPU, and offers the
sequential chunked update for larger dy; K1 factors S in global scratch
instead, so both the joint update and the chunked one,
:func:`fused_ekf_condition_on_chunked`, run on the card at dy = 256.)
"""
from __future__ import annotations

import torch

from bayesianfiltering_tpu_torch import _build
from bayesianfiltering_tpu_torch.ops.ekf import (
    EKFUpdate,
    _degenerate_update,
    _residual,
    batched,
    chol_update_precomputed,
    ekf_condition_on_iterated,
    ekf_predict,
    predict_cov_precomputed,
)

_DIM_MAX = 512
_DY_MAX = 512
_CHUNK = 128  # the JAX package's default chunk (its kernel's dy band)

K1 = _build.register("bft_ekf_update",
                     "bayesianfiltering_tpu_torch/csrc/fused_ekf.cu",
                     "bayesianfiltering_tpu/ops/fused_ekf.py:61")
K2 = _build.register("bft_ekf_predict_cov",
                     "bayesianfiltering_tpu_torch/csrc/fused_ekf.cu",
                     "bayesianfiltering_tpu/ops/fused_ekf.py:146")

_update_plain = chol_update_precomputed
_predict_plain = predict_cov_precomputed


def _launch_update(m, P, Hx, Rt, innov, jitter):
    B, dx = m.shape
    dy = innov.shape[-1]
    _build.check_operands(K1, (m, (B, dx)), (P, (B, dx, dx)),
                          (Hx, (B, dy, dx)), (Rt, (B, dy, dy)),
                          (innov, (B, dy)))
    lib = _build.load()
    ll, mean = m.new_empty(B), torch.empty_like(m)
    cov, kt = torch.empty_like(P), m.new_empty(B, dy, dx)
    if B:
        with torch.cuda.device(m.device):
            scratch = _build.scratch(lib.bft_ekf_update_scratch_elems(
                dx, dy, m.element_size(), m.device.index), K1, B, m)
            err = _build.symbol(K1, m)(
                m.data_ptr(), P.data_ptr(), Hx.data_ptr(), Rt.data_ptr(),
                innov.data_ptr(), ll.data_ptr(), mean.data_ptr(),
                cov.data_ptr(), kt.data_ptr(), _build.ptr(scratch), B, dx, dy,
                jitter, torch.cuda.current_stream().cuda_stream)
        _build.check(err, K1)
        K1.launches += 1
    return ll, mean, cov, kt.mT


def _launch_predict(Fx, P, Fq, Q):
    B, dx = Fx.shape[:2]
    dq = Fq.shape[-1]
    _build.check_operands(K2, (Fx, (B, dx, dx)), (P, (B, dx, dx)),
                          (Fq, (B, dx, dq)), (Q, (dq, dq)))
    lib = _build.load()
    cov = torch.empty_like(P)
    if B:
        with torch.cuda.device(P.device):
            scratch = _build.scratch(lib.bft_ekf_predict_cov_scratch_elems(
                dx, dq, P.element_size(), P.device.index), K2, B, P)
            err = _build.symbol(K2, P)(
                Fx.data_ptr(), P.data_ptr(), Fq.data_ptr(), Q.data_ptr(),
                cov.data_ptr(), _build.ptr(scratch), B, dx, dq,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, K2)
        K2.launches += 1
    return cov


_fused_update = _build.kernel_op(_update_plain, _launch_update, 5)
_fused_predict_cov = _build.kernel_op(_predict_plain, _launch_predict, 4)


def fused_update(m, P, Hx, Rt, innov, jitter=0.0):
    """Batched Joseph-form update on precomputed linearizations: ``m``
    (B, dx), ``P`` (B, dx, dx), ``Hx`` (B, dy, dx), ``Rt`` (B, dy, dy),
    ``innov`` (B, dy). Returns ``(ll, mean, cov, gain)`` with the gain
    (B, dx, dy). K1 on CUDA, the plain twin on CPU."""
    dx, dy = P.shape[-1], innov.shape[-1]
    if m.is_cuda and (dx > _DIM_MAX or dy > _DY_MAX):
        raise NotImplementedError(
            f"update kernel band is dx <= {_DIM_MAX}, dy <= {_DY_MAX}; got "
            f"dx={dx}, dy={dy}")
    return _fused_update(m.contiguous(), P.contiguous(), Hx.contiguous(),
                         Rt.contiguous(), innov.contiguous(), float(jitter))


def fused_predict_cov(Fx, P, Fq, Q):
    """Batched Σ⁺ = sym(F_x P F_xᵀ + F_q Q F_qᵀ) with ``Q`` (dq, dq)
    shared. K2 on CUDA, the plain twin on CPU."""
    dx, dq = P.shape[-1], Fq.shape[-1]
    if P.is_cuda and (dx > _DIM_MAX or dq > _DIM_MAX):
        raise NotImplementedError(
            f"predict kernel band is dx, dq <= {_DIM_MAX}; got dx={dx}, "
            f"dq={dq}")
    return _fused_predict_cov(Fx.contiguous(), P.contiguous(),
                              Fq.contiguous(), Q.contiguous())


def fused_ekf_condition_on_iterated(m, P, h, H_x, H_r, R, r0, u, y,
                                    num_iter=1, jitter=0.0,
                                    residual_fn=None) -> EKFUpdate:
    """Batched (iterated) EKF measurement update, one K1 launch per
    iteration."""
    return ekf_condition_on_iterated(m, P, h, H_x, H_r, R, r0, u, y,
                                     num_iter, jitter, residual_fn,
                                     update=fused_update)


def _chunk_bounds(dy: int, chunk) -> list:
    """The static ``[lo, hi)`` emission blocks of the chunked update.
    Raises ValueError for a chunk below 1, as the JAX package does (its
    ``range`` refuses 0, and a negative chunk leaves no block to
    concatenate)."""
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"update_chunk must be a positive integer; got "
                         f"{chunk}")
    return [(lo, min(lo + chunk, dy)) for lo in range(0, dy, chunk)]


def fused_ekf_condition_on_chunked(m, P, h, H_x, H_r, R, r0, u, y,
                                   chunk=_CHUNK, num_iter=1, jitter=0.0,
                                   residual_fn=None) -> EKFUpdate:
    """Sequential (chunked) EKF measurement update for large emission
    dimensions, batched: the emission vector in ``chunk``-sized blocks, one
    K1 launch per block (⌈dy/chunk⌉ per iteration), the counterpart of
    ``bayesianfiltering_tpu/ops/fused_ekf.py``
    ``fused_ekf_condition_on_chunked``.

    EXACT (the same posterior and total log-likelihood as the joint update)
    whenever the effective emission noise ``Rt = H_r R H_rᵀ`` is
    block-diagonal with respect to the chunking (e.g. diagonal sensor
    noise, as in the Lorenz-96 dx=512 configuration); an approximation
    otherwise — cross-chunk noise correlations are dropped. Chunk
    boundaries are static; each block's innovation is corrected for the
    mean motion of the earlier blocks (``inn_c −= H_c (m_cur − m_lin)``),
    so within one linearization the recursion is algebraically the joint
    update. The log-likelihood is the sum over the blocks; the ``gain``
    field holds the per-block gains concatenated to (B, dx, dy)
    (diagnostic — the joint gain is not formed)."""
    y = torch.atleast_1d(y)
    if int(num_iter) <= 0:
        return _degenerate_update(m, P, y)
    bounds = _chunk_bounds(y.shape[-1], chunk)
    B, dx = m.shape
    lin, out = m, None
    for it in range(int(num_iter)):
        Hx = batched(H_x)(lin, r0, u).reshape(B, -1, dx)
        Hr = batched(H_r)(lin, r0, u).reshape(B, Hx.shape[1], -1)
        yhat = batched(h)(lin, r0, u).reshape(B, -1)
        if it > 0:
            yhat = yhat + (Hx @ (m - lin)[..., None])[..., 0]
        Rt = Hr @ R @ Hr.mT
        innov = _residual(y, yhat, residual_fn)
        ll_total = m.new_zeros(B)
        cur_m, cur_P = m, P
        gains = []
        for lo, hi in bounds:
            Hc = Hx[:, lo:hi]
            inn = innov[..., lo:hi] - (Hc @ (cur_m - m)[..., None])[..., 0]
            ll, cur_m, cur_P, K = fused_update(cur_m, cur_P, Hc,
                                               Rt[:, lo:hi, lo:hi], inn,
                                               jitter)
            ll_total = ll_total + ll
            gains.append(K)
        lin = cur_m
        out = EKFUpdate(ll_total, cur_m, cur_P, Hx, torch.cat(gains, -1))
    return out


def fused_ekf_predict(m, P, f, F_x, F_q, Q, q0, u):
    """Batched EKF predict with the covariance propagation in K2. Returns
    ``(μ⁺, Σ⁺, F_x(m))``."""
    return ekf_predict(m, P, f, F_x, F_q, Q, q0, u,
                       predict_cov=fused_predict_cov)


__all__ = [
    "fused_update",
    "fused_predict_cov",
    "fused_ekf_condition_on_iterated",
    "fused_ekf_condition_on_chunked",
    "fused_ekf_predict",
]
