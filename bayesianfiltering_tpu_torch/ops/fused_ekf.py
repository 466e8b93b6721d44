"""Batched EKF update and predict through the CUDA kernels K1 and K2, and
their tiled variants K1t and K2t (counterpart of
``bayesianfiltering_tpu/ops/fused_ekf.py``).

K1 (``csrc/fused_ekf.cu``, ``ekf_update_kernel``) replaces the TPU kernel
``_update_kernel`` (``bayesianfiltering_tpu/ops/fused_ekf.py:61``): S,
chol(S), L⁻¹, Kᵀ = S⁻¹ H P, the Joseph covariance, the mean and the
log-likelihood in one launch. K2 (``ekf_predict_cov_kernel``) replaces
``_predict_kernel`` (``:146``): Σ⁺ = sym(F_x P F_xᵀ + F_q Q F_qᵀ). Unlike
the TPU kernels, both take a leading batch axis (one thread block per
element), so the batched filter runs through them. Their workspace lives
in the block's shared memory.

K1t and K2t (``csrc/ekf_tiled.cu``) replace the same TPU kernels for
elements whose workspace does not fit there: every product is tiled over
the whole card (``csrc/tiled.cuh``) and the Cholesky is blocked, in one
cooperative launch (``csrc/tiled_chol.cuh``), so one sequence at
dx = 512 uses every SM. K2t is two launches: F_x P and F_q Q as one
grouped launch (two products in one grid), then lower(F_x P F_xᵀ +
F_q Q F_qᵀ) mirrored. The choice is by shape alone (:func:`update_kernel`,
:func:`predict_kernel`); the C entry points size the scratch.

On CUDA tensors the wrappers launch a kernel or raise; on CPU tensors
they run the plain twins beside them. Every width runs on the card, in
float32 and float64: K1t and K2t keep their working set in global scratch
(64-bit offsets), so a width whose operands and scratch fit in the
device's memory runs, and one that does not fails with PyTorch's
out-of-memory error when the scratch is allocated. (The TPU package runs
its update kernel to dy ≤ 128, where its in-kernel factorisation was
verified on the TPU, and XLA above, with the sequential chunked update
for larger dy; here both the joint update and the chunked one,
:func:`fused_ekf_condition_on_chunked`, run on the card at dy = 256 and
1,024.)
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

_CHUNK = 128  # the JAX package's default chunk (its kernel's dy band)

_SRC = "bayesianfiltering_tpu_torch/csrc/fused_ekf.cu"
_TILED_SRC = "bayesianfiltering_tpu_torch/csrc/ekf_tiled.cu"
K1 = _build.register("bft_ekf_update", _SRC,
                     "bayesianfiltering_tpu/ops/fused_ekf.py:61")
K2 = _build.register("bft_ekf_predict_cov", _SRC,
                     "bayesianfiltering_tpu/ops/fused_ekf.py:146")
K1T = _build.register("bft_ekf_update_tiled", _TILED_SRC,
                      "bayesianfiltering_tpu/ops/fused_ekf.py:61")
K2T = _build.register("bft_ekf_predict_cov_tiled", _TILED_SRC,
                      "bayesianfiltering_tpu/ops/fused_ekf.py:146")

_update_plain = chol_update_precomputed
_predict_plain = predict_cov_precomputed


def _ru(x: int, m: int) -> int:
    return -(-x // m) * m


# The per-element kernels' shared-memory workspace, in elements
# (``UpdateWs`` and ``PredictWs`` of csrc/fused_ekf.cu, which lay them out).
def _update_ws(dx: int, dy: int) -> int:
    ldx, ldy = _ru(dx, 32), _ru(dy, 32)
    ldr = _ru(_ru(dx + 1, 4) + dy, 32)
    h = dx * ldx + dy * ldy                          # P, Rt
    q = h + max(_ru(dy, 4) * ldx + ldy * ldr,        # H, [H P | innov | I]
                (dx + dy) * ldx)                     # or [(A P)ᵀ ; (K Rt)ᵀ]
    dinv = q + max(dx * ldy + ldy * ldr,             # (H P)ᵀ, S
                   (dx + dy) * ldx)                  # or [Aᵀ ; W]
    return dinv + 2 * ldy


def _predict_ws(dx: int, dq: int) -> int:
    oq, ldx = _ru(dx, 4), _ru(dx, 32)
    return (oq * _ru(oq + dq, 32) + dx * ldx + dq * _ru(dq, 32)  # F, P, Q
            + (oq + dq) * ldx)                                 # G


def update_kernel(dx: int, dy: int, itemsize: int,
                  smem_optin: int) -> _build.Kernel:
    """The update kernel for one shape: K1 (one block per element) where
    its workspace fits in a block's shared memory, ``smem_optin`` bytes
    (the device's opt-in limit), K1t (tiled over the card) otherwise."""
    fits = _build.fits_smem(_update_ws(dx, dy), itemsize, smem_optin)
    return K1 if fits else K1T


def predict_kernel(dx: int, dq: int, itemsize: int,
                   smem_optin: int) -> _build.Kernel:
    """The predict kernel for one shape: K2 where its workspace fits in
    ``smem_optin`` bytes of shared memory, K2t otherwise."""
    fits = _build.fits_smem(_predict_ws(dx, dq), itemsize, smem_optin)
    return K2 if fits else K2T


def _launch_update(m, P, Hx, Rt, innov, jitter):
    B, dx = m.shape
    dy = innov.shape[-1]
    kernel = update_kernel(dx, dy, m.element_size(),
                           _build.smem_optin(m.device))
    _build.check_operands(kernel, (m, (B, dx)), (P, (B, dx, dx)),
                          (Hx, (B, dy, dx)), (Rt, (B, dy, dy)),
                          (innov, (B, dy)))
    tiled = kernel is K1T
    ll, mean, cov = m.new_empty(B), torch.empty_like(m), torch.empty_like(P)
    # K1t writes the gain K (B, dx, dy), K1 its transpose (B, dy, dx)
    gain = m.new_empty(B, dx, dy) if tiled else m.new_empty(B, dy, dx)
    if B:
        with torch.cuda.device(m.device):
            ptrs = [m.data_ptr(), P.data_ptr(), Hx.data_ptr(), Rt.data_ptr(),
                    innov.data_ptr(), ll.data_ptr(), mean.data_ptr(),
                    cov.data_ptr(), gain.data_ptr()]
            if tiled:  # K1t's per-element workspace
                scratch = m.new_empty(
                    B * _build.load().bft_ekf_update_tiled_scratch_elems(
                        dx, dy))
                ptrs.append(scratch.data_ptr())
            err = _build.symbol(kernel, m)(
                *ptrs, B, dx, dy, jitter,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, kernel)
        kernel.launches += 1
    return ll, mean, cov, gain if tiled else gain.mT


def _launch_predict(Fx, P, Fq, Q):
    B, dx = Fx.shape[:2]
    dq = Fq.shape[-1]
    kernel = predict_kernel(dx, dq, P.element_size(),
                            _build.smem_optin(P.device))
    _build.check_operands(kernel, (Fx, (B, dx, dx)), (P, (B, dx, dx)),
                          (Fq, (B, dx, dq)), (Q, (dq, dq)))
    cov = torch.empty_like(P)
    if B:
        with torch.cuda.device(P.device):
            ptrs = [Fx.data_ptr(), P.data_ptr(), Fq.data_ptr(), Q.data_ptr(),
                    cov.data_ptr()]
            if kernel is K2T:  # F_x P and F_q Q
                scratch = P.new_empty(
                    B * _build.load().bft_ekf_predict_cov_tiled_scratch_elems(
                        dx, dq))
                ptrs.append(scratch.data_ptr())
            err = _build.symbol(kernel, P)(
                *ptrs, B, dx, dq, torch.cuda.current_stream().cuda_stream)
        _build.check(err, kernel)
        kernel.launches += 1
    return cov


_fused_update = _build.kernel_op(_update_plain, _launch_update, 5)
_fused_predict_cov = _build.kernel_op(_predict_plain, _launch_predict, 4)


def fused_update(m, P, Hx, Rt, innov, jitter=0.0):
    """Batched Joseph-form update on precomputed linearizations: ``m``
    (B, dx), ``P`` (B, dx, dx), ``Hx`` (B, dy, dx), ``Rt`` (B, dy, dy),
    ``innov`` (B, dy). Returns ``(ll, mean, cov, gain)`` with the gain
    (B, dx, dy). K1 or K1t on CUDA (:func:`update_kernel`), the plain twin
    on CPU."""
    return _fused_update(m.contiguous(), P.contiguous(), Hx.contiguous(),
                         Rt.contiguous(), innov.contiguous(), float(jitter))


def fused_predict_cov(Fx, P, Fq, Q):
    """Batched Σ⁺ = sym(F_x P F_xᵀ + F_q Q F_qᵀ) with ``Q`` (dq, dq)
    shared. K2 or K2t on CUDA (:func:`predict_kernel`), the plain twin on
    CPU."""
    return _fused_predict_cov(Fx.contiguous(), P.contiguous(),
                              Fq.contiguous(), Q.contiguous())


def fused_ekf_condition_on_iterated(m, P, h, H_x, H_r, R, r0, u, y,
                                    num_iter=1, jitter=0.0,
                                    residual_fn=None) -> EKFUpdate:
    """Batched (iterated) EKF measurement update, one K1 or K1t launch per
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
    K1 or K1t launch per block (⌈dy/chunk⌉ per iteration), the counterpart
    of ``bayesianfiltering_tpu/ops/fused_ekf.py``
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
    """Batched EKF predict with the covariance propagation in K2 or K2t.
    Returns ``(μ⁺, Σ⁺, F_x(m))``."""
    return ekf_predict(m, P, f, F_x, F_q, Q, q0, u,
                       predict_cov=fused_predict_cov)


__all__ = [
    "update_kernel",
    "predict_kernel",
    "fused_update",
    "fused_predict_cov",
    "fused_ekf_condition_on_iterated",
    "fused_ekf_condition_on_chunked",
    "fused_ekf_predict",
]
