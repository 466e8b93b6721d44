"""Unscented-transform steps through the CUDA kernels K6–K9
(counterpart of ``bayesianfiltering_tpu/ops/fused_ut.py``).

``csrc/fused_ut.cu`` holds four kernels, each replacing one TPU kernel of
``bayesianfiltering_tpu/ops/fused_ut.py`` and taking a leading batch axis:

- K6 ``ut_sigma_kernel`` (``_sigma_kernel`` ``:100``): 2n sigma points
  m ± c·Fᵀ, F = chol(P) or the 14-step Newton–Schulz √P;
- K7 ``ut_sigma_aug_kernel`` (``_sigma_aug_kernel`` ``:149``): the points of
  N([m; bias], blkdiag(P, C)) without forming the block-diagonal; C and the
  bias are shared by the batch and C is factored once per launch;
- K8 ``ut_update_kernel`` (``_ut_update_kernel`` ``:225``): [S | C] in
  one product a chunk of rows, chol(S), [Z | z] = L⁻¹ [C | innov] and the
  grouped Joseph covariance as sym(P) − ZᵀZ, μ and log N;
- K9 ``ut_predict_kernel`` (``_ut_predict_kernel`` ``:319``): μ and
  Σ = sym(Σw ccᵀ (+Q)), the lower half mirrored.

All four keep their workspace in one block's shared memory. Where it
does not fit (config 5's Lorenz-96 dx=512, the band's edges), tiled
variants replace the same TPU kernels: in ``csrc/sigma_tiled.cu`` K6t
factors P with the EKF's blocked Cholesky in one launch
(``csrc/tiled_chol.cuh``, on P alone; the points are that launch's
epilogue) or runs the Newton–Schulz rounds as tiled products and a points
pass, and K7t factors P and the shared C side by side in one such launch,
the augmented points its epilogue (by Newton–Schulz: both roots' rounds
as grouped products); in ``csrc/ut_tiled.cu`` K8t is four
launches: it centres the points, forms [S; Cᵀ] as one product over the
whole card, factors [S; Cᵀ; innovᵀ] with K1t's blocked Cholesky (log N
and μ = m + Zᵀz in its epilogue) and forms Σ = sym(P) − ZᵀZ as one
product, as K8 does; K9t is two: one pass over the card forms μ and the
centred points, and Σ is one symmetric rank-k product split along the
points.
The factor's route and scratch are decided in C; the wrappers ask only
for the scratch size. The choice is by shape alone (:func:`sigma_kernel`,
:func:`sigma_aug_kernel`, :func:`update_kernel`, :func:`predict_kernel`).

The model evaluations f(pts), h(pts) run between them in PyTorch. K8 takes
μy and the innovation from the wrapper, which applies the model's residual
function (e.g. a wrapped bearing), so the models with an
``emission_residual`` run the update kernel too (the TPU package skips its
kernel for them).

On CUDA tensors the wrappers launch the kernel or raise; on CPU tensors
they run the plain versions beside them. The band is every factor and
moment dimension ≤ 1,024 (the TPU package caps its kernels at 128 for TPU
reasons and runs XLA above; here K6–K9 hand over to K6t–K9t, so the
Lorenz-96 dx=512 configuration runs through kernels); a CUDA input
outside it raises NotImplementedError.
"""
from __future__ import annotations

import torch

from bayesianfiltering_tpu_torch import _build
from bayesianfiltering_tpu_torch.ops.ekf import _residual
from bayesianfiltering_tpu_torch.ops.ukf import (
    ParamsUKF,
    _ut_moments,
    eval_aug_rows,
    eval_rows,
    ukf_gain_update,
    ut_cov,
    ut_cross,
    ut_mean,
    ut_weights,
)
from bayesianfiltering_tpu_torch.utils.linalg import symmetrize
from bayesianfiltering_tpu_torch.utils.sigma_points import (
    factor,
    points_blockdiag,
    points_from_factor,
)

_DIM_MAX = 1024
_METHODS = {"cholesky": 0, "sqrtm": 1}  # csrc/fused_ut.cu kCholesky, kSqrtm

_SRC = "bayesianfiltering_tpu_torch/csrc/fused_ut.cu"
_TILED_SRC = "bayesianfiltering_tpu_torch/csrc/ut_tiled.cu"
_SIGMA_TILED_SRC = "bayesianfiltering_tpu_torch/csrc/sigma_tiled.cu"
K6 = _build.register("bft_ut_sigma", _SRC,
                     "bayesianfiltering_tpu/ops/fused_ut.py:100")
K7 = _build.register("bft_ut_sigma_aug", _SRC,
                     "bayesianfiltering_tpu/ops/fused_ut.py:149")
K8 = _build.register("bft_ut_update", _SRC,
                     "bayesianfiltering_tpu/ops/fused_ut.py:225")
K9 = _build.register("bft_ut_predict", _SRC,
                     "bayesianfiltering_tpu/ops/fused_ut.py:319")
K8T = _build.register("bft_ut_update_tiled", _TILED_SRC,
                      "bayesianfiltering_tpu/ops/fused_ut.py:225")
K9T = _build.register("bft_ut_predict_tiled", _TILED_SRC,
                      "bayesianfiltering_tpu/ops/fused_ut.py:319")
K6T = _build.register("bft_ut_sigma_tiled", _SIGMA_TILED_SRC,
                      "bayesianfiltering_tpu/ops/fused_ut.py:100")
K7T = _build.register("bft_ut_sigma_aug_tiled", _SIGMA_TILED_SRC,
                      "bayesianfiltering_tpu/ops/fused_ut.py:149")

_ROW_CHUNK = 64  # csrc/fused_ut.cu kRowChunk
_THREADS = 256  # csrc/fused_ut.cu kUtThreads


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# The per-element kernels' shared-memory workspaces, in elements
# (``factor_ws_elems``, ``UpdateWs`` and ``PredictWs`` of
# csrc/fused_ut.cu). K7's points kernel holds P's factor workspace and the
# 2dn × dn noise points, its noise launch C's factor workspace.
def _factor_ws(n: int, method: str) -> int:
    return n * n * (4 if method == "sqrtm" else 1)


def _aug_ws(dx: int, dn: int, method: str) -> int:
    return max(_factor_ws(dx, method) + 2 * dn * dn, _factor_ws(dn, method))


def _update_ws(dx: int, dy: int) -> int:
    """K8: _ROW_CHUNK staged rows [Hc | pad | Xc], the accumulator
    [S | pad | C | innov] (dy rows to the next multiple of 32), P, the
    centres [μy | 0 | m], d0 and the pivots' reciprocals; C starts at
    column oc = dy rounded up to 4, leading dimensions are multiples of
    32."""
    oc, ry, ldx = _round_up(dy, 4), _round_up(dy, 32), _round_up(dx, 32)
    lstg = _round_up(oc + dx, 32)
    lsc = _round_up(oc + _round_up(dx + 1, 4), 32)
    return _ROW_CHUNK * lstg + ry * lsc + dx * ldx + lstg + 2 * ry


def _predict_ws(dx: int) -> int:
    """K9: _ROW_CHUNK staged rows, the lower tiles of Σ ccᵀ, μ, d0 and the
    partial sums of μ."""
    ldx = _round_up(dx, 32)
    return (_ROW_CHUNK + dx) * ldx + 2 * ldx + max(ldx, _THREADS)


def sigma_kernel(n: int, method: str, itemsize: int,
                 smem_optin: int) -> _build.Kernel:
    """The sigma-point kernel for one shape: K6 (one block per element)
    where its factor's workspace fits in a block's shared memory,
    ``smem_optin`` bytes, K6t (tiled over the card) otherwise."""
    fits = _build.fits_smem(_factor_ws(n, method), itemsize, smem_optin)
    return K6 if fits else K6T


def sigma_aug_kernel(dx: int, dn: int, method: str, itemsize: int,
                     smem_optin: int) -> _build.Kernel:
    """The augmented sigma-point kernel for one shape: K7 where both of its
    launches' workspaces fit in ``smem_optin`` bytes of shared memory, K7t
    otherwise."""
    fits = _build.fits_smem(_aug_ws(dx, dn, method), itemsize, smem_optin)
    return K7 if fits else K7T


def update_kernel(dx: int, dy: int, itemsize: int,
                  smem_optin: int) -> _build.Kernel:
    """The UT update kernel for one shape: K8 (one block per element)
    where its workspace fits in a block's shared memory, ``smem_optin``
    bytes (the device's opt-in limit), K8t (tiled over the card)
    otherwise."""
    fits = _build.fits_smem(_update_ws(dx, dy), itemsize, smem_optin)
    return K8 if fits else K8T


def predict_kernel(dx: int, itemsize: int, smem_optin: int) -> _build.Kernel:
    """The UT predict kernel for one shape: K9 where its workspace fits in
    ``smem_optin`` bytes of shared memory, K9t otherwise."""
    fits = _build.fits_smem(_predict_ws(dx), itemsize, smem_optin)
    return K9 if fits else K9T


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _sigma_plain(m, P, scale, method):
    return points_from_factor(m, factor(P, method), scale)


def _sigma_aug_plain(m, P, bias, C, scale, method):
    return points_blockdiag(m, P, bias, C, scale, method)


def _ut_update_plain(pts, hpts, center_y, mu_y, m, P, R, innov, w_side, w0c,
                     add_r):
    """The UT update from the sigma points ``pts`` (B, rows, ≥ dx; state in
    the first dx columns), their images ``hpts`` (B, rows, dy), the image
    of the mean ``center_y`` and ``mu_y``. Returns ``(ll, mean, cov)``."""
    S, cen = ut_cov(center_y, hpts, mu_y, w_side, w0c)
    if add_r:
        S = S + R
    C = ut_cross(cen, pts, m, w_side)
    return ukf_gain_update(m, P, symmetrize(S), C, innov)


def _ut_predict_plain(fpts, center, Q, w_side, w0m, w0c, add_q):
    """μ and sym(Σw ccᵀ (+Q)) of the propagated points ``fpts``
    (B, rows, dx)."""
    mu, cov, _ = _ut_moments(center, fpts, (w_side, w0m, w0c))
    if add_q:
        cov = cov + Q
    return mu, symmetrize(cov)


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def _launch_sigma(m, P, scale, method):
    B, n = m.shape
    code = _METHODS[method]
    kernel = sigma_kernel(n, method, m.element_size(),
                          _build.smem_optin(m.device))
    _build.check_operands(kernel, (m, (B, n)), (P, (B, n, n)))
    pts = m.new_empty(B, 2 * n, n)
    if B:
        with torch.cuda.device(m.device):
            ptrs = [m.data_ptr(), P.data_ptr(), pts.data_ptr()]
            if kernel is K6T:  # the factor's scratch
                scratch = m.new_empty(
                    _build.load().bft_ut_sigma_tiled_scratch_elems(B, n, code))
                ptrs.append(scratch.data_ptr())
            err = _build.symbol(kernel, m)(
                *ptrs, B, n, scale, code,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, kernel)
        kernel.launches += 1
    return pts


def _launch_sigma_aug(m, P, bias, C, scale, method):
    B, dx = m.shape
    dn = bias.shape[-1]
    na = dx + dn
    code = _METHODS[method]
    kernel = sigma_aug_kernel(dx, dn, method, m.element_size(),
                              _build.smem_optin(m.device))
    _build.check_operands(kernel, (m, (B, dx)), (P, (B, dx, dx)),
                          (bias, (dn,)), (C, (dn, dn)))
    pts = m.new_empty(B, 2 * na, na)
    if B:
        with torch.cuda.device(m.device):
            ptrs = [m.data_ptr(), P.data_ptr(), bias.data_ptr(),
                    C.data_ptr(), pts.data_ptr()]
            if kernel is K7T:  # the factors' scratch
                scratch = m.new_empty(
                    _build.load().bft_ut_sigma_aug_tiled_scratch_elems(
                        B, dx, dn, code))
            else:  # the shared noise block's points
                scratch = m.new_empty(2 * dn, dn)
            ptrs.append(scratch.data_ptr())
            err = _build.symbol(kernel, m)(
                *ptrs, B, dx, dn, scale, code,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, kernel)
        kernel.launches += 1
    return pts


def _launch_update(pts, hpts, center_y, mu_y, m, P, R, innov, w_side, w0c,
                   add_r):
    B, dx = m.shape
    rows, ld = pts.shape[1:]
    dy = hpts.shape[-1]
    operands = [(pts, (B, rows, ld)), (hpts, (B, rows, dy)),
                (center_y, (B, dy)), (mu_y, (B, dy)), (m, (B, dx)),
                (P, (B, dx, dx)), (innov, (B, dy))]
    if add_r:
        operands.append((R, (dy, dy)))
    kernel = update_kernel(dx, dy, m.element_size(),
                           _build.smem_optin(m.device))
    _build.check_operands(kernel, *operands)
    if ld < dx:
        raise ValueError(f"{kernel.name}: sigma points of width {ld} < "
                         f"dx={dx}")
    ll, mean, cov = m.new_empty(B), torch.empty_like(m), torch.empty_like(P)
    if B:
        with torch.cuda.device(m.device):
            ptrs = [pts.data_ptr(), hpts.data_ptr(), center_y.data_ptr(),
                    mu_y.data_ptr(), m.data_ptr(), P.data_ptr(),
                    R.data_ptr() if add_r else None, innov.data_ptr(),
                    ll.data_ptr(), mean.data_ptr(), cov.data_ptr()]
            if kernel is K8T:  # K8t's per-element workspace
                scratch = m.new_empty(
                    B * _build.load().bft_ut_update_tiled_scratch_elems(
                        rows, dx, dy))
                ptrs.append(scratch.data_ptr())
            err = _build.symbol(kernel, m)(
                *ptrs, B, rows, ld, dx, dy, w_side, w0c,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, kernel)
        kernel.launches += 1
    return ll, mean, cov


def _launch_predict(fpts, center, Q, w_side, w0m, w0c, add_q):
    B, rows, dx = fpts.shape
    operands = [(fpts, (B, rows, dx)), (center, (B, dx))]
    if add_q:
        operands.append((Q, (dx, dx)))
    kernel = predict_kernel(dx, fpts.element_size(),
                            _build.smem_optin(fpts.device))
    _build.check_operands(kernel, *operands)
    mu, cov = center.new_empty(B, dx), center.new_empty(B, dx, dx)
    if B:
        with torch.cuda.device(fpts.device):
            ptrs = [fpts.data_ptr(), center.data_ptr(),
                    Q.data_ptr() if add_q else None, mu.data_ptr(),
                    cov.data_ptr()]
            if kernel is K9T:  # sym(Q), the centred points and d0
                scratch = fpts.new_empty(
                    _build.load().bft_ut_predict_tiled_scratch_elems(
                        B, rows, dx))
                ptrs.append(scratch.data_ptr())
            err = _build.symbol(kernel, fpts)(
                *ptrs, B, rows, dx, w_side, w0m, w0c,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, kernel)
        kernel.launches += 1
    return mu, cov


_sigma_op = _build.kernel_op(_sigma_plain, _launch_sigma, 2)
_sigma_aug_op = _build.kernel_op(_sigma_aug_plain, _launch_sigma_aug, 4)
_update_op = _build.kernel_op(_ut_update_plain, _launch_update, 8)
_predict_op = _build.kernel_op(_ut_predict_plain, _launch_predict, 3)


def _band(x: torch.Tensor, kernel, **dims) -> None:
    if x.is_cuda and any(d > _DIM_MAX for d in dims.values()):
        raise NotImplementedError(
            f"{kernel.name} band is every dimension <= {_DIM_MAX}; got "
            + ", ".join(f"{k}={v}" for k, v in dims.items()))


def _method(uparams: ParamsUKF) -> str:
    if uparams.sqrt_method not in _METHODS:
        raise ValueError(f"unknown sqrt_method {uparams.sqrt_method!r}")
    return uparams.sqrt_method


# ---------------------------------------------------------------------------
# kernel ops: K on CUDA tensors, the plain versions on CPU tensors
# ---------------------------------------------------------------------------

def fused_sigma(m, P, scale: float, method: str):
    """Sigma points (B, 2n, n) of ``m`` (B, n), ``P`` (B, n, n). K6 or K6t
    on CUDA (:func:`sigma_kernel`), the plain version on CPU."""
    _band(m, K6, n=m.shape[-1])
    return _sigma_op(m.contiguous(), P.contiguous(), float(scale), method)


def fused_sigma_aug(m, P, bias, C, scale: float, method: str):
    """Augmented sigma points (B, 2na, na) of ``N([m; bias], blkdiag(P,
    C))``, ``bias`` (dn,) and ``C`` (dn, dn) shared. K7 or K7t on CUDA
    (:func:`sigma_aug_kernel`), the plain version on CPU."""
    _band(m, K7, na=m.shape[-1] + bias.shape[-1])
    return _sigma_aug_op(m.contiguous(), P.contiguous(), bias.contiguous(),
                         C.contiguous(), float(scale), method)


def fused_ut_update(pts, hpts, center_y, mu_y, m, P, R, innov, w_side, w0c,
                    add_r: bool):
    """UT measurement update from propagated sigma points. ``R`` (dy, dy)
    is added to S only when ``add_r``. Returns ``(ll, mean, cov)``. K8 or
    K8t on CUDA (:func:`update_kernel`), the plain version on CPU."""
    _band(m, K8, dx=m.shape[-1], dy=hpts.shape[-1])
    return _update_op(pts.contiguous(), hpts.contiguous(),
                      center_y.contiguous(), mu_y.contiguous(),
                      m.contiguous(), P.contiguous(), R.contiguous(),
                      innov.contiguous(), float(w_side), float(w0c),
                      bool(add_r))


def fused_ut_predict(fpts, center, Q, w_side, w0m, w0c, add_q: bool):
    """UT predict moments ``(μ, Σ)`` of propagated sigma points; ``Q``
    (dx, dx) is added only when ``add_q``. K9 or K9t on CUDA
    (:func:`predict_kernel`), the plain version on CPU."""
    _band(fpts, K9, dx=fpts.shape[-1])
    return _predict_op(fpts.contiguous(), center.contiguous(), Q.contiguous(),
                       float(w_side), float(w0m), float(w0c), bool(add_q))


# ---------------------------------------------------------------------------
# filter-facing drop-ins for ops/ukf.py
# ---------------------------------------------------------------------------

def fused_ukf_predict_additive(m, P, f, u, Q, uparams: ParamsUKF, q0):
    """Drop-in for ``ops.ukf.ukf_predict_additive``: K6 (or K6t), then f
    over the points, then K9 (or K9t)."""
    dx = m.shape[-1]
    scale, (w_side, w0m, w0c) = ut_weights(dx, uparams)
    pts = fused_sigma(m, P, scale, _method(uparams))
    q0z = m.new_zeros(dx)
    fpts = eval_rows(f, pts, q0z, u)
    center = eval_rows(f, m, q0z, u)
    return fused_ut_predict(fpts, center, Q, w_side, w0m, w0c, True)


def fused_ukf_predict_nonadditive(m, P, f, u, Q, uparams: ParamsUKF, q0):
    """Drop-in for ``ops.ukf.ukf_predict_nonadditive``: K7 (or K7t), then f
    over the augmented points, then K9 (or K9t)."""
    dx = m.shape[-1]
    scale, (w_side, w0m, w0c) = ut_weights(dx + q0.shape[-1], uparams)
    pts = fused_sigma_aug(m, P, q0, Q, scale, _method(uparams))
    fpts = eval_aug_rows(f, pts, dx, u)
    center = eval_rows(f, m, q0, u)
    return fused_ut_predict(fpts, center, Q, w_side, w0m, w0c, False)


def _update(pts, hpts, center, m, P, R, y, weights, add_r, residual_fn):
    w_side, w0m, w0c = weights
    mu_y = ut_mean(center, hpts, w_side, w0m)
    innov = _residual(y, mu_y, residual_fn)
    return fused_ut_update(pts, hpts, center, mu_y, m, P, R, innov, w_side,
                           w0c, add_r)


def fused_ukf_condition_on_additive(m, P, h, R, u, y, uparams: ParamsUKF,
                                    r0=None, residual_fn=None):
    """Drop-in for ``ops.ukf.ukf_condition_on_additive``: K6 (or K6t), then
    h over the points, then K8 (or K8t). Returns ``(ll, mean, cov)``."""
    dx = m.shape[-1]
    y = torch.atleast_1d(y)
    scale, weights = ut_weights(dx, uparams)
    pts = fused_sigma(m, P, scale, _method(uparams))
    r0z = m.new_zeros(y.shape[-1])
    hpts = eval_rows(h, pts, r0z, u)
    center = eval_rows(h, m, r0z, u)
    return _update(pts, hpts, center, m, P, R, y, weights, True, residual_fn)


def fused_ukf_condition_on_nonadditive(m, P, h, R, u, y, uparams: ParamsUKF,
                                       r0=None, residual_fn=None):
    """Drop-in for ``ops.ukf.ukf_condition_on_nonadditive``: K7 (or K7t),
    then h over the augmented points, then K8 (or K8t) on their state part.
    Returns
    ``(ll, mean, cov)``."""
    dx = m.shape[-1]
    y = torch.atleast_1d(y)
    scale, weights = ut_weights(dx + r0.shape[-1], uparams)
    pts = fused_sigma_aug(m, P, r0, R, scale, _method(uparams))
    hpts = eval_aug_rows(h, pts, dx, u)
    center = eval_rows(h, m, r0, u)
    return _update(pts, hpts, center, m, P, R, y, weights, False, residual_fn)


__all__ = [
    "sigma_kernel",
    "sigma_aug_kernel",
    "update_kernel",
    "predict_kernel",
    "fused_sigma",
    "fused_sigma_aug",
    "fused_ut_update",
    "fused_ut_predict",
    "fused_ukf_predict_additive",
    "fused_ukf_predict_nonadditive",
    "fused_ukf_condition_on_additive",
    "fused_ukf_condition_on_nonadditive",
]
