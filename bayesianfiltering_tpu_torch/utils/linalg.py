"""Dense linear-algebra primitives
(counterpart of ``bayesianfiltering_tpu/utils/linalg.py``).

The JAX package's blocked and unrolled factorizations exist because XLA
lowers batched Cholesky and triangular solves to sequential loops on the
TPU; here the library factorizations are used directly. One difference in
contract is bridged: ``jnp.linalg.cholesky`` returns NaN for an input that
is not positive definite, where ``torch.linalg.cholesky`` raises.
:func:`cholesky_nan` restores the NaN contract from ``cholesky_ex``'s
``info``.

The PSD square root keeps the JAX package's algorithm, not an exact root:
14 trace-normalised Newton–Schulz steps up to ``_BLOCK_MAX`` (the sigma
points of the UKF family are built from it, and an exact root drifts from
the reference on ill-conditioned matrices), eigh above.
"""
from __future__ import annotations

import torch


def symmetrize(a: torch.Tensor) -> torch.Tensor:
    """Symmetric part ``(A + Aᵀ)/2`` (batched)."""
    return 0.5 * (a + a.mT)


def cholesky_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN wherever the matrix is not positive
    definite (JAX's contract; never raises, never synchronises). A factor
    counts as failed where ``info`` says so or where a pivot is not
    positive (NaN included): on an H100 ``cholesky_ex`` of a single matrix
    that fails only at its last pivot was seen to report ``info`` = 0."""
    chol, info = torch.linalg.cholesky_ex(a)
    pivots = chol.diagonal(dim1=-2, dim2=-1)
    bad = (info != 0) | ~(pivots > 0).all(dim=-1)
    return torch.where(bad[..., None, None],
                       torch.full_like(chol, float("nan")), chol)


def psd_solve(a: torch.Tensor, b: torch.Tensor, jitter: float = 0.0,
              compat_scalar: bool = False) -> torch.Tensor:
    """Solve ``A x = b`` for symmetric PSD ``A`` via Cholesky.

    ``b`` is (..., n) or (..., n, k). ``jitter`` adds a multiple of the
    identity; ``compat_scalar`` reproduces the reference quirk of adding
    1e-6 to EVERY entry of ``A`` before an LU solve (parity experiments).
    """
    if compat_scalar:
        return torch.linalg.solve(a + 1e-6, b)
    n = a.shape[-1]
    if jitter:
        a = a + jitter * torch.eye(n, dtype=a.dtype, device=a.device)
    chol = cholesky_nan(a)
    vector_rhs = b.ndim == a.ndim - 1
    x = torch.cholesky_solve(b[..., None] if vector_rhs else b, chol)
    return x[..., 0] if vector_rhs else x


def cholesky_guarded(p: torch.Tensor) -> torch.Tensor:
    """Cholesky factor with the WHOLE factor zeroed where it has a NaN
    (non-PSD or NaN input): sampling with it collapses onto the mean, the
    recovery of the reference's NaN guard (``cholesky_guarded`` in the JAX
    package zeroes on ``isnan``, and so does this)."""
    chol = cholesky_nan(p)
    bad = torch.isnan(chol).any(dim=-1, keepdim=True).any(dim=-2, keepdim=True)
    return torch.where(bad, torch.zeros_like(chol), chol)


# Newton–Schulz up to this size, eigh above, for the square root and the
# PSD projection (the JAX package's dispatch constant, kept here as the
# port's own copy).
_BLOCK_MAX = 128
_NS_ITERS = 14


def project_to_psd(delta: torch.Tensor) -> torch.Tensor:
    """Projection of a symmetric matrix onto the PSD cone (eigenvalue
    clamp), batched."""
    evals, evecs = torch.linalg.eigh(symmetrize(delta))
    projected = (evecs * evals.clamp_min(0.0)[..., None, :]) @ evecs.mT
    return symmetrize(projected)


def project_to_psd_ns(delta: torch.Tensor, num_iters: int = 16) -> torch.Tensor:
    """PSD projection by the polar form ``(A + (A²)^{1/2}) / 2`` with the
    Newton–Schulz root (``floor=1e-5`` keeps the iteration alive on a
    rounding-indefinite A²)."""
    a = symmetrize(delta)
    root = sqrtm_psd_ns(a @ a, num_iters, floor=1e-5)
    return symmetrize(0.5 * (a + root))


def project_to_psd_fast(delta: torch.Tensor) -> torch.Tensor:
    """PSD projection: the Newton–Schulz polar form up to ``_BLOCK_MAX``
    (the small matrices filters live on), the eigenvalue clamp above."""
    if delta.shape[-1] <= _BLOCK_MAX:
        return project_to_psd_ns(delta)
    return project_to_psd(delta)


def sqrtm_psd_eigh(p: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD square root by eigendecomposition, batched."""
    evals, evecs = torch.linalg.eigh(symmetrize(p))
    root = torch.sqrt(evals.clamp_min(0.0))
    return symmetrize((evecs * root[..., None, :]) @ evecs.mT)


def sqrtm_psd_ns(p: torch.Tensor, num_iters: int = _NS_ITERS,
                 floor: float = 0.0) -> torch.Tensor:
    """Symmetric PSD square root by the trace-normalised coupled
    Newton–Schulz iteration ``T = (3I − Z Y)/2, Y ← Y T, Z ← T Z``,
    batched. ``floor`` > 0 shifts the normalised spectrum up (see the JAX
    package's ``sqrtm_psd_ns``); the sigma-point path keeps it 0."""
    n = p.shape[-1]
    eye = torch.eye(n, dtype=p.dtype, device=p.device)
    p = symmetrize(p)
    s = torch.diagonal(p, dim1=-2, dim2=-1).sum(-1)[..., None, None] + 1e-30
    y = p / s + floor * eye
    z = eye.expand(p.shape)
    for _ in range(num_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y = y @ t
        z = t @ z
    return symmetrize(y * torch.sqrt(s))


def sqrtm_psd(p: torch.Tensor) -> torch.Tensor:
    """PSD square root: Newton–Schulz up to ``_BLOCK_MAX``, eigh above."""
    if p.shape[-1] <= _BLOCK_MAX:
        return sqrtm_psd_ns(p)
    return sqrtm_psd_eigh(p)


def tri_solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L x = b`` for lower-triangular ``L`` (batched); ``b`` is
    (..., n) or (..., n, k). The JAX package multiplies by the inverse, a
    TPU workaround; here it is the triangular solve."""
    vector_rhs = b.ndim == L.ndim - 1
    x = torch.linalg.solve_triangular(L, b[..., None] if vector_rhs else b,
                                      upper=False)
    return x[..., 0] if vector_rhs else x


def sandwich(f: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Congruence ``F P Fᵀ`` (batched)."""
    return f @ p @ f.mT


def matrix_projection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Frobenius projection of ``A`` on span(B): ``(tr(AᵀB) / tr(BᵀB)) B``."""
    return ((a * b).sum((-2, -1)) / (b * b).sum((-2, -1)))[..., None, None] * b


__all__ = ["symmetrize", "cholesky_nan", "psd_solve", "cholesky_guarded",
           "project_to_psd", "project_to_psd_ns", "project_to_psd_fast",
           "sqrtm_psd_eigh",
           "sqrtm_psd_ns", "sqrtm_psd", "tri_solve_lower", "sandwich",
           "matrix_projection"]
