"""Dense linear-algebra primitives
(counterpart of ``bayesianfiltering_tpu/utils/linalg.py``).

The JAX package's blocked and unrolled factorizations exist because XLA
lowers batched Cholesky and triangular solves to sequential loops on the
TPU; here the library factorizations are used directly. One difference in
contract is bridged: ``jnp.linalg.cholesky`` returns NaN for an input that
is not positive definite, where ``torch.linalg.cholesky`` raises.
:func:`cholesky_nan` restores the NaN contract from ``cholesky_ex``'s
``info``.
"""
from __future__ import annotations

import torch


def symmetrize(a: torch.Tensor) -> torch.Tensor:
    """Symmetric part ``(A + Aᵀ)/2`` (batched)."""
    return 0.5 * (a + a.mT)


def cholesky_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN wherever the matrix is not positive
    definite (JAX's contract; never raises, never synchronises)."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info != 0)[..., None, None],
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


__all__ = ["symmetrize", "cholesky_nan", "psd_solve", "cholesky_guarded"]
