"""Splitting-covariance selection by a projected fixed point
(counterpart of ``bayesianfiltering_tpu/utils/sdp.py``).

The AGSF picks a splitting covariance 0 ⪯ Δ ⪯ P that trades the
linearization error (small Δ) against the Monte-Carlo error (Δ close to
P). :func:`sdp_opt` and :func:`sdp_opt2` iterate the stationarity
condition of ``(β/N)·tr((P − Δ) JᵀJ) + (1/4)·Σ_i tr(Δ H_i)²`` with the
double PSD projection Δ ← P − proj(P − Δ), using the evidently intended
second-order operator ``Σ_i vec(H_i) vec(H_i)ᵀ`` over the output
dimension, as the JAX package does. :func:`sdp_opt_legacy` and
:func:`sdp_opt_test` are the legacy projected-gradient generation that the
legacy filters' selection modes call.

Every function takes one problem or a batch of them (leading axes of
``P``). A batch runs as the JAX package's ``vmap`` of its
``lax.while_loop`` runs: each problem stops updating once its own change
is at most ``tol`` (or after 100 iterations), and the loop ends when all
have stopped; the test is one read of a flag on the host per iteration.
"""
from __future__ import annotations

import torch

from bayesianfiltering_tpu_torch.utils.linalg import project_to_psd_fast

_MAX_ITERS = 100


def _second_order_operator(hessian: torch.Tensor, n: int,
                           batch) -> torch.Tensor:
    """``lhs = (1/4) Σ_i vec(H_i) vec(H_i)ᵀ + I`` over the output
    dimension, per problem: ``hessian`` holds (k, n, n) per problem in any
    layout that reshapes to it (the JAX package's ``atleast_3d``)."""
    vecs = hessian.reshape(batch + (-1, n * n))
    low_rank = vecs.mT @ vecs
    eye = torch.eye(n * n, dtype=hessian.dtype, device=hessian.device)
    return 0.25 * low_rank + eye


def _double_projection(delta: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Project onto {Δ : 0 ⪯ Δ ⪯ P} by alternating projections, with the
    Newton–Schulz PSD projection of the JAX package."""
    delta = project_to_psd_fast(delta)
    delta = p - project_to_psd_fast(p - delta)
    return project_to_psd_fast(delta)


def _fixed_point(lhs, aid, p, n, tol, max_iters=_MAX_ITERS):
    """Iterate ``vec Δ ← vec proj(lhs⁻¹ (aid + vec Δ))`` from Δ = 0 over a
    batch of problems (``lhs`` (B, n², n²), ``aid`` (B, n²), ``p``
    (B, n, n)); each stops once ``‖Δ_new − Δ‖ / n² ≤ tol`` or after
    ``max_iters`` iterations."""
    B = p.shape[0]
    vec = p.new_zeros(B, n * n)
    diff = p.new_ones(B)
    its = torch.zeros(B, dtype=torch.long, device=p.device)
    active = (diff > tol) & (its < max_iters)
    while bool(active.any()):
        # solve_ex: no synchronisation for an error check
        new = torch.linalg.solve_ex(lhs, aid + vec)[0]
        new = _double_projection(new.reshape(B, n, n), p).reshape(B, n * n)
        d = torch.linalg.norm(new - vec, dim=-1) / n ** 2
        vec = torch.where(active[:, None], new, vec)
        diff = torch.where(active, d, diff)
        its = its + active.long()
        active = (diff > tol) & (its < max_iters)
    return vec.reshape(B, n, n)


def _solve(state_dim, N, P, jacobian, hessian, scale, tol):
    n = int(state_dim)
    batch = P.shape[:-2]
    Pb = P.reshape(-1, n, n)
    J = jacobian.reshape(Pb.shape[:1] + (-1, n))
    lhs = _second_order_operator(hessian, n, Pb.shape[:1])
    aid = scale * (J.mT @ J).reshape(-1, n * n) / N
    return _fixed_point(lhs, aid, Pb, n, tol).reshape(batch + (n, n))


def sdp_opt(state_dim: int, N, P, jacobian, hessian, beta, tol: float = 0.1):
    """Fixed-point splitting-covariance solver: ``P`` (..., n, n), the
    Jacobian (..., dy, n) and the Hessian (..., dy, n, n) of the function
    at each mean; returns Δ (..., n, n). At most 100 iterations, so a
    non-contracting instance cannot loop for ever."""
    return _solve(state_dim, N, P, jacobian, hessian, beta, tol)


def sdp_opt2(state_dim: int, N, P, jacobian, hessian, alpha, eta=None,
             tol: float = 0.1):
    """The vanilla variant: :func:`sdp_opt` with ``alpha`` in place of
    ``beta``; ``eta`` is accepted and ignored (the reference's 8-argument
    call)."""
    return _solve(state_dim, N, P, jacobian, hessian, alpha, tol)


def gradient_descent(dim: int, N, L, X0, P, H, Nsteps: int, eta):
    """``Nsteps`` unprojected gradient steps on the splitting objective,
    ``X ← X − η (−(2L²/N) I + ½ tr(H X) H)``, over leading batch axes."""
    X = X0
    eye = torch.eye(dim, dtype=X0.dtype, device=X0.device)
    for _ in range(Nsteps):
        tr = torch.diagonal(H @ X, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        X = X - eta * (-(2.0 * L ** 2 / N) * eye + 0.5 * tr * H)
    return X


def sdp_opt_legacy(dim: int, N, L, X0, P, H, Nsteps: int, eta):
    """The legacy projected-gradient solver: ``Nsteps`` steps, the i-th a
    gradient step of size ``eta**i`` followed by the double projection onto
    {0 ⪯ X ⪯ P}. ``X0``, ``P`` and ``H`` may carry the same leading batch
    axes; returns X (..., dim, dim)."""
    X = X0
    for i in range(Nsteps):
        X = gradient_descent(dim, N, L, X, P, H, 1, eta ** i)
        X = _double_projection(X, P)
    return X.reshape(X.shape[:-2] + (dim, dim))


def sdp_opt_test(dim_in: int, dim_out: int, num_prt, lip, X0, cutoff_cov,
                 hess_array, Nsteps: int, eta):
    """The projected-gradient solver over a stack of Hessians, the legacy
    AGSF's "test" selection: ``hess_array`` (..., num_prt, dim_out, n, n),
    or (..., num_prt, n, n) for a scalar output, with the leading batch
    axes of ``X0``; ``Nsteps`` unprojected steps, then one double
    projection onto {0 ⪯ X ⪯ cutoff_cov}."""
    X = X0
    batch = X0.ndim - 2
    if hess_array.ndim == batch + 3:  # (num_prt, n, n): one output
        hess_array = hess_array[..., None, :, :]
    sum_hess = hess_array.sum(batch)  # (..., dim_out, n, n)
    eye = torch.eye(dim_in, dtype=X0.dtype, device=X0.device)
    for _ in range(Nsteps):
        coeffs = torch.diagonal(X[..., None, None, :, :] @ hess_array,
                                dim1=-2,
                                dim2=-1).sum(-1).sum(batch)  # (..., dim_out)
        term_two = torch.einsum("...j,...jab->...ab", coeffs, sum_hess)
        X = X - eta * (-(2.0 * lip ** 2 / num_prt) * eye
                       + 0.5 / num_prt ** 2 * term_two)
    return _double_projection(X, cutoff_cov)


__all__ = ["sdp_opt", "sdp_opt2", "gradient_descent", "sdp_opt_legacy",
           "sdp_opt_test"]
