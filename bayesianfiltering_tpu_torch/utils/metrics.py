"""Error metrics, mixture moments and divergences
(counterpart of ``bayesianfiltering_tpu/utils/metrics.py``).

``mse``/``rmse`` keep the reference's time-only normalisation,
``normal_KL_div`` its elementwise trace term; ``normal_kl`` is the textbook
KL.
"""
from __future__ import annotations

import math

import torch

from bayesianfiltering_tpu_torch.utils.linalg import cholesky_nan


def mse(x_est: torch.Tensor, x_base: torch.Tensor) -> torch.Tensor:
    """Sum of squared errors over all entries, divided by the leading (time)
    dimension only."""
    return ((x_est - x_base) ** 2).sum() / x_est.shape[0]


def rmse(x_est: torch.Tensor, x_base: torch.Tensor) -> torch.Tensor:
    """Root of :func:`mse`."""
    return torch.sqrt(mse(x_est, x_base))


def collapse(means: torch.Tensor, covariances: torch.Tensor,
             weights: torch.Tensor):
    """Moment-match a mixture ``(M, dx)``, ``(M, dx, dx)``, ``(M,)`` to one
    Gaussian; returns ``(mean, cov)``."""
    mean = torch.einsum("m,mi->i", weights, means)
    diff = means - mean
    cov = (torch.einsum("m,mij->ij", weights, covariances)
           + torch.einsum("m,mi,mj->ij", weights, diff, diff))
    return mean, cov


def normal_KL_div(mean1, mean2, cov1, cov2) -> torch.Tensor:
    """KL(N1 ‖ N2) with the reference's elementwise trace term
    ``trace(Ω ∘ cov1)``."""
    mean1, mean2 = torch.atleast_1d(mean1), torch.atleast_1d(mean2)
    cov1, cov2 = torch.atleast_2d(cov1), torch.atleast_2d(cov2)
    d = cov1.shape[-1]
    omega = torch.linalg.inv(cov2)
    diff = mean1 - mean2
    kl = (torch.log(torch.linalg.det(cov2) / torch.linalg.det(cov1)) - d
          + diff @ omega @ diff + torch.trace(omega * cov1))
    return kl / 2


def normal_kl(mean1, mean2, cov1, cov2) -> torch.Tensor:
    """Textbook KL(N1 ‖ N2) through Cholesky solves."""
    mean1, mean2 = torch.atleast_1d(mean1), torch.atleast_1d(mean2)
    cov1, cov2 = torch.atleast_2d(cov1), torch.atleast_2d(cov2)
    d = cov1.shape[-1]
    chol2, chol1 = cholesky_nan(cov2), cholesky_nan(cov1)
    z = torch.linalg.solve_triangular(chol2, (mean2 - mean1)[:, None],
                                      upper=False)[:, 0]
    sol = torch.cholesky_solve(cov1, chol2)
    logdet2 = 2.0 * torch.log(torch.diagonal(chol2)).sum()
    logdet1 = 2.0 * torch.log(torch.diagonal(chol1)).sum()
    return 0.5 * (torch.trace(sol) + z @ z - d + logdet2 - logdet1)


def W_distance(means, covs, particles, weights) -> torch.Tensor:
    """Mixture-vs-particles spread Σ_n Σ_i w_n (cov_n + (mean_n − x_i)²) /
    num_particles."""
    means = torch.atleast_1d(means)
    sq = (means[:, None] - particles[None, :]) ** 2
    per_n = covs[:, None] + sq
    per_n = per_n.sum(dim=tuple(range(2, per_n.ndim))) if per_n.ndim > 2 \
        else per_n
    return (weights[:, None] * per_n).sum() / particles.shape[0]


def gaussian_logpdf(y, m, S) -> torch.Tensor:
    """log N(y | m, S) for vectors given in any of the reference's shapes."""
    # imported here: distributions imports utils.linalg, and utils
    # re-exports this module
    from bayesianfiltering_tpu_torch.distributions import mvn_logpdf

    return mvn_logpdf(torch.atleast_1d(y).squeeze(), torch.atleast_1d(m).squeeze(),
                      torch.atleast_2d(S))


def gm(x, means, sigma, num_comp):
    """Scalar equal-weight Gaussian-mixture density."""
    means = torch.as_tensor(means)
    z = (x - means) / sigma
    pdfs = torch.exp(-0.5 * z ** 2) / (sigma * math.sqrt(2 * math.pi))
    return pdfs.sum() / num_comp


def loss(D, Pv, L, Nv, H) -> torch.Tensor:
    """The splitting-covariance objective."""
    return (2 * L ** 2 / Nv) * torch.trace(Pv - D) + 0.25 * torch.trace(D @ H) ** 2


def dec_to_base(num: int, base: int) -> str:
    """Integer base conversion, base ≤ 36."""
    if num <= 0:
        return ""
    digits = []
    while num > 0:
        dig = int(num % base)
        digits.append(str(dig) if dig < 10 else chr(ord("A") + dig - 10))
        num //= base
    return "".join(reversed(digits))


__all__ = ["mse", "rmse", "collapse", "normal_KL_div", "normal_kl",
           "W_distance", "gaussian_logpdf", "gm", "loss", "dec_to_base"]
