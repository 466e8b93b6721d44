"""Sigma points of the unscented transform
(counterpart of ``bayesianfiltering_tpu/utils/sigma_points.py``).

Every function takes leading batch axes: ``m`` (..., n), ``P`` (..., n, n).
``method="sqrtm"`` builds the points from the Newton–Schulz PSD square
root (as the JAX package does), ``method="cholesky"`` from the Cholesky
factor, NaN where P is not positive definite (JAX's contract on the CPU).
"""
from __future__ import annotations

import math

import torch

from bayesianfiltering_tpu_torch.utils.linalg import cholesky_nan, sqrtm_psd


def factor(P: torch.Tensor, method: str) -> torch.Tensor:
    """The sigma-point factor of ``P``: Cholesky or the PSD square root."""
    if method == "cholesky":
        return cholesky_nan(P)
    if method == "sqrtm":
        return sqrtm_psd(P)
    raise ValueError(f"unknown sqrt_method {method!r}")


def points_from_factor(mean: torch.Tensor, fac: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """``[mean + scale·facᵀ; mean − scale·facᵀ]``, shape (..., 2n, n): row
    i of each half is a scaled column of the factor."""
    off = scale * fac.mT
    mean = mean[..., None, :]
    return torch.cat([mean + off, mean - off], dim=-2)


def sigma_points(m: torch.Tensor, P: torch.Tensor, lamda,
                 method: str = "sqrtm") -> torch.Tensor:
    """2n sigma points ``m ± sqrt(n+λ) s_i`` (no center point), shape
    (..., 2n, n)."""
    n = m.shape[-1]
    return points_from_factor(m, factor(P, method), math.sqrt(n + lamda))


_get_sigma_points = sigma_points


def points_blockdiag(m: torch.Tensor, P: torch.Tensor, bias: torch.Tensor,
                     C: torch.Tensor, scale: float,
                     method: str = "sqrtm") -> torch.Tensor:
    """``[mA + off; mA − off]`` with ``mA = [m; bias]`` and ``off`` the
    block-diagonal of ``scale·F(P)ᵀ`` and ``scale·F(C)ᵀ``, shape
    (..., 2na, na), na = dx + dn. ``bias`` (dn,) and ``C`` (dn, dn) may be
    shared by the batch of ``m`` (..., dx)."""
    dx, dn = m.shape[-1], bias.shape[-1]
    batch = torch.broadcast_shapes(m.shape[:-1], P.shape[:-2])
    offx = (scale * factor(P, method).mT).expand(batch + (dx, dx))
    offn = (scale * factor(C, method).mT).expand(batch + (dn, dn))
    off = torch.cat([
        torch.cat([offx, offx.new_zeros(batch + (dx, dn))], dim=-1),
        torch.cat([offn.new_zeros(batch + (dn, dx)), offn], dim=-1),
    ], dim=-2)
    mA = torch.cat([m.expand(batch + (dx,)), bias.expand(batch + (dn,))],
                   dim=-1)[..., None, :]
    return torch.cat([mA + off, mA - off], dim=-2)


def sigma_points_blockdiag(m: torch.Tensor, P: torch.Tensor,
                           bias: torch.Tensor, C: torch.Tensor, lamda,
                           method: str = "sqrtm") -> torch.Tensor:
    """2·(dx+dn) sigma points of ``N([m; bias], blkdiag(P, C))`` with the
    factor built block-wise (the same points as the augmented matrix's,
    factoring dx² + dn² instead of (dx+dn)²), shape (..., 2na, na)."""
    na = m.shape[-1] + bias.shape[-1]
    return points_blockdiag(m, P, bias, C, math.sqrt(na + lamda), method)


def split_to_sigma_points(mean: torch.Tensor, cov: torch.Tensor,
                          lamda) -> torch.Tensor:
    """2n+1 sigma points, center first, from Cholesky columns (the legacy
    UKF), shape (..., 2n+1, n)."""
    mean = torch.atleast_1d(mean)
    cov = torch.atleast_2d(cov)
    n = mean.shape[-1]
    pts = points_from_factor(mean, cholesky_nan(cov), math.sqrt(n + lamda))
    return torch.cat([mean[..., None, :].expand(pts.shape[:-2] + (1, n)),
                      pts], dim=-2)


def unscented_weights(n: int, alpha: float, beta: float, kappa: float,
                      dtype: torch.dtype = torch.float64, device=None):
    """``(λ, w_mean, w_cov)``: the textbook UT weights for 2n+1 points,
    center first."""
    lamda = alpha ** 2 * (n + kappa) - n
    side = 1.0 / (2.0 * (n + lamda))
    w_mean = torch.full((2 * n + 1,), side, dtype=dtype, device=device)
    w_mean[0] = lamda / (n + lamda)
    w_cov = w_mean.clone()
    w_cov[0] += 1.0 - alpha ** 2 + beta
    return lamda, w_mean, w_cov


__all__ = ["sigma_points", "_get_sigma_points", "sigma_points_blockdiag",
           "split_to_sigma_points", "unscented_weights", "factor",
           "points_from_factor", "points_blockdiag"]
