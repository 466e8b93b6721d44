"""Multivariate-normal primitives
(counterpart of ``bayesianfiltering_tpu/distributions.py``).

Sampling takes either a ``torch.Generator`` or the standard-normal draws
``eps`` made beforehand (JAX's threefry streams cannot be reproduced in
torch, so parity tests hand JAX's draws over).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from bayesianfiltering_tpu_torch.utils.linalg import cholesky_nan

_LOG_2PI = math.log(2.0 * math.pi)


def mvn_logpdf(x: torch.Tensor, mean: torch.Tensor,
               cov: torch.Tensor) -> torch.Tensor:
    """Log-density of ``N(x | mean, cov)`` via Cholesky, batched over
    leading dimensions."""
    x = torch.atleast_1d(x)
    mean = torch.atleast_1d(mean)
    cov = torch.atleast_2d(cov)
    dim = x.shape[-1]
    chol = cholesky_nan(cov)
    diff = x - mean
    batch = torch.broadcast_shapes(diff.shape[:-1], chol.shape[:-2])
    z = torch.linalg.solve_triangular(
        chol.expand(batch + chol.shape[-2:]),
        diff.expand(batch + diff.shape[-1:])[..., None], upper=False)[..., 0]
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (dim * _LOG_2PI + logdet + (z * z).sum(-1))


def standard_normal(shape: Sequence[int], like: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``eps`` checked against ``shape``, or fresh draws from ``generator``
    in ``like``'s dtype and device."""
    shape = tuple(shape)
    if eps is not None:
        if tuple(eps.shape) != shape:
            raise ValueError(f"draws have shape {tuple(eps.shape)}, "
                             f"expected {shape}")
        return eps.to(dtype=like.dtype, device=like.device)
    if generator is None:
        raise ValueError("pass a torch.Generator or the draws made beforehand")
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def mvn_sample_chol(mean: torch.Tensor, chol: torch.Tensor,
                    shape: Sequence[int] = (),
                    generator: Optional[torch.Generator] = None,
                    eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample ``shape``-many draws given a Cholesky factor; ``eps`` has
    shape ``shape + batch + (dim,)``."""
    batch = torch.broadcast_shapes(mean.shape[:-1], chol.shape[:-2])
    eps = standard_normal(tuple(shape) + batch + mean.shape[-1:], mean,
                          generator, eps)
    return mean + (chol @ eps[..., None])[..., 0]


def mvn_sample(mean: torch.Tensor, cov: torch.Tensor,
               shape: Sequence[int] = (),
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw ``shape``-many samples from ``N(mean, cov)`` via Cholesky."""
    mean = torch.atleast_1d(mean)
    cov = torch.atleast_2d(cov)
    return mvn_sample_chol(mean, cholesky_nan(cov), shape, generator, eps)


__all__ = ["mvn_logpdf", "mvn_sample", "mvn_sample_chol", "standard_normal"]
