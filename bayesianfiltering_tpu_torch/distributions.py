"""Multivariate-normal primitives
(counterpart of ``bayesianfiltering_tpu/distributions.py``).

Sampling takes either a ``torch.Generator`` or the standard-normal draws
``eps`` made beforehand (JAX's threefry streams cannot be reproduced in
torch, so parity tests hand JAX's draws over).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

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
    # invert the factor and multiply: for one factor shared by the batch
    # the product folds into a single GEMM (a triangular solve with a
    # million right-hand sides, a particle filter's likelihoods, took
    # seconds per call on an H100)
    eye = torch.eye(dim, dtype=chol.dtype, device=chol.device)
    linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    z = ((x - mean)[..., None, :] @ linv.mT)[..., 0, :]
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
    return mean + (eps[..., None, :] @ chol.mT)[..., 0, :]


def mvn_sample(mean: torch.Tensor, cov: torch.Tensor,
               shape: Sequence[int] = (),
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw ``shape``-many samples from ``N(mean, cov)`` via Cholesky."""
    mean = torch.atleast_1d(mean)
    cov = torch.atleast_2d(cov)
    return mvn_sample_chol(mean, cholesky_nan(cov), shape, generator, eps)


class MVN:
    """Multivariate normal with a full covariance: the subset of
    ``MultivariateNormalFullCovariance`` the reference uses (construction
    from ``(loc, covariance_matrix)``, ``sample``, ``log_prob``)."""

    def __init__(self, loc: torch.Tensor = None,
                 covariance_matrix: torch.Tensor = None):
        if loc is None or covariance_matrix is None:
            raise ValueError("MVN requires loc and covariance_matrix")
        self.loc = torch.atleast_1d(loc)
        self.covariance_matrix = torch.atleast_2d(covariance_matrix)

    def sample(self, sample_shape: Union[int, Sequence[int]] = (),
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Draws from ``generator`` or from the standard normals ``eps``
        (shape ``sample_shape + batch + (dim,)``); one of them is
        required."""
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        return mvn_sample(self.loc, self.covariance_matrix,
                          tuple(sample_shape), generator, eps)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return mvn_logpdf(x, self.loc, self.covariance_matrix)

    def mean(self) -> torch.Tensor:
        return self.loc

    def covariance(self) -> torch.Tensor:
        return self.covariance_matrix


MultivariateNormalFullCovariance = MVN

__all__ = ["mvn_logpdf", "mvn_sample", "mvn_sample_chol", "standard_normal",
           "MVN", "MultivariateNormalFullCovariance"]
