"""Monte-Carlo and linearization-augmented Monte-Carlo moments
(counterpart of ``bayesianfiltering_tpu/ops/slr.py``).

* :func:`mc_moments`: plain Monte-Carlo moments of a transform, the core
  of the reference's legacy MCF filter.
* :func:`mcla_moments`: particles from the deflated ``N(m, P − Δ)``, each
  with a local linearization of covariance Δ, the core of its legacy
  MCLAF filter and of the ALA estimators.

Each takes a ``torch.Generator`` or the standard normals ``eps``
(num_particles, dx) drawn beforehand. The transform and its Jacobian act
on one state and are evaluated over the particles with
``torch.func.vmap``. Plain PyTorch: the JAX package runs them in XLA, with
no kernel.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from bayesianfiltering_tpu_torch.distributions import standard_normal
from bayesianfiltering_tpu_torch.utils.linalg import cholesky_guarded, symmetrize


def _sample(m, P, num: int, generator, eps):
    chol = cholesky_guarded(P)
    eps = standard_normal((num, m.shape[-1]), m, generator, eps)
    return m + eps @ chol.T


def _transform(func, particles, num):
    trans = torch.func.vmap(func)(particles)
    return torch.atleast_2d(trans.reshape(num, -1))


def mc_moments(m: torch.Tensor, P: torch.Tensor, func: Callable,
               cov_add: torch.Tensor, num_particles: int,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Monte-Carlo moments of ``func`` under N(m, P): ``(mean_out,
    var_out, cov_out)`` with 1/N normalization and the additive noise
    covariance ``cov_add`` folded into ``var_out``."""
    particles = _sample(m, P, num_particles, generator, eps)
    trans = _transform(func, particles, num_particles)
    mean_out = trans.sum(0) / num_particles
    ct = trans - mean_out
    var_out = symmetrize(cov_add + ct.T @ ct / num_particles)
    cov_out = (particles - m).T @ ct / num_particles
    return mean_out, var_out, cov_out


def mcla_moments(m: torch.Tensor, P: torch.Tensor, func: Callable,
                 jacobian: Callable, cov_add: torch.Tensor,
                 delta: torch.Tensor, num_particles: int,
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Linearization-augmented Monte-Carlo moments: particles from
    ``N(m, P − Δ)``, each contributing ``J_n Δ J_nᵀ / N`` to the output
    variance and ``Δ Σ_n J_nᵀ / N`` to the cross-covariance."""
    particles = _sample(m, P - delta, num_particles, generator, eps)
    trans = _transform(func, particles, num_particles)
    grads = torch.func.vmap(jacobian)(particles).reshape(
        num_particles, trans.shape[-1], m.shape[-1])
    mean_out = trans.sum(0) / num_particles
    ct = trans - mean_out
    var_out = symmetrize(cov_add + ct.T @ ct / num_particles
                         + (grads @ delta @ grads.mT).sum(0) / num_particles)
    cov_out = ((particles - m).T @ ct / num_particles
               + delta @ grads.sum(0).T / num_particles)
    return mean_out, var_out, cov_out


__all__ = ["mc_moments", "mcla_moments"]
