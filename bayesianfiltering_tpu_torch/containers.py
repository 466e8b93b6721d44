"""Gaussian mixtures as struct-of-arrays, with splitting and reduction
(counterpart of ``bayesianfiltering_tpu/containers.py``).

Splitting a component into N children samples their means from
``N(m, P − Δ)`` and gives each covariance Δ and weight w/N (the AGSF
"augmentation"); a non-PSD ``P − Δ`` zeroes the factor, which collapses
the children onto the parent mean.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from bayesianfiltering_tpu_torch.distributions import standard_normal
from bayesianfiltering_tpu_torch.utils import resampling as rs
from bayesianfiltering_tpu_torch.utils.linalg import cholesky_guarded


class GaussianSum(NamedTuple):
    """``means`` (M, dx), ``covariances`` (M, dx, dx), ``weights`` (M,)."""

    means: torch.Tensor
    covariances: torch.Tensor
    weights: torch.Tensor

    @property
    def num_components(self) -> int:
        return self.means.shape[0]


def split_gaussian_sum(mixture: GaussianSum, split_covs: torch.Tensor,
                       num_splits: int,
                       generator: Optional[torch.Generator] = None,
                       eps: Optional[torch.Tensor] = None) -> GaussianSum:
    """Branch every component into ``num_splits`` children (contiguous per
    parent). ``eps`` are the standard normals, shape (M, num_splits, dx)."""
    M, dx = mixture.means.shape
    chol = cholesky_guarded(mixture.covariances - split_covs)
    eps = standard_normal((M, num_splits, dx), mixture.means, generator, eps)
    child_means = mixture.means[:, None, :] + (chol[:, None] @ eps[..., None])[..., 0]
    return GaussianSum(
        child_means.reshape(M * num_splits, dx),
        split_covs[:, None].expand(M, num_splits, dx, dx).reshape(
            M * num_splits, dx, dx),
        (mixture.weights / num_splits)[:, None].expand(M, num_splits).reshape(
            M * num_splits),
    )


def reduce_gaussian_sum(mixture: GaussianSum, num_keep: int,
                        method: str = "multinomial",
                        generator: Optional[torch.Generator] = None,
                        u: Optional[torch.Tensor] = None) -> GaussianSum:
    """Reduce a mixture to ``num_keep`` components with uniform weights.

    ``method``: "multinomial", "systematic", "stratified" (weight-
    proportional resampling; ``u`` are its uniforms, see
    :data:`~bayesianfiltering_tpu_torch.utils.resampling.UNIFORM_SHAPES`)
    or "topk" (the heaviest components). "optimal" is not ported yet.
    """
    if method in ("multinomial", "systematic", "stratified"):
        idx = rs.get_resampler(method)(mixture.weights, num_keep, generator, u)
    elif method == "topk":
        idx = torch.topk(mixture.weights, num_keep).indices
    elif method == "optimal":
        raise NotImplementedError("optimal reduction is not ported yet")
    else:
        raise ValueError(f"unknown reduction method {method!r}")
    # every resampler yields indices in range by construction; the clamp
    # keeps a gather on the device from faulting if that ever broke
    idx = idx.clamp(0, mixture.num_components - 1)
    weights = mixture.weights.new_full((num_keep,), 1.0 / num_keep)
    return GaussianSum(mixture.means[idx], mixture.covariances[idx], weights)


__all__ = ["GaussianSum", "split_gaussian_sum", "reduce_gaussian_sum"]
