"""Gaussian mixtures as struct-of-arrays, with splitting and reduction
(counterpart of ``bayesianfiltering_tpu/containers.py``).

Splitting a component into N children samples their means from
``N(m, P − Δ)`` and gives each covariance Δ and weight w/N (the AGSF
"augmentation"); a non-PSD ``P − Δ`` zeroes the factor, which collapses
the children onto the parent mean.

The list-of-components helpers (:class:`GaussianComponent`,
``_gaussian_sum_to_components``, ``_branches_from_tree1/2`` and the
constants ``num_prt1``/``num_prt2``) are compatibility shims for code
written against the reference's API; no filter uses them.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from bayesianfiltering_tpu_torch.distributions import standard_normal
from bayesianfiltering_tpu_torch.utils import resampling as rs
from bayesianfiltering_tpu_torch.utils.linalg import cholesky_guarded

# the reference's module-level split sizes; the filters here take the
# split counts as arguments, these exist so that reference code imports
num_prt1 = 2
num_prt2 = 2


class GaussianComponent(NamedTuple):
    """One mixture component."""

    mean: torch.Tensor
    covariance: torch.Tensor
    weight: torch.Tensor


class GaussianSum(NamedTuple):
    """``means`` (M, dx), ``covariances`` (M, dx, dx), ``weights`` (M,)."""

    means: torch.Tensor
    covariances: torch.Tensor
    weights: torch.Tensor

    @property
    def num_components(self) -> int:
        return self.means.shape[0]

    @property
    def state_dim(self) -> int:
        return self.means.shape[-1]

    def _check_normalization(self) -> torch.Tensor:
        total = self.weights.sum()
        return torch.isclose(total, torch.ones_like(total))

    def _sum_weights(self) -> torch.Tensor:
        return self.weights.sum()

    def normalize(self) -> "GaussianSum":
        return self._replace(weights=self.weights / self.weights.sum())

    def collapse(self):
        """Moment-match the mixture to one Gaussian: (mean, cov)."""
        from bayesianfiltering_tpu_torch.utils.metrics import collapse

        return collapse(self.means, self.covariances, self.weights)


def gaussian_sum(means, covariances, weights) -> GaussianSum:
    """A :class:`GaussianSum` from tensors or sequences of them, stacked as
    needed."""
    if not isinstance(means, torch.Tensor):
        means = torch.stack(list(means))
    if not isinstance(covariances, torch.Tensor):
        covariances = torch.stack(list(covariances))
    if not isinstance(weights, torch.Tensor):
        weights = torch.stack([torch.as_tensor(w) for w in weights])
    return GaussianSum(means, covariances, weights)


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
    """Reduce a mixture to ``num_keep`` components.

    ``method``: "multinomial", "systematic", "stratified" (weight-
    proportional resampling, uniform output weights), "topk" (the heaviest
    components, uniform output weights) or "optimal" (Fearnhead–Clifford:
    the heavy components kept, the light ones resampled, the weights
    :func:`~bayesianfiltering_tpu_torch.utils.resampling.optimal_resampling`
    returns). ``u`` are the uniforms, see
    :data:`~bayesianfiltering_tpu_torch.utils.resampling.UNIFORM_SHAPES`.
    """
    idx, weights = reduction_indices(mixture.weights, num_keep, method,
                                     generator, u)
    return GaussianSum(mixture.means[idx], mixture.covariances[idx], weights)


def reduction_indices(weights: torch.Tensor, num_keep: int,
                      method: str = "multinomial",
                      generator: Optional[torch.Generator] = None,
                      u: Optional[torch.Tensor] = None):
    """The components :func:`reduce_gaussian_sum` keeps of a mixture with
    these ``weights``, and their new weights: ``(indices (num_keep,),
    weights (num_keep,))``."""
    if method in ("multinomial", "systematic", "stratified"):
        idx = rs.get_resampler(method)(weights, num_keep, generator, u)
        kept = weights.new_full((num_keep,), 1.0 / num_keep)
    elif method == "topk":
        idx = torch.topk(weights, num_keep).indices
        kept = weights.new_full((num_keep,), 1.0 / num_keep)
    elif method == "optimal":
        idx, kept = rs.optimal_resampling(weights, num_keep, generator, u)
    else:
        raise ValueError(f"unknown reduction method {method!r}")
    # every resampler yields indices in range by construction; the clamp
    # keeps a gather on the device from faulting if that ever broke
    return idx.clamp(0, weights.shape[0] - 1), kept


# ---------------------------------------------------------------------------
# Reference-compatibility shims (list-of-components API)
# ---------------------------------------------------------------------------

def _gaussian_sum_to_components(mixture) -> List[GaussianComponent]:
    """The mixture as a list of components."""
    means, covs, weights = mixture.means, mixture.covariances, mixture.weights
    return [GaussianComponent(means[i], covs[i], weights[i])
            for i in range(len(means))]


def _components_to_gaussian_sum(
        components: Sequence[GaussianComponent]) -> GaussianSum:
    """A component list stacked into struct-of-arrays form."""
    return gaussian_sum([c.mean for c in components],
                        [c.covariance for c in components],
                        [c.weight for c in components])


def _branches_from_node(node_component: GaussianComponent,
                        splitting_cov: torch.Tensor, num_particles: int,
                        generator: Optional[torch.Generator] = None,
                        eps: Optional[torch.Tensor] = None
                        ) -> List[GaussianComponent]:
    """Split one component into ``num_particles`` children; ``eps`` are
    the standard normals (1, num_particles, dx)."""
    mean = node_component.mean
    parent = GaussianSum(mean[None], node_component.covariance[None],
                         torch.as_tensor(node_component.weight).to(mean)[None])
    child = split_gaussian_sum(parent, splitting_cov[None], int(num_particles),
                               generator, eps)
    return _gaussian_sum_to_components(child)


def _branches_from_tree(components: Sequence[GaussianComponent],
                        split_covs_array, num_branch_array,
                        generator: Optional[torch.Generator] = None,
                        eps: Optional[Sequence[torch.Tensor]] = None):
    """Split every component; a list of child lists. ``eps`` holds the
    standard normals of each component's split, (1, n_i, dx) each."""
    eps = [None] * len(components) if eps is None else list(eps)
    return [_branches_from_node(c, torch.as_tensor(d), int(n), generator, e)
            for c, d, n, e in zip(components, split_covs_array,
                                  num_branch_array, eps)]


# the reference's two copies differ only in a module constant that
# overrides the split count; with the override gone one serves both names
_branches_from_node1 = _branches_from_node
_branches_from_node2 = _branches_from_node
_branches_from_tree1 = _branches_from_tree
_branches_from_tree2 = _branches_from_tree

__all__ = [
    "GaussianComponent",
    "GaussianSum",
    "gaussian_sum",
    "split_gaussian_sum",
    "reduce_gaussian_sum",
    "reduction_indices",
    "num_prt1",
    "num_prt2",
    "_gaussian_sum_to_components",
    "_components_to_gaussian_sum",
    "_branches_from_node1",
    "_branches_from_node2",
    "_branches_from_tree1",
    "_branches_from_tree2",
]
