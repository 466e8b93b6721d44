"""Static (one-shot) augmented-joint-approximation utilities
(counterpart of ``bayesianfiltering_tpu/legacy/static_utils.py``):
``MixtureModel``, ``AugmentedJointApproximation`` (the one-shot ALA
posterior of a single observation, every particle in one batched pass) and
the ``plot_cov_ellipse`` helper, which needs matplotlib."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from bayesianfiltering_tpu_torch.distributions import mvn_logpdf, mvn_sample
from bayesianfiltering_tpu_torch.legacy.gaussfilt import (
    as_tensor,
    jacobian_fn,
)
from bayesianfiltering_tpu_torch.utils.linalg import psd_solve, symmetrize


class MixtureModel(NamedTuple):
    means: torch.Tensor
    covs: torch.Tensor
    weights: torch.Tensor


class AugmentedJointApproximation:
    """One-shot ALA posterior. Given y0 = f(x) + noise with x ~ N(mu,
    cov): particles from the deflated N(mu, cov − Δ); each particle x_n
    with J_n = f'(x_n) gives the component

        mean_n = x_n + Δ J_nᵀ (cov_tol + J_n Δ J_nᵀ)⁻¹ (y0 − f(x_n))
        cov_n  = cov − Δ J_nᵀ (…)⁻¹ J_n Δ
        w_n   ∝ N(y0; f(x_n), cov_tol + J_n Δ J_nᵀ)
    """

    def __init__(self, num_comp: int, f: Callable, dim_in: int, dim_out: int,
                 mu, cov, cov_tol, Delta, device=None):
        self.num_comp = num_comp
        self.f = f
        self.jacobian = jacobian_fn(f, dim_out, dim_in)
        self.dim_in = dim_in
        self.dim_out = dim_out
        self.mu = as_tensor(mu, device)
        self.cov = as_tensor(cov, device)
        self.cov_tol = as_tensor(cov_tol, device)
        self.Delta = as_tensor(Delta, device)

    def _sample_particles(self, generator: Optional[torch.Generator] = None,
                          eps=None):
        self.particles = mvn_sample(self.mu, self.cov - self.Delta,
                                    (self.num_comp,), generator, eps)
        return self.particles

    def return_posterior(self, y0, generator: Optional[torch.Generator] = None,
                         eps=None) -> Tuple[MixtureModel, torch.Tensor]:
        """Returns (the posterior mixture, the per-particle gradients (N,
        dx, dy)); ``eps`` (num_comp, dx) are the particles' standard
        normals."""
        particles = self._sample_particles(generator, eps)
        y0 = torch.atleast_1d(as_tensor(y0, self.mu.device))
        D = self.Delta
        J = torch.func.vmap(self.jacobian)(particles)  # (N, dy, dx)
        mu_y = torch.func.vmap(lambda x: torch.atleast_1d(self.f(x)))(
            particles)
        Sy = symmetrize(self.cov_tol + J @ D @ J.mT)
        gain = psd_solve(Sy, J @ D).mT  # Δ Jᵀ Sy⁻¹
        means = particles + (gain @ (y0 - mu_y)[..., None])[..., 0]
        covs = symmetrize(self.cov - gain @ J @ D)
        lls = mvn_logpdf(y0, mu_y, Sy)
        weights = torch.exp(lls - lls.max())
        weights = weights / weights.sum()
        return MixtureModel(means, covs, weights), J.mT


def plot_cov_ellipse(cov, pos, nstd: int = 2, ax=None, **kwargs):
    """Matplotlib n-sigma covariance ellipse."""
    import numpy as np

    try:
        import matplotlib.pyplot as plt
        from matplotlib.patches import Ellipse
    except ImportError as e:  # pragma: no cover
        raise ImportError("plot_cov_ellipse requires matplotlib") from e

    def eigsorted(cov):
        vals, vecs = np.linalg.eigh(cov)
        order = vals.argsort()[::-1]
        return vals[order], vecs[:, order]

    if isinstance(cov, torch.Tensor):
        cov = cov.detach().cpu().numpy()
    if isinstance(pos, torch.Tensor):
        pos = pos.detach().cpu().numpy()
    if ax is None:
        ax = plt.gca()
    vals, vecs = eigsorted(np.asarray(cov))
    theta = np.degrees(np.arctan2(*vecs[:, 0][::-1]))
    width, height = 2 * nstd * np.sqrt(vals)
    ellip = Ellipse(xy=pos, width=width, height=height, angle=theta, **kwargs)
    ax.add_artist(ellip)
    return ellip


__all__ = ["MixtureModel", "AugmentedJointApproximation", "plot_cov_ellipse"]
