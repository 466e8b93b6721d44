"""Resampling for the Gaussian-sum reduction and the bootstrap particle
filter (counterpart of ``bayesianfiltering_tpu/utils/resampling.py``).

Every resampler takes its uniforms ``u`` made beforehand or a
``torch.Generator``: multinomial and stratified draw (num_samples,)
uniforms, systematic one scalar, optimal resampling one per weight.
Everything is sorts, cumulative sums, sorted search and a counts→parents
inversion — no data-dependent shapes, so nothing synchronises with the
device. The inversion runs the CUDA kernel
K5 (``ops.resample_gather``) on CUDA tensors, at every size, and its plain
version, the scatter form, on CPU tensors. The JAX package's 2¹⁶ gate is
not kept: it sized the TPU kernel's window, and K5 has none.
"""
from __future__ import annotations

from typing import Optional

import torch


def effective_sample_size(weights: torch.Tensor) -> torch.Tensor:
    """ESS = 1 / Σ w² for normalized weights."""
    return 1.0 / torch.sum(weights * weights, dim=-1)


def _uniform(shape, like: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             u: Optional[torch.Tensor] = None) -> torch.Tensor:
    shape = tuple(shape)
    if u is not None:
        if tuple(u.shape) != shape:
            raise ValueError(f"uniforms have shape {tuple(u.shape)}, "
                             f"expected {shape}")
        return u.to(dtype=like.dtype, device=like.device)
    if generator is None:
        raise ValueError("pass a torch.Generator or the uniforms u")
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device)


def _cdf(weights: torch.Tensor) -> torch.Tensor:
    # A parallel cumsum can dip by an ulp; keep the CDF monotone, then
    # normalize against accumulated rounding.
    cdf = torch.cummax(torch.cumsum(weights, -1), -1).values
    return cdf / cdf[..., -1:]


def _inverse_cdf(weights: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Map uniform positions in [0, 1) to categorical indices."""
    idx = torch.searchsorted(_cdf(weights), positions, right=True)
    return idx.clamp(0, weights.shape[-1] - 1)


def _scatter_counts_to_parents(counts: torch.Tensor,
                               num_samples: int) -> torch.Tensor:
    """Expand cumulative child counts into a parent index per output slot:
    one scatter-add and one cumsum. A start equal to ``num_samples`` (a
    particle whose children fall past the end) is dropped, as JAX's
    ``mode="drop"`` does: it lands in a spill slot that is cut off."""
    starts = torch.cat([counts.new_zeros(1), counts[:-1]]).long()
    marker = torch.zeros(num_samples + 1, dtype=torch.long,
                         device=counts.device)
    marker.index_add_(0, starts.clamp(0, num_samples),
                      torch.ones_like(starts))
    return torch.cumsum(marker[:num_samples], 0) - 1


def _counts_to_parents(counts: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Expand cumulative child counts into a parent index per output slot,
    ``parent(j) = min{i : counts_i > j}``, as int64 indices like the other
    resamplers': K5 on CUDA tensors, the scatter form on CPU tensors
    (``ops.resample_gather.windowed_parents``)."""
    from bayesianfiltering_tpu_torch.ops.resample_gather import (
        windowed_parents,
    )

    return windowed_parents(counts, num_samples).long()


def multinomial_resample(weights, num_samples, generator=None, u=None):
    """IID categorical draws."""
    return _inverse_cdf(weights, _uniform((num_samples,), weights, generator,
                                          u))


def systematic_counts(weights, num_samples, generator=None, u=None):
    """Cumulative child counts of systematic resampling,
    ``counts_i = ceil(n·cdf_i − u0)``, monotone."""
    n = num_samples
    u0 = _uniform((), weights, generator, u)
    cdf = torch.cumsum(weights, -1)
    cdf = cdf / cdf[-1]
    return torch.cummax(torch.clamp(torch.ceil(n * cdf - u0), 0, n), 0).values


def systematic_resample(weights, num_samples, generator=None, u=None):
    """Systematic (low-variance) resampling: one uniform, a strided comb."""
    return _counts_to_parents(
        systematic_counts(weights, num_samples, generator, u), num_samples)


def stratified_counts(weights, num_samples, generator=None, u=None):
    """Cumulative child counts of stratified resampling, one uniform per
    stratum: ``c_i = ⌊n·cdf_i⌋ + [u_{⌊n·cdf_i⌋} < frac]``."""
    n = num_samples
    u = _uniform((n,), weights, generator, u)
    cdf = torch.cumsum(weights, -1)
    cdf = cdf / cdf[-1]
    t = n * cdf
    jstar = torch.floor(t).long()
    frac = t - jstar
    u_at = u[jstar.clamp(0, n - 1)]
    counts = torch.clamp(jstar + ((jstar < n) & (u_at < frac)).long(), 0, n)
    return torch.cummax(counts, 0).values


def stratified_resample(weights, num_samples, generator=None, u=None):
    """Stratified resampling: one uniform per stratum [j/n, (j+1)/n)."""
    return _counts_to_parents(
        stratified_counts(weights, num_samples, generator, u), num_samples)


_RESAMPLERS = {
    "multinomial": multinomial_resample,
    "systematic": systematic_resample,
    "stratified": stratified_resample,
}

# the cumulative-count cores of the counts-based resamplers (multinomial has
# no closed-form counts)
_COUNTS_FNS = {
    "systematic": systematic_counts,
    "stratified": stratified_counts,
}

# shape of the uniforms each resampler draws, given num_samples n and the
# number of weights m; optimal resampling draws one uniform per weight (one
# in all for n = 1), as the JAX package does
UNIFORM_SHAPES = {
    "multinomial": lambda n, m=None: (n,),
    "systematic": lambda n, m=None: (),
    "stratified": lambda n, m=None: (n,),
    "optimal": lambda n, m: (1,) if n == 1 else (m,),
}


def get_resampler(name: str):
    try:
        return _RESAMPLERS[name]
    except KeyError:
        raise ValueError(
            f"unknown resampler {name!r}; expected one of {sorted(_RESAMPLERS)}"
        ) from None


def get_counts_fn(name: str):
    """The cumulative-count core of a counts-based resampler, or None
    (multinomial)."""
    return _COUNTS_FNS.get(name)


def _resample(weights: torch.Tensor, particles: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              u: Optional[torch.Tensor] = None):
    """Full multinomial reset: uniform weights and the particles drawn in
    proportion to ``weights``, and the generator for what follows (the JAX
    package's follow-on key; None where the uniforms ``u`` were given)."""
    n = weights.shape[0]
    idx = multinomial_resample(weights, n, generator, u)
    uniform = weights.new_full((n,), 1.0 / n)
    return uniform, particles[idx], generator


def optimal_resampling(weights: torch.Tensor, N: int,
                       generator: Optional[torch.Generator] = None,
                       u: Optional[torch.Tensor] = None):
    """Fearnhead–Clifford (2003) optimal resampling of M weights to N ≤ M
    support points: the weights above a threshold p are kept, the rest of
    the mass is resampled multinomially into the other slots. Returns
    ``(indices (N,), weights (N,))``, the kept components last. ``u`` are
    the uniforms, :data:`UNIFORM_SHAPES` ``["optimal"](N, M)``.

    With the weights sorted ascending (stably, so that ties keep their
    order) and ``S(r)`` the sum of the r smallest, keeping the top k has the
    threshold ``p_k = S(M − k)/(N − k)``; the valid k has
    ``w_(M−k) < p_k < w_(M−k+1)``. Everything stays on the device."""
    M = weights.shape[0]
    if N == 1:
        # nothing can be kept deterministically: one multinomial draw
        idx = multinomial_resample(weights / weights.sum(), 1, generator, u)
        return idx, weights.new_ones(1)
    order = torch.argsort(weights, stable=True)
    sw = weights[order]
    csum = torch.cumsum(sw, 0)

    ks = torch.arange(1, N, device=weights.device)
    p_k = csum[M - ks - 1] / (N - ks).to(weights.dtype)
    valid = (sw[M - ks - 1] < p_k) & (p_k < sw[M - ks])
    L = torch.where(valid, ks, 0).sum()
    # an index past the end is clamped, as JAX's gather clamps it
    p = torch.where(L == 0, weights.new_tensor(1.0 / N),
                    p_k[(L - 1).clamp(0, N - 2)])

    below = sw < p
    res_w = torch.where(below, sw, 0.0)
    res_w = res_w / res_w.sum()
    draw = _inverse_cdf(res_w, _uniform((M,), weights, generator, u))
    final_idx = torch.where(below, order[draw], order)
    final_w = torch.where(below, p, sw)
    w_out = final_w[M - N:]
    return final_idx[M - N:], w_out / w_out.sum()


def resample(weights: torch.Tensor, num_samples: int,
             generator: Optional[torch.Generator] = None,
             u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multinomial resampling over a weight tensor of any rank: (num, ndim)
    indices into it."""
    flat = weights.reshape(-1)
    flat_idx = multinomial_resample(flat / flat.sum(), num_samples,
                                    generator, u)
    return torch.stack(torch.unravel_index(flat_idx, weights.shape), dim=-1)


def retain(weights: torch.Tensor, num_retained: int) -> torch.Tensor:
    """The ``num_retained`` largest weights as (num, ndim) indices, in
    ascending order of weight (ties: the lower flat index ranks higher, as
    ``jax.lax.top_k``)."""
    flat = weights.reshape(-1)
    top = torch.argsort(flat, descending=True, stable=True)[:num_retained]
    return torch.stack(torch.unravel_index(top.flip(0), weights.shape),
                       dim=-1)


def split_by_sampling(mean, cov, new_cov, num_comp: int,
                      generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``num_comp`` means drawn from N(mean, cov − new_cov); ``eps`` are
    the standard normals (num_comp, dx)."""
    from bayesianfiltering_tpu_torch.distributions import mvn_sample

    return mvn_sample(torch.atleast_1d(mean), torch.atleast_2d(cov - new_cov),
                      (num_comp,), generator, eps)


__all__ = [
    "effective_sample_size",
    "multinomial_resample",
    "systematic_counts",
    "systematic_resample",
    "stratified_counts",
    "stratified_resample",
    "get_resampler",
    "get_counts_fn",
    "UNIFORM_SHAPES",
    "_resample",
    "optimal_resampling",
    "resample",
    "retain",
    "split_by_sampling",
]
