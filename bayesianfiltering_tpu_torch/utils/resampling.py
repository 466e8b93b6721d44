"""Resampling for the Gaussian-sum reduction and the bootstrap particle
filter (counterpart of ``bayesianfiltering_tpu/utils/resampling.py``).

Every resampler takes its uniforms ``u`` made beforehand or a
``torch.Generator``: multinomial and stratified draw (num_samples,)
uniforms, systematic one scalar. Everything is cumulative sums, sorted
search and a counts→parents inversion — no data-dependent shapes, so
nothing synchronises with the device. The inversion runs the CUDA kernel
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

# shape of the uniforms each resampler draws, given num_samples
UNIFORM_SHAPES = {
    "multinomial": lambda n: (n,),
    "systematic": lambda n: (),
    "stratified": lambda n: (n,),
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
]
