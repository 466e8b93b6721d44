"""Particle-sharded bootstrap particle filter
(counterpart of ``bayesianfiltering_tpu/parallel/particle.py``).

The bank of P particles is split over the mesh axis, P/n a rank.
Propagation and weighting are local; every step the ranks exchange

* two all-reduces for the global normalisation (the largest log weight,
  then the sum of the shifted weights), one for the ESS and one for the
  weighted mean: a few bytes a step;
* and the resampling, in one of two modes:

  - ``"local"`` (default): when the global ESS falls below the threshold,
    each rank resamples its own bank systematically against its locally
    renormalised weights and keeps its mass (K5 on the card); no particle
    moves between ranks;
  - ``"gather"``: every step, the weights and particles are all-gathered
    and one systematic comb is drawn over the whole bank. Rank 0 computes
    the parents (K5 on the card) and broadcasts them, and every rank keeps
    its slice of the comb: the ranks cannot disagree on a count (a cumsum
    on the card may sum in another order from run to run).

Randomness, as the port's single-process filter: each rank takes its own
``torch.Generator``, or its own draws — a
:class:`~bayesianfiltering_tpu_torch.inference.BPFDraws` of its P/n
particles, whose ``resample`` (T,) are the rank's local combs in
``"local"`` mode and the global comb's uniforms in ``"gather"`` mode (read
on rank 0 only).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from bayesianfiltering_tpu_torch.distributions import mvn_sample
from bayesianfiltering_tpu_torch.inference import (
    BPFDraws,
    _process_input,
    _slice_noise,
)
from bayesianfiltering_tpu_torch.models.params import ParamsBPF
from bayesianfiltering_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    broadcast,
    pmax,
    psum,
)
from bayesianfiltering_tpu_torch.utils.resampling import systematic_resample


def _uniform(draws: Optional[BPFDraws], generator, t: int, like):
    if draws is not None:
        return draws.resample[t]
    return torch.rand((), generator=generator, dtype=like.dtype,
                      device=like.device)


def sharded_bootstrap_particle_filter(
    params: ParamsBPF,
    emissions: torch.Tensor,
    num_particles: int,
    mesh: Mesh,
    generator: Optional[torch.Generator] = None,
    inputs: Optional[torch.Tensor] = None,
    ess_threshold: float = 0.5,
    axis_name: str = "particle",
    resampling_mode: str = "local",
    draws: Optional[BPFDraws] = None,
) -> Dict[str, torch.Tensor]:
    """A bootstrap PF with its particle bank split over ``mesh``; every
    rank passes the whole ``emissions`` (T, dy).

    Returns ``{"means": (T, dx), "ess": (T,)}`` on every rank: the
    weighted mean and the ESS of the whole bank before each step's
    resampling. Raises ValueError when P does not divide over the axis or
    the mode is unknown."""
    if resampling_mode not in ("local", "gather"):
        raise ValueError(f"unknown resampling_mode {resampling_mode!r}; "
                         "expected 'local' or 'gather'")
    if draws is None and generator is None:
        raise ValueError("pass a torch.Generator or the draws")
    mesh.check_axis(axis_name)
    P = int(num_particles)
    start, stop = mesh.block(P, "num_particles")
    local_n = stop - start
    T = emissions.shape[0]
    f = params.dynamics_function
    log_prob = params.emission_distribution_log_prob
    inputs = _process_input(inputs, T, emissions)
    log_p_total = math.log(P)

    particles = mvn_sample(params.initial_mean, params.initial_covariance,
                           (local_n,), generator,
                           None if draws is None else draws.init)
    log_w = emissions.new_full((local_n,), -log_p_total)
    means, ess_out = [], []
    for t in range(T):
        Q, q0, _, _ = _slice_noise(params, t)
        u, y = inputs[t], emissions[t]
        q = mvn_sample(q0, Q, (local_n,), generator,
                       None if draws is None else draws.dynamics[t])
        particles = f(particles, q, u)
        log_w = log_w + log_prob(particles, y, u)

        # global normalisation: a shifted log-sum-exp over the ranks
        gmax = pmax(log_w.max(), mesh)
        total = psum(torch.exp(log_w - gmax).sum(), mesh)
        log_w = log_w - (torch.log(total) + gmax)
        w = torch.exp(log_w)
        ess = 1.0 / psum((w * w).sum(), mesh)
        means.append(psum(w @ particles, mesh))
        ess_out.append(ess)

        if resampling_mode == "gather":
            all_w = all_gather(w, mesh, tiled=True)
            all_p = all_gather(particles, mesh, tiled=True)
            if mesh.rank == 0:
                idx = systematic_resample(
                    all_w, P, u=_uniform(draws, generator, t, all_w))
            else:
                idx = torch.empty(P, dtype=torch.int64, device=w.device)
            idx = broadcast(idx, mesh)
            particles = all_p[idx[start:stop]]
            log_w = torch.full_like(log_w, -log_p_total)
        elif bool(ess < ess_threshold * P):
            # the rank's own comb over its renormalised weights; the kept
            # particles share the rank's mass
            local_logmass = torch.logsumexp(log_w, 0)
            local_w = torch.exp(log_w - local_logmass)
            local_w = torch.where(torch.isfinite(local_w), local_w,
                                  1.0 / local_n)
            idx = systematic_resample(
                local_w, local_n, u=_uniform(draws, generator, t, local_w))
            particles = particles[idx]
            log_w = torch.full_like(log_w, 0.0) + (local_logmass
                                                   - math.log(local_n))
    return {"means": torch.stack(means), "ess": torch.stack(ess_out)}


__all__ = ["sharded_bootstrap_particle_filter"]
