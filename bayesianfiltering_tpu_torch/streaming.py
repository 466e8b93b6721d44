"""Streaming / chunked filtering with checkpointable carries
(counterpart of ``bayesianfiltering_tpu/streaming.py``).

Each filter family is exposed as an ``(init, step, run_chunk)`` triple over
a small carry, so a long run can be processed in chunks, the carry
checkpointed between them, and output storage bounded by the chunk length.

    stepper = make_gsf_stepper(params, num_components=8)
    state = stepper.init(torch.Generator(device="cuda").manual_seed(0))
    for chunk_emissions, chunk_inputs in stream:
        state, outputs = stepper.run_chunk(state, chunk_emissions,
                                           chunk_inputs, t0=t)
        save_state(path, state)

A step predicts the carried posterior of step t−1 with the input ``u_t``
(not at t = 0, where the carry is the prior), then conditions on ``y_t``:
the same posteriors as the whole-sequence filters. ``run_chunk`` is a loop
of steps. On CUDA tensors the EKF stepper runs K1/K2, the GSF stepper the
bank kernels K3/K4 (K1/K2 above their band, as
``inference.gaussian_sum_filter``), and the BPF stepper's systematic and
stratified resampling K5. The EKF stepper takes a leading batch of
sequences (B, T, dy), which stands for the JAX package's ``vmap``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from bayesianfiltering_tpu_torch.distributions import mvn_sample
from bayesianfiltering_tpu_torch.inference import (
    _init_mixture,
    _jacobians,
    _reweight,
    _slice_noise,
)
from bayesianfiltering_tpu_torch.models.params import ParamsBPF, ParamsNLSSM
from bayesianfiltering_tpu_torch.ops import bank_update as _bank
from bayesianfiltering_tpu_torch.ops import fused_ekf as _fused
from bayesianfiltering_tpu_torch.utils.resampling import (
    effective_sample_size,
    get_resampler,
)


class FilterStepper(NamedTuple):
    """A filter exposed as (init, step, run_chunk)."""

    init: Callable        # (generator=None, ...) -> state
    step: Callable        # (state, y, u, t) -> (state, outputs)
    run_chunk: Callable   # (state, emissions, inputs=None, t0=0) -> (state, outputs)


def _chunk_runner(step):
    def run_chunk(state, emissions, inputs=None, t0: int = 0, **per_step):
        """Steps t0 … t0+T−1 over ``emissions`` (T, ...) or, for a batch,
        (B, T, dy); the outputs are stacked along the time axis. Each
        keyword of ``per_step`` is a sequence indexed by the chunk's step
        and handed to ``step`` (the BPF's ``draws``)."""
        axis = 1 if emissions.ndim == 3 else 0
        T = emissions.shape[axis]
        if inputs is None:
            inputs = emissions.new_zeros(T, 1)
        outputs = []
        for i in range(T):
            kw = {k: v[i] for k, v in per_step.items() if v is not None}
            state, out = step(state, emissions.select(axis, i), inputs[i],
                              t0 + i, **kw)
            outputs.append(out)
        return state, {k: torch.stack([o[k] for o in outputs], dim=axis)
                       for k in outputs[0]}

    return run_chunk


class EKFState(NamedTuple):
    mean: torch.Tensor
    cov: torch.Tensor
    marginal_loglik: torch.Tensor


def make_ekf_stepper(params: ParamsNLSSM, num_iter: int = 1,
                     jitter: float = 0.0) -> FilterStepper:
    """Streaming EKF: the carry is the FILTERED (mean, cov, loglik) of one
    sequence, or of a batch once a step has seen emissions (B, dy).

    The step predicts with ``u_t`` and the dynamics noise of step t−1,
    then updates with the emission noise of step t: the same posterior as
    :func:`~bayesianfiltering_tpu_torch.inference.extended_kalman_filter`.
    """
    f, h, F_x, H_x, F_q, H_r = _jacobians(params)
    residual_fn = params.emission_residual

    def init(generator: Optional[torch.Generator] = None) -> EKFState:
        m0 = params.initial_mean
        return EKFState(m0, params.initial_covariance, m0.new_zeros(()))

    def step(state: EKFState, y, u, t: int):
        Q, q0, _, _ = _slice_noise(params, max(t - 1, 0))
        _, _, R, r0 = _slice_noise(params, t)
        batched = y.ndim == 2
        Y = y if batched else y[None]
        B, dx = Y.shape[0], state.mean.shape[-1]
        m = state.mean.expand(B, dx)
        P = state.cov.expand(B, dx, dx)
        if t > 0:
            m, P, _ = _fused.fused_ekf_predict(m, P, f, F_x, F_q, Q, q0, u)
        upd = _fused.fused_ekf_condition_on_iterated(
            m, P, h, H_x, H_r, R, r0, u, Y, num_iter, jitter, residual_fn)
        mean, cov, ll = upd.mean, upd.cov, upd.log_likelihood
        if not batched:
            mean, cov, ll = mean[0], cov[0], ll[0]
        new_state = EKFState(mean, cov, state.marginal_loglik + ll)
        return new_state, {"mean": mean, "cov": cov}

    return FilterStepper(init, step, _chunk_runner(step))


class GSFState(NamedTuple):
    weights: torch.Tensor
    means: torch.Tensor
    covs: torch.Tensor
    marginal_loglik: torch.Tensor


def make_gsf_stepper(params: ParamsNLSSM, num_components: int,
                     num_iter: int = 1, jitter: float = 0.0) -> FilterStepper:
    """Streaming Gaussian-sum filter: the carry is the whole mixture.
    ``init`` draws the initial means from a generator or takes their
    standard normals ``eps`` (M, dx)."""
    f, h, F_x, H_x, F_q, H_r = _jacobians(params)
    residual_fn = params.emission_residual

    def init(generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> GSFState:
        w, m, P = _init_mixture(params, num_components, generator, eps)
        return GSFState(w, m, P, m.new_zeros(()))

    def step(state: GSFState, y, u, t: int):
        Q, q0, _, _ = _slice_noise(params, max(t - 1, 0))
        _, _, R, r0 = _slice_noise(params, t)
        m, P = state.means, state.covs
        if t > 0:
            m, P, _ = _bank.bank_ekf_predict(m, P, f, F_x, F_q, Q, q0, u)
        upd = _bank.bank_ekf_condition_on_iterated(
            m, P, h, H_x, H_r, R, r0, u, y, num_iter, jitter, residual_fn)
        weights, step_ll = _reweight(upd.log_likelihood, state.weights)
        new_state = GSFState(weights, upd.mean, upd.cov,
                             state.marginal_loglik + step_ll)
        return new_state, {"weights": weights, "means": upd.mean,
                           "covs": upd.cov}

    return FilterStepper(init, step, _chunk_runner(step))


class BPFState(NamedTuple):
    """The particle bank and ``rng``, the state of the generator the steps
    draw from (``torch.Generator.get_state()``; empty where every step is
    handed its draws), so that a restored carry continues the same
    stream."""

    log_weights: torch.Tensor
    particles: torch.Tensor
    rng: torch.Tensor


def make_bpf_stepper(params: ParamsBPF, num_particles: int,
                     ess_threshold: float = 0.5,
                     resampler: str = "systematic") -> FilterStepper:
    """Streaming bootstrap PF: the carry is the particle bank.

    Every step, t = 0 included, propagates the particles with the dynamics
    noise of step t, reweights them, and resamples when the effective
    sample size falls below ``ess_threshold``·P (decided on the host). Its
    outputs are the ESS before the resampling and the mean of the bank
    after it, as ``inference.bootstrap_particle_filter(store="summary")``
    gives them (the JAX stepper weighs the resampled particles with the
    weights from before the resampling). The normals and uniforms come from the generator whose state the carry
    holds, or are handed to ``step`` as ``draws = (dynamics normals
    (P, dq), resampling uniforms)``; ``run_chunk`` takes them as
    ``draws=`` with a leading step axis on both.
    """
    P = int(num_particles)
    f = params.dynamics_function
    log_prob = params.emission_distribution_log_prob
    resample_fn = get_resampler(resampler)
    uniform = -math.log(P)

    def init(generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> BPFState:
        particles = mvn_sample(params.initial_mean,
                               params.initial_covariance, (P,), generator,
                               eps)
        rng = (generator.get_state() if generator is not None
               else torch.empty(0, dtype=torch.uint8))
        return BPFState(particles.new_full((P,), uniform), particles, rng)

    def step(state: BPFState, y, u, t: int, draws=None):
        Q, q0, _, _ = _slice_noise(params, t)
        gen = None
        if draws is None:
            gen = torch.Generator(device=state.particles.device)
            gen.set_state(state.rng)
        q = mvn_sample(q0, Q, (P,), gen, None if draws is None else draws[0])
        particles = f(state.particles, q, u)
        log_w = state.log_weights + log_prob(particles, y, u)
        log_w = log_w - torch.logsumexp(log_w, 0)
        w = torch.exp(log_w)
        ess = effective_sample_size(w)
        # the branch that does not resample passes the log weights through:
        # an exp/log round trip turns underflowed weights into -inf
        if bool(ess < ess_threshold * P):
            idx = resample_fn(w, P, gen, None if draws is None else draws[1])
            particles = particles[idx]
            log_w = torch.full_like(log_w, uniform)
            w = torch.exp(log_w)
        rng = state.rng if gen is None else gen.get_state()
        return BPFState(log_w, particles, rng), {"mean": w @ particles,
                                                 "ess": ess}

    return FilterStepper(init, step, _chunk_runner(step))


# ---------------------------------------------------------------------------
# Carry checkpointing
# ---------------------------------------------------------------------------

def save_state(path: str, state) -> None:
    """Checkpoint a filter carry (a NamedTuple of tensors) to the file
    ``path`` with ``torch.save``."""
    torch.save(state._asdict(), path)


def restore_state(path: str, like):
    """Restore a carry saved by :func:`save_state`; ``like`` is a carry of
    the same type whose tensors give the devices to restore onto."""
    fields = torch.load(path, map_location="cpu", weights_only=True)
    return type(like)(**{name: fields[name].to(getattr(like, name).device)
                         for name in like._fields})


__all__ = [
    "FilterStepper",
    "EKFState", "make_ekf_stepper",
    "GSFState", "make_gsf_stepper",
    "BPFState", "make_bpf_stepper",
    "save_state", "restore_state",
]
