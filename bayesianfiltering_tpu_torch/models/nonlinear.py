"""Nonlinear state-space model with sampling
(counterpart of ``NonlinearSSM`` in ``bayesianfiltering_tpu/models/nonlinear.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from bayesianfiltering_tpu_torch.distributions import mvn_sample, standard_normal
from bayesianfiltering_tpu_torch.models.params import ParamsNLSSM


class SampleDraws(NamedTuple):
    """Standard-normal draws behind one call of :meth:`NonlinearSSM.sample`:
    ``initial`` (*batch, dx), ``dynamics`` (*batch, T, dq),
    ``emission`` (*batch, T, dr)."""

    initial: torch.Tensor
    dynamics: torch.Tensor
    emission: torch.Tensor


class NonlinearSSM:
    """General non-additive-noise nonlinear SSM,
    ``x_t = f(x_{t-1}, q_t, u_t)``, ``y_t = h(x_t, r_t, u_t)``."""

    def __init__(self, state_dim: int, state_noise_dim: int,
                 emission_dim: int, emission_noise_dim: int):
        self.state_dim = state_dim
        self.state_noise_dim = state_noise_dim
        self.emission_dim = emission_dim
        self.emission_noise_dim = emission_noise_dim

    def sample(
        self,
        params: ParamsNLSSM,
        num_timesteps: int,
        inputs: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        draws: Optional[SampleDraws] = None,
        batch_shape: Sequence[int] = (),
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample ``batch_shape`` independent sequences of states and
        emissions, shapes (*batch, T, dx) and (*batch, T, dy).

        All noise is drawn up front, from ``generator`` or given as
        ``draws``; t=0 takes the initial-distribution draw and every later
        step ``x_t = f(x_{t-1}, q_t, u_t)``. ``inputs`` (T, ...) is shared
        by the batch. The model functions act on a trailing state axis.
        """
        f, h = params.dynamics_function, params.emission_function
        m0 = params.initial_mean
        batch = tuple(batch_shape)
        T = int(num_timesteps)
        if draws is None:
            draws = SampleDraws(
                standard_normal(batch + m0.shape[-1:], m0, generator),
                standard_normal(
                    batch + (T,) + params.dynamics_noise_bias.shape[-1:], m0,
                    generator),
                standard_normal(
                    batch + (T,) + params.emission_noise_bias.shape[-1:], m0,
                    generator),
            )
        x = mvn_sample(m0, params.initial_covariance, batch,
                       eps=draws.initial)
        dyn = mvn_sample(params.dynamics_noise_bias,
                         params.dynamics_noise_covariance, batch + (T,),
                         eps=draws.dynamics)
        obs = mvn_sample(params.emission_noise_bias,
                         params.emission_noise_covariance, batch + (T,),
                         eps=draws.emission)
        states, emissions = [], []
        for t in range(T):
            u_t = None if inputs is None else inputs[t]
            if t > 0:
                x = f(x, dyn[..., t, :], u_t)
            states.append(x)
            emissions.append(torch.atleast_1d(h(x, obs[..., t, :], u_t)))
        return torch.stack(states, dim=-2), torch.stack(emissions, dim=-2)


__all__ = ["NonlinearSSM", "SampleDraws"]
