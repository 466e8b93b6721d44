"""Abstract state-space-model base class
(counterpart of ``bayesianfiltering_tpu/models/ssm.py``).

Subclasses implement the distribution accessors and the shape properties
and inherit ancestral sampling, the joint log-probability and the EM and
SGD fitting drivers. Where the JAX package vmaps the E-step and the
marginal log-likelihood over a batch of sequences, here ``e_step`` and
``marginal_log_prob`` take the batch (B, T, ...) themselves.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from typing_extensions import Protocol

from bayesianfiltering_tpu_torch.models._fit import (
    adam,
    ensure_array_has_batch_dim,
    run_sgd,
)
from bayesianfiltering_tpu_torch.models.parameters import (
    ParameterSet,
    PropertySet,
    from_unconstrained,
    to_unconstrained,
)
from bayesianfiltering_tpu_torch.types import Scalar


class Posterior(Protocol):
    """NamedTuple of posterior tensors."""


class SuffStatsSSM(Protocol):
    """NamedTuple of sufficient statistics."""


class SampleDraws(NamedTuple):
    """Standard-normal draws behind one call of ``sample``: ``initial``
    (*batch, dx), ``dynamics`` (*batch, T, dq), ``emission``
    (*batch, T, dr). The generic :meth:`SSM.sample` draws one sequence and
    uses ``dynamics[0]`` for nothing (t = 0 takes the initial draw)."""

    initial: torch.Tensor
    dynamics: torch.Tensor
    emission: torch.Tensor


def _at(inputs, t):
    return None if inputs is None else inputs[t]


class SSM(ABC):
    r"""Base class for state-space models.

    Subclasses implement ``initial_distribution`` /
    ``transition_distribution`` / ``emission_distribution`` (objects with
    ``.sample(generator=, eps=)`` and ``.log_prob``) and the shape
    properties.
    """

    # -- abstract distribution accessors ---------------------------------
    @abstractmethod
    def initial_distribution(self, params: ParameterSet, inputs=None):
        raise NotImplementedError

    @abstractmethod
    def transition_distribution(self, params: ParameterSet, state,
                                inputs=None):
        raise NotImplementedError

    @abstractmethod
    def emission_distribution(self, params: ParameterSet, state, inputs=None):
        raise NotImplementedError

    def log_prior(self, params: ParameterSet) -> Scalar:
        return 0.0

    @property
    @abstractmethod
    def emission_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    @property
    def inputs_shape(self) -> Optional[Tuple[int, ...]]:
        return None

    # -- sampling and log probability ------------------------------------
    def sample(self, params: ParameterSet, num_timesteps: int, inputs=None,
               generator: Optional[torch.Generator] = None,
               draws: Optional[SampleDraws] = None):
        """Sample one sequence (states (T, dx), emissions (T, dy)) by
        ancestral sampling: t = 0 from the initial distribution, every
        later state from the transition; each emission from the emission
        distribution. The standard normals come from ``generator`` or are
        handed in as ``draws``."""
        def eps(name, t=None):
            if draws is None:
                return None
            d = getattr(draws, name)
            return d if t is None else d[t]

        x = self.initial_distribution(params, _at(inputs, 0)).sample(
            generator=generator, eps=eps("initial"))
        states, emissions = [], []
        for t in range(int(num_timesteps)):
            u = _at(inputs, t)
            if t > 0:
                x = self.transition_distribution(params, x, u).sample(
                    generator=generator, eps=eps("dynamics", t))
            y = self.emission_distribution(params, x, u).sample(
                generator=generator, eps=eps("emission", t))
            states.append(x)
            emissions.append(y)
        return torch.stack(states), torch.stack(emissions)

    def log_prob(self, params: ParameterSet, states, emissions,
                 inputs=None) -> Scalar:
        """Joint log p(x_{1:T}, y_{1:T}) of one sequence: the per-step
        log-densities, summed once at the end."""
        steps = []
        for t in range(states.shape[0]):
            u = _at(inputs, t)
            prior = (self.initial_distribution(params, u) if t == 0 else
                     self.transition_distribution(params, states[t - 1], u))
            steps.append(
                prior.log_prob(states[t])
                + self.emission_distribution(params, states[t], u).log_prob(
                    emissions[t]))
        return torch.stack(steps).sum()

    # -- inference hooks (overridden by concrete models) ------------------
    def marginal_log_prob(self, params: ParameterSet, emissions,
                          inputs=None) -> Scalar:
        raise NotImplementedError

    def filter(self, params: ParameterSet, emissions, inputs=None) -> Posterior:
        raise NotImplementedError

    def smoother(self, params: ParameterSet, emissions,
                 inputs=None) -> Posterior:
        raise NotImplementedError

    # -- learning ----------------------------------------------------------
    def e_step(self, params: ParameterSet, emissions, inputs=None):
        raise NotImplementedError

    def m_step(self, params: ParameterSet, props: PropertySet, batch_stats,
               m_step_state):
        raise NotImplementedError

    def initialize_m_step_state(self, params: ParameterSet,
                                props: PropertySet) -> Any:
        return None

    def fit_em(
        self,
        params: ParameterSet,
        props: PropertySet,
        emissions,
        inputs=None,
        num_iters: int = 50,
        verbose: bool = True,
    ):
        """EM: each iteration runs the E-step on the batch of sequences
        (B, T, dy) at once and the closed-form M-step on the summed
        statistics. Returns the fitted params and the log-probability of
        each iteration's E-step (the params it started from)."""
        batch_emissions = ensure_array_has_batch_dim(emissions,
                                                     self.emission_shape)
        batch_inputs = ensure_array_has_batch_dim(inputs, self.inputs_shape)
        log_probs = []
        m_step_state = self.initialize_m_step_state(params, props)
        for it in range(num_iters):
            batch_stats, lls = self.e_step(params, batch_emissions,
                                           batch_inputs)
            lp = self.log_prior(params) + lls.sum()
            params, m_step_state = self.m_step(params, props, batch_stats,
                                               m_step_state)
            log_probs.append(lp)
            if verbose and (it % max(1, num_iters // 10) == 0):
                print(f"fit_em iter {it}: lp={float(lp):.4f}")
        return params, torch.stack(log_probs)

    def fit_sgd(
        self,
        params: ParameterSet,
        props: PropertySet,
        emissions,
        inputs=None,
        optimizer: Callable = adam,
        batch_size: int = 1,
        num_epochs: int = 50,
        shuffle: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """SGD on the negative marginal log-probability per emission entry,
        through :func:`~bayesianfiltering_tpu_torch.models._fit.run_sgd`
        in the unconstrained space of ``props``. The gradient runs through
        the filter's kernels forward and their plain versions backward."""
        batch_emissions = ensure_array_has_batch_dim(emissions,
                                                     self.emission_shape)
        batch_inputs = ensure_array_has_batch_dim(inputs, self.inputs_shape)
        num_sequences, size = len(batch_emissions), batch_emissions.numel()

        def loss_fn(unc_params, minibatch):
            params = from_unconstrained(unc_params, props)
            minibatch_emissions, minibatch_inputs = minibatch
            scale = num_sequences / len(minibatch_emissions)
            lls = self.marginal_log_prob(params, minibatch_emissions,
                                         minibatch_inputs)
            lp = self.log_prior(params) + lls.sum() * scale
            return -lp / size

        unc_params, losses = run_sgd(
            loss_fn, to_unconstrained(params, props),
            (batch_emissions, batch_inputs), optimizer=optimizer,
            batch_size=batch_size, num_epochs=num_epochs, shuffle=shuffle,
            generator=generator)
        return from_unconstrained(unc_params, props), losses


__all__ = ["SSM", "Posterior", "SuffStatsSSM", "SampleDraws"]
