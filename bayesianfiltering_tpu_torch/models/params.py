"""Parameter containers for nonlinear state-space models
(counterpart of ``bayesianfiltering_tpu/models/params.py``).

A :class:`ParamsNLSSM` specifies the non-additive-noise SSM

    x_t = f(x_{t-1}, q_t, u_t),   q_t ~ N(q0, Q)
    y_t = h(x_t,     r_t, u_t),   r_t ~ N(r0, R)
    x_1 ~ N(m, S)

Noise covariances may carry a leading time axis (time-varying Q/R).
:func:`params_from_jax` carries a JAX model's arrays across: closures
cannot cross frameworks, arrays can.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch

from bayesianfiltering_tpu_torch.distributions import mvn_sample


class ParamsNLSSM(NamedTuple):
    """Nonlinear SSM parameters. The optional ``*_jacobian_*`` callables
    replace ``torch.func.jacfwd`` of the model functions when given;
    ``emission_residual`` replaces plain subtraction in the innovation
    (e.g. wrapped bearings)."""

    initial_mean: torch.Tensor
    initial_covariance: torch.Tensor
    dynamics_function: Callable
    dynamics_noise_bias: torch.Tensor
    dynamics_noise_covariance: torch.Tensor
    emission_function: Callable
    emission_noise_bias: torch.Tensor
    emission_noise_covariance: torch.Tensor
    dynamics_jacobian_x: Optional[Callable] = None
    dynamics_jacobian_q: Optional[Callable] = None
    emission_jacobian_x: Optional[Callable] = None
    emission_jacobian_r: Optional[Callable] = None
    emission_residual: Optional[Callable] = None


class ParamsBPF(NamedTuple):
    """Bootstrap-PF parameters: :class:`ParamsNLSSM`'s first eight fields
    plus the emission log-density."""

    initial_mean: torch.Tensor
    initial_covariance: torch.Tensor
    dynamics_function: Callable
    dynamics_noise_bias: torch.Tensor
    dynamics_noise_covariance: torch.Tensor
    emission_function: Callable
    emission_noise_bias: torch.Tensor
    emission_noise_covariance: torch.Tensor
    emission_distribution_log_prob: Callable

    def sample_dynamics_distribution(self, x, u, generator=None, eps=None):
        """Propagate one state: q ~ N(q0, Q), then f(x, q, u)."""
        q = mvn_sample(self.dynamics_noise_bias,
                       self.dynamics_noise_covariance, (), generator, eps)
        return self.dynamics_function(x, q, u)


ARRAY_FIELDS = (
    "initial_mean",
    "initial_covariance",
    "dynamics_noise_bias",
    "dynamics_noise_covariance",
    "emission_noise_bias",
    "emission_noise_covariance",
)


def params_from_jax(arrays: Any, template: ParamsNLSSM, *,
                    dtype: torch.dtype, device) -> ParamsNLSSM:
    """The port's :class:`ParamsNLSSM` with the array fields of a JAX
    ``ParamsNLSSM`` and the callables of ``template``.

    ``arrays`` holds the six array fields (:data:`ARRAY_FIELDS`) as numpy
    arrays, either as a mapping or as attributes (a JAX ``ParamsNLSSM``
    itself works: its arrays convert with ``np.asarray``). ``template`` is
    the matching port model's params, e.g. from the port's zoo; every array
    must have the template's shape, or ValueError is raised.
    """
    get = (arrays.__getitem__ if isinstance(arrays, Mapping)
           else lambda name: getattr(arrays, name))
    fields = {}
    for name in ARRAY_FIELDS:
        value = np.asarray(get(name))
        want = tuple(getattr(template, name).shape)
        if value.shape != want:
            raise ValueError(f"{name}: shape {value.shape} does not match the "
                             f"template's {want}")
        fields[name] = torch.tensor(value, dtype=dtype, device=device)
    return template._replace(**fields)


__all__ = ["ParamsNLSSM", "ParamsBPF", "ARRAY_FIELDS", "params_from_jax"]
