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

# Function-signature aliases of the model callables.
FnStateToState = Callable
FnStateAndInputToState = Callable
FnStateToEmission = Callable
FnStateAndInputToEmission = Callable


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


def params_from_jax(arrays: Any, template, *, dtype: torch.dtype, device):
    """The port's params with the array fields of their JAX counterpart and
    the callables of ``template``.

    ``template`` is the matching port params — a :class:`ParamsNLSSM` or
    :class:`ParamsBPF` (e.g. from the port's zoo; the six
    :data:`ARRAY_FIELDS` are carried) or an
    :class:`~bayesianfiltering_tpu_torch.ops.linear.ParamsLGSSM` (all its
    fields are arrays; an optional bias must be None on both sides or on
    neither). ``arrays`` holds the fields as numpy-convertible arrays,
    either as a mapping or as attributes (the JAX ``ParamsNLSSM``,
    ``ParamsBPF`` or ``ParamsLGSSM`` itself works). Every array must have
    the template's shape, or ValueError is raised.
    """
    from bayesianfiltering_tpu_torch.ops.linear import ParamsLGSSM

    get = (arrays.__getitem__ if isinstance(arrays, Mapping)
           else lambda name: getattr(arrays, name))
    names = (ParamsLGSSM._fields if isinstance(template, ParamsLGSSM)
             else ARRAY_FIELDS)
    fields = {}
    for name in names:
        value, want = get(name), getattr(template, name)
        if value is None or want is None:
            if (value is None) != (want is None):
                raise ValueError(f"{name}: None on one side only")
            continue
        value, want = np.asarray(value), tuple(want.shape)
        if value.shape != want:
            raise ValueError(f"{name}: shape {value.shape} does not match the "
                             f"template's {want}")
        fields[name] = torch.tensor(value, dtype=dtype, device=device)
    return template._replace(**fields)


__all__ = ["ParamsNLSSM", "ParamsBPF", "ARRAY_FIELDS", "params_from_jax",
           "FnStateToState", "FnStateAndInputToState", "FnStateToEmission",
           "FnStateAndInputToEmission"]
