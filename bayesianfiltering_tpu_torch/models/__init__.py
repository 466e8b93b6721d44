"""Model layer: parameters, the nonlinear SSM, and the zoo."""
from bayesianfiltering_tpu_torch.models import zoo
from bayesianfiltering_tpu_torch.models.nonlinear import NonlinearSSM, SampleDraws
from bayesianfiltering_tpu_torch.models.params import (
    ParamsBPF,
    ParamsNLSSM,
    params_from_jax,
)

__all__ = ["zoo", "NonlinearSSM", "SampleDraws", "ParamsBPF", "ParamsNLSSM",
           "params_from_jax"]
