"""Model layer: parameter containers, the constraint system, the SSM
classes with their fitting drivers, and the zoo."""
from bayesianfiltering_tpu_torch.models.params import (
    FnStateAndInputToEmission,
    FnStateAndInputToState,
    FnStateToEmission,
    FnStateToState,
    ParamsBPF,
    ParamsNLSSM,
    params_from_jax,
)
from bayesianfiltering_tpu_torch.models.parameters import (
    ParameterProperties,
    ParameterSet,
    PropertySet,
    from_unconstrained,
    log_det_jac_constrain,
    to_unconstrained,
)
from bayesianfiltering_tpu_torch.models.ssm import SSM, SampleDraws
from bayesianfiltering_tpu_torch.models.nonlinear import (
    NonlinearGaussianSSM,
    NonlinearSSM,
)
from bayesianfiltering_tpu_torch.models.linear_gaussian import (
    LinearGaussianSSM,
    PropsLGSSM,
)
from bayesianfiltering_tpu_torch.models import bijectors, zoo
from bayesianfiltering_tpu_torch.models._fit import (
    ensure_array_has_batch_dim,
    run_sgd,
)

__all__ = [
    "ParamsNLSSM", "ParamsBPF",
    "FnStateToState", "FnStateAndInputToState",
    "FnStateToEmission", "FnStateAndInputToEmission",
    "ParameterSet", "PropertySet", "ParameterProperties",
    "to_unconstrained", "from_unconstrained", "log_det_jac_constrain",
    "SSM", "NonlinearGaussianSSM", "NonlinearSSM", "LinearGaussianSSM",
    "PropsLGSSM", "bijectors", "zoo",
    "ensure_array_has_batch_dim", "run_sgd",
    "SampleDraws", "params_from_jax",
]
