"""PyTorch port of ``bayesianfiltering_tpu`` for NVIDIA Hopper GPUs.

Same module layout and public names as the JAX package, which stays the
reference. The EKF and UKF, the Gaussian-sum filters, the AGSF family, the
bootstrap particle filter's resampling and the temporally parallel Kalman
filter and smoother — and so the model layer's EM and SGD fitting and the
streaming steppers built on them — and the legacy bootstrap PF run their
hot loops in hand-written CUDA kernels
(``csrc/``, built at first use by
:mod:`bayesianfiltering_tpu_torch._build`) on CUDA tensors, and in plain
PyTorch twins on CPU tensors; :mod:`~bayesianfiltering_tpu_torch.parallel`
runs them as the ranks of a ``torch.distributed`` group. Importing the package applies the precision
policy of :mod:`bayesianfiltering_tpu_torch.config`.
"""
from bayesianfiltering_tpu_torch import config  # noqa: F401  (precision policy)
from bayesianfiltering_tpu_torch import (
    containers,
    diagnostics,
    distributions,
    inference,
    legacy,
    models,
    ops,
    parallel,
    streaming,
    utils,
)
from bayesianfiltering_tpu_torch.containers import GaussianSum
from bayesianfiltering_tpu_torch.inference import (
    PosteriorGaussianSumFiltered,
    augmented_gaussian_sum_filter,
    augmented_gaussian_sum_filter_optimal,
    bootstrap_particle_filter,
    extended_kalman_filter,
    gaussian_sum_filter,
    speedy_augmented_gaussian_sum_filter,
    speedy_unscented_agsf,
    unscented_agsf,
    unscented_gaussian_sum_filter,
    unscented_kalman_filter,
)
from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF
from bayesianfiltering_tpu_torch.models import (
    NonlinearGaussianSSM,
    NonlinearSSM,
    ParamsBPF,
    ParamsNLSSM,
    params_from_jax,
    zoo,
)

__all__ = [
    "config",
    "containers",
    "diagnostics",
    "distributions",
    "inference",
    "legacy",
    "models",
    "ops",
    "parallel",
    "streaming",
    "utils",
    "GaussianSum",
    "PosteriorGaussianSumFiltered",
    "augmented_gaussian_sum_filter",
    "augmented_gaussian_sum_filter_optimal",
    "bootstrap_particle_filter",
    "extended_kalman_filter",
    "gaussian_sum_filter",
    "speedy_augmented_gaussian_sum_filter",
    "unscented_kalman_filter",
    "unscented_gaussian_sum_filter",
    "unscented_agsf",
    "speedy_unscented_agsf",
    "ParamsUKF",
    "NonlinearGaussianSSM",
    "NonlinearSSM",
    "ParamsBPF",
    "ParamsNLSSM",
    "params_from_jax",
    "zoo",
]
