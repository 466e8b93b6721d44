"""PyTorch port of ``bayesianfiltering_tpu`` for NVIDIA Hopper GPUs.

Same module layout and public names as the JAX package, which stays the
reference. The EKF, Gaussian-sum filter and AGSF run their per-step linear
algebra in hand-written CUDA kernels (``csrc/``, built at first use by
:mod:`bayesianfiltering_tpu_torch._build`) on CUDA tensors, and in plain
PyTorch twins on CPU tensors. Importing the package applies the precision
policy of :mod:`bayesianfiltering_tpu_torch.config`.
"""
from bayesianfiltering_tpu_torch import config  # noqa: F401  (precision policy)
from bayesianfiltering_tpu_torch import containers, distributions, inference
from bayesianfiltering_tpu_torch.containers import GaussianSum
from bayesianfiltering_tpu_torch.inference import (
    augmented_gaussian_sum_filter,
    extended_kalman_filter,
    gaussian_sum_filter,
    speedy_augmented_gaussian_sum_filter,
)
from bayesianfiltering_tpu_torch.models import (
    NonlinearSSM,
    ParamsNLSSM,
    params_from_jax,
    zoo,
)

__all__ = [
    "containers",
    "distributions",
    "inference",
    "GaussianSum",
    "augmented_gaussian_sum_filter",
    "extended_kalman_filter",
    "gaussian_sum_filter",
    "speedy_augmented_gaussian_sum_filter",
    "NonlinearSSM",
    "ParamsNLSSM",
    "params_from_jax",
    "zoo",
]
