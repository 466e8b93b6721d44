"""Filter step primitives and the CUDA kernels behind them."""
from bayesianfiltering_tpu_torch.ops import (
    associative,
    bank_combine,
    bank_smoother,
    bank_update,
    ekf,
    fused_ekf,
    fused_ut,
    linear,
    resample_gather,
    ukf,
)
from bayesianfiltering_tpu_torch.ops.associative import (
    parallel_kalman_filter,
    parallel_kalman_smoother,
)
from bayesianfiltering_tpu_torch.ops.ekf import EKFUpdate
from bayesianfiltering_tpu_torch.ops.linear import (
    ParamsLGSSM,
    PosteriorKalman,
    kalman_filter,
    kalman_smoother,
)
from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF

__all__ = ["associative", "bank_combine", "bank_smoother", "bank_update",
           "ekf", "fused_ekf", "fused_ut", "linear", "resample_gather", "ukf",
           "EKFUpdate", "ParamsLGSSM", "PosteriorKalman", "ParamsUKF",
           "kalman_filter", "kalman_smoother", "parallel_kalman_filter",
           "parallel_kalman_smoother"]
