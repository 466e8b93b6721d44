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
    parallel_iterated,
    resample_gather,
    slr,
    steady_state,
    ukf,
)
from bayesianfiltering_tpu_torch.ops.associative import (
    parallel_kalman_filter,
    parallel_kalman_filter_tv,
    parallel_kalman_smoother,
    parallel_kalman_smoother_tv,
)
from bayesianfiltering_tpu_torch.ops.ekf import (
    EKFUpdate,
    ekf_condition_on,
    ekf_condition_on_iterated,
    ekf_condition_on_ref,
    ekf_predict,
    ekf_step,
)
from bayesianfiltering_tpu_torch.ops.linear import (
    ParamsLGSSM,
    PosteriorKalman,
    kalman_filter,
    kalman_smoother,
)
from bayesianfiltering_tpu_torch.ops.parallel_iterated import (
    parallel_iterated_extended_smoother,
    parallel_iterated_sigma_point_smoother,
)
from bayesianfiltering_tpu_torch.ops.slr import mc_moments, mcla_moments
from bayesianfiltering_tpu_torch.ops.steady_state import (
    SteadyStateGains,
    steady_state_gains,
    steady_state_kalman_filter,
    steady_state_kalman_smoother,
)
from bayesianfiltering_tpu_torch.ops.ukf import (
    ParamsUKF,
    ukf_condition_on_additive,
    ukf_condition_on_nonadditive,
    ukf_predict_additive,
    ukf_predict_nonadditive,
)

__all__ = ["associative", "bank_combine", "bank_smoother", "bank_update",
           "ekf", "fused_ekf", "fused_ut", "linear", "parallel_iterated",
           "resample_gather", "slr", "steady_state", "ukf",
           "EKFUpdate", "ekf_predict", "ekf_condition_on",
           "ekf_condition_on_iterated", "ekf_condition_on_ref", "ekf_step", "ParamsUKF", "ukf_predict_additive",
           "ukf_predict_nonadditive", "ukf_condition_on_additive",
           "ukf_condition_on_nonadditive", "ParamsLGSSM", "PosteriorKalman",
           "kalman_filter", "kalman_smoother", "parallel_kalman_filter",
           "parallel_kalman_smoother", "parallel_kalman_filter_tv",
           "parallel_kalman_smoother_tv", "parallel_iterated_extended_smoother",
           "parallel_iterated_sigma_point_smoother", "mc_moments",
           "mcla_moments", "SteadyStateGains", "steady_state_gains",
           "steady_state_kalman_filter", "steady_state_kalman_smoother"]
