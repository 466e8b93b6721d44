"""Filter step primitives and the CUDA kernels behind them."""
from bayesianfiltering_tpu_torch.ops import bank_update, ekf, fused_ekf, fused_ut, ukf
from bayesianfiltering_tpu_torch.ops.ekf import EKFUpdate
from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF

__all__ = ["bank_update", "ekf", "fused_ekf", "fused_ut", "ukf", "EKFUpdate",
           "ParamsUKF"]
