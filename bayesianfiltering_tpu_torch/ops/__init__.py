"""Filter step primitives and the CUDA kernels behind them."""
from bayesianfiltering_tpu_torch.ops import bank_update, ekf, fused_ekf
from bayesianfiltering_tpu_torch.ops.ekf import EKFUpdate

__all__ = ["bank_update", "ekf", "fused_ekf", "EKFUpdate"]
