"""Precision policy.

Kalman-type covariance algebra is sensitive to reduced-precision products:
the innovation covariance ``S = R + H P Hᵀ`` with a small ``R`` can come
out negative and NaN the Cholesky (observed with bf16 products on the BOT
benchmark, R = 2.5e-5). The JAX package therefore traces every filter at
"highest" matmul precision (``bayesianfiltering_tpu/config.py``). The
counterpart here: TF32 is switched off for CUDA matmuls and cuDNN, and
float32 matmuls run at "highest" precision. The policy is applied once,
when the package is imported, and has no knob to lower it.
"""
from __future__ import annotations

import torch


def apply_precision_policy() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


apply_precision_policy()

__all__ = ["apply_precision_policy"]
