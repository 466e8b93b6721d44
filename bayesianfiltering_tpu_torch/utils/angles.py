"""Angular (wrapped) innovation helpers
(counterpart of ``bayesianfiltering_tpu/utils/angles.py``).

Bearing observations live on the circle: when the true bearing crosses the
±π branch cut of ``atan2`` the raw innovation jumps by ~2π, which at the
BOT benchmark's R = 2.5e-5 throws every EKF of a bank off track. Models opt
in with ``ParamsNLSSM.emission_residual = angular_residual(dims)``.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap to (−π, π] (elementwise)."""
    return theta - 2.0 * math.pi * torch.round(theta / (2.0 * math.pi))


def angular_residual(angular_dims: Sequence[int]) -> Callable:
    """``residual(y, yhat) -> y − yhat`` with the listed emission components
    wrapped to (−π, π]; broadcasts over leading batch dimensions."""
    dims = tuple(int(d) for d in angular_dims)

    def residual(y: torch.Tensor, yhat: torch.Tensor) -> torch.Tensor:
        r = torch.atleast_1d(y) - torch.atleast_1d(yhat)
        if not dims:
            return r
        mask = torch.zeros(r.shape[-1], dtype=torch.bool, device=r.device)
        mask[list(dims)] = True
        return torch.where(mask, wrap_angle(r), r)

    return residual


__all__ = ["wrap_angle", "angular_residual"]
