"""Numerical utilities: linear algebra, angles, resampling."""
from bayesianfiltering_tpu_torch.utils.angles import angular_residual, wrap_angle
from bayesianfiltering_tpu_torch.utils.linalg import (
    cholesky_guarded,
    cholesky_nan,
    psd_solve,
    symmetrize,
)

__all__ = ["angular_residual", "wrap_angle", "cholesky_guarded",
           "cholesky_nan", "psd_solve", "symmetrize"]
