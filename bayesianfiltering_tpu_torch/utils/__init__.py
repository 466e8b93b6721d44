"""Numerical utilities: linear algebra, angles, resampling, sigma points
(``utils.sigma_points``) and metrics (``utils.metrics``)."""
from bayesianfiltering_tpu_torch.utils.angles import angular_residual, wrap_angle
from bayesianfiltering_tpu_torch.utils.linalg import (
    cholesky_guarded,
    cholesky_nan,
    project_to_psd,
    project_to_psd_ns,
    psd_solve,
    sqrtm_psd,
    sqrtm_psd_ns,
    symmetrize,
)

__all__ = ["angular_residual", "wrap_angle", "cholesky_guarded",
           "cholesky_nan", "project_to_psd", "project_to_psd_ns", "psd_solve",
           "sqrtm_psd", "sqrtm_psd_ns", "symmetrize"]
