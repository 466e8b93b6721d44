"""Numerical utilities: linear algebra, angles, resampling, the
splitting-covariance solvers, sigma points and metrics, re-exported as one
flat namespace as the reference's ``utils`` is (``utils.rmse``,
``utils.systematic_resample``, ...)."""
from bayesianfiltering_tpu_torch.utils.angles import angular_residual, wrap_angle
from bayesianfiltering_tpu_torch.utils.linalg import (
    cholesky_guarded,
    cholesky_nan,
    project_to_psd,
    project_to_psd_fast,
    project_to_psd_ns,
    psd_solve,
    sqrtm_psd,
    sqrtm_psd_eigh,
    matrix_projection,
    sandwich,
    sqrtm_psd_ns,
    symmetrize,
    tri_solve_lower,
)
from bayesianfiltering_tpu_torch.utils.metrics import (
    W_distance,
    collapse,
    dec_to_base,
    gaussian_logpdf,
    gm,
    loss,
    mse,
    normal_KL_div,
    normal_kl,
    rmse,
)
from bayesianfiltering_tpu_torch.utils.resampling import (
    _resample,
    effective_sample_size,
    get_resampler,
    multinomial_resample,
    optimal_resampling,
    resample,
    retain,
    split_by_sampling,
    stratified_resample,
    systematic_resample,
)
from bayesianfiltering_tpu_torch.utils.sdp import (
    gradient_descent,
    sdp_opt,
    sdp_opt2,
    sdp_opt_legacy,
    sdp_opt_test,
)
from bayesianfiltering_tpu_torch.utils.sigma_points import (
    _get_sigma_points,
    sigma_points,
    split_to_sigma_points,
    unscented_weights,
)

__all__ = [
    # linalg
    "symmetrize", "psd_solve", "project_to_psd", "project_to_psd_ns",
    "project_to_psd_fast",
    "sqrtm_psd", "sqrtm_psd_eigh", "sqrtm_psd_ns", "cholesky_guarded",
    "cholesky_nan", "tri_solve_lower", "sandwich", "matrix_projection",
    # metrics
    "mse", "rmse", "collapse", "normal_KL_div", "normal_kl", "W_distance",
    "gaussian_logpdf", "gm", "loss", "dec_to_base",
    # sigma points
    "sigma_points", "_get_sigma_points", "split_to_sigma_points",
    "unscented_weights",
    # resampling
    "effective_sample_size", "multinomial_resample", "systematic_resample",
    "stratified_resample", "get_resampler", "_resample", "optimal_resampling",
    "resample", "retain", "split_by_sampling",
    # sdp
    "sdp_opt", "sdp_opt2", "gradient_descent", "sdp_opt_legacy",
    "sdp_opt_test",
    # angles
    "wrap_angle", "angular_residual",
]
