"""Legacy (v0) object-oriented API (counterpart of
``bayesianfiltering_tpu/legacy``): GaussFilt/UKF/MCF/EKF/MCLAF and the
composite bank (``gaussfilt``), the standalone GSF and the original AGSF
with its selection modes (``gausssumfilt``), ``BootstrapPF``
(``particlefilt``), the ALA mean estimators, the static joint
approximation and the ``Simulation`` wrapper.

Randomness comes from a ``torch.Generator`` or from draws made
beforehand. The Gaussian filters are plain PyTorch, as the JAX package's
are plain XLA; the bootstrap PF inverts its resampling counts with the
CUDA kernel K5 on CUDA tensors.
"""
from bayesianfiltering_tpu_torch.legacy.gaussfilt import (
    SSM,
    GaussFilt,
    UKF,
    MCF,
    EKF,
    MCLAF,
    GaussSumFilt as CompositeGaussSumFilt,
)
from bayesianfiltering_tpu_torch.legacy.gausssumfilt import (
    GaussSumFilt,
    AugGaussSumFilt,
)
from bayesianfiltering_tpu_torch.legacy.particlefilt import BootstrapPF
from bayesianfiltering_tpu_torch.legacy.static_utils import (
    MixtureModel,
    AugmentedJointApproximation,
    plot_cov_ellipse,
)
from bayesianfiltering_tpu_torch.legacy.simulation import Simulation
from bayesianfiltering_tpu_torch.legacy import (
    ala,
    mean_estimators,
    nonlinearities,
)
from bayesianfiltering_tpu_torch.legacy.ala import (
    StateSpaceModel,
    LinearModelParameters,
)

__all__ = [
    "SSM", "GaussFilt", "UKF", "MCF", "EKF", "MCLAF",
    "CompositeGaussSumFilt", "GaussSumFilt", "AugGaussSumFilt",
    "BootstrapPF", "MixtureModel", "AugmentedJointApproximation",
    "plot_cov_ellipse", "Simulation", "ala", "mean_estimators", "nonlinearities",
    "StateSpaceModel", "LinearModelParameters",
]
