"""Legacy nonlinearity zoo (counterpart of
``bayesianfiltering_tpu/legacy/nonlinearities.py``): the port's zoo
functions under the legacy names (f1 …, f96, g96, g96lp)."""
from __future__ import annotations

from bayesianfiltering_tpu_torch.models.zoo import (
    linear_nonlinear_product,
    linear_nonlinear_sum,
    lorenz96,
    power_nonlinearity,
    quadratic_form,
    sinc_nonlinearity,
)


def make_f1(p: float):
    """The (1 + ‖x‖²)^(p/2) triple (f, J, H)."""
    return power_nonlinearity(p)


# The closures make no tensor until they are called, so they are built at
# import, where the JAX package builds them at first access.
f2 = sinc_nonlinearity()
f3, J3, H3 = linear_nonlinear_product()
f4, J4, H4 = linear_nonlinear_sum()
f5, J5, H5 = quadratic_form()


def make_lorenz96(state_dim: int, emission_dim: int, r: float = 1.0, **kw):
    """The (f96, g96, g96lp) closures of the zoo's Lorenz-96 with the
    (x, noise, u) convention; ``kw`` goes to ``zoo.lorenz96`` (``dtype``,
    ``device`` among them)."""
    _, params, bpf = lorenz96(state_dim, emission_dim, r=r, **kw)
    return (params.dynamics_function, params.emission_function,
            bpf.emission_distribution_log_prob)


__all__ = [
    "make_f1", "f2", "f3", "J3", "H3", "f4", "J4", "H4", "f5", "J5", "H5",
    "make_lorenz96",
]
