"""Legacy (v0) object-oriented Gaussian filters
(counterpart of ``bayesianfiltering_tpu/legacy/gaussfilt.py``).

An additive-noise :class:`SSM` holder, the :class:`GaussFilt` template (the
generic moment-approximation predict/update recursion) and its filters
:class:`UKF`, :class:`MCF` (Monte-Carlo moments), :class:`EKF` (with the
second-order Hessian terms at ``order=2``) and :class:`MCLAF` (Monte-Carlo
linearization-augmented moments), and the composite bank
:class:`GaussSumFilt` over any of them.

As in the JAX package, ``run`` predicts through the dynamics before the
first update and returns time-major ``(ll (T,), means (T, dx), covs (T, dx,
dx))``. The models' ``f`` and ``g`` act on one state; Jacobians and
Hessians come from ``torch.func``. A model that multiplies a Python float
by a 0-dim slice of ``x`` makes ``torch.func.jacfwd`` promote float32 to
float64: write such models with width-1 slices (``x[..., 1:2]``).

Randomness: the stochastic filters (MCF, MCLAF) take a ``torch.Generator``
or, in ``run``, their standard normals drawn beforehand, (T, 2, N, dx): the
predict's and the update's N particles a step. Everything here is plain
PyTorch on the device of the model's tensors, as the JAX package's legacy
filters are plain XLA.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from bayesianfiltering_tpu_torch.config import resolve_device
from bayesianfiltering_tpu_torch.distributions import (
    mvn_logpdf,
    mvn_sample,
    standard_normal,
)
from bayesianfiltering_tpu_torch.ops.slr import mc_moments, mcla_moments
from bayesianfiltering_tpu_torch.utils.linalg import psd_solve, symmetrize
from bayesianfiltering_tpu_torch.utils.sdp import sdp_opt_legacy
from bayesianfiltering_tpu_torch.utils.sigma_points import split_to_sigma_points


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays where it is (or moves to
    ``device``), anything else is made on ``device``, the card by
    default."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(x, device=resolve_device(device))


def jacobian_fn(f: Callable, dim_out: int, dim_in: int) -> Callable:
    """x ↦ ∂f/∂x as (dim_out, dim_in)."""
    jac = torch.func.jacfwd(f)
    return lambda x: jac(x).reshape(dim_out, dim_in)


def hessian_fn(f: Callable, dim_out: int, dim_in: int) -> Callable:
    """x ↦ the Hessians of f's outputs, (dim_out, dim_in, dim_in)."""
    hess = torch.func.jacfwd(torch.func.jacrev(f))
    return lambda x: hess(x).reshape(dim_out, dim_in, dim_in)


def at_1d(func: Callable) -> Callable:
    return lambda x: torch.atleast_1d(func(x))


class SimulateDraws(NamedTuple):
    """The standard normals of a rollout: ``state`` (T, dx) of the
    dynamics noise, ``emission`` (T, dy) of the emission noise."""

    state: torch.Tensor
    emission: torch.Tensor


class SSM:
    """Additive-noise model x' = f(x) + N(c, Q), y = g(x') + N(d, R).
    ``c``, ``Q``, ``d`` and ``R`` stay on their device if they are tensors,
    else they are made on ``device`` (the card by default)."""

    def __init__(self, dx, dy, c, Q, d, R, f: Callable = None,
                 g: Callable = None, device=None):
        self.dx = dx
        self.dy = dy
        self.f = f
        self.g = g
        self.Q = as_tensor(Q, device)
        self.R = as_tensor(R, device)
        self.c = as_tensor(c, device)
        self.d = as_tensor(d, device)

    def propagate(self, old_x, generator: Optional[torch.Generator] = None,
                  eps=None):
        """One step; ``eps`` is the pair of standard normals ((dx,),
        (dy,))."""
        e_x, e_y = (None, None) if eps is None else eps
        new_x = self.f(old_x) + mvn_sample(self.c, self.Q, (), generator, e_x)
        new_y = self.g(new_x) + mvn_sample(self.d, self.R, (), generator, e_y)
        return new_x, new_y

    def simulate(self, T: int, x0, generator: Optional[torch.Generator] = None,
                 draws: Optional[SimulateDraws] = None):
        """Roll out T steps from ``x0``; returns ``(xs (T, dx), ys (T,
        dy))``."""
        x = as_tensor(x0, self.Q.device)
        xs, ys = [], []
        for t in range(T):
            eps = None if draws is None else (draws.state[t],
                                              draws.emission[t])
            x, y = self.propagate(x, generator, eps)
            xs.append(x)
            ys.append(y)
        return torch.stack(xs), torch.stack(ys)


class GaussFilt:
    """The generic Gaussian-filter recursion. Subclasses implement
    ``moment_approx(m, P, kw, eps)``, the transform moments ``(mean_out,
    var_out, cov_out)``; a stochastic one sets ``num_particles`` and takes
    its (N, dx) standard normals as ``eps``."""

    num_particles: Optional[int] = None

    def __init__(self, ssm: SSM, generator: Optional[torch.Generator] = None):
        self.f = ssm.f
        self.g = ssm.g
        self.Q = ssm.Q
        self.R = ssm.R
        self.dx = ssm.dx
        self.dy = ssm.dy
        self.generator = generator

    def moment_approx(self, m, P, kw: str, eps=None):
        raise NotImplementedError

    def which_step(self, kw: str):
        """(func, additive_cov, dim_in, dim_out) for 'pred'/'upd'."""
        if kw == "pred":
            return self.f, self.Q, self.dx, self.dx
        if kw == "upd":
            return self.g, self.R, self.dx, self.dy
        raise ValueError(f"unknown step {kw!r}")

    def step_draws(self, like: torch.Tensor, generator=None, batch=()):
        """Fresh standard normals of one step, ``batch + (2, N, dx)``, or
        None for a deterministic filter."""
        if self.num_particles is None:
            return None
        gen = self.generator if generator is None else generator
        return standard_normal(tuple(batch) + (2, self.num_particles,
                                               self.dx), like, gen)

    def _step(self, m, P, y, eps=None):
        e1, e2 = (None, None) if eps is None else (eps[0], eps[1])
        m_pred, P_pred, _ = self.moment_approx(m, P, "pred", e1)
        mu_y, Sy, Cxy = self.moment_approx(m_pred, P_pred, "upd", e2)
        gain = psd_solve(Sy, Cxy.T).T  # Cxy Sy⁻¹
        y = torch.atleast_1d(y)
        m_filt = m_pred + gain @ (y - mu_y)
        P_filt = symmetrize(P_pred - gain @ Sy @ gain.T)
        ll = mvn_logpdf(y, mu_y, Sy)
        return m_filt, P_filt, ll, m_pred, P_pred

    def run(self, ys, m0, P0, verbose: bool = False,
            draws: Optional[torch.Tensor] = None):
        """Filter a sequence; ``draws`` (T, 2, N, dx) are a stochastic
        filter's standard normals (else drawn from its generator). Returns
        ``(ll (T,), means (T, dx), covs (T, dx, dx))``."""
        dev = self.Q.device
        ys = as_tensor(ys, dev)
        m, P = as_tensor(m0, dev), as_tensor(P0, dev)
        lls, means, covs = [], [], []
        for t in range(ys.shape[0]):
            eps = draws[t] if draws is not None else self.step_draws(m)
            m, P, ll, _, _ = self._step(m, P, ys[t], eps)
            lls.append(ll)
            means.append(m)
            covs.append(P)
        return torch.stack(lls), torch.stack(means), torch.stack(covs)


class UKF(GaussFilt):
    """Unscented moment filter: 2n+1 Cholesky sigma points, the legacy
    weights."""

    def __init__(self, ssm: SSM, alpha: float = 1e-3, beta: float = 2.0,
                 kappa: float = 0.0, generator=None):
        super().__init__(ssm, generator)
        self.alpha = alpha
        self.beta = beta
        self.kappa = kappa
        self.lamda = alpha ** 2 * (self.dx + kappa) - self.dx

    def __str__(self):
        return "UKF"

    def moment_approx(self, m, P, kw, eps=None):
        func, cov, _, _ = self.which_step(kw)
        n, lam = self.dx, self.lamda
        pts = split_to_sigma_points(m, P, lam)  # (2n+1, dx), center first
        new_pts = torch.func.vmap(at_1d(func))(pts)
        w0m = lam / (n + lam)
        wim = 1.0 / (2.0 * (n + lam))
        w0c = w0m + 1.0 - self.alpha ** 2 + self.beta
        mean_out = w0m * new_pts[0] + wim * new_pts[1:].sum(0)
        d0 = new_pts[0] - mean_out
        di = new_pts[1:] - mean_out
        var_out = cov + w0c * torch.outer(d0, d0) + wim * di.T @ di
        s0 = pts[0] - m
        si = pts[1:] - m
        cov_out = w0c * torch.outer(s0, d0) + wim * si.T @ di
        return mean_out, symmetrize(var_out), cov_out


class MCF(GaussFilt):
    """Monte-Carlo moment filter."""

    def __init__(self, ssm: SSM, num_particles: int, generator=None):
        super().__init__(ssm, generator)
        self.num_particles = num_particles

    def __str__(self):
        return "MCF"

    def moment_approx(self, m, P, kw, eps=None):
        func, cov, _, _ = self.which_step(kw)
        return mc_moments(m, P, at_1d(func), cov, self.num_particles,
                          self.generator, eps)


class EKF(GaussFilt):
    """Extended moment filter; ``order=2`` adds the Hessian corrections
    ``mean += ½ tr(H_k P)``, ``var += ½ tr(H_i P H_j P)``."""

    def __init__(self, ssm: SSM, order: int = 2, generator=None):
        super().__init__(ssm, generator)
        self.order = order
        self.f_jacobian = jacobian_fn(self.f, self.dx, self.dx)
        self.g_jacobian = jacobian_fn(self.g, self.dy, self.dx)
        self.f_hessian = hessian_fn(self.f, self.dx, self.dx)
        self.g_hessian = hessian_fn(self.g, self.dy, self.dx)

    def __str__(self):
        return "EKF"

    def moment_approx(self, m, P, kw, eps=None):
        func, cov, _, _ = self.which_step(kw)
        jacobian = self.f_jacobian if kw == "pred" else self.g_jacobian
        hessian = self.f_hessian if kw == "pred" else self.g_hessian
        J = jacobian(m)
        mean_out = torch.atleast_1d(func(m))
        var_out = cov + J @ P @ J.T
        cov_out = P @ J.T
        if self.order == 2:
            HP = hessian(m) @ P  # (dy, dx, dx)
            mean_out = mean_out + 0.5 * torch.diagonal(
                HP, dim1=-2, dim2=-1).sum(-1)
            var_out = var_out + 0.5 * torch.einsum("ikl,jlk->ij", HP, HP)
        return mean_out, symmetrize(var_out), cov_out


class MCLAF(GaussFilt):
    """Monte-Carlo linearization-augmented filter: particles from the
    deflated N(m, P − Δ), Δ from :func:`sdp_opt_legacy` at the summed
    Hessian of the mean, each particle with its linearization."""

    def __init__(self, ssm: SSM, num_particles: int, generator=None,
                 lip: float = 1.0, sdp_steps: int = 10, sdp_eta: float = 0.01):
        super().__init__(ssm, generator)
        self.num_particles = num_particles
        self.lip = lip
        self.sdp_steps = sdp_steps
        self.sdp_eta = sdp_eta
        self.f_jacobian = jacobian_fn(self.f, self.dx, self.dx)
        self.g_jacobian = jacobian_fn(self.g, self.dy, self.dx)
        self.f_hessian = hessian_fn(self.f, self.dx, self.dx)
        self.g_hessian = hessian_fn(self.g, self.dy, self.dx)

    def __str__(self):
        return "MCLAF"

    def moment_approx(self, m, P, kw, eps=None):
        func, cov, _, _ = self.which_step(kw)
        jacobian = self.f_jacobian if kw == "pred" else self.g_jacobian
        hessian = self.f_hessian if kw == "pred" else self.g_hessian
        avg_hessian = hessian(m).sum(0)
        delta = sdp_opt_legacy(self.dx, self.num_particles, self.lip, P, P,
                               avg_hessian, self.sdp_steps, self.sdp_eta)
        return mcla_moments(m, P, at_1d(func), jacobian, cov, delta,
                            self.num_particles, self.generator, eps)


class BankDraws(NamedTuple):
    """The randomness of a composite bank's run: ``init`` (M, dx) standard
    normals of the initial means; ``steps`` (T, M, 2, N, dx) of a
    stochastic filter's particles, None for a deterministic one."""

    init: torch.Tensor
    steps: Optional[torch.Tensor] = None


class GaussSumFilt:
    """Composite Gaussian-sum bank over any :class:`GaussFilt`: the
    filter's step mapped over the components (``torch.func.vmap``), the
    weights by the innovation likelihoods. ``run`` returns time-major
    ``(means (T, M, dx), covs (T, M, dx, dx), weights (T, M), point_est
    (T, dx))``, the point estimate the weighted mixture mean."""

    def __init__(self, gauss_filt: GaussFilt, num_models: int):
        self.M = num_models
        self.num_models = num_models
        self.gf = gauss_filt
        self.dx = gauss_filt.dx
        self.dy = gauss_filt.dy

    def __str__(self):
        return "gf.GSF"

    def run(self, ys, m0, P0, verbose: bool = False,
            generator: Optional[torch.Generator] = None,
            draws: Optional[BankDraws] = None):
        """``draws`` or ``generator`` (else the filter's) give the initial
        means m0 + N(0, I) and the filter's particles."""
        dev = self.gf.Q.device
        ys = as_tensor(ys, dev)
        m0, P0 = as_tensor(m0, dev), as_tensor(P0, dev)
        gen = self.gf.generator if generator is None else generator
        M = self.M
        init = None if draws is None else draws.init
        means = m0 + standard_normal((M, self.dx), m0, gen, init)
        covs = P0.expand(M, self.dx, self.dx)
        w = m0.new_full((M,), 1.0 / M)
        out = []
        for t in range(ys.shape[0]):
            if draws is not None and draws.steps is not None:
                eps = draws.steps[t]
            else:
                eps = self.gf.step_draws(m0, gen, (M,))
            step = torch.func.vmap(self.gf._step, in_dims=(
                0, 0, None, None if eps is None else 0))
            m_f, P_f, lls, _, _ = step(means, covs, ys[t], eps)
            w = w * torch.exp(lls - lls.max())
            w = w / w.sum()
            means, covs = m_f, P_f
            out.append((m_f, P_f, w, w @ m_f))
        return tuple(torch.stack(o) for o in zip(*out))


__all__ = ["SSM", "GaussFilt", "UKF", "MCF", "EKF", "MCLAF", "GaussSumFilt",
           "SimulateDraws", "BankDraws"]
