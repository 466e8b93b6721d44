"""ALA static mean estimators: estimators of E[g(x)], x ~ N(m, P)
(counterpart of ``bayesianfiltering_tpu/legacy/mean_estimators.py``).

* :func:`mc_estimate`: plain Monte Carlo;
* :func:`mcl_estimate`: MC-linear, samples from the deflated N(m, P − Δ);
* :func:`mcq_estimate`: MC-quadratic, MCL plus ½ tr(H̄ Δ) with H̄ the
  sample-averaged Hessian;
* :func:`mc2_estimate`: two-stage MC with importance-sampling allocation,
  each outer sample with a fixed inner batch weighted by its allocation
  probability (the JAX package's fixed-shape form);
* :func:`simple_quadratic_estimate` / :func:`smart_quadratic_estimate`:
  g(m) + ½ tr(H(m) P) / ½ tr(H(m) Δ);
* :func:`optimal_delta` and :func:`compare_estimators`, the estimators'
  variance and MSE against a large-sample baseline.

``g`` acts on one state. Randomness: a ``torch.Generator`` or the standard
normals drawn beforehand (``eps``, or :class:`CompareDraws`).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from bayesianfiltering_tpu_torch.distributions import mvn_logpdf, mvn_sample
from bayesianfiltering_tpu_torch.utils.sdp import sdp_opt_legacy

vmap = torch.func.vmap


def _scalarize(g: Callable):
    return lambda x: torch.atleast_1d(g(x)).squeeze()


def _hessian(gs: Callable, dx: int):
    hess = torch.func.jacfwd(torch.func.jacrev(gs))
    return lambda x: hess(x).reshape(dx, dx)


def mc_estimate(g: Callable, m, P, num_samples: int,
                generator: Optional[torch.Generator] = None, eps=None):
    """Plain Monte-Carlo estimate of E[g(x)]; ``eps`` (num_samples, dx)."""
    xs = mvn_sample(m, P, (num_samples,), generator, eps)
    return vmap(_scalarize(g))(xs).mean()


def mcl_estimate(g: Callable, m, P, delta, num_samples: int,
                 generator: Optional[torch.Generator] = None, eps=None):
    """MC-linear: g averaged over samples from N(m, P − Δ)."""
    xs = mvn_sample(m, P - delta, (num_samples,), generator, eps)
    return vmap(_scalarize(g))(xs).mean()


def mcq_estimate(g: Callable, m, P, delta, num_samples: int,
                 generator: Optional[torch.Generator] = None, eps=None):
    """MC-quadratic: MCL plus ½ tr(H̄ Δ), H̄ the Hessian averaged over the
    samples."""
    gs = _scalarize(g)
    dx = m.shape[-1]
    xs = mvn_sample(m, P - delta, (num_samples,), generator, eps)
    H = vmap(_hessian(gs, dx))(xs).mean(0)
    return vmap(gs)(xs).mean() + 0.5 * torch.trace(H @ delta)


def mc2_estimate(g: Callable, m, P, delta, num_outer: int, num_inner: int,
                 generator: Optional[torch.Generator] = None, eps=None):
    """Two-stage MC: outer z ~ N(m, P), allocation ∝ N(z; m, P − Δ) /
    N(z; m, P), inner x ~ N(z, Δ), ``num_inner`` of them for every z.
    ``eps`` is the pair (outer (num_outer, dx), inner (num_inner,
    num_outer, dx))."""
    gs = _scalarize(g)
    e_out, e_in = (None, None) if eps is None else eps
    outer = mvn_sample(m, P, (num_outer,), generator, e_out)
    log_alloc = mvn_logpdf(outer, m, P - delta) - mvn_logpdf(outer, m, P)
    alloc = torch.softmax(log_alloc, 0)
    inner = mvn_sample(outer, delta.expand((num_outer,) + delta.shape),
                       (num_inner,), generator, e_in)
    vals = vmap(vmap(gs))(inner)  # (num_inner, num_outer)
    return (alloc * vals.mean(0)).sum()


def simple_quadratic_estimate(g: Callable, m, P):
    """g(m) + ½ tr(H(m) P)."""
    gs = _scalarize(g)
    return gs(m) + 0.5 * torch.trace(_hessian(gs, m.shape[-1])(m) @ P)


def smart_quadratic_estimate(g: Callable, m, P, delta):
    """g(m) + ½ tr(H(m) Δ)."""
    gs = _scalarize(g)
    return gs(m) + 0.5 * torch.trace(_hessian(gs, m.shape[-1])(m) @ delta)


def optimal_delta(g: Callable, m, P, num_samples: int, lip: float = 0.1,
                  steps: int = 10, eta: float = 0.01):
    """The splitting covariance of :func:`sdp_opt_legacy` at the mean's
    Hessian."""
    dx = m.shape[-1]
    H = _hessian(_scalarize(g), dx)(m)
    return sdp_opt_legacy(dx, num_samples, lip, P, P, H, steps, eta)


class CompareDraws(NamedTuple):
    """The standard normals of :func:`compare_estimators`: ``baseline``
    (baseline_samples, dx); ``trials`` (num_trials, num_samples, dx), one
    set a trial shared by MC, MCL and MCQ; ``mc2_outer`` (num_trials,
    num_samples, dx) and ``mc2_inner`` (num_trials, num_samples,
    num_samples, dx), MC2's."""

    baseline: torch.Tensor
    trials: torch.Tensor
    mc2_outer: torch.Tensor
    mc2_inner: torch.Tensor


def compare_estimators(
    g: Callable,
    m,
    P,
    delta=None,
    num_samples: int = 10,
    num_trials: int = 100,
    baseline_samples: int = 100_000,
    generator: Optional[torch.Generator] = None,
    draws: Optional[CompareDraws] = None,
) -> Dict[str, object]:
    """Each estimator's variance and MSE against a ``baseline_samples``
    MC baseline, over ``num_trials`` repetitions."""
    m = torch.atleast_1d(m)
    P = torch.atleast_2d(P)
    dx = m.shape[-1]
    if delta is None:
        delta = optimal_delta(g, m, P, num_samples)
    if draws is None:
        normal = lambda *shape: torch.randn(shape, generator=generator,
                                            dtype=m.dtype, device=m.device)
        draws = CompareDraws(
            normal(baseline_samples, dx), normal(num_trials, num_samples, dx),
            normal(num_trials, num_samples, dx),
            normal(num_trials, num_samples, num_samples, dx))
    baseline = mc_estimate(g, m, P, baseline_samples, eps=draws.baseline)

    def trial(fn):
        return torch.stack([fn(k) for k in range(num_trials)])

    mc = trial(lambda k: mc_estimate(g, m, P, num_samples,
                                     eps=draws.trials[k]))
    mcl = trial(lambda k: mcl_estimate(g, m, P, delta, num_samples,
                                       eps=draws.trials[k]))
    mcq = trial(lambda k: mcq_estimate(g, m, P, delta, num_samples,
                                       eps=draws.trials[k]))
    mc2 = trial(lambda k: mc2_estimate(
        g, m, P, delta, num_samples, num_samples,
        eps=(draws.mc2_outer[k], draws.mc2_inner[k])))

    def stats(est):
        mean = est.mean()
        var = ((est - mean) ** 2).sum() / (num_trials - 1)
        mse = ((est - baseline) ** 2).sum() / (num_trials - 1)
        return {"var": var, "mse": mse, "mean": mean}

    return {
        "baseline": baseline,
        "delta": delta,
        "mc": stats(mc),
        "mcl": stats(mcl),
        "mcq": stats(mcq),
        "mc2": stats(mc2),
        "simple_quadratic": simple_quadratic_estimate(g, m, P),
        "smart_quadratic": smart_quadratic_estimate(g, m, P, delta),
        "linear": _scalarize(g)(m),
    }


__all__ = [
    "mc_estimate",
    "mcl_estimate",
    "mcq_estimate",
    "mc2_estimate",
    "simple_quadratic_estimate",
    "smart_quadratic_estimate",
    "optimal_delta",
    "compare_estimators",
    "CompareDraws",
]
