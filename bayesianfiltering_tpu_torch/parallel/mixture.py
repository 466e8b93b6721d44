"""Mixture-sharded Gaussian-sum filters: the component bank split over the
mesh axis (counterpart of ``bayesianfiltering_tpu/parallel/mixture.py``).

The banks' moments are local (K3/K4 on the card over the rank's M/n
components, or K7–K9 with UKF moments); the only traffic of the GSF is the
weights' normalisation, two scalar all-reduces a step. The AGSF
(:func:`sharded_agsf`) runs the flagship split → predict → split →
update → reduce with M/n components a rank and, for the M·N·L → M
reduction, either

* gathers the updated bank (means, covariances, log-likelihoods and
  weights) to every rank, where the single-process engine's own
  reweighting runs on the whole bank, with no partial sums; rank 0 picks
  the kept indices (and the optimal reduction's weights) and broadcasts
  them, so that the ranks cannot disagree on a count, and each rank keeps
  its slice: the single-process engine's result on the same draws; or
* with ``reduction="local"``, reweights by two scalar all-reduces and
  resamples each rank's M·N·L/n → M/n against its locally renormalised
  weights, keeping its mass: no bank traffic, statistically equivalent,
  not the same draws.

Randomness: the initial means and the split noise are global — the
single-process engine's draws (:class:`~bayesianfiltering_tpu_torch.inference.AGSFDraws`,
or ``init_eps`` for the GSF), the same on every rank, each rank reading
its slice; from a generator, rank 0 draws them and broadcasts. The
reduction's uniforms are global too, except with ``reduction="local"``,
where ``draws.reduce`` (T,) are the rank's own.

Outputs are component-major, (M, T, …), gathered to every rank once at
the end; the marginal log-likelihood is the same on every rank.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from bayesianfiltering_tpu_torch import inference as _inf
from bayesianfiltering_tpu_torch.containers import (
    GaussianSum,
    reduction_indices,
    split_gaussian_sum,
)
from bayesianfiltering_tpu_torch.distributions import standard_normal
from bayesianfiltering_tpu_torch.inference import (
    AGSFDraws,
    PosteriorGaussianSumFiltered,
)
from bayesianfiltering_tpu_torch.models.params import ParamsNLSSM
from bayesianfiltering_tpu_torch.ops import bank_update as _bank
from bayesianfiltering_tpu_torch.ops import fused_ut as _fut
from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF
from bayesianfiltering_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    broadcast,
    pmax,
    psum,
)
from bayesianfiltering_tpu_torch.utils import resampling as _rs


def _global(x: Optional[torch.Tensor], shape, like, generator, mesh: Mesh):
    """A global draw: ``x`` as given (the same on every rank), or rank 0's
    standard normals of ``shape`` from ``generator``, broadcast to every
    rank."""
    if x is not None:
        return x.to(dtype=like.dtype, device=like.device)
    if generator is None:
        raise ValueError("pass a torch.Generator or the draws")
    if mesh.rank == 0:
        x = standard_normal(shape, like, generator)
    else:
        x = like.new_empty(shape)
    return broadcast(x, mesh)


def _reweight(lls, weights, mesh: Mesh):
    """``inference._reweight`` over the whole bank: the largest term and
    the normaliser by two all-reduces."""
    logw = torch.log(weights) + lls
    shift = pmax(logw.max(), mesh)
    unnorm = torch.exp(logw - shift)
    total = psum(unnorm.sum(), mesh)
    return unnorm / total, torch.log(total) + shift


def _gather_outputs(steps, mesh: Mesh):
    """Per-step local (M/n, …) outputs → (M, T, …) on every rank."""
    return {k: all_gather(torch.stack(v, dim=1), mesh, tiled=True)
            for k, v in steps.items()}


def sharded_gaussian_sum_filter(
    params: ParamsNLSSM,
    emissions: torch.Tensor,
    num_components: int,
    mesh: Mesh,
    generator: Optional[torch.Generator] = None,
    num_iter: int = 1,
    inputs: Optional[torch.Tensor] = None,
    axis_name: str = "mixture",
    jitter: float = 0.0,
    init_eps: Optional[torch.Tensor] = None,
) -> PosteriorGaussianSumFiltered:
    """:func:`~bayesianfiltering_tpu_torch.inference.gaussian_sum_filter`
    with the bank split over ``mesh``; every rank passes the whole
    ``emissions`` (T, dy). The initial means are drawn globally
    (``init_eps`` (M, dx) standard normals, or rank 0's draw from
    ``generator``) and sliced. Each step is one K3 and one K4 launch a
    rank on the card and two scalar all-reduces. Raises ValueError when M
    does not divide over the axis."""
    mesh.check_axis(axis_name)
    M = int(num_components)
    start, stop = mesh.block(M, "num_components")
    T = emissions.shape[0]
    f, h, F_x, H_x, F_q, H_r = _inf._jacobians(params)
    inputs = _inf._process_input(inputs, T, emissions)
    residual_fn = params.emission_residual
    dx = params.initial_mean.shape[-1]
    eps = _global(init_eps, (M, dx), emissions, generator, mesh)
    weights, means, covs = (x[start:stop] for x in
                            _inf._init_mixture(params, M, eps=eps))

    ll = emissions.new_zeros(())
    out = {k: [] for k in ("weights", "means", "covariances",
                           "predicted_means", "predicted_covariances")}
    for t in range(T):
        Q, q0, R, r0 = _inf._slice_noise(params, t)
        upd = _bank.bank_ekf_condition_on_iterated(
            means, covs, h, H_x, H_r, R, r0, inputs[t], emissions[t],
            num_iter, jitter, residual_fn)
        weights, step_ll = _reweight(upd.log_likelihood, weights, mesh)
        means, covs, _ = _bank.bank_ekf_predict(
            upd.mean, upd.cov, f, F_x, F_q, Q, q0,
            _inf._predict_input(inputs, t, T))
        ll = ll + step_ll
        for k, v in (("weights", weights), ("means", upd.mean),
                     ("covariances", upd.cov), ("predicted_means", means),
                     ("predicted_covariances", covs)):
            out[k].append(v)
    return PosteriorGaussianSumFiltered(marginal_loglik=ll,
                                        **_gather_outputs(out, mesh))


def _agsf_draws(draws, generator, T, comps, dx, reduction, like,
                mesh: Mesh) -> AGSFDraws:
    """The run's draws: as given, or the global normals (and, but for the
    local reduction, the global uniforms) drawn by rank 0 and broadcast;
    the local reduction's uniforms from each rank's generator."""
    M, N, L = comps
    local = reduction == "local"
    if draws is not None:
        return draws
    if generator is None:
        raise ValueError("pass a torch.Generator or the draws")
    kind = "systematic" if local else reduction
    glob = (_inf.agsf_draws(generator, T, comps, dx, kind, like)
            if mesh.rank == 0 else None)
    shapes = ((M, dx), (T, M, N, dx), (T, M * N, L, dx))
    init, split1, split2 = (broadcast(
        glob[i] if glob is not None else like.new_empty(s), mesh)
        for i, s in enumerate(shapes))
    if local:
        reduce = torch.rand(T, generator=generator, dtype=like.dtype,
                            device=like.device)
    elif kind in _rs.UNIFORM_SHAPES:
        shape = (T,) + _rs.UNIFORM_SHAPES[kind](M, M * N * L)
        reduce = broadcast(glob.reduce if glob is not None
                           else like.new_empty(shape), mesh)
    else:
        reduce = None
    return AGSFDraws(init, split1, split2, reduce)


def sharded_agsf(
    params: ParamsNLSSM,
    emissions: torch.Tensor,
    num_components: Sequence[int],
    mesh: Mesh,
    generator: Optional[torch.Generator] = None,
    num_iter: int = 1,
    opt_args: Tuple[float, float] = (0.1, 0.1),
    inputs: Optional[torch.Tensor] = None,
    axis_name: str = "mixture",
    moments: str = "ekf",
    uparams: Optional[ParamsUKF] = None,
    reduction: str = "systematic",
    autocov: str = "prop",
    jitter: float = 0.0,
    draws: Optional[AGSFDraws] = None,
) -> PosteriorGaussianSumFiltered:
    """The AGSF with its mixture split over ``mesh``: M/n components a
    rank, branched to M·N·L/n locally; every rank passes the whole
    ``emissions`` (T, dy).

    ``draws`` are the single-process engine's
    (:class:`~bayesianfiltering_tpu_torch.inference.AGSFDraws`: ``init``
    (M, dx), ``split1`` (T, M, N, dx), ``split2`` (T, M·N, L, dx) the same
    on every rank; ``reduce`` the global uniforms, or the rank's own (T,)
    for ``reduction="local"``). With a gathered reduction the result is
    the single-process
    :func:`~bayesianfiltering_tpu_torch.inference.augmented_gaussian_sum_filter`'s
    (``moments="ukf"``: :func:`~bayesianfiltering_tpu_torch.inference.unscented_agsf`'s)
    on the same draws. Per step
    and rank on the card: one K4 and one K3 launch (K7+K9 and K7+K8 with
    UKF moments), K5 on rank 0 (gathered) or on every rank (local) for a
    systematic reduction. The auxiliary outputs of the single-process
    filter are not returned. Raises ValueError when M does not divide over
    the axis."""
    mesh.check_axis(axis_name)
    comps = tuple(int(c) for c in num_components)
    M, N, L = comps
    start, stop = mesh.block(M, "num_components[0]")
    Ml = stop - start
    T = emissions.shape[0]
    use_ekf = moments == "ekf"
    local = reduction == "local"
    f, h, F_x, H_x, F_q, H_r = _inf._jacobians(params)
    F_xx, H_xx = torch.func.jacrev(F_x), torch.func.jacrev(H_x)
    if not use_ekf:
        ukf_condition = _inf._ukf_condition(num_iter, params.emission_residual)
    inputs = _inf._process_input(inputs, T, emissions)
    residual_fn = params.emission_residual
    alpha0, alpha1 = opt_args
    dx = params.initial_mean.shape[-1]
    draws = _agsf_draws(draws, generator, T, comps, dx, reduction, emissions,
                        mesh)

    weights, means, covs = (x[start:stop] for x in _inf._init_mixture(
        params, M, eps=draws.init.to(emissions)))
    sl1, sl2 = slice(start, stop), slice(start * N, stop * N)
    out = {"weights": [], "means": [], "covariances": []}
    ll = emissions.new_zeros(())
    for t in range(T):
        Q, q0, R, r0 = _inf._slice_noise(params, t)
        u, y = inputs[t], emissions[t]

        # autocov 1 + branch 1: M/n -> M·N/n, then predict
        deltas = _inf._select_split_cov(autocov, alpha0, means, covs, F_x,
                                        F_xx, N, q0, u)
        to_predict = split_gaussian_sum(
            GaussianSum(means, covs, weights), deltas, N,
            eps=draws.split1[t, sl1].to(emissions))
        if use_ekf:
            pred_means, pred_covs, _ = _bank.bank_ekf_predict(
                to_predict.means, to_predict.covariances, f, F_x, F_q, Q, q0,
                u)
        else:
            pred_means, pred_covs = _fut.fused_ukf_predict_nonadditive(
                to_predict.means, to_predict.covariances, f, u, Q, uparams,
                q0)

        # autocov 2 + branch 2: M·N/n -> M·N·L/n, then update
        lambdas = _inf._select_split_cov(autocov, alpha1, pred_means,
                                         pred_covs, H_x, H_xx, L, r0, u)
        to_update = split_gaussian_sum(
            GaussianSum(pred_means, pred_covs, to_predict.weights), lambdas,
            L, eps=draws.split2[t, sl2].to(emissions))
        if use_ekf:
            upd = _bank.bank_ekf_condition_on_iterated(
                to_update.means, to_update.covariances, h, H_x, H_r, R, r0,
                u, y, num_iter, jitter, residual_fn)
            lls, upd_means, upd_covs = upd.log_likelihood, upd.mean, upd.cov
        else:
            lls, upd_means, upd_covs = ukf_condition(
                to_update.means, to_update.covariances, h, R, u, y, uparams,
                r0)
        u_red = None if draws.reduce is None else draws.reduce[t].to(
            emissions)
        if local:
            new_w, step_ll = _reweight(lls, to_update.weights, mesh)
            # the rank's own mass-preserving comb: no bank traffic
            local_mass = new_w.sum()
            lw = torch.where(local_mass > 0, new_w / local_mass,
                             1.0 / new_w.shape[0])
            idx = _rs.systematic_resample(lw, Ml, u=u_red)
            means, covs = upd_means[idx], upd_covs[idx]
            weights = new_w.new_full((Ml,), 1.0 / Ml) * local_mass
        else:
            # the whole bank, reweighted on every rank by the
            # single-process engine's own operations (no partial sums)
            g_m = all_gather(upd_means, mesh, tiled=True)
            g_P = all_gather(upd_covs, mesh, tiled=True)
            g_w, step_ll = _inf._reweight(
                all_gather(lls, mesh, tiled=True),
                all_gather(to_update.weights, mesh, tiled=True))
            if mesh.rank == 0:
                idx, kept = reduction_indices(g_w, M, reduction, u=u_red)
            else:
                idx = torch.empty(M, dtype=torch.int64, device=g_w.device)
                kept = g_w.new_empty(M)
            idx, kept = broadcast(idx, mesh), broadcast(kept, mesh)
            means, covs = g_m[idx[sl1]], g_P[idx[sl1]]
            weights = kept[sl1]
        ll = ll + step_ll
        out["weights"].append(weights)
        out["means"].append(means)
        out["covariances"].append(covs)
    return PosteriorGaussianSumFiltered(marginal_loglik=ll,
                                        **_gather_outputs(out, mesh))


__all__ = ["sharded_gaussian_sum_filter", "sharded_agsf"]
