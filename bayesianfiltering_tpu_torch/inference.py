"""Filter entry points: the EKF, the Gaussian-sum filter and the AGSF
(counterpart of ``bayesianfiltering_tpu/inference.py``).

Each filter is a Python loop over time of batched step primitives; the
linear algebra of every step runs in the CUDA kernels K1–K4 on CUDA
tensors (through ``ops.fused_ekf`` and ``ops.bank_update``) and in their
plain twins on CPU tensors. The EKF takes a written-out leading batch of
sequences; the mixture filters use the component axis as the kernels'
batch.

Randomness: every stochastic entry point takes a ``torch.Generator`` or its
standard-normal / uniform draws made beforehand (:class:`AGSFDraws`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from bayesianfiltering_tpu_torch import containers
from bayesianfiltering_tpu_torch.containers import GaussianSum, split_gaussian_sum
from bayesianfiltering_tpu_torch.distributions import mvn_sample, standard_normal
from bayesianfiltering_tpu_torch.models.params import ParamsNLSSM
from bayesianfiltering_tpu_torch.ops import bank_update as _bank
from bayesianfiltering_tpu_torch.ops import fused_ekf as _fused
from bayesianfiltering_tpu_torch.utils import resampling as _rs

# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _get_params(x, dim, t):
    """Per-step slice of an optionally time-varying parameter stack."""
    return x[t] if x.ndim == dim + 1 else x


def _process_input(inputs, num_timesteps, like):
    if inputs is None:
        return like.new_zeros(num_timesteps, 1)
    return inputs


def _predict_input(inputs, t, num_timesteps: int):
    """Input of the t → t+1 transition: the generative model is
    ``x_{t+1} = f(x_t, q, u_{t+1})``, so the update-then-predict filters
    predict with ``u_{t+1}`` (the last step clamps to the last input)."""
    return inputs[min(t + 1, num_timesteps - 1)]


def _jacobians(params: ParamsNLSSM):
    """Model functions and Jacobians: analytic when the params provide
    them, ``torch.func.jacfwd`` otherwise. All act on one state."""
    f, h = params.dynamics_function, params.emission_function
    jac = torch.func.jacfwd
    return (
        f,
        h,
        params.dynamics_jacobian_x or jac(f, argnums=0),
        params.emission_jacobian_x or jac(h, argnums=0),
        params.dynamics_jacobian_q or jac(f, argnums=1),
        params.emission_jacobian_r or jac(h, argnums=1),
    )


def _slice_noise(params: ParamsNLSSM, t):
    Q = _get_params(params.dynamics_noise_covariance, 2, t)
    q0 = _get_params(params.dynamics_noise_bias, 1, t)
    R = _get_params(params.emission_noise_covariance, 2, t)
    r0 = _get_params(params.emission_noise_bias, 1, t)
    return Q, q0, R, r0


# ---------------------------------------------------------------------------
# Posterior containers
# ---------------------------------------------------------------------------


class PosteriorGaussianSumFiltered(NamedTuple):
    """Gaussian-sum filtering marginals, component axis first:
    ``weights`` (M, T), ``means`` (M, T, dx), ``covariances``
    (M, T, dx, dx), plus the marginal log-likelihood."""

    weights: Optional[torch.Tensor] = None
    means: Optional[torch.Tensor] = None
    covariances: Optional[torch.Tensor] = None
    predicted_means: Optional[torch.Tensor] = None
    predicted_covariances: Optional[torch.Tensor] = None
    marginal_loglik: Optional[torch.Tensor] = None


class PosteriorGaussianFiltered(NamedTuple):
    """Single-Gaussian filtering posterior; time axis after any batch
    axis."""

    marginal_loglik: torch.Tensor
    filtered_means: torch.Tensor
    filtered_covariances: torch.Tensor
    predicted_means: torch.Tensor
    predicted_covariances: torch.Tensor


# ---------------------------------------------------------------------------
# EKF
# ---------------------------------------------------------------------------


def extended_kalman_filter(
    params: ParamsNLSSM,
    emissions: torch.Tensor,
    num_iter: int = 1,
    inputs: Optional[torch.Tensor] = None,
    jitter: float = 0.0,
    compat_scalar: bool = False,
    update_chunk: Optional[int] = None,
) -> PosteriorGaussianFiltered:
    """First-order (iterated) EKF for non-additive-noise nonlinear SSMs.

    ``emissions`` is (T, dy) or a batch of sequences (B, T, dy); the
    outputs carry the same leading batch axis. ``inputs`` (T, ...) is
    shared by the batch. Update-then-predict per step; the marginal
    log-likelihood accumulates the innovation densities. Each step is one
    K1 launch per iteration and one K2 launch on CUDA tensors.

    ``compat_scalar`` and ``update_chunk`` are not ported yet.
    """
    if compat_scalar:
        raise NotImplementedError("compat_scalar is not ported yet")
    if update_chunk is not None:
        raise NotImplementedError("update_chunk is not ported yet")
    batched = emissions.ndim == 3
    E = emissions if batched else emissions[None]
    B, T = E.shape[:2]
    f, h, F_x, H_x, F_q, H_r = _jacobians(params)
    inputs = _process_input(inputs, T, E)
    residual_fn = params.emission_residual
    dx = params.initial_mean.shape[-1]

    m = params.initial_mean.expand(B, dx)
    P = params.initial_covariance.expand(B, dx, dx)
    ll = E.new_zeros(B)
    fm, pm = E.new_empty(B, T, dx), E.new_empty(B, T, dx)
    fP, pP = E.new_empty(B, T, dx, dx), E.new_empty(B, T, dx, dx)
    for t in range(T):
        Q, q0, R, r0 = _slice_noise(params, t)
        upd = _fused.fused_ekf_condition_on_iterated(
            m, P, h, H_x, H_r, R, r0, inputs[t], E[:, t], num_iter, jitter,
            residual_fn)
        m, P, _ = _fused.fused_ekf_predict(
            upd.mean, upd.cov, f, F_x, F_q, Q, q0,
            _predict_input(inputs, t, T))
        ll = ll + upd.log_likelihood
        fm[:, t], fP[:, t], pm[:, t], pP[:, t] = upd.mean, upd.cov, m, P
    post = PosteriorGaussianFiltered(ll, fm, fP, pm, pP)
    return post if batched else PosteriorGaussianFiltered(*(x[0] for x in post))


# ---------------------------------------------------------------------------
# Gaussian-sum filter (a bank of EKFs)
# ---------------------------------------------------------------------------


def _init_mixture(params: ParamsNLSSM, num_components: int,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None):
    """M means sampled from the initial distribution (``eps`` (M, dx) are
    the standard normals), the shared initial covariance, uniform
    weights."""
    means = mvn_sample(params.initial_mean, params.initial_covariance,
                       (num_components,), generator, eps)
    covs = params.initial_covariance.expand(
        (num_components,) + params.initial_covariance.shape)
    weights = means.new_full((num_components,), 1.0 / num_components)
    return weights, means, covs


def _reweight(lls, weights):
    """Log-space weight update; also returns the incremental marginal
    likelihood log Σ_m w_m exp(ll_m). The shift by max(log w + ll) makes
    the dominant term exactly 1, so the normalizer cannot underflow."""
    logw = torch.log(weights) + lls
    shift = logw.max()
    unnorm = torch.exp(logw - shift)
    total = unnorm.sum()
    return unnorm / total, torch.log(total) + shift


def gaussian_sum_filter(
    params: ParamsNLSSM,
    emissions: torch.Tensor,
    num_components: int = 1,
    num_iter: int = 1,
    inputs: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    jitter: float = 0.0,
    init_eps: Optional[torch.Tensor] = None,
) -> PosteriorGaussianSumFiltered:
    """Gaussian-sum filter: a bank of M (iterated) EKFs on ``emissions``
    (T, dy). The initial means come from ``generator`` or from the
    standard normals ``init_eps`` (M, dx). Each step is one K3 and one K4
    launch on CUDA tensors (K1/K2 when a dimension exceeds 8)."""
    T = emissions.shape[0]
    f, h, F_x, H_x, F_q, H_r = _jacobians(params)
    inputs = _process_input(inputs, T, emissions)
    residual_fn = params.emission_residual

    weights, pred_means, pred_covs = _init_mixture(params, num_components,
                                                   generator, init_eps)
    ll = emissions.new_zeros(())
    out = {k: [] for k in ("weights", "means", "covariances",
                           "predicted_means", "predicted_covariances")}
    for t in range(T):
        Q, q0, R, r0 = _slice_noise(params, t)
        upd = _bank.bank_ekf_condition_on_iterated(
            pred_means, pred_covs, h, H_x, H_r, R, r0, inputs[t],
            emissions[t], num_iter, jitter, residual_fn)
        weights, step_ll = _reweight(upd.log_likelihood, weights)
        pred_means, pred_covs, _ = _bank.bank_ekf_predict(
            upd.mean, upd.cov, f, F_x, F_q, Q, q0,
            _predict_input(inputs, t, T))
        ll = ll + step_ll
        for k, v in (("weights", weights), ("means", upd.mean),
                     ("covariances", upd.cov), ("predicted_means", pred_means),
                     ("predicted_covariances", pred_covs)):
            out[k].append(v)
    return PosteriorGaussianSumFiltered(
        marginal_loglik=ll,
        **{k: torch.stack(v, dim=1) for k, v in out.items()})


# ---------------------------------------------------------------------------
# Augmented Gaussian-sum filter
# ---------------------------------------------------------------------------


class AGSFDraws(NamedTuple):
    """The randomness of one AGSF run: ``init`` (M, dx) standard normals of
    the initial means; ``split1`` (T, M, N, dx) and ``split2``
    (T, M·N, L, dx) standard normals of the two splits; ``reduce`` the
    reduction's uniforms per step — (T,) for "systematic", (T, M) for
    "multinomial" and "stratified", None for "topk"."""

    init: torch.Tensor
    split1: torch.Tensor
    split2: torch.Tensor
    reduce: Optional[torch.Tensor]


def agsf_draws(generator: torch.Generator, num_timesteps: int,
               num_components: Sequence[int], state_dim: int,
               reduction: str, like: torch.Tensor) -> AGSFDraws:
    """Fresh :class:`AGSFDraws` from ``generator``, in ``like``'s dtype and
    device."""
    M, N, L = (int(c) for c in num_components)
    T = int(num_timesteps)
    normal = lambda *shape: standard_normal(shape, like, generator)
    reduce = None
    if reduction in _rs.UNIFORM_SHAPES:
        reduce = torch.rand((T,) + _rs.UNIFORM_SHAPES[reduction](M),
                            generator=generator, dtype=like.dtype,
                            device=like.device)
    return AGSFDraws(normal(M, state_dim), normal(T, M, N, state_dim),
                     normal(T, M * N, L, state_dim), reduce)


def _select_split_cov(strategy: str, alpha, covs):
    """Splitting covariances ("autocov"), batched over components: "prop"
    Δ = α·P (the reference's active branch), "eye" Δ = α·I. "sdp" and
    "trace" are not ported yet."""
    if strategy == "prop":
        return alpha * covs
    if strategy == "eye":
        dx = covs.shape[-1]
        eye = torch.eye(dx, dtype=covs.dtype, device=covs.device)
        return (alpha * eye).expand(covs.shape)
    if strategy in ("sdp", "trace"):
        raise NotImplementedError(f"autocov={strategy!r} is not ported yet")
    raise ValueError(f"unknown autocov strategy {strategy!r}")


def _agsf_engine(params: ParamsNLSSM, emissions, num_components, draws,
                 opt_args, inputs, reduction, autocov, num_iter, jitter):
    """AGSF loop: split → predict → split → update → reweight → reduce.
    Per step: one K4 (predict of M·N) and one K3 (update of M·N·L) launch
    per iteration on CUDA tensors."""
    M, N, L = (int(c) for c in num_components)
    T = emissions.shape[0]
    f, h, F_x, H_x, F_q, H_r = _jacobians(params)
    inputs = _process_input(inputs, T, emissions)
    residual_fn = params.emission_residual
    alpha0, alpha1 = opt_args

    weights, means, covs = _init_mixture(params, M, eps=draws.init)
    outputs = {"weights": [], "means": [], "covariances": []}
    aux = {k: [] for k in ("Deltas", "Lambdas", "updated_means", "pre_weights",
                           "step_loglik", "grads_dyn", "grads_obs", "gain")}
    for t in range(T):
        Q, q0, R, r0 = _slice_noise(params, t)
        u, y = inputs[t], emissions[t]

        # autocov 1 + branch 1: M -> M·N, then predict
        deltas = _select_split_cov(autocov, alpha0, covs)
        to_predict = split_gaussian_sum(GaussianSum(means, covs, weights),
                                        deltas, N, eps=draws.split1[t])
        pred_means, pred_covs, grads_dyn = _bank.bank_ekf_predict(
            to_predict.means, to_predict.covariances, f, F_x, F_q, Q, q0, u)

        # autocov 2 + branch 2: M·N -> M·N·L, then update
        lambdas = _select_split_cov(autocov, alpha1, pred_covs)
        to_update = split_gaussian_sum(
            GaussianSum(pred_means, pred_covs, to_predict.weights), lambdas, L,
            eps=draws.split2[t])
        upd = _bank.bank_ekf_condition_on_iterated(
            to_update.means, to_update.covariances, h, H_x, H_r, R, r0, u, y,
            num_iter, jitter, residual_fn)
        new_weights, step_ll = _reweight(upd.log_likelihood, to_update.weights)

        # reduce M·N·L -> M
        reduced = containers.reduce_gaussian_sum(
            GaussianSum(upd.mean, upd.cov, new_weights), M, reduction,
            u=None if draws.reduce is None else draws.reduce[t])
        means, covs, weights = reduced

        outputs["weights"].append(weights)
        outputs["means"].append(means)
        outputs["covariances"].append(covs)
        for k, v in (("Deltas", deltas), ("Lambdas", lambdas),
                     ("updated_means", upd.mean), ("pre_weights", new_weights),
                     ("step_loglik", step_ll), ("grads_dyn", grads_dyn),
                     ("grads_obs", upd.jacobian), ("gain", upd.gain)):
            aux[k].append(v)

    aux = {k: torch.stack(v) for k, v in aux.items()}
    posterior = PosteriorGaussianSumFiltered(
        torch.stack(outputs["weights"], dim=1),
        torch.stack(outputs["means"], dim=1),
        torch.stack(outputs["covariances"], dim=1),
        marginal_loglik=aux.pop("step_loglik").sum(),
    )
    return posterior, aux


def augmented_gaussian_sum_filter(
    params: ParamsNLSSM,
    emissions: torch.Tensor,
    num_components: Sequence[int],
    generator: Optional[torch.Generator] = None,
    num_iter: int = 1,
    opt_args: Tuple[float, float] = (0.1, 0.1),
    inputs: Optional[torch.Tensor] = None,
    autocov: str = "prop",
    reduction: str = "multinomial",
    compat_fixed_keys: bool = False,
    jitter: float = 0.0,
    draws: Optional[AGSFDraws] = None,
):
    """Augmented Gaussian-sum filter (AGSF) with EKF moments on
    ``emissions`` (T, dy), ``num_components`` = [M, N, L].

    Per step: select the splitting covariances Δ (``autocov``), branch each
    of the M components into N, EKF-predict, select Λ, branch into L,
    EKF-update, reweight, and reduce back to M components (``reduction`` ∈
    {"multinomial", "systematic", "stratified", "topk"}). The randomness
    comes from ``generator`` or from ``draws`` (:class:`AGSFDraws`).

    Returns ``(posterior, aux)``; ``aux`` holds the per-step Deltas,
    Lambdas, updated means, pre-reduction weights, Jacobians and gains,
    stacked along a leading time axis. ``compat_fixed_keys`` (the
    reference's fixed keys) is not ported.
    """
    if compat_fixed_keys:
        raise NotImplementedError("compat_fixed_keys is not ported")
    if reduction == "optimal":
        raise NotImplementedError("optimal reduction is not ported yet")
    if draws is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the draws")
        draws = agsf_draws(generator, emissions.shape[0], num_components,
                           params.initial_mean.shape[-1], reduction, emissions)
    return _agsf_engine(params, emissions, num_components, draws, opt_args,
                        inputs, reduction, autocov, num_iter, jitter)


# The reference's vectorized rewrite is this package's only implementation.
speedy_augmented_gaussian_sum_filter = augmented_gaussian_sum_filter


__all__ = [
    "PosteriorGaussianFiltered",
    "PosteriorGaussianSumFiltered",
    "AGSFDraws",
    "agsf_draws",
    "extended_kalman_filter",
    "gaussian_sum_filter",
    "augmented_gaussian_sum_filter",
    "speedy_augmented_gaussian_sum_filter",
]
