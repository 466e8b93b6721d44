"""Filter entry points: the EKF and UKF, the Gaussian-sum filters (EKF and
UKF moments), the AGSF family and the bootstrap particle filter
(counterpart of ``bayesianfiltering_tpu/inference.py``).

Each filter is a Python loop over time of batched step primitives; the
linear algebra of every step runs in the CUDA kernels on CUDA tensors — K1–K4
for EKF moments (``ops.fused_ekf``, ``ops.bank_update``), K6–K9 for UKF
moments (``ops.fused_ut``), K5 for the systematic and stratified
resampling of the particle filter and the AGSF reductions
(``ops.resample_gather``) — and in their plain
versions on CPU tensors. The EKF and UKF take a written-out leading batch
of sequences; the mixture filters use the component axis as the kernels'
batch.

The extended and unscented RTS smoothers run the EKF or the UKF forward,
form the backward gains of every step at once (plain PyTorch, as the JAX
package's XLA) and keep only the affine recursion of the smoothed moments
as a loop. The parallel iterated smoothers
(``ops.parallel_iterated``) are re-exported here.

The AGSF's adaptive splitting rules ("sdp", "trace") evaluate the model's
Hessians (``torch.func.jacrev`` of its Jacobians) over the components and,
for "sdp", run the batched fixed point of :mod:`~bayesianfiltering_tpu_torch.utils.sdp`:
plain PyTorch, as the JAX package's XLA; the banks' moments stay in the
kernels.

Randomness: every stochastic entry point takes a ``torch.Generator`` or its
standard-normal / uniform draws made beforehand (:class:`AGSFDraws`,
:class:`BPFDraws`).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from bayesianfiltering_tpu_torch import containers
from bayesianfiltering_tpu_torch.containers import GaussianSum, split_gaussian_sum
from bayesianfiltering_tpu_torch.distributions import mvn_sample, standard_normal
from bayesianfiltering_tpu_torch.models.params import ParamsBPF, ParamsNLSSM
from bayesianfiltering_tpu_torch.ops import bank_update as _bank
from bayesianfiltering_tpu_torch.ops import ekf as _ekf
from bayesianfiltering_tpu_torch.ops import fused_ekf as _fused
from bayesianfiltering_tpu_torch.ops import fused_ut as _fut
from bayesianfiltering_tpu_torch.ops import ukf as _ukf
from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF
from bayesianfiltering_tpu_torch.utils import resampling as _rs
from bayesianfiltering_tpu_torch.utils.linalg import psd_solve, symmetrize
from bayesianfiltering_tpu_torch.utils.sdp import sdp_opt
from bayesianfiltering_tpu_torch.utils.sigma_points import (
    factor,
    points_blockdiag,
    points_from_factor,
)

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


def swap_axes_on_values(outputs: Dict, axis1: int = 0,
                        axis2: int = 1) -> Dict:
    """Every tensor of ``outputs`` with two of its axes swapped."""
    return {k: v.swapaxes(axis1, axis2) for k, v in outputs.items()}


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


def _noise_steps(params: ParamsNLSSM, ts: torch.Tensor):
    """:func:`_slice_noise` of the steps ``ts`` (a 1-D index tensor), each
    stacked along a leading step axis (a shared noise is expanded)."""
    def pick(x, dim):
        return x[ts] if x.ndim == dim + 1 else x.expand((len(ts),) + x.shape)

    return (pick(params.dynamics_noise_covariance, 2),
            pick(params.dynamics_noise_bias, 1),
            pick(params.emission_noise_covariance, 2),
            pick(params.emission_noise_bias, 1))


def _steps(fn):
    """A state-level model callable ``fn(x, noise, u)`` over a leading step
    axis of all three arguments."""
    return torch.func.vmap(fn, in_dims=(0, 0, 0))


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


class PosteriorGaussianSmoothed(NamedTuple):
    """Single-Gaussian filtering posterior and its RTS-smoothed marginals."""

    marginal_loglik: torch.Tensor
    filtered_means: torch.Tensor
    filtered_covariances: torch.Tensor
    predicted_means: torch.Tensor
    predicted_covariances: torch.Tensor
    smoothed_means: torch.Tensor
    smoothed_covariances: torch.Tensor


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

    ``update_chunk`` runs the sequential chunked measurement update
    (:func:`~bayesianfiltering_tpu_torch.ops.fused_ekf.fused_ekf_condition_on_chunked`):
    ⌈dy/update_chunk⌉ K1 launches per iteration, exact when the effective
    emission noise is block-diagonal with respect to the chunks (e.g.
    diagonal R, the Lorenz-96 dx=512 configuration), an approximation
    otherwise.

    ``compat_scalar`` runs the reference's update with its quirks
    (:func:`~bayesianfiltering_tpu_torch.ops.ekf.ekf_condition_on_ref`,
    plain linear algebra, no residual function) for golden parity, and
    keeps the reference's predict with ``u_t`` in place of ``u_{t+1}``; it
    ignores ``num_iter``, ``jitter`` and ``update_chunk``. The predict
    still runs K2.
    """
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
        if compat_scalar:
            upd = _ekf.ekf_condition_on_ref(m, P, h, H_x, H_r, R, r0,
                                            inputs[t], E[:, t])
        elif update_chunk is None:
            upd = _fused.fused_ekf_condition_on_iterated(
                m, P, h, H_x, H_r, R, r0, inputs[t], E[:, t], num_iter,
                jitter, residual_fn)
        else:
            upd = _fused.fused_ekf_condition_on_chunked(
                m, P, h, H_x, H_r, R, r0, inputs[t], E[:, t], update_chunk,
                num_iter, jitter, residual_fn)
        # the reference-exact mode keeps the reference's u_t predict
        u_next = inputs[t] if compat_scalar else _predict_input(inputs, t, T)
        m, P, _ = _fused.fused_ekf_predict(
            upd.mean, upd.cov, f, F_x, F_q, Q, q0, u_next)
        ll = ll + upd.log_likelihood
        fm[:, t], fP[:, t], pm[:, t], pP[:, t] = upd.mean, upd.cov, m, P
    post = PosteriorGaussianFiltered(ll, fm, fP, pm, pP)
    return post if batched else PosteriorGaussianFiltered(*(x[0] for x in post))


# ---------------------------------------------------------------------------
# UKF
# ---------------------------------------------------------------------------


def _ukf_condition(num_iter: int, residual_fn):
    """The non-additive UKF update: K7 and K8 for ``num_iter`` ≤ 1, the
    plain iterated posterior linearization (IPLF) for ``num_iter`` > 1."""
    def condition(m, P, h, R, u, y, uparams, r0):
        if int(num_iter) > 1:
            return _ukf.ukf_condition_on_nonadditive_iterated(
                m, P, h, R, u, y, uparams, r0, num_iter, residual_fn)
        return _fut.fused_ukf_condition_on_nonadditive(
            m, P, h, R, u, y, uparams, r0, residual_fn)
    return condition


def unscented_kalman_filter(
    params: ParamsNLSSM,
    uparams: ParamsUKF,
    emissions: torch.Tensor,
    inputs: Optional[torch.Tensor] = None,
    additive: bool = False,
    num_iter: int = 1,
) -> PosteriorGaussianFiltered:
    """UKF for nonlinear SSMs. ``additive=True`` selects the additive-noise
    quadrature (fewer sigma points), otherwise state-noise augmentation;
    ``num_iter > 1`` runs the iterated posterior-linearization update
    (IPLF, non-additive only, plain PyTorch).

    ``emissions`` is (T, dy) or a batch of sequences (B, T, dy); the
    outputs carry the same leading batch axis. Each step is, on CUDA
    tensors, K6+K8 and K6+K9 (additive) or K7+K8 and K7+K9 (augmented).
    """
    if additive and num_iter > 1:
        raise ValueError("num_iter > 1 (IPLF) is only implemented for the "
                         "non-additive quadrature; pass additive=False")
    batched = emissions.ndim == 3
    E = emissions if batched else emissions[None]
    B, T = E.shape[:2]
    f, h = params.dynamics_function, params.emission_function
    inputs = _process_input(inputs, T, E)
    residual_fn = params.emission_residual
    if additive:
        predict = _fut.fused_ukf_predict_additive

        def condition(m, P, h, R, u, y, uparams, r0):
            return _fut.fused_ukf_condition_on_additive(
                m, P, h, R, u, y, uparams, r0, residual_fn)
    else:
        predict = _fut.fused_ukf_predict_nonadditive
        condition = _ukf_condition(num_iter, residual_fn)

    dx = params.initial_mean.shape[-1]
    m = params.initial_mean.expand(B, dx)
    P = params.initial_covariance.expand(B, dx, dx)
    ll = E.new_zeros(B)
    fm, pm = E.new_empty(B, T, dx), E.new_empty(B, T, dx)
    fP, pP = E.new_empty(B, T, dx, dx), E.new_empty(B, T, dx, dx)
    for t in range(T):
        Q, q0, R, r0 = _slice_noise(params, t)
        ll_t, m_f, P_f = condition(m, P, h, R, inputs[t], E[:, t], uparams,
                                   r0)
        m, P = predict(m_f, P_f, f, _predict_input(inputs, t, T), Q,
                       uparams, q0)
        ll = ll + ll_t
        fm[:, t], fP[:, t], pm[:, t], pP[:, t] = m_f, P_f, m, P
    post = PosteriorGaussianFiltered(ll, fm, fP, pm, pP)
    return post if batched else PosteriorGaussianFiltered(*(x[0] for x in post))


# ---------------------------------------------------------------------------
# RTS smoothers
# ---------------------------------------------------------------------------


def _rts_smoothed(post: PosteriorGaussianFiltered,
                  G: torch.Tensor) -> PosteriorGaussianSmoothed:
    """The RTS recursion backwards from the last filtered marginal, with
    the gains ``G`` (..., T−1, dx, dx) of every step formed beforehand:
    ``m_s = m_f + G (m_s' − m_p)``, ``P_s = sym(P_f + G (P_s' − P_p) Gᵀ)``.
    The time axis follows any batch axis. Only this affine recursion is a
    loop."""
    _, fm, fP, pm, pP = post
    T = fm.shape[-2]
    sm, sP = [fm[..., -1, :]], [fP[..., -1, :, :]]
    for t in range(T - 2, -1, -1):
        Gt = G[..., t, :, :]
        sm.append(fm[..., t, :]
                  + (Gt @ (sm[-1] - pm[..., t, :])[..., None])[..., 0])
        sP.append(symmetrize(fP[..., t, :, :]
                             + Gt @ (sP[-1] - pP[..., t, :, :]) @ Gt.mT))
    return PosteriorGaussianSmoothed(*post, torch.stack(sm[::-1], dim=-2),
                                     torch.stack(sP[::-1], dim=-3))


def _over_steps(fn, x, noise, u):
    """``fn(x, noise, u)`` at every step of ``x`` (..., n, d): the noise
    (n, dn) and the inputs (n, ...) are per step and shared by any batch
    axes of ``x``. Returns (..., n) + the output's shape."""
    lead, n = x.shape[:-2], x.shape[-2]
    k = math.prod(lead)
    flat = x.reshape((k * n,) + x.shape[-1:])
    rep = lambda a: a.expand((k,) + a.shape).reshape((k * n,) + a.shape[1:])
    out = _steps(fn)(flat, rep(noise), rep(u))
    return out.reshape(lead + (n,) + out.shape[1:])


def _extended_rts(params: ParamsNLSSM, emissions: torch.Tensor,
                  num_iter: int = 1, inputs: Optional[torch.Tensor] = None,
                  jitter: float = 0.0):
    """:func:`extended_rts_smoother` and its gains (..., T−1, dx, dx)."""
    post = extended_kalman_filter(params, emissions, num_iter, inputs,
                                  jitter)
    fm, fP, pm, pP = post[1:]
    T, dx = fm.shape[-2:]
    if T < 2:
        return (PosteriorGaussianSmoothed(*post, *post[1:3]),
                fP[..., :0, :, :])
    F_x = _jacobians(params)[2]
    inputs = _process_input(inputs, T, emissions)
    _, q0, _, _ = _noise_steps(params, torch.arange(T - 1, device=fm.device))
    Fx = _over_steps(F_x, fm[..., :-1, :], q0, inputs[1:]).reshape(
        fm.shape[:-2] + (T - 1, dx, dx))
    G = psd_solve(pP[..., :-1, :, :], Fx @ fP[..., :-1, :, :]).mT
    return _rts_smoothed(post, G), G


def extended_rts_smoother(
    params: ParamsNLSSM,
    emissions: torch.Tensor,
    num_iter: int = 1,
    inputs: Optional[torch.Tensor] = None,
    jitter: float = 0.0,
) -> PosteriorGaussianSmoothed:
    """Extended Rauch–Tung–Striebel smoother (ERTS) of ``emissions``
    (T, dy) or of a batch of sequences (B, T, dy); ``inputs`` (T, ...) is
    shared by the batch.

    The forward pass is :func:`extended_kalman_filter` (K1 and K2 on CUDA
    tensors). The backward pass relinearises the dynamics at each filtered
    mean with the filter's ``u_{t+1}`` input, ``G_t = P_f F_x(m_f)ᵀ
    P_p⁻¹``, all gains in one batched solve, then runs the affine
    recursion of the smoothed moments. The predicted covariance already
    carries ``F_q Q F_qᵀ``."""
    return _extended_rts(params, emissions, num_iter, inputs, jitter)[0]


def _ut_dynamics_moments(f, m, P, Q, q0, u, uparams: ParamsUKF,
                         additive: bool):
    """The UKF predict's quadrature of the dynamics at N(m, P), over a
    leading step axis of every argument: ``(μ⁺, Φ, C)`` with Φ the
    points' covariance (the additive Q not added) and ``C = Dᵀ`` the
    (dx, dx) transpose of the cross-covariance ``D = Cov(x_t, x_{t+1})``.
    Non-additive: the augmented points of blkdiag(P, Q); additive: the
    state's points at zero noise."""
    dx = m.shape[-1]
    if additive:
        scale, weights = _ukf.ut_weights(dx, uparams)
        pts = points_from_factor(m, factor(P, uparams.sqrt_method), scale)
        zq = torch.zeros_like(q0)
        new_pts = _ukf.eval_step_rows(f, pts, zq, u)
        center = _steps(f)(m, zq, u)
    else:
        scale, weights = _ukf.ut_weights(dx + q0.shape[-1], uparams)
        pts = points_blockdiag(m, P, q0, Q, scale, uparams.sqrt_method)
        new_pts = _ukf.eval_step_aug_rows(f, pts, dx, u)
        center = _steps(f)(m, q0, u)
    mu, Phi, centered = _ukf._ut_moments(center, new_pts, weights)
    return mu, Phi, _ukf.ut_cross(centered, pts, m, weights[0])


def _ut_dynamics_cross_cov(f, m, P, Q, q0, u, uparams: ParamsUKF,
                           additive: bool) -> torch.Tensor:
    """``D = Cov(x_t, x_{t+1} | y_{1:t}) = Σ wᶜ (χ − m)(f(χ) − m⁺)ᵀ`` by the
    UKF predict's quadrature, over a leading step axis (plain PyTorch: the
    JAX package runs it in XLA, with no kernel)."""
    return _ut_dynamics_moments(f, m, P, Q, q0, u, uparams,
                                additive)[2].mT


def _unscented_rts(params: ParamsNLSSM, uparams: ParamsUKF,
                   emissions: torch.Tensor,
                   inputs: Optional[torch.Tensor] = None,
                   additive: bool = False):
    """:func:`unscented_rts_smoother` and its gains (..., T−1, dx, dx)."""
    post = unscented_kalman_filter(params, uparams, emissions, inputs,
                                   additive)
    fm, fP, pm, pP = post[1:]
    T, dx = fm.shape[-2:]
    if T < 2:
        return (PosteriorGaussianSmoothed(*post, *post[1:3]),
                fP[..., :0, :, :])
    lead = fm.shape[:-2]
    k = math.prod(lead)
    inputs = _process_input(inputs, T, emissions)
    Q, q0, _, _ = _noise_steps(params, torch.arange(T - 1, device=fm.device))
    rep = lambda a: a.expand((k,) + a.shape).reshape((k * (T - 1),)
                                                     + a.shape[1:])
    D = _ut_dynamics_cross_cov(
        params.dynamics_function, fm[..., :-1, :].reshape(-1, dx),
        fP[..., :-1, :, :].reshape(-1, dx, dx), rep(Q), rep(q0),
        rep(inputs[1:]), uparams, additive).reshape(lead + (T - 1, dx, dx))
    G = psd_solve(pP[..., :-1, :, :], D.mT).mT
    return _rts_smoothed(post, G), G


def unscented_rts_smoother(
    params: ParamsNLSSM,
    uparams: ParamsUKF,
    emissions: torch.Tensor,
    inputs: Optional[torch.Tensor] = None,
    additive: bool = False,
) -> PosteriorGaussianSmoothed:
    """Unscented Rauch–Tung–Striebel smoother (URTS) of ``emissions``
    (T, dy) or of a batch of sequences (B, T, dy); ``inputs`` (T, ...) is
    shared by the batch.

    The forward pass is :func:`unscented_kalman_filter` (K6 or K7, K8 and
    K9 on CUDA tensors). The backward gains ``G_t = D_t P_p⁻¹`` take the
    unscented cross-covariance ``D_t`` recomputed from sigma points at the
    filtered moments with the filter's ``u_{t+1}`` input (Särkkä 2008),
    all at once; then the affine recursion of the smoothed moments."""
    return _unscented_rts(params, uparams, emissions, inputs, additive)[0]


# ---------------------------------------------------------------------------
# Gaussian-sum filters (banks of EKFs / UKFs)
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


def unscented_gaussian_sum_filter(
    params: ParamsNLSSM,
    uparams: ParamsUKF,
    emissions: torch.Tensor,
    num_components: int = 1,
    num_iter: int = 1,
    inputs: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    init_eps: Optional[torch.Tensor] = None,
) -> PosteriorGaussianSumFiltered:
    """Gaussian-sum filter with UKF moments (non-additive quadrature) on
    ``emissions`` (T, dy). The initial means come from ``generator`` or
    from the standard normals ``init_eps`` (M, dx). Each step is, on CUDA
    tensors, K7+K8 (update) and K7+K9 (predict) over the bank."""
    T = emissions.shape[0]
    f, h = params.dynamics_function, params.emission_function
    inputs = _process_input(inputs, T, emissions)
    condition = _ukf_condition(num_iter, params.emission_residual)

    weights, pred_means, pred_covs = _init_mixture(params, num_components,
                                                   generator, init_eps)
    ll = emissions.new_zeros(())
    out = {k: [] for k in ("weights", "means", "covariances",
                           "predicted_means", "predicted_covariances")}
    for t in range(T):
        Q, q0, R, r0 = _slice_noise(params, t)
        lls, f_means, f_covs = condition(pred_means, pred_covs, h, R,
                                         inputs[t], emissions[t], uparams, r0)
        weights, step_ll = _reweight(lls, weights)
        pred_means, pred_covs = _fut.fused_ukf_predict_nonadditive(
            f_means, f_covs, f, _predict_input(inputs, t, T), Q, uparams, q0)
        ll = ll + step_ll
        for k, v in (("weights", weights), ("means", f_means),
                     ("covariances", f_covs), ("predicted_means", pred_means),
                     ("predicted_covariances", pred_covs)):
            out[k].append(v)
    return PosteriorGaussianSumFiltered(
        marginal_loglik=ll,
        **{k: torch.stack(v, dim=1) for k, v in out.items()})


# ---------------------------------------------------------------------------
# Augmented Gaussian-sum filters (AGSF family)
# ---------------------------------------------------------------------------


class AGSFDraws(NamedTuple):
    """The randomness of one AGSF run: ``init`` (M, dx) standard normals of
    the initial means; ``split1`` (T, M, N, dx) and ``split2``
    (T, M·N, L, dx) standard normals of the two splits; ``reduce`` the
    reduction's uniforms per step, ``(T,) + UNIFORM_SHAPES[reduction](M,
    M·N·L)`` — (T,) for "systematic", (T, M) for "multinomial" and
    "stratified", (T, M·N·L) for "optimal", None for "topk". With
    ``compat_fixed_keys`` every step reuses one step's draws: T is 1."""

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
        reduce = torch.rand((T,) + _rs.UNIFORM_SHAPES[reduction](M, M * N * L),
                            generator=generator, dtype=like.dtype,
                            device=like.device)
    return AGSFDraws(normal(M, state_dim), normal(T, M, N, state_dim),
                     normal(T, M * N, L, state_dim), reduce)


def _fixed_key_draws(generator: torch.Generator, num_components,
                     state_dim: int, reduction: str,
                     like: torch.Tensor) -> AGSFDraws:
    """The draws of ``compat_fixed_keys``: the initial normals from a
    generator seeded 0 (the reference's ``PRNGKey(0)``), and one step's
    split normals and reduction uniforms from ``generator``, which every
    step reuses (the reference reuses its key at every step)."""
    step = agsf_draws(generator, 1, num_components, state_dim, reduction,
                      like)
    seed0 = torch.Generator(device=like.device).manual_seed(0)
    init = standard_normal((int(num_components[0]), state_dim), like, seed0)
    return step._replace(init=init)


def _select_split_cov(strategy: str, alpha, means, covs, jacobian, hessian,
                      num_splits: int, bias, u):
    """Splitting covariances ("autocov"), batched over components:

    * "prop": Δ = α·P (the reference's active branch);
    * "eye": Δ = α·I;
    * "sdp": the fixed-point solver :func:`~bayesianfiltering_tpu_torch.utils.sdp.sdp_opt`
      on the Jacobian and Hessian at each mean;
    * "trace": Δ = clamp(α·tr(P) / Σ_i |tr(H_i P)|, 0, 1)·P, the
      Hessian-trace-scaled proportional rule with magnitudes (signed traces
      can make Δ indefinite for sign-indefinite Hessians).

    The Jacobians and Hessians are evaluated over the components with
    ``torch.func.vmap`` (plain PyTorch, as the JAX package's XLA)."""
    if strategy == "prop":
        return alpha * covs
    if strategy == "eye":
        dx = covs.shape[-1]
        eye = torch.eye(dx, dtype=covs.dtype, device=covs.device)
        return (alpha * eye).expand(covs.shape)
    if strategy in ("sdp", "trace"):
        M, n = covs.shape[:2]
        H = _ekf.batched(hessian)(means, bias, u).reshape(M, -1, n, n)
        if strategy == "sdp":
            J = _ekf.batched(jacobian)(means, bias, u).reshape(M, -1, n)
            return sdp_opt(n, num_splits, covs, J, H, alpha)
        traces = torch.diagonal(H @ covs[:, None], dim1=-2, dim2=-1).sum(-1)
        denom = traces.abs().sum(-1)
        tr_p = torch.diagonal(covs, dim1=-2, dim2=-1).sum(-1)
        scale = (alpha * tr_p / (denom + 1e-30)).clamp(0.0, 1.0)
        return scale[:, None, None] * covs
    raise ValueError(f"unknown autocov strategy {strategy!r}")


def _agsf_engine(params: ParamsNLSSM, emissions, num_components, draws,
                 opt_args, inputs, reduction, autocov, num_iter, jitter,
                 moments="ekf", uparams: Optional[ParamsUKF] = None,
                 fixed_keys: bool = False):
    """AGSF loop: split → predict → split → update → reweight → reduce.
    Per step on CUDA tensors: with EKF moments one K4 (predict of M·N) and
    one K3 (update of M·N·L) launch per iteration; with UKF moments K7+K9
    and K7+K8. ``fixed_keys`` reuses the draws of step 0 at every step."""
    M, N, L = (int(c) for c in num_components)
    T = emissions.shape[0]
    use_ekf = moments == "ekf"
    f, h, F_x, H_x, F_q, H_r = _jacobians(params)
    # the Hessians (out, in, in) of the adaptive splitting rules, as the
    # JAX package's jacrev of the Jacobians
    F_xx, H_xx = torch.func.jacrev(F_x), torch.func.jacrev(H_x)
    if not use_ekf:
        ukf_condition = _ukf_condition(num_iter, params.emission_residual)
    inputs = _process_input(inputs, T, emissions)
    residual_fn = params.emission_residual
    alpha0, alpha1 = opt_args

    weights, means, covs = _init_mixture(params, M, eps=draws.init)
    outputs = {"weights": [], "means": [], "covariances": []}
    names = ("Deltas", "Lambdas", "updated_means", "pre_weights",
             "step_loglik")
    if use_ekf:
        names += ("grads_dyn", "grads_obs", "gain")
    aux = {k: [] for k in names}
    for t in range(T):
        Q, q0, R, r0 = _slice_noise(params, t)
        u, y = inputs[t], emissions[t]
        s = 0 if fixed_keys else t

        # autocov 1 + branch 1: M -> M·N, then predict
        deltas = _select_split_cov(autocov, alpha0, means, covs, F_x, F_xx,
                                   N, q0, u)
        to_predict = split_gaussian_sum(GaussianSum(means, covs, weights),
                                        deltas, N, eps=draws.split1[s])
        if use_ekf:
            pred_means, pred_covs, grads_dyn = _bank.bank_ekf_predict(
                to_predict.means, to_predict.covariances, f, F_x, F_q, Q, q0,
                u)
        else:
            pred_means, pred_covs = _fut.fused_ukf_predict_nonadditive(
                to_predict.means, to_predict.covariances, f, u, Q, uparams,
                q0)

        # autocov 2 + branch 2: M·N -> M·N·L, then update
        lambdas = _select_split_cov(autocov, alpha1, pred_means, pred_covs,
                                    H_x, H_xx, L, r0, u)
        to_update = split_gaussian_sum(
            GaussianSum(pred_means, pred_covs, to_predict.weights), lambdas, L,
            eps=draws.split2[s])
        if use_ekf:
            upd = _bank.bank_ekf_condition_on_iterated(
                to_update.means, to_update.covariances, h, H_x, H_r, R, r0, u,
                y, num_iter, jitter, residual_fn)
            lls, upd_means, upd_covs = upd.log_likelihood, upd.mean, upd.cov
        else:
            lls, upd_means, upd_covs = ukf_condition(
                to_update.means, to_update.covariances, h, R, u, y, uparams,
                r0)
        new_weights, step_ll = _reweight(lls, to_update.weights)

        # reduce M·N·L -> M
        reduced = containers.reduce_gaussian_sum(
            GaussianSum(upd_means, upd_covs, new_weights), M, reduction,
            u=None if draws.reduce is None else draws.reduce[s])
        means, covs, weights = reduced

        outputs["weights"].append(weights)
        outputs["means"].append(means)
        outputs["covariances"].append(covs)
        step = {"Deltas": deltas, "Lambdas": lambdas,
                "updated_means": upd_means, "pre_weights": new_weights,
                "step_loglik": step_ll}
        if use_ekf:
            step.update(grads_dyn=grads_dyn, grads_obs=upd.jacobian,
                        gain=upd.gain)
        for k, v in step.items():
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

    Per step: select the splitting covariances Δ (``autocov`` ∈ {"prop",
    "eye", "sdp", "trace"}), branch each of the M components into N,
    EKF-predict, select Λ, branch into L, EKF-update, reweight, and reduce
    back to M components (``reduction`` ∈ {"multinomial", "systematic",
    "stratified", "topk", "optimal"}). The randomness comes from
    ``generator`` or from ``draws`` (:class:`AGSFDraws`).

    ``compat_fixed_keys`` reproduces the reference's key pattern in torch
    form: the initial normals from a generator seeded 0, and one step's
    split normals and reduction uniforms reused at every step (drawn once
    from ``generator``, or ``draws`` with T = 1).

    Returns ``(posterior, aux)``; ``aux`` holds the per-step Deltas,
    Lambdas, updated means, pre-reduction weights, Jacobians and gains,
    stacked along a leading time axis.
    """
    return _agsf(params, emissions, num_components, generator, num_iter,
                 opt_args, inputs, autocov, reduction, compat_fixed_keys,
                 jitter, draws, "ekf", None)


def _agsf(params, emissions, num_components, generator, num_iter, opt_args,
          inputs, autocov, reduction, compat_fixed_keys, jitter, draws,
          moments, uparams):
    if draws is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the draws")
        dx = params.initial_mean.shape[-1]
        if compat_fixed_keys:
            draws = _fixed_key_draws(generator, num_components, dx,
                                     reduction, emissions)
        else:
            draws = agsf_draws(generator, emissions.shape[0], num_components,
                               dx, reduction, emissions)
    elif compat_fixed_keys and draws.split1.shape[0] != 1:
        raise ValueError("compat_fixed_keys reuses one step's draws: pass "
                         "draws with T = 1")
    return _agsf_engine(params, emissions, num_components, draws, opt_args,
                        inputs, reduction, autocov, num_iter, jitter, moments,
                        uparams, compat_fixed_keys)


# The reference's vectorized rewrite is this package's only implementation.
speedy_augmented_gaussian_sum_filter = augmented_gaussian_sum_filter


def unscented_agsf(
    params: ParamsNLSSM,
    uparams: ParamsUKF,
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
    """AGSF with unscented moments (non-additive quadrature): the loop of
    :func:`augmented_gaussian_sum_filter` with the UKF predict (K7+K9) and
    update (K7+K8, or the plain IPLF for ``num_iter > 1``) over the bank.
    ``aux`` holds Deltas, Lambdas, updated means and pre-reduction weights;
    there are no Jacobians or gains."""
    return _agsf(params, emissions, num_components, generator, num_iter,
                 opt_args, inputs, autocov, reduction, compat_fixed_keys,
                 jitter, draws, "ukf", uparams)


speedy_unscented_agsf = unscented_agsf


def augmented_gaussian_sum_filter_optimal(
    params: ParamsNLSSM,
    emissions: torch.Tensor,
    num_components: Sequence[int],
    generator: Optional[torch.Generator] = None,
    num_iter: int = 1,
    opt_args: Tuple[float, float] = (0.1, 0.1),
    inputs: Optional[torch.Tensor] = None,
    autocov: str = "prop",
    compat_fixed_keys: bool = False,
    jitter: float = 0.0,
    draws: Optional[AGSFDraws] = None,
):
    """:func:`augmented_gaussian_sum_filter` with the Fearnhead–Clifford
    optimal reduction: heavy components survive deterministically, light
    ones are resampled, and the weights are not uniform."""
    return _agsf(params, emissions, num_components, generator, num_iter,
                 opt_args, inputs, autocov, "optimal", compat_fixed_keys,
                 jitter, draws, "ekf", None)


# ---------------------------------------------------------------------------
# Bootstrap particle filter
# ---------------------------------------------------------------------------


class BPFDraws(NamedTuple):
    """The randomness of one bootstrap-PF run: ``init`` (P, dx) standard
    normals of the initial particles; ``dynamics`` (T, P, dq) standard
    normals of the dynamics noise; ``resample`` the resampler's uniforms per
    step, ``(T,) + UNIFORM_SHAPES[resampler](P)`` — (T,) for "systematic",
    (T, P) for "multinomial" and "stratified". Each step's uniforms are
    there whether or not the step resamples, as the JAX key schedule splits
    a resampling key every step."""

    init: torch.Tensor
    dynamics: torch.Tensor
    resample: torch.Tensor


def bpf_draws(generator: torch.Generator, num_timesteps: int,
              num_particles: int, state_dim: int, noise_dim: int,
              resampler: str, like: torch.Tensor) -> BPFDraws:
    """Fresh :class:`BPFDraws` from ``generator``, in ``like``'s dtype and
    device."""
    T, P = int(num_timesteps), int(num_particles)
    normal = lambda *shape: standard_normal(shape, like, generator)
    resample = torch.rand((T,) + _rs.UNIFORM_SHAPES[resampler](P),
                          generator=generator, dtype=like.dtype,
                          device=like.device)
    return BPFDraws(normal(P, state_dim), normal(T, P, noise_dim), resample)


def bootstrap_particle_filter(
    params: ParamsBPF,
    emissions: torch.Tensor,
    num_particles: int,
    generator: Optional[torch.Generator] = None,
    inputs: Optional[torch.Tensor] = None,
    ess_threshold: float = 0.5,
    resampler: str = "systematic",
    store: str = "all",
    draws: Optional[BPFDraws] = None,
) -> Dict[str, torch.Tensor]:
    """Bootstrap PF with ESS-adaptive resampling on ``emissions`` (T, dy).

    Per step: propagate every particle through the dynamics with one
    batched noise draw, add the emission log-likelihoods to the log
    weights, normalise them with ``logsumexp``, and resample (``resampler``
    ∈ {"multinomial", "systematic", "stratified"}) when the effective sample
    size falls below ``ess_threshold``·P. A step that does not resample
    passes the log weights through unchanged (a round trip through exp and
    log would turn an underflowed weight into a permanent −inf). The
    decision is made on the host, one synchronisation per step, as the JAX
    package's ``lax.cond``. On CUDA tensors the systematic and stratified
    resamplers run K5 for the counts→parents inversion, exact at every
    weight profile (the JAX package's TPU deferral is not ported).

    The randomness comes from ``generator`` (drawn step by step) or from
    ``draws`` (:class:`BPFDraws`, e.g. the JAX key schedule's normals and
    uniforms). ``store="all"`` returns ``{"weights": (P, T), "particles":
    (P, T, dx)}``, particle-major as the JAX function returns them; any
    other value returns ``{"means": (T, dx), "ess": (T,)}``, which is what
    fits at a million particles.
    """
    if draws is None and generator is None:
        raise ValueError("pass a torch.Generator or the draws")
    T = emissions.shape[0]
    P = int(num_particles)
    f = params.dynamics_function
    log_prob = params.emission_distribution_log_prob
    inputs = _process_input(inputs, T, emissions)
    resample_fn = _rs.get_resampler(resampler)
    uniform = -math.log(P)

    particles = mvn_sample(params.initial_mean, params.initial_covariance,
                           (P,), generator,
                           None if draws is None else draws.init)
    log_w = emissions.new_full((P,), uniform)
    out = {k: [] for k in (("weights", "particles") if store == "all"
                           else ("means", "ess"))}
    for t in range(T):
        Q, q0, _, _ = _slice_noise(params, t)
        u, y = inputs[t], emissions[t]
        q = mvn_sample(q0, Q, (P,), generator,
                       None if draws is None else draws.dynamics[t])
        particles = f(particles, q, u)

        log_w = log_w + log_prob(particles, y, u)
        log_w = log_w - torch.logsumexp(log_w, 0)
        weights = torch.exp(log_w)
        ess = _rs.effective_sample_size(weights)
        if bool(ess < ess_threshold * P):
            idx = resample_fn(weights, P, generator,
                              None if draws is None else draws.resample[t])
            particles = particles[idx]
            log_w = torch.full_like(log_w, uniform)
            weights = torch.exp(log_w)

        if store == "all":
            out["weights"].append(weights)
            out["particles"].append(particles)
        else:
            out["means"].append(weights @ particles)
            out["ess"].append(ess)
    return {k: torch.stack(v, dim=1 if store == "all" else 0)
            for k, v in out.items()}


# The parallel iterated smoothers live in ops/parallel_iterated.py (they
# import this module's helpers at call time); re-exported here so that the
# smoother family is one namespace, as in the JAX package.
from bayesianfiltering_tpu_torch.ops.parallel_iterated import (  # noqa: E402
    parallel_iterated_extended_smoother,
    parallel_iterated_sigma_point_smoother,
)

__all__ = [
    "PosteriorGaussianFiltered",
    "PosteriorGaussianSmoothed",
    "PosteriorGaussianSumFiltered",
    "AGSFDraws",
    "agsf_draws",
    "BPFDraws",
    "bpf_draws",
    "bootstrap_particle_filter",
    "ParamsUKF",
    "extended_kalman_filter",
    "extended_rts_smoother",
    "unscented_rts_smoother",
    "parallel_iterated_extended_smoother",
    "parallel_iterated_sigma_point_smoother",
    "unscented_kalman_filter",
    "gaussian_sum_filter",
    "unscented_gaussian_sum_filter",
    "augmented_gaussian_sum_filter",
    "speedy_augmented_gaussian_sum_filter",
    "unscented_agsf",
    "speedy_unscented_agsf",
    "augmented_gaussian_sum_filter_optimal",
    "swap_axes_on_values",
]
