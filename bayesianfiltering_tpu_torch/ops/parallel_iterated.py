"""Parallel iterated extended and sigma-point Kalman smoothers (IEKS, IPLS)
(counterpart of ``bayesianfiltering_tpu/ops/parallel_iterated.py``).

Each iteration linearises the nonlinear SSM about the current nominal
trajectory into a per-step affine LGSSM

    x_t = F_t x_{t-1} + c_t + q_t,   y_t = H_t x_t + d_t + r_t

and runs the temporally parallel time-varying filter and smoother
(:func:`~bayesianfiltering_tpu_torch.ops.associative.parallel_kalman_smoother_tv`):
on CUDA tensors every pass is K10 (or K10b) for the filtering combines, one
K11 (K11b) launch for the smoothing elements with the per-step transitions
as a bank, and K12 (K12b) for the smoothing combines. The fixed point of
the extended (Jacobian) version is the Gauss–Newton MAP trajectory (IEKS);
the sigma-point version relinearises by unscented statistical linear
regression about the current posterior marginals (IPLS). Technique:
Yaghoobi, Corenflos, Hassan, Särkkä, "Parallel Iterated Extended and
Sigma-Point Kalman Smoothers" (arXiv 2102.00514).

The linearisations are batched over time: ``torch.func.vmap`` of the model
and its ``jacfwd`` Jacobians, or of the sigma-point quadrature, which stays
plain PyTorch (the JAX package runs it in XLA, with no kernel). The
iterations and the default rollout nominal are Python loops; the
Levenberg–Marquardt accept and reject stay on the device
(``torch.where``), with no host synchronisation an iteration.

Conventions (those of the sequential filters): the transition into step t
is linearised at ``nominal[t-1]`` with input ``u_t`` and noise slice t−1;
the emission at t at ``nominal[t]`` with input ``u_t`` and noise slice t.
Non-additive noise enters through ``F_q Q F_qᵀ`` / ``H_r R H_rᵀ``
(extended) or through the augmented quadrature (sigma-point).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from bayesianfiltering_tpu_torch.ops import ukf as _ukf
from bayesianfiltering_tpu_torch.ops.associative import (
    _mv,
    parallel_kalman_smoother_tv,
)
from bayesianfiltering_tpu_torch.utils.linalg import (
    project_to_psd_fast,
    psd_solve,
    symmetrize,
)
from bayesianfiltering_tpu_torch.utils.sigma_points import (
    factor,
    points_blockdiag,
    points_from_factor,
)


class IteratedSmootherAux(NamedTuple):
    """Per-iteration diagnostics: the max-norm of the nominal trajectory's
    change, which should decrease toward the fixed point."""

    step_norms: torch.Tensor  # (num_iter,)


def _step_index(T: int, like: torch.Tensor):
    """(t, max(t − 1, 0)) for t = 0 … T−1, on ``like``'s device."""
    ts = torch.arange(T, device=like.device)
    return ts, (ts - 1).clamp_min(0)


# ---------------------------------------------------------------------------
# linearisations: nominal trajectory -> per-step affine LGSSM stacks
# ---------------------------------------------------------------------------


def _extended_linearize(params, nom_m, inputs_arr, jacobians):
    """First-order linearisation along a nominal mean trajectory (T, dx):
    the stacks ``(Fs, cs, Qs, Hs, ds, Rs)`` of
    :func:`~bayesianfiltering_tpu_torch.ops.associative.parallel_kalman_filter_tv`
    (``Fs[0]`` unused)."""
    from bayesianfiltering_tpu_torch.inference import _noise_steps, _steps

    f, h, F_x, H_x, F_q, H_r = jacobians
    T, dx = nom_m.shape
    ts, tp = _step_index(T, nom_m)
    # the transition into t, at nominal[t-1] with u_t
    x = nom_m[tp]
    Q, q0, _, _ = _noise_steps(params, tp)
    F = _steps(F_x)(x, q0, inputs_arr).reshape(T, dx, dx)
    Fq = _steps(F_q)(x, q0, inputs_arr).reshape(T, dx, -1)
    c = _steps(f)(x, q0, inputs_arr) - _mv(F, x)
    # the emission at t, at nominal[t]
    _, _, R, r0 = _noise_steps(params, ts)
    H = _steps(H_x)(nom_m, r0, inputs_arr).reshape(T, -1, dx)
    Hr = _steps(H_r)(nom_m, r0, inputs_arr).reshape(T, H.shape[1], -1)
    d = _steps(h)(nom_m, r0, inputs_arr).reshape(T, -1) - _mv(H, nom_m)
    return (F, c, symmetrize(Fq @ Q @ Fq.mT), H, d,
            symmetrize(Hr @ R @ Hr.mT))


def _slr_dynamics(f, m, P, Q, q0, u, uparams, additive):
    """Unscented statistical linear regression of the dynamics at N(m, P)
    over a leading step axis: ``F = Dᵀ P⁻¹``, ``c = μ⁺ − F m``,
    ``Ω = Φ⁺ − F P Fᵀ`` (Φ⁺ carries the process noise). The predicted
    moments and D come from the same points."""
    from bayesianfiltering_tpu_torch.inference import _ut_dynamics_moments

    mu, Phi, C = _ut_dynamics_moments(f, m, P, Q, q0, u, uparams, additive)
    if additive:
        Phi = Phi + Q
    F = psd_solve(P, C.mT).mT
    c = mu - _mv(F, m)
    # Ω is PSD in exact arithmetic but goes indefinite in float32 where the
    # quadrature's coordinates are large (BOT at T = 500); the projection
    # clamps the rounding's negative eigenvalues
    Om = project_to_psd_fast(symmetrize(Phi) - F @ P @ F.mT)
    return F, c, Om


def _slr_emission(h, m, P, R, r0, u, uparams, additive):
    """Unscented SLR of the emission at N(m, P) over a leading step axis:
    ``H = C P⁻¹``, ``d = μ_y − H m``, ``Ω = S − H P Hᵀ`` (S carries the
    emission noise)."""
    from bayesianfiltering_tpu_torch.inference import _steps

    n, dx = m.shape
    if additive:
        scale, weights = _ukf.ut_weights(dx, uparams)
        pts = points_from_factor(m, factor(P, uparams.sqrt_method), scale)
        rz = torch.zeros_like(r0)
        new_pts = _ukf.eval_step_rows(h, pts, rz, u)
        center = _steps(h)(m, rz, u).reshape(n, -1)
        mu_y, S, centered = _ukf._ut_moments(center, new_pts, weights)
        S = symmetrize(S + R)
    else:
        scale, weights = _ukf.ut_weights(dx + r0.shape[-1], uparams)
        pts = points_blockdiag(m, P, r0, R, scale, uparams.sqrt_method)
        new_pts = _ukf.eval_step_aug_rows(h, pts, dx, u)
        center = _steps(h)(m, r0, u).reshape(n, -1)
        mu_y, S, centered = _ukf._ut_moments(center, new_pts, weights)
        S = symmetrize(S)
    C = _ukf.ut_cross(centered, pts, m, weights[0])
    H = psd_solve(P, C.mT).mT
    d = mu_y - _mv(H, m)
    Om = project_to_psd_fast(S - H @ P @ H.mT)
    return H, d, Om


def _sigma_point_linearize(params, uparams, nom_m, nom_P, inputs_arr,
                           additive):
    """SLR linearisation about the nominal marginals N(nom_m, nom_P): the
    stacks of :func:`_extended_linearize`."""
    from bayesianfiltering_tpu_torch.inference import _noise_steps

    ts, tp = _step_index(len(nom_m), nom_m)
    Q, q0, _, _ = _noise_steps(params, tp)
    Fs, cs, Qs = _slr_dynamics(params.dynamics_function, nom_m[tp],
                               nom_P[tp], Q, q0, inputs_arr, uparams,
                               additive)
    _, _, R, r0 = _noise_steps(params, ts)
    Hs, ds, Rs = _slr_emission(params.emission_function, nom_m, nom_P, R,
                               r0, inputs_arr, uparams, additive)
    return Fs, cs, Qs, Hs, ds, Rs


# ---------------------------------------------------------------------------
# iteration drivers
# ---------------------------------------------------------------------------


def _rollout(params, T, inputs_arr):
    """The noise-free rollout ``x_t = f(x_{t-1}, q0_{t-1}, u_t)`` from the
    initial mean: the default nominal trajectory. A loop of T − 1 model
    calls on the state's device."""
    from bayesianfiltering_tpu_torch.inference import _slice_noise

    f = params.dynamics_function
    x = params.initial_mean
    xs = [x]
    for t in range(1, T):
        x = f(x, _slice_noise(params, t - 1)[1], inputs_arr[t])
        xs.append(x)
    return torch.stack(xs)


def _effective_emissions(params, emissions, nom_m, inputs_arr):
    """Wrap-aware emissions for the linearised model: with an
    ``emission_residual`` (e.g. wrapped bearings) the affine filter sees
    ``y_eff = ŷ(x̄) + (y ⊖ ŷ(x̄))``, so that its linear innovation is the
    wrapped one at the linearisation point; without one, ``y``."""
    from bayesianfiltering_tpu_torch.inference import _noise_steps, _steps

    residual_fn = params.emission_residual
    if residual_fn is None:
        return emissions
    T = len(emissions)
    _, _, _, r0 = _noise_steps(params, _step_index(T, nom_m)[0])
    yh = _steps(params.emission_function)(nom_m, r0,
                                          inputs_arr).reshape(T, -1)
    return yh + residual_fn(emissions.reshape(T, -1), yh)


def _recentered_smoother_tv(m0, P0, stacks, ys, nom, solver, chunk):
    """The time-varying smoother in deviation space ``δx = x − nominal``:
    ``c′_t = c_t + F_t x̄_{t−1} − x̄_t``, ``d′_t = d_t + H_t x̄_t``,
    ``m0′ = m0 − x̄_0``, an exact affine reparameterisation (the marginal
    log-likelihood is unchanged). Every b and η of the scan is then of the
    size of the posterior spread, not of the state's coordinates (~1e3 on
    BOT at T = 500 beside covariances ~1e-5, which float32 would lose)."""
    Fs, cs, Qs, Hs, ds, Rs = stacks
    cs2 = torch.cat([cs[:1], cs[1:] + _mv(Fs[1:], nom[:-1]) - nom[1:]])
    ds2 = ds + _mv(Hs, nom)
    post = parallel_kalman_smoother_tv(m0 - nom[0], P0, Fs, cs2, Qs, Hs,
                                       ds2, Rs, ys, solver=solver,
                                       chunk=chunk)
    nom_next = torch.cat([nom[1:], nom[-1:]])
    return post._replace(
        filtered_means=post.filtered_means + nom,
        predicted_means=post.predicted_means + nom_next,
        smoothed_means=post.smoothed_means + nom,
    )


def _lm_augment(stacks, ys, nom_m, lam):
    """Levenberg–Marquardt regularisation as per-step pseudo-observations
    ``x_t = nominal_t`` of precision λ: H ← [H; I], y ← [y; x̄],
    R ← blkdiag(R, I/λ)."""
    Fs, cs, Qs, Hs, ds, Rs = stacks
    T, dy, dx = Hs.shape
    eye = torch.eye(dx, dtype=Hs.dtype, device=Hs.device).expand(T, dx, dx)
    Hs2 = torch.cat([Hs, eye], dim=1)
    ds2 = torch.cat([ds, ds.new_zeros(T, dx)], dim=1)
    Rs2 = Rs.new_zeros(T, dy + dx, dy + dx)
    Rs2[:, :dy, :dy] = Rs
    Rs2[:, dy:, dy:] = eye / lam
    ys2 = torch.cat([ys, nom_m], dim=1)
    return (Fs, cs, Qs, Hs2, ds2, Rs2), ys2


def _make_map_cost(params, emissions, inputs_arr):
    """The MAP objective −log p(x_{0:T-1}, y_{0:T-1}) up to constants, with
    the true nonlinear (wrap-aware) residuals and the caller's effective
    emission covariances ``Rs`` (T, dy, dy): the quantity the LM accept and
    reject compare. Returns ``cost(traj, Qs, Rs)``, a 0-dim tensor on the
    trajectory's device."""
    from bayesianfiltering_tpu_torch.inference import (
        _jacobians,
        _noise_steps,
        _steps,
    )
    from bayesianfiltering_tpu_torch.ops.ekf import _residual

    f, h = params.dynamics_function, params.emission_function
    residual_fn = params.emission_residual
    F_q = _jacobians(params)[4]
    m0, P0 = params.initial_mean, params.initial_covariance
    T = len(emissions)
    ys = emissions.reshape(T, -1)
    ts = _step_index(T, m0)[0]
    _, _, _, r0 = _noise_steps(params, ts)
    # the transition into t ≥ 1: noise slice t − 1, input u_t
    Qd, q0d, _, _ = _noise_steps(params, ts[:-1])
    u_next = inputs_arr[1:]

    def _reg(M):
        # a Tikhonov floor for a possibly ill-conditioned effective noise
        n = M.shape[-1]
        tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
        eps = 1e-9 + 1e-6 * tr / n
        return M + eps[..., None, None] * torch.eye(n, dtype=M.dtype,
                                                    device=M.device)

    def cost(traj, Qs, Rs):
        del Qs  # the dynamics are weighted in noise space (below)
        yh = _steps(h)(traj, r0, inputs_arr).reshape(T, -1)
        e = _residual(ys, yh, residual_fn)
        total = (e * psd_solve(_reg(Rs), e)).sum()
        if T > 1:
            # Non-additive noise makes F_q Q F_qᵀ rank-deficient where
            # dq < dx (the BOT family): project the residual into noise
            # space by least squares through F_q and weight it with the
            # base Q (exact for additive noise, F_q = I)
            dx = traj.shape[-1]
            x_prev = traj[:-1]
            Fq = _steps(F_q)(x_prev, q0d, u_next).reshape(T - 1, dx, -1)
            r = traj[1:] - _steps(f)(x_prev, q0d, u_next)
            G = Fq.mT @ Fq + 1e-9 * torch.eye(Fq.shape[-1], dtype=Fq.dtype,
                                              device=Fq.device)
            rq = psd_solve(G, _mv(Fq.mT, r))
            total = total + (rq * psd_solve(_reg(Qd), rq)).sum()
        d0 = traj[0] - m0
        return 0.5 * (total + d0 @ psd_solve(_reg(P0), d0))

    return cost


def _initial_nominal(params, emissions, inputs, inputs_arr, nominal, T):
    """The nominal seed → ``(means, covariances or None)``: ``None`` or
    "rollout", the noise-free dynamics rollout (the paper's seed, for
    stable dynamics); "filter", one EKF pass (K1 and K2 on CUDA tensors),
    whose filtered covariances also seed the IPLS's first SLR (the robust
    choice for unstable dynamics such as the BOT family's 1.05 drift); an
    array of (T, dx) means."""
    if nominal is None or (isinstance(nominal, str) and nominal == "rollout"):
        return _rollout(params, T, inputs_arr), None
    if isinstance(nominal, str):
        if nominal != "filter":
            raise ValueError(f"unknown nominal seed {nominal!r}; expected "
                             "'rollout', 'filter', or a (T, dx) array")
        from bayesianfiltering_tpu_torch.inference import (
            extended_kalman_filter,
        )

        post = extended_kalman_filter(params, emissions, inputs=inputs)
        return post.filtered_means, post.filtered_covariances
    return torch.as_tensor(nominal, dtype=emissions.dtype,
                           device=emissions.device), None


def _iterate(linearize, run, nom_m, nom_P, num_iter, damping=1.0):
    """``num_iter`` fixed-point iterations, then one more smoother pass at
    the last linearisation, whose posterior is returned. ``damping``
    γ ∈ (0, 1] relaxes the means' update to ``nom + γ(smoothed − nom)``;
    the covariances, which only feed the IPLS's sigma-point spread, are
    not damped."""
    deltas = []
    for _ in range(int(num_iter)):
        post = run(linearize(nom_m, nom_P))
        sm = nom_m + damping * (post.smoothed_means - nom_m)
        deltas.append((sm - nom_m).abs().max())
        nom_m, nom_P = sm, post.smoothed_covariances
    post = run(linearize(nom_m, nom_P))
    return post, IteratedSmootherAux(
        torch.stack(deltas) if deltas else nom_m.new_zeros(0))


def _iterate_lm(linearize, run, cost_fn, nom_m, nom_P, num_iter, lam0):
    """Levenberg–Marquardt trust-region iterations: each candidate solves
    the λ-regularised Gauss–Newton subproblem (one smoother pass); it is
    accepted only if it lowers the MAP cost evaluated with the current
    linearisation's noise, and λ is quartered on accept and quadrupled on
    reject (clipped to [1e-8, 1e16]). Accept and reject are
    ``torch.where`` on the device. Then one more smoother pass at the last
    linearisation, as :func:`_iterate`."""
    m, P = nom_m, nom_P
    lam = torch.as_tensor(lam0, dtype=m.dtype, device=m.device)
    deltas = []
    for _ in range(int(num_iter)):
        stacks, ys, _ = linearize(m, P)
        Qs, Rs = stacks[2], stacks[5]
        cost_here = cost_fn(m, Qs, Rs)
        aug = _lm_augment(stacks, ys, m, lam)
        post = run(aug + (m,))
        accept = cost_fn(post.smoothed_means, Qs, Rs) < cost_here
        new_m = torch.where(accept, post.smoothed_means, m)
        P = torch.where(accept, post.smoothed_covariances, P)
        lam = torch.where(accept, lam * 0.25, lam * 4.0).clamp(1e-8, 1e16)
        deltas.append((new_m - m).abs().max())
        m = new_m
    post = run(linearize(m, P))
    return post, IteratedSmootherAux(
        torch.stack(deltas) if deltas else m.new_zeros(0))


def _smooth(params, emissions, inputs, linearize_stacks, num_iter, nominal,
            solver, damping, lm_lambda, chunk, recenter):
    """The driver shared by the two smoothers: seed the nominal, iterate
    (plain or LM), return ``(PosteriorGaussianSmoothed,
    IteratedSmootherAux)``. ``linearize_stacks(m, P, inputs_arr)`` gives
    the six stacks."""
    from bayesianfiltering_tpu_torch.inference import (
        PosteriorGaussianSmoothed,
        _process_input,
    )

    T = len(emissions)
    inputs_arr = _process_input(inputs, T, emissions)
    m0, P0 = params.initial_mean, params.initial_covariance
    nom_m, nom_P = _initial_nominal(params, emissions, inputs, inputs_arr,
                                    nominal, T)
    if nom_P is None:
        nom_P = P0.expand((T,) + P0.shape)

    def linearize(m, P):
        return (linearize_stacks(m, P, inputs_arr),
                _effective_emissions(params, emissions, m, inputs_arr), m)

    def run(arg):
        stacks, ys, nom = arg
        if recenter:
            return _recentered_smoother_tv(m0, P0, stacks, ys, nom, solver,
                                           chunk)
        return parallel_kalman_smoother_tv(m0, P0, *stacks, ys,
                                           solver=solver, chunk=chunk)

    if lm_lambda > 0.0:
        cost_fn = _make_map_cost(params, emissions, inputs_arr)
        post, aux = _iterate_lm(linearize, run, cost_fn, nom_m, nom_P,
                                num_iter, lm_lambda)
    else:
        post, aux = _iterate(linearize, run, nom_m, nom_P, num_iter,
                             damping)
    return PosteriorGaussianSmoothed(*post), aux


def parallel_iterated_extended_smoother(
    params,
    emissions: torch.Tensor,
    num_iter: int = 5,
    inputs: Optional[torch.Tensor] = None,
    nominal=None,
    solver: str = "woodbury",
    damping: float = 1.0,
    lm_lambda: float = 0.0,
    chunk="auto",
    recenter: bool = True,
):
    """Parallel IEKS: the iterated extended Kalman smoother with every pass
    a temporally parallel scan, on one sequence ``emissions`` (T, dy).

    Returns ``(PosteriorGaussianSmoothed, IteratedSmootherAux)``.
    ``num_iter`` fixed-point iterations run, then one more pass at the last
    linearisation (``num_iter=0``: a non-iterated extended smoother); the
    fixed point is the Gauss–Newton MAP trajectory. ``nominal`` seeds the
    linearisation: None or "rollout" (the noise-free dynamics rollout),
    "filter" (one EKF pass) or a (T, dx) array. ``damping`` < 1 relaxes the
    means' update; ``lm_lambda`` > 0 runs the Levenberg–Marquardt
    accept/reject variant instead. ``recenter`` runs each pass in
    deviation space. ``solver`` and ``chunk`` as in
    :func:`~bayesianfiltering_tpu_torch.ops.associative.parallel_kalman_smoother_tv`.
    """
    from bayesianfiltering_tpu_torch.inference import _jacobians

    jac = _jacobians(params)

    def stacks(m, P, inputs_arr):
        del P  # the first-order linearisation uses the means only
        return _extended_linearize(params, m, inputs_arr, jac)

    return _smooth(params, emissions, inputs, stacks, num_iter, nominal,
                   solver, damping, lm_lambda, chunk, recenter)


def parallel_iterated_sigma_point_smoother(
    params,
    uparams,
    emissions: torch.Tensor,
    num_iter: int = 5,
    inputs: Optional[torch.Tensor] = None,
    additive: bool = False,
    nominal=None,
    solver: str = "woodbury",
    damping: float = 0.8,
    lm_lambda: float = 0.0,
    chunk="auto",
    recenter: bool = True,
):
    """Parallel IPLS: the iterated posterior-linearisation smoother with
    unscented statistical linear regression (arXiv 2102.00514 §IV), on one
    sequence ``emissions`` (T, dy).

    Each relinearisation uses the current posterior marginals' means and
    covariances, so the affine model carries the SLR residual covariance.
    ``additive`` picks the additive-noise quadrature (Q must be dx × dx),
    else the augmented one. The other arguments as
    :func:`parallel_iterated_extended_smoother`. Returns
    ``(PosteriorGaussianSmoothed, IteratedSmootherAux)``.
    """
    def stacks(m, P, inputs_arr):
        return _sigma_point_linearize(params, uparams, m, P, inputs_arr,
                                      additive)

    return _smooth(params, emissions, inputs, stacks, num_iter, nominal,
                   solver, damping, lm_lambda, chunk, recenter)


__all__ = [
    "parallel_iterated_extended_smoother",
    "parallel_iterated_sigma_point_smoother",
    "IteratedSmootherAux",
]
