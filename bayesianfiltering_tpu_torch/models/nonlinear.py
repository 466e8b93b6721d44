"""Nonlinear state-space models with inference and fitting
(counterpart of ``bayesianfiltering_tpu/models/nonlinear.py``).

* :class:`NonlinearGaussianSSM` — additive-noise nonlinear model, with the
  EKF filter, the ERTS smoother, the marginal log-likelihood and extended
  or unscented EM.
* :class:`NonlinearSSM` — the general non-additive-noise model, with its
  own sampler that threads the noise through f and h.

Emissions may carry a leading batch of sequences (B, T, dy), which stands
for the JAX package's ``vmap``: one batched filter or smoother runs the
whole batch. Inputs are shared (T, ...) or per sequence (B, T, ...); per
sequence inputs that differ run one sequence at a time.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from bayesianfiltering_tpu_torch.distributions import (
    MVN,
    mvn_sample,
    standard_normal,
)
from bayesianfiltering_tpu_torch.models._fit import tree_map
from bayesianfiltering_tpu_torch.models.params import ParamsNLSSM
from bayesianfiltering_tpu_torch.models.ssm import SSM, SampleDraws


class SuffStatsNLSSM(NamedTuple):
    """Expected sufficient statistics of the extended (linearised) or
    unscented E-step, with a leading batch axis under ``fit_em``.

    ``sum_qq``/``sum_rr`` are second moments of the process/measurement
    noise about its bias, already mapped INTO noise space through the
    pseudo-inverses of the noise Jacobians F_q/H_r (identity for additive
    models), so the M-step for Q/R is a plain scaled sum.
    """

    Ex0: torch.Tensor         # smoothed E[x_0]
    Ex0x0: torch.Tensor       # smoothed E[x_0 x_0ᵀ]
    sum_qq: torch.Tensor      # Σ_{t=0}^{T-2} E[(q−q0)(q−q0)ᵀ]  (nq, nq)
    sum_rr: torch.Tensor      # Σ_{t=0}^{T-1} E[(r−r0)(r−r0)ᵀ]  (nr, nr)
    num_timesteps: torch.Tensor


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., :, None] * b[..., None, :]


def by_sequence(fn, emissions: torch.Tensor, inputs):
    """``fn(emissions, inputs)`` on a batch (B, T, dy). Inputs of shape
    (B, T, ...) are per sequence: equal ones run as shared inputs in one
    call, different ones one sequence a call, the outputs concatenated
    along the batch axis. Anything else (None, shared (T, ...) inputs, one
    sequence) is one call."""
    if (emissions.ndim != 3 or inputs is None
            or tuple(inputs.shape[:2]) != tuple(emissions.shape[:2])):
        return fn(emissions, inputs)
    if bool((inputs == inputs[:1]).all()):
        return fn(emissions, inputs[0])
    outs = [fn(e[None], u) for e, u in zip(emissions, inputs)]
    return tree_map(lambda *xs: torch.cat(xs), outs[0], *outs[1:])


class NonlinearGaussianSSM(SSM):
    """Additive-noise nonlinear Gaussian SSM,
    ``x_t = f(x_{t-1}[, u_t]) + q_t``, ``y_t = h(x_t[, u_t]) + r_t``.

    ``em_moments`` picks the E-step's quadrature: "ekf" (first-order,
    linearised at the ERTS-smoothed means) or "ukf" (the URTS smoother and
    sigma-point moments of the residuals under the smoothed pairwise
    joints, with ``em_uparams`` or ``ParamsUKF(alpha=1, "cholesky")``).
    """

    def __init__(self, state_dim: int, emission_dim: int, input_dim: int = 0,
                 em_moments: str = "ekf", em_uparams=None):
        self.state_dim = state_dim
        self.emission_dim = emission_dim
        self.input_dim = input_dim
        self.em_moments = em_moments
        self.em_uparams = em_uparams

    @property
    def emission_shape(self):
        return (self.emission_dim,)

    @property
    def inputs_shape(self):
        return (self.input_dim,) if self.input_dim > 0 else None

    def initial_distribution(self, params: ParamsNLSSM, inputs=None):
        return MVN(params.initial_mean, params.initial_covariance)

    def transition_distribution(self, params: ParamsNLSSM, state,
                                inputs=None):
        f = params.dynamics_function
        mean = f(state) if inputs is None else f(state, inputs)
        return MVN(mean, params.dynamics_noise_covariance)

    def emission_distribution(self, params: ParamsNLSSM, state, inputs=None):
        h = params.emission_function
        mean = h(state) if inputs is None else h(state, inputs)
        return MVN(mean, params.emission_noise_covariance)

    # -- inference ----------------------------------------------------------
    def _as_nonadditive(self, params: ParamsNLSSM) -> ParamsNLSSM:
        """Wrap additive-noise f(x[, u]) / h(x[, u]) into the non-additive
        (x, noise, u) calling convention of the filters. The sum is cast
        to the noise's dtype, so a model function that promotes under
        ``torch.func.jacfwd`` cannot change the filter's dtype."""
        f, h = params.dynamics_function, params.emission_function
        has_inputs = self.input_dim > 0

        def fna(x, q, u):
            return ((f(x, u) if has_inputs else f(x)) + q).to(q.dtype)

        def hna(x, r, u):
            return ((h(x, u) if has_inputs else h(x)) + r).to(r.dtype)

        return params._replace(dynamics_function=fna, emission_function=hna)

    def _filter_params(self, params: ParamsNLSSM) -> ParamsNLSSM:
        """Params in the non-additive (x, noise, u) convention the filter
        layer speaks (identity on :class:`NonlinearSSM`)."""
        return self._as_nonadditive(params)

    def filter(self, params: ParamsNLSSM, emissions, inputs=None):
        """The EKF posterior (K1 and K2 on CUDA tensors)."""
        from bayesianfiltering_tpu_torch import inference

        fp = self._filter_params(params)
        return by_sequence(
            lambda e, u: inference.extended_kalman_filter(fp, e, inputs=u),
            emissions, inputs)

    def smoother(self, params: ParamsNLSSM, emissions, inputs=None):
        """The ERTS posterior (K1 and K2 forward on CUDA tensors)."""
        from bayesianfiltering_tpu_torch import inference

        fp = self._filter_params(params)
        return by_sequence(
            lambda e, u: inference.extended_rts_smoother(fp, e, inputs=u),
            emissions, inputs)

    def marginal_log_prob(self, params: ParamsNLSSM, emissions, inputs=None):
        return self.filter(params, emissions, inputs).marginal_loglik

    # -- EM -------------------------------------------------------------------
    # Parameters INSIDE the dynamics/emission callables are not reachable by
    # EM (they live in closures) — fit those with ``fit_sgd``. On models
    # with multimodal smoothing posteriors (the UNGM's ±x symmetry) any
    # Gaussian E-step absorbs mode-assignment error into the noise moments,
    # so Q/R inflate: approximate EM's ascent needs an exact E-step.
    def e_step(self, params: ParamsNLSSM, emissions, inputs=None):
        """Expected statistics and marginal log-likelihood of one sequence
        (T, dy), or of a batch (B, T, dy) with a leading batch axis on
        both."""
        fp = self._filter_params(params)
        if emissions.ndim == 2:
            stats, ll = self._e_step(fp, emissions[None], inputs)
            return tree_map(lambda x: x[0], stats), ll[0]
        return by_sequence(lambda e, u: self._e_step(fp, e, u), emissions,
                           inputs)

    def _e_step(self, fp: ParamsNLSSM, emissions: torch.Tensor, inputs):
        """The E-step of a batch (B, T, dy) with shared inputs."""
        from bayesianfiltering_tpu_torch import inference
        from bayesianfiltering_tpu_torch.inference import (
            _jacobians,
            _over_steps,
            _process_input,
        )

        use_ut = self.em_moments == "ukf"
        if use_ut:
            from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF

            uparams = self.em_uparams or ParamsUKF(alpha=1.0,
                                                   sqrt_method="cholesky")
            post, G = inference._unscented_rts(fp, uparams, emissions,
                                               inputs)
        else:
            post, G = inference._extended_rts(fp, emissions, inputs=inputs)
        B, T = emissions.shape[:2]
        u = _process_input(inputs, T, emissions)
        f, h, F_x, H_x, F_q, H_r = _jacobians(fp)
        q0, r0 = fp.dynamics_noise_bias, fp.emission_noise_bias
        ms, Ps = post.smoothed_means, post.smoothed_covariances
        dx = ms.shape[-1]
        y = emissions.reshape(B, T, -1)

        def at(fn, x, noise, uu):
            steps = x.shape[-2]
            return _over_steps(fn, x, noise.expand((steps,) + noise.shape),
                               uu)

        # smoothed cross-covariance C_{t+1} = Cov(x_{t+1}, x_t) = P^s_{t+1}
        # G_tᵀ, with the smoother's own gains
        C = Ps[:, 1:] @ G.mT
        if use_ut:
            Sigma_q, Sigma_r = self._ut_moments(f, h, q0, r0, ms, Ps, C, y,
                                                u, uparams)
        else:
            # dynamics residual t -> t+1 linearised at the smoothed means:
            # E[F_q (q−q0)(q−q0)ᵀ F_qᵀ] ≈ δδᵀ + P^s_{t+1} − C F_xᵀ − F_x Cᵀ
            # + F_x P^s_t F_xᵀ with δ_t = m^s_{t+1} − f(m^s_t, q0, u_{t+1})
            Fx_s = at(F_x, ms[:, :-1], q0, u[1:T]).reshape(B, T - 1, dx, dx)
            delta = ms[:, 1:] - at(f, ms[:, :-1], q0, u[1:T])
            Sigma_q = (_outer(delta, delta) + Ps[:, 1:] - C @ Fx_s.mT
                       - Fx_s @ C.mT + Fx_s @ Ps[:, :-1] @ Fx_s.mT)
            yhat = at(h, ms, r0, u[:T]).reshape(B, T, -1)
            resid = y - yhat
            Hx_s = at(H_x, ms, r0, u[:T]).reshape(B, T, -1, dx)
            Sigma_r = _outer(resid, resid) + Hx_s @ Ps @ Hx_s.mT

        # into noise space through the noise Jacobians' pseudo-inverses
        # (identity when the noise is additive)
        Gq = at(F_q, ms[:, :-1], q0, u[1:T]).reshape(B, T - 1, dx, -1)
        Gq_pinv = torch.linalg.pinv(Gq)
        sum_qq = torch.einsum("btai,btij,btcj->bac", Gq_pinv, Sigma_q,
                              Gq_pinv)
        dy = y.shape[-1]
        Hr_s = at(H_r, ms, r0, u[:T]).reshape(B, T, dy, -1)
        Hr_pinv = torch.linalg.pinv(Hr_s)
        sum_rr = torch.einsum("btai,btij,btcj->bac", Hr_pinv, Sigma_r,
                              Hr_pinv)

        m0 = ms[:, 0]
        stats = SuffStatsNLSSM(
            Ex0=m0,
            Ex0x0=Ps[:, 0] + _outer(m0, m0),
            sum_qq=sum_qq,
            sum_rr=sum_rr,
            num_timesteps=torch.full((B,), float(T), dtype=torch.float32,
                                     device=ms.device),
        )
        return stats, post.marginal_loglik

    @staticmethod
    def _ut_moments(f, h, q0, r0, ms, Ps, C, y, u, uparams):
        """``E[ggᵀ] = Cov_UT(g) + μμᵀ`` of the dynamics residual
        ``g = x_{t+1} − f(x_t)`` under sigma points of the smoothed pairwise
        joint (x_t, x_{t+1}), and of the emission residual ``y − h(x_t)``
        under sigma points of the smoothed marginal (Cholesky factors)."""
        from bayesianfiltering_tpu_torch.inference import _over_steps
        from bayesianfiltering_tpu_torch.ops import ukf as _ukf
        from bayesianfiltering_tpu_torch.utils.linalg import cholesky_nan
        from bayesianfiltering_tpu_torch.utils.sigma_points import (
            points_from_factor,
        )

        B, T, dx = ms.shape
        k = B * (T - 1)

        def rows(fn, pts, noise, uu):
            """``fn`` at every row of every step of ``pts`` (B, n, r, d)."""
            n = pts.shape[1]
            rep = lambda a: a.expand((B,) + a.shape).reshape(
                (B * n,) + a.shape[1:])
            out = _ukf.eval_step_rows(
                fn, pts.reshape((B * n,) + pts.shape[2:]),
                rep(noise.expand((n,) + noise.shape)), rep(uu))
            return out.reshape((B, n) + out.shape[1:])

        n_j = 2 * dx
        scale_j, weights_j = _ukf.ut_weights(n_j, uparams)
        jm = torch.cat([ms[:, :-1], ms[:, 1:]], dim=-1)
        jP = torch.cat([torch.cat([Ps[:, :-1], C.mT], dim=-1),
                        torch.cat([C, Ps[:, 1:]], dim=-1)], dim=-2)
        diag = torch.diagonal(jP, dim1=-2, dim2=-1).abs().amax(-1)
        jP = jP + 1e-6 * diag[..., None, None] * torch.eye(
            n_j, dtype=jP.dtype, device=jP.device)
        pts = points_from_factor(jm, cholesky_nan(jP), scale_j)
        g_pts = pts[..., dx:] - rows(f, pts[..., :dx].contiguous(), q0,
                                     u[1:T])
        g0 = ms[:, 1:] - _over_steps(
            f, ms[:, :-1], q0.expand((T - 1,) + q0.shape), u[1:T])
        mu, cov, _ = _ukf._ut_moments(g0.reshape(k, dx),
                                      g_pts.reshape(k, 2 * n_j, dx),
                                      weights_j)
        Sigma_q = (cov + _outer(mu, mu)).reshape(B, T - 1, dx, dx)

        scale_e, weights_e = _ukf.ut_weights(dx, uparams)
        pts = points_from_factor(ms, cholesky_nan(Ps), scale_e)
        dy = y.shape[-1]
        g_pts = y[:, :, None, :] - rows(h, pts, r0, u[:T]).reshape(
            B, T, 2 * dx, dy)
        g0 = y - _over_steps(h, ms, r0.expand((T,) + r0.shape),
                             u[:T]).reshape(B, T, dy)
        mu, cov, _ = _ukf._ut_moments(g0, g_pts, weights_e)
        return Sigma_q, cov + _outer(mu, mu)

    def m_step(self, params: ParamsNLSSM, props, batch_stats: SuffStatsNLSSM,
               m_step_state):
        """Closed-form update of Q, R and the initial moments from the
        batch-summed statistics; frozen fields keep their values."""
        from bayesianfiltering_tpu_torch.utils.linalg import symmetrize

        s = tree_map(lambda x: x.sum(0), batch_stats)
        n_seq = batch_stats.num_timesteps.shape[0]
        T_total = s.num_timesteps

        Q_new = symmetrize(s.sum_qq / (T_total - n_seq))
        R_new = symmetrize(s.sum_rr / T_total)
        m0_new = s.Ex0 / n_seq
        P0_new = symmetrize(s.Ex0x0 / n_seq - _outer(m0_new, m0_new))

        def pick(name, new, old):
            prop = getattr(props, name, None) if props is not None else None
            return new if getattr(prop, "trainable", True) else old

        new_params = params._replace(
            initial_mean=pick("initial_mean", m0_new, params.initial_mean),
            initial_covariance=pick("initial_covariance", P0_new,
                                    params.initial_covariance),
            dynamics_noise_covariance=pick(
                "dynamics_noise_covariance", Q_new,
                params.dynamics_noise_covariance),
            emission_noise_covariance=pick(
                "emission_noise_covariance", R_new,
                params.emission_noise_covariance),
        )
        return new_params, m_step_state


class NonlinearSSM(NonlinearGaussianSSM):
    """General non-additive-noise nonlinear SSM,
    ``x_t = f(x_{t-1}, q_t, u_t)``, ``y_t = h(x_t, r_t, u_t)``."""

    def __init__(self, state_dim: int, state_noise_dim: int,
                 emission_dim: int, emission_noise_dim: int,
                 input_dim: int = 0, em_moments: str = "ekf",
                 em_uparams=None):
        super().__init__(state_dim, emission_dim, input_dim,
                         em_moments=em_moments, em_uparams=em_uparams)
        self.state_noise_dim = state_noise_dim
        self.emission_noise_dim = emission_noise_dim

    def transition_distribution(self, params: ParamsNLSSM, state,
                                inputs=None):
        """Gaussian approximation of p(x' | x): mean the zero-noise
        propagation f(x, q0, u), covariance the noise-linearised
        F_q Q F_qᵀ — exact when the noise enters additively."""
        f = params.dynamics_function
        q0 = params.dynamics_noise_bias
        mean = f(state, q0, inputs)
        Fq = torch.func.jacfwd(f, argnums=1)(state, q0, inputs)
        return MVN(mean, Fq @ params.dynamics_noise_covariance @ Fq.mT)

    def emission_distribution(self, params: ParamsNLSSM, state, inputs=None):
        """Gaussian approximation of p(y | x) by noise linearisation (exact
        for additive noise); see :meth:`transition_distribution`."""
        h = params.emission_function
        r0 = params.emission_noise_bias
        mean = h(state, r0, inputs)
        Hr = torch.func.jacfwd(h, argnums=1)(state, r0, inputs)
        cov = Hr @ params.emission_noise_covariance @ Hr.mT
        return MVN(torch.atleast_1d(mean), torch.atleast_2d(cov))

    def sample(
        self,
        params: ParamsNLSSM,
        num_timesteps: int,
        inputs: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        draws: Optional[SampleDraws] = None,
        batch_shape: Sequence[int] = (),
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample ``batch_shape`` independent sequences of states and
        emissions, shapes (*batch, T, dx) and (*batch, T, dy).

        All noise is drawn up front, from ``generator`` or given as
        ``draws``; t=0 takes the initial-distribution draw and every later
        step ``x_t = f(x_{t-1}, q_t, u_t)``. ``inputs`` (T, ...) is shared
        by the batch. The model functions act on a trailing state axis.
        """
        f, h = params.dynamics_function, params.emission_function
        m0 = params.initial_mean
        batch = tuple(batch_shape)
        T = int(num_timesteps)
        if draws is None:
            draws = SampleDraws(
                standard_normal(batch + m0.shape[-1:], m0, generator),
                standard_normal(
                    batch + (T,) + params.dynamics_noise_bias.shape[-1:], m0,
                    generator),
                standard_normal(
                    batch + (T,) + params.emission_noise_bias.shape[-1:], m0,
                    generator),
            )
        x = mvn_sample(m0, params.initial_covariance, batch,
                       eps=draws.initial)
        dyn = mvn_sample(params.dynamics_noise_bias,
                         params.dynamics_noise_covariance, batch + (T,),
                         eps=draws.dynamics)
        obs = mvn_sample(params.emission_noise_bias,
                         params.emission_noise_covariance, batch + (T,),
                         eps=draws.emission)
        states, emissions = [], []
        for t in range(T):
            u_t = None if inputs is None else inputs[t]
            if t > 0:
                x = f(x, dyn[..., t, :], u_t)
            states.append(x)
            emissions.append(torch.atleast_1d(h(x, obs[..., t, :], u_t)))
        return torch.stack(states, dim=-2), torch.stack(emissions, dim=-2)

    def _filter_params(self, params: ParamsNLSSM) -> ParamsNLSSM:
        # already in the non-additive convention the filter layer speaks
        return params


__all__ = ["NonlinearGaussianSSM", "NonlinearSSM", "SuffStatsNLSSM",
           "SampleDraws"]
