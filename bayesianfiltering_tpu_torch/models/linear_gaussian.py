"""Linear-Gaussian SSM with exact inference and EM
(counterpart of ``bayesianfiltering_tpu/models/linear_gaussian.py``).

The E-step runs the RTS smoother (exact sufficient statistics, smoothed
cross-covariances included), the M-step is the closed-form MLE update.
From :data:`_PARALLEL_SMOOTHER_MIN_T` steps on the smoother is the
temporally parallel one (K10, K11 and K12 on CUDA tensors); below it the
sequential ``kalman_smoother``. The parallel smoother takes one sequence,
so a batch of sequences runs one sequence at a time.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from bayesianfiltering_tpu_torch.distributions import MVN
from bayesianfiltering_tpu_torch.models._fit import tree_map
from bayesianfiltering_tpu_torch.models.parameters import ParameterProperties
from bayesianfiltering_tpu_torch.models.ssm import SSM
from bayesianfiltering_tpu_torch.ops.linear import (
    ParamsLGSSM,
    kalman_filter,
    kalman_smoother,
)
from bayesianfiltering_tpu_torch.utils.linalg import psd_solve, symmetrize

# From this length on the smoother pass (and so every EM iteration) runs the
# temporally parallel scan; below it the sequential scan.
_PARALLEL_SMOOTHER_MIN_T = 4096


def _smoother_dispatch(params: ParamsLGSSM, emissions):
    if emissions.shape[0] >= _PARALLEL_SMOOTHER_MIN_T:
        from bayesianfiltering_tpu_torch.ops.associative import (
            parallel_kalman_smoother,
        )

        return parallel_kalman_smoother(params, emissions)
    return kalman_smoother(params, emissions)


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., :, None] * b[..., None, :]


def _stack(outs):
    return tree_map(lambda *xs: torch.stack(xs), outs[0], *outs[1:])


class SuffStatsLGSSM(NamedTuple):
    """Expected sufficient statistics from one sequence's smoother pass."""

    Ex0: torch.Tensor         # E[x_0]
    Ex0x0: torch.Tensor       # E[x_0 x_0ᵀ]
    sum_prev: torch.Tensor    # Σ_{t=0}^{T-2} E[x_t x_tᵀ]
    sum_next: torch.Tensor    # Σ_{t=1}^{T-1} E[x_t x_tᵀ]
    sum_cross: torch.Tensor   # Σ_{t=0}^{T-2} E[x_{t+1} x_tᵀ]
    sum_all: torch.Tensor     # Σ_t E[x_t x_tᵀ]
    sum_yx: torch.Tensor      # Σ_t y_t E[x_t]ᵀ
    sum_yy: torch.Tensor      # Σ_t y_t y_tᵀ
    num_timesteps: torch.Tensor


class PropsLGSSM(NamedTuple):
    """Trainability flags matching :class:`ParamsLGSSM` (the biases are not
    fitted; this EM fits F, Q, H, R, m0, P0)."""

    initial_mean: ParameterProperties = ParameterProperties()
    initial_covariance: ParameterProperties = ParameterProperties()
    dynamics_matrix: ParameterProperties = ParameterProperties()
    dynamics_covariance: ParameterProperties = ParameterProperties()
    emission_matrix: ParameterProperties = ParameterProperties()
    emission_covariance: ParameterProperties = ParameterProperties()


class LinearGaussianSSM(SSM):
    """x_t = F x_{t-1} + q,  y_t = H x_t + r — with exact inference and EM.
    Inputs are not used."""

    def __init__(self, state_dim: int, emission_dim: int):
        self.state_dim = state_dim
        self.emission_dim = emission_dim

    @property
    def emission_shape(self):
        return (self.emission_dim,)

    # -- distributions ----------------------------------------------------
    def initial_distribution(self, params: ParamsLGSSM, inputs=None):
        return MVN(params.initial_mean, params.initial_covariance)

    def transition_distribution(self, params: ParamsLGSSM, state,
                                inputs=None):
        mean = params.dynamics_matrix @ state
        if params.dynamics_bias is not None:
            mean = mean + params.dynamics_bias
        return MVN(mean, params.dynamics_covariance)

    def emission_distribution(self, params: ParamsLGSSM, state, inputs=None):
        mean = params.emission_matrix @ state
        if params.emission_bias is not None:
            mean = mean + params.emission_bias
        return MVN(mean, params.emission_covariance)

    # -- exact inference ----------------------------------------------------
    def filter(self, params: ParamsLGSSM, emissions, inputs=None):
        return kalman_filter(params, emissions)

    def smoother(self, params: ParamsLGSSM, emissions, inputs=None):
        return _smoother_dispatch(params, emissions)

    def marginal_log_prob(self, params: ParamsLGSSM, emissions, inputs=None):
        """log p(y_{1:T}) of one sequence (T, dy), or of each of a batch
        (B, T, dy): the sequential Kalman filter, one sequence at a
        time."""
        if emissions.ndim == 3:
            return torch.stack([kalman_filter(params, e).marginal_loglik
                                for e in emissions])
        return kalman_filter(params, emissions).marginal_loglik

    # -- EM -----------------------------------------------------------------
    def e_step(self, params: ParamsLGSSM, emissions, inputs=None):
        """Smoother pass → expected sufficient statistics and the marginal
        log-likelihood of one sequence (T, dy), or of a batch (B, T, dy)
        with a leading batch axis on both."""
        if emissions.ndim == 3:
            return _stack([self.e_step(params, e) for e in emissions])
        post = _smoother_dispatch(params, emissions)
        ms = post.smoothed_means          # (T, dx)
        Ps = post.smoothed_covariances    # (T, dx, dx)
        F = params.dynamics_matrix

        # smoothing gains G_t = P_t^f Fᵀ (P^pred_{t->t+1})⁻¹, t = 0..T-2
        G = psd_solve(post.predicted_covariances[:-1],
                      F @ post.filtered_covariances[:-1]).mT
        # E[x_{t+1} x_tᵀ] = P^s_{t+1} G_tᵀ + m^s_{t+1} m^sᵀ_t
        cross = Ps[1:] @ G.mT + _outer(ms[1:], ms[:-1])
        Exx = Ps + _outer(ms, ms)         # E[x_t x_tᵀ]

        stats = SuffStatsLGSSM(
            Ex0=ms[0],
            Ex0x0=Exx[0],
            sum_prev=Exx[:-1].sum(0),
            sum_next=Exx[1:].sum(0),
            sum_cross=cross.sum(0),
            sum_all=Exx.sum(0),
            sum_yx=emissions.mT @ ms,
            sum_yy=emissions.mT @ emissions,
            num_timesteps=torch.tensor(float(emissions.shape[0]),
                                       dtype=torch.float32,
                                       device=emissions.device),
        )
        return stats, post.marginal_loglik

    def initialize_m_step_state(self, params, props):
        return None

    def m_step(self, params: ParamsLGSSM, props: Optional[PropsLGSSM],
               batch_stats: SuffStatsLGSSM, m_step_state):
        """Closed-form MLE from the batch-summed sufficient statistics."""
        s = tree_map(lambda x: x.sum(0), batch_stats)
        n_seq = batch_stats.num_timesteps.shape[0]
        T_total = s.num_timesteps

        F_new = psd_solve(symmetrize(s.sum_prev), s.sum_cross.mT).mT
        Q_new = symmetrize(
            (s.sum_next - F_new @ s.sum_cross.mT - s.sum_cross @ F_new.mT
             + F_new @ s.sum_prev @ F_new.mT) / (T_total - n_seq))
        H_new = psd_solve(symmetrize(s.sum_all), s.sum_yx.mT).mT
        R_new = symmetrize(
            (s.sum_yy - H_new @ s.sum_yx.mT - s.sum_yx @ H_new.mT
             + H_new @ s.sum_all @ H_new.mT) / T_total)
        m0_new = s.Ex0 / n_seq
        P0_new = symmetrize(s.Ex0x0 / n_seq - _outer(m0_new, m0_new))

        if props is None:
            props = PropsLGSSM()

        def pick(prop, new, old):
            return new if prop.trainable else old

        new_params = params._replace(
            initial_mean=pick(props.initial_mean, m0_new,
                              params.initial_mean),
            initial_covariance=pick(props.initial_covariance, P0_new,
                                    params.initial_covariance),
            dynamics_matrix=pick(props.dynamics_matrix, F_new,
                                 params.dynamics_matrix),
            dynamics_covariance=pick(props.dynamics_covariance, Q_new,
                                     params.dynamics_covariance),
            emission_matrix=pick(props.emission_matrix, H_new,
                                 params.emission_matrix),
            emission_covariance=pick(props.emission_covariance, R_new,
                                     params.emission_covariance),
        )
        return new_params, m_step_state


__all__ = ["LinearGaussianSSM", "PropsLGSSM", "SuffStatsLGSSM"]
