"""Legacy (v0) bootstrap particle filter
(counterpart of ``bayesianfiltering_tpu/legacy/particlefilt.py``).

``BootstrapPF(ssm, N)`` with ``run(ys, m0, P0)`` over an additive-noise
legacy :class:`~bayesianfiltering_tpu_torch.legacy.gaussfilt.SSM`: one
batched propagate-and-weigh pass a step and a resampling on every step (no
ESS gate), through ``get_resampler``. On CUDA tensors the systematic and
stratified resamplers invert their counts with the CUDA kernel K5
(``ops.resample_gather``), so a run of T steps launches it T times.

Randomness: a ``torch.Generator`` or the
:class:`~bayesianfiltering_tpu_torch.inference.BPFDraws` of a run (``init``
(N, dx), ``dynamics`` (T, N, dx), ``resample`` (T,) + the resampler's
uniform shape).
"""
from __future__ import annotations

from typing import Optional

import torch

from bayesianfiltering_tpu_torch.distributions import (
    mvn_logpdf,
    mvn_sample,
    standard_normal,
)
from bayesianfiltering_tpu_torch.inference import BPFDraws
from bayesianfiltering_tpu_torch.legacy.gaussfilt import SSM, as_tensor
from bayesianfiltering_tpu_torch.utils.resampling import (
    UNIFORM_SHAPES,
    get_resampler,
)
from bayesianfiltering_tpu_torch.utils.linalg import cholesky_nan


class BootstrapPF:
    def __init__(self, ssm: SSM, N: int,
                 generator: Optional[torch.Generator] = None,
                 resampler: str = "systematic"):
        self.f, self.g = ssm.f, ssm.g
        self.Q, self.R = ssm.Q, ssm.R
        self.dx, self.dy = ssm.dx, ssm.dy
        self.N = N
        self.generator = generator
        self.resampler = resampler
        self.resample_fn = get_resampler(resampler)

    def __str__(self):
        return "BPF"

    def run(self, ys, m0, P0, verbose: bool = False,
            draws: Optional[BPFDraws] = None):
        """Returns the (T, N, dx) history of the resampled particles."""
        dev = self.Q.device
        ys = as_tensor(ys, dev)
        m0, P0 = as_tensor(m0, dev), as_tensor(P0, dev)
        N, dx = self.N, self.dx
        gen = self.generator
        particles = mvn_sample(m0, P0, (N,), gen,
                               None if draws is None else draws.init)
        chol_q = cholesky_nan(self.Q)
        u_shape = UNIFORM_SHAPES[self.resampler](N)
        f = torch.func.vmap(lambda p: torch.atleast_1d(self.f(p)))
        g = torch.func.vmap(lambda p: torch.atleast_1d(self.g(p)))
        history = m0.new_empty((ys.shape[0], N, dx))
        for t in range(ys.shape[0]):
            eps = standard_normal((N, dx), m0, gen,
                                  None if draws is None else draws.dynamics[t])
            particles = f(particles) + eps @ chol_q.T
            lls = mvn_logpdf(torch.atleast_1d(ys[t]), g(particles), self.R)
            w = torch.exp(lls - lls.max())
            w = w / w.sum()
            u = (torch.rand(u_shape, generator=gen, dtype=m0.dtype,
                            device=dev)
                 if draws is None else draws.resample[t])
            particles = particles[self.resample_fn(w, N, u=u)]
            history[t] = particles
        return history


__all__ = ["BootstrapPF"]
