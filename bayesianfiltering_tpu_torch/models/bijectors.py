"""The bijectors of the parameter constraints
(counterpart of ``bayesianfiltering_tpu/models/bijectors.py``).

Identity, exp, softplus, sigmoid and a real-vector ↔ PSD-matrix map for
covariance parameters, as plain functions on tensors. Each provides
``forward`` (also ``__call__``, unconstrained → constrained), ``inverse``
and ``forward_log_det_jacobian``.
"""
from __future__ import annotations

import math

import torch


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) at every x (``torch.nn.functional.softplus`` turns
    linear above x = 20, off by e⁻ˣ)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _softplus_inverse(y: torch.Tensor) -> torch.Tensor:
    """log(eʸ − 1), computed stably."""
    return y + torch.log(-torch.expm1(-y))


class Bijector:
    """Base: forward maps unconstrained -> constrained."""

    def forward(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError

    def forward_log_det_jacobian(self, x):
        raise NotImplementedError

    def __call__(self, x):
        return self.forward(x)


class Identity(Bijector):
    def forward(self, x):
        return x

    def inverse(self, y):
        return y

    def forward_log_det_jacobian(self, x):
        x = torch.as_tensor(x)
        if not x.is_floating_point():
            x = x.to(torch.get_default_dtype())
        return torch.zeros_like(x)


class Exp(Bijector):
    def forward(self, x):
        return torch.exp(x)

    def inverse(self, y):
        return torch.log(y)

    def forward_log_det_jacobian(self, x):
        return torch.as_tensor(x)


class Softplus(Bijector):
    def forward(self, x):
        return _softplus(x)

    def inverse(self, y):
        return _softplus_inverse(y)

    def forward_log_det_jacobian(self, x):
        return -_softplus(-x)


class Sigmoid(Bijector):
    def __init__(self, low: float = 0.0, high: float = 1.0):
        self.low = low
        self.high = high

    def forward(self, x):
        return self.low + (self.high - self.low) * torch.sigmoid(x)

    def inverse(self, y):
        z = (y - self.low) / (self.high - self.low)
        return torch.log(z) - torch.log1p(-z)

    def forward_log_det_jacobian(self, x):
        return math.log(self.high - self.low) - _softplus(-x) - _softplus(x)


class RealToPSD(Bijector):
    """Map an unconstrained vector of length n(n+1)/2 to an (n, n) PSD
    matrix ``L Lᵀ``: the vector fills the lower triangle of ``L`` row by
    row (``torch.tril_indices``), its diagonal through softplus."""

    def __init__(self, n: int):
        self.n = n

    def _factor(self, x):
        """``(L, raw diagonal)`` of the vector ``x``."""
        n = self.n
        rows, cols = torch.tril_indices(n, n, device=x.device)
        L = x.new_zeros(x.shape[:-1] + (n, n))
        L[..., rows, cols] = x
        raw = torch.diagonal(L, dim1=-2, dim2=-1)
        return L - torch.diag_embed(raw) + torch.diag_embed(_softplus(raw)), raw

    def forward(self, x):
        L, _ = self._factor(x)
        return L @ L.mT

    def inverse(self, y):
        n = self.n
        L = torch.linalg.cholesky(y)
        diag = _softplus_inverse(torch.diagonal(L, dim1=-2, dim2=-1))
        L = L - torch.diag_embed(torch.diagonal(L, dim1=-2, dim2=-1)) \
            + torch.diag_embed(diag)
        rows, cols = torch.tril_indices(n, n, device=y.device)
        return L[..., rows, cols]

    def forward_log_det_jacobian(self, x):
        # log|d vec(LLᵀ) / dx|: n log 2 + Σ_i (n − i + 1) log L_ii, plus the
        # softplus Jacobians of the diagonal entries
        n = self.n
        L, raw = self._factor(x)
        diag = torch.diagonal(L, dim1=-2, dim2=-1)
        exponents = torch.arange(n, 0, -1, dtype=x.dtype, device=x.device)
        chol_term = n * math.log(2.0) + (exponents * torch.log(diag)).sum(-1)
        return chol_term + (-_softplus(-raw)).sum(-1)


__all__ = ["Bijector", "Identity", "Exp", "Softplus", "Sigmoid", "RealToPSD"]
