"""Seeded inputs for checking the kernels against their plain twins.

Inputs are made with a numpy ``Generator`` so that the JAX package and the
port can be fed the very same arrays; :func:`to_torch` moves them over.
"""
from __future__ import annotations

import numpy as np
import torch


def to_torch(x, dtype=None, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def spd(rng: np.random.Generator, batch, n: int, scale: float = 1.0):
    """A batch of well-conditioned SPD matrices, shape (*batch, n, n)."""
    batch = tuple(np.atleast_1d(batch)) if np.ndim(batch) else (int(batch),)
    a = rng.standard_normal(batch + (n, n))
    return scale * (a @ np.swapaxes(a, -1, -2) / n + np.eye(n))


def update_inputs(rng: np.random.Generator, B: int, dx: int, dy: int):
    """``(m, P, Hx, Rt, innov)`` for a batched measurement update."""
    return (rng.standard_normal((B, dx)), spd(rng, B, dx),
            rng.standard_normal((B, dy, dx)) / np.sqrt(dx),
            spd(rng, B, dy, 0.5), rng.standard_normal((B, dy)))


def predict_inputs(rng: np.random.Generator, B: int, dx: int, dq: int):
    """``(Fx, P, Fq, Q)`` for a batched covariance predict, Q shared."""
    return (np.eye(dx) + 0.1 * rng.standard_normal((B, dx, dx)),
            spd(rng, B, dx), rng.standard_normal((B, dx, dq)) / np.sqrt(dq),
            spd(rng, 1, dq)[0])


__all__ = ["to_torch", "spd", "update_inputs", "predict_inputs"]
