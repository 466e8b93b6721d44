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


def sigma_inputs(rng: np.random.Generator, B: int, n: int):
    """``(m, P)`` for the sigma-point kernel."""
    return rng.standard_normal((B, n)), spd(rng, B, n)


def sigma_aug_inputs(rng: np.random.Generator, B: int, dx: int, dn: int):
    """``(m, P, bias, C)`` for the augmented sigma points, bias and C
    shared."""
    return (rng.standard_normal((B, dx)), spd(rng, B, dx),
            0.1 * rng.standard_normal(dn), spd(rng, 1, dn, 0.5)[0])


def ut_update_inputs(rng: np.random.Generator, B: int, rows: int, ld: int,
                     dx: int, dy: int):
    """``(pts, hpts, center_y, mu_y, m, P, R, innov)`` for the UT update:
    ``rows`` sigma points of width ``ld`` ≥ dx (state first), images that
    depend on the state part, R shared."""
    pts = rng.standard_normal((B, rows, ld))
    G = rng.standard_normal((dx, dy)) / np.sqrt(dx)
    hpts = pts[..., :dx] @ G + 0.3 * rng.standard_normal((B, rows, dy))
    return (pts, hpts, rng.standard_normal((B, dy)), hpts.mean(axis=-2),
            rng.standard_normal((B, dx)), spd(rng, B, dx),
            spd(rng, 1, dy, 0.5)[0], rng.standard_normal((B, dy)))


def ut_predict_inputs(rng: np.random.Generator, B: int, rows: int, dx: int):
    """``(fpts, center, Q)`` for the UT predict moments, Q shared."""
    return (rng.standard_normal((B, rows, dx)), rng.standard_normal((B, dx)),
            spd(rng, 1, dx)[0])


__all__ = ["to_torch", "spd", "update_inputs", "predict_inputs",
           "sigma_inputs", "sigma_aug_inputs", "ut_update_inputs",
           "ut_predict_inputs"]
