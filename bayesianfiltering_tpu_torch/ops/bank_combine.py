"""The associative Kalman filtering combine over a bank through the CUDA
kernel K10 (counterpart of ``bayesianfiltering_tpu/ops/bank_combine.py``).

K10 (``csrc/bank_combine.cu``, ``bank_combine_kernel``) replaces the TPU
kernel ``_combine_kernel`` (``bayesianfiltering_tpu/ops/bank_combine.py:268``,
body ``_combine_lattice :147``): the whole Woodbury combine of
:func:`~bayesianfiltering_tpu_torch.ops.associative._combine` in one
launch, one thread per lane, for dx ≤ 8 in float32 and float64.

Cholesky guard: the kernel zeroes a lane's factor of C1 + εI unless every
pivot is positive, which is what the plain version does (``cholesky_nan``
NaNs a factor that ``cholesky_ex`` reports failed, ``cholesky_guarded``
zeroes a factor holding a NaN): the CPU reference's ``isnan`` guard, not
the TPU kernel's ``~isfinite``. The two differ only on a factor with an
infinite pivot, which no finite input reaches.

Leading batch axes broadcast. An operand whose batch axes, after its
leading 1s, are the trailing axes of the full batch — the chunked scan's
(1, G) against (chunk, G) — goes to the kernel as is and is read at lane
m mod G; any other broadcast is materialised first.
"""
from __future__ import annotations

import math

import torch

from bayesianfiltering_tpu_torch import _build
from bayesianfiltering_tpu_torch.ops.associative import _combine

_BANK_MAX = 8

K10 = _build.register("bft_bank_combine",
                      "bayesianfiltering_tpu_torch/csrc/bank_combine.cu",
                      "bayesianfiltering_tpu/ops/bank_combine.py:268")

_CORES = (2, 1, 2, 2, 1)  # trailing core axes of A, b, C, J, η


def should_use_kernel(name: str, dx: int, *arrays) -> bool:
    """The band check of the combine kernels K10–K12 (the counterpart of
    the JAX package's ``should_use_pallas``): True for CUDA operands with
    dx ≤ 8 in float32 or float64, False for CPU operands (the plain version
    runs); a CUDA operand outside the band raises NotImplementedError."""
    if not any(a.is_cuda for a in arrays):
        return False
    dtypes = {a.dtype for a in arrays}
    if dx > _BANK_MAX or not dtypes <= {torch.float32, torch.float64}:
        raise NotImplementedError(
            f"{name} kernel band is dx <= {_BANK_MAX}, float32/float64; got "
            f"dx={dx}, {sorted(map(str, dtypes))}")
    return True


def as_lanes(x: torch.Tensor, batch, core: int):
    """``(lanes, *core)`` contiguous view of ``x`` for a kernel whose output
    has ``batch`` leading axes, and the number of lanes: ``x`` as it is when
    its batch axes, leading 1s stripped, are the trailing axes of ``batch``
    (the kernel then reads lane m mod lanes), else broadcast to ``batch``."""
    xb = tuple(x.shape[:x.ndim - core])
    k = 0
    while k < len(xb) and xb[k] == 1:
        k += 1
    tail = xb[k:]
    if tail != tuple(batch[len(batch) - len(tail):]):
        x, tail = x.expand(tuple(batch) + x.shape[x.ndim - core:]), batch
    lanes = math.prod(tail)
    return x.reshape((lanes,) + x.shape[x.ndim - core:]).contiguous(), lanes


def periodic_views(xs):
    """The lanes-form operands of a kernel, viewed so that torch
    broadcasting pairs them as the kernel does: with P the fewest lanes,
    each (lanes, ...) becomes (lanes / P, P, ...)."""
    P = max(1, min(x.shape[0] for x in xs))
    return [x.reshape((x.shape[0] // P, P) + x.shape[1:]) for x in xs]


def _combine_lanes(*xs):
    """The plain combine on lanes-form operands (the kernel op's backward
    re-runs it): returns (M, ...) outputs."""
    v = periodic_views(xs)
    out = _combine(tuple(v[:5]), tuple(v[5:]), solver="woodbury")
    return tuple(o.reshape((-1,) + o.shape[2:]) for o in out)


def _launch(*xs):
    Ml, Mr = xs[0].shape[0], xs[5].shape[0]
    M, dx = max(Ml, Mr), xs[0].shape[-1]
    shapes = [(Ml, dx, dx), (Ml, dx), (Ml, dx, dx), (Ml, dx, dx), (Ml, dx),
              (Mr, dx, dx), (Mr, dx), (Mr, dx, dx), (Mr, dx, dx), (Mr, dx)]
    _build.check_operands(K10, *zip(xs, shapes))
    if M and (M % Ml or M % Mr):
        raise ValueError(f"{K10.name}: lanes {Ml} and {Mr} do not tile {M}")
    A1 = xs[0]
    outs = (A1.new_empty(M, dx, dx), A1.new_empty(M, dx),
            A1.new_empty(M, dx, dx), A1.new_empty(M, dx, dx),
            A1.new_empty(M, dx))
    if M:
        with torch.cuda.device(A1.device):
            err = _build.symbol(K10, A1)(
                *(x.data_ptr() for x in xs), *(o.data_ptr() for o in outs),
                M, Ml, Mr, dx, torch.cuda.current_stream().cuda_stream)
        _build.check(err, K10)
        K10.launches += 1
    return outs


_bank_combine = _build.kernel_op(_combine_lanes, _launch, 10)


def bank_filter_combine(left, right):
    """Associative Kalman-filtering combine over banks of elements.

    ``left``/``right`` are 5-tuples ``(A, b, C, J, η)`` with broadcastable
    leading batch axes (matrices batch+(dx, dx), vectors batch+(dx,)).
    Semantics of ``ops.associative._combine(..., solver="woodbury")``; on
    CUDA tensors the whole combine is one K10 launch (dx ≤ 8, float32 or
    float64, else NotImplementedError), on CPU tensors the plain combine
    runs.
    """
    dx = left[0].shape[-1]
    if not should_use_kernel(K10.name, dx, *left, *right):
        return _combine(left, right, solver="woodbury")
    batch = torch.broadcast_shapes(left[0].shape[:-2], right[0].shape[:-2])
    flat = [as_lanes(x, batch, core)[0]
            for x, core in zip((*left, *right), _CORES * 2)]
    out = _bank_combine(*flat)
    return tuple(o.reshape(tuple(batch) + o.shape[1:]) for o in out)


__all__ = ["bank_filter_combine", "should_use_kernel", "K10"]
