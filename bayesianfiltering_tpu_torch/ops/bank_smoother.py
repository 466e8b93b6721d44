"""The parallel RTS smoother's elements and combine over a bank through the
CUDA kernels K11 and K12
(counterpart of ``bayesianfiltering_tpu/ops/bank_smoother.py``).

Both live in ``csrc/bank_combine.cu``, float32 and float64, each in two
size bands with a symbol and a launch counter each: a lane over a group of
4 or 8 threads at dx ≤ 8 (``bank_smoother_*_kernel``, :data:`K11`,
:data:`K12`, on ``csrc/lane_group.cuh``) and one thread block per lane on
a persistent grid at 8 < dx ≤ 512 (``block_smoother_elements_kernel``,
:data:`K11B`, and ``tiled_smoother_combine_kernel``, :data:`K12B`, whose
launches ``ops.bank_combine.tiled_plan`` plans as K10B's):

- K11 ``bank_smoother_elements_kernel`` replaces ``_elements_kernel``
  (``bayesianfiltering_tpu/ops/bank_smoother.py:53``): the smoothing gain
  ``G = (Pp⁻¹ F Pf)ᵀ`` by an in-kernel Cholesky ``Pp = Lp Lpᵀ`` and, on
  each thread of the lane's group, a forward and a back substitution on
  its column of ``F Pf`` (row i of G, no inverse formed),
  ``g = mf − G mp`` and, with ``Y = Lp⁻¹ F Pf``, ``L = sym(Pf) − YᵀY``
  (= ``sym(Pf − G Pp Gᵀ)``). The TPU kernel's 1e-30 diagonal floor is
  dropped (it kept zero-padded lanes factorable; the padding here has
  unit pivots), so a Pp that is not positive definite gives NaN
  throughout the lane, as the plain version's ``psd_solve`` does. K11b
  computes the same outputs from one factor and one triangular solve:
  ``G = Yᵀ Lp⁻¹``, ``G mp = Yᵀ (Lp⁻¹ mp)``.
- K12 ``bank_smoother_combine_kernel`` replaces
  ``_smoother_combine_kernel`` (``:169``): ``E = E1 E2``,
  ``g = E1 g2 + g1``, ``L = sym(E1 L2 E1ᵀ + L1)``.

On CUDA tensors the wrappers launch the kernels, or raise
NotImplementedError outside the band; on CPU tensors the plain versions
run.
"""
from __future__ import annotations

import functools

import torch

from bayesianfiltering_tpu_torch import _build
from bayesianfiltering_tpu_torch.ops.associative import _smoother_combine
from bayesianfiltering_tpu_torch.ops.bank_combine import (
    BLOCK_ELEMENTS,
    BLOCK_SCOMBINE,
    as_lanes,
    band_kernel,
    periodic_views,
    tiled_plan,
)
from bayesianfiltering_tpu_torch.utils.linalg import psd_solve, symmetrize

_SRC = "bayesianfiltering_tpu_torch/csrc/bank_combine.cu"
K11 = _build.register("bft_bank_smoother_elements", _SRC,
                      "bayesianfiltering_tpu/ops/bank_smoother.py:53")
K12 = _build.register("bft_bank_smoother_combine", _SRC,
                      "bayesianfiltering_tpu/ops/bank_smoother.py:169")
K11B = _build.register("bft_block_smoother_elements", _SRC,
                       "bayesianfiltering_tpu/ops/bank_smoother.py:53")
K12B = _build.register("bft_block_smoother_combine", _SRC,
                       "bayesianfiltering_tpu/ops/bank_smoother.py:169")

_CORES = (2, 1, 2)  # E, g, L


def _elements_plain(fm, fP, pm, pP, F):
    """RTS elements by ``psd_solve``: ``G = (Pp⁻¹ F Pf)ᵀ``,
    ``g = mf − G mp``, ``L = sym(Pf − G Pp Gᵀ)``; ``F`` (dx, dx) shared or
    (M, dx, dx)."""
    G = psd_solve(pP, F @ fP).mT
    g = fm - (G @ pm[..., None])[..., 0]
    L = symmetrize(fP - G @ pP @ G.mT)
    return G, g, L


def _launch_elements(kernel, fm, fP, pm, pP, F):
    M, dx = fm.shape
    banked = F.ndim == 3
    _build.check_operands(kernel, (fm, (M, dx)), (fP, (M, dx, dx)),
                          (pm, (M, dx)), (pP, (M, dx, dx)),
                          (F, (M, dx, dx) if banked else (dx, dx)))
    E, g, L = torch.empty_like(fP), torch.empty_like(fm), torch.empty_like(fP)
    if M:
        with torch.cuda.device(fm.device):
            ptrs = [x.data_ptr() for x in (fm, fP, pm, pP, F, E, g, L)]
            plan = ()
            if kernel is K11B:
                scratch, plan = tiled_plan(BLOCK_ELEMENTS, kernel, M, fm)
                ptrs.append(_build.ptr(scratch))
            err = _build.symbol(kernel, fm)(
                *ptrs, M, int(banked), dx, *plan,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, kernel)
        kernel.launches += 1
    return E, g, L


_bank_elements = _build.kernel_op(
    _elements_plain, functools.partial(_launch_elements, K11), 5)
_block_elements = _build.kernel_op(
    _elements_plain, functools.partial(_launch_elements, K11B), 5)


def bank_smoother_elements(fm, fP, pm, pP, F):
    """Per-step RTS smoothing elements ``(G, g, L)`` over a bank of M steps:
    ``fm``, ``pm`` (M, dx), ``fP``, ``pP`` (M, dx, dx), ``F`` (M, dx, dx) —
    a shared transition expanded to M (stride 0) goes to K11 once, not
    copied M times. One K11 launch on CUDA tensors (the lane kernel at
    dx ≤ 8, the block kernel at 8 < dx ≤ 512, float32 or float64, else
    NotImplementedError), the plain version on CPU tensors."""
    dx = fm.shape[-1]
    kernel = band_kernel(K11, K11B, dx, fm, fP, pm, pP, F)
    if kernel is None:
        return _elements_plain(fm, fP, pm, pP, F)
    if F.ndim == 3 and F.stride(0) == 0:
        F = F[0]
    op = _bank_elements if kernel is K11 else _block_elements
    return op(fm.contiguous(), fP.contiguous(), pm.contiguous(),
              pP.contiguous(), F.contiguous())


def _scombine_lanes(*xs):
    """The plain smoothing combine on lanes-form operands (the kernel op's
    backward re-runs it): returns (M, ...) outputs."""
    v = periodic_views(xs)
    out = _smoother_combine(tuple(v[:3]), tuple(v[3:]))
    return tuple(o.reshape((-1,) + o.shape[2:]) for o in out)


def _launch_combine(kernel, *xs):
    Ml, Mr = xs[0].shape[0], xs[3].shape[0]
    M, dx = max(Ml, Mr), xs[0].shape[-1]
    shapes = [(Ml, dx, dx), (Ml, dx), (Ml, dx, dx),
              (Mr, dx, dx), (Mr, dx), (Mr, dx, dx)]
    _build.check_operands(kernel, *zip(xs, shapes))
    if M and (M % Ml or M % Mr):
        raise ValueError(f"{kernel.name}: lanes {Ml} and {Mr} do not tile "
                         f"{M}")
    E1 = xs[0]
    outs = (E1.new_empty(M, dx, dx), E1.new_empty(M, dx),
            E1.new_empty(M, dx, dx))
    if M:
        with torch.cuda.device(E1.device):
            ptrs = [x.data_ptr() for x in (*xs, *outs)]
            plan = ()
            if kernel is K12B:
                scratch, plan = tiled_plan(BLOCK_SCOMBINE, kernel, M, E1)
                ptrs.append(_build.ptr(scratch))
            err = _build.symbol(kernel, E1)(
                *ptrs, M, Ml, Mr, dx, *plan,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, kernel)
        kernel.launches += 1
    return outs


_bank_scombine = _build.kernel_op(
    _scombine_lanes, functools.partial(_launch_combine, K12), 6)
_block_scombine = _build.kernel_op(
    _scombine_lanes, functools.partial(_launch_combine, K12B), 6)


def bank_smoother_combine(earlier, later):
    """Affine smoothing composition ``earlier ∘ later`` over banks with
    broadcastable leading batch axes (semantics of
    ``ops.associative._smoother_combine``): one K12 launch on CUDA tensors
    (the lane kernel at dx ≤ 8, the block kernel at 8 < dx ≤ 512, float32
    or float64, else NotImplementedError), the plain version on CPU
    tensors."""
    dx = earlier[0].shape[-1]
    kernel = band_kernel(K12, K12B, dx, *earlier, *later)
    if kernel is None:
        return _smoother_combine(earlier, later)
    batch = torch.broadcast_shapes(earlier[0].shape[:-2], later[0].shape[:-2])
    flat = [as_lanes(x, batch, core)[0]
            for x, core in zip((*earlier, *later), _CORES * 2)]
    out = (_bank_scombine if kernel is K12 else _block_scombine)(*flat)
    return tuple(o.reshape(tuple(batch) + o.shape[1:]) for o in out)


__all__ = ["bank_smoother_elements", "bank_smoother_combine", "K11", "K12",
           "K11B", "K12B"]
