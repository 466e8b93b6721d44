"""The associative Kalman filtering combine over a bank through the CUDA
kernel K10 (counterpart of ``bayesianfiltering_tpu/ops/bank_combine.py``).

K10 (``csrc/bank_combine.cu``) replaces the TPU kernel ``_combine_kernel``
(``bayesianfiltering_tpu/ops/bank_combine.py:268``, body
``_combine_lattice :147``): the whole Woodbury combine of
:func:`~bayesianfiltering_tpu_torch.ops.associative._combine` in one
launch, in float32 and float64, in two size bands with a symbol and a
launch counter each: ``bank_combine_kernel`` (:data:`K10`), a lane over a
group of 4 or 8 threads, for dx ≤ 8, and ``tiled_combine_kernel``
(:data:`K10B`), one thread block per lane on a persistent grid, for
8 < dx ≤ 512. The choice is by
size alone (:func:`band_kernel`); outside the band a CUDA input raises
NotImplementedError (the port has no plain path on the card). K10B's
launch (and K11B's and K12B's, ``ops/bank_smoother.py``) is planned here
from the width, the dtype and the lanes: :func:`block_tile` picks its
workspace's route, :func:`block_threads` its block size.

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

import functools
import math

import torch

from bayesianfiltering_tpu_torch import _build
from bayesianfiltering_tpu_torch.ops.associative import _combine

_LANE_MAX = 8     # group kernels: a lane over a group of 4 or 8 threads
_BLOCK_MAX = 512  # block kernels: one thread block per lane

_SRC = "bayesianfiltering_tpu_torch/csrc/bank_combine.cu"
K10 = _build.register("bft_bank_combine", _SRC,
                      "bayesianfiltering_tpu/ops/bank_combine.py:268")
K10B = _build.register("bft_block_combine", _SRC,
                       "bayesianfiltering_tpu/ops/bank_combine.py:268")

_CORES = (2, 1, 2, 2, 1)  # trailing core axes of A, b, C, J, η
# workspace kinds of csrc/bank_combine.cu: K10b, K11b, K12b
BLOCK_COMBINE, BLOCK_ELEMENTS, BLOCK_SCOMBINE = 0, 1, 2
# the block kernels' shared-memory tile (the leading dimension of their
# workspace, csrc/bank_combine.cu ``*_kernel_for``) and block sizes
TILE = 64
WIDE_THREADS, NARROW_THREADS = 256, 512


def elements_ldx(ld: int) -> int:
    """The width of K11b's block [Pp | F Pf | mp | pad | I] at leading
    dimension ``ld`` (csrc/bank_combine.cu ``elements_ldx``)."""
    return 3 * ld + 32


def tiled_ws(kind: int, ld: int) -> int:
    """Elements of one lane's workspace in K10b (``BLOCK_COMBINE``), K11b
    (``BLOCK_ELEMENTS``) or K12b (``BLOCK_SCOMBINE``) at leading dimension
    ``ld`` (csrc/bank_combine.cu ``tiled_ws``): six ld × ld matrices, four
    vectors and the partial sums of a matrix-vector product; F, two Pf
    buffers, the block of ld rows of :func:`elements_ldx`, the pivots'
    reciprocals and the partial sums; or five matrices and the partial
    sums."""
    part = max(512, ld)
    if kind == BLOCK_ELEMENTS:
        return 3 * ld * ld + ld * elements_ldx(ld) + ld + part
    mats, vecs = (6, 4) if kind == BLOCK_COMBINE else (5, 0)
    return mats * ld * ld + vecs * ld + part


def block_tile(kind: int, dx: int, itemsize: int, smem_optin: int) -> int:
    """The route of K10b, K11b or K12b at width ``dx``: :data:`TILE`, the
    leading dimension of a shared-memory workspace, where dx ≤ TILE and
    the workspace fits beside the static slack under an opt-in of
    ``smem_optin`` bytes (``_build.smem_optin``), else 0 (the workspace in
    global scratch). On an H100 dx ≤ 64 takes the tile in either dtype."""
    fits = _build.fits_smem(tiled_ws(kind, TILE), itemsize, smem_optin)
    return TILE if dx <= TILE and fits else 0


def block_threads(kind: int, M: int, tile: int, itemsize: int,
                  sms: int) -> int:
    """Threads per block of K10b, K11b or K12b over M lanes: 512 for K10b
    where every lane gets a block of its own on an SM of its own
    (M ≤ ``sms``, the scan's narrow levels), in float32 on the tile, so
    that one lane's serial chain is short; else 256 (float64 keeps 256:
    its panel factor needs more than the 128 registers a thread that 512
    allow; K12b's chain is three products and K11b runs once over every
    step, and both keep 256 throughout)."""
    narrow = (kind == BLOCK_COMBINE and M <= sms and itemsize == 4
              and tile == TILE)
    return NARROW_THREADS if narrow else WIDE_THREADS


def band_kernel(lane: _build.Kernel, block: _build.Kernel, dx: int,
                *arrays):
    """The band check of the combine kernels K10–K12 (the counterpart of
    the JAX package's ``should_use_pallas``): for CUDA operands in float32
    or float64, ``lane`` at dx ≤ 8 and ``block`` at 8 < dx ≤ 512; None for
    CPU operands (the plain version runs); a CUDA operand outside the band
    raises NotImplementedError."""
    if not any(a.is_cuda for a in arrays):
        return None
    dtypes = {a.dtype for a in arrays}
    if dx > _BLOCK_MAX or not dtypes <= {torch.float32, torch.float64}:
        raise NotImplementedError(
            f"{lane.name}/{block.name} kernel band is dx <= {_BLOCK_MAX} "
            f"(a lane over a group of threads to dx = {_LANE_MAX}, one "
            f"block a lane above), "
            f"float32/float64; got dx={dx}, {sorted(map(str, dtypes))}")
    return lane if dx <= _LANE_MAX else block


def block_scratch(kind: int, kernel: _build.Kernel, M: int, like):
    """The global scratch of a block kernel's global route over M lanes,
    bounded by the blocks in flight."""
    elems = _build.load().bft_block_scratch_elems(
        kind, M, like.shape[-1], like.device.index)
    return _build.scratch(elems, kernel, 1, like)


def tiled_plan(kind: int, kernel: _build.Kernel, M: int, like):
    """The launch of K10b, K11b or K12b over M lanes like ``like``: its
    global scratch (None on a shared-memory tile; the caller keeps it until
    the launch is queued) and (tile, threads)."""
    tile = block_tile(kind, like.shape[-1], like.element_size(),
                      _build.smem_optin(like.device))
    threads = block_threads(kind, M, tile, like.element_size(),
                            _build.sm_count(like.device))
    scratch = None if tile else block_scratch(kind, kernel, M, like)
    return scratch, (tile, threads)


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


def _launch(kernel, *xs):
    Ml, Mr = xs[0].shape[0], xs[5].shape[0]
    M, dx = max(Ml, Mr), xs[0].shape[-1]
    shapes = [(Ml, dx, dx), (Ml, dx), (Ml, dx, dx), (Ml, dx, dx), (Ml, dx),
              (Mr, dx, dx), (Mr, dx), (Mr, dx, dx), (Mr, dx, dx), (Mr, dx)]
    _build.check_operands(kernel, *zip(xs, shapes))
    if M and (M % Ml or M % Mr):
        raise ValueError(f"{kernel.name}: lanes {Ml} and {Mr} do not tile "
                         f"{M}")
    A1 = xs[0]
    outs = (A1.new_empty(M, dx, dx), A1.new_empty(M, dx),
            A1.new_empty(M, dx, dx), A1.new_empty(M, dx, dx),
            A1.new_empty(M, dx))
    if M:
        with torch.cuda.device(A1.device):
            ptrs = [x.data_ptr() for x in (*xs, *outs)]
            plan = ()
            if kernel is K10B:
                scratch, plan = tiled_plan(BLOCK_COMBINE, kernel, M, A1)
                ptrs.append(_build.ptr(scratch))
            err = _build.symbol(kernel, A1)(
                *ptrs, M, Ml, Mr, dx, *plan,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, kernel)
        kernel.launches += 1
    return outs


_bank_combine = _build.kernel_op(_combine_lanes,
                                 functools.partial(_launch, K10), 10)
_block_combine = _build.kernel_op(_combine_lanes,
                                  functools.partial(_launch, K10B), 10)


def bank_filter_combine(left, right):
    """Associative Kalman-filtering combine over banks of elements.

    ``left``/``right`` are 5-tuples ``(A, b, C, J, η)`` with broadcastable
    leading batch axes (matrices batch+(dx, dx), vectors batch+(dx,)).
    Semantics of ``ops.associative._combine(..., solver="woodbury")``; on
    CUDA tensors the whole combine is one K10 launch (the lane kernel at
    dx ≤ 8, the block kernel at 8 < dx ≤ 512, float32 or float64, else
    NotImplementedError), on CPU tensors the plain combine runs.
    """
    dx = left[0].shape[-1]
    kernel = band_kernel(K10, K10B, dx, *left, *right)
    if kernel is None:
        return _combine(left, right, solver="woodbury")
    batch = torch.broadcast_shapes(left[0].shape[:-2], right[0].shape[:-2])
    flat = [as_lanes(x, batch, core)[0]
            for x, core in zip((*left, *right), _CORES * 2)]
    out = (_bank_combine if kernel is K10 else _block_combine)(*flat)
    return tuple(o.reshape(tuple(batch) + o.shape[1:]) for o in out)


__all__ = ["bank_filter_combine", "band_kernel", "block_threads", "block_tile",
           "K10", "K10B"]
