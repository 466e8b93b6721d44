"""Parent indices from cumulative child counts through the CUDA kernel K5
(counterpart of ``bayesianfiltering_tpu/ops/resample_gather.py``).

The systematic and stratified resamplers reduce to inverting a monotone
cumulative-count function of the m particles (or components): output
slot j of n takes parent ``parent(j) = #{i : counts_i ≤ j}``, clamped to
m−1 (``utils.resampling._counts_to_parents``, which calls
:func:`windowed_parents` at every size). K5 (``csrc/resample_gather.cu``,
``resample_parents_kernel``) replaces the TPU kernel ``_parents_kernel``
(``bayesianfiltering_tpu/ops/resample_gather.py:66``):
a merge-path search. In the merge of the sorted counts with the slots
0..n−1 (ties count-first), slot j's parent is the number of counts merged
before it; each thread block owns an equal stretch of the merged sequence,
finds its ends by one search, marks its counts' positions in shared
memory, and a block scan of the marks gives each thread the counts merged
before its positions, which it walks serially. It is exact for every
weight profile, and a skewed profile costs what a flat one does. The TPU
kernel's
aligned 4096-wide window, its span check and the BPF's deferral when the
span overflows (``windowed_parents_or_defer``, ``_dense_window_bounds``)
exist for Mosaic's DMA layout and are not ported: the port never defers.
Positions are int32: m + n must stay below :data:`MAX_POSITIONS`.

On CUDA tensors :func:`windowed_parents` launches K5 or raises; on CPU
tensors it runs the plain version, the scatter form of
``utils.resampling._scatter_counts_to_parents``, which K5 equals index
for index.
"""
from __future__ import annotations

import torch

from bayesianfiltering_tpu_torch import _build
from bayesianfiltering_tpu_torch.utils.resampling import (
    _scatter_counts_to_parents,
)

K5 = _build.register("bft_resample_parents",
                     "bayesianfiltering_tpu_torch/csrc/resample_gather.cu",
                     "bayesianfiltering_tpu/ops/resample_gather.py:66")
# K5's merge path indexes its m + n positions in int32, with one block's
# stretch (256 threads × 11 positions) to spare (csrc/resample_gather.cu
# kMaxPositions)
STRETCH = 256 * 11
MAX_POSITIONS = 2 ** 31 - 1 - STRETCH


def _parents_plain(counts_i32: torch.Tensor, num_samples: int) -> torch.Tensor:
    """The scatter form, as int32."""
    return _scatter_counts_to_parents(counts_i32, num_samples).to(torch.int32)


def _parents_launch(counts_i32: torch.Tensor, num_samples: int) -> torch.Tensor:
    n = num_samples
    if not counts_i32.is_cuda:
        raise ValueError(f"{K5.name}: counts must be a CUDA tensor")
    if counts_i32.dtype != torch.int32 or counts_i32.ndim != 1:
        raise ValueError(f"{K5.name}: counts must be int32 of shape (m,), "
                         f"got {counts_i32.dtype} {tuple(counts_i32.shape)}")
    counts_i32 = counts_i32.contiguous()
    m = counts_i32.shape[0]
    if m + n > MAX_POSITIONS:
        raise ValueError(f"{K5.name}: m + n = {m + n} exceeds the int32 "
                         f"merge path's {MAX_POSITIONS} positions")
    out = counts_i32.new_empty(n)
    if n:
        with torch.cuda.device(counts_i32.device):
            err = _build.symbol(K5, counts_i32)(
                counts_i32.data_ptr(), out.data_ptr(), m, n,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, K5)
        K5.launches += 1
    return out


def windowed_parents(counts: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Parents from cumulative counts, ``parent(j) = #{i : counts_i ≤ j}``
    clamped to m−1, as int32 (n,) with n = ``num_samples``: the contract of
    the JAX function of the same name (which has m = n), exact at every
    weight profile. ``counts`` (m,) is monotone, floating (the ``ceil``
    values of ``systematic_counts``) or integer; it is clipped to [0, n]
    and converted to int32 first, as in JAX, so ties at ``counts_i == j``
    resolve the same way. K5 on CUDA tensors, the scatter form on CPU
    tensors."""
    n = num_samples
    counts_i32 = torch.clamp(counts, 0, n).to(torch.int32)
    if counts_i32.is_cuda:
        return _parents_launch(counts_i32, n)
    return _parents_plain(counts_i32, n)


__all__ = ["windowed_parents", "K5"]
