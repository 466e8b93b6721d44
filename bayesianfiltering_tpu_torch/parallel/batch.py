"""Data-parallel filtering over a batch of independent sequences
(counterpart of ``bayesianfiltering_tpu/parallel/batch.py``).

Every rank receives the whole (B, T, dy) batch, filters its B/n slice and
all-gathers each output along the batch axis, so that every rank returns
what the JAX package's global array holds. There is no collective while
the sequences are filtered. The port's EKF and ERTS take a batch of
sequences as they are (K1/K2 over the slice on the card); any other filter
runs once per sequence of the slice and its outputs are stacked. The JAX
package's jit cache (``_cached_batched_fn``, ``_Static``) works around
retracing and has no counterpart here.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from bayesianfiltering_tpu_torch import inference as _inf
from bayesianfiltering_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    make_mesh,
)

# entry points that take a (B, T, dy) batch of sequences with shared inputs
_TAKES_A_BATCH = (_inf.extended_kalman_filter, _inf.extended_rts_smoother)


def _map(fn, tree):
    """``fn`` on every tensor leaf of nested tuples, NamedTuples, lists
    and dicts; None stays None."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _stack(trees):
    """The leaves of equal-structure trees stacked along a new axis 0."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack(list(v)) for v in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(v)) for v in zip(*trees))
    return first


def batched_filter(
    filter_fn: Callable,
    params,
    batch_emissions: torch.Tensor,
    *filter_args,
    mesh: Optional[Mesh] = None,
    axis_name: str = "batch",
    batch_inputs: Optional[torch.Tensor] = None,
    gather: bool = True,
    **filter_kwargs,
):
    """``filter_fn(params, emissions, *args, inputs=..., **kwargs)`` over a
    leading batch of sequences (B, T, dy), split over ``mesh[axis_name]``.

    Outputs keep the leading B axis and are the same on every rank. With
    ``gather=False`` each rank returns its own B/n slice instead (its shard
    of JAX's global array), for outputs too large to hold whole on every
    rank, such as a batch's covariance histories. With no mesh this is the
    single-process call. ``batch_inputs`` (B, T, ...) are per-sequence
    inputs; without them the filter's inputs default to none. Raises
    ValueError when B does not divide over the axis."""
    B = batch_emissions.shape[0]
    if mesh is not None:
        mesh.check_axis(axis_name)
    start, stop = (0, B) if mesh is None else mesh.block(B, "batch size")
    ems = batch_emissions[start:stop]
    ins = None if batch_inputs is None else batch_inputs[start:stop]
    if ins is None and filter_fn in _TAKES_A_BATCH:
        out = filter_fn(params, ems, *filter_args, **filter_kwargs)
    else:
        out = _stack([
            filter_fn(params, ems[i], *filter_args,
                      **({} if ins is None else {"inputs": ins[i]}),
                      **filter_kwargs)
            for i in range(stop - start)])
    if mesh is None or mesh.size == 1 or not gather:
        return out
    return _map(lambda x: all_gather(x, mesh, tiled=True), out)


__all__ = ["make_mesh", "batched_filter"]
