"""Fitting helpers: batch-dimension normalisation and a minibatch SGD loop
on ``torch.optim`` (counterpart of ``bayesianfiltering_tpu/models/_fit.py``,
whose loop is optax's).

The optimizer is a factory ``make(tensors) -> torch.optim.Optimizer``; the
default, Adam at a learning rate of 1e-3 (torch's and optax's Adam both add
``eps`` after the square root), stands for ``optax.adam(1e-3)``. The
shuffle permutation comes from a ``torch.Generator``.
"""
from __future__ import annotations

import functools
from typing import Callable, Mapping, Optional, Tuple

import torch

from bayesianfiltering_tpu_torch.models.parameters import _leaves


def tree_map(fn: Callable, tree, *rest):
    """``fn`` at every leaf of a nest of NamedTuples, dicts, lists and
    tuples (and of the trees ``rest`` of the same structure); None is an
    empty node and stays None."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return type(tree)({k: tree_map(fn, v, *(r[k] for r in rest))
                           for k, v in tree.items()})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *vs) for vs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def ensure_array_has_batch_dim(tree, instance_shapes):
    """Add a leading batch dimension to ``tree`` if it is a single instance.

    ``instance_shapes`` is a per-timestep shape, e.g. ``(emission_dim,)``,
    or a nest of them matching ``tree``: a tensor of rank
    ``len(shape) + 1`` is a single (T, ...) sequence and gets a new leading
    axis, rank ``len(shape) + 2`` is already batched.
    """
    if tree is None:
        return None

    def ensure(arr, shape):
        arr = torch.as_tensor(arr)
        target_rank = len(shape) + 2
        if arr.ndim == target_rank:
            return arr
        if arr.ndim == target_rank - 1:
            return arr[None]
        raise ValueError(
            f"array of rank {arr.ndim} does not match instance shape {shape}")

    if instance_shapes is None:
        # no declared input shape (input_dim 0): the caller supplies the
        # inputs batched (B, T, ...) already
        return tree
    if isinstance(instance_shapes, tuple) and all(
            isinstance(s, int) for s in instance_shapes):
        return ensure(tree, instance_shapes)
    return tree_map(ensure, tree, instance_shapes)


def sample_minibatches(dataset, batch_size: int, shuffle: bool,
                       generator: Optional[torch.Generator] = None):
    """Yield minibatches: the nest ``dataset`` sliced along axis 0, in
    order or in a permutation drawn from ``generator``."""
    first = _leaves(dataset)[0]
    n = len(first)
    perm = (torch.randperm(n, generator=generator, device=first.device)
            if shuffle else torch.arange(n, device=first.device))
    for start in range(0, n, batch_size):
        idx = perm[start:start + batch_size]
        yield tree_map(lambda x: x[idx], dataset)


def partition_static(tree):
    """Split a params nest into (tensors, statics): function-valued leaves
    (e.g. ``ParamsNLSSM.dynamics_function``) are held apart from the
    optimised tensors. ``None`` marks the other kind's slot in each."""
    arrays = tree_map(lambda x: None if callable(x) else x, tree)
    statics = tree_map(lambda x: x if callable(x) else None, tree)
    return arrays, statics


def combine_static(arrays, statics):
    """Inverse of :func:`partition_static`."""
    def pick(a, s):
        return s if a is None else a

    if arrays is None:
        return statics
    if isinstance(arrays, Mapping):
        return type(arrays)({k: combine_static(v, statics[k])
                             for k, v in arrays.items()})
    if isinstance(arrays, tuple) and hasattr(arrays, "_fields"):
        return type(arrays)(*(combine_static(a, s)
                              for a, s in zip(arrays, statics)))
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(combine_static(a, s)
                            for a, s in zip(arrays, statics))
    return pick(arrays, statics)


adam = functools.partial(torch.optim.Adam, lr=1e-3)


def run_sgd(
    loss_fn: Callable,
    params,
    dataset,
    optimizer: Callable = adam,
    batch_size: int = 1,
    num_epochs: int = 50,
    shuffle: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[object, torch.Tensor]:
    """Minibatch SGD over ``dataset`` (a nest of tensors, leading axis =
    sequences).

    ``loss_fn(params, minibatch)`` returns a scalar tensor. Function-valued
    leaves of ``params`` are held static; only the tensors are optimised,
    by ``optimizer(tensors)`` (a ``torch.optim`` factory). Each step takes
    the loss and its gradient at the current tensors, then the optimizer's
    step. Returns the final params (detached) and the per-epoch mean loss
    trace.
    """
    arrays, statics = partition_static(params)
    arrays = tree_map(lambda a: a.detach().clone().requires_grad_(True),
                      arrays)
    opt = optimizer(_leaves(arrays))
    current = combine_static(arrays, statics)
    losses = []
    for _ in range(num_epochs):
        epoch_losses = []
        for minibatch in sample_minibatches(dataset, batch_size, shuffle,
                                            generator):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(current, minibatch)
            loss.backward()
            opt.step()
            epoch_losses.append(loss.detach())
        losses.append(torch.stack(epoch_losses).mean())
    fitted = tree_map(lambda a: a.detach(), arrays)
    return combine_static(fitted, statics), torch.stack(losses)


__all__ = [
    "ensure_array_has_batch_dim",
    "sample_minibatches",
    "run_sgd",
    "partition_static",
    "combine_static",
    "adam",
]
