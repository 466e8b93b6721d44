"""Parameter constraint system: trainability flags and bijectors
(counterpart of ``bayesianfiltering_tpu/models/parameters.py``).

A parameter set is a NamedTuple (or a dict, list or tuple) of tensors,
callables and None; its property set has the same structure with a
:class:`ParameterProperties` in place of each tensor. The maps below walk
the two together; callables and None pass through untouched. A frozen
parameter is ``.detach()``-ed on its way back to the constrained space, the
counterpart of JAX's ``lax.stop_gradient``.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional

from typing_extensions import Protocol

from bayesianfiltering_tpu_torch.models.bijectors import Bijector
from bayesianfiltering_tpu_torch.types import Scalar


class ParameterSet(Protocol):
    """A NamedTuple with parameter tensors in its fields."""


class PropertySet(Protocol):
    """A matching NamedTuple with :class:`ParameterProperties` fields."""


class ParameterProperties:
    """The metadata of one parameter: whether it is trained and the
    bijector from the unconstrained space to its own."""

    def __init__(self, trainable: bool = True,
                 constrainer: Optional[Bijector] = None) -> None:
        self.trainable = trainable
        self.constrainer = constrainer

    def __repr__(self):
        return (f"ParameterProperties(trainable={self.trainable}, "
                f"constrainer={self.constrainer})")


def map_with_props(fn: Callable, params, props):
    """``fn(value, prop)`` at every :class:`ParameterProperties` of
    ``props``, over the matching node of ``params``; the structure of
    ``params`` is kept, and where ``props`` has no properties (None) the
    value passes through."""
    if isinstance(props, ParameterProperties):
        return fn(params, props)
    if props is None or params is None or callable(params):
        return params
    if isinstance(params, Mapping):
        return type(params)({k: map_with_props(fn, v, props[k])
                             for k, v in params.items()})
    if isinstance(params, tuple) and hasattr(params, "_fields"):
        return type(params)(*(map_with_props(fn, v, p)
                              for v, p in zip(params, props)))
    if isinstance(params, (list, tuple)):
        return type(params)(map_with_props(fn, v, p)
                            for v, p in zip(params, props))
    return params


def _leaves(tree):
    """The non-None leaves of a nest of NamedTuples, dicts, lists and
    tuples."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _pass(value) -> bool:
    return value is None or callable(value)


def to_unconstrained(params: ParameterSet, props: PropertySet) -> ParameterSet:
    """Constrained -> unconstrained."""
    def to_unc(value, prop):
        if _pass(value) or prop.constrainer is None:
            return value
        return prop.constrainer.inverse(value)

    return map_with_props(to_unc, params, props)


def from_unconstrained(unc_params: ParameterSet,
                       props: PropertySet) -> ParameterSet:
    """Unconstrained -> constrained; a frozen parameter is detached from
    the graph."""
    def from_unc(unc_value, prop):
        if _pass(unc_value):
            return unc_value
        value = (prop.constrainer(unc_value) if prop.constrainer is not None
                 else unc_value)
        return value if prop.trainable else value.detach()

    return map_with_props(from_unc, unc_params, props)


def log_det_jac_constrain(params: ParameterSet, props: PropertySet) -> Scalar:
    """Σ log|df(x)/dx| over the trainable constrained parameters."""
    unc_params = to_unconstrained(params, props)

    def logdet(unc_value, prop):
        if _pass(unc_value) or prop.constrainer is None or not prop.trainable:
            return 0.0
        return prop.constrainer.forward_log_det_jacobian(unc_value).sum()

    total = 0.0
    for term in _leaves(map_with_props(logdet, unc_params, props)):
        if not _pass(term):
            total = total + term
    return total


__all__ = [
    "ParameterSet",
    "PropertySet",
    "ParameterProperties",
    "to_unconstrained",
    "from_unconstrained",
    "log_det_jac_constrain",
]
