"""Shared type aliases (counterpart of ``bayesianfiltering_tpu/types.py``).

JAX's PRNG keys have no torch counterpart that reproduces their streams;
stochastic entry points take a ``torch.Generator`` or their draws made
beforehand instead.
"""
from typing import Optional, Union

import torch

Generator = Optional[torch.Generator]
Scalar = Union[float, torch.Tensor]

__all__ = ["Generator", "Scalar"]
