"""The rank group of the multi-device layer and the few collectives it uses
(counterpart of ``jax.sharding.Mesh`` and ``lax.psum``/``pmax``/
``all_gather`` under ``shard_map``).

A :class:`Mesh` is one axis over the ranks of a ``torch.distributed``
process group: its name (``"batch"``, ``"particle"``, ``"mixture"``,
``"time"``), this rank, the group's size and the rank's device. The JAX
package's meshes are one-dimensional too. A world of one rank is a valid
mesh; without an initialised process group only that one is, and every
collective is then the identity.

Backends: several ranks on one card cannot run NCCL (it refuses two ranks
on one GPU), so they run ``gloo``; NCCL runs at world size 1 on the card,
and would be the backend of one rank a card. The backend is chosen by what
the run is (:func:`~bayesianfiltering_tpu_torch.parallel.launch.run_ranks`),
never by catching a failure.

The collectives take the tensors where they are: gloo takes CUDA tensors
for all_reduce, broadcast and all_gather (checked on an H100 with PyTorch
2.11 for CUDA 12.8; its send and recv do not — a CUDA send aborts the
sending process — and the layer uses neither), so nothing is copied to the
host by the layer. Every all-reduce gives the same bits on every rank
(gloo and NCCL reduce each element once and share the result), so the
ranks take the same branch on a reduced value.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from bayesianfiltering_tpu_torch.config import resolve_device

# Per collective: calls, bytes delivered to this rank (a gather's whole
# output) and host seconds inside the call (with gloo this includes waiting
# for the card's queued work, which the copy to the host waits on). Read
# and reset by measurement code; the collectives only add to it.
STATS = {}


def reset_stats() -> None:
    STATS.clear()


def _count(op: str, t0: float, out: torch.Tensor) -> None:
    s = STATS.setdefault(op, {"calls": 0, "bytes": 0, "seconds": 0.0})
    s["calls"] += 1
    s["bytes"] += out.numel() * out.element_size()
    s["seconds"] += time.perf_counter() - t0


class Mesh(NamedTuple):
    """One mesh axis over the ranks of ``group`` (the default group when
    None): ``axis_name``, this ``rank``, the axis ``size`` and the rank's
    ``device``."""

    group: Optional[object]
    axis_name: str
    rank: int
    size: int
    device: torch.device

    def check_axis(self, axis_name: str) -> None:
        """Raise unless this is the ``axis_name`` axis."""
        if self.axis_name != axis_name:
            raise ValueError(f"mesh axis {self.axis_name!r}, expected "
                             f"{axis_name!r}")

    def block(self, total: int, what: str = "size"):
        """This rank's slice ``[start, stop)`` of ``total`` items split
        evenly over the axis; raises when ``total`` does not divide."""
        if total % self.size:
            raise ValueError(f"{what}={total} not divisible by mesh axis "
                             f"{self.axis_name}={self.size}")
        n = total // self.size
        return self.rank * n, (self.rank + 1) * n


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              group=None, device=None) -> Mesh:
    """A one-axis :class:`Mesh` over ``group`` (the default process group
    when None). ``axis_sizes`` must be one size equal to the group's; the
    device goes through :func:`~bayesianfiltering_tpu_torch.config.resolve_device`
    (None means the card, a CPU run says ``device="cpu"``)."""
    if len(axis_sizes) != 1 or len(axis_names) != 1:
        raise ValueError("the multi-device layer uses one mesh axis; got "
                         f"sizes {tuple(axis_sizes)}, names "
                         f"{tuple(axis_names)}")
    size = int(axis_sizes[0])
    if dist.is_initialized():
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        if group is not None:
            raise ValueError("a group was given but torch.distributed is "
                             "not initialised")
        world, rank = 1, 0
    if size != world:
        raise ValueError(f"mesh of size {size} over a group of {world} "
                         "ranks")
    return Mesh(group, str(axis_names[0]), rank, size, resolve_device(device))


def _all_reduce(x: torch.Tensor, mesh: Mesh, op) -> torch.Tensor:
    if not dist.is_initialized():
        return x
    t0 = time.perf_counter()
    out = x.clone().contiguous()
    dist.all_reduce(out, op=op, group=mesh.group)
    _count("all_reduce", t0, out)
    return out


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh axis, on every rank."""
    return _all_reduce(x, mesh, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the mesh axis, on every
    rank."""
    return _all_reduce(x, mesh, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh: Mesh, tiled: bool = False
               ) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each), stacked along a new
    leading axis in rank order, or concatenated along axis 0 with
    ``tiled`` (``lax.all_gather``'s two forms)."""
    if not dist.is_initialized():
        return x.clone() if tiled else x[None].clone()
    t0 = time.perf_counter()
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts) if tiled else torch.stack(parts)
    _count("all_gather", t0, out)
    return out


def broadcast(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (the others pass a tensor of the
    same shape and dtype, whose values are ignored)."""
    if not dist.is_initialized():
        return x
    t0 = time.perf_counter()
    out = x.clone().contiguous()
    root = src if mesh.group is None else dist.get_global_rank(mesh.group,
                                                               src)
    dist.broadcast(out, root, group=mesh.group)
    _count("broadcast", t0, out)
    return out


__all__ = ["Mesh", "make_mesh", "psum", "pmax", "all_gather", "broadcast",
           "STATS", "reset_stats"]
