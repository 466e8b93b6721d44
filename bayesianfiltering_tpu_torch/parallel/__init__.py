"""The multi-device layer on ``torch.distributed``
(counterpart of ``bayesianfiltering_tpu/parallel``).

The JAX package runs these paths as single-host SPMD programs under
``shard_map``; here each device is a rank of a process group, started by
:func:`~bayesianfiltering_tpu_torch.parallel.launch.run_ranks`, and a
:class:`~bayesianfiltering_tpu_torch.parallel.mesh.Mesh` is one axis over
the group's ranks. Every rank passes the whole inputs and works on its
share: a batch of sequences (:func:`batched_filter`), a particle bank
(:func:`sharded_bootstrap_particle_filter`), a component bank
(:func:`sharded_gaussian_sum_filter`, :func:`~bayesianfiltering_tpu_torch.parallel.mixture.sharded_agsf`)
or a block of time steps (:mod:`~bayesianfiltering_tpu_torch.parallel.sequence`).
Each rank runs the port's kernels on its device; the collectives are
:mod:`~bayesianfiltering_tpu_torch.parallel.mesh`'s. Randomness comes from
each rank's ``torch.Generator`` or from draws made beforehand, in place of
JAX's keys.
"""
from bayesianfiltering_tpu_torch.parallel.batch import batched_filter
from bayesianfiltering_tpu_torch.parallel.dryrun import dryrun_multichip
from bayesianfiltering_tpu_torch.parallel.launch import run_ranks
from bayesianfiltering_tpu_torch.parallel.mesh import Mesh, make_mesh
from bayesianfiltering_tpu_torch.parallel.mixture import (
    sharded_agsf,
    sharded_gaussian_sum_filter,
)
from bayesianfiltering_tpu_torch.parallel.particle import (
    sharded_bootstrap_particle_filter,
)
from bayesianfiltering_tpu_torch.parallel.sequence import (
    gather_time_blocks,
    time_sharded_iterated_extended_smoother,
    time_sharded_kalman_filter,
    time_sharded_kalman_smoother,
    time_sharded_kalman_smoother_tv,
)

__all__ = [
    "batched_filter",
    "make_mesh",
    "sharded_bootstrap_particle_filter",
    "sharded_gaussian_sum_filter",
    "sharded_agsf",
    "Mesh",
    "run_ranks",
    "dryrun_multichip",
    "time_sharded_kalman_filter",
    "time_sharded_kalman_smoother",
    "time_sharded_kalman_smoother_tv",
    "time_sharded_iterated_extended_smoother",
    "gather_time_blocks",
]
