"""Rank targets of the multi-device tests (``tests/test_torch_parallel*.py``,
``tests/test_torch_sequence_parallel.py``): spawned processes import this
module, so it imports no JAX. Not a test file itself.

``run_cases(cases, device=...)`` runs each case ``(key, kind, kw)`` on
this rank and returns ``{key: output}`` with every tensor on the CPU, and
each case's kernel launches. The
inputs come as float64 CPU tensors and are cast to the case's dtype; the
models are built here by their zoo name (they hold closures, which do not
pickle); per-rank inputs come as lists indexed by rank.
"""
import torch

from bayesianfiltering_tpu_torch import inference as inf
from bayesianfiltering_tpu_torch.models import zoo
from bayesianfiltering_tpu_torch.ops import associative as tas
from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF
from bayesianfiltering_tpu_torch.parallel import (
    batched_filter,
    gather_time_blocks,
    make_mesh,
    run_ranks,
    sharded_agsf,
    sharded_bootstrap_particle_filter,
    sharded_gaussian_sum_filter,
    time_sharded_iterated_extended_smoother,
    time_sharded_kalman_filter,
    time_sharded_kalman_smoother,
)
from bayesianfiltering_tpu_torch.parallel.batch import _map


def _cast(x, dtype, dev):
    return None if x is None else x.to(dtype=dtype, device=dev)


def _on(x, dev):
    return None if x is None else x.to(dev)


def _model(spec, dtype, dev, which=1):
    name, kw = spec
    built = getattr(zoo, name)(dtype=dtype, device=dev, **kw)
    return built if name == "linear_gaussian_lgssm" else built[which]


def _world():
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def batched_ekf(model, ys, dtype, dev, gather=True):
    mesh = make_mesh((_world(),), ("batch",), device=dev)
    post = batched_filter(inf.extended_kalman_filter,
                          _model(model, dtype, dev), _cast(ys, dtype, dev),
                          mesh=mesh, gather=gather)
    return {"filtered_means": post.filtered_means,
            "filtered_covariances": post.filtered_covariances,
            "marginal_loglik": post.marginal_loglik}


def batched_gsf(model, ys, M, eps, dtype, dev):
    """A filter that takes one sequence: run once a sequence of the
    rank's slice, stacked, gathered; and the same calls one by one."""
    params = _model(model, dtype, dev)
    mesh = make_mesh((_world(),), ("batch",), device=dev)
    ys, eps = _cast(ys, dtype, dev), _cast(eps, dtype, dev)
    post = batched_filter(inf.gaussian_sum_filter, params, ys, M,
                          mesh=mesh, init_eps=eps)
    single = [inf.gaussian_sum_filter(params, y, M, init_eps=eps)
              for y in ys]
    return {"means": post.means, "loglik": post.marginal_loglik,
            "single_means": torch.stack([s.means for s in single]),
            "single_loglik": torch.stack([s.marginal_loglik
                                          for s in single])}


def bpf(model, ys, P, mode, draws, dtype, dev):
    mesh = make_mesh((_world(),), ("particle",), device=dev)
    d = inf.BPFDraws(*(_cast(x, dtype, dev) for x in draws[mesh.rank]))
    return sharded_bootstrap_particle_filter(
        _model(model, dtype, dev, which=2), _cast(ys, dtype, dev), P, mesh,
        resampling_mode=mode, draws=d)


def gsf(model, ys, M, eps, inputs, dtype, dev):
    mesh = make_mesh((_world(),), ("mixture",), device=dev)
    post = sharded_gaussian_sum_filter(
        _model(model, dtype, dev), _cast(ys, dtype, dev), M, mesh,
        inputs=_on(inputs, dev), init_eps=_cast(eps, dtype, dev))
    return post._asdict()


def agsf(model, ys, comps, draws, reduce, inputs, dtype, dev, **kw):
    """``reduce``: the global reduction uniforms, or a list of each rank's
    (the local reduction)."""
    mesh = make_mesh((_world(),), ("mixture",), device=dev)
    if isinstance(reduce, list):
        reduce = reduce[mesh.rank]
    d = inf.AGSFDraws(*(_cast(x, dtype, dev) for x in draws),
                      _cast(reduce, dtype, dev))
    if kw.get("moments") == "ukf":
        kw["uparams"] = ParamsUKF(*kw["uparams"])
    post = sharded_agsf(_model(model, dtype, dev), _cast(ys, dtype, dev),
                        comps, mesh, inputs=_on(inputs, dev),
                        draws=d, **kw)
    return {k: v for k, v in post._asdict().items() if v is not None}


def kalman(model, ys, smoother, chunk, dtype, dev):
    """The time-sharded filter or smoother, gathered, beside the rank's
    own block; at one rank also the single-process function."""
    mesh = make_mesh((_world(),), ("time",), device=dev)
    params = _model(model, dtype, dev)
    ys = _cast(ys, dtype, dev)
    fn = time_sharded_kalman_smoother if smoother else \
        time_sharded_kalman_filter
    block = fn(params, ys, mesh, chunk=chunk)
    out = {"whole": gather_time_blocks(block, mesh)._asdict(),
           "block_len": block.filtered_means.shape[0]}
    if mesh.size == 1:
        single = (tas.parallel_kalman_smoother if smoother
                  else tas.parallel_kalman_filter)(params, ys, chunk=chunk)
        out["single"] = single._asdict()
    return out


def ieks(model, ys, num_iter, chunk, dtype, dev):
    mesh = make_mesh((_world(),), ("time",), device=dev)
    params = _model(model, dtype, dev)
    ys = _cast(ys, dtype, dev)
    post, aux = time_sharded_iterated_extended_smoother(
        params, ys, mesh, num_iter=num_iter, chunk=chunk)
    out = {"whole": gather_time_blocks(post, mesh)._asdict(),
           "step_norms": aux.step_norms}
    if mesh.size == 1:
        single, saux = inf.parallel_iterated_extended_smoother(
            params, ys, num_iter=num_iter, chunk=chunk)
        out["single"] = single._asdict()
        out["single_step_norms"] = saux.step_norms
    return out


KINDS = {"batched_ekf": batched_ekf, "batched_gsf": batched_gsf,
         "bpf": bpf, "gsf": gsf, "agsf": agsf, "kalman": kalman,
         "ieks": ieks}


def spawn_worlds(worlds, cases_of, timeout_s=240):
    """``{n: per-rank results of run_cases(cases_of(n))}`` for each world
    size n, the spawns started together (threads waiting on
    ``run_ranks``)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(worlds)) as pool:
        futures = {n: pool.submit(run_ranks, run_cases, n, cases_of(n),
                                  device="cpu", timeout_s=timeout_s)
                   for n in worlds}
        return {n: f.result() for n, f in futures.items()}


def run_cases(cases, device="cpu"):
    """Every case ``(key, kind, kw)`` on this rank: ``{key: output}``,
    tensors on the CPU, and under ``"launches"`` each case's kernel
    launches on this rank (none on the CPU)."""
    from bayesianfiltering_tpu_torch import _build

    dev = torch.device(device)
    out = {"launches": {}}
    for key, kind, kw in cases:
        kw = dict(kw)
        dtype = kw.pop("dtype", torch.float64)
        _build.reset_launch_counts()
        out[key] = _map(lambda x: x.detach().cpu(),
                        KINDS[kind](dtype=dtype, dev=dev, **kw))
        out["launches"][key] = {k.name: k.launches for k in _build.KERNELS
                                if k.launches}
    return out
