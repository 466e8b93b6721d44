"""The multi-device dry run: one short pass through every path of the
layer on ``n`` ranks (the counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``, at its sizes, scaled by n as there).

1. a data-parallel gradient step of the EKF's marginal log-likelihood over
   a batch of 2n sequences split over the ranks: each rank's gradient
   (the kernels forward, their plain versions backward) summed by an
   all-reduce, then one SGD update;
2. the particle-sharded bootstrap PF at 64·n particles, in both resampling
   modes;
3. the time-sharded parallel Kalman filter at T = 8n, flat and with
   ``chunk=8``, and the time-sharded IEKS with 2 iterations;
4. the mixture-sharded GSF with M = 2n;
5. the mixture-sharded AGSF [2n, 2, 2] with the gathered and the local
   reductions.

Run it with :func:`dryrun_multichip`: on the CPU, or on the card, where
several ranks share it over gloo and one rank runs NCCL.
"""
from __future__ import annotations

import torch

SEED = 0
# stage 1's parameters: x' = a·x + q (Q = q·I), y = h·x + r (R = 0.1·I)
THETA = {"a": 0.5, "q": 1.0, "h": 0.2}
STATE_DIM, SEQ_LEN = 2, 6


def _finite(label: str, *xs) -> None:
    for x in xs:
        if not torch.isfinite(x).all():
            raise RuntimeError(f"dryrun {label}: outputs are not finite")


def _say(mesh, msg: str) -> None:
    if mesh.rank == 0:
        print(msg, flush=True)


def stage1_emissions(n: int, dtype=torch.float32) -> torch.Tensor:
    """Stage 1's batch of 2n sequences of the linear-Gaussian model
    (``zoo.linear_gaussian(2, 2)``), sampled on the CPU from the seed: the
    same on every rank."""
    from bayesianfiltering_tpu_torch.models import zoo

    model, params, _ = zoo.linear_gaussian(STATE_DIM, STATE_DIM, dtype=dtype,
                                           device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    return model.sample(params, SEQ_LEN, generator=gen,
                        batch_shape=(2 * n,))[1]


def ekf_loss_grads(theta, emissions):
    """The gradient of the EKF's negative marginal log-likelihood, summed
    over the sequences of ``emissions`` (B, T, 2), with respect to
    ``theta``'s scalars (a list in its order): the kernels forward on the
    card, their plain versions backward."""
    from bayesianfiltering_tpu_torch.inference import extended_kalman_filter
    from bayesianfiltering_tpu_torch.models import ParamsNLSSM

    kw = dict(dtype=emissions.dtype, device=emissions.device)
    th = {k: torch.tensor(v, requires_grad=True, **kw)
          for k, v in theta.items()}
    eye = torch.eye(STATE_DIM, **kw)
    zero = torch.zeros(STATE_DIM, **kw)
    params = ParamsNLSSM(
        initial_mean=zero, initial_covariance=eye,
        dynamics_function=lambda x, q, u: th["a"] * x + q,
        dynamics_noise_bias=zero, dynamics_noise_covariance=th["q"] * eye,
        emission_function=lambda x, r, u: th["h"] * x + r,
        emission_noise_bias=zero, emission_noise_covariance=0.1 * eye)
    lls = extended_kalman_filter(params, emissions).marginal_loglik
    return list(torch.autograd.grad(-lls.sum(), list(th.values())))


def dryrun_ranks(n_devices: int, dtype=torch.float32, device="cpu"):
    """The five stages on this rank (a target of
    :func:`~bayesianfiltering_tpu_torch.parallel.launch.run_ranks`);
    returns the stages' summaries, the same on every rank."""
    from bayesianfiltering_tpu_torch.models import zoo
    from bayesianfiltering_tpu_torch.parallel import (
        make_mesh,
        sharded_bootstrap_particle_filter,
        sharded_gaussian_sum_filter,
    )
    from bayesianfiltering_tpu_torch.parallel.mesh import psum
    from bayesianfiltering_tpu_torch.parallel.mixture import sharded_agsf
    from bayesianfiltering_tpu_torch.parallel.sequence import (
        time_sharded_iterated_extended_smoother,
        time_sharded_kalman_filter,
    )

    n = int(n_devices)
    dev = torch.device(device)
    # the data: sampled on the CPU from one seed, so every rank holds the
    # same sequences
    model, params_cpu, _ = zoo.linear_gaussian(STATE_DIM, STATE_DIM,
                                               dtype=dtype, device="cpu")
    _, params0, bpf_params = zoo.linear_gaussian(STATE_DIM, STATE_DIM,
                                                 dtype=dtype, device=dev)

    def sample(seed, T):
        gen = torch.Generator().manual_seed(seed)
        return model.sample(params_cpu, T, generator=gen)[1].to(dev)

    out = {}

    # ---- 1) the data-parallel gradient step ------------------------------
    mesh = make_mesh((n,), ("batch",), device=dev)
    emissions = stage1_emissions(n, dtype).to(dev)
    start, stop = mesh.block(len(emissions), "batch size")
    grads = torch.stack([psum(g, mesh) for g in
                         ekf_loss_grads(THETA, emissions[start:stop])])
    theta = torch.tensor(list(THETA.values()), dtype=dtype,
                         device=dev) - 1e-3 * grads
    _finite("stage 1", grads, theta)
    out["grads"], out["theta"] = grads.cpu(), theta.cpu()
    _say(mesh, f"dryrun stage 1/5 ok: DP-grad training step ({n}-way batch "
         "sharding)")

    # ---- 2) the particle-sharded BPF --------------------------------------
    pmesh = make_mesh((n,), ("particle",), device=dev)
    emissions1 = sample(SEED + 1, 4)
    for mode in ("local", "gather"):
        gen = torch.Generator(device=dev).manual_seed(SEED + 2 + pmesh.rank)
        bpf = sharded_bootstrap_particle_filter(
            bpf_params, emissions1, 64 * n, pmesh, gen, resampling_mode=mode)
        _finite(f"stage 2 ({mode})", bpf["means"], bpf["ess"])
        out[f"bpf_{mode}"] = bpf["means"].cpu()
    _say(pmesh, "dryrun stage 2/5 ok: particle-sharded BPF (psum/all_gather)")

    # ---- 3) the time-sharded KF and IEKS ----------------------------------
    tmesh = make_mesh((n,), ("time",), device=dev)
    lg = zoo.linear_gaussian_lgssm(STATE_DIM, STATE_DIM, dtype=dtype,
                                   device=dev)
    emissions2 = sample(SEED + 3, 8 * n)
    for chunk in ("auto", 8):
        post = time_sharded_kalman_filter(lg, emissions2, tmesh, chunk=chunk)
        _finite(f"stage 3 (chunk {chunk})", post.filtered_means,
                post.marginal_loglik)
        out[f"kf_{chunk}"] = post.marginal_loglik.cpu()
    post, _ = time_sharded_iterated_extended_smoother(params0, emissions2,
                                                      tmesh, num_iter=2)
    _finite("stage 3 (IEKS)", post.smoothed_means)
    _say(tmesh, "dryrun stage 3/5 ok: time-sharded associative KF (flat + "
         "chunked) + time-sharded IEKS")

    # ---- 4) the mixture-sharded GSF ---------------------------------------
    mmesh = make_mesh((n,), ("mixture",), device=dev)
    emissions3 = sample(SEED + 4, 4)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    gsf = sharded_gaussian_sum_filter(params0, emissions3, 2 * n, mmesh, gen)
    _finite("stage 4", gsf.means, gsf.marginal_loglik)
    out["gsf"] = gsf.marginal_loglik.cpu()
    _say(mmesh, "dryrun stage 4/5 ok: mixture-sharded GSF")

    # ---- 5) the mixture-sharded AGSF --------------------------------------
    for reduction in ("systematic", "local"):
        gen = torch.Generator(device=dev).manual_seed(SEED + 6 + mmesh.rank)
        agsf = sharded_agsf(params0, emissions3, [2 * n, 2, 2], mmesh, gen,
                            reduction=reduction)
        _finite(f"stage 5 ({reduction})", agsf.means, agsf.marginal_loglik)
        out[f"agsf_{reduction}"] = agsf.marginal_loglik.cpu()
    _say(mmesh, "dryrun stage 5/5 ok: mixture-sharded flagship AGSF "
         "(gathered + shard-local reductions)")
    return out


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = 600.0):
    """:func:`dryrun_ranks` on ``n_devices`` spawned ranks (``device``:
    None means the card, shared by the ranks; ``"cpu"`` runs on the
    CPU). Prints each stage's line from rank 0; returns rank 0's
    summaries."""
    from bayesianfiltering_tpu_torch.config import resolve_device
    from bayesianfiltering_tpu_torch.parallel.launch import run_ranks

    device = resolve_device(device)
    out = run_ranks(dryrun_ranks, n_devices, n_devices, device=device,
                    timeout_s=timeout_s)
    print(f"dryrun_multichip OK ({n_devices} ranks on {device})", flush=True)
    return out[0]


__all__ = ["dryrun_multichip", "dryrun_ranks"]
