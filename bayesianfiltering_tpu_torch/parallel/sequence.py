"""Time-sharded temporally parallel Kalman filtering and smoothing, and the
time-sharded parallel IEKS (the counterpart of running
``ops/associative.parallel_kalman_filter``/``parallel_kalman_smoother`` and
``ops/parallel_iterated.parallel_iterated_extended_smoother`` of the JAX
package on a time-sharded array, whose scan XLA partitions).

Each rank takes the whole (T, dy) emissions and works on its block of T/n
steps. The schedule is :func:`~bayesianfiltering_tpu_torch.ops.associative.chunked_associative_scan`
(or the flat log-depth scan) with one more level across the ranks:

1. the local scan of the block's elements (K10 on the card; for the
   smoother K12, reversed);
2. an all-gather of the n block aggregates (a few dx² floats each);
3. each rank's exclusive prefix over the aggregates before it (after it,
   for the smoother's suffix): up to n − 2 combines;
4. one combine broadcasting that prefix into the block's local prefixes
   (K10/K12);

and K11 for the smoother's elements of the block. Only rank 0 builds the
first element from (m0, P0). A rank needs its neighbours' boundary states
(a one-state halo): the marginal log-likelihood's prior of a block's first
step is the previous rank's last prediction, and the smoothing elements of
a block's last step take the next rank's first transition. Each rank
returns the posterior of its own block, as JAX's result is a time-sharded
array, with the global marginal log-likelihood;
:func:`gather_time_blocks` assembles the whole posterior.

The cross-rank level changes the combine tree from the single-process
scan's, so the results agree with it to rounding, which the Woodbury
combine's trace-relative jitter makes visible at ~1e-8 in float64
(``ops.associative._log_depth_scan``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from bayesianfiltering_tpu_torch.ops import associative as _tas
from bayesianfiltering_tpu_torch.ops.associative import _mv
from bayesianfiltering_tpu_torch.ops.linear import (
    ParamsLGSSM,
    PosteriorKalman,
    _biases,
)
from bayesianfiltering_tpu_torch.ops.parallel_iterated import (
    IteratedSmootherAux,
)
from bayesianfiltering_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    broadcast,
    pmax,
    psum,
)
from bayesianfiltering_tpu_torch.utils.linalg import symmetrize


def _gather_tuple(xs, mesh: Mesh):
    """``all_gather`` of a tuple of tensors packed into one flat buffer:
    one collective; returns the tuple of (n, …) stacks."""
    flat = all_gather(torch.cat([x.reshape(-1) for x in xs]), mesh)
    out, at = [], 0
    for x in xs:
        out.append(flat[:, at:at + x.numel()].reshape((mesh.size,)
                                                       + x.shape))
        at += x.numel()
    return tuple(out)


def _halos(mesh: Mesh, forward, backward):
    """One all-gather of this rank's ``forward`` tuple (its last states)
    and ``backward`` tuple (its first): returns (the previous rank's
    ``forward`` or None, the next rank's ``backward`` or None)."""
    parts = _gather_tuple(tuple(forward) + tuple(backward), mesh)
    r, k = mesh.rank, len(forward)
    prev = tuple(p[r - 1] for p in parts[:k]) if r > 0 else None
    nxt = tuple(p[r + 1] for p in parts[k:]) if r + 1 < mesh.size else None
    return prev, nxt


def _filter_combine(solver: str):
    if solver == "woodbury":
        from bayesianfiltering_tpu_torch.ops.bank_combine import (
            bank_filter_combine,
        )

        return bank_filter_combine
    return functools.partial(_tas._combine, solver=solver)


def _sharded_filter_scan(elems, solver: str, chunk, mesh: Mesh):
    """Inclusive prefix of the filtering elements over the whole sequence,
    on this rank's block: the local scan, then the prefix of the blocks
    before this one broadcast into it."""
    local = _tas._run_filter_scan(elems, solver, chunk)
    if mesh.size == 1:
        return local
    aggs = _gather_tuple(tuple(x[-1] for x in local), mesh)
    if mesh.rank == 0:
        return local
    combine = _filter_combine(solver)
    excl = tuple(a[0] for a in aggs)
    for k in range(1, mesh.rank):
        excl = combine(excl, tuple(a[k] for a in aggs))
    return combine(tuple(e[None] for e in excl), local)


def _sharded_smoother_scan(elems, chunk, mesh: Mesh):
    """Inclusive suffix of the smoothing elements over the whole sequence,
    on this rank's block: the local reverse scan, then the suffix of the
    blocks after this one broadcast into it."""
    from bayesianfiltering_tpu_torch.ops.bank_smoother import (
        bank_smoother_combine,
    )

    local = _tas._run_smoother_scan(elems, chunk)
    if mesh.size == 1:
        return local
    aggs = _gather_tuple(tuple(x[0] for x in local), mesh)
    r, n = mesh.rank, mesh.size
    if r == n - 1:
        return local
    excl = tuple(a[r + 1] for a in aggs)
    for k in range(r + 2, n):
        excl = bank_smoother_combine(excl, tuple(a[k] for a in aggs))
    return bank_smoother_combine(local, tuple(e[None] for e in excl))


def _innovation_loglik(Hs, ds, Rs, ys, pm_prev, pP_prev, mesh: Mesh):
    """The marginal log-likelihood of the whole sequence from each block's
    priors ``pm_prev``, ``pP_prev``: the block's innovation densities,
    summed over the ranks."""
    from bayesianfiltering_tpu_torch.distributions import mvn_logpdf

    yhat = _mv(Hs, pm_prev) + ds
    S = symmetrize(Hs @ pP_prev @ Hs.mT + Rs)
    return psum(mvn_logpdf(ys, yhat, S).sum(), mesh)


def time_sharded_kalman_filter(params: ParamsLGSSM, emissions: torch.Tensor,
                               mesh: Mesh, solver: str = "woodbury",
                               chunk="auto",
                               axis_name: str = "time") -> PosteriorKalman:
    """:func:`~bayesianfiltering_tpu_torch.ops.associative.parallel_kalman_filter`
    with the time axis split over ``mesh``: every rank passes the whole
    ``emissions`` (T, dy) and gets its block of T/n steps, with the
    marginal log-likelihood of the whole sequence. ``chunk`` is resolved
    from the whole T ("auto": the flat scan up to 4,096 steps). Raises
    ValueError when T does not divide over the axis."""
    mesh.check_axis(axis_name)
    T = emissions.shape[0]
    start, stop = mesh.block(T, "num_timesteps")
    chunk = _tas._resolve_chunk(chunk, T)
    F, Q = params.dynamics_matrix, params.dynamics_covariance
    H, R = params.emission_matrix, params.emission_covariance
    c, d = _biases(params)
    if start == 0:
        elems = _tas._elements_time_invariant(params, emissions[:stop])
    else:
        # the element of step start − 1 stands in for the first one and is
        # dropped: every step of this block is a generic element
        elems = tuple(x[1:] for x in _tas._elements_time_invariant(
            params, emissions[start - 1:stop]))
    _, fm, fP, _, _ = _sharded_filter_scan(elems, solver, chunk, mesh)
    pm = fm @ F.T + c
    pP = symmetrize(F @ fP @ F.T + Q)

    # the prior of the block's first step: the previous rank's last
    # prediction (the initial moments on rank 0)
    prev, _ = _halos(mesh, (pm[-1], pP[-1]), ())
    m_in, P_in = ((params.initial_mean, params.initial_covariance)
                  if prev is None else prev)
    n = stop - start
    ll = _innovation_loglik(
        H.expand(n, *H.shape), d, R, emissions[start:stop],
        torch.cat([m_in[None], pm[:-1]]), torch.cat([P_in[None], pP[:-1]]),
        mesh)
    return PosteriorKalman(ll, fm, fP, pm, pP)


def _smoothing_elements(post: PosteriorKalman, Fn, mesh: Mesh):
    """The block's RTS elements: K11 over its steps, whose transitions
    out of each are ``Fn``; on the last rank the last step's element is
    the filtered marginal itself."""
    fm, fP = post.filtered_means, post.filtered_covariances
    pm, pP = post.predicted_means, post.predicted_covariances
    last = mesh.rank == mesh.size - 1
    n = len(fm) - int(last)
    G, g, L = _tas._smoother_elements(fm[:n], fP[:n], pm[:n], pP[:n], Fn[:n])
    if not last:
        return G, g, L
    return (torch.cat([G, torch.zeros_like(fP[:1])]),
            torch.cat([g, fm[-1:]]), torch.cat([L, fP[-1:]]))


def time_sharded_kalman_smoother(params: ParamsLGSSM,
                                 emissions: torch.Tensor, mesh: Mesh,
                                 solver: str = "woodbury", chunk="auto",
                                 axis_name: str = "time") -> PosteriorKalman:
    """:func:`~bayesianfiltering_tpu_torch.ops.associative.parallel_kalman_smoother`
    with the time axis split over ``mesh``: :func:`time_sharded_kalman_filter`,
    the block's smoothing elements (one K11 launch), then the reverse scan
    with the cross-rank level. Returns the rank's block."""
    post = time_sharded_kalman_filter(params, emissions, mesh, solver, chunk,
                                      axis_name)
    F = params.dynamics_matrix
    elems = _smoothing_elements(
        post, F.expand((len(post.filtered_means),) + F.shape), mesh)
    _, sm, sP = _sharded_smoother_scan(
        elems, _tas._resolve_chunk(chunk, emissions.shape[0]), mesh)
    return post._replace(smoothed_means=sm, smoothed_covariances=sP)


def _filter_tv(m0, P0, Fs, cs, Qs, Hs, ds, Rs, ys, mesh: Mesh, solver,
               chunk):
    """The time-varying filter on this rank's block, and ``Fn``, the
    transitions out of its steps: the block's last one is the next rank's
    first (the sequence's last step reuses its own, as the single-process
    filter does)."""
    T = len(ys) * mesh.size
    chunk = _tas._resolve_chunk(chunk, T)
    if mesh.rank == 0:
        first = _tas._first_element_tv(m0, P0, Hs[0], ds[0], Rs[0], ys[0])
        rest = _tas._generic_elements_tv(Fs[1:], cs[1:], Qs[1:], Hs[1:],
                                         ds[1:], Rs[1:], ys[1:])
        elems = tuple(torch.cat([f[None], r]) for f, r in zip(first, rest))
    else:
        elems = _tas._generic_elements_tv(Fs, cs, Qs, Hs, ds, Rs, ys)
    _, fm, fP, _, _ = _sharded_filter_scan(elems, solver, chunk, mesh)

    prev, nxt = _halos(mesh, (fm[-1], fP[-1]), (Fs[0], cs[0], Qs[0]))
    Fn, cn, Qn = (torch.cat([x[1:], (x[-1] if nxt is None else y)[None]])
                  for x, y in zip((Fs, cs, Qs), nxt or (None,) * 3))
    pm = _mv(Fn, fm) + cn
    pP = symmetrize(Fn @ fP @ Fn.mT + Qn)

    # the prior of each step: the prediction through Fs[t] from the
    # filtered moments of t − 1 (the previous rank's last for the block's
    # first step; the initial moments on rank 0)
    if prev is None:
        m_in, P_in = m0, P0
    else:
        m_in = _mv(Fs[0], prev[0]) + cs[0]
        P_in = symmetrize(Fs[0] @ prev[1] @ Fs[0].mT + Qs[0])
    pm_prev = torch.cat([m_in[None], _mv(Fs[1:], fm[:-1]) + cs[1:]])
    pP_prev = torch.cat([P_in[None], symmetrize(
        Fs[1:] @ fP[:-1] @ Fs[1:].mT + Qs[1:])])
    ll = _innovation_loglik(Hs, ds, Rs, ys, pm_prev, pP_prev, mesh)
    return PosteriorKalman(ll, fm, fP, pm, pP), Fn


def time_sharded_kalman_smoother_tv(m0, P0, Fs, cs, Qs, Hs, ds, Rs,
                                    emissions, mesh: Mesh,
                                    solver: str = "woodbury",
                                    chunk="auto") -> PosteriorKalman:
    """:func:`~bayesianfiltering_tpu_torch.ops.associative.parallel_kalman_smoother_tv`
    on this rank's block: the stacks and ``emissions`` hold the block's T/n
    steps (``Fs[t]``, ``cs[t]``, ``Qs[t]`` the transition into each step;
    rank 0's first one is unused), ``chunk`` is resolved from the whole T,
    and the smoothing elements take the transitions out of each step as a
    bank, one K11 launch a rank."""
    post, Fn = _filter_tv(m0, P0, Fs, cs, Qs, Hs, ds, Rs, emissions, mesh,
                          solver, chunk)
    elems = _smoothing_elements(post, Fn, mesh)
    _, sm, sP = _sharded_smoother_scan(
        elems, _tas._resolve_chunk(chunk, len(emissions) * mesh.size), mesh)
    return post._replace(smoothed_means=sm, smoothed_covariances=sP)


# ---------------------------------------------------------------------------
# the time-sharded parallel IEKS
# ---------------------------------------------------------------------------


def _rollout_block(params, inputs_arr, start: int, stop: int, mesh: Mesh):
    """This rank's block of the noise-free rollout ``x_t = f(x_{t-1},
    q0_{t-1}, u_t)`` from the initial mean, as a pipeline: rank k rolls
    its block out from the state rank k − 1 passed on (a broadcast), so
    the T model calls run one block after another."""
    from bayesianfiltering_tpu_torch.inference import _slice_noise

    f = params.dynamics_function
    x = params.initial_mean
    block = None
    for k in range(mesh.size):
        if mesh.rank == k:
            xs = [x] if start == 0 else []
            for t in range(max(start, 1), stop):
                x = f(x, _slice_noise(params, t - 1)[1], inputs_arr[t])
                xs.append(x)
            block = torch.stack(xs)
        if k + 1 < mesh.size:
            passed = broadcast(x if mesh.rank == k else torch.empty_like(x),
                               mesh, src=k)
            if mesh.rank == k + 1:
                x = passed
    return block


def _extended_linearize_block(params, x_prev, nom, u, ts, jacobians):
    """``ops.parallel_iterated._extended_linearize`` of a block of steps
    ``ts`` (global indices): the transition into each step at ``x_prev``
    (the nominal of the step before, its own at t = 0), the emission at
    ``nom``."""
    from bayesianfiltering_tpu_torch.inference import _noise_steps, _steps

    f, h, F_x, H_x, F_q, H_r = jacobians
    n, dx = nom.shape
    Q, q0, _, _ = _noise_steps(params, (ts - 1).clamp_min(0))
    F = _steps(F_x)(x_prev, q0, u).reshape(n, dx, dx)
    Fq = _steps(F_q)(x_prev, q0, u).reshape(n, dx, -1)
    c = _steps(f)(x_prev, q0, u) - _mv(F, x_prev)
    _, _, R, r0 = _noise_steps(params, ts)
    H = _steps(H_x)(nom, r0, u).reshape(n, -1, dx)
    Hr = _steps(H_r)(nom, r0, u).reshape(n, H.shape[1], -1)
    d = _steps(h)(nom, r0, u).reshape(n, -1) - _mv(H, nom)
    return (F, c, symmetrize(Fq @ Q @ Fq.mT), H, d,
            symmetrize(Hr @ R @ Hr.mT))


def time_sharded_iterated_extended_smoother(
    params,
    emissions: torch.Tensor,
    mesh: Mesh,
    num_iter: int = 5,
    inputs: Optional[torch.Tensor] = None,
    nominal=None,
    solver: str = "woodbury",
    damping: float = 1.0,
    chunk="auto",
    recenter: bool = True,
    axis_name: str = "time",
):
    """:func:`~bayesianfiltering_tpu_torch.ops.parallel_iterated.parallel_iterated_extended_smoother`
    (the plain iteration) with the time axis split over ``mesh``: every
    rank passes the whole ``emissions`` (T, dy) and ``inputs`` and gets its
    block of the smoothed posterior, with the auxiliary step norms over the
    whole sequence. Each pass is :func:`time_sharded_kalman_smoother_tv`
    (in deviation space with ``recenter``); the linearisation of a block's
    first step reads the previous rank's last nominal state (a one-state
    halo, one all-gather an iteration).

    ``nominal``: None or "rollout" (the noise-free rollout, run as a
    pipeline from rank to rank, see :func:`_rollout_block`) or a (T, dx)
    array. The "filter" seed (a sequential EKF over the whole sequence),
    the Levenberg–Marquardt variant and the sigma-point smoother stay
    single-process, as no JAX test shards them. Raises ValueError when T
    does not divide over the axis."""
    from bayesianfiltering_tpu_torch.inference import (
        PosteriorGaussianSmoothed,
        _jacobians,
        _noise_steps,
        _process_input,
        _steps,
    )

    mesh.check_axis(axis_name)
    T = emissions.shape[0]
    start, stop = mesh.block(T, "num_timesteps")
    inputs_arr = _process_input(inputs, T, emissions)
    jac = _jacobians(params)
    m0, P0 = params.initial_mean, params.initial_covariance
    if nominal is None or (isinstance(nominal, str) and nominal == "rollout"):
        nom = _rollout_block(params, inputs_arr, start, stop, mesh)
    elif isinstance(nominal, str):
        raise ValueError(f"nominal seed {nominal!r} is not time-sharded; "
                         "pass 'rollout' or a (T, dx) array")
    else:
        nom = torch.as_tensor(nominal, dtype=emissions.dtype,
                              device=emissions.device)[start:stop]
    ts = torch.arange(start, stop, device=emissions.device)
    u = inputs_arr[start:stop]
    ys = emissions[start:stop]
    residual_fn = params.emission_residual

    def run(nom):
        prev, nxt = _halos(mesh, (nom[-1],), (nom[0],))
        x_prev = torch.cat([nom[:1] if prev is None else prev[0][None],
                            nom[:-1]])
        stacks = _extended_linearize_block(params, x_prev, nom, u, ts, jac)
        ys_eff = ys
        if residual_fn is not None:
            r0 = _noise_steps(params, ts)[3]
            yh = _steps(params.emission_function)(nom, r0, u).reshape(
                len(nom), -1)
            ys_eff = yh + residual_fn(ys.reshape(len(nom), -1), yh)
        if not recenter:
            return time_sharded_kalman_smoother_tv(
                m0, P0, *stacks, ys_eff, mesh, solver, chunk)
        # deviation space, as ops.parallel_iterated._recentered_smoother_tv
        Fs, cs, Qs, Hs, ds, Rs = stacks
        post = time_sharded_kalman_smoother_tv(
            m0 - nom[0], P0, Fs, cs + _mv(Fs, x_prev) - nom, Qs, Hs,
            ds + _mv(Hs, nom), Rs, ys_eff, mesh, solver, chunk)
        nom_next = torch.cat([nom[1:], nom[-1:] if nxt is None
                              else nxt[0][None]])
        return post._replace(
            filtered_means=post.filtered_means + nom,
            predicted_means=post.predicted_means + nom_next,
            smoothed_means=post.smoothed_means + nom)

    deltas = []
    for _ in range(int(num_iter)):
        post = run(nom)
        sm = nom + damping * (post.smoothed_means - nom)
        deltas.append((sm - nom).abs().max())
        nom = sm
    post = run(nom)
    norms = (pmax(torch.stack(deltas), mesh) if deltas
             else nom.new_zeros(0))
    return PosteriorGaussianSmoothed(*post), IteratedSmootherAux(norms)


def gather_time_blocks(post, mesh: Mesh):
    """Every rank's block of a time-sharded posterior concatenated along
    the time axis (the whole posterior on every rank); 0-dim fields, such
    as the marginal log-likelihood, stay as they are."""
    return type(post)(*(x if x is None or x.ndim == 0
                        else all_gather(x, mesh, tiled=True)
                        for x in post))


__all__ = [
    "time_sharded_kalman_filter",
    "time_sharded_kalman_smoother",
    "time_sharded_kalman_smoother_tv",
    "time_sharded_iterated_extended_smoother",
    "gather_time_blocks",
]
