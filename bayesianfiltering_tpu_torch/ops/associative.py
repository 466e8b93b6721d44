"""Temporally parallel Kalman filtering and RTS smoothing
(counterpart of ``bayesianfiltering_tpu/ops/associative.py``).

The filtering recursion is phrased as an associative operator over
per-timestep five-tuples ``(A, b, C, J, η)`` and the RTS recursion as one
over affine elements ``(E, g, L)`` (Särkkä & García-Fernández, *Temporal
Parallelization of Bayesian Smoothers*, IEEE TAC 2021). Both are combined
over the time axis by :func:`chunked_associative_scan`: O(T) work in
combines batched over thousands of lanes.

On CUDA tensors every Woodbury filtering combine runs the CUDA kernel K10
(``ops.bank_combine``), the smoothing elements K11 and every smoothing
combine K12 (``ops.bank_smoother``), each as a lane over a group of 4 or
8 threads at dx ≤ 8 and one thread block per lane above, at every width
(float16 and bfloat16 run in float32). On CPU
tensors the plain PyTorch combines below run. The ``"native"`` solver has
no kernel in the JAX package either and runs ``torch.linalg.solve``.

The time-varying variants (:func:`parallel_kalman_filter_tv`,
:func:`parallel_kalman_smoother_tv`) build their per-step elements batched
over time and run the same scans and kernels; the smoothing elements take a
per-step (banked) transition. They are the linear solver of the parallel
iterated smoothers (``ops.parallel_iterated``).
"""
from __future__ import annotations

import functools

import torch

from bayesianfiltering_tpu_torch.ops.linear import (
    ParamsLGSSM,
    PosteriorKalman,
    _biases,
)
from bayesianfiltering_tpu_torch.utils.linalg import (
    cholesky_guarded,
    cholesky_nan,
    psd_solve,
    symmetrize,
)


def _mv(A, x):
    """Batched matrix-vector product ``A x`` over broadcastable batches."""
    return (A @ x[..., None])[..., 0]


def _first_element_tv(m0, P0, H0, d0, R0, y0):
    """Element for t=0: condition the prior on y_0 with the emission model
    of step 0 (no propagation first, the update-then-predict convention of
    the sequential filter)."""
    z = torch.zeros_like(P0)
    S = symmetrize(H0 @ P0 @ H0.mT + R0)
    K = psd_solve(S, H0 @ P0).mT
    b = m0 + _mv(K, y0 - _mv(H0, m0) - d0)
    C = symmetrize(P0 - K @ S @ K.mT)
    return z, b, C, z, torch.zeros_like(m0)


def _generic_elements_tv(Fs, cs, Qs, Hs, ds, Rs, ys):
    """Elements for t ≥ 1 over any leading (time) axes: predict through
    (F, c, Q), then update with (H, d, R) and y."""
    I = torch.eye(Fs.shape[-1], dtype=Fs.dtype, device=Fs.device)
    S = symmetrize(Hs @ Qs @ Hs.mT + Rs)
    K = psd_solve(S, Hs @ Qs).mT
    resid = ys - ds - _mv(Hs, cs)
    IKH = I - K @ Hs
    A = IKH @ Fs
    b = cs + _mv(K, resid)
    C = symmetrize(IKH @ Qs)
    HF = Hs @ Fs
    J = symmetrize(HF.mT @ psd_solve(S, HF))
    eta = _mv(HF.mT, psd_solve(S, resid))
    return A, b, C, J, eta


def _first_element(params: ParamsLGSSM, y0):
    """:func:`_first_element_tv` of a time-invariant model."""
    _, d = _biases(params)
    return _first_element_tv(params.initial_mean, params.initial_covariance,
                             params.emission_matrix, d,
                             params.emission_covariance, y0)


def _generic_element(params: ParamsLGSSM, y):
    """The element of one step t ≥ 1 of a time-invariant model (predict
    through F, Q then update with y): the oracle of
    :func:`_elements_time_invariant`."""
    c, d = _biases(params)
    return _generic_elements_tv(
        params.dynamics_matrix, c, params.dynamics_covariance,
        params.emission_matrix, d, params.emission_covariance, y)


def _elements_time_invariant(params: ParamsLGSSM, emissions):
    """All T filtering elements with the constant algebra hoisted: for a
    time-invariant model A, C, J of t ≥ 1 do not depend on y_t and b, η are
    affine in it, so the solves run once and the per-step work is two
    (T−1, dy) × (dy, dx) products."""
    F, Q = params.dynamics_matrix, params.dynamics_covariance
    H, R = params.emission_matrix, params.emission_covariance
    c, d = _biases(params)
    T = emissions.shape[0]
    dx = F.shape[0]
    I = torch.eye(dx, dtype=F.dtype, device=F.device)

    S = symmetrize(H @ Q @ H.T + R)
    K = psd_solve(S, H @ Q).T
    IKH = I - K @ H
    A1 = IKH @ F
    C1 = symmetrize(IKH @ Q)
    HF = H @ F
    SinvHF = psd_solve(S, HF)
    J1 = symmetrize(HF.T @ SinvHF)

    resid = emissions[1:] - d - H @ c            # (T-1, dy)
    b1 = c + resid @ K.T
    eta1 = resid @ SinvHF

    A0, b0, C0, J0, eta0 = _first_element(params, emissions[0])
    bc = lambda X: X.expand(T - 1, dx, dx)
    return (
        torch.cat([A0[None], bc(A1)]),
        torch.cat([b0[None], b1]),
        torch.cat([C0[None], bc(C1)]),
        torch.cat([J0[None], bc(J1)]),
        torch.cat([eta0[None], eta1]),
    )


def _minv_woodbury(C1, J2):
    """Batched ``inv(I + C1 J2)`` for PSD ``C1``, ``J2`` without a general
    solve: with ``U = chol(C1 + εI)`` (guarded),
    ``inv(I + U Uᵀ J2) = I − U inv(I + Uᵀ J2 U) Uᵀ J2``, whose inner matrix
    is symmetric positive definite (⪰ I). The trace-relative ε = 1e-7·tr/dx
    keeps a rank-deficient C1 (process noise of rank < dx) factorable; a
    factor that still fails (a pivot ≤ 0 or NaN) is zeroed whole by
    :func:`cholesky_guarded`, which makes ``M⁻¹ = I`` for that lane."""
    dx = C1.shape[-1]
    I = torch.eye(dx, dtype=C1.dtype, device=C1.device)
    tr = torch.diagonal(C1, dim1=-2, dim2=-1).sum(-1)
    eps = (1e-7 * tr / dx + 1e-30)[..., None, None]
    U = cholesky_guarded(C1 + eps * I)
    J2U = J2 @ U
    inner = I + symmetrize(U.mT @ J2U)
    linv = torch.linalg.solve_triangular(
        cholesky_nan(inner), I.expand(inner.shape), upper=False)
    inner_inv = linv.mT @ linv
    return I - U @ inner_inv @ J2U.mT


def _filter_identity(dx, dtype, device=None):
    """Two-sided identity of the filtering combine: (A=I, b=0, C=0, J=0,
    η=0); exact through the Woodbury path (ε degrades to 1e-30·I)."""
    I = torch.eye(dx, dtype=dtype, device=device)
    z = torch.zeros(dx, dx, dtype=dtype, device=device)
    v = torch.zeros(dx, dtype=dtype, device=device)
    return I, v, z, z, v


def _smoother_identity(dx, dtype, device=None):
    """Two-sided identity of the smoothing combine: (E=I, g=0, L=0)."""
    return (torch.eye(dx, dtype=dtype, device=device),
            torch.zeros(dx, dtype=dtype, device=device),
            torch.zeros(dx, dx, dtype=dtype, device=device))


def _log_depth_scan(combine, elems):
    """Inclusive prefix in O(log T) depth, the tree of
    ``lax.associative_scan``: combine adjacent pairs, scan the T/2 pair
    products recursively, then combine each odd prefix with the next even
    element. Each level is one combine batched over about T/2ᵏ lanes, two
    per level, and the same tree as the JAX package's flat schedule, so the
    two agree up to rounding (the Woodbury combine's jitter makes the result
    depend on the tree at the 1e-8 level)."""
    T = elems[0].shape[0]
    if T < 2:
        return elems
    reduced = combine(tuple(x[0:-1:2] for x in elems),
                      tuple(x[1::2] for x in elems))
    odd = _log_depth_scan(combine, reduced)
    if T % 2 == 0:
        even = combine(tuple(x[:-1] for x in odd),
                       tuple(x[2::2] for x in elems))
    else:
        even = combine(odd, tuple(x[2::2] for x in elems))
    even = tuple(torch.cat([x[:1], e]) for x, e in zip(elems, even))
    out = []
    for e, o in zip(even, odd):
        y = e.new_empty((T,) + e.shape[1:])
        y[0::2], y[1::2] = e, o
        out.append(y)
    return tuple(out)


def _seq_prefix(combine, elems, identity):
    """Inclusive prefix, one combine per element in order."""
    carry = tuple(i.expand(x.shape[1:]) for i, x in zip(identity, elems))
    out = []
    for t in range(elems[0].shape[0]):
        carry = combine(carry, tuple(x[t] for x in elems))
        out.append(carry)
    return tuple(torch.stack(o) for o in zip(*out))


def chunked_associative_scan(combine, elems, identity, chunk: int = 128,
                             reverse: bool = False):
    """Recursive two-level inclusive scan, the JAX package's schedule:

    1. pad T to G·chunk with identity elements and view it as (chunk, G);
    2. in-chunk inclusive prefixes: ``chunk`` combines in order, each
       batched over all G chunks;
    3. recurse on the G chunk aggregates until they fit in one chunk, then
       a sequential prefix (one combine per aggregate);
    4. one combine broadcasting each chunk's exclusive prefix (1, G) into
       its in-chunk prefixes (chunk, G).

    ``combine`` takes broadcastable leading batch axes and is associative;
    ``identity`` (single elements) is a two-sided identity of it.
    ``reverse=True`` flips, scans forward with the same operator and flips
    back, as ``lax.associative_scan(..., reverse=True)`` does. At T=1M and
    chunk 128 that is 128 + 128 + 62 + 1 + 1 = 320 combines.
    """
    if reverse:
        out = chunked_associative_scan(
            combine, tuple(torch.flip(x, (0,)) for x in elems), identity,
            chunk)
        return tuple(torch.flip(x, (0,)) for x in out)

    T = elems[0].shape[0]
    if T <= chunk:
        return _seq_prefix(combine, elems, identity)

    G = -(-T // chunk)
    pad = G * chunk - T
    if pad:
        elems = tuple(torch.cat([x, i.expand((pad,) + x.shape[1:])])
                      for i, x in zip(identity, elems))
    # (T, ...) -> (chunk, G, ...): chunk g covers [g·chunk, (g+1)·chunk)
    blocked = tuple(
        x.reshape((G, chunk) + x.shape[1:]).movedim(1, 0).contiguous()
        for x in elems)

    # step 2: in-chunk prefixes, each combine batched over the G chunks
    carry = tuple(i.expand((G,) + i.shape) for i in identity)
    steps = []
    for k in range(chunk):
        carry = combine(carry, tuple(x[k] for x in blocked))
        steps.append(carry)
    prefix = tuple(torch.stack(p) for p in zip(*steps))    # (chunk, G, ...)

    # step 3: exclusive prefix of the chunk aggregates, recursively
    agg_prefix = chunked_associative_scan(combine, carry, identity, chunk)
    shifted = tuple(torch.cat([i[None], a[:-1]])
                    for i, a in zip(identity, agg_prefix))  # (G, ...)

    # step 4: broadcast each chunk's exclusive prefix into its elements
    out = combine(tuple(s[None] for s in shifted), prefix)  # (chunk, G, ...)
    return tuple(x.movedim(0, 1).reshape((G * chunk,) + x.shape[2:])[:T]
                 for x in out)


def _resolve_chunk(chunk, T):
    """``chunk="auto"``: the flat log-depth scan for short sequences, the
    two-level schedule at 128 beyond (the JAX package's crossover)."""
    if chunk == "auto":
        return None if T <= 4096 else 128
    return chunk


def _run_filter_scan(elems, solver: str, chunk):
    """The filtering prefix scan: chunked two-level, or the flat log-depth
    scan for ``chunk=None``. The Woodbury combine runs K10 on CUDA tensors
    (``ops.bank_combine``)."""
    fn = functools.partial(_combine, solver=solver)
    if solver == "woodbury":
        from bayesianfiltering_tpu_torch.ops.bank_combine import (
            bank_filter_combine,
        )

        fn = bank_filter_combine
    if chunk is None:
        return _log_depth_scan(fn, elems)
    A = elems[0]
    ident = _filter_identity(A.shape[-1], A.dtype, A.device)
    return chunked_associative_scan(fn, elems, ident, chunk=chunk)


def _combine(elem_left, elem_right, solver: str = "woodbury"):
    """Associative combination of filtering elements (Särkkä & G-F,
    Lemma 8), over broadcastable leading batch axes."""
    A1, b1, C1, J1, eta1 = elem_left
    A2, b2, C2, J2, eta2 = elem_right
    dx = A1.shape[-1]
    I = torch.eye(dx, dtype=A1.dtype, device=A1.device)

    # (I + C1 J2)⁻¹, applied right (M) and left (N = Mᵀ)
    if solver == "woodbury":
        Minv = _minv_woodbury(C1, J2)
        A2M = A2 @ Minv
        Ninv = Minv.mT                         # inv(I + J2 C1) = inv(M)ᵀ
        nsolve = lambda x: Ninv @ x
    elif solver == "native":
        M = I + C1 @ J2
        batch = torch.broadcast_shapes(M.shape[:-2], A2.shape[:-2])
        A2M = torch.linalg.solve(M.mT.expand(batch + (dx, dx)),
                                 A2.mT.expand(batch + (dx, dx))).mT
        N = I + J2 @ C1

        def nsolve(x):
            b = torch.broadcast_shapes(N.shape[:-2], x.shape[:-2])
            return torch.linalg.solve(N.expand(b + (dx, dx)),
                                      x.expand(b + x.shape[-2:]))
    else:
        raise ValueError(f"unknown solver {solver!r}; expected 'woodbury' "
                         "or 'native'")
    A = A2M @ A1
    b = _mv(A2M, b1 + _mv(C1, eta2)) + b2
    C = symmetrize(A2M @ C1 @ A2.mT + C2)

    tmp = nsolve((eta2 - _mv(J2, b1))[..., None])[..., 0]
    eta = _mv(A1.mT, tmp) + eta1
    JA = nsolve(J2 @ A1)
    J = symmetrize(A1.mT @ JA + J1)
    return A, b, C, J, eta


def parallel_kalman_filter(params: ParamsLGSSM, emissions: torch.Tensor,
                           solver: str = "woodbury",
                           chunk="auto") -> PosteriorKalman:
    """Temporally parallel Kalman filter; matches
    :func:`~bayesianfiltering_tpu_torch.ops.linear.kalman_filter` (filtered
    moments from the scan, predicted moments by one extra propagation,
    marginal log-likelihood in innovation form).

    ``solver``: "woodbury" (default; K10 on CUDA) or "native"
    (``torch.linalg.solve``, plain PyTorch). ``chunk``: "auto" (default)
    picks the schedule by length; an int runs
    :func:`chunked_associative_scan` with that chunk; ``None`` the flat
    log-depth scan — torch has no ``associative_scan``, so
    :func:`_log_depth_scan` rebuilds its tree: about 2·log₂ T batched
    combines.
    """
    F, Q = params.dynamics_matrix, params.dynamics_covariance
    c, _ = _biases(params)

    elems = _elements_time_invariant(params, emissions)
    _, fm, fP, _, _ = _run_filter_scan(
        elems, solver, _resolve_chunk(chunk, len(emissions)))

    pm = fm @ F.T + c
    pP = symmetrize(F @ fP @ F.T + Q)
    # predicted_*[t] predicts t+1 from 0..t, so the loglik's prior at t is
    # predicted_*[t-1]
    ll = _marginal_loglik(params, emissions, pm[:-1], pP[:-1])
    return PosteriorKalman(ll, fm, fP, pm, pP)


def _run_smoother_scan(elems, chunk):
    """Reverse suffix scan of smoothing elements over the chunked / flat
    schedule. In both, the reverse scan's left operand is the later-time
    partial product, so the time-ordered combine's roles are swapped. The
    combine runs K12 on CUDA tensors (``ops.bank_smoother``)."""
    from bayesianfiltering_tpu_torch.ops.bank_smoother import (
        bank_smoother_combine,
    )

    swapped = lambda a, b: bank_smoother_combine(b, a)
    if chunk is None:
        flipped = tuple(torch.flip(x, (0,)) for x in elems)
        return tuple(torch.flip(x, (0,))
                     for x in _log_depth_scan(swapped, flipped))
    E = elems[0]
    ident = _smoother_identity(E.shape[-1], E.dtype, E.device)
    return chunked_associative_scan(swapped, elems, ident, chunk=chunk,
                                    reverse=True)


def _smoother_elements(fm, fP, pm, pP, F):
    """Per-step RTS elements ``(G, g, L)`` for t < T−1: K11 on CUDA tensors
    (``ops.bank_smoother``)."""
    from bayesianfiltering_tpu_torch.ops.bank_smoother import (
        bank_smoother_elements,
    )

    return bank_smoother_elements(fm, fP, pm, pP, F)


def _smoother_combine(elem_earlier, elem_later):
    """Associative combination of RTS smoothing elements (Särkkä & G-F,
    Lemma 10): ``x_t | x_s ~ N(E x_s + g, L)`` composed over
    earlier ∘ later; products only, no solve."""
    E1, g1, L1 = elem_earlier
    E2, g2, L2 = elem_later
    E = E1 @ E2
    g = _mv(E1, g2) + g1
    L = symmetrize(E1 @ L2 @ E1.mT + L1)
    return E, g, L


def parallel_kalman_smoother(params: ParamsLGSSM, emissions: torch.Tensor,
                             solver: str = "woodbury",
                             chunk="auto") -> PosteriorKalman:
    """Temporally parallel RTS smoother (Särkkä & García-Fernández 2021,
    §IV): :func:`parallel_kalman_filter`, then the RTS recursion as affine
    elements ``x_t | x_{t+1} ~ N(E_t x_{t+1} + g_t, L_t)`` combined by a
    reverse scan over the same schedule. Matches
    :func:`~bayesianfiltering_tpu_torch.ops.linear.kalman_smoother`."""
    post = parallel_kalman_filter(params, emissions, solver, chunk)
    F = params.dynamics_matrix
    fm, fP = post.filtered_means, post.filtered_covariances
    pm, pP = post.predicted_means, post.predicted_covariances

    # t < T−1: G_t = P^f_t Fᵀ (P^p_{t+1|t})⁻¹, g_t = m^f_t − G_t m^p_{t+1|t},
    # L_t = P^f_t − G_t P^p G_tᵀ; F is shared by every step
    G, g, L = _smoother_elements(fm[:-1], fP[:-1], pm[:-1], pP[:-1],
                                 F.expand((len(fm) - 1,) + F.shape))
    # the last element: the smoothed marginal at T−1 is the filtered one
    elems = (torch.cat([G, torch.zeros_like(fP[:1])]),
             torch.cat([g, fm[-1:]]),
             torch.cat([L, fP[-1:]]))
    _, sm, sP = _run_smoother_scan(elems,
                                   _resolve_chunk(chunk, len(emissions)))
    return post._replace(smoothed_means=sm, smoothed_covariances=sP)


def _marginal_loglik(params, emissions, predicted_means, predicted_covs):
    """Innovation-form marginal log-likelihood; ``predicted_*[t]`` predicts
    step t+1 (length T−1), the t=0 term uses the prior."""
    from bayesianfiltering_tpu_torch.distributions import mvn_logpdf

    H, R = params.emission_matrix, params.emission_covariance
    _, d = _biases(params)
    pm_prev = torch.cat([params.initial_mean[None], predicted_means])
    pP_prev = torch.cat([params.initial_covariance[None], predicted_covs])
    yhat = pm_prev @ H.T + d
    S = symmetrize(H @ pP_prev @ H.T + R)
    return mvn_logpdf(emissions, yhat, S).sum()


# ---------------------------------------------------------------------------
# Time-varying (per-step affine) variants: each iteration of the parallel
# iterated smoothers linearises the model into x_t = F_t x_{t-1} + c_t + q_t,
# y_t = H_t x_t + d_t + r_t and runs these.
# ---------------------------------------------------------------------------


def parallel_kalman_filter_tv(m0, P0, Fs, cs, Qs, Hs, ds, Rs, emissions,
                              solver: str = "woodbury",
                              chunk="auto") -> PosteriorKalman:
    """Temporally parallel Kalman filter for a time-varying affine LGSSM.

    The stacks run along axis 0 over T steps. ``Fs[t]``, ``cs[t]``,
    ``Qs[t]`` is the transition into step t (``Fs[0]`` is unused: step 0
    conditions the prior); ``Hs[t]``, ``ds[t]``, ``Rs[t]`` the emission
    model at t. ``predicted_*[t]`` predicts step t+1 from 0..t, the last
    step reusing ``Fs[T-1]``. ``solver`` and ``chunk`` as in
    :func:`parallel_kalman_filter`.
    """
    first = _first_element_tv(m0, P0, Hs[0], ds[0], Rs[0], emissions[0])
    rest = _generic_elements_tv(Fs[1:], cs[1:], Qs[1:], Hs[1:], ds[1:],
                                Rs[1:], emissions[1:])
    elems = tuple(torch.cat([f[None], r]) for f, r in zip(first, rest))
    _, fm, fP, _, _ = _run_filter_scan(
        elems, solver, _resolve_chunk(chunk, len(emissions)))

    # the transition out of each step, F_{t+1}; the last reuses F_{T-1}
    Fn, cn, Qn = (torch.cat([x[1:], x[-1:]]) for x in (Fs, cs, Qs))
    pm = _mv(Fn, fm) + cn
    pP = symmetrize(Fn @ fP @ Fn.mT + Qn)
    ll = _marginal_loglik_tv(m0, P0, Fs, cs, Qs, Hs, ds, Rs, emissions,
                             fm, fP)
    return PosteriorKalman(ll, fm, fP, pm, pP)


def parallel_kalman_smoother_tv(m0, P0, Fs, cs, Qs, Hs, ds, Rs, emissions,
                                solver: str = "woodbury",
                                chunk="auto") -> PosteriorKalman:
    """Temporally parallel RTS smoother for a time-varying affine LGSSM
    (the stack conventions of :func:`parallel_kalman_filter_tv`). The
    smoothing elements take the per-step transitions ``Fs[1:]`` as a bank:
    one K11 launch on CUDA tensors."""
    post = parallel_kalman_filter_tv(m0, P0, Fs, cs, Qs, Hs, ds, Rs,
                                     emissions, solver, chunk)
    fm, fP = post.filtered_means, post.filtered_covariances
    pm, pP = post.predicted_means, post.predicted_covariances

    # G_t = P^f_t F_{t+1}ᵀ (P^p_{t+1|t})⁻¹ with the transition out of t
    G, g, L = _smoother_elements(fm[:-1], fP[:-1], pm[:-1], pP[:-1],
                                 Fs[1:])
    elems = (torch.cat([G, torch.zeros_like(fP[:1])]),
             torch.cat([g, fm[-1:]]),
             torch.cat([L, fP[-1:]]))
    _, sm, sP = _run_smoother_scan(elems,
                                   _resolve_chunk(chunk, len(emissions)))
    return post._replace(smoothed_means=sm, smoothed_covariances=sP)


def _marginal_loglik_tv(m0, P0, Fs, cs, Qs, Hs, ds, Rs, emissions,
                        filtered_means, filtered_covs):
    """Innovation-form marginal log-likelihood of the time-varying model:
    the prior of step t is the prediction through ``Fs[t]`` from the
    filtered moments of t−1 (the initial moments at t=0)."""
    from bayesianfiltering_tpu_torch.distributions import mvn_logpdf

    pm_prev = torch.cat([m0[None],
                         _mv(Fs[1:], filtered_means[:-1]) + cs[1:]])
    pP_prev = torch.cat([
        P0[None],
        symmetrize(Fs[1:] @ filtered_covs[:-1] @ Fs[1:].mT + Qs[1:])])
    yhat = _mv(Hs, pm_prev) + ds
    S = symmetrize(Hs @ pP_prev @ Hs.mT + Rs)
    return mvn_logpdf(emissions, yhat, S).sum()


__all__ = [
    "chunked_associative_scan",
    "parallel_kalman_filter",
    "parallel_kalman_smoother",
    "parallel_kalman_filter_tv",
    "parallel_kalman_smoother_tv",
]
