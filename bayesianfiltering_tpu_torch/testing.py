"""Seeded inputs for checking the kernels against their plain twins.

Inputs are made with a numpy ``Generator`` so that the JAX package and the
port can be fed the very same arrays; :func:`to_torch` moves them over.
:class:`TiledFactor` writes out, in numpy, the one-launch blocked
Cholesky of ``csrc/tiled_chol.cuh`` that K1t, K8t (:func:`augmented_factor`),
K6t (:func:`square_factor`) and K7t (:func:`square_factor_pair`: P and C
side by side, :func:`run_factors`) share, phase by phase on scratch seeded
with NaN, :func:`run_gemms` the multi-block products of ``csrc/tiled.cuh``
(one product, or two in a grouped launch) block by block on flat buffers addressed as the kernel
addresses them, :func:`tiled_ut_predict` K9t's two launches, and
:func:`tile_mm` and
:func:`tile_mm_lower` (with
their epilogues :func:`put`, :func:`put_t` and :func:`put_mirrored`),
:func:`panel_cholesky` and
:func:`tri_solve` the in-block product, panel factor and panel triangular
solve of ``csrc/block_mm.cuh`` and ``csrc/common.cuh`` that K1, K2, K8,
K9, K10b and K12b are built on, for tests that follow their schedules
step by step on workspaces seeded with NaN. :class:`Group` writes out the
lane groups of ``csrc/lane_group.cuh`` that K3, K4, K10, K11 and K12 are
built on, with their board seeded with NaN.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def to_torch(x, dtype=None, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def spd(rng: np.random.Generator, batch, n: int, scale: float = 1.0):
    """A batch of well-conditioned SPD matrices, shape (*batch, n, n)."""
    batch = tuple(np.atleast_1d(batch)) if np.ndim(batch) else (int(batch),)
    a = rng.standard_normal(batch + (n, n))
    return scale * (a @ np.swapaxes(a, -1, -2) / n + np.eye(n))


def update_inputs(rng: np.random.Generator, B: int, dx: int, dy: int):
    """``(m, P, Hx, Rt, innov)`` for a batched measurement update."""
    return (rng.standard_normal((B, dx)), spd(rng, B, dx),
            rng.standard_normal((B, dy, dx)) / np.sqrt(dx),
            spd(rng, B, dy, 0.5), rng.standard_normal((B, dy)))


def predict_inputs(rng: np.random.Generator, B: int, dx: int, dq: int):
    """``(Fx, P, Fq, Q)`` for a batched covariance predict, Q shared."""
    return (np.eye(dx) + 0.1 * rng.standard_normal((B, dx, dx)),
            spd(rng, B, dx), rng.standard_normal((B, dx, dq)) / np.sqrt(dq),
            spd(rng, 1, dq)[0])


def sigma_inputs(rng: np.random.Generator, B: int, n: int):
    """``(m, P)`` for the sigma-point kernel."""
    return rng.standard_normal((B, n)), spd(rng, B, n)


def sigma_aug_inputs(rng: np.random.Generator, B: int, dx: int, dn: int):
    """``(m, P, bias, C)`` for the augmented sigma points, bias and C
    shared."""
    return (rng.standard_normal((B, dx)), spd(rng, B, dx),
            0.1 * rng.standard_normal(dn), spd(rng, 1, dn, 0.5)[0])


def ut_update_inputs(rng: np.random.Generator, B: int, rows: int, ld: int,
                     dx: int, dy: int):
    """``(pts, hpts, center_y, mu_y, m, P, R, innov)`` for the UT update:
    ``rows`` sigma points of width ``ld`` ≥ dx (state first), images that
    depend on the state part, R shared."""
    pts = rng.standard_normal((B, rows, ld))
    G = rng.standard_normal((dx, dy)) / np.sqrt(dx)
    hpts = pts[..., :dx] @ G + 0.3 * rng.standard_normal((B, rows, dy))
    return (pts, hpts, rng.standard_normal((B, dy)), hpts.mean(axis=-2),
            rng.standard_normal((B, dx)), spd(rng, B, dx),
            spd(rng, 1, dy, 0.5)[0], rng.standard_normal((B, dy)))


def ut_predict_inputs(rng: np.random.Generator, B: int, rows: int, dx: int):
    """``(fpts, center, Q)`` for the UT predict moments, Q shared."""
    return (rng.standard_normal((B, rows, dx)), rng.standard_normal((B, dx)),
            spd(rng, 1, dx)[0])


# ---------------------------------------------------------------------------
# csrc/tiled_chol.cuh's one-launch factor, phase by phase
# ---------------------------------------------------------------------------

NB = 32  # tiled_chol.cuh kNb: the tile and panel width
FACTOR_THREADS = 256  # tiled_chol.cuh kThreads


def tiles_of(n: int) -> int:
    return -(-n // NB)


def aug_layout(dx: int, dy: int, height=None) -> dict:
    """``AugLayout`` of csrc/tiled_chol.cuh: the element's W (height × dy,
    height 2dy + dx + 1 unless given), its factor L, the diagonal tiles'
    L⁻ᵀ, the floor and the flag, as offsets in elements."""
    height = 2 * dy + dx + 1 if height is None else height
    w = 0
    l_ = w + height * dy
    li = l_ + height * dy
    misc = li + tiles_of(dy) * NB * NB
    return {"height": height, "w": w, "l": l_, "li": li, "misc": misc,
            "end": misc + 4}


def last_from(dy: int, height: int) -> int:
    """The last phase's first tile row (``AugLayout::last_from``)."""
    return tiles_of(dy) - (1 if dy % NB and height > dy else 0)


def step_tasks(k: int, dy: int, height: int) -> int:
    """``step_tasks``: step k's trailing tiles (I, J), k < J ≤ I, of one
    element (none once its chain has ended)."""
    ntc, ntr = tiles_of(dy), tiles_of(height)
    return sum(ntr - J for J in range(k + 1, ntc))


def factor_tasks(dy: int, height: int, B: int, second=None) -> int:
    """``factor_tasks``: the most tasks of any phase — the first, a step,
    the last — of B elements, and, side by side where ``second`` = (dn,
    B2), of B2 of a square problem of size dn (K7t's C)."""
    dn, B2 = second if second else (0, 0)
    phases = [B + B2, B * (tiles_of(height) - last_from(dy, height))]
    for k in range(max(tiles_of(dy), tiles_of(dn) if B2 else 0) - 1):
        phases.append(B * step_tasks(k, dy, height)
                      + B2 * step_tasks(k, dn, dn))
    return max(max(phases), 1)


def factor_barriers(dy: int, height: int, epilogue: bool) -> int:
    """The grid barriers of one launch: after the first phase, after each
    step, and before an epilogue that follows a last phase."""
    last = tiles_of(height) > last_from(dy, height)
    return 1 + (tiles_of(dy) - 1) + (1 if last and epilogue else 0)


H100_L2_BYTES = 50 * 2 ** 20


def factor_launch(dy: int, height: int, B: int, itemsize: int,
                  epilogue: str = "points", sms: int = 132,
                  identity: bool = True, dn: int = 0) -> dict:
    """How ``launch_factor`` runs the factor of a W of ``height`` × dy rows
    over a batch of B (and, where dn > 0, K7t's square C of size dn side
    by side): one cooperative launch (the route: a persistent grid, the
    working W in L2 between the steps) on min(SMs, tasks) blocks, the
    tasks being the most of any phase, the epilogue's included
    (``"points"``: K6t's tiles of the 2n × n points, K7t's of the
    2(n + dn) × (n + dn) points; ``"gain"``: a warp a row of μ and one for
    ll, eight warps a block, over the dx rows of X that W = [S; X; vᵀ; I]
    holds, or [S; X; vᵀ] where not ``identity``), and ``factor_barriers``
    grid barriers of the longer chain; whether the problems' W and L fit
    the H100's 50 MB L2 at ``itemsize`` bytes an entry."""
    dx = height - dy - 1 - (dy if identity else 0)
    epi = {"points": B * tiles_of(dy + dn) ** 2,
           "gain": -(-B * (dx + 1) // 8)}[epilogue]
    lay = aug_layout(dx, dy, height)
    longer = (dy, height) if dy >= dn else (dn, dn)
    return {"route": "grid", "launches": 1,
            "blocks": min(sms, max(factor_tasks(dy, height, B,
                                                (dn, 1) if dn else None),
                                   epi)),
            "barriers": factor_barriers(*longer, True),
            "in_l2": (B * (lay["li"] - lay["w"]) + 2 * dn * dn) * itemsize
            <= H100_L2_BYTES}


# The per-element (K1t, K8t) or per-launch (K6t, K7t) scratch that the C
# entry points ask for, in elements: bft_ekf_update_tiled_scratch_elems,
# bft_ut_update_tiled_scratch_elems, bft_ut_sigma_tiled_scratch_elems and
# bft_ut_sigma_aug_tiled_scratch_elems.
def k1t_scratch(dx: int, dy: int) -> int:
    end = aug_layout(dx, dy)["end"]  # then sym(Rt), A, K Rs, A P
    return end + dy * dy + 2 * dx * dx + dx * dy


def k8t_layout(rows: int, dx: int, dy: int) -> dict:
    """``UtUpdateScratch``: the factor's layout of W = [S; Cᵀ; vᵀ] (no I
    rows), then V = [Yc | Xc] (rows × (dy + dx)) and [d0; 0] (dy + dx)."""
    lay = aug_layout(dx, dy, dy + dx + 1)
    lay["v"] = lay["end"]
    lay["d0"] = lay["v"] + rows * (dy + dx)
    lay["total"] = lay["d0"] + dy + dx
    return lay


def k8t_scratch(rows: int, dx: int, dy: int) -> int:
    return k8t_layout(rows, dx, dy)["total"]


def k2t_scratch(dx: int, dq: int) -> int:
    """K2t's per-element scratch (``predict_scratch``): F_x P, F_q Q."""
    return dx * dx + dx * dq


def k6t_scratch(B: int, n: int, method: str) -> int:
    if method == "sqrtm":  # Y, Z, T and a spare, the traces after the batch
        return B * 4 * n * n + B
    return B * aug_layout(0, n, n)["end"]


def k7t_scratch(B: int, dx: int, dn: int, method: str) -> int:
    """P's part (as K6t's), then C's (one element)."""
    return k6t_scratch(B, dx, method) + k6t_scratch(1, dn, method)


def k9t_layout(rows: int, dx: int) -> dict:
    """K9t's per-element scratch: the centred points Xc (rows × dx), then
    d0 (dx)."""
    return {"xc": 0, "d0": rows * dx, "total": rows * dx + dx}


def k9t_scratch(B: int, rows: int, dx: int) -> int:
    """``predict_scratch_elems``: B elements' :func:`k9t_layout`."""
    return B * k9t_layout(rows, dx)["total"]


def block_tasks(total: int, blocks: int) -> list:
    """``for_tasks``: block g's task positions, in turns over the blocks,
    the order reversed every other round."""
    out = [[] for _ in range(blocks)]
    rnd = 0
    while rnd * blocks < total:
        for g in range(blocks):
            p = rnd * blocks + (blocks - 1 - g if rnd % 2 else g)
            if p < total:
                out[g].append(p)
        rnd += 1
    return out


def warp_cholesky_inverse(a, n: int):
    """``warp_cholesky_inverse`` on a 32 × 32 tile, lane i as row i: the
    lower ``a`` (zeros above and on rows ≥ n) → (L, L⁻ᵀ, bad), column by
    column, the identity's rows eliminated with the same l_cj; columns
    past n act as the identity's. Runs in a's dtype."""
    dt = a.dtype.type
    a = a.copy()
    e = np.eye(NB, dtype=a.dtype)
    rows = np.arange(NB)[:, None]
    bad = False
    with np.errstate(invalid="ignore", divide="ignore"):
        for j in range(NB):
            d = a[j, j] if j < n else dt(1)
            bad = bad or not d > 0 or np.isinf(d)
            r = dt(1) / np.sqrt(d)
            lij = np.where(np.arange(NB) == j, d * r,
                           np.where(np.arange(NB) > j, a[:, j] * r, dt(0)))
            a[:, j] = lij
            eij = e[:, j] * r
            e[:, j] = eij
            lc = lij[j + 1:]  # lane c's l_cj
            upd = np.outer(lij, lc).astype(a.dtype)
            cols = np.arange(j + 1, NB)[None, :]
            a[:, j + 1:] -= np.where(cols <= rows, upd, dt(0))
            e[:, j + 1:] -= np.outer(eij, lc).astype(a.dtype)
    return a, e, bad


class TiledFactor:
    """``tiled_factor_kernel`` of csrc/tiled_chol.cuh in numpy, phase by
    phase and task by task, on NaN-seeded scratch: the first phase (the
    floor, the first diagonal tile), the steps (every trailing tile (I, J),
    k < J ≤ I, with its own panel tiles; the look-ahead's diagonal tiles
    handed out first and factored by their tasks), the last phase (the rows
    under the last panel) and the gain's epilogue. Blocks take their tasks
    as ``for_tasks`` hands them out over ``blocks`` blocks; each phase's
    tasks read the state at the phase's start, and the model checks that no
    task reads a tile or an inverse another task of the same phase writes,
    and that no two write the same one, so that the blocks' order does not
    matter. With ``run=False`` the phases wait for :func:`run_factors`,
    which runs two problems side by side (K7t).

    ``first_touch(b, i, j)`` gives W's entries at their first touch for
    index arrays i, j (S's lower part with sym(R) where i < dy — the model
    adds the floor —, X, vᵀ and I below); ``s_diag(b)`` diag(S) before the
    floor, for it. The results: ``W``, ``L`` (B, height, dy), ``Li`` (B,
    tiles, 32, 32), ``floor`` and ``flag`` (B,), ``owner`` (phase → {task:
    block})."""

    def __init__(self, first_touch, B: int, dy: int, height: int, dtype,
                 blocks: int = 132, s_diag=None, jitter: float = 0.0,
                 run: bool = True):
        self.src, self.B, self.dy, self.height = first_touch, B, dy, height
        self.dt = np.dtype(dtype).type
        self.ntc, self.ntr = tiles_of(dy), tiles_of(height)
        nan = np.nan
        self.W = np.full((B, height, dy), nan, dtype)
        self.L = np.full((B, height, dy), nan, dtype)
        self.Li = np.full((B, self.ntc, NB, NB), nan, dtype)
        self.floor = np.full(B, nan, dtype)
        self.flag = np.full(B, nan, dtype)
        self.owner = []
        self._floor = s_diag is not None
        for b in range(B if self._floor else 0):
            d = np.asarray(s_diag(b), self.W.dtype)
            self.floor[b] = self.dt(jitter) + self.dt(1e-6) * np.abs(d).max()
        if run:
            run_factors([self], blocks)

    # -- tiles --------------------------------------------------------------
    def _idx(self, I, J):
        i = I * NB + np.arange(NB)[:, None]
        j = J * NB + np.arange(NB)[None, :]
        return i, j, (i < self.height) & (j < self.dy)

    def _entries(self, W, b, I, J, first, lower, reads):
        """W's tile (I, J) as load_tile reads it (zeros outside, and above
        the diagonal where lower)."""
        i, j, inside = self._idx(I, J)
        if lower:
            inside = inside & (j <= i)
        out = np.zeros((NB, NB), W.dtype)
        ii, jj = np.broadcast_to(i, inside.shape)[inside], \
            np.broadcast_to(j, inside.shape)[inside]
        if first:
            v = np.asarray(self.src(b, ii, jj), W.dtype).copy()
            on_diag = (ii == jj) & (ii < self.dy)
            if self._floor and on_diag.any():
                reads.add(("floor", b))
                v[on_diag] += self.floor[b]
            out[inside] = v
        else:
            reads.add(("W", b, I, J))
            out[inside] = W[b][ii, jj]
        return out

    def _factor_diag(self, b, K, C, first, writes):
        n = min(NB, self.dy - K * NB)
        lower = np.tril(C)
        lower[n:] = 0
        lower[:, n:] = 0
        x, e, bad = warp_cholesky_inverse(lower.astype(self.W.dtype), n)
        if bad:
            x = np.full_like(x, np.nan)
            e = np.full_like(e, np.nan)
        r0 = K * NB
        self.L[b, r0:r0 + n, r0:r0 + n] = np.where(np.tri(n, dtype=bool),
                                                   x[:n, :n], 0)
        self.Li[b, K] = e
        self.flag[b] = 1 if bad or (not first and self.flag[b] != 0) else 0
        writes |= {("Ldiag", b, K), ("Li", b, K), ("flag", b)}

    def _store_l(self, b, I, J, v, writes, row_lo=0, tag="L"):
        i, j, inside = self._idx(I, J)
        inside = inside & (i >= row_lo)
        ii = np.broadcast_to(i, inside.shape)[inside]
        jj = np.broadcast_to(j, inside.shape)[inside]
        self.L[b][ii, jj] = v[inside]
        writes.add((tag, b, I, J))

    # -- phases -------------------------------------------------------------
    def phase(self, kind: str, k: int = 0):
        """One phase's tasks as (diagonal, rest): lists of (fn, task),
        ``fn(W0, task, reads, writes)``. ``"first"``: every element's first
        diagonal tile; ``"step"`` k: the look-ahead's diagonal tiles, then
        the other trailing tiles element by element, column by column (none
        once the chain has ended); ``"last"``: the rows under the last
        panel."""
        if kind == "first":
            return [(self._first_task, b) for b in range(self.B)], []
        if kind == "last":
            frm = last_from(self.dy, self.height)
            return [], [(self._last_task, (b, I)) for b in range(self.B)
                        for I in range(frm, self.ntr)]
        if k + 1 >= self.ntc:
            return [], []
        fn = functools.partial(self._step_task, k)
        diag = [(fn, (b, k + 1, k + 1)) for b in range(self.B)]
        rest = [(fn, (b, I, J)) for b in range(self.B)
                for J in range(k + 1, self.ntc) for I in range(J, self.ntr)
                if (I, J) != (k + 1, k + 1)]
        return diag, rest

    def _first_task(self, W0, b, reads, writes):
        C = self._entries(W0, b, 0, 0, True, True, reads)
        self._factor_diag(b, 0, C, True, writes)

    def _step_task(self, k, W0, t, reads, writes):
        first = k == 0
        b, I, J = t
        same = I == J
        Ta = self._entries(W0, b, I, k, first, False, reads)
        Tb = Ta if same else self._entries(W0, b, J, k, first, False, reads)
        reads.add(("Li", b, k))
        li = self.Li[b, k]
        pi = Ta @ li
        pj = pi if same else Tb @ li
        C = self._entries(W0, b, I, J, first, same, reads)
        C = C - pi @ pj.T
        i, j, inside = self._idx(I, J)
        if same:
            inside = inside & (j <= i)
        ii = np.broadcast_to(i, inside.shape)[inside]
        jj = np.broadcast_to(j, inside.shape)[inside]
        self.W[b][ii, jj] = C[inside]
        writes.add(("W", b, I, J))
        if J == k + 1:
            self._store_l(b, I, k, pi, writes)
        if same and I == k + 1:
            self._factor_diag(b, k + 1, C, False, writes)

    def _last_task(self, W0, t, reads, writes):
        b, I = t
        last = self.ntc - 1
        Ta = self._entries(W0, b, I, last, last == 0, False, reads)
        reads.add(("Li", b, last))
        self._store_l(b, I, last, Ta @ self.Li[b, last], writes,
                      row_lo=self.dy, tag="Lunder")

    # -- the gain's epilogue --------------------------------------------------
    def gain(self, dx: int, m):
        """ll = log N(v | 0, S) and μ = m + Zᵀ z of each element, from its
        factor: ``GainEpilogue``."""
        dy = self.dy
        Zt = self.L[:, dy:dy + dx]
        z = self.L[:, dy + dx]
        diag = np.diagonal(self.L[:, :dy], axis1=1, axis2=2)
        with np.errstate(invalid="ignore", divide="ignore"):
            ll = self.dt(-0.5) * (self.dt(dy * np.log(2 * np.pi))
                                  + self.dt(2) * np.log(diag).sum(-1)
                                  + (z * z).sum(-1))
        mean = m + np.einsum("bic,bc->bi", Zt, z)
        return ll, mean


def run_factors(factors, blocks: int = 132) -> list:
    """One launch of ``tiled_factor_kernel`` over one problem or two side
    by side (K7t's P and C; the second square, with no last phase): phase
    by phase, each phase's tasks ordered as the kernel hands them out —
    both problems' diagonal tasks, then both problems' other tasks — and
    given to the blocks by ``for_tasks`` (:func:`block_tasks`). Every task
    reads the state of its phase's start; the hazard checks span both
    problems. Returns (and stores as each factor's ``owner``) the blocks
    of every phase's tasks, phases without tasks left out."""
    assert len(factors) <= 2 and all(
        not f.phase("last")[1] for f in factors[1:])
    steps = max(f.ntc for f in factors) - 1
    kinds = [("first", 0)] + [("step", k) for k in range(steps)] \
        + [("last", 0)]
    owner_all = []
    for kind, k in kinds:
        parts = [f.phase(kind, k) for f in factors]
        tasks = [(x, fn, t) for x, (d, _) in enumerate(parts) for fn, t in d]
        tasks += [(x, fn, t) for x, (_, r) in enumerate(parts) for fn, t in r]
        if not tasks:
            continue
        W0 = [f.W.copy() for f in factors]
        owner, reads, writes = {}, [], []
        for g, mine in enumerate(block_tasks(len(tasks), blocks)):
            for p in mine:
                owner[p] = g
                x, fn, t = tasks[p]
                r, w = set(), set()
                fn(W0[x], t, r, w)
                reads.append({(x, key) for key in r})
                writes.append({(x, key) for key in w})
        writer = {}
        for n, w in enumerate(writes):
            for key in w:
                assert key not in writer, f"two tasks write {key}"
                writer[key] = n
        for n, r in enumerate(reads):
            for key in r:
                assert writer.get(key, n) == n, f"a task reads {key}, " \
                    "which another task of its phase writes"
        owner_all.append(owner)
    for f in factors:
        f.owner = owner_all
    return owner_all


def augmented_factor(S, X, inn, R=None, jitter: float = 0.0, blocks=132,
                     identity: bool = True):
    """K1t's factor of W = [S; X; vᵀ; I], or K8t's of W = [S; X; vᵀ]
    (height dy + dx + 1) where not ``identity``, for a batch, as the
    launch computes it (:class:`TiledFactor`): ``S`` (B, dy, dy) holds G in
    its lower part (the rest is never read), ``X`` (B, dx, dy), ``inn``
    (B, dy), ``R`` (B, dy, dy), (dy, dy) shared, or None; S = G + sym(R) +
    (jitter + 1e-6·max|diag(G + R)|)·I as the first touch assembles it.
    Returns the TiledFactor (the strict upper part of L's top square is
    never written: NaN)."""
    B, dx, dy = X.shape
    Rb = None if R is None else np.broadcast_to(R, (B, dy, dy))

    def first_touch(b, i, j):
        out = np.empty(i.shape, X.dtype)
        s_rows = i < dy
        ii, jj = i[s_rows], j[s_rows]
        v = S[b][ii, jj]
        if Rb is not None:
            v = v + X.dtype.type(0.5) * (Rb[b][ii, jj] + Rb[b][jj, ii])
        out[s_rows] = v
        x_rows = (i >= dy) & (i < dy + dx)
        out[x_rows] = X[b][i[x_rows] - dy, j[x_rows]]
        v_row = i == dy + dx
        out[v_row] = inn[b][j[v_row]]
        e_rows = i > dy + dx
        out[e_rows] = (i[e_rows] - dy - dx - 1 == j[e_rows])
        return out

    def s_diag(b):
        d = np.diagonal(S[b]).copy()
        if Rb is not None:
            d = d + np.diagonal(Rb[b])
        return d

    height = dy + dx + 1 + (dy if identity else 0)
    return TiledFactor(first_touch, B, dy, height, X.dtype, blocks, s_diag,
                       jitter)


def square_factor(P, blocks=132, run=True):
    """K6t's factor of P (B, n, n): :class:`TiledFactor` on a W of height n
    whose first touch reads lower(P) (no floor)."""
    B, n, _ = P.shape
    return TiledFactor(lambda b, i, j: P[b][i, j], B, n, n, P.dtype, blocks,
                       run=run)


def square_factor_pair(P, C, blocks=132):
    """K7t's one launch: the factors of P (B, n, n) and of the shared C
    (dn, dn) side by side (:func:`run_factors`). Returns both
    :class:`TiledFactor` s (C's of one element)."""
    fp = square_factor(P, run=False)
    fc = square_factor(C[None], run=False)
    run_factors([fp, fc], blocks)
    return fp, fc


# ---------------------------------------------------------------------------
# csrc/tiled.cuh's products, block by block
# ---------------------------------------------------------------------------

GEMM_BK = 16        # kGemmBK: the k-slab, and a k-split share's granule
GEMM_MAX_SPLIT = 4  # kMaxSplit
FULL, LOWER, LOWER_MIRROR = 0, 1, 2  # Tri


@dataclasses.dataclass
class Mat:
    """``Mat<T>``: element (r, c) of op(X) for batch element b is
    buf[off + b·batch + r·ld + c], or buf[off + b·batch + c·ld + r] when
    ``trans``; ``buf`` is a flat array (a scratch, an input)."""

    buf: np.ndarray
    off: int
    ld: int
    batch: int
    trans: bool = False

    def block(self, b: int, rows: range, cols: range) -> np.ndarray:
        r = np.asarray(rows)[:, None]
        c = np.asarray(cols)[None, :]
        at = (c * self.ld + r) if self.trans else (r * self.ld + c)
        return self.buf[self.off + b * self.batch + at]


@dataclasses.dataclass
class Gemm:
    """``Gemm<T>`` (``gemm_of`` and the fields set after it): C = Σ_t
    α_t·op(A_t)·op(B_t) + β·Cin (β·½(Cin + Cinᵀ) where ``sym_cin``) + δ·I,
    M × N, into ``C`` (a flat buffer at ``c_off``, leading dimension
    ``ldc``, batch stride ``bc``); ``K[1] = 0`` for a single product."""

    M: int
    N: int
    batch: int
    K: tuple
    A: tuple
    B: tuple
    alpha: tuple
    C: np.ndarray
    c_off: int
    ldc: int
    bc: int
    Cin: Mat = None
    beta: float = 0.0
    sym_cin: bool = False
    diag: float = 0.0
    tri: int = FULL


def live_tiles(g: Gemm, BM: int, BN: int) -> int:
    """``live_tiles``: the BM × BN output tiles a product computes (the
    lower modes skip those above the diagonal), over the batch."""
    mt, nt = -(-g.M // BM), -(-g.N // BN)
    tiles = sum(min(nt, (i * BM + BM - 1) // BN + 1) if g.tri != FULL
                else nt for i in range(mt))
    return tiles * g.batch


def gemm_split(tiles: int, K: int, sms: int) -> int:
    """``gemm_split``: the k-split of a launch whose 64 × 32 tiles number
    ``tiles``."""
    split = (GEMM_MAX_SPLIT if tiles * GEMM_MAX_SPLIT <= sms
             else 2 if tiles <= sms else 1)
    while split > 1 and K < 2 * split * 2 * GEMM_BK:
        split //= 2
    return split


def pair_split(ta: int, tb: int, K: int, sms: int) -> int:
    """``gemm2``'s k-split of two products whose 64 × 32 tiles number ta
    and tb: ``gemm_split`` of both, or 2 where the pair's tiles just pass
    the SMs but the larger product's alone do not."""
    split = gemm_split(ta + tb, K, sms)
    if (split == 1 and max(ta, tb) <= sms and 4 * (ta + tb) <= 5 * sms
            and K >= 8 * GEMM_BK):
        split = 2
    return split


def gemm_plan(gs, sms: int = 132):
    """``gemm`` / ``launch_gemm`` for one product, ``gemm2`` / ``launch_gemm_pair`` for two (each with its
    own batch): (BM, BN, threads, split, blocks), ``blocks`` listing each
    block of a batch element as (product, i0, j0, rank) in launch order:
    one product's grid is (row tiles × split, column tiles), blockIdx.x
    the faster; a pair's is flat, each product's tiles row-major, ``split``
    blocks a tile, product 1 from ``first1`` on."""
    assert 1 <= len(gs) <= 2
    if sum(live_tiles(g, 64, 64) for g in gs) >= sms:
        BM, BN, nt, split = 64, 64, 256, 1
    else:
        K = max(max(g.K) for g in gs)
        BM, BN, nt = 64, 32, 128
        tiles = [live_tiles(g, 64, 32) for g in gs]
        split = (gemm_split(tiles[0], K, sms) if len(gs) == 1
                 else pair_split(*tiles, K, sms))
    blocks = []
    if len(gs) == 1:
        g = gs[0]
        for y in range(-(-g.N // BN)):
            for x in range(-(-g.M // BM) * split):
                blocks.append((0, (x // split) * BM, y * BN, x % split))
        return BM, BN, nt, split, blocks
    for p, g in enumerate(gs):
        ntc = -(-g.N // BN)
        for x in range(-(-g.M // BM) * ntc * split):
            tile = x // split
            blocks.append((p, (tile // ntc) * BM, (tile % ntc) * BN,
                           x % split))
    return BM, BN, nt, split, blocks


def run_gemms(gs, sms: int = 132) -> dict:
    """One launch of ``tiled_gemm_kernel`` over the products ``gs`` (one,
    or two grouped, each over its own batch), block by block as :func:`gemm_plan` lays them out:
    each block reads only its tile's rows of op(A_t) and columns of op(B_t)
    over its rank's share of every inner dimension (whole slabs); a
    cluster's rank 0 adds the other ranks' partial tiles in rank order and
    stores the epilogue (skipping the tiles above the diagonal in the lower
    modes, writing i ≥ j there and mirroring in ``LOWER_MIRROR``). Checks
    that no two blocks store the same entry. Returns the plan's fields."""
    BM, BN, nt, split, blocks = gemm_plan(gs, sms)
    stored = {}
    for b in range(max(g.batch for g in gs)):
        partial = {}
        for p, i0, j0, s in blocks:
            g = gs[p]
            if b >= g.batch or (g.tri != FULL and i0 + BM - 1 < j0):
                continue
            rows = range(i0, min(i0 + BM, g.M))
            cols = range(j0, min(j0 + BN, g.N))
            acc = np.zeros((len(rows), len(cols)), g.C.dtype)
            for t in range(2):
                if g.K[t] <= 0:
                    continue
                per = -(-g.K[t] // (split * GEMM_BK)) * GEMM_BK
                ks = range(s * per, min(g.K[t], s * per + per))
                if len(ks):
                    part = g.A[t].block(b, rows, ks) @ g.B[t].block(b, ks,
                                                                   cols)
                    acc += g.C.dtype.type(g.alpha[t]) * part
            partial[(p, i0, j0, s)] = acc
            if s != split - 1:
                continue
            acc = sum(partial.pop((p, i0, j0, r)) for r in range(split))
            r_ = np.asarray(rows)[:, None]
            c_ = np.asarray(cols)[None, :]
            v = acc.copy()
            if g.Cin is not None:
                beta = g.C.dtype.type(g.beta)
                cin = g.Cin.block(b, rows, cols)
                if g.sym_cin:
                    cin = g.C.dtype.type(0.5) * (
                        cin + g.Cin.block(b, cols, rows).T)
                v = v + beta * cin
            v = v + np.where(r_ == c_, g.C.dtype.type(g.diag), 0)
            keep = np.ones(v.shape, bool) if g.tri == FULL else c_ <= r_
            keep = np.broadcast_to(keep, v.shape)
            rr = np.broadcast_to(r_, v.shape)[keep]
            cc = np.broadcast_to(c_, v.shape)[keep]
            at = g.c_off + b * g.bc + rr * g.ldc + cc
            if g.tri == LOWER_MIRROR:
                off = cc < rr
                at = np.concatenate([at, g.c_off + b * g.bc
                                     + cc[off] * g.ldc + rr[off]])
                vals = np.concatenate([v[keep], v[keep][off]])
            else:
                vals = v[keep]
            count = stored.setdefault(id(g.C), np.zeros(g.C.size, np.int32))
            np.add.at(count, at, 1)
            assert (count[at] == 1).all(), "two blocks store one entry"
            g.C[at] = vals
    return {"tile": (BM, BN), "threads": nt, "split": split,
            "blocks": len(blocks)}


def k9t_mean_centre(fpts, center, w_side: float, w0m: float):
    """``ut_tiled_mean_centre_kernel`` in the inputs' dtype: each column's
    sum by row groups (G = 256 / strip columns, a strip 32 bytes wide),
    group ty summing rows ty, ty + G, … in order, the groups added in the
    kernel's fixed tree; μ = w_side·Σ + w0m·center, Xc = fpts − μ,
    d0 = center − μ. ``fpts`` (B, rows, dx), ``center`` (B, dx)."""
    B, rows, dx = fpts.shape
    dt = fpts.dtype.type
    G = FACTOR_THREADS // (32 // fpts.itemsize)
    part = np.zeros((B, G, dx), fpts.dtype)
    for r0 in range(0, rows, G):
        chunk = fpts[:, r0:r0 + G]
        part[:, :chunk.shape[1]] += chunk
    h = G // 2
    while h:
        part[:, :h] += part[:, h:2 * h]
        h //= 2
    mu = dt(w_side) * part[:, 0] + dt(w0m) * center
    return mu, fpts - mu[:, None], center - mu


def tiled_ut_predict(fpts, center, Q, w, add_q: bool, sms: int = 132):
    """K9t over a batch, launch by launch, in the inputs' dtype: the mean
    and centring pass (:func:`k9t_mean_centre`) into the scratch
    (:func:`k9t_layout`, seeded with NaN), then Σ = lower(w_side·Xcᵀ Xc +
    w0c·d0 d0ᵀ) + sym(Q), mirrored, as ``gemm`` runs it block by block
    (:func:`run_gemms`: at config 5 its row shares over a cluster).
    Returns (μ, Σ, the product's plan)."""
    w_side, w0m, w0c = w
    B, rows, dx = fpts.shape
    lay = k9t_layout(rows, dx)
    st = lay["total"]
    ws = np.full(B * st, np.nan, fpts.dtype)
    mu, xc, d0 = k9t_mean_centre(fpts, center, w_side, w0m)
    for b in range(B):
        ws[b * st:b * st + lay["d0"]] = xc[b].ravel()
        ws[b * st + lay["d0"]:(b + 1) * st] = d0[b]
    cov = np.full(B * dx * dx, np.nan, fpts.dtype)
    cin = Mat(np.ascontiguousarray(Q).ravel(), 0, dx, 0) if add_q else None
    plan = run_gemms([Gemm(
        dx, dx, B, (rows, 1),
        (Mat(ws, lay["xc"], dx, st, True), Mat(ws, lay["d0"], 1, st)),
        (Mat(ws, lay["xc"], dx, st), Mat(ws, lay["d0"], dx, st)),
        (w_side, w0c), cov, 0, dx, dx * dx, Cin=cin,
        beta=1.0 if add_q else 0.0, sym_cin=True, tri=LOWER_MIRROR)], sms)
    return mu, cov.reshape(B, dx, dx), plan


# ---------------------------------------------------------------------------
# csrc/block_mm.cuh and common.cuh's panel factor, step by step
# ---------------------------------------------------------------------------

PANEL = 32  # the panel width of the factor and the solve (kWarp)


def tiling(nt: int):
    """(TM, TN) of a 64 × 64 super-tile over ``nt`` threads laid out
    16 × nt/16 (``Tiling<nt>`` of csrc/bank_combine.cu; K8 and K9 run
    nt = 256: 4 × 4)."""
    return 4, 64 // (nt // 16)


@functools.lru_cache(maxsize=None)
def tile_stored(M: int, N: int, a_ext: int, b_ext: int, shape, nt: int = 256,
                row_lo: int = 0, lower: bool = False):
    """The outputs of ``tile_mm`` that reach a store, as a mask of
    ``shape``: every thread (ty, tx) of every super-tile meeting [0, M) ×
    [0, N) that its skip rules keep, masked to i < M, j < N, i ≥ row_lo.
    Checks that each thread's operand spans (TM entries of A's extent
    ``a_ext``, TN of B's row ``b_ext``) lie inside the operands. Cached:
    the mask is shared, read it only."""
    TM, TN = tiling(nt)
    CX = nt // 16
    mask = np.zeros(shape, bool)
    for ib in range(0, M, 16 * TM):
        for jb in range(0, N, CX * TN):
            for ty in range(16):
                for tx in range(CX):
                    i0, j0 = ib + ty * TM, jb + tx * TN
                    if (i0 >= M or j0 >= N or i0 + TM <= row_lo
                            or (lower and i0 + TM <= j0)):
                        continue
                    assert i0 + TM <= a_ext and j0 + TN <= b_ext
                    mask[max(i0, row_lo):min(i0 + TM, M),
                         j0:min(j0 + TN, N)] = True
    mask.flags.writeable = False
    return mask


def tile_mm(A, B, M: int, N: int, K: int, at: bool, nt: int = 256,
            a_row: int = 0, b_row: int = 0, row_lo: int = 0,
            lower: bool = False):
    """(C, stored mask) of ``tile_mm`` over M × N outputs: A(i, k) =
    A[a_row + k][i] (``at``, the A-transposed layout) or A[i][k], B(k, j)
    = B[b_row + k][j], summed over k < K. C spans A's whole extent by B's
    whole row (entries past M or N read whatever the workspace holds);
    only the masked entries are stored."""
    if at:
        assert a_row + K <= A.shape[0]
        a = A[a_row:a_row + K, :].T
    else:
        assert K <= A.shape[1]
        a = A[:, :K]
    assert b_row + K <= B.shape[0]
    C = a @ B[b_row:b_row + K, :]
    return C, tile_stored(M, N, a.shape[0], B.shape[1], C.shape, nt, row_lo,
                          lower)


@functools.lru_cache(maxsize=None)
def lower_stored(n: int, a_ext: int, b_ext: int, shape, tm: int = 4):
    """The outputs of ``tile_mm_lower`` that reach a store, as a mask of
    ``shape``: the tm × tm tiles (ti, tj), tj ≤ ti, of [0, n)², numbered
    row by row (one a thread), masked to i, j < n. Checks that each
    tile's operand spans lie inside the operands. Cached: read it only."""
    mask = np.zeros(shape, bool)
    nt = -(-n // tm)
    for t in range(nt * (nt + 1) // 2):
        ti = int((np.sqrt(8 * t + 1) - 1) / 2)
        ti -= ti * (ti + 1) // 2 > t
        ti += (ti + 1) * (ti + 2) // 2 <= t
        i0, j0 = ti * tm, (t - ti * (ti + 1) // 2) * tm
        assert j0 <= i0 and i0 + tm <= a_ext and j0 + tm <= b_ext
        mask[i0:min(i0 + tm, n), j0:min(j0 + tm, n)] = True
    mask.flags.writeable = False
    return mask


def tile_mm_lower(A, B, n: int, K: int):
    """(C, stored mask) of ``tile_mm_lower`` over the lower tiles of an
    n × n product, A read transposed: A(i, k) = A[k][i], B(k, j) =
    B[k][j], summed over k < K."""
    assert K <= A.shape[0] and K <= B.shape[0]
    C = A[:K].T @ B[:K]
    return C, lower_stored(n, A.shape[1], B.shape[1], C.shape)


def put(X, C, mask, f=lambda c: c):
    """An epilogue: X ← f(C) at the stored entries."""
    at = np.nonzero(mask)
    X[at] = f(C)[at]


def put_t(X, C, mask):
    """``put_cols``: the stored entries transposed, X[j][i] ← C[i][j]."""
    at = np.nonzero(mask)
    X[at[1], at[0]] = C[at]


def put_mirrored(X, C, mask, tm: int = 4):
    """The epilogue of a symmetric product's lower tiles (K1's and K2's
    ``put_mirrored``): C on a tm × tm tile of the diagonal averaged with
    its transpose first, then each stored entry and its mirror
    (``put_rows`` then ``put_cols``). Checks that every entry of X's
    n × n top square is stored, and returns nothing."""
    n = X.shape[0]
    blk = np.arange(C.shape[0])[:, None] // tm == np.arange(
        C.shape[1])[None, :] // tm
    sq = min(C.shape)
    v = C.copy()
    v[:sq, :sq] = np.where(blk[:sq, :sq], 0.5 * (C[:sq, :sq] + C[:sq, :sq].T),
                           C[:sq, :sq])
    at = np.nonzero(mask)
    X[at] = v[at]
    X[at[1], at[0]] = v[at]
    sq_mask = mask[:n, :n]
    assert (sq_mask | sq_mask.T).all()


def _chol_lower_nan(a):
    """Cholesky factor of the symmetric matrix whose lower triangle ``a``
    holds (its strict upper part is never read), NaN throughout where it
    is not positive definite."""
    lo = np.tril(a)
    try:
        return np.linalg.cholesky(lo + np.tril(lo, -1).T)
    except np.linalg.LinAlgError:
        return np.full_like(a, np.nan)


def panel_cholesky(W, n: int, width: int = PANEL) -> bool:
    """``block_cholesky_panels`` in place on W, whose row c holds column c
    of the lower factor (W[j][i] = S[i][j] for i ≥ j: the column-major
    layout with leading dimension ld), in panels of ``width`` columns.
    Returns whether some pivot was not positive (the panel's diagonal
    block then factors to NaN, as a failed warp factor leaves garbage)."""
    bad = False
    for k in range(0, n, width):
        nb = min(width, n - k)
        below = k + nb
        D = np.tril(W[k:below, k:below].T)
        Lkk = _chol_lower_nan(D)
        bad |= not np.isfinite(Lkk).all()
        low = np.tril(np.ones((nb, nb), bool))
        blk = W[k:below, k:below].T.copy()
        blk[low] = Lkk[low]
        W[k:below, k:below] = blk.T
        if below >= n:
            break
        rinv = 1 / np.diag(Lkk)
        W[below, k:below] = rinv  # parked in the strict upper part
        # L[i][k:below] for i ≥ below: x · Lkkᵀ = S[i][k:below] by forward
        # substitution with the pivots' reciprocals, as the kernel's rows
        rows = W[k:below, below:n].T.copy()
        for c in range(nb):
            rows[:, c] *= rinv[c]
            rows[:, c + 1:] -= np.outer(rows[:, c], Lkk[c + 1:, c])
        W[k:below, below:n] = rows.T
        upd = rows @ rows.T
        rest = n - below
        tri = np.tril(np.ones((rest, rest), bool))  # j ≤ i
        sub = W[below:n, below:n].T.copy()  # sub[i][j] = S[i][j]
        sub[tri] -= upd[tri]
        W[below:n, below:n] = sub.T
    return bad


def tri_solve(Lc, dinv, R1, c1: int, R2, c2: int, n: int, nt: int = 256,
              width: int = PANEL):
    """``block_tri_solve``: R ← L⁻¹ R in place for both right-hand sides
    (R1 with c1 columns, R2 with c2, none when c2 = 0; numpy views of the
    workspace), L held with Lc[c][i] = L[i][c], in panels of ``width``
    rows: a column's panel rows in registers (``width`` of them whatever n
    is: rows past n take garbage that is never stored), then the rows
    below by :func:`tile_mm`."""
    sides = [(R1, c1)] + ([(R2, c2)] if c2 else [])
    for k in range(0, n, width):
        nb = min(width, n - k)
        for R, cols in sides:
            x = R[k:k + width, :cols].copy()
            assert x.shape[0] == width
            for r in range(width):
                x[r] *= dinv[k + r]
                x[r + 1:] -= np.outer(Lc[k + r, k + r + 1:k + width], x[r])
            R[k:k + nb, :cols] = x[:nb]
        if k + width >= n:
            break
        for R, cols in sides:
            C, mask = tile_mm(Lc, R, n, cols, width, True, nt, a_row=k,
                              b_row=k, row_lo=k + width)
            at = np.nonzero(mask)
            R[at] -= C[at]


def filter_elements(rng: np.random.Generator, M: int, dx: int, dy: int = 2,
                    singular_head: int = 0, normalized: bool = False):
    """``(A, b, C, J, η)`` filtering elements over a bank of M: C PSD (its
    first ``singular_head`` lanes exactly zero, the rank-deficient-Q
    regime), J of rank dy < dx. ``normalized`` divides the random factors
    of A, C and J by √dx, so that their spectra stay O(1) (and the
    combine well conditioned in float32) at any width."""
    f = 1.0 / np.sqrt(dx) if normalized else 1.0
    A = 0.5 * f * rng.standard_normal((M, dx, dx))
    cr = 0.3 * f * rng.standard_normal((M, dx, dx))
    C = cr @ np.swapaxes(cr, -1, -2) + 0.01 * np.eye(dx)
    C[:singular_head] = 0.0
    jr = 0.4 * f * rng.standard_normal((M, dx, dy))
    return (A, rng.standard_normal((M, dx)), C, jr @ np.swapaxes(jr, -1, -2),
            rng.standard_normal((M, dx)))


def guard_lanes(rng: np.random.Generator, left, lanes=(0, 1),
                neg: float = -1e-8):
    """``left`` with C of lane ``lanes[0]`` rank-deficient with a tiny
    negative eigenvalue (``neg``, −1e-8 by default: below the combine's ε;
    a wide float32 factor needs a larger one, since its rounding alone
    reaches ~1e-8) and C of lane ``lanes[1]`` holding an infinite
    off-diagonal pair: lanes whose Cholesky fails."""
    A, b, C, J, eta = (np.array(x, copy=True) for x in left)
    dx = C.shape[-1]
    q, _ = np.linalg.qr(rng.standard_normal((dx, dx)))
    evals = np.zeros(dx)
    evals[: max(1, dx - 2)] = 1e-2
    evals[-1] = neg
    C[lanes[0]] = (q * evals) @ q.T
    C[lanes[1], 1 % dx, 0] = C[lanes[1], 0, 1 % dx] = np.inf
    return A, b, C, J, eta


def lgssm_fields(rng: np.random.Generator, dx: int, dy: int):
    """The fields of ``ParamsLGSSM`` for the parallel Kalman benchmark's
    model (``experiments/parallel_kf_bench.py``): F = 0.99·I + 0.01·N/dx,
    H = N/dx, Q = R = 0.1·I, a standard normal prior."""
    return dict(
        initial_mean=np.zeros(dx), initial_covariance=np.eye(dx),
        dynamics_matrix=0.99 * np.eye(dx)
        + 0.01 * rng.standard_normal((dx, dx)) / dx,
        dynamics_covariance=0.1 * np.eye(dx),
        emission_matrix=rng.standard_normal((dy, dx)) / dx,
        emission_covariance=0.1 * np.eye(dy))


def smoother_element_inputs(rng: np.random.Generator, M: int, dx: int):
    """``(fm, fP, pm, pP, F)`` for the RTS elements, F per lane."""
    return (rng.standard_normal((M, dx)), spd(rng, M, dx),
            rng.standard_normal((M, dx)), spd(rng, M, dx) + np.eye(dx),
            0.5 * rng.standard_normal((M, dx, dx)))


def smoother_elements(rng: np.random.Generator, M: int, dx: int):
    """``(E, g, L)`` smoothing elements over a bank of M, L PSD."""
    return (0.5 * rng.standard_normal((M, dx, dx)),
            rng.standard_normal((M, dx)), spd(rng, M, dx))


def resampling_counts(profile: str, n: int, rng: np.random.Generator):
    """Cumulative child counts (float, monotone, in [0, n]) of n outputs
    over n particles for the weight profiles that K5 is held to:
    "dirichlet" (Dirichlet(0.5) weights, comb offset 0.3), "last" (all mass
    on the last particle), "first" (all on the first), "spread" (3/4 of the
    outputs on particle 0, the rest thinly over all others: a 2048-output
    tile then draws parents spanning more than the TPU kernel's 4096-wide
    window), "tail" (the total saturated at n−1, the float rounding edge
    of ``ceil(n·cdf − u0)``)."""
    i = np.arange(n, dtype=np.float64)
    if profile in ("dirichlet", "tail"):
        w = rng.dirichlet(np.full(n, 0.5 if profile == "dirichlet" else 1.0))
        cdf = np.cumsum(w)
        cdf /= cdf[-1]
        u0 = 0.3 if profile == "dirichlet" else 0.5
        counts = np.clip(np.ceil(n * cdf - u0), 0, n)
        if profile == "tail":
            counts = np.minimum(counts, n - 1)
    elif profile == "last":
        counts = np.where(i < n - 1, 0.0, float(n))
    elif profile == "first":
        counts = np.full(n, float(n))
    elif profile == "spread":
        counts = np.clip(np.ceil(0.75 * n + (i / (n - 1)) * 0.25 * n), 0, n)
    else:
        raise ValueError(f"unknown profile {profile!r}")
    return np.maximum.accumulate(counts)


class Group:
    """The lane groups of ``csrc/lane_group.cuh`` written out in numpy:
    every group of a launch at once, thread i of lane m being row [m, i].
    Registers are (lanes, MX, MX) or (lanes, MX) arrays, a shuffle is an
    index exchange inside the group, and the group's board (``slots`` slots
    of an MX × MX matrix and an MX-vector) is a (lanes, slots, MX(MX + 1))
    array seeded with NaN, so that a read of an entry no thread wrote
    shows. The bounds ``n`` of the products and the factor are the
    kernels' uniform row and pivot bounds."""

    def __init__(self, lanes, mx, dx, dtype, slots=5):
        self.mx, self.dx, self.dt = mx, dx, dtype
        self.i = np.arange(mx)
        self.board = np.full((lanes, slots, mx * (mx + 1)), np.nan, dtype)

    def load(self, x, rows):
        """Rows (matrices) or entries (vectors) of lanes ``rows``, zero past
        the matrix's or the vector's extent."""
        x = np.asarray(x, self.dt)[rows]
        if x.ndim == 2:
            out = np.zeros((len(rows), self.mx), self.dt)
            out[:, :x.shape[1]] = x
        else:
            out = np.zeros((len(rows), self.mx, self.mx), self.dt)
            out[:, :x.shape[1], :x.shape[2]] = x
        return out

    def put_row(self, s, R, only=None):
        mx = self.mx
        for i in self.i if only is None else (only,):
            self.board[:, s, i * mx:(i + 1) * mx] = R[:, i]

    def put_el(self, s, v):
        self.board[:, s, self.mx * self.mx:] = v

    def rows(self, s):
        mx = self.mx
        return self.board[:, s, :mx * mx].reshape(-1, mx, mx)

    def get_row(self, s, k):
        """Row k of slot s, read by every thread: (lanes, MX, MX)."""
        return np.repeat(self.rows(s)[:, None, k], self.mx, axis=1)

    def get_col(self, s):
        """Thread i reads column i of slot s."""
        return np.swapaxes(self.rows(s), 1, 2).copy()

    def get_vec(self, s):
        v = self.board[:, s, self.mx * self.mx:]
        return np.repeat(v[:, None], self.mx, axis=1)

    def rowmul(self, x, s, n=None):
        """y = x B, the first n rows of B from slot s:
        y[j] = Σ_k x[k] B[k][j]."""
        B = self.rows(s)
        y = np.zeros_like(x)
        for k in range(self.mx if n is None else n):
            y = y + x[..., k:k + 1] * B[:, None, k, :]
        return y

    def rowmul_t(self, x, s, n=None):
        """y = x Bᵀ, the first n rows of B from slot s:
        y[j] = Σ_k x[k] B[j][k] (zero past n)."""
        B = self.rows(s)
        y = np.zeros_like(x)
        for j in range(self.mx if n is None else n):
            acc = np.zeros(x.shape[:-1], self.dt)
            for k in range(self.mx):
                acc = acc + x[..., k] * B[:, None, j, k]
            y[..., j] = acc
        return y

    def dot(self, x, v):
        acc = np.zeros(x.shape[:-1], self.dt)
        for k in range(self.mx):
            acc = acc + x[..., k] * v[..., k]
        return acc

    def shfl(self, v, src):
        """Every thread reads thread ``src``'s value: (lanes, MX)."""
        return np.repeat(v[:, src:src + 1], self.mx, axis=1)

    def group_sum(self, v):
        """The butterfly of xor shuffles: the same sum on every thread."""
        o = self.mx // 2
        while o:
            v = v + v[:, self.i ^ o]
            o //= 2
        return v

    def group_max(self, v):
        """The same butterfly with the maximum."""
        o = self.mx // 2
        while o:
            w = v[:, self.i ^ o]
            v = np.where(w > v, w, v)
            o //= 2
        return v

    def diag(self, R):
        """Thread i's entry i of its row (a select, not an indexed
        register)."""
        return R[:, self.i, self.i]

    def eye(self):
        return np.broadcast_to(np.eye(self.mx, dtype=self.dt),
                               (1, self.mx, self.mx))

    def chol(self, a, n=None):
        """The column sweep of ``group_chol`` over its first n columns: at
        column j the pivot comes from thread j, l_ij = a_ij · d^-½
        (l_jj = d · d^-½), and each row below takes l_kj of every later row
        k < n from its owner. Returns the rows of L (zeros above the
        diagonal in the swept columns), whether every pivot was positive,
        and each thread's own pivot reciprocal (one past n)."""
        n = self.mx if n is None else n
        a = a.copy()
        ok = np.ones(a.shape[0], bool)
        rinv = np.ones(a.shape[:2], self.dt)
        i = self.i[None, :]
        with np.errstate(invalid="ignore", divide="ignore"):
            for j in range(n):
                d = self.shfl(a[..., j], j)
                ok &= d[:, 0] > 0
                rs = (self.dt(1) / np.sqrt(d)).astype(self.dt)
                rinv = np.where(i == j, rs, rinv)
                l = np.where(i == j, d * rs,
                             np.where(i > j, a[..., j] * rs, 0)).astype(
                                 self.dt)
                a[..., j] = l
                for k in range(j + 1, n):
                    lk = self.shfl(l, k)
                    a[..., k] = np.where(i > j, a[..., k] - l * lk,
                                         a[..., k])
        return a, ok, rinv


PARENT_PROFILES = ("dirichlet", "last", "first", "spread", "tail")


__all__ = ["to_torch", "Group", "spd", "update_inputs", "predict_inputs",
           "NB", "TiledFactor", "augmented_factor", "square_factor",
           "tiles_of", "aug_layout", "last_from", "step_tasks",
           "factor_tasks", "factor_barriers", "block_tasks",
           "warp_cholesky_inverse", "factor_launch", "k1t_scratch",
           "k8t_scratch", "k6t_scratch", "k7t_scratch", "PANEL", "tiling",
           "tile_stored", "tile_mm", "lower_stored", "tile_mm_lower", "put",
           "put_t", "put_mirrored",
           "panel_cholesky", "tri_solve",
           "sigma_inputs", "sigma_aug_inputs", "ut_update_inputs",
           "ut_predict_inputs", "filter_elements", "guard_lanes",
           "lgssm_fields",
           "smoother_element_inputs", "smoother_elements",
           "resampling_counts", "PARENT_PROFILES"]
