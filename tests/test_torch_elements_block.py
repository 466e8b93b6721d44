"""K11b's launch plan and lane loop, on the CPU.

K11b (``csrc/bank_combine.cu`` ``block_smoother_elements_kernel``) forms
the RTS smoothing elements of one lane a block above the lane band
(8 < dx ≤ 512), on the routes of K10b and K12b: its workspace in shared
memory with a leading dimension of 64 where dx ≤ 64 and it fits
(``ops/bank_combine.py`` ``block_tile``, workspace kind
``BLOCK_ELEMENTS``), else in global scratch with the leading dimension
rounded up to 64. The rule is held at its edges with the H100's
shared-memory opt-in (232,448 bytes) and with smaller ones, and the
workspace formula of ``ops/bank_combine.py`` against the C++ one, compiled
here by the host compiler where there is one.

The lane loop is written out below in numpy, step by step, on workspaces
seeded with NaN and kept from lane to lane (so that any read of an entry
the kernel never wrote, or wrote for another lane, shows), from the numpy
models of ``bayesianfiltering_tpu_torch/testing.py``: the shared F staged
once for the block (or a banked F each lane); lane m's Pp into the first
columns of the block X = [Pp | F Pf | mp | I], its lower triangle
mirrored into the factor's column-major layout; F Pf by ``tile_mm``; the
panel factor (``panel_cholesky``) in panels of 32 in float32 and 16 in
float64, its pivots' reciprocals NaN where it fails; one panel solve
[Y | z | Lp⁻¹] = Lp⁻¹ [F Pf | mp | I] (``tri_solve``); E = Yᵀ Lp⁻¹
(``tile_mm``, the A-transposed layout, out from registers);
L = sym(Pf) − YᵀY formed in Pf by the epilogue of the packed lower tiles
(``tile_mm_lower``), each tile with its mirror; g = mf − Yᵀ z; the next
lane's Pp, mp, identity and Pf (into the other of two Pf buffers) staged
before L is stored.

Each schedule is held, in float64 and float32, to the JAX package's XLA
twin ``bank_smoother._elements_xla`` (float64) at dx = 9, 33, 63, 64, 65
and 96 (ragged edges, both routes), with F shared and F banked, and a Pp
that is not positive definite in one lane (that lane NaN throughout on
both sides, the others finite). The CUDA kernel itself runs only on the
card (tests/test_torch_cuda.py).

Tolerances (relative to max(1, max|reference|)): float64 1e-10, float32
1e-3 (the bound chip_smoke.py holds every kernel to): the same function
in another order of summation.
"""
import functools
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu.ops import bank_smoother as jbs
from bayesianfiltering_tpu_torch import testing
from bayesianfiltering_tpu_torch.ops import bank_combine as bc
from bayesianfiltering_tpu_torch.ops import bank_smoother as bs

torch.set_num_threads(1)

H100_OPTIN = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100
H100_SMEM_PER_SM = 233_472  # 228 KB a streaming multiprocessor
SMEM_RESERVED = 1024  # the runtime's shared memory of each block
H100_SMS = 132
TOL = {"float64": 1e-10, "float32": 1e-3}
NT = 256    # K11b's threads a block (ops/bank_combine.py WIDE_THREADS)
# csrc/bank_combine.cu kElementsPanel: the factor's and the solve's panel
PANEL = {"float32": 32, "float64": 16}
DXS = (9, 33, 63, 64, 65, 96)
K11B = bc.BLOCK_ELEMENTS
CSRC = (Path(__file__).resolve().parents[1] / "bayesianfiltering_tpu_torch"
        / "csrc")


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}

_COMPILED = {}


def _elements_xla(*args):
    """``bank_smoother._elements_xla`` in float64, compiled once per
    shape."""
    args = [jnp.asarray(a, jnp.float64) for a in args]
    key = tuple(a.shape for a in args)
    if key not in _COMPILED:
        _COMPILED[key] = jax.jit(jbs._elements_xla).lower(*args).compile(
            FAST_COMPILE)
    return [np.asarray(o) for o in _COMPILED[key](*args)]


def assert_close(got, want, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dx,itemsize,optin,want", [
    (9, 4, H100_OPTIN, 64),       # the band's lower edge
    (33, 4, H100_OPTIN, 64),
    (64, 4, H100_OPTIN, 64),      # path C
    (65, 4, H100_OPTIN, 0),
    (512, 4, H100_OPTIN, 0),      # the band's upper edge
    (9, 8, H100_OPTIN, 64),
    (64, 8, H100_OPTIN, 64),      # 27,200 elements: 217,600 bytes
    (65, 8, H100_OPTIN, 0),
    (64, 4, 112 * 1024, 64),      # a card with less: 108,800 bytes fit
    (64, 8, 112 * 1024, 0),
    (64, 4, 96 * 1024, 0),
    (9, 4, 96 * 1024, 0),
])
def test_elements_tile_rule(dx, itemsize, optin, want):
    assert bc.block_tile(K11B, dx, itemsize, optin) == want


def test_elements_workspace_fits_the_h100_where_the_rule_says():
    """At ld = 64 the workspace takes 27,200 elements: two blocks an SM in
    float32 (each with the static slack and the runtime's reserve), one in
    float64, under the opt-in."""
    ws = bc.tiled_ws(K11B, bc.TILE)
    assert ws == 3 * 64 * 64 + 64 * bc.elements_ldx(64) + 64 + 512 == 27_200
    assert ws * 8 + 256 <= H100_OPTIN
    assert 2 * (ws * 4 + 256 + SMEM_RESERVED) <= H100_SMEM_PER_SM
    assert 2 * (ws * 8 + 256 + SMEM_RESERVED) > H100_SMEM_PER_SM


@pytest.mark.parametrize("M", [1, 4, 132, 65_535])
@pytest.mark.parametrize("tile,itemsize", [(64, 4), (64, 8), (0, 4)])
def test_elements_threads_rule(M, tile, itemsize):
    assert bc.block_threads(K11B, M, tile, itemsize, H100_SMS) == 256


def _cxx_function(src: str, name: str) -> str:
    """The definition of the function ``name`` in ``src``: from the start
    of the line that declares it to its closing brace."""
    found = re.search(rf"^[^\n;{{}}]*\b{name}\([^)]*\)\s*{{", src, re.M)
    assert found is not None, f"no definition of {name}"
    start, depth, i = found.start(), 0, found.end() - 1
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start:i + 1]
        i += 1


def test_workspace_formula_matches_the_cuda_source(tmp_path):
    """``tiled_ws`` and ``tiled_ld`` of csrc/bank_combine.cu, compiled by
    the host compiler, give the launch's workspace (and its global
    scratch) what ``ops/bank_combine.py`` plans, for every kind."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = (CSRC / "bank_combine.cu").read_text()
    lds = (64, 128, 192, 256, 320, 384, 448, 512)
    prog = "\n".join(
        ["#include <cstddef>", "#include <cstdio>",
         "#include <initializer_list>", "#define __host__",
         "#define __device__"]
        + [_cxx_function(src, f) for f in ("elements_ldx", "tiled_ws",
                                           "tiled_ld")]
        + ["int main() {",
           "  for (int kind = 0; kind < 3; ++kind)",
           f"    for (int ld : {{{', '.join(map(str, lds))}}})",
           '      std::printf("%d %d %zu %d\\n", kind, ld, tiled_ws(kind, '
           "ld), tiled_ld(0, ld - 63));",
           "}"])
    (tmp_path / "ws.cpp").write_text(prog)
    subprocess.run([cxx, "-std=c++17", "-o", str(tmp_path / "ws"),
                    str(tmp_path / "ws.cpp")], check=True)
    out = subprocess.run([str(tmp_path / "ws")], check=True,
                         capture_output=True, text=True).stdout.split("\n")
    rows = [tuple(map(int, line.split())) for line in out if line]
    assert len(rows) == 3 * len(lds)
    for kind, ld, ws, ld_global in rows:
        assert ws == bc.tiled_ws(kind, ld)
        assert ld_global == ld  # dx = ld − 63 rounds up to ld


# ---------------------------------------------------------------------------
# The lane loop
# ---------------------------------------------------------------------------

def _round_up(x, m):
    return -(-x // m) * m


def k11b_model(fm, fP, pm, pP, F, dtype):
    """K11b's lane loop in numpy for one block over every lane: ``F``
    (dx, dx) shared, staged once, or (M, dx, dx) banked. Returns
    (E, g, L)."""
    M, n = fm.shape
    banked = F.ndim == 3
    tile = bc.block_tile(K11B, n, np.dtype(dtype).itemsize, H100_OPTIN)
    ld = tile or _round_up(n, 64)
    ldx = bc.elements_ldx(ld)
    oy, oz, oi = ld, ld + n, _round_up(ld + n + 1, 4)
    panel = PANEL[np.dtype(dtype).name]
    cast = lambda x: np.asarray(x, dtype)
    Fs = np.full((ld, ld), np.nan, dtype)
    Pbuf = [np.full((ld, ld), np.nan, dtype) for _ in range(2)]
    X = np.full((ld, ldx), np.nan, dtype)
    dinv = np.full(ld, np.nan, dtype)
    E, g, L = (np.empty((M, n, n), dtype), np.empty((M, n), dtype),
               np.empty((M, n, n), dtype))
    strict = np.tri(n, k=-1, dtype=bool)  # i > j
    tiles = np.arange(n) // 4
    diag_tile = tiles[:, None] == tiles[None, :]

    def stage_lane(m, P):
        X[:n, :n] = cast(pP[m])
        P[:n, :n] = cast(fP[m])
        X[:n, oz] = cast(pm[m])
        if banked:
            Fs[:n, :n] = cast(F[m])
        X[:n, oi:oi + n] = np.eye(n, dtype=dtype)

    if not banked:
        Fs[:n, :n] = cast(F)
    stage_lane(0, Pbuf[0])
    for m in range(M):
        P = Pbuf[m % 2]
        # lower(Pp) into the factor's layout; F Pf into Y
        S = X[:n, :n]
        S.T[strict] = S[strict]
        testing.put(X[:, oy:oy + ld],
                    *testing.tile_mm(Fs, P, n, n, n, False, NT))
        bad = testing.panel_cholesky(X, n, panel)
        dinv[:] = np.nan if bad else 1
        if not bad:
            dinv[:n] = 1 / np.diag(X[:n, :n])
        # [Y | z | Lp⁻¹] = Lp⁻¹ [F Pf | mp | I]
        testing.tri_solve(X, dinv, X[:, oy:], n + 1, X[:, oi:], n, n, NT,
                          panel)
        C, mask = testing.tile_mm(X[:, oy:], X[:, oi:], n, n, n, True, NT)
        E[m] = np.where(mask[:n, :n], C[:n, :n], np.nan)
        C, mask = testing.tile_mm_lower(X[:, oy:], X[:, oy:], n, n)
        stored = mask[:n, :n]
        assert (stored | stored.T).all()
        Wn = C[:n, :n]
        W = np.where(diag_tile, dtype(0.5) * (Wn + Wn.T), Wn)
        Pn = P[:n, :n]
        v = dtype(0.5) * (Pn + Pn.T) - W
        at = np.nonzero(stored)
        Pn[at] = v[at]
        Pn[at[1], at[0]] = v[at]
        g[m] = cast(fm[m]) - X[:n, oy:oy + n].T @ X[:n, oz]
        if m + 1 < M:
            stage_lane(m + 1, Pbuf[(m + 1) % 2])
        L[m] = P[:n, :n]
    return E, g, L


M_LANES = 3


@functools.lru_cache(maxsize=None)
def elements_case(dx, banked, non_pd=False):
    """(fm, fP, pm, pP, F, JAX's elements): F banked, or lane 0's F shared
    by every lane; ``non_pd``: lane 1's Pp negated."""
    fm, fP, pm, pP, F = testing.smoother_element_inputs(
        np.random.default_rng(dx), M_LANES, dx)
    if non_pd:
        pP = pP.copy()
        pP[1] = -pP[1]
    F = F if banked else F[0]
    Fm = F if banked else np.broadcast_to(F, (M_LANES, dx, dx))
    return fm, fP, pm, pP, F, _elements_xla(fm, fP, pm, pP, Fm)


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dx", DXS)
def test_k11b_schedule_matches_jax(dx, dtype, banked):
    *args, want = elements_case(dx, banked)
    got = k11b_model(*args, np.dtype(dtype).type)
    for gt, w in zip(got, want):
        assert_close(gt, w, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dx", [33, 64, 65])
def test_k11b_non_pd_lane_is_nan(dx, dtype):
    """Lane 1's Pp is not positive definite: its pivots' reciprocals are
    NaN, so E, g and L are NaN throughout, as the plain version's and the
    JAX twin's; lanes 0 and 2 (after it, on the workspace it left) hold
    to the JAX twin."""
    fm, fP, pm, pP, F, want = elements_case(dx, False, non_pd=True)
    got = k11b_model(fm, fP, pm, pP, F, np.dtype(dtype).type)
    plain = bs._elements_plain(*(torch.as_tensor(np.array(x)) for x in (
        fm, fP, pm, pP, np.broadcast_to(F, (M_LANES, dx, dx)))))
    for gt, w, p in zip(got, want, plain):
        assert np.isnan(gt[1]).all() and np.isnan(w[1]).all()
        assert torch.isnan(p[1]).all()
        for lane in (0, 2):
            assert_close(gt[lane], w[lane], dtype)
