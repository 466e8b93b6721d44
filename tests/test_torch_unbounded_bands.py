"""Every width the JAX package runs, on the CPU.

The JAX package routes any width to XLA (``ops/fused_ekf.py``
``_should_use_pallas``, ``ops/fused_ut.py``, ``ops/bank_combine.py``
``should_use_pallas``); the port runs every float32 and float64 width on
the card through the tiled variants K1t/K2t and K6t–K9t and the block
variants K10b–K12b on their global-scratch route. Held here:

- the rules pick those variants at path N's widths (dx = 2,048, dy = 1,024)
  and at n = 4,096, and no wrapper or band check raises for a width (CUDA
  stand-ins: the kernel op is replaced by a recorder, since nothing builds
  here);
- the wrappers (their plain versions on CPU tensors) against the JAX
  package just past the old bands, float64, one call each: the EKF update
  and predict at dx = dy = 520, the sigma points and the UT update at
  n = 1,032; tolerance 1e-9 relative to max(1, max|JAX|), the same
  formulas in another order through a Cholesky of a 520- or 1,032-wide
  matrix;
- the 64-bit index and scratch formulas of the CUDA sources, compiled by
  the host compiler, against the Python mirrors at n = 4,096, B = 8 and at
  the first width where the old ``int`` arithmetic overflows;
- K6's and K7's Newton–Schulz workspace formula against its mirror;
- float16 and bfloat16 through the combines and the elements: the JAX
  package computes at those dtypes (its XLA versions run every operation
  in the half dtype), so the port does too, in float32 rounded back once.
  Tolerances relative to max(1, max|reference|): against the float64
  reference float16 2e-3 and bfloat16 1.6e-2 (one rounding of outputs of
  magnitude up to ~4), against JAX's half result 1e-2 and 6e-2 (JAX's
  accumulated half rounding, measured up to 2.3e-3 and 2.1e-2).
"""
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu.ops import bank_combine as jbc
from bayesianfiltering_tpu.ops import bank_smoother as jbs
from bayesianfiltering_tpu.ops import fused_ekf as jfe
from bayesianfiltering_tpu.ops import fused_ut as jfu
from bayesianfiltering_tpu_torch import testing
from bayesianfiltering_tpu_torch.ops import bank_combine as bc
from bayesianfiltering_tpu_torch.ops import bank_smoother as bs
from bayesianfiltering_tpu_torch.ops import fused_ekf as fe
from bayesianfiltering_tpu_torch.ops import fused_ut as fu
from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF, ut_weights

torch.set_num_threads(1)

H100_OPTIN = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100
INT_MAX = 2 ** 31 - 1
CSRC = (Path(__file__).resolve().parents[1] / "bayesianfiltering_tpu_torch"
        / "csrc")


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def assert_close(got, want, tol):
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# ---------------------------------------------------------------------------
# The rules and the band checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 8])
def test_the_rules_pick_the_tiled_variants_at_path_n(itemsize):
    o = H100_OPTIN
    assert fe.update_kernel(2048, 1024, itemsize, o) is fe.K1T
    assert fe.update_kernel(2048, 128, itemsize, o) is fe.K1T  # chunked
    assert fe.predict_kernel(2048, 2048, itemsize, o) is fe.K2T
    for n in (2048, 4096):
        for method in ("cholesky", "sqrtm"):
            assert fu.sigma_kernel(n, method, itemsize, o) is fu.K6T
        assert fu.update_kernel(n, n // 2, itemsize, o) is fu.K8T
        assert fu.predict_kernel(n, itemsize, o) is fu.K9T
    assert fu.sigma_aug_kernel(1024, 1024, "cholesky", itemsize, o) is fu.K7T
    assert fu.sigma_aug_kernel(4096, 4096, "sqrtm", itemsize, o) is fu.K7T
    for kind in (bc.BLOCK_COMBINE, bc.BLOCK_ELEMENTS, bc.BLOCK_SCOMBINE):
        for dx in (1024, 2048, 4096):
            assert bc.block_tile(kind, dx, itemsize, o) == 0  # global scratch


class _OnCard:
    """A stand-in for a CUDA tensor: what the wrappers read before the
    kernel op."""

    is_cuda = True

    def __init__(self, *shape, dtype=torch.float32):
        self.shape = shape
        self.dtype = dtype

    def contiguous(self):
        return self


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx", [9, 512, 513, 1024, 2048, 4096])
def test_the_combine_band_check_takes_every_width(dtype, dx):
    a = _OnCard(4, dx, dx, dtype=dtype)
    for lane, block in ((bc.K10, bc.K10B), (bs.K11, bs.K11B),
                        (bs.K12, bs.K12B)):
        assert bc.band_kernel(lane, block, dx, a, a) is block
    assert bc.band_kernel(bc.K10, bc.K10B, 8, a) is bc.K10


def test_the_wrappers_pass_every_width_to_their_kernel_op(monkeypatch):
    """No wrapper checks a width on the card any more: each hands a
    dx = 2,048 (n = 4,096) CUDA input to its kernel op."""
    seen = []
    for mod, op in ((fe, "_fused_update"), (fe, "_fused_predict_cov"),
                    (fu, "_sigma_op"), (fu, "_sigma_aug_op"),
                    (fu, "_update_op"), (fu, "_predict_op")):
        monkeypatch.setattr(mod, op, lambda *a, _op=op: seen.append(_op))
    B, dx, dy = 1, 2048, 1024
    fe.fused_update(_OnCard(B, dx), _OnCard(B, dx, dx), _OnCard(B, dy, dx),
                    _OnCard(B, dy, dy), _OnCard(B, dy))
    fe.fused_predict_cov(_OnCard(B, dx, dx), _OnCard(B, dx, dx),
                         _OnCard(B, dx, dx), _OnCard(dx, dx))
    fu.fused_sigma(_OnCard(B, 4096), _OnCard(B, 4096, 4096), 1.0, "sqrtm")
    fu.fused_sigma_aug(_OnCard(B, dx), _OnCard(B, dx, dx), _OnCard(dx),
                       _OnCard(dx, dx), 1.0, "cholesky")
    fu.fused_ut_update(_OnCard(B, 2 * dx, dx), _OnCard(B, 2 * dx, dy),
                       _OnCard(B, dy), _OnCard(B, dy), _OnCard(B, dx),
                       _OnCard(B, dx, dx), _OnCard(dy, dy), _OnCard(B, dy),
                       0.1, 0.0, True)
    fu.fused_ut_predict(_OnCard(B, 2 * dx, dx), _OnCard(B, dx),
                        _OnCard(dx, dx), 0.1, 0.0, 0.0, True)
    assert seen == ["_fused_update", "_fused_predict_cov", "_sigma_op",
                    "_sigma_aug_op", "_update_op", "_predict_op"]


# ---------------------------------------------------------------------------
# Parity with the JAX package just past the old bands (float64)
# ---------------------------------------------------------------------------

TOL = 1e-9
JITTER = 1e-4


def _j(a):
    return jnp.asarray(a, jnp.float64)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def test_ekf_update_and_predict_past_the_old_band_match_jax():
    rng = np.random.default_rng(520)
    m, P, Hx, Rt, innov = testing.update_inputs(rng, 1, 520, 520)
    want = jfe._fused_update(_j(m[0]), _j(P[0]), _j(Hx[0]), _j(Rt[0]),
                             _j(innov[0]), JITTER, False)
    got = fe.fused_update(_t(m), _t(P), _t(Hx), _t(Rt), _t(innov), JITTER)
    for g, w in zip(got, want):
        assert_close(g[0], w, TOL)
    Fx, P, Fq, Q = testing.predict_inputs(rng, 1, 520, 520)
    want = jfe._fused_predict_cov(_j(Fx[0]), _j(P[0]), _j(Fq[0]), _j(Q),
                                  False)
    got = fe.fused_predict_cov(_t(Fx), _t(P), _t(Fq), _t(Q))
    assert_close(got[0], want, TOL)


def test_ut_sigma_points_and_update_past_the_old_band_match_jax():
    n, dy = 1032, 520
    rng = np.random.default_rng(n)
    m, P = testing.sigma_inputs(rng, 1, n)
    scale, (w_side, w0m, w0c) = ut_weights(n, ParamsUKF(1.0, 2.0, 0.0))
    want = jfu._sigma_xla(_j(m[0]), _j(P[0]), scale, "cholesky")
    pts = fu.fused_sigma(_t(m), _t(P), scale, "cholesky")
    assert_close(pts[0], want, TOL)
    hpts = rng.standard_normal((1, 2 * n, dy))
    cy = rng.standard_normal((1, dy))
    R = testing.spd(rng, (), dy)
    y = rng.standard_normal((1, dy))
    mu_y = w_side * hpts.sum(-2) + w0m * cy
    want = jfu._ut_update_xla(_j(np.asarray(pts[0])), _j(hpts[0]), _j(cy[0]),
                              _j(m[0]), _j(P[0]), _j(R), _j(y[0]),
                              (w_side, w0m, w0c), True)
    got = fu.fused_ut_update(pts, _t(hpts), _t(cy), _t(mu_y), _t(m), _t(P),
                             _t(R), _t(y - mu_y), w_side, w0c, True)
    for g, w in zip(got, want):
        assert_close(g[0], w, TOL)


# ---------------------------------------------------------------------------
# The 64-bit index and scratch formulas of the CUDA sources
# ---------------------------------------------------------------------------

def _cxx_block(src: str, head: str) -> str:
    """The definition that starts with the line matching ``head`` (a
    regular expression), to its closing brace (and ';' for a struct)."""
    found = re.search(rf"^{head}[^;{{]*{{", src, re.M)
    assert found is not None, f"no definition matching {head}"
    start, depth, i = found.start(), 0, found.end() - 1
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start:i + 1] + (";" if head.startswith("struct")
                                       else "")
        i += 1


# The first widths past an int: n² (n × n operands, the factor's R, K6t's
# Newton–Schulz buffers), K1t's W of (2n + n + 1) × n rows, K8t's centred
# points (2n rows × 2n columns), K11b's block X (ld × (3 ld + 32)) and K9t's
# centred points (2n × n)
N_SQ = 46_341
N_K1T = 26_755
N_K8T = 23_171
LD_K11B = 26_750
N_K9T = 32_768


def test_the_overflow_widths_are_the_first_past_an_int():
    assert N_SQ ** 2 > INT_MAX >= (N_SQ - 1) ** 2
    assert 3 * N_K1T * N_K1T + N_K1T > INT_MAX >= 3 * (N_K1T - 1) ** 2 \
        + N_K1T - 1
    assert 4 * N_K8T ** 2 > INT_MAX >= 4 * (N_K8T - 1) ** 2
    assert LD_K11B * (3 * LD_K11B + 32) > INT_MAX >= (LD_K11B - 1) * (
        3 * LD_K11B - 3 + 32)
    assert 2 * N_K9T ** 2 > INT_MAX >= 2 * (N_K9T - 1) ** 2


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """Each formula's values as the CUDA sources compute them, compiled by
    the host compiler: a list of (label, value)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    chol = (CSRC / "tiled_chol.cuh").read_text()
    sigma = (CSRC / "sigma_tiled.cu").read_text()
    ekf = (CSRC / "ekf_tiled.cu").read_text()
    ut = (CSRC / "ut_tiled.cu").read_text()
    comb = (CSRC / "bank_combine.cu").read_text()
    fused = (CSRC / "fused_ut.cu").read_text()
    bmm = (CSRC / "block_mm.cuh").read_text()
    prints = []

    def show(label, expr):
        prints.append(f'  std::printf("{label} %lld\\n", (long long)({expr}));')

    for n in (4096, N_SQ):
        show(f"at64 {n}", f"at64({n} - 1, {n} - 1, {n})")
        show(f"k6t_ns {n}", f"factor_elems(8, {n}, 1)")
        show(f"k6t_chol {n}", f"factor_elems(8, {n}, 0)")
    for n in (4096, N_K1T):
        show(f"k1t {n}", f"UpdateScratch({n}, {n}).f.total")
        show(f"k1t_l {n}", f"AugLayout({n}, {n}).l")
    for n in (4096, N_K8T):
        show(f"k8t {n}", f"UtUpdateScratch({2 * n}, {n}, {n}).f.total")
        show(f"k8t_d0 {n}", f"UtUpdateScratch({2 * n}, {n}, {n}).d0")
    for n in (4096, N_K9T):
        show(f"k9t {n}", f"predict_scratch_elems(8, {2 * n}, {n})")
        show(f"k2t {n}", f"predict_scratch({n}, {n})")
    for ld in (4096, LD_K11B):
        show(f"k11b_dinv {ld}", f"size_t({ld}) * elements_ldx({ld})")
        for kind in range(3):
            show(f"ws{kind} {ld}", f"tiled_ws({kind}, {ld})")
    for n in range(1, 129):
        show(f"ns_ws {n}", f"factor_ws_elems({n}, kSqrtm)")
    prog = "\n".join(
        ["#include <cstddef>", "#include <cstdio>", "#define __host__",
         "#define __device__", "constexpr int kNb = 32;",
         "constexpr int kSqrtm = 1;", "constexpr int kTM = 4;",
         _cxx_block(bmm, r"__host__ __device__ constexpr int round_up"),
         _cxx_block(chol, r"__host__ __device__ inline int tiles_of"),
         _cxx_block(chol, r"__host__ __device__ inline long long at64"),
         _cxx_block(chol, r"struct AugLayout"),
         _cxx_block(sigma, r"__host__ __device__ inline long long ns_stride"),
         _cxx_block(sigma, r"long long factor_stride"),
         _cxx_block(sigma, r"long long factor_elems"),
         _cxx_block(ekf, r"struct UpdateScratch"),
         _cxx_block(ekf, r"long long predict_scratch"),
         _cxx_block(ut, r"struct UtUpdateScratch"),
         _cxx_block(ut, r"long long predict_scratch_elems"),
         _cxx_block(comb, r"__host__ __device__ constexpr int elements_ldx"),
         _cxx_block(comb, r"__host__ __device__ constexpr size_t tiled_ws"),
         _cxx_block(fused, r"__host__ __device__ inline int ns_ld"),
         _cxx_block(fused, r"__host__ __device__ inline size_t ns_buf"),
         _cxx_block(fused, r"__host__ __device__ inline size_t "
                           r"factor_ws_elems"),
         "int main() {"] + prints + ["}"])
    tmp = tmp_path_factory.mktemp("index")
    (tmp / "index.cpp").write_text(prog)
    subprocess.run([cxx, "-std=c++17", "-o", str(tmp / "index"),
                    str(tmp / "index.cpp")], check=True)
    out = subprocess.run([str(tmp / "index")], check=True,
                         capture_output=True, text=True).stdout
    return dict((line.rsplit(" ", 1)[0], int(line.rsplit(" ", 1)[1]))
                for line in out.splitlines())


def test_the_index_formulas_match_their_python_model(compiled):
    """At n = 4,096 and B = 8, and at the first width where the old int
    arithmetic overflows, each offset and scratch size is the exact
    integer: no formula wraps."""
    for n in (4096, N_SQ):
        assert compiled[f"at64 {n}"] == (n - 1) * n + n - 1
        assert compiled[f"k6t_ns {n}"] == testing.k6t_scratch(8, n, "sqrtm")
        assert compiled[f"k6t_chol {n}"] == testing.k6t_scratch(8, n,
                                                                "cholesky")
    for n in (4096, N_K1T):
        assert compiled[f"k1t {n}"] == testing.k1t_scratch(n, n)
        assert compiled[f"k1t_l {n}"] == testing.aug_layout(n, n)["l"]
    for n in (4096, N_K8T):
        lay = testing.k8t_layout(2 * n, n, n)
        assert compiled[f"k8t {n}"] == lay["total"]
        assert compiled[f"k8t_d0 {n}"] == lay["d0"]
    for n in (4096, N_K9T):
        assert compiled[f"k9t {n}"] == testing.k9t_scratch(8, 2 * n, n)
        assert compiled[f"k2t {n}"] == testing.k2t_scratch(n, n)
    for ld in (4096, LD_K11B):
        assert compiled[f"k11b_dinv {ld}"] == ld * bc.elements_ldx(ld)
        for kind in range(3):
            assert compiled[f"ws{kind} {ld}"] == bc.tiled_ws(kind, ld)
    # past the old arithmetic: each of these exceeds an int
    assert compiled[f"at64 {N_SQ}"] > INT_MAX
    assert compiled[f"k1t_l {N_K1T}"] > INT_MAX
    assert compiled[f"k8t {N_K8T}"] > INT_MAX
    assert compiled[f"k11b_dinv {LD_K11B}"] > INT_MAX


def test_the_newton_schulz_workspace_mirror_matches_the_cuda_source(
        compiled):
    for n in range(1, 129):
        assert compiled[f"ns_ws {n}"] == fu._factor_ws(n, "sqrtm")


# ---------------------------------------------------------------------------
# Float16 and bfloat16: the JAX package computes, so does the port
# ---------------------------------------------------------------------------

HALF = {"float16": (jnp.float16, torch.float16, 2e-3, 1e-2),
        "bfloat16": (jnp.bfloat16, torch.bfloat16, 1.6e-2, 6e-2)}


@pytest.mark.parametrize("half,dx", [("float16", 4), ("bfloat16", 4),
                                     ("float16", 9)])
def test_half_combines_and_elements_compute_as_jax_does(half, dx):
    jd, td, tol_ref, tol_jax = HALF[half]
    rng = np.random.default_rng(dx)
    cases = [
        (jbc.bank_filter_combine, bc.bank_filter_combine,
         (testing.filter_elements(rng, 6, dx),
          testing.filter_elements(rng, 6, dx))),
        (jbs.bank_smoother_combine, bs.bank_smoother_combine,
         (testing.smoother_elements(rng, 6, dx),
          testing.smoother_elements(rng, 6, dx))),
        (jbs.bank_smoother_elements, bs.bank_smoother_elements,
         testing.smoother_element_inputs(rng, 6, dx)),
    ]
    for jfn, tfn, args in cases:
        cast = lambda f, a: tuple(cast(f, x) for x in a) \
            if isinstance(a, tuple) else f(a)
        ref = jfn(*cast(lambda x: jnp.asarray(x, jnp.float64), args))
        want = jfn(*cast(lambda x: jnp.asarray(x, jd), args))
        got = tfn(*cast(lambda x: torch.tensor(np.asarray(x), dtype=td),
                        args))
        for g, w, r in zip(got, want, ref):
            assert g.dtype == td and w.dtype == jd
            assert_close(g.float(), r, tol_ref)
            assert_close(g.float(), np.asarray(w, np.float32), tol_jax)
