"""The plain twins of the port's CUDA kernels K1–K4 against the JAX
package's XLA twins, on the CPU.

On CPU tensors the port's kernel wrappers run their plain twins, through
the same autograd binding the CUDA launch uses; the JAX side is the XLA
reference each TPU kernel is held against (``fused_ekf._update_xla`` /
``_predict_xla``, ``bank_update._update_xla`` / ``_predict_cov_xla``).
Shapes follow tests/test_pallas.py: bank dims 1..8 with M not a multiple
of 128, single stream dx=64, dy=32.

Tolerances (relative to max(1, max|reference|)): float64 1e-9 — both
sides evaluate the same formulas, differing only in factorization
routines and summation order (~1e-15 per op); float32 1e-4 — a few
hundred float32 roundings through a Cholesky of S.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu.ops import bank_update as jbu
from bayesianfiltering_tpu.ops import fused_ekf as jfe
from bayesianfiltering_tpu_torch import _build, testing
from bayesianfiltering_tpu_torch.ops import bank_update as bu
from bayesianfiltering_tpu_torch.ops import fused_ekf as fe

torch.set_num_threads(1)

TOL = {"float64": 1e-9, "float32": 1e-4}
DTYPES = ["float64", "float32"]


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def assert_close(got, want, dtype):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.nanmax(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


def as_pair(arrays, dtype):
    """The same numpy inputs for JAX and for the port."""
    return ([jnp.asarray(a, dtype) for a in arrays],
            [torch.as_tensor(np.asarray(a, dtype)) for a in arrays])


_jax_update_single = jax.jit(
    jax.vmap(jfe._update_xla, in_axes=(0, 0, 0, 0, 0, None)),
    static_argnums=5)
_jax_predict_single = jax.jit(jax.vmap(jfe._predict_xla,
                                       in_axes=(0, 0, 0, None)))
_jax_bank_update = jax.jit(jbu._update_xla, static_argnums=5)
_jax_bank_predict = jax.jit(jbu._predict_cov_xla)


class TestFusedTwins:
    """K1/K2: batched single-stream update and predict."""

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("jitter", [0.0, 1e-3])
    def test_update_matches_xla(self, dtype, jitter):
        rng = np.random.default_rng(0)
        j, t = as_pair(testing.update_inputs(rng, 3, 64, 32), dtype)
        want = _jax_update_single(*j, jitter)
        got = fe.fused_update(*t, jitter)
        for g, w in zip(got, want):
            assert_close(g, w, dtype)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_predict_matches_xla(self, dtype):
        rng = np.random.default_rng(1)
        j, t = as_pair(testing.predict_inputs(rng, 3, 64, 16), dtype)
        assert_close(fe.fused_predict_cov(*t), _jax_predict_single(*j), dtype)


class TestBankTwins:
    """K3/K4: bank update and predict, dims 1..8, M = 130."""

    @pytest.mark.parametrize("dx,dy", [(1, 1), (2, 1), (3, 4), (4, 1),
                                       (5, 2), (6, 7), (7, 3), (8, 8)])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_update_matches_xla(self, dx, dy, dtype):
        rng = np.random.default_rng(dx * 10 + dy)
        j, t = as_pair(testing.update_inputs(rng, 130, dx, dy), dtype)
        want = _jax_bank_update(*j, 0.0)
        got = bu.bank_chol_update(*t)
        for g, w in zip(got, want):
            assert_close(g, w, dtype)

    @pytest.mark.parametrize("dx,dq", [(1, 1), (2, 2), (4, 2), (5, 8),
                                       (8, 3)])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_predict_matches_xla(self, dx, dq, dtype):
        rng = np.random.default_rng(dx * 10 + dq)
        j, t = as_pair(testing.predict_inputs(rng, 130, dx, dq), dtype)
        assert_close(bu.bank_predict_cov(*t), _jax_bank_predict(*j), dtype)

    def test_wide_bank_takes_the_single_stream_band(self):
        """A bank with a dimension above 8 goes to K1 with the batch axis =
        M; on the CPU that is the same twin."""
        rng = np.random.default_rng(2)
        j, t = as_pair(testing.update_inputs(rng, 5, 10, 3), "float64")
        for g, w in zip(bu.bank_chol_update(*t), _jax_bank_update(*j, 0.0)):
            assert_close(g, w, "float64")


@pytest.mark.parametrize("update,jax_update", [
    (fe.fused_update, lambda *a: _jax_update_single(*a, 0.0)),
    (bu.bank_chol_update, lambda *a: _jax_bank_update(*a, 0.0)),
])
def test_non_pd_innovation_covariance_gives_nan(update, jax_update):
    """A negative-definite S: NaN on both sides, never an exception."""
    rng = np.random.default_rng(3)
    m, P, Hx, Rt, innov = testing.update_inputs(rng, 4, 4, 2)
    Rt = -1e3 * np.broadcast_to(np.eye(2), Rt.shape)
    j, t = as_pair((m, P, Hx, Rt, innov), "float64")
    got, want = update(*t), jax_update(*j)
    for g, w in zip(got, want):
        assert np.isnan(np.asarray(w)).all()
        assert torch.isnan(g).all()


class TestBackward:
    """The kernel ops' backward re-runs the plain twin under autograd; it
    must match ``jax.vjp`` of the XLA twin (float64, 1e-9)."""

    @pytest.mark.parametrize("update,jax_update,B,dx,dy", [
        (fe.fused_update, lambda *a: _jax_update_single(*a, 0.0), 2, 5, 3),
        (bu.bank_chol_update, lambda *a: _jax_bank_update(*a, 0.0), 7, 4, 2),
    ])
    def test_update_vjp(self, update, jax_update, B, dx, dy):
        rng = np.random.default_rng(4)
        inputs = testing.update_inputs(rng, B, dx, dy)
        cts = [rng.standard_normal(s) for s in
               [(B,), (B, dx), (B, dx, dx), (B, dx, dy)]]
        j, t = as_pair(inputs, "float64")
        for x in t:
            x.requires_grad_(True)
        outs = update(*t)
        torch.autograd.backward(outs, [torch.as_tensor(c) for c in cts])
        _, vjp = jax.vjp(jax_update, *j)
        for x, w in zip(t, vjp(tuple(jnp.asarray(c) for c in cts))):
            assert_close(x.grad, w, "float64")

    @pytest.mark.parametrize("predict,jax_predict,B,dx,dq", [
        (fe.fused_predict_cov, _jax_predict_single, 2, 6, 3),
        (bu.bank_predict_cov, _jax_bank_predict, 9, 4, 2),
    ])
    def test_predict_vjp(self, predict, jax_predict, B, dx, dq):
        rng = np.random.default_rng(5)
        j, t = as_pair(testing.predict_inputs(rng, B, dx, dq), "float64")
        ct = rng.standard_normal((B, dx, dx))
        for x in t:
            x.requires_grad_(True)
        predict(*t).backward(torch.as_tensor(ct))
        _, vjp = jax.vjp(jax_predict, *j)
        for x, w in zip(t, vjp(jnp.asarray(ct))):
            assert_close(x.grad, w, "float64")


def test_cpu_tensors_never_launch():
    """On CPU tensors every wrapper runs its twin; no launch is counted."""
    _build.reset_launch_counts()
    rng = np.random.default_rng(6)
    _, t = as_pair(testing.update_inputs(rng, 3, 4, 2), "float64")
    _, p = as_pair(testing.predict_inputs(rng, 3, 4, 2), "float64")
    fe.fused_update(*t)
    bu.bank_chol_update(*t)
    fe.fused_predict_cov(*p)
    bu.bank_predict_cov(*p)
    assert [k.launches for k in _build.KERNELS] == [0, 0, 0, 0]


def test_kernel_operand_checks_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_operands(fe.K1, (torch.zeros(2, 3), (2, 3)))
