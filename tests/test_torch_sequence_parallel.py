"""The port's time-sharded parallel Kalman filter and smoother and its
time-sharded parallel IEKS (``parallel/sequence.py``) against the JAX
package, on the CPU: the ranks are spawned processes of a gloo group, at
world sizes 1, 2 and 4, each holding a block of T/n steps (gathered here
by ``gather_time_blocks``).

JAX runs these paths by sharding the time axis of
``parallel_kalman_filter``/``parallel_kalman_smoother`` and
``parallel_iterated_extended_smoother``, and its own tests pin the sharded
run to the unsharded one, so the references are the unsharded JAX
functions (flat and chunked) and the sequential ``kalman_smoother``.

Tolerances, relative to max(1, max|reference|): at one rank the schedule
is the single-process one (float64, 1e-10 against JAX; the port's own
single-process function to 1e-12); with more ranks the cross-rank level
changes the combine tree, whose Woodbury jitter (1e-7·tr/dx a combine)
showed at up to 1.5e-9 against JAX's tree, so float64 is held there to
``TREE_TOL`` = 1e-8; against the sequential smoother (no jitter) the
parallel scan is 2.5e-8 off at any rank count, as the single-process one
is, held to ``SEQ_TOL`` = 1e-7; float32 to 1e-4. The IEKS (the
quadratic-measurement model, T = 64, 3 iterations, the rollout nominal)
at the same bounds.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu.models import zoo as jzoo
from bayesianfiltering_tpu.ops import parallel_iterated_extended_smoother
from bayesianfiltering_tpu.ops.associative import parallel_kalman_smoother
from bayesianfiltering_tpu.ops.linear import kalman_smoother
from bayesianfiltering_tpu_torch.parallel import (
    Mesh,
    time_sharded_iterated_extended_smoother,
    time_sharded_kalman_filter,
)
from parallel_ranks import spawn_worlds

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
T_KF, T_IEKS, CHUNK, ITERS = 256, 64, 16, 3
LG = ("linear_gaussian_lgssm", {"state_dim": 3, "emission_dim": 2})
QM = ("quadratic_measurement", {})
TREE_TOL, SEQ_TOL = 1e-8, 1e-7
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
FILTERED = ("filtered_means", "filtered_covariances", "predicted_means",
            "predicted_covariances", "marginal_loglik")
SMOOTHED = FILTERED + ("smoothed_means", "smoothed_covariances")


def t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def assert_close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def tol(n, dtype):
    return TOL[dtype] if dtype == torch.float32 or n == 1 else TREE_TOL


def jax_fast(fn, *args):
    return jax.device_get(
        jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args))


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def refs(x64):
    model, params, _ = jzoo.linear_gaussian(3, 2)
    lg = jzoo.linear_gaussian_lgssm(3, 2)
    _, ys = model.sample(params, jr.PRNGKey(0), T_KF)
    qmodel, qparams, _ = jzoo.quadratic_measurement()
    _, qys = qmodel.sample(qparams, jr.PRNGKey(2), T_IEKS)
    return {
        "ys": t(ys), "qys": t(qys),
        "flat": jax_fast(lambda e: parallel_kalman_smoother(
            lg, e, chunk=None), ys),
        "chunked": jax_fast(lambda e: parallel_kalman_smoother(
            lg, e, chunk=CHUNK), ys),
        "sequential": jax_fast(lambda e: kalman_smoother(lg, e), ys),
        "ieks": jax_fast(lambda e: parallel_iterated_extended_smoother(
            qparams, e, num_iter=ITERS), qys),
    }


def world_cases(refs, n):
    cases = []
    for dtype in (torch.float64, torch.float32):
        for label, chunk in (("flat", None), ("chunked", CHUNK)):
            for smoother in (False, True):
                cases.append(((label, smoother, dtype), "kalman", dict(
                    model=LG, ys=refs["ys"], smoother=smoother, chunk=chunk,
                    dtype=dtype)))
    cases.append(("ieks", "ieks", dict(model=QM, ys=refs["qys"],
                                       num_iter=ITERS, chunk="auto")))
    return cases


@pytest.fixture(scope="module")
def ranks(refs):
    return spawn_worlds(WORLDS, lambda n: world_cases(refs, n))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("smoother", [False, True])
@pytest.mark.parametrize("schedule", ["flat", "chunked"])
@pytest.mark.parametrize("n", WORLDS)
def test_time_sharded_kalman_matches_the_jax_parallel_scan(
        ranks, refs, n, schedule, smoother, dtype):
    want = refs[schedule]
    for out in ranks[n]:
        got = out[schedule, smoother, dtype]["whole"]
        for name in SMOOTHED if smoother else FILTERED:
            assert_close(got[name], getattr(want, name), tol(n, dtype))


@pytest.mark.parametrize("schedule", ["flat", "chunked"])
@pytest.mark.parametrize("n", WORLDS)
def test_time_sharded_smoother_matches_the_sequential_smoother(
        ranks, refs, n, schedule):
    got = ranks[n][0][schedule, True, torch.float64]["whole"]
    want = refs["sequential"]
    for name in ("filtered_means", "filtered_covariances", "smoothed_means",
                 "smoothed_covariances", "marginal_loglik"):
        assert_close(got[name], getattr(want, name), SEQ_TOL)


@pytest.mark.parametrize("schedule", ["flat", "chunked"])
def test_one_rank_is_the_single_process_scan(ranks, schedule):
    out = ranks[1][0][schedule, True, torch.float64]
    for name in SMOOTHED:
        assert_close(out["whole"][name], out["single"][name], 1e-12)


@pytest.mark.parametrize("n", WORLDS)
def test_each_rank_holds_its_block(ranks, n):
    for out in ranks[n]:
        case = out["flat", True, torch.float64]
        assert case["block_len"] == T_KF // n
        assert case["whole"]["smoothed_means"].shape == (T_KF, 3)


@pytest.mark.parametrize("n", WORLDS)
def test_time_sharded_ieks_matches_the_jax_ieks(ranks, refs, n):
    post, aux = refs["ieks"]
    for out in ranks[n]:
        got = out["ieks"]
        for name in ("smoothed_means", "smoothed_covariances",
                     "filtered_means", "marginal_loglik"):
            assert_close(got["whole"][name], getattr(post, name),
                         tol(n, torch.float64))
        assert_close(got["step_norms"], aux.step_norms,
                     tol(n, torch.float64))


def test_one_rank_ieks_is_the_single_process_ieks(ranks):
    out = ranks[1][0]["ieks"]
    for name in ("smoothed_means", "smoothed_covariances",
                 "marginal_loglik"):
        assert_close(out["whole"][name], out["single"][name], 1e-12)
    assert_close(out["step_norms"], out["single_step_norms"], 1e-12)


def test_indivisible_time_raises():
    from bayesianfiltering_tpu_torch.models import zoo

    lg = zoo.linear_gaussian_lgssm(2, 2, dtype=torch.float64, device="cpu")
    _, params, _ = zoo.quadratic_measurement(dtype=torch.float64,
                                             device="cpu")
    mesh = Mesh(None, "time", 0, 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible"):
        time_sharded_kalman_filter(lg, torch.zeros(10, 2,
                                                   dtype=torch.float64), mesh)
    with pytest.raises(ValueError, match="divisible"):
        time_sharded_iterated_extended_smoother(
            params, torch.zeros(10, 1, dtype=torch.float64), mesh)
    with pytest.raises(ValueError, match="not time-sharded"):
        time_sharded_iterated_extended_smoother(
            params, torch.zeros(8, 1, dtype=torch.float64),
            Mesh(None, "time", 0, 1, torch.device("cpu")), nominal="filter")
