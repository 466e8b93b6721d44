"""The port's mixture-sharded filters (``parallel/mixture.py``) against the
JAX package, on the CPU: the ranks are spawned processes of a gloo group,
at world sizes 1, 2 and 4; the JAX side runs on the conftest's 8-device
CPU mesh.

* ``sharded_gaussian_sum_filter`` against the single-device
  ``gaussian_sum_filter`` (JAX's own tests pin the sharded filter equal to
  it), on bearings-only tracking with the initial normals JAX draws:
  float64 at 1e-8; the port's float32 on the linear-Gaussian model to the
  float64 reference at 1e-4;
* ``sharded_agsf`` with the gathered systematic reduction against the
  single-device ``augmented_gaussian_sum_filter``, and with
  ``moments="ukf"`` against ``unscented_agsf``, on JAX's draws
  (``agsf_parity.jax_agsf_draws``): float64 at 1e-8;
* ``sharded_agsf(reduction="local")`` against JAX's sharded AGSF on a mesh
  of as many devices as there are ranks, each rank given the uniforms of
  its device's reduction key (``fold_in(key_reduce, device)``): float64
  at 1e-8.

Tolerances are relative to max(1, max|reference|). One spawn a world size
computes every case.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import bayesianfiltering_tpu.inference as jgf
from agsf_parity import T, jax_agsf_draws, jax_filter, problem
from bayesianfiltering_tpu.parallel import make_mesh as jmake_mesh
from bayesianfiltering_tpu.parallel.mixture import sharded_agsf as jsharded
from bayesianfiltering_tpu_torch.parallel import (
    Mesh,
    sharded_agsf,
    sharded_gaussian_sum_filter,
)
from parallel_ranks import spawn_worlds

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
TOL = {torch.float64: 1e-8, torch.float32: 1e-4}
BOT = ("bearings_only_tracking", {})
SV = ("stochastic_volatility", {})
LG = ("linear_gaussian", {})
GSF_M, COMPS, UCOMPS = 8, [8, 2, 2], [4, 2, 2]
UKF = (1.0, 0.0, 0.0)
POSTERIOR = ("means", "covariances", "weights", "marginal_loglik")


def t(x):
    x = np.array(x)
    return torch.as_tensor(x, dtype=torch.float64 if x.dtype.kind == "f"
                           else None)


def assert_close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def local_reduce_draws(key, n):
    """Each device's reduction uniforms of JAX's sharded AGSF with
    ``reduction="local"``: ``uniform(fold_in(key_reduce_t, device))``."""
    scan_key = jr.split(key)[1]
    kr = [jr.split(jr.fold_in(scan_key, s), 3)[2] for s in range(T)]
    return [t(jnp.stack([jr.uniform(jr.fold_in(k, dev), (), jnp.float64)
                         for k in kr])) for dev in range(n)]


@pytest.fixture(scope="module")
def refs(x64):
    bot_j, _, bot_in, bot_ys = problem("bearings_only_tracking")
    sv_j, _, sv_in, sv_ys = problem("stochastic_volatility")
    lg_j, _, _, lg_ys = problem("linear_gaussian")
    gkey, akey, ukey = jr.PRNGKey(3), jr.PRNGKey(5), jr.PRNGKey(7)
    out = dict(bot_ys=t(bot_ys), bot_in=t(bot_in), sv_ys=t(sv_ys),
               sv_in=t(sv_in), lg_ys=t(lg_ys))
    out["gsf"] = jax_filter(lambda e: jgf.gaussian_sum_filter(
        bot_j, e, GSF_M, inputs=bot_in, key=gkey), bot_ys)
    out["gsf_eps"] = t(jr.normal(gkey, (GSF_M, 4), jnp.float64))
    out["gsf_lg"] = jax_filter(lambda e: jgf.gaussian_sum_filter(
        lg_j, e, GSF_M, key=gkey), lg_ys)
    out["gsf_lg_eps"] = t(jr.normal(gkey, (GSF_M, 3), jnp.float64))
    out["agsf"] = jax_filter(lambda e: jgf.augmented_gaussian_sum_filter(
        bot_j, e, COMPS, akey, 1, (0.1, 0.1), bot_in,
        reduction="systematic")[0], bot_ys)
    out["agsf_draws"] = jax_agsf_draws(akey, T, *COMPS, 4, "systematic")
    out["uagsf"] = jax_filter(lambda e: jgf.unscented_agsf(
        sv_j, jgf.ParamsUKF(*UKF), e, UCOMPS, ukey, 1, (0.1, 0.1), sv_in,
        reduction="systematic")[0], sv_ys)
    out["uagsf_draws"] = jax_agsf_draws(ukey, T, *UCOMPS, 3, "systematic")
    for n in WORLDS:
        mesh = jmake_mesh((n,), ("mixture",))
        out["local", n] = jax.device_get(jsharded(
            bot_j, jnp.asarray(bot_ys), COMPS, mesh, key=akey,
            inputs=bot_in, reduction="local"))
        out["local_reduce", n] = local_reduce_draws(akey, n)
    return out


def world_cases(refs, n):
    d, ud = refs["agsf_draws"], refs["uagsf_draws"]
    bot = dict(model=BOT, ys=refs["bot_ys"], inputs=refs["bot_in"])
    return [
        ("gsf", "gsf", dict(M=GSF_M, eps=refs["gsf_eps"], **bot)),
        ("gsf f32", "gsf", dict(model=LG, ys=refs["lg_ys"], M=GSF_M,
                                eps=refs["gsf_lg_eps"], inputs=None,
                                dtype=torch.float32)),
        ("agsf", "agsf", dict(comps=COMPS, draws=d[:3], reduce=d.reduce,
                              reduction="systematic", **bot)),
        ("uagsf", "agsf", dict(model=SV, ys=refs["sv_ys"],
                               inputs=refs["sv_in"], comps=UCOMPS,
                               draws=ud[:3], reduce=ud.reduce,
                               reduction="systematic", moments="ukf",
                               uparams=UKF)),
        ("local", "agsf", dict(comps=COMPS, draws=d[:3],
                               reduce=refs["local_reduce", n],
                               reduction="local", **bot)),
    ]


@pytest.fixture(scope="module")
def ranks(refs):
    return spawn_worlds(WORLDS, lambda n: world_cases(refs, n))


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_gsf_matches_the_jax_gsf(ranks, refs, n):
    for out in ranks[n]:
        for name in POSTERIOR + ("predicted_means",
                                 "predicted_covariances"):
            assert_close(out["gsf"][name], getattr(refs["gsf"], name),
                         TOL[torch.float64])


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_gsf_float32(ranks, refs, n):
    out = ranks[n][0]["gsf f32"]
    assert out["means"].dtype == torch.float32
    for name in POSTERIOR:
        assert_close(out[name], getattr(refs["gsf_lg"], name),
                     TOL[torch.float32])


@pytest.mark.parametrize("case,ref", [("agsf", "agsf"), ("uagsf", "uagsf")])
@pytest.mark.parametrize("n", WORLDS)
def test_gathered_sharded_agsf_matches_the_jax_agsf(ranks, refs, n, case,
                                                    ref):
    """The gathered reduction is the single-process engine's on the same
    draws (EKF moments; UKF moments against ``unscented_agsf``)."""
    for out in ranks[n]:
        for name in POSTERIOR:
            assert_close(out[case][name], getattr(refs[ref], name),
                         TOL[torch.float64])


@pytest.mark.parametrize("n", WORLDS)
def test_local_reduction_matches_the_jax_sharded_agsf(ranks, refs, n):
    want = refs["local", n]
    for out in ranks[n]:
        for name in POSTERIOR:
            assert_close(out["local"][name], getattr(want, name),
                         TOL[torch.float64])


@pytest.mark.parametrize("n", WORLDS)
def test_local_reduction_keeps_the_mass(ranks, n):
    """The weights sum to one every step, and the shapes do not depend on
    the rank count (JAX's weak-scaling tests)."""
    out = ranks[n][0]["local"]
    assert out["means"].shape == (COMPS[0], T, 4)
    np.testing.assert_allclose(out["weights"].sum(0).numpy(), np.ones(T),
                               rtol=1e-12)


def test_indivisible_components_raise():
    from bayesianfiltering_tpu_torch.models import zoo

    _, params, _ = zoo.linear_gaussian(2, 2, dtype=torch.float64,
                                       device="cpu")
    mesh = Mesh(None, "mixture", 0, 4, torch.device("cpu"))
    ys, gen = torch.zeros(4, 2, dtype=torch.float64), torch.Generator()
    with pytest.raises(ValueError, match="divisible"):
        sharded_gaussian_sum_filter(params, ys, 6, mesh, gen)
    with pytest.raises(ValueError, match="divisible"):
        sharded_agsf(params, ys, [6, 2, 2], mesh, gen)
