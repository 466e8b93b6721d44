"""The port's model layer and numerical base against the JAX package, plus
the port's own contracts: parameters carried across, CPU tensors never
launch a kernel, importing the port loads no JAX.

float64 throughout; model functions and Jacobians are held to 1e-12
(identical elementwise formulas), sampling to 1e-12 given JAX's own normals.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu import distributions as jdist
from bayesianfiltering_tpu.models import zoo as jzoo
from bayesianfiltering_tpu.utils import angles as jangles
from bayesianfiltering_tpu.utils import linalg as jla
from bayesianfiltering_tpu_torch import _build, distributions, inference
from bayesianfiltering_tpu_torch.models import SampleDraws, params_from_jax, zoo
from bayesianfiltering_tpu_torch.models.params import ARRAY_FIELDS
from bayesianfiltering_tpu_torch.utils import angles, linalg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def t(x):
    return torch.as_tensor(np.array(x))


def assert_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.max(np.abs(want)))))


CPU64 = dict(dtype=torch.float64, device="cpu")
MODELS = {
    "lorenz96_euler": (lambda: jzoo.lorenz96(6, 3),
                       lambda: zoo.lorenz96(6, 3, **CPU64), None),
    "lorenz96_rk4": (lambda: jzoo.lorenz96(6, 3, integrator="rk4"),
                     lambda: zoo.lorenz96(6, 3, integrator="rk4", **CPU64),
                     None),
    "lorenz96_wide_emission": (
        lambda: jzoo.lorenz96(4, 3),
        lambda: zoo.lorenz96(4, 3, **CPU64), None),
    "bot_u0": (jzoo.bearings_only_tracking,
               lambda: zoo.bearings_only_tracking(**CPU64), 0),
    "bot_u1": (jzoo.bearings_only_tracking,
               lambda: zoo.bearings_only_tracking(**CPU64), 1),
    "bot_u2": (jzoo.bearings_only_tracking,
               lambda: zoo.bearings_only_tracking(**CPU64), 2),
    "range_bearing_u0": (jzoo.range_bearing_tracking,
                         lambda: zoo.range_bearing_tracking(**CPU64), 0),
    "range_bearing_u1": (jzoo.range_bearing_tracking,
                         lambda: zoo.range_bearing_tracking(**CPU64), 1),
    "range_bearing_u2": (jzoo.range_bearing_tracking,
                         lambda: zoo.range_bearing_tracking(**CPU64), 2),
    "linear_gaussian": (lambda: jzoo.linear_gaussian(3, 2),
                        lambda: zoo.linear_gaussian(3, 2, **CPU64), None),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_zoo_functions_and_jacobians(name):
    jmake, tmake, u = MODELS[name]
    _, jp, _ = jmake()
    _, tp, _ = tmake()
    rng = np.random.default_rng(0)
    dx = jp.initial_mean.shape[-1]
    x = rng.standard_normal(dx) + 1.0
    q = 0.1 * rng.standard_normal(jp.dynamics_noise_bias.shape)
    r = 0.1 * rng.standard_normal(jp.emission_noise_bias.shape)
    ju = None if u is None else jnp.asarray(u)
    tu = None if u is None else torch.tensor(u)
    jf, jh = jp.dynamics_function, jp.emission_function
    tf, th = tp.dynamics_function, tp.emission_function
    jac = torch.func.jacfwd
    for jfn, tfn, noise in ((jf, tf, q), (jh, th, r)):
        args_j = (jnp.asarray(x), jnp.asarray(noise), ju)
        args_t = (t(x), t(noise), tu)
        assert_close(jnp.atleast_1d(jfn(*args_j)), tfn(*args_t))
        for argnum in (0, 1):
            assert_close(jax.jacfwd(jfn, argnum)(*args_j),
                         jac(tfn, argnum)(*args_t))
    # the model functions take a batch of states as they are
    xb = rng.standard_normal((5, dx))
    batch = tf(t(xb), t(q), tu)
    for i in range(5):
        assert_close(batch[i], jf(jnp.asarray(xb[i]), jnp.asarray(q), ju))


def test_params_from_jax_round_trip_and_shape_errors():
    _, jp, _ = jzoo.bearings_only_tracking()
    _, template, _ = zoo.bearings_only_tracking(dtype=torch.float32,
                                                device="cpu")
    got = params_from_jax(jp, template, dtype=torch.float64, device="cpu")
    for name in ARRAY_FIELDS:
        value = getattr(got, name)
        assert value.dtype == torch.float64 and value.device.type == "cpu"
        assert_close(value, getattr(jp, name))
    assert got.dynamics_function is template.dynamics_function
    assert got.emission_residual is template.emission_residual

    arrays = {k: np.asarray(getattr(jp, k)) for k in ARRAY_FIELDS}
    assert params_from_jax(arrays, template, dtype=torch.float32,
                           device="cpu").initial_mean.dtype == torch.float32
    arrays["emission_noise_covariance"] = np.eye(2)
    with pytest.raises(ValueError, match="emission_noise_covariance"):
        params_from_jax(arrays, template, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("name", ["bot", "lorenz96"])
def test_sample_with_injected_noise(name):
    """JAX's model.sample draws x0, q and r from split keys; handed the
    same normals, the port samples the same trajectory."""
    T, key = 9, jr.PRNGKey(5)
    if name == "bot":
        jmodel, jp, _ = jzoo.bearings_only_tracking()
        tmodel, tp, _ = zoo.bearings_only_tracking(dtype=torch.float64,
                                                     device="cpu")
        inputs = jzoo.bot_maneuver_inputs(T)
    else:
        jmodel, jp, _ = jzoo.lorenz96(6, 3, integrator="rk4")
        tmodel, tp, _ = zoo.lorenz96(6, 3, integrator="rk4",
                                     dtype=torch.float64, device="cpu")
        inputs = None
    want_x, want_y = jmodel.sample(jp, key, T, inputs=inputs)
    k_init, k_dyn, k_obs = jr.split(key, 3)
    dx, dq = jp.initial_mean.shape[-1], jp.dynamics_noise_bias.shape[-1]
    dr = jp.emission_noise_bias.shape[-1]
    draws = SampleDraws(t(jr.normal(k_init, (dx,), jnp.float64)),
                        t(jr.normal(k_dyn, (T, dq), jnp.float64)),
                        t(jr.normal(k_obs, (T, dr), jnp.float64)))
    got_x, got_y = tmodel.sample(tp, T, inputs=None if inputs is None
                                 else t(inputs), draws=draws)
    assert_close(got_x, want_x)
    assert_close(got_y, want_y)


@pytest.mark.parametrize("last_pivot", [float("nan"), -1.0, 0.0])
def test_cholesky_nan_fails_a_factor_whose_info_misses_a_bad_pivot(
        monkeypatch, last_pivot):
    """A factor that ``cholesky_ex`` returns with ``info`` = 0 but a last
    pivot that is not positive (as on an H100 for one matrix failing only
    at its last pivot) is NaN throughout; its good neighbour is kept."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((2, 5, 5))
    spd = t(a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(5))
    exact = torch.linalg.cholesky(spd)
    missed = exact.clone()
    missed[1, 4, 4] = last_pivot
    monkeypatch.setattr(torch.linalg, "cholesky_ex", lambda x: (
        missed, torch.zeros(2, dtype=torch.int32)))
    got = linalg.cholesky_nan(spd)
    assert torch.isnan(got[1]).all()
    assert torch.equal(got[0], exact[0])


def test_numerical_base_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 4, 4))
    spd = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(4)
    indefinite = spd - 10.0 * np.eye(4)
    b = rng.standard_normal((3, 4))
    assert_close(linalg.psd_solve(t(spd), t(b)), jla.psd_solve(jnp.asarray(spd),
                                                               jnp.asarray(b)))
    assert_close(linalg.psd_solve(t(spd[0]), t(b[0]), compat_scalar=True),
                 jla.psd_solve(jnp.asarray(spd[0]), jnp.asarray(b[0]),
                               compat_scalar=True), 1e-9)
    both = np.concatenate([spd, indefinite])
    assert_close(linalg.cholesky_guarded(t(both)),
                 jla.cholesky_guarded(jnp.asarray(both)))
    assert torch.isnan(linalg.cholesky_nan(t(indefinite))).all()
    assert_close(distributions.mvn_logpdf(t(b), t(b[::-1]), t(spd)),
                 jdist.mvn_logpdf(jnp.asarray(b), jnp.asarray(b[::-1]),
                                  jnp.asarray(spd)))
    eps = rng.standard_normal((7, 3, 4))
    assert_close(distributions.mvn_sample(t(b), t(spd), (7,), eps=t(eps)),
                 jnp.asarray(b) + jnp.einsum("...ij,...j->...i",
                                             jnp.linalg.cholesky(spd), eps))
    theta = np.linspace(-10.0, 10.0, 41)
    assert_close(angles.wrap_angle(t(theta)), jangles.wrap_angle(theta))
    y, yhat = rng.standard_normal((5, 2)) * 4, rng.standard_normal((5, 2)) * 4
    assert_close(angles.angular_residual((0,))(t(y), t(yhat)),
                 jangles.angular_residual((0,))(jnp.asarray(y),
                                                jnp.asarray(yhat)))


def test_filters_on_cpu_tensors_never_launch_a_kernel():
    """CPU tensors take the plain twins through the whole main path."""
    _build.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    model, params, _ = zoo.lorenz96(8, 4, dtype=torch.float64, device="cpu")
    _, emissions = model.sample(params, 5, generator=g, batch_shape=(2,))
    inference.extended_kalman_filter(params, emissions)
    model, params, _ = zoo.bearings_only_tracking(dtype=torch.float64,
                                                  device="cpu")
    inputs = zoo.bot_maneuver_inputs(4, device="cpu")
    _, emissions = model.sample(params, 4, inputs=inputs, generator=g)
    inference.gaussian_sum_filter(params, emissions, 3, inputs=inputs,
                                  generator=g)
    inference.augmented_gaussian_sum_filter(params, emissions, [2, 2, 2], g,
                                            inputs=inputs,
                                            reduction="stratified")
    assert {k.name: k.launches for k in _build.KERNELS} == {
        "bft_ekf_update": 0, "bft_ekf_predict_cov": 0,
        "bft_ekf_update_tiled": 0, "bft_ekf_predict_cov_tiled": 0,
        "bft_bank_update": 0, "bft_bank_predict_cov": 0,
        "bft_ut_sigma": 0, "bft_ut_sigma_aug": 0, "bft_ut_update": 0,
        "bft_ut_predict": 0, "bft_ut_update_tiled": 0,
        "bft_ut_predict_tiled": 0, "bft_ut_sigma_tiled": 0,
        "bft_ut_sigma_aug_tiled": 0, "bft_resample_parents": 0,
        "bft_bank_combine": 0, "bft_bank_smoother_elements": 0,
        "bft_bank_smoother_combine": 0, "bft_block_combine": 0,
        "bft_block_smoother_elements": 0, "bft_block_smoother_combine": 0}


def test_precision_policy_is_applied_on_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import bayesianfiltering_tpu_torch\n"
        "import bayesianfiltering_tpu_torch.inference\n"
        "import bayesianfiltering_tpu_torch.testing\n"
        "import bayesianfiltering_tpu_torch.ops.bank_update\n"
        "import bayesianfiltering_tpu_torch.ops.fused_ut\n"
        "import bayesianfiltering_tpu_torch.utils.metrics\n"
        "import bayesianfiltering_tpu_torch.models\n"
        "import bayesianfiltering_tpu_torch.streaming\n"
        "import bayesianfiltering_tpu_torch.diagnostics\n"
        "import bayesianfiltering_tpu_torch.legacy\n"
        "import bayesianfiltering_tpu_torch.parallel\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0]"
        ".startswith('jax'))\n"
        "print(loaded)\n"
        "assert not loaded, loaded\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


# Names of the JAX package's __all__ that the port does not implement: none
# (the parallel (multi-device) subpackage was the last, ROADMAP.md queue 1).
NOT_PORTED = set()

# The same for the subpackages' __all__, each name against its ROADMAP.md
# queue 1 item ("not ported": the TPU-only factorisations that queue 1
# leaves out of the port). ``ops``, ``models``, ``containers``,
# ``streaming``, ``diagnostics``, ``legacy`` and ``parallel`` export every
# name.
SUBPACKAGE_NOT_PORTED = {
    "utils": {
        "fast_cholesky": "not ported", "cholesky_blocked": "not ported",
        "tri_inv_lower": "not ported",
    },
    "ops": {},
    "models": {},
    "containers": {},
    "streaming": {},
    "diagnostics": {},
    "legacy": {},
    "parallel": {},
}


def _assert_exports(jmod, port, not_ported):
    ported = [n for n in jmod.__all__ if n not in not_ported]
    assert set(not_ported) <= set(jmod.__all__)
    assert not [n for n in ported if n not in port.__all__]
    assert not [n for n in port.__all__ if not hasattr(port, n)]
    for name in not_ported:
        assert not hasattr(port, name), name


def test_the_port_exports_every_ported_name_of_the_jax_package():
    import bayesianfiltering_tpu as jpkg
    import bayesianfiltering_tpu_torch as port

    _assert_exports(jpkg, port, NOT_PORTED)


@pytest.mark.parametrize("sub", sorted(SUBPACKAGE_NOT_PORTED))
def test_the_subpackages_export_every_ported_name_of_the_jax_package(sub):
    """``ops``, ``utils``, ``models``, ``containers``, ``streaming``,
    ``diagnostics``, ``legacy`` and ``parallel``: every name of the JAX subpackage's
    ``__all__`` is in the port's, except those not ported yet."""
    import importlib

    _assert_exports(
        importlib.import_module(f"bayesianfiltering_tpu.{sub}"),
        importlib.import_module(f"bayesianfiltering_tpu_torch.{sub}"),
        SUBPACKAGE_NOT_PORTED[sub])


def test_params_bpf_and_the_mixture_posterior_import_from_the_top_level():
    from bayesianfiltering_tpu_torch import (
        ParamsBPF,
        PosteriorGaussianSumFiltered,
    )
    from bayesianfiltering_tpu_torch.inference import (
        PosteriorGaussianSumFiltered as posterior,
    )
    from bayesianfiltering_tpu_torch.models.params import ParamsBPF as params

    assert ParamsBPF is params and PosteriorGaussianSumFiltered is posterior
