"""The port's multi-device dry run (``parallel/dryrun.py``) on the CPU, at
two and four ranks of a gloo group: every stage's line, and stage 1's
all-reduced gradient against the gradient of the whole batch in one
process (float32, 1e-6 relative) and against the central differences of
JAX's float64 loss, the graft entry's ``_dryrun_body`` stage 1, on the
same sequences (1e-4 relative). ``jax.grad`` of that loss is not the
reference: it disagrees with JAX's own central differences (3.79 against
2.74 for the derivative in ``a`` on the two-rank batch), which the port's
gradient matches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesianfiltering_tpu.inference as jgf
from bayesianfiltering_tpu.models.params import ParamsNLSSM
from bayesianfiltering_tpu_torch.parallel import dryrun
from bayesianfiltering_tpu_torch.parallel.dryrun import (
    THETA,
    dryrun_multichip,
    ekf_loss_grads,
    stage1_emissions,
)

torch.set_num_threads(1)

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_grads(emissions, step=1e-6):
    """Central differences of ``__graft_entry__._dryrun_body``'s stage-1
    loss in float64."""
    def make_params(theta):
        eye = jnp.eye(dryrun.STATE_DIM)
        zero = jnp.zeros(dryrun.STATE_DIM)
        return ParamsNLSSM(
            initial_mean=zero, initial_covariance=eye,
            dynamics_function=lambda x, q, u: theta["a"] * x + q,
            dynamics_noise_bias=zero,
            dynamics_noise_covariance=theta["q"] * eye,
            emission_function=lambda x, r, u: theta["h"] * x + r,
            emission_noise_bias=zero,
            emission_noise_covariance=0.1 * eye)

    def loss(theta, em):
        lls = jax.vmap(lambda e: jgf.extended_kalman_filter(
            make_params(theta), e).marginal_loglik)(em)
        return -jnp.sum(lls)

    theta = {k: jnp.asarray(v) for k, v in THETA.items()}
    run = jax.jit(loss).lower(theta, emissions).compile(FAST_COMPILE)
    diffs = []
    for k in THETA:
        up = {**theta, k: theta[k] + step}
        down = {**theta, k: theta[k] - step}
        diffs.append((float(run(up, emissions)) - float(run(down, emissions)))
                     / (2 * step))
    return np.array(diffs)


@pytest.fixture(scope="module")
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_the_cpu(n, capfd, x64):
    out = dryrun_multichip(n, device="cpu", timeout_s=240)
    lines = capfd.readouterr().out
    for k in range(1, 6):
        assert f"dryrun stage {k}/5 ok" in lines
    assert f"dryrun_multichip OK ({n} ranks on cpu)" in lines
    assert out["bpf_local"].shape == out["bpf_gather"].shape == (4, 2)
    for value in out.values():
        assert torch.isfinite(value).all()

    emissions = stage1_emissions(n)
    whole = torch.stack(ekf_loss_grads(THETA, emissions))
    np.testing.assert_allclose(out["grads"].numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-6)
    want = jax_grads(jnp.asarray(emissions.double().numpy()))
    np.testing.assert_allclose(out["grads"].numpy(), want,
                               rtol=1e-4, atol=1e-4 * np.abs(want).max())
