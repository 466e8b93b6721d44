"""The port's streaming steppers and diagnostics against the JAX package,
on the CPU.

Steppers: the EKF, GSF and BPF steppers against JAX's on the same model
and emissions, the GSF with JAX's initial normals and the BPF with the
very normals and uniforms of JAX's key schedule; chunked runs against
one-shot runs, a checkpoint round trip against an uninterrupted run, and
the EKF stepper over a batch against the batched EKF. float64, 1e-8
relative to max(1, max|reference|). The BPF stepper reports the mean of
the bank after a step's resampling, as the whole-sequence BPF does (the
JAX stepper weighs the resampled particles with the weights from before
the resampling): its means are held to JAX's whole-sequence BPF, its ESS
to JAX's stepper. Diagnostics: ``check_finite`` and ``ess_diagnostics``
exactly, ``debug_nans`` on a NaN from a plain operation and from a
kernel op's plain version.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import bayesianfiltering_tpu.inference as jgf
from bayesianfiltering_tpu import diagnostics as jdiag
from bayesianfiltering_tpu import streaming as jstream
from bayesianfiltering_tpu.models import zoo as jzoo
from bayesianfiltering_tpu_torch import diagnostics, inference, streaming
from bayesianfiltering_tpu_torch.models import params_from_jax, zoo
from bayesianfiltering_tpu_torch.ops import fused_ekf
from bayesianfiltering_tpu_torch.utils import resampling as rs

torch.set_num_threads(1)

TOL = 1e-8
T = 20
P = 256


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def assert_close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def linear():
    """zoo.linear_gaussian(2, 2, r=0.5) on both sides, T = 20 emissions
    sampled by the JAX model."""
    jmodel, jp, jbpf = jzoo.linear_gaussian(2, 2, r=0.5)
    _, em = jmodel.sample(jp, jr.PRNGKey(0), T)
    # the BPF's log-density closes over the template's R: build it at 0.5
    _, template, btemplate = zoo.linear_gaussian(2, 2, r=0.5,
                                                 dtype=torch.float64,
                                                 device="cpu")
    kw = dict(dtype=torch.float64, device="cpu")
    return (jp, jbpf, params_from_jax(jp, template, **kw),
            params_from_jax(jbpf, btemplate, **kw), np.asarray(em))


def run_in_chunks(stepper, state, emissions, bounds, **per_step):
    outs = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        kw = {k: v[lo:hi] for k, v in per_step.items()}
        state, out = stepper.run_chunk(state, emissions[lo:hi], t0=lo, **kw)
        outs.append(out)
    return state, {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def test_ekf_stepper_matches_jax(linear):
    jp, _, tp, _, em = linear
    st = jstream.make_ekf_stepper(jp)
    jstate, jout = st.run_chunk(st.init(), jnp.asarray(em))
    stepper = streaming.make_ekf_stepper(tp)
    state, out = run_in_chunks(stepper, stepper.init(), t(em), [0, 7, 13, T])
    assert_close(out["mean"], jout["mean"])
    assert_close(out["cov"], jout["cov"])
    assert_close(state.marginal_loglik, jstate.marginal_loglik)


def test_ekf_stepper_over_a_batch_equals_the_batched_ekf(linear):
    """Emissions (B, T, dy): the carry and outputs take the batch axis,
    and the chunked run equals the whole-sequence EKF's filtered
    moments and log-likelihood."""
    _, _, tp, _, em = linear
    batch = t(np.stack([em, em[::-1], 0.5 * em]))
    stepper = streaming.make_ekf_stepper(tp)
    state = stepper.init()
    state, out1 = stepper.run_chunk(state, batch[:, :9])
    state, out2 = stepper.run_chunk(state, batch[:, 9:], t0=9)
    want = inference.extended_kalman_filter(tp, batch)
    assert_close(torch.cat([out1["mean"], out2["mean"]], 1),
                 want.filtered_means)
    assert_close(torch.cat([out1["cov"], out2["cov"]], 1),
                 want.filtered_covariances)
    assert_close(state.marginal_loglik, want.marginal_loglik)


def test_gsf_stepper_matches_jax(linear):
    jp, _, tp, _, em = linear
    key = jr.PRNGKey(4)
    st = jstream.make_gsf_stepper(jp, 4)
    jstate, jout = st.run_chunk(st.init(key), jnp.asarray(em))
    eps = t(jr.normal(key, (4, 2), dtype=jnp.float64))
    stepper = streaming.make_gsf_stepper(tp, 4)
    state, out = run_in_chunks(stepper, stepper.init(eps=eps), t(em),
                               [0, 10, T])
    for name in ("weights", "means", "covs"):
        assert_close(out[name], jout[name])
    assert_close(state.marginal_loglik, jstate.marginal_loglik)


def jax_bpf_draws(key, steps, resampler):
    """The normals and uniforms of the JAX stepper's key schedule: one
    split for the initial particles, then three keys a step."""
    key, key_init = jr.split(key)
    init = jr.normal(key_init, (P, 2), dtype=jnp.float64)
    dyn, res = [], []
    for _ in range(steps):
        key, key_prop, key_res = jr.split(key, 3)
        dyn.append(jr.normal(key_prop, (P, 2), dtype=jnp.float64))
        res.append(jr.uniform(key_res, rs.UNIFORM_SHAPES[resampler](P),
                              dtype=jnp.float64))
    return t(init), t(jnp.stack(dyn)), t(jnp.stack(res))


@pytest.mark.parametrize("resampler", ["systematic", "stratified"])
def test_bpf_stepper_matches_jax(linear, resampler):
    jp, jbpf, _, tbpf, em = linear
    key = jr.PRNGKey(1)
    st = jstream.make_bpf_stepper(jbpf, P, resampler=resampler)
    _, jout = st.run_chunk(st.init(key), jnp.asarray(em))
    whole = jgf.bootstrap_particle_filter(jbpf, jnp.asarray(em), P, key,
                                          resampler=resampler,
                                          store="summary")
    init, dyn, res = jax_bpf_draws(key, T, resampler)
    stepper = streaming.make_bpf_stepper(tbpf, P, resampler=resampler)
    state, out = run_in_chunks(stepper, stepper.init(eps=init), t(em),
                               [0, 5, T], draws=list(zip(dyn, res)))
    ess = np.asarray(jout["ess"])
    assert (ess < 0.5 * P).any() and (ess >= 0.5 * P).any()
    assert_close(out["ess"], jout["ess"])
    assert_close(out["mean"], whole["means"])
    kept = ess >= 0.5 * P        # no resampling: the two conventions agree
    assert_close(out["mean"][kept], np.asarray(jout["mean"])[kept])


def test_bpf_stepper_restored_run_continues_the_stream(linear, tmp_path):
    """Drawn from a generator: a run checkpointed after 8 steps and
    restored equals the uninterrupted run, draw for draw."""
    _, _, _, tbpf, em = linear
    stepper = streaming.make_bpf_stepper(tbpf, P)
    whole, out = stepper.run_chunk(
        stepper.init(torch.Generator().manual_seed(3)), t(em))
    state, first = stepper.run_chunk(
        stepper.init(torch.Generator().manual_seed(3)), t(em[:8]))
    path = str(tmp_path / "bpf.pt")
    streaming.save_state(path, state)
    restored = streaming.restore_state(path, state)
    for a, b in zip(restored, state):
        assert torch.equal(a, b)
    state, second = stepper.run_chunk(restored, t(em[8:]), t0=8)
    for name in out:
        assert torch.equal(torch.cat([first[name], second[name]]), out[name])
    for a, b in zip(state, whole):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["ekf", "gsf"])
def test_checkpoint_roundtrip(linear, tmp_path, kind):
    _, _, tp, _, em = linear
    stepper = (streaming.make_ekf_stepper(tp) if kind == "ekf" else
               streaming.make_gsf_stepper(tp, 3))
    state = (stepper.init() if kind == "ekf" else
             stepper.init(torch.Generator().manual_seed(0)))
    state, _ = stepper.run_chunk(state, t(em[:10]))
    path = str(tmp_path / "carry.pt")
    streaming.save_state(path, state)
    restored = streaming.restore_state(path, state)
    assert type(restored) is type(state)
    s1, o1 = stepper.run_chunk(state, t(em[10:]), t0=10)
    s2, o2 = stepper.run_chunk(restored, t(em[10:]), t0=10)
    for name in o1:
        assert torch.equal(o1[name], o2[name])


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

TREES = {
    "finite": lambda: {"a": np.ones(3), "b": (np.zeros(2), 1.5)},
    "nan_in_dict": lambda: {"a": np.array([1.0, np.nan]),
                            "b": [np.ones(2), np.array([np.inf])]},
    "ints_skipped": lambda: {"i": np.array([1, 2]), "x": np.array([-np.inf])},
}


def _as(lib, tree):
    if isinstance(tree, dict):
        return {k: _as(lib, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as(lib, v) for v in tree)
    return lib(tree) if isinstance(tree, np.ndarray) else tree


@pytest.mark.parametrize("name", sorted(TREES))
def test_check_finite_matches_jax(name):
    def outcome(check, tree):
        try:
            check(tree, "posterior")
            return None
        except FloatingPointError as err:
            return str(err)

    want = outcome(jdiag.check_finite, _as(jnp.asarray, TREES[name]()))
    got = outcome(diagnostics.check_finite, _as(torch.tensor, TREES[name]()))
    assert got == want


def test_check_finite_names_namedtuple_fields(linear):
    _, _, tp, _, em = linear
    post = inference.extended_kalman_filter(tp, t(em))
    diagnostics.check_finite(post)
    bad = post._replace(filtered_means=post.filtered_means * np.nan)
    with pytest.raises(FloatingPointError, match=r"\.filtered_means"):
        diagnostics.check_finite(bad, "ekf")


def test_ess_diagnostics_match_jax():
    w = np.random.default_rng(2).dirichlet(np.full(50, 0.3), size=4)
    w[1, :10] = 0.0
    want = jdiag.ess_diagnostics(jnp.asarray(w))
    got = diagnostics.ess_diagnostics(t(w))
    assert set(got) == set(want)
    for name in want:
        assert_close(got[name], want[name], 1e-15)


def test_debug_nans_raises_on_a_plain_and_a_kernel_op():
    x = torch.tensor([1.0, -1.0], dtype=torch.float64)
    torch.sqrt(x)                       # outside the block: no check
    with pytest.raises(FloatingPointError, match="sqrt"):
        with diagnostics.debug_nans():
            torch.sqrt(x)
    Fx = torch.eye(2, dtype=torch.float64)[None]
    Q = torch.tensor([[np.nan, 0.0], [0.0, 1.0]], dtype=torch.float64)
    with diagnostics.debug_nans():
        fused_ekf.fused_predict_cov(Fx, Fx, Fx, torch.eye(2).double())
        with pytest.raises(FloatingPointError):
            fused_ekf.fused_predict_cov(Fx, Fx, Fx, Q)
    with diagnostics.debug_nans(False):
        torch.sqrt(x)


def test_benchmarks_and_trace_on_the_cpu(tmp_path):
    res = diagnostics.benchmark(lambda x: (x ** 2).sum(), torch.ones(128),
                                num_runs=2)
    assert res.num_runs == 2 and 0 < res.best <= res.mean
    on = diagnostics.benchmark_on_device(lambda x: x @ x,
                                         torch.ones(10, 16, 16),
                                         reps=(2, 10), num_runs=1)
    assert on.reps == (2, 10) and len(on.walls) == 2
    with pytest.raises(ValueError):
        diagnostics.benchmark_on_device(lambda x: x, torch.ones(3, 2))
    with diagnostics.trace(str(tmp_path)) as prof:
        torch.ones(4) @ torch.ones(4)
    assert (tmp_path / "trace.json").exists()
    assert len(prof.key_averages()) > 0
