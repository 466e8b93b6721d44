"""The AGSF's adaptive splitting against the JAX package, on the CPU:
``autocov="sdp"`` (the fixed-point solver of ``utils/sdp.py``) and
``autocov="trace"`` on the quadratic-measurement model and on
bearings-only tracking, and every option's run from a generator alone.

The JAX filters run once each in a module fixture (``agsf_parity``:
jitted, compiled at XLA's lowest backend optimisation level) at T = 8,
and the port gets the normals of JAX's key schedule. Tolerance 1e-8
relative to max(1, max|reference|), float64.
"""
import jax
import jax.random as jr
import pytest
import torch

from agsf_parity import (
    POSTERIOR,
    T,
    assert_close,
    jax_agsf_draws,
    problem,
    run_case,
    t,
)
from bayesianfiltering_tpu_torch import inference as inf

torch.set_num_threads(1)

# (label, model, filter, components, keyword arguments)
CASES = [
    ("agsf sdp quadratic", "quadratic_measurement", "augmented", (3, 2, 2),
     dict(opt_args=(0.8, 1.0), autocov="sdp", reduction="topk")),
    ("agsf trace quadratic", "quadratic_measurement", "augmented", (3, 2, 2),
     dict(opt_args=(0.8, 1.0), autocov="trace", reduction="topk")),
    ("agsf sdp bot", "bearings_only_tracking", "augmented", (3, 2, 2),
     dict(opt_args=(0.1, 0.1), autocov="sdp", reduction="topk")),
    ("agsf trace bot", "bearings_only_tracking", "augmented", (3, 2, 2),
     dict(opt_args=(0.1, 0.1), autocov="trace", reduction="topk")),
]


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


class LazyCases(dict):
    """Each case's (JAX, port) results, run when a test first asks for
    them and kept for the module: a case's JAX compile is charged to its
    own test, not all of them to the first."""

    def __missing__(self, label):
        i, c = next((i, c) for i, c in enumerate(CASES) if c[0] == label)
        self[label] = run_case(*c[1:], seed=i + 1)
        return self[label]


@pytest.fixture(scope="module")
def results(x64):
    return LazyCases()


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_adaptive_splitting_matches_jax_with_its_draws(results, label):
    (want, want_aux), (got, got_aux) = results[label]
    for name in POSTERIOR:
        assert_close(getattr(got, name), getattr(want, name))
    for name in ("Deltas", "Lambdas", "pre_weights", "gain"):
        assert_close(got_aux[name], want_aux[name])


def test_splitting_covariances_stay_between_zero_and_p(results):
    """0 ⪯ Δ ⪯ P for every component and step, both rules, on BOT."""
    for label in ("agsf sdp bot", "agsf trace bot"):
        _, (_, aux) = results[label]
        assert torch.isfinite(aux["Deltas"]).all()
        assert float(torch.linalg.eigvalsh(aux["Deltas"]).min()) > -1e-9


def test_options_run_from_a_generator():
    """Every option runs from a ``torch.Generator`` alone, and
    ``compat_fixed_keys`` reuses one step's draws: its initial means come
    from a generator seeded 0, whatever the caller's seed."""
    _, tparams, _, ys = problem("sine_quadratic")
    runs = [inf.augmented_gaussian_sum_filter(
        tparams, t(ys), [3, 2, 2], torch.Generator().manual_seed(s),
        opt_args=(0.8, 1.0), autocov=a, compat_fixed_keys=True)[0]
        for s, a in ((1, "sdp"), (2, "trace"))]
    for post in runs:
        assert torch.isfinite(post.means).all()
    with pytest.raises(ValueError):
        inf.augmented_gaussian_sum_filter(
            tparams, t(ys), [3, 2, 2], compat_fixed_keys=True,
            draws=jax_agsf_draws(jr.PRNGKey(0), T, 3, 2, 2, 1,
                                 "multinomial"))
    opt = inf.augmented_gaussian_sum_filter_optimal(
        tparams, t(ys), [3, 2, 2], torch.Generator().manual_seed(3))[0]
    assert torch.isfinite(opt.weights).all()
