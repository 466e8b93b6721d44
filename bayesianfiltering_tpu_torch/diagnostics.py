"""Observability: profiling, benchmarking and numerical-failure detection
(counterpart of ``bayesianfiltering_tpu/diagnostics.py``).

:func:`benchmark` and :func:`benchmark_on_device` time on the card with
CUDA events (on CPU tensors, with the host's clock); :func:`trace` wraps
``torch.profiler``; :func:`debug_nans` raises on the first NaN an
operation produces inside its block; :func:`check_finite` and
:func:`ess_diagnostics` check results on the host.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Mapping, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bayesianfiltering_tpu_torch import _build
from bayesianfiltering_tpu_torch.models._fit import tree_map
from bayesianfiltering_tpu_torch.models.parameters import _leaves


def _tensors(tree):
    """The tensors of a nest of NamedTuples, dicts, lists and tuples."""
    return [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]


def _on_card(*trees) -> bool:
    return any(t.is_cuda for tree in trees for t in _tensors(tree))


class _Clock:
    """Elapsed seconds of a block: CUDA events on the card, the host's
    clock (after the card has finished, where it is used) otherwise."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def __enter__(self):
        if self.cuda:
            self.start, self.end = (torch.cuda.Event(enable_timing=True)
                                    for _ in range(2))
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            self.seconds = self.start.elapsed_time(self.end) / 1e3
        else:
            self.seconds = time.perf_counter() - self.t0


class BenchmarkResult(NamedTuple):
    best: float          # best steady-state wall-clock (s)
    mean: float
    compile_time: float  # first call (kernel build + run)
    num_runs: int

    def steps_per_sec(self, num_steps: int) -> float:
        return num_steps / self.best


def benchmark(fn: Callable, *args, num_runs: int = 3,
              **kwargs) -> BenchmarkResult:
    """Time ``fn(*args, **kwargs)``: the first call (which builds the
    kernels on first use) apart, then the best and mean of ``num_runs``
    steady-state calls. Where the arguments or the result lie on the card
    each call is timed by CUDA events, which wait for its work."""
    if _on_card(args, kwargs):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    cuda = _on_card(args, kwargs, out)
    if cuda:
        torch.cuda.synchronize()
    compile_time = time.perf_counter() - t0
    times = []
    for _ in range(num_runs):
        with _Clock(cuda) as clock:
            fn(*args, **kwargs)
        times.append(clock.seconds)
    return BenchmarkResult(min(times), sum(times) / len(times), compile_time,
                           num_runs)


class OnDeviceResult(NamedTuple):
    per_call: float       # device seconds per fn call, dispatch cancelled
    walls: tuple          # best wall for each K in reps
    reps: tuple

    def steps_per_sec(self, num_steps: int) -> float:
        return num_steps / self.per_call


def benchmark_on_device(fn: Callable, inputs, reps=(2, 10),
                        num_runs: int = 3) -> OnDeviceResult:
    """The per-call time of ``fn`` without its fixed costs: for each ``K``
    in ``reps``, the best of ``num_runs`` timed runs of K calls, each on
    slice i of ``inputs`` (a nest of tensors with a leading axis of at
    least ``max(reps)``) and its outputs summed, so that each call is
    consumed; the per-call time is the slope
    ``(wall_K2 − wall_K1) / (K2 − K1)``, in which a run's fixed cost
    cancels. Timed with CUDA events where ``inputs`` lie on the card."""
    n = _tensors(inputs)[0].shape[0]
    if n < max(reps):
        raise ValueError(f"inputs leading axis {n} < max(reps)={max(reps)}")
    cuda = _on_card(inputs)

    def run(k):
        acc = torch.zeros((), dtype=torch.float32,
                          device=_tensors(inputs)[0].device)
        for i in range(k):
            sl = tree_map(lambda x: x[i] if isinstance(x, torch.Tensor)
                          else x, inputs)
            for leaf in _tensors(fn(sl)):
                acc = acc + leaf.sum().to(torch.float32)
        return acc

    walls = []
    for k in reps:
        run(k)                                   # warm-up
        best = float("inf")
        for _ in range(num_runs):
            with _Clock(cuda) as clock:
                run(k)
            best = min(best, clock.seconds)
        walls.append(best)
    per_call = (walls[-1] - walls[0]) / (reps[-1] - reps[0])
    return OnDeviceResult(per_call, tuple(walls), tuple(reps))


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` around a block (the CPU, and the card where
    there is one); the Chrome trace is written to ``logdir/trace.json``
    at the end. Yields the profiler, whose ``key_averages()`` sum the
    time by operation and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# factory operations hand back memory nobody has written yet
_UNWRITTEN = ("empty", "empty_like", "new_empty", "empty_strided",
              "new_empty_strided", "empty_permuted")


def _raise_on_nan(name: str, out) -> None:
    for t in _tensors(out):
        if (t.is_floating_point() or t.is_complex()) and bool(
                torch.isnan(t).any()):
            raise FloatingPointError(f"NaN in the output of {name}")


class _NanMode(TorchDispatchMode):
    """Checks the output of every ATen operation."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNWRITTEN:
            _raise_on_nan(str(func), out)
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise FloatingPointError on the first NaN an operation produces
    inside the block.

    Covers every ATen operation (a ``TorchDispatchMode``: the plain
    PyTorch code, the kernels' plain versions on CPU tensors, and autograd's
    backward when it runs inside the block) and the outputs of every CUDA
    kernel launched through ``_build.kernel_op`` (K1–K4 and K6–K12 with
    their variants; K5's outputs are integers). It does not see what a
    kernel writes before its wrapper returns, nor operations outside
    PyTorch. Each check reads the result on the host, so a block under it
    synchronises after every operation."""
    if not enable:
        yield
        return
    previous = _build.nan_check
    _build.nan_check = _raise_on_nan
    try:
        with _NanMode():
            yield
    finally:
        _build.nan_check = previous


def check_finite(tree, name: str = "pytree") -> None:
    """Host-side assertion that every floating leaf of ``tree`` is finite;
    raises FloatingPointError naming the paths of the others (``.field``
    of a NamedTuple, ``['key']`` of a dict, ``[i]`` of a list or tuple)."""
    bad = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for k, v in zip(node._fields, node):
                walk(v, f"{path}.{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        else:
            t = torch.as_tensor(node)
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                bad.append(path)

    walk(tree, "")
    if bad:
        raise FloatingPointError(f"non-finite values in {name} at: {bad}")


def ess_diagnostics(weights: torch.Tensor) -> dict:
    """Weight-health metrics for mixture/particle banks: ESS, max weight,
    entropy."""
    w = weights / weights.sum(-1, keepdim=True)
    ess = 1.0 / (w * w).sum(-1)
    entropy = -torch.where(w > 0, w * torch.log(w),
                           torch.zeros_like(w)).sum(-1)
    return {"ess": ess, "max_weight": w.amax(-1), "entropy": entropy}


__all__ = ["BenchmarkResult", "benchmark", "trace", "debug_nans",
           "check_finite", "ess_diagnostics"]
