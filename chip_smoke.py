"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. Environment: torch and CUDA versions, the card's name and power limit.
2. Build the CUDA kernels (K1–K4) from ``bayesianfiltering_tpu_torch/csrc``.
3. Each kernel against its plain PyTorch twin on the card, float32 and
   float64, at the main path's shapes and at its size band's edge; a
   non-positive-definite S must give NaN on both sides. Times each kernel
   and its twin with CUDA events at the main-path shape.
4. Kernel path (card) against plain path (CPU) end to end: the batched EKF
   on Lorenz-96, the GSF and the AGSF on bearings-only tracking, with the
   same data and the same draws.
5. The main path, with every launch counter reset just before: the
   batched EKF on Lorenz-96 (dx=64, dy=32, B=512 sequences, T=1000; data
   from the RK4 model, filter on the Euler model), timed with CUDA events
   after a warm-up; then the GSF (M=50) and the AGSF [50,2,2] at T=100 and
   the AGSF [8,2,2] at T=12 on bearings-only tracking. Checks finiteness,
   shapes and that every kernel of the path was launched.

The last three lines: a JSON object describing each kernel, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# Kernel-vs-twin tolerances on max|kernel − twin| / max(1, max|twin|): the
# kernel and its twin compute the same formulas in another summation order
# (and the twin factors S with cuSOLVER), so they differ by rounding only.
# float64 separates algorithm bugs from rounding; the float32 bound leaves
# room for S's conditioning at the band edge (dy=128).
KERNEL_TOL = {"float32": 1e-3, "float64": 1e-10}
# End-to-end, kernel path on the card vs plain path on the CPU, same inputs:
# float64 per-step rounding (~1e-15) stays far below 1e-8 over 100 steps
# of a filter that contracts errors; float32 (~1e-7 per step) is held to
# 5e-3 on Lorenz-96 states of magnitude ~10.
EKF_TOL = {"float32": 5e-3, "float64": 1e-8}
# GSF/AGSF are compared in float64 only: the reduction's resampling is
# discontinuous in the weights, so float32 rounding may legitimately pick
# another component and the paths would part.
MIXTURE_TOL = 1e-8

EKF_DX, EKF_DY, EKF_B, EKF_T = 64, 32, 512, 1000
CMP_B, CMP_T = 16, 100


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def rel_err(a, b) -> float:
    import torch

    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) / max(1.0, float(b[~torch.isnan(b)].abs().max()))


def cuda_time_ms(fn, reps: int = 50) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 3: kernels against their twins
# ---------------------------------------------------------------------------

def check_kernels(dev) -> dict:
    import numpy as np
    import torch

    from bayesianfiltering_tpu_torch import testing
    from bayesianfiltering_tpu_torch.ops import bank_update as bu
    from bayesianfiltering_tpu_torch.ops import fused_ekf as fe

    # (kernel, wrapper, plain twin, shape name, make inputs, main path?)
    upd = lambda B, dx, dy: lambda rng: testing.update_inputs(rng, B, dx, dy)
    pred = lambda B, dx, dq: lambda rng: testing.predict_inputs(rng, B, dx, dq)
    cases = [
        (fe.K1, fe.fused_update, fe._update_plain, "B=512,dx=64,dy=32",
         upd(512, 64, 32), True),
        (fe.K1, fe.fused_update, fe._update_plain, "B=2,dx=512,dy=128",
         upd(2, 512, 128), False),
        (fe.K2, fe.fused_predict_cov, fe._predict_plain, "B=512,dx=64,dq=64",
         pred(512, 64, 64), True),
        (fe.K2, fe.fused_predict_cov, fe._predict_plain, "B=2,dx=512,dq=512",
         pred(2, 512, 512), False),
        (bu.K3, bu.bank_chol_update, bu._update_plain, "M=200,dx=4,dy=1",
         upd(200, 4, 1), True),
        (bu.K3, bu.bank_chol_update, bu._update_plain, "M=4096,dx=8,dy=8",
         upd(4096, 8, 8), False),
        (bu.K4, bu.bank_predict_cov, bu._predict_cov_plain, "M=200,dx=4,dq=2",
         pred(200, 4, 2), True),
        (bu.K4, bu.bank_predict_cov, bu._predict_cov_plain, "M=4096,dx=8,dq=8",
         pred(4096, 8, 8), False),
    ]
    report = {}
    for kernel, wrapper, plain, shape, make, main in cases:
        raw = make(np.random.default_rng(SEED))
        is_update = len(raw) == 5
        for dtype in (torch.float32, torch.float64):
            args = [torch.as_tensor(a, dtype=dtype, device=dev) for a in raw]
            if is_update:
                args.append(0.0)
            before = kernel.launches
            got = wrapper(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                raise RuntimeError(f"{kernel.name} did not launch at {shape}")
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            name = str(dtype).split(".")[-1]
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            ok = max(errs) <= KERNEL_TOL[name]
            log(f"kernel {kernel.name} {shape} {name}: rel err "
                f"{max(errs):.3e} (tol {KERNEL_TOL[name]:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok or not all(torch.isfinite(g).all() for g in got):
                raise RuntimeError(f"{kernel.name} disagrees with its twin "
                                   f"at {shape} {name}: {errs}")
            if main and dtype == torch.float32:
                abs_err = max(float((g - w).abs().max())
                              for g, w in zip(got, want))
                ms = cuda_time_ms(lambda: wrapper(*args))
                plain_ms = cuda_time_ms(lambda: plain(*args))
                report[kernel.name] = dict(shape=shape, max_abs_err=abs_err,
                                           ms=ms, plain_ms=plain_ms)
                log(f"  time at {shape} float32: kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms")
        if is_update and main:
            # a non-PD S gives NaN on both sides, never an exception
            bad = [torch.as_tensor(a, dtype=torch.float64, device=dev)
                   for a in raw] + [0.0]
            bad[3] = -1e3 * torch.eye(bad[3].shape[-1], dtype=bad[3].dtype,
                                      device=dev).expand_as(bad[3])
            got, want = wrapper(*bad), plain(*bad)
            torch.cuda.synchronize()
            if not (torch.isnan(got[0]).all() and torch.isnan(want[0]).all()
                    and torch.isnan(got[1]).all()):
                raise RuntimeError(f"{kernel.name}: non-PD S did not give NaN")
            log(f"kernel {kernel.name} non-PD S: NaN on both sides ok")
    return report


# ---------------------------------------------------------------------------
# Phases 4 and 5
# ---------------------------------------------------------------------------

def lorenz96_data(dev, dtype):
    import torch

    from bayesianfiltering_tpu_torch.models import zoo

    _, params, _ = zoo.lorenz96(EKF_DX, EKF_DY, dtype=dtype, device=dev)
    data_model, data_params, _ = zoo.lorenz96(EKF_DX, EKF_DY,
                                              integrator="rk4", dtype=dtype,
                                              device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states, emissions = data_model.sample(data_params, EKF_T, generator=gen,
                                          batch_shape=(EKF_B,))
    if not torch.isfinite(emissions).all():
        raise RuntimeError("Lorenz-96 RK4 data are not finite")
    return params, states, emissions


def bot_problem(T, dtype, dev):
    import torch

    from bayesianfiltering_tpu_torch.models import zoo

    model, params, _ = zoo.bearings_only_tracking(dtype=dtype, device=dev)
    inputs = zoo.bot_maneuver_inputs(T, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + T)
    states, emissions = model.sample(params, T, inputs=inputs, generator=gen)
    return params, inputs, states, emissions


MIXTURE_RUNS = [
    # (label, components, T): README quick start at the size users run it,
    # and the graft entry's flagship AGSF
    ("gsf M=50", 50, 100),
    ("agsf [50,2,2]", [50, 2, 2], 100),
    ("agsf [8,2,2]", [8, 2, 2], 12),
]


def run_mixture(label, comps, params, inputs, emissions, draws):
    from bayesianfiltering_tpu_torch import inference as inf

    if label.startswith("gsf"):
        post = inf.gaussian_sum_filter(params, emissions, comps,
                                       inputs=inputs, init_eps=draws.init)
        return post, None
    return inf.augmented_gaussian_sum_filter(
        params, emissions, comps, inputs=inputs, reduction="systematic",
        draws=draws)


def mixture_draws(comps, T, dx, like):
    import torch

    from bayesianfiltering_tpu_torch import inference as inf

    comps = comps if isinstance(comps, list) else [comps, 1, 1]
    gen = torch.Generator(device=like.device).manual_seed(SEED + 1)
    return inf.agsf_draws(gen, T, comps, dx, "systematic", like)


def compare_paths(dev) -> None:
    """Phase 4: kernel path on the card vs plain path on the CPU."""
    import torch

    from bayesianfiltering_tpu_torch import inference as inf
    from bayesianfiltering_tpu_torch.models import zoo

    _, _, em64 = lorenz96_data(dev, torch.float64)
    em64 = em64[:CMP_B, :CMP_T]
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        em = em64.to(dtype)
        params = {d: zoo.lorenz96(EKF_DX, EKF_DY, dtype=dtype, device=d)[1]
                  for d in (dev, "cpu")}
        got = inf.extended_kalman_filter(params[dev], em)
        want = inf.extended_kalman_filter(params["cpu"], em.cpu())
        torch.cuda.synchronize()
        e_m = rel_err(got.filtered_means, want.filtered_means)
        e_ll = rel_err(got.marginal_loglik, want.marginal_loglik)
        ok = max(e_m, e_ll) <= EKF_TOL[name]
        log(f"ekf lorenz96 B={CMP_B} T={CMP_T} {name} card vs cpu: means "
            f"{e_m:.3e}, loglik {e_ll:.3e} (tol {EKF_TOL[name]:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("EKF kernel path disagrees with the plain path")

    for label, comps, T in MIXTURE_RUNS:
        params, inputs, _, emissions = bot_problem(T, torch.float64, dev)
        draws = mixture_draws(comps, T, 4, emissions)
        got, _ = run_mixture(label, comps, params, inputs, emissions, draws)
        cpu_params = zoo.bearings_only_tracking(dtype=torch.float64)[1]
        cpu_draws = type(draws)(*(None if d is None else d.cpu() for d in draws))
        want, _ = run_mixture(label, comps, cpu_params, inputs.cpu(),
                              emissions.cpu(), cpu_draws)
        torch.cuda.synchronize()
        errs = [rel_err(got.means, want.means), rel_err(got.weights, want.weights),
                rel_err(got.marginal_loglik, want.marginal_loglik)]
        ok = max(errs) <= MIXTURE_TOL
        log(f"{label} T={T} float64 card vs cpu: means {errs[0]:.3e}, weights "
            f"{errs[1]:.3e}, loglik {errs[2]:.3e} (tol {MIXTURE_TOL:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label} kernel path disagrees with the plain path")


def main_path(dev, card: str) -> dict:
    """Phase 5: the main path with fresh launch counters."""
    import torch

    from bayesianfiltering_tpu_torch import _build
    from bayesianfiltering_tpu_torch import inference as inf

    params, _, emissions = lorenz96_data(dev, torch.float32)
    bot = {T: bot_problem(T, torch.float32, dev) for _, _, T in MIXTURE_RUNS}
    draws = {label: mixture_draws(comps, T, 4, bot[T][3])
             for label, comps, T in MIXTURE_RUNS}
    # warm-up: a short EKF run at the full batch and width
    inf.extended_kalman_filter(params, emissions[:, :20])
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    post = inf.extended_kalman_filter(params, emissions)
    end.record()
    torch.cuda.synchronize()
    secs = start.elapsed_time(end) / 1e3
    counts = {k.name: k.launches for k in _build.KERNELS}
    if tuple(post.filtered_means.shape) != (EKF_B, EKF_T, EKF_DX):
        raise RuntimeError(f"EKF means shape {tuple(post.filtered_means.shape)}")
    if not (torch.isfinite(post.filtered_means).all()
            and torch.isfinite(post.marginal_loglik).all()):
        raise RuntimeError("EKF outputs are not finite")
    for name in ("bft_ekf_update", "bft_ekf_predict_cov"):
        if counts[name] < EKF_T:
            raise RuntimeError(f"{name} launched {counts[name]} times, "
                               f"expected at least {EKF_T}")
    rate = EKF_B * EKF_T / secs
    log(f"ekf lorenz96 dx={EKF_DX} dy={EKF_DY} B={EKF_B} T={EKF_T} float32: "
        f"{secs:.3f} s, launches {counts}")
    log(f"timestep-equiv/s: {rate:.1f} ({card})")

    before = dict(counts)
    for label, comps, T in MIXTURE_RUNS:
        params_b, inputs, states, em = bot[T]
        t0 = time.perf_counter()
        post, _ = run_mixture(label, comps, params_b, inputs, em, draws[label])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        M = post.means.shape[0]
        if tuple(post.means.shape) != (M, T, 4) or not (
                torch.isfinite(post.means).all()
                and torch.isfinite(post.weights).all()
                and torch.isfinite(post.marginal_loglik)):
            raise RuntimeError(f"{label}: outputs not finite or misshapen")
        est = (post.weights[..., None] * post.means).sum(0)
        rmse = float(((est - states) ** 2).mean().sqrt())
        log(f"{label} bot T={T} float32: wall {wall:.3f} s, rmse {rmse:.4f}, "
            f"loglik {float(post.marginal_loglik):.3f}")
    counts = {k.name: k.launches for k in _build.KERNELS}
    for name in ("bft_bank_update", "bft_bank_predict_cov"):
        if counts[name] <= before[name]:
            raise RuntimeError(f"{name} was not launched by the GSF/AGSF runs")
    log(f"launches over the main path: {counts}")
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "bayesianfiltering_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    card = nvidia_smi()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"card: {card}")
    dev = torch.device("cuda", 0)

    from bayesianfiltering_tpu_torch import _build

    _build.load()
    log(f"kernel build: {_build.build_seconds:.1f} s")
    entry = "?"
    for line in _build.build_log.splitlines():
        found = re.search(r"([a-z_]+_kernel)I([fd])E?(Li(\d))?", line)
        if "Compiling entry function" in line and found:
            entry = f"{found[1]}<{'float' if found[2] == 'f' else 'double'}" \
                    + (f",{found[4]}>" if found[4] else ">")
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {entry}: {line.strip()}")

    timing = check_kernels(dev)
    compare_paths(dev)
    counts = main_path(dev, card)

    kernels = []
    for k in _build.KERNELS:
        t = timing[k.name]
        kernels.append({"name": k.name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces, "launches": counts[k.name],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "shape": t["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
