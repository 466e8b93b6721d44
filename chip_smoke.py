"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --ab PARENT_ROOT [PART ...]`` instead times the
sigma-point kernels, K1t and K8t, K8 and K9 at the Lorenz-96 UKF's and the
range-bearing banks' shapes in both dtypes, the Lorenz-96 UKF's walls,
K1 and K2 at the batched Lorenz-96 EKF's and the bearings-only shapes in
both dtypes, the Lorenz-96 EKF's wall, K10b and K12b at path C's three
shapes, K10b's block sizes, the walls of path B and of path C's two
solvers, K10 and K12 at path B's five shapes and K11 at its one and at
dx = 8 with F banked in both dtypes, and K11b at path C's shape and with F banked in both dtypes, K3
and K4 at the mixture paths' banks and at their band edge in both dtypes
and the GSF M=50 and AGSF [50,2,2] walls, K5 at path A's n = 1M on five
weight profiles and at the reductions' (m, n) beside torch.searchsorted,
the device time of each part of a resampling step and path A's wall, of a
parent checkout and of this one in turns on the same card, or only the
parts named: ``sigma``, ``ut``, ``ekf``, ``combine``, ``bank``,
``resample``; see ``ab``.)

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. Environment: torch and CUDA versions, the card's name and power limit.
2. Build the CUDA kernels (K1–K12, the tiled variants K1t/K2t of the EKF
   update and predict, K6t/K7t of the sigma points and K8t/K9t of the UT
   update and predict, and the block variants K10b–K12b of the combines
   above dx = 8) from
   ``bayesianfiltering_tpu_torch/csrc``, one nvcc per source, in
   parallel.
3. First, the CUDA launches a call of K8t (at most 4), K2t (at most 2),
   K9t (at most 2) and K7t (Cholesky, 1), counted by torch.profiler. Each kernel against its plain PyTorch
   version on the card, float32 and
   float64, at the main paths' shapes and at path N's (K1t at dx = 2,048,
   dy = 1,024 and 128, K2t at dx = dq = 2,048, K6t at n = 2,048, K7t at
   dx = dn = 1,024, K8t and K9t at 4,096 points, the block combines and
   elements at dx = 1,024; the block combines also at dx = 9, 64
   and 512; the EKF, sigma-point and UT update and predict kernels also at
   shapes that are not multiples of a tile and on both sides of the rules
   that pick K1/K2 or K1t/K2t, K6/K7 or K6t/K7t and K8/K9 or K8t/K9t, each
   shape expecting the kernel the rule names); a
   non-positive-definite S or P must give NaN on both sides (K1t, K6t, K7t
   and K8t with the failing pivot in their first and in a later panel; K7
   and K7t NaN only the failing block), and K10's
   guard lanes (a C1 with a −1e-8 eigenvalue, a C1 with an infinite entry)
   the same finite and non-finite entries (dx = 4 to 512). K11 also with
   one F a lane (banked), at path D's (M = 499, dx = 4) and path E's
   (M = T − 1, dx = 1) elements, and K10 and K12 at dx = 1 over path E's
   lanes. K3 and K4 also at paths F's and G's banks (dx = 1 and 3), K7–K9
   at path F's UKF banks (na = 2). K5 (integer
   parents) must equal its plain version exactly at n = 2²⁰, 65,536,
   1,408 (m + n one stretch of its merge path), and the bootstrap PFs'
   100 and 20,000 (paths F, G; timed too) on five weight profiles,
   and at the Gaussian-sum reductions' m counts → n
   slots. Times each kernel and its plain version with CUDA events at the
   main-path shapes (float32; K1/K2, K1t, K2t, K6t, K8t, K9t, K10, K11b
   and K12 float64 too; K10 and K12 at path B's five shapes, K3 and K4
   at the mixture paths' three banks each) and computes its
   bound (bytes over 3.35 TB/s or flops over the peak rate, whichever is
   larger), and its device time: CUDA events around calls queued behind a
   device-side sleep, so that the wrapper's host time is hidden (the
   CUDA-event time of a plain loop of wrapper calls is the host's time
   where the kernel is shorter than its wrapper); torch.profiler's time
   per recorded launch is logged beside it with its count, since the
   profiler drops some launches' records; K5 also gets the time of
   ``torch.searchsorted``, one PyTorch call computing its function, and
   both are timed by device time alike, and by CUDA events around a CUDA
   graph of 100 calls; K6 and K6t get the device time of
   ``torch.linalg.cholesky_ex`` on the same P, the one PyTorch call for
   the factor in their body.
4. Kernel path (card) against plain path (CPU) end to end, with the same
   data and the same draws: the batched EKF and UKF (additive and
   augmented) on Lorenz-96, the GSF and AGSF on bearings-only tracking, the
   UGSF and UAGSF on range-bearing tracking, the bootstrap PF (float64,
   65,536 particles, so K5 runs) on Lorenz-96 dx=8, the parallel
   Kalman smoother at T=4,096, chunk 128, BASELINE config 5 (Lorenz-96
   dx=512, dy=256, float64, T=20: the EKF's joint and chunked updates and
   the additive UKF), path N (the same three filters at dx=2,048,
   dy=1,024, T=3, and the parallel smoother at dx=1,024, dy=512, T=8,
   float64, each with its exact launches), path C (the parallel smoother
   at dx=64, dy=32,
   T=1,024, both solvers, float32 and float64), the time-varying parallel
   filter and smoother at the BOT widths (dx=4, T=250) and at path C's
   (T=1,024, per-step F: K10b, K11b with F banked, K12b), float32 and
   float64, path D's five smoothers at T=100 with 3 iterations in
   float64, and, in float64 at T=20: the AGSF [3,2,2] on Experiment A's
   model with autocov "sdp" and "trace", the AGSF and the UAGSF with the
   optimal reduction and the AGSF with ``compat_fixed_keys`` on the
   stochastic-volatility model (regime switch at T/2), the reference-exact
   EKF (``compat_scalar``) on the quadratic-measurement model,
   ``ekf_step`` over 16 Lorenz-63 states, and the steady-state filter and
   smoother on path B's model at T=4,096 (no launches); and, for paths
   I–K and the streaming steppers, in float64 at 1e-8:
   ``LinearGaussianSSM.fit_em`` on path B's model at T=8,192 (K10–K12),
   extended EM and ``fit_sgd`` on the Lorenz-96 model at B=2, T=20 (K1,
   K2), the unscented E-step on the UNGM at T=100 (K7–K9), the EKF, GSF
   and BPF steppers in chunks with a checkpoint round trip (K1/K2, K3/K4,
   K5 with the same draws); and every legacy (v0) class and estimator in
   float64 at T=20 with the same draws, at 1e-8: ``SSM.simulate``, MCF,
   EKF of order 1 and 2, UKF, MCLAF, the composite and the standalone
   Gaussian-sum banks, the original AGSF [3,2,2] in each selection mode,
   the legacy BPF at 4,096 particles (K5 once a step), the mean
   estimators' comparison, ``AugmentedJointApproximation`` and the oldest
   ALA API; each with its exact launches (none but the BPF's); and the
   multi-device layer: two ranks sharing the card over gloo (spawned
   after phase 2's build, so that they load its library) run every
   function of ``parallel/`` in float64 at a small size on the card and
   on the CPU with the same draws, at 1e-8, and against the
   single-process function on the card (``batched_filter`` of the EKF,
   the BPF in both modes at 4,096 particles, the GSF M=8, the AGSF
   [4,2,2] gathered, local and with UKF moments, the time-sharded filter
   and smoother at T=4,096 and the time-sharded IEKS at T=64), each rank
   with its exact launches; the dry run in one rank over NCCL and on four
   ranks over gloo. These spawned jobs run beside the phase's other
   checks.
5. The main paths, each with every launch counter reset just before it and
   read just after: the batched EKF on Lorenz-96 (dx=64, dy=32, B=512
   sequences, T=1000; data from the RK4 model, filter on the Euler model);
   the GSF and AGSF on bearings-only tracking (the AGSF's systematic
   reduction runs K5 once per step); the batched UKF on the same
   Lorenz-96 data, additive and augmented (Cholesky sigma points, T=1000)
   and additive with the Newton–Schulz root (T=100); the UGSF (M=100) and
   the UAGSF ([16,2,2], systematic, K5 once per step) on range-bearing
   tracking at T=500;
   the bootstrap PF at 1M particles on Lorenz-96 dx=8, dy=4, T=100
   (systematic, ESS threshold 0.5; K5 once per resampling step); the
   parallel Kalman smoother at T=1M, dx=4, dy=2, chunk 128 (K10 and K12
   320 times each, K11 once); BASELINE config 5 (Lorenz-96 dx=512,
   dy=256, one sequence, T=200: the EKF with the joint update, the EKF with
   ``update_chunk=128`` — K1t/K2t, never K1/K2 — and the additive UKF —
   K6t, K8t and K9t, never K6/K8/K9); path N, config 5's model at
   dx=2,048, dy=1,024, T=20 (``ekf2048``: K1t at dy = 1,024 and K2t at
   dx = dq = 2,048; with ``update_chunk=128`` 8 × 128; ``ukf2048``: K6t at
   n = 2,048, K8t and K9t at 4,096 points) and the parallel smoother on
   ``zoo.linear_gaussian_lgssm(1024, 512)`` (Woodbury, chunk 128,
   T=PN_S_T: K10b, K11b and K12b at dx = 1,024);
   path C (the parallel smoother
   on ``zoo.linear_gaussian_lgssm(64, 32)`` at T=65,536, chunk 128, both
   solvers: only the block combines launch); path D, the BOT smoothing
   comparison of experiments/smoother_experiment.py (range-bearing
   tracking, T=250, 8 iterations: the ERTS, the URTS, the IEKS, the
   LM-IEKS and the IPLS, with their RMSE against the sampled states);
   path E, the IEKS row of experiments/parallel_kf_bench.py (the UNGM,
   3 iterations, chunk 128, the rollout nominal, T=2^15; the rollout
   alone timed at 16,384 steps); path F, Experiment A of
   experiments/expa_experiment.py (``zoo.sine_quadratic()``, T=100: the
   GSF M=5, the UGSF M=3, the AGSF [3,2,2] with autocov "prop", "trace"
   and "sdp", the UAGSF [3,2,2] with "trace", a BPF of 100 particles) and
   path G, the regime switch of experiments/adaptive_experiment.py
   (``zoo.stochastic_volatility()``, T=100, inputs 1 from T/2: the GSF
   M=20, the AGSF [20,2,2], the AGSF-optimal [20,2,2], a BPF of 20,000
   particles), each filter on 2 sequences with its wall's median and range
   and its mean RMSE; path H, the steady-state filter and smoother on path
   B's model and data (T=1M, head 64, 128 Riccati iterations: no kernel),
   with the largest gap to path B's parallel smoother; path I, exact EM
   (``LinearGaussianSSM.fit_em``) on path B's model and data at T=1M, 3
   iterations (K10/K12 960 times, K11 3); path J, extended EM on the
   Lorenz-96 EKF's model and data at B=16, T=1000, 1 iteration (K1/K2
   1,000 each); path K, ``fit_sgd`` on the same model at B=32, T=200, Q
   and R under RealToPSD, Adam, 2 steps (K1/K2 400 each forward, the plain
   versions backward); the EKF stepper on the Lorenz-96 batch (B=512,
   T=200), the GSF stepper on bearings-only tracking (M=50, T=100) and the
   BPF stepper at 1M particles (T=100), each in chunks of 50 with a
   checkpoint round trip after the second, against the whole-sequence
   filter; path L, the legacy (v0) API at the sizes of
   experiments/legacy_experiment.py (its particle-filter table: the legacy
   BPF at N=10 and 1,000 on the scalar sin/x² model, T=100; its
   Gaussian-filter table: MCF, EKF of order 1 and 2, UKF, MCLAF and the
   composite EKF bank on the dx=2 sinusoid, T=100), the original AGSF
   [3,2,2] in its "prop", "opt_lip" and "test" selection modes, and the
   legacy BPF at path A's model and size (1M particles, T=100; K5 once a
   step), each three times (MCLAF and "opt_lip" once) with its walls and
   RMSE; path M, the multi-device layer on two ranks sharing the card over
   gloo, float32, each rank's launches exact: ``batched_filter`` of the
   EKF L96 cell (256 sequences a rank; equal to the single-process EKF),
   path A's BPF in both modes (500,000 particles a rank), the GSF M=50 on
   bearings-only tracking (T=100), the AGSF [6400,4,4] of
   experiments/sharded_agsf_scale.py (T=12) gathered and local, path B's
   time-sharded smoother (T=1M), path E's time-sharded IEKS at T=2^14 and
   path K's data-parallel gradient (32 sequences a rank), each with its
   wall, its collectives' calls, bytes and host seconds, and its gap to
   the single-process result (and the gathered AGSF again in float64,
   equal to the single-process one). Config 5,
   paths C, H and L run three times each in one process and report the
   median and the range. Checks finiteness, shapes and the launch counts
   of every kernel.
6. The device's busy and idle share, and the kernels with the most
   device time, under torch.profiler: the batched UKF step, ten steps of
   the 1M-particle BPF (with the split of its resampling steps between
   the counts' cummax, K5, the ``.long()`` and the gather), one run of the
   T=1M parallel smoother, ten steps
   of each of config 5's filters (the EKF's split between K1t/K2t and the
   host, the UKF's between K6t, K8t and K9t), one run of path C with each
   solver (the native one with its host operations), one run of each of
   path D's smoothers at T=20 and of path E at T=2,048 (the device's
   activity alone), one run of path F's AGSF with autocov "sdp" at T=20
   (the device's activity alone) and of path H's smoother at T=1M.

The last three lines: a JSON object describing each kernel, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import hashlib
import json
import re
import statistics
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
UKF_SQRTM_T = 100
BOT_EXP_T, RB_CMP_T = 500, 50
UGSF_M, UAGSF_COMPS = 100, [16, 2, 2]
PROFILE_T = 10
# path A: experiments/headline_bench.py's 1M-particle BPF row
BPF_DX, BPF_DY, BPF_P, BPF_T = 8, 4, 1_000_000, 100
BPF_CMP_P, BPF_CMP_T = 65_536, 20
# path B: experiments/parallel_kf_bench.py's linear workload
KF_DX, KF_DY, KF_T, KF_CHUNK, KF_CMP_T = 4, 2, 1_000_000, 128, 4096
# chunked_associative_scan at T = 1M, chunk 128: 128 in-chunk combines
# over G = 7,813 lanes, 128 over 62, 62 sequential ones on the top level,
# then the two broadcast combines over (128, 62) and (128, 7,813)
KF_COMBINES = 128 + 128 + 62 + 1 + 1
KF_LANES = -(-KF_T // KF_CHUNK)                       # 7,813
KF_NARROW = -(-KF_LANES // KF_CHUNK)                  # 62: the next level
# BASELINE config 5 (experiments/headline_bench.py:90-98): Lorenz-96
# dx=512, dy=256, one sequence, T=200, RK4 data, Euler filter
C5_DX, C5_DY, C5_T, C5_CMP_T, C5_CHUNK = 512, 256, 200, 20, 128
C5_PROFILE_T = 10
# path N: config 5's model at twice its width (Lorenz-96 dx=2,048,
# dy=1,024, one sequence, RK4 data, Euler filter; T=20), the widths at
# which the reference's own wrappers route to XLA; card vs CPU at T=3 in
# float64. Its smoother: path C's model at zoo.linear_gaussian_lgssm(1024,
# 512), Woodbury, chunk 128, T cut from 256 to PN_S_T: K10b and K12b give
# one thread block to a lane, and the chunked scan's in-chunk combines run
# over 2 lanes at T = 256 (a chain of 128 combines on 2 SMs, ~0.38 s of
# K10b and ~0.05 s of K12b each at dx = 1,024 on an H100), so T = 256
# would take ~60 s a call; card vs CPU at T=8 in float64
PN_DX, PN_DY, PN_T, PN_CMP_T = 2048, 1024, 20, 3
PN_SDX, PN_SDY, PN_S_T, PN_S_CMP_T = 1024, 512, 16, 8
# path C: the parallel smoother above the lane band, at bench.py's
# Lorenz-96 filter widths; T cut from path B's 1M to 65,536 (the elements
# at dx=64 take ~256x the bytes of dx=4)
PC_DX, PC_DY, PC_T, PC_CMP_T = 64, 32, 65_536, 1024
# chunked_associative_scan at T = 65,536, chunk 128: 128 in-chunk combines
# over G = 512 lanes, 128 over 4, 4 sequential ones, then the broadcasts
# over (128, 4) and (128, 512)
PC_COMBINES = 128 + 128 + 4 + 1 + 1
PC_LANES = PC_T // KF_CHUNK                           # 512
PC_NARROW = PC_LANES // KF_CHUNK                      # 4: the next level
# path D: experiments/smoother_experiment.py:36-75, the BOT smoothing
# comparison (range-bearing tracking, 8 iterations, ParamsUKF(1, 0, 0,
# "cholesky")); ERTS, URTS, the IEKS (EKF seed, damping 0.7), the LM-IEKS
# (EKF seed, lambda 100) and the IPLS (EKF seed); T cut from the source's
# 500 to 250: its host-bound smoothers took ~150 s of the run's time limit
# at 500 (three calls each), and the run with path L came within 45 s of
# the limit
PD_T, PD_ITER, PD_DAMPING, PD_LM_LAMBDA = 250, 8, 0.7, 100.0
# one call of each smoother on the main path: the five host-bound
# smoothers take ~25 s a round on the H100, and the run has a time limit
PD_REPS = 1
PD_CMP_T, PD_CMP_ITER, PD_PROFILE_T = 100, 3, 20
# path E: experiments/parallel_kf_bench.py:141-152, the IEKS row (the UNGM,
# N(0, 1) emissions, 3 iterations, chunk 128, the rollout nominal); T cut
# from the source's 1M (:70) to 2^15: the rollout is a loop of T model
# calls of ~11 launches each, ~140-180 us a step on the H100 machine's
# host, so that 1M steps would take ~180 s (PERF.md section 4), and 2^18
# (~49 s) and 2^17 (~23 s) no longer fit the run's time limit beside
# path L, and 2^16 (~11 s) was cut to 2^15 when path N joined it. The
# rollout alone is timed at 16,384 steps (65,536 until the multi-device
# path M joined the run: its rate a step is the same), and phase 6 traces
# the path at 2,048.
PE_T, PE_ITER, PE_ROLLOUT_T, PE_PROFILE_T = 2 ** 15, 3, 2 ** 14, 2_048
PE_LANES = PE_T // KF_CHUNK                           # 256
# the time-varying filter and smoother on the card against the CPU: the
# BOT widths (dx=4, dy=2, T=250, the flat scan) and path C's (dx=64,
# dy=32, T=1,024, chunk 128: K10b, K11b with F banked, K12b)
TV_CMP = ((4, 2, PD_T, "auto"), (PC_DX, PC_DY, PC_CMP_T, KF_CHUNK))
REPS = 3  # calls of each new path in one process: median and range
# (M, dx, dy) of K3 and (M, dx, dq) of K4 on the mixture paths (MIXTURE_RUNS,
# bearings-only widths): the GSF M = 50 updates and predicts 50 components;
# the AGSF [50,2,2] predicts M·N = 100 and updates M·N·L = 200; the AGSF
# [8,2,2] 16 and 32
BANK_UPDATES = ((50, 4, 1), (200, 4, 1), (32, 4, 1))
BANK_PREDICTS = ((50, 4, 2), (100, 4, 2), (16, 4, 2))
# paths F and G: experiments/expa_experiment.py:51-79 (Experiment A:
# sine_quadratic, T = 100, ParamsUKF(1, 0, 0), opt_args (0.8, 1.0), a BPF of
# 100 particles) and experiments/adaptive_experiment.py:26-70 (the
# stochastic-volatility regime switch at T/2: M = 20, a BPF of 20,000
# particles); SLICE_SEEDS sequences each (the sources run 100 and 10; 3
# until path N joined the run, which has a time limit)
SLICE_T, SLICE_SEEDS, SLICE_CMP_T, SLICE_PROFILE_T = 100, 2, 20, 20
EXPA_OPT_ARGS, EXPA_PARTICLES = (0.8, 1.0), 100
MSV_M, MSV_PARTICLES = 20, 20_000
# path H: experiments/profile_chunked.py:13-20,49-56, the steady-state filter
# and smoother on path B's model and data (T = 1M, head 64, 128 Riccati
# iterations)
SS_HEAD, SS_ITERS = 64, 128
# path F (Experiment A, dx = 1): the GSF M = 5 and the AGSF [3,2,2]
# (predict over 6, update over 12); path G (stochastic volatility,
# dx = dy = dq = 3): the GSF M = 20 and the AGSF [20,2,2] (40, 80)
SLICE_BANK_UPDATES = ((5, 1, 1), (12, 1, 1), (20, 3, 3), (80, 3, 3))
SLICE_BANK_PREDICTS = ((5, 1, 1), (6, 1, 1), (20, 3, 3), (40, 3, 3))
# path F's UKF banks: the UGSF M = 3 and the UAGSF [3,2,2]
SLICE_UT_BANKS = ((3, "update"), (3, "predict"), (6, "predict"),
                  (12, "update"))
# path F's and G's bootstrap PFs: K5 at n = 100 and 20,000
SLICE_PARENTS = (100, 20_000)
SIGMA_TILED_SYMBOLS = ("tiled_factor_kernel", "sigma_tiled_trace_kernel",
                       "tiled_gemm_kernel", "sigma_tiled_root_kernel",
                       "sigma_tiled_points_kernel")
# each kernel's CUDA symbols (K7 is its points kernel and the one-block
# factor of the shared noise covariance; K6t's and K7t's Cholesky is one
# tiled_factor_kernel launch each, with the points as its epilogue —
# PointsEpilogue, SigmaAugEpilogue —, K7t's Newton–Schulz rounds grouped
# launches of P's and C's products)
KERNEL_SYMBOLS = {
    "bft_ekf_update": ("ekf_update_kernel",),
    "bft_ekf_predict_cov": ("ekf_predict_cov_kernel",),
    "bft_ekf_update_tiled": ("tiled_gemm_kernel", "tiled_factor_kernel"),
    "bft_ekf_predict_cov_tiled": ("tiled_gemm_pair_kernel",
                                  "tiled_gemm_kernel"),
    "bft_bank_update": ("bank_update_kernel",),
    "bft_bank_predict_cov": ("bank_predict_cov_kernel",),
    "bft_resample_parents": ("resample_parents_kernel",),
    "bft_ut_sigma": ("ut_sigma_kernel",),
    "bft_ut_sigma_aug": ("ut_sigma_aug_kernel", "ut_noise_sigma_kernel"),
    "bft_ut_update": ("ut_update_kernel",),
    "bft_ut_predict": ("ut_predict_kernel",),
    "bft_ut_update_tiled": ("tiled_gemm_kernel", "ut_tiled_centre_kernel",
                            "tiled_factor_kernel"),
    "bft_ut_predict_tiled": ("tiled_gemm_kernel",
                             "ut_tiled_mean_centre_kernel"),
    "bft_ut_sigma_tiled": SIGMA_TILED_SYMBOLS,
    "bft_ut_sigma_aug_tiled": SIGMA_TILED_SYMBOLS + ("tiled_gemm_pair_kernel",),
    "bft_bank_combine": ("bank_combine_kernel",),
    "bft_bank_smoother_elements": ("bank_smoother_elements_kernel",),
    "bft_bank_smoother_combine": ("bank_smoother_combine_kernel",),
    "bft_block_combine": ("tiled_combine_kernel",),
    "bft_block_smoother_elements": ("block_smoother_elements_kernel",),
    "bft_block_smoother_combine": ("tiled_smoother_combine_kernel",),
}
# the kernels' IDs, in the order of the kernel table; K1t/K2t and K6t–K9t
# are the tiled variants of K1/K2 and K6–K9, K10b–K12b the block variants
# (dx > 8) of K10–K12
KERNEL_IDS = {"bft_ekf_update": "K1", "bft_ekf_update_tiled": "K1t",
              "bft_ekf_predict_cov": "K2", "bft_ekf_predict_cov_tiled": "K2t",
              "bft_bank_update": "K3", "bft_bank_predict_cov": "K4",
              "bft_resample_parents": "K5", "bft_ut_sigma": "K6",
              "bft_ut_sigma_tiled": "K6t", "bft_ut_sigma_aug": "K7",
              "bft_ut_sigma_aug_tiled": "K7t", "bft_ut_update": "K8",
              "bft_ut_update_tiled": "K8t", "bft_ut_predict": "K9",
              "bft_ut_predict_tiled": "K9t", "bft_bank_combine": "K10",
              "bft_block_combine": "K10b",
              "bft_bank_smoother_elements": "K11",
              "bft_block_smoother_elements": "K11b",
              "bft_bank_smoother_combine": "K12",
              "bft_block_smoother_combine": "K12b"}

# kernels timed in float64 as well at their main-path shapes (config 5's
# filters run in float64 too, K1/K2's and K11b's float64 workspaces hold
# one block an SM, and K10–K12's groups read twice the bytes; the rest are
# timed in float32 only)
TIMED_FLOAT64 = ("bft_ekf_update", "bft_ekf_predict_cov",
                 "bft_ekf_update_tiled", "bft_ekf_predict_cov_tiled",
                 "bft_ut_sigma_tiled", "bft_ut_update_tiled",
                 "bft_ut_predict_tiled", "bft_bank_combine",
                 "bft_bank_smoother_elements", "bft_block_smoother_elements",
                 "bft_bank_smoother_combine")

# Roofline of an H100 SXM at its 700 W limit (NVIDIA's data sheet): memory
# 3.35 TB/s; CUDA-core (non-tensor) peaks 67 TFLOP/s in float32 and
# 34 TFLOP/s in float64; the float64 tensor cores 67 TFLOP/s. TF32 is off
# by the precision policy, so float32 is bound at the CUDA-core peak; a
# kernel whose source issues the float64 tensor-core product (tiled.cuh's
# mma.m8n8k4, in the tiled variants) is bound in float64 at the tensor
# cores' peak, the others at the CUDA cores'.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_FLOPS_FLOAT64_MMA = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def digest(tensors) -> str:
    """The first 12 hex digits of the SHA-1 of the tensors' bytes: two
    builds that compute the same bits print the same digest."""
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:12]


def rel_err(a, b) -> float:
    import torch

    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) / max(1.0, float(b[~torch.isnan(b)].abs().max()))


def _reps(first_ms: float, most: int) -> int:
    """Calls to time after a first one of ``first_ms``: ``most``, or fewer
    for a long call (about a quarter of a second of calls, at least 3)."""
    return most if first_ms * most <= 250 else max(3, int(250 / first_ms))


def cuda_time_ms(fn, reps: int = 50) -> float:
    """Milliseconds per call of ``fn``: CUDA events around a loop of calls
    after a timed warm-up call (fewer calls when one is long)."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = _reps(start.elapsed_time(end), reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 20):
    """Milliseconds of device work per call of ``fn``: CUDA events around
    ``reps`` calls queued behind a device-side sleep (``torch.cuda._sleep``)
    that outlasts their host time, so that their kernels run back to back
    and the wrapper's host time is hidden. The start event must still be
    pending when the last call has been queued; if it is not, the host
    waited for the device: the launch queue filled (K7t's 95 launches a
    call, 20 calls) or the sleep was short, so the calls are cut to a
    quarter, down to one, and then the sleep is lengthened. None if five
    tries did not cover the host time."""
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    reps = _reps(1e3 * first, reps)
    sleep_s = 2 * reps * first + 0.01
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(sleep_s * 2e9))  # cycles, ~2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / reps
        if reps > 1:
            reps = max(1, reps // 4)
        else:
            sleep_s *= 4
    return None


def profiler_ms(fn, symbols, reps: int = 20):
    """(ms per launch, launches recorded, calls) of the kernels named by
    ``symbols`` under torch.profiler over ``reps`` calls of ``fn``. The
    profiler does not record every launch on the card's machine: over 4
    calls of K11b (65,535 lanes) it recorded none, over 5 of K10b's step-4
    broadcast 3, over 20 of K12b at M = 512 18; holding its window open
    0.3 s after the calls, or opening it 0.3 s before them, changed
    nothing. Hence the time per recorded launch, beside the count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = _reps(1e3 * (time.perf_counter() - t0), reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU
              and any(s in e.key for s in symbols)]
    total = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    return (total / 1e3 / launches if launches else None), launches, reps


def device_ms(fn, symbols, reps: int = 20):
    """Device time per call of ``fn`` (``queued_ms``), and a line of the
    log with the profiler's time per launch of the kernels named by
    ``symbols`` and how many of the launches it recorded."""
    ms = queued_ms(fn, reps)
    per_launch, launches, calls = profiler_ms(fn, symbols, reps)
    log(f"  device time {ms} ms a call (queued events); profiler "
        f"{per_launch} ms a launch, {launches} launches recorded over "
        f"{calls} calls")
    return ms


def graph_ms(fn, calls: int = 100, replays: int = 5) -> float:
    """Milliseconds per call of ``fn`` from CUDA events around the replay
    of a CUDA graph of ``calls`` calls: device time with no host cost per
    call, the same method for a kernel and a library call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# Floating-point operations per batch element: the least the function
# needs, counted from the algorithm (a multiply-add is 2). A symmetric
# output — a Gram matrix X Xᵀ or a congruence X A Xᵀ — is counted once, as a
# SYRK computes it (n²k for n×n over an inner k, not 2n²k); a product with a
# triangular factor counts half; a transpose is free.
def update_flops(dx, dy):
    """K1, K3: H P (2dy·dx²), S = (H P)Hᵀ + Rt (dy²·dx), chol S and L⁻¹
    (dy³/3 each), L⁻¹ H P and Kᵀ (dy²·dx each), I − K H (2dx²·dy),
    (I − K H) P (2dx³), the Joseph congruences (dx³ and dx²·dy), K Rt
    (2dx·dy²), μ and z."""
    return (3 * dx ** 3 + 5 * dx * dx * dy + 5 * dx * dy * dy
            + 2 * dy ** 3 / 3 + 2 * dx * dy + dy * dy)


def predict_flops(dx, dq):
    """K2, K4: F_x P (2dx³), its congruence with F_x (dx³), F_q Q
    (2dx·dq²), its congruence with F_q (dx²·dq)."""
    return 3 * dx ** 3 + 2 * dx * dq * dq + dx * dx * dq


def factor_flops(n, method):
    """K6, K7: Cholesky n³/3, or 14 Newton–Schulz rounds of 3 products of
    commuting matrices (symmetric only in exact arithmetic, so counted in
    full)."""
    return n ** 3 / 3 if method == "cholesky" else 14 * 3 * 2 * n ** 3


def ut_update_flops(rows, dx, dy):
    """K8, K8t, which form the grouped Joseph form as sym(P) − ZᵀZ (no
    gain, no L⁻¹): centring (rows·(dx + dy)), S over the rows (rows·dy²),
    C (2rows·dx·dy), chol S (dy³/3), Zᵀ = (L⁻¹C)ᵀ (dx·dy², a triangular
    solve), the symmetric ZᵀZ (dx²·dy), z = L⁻¹ v (dy²), μ = m + Zᵀz
    (2dx·dy) and sym(P) − ZᵀZ (dx²)."""
    return (rows * dy * dy + 2 * rows * dx * dy + rows * (dx + dy)
            + dy ** 3 / 3 + dx * dy * dy + dx * dx * dy + dy * dy
            + 2 * dx * dy + dx * dx)


def ut_predict_flops(rows, dx):
    """K9, K9t: μ and the centring (2rows·dx), Σ over the rows (rows·dx²), the
    center's outer product."""
    return rows * dx * dx + 2 * rows * dx + dx * dx + 2 * dx


def combine_flops(n):
    """K10: chol(C1 + εI) n³/3, J2U with the triangular U n³, the congruence
    UᵀJ2U n³/2, chol and L⁻¹ of the inner matrix n³/3 each, its inverse
    L⁻ᵀL⁻¹ n³/3, V = inner⁻¹(J2U)ᵀ 2n³, U V n³, A2 M⁻¹ and A 2n³ each,
    A2M C1 A2ᵀ 3n³ (a product and a symmetric one), A1ᵀ (M⁻ᵀ J2) A1 5n³,
    five matrix-vector products for b and η 10n²: 107n³/6 + 10n²."""
    return 107 * n ** 3 / 6 + 10 * n * n


def elements_flops(n):
    """K11: with Y = Lp⁻¹ F Pf, G = Yᵀ Lp⁻¹ and L = sym(Pf) − YᵀY:
    chol(Pp) n³/3, F Pf 2n³, the forward solve for Y n³, the back solve
    Lpᵀ Gᵀ = Y n³, the symmetric YᵀY n³, G mp 2n²."""
    return 16 * n ** 3 / 3 + 2 * n * n


def scombine_flops(n):
    """K12: E1 E2 2n³, E1 L2 2n³, the symmetric (E1 L2) E1ᵀ n³, E1 g2 2n²."""
    return 5 * n ** 3 + 2 * n * n


def issues_float64_mma(source: str) -> bool:
    """Whether the kernel source (a path in the repo) or a header that it
    includes, directly or through another, issues the float64 tensor-core
    product."""
    seen, todo = set(), [ROOT / source]
    while todo:
        path = todo.pop()
        if path in seen or not path.is_file():
            continue
        seen.add(path)
        text = path.read_text()
        if "mma.sync.aligned.m8n8k4" in text and ".f64" in text:
            return True
        todo += [path.parent / h for h in re.findall(r'#include "([^"]+)"',
                                                     text)]
    return False


def bound(tensors, outputs, flops, dtype_name, lower=(), mma64=False):
    """(bound_ms, bound_by): every input read once and every output written
    once at the memory rate, or the operations at the peak of their type
    (float64 at the tensor cores' where ``mma64``: the kernel issues the
    float64 tensor-core product). The inputs whose indices are in
    ``lower`` are stacks of n × n matrices of which the function reads only
    the lower triangle: n(n + 1)/2 entries each."""
    def entries(i, t):
        n = t.shape[-1]
        return t.numel() * (n + 1) / (2 * n) if i in lower else t.numel()

    nbytes = (sum(entries(i, t) * t.element_size()
                  for i, t in enumerate(tensors))
              + sum(t.numel() * t.element_size() for t in outputs))
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (PEAK_FLOPS_FLOAT64_MMA if mma64 and dtype_name ==
                     "float64" else PEAK_FLOPS[dtype_name])
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else
                                     "operations")


def kernel_cases():
    """(kernel, wrapper, plain, shape, make inputs, static args, flops per
    launch, timed) — timed is "main" for the kernel's main-path shape,
    "also" for a second timed shape of the main path, else None. The
    kernel is a function of the first operand where a rule picks it by
    shape and dtype (the EKF's K1/K1t and K2/K2t, the UT's K8/K8t and
    K9/K9t)."""
    from bayesianfiltering_tpu_torch import testing
    from bayesianfiltering_tpu_torch.ops import associative as tas
    from bayesianfiltering_tpu_torch.ops import bank_combine as bc
    from bayesianfiltering_tpu_torch.ops import bank_smoother as bs
    from bayesianfiltering_tpu_torch.ops import bank_update as bu
    from bayesianfiltering_tpu_torch.ops import fused_ekf as fe
    from bayesianfiltering_tpu_torch.ops import fused_ut as fu
    from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF, ut_weights
    from bayesianfiltering_tpu_torch import _build

    up = ParamsUKF(1.0, 2.0, 0.0)
    cases = []

    def pairs(make_bank, M, dx, chunk):
        """Left and right operands over M lanes, or the chunked scan's step
        4: left (1, M) against right (chunk, M)."""
        def make(r):
            if chunk is None:
                return make_bank(r, M, dx) + make_bank(r, M, dx)
            left = tuple(x[None] for x in make_bank(r, M, dx))
            right = tuple(x.reshape((chunk, M) + x.shape[1:])
                          for x in make_bank(r, chunk * M, dx))
            return left + right
        return make

    def wide_filter_elements(r, M, dx):
        """Above the lane band: J of rank dx/2 (dy = dx/2, as path C) and
        the factors scaled by 1/√dx, so that the combine stays well
        conditioned in float32 at dx = 512."""
        return testing.filter_elements(r, M, dx, dx // 2, normalized=True)

    def fcombine(M, dx, chunk=None, timed=None):
        shape = f"M={M},dx={dx}" if chunk is None else \
            f"(1,{M}) x ({chunk},{M}),dx={dx}"
        lane = dx <= 8
        cases.append((bc.K10 if lane else bc.K10B,
                      lambda *a: bc.bank_filter_combine(a[:5], a[5:]),
                      lambda *a: tas._combine(a[:5], a[5:]), shape,
                      pairs(testing.filter_elements if lane
                            else wide_filter_elements, M, dx, chunk), (),
                      M * (chunk or 1) * combine_flops(dx), timed))

    def scombine(M, dx, chunk=None, timed=None):
        shape = f"M={M},dx={dx}" if chunk is None else \
            f"(1,{M}) x ({chunk},{M}),dx={dx}"
        cases.append((bs.K12 if dx <= 8 else bs.K12B,
                      lambda *a: bs.bank_smoother_combine(a[:3], a[3:]),
                      lambda *a: tas._smoother_combine(a[:3], a[3:]), shape,
                      pairs(testing.smoother_elements, M, dx, chunk), (),
                      M * (chunk or 1) * scombine_flops(dx), timed))

    def elements(M, dx, timed=None, banked=False):
        """F shared by every lane, as on the time-invariant smoother's
        path, or ``banked``, one F a lane, as on the time-varying one's."""
        def make(r):
            fm, fP, pm, pP, F = testing.smoother_element_inputs(r, M, dx)
            return fm, fP, pm, pP, F if banked else F[0]
        cases.append((bs.K11 if dx <= 8 else bs.K11B,
                      lambda fm, fP, pm, pP, F: bs.bank_smoother_elements(
                          fm, fP, pm, pP, F.expand(M, dx, dx)),
                      bs._elements_plain,
                      f"M={M},dx={dx},F {'banked' if banked else 'shared'}",
                      make, (), M * elements_flops(dx), timed))

    def upd(kernel, wrap, plain, B, dx, dy, timed=None):
        cases.append((kernel, wrap, plain, f"B={B},dx={dx},dy={dy}",
                      lambda r: testing.update_inputs(r, B, dx, dy), (0.0,),
                      B * update_flops(dx, dy), timed))

    def pred(kernel, wrap, plain, B, dx, dq, timed=None):
        cases.append((kernel, wrap, plain, f"B={B},dx={dx},dq={dq}",
                      lambda r: testing.predict_inputs(r, B, dx, dq), (),
                      B * predict_flops(dx, dq), timed))

    def sigma(B, n, method, timed=None):
        rule = lambda a: fu.sigma_kernel(n, method, a.element_size(),
                                         _build.smem_optin(a.device))
        cases.append((rule, fu.fused_sigma, fu._sigma_plain,
                      f"B={B},n={n},{method}",
                      lambda r: testing.sigma_inputs(r, B, n),
                      (ut_weights(n, up)[0], method),
                      B * factor_flops(n, method) + 2 * B * n * n, timed))

    def sigma_aug(B, dx, dn, method, timed=None):
        rule = lambda a: fu.sigma_aug_kernel(dx, dn, method, a.element_size(),
                                             _build.smem_optin(a.device))
        cases.append((rule, fu.fused_sigma_aug, fu._sigma_aug_plain,
                      f"B={B},dx={dx},dn={dn},{method}",
                      lambda r: testing.sigma_aug_inputs(r, B, dx, dn),
                      (ut_weights(dx + dn, up)[0], method),
                      B * factor_flops(dx, method) + factor_flops(dn, method)
                      + 2 * B * (dx + dn) ** 2, timed))

    def ut_update(B, rows, ld, dx, dy, add_r, timed=None):
        w_side, _, w0c = ut_weights(rows // 2, up)[1]
        rule = lambda a: fu.update_kernel(dx, dy, a.element_size(),
                                          _build.smem_optin(a.device))
        cases.append((rule, fu.fused_ut_update, fu._ut_update_plain,
                      f"B={B},rows={rows},ld={ld},dx={dx},dy={dy},"
                      f"{'+R' if add_r else 'no R'}",
                      lambda r: testing.ut_update_inputs(r, B, rows, ld, dx,
                                                         dy),
                      (w_side, w0c, add_r),
                      B * ut_update_flops(rows, dx, dy), timed))

    def ut_predict(B, rows, dx, add_q, timed=None, params=up):
        w_side, w0m, w0c = ut_weights(rows // 2, params)[1]
        rule = lambda a: fu.predict_kernel(dx, a.element_size(),
                                           _build.smem_optin(a.device))
        cases.append((rule, fu.fused_ut_predict, fu._ut_predict_plain,
                      f"B={B},rows={rows},dx={dx},{'+Q' if add_q else 'no Q'}"
                      + ("" if params is up else f",w0m={w0m:g},w0c={w0c:g}"),
                      lambda r: testing.ut_predict_inputs(r, B, rows, dx),
                      (w_side, w0m, w0c, add_q),
                      B * ut_predict_flops(rows, dx), timed))

    def ekf_upd(B, dx, dy, timed=None):
        rule = lambda a: fe.update_kernel(dx, dy, a.element_size(),
                                          _build.smem_optin(a.device))
        upd(rule, fe.fused_update, fe._update_plain, B, dx, dy, timed)

    def ekf_pred(B, dx, dq, timed=None):
        rule = lambda a: fe.predict_kernel(dx, dq, a.element_size(),
                                           _build.smem_optin(a.device))
        pred(rule, fe.fused_predict_cov, fe._predict_plain, B, dx, dq, timed)

    # K1/K2 on the batched Lorenz-96 filter; K1t/K2t at config 5 (the joint
    # update, dy = 256, and the chunked one, 2 × 128), at the band edge
    # dy = 512, at sizes that are not multiples of a tile (64 or 32) or a
    # panel (32), K1 at the bearings-only widths (dx = 4, dy = 1 and 2: the
    # narrow panel), and on both sides of the rule's edges (K1 at
    # dx = 117 | 118, dy = 40 in float32 and 75 | 76, dy = 32 in float64;
    # K2 at dx = dq = 96 | 97 in float32 and 64 | 65 in float64)
    ekf_upd(512, 64, 32, "main")
    ekf_upd(2, 512, 128)
    ekf_upd(1, C5_DX, C5_DY, "main")
    ekf_upd(1, C5_DX, C5_CHUNK, "also")
    ekf_upd(2, 512, 512)
    for B, dx, dy in ((1, 511, 33), (3, 511, 1), (3, 100, 33), (3, 65, 300),
                      (1, 65, 1), (100, 4, 1), (100, 4, 2), (1, 117, 40),
                      (1, 118, 40), (1, 75, 32), (1, 76, 32)):
        ekf_upd(B, dx, dy)
    ekf_pred(512, 64, 64, "main")
    ekf_pred(2, 512, 512)
    ekf_pred(1, C5_DX, C5_DX, "main")
    for B, dx, dq in ((2, 511, 1), (3, 65, 200), (1, 96, 96), (1, 97, 97),
                      (1, 65, 65), (3, 100, 33), (100, 4, 2)):
        ekf_pred(B, dx, dq)
    # K3 and K4 at the mixture paths' banks (BANK_UPDATES, BANK_PREDICTS:
    # the GSF M = 50 first), at widths that take a group of 8 threads
    # (dx = 5 beside 7) and at the band edge
    for i, (M, dx, dy) in enumerate(BANK_UPDATES):
        upd(bu.K3, bu.bank_chol_update, bu._update_plain, M, dx, dy,
            "main" if i == 0 else "also")
    upd(bu.K3, bu.bank_chol_update, bu._update_plain, 130, 5, 7)
    upd(bu.K3, bu.bank_chol_update, bu._update_plain, 4096, 8, 8)
    for i, (M, dx, dq) in enumerate(BANK_PREDICTS):
        pred(bu.K4, bu.bank_predict_cov, bu._predict_cov_plain, M, dx, dq,
             "main" if i == 0 else "also")
    pred(bu.K4, bu.bank_predict_cov, bu._predict_cov_plain, 130, 5, 7)
    pred(bu.K4, bu.bank_predict_cov, bu._predict_cov_plain, 4096, 8, 8)
    # paths F and G: K3 and K4 at Experiment A's banks (dx = dy = dq = 1)
    # and at the stochastic-volatility model's (dx = dy = dq = 3), widths
    # below the 16-byte row loads (SLICE_BANK_UPDATES, SLICE_BANK_PREDICTS)
    for M, dx, dy in SLICE_BANK_UPDATES:
        upd(bu.K3, bu.bank_chol_update, bu._update_plain, M, dx, dy, "also")
    for M, dx, dq in SLICE_BANK_PREDICTS:
        pred(bu.K4, bu.bank_predict_cov, bu._predict_cov_plain, M, dx, dq,
             "also")
    # Lorenz-96 UKF (dx=64, dy=32, augmented na = 128 and 96), the
    # range-bearing banks (na = 6 at M = 32..100), n = 128 and both sides
    # of K6's and K7's rules (K6's Cholesky at n = 240 | 241 in float32
    # and 170 | 171 in float64, Newton–Schulz at 128 | 129 and 96 | 97;
    # K7's Cholesky at dx = 223 | 224 and 144 | 145 beside dn = 64);
    # Newton–Schulz also at ragged widths on one super-tile a thread
    # (n = 1, 37) and on two (65)
    sigma(512, 64, "cholesky", "main")
    sigma(512, 64, "sqrtm", "also")
    sigma(4, 128, "cholesky")
    sigma(4, 128, "sqrtm")
    for n, method in ((240, "cholesky"), (241, "cholesky"), (170, "cholesky"),
                      (171, "cholesky"), (129, "sqrtm"), (96, "sqrtm"),
                      (97, "sqrtm"), (1, "sqrtm"), (37, "sqrtm"),
                      (65, "sqrtm")):
        sigma(2, n, method)
    for dx in (223, 224, 144, 145):
        sigma_aug(2, dx, 64, "cholesky")
    sigma_aug(512, 64, 64, "cholesky", "main")
    sigma_aug(512, 64, 32, "cholesky")
    sigma_aug(512, 64, 64, "sqrtm")
    sigma_aug(512, 64, 32, "sqrtm")
    sigma_aug(100, 4, 2, "cholesky")
    sigma_aug(32, 4, 2, "sqrtm")
    sigma_aug(2, 100, 28, "cholesky")
    sigma_aug(2, 100, 28, "sqrtm")
    sigma_aug(2, 128, 1, "sqrtm")
    sigma_aug(2, 1, 128, "sqrtm")
    # path F: the UGSF M = 3 and the UAGSF [3,2,2] (predict over M·N = 6,
    # update over M·N·L = 12) at Experiment A's widths, dx = dq = dr = 1
    for M in sorted({m for m, _ in SLICE_UT_BANKS}):
        sigma_aug(M, 1, 1, "cholesky", "also")
    for M, step in SLICE_UT_BANKS:
        if step == "update":
            ut_update(M, 4, 2, 1, 1, False, "also")
        else:
            ut_predict(M, 4, 1, False, "also")
    ut_update(512, 128, 64, 64, 32, True, "main")
    ut_update(512, 192, 96, 64, 32, False, "also")
    ut_update(100, 12, 6, 4, 2, False)
    ut_update(64, 12, 6, 4, 2, False)
    ut_update(2, 256, 128, 128, 128, True)
    # K8 and K9 at ragged edges: dy = 33 (S a panel and one row, C from
    # column 36) at the augmented L96 shape, dx = 65 with rows that are
    # not a multiple of the 64-row chunk, S in two panels, and both sides
    # of K8's narrow panel (dy = 8 | 9)
    ut_update(512, 192, 96, 64, 33, False)
    ut_update(3, 130, 70, 65, 33, True)
    ut_update(2, 130, 50, 40, 64, True)
    ut_update(5, 40, 20, 12, 8, True)
    ut_update(5, 40, 20, 12, 9, True)
    ut_predict(512, 128, 64, True, "main")
    ut_predict(512, 256, 64, False, "also")
    ut_predict(100, 12, 4, False)
    ut_predict(32, 12, 4, False)
    ut_predict(2, 256, 128, True)
    ut_predict(3, 130, 65, True)
    ut_predict(2, 70, 33, False)
    # config 5's additive UKF (n = 512, 1,024 points, dy = 256: K8t and
    # K9t), the augmented widths at config 5 (na = 1,024 in the predict,
    # 768 in the update) and the band edge 1,024; K8t and K9t also at
    # shapes that are not multiples of a tile or a panel (dy = 129) and on
    # both sides of their rules' edges (K8 at dx = 188 | 189, dy = 32 in
    # float32 and 105 | 106 in float64; K9 at dx = 192 | 193 and 128 | 129)
    sigma(1, C5_DX, "cholesky", "main")
    sigma(1, 1024, "cholesky")
    sigma(1, 256, "sqrtm")
    sigma_aug(1, C5_DX, C5_DX, "cholesky", "main")
    sigma_aug(2, C5_DX, C5_DY, "cholesky")
    sigma_aug(2, 300, 45, "sqrtm")
    sigma_aug(1, C5_DX, C5_DY, "sqrtm")
    sigma_aug(1, 121, C5_DX, "cholesky")
    ut_update(1, 2 * C5_DX, C5_DX, C5_DX, C5_DY, True, "main")
    ut_update(1, 2 * (C5_DX + C5_DY), C5_DX + C5_DY, C5_DX, C5_DY, False)
    ut_update(1, 2048, 1024, 1024, 1024, True)
    ut_update(2, 300, 150, 100, 129, False)
    for dx in (188, 189, 105, 106):
        ut_update(1, 2 * dx, dx, dx, 32, True)
    ut_predict(1, 2 * C5_DX, C5_DX, True, "main")
    ut_predict(1, 4 * C5_DX, C5_DX, False)
    ut_predict(1, 2048, 1024, True)
    # K9t at non-zero, negative centre weights (w0m = −3, w0c = −0.25)
    for B, rows, dx in ((1, 2 * C5_DX, C5_DX), (1, 2048, 1024),
                        (3, 600, 300)):
        ut_predict(B, rows, dx, True, params=ParamsUKF(0.5, 2.0, 0.0))
    ut_predict(3, 600, 300, False)
    for dx in (192, 193, 128, 129):
        ut_predict(1, 2 * dx, dx, True)
    # path N: config 5's model at dx = 2,048, dy = 1,024 (K1t at dy =
    # 1,024 and at update_chunk=128's 128, K2t at dx = dq = 2,048, K6t at
    # n = 2,048, K8t and K9t at 4,096 points), K7t alone at dx = dn = 1,024
    # (na = 2,048: no main path runs it), and the smoother's block kernels
    # at dx = 1,024 at its shapes (PN_S_T ≤ 128 steps: one lane a combine,
    # the elements over PN_S_T − 1 lanes)
    ekf_upd(1, PN_DX, PN_DY, "also")
    ekf_upd(1, PN_DX, C5_CHUNK, "also")
    ekf_pred(1, PN_DX, PN_DX, "also")
    sigma(1, PN_DX, "cholesky", "also")
    sigma_aug(1, PN_SDX, PN_SDX, "cholesky", "also")
    ut_update(1, 2 * PN_DX, PN_DX, PN_DX, PN_DY, True, "also")
    ut_predict(1, 2 * PN_DX, PN_DX, True, "also")
    fcombine(1, PN_SDX, timed="also")
    scombine(1, PN_SDX, timed="also")
    elements(PN_S_T - 1, PN_SDX, timed="also")
    # the parallel Kalman smoother at T = 1M, chunk 128, dx = 4: in-chunk
    # combines over 7,813 lanes (128 of the 320), over the next level's 62
    # (128) and over one lane (62), the broadcasts of step 4 over (128, 62)
    # and over 1,000,064; the elements over 999,999 steps; the band edge,
    # and widths that pad a group of 4 or 8 threads
    for M, chunk in ((KF_LANES, None), (KF_LANES, KF_CHUNK),
                     (KF_NARROW, None), (1, None), (KF_NARROW, KF_CHUNK)):
        timed = "main" if (M, chunk) == (KF_LANES, None) else "also"
        fcombine(M, KF_DX, chunk=chunk, timed=timed)
        scombine(M, KF_DX, chunk=chunk, timed=timed)
    fcombine(62, 2)
    fcombine(4096, 8)
    fcombine(130, 5)
    elements(KF_T - 1, KF_DX, timed="main")
    elements(4096, 8)
    elements(100, 3)
    # the time-varying smoother's elements, F banked: path D's passes
    # (M = 499, dx = 4) and path E's (M = T − 1, dx = 1), whose scans also
    # run K10 and K12 at dx = 1 over path E's lanes and its step 4
    elements(PD_T - 1, 4, timed="also", banked=True)
    elements(PE_T - 1, 1, timed="also", banked=True)
    elements(130, 8, banked=True)
    for chunk in (None, KF_CHUNK):
        fcombine(PE_LANES, 1, chunk=chunk)
        scombine(PE_LANES, 1, chunk=chunk)
    scombine(4096, 8)
    scombine(62, 3, chunk=5)
    scombine(130, 6)
    # the block variants: path C (dx = 64, T = 65,536, chunk 128) combines
    # over G = 512 lanes in step 2, over 4 at the next level (512 threads
    # a block for K10b) and broadcasts (1, 512) × (128, 512) in step 4;
    # its elements over 65,535 steps; the lower band edge dx = 9 and the
    # upper one, a few lanes at dx = 512; the block kernels' routes on both
    # sides of their edge (the shared-memory tile 64 | global scratch at
    # dx = 64 | 65, in both dtypes) and at widths that are not multiples of
    # a panel (32, or 16: K11b's in float64) or of the register tiles
    fcombine(PC_LANES, PC_DX, timed="main")
    fcombine(PC_NARROW, PC_DX, timed="also")
    fcombine(PC_LANES, PC_DX, chunk=KF_CHUNK, timed="also")
    fcombine(130, 9)
    fcombine(3, 512)
    for M, dx in ((130, 32), (3, 33), (3, 65), (3, 96), (2, 97)):
        fcombine(M, dx)
    elements(PC_T - 1, PC_DX, timed="main")
    elements(130, 9)
    elements(3, 65)
    elements(3, 100)
    elements(2, 512)
    scombine(PC_LANES, PC_DX, timed="main")
    scombine(PC_NARROW, PC_DX, timed="also")
    scombine(PC_LANES, PC_DX, chunk=KF_CHUNK, timed="also")
    scombine(300, 9)
    scombine(2, 512)
    for M, dx in ((130, 32), (3, 33), (3, 65), (3, 96), (2, 97)):
        scombine(M, dx)
    return cases


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def nan_checks(dev) -> None:
    """A non-positive-definite S (K1, K1t, K3, K8, K8t), P (K6, K6t, K7,
    K7t), C (K7, K7t), Pp (K11) or inner matrix (K10b) gives NaN in the
    same places on both sides, and never an exception. K1t's, K8's and
    K8t's S fail at their first pivot, or only at a pivot of their third
    panel; K1's at its first, at a pivot of its second panel, or in its
    one narrow panel at dy = 2;
    K6t's P (n = 512) at its first or at a pivot of its tenth panel, and
    a single P at its last pivot; K7t's P or C at config 5's widths (dn =
    512 and 256, P and C factored side by side in one launch), and a
    single P at its last pivot. First, ``cholesky_ex`` of one matrix and of
    two failing at their last pivot, on the card and on the CPU (logged),
    and ``cholesky_nan`` NaNs each on both."""
    import numpy as np
    import torch

    from bayesianfiltering_tpu_torch.utils.linalg import cholesky_nan

    from bayesianfiltering_tpu_torch import testing
    from bayesianfiltering_tpu_torch.ops import associative as tas
    from bayesianfiltering_tpu_torch.ops import bank_combine as bc
    from bayesianfiltering_tpu_torch.ops import bank_smoother as bs
    from bayesianfiltering_tpu_torch.ops import bank_update as bu
    from bayesianfiltering_tpu_torch.ops import fused_ekf as fe
    from bayesianfiltering_tpu_torch.ops import fused_ut as fu

    def neg_eye(x):
        return -1e3 * torch.eye(x.shape[-1], dtype=x.dtype,
                                device=x.device).expand_as(x).contiguous()

    rng = np.random.default_rng(SEED)
    for n in (64, C5_DX):
        P = torch.as_tensor(testing.sigma_inputs(rng, 2, n)[1],
                            dtype=torch.float64)
        P[:, n - 1, n - 1] = -1e3
        for where in ("cpu", dev):
            for B in (1, 2):
                x = P[:B].to(where)
                L, info = torch.linalg.cholesky_ex(x)
                nan = bool(torch.isnan(cholesky_nan(x)).all())
                log(f"cholesky_ex n={n} B={B} on {where}: info "
                    f"{info.tolist()}, L[n-1, n-1] "
                    f"{L[:, n - 1, n - 1].tolist()}; cholesky_nan all NaN "
                    f"{nan}")
                if not nan:
                    raise RuntimeError("cholesky_nan kept a factor that "
                                       "fails at its last pivot")
    f64 = lambda arrays: [torch.as_tensor(a, dtype=torch.float64, device=dev)
                          for a in arrays]
    checks = []
    for kernel, wrap, plain, dims in ((fe.K1, fe.fused_update,
                                       fe._update_plain, (512, 64, 32)),
                                      (bu.K3, bu.bank_chol_update,
                                       bu._update_plain, (200, 4, 1))):
        a = f64(testing.update_inputs(rng, *dims))
        a[3] = neg_eye(a[3])
        checks.append((kernel, wrap, plain, a + [0.0]))
    # K1 at dx = 12, dy = 64 in float64 (two panels of 32), failing only
    # in its second, and at dy = 2 (one narrow panel of 8)
    for dy, fail_at in ((64, 63), (2, 1)):
        a = f64(testing.update_inputs(rng, 2, 12, dy))
        a[3][:, fail_at, fail_at] = -1e3
        checks.append((fe.K1, fe.fused_update, fe._update_plain, a + [0.0]))
    # K1t at dx = 200, dy = 70 in float64 (three panels of 32, 32, 6)
    for fail_at in (0, 69):
        a = f64(testing.update_inputs(rng, 2, 200, 70))
        a[3][:, fail_at, fail_at] = -1e3
        checks.append((fe.K1T, fe.fused_update, fe._update_plain, a + [0.0]))
    a = f64(testing.sigma_inputs(rng, 8, 64))
    a[1] = neg_eye(a[1])
    checks.append((fu.K6, fu.fused_sigma, fu._sigma_plain,
                   a + [2.0, "cholesky"]))
    a = f64(testing.sigma_aug_inputs(rng, 8, 64, 32))
    a[1] = neg_eye(a[1])
    checks.append((fu.K7, fu.fused_sigma_aug, fu._sigma_aug_plain,
                   a + [2.0, "cholesky"]))
    a = f64(testing.sigma_aug_inputs(rng, 8, 64, 32))
    a[3][5, 5] = -1e3
    checks.append((fu.K7, fu.fused_sigma_aug, fu._sigma_aug_plain,
                   a + [2.0, "cholesky"]))
    for B, fail_at in ((2, 0), (2, 300), (1, C5_DX - 1)):
        a = f64(testing.sigma_inputs(rng, B, C5_DX))
        a[1][B - 1, fail_at, fail_at] = -1e3
        checks.append((fu.K6T, fu.fused_sigma, fu._sigma_plain,
                       a + [2.0, "cholesky"]))
    for B, part, fail_at, dn in ((2, 1, 0, C5_DX), (2, 1, 400, C5_DX),
                                 (2, 3, 100, C5_DX), (2, 1, 300, C5_DY),
                                 (2, 3, 200, C5_DY),
                                 (1, 1, C5_DX - 1, C5_DY)):
        a = f64(testing.sigma_aug_inputs(rng, B, C5_DX, dn))
        if part == 1:
            a[1][0, fail_at, fail_at] = -1e3
        else:
            a[3][fail_at, fail_at] = -1e3
        checks.append((fu.K7T, fu.fused_sigma_aug, fu._sigma_aug_plain,
                       a + [2.0, "cholesky"]))
    a = f64(testing.ut_update_inputs(rng, 8, 128, 64, 64, 32))
    a[6] = neg_eye(a[6])
    checks.append((fu.K8, fu.fused_ut_update, fu._ut_update_plain,
                   a + [1 / 128, 0.0, True]))
    # K8 at dx = 40, dy = 70 in float64 (three panels of 32, 32, 6), and at
    # the banks' dy = 2 (one panel of 8)
    for dy, fail_at in ((70, 0), (70, 69), (2, 1)):
        a = f64(testing.ut_update_inputs(rng, 2, 100, 50, 40, dy))
        a[6][fail_at, fail_at] = -1e3
        checks.append((fu.K8, fu.fused_ut_update, fu._ut_update_plain,
                       a + [1 / 100, 2.0, True]))
    # K8t at dx = 200, dy = 70 in float64 (three panels of 32, 32, 6)
    for fail_at in (0, 69):
        a = f64(testing.ut_update_inputs(rng, 2, 400, 200, 200, 70))
        a[6][fail_at, fail_at] = -1e3
        checks.append((fu.K8T, fu.fused_ut_update, fu._ut_update_plain,
                       a + [1 / 400, 2.0, True]))
    a = f64(testing.smoother_element_inputs(rng, 64, 4))
    a[3] = neg_eye(a[3])
    checks.append((bs.K11, bs.bank_smoother_elements, bs._elements_plain, a))
    a = f64(testing.smoother_element_inputs(rng, 16, PC_DX))
    a[3] = neg_eye(a[3])
    checks.append((bs.K11B, bs.bank_smoother_elements, bs._elements_plain,
                   a))
    # K10b's inner matrix I + sym(Uᵀ J2 U) with J2 = −1e3·I: its factor
    # fails, the lane is NaN throughout on both sides (cholesky_nan), on
    # a shared-memory tile (dx = 64) and on the global route (dx = 100)
    for M, dx in ((8, PC_DX), (2, 100)):
        a = f64(testing.filter_elements(rng, M, dx, dx // 2, normalized=True)
                + testing.filter_elements(rng, M, dx, dx // 2,
                                          normalized=True))
        a[8] = neg_eye(a[8])
        checks.append((bc.K10B,
                       lambda *x: bc.bank_filter_combine(x[:5], x[5:]),
                       lambda *x: tas._combine(x[:5], x[5:]), a))
    for kernel, wrap, plain, args in checks:
        before = kernel.launches
        got, want = _as_tuple(wrap(*args)), _as_tuple(plain(*args))
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            raise RuntimeError(f"{kernel.name} did not launch on a non-PD "
                               "input")
        same = all(torch.equal(torch.isnan(g), torch.isnan(w))
                   for g, w in zip(got, want))
        if not (same and any(torch.isnan(g).any() for g in got)):
            raise RuntimeError(f"{kernel.name}: a non-PD input did not give "
                               "NaN in the same places on both sides")
        log(f"kernel {kernel.name} non-PD input: NaN on both sides ok")


def guard_checks(dev) -> None:
    """K10's Cholesky guard: lane 0's C1 has a −1e-8 eigenvalue (below the
    combine's jitter ε), lane 1's an infinite off-diagonal pair. Both
    factors fail and are zeroed (M⁻¹ = I) on both sides: the outputs must
    be non-finite in the same places, the finite ones within KERNEL_TOL,
    and lane 0 finite throughout. Lane kernel at dx = 3, 4, 5 and 8
    (groups of 4 and 8 threads, padded and full), block kernel at 9, 64
    and 512 (there in float32 with a −1e-4 eigenvalue: a
    wide float32 factor's rounding alone reaches 1e-8, so −1e-8 could
    factor on one side and fail on the other)."""
    import numpy as np
    import torch

    from bayesianfiltering_tpu_torch import testing
    from bayesianfiltering_tpu_torch.ops import associative as tas
    from bayesianfiltering_tpu_torch.ops import bank_combine as bc

    for dx in (3, KF_DX, 5, 8, 9, PC_DX, 512):
        M = 96 if dx <= PC_DX else 4
        kernel = bc.K10 if dx <= 8 else bc.K10B
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[-1]
            rng = np.random.default_rng(SEED + dx)
            if dx <= 8:
                elems = lambda: testing.filter_elements(rng, M, dx)
            else:
                elems = lambda: testing.filter_elements(rng, M, dx, dx // 2,
                                                        normalized=True)
            neg = -1e-8 if dx <= 8 or dtype == torch.float64 else -1e-4
            raw = testing.guard_lanes(rng, elems(), neg=neg) + elems()
            a = [torch.as_tensor(x, dtype=dtype, device=dev) for x in raw]
            before = kernel.launches
            got = bc.bank_filter_combine(a[:5], a[5:])
            want = tas._combine(a[:5], a[5:])
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                raise RuntimeError(f"{kernel.name} did not launch at dx={dx}")
            errs = []
            for g, w in zip(got, want):
                bad = ~torch.isfinite(w)
                if not torch.equal(bad, ~torch.isfinite(g)):
                    raise RuntimeError(f"K10 guard dx={dx} {name}: non-finite "
                                       "entries differ from the plain version")
                errs.append(rel_err(torch.where(bad, 0, g),
                                    torch.where(bad, 0, w)))
            if max(errs) > KERNEL_TOL[name] or not all(
                    torch.isfinite(g[0]).all() for g in got):
                raise RuntimeError(f"K10 guard dx={dx} {name}: {errs}")
            log(f"kernel {kernel.name} guard lanes dx={dx} {name}: same "
                f"non-finite entries, rel err {max(errs):.3e} ok")


def check_parents(dev) -> dict:
    """K5 against its plain version (the scatter), exactly, at n = 2²⁰,
    65,536 and 1,408 on the five weight profiles and at the Gaussian-sum
    reductions' m counts → n slots (and m = 1, n = 1); then K5, the scatter
    and
    ``torch.searchsorted`` timed at the path's n = 1M: by events around a
    loop of calls, and K5 and ``torch.searchsorted`` alike by their device
    time (``device_ms``) and by events around a CUDA graph of 100 calls.
    Bound: 4 bytes read and 4 written per slot (the merge's m + n
    comparisons take less at any CUDA-core rate)."""
    import numpy as np
    import torch

    from bayesianfiltering_tpu_torch import testing
    from bayesianfiltering_tpu_torch.ops import resample_gather as rg
    from bayesianfiltering_tpu_torch.utils import resampling as rs

    rng = np.random.default_rng(SEED)
    # n = 1,408: m + n is one stretch of K5's merge path exactly; 100 and
    # 20,000: the bootstrap PFs of paths F and G
    for n in (1 << 20, 1 << 16, 1408) + SLICE_PARENTS:
        for profile in testing.PARENT_PROFILES:
            counts = torch.as_tensor(testing.resampling_counts(profile, n, rng),
                                     device=dev)
            before = rg.K5.launches
            got = rg.windowed_parents(counts, n)
            want = rg._parents_plain(counts.clamp(0, n).to(torch.int32), n)
            torch.cuda.synchronize()
            if rg.K5.launches != before + 1 or not torch.equal(got, want):
                raise RuntimeError(f"K5 differs from its plain version at "
                                   f"n={n}, {profile}")
            log(f"kernel {rg.K5.name} n={n} {profile}: equal to the plain "
                "version ok")
    # the Gaussian-sum reductions keep n of m components (AGSF [50,2,2],
    # [8,2,2], UAGSF [16,2,2]), and the edges m = 1 and n = 1
    for m, n in RESAMPLE_REDUCTIONS + ((1, 1), (1, 5), (3, 1)):
        w = torch.as_tensor(rng.dirichlet(np.full(m, 0.5)), device=dev)
        counts = rs.systematic_counts(w, n, u=torch.tensor(0.37))
        before = rg.K5.launches
        got = rg.windowed_parents(counts, n)
        want = rg._parents_plain(counts.clamp(0, n).to(torch.int32), n)
        torch.cuda.synchronize()
        if rg.K5.launches != before + 1 or not torch.equal(got, want):
            raise RuntimeError(f"K5 differs from its plain version at m={m}, "
                               f"n={n}")
        log(f"kernel {rg.K5.name} m={m} n={n}: equal to the plain version ok")
    n = BPF_P
    counts = torch.as_tensor(testing.resampling_counts("dirichlet", n, rng),
                             device=dev).to(torch.int32)
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    library = lambda: torch.searchsorted(counts, slots,
                                         right=True).clamp_max_(n - 1)
    got = rg._parents_launch(counts, n)
    if not torch.equal(got.long(), library()):
        raise RuntimeError("K5 differs from torch.searchsorted")
    ms = cuda_time_ms(lambda: rg._parents_launch(counts, n))
    plain_ms = cuda_time_ms(lambda: rg._parents_plain(counts, n))
    library_ms = cuda_time_ms(library)
    dev_ms = device_ms(lambda: rg._parents_launch(counts, n),
                       KERNEL_SYMBOLS[rg.K5.name])
    library_dev_ms = device_ms(library, ("",))  # every kernel of the call
    k_graph_ms = graph_ms(lambda: rg._parents_launch(counts, n))
    library_graph_ms = graph_ms(library)
    bound_ms, bound_by = bound([counts], [got], 2 * n, "float32")
    log(f"  time at n={n} int32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.searchsorted {library_ms:.4f} ms, bound {bound_ms:.3g} ms "
        f"({bound_by}), bound share {bound_ms / ms:.3g}; device time "
        f"{dev_ms} ms, torch.searchsorted {library_dev_ms} ms; CUDA graph of "
        f"100 calls: kernel {k_graph_ms:.4f} ms, torch.searchsorted "
        f"{library_graph_ms:.4f} ms per call")
    also = []
    for m in SLICE_PARENTS:
        c = torch.as_tensor(testing.resampling_counts("dirichlet", m, rng),
                            device=dev).to(torch.int32)
        got_m = rg._parents_launch(c, m)
        lib_m = lambda: torch.searchsorted(
            c, torch.arange(m, dtype=torch.int32, device=dev),
            right=True).clamp_max_(m - 1)
        if not torch.equal(got_m.long(), lib_m()):
            raise RuntimeError(f"K5 differs from torch.searchsorted at n={m}")
        b_ms, b_by = bound([c], [got_m], 2 * m, "float32")
        entry = dict(shape=f"n={m},int32,Dirichlet(0.5)", max_abs_err=0.0,
                     ms=cuda_time_ms(lambda: rg._parents_launch(c, m)),
                     plain_ms=cuda_time_ms(lambda: rg._parents_plain(c, m)),
                     library_ms=cuda_time_ms(lib_m), bound_ms=b_ms,
                     bound_by=b_by,
                     device_ms=device_ms(lambda: rg._parents_launch(c, m),
                                         KERNEL_SYMBOLS[rg.K5.name]),
                     library_device_ms=device_ms(lib_m, ("",)))
        entry["bound_share"] = b_ms / entry["ms"]
        log(f"  time at n={m} int32: kernel {entry['ms']:.4f} ms, plain "
            f"{entry['plain_ms']:.4f} ms, torch.searchsorted "
            f"{entry['library_ms']:.4f} ms, bound {b_ms:.3g} ms ({b_by}); "
            f"device time {entry['device_ms']} ms, torch.searchsorted "
            f"{entry['library_device_ms']} ms")
        also.append(entry)
    return dict(shape=f"n={n},int32,Dirichlet(0.5)", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_share=bound_ms / ms,
                device_ms=dev_ms,
                device_bound_share=bound_ms / dev_ms if dev_ms else None,
                library_device_ms=library_dev_ms, graph_ms=k_graph_ms,
                library_graph_ms=library_graph_ms,
                library_call="torch.searchsorted", also=also)


# K6's rows get torch.linalg.cholesky_ex's time as their library time
FACTOR_LIBRARY = ("bft_ut_sigma", "bft_ut_sigma_tiled")

# The CUDA launches a wrapper call makes, at most: K8t centres, forms the
# moments, factors and forms sym(P) − ZᵀZ; K2t forms F_x P and F_q Q in
# one grouped launch, then the covariance; K9t forms μ and the centred
# points in one pass, then Σ as one product; K7t (Cholesky) factors P and
# C side by side with the points as the epilogue, one launch.
CUDA_LAUNCHES = {"bft_ut_update_tiled": 4, "bft_ekf_predict_cov_tiled": 2,
                 "bft_ut_predict_tiled": 2, "bft_ut_sigma_aug_tiled": 1}


def predict_chain(Fx, P, Fq, Q):
    """K2t's function as torch.matmul calls: F_x P F_xᵀ + F_q Q F_qᵀ,
    symmetrised (a chain of cuBLAS calls, not one call; the port never
    calls it)."""
    cov = Fx @ P @ Fx.mT + Fq @ Q @ Fq.mT
    return 0.5 * (cov + cov.mT)
# the sigma-point kernels' Cholesky reads only lower(P) (and lower(C)):
# the indices of those operands in (m, P) and (m, P, bias, C)
LOWER_READ = {"bft_ut_sigma": (1,), "bft_ut_sigma_tiled": (1,),
              "bft_ut_sigma_aug": (1, 3), "bft_ut_sigma_aug_tiled": (1, 3)}


def ut_update_reads(args, static):
    """What the UT update reads of (pts, hpts, center, μy, m, P, R,
    innov): the state's dx columns of the points (of ld), and R only where
    it is added."""
    pts, hpts, cy, mu, m, P, R, inn = args
    return ([pts[..., :m.shape[-1]], hpts, cy, mu, m, P]
            + ([R] if static[-1] else []) + [inn])


def ut_predict_reads(args, static):
    """What the UT predict reads of (fpts, center, Q): Q only where it is
    added."""
    return list(args) if static[-1] else list(args[:2])


# the operands a kernel reads, where that is not every input whole
READS = {"bft_ut_update": ut_update_reads,
         "bft_ut_update_tiled": ut_update_reads,
         "bft_ut_predict": ut_predict_reads,
         "bft_ut_predict_tiled": ut_predict_reads}


def check_kernels(dev) -> dict:
    """Phase 3. Returns, per kernel name, the timing of its main-path shape
    (float32) and of any second main-path shape."""
    import numpy as np
    import torch

    report = {}
    cuda_launch_checks(dev)
    for (pick, wrapper, plain, shape, make, static, flops,
         timed) in kernel_cases():
        raw = make(np.random.default_rng(SEED))
        for dtype in (torch.float32, torch.float64):
            args = [torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
                    for a in raw]
            kernel = pick(args[0]) if callable(pick) else pick
            before = kernel.launches
            got = _as_tuple(wrapper(*args, *static))
            want = _as_tuple(plain(*args, *static))
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                raise RuntimeError(f"{kernel.name} did not launch at {shape}")
            name = str(dtype).split(".")[-1]
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            ok = max(errs) <= KERNEL_TOL[name]
            log(f"kernel {kernel.name} {shape} {name}: rel err "
                f"{max(errs):.3e} (tol {KERNEL_TOL[name]:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok or not all(torch.isfinite(g).all() for g in got):
                raise RuntimeError(f"{kernel.name} disagrees with its plain "
                                   f"version at {shape} {name}: {errs}")
            if timed and (dtype == torch.float32
                          or kernel.name in TIMED_FLOAT64):
                abs_err = max(float((g - w).abs().max())
                              for g, w in zip(got, want))
                ms = cuda_time_ms(lambda: wrapper(*args, *static))
                plain_ms = cuda_time_ms(lambda: plain(*args, *static))
                dev_ms = device_ms(lambda: wrapper(*args, *static),
                                   KERNEL_SYMBOLS[kernel.name])
                lower = (LOWER_READ[kernel.name] if kernel.name in LOWER_READ
                         and static[-1] == "cholesky" else ())
                reads = READS.get(kernel.name, lambda a, _: a)(args, static)
                bound_ms, bound_by = bound(
                    reads, list(got), flops, name, lower,
                    issues_float64_mma(kernel.source))
                entry = dict(shape=f"{shape},{name}", max_abs_err=abs_err,
                             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bound_share=bound_ms / ms,
                             device_ms=dev_ms,
                             device_bound_share=(bound_ms / dev_ms
                                                 if dev_ms else None))
                if kernel.name in FACTOR_LIBRARY and static[-1] == "cholesky":
                    # the one PyTorch call for the factor in K6's body,
                    # timed by the same device time
                    P = args[1]
                    lib = lambda: torch.linalg.cholesky_ex(P)
                    entry.update(library_ms=device_ms(lib, ("",)),
                                 library_event_ms=cuda_time_ms(lib),
                                 library_call="torch.linalg.cholesky_ex")
                    log(f"  torch.linalg.cholesky_ex on the same P: device "
                        f"{entry['library_ms']} ms, event "
                        f"{entry['library_event_ms']:.4f} ms")
                if (kernel.name == "bft_ut_sigma_aug_tiled"
                        and static[-1] == "cholesky"):
                    # the factors of P and of C, the PyTorch calls in the
                    # plain version's body (two calls, not one)
                    P, C = args[1], args[3]
                    chain = lambda: (torch.linalg.cholesky_ex(P),
                                     torch.linalg.cholesky_ex(C))
                    entry.update(library_chain_ms=device_ms(chain, ("",)),
                                 library_chain=(
                                     "torch.linalg.cholesky_ex of P and of "
                                     "C; two calls, not one"))
                    log(f"  torch.linalg.cholesky_ex of P and of C (two "
                        f"calls): device {entry['library_chain_ms']} ms")
                if kernel.name == "bft_ekf_predict_cov_tiled":
                    chain = lambda: predict_chain(*args)
                    entry.update(library_chain_ms=device_ms(chain, ("",)),
                                 library_chain=(
                                     "torch.matmul: F_x P F_xᵀ + F_q Q F_qᵀ, "
                                     "symmetrised; a chain of cuBLAS calls, "
                                     "not one call"))
                    log(f"  the torch.matmul chain on the same inputs (a "
                        f"chain of cuBLAS calls, not one call): device "
                        f"{entry['library_chain_ms']} ms")
                if timed == "main" and dtype == torch.float32:
                    report.setdefault(kernel.name, {}).update(entry)
                else:
                    report.setdefault(kernel.name, {}).setdefault(
                        "also", []).append(entry)
                log(f"  time at {shape} {name}: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.3g} ms "
                    f"({bound_by}), bound share {bound_ms / ms:.3g}; "
                    f"device time {dev_ms} ms")
    nan_checks(dev)
    guard_checks(dev)
    report["bft_resample_parents"] = check_parents(dev)
    return report


def cuda_launch_checks(dev, calls: int = 5) -> None:
    """The CUDA launches a call of K8t, K2t, K9t and K7t (Cholesky, at the
    augmented widths dx = dn = 512) at config 5 (float32), counted by
    torch.profiler over ``calls`` calls: at most ``CUDA_LAUNCHES`` a
    call. The profiler may drop records (late in a
    long process it kept 3 of K8t's 20), never add one, so only the upper
    bound is held; phase 3 runs this first, before its other traces."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bayesianfiltering_tpu_torch import testing
    from bayesianfiltering_tpu_torch.ops import fused_ekf as fe
    from bayesianfiltering_tpu_torch.ops import fused_ut as fu

    rng = np.random.default_rng(SEED)
    on = lambda xs: [torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                     device=dev) for x in xs]
    u = on(testing.ut_update_inputs(rng, 1, 2 * C5_DX, C5_DX, C5_DX, C5_DY))
    p = on(testing.predict_inputs(rng, 1, C5_DX, C5_DX))
    f = on(testing.ut_predict_inputs(rng, 1, 2 * C5_DX, C5_DX))
    a = on(testing.sigma_aug_inputs(rng, 1, C5_DX, C5_DX))
    for kernel, fn in (
            (fu.K8T, lambda: fu.fused_ut_update(*u, 1 / 1024, 0.0, True)),
            (fe.K2T, lambda: fe.fused_predict_cov(*p)),
            (fu.K9T, lambda: fu.fused_ut_predict(*f, 1 / 1024, 0.0, 2.0,
                                                 True)),
            (fu.K7T, lambda: fu.fused_sigma_aug(*a, 1.0, "cholesky"))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type != DeviceType.CPU
                 and any(k in e.name for k in KERNEL_SYMBOLS[kernel.name])]
        most = CUDA_LAUNCHES[kernel.name]
        log(f"kernel {kernel.name}: {len(names)} CUDA launches recorded over "
            f"{calls} calls (at most {most} a call)")
        if len(names) > most * calls:
            raise RuntimeError(f"{kernel.name}: {len(names)} CUDA launches "
                               f"over {calls} calls, more than {most} a call")


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


def ukf_params(method="cholesky"):
    """ParamsUKF(1, 0, 0), the setting of every experiment."""
    from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF

    return ParamsUKF(1.0, 0.0, 0.0, method)


def rb_problem(T, dtype, dev):
    """The T=500 BOT experiment's range-bearing model and schedule."""
    import torch

    from bayesianfiltering_tpu_torch.models import zoo

    model, params, _ = zoo.range_bearing_tracking(dtype=dtype, device=dev)
    inputs = zoo.bot_experiment_inputs(T, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2 * T)
    states, emissions = model.sample(params, T, inputs=inputs, generator=gen)
    return params, inputs, states, emissions


UKF_MIXTURE_RUNS = [
    # the BOT experiment's UGSF (M=100) and its recommended UAGSF recipe
    ("ugsf M=100", UGSF_M),
    ("uagsf [16,2,2]", UAGSF_COMPS),
]


def run_ukf_mixture(label, comps, params, inputs, emissions, draws):
    from bayesianfiltering_tpu_torch import inference as inf

    if label.startswith("ugsf"):
        return inf.unscented_gaussian_sum_filter(
            params, ukf_params(), emissions, comps, inputs=inputs,
            init_eps=draws.init)
    return inf.unscented_agsf(params, ukf_params(), emissions, comps,
                              opt_args=(0.9, 0.9), inputs=inputs,
                              reduction="systematic", draws=draws)[0]


def kf_problem(T, dtype, dev):
    """Path B's model (experiments/parallel_kf_bench.py): dx=4, dy=2,
    F = 0.99·I + 0.01·N(0,1)/dx, H = N(0,1)/dx, Q = R = 0.1·I, from the
    seed; emissions N(0, 1), made on the device."""
    import numpy as np
    import torch

    from bayesianfiltering_tpu_torch import testing
    from bayesianfiltering_tpu_torch.ops.linear import ParamsLGSSM

    fields = testing.lgssm_fields(np.random.default_rng(SEED), KF_DX, KF_DY)
    params = ParamsLGSSM(**{k: torch.as_tensor(v, dtype=dtype, device=dev)
                            for k, v in fields.items()})
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    ys = torch.randn(T, KF_DY, generator=gen, dtype=dtype, device=dev)
    return params, ys


def bpf_problem(T, dtype, dev):
    """Path A's model (experiments/headline_bench.py): Lorenz-96 dx=8, dy=4,
    data from the RK4 model, one sequence; the filter on the Euler model."""
    import torch

    from bayesianfiltering_tpu_torch.models import zoo

    _, _, bpf = zoo.lorenz96(BPF_DX, BPF_DY, dtype=dtype, device=dev)
    dm, dp, _ = zoo.lorenz96(BPF_DX, BPF_DY, integrator="rk4", dtype=dtype,
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + T)
    states, emissions = dm.sample(dp, T, generator=gen)
    return bpf, states, emissions


def config5_data(T, dtype, dev, dx=C5_DX, dy=C5_DY):
    """BASELINE config 5 (experiments/headline_bench.py:90-98): the Euler
    filter model's parameters and one sequence of RK4 data, Lorenz-96
    dx=512, dy=256 (path N: dx=2,048, dy=1,024)."""
    import torch

    from bayesianfiltering_tpu_torch.models import zoo

    _, params, _ = zoo.lorenz96(dx, dy, dtype=dtype, device=dev)
    dm, dp, _ = zoo.lorenz96(dx, dy, integrator="rk4", dtype=dtype,
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + dx)
    states, emissions = dm.sample(dp, T, generator=gen)
    if not torch.isfinite(emissions).all():
        raise RuntimeError(f"Lorenz-96 dx={dx} RK4 data are not finite")
    return params, states, emissions


def config5_runs(dx=C5_DX, dy=C5_DY):
    """Config 5's three filters (path N's at dx=2,048): (label, call on
    (params, emissions), the exact launches per step of each kernel). The
    EKF's and the UKF's elements do not fit one SM's shared memory, so
    they run the tiled K1t/K2t, K6t, K8t and K9t."""
    from bayesianfiltering_tpu_torch import inference as inf

    return [
        (f"ekf{dx}", lambda p, e: inf.extended_kalman_filter(p, e),
         {"bft_ekf_update_tiled": 1, "bft_ekf_predict_cov_tiled": 1}),
        (f"ekf{dx} update_chunk=128",
         lambda p, e: inf.extended_kalman_filter(p, e, update_chunk=C5_CHUNK),
         {"bft_ekf_update_tiled": -(-dy // C5_CHUNK),
          "bft_ekf_predict_cov_tiled": 1}),
        (f"ukf{dx} additive cholesky",
         lambda p, e: inf.unscented_kalman_filter(p, ukf_params(), e,
                                                  additive=True),
         {"bft_ut_sigma_tiled": 2, "bft_ut_update_tiled": 1,
          "bft_ut_predict_tiled": 1}),
    ]


def path_c_problem(T, dtype, dev, dx=PC_DX, dy=PC_DY):
    """Path C: ``zoo.linear_gaussian_lgssm(64, 32)`` (the widths of
    bench.py's Lorenz-96 filter; path N's smoother at (1,024, 512)) with
    N(0, 1) emissions made on the device, as path B's."""
    import torch

    from bayesianfiltering_tpu_torch.models import zoo

    params = zoo.linear_gaussian_lgssm(dx, dy, dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + dx)
    ys = torch.randn(T, dy, generator=gen, dtype=dtype, device=dev)
    return params, ys


def path_n_smoother_expect(T):
    """Path N's smoother's exact launches at T steps (chunk 128): the block
    kernels only, a combine of each scan a launch, the elements once."""
    return {"bft_block_combine": chunked_combines(T),
            "bft_block_smoother_elements": 1,
            "bft_block_smoother_combine": chunked_combines(T)}


def path_c_expect(solver):
    """Path C's exact launches: the block combines only (the native
    solver's filtering combine has no kernel)."""
    return {"bft_block_combine": PC_COMBINES if solver == "woodbury" else 0,
            "bft_block_smoother_elements": 1,
            "bft_block_smoother_combine": PC_COMBINES}


def flat_combines(T: int) -> int:
    """Combines of ``ops.associative._log_depth_scan`` over T elements that
    have lanes (a launch each on the card): a pairing level, the scan of
    the T/2 pairs, and a level of even prefixes unless it is empty."""
    if T < 2:
        return 0
    return 1 + flat_combines(T // 2) + (1 if T % 2 or T // 2 > 1 else 0)


def chunked_combines(T: int, chunk: int = KF_CHUNK) -> int:
    """Combines of ``chunked_associative_scan`` over T elements: ``chunk``
    in-chunk steps, the scan of the chunk aggregates, one broadcast; T
    sequential ones at T ≤ chunk (320 at 1M, 262 at 65,536)."""
    if T <= chunk:
        return T
    return chunk + chunked_combines(-(-T // chunk), chunk) + 1


def scan_expect(T: int, chunk, passes: int, wide: bool = False) -> dict:
    """Exact launches of ``passes`` time-varying smoother passes over T
    steps (chunk "auto" is the flat scan up to 4,096 steps): K10, K12 a
    combine each and K11 once a pass, or their block variants."""
    combines = passes * (flat_combines(T)
                         if chunk is None or (chunk == "auto" and T <= 4096)
                         else chunked_combines(T, KF_CHUNK if chunk == "auto"
                                               else chunk))
    if wide:
        return {"bft_block_combine": combines,
                "bft_block_smoother_elements": passes,
                "bft_block_smoother_combine": combines}
    return {"bft_bank_combine": combines,
            "bft_bank_smoother_elements": passes,
            "bft_bank_smoother_combine": combines}


def tv_problem(T, dx, dy, dtype, dev):
    """(m0, P0, Fs, cs, Qs, Hs, ds, Rs, ys) of a random time-varying model
    from the seed (``tests/test_parallel_iterated.py``'s, its random
    factors scaled by 1/√dx so that the spectra stay O(1) at dx = 64)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + dx)
    f = 1.0 / np.sqrt(dx)
    eye = np.eye(dx)
    mats = f * rng.standard_normal((T, dx, dx))
    em = rng.standard_normal((T, dy, dy)) / np.sqrt(dy)
    arrays = (rng.standard_normal(dx), eye,
              0.7 * eye + 0.1 * f * rng.standard_normal((T, dx, dx)),
              0.1 * rng.standard_normal((T, dx)),
              0.5 * mats @ np.swapaxes(mats, -1, -2) + eye,
              f * rng.standard_normal((T, dy, dx)),
              0.1 * rng.standard_normal((T, dy)),
              0.5 * em @ np.swapaxes(em, -1, -2) + np.eye(dy),
              rng.standard_normal((T, dy)))
    return [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays]


def smoother_runs(T: int, num_iter: int):
    """Path D's five smoothers (experiments/smoother_experiment.py:54-74):
    (label, call on (params, inputs, emissions) returning the smoothed
    posterior, exact launches). Each EKF pass is T K1 and T K2 launches;
    the URTS's forward UKF 2T K7, T K8 and T K9; every iterated smoother
    seeds with one EKF pass and runs num_iter + 1 smoother passes (the LM
    variant's num_iter candidate passes, then the final one), each a flat
    scan at these T."""
    from bayesianfiltering_tpu_torch import inference as inf

    up = ukf_params()
    ekf = {"bft_ekf_update": T, "bft_ekf_predict_cov": T}
    iterated = {**ekf, **scan_expect(T, "auto", num_iter + 1)}
    return [
        ("erts", lambda p, u, e: inf.extended_rts_smoother(p, e, inputs=u),
         ekf),
        ("urts", lambda p, u, e: inf.unscented_rts_smoother(p, up, e,
                                                            inputs=u),
         {"bft_ut_sigma_aug": 2 * T, "bft_ut_update": T,
          "bft_ut_predict": T}),
        ("ieks", lambda p, u, e: inf.parallel_iterated_extended_smoother(
            p, e, num_iter=num_iter, inputs=u, nominal="filter",
            damping=PD_DAMPING)[0], iterated),
        ("lm-ieks", lambda p, u, e: inf.parallel_iterated_extended_smoother(
            p, e, num_iter=num_iter, inputs=u, nominal="filter",
            lm_lambda=PD_LM_LAMBDA)[0], iterated),
        ("ipls", lambda p, u, e: inf.parallel_iterated_sigma_point_smoother(
            p, up, e, num_iter=num_iter, inputs=u, nominal="filter")[0],
         iterated),
    ]


SMOOTHED = ("filtered_means", "filtered_covariances", "smoothed_means",
            "smoothed_covariances", "marginal_loglik")


def compare_smoothed(label, got, want, tol) -> None:
    import torch

    torch.cuda.synchronize()
    errs = {n: rel_err(getattr(got, n), getattr(want, n)) for n in SMOOTHED}
    finite = all(torch.isfinite(getattr(got, n)).all() for n in SMOOTHED)
    ok = max(errs.values()) <= tol and finite
    log(f"{label} card vs cpu: " + ", ".join(f"{n} {e:.3e}"
                                             for n, e in errs.items())
        + f" (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: the kernel path disagrees with the "
                           "plain path")


def compare_smoothers(dev) -> None:
    """Phase 4's smoothing side: the time-varying parallel filter and
    smoother at the BOT widths and at path C's, float32 and float64, and
    path D's five smoothers at T=100 with 3 iterations in float64, each
    with its exact launches on the card."""
    import torch

    from bayesianfiltering_tpu_torch.models import zoo
    from bayesianfiltering_tpu_torch.ops import associative as tas

    for dx, dy, T, chunk in TV_CMP:
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[-1]
            args = tv_problem(T, dx, dy, dtype, dev)
            got, _ = run_path(
                f"tv smoother dx={dx} T={T} chunk={chunk} {name}",
                lambda: tas.parallel_kalman_smoother_tv(*args, chunk=chunk),
                scan_expect(T, chunk, 1, wide=dx > 8), others_zero=True)
            want = tas.parallel_kalman_smoother_tv(*(a.cpu() for a in args),
                                                   chunk=chunk)
            compare_smoothed(f"tv smoother dx={dx} dy={dy} T={T} "
                             f"chunk={chunk} {name}", got, want,
                             EKF_TOL[name])

    params, inputs, _, em = rb_problem(PD_CMP_T, torch.float64, dev)
    cpu_params = zoo.range_bearing_tracking(dtype=torch.float64,
                                            device="cpu")[1]
    for label, run, expect in smoother_runs(PD_CMP_T, PD_CMP_ITER):
        got, _ = run_path(f"{label} range-bearing T={PD_CMP_T} float64",
                          lambda: run(params, inputs, em), expect,
                          others_zero=True)
        want = run(cpu_params, inputs.cpu(), em.cpu())
        compare_smoothed(f"{label} range-bearing T={PD_CMP_T} "
                         f"{PD_CMP_ITER} iterations float64", got, want,
                         EKF_TOL["float64"])


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
        cpu_params = zoo.bearings_only_tracking(dtype=torch.float64,
                                                device="cpu")[1]
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

    for additive in (True, False):
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[-1]
            em = em64.to(dtype)
            params = {d: zoo.lorenz96(EKF_DX, EKF_DY, dtype=dtype, device=d)[1]
                      for d in (dev, "cpu")}
            got = inf.unscented_kalman_filter(params[dev], ukf_params(), em,
                                              additive=additive)
            want = inf.unscented_kalman_filter(params["cpu"], ukf_params(),
                                               em.cpu(), additive=additive)
            torch.cuda.synchronize()
            e_m = rel_err(got.filtered_means, want.filtered_means)
            e_ll = rel_err(got.marginal_loglik, want.marginal_loglik)
            ok = max(e_m, e_ll) <= EKF_TOL[name]
            log(f"ukf {'additive' if additive else 'augmented'} lorenz96 "
                f"B={CMP_B} T={CMP_T} {name} card vs cpu: means {e_m:.3e}, "
                f"loglik {e_ll:.3e} (tol {EKF_TOL[name]:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("UKF kernel path disagrees with the plain "
                                   "path")

    params, inputs, _, emissions = rb_problem(RB_CMP_T, torch.float64, dev)
    cpu_params = zoo.range_bearing_tracking(dtype=torch.float64,
                                            device="cpu")[1]
    for label, comps in UKF_MIXTURE_RUNS:
        draws = mixture_draws(comps, RB_CMP_T, 4, emissions)
        got = run_ukf_mixture(label, comps, params, inputs, emissions, draws)
        cpu_draws = type(draws)(*(None if d is None else d.cpu()
                                  for d in draws))
        want = run_ukf_mixture(label, comps, cpu_params, inputs.cpu(),
                               emissions.cpu(), cpu_draws)
        torch.cuda.synchronize()
        errs = [rel_err(got.means, want.means),
                rel_err(got.weights, want.weights),
                rel_err(got.marginal_loglik, want.marginal_loglik)]
        ok = max(errs) <= MIXTURE_TOL
        log(f"{label} range-bearing T={RB_CMP_T} float64 card vs cpu: means "
            f"{errs[0]:.3e}, weights {errs[1]:.3e}, loglik {errs[2]:.3e} "
            f"(tol {MIXTURE_TOL:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label} kernel path disagrees with the plain "
                               "path")

    # the bootstrap PF over K5's gate, float64, the same draws on both
    from bayesianfiltering_tpu_torch.ops import associative as tas
    from bayesianfiltering_tpu_torch.ops import resample_gather as rg

    bpf, _, em = bpf_problem(BPF_CMP_T, torch.float64, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    draws = inf.bpf_draws(gen, BPF_CMP_T, BPF_CMP_P, BPF_DX, BPF_DX,
                          "systematic", em)
    before = rg.K5.launches
    got = inf.bootstrap_particle_filter(bpf, em, BPF_CMP_P, store="summary",
                                        draws=draws)
    torch.cuda.synchronize()
    launched = rg.K5.launches - before
    cpu_bpf = zoo.lorenz96(BPF_DX, BPF_DY, dtype=torch.float64,
                           device="cpu")[2]
    want = inf.bootstrap_particle_filter(
        cpu_bpf, em.cpu(), BPF_CMP_P, store="summary",
        draws=inf.BPFDraws(*(d.cpu() for d in draws)))
    errs = [rel_err(got["means"], want["means"]),
            rel_err(got["ess"], want["ess"])]
    ok = max(errs) <= MIXTURE_TOL and launched > 0
    log(f"bpf lorenz96 dx={BPF_DX} P={BPF_CMP_P} T={BPF_CMP_T} float64 card vs "
        f"cpu: means {errs[0]:.3e}, ess {errs[1]:.3e} (tol {MIXTURE_TOL:.0e}),"
        f" K5 launches {launched} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("BPF kernel path disagrees with the plain path")

    # the parallel Kalman smoother, chunk 128
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        params, ys = kf_problem(KF_CMP_T, dtype, dev)
        got = tas.parallel_kalman_smoother(params, ys, chunk=KF_CHUNK)
        cpu_params = type(params)(*(x.cpu() for x in params[:6]))
        want = tas.parallel_kalman_smoother(cpu_params, ys.cpu(),
                                            chunk=KF_CHUNK)
        torch.cuda.synchronize()
        errs = {n: rel_err(getattr(got, n), getattr(want, n))
                for n in ("filtered_means", "filtered_covariances",
                          "smoothed_means", "smoothed_covariances",
                          "marginal_loglik")}
        ok = max(errs.values()) <= EKF_TOL[name]
        log(f"parallel kalman smoother T={KF_CMP_T} chunk={KF_CHUNK} {name} "
            f"card vs cpu: " + ", ".join(f"{n} {e:.3e}"
                                         for n, e in errs.items())
            + f" (tol {EKF_TOL[name]:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("parallel smoother kernel path disagrees with "
                               "the plain path")

    # BASELINE config 5 in float64 at T = 20
    params, _, em = config5_data(C5_CMP_T, torch.float64, dev)
    cpu_params = zoo.lorenz96(C5_DX, C5_DY, dtype=torch.float64,
                              device="cpu")[1]
    for label, run, _ in config5_runs():
        got = run(params, em)
        want = run(cpu_params, em.cpu())
        torch.cuda.synchronize()
        errs = {n: rel_err(getattr(got, n), getattr(want, n))
                for n in ("filtered_means", "filtered_covariances",
                          "marginal_loglik")}
        ok = max(errs.values()) <= EKF_TOL["float64"]
        log(f"{label} lorenz96 dx={C5_DX} dy={C5_DY} T={C5_CMP_T} float64 "
            "card vs cpu: " + ", ".join(f"{n} {e:.3e}"
                                        for n, e in errs.items())
            + f" (tol {EKF_TOL['float64']:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label} kernel path disagrees with the "
                               "plain path")

    compare_path_n(dev)

    # path C: the parallel smoother above the lane band, both solvers
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        params, ys = path_c_problem(PC_CMP_T, dtype, dev)
        cpu_params = type(params)(*(x.cpu() for x in params[:6]))
        for solver in ("woodbury", "native"):
            got = tas.parallel_kalman_smoother(params, ys, solver=solver,
                                               chunk=KF_CHUNK)
            want = tas.parallel_kalman_smoother(cpu_params, ys.cpu(),
                                                solver=solver, chunk=KF_CHUNK)
            torch.cuda.synchronize()
            errs = {n: rel_err(getattr(got, n), getattr(want, n))
                    for n in ("filtered_means", "filtered_covariances",
                              "smoothed_means", "smoothed_covariances",
                              "marginal_loglik")}
            ok = max(errs.values()) <= EKF_TOL[name]
            log(f"path C parallel kalman smoother dx={PC_DX} dy={PC_DY} "
                f"T={PC_CMP_T} chunk={KF_CHUNK} {solver} {name} card vs cpu: "
                + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                + f" (tol {EKF_TOL[name]:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"path C ({solver}, {name}) kernel path "
                                   "disagrees with the plain path")

    compare_smoothers(dev)
    compare_slice(dev)
    compare_fitting(dev)


def compare_path_n(dev) -> None:
    """Phase 4's path N in float64: its three filters at T = PN_CMP_T and
    its smoother at T = PN_S_CMP_T, card against CPU, each with its exact
    launches."""
    import torch

    from bayesianfiltering_tpu_torch.models import zoo
    from bayesianfiltering_tpu_torch.ops import associative as tas

    params, _, em = config5_data(PN_CMP_T, torch.float64, dev, PN_DX, PN_DY)
    cpu_params = zoo.lorenz96(PN_DX, PN_DY, dtype=torch.float64,
                              device="cpu")[1]
    for label, run, per_step in config5_runs(PN_DX, PN_DY):
        t0 = time.perf_counter()
        got, _ = run_path(f"path N {label} T={PN_CMP_T} float64",
                          lambda: run(params, em),
                          {n: k * PN_CMP_T for n, k in per_step.items()},
                          others_zero=True)
        t1 = time.perf_counter()
        want = run(cpu_params, em.cpu())
        t2 = time.perf_counter()
        errs = {n: rel_err(getattr(got, n), getattr(want, n))
                for n in ("filtered_means", "filtered_covariances",
                          "marginal_loglik")}
        ok = max(errs.values()) <= EKF_TOL["float64"]
        log(f"path N {label} lorenz96 dx={PN_DX} dy={PN_DY} T={PN_CMP_T} "
            "float64 card vs cpu: " + ", ".join(f"{n} {e:.3e}"
                                                for n, e in errs.items())
            + f" (tol {EKF_TOL['float64']:.0e}) {'ok' if ok else 'FAIL'}; "
            f"card {t1 - t0:.1f} s, cpu {t2 - t1:.1f} s")
        if not ok:
            raise RuntimeError(f"path N {label}: kernel path disagrees with "
                               "the plain path")
    params, ys = path_c_problem(PN_S_CMP_T, torch.float64, dev, PN_SDX,
                                PN_SDY)
    cpu_params = type(params)(*(x.cpu() for x in params[:6]))
    t0 = time.perf_counter()
    got, _ = run_path(f"path N parallel kalman smoother T={PN_S_CMP_T} "
                      "float64",
                      lambda: tas.parallel_kalman_smoother(
                          params, ys, solver="woodbury", chunk=KF_CHUNK),
                      path_n_smoother_expect(PN_S_CMP_T), others_zero=True)
    t1 = time.perf_counter()
    want = tas.parallel_kalman_smoother(cpu_params, ys.cpu(),
                                        solver="woodbury", chunk=KF_CHUNK)
    t2 = time.perf_counter()
    errs = {n: rel_err(getattr(got, n), getattr(want, n))
            for n in ("filtered_means", "filtered_covariances",
                      "smoothed_means", "smoothed_covariances",
                      "marginal_loglik")}
    ok = max(errs.values()) <= EKF_TOL["float64"]
    log(f"path N parallel kalman smoother dx={PN_SDX} dy={PN_SDY} "
        f"T={PN_S_CMP_T} chunk={KF_CHUNK} woodbury float64 card vs cpu: "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (tol {EKF_TOL['float64']:.0e}) {'ok' if ok else 'FAIL'}; "
        f"card {t1 - t0:.1f} s, cpu {t2 - t1:.1f} s")
    if not ok:
        raise RuntimeError("path N smoother: kernel path disagrees with the "
                           "plain path")


def run_path(label, fn, expect, others_zero=False):
    """Run one main path with every launch counter reset just before it and
    read just after. ``expect`` maps kernel names to their exact launch
    count, or to None for "at least one"; with ``others_zero`` every other
    kernel must not have launched."""
    import torch

    from bayesianfiltering_tpu_torch import _build

    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in _build.KERNELS}
    if others_zero:
        expect = {**{name: 0 for name in counts}, **expect}
    for name, want in expect.items():
        if (counts[name] == 0) if want is None else (counts[name] != want):
            raise RuntimeError(f"{label}: {name} launched {counts[name]} "
                               "times, expected "
                               f"{'at least one' if want is None else want}")
    log(f"{label}: launches {({k: v for k, v in counts.items() if v})}")
    return out, counts


def repeated(label, fn, expect, add, reps=REPS):
    """``reps`` calls of one path in one process, each with every counter
    reset just before it and read just after (``run_path``, every kernel
    outside ``expect`` held to 0). Adds the first call's launches to the
    totals; returns the last output and each call's seconds (CUDA
    events)."""
    secs = []
    for i in range(reps):
        (out, sec), counts = run_path(f"{label} (call {i + 1})",
                                      lambda: timed(fn), expect,
                                      others_zero=True)
        if i == 0:
            add(counts)
        secs.append(sec)
    return out, secs


def spread(secs) -> str:
    return (f"median {statistics.median(secs):.4f} s (min {min(secs):.4f}, "
            f"max {max(secs):.4f}; {len(secs)} calls)")


def timed(fn):
    """``fn()`` between two CUDA events; returns (result, seconds)."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / 1e3


def check_gaussian_posterior(label, post, shape):
    import torch

    if tuple(post.filtered_means.shape) != shape:
        raise RuntimeError(f"{label}: means shape "
                           f"{tuple(post.filtered_means.shape)}")
    if not (torch.isfinite(post.filtered_means).all()
            and torch.isfinite(post.filtered_covariances).all()
            and torch.isfinite(post.marginal_loglik).all()):
        raise RuntimeError(f"{label}: outputs are not finite")


def check_mixture(label, post, T):
    import torch

    M = post.means.shape[0]
    if tuple(post.means.shape) != (M, T, 4) or not (
            torch.isfinite(post.means).all()
            and torch.isfinite(post.weights).all()
            and torch.isfinite(post.marginal_loglik)):
        raise RuntimeError(f"{label}: outputs not finite or misshapen")
    return (post.weights[..., None] * post.means).sum(0)


def main_path(dev, card: str) -> dict:
    """Phase 5: each main path with fresh launch counters. Returns every
    kernel's launches summed over the paths."""
    import torch

    from bayesianfiltering_tpu_torch import _build
    from bayesianfiltering_tpu_torch import inference as inf
    from bayesianfiltering_tpu_torch.utils import metrics

    total = {k.name: 0 for k in _build.KERNELS}
    refs = {}  # the single-process outputs path M is held to

    def add(counts):
        for name, n in counts.items():
            total[name] += n

    params, _, emissions = lorenz96_data(dev, torch.float32)
    refs["l96"] = emissions
    bot = {T: bot_problem(T, torch.float32, dev) for _, _, T in MIXTURE_RUNS}
    draws = {label: mixture_draws(comps, T, 4, bot[T][3])
             for label, comps, T in MIXTURE_RUNS}
    # warm-up: short runs at the full batch and width
    inf.extended_kalman_filter(params, emissions[:, :20])
    for additive in (True, False):
        inf.unscented_kalman_filter(params, ukf_params(), emissions[:, :20],
                                    additive=additive)
    torch.cuda.synchronize()

    # the batched EKF
    (post, secs), counts = run_path(
        "ekf lorenz96",
        lambda: timed(lambda: inf.extended_kalman_filter(params, emissions)),
        {"bft_ekf_update": EKF_T, "bft_ekf_predict_cov": EKF_T,
         "bft_ekf_update_tiled": 0, "bft_ekf_predict_cov_tiled": 0})
    add(counts)
    check_gaussian_posterior("ekf", post, (EKF_B, EKF_T, EKF_DX))
    refs["ekf_means"] = post.filtered_means
    log(f"ekf lorenz96 dx={EKF_DX} dy={EKF_DY} B={EKF_B} T={EKF_T} float32: "
        f"{secs:.3f} s, timestep-equiv/s: {EKF_B * EKF_T / secs:.1f} ({card})")

    # the GSF and AGSF on bearings-only tracking
    for label, comps, T in MIXTURE_RUNS:
        params_b, inputs, states, em = bot[T]
        t0 = time.perf_counter()
        (post, _), counts = run_path(
            f"{label} bot",
            lambda: run_mixture(label, comps, params_b, inputs, em,
                                draws[label]),
            # the AGSF reduces M·N·L → M once per step through K5; the GSF
            # never resamples
            {"bft_bank_update": None, "bft_bank_predict_cov": None,
             "bft_resample_parents": 0 if label.startswith("gsf") else T})
        wall = time.perf_counter() - t0
        add(counts)
        est = check_mixture(label, post, T)
        if label == f"gsf M={PM_GSF_M}" and T == PM_GSF_T:
            refs.update(gsf=post, gsf_eps=draws[label].init, bot100=bot[T])
        rmse = float(((est - states) ** 2).mean().sqrt())
        log(f"{label} bot T={T} float32: wall {wall:.3f} s, rmse {rmse:.4f}, "
            f"loglik {float(post.marginal_loglik):.3f}")

    # the batched UKF on the same Lorenz-96 data
    for additive, method, T in ((True, "cholesky", EKF_T),
                                (False, "cholesky", EKF_T),
                                (True, "sqrtm", UKF_SQRTM_T)):
        kind = "additive" if additive else "augmented"
        sigma = "bft_ut_sigma" if additive else "bft_ut_sigma_aug"
        up, em = ukf_params(method), emissions[:, :T]
        (post, secs), counts = run_path(
            f"ukf {kind} {method} lorenz96",
            lambda: timed(lambda: inf.unscented_kalman_filter(
                params, up, em, additive=additive)),
            {sigma: 2 * T, "bft_ut_update": T, "bft_ut_predict": T,
             "bft_ut_update_tiled": 0, "bft_ut_predict_tiled": 0,
             "bft_ut_sigma_tiled": 0, "bft_ut_sigma_aug_tiled": 0})
        add(counts)
        check_gaussian_posterior("ukf", post, (EKF_B, T, EKF_DX))
        log(f"ukf {kind} {method} lorenz96 dx={EKF_DX} dy={EKF_DY} B={EKF_B} "
            f"T={T} float32: {secs:.3f} s, timestep-equiv/s: "
            f"{EKF_B * T / secs:.1f} ({card})")

    # the UGSF and UAGSF on the T=500 range-bearing experiment
    params_r, inputs, states, em = rb_problem(BOT_EXP_T, torch.float32, dev)
    for label, comps in UKF_MIXTURE_RUNS:
        d = mixture_draws(comps, BOT_EXP_T, 4, em)
        t0 = time.perf_counter()
        post, counts = run_path(
            f"{label} range-bearing",
            lambda: run_ukf_mixture(label, comps, params_r, inputs, em, d),
            {"bft_ut_sigma_aug": 2 * BOT_EXP_T, "bft_ut_update": BOT_EXP_T,
             "bft_ut_predict": BOT_EXP_T, "bft_ut_update_tiled": 0,
             "bft_ut_predict_tiled": 0, "bft_ut_sigma_aug_tiled": 0,
             "bft_resample_parents": 0 if label.startswith("ugsf")
             else BOT_EXP_T})
        wall = time.perf_counter() - t0
        add(counts)
        est = check_mixture(label, post, BOT_EXP_T)
        log(f"{label} range-bearing T={BOT_EXP_T} float32: wall {wall:.3f} s, "
            f"rmse {float(metrics.rmse(est, states)):.4f} (utils.metrics.rmse), "
            f"loglik {float(post.marginal_loglik):.3f} ({card})")
    # path A: the bootstrap PF at 1M particles
    bpf, states, em = bpf_problem(BPF_T, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    inf.bootstrap_particle_filter(bpf, em[:5], BPF_P, gen, store="summary")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (out, secs), counts = run_path(
        "bpf lorenz96",
        lambda: timed(lambda: inf.bootstrap_particle_filter(
            bpf, em, BPF_P, gen, store="summary")),
        {"bft_resample_parents": None})
    add(counts)
    resampled = int((out["ess"] < 0.5 * BPF_P).sum())
    if counts["bft_resample_parents"] != resampled:
        raise RuntimeError(f"bpf: K5 launched {counts['bft_resample_parents']} "
                           f"times for {resampled} resampling steps")
    if (tuple(out["means"].shape) != (BPF_T, BPF_DX)
            or tuple(out["ess"].shape) != (BPF_T,)
            or not torch.isfinite(out["means"]).all()):
        raise RuntimeError("bpf: outputs not finite or misshapen")
    refs.update(bpf_em=em, bpf_states=states,
                bpf_rmse=float(metrics.rmse(out["means"], states)))
    log(f"bpf lorenz96 dx={BPF_DX} dy={BPF_DY} P={BPF_P} T={BPF_T} float32: "
        f"{secs:.4f} s, {BPF_T / secs:.1f} steps/s, "
        f"{BPF_P * BPF_T / secs:.4e} particle-steps/s, {resampled} "
        f"resampling steps, rmse {float(metrics.rmse(out['means'], states)):.4f}"
        f", peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({card})")

    # path B: the parallel Kalman smoother at T = 1M
    from bayesianfiltering_tpu_torch.ops import associative as tas

    params, ys = kf_problem(KF_T, torch.float32, dev)
    tas.parallel_kalman_smoother(params, ys[:KF_CMP_T], chunk=KF_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (post, secs), counts = run_path(
        "parallel kalman smoother",
        lambda: timed(lambda: tas.parallel_kalman_smoother(params, ys,
                                                           chunk=KF_CHUNK)),
        {"bft_bank_combine": KF_COMBINES, "bft_bank_smoother_elements": 1,
         "bft_bank_smoother_combine": KF_COMBINES})
    add(counts)
    for name in ("filtered_means", "smoothed_means", "smoothed_covariances"):
        x = getattr(post, name)
        if x.shape[0] != KF_T or not torch.isfinite(x).all():
            raise RuntimeError(f"parallel smoother: {name} not finite or "
                               "misshapen")
    refs.update(kf_ys=ys, kf_smoothed_means=post.smoothed_means)
    log(f"parallel kalman smoother dx={KF_DX} dy={KF_DY} T={KF_T} "
        f"chunk={KF_CHUNK} float32: {secs:.4f} s, {KF_T / secs:.1f} steps/s, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({card})")

    # BASELINE config 5: Lorenz-96 dx=512, dy=256, one sequence, T=200
    params, states, em = config5_data(C5_T, torch.float32, dev)
    for _, run, _ in config5_runs():  # warm-up
        run(params, em[:3])
    torch.cuda.synchronize()
    for label, run, per_step in config5_runs():
        post, secs = repeated(
            f"{label} lorenz96", lambda: run(params, em),
            {name: n * C5_T for name, n in per_step.items()}, add)
        check_gaussian_posterior(label, post, (C5_T, C5_DX))
        med = statistics.median(secs)
        log(f"{label} lorenz96 dx={C5_DX} dy={C5_DY} B=1 T={C5_T} float32: "
            f"{spread(secs)}, {C5_T / med:.1f} steps/s at the median, rmse "
            f"{float(metrics.rmse(post.filtered_means, states)):.4f} "
            f"({card})")

    path_n(dev, card, add)

    # path C: the parallel smoother at dx=64, T=65,536, both solvers
    params, ys = path_c_problem(PC_T, torch.float32, dev)
    for solver in ("woodbury", "native"):
        tas.parallel_kalman_smoother(params, ys[:PC_CMP_T], solver=solver,
                                     chunk=KF_CHUNK)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        post, secs = repeated(
            f"path C parallel kalman smoother {solver}",
            lambda: tas.parallel_kalman_smoother(params, ys, solver=solver,
                                                 chunk=KF_CHUNK),
            path_c_expect(solver), add)
        for name in ("filtered_means", "smoothed_means",
                     "smoothed_covariances"):
            x = getattr(post, name)
            if x.shape[0] != PC_T or not torch.isfinite(x).all():
                raise RuntimeError(f"path C ({solver}): {name} not finite or "
                                   "misshapen")
        med = statistics.median(secs)
        log(f"path C parallel kalman smoother {solver} dx={PC_DX} "
            f"dy={PC_DY} T={PC_T} chunk={KF_CHUNK} float32: {spread(secs)}, "
            f"{PC_T / med:.1f} steps/s at the median, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    # path D: the BOT smoothing comparison at T=250, 8 iterations
    params_d, inputs_d, states_d, em_d = rb_problem(PD_T, torch.float32,
                                                    dev)
    runs = smoother_runs(PD_T, PD_ITER)
    for _, run, _ in runs:  # warm-up
        run(params_d, inputs_d[:20], em_d[:20])
    torch.cuda.synchronize()
    for label, run, expect in runs:
        post, secs = repeated(
            f"path D {label} range-bearing",
            lambda: run(params_d, inputs_d, em_d), expect, add, PD_REPS)
        for name in ("smoothed_means", "smoothed_covariances"):
            x = getattr(post, name)
            if x.shape[0] != PD_T or not torch.isfinite(x).all():
                raise RuntimeError(f"path D ({label}): {name} not finite "
                                   "or misshapen")
        log(f"path D {label} range-bearing T={PD_T} float32 (max |state| "
            f"{float(states_d.abs().max()):.1f}): {spread(secs)}, rmse "
            f"{float(metrics.rmse(post.smoothed_means, states_d)):.4f} "
            f"(filtered {float(metrics.rmse(post.filtered_means, states_d)):.4f}"
            f"; utils.metrics.rmse) ({card})")

    # path E: the IEKS row of the parallel benchmark on the UNGM
    post, secs = path_e(dev, PE_T, add)
    log(f"path E ieks scalar growth T={PE_T} {PE_ITER} iterations "
        f"chunk={KF_CHUNK} float32: {secs:.4f} s, {PE_T / secs:.1f} "
        f"steps/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")

    # paths F and G: Experiment A and the stochastic-volatility regime
    # switch; path H: the steady-state filter and smoother at T = 1M
    for name, run in (("F", lambda: slice_path("F", dev, card, add)),
                      ("G", lambda: slice_path("G", dev, card, add)),
                      ("H", lambda: path_h(dev, card, add)),
                      ("I-K and the steppers",
                       lambda: fitting_paths(dev, card, add)),
                      ("L", lambda: legacy_path(dev, card, add)),
                      ("M", lambda: path_m(dev, card, add, refs))):
        t0 = time.perf_counter()
        run()
        log(f"path {name} took {time.perf_counter() - t0:.1f} s")
    log(f"launches over the main paths: {total}")
    return total


def path_n(dev, card: str, add) -> None:
    """Phase 5's path N: config 5's three filters at dx = 2,048, dy =
    1,024, T = PN_T (REPS calls each after a warm-up), and the parallel
    smoother at dx = 1,024, T = PN_S_T (one call after a warm-up: ~7 s a
    call), each with every counter reset and its exact launches."""
    import torch

    from bayesianfiltering_tpu_torch.ops import associative as tas
    from bayesianfiltering_tpu_torch.utils import metrics

    params, states, em = config5_data(PN_T, torch.float32, dev, PN_DX, PN_DY)
    for _, run, _ in config5_runs(PN_DX, PN_DY):  # warm-up
        run(params, em[:2])
    torch.cuda.synchronize()
    for label, run, per_step in config5_runs(PN_DX, PN_DY):
        post, secs = repeated(
            f"path N {label} lorenz96", lambda: run(params, em),
            {name: n * PN_T for name, n in per_step.items()}, add)
        check_gaussian_posterior(label, post, (PN_T, PN_DX))
        med = statistics.median(secs)
        log(f"path N {label} lorenz96 dx={PN_DX} dy={PN_DY} B=1 T={PN_T} "
            f"float32: {spread(secs)}, {PN_T / med:.1f} steps/s at the "
            f"median, rmse "
            f"{float(metrics.rmse(post.filtered_means, states)):.4f} "
            f"({card})")
    params, ys = path_c_problem(PN_S_T, torch.float32, dev, PN_SDX, PN_SDY)
    tas.parallel_kalman_smoother(params, ys[:2], solver="woodbury",
                                 chunk=KF_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    post, secs = repeated(
        "path N parallel kalman smoother woodbury",
        lambda: tas.parallel_kalman_smoother(params, ys, solver="woodbury",
                                             chunk=KF_CHUNK),
        path_n_smoother_expect(PN_S_T), add, reps=1)
    for name in ("filtered_means", "smoothed_means", "smoothed_covariances"):
        x = getattr(post, name)
        if x.shape[0] != PN_S_T or not torch.isfinite(x).all():
            raise RuntimeError(f"path N smoother: {name} not finite or "
                               "misshapen")
    med = statistics.median(secs)
    log(f"path N parallel kalman smoother woodbury dx={PN_SDX} dy={PN_SDY} "
        f"T={PN_S_T} chunk={KF_CHUNK} float32: {spread(secs)}, "
        f"{PN_S_T / med:.2f} steps/s at the median, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")


def path_e_problem(T, dev):
    """Path E: ``zoo.scalar_growth()`` (float32) and N(0, 1) emissions of
    shape (T, 1), made on the device."""
    import torch

    from bayesianfiltering_tpu_torch.models import zoo

    params = zoo.scalar_growth(device=dev)[1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    return params, torch.randn(T, 1, generator=gen, device=dev)


def path_e_run(params, ys):
    from bayesianfiltering_tpu_torch import inference as inf

    return inf.parallel_iterated_extended_smoother(
        params, ys, num_iter=PE_ITER, chunk=KF_CHUNK)


def path_e(dev, T, add):
    """Path E at T steps after a warm-up: the rollout alone timed at
    ``PE_ROLLOUT_T`` steps, then one call with exact launches (the
    rollout nominal, then PE_ITER + 1 chunked passes of K10, K11 and K12
    at dx = 1). Returns (posterior, seconds)."""
    import torch

    from bayesianfiltering_tpu_torch.ops import parallel_iterated as pi

    params, ys = path_e_problem(T, dev)
    path_e_run(params, ys[:4096])
    zeros = ys.new_zeros(PE_ROLLOUT_T, 1)
    _, secs = timed(lambda: pi._rollout(params, PE_ROLLOUT_T, zeros))
    log(f"path E rollout alone T={PE_ROLLOUT_T} float32: {secs:.4f} s, "
        f"{1e6 * secs / PE_ROLLOUT_T:.2f} us a step (at this rate 1M steps "
        f"would take {secs * KF_T / PE_ROLLOUT_T:.1f} s)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ((post, aux), secs), counts = run_path(
        "path E ieks scalar growth",
        lambda: timed(lambda: path_e_run(params, ys)),
        scan_expect(T, KF_CHUNK, PE_ITER + 1), others_zero=True)
    add(counts)
    norms = aux.step_norms
    for name in ("filtered_means", "smoothed_means", "smoothed_covariances"):
        x = getattr(post, name)
        if x.shape[0] != T or not torch.isfinite(x).all():
            raise RuntimeError(f"path E: {name} not finite or misshapen")
    if norms.shape != (PE_ITER,) or not torch.isfinite(norms).all():
        raise RuntimeError(f"path E: step norms {norms}")
    log(f"path E step norms {[round(float(n), 4) for n in norms]}")
    return post, secs


# ---------------------------------------------------------------------------
# Paths F, G and H: Experiment A, the stochastic-volatility regime switch
# and the steady-state smoother
# ---------------------------------------------------------------------------

def expa_problem(T, seed, dtype, dev):
    """Path F's model, ``zoo.sine_quadratic()`` (Experiment A: f = sin(10x)
    + q, g = x·x + r, zero inputs), and one sequence sampled from
    ``seed``."""
    import torch

    from bayesianfiltering_tpu_torch.models import zoo

    model, params, bpf = zoo.sine_quadratic(dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 100 + seed)
    states, emissions = model.sample(params, T, generator=gen)
    return params, bpf, None, states, emissions


def msv_problem(T, seed, dtype, dev):
    """Path G's model, ``zoo.stochastic_volatility()`` (dx = 3), its regime
    input 0 before T/2 and 1 after, and one sequence sampled from
    ``seed``."""
    import torch

    from bayesianfiltering_tpu_torch.models import zoo

    model, params, bpf = zoo.stochastic_volatility(dtype=dtype, device=dev)
    inputs = torch.cat([torch.zeros(T // 2, device=dev),
                        torch.ones(T - T // 2, device=dev)])
    gen = torch.Generator(device=dev).manual_seed(SEED + 200 + seed)
    states, emissions = model.sample(params, T, inputs=inputs, generator=gen)
    return params, bpf, inputs, states, emissions


def slice_filters(path: str, T: int):
    """A path's filters as in its source: (label, call on (params, BPF
    params, inputs, emissions, generator) returning (the point estimate
    (T, dx), the posterior) or the BPF's summary, exact launches, and the
    BPF's particle count (None for the mixtures; the BPF's K5 launches are
    its resampling steps)."""
    from bayesianfiltering_tpu_torch import inference as inf

    up = ukf_params()
    bank = {"bft_bank_update": T, "bft_bank_predict_cov": T}
    ut = {"bft_ut_sigma_aug": 2 * T, "bft_ut_update": T, "bft_ut_predict": T}

    def point(post):
        """The weighted mean (T, dx) of a mixture posterior (the AGSFs
        return it with their aux)."""
        if not isinstance(post, inf.PosteriorGaussianSumFiltered):
            post = post[0]
        return (post.weights[..., None] * post.means).sum(0), post

    if path == "F":
        a0, a1 = EXPA_OPT_ARGS
        runs = [
            ("gsf M=5", lambda p, b, u, e, g: point(inf.gaussian_sum_filter(
                p, e, 5, 1, u, g)), bank, None),
            ("ugsf M=3", lambda p, b, u, e, g: point(
                inf.unscented_gaussian_sum_filter(p, up, e, 3, 1, u, g)), ut,
             None),
        ]
        for autocov in ("prop", "trace", "sdp"):
            runs.append((f"agsf [3,2,2] {autocov}",
                         lambda p, b, u, e, g, a=autocov: point(
                             inf.augmented_gaussian_sum_filter(
                                 p, e, [3, 2, 2], g, 1, (a0, a1), u,
                                 autocov=a)), bank, None))
        runs.append(("uagsf [3,2,2] trace", lambda p, b, u, e, g: point(
            inf.unscented_agsf(p, up, e, [3, 2, 2], g, 1, (a0, a1), u,
                               autocov="trace")), ut, None))
        particles = EXPA_PARTICLES
    else:
        M = MSV_M
        runs = [
            (f"gsf M={M}", lambda p, b, u, e, g: point(
                inf.gaussian_sum_filter(p, e, M, 1, u, g)), bank, None),
            (f"agsf [{M},2,2]", lambda p, b, u, e, g: point(
                inf.augmented_gaussian_sum_filter(
                    p, e, [M, 2, 2], g, 1, (0.1, 0.1), u)), bank, None),
            (f"agsf-optimal [{M},2,2]", lambda p, b, u, e, g: point(
                inf.augmented_gaussian_sum_filter_optimal(
                    p, e, [M, 2, 2], g, 1, (0.1, 0.1), u)), bank, None),
        ]
        particles = MSV_PARTICLES
    runs.append((f"bpf P={particles}", lambda p, b, u, e, g: (
        inf.bootstrap_particle_filter(b, e, particles, g, u,
                                      store="summary")), {}, particles))
    return runs


def run_slice_filter(label, run, expect, particles, problem, gen):
    """One filter of a path with exact launches, every other kernel 0 (the
    BPF: K5 once per resampling step). Returns (estimate, seconds,
    counts)."""
    import torch

    params, bpf, inputs, states, em = problem
    (out, secs), counts = run_path(
        label, lambda: timed(lambda: run(params, bpf, inputs, em, gen)),
        expect, others_zero=particles is None)
    if particles is not None:
        resampled = int((out["ess"] < 0.5 * particles).sum())
        if counts["bft_resample_parents"] != resampled or any(
                n for name, n in counts.items()
                if name != "bft_resample_parents"):
            raise RuntimeError(f"{label}: launches {counts} for {resampled} "
                               "resampling steps")
        est = out["means"]
    else:
        est, post = out
        if not (torch.isfinite(post.means).all()
                and torch.isfinite(post.weights).all()):
            raise RuntimeError(f"{label}: outputs are not finite")
    if tuple(est.shape) != tuple(states.shape) or not torch.isfinite(
            est).all():
        raise RuntimeError(f"{label}: estimate not finite or misshapen")
    return est, secs, counts


def slice_path(path: str, dev, card: str, add) -> None:
    """Path F (Experiment A, experiments/expa_experiment.py:51-79) or G
    (the stochastic-volatility regime switch,
    experiments/adaptive_experiment.py:26-70): every filter of the source
    on SLICE_SEEDS sequences, each call with exact launches; logs each
    filter's wall (median and range over the seeds) and its RMSE against
    the sampled states, averaged over the seeds."""
    import torch

    from bayesianfiltering_tpu_torch.utils import metrics

    make = expa_problem if path == "F" else msv_problem
    T = SLICE_T
    runs = slice_filters(path, T)
    warm = make(5, 0, torch.float32, dev)
    for _, run, _, _ in slice_filters(path, 5):
        run(*warm[:3], warm[4], torch.Generator(device=dev))
    torch.cuda.synchronize()
    problems = [make(T, s, torch.float32, dev) for s in range(SLICE_SEEDS)]
    for label, run, expect, particles in runs:
        secs, rmses = [], []
        for s, problem in enumerate(problems):
            gen = torch.Generator(device=dev).manual_seed(SEED + 300 + s)
            est, sec, counts = run_slice_filter(
                f"path {path} {label} (seed {s})", run, expect, particles,
                problem, gen)
            if s == 0:
                add(counts)
            secs.append(sec)
            rmses.append(float(metrics.rmse(est, problem[3])))
        log(f"path {path} {label} T={T} float32: wall {spread(secs)}, rmse "
            f"mean {statistics.mean(rmses):.4f} over {len(rmses)} seeds "
            f"({', '.join(f'{r:.4f}' for r in rmses)}; utils.metrics.rmse) "
            f"({card})")


def path_h(dev, card: str, add) -> None:
    """Path H: the steady-state filter and smoother
    (experiments/profile_chunked.py:13-20,49-56) on path B's model and
    data at T = 1M, head 64, 128 Riccati iterations; no kernel launches.
    Logs each one's wall (median and range of 3), steps/s, peak memory and
    the gains' ``rel_delta``, then the largest gap to path B's parallel
    smoother on the same emissions (information, not a gate)."""
    import torch

    from bayesianfiltering_tpu_torch.ops import associative as tas
    from bayesianfiltering_tpu_torch.ops import steady_state as ss

    params, ys = kf_problem(KF_T, torch.float32, dev)
    rel = float(ss.steady_state_gains(params, SS_ITERS).rel_delta)
    runs = (("filter", ss.steady_state_kalman_filter,
             ("filtered_means", "filtered_covariances")),
            ("smoother", ss.steady_state_kalman_smoother,
             ("filtered_means", "smoothed_means", "smoothed_covariances")))
    out = {}
    for kind, fn, names in runs:
        fn(params, ys[:KF_CMP_T], head=SS_HEAD, num_iters=SS_ITERS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        post, secs = repeated(
            f"path H steady-state {kind}",
            lambda: fn(params, ys, head=SS_HEAD, num_iters=SS_ITERS), {}, add)
        for name in names:
            x = getattr(post, name)
            if x.shape[0] != KF_T or not torch.isfinite(x).all():
                raise RuntimeError(f"path H ({kind}): {name} not finite or "
                                   "misshapen")
        out[kind] = post
        log(f"path H steady-state {kind} dx={KF_DX} dy={KF_DY} T={KF_T} "
            f"head={SS_HEAD} num_iters={SS_ITERS} float32: {spread(secs)}, "
            f"{KF_T / statistics.median(secs):.1f} steps/s at the median, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            f", rel_delta {rel:.3e} ({card})")
    exact = tas.parallel_kalman_smoother(params, ys, chunk=KF_CHUNK)
    gaps = {n: float((getattr(out["smoother"], n)
                      - getattr(exact, n)).abs().max())
            for n in ("filtered_means", "smoothed_means",
                      "smoothed_covariances")}
    log("path H largest gap to path B's parallel smoother (information): "
        + ", ".join(f"{n} {g:.3e}" for n, g in gaps.items()))


def compare_slice(dev) -> None:
    """Phase 4 for paths F–H: card against CPU in float64 with the same
    draws and exact launches — the AGSF [3,2,2] on Experiment A's model
    with autocov "sdp" and "trace", the AGSF and the UAGSF with the
    optimal reduction and the AGSF with the reference's fixed keys on the
    stochastic-volatility model (regime switch at T/2), the reference-
    exact EKF on the quadratic-measurement model, ``ekf_step``, and the
    steady-state filter and smoother on path B's model at T = 4,096 (no
    launches)."""
    import torch

    from bayesianfiltering_tpu_torch import inference as inf
    from bayesianfiltering_tpu_torch.models import zoo
    from bayesianfiltering_tpu_torch.ops import ekf as tekf
    from bayesianfiltering_tpu_torch.ops import steady_state as ss

    f64 = torch.float64
    T = SLICE_CMP_T
    bank = {"bft_bank_update": T, "bft_bank_predict_cov": T}
    ut = {"bft_ut_sigma_aug": 2 * T, "bft_ut_update": T, "bft_ut_predict": T}

    def field(x, name):
        return x[name] if isinstance(x, dict) else getattr(x, name)

    def compare(label, run, expect, names, tol=MIXTURE_TOL):
        got, _ = run_path(label, lambda: run(dev), expect, others_zero=True)
        want = run("cpu")
        errs = {n: rel_err(field(got, n), field(want, n)) for n in names}
        ok = max(errs.values()) <= tol and all(
            torch.isfinite(field(got, n)).all() for n in names)
        log(f"{label} float64 card vs cpu: " + ", ".join(
            f"{n} {e:.3e}" for n, e in errs.items())
            + f" (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label}: the kernel path disagrees with the "
                               "plain path")

    mixture = ("means", "covariances", "weights", "marginal_loglik")
    expa = expa_problem(T, 0, f64, dev)
    msv = msv_problem(T, 0, f64, dev)
    cpu = {"sine_quadratic": zoo.sine_quadratic(dtype=f64, device="cpu")[1],
           "stochastic_volatility": zoo.stochastic_volatility(
               dtype=f64, device="cpu")[1]}

    def on(device, problem, model):
        params, _, inputs, _, em = problem
        if device == "cpu":
            params = cpu[model]
            inputs = None if inputs is None else inputs.cpu()
            em = em.cpu()
        return params, inputs, em

    def moved(draws, device):
        return type(draws)(*(None if x is None else x.to(device)
                             for x in draws))

    # Experiment A's AGSF is chaotic (sin(10x) stretches a difference up to
    # tenfold a step; on the CPU a 1e-13 nudge of the emissions moves the
    # "sdp" run's means by ~4e-2): it is held here with the adaptive rules
    # only, the fixed keys on the stochastic-volatility model
    gen = torch.Generator(device=dev).manual_seed(SEED + 400)
    for autocov in ("sdp", "trace"):
        draws = inf.agsf_draws(gen, T, [3, 2, 2], 1, "multinomial", expa[4])

        def run(device, autocov=autocov, draws=draws):
            p, u, e = on(device, expa, "sine_quadratic")
            return inf.augmented_gaussian_sum_filter(
                p, e, [3, 2, 2], opt_args=EXPA_OPT_ARGS, inputs=u,
                autocov=autocov, draws=moved(draws, device))[0]
        compare(f"agsf [3,2,2] {autocov} sine_quadratic T={T}", run, bank,
                mixture)

    M = 4
    optimal = inf.agsf_draws(gen, T, [M, 2, 2], 3, "optimal", msv[4])
    fixed = inf._fixed_key_draws(gen, [M, 2, 2], 3, "multinomial", msv[4])
    for label, kind, draws in (("agsf-optimal", "optimal", optimal),
                               ("uagsf optimal", "ukf", optimal),
                               ("agsf compat_fixed_keys", "fixed", fixed)):
        def run(device, kind=kind, draws=draws):
            p, u, e = on(device, msv, "stochastic_volatility")
            d = moved(draws, device)
            if kind == "ukf":
                return inf.unscented_agsf(p, ukf_params(), e, [M, 2, 2],
                                          opt_args=(0.1, 0.1), inputs=u,
                                          reduction="optimal", draws=d)[0]
            if kind == "fixed":
                return inf.augmented_gaussian_sum_filter(
                    p, e, [M, 2, 2], opt_args=(0.1, 0.1), inputs=u,
                    compat_fixed_keys=True, draws=d)[0]
            return inf.augmented_gaussian_sum_filter_optimal(
                p, e, [M, 2, 2], opt_args=(0.1, 0.1), inputs=u, draws=d)[0]
        compare(f"{label} [{M},2,2] stochastic volatility T={T}", run,
                ut if kind == "ukf" else bank, mixture)

    qm = zoo.quadratic_measurement(dtype=f64, device=dev)
    qm_ys = qm[0].sample(qm[1], T, generator=torch.Generator(
        device=dev).manual_seed(SEED + 401))[1]
    qm_cpu = zoo.quadratic_measurement(dtype=f64, device="cpu")[1]
    compare(f"ekf compat_scalar quadratic_measurement T={T}",
            lambda device: inf.extended_kalman_filter(
                qm[1] if device != "cpu" else qm_cpu, qm_ys.to(device),
                compat_scalar=True),
            {"bft_ekf_predict_cov": T}, ("filtered_means",
                                         "filtered_covariances",
                                         "marginal_loglik"))

    # ekf_step over a batch of 16 Lorenz-63 states: one K2 and one K1
    l63 = {d: zoo.lorenz63(dtype=f64, device=d)[1] for d in (dev, "cpu")}
    rng = torch.Generator(device="cpu").manual_seed(SEED + 402)
    m0 = torch.randn(16, 3, generator=rng, dtype=f64)
    A = torch.randn(16, 3, 3, generator=rng, dtype=f64)
    P0 = A @ A.mT + torch.eye(3, dtype=f64)
    y0 = torch.randn(1, generator=rng, dtype=f64)

    def step(device):
        p = l63[dev if device != "cpu" else "cpu"]
        f, h = p.dynamics_function, p.emission_function
        jac = torch.func.jacfwd
        return dict(zip(("log_likelihood", "mean", "cov"), tekf.ekf_step(
            m0.to(device), P0.to(device), f, jac(f, 0), jac(f, 1),
            p.dynamics_noise_covariance, p.dynamics_noise_bias,
            torch.zeros((), device=device), h, jac(h, 0), jac(h, 1),
            p.emission_noise_covariance, p.emission_noise_bias,
            y0.to(device))))
    compare("ekf_step lorenz63 B=16", step,
            {"bft_ekf_update": 1, "bft_ekf_predict_cov": 1},
            ("log_likelihood", "mean", "cov"))

    params, ys = kf_problem(KF_CMP_T, f64, dev)
    cpu_params = type(params)(*(x.cpu() for x in params[:6]))
    for kind in ("filter", "smoother"):
        fn = getattr(ss, f"steady_state_kalman_{kind}")
        names = ("filtered_means", "filtered_covariances", "marginal_loglik")
        if kind == "smoother":
            names += ("smoothed_means", "smoothed_covariances")
        compare(f"steady-state {kind} dx={KF_DX} dy={KF_DY} T={KF_CMP_T}",
                lambda device, fn=fn: fn(
                    params if device != "cpu" else cpu_params,
                    ys.to(device), head=SS_HEAD, num_iters=SS_ITERS),
                {}, names)


# ---------------------------------------------------------------------------
# Paths I, J and K and the streaming steppers: fitting and streaming
# ---------------------------------------------------------------------------

# path I: LinearGaussianSSM.fit_em on path B's model and emissions (T = 1M,
# one sequence, every field trained, from F = 0.5·I, Q = R = I as
# tests/test_models.py:197-201); card vs CPU at T = 8,192 (above the
# 4,096-step dispatch to the parallel smoother), float64
PI_ITERS, PI_CMP_T, PI_CMP_ITERS = 3, 8192, 2
# path J: extended EM on the Lorenz-96 EKF batch's model and data (dx = 64,
# dy = 32, T = 1,000), B cut from 512 to 16 sequences (each (B, T, 64, 64)
# float32 stack is 1.05 GB at B = 64, and the E-step holds about ten; 64
# ran ~40 s of the run's time limit, cut to 32 beside path L and to 16
# beside path N), Q and R trained, one iteration on the main path (phase
# 4's check runs two); path K: fit_sgd on the same model at B = 32 (64
# until path N joined the run), T = 200, Q and R under RealToPSD, the
# default Adam, one minibatch of B a step; card vs CPU at B = 2, T = 20,
# float64
PJ_B, PJ_T, PJ_ITERS, PJ_CMP_ITERS = 16, 1000, 1, 2
PK_B, PK_T, PK_EPOCHS = 32, 200, 2
FIT_CMP_B, FIT_CMP_T = 2, 20
# the unscented E-step's check: the UNGM (path E's model), inputs arange(T)
# (tests/test_models.py:338-345)
UNGM_EM_T = 100
# the steppers: the EKF on the Lorenz-96 batch (B = 512, T = 200, chunks of
# 50, a checkpoint round trip after the second), the GSF on bearings-only
# tracking (M = 50, T = 100) and the BPF at path A's size (1M particles,
# T = 100), each in chunks of 50 against the whole-sequence filter
STREAM_EKF_T, STREAM_CHUNK = 200, 50
STREAM_GSF_M, STREAM_GSF_T = 50, 100
STREAM_CMP_T, STREAM_CMP_B, STREAM_CMP_M = 20, 4, 5
FIT_TOL = 1e-8


def lgssm_em_start(params):
    """Path I's starting point: path B's model with F = 0.5·I, Q = R = I."""
    import torch

    eye = lambda n: torch.eye(n, dtype=params.dynamics_matrix.dtype,
                              device=params.dynamics_matrix.device)
    return params._replace(dynamics_matrix=0.5 * eye(KF_DX),
                           dynamics_covariance=eye(KF_DX),
                           emission_covariance=eye(KF_DY))


def noise_props(params, constrainer=None):
    """Q and R trained (under ``constrainer(n)`` if given), every other
    field of ``params`` frozen (tests/test_models.py:260-271)."""
    from bayesianfiltering_tpu_torch.models import ParameterProperties as PP

    frozen = PP(trainable=False)
    make = ((lambda n: PP()) if constrainer is None
            else (lambda n: PP(constrainer=constrainer(n))))
    return params._replace(**{k: frozen for k in params._fields})._replace(
        dynamics_noise_covariance=make(
            params.dynamics_noise_covariance.shape[-1]),
        emission_noise_covariance=make(
            params.emission_noise_covariance.shape[-1]))


def lgssm_fit(params, ys, iters):
    from bayesianfiltering_tpu_torch.models import (
        LinearGaussianSSM,
        PropsLGSSM,
    )

    return LinearGaussianSSM(KF_DX, KF_DY).fit_em(
        lgssm_em_start(params), PropsLGSSM(), ys, num_iters=iters,
        verbose=False)


def l96_model(dtype, dev):
    from bayesianfiltering_tpu_torch.models import zoo

    model, params, _ = zoo.lorenz96(EKF_DX, EKF_DY, dtype=dtype, device=dev)
    return model, params


def extended_em(model, params, em, iters):
    return model.fit_em(params, noise_props(params), em, num_iters=iters,
                        verbose=False)


def sgd_fit(model, params, em, epochs):
    from bayesianfiltering_tpu_torch.models.bijectors import RealToPSD

    return model.fit_sgd(params, noise_props(params, RealToPSD), em,
                         batch_size=em.shape[0], num_epochs=epochs)


def ungm_problem(T, dtype, dev):
    """The UNGM with em_moments="ukf" and one sequence sampled on the CPU
    from the seed, inputs arange(T): (model, params, inputs, emissions)."""
    import torch

    from bayesianfiltering_tpu_torch.models import zoo

    model, params, _ = zoo.scalar_growth(dtype=dtype, device=dev)
    cpu = zoo.scalar_growth(dtype=dtype, device="cpu")[1]
    model.em_moments = "ukf"
    inputs = torch.arange(float(T), dtype=dtype)[:, None]
    _, em = model.sample(cpu, T, inputs=inputs,
                         generator=torch.Generator().manual_seed(SEED + 10))
    return model, params, inputs.to(dev), em.to(dev)


def ekf_kernels(dx, dy, dtype, dev) -> tuple:
    """The names of the EKF update and predict kernels the rules pick at
    (dx, dy) and dq = dx in ``dtype`` on ``dev``."""
    import torch

    from bayesianfiltering_tpu_torch import _build
    from bayesianfiltering_tpu_torch.ops import fused_ekf as fe

    size, optin = torch.empty((), dtype=dtype).element_size(), \
        _build.smem_optin(dev)
    return (fe.update_kernel(dx, dy, size, optin).name,
            fe.predict_kernel(dx, dx, size, optin).name)


def stepper_runs(stepper, state, em, inputs, chunk, ckpt, axis=0, **kw):
    """``stepper`` over ``em`` in chunks of ``chunk`` steps, the carry
    saved to ``ckpt`` and restored after the second chunk; the outputs
    concatenated along the time axis."""
    import torch

    from bayesianfiltering_tpu_torch import streaming

    T = em.shape[axis]
    outs = []
    for i, lo in enumerate(range(0, T, chunk)):
        hi = min(lo + chunk, T)
        state, out = stepper.run_chunk(
            state, em.narrow(axis, lo, hi - lo),
            None if inputs is None else inputs[lo:hi], t0=lo,
            **{k: v[lo:hi] for k, v in kw.items()})
        outs.append(out)
        if i == 1:
            streaming.save_state(ckpt, state)
            state = streaming.restore_state(ckpt, state)
    return state, {k: torch.cat([o[k] for o in outs], dim=axis)
                   for k in outs[0]}


def stream_ekf(params, em, chunk, ckpt):
    from bayesianfiltering_tpu_torch import streaming

    stepper = streaming.make_ekf_stepper(params)
    return stepper_runs(stepper, stepper.init(), em, None, chunk, ckpt, 1)


def stream_gsf(params, inputs, em, M, eps, chunk, ckpt):
    from bayesianfiltering_tpu_torch import streaming

    stepper = streaming.make_gsf_stepper(params, M)
    return stepper_runs(stepper, stepper.init(eps=eps), em, inputs, chunk,
                        ckpt)


def stream_bpf(bpf, em, P, chunk, ckpt, generator=None, init=None,
               draws=None):
    from bayesianfiltering_tpu_torch import streaming

    stepper = streaming.make_bpf_stepper(bpf, P)
    kw = {} if draws is None else {"draws": draws}
    return stepper_runs(stepper, stepper.init(generator, init), em, None,
                        chunk, ckpt, **kw)


def checkpoint(name: str) -> str:
    path = ROOT / "build" / "streaming"
    path.mkdir(parents=True, exist_ok=True)
    return str(path / f"{name}.pt")


def compare_fitting(dev) -> None:
    """Phase 4 for paths I–K and the steppers: card against CPU in
    float64 at FIT_TOL with exact launches — LinearGaussianSSM.fit_em at
    T = 8,192 (K10–K12), extended EM and fit_sgd on the Lorenz-96 model at
    B = 2, T = 20 (K1, K2), the unscented E-step on the UNGM at T = 100
    (K7–K9), and the EKF, GSF and BPF steppers with a checkpoint round
    trip (K1/K2, K3/K4, K5)."""
    import torch

    from bayesianfiltering_tpu_torch import inference as inf
    from bayesianfiltering_tpu_torch.models import zoo
    from bayesianfiltering_tpu_torch.models.nonlinear import SuffStatsNLSSM

    f64 = torch.float64

    def compare(label, run, expect, outputs):
        """run(device) on the card under exact launches, then on the CPU;
        ``outputs(result)`` names the tensors to hold to FIT_TOL."""
        got, _ = run_path(f"{label} float64 card", lambda: run(dev), expect,
                          others_zero=True)
        want = run("cpu")
        errs = {n: rel_err(g, w) for (n, g), (_, w) in
                zip(outputs(got), outputs(want))}
        bad = [n for n, e in errs.items() if not e <= FIT_TOL
               or not torch.isfinite(dict(outputs(got))[n]).all()]
        log(f"{label} float64 card vs cpu: "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (tol {FIT_TOL:.0e}) {'FAIL' if bad else 'ok'}")
        if bad:
            raise RuntimeError(f"{label}: card disagrees with the CPU on "
                               f"{bad}")

    def fitted(names):
        def outputs(result):
            params, trace = result
            return [("trace", trace)] + [(n, getattr(params, n))
                                         for n in names]
        return outputs

    # path I: exact EM above the parallel dispatch
    params, ys = kf_problem(PI_CMP_T, f64, dev)
    cpu_params = type(params)(*(x.cpu() for x in params[:6]))
    compare(f"path I lgssm fit_em T={PI_CMP_T} {PI_CMP_ITERS} iterations",
            lambda d: lgssm_fit(params if d != "cpu" else cpu_params,
                                ys.to(d), PI_CMP_ITERS),
            scan_expect(PI_CMP_T, "auto", PI_CMP_ITERS),
            fitted(("dynamics_matrix", "dynamics_covariance",
                    "emission_matrix", "emission_covariance",
                    "initial_mean", "initial_covariance")))

    # paths J and K at B = 2, T = 20
    _, _, em = lorenz96_data(dev, f64)
    em = em[:FIT_CMP_B, :FIT_CMP_T]
    models = {d: l96_model(f64, d) for d in (dev, "cpu")}
    k1, k2 = ekf_kernels(EKF_DX, EKF_DY, f64, dev)
    pick = lambda d: models[dev if d != "cpu" else "cpu"]
    noise = ("dynamics_noise_covariance", "emission_noise_covariance")
    compare(f"path J extended em lorenz96 B={FIT_CMP_B} T={FIT_CMP_T} "
            f"{PJ_CMP_ITERS} iterations",
            lambda d: extended_em(*pick(d), em.to(d), PJ_CMP_ITERS),
            {k1: PJ_CMP_ITERS * FIT_CMP_T, k2: PJ_CMP_ITERS * FIT_CMP_T},
            fitted(noise))
    compare(f"path K fit_sgd lorenz96 B={FIT_CMP_B} T={FIT_CMP_T} "
            f"{PK_EPOCHS} epochs",
            lambda d: sgd_fit(*pick(d), em.to(d), PK_EPOCHS),
            {k1: PK_EPOCHS * FIT_CMP_T, k2: PK_EPOCHS * FIT_CMP_T},
            fitted(noise))

    # the unscented E-step: the URTS forward pass runs K7 (update and
    # predict), K8 and K9 a step
    model, params, inputs, em = ungm_problem(UNGM_EM_T, f64, dev)
    cpu_params = zoo.scalar_growth(dtype=f64, device="cpu")[1]
    compare(f"unscented e_step scalar growth T={UNGM_EM_T}",
            lambda d: model.e_step(params if d != "cpu" else cpu_params,
                                   em.to(d), inputs.to(d)),
            {"bft_ut_sigma_aug": 2 * UNGM_EM_T, "bft_ut_update": UNGM_EM_T,
             "bft_ut_predict": UNGM_EM_T},
            lambda r: [("loglik", r[1])] + [(n, getattr(r[0], n))
                                            for n in SuffStatsNLSSM._fields])

    # the steppers: chunks of 10 steps, a checkpoint round trip after the
    # second; the EKF over a batch of sequences
    _, params, _ = zoo.lorenz96(EKF_DX, EKF_DY, dtype=f64, device=dev)
    cpu_params = zoo.lorenz96(EKF_DX, EKF_DY, dtype=f64, device="cpu")[1]
    _, _, em = lorenz96_data(dev, f64)
    em = em[:STREAM_CMP_B, :STREAM_CMP_T]
    compare(f"ekf stepper lorenz96 B={STREAM_CMP_B} T={STREAM_CMP_T}",
            lambda d: stream_ekf(params if d != "cpu" else cpu_params,
                                 em.to(d), 10, checkpoint("ekf64")),
            {k1: STREAM_CMP_T, k2: STREAM_CMP_T - 1},
            lambda r: [("loglik", r[0].marginal_loglik)]
            + list(r[1].items()))
    params, inputs, _, em = bot_problem(STREAM_CMP_T, f64, dev)
    cpu_params = zoo.bearings_only_tracking(dtype=f64, device="cpu")[1]
    eps = torch.randn(STREAM_CMP_M, 4, dtype=f64,
                      generator=torch.Generator().manual_seed(SEED + 11))
    compare(f"gsf stepper bot M={STREAM_CMP_M} T={STREAM_CMP_T}",
            lambda d: stream_gsf(params if d != "cpu" else cpu_params,
                                 inputs.to(d), em.to(d), STREAM_CMP_M,
                                 eps.to(d), 10, checkpoint("gsf64")),
            {"bft_bank_update": STREAM_CMP_T,
             "bft_bank_predict_cov": STREAM_CMP_T - 1},
            lambda r: [("loglik", r[0].marginal_loglik)]
            + list(r[1].items()))
    bpf, _, em = bpf_problem(STREAM_CMP_T, f64, dev)
    cpu_bpf = zoo.lorenz96(BPF_DX, BPF_DY, dtype=f64, device="cpu")[2]
    draws = inf.bpf_draws(torch.Generator().manual_seed(SEED + 12),
                          STREAM_CMP_T, BPF_CMP_P, BPF_DX, BPF_DX,
                          "systematic", em.cpu())
    whole = inf.bootstrap_particle_filter(cpu_bpf, em.cpu(), BPF_CMP_P,
                                          store="summary", draws=draws)
    resampled = int((whole["ess"] < 0.5 * BPF_CMP_P).sum())

    def bpf_run(d):
        return stream_bpf(bpf if d != "cpu" else cpu_bpf, em.to(d),
                          BPF_CMP_P, 10, checkpoint("bpf64"),
                          init=draws.init.to(d),
                          draws=list(zip(draws.dynamics.to(d),
                                         draws.resample.to(d))))
    compare(f"bpf stepper lorenz96 dx={BPF_DX} P={BPF_CMP_P} "
            f"T={STREAM_CMP_T} ({resampled} resampling steps)", bpf_run,
            {"bft_resample_parents": resampled},
            lambda r: list(r[1].items()))


def fitting_paths(dev, card: str, add) -> None:
    """Phase 5 for paths I, J and K and the streaming steppers, each with
    exact launches and every other counter held to 0; logs each wall
    (CUDA events) with the card, and checks the outputs."""
    import torch

    from bayesianfiltering_tpu_torch import inference as inf

    def path(label, fn, expect):
        (out, secs), counts = run_path(label, lambda: timed(fn), expect,
                                       others_zero=True)
        add(counts)
        return out, secs, counts

    def finite(label, *tensors):
        if not all(torch.isfinite(x).all() for x in tensors):
            raise RuntimeError(f"{label}: outputs are not finite")

    # path I: exact EM on path B's model at T = 1M
    params, ys = kf_problem(KF_T, torch.float32, dev)
    lgssm_fit(params, ys[:PI_CMP_T], 1)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (fit, lps), secs, counts = path(
        f"path I lgssm fit_em T={KF_T}",
        lambda: lgssm_fit(params, ys, PI_ITERS),
        scan_expect(KF_T, "auto", PI_ITERS))
    finite("path I", lps, *fit[:6])
    if not bool((lps[1:] - lps[:-1] > -1e-2).all()):
        raise RuntimeError(f"path I: EM log-likelihoods fell: {lps}")
    log(f"path I lgssm fit_em dx={KF_DX} dy={KF_DY} T={KF_T} {PI_ITERS} "
        f"iterations float32: {secs:.4f} s, {secs / PI_ITERS:.4f} s an "
        f"iteration, log-likelihoods {[round(float(x), 3) for x in lps]}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({card})")

    # path J: extended EM at Lorenz-96's widths, B = 64
    model, params = l96_model(torch.float32, dev)
    _, _, em_all = lorenz96_data(dev, torch.float32)
    extended_em(model, params, em_all[:2, :10], 1)         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    em = em_all[:PJ_B, :PJ_T]
    (fit, lps), secs, counts = path(
        f"path J extended em lorenz96 B={PJ_B} T={PJ_T}",
        lambda: extended_em(model, params, em, PJ_ITERS),
        {"bft_ekf_update": PJ_ITERS * PJ_T,
         "bft_ekf_predict_cov": PJ_ITERS * PJ_T})
    finite("path J", lps, fit.dynamics_noise_covariance,
           fit.emission_noise_covariance)
    log(f"path J extended em lorenz96 dx={EKF_DX} dy={EKF_DY} B={PJ_B} "
        f"T={PJ_T} {PJ_ITERS} iterations float32: {secs:.4f} s, "
        f"{secs / PJ_ITERS:.4f} s an iteration, log-likelihoods "
        f"{[round(float(x), 2) for x in lps]}, trace(Q) "
        f"{float(fit.dynamics_noise_covariance.trace()):.4f}, trace(R) "
        f"{float(fit.emission_noise_covariance.trace()):.4f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    # the E-step's parts at this size, one call each after the path
    fp = model._filter_params(params)
    _, secs_rts = timed(lambda: inf._extended_rts(fp, em))
    Gq = torch.eye(EKF_DX, device=dev).expand(PJ_B, PJ_T - 1, EKF_DX,
                                              EKF_DX)
    _, secs_pinv = timed(lambda: torch.linalg.pinv(Gq))
    log(f"path J parts: the ERTS over the batch {secs_rts:.4f} s, pinv of "
        f"the {PJ_B * (PJ_T - 1)} noise Jacobians ({EKF_DX} x {EKF_DX}) "
        f"{secs_pinv:.4f} s ({card})")

    # path K: SGD through the EKF kernels
    em = em_all[:PK_B, :PK_T]
    sgd_fit(model, params, em_all[:2, :10], 1)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (fit, losses), secs, counts = path(
        f"path K fit_sgd lorenz96 B={PK_B} T={PK_T}",
        lambda: sgd_fit(model, params, em, PK_EPOCHS),
        {"bft_ekf_update": PK_EPOCHS * PK_T,
         "bft_ekf_predict_cov": PK_EPOCHS * PK_T})
    finite("path K", losses, fit.dynamics_noise_covariance,
           fit.emission_noise_covariance)
    peak = torch.cuda.max_memory_allocated() / 2**30
    Q = fit.dynamics_noise_covariance.clone().requires_grad_()
    loss = -model.marginal_log_prob(
        fit._replace(dynamics_noise_covariance=Q), em).sum() / em.numel()
    loss.backward()
    finite("path K gradient", Q.grad)
    log(f"path K fit_sgd lorenz96 dx={EKF_DX} dy={EKF_DY} B={PK_B} T={PK_T} "
        f"{PK_EPOCHS} epochs (Adam 1e-3, one step an epoch) float32: "
        f"{secs:.4f} s, {secs / PK_EPOCHS:.4f} s a step (forward K1/K2, "
        f"backward the plain versions), losses "
        f"{[round(float(x), 5) for x in losses]}, |grad Q| "
        f"{float(Q.grad.norm()):.4e} at the fit, peak memory {peak:.2f} GiB "
        f"({card})")

    # the steppers against the whole-sequence filters
    def against(label, pairs, tol=EKF_TOL["float32"]):
        errs = {n: rel_err(g, w) for n, (g, w) in pairs.items()}
        ok = max(errs.values()) <= tol
        log(f"{label}: chunked with a restore vs one-shot: "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label}: the chunked run disagrees")

    params = l96_model(torch.float32, dev)[1]
    em = em_all[:, :STREAM_EKF_T]
    (state, out), secs, counts = path(
        f"ekf stepper lorenz96 B={EKF_B} T={STREAM_EKF_T}",
        lambda: stream_ekf(params, em, STREAM_CHUNK, checkpoint("ekf")),
        {"bft_ekf_update": STREAM_EKF_T,
         "bft_ekf_predict_cov": STREAM_EKF_T - 1})
    whole = inf.extended_kalman_filter(params, em)
    against(f"ekf stepper lorenz96 B={EKF_B} T={STREAM_EKF_T}",
            {"means": (out["mean"], whole.filtered_means),
             "covs": (out["cov"], whole.filtered_covariances),
             "loglik": (state.marginal_loglik, whole.marginal_loglik)})
    log(f"ekf stepper lorenz96 dx={EKF_DX} dy={EKF_DY} B={EKF_B} "
        f"T={STREAM_EKF_T} chunks of {STREAM_CHUNK} float32: {secs:.4f} s "
        f"({card})")

    params, inputs, _, em = bot_problem(STREAM_GSF_T, torch.float32, dev)
    eps = torch.randn(STREAM_GSF_M, 4, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(
                          SEED + 13))
    (state, out), secs, counts = path(
        f"gsf stepper bot M={STREAM_GSF_M} T={STREAM_GSF_T}",
        lambda: stream_gsf(params, inputs, em, STREAM_GSF_M, eps,
                           STREAM_CHUNK, checkpoint("gsf")),
        {"bft_bank_update": STREAM_GSF_T,
         "bft_bank_predict_cov": STREAM_GSF_T - 1})
    whole = inf.gaussian_sum_filter(params, em, STREAM_GSF_M, inputs=inputs,
                                    init_eps=eps)
    against(f"gsf stepper bot M={STREAM_GSF_M} T={STREAM_GSF_T}",
            {"weights": (out["weights"], whole.weights.mT),
             "means": (out["means"], whole.means.transpose(0, 1)),
             "loglik": (state.marginal_loglik, whole.marginal_loglik)})
    log(f"gsf stepper bot M={STREAM_GSF_M} T={STREAM_GSF_T} chunks of "
        f"{STREAM_CHUNK} float32: {secs:.4f} s ({card})")

    # the BPF at 1M particles: float32 sums over the bank (the systematic
    # counts' torch.cumsum on the card) are not the same from run to run,
    # so two runs from one seed part after their first resampling step
    # (the whole-sequence filter against itself as well): the stepper
    # equals the whole filter exactly up to that step, and tracks the
    # states as closely after it; float64 with the same draws is exact
    # (phase 4)
    bpf, states, em = bpf_problem(BPF_T, torch.float32, dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED + 14)
    torch.cuda.reset_peak_memory_stats()
    (state, out), secs, counts = path(
        f"bpf stepper lorenz96 P={BPF_P} T={BPF_T}",
        lambda: stream_bpf(bpf, em, BPF_P, STREAM_CHUNK, checkpoint("bpf"),
                           generator=gen()),
        {"bft_resample_parents": None})
    peak = torch.cuda.max_memory_allocated() / 2**30
    resampled = out["ess"] < 0.5 * BPF_P
    if counts["bft_resample_parents"] != int(resampled.sum()):
        raise RuntimeError(f"bpf stepper: K5 launched "
                           f"{counts['bft_resample_parents']} times for "
                           f"{int(resampled.sum())} resampling steps")
    wholes = [inf.bootstrap_particle_filter(bpf, em, BPF_P, gen(),
                                            store="summary")
              for _ in range(2)]
    first = int(resampled.nonzero()[0, 0]) if resampled.any() else BPF_T
    rmse = lambda means: float(((means - states) ** 2).mean().sqrt())
    self_gap = rel_err(wholes[0]["means"], wholes[1]["means"])
    exact = (torch.equal(out["mean"][:first], wholes[0]["means"][:first])
             and torch.equal(out["ess"][:first + 1],
                             wholes[0]["ess"][:first + 1]))
    gap = abs(rmse(out["mean"]) - rmse(wholes[0]["means"]))
    ok = exact and gap <= 0.1 * rmse(wholes[0]["means"])
    log(f"bpf stepper lorenz96 P={BPF_P} T={BPF_T}: chunked with a restore "
        f"vs one-shot: equal through the first resampling step ({first}): "
        f"{exact}; rmse {rmse(out['mean']):.4f} vs {rmse(wholes[0]['means']):.4f}"
        f" (within 10%); afterwards means {rel_err(out['mean'], wholes[0]['means']):.3e}"
        f", the one-shot against itself {self_gap:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("bpf stepper: the chunked run disagrees")
    log(f"bpf stepper lorenz96 dx={BPF_DX} dy={BPF_DY} P={BPF_P} T={BPF_T} "
        f"chunks of {STREAM_CHUNK} float32: {secs:.4f} s, "
        f"{int(resampled.sum())} resampling steps, peak memory {peak:.2f} "
        f"GiB ({card})")


# K9t's first launch, the pass that forms μ and the centred points
K9T_FIRST = "ut_tiled_mean_centre_kernel"


# ---------------------------------------------------------------------------
# The legacy (v0) API: phase 4's card-vs-CPU checks and path L
# ---------------------------------------------------------------------------

# path L: experiments/legacy_experiment.py's two tables at their sizes
# (particlefilt_table :65-82: the scalar sin/x² model, Q = 4, R = 1, P0 = 10,
# m0 = 0.1, T = 100, N = 10 and 1,000; gaussfilt_table :85-114: the dx = 2
# sinusoid f = [x0 + sin(x1), 0.9 x0], g = Hx/ΣH, Q = I, R = 0.1, T = 100,
# MCF / EKF 1 and 2 / UKF(1, 2, 0) / MCLAF with 10 particles and
# GaussSumFilt(EKF, 10)); the AGSF [3, 2, 2] on tests/test_legacy.py's
# scalar model (:34-40) in three selection modes; and the legacy BPF at path
# A's model and size (Lorenz-96 dx = 8, dy = 4, Q = 0.1 I, R = I, 1M
# particles, T = 100), built from legacy.nonlinearities.make_lorenz96 with a
# zero noise argument
LEG_T, LEG_CMP_T, LEG_CMP_P = 100, 20, 4096
LEG_PF_N, LEG_PARTICLES, LEG_BANK = (10, 1000), 10, 10
LEG_AGSF = (3, 2, 2)
LEG_AGSF_MODES = (("prop", (0.2, 0.2)), ("opt_lip", (1.0, 0.2)),
                  ("test", (0.1, 0.2)))
# path L's slowest host-bound calls run once, not REPS times (MCLAF ~12 s
# a call on the H100, the AGSF's "opt_lip" ~7.6 s, its "test" ~2.6 s
# since path N joined the run), to keep the run within its time limit
LEG_ONE_CALL = ("MCLAF", "opt_lip", "test")


def legacy_models(dtype, dev, H):
    """The legacy SSMs of path L on ``dev``: "pf" (sin/x²), "sinusoid"
    (dx = 2, ``H`` (1, 2) the emission row) and "scalar"."""
    import torch

    from bayesianfiltering_tpu_torch import legacy

    kw = dict(dtype=dtype, device=dev)
    eye = lambda n: torch.eye(n, **kw)
    zeros = lambda n: torch.zeros(n, **kw)
    Hm = H.to(**kw)
    return {
        "pf": legacy.SSM(1, 1, zeros(1), 4.0 * eye(1), zeros(1), eye(1),
                         f=torch.sin, g=lambda x: x ** 2),
        # width-1 slices: jacfwd keeps float32 (ROADMAP.md queue 3)
        "sinusoid": legacy.SSM(
            2, 1, zeros(2), eye(2), zeros(1), 0.1 * eye(1),
            f=lambda x: torch.cat([x[..., 0:1] + torch.sin(x[..., 1:2]),
                                   0.9 * x[..., 0:1]], -1),
            g=lambda x: (x @ Hm.T) / Hm.sum()),
        "scalar": legacy.SSM(1, 1, zeros(1), 0.5 * eye(1), zeros(1),
                             0.5 * eye(1),
                             f=lambda x: 0.8 * x + 0.1 * torch.sin(x),
                             g=lambda x: 0.5 * x + 0.05 * x ** 2),
    }


def legacy_filters(ssm, gen=None):
    """gaussfilt_table's roster on ``ssm`` (the bank last)."""
    from bayesianfiltering_tpu_torch import legacy

    return {
        "MCF": legacy.MCF(ssm, LEG_PARTICLES, generator=gen),
        "EKF (order=1)": legacy.EKF(ssm, order=1),
        "EKF (order=2)": legacy.EKF(ssm, order=2),
        "UKF": legacy.UKF(ssm, alpha=1.0, beta=2.0, kappa=0.0),
        "MCLAF": legacy.MCLAF(ssm, LEG_PARTICLES, generator=gen),
        "GaussSumFilt(EKF,10)": legacy.CompositeGaussSumFilt(
            legacy.EKF(ssm, order=1), LEG_BANK),
    }


def leaves(x):
    """The tensors of a nested result (tuples, lists, dicts)."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    return []


def moved(x, dev):
    """Draws (a tensor or a NamedTuple of tensors and None) on ``dev``."""
    import torch

    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return type(x)(*(moved(v, dev) for v in x))


def compare_legacy(dev) -> None:
    """Phase 4, the legacy API: every class and estimator on the card
    against the CPU in float64 with the same draws, T = LEG_CMP_T, held to
    MIXTURE_TOL; the Gaussian filters and estimators launch no kernel (as
    the JAX package's are plain XLA), the BPF at LEG_CMP_P particles
    exactly one K5 a step."""
    import torch

    from bayesianfiltering_tpu_torch import legacy
    from bayesianfiltering_tpu_torch.inference import BPFDraws
    from bayesianfiltering_tpu_torch.legacy import ala, mean_estimators as me
    from bayesianfiltering_tpu_torch.legacy.gaussfilt import (
        BankDraws,
        SimulateDraws,
    )
    from bayesianfiltering_tpu_torch.legacy.gausssumfilt import AugDraws

    f64, T = torch.float64, LEG_CMP_T
    gen = torch.Generator().manual_seed(SEED + 23)
    normal = lambda *shape: torch.randn(shape, generator=gen, dtype=f64)
    H = torch.rand((1, 2), generator=torch.Generator().manual_seed(SEED + 7),
                   dtype=f64)
    models = {d: legacy_models(f64, d, H) for d in (dev, "cpu")}
    on = lambda x, d: torch.as_tensor(x, dtype=f64, device=d)

    def check(label, run, expect=None):
        got, _ = run_path(f"legacy {label} card", lambda: run(dev),
                          expect or {}, others_zero=True)
        want = run("cpu")
        got, want = leaves(got), leaves(want)
        if len(got) != len(want) or any(g.shape != w.shape
                                        for g, w in zip(got, want)):
            raise RuntimeError(f"legacy {label}: outputs differ in shape")
        err = max(rel_err(g, w) for g, w in zip(got, want))
        ok = err <= MIXTURE_TOL and all(bool(torch.isfinite(w).all())
                                        for w in want)
        log(f"legacy {label} float64 T={T} card vs cpu: {err:.3e} (tol "
            f"{MIXTURE_TOL:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"legacy {label}: card and CPU disagree")
        return want

    sim = SimulateDraws(normal(T, 2), normal(T, 1))
    xs, ys = check("SSM.simulate sinusoid", lambda d: models[d][
        "sinusoid"].simulate(T, on([0.0, 0.0], d), draws=moved(sim, d)))
    m0, P0 = torch.zeros(2, dtype=f64), torch.eye(2, dtype=f64)
    steps = normal(T, 2, LEG_PARTICLES, 2)
    for name in legacy_filters(models["cpu"]["sinusoid"]):
        stochastic = name in ("MCF", "MCLAF")
        if name.startswith("GaussSumFilt"):
            draws = BankDraws(normal(LEG_BANK, 2))
        else:
            draws = steps if stochastic else None
        check(f"{name} sinusoid", lambda d, name=name, draws=draws:
              legacy_filters(models[d]["sinusoid"])[name].run(
                  ys.to(d), m0.to(d), P0.to(d), draws=moved(draws, d)))
    init = normal(4, 2)
    check("GaussSumFilt (standalone, M=4) sinusoid",
          lambda d: legacy.GaussSumFilt(models[d]["sinusoid"], 4).run(
              ys.to(d), m0.to(d), P0.to(d), init_eps=init.to(d)))

    sim1 = SimulateDraws(normal(T, 1), normal(T, 1))
    _, ys1 = models["cpu"]["scalar"].simulate(T, on([1.0], "cpu"),
                                              draws=sim1)
    M, N, L = LEG_AGSF
    aug = AugDraws(normal(T, M, 3, 1), normal(T, M, N, 1),
                   normal(T, M * N, 3, 1), normal(T, M * N, L, 1),
                   torch.rand((T, M), generator=gen, dtype=f64))
    for modes, args in ((("prop", "prop"), (0.2, 0.2)),
                        (("opt_lip", "prop"), (1.0, 0.2)),
                        (("opt_max_grad", "prop"), (0.5, 0.2)),
                        (("test", "test"), (0.1, 0.1)),
                        (("input", "input"), (0.05, 0.05))):
        def run(d, modes=modes, args=args):
            agsf = legacy.AugGaussSumFilt(models[d]["scalar"], M, N, L)
            if modes[0] == "input":
                args = tuple(a * torch.eye(1, dtype=f64, device=d)
                             for a in args)
            agsf.set_aug_selection_params(*args, mode1=modes[0],
                                          mode2=modes[1])
            return agsf.run(ys1.to(d), on([0.0], d), on([[1.0]], d),
                            draws=moved(aug, d))
        check(f"AugGaussSumFilt {list(LEG_AGSF)} {'/'.join(modes)} scalar",
              run)

    P = LEG_CMP_P
    bdraws = BPFDraws(normal(P, 1), normal(T, P, 1),
                      torch.rand(T, generator=gen, dtype=f64))
    _, ypf = models["cpu"]["pf"].simulate(T, on([0.1], "cpu"), draws=sim1)
    check(f"BootstrapPF N={P} systematic sin/x^2",
          lambda d: legacy.BootstrapPF(models[d]["pf"], P).run(
              ypf.to(d), on([0.1], d), on([[10.0]], d),
              draws=moved(bdraws, d)),
          {"bft_resample_parents": T})

    g = lambda x: (x ** 2).sum(-1) + torch.sin(x[..., 0])
    ns, trials, base = 10, 20, 10_000
    cdraws = me.CompareDraws(normal(base, 2), normal(trials, ns, 2),
                             normal(trials, ns, 2), normal(trials, ns, ns, 2))
    check("mean_estimators.compare_estimators",
          lambda d: me.compare_estimators(
              g, on([1.0, -1.0], d), on([[0.5, 0.1], [0.1, 0.25]], d),
              num_samples=ns, num_trials=trials, baseline_samples=base,
              draws=moved(cdraws, d)))
    aeps = normal(8, 2)
    check("AugmentedJointApproximation",
          lambda d: legacy.AugmentedJointApproximation(
              8, lambda x: (x ** 2).sum(-1, keepdim=True), 2, 1,
              on([0.0, 0.0], d), torch.eye(2, dtype=f64, device=d),
              on([[0.1]], d), 0.3 * torch.eye(2, dtype=f64, device=d)
          ).return_posterior(on([1.0], d), eps=aeps.to(d)))

    freq, lat = 10.0, normal(T, 10, 1)
    f = lambda x: torch.sin(x) * torch.sin(freq * x)
    jd = lambda x: (torch.sin(x) * freq * torch.cos(freq * x)
                    + torch.cos(x) * torch.sin(freq * x))
    jo = lambda x: torch.ones((), dtype=x.dtype, device=x.device)
    params = ala.LinearModelParameters(0.0, 0.0, 0.1, 0.1)

    def ala_run(d):
        ssm = ala.StateSpaceModel(1, 1, f, lambda x: x, dtype=f64, device=d)
        _, obs = ssm.simulate(T, on([0.0], d), params, draws=moved(sim1, d))
        init = [on([0.0], d), on([[1.0]], d)]
        return (obs, ssm.extended_kalman_filter(obs, jd, jo, params, init),
                ssm.latent_ekf(obs, 10, on([[0.05]], d), jd, jo, params, init,
                               eps=lat.to(d)),
                ssm.unscented_kalman_filter(obs, init, params, 10, 2, 1))
    check("ala.StateSpaceModel (simulate, EKF, latent EKF, UKF)", ala_run)


def legacy_path(dev, card: str, add) -> None:
    """Path L: experiments/legacy_experiment.py's tables, the AGSF's
    selection modes and the legacy BPF at path A's size; REPS calls each
    (``repeated``: every counter reset per call, the BPF's K5 exactly once
    a step, every other kernel 0), walls and RMSEs (``utils.metrics.rmse``)
    against the simulated states."""
    import torch

    from bayesianfiltering_tpu_torch import legacy
    from bayesianfiltering_tpu_torch.legacy import nonlinearities as lnl
    from bayesianfiltering_tpu_torch.models import zoo
    from bayesianfiltering_tpu_torch.utils import metrics

    f32 = torch.float32
    kw = dict(dtype=f32, device=dev)
    H = torch.rand((1, 2), generator=torch.Generator().manual_seed(SEED + 7),
                   dtype=torch.float64)
    models = legacy_models(f32, dev, H)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rmse = lambda est, xs: float(metrics.rmse(est, xs))

    def table(label, run, ys, xs, point, expect):
        """``run(ys)`` warmed up on 5 steps (these loops are host-bound:
        a short warm-up builds what the first call builds), then REPS
        calls at LEG_T (one for the slowest, ``LEG_ONE_CALL``)."""
        run(ys[:5])
        torch.cuda.synchronize()
        reps = 1 if any(k in label for k in LEG_ONE_CALL) else REPS
        out, secs = repeated(f"path L {label}", lambda: run(ys), expect, add,
                             reps)
        log(f"path L {label} T={LEG_T} float32: {spread(secs)}, rmse "
            f"{rmse(point(out), xs):.4f} (utils.metrics.rmse) ({card})")

    # particlefilt_table
    m0, P0 = 0.1 * torch.ones(1, **kw), 10.0 * torch.eye(1, **kw)
    xs, ys = models["pf"].simulate(LEG_T, m0, generator=gen)
    for n in LEG_PF_N:
        bpf = legacy.BootstrapPF(models["pf"], n, generator=gen)
        table(f"BPF (N={n}) sin/x^2", lambda y: bpf.run(y, m0, P0), ys, xs,
              lambda hist: hist.mean(1), {"bft_resample_parents": LEG_T})

    # gaussfilt_table
    m0, P0 = torch.zeros(2, **kw), torch.eye(2, **kw)
    xs, ys = models["sinusoid"].simulate(LEG_T, m0, generator=gen)
    for name, filt in legacy_filters(models["sinusoid"], gen).items():
        bank = name.startswith("GaussSumFilt")
        table(f"{name} dx=2 sinusoid",
              lambda y: (filt.run(y, m0, P0, generator=gen) if bank
                         else filt.run(y, m0, P0)), ys, xs,
              (lambda out: out[3]) if bank else (lambda out: out[1]), {})

    # the AGSF's selection modes on the scalar model
    m0, P0 = torch.zeros(1, **kw), torch.eye(1, **kw)
    xs, ys = models["scalar"].simulate(LEG_T, torch.ones(1, **kw),
                                       generator=gen)
    for mode, args in LEG_AGSF_MODES:
        agsf = legacy.AugGaussSumFilt(models["scalar"], *LEG_AGSF,
                                      generator=gen)
        agsf.set_aug_selection_params(*args, mode1=mode, mode2="prop")
        table(f"AugGaussSumFilt {list(LEG_AGSF)} {mode} scalar",
              lambda y: agsf.run(y, m0, P0), ys, xs, lambda out: out[2], {})

    # the legacy BPF at path A's model and size
    f96, g96, _ = lnl.make_lorenz96(BPF_DX, BPF_DY, **kw)
    qz, rz = torch.zeros(BPF_DX, **kw), torch.zeros(BPF_DY, **kw)
    _, lp, _ = zoo.lorenz96(BPF_DX, BPF_DY, **kw)
    ssm = legacy.SSM(BPF_DX, BPF_DY, qz, lp.dynamics_noise_covariance, rz,
                     lp.emission_noise_covariance,
                     f=lambda x: f96(x, qz, None),
                     g=lambda x: g96(x, rz, None))
    _, states, em = bpf_problem(BPF_T, f32, dev)
    bpf = legacy.BootstrapPF(ssm, BPF_P, generator=gen)
    bpf.run(em[:5], lp.initial_mean, lp.initial_covariance)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist, secs = repeated(
        f"path L legacy BPF lorenz96 P={BPF_P}",
        lambda: bpf.run(em, lp.initial_mean, lp.initial_covariance),
        {"bft_resample_parents": BPF_T}, add)
    if tuple(hist.shape) != (BPF_T, BPF_P, BPF_DX) or not bool(
            torch.isfinite(hist).all()):
        raise RuntimeError("path L legacy BPF: history not finite or "
                           "misshapen")
    log(f"path L legacy BPF lorenz96 dx={BPF_DX} dy={BPF_DY} P={BPF_P} "
        f"T={BPF_T} float32: {spread(secs)}, {BPF_T} resampling steps, rmse "
        f"{rmse(hist.mean(1), states):.4f} (utils.metrics.rmse), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")


# ---------------------------------------------------------------------------
# The multi-device layer (parallel/): phase 4's ranks on the card against
# the CPU, path M and the dry runs
# ---------------------------------------------------------------------------

# Several ranks share the one card over gloo (NCCL refuses two ranks on one
# GPU); NCCL runs the dry run at world size 1. Each job's ranks are spawned
# processes (parallel.launch.run_ranks), started after phase 2's build, so
# that they load the built library and never run nvcc.
PAR_RANKS, PAR_DRY_RANKS, PAR_TIMEOUT = 2, 4, 900
# phase 4, float64, card vs the CPU ranks at MIXTURE_TOL and vs the
# single-process function on the card at the CPU tests' tolerance: the
# batched EKF on path A's Lorenz-96 (dx=8, dy=4, B=8, T=20), the BPF at
# 4,096 particles in both modes, the GSF M=8 and the AGSF [4,2,2]
# (gathered, local, UKF moments) on BOT at T=20, the time-sharded filter
# and smoother on path B's model at T=4,096 (chunk 128), the time-sharded
# IEKS on the quadratic-measurement model at T=64, 3 iterations
PAR_CMP_B, PAR_CMP_T, PAR_CMP_P, PAR_CMP_M = 8, 20, 4096, 8
PAR_CMP_COMPS = [4, 2, 2]
PAR_CMP_KF_T, PAR_CMP_IEKS_T, PAR_CMP_ITERS = 4096, 64, 3
# the single-process twins' tolerances, as the CPU tests state them:
# 1e-10 for the batched EKF (the same per-sequence kernels), 1e-8 for the
# mixtures (the normaliser summed in another order) and the time-sharded
# scans (the cross-rank level changes the combine tree)
PAR_SINGLE_TOL = {"batched ekf": 1e-10}
# path M, float32, two ranks: the EKF L96 cell through batched_filter (B =
# 512 -> 256 a rank), path A's BPF in both modes (1M particles -> 500,000
# a rank), the README quick start's GSF M=50 on BOT at T=100,
# experiments/sharded_agsf_scale.py's AGSF (BOT [6400,4,4]: 102,400
# components in flight, T=12) gathered and local, path B's time-sharded
# smoother (T=1M -> 500,000 a rank), path E's IEKS at T=2^14 (the
# rollout as a pipeline), path K's data-parallel gradient (B=64 -> 32 a
# rank, T=200)
PM_GSF_M, PM_GSF_T = 50, 100
PM_AGSF, PM_AGSF_T = [6400, 4, 4], 12
PM_IEKS_T = 2 ** 14
PM_SGD_B, PM_SGD_T = 64, 200
# the mixture point estimates' gap over the posterior spread that
# experiments/sharded_agsf_scale.py allows between the two reductions
PM_AGSF_GAP = 1.25


def par_launches():
    from bayesianfiltering_tpu_torch import _build

    return {k.name: k.launches for k in _build.KERNELS if k.launches}


def par_collectives():
    from bayesianfiltering_tpu_torch.parallel import mesh as pm

    return {k: dict(v) for k, v in pm.STATS.items()}


def par_path(fn):
    """``fn()`` on this rank with every launch counter and the collective
    statistics reset just before it and read just after; returns (output,
    {"launches", "seconds" (CUDA events), "collectives"})."""
    from bayesianfiltering_tpu_torch import _build
    from bayesianfiltering_tpu_torch.parallel import mesh as pm

    _build.reset_launch_counts()
    pm.reset_stats()
    out, secs = timed(fn)
    return out, {"launches": par_launches(), "seconds": secs,
                 "collectives": par_collectives()}


def gloo_cuda_probe(dev) -> dict:
    """Each collective of the layer called by torch.distributed itself on
    CUDA tensors of this gloo group, its result checked (the layer passes
    CUDA tensors to gloo as they are)."""
    import torch
    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    seen = {}
    for op in ("all_reduce", "broadcast", "all_gather"):
        x = torch.full((3,), float(r + 1), device=dev)
        if op == "all_reduce":
            dist.all_reduce(x)
            ok = bool((x == n * (n + 1) / 2).all())
        elif op == "broadcast":
            dist.broadcast(x, 0)
            ok = bool((x == 1).all())
        else:
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x)
            ok = all(bool((p == i + 1).all()) for i, p in enumerate(parts))
        if not ok:
            raise RuntimeError(f"gloo {op} on CUDA tensors gave wrong values")
        seen[op] = "CUDA tensors"
    return seen


def compare_parallel_ranks(device):
    """Phase 4's multi-device rank job (a ``run_ranks`` target): every
    function of the layer at a small size on the card (launches counted)
    and on the CPU with the same draws, in float64; and, where it has one,
    the single-process function on the card. Returns each case's largest
    errors, launches and finiteness."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from bayesianfiltering_tpu_torch import _build, testing
    from bayesianfiltering_tpu_torch import inference as inf
    from bayesianfiltering_tpu_torch.models import zoo
    from bayesianfiltering_tpu_torch.ops import associative as tas
    from bayesianfiltering_tpu_torch.ops.linear import ParamsLGSSM
    from bayesianfiltering_tpu_torch.parallel import (
        batched_filter,
        gather_time_blocks,
        make_mesh,
        sharded_agsf,
        sharded_bootstrap_particle_filter,
        sharded_gaussian_sum_filter,
        time_sharded_iterated_extended_smoother,
        time_sharded_kalman_filter,
        time_sharded_kalman_smoother,
    )

    _build.load()
    report = {"build_seconds": _build.build_seconds,
              "gloo": gloo_cuda_probe(device), "cases": {}}
    rank, world = dist.get_rank(), dist.get_world_size()
    f64, cpu, T = torch.float64, torch.device("cpu"), PAR_CMP_T
    gen = lambda seed: torch.Generator().manual_seed(seed)
    mesh = lambda axis, d: make_mesh((world,), (axis,), device=d)
    on = lambda x, d: None if x is None else x.to(d)

    def case(label, run, single=None):
        _build.reset_launch_counts()
        got = run(device)
        torch.cuda.synchronize()
        counts = par_launches()
        want = run(cpu)
        g, w = leaves(got), leaves(want)
        entry = {"cpu_err": max(rel_err(a, b) for a, b in zip(g, w)),
                 "launches": counts, "shapes_match": len(g) == len(w) and all(
                     a.shape == b.shape for a, b in zip(g, w)),
                 "finite": all(bool(torch.isfinite(x).all()) for x in w)}
        if single is not None:
            s = leaves(single(device))
            entry["single_err"] = max(rel_err(a, b) for a, b in zip(g, s))
        report["cases"][label] = entry
        return want

    # the batched EKF on path A's Lorenz-96
    dm, dp, _ = zoo.lorenz96(BPF_DX, BPF_DY, integrator="rk4", dtype=f64,
                             device=cpu)
    _, l96_em = dm.sample(dp, T, generator=gen(SEED + 40),
                          batch_shape=(PAR_CMP_B,))
    l96 = lambda d: zoo.lorenz96(BPF_DX, BPF_DY, dtype=f64, device=d)
    posterior = lambda p: (p.filtered_means, p.filtered_covariances,
                           p.marginal_loglik)
    case("batched ekf",
         lambda d: posterior(batched_filter(
             inf.extended_kalman_filter, l96(d)[1], l96_em.to(d),
             mesh=mesh("batch", d))),
         lambda d: posterior(inf.extended_kalman_filter(l96(d)[1],
                                                        l96_em.to(d))))

    # the BPF in both modes, each rank its own draws (the global comb's
    # uniforms in gather mode, the same on every rank)
    local_n = PAR_CMP_P // world
    like = torch.zeros((), dtype=f64)
    draws = inf.bpf_draws(gen(SEED + 50 + rank), T, local_n, BPF_DX,
                          BPF_DX, "systematic", like)
    comb = torch.rand(T, generator=gen(SEED + 60), dtype=f64)
    for mode in ("local", "gather"):
        d_mode = draws if mode == "local" else draws._replace(resample=comb)
        want = case(f"bpf {mode}", lambda d: sharded_bootstrap_particle_filter(
            l96(d)[2], l96_em[0].to(d), PAR_CMP_P, mesh("particle", d),
            draws=type(d_mode)(*(x.to(d) for x in d_mode)),
            resampling_mode=mode))
        report["cases"][f"bpf {mode}"]["resampled"] = int(
            (want["ess"] < 0.5 * PAR_CMP_P).sum())

    # the GSF and the AGSF on BOT
    bm, bp, _ = zoo.bearings_only_tracking(dtype=f64, device=cpu)
    inputs = zoo.bot_maneuver_inputs(T, device=cpu)
    _, bot_em = bm.sample(bp, T, inputs=inputs, generator=gen(SEED + 70))
    bot = lambda d: zoo.bearings_only_tracking(dtype=f64, device=d)[1]
    mix = lambda p: (p.means, p.covariances, p.weights, p.marginal_loglik)
    eps = torch.randn(PAR_CMP_M, 4, generator=gen(SEED + 71), dtype=f64)
    case("gsf",
         lambda d: mix(sharded_gaussian_sum_filter(
             bot(d), bot_em.to(d), PAR_CMP_M, mesh("mixture", d),
             inputs=inputs.to(d), init_eps=eps.to(d))),
         lambda d: mix(inf.gaussian_sum_filter(
             bot(d), bot_em.to(d), PAR_CMP_M, inputs=inputs.to(d),
             init_eps=eps.to(d))))
    adraws = inf.agsf_draws(gen(SEED + 72), T, PAR_CMP_COMPS, 4,
                            "systematic", like)
    moved_draws = lambda d, dr: type(dr)(*(on(x, d) for x in dr))
    up = ukf_params()
    for label, kw, single in (
            ("agsf", {}, lambda d: inf.augmented_gaussian_sum_filter(
                bot(d), bot_em.to(d), PAR_CMP_COMPS, inputs=inputs.to(d),
                reduction="systematic", draws=moved_draws(d, adraws))[0]),
            ("uagsf", {"moments": "ukf", "uparams": up},
             lambda d: inf.unscented_agsf(
                 bot(d), up, bot_em.to(d), PAR_CMP_COMPS,
                 inputs=inputs.to(d), reduction="systematic",
                 draws=moved_draws(d, adraws))[0]),
            ("agsf local", {"reduction": "local"}, None)):
        dr = adraws if label != "agsf local" else adraws._replace(
            reduce=torch.rand(T, generator=gen(SEED + 80 + rank), dtype=f64))
        case(label, lambda d: mix(sharded_agsf(
            bot(d), bot_em.to(d), PAR_CMP_COMPS, mesh("mixture", d),
            inputs=inputs.to(d), draws=moved_draws(d, dr),
            **{"reduction": "systematic", **kw})),
            None if single is None else (lambda d: mix(single(d))))

    # the time-sharded filter and smoother on path B's model
    fields = testing.lgssm_fields(np.random.default_rng(SEED), KF_DX, KF_DY)
    lg = lambda d: ParamsLGSSM(**{k: torch.as_tensor(v, dtype=f64, device=d)
                                  for k, v in fields.items()})
    ys = torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
        (PAR_CMP_KF_T, KF_DY)))
    kf = lambda p: (p.filtered_means, p.filtered_covariances,
                    p.marginal_loglik)
    ks = lambda p: kf(p) + (p.smoothed_means, p.smoothed_covariances)
    case("time-sharded filter",
         lambda d: kf(gather_time_blocks(time_sharded_kalman_filter(
             lg(d), ys.to(d), mesh("time", d), chunk=KF_CHUNK),
             mesh("time", d))),
         lambda d: kf(tas.parallel_kalman_filter(lg(d), ys.to(d),
                                                 chunk=KF_CHUNK)))
    case("time-sharded smoother",
         lambda d: ks(gather_time_blocks(time_sharded_kalman_smoother(
             lg(d), ys.to(d), mesh("time", d), chunk=KF_CHUNK),
             mesh("time", d))),
         lambda d: ks(tas.parallel_kalman_smoother(lg(d), ys.to(d),
                                                   chunk=KF_CHUNK)))

    # the time-sharded IEKS on the quadratic-measurement model
    qm, qp, _ = zoo.quadratic_measurement(dtype=f64, device=cpu)
    _, q_ys = qm.sample(qp, PAR_CMP_IEKS_T, generator=gen(SEED + 90))
    qpar = lambda d: zoo.quadratic_measurement(dtype=f64, device=d)[1]
    ieks = lambda out: (out[0].smoothed_means, out[0].smoothed_covariances,
                        out[0].marginal_loglik, out[1].step_norms)

    def sharded_ieks(d):
        post, aux = time_sharded_iterated_extended_smoother(
            qpar(d), q_ys.to(d), mesh("time", d), num_iter=PAR_CMP_ITERS)
        return gather_time_blocks(post, mesh("time", d)), aux

    case("time-sharded ieks", lambda d: ieks(sharded_ieks(d)),
         lambda d: ieks(inf.parallel_iterated_extended_smoother(
             qpar(d), q_ys.to(d), num_iter=PAR_CMP_ITERS)))
    return report


def par_expected(label: str, rank: int, world: int, case: dict,
                 ekf_names) -> dict:
    """The exact launches a rank of phase 4's job must show for a case:
    the time-sharded scans' local combines plus the cross-rank level (rank
    r: r filtering combines, world − 1 − r smoothing ones); K5 on rank 0
    only where rank 0 picks the global parents."""
    T, first = PAR_CMP_T, rank == 0
    k5 = "bft_resample_parents"
    kf_local = chunked_combines(PAR_CMP_KF_T // world)
    ieks_local = flat_combines(PAR_CMP_IEKS_T // world)
    passes = PAR_CMP_ITERS + 1
    table = {
        "batched ekf": {ekf_names[0]: T, ekf_names[1]: T},
        "bpf local": {k5: case.get("resampled", 0)},
        "bpf gather": {k5: T if first else 0},
        "gsf": {"bft_bank_update": T, "bft_bank_predict_cov": T},
        "agsf": {"bft_bank_update": T, "bft_bank_predict_cov": T,
                 k5: T if first else 0},
        "agsf local": {"bft_bank_update": T, "bft_bank_predict_cov": T,
                       k5: T},
        "uagsf": {"bft_ut_sigma_aug": 2 * T, "bft_ut_update": T,
                  "bft_ut_predict": T, k5: T if first else 0},
        "time-sharded filter": {"bft_bank_combine": kf_local + rank},
        "time-sharded smoother": {
            "bft_bank_combine": kf_local + rank,
            "bft_bank_smoother_elements": 1,
            "bft_bank_smoother_combine": kf_local + world - 1 - rank},
        "time-sharded ieks": {
            "bft_bank_combine": passes * (ieks_local + rank),
            "bft_bank_smoother_elements": passes,
            "bft_bank_smoother_combine": passes * (ieks_local + world - 1
                                                   - rank)},
    }
    return {k: v for k, v in table[label].items() if v}


def start_parallel_jobs(dev) -> dict:
    """The multi-device jobs that measure no time but their walls, started
    before phase 4's other card-vs-CPU checks and run beside them: the
    two-rank job on the card over gloo, the dry run at world size 1 over
    NCCL and the dry run at four ranks over gloo, each a thread waiting on
    its spawned ranks."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from bayesianfiltering_tpu_torch.parallel import (
        dryrun_multichip,
        run_ranks,
    )

    def walled(fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        return out, time.perf_counter() - t0

    torch.cuda.empty_cache()
    pool = ThreadPoolExecutor(3)
    jobs = {"ranks": pool.submit(walled, run_ranks, compare_parallel_ranks,
                                 PAR_RANKS, device=dev,
                                 timeout_s=PAR_TIMEOUT),
            "nccl": pool.submit(walled, dryrun_multichip, 1, device=dev,
                                timeout_s=PAR_TIMEOUT),
            "dry": pool.submit(walled, dryrun_multichip, PAR_DRY_RANKS,
                               device=dev, timeout_s=PAR_TIMEOUT)}
    pool.shutdown(wait=False)
    return jobs


def compare_parallel(dev, jobs: dict) -> None:
    """Phase 4, the multi-device layer: the results of
    :func:`start_parallel_jobs`: the two-rank job on the card over gloo
    against the CPU ranks (float64, MIXTURE_TOL) and the single-process
    functions, with each rank's exact launches; then the dry runs at world
    size 1 over NCCL and at four ranks over gloo."""
    import torch

    reports, wall = jobs["ranks"].result()
    ekf_names = ekf_kernels(BPF_DX, BPF_DY, torch.float64, dev)
    log(f"parallel: {PAR_RANKS} ranks on {dev} over gloo, {wall:.1f} s "
        f"(beside phase 4's other checks); each rank's library load "
        f"{[round(r['build_seconds'], 2) for r in reports]} s (the build "
        f"reused); gloo collectives: {reports[0]['gloo']}")
    failed = []
    for label in reports[0]["cases"]:
        for rank, rep in enumerate(reports):
            c = rep["cases"][label]
            want = par_expected(label, rank, PAR_RANKS, c, ekf_names)
            single_tol = PAR_SINGLE_TOL.get(label, MIXTURE_TOL)
            ok = (c["cpu_err"] <= MIXTURE_TOL and c["finite"]
                  and c["shapes_match"] and c["launches"] == want
                  and c.get("single_err", 0.0) <= single_tol)
            single = ("" if "single_err" not in c else
                      f", vs single-process {c['single_err']:.3e} (tol "
                      f"{single_tol:.0e})")
            log(f"parallel {label} rank {rank} float64: card vs cpu "
                f"{c['cpu_err']:.3e} (tol {MIXTURE_TOL:.0e}){single}, "
                f"launches {c['launches']} (expected {want}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{label} rank {rank}")
    if failed:
        raise RuntimeError(f"parallel: {failed} disagree")
    out, wall = jobs["nccl"].result()
    log(f"parallel dry run, 1 rank over NCCL on {dev}: {wall:.1f} s "
        f"(beside phase 4's other checks), stage-1 gradient "
        f"{[round(float(g), 4) for g in out['grads']]}")
    out, wall = jobs["dry"].result()
    log(f"parallel dry run, {PAR_DRY_RANKS} ranks on {dev} over gloo: "
        f"{wall:.1f} s (beside phase 4's other checks), stage-1 gradient "
        f"{[round(float(g), 4) for g in out['grads']]}")


def sgd_loss_grads(model, params, em, size):
    """Path K's loss gradient on a slice of the minibatch: ``fit_sgd``'s
    −(log p(y of the slice))/size with respect to the unconstrained Q and
    R (RealToPSD), whose sum over the slices is the minibatch's."""
    import torch

    from bayesianfiltering_tpu_torch.models.bijectors import RealToPSD
    from bayesianfiltering_tpu_torch.models.parameters import (
        from_unconstrained,
        to_unconstrained,
    )

    props = noise_props(params, RealToPSD)
    unc = to_unconstrained(params, props)
    names = ("dynamics_noise_covariance", "emission_noise_covariance")
    leaves_ = {k: getattr(unc, k).detach().requires_grad_() for k in names}
    fitted = from_unconstrained(unc._replace(**leaves_), props)
    loss = -model.marginal_log_prob(fitted, em).sum() / size
    return torch.cat([g.reshape(-1) for g in torch.autograd.grad(
        loss, list(leaves_.values()))])


def path_m_ranks(data, device):
    """Path M on this rank (a ``run_ranks`` target; ``data`` the CPU
    tensors the parent made): M1–M7, each with this rank's launch counters
    and collective statistics reset just before it and read just after.
    Rank 0 also returns the gathered outputs the parent compares."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from bayesianfiltering_tpu_torch import _build, testing
    from bayesianfiltering_tpu_torch import inference as inf
    from bayesianfiltering_tpu_torch.models import zoo
    from bayesianfiltering_tpu_torch.ops.linear import ParamsLGSSM
    from bayesianfiltering_tpu_torch.parallel import (
        batched_filter,
        gather_time_blocks,
        make_mesh,
        sharded_agsf,
        sharded_bootstrap_particle_filter,
        sharded_gaussian_sum_filter,
        time_sharded_iterated_extended_smoother,
        time_sharded_kalman_smoother,
    )
    from bayesianfiltering_tpu_torch.parallel.mesh import all_gather, psum

    t_start = time.time()
    _build.load()
    rank, world = dist.get_rank(), dist.get_world_size()
    f32, dev = torch.float32, device
    mesh = lambda axis: make_mesh((world,), (axis,), device=dev)
    d = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
         for k, v in data.items()}
    report = {"build_seconds": _build.build_seconds, "paths": {},
              "outputs": {}, "start": t_start}
    keep = lambda name, x: report["outputs"].__setitem__(
        name, x.detach().cpu()) if rank == 0 else None

    def path(label, fn):
        out, stats = par_path(fn)
        report["paths"][label] = stats
        return out

    # M1: the EKF L96 cell through batched_filter; each rank keeps its
    # slice of the (512, 1000, 64, 64) covariance histories (two of 8.4 GB
    # whole), and the filtered means are gathered apart
    params = zoo.lorenz96(EKF_DX, EKF_DY, dtype=f32, device=dev)[1]
    batched_filter(inf.extended_kalman_filter, params, d["l96"][:, :20],
                   mesh=mesh("batch"))                     # warm-up
    post = path("M1 batched ekf", lambda: batched_filter(
        inf.extended_kalman_filter, params, d["l96"], mesh=mesh("batch"),
        gather=False))
    keep("ekf_means", all_gather(post.filtered_means, mesh("batch"),
                                 tiled=True))
    del post

    # M2: path A's BPF in both modes
    bpf = zoo.lorenz96(BPF_DX, BPF_DY, dtype=f32, device=dev)[2]
    for mode in ("local", "gather"):
        gen = torch.Generator(device=dev).manual_seed(SEED + 7 + rank)
        sharded_bootstrap_particle_filter(bpf, d["bpf_em"][:5], BPF_P,
                                          mesh("particle"), gen,
                                          resampling_mode=mode)
        out = path(f"M2 bpf {mode}", lambda: sharded_bootstrap_particle_filter(
            bpf, d["bpf_em"], BPF_P, mesh("particle"), gen,
            resampling_mode=mode))
        report["paths"][f"M2 bpf {mode}"]["resampled"] = int(
            (out["ess"] < 0.5 * BPF_P).sum())
        keep(f"bpf_{mode}_means", out["means"])

    # M3: the README's GSF M=50 on BOT
    bot = zoo.bearings_only_tracking(dtype=f32, device=dev)[1]
    sharded_gaussian_sum_filter(bot, d["gsf_em"][:5], PM_GSF_M,
                                mesh("mixture"), inputs=d["gsf_inputs"],
                                init_eps=d["gsf_eps"])     # warm-up
    post = path("M3 gsf", lambda: sharded_gaussian_sum_filter(
        bot, d["gsf_em"], PM_GSF_M, mesh("mixture"),
        inputs=d["gsf_inputs"], init_eps=d["gsf_eps"]))
    for name in ("means", "weights", "marginal_loglik"):
        keep(f"gsf_{name}", getattr(post, name))

    # M4: the AGSF at 102,400 components in flight, both reductions
    draws = inf.AGSFDraws(d["agsf_init"], d["agsf_split1"],
                          d["agsf_split2"], d["agsf_reduce"])
    local_reduce = torch.rand(PM_AGSF_T, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 100 + rank))
    sharded_agsf(bot, d["agsf_em"][:2], PM_AGSF, mesh("mixture"),
                 inputs=d["agsf_inputs"], draws=draws)     # warm-up
    for reduction, dr in (("systematic", draws),
                          ("local", draws._replace(reduce=local_reduce))):
        post = path(f"M4 agsf {reduction}", lambda: sharded_agsf(
            bot, d["agsf_em"], PM_AGSF, mesh("mixture"),
            inputs=d["agsf_inputs"], reduction=reduction, draws=dr))
        for name in ("means", "covariances", "weights", "marginal_loglik"):
            keep(f"agsf_{reduction}_{name}", getattr(post, name))
        del post
    # the gathered AGSF again in float64, at the same width and draws: the
    # single-process engine's result to rounding (in float32 a weight's
    # last bit moves a comb's pick, and the runs part)
    bot64 = zoo.bearings_only_tracking(dtype=torch.float64, device=dev)[1]
    post = path("M4 agsf systematic float64", lambda: sharded_agsf(
        bot64, d["agsf_em"].double(), PM_AGSF, mesh("mixture"),
        inputs=d["agsf_inputs"], reduction="systematic",
        draws=inf.AGSFDraws(*(x.double() for x in draws))))
    for name in ("means", "weights", "marginal_loglik"):
        keep(f"agsf64_{name}", getattr(post, name))
    del post

    # M5: path B's time-sharded smoother at T = 1M
    fields = testing.lgssm_fields(np.random.default_rng(SEED), KF_DX, KF_DY)
    lg = ParamsLGSSM(**{k: torch.as_tensor(v, dtype=f32, device=dev)
                        for k, v in fields.items()})
    time_sharded_kalman_smoother(lg, d["kf_ys"][:KF_CMP_T], mesh("time"),
                                 chunk=KF_CHUNK)           # warm-up
    post = path("M5 time-sharded smoother", lambda: time_sharded_kalman_smoother(
        lg, d["kf_ys"], mesh("time"), chunk=KF_CHUNK))
    whole = gather_time_blocks(post, mesh("time"))
    keep("kf_smoothed_means", whole.smoothed_means)
    keep("kf_loglik", whole.marginal_loglik)
    del post, whole

    # M6: path E's IEKS at T = 2^14, the rollout as a pipeline
    ungm = zoo.scalar_growth(device=dev)[1]
    time_sharded_iterated_extended_smoother(
        ungm, d["ieks_ys"][:4096], mesh("time"), num_iter=PE_ITER,
        chunk=KF_CHUNK)                                    # warm-up
    post, aux = path("M6 time-sharded ieks", lambda: (
        time_sharded_iterated_extended_smoother(
            ungm, d["ieks_ys"], mesh("time"), num_iter=PE_ITER,
            chunk=KF_CHUNK)))
    keep("ieks_smoothed_means",
         gather_time_blocks(post, mesh("time")).smoothed_means)
    keep("ieks_norms", aux.step_norms)

    # M7: path K's data-parallel gradient
    model, params = l96_model(f32, dev)
    em = d["l96"][:PM_SGD_B, :PM_SGD_T]
    start, stop = mesh("batch").block(PM_SGD_B, "batch size")
    sgd_loss_grads(model, params, em[start:stop, :10], em.numel())  # warm-up
    grads = path("M7 dp gradient", lambda: psum(sgd_loss_grads(
        model, params, em[start:stop], em.numel()), mesh("batch")))
    keep("sgd_grads", grads)
    report["end"] = time.time()
    return report


def path_m_expected(label: str, rank: int, world: int, stats: dict) -> dict:
    """The exact launches of a rank on path M."""
    first, T = rank == 0, PM_AGSF_T
    k5 = "bft_resample_parents"
    kf = chunked_combines(KF_T // world)
    ieks = chunked_combines(PM_IEKS_T // world)
    passes = PE_ITER + 1
    table = {
        "M1 batched ekf": {"bft_ekf_update": EKF_T,
                           "bft_ekf_predict_cov": EKF_T},
        "M2 bpf local": {k5: stats.get("resampled", 0)},
        "M2 bpf gather": {k5: BPF_T if first else 0},
        "M3 gsf": {"bft_bank_update": PM_GSF_T,
                   "bft_bank_predict_cov": PM_GSF_T},
        "M4 agsf systematic": {"bft_bank_update": T,
                               "bft_bank_predict_cov": T,
                               k5: T if first else 0},
        "M4 agsf systematic float64": {"bft_bank_update": T,
                                       "bft_bank_predict_cov": T,
                                       k5: T if first else 0},
        "M4 agsf local": {"bft_bank_update": T, "bft_bank_predict_cov": T,
                          k5: T},
        "M5 time-sharded smoother": {
            "bft_bank_combine": kf + rank, "bft_bank_smoother_elements": 1,
            "bft_bank_smoother_combine": kf + world - 1 - rank},
        "M6 time-sharded ieks": {
            "bft_bank_combine": passes * (ieks + rank),
            "bft_bank_smoother_elements": passes,
            "bft_bank_smoother_combine": passes * (ieks + world - 1 - rank)},
        "M7 dp gradient": {"bft_ekf_update": PM_SGD_T,
                           "bft_ekf_predict_cov": PM_SGD_T},
    }
    return {k: v for k, v in table[label].items() if v}


def agsf_gap(ref_w, ref_m, ref_P, w, m) -> float:
    """experiments/sharded_agsf_scale.py's agreement measure: the largest
    gap between two mixtures' point estimates over the reference's
    posterior spread (+0.05)."""
    import torch

    pt_ref = torch.einsum("mt,mtd->td", ref_w, ref_m)
    pt = torch.einsum("mt,mtd->td", w, m)
    spread = torch.einsum("mt,mtdd->td", ref_w, ref_P).clamp_min(0).sqrt()
    return float(((pt_ref - pt).abs() / (spread + 0.05)).max())


def path_m(dev, card: str, add, refs: dict) -> None:
    """Phase 5, path M: the single-process references it is held to (made
    here on the card, or kept from the earlier paths in ``refs``), then
    the two-rank job on the card over gloo, each rank's exact launches,
    walls, collective bytes and seconds."""
    import torch

    from bayesianfiltering_tpu_torch import inference as inf
    from bayesianfiltering_tpu_torch.models import zoo
    from bayesianfiltering_tpu_torch.parallel import run_ranks
    from bayesianfiltering_tpu_torch.utils import metrics

    f32 = torch.float32
    params_b, inputs_a, states_a, em_a = bot_problem(PM_AGSF_T, f32, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 99)
    draws = inf.agsf_draws(gen, PM_AGSF_T, PM_AGSF, 4, "systematic", em_a)
    (single_agsf, _), secs_agsf = timed(lambda: inf.augmented_gaussian_sum_filter(
        params_b, em_a, PM_AGSF, inputs=inputs_a, reduction="systematic",
        draws=draws))
    again, _ = inf.augmented_gaussian_sum_filter(
        params_b, em_a, PM_AGSF, inputs=inputs_a, reduction="systematic",
        draws=draws)
    log(f"path M the single-process AGSF {PM_AGSF} float32 called twice on "
        f"the same draws: share of equal component means "
        f"{float((again.means == single_agsf.means).all(-1).float().mean()):.4f}"
        f", loglik {float(single_agsf.marginal_loglik):.4f} and "
        f"{float(again.marginal_loglik):.4f} ({card})")
    del again
    params_b64 = zoo.bearings_only_tracking(dtype=torch.float64,
                                            device=dev)[1]
    (single_agsf64, _), secs_agsf64 = timed(
        lambda: inf.augmented_gaussian_sum_filter(
            params_b64, em_a.double(), PM_AGSF, inputs=inputs_a,
            reduction="systematic",
            draws=inf.AGSFDraws(*(x.double() for x in draws))))
    ungm, ieks_ys = path_e_problem(PM_IEKS_T, dev)
    (single_ieks, _), secs_ieks = timed(lambda: path_e_run(ungm, ieks_ys))
    model, params = l96_model(f32, dev)
    em = refs["l96"][:PM_SGD_B, :PM_SGD_T]
    single_grads, secs_sgd = timed(lambda: sgd_loss_grads(model, params, em,
                                                          em.numel()))
    log(f"path M single-process references on one card: agsf {PM_AGSF} "
        f"T={PM_AGSF_T} {secs_agsf:.4f} s (float64 {secs_agsf64:.4f} s), ieks T={PM_IEKS_T} "
        f"{secs_ieks:.4f} s, the path K gradient B={PM_SGD_B} T={PM_SGD_T} "
        f"{secs_sgd:.4f} s ({card})")
    gsf_params, gsf_inputs, _, gsf_em = refs["bot100"]
    data = {"l96": refs["l96"], "bpf_em": refs["bpf_em"],
            "gsf_em": gsf_em, "gsf_inputs": gsf_inputs,
            "gsf_eps": refs["gsf_eps"], "agsf_em": em_a,
            "agsf_inputs": inputs_a, "agsf_init": draws.init,
            "agsf_split1": draws.split1, "agsf_split2": draws.split2,
            "agsf_reduce": draws.reduce, "kf_ys": refs["kf_ys"],
            "ieks_ys": ieks_ys}
    data = {k: v.cpu() for k, v in data.items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0, w0 = time.perf_counter(), time.time()
    reports = run_ranks(path_m_ranks, PAR_RANKS, data, device=dev,
                        timeout_s=PAR_TIMEOUT)
    w1 = time.time()
    log(f"path M: {PAR_RANKS} ranks on {dev} over gloo, job wall "
        f"{time.perf_counter() - t0:.1f} s: from the call to each rank's "
        f"first line {[round(r['start'] - w0, 1) for r in reports]} s, "
        f"each rank's work {[round(r['end'] - r['start'], 1) for r in reports]}"
        f" s, from its return to the parent's "
        f"{[round(w1 - r['end'], 1) for r in reports]} s; each rank's "
        f"library load {[round(r['build_seconds'], 2) for r in reports]} s "
        f"({card})")

    failed = []
    for label in reports[0]["paths"]:
        for rank, rep in enumerate(reports):
            st = rep["paths"][label]
            want = path_m_expected(label, rank, PAR_RANKS, st)
            ok = st["launches"] == want
            coll = ", ".join(
                f"{op} {c['calls']} calls {c['bytes'] / 1e6:.3f} MB "
                f"{c['seconds']:.4f} s" for op, c in
                sorted(st["collectives"].items()))
            log(f"path {label} rank {rank} float32: {st['seconds']:.4f} s, "
                f"launches {st['launches']} (expected {want}) "
                f"{'ok' if ok else 'FAIL'}; collectives: {coll or 'none'} "
                f"({card})")
            if not ok:
                failed.append(f"{label} rank {rank}")
        for r in reports:
            for name, n in r["paths"][label]["launches"].items():
                add({name: n})
    if failed:
        raise RuntimeError(f"path M: {failed} launched other counts")

    out = reports[0]["outputs"]
    checks = []

    def held(label, err, tol):
        ok = err <= tol
        checks.append(ok)
        log(f"path M {label}: {err:.3e} (tol {tol:.0e}) "
            f"{'ok' if ok else 'FAIL'} ({card})")

    held("M1 batched ekf vs the single-process EKF L96 (filtered means)",
         rel_err(out["ekf_means"], refs["ekf_means"]), EKF_TOL["float32"])
    for mode in ("local", "gather"):
        log(f"path M2 bpf {mode} rmse "
            f"{float(metrics.rmse(out[f'bpf_{mode}_means'], refs['bpf_states'].cpu())):.4f}"
            f" beside path A's {refs['bpf_rmse']:.4f} (utils.metrics.rmse) "
            f"({card})")
    held("M3 gsf M=50 vs the single-process GSF (weighted means)",
         rel_err((out["gsf_weights"][..., None] * out["gsf_means"]).sum(0),
                 (refs["gsf"].weights[..., None] * refs["gsf"].means).sum(0)),
         EKF_TOL["float32"])
    w, m, P = (getattr(single_agsf, k).cpu() for k in
               ("weights", "means", "covariances"))
    for reduction in ("systematic", "local"):
        gap = agsf_gap(w, m, P, out[f"agsf_{reduction}_weights"],
                       out[f"agsf_{reduction}_means"])
        same = float((out[f"agsf_{reduction}_means"] == m).all(-1).float()
                     .mean())
        held(f"M4 agsf {reduction} vs the single-process AGSF: point "
             f"estimate gap over the posterior spread (share of equal "
             f"component means {same:.4f}, loglik "
             f"{float(out[f'agsf_{reduction}_marginal_loglik']):.4f} vs "
             f"{float(single_agsf.marginal_loglik):.4f})", gap, PM_AGSF_GAP)
        mass = float((out[f"agsf_{reduction}_weights"].sum(0) - 1).abs().max())
        held(f"M4 agsf {reduction} weights' sum - 1", mass, 1e-4)
    held(f"M4 agsf systematic float64 vs the single-process AGSF in float64 "
         f"(component means and weights; loglik "
         f"{float(out['agsf64_marginal_loglik']):.6f} vs "
         f"{float(single_agsf64.marginal_loglik):.6f})",
         max(rel_err(out["agsf64_means"], single_agsf64.means),
             rel_err(out["agsf64_weights"], single_agsf64.weights)),
         MIXTURE_TOL)
    held("M5 time-sharded smoother vs path B's single-process smoother "
         "(smoothed means)", rel_err(out["kf_smoothed_means"],
                                     refs["kf_smoothed_means"]),
         EKF_TOL["float32"])
    held("M6 time-sharded ieks vs the single-process IEKS (smoothed means)",
         rel_err(out["ieks_smoothed_means"], single_ieks.smoothed_means),
         EKF_TOL["float32"])
    held("M7 all-reduced gradient vs the single-process gradient",
         rel_err(out["sgd_grads"], single_grads), 1e-4)
    if not all(checks):
        raise RuntimeError("path M: a result disagrees with its reference")


def ukf_split(prof) -> dict:
    """Device ms of K6t, K7t, K8t and K9t in a trace of config 5's UKF.
    They share the product and factor kernels, so their launches are told
    apart by name and launch order: K6t's and K7t's Cholesky are one launch
    each (the factor with the points as its epilogue: ``PointsEpilogue``
    in K6t's name, ``SigmaAugEpilogue`` in K7t's), the Newton–Schulz
    routes run from their trace pass to their points pass, booked to K7t
    where their first product is a grouped launch (P's and C's rounds
    paired, ``tiled_gemm_pair_kernel``), else to K6t; K8t is its centring pass and the three launches after it (the moments,
    the factor, the covariance), K9t its mean-and-centre pass
    (``K9T_FIRST``) and the one product after it."""
    from torch.autograd import DeviceType

    events = sorted((e for e in prof.events()
                     if e.device_type != DeviceType.CPU),
                    key=lambda e: e.time_range.start)
    split = {"K6": 0.0, "K6t": 0.0, "K7t": 0.0, "K8t": 0.0, "K9t": 0.0,
             "other": 0.0}
    owner, k8t_left, ns_trace = None, 0, 0.0
    for e in events:
        name, us = e.name, e.time_range.elapsed_us()
        if "ut_sigma_kernel" in name:
            split["K6"] += us
            continue
        if "SigmaAugEpilogue" in name:
            split["K7t"] += us
            continue
        if "PointsEpilogue" in name:
            split["K6t"] += us
            continue
        if owner is None and "sigma_tiled_trace_kernel" in name:
            owner, ns_trace = "NS", us  # K6t's or K7t's: its product says
            continue
        if owner == "NS":
            owner = "K7t" if "tiled_gemm_pair_kernel" in name else "K6t"
            split[owner] += ns_trace
        elif "ut_tiled_centre_kernel" in name:
            owner, k8t_left = "K8t", CUDA_LAUNCHES["bft_ut_update_tiled"]
        elif K9T_FIRST in name:
            owner = "K9t"
        split[owner or "other"] += us
        if owner == "K8t":
            k8t_left -= 1
        if ("sigma_tiled_points_kernel" in name or (owner == "K8t"
                                                    and k8t_left == 0)
                or (owner == "K9t" and "tiled_gemm_kernel" in name)):
            owner = None
    return {k: v / 1e3 for k, v in split.items()}


def bpf_split(prof) -> dict:
    """Device ms of the parts of path A's resampling steps in a trace of
    the BPF: the counts' cummax (PyTorch's scan with indices), K5, the
    int32 → int64 ``.long()`` and the particles' gather, told apart by
    name and launch order (the copy and the gather are the two launches
    after K5), the cumsum of the weights (CUB's scan), and the rest."""
    from torch.autograd import DeviceType

    events = sorted((e for e in prof.events()
                     if e.device_type != DeviceType.CPU),
                    key=lambda e: e.time_range.start)
    split = {"cummax": 0.0, "K5": 0.0, ".long()": 0.0, "gather": 0.0,
             "cumsum": 0.0, "other": 0.0}
    after_k5 = 0
    for e in events:
        name, us = e.name, e.time_range.elapsed_us()
        if "resample_parents_kernel" in name:
            part, after_k5 = "K5", 1
        elif after_k5 == 1 and "copy" in name:
            part, after_k5 = ".long()", 2
        elif after_k5 == 2 and ("index" in name or "gather" in name):
            part, after_k5 = "gather", 0
        elif "scan_innermost_dim_with_indices" in name:
            part = "cummax"
        elif "DeviceScan" in name:
            part = "cumsum"
        else:
            part, after_k5 = "other", 0
        split[part] += us
    return {k: v / 1e3 for k, v in split.items()}


def profile_run(label: str, run, card: str, host: bool = False,
                split=None, cpu: bool = True) -> None:
    """The device's busy share of ``run()`` under torch.profiler, against
    the traced and the untraced wall, and the kernels with the most device
    time; with ``host``, also the host operations (and CUDA runtime calls)
    with the most self CPU time; with ``split``, the device time that it
    attributes to each kernel of the path. ``cpu=False`` records the
    device's activity alone: on a path that launches ~400 kernels a step
    through ``torch.func``, the host operations made the trace's summary
    the longest part of the run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    _, untraced = timed(run)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]
                 + ([ProfilerActivity.CPU] if cpu else [])) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # device-side events only: a host op's self device time repeats the
    # kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type != DeviceType.CPU]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    if device_s == 0:
        log(f"profile {label}: the profiler saw no device time; busy share "
            "not measured")
        return
    log(f"profile {label}: wall {wall:.4f} s traced, {untraced:.4f} s "
        f"untraced; device {device_s:.4f} s; busy {device_s / wall:.3f} of "
        f"the traced wall, {device_s / untraced:.3f} of the untraced wall "
        f"({card})")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    if split is not None:
        parts = split(prof)
        log("  split of the device time: " + ", ".join(
            f"{k} {v:.3f} ms ({v / 1e3 / device_s:.3f})"
            for k, v in parts.items()))
    if host:
        ops = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CPU]
        log(f"  host: {sum(e.self_cpu_time_total for e in ops) / 1e3:.3f} ms "
            "of self CPU time traced; the most:")
        for e in sorted(ops, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:8]:
            log(f"  {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
                f"host {e.key[:84]}")


def profile_ukf(dev, card: str) -> None:
    """Phase 6: device busy and idle share of the batched UKF step
    (B=512, dx=64) over PROFILE_T steps, of PROFILE_T steps of path A, of
    one run of path B, of C5_PROFILE_T steps of each config-5 filter, of
    one run of path C with each solver (the native one with its host
    operations), of one run of each of path D's smoothers at PD_PROFILE_T
    steps and of path E at PE_PROFILE_T steps (the device's activity
    alone), under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bayesianfiltering_tpu_torch import inference as inf
    from bayesianfiltering_tpu_torch.ops import associative as tas

    params, _, emissions = lorenz96_data(dev, torch.float32)
    em = emissions[:, :PROFILE_T]
    # the first profiled region also pays the tracer's start-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        inf.unscented_kalman_filter(params, ukf_params(), em[:, :1])
        torch.cuda.synchronize()
    for additive in (True, False):
        kind = "additive" if additive else "augmented"
        profile_run(
            f"ukf {kind} B={EKF_B} dx={EKF_DX} {PROFILE_T} steps float32",
            lambda: inf.unscented_kalman_filter(params, ukf_params(), em,
                                                additive=additive), card)

    bpf, _, bem = bpf_problem(PROFILE_T, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    profile_run(f"bpf P={BPF_P} dx={BPF_DX} {PROFILE_T} steps float32",
                lambda: inf.bootstrap_particle_filter(bpf, bem, BPF_P, gen,
                                                      store="summary"), card,
                split=bpf_split)
    kparams, ys = kf_problem(KF_T, torch.float32, dev)
    profile_run(f"parallel kalman smoother T={KF_T} chunk={KF_CHUNK} float32",
                lambda: tas.parallel_kalman_smoother(kparams, ys,
                                                     chunk=KF_CHUNK), card)
    params5, _, em5 = config5_data(C5_PROFILE_T, torch.float32, dev)
    for label, run, _ in config5_runs():
        profile_run(f"config 5 {label} B=1 dx={C5_DX} {C5_PROFILE_T} steps "
                    "float32", lambda: run(params5, em5), card,
                    host=label.startswith("ekf"),
                    split=ukf_split if label.startswith("ukf") else None)
    cparams, cys = path_c_problem(PC_T, torch.float32, dev)
    for solver in ("woodbury", "native"):
        profile_run(f"path C parallel kalman smoother {solver} T={PC_T} "
                    f"dx={PC_DX} chunk={KF_CHUNK} float32",
                    lambda: tas.parallel_kalman_smoother(
                        cparams, cys, solver=solver, chunk=KF_CHUNK), card,
                    host=solver == "native")
    # path D's smoothers and path E at short T, the device's activity alone
    # (their host time is ~20 ms and ~140 us a step, so that the full
    # paths' traces would take minutes)
    dparams, dinputs, _, dem = rb_problem(PD_PROFILE_T, torch.float32, dev)
    for label, run, _ in smoother_runs(PD_PROFILE_T, PD_ITER):
        profile_run(f"path D {label} range-bearing T={PD_PROFILE_T} "
                    f"{PD_ITER} iterations float32",
                    lambda: run(dparams, dinputs, dem), card, cpu=False)
    eparams, eys = path_e_problem(PE_PROFILE_T, dev)
    profile_run(f"path E ieks scalar growth T={PE_PROFILE_T} float32",
                lambda: path_e_run(eparams, eys), card, cpu=False)
    # path F's AGSF with autocov "sdp" at SLICE_PROFILE_T steps (the
    # device's activity alone: its step is ~55 ms of host work, and a
    # trace at T = 100 took ~45 s to summarise on the H100 machine's host)
    # and path H's steady-state smoother at T = 1M
    from bayesianfiltering_tpu_torch.ops import steady_state as ss

    fparams, _, _, _, fem = expa_problem(SLICE_PROFILE_T, 0, torch.float32,
                                         dev)
    fgen = torch.Generator(device=dev).manual_seed(SEED + 300)
    profile_run(f"path F agsf [3,2,2] sdp T={SLICE_PROFILE_T} float32",
                lambda: inf.augmented_gaussian_sum_filter(
                    fparams, fem, [3, 2, 2], fgen, 1, EXPA_OPT_ARGS,
                    autocov="sdp"), card, cpu=False)
    profile_run(f"path H steady-state smoother T={KF_T} float32",
                lambda: ss.steady_state_kalman_smoother(
                    kparams, ys, head=SS_HEAD, num_iters=SS_ITERS), card,
                host=True)


# ---------------------------------------------------------------------------
# Parent against change: python3 chip_smoke.py --ab PARENT_ROOT
# ---------------------------------------------------------------------------

# What --ab times, in this order (``<part>_times``).
AB_PARTS = ("sigma", "ut", "ekf", "combine", "bank", "resample")
# K5 at path A's n = 1M and at the Gaussian-sum reductions' (m, n)
RESAMPLE_REDUCTIONS = ((200, 50), (32, 8), (64, 16))


def ab_times(root: str, parts=AB_PARTS) -> None:
    """``--ab-times ROOT [PART ...]``: ``sigma_times``, ``ut_times``,
    ``ekf_times``, ``combine_times``, ``bank_times`` and
    ``resample_times``, or those of them named in PARTS (``sigma``, ``ut``,
    ``ekf``, ``combine``, ``bank``, ``resample``), with the port of the
    checkout at ROOT (built into that checkout's build directory)."""
    sys.path.insert(0, root)
    for part in parts:
        globals()[f"{part}_times"](root)


def ekf_times(root: str) -> None:
    """K1 and K2 in float32 and float64 at the batched Lorenz-96 EKF's
    shapes (B = 512: the update at dx = 64, dy = 32, the predict at
    dx = dq = 64) and at the bearings-only widths over the same batch and
    over a bank of 100, as ``ut_times`` times the banks (the update at
    dx = 4, dy = 1 and 2, the predict at dx = 4, dq = 2): the
    device time per call (``device_ms``) and the max abs error against the
    plain version on the same inputs; then the wall of the EKF on the
    Lorenz-96 data (B = 512, T = 1000, float32): the median and range of
    REPS calls after a warm-up. Inputs from ``testing`` with SEED."""
    import numpy as np
    import torch

    from bayesianfiltering_tpu_torch import _build, testing
    from bayesianfiltering_tpu_torch import inference as inf
    from bayesianfiltering_tpu_torch.ops import fused_ekf as fe

    _build.load()
    dev = torch.device("cuda", 0)
    updates = ((EKF_B, EKF_DX, EKF_DY), (EKF_B, 4, 1), (EKF_B, 4, 2),
               (UGSF_M, 4, 1), (UGSF_M, 4, 2))
    predicts = ((EKF_B, EKF_DX, EKF_DX), (EKF_B, 4, 2), (UGSF_M, 4, 2))
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        rng = np.random.default_rng(SEED)

        def on_card(xs):
            return [torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
                    for x in xs]

        def show(label, fn, plain):
            err = max(float((g - w).abs().max()) for g, w in
                      zip(_as_tuple(fn()), _as_tuple(plain())))
            log(f"{root} {label} {name}: device {device_ms(fn, ('ekf_',))} "
                f"ms, max abs err {err:.3e} against the plain version")

        for B, dx, dy in updates:
            a = on_card(testing.update_inputs(rng, B, dx, dy))
            show(f"K1 B={B} dx={dx} dy={dy}",
                 lambda: fe.fused_update(*a, 0.0),
                 lambda: fe._update_plain(*a, 0.0))
        for B, dx, dq in predicts:
            a = on_card(testing.predict_inputs(rng, B, dx, dq))
            show(f"K2 B={B} dx={dx} dq={dq}",
                 lambda: fe.fused_predict_cov(*a),
                 lambda: fe._predict_plain(*a))
    params, _, emissions = lorenz96_data(dev, torch.float32)
    run = lambda: inf.extended_kalman_filter(params, emissions)
    inf.extended_kalman_filter(params, emissions[:, :20])
    secs = [timed(run)[1] for _ in range(REPS)]
    log(f"{root} ekf lorenz96 B={EKF_B} T={EKF_T} float32: {spread(secs)}")


def combine_times(root: str) -> None:
    """The combines and elements of the parallel smoother, inputs from
    ``testing`` with SEED: K10b and K12b at path C's three shapes (dx = 64:
    M = 512, the 4-lane level, the (1, 512) × (128, 512) broadcast of step
    4) in float32: the device time per call (``device_ms``) and the
    CUDA-event time of a loop of calls; where the checkout picks K10b's
    block size (``bank_combine.block_threads``), K10b at 4 and 512 lanes
    with 256 and with 512 threads a block, each forced; then the walls of
    path B (T = 1M) and of path C's two solvers (T = 65,536), chunk 128:
    the median and range of REPS calls after a warm-up; last, so that the
    plain versions' allocations come after the walls, each with its max
    abs error against the plain version, the lane kernels K10 and K12 at
    path B's five shapes (dx = 4: M = 7,813, 62 and 1, the (1, 62) ×
    (128, 62) and (1, 7,813) × (128, 7,813) broadcasts) and K11 at its
    one (M = 999,999, F shared) and at its band's edge (M = 65,536, dx = 8,
    F banked) in float32 and float64, and K11b at path C's shape
    (M = 65,535, dx = 64, F shared) and at M = 4,096 with F banked in
    float32 and float64: device and event ms."""
    import numpy as np
    import torch

    from bayesianfiltering_tpu_torch import testing
    from bayesianfiltering_tpu_torch.ops import associative as tas
    from bayesianfiltering_tpu_torch.ops import bank_combine as bc
    from bayesianfiltering_tpu_torch.ops import bank_smoother as bs

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def on_card(xs, dtype=torch.float32):
        return [torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
                for x in xs]

    def operands(make, M, chunk, dtype=torch.float32):
        if chunk is None:
            return on_card(make(rng, M) + make(rng, M), dtype), f"M={M}"
        return (on_card([x[None] for x in make(rng, M)]
                        + [x.reshape((chunk, M) + x.shape[1:])
                           for x in make(rng, chunk * M)], dtype),
                f"(1,{M}) x ({chunk},{M})")

    fwrap = lambda a: bc.bank_filter_combine(a[:5], a[5:])
    swrap = lambda a: bs.bank_smoother_combine(a[:3], a[3:])
    wide = ((PC_LANES, None), (PC_NARROW, None), (PC_LANES, KF_CHUNK))
    kinds = (
        ("K10b", fwrap,
         lambda r, M: testing.filter_elements(r, M, PC_DX, PC_DX // 2,
                                              normalized=True)),
        ("K12b", swrap, lambda r, M: testing.smoother_elements(r, M, PC_DX)))
    for name, wrap, make in kinds:
        for M, chunk in wide:
            a, shape = operands(make, M, chunk)
            fn = lambda: wrap(a)
            log(f"{root} {name} {shape} dx={PC_DX} float32: device "
                f"{device_ms(fn, ('',))} ms, event {cuda_time_ms(fn):.5f} ms")
    rule = getattr(bc, "block_threads", None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for M in ((PC_NARROW, PC_LANES) if rule is not None else ()):
        a = on_card(kinds[0][2](rng, M) + kinds[0][2](rng, M))
        fn = lambda: fwrap(a)
        picked = rule(bc.BLOCK_COMBINE, M, bc.TILE, 4, sms)
        for threads in (256, 512):
            bc.block_threads = lambda *_, t=threads: t
            log(f"{root} K10b M={M} dx={PC_DX} float32 at {threads} threads "
                f"a block (the rule picks {picked}): device "
                f"{device_ms(fn, ('',))} ms, event {cuda_time_ms(fn):.5f} ms")
        bc.block_threads = rule
    walls = [("path B woodbury", KF_T, KF_DX, kf_problem, "woodbury")]
    walls += [(f"path C {solver}", PC_T, PC_DX, path_c_problem, solver)
              for solver in ("woodbury", "native")]
    for label, T, dx, problem, solver in walls:
        params, ys = problem(T, torch.float32, dev)
        run = lambda: tas.parallel_kalman_smoother(params, ys, solver=solver,
                                                   chunk=KF_CHUNK)
        run()
        secs = [timed(run)[1] for _ in range(REPS)]
        log(f"{root} {label} T={T} dx={dx} float32: {spread(secs)}")
    lane = ((KF_LANES, None), (KF_LANES, KF_CHUNK), (KF_NARROW, None),
            (1, None), (KF_NARROW, KF_CHUNK))
    lanes = (
        ("K10", fwrap, lambda a: tas._combine(a[:5], a[5:]),
         lambda r, M: testing.filter_elements(r, M, KF_DX)),
        ("K12", swrap, lambda a: tas._smoother_combine(a[:3], a[3:]),
         lambda r, M: testing.smoother_elements(r, M, KF_DX)))
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        for kernel, wrap, plain, make in lanes:
            for M, chunk in lane:
                a, shape = operands(make, M, chunk, dtype)
                fn = lambda: wrap(a)
                got = fn()
                err = max(float((g - w).abs().max())
                          for g, w in zip(got, plain(a)))
                log(f"{root} {kernel} {shape} dx={KF_DX} {name}: device "
                    f"{device_ms(fn, ('',))} ms, event "
                    f"{cuda_time_ms(fn):.5f} ms, max abs err {err:.3e} "
                    f"against the plain version, outputs {digest(got)}")
    for M, dx, banked in ((KF_T - 1, KF_DX, False), (65_536, 8, True),
                          (PC_T - 1, PC_DX, False), (4096, PC_DX, True)):
        raw = testing.smoother_element_inputs(rng, M, dx)
        for dtype in (torch.float32, torch.float64):
            fm, fP, pm, pP, F = on_card(raw, dtype)
            F = F if banked else F[0].expand(M, dx, dx)
            fn = lambda: bs.bank_smoother_elements(fm, fP, pm, pP, F)
            err = max(float((g - w).abs().max()) for g, w in
                      zip(fn(), bs._elements_plain(fm, fP, pm, pP, F)))
            name = str(dtype).split(".")[-1]
            log(f"{root} {'K11' if dx <= 8 else 'K11b'} M={M} dx={dx} F "
                f"{'banked' if banked else 'shared'} {name}: device "
                f"{device_ms(fn, ('',))} ms, event {cuda_time_ms(fn):.5f} "
                f"ms, max abs err {err:.3e} against the plain version")


def bank_times(root: str) -> None:
    """K3 and K4 in float32 and float64 at the mixture paths' banks
    (``BANK_UPDATES``, ``BANK_PREDICTS``) and at the band edge (M = 4,096,
    dx = dy = dq = 8): the device time per call (``device_ms``), the
    CUDA-event time of a loop of calls and the max abs error against the
    plain version on the same inputs; then the walls of the GSF M = 50 and
    the AGSF [50,2,2] on bearings-only tracking (T = 100, float32): the
    median and range of REPS calls after a warm-up. Inputs from ``testing``
    with SEED."""
    import numpy as np
    import torch

    from bayesianfiltering_tpu_torch import _build, testing
    from bayesianfiltering_tpu_torch.ops import bank_update as bu

    _build.load()
    dev = torch.device("cuda", 0)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        rng = np.random.default_rng(SEED)

        def on_card(xs):
            return [torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
                    for x in xs]

        def show(label, fn, plain):
            err = max(float((g - w).abs().max()) for g, w in
                      zip(_as_tuple(fn()), _as_tuple(plain())))
            log(f"{root} {label} {name}: device "
                f"{device_ms(fn, ('bank_',))} ms, event "
                f"{cuda_time_ms(fn):.5f} ms, max abs err {err:.3e} against "
                "the plain version")

        for M, dx, dy in BANK_UPDATES + ((4096, 8, 8),):
            a = on_card(testing.update_inputs(rng, M, dx, dy))
            show(f"K3 M={M} dx={dx} dy={dy}",
                 lambda: bu.bank_chol_update(*a, 0.0),
                 lambda: bu._update_plain(*a, 0.0))
        for M, dx, dq in BANK_PREDICTS + ((4096, 8, 8),):
            a = on_card(testing.predict_inputs(rng, M, dx, dq))
            show(f"K4 M={M} dx={dx} dq={dq}",
                 lambda: bu.bank_predict_cov(*a),
                 lambda: bu._predict_cov_plain(*a))
    for label, comps, T in MIXTURE_RUNS[:2]:
        params, inputs, _, em = bot_problem(T, torch.float32, dev)
        draws = mixture_draws(comps, T, 4, em)
        run = lambda: run_mixture(label, comps, params, inputs, em, draws)
        run()
        secs = [timed(run)[1] for _ in range(REPS)]
        log(f"{root} {label} bot T={T} float32: {spread(secs)}")


def resample_times(root: str) -> None:
    """K5 at path A's n = 1M (int32) at the five weight profiles and at the
    Gaussian-sum reductions' (m, n) (``RESAMPLE_REDUCTIONS``), each checked
    equal to its plain version: the device time per call (``device_ms``)
    and the time per call of a CUDA graph of 100 calls (``graph_ms``),
    beside ``torch.searchsorted`` + clamp on the same counts, the one
    PyTorch call that computes the same function; then, at n = 1M with
    Dirichlet(0.5) weights (float32), the device time of each part of one
    resampling step of path A: the systematic counts (``utils.resampling.
    systematic_counts``: cumsum, ceil, clamp, cummax), the cummax alone,
    ``windowed_parents`` (clamp, int32, K5), the int32 → int64 ``.long()``
    and the particles' gather ``particles[idx]`` (dx = 8); last, path A's
    wall (the BPF at 1M particles, T = 100, float32, the same draws each
    call): the median and range of REPS calls after a warm-up."""
    import numpy as np
    import torch

    from bayesianfiltering_tpu_torch import _build, testing
    from bayesianfiltering_tpu_torch import inference as inf
    from bayesianfiltering_tpu_torch.ops import resample_gather as rg
    from bayesianfiltering_tpu_torch.utils import resampling as rs

    _build.load()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    cases = []
    n = BPF_P
    for profile in testing.PARENT_PROFILES:
        counts = torch.as_tensor(testing.resampling_counts(profile, n, rng),
                                 device=dev)
        cases.append((f"n={n} {profile}", counts, n))
    for m, k in RESAMPLE_REDUCTIONS:
        w = torch.as_tensor(rng.dirichlet(np.full(m, 0.5)), device=dev)
        cases.append((f"m={m} n={k}",
                      rs.systematic_counts(w, k, u=torch.tensor(0.37)), k))
    for label, counts, k in cases:
        c = counts.clamp(0, k).to(torch.int32)
        slots = torch.arange(k, dtype=torch.int32, device=dev)
        fn = lambda: rg._parents_launch(c, k)
        library = lambda: torch.searchsorted(c, slots,
                                             right=True).clamp_max_(
                                                 c.shape[0] - 1)
        got = fn()
        if not (torch.equal(got, rg._parents_plain(c, k))
                and torch.equal(got.long(), library())):
            raise RuntimeError(f"{root} K5 {label}: differs from its plain "
                               "version")
        log(f"{root} K5 {label} int32: device "
            f"{device_ms(fn, KERNEL_SYMBOLS[rg.K5.name])} ms, graph "
            f"{graph_ms(fn):.5f} ms; torch.searchsorted device "
            f"{device_ms(library, ('',))} ms, graph "
            f"{graph_ms(library):.5f} ms; equal to the plain version")
    w = torch.as_tensor(rng.dirichlet(np.full(n, 0.5)), dtype=torch.float32,
                        device=dev)
    u = torch.tensor(0.37, device=dev)
    counts = rs.systematic_counts(w, n, u=u)
    parents = rg.windowed_parents(counts, n)
    idx = parents.long()
    particles = torch.randn(n, BPF_DX, device=dev)
    parts = (("systematic counts", lambda: rs.systematic_counts(w, n, u=u)),
             ("cummax alone", lambda: torch.cummax(counts, 0)),
             ("windowed_parents", lambda: rg.windowed_parents(counts, n)),
             (".long()", lambda: parents.long()),
             ("gather particles[idx]", lambda: particles[idx]))
    for label, fn in parts:
        log(f"{root} resampling step n={n} float32, {label}: device "
            f"{device_ms(fn, ('',))} ms")
    bpf, _, em = bpf_problem(BPF_T, torch.float32, dev)
    gen = torch.Generator(device=dev)
    run = lambda: inf.bootstrap_particle_filter(
        bpf, em, BPF_P, gen.manual_seed(SEED + 7), store="summary")
    run()
    secs = [timed(run)[1] for _ in range(REPS)]
    log(f"{root} bpf lorenz96 P={BPF_P} T={BPF_T} float32: {spread(secs)}")


def ut_times(root: str) -> None:
    """K8 and K9 in float32 and float64 at the batched Lorenz-96 UKF's
    shapes (B = 512: the additive update's 128 rows with R and the
    augmented one's 192 rows of width 96, dx = 64, dy = 32; the predict's
    128 rows with Q and 256 without) and the range-bearing banks' (B = 100,
    12 rows, dx = 4, dy = 2): the device time per call (``device_ms``) and
    the max abs error against the plain version on the same inputs; then
    the walls of the UKF on the Lorenz-96 data (B = 512, T = 1000,
    float32), additive and augmented: the median and range of REPS calls
    after a warm-up. Inputs from ``testing`` with SEED."""
    import numpy as np
    import torch

    from bayesianfiltering_tpu_torch import _build, testing
    from bayesianfiltering_tpu_torch import inference as inf
    from bayesianfiltering_tpu_torch.ops import fused_ut as fu
    from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF, ut_weights

    _build.load()
    dev = torch.device("cuda", 0)
    up = ParamsUKF(1.0, 2.0, 0.0)
    updates = ((EKF_B, 2 * EKF_DX, EKF_DX, EKF_DX, EKF_DY, True),
               (EKF_B, 2 * (EKF_DX + EKF_DY), EKF_DX + EKF_DY, EKF_DX,
                EKF_DY, False),
               (UGSF_M, 12, 6, 4, 2, False))
    predicts = ((EKF_B, 2 * EKF_DX, EKF_DX, True),
                (EKF_B, 4 * EKF_DX, EKF_DX, False), (UGSF_M, 12, 4, False))
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        rng = np.random.default_rng(SEED)

        def on_card(xs):
            return [torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
                    for x in xs]

        def show(label, fn, plain):
            err = max(float((g - w).abs().max()) for g, w in
                      zip(_as_tuple(fn()), _as_tuple(plain())))
            log(f"{root} {label} {name}: device {device_ms(fn, ('ut_',))} "
                f"ms, max abs err {err:.3e} against the plain version")

        for B, rows, ld, dx, dy, add_r in updates:
            w_side, _, w0c = ut_weights(rows // 2, up)[1]
            a = on_card(testing.ut_update_inputs(rng, B, rows, ld, dx, dy))
            show(f"K8 B={B} rows={rows} ld={ld} dx={dx} dy={dy}"
                 f"{' +R' if add_r else ''}",
                 lambda: fu.fused_ut_update(*a, w_side, w0c, add_r),
                 lambda: fu._ut_update_plain(*a, w_side, w0c, add_r))
        for B, rows, dx, add_q in predicts:
            w = ut_weights(rows // 2, up)[1]
            a = on_card(testing.ut_predict_inputs(rng, B, rows, dx))
            show(f"K9 B={B} rows={rows} dx={dx}{' +Q' if add_q else ''}",
                 lambda: fu.fused_ut_predict(*a, *w, add_q),
                 lambda: fu._ut_predict_plain(*a, *w, add_q))
    params, _, emissions = lorenz96_data(dev, torch.float32)
    for additive in (True, False):
        run = lambda: inf.unscented_kalman_filter(params, ukf_params(),
                                                  emissions,
                                                  additive=additive)
        inf.unscented_kalman_filter(params, ukf_params(), emissions[:, :20],
                                    additive=additive)
        secs = [timed(run)[1] for _ in range(REPS)]
        log(f"{root} ukf {'additive' if additive else 'augmented'} "
            f"lorenz96 B={EKF_B} T={EKF_T} float32: {spread(secs)}")


def sigma_times(root: str) -> None:
    """Float32 and float64, the device time per call of K6 (Cholesky and
    Newton–Schulz; Newton–Schulz also at the top of its band, n = 120 and
    128 in float32, 85 and 96 in float64) and K7 (dn = 64 and 32, by both
    methods; also by CUDA events, since its two launches may overlap) at
    the batched Lorenz-96 UKF's shapes, Newton–Schulz with the max abs
    error against the plain version; then at config 5, with the max abs
    error against the
    plain version: the sigma points (K6t, Cholesky) beside
    ``torch.linalg.cholesky_ex`` of the same P, K6t by Newton–Schulz, K7t
    at the augmented widths (dn = 512 in the predict, 256 in the update)
    by Cholesky (also launch by launch, and beside ``cholesky_ex`` of P
    and of C) and by Newton–Schulz, K1t at dy = 256 and 128
    (``update_chunk=128``), K2t (beside the torch.matmul chain of its
    function), K8t and K9t, each also launch by launch (``launch_split``),
    K9t also at negative centre weights (``ParamsUKF(0.5, 2, 0)``'s
    w0m = −3, w0c = −0.25) and at 2,048 rows, dx = 1,024; last,
    config 5's three walls (``ekf512``, its chunked update, ``ukf512``;
    T = 200, float32; the median and range of REPS calls after a warm-up).
    Inputs from ``testing`` with SEED."""
    import numpy as np
    import torch

    from bayesianfiltering_tpu_torch import _build, testing
    from bayesianfiltering_tpu_torch.ops import fused_ekf as fe
    from bayesianfiltering_tpu_torch.ops import fused_ut as fu
    from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF, ut_weights

    _build.load()
    dev = torch.device("cuda", 0)
    up = ParamsUKF(1.0, 2.0, 0.0)
    w_side, _, w0c = ut_weights(C5_DX, up)[1]
    wp = ut_weights(C5_DX, up)[1]
    # non-zero, negative centre weights (w0m = −3, w0c = −0.25)
    wn = ut_weights(C5_DX, ParamsUKF(0.5, 2.0, 0.0))[1]
    we = ut_weights(1024, up)[1]
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        rng = np.random.default_rng(SEED)

        def on_card(xs):
            return [torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
                    for x in xs]

        def show(label, fn, event=False, plain=None):
            line = (f"{root} {label} {name}: device "
                    f"{device_ms(fn, ('',))} ms")
            if event:
                line += f", event {cuda_time_ms(fn):.5f} ms"
            if plain is not None:
                err = max(float((g - w).abs().max()) for g, w in
                          zip(_as_tuple(fn()), _as_tuple(plain())))
                line += f", max abs err {err:.3e} against the plain version"
            log(line)

        m, P = on_card(testing.sigma_inputs(rng, EKF_B, EKF_DX))
        show("K6 B=512 n=64 cholesky",
             lambda: fu.fused_sigma(m, P, 1.0, "cholesky"))
        show("K6 B=512 n=64 sqrtm",
             lambda: fu.fused_sigma(m, P, 1.0, "sqrtm"),
             plain=lambda: fu._sigma_plain(m, P, 1.0, "sqrtm"))
        # Newton–Schulz at the top of K6's band: n = 120 / 85 (K6 in the
        # parent and in a checkout whose band ends at 128 / 96) and
        # 128 / 96 (the kernel each checkout's rule picks)
        for n in ((120, 128) if dtype == torch.float32 else (85, 96)):
            mn, Pn = on_card(testing.sigma_inputs(rng, EKF_B, n))
            show(f"K6 B=512 n={n} sqrtm ("
                 f"{fu.sigma_kernel(n, 'sqrtm', mn.element_size(), _build.smem_optin(dev)).name})",
                 lambda: fu.fused_sigma(mn, Pn, 1.0, "sqrtm"),
                 plain=lambda: fu._sigma_plain(mn, Pn, 1.0, "sqrtm"))
        for dn in (EKF_DX, EKF_DY):
            m, P, b, C = on_card(testing.sigma_aug_inputs(rng, EKF_B, EKF_DX,
                                                          dn))
            for method in ("cholesky", "sqrtm"):
                show(f"K7 B=512 dx=64 dn={dn} {method}",
                     lambda: fu.fused_sigma_aug(m, P, b, C, 1.0, method),
                     event=True,
                     plain=lambda: fu._sigma_aug_plain(m, P, b, C, 1.0,
                                                       method))
        m, P = on_card(testing.sigma_inputs(rng, 1, C5_DX))
        for method in ("cholesky", "sqrtm"):
            show(f"sigma points B=1 n=512 {method}",
                 lambda: fu.fused_sigma(m, P, 1.0, method),
                 plain=lambda: fu._sigma_plain(m, P, 1.0, method))
        show("torch.linalg.cholesky_ex B=1 n=512",
             lambda: torch.linalg.cholesky_ex(P))
        for dn in (C5_DX, C5_DY):
            a = on_card(testing.sigma_aug_inputs(rng, 1, C5_DX, dn))
            for method in ("cholesky", "sqrtm"):
                fn = lambda: fu.fused_sigma_aug(*a, 1.0, method)
                show(f"K7t B=1 dx=512 dn={dn} {method}", fn,
                     plain=lambda: fu._sigma_aug_plain(*a, 1.0, method))
                if method == "cholesky":
                    log(f"{root} K7t dn={dn} launch by launch {name}: "
                        f"{launch_split(fn)}")
            show(f"torch.linalg.cholesky_ex of P and of C B=1 dx=512 "
                 f"dn={dn}", lambda: (torch.linalg.cholesky_ex(a[1]),
                                      torch.linalg.cholesky_ex(a[3])))
        for dy in (C5_DY, C5_CHUNK):
            a = on_card(testing.update_inputs(rng, 1, C5_DX, dy))
            show(f"K1t B=1 dx=512 dy={dy}", lambda: fe.fused_update(*a, 0.0),
                 plain=lambda: fe._update_plain(*a, 0.0))
        a = on_card(testing.predict_inputs(rng, 1, C5_DX, C5_DX))
        show("K2t B=1 dx=dq=512", lambda: fe.fused_predict_cov(*a),
             plain=lambda: fe._predict_plain(*a))
        log(f"{root} K2t launch by launch {name}: "
            f"{launch_split(lambda: fe.fused_predict_cov(*a))}")
        show("torch.matmul chain for K2t's function (a chain of cuBLAS "
             "calls, not one call) B=1 dx=dq=512",
             lambda: predict_chain(*a))
        a = on_card(testing.ut_update_inputs(rng, 1, 2 * C5_DX, C5_DX, C5_DX,
                                             C5_DY))
        show("K8t B=1 rows=1024 dx=512 dy=256",
             lambda: fu.fused_ut_update(*a, w_side, w0c, True),
             plain=lambda: fu._ut_update_plain(*a, w_side, w0c, True))
        log(f"{root} K8t launch by launch {name}: "
            f"{launch_split(lambda: fu.fused_ut_update(*a, w_side, w0c, True))}")
        a = on_card(testing.ut_predict_inputs(rng, 1, 2 * C5_DX, C5_DX))
        show("K9t B=1 rows=1024 dx=512",
             lambda: fu.fused_ut_predict(*a, *wp, True),
             plain=lambda: fu._ut_predict_plain(*a, *wp, True))
        log(f"{root} K9t launch by launch {name}: "
            f"{launch_split(lambda: fu.fused_ut_predict(*a, *wp, True))}")
        show(f"K9t B=1 rows=1024 dx=512 w0m={wn[1]:g} w0c={wn[2]:g}",
             lambda: fu.fused_ut_predict(*a, *wn, True),
             plain=lambda: fu._ut_predict_plain(*a, *wn, True))
        a = on_card(testing.ut_predict_inputs(rng, 1, 2048, 1024))
        show("K9t B=1 rows=2048 dx=1024",
             lambda: fu.fused_ut_predict(*a, *we, True),
             plain=lambda: fu._ut_predict_plain(*a, *we, True))
    params, _, em = config5_data(C5_T, torch.float32, dev)
    for label, run, _ in config5_runs():
        run(params, em[:20])  # warm-up
        secs = [timed(lambda: run(params, em))[1] for _ in range(REPS)]
        log(f"{root} {label} lorenz96 dx={C5_DX} dy={C5_DY} B=1 T={C5_T} "
            f"float32: {spread(secs)}")


def launch_split(fn, calls: int = 5) -> str:
    """Each CUDA launch of one call of ``fn``, in launch order, with its
    device ms (the median over ``calls`` calls traced back to back by
    torch.profiler), and their sum; or what the profiler recorded, where
    it dropped records (a count that is not a multiple of the calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type != DeviceType.CPU),
                    key=lambda e: e.time_range.start)
    names = [re.search(r"(\w+_kernel)", e.name) for e in events]
    names = [n[1] if n else e.name[:40] for n, e in zip(names, events)]
    if not events or len(events) % calls:
        return f"{len(events)} launches recorded over {calls} calls"
    per = len(events) // calls
    ms = [sorted(events[c * per + i].time_range.elapsed_us() / 1e3
                 for c in range(calls))[calls // 2] for i in range(per)]
    return (", ".join(f"{n} {m:.4f}" for n, m in zip(names[:per], ms))
            + f"; sum {sum(ms):.4f} ms over {per} launches")


def ab(parent: str, parts=AB_PARTS) -> int:
    """``--ab PARENT_ROOT [PART ...]``: the card's name and power limit,
    then ``ab_times`` of the parent checkout and of this one in turns
    (parent, change, change, parent), each in a process of its own."""
    log(nvidia_smi())
    rc = 0
    for root in (parent, str(ROOT), str(ROOT), parent):
        rc |= subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--ab-times", root, *parts]).returncode
    return rc


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
    if len(sys.argv) >= 3 and sys.argv[1] in ("--ab", "--ab-times"):
        parts = tuple(sys.argv[3:]) or AB_PARTS
        if any(part not in AB_PARTS for part in parts):
            print(f"chip_smoke: the parts of --ab are {', '.join(AB_PARTS)}",
                  file=sys.stderr)
            return 2
        if sys.argv[1] == "--ab":
            return ab(sys.argv[2], parts)
        ab_times(sys.argv[2], parts)
        return 0
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
        found = re.search(r"([a-z_]+_kernel)I([fd])((?:Li\d+E)*)", line)
        if "Compiling entry function" in line and found:
            ints = re.findall(r"Li(\d+)E", found[3])
            entry = (f"{found[1]}<{'float' if found[2] == 'f' else 'double'}"
                     + "".join(f",{i}" for i in ints) + ">")
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {entry}: {line.strip()}")

    t0 = time.perf_counter()
    timing = check_kernels(dev)
    log(f"phase 3 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    jobs = start_parallel_jobs(dev)
    compare_paths(dev)
    compare_legacy(dev)
    compare_parallel(dev, jobs)
    log(f"phase 4 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = main_path(dev, card)
    log(f"phase 5 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    profile_ukf(dev, card)
    log(f"phase 6 took {time.perf_counter() - t0:.1f} s")

    kernels = []
    order = list(KERNEL_IDS)
    for k in sorted(_build.KERNELS, key=lambda k: order.index(k.name)):
        t = timing[k.name]
        lib = t.get("library_ms")
        log(f"{KERNEL_IDS[k.name]} {k.name}: {t['ms']:.4f} ms (device "
            f"{t['device_ms']} ms), plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.3g} ms "
            f"({t['bound_by']}), bound share {t['bound_share']:.3g}, library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}, launches "
            f"{counts[k.name]} ({card})")
        kernels.append({"name": k.name, "id": KERNEL_IDS[k.name],
                        "route": "cuda", "source": k.source,
                        "replaces": k.replaces, "launches": counts[k.name],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": lib,
                        "library_call": t.get("library_call"),
                        "bound_share": t["bound_share"],
                        "device_ms": t["device_ms"],
                        "device_bound_share": t["device_bound_share"],
                        "shape": t["shape"], "also": t.get("also", []),
                        **{key: t[key] for key in ("graph_ms",
                                                   "library_graph_ms",
                                                   "library_device_ms",
                                                   "library_chain_ms",
                                                   "library_chain")
                           if key in t}})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
