"""Smoke run of the PyTorch port (klara_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                # phases 1-27
    python3 chip_smoke.py --keyed-only   # phases 1-3 and 27 (kernel K2, keyed draws)
    python3 chip_smoke.py --parallel-only  # phases 1-4 and 25-26 (meshes)
    python3 chip_smoke.py --zoo-only     # phases 1-4 and 12-20 (the sampler zoo)
    python3 chip_smoke.py --io-only      # phases 1-4 and 21-23 (the output layer)
    python3 chip_smoke.py --examples-only  # phases 1-3 and 24 (seven examples)
    python3 chip_smoke.py --graphs-only  # phases 1-6, 9, 10, 28 and 30 (the captured loops)
    python3 chip_smoke.py --profile DIR  # also profile stage 2 of both logreg rows and the Gibbs sweep
    python3 chip_smoke.py --stage1-sensitivity  # only: stage 1 with K1 and with the plain version, three seeds
    python3 chip_smoke.py --tracing-only  # phases 1-3 and 29 (the tracer's cost)
    python3 chip_smoke.py --lgcp-only    # phases 1-3 and 30 (the LGCP, D = 4096; K1's wide form)

Phases, each of which raises on failure (the script then exits non-zero):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels from ``klara_tpu_torch/ops/csrc``
   (K1 and K2, one nvcc each, started together);
3. compare kernel K1 (batched logreg value+grad, three TF32 passes) with its
   plain PyTorch version on the card, TF32 off, at C=5/D=7/N=300, at the
   ragged C=200/D=100/N=1000 (every tile edge of the kernel), at C=4096 and
   at the main path's C=16384/D=100/N=1024, and time it at the last two
   (CUDA events, 50 calls after warm-up) beside the plain version; time the
   single-pass form (``passes=1``, used by no path) at the main shape and
   hold it to a TF32 tolerance; hold K1 to the absolute tolerances against
   the plain version in float64 at 16384 positions around the posterior mode;
4. run the main path, ``MCJob.run_preconditioned`` with the chees_precond
   settings of bench.py, at 16384 chains on the 100-dim synthetic logistic
   regression (1024 rows), 300 burnin and 2000 post draws, bf16 trace;
   check that K1 was launched, every draw is finite, the chunked rank-R̂
   max is at most 1.02, pooled acceptance lies in [0.6, 0.95] and K1
   agrees with its plain version on the final positions; print
   the phase times, min ESS, ESS/s, leaps per draw, stage 1's adapted step
   and trajectory length and the K1 launches of each stage, and hold the
   launch counts to the anchored ones (``K1_LAUNCHES_BEFORE``, on the keyed
   streams every MCJob draw takes); stage 2 samples in captured blocks
   (``klara_tpu_torch/jobs/graphs.py``: a step replays its start, one
   leapfrog step n_max times and its end), and the graphs replayed must be
   more than 0;
5. run nuts_precond at the same size: the same stage 1, stage 2 whitened
   NUTS(max_doublings=3) (bench.py's settings); check finiteness, R̂,
   that stage 2 launched K1 exactly 7 times per step plus once at init,
   K1 against its plain version on the final positions, and that the
   posterior means agree with chees_precond's within 5 combined standard
   errors; stage 2 samples in captured blocks of static NUTS steps (graph
   replays more than 0);
6. run 5 static-tree NUTS steps of the whitened target under
   ``torch.cuda.set_sync_debug_mode("error")``: the step reads nothing back;
7. run the looped tree (4096 chains from phase 5's final positions, 300
   burnin + 1000 post); check R̂, that its mean tree size is within 10%
   of phase 5's and K1 against its plain version on its final positions;
   run both tree forms on the same draws from its final state (they must
   agree exactly); time both forms from that state;
8. run raw NUTS(max_doublings=5) at 4096 chains on the raw target, 300
   burnin + 2400 post at thinning 2 (bench.py's nuts row); check R̂ and K1
   against its plain version on its final positions; run both tree forms
   on the same draws from its final state, where trees stop inside their
   last subtree, so the looped form's checkpoint slots decide outcomes;
9. run bench.py's rats Gibbs row: ``GibbsJob`` on the conjugate rats model
   at 4096 chains, 30000 sweeps (500 burnin), the five hyperparameters
   monitored, after a short warm-up run, every conditional drawn by K2 (the
   keyed stream), the sweeps in captured blocks (graph replays more than
   0); check that every carried value and trace lives on the
   card, every draw is finite, rank-R̂ max ≤ 1.02 and the posterior means of
   alpha_c and beta_c match the published BUGS values; print seconds,
   sweeps/s, chain-sweeps/s, min ESS, ESS per draw, ESS/s and K2's launches
   per sweep, and, after phase 10, the device kernels and time per sweep of
   ``GIBBS_PROFILE_SWEEPS`` profiled sweeps and the host time of a sweep's
   K2 draws over as many more;
10. run 5 conjugate sweeps (K2 draws) from phase 9's final values under
   ``torch.cuda.set_sync_debug_mode("error")``: the sweep reads nothing back;
11. run the rats model with ``alpha`` as a nested HMC block on its
   conditional (``rats_gibbs_model(nested_alpha=True)``: MCMC-within-Gibbs
   with the settings of benchmarks/gibbs_hoist_probe.py; every other block
   is phase 9's) at 4096 chains, 2000 sweeps (200
   burnin): the hoisted step-size search, per-chain ε through ``init_tune``
   and the nested dual-averaging tuner on the card; check R̂, the nested
   acceptance, that the posterior means of alpha_c and beta_c agree with
   phase 9's within 5 combined standard errors, and those of alpha_c,
   beta_c and sigma2_c with the JAX package's for the same settings
   (``JAX_NESTED``);
12-18. run the sampler zoo (``zoo_logreg``) on the same 100-dim target through
   ``MCJob.run_phased`` at 4096 chains from phase 4's final positions in x
   space, which are stationary draws: MALA under pooled dual averaging at
   0.574 (12; again at 16384 chains, 13), RAM (14), AM (15), AMWG (16), the
   slice sampler (17) and SMMALA with autograd's Hessian (18), with the step
   counts of ``ZOO_STEPS``.  Every run must keep phase 4's posterior: each
   posterior mean within 5 combined standard errors (the run's taken across
   its chains' means), each sd within 5 standard errors, rank-R̂ between the
   ensemble's distributions at the saved times at most 1.02; and land its
   rate: MALA 0.574 ± 0.05, RAM 0.234 ± 0.05, AMWG's mean per-coordinate
   rate 0.44 ± 0.1, AM above 0.05, slice above 0.99.  MALA must launch K1
   once a step and once at init; K1 is held against its plain version on
   MALA's and SMMALA's final positions.  Each prints ms per step, K1
   launches, host reads per step (counted under sync debug mode "warn"; the
   slice sampler's own count per sweep too), acceptance, and the split-chain
   rank-R̂ and min ESS, which say how far the chains mixed and are not gated:
   the raw posterior's covariance has a condition number of ~600, which no
   sampler of the zoo but SMMALA sees through;
19. run ARS on the 100-dim normal under the envelope N(0, 2²·I): the accepted
   share must equal the mean acceptance probability and the carried
   log-target the target's;
20. record all 13 monitored slots on the swiss target (D=4, 64 chains, 50
   draws, MALA): shapes, finiteness, and target = likelihood + prior for the
   log-density, gradient, tensor and dtensor slots;
21. stream MALA on the bench target to CSV: 4096 chains from phase 4's final
   positions, pooled dual averaging at 0.574, 100 burnin + 64 draws,
   ``destination="csv"``, ``stream_chunk=16``, into a temporary directory
   (removed at the end), beside its ``destination="nstate"`` twin from the
   same generator seed.  The directory read back by ``kt.io.read_chain``
   must equal the twin's trace and the final states must agree, bit for bit;
   the stream must add one host read per chunk that saved a draw (counted
   under sync debug mode "warn") and keep its ring on the card; K1 launches
   once a step and once at init and holds against its plain version on the
   final positions.  A 50-step run with ``verbose=True, progress_period=25``
   prints two progress lines and adds two host reads; with ``verbose=False``
   it reads no more than the twin.  10 steps under ``trace_profile`` must
   leave a Chrome trace with K1 in it.  Prints the seconds of both runs, the
   MB written, the writer's MB/s and the time of the device→host copies;
22. checkpoint the twin's final state and generator (``kt.io.save_checkpoint``),
   resume once with the live generator, load the file into fresh card
   tensors and a fresh card generator and resume again: both resumes must
   agree bit for bit, the tuner state must survive the file, and K1 must
   launch once a step in each; prints the file's MB and the seconds to save
   and to load;
23. run the conjugate rats model (``GibbsJob``, 4096 chains, 500 sweeps, 100
   burnin) with ``alpha_c`` and ``sigma2_c`` streamed to CSV
   (``stream_chunk=128``) and the other three monitored variables in device
   traces, then ``resume``, beside an all-nstate twin of the same seed: the
   csv variables read back (two appended segments) and the nstate ones must
   equal the twin's, the stream must add one host read per chunk, and K1
   must not launch;
24. run seven examples of the port's registry (``examples_torch/
   run_examples.py``) at the JAX package's sizes: ``poisson_mh``,
   ``gamma_mh_truncation``, ``t_slice``, ``swiss_mala_analytical``,
   ``swiss_hmc_analytical``, ``bivariate_normal_gibbs`` and ``rats_gibbs``.
   Those that assert nothing of their own are held to the truth: the
   Poisson mean 6 and the Gamma(2, 1) mean and variance (both correction
   styles) within 5 MCSE, the int32 trace on its support, the bivariate
   correlation 0.8 ± 0.05 and means 0 within 5 MCSE, the BUGS rats means.
   The two swiss rows launch K1 at C=64, D=4, N=200; K1 is held against its
   plain version on their final positions and timed there (CUDA events)
   beside its plain version, its bound and the launch floor (one
   elementwise op on one value);
25. run the main path of phase 4 again on ``chain_mesh()``, a one-rank NCCL
   chains mesh of this process's own: hold its final positions, final step
   size, stage 1's adapted step and trajectory length, the Cholesky factor
   and the bf16 trace's bit sums per draw to phase 4's bit for bit, and its
   K1 launches to phase 4's; count the NCCL all-reduces of its adaptation
   (``parallel.mesh.COLLECTIVES``); run 5 static NUTS steps with pooled
   dual averaging through the meshed job's loop under
   ``torch.cuda.set_sync_debug_mode("error")`` (2 all-reduces a step, no
   host read); run ``examples_torch/multichip_scaling.py`` at its width
   (16384 chains, NUTS(max_doublings=6), pooled dual averaging; depth
   ``MULTICHIP_BURNIN`` + ``MULTICHIP_POST``) and print its draws/s and
   min ESS; destroy the group;
26. spawn two processes of this script (``--rank-worker``) on cuda:0 joined
   by gloo (NCCL refuses two ranks on one card): MALA on the bench target
   at 4096 chains, 2048 a rank, the conjugate rats ``GibbsJob`` at 4096
   chains x 500 sweeps and MH with a LogNormal proposal distribution (K2
   draws) on a 100-dim Gamma(2, 1) product at 4096 chains x 200 steps, each
   held bit for bit to this process's run of the same seed without a mesh;
   the MALA, rats and MH runs carry 2048 chains a rank and issue no
   collective but the run's generator check (``parallel.mesh.COLLECTIVES``:
   0 in the sweeps and steps); MALA streamed to csv by MCJob (16 draws of
   4096 x 100 in chunks of 5) and the rats model's two csv variables, their
   files written by rank 0 from the gathered chunks and held byte for byte
   to this process's (``P26_CSV_*``); ``param_sharded_logreg_target`` on
   ``mesh2d(1, 2)`` at 4096 x 100 x 1024 held to K1 on the full X (phase-3
   tolerances) and run under HMC with per-chain leap counts (50 + 100
   steps; acceptance above 0.3, both ranks' ``stats.mean`` and
   ``stats.acceptance`` equal), then ``run_phased`` with shared jitter on
   it (20 + 20 steps), which must capture no graph (the target runs
   collectives, so sampling stays eager); time K1 at 8192 chains, a rank's share of
   the main path on two ranks.  Both processes are stopped before the phase
   ends;
27. hold K2 (``klara_tpu_torch/ops/csrc/keyed_draws.cu``, per-chain keyed
   draws) to its plain version on the card with the same keys and counters
   in every mode and both types, at 4096 x 30 and at 16384 x 100, where
   each thread strides over several elements, on the parameter grid and at
   the timed parameters (``K2_*`` tolerances: uniforms bit for bit,
   the f64 ones holding 53 bits of Philox words 0-1, normals within a few
   ulp, gamma, Poisson and binomial on the same attempt but for a stated
   share, and there within a relative tolerance or equal), gamma also at
   the rats sweep's scalar shape parameters 15.001 and 75.001 (4096 x 1),
   the means and variances of 10^6 kernel draws per grid point to the exact
   ones within 5 standard errors, the overflow counter to 0; read each
   (mode, type) kernel's registers and blocks an SM; count one Philox
   call's SASS instructions by pipe and each mode's cheap and slow tests'
   floating-point instructions on their shortest path (``cuobjdump`` of a
   probe built from K2's source); time every mode at the rats shapes and at
   16384 x 100 (ms over 50 launches, host µs and device µs a launch) beside
   torch's own call, its plain version and its bound (the Philox calls,
   cheap tests and slow tests this run's elements made), and the uniforms
   MCJob draws at 16384 chains (``K2_JOB_SHAPES``: the accept uniform, NUTS's
   (C, 14) step uniforms), compared bit for bit and timed alike;
28. (run after phase 10) run each captured path twice from one state and
   one run key, in captured blocks (``jobs/graphs.py``) and in the eager
   loop: 200 stage-2 steps of chees_precond (phase 4's job and final state)
   and of nuts_precond (phase 5's), and 500 conjugate rats sweeps from phase
   9's final values; and 60 warmup steps of chees_precond's stage 1 from
   its init (pooled dual averaging, mass, ChEES from step 30, the shared
   jitter), its transitions replayed as units (``graphs.warm``) and in the
   eager loop, the hooks keeping references to what they are handed and
   return, read after both runs.  Traces (for the warmup, the kept tensors
   of every step), final states and the K1 and K2 launch counts must be
   equal, bit for bit, and each graph form must replay a graph.
   Prints, both ways, ms a step or sweep (host clock to a synchronise), the
   graph form's steady block time (CUDA events at the block ends, the
   median block after the first two), the graphs captured and replayed, the
   launches the replays added, the peak of allocated memory, and a profiled
   window's kernels and device time a step; the idle shares are the eager
   window's device time over each form's wall time;
29. (``--tracing-only``) the tracer's cost (``klara_tpu_torch/utils/tracing.py``):
   phase 4's chees_precond job and phase 9's rats job at their sizes, each
   run twelve times in turns from one seed with span recording off, on, on,
   off, three rounds (``tracing.recording()``); prints each run's wall, each
   neighbouring off/on pair's ratio and their median, its job report's
   phases and the spans it recorded, and raises unless a run with recording
   off leaves no span, each run leaves one job report, and every span of a
   recorded run lies inside its job's report window; then each job eight
   times under ``torch.profiler`` (CUDA activity, as the benchmark's traced
   job), the tracer's spans off, on, on, off, two rounds: what the spans and
   their ``record_function`` cost a profiled job.
30. (run after phase 28) the log-Gaussian Cox process on a 64 × 64 grid
   (``models.lgcp``, D = 4096, 1024 chains): ``MCJob.run_phased`` with the
   benchmark cell's ChEES settings, 60 warmup and 60 sampling steps, run
   twice from one start and run key, once with warmup and sampling in
   graph units and once in the eager loop; raises unless both give the same
   final state, trace and diagnostics bit for bit and the same evaluation
   (``core.target.FACTOR_EVALUATIONS``, replay-aware) and K2 counts, and unless
   the graph run replayed units; prints both walls and the graph run's
   evaluations.  Then logistic regressions wider than K1's 128-column tile
   (D = 129 and 200, N = 1000, 250 chains: ragged chains, rows, chunks and
   column tiles) build on the card, launch K1's wide form once an
   evaluation, and meet float64's value+grad within ``WIDE_LOGREG_TOL``
   (``passes=1``, TF32 operands, within ``WIDE_TF32_TOL``).

The Gibbs paths launch no K1 (their sweep is plain torch ops in both
packages); the kernels line records their K1 count, 0.  K2 makes every draw
of every path (MCJob's momentum, proposals, accept uniforms, jitter, NUTS's
uniforms and init draws; the Gibbs conditionals): the kernels line lists its
launches on each path, each counted from 0 just before the path's run and
required above 0.  The output layer
adds no kernel: phases 21-22 launch K1 on new paths (``io_stream_mala``,
``io_resume_mala``) and phase 23 launches none (``io_gibbs_csv``).

With ``--profile DIR``, 200 stage-2 steps of phase 4's sampler are
profiled after phase 4 (``profile_chees``; DIR/profile_chees.json), 200
stage-2 steps of phase 5's sampler after phase 6 (``profile_nuts``; DIR/profile_nuts.json) and 200
conjugate rats sweeps after phase 10 (``profile_gibbs``;
DIR/profile_gibbs.json).

With ``--stage1-sensitivity`` phases 1-3 run and then stage 1 alone (ChEES
HMC, 300 adapting steps at 16384 chains) five times: with K1 and with the
plain version as the target's value+grad, at generator seeds 42 and 43, and
with K1 at seed 44.  Each run prints its value+grad evaluations, adapted
step and trajectory length: how far the evaluation count moves with the
rounding of the value+grad alone and with the draws (``STAGE1_ALLOWANCE``).

The last three lines of stdout are the kernels' JSON summary, the card
line and the device JSON line.  The plain versions' matmuls run in full f32
(TF32 off); K1's three TF32 passes are f32-grade and meet the same
tolerances.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# phase-3 tolerances: the kernel and cuBLAS sum in different orders
VALUE_RTOL, VALUE_ATOL = 1e-5, 1e-3
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3
# one TF32 pass keeps 11 bits of each operand: about three decimal digits of
# a sum whose terms do not cancel, more where they do
TF32_VALUE_RTOL, TF32_GRAD_RTOL, TF32_GRAD_ATOL = 1e-3, 1e-2, 0.5
TF32_PEAK_FLOPS, HBM_BYTES_PER_S = 495e12, 3.35e12  # H100 SXM, dense TF32; HBM3
# K2's bound: the SASS instructions of one Philox4x32-10 call as nvcc compiles K2's
# ``philox`` (``k2_sass``), issued at the H100 SXM's rates per SM and clock: 64
# lanes of the FMA pipe (IMAD), 64 of the ALU pipe (LOP3, IADD3, SHF, ...), 128 issues
# (4 schedulers x 32 lanes) for every instruction; 132 SMs x 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ISSUE_PER_S = 132 * 128 * 1.98e9
# K2's transforms (``k2_sass``): the FP32 arithmetic at 128 lanes an SM, the FP64
# arithmetic at 64, the MUFU transcendentals at 16 (NVIDIA's throughput table for
# compute capability 9.0); compares, conversions and moves are left out, so the bound
# stays a floor
SASS_FP_PIPES = {"fp32": ("FFMA", "FMUL", "FADD"), "fp64": ("DFMA", "DADD", "DMUL"),
                 "mufu": ("MUFU",)}
SASS_FP_RATES = {"fp32": 132 * 128 * 1.98e9, "fp64": 132 * 64 * 1.98e9,
                 "mufu": 132 * 16 * 1.98e9}
SASS_FMA_PIPE = ("IMAD", "IMUL")
SASS_ALU_PIPE = ("LOP3", "LOP", "IADD3", "IADD", "SHF", "SHL", "SHR", "LEA", "ISETP", "SEL",
                 "PRMT", "MOV", "IMNMX", "IABS", "PLOP3", "SGXT", "BMSK")
RHAT_GATE = 1.02  # bench.py's mixing gate
# K1 launches of the same paths on the keyed streams every MCJob draw takes
# (same seeds, sizes and settings; an NVIDIA H100 80GB HBM3 at 700 W, with K1's
# wgmma design).  Stage 1 is the ChEES warmup that chees_precond and
# nuts_precond share.  Stage 2 of nuts_precond is held exactly (7 leaves a
# step); the other counts follow an adapted step size or trajectory length,
# which a change of the kernel's rounding or of the draws may move.
K1_LAUNCHES_BEFORE = {"stage1": 23436, "chees_stage2": 11581, "nuts_looped": 9095, "nuts": 83707}
LAUNCH_ALLOWANCE = 0.03
# Stage 1 adapts the trajectory length by Adam steps on a noisy ensemble
# estimate, so its count follows the value+grad's last bits and, far more,
# the draws.  ``--stage1-sensitivity`` on an NVIDIA H100 80GB HBM3 at 700 W
# (torch's generator draws): 29,441 evaluations with K1 and 29,406 with the
# plain version at seed 42 (30,926 with K1's earlier design: three roundings,
# 5% apart, adapted trajectory lengths 16.3 and 16.9), 19,532 and 19,357 at
# seed 43 (trajectory lengths 9.5 and 12.4), 24,346 with K1 at seed 44.
STAGE1_ALLOWANCE = 0.08
ACCEPT_RANGE = (0.6, 0.95)

DIM, N_DATA, CHAINS, BURNIN, POST = 100, 1024, 16384, 300, 2000
MEAN_Z_GATE = 5.0      # |Δ posterior mean| in combined standard errors
SMALL_CHAINS, LOOPED_POST, RAW_POST = 4096, 1000, 2400
# bench.py's gibbs row (GIBBS_CHAINS, GIBBS_STEPS, GIBBS_BURNIN)
GIBBS_CHAINS, GIBBS_SWEEPS, GIBBS_BURNIN, GIBBS_WARM = 4096, 30000, 500, 1000
GIBBS_MONITOR = ("alpha_c", "beta_c", "sigma2_c", "sigma2_a", "sigma2_b")
GIBBS_PROFILE_SWEEPS = 50  # phase 9's profiled window (kernels per sweep)
# phase 28: the windows each path runs twice (captured blocks, eager loop), and
# the profiled windows beside them (the first block of each is eager)
GRAPH_WINDOW_STEPS, GRAPH_WINDOW_SWEEPS = 200, 500
# phase 30: the LGCP's grid, chains and steps; the wide logregs' tolerances
# (relative to the largest |value| and |gradient| entry: f32 sums over
# N = 1000 rows and D columns against float64; with TF32 operands three
# decimal digits)
LGCP_GRID, LGCP_CHAINS, LGCP_BURNIN, LGCP_POST = 64, 1024, 60, 60
WIDE_LOGREG_TOL, WIDE_TF32_TOL = 1e-5, 1e-2
WIDE_TIMED = (16384, 256, 1024)  # K1's wide form timed at (C, D, N)
GRAPH_PROFILE_STEPS, GRAPH_PROFILE_SWEEPS = 60, 300
GRAPH_WARMUP_STEPS, GRAPH_WARMUP_PROFILE_STEPS = 60, 20  # stage 1's warmup, both forms
# published BUGS posterior means of the rats example, with the gate's width
BUGS_MEANS = {"alpha_c": (242.5, 1.0), "beta_c": (6.19, 0.1)}
NESTED_SWEEPS, NESTED_BURNIN = 2000, 200
NESTED_ACCEPT_RANGE = (0.2, 0.99)
# The nested block's dual averaging restarts every sweep and adapts in all 4
# of its steps, so the sweep is not exactly invariant: it moves sigma2_c's
# stationary mean up by ~0.4% in both packages.  Phase 11 holds alpha_c and
# beta_c to the conjugate posterior (phase 9) and all three to the JAX
# package's run of this model and these settings (posterior mean, MCSE; 4096
# chains x 2000 sweeps, 200 burnin), which
# ``PYTHONPATH=. python tests/test_torch_gibbs_nested.py`` prints; that
# file's test holds the two packages' nested runs together at 128 chains.
JAX_NESTED = {"alpha_c": (242.65524, 0.00112), "beta_c": (6.185698, 0.0000507),
              "sigma2_c": (37.44109, 0.00411)}
# the sampler zoo on the bench target (phases 12-20): 4096 chains from phase 4's
# final positions; steps per sampler, set so that the whole script stays inside
# its time limit (PERF.md section 4 states each count)
ZOO_CHAINS, MALA_RATE, ARS_STEPS = 4096, 0.574, 500
# Haario's AM feeds the chain's current point into its proposal covariance, so at a
# finite count k the kernel is not reversible and the ensemble contracts by O(D/k): in
# both packages alike (tests/test_torch_zoo_dist.py pins it on a 20-dim normal from exact
# draws: sds 0.86-0.88 of the truth at k in 100..700).  AM's sd gate is this wide;
# every other sampler's is 5 standard errors (5.5% at 4096 chains).
AM_SD_GATE = 0.15
ZOO_STEPS = {
    "mala": dict(burnin=500, post=2000),
    "mala_16384": dict(burnin=500, post=2000, thinning=2),
    "ram": dict(burnin=1500, post=1500, thinning=2),
    "am": dict(burnin=500, post=1500, thinning=2),
    "amwg": dict(burnin=100, post=200),
    "slice": dict(burnin=5, post=30),
    "smmala": dict(burnin=100, post=150),
}
# static vs looped tree on the same draws: positions and discrete outcomes
# exact; `a` sums up to 31 f32 terms in another order
TREE_STEPS, A_RTOL = 10, 1e-5
# the output layer (phases 21-23): MALA at the zoo's width with a short csv run
# (64 draws of 4096 x 100 values: ~26M values, ~340 MB of CSV), and the rats row
# cut from 30000 sweeps to 500
IO_BURNIN, IO_POST, IO_CHUNK, IO_SEED = 100, 64, 16, 11
IO_VERBOSE_STEPS, IO_PERIOD = 50, 25
IO_GIBBS_SWEEPS, IO_GIBBS_BURNIN, IO_GIBBS_CHUNK = 500, 100, 128
IO_GIBBS_CSV = ("alpha_c", "sigma2_c")
# phase 24: seven examples of the port's registry at the JAX package's sizes (168-286 s on
# the H100, gamma_mh_truncation 117-201 s of it: 2 x 20000 MH steps of ~165-270 host-issued ops);
# the two swiss rows launch K1 at C=64, D=4, N=200
SMOKE_EXAMPLES = ("poisson_mh", "gamma_mh_truncation", "t_slice", "swiss_mala_analytical",
                  "swiss_hmc_analytical", "bivariate_normal_gibbs", "rats_gibbs")
K1_EXAMPLES = ("swiss_mala_analytical", "swiss_hmc_analytical")
POISSON_LAM, GAMMA_MOMENTS, BIV_RHO, BIV_RHO_WIDTH = 6.0, (2.0, 2.0), 0.8, 0.05
# phase 25: examples_torch/multichip_scaling.py at its full width (16384 chains,
# NUTS(max_doublings=6)), depth cut from 200 + 300 steps to 50 + 100
MULTICHIP_BURNIN, MULTICHIP_POST = 50, 100
# phase 26: two ranks on one card.  MALA on the bench target (fixed step, no
# tuning), the conjugate rats model (phase 23's depth), and HMC with per-chain
# leap counts (trajectory length jittered per chain) on the param-sharded target
P26_CHAINS, P26_MALA_STEP, P26_BURNIN, P26_POST = 4096, 0.005, 50, 100
P26_SWEEPS = IO_GIBBS_SWEEPS
P26_HMC_LAMBDA, P26_HMC_BURNIN, P26_HMC_POST = 0.05, 50, 100
P26_PHASED_STEPS = 20  # run_phased's burnin and sampling steps on the param-sharded target
P26_TIMEOUT = 600
P26_MH_STEPS = 200
# the two-rank csv check: MALA on the bench target streamed to csv (16 draws of
# 4096 x 100 in chunks of 5, ~80 MB) and the rats model's IO_GIBBS_CSV variables
# (200 sweeps), the files held byte for byte to one process's
P26_CSV_BURNIN, P26_CSV_POST, P26_CSV_CHUNK, P26_CSV_SWEEPS = 24, 16, 5, 200
# phase 27: K2 (keyed draws) against its plain version at the rats blocks' widest
# per-chain draw, 4096 chains x 30, and at 16384 x 100; moments of 10^6 draws a point on the grid below;
# times at the rats shapes (4096 chains x 1 and x 30 elements) and 16384 x 100, with
# the parameters each mode is timed at: the rats InverseGamma conditionals' shape
# parameter (1e-3 + 15), Poisson by PTRS, binomial by BTRS.  The rats sweep's three
# gamma launches pass their shape as a Python number (the kernel's scalar branch):
# a0 + 30/2 and a0 + 30 * 5/2 (a0 = 1e-3), compared at 4096 x 1 as the sweep draws them
K2_COMPARE_SHAPE, K2_MOMENT_SHAPE = (4096, 30), (1000, 1000)
K2_RATS_GAMMA_SHAPE, K2_RATS_ALPHAS = (4096, 1), (15.001, 75.001)
K2_TIME_SHAPES = {"c4096_e1": (4096, 1), "c4096_e30": (4096, 30), "c16384_e100": (16384, 100)}
K2_TIME_PARAMS = {"uniform": (), "normal": (), "gamma": (15.001,), "poisson": (30.0,),
                  "binomial": (100.0, 0.3)}
# the uniforms MCJob draws on the main paths at 16384 chains (each also compared bit for
# bit): the accept uniform, one a chain, and NUTS(max_doublings=3)'s step uniforms, one
# (C, 2J + 2^J) draw; the momentum's 16384 x 100 normals are c16384_e100 above
K2_JOB_SHAPES = {"uniform": {"c16384_e1": (16384, 1), "nuts_c16384_e14": (16384, 14)}}
K2_ALPHAS, K2_LAMBDAS = (1e-3, 0.3, 1.0, 7.5, 1e4), (0.5, 9.9, 10.0, 1e3)
K2_BINOMIALS = tuple((n, p) for n in (1, 20, 1000) for p in (0.01, 0.5, 0.99))
# K2 against its plain version on the same key and counters: uniforms bit for bit (the
# f64 uniform carries 53 bits of Philox words 0-1, the f64 normal words 0-3); normals within K2_NORMAL_ULP units in the last place (the kernel's
# logf/cosf and torch's CUDA log/cos may round apart); gamma, Poisson and binomial
# accepted on the same attempt in all but K2_OTHER_ATTEMPT_SHARE of the elements (an
# ulp can flip an accept near its boundary), there gamma within K2_GAMMA_RTOL and
# Poisson and binomial equal
K2_NORMAL_ULP, K2_OTHER_ATTEMPT_SHARE, K2_MOMENT_Z = 4.0, 1e-4, 5.0
K2_TIMES_TIMEOUT = 600  # seconds for phase 27's timing process (~20 s on an H100)
K2_GAMMA_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _time_ms(fn, iters=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _k1_error(P, X, y, prior_var=100.0):
    """K1 against its plain version on the same card inputs (phase-3
    tolerances); returns the max abs error."""
    from klara_tpu_torch.ops import logreg

    v = (X.T @ y).contiguous()
    prep = logreg.prepare_x(X, y)
    val, grad = logreg.logreg_value_grad(P, X, v, prior_var, prepared=prep)
    rval, rgrad = logreg.logreg_value_grad_reference(P, X, v, prior_var)
    torch.cuda.synchronize()
    torch.testing.assert_close(val, rval, rtol=VALUE_RTOL, atol=VALUE_ATOL)
    torch.testing.assert_close(grad, rgrad, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    return max(float((val - rval).abs().max()), float((grad - rgrad).abs().max()))


def k1_bound_ms(C, D, N, passes=3):
    """The least time the card could take for one K1 evaluation, and which
    of the two limits sets it: ``passes`` TF32 passes over the two products
    of 2·C·N·D operations each at the dense TF32 peak, or the compulsory
    traffic (P in, gradient and value out, X and v in, 4 bytes each) at the
    memory rate."""
    ops_ms = 1e3 * passes * 2 * (2 * C * N * D) / TF32_PEAK_FLOPS
    bytes_ms = 1e3 * 4 * (2 * C * D + C + N * D + D) / HBM_BYTES_PER_S
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def check_k1(C, D, N, seed=0, timed=False, single_pass=False):
    """K1 against its plain version on random card inputs; returns the max
    abs error and, if ``timed``, both times in ms (K1 with X prepared once,
    as the target calls it).  ``single_pass`` also times ``passes=1`` and
    holds it to the TF32 tolerances."""
    from klara_tpu_torch.ops import logreg

    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(N, D, generator=g, device="cuda")
    y = (torch.rand(N, generator=g, device="cuda") < 0.5).float()
    P = 0.3 * torch.randn(C, D, generator=g, device="cuda")
    v = (X.T @ y).contiguous()
    out = {"shape": [C, D, N], "max_abs_err": _k1_error(P, X, y)}
    if timed:
        prep = logreg.prepare_x(X, y)
        out["ms"] = _time_ms(lambda: logreg.logreg_value_grad(P, X, v, 100.0, prepared=prep))
        out["plain_ms"] = _time_ms(lambda: logreg.logreg_value_grad_reference(P, X, v, 100.0))
        out["prepare_x_ms"] = _time_ms(lambda: logreg.prepare_x(X, y))
    if single_pass:
        prep = logreg.prepare_x(X, y)
        val, grad = logreg.logreg_value_grad(P, X, v, 100.0, passes=1, prepared=prep)
        rval, rgrad = logreg.logreg_value_grad_reference(P, X, v, 100.0)
        torch.cuda.synchronize()
        torch.testing.assert_close(val, rval, rtol=TF32_VALUE_RTOL, atol=0)
        torch.testing.assert_close(grad, rgrad, rtol=TF32_GRAD_RTOL, atol=TF32_GRAD_ATOL)
        out["single_pass"] = {
            "ms": _time_ms(lambda: logreg.logreg_value_grad(P, X, v, 100.0, passes=1,
                                                            prepared=prep)),
            "value_max_rel_err": float(((val - rval) / rval).abs().max()),
            "grad_max_abs_err": float((grad - rgrad).abs().max()),
        }
    print(f"# K1 vs plain at C={C} D={D} N={N}: {out}", flush=True)
    return out


def check_k1_against_float64(chains=CHAINS, dim=DIM, n_data=N_DATA, seed=3):
    """K1 and the plain f32 version against the plain version in float64 at
    ``chains`` positions drawn from the Laplace approximation of the main
    path's posterior (Newton steps to the mode in float64), where the logits
    are large and p·v and Σ softplus nearly cancel.  K1 must meet the phase-3
    absolute tolerances against float64 itself; returns both versions' errors."""
    from klara_tpu_torch.models.examples import synthetic_logistic_regression
    from klara_tpu_torch.ops import logreg

    _, X, y = synthetic_logistic_regression(dim=dim, n_data=n_data, device="cuda")
    Xd, yd = X.double(), y.double()
    eye = torch.eye(dim, dtype=torch.float64, device="cuda")
    w = torch.zeros(dim, dtype=torch.float64, device="cuda")
    for _ in range(30):
        p = torch.sigmoid(Xd @ w)
        hess = (Xd.T * (p * (1 - p))) @ Xd + eye / 100.0
        w = w + torch.linalg.solve(hess, Xd.T @ (yd - p) - w / 100.0)
    chol = torch.linalg.cholesky(torch.linalg.inv(hess))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn(chains, dim, generator=gen, device="cuda", dtype=torch.float64)
    P = (w + noise @ chol.T).float().contiguous()
    v = (X.T @ y).contiguous()
    rv, rg = logreg.logreg_value_grad_reference(P.double(), Xd, Xd.T @ yd, 100.0)
    pv, pg = logreg.logreg_value_grad_reference(P, X, v, 100.0)
    kv, kg = logreg.logreg_value_grad(P, X, v, 100.0, prepared=logreg.prepare_x(X, y))
    torch.cuda.synchronize()
    out = {"mean_abs_logit": float((P @ X.T).abs().mean()), "mean_value": float(rv.mean())}
    for name, val, grad in (("plain_f32", pv, pg), ("k1", kv, kg)):
        dv, dg = val - rv, grad - rg
        out[name] = {"value_max_abs_err": float(dv.abs().max()),
                     "value_rms_err": float(dv.pow(2).mean().sqrt()),
                     "grad_max_abs_err": float(dg.abs().max())}
    print(f"# K1 and plain f32 vs float64 at {chains} posterior positions: {json.dumps(out)}",
          flush=True)
    if out["k1"]["value_max_abs_err"] > VALUE_ATOL or out["k1"]["grad_max_abs_err"] > GRAD_ATOL:
        raise RuntimeError(f"K1 is off float64 at posterior positions: {out['k1']}")
    return out


def _x_summary(values, chol, chunk):
    """Per-dim posterior mean, sd and chain-summed ESS of a trace, mapped
    to x = y Lᵀ (L = ``chol``; None: the identity) one chain chunk at a
    time (as bench.py)."""
    import klara_tpu_torch as kt

    s1 = s2 = ess = 0.0
    for s in range(0, values.shape[1], chunk):
        x = values[:, s:s + chunk].to(torch.float32)
        if chol is not None:
            x = x @ chol.T
        ess = ess + kt.stats.ess(x)
        x = x.to(torch.float64)
        s1 = s1 + x.sum((0, 1))
        s2 = s2 + (x * x).sum((0, 1))
    n = values.shape[0] * values.shape[1]
    mean = s1 / n
    return mean, torch.sqrt(s2 / n - mean * mean), ess.to(torch.float64)


def _chunk(n_draws, dim):
    nfft = 1
    while nfft < 2 * n_draws:
        nfft *= 2
    return min(2048, max(128, (1 << 28) // (nfft * dim)))


def _rhat_max(values, chol, max_draws=512, dim_chunk=16, chains_cap=2048, over_time=False):
    """Max over coordinates of rank-R̂ on up to 512 evenly thinned draws of
    up to 2048 chains, back-transformed per dim chunk (as bench.py; chol
    None: the identity).  ``over_time`` swaps the roles: each saved time
    point is a "chain" whose draws are the chains' positions at that time,
    so the statistic compares the ensemble's distribution between times and
    says nothing of how fast a chain moves."""
    import klara_tpu_torch as kt

    values = values[:, :chains_cap]
    step = max(1, values.shape[0] // max_draws)
    y = values[::step].to(torch.float32)
    if over_time:
        y = y.transpose(0, 1)
    if chol is None:
        return float(kt.stats.rhat_rank(y).max())
    return max(
        float(kt.stats.rhat_rank(y @ chol[s:s + dim_chunk].T).max())
        for s in range(0, values.shape[-1], dim_chunk)
    )


def _stage1_job(target, chains, dim, burnin, post, mesh=None):
    """The chees_precond / nuts_precond job: stage-1 ChEES HMC settings of
    bench.py, trace in bf16 past 4e9 bytes."""
    import klara_tpu_torch as kt

    s1 = kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=0.5, jitter=0.9,
                jitter_style="step", max_nleaps=256)
    trace_dtype = "bfloat16" if post * chains * dim * 4 > 4e9 else None
    return kt.MCJob(
        target, s1, kt.MCRange(n_steps=burnin + post, burnin=burnin),
        tuner=kt.DualAveragingTuner(0.8, burnin), n_chains=chains,
        monitor=("value",), diagnostics=("accept", "nleaps"), pooled_tuning=True,
        mass_adaptation=True, mass_period=50, trace_dtype=trace_dtype,
        traj_adaptation=True, mesh=mesh,
    )


def _marked(sampler_cls, marks):
    """``sampler_cls`` that appends the K1 count to ``marks`` when a job
    initialises it: as stage 2's sampler it reads stage 1's launches."""
    import dataclasses

    from klara_tpu_torch.ops import logreg

    @dataclasses.dataclass(frozen=True)
    class Marked(sampler_cls):
        def init(self, *args, **kw):
            marks.append(logreg.KERNEL_LAUNCHES)
            return super().init(*args, **kw)

    return Marked


def _stage1_adapted(info):
    """Stage 1's adapted step size and trajectory length (pooled: one value)."""
    end = info["stage1_state"]
    eps, lam = float(end.tune.step.mean()), float(torch.exp(end.log_traj).mean())
    return {"stage1_eps": eps, "stage1_lambda": lam, "stage1_leaps_at_lambda": lam / eps}


def _check_launches(path, got, allowance=LAUNCH_ALLOWANCE):
    want = K1_LAUNCHES_BEFORE[path]
    if abs(got - want) > allowance * want:
        raise RuntimeError(f"{path}: {got} K1 launches, over {allowance:.0%} from the "
                           f"anchored {want}")


def _trace_bits(values, chunk=64):
    """Per draw, the sum of the trace's raw bits (bf16 or f32 read as
    integers), int64: a checksum that any changed bit moves."""
    ints = torch.int16 if values.element_size() == 2 else torch.int32
    out = torch.empty(values.shape[0], dtype=torch.int64, device=values.device)
    for s in range(0, values.shape[0], chunk):
        out[s:s + chunk] = values[s:s + chunk].view(ints).flatten(1).sum(1, dtype=torch.int64)
    return out


def _fingerprint(chain, info):
    """What phase 25 holds phase 4 to, bit for bit: the final positions, the
    final step size, stage 1's adapted step and trajectory length, the
    Cholesky factor and the trace's checksum per draw."""
    end, s1 = chain.final_state, info["stage1_state"]
    return {"position": end.position.clone(), "eps": end.tune.step.clone(),
            "stage1_eps": s1.tune.step.clone(), "stage1_log_traj": s1.log_traj.clone(),
            "chol": info["chol"].clone(), "trace_bits": _trace_bits(chain.value)}


def run_main_path(device="cuda", chains=CHAINS, dim=DIM, n_data=N_DATA, burnin=BURNIN,
                  post=POST, mesh=None):
    """chees_precond at bench size through the port's public entry points
    (on ``mesh`` if given: phase 25); returns its results, the x-space
    (mean, sd, ESS) per dim (None on a mesh, whose run phase 25 holds to
    phase 4's bit for bit), what ``profile_chees`` starts from (stage 2's
    job, final state, generator), the final positions in x space
    (stationary draws, the zoo's start) and the run's ``_fingerprint``."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import synthetic_logistic_regression
    from klara_tpu_torch.ops import logreg
    from klara_tpu_torch.parallel.mesh import COLLECTIVES

    target, X, y = synthetic_logistic_regression(dim=dim, n_data=n_data, device=device)
    stage2_start = []
    s2 = _marked(kt.HMC, stage2_start)(leapstep=0.05, nleaps=8, trajectory_length=2.0,
                                       jitter=0.9, jitter_style="step", max_nleaps=64)
    job = _stage1_job(target, chains, dim, burnin, post, mesh)
    gen = torch.Generator(device=device).manual_seed(42)
    x0 = 0.1 * torch.randn(chains, dim, generator=gen, device=device)

    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    reduces0 = COLLECTIVES["all_reduce"]
    t0 = time.perf_counter()
    chain, timings, info = job.run_preconditioned(
        gen, x0, stage2_replace=dict(sampler=s2, traj_adaptation=False),
        back_transform=False,
    )
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, k2 = logreg.KERNEL_LAUNCHES, _k2_launches()
    replays = _graph_counts(device, "chees_precond")
    reduces = COLLECTIVES["all_reduce"] - reduces0

    values, chol = chain.value, info["chol"]
    if tuple(values.shape) != (post, chains, dim):
        raise RuntimeError(f"trace shape {tuple(values.shape)}")
    if not bool(torch.isfinite(values).all()):
        raise RuntimeError("non-finite draws in the trace")
    fingerprint = _fingerprint(chain, info)
    accept = float(kt.stats.acceptance(chain))
    leaps = float(chain["nleaps"].to(torch.float64).mean())
    res = {
        "warmup_seconds": timings["warmup_seconds"],
        "sampling_seconds": timings["sampling_seconds"],
        "wall_seconds": wall,
        "acceptance": accept,
        "leaps_per_draw": leaps,
        "eps_final": float(chain.final_state.tune.step.mean()),
        "trace_dtype": str(values.dtype),
        **_stage1_adapted(info),
        "k1_launches": launches,
        "k1_launches_stage1": stage2_start[0],
        "k1_launches_stage2": launches - stage2_start[0],
        "k1_max_abs_err_on_path": _k1_error(
            (chain.final_state.position @ chol.T).contiguous(), X, y),
        "k2_launches": k2,
        "k2_launches_per_step": k2 / (2 * burnin + post + 1),
        **replays,
    }
    x_end = (chain.final_state.position @ chol.T).contiguous()
    if mesh is not None:
        # two stages of burnin adapt; sampling runs no reduction
        res.update(all_reduces=reduces, all_reduces_per_adapting_step=reduces / (2 * burnin))
        print(f"# chees_precond {chains}x{dim}x{n_data} on a one-rank chains mesh "
              f"({torch.distributed.get_backend()}): {json.dumps(res)}", flush=True)
        return res, None, (info["whitened_job"], chain.final_state, gen), x_end, fingerprint
    summary = _x_summary(values, chol, _chunk(post, dim))
    min_ess = float(summary[2].min())
    rhat = _rhat_max(values, chol)
    res.update(min_ess=min_ess, ess_per_sec=min_ess / timings["sampling_seconds"],
               rhat_max=rhat)
    print(f"# chees_precond {chains}x{dim}x{n_data}: {json.dumps(res)}", flush=True)
    if rhat > RHAT_GATE:
        raise RuntimeError(f"rank-R-hat {rhat} > {RHAT_GATE}")
    if not ACCEPT_RANGE[0] <= accept <= ACCEPT_RANGE[1]:
        raise RuntimeError(f"acceptance {accept} outside {ACCEPT_RANGE}")
    if (chains, dim, n_data, burnin, post) == (CHAINS, DIM, N_DATA, BURNIN, POST):
        _check_launches("stage1", res["k1_launches_stage1"], STAGE1_ALLOWANCE)
        _check_launches("chees_stage2", res["k1_launches_stage2"])
    return res, summary, (info["whitened_job"], chain.final_state, gen), x_end, fingerprint


def stage1_sensitivity(device="cuda", chains=CHAINS, dim=DIM, n_data=N_DATA, burnin=BURNIN):
    """Opt-in: stage 1 of the two preconditioned paths alone, with K1 and
    with the plain version (f32 cuBLAS products) as the target's value+grad,
    at several generator seeds.  The same sampler, tuners and draws; only
    the last bits of the value and gradient differ between the two at one
    seed.  Returns one record per run."""
    import dataclasses

    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import synthetic_logistic_regression
    from klara_tpu_torch.ops import logreg

    k1_target, X, y = synthetic_logistic_regression(dim=dim, n_data=n_data, device=device)
    v = (X.T @ y).contiguous()
    runs = []
    for kind, seed in (("k1", 42), ("plain", 42), ("k1", 43), ("plain", 43), ("k1", 44)):
        evals = [0]

        def value_and_grad(P, kind=kind, evals=evals):
            evals[0] += 1
            if kind == "k1":
                return k1_target.value_and_grad_fn(P)
            return logreg.logreg_value_grad_reference(P, X, v, 100.0)

        target = dataclasses.replace(k1_target, value_and_grad_fn=value_and_grad)
        job = dataclasses.replace(_stage1_job(target, chains, dim, burnin, 1),
                                  mcrange=kt.MCRange(n_steps=burnin + 1, burnin=burnin))
        gen = torch.Generator(device=device).manual_seed(seed)
        x0 = 0.1 * torch.randn(chains, dim, generator=gen, device=device)
        chain, timings = job.run_phased(gen, x0)
        end = chain.final_state
        eps, lam = float(end.tune.step.mean()), float(torch.exp(end.log_traj).mean())
        runs.append({"value_and_grad": kind, "seed": seed, "evaluations": evals[0],
                     "stage1_eps": eps, "stage1_lambda": lam, "stage1_leaps_at_lambda": lam / eps,
                     "seconds": timings["warmup_seconds"] + timings["sampling_seconds"]})
        print(f"# stage 1 alone {chains}x{dim}x{n_data}: {json.dumps(runs[-1])}", flush=True)
    return runs


def run_nuts_precond(chees_summary, device="cuda", chains=CHAINS, dim=DIM,
                     n_data=N_DATA, burnin=BURNIN, post=POST):
    """Phase 5: nuts_precond at bench size.  Returns its results and what
    phases 6 and 7 start from."""
    import dataclasses

    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import synthetic_logistic_regression
    from klara_tpu_torch.ops import logreg

    stage2_start = []
    nuts3 = _marked(kt.NUTS, stage2_start)(max_doublings=3)
    target, X, y = synthetic_logistic_regression(dim=dim, n_data=n_data, device=device)
    job = _stage1_job(target, chains, dim, burnin, post)
    gen = torch.Generator(device=device).manual_seed(42)
    x0 = 0.1 * torch.randn(chains, dim, generator=gen, device=device)

    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    chain, timings, info = job.run_preconditioned(
        gen, x0, stage2_replace=dict(sampler=nuts3,
                                     traj_adaptation=False, diagnostics=("accept", "na")),
        back_transform=False,
    )
    torch.cuda.synchronize()
    launches, k2 = logreg.KERNEL_LAUNCHES, _k2_launches()
    replays = _graph_counts(device, "nuts_precond")
    stage2 = launches - stage2_start[0]

    values, chol = chain.value, info["chol"]
    if tuple(values.shape) != (post, chains, dim):
        raise RuntimeError(f"trace shape {tuple(values.shape)}")
    if not bool(torch.isfinite(values).all()):
        raise RuntimeError("non-finite draws in the nuts_precond trace")
    mean, sd, ess = _x_summary(values, chol, _chunk(post, dim))
    rhat = _rhat_max(values, chol)
    na = float(chain["na"].to(torch.float64).mean())
    m0, sd0, ess0 = chees_summary
    z = float(((mean - m0).abs() / torch.sqrt(sd**2 / ess + sd0**2 / ess0)).max())
    data = (X, y)
    k1_err = _k1_error((chain.final_state.position @ chol.T).contiguous(), *data)
    res = {
        "warmup_seconds": timings["warmup_seconds"],
        "sampling_seconds": timings["sampling_seconds"],
        "min_ess": float(ess.min()),
        "ess_per_sec": float(ess.min()) / timings["sampling_seconds"],
        "rhat_max": rhat,
        "acceptance": float(kt.stats.acceptance(chain)),
        "mean_na": na,
        "eps_final": float(chain.final_state.tune.step.mean()),
        "ms_per_step": 1e3 * timings["sampling_seconds"] / post,
        **_stage1_adapted(info),
        "k1_launches": launches,
        "k1_launches_stage1": stage2_start[0],
        "k1_launches_stage2": stage2,
        "k1_max_abs_err_on_path": k1_err,
        "k2_launches": k2,
        **replays,
        "max_mean_z_vs_chees": z,
    }
    print(f"# nuts_precond {chains}x{dim}x{n_data}: {json.dumps(res)}", flush=True)
    if rhat > RHAT_GATE:
        raise RuntimeError(f"nuts_precond rank-R-hat {rhat} > {RHAT_GATE}")
    if stage2 != 7 * (burnin + post) + 1:
        raise RuntimeError(f"stage 2 launched K1 {stage2} times, expected "
                           f"7 x {burnin + post} + 1 (init)")
    if z > MEAN_Z_GATE:
        raise RuntimeError(f"nuts_precond and chees_precond means differ by {z} se")
    if (chains, dim, n_data, burnin, post) == (CHAINS, DIM, N_DATA, BURNIN, POST):
        _check_launches("stage1", stage2_start[0], STAGE1_ALLOWANCE)
    wjob = dataclasses.replace(info["whitened_job"], sampler=kt.NUTS(max_doublings=3))
    return res, wjob, chain.final_state, chol, gen, data


def check_no_host_read(wjob, state, gen, n_steps=5):
    """Phase 6: static-tree steps under sync debug mode 'error'."""
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n_steps):
            state, _ = wjob.sampler.step(state, wjob.target, gen)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(state.position).all()):
        raise RuntimeError("non-finite positions after the sync-checked steps")
    print(f"# static NUTS step: {n_steps} steps with no host read", flush=True)


def profile_nuts(wjob, state, gen, out_dir, window=200, warm=20):
    """Opt-in: ``window`` stage-2 sampling steps of nuts_precond from phase
    5's final state under torch.profiler, with ``leapfrog_step`` and
    ``NUTS.draws`` wrapped in record_function ranges here only.  Device time
    splits into K1, the whitening GEMMs, the leapfrog's elementwise ops, the
    draws and the rest: the NUTS bookkeeping (H, slice and divergence tests,
    take, candidate and edge selects, alive/n/a/na/div, merge u-turn dots,
    doubling swap) and the trace write.  The next ``window`` steps run
    without the profiler for the wall time.  Writes profile_nuts.json and
    profile_nuts.txt (key_averages) under ``out_dir``."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.samplers import nuts as nuts_mod

    def device_ms(e):
        for name in ("device_time_total", "cuda_time_total"):
            if getattr(e, name, None) is not None:
                return float(getattr(e, name)) / 1e3
        return 0.0

    buffers = ({}, {})
    i0 = wjob.mcrange.burnin + warm
    stream = wjob._run_stream(gen, state.position.device)
    state = wjob._loop(state, stream, wjob.mcrange.burnin, i0, False, buffers)
    torch.cuda.synchronize()
    leap0, draws0 = nuts_mod.leapfrog_step, kt.NUTS.draws

    def leap(*a, **k):
        with torch.profiler.record_function("nuts::leapfrog_step"):
            return leap0(*a, **k)

    def draws(self, *a, **k):
        with torch.profiler.record_function("nuts::draws"):
            return draws0(self, *a, **k)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    nuts_mod.leapfrog_step, kt.NUTS.draws = leap, draws
    _k2_reset()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            state = wjob._loop(state, stream, i0, i0 + window, False, buffers)
            torch.cuda.synchronize()
            wall_profiled = 1e3 * (time.perf_counter() - t0)
    finally:
        nuts_mod.leapfrog_step, kt.NUTS.draws = leap0, draws0
    k2_launched = _k2_launches()
    t0 = time.perf_counter()
    wjob._loop(state, stream, i0 + window, i0 + 2 * window, False, buffers)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)

    events = prof.events()
    # device kernels, without the device copies of the user ranges
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")
               and not e.name.startswith("nuts::")]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    k1 = sum(e.time_range.elapsed_us() for e in kernels if "logreg" in e.name) / 1e3
    gemms = [e for e in kernels if any(s in e.name.lower() for s in ("gemm", "cutlass", "xmma"))]
    gemm = sum(e.time_range.elapsed_us() for e in gemms) / 1e3

    def range_ms(name):
        return sum(device_ms(e) for e in events
                   if e.name == name and str(e.device_type).endswith("CPU"))

    leap_range, draws_ms = range_ms("nuts::leapfrog_step"), range_ms("nuts::draws")
    # K1 launches through ctypes, not through an aten op, so the profiler may
    # not charge it to the enclosing range; K1 alone is larger than the rest
    k1_in_range = leap_range >= k1 + gemm
    leap_elementwise = leap_range - gemm - (k1 if k1_in_range else 0.0)
    bookkeeping = busy - k1 - gemm - leap_elementwise - draws_ms
    res = {
        "window_steps": window,
        "device_kernels": len(kernels),
        "device_busy_ms": busy,
        "wall_ms_profiled": wall_profiled,
        "wall_ms": wall,
        "idle_share_profiled": 1.0 - busy / wall_profiled,
        # profiled device busy time over the unprofiled window's wall time
        "idle_share_est": 1.0 - busy / wall,
        "k1_ms": k1,
        "k1_kernels": sum("logreg" in e.name for e in kernels),
        "gemm_ms": gemm,
        "gemm_kernels": len(gemms),
        "k1_in_leapfrog_range": k1_in_range,
        # K2's kernels the profiler recorded against the launches the wrapper counted
        "k2_kernels": sum("keyed_draws" in e.name for e in kernels),
        "k2_launches": k2_launched,
        "leapfrog_elementwise_ms": leap_elementwise,
        "draws_ms": draws_ms,
        "bookkeeping_ms": bookkeeping,
        "bookkeeping_share_of_busy": bookkeeping / busy,
        "eps_mean": float(state.tune.step.mean()),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_nuts.json"), "w") as f:
        json.dump(res, f, indent=1)
    with open(os.path.join(out_dir, "profile_nuts.txt"), "w") as f:
        try:
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
        except (KeyError, AttributeError):  # torch versions before the device_* names
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    print(f"# nuts_precond stage-2 profile: {json.dumps(res)}", flush=True)
    if leap_elementwise < 0 or bookkeeping < 0:
        raise RuntimeError("profile: device time attribution does not add up")
    return res


def profile_chees(wjob, state, gen, out_dir, window=200, warm=20):
    """Opt-in: ``window`` stage-2 sampling steps of chees_precond from phase
    4's final state under torch.profiler: device busy time, K1's and the
    whitening GEMMs' share of it, kernels per step, and the idle share
    against the next ``window`` steps' wall time without the profiler.
    Writes profile_chees.json and profile_chees.txt under ``out_dir``."""
    buffers = ({}, {})
    i0 = wjob.mcrange.burnin + warm
    stream = wjob._run_stream(gen, state.position.device)
    state = wjob._loop(state, stream, wjob.mcrange.burnin, i0, False, buffers)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    _k2_reset()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state = wjob._loop(state, stream, i0, i0 + window, False, buffers)
        torch.cuda.synchronize()
        wall_profiled = 1e3 * (time.perf_counter() - t0)
    k2_launched = _k2_launches()
    t0 = time.perf_counter()
    wjob._loop(state, stream, i0 + window, i0 + 2 * window, False, buffers)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    k1 = [e for e in kernels if "logreg" in e.name]
    k1_ms = sum(e.time_range.elapsed_us() for e in k1) / 1e3
    k2 = [e for e in kernels if "keyed_draws" in e.name]
    k2_ms = sum(e.time_range.elapsed_us() for e in k2) / 1e3
    gemm = sum(e.time_range.elapsed_us() for e in kernels
               if any(s in e.name.lower() for s in ("gemm", "cutlass", "xmma"))) / 1e3
    res = {
        "window_steps": window,
        "device_kernels_per_step": len(kernels) / window,
        "device_busy_ms_per_step": busy / window,
        "wall_ms_per_step_profiled": wall_profiled / window,
        "wall_ms_per_step": wall / window,
        "idle_share_profiled": 1.0 - busy / wall_profiled,
        # profiled device busy time over the unprofiled window's wall time
        "idle_share_est": 1.0 - busy / wall,
        "k1_kernels": len(k1),
        "k1_ms_each": k1_ms / max(len(k1), 1),
        "k1_share_of_busy": k1_ms / busy,
        # K2's kernels the profiler recorded against the launches the wrapper counted
        "k2_kernels": len(k2),
        "k2_launches": k2_launched,
        "k2_ms_per_step": k2_ms / window,
        "k2_share_of_busy": k2_ms / busy,
        "gemm_share_of_busy": gemm / busy,
        "eps_mean": float(state.tune.step.mean()),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_chees.json"), "w") as f:
        json.dump(res, f, indent=1)
    with open(os.path.join(out_dir, "profile_chees.txt"), "w") as f:
        try:
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
        except (KeyError, AttributeError):  # torch versions before the device_* names
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    print(f"# chees_precond stage-2 profile: {json.dumps(res)}", flush=True)
    return res


def check_trees_agree(state, target, gen, max_doublings, n_steps=TREE_STEPS):
    """Both tree forms on the same draws from ``state``, ``n_steps`` steps:
    per chain the leapfrog arithmetic is the same, so the new positions
    and the discrete outcomes must be equal.  Returns the number of trees
    that stopped inside their last subtree (na < 2^ndoublings − 1), where
    the looped form's checkpoint slots decide the outcome."""
    import klara_tpu_torch as kt

    static = kt.NUTS(max_doublings=max_doublings, tree_impl="static")
    looped = kt.NUTS(max_doublings=max_doublings, tree_impl="looped")
    stopped_inside = 0
    for _ in range(n_steps):
        draws = static.draws(gen, state)
        new_s, info_s = static.step(state, target, draws=draws)
        new_l, info_l = looped.step(state, target, draws=draws)
        for name in ("ndoublings", "na", "divergent"):
            if not torch.equal(info_s.extras[name], info_l.extras[name]):
                raise RuntimeError(f"depth {max_doublings}: the tree forms differ in {name}")
        if not torch.equal(info_s.accept, info_l.accept):
            raise RuntimeError(f"depth {max_doublings}: the tree forms differ in accept")
        if not torch.equal(new_s.position, new_l.position):
            raise RuntimeError(f"depth {max_doublings}: the tree forms differ in position")
        torch.testing.assert_close(info_s.extras["a"], info_l.extras["a"], rtol=A_RTOL, atol=0)
        na, nd = info_s.extras["na"], info_s.extras["ndoublings"]
        stopped_inside += int((na < (1 << nd) - 1).sum())
        state = new_s
    print(f"# static = looped tree at depth {max_doublings}: {n_steps} steps x "
          f"{state.position.shape[0]} chains, {stopped_inside} trees stopped "
          f"inside their last subtree", flush=True)
    return stopped_inside


def _ms_per_step(sampler, state, target, gen, n_steps=100):
    for _ in range(5):
        sampler.step(state, target, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, _ = sampler.step(state, target, gen)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n_steps


def run_nuts_looped(wjob, state, chol, gen, na_static, data, chains=SMALL_CHAINS,
                    burnin=BURNIN, post=LOOPED_POST):
    """Phase 7: the looped tree on the whitened target from phase 5's
    first ``chains`` final positions; then K1 on its final positions
    (``data``: X and y), both tree forms on the same draws and both timed
    from that state."""
    import dataclasses

    import klara_tpu_torch as kt
    from klara_tpu_torch.ops import logreg

    looped = kt.NUTS(max_doublings=3, tree_impl="looped")
    job = dataclasses.replace(
        wjob, sampler=looped, n_chains=chains, trace_dtype=None,
        mcrange=kt.MCRange(n_steps=burnin + post, burnin=burnin),
    )
    y0 = state.position[:chains].contiguous()
    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    chain, timings = job.run_phased(gen, y0)
    torch.cuda.synchronize()
    launches, k2 = logreg.KERNEL_LAUNCHES, _k2_launches()

    values = chain.value
    if not bool(torch.isfinite(values).all()):
        raise RuntimeError("non-finite draws in the looped-tree trace")
    rhat = _rhat_max(values, chol)
    na = float(chain["na"].to(torch.float64).mean())
    end = chain.final_state
    res = {
        "warmup_seconds": timings["warmup_seconds"],
        "sampling_seconds": timings["sampling_seconds"],
        "rhat_max": rhat,
        "mean_na": na,
        "eps_final": float(chain.final_state.tune.step.mean()),
        "k1_launches": launches,
        "k1_max_abs_err_on_path": _k1_error((end.position @ chol.T).contiguous(), *data),
        "k2_launches": k2,
        "trees_stopped_inside": check_trees_agree(end, job.target, gen, 3),
        "ms_per_step_looped": _ms_per_step(looped, end, job.target, gen),
        "ms_per_step_static": _ms_per_step(wjob.sampler, end, job.target, gen),
    }
    print(f"# nuts_looped {chains}x{DIM}: {json.dumps(res)}", flush=True)
    if rhat > RHAT_GATE:
        raise RuntimeError(f"looped-tree rank-R-hat {rhat} > {RHAT_GATE}")
    if abs(na - na_static) > 0.1 * na_static:
        raise RuntimeError(f"looped mean na {na} vs static {na_static}: over 10% apart")
    if (chains, burnin, post) == (SMALL_CHAINS, BURNIN, LOOPED_POST):
        _check_launches("nuts_looped", launches)
    return res


def run_nuts_raw(device="cuda", chains=SMALL_CHAINS, dim=DIM, n_data=N_DATA,
                 burnin=BURNIN, post=RAW_POST, thinning=2):
    """Phase 8: bench.py's raw nuts row at ``chains`` chains; then K1 on
    its final positions and both tree forms on the same draws from them."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import synthetic_logistic_regression
    from klara_tpu_torch.ops import logreg

    target, X, y = synthetic_logistic_regression(dim=dim, n_data=n_data, device=device)
    n_stored = post // thinning
    job = kt.MCJob(
        target, kt.NUTS(max_doublings=5),
        kt.MCRange(n_steps=burnin + post, burnin=burnin, thinning=thinning),
        tuner=kt.DualAveragingTuner(0.8, burnin), n_chains=chains,
        monitor=("value",), diagnostics=("accept", "na"), pooled_tuning=True,
        mass_adaptation=True, mass_period=50,
        trace_dtype="bfloat16" if n_stored * chains * dim * 4 > 4e9 else None,
    )
    gen = torch.Generator(device=device).manual_seed(42)
    x0 = 0.1 * torch.randn(chains, dim, generator=gen, device=device)
    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    chain, timings = job.run_phased(gen, x0)
    torch.cuda.synchronize()
    launches, k2 = logreg.KERNEL_LAUNCHES, _k2_launches()

    values = chain.value
    if not bool(torch.isfinite(values).all()):
        raise RuntimeError("non-finite draws in the raw nuts trace")
    _, _, ess = _x_summary(values, None, _chunk(values.shape[0], dim))
    rhat = _rhat_max(values, None)
    res = {
        "warmup_seconds": timings["warmup_seconds"],
        "sampling_seconds": timings["sampling_seconds"],
        "min_ess": float(ess.min()),
        "ess_per_sec": float(ess.min()) / timings["sampling_seconds"],
        "rhat_max": rhat,
        "acceptance": float(kt.stats.acceptance(chain)),
        "leaves_per_step": float(chain["na"].to(torch.float64).mean()),
        "eps_final": float(chain.final_state.tune.step.mean()),
        "k1_launches": launches,
        "k1_max_abs_err_on_path": _k1_error(chain.final_state.position.contiguous(), X, y),
        "k2_launches": k2,
        "trees_stopped_inside": check_trees_agree(chain.final_state, target, gen, 5),
    }
    print(f"# nuts {chains}x{dim}x{n_data}: {json.dumps(res)}", flush=True)
    if rhat > RHAT_GATE:
        raise RuntimeError(f"raw nuts rank-R-hat {rhat} > {RHAT_GATE}")
    if res["trees_stopped_inside"] == 0:
        raise RuntimeError("no depth-5 tree stopped inside its last subtree: the "
                           "tree-form check did not reach the checkpoint slots")
    if (chains, dim, n_data, burnin, post) == (SMALL_CHAINS, DIM, N_DATA, BURNIN, RAW_POST):
        _check_launches("nuts", launches)
    return res


def _gibbs_summary(chains):
    """Per monitored key: posterior mean, sd, chain-summed ESS (chunked over
    chains) and rank-R̂ (thinned, as ``_rhat_max``)."""
    out = {}
    for k, v in chains.samples.items():
        v = v[..., None]
        mean, sd, ess = _x_summary(v, None, _chunk(v.shape[0], 1))
        out[k] = {"mean": float(mean[0]), "sd": float(sd[0]), "ess": float(ess[0]),
                  "rhat": _rhat_max(v, None)}
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed_gibbs(job, gen, v0, device):
    t0 = time.perf_counter()
    chains = job.run(gen, v0)
    _sync(device)
    return chains, time.perf_counter() - t0


def run_gibbs_rats(device="cuda", chains=GIBBS_CHAINS, sweeps=GIBBS_SWEEPS,
                   burnin=GIBBS_BURNIN, warm=GIBBS_WARM):
    """Phase 9: bench.py's rats Gibbs row.  Returns its results, the job,
    the last run's chains, v0 and the generator."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import rats_gibbs_model
    from klara_tpu_torch.ops import logreg

    model, v0 = rats_gibbs_model(device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def job(n):
        return kt.GibbsJob(model, {}, kt.MCRange(n_steps=n, burnin=burnin), n_chains=chains,
                           monitor=GIBBS_MONITOR, device=device)

    _, warm_secs = _timed_gibbs(job(burnin + warm), gen, v0, device)
    full = job(sweeps)
    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    out, secs = _timed_gibbs(full, gen, v0, device)
    launches, k2 = logreg.KERNEL_LAUNCHES, _k2_launches()
    replays = _graph_counts(device, "gibbs_rats")
    from klara_tpu_torch.ops import keyed

    k2_by_mode = dict(keyed.LAUNCHES_BY_MODE)

    where = {t.device.type for t in (*out.samples.values(), *out.final_values.values())}
    if where != {torch.device(device).type}:
        raise RuntimeError(f"Gibbs values and traces live on {where}, not {device}")
    for k, v in out.samples.items():
        if tuple(v.shape) != (sweeps - burnin, chains) or not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"rats trace {k}: shape {tuple(v.shape)} or non-finite draws")
    summary = _gibbs_summary(out)
    min_ess = min(s["ess"] for s in summary.values())
    rhat = max(s["rhat"] for s in summary.values())
    n_draws = (sweeps - burnin) * chains
    res = {
        "warmup_run_sweeps": burnin + warm,
        "warmup_run_seconds": warm_secs,
        "seconds": secs,
        "sweeps_per_sec": sweeps / secs,
        "chain_sweeps_per_sec": sweeps * chains / secs,
        "ms_per_sweep": 1e3 * secs / sweeps,
        "min_ess": min_ess,
        "ess_per_draw": min_ess / n_draws,
        "ess_per_sec": min_ess / secs,
        "rhat_max": rhat,
        "k1_launches": launches,
        "k2_launches": k2,
        "k2_launches_per_sweep": k2 / sweeps,
        "k2_launches_by_mode": k2_by_mode,
        **replays,
        "by_key": summary,
    }
    print(f"# gibbs_rats {chains} chains x {sweeps} sweeps: {json.dumps(res)}", flush=True)
    if rhat > RHAT_GATE:
        raise RuntimeError(f"rats Gibbs rank-R-hat {rhat} > {RHAT_GATE}")
    for k, (want, width) in BUGS_MEANS.items():
        if abs(summary[k]["mean"] - want) > width:
            raise RuntimeError(f"rats posterior mean of {k} {summary[k]['mean']} is not "
                               f"{want} ± {width} (BUGS)")
    return res, full, out, v0, gen


def check_gibbs_no_host_read(job, chains, v0, gen, n_sweeps=5):
    """Phase 10: conjugate sweeps from phase 9's final values under sync
    debug mode 'error'."""
    from klara_tpu_torch.ops import keyed

    values = job._initial_values({**v0, **chains.final_values}, prebatched=True)
    stream = job._stream(gen, gen.device)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(n_sweeps):
            values, _ = job._sweep(values, gen, {}, stream=stream, sweep=i)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    keyed.raise_on_overflow()
    if not all(bool(torch.isfinite(values[k]).all()) for k in chains.final_values):
        raise RuntimeError("non-finite values after the sync-checked sweeps")
    print(f"# rats Gibbs sweep: {n_sweeps} sweeps with no host read", flush=True)


def profile_gibbs(job, chains, v0, gen, out_dir=None, window=200, warm=20):
    """``window`` conjugate rats sweeps from phase 9's final values under
    torch.profiler (device kernels per sweep, device busy time), then
    ``window`` more without it for the wall time.  With ``out_dir`` (the
    opt-in profile) writes profile_gibbs.json and profile_gibbs.txt
    (key_averages) there; phase 9 runs a short window without."""
    from klara_tpu_torch.ops import keyed

    values = job._initial_values({**v0, **chains.final_values}, prebatched=True)
    stream, sweep = job._stream(gen, gen.device), 0

    def sweeps(n):
        nonlocal values, sweep
        for _ in range(n):
            values, _ = job._sweep(values, gen, {}, stream=stream, sweep=sweep)
            sweep += 1

    sweeps(warm)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sweeps(window)
        torch.cuda.synchronize()
        wall_profiled = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    sweeps(window)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    # a third window with every keyed draw's host time summed (perf_counter around
    # keyed.draws, which the stream's methods call; the wrapper's own ~0.1 us included)
    spent, draws = [0.0, 0], keyed.draws

    def timed_draws(*args, **kw):
        t = time.perf_counter()
        out = draws(*args, **kw)
        spent[0] += time.perf_counter() - t
        spent[1] += 1
        return out

    keyed.draws = timed_draws
    try:
        sweeps(window)
    finally:
        keyed.draws = draws
    torch.cuda.synchronize()
    keyed.raise_on_overflow()
    kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    res = {
        "window_sweeps": window,
        "device_kernels_per_sweep": len(kernels) / window,
        "device_busy_us_per_sweep": 1e3 * busy / window,
        "wall_ms_per_sweep_profiled": wall_profiled / window,
        "wall_ms_per_sweep": wall / window,
        "idle_share_profiled": 1.0 - busy / wall_profiled,
        # profiled device busy time over the unprofiled window's wall time
        "idle_share_est": 1.0 - busy / wall,
        "k2_kernels_per_sweep": sum("keyed_draws" in e.name for e in kernels) / window,
        "k2_host_us_per_sweep": 1e6 * spent[0] / window,
        "k2_host_us_per_draw": 1e6 * spent[0] / max(spent[1], 1),
    }
    print(f"# gibbs_rats sweep profile: {json.dumps(res)}", flush=True)
    if out_dir is None:
        return res
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_gibbs.json"), "w") as f:
        json.dump(res, f, indent=1)
    with open(os.path.join(out_dir, "profile_gibbs.txt"), "w") as f:
        try:
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
        except (KeyError, AttributeError):  # torch versions before the device_* names
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    return res


# ------------------------------------------- phase 28: graphs against eager
def _bits_equal(a, b) -> bool:
    """Bit for bit, NaNs included (a NaN field, e.g. a tuner's unset rate)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.bool:
        return bool(torch.equal(a, b))
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return bool(torch.equal(a.contiguous().view(ints), b.contiguous().view(ints)))


def _launch_counts():
    from klara_tpu_torch.ops import keyed, logreg

    return {"k1": logreg.KERNEL_LAUNCHES, "k2": keyed.KERNEL_LAUNCHES,
            "k2_by_mode": {m: n for m, n in keyed.LAUNCHES_BY_MODE.items() if n}}


def _one_form(run, n, device, window):
    """One form of a phase-28 path: ``run()`` (returns its outputs) timed on
    the host clock to a synchronise, with the block ends' CUDA events (each
    ``Staging.drain``), the launch counters and graph counters from 0, the
    peak of allocated memory, and a profiled ``window`` of the same work for
    the kernels the profiler records."""
    from klara_tpu_torch.jobs import graphs
    from klara_tpu_torch.ops import logreg

    events, drain = [], graphs.Staging.drain

    def timed_drain(self, *a, **k):
        drain(self, *a, **k)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    _sync(device)
    torch.cuda.reset_peak_memory_stats()
    graphs.Staging.drain = timed_drain
    try:
        t0 = time.perf_counter()
        out = run(n)
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        graphs.Staging.drain = drain
    res = {"ms_per_step": 1e3 * wall / n, **_launch_counts(), **_graph_counts(),
           "peak_allocated_mb": torch.cuda.max_memory_allocated() / 2**20}
    # steady state: the median block after the first two (the eager warm-up and
    # the first capture), from the block ends' events
    gaps = sorted(a.elapsed_time(b) for a, b in zip(events[2:], events[3:]))
    if gaps:
        res["block_ms_median"] = gaps[len(gaps) // 2]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    res["profiled_window"] = window
    try:
        with torch.profiler.profile(activities=acts) as prof:
            run(window)
            _sync(device)
    except RuntimeError as e:  # a measurement only: the bits and counts are held above
        res["profiler_error"] = repr(e)
        return out, res
    kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    res["profiler_kernels_per_step"] = len(kernels) / window
    res["profiler_busy_ms_per_step"] = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / window
    return out, res


def _compare_forms(path, graph_out, eager_out, graph, eager):
    """Raise unless the two forms give the same named tensors, traces among
    them, agreeing bit for bit, and their K1 and K2 launch counts are equal."""
    names = [name for name, _ in graph_out]
    if names != [name for name, _ in eager_out]:
        raise RuntimeError(f"phase 28 {path}: the graph run gives {names}, the eager run "
                           f"{[name for name, _ in eager_out]}")
    if not any(name.startswith("trace") for name in names):
        raise RuntimeError(f"phase 28 {path}: no trace to compare in {names}")
    for (name, a), (_, b) in zip(graph_out, eager_out):
        if not _bits_equal(a, b):
            raise RuntimeError(f"phase 28 {path}: {name} differs between the graph and eager runs")
    for key in ("k1", "k2", "k2_by_mode"):
        if graph[key] != eager[key]:
            raise RuntimeError(f"phase 28 {path}: {key} launches {graph[key]} (graph) against "
                               f"{eager[key]} (eager)")


def _flat(prefix, tree):
    """(name, tensor) of every tensor in ``tree``: a dict's by key, sorted, a
    tuple's or NamedTuple's by position."""
    if torch.is_tensor(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _flat(f"{prefix}.{k}", tree[k])]
    if isinstance(tree, (tuple, list)):
        return [pair for i, t in enumerate(tree) for pair in _flat(f"{prefix}[{i}]", t)]
    return []


def _graph_and_eager_mcjob(path, wjob, state, gen, steps, device, profile_steps):
    """``steps`` sampling steps of ``wjob`` (a stage-2 job) from ``state``,
    once in captured blocks and once in the eager loop, on one stream."""
    import dataclasses

    import klara_tpu_torch as kt
    from klara_tpu_torch.jobs import graphs
    from klara_tpu_torch.parallel.mesh import chain_context

    b = wjob.mcrange.burnin
    stream = wjob._run_stream(gen, state.position.device)

    def job(n):
        return dataclasses.replace(wjob, mcrange=kt.MCRange(n_steps=b + n, burnin=b))

    def graph_run(n):
        buffers = ({}, {})
        with chain_context(wjob._block):
            end = graphs.sample(job(n), state, stream, b, b + n, buffers)
        return _flat("final", end) + _flat("trace", buffers[0]) + _flat("diag", buffers[1])

    def eager_run(n):
        buffers = ({}, {})
        with chain_context(wjob._block):
            end = job(n)._loop(state, stream, b, b + n, False, buffers)
        return _flat("final", end) + _flat("trace", buffers[0]) + _flat("diag", buffers[1])

    g_out, g = _one_form(graph_run, steps, device, profile_steps)
    e_out, e = _one_form(eager_run, steps, device, profile_steps)
    _compare_forms(path, g_out, e_out, g, e)
    return g, e


def _graph_and_eager_warmup(device, steps, profile_steps, chains, dim, n_data):
    """``steps`` warmup steps of chees_precond's stage 1 from its init, once
    with the transitions replayed as graph units (``graphs.warm``) and once
    in the eager loop, from one state and run key.  The hooks keep
    references to what they are handed and return, as the benchmark's
    recording job does: the kept tensors of every step are the trace, read
    after the run."""
    from klara_tpu_torch.jobs import graphs
    from klara_tpu_torch.models.examples import synthetic_logistic_regression
    from klara_tpu_torch.parallel.mesh import chain_context

    target, _, _ = synthetic_logistic_regression(dim=dim, n_data=n_data, device=device)
    job = _stage1_job(target, chains, dim, BURNIN, 1)
    adapt, kept = job.adapt, []

    def keeping(prev_pos, states, infos, i, frac_shared=1.0):
        new = adapt(prev_pos, states, infos, i, frac_shared)
        kept.append((prev_pos, states, infos, frac_shared, new))
        return new

    job.adapt = keeping
    gen = torch.Generator(device=device).manual_seed(42)
    x0 = 0.1 * torch.randn(chains, dim, generator=gen, device=device)
    stream = job._run_stream(gen, x0.device)
    with chain_context(job._block):
        state = job._init_states(stream, job._start(stream, x0))

    def form(warmup):
        def run(n):
            kept.clear()
            with chain_context(job._block):
                end = warmup(n)
            return _flat("final", end) + _flat("trace", list(kept))
        return run

    g_out, g = _one_form(form(lambda n: graphs.warm(job, state, stream, 0, n)), steps, device,
                         profile_steps)
    e_out, e = _one_form(form(lambda n: job._loop(state, stream, 0, n, True)), steps, device,
                         profile_steps)
    _compare_forms("chees_warmup", g_out, e_out, g, e)
    return g, e


def run_graphs_vs_eager(chees_end, nuts_end, gibbs_parts, device="cuda",
                        steps=GRAPH_WINDOW_STEPS, sweeps=GRAPH_WINDOW_SWEEPS):
    """Phase 28: the three captured paths, each run twice from one state and
    one run key, in captured blocks and in the eager loop: the stage-2
    samplers of chees_precond (HMC, dynamic leap counts, shared jitter) and
    nuts_precond (static NUTS) for ``steps`` steps, stage 1's warmup of
    chees_precond (``GRAPH_WARMUP_STEPS``), and the conjugate rats sweep for
    ``sweeps`` sweeps from phase 9's final values.  Traces, final states and
    K1 and K2 launch counts must be equal, bit for bit."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.jobs import graphs

    t_phase = time.perf_counter()
    res = {}
    for path, (wjob, state, gen) in (("chees_precond", chees_end), ("nuts_precond", nuts_end)):
        g, e = _graph_and_eager_mcjob(path, wjob, state, gen, steps, device,
                                      GRAPH_PROFILE_STEPS)
        res[path] = {"graph": g, "eager": e, "block_steps": graphs.STEPS_PER_BLOCK}
    chains, dim = chees_end[1].position.shape
    g, e = _graph_and_eager_warmup(device, GRAPH_WARMUP_STEPS, GRAPH_WARMUP_PROFILE_STEPS,
                                   chains, dim, N_DATA)
    res["chees_warmup"] = {"graph": g, "eager": e, "block_steps": 1}  # no block: a step

    gjob, gchains, v0, ggen = gibbs_parts

    def job(n):
        return kt.GibbsJob(gjob.model, {}, kt.MCRange(n_steps=n), n_chains=gjob.n_chains,
                           monitor=gjob.monitor, device=device)

    start = job(1)._initial_values({**v0, **gchains.final_values}, prebatched=True)
    stream = job(1)._stream(ggen, ggen.device)

    def traces(n):
        return {k: torch.empty((n,) + tuple(start[k].shape), dtype=start[k].dtype,
                               device=start[k].device) for k in gjob.monitor}

    def graph_sweeps(n):
        buffers, j = traces(n), job(n)
        end = graphs.sweep_blocks(j, start, stream, n, buffers)
        return _flat("final", {k: end[k] for k in j._carry_keys()}) + _flat("trace", buffers)

    def eager_sweeps(n):
        buffers, j = traces(n), job(n)
        end = j._sweeps(start, stream, buffers, {})
        return _flat("final", {k: end[k] for k in j._carry_keys()}) + _flat("trace", buffers)

    g_out, g = _one_form(graph_sweeps, sweeps, device, GRAPH_PROFILE_SWEEPS)
    e_out, e = _one_form(eager_sweeps, sweeps, device, GRAPH_PROFILE_SWEEPS)
    _compare_forms("gibbs_rats", g_out, e_out, g, e)
    res["gibbs_rats"] = {"graph": g, "eager": e, "block_sweeps": graphs.SWEEPS_PER_BLOCK}
    for path, r in res.items():
        g, e = r["graph"], r["eager"]
        if torch.device(device).type == "cuda" and g["graph_replays"] <= 0:
            raise RuntimeError(f"phase 28 {path}: no graph was replayed")
        # the same work a step: the eager window's profiled device time
        busy = e.get("profiler_busy_ms_per_step", 0.0)
        steady = g.get("block_ms_median", 0.0) / r.get("block_steps", r.get("block_sweeps"))
        r.update(bits_equal=True, launches_equal=True,
                 speedup_wall=e["ms_per_step"] / g["ms_per_step"],
                 graph_ms_per_step_steady=steady,
                 idle_share_eager=1.0 - busy / e["ms_per_step"],
                 idle_share_graph=1.0 - busy / g["ms_per_step"],
                 idle_share_graph_steady=1.0 - busy / steady if steady else None,
                 profiler_sees_replays=g.get("profiler_kernels_per_step", 0.0)
                 / max(e.get("profiler_kernels_per_step", 0.0), 1e-9))
    res["seconds"] = time.perf_counter() - t_phase
    print(f"# phase 28 (graphs against eager): {json.dumps(res)}", flush=True)
    return res


# ---------------------------------------------- phase 30: the LGCP, D = 4096
def run_lgcp_graphs_vs_eager(device="cuda", grid=LGCP_GRID, chains=LGCP_CHAINS,
                             burnin=LGCP_BURNIN, post=LGCP_POST):
    """Phase 30: the LGCP job twice (graph units, eager loop) from one start
    and run key; bit for bit, with equal evaluation and K2 counts.  Then
    K1's wide form at D = 129 and 200 against float64."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.core import target as core_target
    from klara_tpu_torch.jobs import graphs
    from klara_tpu_torch.models import lgcp
    from klara_tpu_torch.models.examples import synthetic_logistic_regression
    from klara_tpu_torch.ops import keyed, logreg

    t0 = time.perf_counter()
    target, counts, _ = lgcp.lgcp_grid(grid, device=device)
    _sync(device)
    res = {"grid": grid, "dim": grid * grid, "chains": chains, "counts": int(counts.sum()),
           "target_s": time.perf_counter() - t0}

    def run():
        sampler = kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=0.5, jitter=0.9,
                         jitter_style="step", max_nleaps=128)
        job = kt.MCJob(target, sampler, kt.MCRange(n_steps=burnin + post, burnin=burnin),
                       tuner=kt.DualAveragingTuner(0.8, burnin, gamma=0.05, t0=10, kappa=0.75),
                       n_chains=chains, monitor=("value",), diagnostics=("accept", "nleaps"),
                       pooled_tuning=True, mass_adaptation=True, mass_period=50,
                       traj_adaptation=True, traj_lr=0.1, traj_start_frac=0.1, device=device)
        gen = torch.Generator(device=device).manual_seed(30)
        z0 = torch.randn(chains, grid * grid, generator=gen, device=device)
        _k2_reset()
        evals, k1 = core_target.FACTOR_EVALUATIONS, logreg.KERNEL_LAUNCHES
        _sync(device)
        start = time.perf_counter()
        chain, timings = job.run_phased(gen, z0)
        _sync(device)
        out = {"wall_s": time.perf_counter() - start, **timings,
               "evals": core_target.FACTOR_EVALUATIONS - evals, "k2": keyed.KERNEL_LAUNCHES,
               "k2_by_mode": {m: n for m, n in keyed.LAUNCHES_BY_MODE.items() if n},
               "k1": logreg.KERNEL_LAUNCHES - k1, **_graph_counts()}
        named = (_flat("final", chain.final_state) + _flat("trace", chain.samples)
                 + _flat("diag", chain.diagnostics))
        return named, out

    g_out, g = run()
    kind = graphs.sampling_kind
    graphs.sampling_kind = lambda job: None
    try:
        e_out, e = run()
    finally:
        graphs.sampling_kind = kind
    if g["graph_replays"] <= 0 or e["graph_replays"] != 0:
        raise RuntimeError(f"phase 30: graph replays {g['graph_replays']} (graph form), "
                           f"{e['graph_replays']} (eager form)")
    if g["k1"] or e["k1"]:
        raise RuntimeError("phase 30: the LGCP job launched K1")
    for key in ("evals", "k2", "k2_by_mode"):
        if g[key] != e[key]:
            raise RuntimeError(f"phase 30: {key} {g[key]} (graph) against {e[key]} (eager)")
    if [n for n, _ in g_out] != [n for n, _ in e_out]:
        raise RuntimeError("phase 30: the two forms give different tensors")
    for (name, a), (_, b) in zip(g_out, e_out):
        if not _bits_equal(a, b):
            raise RuntimeError(f"phase 30: {name} differs between the graph and eager runs")
    res.update(graph=g, eager=e,
               graph_us_per_eval=1e6 * g["wall_s"] / max(1, g["evals"]))
    del g_out, e_out

    for dim in (129, 200):
        wide, X, y = synthetic_logistic_regression(dim=dim, n_data=1000, device=device)
        P = 0.05 * torch.randn(250, dim, generator=torch.Generator(device=device).manual_seed(2),
                               device=device)
        Xd, yd, Pd = X.double(), y.double(), P.double()
        logits = Pd @ Xd.T
        rv = (logits @ yd - torch.nn.functional.softplus(logits).sum(-1)
              - 0.5 * ((Pd * Pd).sum(-1) / 100.0 + dim * math.log(2.0 * math.pi * 100.0)))
        rg = (yd - torch.sigmoid(logits)) @ Xd - Pd / 100.0
        k1 = logreg.KERNEL_LAUNCHES
        v, grad = wide.logdensity_and_grad(P)
        launched = logreg.KERNEL_LAUNCHES - k1
        prepared = logreg.prepare_x(X, y)
        v1, g1 = logreg.logreg_value_grad(P, X, (X.T @ y).contiguous(), 100.0, passes=1,
                                          prepared=prepared)
        _sync(device)

        def rel(a, b):
            return float((a.double() - b).abs().max() / b.abs().max())

        errs = (rel(v, rv), rel(grad, rg))
        tf32 = (rel(v1, rv), rel(g1, rg))
        res[f"wide_logreg_d{dim}"] = {"rel_err": errs, "tf32_rel_err": tf32,
                                      "k1_launches": launched}
        if launched != 1:
            raise RuntimeError(f"phase 30: the D = {dim} logreg launched K1 {launched} times")
        if max(errs) > WIDE_LOGREG_TOL or max(tf32) > WIDE_TF32_TOL:
            raise RuntimeError(f"phase 30: K1's wide form at D = {dim} is off float64 by "
                               f"{errs} (f32), {tf32} (TF32)")
    # its time at C = 16384, D = 256, N = 1024 beside the least the FP32
    # cores need for the two products' useful work (4·C·N·D operations at
    # 67 TFLOP/s) and beside the plain version's
    C, dim, n = WIDE_TIMED
    _, X, y = synthetic_logistic_regression(dim=dim, n_data=n, device=device)
    P = 0.05 * torch.randn(C, dim, generator=torch.Generator(device=device).manual_seed(3),
                           device=device)
    prepared, v = logreg.prepare_x(X, y), (X.T @ y).contiguous()
    res["wide_timed"] = {
        "shape": WIDE_TIMED,
        "k1_ms": _time_ms(lambda: logreg.logreg_value_grad(P, X, v, 100.0, prepared=prepared),
                          iters=20),
        "plain_ms": _time_ms(lambda: logreg.logreg_value_grad_reference(P, X, v, 100.0),
                             iters=20),
        "fp32_bound_ms": 1e3 * 4.0 * C * n * dim / 67e12,
    }
    print(f"# phase 30 (the LGCP, graphs against eager): {json.dumps(res)}", flush=True)
    return res


def run_gibbs_nested(conj_summary, device="cuda", chains=GIBBS_CHAINS, sweeps=NESTED_SWEEPS,
                     burnin=NESTED_BURNIN):
    """Phase 11: MCMC-within-Gibbs on the card, against phase 9's posterior."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import rats_gibbs_model
    from klara_tpu_torch.ops import logreg

    model, v0 = rats_gibbs_model(device=device, nested_alpha=True)
    spec = kt.Nested(kt.HMC(leapstep=0.05, nleaps=4), n_steps=4,
                     tuner=kt.DualAveragingTuner(0.8, 4))
    job = kt.GibbsJob(model, {"alpha": spec}, kt.MCRange(n_steps=sweeps, burnin=burnin),
                      n_chains=chains, monitor=GIBBS_MONITOR, device=device)
    if not job._needs_step_hoist(job.sweep["alpha"]):
        raise RuntimeError("the nested HMC block does not take the hoisted step-size search")
    gen = torch.Generator(device=device).manual_seed(1)
    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    out, secs = _timed_gibbs(job, gen, v0, device)
    launches, k2 = logreg.KERNEL_LAUNCHES, _k2_launches()
    for v in (*out.samples.values(), out["alpha.accept"]):
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError("non-finite draws in the nested rats trace")
    summary = _gibbs_summary(out)
    rhat = max(s["rhat"] for s in summary.values())
    accept = float(out["alpha.accept"].to(torch.float64).mean())
    se = {k: summary[k]["sd"] / math.sqrt(summary[k]["ess"]) for k in JAX_NESTED}
    z_conj = {k: abs(summary[k]["mean"] - conj_summary[k]["mean"]) / math.hypot(
        se[k], conj_summary[k]["sd"] / math.sqrt(conj_summary[k]["ess"])) for k in JAX_NESTED}
    z_jax = {k: abs(summary[k]["mean"] - m) / math.hypot(se[k], s)
             for k, (m, s) in JAX_NESTED.items()}
    res = {
        "seconds": secs,
        "sweeps_per_sec": sweeps / secs,
        "ms_per_sweep": 1e3 * secs / sweeps,
        "min_ess": min(s["ess"] for s in summary.values()),
        "rhat_max": rhat,
        "alpha_accept": accept,
        "mean_z_vs_conjugate": z_conj,
        "mean_z_vs_jax_nested": z_jax,
        "k1_launches": launches,
        "k2_launches": k2,
        "by_key": summary,
    }
    print(f"# gibbs_rats_nested {chains} chains x {sweeps} sweeps: {json.dumps(res)}",
          flush=True)
    if rhat > RHAT_GATE:
        raise RuntimeError(f"nested rats rank-R-hat {rhat} > {RHAT_GATE}")
    if not NESTED_ACCEPT_RANGE[0] <= accept <= NESTED_ACCEPT_RANGE[1]:
        raise RuntimeError(f"nested alpha acceptance {accept} outside {NESTED_ACCEPT_RANGE}")
    if max(z_conj["alpha_c"], z_conj["beta_c"]) > MEAN_Z_GATE:
        raise RuntimeError(f"nested and conjugate rats means differ: {z_conj} se")
    if max(z_jax.values()) > MEAN_Z_GATE:
        raise RuntimeError(f"nested rats means differ from the JAX package's: {z_jax} se")
    return res


# ------------------------------------------------------------------ the zoo
@contextlib.contextmanager
def _host_reads():
    """Count the host reads of the block: under sync debug mode 'warn' every
    operation that makes the host wait for the device emits one warning.
    Yields a list that holds, after the block, the count and the source lines
    that made them."""
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    out = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    reads = [w for w in caught if "synchronizing cuda operation" in str(w.message).lower()]
    out.extend([len(reads), sorted({f"{os.path.basename(w.filename)}:{w.lineno}" for w in reads})])


def _count_host_reads(fn):
    """Run ``fn`` once uncounted (the first call of an operation may set up a
    library handle), then once under ``_host_reads``.  Returns the count and
    the source lines that made them."""
    torch.cuda.synchronize()
    fn()
    with _host_reads() as got:
        fn()
    return got[0], got[1]


def _profile_device(fn):
    """``fn`` under torch.profiler: the number of device kernels it launched,
    their summed time in ms, and the three kernel names that took most of it
    with their shares."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return len(kernels), busy / 1e3, [[k[:60], round(v / busy, 3)] for k, v in top]


def run_zoo_sampler(name, target, sampler, x0, ref_summary, *, burnin, post, thinning=1,
                    tuner=None, pooled=False, step_size=None, diagnostics=("accept",),
                    data=None, accept_gate=None, sd_gate=None, probe_steps=2):
    """One sampler of the zoo through ``MCJob.run_phased`` from the stationary
    positions ``x0``.  Reports ms per step, K1
    launches, host reads per step (counted on ``probe_steps`` further steps
    under sync debug mode 'warn'), device kernels and busy time per step (the
    same number of steps under torch.profiler), the acceptance, and how far
    the chains mixed (split-chain rank-R̂, min ESS).  Returns (results, chain, failures):

    * invariance: every posterior mean over the run within ``MEAN_Z_GATE``
      combined standard errors of ``ref_summary``'s (per-dim mean, sd, ESS in
      x space: phase 4's), the run's standard error taken across the chains'
      own means (the chains start from independent stationary draws, so this
      holds however slowly a chain moves), every posterior sd within
      ``sd_gate`` of the reference's (default: ``MEAN_Z_GATE`` standard errors
      of an sd estimated from as many independent draws as there are chains),
      and rank-R̂ between the ensemble's distributions at the saved times
      under the gate;
    * the post-burnin acceptance in ``accept_gate`` (lo, hi).

    With ``data`` (X, y) K1 is held against its plain version on the final
    positions."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.ops import logreg
    from klara_tpu_torch.samplers import slice_sampler

    chains, dim = x0.shape
    n_steps = burnin + post
    job = kt.MCJob(
        target, sampler, kt.MCRange(n_steps=n_steps, burnin=burnin, thinning=thinning),
        tuner=tuner, n_chains=chains, monitor=("value",), diagnostics=diagnostics,
        pooled_tuning=pooled, step_size=step_size,
    )
    gen = torch.Generator(device=x0.device).manual_seed(7)
    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    slice_sampler.HOST_READS = 0
    chain, timings = job.run_phased(gen, x0)
    launches, counted_reads = logreg.KERNEL_LAUNCHES, slice_sampler.HOST_READS
    k2 = _k2_launches()

    values = chain.value
    if not bool(torch.isfinite(values).all()):
        raise RuntimeError(f"{name}: non-finite draws in the trace")
    mean, sd, ess = _x_summary(values, None, _chunk(values.shape[0], dim))
    se2 = values.to(torch.float32).mean(0).to(torch.float64).var(0) / chains
    accept = chain["accept"].to(torch.float32)
    end = chain.final_state
    state = [end]

    def probe():
        for _ in range(probe_steps):
            state[0], _ = job.sampler.step(state[0], job.target, gen)

    m0, sd0, ess0 = ref_summary
    n_reads, read_sites = _count_host_reads(probe)
    n_kernels, busy_ms, top_kernels = _profile_device(probe)
    ms_per_step = 1e3 * timings["sampling_seconds"] / post
    res = {
        "chains": chains,
        "burnin": burnin,
        "post": post,
        "thinning": thinning,
        "warmup_seconds": timings["warmup_seconds"],
        "sampling_seconds": timings["sampling_seconds"],
        "ms_per_step": ms_per_step,
        "k1_launches": launches,
        "k2_launches": k2,
        "host_reads_per_step": n_reads / probe_steps,
        "host_read_sites": read_sites,
        # probe_steps further steps under torch.profiler; the idle share sets their
        # device time against the unprofiled sampling steps' wall time
        "device_kernels_per_step": n_kernels / probe_steps,
        "device_busy_ms_per_step": busy_ms / probe_steps,
        "idle_share_est": 1.0 - busy_ms / probe_steps / ms_per_step,
        "device_top_kernels": top_kernels,
        "acceptance": float(accept.mean()),
        "acceptance_last_quarter": float(accept[-max(accept.shape[0] // 4, 1):].mean()),
        "max_mean_z_vs_chees": float(
            ((mean - m0).abs() / torch.sqrt(se2 + sd0**2 / ess0)).max()),
        "rhat_over_time_max": _rhat_max(values, None, over_time=True),
        "sd_ratio_to_chees_range": [float((sd / sd0).min()), float((sd / sd0).max())],
        # how far the chains mixed: not gated
        "rhat_split_chain_max": _rhat_max(values, None),
        "min_ess": float(ess.min()),
        "ess_per_sec": float(ess.min()) / timings["sampling_seconds"],
        "max_mean_z_ess_based": float(
            ((mean - m0).abs() / torch.sqrt(sd**2 / ess + sd0**2 / ess0)).max()),
    }
    if isinstance(sampler, kt.SliceSampler):
        res["counted_host_reads_per_sweep"] = counted_reads / n_steps
    if hasattr(end, "tune") and not sampler.self_tuning:
        res["step_final"] = float(end.tune.step.mean())
    if data is not None:
        res["k1_max_abs_err_on_path"] = _k1_error(end.position.contiguous(), *data)

    failures = []
    if res["rhat_over_time_max"] > RHAT_GATE:
        failures.append(f"zoo {name}: rank-R-hat over time {res['rhat_over_time_max']} > "
                        f"{RHAT_GATE}")
    if res["max_mean_z_vs_chees"] > MEAN_Z_GATE:
        failures.append(f"zoo {name}: posterior means differ from chees_precond's by "
                        f"{res['max_mean_z_vs_chees']} se")
    lo, hi = res["sd_ratio_to_chees_range"]
    if sd_gate is None:
        sd_gate = MEAN_Z_GATE / math.sqrt(2.0 * chains)
    res["sd_ratio_gate"] = sd_gate
    if lo < 1.0 - sd_gate or hi > 1.0 + sd_gate:
        failures.append(f"zoo {name}: posterior sds are {lo}..{hi} of chees_precond's")
    if accept_gate is not None and not accept_gate[0] <= res["acceptance"] <= accept_gate[1]:
        failures.append(f"zoo {name}: acceptance {res['acceptance']} outside {accept_gate}")
    return res, chain, failures


def run_zoo_logreg(x_end, ref_summary, device="cuda", chains=ZOO_CHAINS, dim=DIM,
                   n_data=N_DATA, steps=None):
    """The sampler zoo on the bench logreg target, from phase 4's final
    positions in x space (``x_end``; stationary draws) against phase 4's
    posterior (``ref_summary``).  ``steps`` overrides ``ZOO_STEPS``.  Every
    sampler runs and prints; the failures of all are raised together at
    the end.  Returns {name: results}."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import synthetic_logistic_regression

    steps = {**ZOO_STEPS, **(steps or {})}
    target, X, y = synthetic_logistic_regression(dim=dim, n_data=n_data, device=device)
    x0 = x_end[:chains].contiguous()
    cov = torch.cov(x_end.T)
    var = torch.diagonal(cov)
    sd = torch.sqrt(var)
    # conditional sd of each coordinate given the others, from the ensemble's precision
    cond_sd = torch.rsqrt(torch.diagonal(torch.linalg.inv(cov)))
    eig = torch.linalg.eigvalsh(cov)
    print(f"# zoo start: ensemble sd {float(sd.min()):.4f}..{float(sd.max()):.4f}, conditional "
          f"sd {float(cond_sd.min()):.4f}..{float(cond_sd.max()):.4f}, covariance condition "
          f"number {float(eig[-1] / eig[0]):.1f}", flush=True)
    out, failures = {}, []

    def run(name, sampler, x0=x0, **kw):
        cfg = {k: v for k, v in steps[name].items() if k != "chains"}
        res, chain, failed = run_zoo_sampler(name, target, sampler, x0, ref_summary,
                                             **cfg, **kw)
        out[name] = res
        failures.extend(failed)
        return res, chain

    def show(name):
        print(f"# zoo {name} {out[name]['chains']}x{dim}x{n_data}: {json.dumps(out[name])}",
              flush=True)

    # MALA: one K1 launch a step, pooled dual averaging on the 0/1 acceptance
    for name, at in (("mala", x0), ("mala_16384", x_end)):
        b = steps[name]["burnin"]
        res, chain = run(name, kt.MALA(), x0=at, tuner=kt.DualAveragingTuner(MALA_RATE, b),
                         pooled=True, step_size=0.005, data=(X, y),
                         accept_gate=(MALA_RATE - 0.05, MALA_RATE + 0.05))
        res["k1_launches_expected"] = b + steps[name]["post"] + 1
        show(name)
        if res["k1_launches"] != res["k1_launches_expected"]:
            failures.append(f"zoo {name}: {res['k1_launches']} K1 launches, expected one a "
                            f"step and one at init: {res['k1_launches_expected']}")
        del chain

    run("ram", kt.RAM(S0=0.1), accept_gate=(0.234 - 0.05, 0.234 + 0.05))
    show("ram")
    # AM counts C0 as the covariance of its first t0 − 2 draws, so t0 = burnin keeps the
    # ensemble's scales while the chain's own history is short; until then it proposes
    # from the isotropic component, scaled like the core
    core = 2.38**2 / dim
    run("am", kt.AM(C0=var, corescale=core, minorscale=core * float(var.mean()),
                    t0=steps["am"]["burnin"]), accept_gate=(0.05, 1.0), sd_gate=AM_SD_GATE)
    show("am")

    # AMWG: logσ moves by δ = 0.01 per 50 sweeps, 0.2 per 1000 sweeps, so it starts
    # where the Roberts-Rosenthal rule is heading: 2.38 conditional sds
    res, chain = run("amwg", kt.AMWG(period=50), step_size=2.38 * cond_sd,
                     diagnostics=("accept", "accept_vec"))
    vec = chain["accept_vec"]
    by_coord = vec[-max(vec.shape[0] // 4, 1):].mean((0, 1))
    res["coordinate_rate_mean_last_quarter"] = float(by_coord.mean())
    res["coordinate_rate_range_last_quarter"] = [float(by_coord.min()), float(by_coord.max())]
    res["logsigma_shift_mean"] = float(
        (chain.final_state.tune.step - torch.log(2.38 * cond_sd)).mean())
    show("amwg")
    if abs(res["coordinate_rate_mean_last_quarter"] - 0.44) > 0.1:
        failures.append(f"zoo amwg: mean per-coordinate rate "
                        f"{res['coordinate_rate_mean_last_quarter']} is not 0.44 ± 0.1")
    del chain, vec

    run("slice", kt.SliceSampler(widths=sd), accept_gate=(0.99, 1.0))
    show("slice")

    # SMMALA: value and gradient through K1, the tensor through autograd's Hessian
    b = steps["smmala"]["burnin"]
    n_sm = steps["smmala"].get("chains", chains)
    res, chain = run("smmala", kt.SMMALA(driftstep=0.005), x0=x_end[:n_sm].contiguous(),
                     tuner=kt.DualAveragingTuner(MALA_RATE, b), pooled=True, data=(X, y))
    show("smmala")
    if res["k1_launches"] <= 0:
        failures.append("zoo smmala launched no K1 kernel")
    del chain
    if failures:
        raise RuntimeError("; ".join(failures))
    return out


def run_zoo_ars(device="cuda", chains=ZOO_CHAINS, dim=DIM, steps=ARS_STEPS):
    """ARS on the 100-dim normal with the envelope N(0, 2²·I) (scale 0: logπ −
    logq = −⅜‖x‖² ≤ 0 everywhere).  At this width every valid envelope
    accepts a jump to x' with probability e^{−⅜‖x'‖²}, so the chains stay
    near the start; the run checks what holds at any width: the accepted
    share equals the mean acceptance probability, and the carried
    log-target is the target's at the final positions."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import normal_target
    from klara_tpu_torch.ops import logreg

    target = normal_target(dim)
    ars = kt.ARS(logproposal=lambda x: -0.5 * torch.square(x / 2.0).sum(-1),
                 proposalscale=0.0, jumpscale=0.05)
    job = kt.MCJob(target, ars, kt.MCRange(n_steps=steps, burnin=0), n_chains=chains,
                   monitor=("value", "logtarget"), diagnostics=("accept", "accept_stat", "weight"))
    gen = torch.Generator(device=device).manual_seed(7)
    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    chain, timings = job.run_phased(gen, torch.zeros(chains, dim, device=device))
    k2 = _k2_launches()
    accept = chain["accept"].to(torch.float64)
    stat = chain["accept_stat"].to(torch.float64)
    n = accept.numel()
    se = float(torch.sqrt(stat.mean() * (1 - stat.mean()) / n))
    end = chain.final_state
    res = {
        "chains": chains, "steps": steps,
        "ms_per_step": 1e3 * timings["sampling_seconds"] / steps,
        "k1_launches": logreg.KERNEL_LAUNCHES,
        "k2_launches": k2,
        "acceptance": float(accept.mean()),
        "mean_accept_stat": float(stat.mean()),
        "accept_minus_stat_in_se": float((accept.mean() - stat.mean()).abs()) / se,
        "acceptance_first_10_steps": float(accept[:10].mean()),
        "acceptance_last_10_steps": float(accept[-10:].mean()),
        "mean_sq_norm_final": float(torch.square(end.position).sum(-1).mean()),
        "logtarget_max_abs_err": float(
            (end.logtarget - target.logdensity(end.position)).abs().max()),
    }
    print(f"# zoo ars {chains}x{dim} normal: {json.dumps(res)}", flush=True)
    if not bool(torch.isfinite(chain.value).all()):
        raise RuntimeError("zoo ars: non-finite draws")
    if tuple(chain.value.shape) != (steps, chains, dim):
        raise RuntimeError(f"zoo ars: trace shape {tuple(chain.value.shape)}")
    if res["accept_minus_stat_in_se"] > MEAN_Z_GATE:
        raise RuntimeError(f"zoo ars: accepted share {res['acceptance']} is not the mean "
                           f"acceptance probability {res['mean_accept_stat']}")
    if res["logtarget_max_abs_err"] > 1e-3 or not 0.0 < res["acceptance"] < 1.0:
        raise RuntimeError(f"zoo ars: {res}")
    return res


MONITOR_SLOTS = (
    "value", "logtarget", "loglikelihood", "logprior",
    "gradlogtarget", "gradloglikelihood", "gradlogprior",
    "tensorlogtarget", "tensorloglikelihood", "tensorlogprior",
    "dtensorlogtarget", "dtensorloglikelihood", "dtensorlogprior",
)


def check_monitor_slots(device="cuda", chains=64, draws=50):
    """All 13 monitored slots on the swiss target (D=4) under MALA: each is
    recorded with its shape, finite, and the target's slots are the sums of
    the likelihood's and the prior's."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import swiss_logistic_regression
    from klara_tpu_torch.ops import logreg

    target, _, _ = swiss_logistic_regression(device=device)
    d = target.dim
    job = kt.MCJob(target, kt.MALA(driftstep=0.05), kt.MCRange(n_steps=draws + 10, burnin=10),
                   n_chains=chains, monitor=MONITOR_SLOTS)
    gen = torch.Generator(device=device).manual_seed(3)
    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    chain = job.run(gen, 0.1 * torch.randn(chains, d, generator=gen, device=device))
    _sync(device)
    k2 = _k2_launches()
    for f in MONITOR_SLOTS:
        rank = (0 if f.startswith("log") else 1 if f.startswith("grad") or f == "value"
                else 2 if f.startswith("tensor") else 3)
        want = (draws, chains) + (d,) * rank
        if tuple(chain[f].shape) != want or not bool(torch.isfinite(chain[f]).all()):
            raise RuntimeError(f"monitor slot {f}: shape {tuple(chain[f].shape)}, want {want}, "
                               "or non-finite")
        if chain[f].device.type != torch.device(device).type:
            raise RuntimeError(f"monitor slot {f} is on {chain[f].device}, not on {device}")
    errs = {}
    for pre, tol in (("log", 1e-3), ("gradlog", 1e-3), ("tensorlog", 1e-4), ("dtensorlog", 1e-4)):
        whole, parts = chain[pre + "target"], chain[pre + "likelihood"] + chain[pre + "prior"]
        errs[pre + "target"] = float((whole - parts).abs().max())
        torch.testing.assert_close(whole, parts, rtol=1e-4, atol=tol)
    res = {"chains": chains, "draws": draws, "k1_launches": logreg.KERNEL_LAUNCHES,
           "k2_launches": k2,
           "acceptance": float(chain["accept"].to(torch.float32).mean()),
           "max_abs_err_target_minus_parts": errs}
    print(f"# 13 monitor slots on swiss {chains}x{d}: {json.dumps(res)}", flush=True)
    if res["k1_launches"] != draws + 10 + 1:
        raise RuntimeError(f"monitor check: {res['k1_launches']} K1 launches, expected "
                           f"{draws + 10 + 1}")
    return res


# ---------------------------------------------------------- the output layer
def _same(a, b) -> bool:
    """Bit-for-bit equality of two states (NamedTuples and tuples of tensors)."""
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, tuple):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


def _flushes(n_steps, burnin, thinning, chunk):
    """The chunks of a csv run that save at least one draw: each costs the
    stream one device→host copy per field and one host read."""
    chunk = max(1, min(chunk, n_steps))
    return len({i // chunk for i in range(burnin, n_steps, thinning)})


def _dir_mb(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e6


@contextlib.contextmanager
def _timed_writer(spent):
    """Add to ``spent`` the seconds in ``StreamingWriter.append_block``
    ('write': conversion, formatting and file writes), in the ``%.9g``
    formatting alone ('format') and in ``DrawRing.take`` ('take': the
    device→host copies and the wait for the chunk's steps)."""
    from klara_tpu_torch.io import stream

    saved = (stream.StreamingWriter.append_block, stream.format_rows, stream.DrawRing.take)

    def timed(fn, key):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
        return wrapper

    stream.StreamingWriter.append_block = timed(saved[0], "write")
    stream.format_rows = timed(saved[1], "format")
    stream.DrawRing.take = timed(saved[2], "take")
    try:
        yield spent
    finally:
        stream.StreamingWriter.append_block, stream.format_rows, stream.DrawRing.take = saved


def _counted(fn):
    """``fn()`` under ``_host_reads``, ended by a synchronise: (its result,
    [host reads, their sources], seconds)."""
    with _host_reads() as reads:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return out, reads, secs


def _mala_io_job(target, chains, n_steps, burnin, **kw):
    import klara_tpu_torch as kt

    return kt.MCJob(target, kt.MALA(), kt.MCRange(n_steps=n_steps, burnin=burnin),
                    tuner=kt.DualAveragingTuner(MALA_RATE, IO_BURNIN), n_chains=chains,
                    monitor=("value", "logtarget"), diagnostics=("accept",),
                    pooled_tuning=True, step_size=0.005, **kw)


def run_io_stream(x_end, tmp, device="cuda", chains=ZOO_CHAINS, dim=DIM, n_data=N_DATA,
                  burnin=IO_BURNIN, post=IO_POST, chunk=IO_CHUNK):
    """Phase 21: MALA on the bench target streamed to CSV under ``tmp``,
    against its nstate twin; then the verbose runs and ``trace_profile``.
    Returns (results, twin job, twin chain, twin's generator, (X, y))."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import synthetic_logistic_regression
    from klara_tpu_torch.ops import logreg
    from klara_tpu_torch.utils import trace_profile

    target, X, y = synthetic_logistic_regression(dim=dim, n_data=n_data, device=device)
    x0 = x_end[:chains].contiguous()
    n_steps = burnin + post
    csv_dir = os.path.join(tmp, "mala")
    job = _mala_io_job(target, chains, n_steps, burnin, destination="csv", filepath=csv_dir,
                       stream_chunk=chunk)
    spent = {"write": 0.0, "format": 0.0, "take": 0.0}
    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    with _timed_writer(spent):
        chain, reads, csv_secs = _counted(
            lambda: job.run(torch.Generator(device=device).manual_seed(IO_SEED), x0))
    launches, k2 = logreg.KERNEL_LAUNCHES, _k2_launches()

    twin_job = _mala_io_job(target, chains, n_steps, burnin)
    gen = torch.Generator(device=device).manual_seed(IO_SEED)
    twin, twin_reads, twin_secs = _counted(lambda: twin_job.run(gen, x0))

    t0 = time.perf_counter()
    back = kt.io.read_chain(csv_dir, device=device)
    torch.cuda.synchronize()
    read_secs = time.perf_counter() - t0
    mb = _dir_mb(csv_dir)
    flushes = _flushes(n_steps, burnin, 1, chunk)
    failures = []
    if chain.samples or chain.diagnostics:
        failures.append("a csv run returned a device trace")
    if set(back.samples) != {"value", "logtarget"} or set(back.diagnostics) != {"accept"}:
        failures.append(f"read back {sorted(back.samples)} / {sorted(back.diagnostics)}")
    for k in ("value", "logtarget", "accept"):
        if tuple(back[k].shape) != tuple(twin[k].shape) or not torch.equal(
                back[k].to(twin[k].dtype), twin[k]):
            failures.append(f"streamed {k} differs from the nstate twin's trace")
    if not _same(chain.final_state, twin.final_state):
        failures.append("the csv run's final state differs from the nstate twin's")
    if job._ring.bufs["value"].device.type != "cuda":
        failures.append(f"the stream's ring lives on {job._ring.bufs['value'].device}")
    if reads[0] - twin_reads[0] != flushes:
        failures.append(f"the stream added {reads[0] - twin_reads[0]} host reads, not one per "
                        f"flush ({flushes}): {reads[1]}")
    if launches != n_steps + 1:
        failures.append(f"{launches} K1 launches, expected one a step and one at init")

    # verbose: two progress lines and two reads more than the same run without
    progress = {}
    for verbose in (False, True):
        out = io.StringIO()
        vjob = _mala_io_job(target, chains, IO_VERBOSE_STEPS, IO_VERBOSE_STEPS // 2,
                            verbose=verbose, progress_period=IO_PERIOD)
        with contextlib.redirect_stdout(out):
            _, r, _ = _counted(
                lambda: vjob.run(torch.Generator(device=device).manual_seed(IO_SEED), x0))
        lines = [ln for ln in out.getvalue().splitlines() if ln.endswith("% acceptance rate")]
        progress[verbose] = (r[0], lines)
        for ln in lines:
            print(f"# {ln}", flush=True)
    want_lines = IO_VERBOSE_STEPS // IO_PERIOD
    if len(progress[True][1]) != want_lines or progress[False][1]:
        failures.append(f"progress lines: {progress}")
    if progress[True][0] - progress[False][0] != want_lines:
        failures.append(f"verbose added {progress[True][0] - progress[False][0]} host reads, "
                        f"not {want_lines}")
    if progress[False][0] != twin_reads[0]:
        failures.append(f"{progress[False][0]} host reads in {IO_VERBOSE_STEPS} quiet steps, "
                        f"{twin_reads[0]} in {n_steps}: a read per step")

    trace_dir = os.path.join(tmp, "trace")
    with trace_profile(trace_dir, label="io_mala"):
        _mala_io_job(target, chains, 10, 5).run(torch.Generator(device=device).manual_seed(1), x0)
    with open(os.path.join(trace_dir, "io_mala.trace.json")) as f:
        k1_events = sum("logreg_value_grad_kernel" in e.get("name", "")
                        for e in json.load(f)["traceEvents"])
    if k1_events < 10:
        failures.append(f"trace_profile's trace holds {k1_events} K1 kernels, not 11")

    res = {
        "chains": chains, "burnin": burnin, "post": post, "stream_chunk": chunk,
        "csv_seconds": csv_secs,
        "nstate_twin_seconds": twin_secs,
        "mb_written": mb,
        "writer_seconds": spent["write"],
        "writer_mb_per_s": mb / spent["write"],
        "format_seconds": spent["format"],
        "take_seconds": spent["take"],
        "read_back_seconds": read_secs,
        "flushes": flushes,
        "host_reads_csv": reads[0],
        "host_reads_twin": twin_reads[0],
        "host_read_sites_csv": reads[1],
        "host_reads_quiet_50": progress[False][0],
        "host_reads_verbose_50": progress[True][0],
        "trace_profile_k1_kernels": k1_events,
        "acceptance": float(twin["accept"].to(torch.float32).mean()),
        "k1_launches": launches,
        "k1_max_abs_err_on_path": _k1_error(chain.final_state.position.contiguous(), X, y),
        "k2_launches": k2,
    }
    print(f"# io_stream_mala {chains}x{dim}x{n_data}: {json.dumps(res)}", flush=True)
    if failures:
        raise RuntimeError("; ".join(failures))
    return res, twin_job, twin, gen, (X, y)


def run_io_resume(job, twin, gen, data, tmp, device="cuda"):
    """Phase 22: checkpoint the twin's final state and generator, resume from
    the live ones and from the file; the two must agree bit for bit."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.ops import logreg

    path = os.path.join(tmp, "mala.npz")
    t0 = time.perf_counter()
    kt.io.save_checkpoint(path, {"state": twin.final_state, "generator": gen})
    save_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = kt.io.load_checkpoint(path, like={"state": twin.final_state,
                                             "generator": torch.Generator(device=device)})
    torch.cuda.synchronize()
    load_secs = time.perf_counter() - t0
    failures = []
    state = tree["state"]
    if not _same(state, twin.final_state):
        failures.append("the state read back differs from the one saved")
    if state.position.device.type != "cuda" or tree["generator"].device.type != "cuda" or (
            state.position.data_ptr() == twin.final_state.position.data_ptr()):
        failures.append("the checkpoint did not load into fresh card tensors and generator")

    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    live = job.resume(gen, twin)
    again = job.resume(tree["generator"], dataclasses.replace(twin, final_state=state))
    torch.cuda.synchronize()
    launches, k2 = logreg.KERNEL_LAUNCHES, _k2_launches()
    for k in ("value", "logtarget", "accept"):
        if not torch.equal(live[k], again[k]):
            failures.append(f"the resumed {k} traces differ")
    if not _same(live.final_state, again.final_state):
        failures.append("the resumed final states differ")
    if launches != 2 * job.mcrange.n_steps:
        failures.append(f"{launches} K1 launches in two resumes, expected one a step")
    res = {
        "checkpoint_mb": os.path.getsize(path) / 1e6,
        "save_seconds": save_secs,
        "load_seconds": load_secs,
        "resume_acceptance": float(again["accept"].to(torch.float32).mean()),
        "k1_launches": launches,
        "k1_max_abs_err_on_path": _k1_error(again.final_state.position.contiguous(), *data),
        "k2_launches": k2,
    }
    print(f"# io_resume_mala: {json.dumps(res)}", flush=True)
    if failures:
        raise RuntimeError("; ".join(failures))
    return res


def run_io_gibbs(tmp, device="cuda", chains=GIBBS_CHAINS, sweeps=IO_GIBBS_SWEEPS,
                 burnin=IO_GIBBS_BURNIN, chunk=IO_GIBBS_CHUNK):
    """Phase 23: the conjugate rats model with two variables streamed to CSV,
    run and resumed, against an all-nstate twin of the same seed."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import rats_gibbs_model
    from klara_tpu_torch.ops import logreg

    model, v0 = rats_gibbs_model(device=device)
    dirs = {k: os.path.join(tmp, k) for k in IO_GIBBS_CSV}
    kw = dict(model=model, sweep={}, mcrange=kt.MCRange(n_steps=sweeps, burnin=burnin),
              n_chains=chains, monitor=GIBBS_MONITOR, device=device)
    job = kt.GibbsJob(**kw, stream_chunk=chunk,
                      outopts={k: {"destination": "csv", "filepath": d} for k, d in dirs.items()})
    twin = kt.GibbsJob(**kw)

    def both(j):
        gen = torch.Generator(device=device).manual_seed(5)
        first = j.run(gen, v0)
        return first, j.resume(gen, first, v0)

    spent = {"write": 0.0, "format": 0.0, "take": 0.0}
    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    with _timed_writer(spent):
        (first, second), reads, secs = _counted(lambda: both(job))
    launches, k2 = logreg.KERNEL_LAUNCHES, _k2_launches()
    (first_t, second_t), twin_reads, twin_secs = _counted(lambda: both(twin))
    n_post = kw["mcrange"].n_post
    flushes = 2 * _flushes(sweeps, burnin, 1, chunk)
    failures = []
    for k, d in dirs.items():
        back = kt.io.read_chain(d, device=device)[k]
        if tuple(back.shape) != (2 * n_post, chains):
            failures.append(f"{k} read back as {tuple(back.shape)}")
        elif not (torch.equal(back[:n_post].to(torch.float32), first_t.samples[k])
                  and torch.equal(back[n_post:].to(torch.float32), second_t.samples[k])):
            failures.append(f"streamed {k} differs from the nstate twin's trace")
        if k in first.samples:
            failures.append(f"csv variable {k} kept a device trace")
    for k in set(GIBBS_MONITOR) - set(IO_GIBBS_CSV):
        if not (torch.equal(first.samples[k], first_t.samples[k])
                and torch.equal(second.samples[k], second_t.samples[k])):
            failures.append(f"nstate variable {k} differs from the twin's")
    if any(not torch.equal(second.final_values[k], v) for k, v in second_t.final_values.items()):
        failures.append("final values differ from the twin's")
    if reads[0] - twin_reads[0] != flushes:
        failures.append(f"the stream added {reads[0] - twin_reads[0]} host reads, not one per "
                        f"flush ({flushes}): {reads[1]}")
    if launches:
        failures.append(f"the Gibbs csv path launched K1 {launches} times")
    mb = sum(_dir_mb(d) for d in dirs.values())
    res = {
        "chains": chains, "sweeps": sweeps, "burnin": burnin, "stream_chunk": chunk,
        "csv_seconds_run_and_resume": secs,
        "nstate_twin_seconds_run_and_resume": twin_secs,
        "mb_written": mb,
        "writer_seconds": spent["write"],
        "writer_mb_per_s": mb / spent["write"],
        "format_seconds": spent["format"],
        "take_seconds": spent["take"],
        "flushes": flushes,
        "host_reads_csv": reads[0],
        "host_reads_twin": twin_reads[0],
        "k1_launches": launches,
        "k2_launches": k2,
        "alpha_c_mean": float(second_t.samples["alpha_c"].to(torch.float64).mean()),
    }
    print(f"# io_gibbs_csv {chains} chains x {sweeps} sweeps x 2: {json.dumps(res)}", flush=True)
    if failures:
        raise RuntimeError("; ".join(failures))
    return res


# ------------------------------------------------------------- the examples
def _mean_mcse(x):
    """Pooled mean of a (draws, chains) trace and its Monte Carlo standard
    error, sd over the chain-summed ESS."""
    import klara_tpu_torch as kt

    x = x.to(torch.float32).reshape(x.shape[0], x.shape[1])
    return float(x.mean()), float(x.std() / kt.stats.ess(x).sqrt())


def _held(name, value, want, width):
    if not abs(value - want) <= width:
        raise RuntimeError(f"example {name}: {value} is not {want} ± {width}")
    return {"value": value, "want": want, "width": width}


def check_example_output(name, out, device="cuda"):
    """Phase 24's truth for the examples whose ``main()`` asserts nothing
    (as in the JAX package): Poisson mean λ and Gamma(2, 1) mean and
    variance within 5 MCSE, the bivariate Gibbs correlation 0.8 ± 0.05 and
    means within 5 MCSE of 0, the rats means against BUGS.  Every trace
    must live on ``device``.  The registry's other examples assert
    themselves."""
    traces = ([c["value"] for c in out.values()] if isinstance(out, dict)
              else list(out.samples.values()))
    where = {t.device.type for t in traces}
    if where != {torch.device(device).type}:
        raise RuntimeError(f"example {name}: traces on {where}, not {device}")
    got = {}
    if name == "poisson_mh":
        x = out["value"]
        if x.dtype != torch.int32 or int(x.min()) < 0:
            raise RuntimeError(f"poisson_mh: trace {x.dtype}, min {int(x.min())}")
        m, se = _mean_mcse(x)
        got["mean"] = _held(name, m, POISSON_LAM, 5 * se)
    elif name == "gamma_mh_truncation":
        mean, var = GAMMA_MOMENTS
        for label, chain in out.items():
            x = chain["value"]
            m, se = _mean_mcse(x)
            v, se_v = _mean_mcse(torch.square(x - x.mean()))
            got[label] = {"mean": _held(name, m, mean, 5 * se),
                          "var": _held(name, v, var, 5 * se_v),
                          "acceptance": float(chain["accept"].to(torch.float32).mean())}
    elif name == "bivariate_normal_gibbs":
        x1, x2 = out["p1"].to(torch.float32), out["p2"].to(torch.float32)
        corr = float(torch.corrcoef(torch.stack([x1.reshape(-1), x2.reshape(-1)]))[0, 1])
        got["corr"] = _held(name, corr, BIV_RHO, BIV_RHO_WIDTH)
        for k, x in (("p1", x1), ("p2", x2)):
            m, se = _mean_mcse(x)
            got[k] = _held(name, m, 0.0, 5 * se)
    elif name == "rats_gibbs":
        for k, (want, width) in BUGS_MEANS.items():
            got[k] = _held(name, float(out[k].to(torch.float32).mean()), want, width)
    return got


def run_examples(device="cuda", names=SMOKE_EXAMPLES):
    """Phase 24: ``names`` through the port's example registry at the JAX
    package's sizes, each example's K1 launches counted from 0; then K1
    against its plain version on the swiss rows' final positions (C=64,
    D=4, N=200), and timed there beside its plain version, its bound and
    the launch floor (one elementwise op on one value)."""
    from examples_torch.run_examples import build_registry
    from klara_tpu_torch.models.examples import swiss_logistic_regression
    from klara_tpu_torch.ops import logreg

    registry, errors = build_registry()
    if errors:
        raise RuntimeError(f"example registry import errors: {errors}")
    res, finals, t_phase = {}, {}, time.perf_counter()
    for name in names:
        logreg.KERNEL_LAUNCHES = 0
        _k2_reset()
        t0 = time.perf_counter()
        out = registry[name](device=device)
        _sync(device)
        secs = time.perf_counter() - t0
        res[name] = {"seconds": secs, "k1_launches": logreg.KERNEL_LAUNCHES,
                     "k2_launches": _k2_launches(),
                     "truth": check_example_output(name, out, device)}
        if name in K1_EXAMPLES:
            finals[name] = out.final_state.position
        print(f"# example {name}: {json.dumps(res[name])}", flush=True)
    _, X, y = swiss_logistic_regression(device=device)
    for name, P in finals.items():
        res[name]["k1_max_abs_err_on_path"] = _k1_error(P.contiguous(), X, y)
    P = finals[K1_EXAMPLES[0]].contiguous()
    v = (X.T @ y).contiguous()
    prep = logreg.prepare_x(X, y)
    one = torch.zeros(1, device=device)
    C, D = P.shape
    bound_ms, bound_by = k1_bound_ms(C, D, X.shape[0])
    k1 = {"shape": [C, D, X.shape[0]],
          "ms": _time_ms(lambda: logreg.logreg_value_grad(P, X, v, 100.0, prepared=prep)),
          "plain_ms": _time_ms(lambda: logreg.logreg_value_grad_reference(P, X, v, 100.0)),
          "bound_ms": bound_ms, "bound_by": bound_by,
          "launch_floor_ms": _time_ms(lambda: one.add_(1.0))}
    summary = {"seconds": time.perf_counter() - t_phase, "k1_swiss": k1}
    print(f"# examples phase: {json.dumps(summary)}", flush=True)
    return res, summary


# ------------------------------------------------------- phases 25-26: meshes
def _same_bits(name, a, b):
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        raise RuntimeError(f"{name}: the meshed run differs from the run without a mesh")


def check_meshed_no_host_read(wjob, state, gen, n_steps=5):
    """Phase 25: ``n_steps`` static-tree NUTS steps through the meshed job's
    own loop, pooled dual averaging included, under sync debug mode
    'error': the NCCL all-reduces of the pooled statistics add no host read.
    Returns the all-reduces counted in the window."""
    import dataclasses

    import klara_tpu_torch as kt
    from klara_tpu_torch.parallel.mesh import COLLECTIVES, chain_context

    job = dataclasses.replace(wjob, sampler=kt.NUTS(max_doublings=3), traj_adaptation=False)
    stream = job._run_stream(gen, state.position.device)
    with chain_context(job._block):
        nuts = job._init_states(stream, state.position)
    torch.cuda.synchronize()
    before = COLLECTIVES["all_reduce"]
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with chain_context(job._block):
            nuts = job._loop(nuts, stream, 0, n_steps, True)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    reduces = COLLECTIVES["all_reduce"] - before
    if not bool(torch.isfinite(nuts.position).all()):
        raise RuntimeError("non-finite positions after the meshed sync-checked steps")
    if reduces != 2 * n_steps:
        raise RuntimeError(f"{reduces} all-reduces in {n_steps} pooled steps, expected "
                           f"{2 * n_steps}")
    print(f"# meshed static NUTS: {n_steps} pooled steps, {reduces} NCCL all-reduces, "
          "no host read", flush=True)
    return reduces


def _all_reduce_ms(mesh, n=1000):
    """Wall time of one all-reduce of a one-value tensor over the mesh's
    chains group, the unit of every cross-chain reduction: ``n`` calls, then
    a synchronise."""
    from klara_tpu_torch.parallel.mesh import all_reduce

    group = mesh.get_group(0)
    t = torch.zeros((), device=mesh.device_type)
    all_reduce(t, group)
    _sync(mesh.device_type)
    t0 = time.perf_counter()
    for _ in range(n):
        all_reduce(t, group)
    _sync(mesh.device_type)
    return 1e3 * (time.perf_counter() - t0) / n


def run_meshed_main_path(phase4, phase4_fingerprint, device="cuda", **sizes):
    """Phase 25: the main path again on a one-rank NCCL chains mesh, held to
    phase 4 bit for bit; five pooled static NUTS steps on the mesh under
    sync debug mode 'error'; ``examples_torch/multichip_scaling.py`` at
    its full width, cut in depth.  ``sizes`` go to ``run_main_path``.
    Destroys its process group."""
    import torch.distributed as dist

    from examples_torch import multichip_scaling
    from klara_tpu_torch.ops import logreg
    from klara_tpu_torch.parallel import chain_mesh

    t_phase = time.perf_counter()
    mesh = chain_mesh(device=None if device == "cuda" else device)
    if dist.get_backend() != ("nccl" if device == "cuda" else "gloo") or mesh.size() != 1:
        raise RuntimeError(f"phase 25 wants a one-rank NCCL mesh, got {dist.get_backend()} "
                           f"over {mesh.size()} ranks")
    try:
        res, _, (wjob, state, gen), _, fingerprint = run_main_path(device, mesh=mesh, **sizes)
        for key, want in phase4_fingerprint.items():
            _same_bits(f"chees_precond {key}", fingerprint[key], want)
        if res["k1_launches"] != phase4["k1_launches"]:
            raise RuntimeError(f"the meshed main path launched K1 {res['k1_launches']} times, "
                               f"phase 4 {phase4['k1_launches']}")
        res["sync_checked_all_reduces"] = check_meshed_no_host_read(wjob, state, gen)
        del wjob, state
        res["all_reduce_ms"] = _all_reduce_ms(mesh)
        res["torch"] = f"{torch.__version__} (CUDA {torch.version.cuda})"
        logreg.KERNEL_LAUNCHES = 0
        _k2_reset()
        scaling = multichip_scaling.main(n_chains=sizes.get("chains", CHAINS),
                                         n_steps=MULTICHIP_BURNIN + MULTICHIP_POST,
                                         burnin=MULTICHIP_BURNIN, device=device)
        scaling["k1_launches"], scaling["k2_launches"] = logreg.KERNEL_LAUNCHES, _k2_launches()
        res["multichip_scaling"] = scaling
    finally:
        dist.destroy_process_group()
    res["phase_seconds"] = time.perf_counter() - t_phase
    print(f"# phase 25 (one-rank NCCL mesh): {json.dumps(res)}", flush=True)
    return res


def _p26_mala(mesh, device="cuda"):
    """MALA on the bench target at P26_CHAINS chains, no tuning; the trace's
    bit sums per (draw, chain) and the final positions of this rank's
    chains."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import synthetic_logistic_regression
    from klara_tpu_torch.ops import logreg

    target, _, _ = synthetic_logistic_regression(dim=DIM, n_data=N_DATA, device=device)
    job = kt.MCJob(target, kt.MALA(driftstep=P26_MALA_STEP),
                   kt.MCRange(n_steps=P26_BURNIN + P26_POST, burnin=P26_BURNIN),
                   n_chains=P26_CHAINS, monitor=("value",), mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(26)
    x0 = 0.1 * torch.randn(P26_CHAINS, DIM, generator=gen, device=device)
    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    chain, collectives = _collectives_of(lambda: job.run(gen, x0))
    bits = chain.value.view(torch.int32).sum(-1, dtype=torch.int64)
    return {"bits": bits.cpu(), "position": chain.final_state.position.cpu(),
            "carried": chain.final_state.position.shape[0], "collectives": collectives,
            "k1_launches": logreg.KERNEL_LAUNCHES, "k2_launches": _k2_launches(),
            "acceptance": float(kt.stats.acceptance(chain))}


def _collectives_of(fn):
    """``fn()`` and the collectives ``parallel.mesh``'s helpers issued in it."""
    from klara_tpu_torch.parallel.mesh import COLLECTIVES

    before = dict(COLLECTIVES)
    out = fn()
    return out, {k: COLLECTIVES[k] - before[k] for k in COLLECTIVES}


def _p26_rats(mesh, device="cuda"):
    """The conjugate rats GibbsJob at P26_CHAINS chains; its traces and
    final values on the host, the chains each rank carried and the
    collectives of its run."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import rats_gibbs_model
    from klara_tpu_torch.ops import logreg

    model, v0 = rats_gibbs_model(device=device)
    job = kt.GibbsJob(model, {}, kt.MCRange(n_steps=P26_SWEEPS, burnin=IO_GIBBS_BURNIN),
                      n_chains=P26_CHAINS, monitor=GIBBS_MONITOR, device=device, mesh=mesh)
    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    out, collectives = _collectives_of(
        lambda: job.run(torch.Generator(device=device).manual_seed(5), v0))
    return {"samples": {k: v.cpu() for k, v in out.samples.items()},
            "final": {k: v.cpu() for k, v in out.final_values.items()},
            "carried": sorted({v.shape[0] for v in out.final_values.values()}
                              | {v.shape[1] for v in out.samples.values()}),
            "collectives": collectives,
            "k1_launches": logreg.KERNEL_LAUNCHES, "k2_launches": _k2_launches()}


def _p26_mh(mesh, device="cuda"):
    """MH with an asymmetric LogNormal proposal distribution (keyed draws)
    on a 100-dim Gamma(2, 1) product at P26_CHAINS chains; the trace's bit
    sums, the final positions, the collectives of the run."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.distributions import LogNormal

    target = kt.Target(logdensity_fn=lambda x: (torch.log(x) - x).sum(-1), dim=DIM)
    sampler = kt.MH(proposal_fn=lambda x, s: LogNormal(torch.log(x), 0.1 * s[:, None]),
                    symmetric=False)
    job = kt.MCJob(target, sampler, kt.MCRange(n_steps=P26_MH_STEPS, burnin=P26_BURNIN),
                   n_chains=P26_CHAINS, monitor=("value",), mesh=mesh)
    _k2_reset()
    chain, collectives = _collectives_of(
        lambda: job.run(torch.Generator(device=device).manual_seed(263),
                        torch.full((DIM,), 2.0, device=device)))
    bits = chain.value.view(torch.int32).sum(-1, dtype=torch.int64)
    return {"bits": bits.cpu(), "position": chain.final_state.position.cpu(),
            "carried": chain.final_state.position.shape[0], "collectives": collectives,
            "k2_launches": _k2_launches(), "acceptance": float(kt.stats.acceptance(chain))}


def _file_digests(root):
    """{path under ``root``: sha256 of the file's bytes} of every file."""
    import hashlib

    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _p26_csv(mesh, root, device="cuda"):
    """csv output at ``root``: MALA on the bench target streamed by MCJob
    and the rats GibbsJob's ``IO_GIBBS_CSV`` variables; on a mesh the first
    rank alone writes.  The files' digests where this process wrote them
    (None elsewhere)."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import rats_gibbs_model, synthetic_logistic_regression
    from klara_tpu_torch.parallel.mesh import writes_output

    target, _, _ = synthetic_logistic_regression(dim=DIM, n_data=N_DATA, device=device)
    job = kt.MCJob(target, kt.MALA(driftstep=P26_MALA_STEP),
                   kt.MCRange(n_steps=P26_CSV_BURNIN + P26_CSV_POST, burnin=P26_CSV_BURNIN),
                   n_chains=P26_CHAINS, destination="csv", filepath=os.path.join(root, "mala"),
                   stream_chunk=P26_CSV_CHUNK, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(264)
    job.run(gen, 0.1 * torch.randn(P26_CHAINS, DIM, generator=gen, device=device))
    model, v0 = rats_gibbs_model(device=device)
    gjob = kt.GibbsJob(model, {}, kt.MCRange(n_steps=P26_CSV_SWEEPS, burnin=IO_GIBBS_BURNIN),
                       n_chains=P26_CHAINS, monitor=GIBBS_MONITOR, device=device, mesh=mesh,
                       outopts={k: {"destination": "csv", "filepath": os.path.join(root, k)}
                                for k in IO_GIBBS_CSV}, stream_chunk=IO_GIBBS_CHUNK)
    gjob.run(torch.Generator(device=device).manual_seed(265), v0)
    return {"files": _file_digests(root) if writes_output(mesh) else None}


def _p26_param(device="cuda"):
    """The param-sharded target on mesh2d(1, 2): value and gradient against
    K1 on the full X at P26_CHAINS positions, and an HMC job with per-chain
    leap counts on it."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import synthetic_logistic_regression
    from klara_tpu_torch.ops import logreg
    from klara_tpu_torch.parallel import mesh2d, param_sharded_logreg_target

    mesh = mesh2d(1, 2, device=device)
    _, X, y = synthetic_logistic_regression(dim=DIM, n_data=N_DATA, device=device)
    target = param_sharded_logreg_target(X, y, mesh)
    g = torch.Generator(device=device).manual_seed(261)
    P = 0.3 * torch.randn(P26_CHAINS, DIM, generator=g, device=device)
    value, grad = target.logdensity_and_grad(P)
    v = (X.T @ y).contiguous()
    kval, kgrad = logreg.logreg_value_grad(P, X, v, 100.0, prepared=logreg.prepare_x(X, y))
    torch.testing.assert_close(value, kval, rtol=VALUE_RTOL, atol=VALUE_ATOL)
    torch.testing.assert_close(grad, kgrad, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    err = max(float((value - kval).abs().max()), float((grad - kgrad).abs().max()))

    sampler = kt.HMC(leapstep=0.01, nleaps=5, trajectory_length=P26_HMC_LAMBDA, jitter=0.5,
                     jitter_style="chain")
    job = kt.MCJob(target, sampler, kt.MCRange(n_steps=P26_HMC_BURNIN + P26_HMC_POST,
                                               burnin=P26_HMC_BURNIN),
                   tuner=kt.DualAveragingTuner(0.8, P26_HMC_BURNIN), n_chains=P26_CHAINS,
                   monitor=("value",), diagnostics=("accept", "nleaps"), mesh=mesh)
    logreg.KERNEL_LAUNCHES = 0
    _k2_reset()
    chain = job.run(torch.Generator(device=device).manual_seed(262),
                    torch.zeros(DIM, device=device))
    k2 = _k2_launches()
    k1 = logreg.KERNEL_LAUNCHES
    leaps = chain["nleaps"]
    # run_phased's sampling on a target that runs collectives stays eager
    phased = dataclasses.replace(
        job, sampler=dataclasses.replace(sampler, jitter_style="step"),
        mcrange=kt.MCRange(n_steps=2 * P26_PHASED_STEPS, burnin=P26_PHASED_STEPS))
    _k2_reset()
    pchain, _ = phased.run_phased(torch.Generator(device=device).manual_seed(263),
                                  torch.zeros(DIM, device=device))
    graphs_run = _graph_counts()
    if graphs_run["graphs_captured"] or graphs_run["graph_replays"]:
        raise RuntimeError(f"phase 26: run_phased on the param-sharded target ran graphs: "
                           f"{graphs_run}")
    return {"max_abs_err_vs_k1": err, "finite": bool(torch.isfinite(chain.value).all()),
            "mean": kt.stats.mean(chain).cpu(), "acceptance": float(kt.stats.acceptance(chain)),
            "leaps_per_step": float(leaps.to(torch.float64).mean()),
            "steps_with_mixed_leaps": int((leaps.max(1).values != leaps.min(1).values).sum()),
            "k1_launches": k1, "k2_launches": k2,
            "phased_finite": bool(torch.isfinite(pchain.value).all()),
            "phased_graphs": graphs_run}


def rank_worker(rank, init_file, out_dir, device="cuda:0"):
    """One of phase 26's two ranks: gloo, both on ``device``."""
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    from klara_tpu_torch.parallel import chain_mesh, initialize_distributed

    initialize_distributed("file://" + init_file, 2, rank, backend="gloo", device=device)
    out = {}
    try:
        mesh = chain_mesh(device=device)
        for name, fn in (("mala", lambda: _p26_mala(mesh, device)),
                         ("rats", lambda: _p26_rats(mesh, device)),
                         ("mh", lambda: _p26_mh(mesh, device)),
                         ("csv", lambda: _p26_csv(mesh, os.path.join(out_dir, "csv_meshed"),
                                                  device)),
                         ("param", lambda: _p26_param(device))):
            t0 = time.perf_counter()
            out[name] = fn()
            _sync(device)
            out[name]["seconds"] = time.perf_counter() - t0
            print(f"# rank {rank} {name}: {out[name]['seconds']:.1f} s", flush=True)
        print(f"# rank {rank} param stats: mean[:4] {out['param']['mean'][:4].tolist()} "
              f"acceptance {out['param']['acceptance']!r}", flush=True)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def run_two_ranks_on_one_card(device="cuda"):
    """Phase 26: two processes on cuda:0 joined by gloo (NCCL refuses two
    ranks on one card), spawned here and stopped before the phase ends;
    their MALA, rats and MH-proposal runs held to this process's runs
    without a mesh bit for bit, the MALA, rats and MH runs to each rank's
    block of 2048 chains and to no collective but the run's generator
    check, their csv files (written by rank 0 from the gathered chunks) to
    this process's byte for byte, the param-sharded target to K1, and K1
    timed at the rank's 8192 chains of the 16384-chain main path."""
    t_phase = time.perf_counter()
    ref_mala, ref_rats = _p26_mala(None, device), _p26_rats(None, device)
    ref_mh = _p26_mh(None, device)
    worker_device = "cuda:0" if device == "cuda" else device
    tmp = tempfile.mkdtemp(prefix="klara_p26_")
    procs = []
    try:
        ref_csv = _p26_csv(None, os.path.join(tmp, "csv_single"), device)
        init = os.path.join(tmp, "pg")
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank-worker",
                                   str(r), init, tmp, worker_device], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
        outs = [p.communicate(timeout=P26_TIMEOUT)[0] for p in procs]
        ranks_seconds = time.perf_counter() - t0
        for r, (p, out) in enumerate(zip(procs, outs)):
            print("\n".join(f"#   {line}" for line in out.strip().splitlines()[-8:]), flush=True)
            if p.returncode != 0:
                raise RuntimeError(f"phase 26 rank {r} failed (exit {p.returncode})")
        parts = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    _same_bits("two-rank MALA trace bits",
               torch.cat([p["mala"]["bits"] for p in parts], 1), ref_mala["bits"])
    _same_bits("two-rank MALA final positions",
               torch.cat([p["mala"]["position"] for p in parts]), ref_mala["position"])
    for k, want in ref_rats["samples"].items():
        _same_bits(f"two-rank rats trace {k}", torch.cat([p["rats"]["samples"][k] for p in parts], 1),
                   want)
    for k, want in ref_rats["final"].items():
        _same_bits(f"two-rank rats final {k}", torch.cat([p["rats"]["final"][k] for p in parts]),
                   want)
    _same_bits("two-rank MH trace bits", torch.cat([p["mh"]["bits"] for p in parts], 1),
               ref_mh["bits"])
    _same_bits("two-rank MH final positions", torch.cat([p["mh"]["position"] for p in parts]),
               ref_mh["position"])
    # a rank carries its 2048 chains; the run's one collective is the generator
    # check (one all-gather of one digest a rank): the sweeps and steps issue none
    check_only = {"all_reduce": 0, "all_gather": 1, "gathered_elements": 2}
    for r, p in enumerate(parts):
        if (p["rats"]["carried"] != [P26_CHAINS // 2] or p["mh"]["carried"] != P26_CHAINS // 2
                or p["mala"]["carried"] != P26_CHAINS // 2):
            raise RuntimeError(f"rank {r} carried {p['rats']['carried']} rats chains and "
                               f"{p['mh']['carried']} MH and {p['mala']['carried']} MALA "
                               f"chains, not {P26_CHAINS // 2}")
        for run in ("mala", "rats", "mh"):
            if p[run]["collectives"] != check_only:
                raise RuntimeError(f"rank {r}'s {run} run issued {p[run]['collectives']}")
            if p[run]["k2_launches"] <= 0:
                raise RuntimeError(f"rank {r}'s {run} run launched no K2 kernel")
    if parts[1]["csv"]["files"] is not None or not ref_csv["files"]:
        raise RuntimeError("rank 1 wrote csv files, or the one process wrote none")
    if parts[0]["csv"]["files"] != ref_csv["files"]:
        differ = sorted(k for k in set(ref_csv["files"]) | set(parts[0]["csv"]["files"])
                        if ref_csv["files"].get(k) != parts[0]["csv"]["files"].get(k))
        raise RuntimeError(f"the two ranks' csv files differ from one process's: {differ}")
    a, b = parts[0]["param"], parts[1]["param"]
    if not (a["finite"] and a["acceptance"] > 0.3 and a["steps_with_mixed_leaps"] > 0
            and a["phased_finite"] and b["phased_finite"]):
        raise RuntimeError(f"param-sharded HMC: {a}")
    if not torch.equal(a["mean"], b["mean"]) or a["acceptance"] != b["acceptance"]:
        raise RuntimeError("the two param ranks report different stats.mean or acceptance")
    bound_ms, bound_by = k1_bound_ms(CHAINS // 2, DIM, N_DATA)
    k1 = check_k1(CHAINS // 2, DIM, N_DATA, timed=True)
    res = {
        "ranks_seconds": ranks_seconds,
        "seconds_by_run": {k: [p[k]["seconds"] for p in parts]
                           for k in ("mala", "rats", "mh", "csv", "param")},
        "mala_k1_launches_per_rank": [p["mala"]["k1_launches"] for p in parts],
        "mala_k1_launches_one_process": ref_mala["k1_launches"],
        "mala_k2_launches_per_rank": [p["mala"]["k2_launches"] for p in parts],
        "mala_k2_launches_one_process": ref_mala["k2_launches"],
        "csv_files_byte_identical": sorted(ref_csv["files"]),
        "mala_acceptance": ref_mala["acceptance"],
        "rats_k1_launches_per_rank": [p["rats"]["k1_launches"] for p in parts],
        "rats_k2_launches_per_rank": [p["rats"]["k2_launches"] for p in parts],
        "mh_k2_launches_per_rank": [p["mh"]["k2_launches"] for p in parts],
        "rats_carried_per_rank": [p["rats"]["carried"] for p in parts],
        "collectives_per_rank": {run: [p[run]["collectives"] for p in parts]
                                 for run in ("rats", "mh")},
        "mh_acceptance": ref_mh["acceptance"],
        "param": {k: v for k, v in a.items() if k != "mean"},
        "k1_c8192": {"ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err": k1["max_abs_err"]},
        "phase_seconds": time.perf_counter() - t_phase,
    }
    print(f"# phase 26 (two gloo ranks on one card): {json.dumps(res)}", flush=True)
    return res


# ------------------------------------------------ phase 29: the tracer's cost
def _traced_runs(run, device, order=(False, True, True, False) * 3):
    """``run()`` (one job) once per entry of ``order``, with span recording on
    where it is True: per run its wall (host clock to a synchronise), its
    job report and the count of spans by name; raises unless a run with
    recording off leaves no span, each run leaves one report, and every
    span of a recorded run lies inside its report's window."""
    from collections import Counter

    from klara_tpu_torch.utils import tracing

    out = []
    for on in order:
        tracing.reset()
        _sync(device)
        t0 = time.perf_counter()
        with tracing.recording() if on else contextlib.nullcontext():
            run()
        _sync(device)
        wall = time.perf_counter() - t0
        reports, spans = tracing.reports(), tracing.spans()
        if len(reports) != 1:
            raise RuntimeError(f"tracer: {len(reports)} job reports from one job")
        rep = reports[0]
        if not on and spans:
            raise RuntimeError(f"tracer: {len(spans)} spans with recording off")
        outside = [s for s in spans if s.end is None or s.start / 1e9 < rep["t0"]
                   or s.end / 1e9 > rep["t1"]]
        if outside:
            raise RuntimeError(f"tracer: {len(outside)} spans outside the job's window")
        counters = {k: v for k, v in rep["counters"].items() if not k.startswith("ops.keyed.")}
        own = [v[0] for k, v in rep["counters"].items() if not k.startswith(MODULE_COUNTERS)]
        out.append({"recording": on, "wall_s": wall, "report_s": rep["t1"] - rep["t0"],
                    "counter_events": sum(own),
                    "phases": {k: [round(p["seconds"], 6), p["steps"]]
                               for k, p in rep["phases"].items()},
                    "counters": counters, "spans": len(spans),
                    "spans_by_name": dict(Counter(s.name for s in spans).most_common(12))})
        print(f"# phase 29 run: {json.dumps(out[-1])}", flush=True)
    return out


MODULE_COUNTERS = ("ops.", "jobs.", "parallel.", "samplers.")  # the repo's module counters


def _event_ns(n=200_000):
    """Host ns of one tracer event on this machine: a span site and a timed
    counter, recording off and on (``n`` of each in a loop)."""
    from klara_tpu_torch.utils import tracing

    out = {}
    for on in (False, True):
        with tracing.recording() if on else contextlib.nullcontext():
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with tracing.span("x"):
                    pass
            t1 = time.perf_counter_ns()
            for _ in range(n):
                with tracing.timed("x"):
                    pass
            t2 = time.perf_counter_ns()
        state = "on" if on else "off"
        out[f"span_{state}_ns"], out[f"timed_{state}_ns"] = (t1 - t0) / n, (t2 - t1) / n
        tracing.reset()
    return out


def _pairs(runs):
    """Each neighbouring pair of runs in turns (one off, one on): the on
    run's wall over the off run's, less 1; and their median."""
    pairs = [(b if b_on else a) / (a if b_on else b) - 1.0
             for (a, b), b_on in zip(zip(*[iter(r["wall_s"] for r in runs)] * 2),
                                     (r["recording"] for r in runs[1::2]))]
    return {"pairs_on_over_off": pairs, "median_on_over_off": statistics.median(pairs)}


def _profiled_runs(run, device, order=(False, True, True, False) * 2):
    """``run()`` under ``torch.profiler`` with CUDA activity (as the
    benchmark profiles its traced job) once per entry of ``order``; where
    False the tracer's spans stay off under the profiler (its profiler check
    replaced for the run), so a pair shows what the spans and their
    ``record_function`` cost a profiled job.  The wall is the job's, to a
    synchronise, inside the profiler's block."""
    from klara_tpu_torch.utils import tracing

    acts = [torch.profiler.ProfilerActivity.CUDA if torch.device(device).type == "cuda"
            else torch.profiler.ProfilerActivity.CPU]
    real, out = tracing._profiling, []
    for on in order:
        tracing.reset()
        tracing._profiling = real if on else (lambda: False)
        try:
            with torch.profiler.profile(activities=acts):
                _sync(device)
                t0 = time.perf_counter()
                run()
                _sync(device)
                wall = time.perf_counter() - t0
        finally:
            tracing._profiling = real
        out.append({"recording": on, "wall_s": wall, "spans": len(tracing.spans())})
        print(f"# phase 29 profiled run: {json.dumps(out[-1])}", flush=True)
    return {"off_s": [r["wall_s"] for r in out if not r["recording"]],
            "on_s": [r["wall_s"] for r in out if r["recording"]],
            "spans_recorded": max(r["spans"] for r in out), **_pairs(out)}


def _cost(runs, event):
    """Recording's cost measured, from the runs in turns (``_pairs``),
    beside the counters' and spans' host time estimated from the events'
    counts and the loop times of ``_event_ns``."""
    off = [r["wall_s"] for r in runs if not r["recording"]]
    on = [r["wall_s"] for r in runs if r["recording"]]
    spans = max(r["spans"] for r in runs)
    return {"off_s": off, "on_s": on, "on_over_off": sum(on) / sum(off) - 1.0, **_pairs(runs),
            "counter_events": runs[0]["counter_events"], "spans_recorded": spans,
            # the always-on counters' host time, and what recording adds to it
            "counters_est_s": runs[0]["counter_events"] * event["timed_off_ns"] * 1e-9,
            "recording_est_s": spans * (event["timed_on_ns"] - event["timed_off_ns"]) * 1e-9}


def run_tracing_cost(device="cuda", chains=CHAINS, dim=DIM, n_data=N_DATA, burnin=BURNIN,
                     post=POST, gchains=GIBBS_CHAINS, sweeps=GIBBS_SWEEPS,
                     gburnin=GIBBS_BURNIN):
    """Phase 29: what span recording costs a whole chees_precond job and a
    whole rats GibbsJob (``_traced_runs``), after a short warm job of each."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import rats_gibbs_model, synthetic_logistic_regression

    target, _, _ = synthetic_logistic_regression(dim=dim, n_data=n_data, device=device)
    s2 = kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=2.0, jitter=0.9,
                jitter_style="step", max_nleaps=64)

    def chees(b=burnin, p=post):
        job = _stage1_job(target, chains, dim, b, p)
        gen = torch.Generator(device=device).manual_seed(42)
        x0 = 0.1 * torch.randn(chains, dim, generator=gen, device=device)
        return job.run_preconditioned(gen, x0, back_transform=False,
                                      stage2_replace=dict(sampler=s2, traj_adaptation=False))

    model, v0 = rats_gibbs_model(device=device)

    def rats(n=sweeps):
        job = kt.GibbsJob(model, {}, kt.MCRange(n_steps=n, burnin=gburnin), n_chains=gchains,
                          monitor=GIBBS_MONITOR, device=device)
        return job.run(torch.Generator(device=device).manual_seed(0), v0)

    chees(4, 40)
    rats(gburnin + 200)
    event = _event_ns()
    res = {"event_ns": event, "chees_precond": _cost(_traced_runs(chees, device), event),
           "gibbs_rats": _cost(_traced_runs(rats, device), event)}
    _profiled_runs(lambda: (chees(4, 40), rats(gburnin + 200)), device, (False, True))
    res["profiled"] = {"chees_precond": _profiled_runs(chees, device),
                       "gibbs_rats": _profiled_runs(rats, device)}
    print(f"# phase 29 (the tracer's cost, recording off / on): {json.dumps(res)}", flush=True)
    return res


# ------------------------------------------------ phase 27: K2, keyed draws
def _k2_reset():
    """Zero K2's launch counters and the graph counters (before a path's run)."""
    from klara_tpu_torch.jobs import graphs
    from klara_tpu_torch.ops import keyed

    keyed.KERNEL_LAUNCHES = 0
    keyed.LAUNCHES_BY_MODE = {m: 0 for m in keyed.MODES}
    graphs.GRAPHS_CAPTURED = graphs.GRAPH_REPLAYS = 0
    graphs.REPLAYED_LAUNCHES = {"k1": 0, "k2": 0}


def _graph_counts(device="cuda", gate=None):
    """The graphs captured and replayed since ``_k2_reset`` and the K1 and K2
    launches the replays added; with ``gate`` (a path's name) on the card,
    raise unless the path replayed a graph."""
    from klara_tpu_torch.jobs import graphs

    out = {"graphs_captured": graphs.GRAPHS_CAPTURED, "graph_replays": graphs.GRAPH_REPLAYS,
           "k1_launches_in_replays": graphs.REPLAYED_LAUNCHES["k1"],
           "k2_launches_in_replays": graphs.REPLAYED_LAUNCHES["k2"]}
    if gate and torch.device(device).type == "cuda" and out["graph_replays"] <= 0:
        raise RuntimeError(f"{gate}: no graph was replayed")
    return out


def _k2_launches():
    from klara_tpu_torch.ops import keyed

    return keyed.KERNEL_LAUNCHES


def _ulps(a, b):
    """|a − b| in units of b's last place."""
    mag = b.abs()
    return (a - b).abs() / (torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag)


_K2_PROBE = r"""
#include "{source}"
extern "C" __global__ void k2_probe_philox(uint4* o, const long long* key, unsigned c1,
                                           unsigned c2, unsigned c3) {{
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned long long kk = (unsigned long long)*key;
  const Words w = philox(i, c1, c2, c3, (uint32_t)kk, (uint32_t)(kk >> 32));
  o[i] = make_uint4(w.x, w.y, w.z, w.w);
}}
extern "C" __global__ void k2_probe_base(uint4* o, const long long* key, unsigned c1,
                                         unsigned c2, unsigned c3) {{
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned long long kk = (unsigned long long)*key;
  o[i] = make_uint4(i, c1, (uint32_t)kk, (uint32_t)(kk >> 32));
}}
// the transforms on Philox words and element state read from memory, as the f32 draws
// compile them; each stores one int, so only the test's own work is left
#define K2_WORDS const unsigned i = blockIdx.x * blockDim.x + threadIdx.x; \
  const uint4 v4 = w[i]; const Words x{{v4.x, v4.y, v4.z, v4.w}};
extern "C" __global__ void k2_probe_uniform(int* o, const uint4* w, const double* s) {{
  K2_WORDS o[i] = __float_as_int(uniform(x, 0.0f));
}}
extern "C" __global__ void k2_probe_normal(int* o, const uint4* w, const double* s) {{
  K2_WORDS o[i] = __float_as_int(normal(x, 0.0f));
}}
extern "C" __global__ void k2_probe_gamma_cheap(int* o, const uint4* w, const double* s) {{
  K2_WORDS Gamma<float> g;
  g.c = (float)s[i];
  o[i] = g.test(x, x);
}}
extern "C" __global__ void k2_probe_poisson_cheap(int* o, const uint4* w, const double* s) {{
  K2_WORDS Poisson<float> g;
  g.inversion = false;
  g.lam = s[i]; g.a = s[i + 1]; g.b = s[i + 2]; g.vr = s[i + 3];
  o[i] = g.test(x);
}}
extern "C" __global__ void k2_probe_binomial_cheap(int* o, const uint4* w, const double* s) {{
  K2_WORDS Binomial<float> g;
  g.n = s[i]; g.a = s[i + 1]; g.b = s[i + 2]; g.c = s[i + 3]; g.v_r = s[i + 4];
  o[i] = g.test(x);
}}
extern "C" __global__ void k2_probe_gamma_slow(int* o, const uint4* w, const double* s) {{
  K2_WORDS Gamma<float> g;
  g.u = (float)s[i]; g.xx = (float)s[i + 1]; g.v = (float)s[i + 2]; g.d = (float)s[i + 3];
  o[i] = g.slow();
}}
extern "C" __global__ void k2_probe_poisson_slow(int* o, const uint4* w, const double* s) {{
  K2_WORDS Poisson<float> g;
  g.V = s[i]; g.us = s[i + 1]; g.k = s[i + 2]; g.a = s[i + 3]; g.b = s[i + 4]; g.lam = s[i + 5];
  g.loglam = s[i + 6]; g.log_invalpha = s[i + 7];
  o[i] = g.slow();
}}
extern "C" __global__ void k2_probe_binomial_slow(int* o, const uint4* w, const double* s) {{
  K2_WORDS Binomial<float> g;
  g.v = s[i]; g.us = s[i + 1]; g.k = s[i + 2]; g.n = s[i + 3]; g.m = s[i + 4]; g.r = s[i + 5];
  g.alpha = s[i + 6]; g.a = s[i + 7]; g.b = s[i + 8]; g.upper_m = s[i + 9]; g.st_m = s[i + 10];
  g.st_nm = s[i + 11];
  o[i] = g.slow();
}}
"""
# K2's transforms (``k2_sass``): the probes of each mode's cheap test (a whole attempt's
# transform; uniform and normal: the element's) and slow test
K2_TRANSFORMS = {"uniform": ("uniform", None), "normal": ("normal", None),
                 "gamma": ("gamma_cheap", "gamma_slow"),
                 "poisson": ("poisson_cheap", "poisson_slow"),
                 "binomial": ("binomial_cheap", "binomial_slow")}


def _sass_listing(text):
    """{function: [(address, predicated, opcode, operands)]} from ``cuobjdump
    -sass`` (NOPs, which pad the code after its end, left out)."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            fn = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*)",
                     line)
        if m and fn is not None and m.group(3) != "NOP":
            fn.append((int(m.group(1), 16), bool(m.group(2)), m.group(3), m.group(4)))
    return out


def _sass_counts(text):
    """{function: {opcode: count}} from ``cuobjdump -sass``."""
    out = {}
    for fn, instrs in _sass_listing(text).items():
        counts = out.setdefault(fn, {})
        for _, _, op, _ in instrs:
            counts[op] = counts.get(op, 0) + 1
    return out


def _sass_min_path(instrs, names):
    """The fewest instructions whose opcode (before its first dot) is in
    ``names`` on any path from a function's first instruction to an exit:
    branches followed both ways, a predicated instruction counted as not
    executed, a call not entered.  Every run of the function executes at
    least that many, so a bound built on it stays a floor."""
    at = {addr: k for k, (addr, *_) in enumerate(instrs)}
    dist, heap, best = {0: 0}, [(0, 0)], math.inf
    while heap:
        d, k = heapq.heappop(heap)
        if k >= len(instrs):
            best = min(best, d)
            continue
        if d > dist[k]:
            continue
        _, pred, op, args = instrs[k]
        base = op.split(".")[0]
        d += int(not pred and base in names)
        cond = pred or op != base or re.match(r"\s*!?U?P[T0-9]+\s*,", args) is not None
        target = re.search(r"0x([0-9a-f]+)", args)
        if base in ("EXIT", "RET", "BRX", "JMX", "KILL"):
            succ = [len(instrs)] + ([k + 1] if cond else [])
        elif base in ("BRA", "JMP"):
            succ = [at.get(int(target.group(1), 16), len(instrs)) if target else len(instrs)]
            succ += [k + 1] if cond else []
        else:
            succ = [k + 1]
        for j in succ:
            if d < dist.get(j, math.inf):
                dist[j] = d
                heapq.heappush(heap, (d, j))
    return best


def k2_sass():
    """K2's code by pipe, from ``cuobjdump -sass`` of a probe that includes
    K2's source, built with K2's flags.  ``philox``: one Philox4x32-10 call
    (two kernels that load the run key from memory as K2 does, so the key
    schedule runs per thread; one storing a call's four words, one storing
    the counter and key words; the difference of their instructions).
    ``ops_per_call`` is the call's least issue time in INT32-lane units:
    the larger of its FMA-pipe and its ALU-pipe instructions (64 lanes an
    SM each) and half of all its instructions (128 issues an SM); each
    instruction counted once, and those whose pipe is not certain (VIADD,
    the uniform datapath's) only in the issue total, so that the bound
    stays a floor.  ``transforms``: each mode's cheap and slow test
    (``K2_TRANSFORMS``), the floating-point instructions on the shortest
    path through the test (``_sass_min_path``) by pipe: FP32 (FFMA, FMUL,
    FADD: 128 lanes an SM), FP64 (64 lanes), MUFU (16 lanes); and, as
    ``cheap_all_paths``/``slow_all_paths``, those of every path through it
    (the math library's special cases included: more than a run executes).
    The shortest path through ``log`` or ``lgamma`` is a special case's
    early exit, so the floor counts little of their work."""
    from klara_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    tools = [os.path.join(os.path.dirname(nvcc), "cuobjdump")]
    with contextlib.suppress(ImportError):
        import triton

        tools.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                                  "cuobjdump"))
    cuobjdump = next((t for t in tools if os.path.exists(t)), None)
    if cuobjdump is None:
        raise RuntimeError(f"no cuobjdump at {tools}: K2's bound cannot be counted")
    tmp = tempfile.mkdtemp(prefix="klara_k2_sass_")
    try:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(_K2_PROBE.format(source=os.path.join(_build.CSRC, "keyed_draws.cu")))
        cubin = os.path.join(tmp, "probe.cubin")
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC",
                                                           "-Xptxas", "-v")]
        subprocess.run([nvcc, *flags, *_build.EXTRA_FLAGS["keyed_draws"], "-cubin", "-o", cubin,
                        src], check=True, capture_output=True, text=True, timeout=300)
        text = subprocess.run([cuobjdump, "-sass", cubin], check=True, capture_output=True,
                              text=True, timeout=120).stdout
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = _sass_counts(text)
    philox, base = counts["k2_probe_philox"], counts["k2_probe_base"]
    diff = {op: philox.get(op, 0) - base.get(op, 0) for op in set(philox) | set(base)}
    diff = {op: n for op, n in sorted(diff.items()) if n}

    def pipe(names):
        return sum(n for op, n in diff.items() if op.split(".")[0] in names)

    fma, alu, total = pipe(SASS_FMA_PIPE), pipe(SASS_ALU_PIPE), sum(diff.values())
    listing = _sass_listing(text)
    transforms = {}
    for mode, probes in K2_TRANSFORMS.items():
        for part, probe in zip(("cheap", "slow"), probes):
            if probe is not None:
                instrs = listing[f"k2_probe_{probe}"]
                transforms.setdefault(mode, {})[part] = {
                    name: _sass_min_path(instrs, names) for name, names in SASS_FP_PIPES.items()}
                # every path's instructions: what the test's code holds, not a floor
                transforms[mode][part + "_all_paths"] = {
                    name: sum(op.split(".")[0] in names for _, _, op, _ in instrs)
                    for name, names in SASS_FP_PIPES.items()}
    out = {"opcodes": diff, "fma_pipe": fma, "alu_pipe": alu, "total": total,
           "ops_per_call": max(fma, alu, total / 2), "transforms": transforms}
    print(f"# K2 in SASS (Philox call: probe minus base; transforms: shortest path): "
          f"{json.dumps(out)}", flush=True)
    return out


def k2_bound_ms(n_elements, elem_bytes, n_calls, sass, mode, attempts, slow_tests):
    """The least time the card could take for a keyed draw of ``n_elements``
    values that makes ``n_calls`` Philox calls, ``attempts`` cheap tests
    and ``slow_tests`` slow tests in all (this run's data: the rejection
    loops' work counted), and which limit sets it: each pipe's instructions
    (``k2_sass``: the Philox calls on the FMA and ALU pipes and the issue
    slots; the transforms on the FP32, FP64 and MUFU pipes) at its rate,
    or the output's bytes (the parameters are numbers passed by value) over
    the memory rate.  Per-element set-up (the PTRS and BTRS constants, the
    final scaling) is not counted."""
    tr = sass["transforms"][mode]
    fp = {name: attempts * tr["cheap"][name] + slow_tests * tr.get("slow", {}).get(name, 0)
          for name in SASS_FP_PIPES}
    secs = {"philox": n_calls * sass["ops_per_call"] / INT32_OPS_PER_S,
            **{name: n / SASS_FP_RATES[name] for name, n in fp.items()},
            "issue": (n_calls * sass["total"] + sum(fp.values())) / ISSUE_PER_S,
            "bytes": n_elements * elem_bytes / HBM_BYTES_PER_S}
    pipe = max(secs, key=secs.get)
    return 1e3 * secs[pipe], "bytes" if pipe == "bytes" else "operations", pipe


def _k2_compare(stream, mode, dtype, p0=None, p1=None, shape=None):
    """K2 against its plain version on the card, same key and counters:
    uniforms bit for bit, normals within ``K2_NORMAL_ULP``, gamma, Poisson
    and binomial on the same attempt in all but ``K2_OTHER_ATTEMPT_SHARE``
    of the elements and there within ``K2_GAMMA_RTOL`` (gamma) or equal.  A
    parameter may be a Python number (the kernel's scalar branch)."""
    from klara_tpu_torch.ops import keyed

    m = keyed.MODES[mode]
    shape = shape or (stream.chains,) + K2_COMPARE_SHAPE[1:]
    kv, kc = keyed.draws(stream, m, shape, dtype, p0, p1, want_calls=True)
    pv, pc, _ = keyed.draws_reference(stream, m, shape, dtype, p0, p1)
    torch.cuda.synchronize()
    out = {"mode": mode, "dtype": str(dtype).split(".")[-1], "elements": kv.numel(),
           "params": [p for p in (p0, p1) if p is not None and not torch.is_tensor(p)]}
    same = (kc == pc) & (kc > 0) if mode in ("gamma", "poisson", "binomial") else kc == pc
    fails = []
    if not bool(same.any()):
        fails.append("no element drawn on the same attempt")
    diff = (kv - pv)[same]
    out["max_abs_err"] = float(diff.abs().max()) if diff.numel() else math.inf
    if mode == "uniform":
        out["bitwise"] = torch.equal(kv, pv)
        if not out["bitwise"]:
            fails.append("uniforms differ")
    elif mode == "normal":
        out["max_ulps"] = float(_ulps(kv, pv).max())
        out["bitwise_share"] = float((kv == pv).double().mean())
        if out["max_ulps"] > K2_NORMAL_ULP:
            fails.append(f"normals {out['max_ulps']} ulp apart")
    else:
        out["other_attempt_share"] = 1.0 - float(same.double().mean())
        out["bitwise_share"] = float((kv[same] == pv[same]).double().mean())
        out["max_calls"] = int(kc.max())
        if not bool(torch.equal(kc > 0, pc > 0)):
            fails.append("the versions disagree on which elements are drawn")
        if out["other_attempt_share"] > K2_OTHER_ATTEMPT_SHARE:
            fails.append(f"{out['other_attempt_share']} of the elements on another attempt")
        if mode == "gamma":
            rel = (diff.abs() / pv[same].abs()).max()
            out["max_rel_err"] = float(rel)
            if out["max_rel_err"] > K2_GAMMA_RTOL[dtype]:
                fails.append(f"gamma relative error {out['max_rel_err']}")
        elif diff.numel() and float(diff.abs().max()) != 0.0:
            fails.append(f"{mode} draws on the same attempt differ")
    print(f"# K2 vs plain: {json.dumps(out)}", flush=True)
    if fails:
        raise RuntimeError(f"K2 {mode} {dtype}: " + "; ".join(fails))
    return out


def _k2_grid_params(mode, shape, device="cuda"):
    """Per-element parameters cycling through phase 27's grid."""
    n = math.prod(shape)
    if mode == "gamma":
        vals = [torch.tensor(K2_ALPHAS)]
    elif mode == "poisson":
        vals = [torch.tensor(K2_LAMBDAS)]
    elif mode == "binomial":
        vals = [torch.tensor([float(n_) for n_, _ in K2_BINOMIALS]),
                torch.tensor([p for _, p in K2_BINOMIALS])]
    else:
        return ()
    idx = torch.arange(n) % vals[0].numel()
    return tuple(v[idx].reshape(shape).to(device) for v in vals)


def _k2_moments(stream):
    """Mean and variance of 10^6 kernel draws per grid point against the
    exact ones, within ``K2_MOMENT_Z`` standard errors (Var s² = (μ4 − σ⁴
    (n−3)/(n−1)) / n)."""
    import scipy.stats as st
    from klara_tpu_torch.ops import keyed

    grid = [("uniform", (), st.uniform()), ("normal", (), st.norm())]
    grid += [("gamma", (a,), st.gamma(a)) for a in K2_ALPHAS]
    grid += [("poisson", (lam,), st.poisson(lam)) for lam in K2_LAMBDAS]
    grid += [("binomial", (float(n_), p), st.binom(n_, p)) for n_, p in K2_BINOMIALS]
    out, worst = [], 0.0
    for j, (mode, params, dist) in enumerate(grid):
        dtypes = (torch.float32, torch.float64) if mode in ("uniform", "normal", "gamma") \
            else (torch.float32,)
        for dtype in dtypes:
            x = keyed.draws(stream.at(chains=K2_MOMENT_SHAPE[0], step=j,
                                      part=int(dtype == torch.float64)),
                            keyed.MODES[mode], K2_MOMENT_SHAPE, dtype, *params)[0].double()
            n = x.numel()
            mean, var, kurt = (float(v) for v in dist.stats(moments="mvk"))
            mu4 = (kurt + 3.0) * var * var
            z_mean = abs(float(x.mean()) - mean) / math.sqrt(var / n)
            z_var = abs(float(x.var()) - var) / math.sqrt((mu4 - var * var * (n - 3) / (n - 1)) / n)
            worst = max(worst, z_mean, z_var)
            out.append({"mode": mode, "params": list(params), "dtype": str(dtype).split(".")[-1],
                        "z_mean": z_mean, "z_var": z_var, "finite": bool(torch.isfinite(x).all())})
    print(f"# K2 moments, {math.prod(K2_MOMENT_SHAPE)} draws a grid point: {json.dumps(out)}",
          flush=True)
    bad = [r for r in out if not r["finite"] or max(r["z_mean"], r["z_var"]) > K2_MOMENT_Z]
    if bad:
        raise RuntimeError(f"K2 moments off the exact ones: {bad}")
    return worst


def _k2_library(mode, shape, gen, params):
    """torch's own call for the same distribution and shape (a yardstick;
    the port never calls it)."""
    if mode == "uniform":
        return lambda: torch.rand(shape, generator=gen, device=gen.device)
    if mode == "normal":
        return lambda: torch.randn(shape, generator=gen, device=gen.device)
    full = [torch.full(shape, float(p), device=gen.device) for p in params]
    if mode == "gamma":
        return lambda: torch._standard_gamma(full[0], generator=gen)
    if mode == "poisson":
        return lambda: torch.poisson(full[0], generator=gen)
    return lambda: torch.binomial(full[0], full[1], generator=gen)


def _k2_calls_made(mode, calls, params):
    """The Philox calls a timed draw made: ``calls`` holds one past each
    element's last call index, and a gamma at α ≥ 1 skips call 0 (the α < 1
    boost's uniform)."""
    n = int(calls.sum())
    if mode == "gamma" and params[0] >= 1:
        n -= int((calls > 0).sum())
    return n


def _k2_tests(stream, mode, shape, params, calls):
    """(cheap tests, slow tests) that an f32 draw's elements made: each
    attempt's cheap test replayed in torch from the plain version's words
    and formulas (``keyed.py``), the attempts an element made read from its
    ``calls``.  Uniform and normal: one transform an element, no slow test.
    The timed parameters are scalars on the rejection branches (gamma at
    α ≥ 1, PTRS, BTRS)."""
    from klara_tpu_torch.ops import keyed

    calls = calls.reshape(-1).long()
    n = calls.numel()
    if mode in ("uniform", "normal"):
        return n, 0
    ctx = keyed._Ctx(stream, math.prod(shape[1:]), (stream.site << 8) | stream.part)
    made = calls - 1 if mode == "gamma" else calls  # attempts: f32 gamma's start at call 1
    idx = torch.arange(n, device=calls.device)
    f64 = dict(dtype=torch.float64, device=calls.device)
    if mode == "gamma":
        assert params[0] >= 1
        d = torch.full((n,), params[0], dtype=torch.float32, device=calls.device) - 1.0 / 3.0
        c = keyed._rdiv(1.0, torch.sqrt(9.0 * d))
    elif mode == "poisson":
        assert params[0] >= 10
        L = torch.full((n,), float(params[0]), **f64)
        b = 0.931 + 2.53 * torch.sqrt(L)
        a, vr = -0.059 + 0.02483 * b, 0.9277 - keyed._rdiv(3.6224, b - 2.0)
    else:
        N, Q = torch.full((n,), float(params[0]), **f64), torch.full((n,), float(params[1]), **f64)
        assert float(params[0]) * float(params[1]) >= 10 and params[1] <= 0.5
        stddev = torch.sqrt(N * Q * (1.0 - Q))
        b = 1.15 + 2.53 * stddev
        a, c, v_r = -0.0873 + 0.0248 * b + 0.01 * Q, N * Q + 0.5, 0.92 - keyed._rdiv(4.2, b)
    slow = 0
    for t in range(int(made.max())):
        i = idx[made > t]
        if mode == "gamma":
            w = ctx.words(i, 1 + t)
            x, u = keyed._normal(w, False), keyed._u01f(w[2])
            y = 1.0 + c[i] * x
            xx = x * x
            slow += int(((y > 0) & ~(u < 1.0 - 0.0331 * xx * xx)).sum())
            continue
        w = ctx.words(i, t)
        U, V = keyed._u01d(w[0], w[1]) - 0.5, keyed._u01d(w[2], w[3])
        us = 0.5 - torch.abs(U)
        if mode == "poisson":
            k = torch.floor((2.0 * a[i] / us + b[i]) * U + L[i] + 0.43)
            quick = (us >= 0.07) & (V <= vr[i])
            bad = (k < 0) | ((us < 0.013) & (V > us))
        else:
            k = torch.floor((2.0 * a[i] / us + b[i]) * U + c[i])
            quick = (us >= 0.07) & (V <= v_r[i])
            bad = (k < 0) | (k > N[i])
        slow += int((~quick & ~bad).sum())
    return int(made.sum()), slow


def _host_us(fn, iters=1000, batch=100, warmup=20) -> float:
    """Host µs a call: perf_counter over ``iters`` calls with no
    synchronisation inside a batch of ``batch`` (the queue of launches
    stays below its depth, so a long kernel does not hold the host back);
    the card is synchronised between batches, outside the clock."""
    for _ in range(warmup):
        fn()
    spent = 0.0
    for _ in range(iters // batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        spent += time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * spent / (iters // batch * batch)


def _profiled_kernels(fn, match=None, iters=20):
    """The device kernels (those whose name holds ``match``, else all) that
    one torch.profiler session records over ``iters`` calls of ``fn``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if str(e.device_type).endswith("CUDA")
            and (match is None or match in e.name)]


def _device_us(fn, match=None, iters=20, tries=3):
    """Device µs a call: under torch.profiler, the duration of the call's
    kernels (those whose name holds ``match``, else all), from a session
    that recorded a whole number of kernels a call (the profiler can drop
    records, ``run_keyed_draws``); None where no session of ``tries`` did
    (not measured)."""
    for _ in range(tries):
        kernels = _profiled_kernels(fn, match, iters)
        if kernels and len(kernels) % iters == 0:
            return sum(e.time_range.elapsed_us() for e in kernels) / iters
    return None


def _k2_times(stream, gen, sass):
    """Each mode at ``K2_TIME_SHAPES`` with ``K2_TIME_PARAMS`` (f32): K2
    and torch's own call in turns, three times each (CUDA events over 50
    back-to-back launches; the least of the three kept, the machine's host
    being shared), their host µs a launch (twice each in turns, the less
    kept) and their device µs (the kernels' own durations); the plain
    version; the work this run's elements made (cheap and slow tests an
    element) and the bound that work gives (``k2_bound_ms``)."""
    from klara_tpu_torch.ops import keyed

    out = {}
    for mode, params in K2_TIME_PARAMS.items():
        out[mode] = {}
        m = keyed.MODES[mode]
        for label, shape in {**K2_TIME_SHAPES, **K2_JOB_SHAPES.get(mode, {})}.items():
            s = stream.at(chains=shape[0])
            _, calls = keyed.draws(s, m, shape, torch.float32, *params, want_calls=True)
            n_calls = _k2_calls_made(mode, calls, params)
            cheap, slow = _k2_tests(s, mode, shape, params, calls)
            n = math.prod(shape)
            bound, by, pipe = k2_bound_ms(n, 4, n_calls, sass, mode, cheap, slow)
            tr = sass["transforms"][mode]
            # the FP64 pipe's time were every instruction of the tests' code executed
            fp64_all_paths = 1e3 * (cheap * tr["cheap_all_paths"]["fp64"] + slow * tr.get(
                "slow_all_paths", {}).get("fp64", 0)) / SASS_FP_RATES["fp64"]

            def k2():
                keyed.draws(s, m, shape, torch.float32, *params)

            lib = _k2_library(mode, shape, gen, params)
            runs = [_time_ms(f) for f in (k2, lib) * 3]
            host = [_host_us(f) for f in (k2, lib) * 2]
            device, device_lib = _device_us(k2, "keyed_draws"), _device_us(lib)
            out[mode][label] = {
                "ms": min(runs[0::2]), "library_ms": min(runs[1::2]),
                "ms_runs": runs[0::2], "library_ms_runs": runs[1::2],
                "host_us": min(host[0::2]), "library_host_us": min(host[1::2]),
                "device_us": device, "library_device_us": device_lib,
                "plain_ms": _time_ms(lambda: keyed.draws_reference(s, m, shape, torch.float32,
                                                                   *params),
                                     iters=3, warmup=1),
                "bound_ms": bound, "bound_by": by, "bound_pipe": pipe, "philox_calls": n_calls,
                "fp64_all_paths_ms": fp64_all_paths,
                "cheap_tests_per_element": cheap / n, "slow_tests_per_element": slow / n,
            }
            print(f"# K2 {mode} {label}: {json.dumps(out[mode][label])}", flush=True)
    print(f"# K2 times (ms, f32): {json.dumps(out)}", flush=True)
    return out


def _k2_times_in_a_process(sass, device="cuda"):
    """``_k2_times`` in a process of its own (``--k2-times-worker``), on the
    stream and generator phase 27 starts from: its host and device readings
    then follow no earlier phase's state.  In a process that has run many
    phases torch.profiler records fewer and fewer of K2's kernels (none late
    in a whole run: ``run_keyed_draws`` reads how many); a fresh process
    records them all."""
    tmp = tempfile.mkdtemp(prefix="klara_k2_times_")
    proc = None
    try:
        with open(os.path.join(tmp, "sass.json"), "w") as f:
            json.dump(sass, f)
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--k2-times-worker",
                                 tmp, device], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        out = proc.communicate(timeout=K2_TIMES_TIMEOUT)[0]
        print("\n".join(line for line in out.splitlines() if line.startswith("# K2 ")), flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"phase 27's timing process failed (exit {proc.returncode}):\n"
                               + out[-3000:])
        with open(os.path.join(tmp, "times.json")) as f:
            return json.load(f)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def k2_times_worker(tmp, device="cuda"):
    """Phase 27's timing process: the stream of ``run_keyed_draws`` at site
    30, the times written to ``tmp``/times.json."""
    sys.path.insert(0, REPO)
    from klara_tpu_torch.ops import keyed

    with open(os.path.join(tmp, "sass.json")) as f:
        sass = json.load(f)
    gen = torch.Generator(device=device).manual_seed(27)
    stream = keyed.KeyedStream(keyed.run_key(gen, device), K2_COMPARE_SHAPE[0], offset=12288,
                               step=5, site=30)
    times = _k2_times(stream, gen, sass)
    torch.cuda.synchronize()
    keyed.raise_on_overflow()
    times["profiler_k2_kernels_of_20"] = len(_k2_profiler_probe(stream))
    with open(os.path.join(tmp, "times.json"), "w") as f:
        json.dump(times, f)


def _k2_profiler_probe(stream):
    """The K2 kernels one torch.profiler session records over 20 normal
    draws at 4096 x 30 (all 20 in a fresh process)."""
    from klara_tpu_torch.ops import keyed

    s = stream.at(chains=4096, site=31)
    return _profiled_kernels(lambda: keyed.draws(s, keyed.MODES["normal"], (4096, 30),
                                                 torch.float32), "keyed_draws", 20)


def _k2_kernels():
    """Registers, spills, shared memory, threads and blocks an SM of each
    (mode, type) kernel of K2 as built."""
    from klara_tpu_torch.ops import keyed

    out = {f"{mode}_{str(dt).split('.')[-1]}": keyed.kernel_info(m, dt)
           for mode, m in keyed.MODES.items() for dt in (torch.float32, torch.float64)}
    print(f"# K2 kernels: {json.dumps(out)}", flush=True)
    return out


def _k2_resident_threads(m, dtype):
    """Threads of K2's (mode, type) kernel the card holds at once: a draw of
    more elements makes each thread stride over several."""
    from klara_tpu_torch.ops import keyed

    info = keyed.kernel_info(m, dtype)
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    return info["blocks_per_sm"] * info["threads"] * sms


def run_keyed_draws(device="cuda"):
    """Phase 27: K2 against its plain version on the card in every mode and
    both types (the f64 uniforms bit for bit hold Philox words 0-1, the f64
    normals words 0-3), at 4096 x 30 and at 16384 x 100 (on the grid, and at
    the timed parameters), and gamma at the rats sweep's scalar shapes; the
    moments of 10^6 draws per grid point against the exact ones; the
    overflow counter at 0; K2's kernels (registers, blocks an SM) and its
    code by pipe (SASS); the times and the work each mode's elements made."""
    from klara_tpu_torch.ops import keyed

    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(27)
    stream = keyed.KeyedStream(keyed.run_key(gen, device), K2_COMPARE_SHAPE[0], offset=12288,
                               step=5, site=2)
    compared, rats, big = [], [], K2_TIME_SHAPES["c16384_e100"]
    for dtype in (torch.float32, torch.float64):
        for mode in keyed.MODES:
            params = _k2_grid_params(mode, K2_COMPARE_SHAPE, device)
            compared.append(_k2_compare(stream.at(site=3 + keyed.MODES[mode]), mode, dtype,
                                        *params))
        for j, alpha in enumerate(K2_RATS_ALPHAS):
            rats.append(_k2_compare(stream.at(site=10 + j), "gamma", dtype, alpha,
                                    shape=K2_RATS_GAMMA_SHAPE))
        # the widest timed shape, where each thread strides over several elements
        # (the constants it keeps, its (chain, element) steps): the grid and the timed
        # parameters
        for mode, m in keyed.MODES.items():
            resident = _k2_resident_threads(m, dtype)
            if math.prod(big) <= resident:
                raise RuntimeError(f"K2 {mode} {dtype} holds {resident} threads at once: "
                                   f"{big} does not make a thread stride")
            compared.append(_k2_compare(stream.at(chains=big[0], site=40 + m), mode, dtype,
                                        *_k2_grid_params(mode, big, device), shape=big))
            if K2_TIME_PARAMS[mode]:
                compared.append(_k2_compare(stream.at(chains=big[0], site=50 + m), mode, dtype,
                                            *K2_TIME_PARAMS[mode], shape=big))
        for j, shape in enumerate(K2_JOB_SHAPES["uniform"].values()):
            compared.append(_k2_compare(stream.at(chains=shape[0], site=60 + j), "uniform",
                                        dtype, shape=shape))
    compared += rats
    worst_z = _k2_moments(stream.at(site=20))
    kernels = _k2_kernels()
    sass = k2_sass()
    # the profiler's records in this process, against the timing process's
    profiler_here = len(_k2_profiler_probe(stream))
    times = _k2_times_in_a_process(sass, device)
    profiler_there = times.pop("profiler_k2_kernels_of_20")
    torch.cuda.synchronize()
    overflow = int(keyed.overflow_counter(device)[0])
    if overflow:
        raise RuntimeError(f"K2's overflow counter reads {overflow}")
    keyed._PENDING.clear()
    res = {"seconds": time.perf_counter() - t_phase, "sass": sass, "kernels": kernels,
           "rats_gamma": rats,
           "max_abs_err": max(c["max_abs_err"] for c in compared if c["mode"] != "uniform"),
           "max_normal_ulps": max(c["max_ulps"] for c in compared if c["mode"] == "normal"),
           "max_other_attempt_share": max(c.get("other_attempt_share", 0.0) for c in compared),
           "worst_moment_z": worst_z, "overflow": overflow,
           "profiler_k2_kernels_of_20": {"this_process": profiler_here,
                                         "timing_process": profiler_there},
           "times": times}
    print(f"# phase 27 (K2 keyed draws): {json.dumps({k: v for k, v in res.items() if k != 'times'})}",
          flush=True)
    return res


def run_io(x_end):
    """Phases 21-23 in one temporary directory, removed at the end."""
    tmp = tempfile.mkdtemp(prefix="klara_io_")
    try:
        stream, job, twin, gen, data = run_io_stream(x_end, tmp)
        resume = run_io_resume(job, twin, gen, data, tmp)
        del job, twin
        gibbs = run_io_gibbs(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return stream, resume, gibbs


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(f"# card: {card}", flush=True)

    from klara_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    print(f"# K1 and K2 build (one nvcc each, in parallel): {time.perf_counter() - t0:.1f} s",
          flush=True)
    print("# " + _build.build_log.strip().replace("\n", "\n# "), flush=True)

    small = check_k1(5, 7, 300)
    ragged = check_k1(200, 100, 1000)
    mid = check_k1(SMALL_CHAINS, DIM, N_DATA, timed=True)
    big = check_k1(CHAINS, DIM, N_DATA, timed=True, single_pass=True)
    check_k1_against_float64()
    if "--keyed-only" in sys.argv:
        run_keyed_draws()
        print(card)
        return
    if "--stage1-sensitivity" in sys.argv:
        stage1_sensitivity()
        print(card)
        return
    if "--tracing-only" in sys.argv:
        run_tracing_cost()
        print(card)
        return
    if "--examples-only" in sys.argv:
        run_examples()
        print(card)
        return
    if "--lgcp-only" in sys.argv:
        run_lgcp_graphs_vs_eager()
        print(card)
        return
    profile_dir = sys.argv[sys.argv.index("--profile") + 1] if "--profile" in sys.argv else None
    chees, chees_summary, chees_end, x_end, chees_fingerprint = run_main_path()
    if "--parallel-only" in sys.argv:
        del chees_end, x_end
        run_meshed_main_path(chees, chees_fingerprint)
        run_two_ranks_on_one_card()
        print(card)
        return
    if profile_dir:
        profile_chees(*chees_end, profile_dir)
    if "--zoo-only" in sys.argv:
        run_zoo_logreg(x_end, chees_summary)
        run_zoo_ars()
        check_monitor_slots()
        print(card)
        return
    if "--io-only" in sys.argv:
        run_io(x_end)
        print(card)
        return
    nuts, wjob, state, chol, gen, data = run_nuts_precond(chees_summary)
    check_no_host_read(wjob, state, gen)
    if profile_dir:
        profile_nuts(wjob, state, gen, profile_dir)
    if "--graphs-only" not in sys.argv:
        looped = run_nuts_looped(wjob, state, chol, gen, nuts["mean_na"], data)
        raw = run_nuts_raw()
    gibbs, gjob, gchains, gv0, ggen = run_gibbs_rats()
    check_gibbs_no_host_read(gjob, gchains, gv0, ggen)
    # kernels and K2 launches per conjugate sweep (84.6-85.0 kernels with torch's own draws)
    gprof = profile_gibbs(gjob, gchains, gv0, ggen, profile_dir,
                          *((200, 20) if profile_dir else (GIBBS_PROFILE_SWEEPS, 5)))
    print(f"# phase 9 per sweep: {gprof['device_kernels_per_sweep']} kernels "
          f"({gprof['k2_kernels_per_sweep']} K2), {gibbs['ms_per_sweep']} ms of the run's wall, "
          f"{gprof['device_busy_us_per_sweep']} us of device time, "
          f"{gprof['k2_host_us_per_sweep']} us of host time in its K2 draws", flush=True)
    graphs28 = run_graphs_vs_eager(chees_end, (wjob, state, gen), (gjob, gchains, gv0, ggen))
    del chees_end, wjob, state
    run_lgcp_graphs_vs_eager()
    if "--graphs-only" in sys.argv:
        print(card)
        return
    nested = run_gibbs_nested(gibbs["by_key"])
    zoo = run_zoo_logreg(x_end, chees_summary)
    ars = run_zoo_ars()
    slots = check_monitor_slots()
    io_stream, io_resume, io_gibbs = run_io(x_end)
    del x_end
    examples, ex_summary = run_examples()
    meshed = run_meshed_main_path(chees, chees_fingerprint)
    two_ranks = run_two_ranks_on_one_card()
    keyed_draws = run_keyed_draws()

    by_path = {"chees_precond": chees["k1_launches"], "nuts_precond": nuts["k1_launches"],
               "nuts_looped": looped["k1_launches"], "nuts": raw["k1_launches"],
               "zoo_mala": zoo["mala"]["k1_launches"],
               "zoo_mala_16384": zoo["mala_16384"]["k1_launches"],
               "zoo_smmala": zoo["smmala"]["k1_launches"],
               "monitor_slots": slots["k1_launches"],
               "io_stream_mala": io_stream["k1_launches"],
               "io_resume_mala": io_resume["k1_launches"],
               **{f"ex_{k}": examples[k]["k1_launches"] for k in K1_EXAMPLES},
               "chees_precond_mesh1": meshed["k1_launches"],
               "multichip_scaling_mesh1": meshed["multichip_scaling"]["k1_launches"],
               **{f"mala_two_ranks_rank{r}": n
                  for r, n in enumerate(two_ranks["mala_k1_launches_per_rank"])}}
    for path, n in by_path.items():
        if n <= 0:
            raise RuntimeError(f"the {path} path launched no K1 kernel")
    # the Gibbs sweep runs no kernel of the port, as the JAX sweep runs no Pallas kernel;
    # RAM, AM, AMWG, slice and ARS evaluate logdensity_fn alone, as in the JAX package
    by_path.update(gibbs_rats=gibbs["k1_launches"], gibbs_rats_nested=nested["k1_launches"],
                   **{f"zoo_{k}": zoo[k]["k1_launches"] for k in ("ram", "am", "amwg", "slice")},
                   zoo_ars=ars["k1_launches"], io_gibbs_csv=io_gibbs["k1_launches"],
                   **{f"ex_{k}": v["k1_launches"] for k, v in examples.items()
                      if k not in K1_EXAMPLES},
                   # the param-sharded target's products are plain torch, as the JAX
                   # function runs no Pallas kernel
                   **{f"rats_two_ranks_rank{r}": n
                      for r, n in enumerate(two_ranks["rats_k1_launches_per_rank"])},
                   param_sharded_hmc=two_ranks["param"]["k1_launches"])
    err_by_path = {"chees_precond": chees["k1_max_abs_err_on_path"],
                   "nuts_precond": nuts["k1_max_abs_err_on_path"],
                   "nuts_looped": looped["k1_max_abs_err_on_path"],
                   "nuts": raw["k1_max_abs_err_on_path"],
                   **{f"zoo_{k}": zoo[k]["k1_max_abs_err_on_path"]
                      for k in ("mala", "mala_16384", "smmala")},
                   "io_stream_mala": io_stream["k1_max_abs_err_on_path"],
                   "io_resume_mala": io_resume["k1_max_abs_err_on_path"],
                   **{f"ex_{k}": examples[k]["k1_max_abs_err_on_path"] for k in K1_EXAMPLES},
                   "chees_precond_mesh1": meshed["k1_max_abs_err_on_path"]}
    # K2 makes every draw of every path: MCJob's (momentum, proposals, accept
    # uniforms, jitter, NUTS's uniforms, the init draws), the Gibbs conditionals
    k2_by_path = {"chees_precond": chees["k2_launches"], "nuts_precond": nuts["k2_launches"],
                  "nuts_looped": looped["k2_launches"], "nuts": raw["k2_launches"],
                  "gibbs_rats": gibbs["k2_launches"], "gibbs_rats_nested": nested["k2_launches"],
                  **{f"zoo_{k}": v["k2_launches"] for k, v in zoo.items()},
                  "zoo_ars": ars["k2_launches"], "monitor_slots": slots["k2_launches"],
                  "io_stream_mala": io_stream["k2_launches"],
                  "io_resume_mala": io_resume["k2_launches"],
                  "io_gibbs_csv": io_gibbs["k2_launches"],
                  **{f"ex_{k}": v["k2_launches"] for k, v in examples.items()},
                  "chees_precond_mesh1": meshed["k2_launches"],
                  "multichip_scaling_mesh1": meshed["multichip_scaling"]["k2_launches"],
                  **{f"{run}_two_ranks_rank{r}": n for run in ("mala", "rats", "mh")
                     for r, n in enumerate(two_ranks[f"{run}_k2_launches_per_rank"])},
                  "param_sharded_hmc": two_ranks["param"]["k2_launches"]}
    for path, n in k2_by_path.items():
        if n <= 0:
            raise RuntimeError(f"the {path} path launched no K2 kernel")
    # 3 TF32 passes x 2 products x 2*C*N*D operations over 495 TFLOP/s: 0.041 ms at the
    # main shape; the 13.6 MB of compulsory traffic would take 0.004 ms
    bound_ms, bound_by = k1_bound_ms(CHAINS, DIM, N_DATA)
    kernels = {"kernels": [{
        "name": "K1 logreg_value_grad",
        "route": "cuda",
        "design": "wgmma",
        "source": "klara_tpu_torch/ops/csrc/logreg.cu",
        "replaces": "klara_tpu/ops/logreg.py:120",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max([small["max_abs_err"], ragged["max_abs_err"], mid["max_abs_err"],
                            big["max_abs_err"], two_ranks["k1_c8192"]["max_abs_err"],
                            *err_by_path.values()]),
        "max_abs_err_by_path": err_by_path,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        # no single PyTorch call computes the value and the gradient of this function
        "library_ms": None,
        "ms_c4096": mid["ms"],
        "plain_ms_c4096": mid["plain_ms"],
        "bound_ms_c4096": k1_bound_ms(SMALL_CHAINS, DIM, N_DATA)[0],
        "ms_single_pass": big["single_pass"]["ms"],
        # the swiss examples' shape (phase 24): D=4 pads to 104 inside the kernel
        "ms_c64_d4_n200": ex_summary["k1_swiss"]["ms"],
        "plain_ms_c64_d4_n200": ex_summary["k1_swiss"]["plain_ms"],
        "bound_ms_c64_d4_n200": ex_summary["k1_swiss"]["bound_ms"],
        "launch_floor_ms": ex_summary["k1_swiss"]["launch_floor_ms"],
        # a rank's share of the main path on two ranks (phase 26)
        "ms_c8192": two_ranks["k1_c8192"]["ms"],
        "plain_ms_c8192": two_ranks["k1_c8192"]["plain_ms"],
        "bound_ms_c8192": two_ranks["k1_c8192"]["bound_ms"],
    }, {
        "name": "K2 keyed_draws",
        "route": "cuda",
        "design": "a kernel per (mode, type), one thread an element",
        "source": "klara_tpu_torch/ops/csrc/keyed_draws.cu",
        # no Pallas kernel: the counterpart of the JAX package's per-chain keys
        "replaces": None,
        "counterpart": "klara_tpu/jobs/job.py:609, klara_tpu/jobs/gibbs.py:328",
        "launches": sum(k2_by_path.values()),
        "launches_by_path": k2_by_path,
        "launches_by_mode_gibbs_rats": gibbs["k2_launches_by_mode"],
        "launches_per_step_chees_precond": chees["k2_launches_per_step"],
        "max_abs_err": keyed_draws["max_abs_err"],
        "max_normal_ulps": keyed_draws["max_normal_ulps"],
        "max_other_attempt_share": keyed_draws["max_other_attempt_share"],
        # the main path's largest launch: chees_precond's momentum, 16384 x 100 normals
        **{k: keyed_draws["times"]["normal"]["c16384_e100"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "by_mode": keyed_draws["times"],
        "kernels_by_mode": keyed_draws["kernels"],
    }]}
    # launches that came from graph replays, on the paths that run captured blocks
    for kernel, short in zip(kernels["kernels"], ("k1", "k2")):
        kernel["launches_in_graph_replays_by_path"] = {
            "chees_precond": chees[f"{short}_launches_in_replays"],
            "nuts_precond": nuts[f"{short}_launches_in_replays"],
            "gibbs_rats": gibbs[f"{short}_launches_in_replays"],
            **{f"phase28_{path}": graphs28[path]["graph"][f"{short}_launches_in_replays"]
               for path in ("chees_precond", "nuts_precond", "gibbs_rats")}}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        rank_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
    elif sys.argv[1:2] == ["--k2-times-worker"]:
        k2_times_worker(sys.argv[2], sys.argv[3])
    else:
        main()
