"""Smoke run of the PyTorch port (klara_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels from ``klara_tpu_torch/ops/csrc``;
3. compare kernel K1 (batched logreg value+grad) with its plain PyTorch
   version on the card, TF32 off, at C=5/D=7/N=300 and at the main path's
   C=16384/D=100/N=1024, and time both (CUDA events, 50 calls after warm-up);
4. run the main path, ``MCJob.run_preconditioned`` with the chees_precond
   settings of bench.py, at 16384 chains on the 100-dim synthetic logistic
   regression (1024 rows), 300 burnin and 2000 post draws, bf16 trace;
   check that K1 was launched, every draw is finite, the chunked rank-R̂
   max is at most 1.02 and pooled acceptance lies in [0.6, 0.95]; print
   the phase times, min ESS, ESS/s and leaps per draw.

The last two lines of stdout are the kernels' JSON summary and the device
JSON line.  Matmuls run in full f32 (TF32 off), the precision the JAX
bench's 'high' setting approximates; the tolerances below assume it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# phase-3 tolerances: the kernel and cuBLAS sum in different orders
VALUE_RTOL, VALUE_ATOL = 1e-5, 1e-3
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3
RHAT_GATE = 1.02  # bench.py's mixing gate
ACCEPT_RANGE = (0.6, 0.95)

DIM, N_DATA, CHAINS, BURNIN, POST = 100, 1024, 16384, 300, 2000


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


def check_k1(C, D, N, seed=0, timed=False):
    """K1 against its plain version on the same card inputs; returns the
    max abs error and, if ``timed``, both times in ms."""
    from klara_tpu_torch.ops import logreg

    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(N, D, generator=g, device="cuda")
    y = (torch.rand(N, generator=g, device="cuda") < 0.5).float()
    P = 0.3 * torch.randn(C, D, generator=g, device="cuda")
    v = (X.T @ y).contiguous()
    val, grad = logreg.logreg_value_grad(P, X, v, 100.0)
    rval, rgrad = logreg.logreg_value_grad_reference(P, X, v, 100.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(val, rval, rtol=VALUE_RTOL, atol=VALUE_ATOL)
    torch.testing.assert_close(grad, rgrad, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    err = max(float((val - rval).abs().max()), float((grad - rgrad).abs().max()))
    out = {"shape": [C, D, N], "max_abs_err": err}
    if timed:
        out["ms"] = _time_ms(lambda: logreg.logreg_value_grad(P, X, v, 100.0))
        out["plain_ms"] = _time_ms(lambda: logreg.logreg_value_grad_reference(P, X, v, 100.0))
    print(f"# K1 vs plain at C={C} D={D} N={N}: {out}", flush=True)
    return out


def _ess_min_chunked(values, chol, chunk):
    """min over dims of the chain-summed ESS of a whitened trace, mapped
    back to x = y Lᵀ one chain chunk at a time (as bench.py)."""
    import klara_tpu_torch as kt

    total = None
    for s in range(0, values.shape[1], chunk):
        e = kt.stats.ess(values[:, s:s + chunk].to(torch.float32) @ chol.T)
        total = e if total is None else total + e
    return float(total.min())


def _rhat_max(values, chol, max_draws=512, dim_chunk=16, chains_cap=2048):
    """Max over coordinates of rank-R̂ on up to 512 evenly thinned draws of
    up to 2048 chains, back-transformed per dim chunk (as bench.py)."""
    import klara_tpu_torch as kt

    values = values[:, :chains_cap]
    step = max(1, values.shape[0] // max_draws)
    y = values[::step].to(torch.float32)
    return max(
        float(kt.stats.rhat_rank(y @ chol[s:s + dim_chunk].T).max())
        for s in range(0, values.shape[-1], dim_chunk)
    )


def run_main_path(device="cuda", chains=CHAINS, dim=DIM, n_data=N_DATA, burnin=BURNIN,
                  post=POST):
    """chees_precond at bench size through the port's public entry points."""
    import klara_tpu_torch as kt
    from klara_tpu_torch.models.examples import synthetic_logistic_regression
    from klara_tpu_torch.ops import logreg

    target, _, _ = synthetic_logistic_regression(dim=dim, n_data=n_data, device=device)
    s1 = kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=0.5, jitter=0.9,
                jitter_style="step", max_nleaps=256)
    s2 = kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=2.0, jitter=0.9,
                jitter_style="step", max_nleaps=64)
    trace_dtype = "bfloat16" if post * chains * dim * 4 > 4e9 else None
    job = kt.MCJob(
        target, s1, kt.MCRange(n_steps=burnin + post, burnin=burnin),
        tuner=kt.DualAveragingTuner(0.8, burnin), n_chains=chains,
        monitor=("value",), diagnostics=("accept", "nleaps"), pooled_tuning=True,
        mass_adaptation=True, mass_period=50, trace_dtype=trace_dtype,
        traj_adaptation=True,
    )
    gen = torch.Generator(device=device).manual_seed(42)
    x0 = 0.1 * torch.randn(chains, dim, generator=gen, device=device)

    logreg.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    chain, timings, info = job.run_preconditioned(
        gen, x0, stage2_replace=dict(sampler=s2, traj_adaptation=False),
        back_transform=False,
    )
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = logreg.KERNEL_LAUNCHES

    values, chol = chain.value, info["chol"]
    if launches <= 0:
        raise RuntimeError("the main path launched no K1 kernel")
    if tuple(values.shape) != (post, chains, dim):
        raise RuntimeError(f"trace shape {tuple(values.shape)}")
    if not bool(torch.isfinite(values).all()):
        raise RuntimeError("non-finite draws in the trace")
    nfft = 1
    while nfft < 2 * post:
        nfft *= 2
    chunk = min(2048, max(128, (1 << 28) // (nfft * dim)))
    min_ess = _ess_min_chunked(values, chol, chunk)
    rhat = _rhat_max(values, chol)
    accept = float(kt.stats.acceptance(chain))
    leaps = float(chain["nleaps"].to(torch.float64).mean())
    res = {
        "warmup_seconds": timings["warmup_seconds"],
        "sampling_seconds": timings["sampling_seconds"],
        "wall_seconds": wall,
        "min_ess": min_ess,
        "ess_per_sec": min_ess / timings["sampling_seconds"],
        "rhat_max": rhat,
        "acceptance": accept,
        "leaps_per_draw": leaps,
        "eps_final": float(chain.final_state.tune.step.mean()),
        "trace_dtype": str(values.dtype),
        "k1_launches": launches,
    }
    print(f"# chees_precond {chains}x{dim}x{n_data}: {json.dumps(res)}", flush=True)
    if rhat > RHAT_GATE:
        raise RuntimeError(f"rank-R-hat {rhat} > {RHAT_GATE}")
    if not ACCEPT_RANGE[0] <= accept <= ACCEPT_RANGE[1]:
        raise RuntimeError(f"acceptance {accept} outside {ACCEPT_RANGE}")
    return res


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
    _build.load()
    print(f"# K1 build: {time.perf_counter() - t0:.1f} s", flush=True)
    print("# " + _build.build_log.strip().replace("\n", "\n# "), flush=True)

    check_k1(5, 7, 300)
    big = check_k1(CHAINS, DIM, N_DATA, timed=True)
    main_path = run_main_path()

    kernels = {"kernels": [{
        "name": "K1 logreg_value_grad",
        "route": "cuda",
        "source": "klara_tpu_torch/ops/csrc/logreg.cu",
        "replaces": "klara_tpu/ops/logreg.py:120",
        "launches": main_path["k1_launches"],
        "max_abs_err": big["max_abs_err"],
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
    }]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
