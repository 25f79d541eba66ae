"""Chain data-parallel scaling over a device mesh (counterpart of
examples/multichip_scaling.py).

Splits 16k chains of NUTS on the 100-dim logistic regression over every rank
of the process group (the 'chains' mesh dimension), with pooled
dual-averaging adaptation (an all-reduce over the chains group each step).
One process makes a one-rank group of its own:

    python examples_torch/multichip_scaling.py --chains 512 --steps 100

Several processes, one per card, each join the group first through
``kt.parallel.initialize_distributed(...)`` and then run the same code.
"""

import argparse
import time

import torch

import klara_tpu_torch as kt
from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.models.examples import synthetic_logistic_regression
from klara_tpu_torch.parallel import chain_mesh


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(n_chains=16384, n_steps=500, burnin=200, dim=100, device=None):
    """Two runs of the meshed job (the first warms up); returns the timed
    run's seconds, draws/s and min ESS."""
    device = resolve_device(device)
    target, _, _ = synthetic_logistic_regression(dim=dim, n_data=1024, device=device)
    mesh = chain_mesh(device=device)
    print(f"ranks: {mesh.size()}  chains: {n_chains}")

    job = kt.MCJob(
        target,
        kt.NUTS(max_doublings=6),
        kt.MCRange(n_steps=n_steps, burnin=burnin),
        tuner=kt.DualAveragingTuner(0.8, burnin),
        n_chains=n_chains,
        mesh=mesh,
        pooled_tuning=True,
        monitor=("value",),
    )
    x0 = torch.zeros((n_chains, dim), dtype=torch.float32, device=device)

    chain = job.run(torch.Generator(device).manual_seed(0), x0)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    chain = job.run(torch.Generator(device).manual_seed(1), x0)
    _sync(device)
    dt = time.perf_counter() - t0

    draws = chain.n_post * n_chains
    min_ess = float(torch.min(kt.stats.ess(chain)))
    print(f"{draws} draws in {dt:.2f}s = {draws/dt:.0f} draws/s")
    print(f"min ESS: {min_ess:.0f}")
    return {"seconds": dt, "draws_per_second": draws / dt, "min_ess": min_ess}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--burnin", type=int, default=200)
    ap.add_argument("--dim", type=int, default=100)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(a.chains, a.steps, a.burnin, a.dim, a.device)
