"""Student-t target: MH and slice on a heavy-tailed unnormalised density
(counterpart of examples/t_mh.py).

Reference family: the t-distribution examples alongside Normal/Gamma/
Poisson (doc/examples structure).  Target: t_nu(loc, scale) with nu = 5,
loc = 2, scale = 1.5.  Asserts posterior median ~ loc and the
interquartile range of the exact t (robust moments: the t's tails make
raw variance estimates noisy).  The chains start from the 0-d ``LOC``:
the job lifts the scalar target to dim 1, so the log-density sees one
scalar per chain, (C,).
"""

import numpy as np
import torch

import klara_tpu_torch as kt
from klara_tpu_torch.core.device import resolve_device

NU, LOC, SCALE = 5.0, 2.0, 1.5


def _target():
    def logdensity(x):
        z = (x - LOC) / SCALE
        return -0.5 * (NU + 1.0) * torch.log1p(z * z / NU)

    return kt.Target(logdensity_fn=logdensity, dim=1)


def _check(chain, name):
    flat = chain.flat("value").cpu().numpy().reshape(-1)
    med = np.median(flat)
    q75, q25 = np.percentile(flat, [75, 25])
    # exact t(5) quartile: 0.7267
    iqr_true = 2 * 0.7267 * SCALE
    print(f"{name:16s} median={med:.3f} iqr={q75-q25:.3f} (true {iqr_true:.3f})")
    assert abs(med - LOC) < 0.1, (name, med)
    np.testing.assert_allclose(q75 - q25, iqr_true, rtol=0.1, err_msg=name)


T_EXAMPLES = {}


def _t_mh(n_chains=32, n_steps=8000, burnin=1000, device=None):
    device = resolve_device(device)
    job = kt.MCJob(
        _target(),
        kt.MH(sigma=2.0),
        kt.MCRange(n_steps=n_steps, burnin=burnin),
        n_chains=n_chains,
    )
    chain = job.run(torch.Generator(device).manual_seed(0), torch.tensor(LOC, device=device))
    _check(chain, "t(5) MH")
    return chain


def _t_slice(n_chains=32, n_steps=5000, burnin=500, device=None):
    device = resolve_device(device)
    job = kt.MCJob(
        _target(),
        kt.SliceSampler(widths=4.0),
        kt.MCRange(n_steps=n_steps, burnin=burnin),
        n_chains=n_chains,
    )
    chain = job.run(torch.Generator(device).manual_seed(1), torch.tensor(LOC, device=device))
    _check(chain, "t(5) slice")
    return chain


T_EXAMPLES["t_mh"] = _t_mh
T_EXAMPLES["t_slice"] = _t_slice


def main(n_chains=32, device=None):
    for fn in T_EXAMPLES.values():
        fn(n_chains, device=device)


if __name__ == "__main__":
    main()
