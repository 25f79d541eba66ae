"""Swiss Bayesian logistic regression across the sampler zoo
(counterpart of examples/swiss_samplers.py).

Reference: doc/examples/swiss/*: MALA (analytical / AD), SMMALA, RAM,
HMC, NUTS, slice on the 200×4 swiss banknote data.  The reference's
forwarddiff/reversediff AD variants run on autograd
(analytical_grad=False).
"""

import torch

import klara_tpu_torch as kt
from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.models.examples import swiss_logistic_regression


def main(n_chains=64, n_steps=6000, burnin=2000, device=None):
    device = resolve_device(device)
    target, X, y = swiss_logistic_regression(analytical_grad=True, device=device)
    target_ad, _, _ = swiss_logistic_regression(analytical_grad=False, device=device)
    x0 = torch.tensor([5.1, -0.9, 8.2, -4.5], device=device)
    mcrange = kt.MCRange(n_steps=n_steps, burnin=burnin)

    runs = [
        ("MALA analytical", target, kt.MALA(0.02), None),
        ("MALA autograd  ", target_ad, kt.MALA(0.02), None),
        ("MALA tuned     ", target, kt.MALA(0.02), kt.AcceptanceRateTuner(0.574)),
        ("RAM            ", target, kt.RAM(S0=0.1), None),
        # reference uses SMMALA(0.02) + AcceptanceRateMCTuner(0.5)
        # (doc/examples/swiss/SMMALA/analytical.jl:36,44)
        ("SMMALA         ", target, kt.SMMALA(0.02), kt.AcceptanceRateTuner(0.5)),
        ("HMC            ", target, kt.HMC(0.1, 10), kt.DualAveragingTuner(0.8, 2000)),
        ("NUTS           ", target, kt.NUTS(), kt.DualAveragingTuner(0.8, 2000)),
        ("Slice          ", target, kt.SliceSampler(widths=1.0), None),
    ]
    for name, tgt, sampler, tuner in runs:
        job = kt.MCJob(tgt, sampler, mcrange, tuner=tuner, n_chains=n_chains)
        chain = job.run(torch.Generator(device).manual_seed(0), x0)
        print(
            f"{name} mean={kt.stats.mean(chain)} "
            f"acc={float(kt.stats.acceptance(chain)):.3f}"
        )


if __name__ == "__main__":
    main()
