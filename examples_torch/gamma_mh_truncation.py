"""MH with a truncated-Normal proposal on a Gamma target whose support
differs from the proposal's natural one (counterpart of
examples/gamma_mh_truncation.py).

Reference: doc/examples/Gamma/MH/truncation.jl: unnormalised Gamma(k, θ)
log-target (k−1)·log(p) − p/θ on p > 0, Constant vertices k and θ
supplying the hyper-parameters through the model graph, and a
Truncated(Normal(x), 0, Inf) proposal with the asymmetric MH correction.
Run both correction styles:

  * the normalised TruncatedNormal proposal with plain
    ``MH(symmetric=False)``;
  * a RAW (non-normalised) truncated kernel with ``MH(normalised=False)``:
    the reference's `lognormalise` path (src/samplers/iterate/MH.jl:14-24),
    exercising the proposal's ``lognormaliser()`` hook.

Both must agree with the Gamma(k, θ) moments mean=kθ, var=kθ².  ``main``
returns each style's chain.
"""

import dataclasses

import torch

import klara_tpu_torch as kt
from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.distributions import TruncatedNormal
from klara_tpu_torch.models.graph import Constant, GibbsParameter, likelihood_model


@dataclasses.dataclass(frozen=True)
class RawTruncatedNormal(TruncatedNormal):
    """Truncated Normal whose logpdf OMITS the truncation normaliser: the
    reference's non-normalised proposal shape, corrected in the MH ratio
    via ``lognormaliser()``."""

    def logpdf(self, x):
        return super().logpdf(x) + self.lognormaliser()


def main(k=2.0, theta=1.0, n_chains=64, n_steps=20000, burnin=2000, device=None):
    device = resolve_device(device)
    # model graph with Constant hyper-parameter vertices, as in the
    # reference example (likelihood_model([Constant(:k), Constant(:θ), p]));
    # the support check is per chain
    p = GibbsParameter(
        "p",
        logtarget=lambda x, v: ((v["k"] - 1.0) * torch.log(x) - x / v["theta"]).sum(-1)
        + torch.where((x > 0).all(-1), 0.0, -torch.inf),
    )
    model = likelihood_model([Constant("k"), Constant("theta"), p])
    v0 = {"k": k, "theta": theta, "p": 10.0}

    results = {}
    for label, sampler in {
        "normalised": kt.MH(
            proposal_fn=lambda x, s: TruncatedNormal(x, s[:, None], 0.0, torch.inf),
            symmetric=False,
        ),
        "lognormalise-corrected": kt.MH(
            proposal_fn=lambda x, s: RawTruncatedNormal(x, s[:, None], 0.0, torch.inf),
            symmetric=False,
            normalised=False,
        ),
    }.items():
        job, x0 = kt.MCJob.from_model(
            model,
            sampler,
            kt.MCRange(n_steps=n_steps, burnin=burnin),
            v0,
            n_chains=n_chains,
            device=device,
        )
        chain = job.run(torch.Generator(device).manual_seed(0),
                        torch.full((n_chains, 1), 10.0, device=device))
        draws = chain.flat("value").cpu().numpy()
        acc = float(kt.stats.acceptance(chain))
        print(
            f"{label:>24}: mean={draws.mean():.4f} (target {k*theta}), "
            f"var={draws.var():.4f} (target {k*theta**2}), accept={acc:.3f}"
        )
        results[label] = chain
    return results


if __name__ == "__main__":
    main()
