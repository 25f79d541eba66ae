from klara_tpu_torch.samplers.base import Info, Sampler, metropolis_accept
from klara_tpu_torch.samplers.hmc import HMC, HMCState

__all__ = ["Info", "Sampler", "metropolis_accept", "HMC", "HMCState"]
