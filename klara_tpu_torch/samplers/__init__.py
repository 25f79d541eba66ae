from klara_tpu_torch.samplers.base import Info, Sampler, metropolis_accept
from klara_tpu_torch.samplers.hmc import HMC, HMCState
from klara_tpu_torch.samplers.mh import MH, MHState
from klara_tpu_torch.samplers.nuts import NUTS, NUTSDraws, NUTSState

__all__ = [
    "Info", "Sampler", "metropolis_accept", "HMC", "HMCState", "MH", "MHState",
    "NUTS", "NUTSDraws", "NUTSState",
]
