from klara_tpu_torch.samplers.am import AM, AMState
from klara_tpu_torch.samplers.amwg import AMWG, AMWGState
from klara_tpu_torch.samplers.ars import ARS, ARSState
from klara_tpu_torch.samplers.base import Info, Sampler, metropolis_accept
from klara_tpu_torch.samplers.hmc import HMC, HMCState
from klara_tpu_torch.samplers.mala import MALA, MALAState
from klara_tpu_torch.samplers.mh import MH, MHState
from klara_tpu_torch.samplers.nuts import NUTS, NUTSDraws, NUTSState
from klara_tpu_torch.samplers.ram import RAM, RAMState
from klara_tpu_torch.samplers.slice_sampler import SliceDraws, SliceSampler, SliceState
from klara_tpu_torch.samplers.smmala import SMMALA, SMMALAState

__all__ = [
    "Info", "Sampler", "metropolis_accept", "HMC", "HMCState", "MH", "MHState",
    "NUTS", "NUTSDraws", "NUTSState", "MALA", "MALAState", "AM", "AMState",
    "RAM", "RAMState", "AMWG", "AMWGState", "SliceSampler", "SliceState",
    "SliceDraws", "ARS", "ARSState", "SMMALA", "SMMALAState",
]
