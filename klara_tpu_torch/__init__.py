"""klara_tpu_torch — the PyTorch / CUDA port of klara_tpu.

Batch-first MCMC on NVIDIA GPUs: every function of a position takes a
leading chains axis, randomness comes from an explicit ``torch.Generator``,
and the hot op (the logistic-regression value+gradient) is a hand-written
CUDA kernel with a plain PyTorch version for CPU tensors.  ``parallel``
splits the chains over the ranks of a device mesh.  The JAX package
``klara_tpu`` is the reference each module is tested against.
"""

from klara_tpu_torch.core.target import Target, bounded_target, whiten_target
from klara_tpu_torch.jobs.chain import Chain
from klara_tpu_torch.jobs.gibbs import GibbsChains, GibbsJob, Nested
from klara_tpu_torch.jobs.job import MCJob, run
from klara_tpu_torch.jobs.range import MCRange
from klara_tpu_torch.models import (
    Constant,
    Data,
    GenericModel,
    GibbsParameter,
    Hyperparameter,
    Parameter,
    Transformation,
    likelihood_model,
)
from klara_tpu_torch.samplers import (
    AM,
    AMWG,
    ARS,
    HMC,
    MALA,
    MH,
    NUTS,
    RAM,
    SMMALA,
    NUTSState,
    SliceSampler,
)
from klara_tpu_torch.tuners import (
    AcceptanceRateTuner,
    DualAveragingTuner,
    RobertsRosenthalTuner,
    VanillaTuner,
)
from klara_tpu_torch import data, distributions, io, parallel, stats

__version__ = "0.1.0"

__all__ = [
    "Target",
    "bounded_target",
    "whiten_target",
    "Chain",
    "MCJob",
    "MCRange",
    "run",
    "GibbsJob",
    "GibbsChains",
    "Nested",
    "GenericModel",
    "GibbsParameter",
    "Parameter",
    "Constant",
    "Hyperparameter",
    "Data",
    "Transformation",
    "likelihood_model",
    "MH",
    "AM",
    "RAM",
    "AMWG",
    "ARS",
    "MALA",
    "SMMALA",
    "SliceSampler",
    "HMC",
    "NUTS",
    "NUTSState",
    "VanillaTuner",
    "AcceptanceRateTuner",
    "DualAveragingTuner",
    "RobertsRosenthalTuner",
    "data",
    "distributions",
    "io",
    "parallel",
    "stats",
]
