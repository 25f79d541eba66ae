from klara_tpu_torch.tuners.tuners import (
    DualAveragingExtra,
    DualAveragingTuner,
    Tuner,
    TuneState,
    VanillaTuner,
)

__all__ = [
    "Tuner",
    "TuneState",
    "VanillaTuner",
    "DualAveragingTuner",
    "DualAveragingExtra",
]
