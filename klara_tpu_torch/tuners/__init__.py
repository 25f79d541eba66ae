from klara_tpu_torch.tuners.tuners import (
    AcceptanceRateTuner,
    DualAveragingExtra,
    DualAveragingTuner,
    RobertsRosenthalExtra,
    RobertsRosenthalTuner,
    Tuner,
    TuneState,
    VanillaTuner,
    erf_rate_score,
    logistic_rate_score,
)

__all__ = [
    "Tuner",
    "TuneState",
    "VanillaTuner",
    "AcceptanceRateTuner",
    "logistic_rate_score",
    "erf_rate_score",
    "DualAveragingTuner",
    "DualAveragingExtra",
    "RobertsRosenthalTuner",
    "RobertsRosenthalExtra",
]
