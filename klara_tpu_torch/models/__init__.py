from klara_tpu_torch.models.examples import (
    logistic_regression_target,
    normal_target,
    swiss_logistic_regression,
    synthetic_logistic_regression,
)

__all__ = [
    "logistic_regression_target",
    "normal_target",
    "swiss_logistic_regression",
    "synthetic_logistic_regression",
]
