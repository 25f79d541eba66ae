from klara_tpu_torch.models.examples import (
    logistic_regression_target,
    normal_target,
    rats_gibbs_model,
    rats_joint_target,
    swiss_logistic_regression,
    synthetic_logistic_regression,
)
from klara_tpu_torch.models.graph import (
    Constant,
    Data,
    GenericModel,
    GibbsParameter,
    Hyperparameter,
    Parameter,
    Transformation,
    Variable,
    likelihood_model,
)

__all__ = [
    "Constant",
    "Data",
    "GenericModel",
    "GibbsParameter",
    "Hyperparameter",
    "Parameter",
    "Transformation",
    "Variable",
    "likelihood_model",
    "logistic_regression_target",
    "normal_target",
    "rats_gibbs_model",
    "rats_joint_target",
    "swiss_logistic_regression",
    "synthetic_logistic_regression",
]
