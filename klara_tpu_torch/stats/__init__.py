"""Post-processing statistics (counterpart of klara_tpu/stats)."""

from klara_tpu_torch.stats.acceptance import acceptance
from klara_tpu_torch.stats.covariance import recursive_covariance
from klara_tpu_torch.stats.logistic import logistic
from klara_tpu_torch.stats.mcvar import (
    autocov,
    ess,
    iact,
    mcse,
    mcvar,
    mcvar_bm,
    mcvar_iid,
    mcvar_imse,
    mcvar_ipse,
)
from klara_tpu_torch.stats.mean import mean, recursive_mean
from klara_tpu_torch.stats.metrics import softabs
from klara_tpu_torch.stats.rhat import ess_bulk, ess_tail, rhat, rhat_rank
from klara_tpu_torch.stats.zv import lzv, qzv

__all__ = [
    "acceptance",
    "autocov",
    "ess",
    "iact",
    "logistic",
    "lzv",
    "mcse",
    "mcvar",
    "mcvar_bm",
    "mcvar_iid",
    "mcvar_imse",
    "mcvar_ipse",
    "mean",
    "qzv",
    "recursive_covariance",
    "recursive_mean",
    "rhat",
    "rhat_rank",
    "ess_bulk",
    "ess_tail",
    "softabs",
]
