from klara_tpu_torch.utils import tracing
from klara_tpu_torch.utils.profiling import trace_profile

__all__ = ["trace_profile", "tracing"]
