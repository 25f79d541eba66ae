from klara_tpu_torch.jobs.chain import Chain
from klara_tpu_torch.jobs.gibbs import GibbsChains, GibbsJob, Nested
from klara_tpu_torch.jobs.job import MCJob, run
from klara_tpu_torch.jobs.range import MCRange

__all__ = ["Chain", "GibbsChains", "GibbsJob", "MCJob", "MCRange", "Nested", "run"]
