"""MCMC range: burnin / thinning / number of steps (counterpart of
klara_tpu/jobs/range.py).  Steps are 0-based: step i is saved iff
i >= burnin and (i - burnin) % thinning == 0."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MCRange:
    n_steps: int = 100
    burnin: int = 0
    thinning: int = 1

    def __post_init__(self):
        if self.burnin < 0:
            raise ValueError("burnin must be non-negative")
        if self.thinning < 1:
            raise ValueError("thinning must be >= 1")
        if self.n_steps <= self.burnin:
            raise ValueError("n_steps must exceed burnin")

    @property
    def n_post(self) -> int:
        """Number of saved draws."""
        return (self.n_steps - self.burnin - 1) // self.thinning + 1
