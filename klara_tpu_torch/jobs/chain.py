"""Markov-chain trace (counterpart of klara_tpu/jobs/chain.py): a dict of
tensors shaped (n_post, n_chains, *event_shape) per monitored field, a dict
of per-draw diagnostics, and the final sampler state.  A chain run on a mesh
holds this rank's block of the chains and names its ``mesh`` and
``chains_axis``; the statistics of ``klara_tpu_torch.stats`` reduce it over
every rank."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass
class Chain:
    samples: Dict[str, torch.Tensor]
    diagnostics: Dict[str, torch.Tensor]
    final_state: Any = None
    mesh: Any = None
    chains_axis: str = "chains"

    @property
    def value(self):
        return self.samples["value"]

    @property
    def n_post(self) -> int:
        return next(iter(self.samples.values())).shape[0]

    @property
    def n_chains(self) -> int:
        return next(iter(self.samples.values())).shape[1]

    def __getitem__(self, field: str):
        if field in self.samples:
            return self.samples[field]
        return self.diagnostics[field]

    def flat(self, field: str = "value"):
        """Merge step and chain axes: (n_post * n_chains, ...)."""
        arr = self[field]
        return arr.reshape((-1,) + tuple(arr.shape[2:]))
