"""Acceptance rate of a chain (counterpart of klara_tpu/stats/acceptance.py):
from the ``accept`` diagnostics channel, or from the fraction of draws that
moved."""

from __future__ import annotations

import torch

from klara_tpu_torch.parallel.mesh import active_block, gather_chains, mean_over_chains
from klara_tpu_torch.stats._common import chain_scope


def acceptance(chain, key: str = "accept", diagnostics: bool = True, per_chain: bool = False):
    """The mean of the ``accept`` diagnostic (or of the draws that moved)
    over draws and chains; per chain with ``per_chain``.  A meshed chain's
    rate is the global one on every rank."""
    if diagnostics:
        acc = chain.diagnostics[key] if hasattr(chain, "diagnostics") else chain
        acc = torch.as_tensor(acc).to(torch.float32)
    else:
        values = chain["value"] if hasattr(chain, "samples") else torch.as_tensor(chain)
        acc = (values[1:] != values[:-1])
        if acc.dim() > 2:
            acc = acc.flatten(2).any(-1)
        acc = acc.to(torch.float32)
    with chain_scope(chain, acc):
        if per_chain:
            return gather_chains(acc.mean(0))
        if active_block() is None:
            return acc.mean()
        return mean_over_chains(acc.mean(0))
