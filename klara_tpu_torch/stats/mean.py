"""Posterior mean + recursive mean (counterpart of klara_tpu/stats/mean.py)."""

from __future__ import annotations

import torch

from klara_tpu_torch.parallel.mesh import active_block, gather_chains, mean_over_chains
from klara_tpu_torch.stats._common import chain_scope, extract_f32


def mean(chain, field: str = "value", per_chain: bool = False):
    """Mean of a monitored field across draws (and chains); bf16 traces are
    promoted to f32 first.  A meshed chain's mean is the global one on every
    rank (per chain: every rank's chains)."""
    arr = extract_f32(chain, field)
    with chain_scope(chain, arr):
        if per_chain:
            return gather_chains(arr.mean(0))
        if active_block() is None:
            return arr.mean((0, 1))
        return mean_over_chains(arr.mean(0))


def recursive_mean(last_mean, k, new_value):
    """mean_k = mean_{k-1} + (x_k − mean_{k-1}) / k."""
    return last_mean + (new_value - last_mean) / k
