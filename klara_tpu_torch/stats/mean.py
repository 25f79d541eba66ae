"""Posterior mean + recursive mean (counterpart of klara_tpu/stats/mean.py)."""

from __future__ import annotations

import torch

from klara_tpu_torch.stats._common import extract_f32


def mean(chain, field: str = "value", per_chain: bool = False):
    """Mean of a monitored field across draws (and chains); bf16 traces are
    promoted to f32 first."""
    arr = extract_f32(chain, field)
    return arr.mean(0) if per_chain else arr.mean((0, 1))


def recursive_mean(last_mean, k, new_value):
    """mean_k = mean_{k-1} + (x_k − mean_{k-1}) / k."""
    return last_mean + (new_value - last_mean) / k
