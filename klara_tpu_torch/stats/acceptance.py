"""Acceptance rate of a chain (counterpart of klara_tpu/stats/acceptance.py):
from the ``accept`` diagnostics channel, or from the fraction of draws that
moved."""

from __future__ import annotations

import torch


def acceptance(chain, key: str = "accept", diagnostics: bool = True, per_chain: bool = False):
    if diagnostics:
        acc = chain.diagnostics[key] if hasattr(chain, "diagnostics") else chain
        acc = torch.as_tensor(acc).to(torch.float32)
        return acc.mean(0) if per_chain else acc.mean()
    values = chain["value"] if hasattr(chain, "samples") else torch.as_tensor(chain)
    moved = (values[1:] != values[:-1])
    if moved.dim() > 2:
        moved = moved.flatten(2).any(-1)
    moved = moved.to(torch.float32)
    return moved.mean(0) if per_chain else moved.mean()
