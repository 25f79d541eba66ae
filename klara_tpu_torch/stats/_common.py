"""Shared field extraction for the stats layer (counterpart of
klara_tpu/stats/_common.py).  Entry points take a Chain or a tensor; floats
narrower than 32 bits (a bf16 trace) are promoted to f32 before any
reduction, since a bf16 accumulator rounds a long sum away."""

from __future__ import annotations

import torch


def extract_f32(chain_or_array, field: str = "value"):
    x = chain_or_array[field] if hasattr(chain_or_array, "samples") else chain_or_array
    x = torch.as_tensor(x)
    if x.is_floating_point() and torch.finfo(x.dtype).bits < 32:
        x = x.to(torch.float32)
    return x
