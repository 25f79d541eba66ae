"""The program's launch counters, read around a job: K1's and K2's wrappers
count every launch, a graph replay's included."""

from __future__ import annotations


def read() -> dict:
    from klara_tpu_torch.ops import keyed, logreg

    return {"k1": logreg.KERNEL_LAUNCHES, "k2": keyed.KERNEL_LAUNCHES}


def delta(before: dict) -> dict:
    now = read()
    return {k: now[k] - before[k] for k in now}
