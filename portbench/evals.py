"""Target evaluations read from the program's job reports: the replay-aware
counter ``core.target.FACTOR_EVALUATIONS`` (evaluations through a factor,
``klara_tpu_torch.core.target.through_factor``, which every LGCP
evaluation is; a graph capture's evaluations taken back and every
replay's added), as a phase's counter delta, and the work an LGCP
evaluation needs.  Where the program has no such counter, as before it
had the LGCP target, a phase holds no delta and a reader reports
nothing."""

from __future__ import annotations

import sys

COUNTER = "core.target.FACTOR_EVALUATIONS"


def lgcp_eval_flops(chains: int, dim: int) -> float:
    """One LGCP value+grad: x = μ + z Lᵀ and (y − m·e^x) L, two products by
    a triangular (D, D) factor, each C·D(D+1)/2 multiply-adds as the
    mathematics needs them (output column j of a row sums j + 1 terms):
    2·C·D(D+1) operations, whatever implements them."""
    return 2.0 * chains * dim * (dim + 1)


def of(phases, who):
    """The evaluations counted in ``phases`` (job-report phases), or None
    (said why) where none holds the counter."""
    got = [p["counters"][COUNTER][0] for p in phases if COUNTER in p["counters"]]
    if not got:
        print(f"# {who}: no {COUNTER} in the phases: not reported", file=sys.stderr)
        return None
    return sum(got)
