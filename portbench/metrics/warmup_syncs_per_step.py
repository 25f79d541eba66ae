"""Host synchronisations a warmup step: torch's sync debug warnings raised
in the warmup span of the window's first job run again under that mode
alone (no profiler), over its warmup steps."""

NEEDS = "syncs"


def read(run):
    if run.synced is None:
        return None
    rec, syncs = run.synced
    t0, t1 = rec["spans"]["warmup"]
    return sum(t0 <= t < t1 for t in syncs) / rec["warmup_steps"]
