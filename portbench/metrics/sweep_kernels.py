"""Device kernels a sweep: the profiled job's device operations in its
sampling span over its sweeps."""
NEEDS = "trace"


def read(run):
    if run.trace is None:
        return None
    n, _ = run.trace.kernels("sampling")
    return n / run.traced["steps"]
