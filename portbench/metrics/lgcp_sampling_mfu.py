"""The LGCP's whole sampling step's share of the card's dense TF32 peak, in
%: the useful work of its evaluations' two triangular products (2·C·D(D+1)
operations an evaluation, ``evals.lgcp_eval_flops``), times the evaluations
the program's replay-aware counter counted in the sampling phase, over the
program's sampling spans × 495 TFLOP/s (``sampling_mfu``'s peak), all jobs
of the window (the program's job reports)."""

from portbench import evals, program, work


def read(run):
    reports = program.job_reports(run, "lgcp_sampling_mfu")
    if reports is None:
        return None
    phases = [program.sampling_phase(r) for r in reports]
    flops = 0.0
    for p, j in zip(phases, run.jobs):
        n = evals.of([p], "lgcp_sampling_mfu")
        if n is None:
            return None
        flops += n * evals.lgcp_eval_flops(j["work"]["chains"], j["work"]["dim"])
    return 100.0 * flops / (work.TF32_FLOPS * sum(p["seconds"] for p in phases))
