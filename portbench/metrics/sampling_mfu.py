"""The sampling phase's share of the card's dense TF32 peak, in %: every
useful target evaluation's K1 and whitening products (``work``), at the leap
counts (HMC) or live leaves (NUTS) the jobs saved, over the program's
sampling spans, all jobs."""

from portbench import work


def read(run):
    flops = sum(j["work"]["sampling_evals"] * work.whitened_eval_flops(
        j["work"]["chains"], j["work"]["n_data"], j["work"]["dim"]) for j in run.jobs)
    return 100.0 * flops / (work.TF32_FLOPS * sum(j["sampling_s"] for j in run.jobs))
