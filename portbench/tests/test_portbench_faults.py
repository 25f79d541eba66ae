"""A whole run at toy size on the CPU, with the timed path broken underneath,
must read ``correct`` false: once for each fault a cell can have (one chip:
no exchange between chips to leave out), and for logreg once for each
adaptation hook of the warmup and for stage 1 alone."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness
from portbench.tests.toy import toy_root


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return toy_root(tmp_path_factory.mktemp("toy_faults"))


def _run(cell, toy):
    result, _ = harness.run_cell(cell, 2**31 + 77, 0.2, False, time.perf_counter(),
                                 device=torch.device("cpu"), root=toy)
    return result


def _hmc_unchanged(mp):
    from klara_tpu_torch.samplers import hmc

    finish = hmc.HMC.finish

    def unchanged(self, state, *args, **kwargs):
        _, info = finish(self, state, *args, **kwargs)
        return state, info

    mp.setattr(hmc.HMC, "finish", unchanged)


def _stage1_unchanged(mp):
    """Stage 1's step (its sampler caps leap counts at 256) returns its
    state unchanged; stage 2 runs as it should."""
    from klara_tpu_torch.samplers import hmc

    finish = hmc.HMC.finish

    def unchanged(self, state, *args, **kwargs):
        new, info = finish(self, state, *args, **kwargs)
        return (state, info) if self.max_nleaps == 256 else (new, info)

    mp.setattr(hmc.HMC, "finish", unchanged)


def _mass_of_half(mp):
    from klara_tpu_torch.jobs import job

    update = job.mass_update

    def half(states, i, burnin, mass_period):
        new = update(states._replace(position=states.position[: states.position.shape[0] // 2]),
                     i, burnin, mass_period)
        return states._replace(inv_mass=new.inv_mass.expand(states.inv_mass.shape))

    mp.setattr(job, "mass_update", half)


def _step_size_altered(mp):
    from klara_tpu_torch.tuners import tuners

    tune = tuners.DualAveragingTuner._tune

    def altered(self, *args, **kwargs):
        step, extra = tune(self, *args, **kwargs)
        return step * (1.0 + 1e-2), extra

    mp.setattr(tuners.DualAveragingTuner, "_tune", altered)


def _chees_altered(mp):
    """Stage 1's trajectory-length update off by 1% of log λ."""
    from klara_tpu_torch.jobs import job

    update = job.chees_update

    def altered(states, *args, **kwargs):
        new = update(states, *args, **kwargs)
        if new.log_traj is states.log_traj:
            return new
        return new._replace(log_traj=new.log_traj * (1.0 + 1e-2))

    mp.setattr(job, "chees_update", altered)


def _cholesky_of_half(mp):
    from klara_tpu_torch.jobs import job

    chol = job.ensemble_cholesky
    mp.setattr(job, "ensemble_cholesky", lambda x, ridge=1e-6: chol(x[: x.shape[0] // 2], ridge))


def _gradient_altered(mp):
    from klara_tpu_torch.models import examples

    vg = examples.logreg_value_grad

    def altered(*args, **kwargs):
        v, g = vg(*args, **kwargs)
        return v, g * (1.0 + 1e-2)

    mp.setattr(examples, "logreg_value_grad", altered)


def _sweep_unchanged(mp):
    from klara_tpu_torch.jobs.gibbs import GibbsJob

    mp.setattr(GibbsJob, "_sweep", lambda self, values, *a, **k: (dict(values), {}))


def _half_the_chains(mp):
    from klara_tpu_torch.jobs.gibbs import GibbsJob

    update = GibbsJob._block_update

    def half(self, var, values, *args, **kwargs):
        new, d = update(self, var, values, *args, **kwargs)
        old = values[var.key]
        keep = torch.arange(new.shape[0]) >= new.shape[0] // 2
        return torch.where(keep.view((-1,) + (1,) * (new.dim() - 1)), old, new), d

    mp.setattr(GibbsJob, "_block_update", half)


def _draw_altered(mp):
    from klara_tpu_torch.distributions import core

    sample = core.InverseGamma.sample
    mp.setattr(core.InverseGamma, "sample",
               lambda self, *a, **k: sample(self, *a, **k) * (1.0 + 1e-3))


FAULTS = {
    "logreg100.chees_16k": {"state_unchanged": _hmc_unchanged,
                            "stage1_state_unchanged": _stage1_unchanged,
                            "half_the_batch_in_the_mean": _cholesky_of_half,
                            "half_the_batch_in_the_mass": _mass_of_half,
                            "answer_altered": _gradient_altered,
                            "step_size_update_altered": _step_size_altered,
                            "trajectory_update_altered": _chees_altered},
    "rats.gibbs_4k": {"state_unchanged": _sweep_unchanged,
                      "half_the_batch_left_out": _half_the_chains,
                      "answer_altered": _draw_altered},
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs])
def test_fault_reads_incorrect(toy, monkeypatch, cell, fault):
    FAULTS[cell][fault](monkeypatch)
    result = _run(cell, toy)
    assert result["correct"] is False, result["compared"]
