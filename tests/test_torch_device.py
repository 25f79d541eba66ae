"""The port's default device: with no ``device`` and no tensor among the
inputs every entry point that builds tensors uses the card, and where there
is none it raises an error that names ``device="cpu"``; with
``device="cpu"`` it runs.  A job follows the tensors it is given."""

import types

import numpy as np
import pytest
import torch

import klara_tpu_torch as kt
from klara_tpu_torch import convert
from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.models import examples as tex
from klara_tpu_torch.models import lgcp

RNG = np.random.default_rng(0)
X = RNG.standard_normal((20, 3)).astype(np.float32)
Y = (RNG.random(20) < 0.5).astype(np.float32)


def _tune(C=4):
    z = np.zeros(C, np.float32)
    return types.SimpleNamespace(step=z + 0.1, accepted=z, proposed=z.astype(np.int32),
                                 totproposed=z.astype(np.int32), rate=z, extra=())


def _hmc_state(C=4, D=3):
    z = np.zeros((C, D), np.float32)
    return types.SimpleNamespace(
        position=z, logtarget=np.zeros(C, np.float32), gradlogtarget=z, inv_mass=z + 1,
        tune=_tune(C), log_traj=np.zeros(C, np.float32), traj_m=np.zeros(C, np.float32),
        traj_v=np.zeros(C, np.float32))


def _normal_job(device=None):
    return kt.MCJob(tex.normal_target(2), kt.HMC(leapstep=0.1, nleaps=2), kt.MCRange(n_steps=5, burnin=2),
                    n_chains=3, device=device)


def _gibbs_job(device=None):
    p = kt.GibbsParameter("p", setpdf=lambda v: kt.distributions.Normal(v["m"], 1.0))
    return kt.GibbsJob(kt.GenericModel([kt.Hyperparameter("m"), p]), {},
                       kt.MCRange(n_steps=4), n_chains=2, device=device)


def _tensors(out):
    if torch.is_tensor(out):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)
    elif hasattr(out, "samples"):
        yield from _tensors(out.samples)
        yield from _tensors(getattr(out, "final_values", {}))
    elif hasattr(out, "_fields"):
        yield from _tensors(tuple(out))


ENTRY_POINTS = {
    "logistic_regression_target": lambda d: tex.logistic_regression_target(X, Y, device=d)
    .logdensity(torch.zeros(2, 3, device=d)),
    "swiss_logistic_regression": lambda d: tex.swiss_logistic_regression(device=d)[1:],
    "synthetic_logistic_regression": lambda d: tex.synthetic_logistic_regression(
        dim=3, n_data=8, device=d)[1:],
    "lgcp_grid": lambda d: lgcp.lgcp_grid(3, device=d)[1:],
    "lgcp_target": lambda d: lgcp.lgcp_target(
        np.ones(4, np.float32), np.eye(4, dtype=np.float32), 1.0, device=d
    ).logdensity_and_grad(torch.zeros(2, 4, device=d)),
    "rats_data": lambda d: tex.rats_data(device=d),
    "rats_gibbs_model": lambda d: tex.rats_gibbs_model(device=d)[1],
    "rats_joint_target": lambda d: tex.rats_joint_target(device=d)[0].logdensity(
        torch.zeros(2, 65, device=d)),
    "MCJob_array_x0": lambda d: _normal_job(d).run(
        torch.Generator(device=d or "cpu").manual_seed(0), np.zeros(2, np.float32)),
    "MCJob_list_x0": lambda d: _normal_job(d)._prepare_x0(None, [0.0, 0.0]),
    "GibbsJob_number_v0": lambda d: _gibbs_job(d).run(
        torch.Generator(device=d or "cpu").manual_seed(0), {"m": 0.5, "p": 0.0}),
    "convert.target_arrays": lambda d: convert.target_arrays(X, Y, device=d).logdensity(
        torch.zeros(2, 3, device=d)),
    "convert.tune_state_from_numpy": lambda d: convert.tune_state_from_numpy(_tune(), device=d),
    "convert.hmc_state_from_numpy": lambda d: convert.hmc_state_from_numpy(_hmc_state(), device=d),
    "convert.chain_from_numpy": lambda d: convert.chain_from_numpy(
        {"value": np.zeros((2, 3, 1), np.float32)}, device=d),
    "convert.gibbs_values_from_numpy": lambda d: convert.gibbs_values_from_numpy(
        {"p": np.zeros(3, np.float32)}, device=d),
    "convert.gibbs_chains_from_numpy": lambda d: convert.gibbs_chains_from_numpy(
        types.SimpleNamespace(samples={"p": np.zeros((2, 3), np.float32)},
                              final_values={"p": np.zeros(3, np.float32)}, diagnostics={}),
        device=d),
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_device_and_no_card_raises_and_names_the_cpu(name, no_card):
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        ENTRY_POINTS[name](None)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_device_cpu_runs_on_the_cpu(name, no_card):
    out = ENTRY_POINTS[name]("cpu")
    tensors = list(_tensors(out))
    assert tensors and {t.device.type for t in tensors} == {"cpu"}


def test_resolve_device_order(no_card):
    cpu, meta = torch.zeros(1), torch.zeros(1, device="meta")
    assert resolve_device("cpu", [meta]) == torch.device("cpu")  # a named device wins
    assert resolve_device(None, [3.0, meta, None]) == torch.device("meta")  # then the tensors'
    with pytest.raises(ValueError, match="several devices"):
        resolve_device(None, [cpu, meta])
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        resolve_device(None, [1.0, np.zeros(2)])


def test_the_default_is_the_card_where_there_is_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device() == torch.device("cuda", 0)


def test_jobs_follow_the_tensors_they_are_given(no_card):
    chain = _normal_job().run(torch.Generator().manual_seed(0), torch.zeros(3, 2))
    assert chain.value.device.type == "cpu"
    out = _gibbs_job().run(torch.Generator().manual_seed(0),
                           {"m": torch.tensor(0.5), "p": torch.tensor(0.0)})
    assert out.samples["p"].device.type == "cpu"
    target = tex.logistic_regression_target(torch.from_numpy(X), torch.from_numpy(Y))
    assert target.logdensity(torch.zeros(2, 3)).device.type == "cpu"


def test_a_prior_draw_decides_the_device_like_any_tensor(no_card):
    """x0=None: the prior draws where its generator lives, and the job
    follows that draw instead of asking for the card first."""
    target = kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=2,
                       prior=kt.distributions.Normal(0.0, 1.0))
    job = kt.MCJob(target, kt.HMC(leapstep=0.1, nleaps=2), kt.MCRange(n_steps=5, burnin=2),
                   n_chains=3)
    gen = torch.Generator().manual_seed(0)
    x0 = job._prepare_x0(job._run_stream(gen, job._run_device(gen, None)), None)
    assert x0.device.type == "cpu" and tuple(x0.shape) == (3, 2)
    assert job.run(torch.Generator().manual_seed(0)).value.device.type == "cpu"
