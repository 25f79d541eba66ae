"""The port's example matrix and data files against the JAX package's, on
the CPU (``device="cpu"``).

The whole 56-example matrix runs on the card (``examples_torch/
run_examples.py``); here: the port's own data files and ``examples()``,
the registry's names, the rule that the port imports nothing of JAX, the
counterparts of ``tests/test_examples.py``'s six tests and of
``tests/test_discrete.py::test_poisson_mh_discrete``, and a few examples
at cut sizes.  A cut run keeps its example's (or JAX test's) tolerance
unless its docstring says otherwise; the gates computed here are 5 Monte
Carlo standard errors of the run's own draws.
"""

import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import klara_tpu as jkt
import klara_tpu_torch as kt
from klara_tpu.data import dataset as jdataset
from klara_tpu.data import examples as jexamples
from klara_tpu.models import examples as jex
from klara_tpu_torch.data import dataset, datasets, examples
from klara_tpu_torch.models import examples as tex
from klara_tpu_torch.models.examples import (
    rats_gibbs_model,
    rats_joint_target,
    swiss_logistic_regression,
    synthetic_logistic_regression,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _gen(seed):
    return torch.Generator(CPU).manual_seed(seed)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The runs here are thousands of ops on tensors of a few hundred
    values: one intra-op thread is faster than many, and keeps the file
    from competing with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ data, registry
@pytest.mark.parametrize("name,fields", [("swiss", ("measurements", "status")),
                                         ("rats", ("age", "weight"))])
def test_port_data_files_equal_jax(name, fields):
    """The port reads its own copy of each .npz; every array equals the JAX
    package's, dtype included."""
    ours, theirs = dataset(name), jdataset(name)
    assert sorted(ours) == sorted(theirs) == sorted(fields)
    for f in fields:
        assert ours[f].dtype == theirs[f].dtype
        np.testing.assert_array_equal(ours[f], theirs[f])
    assert kt.data.FILES == os.path.join(REPO, "klara_tpu_torch", "data", "files")


def test_examples_lists_the_jax_examples():
    assert kt.data.examples() == examples()
    assert examples() == jexamples()
    assert "run_examples" not in examples()


_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|klara_tpu)(\.|\s|$)", re.M)
_JAX_DATA_PATH = re.compile(r"klara_tpu[/\\]data|['\"]klara_tpu['\"]\s*,\s*['\"]data['\"]")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for top in ("klara_tpu_torch", "examples_torch"):
        for root, _, files in os.walk(os.path.join(REPO, top)):
            out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_port_imports_no_jax_and_reads_no_jax_data():
    files = _port_files()
    assert len(files) > 50
    bad = []
    for path in files:
        with open(path) as f:
            text = f.read()
        if _JAX_IMPORT.search(text) or _JAX_DATA_PATH.search(text):
            bad.append(os.path.relpath(path, REPO))
    assert bad == []


def _jax_registry_names():
    """The JAX runner's registry names, its modules imported by their own
    file names and removed again."""
    ex_dir = os.path.join(REPO, "examples")
    spec = importlib.util.spec_from_file_location("_jax_run_examples",
                                                  os.path.join(ex_dir, "run_examples.py"))
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    before = set(sys.modules)
    sys.path.insert(0, ex_dir)
    try:
        registry, errors = runner.build_registry()
    finally:
        sys.path.remove(ex_dir)
        for mod in set(sys.modules) - before:
            if os.path.dirname(getattr(sys.modules[mod], "__file__", "") or "") == ex_dir:
                del sys.modules[mod]
    assert errors == {}
    return list(registry)


def test_registry_names_equal_jax():
    from examples_torch.run_examples import build_registry

    registry, errors = build_registry()
    assert errors == {}
    assert len(registry) == 56
    assert list(registry) == _jax_registry_names()


def test_runner_refuses_to_fall_back_to_cpu(monkeypatch, capsys):
    """Without --cpu and without a card the runner exits at once."""
    from examples_torch import run_examples

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["run_examples.py", "--only", "poisson_mh"])
    with pytest.raises(SystemExit) as exc:
        run_examples.main()
    out = capsys.readouterr()
    assert exc.value.code == 2
    assert "--cpu" in out.err and "examples" not in out.out


def test_merge_joins_split_records():
    from examples_torch.run_examples import merge

    a = {"platform": "cuda", "device": "H100", "card": "H100, 700 W", "torch": "2",
         "passed": 2, "total": 2, "failed": [], "errors": {}, "seconds": 3.0,
         "example_seconds": {"x": 1.0, "y": 2.0}}
    b = dict(a, passed=0, total=1, failed=["z"], errors={"z": "tb"}, seconds=4.0,
             example_seconds={"z": 4.0})
    out = merge([a, b])
    assert (out["passed"], out["total"], out["failed"], out["seconds"]) == (2, 3, ["z"], 7.0)
    assert out["example_seconds"] == {"x": 1.0, "y": 2.0, "z": 4.0}
    with pytest.raises(ValueError):
        merge([a, a])


def test_from_distribution_of_a_multivariate_pdf_is_per_chain():
    """The biv_*_pdf rows' target: MvNormal's logpdf is already (C,), and
    the target keeps it so (it once summed it over the chains)."""
    from klara_tpu.distributions import MvNormal as JMvNormal
    from klara_tpu_torch.distributions import MvNormal

    cov = np.array([[1.0, 0.8], [0.8, 1.0]], np.float32)
    x = np.array([[1.1, -0.7], [0.0, 0.0], [-2.0, 0.5]], np.float32)
    jt = jkt.Target.from_distribution(JMvNormal.from_cov(jnp.zeros(2), jnp.asarray(cov)), dim=2)
    tt = kt.Target.from_distribution(MvNormal.from_cov(torch.zeros(2), torch.from_numpy(cov)),
                                     dim=2)
    want = np.asarray(jax.vmap(jt.logdensity)(jnp.asarray(x)))
    np.testing.assert_allclose(tt.logdensity(torch.from_numpy(x)).numpy(), want, rtol=1e-6)


# ---------------------------------- counterparts of tests/test_examples.py
def test_datasets_loader():
    assert datasets() == ["rats", "swiss"]
    X = dataset("swiss", "measurements")
    y = dataset("swiss", "status")
    assert X.shape == (200, 4) and y.shape == (200,)
    age, weight = dataset("rats", "age", "weight")
    assert age.shape == (5,) and weight.shape == (30, 5)
    with pytest.raises(KeyError):
        dataset("nope")


def test_swiss_analytical_grad_matches_ad_and_jax():
    """Analytical, reverse- and forward-mode gradients and the values of the
    port's swiss target against each other and against the JAX target at
    the same p (f32 throughout; the CPU has no TF32)."""
    import dataclasses

    p = np.array([[0.5, -0.3, 1.2, -0.8], [-0.7, 0.8, 1.0, 3.0]], np.float32)
    jt, _, _ = jex.swiss_logistic_regression(analytical_grad=True)
    jgrad = np.asarray(jax.vmap(jt.grad)(jnp.asarray(p)))
    jval = np.asarray(jax.vmap(jt.logdensity)(jnp.asarray(p)))
    ta, _, _ = swiss_logistic_regression(analytical_grad=True, device=CPU)
    tr, _, _ = swiss_logistic_regression(analytical_grad=False, device=CPU)
    tf = dataclasses.replace(tr, ad_mode="forward")
    P = torch.from_numpy(p)
    for t in (ta, tr, tf):
        np.testing.assert_allclose(t.grad(P).numpy(), jgrad, rtol=2e-4)
        np.testing.assert_allclose(t.logdensity(P).numpy(), jval, rtol=1e-5)
        v, g = t.logdensity_and_grad(P)
        np.testing.assert_allclose(v.numpy(), jval, rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), jgrad, rtol=2e-4)


def test_swiss_reverse_target_fuses_value_and_grad_in_both_packages(monkeypatch):
    """Reference behaviour the port keeps: the swiss target built with
    ``analytical_grad=False`` still carries the fused value+grad, which
    serves ``logdensity_and_grad``; autograd runs only for ``grad`` alone."""
    jt, _, _ = jex.swiss_logistic_regression(analytical_grad=False)
    assert jt.grad_fn is None and jt.value_and_grad_fn is not None
    q = jnp.array([0.5, -0.3, 1.2, -0.8])
    jv, jg = jt.logdensity_and_grad(q)
    fv, fg = jt.value_and_grad_fn(q)
    assert float(jv) == float(fv) and np.array_equal(np.asarray(jg), np.asarray(fg))

    calls = []
    fused = tex.logreg_value_grad

    def counted(*a, **k):
        calls.append(1)
        return fused(*a, **k)

    monkeypatch.setattr(tex, "logreg_value_grad", counted)
    tt, _, _ = swiss_logistic_regression(analytical_grad=False, device=CPU)
    assert tt.grad_fn is None and tt.value_and_grad_fn is not None
    P = torch.tensor([[0.5, -0.3, 1.2, -0.8]])
    tt.logdensity_and_grad(P)
    assert len(calls) == 1
    tt.grad(P)
    assert len(calls) == 1


def test_swiss_mala_vs_nuts_agree():
    """Posterior means from two independent samplers agree within MC error,
    and NUTS lands on the JAX test's golden moments.  Cut from MALA
    6000/2000 and NUTS 3000/1000 steps to 1500/750 and 200/100; the JAX
    test's tolerances (0.1 on means, 0.08 on sds) stay: 0.1 is 4.6
    combined MCSE of the two cut runs' difference and 6 MCSE of NUTS's
    means (the worst coordinate, measured on the CPU)."""
    target, X, y = swiss_logistic_regression(device=CPU)
    x0 = torch.zeros(4)
    mala_job = kt.MCJob(
        target,
        kt.MALA(driftstep=0.05),
        kt.MCRange(n_steps=1500, burnin=750),
        tuner=kt.AcceptanceRateTuner(0.574),
        n_chains=16,
    )
    nuts_job = kt.MCJob(
        target,
        kt.NUTS(),
        kt.MCRange(n_steps=200, burnin=100),
        tuner=kt.DualAveragingTuner(0.8, 100),
        n_chains=16,
    )
    m_mala = kt.stats.mean(mala_job.run(_gen(0), x0)).numpy()
    chain_nuts = nuts_job.run(_gen(1), x0)
    m_nuts = kt.stats.mean(chain_nuts).numpy()

    np.testing.assert_allclose(m_mala, m_nuts, atol=0.1)
    assert float(kt.stats.rhat(chain_nuts).max()) < 1.05
    golden = np.array([-0.7123, 0.7943, 0.9986, 3.0078])
    np.testing.assert_allclose(m_nuts, golden, atol=0.1)
    golden_sd = np.array([0.2961, 0.4303, 0.4397, 0.4955])
    sd = chain_nuts.flat("value").numpy().std(axis=0)
    np.testing.assert_allclose(sd, golden_sd, atol=0.08)


def test_synthetic_logreg_nuts_recovers_weights():
    """Cut from 1500/500 steps to 80/50; the correlation gate stays."""
    target, X, y = synthetic_logistic_regression(dim=10, n_data=2000, seed=3, device=CPU)
    job = kt.MCJob(
        target,
        kt.NUTS(),
        kt.MCRange(n_steps=80, burnin=50),
        tuner=kt.DualAveragingTuner(0.8, 50),
        n_chains=8,
    )
    post_mean = kt.stats.mean(job.run(_gen(2), torch.zeros(10))).numpy()
    rng = np.random.default_rng(3)
    rng.standard_normal((2000, 10))
    w_true = rng.standard_normal(10)
    assert np.corrcoef(post_mean, w_true)[0, 1] > 0.95


def test_rats_gibbs():
    """The BUGS rats posterior, cut from 3000 sweeps (1000 burnin) to 1500
    (500), with the JAX test's tolerances."""
    model, v0 = rats_gibbs_model(device=CPU)
    job = kt.GibbsJob(model, {}, kt.MCRange(n_steps=1500, burnin=500), n_chains=8)
    chains = job.run(_gen(4), v0)
    beta_c = float(chains.flat("beta_c").mean())
    alpha_c = float(chains.flat("alpha_c").mean())
    assert abs(beta_c - 6.19) < 0.15
    assert abs(alpha_c - 242.5) < 3.0
    s2c = float(chains.flat("sigma2_c").mean())
    assert 25.0 < s2c < 55.0


def test_rats_joint_nuts_matches_gibbs():
    """Cut from 2000/1000 steps to 80/60 with the JAX test's gate (beta_c
    only: alpha_c has not reached its posterior by then)."""
    target, dim, unpack = rats_joint_target(device=CPU)
    job = kt.MCJob(
        target,
        kt.NUTS(max_doublings=6),
        kt.MCRange(n_steps=80, burnin=60),
        tuner=kt.DualAveragingTuner(0.8, 60),
        n_chains=8,
    )
    x0 = torch.cat([torch.full((30,), 250.0), torch.full((30,), 6.0),
                    torch.tensor([150.0, 10.0, 3.0, 3.0, 0.0])])
    post = kt.stats.mean(job.run(_gen(5), x0)).numpy()
    assert abs(post[61] - 6.19) < 0.2


# --------------------------- tests/test_discrete.py and examples at cut size
def _binary_walk(x, scale):
    at_zero = x == 0
    return kt.distributions.Binary(torch.where(at_zero, 0, x - 1),
                                   torch.where(at_zero, 1, x + 1), 0.5)


def test_poisson_mh_discrete():
    """tests/test_discrete.py::test_poisson_mh_discrete cut from 8000/1000
    steps to 2500/500; its tolerances stay (6 MCSE of the cut run's mean,
    7 of its variance, measured on the CPU)."""
    lam = 6.0

    def logdensity(p):
        pf = p.to(torch.float32)
        lp = (pf * np.log(lam) - torch.lgamma(pf + 1.0)).sum(-1)
        return torch.where((p >= 0).all(-1), lp, -torch.inf)

    job = kt.MCJob(
        kt.Target(logdensity_fn=logdensity, dim=1),
        kt.MH(proposal_fn=_binary_walk, symmetric=False),
        kt.MCRange(n_steps=2500, burnin=500),
        n_chains=32,
    )
    chain = job.run(_gen(0), torch.tensor([2], dtype=torch.int32))
    draws = chain.flat("value").numpy()
    assert draws.dtype == np.int32
    assert draws.min() >= 0
    np.testing.assert_allclose(draws.mean(), lam, rtol=0.05)
    np.testing.assert_allclose(draws.var(), lam, rtol=0.15)
    rate = float(kt.stats.acceptance(chain, diagnostics=False))
    assert 0.2 < rate < 0.95


def _mcse(x):
    """Monte Carlo standard error of the mean of a (draws, chains, ...)
    trace, pooled over chains; the max over coordinates."""
    x = x.to(torch.float32)
    if x.dim() == 2:
        x = x[..., None]
    return float((x.reshape(-1, x.shape[-1]).std(0) / kt.stats.ess(x).sqrt()).max())


def test_poisson_example_stays_int32_on_support():
    """examples_torch/poisson_mh.py cut from 10000/1000 steps to 2000/400:
    int32 trace, support kept, mean λ = 6 within 5 MCSE."""
    from examples_torch import poisson_mh

    chain = poisson_mh.main(n_steps=2000, burnin=400, device=CPU)
    draws = chain.flat("value").numpy()
    assert chain["value"].dtype == torch.int32 and draws.min() >= 0
    assert abs(draws.mean() - 6.0) < 5 * _mcse(chain["value"])


def test_gamma_truncation_example_both_styles():
    """examples_torch/gamma_mh_truncation.py cut from 20000/2000 steps to
    800/200: both correction styles land on Gamma(2, 1)'s mean 2 and
    variance 2, each within 5 MCSE."""
    from examples_torch import gamma_mh_truncation

    out = gamma_mh_truncation.main(n_steps=800, burnin=200, device=CPU)
    assert sorted(out) == ["lognormalise-corrected", "normalised"]
    for chain in out.values():
        x = chain["value"]
        assert float(x.min()) > 0
        assert abs(float(x.mean()) - 2.0) < 5 * _mcse(x)
        sq = torch.square(x - x.mean())
        assert abs(float(sq.mean()) - 2.0) < 5 * _mcse(sq)


@pytest.mark.parametrize("name,kw", [
    ("t_slice", dict(n_steps=1000, burnin=200)),
    ("biv_smmala_ad", dict(n_steps=300, burnin=100)),
])
def test_example_at_cut_size(name, kw):
    """A registry example, cut in depth only, with its own assertions."""
    from examples_torch.run_examples import build_registry

    registry, _ = build_registry()
    registry[name](device=CPU, **kw)
