"""One MH transition of the port against ``jax.vmap(MH.step)`` with JAX's
proposal noise and accept uniforms replayed (its generators differ from
the port's), for a scalar, vector and Cholesky-matrix sigma and for general
proposals (asymmetric, and non-normalised with a normaliser that depends on
the position); and AcceptanceRateTuner's update sequence against JAX's.
``accept`` must agree exactly, positions within rtol 1e-6 (f32, the same
arithmetic in the same order); tuned steps as the tuner test states."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import klara_tpu as jkt
from klara_tpu import distributions as jd

import klara_tpu_torch as kt
from klara_tpu_torch import distributions as td

C, D = 64, 3
MEAN = np.array([0.5, -1.0, 2.0], np.float32)
SD = np.array([1.0, 0.5, 2.0], np.float32)


def _targets():
    jt = jkt.Target(logdensity_fn=lambda x: -0.5 * jnp.sum(jnp.square((x - MEAN) / SD)))
    m, s = torch.tensor(MEAN), torch.tensor(SD)
    tt = kt.Target(logdensity_fn=lambda x: -0.5 * torch.square((x - m) / s).sum(-1))
    return jt, tt


class _ScaledNormal:
    """A proposal whose logpdf omits its (position-dependent) normaliser."""

    def __init__(self, normal, lognorm):
        self.normal, self._lognorm = normal, lognorm

    def logpdf(self, x):
        return self.normal.logpdf(x) + self._lognorm

    def lognormaliser(self):
        return self._lognorm

    def sample(self, *args, **kw):
        return self.normal.sample(*args, **kw)

    event_dims = 0


def _samplers(case):
    rng = np.random.default_rng(3)
    if case == "scalar":
        return jkt.MH(sigma=0.8), kt.MH(sigma=0.8)
    if case == "vector":
        v = rng.uniform(0.3, 1.5, D).astype(np.float32)
        return jkt.MH(sigma=jnp.asarray(v)), kt.MH(sigma=torch.tensor(v))
    if case == "matrix":
        a = rng.standard_normal((D, D)).astype(np.float32)
        L = np.linalg.cholesky(a @ a.T / D + np.eye(D)).astype(np.float32)
        return jkt.MH(sigma=jnp.asarray(L)), kt.MH(sigma=torch.tensor(L))
    if case == "asymmetric":
        return (
            jkt.MH(proposal_fn=lambda x, s: jd.Normal(0.9 * x, 0.6 * s), symmetric=False),
            kt.MH(proposal_fn=lambda x, s: td.Normal(0.9 * x, 0.6 * s[:, None]),
                  symmetric=False),
        )
    if case == "unnormalised":
        def jfn(x, s):
            return _ScaledNormal(jd.Normal(0.9 * x, 0.6 * s), 0.3 * jnp.tanh(x))

        def tfn(x, s):
            return _ScaledNormal(td.Normal(0.9 * x, 0.6 * s[:, None]), 0.3 * torch.tanh(x))

        return (jkt.MH(proposal_fn=jfn, symmetric=False, normalised=False),
                kt.MH(proposal_fn=tfn, symmetric=False, normalised=False))
    raise KeyError(case)


@pytest.mark.parametrize("case", ["scalar", "vector", "matrix", "asymmetric", "unnormalised"])
def test_mh_step_matches_jax_with_replayed_draws(case):
    jt, tt = _targets()
    js, ts = _samplers(case)
    x0 = (MEAN + 1.5 * np.random.default_rng(4).standard_normal((C, D))).astype(np.float32)
    keys = jax.random.split(jax.random.key(9), C)

    jstate = jax.vmap(lambda k, x: js.init(k, jt, x, step_size=0.7))(keys, jnp.asarray(x0))
    jnew, jinfo = jax.vmap(lambda k, st: js.step(k, st, jt))(keys, jstate)
    # the draws MH.step makes from each chain's key
    k_prop, k_acc = (jax.vmap(jax.random.split)(keys)[:, j] for j in (0, 1))
    z = jax.vmap(lambda k: jax.random.normal(k, (D,), jnp.float32))(k_prop)
    u = jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float32))(k_acc)

    tstate = ts.init(tt, torch.tensor(x0), step_size=0.7)
    tnew, tinfo = ts.step(tstate, tt, z=torch.tensor(np.asarray(z)),
                          u=torch.tensor(np.asarray(u)))

    acc = np.asarray(jinfo.accept)
    assert 0 < acc.sum() < C  # both branches are exercised
    np.testing.assert_array_equal(tinfo.accept.numpy(), acc)
    np.testing.assert_allclose(tnew.position.numpy(), np.asarray(jnew.position), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tnew.logtarget.numpy(), np.asarray(jnew.logtarget), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tinfo.accept_stat.numpy(), np.asarray(jinfo.accept_stat),
                               rtol=1e-5, atol=1e-6)
    assert tnew.tune.step.shape == (C,)


def test_mh_init_takes_a_per_chain_step_size():
    _, tt = _targets()
    step = torch.linspace(0.1, 1.0, C)
    state = kt.MH().init(tt, torch.zeros(C, D), step_size=step)
    torch.testing.assert_close(state.tune.step, step)
    assert kt.MH().init(tt, torch.zeros(C, D, dtype=torch.int32)).tune.step.dtype == torch.float32


@pytest.mark.parametrize("score", ["logistic", "erf"])
def test_acceptance_rate_tuner_sequence_matches_jax(score):
    """300 updates of 8 chains at period 10 and burnin 120 (so adaptation
    stops after the period that straddles the boundary).  The steps are
    products of 13 scores: the logistic score agrees to rtol 1e-6; torch's
    and XLA's erf differ by an ulp, which 1 + erf(k·x) magnifies where erf
    nears −1, so the erf score is held to rtol 1e-5."""
    T, m, burnin = 300, 8, 120
    accepts = (np.random.default_rng(2).random((T, m)) < np.linspace(0.05, 0.9, m)).astype(
        np.float32)
    jtuner = jkt.AcceptanceRateTuner(targetrate=0.3, score=score, period=10)
    ttuner = kt.AcceptanceRateTuner(targetrate=0.3, score=score, period=10)
    jtune = jax.vmap(jtuner.init)(jnp.full((m,), 0.5, jnp.float32))
    ttune = ttuner.init(torch.full((m,), 0.5))
    jsteps, tsteps = [], []
    jupdate = jax.jit(jax.vmap(lambda t, a: jtuner.update(t, a, a, burnin)))
    for t in range(T):
        jtune = jupdate(jtune, jnp.asarray(accepts[t]))
        ttune = ttuner.update(ttune, torch.tensor(accepts[t]), torch.tensor(accepts[t]), burnin)
        jsteps.append(np.asarray(jtune.step))
        tsteps.append(ttune.step.numpy())
    rtol = 1e-6 if score == "logistic" else 1e-5
    np.testing.assert_allclose(np.array(tsteps), np.array(jsteps), rtol=rtol)
    np.testing.assert_allclose(ttune.rate.numpy(), np.asarray(jtune.rate), rtol=1e-6)
    np.testing.assert_array_equal(ttune.totproposed.numpy(), np.asarray(jtune.totproposed))
    assert not np.allclose(jsteps[-1], 0.5)  # the tuner did move the steps


def test_rate_scores_match_jax():
    from klara_tpu.tuners import tuners as jtun
    from klara_tpu_torch.tuners import tuners as ttun

    x = np.linspace(-1, 1, 41).astype(np.float32)
    for name, k in (("logistic_rate_score", 5.0), ("erf_rate_score", 2.0)):
        ref = getattr(jtun, name)(jnp.asarray(x), k)
        out = getattr(ttun, name)(torch.tensor(x), k)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_mcjob_runs_mh():
    """``MCJob`` hands ``init`` a momentum only when it has one: MH's init
    takes none.  Random-walk MH on a 2-d standard normal from 64 chains
    lands on its mean and variance (MCSE ~0.03 at 64 x 1500 draws of ESS
    per draw ~0.2)."""
    target = kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=2)
    job = kt.MCJob(target, kt.MH(1.0), kt.MCRange(n_steps=2000, burnin=500), n_chains=64,
                   monitor=("value",))
    chain = job.run(torch.Generator().manual_seed(0), torch.zeros(64, 2))
    x = chain.value.reshape(-1, 2)
    assert chain.value.shape == (1500, 64, 2)
    assert float(x.mean(0).abs().max()) < 0.15
    assert float((x.var(0) - 1.0).abs().max()) < 0.2


def test_mh_proposal_distribution_draws_from_its_keyed_stream():
    """A proposal distribution draws from the keyed stream (``ops.keyed``)
    it is handed, at counter (its step, ``MH_SITE``); handed none, ``step``
    keys a fresh stream from the generator's next draw, at step 0.  The
    state carries no key."""
    from klara_tpu_torch.ops.keyed import MH_SITE, KeyedStream, run_key

    _, tt = _targets()
    sampler = kt.MH(proposal_fn=lambda x, s: td.Normal(x, 0.5 * s[:, None]), symmetric=False)
    state = sampler.init(tt, torch.zeros(C, D))
    assert state._fields == ("position", "logtarget", "tune")
    stream = KeyedStream(run_key(torch.Generator().manual_seed(3), "cpu"), C)
    s1, info = sampler.step(state, tt, torch.Generator().manual_seed(1), stream=stream.at(step=5))
    proposal = 0.5 * stream.at(step=5, site=MH_SITE).normal((C, D))
    assert bool(info.accept.any())
    torch.testing.assert_close(s1.position[info.accept], proposal[info.accept], rtol=0, atol=0)
    # the random walk's normal is drawn at the same site
    walk, info = kt.MH(0.5).step(state, tt, stream=stream.at(step=5))
    assert bool(info.accept.any())
    torch.testing.assert_close(walk.position[info.accept], proposal[info.accept], rtol=0, atol=0)

    s2, info = sampler.step(state, tt, torch.Generator().manual_seed(9))
    key = run_key(torch.Generator().manual_seed(9), "cpu")
    proposal = 0.5 * KeyedStream(key, C, 0, 0, MH_SITE).normal((C, D))
    assert bool(info.accept.any())
    torch.testing.assert_close(s2.position[info.accept], proposal[info.accept], rtol=0, atol=0)


def test_mh_resume_continues_the_proposal_stream():
    """``MCJob`` owns the proposal's keyed stream: ``run`` and ``resume``
    each key one from the generator's next draw and hand it to step i at
    counter (i, ``MH_SITE``), so a resumed run draws from a stream of its
    own (no proposal of the first run is drawn again)."""
    from klara_tpu_torch.ops.keyed import MH_SITE, run_key

    handed = []

    class Recorded(td.Distribution):
        def __init__(self, inner):
            self.inner = inner

        def sample(self, rng, shape=()):
            handed.append(rng)
            return self.inner.sample(rng, shape)

        def logpdf(self, x):
            return self.inner.logpdf(x)

    target = kt.Target(logdensity_fn=lambda x: (torch.log(x) - x).sum(-1), dim=1)
    sampler = kt.MH(proposal_fn=lambda x, s: Recorded(td.LogNormal(torch.log(x),
                                                                   0.5 * s[:, None])),
                    symmetric=False)
    job = kt.MCJob(target, sampler, kt.MCRange(n_steps=30, burnin=10), n_chains=16,
                   device="cpu")
    gen = torch.Generator().manual_seed(4)
    first = job.run(gen, torch.ones(1))
    second = job.resume(gen, first)
    assert len(handed) == 60
    runs = handed[:30], handed[30:]
    for streams in runs:
        assert [int(s.step) for s in streams] == list(range(30))
        assert {(s.site, s.chains, s.offset) for s in streams} == {(MH_SITE, 16, 0)}
        assert all(torch.equal(s.key, streams[0].key) for s in streams)
    assert torch.equal(runs[0][0].key, run_key(torch.Generator().manual_seed(4), "cpu"))
    assert not torch.equal(runs[0][0].key, runs[1][0].key)
    assert bool(torch.isfinite(second.value).all()) and bool((second.value > 0).all())


def test_mh_refuses_a_generator_or_stream_on_another_device():
    """A proposal's keyed draws stay on the positions' device: a generator
    or a stream elsewhere raises instead of drawing there."""
    from klara_tpu_torch.ops.keyed import KeyedStream

    tt = kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=D)
    sampler = kt.MH(proposal_fn=lambda x, s: td.Normal(x, s[:, None]))
    state = sampler.init(tt, torch.zeros(C, D, device="meta"))
    with pytest.raises(ValueError, match="the generator is on cpu"):
        sampler.step(state, tt, torch.Generator())
    stream = KeyedStream(torch.zeros((), dtype=torch.int64), C)
    with pytest.raises(ValueError, match="the stream is on cpu"):
        sampler.step(state, tt, None, stream=stream)


def test_a_proposal_that_needs_a_generator_gets_a_clear_type_error():
    """A proposal of the user's own whose ``sample`` calls torch with its
    ``rng`` as a generator is told that it was handed a ``KeyedStream``."""

    class Walk(td.Distribution):
        def __init__(self, x):
            self.x = x

        def sample(self, rng, shape=()):
            return self.x + torch.randint(0, 2, self.x.shape, generator=rng)

        def logpdf(self, y):
            return torch.zeros(y.shape[0])

    _, tt = _targets()
    sampler = kt.MH(proposal_fn=lambda x, s: Walk(x))
    state = sampler.init(tt, torch.zeros(C, D))
    with pytest.raises(TypeError, match="Walk.sample was handed a KeyedStream"):
        sampler.step(state, tt, torch.Generator().manual_seed(0))
