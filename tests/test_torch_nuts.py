"""One NUTS transition of the port against klara_tpu's, both tree forms, with
JAX's random draws replayed into the port through ``NUTSDraws`` (the two
packages' generators differ), plus distribution-level checks.

Target: a small logistic regression in f32, per-chain ε and a non-identity
diagonal mass; matmuls in full f32 (TF32 off, as on the CPU).  Tolerances:
the tree's discrete outcomes (ndoublings, na, accept, divergent) must agree
exactly; the positions, log-targets and gradients of the chosen points to
rtol 2e-5 / atol 1e-4 (gradient components reach ~30 and sum 200 rows, so
f32 reduction order leaves ~1e-5 absolute noise); the accumulated
acceptance ``a`` and ``accept_stat`` to rtol 1e-4."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import klara_tpu as jkt
from klara_tpu.models import examples as jex
from klara_tpu.samplers import hamiltonian as jham

import klara_tpu_torch as kt
from klara_tpu_torch import convert
from klara_tpu_torch.samplers.nuts import NUTSDraws

C, D, N = 12, 5, 200


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 0.5).astype(np.float32)
    x0 = (0.3 * rng.standard_normal((C, D))).astype(np.float32)
    inv_mass = rng.uniform(0.5, 2.0, (C, D)).astype(np.float32)
    jt = jex.logistic_regression_target(X, y, 10.0)
    tt = convert.target_arrays(X, y, 10.0, device="cpu")
    return jt, tt, x0, inv_mass


def _leaf_keys(key, depth):
    """The static tree's per-leaf keys in visit order (left subtree first)."""
    if depth == 0:
        return [key]
    k_l, k_r = jax.random.split(key)
    return _leaf_keys(k_l, depth - 1) + _leaf_keys(k_r, depth - 1)


def _jax_draws(key, state, md, static):
    """One chain's draws, on NUTS.step's key schedule for either tree."""
    k_mom, k_slice, k_loop = jax.random.split(key, 3)
    dirs, swaps, takes = [], [], []
    for j in range(md):
        k_loop, k_v, k_sub, k_swap = jax.random.split(k_loop, 4)
        dirs.append(jax.random.bernoulli(k_v))
        swaps.append(jax.random.uniform(k_swap))
        if static:
            leaf_keys = _leaf_keys(k_sub, j)
        else:
            leaf_keys = []
            for _ in range(1 << j):
                k_sub, k_take = jax.random.split(k_sub)
                leaf_keys.append(k_take)
        takes += [jax.random.uniform(k) for k in leaf_keys]
    p0 = jham.sample_momentum(k_mom, state.position, state.inv_mass)
    return p0, jax.random.uniform(k_slice), jnp.stack(dirs), jnp.stack(swaps), jnp.stack(takes)


def _step_both(problem, eps, key=9, **kw):
    """JAX's vmapped step and the port's step on JAX's draws."""
    jt, tt, x0, inv_mass = problem
    js, ts = jkt.NUTS(**kw), kt.NUTS(**kw)
    tuner = jkt.DualAveragingTuner(0.8, 100)
    state = jax.vmap(lambda x: js.init(jax.random.key(0), jt, x, step_size=0.1, tuner=tuner))(
        jnp.asarray(x0))
    state = state._replace(inv_mass=jnp.asarray(inv_mass),
                           tune=state.tune._replace(step=jnp.asarray(eps, jnp.float32)))
    keys = jax.random.split(jax.random.key(key), C)
    new_ref, info_ref = jax.vmap(lambda k, s: js.step(k, s, jt))(keys, state)

    md, static = js.max_doublings, js._use_static()
    p0, su, dirs, swaps, takes = (np.asarray(a) for a in jax.vmap(
        lambda k, s: _jax_draws(k, s, md, static))(keys, state))
    draws = NUTSDraws(torch.tensor(p0), torch.tensor(su), torch.tensor(dirs.T),
                      torch.tensor(swaps.T), torch.tensor(takes.T))
    tstate = convert.nuts_state_from_numpy(jax.tree.map(np.asarray, state), device="cpu")
    new, info = ts.step(tstate, tt, draws=draws)
    return (new_ref, info_ref), (new, info)


@pytest.mark.parametrize("tree_impl,max_doublings", [
    ("static", 3), ("static", 5), ("looped", 5),
])
def test_nuts_step_matches_jax(problem, tree_impl, max_doublings):
    eps = np.geomspace(0.02, 4.0, C)
    (new_ref, info_ref), (new, info) = _step_both(
        problem, eps, tree_impl=tree_impl, max_doublings=max_doublings)
    assert kt.NUTS(tree_impl=tree_impl, max_doublings=max_doublings)._use_static() == (
        tree_impl == "static")
    for name in ("ndoublings", "na", "divergent"):
        np.testing.assert_array_equal(info.extras[name].numpy(),
                                      np.asarray(info_ref.extras[name]), err_msg=name)
        assert len(set(info.extras[name].tolist())) > 1, name  # chains differ
    np.testing.assert_array_equal(info.accept.numpy(), np.asarray(info_ref.accept))
    assert len(set(info.accept.tolist())) > 1
    _close(info.extras["a"], info_ref.extras["a"], 1e-4, 1e-6)
    _close(info.accept_stat, info_ref.accept_stat, 1e-4, 1e-6)
    _close(new.position, new_ref.position, 2e-5, 1e-4)
    _close(new.logtarget, new_ref.logtarget, 2e-5, 1e-4)
    _close(new.gradlogtarget, new_ref.gradlogtarget, 2e-5, 1e-4)
    _close(info.logtarget, new.logtarget, 0, 0)


@pytest.mark.parametrize("tree_impl", ["static", "looped"])
def test_huge_step_diverges_in_both(problem, tree_impl):
    (_, info_ref), (new, info) = _step_both(
        problem, np.full(C, 50.0), tree_impl=tree_impl, max_doublings=3)
    assert bool(info.extras["divergent"].all())
    np.testing.assert_array_equal(info.extras["divergent"].numpy(),
                                  np.asarray(info_ref.extras["divergent"]))
    np.testing.assert_array_equal(info.extras["na"].numpy(), np.asarray(info_ref.extras["na"]))
    assert not bool(info.accept.any())
    assert torch.isfinite(new.position).all()


SCALES = torch.tensor([1.0, 0.3, 0.1, 0.03])


def _stiff_normal_target():
    """N(0, diag(SCALES²)): the stiff coordinates turn many times inside
    one long trajectory, so u-turns fire at inner merge nodes of subtrees,
    not only across whole subtrees."""
    prec = SCALES ** -2

    def value_and_grad(x):
        g = -x * prec
        return 0.5 * (g * x).sum(-1), g

    return kt.Target(logdensity_fn=lambda x: -0.5 * (x * x * prec).sum(-1), dim=4,
                     value_and_grad_fn=value_and_grad)


def test_static_and_looped_trees_agree_on_the_same_draws():
    """Both tree forms read the same NUTSDraws layout, and with the same
    draws they are the same deterministic map: the looped checkpoint stack
    evaluates exactly the (left, right) pairs of the static tree's merge
    nodes.  Five steps of 64 chains at depth 6 on a stiff Gaussian; the
    leapfrog arithmetic per chain is identical, so the outputs agree
    exactly, except ``a``, which the looped form sums per subtree first
    (f32 order: rtol 1e-6)."""
    target = _stiff_normal_target()
    gen = torch.Generator().manual_seed(4)
    x = SCALES * torch.randn(64, 4, generator=gen)
    static = kt.NUTS(max_doublings=6, tree_impl="static")
    looped = kt.NUTS(max_doublings=6, tree_impl="looped")
    state = static.init(target, x, step_size=0.02)
    state = state._replace(tune=state.tune._replace(
        step=torch.linspace(0.005, 0.05, 64)))
    turned_inside = 0
    for _ in range(5):
        draws = static.draws(gen, state)
        new_s, info_s = static.step(state, target, draws=draws)
        new_l, info_l = looped.step(state, target, draws=draws)
        for name in ("ndoublings", "na", "divergent"):
            assert torch.equal(info_s.extras[name], info_l.extras[name]), name
        torch.testing.assert_close(info_s.extras["a"], info_l.extras["a"], rtol=1e-6, atol=0)
        assert torch.equal(info_s.accept, info_l.accept)
        assert torch.equal(new_s.position, new_l.position)
        # a tree that stopped on a u-turn before filling its last subtree
        na, nd = info_s.extras["na"], info_s.extras["ndoublings"]
        turned_inside += int((na < (1 << nd) - 1).sum())
        state = new_s
    assert turned_inside > 20


def test_bfloat16_checkpoint_stack_runs(problem):
    """The looped tree with a bf16 checkpoint stack: same draws as the f32
    stack; decisions may differ only where a u-turn product sits within
    bf16 rounding of zero, so only the outputs' sanity is asserted."""
    _, tt, x0, inv_mass = problem
    s16 = kt.NUTS(tree_impl="looped", ckpt_dtype="bfloat16", max_doublings=4)
    state = s16.init(tt, torch.from_numpy(x0), step_size=0.05)
    state = state._replace(inv_mass=torch.from_numpy(inv_mass))
    draws = s16.draws(torch.Generator().manual_seed(0), state)
    new, info = s16.step(state, tt, draws=draws)
    assert new.position.dtype == torch.float32
    assert torch.isfinite(new.position).all() and torch.isfinite(info.accept_stat).all()
    assert int(info.extras["na"].min()) >= 1


def test_tree_impl_and_dtype_are_validated():
    assert kt.NUTS(max_doublings=6)._use_static()
    assert not kt.NUTS(max_doublings=7)._use_static()
    with pytest.raises(ValueError, match="tree_impl"):
        kt.NUTS(tree_impl="recursive")
    with pytest.raises(ValueError, match="ckpt_dtype"):
        kt.NUTS(ckpt_dtype="bfloat61")


def test_nuts_state_round_trip(problem):
    jt, _, x0, _ = problem
    tuner = jkt.DualAveragingTuner(0.8, 100)
    state = jax.vmap(lambda k, x: jkt.NUTS().init(k, jt, x, tuner=tuner))(
        jax.random.split(jax.random.key(3), C), jnp.asarray(x0))
    nstate = jax.tree.map(np.asarray, state)
    tstate = convert.nuts_state_from_numpy(nstate, device="cpu")
    assert isinstance(tstate, kt.NUTSState)
    for a, b in zip(jax.tree.leaves(nstate), jax.tree.leaves(tuple(tstate))):
        np.testing.assert_array_equal(b.numpy(), a)


RHO = 0.8
COV = np.array([[1.0, RHO], [RHO, 1.0]], dtype=np.float32)
PREC = torch.tensor(np.linalg.inv(COV).astype(np.float32))


def _corr_normal_target():
    def value_and_grad(x):
        g = -(x @ PREC)
        return 0.5 * (g * x).sum(-1), g

    return kt.Target(logdensity_fn=lambda x: -0.5 * ((x @ PREC) * x).sum(-1), dim=2,
                     value_and_grad_fn=value_and_grad)


def test_static_matches_looped_in_distribution():
    """The two tree forms are the same sampler: the same posterior moments
    and mean tree statistics on a correlated Gaussian, up to MC error (the
    counterpart of the JAX package's test of the same name, at 64 chains
    and depth 4 to keep the CPU time small)."""
    stats = {}
    for impl in ("looped", "static"):
        job = kt.MCJob(_corr_normal_target(), kt.NUTS(tree_impl=impl, max_doublings=4),
                       kt.MCRange(n_steps=700, burnin=300),
                       tuner=kt.DualAveragingTuner(0.8, 300), n_chains=64,
                       diagnostics=("na", "ndoublings"))
        chain = job.run(torch.Generator().manual_seed(3), torch.zeros(64, 2))
        flat = chain.flat("value").numpy()
        np.testing.assert_allclose(flat.mean(axis=0), np.zeros(2), atol=0.08)
        np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.12)
        stats[impl] = (flat.mean(axis=0), np.cov(flat.T),
                       float(chain["na"].double().mean()),
                       float(chain["ndoublings"].double().mean()))
    np.testing.assert_allclose(stats["static"][0], stats["looped"][0], atol=0.08)
    np.testing.assert_allclose(stats["static"][1], stats["looped"][1], atol=0.12)
    np.testing.assert_allclose(stats["static"][2], stats["looped"][2], rtol=0.12)
    np.testing.assert_allclose(stats["static"][3], stats["looped"][3], rtol=0.12)
