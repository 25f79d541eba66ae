"""Leapfrog, the step-size search and one HMC transition of the port against
klara_tpu, with JAX's random draws replayed into the port (the two
packages' generators differ).  Target: a small logistic regression, f32.
Tolerances: gradient components reach ~30 and are sums over 200 data rows,
so f32 reduction order leaves ~1e-5 absolute noise in gradients and
momenta (atol 1e-4); positions agree to ~1e-5 relative."""

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
from klara_tpu_torch.samplers import hamiltonian as tham

C, D, N = 12, 5, 200


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 0.5).astype(np.float32)
    x0 = (0.3 * rng.standard_normal((C, D))).astype(np.float32)
    p0 = rng.standard_normal((C, D)).astype(np.float32)
    inv_mass = rng.uniform(0.5, 2.0, (C, D)).astype(np.float32)
    jt = jex.logistic_regression_target(X, y, 10.0)
    tt = convert.target_arrays(X, y, 10.0, device="cpu")
    return jt, tt, x0, p0, inv_mass


def _jax_pp(jt, x, p):
    lt, g = jax.vmap(jt.logdensity_and_grad)(jnp.asarray(x))
    return jham.PhasePoint(jnp.asarray(x), jnp.asarray(p), lt, g)


def _port_pp(tt, x, p):
    x = torch.from_numpy(x)
    lt, g = tt.logdensity_and_grad(x)
    return tham.PhasePoint(x, torch.from_numpy(p), lt, g)


def test_leapfrog_trajectory_matches_jax(problem):
    jt, tt, x0, p0, inv_mass = problem
    ref = jax.vmap(lambda pp, m: jham.leapfrog(jt, pp, 0.05, 10, m))(
        _jax_pp(jt, x0, p0), jnp.asarray(inv_mass))
    out = tham.leapfrog(tt, _port_pp(tt, x0, p0), 0.05, 10, torch.from_numpy(inv_mass))
    for a, b in zip(out, ref):
        _close(a, b, 2e-5, 1e-4)


def test_leapfrog_per_chain_counts_match_jax(problem):
    """Per-chain step counts: the port runs to the max and freezes finished
    chains; JAX's vmapped fori_loop gives each chain its own count."""
    jt, tt, x0, p0, _ = problem
    n = np.arange(C, dtype=np.int32) % 5 + 1
    eps = np.linspace(0.02, 0.1, C).astype(np.float32)
    ref = jax.vmap(lambda pp, e, k: jham.leapfrog(jt, pp, e, k))(
        _jax_pp(jt, x0, p0), jnp.asarray(eps), jnp.asarray(n))
    out = tham.leapfrog(tt, _port_pp(tt, x0, p0), torch.from_numpy(eps), torch.from_numpy(n))
    for a, b in zip(out, ref):
        _close(a, b, 2e-5, 1e-4)


def test_find_reasonable_step_size_matches_jax(problem):
    """ε is a power of 2, so the per-chain results agree exactly."""
    jt, tt, x0, _, _ = problem
    keys = jax.random.split(jax.random.key(5), C)
    pos = jnp.asarray(x0 * 3.0)
    eps_ref = jax.vmap(lambda k, x: jham.find_reasonable_step_size(k, jt, x))(keys, pos)
    p0 = jax.vmap(lambda k, x: jax.random.normal(k, x.shape, x.dtype))(keys, pos)
    eps = tham.find_reasonable_step_size(
        tt, torch.from_numpy(x0 * 3.0), momentum=torch.tensor(np.asarray(p0)))
    np.testing.assert_array_equal(eps.numpy(), np.asarray(eps_ref))
    assert len(set(np.log2(eps.numpy()).tolist())) > 1  # chains differ


def test_hmc_step_matches_jax(problem):
    """One HMC transition with per-chain ('chain') jitter, per-chain ε and a
    non-identity mass, from JAX's momentum, accept uniform and jitter draw."""
    jt, tt, x0, _, inv_mass = problem
    kw = dict(leapstep=0.1, trajectory_length=0.6, jitter=0.5, jitter_style="chain",
              dynamic_nleaps=True, max_nleaps=64)
    js, ts = jkt.HMC(**kw), kt.HMC(**kw)
    tuner = jkt.DualAveragingTuner(0.8, 100)
    state = jax.vmap(lambda x: js.init(jax.random.key(0), jt, x, step_size=0.1, tuner=tuner))(
        jnp.asarray(x0))
    state = state._replace(
        inv_mass=jnp.asarray(inv_mass),
        tune=state.tune._replace(step=jnp.asarray(np.linspace(0.04, 0.12, C), jnp.float32)),
    )
    keys = jax.random.split(jax.random.key(9), C)
    new_ref, info_ref = jax.vmap(lambda k, s: js.step(k, s, jt))(keys, state)

    def draws(key, s):  # HMC.step's key schedule
        key, k_jit = jax.random.split(key)
        k_mom, k_acc = jax.random.split(key)
        p0 = jham.sample_momentum(k_mom, s.position, s.inv_mass)
        return p0, jax.random.uniform(k_acc), jax.random.uniform(k_jit)

    p0, u, u_jit = (torch.tensor(np.asarray(a)) for a in jax.vmap(draws)(keys, state))
    tstate = convert.hmc_state_from_numpy(jax.tree.map(np.asarray, state), device="cpu")
    new, info = ts.step(tstate, tt, momentum=p0, u=u, jitter_u=u_jit)

    np.testing.assert_array_equal(info.extras["nleaps"].numpy(), np.asarray(info_ref.extras["nleaps"]))
    assert len(set(info.extras["nleaps"].tolist())) > 1
    np.testing.assert_array_equal(info.accept.numpy(), np.asarray(info_ref.accept))
    _close(info.extras["traj_frac"], info_ref.extras["traj_frac"], 1e-6, 1e-6)
    _close(info.accept_stat, info_ref.accept_stat, 1e-4, 1e-5)
    for name in ("x_prop", "p_end"):
        _close(info.extras[name], info_ref.extras[name], 2e-5, 1e-4)
    _close(new.position, new_ref.position, 2e-5, 2e-5)
    _close(new.logtarget, new_ref.logtarget, 2e-5, 1e-4)
    _close(new.gradlogtarget, new_ref.gradlogtarget, 2e-5, 1e-4)


def test_hamiltonian_matches_jax_bitwise():
    """H decides discrete outcomes (the Metropolis accept, NUTS's slice
    test u <= H), so the port copies JAX's f32 order, M⁻¹·p² and not
    (M⁻¹·p)·p.  With one coordinate per chain there is no reduction order
    to differ, and the two agree exactly."""
    rng = np.random.default_rng(0)
    lt = (100.0 * rng.standard_normal(4096)).astype(np.float32)
    p = rng.standard_normal((4096, 1)).astype(np.float32)
    m = rng.uniform(0.1, 3.0, (4096, 1)).astype(np.float32)
    ref = jax.vmap(jham.hamiltonian)(jnp.asarray(lt), jnp.asarray(p), jnp.asarray(m))
    out = tham.hamiltonian(torch.from_numpy(lt), torch.from_numpy(p), torch.from_numpy(m))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
