"""One transition of each sampler of the zoo (MALA, ARS, AM, RAM, AMWG, slice,
SMMALA) against ``jax.vmap(Sampler.step)`` with JAX's draws replayed: the
draws are rebuilt here from each kernel's key schedule (the packages'
generators differ), handed to the port's ``step``, and the accept decisions
must be equal in every chain, positions and state within rtol 1e-5 (AM and
RAM factors and SMMALA tensors rtol 1e-4), f32 on the CPU.  AM and RAM also
run 15 consecutive steps (crossing AM's ``t0 = 10``).  A matrix that is not
positive definite in one chain of AM, RAM or SMMALA must neither raise nor
disturb the other chains."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import klara_tpu as jkt
from klara_tpu.models import examples as jex

import klara_tpu_torch as kt
from klara_tpu_torch import convert
from klara_tpu_torch.models import examples as tex
from klara_tpu_torch.samplers import SliceDraws, base

C, D = 48, 4
F = jnp.float32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _swiss():
    return jex.swiss_logistic_regression()[0], tex.swiss_logistic_regression(device="cpu")[0]


def _corr_normal(d=D):
    rng = np.random.default_rng(11)
    a = rng.standard_normal((d, d))
    prec = (a @ a.T / d + np.eye(d)).astype(np.float32)
    jp, tp = jnp.asarray(prec), torch.tensor(prec)
    return (jkt.Target(lambda x: -0.5 * x @ jp @ x, dim=d),
            kt.Target(lambda x: -0.5 * ((x @ tp) * x).sum(-1), dim=d))


def _swiss_posterior_draws(seed=4, spread=1.0):
    """Positions in the swiss posterior's typical set, where accept decisions
    go both ways: Laplace draws around the mode (Newton steps in float64)."""
    _, X, y = tex.swiss_logistic_regression(device="cpu")
    X, y = X.double().numpy(), y.double().numpy()
    w = np.zeros(D)
    for _ in range(30):
        p = 1.0 / (1.0 + np.exp(-X @ w))
        hess = (X.T * (p * (1 - p))) @ X + np.eye(D) / 100.0
        w = w + np.linalg.solve(hess, X.T @ (y - p) - w / 100.0)
    chol = np.linalg.cholesky(np.linalg.inv(hess))
    noise = np.random.default_rng(seed).standard_normal((C, D))
    return (w + spread * noise @ chol.T).astype(np.float32)


def _x0(scale=0.5, seed=4, d=D):
    return (scale * np.random.default_rng(seed).standard_normal((C, d))).astype(np.float32)


def _split(keys, n=2):
    ks = jax.vmap(lambda k: jax.random.split(k, n))(keys)
    return [ks[:, j] for j in range(n)]


def _normal(keys, d=D):
    return jax.vmap(lambda k: jax.random.normal(k, (d,), F))(keys)


def _uniform(keys):
    return jax.vmap(lambda k: jax.random.uniform(k, dtype=F))(keys)


def _jax_step(js, jt, keys, x0, **init_kw):
    jstate = jax.vmap(lambda k, x: js.init(k, jt, x, **init_kw))(keys, jnp.asarray(x0))
    return jstate, jax.vmap(lambda k, st: js.step(k, st, jt))(keys, jstate)


def _check_common(tnew, tinfo, jnew, jinfo, stat_rtol=1e-5):
    """``stat_rtol``: on the swiss target the ratio is a difference of sums
    over 200 rows of size ~30, so its f32 rounding (~1e-5 absolute, the two
    packages sum in different orders) is the relative error of
    accept_stat = e^ratio; the swiss cases hold it to 5e-4."""
    acc = np.asarray(jinfo.accept)
    assert 0 < acc.sum() < C
    np.testing.assert_array_equal(tinfo.accept.numpy(), acc)
    _close(tnew.position, jnew.position)
    _close(tnew.logtarget, jnew.logtarget, atol=1e-4)
    _close(tinfo.accept_stat, jinfo.accept_stat, rtol=stat_rtol, atol=1e-5)


def test_mala_step_matches_jax():
    jt, tt = _swiss()
    keys = jax.random.split(jax.random.key(1), C)
    x0 = _swiss_posterior_draws()
    js, ts = jkt.MALA(driftstep=0.15), kt.MALA(driftstep=0.15)
    _, (jnew, jinfo) = _jax_step(js, jt, keys, x0)
    k_noise, k_acc = _split(keys)
    tstate = ts.init(tt, _t(x0))
    tnew, tinfo = ts.step(tstate, tt, z=_t(_normal(k_noise)), u=_t(_uniform(k_acc)))
    _check_common(tnew, tinfo, jnew, jinfo, stat_rtol=5e-4)
    _close(tnew.gradlogtarget, jnew.gradlogtarget, rtol=1e-4, atol=1e-4)
    assert tnew.tune.step.shape == (C,)


def test_ars_step_matches_jax():
    jt, tt = jex.normal_target(D), tex.normal_target(D)
    js = jkt.ARS(logproposal=lambda x: -0.5 * jnp.sum(jnp.square(x / 2.0)), proposalscale=0.5,
                 jumpscale=1.2)
    ts = kt.ARS(logproposal=lambda x: -0.5 * torch.square(x / 2.0).sum(-1), proposalscale=0.5,
                jumpscale=1.2)
    keys = jax.random.split(jax.random.key(2), C)
    x0 = _x0(1.0)
    _, (jnew, jinfo) = _jax_step(js, jt, keys, x0)
    k_jump, k_acc = _split(keys)
    tnew, tinfo = ts.step(ts.init(tt, _t(x0)), tt, z=_t(_normal(k_jump)), u=_t(_uniform(k_acc)))
    _check_common(tnew, tinfo, jnew, jinfo)
    _close(tinfo.extras["weight"], jinfo.extras["weight"])


def _am_replay(keys):
    k_comp, k_noise, k_acc = _split(keys, 3)
    return dict(u_comp=_t(_uniform(k_comp)), z=_t(_normal(k_noise)), u=_t(_uniform(k_acc)))


def _ram_replay(keys):
    k_noise, k_acc = _split(keys)
    return dict(z=_t(_normal(k_noise)), u=_t(_uniform(k_acc)))


@pytest.mark.parametrize("name", ["am", "ram"])
def test_am_ram_15_steps_match_jax(name):
    """15 consecutive steps from the same start: AM crosses t0 = 10, so both
    proposal branches and the covariance recursion run; RAM's factor is
    updated every step.  Each step replays JAX's draws and is compared with
    JAX's state after that step: accept exact, positions rtol 1e-5,
    covariance / factor rtol 1e-4 with atol 5e-5, a ten-thousandth of the
    factor's scale, since RAM's update feeds on e^ratio, whose f32 error is
    ~1e-4 on this target.  The port takes each step from JAX's previous
    state, carried over by ``convert.state_from_numpy``, so a step's rounding
    is not fed into the next step's comparison."""
    jt, tt = _swiss()
    if name == "am":
        js, ts = jkt.AM(C0=0.5, corescale=1.4, minorscale=0.05), kt.AM(C0=0.5, corescale=1.4,
                                                                       minorscale=0.05)
        replay, big = _am_replay, "C"
    else:
        js, ts = jkt.RAM(S0=0.3), kt.RAM(S0=0.3)
        replay, big = _ram_replay, "S"
    x0 = _swiss_posterior_draws()
    key0 = jax.random.key(3)
    jstate = jax.vmap(lambda k, x: js.init(k, jt, x))(jax.random.split(key0, C), jnp.asarray(x0))
    tstate = ts.init(tt, _t(x0))
    jstep = jax.jit(jax.vmap(lambda k, st: js.step(k, st, jt)))
    n_acc = 0
    for i in range(15):
        keys = jax.random.split(jax.random.fold_in(key0, i), C)
        if i > 0:
            tstate = convert.state_from_numpy(_np(jstate), device="cpu")
        jstate, jinfo = jstep(keys, jstate)
        tstate, tinfo = ts.step(tstate, tt, **replay(keys))
        np.testing.assert_array_equal(tinfo.accept.numpy(), np.asarray(jinfo.accept))
        _close(tstate.position, jstate.position)
        _close(getattr(tstate, big), getattr(jstate, big), rtol=1e-4, atol=5e-5)
        n_acc += int(np.asarray(jinfo.accept).sum())
    assert 0 < n_acc < 15 * C
    np.testing.assert_array_equal(tstate.count.numpy(), np.asarray(jstate.count))
    if name == "am":
        _close(tstate.lastmean, jstate.lastmean)
        _close(tstate.secondlastmean, jstate.secondlastmean)
        assert not np.allclose(np.asarray(jstate.C), 0.5 * np.eye(D))  # it did adapt
    assert type(convert.state_from_numpy(_np(jstate), device="cpu")) is type(tstate)


def test_am_one_step_matches_jax():
    jt, tt = _corr_normal()
    js, ts = jkt.AM(minorscale=0.5, t0=0), kt.AM(minorscale=0.5, t0=0)
    keys = jax.random.split(jax.random.key(5), C)
    x0 = _x0(1.0)
    _, (jnew, jinfo) = _jax_step(js, jt, keys, x0)
    tnew, tinfo = ts.step(ts.init(tt, _t(x0)), tt, **_am_replay(keys))
    _check_common(tnew, tinfo, jnew, jinfo)
    _close(tnew.C, jnew.C, rtol=1e-4)


def test_ram_one_step_matches_jax():
    jt, tt = _corr_normal()
    js, ts = jkt.RAM(), kt.RAM()
    keys = jax.random.split(jax.random.key(6), C)
    x0 = _x0(1.0)
    _, (jnew, jinfo) = _jax_step(js, jt, keys, x0)
    tnew, tinfo = ts.step(ts.init(tt, _t(x0)), tt, **_ram_replay(keys))
    _check_common(tnew, tinfo, jnew, jinfo)
    _close(tnew.S, jnew.S, rtol=1e-4)


def _amwg_draws(keys, d, bounded):
    """The per-coordinate draws of AMWG's sweep: key, k_prop, k_acc =
    split(key, 3) at each coordinate.  The truncated proposal maps one
    U(0, 1) draw of k_prop through the inverse CDF; the port takes that draw."""
    z, u = [], []
    for _ in range(d):
        keys, k_prop, k_acc = _split(keys, 3)
        if bounded:
            z.append(_uniform(k_prop))
        else:
            z.append(jax.vmap(lambda k: jax.random.normal(k, dtype=F))(k_prop))
        u.append(_uniform(k_acc))
    return _t(jnp.stack(z, 1)), _t(jnp.stack(u, 1))


@pytest.mark.parametrize("bounded", [False, True])
def test_amwg_sweep_matches_jax(bounded):
    """One sweep over 4 coordinates.  With bounds the proposal is the
    truncated normal (JAX inverts erf in f32, the port Φ in float64: the
    proposals agree to rtol 1e-5) and the ratio carries the log-normalisers'
    difference in JAX's log(cdf(b) − cdf(a)) form."""
    jt, tt = _corr_normal()
    kw = dict(sigma0=0.8, lower=-0.2, upper=2.5) if bounded else dict(sigma0=0.8)
    js, ts = jkt.AMWG(**kw), kt.AMWG(**kw)
    keys = jax.random.split(jax.random.key(7), C)
    x0 = np.abs(_x0(0.8)) if bounded else _x0(0.8)
    _, (jnew, jinfo) = _jax_step(js, jt, keys, x0)
    z, u = _amwg_draws(keys, D, bounded)
    tnew, tinfo = ts.step(ts.init(tt, _t(x0)), tt, z=z, u=u)
    jvec = np.asarray(jinfo.extras["accept_vec"])
    assert 0 < jvec.sum() < C * D
    np.testing.assert_array_equal(tinfo.extras["accept_vec"].numpy(), jvec)
    _close(tnew.position, jnew.position)
    _close(tnew.logtarget, jnew.logtarget, atol=1e-4)
    _close(tinfo.accept, jinfo.accept)  # the sweep's accepted fraction
    assert tinfo.accept.shape == (C,) and tinfo.extras["logsigma"].shape == (C, D)
    np.testing.assert_array_equal(tnew.tune.proposed.numpy(), np.asarray(jnew.tune.proposed))
    _close(tnew.tune.accepted, jnew.tune.accepted, rtol=0, atol=0)
    if bounded:
        assert float(tnew.position.min()) >= -0.2 and float(tnew.position.max()) <= 2.5
    back = convert.state_from_numpy(_np(jnew), device="cpu")
    _close(back.tune.step, tnew.tune.step)
    assert back.tune.extra.batch.shape == (C,)


def _slice_draws(keys, d, k_max):
    """key, k_u, k_r, k_shrink = split(key, 4) per coordinate; the shrink
    loop splits k_shrink once per iteration and draws from the second half."""
    su, iu, sh = [], [], []
    for _ in range(d):
        keys, k_u, k_r, k_s = _split(keys, 4)
        su.append(_uniform(k_u))
        iu.append(_uniform(k_r))
        row = []
        for _ in range(k_max):
            k_s, k_draw = _split(k_s)
            row.append(_uniform(k_draw))
        sh.append(jnp.stack(row, 1))
    return SliceDraws(_t(jnp.stack(su, 1)), _t(jnp.stack(iu, 1)), _t(jnp.stack(sh, 1)))


@pytest.mark.parametrize("stepout", [True, False])
def test_slice_sweep_matches_jax(stepout):
    """One sweep; every chain's k-th shrink draw is its own k-th draw.
    Narrow widths force step-outs, and the caps (8 each) are generous enough
    that no chain exhausts them."""
    jt, tt = _corr_normal()
    kw = dict(widths=0.6, stepout=stepout, max_stepouts=8, max_shrinks=12)
    js, ts = jkt.SliceSampler(**kw), kt.SliceSampler(**kw)
    keys = jax.random.split(jax.random.key(8), C)
    x0 = _x0(1.0)
    _, (jnew, jinfo) = _jax_step(js, jt, keys, x0)
    tnew, tinfo = ts.step(ts.init(tt, _t(x0)), tt, draws=_slice_draws(keys, D, 12))
    np.testing.assert_array_equal(tinfo.accept.numpy(), np.asarray(jinfo.accept))
    _close(tnew.position, jnew.position)
    _close(tnew.logtarget, jnew.logtarget)
    assert bool(tinfo.accept.all())


def test_slice_cap_exhausted_keeps_the_coordinate():
    """max_shrinks = 1 with wide intervals: most first draws fall outside the
    slice, and those coordinates stay; JAX does the same on the same draws."""
    jt, tt = _corr_normal()
    kw = dict(widths=8.0, stepout=False, max_shrinks=1)
    js, ts = jkt.SliceSampler(**kw), kt.SliceSampler(**kw)
    keys = jax.random.split(jax.random.key(9), C)
    x0 = _x0(1.0)
    _, (jnew, jinfo) = _jax_step(js, jt, keys, x0)
    tnew, tinfo = ts.step(ts.init(tt, _t(x0)), tt, draws=_slice_draws(keys, D, 1))
    stayed = (tnew.position == _t(x0))
    assert 0 < int(stayed.sum()) < C * D
    np.testing.assert_array_equal(stayed.numpy(), np.asarray(jnew.position) == x0)
    _close(tnew.position, jnew.position)
    _close(tnew.logtarget, jnew.logtarget)


def test_slice_counts_its_host_reads():
    from klara_tpu_torch.utils import tracing

    def reads():
        return tracing.counters().get("host_read.slice_shrink", (0, 0))[0]

    _, tt = _corr_normal()
    ts = kt.SliceSampler(widths=1.0)
    state = ts.init(tt, _t(_x0(1.0)))
    before = reads()
    ts.step(state, tt, torch.Generator().manual_seed(0))
    # per coordinate at least one read per step-out side and two in the shrink loop
    assert reads() - before >= 4 * D


@pytest.mark.parametrize("transform", [None, "softabs"])
def test_smmala_step_matches_jax(transform):
    """The default tensor is the Hessian of logdensity_fn; value and gradient
    come from the fused value+grad.  Tensors and inverses rtol 1e-4."""
    jt, tt = _swiss()
    js = jkt.SMMALA(driftstep=0.9, transform=transform, softabs_alpha=50.0)
    ts = kt.SMMALA(driftstep=0.9, transform=transform, softabs_alpha=50.0)
    keys = jax.random.split(jax.random.key(10), C)
    x0 = _swiss_posterior_draws(spread=1.5)
    jstate, (jnew, jinfo) = _jax_step(js, jt, keys, x0)
    tstate = ts.init(tt, _t(x0))
    for f in ("tensor", "invtensor", "firstterm"):
        _close(getattr(tstate, f), getattr(jstate, f), rtol=1e-4, atol=1e-4)
    tnew, tinfo = ts.step(tstate, tt, **_ram_replay(keys))
    _check_common(tnew, tinfo, jnew, jinfo, stat_rtol=5e-4)
    for f in ("tensor", "invtensor", "firstterm", "gradlogtarget"):
        _close(getattr(tnew, f), getattr(jnew, f), rtol=1e-4, atol=1e-4)
    back = convert.state_from_numpy(_np(jnew), device="cpu")
    assert type(back) is type(tnew) and back.tensor.shape == (C, D, D)


# ------------------------------------------------------- failed factorisations
def test_cholesky_or_nan_fails_one_chain_only():
    a = torch.eye(3).repeat(4, 1, 1) * torch.tensor([1.0, 2.0, 3.0, 4.0])[:, None, None]
    a[2] = torch.tensor([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]])  # indefinite
    out = base.cholesky_or_nan(a)
    assert bool(torch.isnan(out[2]).all())
    torch.testing.assert_close(out[[0, 1, 3]], torch.linalg.cholesky(a[[0, 1, 3]]))
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(a)
    b = a.clone()
    b[1] = 0.0  # singular
    inv = base.inverse_or_nan(b)
    assert bool(torch.isnan(inv[1]).all())
    torch.testing.assert_close(inv[[0, 2, 3]], torch.linalg.inv(b[[0, 2, 3]]))


@pytest.mark.parametrize("name", ["am", "ram", "smmala"])
def test_non_pd_matrix_in_one_chain_leaves_the_others_untouched(name, monkeypatch):
    """Chain 5's matrix is made indefinite; the step must not raise, that
    chain must stay where it is (AM, SMMALA: a NaN proposal rejects; RAM keeps
    its factor) and every other chain must do exactly what it does in a batch
    without the bad matrix.  The library calls that raise on failure or read
    their status back are forbidden on these paths."""
    def forbidden(*a, **k):
        raise AssertionError("a status-reading factorisation was called")

    monkeypatch.setattr(torch.linalg, "cholesky", forbidden)
    monkeypatch.setattr(torch.linalg, "inv", forbidden)
    _, tt = _corr_normal()
    x0 = _t(_x0(1.0))
    gen = torch.Generator().manual_seed(0)
    z, u = torch.randn(C, D, generator=gen), torch.rand(C, generator=gen)
    bad = torch.tensor(np.diag([1.0, -1.0, 1.0, 1.0]).astype(np.float32))
    if name == "am":
        s = kt.AM(t0=0)
        # count 5: the recursion keeps 3/4 of the carried covariance
        good = s.init(tt, x0)
        good = good._replace(count=good.count + 5)
        state = good._replace(C=good.C.clone())
        state.C[5] = bad
        kw = dict(z=z, u=u, u_comp=torch.ones(C))
    elif name == "ram":
        s = kt.RAM()
        good = s.init(tt, x0)
        # S (I + c zzᵀ/‖z‖²) Sᵀ with c > −1 is never indefinite: the update
        # fails by overflow, here of chain 5's huge factor
        state = good._replace(S=good.S.clone())
        state.S[5] = 1e25 * torch.eye(D)
        kw = dict(z=z, u=u)
    else:
        s = kt.SMMALA(driftstep=0.5)
        good = s.init(tt, x0)
        state = good._replace(invtensor=good.invtensor.clone())
        state.invtensor[5] = bad
        kw = dict(z=z, u=u)
    ref, ref_info = s.step(good, tt, **kw)
    new, info = s.step(state, tt, **kw)
    others = [c for c in range(C) if c != 5]
    torch.testing.assert_close(new.position[others], ref.position[others], rtol=0, atol=0)
    assert torch.equal(info.accept[others], ref_info.accept[others])
    assert bool(torch.isfinite(new.position).all())
    if name == "ram":
        assert torch.equal(new.S[5], state.S[5])  # the failed update kept the factor
        torch.testing.assert_close(new.S[others], ref.S[others], rtol=0, atol=0)
    else:
        assert not bool(info.accept[5])
        assert torch.equal(new.position[5], x0[5])


# ------------------------------------------------------------------ converter
def _zoo_pairs():
    env_j = lambda x: -0.5 * jnp.sum(jnp.square(x / 2.0))  # noqa: E731
    return {
        "MALA": (jkt.MALA(0.3), kt.MALA(0.3)),
        "ARS": (jkt.ARS(logproposal=env_j), kt.ARS(
            logproposal=lambda x: -0.5 * torch.square(x / 2.0).sum(-1))),
        "AM": (jkt.AM(C0=0.5), kt.AM(C0=0.5)),
        "RAM": (jkt.RAM(S0=[0.1, 0.2, 0.3, 0.4]), kt.RAM(S0=[0.1, 0.2, 0.3, 0.4])),
        "AMWG": (jkt.AMWG(sigma0=0.7), kt.AMWG(sigma0=0.7)),
        "SliceSampler": (jkt.SliceSampler(), kt.SliceSampler()),
        "SMMALA": (jkt.SMMALA(0.4), kt.SMMALA(0.4)),
        "MH": (jkt.MH(0.5), kt.MH(0.5)),
    }


@pytest.mark.parametrize("name", ["MALA", "ARS", "AM", "RAM", "AMWG", "SliceSampler", "SMMALA",
                                  "MH"])
def test_init_state_matches_jax_and_converts(name):
    """``init`` builds the same state as ``jax.vmap(init)`` leaf by leaf
    (shapes included: every per-chain scalar is (C,), every per-chain matrix
    (C, D, D)), and ``convert.state_from_numpy`` carries JAX's state over to
    the port's type of the same name."""
    jt, tt = _corr_normal()
    js, ts = _zoo_pairs()[name]
    x0 = _x0(1.0)
    keys = jax.random.split(jax.random.key(0), C)
    jstate = _np(jax.vmap(lambda k, x: js.init(k, jt, x))(keys, jnp.asarray(x0)))
    tstate = ts.init(tt, _t(x0))
    back = convert.state_from_numpy(jstate, device="cpu")
    assert type(back) is type(tstate)

    def leaves(st):
        for f, v in zip(st._fields, st):
            if hasattr(v, "_fields"):
                yield from ((f"{f}.{g}", w) for g, w in leaves(v))
            elif torch.is_tensor(v):
                yield f, v

    got, want = dict(leaves(tstate)), dict(leaves(back))
    assert got.keys() == want.keys()
    for f in got:
        assert got[f].shape == want[f].shape and got[f].dtype == want[f].dtype, f
        np.testing.assert_allclose(got[f].numpy(), want[f].numpy(), rtol=1e-5, atol=1e-6,
                                   equal_nan=True, err_msg=f)


def test_converter_rejects_an_unknown_state():
    import collections

    with pytest.raises(ValueError, match="no converter"):
        convert.state_from_numpy(collections.namedtuple("OtherState", "position")(np.zeros(2)))


def test_amwg_takes_a_per_coordinate_start():
    """``step_size`` (a number or a (D,) vector) replaces sigma0, as in the
    JAX package."""
    _, tt = _corr_normal()
    sig = torch.tensor([0.1, 0.2, 0.4, 0.8])
    st = kt.AMWG().init(tt, _t(_x0()), step_size=sig)
    torch.testing.assert_close(st.tune.step, torch.log(sig).expand(C, D))
    assert st.tune.accepted.shape == (C, D) and st.tune.proposed.shape == (C,)
