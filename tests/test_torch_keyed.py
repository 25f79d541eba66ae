"""The port's per-chain keyed draws (klara_tpu_torch/ops/keyed.py): the
plain version of kernel K2, which CPU tensors take and against which
``chip_smoke.py`` phase 27 holds the kernel on the card.

* Philox4x32-10 against the Random123 known-answer vectors (kat_vectors);
* every mode against ``scipy.stats`` on phase 27's grid at 10^5 draws: a
  seeded Kolmogorov-Smirnov test at p > 1e-3 (the statistic taken at both
  sides of every distinct value, so that the discrete modes and gamma's
  atom at the smallest normal number are scored as they are) and the mean
  and variance within 5 standard errors;
* rank-count independence: chains [a, b) drawn alone equal the same slice
  of all of them, bit for bit, and another step, site or part changes
  the numbers;
* the edge cases (n = 0, p in {0, 1}, lam = 0, alpha << 1, invalid
  parameters) and the cap of a rejection loop.

The keyed stream's place in the jobs (Gibbs conditionals, MH proposals, two
ranks against one process) is tested in test_torch_gibbs.py,
test_torch_mh.py and test_torch_parallel.py."""

import math

import numpy as np
import pytest
import scipy.stats as st
import torch

from klara_tpu_torch import distributions as td
from klara_tpu_torch.ops import keyed
from klara_tpu_torch.ops.keyed import (
    BINOMIAL,
    GAMMA,
    NORMAL,
    POISSON,
    UNIFORM,
    KeyedStream,
    draws_reference,
    philox4x32,
)

CHAINS, ELEMS = 1000, 100  # 10^5 draws
KS_P, MOMENT_Z = 1e-3, 5.0
ALPHAS = (1e-3, 0.3, 1.0, 7.5, 1e4)
LAMBDAS = (0.5, 9.9, 10.0, 1e3)
BINOMIALS = [(n, p) for n in (1, 20, 1000) for p in (0.01, 0.5, 0.99)]


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain version is many elementwise passes: on one thread each, as
    the suite's test processes share the machine's cores (with a thread per
    core in every process they run many times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(chains=CHAINS, offset=0, step=7, site=3, seed=0):
    key = torch.tensor(np.random.default_rng(seed).integers(-2**63, 2**63 - 1), dtype=torch.int64)
    return KeyedStream(key, chains, offset, step, site)


# -------------------------------------------------------------- Philox KAT
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    words = philox4x32(*(torch.tensor(v, dtype=torch.int64) for v in counter + key))
    assert [int(w) for w in words] == list(want)


def test_philox_words_follow_the_counter_layout():
    """Call 0's words of element e of chain c are Philox at counter (offset
    + c, step, site << 8 | part, e << 12), key (low, high) of the run key:
    read back through the f64 uniform (53 bits of words 0-1, exact) and the
    f64 normal (words 0-1 and 2-3), which use all four words."""
    s = _stream(chains=3, offset=5, step=11, site=2).at(part=1)
    u = s.uniform((3, 4), torch.float64)
    z = s.normal((3, 4), torch.float64)
    key = int(s.key)
    k0, k1 = key & 0xFFFFFFFF, (key >> 32) & 0xFFFFFFFF
    for c, e in ((0, 0), (2, 3), (1, 2)):
        w = [int(v) for v in philox4x32(*(torch.tensor(v) for v in
                                         (5 + c, 11, (2 << 8) | 1, e << 12, k0, k1)))]
        assert float(u[c, e]) == ((w[0] >> 5) * 2**26 + (w[1] >> 6)) * 2.0**-53
        u1, u2 = (torch.tensor(((a >> 5) * 2**26 + (b >> 6)) * 2.0**-53, dtype=torch.float64)
                  for a, b in ((w[0], w[1]), (w[2], w[3])))
        want = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(u2 * (2.0 * math.pi))
        assert float(z[c, e]) == float(want)


# ---------------------------------------------------------- against scipy
def _ks_p(x, cdf, cdf_left):
    """Two-sided KS p-value of the sample ``x`` against a distribution with
    CDF ``cdf`` (right-continuous) and left limits ``cdf_left``."""
    x = np.sort(x)
    n = x.size
    v, first, counts = np.unique(x, return_index=True, return_counts=True)
    d = max(np.abs((first + counts) / n - cdf(v)).max(), np.abs(first / n - cdf_left(v)).max())
    return st.kstwo.sf(d, n)


def _moments_ok(x, dist):
    """|mean − μ| and |s² − σ²| in standard errors (Var s² = (μ4 − σ⁴ (n−3)/(n−1)) / n)."""
    mean, var, kurt = (float(m) for m in dist.stats(moments="mvk"))
    n = x.size
    z_mean = abs(x.mean() - mean) / math.sqrt(var / n)
    mu4 = (kurt + 3.0) * var * var
    z_var = abs(x.var(ddof=1) - var) / math.sqrt((mu4 - var * var * (n - 3) / (n - 1)) / n)
    return z_mean, z_var


def _cases():
    for dt in ("float32", "float64"):
        yield dt, "uniform", None
        yield dt, "normal", None
        for a in ALPHAS:
            yield dt, "gamma", a
    for lam in LAMBDAS:
        yield "float32", "poisson", lam
    for np_ in BINOMIALS:
        yield "float32", "binomial", np_


MODE_IDS = {"uniform": UNIFORM, "normal": NORMAL, "gamma": GAMMA, "poisson": POISSON,
            "binomial": BINOMIAL}


def _draw(mode, param, dtype, stream=None):
    stream = stream or _stream()
    dt = getattr(torch, dtype)
    shape = (stream.chains, ELEMS)
    params = tuple(param) if mode == "binomial" else (() if param is None else (param,))
    return draws_reference(stream, MODE_IDS[mode], shape, dt, *params)


@pytest.mark.parametrize("dtype,mode,param", list(_cases()),
                         ids=[f"{m}-{p}-{d}" for d, m, p in _cases()])
def test_plain_version_matches_scipy(dtype, mode, param):
    out, calls, overflow = _draw(mode, param, dtype)
    assert overflow == 0 and bool((calls > 0).all())
    x = out.double().numpy().ravel()
    assert np.isfinite(x).all()
    tiny = np.finfo(dtype).tiny
    if mode == "uniform":
        dist = st.uniform()
        assert 0.0 < x.min() and x.max() < 1.0
        left = dist.cdf
    elif mode == "normal":
        dist, left = st.norm(), st.norm().cdf
    elif mode == "gamma":
        dist = st.gamma(param)
        assert x.min() >= tiny  # never 0: the smallest normal number, as torch and JAX
        # the draws below the smallest normal number sit on it: an atom of mass cdf(tiny)
        left = lambda v: np.where(v <= tiny, 0.0, dist.cdf(v))  # noqa: E731
    elif mode == "poisson":
        dist = st.poisson(param)
        left = lambda v: dist.cdf(v - 1)  # noqa: E731
    else:
        dist = st.binom(*param)
        left = lambda v: dist.cdf(v - 1)  # noqa: E731
    if mode in ("poisson", "binomial"):
        assert np.array_equal(x, np.round(x)) and x.min() >= 0
    p = _ks_p(x, dist.cdf, left)
    assert p > KS_P, (mode, param, p)
    z_mean, z_var = _moments_ok(x, dist)
    assert z_mean < MOMENT_Z and z_var < MOMENT_Z, (mode, param, z_mean, z_var)


def test_gamma_far_below_one_keeps_its_atom_at_the_smallest_normal():
    """alpha = 1e-3 in f32: U^(1/alpha) underflows; the draw is the smallest
    normal number (not 0), in the share the distribution puts below it."""
    out, _, _ = _draw("gamma", 1e-3, "float32")
    tiny = torch.finfo(torch.float32).tiny
    share = float((out == tiny).double().mean())
    want = st.gamma(1e-3).cdf(tiny)
    assert abs(share - want) < 5 * math.sqrt(want * (1 - want) / out.numel())
    assert float(out.min()) == tiny


# ------------------------------------------------- rank-count independence
MODE_ARGS = {"uniform": (UNIFORM,), "normal": (NORMAL,), "gamma": (GAMMA, 0.5),
             "poisson": (POISSON, 30.0), "binomial": (BINOMIAL, 40.0, 0.3)}


@pytest.mark.parametrize("mode", sorted(MODE_ARGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_block_of_chains_draws_its_slice_of_all_chains(mode, dtype):
    mode_id, *params = MODE_ARGS[mode]
    whole = draws_reference(_stream(chains=16), mode_id, (16, 5), dtype, *params)[0]
    for a, b in ((0, 8), (8, 16), (5, 11)):
        part = draws_reference(_stream(chains=b - a, offset=a), mode_id, (b - a, 5), dtype,
                               *params)[0]
        assert torch.equal(part, whole[a:b])
    for other in (dict(step=8), dict(site=4), dict(part=1)):
        moved = draws_reference(_stream(chains=16).at(**other), mode_id, (16, 5), dtype,
                                *params)[0]
        assert not bool((moved == whole).all()), other


def test_per_chain_parameters_travel_with_their_chains():
    """A per-chain rate (C,) and a per-element shape (C, E): the block of
    chains [a, b) with its block of parameters equals the whole draw's
    slice, and a tensor step equals the same number."""
    g = torch.Generator().manual_seed(0)
    rate = 1.0 + 40.0 * torch.rand(12, 1, generator=g)
    alpha = 0.2 + 5.0 * torch.rand(12, 3, generator=g)
    whole = _stream(chains=12)
    for a, b in ((0, 6), (6, 12)):
        part = _stream(chains=b - a, offset=a)
        assert torch.equal(part.poisson(rate[a:b], (b - a, 3)), whole.poisson(rate, (12, 3))[a:b])
        assert torch.equal(part.standard_gamma(alpha[a:b], (b - a, 3)),
                           whole.standard_gamma(alpha, (12, 3))[a:b])
    as_tensor = whole.at(step=torch.tensor(whole.step))
    assert torch.equal(as_tensor.normal((12, 3)), whole.normal((12, 3)))


# ---------------------------------------------------------- edge cases, cap
def test_binomial_and_poisson_edges_are_exact():
    s = _stream(chains=4)
    n = torch.tensor([0.0, 7.0, 7.0, 1e6])
    p = torch.tensor([0.4, 0.0, 1.0, 1.0])
    assert s.binomial(n[:, None], p[:, None], (4, 3)).tolist() == [[0.0] * 3, [0.0] * 3,
                                                                     [7.0] * 3, [1e6] * 3]
    assert s.poisson(0.0, (4, 2)).eq(0).all()
    bad = s.binomial(torch.tensor([[-1.0], [3.0], [3.0], [math.nan]]),
                     torch.tensor([[0.5], [1.5], [math.nan], [0.5]]), (4, 1))
    assert bool(torch.isnan(bad).all())
    assert bool(torch.isnan(s.poisson(-1.0, (4, 1))).all())
    assert bool(torch.isnan(s.standard_gamma(0.0, (4, 1))).all())


def test_a_rejection_loop_at_its_cap_raises(monkeypatch):
    monkeypatch.setattr(keyed, "MAX_ATTEMPTS", 0)
    out, calls, overflow = draws_reference(_stream(chains=4), GAMMA, (4, 2), torch.float32, 2.0)
    assert overflow == 8 and bool((calls == -1).all()) and bool(torch.isnan(out).all())
    with pytest.raises(RuntimeError, match="cap of their rejection loop"):
        _stream(chains=4).poisson(50.0, (4, 2))


def test_raise_on_overflow_reads_the_counter_once_and_resets(monkeypatch):
    cpu = torch.device("cpu")
    monkeypatch.setattr(keyed, "_OVERFLOW", {cpu: torch.tensor([3], dtype=torch.int32)})
    monkeypatch.setattr(keyed, "_PENDING", {cpu})
    with pytest.raises(RuntimeError, match="3 element"):
        keyed.raise_on_overflow()
    assert not keyed._PENDING and int(keyed._OVERFLOW[cpu][0]) == 0
    keyed.raise_on_overflow()  # nothing pending: no read


def test_the_stream_refuses_what_its_counter_cannot_name():
    s = _stream(chains=4)
    with pytest.raises(ValueError, match="axis 0 is not the stream's 4 chains"):
        s.normal((5, 2))
    with pytest.raises(ValueError, match="elements per chain"):
        s.normal((4, 1 << 20))
    with pytest.raises(TypeError, match="float32 or float64"):
        s.normal((4, 2), torch.float16)
    with pytest.raises(ValueError, match="out of range"):
        s.at(site=1 << 24).normal((4, 2))


def test_an_input_on_another_device_raises_on_either_path():
    """Keyed draws never move their inputs: a parameter, a step or a
    generator on another device than the draws raises, on the plain path
    (a CPU stream) as on the kernel's, instead of drawing on the host."""
    s = _stream(chains=4)
    elsewhere = torch.full((4, 1), 2.0, device="meta")
    with pytest.raises(ValueError, match="a parameter is on meta"):
        s.standard_gamma(elsewhere, (4, 1))
    with pytest.raises(ValueError, match="a parameter is on meta"):
        s.binomial(10.0, elsewhere, (4, 1))
    with pytest.raises(ValueError, match="the step is on meta"):
        s.at(step=torch.zeros((), dtype=torch.int64, device="meta")).normal((4, 1))
    with pytest.raises(ValueError, match="the generator is on cpu"):
        keyed.run_key(torch.Generator(), "meta")
    with pytest.raises(ValueError, match="the generator is on cpu"):
        KeyedStream.for_run(torch.Generator(), "meta", 4)
    assert keyed.run_key(torch.Generator(), "cpu").device.type == "cpu"


# ---------------------------------------------------- through the classes
def test_keyed_gamma_shares_one_draw_per_chain_across_a_vector_rate():
    """The JAX shape rule within a chain: Gamma(3, rate (C, K)) drawn per
    chain takes one element per chain and divides it by the K rates."""
    rate = torch.linspace(0.5, 2.0, 6).expand(8, 6)
    s = _stream(chains=8)
    draw = td.draw_per_chain(td.Gamma(3.0, rate), torch.zeros(8, 6), s)
    g = s.standard_gamma(3.0, (8, 1))
    torch.testing.assert_close(draw, g / rate, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["Normal", "LogNormal", "Uniform", "Exponential", "Laplace",
                                  "Gamma", "InverseGamma", "Beta", "TruncatedNormal", "Bernoulli",
                                  "Binary", "Binomial", "Poisson", "MvNormal", "Dirichlet"])
def test_every_class_draws_from_a_keyed_stream(name):
    """Each of the fifteen classes draws per chain from a stream (a scalar
    per chain; a 3-vector for MvNormal and Dirichlet): the value's shape,
    finite and on the support, a block of chains its slice of all."""
    C = 6
    dists = {
        "Normal": td.Normal(1.0, 2.0), "LogNormal": td.LogNormal(0.0, 1.0),
        "Uniform": td.Uniform(-1.0, 2.0), "Exponential": td.Exponential(2.0),
        "Laplace": td.Laplace(0.0, 1.0), "Gamma": td.Gamma(2.0, 3.0),
        "InverseGamma": td.InverseGamma(3.0, 2.0), "Beta": td.Beta(2.0, 0.5),
        "TruncatedNormal": td.TruncatedNormal(0.0, 1.0, 0.5, 2.0),
        "Bernoulli": td.Bernoulli(0.3), "Binary": td.Binary(2, 5, 0.4),
        "Binomial": td.Binomial(30, 0.4), "Poisson": td.Poisson(12.0),
        "MvNormal": td.MvNormal(torch.zeros(3), torch.eye(3)),
        "Dirichlet": td.Dirichlet(torch.tensor([1.0, 2.0, 0.5])),
    }
    dist = dists[name]
    event = (3,) if dist.event_dims else ()
    whole = td.draw_per_chain(dist, torch.zeros((C,) + event), _stream(chains=C))
    part = td.draw_per_chain(dist, torch.zeros((3,) + event), _stream(chains=3, offset=3))
    assert tuple(whole.shape) == (C,) + event and torch.equal(part, whole[3:])
    assert bool(torch.isfinite(whole).all())
    assert bool(torch.isfinite(dist.logpdf(whole.to(torch.float32))).all())


# ------------------------------------------------------- K2's launch path
def _launch(stream, mode, shape, dtype, *params):
    """``launch_args`` with its fields by name (``ARG_FIELDS`` after out and
    calls) and the parameter tensors the kernel reads."""
    shape, tensors, fields = keyed.launch_args(stream, mode, shape, dtype, *params)
    return shape, tensors, dict(zip(keyed.ARG_FIELDS[2:], fields))


def _read_as_kernel(t, chain_stride, elem_stride, shape):
    """What K2 reads for a parameter: element (c, e) at the tensor's own
    pointer plus c * chain_stride + e * elem_stride elements."""
    return torch.as_strided(t, shape, (chain_stride, elem_stride), t.storage_offset())


def _param_cases():
    g = torch.Generator().manual_seed(1)
    C, E = 6, 5
    wide = 1.0 + torch.rand(C, 2 * E, generator=g, dtype=torch.float64)
    return {
        "scalar": 2.5,
        "chain (C, 1)": 1.0 + torch.rand(C, 1, generator=g),
        "element (1, E)": 1.0 + torch.rand(1, E, generator=g),
        "full (C, E)": 1.0 + torch.rand(C, E, generator=g),
        "non-contiguous (C, E)": wide[:, ::2],
        "transposed (C, E)": (1.0 + torch.rand(E, C, generator=g)).t(),
        "0-d": torch.tensor(3.0),
        "(C,) of (C, 1, E)": 1.0 + torch.rand(C, 1, 1, generator=g),
    }


PARAMS = _param_cases()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_launch_args_give_the_plain_versions_parameters(name, dtype):
    """The kernel's view of a parameter (its pointer and two strides, or the
    scalar) reads the values the plain version draws with, in the draw's
    type; (C, E) draws, and a (C, 1, E) draw for the 3-d case."""
    p = PARAMS[name]
    shape = (6, 1, 5) if name.startswith("(C,)") else (6, 5)
    s = _stream(chains=6)
    got, (t0, t1), f = _launch(s, GAMMA, shape, dtype, p)
    want = keyed._flat_param(p, shape, dtype, torch.device("cpu")).reshape(6, 5)
    assert got == shape and f["elems"] == 5 and t1 is None and f["p1"] == 0
    assert f["f64"] == (dtype == torch.float64) and f["mode"] == GAMMA
    if name == "scalar":
        assert t0 is None and f["p0"] == 0 and f["s0"] == p and (f["p0c"], f["p0e"]) == (0, 0)
        return
    assert t0.dtype == dtype and f["p0"] == t0.data_ptr()
    assert torch.equal(_read_as_kernel(t0, f["p0c"], f["p0e"], (6, 5)), want)
    if p.dtype == dtype and name != "transposed (C, E)":
        assert t0.data_ptr() == p.data_ptr()  # read in place, no copy


@pytest.mark.parametrize("offset", [0, 12288])
@pytest.mark.parametrize("step", [0, 7, 2**32 + 3, "tensor"])
@pytest.mark.parametrize("site,part", [(0, 0), (3, 1), (keyed.MH_SITE, 255)])
def test_launch_args_give_the_plain_versions_counter_words(offset, step, site, part):
    """Counter words 1 and 2, the elements per chain and the chains: those
    the plain version's counter (``_counter``, ``_Ctx``) uses; the key and a
    tensor step by their pointers."""
    st = torch.tensor(2**32 + 9) if step == "tensor" else step
    s = _stream(chains=4, offset=offset).at(step=st, site=site, part=part)
    got, _, f = _launch(s, BINOMIAL, (4, 3, 2), torch.float32, 10.0, torch.full((4, 1, 1), 0.3))
    shape, elems, site_word = keyed._counter(s, (4, 3, 2), torch.float32)
    ctx = keyed._Ctx(s, elems, site_word)
    assert (got, f["elems"], f["site_word"]) == (shape, elems, site_word)
    assert f["key"] == s.key.data_ptr()
    if step == "tensor":
        assert f["step"] == st.data_ptr() and f["step_add"] == 0
    else:
        assert f["step"] == 0
    assert (f["step_add"] + (0 if step != "tensor" else int(st))) & 0xFFFFFFFF == ctx.c1
    assert (f["offset"], f["chains"]) == (ctx.offset, 4) == (offset, 4)
    assert (f["p0"], f["s0"], f["p1c"], f["p1e"]) == (0, 10.0, 1, 0)


def test_launch_args_pack_into_the_kernels_struct():
    """The packed arguments are the 136 bytes of ``struct Args`` in
    keyed_draws.cu, one field each of ``ARG_FIELDS``, in its order."""
    assert keyed._ARGS.size == 136 and len(keyed.ARG_FIELDS) == 21
    src = open(keyed._build.CSRC + "/keyed_draws.cu").read()
    assert "static_assert(sizeof(Args) == 136" in src
    fields = (1, 2, 3, 4, 5, 6, 7, 0.5, 0.25, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 1, 0)
    assert keyed._ARGS.unpack(keyed._ARGS.pack(*fields)) == fields


def test_the_launch_plan_keeps_integers_and_reads_tensors_at_every_launch():
    """Two parameters of one layout share a plan, but each launch takes its
    own tensor's pointer and checks its device."""
    s = _stream(chains=4)
    t1, t2 = torch.full((4, 1), 2.0), torch.full((4, 1), 3.0)
    _, (a1, _), f1 = _launch(s, GAMMA, (4, 2), torch.float32, t1)
    _, (a2, _), f2 = _launch(s, GAMMA, (4, 2), torch.float32, t2)
    assert a1 is t1 and a2 is t2 and (f1["p0"], f2["p0"]) == (t1.data_ptr(), t2.data_ptr())
    assert (f1["p0c"], f1["p0e"]) == (f2["p0c"], f2["p0e"]) == (1, 0)
    plans = [v for v in keyed._PLANS.values() if v.shape == (4, 2)]
    assert all(not torch.is_tensor(x) for v in plans for x in (*v.p0, *(v.p1 or ())))
    with pytest.raises(ValueError, match="a parameter is on meta"):
        keyed.launch_args(s, GAMMA, (4, 2), torch.float32, torch.full((4, 1), 2.0, device="meta"))


REFUSED = {
    "a key that is not int64": (dict(key=torch.tensor(3, dtype=torch.int32)), "0-d int64"),
    "a key of two words": (dict(key=torch.zeros(2, dtype=torch.int64)), "0-d int64"),
    "negative chains": (dict(chains=-1), "out of range"),
    "chains past 2^32": (dict(chains=8, offset=2**32 - 4), "out of range"),
    "a negative offset": (dict(offset=-1), "out of range"),
    "site 2^24": (dict(site=1 << 24), "out of range"),
    "a negative site": (dict(site=-1), "out of range"),
    "part 256": (dict(part=256), "out of range"),
    "an int32 step tensor": (dict(step=torch.tensor(3, dtype=torch.int32)), "0-d int64"),
    "a step tensor of two": (dict(step=torch.zeros(2, dtype=torch.int64)), "0-d int64"),
    "a step on another device": (dict(step=torch.zeros((), dtype=torch.int64, device="meta")),
                                 "the step is on meta"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_the_stream_refuses_at_construction_and_at_at(name):
    """What the counter cannot name raises when the stream is made, and when
    ``at`` makes one, before any draw."""
    kw, match = REFUSED[name]
    base = dict(key=torch.tensor(5, dtype=torch.int64), chains=4, offset=0, step=0, site=0,
                part=0)
    with pytest.raises(ValueError, match=match):
        KeyedStream(**{**base, **kw})
    if "key" not in kw:
        with pytest.raises(ValueError, match=match):
            KeyedStream(**base).at(**kw)


@pytest.mark.parametrize("change", [dict(step=9), dict(step=torch.tensor(4)), dict(site=6),
                                    dict(part=1), dict(chains=2), dict(offset=3),
                                    dict(chains=2, offset=3, site=1)])
def test_at_keeps_every_other_field(change):
    s = _stream(chains=4, offset=1, step=7, site=3).at(part=2)
    moved = s.at(**change)
    fields = ("chains", "offset", "step", "site", "part")
    for f in fields:
        assert getattr(moved, f) is (change[f] if f in change else getattr(s, f))
    assert moved.key is s.key and moved.device == s.device
    _, _, f = _launch(moved, NORMAL, (moved.chains, 2), torch.float32)
    assert (f["site_word"], f["offset"], f["chains"]) == ((moved.site << 8) | moved.part,
                                                          moved.offset, moved.chains)
