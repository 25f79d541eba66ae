"""Kernel K3 (``klara_tpu_torch/ops/factor.py``, ``ops/csrc/tri_factor.cu``):
the two products of a batch with a lower-triangular factor, x = shift + A Lᵀ
and A L − y, on the tensor cores in three TF32 passes over the factor's
triangle.

On the CPU:

* the emulation of K3's arithmetic (``factor_product_split``: the rna TF32
  split, three passes, f32 sums a chunk at a time, over the triangle's chunks
  only) against float64, both directions and both epilogues, at D = 1024 and
  the ragged 1100; one pass misses by at least ten times more;
* the factor's images (``prepare_factor``): the triangle's slots alone, which
  unpack to the TF32 halves of tril(L);
* the shape rule (``engages``), and ``through_factor`` below it and on the
  CPU: no K3 launch, and the bytes of the cuBLAS expressions it ran before;
* the wrappers' refusals (CPU tensors among them), the replay-aware launch
  count (``tracing.counted``), and that importing the package needs no ``nvcc``;
* with the launch replaced by the emulation (``_emulated_launch``): the
  wrappers' derivative rules (backward, forward-mode, ``vmap``) against the
  plain products', an LGCP target's AD gradients, tensor and its derivative
  through them, and an LGCP job's count with stand-in graphs.

On the card (skipped without one): K3 against float64 beside cuBLAS f32; an
LGCP target's AD gradient and tensor through K3 against cuBLAS's; an LGCP job
with its units and sampling captured as CUDA graphs counts two K3 launches an
evaluation plus one a log-density call outside one; a whitened job at
D = 100 launches none.
"""

import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import klara_tpu_torch as kt
from klara_tpu_torch.core import target as core_target
from klara_tpu_torch.jobs import graphs
from klara_tpu_torch.models import lgcp
from klara_tpu_torch.ops import factor
from klara_tpu_torch.ops.logreg import tf32_round
from klara_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K3, EVALS = "ops.factor.KERNEL_LAUNCHES", "core.target.FACTOR_EVALUATIONS"
EPS32 = float(torch.finfo(torch.float32).eps)
# f32 grade, relative to the largest entry: a D-term f32 sum's rounding (the
# plain f32 product reads 1e-7 - 1e-6 here)
F32_GRADE = 2e-6


def _count(name):
    """The tracer's count of ``name``."""
    return tracing.counters().get(name, (0, 0))[0]


def _rect_factor(rows, cols):
    """The LGCP's covariance on a rows × cols grid, its float64 factor."""
    n = max(rows, cols)
    i, j = np.divmod(np.arange(rows * cols, dtype=np.float64), cols)
    delta = np.hypot(i[:, None] - i[None, :], j[:, None] - j[None, :])
    return torch.from_numpy(np.linalg.cholesky(lgcp.SIGMA2 * np.exp(-delta / (n * lgcp.BETA))))


FACTORS = {1024: (32, 32), 1100: (44, 25)}


def _problem(D, C=48, seed=0):
    L = _rect_factor(*FACTORS[D]).float()
    g = torch.Generator().manual_seed(seed)
    return L, torch.randn(C, D, generator=g), torch.randn(D, generator=g), torch.randn(C, D, generator=g)


def _reference(A, L, forward, shift, y):
    Ad, Ld = A.double(), L.double()
    out = Ad @ Ld.T if forward else Ad @ Ld
    if shift is not None:
        out = out + shift.double()
    if y is not None:
        out = out - y.double()
    return out


def _rel_err(out, ref):
    return float((out.double() - ref).abs().max() / ref.abs().max())


def _emulated_errors(D, forward, epilogue):
    L, A, shift, y = _problem(D)
    shift = shift if (forward and epilogue) else None
    y = y if (not forward and epilogue) else None
    ref = _reference(A, L, forward, shift, y)
    return [_rel_err(factor.factor_product_split(A, L, forward, passes, shift, y), ref)
            for passes in (3, 1)]


@pytest.mark.parametrize("epilogue", [False, True], ids=["bare", "epilogue"])
@pytest.mark.parametrize("forward", [True, False], ids=["forward", "gradient"])
@pytest.mark.parametrize("D", [1024, 1100])
def test_emulated_three_passes_match_float64_at_f32_grade(D, forward, epilogue):
    three, _ = _emulated_errors(D, forward, epilogue)
    assert three < F32_GRADE, three


@pytest.mark.parametrize("forward", [True, False], ids=["forward", "gradient"])
@pytest.mark.parametrize("D", [1024, 1100])
def test_one_pass_misses_by_ten_times_more(D, forward):
    """TF32 keeps 11 bits of each operand: one pass reads ~1e-4 here, three
    ~1e-7, so the tests above tell the two apart."""
    three, one = _emulated_errors(D, forward, True)
    assert one >= 10 * three and one > 1e-5, (one, three)


@pytest.mark.parametrize("D", [1, 5, 130, 1100])
def test_images_hold_the_triangles_tf32_halves(D):
    """Both images unpack to hi = tf32_round(tril(L)) and lo = the rounded
    rest, whatever the factor holds above its diagonal; they hold the
    triangle's slots alone, 4·T(T+1)/2 of 32 KB each."""
    g = torch.Generator().manual_seed(D)
    L = torch.randn(D, D, generator=g)
    low = torch.tril(L)
    hi = tf32_round(low)
    lo = tf32_round(low - hi)
    prepared = factor.prepare_factor(L)
    T = factor.tiles(D)
    for slots in (prepared.forward, prepared.gradient):
        assert tuple(slots.shape) == (4 * T * (T + 1) // 2, 2, 8, 128, 4)
        assert slots.is_contiguous() and slots[0].numel() * 4 == 32768
    for h, l in prepared.unpack():
        assert torch.equal(h, hi) and torch.equal(l, lo)


def test_the_triangle_skips_the_zero_chunks():
    """At D = 4096 a 128-column tile's K chunks of 128 on its side of the
    diagonal: 528 of 1,024 (51.6%) for either product; every chunk left out
    is zero in tril(L)."""
    for forward in (True, False):
        keep = factor.triangle_chunks(4096, forward)
        assert int(keep.sum()) == 4 * 528 and keep.shape == (32, 128)
    L = torch.tril(torch.ones(300, 300))
    for forward, M in ((True, L), (False, L.T)):
        Mp = torch.zeros(384, 384)
        Mp[:300, :300] = M
        blocks = Mp.view(3, 128, 12, 32).abs().sum((1, 3)) > 0
        assert not bool((blocks & ~factor.triangle_chunks(300, forward)).any())


def _stub(device, dtype, D):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype, shape=(D, D),
                                 dim=lambda: 2)


def test_the_shape_rule():
    """K3 takes a CUDA float32 factor at least ``MIN_DIM`` wide, read from
    the factor alone."""
    assert factor.MIN_DIM == 2048
    assert factor.engages(_stub("cuda", torch.float32, 2048))
    assert factor.engages(_stub("cuda", torch.float32, 4096))
    assert not factor.engages(_stub("cuda", torch.float32, 2047))
    assert not factor.engages(_stub("cuda", torch.float32, 1024))
    assert not factor.engages(_stub("cuda", torch.float32, 100))
    assert not factor.engages(_stub("cuda", torch.float64, 4096))
    assert not factor.engages(_stub("cpu", torch.float32, 4096))
    assert not factor.engages(torch.eye(1024))


@pytest.mark.parametrize("standard_normal", [False, True])
@pytest.mark.parametrize("D", [100, 1024])
def test_through_factor_on_the_cpu_is_todays_cublas_expressions(monkeypatch, D, standard_normal):
    """Below the rule and on the CPU: no K3 launch, no image, and the bytes of
    ``y @ Lᵀ`` / ``addmm(shift, y, Lᵀ)`` and ``g @ L`` / ``addmm(y, g, L, beta=-1)``."""
    before = _count(K3)
    monkeypatch.setattr(factor, "prepare_factor", None)  # never called here
    g = torch.Generator().manual_seed(D)
    L = torch.tril(torch.randn(D, D, generator=g)) / D ** 0.5
    y = torch.randn(6, D, generator=g)
    shift = torch.randn(D, generator=g) if standard_normal else None

    def inner(x):
        return x.sum(-1), torch.sin(x)

    fn, to_x = core_target.through_factor(inner, L, shift, standard_normal=standard_normal)
    v, grad = fn(y)
    Lt = L.T.contiguous()
    x = torch.addmm(shift, y, Lt) if standard_normal else y @ Lt
    assert torch.equal(to_x(y), x)
    if standard_normal:
        assert torch.equal(v, x.sum(-1) - 0.5 * (y * y).sum(-1))
        assert torch.equal(grad, torch.addmm(y, torch.sin(x), L, beta=-1.0))
    else:
        assert torch.equal(v, x.sum(-1)) and torch.equal(grad, torch.sin(x) @ L)
    assert _count(K3) == before


def _refusals():
    L = torch.tril(torch.ones(6, 6))
    p = factor.prepare_factor(L)
    A = torch.ones(3, 6)
    return {
        "dtype": (TypeError, lambda: factor.factor_forward(A.double(), p)),
        "shift dtype": (TypeError, lambda: factor.factor_forward(A, p, torch.ones(6).double())),
        "device": (ValueError, lambda: factor.factor_forward(A.to("meta"), p)),
        "y device": (ValueError, lambda: factor.factor_gradient(A, p, A.to("meta"))),
        "width": (ValueError, lambda: factor.factor_forward(torch.ones(3, 5), p)),
        "rank": (ValueError, lambda: factor.factor_gradient(torch.ones(6), p)),
        "no chains": (ValueError, lambda: factor.factor_gradient(torch.ones(0, 6), p)),
        "shift shape": (ValueError, lambda: factor.factor_forward(A, p, torch.ones(5))),
        "y shape": (ValueError, lambda: factor.factor_gradient(A, p, torch.ones(2, 6))),
        "contiguity": (ValueError, lambda: factor.factor_forward(torch.ones(6, 3).T, p)),
        "y contiguity": (ValueError, lambda: factor.factor_gradient(A, p, torch.ones(6, 3).T)),
        "unprepared": (TypeError, lambda: factor.factor_forward(A, L)),
        "cpu": (ValueError, lambda: factor.factor_forward(A, p)),
        "cpu gradient": (ValueError, lambda: factor.factor_gradient(A, p, A)),
        "factor dtype": (TypeError, lambda: factor.prepare_factor(L.double())),
        "factor shape": (ValueError, lambda: factor.prepare_factor(torch.ones(6, 5))),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_the_wrappers_refuse_what_k3_does_not_take(case):
    error, call = _refusals()[case]
    with pytest.raises(error, match="K3"):
        call()


def _emulated_launch(a, prepared, extra, forward):
    """K3's launch on the CPU: its arithmetic (``factor_product_split``) on
    the factor the images hold, counted as a launch."""
    (hi, lo), _ = prepared.unpack()
    out = factor.factor_product_split(a, hi + lo, forward, 3,
                                      extra if forward else None, None if forward else extra)
    tracing.count(K3)
    return out


@pytest.fixture
def emulated(monkeypatch):
    """K3 engaged on the CPU, its launch the emulation; returns the count of
    K3 launches made since."""
    before = _count(K3)
    monkeypatch.setattr(factor, "_launch", _emulated_launch)
    monkeypatch.setattr(factor, "engages", lambda chol: True)
    return lambda: _count(K3) - before


def _close(got, want):
    scale = float(want.abs().max()) + 1e-30
    torch.testing.assert_close(got / scale, want / scale, rtol=0.0, atol=1e-5)


@pytest.mark.parametrize("forward", [True, False], ids=["forward", "gradient"])
def test_the_wrappers_derivatives_are_the_plain_products(emulated, forward):
    """Backward (in the batch and the epilogue's term), forward-mode and
    ``vmap`` (a batched batch, a batched epilogue term) of each wrapper
    against the plain products'; each derivative is a K3 launch."""
    L = _rect_factor(20, 15).float()  # D = 300, ragged for the tiles
    g = torch.Generator().manual_seed(0)
    A, shift, y = torch.randn(3, 300, generator=g), torch.randn(300, generator=g), \
        torch.randn(3, 300, generator=g)
    p = factor.prepare_factor(L)
    Lt = L.T.contiguous()
    extra = shift if forward else y
    wrapper = factor.factor_forward if forward else factor.factor_gradient
    ref = (lambda a, e: factor.factor_forward_reference(a, Lt, e)) if forward else \
        (lambda a, e: factor.factor_gradient_reference(a, L, e))
    W = torch.randn(3, 300, generator=torch.Generator().manual_seed(2))

    a1, e1 = A.clone().requires_grad_(), extra.clone().requires_grad_()
    a2, e2 = A.clone().requires_grad_(), extra.clone().requires_grad_()
    got = torch.autograd.grad((wrapper(a1, p, e1) * W).sum(), (a1, e1))
    want = torch.autograd.grad((ref(a2, e2) * W).sum(), (a2, e2))
    for g_, w_ in zip(got, want):
        _close(g_, w_)
    assert emulated() == 2

    ta, te = torch.randn_like(A), torch.randn_like(extra)
    _, jvp = torch.func.jvp(lambda a, e: wrapper(a, p, e), (A, extra), (ta, te))
    _, jvp_ref = torch.func.jvp(ref, (A, extra), (ta, te))
    _close(jvp, jvp_ref)

    batch = torch.stack([A, 2 * A])
    ebatch = torch.stack([extra, -extra])
    for in_dims, args in (((0, None), (batch, extra)), ((0, 0), (batch, ebatch)),
                          ((None, 0), (A, ebatch))):
        got = torch.func.vmap(lambda a, e: wrapper(a, p, e), in_dims)(*args)
        _close(got, torch.func.vmap(ref, in_dims)(*args))


def _lgcp_pair(monkeypatch, n=3):
    """The same LGCP target on the CPU twice: plain, then through the
    emulated K3."""
    plain, _, _ = lgcp.lgcp_grid(n, seed=3, device="cpu")
    monkeypatch.setattr(factor, "engages", lambda chol: True)
    kernel, _, _ = lgcp.lgcp_grid(n, seed=3, device="cpu")
    return plain, kernel


AD_PATHS = {
    "reverse": lambda t, z: t.grad(z),
    "forward_mode": lambda t, z: core_target._forward_grad(t.logdensity_fn, z),
    "tensor": lambda t, z: t.tensor(z[:2]),
    "dtensor": lambda t, z: t.dtensor(z[:1]),
    "gradient_traced": lambda t, z: torch.func.jacrev(
        lambda y: t.logdensity_and_grad(y)[1].sum(0))(z[:2]),
}


@pytest.mark.parametrize("path", list(AD_PATHS))
def test_ad_through_k3_matches_the_plain_products(monkeypatch, path):
    """With K3 engaged, an LGCP target's AD paths (autograd's gradient,
    forward-mode, the tensor by ``torch.func.hessian`` under ``vmap``, its
    derivative, the fused gradient's Jacobian) run through the kernel's
    derivative rules and meet the plain target's."""
    before = _count(K3)
    monkeypatch.setattr(factor, "_launch", _emulated_launch)
    plain, kernel = _lgcp_pair(monkeypatch)
    z = torch.randn(4, 9, generator=torch.Generator().manual_seed(1))
    want = AD_PATHS[path](plain, z)
    assert _count(K3) == before
    got = AD_PATHS[path](kernel, z)
    assert _count(K3) > before and got.shape == want.shape
    _close(got, want)


def test_a_capture_records_k3_launches_and_replays_add_them(monkeypatch):
    before = _count(K3)

    def body():  # what a captured evaluation's wrappers count: two K3 launches
        tracing.count(K3, 2)

    rec = tracing.counted(body)
    assert dict(rec) == {K3: 2} and _count(K3) == before
    tracing.recount(rec)
    tracing.recount(rec)
    assert _count(K3) == before + 4


class _Graph:
    """A stand-in CUDA graph on the CPU: the capture runs the body (its
    counts are its record, ``tracing.counted``), the replay right after it is that
    run, and every later replay runs the body with its counts taken back."""

    def __init__(self):
        self.body, self.fresh = None, False

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        tracing.counted(self.body)


class _CapturingUnits(graphs.Units):
    """``Units`` that capture on the CPU with ``_Graph``."""

    def __init__(self, device):
        super().__init__(device)
        self.capture, self.main = True, None

    def hold(self, tree):
        return graphs._clone(tree)

    def _warm(self, body):
        body()

    def _new_graph(self):
        return _Graph()

    def _record(self, graph, body):
        graph.body, graph.fresh = body, True
        body()

    def _launch(self, graph):
        graph.replay()


def _counted_target(target, outside):
    """``target`` whose log-density and log-likelihood count their calls:
    each runs one forward product outside an evaluation."""

    def counted(fn):
        def call(z):
            outside[0] += 1
            return fn(z)
        return call

    return dataclasses.replace(target, logdensity_fn=counted(target.logdensity_fn),
                               loglikelihood_fn=counted(target.loglikelihood_fn))


def _lgcp_job(target, chains, burnin, post, device):
    sampler = kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=0.5, jitter=0.9,
                     jitter_style="step", max_nleaps=16)
    return kt.MCJob(target, sampler, kt.MCRange(n_steps=burnin + post, burnin=burnin),
                    tuner=kt.DualAveragingTuner(0.8, burnin), n_chains=chains,
                    monitor=("value",), diagnostics=("accept", "nleaps"), pooled_tuning=True,
                    mass_adaptation=True, mass_period=4, traj_adaptation=True, device=device)


def _counted_lgcp_run(monkeypatch, n, chains, burnin, post, device):
    """An LGCP job's (K3 launches, evaluations, log-density calls outside
    one, K3 launches from replays)."""
    outside, replayed = [0], [0]
    recount = tracing.recount

    def replay_counts(record):  # what the replays add of K3
        replayed[0] += dict(record).get(K3, 0)
        recount(record)

    monkeypatch.setattr(tracing, "recount", replay_counts)
    target, _, _ = lgcp.lgcp_grid(n, seed=3, device=device)
    job = _lgcp_job(_counted_target(target, outside), chains, burnin, post, device)
    k3, evals = _count(K3), _count(EVALS)
    gen = torch.Generator(device=device).manual_seed(7)
    z0 = torch.randn(chains, n * n, generator=gen, device=device)
    job.run_phased(gen, z0)
    return _count(K3) - k3, _count(EVALS) - evals, outside[0], replayed[0]


def test_an_lgcp_job_counts_two_k3_launches_an_evaluation(monkeypatch):
    """With the rule engaged on the CPU (the emulated launch) and every unit
    captured by a stand-in graph:
    launches = 2 × evaluations + the log-density's calls outside them,
    replays included."""
    monkeypatch.setattr(factor, "engages", lambda chol: True)
    monkeypatch.setattr(factor, "_launch", _emulated_launch)
    monkeypatch.setattr(graphs, "STEPS_PER_BLOCK", 4)
    monkeypatch.setattr(graphs, "Units", _CapturingUnits)
    launches, evals, outside, replayed = _counted_lgcp_run(monkeypatch, 4, 8, 10, 10, "cpu")
    assert evals > 20 and outside >= 1 and replayed > 0
    assert launches == 2 * evals + outside


def test_import_needs_no_nvcc():
    """A fresh interpreter with no nvcc on PATH imports the package and runs
    an LGCP evaluation on the CPU without building anything."""
    code = (
        "import torch\n"
        "import klara_tpu_torch\n"
        "from klara_tpu_torch.models import lgcp\n"
        "from klara_tpu_torch.ops import _build\n"
        "from klara_tpu_torch.utils import tracing\n"
        "t, _, _ = lgcp.lgcp_grid(4, device='cpu')\n"
        "t.logdensity_and_grad(torch.zeros(2, 16))\n"
        "assert _build._libs == {} and 'ops.factor.KERNEL_LAUNCHES' not in tracing.counters()\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------------------ card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("K3 is a CUDA kernel and runs only on the card")


@pytest.mark.parametrize("shape", [(1024, (64, 64)), (1000, (44, 25))], ids=["4096", "1100"])
def test_card_k3_against_float64_within_twice_cublas(card, shape):
    """Each direction and epilogue off float64 by at most twice cuBLAS f32's
    own error on the same inputs (TF32 off)."""
    C, grid = shape
    L = _rect_factor(*grid).float().cuda()
    D = L.shape[0]
    prepared = factor.prepare_factor(L)
    g = torch.Generator(device="cuda").manual_seed(D)
    A = torch.randn(C, D, generator=g, device="cuda")
    shift = torch.randn(D, generator=g, device="cuda")
    y = torch.randn(C, D, generator=g, device="cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for forward, extra in ((True, None), (True, shift), (False, None), (False, y)):
            before = _count(K3)
            if forward:
                out = factor.factor_forward(A, prepared, extra)
                base = factor.factor_forward_reference(A, L.T.contiguous(), extra)
            else:
                out = factor.factor_gradient(A, prepared, extra)
                base = factor.factor_gradient_reference(A, L, extra)
            assert _count(K3) == before + 1
            ref = _reference(A, L, forward, extra if forward else None,
                             None if forward else extra)
            err, base_err = _rel_err(out, ref), _rel_err(base, ref)
            assert err <= 2 * base_err, (forward, extra is not None, err, base_err)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_card_ad_through_k3_matches_cublas(card, monkeypatch):
    """D = 2116 (a 46 × 46 grid, ragged for K3's tiles): autograd's gradient
    and the tensor of an LGCP target through K3's derivative rules against
    the same target's cuBLAS products (TF32 off)."""
    kernel, _, chol = lgcp.lgcp_grid(46, seed=3, device="cuda")
    assert factor.engages(chol)
    monkeypatch.setattr(factor, "engages", lambda chol: False)
    plain, _, _ = lgcp.lgcp_grid(46, seed=3, device="cuda")
    z = torch.randn(8, 2116, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = _count(K3)
        got = kernel.grad(z), kernel.tensor(z[:1])
        assert _count(K3) > before
        want = plain.grad(z), plain.tensor(z[:1])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for g_, w_ in zip(got, want):
        scale = float(w_.abs().max())
        assert float((g_ - w_).abs().max()) <= 1e-5 * scale


def test_card_lgcp_job_in_cuda_graphs_counts_k3(card, monkeypatch):
    """D = 2116 (a 46 × 46 grid), the units and sampling captured as CUDA
    graphs: K3 launches = 2 × evaluations + the log-density's calls outside
    them, replays included."""
    monkeypatch.setattr(graphs, "STEPS_PER_BLOCK", 4)
    launches, evals, outside, replayed = _counted_lgcp_run(monkeypatch, 46, 64, 12, 12, "cuda")
    assert evals > 24 and replayed > 0
    assert launches == 2 * evals + outside


def test_card_whitened_job_at_d100_launches_no_k3(card):
    """chees_precond's stage 2 evaluates through a D = 100 factor: cuBLAS's
    products, no K3."""
    from klara_tpu_torch.models.examples import synthetic_logistic_regression

    target, _, _ = synthetic_logistic_regression(dim=100, n_data=1024, device="cuda")
    s1 = kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=0.5, jitter=0.9,
                jitter_style="step", max_nleaps=64)
    job = kt.MCJob(target, s1, kt.MCRange(n_steps=80, burnin=40),
                   tuner=kt.DualAveragingTuner(0.8, 40), n_chains=512, monitor=("value",),
                   pooled_tuning=True, mass_adaptation=True, mass_period=20,
                   traj_adaptation=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x0 = 0.1 * torch.randn(512, 100, generator=gen, device="cuda")
    k3, evals = _count(K3), _count(EVALS)
    job.run_preconditioned(gen, x0, stage2_replace=dict(traj_adaptation=False),
                           back_transform=False)
    assert _count(EVALS) > evals
    assert _count(K3) == k3
