"""The LGCP target (``klara_tpu_torch.models.lgcp``) against the benchmark's
plain float64 reference (``portbench/reference/lgcp.py``, which imports
nothing of the port), on an 8 × 8 grid (D = 64), on the CPU:

* the grid covariance, its factor and the data recipe;
* the value and gradient at seeded random fields and counts;
* a short ``MCJob.run_phased`` job (its sampling phase in the graph units'
  eager form) against the reference's replay of 2 chains;
* the replay-aware evaluation count (``core.target.FACTOR_EVALUATIONS``): eager,
  captured and replayed evaluations total the eager loop's, with the units
  capturing on the CPU by a stand-in graph, and on the card by CUDA graphs.
"""

import math

import numpy as np
import pytest
import torch

import klara_tpu_torch as kt
from klara_tpu_torch.core import target as core_target
from klara_tpu_torch.jobs import graphs
from klara_tpu_torch.models import lgcp
from portbench.reference import lgcp as ref
from portbench.reference import philox

N = 8
D = N * N
CONFIG = {"grid": N, "sigma2": lgcp.SIGMA2, "beta": lgcp.BETA,
          "expected_points": lgcp.EXPECTED_POINTS, "data_seed": 3}
MEAN = lgcp.default_mean()
EPS32 = float(torch.finfo(torch.float32).eps)


def _field(seed, chains=16):
    """Seeded random positions z (C, D) and counts y (D,) from random rates."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((chains, D)).astype(np.float32)
    y = rng.poisson(rng.gamma(0.5, 2.0, D)).astype(np.float32)
    return torch.from_numpy(z), torch.from_numpy(y)


def test_covariance_factor_and_counts_match_the_reference():
    """Σ by the same formula in two libraries: within a few float64 ulps;
    the factors from two Cholesky codes: within float64 rounding of an
    O(1) factor (cond(Σ) ~ 1e2 here); the float32 factor the target keeps
    is the float64 one rounded; the data recipe draws the same counts."""
    sigma = torch.from_numpy(lgcp.grid_covariance(N))
    torch.testing.assert_close(sigma, ref.covariance(N, lgcp.SIGMA2, lgcp.BETA),
                               rtol=1e-14, atol=1e-15)
    L64 = ref.factor(N, lgcp.SIGMA2, lgcp.BETA)
    torch.testing.assert_close(torch.from_numpy(lgcp.grid_factor(N)), L64,
                               rtol=0, atol=1e-12)
    target, counts, L = lgcp.lgcp_grid(N, seed=CONFIG["data_seed"], device="cpu")
    assert L.dtype == torch.float32 and torch.equal(L, L64.float())
    np.testing.assert_array_equal(counts.numpy(), ref.synthetic_counts(
        N, lgcp.SIGMA2, lgcp.BETA, MEAN, CONFIG["data_seed"]))
    assert target.dim == D and torch.equal(torch.triu(L, 1), torch.zeros_like(L))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_value_and_grad_match_the_reference(seed):
    """float32 against float64 at the same float32 inputs.  Each value is
    a sum of D terms y·x, m·e^x and z²/2 whose magnitudes add to S: its f32
    rounding stays within a few D·eps·S (the products' and the sums'
    accumulations); each gradient entry, (y − m e^x)·L[:, j] − z_j over
    D terms, within a few D·eps of its terms' magnitudes."""
    z, y = _field(seed)
    L64 = ref.factor(N, lgcp.SIGMA2, lgcp.BETA)
    target = lgcp.lgcp_target(y, L64.float(), MEAN, device="cpu")
    v, g = target.logdensity_and_grad(z)
    assert v.dtype == g.dtype == torch.float32
    z64, y64 = z.double(), y.double()
    rv, rg = ref.value_grad(z64, y64, L64.float().double(), MEAN)
    x = MEAN + z64 @ L64.T
    size = ((y64 * x).abs() + torch.exp(x) / D + 0.5 * z64 * z64).sum(-1)
    assert ((v.double() - rv).abs() <= 4 * D * EPS32 * size).all()
    gsize = (y64 + torch.exp(x) / D).abs() @ L64.abs() + z64.abs()
    assert ((g.double() - rg).abs() <= 4 * D * EPS32 * gsize).all()
    # the unfused accessors agree with the fused evaluation
    torch.testing.assert_close(target.logdensity(z), v, rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(target.logprior(z), -0.5 * (z * z).sum(-1))


def _job(burnin, post, chains=8, step_size=None):
    target, _, _ = lgcp.lgcp_grid(N, seed=CONFIG["data_seed"], device="cpu")
    sampler = kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=0.8, jitter=0.9,
                     jitter_style="step", max_nleaps=32)
    return kt.MCJob(target, sampler, kt.MCRange(n_steps=burnin + post, burnin=burnin),
                    tuner=kt.DualAveragingTuner(0.8, burnin), n_chains=chains,
                    monitor=("value",), diagnostics=("accept", "nleaps"), pooled_tuning=True,
                    mass_adaptation=True, mass_period=4, traj_adaptation=burnin > 0,
                    step_size=step_size, device="cpu")


def test_short_job_matches_the_reference_replay_of_two_chains():
    """30 sampling steps (the graph units' eager form) from prior draws at
    ε = 0.15 and λ = 0.8 under the shared jitter, replayed for 2 chains in
    float64 from the job's run key: the same leap counts and decisions, and
    positions within f32 rounding grown over 30 steps (|Δ| / max(|x|, 1)
    under 1e-4; the replay reads ~1e-6)."""
    job = _job(0, 30, step_size=0.15)
    gen = torch.Generator().manual_seed(5)
    z0 = torch.randn(8, D, generator=gen)
    key = philox.run_key(torch.Generator().manual_seed(5), "cpu")  # the job's one draw
    chain, _ = job.run_phased(torch.Generator().manual_seed(5), z0)
    eps = chain.final_state.tune.step
    chains = torch.tensor([0, 5])
    T = 30
    replay = {
        "key": key, "chains": chains, "steps": torch.arange(T), "start": z0[chains],
        "jitter": 0.9, "max_nleaps": 32,
        "eps": eps[chains][None].expand(T, 2), "log_traj": torch.full((T, 2), math.log(0.8)),
        "inv_mass": torch.ones(T, 2, D), "nleaps": chain["nleaps"][:, chains].long(),
        "accept": chain["accept"][:, chains],
        "accept_stat": torch.full((T, 2), float("nan"), dtype=torch.float64),
        "trace": chain.value[:, chains].double(), "trace_unit": "relative",
    }
    prob = ref.Problem(CONFIG, "cpu")
    gap, _, wrong = ref.hmc_path([replay], prob, 5e-3, 1e-5)
    assert wrong == 0 and gap < 1e-4, (gap, wrong)
    assert chain["accept"].float().mean() > 0.3 and (chain["nleaps"] >= 1).all()


class _Graph:
    """A stand-in CUDA graph on the CPU: the capture runs the body (its
    counts taken back by ``launches_of``), the replay right after it is that
    run, and every later replay runs the body with its counts taken back."""

    def __init__(self):
        self.body, self.fresh = None, False

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        graphs.launches_of(self.body)


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


def _counted_run(job, seed):
    before, replays = core_target.FACTOR_EVALUATIONS, graphs.GRAPH_REPLAYS
    z0 = torch.randn(job.n_chains, D, generator=torch.Generator().manual_seed(seed))
    chain, _ = job.run_phased(torch.Generator().manual_seed(seed), z0)
    return chain, core_target.FACTOR_EVALUATIONS - before, graphs.GRAPH_REPLAYS - replays


def test_replayed_evaluations_total_the_eager_loops(monkeypatch):
    """Warmup (``graphs.warm``) and sampling (``graphs.sample``) with every
    unit captured and replayed count the eager loop's evaluations, and end
    in its state bit for bit."""
    monkeypatch.setattr(graphs, "STEPS_PER_BLOCK", 4)
    with monkeypatch.context() as mp:
        mp.setattr(graphs, "Units", _CapturingUnits)
        graph, n_graph, replays = _counted_run(_job(8, 10), 9)
    monkeypatch.setattr(graphs, "sampling_kind", lambda job: None)
    eager, n_eager, eager_replays = _counted_run(_job(8, 10), 9)
    assert replays > 20 and eager_replays == 0
    assert n_graph == n_eager > 18
    assert torch.equal(graph.value, eager.value)
    assert torch.equal(graph.final_state.position, eager.final_state.position)


def test_a_capture_records_its_evaluations_and_takes_them_back(monkeypatch):
    monkeypatch.setattr(core_target, "FACTOR_EVALUATIONS", 0)
    target, _, _ = lgcp.lgcp_grid(N, device="cpu")
    z = torch.zeros(4, D)
    rec = graphs.launches_of(lambda: (target.logdensity_and_grad(z),
                                      target.logdensity_and_grad(z)))
    assert rec.evals == 2 and core_target.FACTOR_EVALUATIONS == 0
    graphs.add_launches(rec)
    graphs.add_launches(rec)
    assert core_target.FACTOR_EVALUATIONS == 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graph capture needs a card; the CPU cases above use a stand-in")


def test_cuda_graph_evaluations_total_the_eager_loops(card, monkeypatch):
    """On the card: warmup and sampling units captured as CUDA graphs count
    the eager loop's evaluations and end in its state bit for bit."""
    monkeypatch.setattr(graphs, "STEPS_PER_BLOCK", 4)

    def job():
        j = _job(8, 10)
        target, _, _ = lgcp.lgcp_grid(N, seed=CONFIG["data_seed"], device="cuda")
        j.target, j.device = target, "cuda"
        return j

    def run():
        before = core_target.FACTOR_EVALUATIONS
        z0 = torch.randn(8, D, generator=torch.Generator().manual_seed(9)).cuda()
        chain, _ = job().run_phased(torch.Generator(device="cuda").manual_seed(9), z0)
        return chain, core_target.FACTOR_EVALUATIONS - before

    graph, n_graph = run()
    monkeypatch.setattr(graphs, "sampling_kind", lambda job: None)
    eager, n_eager = run()
    assert n_graph == n_eager
    assert torch.equal(graph.value, eager.value)


def test_every_evaluation_through_a_factor_counts_once(monkeypatch):
    """The LGCP's and a whitened target's evaluations go through one helper
    (``core.target.through_factor``): each counts once in its counter, with
    its host time in the tracer's timed counter ``factor.host_ns``."""
    from klara_tpu_torch.utils import tracing

    monkeypatch.setattr(core_target, "FACTOR_EVALUATIONS", 0)
    target, _, L = lgcp.lgcp_grid(N, device="cpu")
    white = core_target.whiten_target(kt.models.normal_target(D), L)
    calls = tracing.counters().get("factor.host_ns", (0, 0))[0]
    target.logdensity_and_grad(torch.zeros(2, D))
    white.logdensity_and_grad(torch.zeros(2, D))
    assert core_target.FACTOR_EVALUATIONS == 2
    assert tracing.counters()["factor.host_ns"][0] == calls + 2
