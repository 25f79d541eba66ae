"""MCJob: the simulation driver, batch-first (counterpart of klara_tpu/jobs/job.py).

The JAX driver vmaps a per-chain step kernel over a chains axis and scans it
over steps inside one compiled program.  Here the sampler's step is already
batched and the scan is a Python loop; per-step gating (burnin, saving,
adaptation periods) is plain Python on the step index, so it costs no
device synchronisation.  The one host read per MCMC step is the leapfrog
trip count (``samplers.hamiltonian.leapfrog``).

The three adaptation hooks (pooled tuning, ensemble mass, ChEES trajectory
length) are module-level functions of the post-kernel states, the step's
infos, the step index and the shared jitter fraction, applied in that order
by ``MCJob.adapt``.

A univariate target (a (C,) position per step) is lifted to dim 1, so the
vector-only samplers (AM, RAM, AMWG, slice, SMMALA) run it too, and the
traces are squeezed back to scalars on output.

Output goes to device trace buffers (``destination='nstate'``), to per-field
CSV files while the run goes on (``'csv'``: saved draws gather in a ring of
``stream_chunk`` rows on the device, and each chunk that saved a draw
reaches the host in one copy per field and one host read), or nowhere
(``'none'``).  With ``verbose`` the loop prints the pooled acceptance rate
every ``progress_period`` steps, the only host read it adds.

Every draw of a run is keyed, as the JAX package's per-chain keys are
(``chain_keys = split(run_key, n_chains)``, folded with the step): the job
draws one run key from the generator per ``run``, ``resume`` or
``run_phased`` (``ops.keyed.run_key``) and hands the sampler the run's
``KeyedStream`` at step i; the sampler draws at the sites of its window
(``ops.keyed``'s table: kernel K2 on the card).  The init draws (a start
from the prior, the step-size search's momentum) are at step 0 on sites of
their own, and the shared jitter is one uniform of global chain 0, the
same on every rank.  A run whose draws were made on the card reads K2's
overflow counter once at its end (``ops.keyed.raise_on_overflow``).

With ``mesh`` (a ``DeviceMesh`` from ``klara_tpu_torch.parallel``) the
chains split over the mesh dimension ``chains_axis``: ``n_chains`` stays the
global count, each rank runs its own contiguous block of chains, and the
run's cross-chain reductions (pooled tuning, ensemble mass, ChEES, the
ensemble covariance, the pooled initial step) all-reduce over that
dimension's group.  A keyed draw names a chain by its global index, so a
rank draws exactly its own chains and a chain's draws do not depend on the
number of ranks; every rank must be handed a generator seeded alike, since
the run key comes from it (checked once per run).  A csv run gathers each
chunk of its ring to the chains group's first rank, and the mesh's first
rank alone writes (``parallel.mesh.gather_to_first``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.core.target import Target, whiten_target
from klara_tpu_torch.io.stream import DrawRing, StreamingWriter
from klara_tpu_torch.jobs import graphs
from klara_tpu_torch.jobs.chain import Chain
from klara_tpu_torch.jobs.gibbs import _as_tensor
from klara_tpu_torch.jobs.range import MCRange
from klara_tpu_torch.ops.keyed import (
    INIT_PRIOR,
    JOB_SITES,
    MH_SITE,
    SHARED_JITTER,
    KeyedStream,
    raise_on_overflow,
    run_key,
)
from klara_tpu_torch.parallel.mesh import (
    active_block,
    chain_block,
    chain_context,
    check_generators,
    gather_chains,
    gather_to_first,
    mean_over_chains,
    sum_over_ranks,
    take_block,
    var_over_chains,
    writes_output,
)
from klara_tpu_torch.samplers.base import Info, Sampler, draw_uniform
from klara_tpu_torch.samplers.hmc import jitter_fraction
from klara_tpu_torch.tuners.tuners import DualAveragingTuner, Tuner
from klara_tpu_torch.utils import tracing


# the 13 monitored slots: {log, gradlog, tensorlog, dtensorlog} ×
# {likelihood, prior, target} + value; these read a Target accessor
_TARGET_FIELDS = {
    "loglikelihood": "loglikelihood",
    "logprior": "logprior",
    "gradloglikelihood": "grad_loglikelihood",
    "gradlogprior": "grad_logprior",
    "tensorlogtarget": "tensor",
    "tensorloglikelihood": "tensor_loglikelihood",
    "tensorlogprior": "tensor_logprior",
    "dtensorlogtarget": "dtensor",
    "dtensorloglikelihood": "dtensor_loglikelihood",
    "dtensorlogprior": "dtensor_logprior",
}


def _field_value(name: str, state, info: Info, target: Target):
    if name == "value":
        return state.position
    if name == "logtarget":
        return info.logtarget
    if name == "gradlogtarget":
        if hasattr(state, "gradlogtarget"):
            return state.gradlogtarget
        return target.grad(state.position)
    if name in _TARGET_FIELDS:
        return getattr(target, _TARGET_FIELDS[name])(state.position)
    raise ValueError(f"unknown monitored field {name!r}")


def _diag_value(name: str, state, info: Info):
    if name == "accept":
        return info.accept
    if name == "accept_stat":
        return info.accept_stat
    if name in info.extras:
        return info.extras[name]
    if name in getattr(state, "_fields", ()):
        val = getattr(state, name)
        if isinstance(val, torch.Tensor):
            return val
    raise ValueError(f"unknown diagnostic {name!r}")


# ---------------------------------------------------------- adaptation hooks
def tune_update(tuner: Tuner, states, infos: Info, stat_name: str, pooled: bool,
                burnin: int):
    """Tuner update from this step's acceptance; with ``pooled`` every chain
    gets the cross-chain mean."""
    accept = infos.accept.to(torch.float32)
    stat = infos.accept_stat if stat_name == "accept_stat" else accept
    if pooled:
        accept = mean_over_chains(accept).expand(accept.shape)
        stat = mean_over_chains(stat.to(torch.float32)).expand(stat.shape)
    return states._replace(tune=tuner.update(states.tune, accept, stat, burnin))


def mass_update(states, i: int, burnin: int, mass_period: int):
    """Every ``mass_period`` burnin steps, set the diagonal inverse mass to
    the regularised ensemble variance, Stan's
    Σ = n/(n+5)·var + 5/(n+5)·1e-3 with n the number of chains."""
    if not ((i + 1) % mass_period == 0 and i + 1 >= mass_period and i < burnin):
        return states
    block = active_block()
    n_c = states.position.shape[0] if block is None else block.total
    var = var_over_chains(states.position)[None]
    w = n_c / (n_c + 5.0)
    new_inv_mass = (w * var + (1.0 - w) * 1e-3 + 1e-7).expand(states.inv_mass.shape)
    return states._replace(inv_mass=new_inv_mass)


def _f32(x, like):
    # a host scalar copied to the card: the copy waits for the device's queue
    with tracing.timed("host_read.chees_scalars"):
        return torch.tensor(x, dtype=torch.float32, device=like.device)


def chees_update(states, prev_pos, infos: Info, i: int, frac_shared, burnin: int,
                 traj_lr: float, traj_start_frac: float,
                 max_nleaps: Optional[int] = None, jitter: float = 0.0):
    """ChEES trajectory-length adaptation (Hoffman, Radul & Sountsov 2021):
    one pooled Adam ascent step on log λ from the ensemble's phase-space
    endpoints, distances whitened by the inverse mass, λ capped at what
    ``max_nleaps`` can execute."""
    traj_start = int(burnin * traj_start_frac)
    if not traj_start <= i < burnin:
        return states
    x_prop = infos.extras["x_prop"]
    p_end = infos.extras["p_end"]
    frac = infos.extras["traj_frac"].to(torch.float32) * frac_shared
    a = infos.accept_stat.to(torch.float32)
    inv_w = 1.0 / states.inv_mass
    xbar = mean_over_chains(prev_pos)
    xpbar = mean_over_chains(x_prop)
    dold = (inv_w * torch.square(prev_pos - xbar)).sum(-1)
    dnew = (inv_w * torch.square(x_prop - xpbar)).sum(-1)
    proj = ((x_prop - xpbar) * p_end).sum(-1)
    w = a / torch.clamp_min(mean_over_chains(a), 1e-3)
    g = mean_over_chains(w * (dnew - dold) * proj * frac)
    g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    b1, b2 = _f32(0.9, g), _f32(0.999, g)
    t = _f32(i + 1, g)
    m = b1 * states.traj_m.mean() + (1.0 - b1) * g
    v = b2 * states.traj_v.mean() + (1.0 - b2) * g * g
    mhat = m / (1.0 - torch.pow(b1, t))
    vhat = v / (1.0 - torch.pow(b2, t))
    lt_new = states.log_traj.mean() + traj_lr * mhat / (torch.sqrt(vhat) + 1e-8)
    lt_new = torch.clamp(lt_new, torch.log(_f32(1e-2, g)), torch.log(_f32(1e3, g)))
    if max_nleaps is not None:
        eps_now = states.tune.step.mean()
        cap = torch.log(eps_now * max_nleaps / (1.0 + jitter))
        lt_new = torch.minimum(lt_new, cap.to(lt_new.dtype))

    def bc(x, like):
        return x.to(like.dtype).expand(like.shape)

    return states._replace(
        log_traj=bc(lt_new, states.log_traj),
        traj_m=bc(m, states.traj_m),
        traj_v=bc(v, states.traj_v),
    )


def _sync(device):
    if device.type == "cuda":
        with tracing.timed("host_read.sync"):
            torch.cuda.synchronize(device)


@dataclasses.dataclass
class MCJob:
    """Single-parameter MCMC job over a batch of chains.

    target, sampler, mcrange, tuner (None -> sampler.default_tuner()),
    n_chains, monitor (saved fields), diagnostics (saved per-draw
    diagnostics), pooled_tuning (adapt from cross-chain pooled statistics),
    step_size (initial step override), mass_adaptation / mass_period
    (ensemble diagonal mass), traj_adaptation / traj_lr / traj_start_frac
    (ChEES), trace_dtype (storage dtype of floating sample traces, e.g.
    'bfloat16'), device (None -> the device of x0 if it is a tensor, else
    the card; where there is none, an error that names ``device="cpu"``),
    mesh / chains_axis (split the chains over that mesh dimension; the
    states, traces and ``Chain`` hold this rank's block).

    Output: destination ('nstate' device traces, 'csv' files under
    ``filepath``, 'none' the final state alone), flush (flush the files
    after every write), stream_chunk (steps per host copy of a csv run),
    stream_mode ('io_callback' streams during the run; 'post' keeps the
    device traces and appends them to the files after the run, returning
    them too), verbose / progress_period (print the pooled acceptance rate
    every ``progress_period`` steps)."""

    target: Target
    sampler: Sampler
    mcrange: MCRange = dataclasses.field(default_factory=MCRange)
    tuner: Optional[Tuner] = None
    n_chains: int = 1
    monitor: Sequence[str] = ("value", "logtarget")
    diagnostics: Sequence[str] = ("accept",)
    pooled_tuning: bool = False
    step_size: Optional[float] = None
    destination: str = "nstate"
    filepath: Optional[str] = None
    flush: bool = False
    stream_chunk: int = 128
    stream_mode: str = "io_callback"
    verbose: bool = False
    progress_period: int = 100
    mass_adaptation: bool = False
    mass_period: int = 100
    traj_adaptation: bool = False
    traj_lr: float = 0.1
    traj_start_frac: float = 0.1
    trace_dtype: Optional[str] = None
    device: Any = None
    mesh: Any = None
    chains_axis: str = "chains"

    def __post_init__(self):
        if self.tuner is None:
            self.tuner = self.sampler.default_tuner()
        self.sampler = self.sampler.bind_tuner(self.tuner)
        if self.traj_adaptation:
            if not hasattr(self.sampler, "dynamic_nleaps"):
                raise ValueError(
                    "traj_adaptation requires an HMC-family sampler whose "
                    "trajectory length is dynamic (state carries log_traj)"
                )
            if not self.sampler.dynamic_nleaps:
                self.sampler = dataclasses.replace(self.sampler, dynamic_nleaps=True)
        if self.destination not in ("nstate", "csv", "none"):
            raise ValueError(f"unknown destination {self.destination!r}")
        if self.destination == "csv" and not self.filepath:
            raise ValueError("destination='csv' requires filepath")
        if self.stream_mode not in ("io_callback", "post"):
            raise ValueError(f"unknown stream_mode {self.stream_mode!r}")
        self._block = chain_block(self.mesh, self.chains_axis, self.n_chains)
        if self.trace_dtype is not None:
            dt = getattr(torch, str(self.trace_dtype), None)
            if not isinstance(dt, torch.dtype):
                raise ValueError(f"unknown trace_dtype {self.trace_dtype!r}")
        self._lifted = False
        self._writer = None
        self._ring = None

    # ------------------------------------------------------------- from model
    @classmethod
    def from_model(cls, model, sampler, mcrange, v0: dict, pkey: Optional[str] = None,
                   **kwargs):
        """A single-parameter job from a model graph and initial values: the
        target is parameter ``pkey``'s conditional log-density given the
        other (fixed) values of ``v0``.  Returns (job, x0)."""
        params = model.parameters
        if pkey is None:
            if len(params) != 1:
                raise ValueError(
                    "model has multiple parameters; pass pkey to choose one "
                    "(or use GibbsJob)"
                )
            pkey = params[0].key
        param = model[pkey]
        device = resolve_device(kwargs.get("device"), v0.values())
        values = {k: _as_tensor(v, device).to(device) for k, v in v0.items()}
        consts = {k: v for k, v in values.items() if k != pkey}
        target = Target(
            logdensity_fn=lambda x: param.conditional_logdensity(x, consts), name=pkey
        )
        return cls(target, sampler, mcrange, **kwargs), values[pkey]

    # ------------------------------------------------------------------ init
    def _run_device(self, generator, x0) -> torch.device:
        """The run's device: ``device``, else x0's, else (a start from the
        prior) the generator's, else the card (``resolve_device``)."""
        if self.device is None and x0 is None and generator is not None:
            return generator.device
        return resolve_device(self.device, (x0,))

    def _run_stream(self, generator, device) -> KeyedStream:
        """The run's keyed stream: a run key drawn from ``generator`` (one
        draw) on ``device``, over this rank's chains named by their global
        indices, at step 0 in MCJob's window."""
        block = self._block
        return KeyedStream(run_key(generator, device),
                           self.n_chains if block is None else block.local,
                           0 if block is None else block.offset)

    def _prepare_x0(self, stream, x0):
        """The initial positions as (n_chains, ...): drawn from the prior
        when ``x0`` is None, at ``stream``'s ``INIT_PRIOR`` site (only the
        stream's chains: on a mesh the rank's block); one position is shared
        by every chain.  Scalar positions (a 0-d ``x0``, per-chain scalars
        (n_chains,) with ``target.dim == 1``, 1-d prior draws) lift the
        target to dim 1."""
        from_prior = x0 is None
        if from_prior:
            x0 = self.target.sample_prior(stream.window_site(INIT_PRIOR), stream.chains)
        x0 = torch.as_tensor(x0).to(resolve_device(self.device, (x0,)))
        per_chain_1d = x0.dim() == 1 and self.n_chains > 1 and x0.shape[0] == self.n_chains
        if x0.dim() == 0 or (from_prior and x0.dim() == 1) or (
            per_chain_1d and self.target.dim == 1
        ):
            self._lift_target()
            x0 = x0[..., None]
        elif per_chain_1d and self.target.dim is None:
            raise ValueError(
                f"ambiguous initial value: x0 has shape {tuple(x0.shape)} with "
                f"n_chains={self.n_chains} and target.dim unset — cannot tell "
                "one (D,)-vector position shared by all chains from per-chain "
                "scalar positions. Set Target(dim=...) or pass x0 shaped "
                "(n_chains, dim)."
            )
        if not from_prior and (x0.dim() == 1 or x0.shape[0] != self.n_chains):
            x0 = x0.expand((self.n_chains,) + tuple(x0.shape))
        return x0.contiguous()

    def _lift_target(self):
        """Wrap every function of the target to take (C, 1) positions where
        the user's take (C,)."""
        if self._lifted:
            return
        orig = self.target

        def wrap(f, shape=()):
            if f is None:
                return None
            return lambda x: f(x[:, 0]).reshape((-1,) + shape)

        def wrap_vg(f):
            if f is None:
                return None

            def vg(x):
                v, g = f(x[:, 0])
                return v, g.reshape(-1, 1)

            return vg

        self.target = dataclasses.replace(
            orig,
            logdensity_fn=wrap(orig.logdensity_fn),
            loglikelihood_fn=wrap(orig.loglikelihood_fn),
            logprior_fn=wrap(orig.logprior_fn),
            grad_fn=wrap(orig.grad_fn, (1,)),
            value_and_grad_fn=wrap_vg(orig.value_and_grad_fn),
            tensor_fn=wrap(orig.tensor_fn, (1, 1)),
            dtensor_fn=wrap(orig.dtensor_fn, (1, 1, 1)),
            dim=1,
        )
        self._lifted = True

    def _squeeze(self, chain: Chain) -> Chain:
        """Drop the lifted trailing axis from the traces, so a scalar target
        yields scalar draw series (the final state stays lifted)."""
        if not self._lifted:
            return chain

        def sq(d):
            return {k: (v[..., 0] if (v.dim() >= 3 and v.shape[-1] == 1) else v)
                    for k, v in d.items()}

        return dataclasses.replace(chain, samples=sq(chain.samples),
                                   diagnostics=sq(chain.diagnostics))

    def _checkin(self, x0):
        """The initial value must lie inside the target's support."""
        lt0 = self.target.logdensity(x0[:1])
        with tracing.timed("host_read.checkin"):
            finite = bool(torch.isfinite(lt0).all())
        if not finite:
            raise ValueError(
                f"log-target not finite at the initial value "
                f"(logdensity={float(lt0[0])}): initial value out of support"
            )

    def _init_states(self, stream, x0, momentum=None):
        # only the Hamiltonian samplers' init takes a momentum
        kw = {} if momentum is None else {"momentum": momentum}
        states = self.sampler.init(
            self.target, x0, None, step_size=self.step_size, tuner=self.tuner, stream=stream,
            **kw
        )
        if self.pooled_tuning and hasattr(states, "tune") and not self.sampler.self_tuning:
            # one shared step: geometric mean of the per-chain searches, μ
            # re-anchored to it
            tune = states.tune
            pooled = torch.exp(mean_over_chains(torch.log(tune.step)))
            tune = tune._replace(step=pooled.expand(tune.step.shape).to(tune.step.dtype))
            if isinstance(self.tuner, DualAveragingTuner):
                tune = self.tuner.set_mu_from_step(tune)
            states = states._replace(tune=tune)
        return states

    # ------------------------------------------------------------------ step
    def adapt(self, prev_pos, states, infos: Info, i: int, frac_shared=1.0):
        """The adaptation hooks for step ``i``, applied to the post-kernel
        states (pre-step positions ``prev_pos``)."""
        sampler, burnin = self.sampler, self.mcrange.burnin
        if not sampler.self_tuning:
            with tracing.timed("adapt.tune"):
                states = tune_update(
                    self.tuner, states, infos, sampler.tuner_statistic,
                    self.pooled_tuning, burnin,
                )
        if self.mass_adaptation and hasattr(states, "inv_mass"):
            with tracing.timed("adapt.mass"):
                states = mass_update(states, i, burnin, self.mass_period)
        if self.traj_adaptation and hasattr(states, "log_traj"):
            with tracing.timed("adapt.chees"):
                states = chees_update(
                    states, prev_pos, infos, i, frac_shared, burnin, self.traj_lr,
                    self.traj_start_frac, getattr(sampler, "max_nleaps", None),
                    getattr(sampler, "jitter", 0.0),
                )
        return states

    def _shared_jitter(self) -> bool:
        s = self.sampler
        return (
            getattr(s, "jitter", 0.0) > 0.0
            and getattr(s, "jitter_style", "chain") == "step"
            and getattr(s, "dynamic_nleaps", False)
        )

    def _step_sampler(self):
        """The sampler a step runs: under shared jitter with its own jitter
        off, since the job scales every chain's λ (``_under_jitter``)."""
        return dataclasses.replace(self.sampler, jitter=0.0) if self._shared_jitter() \
            else self.sampler

    def _shared_fraction(self, at, like):
        """The shared jitter fraction of the step ``at`` points at: global
        chain 0's draw at ``SHARED_JITTER``, the same on every rank with no
        collective, mapped to U(1 − jitter, 1 + jitter)."""
        u = draw_uniform(at.at(chains=1, offset=0), SHARED_JITTER, (1,), like)[0]
        return jitter_fraction(u, self.sampler.jitter)

    @staticmethod
    def _under_jitter(states, frac, step):
        """``step(states)`` -> (states, out) with every chain's λ scaled by
        the shared fraction ``frac`` (None: not scaled): a log_traj offset
        that the step reads and that is taken back after it."""
        if frac is None:
            return step(states)
        lt = states.log_traj
        states, out = step(states._replace(log_traj=lt + torch.log(frac)))
        return states._replace(log_traj=lt), out

    def _loop(self, states, stream, start, stop, adapt, buffers=None, ring=None):
        """Steps [start, stop), step i drawing from ``stream`` at step i.
        Saved draws go to ``buffers`` (device traces) and ``ring`` (a csv
        stream, handed to the writer after every chunk of ``ring.rows``
        steps and at ``stop``).  With shared ('step') jitter one draw per
        step, the same on every rank, scales every chain's λ through a
        temporary log_traj offset, so all chains run the same leap count."""
        target = self.target
        burnin, thinning = self.mcrange.burnin, self.mcrange.thinning
        shared = self._shared_jitter()
        step_sampler = self._step_sampler()
        self._check_sites(states)
        for i in range(start, stop):
            with tracing.span("step"):
                prev_pos = states.position
                at = stream.at(step=i)
                frac = self._shared_fraction(at, states.log_traj) if shared else None
                states, infos = self._under_jitter(
                    states, frac, lambda st: step_sampler.step(st, target, stream=at))
                if adapt:
                    states = self.adapt(prev_pos, states, infos, i,
                                        1.0 if frac is None else frac)
                if i >= burnin and (i - burnin) % thinning == 0:
                    if buffers is not None:
                        self._write(buffers, (i - burnin) // thinning, states, infos)
                    if ring is not None:
                        ring.save(self._fields(states, infos))
                if ring is not None and ((i + 1 - start) % ring.rows == 0 or i + 1 == stop):
                    self._flush_ring(ring)
                if self.verbose and (i + 1) % self.progress_period == 0:
                    self._report(i, infos)
        return states

    def _check_sites(self, states):
        if self.sampler.keyed_sites(states.position) > MH_SITE + 1 - JOB_SITES:
            raise ValueError(f"{type(self.sampler).__name__} draws at more sites a step than "
                             f"MCJob's window holds ({MH_SITE + 1 - JOB_SITES})")

    def _sample(self, states, stream, start, stop, buffers):
        """The sampling phase's steps [start, stop), without adaptation: in
        captured blocks where ``jobs.graphs`` takes the sampler (the static
        NUTS tree, HMC), else in the eager loop; bit for bit either way."""
        if graphs.sampling_kind(self) is None:
            return self._loop(states, stream, start, stop, False, buffers)
        return graphs.sample(self, states, stream, start, stop, buffers)

    def _report(self, i: int, infos: Info):
        """The progress line of step ``i``: the pooled acceptance rate, read
        from the device."""
        rate = float(mean_over_chains(infos.accept.to(torch.float32)))
        phase = "burnin " if i < self.mcrange.burnin else "sampling"
        print(f"[{self.target.name}] {phase} iteration {i + 1}: "
              f"{100 * rate:.2f} % acceptance rate")

    def _fields(self, states, infos):
        """{field: (C, ...) value} of the monitored fields, then the
        diagnostics: one row of a csv stream."""
        out = {n: _field_value(n, states, infos, self.target) for n in self.monitor}
        out.update({n: _diag_value(n, states, infos) for n in self.diagnostics})
        return out

    def _saved(self, states, infos):
        """One saved draw: ((group, name), value, trace dtype) of each
        monitored field (group 0) and diagnostic (group 1); floating
        monitored fields are stored in ``trace_dtype``."""
        tdt = getattr(torch, self.trace_dtype) if self.trace_dtype else None
        out = []
        for group, names, fn, cast in (
            (0, self.monitor, lambda n: _field_value(n, states, infos, self.target), True),
            (1, self.diagnostics, lambda n: _diag_value(n, states, infos), False),
        ):
            for name in names:
                val = fn(name)
                dt = tdt if cast and tdt is not None and val.is_floating_point() else val.dtype
                out.append(((group, name), val, dt))
        return out

    def _write(self, buffers, idx, states, infos):
        n_post = self.mcrange.n_post
        for (g, name), val, dt in self._saved(states, infos):
            group = buffers[g]
            if name not in group:
                # every slot is written exactly once by the end of the run
                group[name] = torch.empty((n_post,) + tuple(val.shape), dtype=dt,
                                          device=val.device)
            group[name][idx] = val

    # ------------------------------------------------------------------- run
    def run(self, generator=None, x0=None) -> Chain:
        """Run all ``mcrange.n_steps`` steps, adapting during burnin and
        saving the post-burnin draws to ``destination``."""
        with tracing.job("MCJob.run"), tracing.Phases() as phases:
            check_generators(generator, self.mesh)
            stream = self._run_stream(generator, self._run_device(generator, x0))
            x0 = self._start(stream, x0)
            self._open_writer()
            with chain_context(self._block):
                phases.enter("init")
                states = self._init_states(stream, x0)
                phases.enter("steps", self.mcrange.n_steps)
                return self._drive(states, stream)

    def resume(self, generator, chain: Chain) -> Chain:
        """Another ``mcrange.n_steps`` steps from ``chain.final_state`` (a live
        state or one from ``io.load_checkpoint``), burnin and adaptation
        included, as ``run`` from that state, on a run key of its own; a csv
        run appends its draws to the files.  On a mesh the state may hold
        the global chains (a reloaded checkpoint: this rank takes its block)
        or this rank's."""
        with tracing.job("MCJob.resume"), tracing.Phases() as phases:
            check_generators(generator, self.mesh)
            states = take_block(chain.final_state, self._block)
            stream = self._run_stream(generator, states.position.device)
            self._open_writer()
            with chain_context(self._block):
                phases.enter("steps", self.mcrange.n_steps)
                return self._drive(states, stream)

    def _start(self, stream, x0):
        """This rank's initial positions: ``x0`` prepared (``_prepare_x0``;
        given, for the global chains), checked, then cut to the rank's
        block."""
        x0 = self._prepare_x0(stream, x0)
        self._checkin(x0)
        return take_block(x0, self._block)

    def _chain(self, buffers, states) -> Chain:
        return Chain(samples=buffers[0], diagnostics=buffers[1], final_state=states,
                     mesh=self.mesh, chains_axis=self.chains_axis)

    def _drive(self, states, stream) -> Chain:
        buffers = ({}, {})
        keep = self.destination == "nstate" or self._buffered_csv
        states = self._loop(states, stream, 0, self.mcrange.n_steps, True,
                            buffers if keep else None, self._ring)
        raise_on_overflow()
        return self._squeeze(self._finish_output(self._chain(buffers, states)))

    @property
    def _buffered_csv(self) -> bool:
        return self.destination == "csv" and self.stream_mode == "post"

    def _open_writer(self):
        """The csv stream's ring and (on the rank that writes) its writer,
        kept across ``run`` and ``resume`` (files reopen in append mode)."""
        if self.destination == "csv" and self.stream_mode == "io_callback" and self._ring is None:
            self._ring = DrawRing(max(1, min(self.stream_chunk, self.mcrange.n_steps)))
            if writes_output(self.mesh):
                self._writer = StreamingWriter(self.filepath, flush=self.flush,
                                               sample_fields=set(self.monitor))

    def _flush_ring(self, ring):
        """The ring's chunk to the files: on a split mesh gathered to the
        first rank of the chains group, and written by the mesh's first."""
        count, host = ring.take(self._block)
        if self._writer is not None:
            self._writer.append_block(count, host)

    def _finish_output(self, chain: Chain) -> Chain:
        """Close the stream's files (manifest and sidecars with the final row
        counts), or with ``stream_mode='post'`` append the device traces to
        them (on a split mesh gathered to the chains group's first rank)."""
        if self._writer is not None:
            self._writer.close()
        elif self._buffered_csv:
            fields = {**chain.samples, **chain.diagnostics}
            if self._block is not None and self._block.split:
                fields = {k: gather_to_first(v, self._block, dim=1) for k, v in fields.items()}
            if writes_output(self.mesh):
                with StreamingWriter(self.filepath, sample_fields=set(self.monitor)) as w:
                    w.append_block(self.mcrange.n_post, fields)
        return chain

    def run_phased(self, generator=None, x0=None):
        """Warmup (init + burnin steps with adaptation, then the tuner's
        finalize) and sampling (no adaptation code) timed apart.  HMC's
        warmup transitions replay captured units (``graphs.warm``, the hooks
        eager between steps), and its and static NUTS's sampling captured
        blocks (``graphs.sample``), bit for bit the eager loop.  Returns
        ``(chain, {'warmup_seconds', 'sampling_seconds'})``; on a CUDA device
        each phase ends in a synchronise.  Output to 'nstate' or 'none' only:
        ``run`` streams csv.  The timings are the clock reads of the job
        report's phases (``utils.tracing``): ``init`` (the sampler's init,
        the step-size search among it) and ``warmup`` make up
        ``warmup_seconds``, ``sampling`` is ``sampling_seconds``."""
        if self.destination == "csv":
            raise ValueError("run_phased supports destination 'nstate'/'none' only")
        with tracing.job("MCJob.run_phased"), tracing.Phases() as phases:
            check_generators(generator, self.mesh)
            stream = self._run_stream(generator, self._run_device(generator, x0))
            x0 = self._start(stream, x0)
            device = x0.device
            _sync(device)
            t0 = phases.enter("init")
            with chain_context(self._block):
                states = self._init_states(stream, x0)
                burnin = self.mcrange.burnin
                phases.enter("warmup", burnin)
                if burnin > 0:
                    if graphs.sampling_kind(self) == "leaps":
                        states = graphs.warm(self, states, stream, 0, burnin)
                    else:
                        states = self._loop(states, stream, 0, burnin, True)
                    if hasattr(states, "tune") and not self.sampler.self_tuning:
                        states = states._replace(tune=self.tuner.finalize(states.tune))
                _sync(device)
                t1 = phases.enter("sampling", self.mcrange.n_steps - burnin)
                buffers = ({}, {})
                states = self._sample(states, stream, burnin, self.mcrange.n_steps,
                                      buffers if self.destination == "nstate" else None)
            _sync(device)
            raise_on_overflow()
            t2 = phases.close()
        chain = self._squeeze(self._chain(buffers, states))
        return chain, {"warmup_seconds": (t1 - t0) / 1e9, "sampling_seconds": (t2 - t1) / 1e9}

    # ---------------------------------------- dense ensemble preconditioning
    def run_preconditioned(self, generator=None, x0=None, ridge: float = 1e-6,
                           stage2_replace: Optional[dict] = None,
                           warm_stage2: bool = False, back_transform: bool = True):
        """Two-stage run with a dense ensemble preconditioner.

        Stage 1 runs this job's warmup on the raw target; the end-of-warmup
        ensemble covariance (shrunk toward its diagonal with weight
        n/(n+D), plus a relative ridge) is factored as Σ = L Lᵀ in f32.
        Stage 2 reruns warmup and sampling on ``whiten_target(target, L)``
        from the whitened stage-1 positions, with the step seeded at
        dim^-1/4 unless a step size is given.  Returns ``(chain, timings,
        info)``: the trace is mapped back to x = y Lᵀ unless
        ``back_transform=False``; ``timings['warmup_seconds']`` is stage 1
        in full plus stage 2's warmup; ``info`` holds ``chol``, the
        whitened job and stage 1's final state (its adapted step and
        trajectory length).  ``warm_stage2`` runs stage 2 once and discards it
        before the timed pass."""
        if tuple(self.monitor) != ("value",):
            raise ValueError(
                "run_preconditioned requires monitor=('value',); other "
                "fields are not back-transformed from the whitened space"
            )
        if self.destination != "nstate":
            raise ValueError("run_preconditioned requires destination='nstate'")
        if self.n_chains < 2:
            raise ValueError(
                "run_preconditioned needs an ensemble (n_chains >= 2; "
                "intended regime n_chains >> dim)"
            )
        stage1 = dataclasses.replace(
            self,
            mcrange=MCRange(n_steps=self.mcrange.burnin + 1, burnin=self.mcrange.burnin),
        )
        with tracing.job("MCJob.run_preconditioned"), tracing.Phases() as phases:
            phases.enter("stage1")
            c1, t1 = stage1.run_phased(generator, x0)
            phases.enter("precondition")
            # the trace may be stored in bf16: covariance, Cholesky and the
            # stage-2 start come back to f32
            x_end = c1.value[-1].to(torch.float32)
            stage1_state = c1.final_state
            del c1
            with chain_context(self._block):
                chol = ensemble_cholesky(x_end, ridge)
                # stage 2 starts, as any run, from the positions of every chain
                y0 = gather_chains(torch.linalg.solve_triangular(chol, x_end.T, upper=False).T)
            repl = dict(stage2_replace or {})
            if "step_size" not in repl and self.step_size is None:
                repl["step_size"] = float(x_end.shape[1]) ** -0.25
            wjob = dataclasses.replace(self, target=whiten_target(self.target, chol), **repl)
            phases.enter("stage2")
            if warm_stage2:
                warm, _ = wjob.run_phased(generator, y0)
                del warm
            chain, t2 = wjob.run_phased(generator, y0)
        if back_transform:
            chain.samples["value"] = _back_transform(chain.samples["value"], chol)
        timings = {
            "warmup_seconds": t1["warmup_seconds"] + t1["sampling_seconds"]
            + t2["warmup_seconds"],
            "sampling_seconds": t2["sampling_seconds"],
        }
        return chain, timings, {"chol": chol, "whitened_job": wjob, "stage1_state": stage1_state}


def ensemble_cholesky(x_end, ridge: float = 1e-6):
    """Cholesky factor of the shrunk, ridged ensemble covariance of the
    (n_chains, D) positions ``x_end``, in f32.  Inside
    ``parallel.mesh.chain_context(block)`` ``x_end`` is this rank's block,
    the mean and the cross-product are all-reduced over the chains group,
    and every rank computes the same factor."""
    block = active_block()
    x_end = x_end.to(torch.float32)
    d = x_end.shape[1]
    n = x_end.shape[0] if block is None else block.total
    xc = x_end - mean_over_chains(x_end)[None]
    cov = sum_over_ranks(xc.T @ xc) / (n - 1)
    w = n / (n + d)
    cov = w * cov + (1.0 - w) * torch.diag(torch.diagonal(cov))
    lam = ridge * torch.diagonal(cov).mean() + 1e-12
    return torch.linalg.cholesky(cov + lam * torch.eye(d, dtype=cov.dtype, device=cov.device))


def _back_transform(y_trace, chol, chunk: int = 64):
    """x = y Lᵀ per draw, in f32, stored back in the trace's dtype, a chunk
    of draws at a time so no second full-size f32 trace is held."""
    out = torch.empty_like(y_trace)
    chol_t = chol.T
    for s in range(0, y_trace.shape[0], chunk):
        out[s:s + chunk] = (y_trace[s:s + chunk].to(torch.float32) @ chol_t).to(y_trace.dtype)
    return out


def run(jobs, generator, x0s):
    """Run a sequence of jobs one after the other."""
    return [job.run(generator, x0) for job, x0 in zip(jobs, x0s)]
