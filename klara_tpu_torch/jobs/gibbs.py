"""GibbsJob: block-sweep simulation over a model graph, batch-first
(counterpart of klara_tpu/jobs/gibbs.py).

A sweep visits each dependent variable in vertex order and

  (a) runs a nested sampler on the parameter's conditional
      (MCMC-within-Gibbs, a ``Nested`` entry of ``sweep``),
  (b) draws from its full conditional ``setpdf`` given the current values,
  (c) or applies a Transformation,

after the update hooks of Data vertices have fired.  The JAX package writes
every block per chain and vmaps the sweep; here each block updates all
chains at once.  Values the sweep carries (dependents and Data vertices
with an update hook) have a leading chains axis: a per-chain scalar is
(C,), a K-vector (C, K).  Every other value (data, hyperparameters) stays
as given.  User functions are written for that layout: a per-chain scalar
meets a vector through ``[:, None]`` (at C == K plain broadcasting would
silently pair chains with coordinates), and ``logtarget`` maps (C, ...) to
(C,).

A conditional draw is one independent draw per chain at the carried
value's shape, even from a distribution whose parameters are all
constants; within a chain it keeps the JAX package's shape rule (a Gamma
with a scalar shape parameter and a vector rate shares one gamma draw
across the vector).  The draw is cast to the carried value's dtype.  Every
conditional, and every ``reset_from_prior`` start, draws from the run's
keyed stream (``ops.keyed.KeyedStream``, kernel K2 on the card) at counter
(sweep, block): the counterpart of the JAX package's
``fold_in(fold_in(chain_key, sweep), block)``.  The stream's key is drawn
once per ``run`` or ``resume`` from the generator.  A nested block's
sampler draws from the same stream at step = sweep, its k-th step of a
sweep in a window of sites of its own (``ops.keyed``: the nested blocks'
windows lie in ``[NESTED_SITES, JOB_SITES)``, one per nested step, each as
wide as the sampler's ``keyed_sites``); the hoisted step-size search draws
its momentum at step 0 in the block's first window.

A sweep of conjugate draws alone (no nested block, no csv variable) runs
in captured blocks of sweeps (``jobs.graphs``: CUDA graphs on the card, the
same blocks eagerly on the CPU), bit for bit the eager loop; the others run
in a Python loop.  A variable with ``'csv'`` outopts streams to
its own directory: its saved draws gather in a ring of ``stream_chunk`` rows
on the device, and each chunk of sweeps that saved a draw reaches the host
in one copy per csv variable and one host read; on a mesh each chunk is
gathered to the first rank of the chains group, and the mesh's first rank
alone writes.  The conjugate sweep reads nothing back from the device; a
nested HMC/NUTS block with dynamic leap counts reads its batch maximum once
per nested step.  Nested blocks re-initialise their sampler
every sweep, from the current value or a fresh prior draw
(``reset_from_prior``), and tune per chain during their ``burnin``; HMC/NUTS
blocks under dual averaging take their initial ε from one step-size search
per run, against the initial conditionals.

With ``mesh`` the chains split over the mesh dimension ``chains_axis`` as in
``MCJob``, and the traces equal the one-process run's.  Each rank carries
only its block of the chains: a keyed draw names a chain by its global
index, so the rank draws exactly its own chains and the conjugate sweep
issues no collective, nor do nested blocks: their keyed draws name their
chains alike, and a nested block's batch-max leap count is the rank's own
(the loop is masked per chain and runs no collective).  ``v0``'s
carried values hold no chains axis; ``resume`` takes final values of the
global chains (a reloaded checkpoint, or a one-process run: each rank cuts
its block once) or of this rank's (``parallel.mesh.take_block``, which
decides by the leading length alone).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.core.target import Target
from klara_tpu_torch.distributions.core import draw_per_chain
from klara_tpu_torch.io.stream import DrawRing, StreamingWriter
from klara_tpu_torch.jobs import graphs
from klara_tpu_torch.jobs.range import MCRange
from klara_tpu_torch.models.graph import Data, GenericModel, GibbsParameter, Transformation
from klara_tpu_torch.ops.keyed import JOB_SITES, NESTED_SITES, KeyedStream, raise_on_overflow
from klara_tpu_torch.parallel.mesh import (
    chain_block,
    chain_context,
    check_generators,
    take_block,
    writes_output,
)
from klara_tpu_torch.samplers.base import Sampler
from klara_tpu_torch.samplers.hamiltonian import find_reasonable_step_size
from klara_tpu_torch.samplers.hmc import HMC
from klara_tpu_torch.samplers.nuts import NUTS
from klara_tpu_torch.tuners.tuners import DualAveragingTuner, Tuner
from klara_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class Nested:
    """MCMC-within-Gibbs block: ``n_steps`` sampler steps on the block's
    conditional each sweep, the tuner (if any) adapting during the first
    ``burnin`` of them.  With ``reset_from_prior`` the nested start is drawn
    from the parameter's ``setprior`` each sweep instead of continuing from
    the current value."""

    sampler: Sampler
    n_steps: int = 1
    step_size: Optional[float] = None
    burnin: int = 0
    tuner: Optional[Tuner] = None
    reset_from_prior: bool = False


@dataclasses.dataclass
class GibbsChains:
    """Per-variable draws: ``samples[key]`` is (n_post, n_chains, ...).
    ``diagnostics['<key>.accept']`` (n_post, n_chains) is the mean
    acceptance of nested block <key> in each saved sweep."""

    samples: Dict[str, torch.Tensor]
    final_values: Dict[str, torch.Tensor]
    diagnostics: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # the mesh of a run whose chains split over ranks (this rank's block)
    mesh: Any = None
    chains_axis: str = "chains"

    def __getitem__(self, key):
        if key in self.samples:
            return self.samples[key]
        return self.diagnostics[key]

    def flat(self, key):
        arr = self[key]
        return arr.reshape((-1,) + tuple(arr.shape[2:]))


def _default_outopts():
    return {"destination": "nstate", "filepath": None, "flush": False}


def _as_tensor(v, device):
    """A value as a tensor on ``device``.  Numbers and arrays get the JAX
    package's 32-bit defaults (a Python float becomes f32, an int int32);
    a tensor (already on ``device``) is kept as it is."""
    if torch.is_tensor(v):
        return v
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.tensor(a, device=device)


@dataclasses.dataclass
class GibbsJob:
    """Gibbs sweep runner over a GenericModel.

    Parameters
    ----------
    model : GenericModel
    sweep : {param_key: Nested(...)} for MCMC-within-Gibbs blocks; params
        absent from the dict take their full-conditional ``setpdf`` draw.
    mcrange : MCRange
    n_chains : chains axis
    monitor : dependent variables to record (default: all)
    outopts : per-variable output options
        {key: {'destination': 'nstate'|'csv'|'none', 'filepath': ..., 'flush': ...}};
        unlisted variables take 'nstate'.  'csv' streams the variable's draws
        to files under its ``filepath`` during the run (a ``resume`` appends);
        'none' keeps no trace (the final value is still returned).
    record_diagnostics : record '<key>.accept' for nested blocks
    stream_chunk : sweeps per host copy of the csv variables' draws
    hoist_step_search : one step-size search per run for HMC/NUTS nested
        blocks under dual averaging with no ``step_size`` (else one per
        sweep, inside the sampler's ``init``)
    trace_dtype : storage dtype of floating-point traces, e.g. 'bfloat16'
        (only the saved copy rounds; the sweep and final values keep theirs)
    device : where the carried values, the statics and the traces live
        (None: the device of v0's tensors, the card when v0 holds none,
        and an error naming ``device="cpu"`` where there is no card; a
        tensor of v0 on another device than a given one raises)
    mesh, chains_axis : split the chains over that dimension of a
        ``DeviceMesh`` (``klara_tpu_torch.parallel``); every rank is handed a
        generator seeded alike, and the outputs hold the rank's block
    """

    model: GenericModel
    sweep: Dict[str, Nested] = dataclasses.field(default_factory=dict)
    mcrange: MCRange = dataclasses.field(default_factory=MCRange)
    n_chains: int = 1
    monitor: Optional[Sequence[str]] = None
    outopts: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    record_diagnostics: bool = True
    stream_chunk: int = 128
    hoist_step_search: bool = True
    trace_dtype: Optional[str] = None
    device: Any = None
    mesh: Any = None
    chains_axis: str = "chains"

    def __post_init__(self):
        self._dependents = self.model.dependents
        self._updatable = [
            v for v in self.model.vertices if isinstance(v, Data) and v.update is not None
        ]
        if self.monitor is None:
            self.monitor = [v.key for v in self._dependents]
        # specialise nested samplers to their tuners (HMC: fixed trajectory
        # length under dual averaging), as MCJob does
        self.sweep = {
            k: (
                dataclasses.replace(spec, sampler=spec.sampler.bind_tuner(spec.tuner))
                if spec.tuner is not None
                else spec
            )
            for k, spec in self.sweep.items()
        }
        for key in self.sweep:
            if key not in self.model:
                raise ValueError(f"sweep references unknown variable {key!r}")
        if len(self._dependents) > NESTED_SITES:
            raise ValueError(f"{len(self._dependents)} blocks: the keyed draws name at most "
                             f"{NESTED_SITES}")
        for key, spec in self.sweep.items():
            if spec.reset_from_prior and self.model[key].setprior is None:
                raise ValueError(
                    f"Nested(reset_from_prior=True) on {key!r} requires the "
                    "parameter to define setprior"
                )
        self._opts = {}
        for key in self.monitor:
            opts = dict(_default_outopts())
            opts.update(self.outopts.get(key, {}))
            if opts["destination"] not in ("nstate", "csv", "none"):
                raise ValueError(f"unknown destination {opts['destination']!r} for {key!r}")
            if opts["destination"] == "csv" and not opts.get("filepath"):
                raise ValueError(f"destination='csv' for {key!r} requires filepath")
            self._opts[key] = opts
        unknown = set(self.outopts) - set(self.monitor)
        if unknown:
            raise ValueError(f"outopts for unmonitored variables: {sorted(unknown)}")
        self._trace_dtype = None
        if self.trace_dtype is not None:
            self._trace_dtype = getattr(torch, str(self.trace_dtype), None)
            if not isinstance(self._trace_dtype, torch.dtype):
                raise ValueError(f"unknown trace_dtype {self.trace_dtype!r}")
        self._csv_keys = [k for k in self.monitor if self._opts[k]["destination"] == "csv"]
        self._block = chain_block(self.mesh, self.chains_axis, self.n_chains)
        self._local_chains = self.n_chains if self._block is None else self._block.local
        self._writers: Dict[str, StreamingWriter] = {}
        self._ring = None

    # ---------------------------------------------------------------- sweep
    def _needs_step_hoist(self, spec: Nested) -> bool:
        """True when the block's ``init`` would run the step-size search:
        HMC/NUTS under dual averaging with no explicit step size."""
        return (
            self.hoist_step_search
            and spec.step_size is None
            and isinstance(spec.sampler, (HMC, NUTS))
            and isinstance(spec.tuner, DualAveragingTuner)
        )

    def _nested_window(self, key, values) -> tuple:
        """(base, width) of nested block ``key``'s windows: its step k of a
        sweep draws at sites [base + k·width, base + (k+1)·width), its init
        in step 0's.  The nested blocks' windows follow each other from
        ``NESTED_SITES`` in the order of their keys."""
        base = NESTED_SITES
        for k, spec in sorted(self.sweep.items()):
            width = spec.sampler.keyed_sites(values[k])
            if k == key:
                if base + max(1, spec.n_steps) * width > JOB_SITES:
                    raise ValueError("the nested blocks' draws need more sites than "
                                     f"[{NESTED_SITES}, {JOB_SITES}) holds")
                return base, width
            base += max(1, spec.n_steps) * width
        raise KeyError(key)

    def _hoist_step_sizes(self, values: Dict[str, Any], stream):
        """Per-chain (C,) step sizes for nested blocks, searched once per
        run against the initial conditionals and reused by every sweep; the
        search's momentum at step 0 in the block's first window."""
        out = {}
        for hk, spec in sorted(self.sweep.items()):
            if not self._needs_step_hoist(spec):
                continue
            var, frozen = self.model[hk], dict(values)
            target = Target(
                logdensity_fn=lambda x, _v=var, _f=frozen: _v.conditional_logdensity(x, _f)
            )
            base, width = self._nested_window(hk, values)
            out[hk] = find_reasonable_step_size(
                target, values[hk], stream=stream.at(step=0, window=base + width - 1))
        return out

    def _nested_update(self, var, spec: Nested, values, stream, step_size):
        """``n_steps`` sampler steps on the conditional of ``var`` from ε =
        ``step_size`` (None: the sampler's own start), drawing from
        ``stream`` (at the sweep and the block) in the block's windows."""
        x0 = values[var.key]
        if spec.reset_from_prior:
            x0 = draw_per_chain(var.setprior(values), x0, stream)
        # conditional target given the CURRENT values of all others
        frozen = dict(values)
        target = Target(logdensity_fn=lambda x: var.conditional_logdensity(x, frozen))
        base, width = self._nested_window(var.key, values)
        state = spec.sampler.init(target, x0, step_size=step_size, tuner=spec.tuner,
                                  stream=stream.at(window=base + width - 1))
        acc = torch.zeros(x0.shape[0], dtype=torch.float32, device=x0.device)
        for k in range(spec.n_steps):
            state, info = spec.sampler.step(state, target,
                                            stream=stream.at(window=base + (k + 1) * width - 1))
            accept = info.accept.to(torch.float32)
            if spec.tuner is not None and not spec.sampler.self_tuning:
                stat = info.accept_stat if spec.sampler.tuner_statistic == "accept_stat" else accept
                state = state._replace(
                    tune=spec.tuner.update(state.tune, accept, stat, spec.burnin)
                )
            acc = acc + accept
        return state.position, {f"{var.key}.accept": acc / spec.n_steps}

    def _block_update(self, var, values, stream, hoisted, noise=None):
        """One block of the sweep: (new value, diagnostics dict)."""
        if isinstance(var, Transformation):
            return var.transform(values), {}
        if var.key in self.sweep:
            spec = self.sweep[var.key]
            step_size = spec.step_size if spec.step_size is not None else hoisted.get(var.key)
            return self._nested_update(var, spec, values, stream, step_size)
        if var.setpdf is None:
            raise ValueError(
                f"parameter {var.key!r} needs either a setpdf full conditional "
                "or a Nested sweep entry"
            )
        return draw_per_chain(var.setpdf(values), values[var.key], stream, noise), {}

    def _stream(self, generator, device) -> KeyedStream:
        """The run's keyed stream over this rank's chains on the values'
        ``device``, its key drawn from ``generator`` (a generator on another
        device raises: the draws never move to it)."""
        offset = 0 if self._block is None else self._block.offset
        return KeyedStream.for_run(generator, device, self._local_chains, offset)

    def _sweep(self, values, generator, hoisted, noise=None, stream=None, sweep=0, step_add=0):
        """One full sweep over this rank's chains: (updated values,
        diagnostics).  Conditional block b draws from ``stream`` (default: a
        fresh one from ``generator``) at counter (``sweep`` + ``step_add``, b),
        ``sweep`` an int or a captured block's step counter on the device;
        ``noise`` ({key: standard draw}) replays conditional draws."""
        if stream is None:
            stream = self._stream(generator, self._device_of(values))
        values, diags = dict(values), {}
        for u in self._updatable:  # Data.update hooks fire before any block
            values[u.key] = u.update(values)
        for b, var in enumerate(self._dependents):
            values[var.key], d = self._block_update(
                var, values, stream.at(step=sweep, step_add=step_add, site=b), hoisted,
                None if noise is None else noise.get(var.key)
            )
            diags.update(d)
        return values, diags

    def _carry_keys(self):
        return [u.key for u in self._updatable] + [v.key for v in self._dependents]

    def _device_of(self, v0: Dict[str, Any]) -> torch.device:
        """The run's device: ``device`` if given, else the one device of
        v0's tensors, else the card (``resolve_device``).  Values never move
        between devices: a tensor elsewhere raises."""
        want = resolve_device(self.device, v0.values())
        if self.device is not None:
            for d in {t.device for t in v0.values() if torch.is_tensor(t)}:
                if d.type != want.type or want.index not in (None, d.index):
                    raise ValueError(f"v0 holds tensors on {d}, but the job's device is {want}")
        return want

    def _initial_values(self, v0: Dict[str, Any], prebatched: bool):
        """Every value on the run's device, the carried ones with a leading
        axis of this rank's chains (``prebatched``: cut from the global
        chains, or already the rank's)."""
        device = self._device_of(v0)
        carry = set(self._carry_keys())
        values = {}
        for k, v in v0.items():
            t = _as_tensor(v, device)
            if k in carry:
                t = take_block(t, self._block) if prebatched else t.expand(
                    (self._local_chains,) + tuple(t.shape)).clone()
            values[k] = t
        return values

    # ------------------------------------------------------------------ run
    def _run(self, generator, v0: Dict[str, Any], prebatched: bool):
        """The run in the job report's phases (``utils.tracing``): ``setup``
        (values, buffers and the stream), then ``sweeps`` (every sweep,
        through the overflow check)."""
        n_post = self.mcrange.n_post
        with tracing.Phases() as phases:
            phases.enter("setup")
            values = self._initial_values(v0, prebatched)
            device = self._device_of(values)
            dep_keys = [v.key for v in self._dependents]
            diag_keys = (
                [f"{k}.accept" for k in self.sweep if k in dep_keys]
                if self.record_diagnostics
                else []
            )

            def buf_dtype(v):
                if self._trace_dtype is not None and v.is_floating_point():
                    return self._trace_dtype
                return v.dtype

            buffers = {
                k: torch.empty((n_post,) + tuple(values[k].shape), dtype=buf_dtype(values[k]),
                               device=values[k].device)
                for k in self.monitor
                if self._opts[k]["destination"] == "nstate"
            }
            diag_buffers = {
                k: torch.empty((n_post, self._local_chains), dtype=torch.float32, device=device)
                for k in diag_keys
            }
            stream = self._stream(generator, device)
            phases.enter("sweeps", self.mcrange.n_steps)
            if graphs.sweeps_capturable(self):
                values = graphs.sweep_blocks(self, values, stream, self.mcrange.n_steps, buffers)
            else:
                values = self._sweeps(values, stream, buffers, diag_buffers)
            raise_on_overflow()
        return GibbsChains(
            samples=buffers,
            final_values={k: values[k] for k in self._carry_keys()},
            diagnostics=diag_buffers,
            mesh=self.mesh,
            chains_axis=self.chains_axis,
        )

    def _sweeps(self, values, stream, buffers, diag_buffers):
        """The eager loop: every sweep of the run, one at a time (nested
        blocks, csv variables)."""
        burnin, thinning = self.mcrange.burnin, self.mcrange.thinning
        hoisted = self._hoist_step_sizes(values, stream)
        n_steps, ring = self.mcrange.n_steps, self._ring
        for i in range(n_steps):
            values, diags = self._sweep(values, None, hoisted, stream=stream, sweep=i)
            if i >= burnin and (i - burnin) % thinning == 0:
                j = (i - burnin) // thinning
                for k, buf in buffers.items():
                    buf[j].copy_(values[k])
                for k, buf in diag_buffers.items():
                    buf[j].copy_(diags[k])
                if ring is not None:
                    ring.save({k: values[k] for k in self._csv_keys})
            if ring is not None and ((i + 1) % ring.rows == 0 or i + 1 == n_steps):
                count, host = ring.take(self._block)
                if count and self._writers:
                    for k in self._csv_keys:
                        self._writers[k].append_block(count, {k: host[k]})
        return values

    def run(self, generator, v0: Dict[str, Any]) -> GibbsChains:
        """Sweep ``mcrange.n_steps`` times from ``v0``, which holds a value
        for every vertex (carried values without the chains axis)."""
        missing = [v.key for v in self.model.vertices if v.key not in v0]
        if missing:
            raise ValueError(f"v0 missing values for {missing}")
        with tracing.job("GibbsJob.run"):
            check_generators(generator, self.mesh)
            self._open_writers()
            with chain_context(self._block):
                out = self._run(generator, v0, prebatched=False)
            self._close_writers()
        return out

    def resume(self, generator, chains: GibbsChains, v0: Dict[str, Any]) -> GibbsChains:
        """Continue for another ``mcrange.n_steps`` sweeps from
        ``chains.final_values``; ``v0`` supplies the values that are not
        carried (data, hyperparameters), as in ``run``.  On a mesh the final
        values may hold the global chains (a reloaded checkpoint: this rank
        takes its block) or this rank's."""
        carry = self._carry_keys()
        merged = {k: v for k, v in v0.items() if k not in carry}
        merged.update({k: chains.final_values[k] for k in carry})
        missing = [v.key for v in self.model.vertices if v.key not in merged]
        if missing:
            raise ValueError(f"resume missing values for {missing}")
        with tracing.job("GibbsJob.resume"):
            check_generators(generator, self.mesh)
            self._open_writers()
            with chain_context(self._block):
                out = self._run(generator, merged, prebatched=True)
            self._close_writers()
        return out

    def _open_writers(self):
        """A writer per csv variable (on the rank that writes) and the ring
        they share, kept across ``run`` and ``resume`` (files reopen in
        append mode)."""
        for k in self._csv_keys if writes_output(self.mesh) else ():
            if k not in self._writers:
                opts = self._opts[k]
                self._writers[k] = StreamingWriter(
                    opts["filepath"], flush=opts.get("flush", False), sample_fields={k})
        if self._csv_keys and self._ring is None:
            self._ring = DrawRing(max(1, min(self.stream_chunk, self.mcrange.n_steps)))

    def _close_writers(self):
        """Close the files (manifest and sidecars with the final row counts);
        the writers stay for a later ``run`` or ``resume``."""
        for w in self._writers.values():
            w.close()

    def to_dot(self) -> str:
        """Graphviz export with update annotations: dependents get
        ``peripheries=2``, monitored dependents (destination != 'none') an
        underlined label, MCMC-within-Gibbs blocks ``style=diagonals``."""
        lines = ["digraph GibbsJob {"]
        for v in self.model.vertices:
            attrs = [f"shape={v.dotshape}"]
            if v.is_dependent:
                attrs.append("peripheries=2")
                opts = self._opts.get(v.key)
                if opts is not None and opts["destination"] != "none":
                    attrs.append(f"label=<<u>{v.key}</u>>")
                if isinstance(v, GibbsParameter) and v.key in self.sweep:
                    attrs.append("style=diagonals")
            lines.append(f'  "{v.key}" [{", ".join(attrs)}];')
        for s, t in self.model.edges:
            lines.append(f'  "{s}" -> "{t}";')
        lines.append("}")
        return "\n".join(lines)
