"""Captured sampling loops: the port's counterpart of the JAX package's compiled loops.

The JAX package runs a phase's steps as one compiled program with no host
work in between: ``MCJob._scan_fn``'s ``scan_body`` (klara_tpu/jobs/job.py
:321-550) under ``lax.scan`` in ``_drive`` (:621-689) and
``_sampling_phase`` (:932-946), compiled by ``jax.jit`` (:226, :749-750);
``GibbsJob._run``'s sweep ``_sweep_fn`` under one ``lax.scan``
(klara_tpu/jobs/gibbs.py:325-481, the scan at :417); and a traced leap count
in ``lax.fori_loop`` (klara_tpu/samplers/hamiltonian.py:64-83).  Here a CUDA
graph takes that place: one replay launches a fixed block of device work, the
same kernels on the same inputs as the eager loop, so every draw, trace and
final state is bit for bit the eager loop's.

What runs as captured blocks (on the card; on the CPU the same blocks run
eagerly, which is how the tests hold them to the per-step loop):

* ``GibbsJob``'s conjugate sweeps (``sweep_blocks``): a block of
  ``SWEEPS_PER_BLOCK`` sweeps.
* ``MCJob.run_phased``'s sampling phase (``sample``) with ``NUTS`` on the
  static tree: a block of ``STEPS_PER_BLOCK`` steps.
* the same phase with ``HMC`` whose leap counts follow from the state (a
  fixed count, λ/ε, or λ/ε under the job's shared jitter): a block's leap
  counts are read once (a "prepass" block draws its ``STEPS_PER_BLOCK``
  shared jitters, global chain 0's keyed draws at (step, ``SHARED_JITTER``),
  and works out each step's batch max and min leap count), then a step
  replays four graphs: its start (``HMC.begin``: the momentum draw), one
  leapfrog step n_max times (the unmasked graph for the first n_min, the
  masked one, ``leapfrog``'s tail where the chains' counts differ, for the
  rest), and its end (``HMC.finish``: the accept draw, the saved fields).
  So a run holds at most six graphs whatever leap counts it meets, and a
  step costs n_max + 2 replays and a copy of the trajectory's point after
  each leap (the carry between replays).  One graph per leap count would
  cost one replay a step and no such copy, but a graph and a capture for
  every (max, min) pair a run meets: a handful under one pooled ε, up to
  ``max_nleaps``² / 2 under per-chain ε and a long, jittered trajectory,
  each holding n_max steps' nodes.  The traffic that decides is the
  spread of leap counts, which the job does not bound; ``PERF.md`` gives
  the copies' cost.  The prepass's draw is the step's jitter (the start reads it back
  from the prepass's buffer), so K2 launches as often as in the eager loop.
* ``MCJob.run_phased``'s warmup with that ``HMC`` (``warm``): a step replays
  the same units under kinds of their own (``warmup head``, ``warmup leap``,
  ``warmup masked leap``, ``warmup tail``), its start drawing the shared
  jitter and leaving the step's (max, min) leap count in a buffer the host
  reads once (the hooks change ε and λ every step, so no prepass can draw
  a block's counts ahead).  The adaptation hooks (``MCJob.adapt``: tune,
  mass, ChEES) then run eagerly between steps, on fresh copies of the
  step's new tensors: an override of ``adapt`` may keep what it is handed,
  which a later replay must not write over.  What the hooks change is
  copied back into the units' state.

What stays eager, each because it is out of this slice's scope: the
adaptation hooks themselves, and ``MCJob.run``'s steps, which adapt;
warmup with any sampler but that ``HMC`` (NUTS's among them); nested Gibbs
blocks (a host read a nested step); the looped NUTS tree (a host read a
doubling); HMC with per-chain jitter; MALA and the rest of the sampler zoo;
``verbose`` and csv runs.  A job whose mesh has a param dimension of more than one rank stays
eager too: its target (``param_sharded_logreg_target``) runs collectives in
every evaluation, which a capture would bake into the graph (gloo refuses
them under capture; NCCL's would replay uncounted in ``COLLECTIVES``).

A block's structure.  The state lives in tensors made before the first
block (``_clone``); a block reads them, and ends by copying its final state
back into them, so blocks chain with no host work.  It draws K2 at a 0-d
int64 step counter on the device (``KeyedStream.at(step=counter,
step_add=k)`` for its k-th step) and advances the counter in place.  Each
step's saved fields go to a staging buffer inside the block (``Staging``);
after the block one copy a field moves the saved rows into the traces.  A
tail block shorter than the rest, and the first block of each kind, run
eagerly; the second block of a kind is captured, then replayed.

Where trouble lies, and what is done about it:

* K2's step.  The kernel adds the stream's ``step_add`` to the step it reads
  by pointer, so a block's k-th step is ``at(step=counter, step_add=k)``;
  the plain version (``draws_reference``) adds it too.
* Addresses are baked into a graph.  K2's packed arguments hold the run
  key's and the parameters' pointers (``ops.keyed.launch_args``), K1 its
  operands'.  So blocks are captured per run, from that run's stream and
  state tensors (``Units`` belongs to one run), and never reused across runs.
* Everything lazy happens before capture: the first block of every kind
  runs eagerly on the capture stream, which builds and loads K1 and K2
  (``_build.load``), fills K2's plans and cuBLAS's workspace for that stream,
  and allocates the staging buffers (outside the graph's pool).
* Streams.  K1 launches on ``torch.cuda.current_stream``, K2 on
  ``torch._C._cuda_getCurrentRawStream``: both follow the capture stream.
  Both libraries link the CUDA runtime statically; their launches land in
  the capture all the same, since capture belongs to the stream
  (``chip_smoke.py`` phase 28 holds the replays bit for bit to the eager
  loop, which a missing node breaks).
* No host read and no host→device copy inside a block: a capture runs under
  ``torch.cuda.set_sync_debug_mode("error")``, and a capture that fails
  raises; nothing falls back to the eager loop.
* Launch counters.  ``ops.logreg.KERNEL_LAUNCHES``, ``ops.keyed.KERNEL_LAUNCHES``
  and ``LAUNCHES_BY_MODE`` count Python calls, as does
  ``core.target.FACTOR_EVALUATIONS`` the evaluations through a factor (the
  LGCP's launch neither kernel).  A capture calls the wrappers but runs nothing, so the counts a
  capture adds are recorded and taken back (``launches_of``), and every
  replay adds them (``add_launches``): the counts equal the eager loop's.
* Memory.  A phase's graphs share one pool, which holds one block's
  intermediates; the staging buffers hold a block's saved rows, and HMC's
  trajectory between replays lives in tensors made by its first, eager
  step (``Units.hold``), as do the warmup's accept flags and statistics
  between a step's end and its hooks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from klara_tpu_torch.core import target as core_target
from klara_tpu_torch.ops import keyed, logreg
from klara_tpu_torch.samplers.hamiltonian import leap
from klara_tpu_torch.samplers.hmc import HMC
from klara_tpu_torch.samplers.nuts import NUTS
from klara_tpu_torch.utils import tracing

STEPS_PER_BLOCK = 20     # MCJob sampling steps a block (and leap counts a prepass)
SWEEPS_PER_BLOCK = 100   # conjugate Gibbs sweeps a block

# graphs captured and replayed in this process, and the kernel launches the
# replays added to the wrappers' counters (plain counters; reset by assignment)
GRAPHS_CAPTURED = 0
GRAPH_REPLAYS = 0
REPLAYED_LAUNCHES = {"k1": 0, "k2": 0}


# ---------------------------------------------------------- launch counters
class Launches(NamedTuple):
    """What the wrappers counted: K1's and K2's launches, K2's by mode, and
    the evaluations through a factor (``core.target.through_factor``)."""

    k1: int
    k2: int
    k2_by_mode: dict
    evals: int = 0


def launches_of(fn) -> Launches:
    """Call ``fn`` and return the launches the wrappers counted in it, with
    the counters set back to where they were: what a capture records, since
    it calls the wrappers but launches nothing."""
    k1, k2, modes = logreg.KERNEL_LAUNCHES, keyed.KERNEL_LAUNCHES, dict(keyed.LAUNCHES_BY_MODE)
    evals = core_target.FACTOR_EVALUATIONS
    try:
        fn()
    finally:
        now = keyed.LAUNCHES_BY_MODE
        rec = Launches(logreg.KERNEL_LAUNCHES - k1, keyed.KERNEL_LAUNCHES - k2,
                       {m: n - modes.get(m, 0) for m, n in now.items() if n != modes.get(m, 0)},
                       core_target.FACTOR_EVALUATIONS - evals)
        logreg.KERNEL_LAUNCHES, keyed.KERNEL_LAUNCHES = k1, k2
        core_target.FACTOR_EVALUATIONS = evals
        now.update(modes)
    return rec


def add_launches(rec: Launches) -> None:
    """One replay's launches, added to the wrappers' counters."""
    logreg.KERNEL_LAUNCHES += rec.k1
    keyed.KERNEL_LAUNCHES += rec.k2
    core_target.FACTOR_EVALUATIONS += rec.evals
    for mode, n in rec.k2_by_mode.items():
        keyed.LAUNCHES_BY_MODE[mode] += n
    REPLAYED_LAUNCHES["k1"] += rec.k1
    REPLAYED_LAUNCHES["k2"] += rec.k2


# -------------------------------------------------------------------- units
def kind_of(key) -> str:
    """The kind of a unit's key: the key itself (a name), its first item (a
    (name, steps) pair), or ``sweeps`` (a Gibbs block's count of sweeps)."""
    if isinstance(key, str):
        return key
    return key[0] if isinstance(key, tuple) else "sweeps"


class Units:
    """One run's blocks of device work, each named by a key: ``run(key,
    body)`` calls ``body()`` eagerly the first time the key is met (on the
    capture stream: lazy loads, plans and workspaces happen there), captures
    it into a CUDA graph the second time and replays it then and after.  On
    the CPU every call runs ``body()``.  ``body`` reads and writes only
    tensors that outlive the run's blocks, the same every time its key is
    met.  The tracer's timed counters ``graphs.eager_blocks``,
    ``graphs.captures`` and ``graphs.replays.<kind>`` (``kind_of``) count
    the card's eager blocks, captures and replays and their host time;
    ``graphs.eager_steps`` (counted by the callers whose blocks are whole
    steps or sweeps) the steps the eager blocks ran."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda"
        self._seen = set()
        self._graphs = {}  # key -> (graph, Launches)
        if self.capture:
            self.main = torch.cuda.current_stream(self.device)
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()

    def run(self, key, body) -> bool:
        """True where ``body`` ran as the card's eager first block of
        ``key``."""
        global GRAPH_REPLAYS
        if not self.capture:
            body()
            return False
        entry = self._graphs.get(key)
        if entry is None:
            if key not in self._seen:
                self._seen.add(key)
                with tracing.timed("graphs.eager_blocks", "eager_block"):
                    self._warm(body)
                return True
            with tracing.timed("graphs.captures", "capture"):
                entry = self._graphs[key] = self._capture(body)
        graph, rec = entry
        kind = kind_of(key)
        with tracing.timed(f"graphs.replays.{kind}", f"replay.{kind}"):
            self._launch(graph)
        add_launches(rec)
        GRAPH_REPLAYS += 1
        return False

    def hold(self, tree):
        """Fresh copies of ``tree``'s tensors that outlive the run's blocks:
        made in an eager block on the capture stream, read and written by
        the replays on the main stream too."""
        out = _clone(tree)
        if self.capture:
            for t in _tensors(out, []):
                t.record_stream(self.main)
        return out

    def _launch(self, graph) -> None:
        with torch.cuda.device(self.device):
            graph.replay()

    def _warm(self, body) -> None:
        """``body`` eagerly on the capture stream, ordered after the main
        stream's work and before what the main stream does next."""
        self._stream.wait_stream(self.main)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            body()
        self.main.wait_stream(self._stream)

    def _capture(self, body):
        """(graph, launches) of ``body`` captured: the wrappers' counts of the
        capture are recorded and taken back; a failed capture raises."""
        global GRAPHS_CAPTURED
        graph = self._new_graph()
        rec = launches_of(lambda: self._record(graph, body))
        GRAPHS_CAPTURED += 1
        return graph, rec

    def _new_graph(self):
        return torch.cuda.CUDAGraph()

    def _record(self, graph, body) -> None:
        """``body`` captured into ``graph``, in this run's pool, with no host
        read allowed (a read or a synchronisation raises)."""
        with torch.cuda.device(self.device), \
                torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                body()
            finally:
                torch.cuda.set_sync_debug_mode(mode)


class Staging:
    """A block's saved fields, ``rows`` of each on the device, written inside
    the block and moved into the traces after it (``drain``: one copy a
    field).  A buffer is made at its field's first write, which is always
    in an eager block, never inside a capture."""

    def __init__(self, rows: int, units: Units):
        self.rows, self.bufs = rows, {}
        self._main = units.main if units.capture else None

    def write(self, row, saved) -> None:
        """``saved``: (name, value, trace dtype) of one step; ``row`` an int
        or a (1,) int64 device index."""
        for name, val, dtype in saved:
            buf = self.bufs.get(name)
            if buf is None:
                buf = self.bufs[name] = torch.empty((self.rows,) + tuple(val.shape), dtype=dtype,
                                                    device=val.device)
                if self._main is not None:  # made on the capture stream, read on the main one
                    buf.record_stream(self._main)
            if isinstance(row, int):
                buf[row].copy_(val)
            else:
                buf.index_copy_(0, row, val.to(dtype).unsqueeze(0))

    def drain(self, trace_of, rows: range, first_draw: int) -> None:
        """Rows ``rows`` (a range with a step) of every buffer into trace rows
        ``first_draw``, ``first_draw + 1``, ...; ``trace_of(name, buf)`` gives
        a field's trace."""
        if len(rows) == 0:
            return
        for name, buf in self.bufs.items():
            trace_of(name, buf)[first_draw:first_draw + len(rows)].copy_(
                buf[rows.start:rows.stop:rows.step])


def saved_rows(start: int, n: int, burnin: int, thinning: int):
    """(rows of a block of steps [start, start + n) that are saved, the first
    one's draw index): step i is saved when i >= burnin and (i − burnin) is
    a multiple of ``thinning``."""
    first = max(start, burnin)
    first += (-(first - burnin)) % thinning
    rows = range(first - start, n, thinning)
    return rows, (first - burnin) // thinning


# --------------------------------------------------------------- the state
def _tensors(tree, out):
    if torch.is_tensor(tree):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _tensors(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _tensors(t, out)
    return out


def _rebuild(tree, it):
    if torch.is_tensor(tree):
        return next(it)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(t, it) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, it) for t in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(t, it) for k, t in tree.items()}
    return tree


def _clone(state):
    """A state (NamedTuples and tuples of tensors) whose tensors are fresh
    copies: the tensors a run's blocks read and write back."""
    return _rebuild(state, iter([t.clone() for t in _tensors(state, [])]))


def _copy_into(static, new) -> None:
    """The tensors of ``new`` copied into those of ``static``, position by
    position; a new tensor that shares memory with a static one is cloned
    first, so no copy reads what an earlier one wrote."""
    dst, src = _tensors(static, []), _tensors(new, [])
    held = {t.untyped_storage().data_ptr() for t in dst}
    src = [s if s is d or s.untyped_storage().data_ptr() not in held else s.clone()
           for d, s in zip(dst, src)]
    for d, s in zip(dst, src):
        if s is not d:
            d.copy_(s)


# ------------------------------------------------------------------- MCJob
def _collective_target(job) -> bool:
    """True where the job's mesh has a dimension besides the chains' with
    more than one rank: a target sharded over it
    (``param_sharded_logreg_target``) runs collectives in every evaluation."""
    mesh = job.mesh
    if mesh is None:
        return False
    names = tuple(mesh.mesh_dim_names or ())
    return any(mesh.size(i) > 1 for i, name in enumerate(names) if name != job.chains_axis)


def sampling_kind(job):
    """How ``MCJob.run_phased`` samples: 'block' (the static NUTS tree),
    'leaps' (HMC whose leap counts follow from the state), or None (the
    eager loop: verbose runs, a target that runs collectives, per-chain
    jitter, the looped tree, the zoo)."""
    s = job.sampler
    if job.verbose or _collective_target(job):
        return None
    if isinstance(s, NUTS):
        return "block" if s._use_static() else None
    if isinstance(s, HMC):
        per_chain = s.dynamic_nleaps and s.jitter > 0.0 and not job._shared_jitter()
        return None if per_chain else "leaps"
    return None


class _Transition:
    """HMC's transition as graph units over a run's state ``static``, drawn at
    the device step ``counter``: ``begin`` (its start: the momentum draw, H
    there and the leap counts, into the carry), ``leap`` (one leapfrog step
    of the carry, masked where the chains' counts differ) and ``finish``
    (its end: the accept draw; returns the new state and infos).  The carry,
    the trajectory between replays ([start or last point, H at start,
    counts, frac]), is made by the first ``begin``, always eager, and
    outlives the run's blocks."""

    def __init__(self, job, units, static, stream, counter):
        self.job, self.units, self.static = job, units, static
        self.stream, self.counter = stream, counter
        self.sampler = job._step_sampler()
        self.carry = []
        self.leap_k = torch.zeros((), dtype=torch.int64, device=counter.device)  # leap in the step

    def begin(self, frac):
        """``frac``: the step's shared jitter fraction (0-d) or None; returns
        the leap counts."""
        at = self.stream.at(step=self.counter)
        _, begun = self.job._under_jitter(
            self.static, frac, lambda st: (st, self.sampler.begin(st, at)))
        if self.carry:
            _copy_into(self.carry, list(begun))
        else:
            self.carry.extend(self.units.hold(t) for t in begun)
        self.leap_k.zero_()
        return begun[2]

    def leap(self, masked: bool):
        pp, _, nleaps, _ = self.carry
        live = self.leap_k < nleaps if masked else None
        st = self.static
        _copy_into(pp, leap(self.job.target, pp, st.tune.step, st.inv_mass, live))
        self.leap_k.add_(1)

    def finish(self):
        pp, h0, nleaps, frac = self.carry
        # the jitter's log_traj offset reached the leap counts alone
        return self.sampler.finish(self.static, pp, h0, nleaps, frac,
                                   self.stream.at(step=self.counter))

    def replay(self, prefix: str, n_max: int, n_min: int) -> None:
        """A step's ``n_max`` leaps: units of kind ``<prefix>leap`` for the
        first ``n_min``, ``<prefix>masked leap`` for the rest."""
        for k in range(n_max):
            masked = k >= n_min
            self.units.run(f"{prefix}masked leap" if masked else f"{prefix}leap",
                           lambda masked=masked: self.leap(masked))


def sample(job, states, stream, start: int, stop: int, buffers):
    """Steps [start, stop) of ``job``'s sampling phase (no adaptation) in
    captured blocks, from ``stream`` at those steps; saved draws go to
    ``buffers`` (samples, diagnostics) unless it is None.  Returns the final
    state: bit for bit ``job._loop(states, stream, start, stop, False,
    buffers)``'s."""
    kind = sampling_kind(job)
    job._check_sites(states)
    sampler, target = job._step_sampler(), job.target
    burnin, thinning, n_post = job.mcrange.burnin, job.mcrange.thinning, job.mcrange.n_post
    device = states.position.device
    units = Units(device)
    block = STEPS_PER_BLOCK
    staging = None if buffers is None else Staging(block, units)
    static = _clone(states)
    counter = torch.full((), start, dtype=torch.int64, device=device)

    def save(row, st, infos):
        if staging is not None:
            staging.write(row, job._saved(st, infos))

    def steps(n):
        st = static
        for k in range(n):
            st, infos = sampler.step(st, target, stream=stream.at(step=counter, step_add=k))
            save(k, st, infos)
        counter.add_(n)
        _copy_into(static, st)

    if kind == "leaps":
        shared = job._shared_jitter()
        fracs = torch.ones(block, dtype=static.log_traj.dtype, device=device)
        bounds = torch.zeros(block, 2, dtype=torch.int32, device=device)
        slot = torch.zeros(1, dtype=torch.int64, device=device)    # the step's row in the block
        tr = _Transition(job, units, static, stream, counter)

        def prepass(n):
            for k in range(n):
                frac = None
                if shared:
                    frac = job._shared_fraction(stream.at(step=counter, step_add=k),
                                                static.log_traj)
                    fracs[k].copy_(frac)
                _, nleaps = job._under_jitter(
                    static, frac, lambda st: (st, sampler._nleaps(st.tune.step, st.log_traj)[0]))
                bounds[k].copy_(torch.stack([nleaps.max(), nleaps.min()]))
            slot.zero_()

        def head():
            tr.begin(fracs.index_select(0, slot).reshape(()) if shared else None)

        def tail():
            st, infos = tr.finish()
            save(slot, st, infos)
            counter.add_(1)
            slot.add_(1)
            _copy_into(static, st)

    def trace_of(name, buf):
        group, field = buffers[name[0]], name[1]
        if field not in group:
            group[field] = torch.empty((n_post,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                                       device=buf.device)
        return group[field]

    for s in range(start, stop, block):
        n = min(block, stop - s)
        with tracing.span("block"):
            if kind == "block":
                if units.run(("block", n), lambda n=n: steps(n)):
                    tracing.count("graphs.eager_steps", n)
            else:
                units.run(("prepass", n), lambda n=n: prepass(n))
                with tracing.timed("host_read.block_bounds"):  # the block's one host read
                    counts = bounds[:n].tolist()
                for n_max, n_min in counts:
                    units.run("head", head)
                    tr.replay("", n_max, n_min)
                    units.run("tail", tail)
            if staging is not None:
                staging.drain(trace_of, *saved_rows(s, n, burnin, thinning))
    return static


def warm(job, states, stream, start: int, stop: int):
    """Warmup steps [start, stop) of ``job`` (``sampling_kind`` 'leaps') from
    ``stream`` at those steps: a step replays its transition as units (its
    start, which also draws the shared jitter and leaves the step's batch
    max and min leap count in a buffer the host reads once; n_max leaps; its
    end), then runs the adaptation hooks, ``job.adapt``, eagerly.  The hooks
    get fresh tensors, never a unit's: an override may keep what it is
    handed, and the next replay would write over a unit's.  Returns the
    adapted state after the last step: bit for bit ``job._loop(states,
    stream, start, stop, True)``'s."""
    job._check_sites(states)
    shared = job._shared_jitter()
    device = states.position.device
    units = Units(device)
    static = _clone(states)
    counter = torch.full((), start, dtype=torch.int64, device=device)
    tr = _Transition(job, units, static, stream, counter)
    frac = torch.ones((), dtype=static.log_traj.dtype, device=device)  # the shared jitter
    bounds = torch.zeros(2, dtype=torch.int32, device=device)
    kept = []   # the end's new tensors that neither the state nor the carry holds
    ended = []  # the end's (state, infos), and where each of its tensors lies after it

    def head():
        f = None
        if shared:
            f = job._shared_fraction(stream.at(step=counter), static.log_traj)
            frac.copy_(f)
        nleaps = tr.begin(f)
        bounds.copy_(torch.stack([nleaps.max(), nleaps.min()]))

    def tail():
        out = tr.finish()
        old, new = _tensors(static, []), _tensors(out[0], [])
        where = {id(n): ("hooks", k) if n is t else ("static", k)
                 for k, (t, n) in enumerate(zip(old, new))}
        for k, t in enumerate(_tensors(tr.carry, [])):
            where.setdefault(id(t), ("carry", k))
        fresh = []
        for t in _tensors(out, []):
            if id(t) not in where:
                where[id(t)] = ("kept", len(fresh))
                fresh.append(t)
        if kept:
            _copy_into(kept, fresh)
        else:  # the first end, always eager
            kept.extend(units.hold(t) for t in fresh)
        ended[:] = [out, [where[id(t)] for t in _tensors(out, [])]]
        counter.add_(1)
        _copy_into(static, out[0])

    def handed(cur):
        """The end's (state, infos) as the eager step gives them: a copy of
        each new tensor (one copy where the end gave one tensor twice), the
        hooks' own tensors where the step kept theirs."""
        out, plan = ended
        lies = {"hooks": _tensors(cur, []), "static": _tensors(static, []),
                "carry": _tensors(tr.carry, []), "kept": kept}
        copies = {}
        for kind, k in plan:
            if kind != "hooks" and (kind, k) not in copies:
                copies[kind, k] = lies[kind][k].clone()
        return _rebuild(out, iter([lies[kind][k] if kind == "hooks" else copies[kind, k]
                                   for kind, k in plan]))

    cur = states
    for i in range(start, stop):
        with tracing.span("step"):
            units.run("warmup head", head)
            with tracing.timed("host_read.leapfrog_bounds"):  # the step's one host read
                n_max, n_min = bounds.tolist()
            tr.replay("warmup ", n_max, n_min)
            units.run("warmup tail", tail)
            post, infos = handed(cur)
            new = job.adapt(cur.position, post, infos, i, frac.clone() if shared else 1.0)
            # what the hooks replaced goes back into the units' state
            moved = [(d, n) for d, n, p in zip(_tensors(static, []), _tensors(new, []),
                                               _tensors(post, [])) if n is not p]
            _copy_into([d for d, _ in moved], [n for _, n in moved])
            cur = new
    return cur


# ------------------------------------------------------------------- Gibbs
def sweeps_capturable(job) -> bool:
    """True for a sweep of conjugate draws, transformations and update
    hooks alone, with no csv variable: ``GibbsJob`` runs it in captured
    blocks.  Nested blocks (a host read a nested step) and csv runs stay in
    the eager loop."""
    return job._ring is None and not any(v.key in job.sweep for v in job._dependents)


def sweep_blocks(job, values, stream, n_steps: int, buffers):
    """``n_steps`` conjugate sweeps from ``values`` in captured blocks, from
    ``stream`` at sweeps 0, 1, ...; the saved sweeps' monitored values go to
    ``buffers`` ({key: (n_post, C, ...) trace}).  Returns the final values:
    bit for bit those of ``GibbsJob``'s eager loop."""
    burnin, thinning = job.mcrange.burnin, job.mcrange.thinning
    carry = job._carry_keys()
    device = job._device_of(values)
    units = Units(device)
    block = SWEEPS_PER_BLOCK
    staging = Staging(block, units)
    static = {k: (v.clone() if k in carry else v) for k, v in values.items()}
    counter = torch.zeros((), dtype=torch.int64, device=device)

    def sweeps(n):
        vals = static
        for k in range(n):
            vals, _ = job._sweep(vals, None, {}, stream=stream, sweep=counter, step_add=k)
            staging.write(k, [(key, vals[key], buf.dtype) for key, buf in buffers.items()])
        counter.add_(n)
        _copy_into([static[k] for k in carry], [vals[k] for k in carry])

    for s in range(0, n_steps, block):
        n = min(block, n_steps - s)
        with tracing.span("block"):
            if units.run(n, lambda n=n: sweeps(n)):
                tracing.count("graphs.eager_steps", n)
            staging.drain(lambda key, buf: buffers[key], *saved_rows(s, n, burnin, thinning))
    return static
