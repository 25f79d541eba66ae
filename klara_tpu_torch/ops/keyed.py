"""Per-chain keyed random draws: kernel K2 and its plain PyTorch version.

The JAX package gives every chain a key of its own
(``jax.random.split(run_key, n_chains)``, klara_tpu/jobs/job.py and
jobs/gibbs.py) and folds the sweep and the block into it, so a device draws
only its own chains and a chain's numbers do not depend on how the chains
are split.  Here a draw is a pure function of the run key and a counter
that names the chain by its global index, so a rank draws exactly its own
chains, whatever the parameters of the draw.  K2 replaces no Pallas kernel:
it is the counterpart of those keys.

Generator: Philox4x32-10 (Salmon, Moraes, Dror & Shaw, "Parallel random
numbers: as easy as 1, 2, 3", SC'11), with the Random123 constants.  The key
is the run key, two 32-bit words: the low and the high half of one int64
drawn once per run from the run's ``torch.Generator`` (``run_key``; it stays
on the device, so no host read).  The counter is four words:

    c0 = the chain's global index
    c1 = the step (the MCJob step, the Gibbs sweep), mod 2^32: an int, or
         a 0-d int64 step on the device plus an int ``step_add`` (a
         captured block's k-th step reads the block's counter + k)
    c2 = site << 8 | part   (site < 2^24, below; part < 256: 0, or 1 for
                             the second gamma draw of a Beta)
    c3 = element << 12 | call   (element < 2^20: the index within the
                                 chain's draw; call < 2^12: the element's
                                 Philox call)

Distinct (chain, step, site, part, element, call) are distinct counters, so
no two numbers of a run share a (key, counter) pair.  The sites:

    [0, NESTED_SITES)           a Gibbs conditional block b at site b (and a
                                nested block's ``reset_from_prior`` start)
    [NESTED_SITES, JOB_SITES)   the windows of nested Gibbs blocks' samplers,
                                one window per nested step of a sweep
    [JOB_SITES, MH_SITE]        MCJob's window, its top ``MH_SITE``

A sampler draws at site = its stream's ``window`` − the draw's offset
(``KeyedStream.window_site``), so one sampler's code serves MCJob's window
and a nested block's.  The offsets, one draw each per step (a (C, ...) draw
whose element counter runs over the rest of its shape):

    PROPOSAL        0   the proposal: an MH proposal distribution (at
                        ``MH_SITE`` in MCJob, as before), the random-walk
                        or Langevin normal of MH, MALA, SMMALA, RAM, AM, ARS
    MOMENTUM        1   HMC's and NUTS's momentum
    ACCEPT          2   the accept uniform (C,)
    JITTER          3   HMC's per-chain jitter of the trajectory length (C,)
    NUTS_UNIFORMS   4   NUTS's slice, direction, swap and take uniforms as
                        one (C, 1 + 2J + 2^J − 1) draw
    SLICE_LEVEL     5   the slice sampler's (C, D) slice levels
    SLICE_INTERVAL  6   its (C, D) interval placements
    AM_COMPONENT    7   AM's mixture component (C,)
    AMWG_PROPOSAL   8   AMWG's (C, D) per-coordinate proposals
    AMWG_ACCEPT     9   AMWG's (C, D) per-coordinate accept uniforms
    INIT_MOMENTUM  10   the step-size search's momentum (at step 0)
    INIT_PRIOR     11   MCJob's start drawn from the prior (at step 0)
    SHARED_JITTER  12   MCJob's shared jitter: one (1,) uniform of global
                        chain 0, the same on every rank
    FIXED_SITES + i·K + k   the slice sampler's k-th shrink uniform (C,) of
                        coordinate i, K = ``max_shrinks`` (a data-dependent
                        loop: its index is in the site, not the part)

A sampler needs ``FIXED_SITES`` offsets, the slice sampler ``FIXED_SITES +
D·K`` (``Sampler.keyed_sites``); a job checks that its windows hold them.
A thread owns one element and makes the calls its own draw needs:

- uniform on (0, 1): call 0; f32 from the top 24 bits of word 0, f64 from
  53 bits of words 0-1 (27 + 26), a zero replaced by half the spacing;
- normal: Box-Muller, sqrt(-2 log u1) cos(2 pi u2), from call 0 (f32: words
  0 and 1; f64: words 0-1 and 2-3);
- standard gamma(a): Marsaglia & Tsang (ACM TOMS 2000) in the output type,
  attempt t from call 1 + t (f32: x from words 0-1, u from word 2) or calls
  1 + 2t and 2 + 2t (f64); for a < 1 the draw of gamma(a + 1) times
  exp(log(u)/a), u from call 0; the result at least the type's smallest
  normal number, as ``torch._standard_gamma`` and ``jax.random.gamma``
  return it;
- Poisson(lam), in f64: inversion below lam = 10 (attempt t: call t), and
  Hormann's PTRS (1993) at and above it (attempt t: call t, U from words
  0-1, V from words 2-3);
- binomial(n, p), in f64: p > 1/2 reflected to q = 1 - p; where n q < 10 the
  sum of geometric draws (uniform j from call j >> 1, words 0-1 or 2-3),
  else Hormann's BTRS (attempt t: call t).

n = 0 or p = 0 gives exactly 0 and p = 1 exactly n; an invalid parameter
gives NaN.  An element whose rejection loop reaches its cap
(``MAX_ATTEMPTS`` attempts, ``BINOMIAL_INV_MAX`` uniforms) is written as
NaN and counted in a counter on the device; ``raise_on_overflow`` reads it
(one host read, at the end of a run) and raises.  The plain version raises
at once.

The plain version (``draws_reference``) computes the same Philox words in
numpy's uint64 on the host (a 32 x 32 product is exact there) and the same
transforms in torch, in the same order of operations; it is what CPU
tensors take, and what ``chip_smoke.py`` holds the kernel to on the card.
Bound on the H100: the SASS instructions of its Philox calls and of the
cheap and slow tests its elements ran, each pipe at its rate
(``chip_smoke.py`` counts them from ``cuobjdump -sass`` of K2's own code
and weights them by a run's attempts), or its bytes, the larger.

A launch does on the host only what changes from launch to launch: a
stream checks its fields when it is made, what follows from a draw's
(chains, mode, shape, type, parameter layouts) is kept as integers
(``launch_args``), and the kernel takes one packed struct of arguments
(``_ARGS``) and the raw stream handle in one ctypes call.
"""

from __future__ import annotations

import ctypes
import math
import operator
import struct
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from klara_tpu_torch.ops import _build
from klara_tpu_torch.utils import tracing

UNIFORM, NORMAL, GAMMA, POISSON, BINOMIAL = range(5)
MODES = {"uniform": UNIFORM, "normal": NORMAL, "gamma": GAMMA, "poisson": POISSON,
         "binomial": BINOMIAL}
_MODE_NAMES = {v: k for k, v in MODES.items()}
MH_SITE = (1 << 24) - 1  # the top of MCJob's window: its MH proposal's site
NESTED_SITES = 1 << 20   # nested Gibbs blocks' windows start here (Gibbs blocks below)
JOB_SITES = 1 << 23      # MCJob's window starts here
# a sampler's draw offsets within its window (site = window − offset)
(PROPOSAL, MOMENTUM, ACCEPT, JITTER, NUTS_UNIFORMS, SLICE_LEVEL, SLICE_INTERVAL, AM_COMPONENT,
 AMWG_PROPOSAL, AMWG_ACCEPT, INIT_MOMENTUM, INIT_PRIOR, SHARED_JITTER) = range(13)
FIXED_SITES = 16         # the fixed offsets' room; the slice sampler's shrink draws follow
MAX_ATTEMPTS = 64        # rejection attempts: gamma, PTRS, BTRS, Poisson inversion restarts
POISSON_INV_MAX_K = 100  # an inversion search past k = 100 restarts
BINOMIAL_INV_MAX = 1024  # uniforms of one geometric-sum binomial draw
MAX_ELEMENTS = 1 << 20   # elements of one chain's draw
CALL_BITS = 12

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
_MULT = np.array([_M1, _M0], dtype=np.uint64)  # x's rows reversed: (c2, c0) times (M1, M0)
_ROUND_W = np.arange(10, dtype=np.uint64)[:, None] * np.array([_W0, _W1], dtype=np.uint64)
_MASK_U64, _U32 = np.uint64(_MASK), np.uint64(32)
_TWO_PI = 2.0 * math.pi

# the tracer's counts of K2 launches, in all and by mode, made only where
# the kernel is launched
_LAUNCHES = "ops.keyed.KERNEL_LAUNCHES"
_LAUNCHES_BY_MODE = {v: "ops.keyed.LAUNCHES_BY_MODE." + k for k, v in MODES.items()}


def __getattr__(name):
    """``KERNEL_LAUNCHES``, read-only: the tracer's count of K2 launches.
    It serves ``portbench/counters.py`` until that file reads the tracer."""
    if name == "KERNEL_LAUNCHES":
        return tracing.counters().get(_LAUNCHES, (0, 0))[0]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

_OVERFLOW = {}     # device -> int32 (1,) count of elements that hit their cap
_PENDING = set()   # devices with launches since the last raise_on_overflow


# ------------------------------------------------------------------ Philox
def _philox_rounds(x, y, k0: int, k1: int):
    """Philox4x32-10's ten rounds, in place, on the uint64 lanes x = (c0, c2)
    and y = (c1, c3), each a (2, ...) array of 32-bit words: a round's two
    32 x 32 products are one product of x's rows reversed with (M1, M0),
    exact in uint64 (hi = p >> 32, lo = p mod 2^32)."""
    ones = (1,) * (x.ndim - 1)
    mult = _MULT.reshape((2,) + ones)
    keys = (np.array([k0, k1], dtype=np.uint64) + _ROUND_W) & _MASK_U64
    p = np.empty_like(x)
    for r in range(10):
        np.multiply(x[::-1], mult, out=p)  # (c2·M1, c0·M0)
        # c0' = hi(c2·M1) ^ c1 ^ k0, c2' = hi(c0·M0) ^ c3 ^ k1, c1' = lo(c2·M1), c3' = lo(c0·M0)
        np.right_shift(p, _U32, out=x)
        x ^= y
        x ^= keys[r].reshape((2,) + ones)
        np.bitwise_and(p, _MASK_U64, out=y)


def _words(x, y, device):
    """(c0, c1, c2, c3) of the lanes as int64 tensors on ``device``."""
    w = torch.from_numpy(np.concatenate([x, y]).view(np.int64)).to(device)
    return w[0], w[2], w[1], w[3]


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of the counter words (ints or int64 tensors holding
    32-bit words, broadcast together) under the key words ``k0``, ``k1``
    (ints or 0-d tensors): four int64 tensors on the counter tensors'
    device, computed in numpy's uint64 on the host (``_philox_rounds``)."""
    device = next((c.device for c in (c0, c1, c2, c3) if torch.is_tensor(c) and c.dim()),
                  torch.device("cpu"))
    c0, c1, c2, c3 = np.broadcast_arrays(*(
        np.asarray(c.cpu() if torch.is_tensor(c) else c, dtype=np.int64).astype(np.uint64)
        for c in (c0, c1, c2, c3)))
    x, y = np.stack([c0, c2]), np.stack([c1, c3])
    _philox_rounds(x, y, int(k0), int(k1))
    return _words(x, y, device)


def _u01f(w):
    """f32 on (0, 1) from the top 24 bits of a word."""
    return ((w >> 8).to(torch.float32) * 2.0**-24).clamp_min(2.0**-25)


def _u01d(a, b):
    """f64 on (0, 1) from 53 bits of two words."""
    m = ((a >> 5) << 26) | (b >> 6)
    return (m.to(torch.float64) * 2.0**-53).clamp_min(2.0**-54)


def _normal(w, f64: bool):
    """Box-Muller's cosine branch from one call's words."""
    if f64:
        u1, u2 = _u01d(w[0], w[1]), _u01d(w[2], w[3])
    else:
        u1, u2 = _u01f(w[0]), _u01f(w[1])
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(u2 * _TWO_PI)


def _uniform(w, f64: bool):
    return _u01d(w[0], w[1]) if f64 else _u01f(w[0])


def _rdiv(s: float, t):
    """s / t in one rounding, as the kernel divides (``s / t`` on a tensor
    is ``t.reciprocal() * s``, two roundings)."""
    return torch.full_like(t, s) / t


def _same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def check_device(what, device, stream_device) -> None:
    """Raise unless ``device`` is ``stream_device``: keyed draws never move
    their inputs between the host and the card."""
    if not _same_device(device, stream_device):
        raise ValueError(f"keyed draws: {what} is on {device}, the draws on {stream_device}")


def run_key(generator, device):
    """A run key: one int64 (both key words) drawn from ``generator`` (None:
    the device's default generator) on ``device``, kept there.  A generator
    on another device raises."""
    if generator is not None:
        check_device("the generator", generator.device, device)
    return torch.randint(-2**63, 2**63 - 1, (), dtype=torch.int64, generator=generator,
                         device=device)


# ------------------------------------------------------------------ stream
_SAME = object()  # ``KeyedStream.at``: keep the field


class KeyedStream:
    """Keyed draws for ``chains`` chains whose first has the global index
    ``offset``, at counter (``step``, ``site``, ``part``).  ``key`` is a 0-d
    int64 tensor (``run_key``) on the draws' device; ``step`` a number or a
    0-d int64 tensor on that device, to which ``at(step_add=)`` adds an
    int: counter word 1 is (step + step_add) mod 2^32, a tensor step read
    by the kernel at each launch.  Every draw's shape has the chains on
    axis 0; the element counter runs over the rest of it.  ``window`` is the
    top site of a sampler's draws (``window_site``): MCJob's, ``MH_SITE``,
    unless a nested Gibbs block names its own.

    A stream is immutable and checks its fields once, when it is made:
    whatever its counter cannot name raises here (and in ``at``), not at a
    draw.  It keeps the counter words its fields give (the site word, an
    int step's word), so that a launch only reads them."""

    __slots__ = ("_key", "_chains", "_offset", "_step", "_site", "_part", "_device",
                 "_site_word", "_step_add", "_step_tensor", "_window")

    def __init__(self, key, chains: int, offset: int = 0, step: Any = 0, site: int = 0,
                 part: int = 0, window: int = MH_SITE):
        if not (torch.is_tensor(key) and key.dtype == torch.int64 and key.numel() == 1):
            raise ValueError("keyed draws: the run key is a 0-d int64 tensor (run_key)")
        self._key, self._device = key, key.device
        self._set_chains(chains, offset)
        self._set_step(step)
        self._set_site(site, part)
        self._set_window(window)

    @classmethod
    def for_run(cls, generator, device, chains: int, offset: int = 0):
        """A stream on ``device`` keyed by a fresh run key from ``generator``
        (which must be on ``device``)."""
        return cls(run_key(generator, device), chains, offset)

    key = property(lambda self: self._key)
    chains = property(lambda self: self._chains)
    offset = property(lambda self: self._offset)
    step = property(lambda self: self._step)
    # the int added to the step: counter word 1 is step_add alone for an int step
    step_add = property(lambda self: self._step_add)
    site = property(lambda self: self._site)
    part = property(lambda self: self._part)
    device = property(lambda self: self._device)
    window = property(lambda self: self._window)

    def __repr__(self):
        return (f"KeyedStream(chains={self._chains}, offset={self._offset}, step={self._step!r}, "
                f"step_add={self._step_add}, site={self._site}, part={self._part}, "
                f"window={self._window}, "
                f"device={self._device})")

    def _set_chains(self, chains, offset):
        chains, offset = operator.index(chains), operator.index(offset)
        if chains < 0 or offset < 0 or offset + chains > 2**32:
            raise ValueError(f"keyed draws: chains [{offset}, {offset + chains}) out of range")
        self._chains, self._offset = chains, offset

    def _set_step(self, step, step_add=0):
        step_add = operator.index(step_add)
        if torch.is_tensor(step):
            check_device("the step", step.device, self._device)
            if step.dtype != torch.int64 or step.numel() != 1:
                raise ValueError("keyed draws: a tensor step is a 0-d int64 on the stream's "
                                 "device")
            self._step_tensor, self._step_add = step, step_add & _MASK
        else:
            self._step_tensor, self._step_add = None, (operator.index(step) + step_add) & _MASK
        self._step = step

    def _set_site(self, site, part):
        site, part = operator.index(site), operator.index(part)
        if not 0 <= site <= MH_SITE or not 0 <= part < 256:
            raise ValueError(f"keyed draws: site {site} or part {part} out of range")
        self._site, self._part, self._site_word = site, part, (site << 8) | part

    def _set_window(self, window):
        window = operator.index(window)
        if not 0 <= window <= MH_SITE:
            raise ValueError(f"keyed draws: window {window} out of range")
        self._window = window

    def at(self, *, step=_SAME, step_add=_SAME, site=_SAME, part=_SAME, chains=_SAME,
           offset=_SAME, window=_SAME):
        """The stream at another ``step``, ``site``, ``part``, chain count,
        offset or window; the other fields kept (and not checked again).  A
        new ``step`` comes with ``step_add`` 0 unless one is given; a
        ``step_add`` alone keeps the step (a tensor step: a block's counter)."""
        new = object.__new__(KeyedStream)
        new._key, new._device = self._key, self._device
        if window is _SAME:
            new._window = self._window
        else:
            new._set_window(window)
        if chains is _SAME and offset is _SAME:
            new._chains, new._offset = self._chains, self._offset
        else:
            new._set_chains(self._chains if chains is _SAME else chains,
                            self._offset if offset is _SAME else offset)
        if step is _SAME and step_add is _SAME:
            new._step, new._step_add, new._step_tensor = (self._step, self._step_add,
                                                          self._step_tensor)
        elif step is _SAME:
            new._set_step(self._step, step_add)
        else:
            new._set_step(step, 0 if step_add is _SAME else step_add)
        if site is _SAME and part is _SAME:
            new._site, new._part, new._site_word = self._site, self._part, self._site_word
        else:
            new._set_site(self._site if site is _SAME else site,
                          self._part if part is _SAME else part)
        return new

    def window_site(self, offset: int):
        """The stream at a sampler's draw ``offset``: site = window − offset,
        part 0 (the table in the module's docstring)."""
        return self.at(site=self._window - offset, part=0)

    def uniform(self, shape, dtype=torch.float32):
        return draws(self, UNIFORM, shape, dtype)[0]

    def normal(self, shape, dtype=torch.float32):
        return draws(self, NORMAL, shape, dtype)[0]

    def standard_gamma(self, alpha, shape, dtype=torch.float32):
        return draws(self, GAMMA, shape, dtype, alpha)[0]

    def poisson(self, rate, shape, dtype=torch.float32):
        return draws(self, POISSON, shape, dtype, rate)[0]

    def binomial(self, count, prob, shape, dtype=torch.float32):
        return draws(self, BINOMIAL, shape, dtype, count, prob)[0]


def _counter(stream: KeyedStream, shape, dtype, params=()):
    shape = tuple(int(s) for s in shape)
    for p in params:
        if torch.is_tensor(p):
            check_device("a parameter", p.device, stream.device)
    if torch.is_tensor(stream.step):
        check_device("the step", stream.step.device, stream.device)
    if not shape or shape[0] != stream.chains:
        raise ValueError(f"keyed draw of shape {shape}: axis 0 is not the stream's "
                         f"{stream.chains} chains")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"keyed draws are float32 or float64, not {dtype}")
    elems = math.prod(shape[1:])
    if elems >= MAX_ELEMENTS:
        raise ValueError(f"keyed draw of {elems} elements per chain: at most {MAX_ELEMENTS - 1}")
    if not 0 <= stream.site < MH_SITE + 1 or not 0 <= stream.part < 256:
        raise ValueError(f"site {stream.site} or part {stream.part} out of range")
    if stream.offset < 0 or stream.offset + stream.chains > 2**32:
        raise ValueError(f"chains [{stream.offset}, {stream.offset + stream.chains}) out of range")
    return shape, elems, (stream.site << 8) | stream.part


def _flat_param(p, shape, dtype, device, work=None):
    """A parameter (on ``device``) broadcast to ``shape``, flat, in ``dtype``
    (the kernel's parameter type), then in ``work`` (the type it computes
    in)."""
    if torch.is_tensor(p):
        t = p.to(dtype).expand(shape).reshape(-1)
    else:
        t = torch.full(shape, float(p), dtype=dtype, device=device).reshape(-1)
    return t if work is None else t.to(work)


# ----------------------------------------------------------- plain version
class _Ctx:
    """The words of the elements ``idx`` (flat indices) at a call."""

    def __init__(self, stream, elems, site_word):
        key = int(stream.key)  # on the card a host read: the plain version is no path's
        self.k0, self.k1 = key & _MASK, (key >> 32) & _MASK
        step = stream._step_tensor
        self.c1 = (stream._step_add + (0 if step is None else int(step))) & _MASK
        self.c2, self.elems, self.offset = site_word, elems, stream.offset

    def words(self, idx, call):
        i = idx.cpu().numpy()
        x = np.empty((2,) + i.shape, dtype=np.uint64)
        y = np.empty_like(x)
        x[0] = self.offset + i // self.elems
        x[1] = self.c2
        y[0] = self.c1
        y[1] = ((i % self.elems) << CALL_BITS) | call
        _philox_rounds(x, y, self.k0, self.k1)
        return _words(x, y, idx.device)


def draws_reference(stream: KeyedStream, mode, shape, dtype, p0=None, p1=None):
    """The plain PyTorch version of K2: ``(values, calls, overflow)``, with
    ``calls`` (int32, the draw's shape) the number of Philox calls each
    element used (its call indices run below it; 0 for a parameter that
    needs none, -1 where the cap was reached) and ``overflow`` the count of
    such elements."""
    shape, elems, site_word = _counter(stream, shape, dtype, (p0, p1))
    device, n = stream.device, math.prod(shape)
    ctx = _Ctx(stream, elems, site_word)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    f64 = dtype == torch.float64
    calls = torch.ones(n, dtype=torch.int32, device=device)
    if mode in (UNIFORM, NORMAL):
        w = ctx.words(idx, 0)
        out = _uniform(w, f64) if mode == UNIFORM else _normal(w, f64)
        return out.reshape(shape), calls.reshape(shape), 0
    if mode == GAMMA:
        out = _gamma_ref(ctx, _flat_param(p0, shape, dtype, device), f64, calls)
    elif mode == POISSON:
        out = _poisson_ref(ctx, _flat_param(p0, shape, dtype, device, torch.float64), calls)
    elif mode == BINOMIAL:
        out = _binomial_ref(ctx, _flat_param(p0, shape, dtype, device, torch.float64),
                            _flat_param(p1, shape, dtype, device, torch.float64), calls)
    else:
        raise ValueError(f"unknown keyed-draw mode {mode}")
    return out.to(dtype).reshape(shape), calls.reshape(shape), int((calls < 0).sum())


def _gamma_ref(ctx, a, f64, calls):
    dt = a.dtype
    out = torch.full_like(a, math.nan)
    valid = (a > 0) & torch.isfinite(a)
    calls.masked_fill_(~valid, 0)
    boost = a < 1
    aa = torch.where(boost, a + 1.0, a)
    d = aa - 1.0 / 3.0
    c = _rdiv(1.0, torch.sqrt(9.0 * d))
    per = 2 if f64 else 1
    idx = valid.nonzero().squeeze(1)
    for t in range(MAX_ATTEMPTS):
        if idx.numel() == 0:
            break
        w = ctx.words(idx, 1 + per * t)
        x = _normal(w, f64)
        u = _u01d(*ctx.words(idx, 2 + 2 * t)[:2]) if f64 else _u01f(w[2])
        di, ci = d[idx], c[idx]
        y = 1.0 + ci * x
        v = y * y * y
        xx = x * x
        ok = (y > 0) & ((u < 1.0 - 0.0331 * xx * xx)
                        | (torch.log(u) < 0.5 * xx + di * (1.0 - v + torch.log(v))))
        acc = idx[ok]
        out[acc] = (di * v)[ok]
        calls[acc] = 1 + per * (t + 1)
        idx = idx[~ok]
    calls[idx] = -1
    lift = (boost & valid & (calls > 0)).nonzero().squeeze(1)
    if lift.numel():
        ub = _uniform(ctx.words(lift, 0), f64)
        out[lift] = out[lift] * torch.exp(torch.log(ub) / a[lift])
    done = calls > 0
    out[done] = out[done].clamp_min(torch.finfo(dt).tiny)
    return out


def _poisson_ref(ctx, lam, calls):
    out = torch.full_like(lam, math.nan)
    valid = (lam >= 0) & torch.isfinite(lam)
    calls.masked_fill_(~valid | (lam == 0), 0)
    out[valid & (lam == 0)] = 0.0
    small = (valid & (lam > 0) & (lam < 10)).nonzero().squeeze(1)
    for t in range(MAX_ATTEMPTS):
        if small.numel() == 0:
            break
        w = ctx.words(small, t)
        u, L = _u01d(w[0], w[1]), lam[small]
        p = torch.exp(-L)
        F, k = p.clone(), torch.zeros_like(p)
        search = u > F
        for _ in range(POISSON_INV_MAX_K):
            if not bool(search.any()):
                break
            k = torch.where(search, k + 1.0, k)
            p = torch.where(search, p * L / k, p)
            F = torch.where(search, F + p, F)
            search = search & (u > F)
        ok = u <= F
        out[small[ok]] = k[ok]
        calls[small[ok]] = t + 1
        small = small[~ok]
    calls[small] = -1

    big = (valid & (lam >= 10)).nonzero().squeeze(1)
    L = lam[big]
    slam, loglam = torch.sqrt(L), torch.log(L)
    b = 0.931 + 2.53 * slam
    a = -0.059 + 0.02483 * b
    invalpha = 1.1239 + _rdiv(1.1328, b - 3.4)
    vr = 0.9277 - _rdiv(3.6224, b - 2.0)
    for t in range(MAX_ATTEMPTS):
        if big.numel() == 0:
            break
        w = ctx.words(big, t)
        U, V = _u01d(w[0], w[1]) - 0.5, _u01d(w[2], w[3])
        us = 0.5 - torch.abs(U)
        k = torch.floor((2.0 * a / us + b) * U + L + 0.43)
        quick = (us >= 0.07) & (V <= vr)
        bad = (k < 0) | ((us < 0.013) & (V > us))
        ok = quick | (~bad & (torch.log(V) + torch.log(invalpha) - torch.log(a / (us * us) + b)
                              <= -L + k * loglam - torch.lgamma(k + 1.0)))
        out[big[ok]] = k[ok]
        calls[big[ok]] = t + 1
        keep = ~ok
        big, L, loglam, a, b, invalpha, vr = (v[keep] for v in (big, L, loglam, a, b, invalpha,
                                                                 vr))
    calls[big] = -1
    return out


_STIRLING_TAIL = (0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
                  0.02079067210376509, 0.0166446911898211, 0.0138761288230707,
                  0.0118967099458917, 0.0104112652619720, 0.00925546218271273,
                  0.00833056343336287)


def _stirling_tail(k):
    """log k! − (k + ½) log(k + 1) + (k + 1) − ½ log 2π, tabulated to 9."""
    table = torch.tensor(_STIRLING_TAIL, dtype=k.dtype, device=k.device)
    kp1sq = (k + 1.0) * (k + 1.0)
    series = (1.0 / 12 - (1.0 / 360 - _rdiv(1.0 / 1260, kp1sq)) / kp1sq) / (k + 1.0)
    return torch.where(k <= 9, table[k.clamp(0, 9).long()], series)


def _binomial_ref(ctx, n, p, calls):
    out = torch.full_like(n, math.nan)
    valid = (n >= 0) & torch.isfinite(n) & (p >= 0) & (p <= 1)
    trivial = valid & ((n == 0) | (p == 0) | (p == 1))
    calls.masked_fill_(~valid | trivial, 0)
    out[trivial] = torch.where(p == 1, n, torch.zeros_like(n))[trivial]
    rest = valid & ~trivial
    flip = p > 0.5
    q = torch.where(flip, 1.0 - p, p)
    k_out = torch.zeros_like(n)

    idx = (rest & (n * q < 10.0)).nonzero().squeeze(1)
    logq, N = torch.log1p(-q[idx]), n[idx]
    gsum, k = torch.zeros_like(N), torch.zeros_like(N)
    for j in range(BINOMIAL_INV_MAX):
        if idx.numel() == 0:
            break
        w = ctx.words(idx, j >> 1)
        u = _u01d(w[2], w[3]) if j & 1 else _u01d(w[0], w[1])
        gsum = gsum + torch.ceil(torch.log(u) / logq)
        done = gsum > N
        k_out[idx[done]] = k[done]
        calls[idx[done]] = (j >> 1) + 1
        keep = ~done
        idx, logq, N, gsum, k = idx[keep], logq[keep], N[keep], gsum[keep], k[keep] + 1.0
    calls[idx] = -1

    idx = (rest & (n * q >= 10.0)).nonzero().squeeze(1)
    N, Q = n[idx], q[idx]
    stddev = torch.sqrt(N * Q * (1.0 - Q))
    b = 1.15 + 2.53 * stddev
    a = -0.0873 + 0.0248 * b + 0.01 * Q
    c = N * Q + 0.5
    v_r = 0.92 - _rdiv(4.2, b)
    r = Q / (1.0 - Q)
    alpha = (2.83 + _rdiv(5.1, b)) * stddev
    m = torch.floor((N + 1.0) * Q)
    for t in range(MAX_ATTEMPTS):
        if idx.numel() == 0:
            break
        w = ctx.words(idx, t)
        u, v = _u01d(w[0], w[1]) - 0.5, _u01d(w[2], w[3])
        us = 0.5 - torch.abs(u)
        k = torch.floor((2.0 * a / us + b) * u + c)
        quick = (us >= 0.07) & (v <= v_r)
        bad = (k < 0) | (k > N)
        lv = torch.log(v * alpha / (a / (us * us) + b))
        upper = ((m + 0.5) * torch.log((m + 1.0) / (r * (N - m + 1.0)))
                 + (N + 1.0) * torch.log((N - m + 1.0) / (N - k + 1.0))
                 + (k + 0.5) * torch.log(r * (N - k + 1.0) / (k + 1.0))
                 + _stirling_tail(m) + _stirling_tail(N - m)
                 - _stirling_tail(k) - _stirling_tail(N - k))
        ok = quick | (~bad & (lv <= upper))
        k_out[idx[ok]] = k[ok]
        calls[idx[ok]] = t + 1
        keep = ~ok
        idx, N, a, b, c, v_r, r, alpha, m = (x[keep] for x in (idx, N, a, b, c, v_r, r, alpha, m))
    calls[idx] = -1

    drawn = rest & (calls > 0)
    out[drawn] = torch.where(flip, n - k_out, k_out)[drawn]
    return out


# ------------------------------------------------------------------ kernel
# K2's launch arguments, packed as its entry point reads them (``struct Args``
# in csrc/keyed_draws.cu): pointers (0: none), the scalar parameters, the
# parameter strides (chain, element; in elements), the counter words (step,
# site << 8 | part, the first chain's index), the draw's chains and elements
# per chain, the mode, the type (f64) and the device index
ARG_FIELDS = ("out", "calls", "overflow", "key", "step", "p0", "p1", "s0", "s1", "p0c", "p0e",
              "p1c", "p1e", "step_add", "site_word", "offset", "chains", "elems", "mode", "f64",
              "device")
_ARGS = struct.Struct("<7Q2d4q3I5i")
_PLANS = {}        # (chains, mode, shape, dtype, layouts) -> _Plan: integers only
_MAX_PLANS = 4096
_SCALAR = "scalar"
_NO_PARAM = (None, 0.0, 0, 0)
_launch = None     # K2's ctypes entry point, once loaded
_raw_stream = None  # torch's raw current-stream handle of a device index


class _Plan(NamedTuple):
    shape: tuple
    elems: int
    p0: tuple  # (convert to the draw's type, copy contiguous, chain stride, element stride)
    p1: tuple


def _layout(p):
    if isinstance(p, torch.Tensor):
        return p.dtype, p.shape, p.stride()
    return _SCALAR


def _param_plan(p, shape, dtype):
    """How the kernel reads a parameter broadcast to ``shape`` (C, ...): a
    view where its non-chain axes collapse to one stride, else a contiguous
    copy; in the draw's type."""
    if not torch.is_tensor(p):
        return None
    convert = p.dtype != dtype
    t = p.to(dtype).expand(shape)
    sc = t.stride(0) if shape[0] > 1 else 0
    dims = [(n, s) for n, s in zip(t.shape[1:], t.stride()[1:]) if n > 1]
    if all(s0 == s1 * n1 for (_, s0), (n1, s1) in zip(dims, dims[1:])):
        return (convert, False, sc, dims[-1][1] if dims else 0)
    return (convert, True, math.prod(shape[1:]) if shape[0] > 1 else 0, 1)


def _make_plan(chains, mode, shape, dtype, p0, p1):
    shape = tuple(int(s) for s in shape)
    if not shape or shape[0] != chains:
        raise ValueError(f"keyed draw of shape {shape}: axis 0 is not the stream's "
                         f"{chains} chains")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"keyed draws are float32 or float64, not {dtype}")
    if mode not in _MODE_NAMES:
        raise ValueError(f"unknown keyed-draw mode {mode}")
    elems = math.prod(shape[1:])
    if elems >= MAX_ELEMENTS:
        raise ValueError(f"keyed draw of {elems} elements per chain: at most {MAX_ELEMENTS - 1}")
    return _Plan(shape, elems, _param_plan(p0, shape, dtype), _param_plan(p1, shape, dtype))


def _param(p, plan, shape, dtype, device):
    """(tensor or None, scalar, chain stride, element stride) of one
    launch; a tensor's device is checked at every launch."""
    if not isinstance(p, torch.Tensor):
        return None, float(p), 0, 0
    if p.device != device:
        check_device("a parameter", p.device, device)
    convert, copy, sc, se = plan
    if convert:
        p = p.to(dtype)
    if copy:
        p = p.expand(shape).contiguous()
    return p, 0.0, sc, se


def launch_args(stream: KeyedStream, mode, shape, dtype, p0=None, p1=None):
    """``(shape, tensors, fields)`` of one K2 launch (a pure function of its
    inputs; the CPU tests call it): the draw's shape, the parameter tensors
    the kernel reads (a converted or copied parameter is a new tensor, kept
    alive until the launch), and the launch struct's fields after ``out``
    and ``calls`` (``ARG_FIELDS[2:]``).  What follows from (chains, mode,
    shape, dtype, the parameters' types and layouts) is worked out once and
    kept as integers; the tensors' pointers and devices are read at every
    launch."""
    if type(shape) is not tuple:
        shape = tuple(shape)
    # a Python float (the common scalar) takes no call
    key = (stream._chains, mode, shape, dtype,
           None if p0 is None else _SCALAR if type(p0) is float else _layout(p0),
           None if p1 is None else _SCALAR if type(p1) is float else _layout(p1))
    plan = _PLANS.get(key)
    if plan is None:
        plan = _make_plan(stream._chains, mode, shape, dtype, p0, p1)
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        _PLANS[key] = plan
    device = stream._device
    t0, s0, c0, e0 = (_NO_PARAM if p0 is None else (None, p0, 0, 0) if type(p0) is float
                      else _param(p0, plan.p0, plan.shape, dtype, device))
    t1, s1, c1, e1 = (_NO_PARAM if p1 is None else (None, p1, 0, 0) if type(p1) is float
                      else _param(p1, plan.p1, plan.shape, dtype, device))
    step, overflow = stream._step_tensor, _OVERFLOW.get(device)
    if overflow is None:
        overflow = overflow_counter(device)
    return plan.shape, (t0, t1), (
        overflow.data_ptr(), stream._key.data_ptr(), 0 if step is None else step.data_ptr(),
        0 if t0 is None else t0.data_ptr(), 0 if t1 is None else t1.data_ptr(), s0, s1, c0, e0,
        c1, e1, stream._step_add, stream._site_word, stream._offset, stream._chains, plan.elems,
        mode, dtype is torch.float64, device.index)


def overflow_counter(device) -> torch.Tensor:
    """The device's count of elements that reached their cap (int32 (1,))."""
    count = _OVERFLOW.get(device)
    if count is None:
        device = torch.device(device)
        if device not in _OVERFLOW:
            _OVERFLOW[device] = torch.zeros(1, dtype=torch.int32, device=device)
        count = _OVERFLOW[device]
    return count


def raise_on_overflow() -> None:
    """One host read per device with K2 launches since the last call: raise
    if an element reached the cap of its rejection loop (and reset)."""
    while _PENDING:
        count = overflow_counter(_PENDING.pop())
        with tracing.timed("host_read.overflow"):
            n = int(count[0])
        if n:
            count.zero_()
            raise RuntimeError(f"keyed draws: {n} element(s) reached the cap of their "
                               "rejection loop (written as NaN)")


def _load():
    """K2's entry point and torch's raw-stream query, at the first launch."""
    global _launch, _raw_stream
    _launch = _build.load("keyed_draws").klara_keyed_draws
    _raw_stream = torch._C._cuda_getCurrentRawStream
    return _launch


def kernel_info(mode, dtype) -> dict:
    """K2's kernel for (mode, dtype) on the current device, as built:
    registers and local (spill) bytes a thread, static shared bytes and
    threads a block, blocks resident on an SM."""
    info = (ctypes.c_int * 5)()
    rc = _build.load("keyed_draws").klara_keyed_draws_info(
        mode, int(dtype == torch.float64), ctypes.addressof(info))
    if rc != 0:
        raise RuntimeError(f"K2 kernel info failed: cudaError {rc}")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "threads", "blocks_per_sm"),
                    info))


def draws(stream: KeyedStream, mode, shape, dtype, p0=None, p1=None, want_calls=False):
    """``(values, calls or None)`` of one keyed draw.  CUDA streams launch
    K2 on the device's current stream: the output allocated on the key's
    device, the arguments packed (``launch_args``), one ctypes call, no
    synchronisation (the overflow counter stays on the device).  CPU
    streams take ``draws_reference`` and raise at once if an element
    reached its cap.  A tensor parameter or step on another device than the
    stream's key raises on either path.  The call's host time goes to the
    tracer's ``k2.host_ns``."""
    t0 = time.perf_counter_ns()
    if stream._device.type == "cpu":
        out, calls, overflow = draws_reference(stream, mode, shape, dtype, p0, p1)
        tracing.add("k2.host_ns", time.perf_counter_ns() - t0)
        if overflow:
            raise RuntimeError(f"keyed draws: {overflow} element(s) reached the cap of "
                               "their rejection loop")
        return out, calls if want_calls else None
    shape, _tensors, fields = launch_args(stream, mode, shape, dtype, p0, p1)
    key = stream._key
    out = key.new_empty(shape, dtype=dtype)
    calls = key.new_empty(shape, dtype=torch.int32) if want_calls else None
    rc = (_launch or _load())(_ARGS.pack(out.data_ptr(), 0 if calls is None else calls.data_ptr(),
                                         *fields), _raw_stream(fields[-1]))
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    tracing.count(_LAUNCHES)
    tracing.count(_LAUNCHES_BY_MODE[mode])
    _PENDING.add(stream._device)
    tracing.add("k2.host_ns", time.perf_counter_ns() - t0)
    return out, calls
