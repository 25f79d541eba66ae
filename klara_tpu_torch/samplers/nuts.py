"""No-U-Turn Sampler, batch-first (counterpart of klara_tpu/samplers/nuts.py).

The Hoffman-Gelman (2014) slice-variable NUTS of Klara, with the JAX
package's two tree forms, each run for the whole (C, D) batch of chains:

  * ``'static'`` (the ``'auto'`` choice for max_doublings <= 6): the doubling
    loop and every subtree are unrolled in Python into 2^max_doublings − 1
    leapfrog steps on the whole batch.  A (C,) ``alive`` mask threads
    through the leaves in visit order, so a chain's leaves after its
    divergence or u-turn stop contributing; u-turn checks are (C,) dot
    products at the recursion's merge nodes.  The step reads nothing back
    from the device.
  * ``'looped'``: each doubling's subtree runs its 2^j leaves for the
    batch with a popcount-indexed checkpoint stack (S, C, D) of even
    leaves, S = max_doublings + 1, stored in ``ckpt_dtype``.  Every chain
    sits at the same leaf index, so slots and u-turn pairs are Python
    integers and the stack is written by plain slice assignment.  The
    doubling loop stops when no chain is alive, with one host read per
    doubling after the first.

The random draws of a step may be passed in (``NUTSDraws``) to replay
another package's stream; by default they are keyed draws (two: the
momentum, and every uniform of the step in one (C, 1 + 2J + 2^J − 1) draw),
which both tree forms read alike.  Where
an arithmetic result decides a discrete outcome (leaf take, doubling swap,
divergence, the slice) the JAX package's f32 formula is copied.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from klara_tpu_torch.models.graph import chain_sum
from klara_tpu_torch.ops.keyed import NUTS_UNIFORMS
from klara_tpu_torch.samplers.base import Info, Sampler, chain_view, draw_uniform, step_stream
from klara_tpu_torch.samplers.hamiltonian import (
    PhasePoint,
    hamiltonian,
    init_tune,
    leapfrog_step,
    sample_momentum,
)
from klara_tpu_torch.tuners.tuners import TuneState


class NUTSState(NamedTuple):
    position: torch.Tensor       # (C, D); any per-chain rank works: (C,), (C, A, B)
    logtarget: torch.Tensor      # (C,)
    gradlogtarget: torch.Tensor  # as position
    inv_mass: torch.Tensor       # as position: diagonal inverse mass (1 = identity)
    tune: TuneState


class _Candidate(NamedTuple):
    position: torch.Tensor
    logtarget: torch.Tensor
    gradlogtarget: torch.Tensor


class NUTSDraws(NamedTuple):
    """The random draws of one step, per chain.  ``take_u`` holds doubling
    j's leaves, in visit order, at rows 2^j − 1 … 2^(j+1) − 2."""

    momentum: torch.Tensor   # (C, D)
    slice_u: torch.Tensor    # (C,) U(0, 1); the log-slice is log(u) + H0
    direction: torch.Tensor  # (J, C) bool, True: forward
    swap_u: torch.Tensor     # (J, C)
    take_u: torch.Tensor     # (2^J − 1, C)


def _where(mask, new, old):
    """Per-chain select between two NamedTuples of (C, ...) tensors."""
    return type(new)(*(
        torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)
        for a, b in zip(new, old)
    ))


def _cand(z) -> _Candidate:
    return _Candidate(z.position, z.logtarget, z.gradlogtarget)


def _nan_to_neg_inf(h):
    return torch.where(torch.isnan(h), -torch.inf, h)


def _turn(pos_hi, mom_hi, pos_lo, mom_lo, v, inv_mass):
    """U-turn criterion between trajectory-ordered ends, per chain (C,);
    ``v`` is the (C,) build direction or the float 1.0.  With a diagonal
    mass the criterion uses velocities M⁻¹p."""
    d = (chain_view(v, pos_hi) if torch.is_tensor(v) else v) * (pos_hi - pos_lo)
    return (chain_sum(d * (inv_mass * mom_hi)) < 0.0) | (
        chain_sum(d * (inv_mass * mom_lo)) < 0.0
    )


def _accept_prob(h, h0):
    return torch.clamp_max(torch.exp(torch.clamp_max(h - h0, 0.0)), 1.0)


@dataclasses.dataclass(frozen=True)
class NUTS(Sampler):
    leapstep: float = 0.1
    maxdelta: float = 1000.0
    max_doublings: int = 5
    # storage dtype of the looped tree's checkpoint stack; the u-turn dot
    # products still reduce in f32 (see the JAX package's caveat)
    ckpt_dtype: str = "float32"
    # 'static' | 'looped' | 'auto' (static for max_doublings <= 6)
    tree_impl: str = "auto"

    tuner_statistic = "accept_stat"

    def __post_init__(self):
        if self.tree_impl not in ("auto", "static", "looped"):
            raise ValueError(
                f"tree_impl must be 'auto', 'static' or 'looped', "
                f"got {self.tree_impl!r}"
            )
        if not isinstance(getattr(torch, self.ckpt_dtype, None), torch.dtype):
            raise ValueError(f"unknown ckpt_dtype {self.ckpt_dtype!r}")

    def _use_static(self):
        if self.tree_impl == "auto":
            return self.max_doublings <= 6
        return self.tree_impl == "static"

    def init(self, target, position, generator=None, step_size=None, tuner=None,
             momentum=None, stream=None):
        """``momentum`` feeds the step-size search (tests replay draws)."""
        lt, grad = target.logdensity_and_grad(position)
        tune = init_tune(tuner or self.default_tuner(), target, position, self.leapstep,
                         generator, step_size, momentum, stream)
        return NUTSState(position, lt, grad, torch.ones_like(position), tune)

    def draws(self, generator, state: NUTSState, stream=None) -> NUTSDraws:
        """One step's draws from ``stream`` (``step_stream``: else from one
        keyed from ``generator``): the momentum at its ``MOMENTUM`` site and
        the slice, direction, swap and take uniforms as the columns of one
        (C, 1 + 2J + 2^J − 1) draw at ``NUTS_UNIFORMS``."""
        x = state.position
        stream = step_stream(stream, generator, x)
        J, C = self.max_doublings, x.shape[0]
        u = draw_uniform(stream, NUTS_UNIFORMS, (C, 2 * J + (1 << J)), x).T.contiguous()
        return NUTSDraws(
            momentum=sample_momentum(stream, x, state.inv_mass),
            slice_u=u[0],
            direction=u[1:1 + J] < 0.5,
            swap_u=u[1 + J:1 + 2 * J],
            take_u=u[1 + 2 * J:],
        )

    # --------------------------------------------------------------- step
    def step(self, state: NUTSState, target, generator=None, draws=None, stream=None):
        """One NUTS transition for every chain; ``draws`` may be given to
        replay another stream."""
        if draws is None:
            draws = self.draws(generator, state, stream)
        if self._use_static():
            return self._step_static(state, target, draws)
        return self._step_looped(state, target, draws)

    @staticmethod
    def _start(state: NUTSState, draws: NUTSDraws):
        """The initial phase point, H0 and the log-slice u = log(rand()) + H0
        (iterate/NUTS.jl:261)."""
        h0 = hamiltonian(state.logtarget, draws.momentum, state.inv_mass)
        u = torch.log(draws.slice_u) + h0
        z0 = PhasePoint(state.position, draws.momentum, state.logtarget,
                        state.gradlogtarget)
        return z0, h0, u

    @staticmethod
    def _result(state: NUTSState, cand, updated, ndoubl, a, na, div):
        new_state = state._replace(
            position=cand.position, logtarget=cand.logtarget,
            gradlogtarget=cand.gradlogtarget,
        )
        info = Info(
            accept=updated,
            accept_stat=a / torch.clamp_min(na, 1).to(a.dtype),
            logtarget=cand.logtarget,
            extras={"ndoublings": ndoubl, "a": a, "na": na, "divergent": div},
        )
        return new_state, info

    def _leaf(self, target, z_prev, v, eps, u, h0, inv_mass):
        """One leapfrog leaf: the new point, its H (NaN → −∞), n_leaf
        before masking, and the divergence bound s_leaf (NUTS.jl:420-421)."""
        z = leapfrog_step(target, z_prev, v * eps, inv_mass)
        h = _nan_to_neg_inf(hamiltonian(z.logtarget, z.momentum, inv_mass))
        return z, h, u <= h, u < self.maxdelta + h

    @staticmethod
    def _take(n_leaf, n_acc, take_u):
        """Progressive sampling: the leaf replaces the running candidate
        with probability n_leaf / (n_acc + n_leaf), in f32 as the JAX
        package draws it."""
        f = take_u.dtype
        return (n_leaf > 0) & (take_u * (n_acc + n_leaf).to(f) < n_leaf.to(f))

    @staticmethod
    def _doubling_swap(s_p, n_p, n_before, swap_u):
        """A valid subtree replaces the proposal with prob n'/n
        (iterate/NUTS.jl:361), an f32 division as in the JAX package."""
        f = swap_u.dtype
        return s_p & (swap_u < n_p.to(f) / n_before.to(f))

    # ------------------------------------------------- static (unrolled)
    def _static_leaf(self, target, take_u, z_prev, v, eps, u, h0, inv_mass, acc):
        """One leaf, masked by acc['alive']: it contributes to n, cand, a,
        na and div exactly where the looped form would have run it."""
        z, h, ok, s_leaf = self._leaf(target, z_prev, v, eps, u, h0, inv_mass)
        alive = acc["alive"]
        n_leaf = (ok & alive).to(torch.int32)
        take = self._take(n_leaf, acc["n"], take_u)
        acc = dict(
            acc,
            cand=_where(take, _cand(z), acc["cand"]),
            n=acc["n"] + n_leaf,
            a=acc["a"] + torch.where(alive, _accept_prob(h, h0), 0.0),
            na=acc["na"] + alive.to(torch.int32),
            div=acc["div"] | (alive & ~s_leaf),
            alive=alive & s_leaf,
        )
        return z, z, acc

    def _static_subtree(self, target, take_u, depth, z_in, v, eps, u, h0,
                        inv_mass, acc):
        """Unrolled depth-``depth`` subtree in direction v over the take
        draws ``take_u`` (2^depth rows).  Returns the subtree's boundary
        leaves and the threaded accumulator."""
        if depth == 0:
            return self._static_leaf(
                target, take_u[0], z_in, v, eps, u, h0, inv_mass, acc
            )
        half = 1 << (depth - 1)
        zs_l, ze_l, acc = self._static_subtree(
            target, take_u[:half], depth - 1, z_in, v, eps, u, h0, inv_mass, acc
        )
        _, ze_r, acc = self._static_subtree(
            target, take_u[half:], depth - 1, ze_l, v, eps, u, h0, inv_mass, acc
        )
        turned = _turn(
            ze_r.position, ze_r.momentum, zs_l.position, zs_l.momentum, v, inv_mass
        )
        acc = dict(acc, alive=acc["alive"] & ~turned)
        return zs_l, ze_r, acc

    def _step_static(self, state: NUTSState, target, draws: NUTSDraws):
        """The statically unrolled step: the looped form's contribution
        semantics through the alive mask, and no host read."""
        z0, h0, u = self._start(state, draws)
        eps, inv_mass = state.tune.step, state.inv_mass
        C = z0.position.shape[0]
        i32 = dict(dtype=torch.int32, device=z0.position.device)
        false = torch.zeros(C, dtype=torch.bool, device=z0.position.device)
        z_minus, z_plus = z0, z0
        acc = {
            "cand": _cand(z0),
            "n": torch.ones(C, **i32),
            "a": torch.zeros_like(z0.logtarget),
            "na": torch.zeros(C, **i32),
            "div": false,
            "alive": ~false,
        }
        ndoubl = torch.zeros(C, **i32)
        updated = false
        for j in range(self.max_doublings):
            entry = acc["alive"]
            fwd = draws.direction[j]
            v = fwd.to(z0.position.dtype) * 2.0 - 1.0
            start = _where(fwd, z_plus, z_minus)
            # the subtree streams its own candidate over a subtree-local
            # count, then the doubling swaps it in with prob n'/n
            n_before, cand_before = acc["n"], acc["cand"]
            acc = dict(acc, n=torch.zeros(C, **i32), cand=_cand(start))
            _, z_end, acc = self._static_subtree(
                target, draws.take_u[(1 << j) - 1:(2 << j) - 1], j, start, v,
                eps, u, h0, inv_mass, acc,
            )
            s_p, n_p = acc["alive"], acc["n"]
            # edges update for every doubling entered, a failing one too
            z_minus = _where(entry & ~fwd, z_end, z_minus)
            z_plus = _where(entry & fwd, z_end, z_plus)
            swap = self._doubling_swap(s_p, n_p, n_before, draws.swap_u[j])
            acc = dict(
                acc,
                n=n_before + n_p,
                cand=_where(swap, acc["cand"], cand_before),
            )
            updated = updated | swap
            ndoubl = ndoubl + entry.to(torch.int32)
            # whole-tree u-turn check (iterate/NUTS.jl:373)
            whole_turn = _turn(
                z_plus.position, z_plus.momentum, z_minus.position,
                z_minus.momentum, 1.0, inv_mass,
            )
            acc = dict(acc, alive=acc["alive"] & ~whole_turn)
        return self._result(state, acc["cand"], updated, ndoubl, acc["a"],
                            acc["na"], acc["div"])

    # --------------------------------------------------------- looped tree
    def _build_subtree(self, target, z_start, v, depth, eps, u, h0, inv_mass,
                       live, take_u):
        """2^depth leaves in direction v for the chains in ``live``; a chain
        stops at its first divergent or u-turning leaf.  Returns
        (z_end, candidate, n', s', a', na', divergent')."""
        C = z_start.position.shape[0]
        f = z_start.position.dtype
        i32 = dict(dtype=torch.int32, device=z_start.position.device)
        md = self.max_doublings
        cdt = getattr(torch, self.ckpt_dtype)
        ckpt_pos = torch.zeros((md + 1,) + tuple(z_start.position.shape), dtype=cdt,
                               device=z_start.position.device)
        ckpt_mom = torch.zeros_like(ckpt_pos)
        z, cand = z_start, _cand(z_start)
        n_acc = torch.zeros(C, **i32)
        s = live
        a = torch.zeros_like(z_start.logtarget)
        na = torch.zeros(C, **i32)
        div = torch.zeros_like(live)
        for k in range(1 << depth):
            z_new, h, ok, s_leaf = self._leaf(target, z, v, eps, u, h0, inv_mass)
            n_leaf = (ok & s).to(torch.int32)
            take = self._take(n_leaf, n_acc, take_u[k])
            cand = _where(take, _cand(z_new), cand)
            n_acc = n_acc + n_leaf
            a = a + torch.where(s, _accept_prob(h, h0), 0.0)
            na = na + s.to(torch.int32)
            div = div | (s & ~s_leaf)

            # checkpointed u-turn detection: even leaves are stored at slot
            # popcount(k); after odd leaf k the current point is checked
            # against the left end of every completed 2^m-leaf subtree
            # ending at k (m = 1 .. trailing zeros of k+1)
            turned = torch.zeros_like(s)
            if k % 2 == 0:
                slot = min(bin(k).count("1"), md)
                ckpt_pos[slot] = z_new.position.to(cdt)
                ckpt_mom[slot] = z_new.momentum.to(cdt)
            else:
                big_m = ((k + 1) & -(k + 1)).bit_length() - 1
                vel_hi = inv_mass * z_new.momentum
                for m in range(1, min(big_m, md) + 1):
                    lslot = min(bin(k + 1 - (1 << m)).count("1"), md)
                    d = chain_view(v, z_new.position) * (
                        z_new.position - ckpt_pos[lslot].to(f))
                    dot_hi = chain_sum(d * vel_hi)
                    dot_lo = chain_sum(d * (inv_mass * ckpt_mom[lslot].to(f)))
                    turned = turned | (dot_hi < 0.0) | (dot_lo < 0.0)
            z = _where(s, z_new, z)
            s = s & s_leaf & ~turned
        return z, cand, n_acc, s, a, na, div

    def _step_looped(self, state: NUTSState, target, draws: NUTSDraws):
        z0, h0, u = self._start(state, draws)
        eps, inv_mass = state.tune.step, state.inv_mass
        C = z0.position.shape[0]
        i32 = dict(dtype=torch.int32, device=z0.position.device)
        z_minus, z_plus, cand = z0, z0, _cand(z0)
        n = torch.ones(C, **i32)
        s = torch.ones(C, dtype=torch.bool, device=z0.position.device)
        ndoubl = torch.zeros(C, **i32)
        a = torch.zeros_like(z0.logtarget)
        na = torch.zeros(C, **i32)
        updated = torch.zeros_like(s)
        div = torch.zeros_like(s)
        for j in range(self.max_doublings):
            if j > 0 and not bool(s.any()):  # one host read per doubling
                break
            fwd = draws.direction[j]
            v = fwd.to(z0.position.dtype) * 2.0 - 1.0
            start = _where(fwd, z_plus, z_minus)
            z_end, cand_p, n_p, s_p, a_p, na_p, div_p = self._build_subtree(
                target, start, v, j, eps, u, h0, inv_mass, s,
                draws.take_u[(1 << j) - 1:(2 << j) - 1],
            )
            z_minus = _where(s & ~fwd, z_end, z_minus)
            z_plus = _where(s & fwd, z_end, z_plus)
            swap = self._doubling_swap(s_p, n_p, n, draws.swap_u[j])
            cand = _where(swap, cand_p, cand)
            updated = updated | swap
            n = n + n_p
            ndoubl = ndoubl + s.to(torch.int32)
            s = s_p & ~_turn(
                z_plus.position, z_plus.momentum, z_minus.position,
                z_minus.momentum, 1.0, inv_mass,
            )
            a = a + a_p
            na = na + na_p
            div = div | div_p
        return self._result(state, cand, updated, ndoubl, a, na, div)
