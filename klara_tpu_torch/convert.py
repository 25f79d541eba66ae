"""Carry state across from the JAX package as numpy arrays.

The JAX side maps its pytrees' leaves to numpy arrays with a tree map;
these functions read the resulting numpy-leaved NamedTuples by field name
(nothing of JAX is imported) and build the port's tensors on ``device``
(None: the card; ``core.device.resolve_device``).  A Cholesky factor needs
no converter: it passes as a plain array.
"""

from __future__ import annotations

import numpy as np
import torch

from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.jobs.chain import Chain
from klara_tpu_torch.jobs.gibbs import GibbsChains
from klara_tpu_torch.models.examples import logistic_regression_target
from klara_tpu_torch.samplers.hmc import HMCState
from klara_tpu_torch.samplers.nuts import NUTSState
from klara_tpu_torch.tuners.tuners import DualAveragingExtra, TuneState


def _t(a, device=None):
    device = resolve_device(device)  # None: the card
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy's bf16 (ml_dtypes) has no torch twin
        return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)  # a copy: JAX's arrays are read-only


def target_arrays(X, y, prior_var: float = 100.0, device=None):
    """The port's logreg target on the same numpy X and y."""
    return logistic_regression_target(
        np.asarray(X), np.asarray(y), prior_var, device=device
    )


def tune_state_from_numpy(tune, device=None) -> TuneState:
    extra = tune.extra
    if hasattr(extra, "eps_bar"):
        extra = DualAveragingExtra(*(_t(getattr(extra, f), device) for f in DualAveragingExtra._fields))
    elif len(extra) == 0:
        extra = ()
    else:
        raise ValueError(f"no converter for tuner extra {type(extra).__name__}")
    return TuneState(
        *(_t(getattr(tune, f), device) for f in TuneState._fields[:-1]), extra
    )


def hmc_state_from_numpy(state, device=None) -> HMCState:
    """A chains-batched JAX ``HMCState`` with numpy leaves -> the port's."""
    return HMCState(
        position=_t(state.position, device),
        logtarget=_t(state.logtarget, device),
        gradlogtarget=_t(state.gradlogtarget, device),
        inv_mass=_t(state.inv_mass, device),
        tune=tune_state_from_numpy(state.tune, device),
        log_traj=_t(state.log_traj, device),
        traj_m=_t(state.traj_m, device),
        traj_v=_t(state.traj_v, device),
    )


def nuts_state_from_numpy(state, device=None) -> NUTSState:
    """A chains-batched JAX ``NUTSState`` with numpy leaves -> the port's."""
    return NUTSState(
        position=_t(state.position, device),
        logtarget=_t(state.logtarget, device),
        gradlogtarget=_t(state.gradlogtarget, device),
        inv_mass=_t(state.inv_mass, device),
        tune=tune_state_from_numpy(state.tune, device),
    )


def chain_from_numpy(samples, diagnostics=None, device=None) -> Chain:
    """A Chain from dicts of (n_post, n_chains, ...) arrays, or from any
    object with ``samples`` and ``diagnostics`` dicts (a JAX Chain with
    its leaves mapped to numpy); the final state is not carried."""
    if hasattr(samples, "samples"):
        samples, diagnostics = samples.samples, samples.diagnostics
    return Chain(
        samples={k: _t(v, device) for k, v in samples.items()},
        diagnostics={k: _t(v, device) for k, v in (diagnostics or {}).items()},
    )


def gibbs_values_from_numpy(values, device=None):
    """A Gibbs values dict as numpy (a JAX ``v0``, or a ``GibbsChains``'
    ``final_values`` with leading chains axes) -> the port's tensors."""
    return {k: _t(v, device) for k, v in values.items()}


def gibbs_chains_from_numpy(chains, device=None) -> GibbsChains:
    """A JAX ``GibbsChains`` with numpy leaves -> the port's."""
    return GibbsChains(
        samples=gibbs_values_from_numpy(chains.samples, device),
        final_values=gibbs_values_from_numpy(chains.final_values, device),
        diagnostics=gibbs_values_from_numpy(chains.diagnostics, device),
    )
