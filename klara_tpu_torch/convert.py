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
from klara_tpu_torch import samplers as _samplers
from klara_tpu_torch.tuners.tuners import (
    DualAveragingExtra,
    RobertsRosenthalExtra,
    TuneState,
)

_STATE_TYPES = {
    cls.__name__: cls
    for cls in (
        TuneState,
        *(getattr(_samplers, n) for n in _samplers.__all__ if n.endswith("State")),
    )
}


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


def _extra_from_numpy(extra, device):
    for cls in (DualAveragingExtra, RobertsRosenthalExtra):
        if all(hasattr(extra, f) for f in cls._fields):
            return cls(*(_t(getattr(extra, f), device) for f in cls._fields))
    if len(extra) == 0:
        return ()
    raise ValueError(f"no converter for tuner extra {type(extra).__name__}")


def state_from_numpy(state, device=None, cls=None):
    """A sampler or tuner state of the JAX package, chains-batched and with
    numpy leaves, as the port's NamedTuple ``cls`` (default: the port's type
    of the same name: ``HMCState``, ``NUTSState``, ``MHState``,
    ``MALAState``, ``AMState``, ``RAMState``, ``AMWGState``, ``SliceState``,
    ``ARSState``, ``SMMALAState``, ``TuneState``).  Fields are read by name."""
    if cls is None:
        cls = _STATE_TYPES.get(type(state).__name__)
        if cls is None:
            raise ValueError(f"no converter for {type(state).__name__}")
    out = []
    for f in cls._fields:
        v = getattr(state, f)
        if f == "tune":
            out.append(state_from_numpy(v, device, TuneState))
        elif f == "extra":
            out.append(_extra_from_numpy(v, device))
        else:
            out.append(_t(v, device))
    return cls(*out)


def tune_state_from_numpy(tune, device=None) -> TuneState:
    return state_from_numpy(tune, device, TuneState)


def hmc_state_from_numpy(state, device=None):
    return state_from_numpy(state, device, _samplers.HMCState)


def nuts_state_from_numpy(state, device=None):
    return state_from_numpy(state, device, _samplers.NUTSState)


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
