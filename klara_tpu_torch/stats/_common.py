"""Shared field extraction for the stats layer (counterpart of
klara_tpu/stats/_common.py).  Entry points take a Chain or a tensor; floats
narrower than 32 bits (a bf16 trace) are promoted to f32 before any
reduction, since a bf16 accumulator rounds a long sum away.

A chain run on a mesh holds one rank's block of the chains (axis 1 of a
trace) and names its mesh.  Its statistics are the global ones on every
rank, as every JAX process gets the replicated result of a reduction over
the global chains axis: ``mean``, ``acceptance`` and ``ess`` (summed over
chains) all-reduce their sums; ``mcvar``, ``mcse``, ``iact`` and the
per-chain ``ess`` and ``mean`` compute on the rank's chains and all-gather
their per-chain results (``gather_results``); split-chain ``rhat``
all-gathers per-chain means and variances.  Only the rank-normalised
statistics (``rhat_rank``, ``ess_bulk``, ``ess_tail``: a global rank needs
every draw) and the zero-variance estimators gather the draws of all
chains (``extract_f32(..., gather=True)``)."""

from __future__ import annotations

import torch

from klara_tpu_torch.parallel.mesh import chain_block, chain_context, gather_chains, mesh_dim


def block_of(chain_or_array, local: int):
    """The ``ChainBlock`` of a meshed chain whose traces hold ``local``
    chains (None for a tensor or a chain run without a mesh)."""
    mesh = getattr(chain_or_array, "mesh", None)
    if mesh is None:
        return None
    axis = chain_or_array.chains_axis
    return chain_block(mesh, axis, local * mesh.size(mesh_dim(mesh, axis)))


def chain_scope(chain_or_array, x):
    """``chain_context`` of the block of a meshed chain whose trace ``x``
    holds its chains on axis 1 (no block for fewer axes)."""
    return chain_context(block_of(chain_or_array, x.shape[1]) if x.dim() >= 2 else None)


def extract_f32(chain_or_array, field: str = "value", gather: bool = False):
    """The field as a tensor, f32 if narrower; a meshed chain's trace holds
    this rank's chains (axis 1), every rank's with ``gather``."""
    x = chain_or_array[field] if hasattr(chain_or_array, "samples") else chain_or_array
    x = torch.as_tensor(x)
    if x.is_floating_point() and torch.finfo(x.dtype).bits < 32:
        x = x.to(torch.float32)
    if gather:
        with chain_scope(chain_or_array, x):
            x = gather_chains(x, dim=1)
    return x


def gather_results(chain_or_array, x, result):
    """``result``, a per-chain statistic of the trace ``x`` with the chains
    on axis 0, with every rank's chains (as it is without a mesh)."""
    if x.dim() < 2:
        return result
    with chain_scope(chain_or_array, x):
        return gather_chains(result)
