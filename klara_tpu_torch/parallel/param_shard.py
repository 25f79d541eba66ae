"""Parameter-dimension sharding: a (chains, param) mesh and the
logistic-regression target with its features sharded over ``"param"``
(counterpart of klara_tpu/parallel/param_shard.py).

Layout on a 2-D ``(chains, param)`` mesh of P param ranks:

    positions  (C_local, D)      replicated over the param ranks
    X          (N, D/P)          this rank's block of feature columns
    v = Xᵀy    (D/P,)            its slice
    logits     (C_local, N)      the partial P_local·X_localᵀ, all-reduced
    gradient   (C_local, D)      the local (C_local, D/P) block, all-gathered

Per evaluation the param group runs one all-reduce of the partial logits
(with the partial p·v − ‖p‖²/2λ riding along) and one all-gather of the
gradient blocks.  The JAX package keeps positions and gradients sharded
over 'param' because GSPMD also partitions the samplers' sums over D; here
positions stay replicated, so no sampler has to reduce over D.  That is a
layout choice, not a change of the function.  Both products stay
``torch.matmul``: the JAX function is plain XLA outside any Pallas kernel,
and K1 cannot be split around the all-reduce.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from klara_tpu_torch.ops.logreg import _softplus
from klara_tpu_torch.parallel.mesh import all_gather_cat, all_reduce, build_mesh, mesh_dim


def mesh2d(
    n_chain_devices: Optional[int] = None,
    n_param_devices: int = 1,
    axes: Sequence[str] = ("chains", "param"),
    device=None,
):
    """2-D mesh: chains (data parallel) × param (tensor parallel).
    ``n_chain_devices=None`` takes every rank the param dimension leaves."""
    return build_mesh((n_chain_devices, n_param_devices), axes, device)


def param_sharded_logreg_target(
    X,
    y,
    mesh,
    prior_var: float = 100.0,
    chains_axis: str = "chains",
    param_axis: str = "param",
):
    """Logistic-regression ``Target`` (N(0, prior_var·I) prior) whose
    batched value+grad runs with X's feature columns sharded over the mesh's
    ``param_axis``.  Use with ``MCJob(..., mesh=mesh)``: the chains shard
    over ``chains_axis`` as usual.  Every rank of a param group must
    evaluate it together (it runs collectives)."""
    from klara_tpu_torch.core.target import Target

    mesh_dim(mesh, chains_axis)
    i = mesh_dim(mesh, param_axis)
    n_param, rank, group = mesh.size(i), mesh.get_local_rank(i), mesh.get_group(i)
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    N, D = X.shape
    lam = float(prior_var)
    if D % n_param != 0:
        raise ValueError(
            f"feature dimension D={D} is not divisible by the '{param_axis}' "
            f"mesh axis size {n_param}; pad X with zero columns to a multiple "
            f"of {n_param} (zero-padded features do not change the posterior "
            f"when the padded position coordinates start at 0 under a "
            f"Gaussian prior) or choose a mesh with n_param dividing D"
        )
    width = D // n_param
    cols = slice(rank * width, (rank + 1) * width)
    Xl = X[:, cols].contiguous()          # (N, D/P), this rank's features
    vl = (Xl.T @ y).contiguous()          # (D/P,)
    const = 0.5 * D * math.log(2.0 * math.pi * lam)

    def value_and_grad(P):  # (C, D) replicated over the param ranks
        Pl = P[:, cols]
        # partial logits and partial p·v − ‖p‖²/2λ in one all-reduce
        part = torch.cat([Pl @ Xl.T, (Pl @ vl - 0.5 * (Pl * Pl).sum(-1) / lam)[:, None]], 1)
        if n_param > 1:
            all_reduce(part, group)
        logits, lin = part[:, :N], part[:, N]
        value = lin - _softplus(logits).sum(-1) - const
        g = (vl - torch.sigmoid(logits) @ Xl - Pl / lam).contiguous()
        if n_param > 1:
            g = all_gather_cat(g, group, 1)
        return value, g

    def logdensity(P):
        return value_and_grad(P)[0]

    return Target(
        logdensity_fn=logdensity,
        dim=D,
        value_and_grad_fn=value_and_grad,
        name="logreg_param_sharded",
    )
