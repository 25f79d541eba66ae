"""Chain meshes: chains data-parallel over ranks (counterpart of
klara_tpu/parallel/mesh.py).

In the JAX package a mesh is a sharding annotation and GSPMD inserts the
collectives: ``jnp.mean`` over the sharded chains axis inside the jitted job
is the psum.  Eager PyTorch has no such compiler, so here every cross-chain
step is explicit.  The design:

1. The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
   dimensions, ``("chains",)`` or ``("chains", "param")``, the counterpart of
   ``jax.sharding.Mesh``.  A job takes ``mesh=`` and ``chains_axis=`` and
   reduces over ``mesh.get_group(chains_axis)``.
2. Explicit SPMD on local tensors.  ``n_chains`` stays the global count; each
   rank of the chains dimension holds a contiguous block of n_chains / R
   chains (``ChainBlock``), and a count that does not divide raises
   ``ValueError``, as ``jax.device_put`` refuses an uneven sharding.  The
   job's states, traces and ``Chain`` hold the rank's own chains, and the
   ``Chain`` names its mesh.  No DTensor: K1 is a ctypes launch on plain
   tensors, and the samplers' masked loops gain nothing from sharding
   propagation.
3. Draws.  Every draw of a job is keyed (``ops.keyed.KeyedStream``, kernel
   K2 on the card), as the JAX package's per-chain keys are: a function of
   the run key, drawn from the generator once per run (replicated: every
   rank is handed a generator seeded alike, and a mismatch raises,
   ``check_generators``, one all-gather per run), and a counter holding the
   chain's global index, the step and the draw's site.  So a rank draws
   exactly its own chains, however many numbers a draw takes, and issues no
   collective for it; the shared jitter is global chain 0's draw, the same
   on every rank.  Without a split block a draw is exactly what it is
   without a mesh.
4. Reductions.  A cross-chain mean is the all-reduce of each rank's local
   mean weighted by its share of the chains (``mean_over_chains``); a
   variance pools each rank's local mean and variance
   (``var_over_chains``); the ensemble covariance all-reduces its
   cross-product.  The helpers run the same arithmetic with and without a
   mesh, skipping only the collective (and weights of 1), so a one-rank mesh
   gives the mesh-less run's bits and the mesh-less run keeps its own.
5. Host-read loops.  A loop whose trip count comes from a host read may wrap
   a collective only when every rank of that collective's group reads the
   same count.  Under a chains mesh the target runs no collective, and the
   leapfrog, NUTS and step-size-search loops draw nothing inside, so each
   rank uses its own count (the loops are masked per chain; no chain's
   result changes).  Under the param-sharded target the ranks of a param
   group hold the same chains and read the same count.  A loop that draws
   inside (the slice sampler's shrinkage) keys each iteration's draw at a
   site of its own, so it too runs on the rank's own count.
6. The param-sharded logreg target is in ``param_shard.py``.
7. Backends.  ``initialize_distributed`` joins a process group (a no-op for
   one process); ``chain_mesh`` and ``mesh2d`` on a process with no group
   make a one-rank group of their own.  The device is the card unless the
   caller names another (``core.device.resolve_device``, which raises where
   there is no card); NCCL on the card, gloo where the caller asks for the
   CPU or names ``backend="gloo"`` (two ranks on one card: NCCL refuses
   that).  Nothing falls back.
8. Output.  A csv run gathers each chunk of its ring (and a ``'post'``
   run its traces) to the first rank of the chains group
   (``gather_to_first``: host tensors on gloo, card tensors on NCCL; not
   counted), and the mesh's first rank alone writes (``writes_output``),
   so the files are the one process's byte for byte.
9. Statistics of a meshed chain are global on every rank.  ``mean``,
   ``acceptance`` and the chain-summed ``ess`` all-reduce their sums;
   ``mcvar``, ``mcse``, ``iact`` and per-chain ``ess`` and ``mean`` compute
   on the rank's chains and all-gather their per-chain results; split-chain
   ``rhat`` all-gathers per-chain means and variances; only the
   rank-normalised statistics (``rhat_rank``, ``ess_bulk``, ``ess_tail``)
   and the zero-variance estimators, which need every draw, all-gather the
   draws (``stats._common``).

The reductions (and a sampler's stream keyed without a job) act on the
block of the enclosing ``chain_context(block)``, and on no mesh outside
one: a job enters it for the length of a run, a statistic of a meshed chain
for its call, so the adaptation hooks and the statistics find the rank's
block without a change of their signatures.  The tracer's counts
``parallel.mesh.COLLECTIVES.<kind>`` count the helpers' calls.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import hashlib
import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class ChainBlock:
    """One rank's contiguous block of the global chains: ``size`` ranks in
    ``group``, this one ``rank``, ``total`` chains in all."""

    group: Any
    rank: int
    size: int
    total: int

    @property
    def local(self) -> int:
        return self.total // self.size

    @property
    def offset(self) -> int:
        return self.rank * self.local

    @property
    def split(self) -> bool:
        return self.size > 1


def mesh_dim(mesh, axis: str) -> int:
    """The index of the mesh dimension named ``axis``."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has dimensions {names}, not {axis!r}")
    return names.index(axis)


def chain_block(mesh, axis: str, n_chains: int) -> Optional[ChainBlock]:
    """This rank's block of ``n_chains`` chains over the mesh dimension
    ``axis`` (None without a mesh)."""
    if mesh is None:
        return None
    i = mesh_dim(mesh, axis)
    size = mesh.size(i)
    if n_chains % size:
        raise ValueError(
            f"n_chains={n_chains} is not divisible by the {axis!r} mesh "
            f"dimension's {size} ranks"
        )
    return ChainBlock(mesh.get_group(i), mesh.get_local_rank(i), size, n_chains)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("klara_chain_block", default=None)


@contextlib.contextmanager
def chain_context(block: Optional[ChainBlock]):
    """Make ``block`` the active one for the draws and reductions inside."""
    token = _ACTIVE.set(block)
    try:
        yield block
    finally:
        _ACTIVE.reset(token)


def active_block() -> Optional[ChainBlock]:
    """The block of ``chain_context`` (None outside one, or without a mesh):
    the draws and reductions below act on it."""
    return _ACTIVE.get()


# ------------------------------------------------------------- collectives
def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """``dist.all_reduce`` in place on ``t``, counted; returns ``t``."""
    tracing.count("parallel.mesh.COLLECTIVES.all_reduce")
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_cat(t, group, dim: int = 0):
    """Every rank's ``t`` of ``group``, in rank order, concatenated along
    ``dim``; counted."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    tracing.count("parallel.mesh.COLLECTIVES.all_gather")
    tracing.count("parallel.mesh.COLLECTIVES.gathered_elements", t.numel() * len(parts))
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def sum_over_ranks(t):
    """A per-rank partial sum summed over the active block's chains group
    (``t`` without one)."""
    b = _ACTIVE.get()
    if b is None:
        return t
    return all_reduce(t.contiguous(), b.group)


def mean_over_chains(x):
    """Mean over dim 0 of the global chains: ``x.mean(0)`` without an active
    block, else the all-reduce of each rank's mean times its share."""
    b = _ACTIVE.get()
    m = x.mean(0)
    if b is None:
        return m
    if b.split:
        m = m * (b.local / b.total)
    return all_reduce(m.contiguous(), b.group)


def var_over_chains(x):
    """Population variance (``correction=0``) over dim 0 of the global
    chains: each rank's mean m_r and variance v_r pooled with weights w_r,
    M = Σ w_r m_r, var = Σ w_r (v_r + (m_r − M)²).  One rank: v exactly."""
    b = _ACTIVE.get()
    v = torch.var(x, dim=0, correction=0)
    if b is None:
        return v
    m = x.mean(0)
    w = b.local / b.total
    big_m = all_reduce((m * w if b.split else m).contiguous(), b.group)
    pooled = v + torch.square(m - big_m)
    return all_reduce((pooled * w if b.split else pooled).contiguous(), b.group)


def gather_chains(x, dim: int = 0):
    """The global tensor: every rank's block concatenated along ``dim``
    (``x`` itself unless the active block is split)."""
    b = _ACTIVE.get()
    if b is None or not b.split:
        return x
    return all_gather_cat(x, b.group, dim)


def gather_to_first(t, block, dim: int = 0):
    """Every rank's ``t`` of the block's chains group, concatenated along
    ``dim`` in rank order, on the group's first rank (None on the others).
    On gloo the tensors go through host memory (its gather takes host
    tensors), on NCCL they stay on the card.  A float narrower than 32 bits
    widens to f32 and a bool becomes uint8 first, exactly."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    elif t.is_floating_point() and torch.finfo(t.dtype).bits < 32:
        t = t.float()
    if dist.get_backend(block.group) != "nccl":
        t = t.cpu()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(block.size)] if block.rank == 0 else None
    dist.gather(t, parts, dst=dist.get_global_rank(block.group, 0), group=block.group)
    return None if parts is None else torch.cat(parts, dim)


def writes_output(mesh) -> bool:
    """Whether this process writes a job's files: without a mesh, or where
    its coordinate is 0 in every dimension of the mesh."""
    return mesh is None or all(mesh.get_local_rank(i) == 0 for i in range(mesh.ndim))


def check_generators(generator, mesh) -> None:
    """Raise unless every rank of ``mesh`` holds a generator in the same
    state: one all-gather of a digest per mesh dimension."""
    if mesh is None:
        return
    if generator is None:
        raise ValueError("a run on a mesh needs a generator, seeded alike on every rank")
    digest = hashlib.blake2b(generator.get_state().numpy().tobytes(), digest_size=8).digest()
    value = int.from_bytes(digest, "little", signed=True)
    for i, name in enumerate(mesh.mesh_dim_names or ()):
        group = mesh.get_group(i)
        if dist.get_world_size(group) == 1:
            continue
        # NCCL carries card tensors only; gloo takes host ones
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl" else torch.device("cpu"))
        t = torch.tensor([value], dtype=torch.int64, device=device)
        if len(set(all_gather_cat(t, group).tolist())) != 1:
            raise RuntimeError(
                f"the ranks of mesh dimension {name!r} hold generators in different "
                "states: seed every rank's generator alike (the run key comes from it)"
            )


# ------------------------------------------------------------ mesh, groups
def _backend_for(device: torch.device, backend: Optional[str]) -> str:
    if backend is not None:
        return backend
    return "nccl" if device.type == "cuda" else "gloo"


def _ensure_group(device: torch.device, backend: Optional[str] = None) -> None:
    """A one-rank process group of this process's own when none exists, as
    a JAX mesh over local devices needs no initialisation."""
    if dist.is_initialized():
        return
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(_backend_for(device, backend), store=dist.HashStore(),
                            rank=0, world_size=1)


def build_mesh(shape, names, device=None):
    """A ``DeviceMesh`` of ``shape`` over the first ranks of the process
    group (made if there is none), on ``device`` (None: the card).  One
    entry of ``shape`` may be None: it takes every rank the others leave."""
    dev = resolve_device(device)
    _ensure_group(dev)
    world, known = dist.get_world_size(), 1
    for s in shape:
        known *= 1 if s is None else s
    shape = tuple(world // known if s is None else s for s in shape)
    n = math.prod(shape)
    if n > world or n == 0:
        dims = "x".join(str(s) for s in shape)
        raise ValueError(f"mesh {dims} needs {n} ranks, have {world}")
    from torch.distributed.device_mesh import DeviceMesh

    # every dimension's group on the process group's own backend: left to
    # itself a mesh on the card asks for NCCL groups, which refuse two ranks
    # on one card
    backend = dist.get_backend()
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(names),
                      backend_override=tuple((backend, None) for _ in shape))


def chain_mesh(n_devices: Optional[int] = None, axis: str = "chains", device=None):
    """1-D mesh over the first ``n_devices`` ranks (default: all)."""
    return build_mesh((n_devices,), (axis,), device)


def shard_chains(tree, mesh, axis: str = "chains", batch_dim: int = 0):
    """Each tensor leaf's block along ``batch_dim`` for this rank of the mesh
    dimension ``axis``; a leaf without that dimension is returned as is."""
    i = mesh_dim(mesh, axis)
    size, rank = mesh.size(i), mesh.get_local_rank(i)

    def put(x):
        if not torch.is_tensor(x) or x.dim() <= batch_dim:
            return x
        n = x.shape[batch_dim]
        if n % size:
            raise ValueError(f"dimension {batch_dim} of length {n} is not divisible "
                             f"by the {axis!r} mesh dimension's {size} ranks")
        return x.narrow(batch_dim, rank * (n // size), n // size)

    return tree_map(put, tree)


def take_block(tree, block):
    """This rank's block of a tree of per-chain leaves, the port's layout
    for sampler states and Gibbs carries: every tensor leaf of one or more
    dimensions holds the chains on axis 0.  A leaf of the ``block``'s global
    chains is cut to the block, one of its local chains is taken as it is,
    and any other length raises ``ValueError``.  The tree as it is unless
    the block is split."""
    if block is None or not block.split:
        return tree

    def cut(x):
        if not torch.is_tensor(x) or x.dim() == 0:
            return x
        if x.shape[0] == block.total:
            return x.narrow(0, block.offset, block.local).contiguous()
        if x.shape[0] == block.local:
            return x
        raise ValueError(f"a per-chain leaf of shape {tuple(x.shape)} holds neither the "
                         f"{block.total} chains nor this rank's {block.local}")

    return tree_map(cut, tree)


def tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
):
    """Join the process group of ``num_processes`` processes: call once per
    process before building the mesh.  A no-op for one process, so
    single-process runs may call it unconditionally.  ``coordinator_address``
    is ``host:port`` (tcp) or an ``init_method`` URL such as ``file://...``;
    the backend is NCCL on the card and gloo on the CPU unless named."""
    if num_processes is None or num_processes <= 1:
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    addr = coordinator_address or ""
    init_method = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(_backend_for(dev, backend), init_method=init_method,
                            world_size=num_processes, rank=process_id)
