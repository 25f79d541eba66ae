"""The two products of a batch with a lower-triangular factor: kernel K3 and
its plain PyTorch version.

For a (C, D) f32 batch A and the factor L (D, D, lower-triangular):

    forward   x = shift + A Lᵀ      out[c, i] = shift[i] + Σ_{j ≤ i} A[c, j] L[i, j]
    gradient  g = A L − y           out[c, j] = Σ_{i ≥ j} A[c, i] L[i, j] − y[c, j]

(``shift`` (D,) and ``y`` (C, D) optional): what ``core.target.through_factor``
computes around every evaluation through a factor (the LGCP's, a whitened
target's).  No TPU kernel corresponds: the JAX package leaves these products
to XLA.

``factor_forward`` and ``factor_gradient`` launch the hand-written CUDA kernel
(``csrc/tri_factor.cu``) and take CUDA tensors only.  The kernel runs on the
tensor cores in three TF32 passes (each operand split into hi = tf32(a),
rounded to nearest, and lo = tf32(a − hi); lo·hi + hi·lo + hi·hi, f32
accumulators), which is f32-grade, and only over the factor's triangle: a
128-column output tile reads the K chunks on its side of the diagonal and no
others.  L is constant for a target, so what the kernel reads of it
(``prepare_factor``: the hi/lo split of L's rows and of Lᵀ's, in the byte
order of the kernel's shared-memory slots, the triangle's slots alone) is
made once and handed to every call.  Both maps are linear, and each wrapper
is a ``torch.autograd.Function`` whose derivative is the other product:
autograd, forward-mode AD and ``torch.func``'s transforms (``vmap`` folds its
batch into the kernel's rows) run through K3 as the sampler does.
``factor_forward_reference`` and ``factor_gradient_reference`` are the plain
version, cuBLAS's f32 products; ``factor_product_split`` emulates the
kernel's arithmetic in plain PyTorch, so that its accuracy is testable
without the card.

``core.target.through_factor`` takes the kernel where ``engages(chol)``: a CUDA
float32 factor at least ``MIN_DIM`` wide.  Narrower, and on the CPU, it runs
the plain version: there the products are a few microseconds each and bound
by latency.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from klara_tpu_torch.ops.logreg import tf32_round
from klara_tpu_torch.utils import tracing

# The shape rule: K3 takes CUDA float32 factors at least this wide.  At
# D = 1024 cuBLAS's pair of products is as fast or faster (64 tiles for 132
# SMs); from 2048 K3 is 1.6-1.8x faster (``chip_smoke.py`` phase 31).
MIN_DIM = 2048
TILE = 128       # output columns (and batch rows) of a tile
CHUNK = 32       # K of a chunk: four k-steps of 8
CHUNKS = TILE // CHUNK
# K an accumulator runs over before the FP32 cores add it up, by direction
# (forward or not): see ``csrc/tri_factor.cu``
RUN = {True: 8, False: 32}

# the tracer's count of K3 launches, made only where the kernel is launched
_LAUNCHES = "ops.factor.KERNEL_LAUNCHES"

_sms = {}  # device index -> streaming multiprocessors (the persistent grid)


def engages(chol) -> bool:
    """Whether ``through_factor`` runs its products through K3: a CUDA
    float32 factor of at least ``MIN_DIM`` rows."""
    return (chol.device.type == "cuda" and chol.dtype == torch.float32
            and chol.dim() == 2 and chol.shape[0] >= MIN_DIM)


def tiles(D: int) -> int:
    """Output column tiles of 128 for D columns."""
    return -(-D // TILE)


def triangle_chunks(D: int, forward: bool):
    """A bool (T, 4T) mask of the (column tile, K chunk) pairs K3 multiplies:
    the forward product's tile t takes chunks [0, 4(t + 1)), the gradient's
    [4t, 4T)."""
    T = tiles(D)
    t = torch.arange(T)[:, None]
    c = torch.arange(CHUNKS * T)[None, :]
    return c < CHUNKS * (t + 1) if forward else c >= CHUNKS * t


# ------------------------------------------------------------ plain version
def factor_forward_reference(a, chol_t, shift=None):
    """Plain PyTorch ``shift + a Lᵀ`` from Lᵀ (``chol_t``, made once and
    held): what ``through_factor`` runs below the shape rule."""
    return a @ chol_t if shift is None else torch.addmm(shift, a, chol_t)


def factor_gradient_reference(a, chol, y=None):
    """Plain PyTorch ``a L − y``."""
    return a @ chol if y is None else torch.addmm(y, a, chol, beta=-1.0)


# ----------------------------------------------------------------- emulation
def factor_product_split(a, chol, forward=True, passes=3, shift=None, y=None):
    """K3's arithmetic in plain PyTorch: both operands split by
    ``tf32_round`` (each product of two TF32 numbers is exact in f32), three
    passes (lo·hi + hi·lo, then hi·hi) or one (hi·hi), summed in f32 a run of
    ``RUN[forward]`` along K at a time over the triangle's chunks only, the
    runs' sums added in f32; the epilogue as the kernel's."""
    C, D = a.shape
    T = tiles(D)
    DP = TILE * T
    B = torch.tril(chol.to(torch.float32))
    B = B if forward else B.T
    Bp = B.new_zeros(DP, DP)
    Bp[:D, :D] = B
    Ap = a.new_zeros(C, DP)
    Ap[:, :D] = a
    a_hi = tf32_round(Ap)
    b_hi = tf32_round(Bp)

    run = RUN[forward]

    def chunked(x, w):  # (C, DP) x (DP rows n, DP K) -> (runs, C, DP) partial sums
        return torch.einsum("ckj,nkj->kcn", x.view(C, -1, run), w.view(DP, -1, run))

    parts = chunked(a_hi, b_hi)
    if passes == 3:
        a_lo = tf32_round(Ap - a_hi)
        b_lo = tf32_round(Bp - b_hi)
        parts = (chunked(a_lo, b_hi) + chunked(a_hi, b_lo)) + parts
    elif passes != 1:
        raise ValueError(f"K3 emulation takes passes=3 or passes=1, got {passes}")
    # a run of column n counts only where (n's tile, its chunk) is on the triangle
    keep = triangle_chunks(D, forward).repeat_interleave(TILE, 0)
    keep = keep.repeat_interleave(CHUNK // run, 1).T  # (runs, DP)
    out = (parts * keep[:, None, :]).sum(0)[:, :D]
    if shift is not None:
        out = shift + out
    if y is not None:
        out = out - y
    return out


# ----------------------------------------------------------------- the images
def _slots(M, forward):
    """The triangle's slots of M (DP, DP; rows n, K along columns) for the
    direction: (slots, 2, 8, 128, 4) f32, each [hi | lo] of one (tile, chunk)
    in the kernel's shared-memory order.  Section index (kc, n, e) holds row
    n at physical column 8 e + kc of the chunk: the kernel's k-step s reads
    kc = 2s, 2s + 1, and logical column kk of it is physical 8 (kk % 4) + 2s
    + kk // 4, the columns a thread's A fragment holds contiguously."""
    T = M.shape[0] // TILE
    hi = tf32_round(M)
    lo = tf32_round(M - hi)
    # (t, n, c, e, kc) -> (t, c, kc, n, e)
    sec = torch.stack([hi, lo]).view(2, T, TILE, CHUNKS * T, 4, 8).permute(1, 3, 0, 5, 2, 4)
    return sec[triangle_chunks(M.shape[0], forward)].contiguous()


@dataclasses.dataclass(frozen=True)
class PreparedFactor:
    """L as K3 reads it: ``forward`` holds the slots of L's rows (the forward
    product's B operand, K-major), ``gradient`` those of Lᵀ's, each
    (slots, 2, 8, 128, 4) f32 (``_slots``): column tile t's slots one after
    another, in the order the kernel walks its chunks.  Only the lower
    triangle of the factor enters."""

    forward: torch.Tensor
    gradient: torch.Tensor
    dim: int

    def unpack(self):
        """The factor's halves rebuilt from the slots: ((hi, lo) from the
        forward slots, (hi, lo) from the gradient slots), each (D, D) and
        laid out as L; both pairs are tf32_round(tril(L)) and the rounded
        rest."""
        D, T = self.dim, tiles(self.dim)
        out = []
        for sl, forward in ((self.forward, True), (self.gradient, False)):
            full = sl.new_zeros(T, CHUNKS * T, 2, 8, TILE, 4)
            full[triangle_chunks(D, forward)] = sl
            M = full.permute(2, 0, 4, 1, 5, 3).reshape(2, TILE * T, TILE * T)
            M = M if forward else M.transpose(1, 2)
            out.append((M[0, :D, :D], M[1, :D, :D]))
        return tuple(out)


def prepare_factor(chol) -> PreparedFactor:
    """K3's images of the factor ``chol`` (D, D) f32, on its device; once
    per target (~140 MB at D = 4096)."""
    if chol.dim() != 2 or chol.shape[0] != chol.shape[1] or chol.shape[0] < 1:
        raise ValueError(f"K3: the factor must be (D, D), got {tuple(chol.shape)}")
    if chol.dtype != torch.float32:
        raise TypeError(f"K3: the factor has dtype {chol.dtype}, expected float32")
    D = chol.shape[0]
    DP = TILE * tiles(D)
    M = chol.new_zeros(DP, DP)
    M[:D, :D] = torch.tril(chol)
    return PreparedFactor(forward=_slots(M, True), gradient=_slots(M.T.contiguous(), False),
                          dim=D)


# -------------------------------------------------------------- the wrappers
def _check(a, prepared, extra, extra_shape, name):
    if not isinstance(prepared, PreparedFactor):
        raise TypeError("K3 reads the factor as prepare_factor(chol) lays it out: make that "
                        "once per target and pass it")
    if a.dim() != 2 or a.shape[1] != prepared.dim or a.shape[0] < 1:
        raise ValueError(f"K3: the batch must be (C, {prepared.dim}) with C >= 1, "
                         f"got {tuple(a.shape)}")
    device = prepared.forward.device
    tensors = [("the batch", a)] + ([(name, extra)] if extra is not None else [])
    for what, t in tensors:
        if t.device != device:
            raise ValueError(f"K3: {what} is on {t.device}, the factor on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"K3: {what} has dtype {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"K3: {what} is not contiguous")
    if extra is not None and tuple(extra.shape) != extra_shape:
        raise ValueError(f"K3: {name} is {tuple(extra.shape)}, expected {extra_shape}")


def _launch(a, prepared, extra, forward):
    """One K3 launch on the current stream (no synchronisation): the
    direction's product of the checked ``a`` with its epilogue ``extra``."""
    from klara_tpu_torch.ops import _build

    device = a.device
    if device.type != "cuda":
        raise ValueError(f"K3 is a CUDA kernel: the batch is on {device}; the plain "
                         "version is factor_forward_reference / factor_gradient_reference")
    lib = _build.load("tri_factor")
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    out = torch.empty_like(a)
    img = prepared.forward if forward else prepared.gradient
    with torch.cuda.device(device):  # the launch goes to the current device
        rc = lib.klara_tri_factor(a.data_ptr(), img.data_ptr(),
                                  None if extra is None else extra.data_ptr(), out.data_ptr(),
                                  a.shape[0], a.shape[1], int(forward), _sms[index],
                                  torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {rc}")
    tracing.count(_LAUNCHES)
    return out


def _product(a, prepared, extra, forward):
    """A checked launch, its host time to the tracer's ``k3.host_ns``."""
    t0 = time.perf_counter_ns()
    if forward:
        _check(a, prepared, extra, (prepared.dim,), "the shift")
    else:
        _check(a, prepared, extra, tuple(a.shape), "y")
    out = _launch(a, prepared, extra, forward)
    tracing.add("k3.host_ns", time.perf_counter_ns() - t0)
    return out


def _vmapped(fn, info, in_dims, a, prepared, extra, sign):
    """A wrapper under ``torch.func.vmap``: the batch dimension folded into
    the kernel's rows, one bare launch, the epilogue's term added after with
    its own batch dimension."""
    a_dim, _, e_dim = in_dims
    a = a.movedim(a_dim, 0) if a_dim is not None else a.expand(info.batch_size, *a.shape)
    out = fn(a.reshape(-1, a.shape[-1]).contiguous(), prepared, None).view(a.shape)
    if extra is not None:
        if e_dim is not None:
            extra = extra.movedim(e_dim, 0)
            extra = extra.view(extra.shape[0], *[1] * (out.dim() - extra.dim()),
                               *extra.shape[1:])
        out = out + sign * extra
    return out, 0


class _Forward(torch.autograd.Function):
    """x = shift + a Lᵀ; its derivative in a is the gradient product."""

    @staticmethod
    def forward(a, prepared, shift):
        return _product(a, prepared, shift, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.prepared, ctx.shape = inputs[1], output.shape

    @staticmethod
    def backward(ctx, g):
        da = _Gradient.apply(g.contiguous(), ctx.prepared, None) if ctx.needs_input_grad[0] \
            else None
        return da, None, (g.sum(0) if ctx.needs_input_grad[2] else None)

    @staticmethod
    def jvp(ctx, ta, _, tshift):
        out = _Forward.apply(ta.contiguous(), ctx.prepared, None) if ta is not None else None
        if tshift is not None:
            out = tshift.expand(ctx.shape) if out is None else out + tshift
        return out

    @staticmethod
    def vmap(info, in_dims, a, prepared, shift):
        return _vmapped(_Forward.apply, info, in_dims, a, prepared, shift, 1.0)


class _Gradient(torch.autograd.Function):
    """a L − y; its derivative in a is the forward product."""

    @staticmethod
    def forward(a, prepared, y):
        return _product(a, prepared, y, False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.prepared = inputs[1]

    @staticmethod
    def backward(ctx, g):
        da = _Forward.apply(g.contiguous(), ctx.prepared, None) if ctx.needs_input_grad[0] \
            else None
        return da, None, (-g if ctx.needs_input_grad[2] else None)

    @staticmethod
    def jvp(ctx, ta, _, ty):
        out = _Gradient.apply(ta.contiguous(), ctx.prepared, None) if ta is not None else None
        if ty is not None:
            out = -ty if out is None else out - ty
        return out

    @staticmethod
    def vmap(info, in_dims, a, prepared, y):
        return _vmapped(_Gradient.apply, info, in_dims, a, prepared, y, -1.0)


def factor_forward(a, prepared, shift=None):
    """``shift + a Lᵀ`` (C, D) for the batch ``a`` (C, D) f32 and the factor
    as ``prepare_factor`` made it: one K3 launch on the current stream (no
    synchronisation), CUDA tensors only.  The call's host time goes to the
    tracer's ``k3.host_ns``.  Differentiable in ``a`` and ``shift``, by
    autograd and ``torch.func``'s transforms."""
    return _Forward.apply(a, prepared, shift)


def factor_gradient(a, prepared, y=None):
    """``a L − y`` (C, D), as ``factor_forward``."""
    return _Gradient.apply(a, prepared, y)
