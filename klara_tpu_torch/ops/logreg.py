"""Batched logistic-regression log-density + gradient: kernel K1 and its
plain PyTorch version.

Counterpart of klara_tpu/ops/logreg.py (``fused_logreg_value_grad``, the
Pallas kernel, and ``_xla_value_grad_batched``).  For chains P (C, D), data
X (N, D) and v = Xᵀy (D,):

    value_c = p_c·v − Σ_n softplus(x_n·p_c) − ‖p_c‖²/(2λ) − ½D·log(2πλ)
    grad_c  = v − σ(X p_c)ᵀX − p_c/λ

``logreg_value_grad`` launches the hand-written CUDA kernel
(``csrc/logreg.cu``) for CUDA tensors and takes the plain version for CPU
tensors.  The kernel runs both products on the tensor cores in TF32 with
f32 accumulators: ``passes=3`` (the default, and what every sampler uses)
splits each operand into hi = tf32(a) and lo = a − hi and sums
lo·hi + hi·lo + hi·hi, which is f32-grade; ``passes=1`` keeps hi·hi only
(about three decimal digits), the counterpart of the Pallas kernel's
``mxu_dtype``.  X and y are constant per target, so what the kernel wants
of them (``prepare_x``: D padded to a multiple of 8, the hi/lo split, a
transposed copy, all in the byte order of the kernel's shared-memory tiles,
and the padded labels) is made once and handed to every call.  Wider than
``MAX_DIM`` columns the kernel takes its wide form, which tiles D into
128-column tiles of the gradient (the Pallas kernel pads D to a multiple of
128 likewise) and reads X as it is: two f32 products on the FP32 cores
(``passes=1``: TF32 operands), the log-likelihood summed row by row too.  The kernel
sums the log-likelihood row by row, Σ_n (y_n z_n − softplus(z_n)), from its
own logits: the same number as p·v − Σ softplus from exact logits, but a sum
of terms that are small where the model fits.  ``logreg_value_grad_split``
emulates this arithmetic in plain PyTorch, so that its accuracy is testable
without the card.

The port is batch-first, so this one function is the logreg target's
value+grad: the JAX package's ``make_logreg_target`` / ``custom_vmap``
dispatch has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from klara_tpu_torch.utils import tracing

MAX_DIM = 128   # widest accumulator tile; wider D takes the kernel's wide form
TILE_N = 32     # data rows per tile image
# position k' of an 8-row block's K order holds data row _ROW_ORDER[k']: the
# first product leaves rows (2q, 2q+1) with the thread that must supply
# k = (q, q+4) of the second
_ROW_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)

# the tracer's count of K1 launches, made only where the kernel is launched
_LAUNCHES = "ops.logreg.KERNEL_LAUNCHES"


def __getattr__(name):
    """``KERNEL_LAUNCHES``, read-only: the tracer's count of K1 launches.
    It serves ``portbench/counters.py`` until that file reads the tracer."""
    if name == "KERNEL_LAUNCHES":
        return tracing.counters().get(_LAUNCHES, (0, 0))[0]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _softplus(z):
    # max(z, 0) + log1p(exp(-|z|)): the stable softplus, as the kernel and
    # the JAX package compute it
    return torch.clamp_min(z, 0.0) + torch.log1p(torch.exp(-z.abs()))


def logreg_value_grad_reference(P, X, v, prior_var):
    """Plain PyTorch value (C,) and gradient (C, D); the formula of
    ``_xla_value_grad_batched`` with y entering through v = Xᵀy."""
    lam = float(prior_var)
    D = P.shape[-1]
    logits = P @ X.T  # (C, N)
    value = (
        P @ v
        - _softplus(logits).sum(-1)
        - 0.5 * (P * P).sum(-1) / lam
        - 0.5 * D * math.log(2.0 * math.pi * lam)
    )
    grad = v - torch.sigmoid(logits) @ X - P / lam
    return value, grad


# ------------------------------------------------------------- TF32 splitting
def tf32_round(a):
    """f32 rounded to TF32 (10 mantissa bits), nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``: integer arithmetic on the f32 bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(a):
    """f32 with the low 13 mantissa bits dropped: what the tensor core reads
    of an f32 operand that nothing rounded."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def padded_dim(D: int) -> int:
    """The kernel's accumulator width for D columns: 104 or 128, or above
    ``MAX_DIM`` the wide form's 128-column tiles."""
    if D > MAX_DIM:
        return MAX_DIM * -(-D // MAX_DIM)
    return 104 if D <= 104 else 128


@dataclasses.dataclass(frozen=True)
class PreparedX:
    """X as K1 reads it.  ``image`` is (T, 4·DP·32) f32, one row per tile of
    32 data rows: the sections [X hi | X lo | Xᵀ hi | Xᵀ lo], each DP × 32
    values in core-matrix order (8 rows × 16 bytes, K-major):

    - X  (rows n, K = d):  float ((d//4)·4 + n//8)·32 + (n%8)·4 + d%4
    - Xᵀ (rows d, K = n′): float ((n′//4)·(DP/8) + d//8)·32 + (d%8)·4 + n′%4,
      n′ the position of row n in ``_ROW_ORDER`` within its block of 8

    hi = ``tf32_round``; lo = X − hi exactly (the tensor core drops at most
    its last bit).  Rows ≥ N and columns ≥ D are zeros.  For the wide form
    (D > ``MAX_DIM``, ``wide``) ``image`` is X itself, (N, D).  ``y`` holds
    the labels, zero-padded to T·32."""

    image: torch.Tensor
    n_data: int
    dim: int
    dim_padded: int
    y: torch.Tensor

    @property
    def wide(self) -> bool:
        return self.dim > MAX_DIM

    def unpack(self):
        """X rebuilt as hi + lo from the X sections and from the Xᵀ
        sections: two (N, D) tensors, both equal to X."""
        if self.wide:
            return self.image, self.image
        T, DP = self.image.shape[0], self.dim_padded
        sec = self.image.view(T, 4, DP * TILE_N)
        rows = sec[:, 0:2].reshape(T, 2, DP // 4, TILE_N // 8, 8, 4).sum(1)
        rows = rows.permute(0, 2, 3, 1, 4).reshape(T * TILE_N, DP)
        cols = sec[:, 2:4].reshape(T, 2, TILE_N // 4, DP // 8, 8, 4).sum(1)
        cols = cols.permute(0, 1, 4, 2, 3).reshape(T, TILE_N // 8, 8, DP)
        inverse = [_ROW_ORDER.index(n) for n in range(8)]
        cols = cols[:, :, inverse, :].reshape(T * TILE_N, DP)
        return rows[: self.n_data, : self.dim], cols[: self.n_data, : self.dim]


def prepare_x(X, y) -> PreparedX:
    """The tile images of X (N, D) f32, on X's device, and the padded labels
    y (N,); once per target."""
    N, D = X.shape
    if y.shape != (N,):
        raise ValueError(f"K1: X is {tuple(X.shape)}, y {tuple(y.shape)}: expected ({N},)")
    DP, T = padded_dim(D), -(-N // TILE_N)
    y = torch.cat([y.to(X), X.new_zeros(T * TILE_N - N)]).contiguous()
    if D > MAX_DIM:
        return PreparedX(image=X.contiguous(), n_data=N, dim=D, dim_padded=DP, y=y)
    Xp = X.new_zeros(T * TILE_N, DP)
    Xp[:N, :D] = X
    hi = tf32_round(Xp)
    lo = Xp - hi

    def rows(M):  # (t, n//8, n%8, d//4, d%4) -> (t, d//4, n//8, n%8, d%4)
        return M.view(T, TILE_N // 8, 8, DP // 4, 4).permute(0, 3, 1, 2, 4).reshape(T, -1)

    def cols(M):  # (t, n'//4, n'%4, d//8, d%8) -> (t, n'//4, d//8, d%8, n'%4)
        M = M.view(T, TILE_N // 8, 8, DP)[:, :, list(_ROW_ORDER), :]
        return M.reshape(T, TILE_N // 4, 4, DP // 8, 8).permute(0, 1, 3, 4, 2).reshape(T, -1)

    image = torch.cat([rows(hi), rows(lo), cols(hi), cols(lo)], dim=1).contiguous()
    return PreparedX(image=image, n_data=N, dim=D, dim_padded=DP, y=y)


def logreg_value_grad_split(P, X, y, prior_var, passes=3):
    """K1's arithmetic in plain PyTorch, from the labels y (N,): both
    products on TF32-rounded operands (each product of two TF32 numbers is
    exact in f32), three passes or one, f32 sums; the log-likelihood summed
    row by row from the split logits; the rest as the plain version.  Wider
    than ``MAX_DIM`` (the wide form) three passes are f32 products."""
    lam = float(prior_var)
    D = P.shape[-1]

    def product(A, B, b_rounded):  # A rounded by the kernel, B as stored
        if passes == 3 and D > MAX_DIM:
            return A @ B
        a_hi = tf32_round(A)
        b_hi = tf32_round(B)
        if passes == 1:
            return a_hi @ b_hi
        a_lo = tf32_round(A - a_hi)
        b_lo = tf32_round(B - b_hi) if b_rounded else tf32_truncate(B - b_hi)
        return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi

    logits = product(P, X.T.contiguous(), False)
    # row by row: max(z, 0) − y z is exact for labels 0 and 1
    loglik = -(
        torch.clamp_min(logits, 0.0) - y * logits + torch.log1p(torch.exp(-logits.abs()))
    ).sum(-1)
    value = (
        loglik
        - 0.5 * (P * P).sum(-1) / lam
        - 0.5 * D * math.log(2.0 * math.pi * lam)
    )
    grad = X.T @ y - product(torch.sigmoid(logits), X, False) - P / lam
    return value, grad


def _check(P, X, v, passes=3, prepared=None):
    if P.dim() != 2 or X.dim() != 2 or v.dim() != 1:
        raise ValueError(
            f"K1: expected P (C, D), X (N, D), v (D,); got {tuple(P.shape)}, "
            f"{tuple(X.shape)}, {tuple(v.shape)}"
        )
    C, D = P.shape
    if X.shape[1] != D or v.shape[0] != D:
        raise ValueError(f"K1: dims disagree: P {tuple(P.shape)}, X {tuple(X.shape)}, v {tuple(v.shape)}")
    if D < 1:
        raise ValueError(f"K1 takes D >= 1, got D={D}")
    if C < 1 or X.shape[0] < 1:
        raise ValueError("K1: empty chains or data")
    for name, t in (("P", P), ("X", X), ("v", v)):
        if t.device != P.device or t.device.type != "cuda":
            raise ValueError(f"K1: {name} is on {t.device}, expected the CUDA device of P")
        if t.dtype != torch.float32:
            raise TypeError(f"K1: {name} has dtype {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"K1: {name} is not contiguous")
    if passes not in (1, 3):
        raise ValueError(f"K1 takes passes=3 (f32-grade) or passes=1 (one TF32 pass), got {passes}")
    if prepared is None:
        raise ValueError(
            "K1 reads X and y as prepare_x(X, y) lays them out: make that once per "
            "target and pass it as prepared="
        )
    if (prepared.n_data, prepared.dim) != tuple(X.shape):
        raise ValueError(
            f"K1: prepared X is {prepared.n_data} x {prepared.dim}, X is {tuple(X.shape)}"
        )
    if prepared.image.device != P.device:
        raise ValueError(f"K1: prepared X is on {prepared.image.device}, P on {P.device}")


def logreg_value_grad(P, X, v, prior_var, passes=3, prepared=None):
    """Batched value (C,) and gradient (C, D).

    CUDA tensors launch K1 on the current stream (no synchronisation) or
    raise, wider than ``MAX_DIM`` its wide form; CPU tensors take
    ``logreg_value_grad_reference``.  ``prepared``
    is ``prepare_x(X, y)``, made once per target by the caller: the kernel
    needs it, the plain version does not.  ``passes``: 3 or 1 TF32 passes
    per product.  The call's host time goes to the tracer's ``k1.host_ns``."""
    t0 = time.perf_counter_ns()
    if P.device.type == "cpu":
        out = logreg_value_grad_reference(P, X, v, prior_var)
        tracing.add("k1.host_ns", time.perf_counter_ns() - t0)
        return out
    _check(P, X, v, passes, prepared)
    from klara_tpu_torch.ops import _build

    lib = _build.load()
    if P.data_ptr() % 16:  # the kernel reads P in 16-byte chunks
        P = P.clone()
    C, D = P.shape
    lam = float(prior_var)
    value = torch.empty(C, device=P.device, dtype=torch.float32)
    grad = torch.empty(C, D, device=P.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(P.device).cuda_stream
    log_norm = 0.5 * D * math.log(2.0 * math.pi * lam)
    with torch.cuda.device(P.device):  # the launch goes to the current device
        if prepared.wide:
            rc = lib.klara_logreg_value_grad_wide(
                P.data_ptr(), prepared.image.data_ptr(), prepared.y.data_ptr(), v.data_ptr(),
                value.data_ptr(), grad.data_ptr(), C, prepared.n_data, D, passes, 1.0 / lam,
                log_norm, stream,
            )
        else:
            rc = lib.klara_logreg_value_grad_tf32(
                P.data_ptr(), prepared.image.data_ptr(), prepared.y.data_ptr(), v.data_ptr(),
                value.data_ptr(), grad.data_ptr(), C, prepared.n_data, D, prepared.dim_padded,
                passes, 1.0 / lam, log_norm, stream,
            )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    tracing.count(_LAUNCHES)
    tracing.add("k1.host_ns", time.perf_counter_ns() - t0)
    return value, grad
