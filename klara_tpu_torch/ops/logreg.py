"""Batched logistic-regression log-density + gradient: kernel K1 and its
plain PyTorch version.

Counterpart of klara_tpu/ops/logreg.py (``fused_logreg_value_grad``, the
Pallas kernel, and ``_xla_value_grad_batched``).  For chains P (C, D), data
X (N, D) and v = Xᵀy (D,):

    value_c = p_c·v − Σ_n softplus(x_n·p_c) − ‖p_c‖²/(2λ) − ½D·log(2πλ)
    grad_c  = v − σ(X p_c)ᵀX − p_c/λ

``logreg_value_grad`` launches the hand-written CUDA kernel
(``csrc/logreg.cu``) for CUDA tensors and takes the plain version for CPU
tensors.  The port is batch-first, so this one function is the logreg
target's value+grad: the JAX package's ``make_logreg_target`` /
``custom_vmap`` dispatch has no counterpart here.
"""

from __future__ import annotations

import math

import torch

MAX_DIM = 128  # K1 keeps 4 gradient columns per lane of a warp

# Number of K1 launches in this process (a plain counter; reset it by
# assignment).  Incremented only where the kernel is launched.
KERNEL_LAUNCHES = 0


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


def _check(P, X, v):
    if P.dim() != 2 or X.dim() != 2 or v.dim() != 1:
        raise ValueError(
            f"K1: expected P (C, D), X (N, D), v (D,); got {tuple(P.shape)}, "
            f"{tuple(X.shape)}, {tuple(v.shape)}"
        )
    C, D = P.shape
    if X.shape[1] != D or v.shape[0] != D:
        raise ValueError(f"K1: dims disagree: P {tuple(P.shape)}, X {tuple(X.shape)}, v {tuple(v.shape)}")
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"K1 takes 1 <= D <= {MAX_DIM}, got D={D}")
    if C < 1 or X.shape[0] < 1:
        raise ValueError("K1: empty chains or data")
    for name, t in (("P", P), ("X", X), ("v", v)):
        if t.device != P.device or t.device.type != "cuda":
            raise ValueError(f"K1: {name} is on {t.device}, expected the CUDA device of P")
        if t.dtype != torch.float32:
            raise TypeError(f"K1: {name} has dtype {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"K1: {name} is not contiguous")


def logreg_value_grad(P, X, v, prior_var):
    """Batched value (C,) and gradient (C, D).

    CUDA tensors launch K1 on the current stream (no synchronisation) or
    raise; CPU tensors take ``logreg_value_grad_reference``."""
    if P.device.type == "cpu":
        return logreg_value_grad_reference(P, X, v, prior_var)
    global KERNEL_LAUNCHES
    _check(P, X, v)
    from klara_tpu_torch.ops import _build

    lib = _build.load()
    C, D = P.shape
    N = X.shape[0]
    lam = float(prior_var)
    value = torch.empty(C, device=P.device, dtype=torch.float32)
    grad = torch.empty(C, D, device=P.device, dtype=torch.float32)
    with torch.cuda.device(P.device):  # the launch goes to the current device
        rc = lib.klara_logreg_value_grad_f32(
            P.data_ptr(), X.data_ptr(), v.data_ptr(), value.data_ptr(),
            grad.data_ptr(), C, N, D, 1.0 / lam,
            0.5 * D * math.log(2.0 * math.pi * lam),
            torch.cuda.current_stream(P.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    KERNEL_LAUNCHES += 1
    return value, grad
