"""The yardstick's table of peaks and its counts of work, from shapes alone.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates at its 700 W
limit.  A count is the work the mathematics needs, the same whatever
implements it: each input byte read once, each output byte written once.
"""

from __future__ import annotations

TF32_FLOPS = 495e12    # dense TF32 tensor-core rate: the best an f32-grade product reaches
HBM_BYTES_PER_S = 3.35e12


def k1_flops(chains: int, n_data: int, dim: int) -> float:
    """Logistic-regression value and gradient: the logits P Xᵀ and the
    gradient's (y − σ) X, two (C, N, D) products."""
    return 4.0 * chains * n_data * dim


def k1_bytes(chains: int, n_data: int, dim: int) -> float:
    """P (C, D), X (N, D), y (N) read; the value (C) and gradient (C, D) written; f32."""
    return 4.0 * (chains * dim + n_data * dim + n_data + chains + chains * dim)


def k1_least_s(chains: int, n_data: int, dim: int) -> float:
    return max(k1_flops(chains, n_data, dim) / TF32_FLOPS,
               k1_bytes(chains, n_data, dim) / HBM_BYTES_PER_S)


def whitened_eval_flops(chains: int, n_data: int, dim: int) -> float:
    """One evaluation of the whitened target: K1's products and the two
    (C, D) × (D, D) whitening products."""
    return k1_flops(chains, n_data, dim) + 2 * 2.0 * chains * dim * dim
