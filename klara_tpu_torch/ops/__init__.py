"""Hand-written CUDA kernels for hot compute paths, each with its plain
PyTorch version (counterpart of klara_tpu/ops)."""

from klara_tpu_torch.ops.logreg import logreg_value_grad, logreg_value_grad_reference

__all__ = ["logreg_value_grad", "logreg_value_grad_reference"]
