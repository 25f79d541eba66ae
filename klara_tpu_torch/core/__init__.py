from klara_tpu_torch.core.target import Target, bounded_target, whiten_target

__all__ = ["Target", "bounded_target", "whiten_target"]
