"""The port's runnable examples (counterpart of examples/): the same
workloads and assertions, through klara_tpu_torch.  Run them with
``python examples_torch/run_examples.py``."""
