"""The package's one rule for where tensors live.

An entry point that makes tensors (the functions of ``models.examples``, ``MCJob``,
``GibbsJob``, the converters) runs on

1. the device it is told (``device=``), else
2. the one device of the tensors it is given, else
3. the card.

Where nothing names a device and CUDA is not available it raises and names
``device="cpu"``: the port never carries on on the CPU unasked.
"""

from __future__ import annotations

import torch


def resolve_device(device=None, inputs=()) -> torch.device:
    """``device`` if given, else the device of the tensors among ``inputs``
    (tensors on several devices raise), else the current CUDA device."""
    if device is not None:
        return torch.device(device)
    held = {t.device for t in inputs if torch.is_tensor(t)}
    if len(held) > 1:
        raise ValueError(
            f"the inputs hold tensors on several devices {sorted(map(str, held))}; "
            "pass device="
        )
    if held:
        return held.pop()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no device was named, no input is a tensor and CUDA is not available: "
            'klara_tpu_torch runs on the GPU by default; pass device="cpu" to run '
            "on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
