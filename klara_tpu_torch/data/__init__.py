"""Bundled example datasets (counterpart of the JAX package's data module): ``swiss``
(200×4 banknote measurements and 200 status labels) and ``rats`` (5 ages,
30 rats' weights), stored as .npz under ``files/``, and the list of the
runnable examples under ``examples_torch/``."""

from __future__ import annotations

import os

import numpy as np

FILES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "files")
EXAMPLES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "examples_torch",
)

_MANIFEST = {
    "swiss": ("swiss.npz", ("measurements", "status")),
    "rats": ("rats.npz", ("age", "weight")),
}

__all__ = ["dataset", "datasets", "examples"]


def datasets():
    """The available dataset names."""
    return sorted(_MANIFEST)


def examples():
    """The runnable examples' names (the modules of ``examples_torch/``
    but its runner and package file); empty where the directory is absent."""
    if not os.path.isdir(EXAMPLES):
        return []
    return sorted(
        f[:-3] for f in os.listdir(EXAMPLES)
        if f.endswith(".py") and f != "run_examples.py" and not f.startswith("_")
    )


def dataset(name: str, *fields: str):
    """Dataset arrays as numpy: one array for one field, a tuple for
    several, a dict of all fields for none."""
    if name not in _MANIFEST:
        raise KeyError(f"unknown dataset {name!r}; available: {datasets()}")
    fname, available = _MANIFEST[name]
    for f in fields:
        if f not in available:
            raise KeyError(f"dataset {name!r} has fields {available}")
    with np.load(os.path.join(FILES, fname)) as z:
        if not fields:
            return {k: z[k] for k in available}
        out = tuple(z[f] for f in fields)
    return out[0] if len(out) == 1 else out
