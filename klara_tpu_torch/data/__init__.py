"""Bundled example datasets (counterpart of klara_tpu/data): ``swiss``
(200×4 banknote measurements and 200 status labels) and ``rats`` (5 ages,
30 rats' weights).  The .npz files ship with the JAX package and are read
from there by path; nothing of that package is imported."""

from __future__ import annotations

import os

import numpy as np

FILES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "klara_tpu", "data", "files",
)

_MANIFEST = {
    "swiss": ("swiss.npz", ("measurements", "status")),
    "rats": ("rats.npz", ("age", "weight")),
}


def datasets():
    """The available dataset names."""
    return sorted(_MANIFEST)


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
