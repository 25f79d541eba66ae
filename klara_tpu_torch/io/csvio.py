"""CSV chain output and read-back (counterpart of klara_tpu/io/csvio.py).

One file per monitored field and diagnostic (``<field>.csv`` under
``filepath``), one row per draw with the chains and event coordinates
flattened into comma-separated ``%.9g`` values, a ``<field>.shape`` sidecar
and a ``manifest.json`` naming the samples and diagnostics.  The files are
byte for byte the JAX package's, so either package reads the other's
directory.  ``read_chain`` rebuilds a ``Chain`` of tensors that the stats
layer takes directly; ``ChainReader`` gives mark/reset control over a
directory a ``StreamingWriter`` is still appending to.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from klara_tpu_torch.core.device import resolve_device


def to_numpy(x) -> np.ndarray:
    """A tensor or array as a host numpy array.  Floats narrower than 32 bits
    (bf16 has no numpy dtype) widen to f32, exactly."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.is_floating_point() and torch.finfo(x.dtype).bits < 32:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def format_rows(flat: np.ndarray) -> str:
    """Rows of ``flat`` (n, k) as ``%.9g`` values joined by commas, one line
    each (the same bytes as ``np.savetxt(..., fmt="%.9g")`` and as the JAX
    writer's per-value f-strings)."""
    fmt = ",".join(["%.9g"] * flat.shape[1])
    return "".join(fmt % tuple(row) + "\n" for row in flat.tolist())


def _write_manifest(filepath, samples, diagnostics, shapes, filesuffix="csv"):
    with open(os.path.join(filepath, "manifest.json"), "w") as f:
        json.dump(
            {
                "samples": sorted(samples),
                "diagnostics": sorted(diagnostics),
                "shapes": {k: list(v) for k, v in shapes.items()},
                "filesuffix": filesuffix,
            },
            f,
        )


def _read_manifest(filepath):
    path = os.path.join(filepath, "manifest.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_chain_csv(chain, filepath: str, filesuffix: str = "csv") -> Dict[str, str]:
    """Write one file per monitored field and diagnostic of ``chain``; an
    (n_post, n_chains, ...) trace becomes n_post rows.  Returns {field: path}."""
    os.makedirs(filepath, exist_ok=True)
    written = {}
    fields = {**chain.samples, **chain.diagnostics}
    shapes = {}
    for name, arr in fields.items():
        arr = to_numpy(arr)
        fname = os.path.join(filepath, f"{name}.{filesuffix}")
        with open(fname, "w") as f:
            f.write(format_rows(np.asarray(arr.reshape(arr.shape[0], -1), np.float64)))
        written[name] = fname
        shapes[name] = arr.shape
        with open(os.path.join(filepath, f"{name}.shape"), "w") as f:
            f.write(",".join(map(str, arr.shape)))
    _write_manifest(filepath, chain.samples.keys(), chain.diagnostics.keys(), shapes,
                    filesuffix)
    return written


def read_chain_csv(filepath: str, fields=None, filesuffix: str = "csv"):
    """{field: float64 numpy array} from a directory written by
    ``write_chain_csv`` or ``StreamingWriter`` (all fields when ``fields`` is
    None).  A ``.shape`` sidecar restores the event shape; the data decides
    the draws axis (a sidecar written at the start of a stream, or by a run
    that died, may count fewer rows)."""
    out = {}
    names = fields
    if names is None:
        names = [
            f[: -len(f".{filesuffix}")]
            for f in os.listdir(filepath)
            if f.endswith(f".{filesuffix}")
        ]
    for name in names:
        # ndmin=2 keeps a single-row file as (1, D), not a (D,) vector
        flat = np.loadtxt(
            os.path.join(filepath, f"{name}.{filesuffix}"), delimiter=",", ndmin=2
        )
        shape_file = os.path.join(filepath, f"{name}.shape")
        if os.path.exists(shape_file):
            with open(shape_file) as f:
                shape = tuple(int(s) for s in f.read().split(","))
            if int(np.prod(shape)) != flat.size:
                shape = (flat.shape[0],) + shape[1:]
            flat = flat.reshape(shape)
        out[name] = flat
    return out


def read_chain(
    filepath: str,
    samples: Optional[Sequence[str]] = None,
    diagnostics: Optional[Sequence[str]] = None,
    filesuffix: str = "csv",
    device=None,
):
    """A ``Chain`` (``final_state=None``) of float64 tensors on
    ``resolve_device(device)`` from a CSV directory.  The samples and
    diagnostics come from ``manifest.json`` unless given.  ``.9g`` round-trips
    f32 and bf16 values: cast a field to its trace's dtype to get the trace
    back bit for bit."""
    from klara_tpu_torch.jobs.chain import Chain

    manifest = _read_manifest(filepath)
    if samples is None:
        if manifest is None:
            raise ValueError(
                f"{filepath} has no manifest.json; pass samples=[...] "
                "(and optionally diagnostics=[...]) explicitly"
            )
        samples = manifest["samples"]
        if diagnostics is None:
            diagnostics = manifest["diagnostics"]
    diagnostics = diagnostics or []
    device = resolve_device(device)
    raw = read_chain_csv(filepath, list(samples) + list(diagnostics), filesuffix)
    raw = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    return Chain(
        samples={k: raw[k] for k in samples},
        diagnostics={k: raw[k] for k in diagnostics},
        final_state=None,
    )


class ChainReader:
    """Incremental reader with mark/reset over the per-field files of a
    directory.  ``read_new()`` returns the rows appended since the last
    call; ``mark()``/``reset()`` record and rewind the positions."""

    def __init__(self, filepath: str, fields=None, filesuffix: str = "csv"):
        self.filepath = filepath
        self.filesuffix = filesuffix
        manifest = _read_manifest(filepath)
        if fields is None:
            if manifest is not None:
                fields = list(manifest["samples"]) + list(manifest["diagnostics"])
            else:
                fields = [
                    f[: -len(f".{filesuffix}")]
                    for f in os.listdir(filepath)
                    if f.endswith(f".{filesuffix}")
                ]
        self.fields = list(fields)
        # binary mode: byte-exact tell/seek for the partial-line rewind
        self._handles = {
            name: open(os.path.join(filepath, f"{name}.{filesuffix}"), "rb")
            for name in self.fields
        }
        self._marks = {name: 0 for name in self.fields}
        # column counts for shape-stable empty reads: from the manifest,
        # else learned from the first non-empty read
        self._ncols = {}
        if manifest is not None:
            for name, shape in manifest.get("shapes", {}).items():
                if len(shape) >= 2:
                    self._ncols[name] = int(np.prod(shape[1:]))

    def mark(self):
        """Record the current positions."""
        self._marks = {name: h.tell() for name, h in self._handles.items()}

    def reset(self):
        """Rewind to the marked positions."""
        for name, h in self._handles.items():
            h.seek(self._marks[name])

    def read_new(self) -> Dict[str, np.ndarray]:
        """{field: (n_new_rows, n_cols) array} of the complete rows appended
        since the last read; (0, n_cols) where there are none ((0, 0) while
        the width is unknown).  A partly written trailing line stays in the
        file for the next read."""
        out = {}
        for name, h in self._handles.items():
            pos = h.tell()
            chunk = h.read()
            cut = chunk.rfind(b"\n") + 1
            h.seek(pos + cut)
            lines = [ln for ln in chunk[:cut].decode().splitlines() if ln.strip()]
            if lines:
                arr = np.asarray([[float(v) for v in ln.split(",")] for ln in lines])
                self._ncols.setdefault(name, arr.shape[1])
                out[name] = arr
            else:
                out[name] = np.zeros((0, self._ncols.get(name, 0)))
        return out

    def close(self):
        for h in self._handles.values():
            h.close()
        self._handles.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
