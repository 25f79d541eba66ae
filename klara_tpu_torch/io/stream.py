"""Streaming of draws to CSV during a run (counterpart of
klara_tpu/io/stream.py).

The JAX package pushes each chunk of saved draws from inside its compiled
scan through an ordered ``io_callback``.  Here the jobs' step loop runs on
the host, so the jobs call ``append_block`` themselves: saved draws gather
in a ``DrawRing`` of ``stream_chunk`` rows on the job's device and reach the
host in one copy per field a chunk (``MCJob``, ``GibbsJob``).  The directory reads
back through ``klara_tpu_torch.io.read_chain`` like one written by
``write_chain_csv``, and has the same bytes as the JAX writer's.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from klara_tpu_torch.io.csvio import _write_manifest, format_rows, to_numpy
from klara_tpu_torch.parallel.mesh import gather_to_first


class DrawRing:
    """The draws saved in one chunk of steps, ``rows`` rows a field, each
    field at its own dtype on its own device.  ``take`` brings the filled
    rows to the host: on a CUDA device one copy per field into pinned memory
    and one stream synchronise, the chunk's only host read."""

    def __init__(self, rows: int):
        self.rows = rows
        self.count = 0
        self.bufs: Dict[str, torch.Tensor] = {}
        self._pinned: Dict[str, torch.Tensor] = {}

    def save(self, fields: Dict[str, torch.Tensor]) -> None:
        for name, val in fields.items():
            buf = self.bufs.get(name)
            if buf is None:
                buf = self.bufs[name] = torch.empty(
                    (self.rows,) + tuple(val.shape), dtype=val.dtype, device=val.device)
            buf[self.count].copy_(val)
        self.count += 1

    def take(self, block=None):
        """(count, {field: host tensor of its first ``count`` rows}) and an
        empty ring.  A CPU ring hands out views of itself, valid until the
        next ``save``.  With a split chains ``block`` (``parallel.mesh``)
        the rows of every rank of its group are gathered along the chains
        axis to the group's first rank, and the others get (count, None)."""
        n, self.count = self.count, 0
        if n == 0:
            return 0, {}
        if block is not None and block.split:
            rows = {name: gather_to_first(buf[:n], block, dim=1)
                    for name, buf in self.bufs.items()}
            return n, (None if block.rank else {k: v.cpu() for k, v in rows.items()})
        out, stream = {}, None
        for name, buf in self.bufs.items():
            if buf.device.type == "cpu":
                out[name] = buf[:n]
                continue
            host = self._pinned.get(name)
            if host is None:
                host = self._pinned[name] = torch.empty(buf.shape, dtype=buf.dtype,
                                                        pin_memory=True)
            host[:n].copy_(buf[:n], non_blocking=True)
            out[name] = host[:n]
            stream = torch.cuda.current_stream(buf.device)
        if stream is not None:
            stream.synchronize()
        return n, out


class StreamingWriter:
    """Appends rows of draws to one file per field.

    ``sample_fields`` (optional) names the monitored samples; the other
    fields are diagnostics.  The manifest and the ``.shape`` sidecars are
    written when a field first appears, so the output of a run that dies
    still reads back, and again with the final row counts on ``close``.
    Files open in append mode, so a writer reused after ``close`` (a
    ``resume``) adds a segment."""

    def __init__(
        self,
        filepath: str,
        filesuffix: str = "csv",
        flush: bool = False,
        sample_fields: Optional[set] = None,
    ):
        self.filepath = filepath
        self.filesuffix = filesuffix
        self.flush = flush
        self.sample_fields = sample_fields
        self._handles: Dict[str, object] = {}
        self._shapes: Dict[str, tuple] = {}
        self._rows: Dict[str, int] = {}
        os.makedirs(filepath, exist_ok=True)

    def _handle(self, name):
        if name not in self._handles:
            self._handles[name] = open(
                os.path.join(self.filepath, f"{name}.{self.filesuffix}"), "a"
            )
        return self._handles[name]

    def append(self, do_save, fields) -> None:
        """Append one row per field (arrays or tensors) when ``do_save``."""
        if bool(do_save):
            self.append_block(1, {name: to_numpy(a)[None] for name, a in fields.items()})

    def append_block(self, count, fields) -> None:
        """Append the first ``count`` rows of each field; ``fields`` holds
        arrays or host tensors with a leading chunk axis."""
        count = int(count)
        if count <= 0:
            return
        new_field = False
        for name, arr in fields.items():
            arr = np.asarray(to_numpy(arr)[:count], np.float64)
            if name not in self._shapes:
                self._shapes[name] = arr.shape[1:]
                new_field = True
            self._rows[name] = self._rows.get(name, 0) + count
            h = self._handle(name)
            h.write(format_rows(arr.reshape(count, -1)))
            if self.flush:
                h.flush()
        if new_field:
            self._write_sidecars()

    def _write_sidecars(self):
        shapes = {
            name: (self._rows.get(name, 0),) + shape
            for name, shape in self._shapes.items()
        }
        for name, shape in shapes.items():
            with open(os.path.join(self.filepath, f"{name}.shape"), "w") as f:
                f.write(",".join(map(str, shape)))
        if self.sample_fields is None:
            samples, diagnostics = list(self._shapes), []
        else:
            samples = [n for n in self._shapes if n in self.sample_fields]
            diagnostics = [n for n in self._shapes if n not in self.sample_fields]
        _write_manifest(self.filepath, samples, diagnostics, shapes, self.filesuffix)

    def close(self):
        for h in self._handles.values():
            h.close()
        self._handles.clear()
        if self._shapes:
            self._write_sidecars()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
