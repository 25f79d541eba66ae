"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` becomes its own shared library
``_build/lib<name>.so`` beside this file (listed in ``.gitignore``), with
the flags of ``NVCC_FLAGS`` and that source's ``EXTRA_FLAGS``.  ``build``
starts one nvcc per missing or stale library, all at once, and waits for
them; it runs at first use, in the process that first launches a kernel,
and again whenever a source is newer than its library.  Nothing here runs
at import time, so the package imports on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# K2 rounds every multiply and add apart, as its plain version does
EXTRA_FLAGS = {"keyed_draws": ("-fmad=false",)}

_P, _I = ctypes.c_void_p, ctypes.c_int
# each library's entry points and their C signatures
ENTRY = {
    "logreg": {"klara_logreg_value_grad_tf32": [_P] * 6 + [_I] * 5 + [ctypes.c_float] * 2 + [_P],
               "klara_logreg_value_grad_wide": [_P] * 6 + [_I] * 4 + [ctypes.c_float] * 2 + [_P]},
    # the launch arguments packed in one struct (keyed.py: _ARGS), the stream
    "keyed_draws": {"klara_keyed_draws": [ctypes.c_char_p, _P],
                    "klara_keyed_draws_info": [_I, _I, _P]},
    # the batch, the factor's slots, the shift or y (or null), the output;
    # C, D, forward, the grid; the stream
    "tri_factor": {"klara_tri_factor": [_P] * 4 + [_I] * 4 + [_P]},
}

_libs = {}
build_log = ""  # nvcc's output of the last build in this process (-Xptxas -v)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str, source: str) -> bool:
    path = lib_path(name)
    return not os.path.exists(path) or os.path.getmtime(source) > os.path.getmtime(path)


def build() -> dict:
    """Compile every missing or stale ``csrc/*.cu``, one nvcc each, all
    started together; return {name: library path}.  A failed build raises."""
    global build_log
    sources = {os.path.basename(s)[:-3]: s for s in sorted(glob.glob(os.path.join(CSRC, "*.cu")))}
    todo = {n: s for n, s in sources.items() if _stale(n, s)}
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name, src in todo.items():
            tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o", tmp, src]
            procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
        logs, failed = [], []
        for name, (tmp, proc) in procs.items():
            out = proc.communicate()[0]
            logs.append(f"[{name}]\n{out}")
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, lib_path(name))
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return {n: lib_path(n) for n in sources}


def load(name: str = "logreg") -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, the kernels built first if
    needed."""
    if name not in _libs:
        paths = build()
        lib = ctypes.CDLL(paths[name])
        for symbol, argtypes in ENTRY[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]
