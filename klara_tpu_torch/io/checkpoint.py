"""Full-state checkpoint and resume (counterpart of klara_tpu/io/checkpoint.py).

A checkpoint holds any tree of dicts, lists, tuples, NamedTuples and
dataclasses over tensors: chain buffers, sampler and tuner state, and
``torch.Generator``s, so a run resumes bit for bit:

    save_checkpoint(path, {"state": chain.final_state, "generator": gen})
    tree = load_checkpoint(path, like={"state": ..., "generator": ...})

The file is one ``.npz`` of leaves keyed by their paths in the tree, written
as ``jax.tree_util.keystr`` writes them (``['state'].position``,
``['n'][0]``), so both packages name the leaves of one structure alike.  A
generator is stored as its ``get_state()`` bytes, a bf16 tensor as its int16
bits.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch


def _children(node):
    """[(key string, child)] of an inner node of the tree, None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", v) for k, v in sorted(node.items())]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{name}", getattr(node, name)) for name in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def _leaf_paths(tree, prefix=""):
    """[(key string, leaf)] in flattening order; None is an empty subtree."""
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [(prefix, tree)]
    out = []
    for key, child in children:
        out.extend(_leaf_paths(child, prefix + key))
    return out


def _to_saved(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)
        return leaf.numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any) -> None:
    """Write the leaves of ``tree`` to ``path`` (.npz), keyed by their paths."""
    entries = {k: _to_saved(v) for k, v in _leaf_paths(tree)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **entries)


def load_checkpoint(path: str, like: Any = None) -> Any:
    """The checkpoint at ``path``: rebuilt in the structure of ``like`` when
    it is given, else a flat {key string: array} dict."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    if like is None:
        return flat
    return restore_like(like, flat)


def _restored(leaf, raw: np.ndarray):
    """``raw`` as a leaf like ``leaf``: a tensor of its dtype on its device, a
    generator of its device with the saved state, an array or a number of
    its type."""
    if isinstance(leaf, torch.Generator):
        g = torch.Generator(device=leaf.device)
        g.set_state(torch.from_numpy(np.ascontiguousarray(raw)))
        return g
    if torch.is_tensor(leaf):
        t = torch.from_numpy(np.array(raw))
        if leaf.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return np.asarray(raw, leaf.dtype)
    return type(leaf)(raw)


def _rebuild(node, prefix, flat):
    if node is None:
        return None
    children = _children(node)
    if children is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        return _restored(node, flat[prefix])
    new = {key: _rebuild(child, prefix + key, flat) for key, child in children}
    if isinstance(node, dict):
        return type(node)((k, new[f"[{k!r}]"]) for k in node)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(new[f".{n}"] for n in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(new[f"[{i}]"] for i in range(len(node)))
    return dataclasses.replace(
        node, **{f.name: new[f".{f.name}"] for f in dataclasses.fields(node) if f.init})


def restore_like(like: Any, flat: dict) -> Any:
    """The tree ``like`` with every leaf taken from ``flat`` and put on its
    template leaf's device and dtype."""
    return _rebuild(like, "", flat)
