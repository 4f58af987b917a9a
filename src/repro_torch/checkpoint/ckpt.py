"""Checkpointing: trees of tensors <-> npz + JSON manifest.

The port of `repro.checkpoint.ckpt`, in its on-disk format: one npz
array per leaf, keyed by the slash-joined tree path (dict keys in
sorted order, list and tuple indices, NamedTuple field names: JAX's
flattening order and key names), and ``<base>.manifest.json`` with the
sorted ``keys`` and the caller's ``metadata``.  npz has no bf16, so a
bf16 leaf is widened to float32 on save (losslessly) and cast back to
the dtype of the template leaf on load.  Leaves load onto a given
device.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[list[tuple[str, Any]]]:
    """(key name, child) pairs in JAX's order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _named_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out += _named_leaves(child, f"{prefix}/{name}" if prefix else name)
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:      # npz has no bf16: widen
            t = t.float()                  # (lossless; load casts back)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_names(tree: Any) -> dict[str, np.ndarray]:
    return {name: _to_numpy(leaf) for name, leaf in _named_leaves(tree)}


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _manifest_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".manifest.json"


def save_pytree(path: str, tree: Any, *, metadata: Optional[dict] = None
                ) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten_with_names(tree)
    np.savez(_npz_path(path), **flat)
    manifest = {
        "keys": sorted(flat),
        "metadata": metadata or {},
    }
    with open(_manifest_path(path), "w") as f:
        json.dump(manifest, f, indent=1)


def _rebuild(like, leaves):
    kids = _children(like)
    if kids is None:
        return next(leaves)
    built = [_rebuild(child, leaves) for _, child in kids]
    if isinstance(like, dict):
        return dict(zip(sorted(like), built, strict=True))
    if _is_namedtuple(like):
        return type(like)(*built)
    return type(like)(built)


def _load_leaf(arr: np.ndarray, like, device):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(
            device=like.device if device is None else device,
            dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return type(like)(arr)                 # a Python number


def load_pytree(path: str, like: Any, device=None) -> Any:
    """Load into the structure of `like` (names must match): each leaf
    takes the template leaf's dtype, and lands on `device` (default: the
    template leaf's device)."""
    with np.load(_npz_path(path)) as npz:
        leaves = [_load_leaf(npz[name], leaf, device)
                  for name, leaf in _named_leaves(like)]
    return _rebuild(like, iter(leaves))


def restore(path: str, like: Any, device=None) -> Any:
    """`load_pytree` onto `device`.  The reference's `restore` places
    leaves on a sharding tree; the port's mesh is one card
    (`launch.mesh`)."""
    return load_pytree(path, like, device)


# convenience aliases
save = save_pytree
