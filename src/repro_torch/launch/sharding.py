"""Sharding rules: parameter / optimizer / batch / cache specs.

The port of `repro.launch.sharding`.  The rules are pure functions of a
tree path, a shape and the mesh's axis sizes (a `DeviceMesh`, or a
mapping such as ``{"data": 16, "model": 16}``), so the reference's
16 x 16 topology can be evaluated without its 256 devices.  A spec is
a tuple with one entry per tensor dim: an axis name, a tuple of axis
names (the batch over ("pod", "data")), or None (replicated): the
reference's `PartitionSpec` as a plain tuple.  `to_placements` turns a
spec into DTensor placements on a real `DeviceMesh`; on the port's one
card every axis has size 1, and applying them changes no value.

Right-aligned template rules keyed on tree-path substrings: a template
like (DATA, MODEL) applies to the trailing dims of the leaf, leading
dims replicate.  The reference's leading dim is the `lax.scan` group
axis; the port keeps one parameter dict per layer (paths like
``decoder/3/attn/wq/w``), so the same templates land on the same
trailing dims, and `left_skip_scan`'s offset = len(shape) - 3 puts an
expert stack's (E, din, dout) at offset 0.  Dims that do not divide the
mesh axis fall back to replication (logged).
"""
from __future__ import annotations

import logging
from typing import Any, Optional

import torch
from torch.distributed.tensor import Replicate, Shard

from .mesh import axis_sizes, batch_axes

log = logging.getLogger("repro_torch.sharding")

DATA, MODEL = "data", "model"
Spec = tuple


def _fits(dim: int, sizes: dict, axis: Optional[str]) -> Optional[str]:
    if axis is None:
        return None
    size = sizes[axis]
    if dim % size == 0:
        return axis
    log.debug("dim %d not divisible by %s=%d -> replicated", dim, axis, size)
    return None


def _apply_template(shape: tuple, template: tuple, mesh,
                    align: str = "right") -> Spec:
    """Template entries map to trailing (right) or leading (left) dims."""
    sizes = axis_sizes(mesh)
    spec: list = [None] * len(shape)
    if align == "right":
        for i, ax in enumerate(reversed(template)):
            d = len(shape) - 1 - i
            if d >= 0:
                spec[d] = _fits(shape[d], sizes, ax)
    else:
        for d, ax in enumerate(template):
            if d < len(shape):
                spec[d] = _fits(shape[d], sizes, ax)
    return tuple(spec)


# MoE expert-weight inner sharding:
#   'dmodel' (baseline/ZeRO): w_gate/w_up (E, d@data, ff) — the d_model
#       contraction dim is sharded
#   'dff': (E, d, ff@data) — the contraction dim whole
MOE_INNER = "dmodel"


def set_moe_inner_shard(mode: str) -> None:
    if mode not in ("dmodel", "dff"):
        raise ValueError(f"unknown MoE inner shard {mode!r}")
    globals()["MOE_INNER"] = mode


def _param_rules():
    up_tmpl = ((MODEL, DATA, None) if MOE_INNER == "dmodel"
               else (MODEL, None, DATA))
    return [
        ("moe/w_gate", up_tmpl, "left_skip_scan"),
        ("moe/w_up", up_tmpl, "left_skip_scan"),
        ("moe/w_down", (MODEL, DATA, None), "left_skip_scan"),
        ("moe/router", (DATA, None), "right"),
        ("embed/table", (MODEL, DATA), "right"),
        ("lm_head", (DATA, MODEL), "right"),
        ("conv_w", (None, MODEL), "right"),
        ("lam", (MODEL,), "right"),
    ]


def param_spec_for(path: str, shape: tuple, mesh) -> Spec:
    if len(shape) == 0:
        return ()
    sizes = axis_sizes(mesh)
    for sub, template, align in _param_rules():
        if sub in path:
            if align == "left_skip_scan":
                # expert weights: (E, din, dout) or (G, E, din, dout)
                offset = len(shape) - 3
                spec = [None] * len(shape)
                for j, ax in enumerate(template):
                    d = offset + j
                    spec[d] = _fits(shape[d], sizes, ax)
                return tuple(spec)
            return _apply_template(shape, template, sizes, align)
    if len(shape) == 1:
        return (None,)
    # generic matrix: in-dim -> data (ZeRO), out-dim -> model
    return _apply_template(shape, (DATA, MODEL), sizes)


def tree_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) of every tensor of a nested dict / list / tuple
    tree, paths joined by "/" (list indices as numbers), in order;
    non-tensor leaves (a cache's int ``pos``) are skipped."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)] if isinstance(tree, torch.Tensor) else []
    out = []
    for k, v in items:
        out += tree_paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _map_paths(tree: Any, fn, prefix: str = "") -> Any:
    """`tree` with each tensor leaf replaced by fn(path, leaf)."""
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(v, fn, f"{prefix}/{i}" if prefix
                                     else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree) if isinstance(tree, torch.Tensor) else tree


def param_shardings(params: Any, mesh) -> Any:
    """Parameter tree -> a tree of specs."""
    return _map_paths(params, lambda p, t: param_spec_for(
        p, tuple(t.shape), mesh))


# ---------------------------------------------------------------------------
# batches & caches
# ---------------------------------------------------------------------------

def _batch_entry(sizes: dict):
    axes = batch_axes(sizes)
    total = 1
    for a in axes:
        total *= sizes[a]
    return (axes if len(axes) > 1 else axes[0]) if axes else None, total


def batch_spec(shape: tuple, mesh) -> Spec:
    """Leading dim = global batch -> (pod,)data when divisible."""
    sizes = axis_sizes(mesh)
    if len(shape) == 0:
        return ()
    first, total = _batch_entry(sizes)
    if first is not None and shape[0] % total == 0 and shape[0] > 0:
        return (first,) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


def batch_shardings(batch: Any, mesh) -> Any:
    return _map_paths(batch, lambda p, t: batch_spec(tuple(t.shape), mesh))


_CACHE_RULES = [
    # (leaf name, template) right-aligned
    ("k", (None, MODEL, None, None)),      # (B, slots, KV, hd)
    ("v", (None, MODEL, None, None)),
    ("ckv", (None, MODEL, None)),          # (B, slots, r)
    ("krope", (None, MODEL, None)),
    ("conv", (None, None, MODEL)),         # (B, cw-1, w)
    ("h", (None, MODEL)),                  # (B, w)
    ("C", (None, None, None, None)),       # mlstm matrix memory
    ("n", (None, None, None)),
    ("m", (None, None)),
    ("c", (None, MODEL)),                  # slstm
    ("pos", ()),
]


def cache_spec_for(path: str, shape: tuple, mesh) -> Spec:
    sizes = axis_sizes(mesh)
    name = path.rsplit("/", 1)[-1]
    for leaf_name, template in _CACHE_RULES:
        if name == leaf_name:
            spec = list(_apply_template(shape, template, sizes))
            # batch dim: right-aligned template leaves leading dims None;
            # shard the batch dim (first of the template window) on data
            boff = len(shape) - len(template)
            if len(template) and boff >= 0:
                first, total = _batch_entry(sizes)
                if first is not None and shape[boff] % max(total, 1) == 0:
                    spec[boff] = first
            return tuple(spec)
    return (None,) * len(shape)


def cache_shardings(cache: Any, mesh) -> Any:
    return _map_paths(cache, lambda p, t: cache_spec_for(
        p, tuple(t.shape), mesh))


def replicated(mesh) -> Spec:
    """The fully replicated spec of any rank (the reference's P())."""
    return ()


# ---------------------------------------------------------------------------
# coded packets (engine lane parallelism)
# ---------------------------------------------------------------------------

def replicated_spec(ndim: int) -> Spec:
    """All-dims-replicated spec (coding matrices: tiny, everywhere)."""
    return (None,) * ndim


def coded_spec(ndim: int, mesh, axis: str = "data") -> Spec:
    """Spec for coded symbol matrices (..., L): lanes shard on `axis`.
    RLNC mixes clients (rows); every lane (column) is independent, so
    L splits across the mesh with zero communication.  Falls back to
    full replication when the axis is absent."""
    if ndim == 0 or axis not in axis_sizes(mesh):
        return replicated_spec(ndim)
    return (None,) * (ndim - 1) + (axis,)


def opt_shardings(opt_state: Any, mesh, params_template: Any = None) -> Any:
    """Optimizer slots mirror the parameter tree's specs (slots are
    tree_map images of params, so the same path rules match); the step
    count and 0-d leaves replicate.  `opt_state` is an `OptState` or its
    slots tree."""
    slots = getattr(opt_state, "slots", opt_state)
    return _map_paths(slots, lambda p, t: () if t.dim() == 0
                      else param_spec_for(p, tuple(t.shape), mesh))


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def to_placements(spec: Spec, mesh) -> tuple:
    """A spec as DTensor placements on `mesh` (a DeviceMesh): for each
    mesh axis in order, Shard(d) of the tensor dim d it names, else
    Replicate()."""
    placements = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple)
                                     and axis in entry)]
        placements.append(Shard(dims[0]) if dims else Replicate())
    return tuple(placements)
