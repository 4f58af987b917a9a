"""Packetization: parameter trees <-> GF(2^s) symbol packets.

The port of `repro.core.packets` (bit-exact path).  A parameter tree is
a nested dict (or list) of tensors; it flattens in JAX's leaf order
(dict keys sorted at every level, lists in order), and every leaf is bitcast to its raw
little-endian bytes in its own layout, so the (K, L) symbol matrix P is
byte-identical to the reference's for the same parameters.
`params_from_jax` carries a JAX parameter pytree across (as numpy
arrays) without touching its layouts or bits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

# ---------------------------------------------------------------------------
# trees: nested dicts (and lists) of tensors, flattened in JAX's order
# ---------------------------------------------------------------------------


def tree_flatten(tree) -> tuple[list[torch.Tensor], Any]:
    """(leaves, treedef) in JAX's order: dicts by sorted key, lists and
    tuples in order.  The treedef is the nested skeleton with None at
    every leaf."""
    if isinstance(tree, dict):
        leaves: list[torch.Tensor] = []
        treedef = {}
        for key in sorted(tree):
            sub, treedef[key] = tree_flatten(tree[key])
            leaves.extend(sub)
        return leaves, treedef
    if isinstance(tree, (list, tuple)):
        leaves, subdefs = [], []
        for item in tree:
            sub, subdef = tree_flatten(item)
            leaves.extend(sub)
            subdefs.append(subdef)
        return leaves, type(tree)(subdefs)
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"tree leaves must be tensors, got {type(tree)}")
    return [tree], None


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        if isinstance(d, dict):
            return {k: build(v) for k, v in d.items()}
        return type(d)(build(v) for v in d)

    return build(treedef)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """fn over corresponding leaves of same-structure trees."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in
                                    zip(leaves, *others, strict=True)])


def params_from_jax(tree, device="cuda", *, bf16_bits: bool = False) -> Any:
    """A JAX parameter pytree, given as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``), as the port's
    nested dicts, lists and tuples of tensors.  Layouts and dtypes stay
    as they are (conv `w` stays HWIO), so the packet bytes equal the
    reference's.  A leaf of numpy's bfloat16 extension dtype (what
    ``np.asarray`` gives for a JAX bf16 array) becomes ``torch.bfloat16``
    bit for bit.  With `bf16_bits`, the tree's ``uint16``/``int16``
    leaves are bf16 leaves' views and are reinterpreted as
    ``torch.bfloat16``; without it, they stay the integers they are."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, bf16_bits=bf16_bits)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device, bf16_bits=bf16_bits)
                          for v in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16" or (bf16_bits and
                                      a.dtype in (np.uint16, np.int16)):
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


@dataclass(frozen=True)
class PacketSpec:
    treedef: Any
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    s: int
    n_bytes: int          # total byte length before symbol split


# ---------------------------------------------------------------------------
# bytes <-> symbols
# ---------------------------------------------------------------------------

def bytes_to_symbols(b: torch.Tensor, s: int) -> torch.Tensor:
    """Split uint8 bytes (..., n) into s-bit symbols (..., n·8/s),
    s in {1,2,4,8}.  Little-endian within the byte: symbol j of a byte
    holds bits [j*s, (j+1)*s)."""
    if s == 8:
        return b
    if s not in (1, 2, 4):
        raise ValueError("byte-aligned symbol sizes are 1, 2, 4, 8")
    per = 8 // s
    shifts = torch.arange(per, dtype=torch.uint8, device=b.device) * s
    sym = (b[..., None] >> shifts) & ((1 << s) - 1)
    return sym.reshape(*b.shape[:-1], -1)


def symbols_to_bytes(sym: torch.Tensor, s: int) -> torch.Tensor:
    """Inverse of :func:`bytes_to_symbols`."""
    if s == 8:
        return sym
    per = 8 // s
    grouped = sym.reshape(*sym.shape[:-1], -1, per)
    out = torch.zeros(grouped.shape[:-1], dtype=torch.uint8,
                      device=sym.device)
    for j in range(per):
        out |= grouped[..., j] << (j * s)
    return out


# ---------------------------------------------------------------------------
# batched packetization (K clients -> one (K, L) matrix)
# ---------------------------------------------------------------------------

def pytrees_to_packets(trees: list, s: int = 8, device=None
                       ) -> tuple[torch.Tensor, PacketSpec]:
    """K same-structure trees -> (K, L) uint8 symbol matrix.

    Each leaf's K copies are stacked and bitcast to bytes once, then the
    byte rows are split into s-bit symbols.  `device` (default: where
    the leaves are) is where P is built.
    """
    if not trees:
        raise ValueError("need at least one client tree")
    leaves0, treedef = tree_flatten(trees[0])
    per_client = [tree_flatten(t)[0] for t in trees]
    K = len(trees)
    chunks = []
    for j in range(len(leaves0)):
        stacked = torch.stack([leaves[j] for leaves in per_client])
        if device is not None:
            stacked = stacked.to(device)
        stacked = stacked.contiguous()
        chunks.append(stacked.reshape(K, -1).view(torch.uint8))
    b = (torch.cat(chunks, dim=1) if chunks else
         torch.zeros((K, 0), dtype=torch.uint8, device=device))
    spec = PacketSpec(
        treedef=treedef,
        shapes=tuple(tuple(leaf.shape) for leaf in leaves0),
        dtypes=tuple(leaf.dtype for leaf in leaves0),
        s=s,
        n_bytes=int(b.shape[1]),
    )
    return bytes_to_symbols(b, s), spec


def packets_to_pytrees(P_hat: torch.Tensor, spec: PacketSpec):
    """(K, L) decoded symbols -> ONE stacked tree (leading K axis)."""
    b = symbols_to_bytes(P_hat, spec.s)[:, : spec.n_bytes]
    K = b.shape[0]
    leaves = []
    off = 0
    for shape, dtype in zip(spec.shapes, spec.dtypes, strict=True):
        n = int(np.prod(shape, dtype=np.int64))
        nbytes = n * dtype.itemsize
        chunk = b[:, off: off + nbytes].contiguous()
        leaves.append(chunk.view(dtype).reshape(K, *shape))
        off += nbytes
    return tree_unflatten(spec.treedef, leaves)
