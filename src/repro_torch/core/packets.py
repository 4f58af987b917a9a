"""Packetization: parameter trees <-> GF(2^s) symbol packets.

The port of `repro.core.packets` (bit-exact path).  A parameter tree is
a nested dict (or list) of tensors; it flattens in JAX's leaf order
(dict keys sorted at every level, lists in order), and every leaf is bitcast to its raw
little-endian bytes in its own layout, so the (K, L) symbol matrix P is
byte-identical to the reference's for the same parameters.
`params_from_jax` carries a JAX parameter pytree across (as numpy
arrays) without touching its layouts or bits.  `pack_seed_packet` /
`unpack_seed_packet` are the seeded wire format (4 seed bytes, then the
payload).  `quantize_pytree` / `dequantize_pytree` are the lossy int8
variant (`FedNCConfig.quantize_bits`).
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


def _build(d, it) -> Any:
    if d is None:
        return next(it)
    if isinstance(d, dict):
        return {k: _build(v, it) for k, v in d.items()}
    return type(d)(_build(v, it) for v in d)


def tree_unflatten(treedef, leaves) -> Any:
    # a module-level builder: a nested one that calls itself is a
    # reference cycle, which would keep `leaves` (a whole gradient
    # stack) alive until the garbage collector happens to run
    return _build(treedef, iter(leaves))


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
        # np.array copies into a contiguous array of a's shape (0-d stays
        # 0-d; np.ascontiguousarray would make it (1,))
        bits = torch.from_numpy(np.array(a).view(np.int16))
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
# one tree <-> one packet
# ---------------------------------------------------------------------------

def _leaf_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """A leaf's raw little-endian bytes, in its own layout."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def _bytes_to_leaf(b: torch.Tensor, shape, dtype: torch.dtype
                   ) -> torch.Tensor:
    """A leaf from its bytes; a copy, since a slice of the packet may
    not be aligned to the dtype's width."""
    return b.clone().view(dtype).reshape(shape)


def pytree_to_packet(tree, s: int = 8) -> tuple[torch.Tensor, PacketSpec]:
    """Flatten a tree into one GF(2^s) symbol packet (bit-exact)."""
    leaves, treedef = tree_flatten(tree)
    chunks = [_leaf_to_bytes(leaf) for leaf in leaves]
    b = (torch.cat(chunks) if chunks
         else torch.zeros((0,), dtype=torch.uint8))
    spec = PacketSpec(
        treedef=treedef,
        shapes=tuple(tuple(leaf.shape) for leaf in leaves),
        dtypes=tuple(leaf.dtype for leaf in leaves),
        s=s,
        n_bytes=int(b.shape[0]),
    )
    return bytes_to_symbols(b, s), spec


def packet_to_pytree(packet: torch.Tensor, spec: PacketSpec):
    """Reassemble the tree from a symbol packet (bit-exact inverse)."""
    b = symbols_to_bytes(packet, spec.s)[: spec.n_bytes]
    leaves = []
    off = 0
    for shape, dtype in zip(spec.shapes, spec.dtypes, strict=True):
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        leaves.append(_bytes_to_leaf(b[off: off + nbytes], shape, dtype))
        off += nbytes
    return tree_unflatten(spec.treedef, leaves)


def stack_packets(packets: list[torch.Tensor]) -> torch.Tensor:
    """K same-length packets -> P matrix (K, L) for RLNC (paper eq. P)."""
    L = packets[0].shape[0]
    for p in packets:
        if tuple(p.shape) != (L,):
            raise ValueError("all client packets must have equal length")
    return torch.stack(packets, dim=0)


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


# ---------------------------------------------------------------------------
# wire sizes: a materialized K-symbol row or a 4-byte seed, then the payload
# ---------------------------------------------------------------------------

SEED_WIRE_BYTES = 4


def coding_row_wire_bytes(K: int, s: int) -> int:
    """Bytes a materialized K-symbol GF(2^s) coding row occupies."""
    return -(-K * s // 8)


def packet_wire_bytes(K: int, payload_symbols: int, s: int,
                      *, seeded: bool) -> int:
    """Total wire bytes of one encoded tuple (header + payload).

    >>> packet_wire_bytes(128, 4096, 8, seeded=False)   # K + L
    4224
    >>> packet_wire_bytes(128, 4096, 8, seeded=True)    # 4 + L
    4100
    """
    header = SEED_WIRE_BYTES if seeded else coding_row_wire_bytes(K, s)
    return header + -(-payload_symbols * s // 8)


def pack_seed_packet(seed, payload: torch.Tensor, s: int) -> torch.Tensor:
    """Serialize one seeded tuple: 4 seed bytes (little-endian), then
    the payload bytes, on the payload's device."""
    value = int(seed) & 0xFFFFFFFF
    head = torch.tensor([(value >> (8 * i)) & 0xFF
                         for i in range(SEED_WIRE_BYTES)],
                        dtype=torch.uint8, device=payload.device)
    return torch.cat([head, symbols_to_bytes(payload.to(torch.uint8), s)])


def unpack_seed_packet(buf: torch.Tensor, s: int
                       ) -> tuple[int, torch.Tensor]:
    """Inverse of :func:`pack_seed_packet`: (seed, payload symbols);
    the seed is a Python int holding the 32-bit value."""
    buf = torch.as_tensor(buf, dtype=torch.uint8)
    head = buf[:SEED_WIRE_BYTES].cpu().tolist()
    seed = sum(int(v) << (8 * i) for i, v in enumerate(head))
    return seed, bytes_to_symbols(buf[SEED_WIRE_BYTES:], s)


# ---------------------------------------------------------------------------
# quantized variant (paper ref [22]: pruning-quantization coding design)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QuantSpec:
    scales: tuple[float, ...]
    zeros: tuple[float, ...]


def quantize_pytree(tree, bits: int = 8):
    """Per-tensor affine quantization to uint8 in [0, 2^bits), in
    float32 as the reference computes it (round half to even)."""
    leaves, treedef = tree_flatten(tree)
    qleaves, scales, zeros = [], [], []
    qmax = float(2**bits - 1)
    for leaf in leaves:
        leaf = leaf.to(torch.float32)
        lo = torch.min(leaf)
        hi = torch.max(leaf)
        scale = torch.clamp((hi - lo) / qmax, min=1e-12)
        q = torch.clamp(torch.round((leaf - lo) / scale), 0, qmax)
        qleaves.append(q.to(torch.uint8))
        scales.append(float(scale))
        zeros.append(float(lo))
    return tree_unflatten(treedef, qleaves), QuantSpec(tuple(scales),
                                                       tuple(zeros))


def dequantize_pytree(qtree, qspec: QuantSpec):
    leaves, treedef = tree_flatten(qtree)
    out = [q.to(torch.float32) * s + z
           for q, s, z in zip(leaves, qspec.scales, qspec.zeros, strict=True)]
    return tree_unflatten(treedef, out)
