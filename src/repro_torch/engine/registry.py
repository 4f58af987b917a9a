"""Kernel registry: one dispatch point for every GF coded-matmul path.

A *kernel* is a callable ``fn(A, P, *, s, out=None) -> C`` computing
C = A·P over GF(2^s) for A (n, K) uint8 and P (K, L) uint8, written
into `out` (an (n, L) uint8 tensor, possibly a column view) when one is
given.  The **seeded** family
takes ``(seeds, P)`` instead — seeds (n,) int64 holding 32-bit values —
and regenerates row i of the coding matrix from seed i
(`repro_torch.core.seeds.expand_rows`), bit-identical to its
materialized sibling on the expanded matrix.  Built-in entries:

======================  ====================================================
``table``               log/exp table oracle (independent formulation — the
                        correctness reference)
``clmul``               unpacked carry-less multiply in plain PyTorch
                        (`ref.gf_matmul_clmul_ref`; the reference's
                        ``jnp_clmul``)
``cuda``                the unpacked hand-written CUDA kernels (the
                        reference's ``pallas``): `gf2_matmul` at s=1,
                        `gf_matmul_unpacked` for s>1
``cuda_packed``         the hand-written CUDA kernel `gf_matmul_packed`
``table_seeded``        seeded table oracle: expand rows, then ``table``
``cuda_packed_seeded``  the hand-written CUDA kernel
                        `gf_matmul_packed_seeded`
``auto``                alias: ``cuda_packed``
``auto_seeded``         alias: ``cuda_packed_seeded``
======================  ====================================================

``cuda`` has no seeded sibling: its seeded name is ``table_seeded``, as
the reference pairs ``pallas`` with ``jnp_seeded``.  The CUDA entries
name the hand-written kernels on every engine device.  Their wrappers
dispatch on the tensor's device: a CUDA engine launches the kernels, a
CPU engine runs their plain PyTorch versions
(`repro_torch.kernels.ref`), and nothing depends on what the process
happens to see.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.gf2_xor import gf2_matmul
from repro_torch.kernels.gf_matmul import (gf_matmul_packed,
                                           gf_matmul_packed_seeded,
                                           gf_matmul_unpacked)

KernelFn = Callable[..., torch.Tensor]

SEEDED_SUFFIX = "_seeded"
_ALIASES = ("auto", "auto_seeded")

_KERNELS: Dict[str, KernelFn] = {}
_SEEDED: set[str] = set()


def register_kernel(name: str, fn: KernelFn, *, seeded: bool = False
                    ) -> KernelFn:
    """Register a coded-matmul backend under `name`.

    `fn(A, P, *, s, out=None)` must return A·P over GF(2^s) as (n, L)
    uint8, bit-exact against ``table``, written into `out` when one is
    given; with ``seeded=True`` the first operand is the (n,) int64 seed
    vector and the result must match ``table_seeded``.
    """
    if name in _ALIASES:
        raise ValueError(f"{name!r} is a reserved alias")
    if name in _KERNELS:
        raise ValueError(f"kernel {name!r} already registered")
    _KERNELS[name] = fn
    if seeded:
        _SEEDED.add(name)
    return fn


def available_kernels() -> tuple[str, ...]:
    return tuple(sorted(_KERNELS)) + _ALIASES


def is_seeded_kernel(name: str) -> bool:
    """True iff `name` (or either resolution of an alias) takes seeds."""
    if name in _ALIASES:
        return name == "auto_seeded"
    return name in _SEEDED


def seeded_kernel_name(name: str) -> str:
    """The seeded sibling of a materialized kernel name.

    >>> seeded_kernel_name("cuda_packed"), seeded_kernel_name("auto")
    ('cuda_packed_seeded', 'auto_seeded')
    """
    if name in _ALIASES:
        return "auto_seeded"
    if name in _SEEDED:
        return name
    candidate = name + SEEDED_SUFFIX
    # every materialized kernel's rows expand identically, so the table
    # oracle's seeded form is always a correct (if unfused) sibling
    return candidate if candidate in _SEEDED else "table_seeded"


def materialized_kernel_name(name: str) -> str:
    """The materialized sibling of a seeded kernel name.

    >>> materialized_kernel_name("cuda_packed_seeded")
    'cuda_packed'
    """
    if name in _ALIASES:
        return "auto"
    if name not in _SEEDED:
        return name
    base = name[: -len(SEEDED_SUFFIX)] if name.endswith(SEEDED_SUFFIX) \
        else name
    return base if base in _KERNELS else "table"


def resolve_kernel_name(name: str) -> str:
    """Resolve the 'auto'/'auto_seeded' aliases to the CUDA kernels."""
    return {"auto": "cuda_packed",
            "auto_seeded": "cuda_packed_seeded"}.get(name, name)


def resolve_kernel(name: str) -> tuple[str, KernelFn]:
    """(resolved_name, fn) for a registry name; raises on unknown."""
    resolved = resolve_kernel_name(name)
    try:
        return resolved, _KERNELS[resolved]
    except KeyError:
        raise ValueError(f"unknown kernel {name!r}; available: "
                         f"{available_kernels()}") from None


# ---------------------------------------------------------------------------
# built-ins
# ---------------------------------------------------------------------------

def _into(C: torch.Tensor, out) -> torch.Tensor:
    return C if out is None else out.copy_(C)


def _table_kernel(A, P, *, s: int, out=None):
    return _into(ref.gf_matmul_ref(A, P, s), out)


def _table_seeded_kernel(seeds, P, *, s: int, out=None):
    return _into(ref.gf_matmul_seeded_ref(seeds, P, s), out)


def _clmul_kernel(A, P, *, s: int, out=None):
    return _into(ref.gf_matmul_clmul_ref(A, P, s), out)


def _cuda_kernel(A, P, *, s: int, out=None):
    if s == 1:
        return gf2_matmul(A, P, out=out)
    return gf_matmul_unpacked(A, P, s=s, out=out)


register_kernel("table", _table_kernel)
register_kernel("clmul", _clmul_kernel)
register_kernel("cuda", _cuda_kernel)
register_kernel("cuda_packed", gf_matmul_packed)
register_kernel("table_seeded", _table_seeded_kernel, seeded=True)
register_kernel("cuda_packed_seeded", gf_matmul_packed_seeded, seeded=True)
