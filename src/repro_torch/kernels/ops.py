"""Public entry points over the kernels.

The port of `repro.kernels.ops`: `flash_attention` is the causal
attention kernel's wrapper (`kernels.flash_attention`).  Backend choice
for the GF products is the engine registry's
(`repro_torch.engine.registry`): `gf_matmul` resolves a registry name,
and `gf2_combine` is the GF(2) byte-stream combine with its own two
names:

* ``auto``  — the hand-written CUDA kernel `gf2_xor.gf2_matmul` (its
  wrapper runs the plain version on CPU tensors);
* ``table`` — the plain version `ref.gf2_matmul_ref`.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention
from .gf2_xor import gf2_matmul

__all__ = ["flash_attention", "gf2_combine", "gf_matmul"]


def gf_matmul(A, P, *, s: int = 8, impl: str = "auto") -> torch.Tensor:
    """C = A·P over GF(2^s) through the registry kernel named `impl`
    (a seeded name takes the (n,) seed vector as `A`)."""
    # call-time import: repro_torch.engine imports repro_torch.kernels
    from repro_torch.engine.registry import resolve_kernel
    return resolve_kernel(impl)[1](A, P, s=s)


def gf2_combine(A, P, *, impl: str = "auto") -> torch.Tensor:
    """GF(2) combine of raw bytes: C[i] = XOR_{k : A[i,k] & 1} P[k]."""
    if impl == "auto":
        return gf2_matmul(A, P)
    if impl == "table":
        return ref.gf2_matmul_ref(A, P)
    raise ValueError(f"unknown impl {impl!r} (auto or table)")
