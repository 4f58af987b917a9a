"""GF(2) coded combine (the s = 1 fast path): CUDA kernel and wrapper.

For s = 1 the coding coefficients are bits and the field product
degenerates to a masked XOR: C[i] = XOR_{k : A[i,k] & 1} P[k].  The
combination acts on whole bytes (bit-planes mix independently), so the
kernel streams the raw uint8 packet matrix: no symbol splitting, no
multiplies.  One hand-written Hopper kernel lives in `csrc/gf2_xor.cu`:

* `gf2_matmul(A, P)` — replaces the TPU kernel
  `repro.kernels.gf2_xor.gf2_matmul_pallas`.

As in `gf_matmul`, the wrapper decides by the tensor's device alone: a
CPU tensor runs the plain version (`ref.gf2_matmul_ref`), a CUDA tensor
launches the kernel or raises.  ``out=`` takes an (n, L) column view of
a wider output; the wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import ref
from .gf_matmul import (check_out, check_packets, check_rows, declare,
                        launch, plain)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with every C function's types declared."""
    from . import build

    return declare(build.load("gf2_xor"), ("gf2_matmul",))


def gf2_matmul(A: torch.Tensor, P: torch.Tensor, *, s: int = 1,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """C = A·P over GF(2) on raw bytes: A (n, K) uint8 (bit 0 read),
    P (K, L) uint8 -> (n, L).

    `s` is taken for the registry's kernel signature and must be 1.
    CUDA tensors launch the hand-written kernel; CPU tensors run
    `ref.gf2_matmul_ref`.
    """
    if s != 1:
        raise ValueError(f"gf2_matmul computes over GF(2), got s={s}")
    check_packets(P)
    check_rows(A, P)
    check_out(out, A.shape[0], P)
    if P.device.type == "cpu":
        return plain(ref.gf2_matmul_ref(A, P), out)
    return launch(_lib(), gf2_matmul, A.contiguous(), P, A.shape[0], 1, out)


gf2_matmul.launches = 0

#: every hand-written kernel wrapper of this module
WRAPPERS = (gf2_matmul,)
