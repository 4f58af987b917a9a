"""GF(2^s) coded matmul C = A·P: CUDA kernels and wrappers.

FedNC's compute hot spot: every round the (K, L) packet matrix P
(L = model bytes) is mixed by the (n, K) coding matrix, and decode
applies A^-1 the same way.  Three hand-written Hopper kernels live in
`csrc/gf_matmul.cu`:

* `gf_matmul_packed(A, P, s=)` — replaces the TPU kernel
  `repro.kernels.gf_matmul.gf_matmul_pallas_packed`;
* `gf_matmul_packed_seeded(seeds, P, s=)` — replaces
  `gf_matmul_pallas_packed_seeded`: row i's coefficients are
  regenerated inside the kernel from seed i with Threefry-2x32-20;
* `gf_matmul_unpacked(A, P, s=)` — replaces `gf_matmul_pallas`: the
  carry-less multiply and polynomial reduction of one symbol per lane.

The first two compute on four symbols per 32-bit word with the
byte-masked xtime ladder below.  A wrapper decides by the tensor's
device alone: a
CPU tensor runs the plain PyTorch version (`kernels.ref`), a CUDA
tensor launches the kernel — and raises if the launch fails; there is
no fallback.  With ``out=`` a wrapper writes C into the given (n, L)
tensor, which may be a column view of a wider one (the engine's chunked
output), instead of allocating.  Each wrapper counts its launches in
``.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.gf import PRIMITIVE_POLY

from . import ref

_ONE_MASK = 0x01010101   # bit 0 of every byte lane
LANES_PER_WORD = 4


# ---------------------------------------------------------------------------
# int32 lane packing: 4 uint8 symbols per word (little-endian bitcast)
# ---------------------------------------------------------------------------

def _xtime_packed(w: torch.Tensor, s: int) -> torch.Tensor:
    """Multiply each packed s-bit symbol by x, byte-parallel.

    Drop each symbol's top bit and shift left one; XOR the reduced
    polynomial into bytes whose top bit was set.  ``w >> (s-1)`` is an
    arithmetic shift on int32; the ``& 0x01010101`` mask is what keeps
    its sign smear out of the other lanes.
    """
    poly_red = PRIMITIVE_POLY[s] ^ (1 << s)           # poly minus x^s
    low_mask = ((1 << (s - 1)) - 1) * _ONE_MASK
    hi = (w >> (s - 1)) & _ONE_MASK
    return ((w & low_mask) << 1) ^ (hi * poly_red)


def pack_lanes(P: torch.Tensor) -> torch.Tensor:
    """(…, L) uint8 symbols -> (…, ceil(L/4)) int32 packed words."""
    L = P.shape[-1]
    pad = (-L) % LANES_PER_WORD
    if pad:
        P = torch.cat([P, P.new_zeros(*P.shape[:-1], pad)], dim=-1)
    return P.contiguous().view(torch.int32)


def unpack_lanes(W: torch.Tensor, L: int) -> torch.Tensor:
    """Inverse of :func:`pack_lanes`: (…, Lw) int32 -> (…, L) uint8."""
    return W.contiguous().view(torch.uint8)[..., :L]


# ---------------------------------------------------------------------------
# the CUDA library and its C interface
# ---------------------------------------------------------------------------

_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
              ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with every C function's types declared."""
    from . import build

    return declare(build.load("gf_matmul"), (
        "gf_matmul_packed", "gf_matmul_packed_seeded", "gf_matmul_unpacked"))


def declare(lib: ctypes.CDLL, kernels: tuple[str, ...]) -> ctypes.CDLL:
    """Declare the types of `kernels` (each with `_SIGNATURE`) and of
    the helper every GF library exports (`gf_error_string`)."""
    for name in kernels:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    lib.gf_error_string.argtypes = [ctypes.c_int]
    lib.gf_error_string.restype = ctypes.c_char_p
    return lib


def check_field(s: int) -> None:
    if s not in PRIMITIVE_POLY:
        raise ValueError(f"unsupported field size s={s} (need 1..8)")


def check_packets(P: torch.Tensor) -> None:
    """P must be a (K, L) uint8 tensor on the CPU or a CUDA device."""
    if P.dim() != 2 or P.dtype != torch.uint8:
        raise TypeError(f"P must be a 2-D uint8 tensor, got "
                        f"{P.dtype} {tuple(P.shape)}")
    if P.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {P.device}")


def check_rows(A: torch.Tensor, P: torch.Tensor) -> None:
    if A.dim() != 2 or A.dtype != torch.uint8 or A.shape[1] != P.shape[0]:
        raise ValueError(f"A must be (n, {P.shape[0]}) uint8, got "
                         f"{A.dtype} {tuple(A.shape)}")
    if A.device != P.device:
        raise ValueError(f"A on {A.device} but P on {P.device}")


def check_out(out, n: int, P: torch.Tensor) -> None:
    if out is None:
        return
    L = P.shape[1]
    if out.shape != (n, L) or out.dtype != torch.uint8:
        raise ValueError(f"out must be ({n}, {L}) uint8, got "
                         f"{out.dtype} {tuple(out.shape)}")
    if out.device != P.device:
        raise ValueError(f"out on {out.device} but P on {P.device}")
    if out.numel() and out.stride(1) != 1:
        raise ValueError("out needs unit column stride")


def plain(C: torch.Tensor, out) -> torch.Tensor:
    """The plain version's C, written into `out` when one is given."""
    return C if out is None else out.copy_(C)


def launch(lib: ctypes.CDLL, wrapper, rows: torch.Tensor, P: torch.Tensor,
           n: int, s: int, out) -> torch.Tensor:
    """Launch `wrapper`'s kernel (the C function of `lib` named like
    it) on P's device and current stream into `out` (allocated when
    None), count the launch on the wrapper, and return C (n, L)."""
    K, L = P.shape
    if out is None:
        out = torch.empty((n, L), dtype=torch.uint8, device=P.device)
    if L == 0 or n == 0:
        return out
    if P.stride(1) != 1:          # rows may be strided; columns may not
        P = P.contiguous()
    stream = torch.cuda.current_stream(P.device).cuda_stream
    fn_name = wrapper.__name__
    err = getattr(lib, fn_name)(rows.data_ptr(), P.data_ptr(), P.stride(0),
                                out.data_ptr(), out.stride(0), n, K, L, s,
                                P.device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err} "
                           f"({lib.gf_error_string(err).decode()})")
    wrapper.launches += 1
    return out


def gf_matmul_packed(A: torch.Tensor, P: torch.Tensor, *, s: int = 8,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """C = A·P over GF(2^s): A (n, K) uint8, P (K, L) uint8 -> (n, L).

    CUDA tensors launch the hand-written kernel; CPU tensors run
    `ref.gf_matmul_packed_ref`.
    """
    check_field(s)
    check_packets(P)
    check_rows(A, P)
    check_out(out, A.shape[0], P)
    if P.device.type == "cpu":
        return plain(ref.gf_matmul_packed_ref(A, P, s), out)
    return launch(_lib(), gf_matmul_packed, A.contiguous(), P, A.shape[0],
                  s, out)


def gf_matmul_packed_seeded(seeds: torch.Tensor, P: torch.Tensor, *,
                            s: int = 8, out: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """C = rows(seeds)·P over GF(2^s) without materializing the rows.

    `seeds`: (n,) int64 whose low 32 bits are the row seeds; P (K, L)
    uint8 -> (n, L).  Bit-identical to
    ``gf_matmul_packed(expand_rows(seeds, K, s), P, s=s)``.
    """
    check_field(s)
    check_packets(P)
    if seeds.dim() != 1 or seeds.dtype != torch.int64:
        raise ValueError(f"seeds must be (n,) int64, got "
                         f"{seeds.dtype} {tuple(seeds.shape)}")
    if seeds.device != P.device:
        raise ValueError(f"seeds on {seeds.device} but P on {P.device}")
    check_out(out, seeds.shape[0], P)
    if P.device.type == "cpu":
        return plain(ref.gf_matmul_packed_seeded_ref(seeds, P, s), out)
    return launch(_lib(), gf_matmul_packed_seeded, seeds.contiguous(), P,
                  seeds.shape[0], s, out)


def gf_matmul_unpacked(A: torch.Tensor, P: torch.Tensor, *, s: int = 8,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """C = A·P over GF(2^s) by carry-less multiply and reduction, one
    symbol per lane: A (n, K) uint8, P (K, L) uint8 -> (n, L).

    Equal to :func:`gf_matmul_packed` wherever A and P hold s-bit
    symbols; on bytes >= 2^s it computes what the reference's
    `gf_matmul_pallas` computes (A's byte whole, P's low s bits).  CUDA
    tensors launch the hand-written kernel; CPU tensors run
    `ref.gf_matmul_clmul_ref`.
    """
    check_field(s)
    check_packets(P)
    check_rows(A, P)
    check_out(out, A.shape[0], P)
    if P.device.type == "cpu":
        return plain(ref.gf_matmul_clmul_ref(A, P, s), out)
    return launch(_lib(), gf_matmul_unpacked, A.contiguous(), P,
                  A.shape[0], s, out)


gf_matmul_packed.launches = 0
gf_matmul_packed_seeded.launches = 0
gf_matmul_unpacked.launches = 0

#: every hand-written kernel wrapper of this module
WRAPPERS = (gf_matmul_packed, gf_matmul_packed_seeded, gf_matmul_unpacked)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
