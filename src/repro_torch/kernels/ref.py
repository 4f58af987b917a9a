"""Plain PyTorch versions of the GF coding kernels.

`gf_matmul_ref` (log/exp tables) is the correctness oracle: an
independent formulation from the kernels' xtime ladder, so agreement is
meaningful.  `gf_matmul_packed_ref` and `gf_matmul_packed_seeded_ref`
repeat the CUDA kernels' arithmetic step for step in tensor ops — four
symbols per int32 word, the Russian-peasant ladder
``acc ^= (P_k·x^i) & bit_i(A[:, k])`` — and are what the kernel
wrappers run for CPU tensors and what `chip_smoke.py` holds the kernels
against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.gf import get_field


def gf_matmul_ref(A: torch.Tensor, P: torch.Tensor, s: int) -> torch.Tensor:
    """C = A·P over GF(2^s). A: (n, K) uint8, P: (K, L) uint8."""
    return get_field(s, P.device).matmul(A, P)


def _ladder(coeff_of, W: torch.Tensor, n: int, K: int, s: int
            ) -> torch.Tensor:
    """acc (n, Lw) int32 = XOR_k XOR_i (W_k·x^i) & bit_i(coeff_of(k))."""
    from .gf_matmul import _xtime_packed  # late: ref must stay import-light

    acc = torch.zeros((n, W.shape[1]), dtype=torch.int32, device=W.device)
    for k in range(K):
        w = W[k][None, :]
        coeff = coeff_of(k)                            # (n, 1) int32
        for i in range(s):
            acc = acc ^ (w * ((coeff >> i) & 1))
            if i + 1 < s:
                w = _xtime_packed(w, s)
    return acc


def gf_matmul_packed_ref(A: torch.Tensor, P: torch.Tensor, s: int
                         ) -> torch.Tensor:
    """Lane-packed ladder: the `gf_matmul_packed` kernel's arithmetic."""
    from .gf_matmul import pack_lanes, unpack_lanes

    n, K = A.shape
    L = P.shape[1]
    if L == 0:
        return torch.zeros((n, 0), dtype=torch.uint8, device=P.device)
    A32 = A.to(device=P.device, dtype=torch.int32)
    acc = _ladder(lambda k: A32[:, k][:, None], pack_lanes(P), n, K, s)
    return unpack_lanes(acc, L)


# ---------------------------------------------------------------------------
# seeded variants: coefficient rows regenerated from 4-byte seeds
# ---------------------------------------------------------------------------

def gf_matmul_seeded_ref(seeds: torch.Tensor, P: torch.Tensor, s: int
                         ) -> torch.Tensor:
    """Seeded table oracle: expand the rows, then the log/exp matmul."""
    from repro_torch.core.seeds import expand_rows

    A = expand_rows(seeds.to(P.device), int(P.shape[0]), s)
    return gf_matmul_ref(A, P, s)


def gf_matmul_packed_seeded_ref(seeds: torch.Tensor, P: torch.Tensor,
                                s: int) -> torch.Tensor:
    """Seeded lane-packed ladder: the `gf_matmul_packed_seeded`
    kernel's arithmetic — coefficient k of row i is byte k%4 of Threefry
    word k//4 of seed i, masked to s bits."""
    from repro_torch.core.seeds import COEFFS_PER_WORD, coeff_words

    from .gf_matmul import pack_lanes, unpack_lanes

    K, L = P.shape
    n = seeds.shape[0]
    if L == 0:
        return torch.zeros((n, 0), dtype=torch.uint8, device=P.device)
    words = coeff_words(seeds.to(P.device), -(-K // COEFFS_PER_WORD))
    mask = (1 << s) - 1

    def coeff_of(k: int) -> torch.Tensor:
        byte = words[:, k // COEFFS_PER_WORD] >> (8 * (k % COEFFS_PER_WORD))
        return (byte & mask).to(torch.int32)[:, None]

    return unpack_lanes(_ladder(coeff_of, pack_lanes(P), n, K, s), L)
