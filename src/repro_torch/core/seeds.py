"""Seed-derived RLNC coding vectors: counter-based PRNG + row expansion.

The port of `repro.core.seeds`.  A coding row travels as a 4-byte seed
instead of K symbols; coefficient j of the row is a pure function of
``(seed, j)`` through Threefry-2x32-20, so every party — this module,
the seeded CUDA kernel (`repro_torch.kernels.csrc`) and the JAX
reference — regenerates the byte-identical row.

Layout: coefficient j comes from byte ``j % 4`` of the Threefry output
word with counter ``j // 4`` (key = ``(seed, KEY_SALT)``), masked to s
bits.

Dtype: torch has no uint32 ``+``, ``<<`` or ``>>`` on the CPU, so seeds
and Threefry words are int64 tensors holding values in [0, 2^32), and
every add and shift is masked back to 32 bits.  A seed vector is a
1-D int64 tensor — the engine tells it from a coding matrix (2-D uint8)
by its rank alone.
"""
from __future__ import annotations

import numpy as np
import torch

COEFFS_PER_WORD = 4          # one coefficient byte per Threefry-word byte

# Domain-separation constant ("FdNC"): the second Threefry key word.
# Fixed forever — changing it silently changes every derived row.
KEY_SALT = 0x46644E43

_MASK32 = 0xFFFFFFFF
_THREEFRY_C240 = 0x1BD11BDA
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_ROUNDS = 20


def as_seeds(seeds, device=None) -> torch.Tensor:
    """Seeds (tensor, numpy uint32 array or ints) as the port's int64
    seed tensor, values reduced to 32 bits."""
    if not isinstance(seeds, torch.Tensor):
        seeds = torch.from_numpy(np.array(seeds, np.int64))
    return seeds.to(device=device, dtype=torch.int64) & _MASK32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate-left on 32-bit values held in int64 (0 < r < 32)."""
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32-20 block cipher: key (k0, k1), counter (x0, x1).

    Inputs broadcast; each is an int or an int64 tensor of 32-bit
    values.  Returns the two output words as int64 tensors.  Matches
    the Random123 reference and `repro.core.seeds.threefry2x32` bit for
    bit.
    """
    k0, k1, x0, x1 = (torch.as_tensor(v, dtype=torch.int64) & _MASK32
                      for v in (k0, k1, x0, x1))
    ks = (k0, k1, _THREEFRY_C240 ^ k0 ^ k1)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for d in range(_ROUNDS):
        x0 = (x0 + x1) & _MASK32
        x1 = _rotl32(x1, _ROTATIONS[d % 8]) ^ x0
        if d % 4 == 3:
            j = d // 4 + 1                             # key-injection index
            x0 = (x0 + ks[j % 3]) & _MASK32
            x1 = (x1 + ks[(j + 1) % 3] + j) & _MASK32
    return x0, x1


def coeff_words(seeds, n_words: int) -> torch.Tensor:
    """(N,) seeds -> (N, n_words) int64 coefficient words.

    Word w of row i is ``threefry2x32(seed_i, KEY_SALT; w, 0)[0]`` — a
    counter-based stream, so any sub-range of words is computable
    without its predecessors.
    """
    seeds = as_seeds(seeds)
    ctr = torch.arange(n_words, dtype=torch.int64, device=seeds.device)
    w0, _ = threefry2x32(seeds[:, None], KEY_SALT, ctr[None, :], 0)
    return w0


def expand_rows(seeds, K: int, s: int = 8) -> torch.Tensor:
    """Regenerate the (N, K) uint8 coding matrix from (N,) seeds.

    Coefficient j = byte ``j % 4`` of word ``j // 4``, masked to s
    bits — the definition of a seed-addressed row that every seeded
    kernel and the wire format agree with byte for byte.
    """
    seeds = as_seeds(seeds)
    if seeds.dim() != 1:
        raise ValueError(f"seeds must be (N,), got {tuple(seeds.shape)}")
    n_words = -(-K // COEFFS_PER_WORD)
    W = coeff_words(seeds, n_words)                     # (N, n_words)
    shifts = torch.arange(COEFFS_PER_WORD, dtype=torch.int64,
                          device=seeds.device) * 8
    b = (W[:, :, None] >> shifts) & 0xFF
    flat = b.reshape(seeds.shape[0], n_words * COEFFS_PER_WORD)
    return (flat[:, :K] & ((1 << s) - 1)).to(torch.uint8)


def draw_seeds(generator: torch.Generator, n: int) -> torch.Tensor:
    """Draw n uniform 32-bit row seeds (int64) from a torch generator,
    on the generator's device.  The seeded analogue of
    ``rlnc.random_coding_matrix``."""
    return torch.randint(0, 1 << 32, (n,), generator=generator,
                         device=generator.device, dtype=torch.int64)
