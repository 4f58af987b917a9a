"""Plain PyTorch versions of the GF coding kernels.

`gf_matmul_ref` (log/exp tables) is the correctness oracle: an
independent formulation from the kernels' xtime ladder and carry-less
multiply, so agreement is meaningful.  The others repeat a CUDA
kernel's function in tensor ops, and are what the kernel wrappers run
for CPU tensors and what `chip_smoke.py` holds the kernels against on
the card:

* `gf_matmul_packed_ref`, `gf_matmul_packed_seeded_ref` — four symbols
  per int32 word, the Russian-peasant ladder
  ``acc ^= (P_k·x^i) & bit_i(A[:, k])``; `gf_matmul_packed_batched_ref`,
  the first on each of J problems (`gf_matmul_packed_batched`);
* `gf_matmul_clmul_ref` — one symbol per int32 lane, carry-less
  multiply then reduction by the primitive polynomial
  (`gf_matmul_unpacked`);
* `gf2_matmul_ref` — the GF(2) masked XOR on raw bytes (`gf2_matmul`);
* `flash_attention_ref` — causal online-softmax attention over key
  tiles (`flash_attention`), held against the reference's `_attend`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.gf import PRIMITIVE_POLY, get_field


def gf_matmul_ref(A: torch.Tensor, P: torch.Tensor, s: int) -> torch.Tensor:
    """C = A·P over GF(2^s). A: (n, K) uint8, P: (K, L) uint8."""
    return get_field(s, P.device).matmul(A, P)


def _gf_mul_vec(a: torch.Tensor, b: torch.Tensor, s: int) -> torch.Tensor:
    """GF(2^s) product of broadcasting int32 tensors, as the reference's
    `_gf_mul_vec` computes it: the carry-less multiply
    ``XOR_{i < s} (a << i)·bit_i(b)``, then reduction of bits 2s-2..s by
    `PRIMITIVE_POLY[s]`.  Inputs are not masked: bits of `a` at or
    above s shift along, bits of `b` at or above s are never read."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape),
                      dtype=torch.int32, device=a.device)
    for i in range(s):
        acc = acc ^ ((a << i) * ((b >> i) & 1))
    poly = PRIMITIVE_POLY[s]
    for i in range(2 * s - 2, s - 1, -1):
        acc = acc ^ ((poly << (i - s)) * ((acc >> i) & 1))
    return acc


def gf_matmul_clmul_ref(A: torch.Tensor, P: torch.Tensor, s: int
                        ) -> torch.Tensor:
    """Unpacked carry-less-multiply formulation: one symbol per int32
    lane, looped over k (memory O(n·L)).  The `gf_matmul_unpacked`
    kernel's function; bit for bit the reference's
    `gf_matmul_clmul_ref`, bytes >= 2^s included (the result keeps the
    low 8 bits of each lane)."""
    n, K = A.shape
    A32 = A.to(device=P.device, dtype=torch.int32)
    P32 = P.to(torch.int32)
    acc = torch.zeros((n, P.shape[1]), dtype=torch.int32, device=P.device)
    for k in range(K):
        acc = acc ^ _gf_mul_vec(A32[:, k][:, None], P32[k][None, :], s)
    return (acc & 0xFF).to(torch.uint8)


def gf2_matmul_ref(A: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """GF(2) fast path on raw bytes: C[i] = XOR over {k : A[i,k] & 1}
    of P[k].  Only bit 0 of A is read; P's bytes combine whole (for s=1
    every bit-plane mixes with the same coefficients).  The
    `gf2_matmul` kernel's function, looped over k."""
    n, K = A.shape
    bit = (A.to(P.device) & 1)
    acc = torch.zeros((n, P.shape[1]), dtype=torch.uint8, device=P.device)
    for k in range(K):
        acc ^= P[k][None, :] * bit[:, k][:, None]
    return acc


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


def gf_matmul_packed_batched_ref(A: torch.Tensor, P: torch.Tensor, s: int
                                ) -> torch.Tensor:
    """The batched instance's function: `gf_matmul_packed_ref` on each
    problem, A (J, n, K), P (J, K, L) -> (J, n, L)."""
    J, n, _ = A.shape
    if J == 0:
        return torch.zeros((0, n, P.shape[2]), dtype=torch.uint8,
                           device=P.device)
    return torch.stack([gf_matmul_packed_ref(A[j], P[j], s)
                        for j in range(J)])


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


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

#: (query rows, keys) per tile of the flash kernel, by input dtype, as
#: in csrc/flash_attention.cu: the float32 CUDA-core kernel's kBlockQ x
#: kBlockK and the bf16 tensor-core kernel's hopper::kBlockQ x kBlockK
FLASH_TILES = {torch.float32: (64, 32), torch.bfloat16: (128, 128)}
FLASH_MASK = -1e30      # masked score, as the reference kernel's NEG_INF
LOG2E = 1.4426950408889634


def _tensor_core_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16-valued float32 tiles (..., m, k) x (..., k, n) with
    float32 sums.  On the card through torch's bf16 GEMM with float32
    output: bf16 products summed by the tensor cores, as the kernel's
    wgmma sums them (a float32 GEMM sums in another order, and that last
    bit decides on which side of a bf16 rounding boundary P falls).  On
    the CPU, which has no such GEMM, in float32."""
    if not a.is_cuda:
        return a @ b
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    out = torch.bmm(a3.to(torch.bfloat16), b3.to(torch.bfloat16),
                    out_dtype=torch.float32)
    return out.reshape(*lead, *out.shape[-2:])


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """The `flash_attention` kernel's algorithm in tensor ops.

    q (B, S, H, hd), k and v (B, S, KV, hd) with H a multiple of KV ->
    (B, S, H, hd) in q's dtype.  Per tile of query rows it walks the key
    tiles (FLASH_TILES[q.dtype]) up to the one that holds the tile's
    last row (all of them when not `causal`), carrying the running max,
    normalizer and accumulator in float32; masked scores are -1e30.  As
    each kernel does: in float32 q is scaled by 1/sqrt(hd) first, both
    products are float32 and the output is acc / max(l, 1e-20).  In bf16
    (the tensor-core kernel) the softmax is base 2: the running max is
    of the scores times c = log2(e)/sqrt(hd) (c rounded as the kernel
    rounds it), P = 2^(s·c − m) with one rounding (the kernel's FMA: s·c
    is exact in float64), P is rounded to bf16 before P·V (l sums the
    unrounded P), both products are `_tensor_core_product`, and the
    output is acc · (1 / max(l, 1e-20)).  K and V are expanded to H
    heads here (query head h reads KV head h // (H // KV)); the kernels
    index instead.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    block_q, block_k = FLASH_TILES[q.dtype]
    tensor_cores = q.dtype == torch.bfloat16
    fold = lambda x: x.float().permute(0, 2, 1, 3)           # (B, H, S, hd)
    expand = lambda x: x[:, :, :, None].expand(
        B, S, KV, H // KV, hd).reshape(B, S, H, hd)
    if tensor_cores:
        qf = fold(q)
        # float32(1/sqrt(hd)) x float32(log2 e), rounded to float32
        c = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32))
        product = _tensor_core_product
    else:
        qf = fold(q) * (1.0 / math.sqrt(hd))
        product = torch.matmul
    kf = fold(expand(k))
    vf = fold(expand(v))
    out = torch.empty((B, H, S, hd), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, block_q):
        qt = qf[:, :, q0:q0 + block_q]
        nq = qt.shape[2]
        qpos = torch.arange(q0, q0 + nq, device=q.device)[:, None]
        acc = torch.zeros((B, H, nq, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, H, nq), FLASH_MASK, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, nq), dtype=torch.float32, device=q.device)
        last = min(q0 + block_q, S) if causal else S
        for k0 in range(0, last, block_k):
            kt = kf[:, :, k0:k0 + block_k]
            vt = vf[:, :, k0:k0 + block_k]
            s = product(qt, kt.transpose(-1, -2))              # (B,H,nq,bk)
            if causal:
                kpos = torch.arange(k0, k0 + kt.shape[2], device=q.device)
                s = torch.where(kpos[None, :] <= qpos, s, FLASH_MASK)
            if tensor_cores:
                m_new = torch.maximum(m, s.amax(dim=-1) * c)
                p = torch.exp2((s.double() * c
                                - m_new.double()[..., None]).float())
                corr = torch.exp2(m - m_new)
            else:
                m_new = torch.maximum(m, s.amax(dim=-1))
                p = torch.exp(s - m_new[..., None])
                corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            if tensor_cores:
                p = p.to(torch.bfloat16).float()
            acc = acc * corr[..., None] + product(p, vt)
            m = m_new
        l = torch.clamp_min(l, 1e-20)[..., None]
        out[:, :, q0:q0 + nq] = (acc * torch.reciprocal(l) if tensor_cores
                                 else acc / l)
    return out.permute(0, 2, 1, 3).contiguous().to(q.dtype)
