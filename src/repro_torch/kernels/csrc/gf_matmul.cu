// Hand-written Hopper (sm_90a) kernels for C = A·P over GF(2^s), s = 1..8.
//
// gf_matmul_packed_kernel<S, false, ...>
//   Replaces the TPU kernel src/repro/kernels/gf_matmul.py
//   gf_matmul_pallas_packed (_packed_kernel, _xtime_packed).
// gf_matmul_packed_batched_kernel<S, ...>
//   The same product for J independent problems in one launch,
//   C[j] = A[j]·P[j] (grid.z = j, batch strides), the port's instance of
//   the reference's jax.vmap over the decoder bank's slots
//   (src/repro/engine/stream.py _bank_fns).  It runs packed_product, the
//   body of gf_matmul_packed_kernel, on problem j's pointers.
// gf_matmul_packed_kernel<S, true, ...>
//   Replaces src/repro/kernels/gf_matmul.py gf_matmul_pallas_packed_seeded
//   (_packed_seeded_kernel, with repro.core.seeds threefry2x32/coeff_words).
// gf_matmul_unpacked_kernel<S, ...>
//   Replaces src/repro/kernels/gf_matmul.py gf_matmul_pallas (_kernel,
//   _gf_mul_vec): the carry-less-multiply formulation, below.
//
// Arithmetic of the packed kernels.  Four s-bit symbols ride in one
// 32-bit word, one per byte (byte b of word j is symbol 4j+b, the
// little-endian bitcast the JAX kernels use).  For each packet row k the
// thread builds the ladder P_k·x^i, i < s, with a byte-masked xtime that
// never carries across byte lanes, and XORs rung i into output row r
// wherever bit i of A[r, k] is set.  No tables, no gathers: pure 32-bit
// logic and shifts.
//
// Arithmetic of the unpacked kernel.  The reference computes, per k and
// per symbol, clmul(A[i,k], P[k,j]) = XOR_{i<s} (A[i,k] << i)·bit_i(P)
// in a 32-bit lane, reduces bits 2s-2..s by PRIMITIVE_POLY[s], XORs the
// products and keeps the low byte; A's byte is not masked, P's bits at
// or above s are never read.  Here each packed word of P is spread over
// two registers of two 16-bit lanes each (symbols 0, 2 and 1, 3), masked
// to s bits, and the clmul is computed the other way round, which
// carry-less multiplication allows: XOR over the 8 bits j of A[i,k] of
// P << j.  The rungs P << j (j < 8) are shared by all output rows; a
// product has at most 15 bits, so no lane spills into the next.
// Reduction by the polynomial is linear over GF(2), so the lanes
// accumulate the unreduced products over k and reduce once per output,
// bit for bit the reference's reduce-then-XOR.
//
// What bounds them.  Per 4-byte word of a row the packed kernels need
// K·(s-1) xtimes (4 int32 operations each) and n·K·s selects, but move
// only (K + n)·4 bytes: at the main path's shapes (n = K = 8, s = 8) 736
// operations for 64 bytes, 11.5 per byte, while an H100 SXM balances at
// 5 (16.7 T int32 op/s over 3.35 TB/s).  The unpacked kernel needs
// 2·n·K·8 selects and K·17 rung operations per word, plus a reduction
// per output.  Both are bound by the int32 pipes, not by HBM; at the
// chunk shape (L = 2^18) a launch also pays a fixed ~3 µs to start its
// one wave of blocks and write C (measured at K = 0).  So the design
// spends the int32 issue slots on the selects and on little else:
//
// * A select is one LOP3, acc ^= rung & mask (LUT 0x78).  The mask (0 or
//   ~0) is the same in every thread of a launch, so it is not rebuilt
//   per thread: each block expands its rows' coefficients once into
//   shared memory as 32-bit masks, [k][row][bit], 8 words per (k, row),
//   and the step reads a row's masks with two broadcast LDS.128.  The
//   seeded kernel generates the coefficients there with Threefry-2x32-20
//   first.  Masks of kKTile packet rows are held at a time (8 KB for 8
//   rows), so K has no shared-memory limit.
// * A thread owns kWords = 2 consecutive words of a row, 8 bytes: each
//   mask it reads serves both, a row that is 8- or 16-byte aligned takes
//   one 8-byte load per packet row (4- and 1-byte aligned rows narrower
//   loads of the same words), and a chunk of 2^18 columns still gives
//   8 warps per SM.  4 words per thread (16-byte loads) halve the warps
//   and were slower; 1 word doubles the mask loads and was not faster.
// * A block owns R = kTileRows = 8 output rows, the main path's n;
//   n > 8 takes balanced tiles over blockIdx.y.  A full tile runs its
//   rows with no branch, so the compiler interleaves the rows' select
//   chains and hoists their mask loads; the packed kernels go further
//   and run a separate instance of the loop for full tiles, in which the
//   ladder and the selects of a step share one basic block.  (The
//   unpacked step, with 16 rungs per word, was slower that way and
//   tests the tile per step.)  Partial tiles test each row.
// * The loop over packet rows stays rolled, so the body the warps share
//   is one unrolled step and fits the instruction cache; a ring of
//   kGroup registers keeps the loads of the next kGroup - 1 packet rows
//   in flight under the arithmetic.
// * The unpacked reduction folds: w = lo + x^s·h ≡ lo + h·(poly - x^s),
//   a carry-less product by a constant (a few shifted XORs), repeated
//   while bits at or above s remain; bits >= 2s-1, which only A's bytes
//   >= 2^s set and the reference never reduces, are kept as they are.
//
// Per word and packet row the packed step thus issues, besides its
// share of the load, the xtimes (SHF, LOP3, IMAD, LOP3 and an IMAD
// shift: IMADs on the FMA pipe) and per output row s LOP3 and 2 LDS.128
// shared by the thread's 2 words; the unpacked step 3 + 14 rung
// operations and per output row 16 LOP3 and the 2 LDS.128.
//
// Contract (checked by the Python wrappers): A (n, K) uint8 contiguous
// (batched: (J, n, K), problem j at A + j·a_batch);
// seeds (n,) int64 whose low 32 bits are the seeds; P (K, L) uint8 with
// unit column stride and row stride ldp (a column slice of a wider
// matrix is fine); C (n, L) uint8 with unit column stride and row stride
// ldc (the chunk's columns of the engine's output); batched: problem j's
// P and C at P + j·p_batch and C + j·c_batch, J <= 65,535.  Ragged L is masked
// here, word by word and byte by byte, not padded by the caller; n != K
// is fine; L = 0 returns at once.  The blocks share nothing, so they run
// in any order.
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "gf_common.cuh"

namespace {

constexpr int kThreads = 256;     // threads per block
constexpr int kKTile = 32;        // packet rows whose masks a block holds
constexpr int kGroup = 4;         // packet rows whose loads fly together
constexpr int kMaskSlots = 8;     // mask words per (packet row, output row)
constexpr int kWords = 2;         // packed words per thread (8 bytes)
constexpr int kTileRows = 8;      // output rows per block, R
constexpr uint32_t kOne = 0x01010101u;   // bit 0 of every byte lane
constexpr uint32_t kLane16 = 0x00010001u;  // bit 0 of both 16-bit lanes
constexpr uint32_t kKeySalt = 0x46644E43u;  // "FdNC", repro.core.seeds

static_assert(kKTile % 4 == 0, "a Threefry word never straddles a tile");

__host__ __device__ constexpr uint32_t primitive_poly(int s) {
  return s == 1 ? 0x3u : s == 2 ? 0x7u : s == 3 ? 0xBu : s == 4 ? 0x13u
       : s == 5 ? 0x25u : s == 6 ? 0x43u : s == 7 ? 0x83u : 0x11Du;
}

// V packed words (4V bytes) from byte b0 of a row of length L, b0 a
// multiple of 4V; bytes past L read as 0.  `align` is the row alignment
// (16, 8, 4 or 1): 8-byte loads where it is 8 or more.
template <int V>
__device__ __forceinline__ void load_words(const uint8_t* row, long long b0,
                                           long long L, int align,
                                           uint32_t (&w)[V]) {
  const uint8_t* p = row + b0;
  if (b0 + 4 * V <= L) {
    if constexpr (V % 2 == 0) {
      if (align >= 8) {
#pragma unroll
        for (int q = 0; q < V / 2; ++q) {
          const uint2 x = reinterpret_cast<const uint2*>(p)[q];
          w[2 * q] = x.x;
          w[2 * q + 1] = x.y;
        }
        return;
      }
    }
    if (align >= 4) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        w[v] = reinterpret_cast<const uint32_t*>(p)[v];
      }
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    w[v] = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b0 + 4 * v + b < L) {
        w[v] |= static_cast<uint32_t>(p[4 * v + b]) << (8 * b);
      }
    }
  }
}

// Store V packed words at byte b0 of a row of length L; bytes past L are
// not written.
template <int V>
__device__ __forceinline__ void store_words(uint8_t* row, long long b0,
                                            long long L, int align,
                                            const uint32_t (&w)[V]) {
  uint8_t* p = row + b0;
  if (b0 + 4 * V <= L) {
    if constexpr (V % 2 == 0) {
      if (align >= 8) {
#pragma unroll
        for (int q = 0; q < V / 2; ++q) {
          reinterpret_cast<uint2*>(p)[q] = make_uint2(w[2 * q], w[2 * q + 1]);
        }
        return;
      }
    }
    if (align >= 4) {
#pragma unroll
      for (int v = 0; v < V; ++v) reinterpret_cast<uint32_t*>(p)[v] = w[v];
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b0 + 4 * v + b < L) {
        p[4 * v + b] = static_cast<uint8_t>(w[v] >> (8 * b));
      }
    }
  }
}

// Multiply each of the four packed s-bit symbols by x, byte-parallel.
template <int S>
__device__ __forceinline__ uint32_t xtime(uint32_t w) {
  constexpr uint32_t low_mask = ((1u << (S - 1)) - 1u) * kOne;
  constexpr uint32_t poly_red = primitive_poly(S) ^ (1u << S);
  const uint32_t hi = (w >> (S - 1)) & kOne;
  return ((w & low_mask) << 1) ^ (hi * poly_red);
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32's rotation constants, R_{d mod 8}.
__host__ __device__ constexpr int rotation(int d) {
  return d == 0 ? 13 : d == 1 ? 15 : d == 2 ? 26 : d == 3 ? 6
       : d == 4 ? 17 : d == 5 ? 29 : d == 6 ? 16 : 24;
}

// Threefry-2x32-20, first output word (Random123; repro.core.seeds).
__device__ uint32_t threefry2x32_w0(uint32_t k0, uint32_t k1, uint32_t x0,
                                    uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, 0x1BD11BDAu ^ k0 ^ k1};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int d = 0; d < 20; ++d) {
    x0 += x1;
    x1 = rotl32(x1, rotation(d % 8));
    x1 ^= x0;
    if (d % 4 == 3) {
      const int j = d / 4 + 1;
      x0 += ks[j % 3];
      x1 += ks[(j + 1) % 3] + static_cast<uint32_t>(j);
    }
  }
  return x0;
}

// The 8 select masks of coefficient `a`: word i is ~0 where bit i is set.
__device__ __forceinline__ void put_masks(uint32_t* m, uint32_t a) {
  uint32_t x[kMaskSlots];
#pragma unroll
  for (int i = 0; i < kMaskSlots; ++i) x[i] = 0u - ((a >> i) & 1u);
  reinterpret_cast<uint4*>(m)[0] = make_uint4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<uint4*>(m)[1] = make_uint4(x[4], x[5], x[6], x[7]);
}

// Expand the coefficients of packet rows k0 .. k0+kt-1 of the block's
// `rows` output rows into masks[kk][r][i] (R rows per kk).  Materialized:
// A's bytes as they are.  Seeded: Threefry word w of row r's seed gives
// coefficients 4w..4w+3, masked to S bits.
template <int S, bool Seeded, int R>
__device__ __forceinline__ void build_masks(uint32_t* masks, const uint8_t* A,
                                            const long long* seeds, int row0,
                                            int rows, int K, int k0, int kt) {
  if constexpr (Seeded) {
    const int n_words = (kt + 3) / 4;
    for (int t = threadIdx.x; t < rows * n_words; t += blockDim.x) {
      const int r = t / n_words;
      const int wl = t - r * n_words;
      const uint32_t word = threefry2x32_w0(
          static_cast<uint32_t>(seeds[row0 + r]), kKeySalt,
          static_cast<uint32_t>(k0 / 4 + wl), 0u);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int kk = 4 * wl + b;
        if (kk < kt) {
          put_masks(masks + (kk * R + r) * kMaskSlots,
                    (word >> (8 * b)) & ((1u << S) - 1u));
        }
      }
    }
  } else {
    for (int t = threadIdx.x; t < rows * kt; t += blockDim.x) {
      const int r = t / kt;
      const int kk = t - r * kt;
      put_masks(masks + (kk * R + r) * kMaskSlots,
                A[static_cast<long long>(row0 + r) * K + k0 + kk]);
    }
  }
}

// The 8 masks of one (packet row, output row), two broadcast LDS.128.
__device__ __forceinline__ void get_masks(const uint32_t* m,
                                          uint32_t (&x)[kMaskSlots]) {
  const uint4 lo = reinterpret_cast<const uint4*>(m)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(m)[1];
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// Run `row(r)` for the block's output rows r < rows.  A full tile
// (rows == R, the main path's) runs them without a branch, so the rows'
// select chains interleave and their mask loads are hoisted; a partial
// tile tests each row.  Full: the caller knows the tile is full, and
// the step is then one basic block with the ladder too.
template <int R, bool Full, typename Row>
__device__ __forceinline__ void for_rows(int rows, Row&& row) {
  if (Full || rows == R) {
#pragma unroll
    for (int r = 0; r < R; ++r) row(r);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) row(r);
    }
  }
}

// One packet row of the packed product: the ladder of the thread's V
// words, then s selects per output row and word.
template <int S, int V, int R, bool Full>
__device__ __forceinline__ void ladder_step(const uint32_t (&p)[V],
                                            const uint32_t* m, int rows,
                                            uint32_t (&acc)[R][V]) {
  uint32_t rung[S][V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    rung[0][v] = p[v];
#pragma unroll
    for (int i = 1; i < S; ++i) rung[i][v] = xtime<S>(rung[i - 1][v]);
  }
  for_rows<R, Full>(rows, [&](int r) {
    uint32_t mask[kMaskSlots];
    get_masks(m + r * kMaskSlots, mask);
#pragma unroll
    for (int i = 0; i < S; ++i) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] ^= rung[i][v] & mask[i];
    }
  });
}

// One packet row of the unpacked product: the rungs P << j of both lane
// registers of each word, then 16 selects per output row and word.
template <int S, int V, int R, bool Full>
__device__ __forceinline__ void clmul_step(const uint32_t (&p)[V],
                                           const uint32_t* m, int rows,
                                           uint32_t (&acc02)[R][V],
                                           uint32_t (&acc13)[R][V]) {
  constexpr uint32_t sym_mask = ((1u << S) - 1u) * kLane16;
  uint32_t r02[8][V], r13[8][V];     // P << j for the 8 bits of A
#pragma unroll
  for (int v = 0; v < V; ++v) {
    r02[0][v] = p[v] & sym_mask;
    r13[0][v] = (p[v] >> 8) & sym_mask;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      r02[j][v] = r02[0][v] << j;
      r13[j][v] = r13[0][v] << j;
    }
  }
  for_rows<R, Full>(rows, [&](int r) {
    uint32_t mask[kMaskSlots];
    get_masks(m + r * kMaskSlots, mask);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc02[r][v] ^= r02[j][v] & mask[j];
        acc13[r][v] ^= r13[j][v] & mask[j];
      }
    }
  });
}

// Degree of primitive_poly(s) - x^s.
__host__ __device__ constexpr int red_degree(int s) {
  int d = 0;
  for (uint32_t r = primitive_poly(s) ^ (1u << s); r > 1u; r >>= 1) ++d;
  return d;
}

// Reduce the unreduced clmul sums of both 16-bit lanes by the primitive
// polynomial: bits 2S-2 down to S, as the reference's _gf_mul_vec does.
template <int S>
__device__ __forceinline__ uint32_t reduce_lanes16(uint32_t acc) {
  if constexpr (S == 1) {
    return acc;                       // bits 0..0: nothing to reduce
  } else {
    // The reference's loop over bits 2S-2 .. S never reads bits >= 2S-1
    // (only A's bytes >= 2^S set them) and takes the rest modulo the
    // polynomial, which folds compute with fewer operations:
    // w = lo + x^S·h ≡ lo + h·(poly - x^S), the product carry-less by a
    // constant (a few shifted XORs), repeated while bits at or above S
    // may remain.
    constexpr uint32_t red = primitive_poly(S) ^ (1u << S);
    constexpr int d = red_degree(S);
    constexpr uint32_t low = ((1u << S) - 1u) * kLane16;
    constexpr uint32_t keep = ((0xFFFFu << (2 * S - 1)) & 0xFFFFu) * kLane16;
    uint32_t w = acc & ~keep;
#pragma unroll
    for (int top = 2 * S - 2; top >= S; top += d - S) {  // highest bit of w
      const uint32_t h = (w >> S) & (((1u << (top - S + 1)) - 1u) * kLane16);
      uint32_t q = h;                 // red's bit 0 is set: poly is primitive
#pragma unroll
      for (int j = 1; j <= d; ++j) {
        if ((red >> j) & 1u) q ^= h << j;
      }
      w = (w & low) ^ q;
    }
    return w | (acc & keep);
  }
}

// The loop every kernel here shares: for each tile of kKTile packet rows,
// expand the masks, then stream the thread's words of P through `step`
// (a packet row's words, its masks) one packet row at a time, the loads
// of the next kGroup - 1 rows in flight in a ring of registers.  The
// loop over packet rows stays rolled, so the body the warps share is one
// unrolled step (R·s·V selects) and fits the instruction cache.  The
// masks come from problem blockIdx.z's A, at A + blockIdx.z · a_batch
// (a_batch = 0 but in the batched kernel), formed where a tile's masks
// are built so that no pointer of it is live across the loop.
template <int S, bool Seeded, int V, int R, typename Step>
__device__ __forceinline__ void stream_packets(
    uint32_t* masks, const uint8_t* A, long long a_batch,
    const long long* seeds, const uint8_t* P, long long ldp, int row0,
    int rows, int K, long long L, long long b0, int p_align, Step&& step) {
  const bool active = b0 < L;
  uint32_t ring[kGroup][V] = {};    // packet rows k .. k + kGroup - 1
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    if (active && g < K) {
      load_words<V>(P + static_cast<long long>(g) * ldp, b0, L, p_align,
                    ring[g]);
    }
  }
  for (int k0 = 0; k0 < K; k0 += kKTile) {
    const int kt = min(kKTile, K - k0);
    if (k0 > 0) __syncthreads();     // every thread is done with the tile
    build_masks<S, Seeded, R>(masks, A + blockIdx.z * a_batch, seeds, row0,
                              rows, K, k0, kt);
    __syncthreads();
    if (!active) continue;
#pragma unroll 1
    for (int k = 0; k < kt; ++k) {
      uint32_t cur[V];
#pragma unroll
      for (int v = 0; v < V; ++v) cur[v] = ring[0][v];
#pragma unroll
      for (int g = 0; g + 1 < kGroup; ++g) {
#pragma unroll
        for (int v = 0; v < V; ++v) ring[g][v] = ring[g + 1][v];
      }
      const int ahead = k0 + k + kGroup;
      if (ahead < K) {
        load_words<V>(P + static_cast<long long>(ahead) * ldp, b0, L,
                      p_align, ring[kGroup - 1]);
      }
      step(cur, masks + k * R * kMaskSlots);
    }
  }
}

// grid = (ceil(L / (4·V·kThreads)), ceil(n / tile)[, J]); block = kThreads;
// dynamic shared memory = min(K, kKTile) · R · 32 bytes.  Block (x, y)
// computes output rows tile·y .. tile·y + tile - 1 (tile <= R) at bytes
// 4·V·(kThreads·x + threadIdx.x) .. + 4·V - 1.  The body of both packed
// kernels; `masks` is the block's dynamic shared memory.  P is the
// block's problem's; its A and C lie at A + blockIdx.z · a_batch and
// C + blockIdx.z · c_batch, formed where they are used: the kernel's
// arguments sit in the constant bank, and per-problem pointers formed
// once at the top hold registers across the loop (at s = 8 they left
// the batched instance at 80 registers with 56 bytes of spills; formed
// at use, it takes 66 and spills nothing).
template <int S, bool Seeded, int V, int R>
__device__ __forceinline__ void packed_product(
    uint32_t* masks, const uint8_t* __restrict__ A, long long a_batch,
    const long long* __restrict__ seeds, const uint8_t* __restrict__ P,
    long long ldp, uint8_t* __restrict__ C, long long ldc, long long c_batch,
    int n, int K, long long L, int tile, int p_align, int c_align) {
  const int row0 = blockIdx.y * tile;
  const int rows = min(tile, n - row0);
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4 * V;

  uint32_t acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0u;
  }
  // the loop in two instances: full tiles (the main path) and the rest
  if (rows == R) {
    stream_packets<S, Seeded, V, R>(
        masks, A, a_batch, seeds, P, ldp, row0, rows, K, L, b0, p_align,
        [&](const uint32_t (&p)[V], const uint32_t* m) {
          ladder_step<S, V, R, true>(p, m, rows, acc);
        });
  } else {
    stream_packets<S, Seeded, V, R>(
        masks, A, a_batch, seeds, P, ldp, row0, rows, K, L, b0, p_align,
        [&](const uint32_t (&p)[V], const uint32_t* m) {
          ladder_step<S, V, R, false>(p, m, rows, acc);
        });
  }
  if (b0 >= L) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rows) {
      store_words<V>(C + blockIdx.z * c_batch +
                         static_cast<long long>(row0 + r) * ldc,
                     b0, L, c_align, acc[r]);
    }
  }
}

template <int S, bool Seeded, int V, int R>
__global__ void __launch_bounds__(kThreads)
gf_matmul_packed_kernel(const uint8_t* __restrict__ A,
                        const long long* __restrict__ seeds,
                        const uint8_t* __restrict__ P, long long ldp,
                        uint8_t* __restrict__ C, long long ldc, int n, int K,
                        long long L, int tile, int p_align, int c_align) {
  extern __shared__ uint4 smem[];
  packed_product<S, Seeded, V, R>(reinterpret_cast<uint32_t*>(smem), A, 0,
                                  seeds, P, ldp, C, ldc, 0, n, K, L, tile,
                                  p_align, c_align);
}

// Problem j = blockIdx.z: C[j] = A[j]·P[j].  The alignments hold for
// every problem's rows (the launcher folds the batch strides in).
template <int S, int V, int R>
__global__ void __launch_bounds__(kThreads)
gf_matmul_packed_batched_kernel(const uint8_t* __restrict__ A,
                                long long a_batch,
                                const uint8_t* __restrict__ P, long long ldp,
                                long long p_batch, uint8_t* __restrict__ C,
                                long long ldc, long long c_batch, int n,
                                int K, long long L, int tile, int p_align,
                                int c_align) {
  extern __shared__ uint4 smem[];
  packed_product<S, false, V, R>(reinterpret_cast<uint32_t*>(smem), A,
                                 a_batch, nullptr, P + blockIdx.z * p_batch,
                                 ldp, C, ldc, c_batch, n, K, L, tile,
                                 p_align, c_align);
}

// Same grid, block and shared memory as the packed kernels.
template <int S, int V, int R>
__global__ void __launch_bounds__(kThreads)
gf_matmul_unpacked_kernel(const uint8_t* __restrict__ A,
                          const uint8_t* __restrict__ P, long long ldp,
                          uint8_t* __restrict__ C, long long ldc, int n,
                          int K, long long L, int tile, int p_align,
                          int c_align) {
  extern __shared__ uint4 smem[];
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem);
  const int row0 = blockIdx.y * tile;
  const int rows = min(tile, n - row0);
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4 * V;

  uint32_t acc02[R][V], acc13[R][V];   // symbols 0, 2 and 1, 3 of a word
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc02[r][v] = acc13[r][v] = 0u;
  }
  // A's whole byte selects (bits >= S too): 8 masks per coefficient.
  // one instance of the loop, the full tile tested per step: with the
  // unpacked step's 16 rungs per word a second instance was slower
  stream_packets<8, false, V, R>(
      masks, A, 0, nullptr, P, ldp, row0, rows, K, L, b0, p_align,
      [&](const uint32_t (&p)[V], const uint32_t* m) {
        clmul_step<S, V, R, false>(p, m, rows, acc02, acc13);
      });
  if (b0 >= L) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rows) {
      uint32_t w[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        w[v] = (reduce_lanes16<S>(acc02[r][v]) & 0x00FF00FFu) |
               ((reduce_lanes16<S>(acc13[r][v]) & 0x00FF00FFu) << 8);
      }
      store_words<V>(C + static_cast<long long>(row0 + r) * ldc, b0, L,
                     c_align, w);
    }
  }
}

// The launch geometry every kernel here shares: kWords words per
// thread, balanced row tiles of at most kTileRows rows, the mask tile in
// dynamic shared memory.
struct Geometry {
  dim3 grid;
  size_t smem;
  int tile, p_align, c_align;
};

Geometry geometry(const uint8_t* P, long long ldp, const uint8_t* C,
                  long long ldc, int n, int K, long long L) {
  const long long per_block = 4LL * kWords * kThreads;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const int tile = (n + tiles - 1) / tiles;
  return {dim3(static_cast<unsigned>((L + per_block - 1) / per_block),
               static_cast<unsigned>(tiles)),
          static_cast<size_t>(std::min(K, kKTile)) * kTileRows * kMaskSlots *
              sizeof(uint32_t),
          tile, gf::row_alignment(P, ldp), gf::row_alignment(C, ldc)};
}

template <bool Seeded>
int launch_packed(const uint8_t* A, const long long* seeds, const uint8_t* P,
                  long long ldp, uint8_t* C, long long ldc, int n, int K,
                  long long L, int s, int device, cudaStream_t stream) {
  if (n <= 0 || L <= 0) return 0;
  if (s < 1 || s > 8 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = kWords, R = kTileRows;
  const Geometry g = geometry(P, ldp, C, ldc, n, K, L);
  return gf::on_device(device, [&] {
    switch (s) {
#define GF_CASE(SS)                                                          \
  case SS:                                                                   \
    gf_matmul_packed_kernel<SS, Seeded, V, R>                                \
        <<<g.grid, kThreads, g.smem, stream>>>(A, seeds, P, ldp, C, ldc, n,  \
                                               K, L, g.tile, g.p_align,      \
                                               g.c_align);                   \
    break;
      GF_CASE(1) GF_CASE(2) GF_CASE(3) GF_CASE(4)
      GF_CASE(5) GF_CASE(6) GF_CASE(7) GF_CASE(8)
#undef GF_CASE
    }
  });
}

int launch_packed_batched(const uint8_t* A, long long a_batch,
                          const uint8_t* P, long long ldp, long long p_batch,
                          uint8_t* C, long long ldc, long long c_batch, int J,
                          int n, int K, long long L, int s, int device,
                          cudaStream_t stream) {
  if (J <= 0 || n <= 0 || L <= 0) return 0;
  if (s < 1 || s > 8 || K < 0 || J > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int V = kWords, R = kTileRows;
  Geometry g = geometry(P, ldp, C, ldc, n, K, L);
  g.grid.z = static_cast<unsigned>(J);
  // every problem's rows: the widest load that the batch strides keep
  g.p_align = std::min(g.p_align, gf::row_alignment(P, p_batch));
  g.c_align = std::min(g.c_align, gf::row_alignment(C, c_batch));
  return gf::on_device(device, [&] {
    switch (s) {
#define GF_CASE(SS)                                                          \
  case SS:                                                                   \
    gf_matmul_packed_batched_kernel<SS, V, R>                                \
        <<<g.grid, kThreads, g.smem, stream>>>(A, a_batch, P, ldp, p_batch,  \
                                               C, ldc, c_batch, n, K, L,     \
                                               g.tile, g.p_align,            \
                                               g.c_align);                   \
    break;
      GF_CASE(1) GF_CASE(2) GF_CASE(3) GF_CASE(4)
      GF_CASE(5) GF_CASE(6) GF_CASE(7) GF_CASE(8)
#undef GF_CASE
    }
  });
}

int launch_unpacked(const uint8_t* A, const uint8_t* P, long long ldp,
                    uint8_t* C, long long ldc, int n, int K, long long L,
                    int s, int device, cudaStream_t stream) {
  if (n <= 0 || L <= 0) return 0;
  if (s < 1 || s > 8 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = kWords, R = kTileRows;
  const Geometry g = geometry(P, ldp, C, ldc, n, K, L);
  return gf::on_device(device, [&] {
    switch (s) {
#define GF_CASE(SS)                                                          \
  case SS:                                                                   \
    gf_matmul_unpacked_kernel<SS, V, R>                                      \
        <<<g.grid, kThreads, g.smem, stream>>>(A, P, ldp, C, ldc, n, K, L,   \
                                               g.tile, g.p_align, g.c_align); \
    break;
      GF_CASE(1) GF_CASE(2) GF_CASE(3) GF_CASE(4)
      GF_CASE(5) GF_CASE(6) GF_CASE(7) GF_CASE(8)
#undef GF_CASE
    }
  });
}

}  // namespace

extern "C" {

int gf_matmul_packed(const void* A, const void* P, long long ldp, void* C,
                     long long ldc, int n, int K, long long L, int s,
                     int device, void* stream) {
  return launch_packed<false>(static_cast<const uint8_t*>(A), nullptr,
                              static_cast<const uint8_t*>(P), ldp,
                              static_cast<uint8_t*>(C), ldc, n, K, L, s,
                              device, static_cast<cudaStream_t>(stream));
}

int gf_matmul_packed_seeded(const void* seeds, const void* P, long long ldp,
                            void* C, long long ldc, int n, int K, long long L,
                            int s, int device, void* stream) {
  return launch_packed<true>(nullptr, static_cast<const long long*>(seeds),
                             static_cast<const uint8_t*>(P), ldp,
                             static_cast<uint8_t*>(C), ldc, n, K, L, s,
                             device, static_cast<cudaStream_t>(stream));
}

int gf_matmul_packed_batched(const void* A, long long a_batch, const void* P,
                             long long ldp, long long p_batch, void* C,
                             long long ldc, long long c_batch, int J, int n,
                             int K, long long L, int s, int device,
                             void* stream) {
  return launch_packed_batched(
      static_cast<const uint8_t*>(A), a_batch, static_cast<const uint8_t*>(P),
      ldp, p_batch, static_cast<uint8_t*>(C), ldc, c_batch, J, n, K, L, s,
      device, static_cast<cudaStream_t>(stream));
}

int gf_matmul_unpacked(const void* A, const void* P, long long ldp, void* C,
                       long long ldc, int n, int K, long long L, int s,
                       int device, void* stream) {
  return launch_unpacked(static_cast<const uint8_t*>(A),
                         static_cast<const uint8_t*>(P), ldp,
                         static_cast<uint8_t*>(C), ldc, n, K, L, s, device,
                         static_cast<cudaStream_t>(stream));
}

const char* gf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
