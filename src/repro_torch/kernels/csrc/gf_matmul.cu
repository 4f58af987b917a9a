// Hand-written Hopper (sm_90a) kernels for C = A·P over GF(2^s), s = 1..8.
//
// gf_matmul_packed_kernel<S, false>
//   Replaces the TPU kernel src/repro/kernels/gf_matmul.py
//   gf_matmul_pallas_packed (_packed_kernel, _xtime_packed).
// gf_matmul_packed_kernel<S, true>
//   Replaces src/repro/kernels/gf_matmul.py gf_matmul_pallas_packed_seeded
//   (_packed_seeded_kernel, with repro.core.seeds threefry2x32/coeff_words).
// gf_matmul_unpacked_kernel<S>
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
// What bounds them.  Per packed word the kernel does K·(s-1) xtimes (at
// least 4 int32 operations each) and n·K·s bit-selects (at least one
// each) but moves only (K + n)·4 bytes.  At the main path's shapes
// (n = K = 8, s = 8) that is 736 operations for 64 bytes, 11.5 per
// byte, while an H100 SXM balances at 5 (16.7 T int32 op/s over
// 3.35 TB/s): it is bound by the int32 pipes, not by HBM.  The
// design keeps every operand of that arithmetic on chip: the (rows x K)
// coefficient tile sits in shared memory (the seeded kernel builds it
// there from 4-byte seeds with Threefry-2x32-20 before a
// __syncthreads()), the s rungs and the kRows accumulators live in
// registers, and each packet word is read from HBM exactly once per
// row tile.  Coalesced 4-byte loads (a warp reads 128 contiguous bytes
// of a row) keep the memory side far below its bound.
//
// Arithmetic of the unpacked kernel.  The reference computes, per k and
// per symbol, clmul(A[i,k], P[k,j]) = XOR_{i<s} (A[i,k] << i)·bit_i(P)
// in a 32-bit lane, reduces bits 2s-2..s by PRIMITIVE_POLY[s], XORs the
// products and keeps the low byte; A's byte is not masked, P's bits at
// or above s are never read.  Here a thread takes 4 consecutive symbols
// (one 32-bit load when the row is aligned) and spreads them over two
// registers of two 16-bit lanes each (symbols 0, 2 and 1, 3), masked to
// s bits.  The clmul is computed the other way round, which carry-less
// multiplication allows: XOR over the 8 bits j of A[i,k] of P << j.
// The rungs P << j (j < 8) are shared by all output rows; a product has
// at most 15 bits, so no lane spills into the next.  Reduction by the
// polynomial is linear over GF(2), so the lanes accumulate the unreduced
// products over k and reduce once per output, bit for bit the
// reference's reduce-then-XOR.  What bounds it: per 4 symbols, per row
// and per k, about 56 int32 operations (8 masks from A's bits, 16
// select-and-XORs) against 4 bytes moved per (k + row): bound by the
// int32 pipes, like the packed kernels, with ~6x their operations.
//
// Contract (checked by the Python wrappers): A (n, K) uint8 contiguous;
// seeds (n,) int64 whose low 32 bits are the seeds; P (K, L) uint8 with
// unit column stride and row stride ldp (a column slice of a wider
// matrix is fine); C (n, L) uint8 with unit column stride and row stride
// ldc (the chunk's columns of the engine's output).  Ragged L is masked here,
// word by word, not padded by the caller; n != K is fine; L = 0 returns
// at once.  The blocks share nothing, so they run in any order.
#include <cstdint>

#include <cuda_runtime.h>

#include "gf_common.cuh"

namespace {

using gf::kRows;

constexpr int kThreads = 256;     // packed words per block, one per thread
constexpr uint32_t kOne = 0x01010101u;   // bit 0 of every byte lane
constexpr uint32_t kLane16 = 0x00010001u;  // bit 0 of both 16-bit lanes
constexpr uint32_t kKeySalt = 0x46644E43u;  // "FdNC", repro.core.seeds

__host__ __device__ constexpr uint32_t primitive_poly(int s) {
  return s == 1 ? 0x3u : s == 2 ? 0x7u : s == 3 ? 0xBu : s == 4 ? 0x13u
       : s == 5 ? 0x25u : s == 6 ? 0x43u : s == 7 ? 0x83u : 0x11Du;
}

// Word j of a byte row of length L; bytes past L read as 0.
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, long long j,
                                              long long L, bool aligned) {
  const long long b0 = 4 * j;
  if (aligned && b0 + 4 <= L) {
    return *reinterpret_cast<const uint32_t*>(row + b0);
  }
  uint32_t w = 0u;
  for (int b = 0; b < 4; ++b) {
    if (b0 + b < L) w |= static_cast<uint32_t>(row[b0 + b]) << (8 * b);
  }
  return w;
}

// Store word j of a byte row of length L; bytes past L are not written.
__device__ __forceinline__ void store_word(uint8_t* row, long long j,
                                           long long L, bool aligned,
                                           uint32_t w) {
  const long long b0 = 4 * j;
  if (aligned && b0 + 4 <= L) {
    *reinterpret_cast<uint32_t*>(row + b0) = w;
    return;
  }
  for (int b = 0; b < 4; ++b) {
    if (b0 + b < L) row[b0 + b] = static_cast<uint8_t>(w >> (8 * b));
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

// grid = (ceil(ceil(L/4) / kThreads), ceil(n / kRows)); block = kThreads;
// dynamic shared memory = kRows * K bytes.
template <int S, bool Seeded>
__global__ void __launch_bounds__(kThreads)
gf_matmul_packed_kernel(const uint8_t* __restrict__ A,
                        const long long* __restrict__ seeds,
                        const uint8_t* __restrict__ P, long long ldp,
                        uint8_t* __restrict__ C, long long ldc, int n, int K,
                        long long L, bool p_aligned, bool c_aligned) {
  extern __shared__ uint8_t coeff[];  // [rows][K]
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, n - row0);
  if constexpr (Seeded) {
    const int n_words = (K + 3) / 4;
    for (int t = threadIdx.x; t < rows * n_words; t += blockDim.x) {
      const int i = t / n_words;
      const int wi = t - i * n_words;
      const uint32_t word = threefry2x32_w0(
          static_cast<uint32_t>(seeds[row0 + i]), kKeySalt,
          static_cast<uint32_t>(wi), 0u);
      for (int b = 0; b < 4 && 4 * wi + b < K; ++b) {
        coeff[i * K + 4 * wi + b] =
            static_cast<uint8_t>((word >> (8 * b)) & ((1u << S) - 1u));
      }
    }
  } else {
    for (int t = threadIdx.x; t < rows * K; t += blockDim.x) {
      coeff[t] = A[static_cast<long long>(row0) * K + t];
    }
  }
  __syncthreads();

  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= (L + 3) / 4) return;

  uint32_t acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0u;

  for (int k = 0; k < K; ++k) {
    uint32_t rung[S];
    rung[0] = load_word(P + static_cast<long long>(k) * ldp, j, L, p_aligned);
#pragma unroll
    for (int i = 1; i < S; ++i) rung[i] = xtime<S>(rung[i - 1]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const uint32_t a = coeff[r * K + k];
#pragma unroll
        for (int i = 0; i < S; ++i) acc[r] ^= rung[i] & (0u - ((a >> i) & 1u));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
      store_word(C + static_cast<long long>(row0 + r) * ldc, j, L, c_aligned,
                 acc[r]);
    }
  }
}

// Reduce the unreduced clmul sums of both 16-bit lanes by the primitive
// polynomial: bits 2S-2 down to S, as the reference's _gf_mul_vec does.
template <int S>
__device__ __forceinline__ uint32_t reduce_lanes16(uint32_t acc) {
  constexpr uint32_t poly = primitive_poly(S);
#pragma unroll
  for (int i = 2 * S - 2; i >= S; --i) {
    acc ^= ((acc >> i) & kLane16) * (poly << (i - S));
  }
  return acc;
}

// grid = (ceil(ceil(L/4) / kThreads), ceil(n / kRows)); block = kThreads;
// dynamic shared memory = kRows * K bytes.
template <int S>
__global__ void __launch_bounds__(kThreads)
gf_matmul_unpacked_kernel(const uint8_t* __restrict__ A,
                          const uint8_t* __restrict__ P, long long ldp,
                          uint8_t* __restrict__ C, long long ldc, int n,
                          int K, long long L, bool p_aligned,
                          bool c_aligned) {
  extern __shared__ uint8_t coeff[];  // [rows][K], whole bytes
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, n - row0);
  for (int t = threadIdx.x; t < rows * K; t += blockDim.x) {
    coeff[t] = A[static_cast<long long>(row0) * K + t];
  }
  __syncthreads();

  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= (L + 3) / 4) return;

  constexpr uint32_t sym_mask = ((1u << S) - 1u) * kLane16;
  uint32_t acc02[kRows], acc13[kRows];   // symbols 0, 2 and 1, 3
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc02[r] = acc13[r] = 0u;

  for (int k = 0; k < K; ++k) {
    const uint32_t w =
        load_word(P + static_cast<long long>(k) * ldp, j, L, p_aligned);
    uint32_t rung02[8], rung13[8];     // P << j for the 8 bits of A
    rung02[0] = w & sym_mask;
    rung13[0] = (w >> 8) & sym_mask;
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      rung02[i] = rung02[0] << i;
      rung13[i] = rung13[0] << i;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const uint32_t a = coeff[r * K + k];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t m = 0u - ((a >> i) & 1u);
          acc02[r] ^= rung02[i] & m;
          acc13[r] ^= rung13[i] & m;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
      const uint32_t w02 = reduce_lanes16<S>(acc02[r]) & 0x00FF00FFu;
      const uint32_t w13 = reduce_lanes16<S>(acc13[r]) & 0x00FF00FFu;
      store_word(C + static_cast<long long>(row0 + r) * ldc, j, L, c_aligned,
                 w02 | (w13 << 8));
    }
  }
}

template <int S, bool Seeded>
void launch_s(dim3 grid, size_t smem, cudaStream_t stream, const uint8_t* A,
              const long long* seeds, const uint8_t* P, long long ldp,
              uint8_t* C, long long ldc, int n, int K, long long L, bool p_al,
              bool c_al) {
  gf_matmul_packed_kernel<S, Seeded><<<grid, kThreads, smem, stream>>>(
      A, seeds, P, ldp, C, ldc, n, K, L, p_al, c_al);
}

// The launch geometry every kernel here shares: one thread per packed
// word, kRows output rows per block, the coefficient tile in shared
// memory.
struct Geometry {
  dim3 grid;
  size_t smem;
  bool p_al, c_al;
};

Geometry geometry(const uint8_t* P, long long ldp, const uint8_t* C,
                  long long ldc, int n, int K, long long L) {
  const long long words = (L + 3) / 4;
  return {dim3(static_cast<unsigned>((words + kThreads - 1) / kThreads),
               static_cast<unsigned>((n + kRows - 1) / kRows)),
          static_cast<size_t>(kRows) * K, gf::row_alignment(P, ldp) >= 4,
          gf::row_alignment(C, ldc) >= 4};
}

template <bool Seeded>
int launch(const uint8_t* A, const long long* seeds, const uint8_t* P,
           long long ldp, uint8_t* C, long long ldc, int n, int K,
           long long L, int s, int device, cudaStream_t stream) {
  if (n <= 0 || L <= 0) return 0;
  if (s < 1 || s > 8 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(P, ldp, C, ldc, n, K, L);
  return gf::on_device(device, [&] {
    switch (s) {
#define GF_CASE(SS)                                                          \
  case SS:                                                                   \
    launch_s<SS, Seeded>(g.grid, g.smem, stream, A, seeds, P, ldp, C, ldc, n, \
                         K, L, g.p_al, g.c_al);                              \
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
  const Geometry g = geometry(P, ldp, C, ldc, n, K, L);
  return gf::on_device(device, [&] {
    switch (s) {
#define GF_CASE(SS)                                                     \
  case SS:                                                              \
    gf_matmul_unpacked_kernel<SS><<<g.grid, kThreads, g.smem, stream>>>( \
        A, P, ldp, C, ldc, n, K, L, g.p_al, g.c_al);                    \
    break;
      GF_CASE(1) GF_CASE(2) GF_CASE(3) GF_CASE(4)
      GF_CASE(5) GF_CASE(6) GF_CASE(7) GF_CASE(8)
#undef GF_CASE
    }
  });
}

}  // namespace

extern "C" {

// Largest K whose coefficient tile fits the default 48 KB of shared memory.
int gf_max_k() { return gf::kSmemBytes / kRows; }

int gf_matmul_packed(const void* A, const void* P, long long ldp, void* C,
                     long long ldc, int n, int K, long long L, int s,
                     int device, void* stream) {
  return launch<false>(static_cast<const uint8_t*>(A), nullptr,
                       static_cast<const uint8_t*>(P), ldp,
                       static_cast<uint8_t*>(C), ldc, n, K, L, s, device,
                       static_cast<cudaStream_t>(stream));
}

int gf_matmul_packed_seeded(const void* seeds, const void* P, long long ldp,
                            void* C, long long ldc, int n, int K, long long L,
                            int s, int device, void* stream) {
  return launch<true>(nullptr, static_cast<const long long*>(seeds),
                      static_cast<const uint8_t*>(P), ldp,
                      static_cast<uint8_t*>(C), ldc, n, K, L, s, device,
                      static_cast<cudaStream_t>(stream));
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
