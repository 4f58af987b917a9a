// Hand-written Hopper (sm_90a) kernel for the GF(2) coded combine (s = 1).
//
// gf2_matmul_kernel<R>
//   Replaces the TPU kernel src/repro/kernels/gf2_xor.py gf2_matmul_pallas
//   (_kernel): C[i] = XOR over {k : A[i,k] & 1} of P[k], on raw bytes.
//
// Arithmetic.  With s = 1 a coefficient is one bit and the field product
// is a mask, so every bit-plane of a byte mixes with the same
// coefficients: the kernel XORs whole bytes.  Only bit 0 of A is read, as
// in the reference (callers hand it arbitrary bytes).
//
// What bounds it.  Per 4-byte word of a row the kernel does one select,
// acc ^= P_k & mask (one LOP3), per (row, k) pair: 2·n·K operations for
// (K + n)·L bytes moved, at n = K = 8 0.5 operations per byte against the
// card's 5.  So it is bound by HBM: the design keeps loads of P in flight
// from the start, spends little else, and keeps its code small, because
// in a coding round each launch finds the instruction cache cold (the
// two legs of a RowMix round alternate two instances of the kernel):
//
// * Loads in flight.  A thread owns kBytes = 16 consecutive bytes of a
//   row and copies those of the next kGroup = 4 packet rows into its own
//   slots of a ring in shared memory with cp.async, refilling each slot
//   kGroup packet rows ahead as it uses it.  At the chunk shape (L =
//   2^18) that is 128 blocks of 128 threads and 1 MB of copies in flight,
//   half of P.  Little's law (3.35 TB/s x ~0.6 µs) asks for about all of
//   P, yet rings of 2, 8 and 16 packet rows (all of P at K <= 16) and
//   blocks of 32 or 64 threads were slower on the card, and 8 bytes per
//   thread no faster.  The loop over packet rows stays rolled: a ring of
//   registers,
//   which must be unrolled, ran as fast back to back but 2x slower in a
//   round, its unrolled code missing the instruction cache at every
//   launch.
// * Alignment.  Rows 16-, 8- and 4-byte aligned copy 16-, 8- and 4-byte
//   pieces; a piece that runs past L is zero-filled by the copy itself
//   (its source size), so the ragged tail needs no other path.  Rows
//   with no 4-byte alignment take byte loads, one packet row at a time.
// * Masks: each block expands its rows' bits once into shared memory as
//   32-bit 0 / ~0 words, [k][row], and a packet row's step reads them
//   four rows at a time with broadcast LDS.128.  Masks of kKTile packet
//   rows are held at a time, so K has no shared-memory limit.
// * Rows: a block owns all n <= kTileRows = 16 output rows, so P is read
//   once; a row tile is R = 4, 8, 12 or 16 rows (n rounded up to 4), the
//   rows past n holding zero masks, so no row has a branch until the
//   stores.  Above 16 rows the tiles are balanced over blockIdx.y and
//   each re-reads P.
//
// Contract (checked by the Python wrapper): A (n, K) uint8 contiguous;
// P (K, L) uint8 with unit column stride and row stride ldp; C (n, L)
// uint8 with unit column stride and row stride ldc.  A ragged tail is
// masked here, not padded by the caller.  L = 0 returns at once; K = 0
// writes zeros.  The blocks share nothing, so they run in any order.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "gf_common.cuh"

namespace {

constexpr int kThreads = 128;     // threads per block
constexpr int kBytes = 16;        // bytes of a row per thread
constexpr int kGroup = 4;         // packet rows whose copies fly together
constexpr int kKTile = 32;        // packet rows whose masks a block holds
constexpr int kTileRows = 16;     // most output rows per block
constexpr int kWords = kBytes / 4;
constexpr int kRingBytes = kGroup * kThreads * kBytes;   // the copies' ring

static_assert(kBytes == 16, "a thread's slot of the ring is one uint4");

// V words (4V bytes) at byte b0 of a row of length L, byte by byte;
// bytes past L read as 0.
template <int V>
__device__ __forceinline__ void load_bytes(const uint8_t* row, long long b0,
                                           long long L, uint32_t (&w)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    w[v] = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b0 + 4 * v + b < L) {
        w[v] |= static_cast<uint32_t>(row[b0 + 4 * v + b]) << (8 * b);
      }
    }
  }
}

// Copy W bytes (W = 16, 8 or 4) from `src` to the shared address `dst`
// without waiting: the first `valid` (0..W) are read, the rest of the W
// zero-filled.  Each call joins the thread's open group of copies.
template <int W>
__device__ __forceinline__ void copy_async(uint32_t dst, const uint8_t* src,
                                           int valid) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(W), "r"(valid) : "memory");
  }
}

// Close the thread's open group of copies.
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of the thread's groups of copies are in flight;
// the others have landed and the thread sees them.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The thread's kBytes of packet row `row` from byte b0 into its ring slot
// at shared address `dst`, W bytes a copy; bytes past L are zero-filled
// (and not read: a copy with nothing to read is pointed at the row).
template <int W>
__device__ __forceinline__ void copy_row(uint32_t dst, const uint8_t* row,
                                         long long b0, long long L) {
#pragma unroll
  for (int q = 0; q < kBytes / W; ++q) {
    const long long b = b0 + q * W;
    const int valid = static_cast<int>(
        max(0LL, min(static_cast<long long>(W), L - b)));
    copy_async<W>(dst + q * W, valid > 0 ? row + b : row, valid);
  }
}

// Store V words at byte b0 of a row of length L; bytes past L are not
// written.
template <int V>
__device__ __forceinline__ void store_words(uint8_t* row, long long b0,
                                            long long L, int align,
                                            const uint32_t (&w)[V]) {
  uint8_t* p = row + b0;
  if (b0 + 4 * V <= L) {
    if constexpr (V % 4 == 0) {
      if (align >= 16) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          reinterpret_cast<uint4*>(p)[q] = make_uint4(
              w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
        }
        return;
      }
    }
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

// Expand bit 0 of A's packet rows k0 .. k0+kt-1 into masks[kk][r] for
// the R rows of the tile; rows at or past `rows` get 0.
template <int R>
__device__ __forceinline__ void build_masks(uint32_t* masks, const uint8_t* A,
                                            int row0, int rows, int K, int k0,
                                            int kt) {
  for (int t = threadIdx.x; t < kt * R; t += blockDim.x) {
    const int kk = t / R;
    const int r = t - kk * R;
    masks[t] = r < rows
        ? 0u - (A[static_cast<long long>(row0 + r) * K + k0 + kk] & 1u)
        : 0u;
  }
}

// One packet row's selects: acc[r] ^= p & mask[r] for the R rows, the
// masks four rows per broadcast LDS.128.
template <int V, int R>
__device__ __forceinline__ void select_rows(const uint32_t (&p)[V],
                                            const uint32_t* m,
                                            uint32_t (&acc)[R][V]) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const uint4 x = reinterpret_cast<const uint4*>(m)[q];
    const uint32_t mask[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[4 * q + j][v] ^= p[v] & mask[j];
    }
  }
}

// The loop every path shares: for each tile of kKTile packet rows,
// expand the masks, then run `row(k, masks of k)` for its packet rows,
// one at a time, the loop rolled.
template <int R, typename Row>
__device__ __forceinline__ void stream_packets(uint32_t* masks,
                                               const uint8_t* A, int row0,
                                               int rows, int K, Row&& row) {
  for (int k0 = 0; k0 < K; k0 += kKTile) {
    const int kt = min(kKTile, K - k0);
    if (k0 > 0) __syncthreads();     // every thread is done with the tile
    build_masks<R>(masks, A, row0, rows, K, k0, kt);
    __syncthreads();
#pragma unroll 1
    for (int kk = 0; kk < kt; ++kk) row(k0 + kk, masks + kk * R);
  }
}

// grid = (ceil(L / (kBytes·kThreads)), ceil(n / tile)); block = kThreads;
// dynamic shared memory = kRingBytes + min(K, kKTile) · R · 4 bytes (the
// ring of copies, then the masks).  Block (x, y) computes output rows
// tile·y .. tile·y + tile - 1 (tile <= R) at bytes
// kBytes·(kThreads·x + threadIdx.x) .. + kBytes - 1.
template <int R>
__global__ void __launch_bounds__(kThreads)
gf2_matmul_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ P,
                  long long ldp, uint8_t* __restrict__ C, long long ldc, int n,
                  int K, long long L, int tile, int p_align, int c_align) {
  constexpr int V = kWords;
  extern __shared__ uint4 smem[];
  uint4* ring = smem;                // [kGroup][kThreads], row k at k % kGroup
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + kGroup * kThreads);
  const int row0 = blockIdx.y * tile;
  const int rows = min(tile, n - row0);
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kBytes;

  uint32_t acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0u;
  }
  // rows 4-byte aligned or more: the ring of copies, W bytes a copy
  auto copied = [&](auto width) {
    constexpr int W = decltype(width)::value;
    const uint32_t slot = static_cast<uint32_t>(
        __cvta_generic_to_shared(ring + threadIdx.x));
    constexpr uint32_t stride = kThreads * kBytes;   // bytes between slots
#pragma unroll 1
    for (int g = 0; g < kGroup; ++g) {
      if (g < K) copy_row<W>(slot + g * stride, P + g * ldp, b0, L);
      copy_commit();
    }
    stream_packets<R>(masks, A, row0, rows, K, [&](int k, const uint32_t* m) {
      const int g = k % kGroup;
      copy_wait<kGroup - 1>();       // packet row k has landed
      const uint4 x = ring[g * kThreads + threadIdx.x];
      const uint32_t p[V] = {x.x, x.y, x.z, x.w};
      select_rows<V, R>(p, m, acc);
      if (k + kGroup < K) {
        copy_row<W>(slot + g * stride, P + (k + kGroup) * ldp, b0, L);
      }
      copy_commit();                 // one group per packet row, even empty
    });
  };
  if (p_align >= 16) {
    copied(std::integral_constant<int, 16>());
  } else if (p_align >= 8) {
    copied(std::integral_constant<int, 8>());
  } else if (p_align >= 4) {
    copied(std::integral_constant<int, 4>());
  } else {                           // rows with no 4-byte alignment
    stream_packets<R>(masks, A, row0, rows, K, [&](int k, const uint32_t* m) {
      uint32_t p[V];
      load_bytes<V>(P + k * ldp, b0, L, p);
      select_rows<V, R>(p, m, acc);
    });
  }
  if (b0 >= L) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rows) {
      store_words<V>(C + static_cast<long long>(row0 + r) * ldc, b0, L,
                     c_align, acc[r]);
    }
  }
}

}  // namespace

extern "C" {

// `s` is accepted for the shared C interface of the GF kernels and not
// read: the coefficients are bits.
int gf2_matmul(const void* A, const void* P, long long ldp, void* C,
               long long ldc, int n, int K, long long L, int s, int device,
               void* stream) {
  (void)s;
  if (n <= 0 || L <= 0) return 0;
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = static_cast<long long>(kThreads) * kBytes;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const int tile = (n + tiles - 1) / tiles;
  const int R = (tile + 3) / 4 * 4;
  const dim3 grid(static_cast<unsigned>((L + per_block - 1) / per_block),
                  static_cast<unsigned>(tiles));
  const size_t smem =
      kRingBytes + static_cast<size_t>(K < kKTile ? K : kKTile) * R * 4;
  const int p_align = gf::row_alignment(P, ldp);
  const int c_align = gf::row_alignment(C, ldc);
  const auto* a = static_cast<const uint8_t*>(A);
  const auto* p = static_cast<const uint8_t*>(P);
  auto* c = static_cast<uint8_t*>(C);
  const auto st = static_cast<cudaStream_t>(stream);
  return gf::on_device(device, [&] {
    switch (R) {
#define GF2_CASE(RR)                                                         \
  case RR:                                                                   \
    gf2_matmul_kernel<RR><<<grid, kThreads, smem, st>>>(                     \
        a, p, ldp, c, ldc, n, K, L, tile, p_align, c_align);                 \
    break;
      GF2_CASE(4) GF2_CASE(8) GF2_CASE(12) GF2_CASE(16)
#undef GF2_CASE
    }
  });
}

const char* gf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
