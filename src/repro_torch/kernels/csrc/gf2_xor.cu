// Hand-written Hopper (sm_90a) kernel for the GF(2) coded combine (s = 1).
//
// gf2_matmul_kernel
//   Replaces the TPU kernel src/repro/kernels/gf2_xor.py gf2_matmul_pallas
//   (_kernel): C[i] = XOR over {k : A[i,k] & 1} of P[k], on raw bytes.
//
// Arithmetic.  With s = 1 a coefficient is one bit and the field product
// is a mask, so every bit-plane of a byte mixes with the same
// coefficients: the kernel XORs whole bytes, 16 at a time.  Only bit 0
// of A is read, as in the reference (callers hand it arbitrary bytes).
//
// What bounds it.  Per 16 bytes of a row the kernel does one AND and
// one XOR per (row, k) pair, 2·n·K operations for 16·(K + n) bytes
// moved: at n = K = 8 that is 0.5 operations per byte against the
// card's 5, so it is bound by HBM.  The design reads each byte of P
// once per row tile with 16-byte loads (a warp reads 512 contiguous
// bytes of a row), keeps A's bits in shared memory as 0x00/0xFF masks
// built once per block, and keeps the kRows accumulators (4 words
// each) in registers.
//
// Contract (checked by the Python wrapper): A (n, K) uint8 contiguous;
// P (K, L) uint8 with unit column stride and row stride ldp; C (n, L)
// uint8 with unit column stride and row stride ldc.  Rows whose address
// and stride are 16-byte aligned take one 16-byte load, 4- or 8-byte
// aligned ones four 4-byte loads, others byte loads; a ragged tail is masked
// here, not padded by the caller.  L = 0 returns at once.  The blocks
// share nothing, so they run in any order.
#include <cstdint>

#include <cuda_runtime.h>

#include "gf_common.cuh"

namespace {

using gf::kRows;

constexpr int kThreads = 128;     // 16-byte groups per block, one per thread
constexpr int kBytes = 16;        // bytes per thread per row

// 16 bytes starting at byte 16·j of a row of length L; bytes past L
// read as 0.  `align` is the row alignment (16, 8, 4 or 1).
__device__ __forceinline__ uint4 load16(const uint8_t* row, long long j,
                                        long long L, int align) {
  const long long b0 = static_cast<long long>(kBytes) * j;
  if (b0 + kBytes <= L) {
    if (align == 16) return *reinterpret_cast<const uint4*>(row + b0);
    if (align >= 4) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(row + b0);
      return make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < kBytes; ++b) {
    if (b0 + b < L) {
      w[b / 4] |= static_cast<uint32_t>(row[b0 + b]) << (8 * (b % 4));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Store 16 bytes at byte 16·j of a row of length L; bytes past L are
// not written.
__device__ __forceinline__ void store16(uint8_t* row, long long j, long long L,
                                        int align, uint4 v) {
  const long long b0 = static_cast<long long>(kBytes) * j;
  if (b0 + kBytes <= L) {
    if (align == 16) {
      *reinterpret_cast<uint4*>(row + b0) = v;
      return;
    }
    if (align >= 4) {
      uint32_t* w = reinterpret_cast<uint32_t*>(row + b0);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
      return;
    }
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int b = 0; b < kBytes; ++b) {
    if (b0 + b < L) {
      row[b0 + b] = static_cast<uint8_t>(w[b / 4] >> (8 * (b % 4)));
    }
  }
}

// grid = (ceil(ceil(L/16) / kThreads), ceil(n / kRows)); block = kThreads;
// dynamic shared memory = kRows * K bytes.
__global__ void __launch_bounds__(kThreads)
gf2_matmul_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ P,
                  long long ldp, uint8_t* __restrict__ C, long long ldc, int n,
                  int K, long long L, int p_align, int c_align) {
  extern __shared__ uint8_t mask[];  // [rows][K]: 0x00 or 0xFF
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, n - row0);
  for (int t = threadIdx.x; t < rows * K; t += blockDim.x) {
    mask[t] = static_cast<uint8_t>(
        0u - (A[static_cast<long long>(row0) * K + t] & 1u));
  }
  __syncthreads();

  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= (L + kBytes - 1) / kBytes) return;

  uint4 acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = make_uint4(0u, 0u, 0u, 0u);

  for (int k = 0; k < K; ++k) {
    const uint4 p =
        load16(P + static_cast<long long>(k) * ldp, j, L, p_align);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const uint32_t m =
            static_cast<uint32_t>(mask[r * K + k]) * 0x01010101u;
        acc[r].x ^= p.x & m;
        acc[r].y ^= p.y & m;
        acc[r].z ^= p.z & m;
        acc[r].w ^= p.w & m;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
      store16(C + static_cast<long long>(row0 + r) * ldc, j, L, c_align,
              acc[r]);
    }
  }
}

}  // namespace

extern "C" {

// Largest K whose mask tile fits the default 48 KB of shared memory.
int gf_max_k() { return gf::kSmemBytes / kRows; }

// `s` is accepted for the shared C interface of the GF kernels and not
// read: the coefficients are bits.
int gf2_matmul(const void* A, const void* P, long long ldp, void* C,
               long long ldc, int n, int K, long long L, int s, int device,
               void* stream) {
  (void)s;
  if (n <= 0 || L <= 0) return 0;
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (L + kBytes - 1) / kBytes;
  const dim3 grid(static_cast<unsigned>((groups + kThreads - 1) / kThreads),
                  static_cast<unsigned>((n + kRows - 1) / kRows));
  const size_t smem = static_cast<size_t>(kRows) * K;
  const int p_align = gf::row_alignment(P, ldp);
  const int c_align = gf::row_alignment(C, ldc);
  return gf::on_device(device, [&] {
    gf2_matmul_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(A), static_cast<const uint8_t*>(P), ldp,
        static_cast<uint8_t*>(C), ldc, n, K, L, p_align, c_align);
  });
}

const char* gf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
