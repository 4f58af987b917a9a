// Hand-written Hopper (sm_90a) kernel for causal flash attention.
//
// flash_attention_kernel<HD, T>
//   Replaces the TPU kernel src/repro/kernels/flash_attention.py
//   flash_attention_folded (_kernel, and the wrapper flash_attention):
//   softmax(q·kᵀ / sqrt(hd)) · v per head, online over key tiles, with the
//   running max, normalizer and accumulator in float32, masked scores at
//   -1e30 and the output acc / max(l, 1e-20) in q's dtype.  With `causal`
//   a query tile stops at the key tile that holds its last row, as the
//   TPU kernel's loop bound does (flash_attention.py:38-42).
//
// Layout.  q is (B, S, H, hd) and k, v are (B, S, KV, hd), read through
// their batch, sequence and head strides (elements; hd has unit
// stride), so the tensors that leave RoPE need no transpose or fold.
// Query head h reads KV head h / (H / KV): grouped-query attention
// without expanding K and V.  The output o is written through its own
// strides.  A ragged last query or key tile is masked here, not padded
// by the caller.
//
// What bounds it.  Causal attention at the serving shape (hd = 128,
// S = 2048) does ~S/2 multiply-adds per query element for each of the
// two products and moves each element of q, k, v and o once: about 512
// operations per byte, so the card's arithmetic bounds it, not HBM.
// This first kernel runs on the CUDA cores in float32 FMA (tensor
// cores, wgmma and TMA are later work), so its own ceiling is the
// float32 rate, about 1/15 of the bf16 tensor-core rate of the bound.
// The design keeps the score tile and the softmax state out of device
// memory: one block per (batch·head, 64 query rows), 256 threads, four
// per query row.  K and V tiles of 32 keys are staged in shared memory
// as float32; each thread computes whole dot products for 8 of the 32
// keys (its q row and the keys read as float4 from shared memory), the
// four threads of a row reduce max and sum with warp shuffles, write
// their probabilities to a shared row, and then each accumulates a
// quarter of the head dimension (hd / 4 floats in registers: 32 at
// hd = 128, which is what keeps the accumulator out of local memory).
// Rows are padded by 4 floats (by 1 for the probability rows) so the
// float4 reads of a warp fall on distinct banks.  Query tiles are
// scheduled longest first, so the short causal tiles fill the tail.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gf_common.cuh"

namespace {

constexpr int kBlockQ = 64;                   // query rows per block
constexpr int kBlockK = 32;                   // keys per shared-memory tile
constexpr int kGroup = 4;                     // threads per query row
constexpr int kThreads = kBlockQ * kGroup;    // 256
constexpr int kKeysPerThread = kBlockK / kGroup;
constexpr int kPStride = kBlockK + 1;         // floats per probability row
constexpr float kMaskValue = -1e30f;          // as the TPU kernel's NEG_INF

struct Strides {
  long long b, s, h;    // batch, sequence, head strides in elements
};

template <int HD>
__host__ __device__ constexpr int row_stride() { return HD + 4; }  // floats/row

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBlockQ + 2 * kBlockK) * row_stride<HD>() +
          static_cast<size_t>(kBlockQ) * kPStride);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int groups, Strides qs, Strides ks, Strides vs,
                       Strides os, int causal, float scale) {
  constexpr int ST = row_stride<HD>();
  constexpr int kChunks = HD / (4 * kGroup);   // float4 accumulators/thread
  extern __shared__ float4 smem4[];            // 16-byte aligned
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBlockQ * ST;
  float* Vs = Ks + kBlockK * ST;
  float* Ps = Vs + kBlockK * ST;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;   // longest first
  const int tid = threadIdx.x;
  const int r = tid / kGroup;          // query row within the tile
  const int t = tid % kGroup;          // lane within the row's group
  const int qpos = q0 + r;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / groups) * ks.h;
  const T* vb = v + b * vs.b + (h / groups) * vs.h;

  // q tile, pre-scaled as the TPU kernel does; rows past S read as 0
  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int row = i / HD, col = i % HD;
    const int pos = q0 + row;
    Qs[row * ST + col] = pos < S ? to_f32(qb[pos * qs.s + col]) * scale : 0.f;
  }

  const int last = causal ? min(q0 + kBlockQ, S) : S;
  const int n_tiles = (last + kBlockK - 1) / kBlockK;
  float acc[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  }
  float m = kMaskValue, l = 0.f;
  const float4* qrow = reinterpret_cast<const float4*>(Qs + r * ST);
  float* prow = Ps + r * kPStride;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();     // the q tile is written; the last tile is read
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int row = i / HD, col = i % HD;
      const int pos = k0 + row;
      const bool in = pos < S;
      Ks[row * ST + col] = in ? to_f32(kb[pos * ks.s + col]) : 0.f;
      Vs[row * ST + col] = in ? to_f32(vb[pos * vs.s + col]) : 0.f;
    }
    __syncthreads();

    // scores of this thread's keys t, t + 4, ..., t + 28
    float sc[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) sc[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD / 4; ++d) {
      const float4 qv = qrow[d];
#pragma unroll
      for (int i = 0; i < kKeysPerThread; ++i) {
        const float4 kv =
            reinterpret_cast<const float4*>(Ks + (t + kGroup * i) * ST)[d];
        sc[i] = fmaf(qv.x, kv.x, sc[i]);
        sc[i] = fmaf(qv.y, kv.y, sc[i]);
        sc[i] = fmaf(qv.z, kv.z, sc[i]);
        sc[i] = fmaf(qv.w, kv.w, sc[i]);
      }
    }

    // online softmax; the row's four threads are adjacent lanes of a warp
    float tile_max = kMaskValue;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int kpos = k0 + t + kGroup * i;
      const bool live = kpos < S && (!causal || kpos <= qpos);
      sc[i] = live ? sc[i] : kMaskValue;
      tile_max = fmaxf(tile_max, sc[i]);
    }
#pragma unroll
    for (int off = 1; off < kGroup; off <<= 1) {
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const float p = expf(sc[i] - m_new);
      sum += p;
      prow[t + kGroup * i] = p;
    }
#pragma unroll
    for (int off = 1; off < kGroup; off <<= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    l = l * corr + sum;
    m = m_new;
    __syncwarp();        // the row's probabilities are visible to its group

#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      acc[c][0] *= corr;
      acc[c][1] *= corr;
      acc[c][2] *= corr;
      acc[c][3] *= corr;
    }
#pragma unroll 4
    for (int jj = 0; jj < kBlockK; ++jj) {
      const float p = prow[jj];
      const float4* vrow = reinterpret_cast<const float4*>(Vs + jj * ST);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = vrow[t + kGroup * c];
        acc[c][0] = fmaf(p, vv.x, acc[c][0]);
        acc[c][1] = fmaf(p, vv.y, acc[c][1]);
        acc[c][2] = fmaf(p, vv.z, acc[c][2]);
        acc[c][3] = fmaf(p, vv.w, acc[c][3]);
      }
    }
    __syncwarp();        // reads of the row done before the next tile's writes
  }

  if (qpos < S) {
    const float denom = fmaxf(l, 1e-20f);
    T* orow = o + b * os.b + qpos * os.s + h * os.h;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = 4 * (t + kGroup * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) store(orow + d + e, acc[c][e] / denom);
    }
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, const Strides& qs, const Strides& ks,
           const Strides& vs, const Strides& os, int causal, float scale,
           int device, cudaStream_t stream) {
  const long long q_tiles = (S + kBlockQ - 1) / kBlockQ;
  const long long heads = static_cast<long long>(B) * H;
  if (q_tiles > 65535 || heads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(heads),
                  static_cast<unsigned>(q_tiles));
  const size_t smem = smem_bytes<HD>();
  auto* kernel = flash_attention_kernel<HD, T>;
  cudaError_t attr = cudaSuccess;
  const int err = gf::on_device(device, [&] {
    attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, H, H / KV, qs, ks,
        vs, os, causal, scale);
  });
  return attr != cudaSuccess ? static_cast<int>(attr) : err;
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int S, int H, int KV, const Strides& qs,
                const Strides& ks, const Strides& vs, const Strides& os,
                int causal, float scale, int device, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<32, T>(q, k, v, o, B, S, H, KV, qs, ks, vs, os, causal,
                           scale, device, stream);
    case 64:
      return launch<64, T>(q, k, v, o, B, S, H, KV, qs, ks, vs, os, causal,
                           scale, device, stream);
    case 128:
      return launch<128, T>(q, k, v, o, B, S, H, KV, qs, ks, vs, os, causal,
                            scale, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Strides in elements.  Returns 0 or the
// CUDA error of the launch (a refused launch never runs).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int dtype, int B, int S, int H, int KV, int hd,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long o_sb, long long o_ss, long long o_sh,
                    int causal, float scale, int device, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_hd<float>(hd, q, k, v, o, B, S, H, KV, qs, ks, vs, os,
                              causal, scale, device, st);
  }
  if (dtype == 1) {
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, H, KV, qs, ks, vs,
                                      os, causal, scale, device, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
