// Hand-written Hopper (sm_90a) kernels for causal flash attention.
//
// Both replace the TPU kernel src/repro/kernels/flash_attention.py
// flash_attention_folded (_kernel, and the wrapper flash_attention):
// softmax(q·kᵀ / sqrt(hd)) · v per head, online over key tiles, with the
// running max, normalizer and accumulator in float32, masked scores at
// -1e30 and the output acc / max(l, 1e-20) in q's dtype.  With `causal`
// a query tile stops at the key tile that holds its last row, as the
// TPU kernel's loop bound does (flash_attention.py:38-42).
//
// Layout.  q is (B, S, H, hd) and k, v are (B, S, KV, hd), read through
// their batch, sequence and head strides (hd has unit stride), so the
// tensors that leave RoPE need no transpose or fold.  Query head h reads
// KV head h / (H / KV): grouped-query attention without expanding K and
// V.  The output o is written through its own strides.  A ragged last
// query or key tile is masked here, not padded by the caller.
//
// What bounds it.  Causal attention at the serving shape (hd = 128,
// S = 2048) does ~S/2 multiply-adds per query element for each of the
// two products and moves each element of q, k, v and o once: about 512
// operations per byte, so the card's bf16 tensor-core rate bounds it
// (989 TFLOP/s dense on an H100 SXM at 700 W), not HBM.
//
// bfloat16: flash_attention_kernel_wgmma<HD>, on the tensor cores.
// Persistent: one block per SM walks the work tiles (128 query rows of
// one batch·head), longest causal tiles first, with three warpgroups.
// A producer warpgroup gives its registers up (setmaxnreg) and one of
// its threads keeps TMA copies in flight: each work tile's q, then its
// K and V tiles of 128 keys into a ring of 2 shared-memory stages.
// mbarriers pace the ring: "full" ones that TMA completes (q, K, V of
// each stage) and "empty" ones the consumers arrive on, for K as soon as
// S has read it and for V after P·V, so the next K is in flight under
// this tile's products and the next work tile's q and K arrive while
// the consumers still finish and store the last one.  Two consumer
// warpgroups of 64 query rows each (one wgmma M) take the registers
// and, per key tile:
//   S = q·kᵀ   wgmma m64n128k16, both operands K-major in shared memory
//              (TMA's 128-byte swizzle, 64-byte at hd = 32, matched by
//              the descriptors), hd / 16 k-steps, float32 accumulator;
//   softmax    in registers: each thread holds two rows' quarter of the
//              64 x 128 scores, row max and sum over the 4 threads of a
//              row by shuffles, exp2 of one FMA (score x log2(e)/sqrt(hd)
//              − max); the causal and kpos < S masks only on the last
//              tile;
//   O += P·V   P rounded to bf16 in registers (the accumulator layout
//              is the A-from-registers fragment layout), wgmma
//              m64n{hd}k16 with V as an MN-major B (the transpose bit,
//              no transposed copy).
// Each consumer starts S_j and P_{j-1}·V_{j-1} together and runs the
// softmax of S_j while the tensor cores finish P_{j-1}·V_{j-1}; P stays
// float32 until that product is in, since ptxas serialises every wgmma
// of the kernel if an in-flight one's registers are written.  The two
// consumers take turns starting their products (ping-pong on two named
// barriers), so one's softmax runs under the other's.  At the serving shape
// the consumers' instruction count, not the tensor cores or the loads,
// proved to set the pace, so it is kept short: one FMA in the exponent,
// one compare per element on the masked tile, one reciprocal per row
// for the output, each tile's wgmma descriptors built once.  Scores, P
// and the accumulator never leave registers.  The TMA maps are 4-D (hd, heads,
// S, B) over the caller's strides, built per call on the host
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
// the library needs no -lcuda); TMA zero-fills rows past S.  Key tile 0
// runs first, so the running max is finite from the first tile on.
//
// float32: flash_attention_kernel<HD, float>, on the CUDA cores in FMA.
// It serves the float32 model, whose gates (rtol = atol = 2e-4 against
// the plain version, 1e-3 on decode logits) neither TF32 nor bf16
// tensor cores could hold, so it keeps full float32 products: one block
// per (batch·head, 64 query rows), 256 threads, four per query row.  K
// and V tiles of 32 keys are staged in shared memory as float32; each
// thread computes whole dot products for 8 of the 32 keys, the four
// threads of a row reduce max and sum with warp shuffles, write their
// probabilities to a shared row, and then each accumulates a quarter of
// the head dimension (hd / 4 floats in registers).  Rows are padded by 4
// floats (by 1 for the probability rows) so the float4 reads of a warp
// fall on distinct banks.
//
// Both take the longest causal query tiles first, so the short ones
// fill the tail.
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda.h>
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bfloat16: the warp-specialised tensor-core kernel
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int kBlockQ = 128;       // query rows per work tile: 2 wgmma M
constexpr int kBlockK = 128;       // keys per ring stage: the S wgmma's N
constexpr int kStages = 2;         // depth of the K/V ring
constexpr int kThreads = 384;      // producer + 2 consumer warpgroups
// setmaxnreg: 128 x 24 + 256 x 240 = 384 x 168, what the block holds
// at launch under __launch_bounds__(384, 1)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMask = -1e30f;    // as the TPU kernel's NEG_INF
static_assert(kBlockQ == kBlockK, "the diagonal tile is the last tile");

// One 128-row tile of q, k or v in shared memory at head_dim HD, as TMA
// writes it: HD / kCols column blocks ("atoms") of 128 rows x kSwizzle
// bytes each, in the swizzled layout the wgmma descriptors name.
template <int HD>
struct Tile {
  static constexpr int kSwizzle = HD >= 64 ? 128 : 64;   // bytes per row
  static constexpr int kCols = kSwizzle / 2;             // bf16 per row
  static constexpr int kAtoms = HD / kCols;
  static constexpr int kAtomBytes = kBlockK * kSwizzle;
  static constexpr int kBytes = kAtoms * kAtomBytes;     // 128 x HD x 2
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;  // B128/B64
  // q, kStages K, kStages V, then the mbarriers; +1 KB to align the base
  static constexpr int kBarriers = (1 + 2 * kStages) * kBytes;
  static constexpr size_t kSmem = kBarriers + 8 * (2 + 4 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0, c1, c2, c3) of `map` into shared memory at `dst`,
// its bytes counted on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// One 128-row tile (all HD columns) of `map` at (head, row, b) into `dst`.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int head, int row,
                                          int b) {
  using T = Tile<HD>;
  mbar_expect_tx(bar, T::kBytes);
#pragma unroll
  for (int a = 0; a < T::kAtoms; ++a) {
    tma_load_4d(dst + a * T::kAtomBytes, map, bar, a * T::kCols, head, row,
                b);
  }
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Wait until at most N of this thread's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Tie registers an asynchronous wgmma reads or writes to this point of
// the program, so the compiler moves no access to them across it.
template <typename R, int N>
__device__ __forceinline__ void fence_regs(R (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same_v<R, float>) {
      asm volatile("" : "+f"(r[i])::"memory");
    } else {
      asm volatile("" : "+r"(r[i])::"memory");
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // RNE
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 128, float32) {+}= A (64 x 16, smem) * B (16 x 128, smem),
// both K-major; D is zeroed first unless scale_d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 32, float32) += A (64 x 16, bf16 registers) * B (16 x 32,
// smem, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                           const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64, float32) += A (64 x 16, bf16 registers) * B (16 x 64,
// smem, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                           const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, float32) += A (64 x 16, bf16 registers) * B (16 x 128,
// smem, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                            const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S = q·kᵀ for one key tile: hd / 16 k-steps of m64n128k16, both
// operands K-major (the caller fences and commits).
template <int HD>
__device__ __forceinline__ void scores_wgmma(float (&sc)[kBlockK / 2],
                                             uint32_t q_rows,
                                             uint32_t k_tile) {
  using T = Tile<HD>;
  // k-step kk's descriptors are the tile's plus its offset in 16-byte
  // units (the start-address field holds any shared-memory address)
  const uint64_t dq = smem_desc(q_rows, 16, 8 * T::kSwizzle, T::kLayout);
  const uint64_t dk = smem_desc(k_tile, 16, 8 * T::kSwizzle, T::kLayout);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off =
        (16 * kk / T::kCols) * T::kAtomBytes + (16 * kk % T::kCols) * 2;
    wgmma_ss_n128(sc, dq + (off >> 4), dk + (off >> 4), kk > 0);
  }
}

// O += P·V for one key tile: 8 k-steps of m64n{HD}k16, P from
// registers, V MN-major (the caller fences and commits).
template <int HD>
__device__ __forceinline__ void pv_wgmma(float (&acc)[HD / 2],
                                         const uint32_t (&pf)[kBlockK / 4],
                                         uint32_t v_tile) {
  using T = Tile<HD>;
  const uint64_t dv =
      smem_desc(v_tile, T::kAtomBytes, 8 * T::kSwizzle, T::kLayout);
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    wgmma_rs(acc, pf + 4 * kk, dv + ((16 * kk * T::kSwizzle) >> 4));
  }
}

// 2^x, results below 2^-126 flushed to 0 (a P that small adds nothing
// next to the row's largest, which is 1).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one key tile's scores, in the log2 domain and in
// place: sc becomes P (float32), m the running max (of score x
// scale_log2), l this thread's share of the row sums, corr the factor
// the accumulator must be scaled by.  The row max is taken on the raw
// scores (scaling is monotonic) and P = 2^fma(s, scale_log2, -m): one
// rounding, which the plain version repeats.  Masked scores (the causal
// diagonal, kpos < S: only where `edge`) are -1e30 before scaling.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBlockK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool edge,
                                             int k0, int row0, int t, int S,
                                             int causal, float scale_log2) {
  // the last live key of each row, as a column of this thread's
  // fragment (8 i + e % 2) past 2 t
  int live_to[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    live_to[r] = (causal ? min(row0 + 8 * r, S - 1) : S - 1) - k0 - 2 * t;
  }
  float mx[2] = {kMask, kMask};
#pragma unroll
  for (int i = 0; i < kBlockK / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e / 2;
      if (edge && 8 * i + e % 2 > live_to[r]) sc[4 * i + e] = kMask;
      mx[r] = fmaxf(mx[r], sc[4 * i + e]);
    }
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], __fmul_rn(mx[r], scale_log2));
    corr[r] = exp2_ftz(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i) {
    const int r = (i / 2) % 2;
    sc[i] = exp2_ftz(__fmaf_rn(sc[i], scale_log2, neg_m[r]));
    l[r] += sc[i];
  }
}

// P (float32, accumulator layout) rounded to bf16 A fragments: pf[i]
// holds P 2i, 2i + 1, k-step i / 4, register i % 4.
__device__ __forceinline__ void pack_p(const float (&sc)[kBlockK / 2],
                                       uint32_t (&pf)[kBlockK / 4]) {
#pragma unroll
  for (int i = 0; i < kBlockK / 4; ++i) pf[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, Strides os,
                             int S, int H, int groups, int causal,
                             float scale_log2, int heads, int q_tiles) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t q_full = base + T::kBarriers;
  const uint32_t q_empty = q_full + 8;
  // stage s: K at k_tile(s), V at v_tile(s); its barriers after q_empty
  auto k_tile = [&](int s) { return base + (1 + s) * T::kBytes; };
  auto v_tile = [&](int s) { return base + (1 + kStages + s) * T::kBytes; };
  auto k_full = [&](int s) { return q_full + 8 * (2 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (2 + kStages + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (2 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (2 + 3 * kStages + s); };
  // the stage of the block's it-th K/V tile, and the parity of its round
  auto stage = [](int it) { return it % kStages; };
  auto parity = [](int it) { return static_cast<uint32_t>(it / kStages) & 1; };

  // Persistent: block x takes work tiles x, x + gridDim.x, ... of the
  // (query tile, batch·head) pairs, longest query tiles first.
  const int n_work = heads * q_tiles;
  struct Work {
    int b, h, q0, n_tiles;
  };
  auto work = [&](int w) {
    const int bh = w % heads;
    const int q0 = (q_tiles - 1 - w / heads) * kBlockQ;
    const int last = causal ? min(q0 + kBlockQ, S) : S;
    return Work{bh / H, bh % H, q0, (last + kBlockK - 1) / kBlockK};
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kThreads - 128);       // every consumer thread
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kThreads - 128);
      mbar_init(v_empty(s), kThreads - 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread starts every copy.  K and V of a
    // stage are released apart (K after S, V after P·V), so the next K
    // is in flight while the consumers still multiply by this V; the
    // next work tile's q as soon as its last S has read this one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;
      for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
        const Work job = work(w);
        const int kv = job.h / groups;
        mbar_wait(q_empty, (n & 1) ^ 1);          // round 0 passes
        load_tile<HD>(q_tile, &tq, q_full, job.h, job.q0, job.b);
        for (int j = 0; j < job.n_tiles; ++j, ++it) {
          const int s = stage(it);
          mbar_wait(k_empty(s), parity(it) ^ 1);
          load_tile<HD>(k_tile(s), &tk, k_full(s), kv, j * kBlockK, job.b);
          mbar_wait(v_empty(s), parity(it) ^ 1);
          load_tile<HD>(v_tile(s), &tv, v_full(s), kv, j * kBlockK, job.b);
        }
      }
    }
  } else {
    // consumer warpgroup c: query rows q0 + 64 c .. q0 + 64 c + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int c = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int t = lane % 4;
    const uint32_t q_rows = q_tile + 64 * c * T::kSwizzle;

    // Ping-pong: the two consumer warpgroups take turns starting their
    // products (named barrier 1 + c is warpgroup c's turn), so one's
    // softmax runs under the other's wgmma.  Warpgroup 0 goes first and
    // takes one turn more at the end, so every arrival is waited for.
    auto my_turn = [&] {
      asm volatile("bar.sync %0, 256;" ::"r"(1 + c) : "memory");
    };
    auto pass_turn = [&] {
      asm volatile("bar.arrive %0, 256;" ::"r"(2 - c) : "memory");
    };
    if (c == 1) pass_turn();

    float sc[kBlockK / 2];        // S, then P: 64 x 128 float32
    float acc[HD / 2];            // O: 64 x HD float32
    uint32_t pf[kBlockK / 4];     // P in bf16, the A fragments of P·V
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) sc[i] = 0.f;
    int it = 0;
    for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
      const Work job = work(w);
      const int nt = job.n_tiles;
      // this thread's rows (accumulator layout): row0 and row0 + 8
      const int row0 = job.q0 + 64 * c + 16 * warp + lane / 4;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      float m[2] = {kMask, kMask};
      float l[2] = {0.f, 0.f};    // this thread's share of each row's sum
      float corr[2];

      // key tile 0: S, softmax (the accumulator is still 0)
      mbar_wait(q_full, n & 1);
      mbar_wait(k_full(stage(it)), parity(it));
      my_turn();
      fence_regs(sc);
      wgmma_fence();
      scores_wgmma<HD>(sc, q_rows, k_tile(stage(it)));
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(k_empty(stage(it)));
      if (nt == 1) mbar_arrive(q_empty);
      softmax_tile(sc, m, l, corr, nt == 1, 0, row0, t, S, causal,
                   scale_log2);
      pack_p(sc, pf);
      // key tile j: S_j and P_{j-1}·V_{j-1} started together; the softmax
      // of S_j runs while the tensor cores finish P_{j-1}·V_{j-1}.
      // Nothing writes an in-flight product's registers: P_j stays
      // float32 in sc until P_{j-1}·V_{j-1} is in, then is rounded into pf.
      for (int j = 1; j < nt; ++j) {
        const int cur = it + j;
        const int prev = cur - 1;
        mbar_wait(k_full(stage(cur)), parity(cur));
        mbar_wait(v_full(stage(prev)), parity(prev));
        my_turn();
        fence_regs(sc);
        fence_regs(acc);
        fence_regs(pf);
        wgmma_fence();
        scores_wgmma<HD>(sc, q_rows, k_tile(stage(cur)));
        wgmma_commit();
        pv_wgmma<HD>(acc, pf, v_tile(stage(prev)));
        wgmma_commit();
        pass_turn();
        wgmma_wait<1>();          // S_j is in
        fence_regs(sc);
        mbar_arrive(k_empty(stage(cur)));
        if (j == nt - 1) mbar_arrive(q_empty);
        softmax_tile(sc, m, l, corr, j == nt - 1, j * kBlockK, row0, t, S,
                     causal, scale_log2);
        wgmma_wait<0>();          // P_{j-1}·V_{j-1} is in
        fence_regs(acc);
        fence_regs(pf);
        mbar_arrive(v_empty(stage(prev)));
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i / 2) % 2];
        pack_p(sc, pf);
      }
      const int final_tile = it + nt - 1;
      mbar_wait(v_full(stage(final_tile)), parity(final_tile));
      my_turn();
      fence_regs(acc);
      fence_regs(pf);
      wgmma_fence();
      pv_wgmma<HD>(acc, pf, v_tile(stage(final_tile)));
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pf);
      mbar_arrive(v_empty(stage(final_tile)));
      it += nt;

      // epilogue: acc / max(l, 1e-20), rounded to bf16, rows < S; the
      // producer is already loading the next work tile
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = __frcp_rn(fmaxf(l[r], 1e-20f));
      }
      __nv_bfloat16* ob = o + job.b * os.b + job.h * os.h + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = row0 + 8 * r;
        if (qpos < S) {
          __nv_bfloat16* orow = ob + qpos * os.s;
#pragma unroll
          for (int i = 0; i < HD / 8; ++i) {
            *reinterpret_cast<uint32_t*>(orow + 8 * i) =
                pack_bf16(__fmul_rn(acc[4 * i + 2 * r], l[r]),
                          __fmul_rn(acc[4 * i + 2 * r + 1], l[r]));
          }
        }
      }
    }
    if (c == 0) my_turn();        // warpgroup 1's last pass
  }
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime's entry-point
// query (so the library links no -lcuda); null where libcuda lacks it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D TMA map (hd, heads, S, B) of a bf16 operand over its strides
// (elements; the caller checks 16-byte alignment), one 128-row box of
// one atom's columns per copy.
template <int HD>
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
             const Strides& st) {
  using T = Tile<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {T::kCols, 1, kBlockK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, const Strides& qs, const Strides& ks,
           const Strides& vs, const Strides& os, int causal, float scale,
           int device, cudaStream_t stream) {
  const long long q_tiles = (S + kBlockQ - 1) / kBlockQ;
  const long long heads = static_cast<long long>(B) * H;
  // o takes 4-byte (bf16 pair) stores
  if (heads * q_tiles > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(o) % 4 != 0 ||
      ((os.b | os.s | os.h) & 1) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv;
  int err = make_map<HD>(&tq, q, B, S, H, qs);
  if (err == 0) err = make_map<HD>(&tk, k, B, S, KV, ks);
  if (err == 0) err = make_map<HD>(&tv, v, B, S, KV, vs);
  if (err != 0) return err;
  const size_t smem = Tile<HD>::kSmem;
  auto* kernel = flash_attention_kernel_wgmma<HD>;
  cudaError_t attr = cudaSuccess;
  err = gf::on_device(device, [&] {
    int sms = 0;
    attr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
    if (attr != cudaSuccess) return;
    attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return;
    // one block per SM (the shared memory admits no second)
    const long long blocks = std::min<long long>(heads * q_tiles, sms);
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), os, S, H, H / KV, causal,
        scale * kLog2e, static_cast<int>(heads), static_cast<int>(q_tiles));
  });
  return attr != cudaSuccess ? static_cast<int>(attr) : err;
}

}  // namespace hopper

// f(std::integral_constant<int, hd>) for each head_dim of the instances
template <typename F>
int by_head_dim(int hd, F&& f) {
  switch (hd) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32 (CUDA-core kernel), 1 bfloat16 (tensor-core kernel;
// q, k, v 16-byte aligned with strides of multiples of 8 elements).
// Strides in elements.  Returns 0 or the CUDA error of the launch (a
// refused launch never runs).
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
    return by_head_dim(hd, [&](auto HD) {
      return launch<decltype(HD)::value, float>(q, k, v, o, B, S, H, KV, qs,
                                                ks, vs, os, causal, scale,
                                                device, st);
    });
  }
  if (dtype == 1) {
    return by_head_dim(hd, [&](auto HD) {
      return hopper::launch<decltype(HD)::value>(q, k, v, o, B, S, H, KV, qs,
                                                 ks, vs, os, causal, scale,
                                                 device, st);
    });
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
