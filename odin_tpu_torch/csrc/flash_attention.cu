// K2: flash attention forward, softmax(Q K^T * scale) V, for sm_90a.
//
// Replaces `_flash_kernel` (odin_tpu/ops/pallas_attention.py:35, launched by
// `_flash_forward`).  For each (batch, head) and query row i:
//   s_ij = (q_i . k_j) * scale            for the valid keys j
//   o_i  = sum_j exp(s_ij - m_i) v_j / sum_j exp(s_ij - m_i)
// with the row max m_i, the row sum and the output accumulator carried in
// fp32 across the key tiles (online softmax), so the (Tq, Tk) score matrix
// never leaves the block.  A key j is valid when j < Tk and, under `causal`,
// when i >= j (top-left alignment, as in the TPU kernel).  A row with no
// valid key gives 0.  Inputs are fp32 or bf16; the arithmetic is fp32 and
// the output has the inputs' type.
//
// Bound on an H100 SXM at the repo's benchmark width (B 4, H 8, T 4096,
// D 64, fp32): the two products are 4 B H Tq Tk D = 1.37e11 flop, 2.05 ms at
// 67 TFLOP/s of fp32 outside the tensor cores, against 134 MB of q, k, v and
// o, 0.04 ms at 3.35 TB/s.  So the kernel is bound by operations.  The fp32
// result has to hold 2e-5 against the plain version, which TF32 tensor cores
// (10-bit mantissa) cannot promise, so both products are plain fp32 FMAs
// here; bf16 inputs are widened to fp32 as they are staged and take the same
// path.  Tensor cores for bf16 are left for later work.
//
// Design: one block of 8 warps owns a tile of 128 queries of one (batch,
// head) and loops over the key tiles of 64 itself: Hopper's blocks run in
// no order, so the sequential grid axis that carried the TPU kernel's VMEM
// scratch becomes this loop.  Q is staged once in shared memory, transposed
// (d-major), K transposed and V as it is for each key tile; the head dim is
// padded with zeros to DP (32, 64 or 128), a template argument, and ragged
// Tq and Tk are masked here, so the caller pads nothing.  A thread issues
// its loads of a tile before it stores any, so it waits for device memory
// about once per tile.  Thread (rg, cg) owns query rows 4 rg .. 4 rg + 3
// and key columns 4 cg + {0..3} and 32 + 4 cg + {0..3} of the score tile:
// per step of d it reads one float4 of Q and two of K for 32 FMAs.  The 8
// threads that share a row are 8 neighbouring lanes, so the row max and row
// sum are 3 shuffles each.  P goes through shared memory (transposed) into
// the product with V, where the same thread owns the same 4 rows and DP / 8
// output columns, so m, l and the accumulator stay in registers.  At DP 64
// a block takes 101 KB of shared memory and at most 128 registers a
// thread, so two blocks (16 warps) share an SM.  The exponentials are exp2
// of scores prescaled by scale * log2(e).  Under `causal` the loop stops at
// the last key tile that meets the diagonal of the block's last valid row.
// The row max starts at -inf; a row whose keys so far are all masked keeps
// m = -inf, and its exponentials are taken against 0, so no -inf - (-inf)
// appears.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kBlockQ = 128;            // queries per block
constexpr int kBlockK = 64;             // keys per tile
constexpr int kThreads = 256;           // 32 row groups x 8 column groups
constexpr int kQStride = kBlockQ + 4;   // floats per row of qT and pT
constexpr int kKStride = kBlockK + 4;   // floats per row of kT
constexpr int kMaxDim = 128;
static_assert(kThreads == 8 * kBlockQ / 4, "a thread owns 4 query rows");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [row0, row0 + kRows) of a (n_rows, D) row-major matrix into shared
// memory as fp32, zero past n_rows and past D: transposed,
// dst[d * kStrideT + r] (kStrideT > 0), or as they are, dst[r * DP + d].
// A thread issues kBatch loads before it stores them, so it waits for
// device memory once per batch (once per K or V tile at DP <= 64).
template <int DP, int kRows, int kStrideT, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int row0, int n_rows, int D) {
  constexpr int kPerThread = kRows * DP / kThreads;
  constexpr int kBatch = kPerThread < 16 ? kPerThread : 16;
  static_assert(kPerThread % kBatch == 0, "whole batches");
  const int rows = min(kRows, n_rows - row0);
  const T* base = src + static_cast<size_t>(row0) * D;
#pragma unroll 1
  for (int n0 = 0; n0 < kPerThread; n0 += kBatch) {
    float x[kBatch];
#pragma unroll
    for (int n = 0; n < kBatch; ++n) {
      const int e = threadIdx.x + (n0 + n) * kThreads;
      const int r = e / DP;
      const int d = e % DP;
      x[n] = r < rows && d < D ? widen(base[r * D + d]) : 0.0f;
    }
#pragma unroll
    for (int n = 0; n < kBatch; ++n) {
      const int e = threadIdx.x + (n0 + n) * kThreads;
      if (kStrideT > 0) {
        dst[(e % DP) * kStrideT + e / DP] = x[n];
      } else {
        dst[e] = x[n];
      }
    }
  }
}

template <int DP>
__host__ __device__ constexpr int smem_floats() {
  return DP * kQStride + DP * kKStride + kBlockK * DP + kBlockK * kQStride;
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 2 : 1) flash_kernel(
    const T* __restrict__ q,  // (BH, Tq, D)
    const T* __restrict__ k,  // (BH, Tk, D)
    const T* __restrict__ v,  // (BH, Tk, D)
    T* __restrict__ o,        // (BH, Tq, D)
    int n_q_tiles, int Tq, int Tk, int D, float scale_log2e, int causal) {
  constexpr int kCols = DP / 8;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qT = smem;                 // DP x kQStride
  float* kT = qT + DP * kQStride;   // DP x kKStride
  float* vs = kT + DP * kKStride;   // kBlockK x DP
  float* pT = vs + kBlockK * DP;    // kBlockK x kQStride

  const int bh = blockIdx.x / n_q_tiles;
  const int q0 = (blockIdx.x % n_q_tiles) * kBlockQ;
  q += static_cast<size_t>(bh) * Tq * D;
  k += static_cast<size_t>(bh) * Tk * D;
  v += static_cast<size_t>(bh) * Tk * D;
  o += static_cast<size_t>(bh) * Tq * D;
  const int rg = threadIdx.x / 8;  // rows 4 rg .. 4 rg + 3
  const int cg = threadIdx.x % 8;  // a row's 8 threads are neighbouring lanes

  stage<DP, kBlockQ, kQStride>(qT, q, q0, Tq, D);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      acc[i][c] = 0.0f;
    }
  }

  const int last_q = min(q0 + kBlockQ, Tq) - 1;
  int n_k_tiles = (Tk + kBlockK - 1) / kBlockK;
  if (causal) {
    n_k_tiles = min(n_k_tiles, last_q / kBlockK + 1);
  }
  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's kT, vs and pT are read
    stage<DP, kBlockK, kKStride>(kT, k, k0, Tk, D);
    stage<DP, kBlockK, 0>(vs, v, k0, Tk, D);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = 0.0f;
      }
    }
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * kQStride +
                                                        4 * rg);
      const float4 b0 = *reinterpret_cast<const float4*>(kT + d * kKStride +
                                                         4 * cg);
      const float4 b1 = *reinterpret_cast<const float4*>(kT + d * kKStride +
                                                         32 + 4 * cg);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        }
      }
    }

    // mask, then the online softmax in base 2
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * rg + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + (j < 4 ? 4 * cg + j : 32 + 4 * cg + j - 4);
        const bool valid = kj < Tk && (!causal || qi >= kj);
        s[i][j] = valid ? s[i][j] * scale_log2e : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = exp2f(s[i][j] - m_use);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acc[i][c] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j < 4 ? 4 * cg + j : 32 + 4 * cg + j - 4;
      *reinterpret_cast<float4*>(pT + col * kQStride + 4 * rg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc += P V over this tile's keys
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(pT + kk * kQStride +
                                                        4 * rg);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int c4 = 0; c4 < DP / 32; ++c4) {
        const float4 b = *reinterpret_cast<const float4*>(vs + kk * DP +
                                                          32 * c4 + 4 * cg);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][4 * c4 + j] = fmaf(av[i], bv[j], acc[i][4 * c4 + j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * rg + i;
    if (qi < Tq) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = 32 * (c / 4) + 4 * cg + c % 4;
        if (d < D) {
          narrow(o + static_cast<size_t>(qi) * D + d,
                 l[i] > 0.0f ? acc[i][c] / l[i] : 0.0f);
        }
      }
    }
  }
}

template <int DP, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int Tq, int Tk, int D, float scale_log2e, int causal,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int n_q_tiles = (Tq + kBlockQ - 1) / kBlockQ;
  flash_kernel<DP, T><<<n_q_tiles * bh, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n_q_tiles, Tq, Tk, D,
      scale_log2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int Tq, int Tk, int D, float scale_log2e, int causal,
             cudaStream_t stream) {
  if (D <= 32) {
    return launch<32, T>(q, k, v, o, bh, Tq, Tk, D, scale_log2e, causal,
                         stream);
  }
  if (D <= 64) {
    return launch<64, T>(q, k, v, o, bh, Tq, Tk, D, scale_log2e, causal,
                         stream);
  }
  return launch<128, T>(q, k, v, o, bh, Tq, Tk, D, scale_log2e, causal,
                        stream);
}

}  // namespace

// The largest head dim the kernel takes.
extern "C" int odin_flash_attention_max_dim() { return kMaxDim; }

// Launches K2 on `stream` over contiguous (bh, Tq, D) q and o and (bh, Tk, D)
// k and v, all fp32 (dtype 0) or all bf16 (dtype 1).  Allocates nothing and
// does not synchronise.  Returns 0, or the CUDA error of the launch
// (cudaGetLastError()).
extern "C" int odin_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int bh, int Tq,
                                    int Tk, int D, float sm_scale, int causal,
                                    int dtype, void* stream) {
  if (bh <= 0 || Tq <= 0 || Tk < 0 || D <= 0 || D > kMaxDim ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale_log2e = sm_scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? dispatch<float>(q, k, v, o, bh, Tq, Tk, D, scale_log2e,
                               causal, s)
             : dispatch<__nv_bfloat16>(q, k, v, o, bh, Tq, Tk, D,
                                       scale_log2e, causal, s);
}
