// K2: flash attention forward, softmax(Q K^T * scale) V, for sm_90a, fp32.
//
// Replaces `_flash_kernel` (odin_tpu/ops/pallas_attention.py:35, launched by
// `_flash_forward`) for float32 q, k and v; bfloat16 and float16 take the
// tensor-core kernel in flash_attention_mma.cu.  For each (batch, head) and
// query row i:
//   s_ij = (q_i . k_j) * scale            for the valid keys j
//   o_i  = sum_j exp(s_ij - m_i) v_j / sum_j exp(s_ij - m_i)
// with the row max m_i, the row sum and the output accumulator carried in
// fp32 across the key tiles (online softmax), so the (Tq, Tk) score matrix
// never leaves the block.  A key j is valid when j < Tk and, under `causal`,
// when i >= j (top-left alignment, as in the TPU kernel).  A row with no
// valid key gives 0.
//
// Bound on an H100 SXM at the repo's benchmark width (B 4, H 8, T 4096,
// D 64, fp32): the two products are 4 B H Tq Tk D = 1.37e11 flop, 2.05 ms at
// 67 TFLOP/s of fp32 outside the tensor cores, against 134 MB of q, k, v and
// o, 0.04 ms at 3.35 TB/s.  So the kernel is bound by operations.  The fp32
// result has to hold 2e-5 against the plain version, which TF32 tensor cores
// (10-bit mantissa) cannot promise, so both products are plain fp32 FMAs.
//
// Design: one block of 8 warps owns a tile of 128 queries of one (batch,
// head) and loops over the key tiles of 64 itself: Hopper's blocks run in
// no order, so the sequential grid axis that carried the TPU kernel's VMEM
// scratch becomes this loop.  Q is staged once in shared memory, transposed
// (d-major), K transposed and V as it is for each key tile; the head dim is
// padded with zeros to DP (32, 64 or 128), a template argument, and ragged
// Tq and Tk are masked here, so the caller pads nothing.  Above 128 a launch
// covers one 128-wide chunk of V's and O's columns (the caller launches once
// per chunk), and takes the scores over D in 128-wide chunks of Q and K
// staged in turn; each launch computes the scores anew.  A thread issues
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

// Rows [row0, row0 + kRows) of a row-major matrix with row stride `ld`
// into shared memory, zero past n_rows and past its first `ncols` columns:
// transposed, dst[d * kStrideT + r] (kStrideT > 0), or as they are,
// dst[r * DP + d].  A thread issues kBatch loads before it stores them, so
// it waits for device memory once per batch (once per K or V tile at
// DP <= 64).
template <int DP, int kRows, int kStrideT>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src,
                                      int row0, int n_rows, int ld,
                                      int ncols) {
  constexpr int kPerThread = kRows * DP / kThreads;
  constexpr int kBatch = kPerThread < 16 ? kPerThread : 16;
  static_assert(kPerThread % kBatch == 0, "whole batches");
  const int rows = min(kRows, n_rows - row0);
  const float* base = src + static_cast<size_t>(row0) * ld;
#pragma unroll 1
  for (int n0 = 0; n0 < kPerThread; n0 += kBatch) {
    float x[kBatch];
#pragma unroll
    for (int n = 0; n < kBatch; ++n) {
      const int e = threadIdx.x + (n0 + n) * kThreads;
      const int r = e / DP;
      const int d = e % DP;
      x[n] = r < rows && d < ncols ? base[r * ld + d] : 0.0f;
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

template <int DP, bool kChunked>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 2 : 1) flash_kernel(
    const float* __restrict__ q,  // (BH, Tq, D)
    const float* __restrict__ k,  // (BH, Tk, D)
    const float* __restrict__ v,  // (BH, Tk, D), from this launch's column
    float* __restrict__ o,        // (BH, Tq, D), from this launch's column
    int n_q_tiles, int Tq, int Tk, int D, int Dv, float scale_log2e,
    int causal) {
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

  if (!kChunked) {
    stage<DP, kBlockQ, kQStride>(qT, q, q0, Tq, D, D);
  }

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
    if (!kChunked) {
      stage<DP, kBlockK, kKStride>(kT, k, k0, Tk, D, D);
    }
    stage<DP, kBlockK, 0>(vs, v, k0, Tk, D, Dv);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = 0.0f;
      }
    }
    // the scores over D in DP-wide chunks of Q and K, staged in turn
    for (int c0 = 0; c0 < (kChunked ? D : 1); c0 += DP) {
      if (kChunked) {
        if (c0 > 0) {
          __syncthreads();  // the previous chunk is read
        }
        stage<DP, kBlockQ, kQStride>(qT, q + c0, q0, Tq, D, D - c0);
        stage<DP, kBlockK, kKStride>(kT, k + c0, k0, Tk, D, D - c0);
        __syncthreads();
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
        if (d < Dv) {
          o[static_cast<size_t>(qi) * D + d] =
              l[i] > 0.0f ? acc[i][c] / l[i] : 0.0f;
        }
      }
    }
  }
}

template <int DP, bool kChunked>
int launch(const float* q, const float* k, const float* v, float* o, int bh,
           int Tq, int Tk, int D, int Dv, float scale_log2e, int causal,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DP, kChunked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int n_q_tiles = (Tq + kBlockQ - 1) / kBlockQ;
  flash_kernel<DP, kChunked><<<n_q_tiles * bh, kThreads, smem, stream>>>(
      q, k, v, o, n_q_tiles, Tq, Tk, D, Dv, scale_log2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The widest head dim one launch covers; above it the caller launches once
// per chunk of this many columns.
extern "C" int odin_flash_attention_max_dim() { return kMaxDim; }

// Launches the fp32 K2 on `stream` over contiguous (bh, Tq, D) q and o and
// (bh, Tk, D) k and v, all fp32 (dtype 0), for the columns
// [col0, col0 + max_dim) of v and o: col0 is 0 where D <= max_dim, else a
// multiple of max_dim below D.  Allocates nothing and does not synchronise.
// Returns 0, or the CUDA error of the launch (cudaGetLastError()).
extern "C" int odin_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int bh, int Tq,
                                    int Tk, int D, int col0, float sm_scale,
                                    int causal, int dtype, void* stream) {
  if (bh <= 0 || Tq <= 0 || Tk < 0 || D <= 0 || col0 < 0 || col0 >= D ||
      col0 % kMaxDim != 0 || dtype != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Dv = D - col0 < kMaxDim ? D - col0 : kMaxDim;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vc = static_cast<const float*>(v) + col0;
  float* oc = static_cast<float*>(o) + col0;
  const float scale_log2e = sm_scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) {
    return launch<32, false>(qf, kf, vc, oc, bh, Tq, Tk, D, Dv, scale_log2e,
                             causal, s);
  }
  if (D <= 64) {
    return launch<64, false>(qf, kf, vc, oc, bh, Tq, Tk, D, Dv, scale_log2e,
                             causal, s);
  }
  if (D <= kMaxDim) {
    return launch<128, false>(qf, kf, vc, oc, bh, Tq, Tk, D, Dv, scale_log2e,
                              causal, s);
  }
  return launch<128, true>(qf, kf, vc, oc, bh, Tq, Tk, D, Dv, scale_log2e,
                           causal, s);
}
