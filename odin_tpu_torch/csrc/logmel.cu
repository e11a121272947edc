// K1: fused window-DFT-power-mel-log over tiles of frames, for sm_90a.
//
// Replaces `_logmel_kernel` (odin_tpu/ops/pallas_features.py:32-39, launched
// by `logmel_pallas`).  For each windowed frame f (frame_length samples):
//   re = f . cos,  im = f . sin          (frame_length x n_freqs real DFT)
//   power = (re^2 + im^2) * scale_sq
//   out = 10 log10(max(power . mel_t, 1e-10))   (unclipped; top-dB is outside)
// all in fp32.  The power spectrum lives in shared memory only.
//
// Bound on an H100 SXM at the main path's size (64 utterances x 4 s, N =
// 25,472 frames of 400 samples, 257 bins, 40 mels).  The function needs
// the frames in, the filter bank in and the mels out, about 44.9 MB, or
// 0.013 ms at 3.35 TB/s.  Its operations are far fewer: a 512-point real
// FFT (about 11.5k flop a frame), the power and the mel product over the
// filters' 486 nonzero weights come to about 3.4e8 flop, 0.005 ms at
// 67 TFLOP/s fp32.  So the function is bound by bytes, at about 0.013 ms.
// This kernel's algorithm, a dense real DFT, does N * 2*400*257*2 = 1.05e10
// flop, whose own bound is 0.157 ms.  On the card measured so far (NVIDIA
// H100 80GB HBM3, 700 W power limit) this design takes about 0.49 ms, over
// 30 times the function's bound; the times are in PERF.md.  Closing that
// gap needs another algorithm (an FFT in shared memory), not a faster DFT;
// it is left for later work.
//
// Design: one block of 12 warps per tile of 32 frames, staged in shared
// memory.  The warps form a 4 x 3 grid: a warp owns 8 frames and 96 bins
// (lane + 32 j, j < 3), so a thread keeps 48 fp32 accumulators (8 frames x 3
// bins x re, im).  For two samples it reads 8 float2 frame values (each a
// shared-memory broadcast) and 12 cos/sin values, for 96 FMAs.  The DFT
// bases come in the kernel's own layout (`odin_logmel_bases_layout`): the
// samples padded to a multiple of kChunk and the bins to kMaxFreqs, both with
// zeros, cos then sin in each sample row.  So every chunk of kChunk sample
// rows is one contiguous run, copied into shared memory with cp.async while
// the block works on the previous chunk (double buffer, 88 KB a block).  The
// power rows then overwrite the frame tile, and the mel product runs over
// each filter's nonzero band only (`bands`, exact: the skipped weights are
// 0), followed by the log.  The ragged last tile is masked here, not padded
// by the caller.  Plain fp32 FMAs hold 0.01 dB.
#include <cuda_runtime.h>

namespace {

constexpr int kFrameGroups = 4;  // warps along the frames of a tile
constexpr int kBinGroups = 3;    // warps along the bins
constexpr int kThreads = 32 * kFrameGroups * kBinGroups;
constexpr int kFramesPerWarp = 8;
constexpr int kTileFrames = kFrameGroups * kFramesPerWarp;
constexpr int kBinsPerLane = 3;
constexpr int kMaxFreqs = kBinGroups * 32 * kBinsPerLane;  // 288: n_fft <= 574
constexpr int kRow = 2 * kMaxFreqs;  // floats of one sample row of the bases
constexpr int kChunk = 8;            // sample rows per staged chunk

__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src));
}

__device__ __forceinline__ void stage_chunk(float* dst, const float* src) {
  for (int i = threadIdx.x; i < kChunk * kRow / 4; i += kThreads) {
    copy16_async(dst + 4 * i, src + 4 * i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads, 2) logmel_kernel(
    const float* __restrict__ frames,  // (n, frame_length)
    const float* __restrict__ bases,   // (padded, 2, kMaxFreqs): cos, sin
    const float* __restrict__ mel_t,   // (n_freqs, n_mels)
    const int2* __restrict__ bands,    // (n_mels): nonzero rows [x, y) of mel_t
    float* __restrict__ out,           // (n, n_mels)
    int n, int frame_length, int n_freqs, int n_mels, float scale_sq) {
  extern __shared__ float smem[];
  float* staged = smem;                    // 2 x kChunk x kRow
  float* tile = smem + 2 * kChunk * kRow;  // kTileFrames x max(padded, n_freqs)
  const int padded = (frame_length + kChunk - 1) / kChunk * kChunk;
  const int n_chunks = padded / kChunk;
  const int first = blockIdx.x * kTileFrames;
  const int rows = min(kTileFrames, n - first);
  stage_chunk(staged, bases);
  const float* src = frames + static_cast<size_t>(first) * frame_length;
  for (int i = threadIdx.x; i < kTileFrames * padded; i += kThreads) {
    const int f = i / padded;
    const int t = i - f * padded;
    tile[i] = f < rows && t < frame_length ? src[f * frame_length + t] : 0.0f;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int f0 = (warp % kFrameGroups) * kFramesPerWarp;
  const int b0 = (warp / kFrameGroups) * 32 * kBinsPerLane + lane;
  float re[kFramesPerWarp][kBinsPerLane];
  float im[kFramesPerWarp][kBinsPerLane];
#pragma unroll
  for (int i = 0; i < kFramesPerWarp; ++i) {
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) {
      re[i][j] = 0.0f;
      im[i][j] = 0.0f;
    }
  }
  const float* xrow = tile + f0 * padded;
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      stage_chunk(staged + ((c + 1) & 1) * kChunk * kRow,
                  bases + static_cast<size_t>(c + 1) * kChunk * kRow);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // chunk c (and, at c = 0, the frame tile) is in place
    const float* chunk = staged + (c & 1) * kChunk * kRow;
    // not unrolled: unrolling the pairs of samples spills registers at the
    // 2 blocks per SM that __launch_bounds__ asks for
#pragma unroll 1
    for (int r = 0; r < kChunk; r += 2) {
      float2 x[kFramesPerWarp];
#pragma unroll
      for (int i = 0; i < kFramesPerWarp; ++i) {
        x[i] = *reinterpret_cast<const float2*>(xrow + i * padded +
                                                c * kChunk + r);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* crow = chunk + (r + u) * kRow;
#pragma unroll
        for (int j = 0; j < kBinsPerLane; ++j) {
          const float cv = crow[b0 + 32 * j];
          const float sv = crow[kMaxFreqs + b0 + 32 * j];
#pragma unroll
          for (int i = 0; i < kFramesPerWarp; ++i) {
            const float xv = u == 0 ? x[i].x : x[i].y;
            re[i][j] = fmaf(xv, cv, re[i][j]);
            im[i][j] = fmaf(xv, sv, im[i][j]);
          }
        }
      }
    }
    __syncthreads();  // chunk c is read before its buffer is staged again
  }

  float* power = tile;  // (kTileFrames, n_freqs): the frame tile is done
#pragma unroll
  for (int i = 0; i < kFramesPerWarp; ++i) {
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) {
      const int k = b0 + 32 * j;
      if (k < n_freqs) {
        power[(f0 + i) * n_freqs + k] =
            (re[i][j] * re[i][j] + im[i][j] * im[i][j]) * scale_sq;
      }
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < rows * n_mels; idx += kThreads) {
    const int f = idx / n_mels;
    const int m = idx - f * n_mels;
    const int2 band = __ldg(bands + m);
    const float* p = power + f * n_freqs;
    float acc = 0.0f;
    for (int k = band.x; k < band.y; ++k) {
      acc = fmaf(p[k], __ldg(mel_t + k * n_mels + m), acc);
    }
    out[static_cast<size_t>(first + f) * n_mels + m] =
        10.0f * log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// The layout of `bases`: (ceil(frame_length / chunk) * chunk, 2, max_freqs)
// fp32, 16-byte aligned; row t holds cos then sin of sample t, zero past
// n_freqs, and the padded rows are zero.
extern "C" void odin_logmel_bases_layout(int* chunk, int* max_freqs) {
  *chunk = kChunk;
  *max_freqs = kMaxFreqs;
}

// Launches K1 on `stream`.  Allocates nothing and does not synchronise.
// Returns 0, or the CUDA error of the launch (cudaGetLastError()).
extern "C" int odin_logmel(const void* frames, const void* bases,
                           const void* mel_t, const void* bands, void* out,
                           int n, int frame_length, int n_freqs, int n_mels,
                           float scale_sq, void* stream) {
  if (n_freqs > kMaxFreqs || n <= 0 || frame_length <= 0 || n_mels <= 0 ||
      reinterpret_cast<size_t>(bases) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int padded = (frame_length + kChunk - 1) / kChunk * kChunk;
  const int cols = padded > n_freqs ? padded : n_freqs;
  const size_t smem = sizeof(float) * (2 * kChunk * kRow + kTileFrames * cols);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int blocks = (n + kTileFrames - 1) / kTileFrames;
  logmel_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(bases),
      static_cast<const float*>(mel_t), static_cast<const int2*>(bands),
      static_cast<float*>(out), n, frame_length, n_freqs, n_mels, scale_sq);
  return static_cast<int>(cudaGetLastError());
}
