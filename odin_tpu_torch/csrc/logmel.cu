// K1: fused window-DFT-power-mel-log over tiles of frames, for sm_90a.
//
// Replaces `_logmel_kernel` (odin_tpu/ops/pallas_features.py:32-39, launched
// by `logmel_pallas`) where n_fft is not a power of two from 16 to 8192;
// logmel_fft.cu, an FFT in shared memory, takes those (`kernel_route`,
// ops/logmel.py).  For each windowed frame f (frame_length samples):
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
// gap needs another algorithm, not a faster DFT: logmel_fft.cu.
//
// Design: one block of 12 warps per tile of 32 frames, staged in shared
// memory.  The warps form a 4 x 3 grid: a warp owns 8 frames and 96 bins
// (lane + 32 j, j < 3), so a thread keeps 48 fp32 accumulators (8 frames x 3
// bins x re, im).  For two samples it reads 8 float2 frame values (each a
// shared-memory broadcast) and 12 cos/sin values, for 96 FMAs.  The DFT
// bases come in the kernel's own layout (`odin_logmel_bases_layout`): one
// block of rows for each group of kMaxFreqs bins, the samples padded to a
// multiple of kChunk, each sample row holding cos then sin of the group's
// bins, padded with zeros.  So every chunk of kChunk sample rows of a group
// is one contiguous run, copied into shared memory with cp.async while the
// block works on the previous chunk (double buffer, 88 KB a block at the
// speech path's size).  The power rows then overwrite
// the frame tile, and the mel product runs over each filter's nonzero band
// only (`bands`, exact: the skipped weights are 0), followed by the log.
// Above kMaxFreqs bins (n_fft > 574) the block runs the DFT once per group
// of kMaxFreqs bins, adding each group's share of the mel product to sums
// kept in shared memory; where a tile of whole frames does not fit in
// shared memory (frame_length above about 1,400 with two bin groups), the
// frames are staged in segments of `seg` samples.  The ragged last tile is
// masked here, not padded by the caller.  Plain fp32 FMAs hold 0.01 dB.
#include <cuda_runtime.h>

namespace {

constexpr int kFrameGroups = 4;  // warps along the frames of a tile
constexpr int kBinGroups = 3;    // warps along the bins
constexpr int kThreads = 32 * kFrameGroups * kBinGroups;
constexpr int kFramesPerWarp = 8;
constexpr int kTileFrames = kFrameGroups * kFramesPerWarp;
constexpr int kBinsPerLane = 3;
constexpr int kMaxFreqs = kBinGroups * 32 * kBinsPerLane;  // 288 bins a group
constexpr int kRow = 2 * kMaxFreqs;  // floats of one staged sample row
constexpr int kChunk = 8;            // sample rows per staged chunk
constexpr int kSmemBytes = 232448;   // shared memory a block may use

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

// kGrouped: more than one group of bins, or frames in more than one
// segment; without it the loops over both run once, at compile time, which
// keeps the speech path's code as it was before they existed
template <bool kGrouped>
__global__ void __launch_bounds__(kThreads, 2) logmel_kernel(
    const float* __restrict__ frames,  // (n, frame_length)
    const float* __restrict__ bases,   // (groups, padded, 2, kMaxFreqs)
    const float* __restrict__ mel_t,   // (n_freqs, n_mels)
    const int2* __restrict__ bands,    // (n_mels): nonzero rows [x, y) of mel_t
    float* __restrict__ out,           // (n, n_mels)
    int n, int frame_length, int n_freqs, int n_mels, float scale_sq,
    int seg) {
  extern __shared__ float smem[];
  const int padded = (frame_length + kChunk - 1) / kChunk * kChunk;
  const int n_groups = kGrouped ? (n_freqs + kMaxFreqs - 1) / kMaxFreqs : 1;
  const int cols = max(seg, min(n_freqs, kMaxFreqs));
  float* staged = smem;                    // 2 x kChunk x kRow
  float* tile = smem + 2 * kChunk * kRow;  // kTileFrames x cols
  float* mel_sums = tile + kTileFrames * cols;  // kTileFrames x n_mels
  const int first = blockIdx.x * kTileFrames;
  const int rows = min(kTileFrames, n - first);
  const float* src = frames + static_cast<size_t>(first) * frame_length;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int f0 = (warp % kFrameGroups) * kFramesPerWarp;
  const int b0 = (warp / kFrameGroups) * 32 * kBinsPerLane + lane;
  // the frame samples in segments of `seg`: one, at compile time, without
  // kGrouped
  const int t_end = kGrouped ? padded : 1;
  const int t_step = kGrouped ? seg : 1;
  for (int group = 0; group < n_groups; ++group) {
    const int bin0 = group * kMaxFreqs;
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
    for (int t0 = 0; t0 < t_end; t0 += t_step) {
      const int len = kGrouped ? min(seg, padded - t0) : padded;
      const int n_chunks = len / kChunk;
      const float* chunk_src =
          bases + (static_cast<size_t>(group) * padded + t0) * kRow;
      // the tile and both buffers are free: the last chunk loop and the
      // last group's mel sums end with a barrier
      stage_chunk(staged, chunk_src);
      for (int i = threadIdx.x; i < kTileFrames * len; i += kThreads) {
        const int f = i / len;
        const int t = i - f * len;
        tile[i] = f < rows && t0 + t < frame_length
                      ? src[f * frame_length + t0 + t]
                      : 0.0f;
      }
      const float* xrow = tile + f0 * len;
      for (int c = 0; c < n_chunks; ++c) {
        if (c + 1 < n_chunks) {
          stage_chunk(staged + ((c + 1) & 1) * kChunk * kRow,
                      chunk_src + (c + 1) * kChunk * kRow);
          asm volatile("cp.async.wait_group 1;\n" ::);
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::);
        }
        __syncthreads();  // chunk c (and, at c = 0, the frame tile) is in
        const float* chunk = staged + (c & 1) * kChunk * kRow;
        // not unrolled: unrolling the pairs of samples spills registers at
        // the 2 blocks per SM that __launch_bounds__ asks for
#pragma unroll 1
        for (int r = 0; r < kChunk; r += 2) {
          float2 x[kFramesPerWarp];
#pragma unroll
          for (int i = 0; i < kFramesPerWarp; ++i) {
            x[i] = *reinterpret_cast<const float2*>(xrow + i * len +
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
    }

    // this group's power rows overwrite the frame tile, which is done
    const int nb = min(kMaxFreqs, n_freqs - bin0);
    float* power = tile;  // (kTileFrames, nb)
#pragma unroll
    for (int i = 0; i < kFramesPerWarp; ++i) {
#pragma unroll
      for (int j = 0; j < kBinsPerLane; ++j) {
        const int k = b0 + 32 * j;
        if (k < nb) {
          power[(f0 + i) * nb + k] =
              (re[i][j] * re[i][j] + im[i][j] * im[i][j]) * scale_sq;
        }
      }
    }
    __syncthreads();

    // the group's share of the mel product; a thread keeps the same
    // (frame, mel) entries in every group
    const bool last = !kGrouped || group + 1 == n_groups;
    for (int idx = threadIdx.x; idx < rows * n_mels; idx += kThreads) {
      const int f = idx / n_mels;
      const int m = idx - f * n_mels;
      const int2 band = __ldg(bands + m);
      const int lo = max(band.x, bin0);
      const int hi = min(band.y, bin0 + nb);
      const float* p = power + f * nb - bin0;
      float acc = group == 0 ? 0.0f : mel_sums[idx];
      for (int k = lo; k < hi; ++k) {
        acc = fmaf(p[k], __ldg(mel_t + k * n_mels + m), acc);
      }
      if (last) {
        out[static_cast<size_t>(first + f) * n_mels + m] =
            10.0f * log10f(fmaxf(acc, 1e-10f));
      } else {
        mel_sums[idx] = acc;
      }
    }
    if (!last) {
      __syncthreads();  // the power rows are read before the next tile
    }
  }
}

}  // namespace

// The layout of `bases`: (ceil(n_freqs / max_freqs),
// ceil(frame_length / chunk) * chunk, 2, max_freqs) fp32, 16-byte aligned;
// row t of group g holds cos then sin of sample t at the bins
// g * max_freqs + (0 .. max_freqs - 1), zero past n_freqs, and the padded
// rows are zero.  `tile_frames` frames share a block.
extern "C" void odin_logmel_bases_layout(int* chunk, int* max_freqs,
                                         int* tile_frames) {
  *chunk = kChunk;
  *max_freqs = kMaxFreqs;
  *tile_frames = kTileFrames;
}

// Launches K1 on `stream`.  Allocates nothing and does not synchronise.
// Returns 0, or the CUDA error of the launch (cudaGetLastError()).
extern "C" int odin_logmel(const void* frames, const void* bases,
                           const void* mel_t, const void* bands, void* out,
                           int n, int frame_length, int n_freqs, int n_mels,
                           float scale_sq, void* stream) {
  if (n <= 0 || frame_length <= 0 || n_freqs <= 0 || n_mels <= 0 ||
      reinterpret_cast<size_t>(bases) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the frame tile whole if it fits, else in the longest segments that do
  const int padded = (frame_length + kChunk - 1) / kChunk * kChunk;
  const int n_groups = (n_freqs + kMaxFreqs - 1) / kMaxFreqs;
  const int fixed = 2 * kChunk * kRow + (n_groups > 1 ? kTileFrames * n_mels
                                                      : 0);
  const int power_cols = n_freqs < kMaxFreqs ? n_freqs : kMaxFreqs;
  const int room = (kSmemBytes / 4 - fixed) / kTileFrames / kChunk * kChunk;
  const int seg = padded < room ? padded : room;
  if (seg < kChunk || room < power_cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cols = seg > power_cols ? seg : power_cols;
  const size_t smem = sizeof(float) * (fixed + kTileFrames * cols);
  auto kernel = n_groups > 1 || seg < padded ? logmel_kernel<true>
                                             : logmel_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int blocks = (n + kTileFrames - 1) / kTileFrames;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(bases),
      static_cast<const float*>(mel_t), static_cast<const int2*>(bands),
      static_cast<float*>(out), n, frame_length, n_freqs, n_mels, scale_sq,
      seg);
  return static_cast<int>(cudaGetLastError());
}
