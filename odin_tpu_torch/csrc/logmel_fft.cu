// K1 as an fp32 real FFT in shared memory, for sm_90a: windowed frames ->
// 10 log10(max(mel power, 1e-10)), unclipped (top-dB is outside).
//
// Replaces `_logmel_kernel` (odin_tpu/ops/pallas_features.py:32-39, launched
// by `logmel_pallas`) where n_fft is a power of two from 16 to 8192; the
// dense-DFT kernel (logmel.cu) takes every other n_fft.  It computes what
// JAX's bases define (odin_tpu/ops/features.py:97-105): for a frame f of
// frame_length samples,
//   X[k] = sum_{t < frame_length} f[t] exp(-2 pi i t k / n_fft),  k <= n_fft/2,
// so a frame shorter than n_fft is padded with zeros and a longer one folds:
// x[s] = sum of f[t] over t = s (mod n_fft), then X is the FFT of x.  Then
//   power = |X|^2 * scale_sq,  out = 10 log10(max(power . mel_t, 1e-10)).
//
// Bound on an H100 SXM at the speech path's size (N = 25,472 frames of 400
// samples, n_fft 512, 40 mels): the frames in and the mels out are about
// 44.9 MB, 0.013 ms at 3.35 TB/s; the operations (a 512-point real FFT is
// about 11.5k flop a frame, then the power, the banded mel product and the
// log) about 3.4e8 flop, 0.005 ms at 67 TFLOP/s fp32.  So it is bound by
// bytes.  The dense DFT that logmel.cu runs does 1.05e10 flop there, whose
// own floor (0.157 ms) is 12 times the function's.
//
// Design: an n_fft-point real FFT as an M = n_fft/2-point complex FFT of
// z[m] = x[2m] + i x[2m+1], which is the frame read as float2.  The complex
// FFT runs as Stockham passes (no bit-reversal pass): one pass of radix 2, 4
// or 8 first for the bits of M beyond a multiple of 4, then radix-16 passes
// (`plan`; two passes at n_fft 512).  In a pass each thread holds 16 points
// in registers: it reads them from shared memory, applies the twiddles and
// the butterflies, and writes them back in place after a barrier.  Rows are
// padded by one float2 in 16, which makes every pass's reads and writes free
// of bank conflicts.  A split step then gives the bins: with A = Z[k],
// B = conj(Z[M-k]), S = A + B, D = -i (A - B) and W = exp(-2 pi i k / n_fft),
//   4 |X[k]|^2 = |S + W D|^2,   4 |X[M-k]|^2 = |S - W D|^2,
// so a thread gives two bins from one pair of points.  The mel product runs
// over each filter's nonzero band, with the bands' weights packed (`bands`,
// `weights`); a thread takes one filter for four frames, so that each weight
// is read once for the four.
//
// A block of 256 threads owns a group of 4096 / M frames at a time (16 at
// n_fft 512) and walks over groups; the grid holds as many blocks as fit on
// the card at once, so the tables are staged into shared memory once a
// block.  A group's frames, contiguous in device memory, are copied into
// shared memory by cp.async while the block transforms the previous group,
// and the first pass reads them there; a frame longer than n_fft is folded
// into the FFT buffer by plain loads instead.  The twiddles come in one
// table made on the host in float64 and rounded once to fp32 (the layout is
// in `twiddle_count`); no sin/cos is computed on the device, and nothing is
// built with fast math: 0.01 dB leaves no room for either.
#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 16;  // complex points a thread holds in a pass
constexpr int kGroupPoints = kThreads * kPoints;  // a group's M * frames
constexpr int kMelFrames = 4;  // frames a thread takes in the mel product
constexpr int kMinLog2Fft = 4;    // n_fft 16
constexpr int kMaxLog2Fft = 13;   // n_fft 8192: M = kGroupPoints
constexpr int kSmemBytes = 232448;  // shared memory a block may use
constexpr int kMaxDevices = 64;

// exp(-2 pi i k / 16), rounded once to fp32
constexpr float kR = 0.707106781186547524f;   // cos(pi/4)
constexpr float kC = 0.923879532511286756f;   // cos(pi/8)
constexpr float kS = 0.382683432365089772f;   // sin(pi/8)

// The radix of the first pass: 2, 4 or 8 for the bits of M beyond a
// multiple of 4, else 16; every later pass is radix 16.
__host__ __device__ int first_radix(int log2_m) {
  return log2_m % 4 ? 1 << (log2_m % 4) : 16;
}

// The twiddles of the passes after the first, then those of the split step.
// A radix-R pass that follows passes of ns points in all holds, for k < ns
// and r = 1 .. R-1, exp(-2 pi i r k / (ns R)) at (R-1) k + r - 1; the split
// step holds exp(-2 pi i k / n_fft) for k < n_fft / 4.
int twiddle_count(int log2_fft) {
  const int m = 1 << (log2_fft - 1);
  int count = m / 2;
  for (int ns = first_radix(log2_fft - 1); ns < m; ns *= 16) {
    count += 15 * ns;
  }
  return count;
}

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 mul_neg_i(float2 a) {  // -i a
  return make_float2(a.y, -a.x);
}

// one float2 of padding in 16
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// y[q] = sum_r v[r] exp(-2 pi i r q / R), in place
__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2,
                                     float2& v3) {
  const float2 a0 = add(v0, v2);
  const float2 a1 = sub(v0, v2);
  const float2 a2 = add(v1, v3);
  const float2 a3 = mul_neg_i(sub(v1, v3));
  v0 = add(a0, a2);
  v1 = add(a1, a3);
  v2 = sub(a0, a2);
  v3 = sub(a1, a3);
}

template <int R>
__device__ __forceinline__ void dft(float2* v);

template <>
__device__ __forceinline__ void dft<2>(float2* v) {
  const float2 a = v[0];
  v[0] = add(a, v[1]);
  v[1] = sub(a, v[1]);
}

template <>
__device__ __forceinline__ void dft<4>(float2* v) {
  dft4(v[0], v[1], v[2], v[3]);
}

// 8 = 4 x 2: r = 2 r1 + r2, q = q1 + 4 q2
template <>
__device__ __forceinline__ void dft<8>(float2* v) {
  float2 a0 = v[0], a1 = v[2], a2 = v[4], a3 = v[6];
  float2 b0 = v[1], b1 = v[3], b2 = v[5], b3 = v[7];
  dft4(a0, a1, a2, a3);
  dft4(b0, b1, b2, b3);
  b1 = make_float2((b1.x + b1.y) * kR, (b1.y - b1.x) * kR);     // W8^1
  b2 = mul_neg_i(b2);                                           // W8^2
  b3 = make_float2((b3.y - b3.x) * kR, -(b3.x + b3.y) * kR);    // W8^3
  v[0] = add(a0, b0);
  v[4] = sub(a0, b0);
  v[1] = add(a1, b1);
  v[5] = sub(a1, b1);
  v[2] = add(a2, b2);
  v[6] = sub(a2, b2);
  v[3] = add(a3, b3);
  v[7] = sub(a3, b3);
}

// 16 = 4 x 4: r = 4 r1 + r2, q = q1 + 4 q2
template <>
__device__ __forceinline__ void dft<16>(float2* v) {
#pragma unroll
  for (int r2 = 0; r2 < 4; ++r2) {
    dft4(v[r2], v[4 + r2], v[8 + r2], v[12 + r2]);
  }
  // v[4 q1 + r2] now holds the r2-th sub-transform at q1; times W16^(r2 q1)
  const float2 w1 = make_float2(kC, -kS);
  const float2 w3 = make_float2(kS, -kC);
  v[5] = cmul(v[5], w1);
  v[6] = make_float2((v[6].x + v[6].y) * kR, (v[6].y - v[6].x) * kR);   // W^2
  v[7] = cmul(v[7], w3);
  v[9] = make_float2((v[9].x + v[9].y) * kR, (v[9].y - v[9].x) * kR);   // W^2
  v[10] = mul_neg_i(v[10]);                                              // W^4
  v[11] = make_float2((v[11].y - v[11].x) * kR,
                      -(v[11].x + v[11].y) * kR);                        // W^6
  v[13] = cmul(v[13], w3);
  v[14] = make_float2((v[14].y - v[14].x) * kR,
                      -(v[14].x + v[14].y) * kR);                        // W^6
  v[15] = cmul(v[15], make_float2(-kC, kS));                             // W^9
#pragma unroll
  for (int q1 = 0; q1 < 4; ++q1) {
    dft4(v[4 * q1], v[4 * q1 + 1], v[4 * q1 + 2], v[4 * q1 + 3]);
  }
  // y[q1 + 4 q2] sits at v[4 q1 + q2]: transpose the 4 x 4
  float2 t;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = a + 1; b < 4; ++b) {
      t = v[4 * a + b];
      v[4 * a + b] = v[4 * b + a];
      v[4 * b + a] = t;
    }
  }
}

__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
                 "l"(src));
  }
}

// Copies `count` floats of a group's frames (contiguous in device memory)
// into shared memory with cp.async, 16 bytes a copy where `vec` says both
// ends are aligned, and commits them as one group.
__device__ __forceinline__ void stage_frames(float* dst, const float* src,
                                             int count, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < count / 4; i += kThreads) {
      copy_async(dst + 4 * i, src + 4 * i, 16);
    }
    for (int i = count / 4 * 4 + threadIdx.x; i < count; i += kThreads) {
      copy_async(dst + i, src + i, 4);
    }
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads) {
      copy_async(dst + i, src + i, 4);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// One radix-R Stockham pass over a group, after passes of ns points: each
// thread takes kPoints / R butterflies.  The first pass (ns = 1, twiddles
// all 1) reads the staged frames (kFromStage: rows of frame_length floats,
// zero past the frame) or the folded frames in buf; every pass writes buf,
// in place after a barrier where it read buf.
template <int R, bool kFromStage>
__device__ __forceinline__ void fft_pass(
    const float* stage, int frame_length, float2* buf, int m_pad,
    int log2_step, int ns, const float2* tw, int rows) {
  constexpr int kButterflies = kPoints / R;
  const int step = 1 << log2_step;
  float2 v[kPoints];
#pragma unroll
  for (int b = 0; b < kButterflies; ++b) {
    const int idx = threadIdx.x + b * kThreads;
    const int f = idx >> log2_step;
    const int j = idx & (step - 1);
    if (f < rows) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int p = j + q * step;
        if (kFromStage) {
          // one 8-byte load where the frame length is even (the rows and
          // the pair are then 8-byte aligned)
          const float* row = stage + f * frame_length;
          const int t = 2 * p;
          if (t + 1 >= frame_length) {
            v[b * R + q] = make_float2(t < frame_length ? row[t] : 0.0f, 0.0f);
          } else if (frame_length % 2 == 0) {
            v[b * R + q] = *reinterpret_cast<const float2*>(row + t);
          } else {
            v[b * R + q] = make_float2(row[t], row[t + 1]);
          }
        } else {
          v[b * R + q] = buf[f * m_pad + pad(p)];
        }
      }
    }
  }
  if (!kFromStage) {
    __syncthreads();  // every point of the pass is read before any is written
  }
#pragma unroll
  for (int b = 0; b < kButterflies; ++b) {
    const int idx = threadIdx.x + b * kThreads;
    const int f = idx >> log2_step;
    const int j = idx & (step - 1);
    if (f < rows) {
      float2* x = v + b * R;
      const int k = j & (ns - 1);
      if (ns > 1) {
        const float2* w = tw + (R - 1) * k;
#pragma unroll
        for (int q = 1; q < R; ++q) {
          x[q] = cmul(x[q], w[q - 1]);
        }
      }
      dft<R>(x);
      float2* d = buf + f * m_pad;
      const int o = (j - k) * R + k;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        d[pad(o + q * ns)] = x[q];
      }
    }
  }
}

template <bool kFromStage>
__device__ __forceinline__ void first_pass(int radix, const float* stage,
                                           int frame_length, float2* buf,
                                           int m_pad, int log2_m, int rows) {
  switch (radix) {
    case 2:
      fft_pass<2, kFromStage>(stage, frame_length, buf, m_pad, log2_m - 1, 1,
                              nullptr, rows);
      break;
    case 4:
      fft_pass<4, kFromStage>(stage, frame_length, buf, m_pad, log2_m - 2, 1,
                              nullptr, rows);
      break;
    case 8:
      fft_pass<8, kFromStage>(stage, frame_length, buf, m_pad, log2_m - 3, 1,
                              nullptr, rows);
      break;
    default:
      fft_pass<16, kFromStage>(stage, frame_length, buf, m_pad, log2_m - 4,
                               1, nullptr, rows);
  }
}

// kStaged: the frames are no longer than n_fft and are staged by cp.async
// into one of two buffers while the other group is transformed; otherwise
// (a frame longer than n_fft, or the staging buffers do not fit) they are
// folded into buf by plain loads.  Either way `stage` ends up holding the
// group's power rows, m + 1 floats a frame.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 2) logmel_fft_kernel(
    const float* __restrict__ frames,    // (n, frame_length)
    const float2* __restrict__ twiddles,  // (n_twiddles,) see twiddle_count
    const float* __restrict__ weights,   // (n_weights,) the bands' weights
    const int4* __restrict__ bands,      // (n_mels,): lo, hi, offset, 0
    float* __restrict__ out,             // (n, n_mels)
    int n, int frame_length, int log2_fft, int n_mels, int n_twiddles,
    int n_weights, int stage_floats, bool vec, float scale_sq) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int log2_m = log2_fft - 1;
  const int m = 1 << log2_m;  // complex points of a frame
  const int half = m >> 1;
  const int m_pad = m + (m >> 4);
  const int group_frames = kGroupPoints >> log2_m;
  int4* band_s = reinterpret_cast<int4*>(smem);
  float* staged = reinterpret_cast<float*>(band_s + n_mels);
  float2* tw = reinterpret_cast<float2*>(staged +
                                         (kStaged ? 2 : 1) * stage_floats);
  float2* buf = tw + n_twiddles;
  float* weight_s = reinterpret_cast<float*>(buf + group_frames * m_pad);
  const int n_groups = (n + group_frames - 1) / group_frames;
  const size_t group_stride =
      static_cast<size_t>(group_frames) * frame_length;
  if (kStaged) {  // gridDim.x <= n_groups
    stage_frames(staged, frames + blockIdx.x * group_stride,
                 min(group_frames, n - static_cast<int>(blockIdx.x) *
                                           group_frames) * frame_length,
                 vec);
  }
  for (int i = threadIdx.x; i < n_mels; i += kThreads) {
    band_s[i] = bands[i];
  }
  for (int i = threadIdx.x; i < n_twiddles; i += kThreads) {
    tw[i] = twiddles[i];
  }
  for (int i = threadIdx.x; i < n_weights; i += kThreads) {
    weight_s[i] = weights[i];
  }
  const float2* split_tw = tw + n_twiddles - half;
  const float out_scale = 0.25f * scale_sq;  // 4 |X|^2 from the split step
  const int radix0 = first_radix(log2_m);

  int it = 0;
  for (int group = blockIdx.x; group < n_groups;
       group += gridDim.x, ++it) {
    const int first = group * group_frames;
    const int rows = min(group_frames, n - first);
    float* cur = staged + (kStaged ? (it & 1) * stage_floats : 0);
    if (kStaged) {
      const int next = group + gridDim.x;
      if (next < n_groups) {
        stage_frames(staged + ((it + 1) & 1) * stage_floats,
                     frames + next * group_stride,
                     min(group_frames, n - next * group_frames) *
                         frame_length, vec);
      } else {
        asm volatile("cp.async.commit_group;\n" ::);
      }
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      // the fold: x[s] = sum of the frame's samples t = s (mod n_fft),
      // written as the floats of z in buf's padded rows
      const float* src = frames + group * group_stride;
      float* x = reinterpret_cast<float*>(buf);
      for (int i = threadIdx.x; i < rows << log2_fft; i += kThreads) {
        const int f = i >> log2_fft;
        const int s = i & ((2 << log2_m) - 1);
        const float* row = src + static_cast<size_t>(f) * frame_length;
        float sum = 0.0f;
        for (int t = s; t < frame_length; t += 2 << log2_m) {
          sum += row[t];
        }
        x[2 * (f * m_pad + pad(s >> 1)) + (s & 1)] = sum;
      }
    }
    __syncthreads();  // the frames (and, the first time, the tables) are in

    first_pass<kStaged>(radix0, cur, frame_length, buf, m_pad, log2_m, rows);
    __syncthreads();
    const float2* pass_tw = tw;
    for (int ns = radix0; ns < m; ns *= 16) {
      fft_pass<16, false>(nullptr, frame_length, buf, m_pad, log2_m - 4, ns,
                          pass_tw, rows);
      pass_tw += 15 * ns;
      __syncthreads();
    }

    // split step: the power of bins k and M - k (and, for k = 0, M / 2)
    // into the group's power rows in `cur`, which the first pass has read
    float* power = cur;
#pragma unroll
    for (int b = 0; b < kPoints / 2; ++b) {
      const int idx = threadIdx.x + b * kThreads;
      const int f = idx >> (log2_m - 1);
      const int k = idx & (half - 1);
      if (f < rows) {
        const float2* z = buf + f * m_pad;
        float* p = power + f * (m + 1);
        const float2 za = z[pad(k)];
        const float2 zb = z[pad((m - k) & (m - 1))];
        const float2 s = make_float2(za.x + zb.x, za.y - zb.y);
        const float2 d = make_float2(za.y + zb.y, zb.x - za.x);
        const float2 wd = cmul(split_tw[k], d);
        const float2 x0 = add(s, wd);
        const float2 x1 = sub(s, wd);
        p[k] = x0.x * x0.x + x0.y * x0.y;
        p[m - k] = x1.x * x1.x + x1.y * x1.y;
        if (k == 0) {  // bin M / 2: 4 |X|^2 = 4 |Z[M/2]|^2
          const float2 zh = z[pad(half)];
          p[half] = 4.0f * (zh.x * zh.x + zh.y * zh.y);
        }
      }
    }
    __syncthreads();

    // the mel product over each filter's nonzero band, kMelFrames frames a
    // thread, then the log
    const int quads = (rows + kMelFrames - 1) / kMelFrames;
    for (int i = threadIdx.x; i < quads * n_mels; i += kThreads) {
      const int quad = i / n_mels;
      const int mel = i - quad * n_mels;
      const int4 band = band_s[mel];
      // past the group's last frame, the rows read are the last frame's
      // (and their sums are not stored)
      const float* p[kMelFrames];
#pragma unroll
      for (int r = 0; r < kMelFrames; ++r) {
        p[r] = power + min(quad * kMelFrames + r, rows - 1) * (m + 1);
      }
      const float* w = weight_s + band.z - band.x;
      float acc[kMelFrames] = {};
      for (int k = band.x; k < band.y; ++k) {
        const float wk = w[k];
#pragma unroll
        for (int r = 0; r < kMelFrames; ++r) {
          acc[r] = fmaf(p[r][k], wk, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kMelFrames; ++r) {
        const int f = quad * kMelFrames + r;
        if (f < rows) {
          out[static_cast<size_t>(first + f) * n_mels + mel] =
              10.0f * log10f(fmaxf(acc[r] * out_scale, 1e-10f));
        }
      }
    }
    __syncthreads();  // the buffers are read before the next group
  }
}

size_t smem_bytes(bool staged, int log2_fft, int n_mels, int n_weights,
                  int stage_floats) {
  const int m = 1 << (log2_fft - 1);
  const size_t frames = kGroupPoints / m;
  return sizeof(int4) * n_mels +
         sizeof(float) * (staged ? 2 : 1) * stage_floats +
         sizeof(float2) * (twiddle_count(log2_fft) + frames * (m + m / 16)) +
         sizeof(float) * n_weights;
}

// The floats of one staging buffer: the group's frames where they are
// staged, and its power rows (m + 1 floats a frame) either way; a multiple
// of 16 bytes.
int stage_floats_for(bool staged, int log2_fft, int frame_length) {
  const int m = 1 << (log2_fft - 1);
  const int row = staged && frame_length > m + 1 ? frame_length : m + 1;
  return (kGroupPoints / m * row + 3) / 4 * 4;
}

// The SM count and, for each variant of the kernel, the blocks an SM holds
// at the shared memory last asked for, per device: queried once, since the
// queries cost host time on every launch.
struct Occupancy {
  int sms = 0;
  size_t smem[2] = {0, 0};
  int per_sm[2] = {0, 0};
};
std::mutex occupancy_mutex;
Occupancy occupancy[kMaxDevices];

cudaError_t resident_blocks(bool staged, size_t smem, int* blocks) {
  auto kernel = staged ? logmel_fft_kernel<true> : logmel_fft_kernel<false>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) {
    return err;
  }
  if (device >= kMaxDevices) {
    return cudaErrorInvalidDevice;
  }
  std::lock_guard<std::mutex> lock(occupancy_mutex);
  Occupancy& o = occupancy[device];
  if (o.sms == 0) {
    err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) {
      o.sms = 0;
      return err;
    }
  }
  if (o.smem[staged] != smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &o.per_sm[staged], kernel, kThreads, smem);
    }
    if (err != cudaSuccess) {
      o.smem[staged] = 0;
      return err;
    }
    o.smem[staged] = smem;
  }
  *blocks = o.sms * (o.per_sm[staged] > 0 ? o.per_sm[staged] : 1);
  return cudaSuccess;
}

}  // namespace

// The n_fft the kernel takes: powers of two from 2^min_log2 to 2^max_log2.
extern "C" void odin_logmel_fft_limits(int* min_log2, int* max_log2) {
  *min_log2 = kMinLog2Fft;
  *max_log2 = kMaxLog2Fft;
}

// The length of the twiddle table for n_fft = 2^log2_fft (float2 entries),
// or 0 outside the kernel's range.
extern "C" int odin_logmel_fft_twiddle_count(int log2_fft) {
  if (log2_fft < kMinLog2Fft || log2_fft > kMaxLog2Fft) {
    return 0;
  }
  return twiddle_count(log2_fft);
}

// Launches K1's FFT kernel on `stream`.  Allocates nothing and does not
// synchronise.  `twiddles` is the table of odin_logmel_fft_twiddle_count
// entries; `bands` gives each mel filter's nonzero bins [lo, hi) and the
// offset of their weights in `weights`.  Returns 0, or a CUDA error.
extern "C" int odin_logmel_fft(const void* frames, const void* twiddles,
                               const void* weights, const void* bands,
                               void* out, int n, int frame_length,
                               int log2_fft, int n_mels, int n_weights,
                               float scale_sq, void* stream) {
  if (n <= 0 || frame_length <= 0 || n_mels <= 0 || n_weights < 0 ||
      log2_fft < kMinLog2Fft || log2_fft > kMaxLog2Fft ||
      reinterpret_cast<size_t>(bands) % 16 != 0 ||
      reinterpret_cast<size_t>(twiddles) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int m = 1 << (log2_fft - 1);
  const int group_frames = kGroupPoints / m;
  // the frames staged where they are no longer than n_fft and fit
  bool staged = frame_length <= 2 * m;
  int stage_floats = stage_floats_for(staged, log2_fft, frame_length);
  if (staged && smem_bytes(true, log2_fft, n_mels, n_weights, stage_floats) >
                    kSmemBytes) {
    staged = false;
    stage_floats = stage_floats_for(false, log2_fft, frame_length);
  }
  const size_t smem =
      smem_bytes(staged, log2_fft, n_mels, n_weights, stage_floats);
  if (smem > kSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int resident = 0;
  cudaError_t err = resident_blocks(staged, smem, &resident);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  // 16-byte copies where every group's frames start on 16 bytes
  const bool vec = reinterpret_cast<size_t>(frames) % 16 == 0 &&
                   group_frames * frame_length % 4 == 0;
  const int n_groups = (n + group_frames - 1) / group_frames;
  const int blocks = n_groups < resident ? n_groups : resident;
  auto kernel = staged ? logmel_fft_kernel<true> : logmel_fft_kernel<false>;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float2*>(twiddles),
      static_cast<const float*>(weights), static_cast<const int4*>(bands),
      static_cast<float*>(out), n, frame_length, log2_fft, n_mels,
      twiddle_count(log2_fft), n_weights, stage_floats, vec, scale_sq);
  return static_cast<int>(cudaGetLastError());
}
