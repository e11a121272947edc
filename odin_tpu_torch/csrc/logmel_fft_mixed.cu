// K1 as a mixed-radix fp32 real FFT in shared memory, for sm_90a: windowed
// frames -> 10 log10(max(mel power, 1e-10)), unclipped (top-dB is outside).
//
// Replaces `_logmel_kernel` (odin_tpu/ops/pallas_features.py:32-39, launched
// by `logmel_pallas`) where n_fft is even, from 16 to 8192, not a power of
// two, and M = n_fft/2 has no prime factor above 7: Whisper's n_fft 400
// (25 ms at 16 kHz), 320 and 480 (20 and 30 ms), 882 (20 ms at 44.1 kHz),
// 1200 (25 ms at 48 kHz).  logmel_fft.cu takes the powers of two, logmel.cu
// (the dense DFT) the rest (`kernel_route`, ops/logmel.py).  It computes
// what JAX's bases define (odin_tpu/ops/features.py:97-105): for a frame f
// of frame_length samples,
//   X[k] = sum_{t < frame_length} f[t] exp(-2 pi i t k / n_fft),  k <= n_fft/2,
// so a frame shorter than n_fft is padded with zeros and a longer one folds:
// x[s] = sum of f[t] over t = s (mod n_fft), then X is the FFT of x.  Then
//   power = |X|^2 * scale_sq,  out = 10 log10(max(power . mel_t, 1e-10)).
//
// Bound on an H100 SXM at Whisper's framing (N = 25,472 frames of 400
// samples, n_fft 400, 201 bins, 80 mels from 0 Hz): the frames in, the
// filter bank in and the mels out are 48.97 MB, 0.0146 ms at 3.35 TB/s;
// the operations (a 400-point real FFT, 2.5 n log2 n = 8.6k flop a frame,
// then the power, the banded mel product and the log) about 2.6e8 flop,
// 0.004 ms at 67 TFLOP/s fp32.  So it is bound by bytes.  The dense DFT
// does 8.19e9 flop there, whose own floor (0.122 ms) is 8.4 times the
// function's.
//
// Design: an n_fft-point real FFT as an M-point complex FFT of
// z[m] = x[2m] + i x[2m+1], which is the frame read as float2, then a split
// step.  The complex FFT runs as Stockham passes (no reordering pass),
// planned from M's factors (`make_plan`): the power of two first, a pass
// of radix 2, 4 or 8 for its bits beyond a multiple of 4 and then radix-16
// passes, as logmel_fft.cu plans them; then one pass of radix 3, 5 or 7 for
// each such factor, in that order.  M = 200 is 8.5.5, M = 240 16.3.5,
// M = 600 8.3.5.5, M = 441 3.3.7.7.  A pass of radix R after passes that
// span ns points takes, for j < M/R and k = j mod ns, the points
// j + q M/R (q < R), multiplies point q by exp(-2 pi i q k / (ns R)),
// transforms them (`dft<R>`) and writes output q at (j - k) R + k + q ns.
// The split step gives, with A = Z[k], B = conj(Z[M-k]), S = A + B,
// D = -i (A - B) and W = exp(-2 pi i k / n_fft),
//   4 |X[k]|^2 = |S + W D|^2,   4 |X[M-k]|^2 = |S - W D|^2,
// for k < (M + 1)/2, with k = 0 giving bins 0 and M; for even M, bin M/2
// is 4 |X|^2 = 4 |Z[M/2]|^2, and for odd M there is no middle bin.
//
// A block of 256 threads owns a group of G frames at a time and walks over
// groups; the grid holds as many blocks as fit on the card at once.  A
// group's frames, contiguous in device memory, are copied into shared
// memory by cp.async while the block transforms the previous group, and
// the first pass reads them there; a frame longer than n_fft is folded
// into the FFT buffer by plain loads instead.  The passes go back and
// forth between the FFT buffer and the group's staging buffer, whose
// frames the first pass has read: a pass reads each butterfly's R points
// from one, and writes its R outputs to the other, so a thread holds one
// butterfly at a time (80 registers, no spills) and a pass needs one
// barrier.  (Designs that held all of a thread's points in registers
// across a barrier, to transform in place in one buffer, spilled at
// radix 3 and 7 and took 0.32 ms at n_fft 1200 where this one takes 0.21; PERF.md.)
// A pass of radix R has G M / R butterflies, which the threads take in
// turn; where G M / R is not a multiple of 256 some threads idle in the
// last round.  G is the one of 1 .. 4096 / M (or 1) that gives the most
// frames for the slots the passes take (`mixed_geometry`, ops/logmel.py);
// the idle shares of a full group's passes (tools/k1_mixed_plan.py):
//   n_fft  400: G 19, radix 8, 5, 5:     7.2 %, 1.0 %, 1.0 %
//   n_fft  480: G 16, radix 16, 3, 5:    6.2 %, 0 %, 0 %
//   n_fft  882: G  8, radix 3, 3, 7, 7:  8.1 %, 8.1 %, 1.6 %, 1.6 %
//   n_fft 1200: G  6, radix 8, 3, 5, 5:  12.1 %, 6.2 %, 6.2 %, 6.2 %
// At n_fft 400 a block takes about 96 KB of shared memory, 2 blocks an SM.
//
// Shared memory: point i of a group lies at float2 `at(i)`, in one of two
// layouts, which the caller picks for the plan's strides (`mixed_geometry`,
// a count of the bank conflicts of every pass): plain (i) or swizzled
// (i ^ ((i/16) mod 16), the bank pair permuted within each run of 16).  A
// power-of-two first pass writes with a stride of R points, which puts 8
// of 16 threads on one bank pair where the points lie plain; an odd radix
// writes with an odd stride, free of conflicts plain, which the swizzle
// disturbs.  At n_fft 400, 480 and 1200 the count picks the swizzle, at
// 882 (radix 3 first) the plain layout; each pick was within 1.5 % of the
// fastest layout on the card (the padding of logmel_fft.cu, one float2 in
// 16, was the fastest at 480 and 1200 by that much, and was left out;
// PERF.md).
//
// Integer division by M / R, by ns, by the split step's pairs, by n_fft
// and by the mel count (none of them a power of two in general) is a
// multiply-high by a constant made on the host (`magic`), exact for the
// dividends the kernel meets.  The twiddles come in one table made on the
// host in float64 and rounded once to fp32 (the layout is in
// `make_plan`); the radix-3, 5, 7, 8 and 16 butterflies' constants are
// cos and sin of 2 pi j / R computed in float64 and rounded once to fp32,
// written below as exact hex literals.  No sin/cos is computed on the
// device, and nothing is built with fast math: 0.01 dB on bins 80 dB below
// the peak leaves no room for either.
#include <cuda_runtime.h>

#include <initializer_list>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksAnSm = 3;  // 80 registers a thread
constexpr int kMaxGroupPoints = 16384;  // a group's M * frames at most
constexpr int kMelFrames = 4;       // frames a thread takes in the mel product
constexpr int kMinFft = 16;
constexpr int kMaxFft = 8192;
constexpr int kMaxPasses = 12;  // passes a plan may hold (M = 3^7: 7)
constexpr int kLayouts = 2;     // plain, swizzled
constexpr int kSmemBytes = 232448;  // shared memory a block may use
constexpr int kMaxDevices = 64;

// cos and sin of 2 pi j / R, computed in float64 and rounded once to fp32
constexpr float kCos3_1 = -0x1p-1f;          // R = 3, j = 1
constexpr float kSin3_1 = 0x1.bb67aep-1f;
constexpr float kCos5_1 = 0x1.3c6ef4p-2f;    // R = 5, j = 1, 2
constexpr float kSin5_1 = 0x1.e6f0e2p-1f;
constexpr float kCos5_2 = -0x1.9e377ap-1f;
constexpr float kSin5_2 = 0x1.2cf230p-1f;
constexpr float kCos7_1 = 0x1.3f3a0ep-1f;    // R = 7, j = 1, 2, 3
constexpr float kSin7_1 = 0x1.904c38p-1f;
constexpr float kCos7_2 = -0x1.c7b90ep-3f;
constexpr float kSin7_2 = 0x1.f329c0p-1f;
constexpr float kCos7_3 = -0x1.cd4bcap-1f;
constexpr float kSin7_3 = 0x1.bc4c04p-2f;
constexpr float kCos8_1 = 0x1.6a09e6p-1f;    // R = 8, j = 1 (= sin)
constexpr float kCos16_1 = 0x1.d906bcp-1f;   // R = 16, j = 1
constexpr float kSin16_1 = 0x1.87de2ap-2f;

// One Stockham pass: radix, the points ns that the earlier passes span,
// step = M / radix, the multipliers that divide by step and by ns, and the
// offset of the pass's twiddles in the table.
struct Pass {
  int radix, ns, step;
  unsigned step_magic, ns_magic;
  int twiddle;
};

// Everything a launch needs to know of n_fft, made on the host.
struct Plan {
  int n_fft, m, passes, group;
  int pairs;  // the split step's pairs a frame, (M + 1) / 2
  unsigned pairs_magic, fft_magic, mel_magic;
  Pass pass[kMaxPasses];
};

// ceil(2^32 / d), so that n / d = umulhi(n, magic) while n (d - 1) < 2^32
// (`fits`); 0 stands for d = 1
unsigned magic(int d) {
  return d == 1 ? 0u
                : static_cast<unsigned>(((1ull << 32) + d - 1) /
                                        static_cast<unsigned long long>(d));
}

bool fits(long long max_dividend, int d) {
  return max_dividend * (d - 1) < (1ll << 32);
}

__device__ __forceinline__ int quotient(int n, unsigned mul) {
  return mul ? static_cast<int>(__umulhi(static_cast<unsigned>(n), mul)) : n;
}

// The plan of n_fft (false outside the kernel's range): the radices, each
// pass's strides and twiddle offset, and the twiddle count.  A radix-R pass
// that follows passes of ns points in all holds, for r = 1 .. R-1 and
// k < ns, exp(-2 pi i r k / (ns R)) at (r - 1) ns + k, so that the threads
// of a warp, on consecutive k, read consecutive twiddles (logmel_fft.cu
// holds them at (R-1) k + r - 1, which for an odd R is an even stride); the
// split step holds exp(-2 pi i k / n_fft) for k < (M + 1) / 2, after them.
bool make_plan(int n_fft, Plan* plan, int* twiddles) {
  if (n_fft < kMinFft || n_fft > kMaxFft || n_fft % 2) {
    return false;
  }
  const int m = n_fft / 2;
  int radices[kMaxPasses];
  int passes = 0;
  int log2 = 0;
  while ((m >> log2) % 2 == 0) {
    ++log2;
  }
  int odd = m >> log2;
  if (odd == 1) {
    return false;  // a power of two: logmel_fft.cu
  }
  if (log2 % 4) {
    radices[passes++] = 1 << (log2 % 4);
  }
  for (int i = 0; i < log2 / 4; ++i) {
    radices[passes++] = 16;
  }
  for (int p : {3, 5, 7}) {
    while (odd % p == 0) {
      radices[passes++] = p;
      odd /= p;
    }
  }
  if (odd != 1) {
    return false;  // a prime factor of 11 or more: logmel.cu
  }
  plan->n_fft = n_fft;
  plan->m = m;
  plan->passes = passes;
  plan->group = 0;
  plan->pairs = (m + 1) / 2;
  int ns = 1, count = 0;
  for (int p = 0; p < passes; ++p) {
    Pass& ps = plan->pass[p];
    ps.radix = radices[p];
    ps.ns = ns;
    ps.step = m / ps.radix;
    ps.step_magic = magic(ps.step);
    ps.ns_magic = magic(ns);
    ps.twiddle = count;
    if (p > 0) {
      count += (ps.radix - 1) * ns;
    }
    ns *= ps.radix;
  }
  *twiddles = count + plan->pairs;
  return true;
}

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 scale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 mul_neg_i(float2 a) {  // -i a
  return make_float2(a.y, -a.x);
}

// where a group's point i lies, in float2 (`Layout` of ops/logmel.py)
template <int kLayout>
__device__ __forceinline__ int at(int i) {
  return kLayout ? i ^ ((i >> 4) & 15) : i;
}

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

// t - i u and t + i u into y[q] and y[R - q]
__device__ __forceinline__ void conj_pair(float2 t, float2 u, float2& lo,
                                          float2& hi) {
  lo = make_float2(t.x + u.y, t.y - u.x);
  hi = make_float2(t.x - u.y, t.y + u.x);
}

template <int R>
__device__ __forceinline__ void dft(float2* v);

template <>
__device__ __forceinline__ void dft<2>(float2* v) {
  const float2 a = v[0];
  v[0] = add(a, v[1]);
  v[1] = sub(a, v[1]);
}

// with a = x1 + x2, b = x1 - x2: y1, y2 = x0 + cos(2pi/3) a -/+ i sin(2pi/3) b
template <>
__device__ __forceinline__ void dft<3>(float2* v) {
  const float2 a = add(v[1], v[2]);
  const float2 b = sub(v[1], v[2]);
  const float2 t = add(v[0], scale(a, kCos3_1));
  v[0] = add(v[0], a);
  conj_pair(t, scale(b, kSin3_1), v[1], v[2]);
}

template <>
__device__ __forceinline__ void dft<4>(float2* v) {
  dft4(v[0], v[1], v[2], v[3]);
}

// with a_j = x_j + x_{5-j}, b_j = x_j - x_{5-j}: y_q, y_{5-q} =
// x0 + sum_j cos(2pi qj/5) a_j -/+ i sum_j sin(2pi qj/5) b_j
template <>
__device__ __forceinline__ void dft<5>(float2* v) {
  const float2 a1 = add(v[1], v[4]), b1 = sub(v[1], v[4]);
  const float2 a2 = add(v[2], v[3]), b2 = sub(v[2], v[3]);
  const float2 t1 = add(v[0], add(scale(a1, kCos5_1), scale(a2, kCos5_2)));
  const float2 t2 = add(v[0], add(scale(a1, kCos5_2), scale(a2, kCos5_1)));
  const float2 u1 = add(scale(b1, kSin5_1), scale(b2, kSin5_2));
  const float2 u2 = sub(scale(b1, kSin5_2), scale(b2, kSin5_1));
  v[0] = add(v[0], add(a1, a2));
  conj_pair(t1, u1, v[1], v[4]);
  conj_pair(t2, u2, v[2], v[3]);
}

// as radix 5: cos(2pi qj/7) and sin(2pi qj/7) are the constants of
// j' = qj mod 7, the sin negated for j' > 3
template <>
__device__ __forceinline__ void dft<7>(float2* v) {
  const float2 a1 = add(v[1], v[6]), b1 = sub(v[1], v[6]);
  const float2 a2 = add(v[2], v[5]), b2 = sub(v[2], v[5]);
  const float2 a3 = add(v[3], v[4]), b3 = sub(v[3], v[4]);
  const float2 t1 = add(v[0], add(add(scale(a1, kCos7_1), scale(a2, kCos7_2)),
                                  scale(a3, kCos7_3)));
  const float2 t2 = add(v[0], add(add(scale(a1, kCos7_2), scale(a2, kCos7_3)),
                                  scale(a3, kCos7_1)));
  const float2 t3 = add(v[0], add(add(scale(a1, kCos7_3), scale(a2, kCos7_1)),
                                  scale(a3, kCos7_2)));
  const float2 u1 = add(add(scale(b1, kSin7_1), scale(b2, kSin7_2)),
                        scale(b3, kSin7_3));
  const float2 u2 = sub(sub(scale(b1, kSin7_2), scale(b2, kSin7_3)),
                        scale(b3, kSin7_1));
  const float2 u3 = add(sub(scale(b1, kSin7_3), scale(b2, kSin7_1)),
                        scale(b3, kSin7_2));
  v[0] = add(v[0], add(add(a1, a2), a3));
  conj_pair(t1, u1, v[1], v[6]);
  conj_pair(t2, u2, v[2], v[5]);
  conj_pair(t3, u3, v[3], v[4]);
}

// times exp(-2 pi i / 8), exp(-2 pi i 3 / 8)
__device__ __forceinline__ float2 w8_1(float2 a) {
  return make_float2((a.x + a.y) * kCos8_1, (a.y - a.x) * kCos8_1);
}

__device__ __forceinline__ float2 w8_3(float2 a) {
  return make_float2((a.y - a.x) * kCos8_1, -(a.x + a.y) * kCos8_1);
}

// 8 = 4 x 2: r = 2 r1 + r2, q = q1 + 4 q2
template <>
__device__ __forceinline__ void dft<8>(float2* v) {
  float2 a0 = v[0], a1 = v[2], a2 = v[4], a3 = v[6];
  float2 b0 = v[1], b1 = v[3], b2 = v[5], b3 = v[7];
  dft4(a0, a1, a2, a3);
  dft4(b0, b1, b2, b3);
  b1 = w8_1(b1);
  b2 = mul_neg_i(b2);
  b3 = w8_3(b3);
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
  const float2 w1 = make_float2(kCos16_1, -kSin16_1);
  const float2 w3 = make_float2(kSin16_1, -kCos16_1);
  v[5] = cmul(v[5], w1);
  v[6] = w8_1(v[6]);      // W16^2
  v[7] = cmul(v[7], w3);
  v[9] = w8_1(v[9]);      // W16^2
  v[10] = mul_neg_i(v[10]);  // W16^4
  v[11] = w8_3(v[11]);    // W16^6
  v[13] = cmul(v[13], w3);
  v[14] = w8_3(v[14]);    // W16^6
  v[15] = cmul(v[15], make_float2(-kCos16_1, kSin16_1));  // W16^9
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

// One radix-R Stockham pass over the `rows` frames of a group, from `src`
// into `dst`: the threads take the rows * M/R butterflies in turn, each
// from its points to its outputs in registers.  The first pass (ns = 1,
// twiddles all 1) reads the staged frames (kFromStage: rows of
// frame_length floats, zero past the frame) or the folded frames in src.
template <int R, int kLayout, bool kFromStage>
__device__ __forceinline__ void fft_pass(const Pass& ps, int m,
                                         const float* stage,
                                         int frame_length,
                                         const float2* src, float2* dst,
                                         const float2* tw, int rows) {
  const int butterflies = rows * ps.step;
  for (int idx = threadIdx.x; idx < butterflies; idx += kThreads) {
    const int f = quotient(idx, ps.step_magic);
    const int j = idx - f * ps.step;
    const int k = j - quotient(j, ps.ns_magic) * ps.ns;
    float2 x[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int p = j + q * ps.step;
      if (kFromStage) {
        // one 8-byte load where the frame length is even (the rows and
        // the pair are then 8-byte aligned)
        const float* row = stage + f * frame_length;
        const int t = 2 * p;
        if (t + 1 >= frame_length) {
          x[q] = make_float2(t < frame_length ? row[t] : 0.0f, 0.0f);
        } else if (frame_length % 2 == 0) {
          x[q] = *reinterpret_cast<const float2*>(row + t);
        } else {
          x[q] = make_float2(row[t], row[t + 1]);
        }
      } else {
        x[q] = src[at<kLayout>(f * m + p)];
      }
    }
    if (ps.ns > 1) {
      const float2* w = tw + ps.twiddle + k;
#pragma unroll
      for (int q = 1; q < R; ++q) {
        x[q] = cmul(x[q], w[(q - 1) * ps.ns]);
      }
    }
    dft<R>(x);
    const int o = f * m + (j - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      dst[at<kLayout>(o + q * ps.ns)] = x[q];
    }
  }
}

template <int kLayout, bool kFromStage>
__device__ __forceinline__ void run_pass(const Pass& ps, int m,
                                         const float* stage,
                                         int frame_length,
                                         const float2* src, float2* dst,
                                         const float2* tw, int rows) {
  switch (ps.radix) {
    case 2:
      fft_pass<2, kLayout, kFromStage>(ps, m, stage, frame_length, src, dst,
                                       tw, rows);
      break;
    case 3:
      fft_pass<3, kLayout, kFromStage>(ps, m, stage, frame_length, src, dst,
                                       tw, rows);
      break;
    case 4:
      fft_pass<4, kLayout, kFromStage>(ps, m, stage, frame_length, src, dst,
                                       tw, rows);
      break;
    case 5:
      fft_pass<5, kLayout, kFromStage>(ps, m, stage, frame_length, src, dst,
                                       tw, rows);
      break;
    case 7:
      fft_pass<7, kLayout, kFromStage>(ps, m, stage, frame_length, src, dst,
                                       tw, rows);
      break;
    case 8:
      fft_pass<8, kLayout, kFromStage>(ps, m, stage, frame_length, src, dst,
                                       tw, rows);
      break;
    default:
      fft_pass<16, kLayout, kFromStage>(ps, m, stage, frame_length, src,
                                        dst, tw, rows);
  }
}

// kStaged: the frames are no longer than n_fft and are staged by cp.async
// into one of two staging buffers while the other group is transformed;
// otherwise (a frame longer than n_fft, or the staging buffers do not fit)
// they are folded into buf by plain loads.  Either way the passes then go
// back and forth between buf and the group's staging buffer, whose frames
// the first pass has read (each holds a group's points), and the split
// step writes the group's power rows, M + 1 floats a frame, into the one
// that the last pass read.
template <int kLayout, bool kStaged>
__global__ void __launch_bounds__(kThreads, kBlocksAnSm)
    logmel_fft_mixed_kernel(
    const float* __restrict__ frames,    // (n, frame_length)
    const float2* __restrict__ twiddles,  // (n_twiddles,) see make_plan
    const float* __restrict__ weights,   // (n_weights,) the bands' weights
    const int4* __restrict__ bands,      // (n_mels,): lo, hi, offset, 0
    float* __restrict__ out,             // (n, n_mels)
    int n, int frame_length, int n_mels, int n_twiddles, int n_weights,
    int stage_floats, int buf_float2s, bool vec, float scale_sq,
    const Plan plan_arg) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Plan plan;  // the later passes' parameters, read by pass index
  if (threadIdx.x == 0) {
    plan = plan_arg;
  }
  const int m = plan_arg.m;
  const int n_fft = plan_arg.n_fft;
  const int group_frames = plan_arg.group;
  int4* band_s = reinterpret_cast<int4*>(smem);
  float* staged = reinterpret_cast<float*>(band_s + n_mels);
  float2* tw = reinterpret_cast<float2*>(staged +
                                         (kStaged ? 2 : 1) * stage_floats);
  float2* buf = tw + n_twiddles;
  float* weight_s = reinterpret_cast<float*>(buf + buf_float2s);
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
  const float2* split_tw = tw + n_twiddles - plan_arg.pairs;
  const float out_scale = 0.25f * scale_sq;  // 4 |X|^2 from the split step

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
      // written as the floats of z at their places in buf
      const float* src = frames + group * group_stride;
      float* x = reinterpret_cast<float*>(buf);
      for (int i = threadIdx.x; i < rows * n_fft; i += kThreads) {
        const int f = quotient(i, plan_arg.fft_magic);
        const int s = i - f * n_fft;
        const float* row = src + static_cast<size_t>(f) * frame_length;
        float sum = 0.0f;
        for (int t = s; t < frame_length; t += n_fft) {
          sum += row[t];
        }
        x[2 * at<kLayout>(f * m + (s >> 1)) + (s & 1)] = sum;
      }
    }
    __syncthreads();  // the frames (and, the first time, the tables) are in

    // the staged path's first pass reads the frames in `cur` and writes
    // buf; the folded path's reads buf and writes `cur`; then each pass
    // reads what the last one wrote and writes the other buffer
    float2* const bufs[2] = {buf, reinterpret_cast<float2*>(cur)};
    int last = kStaged ? 0 : 1;  // the buffer the last pass wrote
    run_pass<kLayout, kStaged>(plan_arg.pass[0], m, cur, frame_length, buf,
                               bufs[last], tw, rows);
    for (int p = 1; p < plan_arg.passes; ++p) {
      __syncthreads();
      run_pass<kLayout, false>(plan.pass[p], m, nullptr, frame_length,
                               bufs[last], bufs[last ^ 1], tw, rows);
      last ^= 1;
    }
    __syncthreads();

    // split step: the power of bins k and M - k (and, for k = 0 and even M,
    // M / 2) into the group's power rows, in the buffer the last pass read
    const float2* z = bufs[last];
    float* power = reinterpret_cast<float*>(bufs[last ^ 1]);
    const int pairs = plan_arg.pairs;
    for (int idx = threadIdx.x; idx < rows * pairs; idx += kThreads) {
      const int f = quotient(idx, plan_arg.pairs_magic);
      const int k = idx - f * pairs;
      float* p = power + f * (m + 1);
      const float2 za = z[at<kLayout>(f * m + k)];
      const float2 zb = z[at<kLayout>(f * m + (k ? m - k : 0))];
      const float2 s = make_float2(za.x + zb.x, za.y - zb.y);
      const float2 d = make_float2(za.y + zb.y, zb.x - za.x);
      const float2 wd = cmul(split_tw[k], d);
      const float2 x0 = add(s, wd);
      const float2 x1 = sub(s, wd);
      p[k] = x0.x * x0.x + x0.y * x0.y;
      p[m - k] = x1.x * x1.x + x1.y * x1.y;
      if (k == 0 && m % 2 == 0) {  // bin M / 2: 4 |X|^2 = 4 |Z[M/2]|^2
        const float2 zh = z[at<kLayout>(f * m + m / 2)];
        p[m / 2] = 4.0f * (zh.x * zh.x + zh.y * zh.y);
      }
    }
    __syncthreads();

    // the mel product over each filter's nonzero band, kMelFrames frames a
    // thread, then the log
    const int quads = (rows + kMelFrames - 1) / kMelFrames;
    for (int i = threadIdx.x; i < quads * n_mels; i += kThreads) {
      const int quad = quotient(i, plan_arg.mel_magic);
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

// the float2 a group's points take in a layout
int buf_float2s_for(int layout, int points) {
  return layout ? (points + 15) / 16 * 16 : points;
}

// The floats of one staging buffer: the group's frames where they are
// staged, its points (`buf_float2s` float2) and its power rows (M + 1
// floats a frame); a multiple of 16 bytes.
int stage_floats_for(bool staged, const Plan& plan, int frame_length,
                     int buf_float2s) {
  int floats = plan.group * (plan.m + 1);
  floats = floats > 2 * buf_float2s ? floats : 2 * buf_float2s;
  if (staged && plan.group * frame_length > floats) {
    floats = plan.group * frame_length;
  }
  return (floats + 3) / 4 * 4;
}

size_t smem_bytes(bool staged, int n_mels, int n_twiddles, int n_weights,
                  int stage_floats, int buf_float2s) {
  return sizeof(int4) * n_mels +
         sizeof(float) * (staged ? 2 : 1) * stage_floats +
         sizeof(float2) * (n_twiddles + buf_float2s) +
         sizeof(float) * n_weights;
}

using Kernel = void (*)(const float*, const float2*, const float*,
                        const int4*, float*, int, int, int, int, int, int,
                        int, bool, float, const Plan);

// The kernel's variants: layout and staging.
constexpr int kVariants = kLayouts * 2;

Kernel kernel_for(int variant) {
  switch (variant) {
    case 0: return logmel_fft_mixed_kernel<0, false>;
    case 1: return logmel_fft_mixed_kernel<0, true>;
    case 2: return logmel_fft_mixed_kernel<1, false>;
    default: return logmel_fft_mixed_kernel<1, true>;
  }
}

// The SM count and, for each variant of the kernel, the blocks an SM holds
// at the shared memory last asked for, per device: queried once, since the
// queries cost host time on every launch.
struct Occupancy {
  int sms = 0;
  size_t smem[kVariants] = {};
  int per_sm[kVariants] = {};
};
std::mutex occupancy_mutex;
Occupancy occupancy[kMaxDevices];

cudaError_t resident_blocks(int variant, size_t smem, int* blocks) {
  const Kernel kernel = kernel_for(variant);
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
  if (o.smem[variant] != smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &o.per_sm[variant], kernel, kThreads, smem);
    }
    if (err != cudaSuccess) {
      o.smem[variant] = 0;
      return err;
    }
    o.smem[variant] = smem;
  }
  *blocks = o.sms * (o.per_sm[variant] > 0 ? o.per_sm[variant] : 1);
  return cudaSuccess;
}

}  // namespace

// The range of n_fft the kernel takes (the even n_fft from min_fft to
// max_fft that are not powers of two and whose half has no prime factor
// above 7) and the threads of a block, which the caller's choice of group
// counts on.
extern "C" void odin_logmel_fft_mixed_limits(int* min_fft, int* max_fft,
                                             int* threads) {
  *min_fft = kMinFft;
  *max_fft = kMaxFft;
  *threads = kThreads;
}

// The kernel's passes at n_fft: writes their radices, in order, to
// `radices` (room for 12) and returns their count, or 0 where the kernel
// does not take n_fft.
extern "C" int odin_logmel_fft_mixed_plan(int n_fft, int* radices) {
  Plan plan;
  int count = 0;
  if (!make_plan(n_fft, &plan, &count)) {
    return 0;
  }
  for (int p = 0; p < plan.passes; ++p) {
    radices[p] = plan.pass[p].radix;
  }
  return plan.passes;
}

// The length of the twiddle table at n_fft (float2 entries), or 0 where
// the kernel does not take n_fft.
extern "C" int odin_logmel_fft_mixed_twiddle_count(int n_fft) {
  Plan plan;
  int count = 0;
  return make_plan(n_fft, &plan, &count) ? count : 0;
}

// Launches K1's mixed-radix FFT kernel on `stream`.  Allocates nothing and
// does not synchronise.  `twiddles` is the table of
// odin_logmel_fft_mixed_twiddle_count entries; `bands` gives each mel
// filter's nonzero bins [lo, hi) and the offset of their weights in
// `weights`; `group` (frames a block transforms at once) and `layout` (0
// plain, 1 swizzled) are the caller's choice (`mixed_geometry`,
// ops/logmel.py).  Returns 0, or a CUDA error.
extern "C" int odin_logmel_fft_mixed(const void* frames, const void* twiddles,
                                     const void* weights, const void* bands,
                                     void* out, int n, int frame_length,
                                     int n_fft, int n_mels, int n_weights,
                                     int group, int layout, float scale_sq,
                                     void* stream) {
  Plan plan;
  int n_twiddles = 0;
  if (n <= 0 || frame_length <= 0 || n_mels <= 0 || n_weights < 0 ||
      !make_plan(n_fft, &plan, &n_twiddles) || group < 1 ||
      group > kMaxGroupPoints / plan.m || layout < 0 || layout >= kLayouts ||
      reinterpret_cast<size_t>(bands) % 16 != 0 ||
      reinterpret_cast<size_t>(twiddles) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  plan.group = group;
  plan.pairs_magic = magic(plan.pairs);
  plan.fft_magic = magic(n_fft);
  plan.mel_magic = magic(n_mels);
  // every quotient the kernel takes is exact (`magic`)
  const int quads = (group + kMelFrames - 1) / kMelFrames;
  bool exact = fits(static_cast<long long>(group) * plan.pairs, plan.pairs) &&
               fits(static_cast<long long>(group) * n_fft, n_fft) &&
               fits(static_cast<long long>(quads) * n_mels, n_mels);
  for (int p = 0; p < plan.passes; ++p) {
    exact = exact && fits(static_cast<long long>(group) * plan.pass[p].step,
                          plan.pass[p].step) &&
            fits(plan.pass[p].step, plan.pass[p].ns);
  }
  if (!exact) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int buf_float2s = buf_float2s_for(layout, group * plan.m);
  // the frames staged where they are no longer than n_fft and fit
  bool staged = frame_length <= n_fft;
  int stage_floats = stage_floats_for(staged, plan, frame_length, buf_float2s);
  if (staged && smem_bytes(true, n_mels, n_twiddles, n_weights, stage_floats,
                           buf_float2s) > kSmemBytes) {
    staged = false;
    stage_floats = stage_floats_for(false, plan, frame_length, buf_float2s);
  }
  const size_t smem = smem_bytes(staged, n_mels, n_twiddles, n_weights,
                                 stage_floats, buf_float2s);
  if (smem > kSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int resident = 0;
  const int variant = layout * 2 + staged;
  cudaError_t err = resident_blocks(variant, smem, &resident);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  // 16-byte copies where every group's frames start on 16 bytes
  const bool vec = reinterpret_cast<size_t>(frames) % 16 == 0 &&
                   group * frame_length % 4 == 0;
  const int n_groups = (n + group - 1) / group;
  const int blocks = n_groups < resident ? n_groups : resident;
  kernel_for(variant)<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float2*>(twiddles),
      static_cast<const float*>(weights), static_cast<const int4*>(bands),
      static_cast<float*>(out), n, frame_length, n_mels, n_twiddles,
      n_weights, stage_floats, buf_float2s, vec, scale_sq, plan);
  return static_cast<int>(cudaGetLastError());
}
