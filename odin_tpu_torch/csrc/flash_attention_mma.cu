// K2 for 16-bit inputs: flash attention forward on the tensor cores, sm_90a.
//
// Replaces `_flash_kernel` (odin_tpu/ops/pallas_attention.py:35, launched by
// `_flash_forward`) for bfloat16 and float16 q, k and v.  For each (batch,
// head) and query row i:
//   s_ij = (q_i . k_j) * scale            for the valid keys j
//   o_i  = sum_j exp(s_ij - m_i) v_j / sum_j exp(s_ij - m_i)
// A key j is valid when j < Tk and, under `causal`, when i >= j (top-left
// alignment, as in the TPU kernel).  A row with no valid key gives 0.  The
// output has the inputs' type.
//
// Numbers.  The TPU kernel takes the scores from 16-bit q and k with fp32
// accumulation, keeps p in fp32 and multiplies it with v widened to fp32.
// Here both products run on the tensor cores (wgmma, fp32 accumulation); a
// product of two 16-bit values is exact in fp32, so the scores differ from
// the plain version only in the order of the sums.  The running max, the
// running sum, the exp2 of the prescaled scores and the output accumulator
// are fp32 registers.  p enters the second product as two 16-bit parts,
// hi = round16(p) and lo = round16(p - hi), each multiplied with the same V
// tile, so p loses about 2^-18 of itself (bf16) where one rounding would
// lose 2^-9; the row sum is taken over the fp32 p.  That doubles the P.V
// work.
//
// Bound on an H100 SXM at the repo's benchmark width (B 4, H 8, T 4096,
// D 64): the two products are 4 B H Tq Tk D = 1.37e11 flop, 0.139 ms at
// 989 TFLOP/s of dense 16-bit tensor-core work, against 67 MB of q, k, v
// and o, 0.020 ms at 3.35 TB/s.  So the kernel is bound by operations; the
// hi/lo split makes the work it issues 1.5 times the bound's.  On the card
// (tools/k2_ablation.py) the products and the softmax run one after the
// other rather than under each other, which keeps the kernel at about four
// times the bound; PERF.md has the numbers.
//
// Design: a block of two warpgroups (8 warps) owns 128 queries of one
// (batch, head), 64 a warpgroup, and loops over the key tiles itself, since
// Hopper's blocks run in no order.  Q is staged once in shared memory; K and
// V tiles (128 keys at DP <= 128, 64 at DP 256) come into a ring of two
// stages, so the copy of tile kt + 1 runs under the products of tile kt.
// One thread stages each tile by TMA (cp.async.bulk.tensor, one box of 64
// columns per column block) and an mbarrier counts its bytes; the other
// threads only wait on it.  TMA's 128-byte swizzle puts every tile in
// wgmma's layout: 64-wide column blocks of rows of 128 bytes, the 16-byte
// chunk c of row r at c ^ (r % 8), each tile 1024-byte aligned; rows past
// Tq or Tk and columns past D land as zeros, so the caller pads nothing.
// Where D is not a multiple of 8 or a base is not 16-byte aligned (TMA
// cannot take them), every thread stages the tiles by plain loads into the
// same layout.  A warpgroup computes its 64 x kBlockK scores with wgmma
// m64n64k16 from shared memory (Q and K both K-major), takes the softmax in
// registers, and multiplies P (its score accumulators, rounded to hi and lo,
// are wgmma's A fragments in registers) with V read from shared memory as
// an MN-major operand.  The head dim is padded with zeros to DP (64, 128 or
// 256, a template argument).  Above 256 the launch covers one 256-wide
// chunk of V's and O's columns (the caller launches once per chunk) and
// takes the scores over D in 256-wide chunks of Q and K staged in turn;
// each launch computes the scores anew.  Only the key tiles that hold
// padded keys or meet the causal diagonal are masked.  The exponentials are
// exp2 of one FFMA, s * scale - m * scale, with the row max m of the scores
// (a negative sm_scale negates the scores first).  Under `causal` the loop
// stops at the last key tile that meets the diagonal of the block's last
// valid row.  The row max starts at -inf; a row whose keys so far are all
// masked keeps m = -inf, and its exponentials are taken against 0, so no
// -inf - (-inf) appears.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBlockQ = 128;   // queries per block, 64 a warpgroup
constexpr int kMaxDim = 256;   // the widest DP

// keys per tile: 64 at DP 256 keeps the output accumulator (128 floats a
// thread) and the score tile inside the register file
template <int DP>
__host__ __device__ constexpr int block_k() {
  return DP >= 256 ? 64 : 128;
}

template <int DP>
__host__ __device__ constexpr int smem_bytes() {
  // Q, two stages of K and V, and room to align the tiles to 1024 bytes
  return 2 * (kBlockQ * DP + 4 * block_k<DP>() * DP) + 1024;
}

// the element (row, 8 * chunk) of a tile of kRows rows in wgmma's
// 128-byte-swizzled layout: 64-wide column blocks, rows of 128 bytes
template <int kRows>
__device__ __forceinline__ int swz(int row, int chunk) {
  return (chunk / 8) * kRows * 64 + row * 64 +
         (((chunk % 8) ^ (row & 7)) << 3);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the arrival that expects `bytes` more to land before the phase completes
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// waits for the phase of parity `parity` to complete; a copy that never
// lands traps after about 4 s rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) {
      return;
    }
    if (clock64() - start > (1ll << 33)) {
      __trap();
    }
  }
}

// one TMA box (64 columns x the map's box rows) at (x, y, z) of `map` into
// dst, its bytes counted on `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int x, int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
      "r"(smem_addr(bar))
      : "memory");
}

// the generic proxy's writes to shared memory (the plain stores) made
// visible to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    asm volatile("" : "+f"(r[i])::"memory");
  }
}

// a shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1
__device__ __forceinline__ uint64_t desc(const uint16_t* p, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 x 64, fp32, the warpgroup's) = a (64 x 16, shared, K-major) .
// b (16 x 64, shared, K-major) + (scale_d ? d : 0); and d += a (registers)
// . b (shared, MN-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d, __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d, __half) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, __half) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

// (x, y) rounded to two 16-bit values in one register, x in the low half;
// `rx`, `ry` get them back as fp32
__device__ __forceinline__ uint32_t pack(float x, float y, float& rx,
                                         float& ry, __nv_bfloat16) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  rx = f.x;
  ry = f.y;
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack(float x, float y, float& rx,
                                         float& ry, __half) {
  const __half2 h = __floats2half2_rn(x, y);
  const float2 f = __half22float2(h);
  rx = f.x;
  ry = f.y;
  return *reinterpret_cast<const uint32_t*>(&h);
}

// p (fp32) as hi + lo, two 16-bit values each
template <typename T>
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  float hx, hy, unused_x, unused_y;
  hi = pack(x, y, hx, hy, T());
  lo = pack(x - hx, y - hy, unused_x, unused_y, T());
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// Rows [row0, row0 + kRows) of a row-major matrix with row stride `ld`,
// columns [0, DP) of which the first `ncols` are valid, into a tile in the
// layout swz<kRows>, zero past n_rows and past ncols, by plain 16-bit loads
// stored at once: the staging where TMA cannot be used (D not a multiple
// of 8, or a pointer not 16-byte aligned).
template <int DP, int kRows>
__device__ __forceinline__ void load_tile(uint16_t* dst,
                                          const uint16_t* __restrict__ src,
                                          int row0, int n_rows, int ld,
                                          int ncols) {
  constexpr int kChunks = DP / 8;
  static_assert(kRows * kChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll 1
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int gr = row0 + r;
    uint16_t x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      x[e] = gr < n_rows && 8 * c + e < ncols
                 ? src[static_cast<size_t>(gr) * ld + 8 * c + e]
                 : uint16_t(0);
    }
    uint4 w;
    w.x = x[0] | (static_cast<uint32_t>(x[1]) << 16);
    w.y = x[2] | (static_cast<uint32_t>(x[3]) << 16);
    w.z = x[4] | (static_cast<uint32_t>(x[5]) << 16);
    w.w = x[6] | (static_cast<uint32_t>(x[7]) << 16);
    *reinterpret_cast<uint4*>(dst + swz<kRows>(r, c)) = w;
  }
}

// A tile of kRows rows from y and DP columns from x of (D, T, BH) `map` at
// z into dst (layout swz<kRows>), one 64-column TMA box per column block;
// rows past T and columns past D land as zeros
template <int DP, int kRows>
__device__ __forceinline__ void tma_tile(uint16_t* dst, const CUtensorMap* map,
                                         int x, int y, int z, uint64_t* bar) {
#pragma unroll
  for (int cb = 0; cb < DP / 64; ++cb) {
    tma_box(dst + cb * kRows * 64, map, x + 64 * cb, y, z, bar);
  }
}

// s (this warpgroup's 64 queries x kBlockK keys, as kBlockK / 64 n64
// accumulators) = Q . K^T over DP columns, or += where `accumulate`
template <int DP, typename T>
__device__ __forceinline__ void scores(float (&s)[block_k<DP>() / 64][32],
                                       const uint16_t* qs,
                                       const uint16_t* ks, int wg,
                                       bool accumulate) {
  constexpr int kBlockK = block_k<DP>();
#pragma unroll
  for (int n = 0; n < kBlockK / 64; ++n) {
    fence_regs(s[n]);
  }
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    // k16 step kc: in column block kc / 4, 16 elements (32 bytes) a step;
    // the warpgroup's 64 rows of Q, the keys 64 n .. 64 n + 63 of K
    const int cb = kc / 4;
    const int kk = 16 * (kc % 4);
    const uint64_t a = desc(qs + cb * kBlockQ * 64 + 64 * wg * 64 + kk, 16,
                            1024);
#pragma unroll
    for (int n = 0; n < kBlockK / 64; ++n) {
      const uint64_t b = desc(ks + cb * kBlockK * 64 + 64 * n * 64 + kk, 16,
                              1024);
      wgmma_ss(s[n], a, b, accumulate || kc > 0 ? 1 : 0, T());
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int n = 0; n < kBlockK / 64; ++n) {
    fence_regs(s[n]);
  }
}

// With `tma`, q, k and v come in through the tensor maps (their own
// pointers unused) and one thread stages each tile; else by every thread's
// plain loads.
template <int DP, bool kChunked, typename T>
__global__ void __launch_bounds__(kThreads, 1) flash_mma_kernel(
    const __grid_constant__ CUtensorMap tq,  // (D, Tq, BH) boxes of 64 x 128
    const __grid_constant__ CUtensorMap tk,  // (D, Tk, BH), 64 x kBlockK
    const __grid_constant__ CUtensorMap tv,  // (D, Tk, BH), 64 x kBlockK
    const uint16_t* __restrict__ q,  // (BH, Tq, D)
    const uint16_t* __restrict__ k,  // (BH, Tk, D)
    const uint16_t* __restrict__ v,  // (BH, Tk, D), from this launch's column
    T* __restrict__ o,               // (BH, Tq, D), from this launch's column
    int col0, int n_q_tiles, int Tq, int Tk, int D, int Dv,
    float scale_log2e, int negate, int causal, int tma) {
  constexpr int kBlockK = block_k<DP>();
  constexpr int kNS = kBlockK / 64;  // n64 accumulators of the scores
  constexpr int kNO = DP / 64;       // n64 accumulators of the output
  constexpr int kTile = kBlockK * DP;
  extern __shared__ uint8_t smem_raw[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  uint16_t* ks = qs + kBlockQ * DP;  // 2 x kBlockK x DP
  uint16_t* vs = ks + 2 * kTile;     // 2 x kBlockK x DP

  const int bh = blockIdx.x / n_q_tiles;
  const int q0 = (blockIdx.x % n_q_tiles) * kBlockQ;
  q += static_cast<size_t>(bh) * Tq * D;
  k += static_cast<size_t>(bh) * Tk * D;
  v += static_cast<size_t>(bh) * Tk * D;
  o += static_cast<size_t>(bh) * Tq * D;
  const int wg = threadIdx.x / 128;         // warpgroup: queries 64 wg + ..
  const int wq = (threadIdx.x % 128) / 32;  // its warp: 16 of them
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // rows g and g + 8 of the warp's 16
  const int t = lane % 4;  // columns 2 t, 2 t + 1 of each 8
  const int w0 = q0 + 64 * wg + 16 * wq;  // the warp's first query
  const bool use_tma = tma != 0;
  __shared__ uint64_t bars[4];  // the stages' tiles, Q, Q and K chunks
  if (use_tma && threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mbar_init(&bars[i]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int last_q = min(q0 + kBlockQ, Tq) - 1;
  int n_k_tiles = (Tk + kBlockK - 1) / kBlockK;
  if (causal) {
    n_k_tiles = min(n_k_tiles, last_q / kBlockK + 1);
  }
  // tile kt into stage kt & 1: its K (unless chunked) and V
  auto load_kv = [&](int kt) {
    uint16_t* kd = ks + (kt & 1) * kTile;
    uint16_t* vd = vs + (kt & 1) * kTile;
    if (use_tma) {
      if (threadIdx.x == 0) {
        uint64_t* bar = &bars[kt & 1];
        mbar_expect(bar, (kChunked ? 2 : 4) * kTile);
        if (!kChunked) {
          tma_tile<DP, kBlockK>(kd, &tk, 0, kt * kBlockK, bh, bar);
        }
        tma_tile<DP, kBlockK>(vd, &tv, col0, kt * kBlockK, bh, bar);
      }
    } else {
      if (!kChunked) {
        load_tile<DP, kBlockK>(kd, k, kt * kBlockK, Tk, D, D);
      }
      load_tile<DP, kBlockK>(vd, v, kt * kBlockK, Tk, D, Dv);
    }
  };
  if (!kChunked) {
    if (use_tma) {
      if (threadIdx.x == 0) {
        mbar_expect(&bars[2], 2 * kBlockQ * DP);
        tma_tile<DP, kBlockQ>(qs, &tq, 0, q0, bh, &bars[2]);
      }
    } else {
      load_tile<DP, kBlockQ>(qs, q, q0, Tq, D, D);
    }
  }
  if (n_k_tiles > 0) {
    load_kv(0);
  }
  if (n_k_tiles > 1) {
    load_kv(1);
  }
  if (use_tma && !kChunked) {
    mbar_wait(&bars[2], 0);
  }
  int chunk_parity = 0;

  float acc[kNO][32];
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[n][i] = 0.0f;
    }
  }
  float m[2] = {-INFINITY, -INFINITY};  // the row max of the scores
  float l[2] = {0.0f, 0.0f};            // this thread's share of the row sums

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    if (use_tma) {
      mbar_wait(&bars[kt & 1], (kt >> 1) & 1);  // tile kt is in
    } else {
      fence_proxy_async();  // the plain stores, made visible to wgmma
      __syncthreads();
    }
    uint16_t* kst = ks + (kt & 1) * kTile;
    const uint16_t* vst = vs + (kt & 1) * kTile;

    float s[kNS][32];
    if (kChunked) {
      // the scores over D in DP-wide chunks of Q and K, staged in turn into
      // Q's tile and this stage's K tile (the ring copies only V here)
      for (int c0 = 0; c0 < D; c0 += DP) {
        __syncthreads();  // the previous chunk is read
        if (use_tma) {
          if (threadIdx.x == 0) {
            mbar_expect(&bars[3], 2 * (kBlockQ * DP + kTile));
            tma_tile<DP, kBlockQ>(qs, &tq, c0, q0, bh, &bars[3]);
            tma_tile<DP, kBlockK>(kst, &tk, c0, kt * kBlockK, bh, &bars[3]);
          }
          mbar_wait(&bars[3], chunk_parity);
          chunk_parity ^= 1;
        } else {
          load_tile<DP, kBlockQ>(qs, q + c0, q0, Tq, D, D - c0);
          load_tile<DP, kBlockK>(kst, k + c0, kt * kBlockK, Tk, D, D - c0);
          fence_proxy_async();
          __syncthreads();
        }
        scores<DP, T>(s, qs, kst, wg, c0 > 0);
      }
    } else {
      scores<DP, T>(s, qs, kst, wg, false);
    }

    // accumulator i of block n: row g + 8 (i % 4 / 2) of the warp's 16,
    // key 64 n + 8 (i / 4) + 2 t + i % 2 of the tile
    if (negate) {
#pragma unroll
      for (int n = 0; n < kNS; ++n) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[n][i] = -s[n][i];
        }
      }
    }
    // mask where the tile holds padded keys or meets the causal diagonal
    const int k0 = kt * kBlockK;
    if (k0 + kBlockK > Tk || (causal && k0 + kBlockK - 1 > w0)) {
#pragma unroll
      for (int n = 0; n < kNS; ++n) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qi = w0 + g + 8 * (i % 4 / 2);
          const int kj = k0 + 64 * n + 8 * (i / 4) + 2 * t + i % 2;
          if (kj >= Tk || (causal && qi < kj)) {
            s[n][i] = -INFINITY;
          }
        }
      }
    }
    // the online softmax in base 2: p = exp2(s * scale - m * scale), one
    // FFMA and one exp2 a score
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNS; ++n) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        mx[i % 4 / 2] = fmaxf(mx[i % 4 / 2], s[n][i]);
      }
    }
    float m_scaled[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_scaled[r] = m_new == -INFINITY ? 0.0f : m_new * scale_log2e;
      alpha[r] = exp2f(m[r] * scale_log2e - m_scaled[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kNS; ++n) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[n][i] = exp2f(fmaf(s[n][i], scale_log2e, -m_scaled[i % 4 / 2]));
        l[i % 4 / 2] += s[n][i];
      }
    }
#pragma unroll
    for (int n = 0; n < kNO; ++n) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc[n][i] *= alpha[i % 4 / 2];
      }
      fence_regs(acc[n]);
    }

    // acc += P V: the score accumulators of keys 16 j .. 16 j + 15 are, as
    // hi and lo, the warpgroup's A fragments of P in registers; all of them
    // are made before the first wgmma, which reads its A registers
    // asynchronously
    uint32_t hi[kBlockK / 16][4], lo[kBlockK / 16][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      const int n = j / 4;
      const int i = 8 * (j % 4);
      split<T>(s[n][i], s[n][i + 1], hi[j][0], lo[j][0]);
      split<T>(s[n][i + 2], s[n][i + 3], hi[j][1], lo[j][1]);
      split<T>(s[n][i + 4], s[n][i + 5], hi[j][2], lo[j][2]);
      split<T>(s[n][i + 6], s[n][i + 7], hi[j][3], lo[j][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        // V's keys 16 j .. 16 j + 15 (two groups of 8 rows, 1024 bytes
        // apart) and columns 64 n .. 64 n + 63, as an MN-major operand
        const uint64_t b =
            desc(vst + n * kBlockK * 64 + 16 * j * 64, kBlockK * 128, 1024);
        wgmma_rs(acc[n], hi[j], b, T());
        wgmma_rs(acc[n], lo[j], b, T());
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < kNO; ++n) {
      fence_regs(acc[n]);
    }
    __syncthreads();  // every warp is done with this stage
    if (kt + 2 < n_k_tiles) {
      load_kv(kt + 2);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = i % 4 / 2;
      const int qi = w0 + g + 8 * r;
      const int d = 64 * n + 8 * (i / 4) + 2 * t + i % 2;
      if (qi < Tq && d < Dv) {
        store(o + static_cast<size_t>(qi) * D + d,
              l[r] > 0.0f ? acc[n][i] / l[r] : 0.0f);
      }
    }
  }
}

CUtensorMapDataType map_type(__nv_bfloat16) {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
CUtensorMapDataType map_type(__half) { return CU_TENSOR_MAP_DATA_TYPE_FLOAT16; }

// A (D, T, bh) tensor map of `base` (row-major (bh, T, D), D a multiple of
// 8, base 16-byte aligned) with boxes of 64 columns x `rows` rows, swizzled
// by 128 bytes as wgmma reads them.  cuTensorMapEncodeTiled lives in
// libcuda; the runtime hands over its address, so nothing links libcuda.
template <typename T>
bool encode(CUtensorMap* map, const void* base, int D, int T_, int bh,
            int rows) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
      const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
      CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || p == nullptr) {
      return false;
    }
    fn = reinterpret_cast<Encode>(p);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T_),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {2ull * D, 2ull * D * T_};  // bytes
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, map_type(T()), 3, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, bool kChunked, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int Tq, int Tk, int D, int col0, float scale_log2e, int negate,
           int causal, int tma, cudaStream_t stream) {
  CUtensorMap mq = {}, mk = {}, mv = {};
  if (tma && (!encode<T>(&mq, q, D, Tq, bh, kBlockQ) ||
              (Tk > 0 && (!encode<T>(&mk, k, D, Tk, bh, block_k<DP>()) ||
                          !encode<T>(&mv, v, D, Tk, bh, block_k<DP>()))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<DP, kChunked, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int Dv = D - col0 < kMaxDim ? D - col0 : kMaxDim;
  const int n_q_tiles = (Tq + kBlockQ - 1) / kBlockQ;
  flash_mma_kernel<DP, kChunked, T><<<n_q_tiles * bh, kThreads, smem,
                                      stream>>>(
      mq, mk, mv, static_cast<const uint16_t*>(q),
      static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v) + col0, static_cast<T*>(o) + col0,
      col0, n_q_tiles, Tq, Tk, D, Dv, scale_log2e, negate, causal, tma);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int Tq, int Tk, int D, int col0, float scale_log2e, int negate,
             int causal, int tma, cudaStream_t s) {
  if (D <= 64) {
    return launch<64, false, T>(q, k, v, o, bh, Tq, Tk, D, col0, scale_log2e,
                                negate, causal, tma, s);
  }
  if (D <= 128) {
    return launch<128, false, T>(q, k, v, o, bh, Tq, Tk, D, col0,
                                 scale_log2e, negate, causal, tma, s);
  }
  if (D <= kMaxDim) {
    return launch<256, false, T>(q, k, v, o, bh, Tq, Tk, D, col0,
                                 scale_log2e, negate, causal, tma, s);
  }
  return launch<256, true, T>(q, k, v, o, bh, Tq, Tk, D, col0, scale_log2e,
                              negate, causal, tma, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

}  // namespace

// The widest head dim one launch covers; above it the caller launches once
// per chunk of this many columns.
extern "C" int odin_flash_attention_mma_max_dim() { return kMaxDim; }

// Launches the 16-bit K2 on `stream` over contiguous (bh, Tq, D) q and o and
// (bh, Tk, D) k and v, all bf16 (dtype 1) or all fp16 (dtype 2), for the
// columns [col0, col0 + max_dim) of v and o: col0 is 0 where D <= max_dim,
// else a multiple of max_dim below D.  Allocates nothing and does not
// synchronise.  Returns 0, or the CUDA error of the launch
// (cudaGetLastError()).
extern "C" int odin_flash_attention_mma(const void* q, const void* k,
                                        const void* v, void* o, int bh,
                                        int Tq, int Tk, int D, int col0,
                                        float sm_scale, int causal, int dtype,
                                        void* stream) {
  if (bh <= 0 || Tq <= 0 || Tk < 0 || D <= 0 || col0 < 0 || col0 >= D ||
      col0 % kMaxDim != 0 || (dtype != 1 && dtype != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // TMA needs rows of a multiple of 16 bytes and 16-byte aligned bases
  const int tma = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  // the kernel takes scale > 0: a negative one negates the scores, and 0
  // becomes the least normal float, under which every exp2 of a finite
  // score is 1
  const float scale_log2e =
      fmaxf(fabsf(sm_scale) * 1.4426950408889634f, FLT_MIN);
  const int negate = sm_scale < 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? dispatch<__nv_bfloat16>(q, k, v, o, bh, Tq, Tk, D, col0,
                                       scale_log2e, negate, causal, tma, s)
             : dispatch<__half>(q, k, v, o, bh, Tq, Tk, D, col0, scale_log2e,
                                negate, causal, tma, s);
}
