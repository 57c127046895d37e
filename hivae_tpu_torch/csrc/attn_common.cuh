// Shared device helpers for the attention kernels: 16-bit tensor-core MMA
// (mma.sync m16n8k16, fp32 accumulate) with the PTX-documented fragment
// layouts, the TF32 products of the fp32 kernels (m16n8k8 on a hi/lo
// split), wgmma, TMA and cluster helpers, and 16-byte tile loads from
// global to shared memory.
//
// The 16-bit element type `e16` is bf16, or fp16 where the source is
// compiled with -DHV_F16 (flash_attention.py builds each attention source
// both ways, into libraries of their own): the two have the same size, the
// same fragment layouts and the same mma / wgmma shapes, and differ only in
// the instructions' type suffix (HV_E16), the conversions below and the
// TMA element type, so one kernel source serves both.
//
// Head dims: a kernel is compiled for a tile width D (its template
// argument) and serves every head dim hd <= D that is a multiple of 8 (the
// caller's `hd`): loads fill the columns at or past hd with zeros (a row of
// hd elements is a whole number of 16-byte chunks in 2-byte types and of
// 32-byte chunks in fp32), so they add nothing to Q.K^T, dO.V^T or delta,
// and stores write only the first hd columns.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16 / .f16), with g = lane / 4 and
// t = lane % 4:
//   A (16x16, row-major): reg0 = (row g,   k 2t..2t+1)  reg1 = (row g+8, k 2t..)
//                         reg2 = (row g,   k 2t+8..)    reg3 = (row g+8, k 2t+8..)
//   B (16x8, "col"):      reg0 = (k 2t..2t+1, col g)    reg1 = (k 2t+8.., col g)
//   C (16x8, fp32):       c0,c1 = (row g, col 2t, 2t+1) c2,c3 = (row g+8, same cols)
// Two C tiles of 8 columns side by side are exactly one A fragment of a
// 16-wide k step, which is how the probabilities P feed the P.V product
// without a trip through shared memory.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hv {

#ifdef HV_F16
using e16 = __half;
using e16x2 = __half2;
#define HV_E16 "f16"
constexpr CUtensorMapDataType E16_TMAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
__device__ __forceinline__ e16x2 to_e16x2(float lo, float hi) {
  return __floats2half2_rn(lo, hi);
}
__device__ __forceinline__ float2 from_e16x2(e16x2 v) {
  return __half22float2(v);
}
__device__ __forceinline__ float from_e16(e16 x) { return __half2float(x); }
__device__ __forceinline__ e16 to_e16(float x) { return __float2half_rn(x); }
#else
using e16 = __nv_bfloat16;
using e16x2 = __nv_bfloat162;
#define HV_E16 "bf16"
constexpr CUtensorMapDataType E16_TMAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
__device__ __forceinline__ e16x2 to_e16x2(float lo, float hi) {
  return __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ float2 from_e16x2(e16x2 v) {
  return __bfloat1622float2(v);
}
__device__ __forceinline__ float from_e16(e16 x) { return __bfloat162float(x); }
__device__ __forceinline__ e16 to_e16(float x) { return __float2bfloat16_rn(x); }
#endif

// The tile width (template D) a kernel runs head dim d at: the smallest
// of its widths >= d, or -1 where d is not a positive multiple of 8 or
// passes the widest (flash_attention.py::tile_plan mirrors both lists).
inline int pick_tile(int d, const int* tiles, int n) {
  if (d <= 0 || d % 8) return -1;
  for (int i = 0; i < n; ++i)
    if (d <= tiles[i]) return tiles[i];
  return -1;
}

inline int full_block_tile(int d) {
  static const int tiles[] = {32, 64, 96, 128};
  return pick_tile(d, tiles, 4);
}

// Past 640 the tiles are the multiples of 256 up to 2048, each run by a
// cluster of tile / 256 CTAs of 256 columns (attn_wide.cuh).
inline int stream_tile(int d) {
  static const int tiles[] = {64,  128,  256,  512,  640,  768,
                              1024, 1280, 1536, 1792, 2048};
  return pick_tile(d, tiles, 11);
}

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32." HV_E16 "." HV_E16 ".f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats rounded to e16, `lo` in the low half (the lower k index).
__device__ __forceinline__ uint32_t pack_e16(float lo, float hi) {
  e16x2 v = to_e16x2(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes global -> shared without passing through registers (cp.async,
// sm_80+). With `valid` false nothing is read and the 16 bytes are zeroed;
// `src` must still be a mapped address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Rows [row0, row0 + NROWS) of an (S, hd) e16 matrix whose rows are `rs`
// elements apart, into a shared tile of D columns with leading dimension
// ld; rows at or past S and columns at or past hd are zero-filled so that
// ragged edges contribute nothing. Every
// copy of the tile is issued before any completes (asynchronous cp.async),
// so the tile costs one memory latency, not one per copy; wait for the
// copies and synchronise the CTA before reading it.
template <int D, int NROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(e16* dst, int ld, const e16* src,
                                          long rs, int row0, int S, int tid,
                                          int hd) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  static_assert((NROWS * VPR) % NTHREADS == 0, "tile not a whole number of "
                                               "copies per thread");
#pragma unroll
  for (int it = 0; it < NROWS * VPR / NTHREADS; ++it) {
    const int i = tid + it * NTHREADS;
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool valid = row0 + r < S && c < hd;
    cp_async16(dst + r * ld + c,
               src + (valid ? (long)(row0 + r) * rs + c : 0), valid);
  }
}

// Element strides (batch, head, row) of one (B, H, S, D) tensor whose last
// dimension is contiguous.
struct Rows {
  long b, h, s;
};

template <typename T>
__device__ __forceinline__ T* head_ptr(T* base, Rows r, int b, int h) {
  return base + b * r.b + h * r.h;
}

// delta = rowsum(dO * O) in fp32 of row `row` of the (B, H, Sq) rows of
// dout and out (e16, hd <= D columns): 8 lanes a row, lane & 7 reads
// 16-byte chunks of both rows, a 3-step shuffle sums them and every lane of
// the 8 returns the sum. The whole warp calls it; a lane with row >= rows
// reads nothing and adds 0.
template <int D>
__device__ __forceinline__ float row_delta(const e16* dout, const e16* out,
                                           long row, long rows, int H, int Sq,
                                           Rows sdo, Rows so, int hd) {
  const int sub = threadIdx.x & 7;
  float acc = 0.f;
  if (row < rows) {
    const int s = (int)(row % Sq), h = (int)(row / Sq % H), b = (int)(row / Sq / H);
    const e16* dp = head_ptr(dout, sdo, b, h) + s * sdo.s;
    const e16* op = head_ptr(out, so, b, h) + s * so.s;
#pragma unroll
    for (int c = sub * 8; c < D; c += 64) {
      if (c >= hd) break;
      const uint4 x = *reinterpret_cast<const uint4*>(dp + c);
      const uint4 y = *reinterpret_cast<const uint4*>(op + c);
      const e16x2* xp = reinterpret_cast<const e16x2*>(&x);
      const e16x2* yp = reinterpret_cast<const e16x2*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = from_e16x2(xp[e]);
        const float2 yf = from_e16x2(yp[e]);
        acc = fmaf(xf.x, yf.x, acc);
        acc = fmaf(xf.y, yf.y, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc + __shfl_xor_sync(0xffffffffu, acc, 4);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Two e16 values of the fp32 accumulator pair (c0, c1) scaled by s, stored
// at p (4-byte aligned).
__device__ __forceinline__ void store_e16x2(e16* p, float c0, float c1,
                                            float s) {
  *reinterpret_cast<e16x2*>(p) = to_e16x2(c0 * s, c1 * s);
}

// The A fragment over a 16-wide k step built from two adjacent fp32 C tiles
// (columns k 0..7 in c_lo, 8..15 in c_hi), rounded to e16.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c_lo[4],
                                       const float c_hi[4]) {
  a[0] = pack_e16(c_lo[0], c_lo[1]);
  a[1] = pack_e16(c_lo[2], c_lo[3]);
  a[2] = pack_e16(c_hi[0], c_hi[1]);
  a[3] = pack_e16(c_hi[2], c_hi[3]);
}

// ---------------------------------------------------------------------------
// TF32 tensor-core products with a hi/lo split (the fp32 kernels: the
// streaming forward in flash_stream.cu, the full-block forward and backward
// and the streaming backward through attn_f32.cuh).
// ---------------------------------------------------------------------------

// x as hi + lo: hi = x rounded to TF32, to nearest with ties away from
// zero (cvt.rna.tf32.f32's rounding, in integer operations: the conversion
// pipe takes 8 cycles a warp instruction), its low 13 bits cleared so that
// x - hi is exact; lo = x - hi, which the mma reads as TF32 by its top 19
// bits (truncated: 2^-21 of x at most, below the fp32 gate by far).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a.b for a 16 x 8 x 8 TF32 product (PTX fragment layouts, g = lane
// / 4, t = lane % 4: a = (g, k t), (g + 8, k t), (g, k t + 4),
// (g + 8, k t + 4); b = (k t, n g), (k t + 4, n g); c as mma16816's). Not
// volatile: independent products may be scheduled around each other.
__device__ __forceinline__ void mma1688_tf32(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a.b, the same product into a fresh accumulator.
__device__ __forceinline__ void mma1688_tf32_z(float d[4],
                                               const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// ---------------------------------------------------------------------------
// Helpers of the pipelined full-block kernels (flash_full_block*.cu).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix x4: four 8x8 bf16 matrices from shared memory, one per register;
// lanes 8i..8i+7 give the row addresses of matrix i (16-byte aligned).
// Matrix i lands in r[i] in the mma fragment layout: lane holds row
// lane / 4, elements 2 (lane % 4) and 2 (lane % 4) + 1 (.trans: the
// transposed matrix, i.e. column lane / 4, rows 2 (lane % 4) and + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const e16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const e16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// This lane's element offset inside a 16 x 16 block of a row-major shared
// tile (leading dimension ld) for ldsm_x4 / ldsm_x4_t:
//  * ldsm_off_a: matrices (r, c), (r+8, c), (r, c+8), (r+8, c+8). With
//    ldsm_x4 that is the A fragment of rows r..r+16, k c..c+16. With
//    ldsm_x4_t on a (k, n) tile (keys x head dim) it is the B fragments of
//    two 8-wide n tiles: {r[0], r[1]} for n c..c+8, {r[2], r[3]} for c+8..
//  * ldsm_off_b: matrices (n, k), (n, k+8), (n+8, k), (n+8, k+8) of an
//    (n, k) tile (keys x head dim): with ldsm_x4 the B fragments of
//    B(k, n) = T[n][k] for two 8-wide n tiles, {r[0], r[1]} and {r[2], r[3]}.
__device__ __forceinline__ int ldsm_off_a(int lane, int ld) {
  return ((lane & 7) + (lane & 8)) * ld + ((lane & 16) >> 1);
}

__device__ __forceinline__ int ldsm_off_b(int lane, int ld) {
  return ((lane & 7) + ((lane & 16) >> 1)) * ld + (lane & 8);
}

// A multi-stage copy ring on cp.async commit groups: every thread issues
// its share of a job's copies with cp_async16 / cp_async4, then
// ring_commit() closes the job's group; ring_wait_upto(n) returns
// once at most n of this thread's groups are still in flight (groups
// complete in order, so every older job has landed), and a __syncthreads()
// after it publishes the job to the CTA.
__device__ __forceinline__ void ring_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void ring_wait_upto(int n) {
  switch (n <= 0 ? 0 : n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// 4 bytes global -> shared (cp.async.ca); zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Elements [i0, i0 + N) of an fp32 row of n elements into shared memory,
// zero past n (4-byte copies: the rows of a (B, S) or (B, H, S) array are
// not 16-byte aligned at S = 260 or 266).
template <int N, int NTHREADS>
__device__ __forceinline__ void load_row_f32(float* dst, const float* src,
                                             int i0, int n, int tid) {
  for (int i = tid; i < N; i += NTHREADS) {
    const bool valid = i0 + i < n;
    cp_async4(dst + i, src + (valid ? i0 + i : 0), valid);
  }
}

// The softmax probability, as both full-block kernels form it, in base 2:
// log2(e) is folded into the scale and the key bias, so one FMA gives the
// base-2 logit t = s * scale * log2(e) + bias * log2(e) of the raw Q.K^T
// product s, and P = 2^(t - m) * (1 / l) with m the row max of t and 1/l
// the reciprocal of the row's denominator, computed once per row. A key
// past Sk has bias_log2 = -inf and P = 0; under the -1e30 key mask every
// key of a fully masked row has the same t, so its P stays uniform.
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float scale_log2(float scale) {
  return __fmul_rn(scale, LOG2E);
}

__device__ __forceinline__ float bias_log2(float bias) {
  return __fmul_rn(bias, LOG2E);
}

__device__ __forceinline__ float attn_logit2(float s, float sl2, float bl2) {
  return fmaf(s, sl2, bl2);
}

__device__ __forceinline__ float attn_p(float s, float sl2, float bl2,
                                        float m_log2, float inv_l) {
  return ex2(attn_logit2(s, sl2, bl2) - m_log2) * inv_l;
}

// The streaming backward's P of a score s from the forward's natural-log
// LSE: exp(s * scale + bias - lse), in base 2. A row with no real key (the
// -1e30 key mask on every key) has every logit and its LSE at -1e30 in
// fp32, so that gives P = 1 on every key; the TPU streaming kernels do the
// same, and a caller of theirs gets it (keyless = 0). Where the JAX
// package would run its full-block kernel instead, whose softmax gives
// such a row the uniform 1 / Sk (the average its forward returned too),
// the caller passes keyless = 1 / Sk, and a row whose LSE is at the mask's
// level (at most KEYLESS_LSE, half of -1e30: a row with a real key has an
// LSE of the scores' size) takes that P.
constexpr float KEYLESS_LSE = -5e29f;

__device__ __forceinline__ float stream_p(float s, float scale, float bias,
                                          float lse, float keyless) {
  return keyless > 0.f && lse <= KEYLESS_LSE
             ? keyless
             : ex2((fmaf(s, scale, bias) - lse) * LOG2E);
}

// Two 8-wide n tiles (one 16-wide chunk starting at row n0 of T, an (n, k)
// tile of leading dimension ld) of the product A . T^T over KS k steps:
// s[i] += A . T[n0 + 8i .. n0 + 8i + 8]^T, A given as register fragments.
template <int KS>
__device__ __forceinline__ void mma_chunk_nk(float s[2][4],
                                             const uint32_t a[KS][4],
                                             const e16* T, int ld, int n0,
                                             int lane) {
  const e16* p = T + n0 * ld + ldsm_off_b(lane, ld);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, p + kk * 16);
    mma16816(s[0], a[kk], b);
    mma16816(s[1], a[kk], b + 2);
  }
}

// acc[dt] += A . T[k0 .. k0 + 16][8 dt .. 8 dt + 8] for every 8-wide n tile
// of the head dim D: A is one 16-wide k step (P or dS), T a (k, n) tile
// (keys x head dim) of leading dimension ld.
template <int D>
__device__ __forceinline__ void mma_rows_kn(float acc[D / 8][4],
                                            const uint32_t a[4],
                                            const e16* T, int ld, int k0,
                                            int lane) {
  const e16* p = T + k0 * ld + ldsm_off_a(lane, ld);
#pragma unroll
  for (int d2 = 0; d2 < D / 16; ++d2) {
    uint32_t b[4];
    ldsm_x4_t(b, p + d2 * 16);
    mma16816(acc[2 * d2], a, b);
    mma16816(acc[2 * d2 + 1], a, b + 2);
  }
}

// ---------------------------------------------------------------------------
// wgmma (sm_90a): a warpgroup's 64-row product from shared memory.
// ---------------------------------------------------------------------------

// A K-major tile for wgmma with the 128-byte swizzle: NROWS rows of D bf16
// stored as ceil(D / 64) column blocks of NROWS x 128 bytes (64 elements a
// row; D = 32 leaves half of each row unused); within a block, 16-byte chunk
// j of row r sits at chunk j ^ (r % 8), so 8 threads writing one row, and
// the hardware reading 8 rows of one chunk, touch distinct banks. Column
// blocks must start 1024-byte aligned.
template <int D, int NROWS>
__host__ __device__ constexpr int sw128_bytes() {
  return ((D + 63) / 64) * NROWS * 128;
}

template <int D, int NROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_sw128(e16* dst, const e16* src,
                                                long rs, int row0, int S,
                                                int tid, int hd) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  static_assert((NROWS * VPR) % NTHREADS == 0, "tile not a whole number of "
                                               "copies per thread");
  unsigned char* base = reinterpret_cast<unsigned char*>(dst);
#pragma unroll
  for (int it = 0; it < NROWS * VPR / NTHREADS; ++it) {
    const int i = tid + it * NTHREADS;
    const int r = i / VPR, c8 = i % VPR;
    const bool valid = row0 + r < S && c8 * 8 < hd;
    cp_async16(base + (c8 >> 3) * NROWS * 128 + r * 128 +
                   (((c8 & 7) ^ (r & 7)) << 4),
               src + (valid ? (long)(row0 + r) * rs + c8 * 8 : 0), valid);
  }
}

// Matrix descriptor of a K-major 128-byte-swizzled operand whose first row
// and first k element sit at p: start address >> 4, leading byte offset 1
// (unused for a swizzled K-major operand), stride byte offset 1024 (one
// 8-row group of 128-byte rows), layout type 1 (128-byte swizzle). The k
// step kk of 16 elements starts at p + (kk / 4) * block + (kk % 4) * 32.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Shared memory written by cp.async (the generic proxy) made visible to the
// async proxy that wgmma reads it through; each writing thread, before the
// barrier that publishes the tile.
__device__ __forceinline__ void fence_async_smem() {
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

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A . B^T for a 64 x N tile, k 16, A and B K-major in shared memory
// (descriptors), fp32 accumulation; scale_d = 0 overwrites d. Warp w of the
// warpgroup holds rows 16w.., in the mma.sync C layout for each 8-column
// group j: d[4j + 0..1] = (row g, cols 8j + 2t, +1), d[4j + 2..3] = row g+8.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." HV_E16 "." HV_E16 " "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." HV_E16 "." HV_E16 " "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32." HV_E16 "." HV_E16 " "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." HV_E16 "." HV_E16 " "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Matrix descriptor of an MN-major 128-byte-swizzled B operand (a tile of
// k rows of 128-byte swizzled n elements, as load_tile_sw128 stores V:
// keys x head dim): leading byte offset `block` (the next 64-wide n
// block), stride byte offset 1024 (the next 8 k rows), 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_sw128_mn(const void* p, int block) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((block >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d += A . B for a 64 x 32 tile, k 16: A (the warp's 16 rows, mma.sync A
// fragment layout) from registers, B an MN-major (transposed) operand in
// shared memory; d[4j + e] as in wgmma_ss.
__device__ __forceinline__ void wgmma_rs32(float (&d)[16], const uint32_t a[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." HV_E16 "." HV_E16 " "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// As wgmma_rs32 for a 64 x 64 tile (one 64-wide, 128-byte swizzle atom of
// the MN-major B operand, so its leading byte offset is never stepped).
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t a[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." HV_E16 "." HV_E16 " {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d = Q . K^T over D for a warpgroup's 64 query rows (Q: a 128-byte-swizzled
// tile of QROWS rows, the warpgroup's first row at row q_row0; K: one of
// KROWS rows) against the first N keys of K, then waited for.
template <int D, int N, int QROWS, int KROWS>
__device__ __forceinline__ void wgmma_qk(float (&d)[32], const e16* Qs,
                                         int q_row0, const e16* Ks) {
  const unsigned char* qb = reinterpret_cast<const unsigned char*>(Qs) + q_row0 * 128;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(Ks);
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk % 4) * 32;
    wgmma_ss<N>(d, desc_sw128(qb + (kk / 4) * QROWS * 128 + off),
                desc_sw128(kb + (kk / 4) * KROWS * 128 + off), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
}

// ---------------------------------------------------------------------------
// TF32 wgmma (sm_90a; the fp32 full-block kernels). At .tf32 both operands
// are K-major: wgmma has no transpose at this type (CUTLASS's
// SM90_64xNx8_F32TF32TF32_{SS,RS}_TN take K-major layouts only), so a
// product whose k runs over a tile's rows reads a transposed copy. A K step
// is 8 floats, 32 bytes, as a bf16 step of 16: K-major 128-byte-swizzled
// fp32 tiles take desc_sw128's descriptor and step k as the bf16 ones do.
// ---------------------------------------------------------------------------

// d (+)= A . B^T for a 64 x N tile, k 8: A and B K-major in shared memory
// (descriptors), fp32 accumulation; scale_d = 0 overwrites d. d as
// wgmma_ss's: warp w of the warpgroup holds rows 16 w.., d[4 j + 0..1] =
// (row g, columns 8 j + 2 t, + 1), d[4 j + 2..3] = row g + 8.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t a,
                                              uint64_t b, int scale_d);

// The same with A from registers, as mma.sync m16n8k8 .tf32 lays it out
// for the warp's 16 rows: a = (g, k t), (g + 8, k t), (g, k t + 4),
// (g + 8, k t + 4).
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<16>(float (&d)[8], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float (&d)[16], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tf32_rs<48>(float (&d)[24],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tf32_rs<96>(float (&d)[48],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

// The A fragments of rows [r0, r0 + 16) over all D columns of a shared tile.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t a[D / 16][4],
                                            const e16* T, int ld, int r0,
                                            int lane) {
  const e16* p = T + r0 * ld + ldsm_off_a(lane, ld);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(a[kk], p + kk * 16);
}

// ---------------------------------------------------------------------------
// TMA tile copies completed on mbarriers (sm_90).
// ---------------------------------------------------------------------------

// A tensor map (cuTensorMapEncodeTiled) of a `rank`-dimensional array with
// 128-byte swizzle: dims[0] the contiguous dimension (elements), strides
// the byte strides of dims[1..rank-1], box the tile; reads outside the
// array fill zeros. The driver's encoder is reached through the runtime
// (cudaGetDriverEntryPoint), so the library needs no -lcuda. Returns a
// cudaError_t (cudaErrorInvalidValue when the driver refuses the map).
static inline int make_tmap(CUtensorMap* map, CUtensorMapDataType type,
                            int rank, const void* base,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, type, rank, const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count)
               : "memory");
}

// After every mbar_init of the CTA, before any use (with a __syncthreads).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The issuing thread's arrival, announcing `bytes` more to come by TMA.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes)
      : "memory");
}

// Waits until phase `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
}

// One box of a 2-d / 4-d tensor map into shared memory (1024-byte aligned
// for the swizzle), completing on `bar`; coordinates innermost first.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// Thread-block clusters (sm_90): rank, the cluster-wide barrier and stores
// into a peer CTA's shared memory (distributed shared memory).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives, then waits; a thread
// alternates the two. The release / acquire pair orders each thread's
// shared-memory accesses before its arrival against every access after
// the wait, cluster-wide.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p` in the CTA of cluster rank `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  return remote;
}

// Stores v at the same shared address in the CTA of cluster rank `rank`.
__device__ __forceinline__ void st_peer(float* p, uint32_t rank, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(peer_addr(p, rank)),
               "f"(v)
               : "memory");
}

// Four floats from the shared::cluster address `addr` (16-byte aligned; a
// peer CTA's, from peer_addr, or this CTA's own).
__device__ __forceinline__ float4 ld_peer_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// One arrival, with release at cluster scope, on the mbarrier at the
// shared::cluster address `addr` (a peer CTA's, from peer_addr): the
// arriving thread's earlier shared-memory accesses, remote stores included,
// happen before the phase it completes is observed.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}

// mbar_wait with acquire at cluster scope: after it, what the arrivals of
// the completed phase released (from any CTA of the cluster) is visible.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
}

// Four floats stored asynchronously at the shared::cluster address `addr`
// (16-byte aligned, in a peer CTA), their 16 bytes reported to that CTA's
// mbarrier at `bar` (complete_tx, as a TMA copy reports): the storing
// thread does not wait for them.
__device__ __forceinline__ void st_async_v4(uint32_t addr, const float* v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar)
      : "memory");
}

}  // namespace hv
