// Shared device helpers for the attention kernels: bf16 tensor-core MMA
// (mma.sync m16n8k16, fp32 accumulate) with the PTX-documented fragment
// layouts, and 16-byte tile loads from global to shared memory.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), with g = lane / 4 and
// t = lane % 4:
//   A (16x16, row-major): reg0 = (row g,   k 2t..2t+1)  reg1 = (row g+8, k 2t..)
//                         reg2 = (row g,   k 2t+8..)    reg3 = (row g+8, k 2t+8..)
//   B (16x8, "col"):      reg0 = (k 2t..2t+1, col g)    reg1 = (k 2t+8.., col g)
//   C (16x8, fp32):       c0,c1 = (row g, col 2t, 2t+1) c2,c3 = (row g+8, same cols)
// Two C tiles of 8 columns side by side are exactly one A fragment of a
// 16-wide k step, which is how the probabilities P feed the P.V product
// without a trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hv {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats rounded to bf16, `lo` in the low half (the lower k index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of rows [r0, r0+16) and columns [c0, c0+16) of a row-major
// shared tile with leading dimension ld.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* T, int ld,
                                       int r0, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = T + (r0 + g) * ld + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment with B(k, n) = T[n0 + n][k0 + k]: keys stored row-major, used
// for Q.K^T (n runs over keys, k over the head dim).
__device__ __forceinline__ void load_b_nk(uint32_t b[2], const bf16* T,
                                          int ld, int n0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = T + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment with B(k, n) = T[k0 + k][n0 + n]: values stored row-major,
// used for P.V (k runs over keys, n over the head dim).
__device__ __forceinline__ void load_b_kn(uint32_t b[2], const bf16* T,
                                          int ld, int k0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = T + (k0 + 2 * t) * ld + n0 + g;
  b[0] = pack_bf16(p[0], p[ld]);
  b[1] = pack_bf16(p[8 * ld], p[9 * ld]);
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

// Waits for this thread's cp.async copies, then for the whole CTA: after it
// every tile issued by load_tile is in shared memory.
__device__ __forceinline__ void tile_barrier() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Rows [row0, row0 + NROWS) of an (S, D) bf16 matrix whose rows are `rs`
// elements apart, into a shared tile with leading dimension ld; rows at or
// past S are zero-filled so that ragged edges contribute nothing. Every
// copy of the tile is issued before any completes (asynchronous cp.async),
// so the tile costs one memory latency, not one per copy; call
// tile_barrier() before reading it.
template <int D, int NROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long rs, int row0, int S, int tid) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  static_assert((NROWS * VPR) % NTHREADS == 0, "tile not a whole number of "
                                               "copies per thread");
#pragma unroll
  for (int it = 0; it < NROWS * VPR / NTHREADS; ++it) {
    const int i = tid + it * NTHREADS;
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool valid = row0 + r < S;
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Scale, key bias and ragged-key mask for one C tile of logits whose first
// column is key `col0`: c[0..1] belong to row g, c[2..3] to row g + 8.
__device__ __forceinline__ void logits_epilogue(float c[4], int col0,
                                                int lane, int Sk, float scale,
                                                const float* bias_row) {
  const int t = lane & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int col = col0 + 2 * t + e;
    if (col < Sk) {
      const float b = bias_row ? bias_row[col] : 0.f;
      c[e] = c[e] * scale + b;
      c[2 + e] = c[2 + e] * scale + b;
    } else {
      c[e] = -INFINITY;
      c[2 + e] = -INFINITY;
    }
  }
}

// Two bf16 values of the fp32 accumulator pair (c0, c1) scaled by s, stored
// at p (4-byte aligned).
__device__ __forceinline__ void store_bf16x2(bf16* p, float c0, float c1,
                                             float s) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(c0 * s, c1 * s);
}

// The A fragment over a 16-wide k step built from two adjacent fp32 C tiles
// (columns k 0..7 in c_lo, 8..15 in c_hi), rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c_lo[4],
                                       const float c_hi[4]) {
  a[0] = pack_bf16(c_lo[0], c_lo[1]);
  a[1] = pack_bf16(c_lo[2], c_lo[3]);
  a[2] = pack_bf16(c_hi[0], c_hi[1]);
  a[3] = pack_bf16(c_hi[2], c_hi[3]);
}

}  // namespace hv
