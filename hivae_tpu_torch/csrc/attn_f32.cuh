// fp32 attention on the tensor cores (sm_90a): the tile machinery of the
// fp32 full-block forward (flash_full_block.cu), the fp32 full-block
// backward (flash_full_block_bwd.cu) and the fp32 streaming backward
// (flash_stream_bwd.cu, whose cluster CTA at D >= 512 uses the fragment
// and product helpers here). With fp32 operands the TPU kernels keep P and
// dS in fp32 (their casts to v's or q's dtype are no-ops), and so do these.
//
// Every product runs as three TF32 products of a hi/lo split (split_tf32 in
// attn_common.cuh; flash_stream.cu's note has the error table): a.b =
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi. The tensor core truncates as it
// accumulates, so sums are kept short: the score products keep the small
// terms in their own accumulator, added to the hi.hi sum once at the end,
// and each walked tile's gradient (or output) product goes into a fresh
// accumulator that reaches the running sum by one fp32 addition.
// flash_attention.py::tf32_matmul models the split on the CPU.
//
// Two ways to run those products:
//  * The full-block kernels (#1f, #2f, #3f) split every operand once a
//    tile and multiply on TF32 wgmma (the "split once" section below): a
//    raw tile is split by one pass of the CTA into hi and lo parts, K-major
//    128-byte-swizzled tiles that wgmma reads through descriptors, and the
//    products whose k runs over a tile's rows read a transposed copy (at
//    .tf32 wgmma takes K-major operands only). Their bound is the TF32
//    rate, 494.7 TFLOP/s for three products a matmul; the plans and the
//    steps are in the two sources' notes.
//  * The streaming backward at D <= 256 keeps the mma.sync m16n8k8 CTA
//    below (f32_grad_cta), which splits each fragment as it reads it from
//    tiles of rows D + 4 floats apart (the fragment reads of a score
//    product, rows g and columns t of a lane, meet no bank conflict). A
//    gradient product's A operand (P or dS) comes from a C-layout tile, so
//    its k index is taken permuted: index t is column 2t and t + 4 column
//    2t + 1, which makes a lane's two A values of a row one float2 and puts
//    B's rows 2t and 2t + 1 at banks 8t + g and 8t + 4 + g, distinct across
//    the warp. The full-block kernels' transposed copies store their k
//    positions in the same order, so P and dS feed wgmma from registers.
//
// The gradient CTA (f32_grad_cta): the fp32 streaming backward at D <= 256
// (from D 512 the streaming dQ and dK/dV run flash_stream_bwd.cu's cluster
// CTA, fc_cta, which splits D over 2 or 4 CTAs to keep 64 rows a CTA). A
// CTA of 8 warps owns R rows of one side (query rows for dQ; keys for dK
// and dV) and walks tiles of BT rows of the other through a two-slot
// cp.async ring: the resident pair (Q and dO, or K and V) stays in shared
// memory, and each walked pair (K and V, or Q and dO) lands while the tile
// before it computes. Per walked tile, in three steps between barriers:
//  1. scores: X = A1.B1^T and Y = A2.B2^T (S and dP for dQ; S^T and dP^T
//     for dK/dV), R x BT each. The 8 warps split the 16 x 8 blocks of both,
//     and where there are fewer than 8 blocks, the head dim too (WK slices
//     of D, summed over the slices in a fixed order in step 2); partial
//     sums go to shared tiles.
//  2. every thread takes elements of the tile: P (exp(s - lse) from the
//     natural-log LSE, as the TPU kernels do) and dS = P (dP - delta),
//     written over the partials. A walked row past the sequence gets
//     P = dS = 0.
//  3. gradients: each warp owns a slice of D columns for its rows and adds
//     dS.B1 (dQ: dS.K; dK: dS^T.Q) and, for dK/dV, P.B2 (dV: P^T.dO).
// The accumulators of R rows x D (x 2 for dK and dV) live in registers, so
// R shrinks as D grows (fg_rows: at most 64 registers of accumulator a
// thread, 80 at D = 640), and BT shrinks until the tiles fit one block's
// shared memory (fg_tile). No atomics and a fixed order of sums: two
// launches give the same bits.
#pragma once

#include "attn_common.cuh"

namespace hv {

constexpr int F32_THREADS = 256;
constexpr int F32_WARPS = F32_THREADS / 32;
constexpr int F32_SMEM_MAX = 232448;  // bytes one block may use on the H100

// ---------------------------------------------------------------------------
// Fragments and products.
// ---------------------------------------------------------------------------

// A (16 x 8) over rows 0..15 and columns 0..7 of T (rows ld floats apart).
__device__ __forceinline__ void f32_frag_a(uint32_t hi[4], uint32_t lo[4],
                                           const float* T, int ld, int g,
                                           int t) {
  const float* p = T + g * ld + t;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * ld], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * ld + 4], hi[3], lo[3]);
}

// B (8 x 8) with B(k, n) = T[n][k]: rows 0..7 of T, columns 0..7.
__device__ __forceinline__ void f32_frag_bt(uint32_t hi[2], uint32_t lo[2],
                                            const float* T, int ld, int g,
                                            int t) {
  const float* p = T + g * ld + t;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[4], hi[1], lo[1]);
}

// A (16 x 8) of rows 0..15 of T with k permuted (columns 2t, 2t + 1).
__device__ __forceinline__ void f32_frag_a_perm(uint32_t hi[4],
                                                uint32_t lo[4],
                                                const float* T, int ld,
                                                int g, int t) {
  const float2 x0 = *reinterpret_cast<const float2*>(T + g * ld + 2 * t);
  const float2 x1 =
      *reinterpret_cast<const float2*>(T + (g + 8) * ld + 2 * t);
  split_tf32(x0.x, hi[0], lo[0]);
  split_tf32(x1.x, hi[1], lo[1]);
  split_tf32(x0.y, hi[2], lo[2]);
  split_tf32(x1.y, hi[3], lo[3]);
}

// B (8 x 8) with B(k, n) = T[k][n], k permuted: rows 2t and 2t + 1 of T,
// column g.
__device__ __forceinline__ void f32_frag_b_perm(uint32_t hi[2],
                                                uint32_t lo[2],
                                                const float* T, int ld,
                                                int g, int t) {
  const float* p = T + 2 * t * ld + g;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[ld], hi[1], lo[1]);
}

// c += a.b as three TF32 products of the hi/lo parts, small terms first.
__device__ __forceinline__ void mma3_tf32(float c[4], const uint32_t ah[4],
                                          const uint32_t al[4],
                                          const uint32_t bh[2],
                                          const uint32_t bl[2]) {
  mma1688_tf32(c, al, bh);
  mma1688_tf32(c, ah, bl);
  mma1688_tf32(c, ah, bh);
}

// A warp's NB 16 x 8 blocks of A.B^T over KS k steps of 8: rows 0..15 of A
// against rows 8 nb.. of B, both from their first k column, rows ld floats
// apart. hi.hi goes into big, the small terms into small.
template <int NB, int KS>
__device__ __forceinline__ void f32_scores(float (&big)[NB][4],
                                           float (&small)[NB][4],
                                           const float* A, const float* B,
                                           int ld, int g, int t) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) big[nb][e] = small[nb][e] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t ah[4], al[4];
    f32_frag_a(ah, al, A + 8 * ks, ld, g, t);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t bh[2], bl[2];
      f32_frag_bt(bh, bl, B + nb * 8 * ld + 8 * ks, ld, g, t);
      mma1688_tf32(small[nb], al, bh);
      mma1688_tf32(small[nb], ah, bl);
      mma1688_tf32(big[nb], ah, bh);
    }
  }
}

// big + small of a warp's NB blocks into rows 0..15, columns 8 nb.. of the
// row-major tile X (rows ldx floats apart, ldx even).
template <int NB>
__device__ __forceinline__ void f32_store_blocks(float* X, int ldx,
                                                 const float (&big)[NB][4],
                                                 const float (&small)[NB][4],
                                                 int g, int t) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    float* p = X + g * ldx + 8 * nb + 2 * t;
    *reinterpret_cast<float2*>(p) =
        make_float2(big[nb][0] + small[nb][0], big[nb][1] + small[nb][1]);
    *reinterpret_cast<float2*>(p + 8 * ldx) =
        make_float2(big[nb][2] + small[nb][2], big[nb][3] + small[nb][3]);
  }
}

// acc[m][n] += A.B over the BT rows of a walked tile: A the MTW 16-row
// tiles from row 0 of a row-major tile of BT columns (P or dS, rows lda
// apart, read k-permuted), B the tile's BT rows (rows ldb apart) at the NCW
// 8-column n tiles from its column 0, W n tiles at a time, each into a
// fresh accumulator added to acc once. With TWO, acc2 += A2.B2 alongside.
template <int MTW, int NCW, int W, int BT, bool TWO>
__device__ __forceinline__ void f32_grad(float (&acc)[MTW][NCW][4],
                                         float (&acc2)[MTW][NCW][4],
                                         const float* A, const float* A2,
                                         int lda, const float* B,
                                         const float* B2, int ldb, int g,
                                         int t) {
  static_assert(NCW % W == 0, "whole chunks of n tiles");
#pragma unroll
  for (int n0 = 0; n0 < NCW; n0 += W) {
    float tmp[MTW][W][4], tmp2[MTW][W][4];
#pragma unroll
    for (int m = 0; m < MTW; ++m)
#pragma unroll
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[m][w][e] = tmp2[m][w][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BT / 8; ++ks) {
      uint32_t bh[W][2], bl[W][2], ch[W][2], cl[W][2];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        f32_frag_b_perm(bh[w], bl[w], B + 8 * ks * ldb + 8 * (n0 + w), ldb,
                        g, t);
        if constexpr (TWO)
          f32_frag_b_perm(ch[w], cl[w], B2 + 8 * ks * ldb + 8 * (n0 + w),
                          ldb, g, t);
      }
#pragma unroll
      for (int m = 0; m < MTW; ++m) {
        uint32_t ah[4], al[4];
        f32_frag_a_perm(ah, al, A + 16 * m * lda + 8 * ks, lda, g, t);
#pragma unroll
        for (int w = 0; w < W; ++w) mma3_tf32(tmp[m][w], ah, al, bh[w], bl[w]);
        if constexpr (TWO) {
          f32_frag_a_perm(ah, al, A2 + 16 * m * lda + 8 * ks, lda, g, t);
#pragma unroll
          for (int w = 0; w < W; ++w)
            mma3_tf32(tmp2[m][w], ah, al, ch[w], cl[w]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MTW; ++m)
#pragma unroll
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[m][n0 + w][e] += tmp[m][w][e];
          if constexpr (TWO) acc2[m][n0 + w][e] += tmp2[m][w][e];
        }
  }
}

// Rows [row0, row0 + ROWS) and D columns of an fp32 matrix whose rows are
// `ss` elements apart into a shared tile of rows D + 4 floats apart, rows
// at or past n and columns at or past nc zero-filled (nc may be <= 0: a
// slice wholly past the head dim): this thread's share of the 16-byte
// cp.async copies (the caller commits the group).
template <int D, int ROWS>
__device__ __forceinline__ void f32_load_tile(float* dst, const float* src,
                                              long ss, int row0, int n,
                                              int tid, int nc) {
  constexpr int NC4 = D / 4, LD = D + 4;
  for (int i = tid; i < ROWS * NC4; i += F32_THREADS) {
    const int r = i / NC4, c = i - r * NC4;
    const bool valid = row0 + r < n && 4 * c < nc;
    cp_async16(dst + r * LD + 4 * c,
               src + (valid ? (long)(row0 + r) * ss + 4 * c : 0), valid);
  }
}

// The output side of a product: each warp owns D / CG columns (CG 8 where
// D is a multiple of 64, else 4) of MTW 16-row tiles; n tiles go W at a
// time into the fresh accumulator (at most 4 blocks of it a thread).
template <int D>
__host__ __device__ constexpr int f32_col_groups() {
  return D % 64 == 0 ? 8 : 4;
}

__host__ __device__ constexpr int f32_chunk(int ncw, int mtw) {
  return (ncw % 4 == 0 && mtw <= 1) ? 4 : (ncw % 2 == 0 && mtw <= 2) ? 2 : 1;
}

// ---------------------------------------------------------------------------
// Operands split once per tile, products on TF32 wgmma (the fp32 full-block
// forward and backward). A tile lands raw (rows D floats apart) by cp.async;
// one pass over it writes its hi and lo parts as K-major 128-byte-swizzled
// tiles, in the layout the product reading them needs; every later read is
// a wgmma descriptor, so no inner loop splits anything.
// ---------------------------------------------------------------------------

// Rows [row0, row0 + ROWS) of an fp32 (S, hd) matrix whose rows are `ss`
// elements apart into a shared tile of rows D floats apart, rows at or past
// n and columns at or past hd zero-filled: this thread's share of the
// 16-byte cp.async copies of NT threads (the caller commits the group).
template <int D, int ROWS, int NT>
__device__ __forceinline__ void f32_copy_rows(float* dst, const float* src,
                                              long ss, int row0, int n,
                                              int tid, int hd) {
  constexpr int NC4 = D / 4;
#pragma unroll 4
  for (int i = tid; i < ROWS * NC4; i += NT) {
    const int r = i / NC4, c = i - r * NC4;
    const bool valid = row0 + r < n && 4 * c < hd;
    cp_async16(dst + r * D + 4 * c,
               src + (valid ? (long)(row0 + r) * ss + 4 * c : 0), valid);
  }
}

// Byte offset of 16-byte chunk c (k elements 4c..4c+3) of row r in a K-major
// 128-byte-swizzled fp32 tile of NROWS rows: ceil(K / 32) column blocks of
// NROWS x 128 bytes, chunk c % 8 of row r at chunk (c % 8) ^ (r % 8), as
// load_tile_sw128 lays bf16 tiles out. Tiles start 1024-byte aligned.
__device__ __forceinline__ int sw128_f32_off(int nrows, int r, int c) {
  return (c >> 3) * nrows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// The descriptor of k step kk (8 floats) of such a tile from row r0 (a
// multiple of 8).
__device__ __forceinline__ uint64_t desc_f32(const unsigned char* t,
                                             int nrows, int r0, int kk) {
  return desc_sw128(t + (kk >> 2) * nrows * 128 + r0 * 128 + (kk & 3) * 32);
}

__device__ __forceinline__ void split_tf32x4(const float4& x, float4& hi,
                                             float4& lo) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                   __uint_as_float(h[2]), __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                   __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// The ROWS x D raw tile (rows D floats apart) as it is, K-major over D: the
// A operand of a score product, or its B operand (the keys, or the walked
// queries, as its N rows). Eight neighbouring threads take one row's
// 128 bytes, which the swizzle keeps within one row: no bank conflict.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void split_rows_tf32(unsigned char* hi,
                                                unsigned char* lo,
                                                const float* raw, int tid) {
  constexpr int C = D / 4;
#pragma unroll 4
  for (int e = tid; e < ROWS * C; e += NT) {
    const int r = e / C, c = e - r * C;
    float4 h, l;
    split_tf32x4(*reinterpret_cast<const float4*>(raw + r * D + 4 * c), h, l);
    const int off = sw128_f32_off(ROWS, r, c);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// The transposed copy of a tile of ROWS rows x D, K-major over its rows:
// the B operand of a product whose k runs over the tile's rows (P.V, dS.K,
// dS^T.Q, P^T.dO), a tile of D rows (the product's columns) whose k
// positions [p0, p0 + ROWS) hold the tile's rows in the order the A
// operand reads them: its A comes from a score accumulator, whose columns
// 2t and 2t + 1 of each 8 are k indices t and t + 4, so k position 8c + p
// holds row 8c + 2p (p < 4) or 8c + 2(p - 4) + 1. Work item e of KC x DC
// takes 4 positions (one 16-byte chunk kc) of 4 columns (chunk dc), four
// neighbouring items neighbouring columns and the next four the other half
// of the same 8 rows: it reads rows r0 + 2i, i < 4, at chunk dc and writes
// the 4 x 4 transpose as four 16-byte chunks.
struct TposeItem {
  int dc, kc, r0;
};

__device__ __forceinline__ TposeItem tpose_item(int e, int dc4) {
  const int rest = e >> 3;
  const int kc = (rest / dc4) * 2 + ((e >> 2) & 1);
  return {(rest % dc4) * 4 + (e & 3), kc, (kc >> 1) * 8 + (kc & 1)};
}

__device__ __forceinline__ void transpose4(const float4 (&x)[4],
                                           float4 (&y)[4]) {
  y[0] = make_float4(x[0].x, x[1].x, x[2].x, x[3].x);
  y[1] = make_float4(x[0].y, x[1].y, x[2].y, x[3].y);
  y[2] = make_float4(x[0].z, x[1].z, x[2].z, x[3].z);
  y[3] = make_float4(x[0].w, x[1].w, x[2].w, x[3].w);
}

// That copy from the raw tile (rows D floats apart), split on the way.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void split_cols_tf32(unsigned char* hi,
                                                unsigned char* lo, int p0,
                                                const float* raw, int tid) {
  constexpr int KC = ROWS / 4, DC = D / 4;
  static_assert(KC % 2 == 0 && DC % 4 == 0, "whole chunk groups");
#pragma unroll 2
  for (int e = tid; e < KC * DC; e += NT) {
    const TposeItem it = tpose_item(e, DC / 4);
    float4 x[4], xt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(raw + (it.r0 + 2 * i) * D +
                                              4 * it.dc);
    transpose4(x, xt);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      float4 h, l;
      split_tf32x4(xt[dd], h, l);
      const int off = sw128_f32_off(D, 4 * it.dc + dd, p0 / 4 + it.kc);
      *reinterpret_cast<float4*>(hi + off) = h;
      *reinterpret_cast<float4*>(lo + off) = l;
    }
  }
}

// That copy from the tile already split as it is (hi and lo parts, each at
// its pointer in a K-major tile of SROWS rows): x = hi + lo exactly, so the
// parts move unchanged.
template <int ROWS, int D, int NT, int SROWS>
__device__ __forceinline__ void transpose_tf32(unsigned char* hi,
                                               unsigned char* lo, int p0,
                                               const unsigned char* shi,
                                               const unsigned char* slo,
                                               int tid) {
  constexpr int KC = ROWS / 4, DC = D / 4;
  static_assert(KC % 2 == 0 && DC % 4 == 0, "whole chunk groups");
#pragma unroll 2
  for (int e = tid; e < KC * DC; e += NT) {
    const TposeItem it = tpose_item(e, DC / 4);
    float4 h[4], l[4], ht[4], lt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = sw128_f32_off(SROWS, it.r0 + 2 * i, it.dc);
      h[i] = *reinterpret_cast<const float4*>(shi + off);
      l[i] = *reinterpret_cast<const float4*>(slo + off);
    }
    transpose4(h, ht);
    transpose4(l, lt);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const int off = sw128_f32_off(D, 4 * it.dc + dd, p0 / 4 + it.kc);
      *reinterpret_cast<float4*>(hi + off) = ht[dd];
      *reinterpret_cast<float4*>(lo + off) = lt[dd];
    }
  }
}

// small (+)= A_lo.B_hi + A_hi.B_lo and big (+)= A_hi.B_hi over KS k steps
// of the head dim from k step k0: A the warpgroup's 64 rows from row a0 of
// a K-major tile of AROWS rows (hi and lo parts), B a K-major tile of N
// rows. The small terms keep their own accumulator, added to big once by
// the caller. Issued, not committed.
template <int KS, int N, int AROWS>
__device__ __forceinline__ void wg_scores_tf32(
    float (&big)[N / 2], float (&small)[N / 2], const unsigned char* ah,
    const unsigned char* al, int a0, const unsigned char* bh,
    const unsigned char* bl, int k0) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int kk = k0 + ks;
    const uint64_t dah = desc_f32(ah, AROWS, a0, kk);
    const uint64_t dal = desc_f32(al, AROWS, a0, kk);
    const uint64_t dbh = desc_f32(bh, N, 0, kk);
    const uint64_t dbl = desc_f32(bl, N, 0, kk);
    wgmma_tf32_ss<N>(small, dal, dbh, ks > 0);
    wgmma_tf32_ss<N>(small, dah, dbl, 1);
    wgmma_tf32_ss<N>(big, dah, dbh, ks > 0);
  }
}

// The score products with B's two parts stacked in one K-major tile of
// 2 BT rows (lo, then hi): wide (+)= A_hi.[B_lo; B_hi]^T, one wgmma of N =
// 2 BT whose columns [0, BT) are the small term A_hi.B_lo and [BT, 2 BT)
// the big sum, and narrow (+)= A_lo.B_hi, the other small term, in its own
// accumulator; two wgmmas a k step, which read A_hi once and B_hi twice
// where three of N = BT read A three times. The caller adds small =
// A_hi.B_lo + A_lo.B_hi, then big + small. Issued, not committed.
template <int KS, int BT, int AROWS>
__device__ __forceinline__ void wg_scores2_tf32(
    float (&wide)[BT], float (&narrow)[BT / 2], const unsigned char* ah,
    const unsigned char* al, int a0, const unsigned char* b, int k0) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int kk = k0 + ks;
    wgmma_tf32_ss<2 * BT>(wide, desc_f32(ah, AROWS, a0, kk),
                          desc_f32(b, 2 * BT, 0, kk), ks > 0);
    wgmma_tf32_ss<BT>(narrow, desc_f32(al, AROWS, a0, kk),
                      desc_f32(b, 2 * BT, BT, kk), ks > 0);
  }
}

// d = A.B into a fresh accumulator: A the KS k steps of register fragments
// ah / al (hi and lo parts, wgmma_tf32_rs's layout), B the NC rows from row
// c0 of a transposed K-major tile of TROWS rows (split_cols_tf32's), its k
// steps from k0; per k step the three products, small terms first. Issued,
// not committed.
template <int KS, int NC, int TROWS>
__device__ __forceinline__ void wg_product_tf32(
    float (&d)[NC / 2], const uint32_t (&ah)[KS][4],
    const uint32_t (&al)[KS][4], const unsigned char* bh,
    const unsigned char* bl, int c0, int k0) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint64_t dbh = desc_f32(bh, TROWS, c0, k0 + ks);
    const uint64_t dbl = desc_f32(bl, TROWS, c0, k0 + ks);
    wgmma_tf32_rs<NC>(d, al[ks], dbh, ks > 0);
    wgmma_tf32_rs<NC>(d, ah[ks], dbl, 1);
    wgmma_tf32_rs<NC>(d, ah[ks], dbh, 1);
  }
}

// The A operand of N / 8 k steps from a C-layout accumulator x of N
// columns (P or dS), split: k step c reads columns 8c..8c+7, k index t as
// column 2t and t + 4 as 2t + 1 (split_cols_tf32's order).
template <int N>
__device__ __forceinline__ void frag_from_acc(uint32_t (&h)[N / 8][4],
                                              uint32_t (&l)[N / 8][4],
                                              const float (&x)[N / 2]) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    split_tf32(x[4 * c], h[c][0], l[c][0]);
    split_tf32(x[4 * c + 2], h[c][1], l[c][1]);
    split_tf32(x[4 * c + 1], h[c][2], l[c][2]);
    split_tf32(x[4 * c + 3], h[c][3], l[c][3]);
  }
}

template <int N, int M>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(f[i]);
}

// ---------------------------------------------------------------------------
// Launch plans of the gradient CTA (flash_attention.py::_f32_grad_plan).
// ---------------------------------------------------------------------------

// Rows a CTA for NOUT outputs of D columns: 64, 32 or 16, the most whose
// accumulators take at most 64 registers a thread (16 at least).
template <int D, int NOUT>
__host__ __device__ constexpr int fg_rows() {
  return 16384 / (D * NOUT) >= 64 ? 64 : 16384 / (D * NOUT) >= 32 ? 32 : 16;
}

// k slices of the score products: 1 where the tile has 8 blocks of 16 x 8
// or more, else 8 over the blocks.
__host__ __device__ constexpr int fg_split(int rows, int tile) {
  return rows / 16 * (tile / 8) >= F32_WARPS
             ? 1
             : F32_WARPS / (rows / 16 * (tile / 8));
}

// Shared bytes: the resident pair (2 x rows x (d + 4)) and its 3 fp32 rows,
// two slots of a walked pair (2 x tile x (d + 4)) and 3 fp32 rows of tile,
// and the X and Y partials (split x rows x (tile + 8) each).
__host__ __device__ constexpr int fg_smem_at(int d, int rows, int tile) {
  return 4 * (2 * rows * (d + 4) + 3 * rows +
              2 * (2 * tile * (d + 4) + 3 * tile) +
              2 * fg_split(rows, tile) * rows * (tile + 8));
}

// Walked rows a tile: 32, 16 or 8, the most that fit one block.
template <int D, int NOUT>
__host__ __device__ constexpr int fg_tile() {
  return fg_smem_at(D, fg_rows<D, NOUT>(), 32) <= F32_SMEM_MAX   ? 32
         : fg_smem_at(D, fg_rows<D, NOUT>(), 16) <= F32_SMEM_MAX ? 16
                                                                 : 8;
}

template <int D, int NOUT>
__host__ __device__ constexpr int fg_smem() {
  return fg_smem_at(D, fg_rows<D, NOUT>(), fg_tile<D, NOUT>());
}

struct F32GradArgs {
  const float *q, *k, *v, *dout;
  const float* bias;             // (B, Sk) key bias or null
  const float *s0, *s1, *s2;     // (B, H, Sq) row statistics: full-block m,
                                 // 1/l and delta; streaming lse, null, delta
  float *dq, *dk, *dv;
  Rows sq, sk, sv, sdo, sdq, sdk, sdv;
  int H, Sq, Sk;
  int nqb;                       // dQ CTAs ahead of the dK/dV ones (a launch
                                 // of both)
  int hd;                        // the head dim (<= the tile's D)
  float scale;
  float keyless;                 // the streaming backward's stream_p: 0, or
                                 // 1 / Sk (the full-block rule)
};

// One CTA of the fp32 streaming backward: dQ of R query rows (DKV false) or
// dK and dV of R keys (DKV true), block `blk` of its kind.
template <int D, int R, int BT, bool DKV>
__device__ __forceinline__ void f32_grad_cta(const F32GradArgs& a,
                                             float* smem, int blk) {
  constexpr int LD = D + 4, BTP = BT + 8;
  constexpr int MT = R / 16, NT = BT / 8;
  constexpr int WK = fg_split(R, BT), WB = F32_WARPS / WK;
  constexpr int BPW = MT * NT / WB;  // score blocks a warp
  constexpr int DK = D / WK;         // head-dim columns of a k slice
  constexpr int CG = f32_col_groups<D>(), MG = F32_WARPS / CG;
  constexpr int MTW = MT / MG, NCW = D / CG / 8, W = f32_chunk(NCW, MTW);
  static_assert(NT % BPW == 0 && DK % 8 == 0 && MT % MG == 0 && MTW >= 1,
                "plan");
  constexpr int TILE = BT * LD, SLOT = 2 * TILE + 3 * BT;
  float* A1 = smem;
  float* A2 = A1 + R * LD;
  float* ring = A2 + R * LD;
  float* XS = ring + 2 * SLOT;
  float* YS = XS + WK * R * BTP;
  float* ST = YS + WK * R * BTP;  // 3 fp32 rows of R

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, r0 = blk * R;
  const int nres = DKV ? a.Sk : a.Sq, nwalk = DKV ? a.Sq : a.Sk;
  const float* ra1 = DKV ? head_ptr(a.k, a.sk, b, h) : head_ptr(a.q, a.sq, b, h);
  const float* ra2 = DKV ? head_ptr(a.v, a.sv, b, h) : head_ptr(a.dout, a.sdo, b, h);
  const float* wa1 = DKV ? head_ptr(a.q, a.sq, b, h) : head_ptr(a.k, a.sk, b, h);
  const float* wa2 = DKV ? head_ptr(a.dout, a.sdo, b, h) : head_ptr(a.v, a.sv, b, h);
  const long rs1 = DKV ? a.sk.s : a.sq.s, rs2 = DKV ? a.sv.s : a.sdo.s;
  const long ws1 = DKV ? a.sq.s : a.sk.s, ws2 = DKV ? a.sdo.s : a.sv.s;
  const long rb = ((long)b * a.H + h) * a.Sq;  // row statistics of (b, h)
  const float* brow = a.bias ? a.bias + (long)b * a.Sk : nullptr;
  const int njobs = (nwalk + BT - 1) / BT;

  // walked tile i into slot i % 2: its two tiles and its fp32 rows (dK/dV:
  // the queries' statistics; dQ: the keys' bias)
  auto issue = [&](int i) {
    float* sl = ring + (i & 1) * SLOT;
    f32_load_tile<D, BT>(sl, wa1, ws1, i * BT, nwalk, tid, a.hd);
    f32_load_tile<D, BT>(sl + TILE, wa2, ws2, i * BT, nwalk, tid, a.hd);
    float* rows = sl + 2 * TILE;
    if constexpr (DKV) {
      load_row_f32<BT, F32_THREADS>(rows, a.s0 + rb, i * BT, a.Sq, tid);
      load_row_f32<BT, F32_THREADS>(rows + 2 * BT, a.s2 + rb, i * BT, a.Sq,
                                    tid);
    } else {
      if (brow) load_row_f32<BT, F32_THREADS>(rows, brow, i * BT, a.Sk, tid);
    }
    ring_commit();
  };

  // the resident pair and its fp32 rows (dQ: the rows' statistics; dK/dV:
  // the keys' bias) ride in job 0's group
  f32_load_tile<D, R>(A1, ra1, rs1, r0, nres, tid, a.hd);
  f32_load_tile<D, R>(A2, ra2, rs2, r0, nres, tid, a.hd);
  if constexpr (DKV) {
    if (brow) load_row_f32<R, F32_THREADS>(ST, brow, r0, a.Sk, tid);
  } else {
    load_row_f32<R, F32_THREADS>(ST, a.s0 + rb, r0, a.Sq, tid);
    load_row_f32<R, F32_THREADS>(ST + 2 * R, a.s2 + rb, r0, a.Sq, tid);
  }
  issue(0);

  float acc[MTW][NCW][4], acc2[MTW][NCW][4];
#pragma unroll
  for (int m = 0; m < MTW; ++m)
#pragma unroll
    for (int n = 0; n < NCW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = acc2[m][n][e] = 0.f;
  // step 1: k slice ksl, blocks (mt, nt0..nt0 + BPW); step 3: columns
  // [cg D / CG, ...) of rows 16 mg MTW..
  const int ksl = warp / WB, bw = warp % WB;
  const int mt = bw * BPW / NT, nt0 = bw * BPW % NT;
  const int mg = warp / CG, cg = warp % CG;

  for (int i = 0; i < njobs; ++i) {
    ring_wait_upto(0);
    __syncthreads();  // tile i has landed; tile i - 1's slot and the P and
                      // dS tiles are free
    if (i + 1 < njobs) issue(i + 1);
    const float* sl = ring + (i & 1) * SLOT;
    const float* rows = sl + 2 * TILE;
    {
      float xb[BPW][4], xs[BPW][4], yb[BPW][4], ys[BPW][4];
      f32_scores<BPW, DK / 8>(xb, xs, A1 + 16 * mt * LD + ksl * DK,
                              sl + 8 * nt0 * LD + ksl * DK, LD, g, t);
      f32_scores<BPW, DK / 8>(yb, ys, A2 + 16 * mt * LD + ksl * DK,
                              sl + TILE + 8 * nt0 * LD + ksl * DK, LD, g, t);
      f32_store_blocks<BPW>(XS + (ksl * R + 16 * mt) * BTP + 8 * nt0, BTP, xb,
                            xs, g, t);
      f32_store_blocks<BPW>(YS + (ksl * R + 16 * mt) * BTP + 8 * nt0, BTP, yb,
                            ys, g, t);
    }
    __syncthreads();
    // step 2: P and dS over the k slices in a fixed order, written over
    // slice 0's partials (each element by the thread that read it)
    for (int e = tid; e < R * BT; e += F32_THREADS) {
      const int r = e / BT, c = e - r * BT;
      float x = XS[r * BTP + c], y = YS[r * BTP + c];
#pragma unroll
      for (int s = 1; s < WK; ++s) {
        x += XS[(s * R + r) * BTP + c];
        y += YS[(s * R + r) * BTP + c];
      }
      float p = 0.f, ds = 0.f;
      if (i * BT + c < nwalk) {
        if constexpr (DKV) {
          p = stream_p(x, a.scale, brow ? ST[r] : 0.f, rows[c], a.keyless);
          ds = p * (y - rows[2 * BT + c]);
        } else {
          p = stream_p(x, a.scale, brow ? rows[c] : 0.f, ST[r], a.keyless);
          ds = p * (y - ST[2 * R + r]);
        }
      }
      if constexpr (DKV) XS[r * BTP + c] = p;
      YS[r * BTP + c] = ds;
    }
    __syncthreads();
    // step 3: dQ += dS.K, or dK += dS^T.Q and dV += P^T.dO
    const int col = cg * (D / CG);
    f32_grad<MTW, NCW, W, BT, DKV>(acc, acc2, YS + 16 * mg * MTW * BTP,
                                   XS + 16 * mg * MTW * BTP, BTP, sl + col,
                                   sl + TILE + col, LD, g, t);
  }

  float *o1, *o2 = nullptr;
  long os1;
  if constexpr (DKV) {
    o1 = head_ptr(a.dk, a.sdk, b, h);
    os1 = a.sdk.s;
    o2 = head_ptr(a.dv, a.sdv, b, h);
  } else {
    o1 = head_ptr(a.dq, a.sdq, b, h);
    os1 = a.sdq.s;
  }
#pragma unroll
  for (int m = 0; m < MTW; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + 16 * (mg * MTW + m) + 8 * hf + g;
      if (row >= nres) continue;
#pragma unroll
      for (int n = 0; n < NCW; ++n) {
        const int c = cg * (D / CG) + 8 * n + 2 * t;
        if (c >= a.hd) continue;
        *reinterpret_cast<float2*>(o1 + (long)row * os1 + c) =
            make_float2(acc[m][n][2 * hf] * a.scale,
                        acc[m][n][2 * hf + 1] * a.scale);
        if constexpr (DKV)
          *reinterpret_cast<float2*>(o2 + (long)row * a.sdv.s + c) =
              make_float2(acc2[m][n][2 * hf], acc2[m][n][2 * hf + 1]);
      }
    }
}

// delta = rowsum(dO * O) in fp32 of row `row` of the (B, H, Sq) rows of
// dout and out (fp32, hd <= D columns): 8 lanes a row, lane & 7 reads
// 16-byte chunks of both rows (row_delta's layout), a 3-step shuffle sums
// them and every lane of the 8 returns the sum.
template <int D>
__device__ __forceinline__ float row_delta_f32(const float* dout,
                                               const float* out, long row,
                                               long rows, int H, int Sq,
                                               Rows sdo, Rows so, int hd) {
  const int sub = threadIdx.x & 7;
  float acc = 0.f;
  if (row < rows) {
    const int s = (int)(row % Sq), h = (int)(row / Sq % H),
              b = (int)(row / Sq / H);
    const float* dp = head_ptr(dout, sdo, b, h) + s * sdo.s;
    const float* op = head_ptr(out, so, b, h) + s * so.s;
#pragma unroll
    for (int c = sub * 4; c < D; c += 32) {
      if (c >= hd) break;
      const float4 x = *reinterpret_cast<const float4*>(dp + c);
      const float4 y = *reinterpret_cast<const float4*>(op + c);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc + __shfl_xor_sync(0xffffffffu, acc, 4);
}

}  // namespace hv
