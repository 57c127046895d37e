// The wide streaming kernels: the streaming forward (flash_stream.cu,
// stream_fwd_wide_kernel) and dQ and dK/dV (flash_stream_bwd.cu,
// stream_bwd_wide_kernel) at head dims past 640, in bf16 (fp16 built with
// -DHV_F16) and fp32: the counterparts of
// hivae_tpu/ops/pallas/flash_attention.py::_stream_fwd_kernel,
// ::_stream_dq_kernel and ::_stream_dkv_kernel there, which take every
// head dim that is a multiple of 8. No model of the repository runs such a
// head dim; ops.attention.sdpa and AttentionBlock2D (single-head
// attention over its channels) of a DownEncoder, Upsampler or MapConv
// built wider than 640 channels do.
//
// Why a cluster. The narrow kernels hold a whole row of every operand in
// one CTA. Past D 640 a 64-row fp32 output accumulator of D columns passes
// the registers of a CTA, and a 64-row tile of D columns (128 KB in bf16 at
// D 1024) passes its shared memory beside anything it is multiplied with.
// So the head dim is split over a cluster of CTAs: the tile width is
// 256 * ceil(D / 256) (768 to 2048), run by tile / 256 CTAs (3 to 8, within
// the portable cluster size), rank r holding columns [256 r, 256 r + 256)
// of Q, K, V, O, dO and the gradients, and reading only those (columns past
// D are zero-filled and never stored). One kernel per element type serves
// every wide tile: the cluster size is a launch-time value. The score
// products (S = Q.K^T, and dP = dO.V^T in the backward) contract over D,
// so each CTA forms a partial over its columns and the partials are summed
// across the cluster in rank order, ((p0 + p1) + p2) + ...: a fixed order,
// so two launches give the same bits. The two directions exchange them in
// two designs.
//
// The forward (the wf_ helpers below; flash_stream.cu has its note): each
// row of a walked 64-key tile is owned by one CTA, which sums that row's
// partials, takes its softmax once and sends P and the row's rescale
// factor to every CTA (a reduce-scatter by rows, then a broadcast, both by
// st.async over distributed shared memory onto mbarriers); 16-bit products
// run on wgmma, fp32 ones on mma.sync with ldmatrix fragments.
//
// The backward (stream_bwd_wide_kernel, the helpers from wide_load to
// wide_launch). Each CTA writes its fp32 partial tile to its own shared
// memory, the cluster meets at one barrier (barrier.cluster, release /
// acquire), and every CTA reads all the partials through distributed
// shared memory (ld.shared::cluster at mapa addresses) and adds them in
// rank order: every CTA holds the same bits of S, of the row statistics
// and of P. No slot per peer: the partial tiles take the same bytes at any
// cluster size. They alternate between two buffers by tile parity, so one
// barrier a tile suffices: a CTA writes buffer j % 2 again at tile j + 2,
// after the barrier of tile j + 1, which every peer reaches only once it
// has read tile j's partials. A last barrier keeps every CTA alive until
// its peers have read it. Every product runs on mma.sync m16n8k8 at TF32
// with fp32 accumulation. A bf16 or fp16 value is exact in TF32 (8 or 11
// significant bits of TF32's 11), so one TF32 product of 16-bit operands
// is exact, as the 16-bit tensor-core product is; fp32 operands are split
// into hi + lo (split_tf32) and take three products, lo.hi + hi.lo +
// hi.hi, with the small terms summed apart (flash_stream.cu's note has the
// error table). P and dS are rounded to the operands' dtype before their
// products (P to v's, dS to q's), as the Pallas kernels round them. Fragments are read from shared memory one
// element a lane (one code path for both element widths); tiles keep rows
// 256 + 16 bytes / element apart, so those reads meet no bank conflict. A
// CTA: 8 warps, 64 resident rows (query rows for dQ, keys for dK/dV),
// walked tiles of WT rows through two cp.async slots. Scores: warp w forms
// the 16 x WT block of m tile w % 4 (X = S for warps 0-3, Y = dP for
// 4-7). Outputs: warp w owns rows 16 (w % 4).. and columns 128 (w / 4).. of
// its CTA's 256 (64 accumulator registers a thread an output).
#pragma once

#include "attn_common.cuh"

namespace hv {

constexpr int WIDE_COLS = 256;     // columns of each operand a CTA holds
constexpr int WIDE_THREADS = 256;  // 8 warps
constexpr int WIDE_ROWS = 64;      // resident rows a CTA
constexpr int WIDE_OUT_COLS = 128; // output columns a warp

// The cluster of a wide tile: one CTA per 256 columns.
__host__ __device__ constexpr int wide_cluster(int tile) {
  return tile / WIDE_COLS;
}

// Row stride of a shared tile of T: 256 elements and 16 bytes.
template <typename T>
__host__ __device__ constexpr int wide_ld() {
  return WIDE_COLS + 16 / (int)sizeof(T);
}

__device__ __forceinline__ float wide_val(const float* p) { return *p; }
__device__ __forceinline__ float wide_val(const e16* p) {
  return from_e16(*p);
}

// x rounded to T (P cast to v's dtype, dS to q's); fp32 keeps it.
template <typename T>
__device__ __forceinline__ float wide_round(float x) {
  if constexpr (sizeof(T) == 4)
    return x;
  else
    return from_e16(to_e16(x));
}

// x as a TF32 operand: fp32 split into hi + lo; a 16-bit value is exact
// in TF32 (lo 0, never multiplied).
template <typename T>
__device__ __forceinline__ void wide_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (sizeof(T) == 4) {
    split_tf32(x, hi, lo);
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// c += a.b in TF32: hi.hi into c and, for fp32, lo.hi + hi.lo into cs.
template <typename T>
__device__ __forceinline__ void wide_mma(float (&c)[4], float (&cs)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  if constexpr (sizeof(T) == 4) {
    mma1688_tf32(cs, al, bh);
    mma1688_tf32(cs, ah, bl);
  }
  mma1688_tf32(c, ah, bh);
}

// Rows [row0, row0 + ROWS) and this CTA's 256 columns from c0 of a (S, hd)
// matrix (head: its first element, rows rs elements apart) into a shared
// tile (rows wide_ld apart), rows at or past n and columns at or past hd
// zero-filled: this thread's share of the 16-byte cp.async copies (the
// caller commits the group).
template <typename T, int ROWS>
__device__ __forceinline__ void wide_load(T* dst, const T* head, long rs,
                                          int row0, int n, int c0, int hd,
                                          int tid) {
  constexpr int PER = 16 / (int)sizeof(T), NCH = WIDE_COLS / PER;
  constexpr int LD = wide_ld<T>();
  for (int i = tid; i < ROWS * NCH; i += WIDE_THREADS) {
    const int r = i / NCH, c = (i - r * NCH) * PER;
    const bool valid = row0 + r < n && c0 + c < hd;
    cp_async16(dst + r * LD + c,
               head + (valid ? (long)(row0 + r) * rs + c0 + c : 0), valid);
  }
}

// x = A.B^T of rows [0, 16) of A against rows [0, 8 NB) of B over the
// CTA's 256 columns (both shared tiles of T); m16n8k8 layouts with
// g = lane / 4, t = lane % 4: A (g, k t), (g + 8, k t), (g, k t + 4),
// (g + 8, k t + 4); B (k t, n g), (k t + 4, n g); x[nb] the C fragment of
// rows g, g + 8 and columns 8 nb + 2t, + 1.
template <typename T, int NB>
__device__ __forceinline__ void wide_scores(float (&x)[NB][4], const T* A,
                                            const T* B, int g, int t) {
  constexpr int LD = wide_ld<T>();
  float sm[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nb][e] = sm[nb][e] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < WIDE_COLS / 8; ++ks) {
    const T* pa = A + g * LD + 8 * ks + t;
    uint32_t ah[4], al[4];
    wide_split<T>(wide_val(pa), ah[0], al[0]);
    wide_split<T>(wide_val(pa + 8 * LD), ah[1], al[1]);
    wide_split<T>(wide_val(pa + 4), ah[2], al[2]);
    wide_split<T>(wide_val(pa + 8 * LD + 4), ah[3], al[3]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const T* pb = B + (8 * nb + g) * LD + 8 * ks + t;
      uint32_t bh[2], bl[2];
      wide_split<T>(wide_val(pb), bh[0], bl[0]);
      wide_split<T>(wide_val(pb + 4), bh[1], bl[1]);
      wide_mma<T>(x[nb], sm[nb], ah, al, bh, bl);
    }
  }
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[nb][e] += sm[nb][e];
  }
}

// This warp's 16 x 8 blocks of x into rows 0..15, columns 8 nb.. of the
// fp32 row-major tile X (rows ldx floats apart, ldx even).
template <int NB>
__device__ __forceinline__ void wide_store_blocks(float* X, int ldx,
                                                  const float (&x)[NB][4],
                                                  int g, int t) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    float* p = X + g * ldx + 8 * nb + 2 * t;
    *reinterpret_cast<float2*>(p) = make_float2(x[nb][0], x[nb][1]);
    *reinterpret_cast<float2*>(p + 8 * ldx) = make_float2(x[nb][2], x[nb][3]);
  }
}

// The cluster's sum of the partial tile at `part` (this CTA's address of
// a buffer every CTA holds at the same offset), float4 i of it, in rank
// order: the same bits in every CTA.
__device__ __forceinline__ float4 wide_cluster_sum(const float* part, int i,
                                                   int cl) {
  float4 s = ld_peer_v4(peer_addr(part + 4 * i, 0));
  for (int r = 1; r < cl; ++r) {
    const float4 y = ld_peer_v4(peer_addr(part + 4 * i, r));
    s.x += y.x;
    s.y += y.y;
    s.z += y.z;
    s.w += y.w;
  }
  return s;
}

// The A fragments of a gradient product over KS k steps of 8 from rows
// 0..15 of an fp32 row-major tile (P or dS, rows lda apart), k permuted:
// index t is column 8 ks + 2t and t + 4 column 8 ks + 2t + 1 (a lane's two
// values of a row are one float2; wide_grad's B reads match).
template <typename T, int KS>
__device__ __forceinline__ void wide_frag_a(uint32_t (&ah)[KS][4],
                                            uint32_t (&al)[KS][4],
                                            const float* A, int lda, int g,
                                            int t) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const float2 x0 =
        *reinterpret_cast<const float2*>(A + g * lda + 8 * ks + 2 * t);
    const float2 x1 =
        *reinterpret_cast<const float2*>(A + (g + 8) * lda + 8 * ks + 2 * t);
    wide_split<T>(x0.x, ah[ks][0], al[ks][0]);
    wide_split<T>(x1.x, ah[ks][1], al[ks][1]);
    wide_split<T>(x0.y, ah[ks][2], al[ks][2]);
    wide_split<T>(x1.y, ah[ks][3], al[ks][3]);
  }
}

// acc[n] = acc[n] * a(row) + A.B for a warp's 16 rows (A: KS k steps of
// fragments, k permuted) and NO 8-column n tiles of B, the 8 KS rows of a
// shared tile of T (rows wide_ld apart) from the warp's first column: B's
// k index t is row 8 ks + 2t, t + 4 row 8 ks + 2t + 1, at column g. Each
// chunk of 4 n tiles runs into a fresh sum that reaches acc by one fp32
// FMA (a0 for row g, a1 for row g + 8: the forward's rescale; 1 in the
// backward).
template <typename T, int NO, int KS>
__device__ __forceinline__ void wide_grad(float (&acc)[NO][4],
                                          const uint32_t (&ah)[KS][4],
                                          const uint32_t (&al)[KS][4],
                                          const T* B, float a0, float a1,
                                          int g, int t) {
  constexpr int LD = wide_ld<T>(), W = 4;
  static_assert(NO % W == 0, "whole chunks of n tiles");
#pragma unroll
  for (int n0 = 0; n0 < NO; n0 += W) {
    float tmp[W][4], tsm[W][4];
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmp[w][e] = tsm[w][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const T* pb = B + (8 * ks + 2 * t) * LD + 8 * (n0 + w) + g;
        uint32_t bh[2], bl[2];
        wide_split<T>(wide_val(pb), bh[0], bl[0]);
        wide_split<T>(wide_val(pb + LD), bh[1], bl[1]);
        wide_mma<T>(tmp[w], tsm[w], ah[ks], al[ks], bh, bl);
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n0 + w][e] =
            fmaf(acc[n0 + w][e], e < 2 ? a0 : a1, tmp[w][e] + tsm[w][e]);
  }
}

// Two values of an output row at p: fp32 as they are, 16-bit rounded.
__device__ __forceinline__ void wide_store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void wide_store2(e16* p, float x, float y) {
  *reinterpret_cast<e16x2*>(p) = to_e16x2(x, y);
}

// ---------------------------------------------------------------------------
// The wide forward's layout and exchange (flash_stream.cu,
// stream_fwd_wide_kernel). A walked tile holds WF_KEYS keys; its rows are
// split over the cluster, CTA r owning rows [wf_row0(r), wf_row0(r + 1))
// of the 64 resident ones. Shared memory from a 1024-byte aligned base:
// the Q tile, wf_slots K or V tiles (each 64 rows of the CTA's 256
// columns, 128-byte swizzled in column blocks of 128 bytes, as TMA lands
// them), then wf_bufs exchange buffers of each kind (the partial-score
// slots an owner receives, the P tile every CTA receives, the rows'
// rescale factors), then the mbarriers.
// ---------------------------------------------------------------------------
constexpr int WF_KEYS = 64;

// First row CTA r of a cluster of cl owns in the exchange.
__host__ __device__ constexpr int wf_row0(int r, int cl) {
  return WIDE_ROWS * r / cl;
}

// The rows an owner receives partials for, cl slots of its own rows, at
// most over the wide cluster sizes (3 to 8): 70, at 7 CTAs (10 rows each).
__host__ __device__ constexpr int wf_recv_rows() {
  int most = 0;
  for (int cl = 3; cl <= 8; ++cl) {
    int own = 0;
    for (int r = 0; r < cl; ++r)
      own = own > wf_row0(r + 1, cl) - wf_row0(r, cl)
                ? own
                : wf_row0(r + 1, cl) - wf_row0(r, cl);
    most = most > cl * own ? most : cl * own;
  }
  return most;
}

// K and V slots (the ring's jobs alternate K_j, V_j) and exchange buffers:
// 4 and 2 in 16 bits; fp32 tiles are twice the bytes, so 2 and 1.
template <typename T>
__host__ __device__ constexpr int wf_slots() { return sizeof(T) == 4 ? 2 : 4; }
template <typename T>
__host__ __device__ constexpr int wf_bufs() { return sizeof(T) == 4 ? 1 : 2; }

// A 64-row tile of the CTA's 256 columns.
template <typename T>
__host__ __device__ constexpr int wf_tile_bytes() {
  return WIDE_ROWS * WIDE_COLS * (int)sizeof(T);
}

// Row stride of the P tile, bytes: 16-bit rows of 64 keys padded by 16
// bytes (ldmatrix of A fragments); fp32 rows unpadded, 16-byte chunks
// swizzled (wf_p_off).
template <typename T>
__host__ __device__ constexpr int wf_p_row() {
  return sizeof(T) == 4 ? WF_KEYS * 4 : WF_KEYS * 2 + 16;
}

constexpr int WF_RECV_BYTES = wf_recv_rows() * WF_KEYS * 4;

template <typename T>
__host__ __device__ constexpr int wf_buf_bytes() {
  return WF_RECV_BYTES + WIDE_ROWS * wf_p_row<T>() + WIDE_ROWS * 4;
}

// mbarriers: one a slot, Q, a partial-score and a P arrival a buffer, the
// final denominators.
template <typename T>
__host__ __device__ constexpr int wf_bars() {
  return wf_slots<T>() + 2 + 2 * wf_bufs<T>();
}

// Dynamic shared bytes of the launch, with 1024 to align the base.
template <typename T>
__host__ __device__ constexpr int wf_smem_bytes() {
  return 1024 + (1 + wf_slots<T>()) * wf_tile_bytes<T>() +
         wf_bufs<T>() * wf_buf_bytes<T>() + 8 * wf_bars<T>();
}

// Byte offset of element (r, c) of a 128-byte-swizzled tile of 64 rows of
// T (column blocks of 128 bytes, 16-byte chunk k of row r at k ^ (r % 8)).
template <typename T>
__device__ __forceinline__ int wf_sw_off(int r, int c) {
  constexpr int PER = 128 / (int)sizeof(T);  // elements a block row
  const int cb = c / PER, cc = c % PER;
  return cb * WIDE_ROWS * 128 + r * 128 +
         ((((cc * (int)sizeof(T)) >> 4) ^ (r & 7)) << 4) +
         ((cc * (int)sizeof(T)) & 15);
}

// Byte offset of P[r][c] in the fp32 P tile (16-byte chunk k of row r at
// k ^ (r % 8), so the A-fragment reads of 8 rows meet distinct banks).
__device__ __forceinline__ int wf_p_off(int r, int c) {
  return r * WF_KEYS * 4 + ((((c >> 2) ^ (r & 7))) << 4) + (c & 3) * 4;
}

// Asynchronous stores into a peer CTA's shared memory at the
// shared::cluster address `addr`, their bytes reported to that CTA's
// mbarrier at `bar` (complete_tx): the storing thread does not wait.
__device__ __forceinline__ void st_async_v2(uint32_t addr, float x, float y,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "f"(x), "f"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async_f32(uint32_t addr, float x,
                                             uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "f"(x), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async_u4(uint32_t addr, uint4 v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// ldmatrix x4 at a shared address (b16 8 x 8 matrices; with fp32 data each
// lane gets element (lane / 4, lane % 4) of an 8 x 4 fp32 matrix: the TF32
// m16n8k8 fragment layouts).
__device__ __forceinline__ void ldsm_x4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The partial scores x of a walked tile, warp w's block: rows 16 (w % 4)
// + g, + 8 against keys 32 (w / 4) + 8 n + 2t, + 1 (x[4 n + e], the
// mma.sync C layout, which wgmma m64n32's matches), over the CTA's 256
// columns. 16-bit: wgmma m64n32k16, each warpgroup its 32 keys for all 64
// rows (Q and K both K-major and swizzled, as TMA lands them), waited for.
__device__ __forceinline__ void wf_scores(float (&x)[32], const e16* Qs,
                                          const e16* Ks, int warp, int) {
  const unsigned char* qb = reinterpret_cast<const unsigned char*>(Qs);
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(Ks) + (warp >> 2) * 32 * 128;
  fence_regs(x);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WIDE_COLS / 16; ++kk) {
    const int off = (kk / 4) * WIDE_ROWS * 128 + (kk % 4) * 32;
    wgmma_ss<32>(x, desc_sw128(qb + off), desc_sw128(kb + off), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(x);
}

// fp32: mma.sync m16n8k8 at TF32, three products of a hi/lo split (the
// small terms summed apart), Q's A fragments and K's B fragments by
// ldmatrix from the swizzled tiles, split as they are read.
__device__ __forceinline__ void wf_scores(float (&x)[32], const float* Qs,
                                          const float* Ks, int warp,
                                          int lane) {
  const uint32_t qa = smem_addr(Qs), ka = smem_addr(Ks);
  const int mt = warp & 3, kh = warp >> 2;
  // this lane's ldmatrix rows: Q row (matrices: rows 0-7, 8-15 at chunk
  // c, then at c + 1), K keys (matrices: keys 0-7 at c, c + 1, then keys
  // 8-15)
  const int qr = 16 * mt + (lane & 7) + (lane & 8), qc = lane >> 4;
  const int kr = 32 * kh + (lane & 7) + ((lane >> 4) << 3),
            kc = (lane >> 3) & 1;
  float sm[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = sm[i] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < WIDE_COLS / 8; ++ks) {
    const int cb = (ks >> 2) * WIDE_ROWS * 128, ch = (ks & 3) * 2;
    uint32_t a[4], ah[4], al[4];
    ldsm_x4_at(a, qa + cb + qr * 128 + (((ch + qc) ^ (qr & 7)) << 4));
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int r = kr + 16 * np;
      uint32_t bq[4];
      ldsm_x4_at(bq, ka + cb + r * 128 + (((ch + kc) ^ (r & 7)) << 4));
#pragma unroll
      for (int hn = 0; hn < 2; ++hn) {
        uint32_t bh[2], bl[2];
        split_tf32(__uint_as_float(bq[2 * hn]), bh[0], bl[0]);
        split_tf32(__uint_as_float(bq[2 * hn + 1]), bh[1], bl[1]);
        float* c = x + 4 * (2 * np + hn);
        float* cs = sm + 4 * (2 * np + hn);
        mma1688_tf32(cs, al, bh);
        mma1688_tf32(cs, ah, bl);
        mma1688_tf32(c, ah, bh);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] += sm[i];
}

// The P fragments a warp reads of a walked tile: its 16 rows (16 (w % 4)..)
// over the 64 keys. 16-bit: A fragments of m16n8k16 by ldmatrix.
struct WfP16 {
  uint32_t a[WF_KEYS / 16][4];
};
// fp32: rows g and g + 8, keys 8 ks + 2t, + 1 (the k index permuted: t is
// key 8 ks + 2t and t + 4 key 8 ks + 2t + 1), unsplit.
struct WfP32 {
  float2 p[WF_KEYS / 8][2];
};

__device__ __forceinline__ void wf_read_p(WfP16& f, const unsigned char* P,
                                          int warp, int lane) {
  load_a_rows<WF_KEYS>(f.a, reinterpret_cast<const e16*>(P),
                       wf_p_row<e16>() / 2, 16 * (warp & 3), lane);
}

__device__ __forceinline__ void wf_read_p(WfP32& f, const unsigned char* P,
                                          int warp, int lane) {
  const int r = 16 * (warp & 3) + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < WF_KEYS / 8; ++ks) {
    f.p[ks][0] = *reinterpret_cast<const float2*>(P + wf_p_off(r, 8 * ks + 2 * t));
    f.p[ks][1] =
        *reinterpret_cast<const float2*>(P + wf_p_off(r + 8, 8 * ks + 2 * t));
  }
}

// acc = acc * a(row) + P.V over warp w's 128 output columns (128 (w / 4)..
// of the CTA's 256) and its 16 rows: acc[nb][4 j + e] is row g (e < 2) or
// g + 8, column 64 nb + 8 j + 2t + (e & 1) of the warp's 128. 16-bit:
// each warpgroup its 128 columns for all 64 rows, wgmma m64n64k16 with P
// as the register A operand and V read transposed (MN-major), waited for.
__device__ __forceinline__ void wf_pv(float (&acc)[2][32], const WfP16& f,
                                      const e16* Vs, float a0, float a1,
                                      int warp, int) {
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(Vs);
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[nb][e] *= (e & 2) ? a1 : a0;
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < WF_KEYS / 16; ++c)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int blk = 2 * (warp >> 2) + nb;  // 64-column block of V
      wgmma_rs64(acc[nb], f.a[c],
                 desc_sw128_mn(vb + blk * WIDE_ROWS * 128 + c * 16 * 128,
                               WIDE_ROWS * 128));
    }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
}

// fp32: mma.sync m16n8k8 at TF32, three products (small terms apart); each
// chunk of 4 n tiles runs into a fresh sum that reaches acc by one FMA,
// which applies the rescale. V's B fragments (rows 8 ks + 2t, + 1, column
// g) read from the swizzled tile: the 8 rows of a k step sit in distinct
// chunks, so the lanes meet distinct banks.
__device__ __forceinline__ void wf_pv(float (&acc)[2][32], const WfP32& f,
                                      const float* Vs, float a0, float a1,
                                      int warp, int lane) {
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(Vs);
  const int g = lane >> 2, t = lane & 3, c0 = 128 * (warp >> 2);
#pragma unroll
  for (int n0 = 0; n0 < 16; n0 += 4) {
    float tmp[4][4], tsm[4][4];
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmp[w][e] = tsm[w][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < WF_KEYS / 8; ++ks) {
      uint32_t ah[4], al[4];
      split_tf32(f.p[ks][0].x, ah[0], al[0]);
      split_tf32(f.p[ks][1].x, ah[1], al[1]);
      split_tf32(f.p[ks][0].y, ah[2], al[2]);
      split_tf32(f.p[ks][1].y, ah[3], al[3]);
      const int k = 8 * ks + 2 * t;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int col = c0 + 8 * (n0 + w) + g;
        uint32_t bh[2], bl[2];
        split_tf32(*reinterpret_cast<const float*>(vb + wf_sw_off<float>(k, col)),
                   bh[0], bl[0]);
        split_tf32(
            *reinterpret_cast<const float*>(vb + wf_sw_off<float>(k + 1, col)),
            bh[1], bl[1]);
        mma1688_tf32(tsm[w], al, bh);
        mma1688_tf32(tsm[w], ah, bl);
        mma1688_tf32(tmp[w], ah, bh);
      }
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int n = n0 + w;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n >> 3][4 * (n & 7) + e] = fmaf(acc[n >> 3][4 * (n & 7) + e],
                                            e < 2 ? a0 : a1,
                                            tmp[w][e] + tsm[w][e]);
    }
  }
}

// The fragment type a CTA of T reads P into.
template <typename T>
struct WfFrag {
  using type = WfP16;
};
template <>
struct WfFrag<float> {
  using type = WfP32;
};

// Eight probabilities of a row (keys 8 q.. of the tile, q = the owner
// thread's part) rounded to T, into every peer's P tile at row r; their
// bytes reported to the peer's P mbarrier.
__device__ __forceinline__ void wf_push_p(const float (&p)[8], uint32_t dst,
                                          uint32_t bar, int, int, e16*) {
  uint4 v;
  v.x = pack_e16(p[0], p[1]);
  v.y = pack_e16(p[2], p[3]);
  v.z = pack_e16(p[4], p[5]);
  v.w = pack_e16(p[6], p[7]);
  st_async_u4(dst, v, bar);
}

__device__ __forceinline__ void wf_push_p(const float (&p)[8], uint32_t dst,
                                          uint32_t bar, int r, int q, float*) {
  // dst is the row's start; its two 16-byte chunks 2q, 2q + 1, swizzled
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint4 v;
    v.x = __float_as_uint(p[4 * h]);
    v.y = __float_as_uint(p[4 * h + 1]);
    v.z = __float_as_uint(p[4 * h + 2]);
    v.w = __float_as_uint(p[4 * h + 3]);
    st_async_u4(dst + (((2 * q + h) ^ (r & 7)) << 4), v, bar);
  }
}

// The launch of a wide kernel: ceil(rows / 64) clusters of `cluster` CTAs
// along x, heads along y, batch along z.
template <typename... KArgs, typename... Args>
inline int wide_launch(void (*kern)(KArgs...), int blocks, int cluster,
                       int H, int B, int smem, cudaStream_t stream,
                       Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * cluster, H, B);
  cfg.blockDim = dim3(WIDE_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of `cluster` CTAs of `kern` at `smem` dynamic shared
// bytes the card holds at once (cudaOccupancyMaxActiveClusters).
template <typename... KArgs>
inline int wide_active_clusters(void (*kern)(KArgs...), int cluster,
                                int smem, int* count) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(WIDE_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(
      count, reinterpret_cast<const void*>(kern), &cfg);
}

}  // namespace hv
