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
// every wide tile: the cluster size is a launch-time value.
//
// The exchange. The score products (S = Q.K^T, and dP = dO.V^T in the
// backward) contract over D, so each CTA forms a partial over its columns
// and the partials are summed across the cluster. Each CTA writes its
// fp32 partial tile to its own shared memory, the cluster meets at one
// barrier (barrier.cluster, release / acquire), and every CTA reads all
// the partials through distributed shared memory (ld.shared::cluster at
// mapa addresses) and adds them in rank order, ((p0 + p1) + p2) + ...: every
// CTA holds the same bits of S, of the row max and denominator, and of P,
// so the LSE written once is well defined and two launches give the same
// bits. No slot per peer: the partial tiles take the same bytes at any
// cluster size. They alternate between two buffers by tile parity, so one
// barrier a tile suffices: a CTA writes buffer j % 2 again at tile j + 2,
// after the barrier of tile j + 1, which every peer reaches only once it
// has read tile j's partials. A last barrier keeps every CTA alive until
// its peers have read it.
//
// Products. Every product runs on mma.sync m16n8k8 at TF32 with fp32
// accumulation. A bf16 or fp16 value is exact in TF32 (8 or 11 significant
// bits of TF32's 11), so one TF32 product of 16-bit operands is exact, as
// the 16-bit tensor-core product is; fp32 operands are split into hi + lo
// (split_tf32) and take three products, lo.hi + hi.lo + hi.hi, with the
// small terms summed apart (flash_stream.cu's note has the error table).
// P and dS are rounded to the operands' dtype before their products (P to
// v's, dS to q's), as the Pallas kernels round them. Fragments are read
// from shared memory one element a lane (no ldmatrix: one code path for
// both element widths); tiles keep rows 256 + 16 bytes / element apart, so
// those reads meet no bank conflict. A simple kernel: at TF32's rate the
// 16-bit forms have half the 16-bit tensor cores' peak, and the steps of a
// tile (scores, exchange, softmax or P and dS, gradient products) do not
// overlap, beyond the next walked tile landing by cp.async meanwhile.
//
// A CTA: 8 warps, 64 resident rows (query rows for the forward and dQ,
// keys for dK/dV), walked tiles of WT rows through two cp.async slots.
// Scores: warp w forms the 16 x WT block of m tile w % 4 (forward: half
// w / 4 of its keys; backward: X = S for warps 0-3, Y = dP for 4-7).
// Outputs: warp w owns rows 16 (w % 4).. and columns 128 (w / 4).. of its
// CTA's 256 (64 accumulator registers a thread an output).
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

}  // namespace hv
