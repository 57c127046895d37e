// Full-block attention forward for Hopper (sm_90a), bf16 (or fp16, built
// with -DHV_F16: attn_common.cuh) in and out.
//
// Replaces hivae_tpu/ops/pallas/flash_attention.py::_fwd_kernel (driven by
// _flash_fwd_impl): softmax(Q.K^T * scale + key_bias) . V over sequences of
// a few hundred to ~1024 keys, with fp32 logits and softmax, the normalised
// probabilities rounded to bf16 before P.V, and fp32 accumulation.
//
// Bound on the H100 SXM: 4*B*H*Sq*Sk*D matmul FLOPs over (q + k + v + o)
// bf16 bytes; at the path shapes (B*H = 256, S = 260..512, D = 64) that is
// 4.4-17 GFLOP against 35-67 MB: 4.5-17 us of tensor time at 989 TFLOP/s
// against 10-20 us of HBM time at 3.35 TB/s, so the bound is bytes. Keeping
// the TPU kernel's rounding point (the normalised P) makes the kernel two
// passes over the keys, with two exponentials per logit: at ~3.7 T ex2/s
// (16 a clock per SM) that alone is ~36 us at (16, 16, 512, 64), above the
// bound by design. Measured on an H100 (chip_smoke.py, PERF.md): 0.072 ms
// at 260/266 keys and 0.161 ms at 512, 2.1x and 3.3x SDPA; the qk-norm
// variant 0.099 and 0.247 ms. The time follows
// the warps resident on an SM, not the tensor cores: the load ring, the
// softmax arithmetic and the two products add up rather than overlap.
//
// Design. A CTA of 8 warps (two warpgroups) takes 128 query rows of one
// (batch, head). Pass 1 walks the key tiles (64 keys) for the row max m and
// denominator l; pass 2 recomputes Q.K^T and accumulates bf16(P) . V. Both
// products run on wgmma, fp32 accumulation, one warpgroup per 64 query
// rows: Q.K^T is m64nNk16 with both operands in 128-byte-swizzled shared
// memory (SS), so the tensor cores read each K tile once per 64 rows; P.V
// is m64n32k16 per 16 keys and 32 output columns with P from registers (RS:
// the accumulator of Q.K^T, rounded to bf16, is already the A fragment
// layout) and V, swizzled as stored, read transposed (MN-major). The P.V
// wgmmas of one 16-key chunk run asynchronously while the next chunk's P is
// formed. What held the first version back, and what this one does about
// it:
//  * Loads never overlapped compute (one buffer, wait_all per tile). Now the
//    2 * ceil(Sk/64) tile jobs (K for pass 1; K, V for pass 2) run through
//    a ring of shared slots filled by cp.async commit groups: with
//    `stages` slots, jobs i+1 .. i+stages-1 are in flight while job i
//    computes, and pass 2's first tiles arrive during pass 1's last. Where
//    all of K and V fit with two CTAs per SM (`resident`, Sk <= 320 at
//    D = 64), each key tile has its own slot: K is read from device memory
//    once for both passes and V streams in behind pass 1. The plan (slots,
//    resident, shared bytes) comes from the caller
//    (flash_attention.py::_full_block_plan), which the CPU tests check.
//  * Scalar shared loads fed the B fragments (32 a warp per 16-key step of
//    P.V at D = 64). Both products now read K and V from shared memory
//    through wgmma's descriptors: no per-warp fragment loads at all.
//  * An IEEE division and expf per logit. P is formed by attn_p
//    (attn_common.cuh), shared with the backward: one FMA gives the base-2
//    logit with log2(e) folded into the scale and bias, one ex2.approx, one
//    multiply by 1/l computed once per row. m is saved in base-2 units, so
//    the backward forms the same P bit for bit.
//  * Padding was computed and thrown away. The last key tile's wgmma is
//    m64n16/32/48/64k16, up to the next multiple of 16 past Sk, and later
//    chunks skip their softmax and P.V; a warpgroup whose 64 rows all lie
//    past Sq issues nothing.
//  * The bias row was read from device memory inside the inner loop; each
//    key tile's bias row now travels with the tile into its slot, and a
//    tile wholly inside Sk with no bias skips the per-column bias and mask.
//    The row max and sum of a tile run in four independent chains a row.
// Nothing of size S x S is ever stored. Ragged Sq/Sk (260, 266) are
// zero-filled tile rows and -inf logits past Sk, not host padding.
//
// The qk-norm variant (QKN = true; replaces _fwd_kernel_qknorm, driven by
// _flash_qknorm_fwd_impl) is the same kernel on raw q and k: once the Q tile
// and each K tile have landed, every thread normalises its share of their
// rows in the swizzled slot by a per-head LayerNorm over D (ln_rows_sw128,
// the operation order of _ln_block), rounded to bf16, before Q.K^T. A
// resident K tile is normalised once for both passes; a streamed one each
// time it arrives.
#include "attn_f32.cuh"

namespace hv {

// ---------------------------------------------------------------------------
// The pipelined forward.
// ---------------------------------------------------------------------------

constexpr int FB_WG = 2;              // warpgroups (64 query rows each) a CTA
constexpr int FB_THREADS = 128 * FB_WG;
constexpr int FB_BQ = 64 * FB_WG;     // query rows per CTA
constexpr int FB_BK = 64;             // keys per tile job
constexpr int FB_NC = FB_BK / 16;     // 16-key chunks per tile

// Shared bytes, from a 1024-byte aligned base: the Q tile, then `stages`
// slots of a K tile, a V tile (all three 128-byte swizzled, rows as stored
// in device memory) and the tile's fp32 bias row, each slot rounded up to
// 1024 bytes so that every swizzled tile stays aligned.
template <int D>
__host__ __device__ constexpr int fb_q_bytes() { return sw128_bytes<D, FB_BQ>(); }

template <int D>
__host__ __device__ constexpr int fb_k_bytes() { return sw128_bytes<D, FB_BK>(); }

template <int D>
__host__ __device__ constexpr int fb_slot_bytes() {
  return (2 * fb_k_bytes<D>() + FB_BK * 4 + 1023) / 1024 * 1024;
}

template <int D>
__host__ __device__ constexpr int fb_smem_bytes(int stages) {
  return 1024 + fb_q_bytes<D>() + stages * fb_slot_bytes<D>();
}

// Per-head LayerNorm over D of the NROWS rows of a 128-byte-swizzled
// shared tile (load_tile_sw128's layout), in place, as
// hivae_tpu/ops/pallas/flash_attention.py::_ln_block (flax fast variance):
// fp32 sums of x and x^2, mean and mean of squares, var = max(mean2 -
// mean^2, 0), mul = rsqrt(var + eps) * gamma, y = (x - mean) * mul + beta,
// rounded to e16. NTHREADS / NROWS adjacent lanes share a row, each
// summing its D / (NTHREADS / NROWS) contiguous elements in order; the _rn
// intrinsics keep the plain version's separate roundings (no fused
// multiply-add). The mean and variance are over the hd real columns: the
// zero-filled columns past hd add nothing to the sums, and with gamma and
// beta zero-padded to D they stay zero. Rows past the sequence
// (zero-filled) become beta; their logits are masked and their outputs are
// not stored.
template <int D, int NROWS, int NTHREADS>
__device__ __forceinline__ void ln_rows_sw128(e16* T, const float* gamma,
                                              const float* beta, float eps,
                                              int tid, int hd) {
  constexpr int TPR = NTHREADS / NROWS;  // lanes a row
  constexpr int CH = D / 8 / TPR;        // 16-byte chunks a lane
  static_assert(TPR * NROWS == NTHREADS && CH * 8 * TPR == D,
                "whole chunks per lane");
  const int r = tid / TPR, c0 = (tid % TPR) * CH;
  unsigned char* base = reinterpret_cast<unsigned char*>(T);
  auto chunk = [&](int c) {
    return reinterpret_cast<uint4*>(base + (c >> 3) * NROWS * 128 + r * 128 +
                                    (((c & 7) ^ (r & 7)) << 4));
  };
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const uint4 x = *chunk(c0 + i);
    const e16* e = reinterpret_cast<const e16*>(&x);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = from_e16(e[j]);
      s = __fadd_rn(s, f);
      s2 = __fadd_rn(s2, __fmul_rn(f, f));
    }
  }
#pragma unroll
  for (int lane = 1; lane < TPR; lane <<= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, lane));
    s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, lane));
  }
  const float mean = __fdiv_rn(s, (float)hd), mean2 = __fdiv_rn(s2, (float)hd);
  const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
  const float rs = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    uint4 x = *chunk(c0 + i);
    e16* e = reinterpret_cast<e16*>(&x);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (c0 + i) * 8 + j;
      const float mul = __fmul_rn(rs, __ldg(gamma + col));
      e[j] = to_e16(__fadd_rn(
          __fmul_rn(__fsub_rn(from_e16(e[j]), mean), mul),
          __ldg(beta + col)));
    }
    *chunk(c0 + i) = x;
  }
}

// QKN: the qk-norm variant. q and k arrive raw; `norms` holds gamma_q,
// beta_q, gamma_k, beta_k (D floats each, zero past hd) and `eps` the
// LayerNorm epsilon. hd: the head dim of q, k, v and o (<= D).
template <int D, bool QKN>
__global__ void __launch_bounds__(FB_THREADS, D <= 64 ? 2 : 1)
full_block_fwd_kernel(const e16* __restrict__ q, const e16* __restrict__ k,
                      const e16* __restrict__ v,
                      const float* __restrict__ bias,
                      const float* __restrict__ norms, float eps,
                      e16* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ l_out, int H, int Sq, int Sk,
                      float scale, int stages, int resident, int hd,
                      long qsb, long qsh, long qss, long ksb, long ksh,
                      long kss, long vsb, long vsh, long vss, long osb,
                      long osh, long oss) {
  constexpr int NB = D / 32;  // 32-wide column blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  e16* Qs = reinterpret_cast<e16*>(base);
  unsigned char* ring = base + fb_q_bytes<D>();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FB_BQ;
  const e16* kp = k + b * ksb + h * ksh;
  const e16* vp = v + b * vsb + h * vsh;
  const float* brow = bias ? bias + (long)b * Sk : nullptr;
  const float sl2 = scale_log2(scale);
  const int nkt = (Sk + FB_BK - 1) / FB_BK, njobs = 2 * nkt;
  // a warpgroup (64 rows, one wgmma) wholly past Sq computes nothing
  const bool wg_active = q0 + wg * 64 < Sq;

  // job i < nkt: K tile i (and its bias row); job nkt + j: V tile j, and
  // K tile j again unless every K tile stays resident in its own slot
  auto slot = [&](int i) { return ring + (i % stages) * fb_slot_bytes<D>(); };
  auto issue = [&](int i) {
    unsigned char* sl = slot(i);
    const int j = i < nkt ? i : i - nkt;
    if (i < nkt || !resident) {
      load_tile_sw128<D, FB_BK, FB_THREADS>(reinterpret_cast<e16*>(sl), kp,
                                            kss, j * FB_BK, Sk, tid, hd);
      if (brow)
        load_row_f32<FB_BK, FB_THREADS>(
            reinterpret_cast<float*>(sl + 2 * fb_k_bytes<D>()), brow,
            j * FB_BK, Sk, tid);
    }
    if (i >= nkt)
      load_tile_sw128<D, FB_BK, FB_THREADS>(
          reinterpret_cast<e16*>(sl + fb_k_bytes<D>()), vp, vss, j * FB_BK,
          Sk, tid, hd);
    ring_commit();
  };

  // the Q tile rides in job 0's group
  load_tile_sw128<D, FB_BQ, FB_THREADS>(Qs, q + b * qsb + h * qsh, qss, q0,
                                        Sq, tid, hd);
  int issued = 0;
  const int depth = resident ? njobs : stages - 1;
  for (; issued < depth && issued < njobs; ++issued) issue(issued);

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float il0 = 0.f, il1 = 0.f;
  // O accumulators of the warp's 16 rows, one wgmma m64n32 tile per 32
  // columns: acc[nb][4 j + e] as in wgmma_ss
  float acc[NB][16];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[nb][e] = 0.f;

  for (int i = 0; i < njobs; ++i) {
    ring_wait_upto(issued - 1 - i);
    fence_async_smem();
    __syncthreads();  // job i has landed; job i-1's slot is free
    if (issued < njobs) issue(issued++);
    if constexpr (QKN) {
      // LayerNorm the Q tile once (it rode in job 0) and each K tile as it
      // lands (a resident K tile keeps its normalised rows for pass 2),
      // then publish them to wgmma
      const bool new_k = i < nkt || !resident;
      if (i == 0)
        ln_rows_sw128<D, FB_BQ, FB_THREADS>(Qs, norms, norms + D, eps, tid,
                                            hd);
      if (new_k)
        ln_rows_sw128<D, FB_BK, FB_THREADS>(reinterpret_cast<e16*>(slot(i)),
                                            norms + 2 * D, norms + 3 * D, eps,
                                            tid, hd);
      if (i == 0 || new_k) {
        fence_async_smem();
        __syncthreads();
      }
    }
    if (!wg_active) continue;
    const int j = i < nkt ? i : i - nkt;
    const unsigned char* sl = slot(i);
    const e16* Ks = reinterpret_cast<const e16*>(sl);
    const unsigned char* Vs = sl + fb_k_bytes<D>();
    const float* Bs = reinterpret_cast<const float*>(sl + 2 * fb_k_bytes<D>());
    const int nc = min(FB_NC, (Sk - j * FB_BK + 15) / 16);

    // raw scores of the warpgroup's 64 rows against the tile's keys up to
    // the next multiple of 16 past Sk; this warp's 16 rows, the C layout
    // of 8 n tiles: s[4 (2c + n) + e]
    float s[32];
    switch (nc) {
      case 1: wgmma_qk<D, 16, FB_BQ, FB_BK>(s, Qs, wg * 64, Ks); break;
      case 2: wgmma_qk<D, 32, FB_BQ, FB_BK>(s, Qs, wg * 64, Ks); break;
      case 3: wgmma_qk<D, 48, FB_BQ, FB_BK>(s, Qs, wg * 64, Ks); break;
      default: wgmma_qk<D, 64, FB_BQ, FB_BK>(s, Qs, wg * 64, Ks); break;
    }

    // base-2 bias of this lane's two columns of n tile (c, n); -inf past
    // Sk. A tile wholly inside Sk with no bias has none (plain).
    const bool plain = !brow && (j + 1) * FB_BK <= Sk;
    auto col_bias = [&](int c, int n, float bl[2]) {
      if (plain) {
        bl[0] = bl[1] = 0.f;
        return;
      }
      const int col = c * 16 + n * 8 + 2 * t;
      const float2 bb = brow ? *reinterpret_cast<const float2*>(Bs + col)
                             : make_float2(0.f, 0.f);
      bl[0] = j * FB_BK + col < Sk ? bias_log2(bb.x) : -INFINITY;
      bl[1] = j * FB_BK + col + 1 < Sk ? bias_log2(bb.y) : -INFINITY;
    };

    if (i < nkt) {
      // pass 1: online row max and denominator of the base-2 logits
#pragma unroll
      for (int c = 0; c < FB_NC; ++c)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float* x = s + 4 * (2 * c + n);
          if (c < nc) {
            float bl[2];
            col_bias(c, n, bl);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              x[e] = attn_logit2(x[e], sl2, bl[e]);
              x[2 + e] = attn_logit2(x[2 + e], sl2, bl[e]);
            }
          } else {
            x[0] = x[1] = x[2] = x[3] = -INFINITY;
          }
        }
      // row max and sum over the tile in four independent chains a row
      float mx[2][4], sm[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          mx[r][u] = fmaxf(s[8 * u + 2 * r], s[8 * u + 2 * r + 1]);
          mx[r][u] = fmaxf(mx[r][u], fmaxf(s[8 * u + 4 + 2 * r],
                                           s[8 * u + 5 + 2 * r]));
        }
      const float mn0 = fmaxf(m0, quad_max(fmaxf(fmaxf(mx[0][0], mx[0][1]),
                                                 fmaxf(mx[0][2], mx[0][3]))));
      const float mn1 = fmaxf(m1, quad_max(fmaxf(fmaxf(mx[1][0], mx[1][1]),
                                                 fmaxf(mx[1][2], mx[1][3]))));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sm[0][u] = sm[1][u] = 0.f;
        if (u < nc)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float* x = s + 8 * u + 4 * n;
            sm[0][u] += ex2(x[0] - mn0) + ex2(x[1] - mn0);
            sm[1][u] += ex2(x[2] - mn1) + ex2(x[3] - mn1);
          }
      }
      l0 = l0 * ex2(m0 - mn0) +
           quad_sum((sm[0][0] + sm[0][1]) + (sm[0][2] + sm[0][3]));
      l1 = l1 * ex2(m1 - mn1) +
           quad_sum((sm[1][0] + sm[1][1]) + (sm[1][2] + sm[1][3]));
      m0 = mn0;
      m1 = mn1;
      if (i == nkt - 1) {
        il0 = __frcp_rn(l0);
        il1 = __frcp_rn(l1);
      }
    } else {
      // pass 2: normalised e16 probabilities times V, fp32 accumulation:
      // P of chunk c, rounded to e16, is the A operand (registers) of
      // wgmma m64n32k16 against the chunk's 16 V rows (MN-major), issued
      // asynchronously while the next chunk's P is formed
      uint32_t pa[FB_NC][4] = {};
#pragma unroll
      for (int c = 0; c < FB_NC; ++c) {
        if (c < nc) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            float* x = s + 4 * (2 * c + n);
            float bl[2];
            col_bias(c, n, bl);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              x[e] = attn_p(x[e], sl2, bl[e], m0, il0);
              x[2 + e] = attn_p(x[2 + e], sl2, bl[e], m1, il1);
            }
          }
          c_to_a(pa[c], s + 8 * c, s + 8 * c + 4);
          wgmma_fence();
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            wgmma_rs32(acc[nb], pa[c],
                       desc_sw128_mn(Vs + (nb / 2) * FB_BK * 128 +
                                         (nb % 2) * 64 + c * 2048,
                                     FB_BK * 128));
          wgmma_commit();
        }
      }
      wgmma_wait_all();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
#pragma unroll
      for (int c = 0; c < FB_NC; ++c) fence_regs(pa[c]);
    }
  }
  if (!wg_active) return;

  e16* op = o + b * osb + h * osh;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int col = nb * 32 + jn * 8 + 2 * t;
      const float* a = acc[nb] + 4 * jn;
      if (col >= hd) continue;
      if (r0 < Sq) store_e16x2(op + (long)r0 * oss + col, a[0], a[1], 1.f);
      if (r1 < Sq) store_e16x2(op + (long)r1 * oss + col, a[2], a[3], 1.f);
    }
  // softmax statistics for the backward (m in base-2 units): every lane of
  // a quad holds them
  if (m_out && t == 0) {
    const long rb = ((long)b * H + h) * Sq;
    if (r0 < Sq) { m_out[rb + r0] = m0; l_out[rb + r0] = l0; }
    if (r1 < Sq) { m_out[rb + r1] = m1; l_out[rb + r1] = l1; }
  }
}

constexpr int HV_BAD_PLAN = -2;
constexpr int SMEM_MAX = 232448;  // bytes one block may use on the H100
constexpr int FB_STAGES = 3;      // slots of a streaming ring

// Takes only the plans flash_attention.py::_full_block_plan returns: one
// slot per key tile (resident), or a FB_STAGES-slot ring.
template <int D, bool QKN>
int launch_full_block(const void* q, const void* k, const void* v,
                      const float* bias, const float* norms, float eps,
                      void* o, float* m_out, float* l_out, int B, int H,
                      int Sq, int Sk, int hd, int stages, int resident,
                      int smem, float scale, const long* st,
                      cudaStream_t stream) {
  const int nkt = (Sk + FB_BK - 1) / FB_BK;
  if (stages != (resident ? nkt : FB_STAGES) ||
      smem != fb_smem_bytes<D>(stages) || smem > SMEM_MAX)
    return HV_BAD_PLAN;
  cudaError_t err = cudaFuncSetAttribute(
      full_block_fwd_kernel<D, QKN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + FB_BQ - 1) / FB_BQ, H, B);
  full_block_fwd_kernel<D, QKN><<<grid, FB_THREADS, smem, stream>>>(
      static_cast<const e16*>(q), static_cast<const e16*>(k),
      static_cast<const e16*>(v), bias, norms, eps, static_cast<e16*>(o),
      m_out, l_out, H, Sq, Sk, scale, stages, resident, hd, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v,
               const float* bias, const float* norms, float eps, void* o,
               float* m_out, float* l_out, int B, int H, int Sq, int Sk,
               int hd, int stages, int resident, int smem, float scale,
               const long* st, cudaStream_t stream) {
  return norms ? launch_full_block<D, true>(q, k, v, bias, norms, eps, o,
                                            m_out, l_out, B, H, Sq, Sk, hd,
                                            stages, resident, smem, scale,
                                            st, stream)
               : launch_full_block<D, false>(q, k, v, bias, norms, eps, o,
                                             m_out, l_out, B, H, Sq, Sk, hd,
                                             stages, resident, smem, scale,
                                             st, stream);
}

// ---------------------------------------------------------------------------
// fp32 variant (full_block_fwd_f32_kernel, hv_full_block_fwd_f32): the same
// function with fp32 Q, K, V and O and P kept in fp32 for P.V, as
// _fwd_kernel computes it for fp32 operands (its p.astype(v.dtype) is then
// the identity), and its QKN variant (_fwd_kernel_qknorm at fp32).
// It serves `--mp no` training and the fp32 frozen models the head
// trainers run: the joint blocks and object encoder of the flagship (D 64,
// S 260-512), the T2M joint block (D 128), the MAE (D 32 and 64), AMD_L's
// DiT (D 96).
//
// Bound on the H100 SXM at (32, 16, 512, 64): 4*B*H*S*S*D = 34.4 GFLOP of
// matmul, three TF32 products each (a hi/lo split, attn_f32.cuh): 0.208 ms
// at TF32's 494.7 TFLOP/s, against 67 MB of q, k, v and o, 0.020 ms at
// 3.35 TB/s: bound by operations. At fp32 the TPU kernel's rounding point
// (bf16 of the normalised P) is the identity, so one online-softmax pass
// over the keys computes the same O to within fp32 rounding: Q.K^T once.
//
// Design (FF32 has the plan). A CTA of two warpgroups takes 128 query rows
// of one (batch, head), 64 a warpgroup, and walks tiles of BK keys (64 at D
// <= 64, else 32). Every operand is split into TF32 hi and lo parts once,
// when it lands: Q once a CTA, each K and V tile once, by one pass of the
// CTA over the raw tile (split_rows_tf32, split_cols_tf32); no product
// splits anything. Both products run on TF32 wgmma, three a k step:
//  * S = Q.K^T: SS, Q (128 x D) and the tile's K (BK x D), both K-major
//    over D as they are stored, the small terms in their own accumulator;
//    S stays in registers (the wgmma C layout), where the online softmax
//    runs: base-2 logits with attn_logit2 (the tile's base-2 bias row, -inf
//    past Sk, is written by the split pass), the row max and sum by quad
//    shuffles, the running O rescaled by 2^(m_old - m).
//  * O += P~.V: RS, P~ split in registers as the A operand (a C-layout
//    column pair 2t, 2t + 1 is k index t, t + 4), V transposed into a
//    K-major D x BK tile whose k positions follow that order
//    (split_cols_tf32). Each tile's product goes into a fresh accumulator
//    added to O once.
// Overlap: the raw K and V of the next tile land by cp.async while this
// one computes; where two split buffers fit (D < 128), the CTA splits the
// next tile while this tile's P.V wgmmas run, and the two warpgroups'
// products and softmax interleave on the SM. At D 128 one split buffer
// fits beside Q: the split waits for P.V. At the end O = acc * (1/l); m
// (base-2) and l are saved as the bf16 forward saves them, so the fp32
// backward forms P = 2^(t - m) / l. Keys past Sk are -inf; rows past Sq
// are zero-filled and not stored; a fully masked row (bias -1e30 on every
// key) averages its keys uniformly. QKN: the raw Q tile once and each raw
// K tile once are normalised in place by ln_rows_f32 (the operation order
// of _ln_block, fp32 throughout) before they are split.
template <int D>
struct FF32 {
  static constexpr int WG = 2, THREADS = 128 * WG, ROWS = 64 * WG;
  static constexpr int BK = D <= 64 ? 64 : 32;    // keys a tile
  static constexpr int NSPLIT = D < 128 ? 2 : 1;  // split K / V^T buffers
  static constexpr int Q = ROWS * D * 4;          // one part (hi or lo) of Q
  static constexpr int KT = BK * D * 4;           // one part of K or of V^T
  static constexpr int SPLIT = 4 * KT;            // K hi, lo, V^T hi, lo
  static constexpr int RAW = 2 * KT + BK * 4;     // raw K, V, bias row
  // from a 1024-byte aligned base: Q hi, Q lo, the split buffers, the raw
  // tile, a base-2 bias row a split buffer
  static constexpr int SMEM = 1024 + 2 * Q + NSPLIT * SPLIT + RAW +
                              NSPLIT * BK * 4;
};

// Per-head LayerNorm over D of the ROWS rows of a shared fp32 tile (rows D
// floats apart), in place, as _ln_block (flax fast variance): fp32 sums of
// x and x^2, mean and mean of squares, var = max(mean2 - mean^2, 0), mul =
// rsqrt(var + eps) * gamma, y = (x - mean) * mul + beta; the _rn
// intrinsics keep the plain version's separate roundings. NT / ROWS
// adjacent lanes share a row and hold it in registers, 16 bytes at a time:
// lane l takes chunks l, l + TPR, ... of its row, starting TPR chunks
// further on each row, so the 8 lanes of one 16-byte access phase meet
// distinct banks. The mean and variance are over the hd real columns (the
// zero-filled ones past hd add nothing; with gamma and beta zero-padded to
// D they stay zero). Rows past the sequence (zero-filled) become beta;
// their logits are masked and their outputs not stored.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void ln_rows_f32(float* T, const float* gamma,
                                            const float* beta, float eps,
                                            int tid, int hd) {
  constexpr int TPR = NT / ROWS, C = D / 4, CH = C / TPR;
  static_assert(TPR * ROWS == NT && CH * TPR == C && TPR <= 32,
                "whole rows a lane group");
  const int r = tid / TPR, l = tid % TPR;
  float4* x = reinterpret_cast<float4*>(T + r * D);
  float4 v[CH];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    v[i] = x[(l + TPR * (i + r)) % C];
    const float e[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s = __fadd_rn(s, e[j]);
      s2 = __fadd_rn(s2, __fmul_rn(e[j], e[j]));
    }
  }
#pragma unroll
  for (int lane = 1; lane < TPR; lane <<= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, lane));
    s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, lane));
  }
  const float mean = __fdiv_rn(s, (float)hd), mean2 = __fdiv_rn(s2, (float)hd);
  const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
  const float rs = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = (l + TPR * (i + r)) % C;
    const float4 gm = __ldg(reinterpret_cast<const float4*>(gamma) + c);
    const float4 bt = __ldg(reinterpret_cast<const float4*>(beta) + c);
    auto y = [&](float xe, float ge, float be) {
      return __fadd_rn(__fmul_rn(__fsub_rn(xe, mean), __fmul_rn(rs, ge)),
                       be);
    };
    x[c] = make_float4(y(v[i].x, gm.x, bt.x), y(v[i].y, gm.y, bt.y),
                       y(v[i].z, gm.z, bt.z), y(v[i].w, gm.w, bt.w));
  }
}

template <int D, bool QKN>
__global__ void __launch_bounds__(FF32<D>::THREADS, 1)
full_block_fwd_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ bias,
                          const float* __restrict__ norms, float eps,
                          float* __restrict__ o, float* __restrict__ m_out,
                          float* __restrict__ l_out, int H, int Sq, int Sk,
                          float scale, int hd, long qsb, long qsh, long qss,
                          long ksb, long ksh, long kss, long vsb, long vsh,
                          long vss, long osb, long osh, long oss) {
  using P = FF32<D>;
  constexpr int R = P::ROWS, BK = P::BK, NS = P::NSPLIT, NT = P::THREADS;
  constexpr int KT = P::KT;
  extern __shared__ __align__(16) unsigned char ff_smem[];
  unsigned char* base = ff_smem + ((1024 - (smem_addr(ff_smem) & 1023)) & 1023);
  unsigned char* Qh = base;
  unsigned char* Ql = base + P::Q;
  unsigned char* split = base + 2 * P::Q;
  float* Kraw = reinterpret_cast<float*>(split + NS * P::SPLIT);
  float* Vraw = Kraw + BK * D;
  float* Braw = Vraw + BK * D;
  float* BL = Braw + BK;  // NS rows of BK base-2 key biases

  const int tid = threadIdx.x, warp = tid >> 5, wg = warp >> 2;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * R;
  const float* kp = k + b * ksb + h * ksh;
  const float* vp = v + b * vsb + h * vsh;
  const float* brow = bias ? bias + (long)b * Sk : nullptr;
  const float sl2 = scale_log2(scale);
  const int nkt = (Sk + BK - 1) / BK;

  // the raw K and V of tile j and its bias row
  auto issue = [&](int j) {
    f32_copy_rows<D, BK, NT>(Kraw, kp, kss, j * BK, Sk, tid, hd);
    f32_copy_rows<D, BK, NT>(Vraw, vp, vss, j * BK, Sk, tid, hd);
    if (brow) load_row_f32<BK, NT>(Braw, brow, j * BK, Sk, tid);
    ring_commit();
  };
  // raw tile j into split buffer j % NS: K as it is, V transposed, and
  // the keys' base-2 bias (-inf past Sk)
  auto split_kv = [&](int j) {
    unsigned char* sb = split + (j % NS) * P::SPLIT;
    split_rows_tf32<BK, D, NT>(sb, sb + KT, Kraw, tid);
    split_cols_tf32<BK, D, NT>(sb + 2 * KT, sb + 3 * KT, 0, Vraw, tid);
    for (int c = tid; c < BK; c += NT)
      BL[(j % NS) * BK + c] =
          j * BK + c < Sk ? bias_log2(brow ? Braw[c] : 0.f) : -INFINITY;
  };

  // the raw Q tile lands in the split buffers and rides in tile 0's group
  float* Qraw = reinterpret_cast<float*>(split);
  f32_copy_rows<D, R, NT>(Qraw, q + b * qsb + h * qsh, qss, q0, Sq, tid,
                          hd);
  issue(0);
  ring_wait_upto(0);
  __syncthreads();
  if constexpr (QKN) {
    ln_rows_f32<D, R, NT>(Qraw, norms, norms + D, eps, tid, hd);
    ln_rows_f32<D, BK, NT>(Kraw, norms + 2 * D, norms + 3 * D, eps, tid, hd);
    __syncthreads();
  }
  split_rows_tf32<R, D, NT>(Qh, Ql, Qraw, tid);
  __syncthreads();  // Q read before split buffer 0 is written over it
  split_kv(0);
  fence_async_smem();
  __syncthreads();
  if (nkt > 1) issue(1);

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[D / 2];  // O of the warp's rows g and g + 8 (C layout)
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    const unsigned char* sb = split + (j % NS) * P::SPLIT;
    const float* bl = BL + (j % NS) * BK;
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
    float tmp[D / 2];
    {
      float big[BK / 2], small[BK / 2];
      fence_regs(big);
      fence_regs(small);
      wgmma_fence();
      wg_scores_tf32<D / 8, BK, R>(big, small, Qh, Ql, 64 * wg, sb,
                                   sb + KT, 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(big);
      fence_regs(small);

      // base-2 logits, the rows' online max and sum, P~ = 2^(t - m) in big
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int c = 0; c < BK / 8; ++c) {
        const float2 bb =
            *reinterpret_cast<const float2*>(bl + 8 * c + 2 * t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float be = e ? bb.y : bb.x;
          float* x = big + 4 * c + e;
          x[0] = attn_logit2(x[0] + small[4 * c + e], sl2, be);
          x[2] = attn_logit2(x[2] + small[4 * c + 2 + e], sl2, be);
          mx0 = fmaxf(mx0, x[0]);
          mx1 = fmaxf(mx1, x[2]);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* x = big + 4 * c + e;
          x[0] = ex2(x[0] - mn0);
          x[2] = ex2(x[2] - mn1);
          s0 += x[0];
          s1 += x[2];
        }
      l0 = l0 * al0 + quad_sum(s0);
      l1 = l1 * al1 + quad_sum(s1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] *= (e & 2) ? al1 : al0;

      // P~.V into a fresh accumulator, asynchronously
      frag_from_acc<BK>(ph, pl, big);
      fence_regs(tmp);
      wgmma_fence();
      wg_product_tf32<BK / 8, D, D>(tmp, ph, pl, sb + 2 * KT, sb + 3 * KT,
                                    0, 0);
      wgmma_commit();
    }
    if (NS == 2 && j + 1 < nkt) {
      // the next tile, split while P.V runs
      ring_wait_upto(0);
      __syncthreads();
      if constexpr (QKN) {
        ln_rows_f32<D, BK, NT>(Kraw, norms + 2 * D, norms + 3 * D, eps, tid,
                               hd);
        __syncthreads();
      }
      split_kv(j + 1);
      fence_async_smem();
    }
    {
      wgmma_wait_all();
      fence_regs(tmp);
      fence_frags(ph);
      fence_frags(pl);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] += tmp[e];
    }
    if (NS == 1 && j + 1 < nkt) {
      // one split buffer: the next tile once every warpgroup's P.V is done
      ring_wait_upto(0);
      __syncthreads();
      if constexpr (QKN) {
        ln_rows_f32<D, BK, NT>(Kraw, norms + 2 * D, norms + 3 * D, eps, tid,
                               hd);
        __syncthreads();
      }
      split_kv(j + 1);
      fence_async_smem();
    }
    __syncthreads();  // the raw tile is free; the split one is published
    if (j + 2 < nkt) issue(j + 2);
  }

  const float il0 = __frcp_rn(l0), il1 = __frcp_rn(l1);
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  float* op = o + b * osb + h * osh;
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn) {
    const int col = 8 * jn + 2 * t;
    if (col >= hd) continue;
    if (r0 < Sq)
      *reinterpret_cast<float2*>(op + (long)r0 * oss + col) =
          make_float2(acc[4 * jn] * il0, acc[4 * jn + 1] * il0);
    if (r1 < Sq)
      *reinterpret_cast<float2*>(op + (long)r1 * oss + col) =
          make_float2(acc[4 * jn + 2] * il1, acc[4 * jn + 3] * il1);
  }
  // softmax statistics for the backward, as the bf16 forward saves them
  if (m_out && t == 0) {
    const long rb = ((long)b * H + h) * Sq;
    if (r0 < Sq) { m_out[rb + r0] = m0; l_out[rb + r0] = l0; }
    if (r1 < Sq) { m_out[rb + r1] = m1; l_out[rb + r1] = l1; }
  }
}

// Takes only the plan flash_attention.py::_full_block_f32_plan returns.
template <int D, bool QKN>
int launch_full_block_f32(const float* q, const float* k, const float* v,
                          const float* bias, const float* norms, float eps,
                          float* o, float* m_out, float* l_out, int B, int H,
                          int Sq, int Sk, int hd, int rows, int tile,
                          int smem, float scale, const long* st,
                          cudaStream_t stream) {
  using P = FF32<D>;
  if (rows != P::ROWS || tile != P::BK || smem != P::SMEM || smem > SMEM_MAX)
    return HV_BAD_PLAN;
  cudaError_t err = cudaFuncSetAttribute(
      full_block_fwd_f32_kernel<D, QKN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + P::ROWS - 1) / P::ROWS, H, B);
  full_block_fwd_f32_kernel<D, QKN><<<grid, P::THREADS, smem, stream>>>(
      q, k, v, bias, norms, eps, o, m_out, l_out, H, Sq, Sk, scale, hd,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11]);
  return cudaGetLastError();
}

template <int D>
int launch_fwd_f32(const void* q, const void* k, const void* v,
                   const float* bias, const float* norms, float eps, void* o,
                   float* m_out, float* l_out, int B, int H, int Sq, int Sk,
                   int hd, int rows, int tile, int smem, float scale,
                   const long* st, cudaStream_t stream) {
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(o);
  return norms ? launch_full_block_f32<D, true>(
                     fq, fk, fv, bias, norms, eps, fo, m_out, l_out, B, H,
                     Sq, Sk, hd, rows, tile, smem, scale, st, stream)
               : launch_full_block_f32<D, false>(
                     fq, fk, fv, bias, norms, eps, fo, m_out, l_out, B, H,
                     Sq, Sk, hd, rows, tile, smem, scale, st, stream);
}

}  // namespace hv

// Plain C entry point. `strides` holds 12 element strides: (batch, head,
// row) for q, k, v and o in that order; the last dimension is contiguous.
// D is the head dim, any multiple of 8 up to 128: the kernel runs the
// tile width hv::full_block_tile(D) (32, 64, 96 or 128; columns past D
// zero-filled). `norms` is null, or for the qk-norm variant (q and k raw)
// a contiguous (4, tile) fp32 array (gamma_q, beta_q, gamma_k, beta_k,
// each zero past D) with `eps` the LayerNorm epsilon. `m_out` and `l_out`
// are null, or contiguous (B, H, Sq) fp32 buffers that receive each row's
// base-2 logit max and softmax denominator for the backward. `stages`,
// `resident` and `smem` are the launch plan of
// flash_attention.py::_full_block_plan at the tile width. Returns a
// cudaError_t, -1 for an unsupported head dim, -2 for a plan the kernel
// does not take. Built with -DHV_F16, q, k, v and o are fp16 and the fp32
// entry point is left out.
extern "C" int hv_full_block_fwd(const void* q, const void* k, const void* v,
                                 const float* bias, const float* norms,
                                 void* o, float* m_out, float* l_out, int B,
                                 int H, int Sq, int Sk, int D, int stages,
                                 int resident, int smem, float scale,
                                 float eps, const long* strides,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hv::full_block_tile(D)) {
    case 32: return hv::launch_fwd<32>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, D, stages, resident, smem, scale, strides, s);
    case 64: return hv::launch_fwd<64>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, D, stages, resident, smem, scale, strides, s);
    case 96: return hv::launch_fwd<96>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, D, stages, resident, smem, scale, strides, s);
    case 128: return hv::launch_fwd<128>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, D, stages, resident, smem, scale, strides, s);
    default: return -1;
  }
}

#ifndef HV_F16
// fp32 entry point: as hv_full_block_fwd with fp32 q, k, v and o; `rows`,
// `tile` and `smem` are the forward plan of
// flash_attention.py::_full_block_f32_plan at the tile width.
extern "C" int hv_full_block_fwd_f32(const void* q, const void* k,
                                     const void* v, const float* bias,
                                     const float* norms, void* o,
                                     float* m_out, float* l_out, int B, int H,
                                     int Sq, int Sk, int D, int rows,
                                     int tile, int smem, float scale,
                                     float eps, const long* strides,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hv::full_block_tile(D)) {
    case 32: return hv::launch_fwd_f32<32>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, D, rows, tile, smem, scale, strides, s);
    case 64: return hv::launch_fwd_f32<64>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, D, rows, tile, smem, scale, strides, s);
    case 96: return hv::launch_fwd_f32<96>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, D, rows, tile, smem, scale, strides, s);
    case 128: return hv::launch_fwd_f32<128>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, D, rows, tile, smem, scale, strides, s);
    default: return -1;
  }
}
#endif

extern "C" const char* hv_full_block_error_string(int code) {
  if (code == -1) return "unsupported head dim";
  if (code == hv::HV_BAD_PLAN) return "launch plan not taken by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
