// Full-block attention forward for Hopper (sm_90a), bf16 in, bf16 out.
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
#include "attn_common.cuh"

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
// rounded to bf16. NTHREADS / NROWS adjacent lanes share a row, each
// summing its D / (NTHREADS / NROWS) contiguous elements in order; the _rn
// intrinsics keep the plain version's separate roundings (no fused
// multiply-add). Rows past the sequence (zero-filled) become beta; their
// logits are masked and their outputs are not stored.
template <int D, int NROWS, int NTHREADS>
__device__ __forceinline__ void ln_rows_sw128(bf16* T, const float* gamma,
                                              const float* beta, float eps,
                                              int tid) {
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
    const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(e[j]);
      s = __fadd_rn(s, f);
      s2 = __fadd_rn(s2, __fmul_rn(f, f));
    }
  }
#pragma unroll
  for (int lane = 1; lane < TPR; lane <<= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, lane));
    s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, lane));
  }
  const float mean = __fdiv_rn(s, (float)D), mean2 = __fdiv_rn(s2, (float)D);
  const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
  const float rs = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    uint4 x = *chunk(c0 + i);
    bf16* e = reinterpret_cast<bf16*>(&x);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (c0 + i) * 8 + j;
      const float mul = __fmul_rn(rs, __ldg(gamma + col));
      e[j] = __float2bfloat16_rn(__fadd_rn(
          __fmul_rn(__fsub_rn(__bfloat162float(e[j]), mean), mul),
          __ldg(beta + col)));
    }
    *chunk(c0 + i) = x;
  }
}

// QKN: the qk-norm variant. q and k arrive raw; `norms` holds gamma_q,
// beta_q, gamma_k, beta_k (D floats each) and `eps` the LayerNorm epsilon.
template <int D, bool QKN>
__global__ void __launch_bounds__(FB_THREADS, D <= 64 ? 2 : 1)
full_block_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ bias,
                      const float* __restrict__ norms, float eps,
                      bf16* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ l_out, int H, int Sq, int Sk,
                      float scale, int stages, int resident, long qsb,
                      long qsh, long qss, long ksb, long ksh, long kss,
                      long vsb, long vsh, long vss, long osb, long osh,
                      long oss) {
  constexpr int NB = D / 32;  // 32-wide column blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  unsigned char* ring = base + fb_q_bytes<D>();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FB_BQ;
  const bf16* kp = k + b * ksb + h * ksh;
  const bf16* vp = v + b * vsb + h * vsh;
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
      load_tile_sw128<D, FB_BK, FB_THREADS>(reinterpret_cast<bf16*>(sl), kp,
                                            kss, j * FB_BK, Sk, tid);
      if (brow)
        load_row_f32<FB_BK, FB_THREADS>(
            reinterpret_cast<float*>(sl + 2 * fb_k_bytes<D>()), brow,
            j * FB_BK, Sk, tid);
    }
    if (i >= nkt)
      load_tile_sw128<D, FB_BK, FB_THREADS>(
          reinterpret_cast<bf16*>(sl + fb_k_bytes<D>()), vp, vss, j * FB_BK,
          Sk, tid);
    ring_commit();
  };

  // the Q tile rides in job 0's group
  load_tile_sw128<D, FB_BQ, FB_THREADS>(Qs, q + b * qsb + h * qsh, qss, q0,
                                        Sq, tid);
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
        ln_rows_sw128<D, FB_BQ, FB_THREADS>(Qs, norms, norms + D, eps, tid);
      if (new_k)
        ln_rows_sw128<D, FB_BK, FB_THREADS>(reinterpret_cast<bf16*>(slot(i)),
                                            norms + 2 * D, norms + 3 * D, eps,
                                            tid);
      if (i == 0 || new_k) {
        fence_async_smem();
        __syncthreads();
      }
    }
    if (!wg_active) continue;
    const int j = i < nkt ? i : i - nkt;
    const unsigned char* sl = slot(i);
    const bf16* Ks = reinterpret_cast<const bf16*>(sl);
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
      // pass 2: normalised bf16 probabilities times V, fp32 accumulation:
      // P of chunk c, rounded to bf16, is the A operand (registers) of
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

  bf16* op = o + b * osb + h * osh;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int col = nb * 32 + jn * 8 + 2 * t;
      const float* a = acc[nb] + 4 * jn;
      if (r0 < Sq) store_bf16x2(op + (long)r0 * oss + col, a[0], a[1], 1.f);
      if (r1 < Sq) store_bf16x2(op + (long)r1 * oss + col, a[2], a[3], 1.f);
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
                      int Sq, int Sk, int stages, int resident, int smem,
                      float scale, const long* st, cudaStream_t stream) {
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
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, norms, eps, static_cast<bf16*>(o),
      m_out, l_out, H, Sq, Sk, scale, stages, resident, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v,
               const float* bias, const float* norms, float eps, void* o,
               float* m_out, float* l_out, int B, int H, int Sq, int Sk,
               int stages, int resident, int smem, float scale,
               const long* st, cudaStream_t stream) {
  return norms ? launch_full_block<D, true>(q, k, v, bias, norms, eps, o,
                                            m_out, l_out, B, H, Sq, Sk,
                                            stages, resident, smem, scale,
                                            st, stream)
               : launch_full_block<D, false>(q, k, v, bias, norms, eps, o,
                                             m_out, l_out, B, H, Sq, Sk,
                                             stages, resident, smem, scale,
                                             st, stream);
}

}  // namespace hv

// Plain C entry point. `strides` holds 12 element strides: (batch, head,
// row) for q, k, v and o in that order; the last dimension is contiguous.
// `norms` is null, or for the qk-norm variant (q and k raw) a contiguous
// (4, D) fp32 array (gamma_q, beta_q, gamma_k, beta_k) with `eps` the
// LayerNorm epsilon. `m_out` and `l_out` are null, or contiguous (B, H, Sq)
// fp32 buffers that receive each row's base-2 logit max and softmax
// denominator for the backward. `stages`, `resident` and `smem` are the
// launch plan of flash_attention.py::_full_block_plan. Returns a
// cudaError_t, -1 for an unsupported head dim, -2 for a plan the kernel
// does not take.
extern "C" int hv_full_block_fwd(const void* q, const void* k, const void* v,
                                 const float* bias, const float* norms,
                                 void* o, float* m_out, float* l_out, int B,
                                 int H, int Sq, int Sk, int D, int stages,
                                 int resident, int smem, float scale,
                                 float eps, const long* strides,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return hv::launch_fwd<32>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, stages, resident, smem, scale, strides, s);
    case 64: return hv::launch_fwd<64>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, stages, resident, smem, scale, strides, s);
    case 96: return hv::launch_fwd<96>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, stages, resident, smem, scale, strides, s);
    case 128: return hv::launch_fwd<128>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, stages, resident, smem, scale, strides, s);
    default: return -1;
  }
}

extern "C" const char* hv_full_block_error_string(int code) {
  if (code == -1) return "unsupported head dim";
  if (code == hv::HV_BAD_PLAN) return "launch plan not taken by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
