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

// ---------------------------------------------------------------------------
// fp32 variant (full_block_fwd_f32_kernel, hv_full_block_fwd_f32): the same
// function with fp32 Q, K, V and O and P kept in fp32 for P.V, as
// _fwd_kernel computes it for fp32 operands (its p.astype(v.dtype) is then
// the identity), and its QKN variant (_fwd_kernel_qknorm at fp32).
// It serves `--mp no` training and the fp32 frozen models the head
// trainers run: the joint blocks and object encoder of the flagship (D 64,
// S 260-512), the T2M joint block (D 128), the MAE (D 32 and 64).
//
// Bound on the H100 SXM at (8, 16, 260, 64): 4*B*H*S*S*D = 2.2 GFLOP of
// matmul, three TF32 products each (the hi/lo split of attn_f32.cuh): 13.3
// us at TF32's 494.7 TFLOP/s, against 34.6 MB of q, k, v and o, 10.3 us at
// 3.35 TB/s: bound by operations. At fp32 the TPU kernel's rounding point
// (bf16 of the normalised P) is the identity, so one online-softmax pass
// over the keys computes the same O to within fp32 rounding: Q.K^T once.
//
// Design. A CTA of 8 warps takes FF_ROWS = 64 query rows of one (batch,
// head) and keeps them in shared memory (rows D + 4 floats apart). Jobs
// travel through a two-slot cp.async ring, one tile of FF_TILE = 32 keys
// each: K_j, then V_j. A K job computes S = Q.K^T (f32_scores; the 16
// blocks of 16 x 8 two a warp) into a shared 64 x 32 tile; then thread tid
// takes row tid / 4, columns 8 (tid % 4).. of it: base-2 logits with
// attn_logit2 fold into the row's online max m and denominator l (the
// row's four threads meet by quad shuffles), the tile's P~ = 2^(x - m) is
// written over S, and the row's rescale 2^(m_old - m) goes to a shared
// column. A V job rescales the output rows by that column and adds P~.V
// (f32_grad: each warp owns D/8 columns of the 64 rows, or D/4 of 32 rows
// at D 32 and 96; each tile's product in a fresh accumulator). At the end
// O = acc * (1/l). m and l are saved as the bf16 forward saves them
// (base-2 m, l apart), so the fp32 backward forms P = 2^(x - m) / l.
// Keys past Sk are -inf; rows past Sq are zero-filled and not stored; a
// fully masked row (bias -1e30 on every key) averages its keys uniformly.
// QKN: the Q tile once and each K tile as it lands are normalised in place
// in shared memory by ln_rows_f32 (the operation order of _ln_block, fp32
// throughout) before S.
constexpr int FF_ROWS = 64;   // query rows a CTA
constexpr int FF_TILE = 32;   // keys a K or V tile

// Shared bytes: the Q tile, two slots of a K or V tile and its bias row,
// the 64 x 32 S / P tile (rows FF_TILE + 8 floats apart), and two columns
// of 64 rows (the tile's rescale, the final 1/l).
template <int D>
__host__ __device__ constexpr int ff_smem_bytes() {
  return 4 * (FF_ROWS * (D + 4) + 2 * (FF_TILE * (D + 4) + FF_TILE) +
              FF_ROWS * (FF_TILE + 8) + 2 * FF_ROWS);
}

// Per-head LayerNorm over D of the ROWS rows of a shared fp32 tile (rows
// D + 4 floats apart), in place, as _ln_block (flax fast variance): fp32
// sums of x and x^2, mean and mean of squares, var = max(mean2 - mean^2,
// 0), mul = rsqrt(var + eps) * gamma, y = (x - mean) * mul + beta.
// F32_THREADS / ROWS adjacent lanes share a row, each summing its D /
// (F32_THREADS / ROWS) contiguous elements in order; the _rn intrinsics keep
// the plain version's separate roundings. Rows past the sequence
// (zero-filled) become beta; their logits are masked and their outputs not
// stored.
template <int D, int ROWS>
__device__ __forceinline__ void ln_rows_f32(float* T, const float* gamma,
                                            const float* beta, float eps,
                                            int tid) {
  constexpr int TPR = F32_THREADS / ROWS, CH = D / TPR;
  static_assert(TPR * ROWS == F32_THREADS && CH * TPR == D && TPR <= 32,
                "whole rows a lane group");
  const int c0 = (tid % TPR) * CH;
  float* x = T + (tid / TPR) * (D + 4) + c0;
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    s = __fadd_rn(s, x[i]);
    s2 = __fadd_rn(s2, __fmul_rn(x[i], x[i]));
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
  for (int i = 0; i < CH; ++i)
    x[i] = __fadd_rn(__fmul_rn(__fsub_rn(x[i], mean),
                               __fmul_rn(rs, __ldg(gamma + c0 + i))),
                     __ldg(beta + c0 + i));
}

template <int D, bool QKN>
__global__ void __launch_bounds__(F32_THREADS, 2)
full_block_fwd_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ bias,
                          const float* __restrict__ norms, float eps,
                          float* __restrict__ o, float* __restrict__ m_out,
                          float* __restrict__ l_out, int H, int Sq, int Sk,
                          float scale, long qsb, long qsh, long qss,
                          long ksb, long ksh, long kss, long vsb, long vsh,
                          long vss, long osb, long osh, long oss) {
  constexpr int R = FF_ROWS, BT = FF_TILE, LD = D + 4, BTP = BT + 8;
  constexpr int MT = R / 16, NT = BT / 8, BPW = MT * NT / F32_WARPS;
  constexpr int CG = f32_col_groups<D>(), MG = F32_WARPS / CG;
  constexpr int MTW = MT / MG, NCW = D / CG / 8, W = f32_chunk(NCW, MTW);
  constexpr int SLOT = BT * LD + BT;
  extern __shared__ float4 ff_smem[];
  float* Qs = reinterpret_cast<float*>(ff_smem);
  float* ring = Qs + R * LD;
  float* XS = ring + 2 * SLOT;  // S, then P~, of the tile
  float* RS = XS + R * BTP;     // the rows' rescale; RS + R: their 1/l

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * R;
  const float* kp = k + b * ksb + h * ksh;
  const float* vp = v + b * vsb + h * vsh;
  const float* brow = bias ? bias + (long)b * Sk : nullptr;
  const float sl2 = scale_log2(scale);
  const int nkt = (Sk + BT - 1) / BT, njobs = 2 * nkt;

  // job 2j: K tile j with its bias row; job 2j + 1: V tile j; into slot
  // i % 2
  auto issue = [&](int i) {
    float* sl = ring + (i & 1) * SLOT;
    const int j = i >> 1;
    const bool isv = i & 1;
    f32_load_tile<D, BT>(sl, isv ? vp : kp, isv ? vss : kss, j * BT, Sk, tid);
    if (brow && !isv)
      load_row_f32<BT, F32_THREADS>(sl + BT * LD, brow, j * BT, Sk, tid);
    ring_commit();
  };
  // the Q tile rides in job 0's group
  f32_load_tile<D, R>(Qs, q + b * qsb + h * qsh, qss, q0, Sq, tid);
  issue(0);

  // this thread's softmax row er and columns ec.. of each tile
  const int er = tid >> 2, ec = (tid & 3) * 8;
  float m = -INFINITY, l = 0.f;
  float acc[MTW][NCW][4];
#pragma unroll
  for (int mm = 0; mm < MTW; ++mm)
#pragma unroll
    for (int n = 0; n < NCW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mm][n][e] = 0.f;
  const int mt = warp * BPW / NT, nt0 = warp * BPW % NT;
  const int mg = warp / CG, cg = warp % CG;
  // scale this warp's output rows by the shared column c
  auto scale_rows = [&](const float* c) {
#pragma unroll
    for (int mm = 0; mm < MTW; ++mm)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float a = c[16 * (mg * MTW + mm) + 8 * hf + g];
#pragma unroll
        for (int n = 0; n < NCW; ++n) {
          acc[mm][n][2 * hf] *= a;
          acc[mm][n][2 * hf + 1] *= a;
        }
      }
  };

  for (int i = 0; i < njobs; ++i) {
    ring_wait_upto(0);
    __syncthreads();  // job i has landed; job i - 1's slot is free
    if (i + 1 < njobs) issue(i + 1);
    float* sl = ring + (i & 1) * SLOT;
    if (i & 1) {
      // O = O * 2^(m_old - m) + P~.V over this warp's columns
      scale_rows(RS);
      f32_grad<MTW, NCW, W, BT, false>(acc, acc, XS + 16 * mg * MTW * BTP,
                                       nullptr, BTP, sl + cg * (D / CG),
                                       nullptr, LD, g, t);
      continue;
    }
    const int j = i >> 1;
    if constexpr (QKN) {
      if (i == 0) ln_rows_f32<D, R>(Qs, norms, norms + D, eps, tid);
      ln_rows_f32<D, BT>(sl, norms + 2 * D, norms + 3 * D, eps, tid);
      __syncthreads();
    }
    {
      float xb[BPW][4], xs[BPW][4];
      f32_scores<BPW, D / 8>(xb, xs, Qs + 16 * mt * LD, sl + 8 * nt0 * LD,
                             LD, g, t);
      f32_store_blocks<BPW>(XS + 16 * mt * BTP + 8 * nt0, BTP, xb, xs, g, t);
    }
    __syncthreads();
    float* xr = XS + er * BTP + ec;
    const float4 x0 = *reinterpret_cast<const float4*>(xr);
    const float4 x1 = *reinterpret_cast<const float4*>(xr + 4);
    float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float* bs = sl + BT * LD;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int key = j * BT + ec + e;
      x[e] = key < Sk ? attn_logit2(x[e], sl2,
                                    bias_log2(brow ? bs[ec + e] : 0.f))
                      : -INFINITY;
    }
    // the row's online max and denominator, P~ over the tile's S
    float mx = x[0];
#pragma unroll
    for (int e = 1; e < 8; ++e) mx = fmaxf(mx, x[e]);
    const float mn = fmaxf(m, quad_max(mx)), alpha = ex2(m - mn);
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      x[e] = ex2(x[e] - mn);
      sum += x[e];
    }
    l = l * alpha + quad_sum(sum);
    m = mn;
    *reinterpret_cast<float4*>(xr) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(xr + 4) = make_float4(x[4], x[5], x[6], x[7]);
    if ((tid & 3) == 0) {
      RS[er] = alpha;
      if (j == nkt - 1) RS[R + er] = __frcp_rn(l);
    }
  }
  scale_rows(RS + R);  // 1/l, written at the last K job

  float* op = o + b * osb + h * osh;
#pragma unroll
  for (int mm = 0; mm < MTW; ++mm)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + 16 * (mg * MTW + mm) + 8 * hf + g;
      if (row >= Sq) continue;
#pragma unroll
      for (int n = 0; n < NCW; ++n)
        *reinterpret_cast<float2*>(op + (long)row * oss + cg * (D / CG) +
                                   8 * n + 2 * t) =
            make_float2(acc[mm][n][2 * hf], acc[mm][n][2 * hf + 1]);
    }
  // softmax statistics for the backward, as the bf16 forward saves them
  const int row = q0 + er;
  if (m_out && (tid & 3) == 0 && row < Sq) {
    const long rb = ((long)b * H + h) * Sq;
    m_out[rb + row] = m;
    l_out[rb + row] = l;
  }
}

// Takes only the plan flash_attention.py::_full_block_f32_plan returns.
template <int D, bool QKN>
int launch_full_block_f32(const float* q, const float* k, const float* v,
                          const float* bias, const float* norms, float eps,
                          float* o, float* m_out, float* l_out, int B, int H,
                          int Sq, int Sk, int rows, int tile, int smem,
                          float scale, const long* st, cudaStream_t stream) {
  if (rows != FF_ROWS || tile != FF_TILE || smem != ff_smem_bytes<D>() ||
      smem > SMEM_MAX)
    return HV_BAD_PLAN;
  cudaError_t err = cudaFuncSetAttribute(
      full_block_fwd_f32_kernel<D, QKN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + FF_ROWS - 1) / FF_ROWS, H, B);
  full_block_fwd_f32_kernel<D, QKN><<<grid, F32_THREADS, smem, stream>>>(
      q, k, v, bias, norms, eps, o, m_out, l_out, H, Sq, Sk, scale, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  return cudaGetLastError();
}

template <int D>
int launch_fwd_f32(const void* q, const void* k, const void* v,
                   const float* bias, const float* norms, float eps, void* o,
                   float* m_out, float* l_out, int B, int H, int Sq, int Sk,
                   int rows, int tile, int smem, float scale, const long* st,
                   cudaStream_t stream) {
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(o);
  return norms ? launch_full_block_f32<D, true>(
                     fq, fk, fv, bias, norms, eps, fo, m_out, l_out, B, H,
                     Sq, Sk, rows, tile, smem, scale, st, stream)
               : launch_full_block_f32<D, false>(
                     fq, fk, fv, bias, norms, eps, fo, m_out, l_out, B, H,
                     Sq, Sk, rows, tile, smem, scale, st, stream);
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

// fp32 entry point: as hv_full_block_fwd with fp32 q, k, v and o; `rows`,
// `tile` and `smem` are the forward plan of
// flash_attention.py::_full_block_f32_plan.
extern "C" int hv_full_block_fwd_f32(const void* q, const void* k,
                                     const void* v, const float* bias,
                                     const float* norms, void* o,
                                     float* m_out, float* l_out, int B, int H,
                                     int Sq, int Sk, int D, int rows,
                                     int tile, int smem, float scale,
                                     float eps, const long* strides,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return hv::launch_fwd_f32<32>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, rows, tile, smem, scale, strides, s);
    case 64: return hv::launch_fwd_f32<64>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, rows, tile, smem, scale, strides, s);
    case 96: return hv::launch_fwd_f32<96>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, rows, tile, smem, scale, strides, s);
    case 128: return hv::launch_fwd_f32<128>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, rows, tile, smem, scale, strides, s);
    default: return -1;
  }
}

extern "C" const char* hv_full_block_error_string(int code) {
  if (code == -1) return "unsupported head dim";
  if (code == hv::HV_BAD_PLAN) return "launch plan not taken by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
