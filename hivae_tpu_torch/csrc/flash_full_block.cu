// Full-block attention forward for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces hivae_tpu/ops/pallas/flash_attention.py::_fwd_kernel (driven by
// _flash_fwd_impl): softmax(Q.K^T * scale + key_bias) . V over sequences of
// a few hundred to ~1024 keys, with fp32 logits and softmax, the normalised
// probabilities rounded to bf16 before P.V, and fp32 accumulation.
//
// Design. One CTA of 4 warps takes 64 query rows of one (batch, head); each
// warp owns 16 rows end to end and the warps share only the K/V tiles
// (64 keys each) staged in shared memory. The softmax is two-pass over all
// keys of the row: pass 1 computes Q.K^T tile by tile and keeps only the
// running row max and denominator; pass 2 recomputes Q.K^T, forms the
// normalised P = exp(s - m) / l exactly as the TPU kernel does (so P is
// rounded after normalisation), and accumulates P.V in registers on the
// tensor cores (mma.sync m16n8k16). Nothing of size S x S is ever stored;
// ragged Sq/Sk (260, 266) are handled by zero-filled tile rows and -inf
// logits past Sk, not by padding tensors on the host.
//
// Bound on the H100 SXM: the work is 4*B*H*Sq*Sk*D matmul FLOPs over
// (q + k + v + o) bf16 bytes; at the path shapes (B*H = 256, S = 260..512,
// D = 64) that is 4.4-17 GFLOP against 35-67 MB, i.e. 4.5-17 us of tensor
// time at 989 TFLOP/s versus 10-20 us of HBM time at 3.35 TB/s, so the
// bound is bytes. This kernel recomputes Q.K^T (1.5x the FLOPs) and re-reads
// K/V per 64-row query tile from L2. Each tile arrives by cp.async in one
// batch, but loads do not overlap compute (one buffer); wgmma/TMA
// pipelining is later work.
//
// The same kernel with QKN = true replaces _fwd_kernel_qknorm (driven by
// _flash_qknorm_fwd_impl): q and k arrive raw and each staged Q and K tile
// is normalised in shared memory by a per-head LayerNorm over D (ln_rows,
// the operation order of _ln_block) and rounded to bf16 before Q.K^T. Every
// query CTA normalises every K tile it loads, in both passes: redundant
// work (about 2*(Sq/64) normalisations of each K row) but cheap next to the
// two Q.K^T products; normalising K once per head is a later optimisation.
// The LayerNorm reads and writes shared memory only, so the bound is row 1's.
#include "attn_common.cuh"

namespace hv {

constexpr int FB_BQ = 64;   // query rows per CTA (4 warps x 16)
constexpr int FB_BK = 64;   // keys per shared tile
constexpr int FB_THREADS = 128;

template <int D>
__device__ __forceinline__ void fb_scores(float s[FB_BK / 8][4],
                                          const uint32_t qa[D / 16][4],
                                          const bf16* Ks, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int nt = 0; nt < FB_BK / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[2];
      load_b_nk(b, Ks, LD, nt * 8, kk * 16, lane);
      mma16816(s[nt], qa[kk], b);
    }
  }
}

// Per-head LayerNorm over D of the NROWS rows of a shared bf16 tile, in
// place, as hivae_tpu/ops/pallas/flash_attention.py::_ln_block (flax fast
// variance): fp32 mean and mean of squares, var = max(mean2 - mean^2, 0),
// mul = rsqrt(var + eps) * gamma, y = (x - mean) * mul + beta, rounded to
// bf16. Two threads per row, each summing one half of D. The _rn
// intrinsics keep the plain version's separate roundings (no fused
// multiply-add). Rows past the sequence (zero-filled) become beta; their
// logits are masked and their outputs are not stored.
template <int D, int NROWS, int NTHREADS>
__device__ __forceinline__ void ln_rows(bf16* T, int ld, const float* gamma,
                                        const float* beta, float eps,
                                        int tid) {
  static_assert(NTHREADS == 2 * NROWS, "two threads per row");
  constexpr int HALF = D / 2;
  const int r = tid >> 1, c0 = (tid & 1) * HALF;
  bf16* p = T + r * ld + c0;
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float x = __bfloat162float(p[i]);
    s = __fadd_rn(s, x);
    s2 = __fadd_rn(s2, __fmul_rn(x, x));
  }
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
  s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, 1));
  const float mean = __fdiv_rn(s, (float)D), mean2 = __fdiv_rn(s2, (float)D);
  const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
  const float rs = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float x = __bfloat162float(p[i]);
    const float mul = __fmul_rn(rs, gamma[c0 + i]);
    p[i] = __float2bfloat16_rn(
        __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), beta[c0 + i]));
  }
}

template <int D, bool QKN>
__global__ void __launch_bounds__(FB_THREADS)
full_block_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ bias,
                      const float* __restrict__ norms, float eps,
                      bf16* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      int H, int Sq, int Sk, float scale, long qsb, long qsh,
                      long qss, long ksb, long ksh, long kss, long vsb,
                      long vsh, long vss, long osb, long osh, long oss) {
  constexpr int LD = D + 8;  // +16 bytes per row: conflict-free fragments
  constexpr int NT = FB_BK / 8;
  constexpr int KS = D / 16;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + FB_BQ * LD;
  bf16* Vs = Ks + FB_BK * LD;
  // QKN: gamma_q, beta_q, gamma_k, beta_k, D floats each
  float* Ns = reinterpret_cast<float*>(Vs + FB_BK * LD);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FB_BQ;
  const bf16* qp = q + b * qsb + h * qsh;
  const bf16* kp = k + b * ksb + h * ksh;
  const bf16* vp = v + b * vsb + h * vsh;
  const float* brow = bias ? bias + (long)b * Sk : nullptr;

  load_tile<D, FB_BQ, FB_THREADS>(Qs, LD, qp, qss, q0, Sq, tid);
  if (QKN)
    for (int i = tid; i < 4 * D; i += FB_THREADS) Ns[i] = norms[i];
  tile_barrier();
  if (QKN) {
    ln_rows<D, FB_BQ, FB_THREADS>(Qs, LD, Ns, Ns + D, eps, tid);
    __syncthreads();
  }
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_a(qa[kk], Qs, LD, warp * 16, kk * 16, lane);

  const int nkt = (Sk + FB_BK - 1) / FB_BK;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[NT][4];

  // pass 1: row max and softmax denominator over every key
  for (int j = 0; j < nkt; ++j) {
    __syncthreads();
    load_tile<D, FB_BK, FB_THREADS>(Ks, LD, kp, kss, j * FB_BK, Sk, tid);
    tile_barrier();
    if (QKN) {
      ln_rows<D, FB_BK, FB_THREADS>(Ks, LD, Ns + 2 * D, Ns + 3 * D, eps, tid);
      __syncthreads();
    }
    fb_scores<D>(s, qa, Ks, lane);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      logits_epilogue(s[nt], j * FB_BK + nt * 8, lane, Sk, scale, brow);
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sum0 += expf(s[nt][0] - mn0) + expf(s[nt][1] - mn0);
      sum1 += expf(s[nt][2] - mn1) + expf(s[nt][3] - mn1);
    }
    l0 = l0 * expf(m0 - mn0) + quad_sum(sum0);
    l1 = l1 * expf(m1 - mn1) + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
  }

  // pass 2: normalised bf16 probabilities times V, fp32 accumulation
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int j = 0; j < nkt; ++j) {
    __syncthreads();
    load_tile<D, FB_BK, FB_THREADS>(Ks, LD, kp, kss, j * FB_BK, Sk, tid);
    load_tile<D, FB_BK, FB_THREADS>(Vs, LD, vp, vss, j * FB_BK, Sk, tid);
    tile_barrier();
    if (QKN) {
      ln_rows<D, FB_BK, FB_THREADS>(Ks, LD, Ns + 2 * D, Ns + 3 * D, eps, tid);
      __syncthreads();
    }
    fb_scores<D>(s, qa, Ks, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      logits_epilogue(s[nt], j * FB_BK + nt * 8, lane, Sk, scale, brow);
#pragma unroll
    for (int kk = 0; kk < FB_BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(expf(s[2 * kk][0] - m0) / l0, expf(s[2 * kk][1] - m0) / l0);
      pa[1] = pack_bf16(expf(s[2 * kk][2] - m1) / l1, expf(s[2 * kk][3] - m1) / l1);
      pa[2] = pack_bf16(expf(s[2 * kk + 1][0] - m0) / l0, expf(s[2 * kk + 1][1] - m0) / l0);
      pa[3] = pack_bf16(expf(s[2 * kk + 1][2] - m1) / l1, expf(s[2 * kk + 1][3] - m1) / l1);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bv[2];
        load_b_kn(bv, Vs, LD, kk * 16, dt * 8, lane);
        mma16816(acc[dt], pa, bv);
      }
    }
  }

  bf16* op = o + b * osb + h * osh;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(op + (long)r0 * oss + col) =
          __floats2bfloat162_rn(acc[dt][0], acc[dt][1]);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(op + (long)r1 * oss + col) =
          __floats2bfloat162_rn(acc[dt][2], acc[dt][3]);
  }
  // softmax statistics for the backward: every lane of a quad holds them
  if (m_out && t == 0) {
    const long rb = ((long)b * H + h) * Sq;
    if (r0 < Sq) { m_out[rb + r0] = m0; l_out[rb + r0] = l0; }
    if (r1 < Sq) { m_out[rb + r1] = m1; l_out[rb + r1] = l1; }
  }
}

template <int D, bool QKN>
cudaError_t launch_full_block(const void* q, const void* k, const void* v,
                              const float* bias, const float* norms, float eps,
                              void* o, float* m_out, float* l_out, int B,
                              int H, int Sq, int Sk, float scale,
                              const long* st, cudaStream_t stream) {
  const size_t smem = (size_t)(FB_BQ + 2 * FB_BK) * (D + 8) * sizeof(bf16) +
                      (QKN ? 4 * D * sizeof(float) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      full_block_fwd_kernel<D, QKN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + FB_BQ - 1) / FB_BQ, H, B);
  full_block_fwd_kernel<D, QKN><<<grid, FB_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, norms, eps, static_cast<bf16*>(o),
      m_out, l_out, H, Sq, Sk, scale,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace hv

// Plain C entry points. `strides` holds 12 element strides: (batch, head,
// row) for q, k, v and o in that order; the last dimension is contiguous.
// `m_out` and `l_out` are null, or contiguous (B, H, Sq) fp32 buffers that
// receive each row's logit max and softmax denominator for the backward.
// Return a cudaError_t, or -1 for an unsupported head dim.
extern "C" int hv_full_block_fwd(const void* q, const void* k, const void* v,
                                 const float* bias, void* o, float* m_out,
                                 float* l_out, int B, int H, int Sq, int Sk,
                                 int D, float scale, const long* strides,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return hv::launch_full_block<32, false>(q, k, v, bias, nullptr, 0.f, o, m_out, l_out, B, H, Sq, Sk, scale, strides, s);
    case 64: return hv::launch_full_block<64, false>(q, k, v, bias, nullptr, 0.f, o, m_out, l_out, B, H, Sq, Sk, scale, strides, s);
    case 96: return hv::launch_full_block<96, false>(q, k, v, bias, nullptr, 0.f, o, m_out, l_out, B, H, Sq, Sk, scale, strides, s);
    case 128: return hv::launch_full_block<128, false>(q, k, v, bias, nullptr, 0.f, o, m_out, l_out, B, H, Sq, Sk, scale, strides, s);
    default: return -1;
  }
}

// The qk-norm variant: q and k raw; `norms` is a contiguous (4, D) fp32
// array (gamma_q, beta_q, gamma_k, beta_k) and `eps` the LayerNorm epsilon.
extern "C" int hv_full_block_qknorm_fwd(const void* q, const void* k,
                                        const void* v, const float* bias,
                                        const float* norms, void* o,
                                        float* m_out, float* l_out, int B,
                                        int H, int Sq, int Sk, int D,
                                        float scale, float eps,
                                        const long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return hv::launch_full_block<32, true>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, scale, strides, s);
    case 64: return hv::launch_full_block<64, true>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, scale, strides, s);
    case 96: return hv::launch_full_block<96, true>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, scale, strides, s);
    case 128: return hv::launch_full_block<128, true>(q, k, v, bias, norms, eps, o, m_out, l_out, B, H, Sq, Sk, scale, strides, s);
    default: return -1;
  }
}

extern "C" const char* hv_full_block_error_string(int code) {
  return code < 0 ? "unsupported head dim" : cudaGetErrorString(static_cast<cudaError_t>(code));
}
