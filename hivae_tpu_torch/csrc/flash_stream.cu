// Streaming (online-softmax) attention forward with LSE for Hopper
// (sm_90a), bf16 in, bf16 out, fp32 log-sum-exp.
//
// Replaces hivae_tpu/ops/pallas/flash_attention.py::_stream_fwd_kernel
// (driven by _stream_fwd_impl / stream_fwd_lse): a loop over KV tiles with a
// running row max m, denominator l and output accumulator; the
// unnormalised p = exp(s - m) is rounded to bf16 for P.V, l sums the fp32 p,
// and the epilogue writes O = acc / l and LSE = m + log(l).
//
// Design. On the serving path this kernel runs the SD-VAE mid-block
// attention: (B, H, S, D) = (17, 1, 1024, 512). At D = 512 one 16-row fp32
// accumulator is 256 registers per lane, too many for one warp, so the
// accumulator is split over D: a CTA of 8 warps takes 32 query rows as 2
// row groups x 4 D-slices of D/4 columns. Each warp multiplies its 16 rows
// by a KV tile of 32 keys over its own D-slice only, the 4 partial score
// tiles of a row group are summed through shared memory, every warp of the
// group then runs the identical online-softmax update on the full scores,
// and multiplies P by its own D-slice of V. Per KV step shared memory holds
// Q (32 x D), K and V tiles (32 x D) and the partial scores: 116 KB at
// D = 512, so one CTA per SM.
//
// Bound on the H100 SXM at (17, 1, 1024, 512): 4*B*H*S*S*D = 36.5 GFLOP of
// matmul, 36.9 us at 989 TFLOP/s, against 71.4 MB of q, k, v, o and LSE,
// 21.3 us at 3.35 TB/s, so the bound is operations. This simple kernel
// issues mma.sync from registers; each K/V tile arrives by cp.async in one
// batch, but loads do not overlap compute (one buffer). Double buffering,
// wgmma and TMA are later work.
#include "attn_common.cuh"

namespace hv {

constexpr int ST_BQ = 32;        // query rows per CTA (2 row groups of 16)
constexpr int ST_BK = 32;        // keys per KV tile
constexpr int ST_SLICES = 4;     // D-slices per row group
constexpr int ST_THREADS = 256;  // 8 warps
constexpr int ST_SLD = ST_BK + 4;  // leading dim of the partial-score tiles

template <int D>
__global__ void __launch_bounds__(ST_THREADS)
stream_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ bias,
                  bf16* __restrict__ o, float* __restrict__ lse, int H,
                  int Sq, int Sk, float scale, long qsb, long qsh, long qss,
                  long ksb, long ksh, long kss, long vsb, long vsh, long vss,
                  long osb, long osh, long oss) {
  constexpr int LD = D + 8;
  constexpr int DS = D / ST_SLICES;  // columns of D per warp
  constexpr int KS = DS / 16;        // k steps of Q.K^T per warp
  constexpr int DT = DS / 8;         // output column tiles per warp
  constexpr int NT = ST_BK / 8;      // score column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + ST_BQ * LD;
  bf16* Vs = Ks + ST_BK * LD;
  float* Sp = reinterpret_cast<float*>(Vs + ST_BK * LD);  // [8 warps][16][SLD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / ST_SLICES, sl = warp % ST_SLICES;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ST_BQ;
  const bf16* qp = q + b * qsb + h * qsh;
  const bf16* kp = k + b * ksb + h * ksh;
  const bf16* vp = v + b * vsb + h * vsh;
  const float* brow = bias ? bias + (long)b * Sk : nullptr;

  load_tile<D, ST_BQ, ST_THREADS>(Qs, LD, qp, qss, q0, Sq, tid);
  tile_barrier();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    load_a(qa[kk], Qs, LD, rg * 16, sl * DS + kk * 16, lane);

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float* my_sp = Sp + warp * 16 * ST_SLD;

  const int nkt = (Sk + ST_BK - 1) / ST_BK;
  for (int j = 0; j < nkt; ++j) {
    __syncthreads();  // previous tile's K, V and partial scores are consumed
    load_tile<D, ST_BK, ST_THREADS>(Ks, LD, kp, kss, j * ST_BK, Sk, tid);
    load_tile<D, ST_BK, ST_THREADS>(Vs, LD, vp, vss, j * ST_BK, Sk, tid);
    tile_barrier();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bk[2];
        load_b_nk(bk, Ks, LD, nt * 8, sl * DS + kk * 16, lane);
        mma16816(s[nt], qa[kk], bk);
      }
      const int c = nt * 8 + 2 * t;
      my_sp[g * ST_SLD + c] = s[nt][0];
      my_sp[g * ST_SLD + c + 1] = s[nt][1];
      my_sp[(g + 8) * ST_SLD + c] = s[nt][2];
      my_sp[(g + 8) * ST_SLD + c + 1] = s[nt][3];
    }
    __syncthreads();

    // full scores of this row group: the D-slice partials summed in a fixed
    // order, so all four warps of the group hold bit-identical values
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * t;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int w = 0; w < ST_SLICES; ++w) {
        const float* ps = Sp + (rg * ST_SLICES + w) * 16 * ST_SLD;
        a0 += ps[g * ST_SLD + c];
        a1 += ps[g * ST_SLD + c + 1];
        a2 += ps[(g + 8) * ST_SLD + c];
        a3 += ps[(g + 8) * ST_SLD + c + 1];
      }
      s[nt][0] = a0;
      s[nt][1] = a1;
      s[nt][2] = a2;
      s[nt][3] = a3;
      logits_epilogue(s[nt], j * ST_BK + nt * 8, lane, Sk, scale, brow);
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * corr0 + quad_sum(sum0);
    l1 = l1 * corr1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= corr0;
      acc[dt][1] *= corr0;
      acc[dt][2] *= corr1;
      acc[dt][3] *= corr1;
    }
#pragma unroll
    for (int kk = 0; kk < ST_BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bv[2];
        load_b_kn(bv, Vs, LD, kk * 16, sl * DS + dt * 8, lane);
        mma16816(acc[dt], pa, bv);
      }
    }
  }

  bf16* op = o + b * osb + h * osh;
  const int r0 = q0 + rg * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = sl * DS + dt * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(op + (long)r0 * oss + col) =
          __floats2bfloat162_rn(acc[dt][0] / l0, acc[dt][1] / l0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(op + (long)r1 * oss + col) =
          __floats2bfloat162_rn(acc[dt][2] / l1, acc[dt][3] / l1);
  }
  if (sl == 0 && t == 0) {
    float* lp = lse + ((long)b * H + h) * Sq;
    if (r0 < Sq) lp[r0] = m0 + logf(l0);
    if (r1 < Sq) lp[r1] = m1 + logf(l1);
  }
}

template <int D>
cudaError_t launch_stream(const void* q, const void* k, const void* v,
                          const float* bias, void* o, float* lse, int B,
                          int H, int Sq, int Sk, float scale, const long* st,
                          cudaStream_t stream) {
  const size_t smem = (size_t)(ST_BQ + 2 * ST_BK) * (D + 8) * sizeof(bf16) +
                      (size_t)(ST_THREADS / 32) * 16 * ST_SLD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stream_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + ST_BQ - 1) / ST_BQ, H, B);
  stream_fwd_kernel<D><<<grid, ST_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, static_cast<bf16*>(o), lse, H, Sq,
      Sk, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace hv

// Plain C entry point. `strides` holds 12 element strides: (batch, head,
// row) for q, k, v and o in that order; the last dimension is contiguous.
// `lse` is a contiguous (B, H, Sq) fp32 buffer. Returns a cudaError_t, or
// -1 for an unsupported head dim.
extern "C" int hv_stream_fwd(const void* q, const void* k, const void* v,
                             const float* bias, void* o, float* lse, int B,
                             int H, int Sq, int Sk, int D, float scale,
                             const long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return hv::launch_stream<64>(q, k, v, bias, o, lse, B, H, Sq, Sk, scale, strides, s);
    case 128: return hv::launch_stream<128>(q, k, v, bias, o, lse, B, H, Sq, Sk, scale, strides, s);
    case 256: return hv::launch_stream<256>(q, k, v, bias, o, lse, B, H, Sq, Sk, scale, strides, s);
    case 512: return hv::launch_stream<512>(q, k, v, bias, o, lse, B, H, Sq, Sk, scale, strides, s);
    default: return -1;
  }
}

extern "C" const char* hv_stream_error_string(int code) {
  return code < 0 ? "unsupported head dim" : cudaGetErrorString(static_cast<cudaError_t>(code));
}
