// Full-block attention backward for Hopper (sm_90a): dQ, dK and dV of
// softmax(Q.K^T * scale + key_bias) . V, bf16 in and out, fp32 accumulation.
//
// Replaces hivae_tpu/ops/pallas/flash_attention.py::_bwd_kernel (driven by
// _flash_bwd): recomputed P; dV = bf16(P)^T . dO; dP = dO . V^T;
// dS = P * (dP - delta) rounded to bf16; dQ = dS . K * scale;
// dK = dS^T . Q * scale.
//
// Two departures from the TPU kernel, both within rounding:
//   * P is not recomputed from scratch over the whole row. The forward
//     (flash_full_block.cu) saves each row's logit max m and denominator l,
//     and this kernel forms P = exp(s - m) / l with the forward's own
//     expression. m and l are kept apart rather than folded into one LSE:
//     under the -1e30 key mask a fully masked row has m = -1e30, and
//     m + log(l) rounds back to -1e30 in fp32, which would lose the 1/l.
//   * delta = rowsum(dO * O) (FlashAttention-2), computed by the caller from
//     the bf16 forward output, in place of the TPU kernel's rowsum(dP * P)
//     over fp32 P. The two are equal in exact arithmetic; they differ by
//     the bf16 rounding of O.
// The bf16 roundings of P (for dV) and of dS (for dQ and dK) are kept.
//
// Design. dK and dV need a sum over query rows, dQ a sum over keys. One
// launch does both without atomics, so the result is deterministic: the
// grid's x axis holds ceil(Sq/64) dQ CTAs followed by ceil(Sk/64) dK/dV
// CTAs. A dQ CTA (4 warps, 16 query rows each) keeps its Q and dO rows and
// walks every key tile; a dK/dV CTA (4 warps, 16 keys each) keeps its K and
// V rows and walks every query tile. Both recompute Q.K^T and dO.V^T, so
// the launch does 4 + 4 + 2 + 2 = 12 (not 10) B*H*Sq*Sk*D matmul flops
// through mma.sync m16n8k16; the score tiles are worked in 16-column chunks
// so that P and dS go from the accumulator straight into the next product's
// A fragment without a trip through shared memory. No S x S buffer exists.
//
// Bound on the H100 SXM: 10*B*H*Sq*Sk*D operations over the 7 bf16 tensors
// (q, k, v, dO, dq, dk, dv) plus the fp32 row statistics. At the training
// shapes, D = 64: (64, 16, 512, 64) is 0.174 ms of tensor time against
// 0.140 ms of memory (operations bound); (64, 16, 266, 64) and
// (128, 8, 260, 64) are bound by bytes (~0.07 ms). Loads do not overlap
// compute (one buffer); wgmma/TMA pipelining is later work.
#include "attn_common.cuh"

namespace hv {

constexpr int FBB_BQ = 64;  // query rows per dQ CTA, per query tile
constexpr int FBB_BK = 64;  // keys per dK/dV CTA, per key tile
constexpr int FBB_THREADS = 128;

struct FbbArgs {
  const bf16 *q, *k, *v, *dout;
  const float *bias, *m, *l, *delta;
  bf16 *dq, *dk, *dv;
  Rows sq, sk, sv, sdo, sdq, sdk, sdv;
  int H, Sq, Sk, nqt;
  float scale;
};

template <int D>
__device__ void fbb_dq(const FbbArgs& a, unsigned char* smem, int qt) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int DT = D / 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + FBB_BQ * LD;
  bf16* Ks = Os + FBB_BQ * LD;
  bf16* Vs = Ks + FBB_BK * LD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = qt * FBB_BQ;
  const bf16* kp = head_ptr(a.k, a.sk, b, h);
  const bf16* vp = head_ptr(a.v, a.sv, b, h);
  const float* brow = a.bias ? a.bias + (long)b * a.Sk : nullptr;

  load_tile<D, FBB_BQ, FBB_THREADS>(Qs, LD, head_ptr(a.q, a.sq, b, h), a.sq.s,
                                    q0, a.Sq, tid);
  load_tile<D, FBB_BQ, FBB_THREADS>(Os, LD, head_ptr(a.dout, a.sdo, b, h),
                                    a.sdo.s, q0, a.Sq, tid);
  tile_barrier();
  uint32_t qa[KS][4], da[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    load_a(qa[kk], Qs, LD, warp * 16, kk * 16, lane);
    load_a(da[kk], Os, LD, warp * 16, kk * 16, lane);
  }
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const long rb = ((long)b * a.H + h) * a.Sq;
  // rows past Sq are never stored; give them harmless statistics
  const float m0 = r0 < a.Sq ? a.m[rb + r0] : 0.f;
  const float m1 = r1 < a.Sq ? a.m[rb + r1] : 0.f;
  const float l0 = r0 < a.Sq ? a.l[rb + r0] : 1.f;
  const float l1 = r1 < a.Sq ? a.l[rb + r1] : 1.f;
  const float d0 = r0 < a.Sq ? a.delta[rb + r0] : 0.f;
  const float d1 = r1 < a.Sq ? a.delta[rb + r1] : 0.f;

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int nkt = (a.Sk + FBB_BK - 1) / FBB_BK;
  for (int j = 0; j < nkt; ++j) {
    __syncthreads();  // the previous K/V tile is consumed
    load_tile<D, FBB_BK, FBB_THREADS>(Ks, LD, kp, a.sk.s, j * FBB_BK, a.Sk, tid);
    load_tile<D, FBB_BK, FBB_THREADS>(Vs, LD, vp, a.sv.s, j * FBB_BK, a.Sk, tid);
    tile_barrier();
#pragma unroll
    for (int c = 0; c < FBB_BK / 16; ++c) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        s[n2][0] = s[n2][1] = s[n2][2] = s[n2][3] = 0.f;
        dp[n2][0] = dp[n2][1] = dp[n2][2] = dp[n2][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t bk[2], bv[2];
          load_b_nk(bk, Ks, LD, c * 16 + n2 * 8, kk * 16, lane);
          mma16816(s[n2], qa[kk], bk);
          load_b_nk(bv, Vs, LD, c * 16 + n2 * 8, kk * 16, lane);
          mma16816(dp[n2], da[kk], bv);
        }
        logits_epilogue(s[n2], j * FBB_BK + c * 16 + n2 * 8, lane, a.Sk,
                        a.scale, brow);
        // dS = P * (dP - delta), P = exp(s - m) / l as in the forward
        s[n2][0] = expf(s[n2][0] - m0) / l0 * (dp[n2][0] - d0);
        s[n2][1] = expf(s[n2][1] - m0) / l0 * (dp[n2][1] - d0);
        s[n2][2] = expf(s[n2][2] - m1) / l1 * (dp[n2][2] - d1);
        s[n2][3] = expf(s[n2][3] - m1) / l1 * (dp[n2][3] - d1);
      }
      uint32_t dsa[4];
      c_to_a(dsa, s[0], s[1]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bk[2];
        load_b_kn(bk, Ks, LD, c * 16, dt * 8, lane);
        mma16816(acc[dt], dsa, bk);
      }
    }
  }

  bf16* dqp = head_ptr(a.dq, a.sdq, b, h);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (r0 < a.Sq) store_bf16x2(dqp + (long)r0 * a.sdq.s + col, acc[dt][0], acc[dt][1], a.scale);
    if (r1 < a.Sq) store_bf16x2(dqp + (long)r1 * a.sdq.s + col, acc[dt][2], acc[dt][3], a.scale);
  }
}

template <int D>
__device__ void fbb_dkv(const FbbArgs& a, unsigned char* smem, int kt) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int DT = D / 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + FBB_BK * LD;
  bf16* Qs = Vs + FBB_BK * LD;
  bf16* Os = Qs + FBB_BQ * LD;
  float* st_m = reinterpret_cast<float*>(Os + FBB_BQ * LD);
  float* st_l = st_m + FBB_BQ;
  float* st_d = st_l + FBB_BQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, k0 = kt * FBB_BK;
  const bf16* qp = head_ptr(a.q, a.sq, b, h);
  const bf16* op = head_ptr(a.dout, a.sdo, b, h);
  const long rb = ((long)b * a.H + h) * a.Sq;

  load_tile<D, FBB_BK, FBB_THREADS>(Ks, LD, head_ptr(a.k, a.sk, b, h), a.sk.s,
                                    k0, a.Sk, tid);
  load_tile<D, FBB_BK, FBB_THREADS>(Vs, LD, head_ptr(a.v, a.sv, b, h), a.sv.s,
                                    k0, a.Sk, tid);
  tile_barrier();
  uint32_t ka[KS][4], va[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    load_a(ka[kk], Ks, LD, warp * 16, kk * 16, lane);
    load_a(va[kk], Vs, LD, warp * 16, kk * 16, lane);
  }
  // this thread's two key rows: their bias, and whether they exist
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;
  const bool kv0 = kr0 < a.Sk, kv1 = kr1 < a.Sk;
  const float bk0 = kv0 && a.bias ? a.bias[(long)b * a.Sk + kr0] : 0.f;
  const float bk1 = kv1 && a.bias ? a.bias[(long)b * a.Sk + kr1] : 0.f;

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }

  for (int i = 0; i < a.nqt; ++i) {
    __syncthreads();  // the previous Q/dO tile and its statistics are consumed
    load_tile<D, FBB_BQ, FBB_THREADS>(Qs, LD, qp, a.sq.s, i * FBB_BQ, a.Sq, tid);
    load_tile<D, FBB_BQ, FBB_THREADS>(Os, LD, op, a.sdo.s, i * FBB_BQ, a.Sq, tid);
    if (tid < FBB_BQ) {
      const int r = i * FBB_BQ + tid;
      // a query row past Sq gets m = +inf: its P is 0 and it adds nothing
      st_m[tid] = r < a.Sq ? a.m[rb + r] : INFINITY;
      st_l[tid] = r < a.Sq ? a.l[rb + r] : 1.f;
      st_d[tid] = r < a.Sq ? a.delta[rb + r] : 0.f;
    }
    tile_barrier();
#pragma unroll
    for (int c = 0; c < FBB_BQ / 16; ++c) {
      // transposed score tiles: rows are this warp's keys, columns queries
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        s[n2][0] = s[n2][1] = s[n2][2] = s[n2][3] = 0.f;
        dp[n2][0] = dp[n2][1] = dp[n2][2] = dp[n2][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t bq[2], bo[2];
          load_b_nk(bq, Qs, LD, c * 16 + n2 * 8, kk * 16, lane);
          mma16816(s[n2], ka[kk], bq);
          load_b_nk(bo, Os, LD, c * 16 + n2 * 8, kk * 16, lane);
          mma16816(dp[n2], va[kk], bo);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = c * 16 + n2 * 8 + 2 * t + e;
          const float mq = st_m[qc], lq = st_l[qc], dlt = st_d[qc];
          const float p0 = kv0 ? expf(s[n2][e] * a.scale + bk0 - mq) / lq : 0.f;
          const float p1 = kv1 ? expf(s[n2][2 + e] * a.scale + bk1 - mq) / lq : 0.f;
          s[n2][e] = p0;
          s[n2][2 + e] = p1;
          dp[n2][e] = p0 * (dp[n2][e] - dlt);
          dp[n2][2 + e] = p1 * (dp[n2][2 + e] - dlt);
        }
      }
      uint32_t pa[4], dsa[4];
      c_to_a(pa, s[0], s[1]);
      c_to_a(dsa, dp[0], dp[1]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bo[2], bq[2];
        load_b_kn(bo, Os, LD, c * 16, dt * 8, lane);
        mma16816(dva[dt], pa, bo);
        load_b_kn(bq, Qs, LD, c * 16, dt * 8, lane);
        mma16816(dka[dt], dsa, bq);
      }
    }
  }

  bf16* dkp = head_ptr(a.dk, a.sdk, b, h);
  bf16* dvp = head_ptr(a.dv, a.sdv, b, h);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (kv0) {
      store_bf16x2(dkp + (long)kr0 * a.sdk.s + col, dka[dt][0], dka[dt][1], a.scale);
      store_bf16x2(dvp + (long)kr0 * a.sdv.s + col, dva[dt][0], dva[dt][1], 1.f);
    }
    if (kv1) {
      store_bf16x2(dkp + (long)kr1 * a.sdk.s + col, dka[dt][2], dka[dt][3], a.scale);
      store_bf16x2(dvp + (long)kr1 * a.sdv.s + col, dva[dt][2], dva[dt][3], 1.f);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FBB_THREADS)
full_block_bwd_kernel(const FbbArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if ((int)blockIdx.x < a.nqt)
    fbb_dq<D>(a, smem_raw, blockIdx.x);
  else
    fbb_dkv<D>(a, smem_raw, blockIdx.x - a.nqt);
}

template <int D>
cudaError_t launch_full_block_bwd(const FbbArgs& a, int B, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * FBB_BQ + 2 * FBB_BK) * (D + 8) * sizeof(bf16) +
                      3 * FBB_BQ * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      full_block_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int nkt = (a.Sk + FBB_BK - 1) / FBB_BK;
  const dim3 grid(a.nqt + nkt, a.H, B);
  full_block_bwd_kernel<D><<<grid, FBB_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace hv

// Plain C entry point. `strides` holds 21 element strides: (batch, head,
// row) for q, k, v, dout, dq, dk and dv in that order; the last dimension
// of each is contiguous. `m`, `l` (from hv_full_block_fwd) and `delta`
// (rowsum(dout * out)) are contiguous (B, H, Sq) fp32. Returns a
// cudaError_t, or -1 for an unsupported head dim.
extern "C" int hv_full_block_bwd(const void* q, const void* k, const void* v,
                                 const float* bias, const void* dout,
                                 const float* m, const float* l,
                                 const float* delta, void* dq, void* dk,
                                 void* dv, int B, int H, int Sq, int Sk, int D,
                                 float scale, const long* st, void* stream) {
  using hv::bf16;
  hv::FbbArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.bias = bias;
  a.m = m;
  a.l = l;
  a.delta = delta;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  hv::Rows* rows[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *rows[i] = hv::Rows{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.nqt = (Sq + hv::FBB_BQ - 1) / hv::FBB_BQ;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return hv::launch_full_block_bwd<32>(a, B, s);
    case 64: return hv::launch_full_block_bwd<64>(a, B, s);
    case 96: return hv::launch_full_block_bwd<96>(a, B, s);
    case 128: return hv::launch_full_block_bwd<128>(a, B, s);
    default: return -1;
  }
}

extern "C" const char* hv_full_block_bwd_error_string(int code) {
  return code < 0 ? "unsupported head dim" : cudaGetErrorString(static_cast<cudaError_t>(code));
}
