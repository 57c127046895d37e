// Streaming attention backward for Hopper (sm_90a): two kernels, one for dQ
// and one for dK and dV, bf16 in and out, fp32 accumulation, from the
// forward's per-row LSE and delta = rowsum(dO * O) (FlashAttention-2).
//
// Replaces hivae_tpu/ops/pallas/flash_attention.py::_stream_dq_kernel and
// ::_stream_dkv_kernel (driven by stream_bwd): P = exp(s - lse);
// dP = dO . V^T; dS = P * (dP - delta); dQ = bf16(dS) . K * scale over KV
// tiles; dV = bf16(P)^T . dO and dK = bf16(dS)^T . Q * scale over query
// tiles.
//
// Design. On the training path these kernels run the SD-VAE decoder's
// mid-block attention inside the perceptual loss: (B, H, S, D) =
// (16, 1, 1024, 512). As in the forward (flash_stream.cu), D = 512 is the
// hard part: a 16-row fp32 accumulator over all of D is 256 registers per
// lane, and dK/dV need two of them. So each CTA of 8 warps is 2 row groups
// x 4 D-slices of D/4 = 128 columns. Every score needs Q.K^T and dO.V^T
// over the whole of D: each warp forms the products over its own slice,
// the 4 partial tiles of a row group are summed through shared memory in a
// fixed order (so the four warps hold bit-identical scores, and the sum is
// deterministic), and each warp then multiplies P or dS by its own slice.
//   * dQ CTA: 32 query rows; walks the KV tiles of 32 keys. Per lane: a dQ
//     accumulator of 16 x 128 (64 registers).
//   * dK/dV CTA: 32 keys; walks the query tiles of 32 rows. Per lane: dK and
//     dV accumulators of 16 x 128 each (128 registers).
// A key past Sk gives P = 0 in the dQ kernel and is never stored by the
// dK/dV kernel; a query row past Sq has its LSE set to +inf, so its P is 0.
// A key masked by the -1e30 bias has P = exp(-1e30 - lse) = 0 wherever
// its row attends to any real key, so a fully masked key block adds nothing.
// Shared memory per CTA: Q, dO, K and V tiles (32 x (D + 8) bf16 each) and
// two sets of partial score tiles: 166 KB at D = 512, one CTA per SM.
//
// Bound on the H100 SXM at (16, 1, 1024, 512): dQ does 6*B*H*S^2*D = 51.5
// GFLOP (0.052 ms at 989 TFLOP/s) over 4 bf16 tensors plus LSE and delta
// (0.020 ms at 3.35 TB/s); dK/dV does 8*B*H*S^2*D = 68.7 GFLOP (0.069 ms)
// over 6 tensors (0.030 ms). Both are bound by operations. These simple
// kernels issue mma.sync from registers with one buffer per tile, and loads
// do not overlap compute; wgmma and TMA are later work.
#include "attn_common.cuh"

namespace hv {

constexpr int SB_BQ = 32;        // query rows per tile (2 row groups of 16)
constexpr int SB_BK = 32;        // keys per tile (2 row groups of 16)
constexpr int SB_SLICES = 4;     // D-slices per row group
constexpr int SB_THREADS = 256;  // 8 warps
constexpr int SB_SLD = 32 + 4;   // leading dim of the partial-score tiles

struct SbArgs {
  const bf16 *q, *k, *v, *dout;
  const float *bias, *lse, *delta;
  bf16 *dq, *dk, *dv;
  Rows sq, sk, sv, sdo, sdq, sdk, sdv;
  int H, Sq, Sk;
  float scale;
};

// Sum of the 4 D-slice partials of row group rg for this lane's C-tile
// positions, in slice order: s[nt] becomes the full product.
__device__ __forceinline__ void sum_slices(float s[4][4], const float* part,
                                           int rg, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = nt * 8 + 2 * t;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int w = 0; w < SB_SLICES; ++w) {
      const float* ps = part + (rg * SB_SLICES + w) * 16 * SB_SLD;
      a0 += ps[g * SB_SLD + c];
      a1 += ps[g * SB_SLD + c + 1];
      a2 += ps[(g + 8) * SB_SLD + c];
      a3 += ps[(g + 8) * SB_SLD + c + 1];
    }
    s[nt][0] = a0;
    s[nt][1] = a1;
    s[nt][2] = a2;
    s[nt][3] = a3;
  }
}

__device__ __forceinline__ void store_partial(float* my, const float s[4][4],
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = nt * 8 + 2 * t;
    my[g * SB_SLD + c] = s[nt][0];
    my[g * SB_SLD + c + 1] = s[nt][1];
    my[(g + 8) * SB_SLD + c] = s[nt][2];
    my[(g + 8) * SB_SLD + c + 1] = s[nt][3];
  }
}

// Partial products over this warp's D-slice: s = A1 . B1^T and
// dp = A2 . B2^T for the 16 rows r0.. of A (row-major tiles A1, A2) and the
// 32 rows of B (row-major tiles B1, B2).
template <int D>
__device__ __forceinline__ void slice_products(float s[4][4], float dp[4][4],
                                               const bf16* A1, const bf16* A2,
                                               const bf16* B1, const bf16* B2,
                                               int r0, int c0, int lane) {
  constexpr int LD = D + 8;
  constexpr int KS = D / SB_SLICES / 16;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] =
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a1[4], a2[4];
    load_a(a1, A1, LD, r0, c0 + kk * 16, lane);
    load_a(a2, A2, LD, r0, c0 + kk * 16, lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t b1[2], b2[2];
      load_b_nk(b1, B1, LD, nt * 8, c0 + kk * 16, lane);
      mma16816(s[nt], a1, b1);
      load_b_nk(b2, B2, LD, nt * 8, c0 + kk * 16, lane);
      mma16816(dp[nt], a2, b2);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(SB_THREADS)
stream_bwd_dq_kernel(const SbArgs a) {
  constexpr int LD = D + 8;
  constexpr int DS = D / SB_SLICES;
  constexpr int DT = DS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + SB_BQ * LD;
  bf16* Ks = Os + SB_BQ * LD;
  bf16* Vs = Ks + SB_BK * LD;
  float* Sp = reinterpret_cast<float*>(Vs + SB_BK * LD);  // [8][16][SLD]
  float* Dp = Sp + (SB_THREADS / 32) * 16 * SB_SLD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / SB_SLICES, sl = warp % SB_SLICES;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * SB_BQ;
  const bf16* kp = head_ptr(a.k, a.sk, b, h);
  const bf16* vp = head_ptr(a.v, a.sv, b, h);
  const float* brow = a.bias ? a.bias + (long)b * a.Sk : nullptr;

  load_tile<D, SB_BQ, SB_THREADS>(Qs, LD, head_ptr(a.q, a.sq, b, h), a.sq.s,
                                  q0, a.Sq, tid);
  load_tile<D, SB_BQ, SB_THREADS>(Os, LD, head_ptr(a.dout, a.sdo, b, h),
                                  a.sdo.s, q0, a.Sq, tid);
  const int r0 = q0 + rg * 16 + g, r1 = r0 + 8;
  const long rb = ((long)b * a.H + h) * a.Sq;
  const float lse0 = r0 < a.Sq ? a.lse[rb + r0] : INFINITY;
  const float lse1 = r1 < a.Sq ? a.lse[rb + r1] : INFINITY;
  const float d0 = r0 < a.Sq ? a.delta[rb + r0] : 0.f;
  const float d1 = r1 < a.Sq ? a.delta[rb + r1] : 0.f;

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float* my_sp = Sp + warp * 16 * SB_SLD;
  float* my_dp = Dp + warp * 16 * SB_SLD;

  const int nkt = (a.Sk + SB_BK - 1) / SB_BK;
  for (int j = 0; j < nkt; ++j) {
    __syncthreads();  // the previous tile's K, V and partials are consumed
    load_tile<D, SB_BK, SB_THREADS>(Ks, LD, kp, a.sk.s, j * SB_BK, a.Sk, tid);
    load_tile<D, SB_BK, SB_THREADS>(Vs, LD, vp, a.sv.s, j * SB_BK, a.Sk, tid);
    tile_barrier();

    float s[4][4], dp[4][4];
    slice_products<D>(s, dp, Qs, Os, Ks, Vs, rg * 16, sl * DS, lane);
    store_partial(my_sp, s, lane);
    store_partial(my_dp, dp, lane);
    __syncthreads();
    sum_slices(s, Sp, rg, lane);
    sum_slices(dp, Dp, rg, lane);

#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      logits_epilogue(s[nt], j * SB_BK + nt * 8, lane, a.Sk, a.scale, brow);
      s[nt][0] = expf(s[nt][0] - lse0) * (dp[nt][0] - d0);
      s[nt][1] = expf(s[nt][1] - lse0) * (dp[nt][1] - d0);
      s[nt][2] = expf(s[nt][2] - lse1) * (dp[nt][2] - d1);
      s[nt][3] = expf(s[nt][3] - lse1) * (dp[nt][3] - d1);
    }
#pragma unroll
    for (int kk = 0; kk < SB_BK / 16; ++kk) {
      uint32_t dsa[4];
      c_to_a(dsa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bk[2];
        load_b_kn(bk, Ks, LD, kk * 16, sl * DS + dt * 8, lane);
        mma16816(acc[dt], dsa, bk);
      }
    }
  }

  bf16* dqp = head_ptr(a.dq, a.sdq, b, h);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = sl * DS + dt * 8 + 2 * t;
    if (r0 < a.Sq) store_bf16x2(dqp + (long)r0 * a.sdq.s + col, acc[dt][0], acc[dt][1], a.scale);
    if (r1 < a.Sq) store_bf16x2(dqp + (long)r1 * a.sdq.s + col, acc[dt][2], acc[dt][3], a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(SB_THREADS)
stream_bwd_dkv_kernel(const SbArgs a) {
  constexpr int LD = D + 8;
  constexpr int DS = D / SB_SLICES;
  constexpr int DT = DS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + SB_BK * LD;
  bf16* Qs = Vs + SB_BK * LD;
  bf16* Os = Qs + SB_BQ * LD;
  float* Sp = reinterpret_cast<float*>(Os + SB_BQ * LD);
  float* Dp = Sp + (SB_THREADS / 32) * 16 * SB_SLD;
  float* st_lse = Dp + (SB_THREADS / 32) * 16 * SB_SLD;
  float* st_d = st_lse + SB_BQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / SB_SLICES, sl = warp % SB_SLICES;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * SB_BK;
  const bf16* qp = head_ptr(a.q, a.sq, b, h);
  const bf16* op = head_ptr(a.dout, a.sdo, b, h);
  const long rb = ((long)b * a.H + h) * a.Sq;

  load_tile<D, SB_BK, SB_THREADS>(Ks, LD, head_ptr(a.k, a.sk, b, h), a.sk.s,
                                  k0, a.Sk, tid);
  load_tile<D, SB_BK, SB_THREADS>(Vs, LD, head_ptr(a.v, a.sv, b, h), a.sv.s,
                                  k0, a.Sk, tid);
  const int kr0 = k0 + rg * 16 + g, kr1 = kr0 + 8;
  const bool kv0 = kr0 < a.Sk, kv1 = kr1 < a.Sk;
  const float bk0 = kv0 && a.bias ? a.bias[(long)b * a.Sk + kr0] : 0.f;
  const float bk1 = kv1 && a.bias ? a.bias[(long)b * a.Sk + kr1] : 0.f;

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }
  float* my_sp = Sp + warp * 16 * SB_SLD;
  float* my_dp = Dp + warp * 16 * SB_SLD;

  const int nqt = (a.Sq + SB_BQ - 1) / SB_BQ;
  for (int i = 0; i < nqt; ++i) {
    __syncthreads();  // the previous Q/dO tile, partials and stats are consumed
    load_tile<D, SB_BQ, SB_THREADS>(Qs, LD, qp, a.sq.s, i * SB_BQ, a.Sq, tid);
    load_tile<D, SB_BQ, SB_THREADS>(Os, LD, op, a.sdo.s, i * SB_BQ, a.Sq, tid);
    if (tid < SB_BQ) {
      const int r = i * SB_BQ + tid;
      st_lse[tid] = r < a.Sq ? a.lse[rb + r] : INFINITY;
      st_d[tid] = r < a.Sq ? a.delta[rb + r] : 0.f;
    }
    tile_barrier();

    // transposed tiles: rows are this row group's keys, columns queries
    float s[4][4], dp[4][4];
    slice_products<D>(s, dp, Ks, Vs, Qs, Os, rg * 16, sl * DS, lane);
    store_partial(my_sp, s, lane);
    store_partial(my_dp, dp, lane);
    __syncthreads();
    sum_slices(s, Sp, rg, lane);
    sum_slices(dp, Dp, rg, lane);

#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = nt * 8 + 2 * t + e;
        const float lq = st_lse[qc], dlt = st_d[qc];
        const float p0 = kv0 ? expf(s[nt][e] * a.scale + bk0 - lq) : 0.f;
        const float p1 = kv1 ? expf(s[nt][2 + e] * a.scale + bk1 - lq) : 0.f;
        s[nt][e] = p0;
        s[nt][2 + e] = p1;
        dp[nt][e] = p0 * (dp[nt][e] - dlt);
        dp[nt][2 + e] = p1 * (dp[nt][2 + e] - dlt);
      }
    }
#pragma unroll
    for (int kk = 0; kk < SB_BQ / 16; ++kk) {
      uint32_t pa[4], dsa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      c_to_a(dsa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bo[2], bq[2];
        load_b_kn(bo, Os, LD, kk * 16, sl * DS + dt * 8, lane);
        mma16816(dva[dt], pa, bo);
        load_b_kn(bq, Qs, LD, kk * 16, sl * DS + dt * 8, lane);
        mma16816(dka[dt], dsa, bq);
      }
    }
  }

  bf16* dkp = head_ptr(a.dk, a.sdk, b, h);
  bf16* dvp = head_ptr(a.dv, a.sdv, b, h);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = sl * DS + dt * 8 + 2 * t;
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

constexpr size_t sb_smem(int D) {
  return (size_t)(2 * SB_BQ + 2 * SB_BK) * (D + 8) * sizeof(bf16) +
         2 * (size_t)(SB_THREADS / 32) * 16 * SB_SLD * sizeof(float) +
         2 * SB_BQ * sizeof(float);
}

template <int D>
cudaError_t launch_stream_bwd(const SbArgs& a, int B, bool dkv,
                              cudaStream_t stream) {
  const size_t smem = sb_smem(D);
  if (!dkv) {
    cudaError_t err = cudaFuncSetAttribute(
        stream_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + SB_BQ - 1) / SB_BQ, a.H, B);
    stream_bwd_dq_kernel<D><<<grid, SB_THREADS, smem, stream>>>(a);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        stream_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sk + SB_BK - 1) / SB_BK, a.H, B);
    stream_bwd_dkv_kernel<D><<<grid, SB_THREADS, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

int stream_bwd(const void* q, const void* k, const void* v, const float* bias,
               const void* dout, const float* lse, const float* delta,
               void* dq, void* dk, void* dv, int B, int H, int Sq, int Sk,
               int D, float scale, const long* st, bool dkv, void* stream) {
  SbArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.bias = bias;
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  Rows* rows[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *rows[i] = Rows{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_stream_bwd<64>(a, B, dkv, s);
    case 128: return launch_stream_bwd<128>(a, B, dkv, s);
    case 256: return launch_stream_bwd<256>(a, B, dkv, s);
    case 512: return launch_stream_bwd<512>(a, B, dkv, s);
    default: return -1;
  }
}

}  // namespace hv

// Plain C entry points. `strides` holds 21 element strides: (batch, head,
// row) for q, k, v, dout, dq, dk and dv in that order (the dQ kernel reads
// the dq triple only, the dK/dV kernel the dk and dv triples); the last
// dimension of each is contiguous. `lse` and `delta` are contiguous
// (B, H, Sq) fp32. Each returns a cudaError_t, or -1 for an unsupported
// head dim.
extern "C" int hv_stream_bwd_dq(const void* q, const void* k, const void* v,
                                const float* bias, const void* dout,
                                const float* lse, const float* delta,
                                void* dq, int B, int H, int Sq, int Sk, int D,
                                float scale, const long* strides,
                                void* stream) {
  return hv::stream_bwd(q, k, v, bias, dout, lse, delta, dq, nullptr,
                        nullptr, B, H, Sq, Sk, D, scale, strides, false,
                        stream);
}

extern "C" int hv_stream_bwd_dkv(const void* q, const void* k, const void* v,
                                 const float* bias, const void* dout,
                                 const float* lse, const float* delta,
                                 void* dk, void* dv, int B, int H, int Sq,
                                 int Sk, int D, float scale,
                                 const long* strides, void* stream) {
  return hv::stream_bwd(q, k, v, bias, dout, lse, delta, nullptr, dk, dv, B,
                        H, Sq, Sk, D, scale, strides, true, stream);
}

extern "C" const char* hv_stream_bwd_error_string(int code) {
  return code < 0 ? "unsupported head dim" : cudaGetErrorString(static_cast<cudaError_t>(code));
}
