// Full-block attention backward for Hopper (sm_90a): dQ, dK and dV of
// softmax(Q.K^T * scale + key_bias) . V, bf16 (or fp16, built with
// -DHV_F16: attn_common.cuh) in and out, fp32 accumulation.
//
// Replaces hivae_tpu/ops/pallas/flash_attention.py::_bwd_kernel (driven by
// _flash_bwd): recomputed P; dV = bf16(P)^T . dO; dP = dO . V^T;
// dS = P * (dP - delta) rounded to bf16; dQ = dS . K * scale;
// dK = dS^T . Q * scale.
//
// Two departures from the TPU kernel, both within rounding:
//   * P is not recomputed from scratch over the whole row. The forward
//     (flash_full_block.cu) saves each row's base-2 logit max m and
//     denominator l, and both sides here form P with the forward's own
//     function (attn_p in attn_common.cuh), so P is the forward's P bit for
//     bit. m and l are kept apart rather than folded into one LSE: under
//     the -1e30 key mask a fully masked row has m = -1.44e30, and
//     m + log2(l) rounds back to m in fp32, which would lose the 1/l.
//   * delta = rowsum(dO * O) (FlashAttention-2), from the bf16 forward
//     output, in place of the TPU kernel's rowsum(dP * P) over fp32 P. The
//     two are equal in exact arithmetic; they differ by the bf16 rounding of
//     O. A pre-pass kernel (full_block_delta_kernel) reads dO and O once,
//     8 lanes a row with 16-byte loads, and writes delta and 1/l (the
//     forward's own reciprocal) as (B, H, Sq) fp32.
// The bf16 roundings of P (for dV) and of dS (for dQ and dK) are kept.
//
// Design. dK and dV need a sum over query rows, dQ a sum over keys. One
// launch does both without atomics, so the result is deterministic: the
// grid's x axis holds ceil(Sq/128) dQ CTAs followed by ceil(Sk/128) dK/dV
// CTAs, 8 warps each. A dQ CTA keeps its 128 Q and dO rows as register
// fragments (16 rows a warp) and walks the key tiles (64 keys); a dK/dV CTA
// keeps its 128 K and V rows and walks the query tiles (64 rows). Both
// recompute Q.K^T and dO.V^T, so the launch does 4 + 4 + 2 + 2 = 12 (not
// 10) B*H*Sq*Sk*D matmul flops, all on mma.sync m16n8k16; score tiles are
// worked in 16-column chunks so that P and dS go from the accumulator
// straight into the next product's A fragment. No S x S buffer exists.
// What held the first version back, and what this one does about it:
//  * One buffer per tile (wait_all, every tile a full memory latency). The
//    walked tiles now run through a ring of `stages` shared slots filled by
//    cp.async commit groups, the next stages-1 in flight while one computes:
//    K, V and the bias row for a dQ CTA; Q, dO and the m, 1/l and delta rows
//    for a dK/dV CTA.
//  * Scalar shared loads for the B fragments (load_b_kn): every fragment is
//    now one ldmatrix x4 (.trans for dQ += dS.K, dV += P^T.dO and
//    dK += dS^T.Q).
//  * expf and a division per logit: attn_p, one FMA, one ex2 and a
//    multiply by 1/l per logit.
//  * Padding: 16-wide chunks past Sk (dQ side) or Sq (dK/dV side) are
//    skipped, and a warp whose 16 rows lie wholly past the sequence
//    computes nothing.
//  * delta as four eager fp32 ops on the host side: the pre-pass kernel.
//  * The bias row read from device memory in the inner loop: staged with
//    each key tile, or held in registers for a dK/dV CTA's own keys.
//
// Bound on the H100 SXM: 10*B*H*Sq*Sk*D operations over the 7 bf16 tensors
// (q, k, v, dO, dq, dk, dv) plus the fp32 row statistics (chip_smoke.py's
// bound; the delta pre-pass reads O in place of the delta row it writes).
// At the training shapes, D = 64: (64, 16, 512, 64) is 0.174 ms of tensor
// time against 0.140 ms of memory (operations bound); (64, 16, 266, 64) and
// (128, 8, 260, 64) are bound by bytes (~0.07 ms).
#include "attn_f32.cuh"

namespace hv {

constexpr int FBB_WARPS = 8;
constexpr int FBB_THREADS = 32 * FBB_WARPS;
constexpr int FBB_ROWS = 16 * FBB_WARPS;  // query rows / keys a CTA owns
constexpr int FBB_T = 64;                 // rows of one walked tile job
constexpr int FBB_NC = FBB_T / 16;        // 16-wide chunks per tile

struct FbbArgs {
  const e16 *q, *k, *v, *dout;
  const float *bias, *m, *il, *delta;
  e16 *dq, *dk, *dv;
  Rows sq, sk, sv, sdo, sdq, sdk, sdv;
  int H, Sq, Sk, nqb, stages;
  int hd;  // the head dim (<= the tile's D)
  float scale;
};

// Shared bytes: the CTA's own two 128-row tiles (Q and dO, or K and V),
// then `stages` slots of two 64-row tiles and three fp32 rows of 64.
template <int D>
__host__ __device__ constexpr int fbb_own_bytes() { return 2 * FBB_ROWS * (D + 8) * 2; }

template <int D>
__host__ __device__ constexpr int fbb_slot_bytes() { return 2 * FBB_T * (D + 8) * 2 + 3 * FBB_T * 4; }

template <int D>
__device__ void fbb_dq(const FbbArgs& a, unsigned char* smem, int qb) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int DT = D / 8;
  constexpr int TILE = FBB_T * LD;
  e16* Qs = reinterpret_cast<e16*>(smem);
  e16* Os = Qs + FBB_ROWS * LD;
  unsigned char* ring = smem + fbb_own_bytes<D>();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = qb * FBB_ROWS;
  const e16* kp = head_ptr(a.k, a.sk, b, h);
  const e16* vp = head_ptr(a.v, a.sv, b, h);
  const float* brow = a.bias ? a.bias + (long)b * a.Sk : nullptr;
  const float sl2 = scale_log2(a.scale);
  const int nkt = (a.Sk + FBB_T - 1) / FBB_T;
  const bool active = q0 + warp * 16 < a.Sq;

  auto slot = [&](int i) {
    return reinterpret_cast<e16*>(ring + (i % a.stages) * fbb_slot_bytes<D>());
  };
  auto issue = [&](int i) {  // K tile i, V tile i, their bias row
    e16* Ks = slot(i);
    load_tile<D, FBB_T, FBB_THREADS>(Ks, LD, kp, a.sk.s, i * FBB_T, a.Sk, tid, a.hd);
    load_tile<D, FBB_T, FBB_THREADS>(Ks + TILE, LD, vp, a.sv.s, i * FBB_T,
                                     a.Sk, tid, a.hd);
    if (brow)
      load_row_f32<FBB_T, FBB_THREADS>(reinterpret_cast<float*>(Ks + 2 * TILE),
                                       brow, i * FBB_T, a.Sk, tid);
    ring_commit();
  };

  // the CTA's Q and dO rows ride in job 0's group
  load_tile<D, FBB_ROWS, FBB_THREADS>(Qs, LD, head_ptr(a.q, a.sq, b, h),
                                      a.sq.s, q0, a.Sq, tid, a.hd);
  load_tile<D, FBB_ROWS, FBB_THREADS>(Os, LD, head_ptr(a.dout, a.sdo, b, h),
                                      a.sdo.s, q0, a.Sq, tid, a.hd);
  int issued = 0;
  for (; issued < a.stages - 1 && issued < nkt; ++issued) issue(issued);

  // this thread's two rows; a row past Sq gets 1/l = 0, so P = 0
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const long rb = ((long)b * a.H + h) * a.Sq;
  const float m0 = r0 < a.Sq ? a.m[rb + r0] : 0.f;
  const float m1 = r1 < a.Sq ? a.m[rb + r1] : 0.f;
  const float il0 = r0 < a.Sq ? a.il[rb + r0] : 0.f;
  const float il1 = r1 < a.Sq ? a.il[rb + r1] : 0.f;
  const float d0 = r0 < a.Sq ? a.delta[rb + r0] : 0.f;
  const float d1 = r1 < a.Sq ? a.delta[rb + r1] : 0.f;

  uint32_t qa[KS][4], da[KS][4];
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int i = 0; i < nkt; ++i) {
    ring_wait_upto(issued - 1 - i);
    __syncthreads();  // job i has landed; job i-1's slot is free
    if (issued < nkt) issue(issued++);
    if (i == 0) {
      load_a_rows<D>(qa, Qs, LD, warp * 16, lane);
      load_a_rows<D>(da, Os, LD, warp * 16, lane);
    }
    if (!active) continue;
    const e16* Ks = slot(i);
    const e16* Vs = Ks + TILE;
    const float* Bs = reinterpret_cast<const float*>(Ks + 2 * TILE);
    const int nc = min(FBB_NC, (a.Sk - i * FBB_T + 15) / 16);
#pragma unroll
    for (int c = 0; c < FBB_NC; ++c) {
      if (c < nc) {
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        mma_chunk_nk<KS>(s, qa, Ks, LD, c * 16, lane);
        mma_chunk_nk<KS>(dp, da, Vs, LD, c * 16, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = c * 16 + n * 8 + 2 * t;
          const float2 bb = brow ? *reinterpret_cast<const float2*>(Bs + col)
                                 : make_float2(0.f, 0.f);
          const int key = i * FBB_T + col;
          const float bl[2] = {key < a.Sk ? bias_log2(bb.x) : -INFINITY,
                               key + 1 < a.Sk ? bias_log2(bb.y) : -INFINITY};
          // dS = P * (dP - delta), P as the forward forms it
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[n][e] = attn_p(s[n][e], sl2, bl[e], m0, il0) * (dp[n][e] - d0);
            s[n][2 + e] =
                attn_p(s[n][2 + e], sl2, bl[e], m1, il1) * (dp[n][2 + e] - d1);
          }
        }
        uint32_t dsa[4];
        c_to_a(dsa, s[0], s[1]);
        mma_rows_kn<D>(acc, dsa, Ks, LD, c * 16, lane);
      }
    }
  }
  if (!active) return;

  e16* dqp = head_ptr(a.dq, a.sdq, b, h);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (col >= a.hd) continue;
    if (r0 < a.Sq) store_e16x2(dqp + (long)r0 * a.sdq.s + col, acc[dt][0], acc[dt][1], a.scale);
    if (r1 < a.Sq) store_e16x2(dqp + (long)r1 * a.sdq.s + col, acc[dt][2], acc[dt][3], a.scale);
  }
}

template <int D>
__device__ void fbb_dkv(const FbbArgs& a, unsigned char* smem, int kb) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int DT = D / 8;
  constexpr int TILE = FBB_T * LD;
  e16* Ks = reinterpret_cast<e16*>(smem);
  e16* Vs = Ks + FBB_ROWS * LD;
  unsigned char* ring = smem + fbb_own_bytes<D>();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, k0 = kb * FBB_ROWS;
  const e16* qp = head_ptr(a.q, a.sq, b, h);
  const e16* op = head_ptr(a.dout, a.sdo, b, h);
  const long rb = ((long)b * a.H + h) * a.Sq;
  const float sl2 = scale_log2(a.scale);
  const int nqt = (a.Sq + FBB_T - 1) / FBB_T;
  const bool active = k0 + warp * 16 < a.Sk;

  auto slot = [&](int i) {
    return reinterpret_cast<e16*>(ring + (i % a.stages) * fbb_slot_bytes<D>());
  };
  // Q tile i, dO tile i and their m, 1/l and delta rows (zero past Sq: a
  // query row there has 1/l = 0, so P = 0, and zero Q and dO rows)
  auto issue = [&](int i) {
    e16* Qs = slot(i);
    load_tile<D, FBB_T, FBB_THREADS>(Qs, LD, qp, a.sq.s, i * FBB_T, a.Sq, tid, a.hd);
    load_tile<D, FBB_T, FBB_THREADS>(Qs + TILE, LD, op, a.sdo.s, i * FBB_T,
                                     a.Sq, tid, a.hd);
    float* R = reinterpret_cast<float*>(Qs + 2 * TILE);
    load_row_f32<FBB_T, FBB_THREADS>(R, a.m + rb, i * FBB_T, a.Sq, tid);
    load_row_f32<FBB_T, FBB_THREADS>(R + FBB_T, a.il + rb, i * FBB_T, a.Sq, tid);
    load_row_f32<FBB_T, FBB_THREADS>(R + 2 * FBB_T, a.delta + rb, i * FBB_T,
                                     a.Sq, tid);
    ring_commit();
  };

  load_tile<D, FBB_ROWS, FBB_THREADS>(Ks, LD, head_ptr(a.k, a.sk, b, h),
                                      a.sk.s, k0, a.Sk, tid, a.hd);
  load_tile<D, FBB_ROWS, FBB_THREADS>(Vs, LD, head_ptr(a.v, a.sv, b, h),
                                      a.sv.s, k0, a.Sk, tid, a.hd);
  int issued = 0;
  for (; issued < a.stages - 1 && issued < nqt; ++issued) issue(issued);

  // this thread's two keys: their base-2 bias, -inf past Sk
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;
  const float* brow = a.bias ? a.bias + (long)b * a.Sk : nullptr;
  const float bl0 = kr0 < a.Sk ? bias_log2(brow ? brow[kr0] : 0.f) : -INFINITY;
  const float bl1 = kr1 < a.Sk ? bias_log2(brow ? brow[kr1] : 0.f) : -INFINITY;

  uint32_t ka[KS][4], va[KS][4];
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }

  for (int i = 0; i < nqt; ++i) {
    ring_wait_upto(issued - 1 - i);
    __syncthreads();  // job i has landed; job i-1's slot is free
    if (issued < nqt) issue(issued++);
    if (i == 0) {
      load_a_rows<D>(ka, Ks, LD, warp * 16, lane);
      load_a_rows<D>(va, Vs, LD, warp * 16, lane);
    }
    if (!active) continue;
    const e16* Qs = slot(i);
    const e16* Os = Qs + TILE;
    const float* R = reinterpret_cast<const float*>(Qs + 2 * TILE);
    const int nc = min(FBB_NC, (a.Sq - i * FBB_T + 15) / 16);
#pragma unroll
    for (int c = 0; c < FBB_NC; ++c) {
      if (c < nc) {
        // transposed score tiles: rows are this warp's keys, columns queries
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        mma_chunk_nk<KS>(s, ka, Qs, LD, c * 16, lane);
        mma_chunk_nk<KS>(dp, va, Os, LD, c * 16, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int qc = c * 16 + n * 8 + 2 * t;
          const float2 mq = *reinterpret_cast<const float2*>(R + qc);
          const float2 lq = *reinterpret_cast<const float2*>(R + FBB_T + qc);
          const float2 dq = *reinterpret_cast<const float2*>(R + 2 * FBB_T + qc);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float mm = e ? mq.y : mq.x, ll = e ? lq.y : lq.x;
            const float dd = e ? dq.y : dq.x;
            const float p0 = attn_p(s[n][e], sl2, bl0, mm, ll);
            const float p1 = attn_p(s[n][2 + e], sl2, bl1, mm, ll);
            s[n][e] = p0;
            s[n][2 + e] = p1;
            dp[n][e] = p0 * (dp[n][e] - dd);
            dp[n][2 + e] = p1 * (dp[n][2 + e] - dd);
          }
        }
        uint32_t pa[4], dsa[4];
        c_to_a(pa, s[0], s[1]);
        c_to_a(dsa, dp[0], dp[1]);
        mma_rows_kn<D>(dva, pa, Os, LD, c * 16, lane);
        mma_rows_kn<D>(dka, dsa, Qs, LD, c * 16, lane);
      }
    }
  }
  if (!active) return;

  e16* dkp = head_ptr(a.dk, a.sdk, b, h);
  e16* dvp = head_ptr(a.dv, a.sdv, b, h);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (col >= a.hd) continue;
    if (kr0 < a.Sk) {
      store_e16x2(dkp + (long)kr0 * a.sdk.s + col, dka[dt][0], dka[dt][1], a.scale);
      store_e16x2(dvp + (long)kr0 * a.sdv.s + col, dva[dt][0], dva[dt][1], 1.f);
    }
    if (kr1 < a.Sk) {
      store_e16x2(dkp + (long)kr1 * a.sdk.s + col, dka[dt][2], dka[dt][3], a.scale);
      store_e16x2(dvp + (long)kr1 * a.sdv.s + col, dva[dt][2], dva[dt][3], 1.f);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FBB_THREADS, D <= 64 ? 2 : 1)
full_block_bwd_kernel(const FbbArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if ((int)blockIdx.x < a.nqb)
    fbb_dq<D>(a, smem_raw, blockIdx.x);
  else
    fbb_dkv<D>(a, smem_raw, blockIdx.x - a.nqb);
}

// delta = rowsum(dO * O) in fp32 (row_delta: 8 lanes a row, 16-byte loads
// of both bf16 rows) and 1/l for every row.
constexpr int DELTA_THREADS = 256;

template <int D>
__global__ void __launch_bounds__(DELTA_THREADS)
full_block_delta_kernel(const e16* __restrict__ dout,
                        const e16* __restrict__ out,
                        const float* __restrict__ l, float* __restrict__ delta,
                        float* __restrict__ inv_l, int H, int Sq, long rows,
                        Rows sdo, Rows so, int hd) {
  const long row = ((long)blockIdx.x * DELTA_THREADS + threadIdx.x) >> 3;
  const float acc = row_delta<D>(dout, out, row, rows, H, Sq, sdo, so, hd);
  if (row < rows && (threadIdx.x & 7) == 0) {
    delta[row] = acc;
    inv_l[row] = __frcp_rn(l[row]);
  }
}

constexpr int HV_BAD_PLAN = -2;
constexpr int SMEM_MAX = 232448;  // bytes one block may use on the H100

constexpr int FBB_STAGES = 3;     // slots of the ring

// Takes only the plan flash_attention.py::_full_block_plan returns.
template <int D>
int launch_full_block_bwd(const FbbArgs& a, int B, int smem,
                          cudaStream_t stream) {
  if (a.stages != FBB_STAGES ||
      smem != fbb_own_bytes<D>() + FBB_STAGES * fbb_slot_bytes<D>() ||
      smem > SMEM_MAX)
    return HV_BAD_PLAN;
  cudaError_t err = cudaFuncSetAttribute(
      full_block_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int nkb = (a.Sk + FBB_ROWS - 1) / FBB_ROWS;
  const dim3 grid(a.nqb + nkb, a.H, B);
  full_block_bwd_kernel<D><<<grid, FBB_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
int launch_delta(const e16* dout, const e16* out, const float* l,
                 float* delta, float* inv_l, int B, int H, int Sq, int hd,
                 const long* st, cudaStream_t stream) {
  const long rows = (long)B * H * Sq;
  const long blocks = (rows * 8 + DELTA_THREADS - 1) / DELTA_THREADS;
  full_block_delta_kernel<D><<<(unsigned)blocks, DELTA_THREADS, 0, stream>>>(
      dout, out, l, delta, inv_l, H, Sq, rows, Rows{st[0], st[1], st[2]},
      Rows{st[3], st[4], st[5]}, hd);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 variant (full_block_bwd_f32_kernel, hv_full_block_bwd_f32, and its
// pre-pass full_block_delta_f32_kernel, hv_full_block_delta_f32): _bwd_kernel
// at fp32, where its roundings of P (for dV) and dS (for dQ and dK) to the
// operands' dtype are no-ops: P and dS stay fp32, every product is three
// TF32 products of a hi/lo split (attn_f32.cuh), and P is formed from the
// fp32 forward's m and 1/l with attn_p, as the bf16 kernel forms it.
//
// Bound on the H100 SXM at (32, 16, 512, 64), the camera joint block of an
// N = 2 step: 10*B*H*Sq*Sk*D = 86 GFLOP, three TF32 products each, 0.521 ms
// at 494.7 TFLOP/s, against 7 fp32 tensors and 3 rows, 0.080 ms at 3.35
// TB/s: bound by operations. The kernel recomputes S and dP on both sides
// (12, not 10, B*H*Sq*Sk*D), as the bf16 kernel does: no atomics, and two
// launches give the same bits.
//
// Design (FB32 has the plan): one launch, ceil(Sq / ROWS) dQ CTAs then
// ceil(Sk / ROWS) dK/dV CTAs along x, each of two warpgroups (fb32_cta). A
// dQ CTA keeps Q and dO resident, a dK/dV CTA K and V, each split into hi
// and lo once a CTA, K-major over D. At D <= 64 the two warpgroups own 64
// resident rows each (ROWS 128); from D 96, where 128 rows' hi and lo parts
// would not fit, they share 64 rows and split D (DS 2): each computes the
// score products over half the head dim, the two partial sums meet through
// shared memory (added in warpgroup order, so both hold the same bits),
// and each owns half of the output columns. The CTA walks tiles of BT
// rows of the other side (K and V, or Q and dO): a tile's rows arrive in
// registers (16-byte loads issued a tile ahead), each thread splits its
// own rows into the copies the score products read as they are (the B
// operands, K-major over D), and the CTA transposes those split parts into
// the copies the gradient products read: B1^T (dQ: K^T; dK/dV: Q^T) and,
// for dK/dV, B2^T (dO^T), k permuted as the P or dS accumulator gives it
// (transpose_tf32). Per walked tile i, in each warpgroup:
//  1. while tile i's score products run on TF32 wgmma (SS: X = A1.B1^T and
//     Y = A2.B2^T, S and dP for dQ, S^T and dP^T for dK/dV, 64 x BT each,
//     small terms in their own accumulators), the CTA writes tile i's
//     transposed copies;
//  2. P (attn_p, from the forward's base-2 m and 1/l) and dS = P (dP -
//     delta), in registers; a walked row past the sequence gets P = dS = 0;
//  3. gradients on TF32 wgmma (RS, P and dS split in registers as the A
//     operand; each tile's product in a fresh accumulator added once): dQ
//     += dS.K, or dV += P^T.dO then dK += dS^T.Q; the CTA splits tile
//     i + 1 as it is while the first runs, and loads tile i + 2.
// Two barriers a tile: after step 1 (the transposed copies published, the
// copies as they are free) and after step 3. The score products are SS
// wgmma of N = BT (32, or 16 from D 128), which the shared-memory reads of
// A and B hold to 318 (N 32) and 189 (N 16) TFLOP/s with two warpgroups
// on an SM, against 481 for the RS gradient products
// (scripts/wgmma_tf32_rate.cu on an H100): the score products, 4 of the
// CTA pair's 7 products a tile, take most of the time.
template <int D>
struct FB32 {
  static constexpr int THREADS = 256;
  static constexpr int DS = D <= 64 ? 1 : 2;        // warpgroups sharing D
  static constexpr int ROWS = 128 / DS;             // resident rows
  static constexpr int BT = D <= 96 ? 32 : 16;      // walked rows a tile
  static constexpr int COLS = D / DS;               // output columns of a
                                                    // warpgroup
  static constexpr int RES = ROWS * D * 4;          // one resident part
  static constexpr int NAT = BT * D * 4;            // one walked part
  // one part of the transposed tile: D rows, k positions [0, BT) for B1^T
  // and [BT, 2 BT) for dK/dV's B2^T
  static constexpr int TT = D * 128 * ((2 * BT + 31) / 32);
  static constexpr int SPLIT = 4 * NAT + 2 * TT;
  static constexpr int STATS = 3 * BT * 4;          // three fp32 rows
  static constexpr int EX = DS == 2 ? 2 * BT * 128 * 4 : 0;  // partials
  // from a 1024-byte aligned base: A1 hi, lo, A2 hi, lo; B1 hi, lo, B2 hi,
  // lo, B^T hi, lo; the walked rows' statistics, and the next tile's as
  // loaded; the score partials. The raw resident tiles land in the split
  // region.
  static constexpr int SMEM = 1024 + 4 * RES + SPLIT + 2 * STATS + EX;
  static constexpr int LOADS = (BT * D / 4 + THREADS - 1) / THREADS;
  static_assert(2 * RES <= SPLIT, "raw resident tiles fit the split region");
};

// A walked tile's rows [row0, row0 + BT) of two (S, hd) fp32 matrices into
// registers as D columns: this thread's 16-byte chunks, zero past n and
// past hd.
template <int D, int BT, int NT, int LOADS>
__device__ __forceinline__ void fb32_fetch(float4 (&w1)[LOADS],
                                           float4 (&w2)[LOADS],
                                           const float* a1, long s1,
                                           const float* a2, long s2,
                                           int row0, int n, int tid, int hd) {
  constexpr int C4 = D / 4;
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int e = tid + u * NT, r = e / C4, c = e - r * C4;
    const bool valid = e < BT * C4 && row0 + r < n && 4 * c < hd;
    const long row = valid ? row0 + r : 0;
    w1[u] = valid ? __ldg(reinterpret_cast<const float4*>(a1 + row * s1 +
                                                           4 * c))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    w2[u] = valid ? __ldg(reinterpret_cast<const float4*>(a2 + row * s2 +
                                                           4 * c))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Those registers split as they are into the K-major tiles of the score
// products' B operands: each of b1 and b2 a tile of 2 BT rows, the lo
// parts in rows [0, BT), the hi parts in [BT, 2 BT) (wg_scores2_tf32).
template <int D, int BT, int NT, int LOADS>
__device__ __forceinline__ void fb32_split_natural(const float4 (&w1)[LOADS],
                                                   const float4 (&w2)[LOADS],
                                                   unsigned char* b1,
                                                   unsigned char* b2,
                                                   int tid) {
  constexpr int C4 = D / 4;
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int e = tid + u * NT, r = e / C4, c = e - r * C4;
    if (e < BT * C4) {
      const int lo_off = sw128_f32_off(2 * BT, r, c);
      const int hi_off = sw128_f32_off(2 * BT, BT + r, c);
      float4 hi, lo;
      split_tf32x4(w1[u], hi, lo);
      *reinterpret_cast<float4*>(b1 + hi_off) = hi;
      *reinterpret_cast<float4*>(b1 + lo_off) = lo;
      split_tf32x4(w2[u], hi, lo);
      *reinterpret_cast<float4*>(b2 + hi_off) = hi;
      *reinterpret_cast<float4*>(b2 + lo_off) = lo;
    }
  }
}

// One CTA of the fp32 full-block backward: dQ of ROWS query rows (DKV
// false) or dK and dV of ROWS keys (DKV true), block `blk` of its kind.
template <int D, bool DKV>
__device__ __forceinline__ void fb32_cta(const F32GradArgs& a,
                                         unsigned char* base, int blk) {
  using P = FB32<D>;
  constexpr int R = P::ROWS, BT = P::BT, NT = P::THREADS, DS = P::DS;
  constexpr int KS = BT / 8, RES = P::RES, NAT = P::NAT, COLS = P::COLS;
  constexpr int LOADS = P::LOADS;
  unsigned char* A1h = base;
  unsigned char* A2h = base + 2 * RES;
  unsigned char* sp = base + 4 * RES;
  unsigned char* B1h = sp;
  unsigned char* B2h = sp + 2 * NAT;
  unsigned char* BTh = sp + 4 * NAT;
  unsigned char* BTl = BTh + P::TT;
  float* ST = reinterpret_cast<float*>(sp + P::SPLIT);
  float* SR = ST + 3 * BT;  // the next tile's statistics as loaded
  float* EX = SR + 3 * BT;  // DS 2: [warpgroup][partial][thread]

  const int tid = threadIdx.x, warp = tid >> 5, wg = warp >> 2;
  const int g = (tid & 31) >> 2, t = tid & 3, tw = tid & 127;
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
  const float sl2 = scale_log2(a.scale);
  const int njobs = (nwalk + BT - 1) / BT;
  // this warpgroup's rows of the resident tiles, its k steps of the score
  // products and its output columns
  const int arow = DS == 1 ? 64 * wg : 0;
  const int k0 = DS == 1 ? 0 : wg * (D / 16);
  const int c0 = DS == 1 ? 0 : wg * COLS;
  // the statistic this thread loads with a walked tile (dK/dV: the
  // queries' m, 1/l or delta; dQ: a key's bias)
  const float* wsrc = nullptr;
  if constexpr (DKV) {
    if (tid < 3 * BT)
      wsrc = (tid < BT ? a.s0 : tid < 2 * BT ? a.s1 : a.s2) + rb + tid % BT;
  } else {
    if (brow && tid < BT) wsrc = brow + tid;
  }

  // this thread's two resident rows (the C layout's g and g + 8 of its
  // warp): dQ their m, 1/l and delta (m = +inf, 1/l = 0 past Sq); dK/dV
  // their keys' base-2 bias (-inf past Sk)
  const int lr0 = r0 + arow + 16 * (warp & 3) + g;
  const int lr[2] = {lr0, lr0 + 8};
  float rm[2] = {0.f, 0.f}, ril[2] = {0.f, 0.f}, rdl[2] = {0.f, 0.f};
  float rbl[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const bool valid = lr[hf] < nres;
    if constexpr (DKV) {
      rbl[hf] = valid ? bias_log2(brow ? brow[lr[hf]] : 0.f) : -INFINITY;
    } else {
      rm[hf] = valid ? a.s0[rb + lr[hf]] : INFINITY;
      ril[hf] = valid ? a.s1[rb + lr[hf]] : 0.f;
      rdl[hf] = valid ? a.s2[rb + lr[hf]] : 0.f;
    }
  }

  // the raw resident tiles land in the split region; split once, then
  // walked tile 0 (its registers staged and split) and tile 1 loading
  float4 w1[LOADS], w2[LOADS];
  float wst;
  float* Araw = reinterpret_cast<float*>(sp);
  f32_copy_rows<D, R, NT>(Araw, ra1, rs1, r0, nres, tid, a.hd);
  f32_copy_rows<D, R, NT>(Araw + R * D, ra2, rs2, r0, nres, tid, a.hd);
  ring_commit();
  fb32_fetch<D, BT, NT, LOADS>(w1, w2, wa1, ws1, wa2, ws2, 0, nwalk, tid,
                               a.hd);
  wst = wsrc && tid % BT < nwalk ? __ldg(wsrc) : 0.f;
  ring_wait_upto(0);
  __syncthreads();
  split_rows_tf32<R, D, NT>(A1h, A1h + RES, Araw, tid);
  split_rows_tf32<R, D, NT>(A2h, A2h + RES, Araw + R * D, tid);
  __syncthreads();  // the split region is free
  if (tid < 3 * BT) SR[tid] = wst;
  fb32_split_natural<D, BT, NT, LOADS>(w1, w2, B1h, B2h, tid);
  if (njobs > 1) {
    fb32_fetch<D, BT, NT, LOADS>(w1, w2, wa1, ws1, wa2, ws2, BT, nwalk, tid,
                                 a.hd);
    wst = wsrc && BT + tid % BT < nwalk ? __ldg(wsrc + BT) : 0.f;
  }
  fence_async_smem();
  __syncthreads();

  float acc1[COLS / 2], acc2[COLS / 2];  // dQ or dK; dV
#pragma unroll
  for (int e = 0; e < COLS / 2; ++e) acc1[e] = acc2[e] = 0.f;

  for (int i = 0; i < njobs; ++i) {
    // 1. tile i's statistics (a row past the sequence masked: dQ base-2
    // bias -inf, dK/dV m = +inf and 1/l = 0), then its score products,
    // and its transposed copies while they run
    if (tid < BT) {
      const bool valid = i * BT + tid < nwalk;
      if constexpr (DKV) {
        ST[tid] = valid ? SR[tid] : INFINITY;
        ST[BT + tid] = valid ? SR[BT + tid] : 0.f;
        ST[2 * BT + tid] = valid ? SR[2 * BT + tid] : 0.f;
      } else {
        ST[tid] = valid ? bias_log2(brow ? SR[tid] : 0.f) : -INFINITY;
      }
    }
    float xw[BT], xn[BT / 2], yw[BT], yn[BT / 2];
    fence_regs(xw);
    fence_regs(xn);
    fence_regs(yw);
    fence_regs(yn);
    wgmma_fence();
    wg_scores2_tf32<D / 8 / DS, BT, R>(xw, xn, A1h, A1h + RES, arow, B1h, k0);
    wg_scores2_tf32<D / 8 / DS, BT, R>(yw, yn, A2h, A2h + RES, arow, B2h, k0);
    wgmma_commit();
    transpose_tf32<BT, D, NT, 2 * BT>(BTh, BTl, 0, B1h + BT * 128, B1h, tid);
    if constexpr (DKV)
      transpose_tf32<BT, D, NT, 2 * BT>(BTh, BTl, BT, B2h + BT * 128, B2h,
                                        tid);
    fence_async_smem();
    wgmma_wait_all();
    fence_regs(xw);
    fence_regs(xn);
    fence_regs(yw);
    fence_regs(yn);
    // X and Y: big + (the two small terms)
    float xb[BT / 2], yb[BT / 2];
#pragma unroll
    for (int e = 0; e < BT / 2; ++e) {
      xb[e] = xw[BT / 2 + e] + (xw[e] + xn[e]);
      yb[e] = yw[BT / 2 + e] + (yw[e] + yn[e]);
    }
    if constexpr (DS == 2) {
#pragma unroll
      for (int e = 0; e < BT / 2; ++e) {
        EX[(wg * BT + e) * 128 + tw] = xb[e];
        EX[(wg * BT + BT / 2 + e) * 128 + tw] = yb[e];
      }
    }
    __syncthreads();  // the transposed copies published; the copies as
                      // they are and the statistics as loaded free
    if (i + 1 < njobs && tid < 3 * BT) SR[tid] = wst;
    if constexpr (DS == 2) {
      // the other warpgroup's half of the head dim, added in warpgroup
      // order
#pragma unroll
      for (int e = 0; e < BT / 2; ++e) {
        const float xo = EX[((1 - wg) * BT + e) * 128 + tw];
        const float yo = EX[((1 - wg) * BT + BT / 2 + e) * 128 + tw];
        xb[e] = wg == 0 ? xb[e] + xo : xo + xb[e];
        yb[e] = wg == 0 ? yb[e] + yo : yo + yb[e];
      }
    }
    // 2. P into xb, dS into yb
#pragma unroll
    for (int c = 0; c < BT / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * c + 2 * t + e;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int x = 4 * c + 2 * hf + e;
          float p, ds;
          if constexpr (DKV) {
            p = attn_p(xb[x], sl2, rbl[hf], ST[col], ST[BT + col]);
            ds = p * (yb[x] - ST[2 * BT + col]);
          } else {
            p = attn_p(xb[x], sl2, ST[col], rm[hf], ril[hf]);
            ds = p * (yb[x] - rdl[hf]);
          }
          xb[x] = p;
          yb[x] = ds;
        }
      }
    // 3. the gradient products: dQ += dS.K, or dV += P^T.dO then dK +=
    // dS^T.Q, while tile i + 1 is split as it is and tile i + 2 loads
    uint32_t fh[KS][4], fl[KS][4];
    float tp[COLS / 2];
    if constexpr (DKV)
      frag_from_acc<BT>(fh, fl, xb);
    else
      frag_from_acc<BT>(fh, fl, yb);
    fence_regs(tp);
    wgmma_fence();
    wg_product_tf32<KS, COLS, D>(tp, fh, fl, BTh, BTl, c0, DKV ? KS : 0);
    wgmma_commit();
    if (i + 1 < njobs) {
      fb32_split_natural<D, BT, NT, LOADS>(w1, w2, B1h, B2h, tid);
      fence_async_smem();
    }
    wgmma_wait_all();
    fence_regs(tp);
    fence_frags(fh);
    fence_frags(fl);
#pragma unroll
    for (int e = 0; e < COLS / 2; ++e) {
      if constexpr (DKV)
        acc2[e] += tp[e];
      else
        acc1[e] += tp[e];
    }
    if constexpr (DKV) {
      frag_from_acc<BT>(fh, fl, yb);
      fence_regs(tp);
      wgmma_fence();
      wg_product_tf32<KS, COLS, D>(tp, fh, fl, BTh, BTl, c0, 0);
      wgmma_commit();
    }
    if (i + 2 < njobs) {
      const int row0 = (i + 2) * BT;
      fb32_fetch<D, BT, NT, LOADS>(w1, w2, wa1, ws1, wa2, ws2, row0, nwalk,
                                   tid, a.hd);
      wst = wsrc && row0 + tid % BT < nwalk ? __ldg(wsrc + row0) : 0.f;
    }
    if constexpr (DKV) {
      wgmma_wait_all();
      fence_regs(tp);
      fence_frags(fh);
      fence_frags(fl);
#pragma unroll
      for (int e = 0; e < COLS / 2; ++e) acc1[e] += tp[e];
    }
    __syncthreads();  // tile i + 1's copies published; tile i's free
  }

  float *o1, *o2 = nullptr;
  long os1, os2 = 0;
  if constexpr (DKV) {
    o1 = head_ptr(a.dk, a.sdk, b, h);
    os1 = a.sdk.s;
    o2 = head_ptr(a.dv, a.sdv, b, h);
    os2 = a.sdv.s;
  } else {
    o1 = head_ptr(a.dq, a.sdq, b, h);
    os1 = a.sdq.s;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (lr[hf] >= nres) continue;
#pragma unroll
    for (int jn = 0; jn < COLS / 8; ++jn) {
      const int c = c0 + 8 * jn + 2 * t, x = 4 * jn + 2 * hf;
      if (c >= a.hd) continue;
      *reinterpret_cast<float2*>(o1 + (long)lr[hf] * os1 + c) =
          make_float2(acc1[x] * a.scale, acc1[x + 1] * a.scale);
      if constexpr (DKV)
        *reinterpret_cast<float2*>(o2 + (long)lr[hf] * os2 + c) =
            make_float2(acc2[x], acc2[x + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FB32<D>::THREADS, 1)
full_block_bwd_f32_kernel(const F32GradArgs a) {
  extern __shared__ __align__(16) unsigned char fbf_smem[];
  unsigned char* base =
      fbf_smem + ((1024 - (smem_addr(fbf_smem) & 1023)) & 1023);
  if ((int)blockIdx.x < a.nqb)
    fb32_cta<D, false>(a, base, blockIdx.x);
  else
    fb32_cta<D, true>(a, base, blockIdx.x - a.nqb);
}

// delta = rowsum(dO * O) in fp32 (row_delta_f32: 8 lanes a row, 16-byte
// loads of both fp32 rows) and 1/l for every row.
template <int D>
__global__ void __launch_bounds__(DELTA_THREADS)
full_block_delta_f32_kernel(const float* __restrict__ dout,
                            const float* __restrict__ out,
                            const float* __restrict__ l,
                            float* __restrict__ delta,
                            float* __restrict__ inv_l, int H, int Sq,
                            long rows, Rows sdo, Rows so, int hd) {
  const long row = ((long)blockIdx.x * DELTA_THREADS + threadIdx.x) >> 3;
  const float acc =
      row_delta_f32<D>(dout, out, row, rows, H, Sq, sdo, so, hd);
  if (row < rows && (threadIdx.x & 7) == 0) {
    delta[row] = acc;
    inv_l[row] = __frcp_rn(l[row]);
  }
}

// Takes only the plan flash_attention.py::_full_block_f32_plan returns.
template <int D>
int launch_full_block_bwd_f32(const F32GradArgs& a, int B, int dq_rows,
                              int dkv_rows, int tile, int smem,
                              cudaStream_t stream) {
  using P = FB32<D>;
  if (dq_rows != P::ROWS || dkv_rows != P::ROWS || tile != P::BT ||
      smem != P::SMEM || smem > SMEM_MAX ||
      a.nqb != (a.Sq + dq_rows - 1) / dq_rows)
    return HV_BAD_PLAN;
  cudaError_t err = cudaFuncSetAttribute(
      full_block_bwd_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nkb = (a.Sk + dkv_rows - 1) / dkv_rows;
  const dim3 grid(a.nqb + nkb, a.H, B);
  full_block_bwd_f32_kernel<D><<<grid, P::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
int launch_delta_f32(const float* dout, const float* out, const float* l,
                     float* delta, float* inv_l, int B, int H, int Sq,
                     int hd, const long* st, cudaStream_t stream) {
  const long rows = (long)B * H * Sq;
  const long blocks = (rows * 8 + DELTA_THREADS - 1) / DELTA_THREADS;
  full_block_delta_f32_kernel<D>
      <<<(unsigned)blocks, DELTA_THREADS, 0, stream>>>(
          dout, out, l, delta, inv_l, H, Sq, rows, Rows{st[0], st[1], st[2]},
          Rows{st[3], st[4], st[5]}, hd);
  return cudaGetLastError();
}

}  // namespace hv

// Plain C entry points. D is the head dim, any multiple of 8 up to 128:
// the kernels run the tile width hv::full_block_tile(D) (columns past D
// zero-filled, never stored). hv_full_block_delta: `strides` holds 6
// element strides, (batch, head, row) of dout and out; `l` is the
// forward's (B, H, Sq) fp32 denominator; writes contiguous (B, H, Sq) fp32
// `delta` and `inv_l`. hv_full_block_bwd: `strides` holds 21 element
// strides, (batch, head, row) for q, k, v, dout, dq, dk and dv in that
// order; the last dimension of each is contiguous. `m` (from
// hv_full_block_fwd), `inv_l` and `delta` (from hv_full_block_delta) are
// contiguous (B, H, Sq) fp32; `stages` and `smem` are the launch plan of
// flash_attention.py::_full_block_plan at the tile width. Both return a
// cudaError_t, -1 for an unsupported head dim, -2 for a plan the kernel
// does not take. Built with -DHV_F16 the tensors are fp16 and the fp32
// entry points are left out.
extern "C" int hv_full_block_delta(const void* dout, const void* out,
                                   const float* l, float* delta,
                                   float* inv_l, int B, int H, int Sq, int D,
                                   const long* st, void* stream) {
  using hv::e16;
  const e16* d = static_cast<const e16*>(dout);
  const e16* o = static_cast<const e16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hv::full_block_tile(D)) {
    case 32: return hv::launch_delta<32>(d, o, l, delta, inv_l, B, H, Sq, D, st, s);
    case 64: return hv::launch_delta<64>(d, o, l, delta, inv_l, B, H, Sq, D, st, s);
    case 96: return hv::launch_delta<96>(d, o, l, delta, inv_l, B, H, Sq, D, st, s);
    case 128: return hv::launch_delta<128>(d, o, l, delta, inv_l, B, H, Sq, D, st, s);
    default: return -1;
  }
}

extern "C" int hv_full_block_bwd(const void* q, const void* k, const void* v,
                                 const float* bias, const void* dout,
                                 const float* m, const float* inv_l,
                                 const float* delta, void* dq, void* dk,
                                 void* dv, int B, int H, int Sq, int Sk, int D,
                                 int stages, int smem, float scale,
                                 const long* st, void* stream) {
  using hv::e16;
  hv::FbbArgs a;
  a.q = static_cast<const e16*>(q);
  a.k = static_cast<const e16*>(k);
  a.v = static_cast<const e16*>(v);
  a.dout = static_cast<const e16*>(dout);
  a.bias = bias;
  a.m = m;
  a.il = inv_l;
  a.delta = delta;
  a.dq = static_cast<e16*>(dq);
  a.dk = static_cast<e16*>(dk);
  a.dv = static_cast<e16*>(dv);
  hv::Rows* rows[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *rows[i] = hv::Rows{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.nqb = (Sq + hv::FBB_ROWS - 1) / hv::FBB_ROWS;
  a.stages = stages;
  a.hd = D;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hv::full_block_tile(D)) {
    case 32: return hv::launch_full_block_bwd<32>(a, B, smem, s);
    case 64: return hv::launch_full_block_bwd<64>(a, B, smem, s);
    case 96: return hv::launch_full_block_bwd<96>(a, B, smem, s);
    case 128: return hv::launch_full_block_bwd<128>(a, B, smem, s);
    default: return -1;
  }
}

#ifndef HV_F16
// fp32 entry points, as hv_full_block_delta and hv_full_block_bwd with
// fp32 tensors; hv_full_block_bwd_f32 takes the backward plan of
// flash_attention.py::_full_block_f32_plan at the tile width (`dq_rows`,
// `dkv_rows`, `tile`, `smem`).
extern "C" int hv_full_block_delta_f32(const void* dout, const void* out,
                                       const float* l, float* delta,
                                       float* inv_l, int B, int H, int Sq,
                                       int D, const long* st, void* stream) {
  const float* d = static_cast<const float*>(dout);
  const float* o = static_cast<const float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hv::full_block_tile(D)) {
    case 32: return hv::launch_delta_f32<32>(d, o, l, delta, inv_l, B, H, Sq, D, st, s);
    case 64: return hv::launch_delta_f32<64>(d, o, l, delta, inv_l, B, H, Sq, D, st, s);
    case 96: return hv::launch_delta_f32<96>(d, o, l, delta, inv_l, B, H, Sq, D, st, s);
    case 128: return hv::launch_delta_f32<128>(d, o, l, delta, inv_l, B, H, Sq, D, st, s);
    default: return -1;
  }
}

extern "C" int hv_full_block_bwd_f32(const void* q, const void* k,
                                     const void* v, const float* bias,
                                     const void* dout, const float* m,
                                     const float* inv_l, const float* delta,
                                     void* dq, void* dk, void* dv, int B,
                                     int H, int Sq, int Sk, int D,
                                     int dq_rows, int dkv_rows, int tile,
                                     int smem, float scale, const long* st,
                                     void* stream) {
  hv::F32GradArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.bias = bias;
  a.s0 = m;
  a.s1 = inv_l;
  a.s2 = delta;
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  hv::Rows* rows[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *rows[i] = hv::Rows{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.nqb = dq_rows > 0 ? (Sq + dq_rows - 1) / dq_rows : 0;
  a.hd = D;
  a.scale = scale;
  a.keyless = 0.f;  // the full-block backward forms P from m and 1 / l
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hv::full_block_tile(D)) {
    case 32: return hv::launch_full_block_bwd_f32<32>(a, B, dq_rows, dkv_rows, tile, smem, s);
    case 64: return hv::launch_full_block_bwd_f32<64>(a, B, dq_rows, dkv_rows, tile, smem, s);
    case 96: return hv::launch_full_block_bwd_f32<96>(a, B, dq_rows, dkv_rows, tile, smem, s);
    case 128: return hv::launch_full_block_bwd_f32<128>(a, B, dq_rows, dkv_rows, tile, smem, s);
    default: return -1;
  }
}
#endif

extern "C" const char* hv_full_block_bwd_error_string(int code) {
  if (code == -1) return "unsupported head dim";
  if (code == hv::HV_BAD_PLAN) return "launch plan not taken by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
