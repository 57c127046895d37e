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
  const bf16 *q, *k, *v, *dout;
  const float *bias, *m, *il, *delta;
  bf16 *dq, *dk, *dv;
  Rows sq, sk, sv, sdo, sdq, sdk, sdv;
  int H, Sq, Sk, nqb, stages;
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
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + FBB_ROWS * LD;
  unsigned char* ring = smem + fbb_own_bytes<D>();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = qb * FBB_ROWS;
  const bf16* kp = head_ptr(a.k, a.sk, b, h);
  const bf16* vp = head_ptr(a.v, a.sv, b, h);
  const float* brow = a.bias ? a.bias + (long)b * a.Sk : nullptr;
  const float sl2 = scale_log2(a.scale);
  const int nkt = (a.Sk + FBB_T - 1) / FBB_T;
  const bool active = q0 + warp * 16 < a.Sq;

  auto slot = [&](int i) {
    return reinterpret_cast<bf16*>(ring + (i % a.stages) * fbb_slot_bytes<D>());
  };
  auto issue = [&](int i) {  // K tile i, V tile i, their bias row
    bf16* Ks = slot(i);
    load_tile<D, FBB_T, FBB_THREADS>(Ks, LD, kp, a.sk.s, i * FBB_T, a.Sk, tid);
    load_tile<D, FBB_T, FBB_THREADS>(Ks + TILE, LD, vp, a.sv.s, i * FBB_T,
                                     a.Sk, tid);
    if (brow)
      load_row_f32<FBB_T, FBB_THREADS>(reinterpret_cast<float*>(Ks + 2 * TILE),
                                       brow, i * FBB_T, a.Sk, tid);
    ring_commit();
  };

  // the CTA's Q and dO rows ride in job 0's group
  load_tile<D, FBB_ROWS, FBB_THREADS>(Qs, LD, head_ptr(a.q, a.sq, b, h),
                                      a.sq.s, q0, a.Sq, tid);
  load_tile<D, FBB_ROWS, FBB_THREADS>(Os, LD, head_ptr(a.dout, a.sdo, b, h),
                                      a.sdo.s, q0, a.Sq, tid);
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
    const bf16* Ks = slot(i);
    const bf16* Vs = Ks + TILE;
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

  bf16* dqp = head_ptr(a.dq, a.sdq, b, h);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (r0 < a.Sq) store_bf16x2(dqp + (long)r0 * a.sdq.s + col, acc[dt][0], acc[dt][1], a.scale);
    if (r1 < a.Sq) store_bf16x2(dqp + (long)r1 * a.sdq.s + col, acc[dt][2], acc[dt][3], a.scale);
  }
}

template <int D>
__device__ void fbb_dkv(const FbbArgs& a, unsigned char* smem, int kb) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int DT = D / 8;
  constexpr int TILE = FBB_T * LD;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + FBB_ROWS * LD;
  unsigned char* ring = smem + fbb_own_bytes<D>();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, k0 = kb * FBB_ROWS;
  const bf16* qp = head_ptr(a.q, a.sq, b, h);
  const bf16* op = head_ptr(a.dout, a.sdo, b, h);
  const long rb = ((long)b * a.H + h) * a.Sq;
  const float sl2 = scale_log2(a.scale);
  const int nqt = (a.Sq + FBB_T - 1) / FBB_T;
  const bool active = k0 + warp * 16 < a.Sk;

  auto slot = [&](int i) {
    return reinterpret_cast<bf16*>(ring + (i % a.stages) * fbb_slot_bytes<D>());
  };
  // Q tile i, dO tile i and their m, 1/l and delta rows (zero past Sq: a
  // query row there has 1/l = 0, so P = 0, and zero Q and dO rows)
  auto issue = [&](int i) {
    bf16* Qs = slot(i);
    load_tile<D, FBB_T, FBB_THREADS>(Qs, LD, qp, a.sq.s, i * FBB_T, a.Sq, tid);
    load_tile<D, FBB_T, FBB_THREADS>(Qs + TILE, LD, op, a.sdo.s, i * FBB_T,
                                     a.Sq, tid);
    float* R = reinterpret_cast<float*>(Qs + 2 * TILE);
    load_row_f32<FBB_T, FBB_THREADS>(R, a.m + rb, i * FBB_T, a.Sq, tid);
    load_row_f32<FBB_T, FBB_THREADS>(R + FBB_T, a.il + rb, i * FBB_T, a.Sq, tid);
    load_row_f32<FBB_T, FBB_THREADS>(R + 2 * FBB_T, a.delta + rb, i * FBB_T,
                                     a.Sq, tid);
    ring_commit();
  };

  load_tile<D, FBB_ROWS, FBB_THREADS>(Ks, LD, head_ptr(a.k, a.sk, b, h),
                                      a.sk.s, k0, a.Sk, tid);
  load_tile<D, FBB_ROWS, FBB_THREADS>(Vs, LD, head_ptr(a.v, a.sv, b, h),
                                      a.sv.s, k0, a.Sk, tid);
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
    const bf16* Qs = slot(i);
    const bf16* Os = Qs + TILE;
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

  bf16* dkp = head_ptr(a.dk, a.sdk, b, h);
  bf16* dvp = head_ptr(a.dv, a.sdv, b, h);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (kr0 < a.Sk) {
      store_bf16x2(dkp + (long)kr0 * a.sdk.s + col, dka[dt][0], dka[dt][1], a.scale);
      store_bf16x2(dvp + (long)kr0 * a.sdv.s + col, dva[dt][0], dva[dt][1], 1.f);
    }
    if (kr1 < a.Sk) {
      store_bf16x2(dkp + (long)kr1 * a.sdk.s + col, dka[dt][2], dka[dt][3], a.scale);
      store_bf16x2(dvp + (long)kr1 * a.sdv.s + col, dva[dt][2], dva[dt][3], 1.f);
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
full_block_delta_kernel(const bf16* __restrict__ dout,
                        const bf16* __restrict__ out,
                        const float* __restrict__ l, float* __restrict__ delta,
                        float* __restrict__ inv_l, int H, int Sq, long rows,
                        Rows sdo, Rows so) {
  const long row = ((long)blockIdx.x * DELTA_THREADS + threadIdx.x) >> 3;
  const float acc = row_delta<D>(dout, out, row, rows, H, Sq, sdo, so);
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
int launch_delta(const bf16* dout, const bf16* out, const float* l,
                 float* delta, float* inv_l, int B, int H, int Sq,
                 const long* st, cudaStream_t stream) {
  const long rows = (long)B * H * Sq;
  const long blocks = (rows * 8 + DELTA_THREADS - 1) / DELTA_THREADS;
  full_block_delta_kernel<D><<<(unsigned)blocks, DELTA_THREADS, 0, stream>>>(
      dout, out, l, delta, inv_l, H, Sq, rows, Rows{st[0], st[1], st[2]},
      Rows{st[3], st[4], st[5]});
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
// (12, not 10, B*H*Sq*Sk*D), as the bf16 kernel does.
//
// Design: one launch, no atomics, as the bf16 kernel: ceil(Sq / R) dQ CTAs
// then ceil(Sk / R) dK/dV CTAs along x, each an f32_grad_cta of 8 warps
// (attn_f32.cuh has the steps). Where the bf16 kernel keeps 128 rows of Q
// and dO (or K and V) as register fragments, at fp32 with hi/lo splits that
// would be 4x the registers; here a CTA owns 64 rows (fg_rows at D <= 128),
// keeps them in shared memory and splits each fragment as it is read, and
// walks tiles of 32 rows (fg_tile). The dQ CTA's P and dS come from the
// forward's m and 1/l of its rows and the bias of each walked key; the
// dK/dV CTA's from the m, 1/l and delta rows that travel with each walked
// query tile and the bias of its own keys. A key past Sk or a query row
// past Sq gets P = dS = 0. Each CTA launch takes max(fg_smem) bytes (its
// two kinds' plans, flash_attention.py::_full_block_f32_plan).
template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
full_block_bwd_f32_kernel(const F32GradArgs a) {
  extern __shared__ float4 fbf_dyn[];
  float* smem = reinterpret_cast<float*>(fbf_dyn);
  if ((int)blockIdx.x < a.nqb)
    f32_grad_cta<D, fg_rows<D, 1>(), fg_tile<D, 1>(), false, false>(
        a, smem, blockIdx.x);
  else
    f32_grad_cta<D, fg_rows<D, 2>(), fg_tile<D, 2>(), true, false>(
        a, smem, blockIdx.x - a.nqb);
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
                            long rows, Rows sdo, Rows so) {
  const long row = ((long)blockIdx.x * DELTA_THREADS + threadIdx.x) >> 3;
  const float acc = row_delta_f32<D>(dout, out, row, rows, H, Sq, sdo, so);
  if (row < rows && (threadIdx.x & 7) == 0) {
    delta[row] = acc;
    inv_l[row] = __frcp_rn(l[row]);
  }
}

template <int D>
constexpr int fbf_smem_bytes() {
  return fg_smem<D, 1>() > fg_smem<D, 2>() ? fg_smem<D, 1>() : fg_smem<D, 2>();
}

// Takes only the plan flash_attention.py::_full_block_f32_plan returns.
template <int D>
int launch_full_block_bwd_f32(const F32GradArgs& a, int B, int dq_rows,
                              int dkv_rows, int tile, int smem,
                              cudaStream_t stream) {
  if (dq_rows != fg_rows<D, 1>() || dkv_rows != fg_rows<D, 2>() ||
      tile != fg_tile<D, 1>() || tile != fg_tile<D, 2>() ||
      smem != fbf_smem_bytes<D>() || smem > SMEM_MAX ||
      a.nqb != (a.Sq + dq_rows - 1) / dq_rows)
    return HV_BAD_PLAN;
  cudaError_t err = cudaFuncSetAttribute(
      full_block_bwd_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nkb = (a.Sk + dkv_rows - 1) / dkv_rows;
  const dim3 grid(a.nqb + nkb, a.H, B);
  full_block_bwd_f32_kernel<D><<<grid, F32_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
int launch_delta_f32(const float* dout, const float* out, const float* l,
                     float* delta, float* inv_l, int B, int H, int Sq,
                     const long* st, cudaStream_t stream) {
  const long rows = (long)B * H * Sq;
  const long blocks = (rows * 8 + DELTA_THREADS - 1) / DELTA_THREADS;
  full_block_delta_f32_kernel<D>
      <<<(unsigned)blocks, DELTA_THREADS, 0, stream>>>(
          dout, out, l, delta, inv_l, H, Sq, rows, Rows{st[0], st[1], st[2]},
          Rows{st[3], st[4], st[5]});
  return cudaGetLastError();
}

}  // namespace hv

// Plain C entry points. hv_full_block_delta: `strides` holds 6 element
// strides, (batch, head, row) of dout and out; `l` is the forward's
// (B, H, Sq) fp32 denominator; writes contiguous (B, H, Sq) fp32 `delta`
// and `inv_l`. hv_full_block_bwd: `strides` holds 21 element strides,
// (batch, head, row) for q, k, v, dout, dq, dk and dv in that order; the
// last dimension of each is contiguous. `m` (from hv_full_block_fwd),
// `inv_l` and `delta` (from hv_full_block_delta) are contiguous (B, H, Sq)
// fp32; `stages` and `smem` are the launch plan of
// flash_attention.py::_full_block_plan. Both return a cudaError_t, -1 for
// an unsupported head dim, -2 for a plan the kernel does not take.
extern "C" int hv_full_block_delta(const void* dout, const void* out,
                                   const float* l, float* delta,
                                   float* inv_l, int B, int H, int Sq, int D,
                                   const long* st, void* stream) {
  using hv::bf16;
  const bf16* d = static_cast<const bf16*>(dout);
  const bf16* o = static_cast<const bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return hv::launch_delta<32>(d, o, l, delta, inv_l, B, H, Sq, st, s);
    case 64: return hv::launch_delta<64>(d, o, l, delta, inv_l, B, H, Sq, st, s);
    case 96: return hv::launch_delta<96>(d, o, l, delta, inv_l, B, H, Sq, st, s);
    case 128: return hv::launch_delta<128>(d, o, l, delta, inv_l, B, H, Sq, st, s);
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
  using hv::bf16;
  hv::FbbArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.bias = bias;
  a.m = m;
  a.il = inv_l;
  a.delta = delta;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  hv::Rows* rows[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *rows[i] = hv::Rows{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.nqb = (Sq + hv::FBB_ROWS - 1) / hv::FBB_ROWS;
  a.stages = stages;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return hv::launch_full_block_bwd<32>(a, B, smem, s);
    case 64: return hv::launch_full_block_bwd<64>(a, B, smem, s);
    case 96: return hv::launch_full_block_bwd<96>(a, B, smem, s);
    case 128: return hv::launch_full_block_bwd<128>(a, B, smem, s);
    default: return -1;
  }
}

// fp32 entry points, as hv_full_block_delta and hv_full_block_bwd with
// fp32 tensors; hv_full_block_bwd_f32 takes the backward plan of
// flash_attention.py::_full_block_f32_plan (`dq_rows`, `dkv_rows`, `tile`,
// `smem`).
extern "C" int hv_full_block_delta_f32(const void* dout, const void* out,
                                       const float* l, float* delta,
                                       float* inv_l, int B, int H, int Sq,
                                       int D, const long* st, void* stream) {
  const float* d = static_cast<const float*>(dout);
  const float* o = static_cast<const float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return hv::launch_delta_f32<32>(d, o, l, delta, inv_l, B, H, Sq, st, s);
    case 64: return hv::launch_delta_f32<64>(d, o, l, delta, inv_l, B, H, Sq, st, s);
    case 96: return hv::launch_delta_f32<96>(d, o, l, delta, inv_l, B, H, Sq, st, s);
    case 128: return hv::launch_delta_f32<128>(d, o, l, delta, inv_l, B, H, Sq, st, s);
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
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return hv::launch_full_block_bwd_f32<32>(a, B, dq_rows, dkv_rows, tile, smem, s);
    case 64: return hv::launch_full_block_bwd_f32<64>(a, B, dq_rows, dkv_rows, tile, smem, s);
    case 96: return hv::launch_full_block_bwd_f32<96>(a, B, dq_rows, dkv_rows, tile, smem, s);
    case 128: return hv::launch_full_block_bwd_f32<128>(a, B, dq_rows, dkv_rows, tile, smem, s);
    default: return -1;
  }
}

extern "C" const char* hv_full_block_bwd_error_string(int code) {
  if (code == -1) return "unsupported head dim";
  if (code == hv::HV_BAD_PLAN) return "launch plan not taken by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
