// Streaming (online-softmax) attention forward with LSE for Hopper
// (sm_90a), bf16 in, bf16 out, fp32 log-sum-exp; and, below, its fp32
// variant (stream_fwd_f32_kernel, hv_stream_fwd_f32).
//
// Replaces hivae_tpu/ops/pallas/flash_attention.py::_stream_fwd_kernel
// (driven by _stream_fwd_impl / stream_fwd_lse): a loop over KV tiles with a
// running row max m, denominator l and output accumulator; the
// unnormalised p = exp(s - m) is rounded to bf16 for P.V, l sums the fp32 p,
// and the epilogue writes O = acc / l and LSE = m + log(l) (natural log: the
// streaming backward forms P = exp(s - lse) from it).
//
// Bound on the H100 SXM at the serving shape (17, 1, 1024, 512): 4*B*H*S*S*D
// = 36.5 GFLOP of matmul, 36.9 us at 989 TFLOP/s, against 71.4 MB of q, k,
// v, o and LSE, 21.3 us at 3.35 TB/s, so the bound is operations.
//
// Design. A CTA of two consumer warpgroups takes 64 query rows of one
// (batch, head). At D = 512 the 64 x 512 fp32 output accumulator is 256
// registers a thread for one warpgroup, so it is split over D: warpgroup w
// owns output columns [w D/2, (w + 1) D/2), 128 registers a thread at
// D = 512, as m64n64 blocks (m64n32 at D = 64). Both need the probabilities
// of every key for their columns, so the score tile is split over keys
// instead: warpgroup w computes the 64 rows' scores against keys
// [32 w, 32 w + 32) of the tile (wgmma m64n32k16, Q and K both K-major in
// 128-byte-swizzled shared memory), the two exchange their row maxima
// through shared memory (one barrier), each writes its half of bf16(P) into
// a shared 64 x 64 tile (a second barrier), and each reads the whole tile
// back as A fragments (ldmatrix). Each keeps its half of the denominator;
// the halves are summed once, at the end. The tensor cores do each Q.K^T
// once (computing the whole tile in each warpgroup, without the exchange,
// measured slower: 1.5x the matmul work at D = 512).
// P is the register A operand of P.V; V, stored swizzled as it arrives, is
// read transposed (MN-major), one 64-column swizzle atom a wgmma.
// Loads overlap compute: K and V tiles of 64 keys travel as separate jobs
// (K_j, V_j, K_j+1, ...) through a ring of `stages` slots filled by TMA and
// completed on mbarriers, so V_j lands while S_j and its softmax run and
// K_j+1 while P_j.V_j runs (a cp.async ring issued by every thread was
// slower). At D = 512 a K or V tile is 64 KB, so the Q tile and two slots
// fill 195 KB: one CTA a SM. The plan (slots, shared bytes) comes from
// flash_attention.py::_stream_plan, which the CPU tests check; the C entry
// point refuses any other.
//
// The softmax runs on natural-unit logits t = s * scale + bias (one FMA):
// p = 2^((t - m) log2 e), so a fully masked row (bias -1e30 on every key)
// keeps m = -1e30 and p = 1 on every key, the uniform average, and its LSE
// is the plain version's. Keys past Sk are -inf; the last tile's Q.K^T is
// m64n16/32/48/64 up to the next multiple of 16 past Sk, and its P.V skips
// the chunks past it. Rows past Sq are zero-filled and not stored.
//
// D = 640 (the CNN motion AE's MapConv, (B, 1, 1024, 640)): a 64 x 640 Q
// tile is 80 KB and a 64-key K or V tile as much, so two slots would not
// fit beside Q. There a K or V tile holds 32 keys (40 KB; three slots fit):
// each warpgroup scores 16 keys of it (m64n16), P is a 64 x 32 tile and
// P.V runs 2 chunks of 16 keys a tile into 5 m64n64 blocks of output
// columns a warpgroup (160 accumulator registers a thread). The plan's
// tile rows come from sf_bk, which the Python plan mirrors.
//
// Grid: ceil(Sq / 64) x H x B CTAs, 16 x 1 x 17 = 272 at the serving shape,
// 2.06 waves of one CTA a SM on 132 SMs. The third wave is nearly empty, so
// the launch takes about three CTA times where 2.06 would do; the plan does
// not avoid it (a split over keys merged by LSE, or a persistent schedule,
// would).
#include "attn_common.cuh"

namespace hv {

constexpr int SF_BQ = 64;        // query rows a CTA (one wgmma M)
constexpr int SF_BK_MAX = 64;    // keys a K or V tile, at most
constexpr int SF_THREADS = 256;  // two warpgroups
constexpr int SF_MAX_STAGES = 4;
constexpr int SF_SMEM_MAX = 232448;
constexpr int SF_PLD_MAX = SF_BK_MAX + 8;  // row stride of the P tile, at most
// static shared bytes: the mbarriers, the P tile and the row partials
constexpr int SF_STATIC = 8 * (SF_MAX_STAGES + 1) + SF_BQ * SF_PLD_MAX * 2 +
                          2 * SF_BQ * 4;

// Keys a K or V tile: 64, or 32 past D = 512 (a 64-key tile would leave
// room for one slot beside Q).
template <int D>
__host__ __device__ constexpr int sf_bk() { return D > 512 ? 32 : 64; }

// Shared bytes, from a 1024-byte aligned base: the swizzled Q tile, then
// `stages` slots of one swizzled K or V tile and a tile's fp32 bias row,
// each rounded up to 1024 bytes.
template <int D>
__host__ __device__ constexpr int sf_q_bytes() { return sw128_bytes<D, SF_BQ>(); }

template <int D>
__host__ __device__ constexpr int sf_tile_bytes() {
  return sw128_bytes<D, sf_bk<D>()>();
}

template <int D>
__host__ __device__ constexpr int sf_slot_bytes() {
  return (sf_tile_bytes<D>() + sf_bk<D>() * 4 + 1023) / 1024 * 1024;
}

template <int D>
__host__ __device__ constexpr int sf_smem_bytes(int stages) {
  return 1024 + sf_q_bytes<D>() + stages * sf_slot_bytes<D>();
}

// The slots the plan takes: as many as fit, at most SF_MAX_STAGES.
template <int D>
__host__ int sf_stages() {
  const int n = (SF_SMEM_MAX - SF_STATIC - 1024 - sf_q_bytes<D>()) /
                sf_slot_bytes<D>();
  return n < SF_MAX_STAGES ? n : SF_MAX_STAGES;
}

// tq, tk, tv: tensor maps of q, k and v as (D, S, H, B) arrays, boxes of
// 64 columns x 64 rows (Q) or sf_bk rows (K, V), 128-byte swizzled.
template <int D>
__global__ void __launch_bounds__(SF_THREADS, 1)
stream_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const float* __restrict__ bias, bf16* __restrict__ o,
                  float* __restrict__ lse, int H, int Sq, int Sk, float scale,
                  int stages, long osb, long osh, long oss) {
  constexpr int DH = D / 2;                  // output columns a warpgroup
  constexpr int NW = DH < 64 ? DH : 64;      // columns a P.V wgmma
  constexpr int NB = DH / NW;                // P.V wgmmas a 16-key chunk
  constexpr int BK = sf_bk<D>(), NC = BK / 16, PLD = BK + 8;
  constexpr int KW = BK / 2;                 // keys a warpgroup scores
  constexpr int CW = KW / 16;                // its 16-key chunks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t full[SF_MAX_STAGES + 1];  // slots' jobs, then Q
  __shared__ __align__(16) bf16 Ps[SF_BQ * SF_PLD_MAX];  // bf16(P) of a tile
  __shared__ float xm[2][SF_BQ];  // each warpgroup's row maxima of a tile
                                  // (at the end: its denominators)
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  unsigned char* ring = base + sf_q_bytes<D>();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, rw = (warp & 3) * 16;  // warpgroup, first row
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * SF_BQ;
  const float* brow = bias ? bias + (long)b * Sk : nullptr;
  const int nkt = (Sk + BK - 1) / BK, njobs = 2 * nkt;

  // job 2j: K tile j (TMA, one box a 64-column block, completing on
  // full[slot]) and its bias row (cp.async, one commit group a job, empty
  // without a bias); job 2j + 1: V tile j. Rows past Sk arrive zero-filled.
  auto slot = [&](int i) { return ring + (i % stages) * sf_slot_bytes<D>(); };
  auto issue = [&](int i) {
    if (i < njobs) {
      unsigned char* sl = slot(i);
      const int j = i >> 1;
      if (tid == 0) {
        uint64_t* bar = full + i % stages;
        mbar_expect(bar, sf_tile_bytes<D>());
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sl + c * BK * 128, (i & 1) ? &tv : &tk, bar, c * 64,
                      j * BK, h, b);
      }
      if (brow && !(i & 1))
        load_row_f32<BK, SF_THREADS>(
            reinterpret_cast<float*>(sl + sf_tile_bytes<D>()), brow, j * BK,
            Sk, tid);
    }
    ring_commit();  // an empty group past the last job keeps the count
  };

  if (tid == 0) {
    for (int i = 0; i <= stages; ++i) mbar_init(full + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    uint64_t* qbar = full + stages;
    mbar_expect(qbar, sf_q_bytes<D>());
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      tma_load_4d(base + c * SF_BQ * 128, &tq, qbar, c * 64, q0, h, b);
  }
  for (int i = 0; i < stages - 1; ++i) issue(i);
  mbar_wait(full + stages, 0);

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NB][NW / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) acc[nb][e] = 0.f;
  uint32_t pa[NC][4] = {};

  for (int i = 0; i < njobs; ++i) {
    ring_wait_upto(stages - 2);  // this thread's share of the bias row
    mbar_wait(full + i % stages, (i / stages) & 1);
    __syncthreads();  // job i has landed; job i-1's slot is free
    issue(i + stages - 1);
    const int j = i >> 1;
    const unsigned char* sl = slot(i);
    const int nc = min(NC, (Sk - j * BK + 15) / 16);

    if (!(i & 1)) {
      // scores of the 64 rows against this warpgroup's KW keys of the tile,
      // up to the next multiple of 16 past Sk: this warp's 16 rows,
      // s[4 u + e] for 8-key group u
      const int ncw = min(CW, max(0, nc - CW * wg));  // its 16-key chunks
      const bf16* Kw = reinterpret_cast<const bf16*>(sl + wg * KW * 128);
      float s[32];
      if (ncw == 1) wgmma_qk<D, 16, SF_BQ, BK>(s, Qs, 0, Kw);
      if constexpr (CW == 2)
        if (ncw == 2) wgmma_qk<D, 32, SF_BQ, BK>(s, Qs, 0, Kw);
      const float* Bs =
          reinterpret_cast<const float*>(sl + sf_tile_bytes<D>());
      const bool plain = !brow && (j + 1) * BK <= Sk;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int u = 0; u < KW / 8; ++u) {
        float* x = s + 4 * u;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wg * KW + u * 8 + 2 * t + e;
          float bb = 0.f;
          if (!plain) {
            bb = j * BK + col < Sk ? (brow ? Bs[col] : 0.f) : -INFINITY;
          }
          // chunks past the last product hold no scores at all
          x[e] = u < 2 * ncw ? fmaf(x[e], scale, bb) : -INFINITY;
          x[2 + e] = u < 2 * ncw ? fmaf(x[2 + e], scale, bb) : -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(x[0], x[1]));
        mx1 = fmaxf(mx1, fmaxf(x[2], x[3]));
      }
      // the row max over both halves, read in the same order by both
      // warpgroups, so both hold the same m
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      if (t == 0) {
        xm[wg][rw + g] = mx0;
        xm[wg][rw + g + 8] = mx1;
      }
      __syncthreads();
      const float mn0 = fmaxf(m0, fmaxf(xm[0][rw + g], xm[1][rw + g]));
      const float mn1 =
          fmaxf(m1, fmaxf(xm[0][rw + g + 8], xm[1][rw + g + 8]));
      const float c0 = ex2((m0 - mn0) * LOG2E), c1 = ex2((m1 - mn1) * LOG2E);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int u = 0; u < KW / 8; ++u) {
        float* x = s + 4 * u;
        x[0] = ex2((x[0] - mn0) * LOG2E);
        x[1] = ex2((x[1] - mn0) * LOG2E);
        x[2] = ex2((x[2] - mn1) * LOG2E);
        x[3] = ex2((x[3] - mn1) * LOG2E);
        sum0 += x[0] + x[1];
        sum1 += x[2] + x[3];
        // bf16(P) of this half into the shared 64 x BK tile
        const int col = wg * KW + u * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(Ps + (rw + g) * PLD + col) =
            pack_bf16(x[0], x[1]);
        *reinterpret_cast<uint32_t*>(Ps + (rw + g + 8) * PLD + col) =
            pack_bf16(x[2], x[3]);
      }
      // this warpgroup's part of the denominator (the halves are summed
      // once, at the end)
      l0 = l0 * c0 + quad_sum(sum0);
      l1 = l1 * c1 + quad_sum(sum1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < NW / 2; e += 4) {
          acc[nb][e] *= c0;
          acc[nb][e + 1] *= c0;
          acc[nb][e + 2] *= c1;
          acc[nb][e + 3] *= c1;
        }
      __syncthreads();  // both halves of P are in the tile
      load_a_rows<BK>(pa, Ps, PLD, rw, lane);
    } else {
      // acc += bf16(P) . V over this warpgroup's D/2 columns: V chunk c (16
      // keys) of swizzle atom a (64 columns) at a * BK rows * 128 + c * 2048
      const unsigned char* Vs = sl;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nc) {
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            const int col = wg * DH + nb * NW;  // first output column
            const uint64_t dv = desc_sw128_mn(
                Vs + (col / 64) * BK * 128 + (col % 64) * 2 + c * 2048,
                BK * 128);
            if constexpr (NW == 64)
              wgmma_rs64(acc[nb], pa[c], dv);
            else
              wgmma_rs32(acc[nb], pa[c], dv);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();  // the slot is overwritten after the next barrier
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(pa[c]);
    }
  }
  ring_wait_upto(0);

  // the denominator: the two warpgroups' parts, summed in the same order
  // by both
  if (t == 0) {
    xm[wg][rw + g] = l0;
    xm[wg][rw + g + 8] = l1;
  }
  __syncthreads();
  l0 = xm[0][rw + g] + xm[1][rw + g];
  l1 = xm[0][rw + g + 8] + xm[1][rw + g + 8];
  bf16* op = o + b * osb + h * osh;
  const int r0 = q0 + rw + g, r1 = r0 + 8;
  const float il0 = __frcp_rn(l0), il1 = __frcp_rn(l1);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int jn = 0; jn < NW / 8; ++jn) {
      const int col = wg * DH + nb * NW + jn * 8 + 2 * t;
      const float* a = acc[nb] + 4 * jn;
      if (r0 < Sq) store_bf16x2(op + (long)r0 * oss + col, a[0], a[1], il0);
      if (r1 < Sq) store_bf16x2(op + (long)r1 * oss + col, a[2], a[3], il1);
    }
  if (wg == 0 && t == 0) {
    float* lp = lse + ((long)b * H + h) * Sq;
    if (r0 < Sq) lp[r0] = m0 + logf(l0);
    if (r1 < Sq) lp[r1] = m1 + logf(l1);
  }
}

constexpr int HV_BAD_PLAN = -2;

// ---------------------------------------------------------------------------
// fp32 variant: the same function with fp32 Q, K, V, O and LSE, P kept in
// fp32 for P.V, as the Pallas kernel computes it for fp32 operands (its
// p.astype(v.dtype) is then the identity). It serves the fp32 SD-VAE
// (``AutoencoderKL()`` builds in fp32): the mid-block attention,
// (B, 1, 1024, 512), of ``cli.vis`` and ``cli.frequency_filter_decode``.
//
// Bound on the H100 SXM at (16, 1, 1024, 512): 4*B*H*S*S*D = 34.4 GFLOP,
// 0.51 ms at the 67 TFLOP/s of fp32 outside the tensor cores (the rate
// this kernel's arithmetic runs at), against 134 MB of q, k, v and o,
// 0.040 ms at 3.35 TB/s: the bound is operations. (At the 495 TFLOP/s of
// TF32 it would be 0.069 ms; this kernel does not use the tensor cores, so
// that every product is a full fp32 one, as the plain version's.)
//
// Design: SIMT, correct first. A CTA of 256 threads takes 32 query rows of
// one (batch, head) and walks the keys in tiles of 64 (32 past D = 512).
// The Q tile and one K or V tile sit in shared memory with rows D + 4
// floats apart (a 16-byte pad: consecutive rows start four banks apart, so
// the float4 reads of eight neighbouring rows meet no bank conflict), 198
// KB at D = 512: one CTA a SM. S = Q.K^T: thread (ty, tx) of a 16 x 16
// grid sums rows ty + 16 i against keys tx + 16 j over float4 steps of D;
// each row's 16 threads reduce the tile's maximum and sum by shuffles and
// one of them keeps the row's running max, denominator and rescale factor
// in shared memory; fp32 P goes to a shared tile. Then V replaces K in the
// same buffer, and P.V runs with warp w owning output rows 4w..4w+3 and
// lane l the float4 columns l + 32 c: the P values are warp-uniform reads
// (broadcasts) and the V row a contiguous 512-byte read. The 32 x D output
// accumulator lives in registers (64 a thread at D = 512, 80 at 640).
// Tiles travel by cp.async, each a single group of copies in flight at
// once: V's under the softmax, which needs no shared K or V; K's
// otherwise alone (no room for a second K/V slot at D = 512).
//
// Softmax as the bf16 kernel: t = s * scale + bias, p = 2^((t - m) log2 e),
// so a fully masked row keeps m = -1e30 and averages its keys uniformly;
// keys past Sk are -inf and rows past Sq are zero-filled and not stored.
// Grid: ceil(Sq / 32) x H x B, 512 CTAs at the serving shape.
constexpr int SF32_BQ = 32;
constexpr int SF32_THREADS = 256;

template <int D>
__host__ __device__ constexpr int sf32_bk() { return D > 512 ? 32 : 64; }

// Shared bytes: Q (BQ rows) and one K/V tile (bk rows), rows D + 4 floats
// apart, the fp32 P tile (rows bk + 4 apart) and three rows of statistics.
template <int D>
__host__ __device__ constexpr int sf32_smem_bytes() {
  return ((SF32_BQ + sf32_bk<D>()) * (D + 4) +
          SF32_BQ * (sf32_bk<D>() + 4) + 3 * SF32_BQ) * 4;
}

// Rows [r0, r0 + rows) of an fp32 (S, D) matrix whose rows are `ss`
// elements apart into a shared tile of rows D + 4 floats apart, rows at or
// past n zero-filled: every thread issues its share of 16-byte cp.async
// copies and closes them as one group, so the whole tile is in flight at
// once; wait for the group and synchronise before reading it.
template <int D, int ROWS>
__device__ __forceinline__ void sf32_load_rows(float* dst, const float* src,
                                               long ss, int r0, int n) {
  constexpr int NC4 = D / 4, LD = D + 4;
  for (int i = threadIdx.x; i < ROWS * NC4; i += SF32_THREADS) {
    const int r = i / NC4, c = i - r * NC4;
    const bool valid = r0 + r < n;
    cp_async16(dst + r * LD + 4 * c,
               src + (valid ? (long)(r0 + r) * ss + 4 * c : 0), valid);
  }
  ring_commit();
}

template <int D>
__global__ void __launch_bounds__(SF32_THREADS, 1)
stream_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias, float* __restrict__ o,
                      float* __restrict__ lse, int H, int Sq, int Sk,
                      float scale,
                      long qsb, long qsh, long qss, long ksb, long ksh,
                      long kss, long vsb, long vsh, long vss, long osb,
                      long osh, long oss) {
  constexpr int BQ = SF32_BQ, BK = sf32_bk<D>(), LD = D + 4, PLD = BK + 4;
  constexpr int NC4 = D / 4;                // float4 columns of a row
  constexpr int CPT = (NC4 + 31) / 32;      // of them a lane, in P.V
  constexpr int SR = BQ / 16, SC = BK / 16;  // S entries a thread
  extern __shared__ float4 sf32_smem[];
  float* qs = reinterpret_cast<float*>(sf32_smem);
  float* kv = qs + BQ * LD;
  float* ps = kv + BK * LD;
  float* row_m = ps + BQ * PLD;
  float* row_l = row_m + BQ;
  float* row_a = row_l + BQ;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* kp = k + b * ksb + h * ksh;
  const float* vp = v + b * vsb + h * vsh;
  const float* bp = bias ? bias + (long)b * Sk : nullptr;
  const float sl = __fmul_rn(scale, LOG2E);

  sf32_load_rows<D, BQ>(qs, q + b * qsb + h * qsh + (long)q0 * qss, qss, 0,
                        Sq - q0);
  sf32_load_rows<D, BK>(kv, kp, kss, 0, Sk);
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  const int tx = tid & 15, ty = tid >> 4;   // S: 16 x 16 threads
  const int lane = tid & 31, w = tid >> 5;  // P.V: rows 4w.., columns lane..
  float4 acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    ring_wait_upto(0);  // this tile's K (and, at the first, Q)
    __syncthreads();
    float s[SR][SC];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < NC4; ++d4) {
      float4 qa[SR], kb[SC];
#pragma unroll
      for (int i = 0; i < SR; ++i)
        qa[i] = reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD)[d4];
#pragma unroll
      for (int j = 0; j < SC; ++j)
        kb[j] = reinterpret_cast<const float4*>(kv + (tx + 16 * j) * LD)[d4];
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }
    __syncthreads();  // K is consumed: V's copies run under the softmax
    sf32_load_rows<D, BK>(kv, vp, vss, k0, Sk);
    // online softmax in base 2; each row belongs to one half-warp
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int row = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int key = k0 + tx + 16 * j;
        const float t = key < Sk
            ? fmaf(s[i][j], sl, bp ? __fmul_rn(bp[key], LOG2E) : 0.f)
            : -INFINITY;
        s[i][j] = t;
        mx = fmaxf(mx, t);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        ps[row * PLD + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (tx == 0) {
        const float alpha = exp2f(m_old - m_new);  // 0 at the first tile
        row_a[row] = alpha;
        row_l[row] = fmaf(row_l[row], alpha, sum);
        row_m[row] = m_new;
      }
    }
    ring_wait_upto(0);
    __syncthreads();  // V, P and the factors are in place
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = row_a[4 * w + r];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        acc[r][c].x *= a;
        acc[r][c].y *= a;
        acc[r][c].z *= a;
        acc[r][c].w *= a;
      }
    }
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = ps[(4 * w + r) * PLD + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        if (lane + 32 * c < NC4) {
          const float4 vv =
              reinterpret_cast<const float4*>(kv + kk * LD)[lane + 32 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][c].x = fmaf(p[r], vv.x, acc[r][c].x);
            acc[r][c].y = fmaf(p[r], vv.y, acc[r][c].y);
            acc[r][c].z = fmaf(p[r], vv.z, acc[r][c].z);
            acc[r][c].w = fmaf(p[r], vv.w, acc[r][c].w);
          }
        }
      }
    }
    __syncthreads();  // V is consumed: the next K's copies
    if (k0 + BK < Sk) sf32_load_rows<D, BK>(kv, kp, kss, k0 + BK, Sk);
  }
  float* op = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * w + r;
    if (row >= Sq) continue;
    const float il = 1.f / row_l[4 * w + r];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (lane + 32 * c < NC4) {
        float4 x = acc[r][c];
        x.x *= il;
        x.y *= il;
        x.z *= il;
        x.w *= il;
        reinterpret_cast<float4*>(op + (long)row * oss)[lane + 32 * c] = x;
      }
  }
  if (tid < BQ && q0 + tid < Sq)
    lse[((long)b * H + h) * Sq + q0 + tid] =
        (row_m[tid] + log2f(row_l[tid])) * 0.69314718055994531f;
}

template <int D>
int launch_stream_f32(const float* q, const float* k, const float* v,
                      const float* bias, float* o, float* lse, int B, int H,
                      int Sq, int Sk, int bk, int smem, float scale,
                      const long* st, cudaStream_t stream) {
  if (bk != sf32_bk<D>() || smem != sf32_smem_bytes<D>() ||
      smem > SF_SMEM_MAX)
    return HV_BAD_PLAN;
  cudaError_t err = cudaFuncSetAttribute(
      stream_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + SF32_BQ - 1) / SF32_BQ, H, B);
  stream_fwd_f32_kernel<D><<<grid, SF32_THREADS, smem, stream>>>(
      q, k, v, bias, o, lse, H, Sq, Sk, scale, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}


// A tensor map of one (B, H, S, D) bf16 operand with element strides
// st[0..2] (batch, head, row), boxes of 64 columns x `rows` rows.
static int stream_tmap(CUtensorMap* map, const void* x, int B, int H, int S,
                       int D, const long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return make_tmap(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dims, strides,
                   box);
}

template <int D>
int launch_stream(const void* q, const void* k, const void* v,
                  const float* bias, void* o, float* lse, int B, int H,
                  int Sq, int Sk, int stages, int smem, float scale,
                  const long* st, cudaStream_t stream) {
  if (stages != sf_stages<D>() || smem != sf_smem_bytes<D>(stages) ||
      smem + SF_STATIC > SF_SMEM_MAX)
    return HV_BAD_PLAN;
  CUtensorMap tq, tk, tv;
  int rc = stream_tmap(&tq, q, B, H, Sq, D, st, SF_BQ);
  if (!rc) rc = stream_tmap(&tk, k, B, H, Sk, D, st + 3, sf_bk<D>());
  if (!rc) rc = stream_tmap(&tv, v, B, H, Sk, D, st + 6, sf_bk<D>());
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      stream_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + SF_BQ - 1) / SF_BQ, H, B);
  stream_fwd_kernel<D><<<grid, SF_THREADS, smem, stream>>>(
      tq, tk, tv, bias, static_cast<bf16*>(o), lse, H, Sq, Sk, scale, stages,
      st[9], st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace hv

// Plain C entry point. `strides` holds 12 element strides: (batch, head,
// row) for q, k, v and o in that order; the last dimension is contiguous.
// `lse` is a contiguous (B, H, Sq) fp32 buffer. `stages` and `smem` are the
// launch plan of flash_attention.py::_stream_plan. Returns a cudaError_t,
// -1 for an unsupported head dim, -2 for a plan the kernel does not take.
extern "C" int hv_stream_fwd(const void* q, const void* k, const void* v,
                             const float* bias, void* o, float* lse, int B,
                             int H, int Sq, int Sk, int D, int stages,
                             int smem, float scale, const long* strides,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return hv::launch_stream<64>(q, k, v, bias, o, lse, B, H, Sq, Sk, stages, smem, scale, strides, s);
    case 128: return hv::launch_stream<128>(q, k, v, bias, o, lse, B, H, Sq, Sk, stages, smem, scale, strides, s);
    case 256: return hv::launch_stream<256>(q, k, v, bias, o, lse, B, H, Sq, Sk, stages, smem, scale, strides, s);
    case 512: return hv::launch_stream<512>(q, k, v, bias, o, lse, B, H, Sq, Sk, stages, smem, scale, strides, s);
    case 640: return hv::launch_stream<640>(q, k, v, bias, o, lse, B, H, Sq, Sk, stages, smem, scale, strides, s);
    default: return -1;
  }
}

// fp32 entry point: as hv_stream_fwd with fp32 q, k, v and o; `bk` and
// `smem` are the plan of flash_attention.py::_stream_f32_plan.
extern "C" int hv_stream_fwd_f32(const void* q, const void* k, const void* v,
                                 const float* bias, void* o, float* lse,
                                 int B, int H, int Sq, int Sk, int D, int bk,
                                 int smem, float scale, const long* strides,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(o);
  switch (D) {
    case 64: return hv::launch_stream_f32<64>(fq, fk, fv, bias, fo, lse, B, H, Sq, Sk, bk, smem, scale, strides, s);
    case 128: return hv::launch_stream_f32<128>(fq, fk, fv, bias, fo, lse, B, H, Sq, Sk, bk, smem, scale, strides, s);
    case 256: return hv::launch_stream_f32<256>(fq, fk, fv, bias, fo, lse, B, H, Sq, Sk, bk, smem, scale, strides, s);
    case 512: return hv::launch_stream_f32<512>(fq, fk, fv, bias, fo, lse, B, H, Sq, Sk, bk, smem, scale, strides, s);
    case 640: return hv::launch_stream_f32<640>(fq, fk, fv, bias, fo, lse, B, H, Sq, Sk, bk, smem, scale, strides, s);
    default: return -1;
  }
}

extern "C" const char* hv_stream_error_string(int code) {
  if (code == -1) return "unsupported head dim";
  if (code == hv::HV_BAD_PLAN) return "launch plan not taken by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
