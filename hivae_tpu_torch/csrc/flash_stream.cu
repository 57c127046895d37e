// Streaming (online-softmax) attention forward with LSE for Hopper
// (sm_90a), bf16 (or fp16, built with -DHV_F16: attn_common.cuh) in and
// out, fp32 log-sum-exp; and, below, its fp32 variant
// (stream_fwd_f32_kernel, hv_stream_fwd_f32) and, past D 640, the wide
// forward (stream_fwd_wide_kernel, bf16, fp16 and fp32: a cluster of CTAs
// along D, attn_wide.cuh).
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
#include "attn_wide.cuh"

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

// tq, tk, tv: tensor maps of q, k and v as (hd, S, H, B) arrays, boxes of
// 64 columns x 64 rows (Q) or sf_bk rows (K, V), 128-byte swizzled; the
// boxes' columns past hd (the head dim, <= D) read zeros.
template <int D>
__global__ void __launch_bounds__(SF_THREADS, 1)
stream_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const float* __restrict__ bias, e16* __restrict__ o,
                  float* __restrict__ lse, int H, int Sq, int Sk, float scale,
                  int stages, int hd, long osb, long osh, long oss) {
  constexpr int DH = D / 2;                  // output columns a warpgroup
  constexpr int NW = DH < 64 ? DH : 64;      // columns a P.V wgmma
  constexpr int NB = DH / NW;                // P.V wgmmas a 16-key chunk
  constexpr int BK = sf_bk<D>(), NC = BK / 16, PLD = BK + 8;
  constexpr int KW = BK / 2;                 // keys a warpgroup scores
  constexpr int CW = KW / 16;                // its 16-key chunks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t full[SF_MAX_STAGES + 1];  // slots' jobs, then Q
  __shared__ __align__(16) e16 Ps[SF_BQ * SF_PLD_MAX];  // bf16(P) of a tile
  __shared__ float xm[2][SF_BQ];  // each warpgroup's row maxima of a tile
                                  // (at the end: its denominators)
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  e16* Qs = reinterpret_cast<e16*>(base);
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
      const e16* Kw = reinterpret_cast<const e16*>(sl + wg * KW * 128);
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
            pack_e16(x[0], x[1]);
        *reinterpret_cast<uint32_t*>(Ps + (rw + g + 8) * PLD + col) =
            pack_e16(x[2], x[3]);
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
  e16* op = o + b * osb + h * osh;
  const int r0 = q0 + rw + g, r1 = r0 + 8;
  const float il0 = __frcp_rn(l0), il1 = __frcp_rn(l1);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int jn = 0; jn < NW / 8; ++jn) {
      const int col = wg * DH + nb * NW + jn * 8 + 2 * t;
      const float* a = acc[nb] + 4 * jn;
      if (col >= hd) continue;
      if (r0 < Sq) store_e16x2(op + (long)r0 * oss + col, a[0], a[1], il0);
      if (r1 < Sq) store_e16x2(op + (long)r1 * oss + col, a[2], a[3], il1);
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
// fp32 for P.V, as hivae_tpu/ops/pallas/flash_attention.py::
// _stream_fwd_kernel computes it for fp32 operands (its p.astype(v.dtype)
// is then the identity). It serves the fp32 SD-VAE (``AutoencoderKL()``
// builds in fp32): the mid-block attention, (B, 1, 1024, 512), of the fp32
// VAE encode, ``cli.vis`` and ``cli.frequency_filter_decode``.
//
// Bounds on the H100 SXM at (16, 1, 1024, 512), 4*B*H*S*S*D = 34.4 GFLOP
// against 134 MB of q, k, v and o: 3 x 34.4 GFLOP at TF32's 494.7 TFLOP/s,
// 0.208 ms, for the three tensor-core products below; 0.513 ms at the 67
// TFLOP/s of fp32 outside the tensor cores (the SIMT kernel this one
// replaced); 0.040 ms for the bytes at 3.35 TB/s. The bound is operations.
//
// Why three TF32 products and not one. TF32 keeps 10 mantissa bits, so one
// product of tf32(q) and tf32(k) misses the fp32 gate (1e-5 against the
// fp32 plain version) by 20x. Each operand x is split in registers into
// hi = tf32(x) (cvt.rna.tf32.f32's rounding: to nearest, ties away) and
// lo = x - hi, and x.y is taken as lo_x.hi_y + hi_x.lo_y + hi_x.hi_y (lo.lo
// is below fp32's rounding). Against fp64, attention over 1024 keys of
// N(0, 1):
//                         D 64     D 512    D 640
//   one TF32 product      2.0e-4   1.7e-4   1.9e-4
//   three (hi/lo split)   6.6e-7   2.6e-7   3.4e-7
//   plain fp32            8.2e-7   3.4e-7   2.9e-7
// flash_attention.py::tf32_matmul models the split on the CPU and
// tests/test_torch_longtail_ops.py holds both rows at D 512. The tensor
// core truncates as it accumulates, so where a long sum would pile that up
// the kernel keeps it short: S's small terms go to their own accumulator,
// and each tile's P.V goes to a fresh one that reaches O by one fp32 FMA
// (which also applies the tile's rescale). On the H100 at (16, 1, 1024,
// 512) the output's error was 5e-6 summed over every tile into O, 1.2e-6
// so kept.
//
// Design (the SIMT kernel was bound by four things; what this one does):
// 1. No tensor cores: both products run as mma.sync m16n8k8 .tf32, three
//    per product. (wgmma at .tf32 takes K-major operands only, and V lands
//    with D contiguous, so it could not be P.V's B operand without a
//    transpose in shared memory.) The split is integer and fp32 arithmetic
//    (the conversion pipe would take 8 cycles a warp instruction), and
//    each product is issued over four or eight independent accumulators
//    before the next into the same one.
// 2. Shared-memory reads per FMA: a warp computes a 32 x BK block of S
//    (two 16-row A fragments of Q, each B fragment of K used for both) and
//    a 32 x D/4 block of O (each V fragment used for both row tiles), with
//    Q and K fragments read by ldmatrix (the .b16 8x8 form, one fp32 per
//    lane: the tf32 A and B layouts).
// 3. Exposed loads: K and V tiles travel as separate jobs (K_j, V_j,
//    K_j+1, ...) through two slots, so each job is in flight while the one
//    before it is computed: V_j under S_j and its softmax, K_j+1 under
//    P_j.V_j. One lane a row hands the tile's rows to the bulk-copy engine
//    (cp.async.bulk on an mbarrier): 3.5% faster on the H100 than cp.async
//    pieces issued by every thread.
// 4. 32 rows a CTA: now 64 (ceil(Sq / 64) x H x B CTAs, 256 at (16, 1,
//    1024, 512), 1.94 waves on 132 SMs), so K and V are read half as often.
//    At 17 frames the 272 CTAs take a third, nearly empty wave.
//
// Layout. 8 warps: warp w takes row half rh = w / 4 (32 rows, two m16
// tiles) and quarter dq = w % 4 of D. For S it sums Q.K^T over its quarter
// of D only; the four partial 32 x BK blocks of a row half meet in shared
// memory (a 128-thread barrier), and warp dq of the half owns 8 of its
// rows: it adds their four partials in a fixed order, keeps their running
// max and denominator, and writes their P and rescale factor back for the
// four warps (a second barrier; each warp doing all 32 rows itself was 8%
// slower on the H100). For O it owns columns [dq D/4, (dq + 1) D/4) of its 32 rows
// (D/4 accumulator registers a thread: 128 at D = 512). The C fragment of
// m16n8 holds keys 2t, 2t+1 of a row and the A fragment of m16n8k8 wants
// k t, t+4, so k index t is taken as key 2t and t+4 as key 2t+1, and V's B
// fragment is read from rows 2t and 2t+1. Tiles sit in shared memory with
// rows D + 4 floats apart: ldmatrix's eight 16-byte rows of Q or K, and
// V's rows 2t, 2t+1 at column g, meet no bank conflict. A key tile holds
// BK keys, 32 to D = 256, 16 at 512 and 8 at 640 (sf32_bk), so that the Q
// tile, two slots, the exchange and P fit one block: 219 KB at D = 512;
// the plan comes from flash_attention.py::_stream_f32_plan, which the CPU
// tests check, and the C entry point refuses any other.
//
// Softmax as the bf16 kernel: t = s * scale + bias, p = 2^((t - m) log2 e),
// so a fully masked row keeps m = -1e30 and averages its keys uniformly;
// keys past Sk are -inf (their K and V rows zeroed) and rows past Sq are
// zero-filled and not stored. No atomics and a fixed order of sums: two
// launches give the same bits.
constexpr int SF32_BQ = 64;        // query rows a CTA
constexpr int SF32_THREADS = 256;  // 2 row halves x 4 quarters of D
constexpr int SF32_STAGES = 2;     // K/V slots

template <int D>
__host__ __device__ constexpr int sf32_bk() {
  return D <= 256 ? 32 : D <= 512 ? 16 : 8;
}

// One slot: a K or V tile of sf32_bk rows, D + 4 floats apart, then the
// tile's fp32 bias row.
template <int D>
__host__ __device__ constexpr int sf32_slot_bytes() {
  return (sf32_bk<D>() * (D + 4) + sf32_bk<D>()) * 4;
}

// Shared bytes: the Q tile, two slots, the exchange of partial scores
// (each thread's sf32_bk fp32 S fragment values), the tile's P and a row
// of rescale factors.
template <int D>
__host__ __device__ constexpr int sf32_smem_bytes() {
  return SF32_BQ * (D + 4) * 4 + SF32_STAGES * sf32_slot_bytes<D>() +
         (SF32_THREADS + SF32_BQ) * sf32_bk<D>() * 4 + SF32_BQ * 4;
}

// The first ROWS rows of an fp32 (S, hd) matrix whose rows are `ss`
// elements apart into a shared tile of D columns, rows D + 4 floats apart,
// rows at or past n and columns at or past hd zero-filled, as this
// thread's share of 16-byte cp.async copies (the caller closes the group).
template <int D, int ROWS>
__device__ __forceinline__ void sf32_load_rows(float* dst, const float* src,
                                               long ss, int n, int hd) {
  constexpr int NC4 = D / 4, LD = D + 4;
  for (int i = threadIdx.x; i < ROWS * NC4; i += SF32_THREADS) {
    const int r = i / NC4, c = i - r * NC4;
    const bool valid = r < n && 4 * c < hd;
    cp_async16(dst + r * LD + 4 * c, src + (valid ? r * ss + 4 * c : 0),
               valid);
  }
}

// `bytes` (a multiple of 16) of contiguous global memory into shared
// memory by the bulk-copy engine, completing on `bar` (one instruction a
// row, where cp.async would take one a 16-byte piece and thread).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void sync_threads(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int D>
__global__ void __launch_bounds__(SF32_THREADS, 1)
stream_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias, float* __restrict__ o,
                      float* __restrict__ lse, int H, int Sq, int Sk,
                      float scale, int hd,
                      long qsb, long qsh, long qss, long ksb, long ksh,
                      long kss, long vsb, long vsh, long vss, long osb,
                      long osh, long oss) {
  constexpr int BQ = SF32_BQ, BK = sf32_bk<D>(), LD = D + 4;
  constexpr int DQ = D / 4;    // columns of a quarter of D
  constexpr int NT = BK / 8;   // 8-key n tiles of S (k steps of P.V)
  constexpr int NO = DQ / 8;   // 8-column n tiles of O (k steps of S) a warp
  constexpr int SLOT = sf32_slot_bytes<D>() / 4;
  static_assert(NO % 2 == 0 && (NO < 4 || NO % 4 == 0),
                "S takes k steps in pairs, P.V n tiles in fours");
  extern __shared__ float4 sf32_smem[];
  float* qs = reinterpret_cast<float*>(sf32_smem);
  float* ring = qs + BQ * LD;
  float* xs = ring + SF32_STAGES * SLOT;  // partial scores, [warp][value][lane]
  float* ps = xs + SF32_THREADS * BK;      // P, [row half][value][lane]
  float* rs = ps + BQ * BK;                // rescale, then l: [warp][row]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rh = warp >> 2, dq = warp & 3;
  const int om = dq >> 1, oh = dq & 1;  // the m tile and half whose rows it owns
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* kp = k + b * ksb + h * ksh;
  const float* vp = v + b * vsb + h * vsh;
  const float* brow = bias ? bias + (long)b * Sk : nullptr;
  const float sl = __fmul_rn(scale, LOG2E);
  const int njobs = 2 * ((Sk + BK - 1) / BK);

  // job 2j: K tile j and its bias row; job 2j + 1: V tile j, into slot
  // i % 2: warp 0 copies the tile's rows (their hd columns) by the
  // bulk-copy engine, one lane a row, completing on the slot's barrier;
  // rows past Sk, and the columns past hd, are zeroed instead, and the bias
  // row travels by cp.async (one group a job, empty without a bias)
  __shared__ uint64_t full[SF32_STAGES];
  auto issue = [&](int i) {
    if (i < njobs) {
      float* dst = ring + (i & 1) * SLOT;
      const int j = i >> 1, rows = min(BK, Sk - j * BK);
      const float* src = (i & 1) ? vp + (long)j * BK * vss
                                 : kp + (long)j * BK * kss;
      const long ss = (i & 1) ? vss : kss;
      if (warp == 0) {
        if (lane == 0) mbar_expect(full + (i & 1), rows * hd * 4);
        __syncwarp();
        if (lane < rows) {
          fence_async_smem();  // the slot's last reads come first
          bulk_load(dst + lane * LD, src + lane * ss, hd * 4, full + (i & 1));
        }
      }
      for (int x = tid; x < (BK - rows) * (D / 4); x += SF32_THREADS)
        reinterpret_cast<float4*>(dst + (rows + x / (D / 4)) * LD)[x % (D / 4)] =
            make_float4(0.f, 0.f, 0.f, 0.f);
      if (hd < D) {
        const int pad = (D - hd) / 4;  // 16-byte chunks past hd a row
        for (int x = tid; x < rows * pad; x += SF32_THREADS)
          reinterpret_cast<float4*>(dst + (x / pad) * LD + hd)[x % pad] =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (brow && !(i & 1))
        load_row_f32<BK, SF32_THREADS>(dst + BK * LD, brow, j * BK, Sk, tid);
    }
    ring_commit();
  };
  if (tid == 0) {
    for (int i = 0; i < SF32_STAGES; ++i) mbar_init(full + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  sf32_load_rows<D, BQ>(qs, q + b * qsb + h * qsh + (long)q0 * qss, qss,
                        Sq - q0, hd);
  issue(0);  // the first cp.async group holds Q too

  float acc[2][NO][4];  // O: [m tile][n tile][C fragment]
  float s[2][NT][4];    // S (its hi.hi terms), then P: [m tile][n tile][C]
  float sc[2][NT][4];   // S's small terms, lo.hi + hi.lo
  float alpha[2][2];  // the tile's rescale of rows [m tile][g, g + 8]
  float m_o = -INFINITY, l_o = 0.f;  // base-2 max, denominator of its rows
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int no = 0; no < NO; ++no)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][no][e] = 0.f;
  }
  // this lane's ldmatrix row: Q rows r + (lane & 7) + 8 ((lane >> 3) & 1),
  // columns c + 4 (lane >> 4); K rows n + (lane & 7), columns c + 4 (lane >> 3)
  const float* qa = qs + (32 * rh + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    dq * DQ + (lane >> 4) * 4;
  const int kb = (lane & 7) * LD + dq * DQ + (lane >> 3) * 4;

  for (int i = 0; i < njobs; ++i) {
    mbar_wait(full + (i & 1), (i >> 1) & 1);  // job i's rows
    ring_wait_upto(0);  // its bias row (and, at the first, Q)
    __syncthreads();    // ... for every thread; job i - 1's slot is free
    issue(i + 1);
    const float* sl_ = ring + (i & 1) * SLOT;
    const int j = i >> 1;
    if (!(i & 1)) {
      // this warp's quarter of S = Q.K^T, two k steps of 8 at a time
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][nt][e] = sc[mt][nt][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < NO; kk += 2) {
        uint32_t ah[2][2][4], al[2][2][4];  // [k step][m tile]
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            uint32_t r[4];
            ldsm_x4(r, reinterpret_cast<const e16*>(
                           qa + mt * 16 * LD + (kk + ks) * 8));
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]),
                                                   ah[ks][mt][e], al[ks][mt][e]);
          }
        // two n tiles at a time, each product over four independent
        // accumulators before the next into the same one
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += 2) {
          constexpr int W = NT < 2 ? NT : 2;
          uint32_t bh[2][W][2], bl[2][W][2];  // [k step][n tile][b0, b1]
#pragma unroll
          for (int nt = 0; nt < W; ++nt) {
            uint32_t r[4];
            ldsm_x4(r, reinterpret_cast<const e16*>(
                           sl_ + (n0 + nt) * 8 * LD + kb + kk * 8));
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split_tf32(__uint_as_float(r[e]), bh[e >> 1][nt][e & 1],
                         bl[e >> 1][nt][e & 1]);
          }
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int term = 0; term < 3; ++term)
#pragma unroll
              for (int nt = 0; nt < W; ++nt)
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                  if (term == 0)
                    mma1688_tf32(sc[mt][n0 + nt], al[ks][mt], bh[ks][nt]);
                  else if (term == 1)
                    mma1688_tf32(sc[mt][n0 + nt], ah[ks][mt], bl[ks][nt]);
                  else
                    mma1688_tf32(s[mt][n0 + nt], ah[ks][mt], bh[ks][nt]);
                }
        }
      }
      // the four quarters of the row half meet in shared memory; warp dq
      // of the row half then owns the softmax of rows 16 (dq / 2) + 8
      // (dq % 2) + g: it adds those rows' four partials in a fixed order,
      // keeps their running max and denominator, and writes their P and
      // rescale factor for all four warps to read back
      float* xw = xs + warp * BK * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) xw[((mt * NT + nt) * 4 + e) * 32] =
                                          s[mt][nt][e] + sc[mt][nt][e];
      sync_threads(1 + rh, 128);
      {
        const float* xr = xs + 4 * rh * BK * 32 + lane;
        const float* bs = sl_ + BK * LD;
        const bool plain = !brow && (j + 1) * BK <= Sk;
        float u[NT][2];
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = ((om * NT + nt) * 4 + 2 * oh + e) * 32;
            float y = ((xr[x] + xr[BK * 32 + x]) + xr[2 * BK * 32 + x]) +
                      xr[3 * BK * 32 + x];
            const int key = nt * 8 + 2 * t + e;
            if (plain)
              y *= sl;
            else
              y = j * BK + key < Sk
                  ? fmaf(y, sl, brow ? __fmul_rn(bs[key], LOG2E) : 0.f)
                  : -INFINITY;
            u[nt][e] = y;
            mx = fmaxf(mx, y);
          }
        mx = quad_max(mx);
        const float m_new = fmaxf(m_o, mx);
        const float a_o = ex2(m_o - m_new);  // 0 at the first tile
        float sum = 0.f;
        float* pw = ps + rh * BK * 32 + lane;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(u[nt][e] - m_new);
            pw[((om * NT + nt) * 4 + 2 * oh + e) * 32] = p;
            sum += p;
          }
        l_o = fmaf(l_o, a_o, quad_sum(sum));
        m_o = m_new;
        if (t == 0) rs[(rh * 4 + dq) * 8 + g] = a_o;
      }
      sync_threads(1 + rh, 128);
      const float* pr = ps + rh * BK * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][nt][e] = pr[((mt * NT + nt) * 4 + e) * 32];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          alpha[mt][hf] = rs[(rh * 4 + 2 * mt + hf) * 8 + g];
      }
    } else {
      // O = O * alpha + P.V over this warp's columns, four n tiles at a
      // time: the tile's product goes into a fresh accumulator and reaches
      // O by one fp32 FMA (the tensor core truncates as it accumulates;
      // summed over every tile into O, that would cost about 10x fp32's
      // error). k index t is key 2t, t + 4 key 2t + 1 of each 8-key step.
      uint32_t ph[NT][2][4], pl[NT][2][4];  // [k step][m tile]
#pragma unroll
      for (int ks = 0; ks < NT; ++ks)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* p = s[mt][ks];
          split_tf32(p[0], ph[ks][mt][0], pl[ks][mt][0]);
          split_tf32(p[2], ph[ks][mt][1], pl[ks][mt][1]);
          split_tf32(p[1], ph[ks][mt][2], pl[ks][mt][2]);
          split_tf32(p[3], ph[ks][mt][3], pl[ks][mt][3]);
        }
      const float* vb = sl_ + 2 * t * LD + dq * DQ + g;
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += 4) {
        constexpr int W = NO < 4 ? NO : 4;
        float tmp[2][W][4];
#pragma unroll
        for (int ks = 0; ks < NT; ++ks) {
          const float* vk = vb + ks * 8 * LD + n0 * 8;
          uint32_t bh[W][2], bl[W][2];
#pragma unroll
          for (int no = 0; no < W; ++no) {
            split_tf32(vk[no * 8], bh[no][0], bl[no][0]);
            split_tf32(vk[LD + no * 8], bh[no][1], bl[no][1]);
          }
#pragma unroll
          for (int term = 0; term < 3; ++term)
#pragma unroll
            for (int no = 0; no < W; ++no)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                const uint32_t* a = term == 0 ? pl[ks][mt] : ph[ks][mt];
                const uint32_t* bb = term == 1 ? bl[no] : bh[no];
                if (ks == 0 && term == 0)
                  mma1688_tf32_z(tmp[mt][no], a, bb);
                else
                  mma1688_tf32(tmp[mt][no], a, bb);
              }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int no = 0; no < W; ++no)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][n0 + no][e] = fmaf(acc[mt][n0 + no][e],
                                         alpha[mt][e >> 1], tmp[mt][no][e]);
      }
    }
  }
  ring_wait_upto(0);
  // each owner's denominators to the warps of its row half
  if (t == 0) rs[(rh * 4 + dq) * 8 + g] = l_o;
  sync_threads(1 + rh, 128);

  float* op = o + b * osb + h * osh;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + 32 * rh + 16 * mt + 8 * hf + g;
      if (row >= Sq) continue;
      const float il = 1.f / rs[(rh * 4 + 2 * mt + hf) * 8 + g];
#pragma unroll
      for (int no = 0; no < NO; ++no) {
        const int col = dq * DQ + no * 8 + 2 * t;
        if (col < hd)
          *reinterpret_cast<float2*>(op + (long)row * oss + col) =
              make_float2(acc[mt][no][2 * hf] * il,
                          acc[mt][no][2 * hf + 1] * il);
      }
    }
  const int row = q0 + 32 * rh + 16 * om + 8 * oh + g;
  if (t == 0 && row < Sq)
    lse[((long)b * H + h) * Sq + row] =
        (m_o + log2f(l_o)) * 0.69314718055994531f;
}

template <int D>
int launch_stream_f32(const float* q, const float* k, const float* v,
                      const float* bias, float* o, float* lse, int B, int H,
                      int Sq, int Sk, int hd, int bk, int smem, float scale,
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
      q, k, v, bias, o, lse, H, Sq, Sk, scale, hd, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

// A tensor map of one (B, H, S, D) e16 operand (D the head dim) with
// element strides st[0..2] (batch, head, row), boxes of 64 columns x `rows`
// rows; a box's columns past D read zeros.
static int stream_tmap(CUtensorMap* map, const void* x, int B, int H, int S,
                       int D, const long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return make_tmap(map, E16_TMAP, 4, x, dims, strides, box);
}

template <int D>
int launch_stream(const void* q, const void* k, const void* v,
                  const float* bias, void* o, float* lse, int B, int H,
                  int Sq, int Sk, int hd, int stages, int smem, float scale,
                  const long* st, cudaStream_t stream) {
  if (stages != sf_stages<D>() || smem != sf_smem_bytes<D>(stages) ||
      smem + SF_STATIC > SF_SMEM_MAX)
    return HV_BAD_PLAN;
  CUtensorMap tq, tk, tv;
  int rc = stream_tmap(&tq, q, B, H, Sq, hd, st, SF_BQ);
  if (!rc) rc = stream_tmap(&tk, k, B, H, Sk, hd, st + 3, sf_bk<D>());
  if (!rc) rc = stream_tmap(&tv, v, B, H, Sk, hd, st + 6, sf_bk<D>());
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      stream_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + SF_BQ - 1) / SF_BQ, H, B);
  stream_fwd_kernel<D><<<grid, SF_THREADS, smem, stream>>>(
      tq, tk, tv, bias, static_cast<e16*>(o), lse, H, Sq, Sk, scale, stages,
      hd, st[9], st[10], st[11]);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dims past 640 (tiles 768 to 2048): stream_fwd_wide_kernel, a cluster
// of tile / 256 CTAs along D (attn_wide.cuh's note), in bf16 (fp16 built
// with -DHV_F16) and fp32. The same function as stream_fwd_kernel: the
// natural-unit logits t = s * scale + bias, p = 2^((t - m) log2 e) with a
// running max m and denominator l (a fully masked row keeps m = -1e30 and
// p = 1 on every key, the uniform average), P rounded to v's dtype for
// P.V, O = acc / l and LSE = m + log(l).
//
// Bound on the H100 SXM at (4, 1, 1024, 1024): 4*B*H*S*S*D = 17.2 GFLOP,
// 17.4 us at 989 TFLOP/s in bf16 (34.7 us at TF32's 494.7, the rate this
// kernel's products run at; three products for fp32: 104 us), against
// 33.6 MB of q, k, v and o (10.0 us at 3.35 TB/s; fp32 20.0 us): bound by
// operations.
//
// A CTA: 64 query rows of its 256 columns. A walked tile holds SW_TILE
// keys of K and V (both, one cp.async group, two slots) and the keys' bias
// row. Per tile: warp w forms the partial scores of m tile w % 4 and keys
// 16 (w / 4).., into this CTA's partial tile; the cluster barrier; each
// thread sums float4s of the partial tiles over the cluster in rank order
// into the summed tile; a CTA barrier; warp w then takes the softmax of
// its 16 rows over the tile's keys (the two warps of an m tile compute the
// same, from the same bits), rescales its O block (its 128 columns) and
// adds P.V. Shared bytes (sw_smem_bytes): Q, two slots, two partial tiles
// and the summed one: 127,232 in bf16 and fp16, 225,536 in fp32.
// ---------------------------------------------------------------------------
constexpr int SW_TILE = 32;  // keys a walked tile

template <typename T>
__host__ __device__ constexpr int sw_slot_elems() {
  return 2 * SW_TILE * wide_ld<T>() + SW_TILE * 4 / (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr int sw_smem_bytes() {
  return (WIDE_ROWS * wide_ld<T>() + 2 * sw_slot_elems<T>()) *
             (int)sizeof(T) +
         (2 * WIDE_ROWS * SW_TILE + WIDE_ROWS * (SW_TILE + 4)) * 4;
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
stream_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       T* __restrict__ o, float* __restrict__ lse, int H,
                       int Sq, int Sk, float scale, int hd, int cl, Rows sq,
                       Rows sk, Rows sv, Rows so) {
  constexpr int LD = wide_ld<T>(), R = WIDE_ROWS, BT = SW_TILE;
  constexpr int BTP = BT + 4, KS = BT / 8, SLOT = sw_slot_elems<T>();
  constexpr int NO = WIDE_OUT_COLS / 8;
  extern __shared__ float4 sw_smem[];
  T* Qs = reinterpret_cast<T*>(sw_smem);
  T* ring = Qs + R * LD;
  float* XP = reinterpret_cast<float*>(ring + 2 * SLOT);  // [2][R][BT]
  float* SS = XP + 2 * R * BT;                            // [R][BTP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3, half = warp >> 2;
  const int c0 = (int)cluster_rank() * WIDE_COLS;
  const int b = blockIdx.z, h = blockIdx.y, q0 = (blockIdx.x / cl) * R;
  const T* kh = head_ptr(k, sk, b, h);
  const T* vh = head_ptr(v, sv, b, h);
  const float* brow = bias ? bias + (long)b * Sk : nullptr;
  const int nkt = (Sk + BT - 1) / BT;

  // tile j into slot j % 2: K, V and the keys' bias (one cp.async group)
  auto issue = [&](int j) {
    T* sl = ring + (j & 1) * SLOT;
    wide_load<T, BT>(sl, kh, sk.s, j * BT, Sk, c0, hd, tid);
    wide_load<T, BT>(sl + BT * LD, vh, sv.s, j * BT, Sk, c0, hd, tid);
    if (brow)
      load_row_f32<BT, WIDE_THREADS>(
          reinterpret_cast<float*>(sl + 2 * BT * LD), brow, j * BT, Sk, tid);
    ring_commit();
  };
  wide_load<T, R>(Qs, head_ptr(q, sq, b, h), sq.s, q0, Sq, c0, hd, tid);
  issue(0);  // the first group holds Q too

  const int r0 = 16 * mt + g, r1 = r0 + 8;  // this thread's rows
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NO][4];  // O of rows r0, r1, columns 128 half + 8 n + 2t, + 1
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    ring_wait_upto(0);
    __syncthreads();  // tile j has landed; tile j - 1's slot is free
    if (j + 1 < nkt) issue(j + 1);
    const T* Ks = ring + (j & 1) * SLOT;
    const T* Vs = Ks + BT * LD;
    const float* bs = reinterpret_cast<const float*>(Ks + 2 * BT * LD);
    float* part = XP + (j & 1) * R * BT;
    {
      float x[2][4];
      wide_scores<T, 2>(x, Qs + 16 * mt * LD, Ks + 16 * half * LD, g, t);
      wide_store_blocks<2>(part + 16 * mt * BT + 16 * half, BT, x, g, t);
    }
    cluster_arrive();
    cluster_wait();  // every CTA's partial scores of tile j are in place
    for (int i = tid; i < R * BT / 4; i += WIDE_THREADS) {
      const float4 s = wide_cluster_sum(part, i, cl);
      *reinterpret_cast<float4*>(SS + (4 * i / BT) * BTP + 4 * i % BT) = s;
    }
    __syncthreads();

    // the softmax of rows r0 and r1 over this lane's keys 8 ks + 2t, + 1
    float u[2][KS][2];
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * ks + 2 * t + e;
        float x0 = -INFINITY, x1 = -INFINITY;
        if (j * BT + key < Sk) {
          const float bb = brow ? bs[key] : 0.f;
          x0 = fmaf(SS[r0 * BTP + key], scale, bb);
          x1 = fmaf(SS[r1 * BTP + key], scale, bb);
        }
        u[0][ks][e] = x0;
        u[1][ks][e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = ex2((m0 - mn0) * LOG2E), a1 = ex2((m1 - mn1) * LOG2E);
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t ph[KS][4], pl[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      float p[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[0][e] = ex2((u[0][ks][e] - mn0) * LOG2E);
        p[1][e] = ex2((u[1][ks][e] - mn1) * LOG2E);
        sum0 += p[0][e];
        sum1 += p[1][e];
      }
      // k permuted: index t is key 8 ks + 2t, t + 4 key 8 ks + 2t + 1
      wide_split<T>(wide_round<T>(p[0][0]), ph[ks][0], pl[ks][0]);
      wide_split<T>(wide_round<T>(p[1][0]), ph[ks][1], pl[ks][1]);
      wide_split<T>(wide_round<T>(p[0][1]), ph[ks][2], pl[ks][2]);
      wide_split<T>(wide_round<T>(p[1][1]), ph[ks][3], pl[ks][3]);
    }
    l0 = l0 * a0 + quad_sum(sum0);
    l1 = l1 * a1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
    // O = O * a + P.V over this warp's 128 columns
    wide_grad<T, NO, KS>(acc, ph, pl, Vs + WIDE_OUT_COLS * half, a0, a1, g,
                         t);
  }
  ring_wait_upto(0);
  cluster_arrive();
  cluster_wait();  // no CTA leaves while a peer may read its partials

  T* op = head_ptr(o, so, b, h);
  const int gr0 = q0 + r0, gr1 = q0 + r1;
  const float il0 = 1.f / l0, il1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = c0 + WIDE_OUT_COLS * half + 8 * n + 2 * t;
    if (col >= hd) continue;
    if (gr0 < Sq)
      wide_store2(op + (long)gr0 * so.s + col, acc[n][0] * il0,
                  acc[n][1] * il0);
    if (gr1 < Sq)
      wide_store2(op + (long)gr1 * so.s + col, acc[n][2] * il1,
                  acc[n][3] * il1);
  }
  if (c0 == 0 && half == 0 && t == 0) {
    float* lp = lse + ((long)b * H + h) * Sq;
    if (gr0 < Sq) lp[gr0] = m0 + logf(l0);
    if (gr1 < Sq) lp[gr1] = m1 + logf(l1);
  }
}

// Takes only the plan flash_attention.py::_stream_plan (bf16, fp16) or
// _stream_f32_plan (fp32) returns at a wide tile: `walk` is the plan's
// slots (16-bit) or keys a tile (fp32), as at the narrow tiles.
template <typename T>
int launch_stream_wide(const void* q, const void* k, const void* v,
                       const float* bias, void* o, float* lse, int B, int H,
                       int Sq, int Sk, int hd, int tile, int walk, int smem,
                       float scale, const long* st, cudaStream_t stream) {
  if (walk != (sizeof(T) == 4 ? SW_TILE : 2) || smem != sw_smem_bytes<T>() ||
      smem > SF_SMEM_MAX)
    return HV_BAD_PLAN;
  const int cl = wide_cluster(tile);
  return wide_launch(stream_fwd_wide_kernel<T>, (Sq + WIDE_ROWS - 1) / WIDE_ROWS,
                     cl, H, B, smem, stream, static_cast<const T*>(q),
                     static_cast<const T*>(k), static_cast<const T*>(v), bias,
                     static_cast<T*>(o), lse, H, Sq, Sk, scale, hd, cl,
                     Rows{st[0], st[1], st[2]}, Rows{st[3], st[4], st[5]},
                     Rows{st[6], st[7], st[8]}, Rows{st[9], st[10], st[11]});
}

}  // namespace hv

// Plain C entry point. `strides` holds 12 element strides: (batch, head,
// row) for q, k, v and o in that order; the last dimension is contiguous.
// D is the head dim, any multiple of 8 up to 2048: the kernel runs the tile
// width hv::stream_tile(D) (64, 128, 256, 512 or 640, or past 640 a
// multiple of 256 up to 2048 on the wide kernel; columns past D read as
// zeros, never stored). `lse` is a contiguous (B, H, Sq) fp32 buffer.
// `stages` and `smem` are the launch plan of
// flash_attention.py::_stream_plan at the tile width. Returns a
// cudaError_t, -1 for an unsupported head dim, -2 for a plan the kernel
// does not take. Built with -DHV_F16, q, k, v and o are fp16 and the fp32
// entry point is left out.
extern "C" int hv_stream_fwd(const void* q, const void* k, const void* v,
                             const float* bias, void* o, float* lse, int B,
                             int H, int Sq, int Sk, int D, int stages,
                             int smem, float scale, const long* strides,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hv::stream_tile(D)) {
    case 64: return hv::launch_stream<64>(q, k, v, bias, o, lse, B, H, Sq, Sk, D, stages, smem, scale, strides, s);
    case 128: return hv::launch_stream<128>(q, k, v, bias, o, lse, B, H, Sq, Sk, D, stages, smem, scale, strides, s);
    case 256: return hv::launch_stream<256>(q, k, v, bias, o, lse, B, H, Sq, Sk, D, stages, smem, scale, strides, s);
    case 512: return hv::launch_stream<512>(q, k, v, bias, o, lse, B, H, Sq, Sk, D, stages, smem, scale, strides, s);
    case 640: return hv::launch_stream<640>(q, k, v, bias, o, lse, B, H, Sq, Sk, D, stages, smem, scale, strides, s);
    case -1: return -1;
    default: return hv::launch_stream_wide<hv::e16>(q, k, v, bias, o, lse, B, H, Sq, Sk, D, hv::stream_tile(D), stages, smem, scale, strides, s);
  }
}

#ifndef HV_F16
// fp32 entry point: as hv_stream_fwd with fp32 q, k, v and o; `bk` and
// `smem` are the plan of flash_attention.py::_stream_f32_plan at the tile
// width.
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
  switch (hv::stream_tile(D)) {
    case 64: return hv::launch_stream_f32<64>(fq, fk, fv, bias, fo, lse, B, H, Sq, Sk, D, bk, smem, scale, strides, s);
    case 128: return hv::launch_stream_f32<128>(fq, fk, fv, bias, fo, lse, B, H, Sq, Sk, D, bk, smem, scale, strides, s);
    case 256: return hv::launch_stream_f32<256>(fq, fk, fv, bias, fo, lse, B, H, Sq, Sk, D, bk, smem, scale, strides, s);
    case 512: return hv::launch_stream_f32<512>(fq, fk, fv, bias, fo, lse, B, H, Sq, Sk, D, bk, smem, scale, strides, s);
    case 640: return hv::launch_stream_f32<640>(fq, fk, fv, bias, fo, lse, B, H, Sq, Sk, D, bk, smem, scale, strides, s);
    case -1: return -1;
    default: return hv::launch_stream_wide<float>(q, k, v, bias, o, lse, B, H, Sq, Sk, D, hv::stream_tile(D), bk, smem, scale, strides, s);
  }
}
#endif

extern "C" const char* hv_stream_error_string(int code) {
  if (code == -1) return "unsupported head dim";
  if (code == hv::HV_BAD_PLAN) return "launch plan not taken by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
