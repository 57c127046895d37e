// Fused int8 FFN-up + tanh-GELU + per-token requantise for Hopper (sm_90a).
//
// Replaces hivae_tpu/ops/pallas/quant_ffn.py::_kernel (driven by
// fused_ffn_up_quant): for per-token int8 activations xq (M, K) with fp32
// scales sx (M), per-output-channel int8 weights w (N, K) with fp32 scales
// ws (N) and an fp32 bias b (N),
//   y  = float(xq . w^T) * (sx * ws) + b        int32 accumulate, fp32
//   y  = gelu_tanh(y)                           fp32, precise tanhf
//   sy = max(max_n |y|, 1e-8) / 127             per row, over all N
//   yq = clip(rint(y / sy), -127, 127)          int8, round half to even
// The (M, N) GELU output never reaches device memory: only yq and sy do.
//
// Bound on the H100 SXM: 2*M*K*N int8 operations at 1979 TOP/s against
// M*K + K*N + M*N + 8*M + 8*N bytes at 3.35 TB/s. At K = 1024, N = 4096 and
// the path's M of 4096, 4256 and 8192 that is 0.017, 0.018 and 0.035 ms of
// tensor time against 0.007-0.013 ms of memory time: bound by operations.
// The epilogue has a floor of its own: the precise tanhf, the dequant, the
// GELU's and the requantise's roundings spelled out, are some 30 fp32
// instructions an element (chip_smoke.py counts them in the SASS), M*N
// elements on 132 SMs of 128 lanes: about the tensor time (PERF.md).
//
// Design. The per-row scale is the abs-max over all N GELU outputs of the
// row, so no output can be quantised before its row is finished. A cluster
// of CTAs along N covers the same 64 rows: at N = 4096, 8 CTAs of 64 rows x
// 512 columns. Each CTA runs its GEMM once (2*M*K*N operations in all, one
// pass over K) with two consumer warpgroups, each a wgmma m64n256k32
// s8 x s8 -> s32 (128 accumulator registers a thread) over its 256 columns,
// both operands K-major in 128-byte-swizzled shared memory, fed by a
// QF_STAGES-slot ring of TMA copies completing on mbarriers (64 rows of xq
// and 512 rows of the weight, 128 bytes of K each). The int32 tile becomes
// the fp32 GELU output in the same registers. Each CTA stores its per-row
// partial abs-max into the shared memory of every CTA of the cluster (mapa
// + st.shared::cluster), one cluster barrier (arrive.release /
// wait.acquire) publishes them, and every CTA reduces them locally to the
// row maximum and the scale. A max does not depend on the order it is
// taken in, so the scale is the plain version's bit for bit. The CTA then
// requantises from registers and writes int8, staged through the ring slot
// it has just consumed and stored 16 bytes a lane, and (rank 0) the scale.
// The clusters are persistent: as many as the card holds at once (the
// driver's count) walk the row blocks, and the ring runs on from one row
// block to the next, so the next block's first tiles land during this
// block's epilogue. N wider than 8 CTAs of 512 columns (one portable
// cluster) is taken in `chunks` column chunks a CTA: the row max over all
// of them first, keeping the last in registers, then the earlier chunks
// again (the recompute pass exists only for N > 4096). Columns past N and
// rows past M are masked: no copies and no products for a 128-column
// subtile wholly past N; rows past M or N arrive zero-filled from TMA and
// are never stored. The launch plan (cluster width, chunks, shared bytes)
// comes from ops/kernels/quant_ffn.py::_ffn_plan, which the CPU tests
// check; the C entry point refuses any other.
//
// The dequant and the GELU are spelled out with __fmul_rn/__fadd_rn, so each
// operation rounds as the plain version's separate PyTorch operations do (no
// fused multiply-add), with the precise tanhf: the kernel gives the plain
// version's bits. A one-ulp difference would move a value on a rounding edge
// of the int8 grid by a step, and an int8 network carries such a flip on
// through every later layer's activation grid.
//
// Not done: the epilogue of one row block does not overlap the tensor
// cores of the next (one CTA a SM: 216 KB of ring, 128 accumulators a
// thread, and both warpgroups meet at every job's barrier), and the
// cluster's CTAs each read the shared 64 rows of xq from L2 rather than one
// multicast.
#include "attn_common.cuh"

namespace hv {

constexpr int QF_BM = 64;                 // rows per CTA (one wgmma M)
constexpr int QF_BN = 512;                // columns per CTA and chunk
constexpr int QF_SUB = 128;               // columns of a subtile (N gate)
constexpr int QF_BK = 128;                // contraction bytes per ring job
constexpr int QF_THREADS = 256;           // two consumer warpgroups
constexpr int QF_STAGES = 3;
constexpr int QF_MAX_CLUSTER = 8;         // portable cluster size
constexpr int QF_A_BYTES = QF_BM * QF_BK;             // 8 KB
constexpr int QF_B_BYTES = QF_BN * QF_BK;             // 64 KB
constexpr int QF_SLOT = QF_A_BYTES + QF_B_BYTES;      // multiple of 1024
constexpr int QF_SMEM = 1024 + QF_STAGES * QF_SLOT;   // 222208 bytes
constexpr int QF_STG = 256 + 16;  // row stride of the output staging, bytes

// d (+)= A . B^T for a 64 x N tile, k 32 bytes, int8 operands K-major in
// shared memory (descriptors), int32 accumulation; scale_d = 0 overwrites
// d. Warp w of the warpgroup holds rows 16w.., for each 8-column group j:
// d[4j + 0..1] = (row g, cols 8j + 2t, +1), d[4j + 2..3] = row g + 8.
template <int N>
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[128], uint64_t a,
                                         uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<128>(uint32_t (&d)[128], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(uint32_t (&d)[128], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}


// tanh GELU, 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), one rounded
// operation at a time in the order of quant_ffn.py::gelu_tanh.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner =
      __fmul_rn(0.7978845608028654f, __fadd_rn(x, __fmul_rn(0.044715f, cube)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// gelu(acc * (sx * ws) + b) with the plain version's roundings.
__device__ __forceinline__ float ffn_act(int acc, float sxw, float b) {
  return gelu_tanh(__fadd_rn(__fmul_rn(static_cast<float>(acc), sxw), b));
}

// clip(rint(y / s), -127, 127) as int8, with the IEEE quotient y / s formed
// from r = 1/s correctly rounded (__frcp_rn, once a row): q0 = y r is within
// an ulp of y / s, the remainder y - s q0 is exact in one fma, and
// q0 + r (y - s q0) rounded once is the correctly rounded quotient
// (Markstein's theorem; no step overflows, since |y / s| <= 127, and where
// the remainder underflows |y / s| is far below 1/2 and rounds to 0 either
// way). So it is __fdiv_rn(y, s), the plain version's division, in three
// operations instead of a division an element.
__device__ __forceinline__ int8_t requant(float y, float s, float r) {
  const float q0 = __fmul_rn(y, r);
  const float q = __fmaf_rn(__fmaf_rn(-q0, s, y), r, q0);
  return static_cast<int8_t>(fminf(fmaxf(rintf(q), -127.f), 127.f));
}

// grid (cluster, clusters), cluster (cluster, 1, 1): a persistent cluster
// takes row blocks blockIdx.y, blockIdx.y + gridDim.y, ... of 64 rows; CTA
// rank r of the cluster owns columns [(ch * cluster + r) * 512, + 512) of
// chunk ch. tx and tw: tensor maps of xq (boxes of 64 rows) and w (256
// rows), 128 bytes of K a box, 128-byte swizzled.
__global__ void __launch_bounds__(QF_THREADS, 1)
quant_ffn_up_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw,
                    const float* __restrict__ sx, const float* __restrict__ ws,
                    const float* __restrict__ bias, int8_t* __restrict__ yq,
                    float* __restrict__ sy, int M, int K, int N, int chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t full[QF_STAGES];  // a slot's job has landed
  __shared__ float part[2][QF_BM];  // per-warpgroup row abs-max
  // every cluster CTA's row abs-max, written by its owner, by row-block
  // parity
  __shared__ float cmax[2][QF_MAX_CLUSTER][QF_BM];
  __shared__ float srow[QF_BM];     // the rows' scales
  __shared__ float2 wsb[QF_BN];     // (ws, bias) of this CTA's columns
  unsigned char* ring =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wr = (warp & 3) * 16;  // warpgroup, first row
  const int g = lane >> 2, t = lane & 3;
  const uint32_t rank = cluster_rank();
  const int ncl = gridDim.x;
  const int kcn = K / QF_BK;
  // a row block's chunk computations: 0 .. chunks-1 for the row max (the
  // last one kept), then 0 .. chunks-2 again to store; kcn jobs each
  const int per_rb = (2 * chunks - 1) * kcn;
  const int nrb = (M + QF_BM - 1) / QF_BM;
  const int njobs =
      (nrb - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y * per_rb;
  auto row0_of = [&](int i) {
    return ((int)blockIdx.y + i / per_rb * (int)gridDim.y) * QF_BM;
  };
  auto chunk_of = [&](int s) { return s < chunks ? s : s - chunks; };
  auto col0_of = [&](int ch) { return (ch * ncl + (int)rank) * QF_BN; };
  // valid 128-column subtiles of this CTA's 512 columns in chunk ch
  auto live_subs = [&](int ch) {
    return min(QF_BN / QF_SUB, max(0, (N - col0_of(ch)) / QF_SUB));
  };

  // job i (row block i / per_rb, chunk computation (i % per_rb) / kcn, K
  // bytes (i % kcn) * 128) by TMA into slot i % QF_STAGES, completing on
  // full[i % QF_STAGES]: the 64 rows of xq, and each 256-row half of the
  // weight slice that holds a live subtile (rows past M or N are
  // zero-filled and still counted). The ring runs on across row blocks, so
  // the next block's first tiles land during this block's epilogue.
  auto slot = [&](int i) { return ring + (i % QF_STAGES) * QF_SLOT; };
  auto issue = [&](int i) {
    if (tid != 0 || i >= njobs) return;
    const int ch = chunk_of(i % per_rb / kcn), k0 = (i % kcn) * QF_BK;
    const int halves = (live_subs(ch) + 1) / 2;
    unsigned char* sl = slot(i);
    uint64_t* bar = full + i % QF_STAGES;
    mbar_expect(bar, QF_A_BYTES + halves * (QF_B_BYTES / 2));
    tma_load_2d(sl, &tx, bar, k0, row0_of(i));
    for (int hf = 0; hf < halves; ++hf)
      tma_load_2d(sl + QF_A_BYTES + hf * (QF_B_BYTES / 2), &tw, bar, k0,
                  col0_of(ch) + hf * 256);
  };

  float sx0 = 0.f, sx1 = 0.f, rmax0 = 0.f, rmax1 = 0.f;
  float s0 = 1.f, s1 = 1.f, rs0 = 1.f, rs1 = 1.f;  // row scales, reciprocals
  int wsb_ch = -1;  // the chunk whose ws and bias columns are in wsb
  uint32_t acc[128];

  if (tid == 0) {
    for (int i = 0; i < QF_STAGES; ++i) mbar_init(full + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  for (int i = 0; i < QF_STAGES - 1; ++i) issue(i);
  for (int i = 0; i < njobs; ++i) {
    const int row0 = row0_of(i), within = i % per_rb;
    const int s = within / kcn, kc = within % kcn, ch = chunk_of(s);
    if (within == 0) {
      // a new row block: this thread's rows (wr + g, wr + g + 8)
      const int r0 = row0 + wr + g, r1 = r0 + 8;
      sx0 = r0 < M ? sx[r0] : 0.f;
      sx1 = r1 < M ? sx[r1] : 0.f;
      rmax0 = rmax1 = 0.f;
    }
    mbar_wait(full + i % QF_STAGES, (i / QF_STAGES) & 1);
    __syncthreads();  // job i has landed; job i-1's slot is free
    issue(i + QF_STAGES - 1);
    // this warpgroup's subtiles 2 wg and 2 wg + 1: m64n256, m64n128 or none
    const int subs = min(2, max(0, live_subs(ch) - 2 * wg));
    const unsigned char* sl = slot(i);
    if (subs > 0) {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QF_BK / 32; ++kk) {
        const uint64_t da = desc_sw128(sl + kk * 32);
        const uint64_t db =
            desc_sw128(sl + QF_A_BYTES + wg * 256 * 128 + kk * 32);
        if (subs == 2)
          wgmma_s8<256>(acc, da, db, kc > 0 || kk > 0);
        else
          wgmma_s8<128>(acc, da, db, kc > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();  // the slot is overwritten after the next barrier
      fence_regs(acc);
    }
    if (kc != kcn - 1) continue;

    // the chunk's products are complete: dequant + GELU in place, with the
    // chunk's column scales and biases staged in shared memory once
    if (ch != wsb_ch) {
      __syncthreads();
      for (int c = tid; c < QF_BN; c += QF_THREADS) {
        const int col = col0_of(ch) + c;
        wsb[c] = col < N ? make_float2(ws[col], bias[col])
                         : make_float2(0.f, 0.f);
      }
      __syncthreads();
      wsb_ch = ch;
    }
    const int cbase = wg * 256 + 2 * t;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j < subs * 16) {
        const float2 c0 = wsb[cbase + 8 * j], c1 = wsb[cbase + 8 * j + 1];
        const float2 w2 = make_float2(c0.x, c1.x);
        const float2 b2 = make_float2(c0.y, c1.y);
        uint32_t* a = acc + 4 * j;
        const float y0 = ffn_act((int)a[0], __fmul_rn(sx0, w2.x), b2.x);
        const float y1 = ffn_act((int)a[1], __fmul_rn(sx0, w2.y), b2.y);
        const float y2 = ffn_act((int)a[2], __fmul_rn(sx1, w2.x), b2.x);
        const float y3 = ffn_act((int)a[3], __fmul_rn(sx1, w2.y), b2.y);
        if (s < chunks) {
          rmax0 = fmaxf(rmax0, fmaxf(fabsf(y0), fabsf(y1)));
          rmax1 = fmaxf(rmax1, fmaxf(fabsf(y2), fabsf(y3)));
        }
        a[0] = __float_as_uint(y0);
        a[1] = __float_as_uint(y1);
        a[2] = __float_as_uint(y2);
        a[3] = __float_as_uint(y3);
      }
    }

    if (s == chunks - 1) {
      // the row abs-max: over the quad, the two warpgroups, then the
      // cluster: each CTA stores its rows' maxima into every CTA of the
      // cluster (cmax[parity][rank]), one cluster barrier publishes them,
      // and each CTA reduces them locally. A buffer of one parity is
      // written again two row blocks later, after a barrier that every CTA
      // reaches only once it has read it; after the last barrier no CTA
      // writes into another, so a CTA may then exit.
      rmax0 = quad_max(rmax0);
      rmax1 = quad_max(rmax1);
      if (t == 0) {
        part[wg][wr + g] = rmax0;
        part[wg][wr + g + 8] = rmax1;
      }
      __syncthreads();
      const int par = (i / per_rb) & 1;
      if (tid < QF_BM) {
        const float m = fmaxf(part[0][tid], part[1][tid]);
        for (int p = 0; p < ncl; ++p) st_peer(&cmax[par][rank][tid], p, m);
      }
      cluster_arrive();
      cluster_wait();
      if (tid < QF_BM) {
        float m = 0.f;
        for (int p = 0; p < ncl; ++p) m = fmaxf(m, cmax[par][p][tid]);
        const float sc = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
        srow[tid] = sc;
        if (rank == 0 && row0 + tid < M) sy[row0 + tid] = sc;
      }
      __syncthreads();
      s0 = srow[wr + g];
      s1 = srow[wr + g + 8];
      rs0 = __frcp_rn(s0);
      rs1 = __frcp_rn(s1);
    }
    if (s >= chunks - 1) {
      // requantise, staged a warp at a time (its 16 rows x 256 columns) in
      // the slot this job has just freed, then written 16 bytes a lane
      __syncthreads();  // both warpgroups' products have read the slot
      unsigned char* stg = slot(i) + warp * 16 * QF_STG;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j < subs * 16) {
          const uint32_t* a = acc + 4 * j;
          char2 v0, v1;
          v0.x = requant(__uint_as_float(a[0]), s0, rs0);
          v0.y = requant(__uint_as_float(a[1]), s0, rs0);
          v1.x = requant(__uint_as_float(a[2]), s1, rs1);
          v1.y = requant(__uint_as_float(a[3]), s1, rs1);
          *reinterpret_cast<char2*>(stg + g * QF_STG + 8 * j + 2 * t) = v0;
          *reinterpret_cast<char2*>(stg + (g + 8) * QF_STG + 8 * j + 2 * t) =
              v1;
        }
      }
      __syncwarp();
      uint4 rows[8];
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const int c = lane + 32 * it;
        rows[it] = *reinterpret_cast<const uint4*>(stg + c / 16 * QF_STG +
                                                   c % 16 * 16);
      }
      fence_async_smem();  // the slot's next TMA write follows these reads
      const int cpr = subs * 8;  // 16-byte chunks a row
      int8_t* out = yq + (long)(row0 + wr) * N + col0_of(ch) + wg * 256;
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const int c = lane + 32 * it, r = c / 16, cc = c % 16;
        if (cc < cpr && row0 + wr + r < M)
          *reinterpret_cast<uint4*>(out + (long)r * N + cc * 16) = rows[it];
      }
    }
  }
}

// The launch plan of ops/kernels/quant_ffn.py::_ffn_plan: the cluster
// width, and the column chunks a CTA takes.
__host__ int ffn_cluster(int N) {
  const int c = (N + QF_BN - 1) / QF_BN;
  return c < QF_MAX_CLUSTER ? c : QF_MAX_CLUSTER;
}

__host__ int ffn_chunks(int N) {
  const int c = ffn_cluster(N);
  return (N + QF_BN * c - 1) / (QF_BN * c);
}

}  // namespace hv

// Plain C entry point: xq (M, K) int8, sx (M) fp32, w8 (N, K) int8, ws (N)
// and bias (N) fp32, all contiguous; writes yq (M, N) int8 and sy (M) fp32.
// `cluster`, `chunks` and `smem` are the launch plan of
// ops/kernels/quant_ffn.py::_ffn_plan. Returns a cudaError_t, -1 when K or N
// is not a positive multiple of 128 or M < 1, -2 for a plan the kernel does
// not take.
extern "C" int hv_quant_ffn_up(const void* xq, const void* sx, const void* w8,
                               const void* ws, const void* bias, void* yq,
                               void* sy, int M, int K, int N, int cluster,
                               int chunks, int smem, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % hv::QF_BK || N % hv::QF_SUB) return -1;
  if (cluster != hv::ffn_cluster(N) || chunks != hv::ffn_chunks(N) ||
      smem != hv::QF_SMEM)
    return -2;
  CUtensorMap tx, tw;
  const cuuint64_t kstride[1] = {(cuuint64_t)K};
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t wdims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint32_t xbox[2] = {hv::QF_BK, hv::QF_BM};
  const cuuint32_t wbox[2] = {hv::QF_BK, 256};
  int rc = hv::make_tmap(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, xdims,
                         kstride, xbox);
  if (rc) return rc;
  rc = hv::make_tmap(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w8, wdims,
                     kstride, wbox);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      hv::quant_ffn_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(hv::QF_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // one persistent cluster for each cluster the card holds at once (the
  // driver's count for this kernel, width and shared memory), at most one
  // for each row block
  static int fits[hv::QF_MAX_CLUSTER + 1] = {};  // by width, once a process
  int& fit = fits[cluster];
  if (fit == 0) {
    cfg.gridDim = dim3(cluster, 1, 1);
    err = cudaOccupancyMaxActiveClusters(&fit, hv::quant_ffn_up_kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorLaunchOutOfResources;
  }
  const int nrb = (M + hv::QF_BM - 1) / hv::QF_BM;
  cfg.gridDim = dim3(cluster, nrb < fit ? nrb : fit, 1);
  err = cudaLaunchKernelEx(
      &cfg, hv::quant_ffn_up_kernel, tx, tw, static_cast<const float*>(sx),
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<int8_t*>(yq), static_cast<float*>(sy), M, K, N, chunks);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" const char* hv_quant_ffn_error_string(int code) {
  if (code == -1) return "K and N must be positive multiples of 128, M >= 1";
  if (code == -2) return "launch plan not taken by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
