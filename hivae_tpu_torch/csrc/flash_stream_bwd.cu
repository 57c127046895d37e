// Streaming attention backward for Hopper (sm_90a): a kernel for dQ, one
// for dK and dV, and a pre-pass for delta = rowsum(dO * O), bf16 (or
// fp16, built with -DHV_F16: attn_common.cuh) in and out, fp32
// accumulation, from the forward's natural-log LSE (FlashAttention-2).
//
// Replaces hivae_tpu/ops/pallas/flash_attention.py::_stream_dq_kernel and
// ::_stream_dkv_kernel (driven by stream_bwd): P = exp(s - lse);
// dP = dO . V^T; dS = P * (dP - delta); dQ = bf16(dS) . K * scale over KV
// tiles; dV = bf16(P)^T . dO and dK = bf16(dS)^T . Q * scale over query
// tiles. The JAX package computes delta in XLA; here stream_delta_kernel
// reads dO and O once (8 lanes a row, 16-byte loads). Past D 640 dQ and
// dK/dV run stream_bwd_wide_kernel (bf16, fp16 and fp32: a cluster of CTAs
// along D, attn_wide.cuh), below the fp32 variant.
//
// Bound on the H100 SXM at the training shape (16, 1, 1024, 512), the
// SD-VAE decoder's mid-block inside the perceptual loss: dQ does
// 6*B*H*S^2*D = 51.5 GFLOP (0.052 ms at 989 TFLOP/s) over 4 bf16 tensors
// plus LSE and delta (0.020 ms at 3.35 TB/s); dK/dV does 8*B*H*S^2*D =
// 68.7 GFLOP (0.069 ms) over 6 tensors (0.030 ms). Both are bound by
// operations.
//
// What the design has to meet. A CTA owns a block of keys (dK/dV) or
// query rows (dQ) and walks 64-row tiles of the other side; wgmma takes 64
// rows a warpgroup. At D = 512 the dK and dV accumulators of 64 keys are
// 2 x 64 x 512 x 4 B = 256 KB, the whole register file of an SM (65,536 x
// 4 B); for dQ, the resident Q and dO (128 KB) and one K and one V tile
// (128 KB) pass the 227 KB of shared memory a block. So at D = 512 both
// kernels run as a cluster of 2 CTAs along D: CTA rank r owns columns
// [256 r, 256 r + 256) of every operand and output, and reads only those
// (the split adds no load). Each forms partial products S = Q.K^T and
// dP = dO.V^T over its half; the two 64 x 64 fp32 partials are exchanged
// through distributed shared memory (each thread's fragments as 16-byte
// chunks into the peer's tile at its mapa address) and each CTA adds the
// peer's partial to its own. IEEE addition commutes, so both CTAs hold
// bit-identical S and dP with no recomputation, and every gradient element
// is still written by one CTA in a fixed order (no atomics: two runs give
// the same bits). Two mbarriers a CTA carry the hand-off: `landed`
// completes when the peer's partials are here, stored by st.async, whose
// bytes the mbarrier counts as it counts a TMA copy's (complete_tx), so no
// thread waits on its remote stores; `freed` when each of the peer's
// threads has arrived (release at cluster scope) after reading what this
// CTA stored there, which the next tile's partial overwrites (the tile is
// single-buffered). Other versions, each timed in its own run against the
// parent: plain remote stores with barrier.cluster took 1.11x (dQ) and
// 1.16x (dK/dV) this one's time; the same with per-thread mbarrier arrivals
// 1.09x and 1.08x; `freed` arrived per warp as soon as P is read 1.07x and
// 1.06x. With the exchange compiled out (wrong values, the same work
// otherwise) the barrier.cluster version took 0.46x and 0.80x its own
// time; the per-thread-arrival version with only its waits compiled out
// 0.94x and 0.94x: the remote stores held the threads, and st.async takes
// them off.
//
// Two shapes of CTA (sb_split):
//   * D = 256 and 512: 64 keys or rows a CTA and roles for its two
//     warpgroups. WG0 forms the score tile and P, writes P as fp32 to a
//     shared 64 x 64 tile (at D = 512 over the summed exchange tile), WG1
//     forms dP, reads P and forms dS. dK/dV CTA: WG0 computes S^T = K.Q^T
//     and dV += bf16(P^T) . dO, WG1 dP^T = V.dO^T and dK += bf16(dS^T) . Q,
//     each with its accumulator of 64 x 256 (128 registers a thread). dQ
//     CTA: WG0 computes S = Q.K^T, WG1 dP = dO.V^T and dQ += bf16(dS) . K
//     (handing dS through shared memory to both warpgroups for half the
//     columns each, or both forming dS from shared P and dP tiles,
//     measured 6-8% slower). A 64 x 256 accumulator is
//     all a warpgroup's registers can hold beside the score tile, so 64
//     rows do not split over two warpgroups' products.
//   * D = 64 and 128: 128 keys or rows a CTA, 64 a warpgroup; each
//     warpgroup forms S, dP, P and dS of its own rows in registers and runs
//     every product itself (dK and dV of 64 keys at D = 128: 64 KB), with
//     no hand-off. The walked tile serves twice the rows; at D = 64 and
//     128 the version with roles took 1.3-2.5x as long.
// Both shapes share the ring (SbRing), the resident loads (sb_load_pair),
// the gradient products (sb_grad) and the bf16 store (sb_store).
// Products: S and dP on wgmma from shared memory (both operands 128-byte
// swizzled, K-major); P^T, dS^T or dS as the register A operand of the
// gradient products, whose B tile (dO, Q or K) is read MN-major from the
// same swizzled tile.
// Loads: K and V (dK/dV) or Q and dO (dQ) are resident; the walked tiles
// travel by TMA into a ring of SB_STAGES slots completed on mbarriers (the
// next tile lands while one computes), with the per-tile fp32 rows (lse and
// delta, or the key bias) by cp.async beside them.
//
// D = 640 (the CNN motion AE's MapConv): the same cluster of 2, 320
// columns a CTA (160 accumulator registers a thread). A 64-row walked tile
// of 320 columns is 40 KB, so two resident tiles, two slots of two and the
// exchange tiles would pass 227 KB; there the walked tile holds 32 rows
// (sb_tile): S and dP are 64 x 32 (m64n32), the exchange tiles 64 x 32
// fp32, and each gradient product runs 2 chunks of 16 rows: 177 KB.
//
// Shared memory at D = 512 (per CTA, D/2 = 256 columns): two resident
// 64 x 256 bf16 tiles (64 KB), 2 slots of two tiles (128 KB), two 64 x 64
// fp32 exchange tiles (32 KB; P is written over the score tile once it is
// summed) and 1 KB of alignment: 225 KB, one CTA a SM. The launch plan
// (rows, cluster, columns, slots, bytes) is
// flash_attention.py::_stream_bwd_plan, which the CPU tests check; the C
// entry points refuse any other.
//
// Masks: a key past Sk or a query row past Sq gets P = 0 (TMA zero-fills
// its tile rows; nothing is stored for it). A key masked by the -1e30 bias
// has P = exp(-1e30 - lse) = 0 wherever its row attends to any real key, so
// a fully masked key block gets no gradient. A row with no real key has
// P = exp(s - lse) = 1 on every key, as the TPU streaming kernels have (its
// lse has lost the log-denominator), or, where the caller asks for the
// full-block rule (SbArgs::keyless, stream_p), the full-block softmax's
// 1 / Sk.
#include "attn_f32.cuh"
#include "attn_wide.cuh"

namespace hv {

constexpr int SB_ROWS = 64;        // keys or query rows of a CTA with roles
constexpr int SB_TILE_MAX = 64;    // rows of a walked tile, at most
constexpr int SB_THREADS = 256;    // two consumer warpgroups
constexpr int SB_STAGES = 2;       // ring slots
constexpr int SB_SMEM_MAX = 232448;
constexpr int HV_BAD_PLAN = -2;

template <int D>
__host__ __device__ constexpr int sb_cluster() { return D >= 512 ? 2 : 1; }

template <int D>
__host__ __device__ constexpr int sb_cols() { return D / sb_cluster<D>(); }

// Rows of a walked tile: 64, or 32 past D = 512.
template <int D>
__host__ __device__ constexpr int sb_tile() { return D > 512 ? 32 : 64; }

// One 128-byte-swizzled walked tile of this CTA's columns.
template <int D>
__host__ __device__ constexpr int sb_tile_bytes() {
  return sw128_bytes<sb_cols<D>(), sb_tile<D>()>();
}

// At D <= 128 a CTA takes 128 rows, 64 a warpgroup, and each warpgroup
// forms its own rows' S, dP, P and dS (no hand-off); at D >= 256, 64 rows
// shared by the two warpgroups' roles.
template <int D>
__host__ __device__ constexpr bool sb_split() { return D >= 256; }

template <int D>
__host__ __device__ constexpr int sb_rows() { return sb_split<D>() ? 64 : 128; }

// Dynamic shared bytes from a 1024-byte aligned base (both kernels): 2
// resident tiles of sb_rows rows, SB_STAGES slots of 2 walked tiles, and
// with the roles one fp32 64 x sb_tile tile a cluster CTA.
template <int D>
__host__ __device__ constexpr int sb_smem_bytes() {
  return 1024 + 2 * sw128_bytes<sb_cols<D>(), sb_rows<D>()>() +
         2 * SB_STAGES * sb_tile_bytes<D>() +
         (sb_split<D>() ? sb_cluster<D>() * SB_ROWS * sb_tile<D>() * 4 : 0);
}

// A warpgroup's 64 x T fp32 C fragments in shared memory, by thread: the
// T / 2 values of warpgroup thread lt (0..127) at lt * T / 2, as T / 8
// chunks of 4 (chunk k: rows g and g + 8 of columns 8k + 2t, +1), chunk k
// at slot k ^ (lt % 8) (T = 64) or k ^ (lt / 2 % 4) (T = 32), so the 8
// threads of a 16-byte access phase touch distinct banks. The same thread
// of either warpgroup finds its own positions.
template <int T>
__device__ __forceinline__ int frag_off(int lt, int k) {
  const int sw = T == 64 ? (lt & 7) : ((lt >> 1) & 3);
  return lt * (T / 2) + ((k ^ sw) << 2);
}

template <int T>
__device__ __forceinline__ void store_frag(float* tile, int lt,
                                           const float (&x)[32]) {
#pragma unroll
  for (int k = 0; k < T / 8; ++k)
    *reinterpret_cast<float4*>(tile + frag_off<T>(lt, k)) =
        make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
}

template <int T>
__device__ __forceinline__ float4 load_chunk(const float* tile, int lt,
                                             int k) {
  return *reinterpret_cast<const float4*>(tile + frag_off<T>(lt, k));
}

struct SbArgs {
  const float *bias, *lse, *delta;
  e16 *dq, *dk, *dv;
  Rows sdq, sdk, sdv;
  int H, Sq, Sk;
  int hd;  // the head dim (<= the tile's D)
  float scale;
  float keyless;  // stream_p's: 0, or 1 / Sk (the full-block rule)
};

// The exchange of a 2-CTA cluster: this CTA's fp32 tiles (tile 0 of S,
// tile 1 of dP), two mbarriers, and their peers' addresses. `landed`
// completes when the peer's partials (64 x T x 4 B each, st.async with
// complete_tx)
// have arrived here, `freed` (256 arrivals) when the peer's threads have
// read what this CTA stored there.
struct Xch {
  uint64_t* landed;
  uint64_t* freed;
  uint32_t peer_tile, peer_landed, peer_freed;
};

// Tile j: this thread's partial x (its warpgroup's 64 x T fp32 C
// fragments) into the peer's tile at its own positions (frag_off), once
// the peer has read the previous one; then, once the peer's partials have
// landed here, x += the peer's. Both CTAs add the same two numbers.
template <int T>
__device__ __forceinline__ void exchange_add(float (&x)[32], const float* mine,
                                             const Xch& e, int tid, int j) {
  constexpr int XBYTES = 2 * 64 * T * 4;  // both partials of a tile
  const int lt = tid & 127;
  if (tid == 0) mbar_expect(e.landed, XBYTES);  // this tile's phase
  if (j > 0) mbar_wait_cluster(e.freed, (j - 1) & 1);
#pragma unroll
  for (int k = 0; k < T / 8; ++k)
    st_async_v4(e.peer_tile + 4 * frag_off<T>(lt, k), x + 4 * k,
                e.peer_landed);
  mbar_wait_cluster(e.landed, j & 1);
#pragma unroll
  for (int k = 0; k < T / 8; ++k) {
    const float4 a = load_chunk<T>(mine, lt, k);
    x[4 * k] += a.x;
    x[4 * k + 1] += a.y;
    x[4 * k + 2] += a.z;
    x[4 * k + 3] += a.w;
  }
}

// The dynamic shared memory from its first 1024-byte boundary (the
// 128-byte swizzle repeats every 1024 bytes).
__device__ __forceinline__ unsigned char* sb_base(unsigned char* smem_raw) {
  return smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
}

// The mbarriers of a CTA: full[0, SB_STAGES) the ring's slots,
// full[SB_STAGES] the resident tiles; with a cluster (xbar not null) the
// exchange's `landed` (one arrival plus the peer's bytes) and `freed`
// (SB_THREADS arrivals).
__device__ __forceinline__ void sb_init(uint64_t* full, uint64_t* xbar,
                                        int tid) {
  if (tid == 0) {
    for (int i = 0; i <= SB_STAGES; ++i) mbar_init(full + i, 1);
    if (xbar) {
      mbar_init(xbar, 1);
      mbar_init(xbar + 1, SB_THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// Rows [r0, r0 + ROWS) and this CTA's DC columns from c0 of the tensor maps
// m0 and m1 into two swizzled ROWS-row tiles at dst and right after it, by
// TMA completing on bar, boxes of min(ROWS, 64) rows (thread 0 only): the
// resident tiles (ROWS = sb_rows) or one ring job (ROWS = sb_tile).
template <int DC, int ROWS>
__device__ __forceinline__ void sb_load_pair(unsigned char* dst,
                                             const CUtensorMap* m0,
                                             const CUtensorMap* m1,
                                             uint64_t* bar, int c0, int r0,
                                             int h, int b) {
  constexpr int TB = sw128_bytes<DC, ROWS>();
  constexpr int BOX = ROWS < 64 ? ROWS : 64;
  mbar_expect(bar, 2 * TB);
#pragma unroll
  for (int c = 0; c < DC / 64; ++c)
#pragma unroll
    for (int part = 0; part < ROWS / BOX; ++part) {
      const int off = c * ROWS * 128 + part * BOX * 128;
      tma_load_4d(dst + off, m0, bar, c0 + c * 64, r0 + BOX * part, h, b);
      tma_load_4d(dst + TB + off, m1, bar, c0 + c * 64, r0 + BOX * part, h,
                  b);
    }
}

// The walked side of a CTA: a ring of SB_STAGES slots, each two T-row
// tiles (of maps m0 and m1, this CTA's DC columns from c0) that travel by
// TMA onto full[slot], with up to two fp32 rows (src0, src1, n long; null
// for none) that travel by cp.async into rows[slot] beside them.
template <int DC, int T>
struct SbRing {
  static constexpr int TB = sw128_bytes<DC, T>();
  unsigned char* slots;
  uint64_t* full;
  float (*rows)[2][SB_TILE_MAX];
  const CUtensorMap *m0, *m1;
  const float *src0, *src1;
  int jobs, n, c0, h, b;

  __device__ unsigned char* slot(int i) const {
    return slots + (i % SB_STAGES) * 2 * TB;
  }
  // Job i, one cp.async commit group (an empty one past the last job keeps
  // the count).
  __device__ void issue(int i, int tid) const {
    if (i < jobs) {
      const int st = i % SB_STAGES;
      if (tid == 0)
        sb_load_pair<DC, T>(slot(i), m0, m1, full + st, c0, i * T, h, b);
      if (src0)
        load_row_f32<T, SB_THREADS>(rows[st][0], src0, i * T, n, tid);
      if (src1)
        load_row_f32<T, SB_THREADS>(rows[st][1], src1, i * T, n, tid);
    }
    ring_commit();
  }
  __device__ void start(int tid) const {
    for (int i = 0; i < SB_STAGES - 1; ++i) issue(i, tid);
  }
  // Waits for job i (its tiles, and this thread's share of its rows), then,
  // with job i-1's slot free behind a CTA barrier, issues job
  // i + SB_STAGES - 1; returns job i's slot.
  __device__ const unsigned char* next(int i, int tid) const {
    ring_wait_upto(SB_STAGES - 2);
    mbar_wait(full + i % SB_STAGES, (i / SB_STAGES) & 1);
    __syncthreads();
    issue(i + SB_STAGES - 1, tid);
    return slot(i);
  }
};

template <int NB>
__device__ __forceinline__ void zero_acc(float (&acc)[NB][32]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[nb][e] = 0.f;
}

template <int NB>
__device__ __forceinline__ void fence_acc(float (&acc)[NB][32]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
}

// A warpgroup's 64 x 16 NC fp32 C tile x as the register A operand of a
// gradient product: NC chunks of 16 columns in bf16.
template <int NC>
__device__ __forceinline__ void sb_frags(uint32_t (&fr)[NC][4],
                                         const float (&x)[32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) c_to_a(fr[c], x + 8 * c, x + 8 * c + 4);
}

// acc += bf16(x) . B issued on wgmma, B the walked 16 NC-row tile at Bt
// read MN-major: its 64-column block nb, 16-row chunk c at nb * 16 NC rows
// * 128 + c * 2048. The caller fences, commits and waits.
template <int NB, int NC>
__device__ __forceinline__ void sb_grad_issue(float (&acc)[NB][32],
                                              const uint32_t (&fr)[NC][4],
                                              const unsigned char* Bt) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      wgmma_rs64(acc[nb], fr[c],
                 desc_sw128_mn(Bt + nb * 16 * NC * 128 + c * 2048,
                               16 * NC * 128));
}

// acc += bf16(x) . B (sb_grad_issue) over the T rows of the walked tile,
// waited for: the slot holding B is overwritten after the next CTA
// barrier.
template <int T, int NB>
__device__ __forceinline__ void sb_grad(float (&acc)[NB][32],
                                        const float (&x)[32],
                                        const unsigned char* Bt) {
  uint32_t fr[T / 16][4];
  sb_frags(fr, x);
  fence_acc(acc);
  wgmma_fence();
  sb_grad_issue(acc, fr, Bt);
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(acc);
#pragma unroll
  for (int c = 0; c < T / 16; ++c) fence_regs(fr[c]);
}

// A warpgroup's NB 64-column blocks of fp32 accumulators times sc, as e16
// into p (rows rs elements apart) from column c0: its rows r0 and r1 (those
// of this thread's fragments), each where v0 or v1, and the columns below
// the head dim hd.
template <int NB>
__device__ __forceinline__ void sb_store(e16* p, long rs,
                                         const float (&acc)[NB][32], int r0,
                                         bool v0, int r1, bool v1, int c0,
                                         int t, float sc, int hd) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int col = c0 + nb * 64 + jn * 8 + 2 * t;
      const float* x = acc[nb] + 4 * jn;
      if (col >= hd) continue;
      if (v0) store_e16x2(p + (long)r0 * rs + col, x[0], x[1], sc);
      if (v1) store_e16x2(p + (long)r1 * rs + col, x[2], x[3], sc);
    }
}

// The tensor maps: q, k, v and dout as (D, S, H, B) arrays, boxes of 64
// columns x 64 rows (the resident side) or sb_tile rows (the walked side),
// 128-byte swizzled.
template <int D>
__global__ void __launch_bounds__(SB_THREADS, 1)
stream_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const SbArgs a) {
  constexpr int CL = sb_cluster<D>(), DC = sb_cols<D>(), NB = DC / 64;
  constexpr int T = sb_tile<D>(), TB = sb_tile_bytes<D>();
  constexpr int RB = sw128_bytes<DC, SB_ROWS>();  // a resident tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t full[SB_STAGES + 1];  // slots' jobs, then K and V
  __shared__ uint64_t xbar[2];  // the exchange's landed and freed
  __shared__ float rows[SB_STAGES][2][SB_TILE_MAX];  // lse, delta of a slot
  unsigned char* base = sb_base(smem_raw);
  const e16* Ks = reinterpret_cast<const e16*>(base);
  const e16* Vs = reinterpret_cast<const e16*>(base + RB);
  // tile 0: S^T (the peer's partial, then P^T); tile 1 (cluster): dP^T
  float* X = reinterpret_cast<float*>(base + 2 * RB + 2 * SB_STAGES * TB);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, rw = (warp & 3) * 16;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t rank = CL > 1 ? cluster_rank() : 0;
  const int b = blockIdx.z, h = blockIdx.y, k0 = (blockIdx.x / CL) * SB_ROWS;
  const int c0 = rank * DC;  // first column of this CTA's slice of D
  const long rb = ((long)b * a.H + h) * a.Sq;
  const int nqt = (a.Sq + T - 1) / T;
  float* mine = X + (CL > 1 ? wg : 0) * SB_ROWS * T;
  Xch xch{xbar, xbar + 1, 0, 0, 0};
  if constexpr (CL > 1)
    xch = Xch{xbar, xbar + 1, peer_addr(mine, rank ^ 1),
              peer_addr(xbar, rank ^ 1), peer_addr(xbar + 1, rank ^ 1)};
  // job i: Q and dO tile i and their lse and delta rows
  const SbRing<DC, T> ring{base + 2 * RB, full, rows, &tq, &tdo, a.lse + rb,
                           a.delta + rb, nqt, a.Sq, c0, h, b};

  sb_init(full, CL > 1 ? xbar : nullptr, tid);
  if (tid == 0)
    sb_load_pair<DC, SB_ROWS>(base, &tk, &tv, full + SB_STAGES, c0, k0, h, b);
  ring.start(tid);
  if constexpr (CL > 1) {  // the peer runs and its mbarriers are set up
    cluster_arrive();
    cluster_wait();
  }
  const int kr0 = k0 + rw + g, kr1 = kr0 + 8;
  const bool kv0 = kr0 < a.Sk, kv1 = kr1 < a.Sk;
  const float* brow = a.bias ? a.bias + (long)b * a.Sk : nullptr;
  const float bk0 = brow && kv0 ? brow[kr0] : 0.f;
  const float bk1 = brow && kv1 ? brow[kr1] : 0.f;
  mbar_wait(full + SB_STAGES, 0);

  float acc[NB][32];  // WG0: dV, WG1: dK (this CTA's columns)
  zero_acc(acc);

  for (int i = 0; i < nqt; ++i) {
    const int st = i % SB_STAGES;
    const unsigned char* sl = ring.next(i, tid);
    const e16* Qt = reinterpret_cast<const e16*>(sl);
    const e16* Ot = reinterpret_cast<const e16*>(sl + TB);

    // WG0: S^T = K.Q^T; WG1: dP^T = V.dO^T (rows keys, columns queries)
    float x[32];
    if (wg == 0)
      wgmma_qk<DC, T, SB_ROWS, T>(x, Ks, 0, Qt);
    else
      wgmma_qk<DC, T, SB_ROWS, T>(x, Vs, 0, Ot);
    if constexpr (CL > 1) exchange_add<T>(x, mine, xch, tid, i);

    const float* lse = rows[st][0];
    const float* dlt = rows[st][1];
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 8 * j + 2 * t + e;
          const bool qv = i * T + qc < a.Sq;
          x[4 * j + e] = qv && kv0 ? stream_p(x[4 * j + e], a.scale, bk0,
                                              lse[qc], a.keyless)
                                   : 0.f;
          x[4 * j + 2 + e] = qv && kv1
                                 ? stream_p(x[4 * j + 2 + e], a.scale, bk1,
                                            lse[qc], a.keyless)
                                 : 0.f;
        }
      }
      store_frag<T>(X, tid & 127, x);
    }
    __syncthreads();  // P^T is in tile 0
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
        const int qc = 8 * j + 2 * t;
        const float4 p = load_chunk<T>(X, tid & 127, j);
        x[4 * j] = p.x * (x[4 * j] - dlt[qc]);
        x[4 * j + 1] = p.y * (x[4 * j + 1] - dlt[qc + 1]);
        x[4 * j + 2] = p.z * (x[4 * j + 2] - dlt[qc]);
        x[4 * j + 3] = p.w * (x[4 * j + 3] - dlt[qc + 1]);
      }
    }

    // WG0: dV += bf16(P^T) . dO; WG1: dK += bf16(dS^T) . Q
    sb_grad<T>(acc, x, wg == 0 ? sl + TB : sl);
    if constexpr (CL > 1) mbar_arrive_remote(xch.peer_freed);  // read all
  }
  ring_wait_upto(0);
  // no CTA exits while its peer may still arrive on its mbarriers
  if constexpr (CL > 1) mbar_wait_cluster(xch.freed, (nqt - 1) & 1);

  if (wg == 0)
    sb_store(head_ptr(a.dv, a.sdv, b, h), a.sdv.s, acc, kr0, kv0, kr1, kv1,
             c0, t, 1.f, a.hd);
  else
    sb_store(head_ptr(a.dk, a.sdk, b, h), a.sdk.s, acc, kr0, kv0, kr1, kv1,
             c0, t, a.scale, a.hd);
}

template <int D>
__global__ void __launch_bounds__(SB_THREADS, 1)
stream_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const SbArgs a) {
  constexpr int CL = sb_cluster<D>(), DC = sb_cols<D>(), NB = DC / 64;
  constexpr int T = sb_tile<D>(), TB = sb_tile_bytes<D>();
  constexpr int RB = sw128_bytes<DC, SB_ROWS>();  // a resident tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t full[SB_STAGES + 1];  // slots' jobs, then Q and dO
  __shared__ uint64_t xbar[2];  // the exchange's landed and freed
  __shared__ float rows[SB_STAGES][2][SB_TILE_MAX];  // a slot's key bias
  unsigned char* base = sb_base(smem_raw);
  const e16* Qs = reinterpret_cast<const e16*>(base);
  const e16* Os = reinterpret_cast<const e16*>(base + RB);
  // tile 0: S (the peer's partial, then P); tile 1 (cluster): dP
  float* X = reinterpret_cast<float*>(base + 2 * RB + 2 * SB_STAGES * TB);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, rw = (warp & 3) * 16;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t rank = CL > 1 ? cluster_rank() : 0;
  const int b = blockIdx.z, h = blockIdx.y, q0 = (blockIdx.x / CL) * SB_ROWS;
  const int c0 = rank * DC;
  const int nkt = (a.Sk + T - 1) / T;
  const float* brow = a.bias ? a.bias + (long)b * a.Sk : nullptr;
  float* mine = X + (CL > 1 ? wg : 0) * SB_ROWS * T;
  Xch xch{xbar, xbar + 1, 0, 0, 0};
  if constexpr (CL > 1)
    xch = Xch{xbar, xbar + 1, peer_addr(mine, rank ^ 1),
              peer_addr(xbar, rank ^ 1), peer_addr(xbar + 1, rank ^ 1)};
  // job j: K and V tile j and its bias row
  const SbRing<DC, T> ring{base + 2 * RB, full, rows, &tk, &tv, brow,
                           nullptr, nkt, a.Sk, c0, h, b};

  sb_init(full, CL > 1 ? xbar : nullptr, tid);
  if (tid == 0)
    sb_load_pair<DC, SB_ROWS>(base, &tq, &tdo, full + SB_STAGES, c0, q0, h,
                              b);
  ring.start(tid);
  if constexpr (CL > 1) {  // the peer runs and its mbarriers are set up
    cluster_arrive();
    cluster_wait();
  }
  const int r0 = q0 + rw + g, r1 = r0 + 8;
  const long rb = ((long)b * a.H + h) * a.Sq;
  // WG0 needs each row's lse, WG1 its delta
  const float* stat = wg == 0 ? a.lse : a.delta;
  const float st0 = r0 < a.Sq ? stat[rb + r0] : 0.f;
  const float st1 = r1 < a.Sq ? stat[rb + r1] : 0.f;
  mbar_wait(full + SB_STAGES, 0);

  float acc[NB][32];  // WG1: dQ (this CTA's columns)
  zero_acc(acc);

  for (int j = 0; j < nkt; ++j) {
    const int st = j % SB_STAGES;
    const unsigned char* sl = ring.next(j, tid);
    const e16* Kt = reinterpret_cast<const e16*>(sl);
    const e16* Vt = reinterpret_cast<const e16*>(sl + TB);

    // WG0: S = Q.K^T; WG1: dP = dO.V^T
    float x[32];
    if (wg == 0)
      wgmma_qk<DC, T, SB_ROWS, T>(x, Qs, 0, Kt);
    else
      wgmma_qk<DC, T, SB_ROWS, T>(x, Os, 0, Vt);
    if constexpr (CL > 1) exchange_add<T>(x, mine, xch, tid, j);

    if (wg == 0) {
      const float* bs = rows[st][0];
#pragma unroll
      for (int u = 0; u < T / 8; ++u) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = 8 * u + 2 * t + e;
          const bool kv = j * T + kc < a.Sk;
          const float bb = brow ? bs[kc] : 0.f;
          x[4 * u + e] =
              kv ? stream_p(x[4 * u + e], a.scale, bb, st0, a.keyless) : 0.f;
          x[4 * u + 2 + e] =
              kv ? stream_p(x[4 * u + 2 + e], a.scale, bb, st1, a.keyless)
                 : 0.f;
        }
      }
      store_frag<T>(X, tid & 127, x);
    }
    __syncthreads();  // P is in tile 0
    if (wg == 1) {
      // dS = P (dP - delta); dQ += bf16(dS) . K, K read MN-major
#pragma unroll
      for (int u = 0; u < T / 8; ++u) {
        const float4 p = load_chunk<T>(X, tid & 127, u);
        x[4 * u] = p.x * (x[4 * u] - st0);
        x[4 * u + 1] = p.y * (x[4 * u + 1] - st0);
        x[4 * u + 2] = p.z * (x[4 * u + 2] - st1);
        x[4 * u + 3] = p.w * (x[4 * u + 3] - st1);
      }
      sb_grad<T>(acc, x, sl);
    }
    if constexpr (CL > 1) mbar_arrive_remote(xch.peer_freed);  // read all
  }
  ring_wait_upto(0);
  // no CTA exits while its peer may still arrive on its mbarriers
  if constexpr (CL > 1) mbar_wait_cluster(xch.freed, (nkt - 1) & 1);

  if (wg == 1)
    sb_store(head_ptr(a.dq, a.sdq, b, h), a.sdq.s, acc, r0, r0 < a.Sq, r1,
             r1 < a.Sq, c0, t, a.scale, a.hd);
}

// Both products of a warpgroup's 64 rows against a walked 64-row tile,
// over D: d1 = A1.B1^T and d2 = A2.B2^T (A tiles of AROWS rows from row
// a_row0, swizzled K-major, as wgmma_qk), issued together, then waited for.
template <int D, int AROWS>
__device__ __forceinline__ void wgmma_qk2(float (&d1)[32], const e16* A1,
                                          const e16* B1, float (&d2)[32],
                                          const e16* A2, const e16* B2,
                                          int a_row0) {
  const unsigned char* a1 = reinterpret_cast<const unsigned char*>(A1) + a_row0 * 128;
  const unsigned char* a2 = reinterpret_cast<const unsigned char*>(A2) + a_row0 * 128;
  const unsigned char* b1 = reinterpret_cast<const unsigned char*>(B1);
  const unsigned char* b2 = reinterpret_cast<const unsigned char*>(B2);
  fence_regs(d1);
  fence_regs(d2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int ao = (kk / 4) * AROWS * 128 + (kk % 4) * 32;
    const int bo = (kk / 4) * SB_TILE_MAX * 128 + (kk % 4) * 32;
    wgmma_ss<64>(d1, desc_sw128(a1 + ao), desc_sw128(b1 + bo), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int ao = (kk / 4) * AROWS * 128 + (kk % 4) * 32;
    const int bo = (kk / 4) * SB_TILE_MAX * 128 + (kk % 4) * 32;
    wgmma_ss<64>(d2, desc_sw128(a2 + ao), desc_sw128(b2 + bo), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d1);
  fence_regs(d2);
}

// dK/dV at D <= 128: 128 keys a CTA, warpgroup w owns keys 64 w.. and
// forms S^T, dP^T, P^T and dS^T of them itself, then dV += bf16(P^T) . dO
// and dK += bf16(dS^T) . Q, all in registers.
template <int D>
__global__ void __launch_bounds__(SB_THREADS, 1)
stream_bwd_dkv_rows_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const SbArgs a) {
  constexpr int T = SB_TILE_MAX, NB = D / 64, TB = sw128_bytes<D, T>();
  constexpr int OB = sw128_bytes<D, 128>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t full[SB_STAGES + 1];  // slots' jobs, then K and V
  __shared__ float rows[SB_STAGES][2][T];  // lse, delta of a slot
  unsigned char* base = sb_base(smem_raw);
  const e16* Ks = reinterpret_cast<const e16*>(base);
  const e16* Vs = reinterpret_cast<const e16*>(base + OB);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, rw = (warp & 3) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * 128;
  const long rb = ((long)b * a.H + h) * a.Sq;
  const int nqt = (a.Sq + T - 1) / T;
  const SbRing<D, T> ring{base + 2 * OB, full, rows, &tq, &tdo, a.lse + rb,
                          a.delta + rb, nqt, a.Sq, 0, h, b};

  sb_init(full, nullptr, tid);
  if (tid == 0)
    sb_load_pair<D, 128>(base, &tk, &tv, full + SB_STAGES, 0, k0, h, b);
  ring.start(tid);
  const int kr0 = k0 + 64 * wg + rw + g, kr1 = kr0 + 8;
  const bool kv0 = kr0 < a.Sk, kv1 = kr1 < a.Sk;
  const float* brow = a.bias ? a.bias + (long)b * a.Sk : nullptr;
  const float bk0 = brow && kv0 ? brow[kr0] : 0.f;
  const float bk1 = brow && kv1 ? brow[kr1] : 0.f;
  mbar_wait(full + SB_STAGES, 0);

  float dva[NB][32], dka[NB][32];
  zero_acc(dva);
  zero_acc(dka);

  for (int i = 0; i < nqt; ++i) {
    const int st = i % SB_STAGES;
    const unsigned char* sl = ring.next(i, tid);
    const e16* Qt = reinterpret_cast<const e16*>(sl);
    const e16* Ot = reinterpret_cast<const e16*>(sl + TB);

    float s[32], dp[32];  // S^T = K.Q^T and dP^T = V.dO^T of this WG's keys
    wgmma_qk2<D, 128>(s, Ks, Qt, dp, Vs, Ot, 64 * wg);
    const float* lse = rows[st][0];
    const float* dlt = rows[st][1];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * j + 2 * t + e;
        const bool qv = i * T + qc < a.Sq;
        const float p0 = qv && kv0 ? stream_p(s[4 * j + e], a.scale, bk0,
                                              lse[qc], a.keyless)
                                   : 0.f;
        const float p1 = qv && kv1 ? stream_p(s[4 * j + 2 + e], a.scale, bk1,
                                              lse[qc], a.keyless)
                                   : 0.f;
        s[4 * j + e] = p0;
        s[4 * j + 2 + e] = p1;
        dp[4 * j + e] = p0 * (dp[4 * j + e] - dlt[qc]);
        dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dlt[qc]);
      }
    // dV += bf16(P^T) . dO and dK += bf16(dS^T) . Q in one commit group
    uint32_t fp[T / 16][4], fd[T / 16][4];
    sb_frags(fp, s);
    sb_frags(fd, dp);
    fence_acc(dva);
    fence_acc(dka);
    wgmma_fence();
    sb_grad_issue(dva, fp, sl + TB);
    sb_grad_issue(dka, fd, sl);
    wgmma_commit();
    wgmma_wait_all();  // the slot is overwritten after the next barrier
    fence_acc(dva);
    fence_acc(dka);
#pragma unroll
    for (int c = 0; c < T / 16; ++c) {
      fence_regs(fp[c]);
      fence_regs(fd[c]);
    }
  }
  ring_wait_upto(0);

  sb_store(head_ptr(a.dk, a.sdk, b, h), a.sdk.s, dka, kr0, kv0, kr1, kv1, 0,
           t, a.scale, a.hd);
  sb_store(head_ptr(a.dv, a.sdv, b, h), a.sdv.s, dva, kr0, kv0, kr1, kv1, 0,
           t, 1.f, a.hd);
}

// dQ at D <= 128: 128 query rows a CTA, warpgroup w owns rows 64 w.. and
// forms S, dP, P and dS of them itself, then dQ += bf16(dS) . K.
template <int D>
__global__ void __launch_bounds__(SB_THREADS, 1)
stream_bwd_dq_rows_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const SbArgs a) {
  constexpr int T = SB_TILE_MAX, NB = D / 64, TB = sw128_bytes<D, T>();
  constexpr int OB = sw128_bytes<D, 128>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t full[SB_STAGES + 1];  // slots' jobs, then Q and dO
  __shared__ float rows[SB_STAGES][2][T];  // a slot's key bias
  unsigned char* base = sb_base(smem_raw);
  const e16* Qs = reinterpret_cast<const e16*>(base);
  const e16* Os = reinterpret_cast<const e16*>(base + OB);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, rw = (warp & 3) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * 128;
  const int nkt = (a.Sk + T - 1) / T;
  const float* brow = a.bias ? a.bias + (long)b * a.Sk : nullptr;
  const SbRing<D, T> ring{base + 2 * OB, full, rows, &tk, &tv, brow, nullptr,
                          nkt, a.Sk, 0, h, b};

  sb_init(full, nullptr, tid);
  if (tid == 0)
    sb_load_pair<D, 128>(base, &tq, &tdo, full + SB_STAGES, 0, q0, h, b);
  ring.start(tid);
  const int r0 = q0 + 64 * wg + rw + g, r1 = r0 + 8;
  const long rb = ((long)b * a.H + h) * a.Sq;
  const float lse0 = r0 < a.Sq ? a.lse[rb + r0] : 0.f;
  const float lse1 = r1 < a.Sq ? a.lse[rb + r1] : 0.f;
  const float d0 = r0 < a.Sq ? a.delta[rb + r0] : 0.f;
  const float d1 = r1 < a.Sq ? a.delta[rb + r1] : 0.f;
  mbar_wait(full + SB_STAGES, 0);

  float acc[NB][32];
  zero_acc(acc);

  for (int j = 0; j < nkt; ++j) {
    const int st = j % SB_STAGES;
    const unsigned char* sl = ring.next(j, tid);
    const e16* Kt = reinterpret_cast<const e16*>(sl);
    const e16* Vt = reinterpret_cast<const e16*>(sl + TB);

    float s[32], dp[32];  // S = Q.K^T and dP = dO.V^T of this WG's rows
    wgmma_qk2<D, 128>(s, Qs, Kt, dp, Os, Vt, 64 * wg);
    const float* bs = rows[st][0];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = 8 * u + 2 * t + e;
        const bool kv = j * T + kc < a.Sk;
        const float bb = brow ? bs[kc] : 0.f;
        const float p0 =
            kv ? stream_p(s[4 * u + e], a.scale, bb, lse0, a.keyless) : 0.f;
        const float p1 =
            kv ? stream_p(s[4 * u + 2 + e], a.scale, bb, lse1, a.keyless)
               : 0.f;
        dp[4 * u + e] = p0 * (dp[4 * u + e] - d0);
        dp[4 * u + 2 + e] = p1 * (dp[4 * u + 2 + e] - d1);
      }
    sb_grad<T>(acc, dp, sl);  // dQ += bf16(dS) . K
  }
  ring_wait_upto(0);

  sb_store(head_ptr(a.dq, a.sdq, b, h), a.sdq.s, acc, r0, r0 < a.Sq, r1,
           r1 < a.Sq, 0, t, a.scale, a.hd);
}

// delta = rowsum(dO * O) in fp32 for every row (row_delta, as the
// full-block backward's pre-pass computes it, without 1/l).
constexpr int SD_THREADS = 256;

template <int D>
__global__ void __launch_bounds__(SD_THREADS)
stream_delta_kernel(const e16* __restrict__ dout,
                    const e16* __restrict__ out, float* __restrict__ delta,
                    int H, int Sq, long rows, Rows sdo, Rows so, int hd) {
  const long row = ((long)blockIdx.x * SD_THREADS + threadIdx.x) >> 3;
  const float acc = row_delta<D>(dout, out, row, rows, H, Sq, sdo, so, hd);
  if (row < rows && (threadIdx.x & 7) == 0) delta[row] = acc;
}

// A tensor map of one (B, H, S, D) e16 operand (D the head dim) with
// element strides st[0..2] (batch, head, row), boxes of 64 columns x `rows`
// rows; a box's columns past D read zeros (a cluster CTA's whole slice
// where it lies past D).
static int sb_tmap(CUtensorMap* map, const void* x, int B, int H, int S,
                   int D, const long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return make_tmap(map, E16_TMAP, 4, x, dims, strides, box);
}

template <int D>
int launch_stream_bwd(bool dkv, const void* q, const void* k, const void* v,
                      const void* dout, const SbArgs& a, int B,
                      const long* st, int cluster, int stages, int smem,
                      cudaStream_t stream) {
  if (cluster != sb_cluster<D>() || stages != SB_STAGES ||
      smem != sb_smem_bytes<D>() || smem > SB_SMEM_MAX)
    return HV_BAD_PLAN;
  CUtensorMap tq, tk, tv, tdo;
  // boxes of 64 rows for the resident side, sb_tile for the walked one
  const int qbox = dkv ? sb_tile<D>() : 64, kbox = dkv ? 64 : sb_tile<D>();
  int rc = sb_tmap(&tq, q, B, a.H, a.Sq, a.hd, st, qbox);
  if (!rc) rc = sb_tmap(&tk, k, B, a.H, a.Sk, a.hd, st + 3, kbox);
  if (!rc) rc = sb_tmap(&tv, v, B, a.H, a.Sk, a.hd, st + 6, kbox);
  if (!rc) rc = sb_tmap(&tdo, dout, B, a.H, a.Sq, a.hd, st + 9, qbox);
  if (rc) return rc;
  void (*kern)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, SbArgs);
  if constexpr (sb_split<D>())
    kern = dkv ? stream_bwd_dkv_kernel<D> : stream_bwd_dq_kernel<D>;
  else
    kern = dkv ? stream_bwd_dkv_rows_kernel<D> : stream_bwd_dq_rows_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = ((dkv ? a.Sk : a.Sq) + sb_rows<D>() - 1) / sb_rows<D>();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * cluster, a.H, B);
  cfg.blockDim = dim3(SB_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, tq, tk, tv, tdo, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dims past 640 (tiles 768 to 2048): stream_bwd_wide_kernel, dQ (DKV
// false) or dK and dV (DKV true), a cluster of tile / 256 CTAs along D
// (attn_wide.cuh's note), in bf16 (fp16 built with -DHV_F16) and fp32. The
// same functions as the narrow kernels: P = exp(s - lse) from the
// forward's natural-log LSE (stream_p: with keyless = 1 / Sk, the uniform
// P of a row with no key), dS = P (dP - delta), dQ = dS.K * scale, dK =
// dS^T.Q * scale, dV = P^T.dO, P rounded to dO's dtype and dS to q's.
//
// Bounds on the H100 SXM at (4, 1, 1024, 1024): dQ does 6*B*H*S^2*D =
// 25.8 GFLOP (26.1 us at 989 TFLOP/s; 52.1 us at TF32's 494.7, the rate
// this kernel's products run at; three products for fp32: 156 us) over q,
// k, v, dO, dQ and two rows (10.0 us at 3.35 TB/s in bf16); dK/dV
// 8*B*H*S^2*D = 34.4 GFLOP (34.7, 69.5 and 208 us) over six tensors. Both
// bound by operations.
//
// A CTA: 64 resident rows (query rows for dQ with their lse and delta;
// keys for dK/dV with their bias) of its 256 columns of the resident pair
// (Q and dO; K and V); walked tiles of swb_tile rows (32 in bf16 and
// fp16, 16 in fp32) of the walked pair (K and V; Q and dO) with their fp32
// rows (the keys' bias; the queries' lse and delta) through two cp.async
// slots. Per walked tile: warps 0-3 form the partial X = S (S^T for
// dK/dV) of m tile w, warps 4-7 Y = dP (dP^T), into this CTA's partial
// tiles; the cluster barrier; each thread sums float4s of X and Y over
// the cluster in rank order and forms P and dS of them, into the P and dS
// tiles; a CTA barrier; warp w adds the gradient products of its 16 rows
// and 128 columns: dQ += dS.K, or dK += dS^T.Q and dV += P^T.dO. Shared
// bytes (swb_smem_bytes): the resident pair and its rows, two slots, two
// buffers of the X and Y partials, the P and dS tiles: 187,392 in bf16
// and fp16, 227,072 in fp32.
// ---------------------------------------------------------------------------

template <typename T>
__host__ __device__ constexpr int swb_tile() {
  return sizeof(T) == 4 ? 16 : 32;
}

// One slot: the walked pair's two tiles, then two fp32 rows of swb_tile.
template <typename T>
__host__ __device__ constexpr int swb_slot_elems() {
  return 2 * swb_tile<T>() * wide_ld<T>() + 2 * swb_tile<T>() * 4 /
                                                (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr int swb_smem_bytes() {
  return (2 * WIDE_ROWS * wide_ld<T>() + 2 * swb_slot_elems<T>()) *
             (int)sizeof(T) +
         (2 * WIDE_ROWS + 4 * WIDE_ROWS * swb_tile<T>() +
          2 * WIDE_ROWS * (swb_tile<T>() + 4)) *
             4;
}

struct WideArgs {
  const void *q, *k, *v, *dout;
  const float *bias, *lse, *delta;
  void *dq, *dk, *dv;
  Rows sq, sk, sv, sdo, sdq, sdk, sdv;
  int H, Sq, Sk;
  int hd;         // the head dim (<= the tile)
  int cl;         // CTAs a cluster
  float scale;
  float keyless;  // stream_p's: 0, or 1 / Sk (the full-block rule)
};

template <typename T, bool DKV>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
stream_bwd_wide_kernel(const WideArgs a) {
  constexpr int LD = wide_ld<T>(), R = WIDE_ROWS, BT = swb_tile<T>();
  constexpr int BTP = BT + 4, KS = BT / 8, SLOT = swb_slot_elems<T>();
  constexpr int NO = WIDE_OUT_COLS / 8;
  extern __shared__ float4 swb_smem[];
  T* A1 = reinterpret_cast<T*>(swb_smem);
  T* A2 = A1 + R * LD;
  T* ring = A2 + R * LD;
  float* ST = reinterpret_cast<float*>(ring + 2 * SLOT);  // 2 rows of R
  float* XP = ST + 2 * R;       // [2 buffers][X, Y][R][BT]
  float* PD = XP + 4 * R * BT;  // [P, dS][R][BTP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3, xy = warp >> 2;  // scores: X or Y of m tile mt
  const int ch = warp >> 2;                 // gradients: columns 128 ch..
  const int c0 = (int)cluster_rank() * WIDE_COLS;
  const int b = blockIdx.z, h = blockIdx.y, r0 = (blockIdx.x / a.cl) * R;
  const int nres = DKV ? a.Sk : a.Sq, nwalk = DKV ? a.Sq : a.Sk;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const T* ra1 = DKV ? head_ptr(k, a.sk, b, h) : head_ptr(q, a.sq, b, h);
  const T* ra2 = DKV ? head_ptr(v, a.sv, b, h) : head_ptr(dout, a.sdo, b, h);
  const T* wa1 = DKV ? head_ptr(q, a.sq, b, h) : head_ptr(k, a.sk, b, h);
  const T* wa2 = DKV ? head_ptr(dout, a.sdo, b, h) : head_ptr(v, a.sv, b, h);
  const long rs1 = DKV ? a.sk.s : a.sq.s, rs2 = DKV ? a.sv.s : a.sdo.s;
  const long ws1 = DKV ? a.sq.s : a.sk.s, ws2 = DKV ? a.sdo.s : a.sv.s;
  const long rb = ((long)b * a.H + h) * a.Sq;  // row statistics of (b, h)
  const float* brow = a.bias ? a.bias + (long)b * a.Sk : nullptr;
  const int njobs = (nwalk + BT - 1) / BT;

  // walked tile i into slot i % 2: its two tiles and its fp32 rows (dK/dV:
  // the queries' lse and delta; dQ: the keys' bias), one cp.async group
  auto issue = [&](int i) {
    T* sl = ring + (i & 1) * SLOT;
    wide_load<T, BT>(sl, wa1, ws1, i * BT, nwalk, c0, a.hd, tid);
    wide_load<T, BT>(sl + BT * LD, wa2, ws2, i * BT, nwalk, c0, a.hd, tid);
    float* rows = reinterpret_cast<float*>(sl + 2 * BT * LD);
    if constexpr (DKV) {
      load_row_f32<BT, WIDE_THREADS>(rows, a.lse + rb, i * BT, a.Sq, tid);
      load_row_f32<BT, WIDE_THREADS>(rows + BT, a.delta + rb, i * BT, a.Sq,
                                     tid);
    } else {
      if (brow) load_row_f32<BT, WIDE_THREADS>(rows, brow, i * BT, a.Sk, tid);
    }
    ring_commit();
  };
  // the resident pair and its rows (dQ: lse and delta; dK/dV: the keys'
  // bias) ride in job 0's group
  wide_load<T, R>(A1, ra1, rs1, r0, nres, c0, a.hd, tid);
  wide_load<T, R>(A2, ra2, rs2, r0, nres, c0, a.hd, tid);
  if constexpr (DKV) {
    if (brow) load_row_f32<R, WIDE_THREADS>(ST, brow, r0, a.Sk, tid);
  } else {
    load_row_f32<R, WIDE_THREADS>(ST, a.lse + rb, r0, a.Sq, tid);
    load_row_f32<R, WIDE_THREADS>(ST + R, a.delta + rb, r0, a.Sq, tid);
  }
  issue(0);

  float acc[NO][4], acc2[DKV ? NO : 1][4];  // dQ or dK; dV
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < (DKV ? NO : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[n][e] = 0.f;

  for (int i = 0; i < njobs; ++i) {
    ring_wait_upto(0);
    __syncthreads();  // tile i has landed; tile i - 1's slot, P and dS free
    if (i + 1 < njobs) issue(i + 1);
    const T* sl = ring + (i & 1) * SLOT;
    const float* rows = reinterpret_cast<const float*>(sl + 2 * BT * LD);
    float* part = XP + (i & 1) * 2 * R * BT;  // X, then Y
    {
      float x[KS][4];
      wide_scores<T, KS>(x, (xy ? A2 : A1) + 16 * mt * LD, sl + xy * BT * LD,
                         g, t);
      wide_store_blocks<KS>(part + xy * R * BT + 16 * mt * BT, BT, x, g, t);
    }
    cluster_arrive();
    cluster_wait();  // every CTA's partials of tile i are in place
    // the cluster's X and Y in rank order, then P and dS, 4 elements a
    // thread at a time
    for (int e4 = tid; e4 < R * BT / 4; e4 += WIDE_THREADS) {
      const int r = 4 * e4 / BT, c = 4 * e4 % BT;
      const float4 xs = wide_cluster_sum(part, e4, a.cl);
      const float4 ys = wide_cluster_sum(part + R * BT, e4, a.cl);
      const float xv[4] = {xs.x, xs.y, xs.z, xs.w};
      const float yv[4] = {ys.x, ys.y, ys.z, ys.w};
      float p[4], ds[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        p[jj] = ds[jj] = 0.f;
        const int w = i * BT + c + jj;  // the walked row
        if constexpr (DKV) {
          if (r0 + r < a.Sk && w < a.Sq) {
            p[jj] = stream_p(xv[jj], a.scale, brow ? ST[r] : 0.f,
                             rows[c + jj], a.keyless);
            ds[jj] = p[jj] * (yv[jj] - rows[BT + c + jj]);
          }
        } else {
          if (w < a.Sk) {
            p[jj] = stream_p(xv[jj], a.scale, brow ? rows[c + jj] : 0.f,
                             ST[r], a.keyless);
            ds[jj] = p[jj] * (yv[jj] - ST[R + r]);
          }
        }
      }
      *reinterpret_cast<float4*>(PD + r * BTP + c) =
          make_float4(wide_round<T>(p[0]), wide_round<T>(p[1]),
                      wide_round<T>(p[2]), wide_round<T>(p[3]));
      *reinterpret_cast<float4*>(PD + (R + r) * BTP + c) =
          make_float4(wide_round<T>(ds[0]), wide_round<T>(ds[1]),
                      wide_round<T>(ds[2]), wide_round<T>(ds[3]));
    }
    __syncthreads();
    // dQ += dS.K, or dK += dS^T.Q and dV += P^T.dO: this warp's 16 rows
    // and 128 columns
    {
      uint32_t fh[KS][4], fl[KS][4];
      wide_frag_a<T, KS>(fh, fl, PD + (R + 16 * mt) * BTP, BTP, g, t);
      wide_grad<T, NO, KS>(acc, fh, fl, sl + WIDE_OUT_COLS * ch, 1.f, 1.f, g,
                           t);
    }
    if constexpr (DKV) {
      uint32_t fh[KS][4], fl[KS][4];
      wide_frag_a<T, KS>(fh, fl, PD + 16 * mt * BTP, BTP, g, t);
      wide_grad<T, NO, KS>(acc2, fh, fl, sl + BT * LD + WIDE_OUT_COLS * ch,
                           1.f, 1.f, g, t);
    }
  }
  ring_wait_upto(0);
  cluster_arrive();
  cluster_wait();  // no CTA leaves while a peer may read its partials

  T* o1 = static_cast<T*>(DKV ? a.dk : a.dq);
  const Rows so1 = DKV ? a.sdk : a.sdq;
  o1 = head_ptr(o1, so1, b, h);
  T* o2 = DKV ? head_ptr(static_cast<T*>(a.dv), a.sdv, b, h) : nullptr;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + 16 * mt + 8 * hf + g;
    if (row >= nres) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = c0 + WIDE_OUT_COLS * ch + 8 * n + 2 * t;
      if (col >= a.hd) continue;
      wide_store2(o1 + (long)row * so1.s + col, acc[n][2 * hf] * a.scale,
                  acc[n][2 * hf + 1] * a.scale);
      if constexpr (DKV)
        wide_store2(o2 + (long)row * a.sdv.s + col, acc2[n][2 * hf],
                    acc2[n][2 * hf + 1]);
    }
  }
}

// Takes only the plans flash_attention.py::_stream_bwd_plan (bf16, fp16:
// cluster, 2 slots, shared bytes) and _stream_bwd_f32_plan (fp32: cluster,
// 64 rows, the walked tile, shared bytes) return at a wide tile.
template <typename T>
int launch_stream_bwd_wide(bool dkv, const WideArgs& a, int B, int tile,
                           int cluster, int rows, int walk, int smem,
                           cudaStream_t stream) {
  if (cluster != wide_cluster(tile) || rows != WIDE_ROWS ||
      walk != (sizeof(T) == 4 ? swb_tile<T>() : SB_STAGES) ||
      smem != swb_smem_bytes<T>() || smem > SB_SMEM_MAX)
    return HV_BAD_PLAN;
  WideArgs w = a;
  w.cl = cluster;
  const int blocks = ((dkv ? a.Sk : a.Sq) + WIDE_ROWS - 1) / WIDE_ROWS;
  return dkv ? wide_launch(stream_bwd_wide_kernel<T, true>, blocks, cluster,
                           a.H, B, smem, stream, w)
             : wide_launch(stream_bwd_wide_kernel<T, false>, blocks, cluster,
                           a.H, B, smem, stream, w);
}

inline WideArgs wide_args(const void* q, const void* k, const void* v,
                   const float* bias, const void* dout, const float* lse,
                   const float* delta, void* dq, void* dk, void* dv, int H,
                   int Sq, int Sk, int D, float scale, int full,
                   const long* st) {
  WideArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.bias = bias;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  Rows* rs[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i)
    *rs[i] = Rows{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.hd = D;
  a.cl = 0;
  a.scale = scale;
  a.keyless = full ? 1.f / Sk : 0.f;
  return a;
}

int stream_bwd(bool dkv, const void* q, const void* k, const void* v,
               const float* bias, const void* dout, const float* lse,
               const float* delta, void* dq, void* dk, void* dv, int B, int H,
               int Sq, int Sk, int D, int cluster, int stages, int smem,
               int full, float scale, const long* st, void* stream) {
  SbArgs a;
  a.bias = bias;
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<e16*>(dq);
  a.dk = static_cast<e16*>(dk);
  a.dv = static_cast<e16*>(dv);
  a.sdq = Rows{st[12], st[13], st[14]};
  a.sdk = Rows{st[15], st[16], st[17]};
  a.sdv = Rows{st[18], st[19], st[20]};
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.hd = D;
  a.scale = scale;
  a.keyless = full ? 1.f / Sk : 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stream_tile(D)) {
    case 64: return launch_stream_bwd<64>(dkv, q, k, v, dout, a, B, st, cluster, stages, smem, s);
    case 128: return launch_stream_bwd<128>(dkv, q, k, v, dout, a, B, st, cluster, stages, smem, s);
    case 256: return launch_stream_bwd<256>(dkv, q, k, v, dout, a, B, st, cluster, stages, smem, s);
    case 512: return launch_stream_bwd<512>(dkv, q, k, v, dout, a, B, st, cluster, stages, smem, s);
    case 640: return launch_stream_bwd<640>(dkv, q, k, v, dout, a, B, st, cluster, stages, smem, s);
    case -1: return -1;
    default:
      return launch_stream_bwd_wide<e16>(
          dkv, wide_args(q, k, v, bias, dout, lse, delta, dq, dk, dv, H, Sq, Sk, D, scale, full, st),
          B, stream_tile(D), cluster, WIDE_ROWS, stages, smem, s);
  }
}

template <int D>
int launch_delta(const void* dout, const void* out, float* delta, int B,
                 int H, int Sq, int hd, const long* st, cudaStream_t stream) {
  const long rows = (long)B * H * Sq;
  const long blocks = (rows * 8 + SD_THREADS - 1) / SD_THREADS;
  stream_delta_kernel<D><<<(unsigned)blocks, SD_THREADS, 0, stream>>>(
      static_cast<const e16*>(dout), static_cast<const e16*>(out), delta, H,
      Sq, rows, Rows{st[0], st[1], st[2]}, Rows{st[3], st[4], st[5]}, hd);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 variant (stream_bwd_dq_f32_kernel, stream_bwd_dkv_f32_kernel,
// stream_delta_f32_kernel; hv_stream_bwd_dq_f32, hv_stream_bwd_dkv_f32,
// hv_stream_delta_f32): _stream_dq_kernel and _stream_dkv_kernel at fp32,
// where their roundings of P and dS are no-ops: P = exp(s - lse) from the
// fp32 forward's natural-log LSE (stream_fwd_f32_kernel), kept in fp32 with
// dS, every product three TF32 products of a hi/lo split (attn_f32.cuh). It
// serves the perceptual loss's fp32 SD-VAE decode (D 512), the CNN motion
// AE's MapConv (D 640) and the ring's fp32 hop (D 64) with a gradient.
//
// Bounds on the H100 SXM: at (16, 1, 1024, 512) dQ does 6*B*H*S^2*D = 51.5
// GFLOP, three TF32 products each, 0.3126 ms at 494.7 TFLOP/s (bytes: q, k,
// v, dO, dQ and 2 rows, 0.050 ms); dK/dV 8*B*H*S^2*D = 68.7 GFLOP, 0.4167
// ms; at (16, 1, 1024, 640) 0.3907 and 0.5209 ms. Both bound by operations.
// mma.sync m16n8k8 .tf32, which takes the A operand the threads split in
// registers, runs at 288.8-312.6 TFLOP/s on the H100 alone (4 to 8
// independent accumulators a warp, 8 or 16 warps a SM; 125.2 with one at 8
// warps; scripts/mma_sync_rate.cu), so through it these products take at
// least 0.49-0.54 (dQ) and 0.66-0.71 ms (dK/dV) at D 512.
//
// D <= 256: attn_f32.cuh's gradient CTA (f32_grad_cta, its note).
//
// D >= FC_DIM (fc_cta): a cluster along D. One CTA's fp32 accumulators of
// 64 rows x D take 64 (dQ) or 128 (dK and dV) registers a thread only up to
// D 256, and a resident pair of 64 fp32 rows of D = 512 columns is 256 KB,
// past the 227 KB of a block before any walked tile. So the gradient CTA,
// which these head dims ran before, held 32 query rows (dQ) or 16 keys
// (dK/dV) at D 512, 16 at 640, with 8- or 16-row walked tiles: every CTA
// streamed its head's whole walked side, 2 (dQ) and 4 GiB (dK/dV) through
// L2 a launch at (16, 1, 1024, 512), 5 GiB each at D 640. Here a cluster
// of CL CTAs (fc_cluster: 2 at D 512, 4 at D 640) shares 64 rows: rank r
// holds columns [r D / CL, (r + 1) D / CL) of every operand and output,
// so its accumulators are 64 / 128
// registers (D 512) or 40 / 80 (D 640), its resident pair 64 x D / CL, its
// walked tiles D / CL wide: 16 rows at D 512, 32 at D 640 (fc_tile), one
// CTA a SM. The walked side crosses L2 once for 64 rows: 1 GiB for either
// kernel at (16, 1, 1024, 512), 1.25 GiB at D 640.
// A walked tile, 8 warps, in four steps:
//  1. scores: warps 0-3 form X = A1.B1^T (S; S^T = K.Q^T for dK/dV) of one
//     16-row m tile each over the CTA's columns, warps 4-7 Y = A2.B2^T (dP;
//     dP^T), hi.hi and the small terms in their own sums (f32_scores),
//     added once: the CTA's partial, in registers.
//  2. exchange: each thread stores its partial fragments (float4s, [n
//     block][thread]) into this CTA's slot in every peer by st.async, whose
//     bytes the peer's `landed` mbarrier counts (complete_tx), waits on its
//     own `landed`, and sums its fragments over the cluster in rank order,
//     its own from registers: ((p0 + p1) + p2) + p3, the same bits in
//     every CTA. After a CTA barrier the sums go to the P and dS tiles
//     (rows BT + 8 floats apart) over the slots; a CTA barrier. A slot is
//     stored into again only after its owner has arrived on the storer's
//     `freed` mbarrier, which it does once the tile's gradients are done
//     (thread 0 after the next tile's first CTA barrier, release at
//     cluster scope; CL - 1 arrivals a phase).
//  3. P = exp(s scale + bias - lse) and dS = P (dP - delta), elementwise,
//     written over them; a CTA barrier.
//  4. gradients: warp w owns columns [w D / CL / 8, ...) of all 64 rows (D
//     512; at 640, 40 columns of 32 rows): dQ += dS.K, or dK += dS^T.Q and
//     dV += P^T.dO, each tile's product into a fresh sum (fc_grad).
// No atomics, a fixed order of sums, every gradient element written by one
// CTA: two launches give the same bits. Shared memory at D 512 (floats):
// the resident pair 2 x 64 x 260 and 2 rows of 64; two slots of a walked
// pair 2 x 16 x 260 and 2 rows of 16; the peer's slot 2 x 64 x 16, which
// the P and dS tiles 2 x 64 x 24 overwrite once a CTA barrier shows it
// read (`freed` is arrived after the tile's gradient): 212,736 B; at D 640
// the three peers' slots (48 KB) take the tiles: 218,112 B. The plan is
// flash_attention.py::_stream_bwd_f32_plan (F32ClusterPlan), which the CPU
// tests check; the C entry points refuse any other.
//
// Versions, each timed against the parent (the gradient CTA) and this one in
// one run by scripts/time_stream_bwd_f32.py on an H100 80GB HBM3 at 700 W,
// dQ / dK/dV ms at (16, 1, 1024, 512), then at D 640 (the first of two
// rounds, which agree within 2%): this one 1.3110 / 1.6409, 2.0227 /
// 2.3919; the parent 1.6979 / 2.2024, 2.6377 / 2.9402. The exchange by
// ld.shared::cluster after a barrier.cluster a tile: 1.4042 / 1.6780,
// 2.2326 / 2.5131. The P and dS tiles beside the peer's slot at D 512 (one
// CTA barrier fewer, `freed` arrived as soon as the slot is read): 1.3788
// / 1.6539. A cluster of 4 at D 512 (128 columns, 32-row tiles): 1.8234 /
// 2.1765. 16-row tiles at D 640: 2.5211 / 2.9294. Each TF32 product into
// its own accumulator in both products: 1.3021 / 1.6841, 2.0671 / 2.7504
// (dK/dV spills at D 640). What holds it back, from the same run's
// versions with one part compiled out (wrong values, the rest the same):
// without the exchange 1.2153 / 1.5069, 1.6540 / 2.0250; without the score
// products 0.6382 / 0.9916, 1.5776 / 1.9277; without the gradient products
// 1.0456 / 1.0833, 1.7069 / 1.7522; without the hi/lo split (hi = lo = x)
// 1.1122 / 1.5963, 1.7832 / 2.1936. So at D 512 the score products take
// ~0.66 ms (about half of mma.sync's rate: each warp's 16 x BT blocks over
// D / CL, their fragments read from shared memory and split every tile,
// since no plan leaves room for split copies), the gradients 0.27 / 0.56,
// the split 0.20 / 0.04 and the exchange 0.10 / 0.13 (0.37 at D 640, with
// 3 peers); the steps of a tile do not overlap, one CTA of 8 warps a SM.
//
// Masks as the bf16 kernels: keys past Sk and query rows past Sq get P =
// dS = 0; a key masked by the -1e30 bias has P = exp(-1e30 - lse) = 0
// wherever its row attends to a real key, so a fully masked key block gets
// no gradient; a row with no real key takes stream_p's rule
// (F32GradArgs::keyless), as the bf16 kernels do.
// ---------------------------------------------------------------------------

constexpr int FC_DIM = 512;   // head dims from here on run the cluster CTA
constexpr int FC_ROWS = 64;   // resident rows of a cluster CTA

// The cluster along D: 2 CTAs where each CTA's D / 2 columns are a
// multiple of 32 and at most 256 (the dK and dV accumulators of 64 rows in
// at most 128 registers a thread), else 4.
template <int D>
__host__ __device__ constexpr int fc_cluster() {
  return (D / 2) % 32 == 0 && D / 2 <= 256 ? 2 : 4;
}

// Shared floats of a cluster CTA of dc columns walking tiles of `tile`
// rows, the exchange aside: the resident pair (rows dc + 4 apart) and 2
// fp32 rows of it, two slots of a walked pair and 2 fp32 rows of tile.
__host__ __device__ constexpr int fc_base_floats(int dc, int tile) {
  return 2 * FC_ROWS * (dc + 4) + 2 * FC_ROWS +
         2 * (2 * tile * (dc + 4) + 2 * tile);
}

// The exchange: a slot for each peer's X and Y partials (2 x 64 x tile
// floats), which the P and dS tiles (2 x 64 x (tile + 8)) overwrite once
// the slots are read.
__host__ __device__ constexpr int fc_recv_floats(int tile, int cl) {
  return (cl - 1) * 2 * FC_ROWS * tile > 2 * FC_ROWS * (tile + 8)
             ? (cl - 1) * 2 * FC_ROWS * tile
             : 2 * FC_ROWS * (tile + 8);
}

__host__ __device__ constexpr int fc_smem_at(int dc, int tile, int cl) {
  return 4 * (fc_base_floats(dc, tile) + fc_recv_floats(tile, cl));
}

// Walked rows a tile: 32 or 16, the most that fit one block.
template <int D>
__host__ __device__ constexpr int fc_tile() {
  return fc_smem_at(D / fc_cluster<D>(), 32, fc_cluster<D>()) <= F32_SMEM_MAX
             ? 32
             : 16;
}

template <int D>
__host__ __device__ constexpr int fc_smem() {
  return fc_smem_at(D / fc_cluster<D>(), fc_tile<D>(), fc_cluster<D>());
}

// acc[m] += A.B over the BT rows of a walked tile, for each of a warp's MTW
// 16-row tiles m of A (P or dS, rows lda apart, read k-permuted) against
// its NCW 8-column n tiles of B (the walked tile's rows, ldb apart): m by
// m, each m's product into a fresh accumulator added to acc[m] once, so
// that A's fragments are split once a tile (attn_f32.cuh's f32_grad goes
// n chunk by n chunk, whose fresh accumulators for all MTW m tiles would
// here take as many registers as acc). With TWO, acc2 += A2.B2 alongside.
template <int MTW, int NCW, int BT, bool TWO>
__device__ __forceinline__ void fc_grad(float (&acc)[MTW][NCW][4],
                                        float (&acc2)[MTW][NCW][4],
                                        const float* A, const float* A2,
                                        int lda, const float* B,
                                        const float* B2, int ldb, int g,
                                        int t) {
#pragma unroll
  for (int m = 0; m < MTW; ++m) {
    float tmp[NCW][4], tmp2[NCW][4];
#pragma unroll
    for (int n = 0; n < NCW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmp[n][e] = tmp2[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BT / 8; ++ks) {
      uint32_t ah[4], al[4], ch[4], cl[4];
      f32_frag_a_perm(ah, al, A + 16 * m * lda + 8 * ks, lda, g, t);
      if constexpr (TWO)
        f32_frag_a_perm(ch, cl, A2 + 16 * m * lda + 8 * ks, lda, g, t);
#pragma unroll
      for (int n = 0; n < NCW; ++n) {
        uint32_t bh[2], bl[2];
        f32_frag_b_perm(bh, bl, B + 8 * ks * ldb + 8 * n, ldb, g, t);
        mma3_tf32(tmp[n], ah, al, bh, bl);
        if constexpr (TWO) {
          f32_frag_b_perm(bh, bl, B2 + 8 * ks * ldb + 8 * n, ldb, g, t);
          mma3_tf32(tmp2[n], ch, cl, bh, bl);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NCW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[m][n][e] += tmp[n][e];
        if constexpr (TWO) acc2[m][n][e] += tmp2[n][e];
      }
  }
}

// One CTA of a cluster of the fp32 streaming backward at D >= FC_DIM: the
// dQ (DKV false) or dK and dV (DKV true) of FC_ROWS rows, over this CTA's
// D / CL columns of every operand and output.
template <int D, bool DKV>
__device__ __forceinline__ void fc_cta(const F32GradArgs& a, float* smem) {
  constexpr int CL = fc_cluster<D>(), DC = D / CL, R = FC_ROWS;
  constexpr int BT = fc_tile<D>(), LD = DC + 4, BTP = BT + 8, NT = BT / 8;
  constexpr int CG = f32_col_groups<DC>(), MG = F32_WARPS / CG;
  constexpr int MTW = R / 16 / MG, NCW = DC / CG / 8;
  constexpr int TILE = BT * LD, SLOT = 2 * TILE + 2 * BT, PART = R * BTP;
  static_assert(R / 16 * 2 == F32_WARPS && DC % 32 == 0 &&
                    MTW * MG * 16 == R && NCW * CG * 8 == DC,
                "plan");
  float* A1 = smem;
  float* A2 = A1 + R * LD;
  float* ring = A2 + R * LD;
  constexpr int XB = 2 * R * BT;  // floats of one CTA's partials
  float* recv = ring + 2 * SLOT;  // the peers' partials, slot by rank; then
  float* pds = recv;              // [X/P, Y/dS][R][BTP] over them
  float* ST = recv + fc_recv_floats(BT, CL);  // 2 fp32 rows of R
  __shared__ uint64_t xbar[2];  // landed: 1 arrival + the peers' bytes;
                                // freed: CL - 1 arrivals

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t rank = cluster_rank();
  const int b = blockIdx.z, h = blockIdx.y, r0 = (blockIdx.x / CL) * R;
  const int c0 = rank * DC;  // this CTA's first column
  const int nres = DKV ? a.Sk : a.Sq, nwalk = DKV ? a.Sq : a.Sk;
  const float* ra1 = (DKV ? head_ptr(a.k, a.sk, b, h) : head_ptr(a.q, a.sq, b, h)) + c0;
  const float* ra2 = (DKV ? head_ptr(a.v, a.sv, b, h) : head_ptr(a.dout, a.sdo, b, h)) + c0;
  const float* wa1 = (DKV ? head_ptr(a.q, a.sq, b, h) : head_ptr(a.k, a.sk, b, h)) + c0;
  const float* wa2 = (DKV ? head_ptr(a.dout, a.sdo, b, h) : head_ptr(a.v, a.sv, b, h)) + c0;
  const long rs1 = DKV ? a.sk.s : a.sq.s, rs2 = DKV ? a.sv.s : a.sdo.s;
  const long ws1 = DKV ? a.sq.s : a.sk.s, ws2 = DKV ? a.sdo.s : a.sv.s;
  const long rb = ((long)b * a.H + h) * a.Sq;  // row statistics of (b, h)
  const float* brow = a.bias ? a.bias + (long)b * a.Sk : nullptr;
  const int njobs = (nwalk + BT - 1) / BT;

  // walked tile i into slot i % 2: its two tiles and its fp32 rows (dK/dV:
  // the queries' lse and delta; dQ: the keys' bias)
  auto issue = [&](int i) {
    float* sl = ring + (i & 1) * SLOT;
    f32_load_tile<DC, BT>(sl, wa1, ws1, i * BT, nwalk, tid, a.hd - c0);
    f32_load_tile<DC, BT>(sl + TILE, wa2, ws2, i * BT, nwalk, tid,
                          a.hd - c0);
    float* rows = sl + 2 * TILE;
    if constexpr (DKV) {
      load_row_f32<BT, F32_THREADS>(rows, a.s0 + rb, i * BT, a.Sq, tid);
      load_row_f32<BT, F32_THREADS>(rows + BT, a.s2 + rb, i * BT, a.Sq, tid);
    } else {
      if (brow) load_row_f32<BT, F32_THREADS>(rows, brow, i * BT, a.Sk, tid);
    }
    ring_commit();
  };

  // the resident pair and its fp32 rows (dQ: the rows' lse and delta;
  // dK/dV: the keys' bias) ride in job 0's group
  f32_load_tile<DC, R>(A1, ra1, rs1, r0, nres, tid, a.hd - c0);
  f32_load_tile<DC, R>(A2, ra2, rs2, r0, nres, tid, a.hd - c0);
  if constexpr (DKV) {
    if (brow) load_row_f32<R, F32_THREADS>(ST, brow, r0, a.Sk, tid);
  } else {
    load_row_f32<R, F32_THREADS>(ST, a.s0 + rb, r0, a.Sq, tid);
    load_row_f32<R, F32_THREADS>(ST + R, a.s2 + rb, r0, a.Sq, tid);
  }
  issue(0);
  if (tid == 0) {
    mbar_init(xbar, 1);
    mbar_init(xbar + 1, CL - 1);
    mbar_fence_init();
  }
  __syncthreads();
  cluster_arrive();
  cluster_wait();  // every CTA of the cluster runs, its mbarriers set up
  // this CTA's slot in the CTA of rank q: ranks in order, q's own left out
  uint32_t prec[CL], pland[CL], pfree[CL];
#pragma unroll
  for (int q = 0; q < CL; ++q) {
    const int slot = (int)rank < q ? rank : rank - 1;
    prec[q] = peer_addr(recv + slot * XB, q);
    pland[q] = peer_addr(xbar, q);
    pfree[q] = peer_addr(xbar + 1, q);
  }

  float acc[MTW][NCW][4], acc2[MTW][NCW][4];
#pragma unroll
  for (int m = 0; m < MTW; ++m)
#pragma unroll
    for (int n = 0; n < NCW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = acc2[m][n][e] = 0.f;
  // step 1: warps 0-3 X of m tile `mt`, warps 4-7 Y; step 3: columns
  // [col, col + DC / CG) of rows 16 mg MTW..
  const int xy = warp / 4, mt = warp % 4;
  const int mg = warp / CG, col = (warp % CG) * (DC / CG);

  for (int i = 0; i < njobs; ++i) {
    ring_wait_upto(0);
    __syncthreads();  // tile i has landed; tile i - 1's slot, P and dS free
    if (tid == 0) {
      if (i > 0) {  // the peers may push tile i into this CTA
#pragma unroll
        for (int q = 0; q < CL; ++q) {
          if (q != (int)rank) mbar_arrive_remote(pfree[q]);
        }
      }
      mbar_expect(xbar, (CL - 1) * XB * 4);
    }
    if (i + 1 < njobs) issue(i + 1);
    const float* sl = ring + (i & 1) * SLOT;
    const float* rows = sl + 2 * TILE;
    float x[NT][4];
    {
      float big[NT][4], small[NT][4];
      f32_scores<NT, DC / 8>(big, small, (xy ? A2 : A1) + 16 * mt * LD,
                             sl + xy * TILE, LD, g, t);
#pragma unroll
      for (int nb = 0; nb < NT; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[nb][e] = big[nb][e] + small[nb][e];
    }
    if (i > 0) mbar_wait_cluster(xbar + 1, (i - 1) & 1);  // peers' slots free
#pragma unroll
    for (int q = 0; q < CL; ++q) {
      if (q != (int)rank) {
#pragma unroll
        for (int nb = 0; nb < NT; ++nb)
          st_async_v4(prec[q] + 16 * (nb * F32_THREADS + tid), x[nb],
                      pland[q]);
      }
    }
    mbar_wait_cluster(xbar, i & 1);  // the peers' partials of tile i
    float s[NT][4];
#pragma unroll
    for (int q = 0; q < CL; ++q) {
#pragma unroll
      for (int nb = 0; nb < NT; ++nb) {
        float v[4];
        if (q == (int)rank) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = x[nb][e];
        } else {
          const float4 w = *reinterpret_cast<const float4*>(
              recv + (q < (int)rank ? q : q - 1) * XB +
              4 * (nb * F32_THREADS + tid));
          v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = q == 0 ? v[e] : s[nb][e] + v[e];
      }
    }
    __syncthreads();  // the slots are read
    {
      float* p = pds + xy * PART + (16 * mt + g) * BTP + 2 * t;
#pragma unroll
      for (int nb = 0; nb < NT; ++nb) {
        *reinterpret_cast<float2*>(p + 8 * nb) = make_float2(s[nb][0], s[nb][1]);
        *reinterpret_cast<float2*>(p + 8 * BTP + 8 * nb) =
            make_float2(s[nb][2], s[nb][3]);
      }
    }
    __syncthreads();
    // step 2: P and dS over the summed X and Y, in place
    for (int e = tid; e < R * BT / 4; e += F32_THREADS) {
      const int r = e / (BT / 4), c = 4 * (e % (BT / 4));
      const float4 x = *reinterpret_cast<const float4*>(pds + r * BTP + c);
      const float4 y =
          *reinterpret_cast<const float4*>(pds + PART + r * BTP + c);
      const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = ds[j] = 0.f;
        if (i * BT + c + j < nwalk) {
          if constexpr (DKV) {
            p[j] = stream_p(xs[j], a.scale, brow ? ST[r] : 0.f, rows[c + j],
                            a.keyless);
            ds[j] = p[j] * (ys[j] - rows[BT + c + j]);
          } else {
            p[j] = stream_p(xs[j], a.scale, brow ? rows[c + j] : 0.f, ST[r],
                            a.keyless);
            ds[j] = p[j] * (ys[j] - ST[R + r]);
          }
        }
      }
      if constexpr (DKV)
        *reinterpret_cast<float4*>(pds + r * BTP + c) =
            make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(pds + PART + r * BTP + c) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    // step 3: dQ += dS.K, or dK += dS^T.Q and dV += P^T.dO
    fc_grad<MTW, NCW, BT, DKV>(acc, acc2, pds + PART + 16 * mg * MTW * BTP,
                               pds + 16 * mg * MTW * BTP, BTP, sl + col,
                               sl + TILE + col, LD, g, t);
  }
  // every push into this CTA and every arrival on its mbarriers has been
  // waited for

  float* o1;
  float* o2 = nullptr;
  long os1;
  if constexpr (DKV) {
    o1 = head_ptr(a.dk, a.sdk, b, h);
    os1 = a.sdk.s;
    o2 = head_ptr(a.dv, a.sdv, b, h);
  } else {
    o1 = head_ptr(a.dq, a.sdq, b, h);
    os1 = a.sdq.s;
  }
#pragma unroll
  for (int m = 0; m < MTW; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + 16 * (mg * MTW + m) + 8 * hf + g;
      if (row >= nres) continue;
#pragma unroll
      for (int n = 0; n < NCW; ++n) {
        const int c = c0 + col + 8 * n + 2 * t;
        if (c >= a.hd) continue;
        *reinterpret_cast<float2*>(o1 + (long)row * os1 + c) =
            make_float2(acc[m][n][2 * hf] * a.scale,
                        acc[m][n][2 * hf + 1] * a.scale);
        if constexpr (DKV)
          *reinterpret_cast<float2*>(o2 + (long)row * a.sdv.s + c) =
              make_float2(acc2[m][n][2 * hf], acc2[m][n][2 * hf + 1]);
      }
    }
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
stream_bwd_dq_f32_kernel(const F32GradArgs a) {
  extern __shared__ float4 sbf_smem[];
  if constexpr (D >= FC_DIM)
    fc_cta<D, false>(a, reinterpret_cast<float*>(sbf_smem));
  else
    f32_grad_cta<D, fg_rows<D, 1>(), fg_tile<D, 1>(), false>(
        a, reinterpret_cast<float*>(sbf_smem), blockIdx.x);
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
stream_bwd_dkv_f32_kernel(const F32GradArgs a) {
  extern __shared__ float4 sbf_smem[];
  if constexpr (D >= FC_DIM)
    fc_cta<D, true>(a, reinterpret_cast<float*>(sbf_smem));
  else
    f32_grad_cta<D, fg_rows<D, 2>(), fg_tile<D, 2>(), true>(
        a, reinterpret_cast<float*>(sbf_smem), blockIdx.x);
}

template <int D>
__global__ void __launch_bounds__(SD_THREADS)
stream_delta_f32_kernel(const float* __restrict__ dout,
                        const float* __restrict__ out,
                        float* __restrict__ delta, int H, int Sq, long rows,
                        Rows sdo, Rows so, int hd) {
  const long row = ((long)blockIdx.x * SD_THREADS + threadIdx.x) >> 3;
  const float acc =
      row_delta_f32<D>(dout, out, row, rows, H, Sq, sdo, so, hd);
  if (row < rows && (threadIdx.x & 7) == 0) delta[row] = acc;
}

// Takes only the plans flash_attention.py::_stream_bwd_f32_plan returns:
// below FC_DIM the gradient CTA's (cluster 1), from it the cluster CTA's.
template <int D, bool DKV>
int launch_stream_bwd_f32(const F32GradArgs& a, int B, int cluster,
                          int rows, int tile, int smem, cudaStream_t stream) {
  constexpr int NOUT = DKV ? 2 : 1;
  constexpr bool CLU = D >= FC_DIM;
  constexpr int CL = CLU ? fc_cluster<D>() : 1;
  constexpr int R = CLU ? FC_ROWS : fg_rows<D, NOUT>();
  constexpr int BT = CLU ? fc_tile<D>() : fg_tile<D, NOUT>();
  constexpr int SM = CLU ? fc_smem<D>() : fg_smem<D, NOUT>();
  if (cluster != CL || rows != R || tile != BT || smem != SM ||
      smem > SB_SMEM_MAX)
    return HV_BAD_PLAN;
  void (*kern)(F32GradArgs) =
      DKV ? stream_bwd_dkv_f32_kernel<D> : stream_bwd_dq_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((DKV ? a.Sk : a.Sq) + R - 1) / R * CL, a.H, B);
  cfg.blockDim = dim3(F32_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#ifndef HV_F16
int stream_bwd_f32(bool dkv, const void* q, const void* k, const void* v,
                   const float* bias, const void* dout, const float* lse,
                   const float* delta, void* dq, void* dk, void* dv, int B,
                   int H, int Sq, int Sk, int D, int cluster, int rows,
                   int tile, int smem, int full, float scale, const long* st,
                   void* stream) {
  F32GradArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.bias = bias;
  a.s0 = lse;
  a.s1 = nullptr;
  a.s2 = delta;
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  Rows* rs[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *rs[i] = Rows{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.nqb = 0;
  a.hd = D;
  a.scale = scale;
  a.keyless = full ? 1.f / Sk : 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HV_SBF(DD)                                                          \
  case DD:                                                                  \
    return dkv ? launch_stream_bwd_f32<DD, true>(a, B, cluster, rows, tile, \
                                                 smem, s)                     \
               : launch_stream_bwd_f32<DD, false>(a, B, cluster, rows, tile, \
                                                  smem, s);
  switch (stream_tile(D)) {
    HV_SBF(64)
    HV_SBF(128)
    HV_SBF(256)
    HV_SBF(512)
    HV_SBF(640)
    case -1: return -1;
    default:
      return launch_stream_bwd_wide<float>(
          dkv, wide_args(q, k, v, bias, dout, lse, delta, dq, dk, dv, H, Sq, Sk, D, scale, full, st),
          B, stream_tile(D), cluster, rows, tile, smem, s);
  }
#undef HV_SBF
}
#endif

template <int D>
int launch_delta_f32(const void* dout, const void* out, float* delta, int B,
                     int H, int Sq, int hd, const long* st,
                     cudaStream_t stream) {
  const long rows = (long)B * H * Sq;
  const long blocks = (rows * 8 + SD_THREADS - 1) / SD_THREADS;
  stream_delta_f32_kernel<D><<<(unsigned)blocks, SD_THREADS, 0, stream>>>(
      static_cast<const float*>(dout), static_cast<const float*>(out), delta,
      H, Sq, rows, Rows{st[0], st[1], st[2]}, Rows{st[3], st[4], st[5]}, hd);
  return cudaGetLastError();
}

}  // namespace hv

// Plain C entry points. `strides` holds 21 element strides: (batch, head,
// row) for q, k, v, dout, dq, dk and dv in that order (the dQ kernel writes
// dq only, the dK/dV kernel dk and dv); the last dimension of each is
// contiguous. D is the head dim, any multiple of 8 up to 2048: the kernels
// run the tile width hv::stream_tile(D) (past 640 a multiple of 256, on the
// wide kernels; columns past D read as zeros, never stored). `lse` and
// `delta` are contiguous (B, H, Sq) fp32; `bias` is null or a contiguous
// (B, Sk) fp32 key bias. `cluster`, `stages` and `smem` are the launch
// plan of flash_attention.py::_stream_bwd_plan at the tile width. `full`
// non-zero gives a row with no real key (its LSE at the -1e30 mask's
// level) the full-block kernels' P = 1 / Sk on every key (stream_p): the
// caller's choice, where the JAX rule would run its full-block kernel. hv_stream_delta: `strides` holds 6, (batch, head, row)
// of dout and out; writes a contiguous (B, H, Sq) fp32 `delta`. Each
// returns a cudaError_t, -1 for an unsupported head dim, -2 for a plan the
// kernel does not take. Built with -DHV_F16 the tensors are fp16 and the
// fp32 entry points are left out.
extern "C" int hv_stream_bwd_dq(const void* q, const void* k, const void* v,
                                const float* bias, const void* dout,
                                const float* lse, const float* delta,
                                void* dq, int B, int H, int Sq, int Sk, int D,
                                int cluster, int stages, int smem, int full,
                                float scale, const long* strides,
                                void* stream) {
  return hv::stream_bwd(false, q, k, v, bias, dout, lse, delta, dq, nullptr,
                        nullptr, B, H, Sq, Sk, D, cluster, stages, smem, full,
                        scale, strides, stream);
}

extern "C" int hv_stream_bwd_dkv(const void* q, const void* k, const void* v,
                                 const float* bias, const void* dout,
                                 const float* lse, const float* delta,
                                 void* dk, void* dv, int B, int H, int Sq,
                                 int Sk, int D, int cluster, int stages,
                                 int smem, int full, float scale,
                                 const long* strides, void* stream) {
  return hv::stream_bwd(true, q, k, v, bias, dout, lse, delta, nullptr, dk,
                        dv, B, H, Sq, Sk, D, cluster, stages, smem, full,
                        scale, strides, stream);
}

extern "C" int hv_stream_delta(const void* dout, const void* out,
                               float* delta, int B, int H, int Sq, int D,
                               const long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hv::stream_tile(D)) {
    case 64: return hv::launch_delta<64>(dout, out, delta, B, H, Sq, D, strides, s);
    case 128: return hv::launch_delta<128>(dout, out, delta, B, H, Sq, D, strides, s);
    case 256: return hv::launch_delta<256>(dout, out, delta, B, H, Sq, D, strides, s);
    case 512: return hv::launch_delta<512>(dout, out, delta, B, H, Sq, D, strides, s);
    case 640: return hv::launch_delta<640>(dout, out, delta, B, H, Sq, D, strides, s);
    case -1: return -1;
    default: return hv::launch_delta<2048>(dout, out, delta, B, H, Sq, D, strides, s);
  }
}

#ifndef HV_F16
// fp32 entry points, as hv_stream_bwd_dq, hv_stream_bwd_dkv and
// hv_stream_delta with fp32 tensors; `cluster`, `rows`, `tile` and `smem`
// are the dQ or dK/dV plan of flash_attention.py::_stream_bwd_f32_plan at
// the tile width.
extern "C" int hv_stream_bwd_dq_f32(const void* q, const void* k,
                                    const void* v, const float* bias,
                                    const void* dout, const float* lse,
                                    const float* delta, void* dq, int B,
                                    int H, int Sq, int Sk, int D, int cluster,
                                    int rows, int tile, int smem, int full,
                                    float scale, const long* strides,
                                    void* stream) {
  return hv::stream_bwd_f32(false, q, k, v, bias, dout, lse, delta, dq,
                            nullptr, nullptr, B, H, Sq, Sk, D, cluster, rows,
                            tile, smem, full, scale, strides, stream);
}

extern "C" int hv_stream_bwd_dkv_f32(const void* q, const void* k,
                                     const void* v, const float* bias,
                                     const void* dout, const float* lse,
                                     const float* delta, void* dk, void* dv,
                                     int B, int H, int Sq, int Sk, int D,
                                     int cluster, int rows, int tile,
                                     int smem, int full, float scale,
                                     const long* strides, void* stream) {
  return hv::stream_bwd_f32(true, q, k, v, bias, dout, lse, delta, nullptr,
                            dk, dv, B, H, Sq, Sk, D, cluster, rows, tile,
                            smem, full, scale, strides, stream);
}

extern "C" int hv_stream_delta_f32(const void* dout, const void* out,
                                   float* delta, int B, int H, int Sq, int D,
                                   const long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hv::stream_tile(D)) {
    case 64: return hv::launch_delta_f32<64>(dout, out, delta, B, H, Sq, D, strides, s);
    case 128: return hv::launch_delta_f32<128>(dout, out, delta, B, H, Sq, D, strides, s);
    case 256: return hv::launch_delta_f32<256>(dout, out, delta, B, H, Sq, D, strides, s);
    case 512: return hv::launch_delta_f32<512>(dout, out, delta, B, H, Sq, D, strides, s);
    case 640: return hv::launch_delta_f32<640>(dout, out, delta, B, H, Sq, D, strides, s);
    case -1: return -1;
    default: return hv::launch_delta_f32<2048>(dout, out, delta, B, H, Sq, D, strides, s);
  }
}
#endif

extern "C" const char* hv_stream_bwd_error_string(int code) {
  if (code == -1) return "unsupported head dim";
  if (code == hv::HV_BAD_PLAN) return "launch plan not taken by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
