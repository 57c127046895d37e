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
// Design. The per-row scale is the abs-max over all N = 4096 GELU outputs of
// the row, so no output tile can be quantised before its row is finished,
// and a 32-row fp32 row block (512 KB) does not fit one SM's shared memory.
// One CTA of 4 warps owns 32 rows and makes two passes over N inside the
// launch: pass 1 computes GEMM + dequant + GELU tile by tile and keeps only
// the running row abs-max; pass 2 recomputes every tile and writes int8.
// That doubles the tensor-core work (4*M*K*N operations instead of 2*M*K*N)
// in exchange for never writing the GELU output; a cluster that reduces the
// row maximum through distributed shared memory is the later alternative.
// The CTA's 32 x K int8 rows of xq are loaded into shared memory once and
// serve both passes; the weight streams through a two-stage cp.async ring of
// 128 (n) x 128 (k) byte chunks, one chunk loading while the previous one
// feeds the tensor cores (mma.sync m16n8k32 s8 x s8 -> s32, fragments from
// shared memory, rows padded by 16 bytes so fragment loads are free of bank
// conflicts). Each warp owns 32 of the tile's 128 columns for all 32 rows.
// The dequant and the GELU are spelled out with __fmul_rn/__fadd_rn, so each
// operation rounds as the plain version's separate PyTorch operations do (no
// fused multiply-add), with the precise tanhf: the kernel gives the plain
// version's bits. A one-ulp difference would move a value on a rounding edge
// of the int8 grid by a step, and an int8 network carries such a flip on
// through every later layer's activation grid.
//
// Bound on the H100 SXM: 2*M*K*N int8 operations at 1979 TOP/s against
// M*K + K*N + M*N + 8*M + 8*N bytes at 3.35 TB/s. At K = 1024, N = 4096 and
// the path's M of 4096, 4256 and 8192 that is 0.017, 0.018 and 0.035 ms of
// tensor time against 0.007-0.013 ms of memory time: bound by operations.
// This kernel does twice the operations, on mma.sync rather than wgmma, and
// every CTA re-reads the whole weight from L2 in each pass; wgmma with TMA
// and a cluster-wide row maximum are later work.
#include "attn_common.cuh"

namespace hv {

constexpr int QF_BM = 32;             // rows per CTA
constexpr int QF_BN = 128;            // columns per N tile (4 warps x 32)
constexpr int QF_BK = 128;            // contraction bytes per weight chunk
constexpr int QF_THREADS = 128;
constexpr int QF_WLD = QF_BK + 16;    // weight chunk row stride, bytes
constexpr int QF_WCHUNK = QF_BN * QF_WLD;

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32s8(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (m16n8k32, s8) of rows [r0, r0+16), bytes [c0, c0+32) of a
// row-major shared tile: reg0 = (row g, k 4t..4t+3), reg1 = (row g+8, same),
// reg2 = (row g, k 16+4t..), reg3 = (row g+8, k 16+4t..).
__device__ __forceinline__ void load_a8(uint32_t a[4], const int8_t* T, int ld,
                                        int r0, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int8_t* p = T + (r0 + g) * ld + c0 + 4 * t;
  a[0] = ld32s8(p);
  a[1] = ld32s8(p + 8 * ld);
  a[2] = ld32s8(p + 16);
  a[3] = ld32s8(p + 8 * ld + 16);
}

// B fragment with B(k, n) = T[n0 + n][k0 + k] (the weight stored (N, K)):
// reg0 = (k 4t..4t+3, col g), reg1 = (k 16+4t.., col g).
__device__ __forceinline__ void load_b8(uint32_t b[2], const int8_t* T, int ld,
                                        int n0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int8_t* p = T + (n0 + g) * ld + k0 + 4 * t;
  b[0] = ld32s8(p);
  b[1] = ld32s8(p + 16);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

__device__ __forceinline__ int8_t requant(float y, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f);
  return static_cast<int8_t>(q);
}

__global__ void __launch_bounds__(QF_THREADS)
quant_ffn_up_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                    const int8_t* __restrict__ w, const float* __restrict__ ws,
                    const float* __restrict__ bias, int8_t* __restrict__ yq,
                    float* __restrict__ sy, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ald = K + 16;
  int8_t* As = reinterpret_cast<int8_t*>(smem_raw);   // QF_BM x ald
  int8_t* Ws = As + QF_BM * ald;                        // 2 x QF_WCHUNK
  float* red = reinterpret_cast<float*>(Ws + 2 * QF_WCHUNK);  // 4 x QF_BM
  float* srow = red + 4 * QF_BM;                        // QF_BM

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * QF_BM;
  const int kc_n = K / QF_BK, nt_n = N / QF_BN;
  const int per_pass = nt_n * kc_n, total = 2 * per_pass;

  // this CTA's rows of xq, once (rows past M are zero-filled)
  const int vpr = K / 16;
  for (int i = tid; i < QF_BM * vpr; i += QF_THREADS) {
    const int r = i / vpr, c = (i % vpr) * 16;
    const bool valid = row0 + r < M;
    cp_async16(As + r * ald + c, xq + (valid ? (long)(row0 + r) * K + c : 0),
               valid);
  }
  cp_async_commit();

  // weight chunk c (either pass) into ring slot `slot`
  auto load_w = [&](int c, int slot) {
    const int within = c % per_pass;
    const int n0 = (within / kc_n) * QF_BN, k0 = (within % kc_n) * QF_BK;
    int8_t* dst = Ws + slot * QF_WCHUNK;
#pragma unroll
    for (int it = 0; it < QF_BN * (QF_BK / 16) / QF_THREADS; ++it) {
      const int i = tid + it * QF_THREADS;
      const int r = i / (QF_BK / 16), cc = (i % (QF_BK / 16)) * 16;
      cp_async16(dst + r * QF_WLD + cc, w + (long)(n0 + r) * K + k0 + cc, true);
    }
    cp_async_commit();
  };

  // rows of this lane: (mt, h) -> mt * 16 + g + 8 * h
  float sxr[2][2], srq[2][2], rmax[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + mt * 16 + g + 8 * h;
      sxr[mt][h] = r < M ? sx[r] : 0.f;
      srq[mt][h] = 1.f;
      rmax[mt][h] = 0.f;
    }

  int acc[2][4][4];
  load_w(0, 0);
  for (int c = 0; c < total; ++c) {
    const int slot = c & 1;
    if (c + 1 < total) {
      load_w(c + 1, slot ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int within = c % per_pass;
    const int kc = within % kc_n, n0 = (within / kc_n) * QF_BN;
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
    }
    const int8_t* Wc = Ws + slot * QF_WCHUNK;
#pragma unroll
    for (int ks = 0; ks < QF_BK / 32; ++ks) {
      uint32_t a[2][4];
      load_a8(a[0], As, ald, 0, kc * QF_BK + ks * 32, lane);
      load_a8(a[1], As, ald, 16, kc * QF_BK + ks * 32, lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t b[2];
        load_b8(b, Wc, QF_WLD, warp * 32 + nt * 8, ks * 32, lane);
        mma_s8(acc[0][nt], a[0], b);
        mma_s8(acc[1][nt], a[1], b);
      }
    }
    __syncthreads();  // the next iteration's load overwrites this slot
    if (kc != kc_n - 1) continue;

    // epilogue of one finished (32 x 128) tile
    const bool second = c >= per_pass;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + warp * 32 + nt * 8 + 2 * t;
      const float w0 = ws[col], w1 = ws[col + 1];
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y0 = ffn_act(acc[mt][nt][2 * h],
                                   __fmul_rn(sxr[mt][h], w0), b0);
          const float y1 = ffn_act(acc[mt][nt][2 * h + 1],
                                   __fmul_rn(sxr[mt][h], w1), b1);
          if (!second) {
            rmax[mt][h] = fmaxf(rmax[mt][h], fmaxf(fabsf(y0), fabsf(y1)));
          } else {
            const int r = row0 + mt * 16 + g + 8 * h;
            if (r < M) {
              char2 v;
              v.x = requant(y0, srq[mt][h]);
              v.y = requant(y1, srq[mt][h]);
              *reinterpret_cast<char2*>(yq + (long)r * N + col) = v;
            }
          }
        }
    }
    if (c == per_pass - 1) {
      // end of pass 1: reduce the row maxima over the quad, then the warps
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m = quad_max(rmax[mt][h]);
          if (t == 0) red[warp * QF_BM + mt * 16 + g + 8 * h] = m;
        }
      __syncthreads();
      if (tid < QF_BM) {
        const float m = fmaxf(fmaxf(red[tid], red[QF_BM + tid]),
                              fmaxf(red[2 * QF_BM + tid], red[3 * QF_BM + tid]));
        const float s = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
        srow[tid] = s;
        if (row0 + tid < M) sy[row0 + tid] = s;
      }
      __syncthreads();
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) srq[mt][h] = srow[mt * 16 + g + 8 * h];
    }
  }
}

size_t quant_ffn_smem(int K) {
  return (size_t)QF_BM * (K + 16) + 2 * QF_WCHUNK + 5 * QF_BM * sizeof(float);
}

}  // namespace hv

// Plain C entry point: xq (M, K) int8, sx (M) fp32, w8 (N, K) int8, ws (N)
// and bias (N) fp32, all contiguous; writes yq (M, N) int8 and sy (M) fp32.
// Returns a cudaError_t, -1 when K or N is not a multiple of 128, -2 when
// the CTA's K-wide rows do not fit shared memory.
extern "C" int hv_quant_ffn_up(const void* xq, const void* sx, const void* w8,
                               const void* ws, const void* bias, void* yq,
                               void* sy, int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % hv::QF_BK || N % hv::QF_BN) return -1;
  const size_t smem = hv::quant_ffn_smem(K);
  if (smem > 232448) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      hv::quant_ffn_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + hv::QF_BM - 1) / hv::QF_BM);
  hv::quant_ffn_up_kernel<<<grid, hv::QF_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w8), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<int8_t*>(yq),
      static_cast<float*>(sy), M, K, N);
  return cudaGetLastError();
}

extern "C" const char* hv_quant_ffn_error_string(int code) {
  if (code == -1) return "K and N must be positive multiples of 128";
  if (code == -2) return "K too large: the CTA's rows of xq exceed shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
