// Rate of TF32 wgmma (m64nNk8 .tf32, the fp32 full-block kernels'
// products) on the card, as those kernels issue it: one block a SM of one
// or two warpgroups, each warpgroup issuing groups of 4 k steps x 3
// products (two into one accumulator, one into another, as a score
// product's small and big sums), committing and waiting for each group;
// SS reads A (64 x 32 floats) and B (N x 32 floats) from 128-byte-swizzled
// shared memory, RS reads A from registers. No global memory traffic;
// TFLOP/s from CUDA events, 2 x 64 x N x 8 operations a wgmma.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o hivae_tpu_torch/build/wgmma_tf32_rate scripts/wgmma_tf32_rate.cu
//   hivae_tpu_torch/build/wgmma_tf32_rate
#include <cstdio>

#include "../hivae_tpu_torch/csrc/attn_common.cuh"

using namespace hv;

template <int N, bool RS>
__global__ void wgmma_tput(float* out, int iters) {
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* base = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  float* f = reinterpret_cast<float*>(base);
  for (int i = threadIdx.x; i < (64 + N) * 32; i += blockDim.x)
    f[i] = 1e-3f * (i % 7);
  fence_async_smem();
  __syncthreads();
  const unsigned char* A = base;
  const unsigned char* B = base + 64 * 128;
  float d0[N / 2], d1[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) d0[e] = d1[e] = 0.f;
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  for (int it = 0; it < iters; ++it) {
    fence_regs(d0);
    fence_regs(d1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_sw128(B + kk * 32);
      if constexpr (RS) {
        wgmma_tf32_rs<N>(d0, a, db, 1);
        wgmma_tf32_rs<N>(d0, a, db, 1);
        wgmma_tf32_rs<N>(d1, a, db, 1);
      } else {
        const uint64_t da = desc_sw128(A + kk * 32);
        wgmma_tf32_ss<N>(d0, da, db, 1);
        wgmma_tf32_ss<N>(d0, da, db, 1);
        wgmma_tf32_ss<N>(d1, da, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(d0);
    fence_regs(d1);
  }
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < N / 2; ++e) s += d0[e] + d1[e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int N, bool RS>
void run(int wgs, int sms) {
  const int threads = 128 * wgs, iters = 4096;
  const int smem = 1024 + (64 + N) * 128;
  auto kern = wgmma_tput<N, RS>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  float* out;
  cudaMalloc(&out, sms * threads * 4);
  kern<<<sms, threads, smem>>>(out, 16);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  kern<<<sms, threads, smem>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  const double flop = 2.0 * 64 * N * 8 * 12.0 * iters * wgs * sms;
  printf("%s m64n%dk8, %d warpgroup(s) a SM: %.1f TFLOP/s (%s)\n",
         RS ? "RS" : "SS", N, wgs, flop / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  for (int wgs = 1; wgs <= 2; ++wgs) {
    run<16, false>(wgs, sms);
    run<32, false>(wgs, sms);
    run<64, false>(wgs, sms);
    run<32, true>(wgs, sms);
    run<48, true>(wgs, sms);
    run<64, true>(wgs, sms);
    run<128, true>(wgs, sms);
  }
  return 0;
}
