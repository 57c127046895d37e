// Rate of mma.sync m16n8k8 .tf32 (the fp32 kernels' TF32 products) and
// m16n8k16 .bf16 on the card: two blocks a SM, 8 or 16 warps a SM, each
// warp running 4096 x NACC products into NACC independent accumulators
// from registers, with no memory traffic; TFLOP/s from CUDA events.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o hivae_tpu_torch/build/mma_sync_rate scripts/mma_sync_rate.cu
//   hivae_tpu_torch/build/mma_sync_rate
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>

template <int NACC>
__global__ void tf32_tput(float* out, int iters) {
  float c[NACC][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + threadIdx.x * i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                     "r"(b[1]));
  }
  float s = 0;
  for (int j = 0; j < NACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int NACC>
__global__ void bf16_tput(float* out, int iters) {
  float c[NACC][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f803f80u + threadIdx.x * i;
  for (int i = 0; i < 2; ++i) b[i] = 0x3f003f00u + threadIdx.x * i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                     "r"(b[1]));
  }
  float s = 0;
  for (int j = 0; j < NACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename K>
void run(const char* name, K kern, int nacc, double flop_per_mma, int warps,
         int sms) {
  const int blocks = sms * 2, threads = 32 * warps / 2, iters = 4096;
  float* out;
  cudaMalloc(&out, blocks * threads * 4);
  kern<<<blocks, threads>>>(out, 16);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  kern<<<blocks, threads>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double flops = (double)blocks * threads / 32 * iters * nacc * flop_per_mma;
  printf("%s nacc %d warps/SM %d: %.3f ms, %.1f TFLOP/s\n", name, nacc, warps,
         ms, flops / ms / 1e9);
  cudaFree(out);
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "mma_sync_rate: no CUDA device\n");
    return 2;
  }
  printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  for (int w : {8, 16}) {
    run("tf32 m16n8k8", tf32_tput<1>, 1, 2048, w, prop.multiProcessorCount);
    run("tf32 m16n8k8", tf32_tput<2>, 2, 2048, w, prop.multiProcessorCount);
    run("tf32 m16n8k8", tf32_tput<4>, 4, 2048, w, prop.multiProcessorCount);
    run("tf32 m16n8k8", tf32_tput<8>, 8, 2048, w, prop.multiProcessorCount);
    run("bf16 m16n8k16", bf16_tput<8>, 8, 4096, w, prop.multiProcessorCount);
  }
  return 0;
}
