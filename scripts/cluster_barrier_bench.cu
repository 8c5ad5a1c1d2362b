// What one barrier costs a CTA of an H100: __syncthreads against the
// thread-block-cluster barrier (cooperative_groups' cluster.sync(), and the
// split barrier.cluster arrive/wait that K2's cluster path uses), for
// clusters of 1 to 16 CTAs of 256 and 1024 threads. Each launch runs N
// iterations of one shared-memory update and one barrier; the cost of an
// iteration is the time of N = 1000 less that of N = 0, over 1000.
//
// Build and run on the machine with the card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o cluster_barrier_bench scripts/cluster_barrier_bench.cu
//   ./cluster_barrier_bench

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdio>

namespace cg = cooperative_groups;

enum Mode { kSyncthreads, kClusterSync, kSplit, kNone };

template <int MODE>
__global__ void __launch_bounds__(1024) loop_kernel(int iters, float* out) {
  __shared__ float buf[1024];
  cg::cluster_group cluster = cg::this_cluster();
  float acc = threadIdx.x;
  buf[threadIdx.x] = acc;
  for (int s = 0; s < iters; ++s) {
    acc += buf[(threadIdx.x + 1) & (blockDim.x - 1)];
    buf[threadIdx.x] = acc;
    if (MODE == kSyncthreads) {
      __syncthreads();
    } else if (MODE == kClusterSync) {
      cluster.sync();
    } else if (MODE == kSplit) {
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

// Microseconds per launch of `iters` iterations, over 20 launches.
template <int MODE>
float launch_us(int csize, int threads, int iters, float* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize);
  cfg.blockDim = dim3(threads);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaFuncSetAttribute(loop_kernel<MODE>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  for (int w = 0; w < 3; ++w) cudaLaunchKernelEx(&cfg, loop_kernel<MODE>, iters, out);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int k = 0; k < 20; ++k) cudaLaunchKernelEx(&cfg, loop_kernel<MODE>, iters, out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return ms / 20 * 1000.f;
}

template <int MODE>
void report(const char* name, int csize, int threads, float* out) {
  const float per_iter_ns = launch_us<MODE>(csize, threads, 1000, out) -
                            launch_us<MODE>(csize, threads, 0, out);
  const cudaError_t err = cudaGetLastError();
  printf("%-28s cluster %2d, %4d threads: %7.1f ns per iteration%s%s\n", name, csize,
         threads, per_iter_ns, err == cudaSuccess ? "" : "  error: ",
         err == cudaSuccess ? "" : cudaGetErrorString(err));
}

int main() {
  float* out = nullptr;
  if (cudaMalloc(&out, 16 * 1024 * sizeof(float)) != cudaSuccess) return 1;
  for (int threads : {256, 1024}) {
    report<kSyncthreads>("__syncthreads", 1, threads, out);
    report<kNone>("no barrier", 1, threads, out);
    for (int csize : {1, 2, 8, 16}) {
      report<kClusterSync>("cluster.sync()", csize, threads, out);
      report<kSplit>("barrier.cluster arrive+wait", csize, threads, out);
    }
  }
  cudaFree(out);
  return 0;
}
