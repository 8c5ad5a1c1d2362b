// K7: the fused CG update and the fused axpy-dot, for Hopper (sm_90a).
//
//   K7a  gt_cg_update:  xo = x + α·p,  ro = r − α·ap,  sum = Σ f32(ro)²
//   K7b  gt_axpy_dot:   yo = y + α·x,  sum = Σ f32(yo)·f32(z)
//
// The elementwise work is in the input dtype; the products and the sum are in
// float32 and the sum is returned as a float32 scalar, the contract of the JAX
// kernels (the f32 casts and the (1, 1) float32 out_shape). α is read from
// device memory, so a caller whose α was computed on the card needs no host
// read.
//
// Replaces the Pallas kernels `_cg_update_kernel` (behind cg_fused_update) and
// `_axpy_dot_kernel` (behind axpy_dot), gmres_tpu/ops/fused.py. The TPU
// kernels are one whole-block VMEM pass whose sum is one scalar accumulator.
// Blocks on Hopper run in parallel and in no order, so the sum takes two
// launches: a grid-stride pass in which each block writes its float32 partial
// (warp shuffles, then one warp over the warps' sums), then one block that sums
// the partials. The grid is a function of n alone and every sum runs in a
// fixed order, with no atomics: repeated calls give the same bits.
//
// What bounds it: memory. K7a moves six vectors (four read, two written), K7b
// four (three read, one written), at 3–4 flops a point: far under the card's
// balance point. The pass streams with one element a thread per step,
// consecutive threads on consecutive addresses; the grid is capped at
// kMaxBlocks blocks of kThreads (~2 blocks an SM's worth of threads), so the
// second launch reads at most 4 KB.
//
// C interface (ctypes): returns cudaGetLastError() after the second launch
// (or the first error).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kSumThreads = 1024;

int reduce_blocks(int n) {
  const int per_block = kThreads * 4;
  int b = (n + per_block - 1) / per_block;
  if (b < 1) b = 1;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

// Sum of v over the block, valid in thread 0. Fixed order: shuffles down
// within each warp, then warp 0 over the warps' sums.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void cg_update_kernel(const T* __restrict__ x, const T* __restrict__ r,
                                 const T* __restrict__ p, const T* __restrict__ ap,
                                 const T* __restrict__ alpha, T* __restrict__ xo,
                                 T* __restrict__ ro, float* __restrict__ partial,
                                 int n) {
  const T a = *alpha;
  float acc = 0.0f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    xo[i] = x[i] + a * p[i];
    const T rn = r[i] - a * ap[i];
    ro[i] = rn;
    const float rf = (float)rn;
    acc += rf * rf;
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

template <typename T>
__global__ void axpy_dot_kernel(const T* __restrict__ alpha, const T* __restrict__ x,
                                const T* __restrict__ y, const T* __restrict__ z,
                                T* __restrict__ yo, float* __restrict__ partial,
                                int n) {
  const T a = *alpha;
  float acc = 0.0f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const T yn = y[i] + a * x[i];
    yo[i] = yn;
    acc += (float)yn * (float)z[i];
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void sum_partials_kernel(const float* __restrict__ partial, int count,
                                    float* __restrict__ out) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) acc += partial[i];
  const float s = block_sum(acc);
  if (threadIdx.x == 0) *out = s;
}

int finish(const float* partial, int nblocks, float* out, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, kSumThreads, 0, stream>>>(partial, nblocks, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cg_update(const T* x, const T* r, const T* p, const T* ap,
                     const T* alpha, T* xo, T* ro, float* partial, float* out,
                     int n, int nblocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nblocks != reduce_blocks(n)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cg_update_kernel<T><<<nblocks, kThreads, 0, s>>>(x, r, p, ap, alpha, xo, ro,
                                                   partial, n);
  return finish(partial, nblocks, out, s);
}

template <typename T>
int launch_axpy_dot(const T* alpha, const T* x, const T* y, const T* z, T* yo,
                    float* partial, float* out, int n, int nblocks, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nblocks != reduce_blocks(n)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  axpy_dot_kernel<T><<<nblocks, kThreads, 0, s>>>(alpha, x, y, z, yo, partial, n);
  return finish(partial, nblocks, out, s);
}

}  // namespace

extern "C" {

int gt_fused_reduce_blocks(int n) { return reduce_blocks(n); }

int gt_cg_update_f32(const float* x, const float* r, const float* p,
                     const float* ap, const float* alpha, float* xo, float* ro,
                     float* partial, float* out, int n, int nblocks, int device,
                     void* stream) {
  return launch_cg_update<float>(x, r, p, ap, alpha, xo, ro, partial, out, n,
                                 nblocks, device, stream);
}

int gt_cg_update_f64(const double* x, const double* r, const double* p,
                     const double* ap, const double* alpha, double* xo,
                     double* ro, float* partial, float* out, int n, int nblocks,
                     int device, void* stream) {
  return launch_cg_update<double>(x, r, p, ap, alpha, xo, ro, partial, out, n,
                                  nblocks, device, stream);
}

int gt_axpy_dot_f32(const float* alpha, const float* x, const float* y,
                    const float* z, float* yo, float* partial, float* out,
                    int n, int nblocks, int device, void* stream) {
  return launch_axpy_dot<float>(alpha, x, y, z, yo, partial, out, n, nblocks,
                                device, stream);
}

int gt_axpy_dot_f64(const double* alpha, const double* x, const double* y,
                    const double* z, double* yo, float* partial, float* out,
                    int n, int nblocks, int device, void* stream) {
  return launch_axpy_dot<double>(alpha, x, y, z, yo, partial, out, n, nblocks,
                                 device, stream);
}

}  // extern "C"
