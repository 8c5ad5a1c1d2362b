// K8: the per-shard affine 5-point stencil of the RDMA route, for Hopper
// (sm_90a), in two entry points that run in the TPU kernel's order:
//
//   interior:  y(i,j) = a·x(i,j) + b·(c0·x(i,j) + cw·x(i,j−1) + ce·x(i,j+1)
//                                    + cs·x(i−1,j) + cn·x(i+1,j))
//              with ZERO halo rows (every term the block holds itself);
//   edges:     y(0,j)      += (b·cs)·top(j)
//              y(rows−1,j) += (b·cn)·bot(j)
//
// on a (rows, cols) block of a row-partitioned grid. (a, b) = (0, 1) is the
// plain stencil; (1/d + α, −α/d) is the degree-2 Chebyshev application cbpr2
// collapsed by linearity.
//
// Replaces the Pallas kernel `_rdma_halo_kernel`
// (gmres_tpu/ops/stencil_rdma.py:41, behind stencil_5pt_rdma). On the TPU the
// kernel itself starts two one-row remote DMAs to the neighbouring chips,
// computes the interior while they are in flight, waits on the receive
// semaphores and then corrects the two boundary rows. Remote copies from
// inside a kernel become NCCL point-to-point messages outside it here: the
// caller (gmres_tpu_torch/ops/stencil_rdma.py) posts the sends and receives,
// launches `interior` (NCCL's P2P runs on its own stream, so the interior
// overlaps the transfer), waits on the receives (a stream wait, no host
// sync) and launches `edges`. Rank 0's top row and the last rank's bottom
// row are zeros: the Dirichlet truncation. A design with the peers' stores
// issued from inside the kernel, over symmetric memory, needs several cards
// to measure it and is queued.
//
// What bounds it: memory. A point reads x once and writes y once (the
// neighbours' reads hit L1/L2) and does 12 flops: 1.5 flop/byte in float32.
// At 2048² float32 that is 33.6 MB, 10.0 µs at 3.35 TB/s; at 304² float32
// (the strong-scaling shard) 0.74 MB, 0.22 µs, so there the two launches
// bound it. One thread per point, 32 consecutive columns per warp, as K1;
// `edges` is one thread per column.
//
// Rounding: the sums in the plain version's order, (a, b) and the stencil
// coefficients rounded to the block's type on the host, b·cs and b·cn
// multiplied here in that type, -fmad=false: the target is bit-identity with
// the plain PyTorch version.
//
// C interface (ctypes): each entry returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kEdgeBlock = 256;

template <typename T>
__global__ void rdma_interior_kernel(const T* __restrict__ x,
                                     T* __restrict__ y, int rows, int cols,
                                     T c0, T cw, T ce, T cs, T cn, T a, T b) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= rows || j >= cols) return;
  const long long idx = (long long)i * cols + j;
  const T zero = T(0);
  const T xc = x[idx];
  const T w = j > 0 ? x[idx - 1] : zero;
  const T e = j + 1 < cols ? x[idx + 1] : zero;
  const T s = i > 0 ? x[idx - cols] : zero;
  const T n = i + 1 < rows ? x[idx + cols] : zero;
  y[idx] = a * xc + b * (c0 * xc + cw * w + ce * e + cs * s + cn * n);
}

// Row 0 first, then the last row, as the TPU kernel stores them: a one-row
// block takes both corrections in that order.
template <typename T>
__global__ void rdma_edges_kernel(T* __restrict__ y, const T* __restrict__ top,
                                  const T* __restrict__ bot, int rows, int cols,
                                  T b, T cs, T cn) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  const long long last = (long long)(rows - 1) * cols + j;
  y[j] = y[j] + (b * cs) * top[j];
  y[last] = y[last] + (b * cn) * bot[j];
}

template <typename T>
int interior(const T* x, T* y, int rows, int cols, T c0, T cw, T ce, T cs,
             T cn, T a, T b, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((cols + kBlockX - 1) / kBlockX, (rows + kBlockY - 1) / kBlockY);
  rdma_interior_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      x, y, rows, cols, c0, cw, ce, cs, cn, a, b);
  return (int)cudaGetLastError();
}

template <typename T>
int edges(T* y, const T* top, const T* bot, int rows, int cols, T b, T cs,
          T cn, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rdma_edges_kernel<T><<<(cols + kEdgeBlock - 1) / kEdgeBlock, kEdgeBlock, 0,
                         (cudaStream_t)stream>>>(y, top, bot, rows, cols, b, cs,
                                                 cn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gt_rdma_interior_f32(const float* x, float* y, int rows, int cols, float c0,
                         float cw, float ce, float cs, float cn, float a,
                         float b, int device, void* stream) {
  return interior<float>(x, y, rows, cols, c0, cw, ce, cs, cn, a, b, device,
                         stream);
}

int gt_rdma_interior_f64(const double* x, double* y, int rows, int cols,
                         double c0, double cw, double ce, double cs, double cn,
                         double a, double b, int device, void* stream) {
  return interior<double>(x, y, rows, cols, c0, cw, ce, cs, cn, a, b, device,
                          stream);
}

int gt_rdma_edges_f32(float* y, const float* top, const float* bot, int rows,
                      int cols, float b, float cs, float cn, int device,
                      void* stream) {
  return edges<float>(y, top, bot, rows, cols, b, cs, cn, device, stream);
}

int gt_rdma_edges_f64(double* y, const double* top, const double* bot, int rows,
                      int cols, double b, double cs, double cn, int device,
                      void* stream) {
  return edges<double>(y, top, bot, rows, cols, b, cs, cn, device, stream);
}

}  // extern "C"
