// K1: the general 5-point stencil on a (rows, cols) block, for Hopper (sm_90a).
//
//   y(i,j) = c0·x(i,j) + cw·x(i,j−1) + ce·x(i,j+1) + cs·x(i−1,j) + cn·x(i+1,j)
//
// with zeros outside the block, except that row −1 is read from `top` and row
// `rows` from `bot` when those pointers are not null (a null pointer is a zero
// row — the Dirichlet boundary).
//
// Replaces the Pallas kernels `_halo_kernel` (gmres_tpu/ops/stencil.py,
// behind stencil_5pt_pallas_halo / stencil_5pt_pallas) and `_blocked_kernel`
// (behind stencil_5pt_pallas_blocked). The TPU versions cut the grid into
// row blocks with 8-row halo windows because of Mosaic's (8, 128) sublane
// tiling and VMEM size; neither constraint exists here, so one launch covers
// any (rows, cols).
//
// What bounds it: memory. Each point does 9 flops against one read and one
// write of its own value (the four neighbour reads hit L1/L2, since
// neighbouring threads own neighbouring points), i.e. ~1.1 flop/byte in
// float32 and ~0.56 in float64 — an order of magnitude and more under the
// card's balance point (~20 flop/byte for non-tensor-core float32). The
// design therefore only has to stream: one thread per point, 32 consecutive
// columns per warp so every load and store is coalesced, no shared memory.
//
// Rounding: the sum is evaluated in the order of the plain PyTorch version
// (c0·x + cw·W + ce·E + cs·S + cn·N, left to right) and the library is built
// with -fmad=false, so each product and sum rounds exactly as the separate
// PyTorch elementwise operations do.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <typename T>
__global__ void stencil5_kernel(const T* __restrict__ x,
                                const T* __restrict__ top,
                                const T* __restrict__ bot,
                                T* __restrict__ y, int rows, int cols,
                                T c0, T cw, T ce, T cs, T cn) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= rows || j >= cols) return;
  const long long idx = (long long)i * cols + j;
  const T zero = T(0);
  const T xc = x[idx];
  const T w = j > 0 ? x[idx - 1] : zero;
  const T e = j + 1 < cols ? x[idx + 1] : zero;
  const T s = i > 0 ? x[idx - cols] : (top != nullptr ? top[j] : zero);
  const T n = i + 1 < rows ? x[idx + cols] : (bot != nullptr ? bot[j] : zero);
  y[idx] = c0 * xc + cw * w + ce * e + cs * s + cn * n;
}

template <typename T>
int launch(const T* x, const T* top, const T* bot, T* y, int rows, int cols,
           T c0, T cw, T ce, T cs, T cn, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((cols + kBlockX - 1) / kBlockX, (rows + kBlockY - 1) / kBlockY);
  stencil5_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      x, top, bot, y, rows, cols, c0, cw, ce, cs, cn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gt_stencil5_f32(const float* x, const float* top, const float* bot, float* y,
                    int rows, int cols, float c0, float cw, float ce, float cs,
                    float cn, int device, void* stream) {
  return launch<float>(x, top, bot, y, rows, cols, c0, cw, ce, cs, cn, device,
                       stream);
}

int gt_stencil5_f64(const double* x, const double* top, const double* bot,
                    double* y, int rows, int cols, double c0, double cw,
                    double ce, double cs, double cn, int device, void* stream) {
  return launch<double>(x, top, bot, y, rows, cols, c0, cw, ce, cs, cn, device,
                        stream);
}

const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
