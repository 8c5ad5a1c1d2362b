// K6: the float64-accurate 5-point stencil on (hi, lo) float32 pairs, for
// Hopper (sm_90a).
//
//   x      = (double)x_hi + (double)x_lo
//   y(i,j) = c0·x(i,j) + cw·x(i,j−1) + ce·x(i,j+1) + cs·x(i−1,j) + cn·x(i+1,j)
//   y_hi   = (float)y,   y_lo = (float)(y − (double)y_hi)
//
// in float64, with zeros outside the grid (the Dirichlet boundary).
//
// Replaces the Pallas kernels `_dd_blocked_kernel` (gmres_tpu/ops/stencil.py:388,
// behind stencil_5pt_dd_pallas_blocked: the Poisson coefficients) and
// `_dd_general_kernel` (gmres_tpu/ops/stencil.py:519, behind
// stencil_5pt_dd_general_pallas_blocked: five arbitrary float64
// coefficients). One kernel serves both: the Poisson coefficients
// (4, −1, −1, −1, −1) are exact in float64.
//
// Design. Mosaic has no float64, so the TPU kernels run double-double
// arithmetic on the pairs (error-free float32 sums and 12-bit split
// products, ~2⁻⁴⁸ relative per application). Hopper has native float64: this
// kernel widens the pair, applies the stencil in float64 in the order of the
// plain version (`stencil_5pt_general`: center, west, east, south, north,
// left to right) and splits the result with `dd_from_f64`'s two roundings.
// That is more accurate than the 2⁻⁴⁸ contract (one float64 rounding per
// operation, then the pair's 2⁻⁴⁹ representation) and costs nothing on a card
// that is bound by memory. The library is built with -fmad=false, so every
// product rounds as in the plain PyTorch version: the target is bit-identity.
//
// What bounds it: memory. A point reads its pair (8 B) and writes a pair
// (8 B): 16 B, the same bytes as a float64 stencil. At 4096² that is 268 MB,
// 80.1 µs at 3.35 TB/s; the 9 float64 flops a point are ~4.4 µs at
// 34 TFLOP/s. One thread per point, 32 consecutive columns per warp so every
// load and store is coalesced (the neighbours' reads hit L1/L2), as K1.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ double pair_at(const float* __restrict__ hi,
                                          const float* __restrict__ lo,
                                          long long k) {
  return (double)hi[k] + (double)lo[k];
}

__global__ void stencil5_dd_kernel(const float* __restrict__ xh,
                                   const float* __restrict__ xl,
                                   float* __restrict__ yh,
                                   float* __restrict__ yl, int rows, int cols,
                                   double c0, double cw, double ce, double cs,
                                   double cn) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= rows || j >= cols) return;
  const long long idx = (long long)i * cols + j;
  const double xc = pair_at(xh, xl, idx);
  const double w = j > 0 ? pair_at(xh, xl, idx - 1) : 0.0;
  const double e = j + 1 < cols ? pair_at(xh, xl, idx + 1) : 0.0;
  const double s = i > 0 ? pair_at(xh, xl, idx - cols) : 0.0;
  const double n = i + 1 < rows ? pair_at(xh, xl, idx + cols) : 0.0;
  const double y = c0 * xc + cw * w + ce * e + cs * s + cn * n;
  const float h = __double2float_rn(y);
  yh[idx] = h;
  yl[idx] = __double2float_rn(y - (double)h);
}

}  // namespace

extern "C" {

int gt_stencil5_dd(const float* xh, const float* xl, float* yh, float* yl,
                   int rows, int cols, double c0, double cw, double ce,
                   double cs, double cn, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((cols + kBlockX - 1) / kBlockX, (rows + kBlockY - 1) / kBlockY);
  stencil5_dd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      xh, xl, yh, yl, rows, cols, c0, cw, ce, cs, cn);
  return (int)cudaGetLastError();
}

}  // extern "C"
