// K5: the fused degree-2 Chebyshev (cbpr2) application on a (rows, cols)
// block with explicit halo rows, for Hopper (sm_90a).
//
//   ar(i,j) = c0·r(i,j) + cw·r(i,j−1) + ce·r(i,j+1) + cs·r(i−1,j) + cn·r(i+1,j)
//   z(i,j)  = r(i,j)·inv_d + alpha·(r(i,j) − ar(i,j)·inv_d)
//
// with zeros outside the block, except that row −1 is read from `top` and row
// `rows` from `bot` when those pointers are not null (a null pointer is a zero
// row — the Dirichlet boundary, or a shard with no neighbour there: the halo
// route passes no row for a side without a neighbour, so an application on
// one rank is this one launch). By linearity A(r/d) = A(r)/d, so this is the
// reference's three cbpr2 loops (z = r/d; z += α(r − A z)) in one pass.
//
// Replaces the Pallas kernel `_cheb_kernel` (gmres_tpu/ops/fused.py, behind
// chebyshev_poisson_fused), which the distributed halo_chebyshev_preconditioner
// runs on each shard. The TPU kernel loads the whole shard into VMEM as one
// block; here one launch covers any (rows, cols).
//
// What bounds it: at 2048² float32 (33.6 MB) HBM bytes, ~10 µs. Each point
// reads r once and writes z once (the neighbour reads hit L1/L2) and does 14
// flops: ~0.9 flop/byte in float64, ~1.75 in float32, far under the card's
// balance point. At 304² float64, the strong-scaling shard on one card, the
// block is 1.5 MB and sits in L2: the bytes take 0.44 µs and the launch more,
// so the design keeps the launch short: one thread a point in a flat grid
// of 256-thread CTAs (361 at 304² float64), warps along rows so every load
// and store is coalesced, no shared memory. Two float64 (four float32)
// points a thread with 16-byte accesses were measured at that shape and
// were no faster; programmatic dependent launch was measured on the halo
// path's K5 → K1 chain in CUDA-graph replay, which no path runs (PERF.md).
// Neither is used.
//
// Lanes. A contiguous (lanes, rows, cols) block of grids is one launch, the
// lane on gridDim.y, with per-lane halo rows: `top` and `bot` are then
// (lanes, cols) arrays, lane ℓ's row at ℓ·cols (null: a zero row in every
// lane). That is the halo route's block form, what jax.vmap makes of the
// cbpr2 kernel: s rows of a row-sharded grid take one exchange of their
// boundary rows and one launch. A lane's threads run one grid's arithmetic on
// the lane's slice, so every lane gives the bits of its own launch. The
// scalars are one set for every lane (the preconditioner's).
//
// Rounding: the stencil sum in the order of the plain PyTorch version
// (c0·r + cw·W + ce·E + cs·S + cn·N, left to right), then the epilogue in the
// JAX kernel's order, with 1/d rounded to the dtype on the host. The library is
// built with -fmad=false, so each product and sum rounds as the separate
// PyTorch operations do: the target is bit-identity with the plain version.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Cheb2 {
  T inv_d, alpha, c0, cw, ce, cs, cn;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
cheb2_kernel(const T* __restrict__ r, const T* __restrict__ top,
             const T* __restrict__ bot, T* __restrict__ z, int rows, int cols,
             Cheb2<T> p) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)rows * cols) return;
  const long long lane = (long long)blockIdx.y * rows * cols;
  r += lane;
  z += lane;
  if (top != nullptr) top += (long long)blockIdx.y * cols;
  if (bot != nullptr) bot += (long long)blockIdx.y * cols;
  const int i = (int)(idx / cols);
  const int j = (int)(idx - (long long)i * cols);
  const T zero = T(0);
  const T x = r[idx];
  const T w = j > 0 ? r[idx - 1] : zero;
  const T e = j + 1 < cols ? r[idx + 1] : zero;
  const T s = i > 0 ? r[idx - cols] : (top != nullptr ? top[j] : zero);
  const T n = i + 1 < rows ? r[idx + cols] : (bot != nullptr ? bot[j] : zero);
  const T ar = p.c0 * x + p.cw * w + p.ce * e + p.cs * s + p.cn * n;
  z[idx] = x * p.inv_d + p.alpha * (x - ar * p.inv_d);
}

template <typename T>
int launch(const T* r, const T* top, const T* bot, T* z, int lanes, int rows,
           int cols, Cheb2<T> p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  const long long work = (long long)rows * cols;
  const dim3 grid((unsigned)((work + kThreads - 1) / kThreads), (unsigned)lanes);
  cheb2_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(r, top, bot, z,
                                                               rows, cols, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `lanes` grids of (rows, cols) in one contiguous block; top, bot: (lanes,
// cols) arrays of halo rows, or null for zero rows.
int gt_cheb2_f32(const float* r, const float* top, const float* bot, float* z,
                 int lanes, int rows, int cols, float inv_d, float alpha,
                 float c0, float cw, float ce, float cs, float cn, int device,
                 void* stream) {
  return launch<float>(r, top, bot, z, lanes, rows, cols,
                       {inv_d, alpha, c0, cw, ce, cs, cn}, device, stream);
}

int gt_cheb2_f64(const double* r, const double* top, const double* bot,
                 double* z, int lanes, int rows, int cols, double inv_d,
                 double alpha, double c0, double cw, double ce, double cs,
                 double cn, int device, void* stream) {
  return launch<double>(r, top, bot, z, lanes, rows, cols,
                        {inv_d, alpha, c0, cw, ce, cs, cn}, device, stream);
}

}  // extern "C"
