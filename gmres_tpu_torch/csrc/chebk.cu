// K2: the order-k polynomial semi-iteration z ≈ A⁻¹r on a 5-point stencil,
// for Hopper (sm_90a).
//
//   d₀ = z₀ = r/θ;  then k−1 times:  d ← a_s·d + b_s·(r − A z);  z ← z + d
//
// with A the general 5-point stencil (coefficients c0, cw, ce, cs, cn, zero
// outside the grid). (θ, a_s, b_s) arrive already rounded to the element
// type: Chebyshev on an interval or damped Jacobi are both this recurrence,
// with the coefficient lists made on the host.
//
// Replaces the Pallas kernels `_chebk_kernel` (gmres_tpu/ops/fused.py, behind
// chebyshev_k_poisson_pallas and poly_stencil_smoother_pallas: the whole grid
// held in VMEM for all k−1 sweeps) and `_chebk_blocked_kernel` (behind the
// `_blocked` entry points: row blocks with a trapezoidal halo of
// 8·⌈(k−1)/8⌉ rows, re-masked to zero outside the grid after every sweep).
//
// What bounds it: memory. A sweep is 13 flops per point against the reads of
// r, z and d and the writes of z and d. The TPU kernels keep the grid in a
// large on-chip store so that all sweeps cost one HBM pass; Hopper has no
// grid-sized on-chip store (a block gets at most 227 KB of shared memory),
// so the design has two paths, chosen by the caller:
//
//  * chebk_smem_kernel — the whole grid in one block's shared memory, when r,
//    z and d fit (3·rows·cols·sizeof(T) within the caller's budget): one
//    launch runs all k−1 sweeps, reading r once and writing z once. This is
//    the coarse solve (order 32 on 75², 31 sweeps) and the small levels. A
//    single SM does the work, which is right for grids this small: at these
//    sizes the cost is launch and synchronisation, not bandwidth.
//  * chebk_sweep_kernel — one launch per sweep, over the whole card. z is
//    ping-ponged between two buffers, so no block reads a z value that
//    another block is writing; d is read and written only at its own point,
//    so it is updated in place. The first sweep derives z₀ = d₀ = r/θ from r
//    on the fly (the same division, so the same rounding) instead of a
//    separate initialisation pass. At 300² the three buffers (1 MB in
//    float32) stay in the 50 MB L2 between sweeps.
//
// The TPU's trapezoidal halo is a consequence of its row-block tiling and is
// not carried over: the per-sweep launch sees the true grid edge at every
// sweep, so the out-of-grid rows are zero by construction (the re-masking
// that `_chebk_blocked_kernel` needs, fused.py:402-418, is implicit here).
//
// Rounding: each step is evaluated in the order of the plain PyTorch version
// and the library is built with -fmad=false.
//
// C interface (ctypes): returns cudaGetLastError() after the last launch.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kSmemBlock = 32;        // 32×32 = 1024 threads
constexpr int kMaxSmemSteps = 128;    // sweeps carried as kernel parameters

template <typename T>
struct Coefs {
  T c0, cw, ce, cs, cn;
};

template <typename T>
struct Steps {
  T v[2 * kMaxSmemSteps];
};

// Stencil of z at (i, j) with zeros outside the grid; `scale` divides every
// value read (1 for z itself, θ for the implied z₀ = r/θ of the first sweep).
template <typename T, bool kFromR>
__device__ __forceinline__ T stencil_at(const T* __restrict__ z, int i, int j,
                                        int rows, int cols, long long idx,
                                        const Coefs<T>& c, T theta) {
  const T zero = T(0);
  T xc = z[idx];
  T w = j > 0 ? z[idx - 1] : zero;
  T e = j + 1 < cols ? z[idx + 1] : zero;
  T s = i > 0 ? z[idx - cols] : zero;
  T n = i + 1 < rows ? z[idx + cols] : zero;
  if (kFromR) {
    xc = xc / theta;
    w = w / theta;
    e = e / theta;
    s = s / theta;
    n = n / theta;
  }
  return c.c0 * xc + c.cw * w + c.ce * e + c.cs * s + c.cn * n;
}

// mode 0: z_out = r/θ (order 1: no sweep).
// mode 1: first sweep, z₀ = d₀ = r/θ implied.
// mode 2: later sweep, reading z_in and d.
// d_out may be null on the last sweep (d is not needed afterwards).
template <typename T>
__global__ void chebk_sweep_kernel(const T* __restrict__ r,
                                   const T* __restrict__ z_in,
                                   const T* d_in, T* d_out,
                                   T* __restrict__ z_out, int rows, int cols,
                                   T theta, T a, T b, Coefs<T> c, int mode) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= rows || j >= cols) return;
  const long long idx = (long long)i * cols + j;
  const T rc = r[idx];
  if (mode == 0) {
    z_out[idx] = rc / theta;
    return;
  }
  T z, d, az;
  if (mode == 1) {
    z = rc / theta;
    d = z;
    az = stencil_at<T, true>(r, i, j, rows, cols, idx, c, theta);
  } else {
    z = z_in[idx];
    d = d_in[idx];
    az = stencil_at<T, false>(z_in, i, j, rows, cols, idx, c, theta);
  }
  d = a * d + b * (rc - az);
  if (d_out != nullptr) d_out[idx] = d;
  z_out[idx] = z + d;
}

template <typename T>
__global__ void __launch_bounds__(kSmemBlock * kSmemBlock)
chebk_smem_kernel(const T* __restrict__ r, T* __restrict__ z_out, int rows,
                  int cols, T theta, Steps<T> steps, int nsteps, Coefs<T> c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int npts = rows * cols;
  T* rs = reinterpret_cast<T*>(smem_raw);
  T* zs = rs + npts;
  T* ds = zs + npts;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int i = ty; i < rows; i += kSmemBlock) {
    for (int j = tx; j < cols; j += kSmemBlock) {
      const int p = i * cols + j;
      const T rv = r[p];
      const T d0 = rv / theta;
      rs[p] = rv;
      ds[p] = d0;
      zs[p] = d0;
    }
  }
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    const T a = steps.v[2 * s];
    const T b = steps.v[2 * s + 1];
    // Phase 1: new d from the neighbours of z (z is only read here).
    for (int i = ty; i < rows; i += kSmemBlock) {
      for (int j = tx; j < cols; j += kSmemBlock) {
        const int p = i * cols + j;
        const T az = stencil_at<T, false>(zs, i, j, rows, cols, p, c, theta);
        ds[p] = a * ds[p] + b * (rs[p] - az);
      }
    }
    __syncthreads();
    // Phase 2: z += d at each point's own index.
    for (int i = ty; i < rows; i += kSmemBlock) {
      for (int j = tx; j < cols; j += kSmemBlock) {
        const int p = i * cols + j;
        zs[p] = zs[p] + ds[p];
      }
    }
    __syncthreads();
  }
  for (int i = ty; i < rows; i += kSmemBlock) {
    for (int j = tx; j < cols; j += kSmemBlock) {
      const int p = i * cols + j;
      z_out[p] = zs[p];
    }
  }
}

template <typename T>
int launch(const T* r, T* z_out, T* z_scratch, T* d, int rows, int cols,
           T theta, const T* steps, int nsteps, const T* coefs, int whole_grid,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const Coefs<T> c{coefs[0], coefs[1], coefs[2], coefs[3], coefs[4]};

  if (whole_grid) {
    if (nsteps > kMaxSmemSteps) return (int)cudaErrorInvalidValue;
    Steps<T> sv;
    for (int s = 0; s < 2 * nsteps; ++s) sv.v[s] = steps[s];
    const size_t smem = 3 * (size_t)rows * cols * sizeof(T);
    err = cudaFuncSetAttribute(chebk_smem_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    chebk_smem_kernel<T><<<1, dim3(kSmemBlock, kSmemBlock), smem, st>>>(
        r, z_out, rows, cols, theta, sv, nsteps, c);
    return (int)cudaGetLastError();
  }

  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((cols + kBlockX - 1) / kBlockX, (rows + kBlockY - 1) / kBlockY);
  if (nsteps == 0) {
    chebk_sweep_kernel<T><<<grid, block, 0, st>>>(
        r, nullptr, nullptr, nullptr, z_out, rows, cols, theta, T(0), T(0), c, 0);
    return (int)cudaGetLastError();
  }
  // Sweep s (1-based) writes buf[s % 2]; the last sweep must land in z_out.
  T* buf[2];
  buf[nsteps % 2] = z_out;
  buf[(nsteps + 1) % 2] = z_scratch;
  for (int s = 1; s <= nsteps; ++s) {
    const T* z_in = s == 1 ? nullptr : buf[(s - 1) % 2];
    T* d_out = s == nsteps ? nullptr : d;
    chebk_sweep_kernel<T><<<grid, block, 0, st>>>(
        r, z_in, d, d_out, buf[s % 2], rows, cols, theta, steps[2 * (s - 1)],
        steps[2 * (s - 1) + 1], c, s == 1 ? 1 : 2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

int gt_chebk_f32(const float* r, float* z_out, float* z_scratch, float* d,
                 int rows, int cols, float theta, const float* steps,
                 int nsteps, const float* coefs, int whole_grid, int device,
                 void* stream) {
  return launch<float>(r, z_out, z_scratch, d, rows, cols, theta, steps, nsteps,
                       coefs, whole_grid, device, stream);
}

int gt_chebk_f64(const double* r, double* z_out, double* z_scratch, double* d,
                 int rows, int cols, double theta, const double* steps,
                 int nsteps, const double* coefs, int whole_grid, int device,
                 void* stream) {
  return launch<double>(r, z_out, z_scratch, d, rows, cols, theta, steps,
                        nsteps, coefs, whole_grid, device, stream);
}

int gt_chebk_max_smem_steps(void) { return kMaxSmemSteps; }

}  // extern "C"
