// K3: DIA sparse matrix-vector product for Hopper (sm_90a).
//
//   y[i] = Σ_k data[k, i] · x[i + off_k],   i < n_rows,  0 ≤ i + off_k < n_cols
//
// summed in offset order from zero (or, with `accumulate`, from the y that a
// previous launch over the earlier diagonals wrote).
//
// Replaces the Pallas kernel `_dia_kernel` (gmres_tpu/ops/sparse.py, behind
// dia_spmv_pallas). The TPU kernel tiles x as (rows, 128) VMEM blocks, turns
// each flat offset into a static row shift plus a lane roll, and reads the
// neighbouring blocks as halo windows, with the offsets compiled into the
// kernel. None of that is needed here: a thread reads x[i + off] directly.
//
// What bounds it: memory. Each row reads ndiags coefficients and ndiags
// entries of x and writes one y, for 2·ndiags flops: under 0.3 flop/byte in
// float32. The least traffic is n·(ndiags + 2)·itemsize bytes (data once,
// x once, y once); for the 2048² Poisson matrix in float32 that is 117 MB,
// 35 µs at 3.35 TB/s. Design: one thread per row, so the reads of each
// diagonal and of each shifted window of x are coalesced; x's re-reads for
// the other diagonals hit L1/L2. The offsets are arbitrary (up to 2n − 1 of
// them from dia_from_dense, up to max_diags from csr_to_hyb) and travel by
// value in the kernel's parameters, at most kMaxDiags per launch (read from
// the constant bank, the same value for every thread); the wrapper splits a
// longer list into several launches with `accumulate` set, which keeps the
// order of the sums.
//
// Out-of-range positions (i + off outside [0, n_cols)) are never read. The
// plain version (dia_spmv) rolls x around instead and relies on the zero
// coefficient there, so a NaN or Inf of x at such a position poisons only
// the plain version; the two agree on finite inputs.
//
// Lanes (jax.vmap of dia_spmv_pallas: a leading grid axis). One launch takes
// a (lanes, n_cols) block of x with one matrix shared by the lanes and writes
// the (lanes, n_rows) block of y, the lane on gridDim.y: each lane's threads
// run the single launch's loop on that lane's x and y, so each lane gets the
// bits of its own launch. The matrix is read once per lane (its re-reads for
// the other lanes may hit L2); reading it once for all lanes is later work.
//
// Rounding: every product and sum rounds separately in both versions (the
// library is built with -fmad=false, so nvcc does not contract them into
// FMAs), and the sum runs in the same order from zero, so K3 agrees with
// dia_spmv bitwise on finite inputs.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 64;  // DIA_MAX_DIAGS_PER_LAUNCH in ops/sparse.py
constexpr int kThreads = 256;

struct DiaOffsets {
  int off[kMaxDiags];
};

template <typename T>
__global__ void dia_spmv_kernel(const T* __restrict__ data,
                                const T* __restrict__ x, T* __restrict__ y,
                                int n_rows, int n_cols, int ndiags,
                                DiaOffsets offs, int accumulate) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  x += (long long)blockIdx.y * n_cols;
  y += (long long)blockIdx.y * n_rows;
  T acc = accumulate ? y[i] : T(0);
  for (int k = 0; k < ndiags; ++k) {
    const long long j = (long long)i + offs.off[k];
    if (j >= 0 && j < n_cols) {
      acc = acc + data[(long long)k * n_rows + i] * x[j];
    }
  }
  y[i] = acc;
}

template <typename T>
int launch(const T* data, const T* x, T* y, int lanes, int n_rows, int n_cols,
           const int* offsets, int ndiags, int accumulate, int device,
           void* stream) {
  if (ndiags < 1 || ndiags > kMaxDiags || lanes < 1 || lanes > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  DiaOffsets offs = {};
  for (int k = 0; k < ndiags; ++k) offs.off[k] = offsets[k];
  const dim3 grid((n_rows + kThreads - 1) / kThreads, lanes);
  if (grid.x > 0) {
    dia_spmv_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        data, x, y, n_rows, n_cols, ndiags, offs, accumulate);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gt_dia_spmv_f32(const float* data, const float* x, float* y, int lanes,
                    int n_rows, int n_cols, const int* offsets, int ndiags,
                    int accumulate, int device, void* stream) {
  return launch<float>(data, x, y, lanes, n_rows, n_cols, offsets, ndiags,
                       accumulate, device, stream);
}

int gt_dia_spmv_f64(const double* data, const double* x, double* y, int lanes,
                    int n_rows, int n_cols, const int* offsets, int ndiags,
                    int accumulate, int device, void* stream) {
  return launch<double>(data, x, y, lanes, n_rows, n_cols, offsets, ndiags,
                        accumulate, device, stream);
}

}  // extern "C"
