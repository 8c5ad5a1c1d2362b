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
// 35 µs at 3.35 TB/s; on L lanes the data once and each lane's x and y,
// 104 MB (31 µs) for 4 lanes of the HYB 1000² float64. Design: one thread per row, so the reads of each
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
// the (lanes, n_rows) block of y. The lanes run in chunks of up to L
// (ops/sparse.py:spmv_lanes_plan picks L), the chunk on gridDim.y: each thread
// keeps one accumulator a lane of its chunk, loads each coefficient
// data[k, i] once and adds its product with each lane's x[i + off_k], so one
// launch reads the matrix once a chunk, not once a lane. Each lane's sum runs
// in offset order from zero (or from its y), as in its single launch, so each
// lane gets the bits of its own launch; one vector is the chunk of one lane.
// The plan takes the smallest compiled chunk that holds the lanes: on the
// H100 a chunk of 8 measured faster at 8 lanes than one of 16, and one of
// 16 faster at 9 lanes than two of 8 (PERF.md §6, row 12b).
//
// Rounding: every product and sum rounds separately in both versions (the
// library is built with -fmad=false, so nvcc does not contract them into
// FMAs), and the sum runs in the same order from zero, so K3 agrees with
// dia_spmv bitwise on finite inputs.
//
// C interface (ctypes): the launch's chunk, grid, threads and shared bytes
// come from ops/sparse.py:spmv_lanes_plan. Returns cudaGetLastError() after
// the launch, cudaErrorInvalidValue for a chunk size not compiled here, and
// cudaErrorInvalidConfiguration for a grid that does not cover the rows and
// chunks.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 64;  // DIA_MAX_DIAGS_PER_LAUNCH in ops/sparse.py
constexpr int kThreads = 256;

struct DiaOffsets {
  int off[kMaxDiags];
};

// The chunk sizes compiled; ops/sparse.py:K3_CHUNKS names the same.
#define K3_CHUNKS(X) X(1) X(2) X(4) X(8) X(16)

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ data, const T* __restrict__ x,
                T* __restrict__ y, int n_rows, int n_cols, int ndiags,
                DiaOffsets offs, int accumulate, int lanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const int l0 = blockIdx.y * L;
  const int nl = min(L, lanes - l0);
  x += (long long)l0 * n_cols;
  y += (long long)l0 * n_rows;
  T acc[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    acc[l] = (accumulate && l < nl) ? y[(long long)l * n_rows + i] : T(0);
  }
  for (int k = 0; k < ndiags; ++k) {
    const long long j = (long long)i + offs.off[k];
    if (j >= 0 && j < n_cols) {
      const T c = data[(long long)k * n_rows + i];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (l < nl) acc[l] = acc[l] + c * x[(long long)l * n_cols + j];
      }
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (l < nl) y[(long long)l * n_rows + i] = acc[l];
  }
}

template <typename T>
int launch(const T* data, const T* x, T* y, int lanes, int n_rows, int n_cols,
           const int* offsets, int ndiags, int accumulate, int chunk, int grid_x,
           int grid_y, int grid_z, int threads, int shared_bytes, int device,
           void* stream) {
  if (ndiags < 1 || ndiags > kMaxDiags || lanes < 1 || lanes > 65535 || chunk < 1) {
    return (int)cudaErrorInvalidValue;
  }
  // The launch is the plan's (ops/sparse.py:spmv_lanes_plan); one that does
  // not cover this kernel's rows and chunks exactly is refused.
  if (grid_x != (n_rows + kThreads - 1) / kThreads ||
      grid_y != (lanes + chunk - 1) / chunk || grid_z != 1 || threads != kThreads ||
      shared_bytes != 0) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  DiaOffsets offs = {};
  for (int k = 0; k < ndiags; ++k) offs.off[k] = offsets[k];
  const dim3 grid(grid_x, grid_y, grid_z);
  if (grid_x == 0) return (int)cudaGetLastError();
#define K3_CASE(L_)                                                             \
  if (chunk == L_) {                                                            \
    dia_spmv_kernel<T, L_><<<grid, threads, shared_bytes, (cudaStream_t)stream>>>( \
        data, x, y, n_rows, n_cols, ndiags, offs, accumulate, lanes);           \
    return (int)cudaGetLastError();                                             \
  }
  K3_CHUNKS(K3_CASE)
#undef K3_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int gt_dia_spmv_f32(const float* data, const float* x, float* y, int lanes,
                    int n_rows, int n_cols, const int* offsets, int ndiags,
                    int accumulate, int chunk, int grid_x, int grid_y, int grid_z,
                    int threads, int shared_bytes, int device, void* stream) {
  return launch<float>(data, x, y, lanes, n_rows, n_cols, offsets, ndiags,
                       accumulate, chunk, grid_x, grid_y, grid_z, threads,
                       shared_bytes, device, stream);
}

int gt_dia_spmv_f64(const double* data, const double* x, double* y, int lanes,
                    int n_rows, int n_cols, const int* offsets, int ndiags,
                    int accumulate, int chunk, int grid_x, int grid_y, int grid_z,
                    int threads, int shared_bytes, int device, void* stream) {
  return launch<double>(data, x, y, lanes, n_rows, n_cols, offsets, ndiags,
                        accumulate, chunk, grid_x, grid_y, grid_z, threads,
                        shared_bytes, device, stream);
}

}  // extern "C"
