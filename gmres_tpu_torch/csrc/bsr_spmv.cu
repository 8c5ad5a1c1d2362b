// K4: block-sparse-row (block-ELL) matrix-vector product for Hopper (sm_90a).
//
//   y[i·bs + a] = Σ_j Σ_b data[i, j, a, b] · x[cols[i, j]·bs + b]
//
// for block rows i < nbr, block slots j < k and (bs, bs) dense blocks. Padding
// blocks are all zeros with block column 0; they are multiplied like any
// other block (skipping them by value would make the work depend on the data
// and change nothing in y).
//
// Replaces the Pallas kernel `_bsr_kernel` (gmres_tpu/ops/sparse.py, behind
// bsr_spmv_pallas). The TPU kernel walks a sequential (nbr, k) grid: it
// scalar-prefetches block_cols so that the DMA of the next x block overlaps
// the MXU product, and accumulates into the output block across j. Here
// blocks run in no order and nothing carries across them, so one CUDA block
// owns one (block row, tile of output rows) and loops over the k blocks of
// its row itself, reading block_cols[i, j] and staging that x block in
// shared memory.
//
// What bounds it: memory. Each block entry is read once for one multiply-add
// (0.25 flop/byte in float32), so the least traffic is
// nbr·k·bs²·itemsize + x + y bytes: for 512 block rows of three 128×128
// blocks in float32, 100.7 MB, 30 µs at 3.35 TB/s. Design: a warp per output
// row, its 32 lanes on 32 consecutive columns of the block row, so each read
// of the block is coalesced; each warp carries kRowsPerWarp rows, and the
// lanes' partial sums are reduced by warp shuffles at the end. No tensor
// cores: TF32 would break the full-float32 precision the TPU kernel asks for
// (Precision.HIGHEST), and a 3×TF32 split is later work.
//
// Lanes (jax.vmap of bsr_spmv_pallas: a leading grid axis). One launch takes
// a (lanes, nbc·bs) block of x with one matrix shared by the lanes and writes
// the (lanes, nbr·bs) block of y, the lane on gridDim.z (x and y already
// carry the block rows and the row tiles): each lane's CUDA blocks run the
// single launch's body on that lane's x and y, so each lane gets the bits of
// its own launch. The matrix is read once per lane; reading each block once
// for all lanes is later work.
//
// Rounding: the library is built with -fmad=false, but this kernel uses
// explicit fused multiply-adds (__fmaf_rn / __fma_rn), which that flag does
// not touch. Its reference, the einsum of bsr_spmv, sums in cuBLAS's order,
// so the two agree to a stated tolerance (1e-5 of max|y| in float32, 1e-13
// in float64), not bitwise.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kWarps * kRowsPerWarp;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
__global__ void bsr_spmv_kernel(const T* __restrict__ data,
                                const int* __restrict__ cols,
                                const T* __restrict__ x, T* __restrict__ y,
                                int k, int bs, long long x_len, long long y_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  const long long br = blockIdx.x;
  x += blockIdx.z * x_len;
  y += blockIdx.z * y_len;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * kTileRows + warp * kRowsPerWarp;
  T acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = T(0);

  for (int j = 0; j < k; ++j) {
    const long long col = cols[br * k + j];
    __syncthreads();  // every warp is done with the previous x block
    for (int b = threadIdx.x; b < bs; b += blockDim.x) xs[b] = x[col * bs + b];
    __syncthreads();
    const T* blk = data + (br * k + j) * (long long)bs * bs;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int a = row0 + r;
      if (a < bs) {
        const T* row = blk + (long long)a * bs;
#pragma unroll 4
        for (int b = lane; b < bs; b += 32) acc[r] = fma_t(row[b], xs[b], acc[r]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    T v = acc[r];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    const int a = row0 + r;
    if (lane == 0 && a < bs) y[br * bs + a] = v;
  }
}

template <typename T>
int launch(const T* data, const int* cols, const T* x, T* y, int lanes, int nbr,
           int nbc, int k, int bs, int device, void* stream) {
  if (lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nbr <= 0 || k <= 0 || bs <= 0) return (int)cudaGetLastError();
  const dim3 grid(nbr, (bs + kTileRows - 1) / kTileRows, lanes);
  bsr_spmv_kernel<T><<<grid, kWarps * 32, bs * sizeof(T), (cudaStream_t)stream>>>(
      data, cols, x, y, k, bs, (long long)nbc * bs, (long long)nbr * bs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gt_bsr_spmv_f32(const float* data, const int* cols, const float* x, float* y,
                    int lanes, int nbr, int nbc, int k, int bs, int device,
                    void* stream) {
  return launch<float>(data, cols, x, y, lanes, nbr, nbc, k, bs, device, stream);
}

int gt_bsr_spmv_f64(const double* data, const int* cols, const double* x,
                    double* y, int lanes, int nbr, int nbc, int k, int bs,
                    int device, void* stream) {
  return launch<double>(data, cols, x, y, lanes, nbr, nbc, k, bs, device, stream);
}

}  // extern "C"
