// K4: block-sparse-row (block-ELL) matrix-vector product for Hopper (sm_90a).
//
//   y[l, i·bs + a] = Σ_j Σ_b data[i, j, a, b] · x[l, cols[i, j]·bs + b]
//
// for block rows i < nbr, block slots j < k, (bs, bs) dense blocks and lanes
// l < lanes (one lane: a single vector). Padding blocks are all zeros with
// block column 0; they are multiplied like any other block (skipping them by
// value would make the work depend on the data and change nothing in y).
//
// Replaces the Pallas kernel `_bsr_kernel` (gmres_tpu/ops/sparse.py, behind
// bsr_spmv_pallas, and what jax.vmap makes of it: a leading grid axis). The
// TPU kernel walks a sequential (nbr, k) grid: it scalar-prefetches
// block_cols so that the DMA of the next x block overlaps the MXU product,
// and accumulates into the output block across j. Here blocks run in no
// order and nothing carries across them, so one CUDA block owns one (block
// row, tile of output rows, chunk of lanes) and loops over the k blocks of
// its row itself, reading block_cols[i, j].
//
// What bounds it: memory. Each block entry is read for one multiply-add a
// lane (0.25 flop/byte a lane in float32), so the least traffic is the
// matrix once plus each lane's x and y: for 512 block rows of three 128×128
// blocks in float32, 100.7 MB for one vector (30 µs at 3.35 TB/s), 104.9 MB
// for 8 lanes (31 µs).
//
// Design: a warp per output row, its 32 threads on 32 consecutive columns of
// the block row, so each read of the block is coalesced; each warp carries 4
// rows (a CUDA block a tile of 32), and the threads' partial sums are
// reduced by warp shuffles at the end. The lanes run in chunks of up to L
// (ops/sparse.py:spmv_lanes_plan picks L): each thread keeps one accumulator
// a (row, lane), and each matrix entry it loads feeds L fused multiply-adds,
// one a lane of the chunk, so one launch reads the matrix once a chunk, not
// once a lane. The grid is one-dimensional with the chunk fastest, so the
// chunks of one tile run side by side and a later chunk finds the tile in
// L2. A thread's columns are fixed (b ≡ thread mod 32), so for each block it
// loads its chunk's x entries into registers once (through L1: every warp of
// the CUDA block reads the same x block) and reuses them over its 4 rows; no
// shared memory and no barrier. The matrix streams through L2 only
// (ld.global.cg), leaving L1 to x. Columns run in steps of 128 (4 a thread);
// a block of at most 128 columns, the common case, is one step, specialised
// at compile time. One vector has registers to spare and issues each step's
// matrix loads a step ahead; a lane block's registers go to its 4·L
// accumulators and 4·L x entries, which cap the warps an SM holds (16 at
// L = 8 in float32), and so the bytes in flight: each chunk size is
// compiled for the CUDA blocks an SM can hold by its register estimate
// (min_blocks; left free, ptxas took 137 registers at L = 4 and the SM
// held one CUDA block), and float64 stops at chunks of 4. The end of a
// block's sums trades values between threads (warp_sums): 31 shuffles for
// 32 sums, not 160. Staging the matrix in shared memory by cp.async (a ring
// of 2–4 tiles, one or four work items a CUDA block) measured slower at
// every chunk on the H100 (PERF.md §6, row 11b), so the matrix goes
// straight to registers.
//
// No tensor cores: TF32 would break the full-float32 precision the TPU
// kernel asks for (Precision.HIGHEST), and the product is memory-bound at
// these lane counts anyway.
//
// Rounding: the library is built with -fmad=false, but this kernel uses
// explicit fused multiply-adds (__fmaf_rn / __fma_rn), which that flag does
// not touch. Each (row, lane) sums in the same order whatever L is (j
// outer, then the thread's columns in order, then the pairings of the
// shuffle-down tree 16, 8, 4, 2, 1), so every lane of a block gets the bits
// of its own single launch, and a single launch those of a one-warp-a-row
// kernel summing in that order. The reference, the einsum of bsr_spmv, sums
// in cuBLAS's order, so the two agree to a stated tolerance (1e-5 of max|y|
// in float32, 1e-13 in float64), not bitwise.
//
// C interface (ctypes): the launch's chunk, grid, threads and shared bytes
// come from ops/sparse.py:spmv_lanes_plan. Returns cudaGetLastError() after
// the launch, cudaErrorInvalidValue for a chunk size not compiled here, and
// cudaErrorInvalidConfiguration for a grid that does not cover the block
// rows, tiles and chunks.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroupCols = 128;
constexpr int kColsPerThread = kGroupCols / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kWarps * kRowsPerWarp;

// The chunk sizes compiled, by dtype; ops/sparse.py:K4_CHUNKS names the
// same. In float64 a chunk of 8 leaves an SM too few warps (its registers),
// and two chunks of 4 measured faster on the H100 (PERF.md §6, row 11b).
#define K4_CHUNKS_F32(X) X(1) X(2) X(4) X(8)
#define K4_CHUNKS_F64(X) X(1) X(2) X(4)

// CUDA blocks an SM should hold, from a thread's registers: 4L accumulators,
// 4L x entries and 16 matrix entries (32 where one vector loads a step
// ahead), 4 bytes a register, and ~24 for addresses; ptxas keeps the kernel
// within 65536 / (256 · blocks) registers a thread.
template <typename T, int L>
constexpr int min_blocks() {
  constexpr int regs = (8 * L + 16 * (L == 1 ? 2 : 1)) * (int)(sizeof(T) / 4) + 24;
  constexpr int blocks = 256 / regs;
  return blocks < 1 ? 1 : blocks > 4 ? 4 : blocks;
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// Sums each of a thread's Q values (a power of two, at most 32) over the
// warp with the pairings of the shuffle-down tree (16, 8, 4, 2, 1), so each
// sum has that tree's bits: while a thread holds more than one value, it
// keeps half of them and trades the other half with the thread `off` away,
// one shuffle a value kept (its own partial plus its partner's, as the tree
// adds them); then plain butterflies. The thread ends with value
// q = lane >> (5 − log2 Q), which every thread of its group of 32 / Q holds.
template <int K, typename T, int Q>
__device__ __forceinline__ T warp_sums(T (&v)[Q], int lane) {
  constexpr int off = 16 >> K;
  constexpr int n = Q >> K;
  if constexpr (n > 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const T send = upper ? v[i] : v[i + n / 2];
      const T keep = upper ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  }
  if constexpr (K < 4) {
    return warp_sums<K + 1>(v, lane);
  } else {
    return v[0];
  }
}

template <typename T, int R>
__device__ __forceinline__ void load_rows(T (&d)[R][kColsPerThread], const T* blk,
                                          int row0, int c0, int lane, int bs) {
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    const int b = c0 + c * 32 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      d[r][c] = (b < bs && row0 + r < bs)
                    ? __ldcg(blk + (long long)(row0 + r) * bs + b) : T(0);
    }
  }
}

template <typename T, int L, bool kOneGroup>
__global__ void __launch_bounds__(kThreads, min_blocks<T, L>())
bsr_spmv_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                const T* __restrict__ x, T* __restrict__ y, int lanes, int chunks,
                int tiles, int k, int bs, long long x_len, long long y_len) {
  // One vector issues each step's matrix loads a step ahead, into a second
  // set of registers; a lane block's registers go to its sums.
  constexpr bool kPrefetch = L == 1;
  constexpr int R = kRowsPerWarp;
  constexpr int Q = R * L;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  long long id = blockIdx.x;
  const int chunk = (int)(id % chunks);
  id /= chunks;
  const int row0 = (int)(id % tiles) * kTileRows + warp * R;
  const long long br = id / tiles;
  if (row0 >= bs) return;  // the whole warp: none of its rows exists
  const int l0 = chunk * L;
  const int nl = min(L, lanes - l0);
  x += l0 * x_len;
  y += l0 * y_len;
  T acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = T(0);
  // Steps (block j, group g of 128 columns), j outer.
  const int groups = kOneGroup ? 1 : (bs + kGroupCols - 1) / kGroupCols;
  const int steps = k * groups;
  const T* blocks = data + br * k * (long long)bs * bs;
  T d[R][kColsPerThread];
  if constexpr (kPrefetch) load_rows<T, R>(d, blocks, row0, 0, lane, bs);

  for (int s = 0; s < steps; ++s) {
    const int j = s / groups, g = s - j * groups;
    const int c0 = g * kGroupCols;
    T dn[R][kColsPerThread];
    if constexpr (kPrefetch) {
      if (s + 1 < steps) {
        const int jn = (s + 1) / groups;
        load_rows<T, R>(dn, blocks + jn * (long long)bs * bs, row0,
                        (s + 1 - jn * groups) * kGroupCols, lane, bs);
      }
    } else {
      load_rows<T, R>(d, blocks + j * (long long)bs * bs, row0, c0, lane, bs);
    }
    const T* xb = x + (long long)cols[br * k + j] * bs;
    T xr[kColsPerThread][L];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int b = c0 + c * 32 + lane;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        xr[c][l] = (b < bs && l < nl) ? __ldg(xb + l * x_len + b) : T(0);
      }
    }
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      if (c0 + c * 32 + lane < bs) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int l = 0; l < L; ++l) {
            acc[r * L + l] = fma_t(d[r][c], xr[c][l], acc[r * L + l]);
          }
        }
      }
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) d[r][c] = dn[r][c];
      }
    }
  }

  const T v = warp_sums<0>(acc, lane);
  constexpr int kShift = Q >= 32 ? 0 : Q >= 16 ? 1 : Q >= 8 ? 2 : Q >= 4 ? 3 : Q >= 2 ? 4 : 5;
  const int q = lane >> kShift;
  const int r = q / L, l = q - r * L;
  if ((lane & ((1 << kShift) - 1)) == 0 && row0 + r < bs && l < nl) {
    y[l * y_len + br * bs + row0 + r] = v;
  }
}

template <typename T, int L>
void launch_config(const T* data, const int* cols, const T* x, T* y, int lanes,
                   int chunks, int tiles, int k, int bs, long long x_len,
                   long long y_len, dim3 grid, int threads, int shared_bytes,
                   cudaStream_t stream) {
  if (bs <= kGroupCols) {
    bsr_spmv_kernel<T, L, true><<<grid, threads, shared_bytes, stream>>>(
        data, cols, x, y, lanes, chunks, tiles, k, bs, x_len, y_len);
  } else {
    bsr_spmv_kernel<T, L, false><<<grid, threads, shared_bytes, stream>>>(
        data, cols, x, y, lanes, chunks, tiles, k, bs, x_len, y_len);
  }
}

template <typename T>
int launch(const T* data, const int* cols, const T* x, T* y, int lanes, int nbr,
           int nbc, int k, int bs, int chunk, int grid_x, int grid_y, int grid_z,
           int threads, int shared_bytes, int device, void* stream) {
  if (lanes < 1 || lanes > 65535 || chunk < 1 || nbr < 0 || bs < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunks = (lanes + chunk - 1) / chunk;
  const int tiles = (bs + kTileRows - 1) / kTileRows;
  // The launch is the plan's (ops/sparse.py:spmv_lanes_plan): one CUDA block
  // a (block row, tile, chunk); a grid that does not cover them exactly is
  // refused.
  if ((long long)grid_x != (long long)nbr * tiles * chunks || grid_y != 1 ||
      grid_z != 1 || threads != kThreads || shared_bytes != 0) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nbr == 0 || k <= 0 || bs == 0) return (int)cudaGetLastError();
  const long long x_len = (long long)nbc * bs, y_len = (long long)nbr * bs;
  const dim3 grid(grid_x, grid_y, grid_z);
#define K4_CASE(L_)                                                              \
  if (chunk == L_) {                                                             \
    launch_config<T, L_>(data, cols, x, y, lanes, chunks, tiles, k, bs, x_len,   \
                         y_len, grid, threads, shared_bytes, (cudaStream_t)stream); \
    return (int)cudaGetLastError();                                              \
  }
  if constexpr (sizeof(T) == 4) {
    K4_CHUNKS_F32(K4_CASE)
  } else {
    K4_CHUNKS_F64(K4_CASE)
  }
#undef K4_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int gt_bsr_spmv_f32(const float* data, const int* cols, const float* x, float* y,
                    int lanes, int nbr, int nbc, int k, int bs, int chunk,
                    int grid_x, int grid_y, int grid_z, int threads,
                    int shared_bytes, int device, void* stream) {
  return launch<float>(data, cols, x, y, lanes, nbr, nbc, k, bs, chunk, grid_x,
                       grid_y, grid_z, threads, shared_bytes, device, stream);
}

int gt_bsr_spmv_f64(const double* data, const int* cols, const double* x,
                    double* y, int lanes, int nbr, int nbc, int k, int bs,
                    int chunk, int grid_x, int grid_y, int grid_z, int threads,
                    int shared_bytes, int device, void* stream) {
  return launch<double>(data, cols, x, y, lanes, nbr, nbc, k, bs, chunk, grid_x,
                        grid_y, grid_z, threads, shared_bytes, device, stream);
}

}  // extern "C"
