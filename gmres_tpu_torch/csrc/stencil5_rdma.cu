// K8: the per-shard affine 5-point stencil of the RDMA route, for Hopper
// (sm_90a), in two entry points that run in the TPU kernel's order:
//
//   interior:  y(i,j) = a·x(i,j) + b·(c0·x(i,j) + cw·x(i,j−1) + ce·x(i,j+1)
//                                    + cs·x(i−1,j) + cn·x(i+1,j))
//              with ZERO halo rows (every term the block holds itself);
//   edges:     y(0,j)      += (b·cs)·top(j)   where `top` is not null
//              y(rows−1,j) += (b·cn)·bot(j)   where `bot` is not null
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
// sync) and launches `edges`. A side with no neighbour (rank 0's top, the
// last rank's bottom: the Dirichlet truncation) has no halo row: the caller
// passes a null pointer, and `edges` leaves that row as the interior wrote
// it. On one rank neither side has a row and the caller launches no `edges`
// at all, so an application is one launch. A design with the peers' stores
// issued from inside the kernel, over symmetric memory, needs several cards
// to measure it and is queued.
//
// What bounds it: memory. A point reads x once and writes y once (the
// neighbours' reads hit L1/L2) and does 12 flops: 1.5 flop/byte in float32.
// At 2048² float32 that is 33.6 MB, 10.0 µs at 3.35 TB/s; at 304² float32
// (the strong-scaling shard) 0.74 MB, 0.22 µs, so there the launch bounds
// it, and the design's answer is one launch an application where there is
// no neighbour (it was four: two fills of zero rows, interior, edges).
// `interior` runs one thread a point in a flat grid of 256-thread CTAs,
// consecutive threads on consecutive columns; on aligned grids of
// kChunkPoints (1024²) points or more whose row length allows, a thread
// takes V = 16 / sizeof(T) consecutive points with 16-byte loads and stores,
// as K1 does (csrc/stencil5.cu, which measured the chunks at 1.24× the byte
// bound at 2048² float32 against 1.92× one point a thread). `edges` is one
// thread per column.
//
// Lanes. Each entry also takes a contiguous (lanes, rows, cols) block of grids
// in one launch, the lane on gridDim.y, and `edges` per-lane halo rows: `top`
// and `bot` are then (lanes, cols) arrays, lane ℓ's row at ℓ·cols (null: no
// correction on that side in any lane). That is the route's block form, what
// jax.vmap makes of the TPU kernel: s rows of a row-sharded grid post one
// message each way for the s rows' boundary rows, one `interior` launch and,
// where a neighbour exists, one `edges` launch. A lane's threads run one
// grid's arithmetic on the lane's slice, so every lane gives the bits of its
// own launches.
//
// Rounding: the sums in the plain version's order, (a, b) and the stencil
// coefficients rounded to the block's type on the host, b·cs and b·cn
// multiplied here in that type, -fmad=false: the target is bit-identity with
// the plain PyTorch version. One difference from the TPU kernel, which adds
// a zero row where there is no neighbour: skipping that correction can
// change only the sign of an exact zero. Where y(0,j) is −0.0, the TPU
// kernel's −0.0 + (b·cs)·0 is +0.0 when b·cs > 0 (as in cbpr2), and here y
// stays −0.0. The two compare equal; no other bit differs.
//
// C interface (ctypes): each entry returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEdgeBlock = 256;
// The smallest grid (in points) on which `interior` takes row chunks (K1's).
constexpr long long kChunkPoints = 1 << 20;

template <typename T>
struct Affine7 {
  T c0, cw, ce, cs, cn, a, b;
};

// The plain version's order: a·x + b·(c0·x + cw·W + ce·E + cs·S + cn·N).
template <typename T>
__device__ __forceinline__ T affine_pt(const Affine7<T>& c, T x, T w, T e, T s,
                                       T n) {
  return c.a * x + c.b * (c.c0 * x + c.cw * w + c.ce * e + c.cs * s + c.cn * n);
}

// V consecutive values of a row, one 16-byte access (V > 1 only on aligned
// pointers).
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// V points a thread (V = 1: one point, any alignment).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rdma_interior_kernel(const T* __restrict__ x, T* __restrict__ y, int rows,
                     int cols, Affine7<T> c) {
  const int nv = cols / V;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)rows * nv) return;
  const long long lane = (long long)blockIdx.y * rows * cols;
  x += lane;
  y += lane;
  const int i = (int)(t / nv);
  const int j = (int)(t - (long long)i * nv) * V;
  const long long idx = (long long)i * cols + j;
  using VT = Vec<T, V>;
  const VT zero{};
  const VT xc = *reinterpret_cast<const VT*>(x + idx);
  const VT s = i > 0 ? *reinterpret_cast<const VT*>(x + idx - cols) : zero;
  const VT n = i + 1 < rows ? *reinterpret_cast<const VT*>(x + idx + cols) : zero;
  const T w = j > 0 ? x[idx - 1] : T(0);
  const T e = j + V < cols ? x[idx + V] : T(0);
  VT out;
#pragma unroll
  for (int k = 0; k < V; ++k)
    out.v[k] = affine_pt(c, xc.v[k], k == 0 ? w : xc.v[k - 1],
                         k == V - 1 ? e : xc.v[k + 1], s.v[k], n.v[k]);
  *reinterpret_cast<VT*>(y + idx) = out;
}

// Row 0 first, then the last row, as the TPU kernel stores them: a one-row
// block takes both corrections in that order. A null row is no correction.
template <typename T>
__global__ void rdma_edges_kernel(T* __restrict__ y, const T* __restrict__ top,
                                  const T* __restrict__ bot, int rows, int cols,
                                  T b, T cs, T cn) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  y += (long long)blockIdx.y * rows * cols;
  if (top != nullptr) top += (long long)blockIdx.y * cols;
  if (bot != nullptr) bot += (long long)blockIdx.y * cols;
  if (top != nullptr) y[j] = y[j] + (b * cs) * top[j];
  if (bot != nullptr) {
    const long long last = (long long)(rows - 1) * cols + j;
    y[last] = y[last] + (b * cn) * bot[j];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// One thread per unit of `work` of each lane, in 256-thread CTAs (one CTA of
// whole warps for less work), the lane on gridDim.y, as K1 launches.
template <typename T, int V>
int launch_interior(const T* x, T* y, int lanes, int rows, int cols,
                    Affine7<T> c, cudaStream_t stream) {
  const long long work = (long long)rows * (cols / V);
  const dim3 grid((unsigned)((work + kThreads - 1) / kThreads), (unsigned)lanes);
  const dim3 block(work > 0 && work < kThreads ? 32 * (unsigned)((work + 31) / 32)
                                               : kThreads);
  rdma_interior_kernel<T, V><<<grid, block, 0, stream>>>(x, y, rows, cols, c);
  return (int)cudaGetLastError();
}

// A lane's grid holds whole rows of a multiple of V points on the chunk
// path, so every lane's first row stays on a 16-byte boundary.
template <typename T>
int interior(const T* x, T* y, int lanes, int rows, int cols, Affine7<T> c,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  const cudaStream_t s = (cudaStream_t)stream;
  if ((long long)rows * cols >= kChunkPoints && cols % V == 0 && aligned16(x) &&
      aligned16(y))
    return launch_interior<T, V>(x, y, lanes, rows, cols, c, s);
  return launch_interior<T, 1>(x, y, lanes, rows, cols, c, s);
}

template <typename T>
int edges(T* y, const T* top, const T* bot, int lanes, int rows, int cols,
          T b, T cs, T cn, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((cols + kEdgeBlock - 1) / kEdgeBlock), (unsigned)lanes);
  rdma_edges_kernel<T><<<grid, kEdgeBlock, 0, (cudaStream_t)stream>>>(
      y, top, bot, rows, cols, b, cs, cn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `lanes` grids of (rows, cols) in one contiguous block (1: one grid).
int gt_rdma_interior_f32(const float* x, float* y, int lanes, int rows, int cols,
                         float c0, float cw, float ce, float cs, float cn,
                         float a, float b, int device, void* stream) {
  return interior<float>(x, y, lanes, rows, cols, {c0, cw, ce, cs, cn, a, b},
                         device, stream);
}

int gt_rdma_interior_f64(const double* x, double* y, int lanes, int rows,
                         int cols, double c0, double cw, double ce, double cs,
                         double cn, double a, double b, int device,
                         void* stream) {
  return interior<double>(x, y, lanes, rows, cols, {c0, cw, ce, cs, cn, a, b},
                          device, stream);
}

// top, bot: (lanes, cols) arrays of halo rows, or null for no correction.
int gt_rdma_edges_f32(float* y, const float* top, const float* bot, int lanes,
                      int rows, int cols, float b, float cs, float cn,
                      int device, void* stream) {
  return edges<float>(y, top, bot, lanes, rows, cols, b, cs, cn, device, stream);
}

int gt_rdma_edges_f64(double* y, const double* top, const double* bot,
                      int lanes, int rows, int cols, double b, double cs,
                      double cn, int device, void* stream) {
  return edges<double>(y, top, bot, lanes, rows, cols, b, cs, cn, device,
                       stream);
}

}  // extern "C"
