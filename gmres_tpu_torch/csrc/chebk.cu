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
// What bounds it. A smoother needs one read of r and one write of z, so the
// bound is 2·rows·cols·sizeof(T) bytes; swept one pass at a time it moves r,
// z and d every sweep. The TPU keeps the grid in VMEM for all sweeps. Hopper
// has no grid-sized on-chip store (a CTA gets at most 227 KB of shared
// memory), and a deep polynomial on a small grid is bound by the latency of
// its k−1 dependent sweeps, not by bytes. Three paths, one per regime, chosen
// by the caller (chebk_plan in ops/fused.py, set by measurement on the card):
//
//  * chebk_cluster_kernel (path A, `_chebk_kernel`'s counterpart): the whole
//    grid in the shared memory of one thread-block cluster of up to 16 CTAs,
//    a band of rows per CTA, all k − 1 sweeps in one launch. A sweep with
//    one point a thread is a chain of dependent shared-memory loads and nine
//    rounded operations (one CTA at 16²: ~0.23 µs a sweep); a hardware
//    cluster barrier costs 0.4–0.8 µs (scripts/cluster_barrier_bench.cu on an
//    H100), so one barrier a sweep would more than double the cost. Each
//    CTA therefore also holds `ghost` rows of each neighbour band: it runs
//    `ghost` sweeps with only __syncthreads, the updated rows shrinking by
//    one a sweep from each ghost edge, then the bands swap their edge rows of
//    z and d through distributed shared memory (remote stores into the
//    neighbours' landing rows) and meet at one cluster barrier. A thread owns
//    fixed points of its window for the whole launch. One CTA (no ghosts, no
//    cluster barrier) takes the 16² coarse grid.
//  * chebk_tiled_kernel (path B, `_chebk_blocked_kernel`'s counterpart):
//    temporal blocking in one launch. Each CTA owns a T_r × T_c tile and its
//    window grown by h = k − 1 cells a side; each thread owns fixed 16-byte
//    row chunks of the window and keeps their r and d in registers, loaded
//    straight from global memory; shared memory holds the two z buffers
//    only. All k − 1 sweeps run there, the points outside the grid held at
//    zero (the TPU kernel's `in_grid` re-mask), and the last sweep writes the
//    interior from registers. r is read once (its halo mostly from L2) and z
//    written once: the single pass the TPU kernel exists for. The Poisson
//    stencil (unit neighbour coefficients) drops four multiplications a
//    point: x + (−1)·w is x − w, the same IEEE operation.
//  * chebk_sweep_kernel (path C): one launch per sweep over the whole card.
//    z is ping-ponged between two buffers, so no block reads a z value that
//    another block is writing; d is read and written only at its own point,
//    so it is updated in place. The first sweep derives z₀ = d₀ = r/θ from r
//    on the fly (the same division, so the same rounding). It takes what
//    neither fused path takes (more sweeps than the kernels carry, shapes
//    where it measured faster) and is the bitwise yardstick of the others.
//
// Rounding: each point's arithmetic is the same expression in the same order
// on every path (the plain PyTorch version's order), and the library is built
// with -fmad=false, so paths A and B give path C's bits.
//
// C interface (ctypes): returns cudaGetLastError() after the last launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxFusedSteps = 128;   // sweeps carried as kernel parameters
constexpr int kMaxClusterCtas = 16;
constexpr int kMaxThreads = 1024;
constexpr int kMaxDevices = 64;

template <typename T>
struct Coefs {
  T c0, cw, ce, cs, cn;
};

// The (a, b) pairs as a by-value kernel parameter: 2 KB for double, inside
// the 4 KB parameter block. The fused kernels take it __grid_constant__, so
// that indexing it by the sweep reads the parameter in place.
template <typename T>
struct Steps {
  T v[2 * kMaxFusedSteps];
};

template <typename T>
__device__ __forceinline__ T stencil5(const Coefs<T>& c, T xc, T w, T e, T s,
                                      T n) {
  return c.c0 * xc + c.cw * w + c.ce * e + c.cs * s + c.cn * n;
}

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
  return stencil5(c, xc, w, e, s, n);
}

// ---------------------------------------------------------------------------
// Path C: one launch per sweep.
// mode 0: z_out = r/θ (order 1: no sweep).
// mode 1: first sweep, z₀ = d₀ = r/θ implied.
// mode 2: later sweep, reading z_in and d.
// d_out may be null on the last sweep (d is not needed afterwards).
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// Path A: the grid resident in one cluster's shared memory.
// ---------------------------------------------------------------------------

// Band b of `csize` over `rows`: the first rows % csize bands are one row
// longer (ops/fused.py's chebk_bands is the same rule).
__device__ __forceinline__ void band_of(int b, int rows, int csize, int* start,
                                        int* count) {
  const int base = rows / csize, extra = rows % csize;
  *start = b * base + min(b, extra);
  *count = base + (b < extra ? 1 : 0);
}

// One element from global to shared memory, asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"((int)sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The hardware cluster barrier, split: arrive (releasing this thread's
// writes, remote ones included) and wait (acquiring everyone's). Every thread
// of every CTA executes each, alternately.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The points of the window one thread owns, at most this many.
constexpr int kMaxClusterPoints = 8;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
chebk_cluster_kernel(const T* __restrict__ r, T* __restrict__ z_out, int rows,
                     int cols, T theta, const __grid_constant__ Steps<T> steps,
                     int nsteps, Coefs<T> c, int ghost, int win_cap) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The window: the band's rows and `ghost` rows of each neighbour band
  // (none at the grid's edge). r, d and two z buffers of it, then the
  // landing rows the neighbours write: [epoch parity][from above, from
  // below][z, d][ghost rows]. Every CTA has the same layout.
  T* rs = reinterpret_cast<T*>(smem_raw);
  T* ds = rs + win_cap;
  T* zb0 = ds + win_cap;
  T* zb1 = zb0 + win_cap;
  T* land = zb1 + win_cap;
  const int gsz = ghost * cols;
  const int csize = (int)cluster.num_blocks();
  const int b = (int)cluster.block_rank();
  const bool multi = csize > 1;
  int start, count;
  band_of(b, rows, csize, &start, &count);
  const int g_up = b > 0 ? ghost : 0, g_dn = b + 1 < csize ? ghost : 0;
  const int win_rows = count + g_up + g_dn;
  const int npts = win_rows * cols;
  const int nt = blockDim.x;
  const T zero = T(0);

  const T* rg = r + (long long)(start - g_up) * cols;
  for (int p = threadIdx.x; p < npts; p += nt) cp_async(rs + p, rg + p);
  // This thread's points, fixed for the whole launch.
  int pi[kMaxClusterPoints], pj[kMaxClusterPoints];
#pragma unroll
  for (int m = 0; m < kMaxClusterPoints; ++m) {
    const int p = threadIdx.x + m * nt;
    pi[m] = p < npts ? p / cols : -1;
    pj[m] = p < npts ? p % cols : 0;
  }
  cp_async_wait_all();
#pragma unroll
  for (int m = 0; m < kMaxClusterPoints; ++m) {
    const int p = threadIdx.x + m * nt;
    if (pi[m] >= 0) {
      const T z0 = rs[p] / theta;
      ds[p] = z0;
      zb0[p] = z0;
    }
  }
  // Every CTA has started before any writes into another's shared memory
  // (the matching wait is at the first exchange).
  if (multi) cluster_arrive();
  __syncthreads();

  // Epochs of up to `ghost` sweeps with no cluster barrier: sweep k of an
  // epoch updates the window less k rows at each ghost edge (a grid edge is
  // a true zero boundary and does not shrink), so after the epoch the band's
  // own rows hold the sweeps' values. Then each band's first and last
  // `ghost` rows of z and d go to its neighbours, which refresh their ghost
  // rows from them. Without neighbours (one CTA) the whole run is one epoch.
  const int own_lo = g_up * cols, own_hi = (g_up + count) * cols;
  T* to_up = b > 0 ? cluster.map_shared_rank(land, b - 1) + 2 * gsz : nullptr;
  T* to_down = b + 1 < csize ? cluster.map_shared_rank(land, b + 1) : nullptr;
  int done = 0, epoch = 0;
  while (done < nsteps) {
    const int e = multi ? min(ghost, nsteps - done) : nsteps;
    for (int k = 1; k <= e; ++k) {
      const int s = done + k - 1;
      const T a = steps.v[2 * s];
      const T bs = steps.v[2 * s + 1];
      const T* zc = (s & 1) ? zb1 : zb0;
      T* zn = (s & 1) ? zb0 : zb1;
      const int lo = g_up > 0 ? k : 0, hi = g_dn > 0 ? win_rows - k : win_rows;
#pragma unroll
      for (int m = 0; m < kMaxClusterPoints; ++m) {
        const int i = pi[m], j = pj[m];
        if (i >= lo && i < hi) {
          const int p = threadIdx.x + m * nt;
          const T xc = zc[p];
          const T w = j > 0 ? zc[p - 1] : zero;
          const T ea = j + 1 < cols ? zc[p + 1] : zero;
          const T so = i > 0 ? zc[p - cols] : zero;
          const T no = i + 1 < win_rows ? zc[p + cols] : zero;
          const T az = stencil5(c, xc, w, ea, so, no);
          const T d = a * ds[p] + bs * (rs[p] - az);
          ds[p] = d;
          zn[p] = xc + d;
        }
      }
      __syncthreads();
    }
    done += e;
    if (done == nsteps) break;
    // Exchange; z after `done` sweeps is in buffer done % 2.
    T* zf = (done & 1) ? zb1 : zb0;
    const int par = (epoch & 1) * 4 * gsz;
    if (epoch == 0) cluster_wait();
    for (int q = threadIdx.x; q < gsz; q += nt) {
      if (to_up) {
        to_up[par + q] = zf[own_lo + q];
        to_up[par + gsz + q] = ds[own_lo + q];
      }
      if (to_down) {
        to_down[par + q] = zf[own_hi - gsz + q];
        to_down[par + gsz + q] = ds[own_hi - gsz + q];
      }
    }
    cluster_arrive();
    cluster_wait();
    for (int q = threadIdx.x; q < gsz; q += nt) {
      if (g_up > 0) {
        zf[q] = land[par + q];
        ds[q] = land[par + gsz + q];
      }
      if (g_dn > 0) {
        zf[own_hi + q] = land[par + 2 * gsz + q];
        ds[own_hi + q] = land[par + 3 * gsz + q];
      }
    }
    __syncthreads();
    ++epoch;
  }
  // Pair the first arrive when no exchange took place. After the last
  // exchange no CTA writes into another's shared memory.
  if (multi && epoch == 0) cluster_wait();
  const T* zf = (nsteps & 1) ? zb1 : zb0;
  T* og = z_out + (long long)start * cols;
  for (int p = own_lo + threadIdx.x; p < own_hi; p += nt) og[p - own_lo] = zf[p];
}

// ---------------------------------------------------------------------------
// Path B: temporally blocked tiles, one launch for all sweeps.
// ---------------------------------------------------------------------------

// A row chunk of V = 16 / sizeof(T) values, one 16-byte shared-memory access.
template <typename T>
struct __align__(16) Pack {
  static constexpr int n = 16 / sizeof(T);
  T v[n];
};

// The stencil of one point from its five values. kUnit: the four neighbour
// coefficients are −1 (the Poisson stencil), and x + (−1)·w is computed as
// x − w, which IEEE arithmetic defines as the same operation: the same bits.
template <typename T, bool kUnit>
__device__ __forceinline__ T stencil_pt(const Coefs<T>& c, T xc, T w, T e, T s,
                                        T n) {
  if (kUnit) return c.c0 * xc - w - e - s - n;
  return stencil5(c, xc, w, e, s, n);
}

// The chunks of the window one thread owns, at most this many.
constexpr int kMaxTileChunks = 4;
constexpr int kMaxTileThreads = 512;

// Each thread owns up to kMaxTileChunks row chunks of V = 16 / sizeof(T)
// points of the window (lr rows of lc, lc a multiple of V) for the whole
// launch, and keeps their r and d in registers; shared memory holds the two
// z buffers only. Every sweep updates the chunks of rows 1 … lr − 2 whole:
// the points within s cells of the window's edge come out wrong after sweep
// s (they read rows 0 and lr − 1, which never update, or wrap around a row
// end), and the written interior lies h cells in. A point outside the grid
// is set to zero every sweep, the zero boundary the plain version reads
// (checked only where the window crosses the grid's edge). The last sweep
// writes the interior to global memory from registers.
template <typename T, bool kUnit>
__global__ void __launch_bounds__(kMaxTileThreads)
chebk_tiled_kernel(const T* __restrict__ r, T* __restrict__ z_out, int rows,
                   int cols, T theta, const __grid_constant__ Steps<T> steps,
                   int nsteps, Coefs<T> c, int tile_r, int tile_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = Pack<T>::n;
  const int h = nsteps;
  const int lr = tile_r + 2 * h;
  const int lc = (tile_c + 2 * h + V - 1) / V * V;
  const int nch = lc / V, total = lr * nch;
  T* zb0 = reinterpret_cast<T*>(smem_raw);
  T* zb1 = zb0 + lr * lc;
  // Grid coordinates of the window's first cell.
  const int gi0 = blockIdx.y * tile_r - h, gj0 = blockIdx.x * tile_c - h;
  const bool inside = gi0 >= 0 && gj0 >= 0 && gi0 + lr <= rows && gj0 + lc <= cols;
  const int nt = blockDim.x;

  // r of this thread's chunks straight into registers (zero outside the
  // grid; all loads in flight at once), then z₀ = d₀ = r/θ.
  Pack<T> rv[kMaxTileChunks], dv[kMaxTileChunks];
  int off[kMaxTileChunks];
  unsigned in_grid[kMaxTileChunks];
#pragma unroll
  for (int m = 0; m < kMaxTileChunks; ++m) {
    const int q = threadIdx.x + m * nt;
    off[m] = -1;
    in_grid[m] = 0;
    if (q < total) {
      const int li = q / nch, lj = (q - li * nch) * V;
      off[m] = li * lc + lj;
      const int gi = gi0 + li;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int gj = gj0 + lj + k;
        const bool in = gi >= 0 && gi < rows && gj >= 0 && gj < cols;
        in_grid[m] |= (unsigned)in << k;
        rv[m].v[k] = in ? r[(long long)gi * cols + gj] : T(0);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kMaxTileChunks; ++m) {
    if (off[m] >= 0) {
#pragma unroll
      for (int k = 0; k < V; ++k) dv[m].v[k] = (in_grid[m] >> k) & 1 ? rv[m].v[k] / theta : T(0);
      *reinterpret_cast<Pack<T>*>(zb0 + off[m]) = dv[m];
    }
  }
  __syncthreads();
  const int lo = lc, hi = (lr - 1) * lc;
  for (int s = 1; s <= h; ++s) {
    // Sweep s reads buffer (s − 1) % 2 and writes buffer s % 2.
    const T* zc = (s & 1) ? zb0 : zb1;
    T* zn = (s & 1) ? zb1 : zb0;
    const T a = steps.v[2 * (s - 1)];
    const T bs = steps.v[2 * (s - 1) + 1];
#pragma unroll
    for (int m = 0; m < kMaxTileChunks; ++m) {
      const int o = off[m];
      if (o >= lo && o < hi) {
        const Pack<T> x = *reinterpret_cast<const Pack<T>*>(zc + o);
        const Pack<T> so = *reinterpret_cast<const Pack<T>*>(zc + o - lc);
        const Pack<T> no = *reinterpret_cast<const Pack<T>*>(zc + o + lc);
        const T west = zc[o - 1], east = zc[o + V];
        Pack<T> zo;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const T w = k == 0 ? west : x.v[k - 1];
          const T e = k == V - 1 ? east : x.v[k + 1];
          const T az = stencil_pt<T, kUnit>(c, x.v[k], w, e, so.v[k], no.v[k]);
          T d = a * dv[m].v[k] + bs * (rv[m].v[k] - az);
          T z = x.v[k] + d;
          if (!inside && !((in_grid[m] >> k) & 1)) d = z = T(0);
          dv[m].v[k] = d;
          zo.v[k] = z;
        }
        if (s < h) {
          *reinterpret_cast<Pack<T>*>(zn + o) = zo;
        } else {
          const int li = o / lc, lj = o - li * lc;
          if (li >= h && li < h + tile_r) {
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const int gi = gi0 + li, gj = gj0 + lj + k;
              if (lj + k >= h && lj + k < h + tile_c && gi < rows && gj < cols) {
                z_out[(long long)gi * cols + gj] = zo.v[k];
              }
            }
          }
        }
      }
    }
    if (s < h) __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// cudaFuncSetAttribute once per kernel instantiation and device: dynamic
// shared memory up to the device's opt-in maximum, and (for the cluster
// kernel) clusters beyond the portable 8 CTAs.
template <typename K>
cudaError_t configure_once(K* kernel, int device, bool cluster, bool* done) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess && cluster) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) done[device] = true;
  return err;
}

template <typename T>
cudaError_t configure_cluster(int device) {
  static bool done[kMaxDevices];
  return configure_once(chebk_cluster_kernel<T>, device, true, done);
}

template <typename T, bool kUnit>
cudaError_t configure_tiled(int device) {
  static bool done[kMaxDevices];
  return configure_once(chebk_tiled_kernel<T, kUnit>, device, false, done);
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int csize, int threads, size_t smem, cudaStream_t st) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(csize, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The window of the cluster path: the longest band and `ghost` rows of each
// neighbour; one CTA's shared memory holds r, d and two z buffers of it and
// the landing rows, 2 · 2 · 2 · ghost rows.
inline int cluster_window(int rows, int cols, int csize, int ghost) {
  return ((rows + csize - 1) / csize + 2 * ghost) * cols;
}

inline bool cluster_shape_ok(int rows, int cols, int csize, int threads, int ghost) {
  return csize >= 1 && csize <= kMaxClusterCtas && csize <= rows && threads >= 32 &&
         threads <= kMaxThreads && ghost >= (csize > 1 ? 1 : 0) && ghost <= rows / csize &&
         cluster_window(rows, cols, csize, ghost) <= kMaxClusterPoints * threads;
}

template <typename T>
size_t cluster_smem(int rows, int cols, int csize, int ghost) {
  return (4 * (size_t)cluster_window(rows, cols, csize, ghost) + 8 * (size_t)ghost * cols) *
         sizeof(T);
}

// The tiled path's window: tile_r + 2h rows of tile_c + 2h points, padded to
// whole chunks; one CTA's shared memory holds its two z buffers.
template <typename T>
int tiled_chunks(int tile_r, int tile_c, int nsteps) {
  constexpr int V = Pack<T>::n;
  return (tile_r + 2 * nsteps) * ((tile_c + 2 * nsteps + V - 1) / V);
}

template <typename T>
size_t tiled_smem(int tile_r, int tile_c, int nsteps) {
  return 2 * (size_t)tiled_chunks<T>(tile_r, tile_c, nsteps) * 16;
}

template <typename T>
int launch(const T* r, T* z_out, T* z_scratch, T* d, int rows, int cols,
           T theta, const T* steps, int nsteps, const T* coefs, int path,
           int p0, int p1, int p2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const Coefs<T> c{coefs[0], coefs[1], coefs[2], coefs[3], coefs[4]};

  if (path == 1 || path == 2) {
    if (nsteps < 1 || nsteps > kMaxFusedSteps) return (int)cudaErrorInvalidValue;
    Steps<T> sv;
    for (int s = 0; s < 2 * nsteps; ++s) sv.v[s] = steps[s];
    if (path == 1) {
      // p0: CTAs in the cluster; p1: threads per CTA; p2: ghost rows (0
      // for one CTA; at most the shortest band's rows otherwise).
      const int csize = p0, threads = p1, ghost = csize > 1 ? p2 : 0;
      if (!cluster_shape_ok(rows, cols, csize, threads, ghost)) {
        return (int)cudaErrorInvalidValue;
      }
      err = configure_cluster<T>(device);
      if (err != cudaSuccess) return (int)err;
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr;
      cluster_config(&cfg, &attr, csize, threads, cluster_smem<T>(rows, cols, csize, ghost),
                     st);
      err = cudaLaunchKernelEx(&cfg, chebk_cluster_kernel<T>, r, z_out, rows, cols,
                               theta, sv, nsteps, c, ghost,
                               cluster_window(rows, cols, csize, ghost));
      if (err != cudaSuccess) return (int)err;
      return (int)cudaGetLastError();
    }
    // p0 × p1: the tile each CTA writes; p2: threads per CTA.
    const int tile_r = p0, tile_c = p1, threads = p2;
    if (tile_r < 1 || tile_c < 1 || threads < 32 || threads % 32 || threads > kMaxTileThreads ||
        tiled_chunks<T>(tile_r, tile_c, nsteps) > kMaxTileChunks * threads) {
      return (int)cudaErrorInvalidValue;
    }
    const bool unit = c.cw == T(-1) && c.ce == T(-1) && c.cs == T(-1) && c.cn == T(-1);
    err = unit ? configure_tiled<T, true>(device) : configure_tiled<T, false>(device);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = tiled_smem<T>(tile_r, tile_c, nsteps);
    const dim3 grid((cols + tile_c - 1) / tile_c, (rows + tile_r - 1) / tile_r);
    if (unit) {
      chebk_tiled_kernel<T, true><<<grid, threads, smem, st>>>(
          r, z_out, rows, cols, theta, sv, nsteps, c, tile_r, tile_c);
    } else {
      chebk_tiled_kernel<T, false><<<grid, threads, smem, st>>>(
          r, z_out, rows, cols, theta, sv, nsteps, c, tile_r, tile_c);
    }
    return (int)cudaGetLastError();
  }
  if (path != 0) return (int)cudaErrorInvalidValue;

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

// How many clusters of the cluster path can be resident at once (0: the
// shape cannot be scheduled); a negative value is a CUDA error code.
template <typename T>
int max_active_clusters(int rows, int cols, int csize, int threads, int ghost,
                        int device) {
  if (!cluster_shape_ok(rows, cols, csize, threads, ghost)) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = configure_cluster<T>(device);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, csize, threads, cluster_smem<T>(rows, cols, csize, ghost), 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, chebk_cluster_kernel<T>, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused query must not fail the next launch
    return -(int)err;
  }
  return n;
}

}  // namespace

extern "C" {

// path 0: one launch per sweep; 1: cluster-resident (p0 CTAs of p1 threads,
// p2 ghost rows); 2: temporally blocked tiles (p0 × p1 tiles, p2 threads).
int gt_chebk_f32(const float* r, float* z_out, float* z_scratch, float* d,
                 int rows, int cols, float theta, const float* steps,
                 int nsteps, const float* coefs, int path, int p0, int p1,
                 int p2, int device, void* stream) {
  return launch<float>(r, z_out, z_scratch, d, rows, cols, theta, steps, nsteps,
                       coefs, path, p0, p1, p2, device, stream);
}

int gt_chebk_f64(const double* r, double* z_out, double* z_scratch, double* d,
                 int rows, int cols, double theta, const double* steps,
                 int nsteps, const double* coefs, int path, int p0, int p1,
                 int p2, int device, void* stream) {
  return launch<double>(r, z_out, z_scratch, d, rows, cols, theta, steps,
                        nsteps, coefs, path, p0, p1, p2, device, stream);
}

int gt_chebk_max_active_clusters(int f64, int rows, int cols, int csize,
                                 int threads, int ghost, int device) {
  return f64 ? max_active_clusters<double>(rows, cols, csize, threads, ghost, device)
             : max_active_clusters<float>(rows, cols, csize, threads, ghost, device);
}

int gt_chebk_max_fused_steps(void) { return kMaxFusedSteps; }

}  // extern "C"
