// K1: the general 5-point stencil on a (rows, cols) block, for Hopper (sm_90a),
// and its two fused forms for the multigrid V-cycle.
//
//   y(i,j) = c0·x(i,j) + cw·x(i,j−1) + ce·x(i,j+1) + cs·x(i−1,j) + cn·x(i+1,j)
//
// with zeros outside the block, except that row −1 is read from `top` and row
// `rows` from `bot` when those pointers are not null (a null pointer is a zero
// row — the Dirichlet boundary, or a shard with no neighbour on that side).
//
// Replaces the Pallas kernels `_halo_kernel` (gmres_tpu/ops/stencil.py,
// behind stencil_5pt_pallas_halo / stencil_5pt_pallas) and `_blocked_kernel`
// (behind stencil_5pt_pallas_blocked). The TPU versions cut the grid into
// row blocks with 8-row halo windows because of Mosaic's (8, 128) sublane
// tiling and VMEM size; neither constraint exists here, so one launch covers
// any (rows, cols).
//
// The fused forms take the place of the jnp operations that XLA fused around
// the TPU kernel in one V-cycle level (gmres_tpu/precond/multigrid.py), which
// eager PyTorch runs as separate launches over the whole level:
//
//   residual-restrict  rc = restrict_sum(r − A·e): fine (2m, 2mc) r and e to
//                      the coarse (m, mc) grid; the fine residual is never
//                      written.
//   correct-residual   e' = e + prolong_repeat(ec) and r3 = r − A·e', writing
//                      e' and r3; the prolonged grid is never written.
//
// What bounds them: at 2048² (the finest mg level) HBM bytes. Each point does
// ~11 flops against 10–20 bytes, far under the card's balance point. At
// 2048² float32, residual-restrict moves 37.7 MB (r and e read, rc written)
// where the composition (K1 33.6, the subtraction 50.3, the two strided adds
// 37.7) moves 121.6 MB, and correct-residual 71.3 MB (r, e, ec read; e' and
// r3 written) where the two repeats (37.7), the add (50.3), K1 (33.6) and the
// subtraction (50.3) move 172.0 MB: 184.6 MB less a cycle at level 0, 55 µs
// at 3.35 TB/s. Below ~512² a grid sits in the 50 MB L2 and a launch costs
// more than its bytes (300² float32 is 360 KB), so there the design saves
// launches: one instead of four, and one instead of five.
//
// Design. One thread owns a 2×2 quad of fine points (one coarse point), so
// the restriction is a sum in registers and ec is read once per quad. Its two
// rows' pairs, and the pairs above and below, are single 8-byte (float32) or
// 16-byte (float64) loads where the pointers are aligned to a pair (a fine
// row has an even length, so then every pair is); the west and east
// neighbours are scalar loads that hit L1. Warps run along coarse rows: 32
// threads cover 64 consecutive fine columns, so every load is coalesced. A
// flat grid of 256-thread CTAs gives 4096 CTAs at 2048² (31 a SM) and 22 at
// 150².
//
// The plain stencil takes V = 16 / sizeof(T) consecutive points a thread
// with 16-byte loads and stores on grids of kChunkPoints points or more,
// where the row length and the pointers allow, and one point a thread
// otherwise. The chunks are chosen by size because that is where they were
// measured faster: at 2048² float32, reading HBM, they take the kernel from
// 1.9× its byte bound to 1.24×, while at the halo path's 304² float64 one
// point a thread was as fast or faster (both near the launch floor;
// PERF.md).
//
// Programmatic dependent launch (letting a kernel start while its
// predecessor drains) was measured on the V-cycle's K2 → form → K2 chain and
// the halo path's K5 → K1 chain in CUDA-graph replay and is not used: no
// path runs these kernels back to back in a graph, and the V-cycle's chain
// was no faster with it (PERF.md).
//
// Rounding: the stencil sum is evaluated in the order of the plain PyTorch
// version (c0·x + cw·W + ce·E + cs·S + cn·N, left to right), a residual is one
// subtraction after it, the restriction sums rows first as restrict_sum does,
// e' is one addition, and a neighbour's e' is rebuilt from e and ec the same
// way. The library is built with -fmad=false, so each product and sum rounds
// exactly as the separate PyTorch operations do: every form is bitwise equal
// to its plain version.
//
// Lanes. Each form also takes a contiguous (lanes, rows, cols) block of grids
// in one launch, the lane on gridDim.y: the batched launch that jax.vmap makes
// of the Pallas kernel (a leading grid axis), which a block application
// (torch.func.vmap over an operator or a V-cycle) reaches through the vmap
// rules of ops/stencil.py. A lane's threads run the single grid's arithmetic
// on the lane's slice, so every lane gives the bits of its own launch. The
// plain stencil also takes a (lanes, 5) device array of coefficients, one set
// per lane (an operator family swept over lanes; null: the five values
// given to every lane), and per-lane halo rows: `top` and `bot` are then
// (lanes, cols) arrays, lane ℓ's row at ℓ·cols (a null pointer is a zero row
// in every lane). That is the halo route's block form: a block of s rows of a
// row-sharded grid, what jax.vmap makes of the halo kernel, is one exchange of
// the s rows' boundary rows and one launch. At 2048²
// float32 a lane already fills the card (4096 CTAs), so the lanes save
// launches, not bandwidth; below ~512² they also fill the card where one grid
// does not (22 CTAs at 150²).
//
// C interface (ctypes): each entry point returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// The smallest grid (in points) on which the plain stencil takes row chunks.
constexpr long long kChunkPoints = 1 << 20;

template <typename T>
struct Coefs5 {
  T c0, cw, ce, cs, cn;
};

// K1's order of the five terms.
template <typename T>
__device__ __forceinline__ T stencil_pt(const Coefs5<T>& c, T x, T w, T e, T s,
                                        T n) {
  return c.c0 * x + c.cw * w + c.ce * e + c.cs * s + c.cn * n;
}

// The coefficients of lane blockIdx.y: its row of the (lanes, 5) array, or
// the shared set where there is no array.
template <typename T>
__device__ __forceinline__ Coefs5<T> lane_coefs(const Coefs5<T>& c,
                                                const T* __restrict__ per_lane) {
  if (per_lane == nullptr) return c;
  const T* p = per_lane + 5 * blockIdx.y;
  return Coefs5<T>{p[0], p[1], p[2], p[3], p[4]};
}

// V consecutive values of a row; one vector access when aligned to its size.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V, bool kAligned>
__device__ __forceinline__ Vec<T, V> load(const T* __restrict__ p) {
  if constexpr (kAligned) {
    return *reinterpret_cast<const Vec<T, V>*>(p);
  } else {
    Vec<T, V> out;
#pragma unroll
    for (int k = 0; k < V; ++k) out.v[k] = p[k];
    return out;
  }
}

template <typename T, int V, bool kAligned>
__device__ __forceinline__ void store(T* __restrict__ p, const Vec<T, V>& x) {
  if constexpr (kAligned) {
    *reinterpret_cast<Vec<T, V>*>(p) = x;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = x.v[k];
  }
}

// The plain stencil, V points a thread (V = 1: one point, any alignment).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
stencil5_kernel(const T* __restrict__ x, const T* __restrict__ top,
                const T* __restrict__ bot, T* __restrict__ y, int rows,
                int cols, Coefs5<T> c0, const T* __restrict__ per_lane) {
  const int nv = cols / V;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)rows * nv) return;
  const long long lane = (long long)blockIdx.y * rows * cols;
  x += lane;
  y += lane;
  // Lane ℓ's halo rows: row ℓ of the (lanes, cols) arrays.
  if (top != nullptr) top += (long long)blockIdx.y * cols;
  if (bot != nullptr) bot += (long long)blockIdx.y * cols;
  const Coefs5<T> c = lane_coefs(c0, per_lane);
  const int i = (int)(t / nv);
  const int j = (int)(t - (long long)i * nv) * V;
  const long long idx = (long long)i * cols + j;
  const Vec<T, V> zero{};
  const Vec<T, V> xc = load<T, V, true>(x + idx);
  const Vec<T, V> s = i > 0 ? load<T, V, true>(x + idx - cols)
                            : (top != nullptr ? load<T, V, true>(top + j) : zero);
  const Vec<T, V> n = i + 1 < rows ? load<T, V, true>(x + idx + cols)
                                   : (bot != nullptr ? load<T, V, true>(bot + j) : zero);
  const T w = j > 0 ? x[idx - 1] : T(0);
  const T e = j + V < cols ? x[idx + V] : T(0);
  Vec<T, V> out;
#pragma unroll
  for (int k = 0; k < V; ++k)
    out.v[k] = stencil_pt(c, xc.v[k], k == 0 ? w : xc.v[k - 1],
                          k == V - 1 ? e : xc.v[k + 1], s.v[k], n.v[k]);
  store<T, V, true>(y + idx, out);
}

// The quad of coarse point t of an (mr, mc) coarse grid: fine rows i0, i0 + 1
// and columns j0, j0 + 1 of the (2mr, 2mc) fine grid.
struct Quad {
  int I, J, i0, j0, rows, cols;
  long long a, b;  // offsets of the quad's two fine-row pairs
  __device__ Quad(long long t, int mr, int mc) {
    I = (int)(t / mc);
    J = (int)(t - (long long)I * mc);
    rows = 2 * mr;
    cols = 2 * mc;
    i0 = 2 * I;
    j0 = 2 * J;
    a = (long long)i0 * cols + j0;
    b = a + cols;
  }
};

// rc(I,J) = (x(i0,j0) + x(i0+1,j0)) + (x(i0,j0+1) + x(i0+1,j0+1)) with
// x = r − A·e at the four fine points.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
residual_restrict_kernel(const T* __restrict__ r, const T* __restrict__ e,
                         T* __restrict__ rc, int mr, int mc, Coefs5<T> c) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)mr * mc) return;
  const long long lane = (long long)blockIdx.y * mr * mc;
  r += 4 * lane;
  e += 4 * lane;
  rc += lane;
  const Quad q(t, mr, mc);
  const Vec<T, 2> zero{};
  const Vec<T, 2> ea = load<T, 2, kAligned>(e + q.a);
  const Vec<T, 2> eb = load<T, 2, kAligned>(e + q.b);
  const Vec<T, 2> up = q.i0 > 0 ? load<T, 2, kAligned>(e + q.a - q.cols) : zero;
  const Vec<T, 2> dn = q.i0 + 2 < q.rows ? load<T, 2, kAligned>(e + q.b + q.cols) : zero;
  const bool west = q.j0 > 0, east = q.j0 + 2 < q.cols;
  const T wa = west ? e[q.a - 1] : T(0), wb = west ? e[q.b - 1] : T(0);
  const T xa = east ? e[q.a + 2] : T(0), xb = east ? e[q.b + 2] : T(0);
  const Vec<T, 2> ra = load<T, 2, kAligned>(r + q.a);
  const Vec<T, 2> rb = load<T, 2, kAligned>(r + q.b);
  const T x00 = ra.v[0] - stencil_pt(c, ea.v[0], wa, ea.v[1], up.v[0], eb.v[0]);
  const T x01 = ra.v[1] - stencil_pt(c, ea.v[1], ea.v[0], xa, up.v[1], eb.v[1]);
  const T x10 = rb.v[0] - stencil_pt(c, eb.v[0], wb, eb.v[1], ea.v[0], dn.v[0]);
  const T x11 = rb.v[1] - stencil_pt(c, eb.v[1], eb.v[0], xb, ea.v[1], dn.v[1]);
  rc[t] = (x00 + x10) + (x01 + x11);
}

// e' = e + ec(I,J) on the quad, r3 = r − A·e' there; each neighbour's e' is
// rebuilt from e and its own coarse value, zero outside the grid.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
correct_residual_kernel(const T* __restrict__ r, const T* __restrict__ e,
                        const T* __restrict__ ec, T* __restrict__ e_out,
                        T* __restrict__ r_out, int mr, int mc, Coefs5<T> c) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)mr * mc) return;
  const long long lane = (long long)blockIdx.y * mr * mc;
  r += 4 * lane;
  e += 4 * lane;
  e_out += 4 * lane;
  r_out += 4 * lane;
  ec += lane;
  const Quad q(t, mr, mc);
  const T g = ec[t];
  Vec<T, 2> ea = load<T, 2, kAligned>(e + q.a);
  Vec<T, 2> eb = load<T, 2, kAligned>(e + q.b);
  Vec<T, 2> up{}, dn{};
  if (q.I > 0) {
    const T gu = ec[t - mc];
    up = load<T, 2, kAligned>(e + q.a - q.cols);
    up.v[0] = up.v[0] + gu;
    up.v[1] = up.v[1] + gu;
  }
  if (q.I + 1 < mr) {
    const T gd = ec[t + mc];
    dn = load<T, 2, kAligned>(e + q.b + q.cols);
    dn.v[0] = dn.v[0] + gd;
    dn.v[1] = dn.v[1] + gd;
  }
  T wa = T(0), wb = T(0), xa = T(0), xb = T(0);
  if (q.J > 0) {
    const T gw = ec[t - 1];
    wa = e[q.a - 1] + gw;
    wb = e[q.b - 1] + gw;
  }
  if (q.J + 1 < mc) {
    const T ge = ec[t + 1];
    xa = e[q.a + 2] + ge;
    xb = e[q.b + 2] + ge;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    ea.v[k] = ea.v[k] + g;
    eb.v[k] = eb.v[k] + g;
  }
  store<T, 2, kAligned>(e_out + q.a, ea);
  store<T, 2, kAligned>(e_out + q.b, eb);
  const Vec<T, 2> ra = load<T, 2, kAligned>(r + q.a);
  const Vec<T, 2> rb = load<T, 2, kAligned>(r + q.b);
  Vec<T, 2> oa, ob;
  oa.v[0] = ra.v[0] - stencil_pt(c, ea.v[0], wa, ea.v[1], up.v[0], eb.v[0]);
  oa.v[1] = ra.v[1] - stencil_pt(c, ea.v[1], ea.v[0], xa, up.v[1], eb.v[1]);
  ob.v[0] = rb.v[0] - stencil_pt(c, eb.v[0], wb, eb.v[1], ea.v[0], dn.v[0]);
  ob.v[1] = rb.v[1] - stencil_pt(c, eb.v[1], eb.v[0], xb, ea.v[1], dn.v[1]);
  store<T, 2, kAligned>(r_out + q.a, oa);
  store<T, 2, kAligned>(r_out + q.b, ob);
}

// The launch floor: a kernel that does nothing, one CTA of one warp.
__global__ void empty_kernel() {}

// One thread per unit of `work` of each of `lanes` grids, in 256-thread CTAs
// (one CTA of whole warps for less work), the lane on gridDim.y.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), long long work, int lanes, int device,
           void* stream, Args... args) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((work + kThreads - 1) / kThreads), (unsigned)lanes);
  const dim3 block(work > 0 && work < kThreads ? 32 * (unsigned)((work + 31) / 32)
                                               : kThreads);
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

// `top` and `bot`, where not null, hold one row a lane.
template <typename T>
int stencil5(const T* x, const T* top, const T* bot, T* y, int lanes, int rows,
             int cols, Coefs5<T> c, const T* per_lane, int device, void* stream) {
  constexpr int V = 16 / sizeof(T);
  // Every lane's first row (and halo row) on a chunk boundary too.
  const bool lanes_aligned = lanes == 1 || ((long long)rows * cols * sizeof(T)) % 16 == 0;
  if ((long long)rows * cols >= kChunkPoints && cols % V == 0 && lanes_aligned &&
      aligned(x, 16) && aligned(top, 16) && aligned(bot, 16) && aligned(y, 16))
    return launch(stencil5_kernel<T, V>, (long long)rows * (cols / V), lanes,
                  device, stream, x, top, bot, y, rows, cols, c, per_lane);
  return launch(stencil5_kernel<T, 1>, (long long)rows * cols, lanes, device,
                stream, x, top, bot, y, rows, cols, c, per_lane);
}

// A lane's fine grid holds 4·mr·mc points, so its pairs stay aligned.
template <typename T>
int residual_restrict(const T* r, const T* e, T* rc, int lanes, int mr, int mc,
                      Coefs5<T> c, int device, void* stream) {
  const int pair = 2 * sizeof(T);
  if (aligned(r, pair) && aligned(e, pair))
    return launch(residual_restrict_kernel<T, true>, (long long)mr * mc, lanes,
                  device, stream, r, e, rc, mr, mc, c);
  return launch(residual_restrict_kernel<T, false>, (long long)mr * mc, lanes,
                device, stream, r, e, rc, mr, mc, c);
}

template <typename T>
int correct_residual(const T* r, const T* e, const T* ec, T* e_out, T* r_out,
                     int lanes, int mr, int mc, Coefs5<T> c, int device,
                     void* stream) {
  const int pair = 2 * sizeof(T);
  if (aligned(r, pair) && aligned(e, pair) && aligned(e_out, pair) &&
      aligned(r_out, pair))
    return launch(correct_residual_kernel<T, true>, (long long)mr * mc, lanes,
                  device, stream, r, e, ec, e_out, r_out, mr, mc, c);
  return launch(correct_residual_kernel<T, false>, (long long)mr * mc, lanes,
                device, stream, r, e, ec, e_out, r_out, mr, mc, c);
}

}  // namespace

extern "C" {

// `lanes` grids of (rows, cols) in one contiguous block; top, bot: (lanes,
// cols) arrays of halo rows, or null for zero rows; per_lane: a (lanes, 5)
// device array of coefficients, or null for c0 … cn in every lane.
int gt_stencil5_f32(const float* x, const float* top, const float* bot, float* y,
                    int lanes, int rows, int cols, float c0, float cw, float ce,
                    float cs, float cn, const float* per_lane, int device,
                    void* stream) {
  return stencil5<float>(x, top, bot, y, lanes, rows, cols, {c0, cw, ce, cs, cn},
                         per_lane, device, stream);
}

int gt_stencil5_f64(const double* x, const double* top, const double* bot,
                    double* y, int lanes, int rows, int cols, double c0,
                    double cw, double ce, double cs, double cn,
                    const double* per_lane, int device, void* stream) {
  return stencil5<double>(x, top, bot, y, lanes, rows, cols, {c0, cw, ce, cs, cn},
                          per_lane, device, stream);
}

int gt_residual_restrict_f32(const float* r, const float* e, float* rc, int lanes,
                             int mr, int mc, float c0, float cw, float ce,
                             float cs, float cn, int device, void* stream) {
  return residual_restrict<float>(r, e, rc, lanes, mr, mc, {c0, cw, ce, cs, cn},
                                  device, stream);
}

int gt_residual_restrict_f64(const double* r, const double* e, double* rc,
                             int lanes, int mr, int mc, double c0, double cw,
                             double ce, double cs, double cn, int device,
                             void* stream) {
  return residual_restrict<double>(r, e, rc, lanes, mr, mc, {c0, cw, ce, cs, cn},
                                   device, stream);
}

int gt_correct_residual_f32(const float* r, const float* e, const float* ec,
                            float* e_out, float* r_out, int lanes, int mr,
                            int mc, float c0, float cw, float ce, float cs,
                            float cn, int device, void* stream) {
  return correct_residual<float>(r, e, ec, e_out, r_out, lanes, mr, mc,
                                 {c0, cw, ce, cs, cn}, device, stream);
}

int gt_correct_residual_f64(const double* r, const double* e, const double* ec,
                            double* e_out, double* r_out, int lanes, int mr,
                            int mc, double c0, double cw, double ce, double cs,
                            double cn, int device, void* stream) {
  return correct_residual<double>(r, e, ec, e_out, r_out, lanes, mr, mc,
                                  {c0, cw, ce, cs, cn}, device, stream);
}

int gt_empty(int device, void* stream) {
  return launch(empty_kernel, 32, 1, device, stream);
}

const char* gt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
