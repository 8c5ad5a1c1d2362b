// K7: the fused CG update and the fused axpy-dot, for Hopper (sm_90a).
//
//   K7a  gt_cg_update:  xo = x + α·p,  ro = r − α·ap,  sum = Σ f32(ro)²
//   K7b  gt_axpy_dot:   yo = y + α·x,  sum = Σ f32(yo)·f32(z)
//
// The elementwise work is in the input dtype; the products and the sum are in
// float32 and the sum is returned as a float32 scalar, the contract of the JAX
// kernels (the f32 casts and the (1, 1) float32 out_shape). α comes by value
// (a Python number, rounded to the dtype on the host as JAX's
// jnp.asarray(alpha, dtype=x.dtype) rounds it) or by pointer (a 0-d float32
// or float64 tensor on the card, rounded to the dtype here), so neither
// needs a host round trip; both give the same bits.
//
// Replaces the Pallas kernels `_cg_update_kernel` (behind cg_fused_update) and
// `_axpy_dot_kernel` (behind axpy_dot), gmres_tpu/ops/fused.py. The TPU
// kernels are one whole-block VMEM pass whose sum is one scalar accumulator.
// Blocks on Hopper run in parallel and in no order, so the sum crosses blocks
// in the same launch: each block writes its float32 partial (warp shuffles,
// then one warp over the warps' sums) and takes a ticket with one atomic
// add (acq_rel, so the add also publishes the partial, as __threadfence()
// before it would) on a counter; the block that draws the last ticket sums
// all the partials in a fixed order, writes the 0-d result and resets the
// counter to 0 for the next call. The atomic orders only the
// tickets, never the sum, so repeated calls give the same bits. The wrapper
// owns the partials (one float per block, per call) and the counter (zeroed
// once and kept per device and stream, so two streams never share one, and
// CUDA-graph replay finds it at 0 as an eager call does).
//
// What bounds it: memory. K7a moves six vectors (four read, two written), K7b
// four (three read, one written), at 3–4 flops a point: far under the card's
// balance point. At 304² float64 that is 4.4 and 3.0 MB, 1.3 and 0.9 µs at
// 3.35 TB/s, near the launch floor (~1 µs): there the design's answer is one
// launch instead of two and a grid that fills the card. The cross-block sum
// costs its own dependent round trips to L2 all the same (the ticket, then
// the last block's read of the partials): scripts/k7_tail_bench.cu measured
// the pass alone at 2.3 µs at 304² float64 and the tail at ~1.2 µs, as much
// as the second launch it replaces. Each thread takes V =
// 16 / sizeof(T) consecutive elements a step with 16-byte loads and stores
// where every operand is aligned to 16 bytes (one element otherwise; the
// last n mod V elements one a thread), consecutive threads on consecutive
// chunks, in a grid-stride loop. The grid (ops/fused.py, k7_plan) is one
// 256-thread block per 256 chunks, capped at 4 blocks an SM, and never fewer
// blocks than SMs while each still gets a warp's worth of chunks: at least
// one full wave of the card's 132 SMs. The grid depends on the SM count and
// the vector width on the operands' alignment, and the sum's order on both:
// the bits of a sum are fixed for a card and a layout, not across cards.
//
// C interface (ctypes): returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a vector width or grid the wrapper should not
// have asked for.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// α: by value (kind 0) or from a float32 (1) or float64 (2) on the card.
template <typename T>
__device__ __forceinline__ T read_alpha(const void* p, int kind, T value) {
  if (kind == 1) return (T)*static_cast<const float*>(p);
  if (kind == 2) return (T)*static_cast<const double*>(p);
  return value;
}

// Sum of v over the block, valid in thread 0. Fixed order: shuffles down
// within each warp, then warp 0 over the warps' sums.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// This block's partial, its ticket, and in the last block the sum of every
// partial (thread k over partials k, k + 256, …, then block_sum) into *out.
// The ticket is one acq_rel atomic: its release publishes this block's
// partial, its acquire (passed on to the block by __syncthreads) makes every
// earlier block's visible to the last one. scripts/k7_tail_bench.cu measured
// it 0.35 µs faster at 304² float64 than __threadfence() before and after a
// plain atomicAdd, with the same bits.
__device__ void finish(float acc, float* __restrict__ partial,
                       unsigned int* __restrict__ counter, float* __restrict__ out) {
  __shared__ bool last;
  const float s = block_sum(acc);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s;
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(*counter);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  float v = 0.0f;
  for (unsigned int i = threadIdx.x; i < gridDim.x; i += kThreads)
    v += __ldcg(partial + i);
  v = block_sum(v);
  if (threadIdx.x == 0) {
    *out = v;
    *counter = 0u;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
cg_update_kernel(const void* alpha_p, int alpha_kind, T alpha_value,
                 const T* __restrict__ x, const T* __restrict__ r,
                 const T* __restrict__ p, const T* __restrict__ ap,
                 T* __restrict__ xo, T* __restrict__ ro, float* __restrict__ partial,
                 unsigned int* __restrict__ counter, float* __restrict__ out,
                 long long n) {
  using VT = Vec<T, V>;
  const T a = read_alpha<T>(alpha_p, alpha_kind, alpha_value);
  const long long nvec = n / V;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  float acc = 0.0f;
  for (long long i = t; i < nvec; i += stride) {
    const VT xv = reinterpret_cast<const VT*>(x)[i];
    const VT rv = reinterpret_cast<const VT*>(r)[i];
    const VT pv = reinterpret_cast<const VT*>(p)[i];
    const VT av = reinterpret_cast<const VT*>(ap)[i];
    VT xn, rn;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      xn.v[k] = xv.v[k] + a * pv.v[k];
      rn.v[k] = rv.v[k] - a * av.v[k];
      const float rf = (float)rn.v[k];
      acc += rf * rf;
    }
    reinterpret_cast<VT*>(xo)[i] = xn;
    reinterpret_cast<VT*>(ro)[i] = rn;
  }
  const long long i = nvec * V + t;  // the last n mod V elements
  if (i < n) {
    xo[i] = x[i] + a * p[i];
    const T rn = r[i] - a * ap[i];
    ro[i] = rn;
    const float rf = (float)rn;
    acc += rf * rf;
  }
  finish(acc, partial, counter, out);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
axpy_dot_kernel(const void* alpha_p, int alpha_kind, T alpha_value,
                const T* __restrict__ x, const T* __restrict__ y,
                const T* __restrict__ z, T* __restrict__ yo,
                float* __restrict__ partial, unsigned int* __restrict__ counter,
                float* __restrict__ out, long long n) {
  using VT = Vec<T, V>;
  const T a = read_alpha<T>(alpha_p, alpha_kind, alpha_value);
  const long long nvec = n / V;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  float acc = 0.0f;
  for (long long i = t; i < nvec; i += stride) {
    const VT xv = reinterpret_cast<const VT*>(x)[i];
    const VT yv = reinterpret_cast<const VT*>(y)[i];
    const VT zv = reinterpret_cast<const VT*>(z)[i];
    VT yn;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      yn.v[k] = yv.v[k] + a * xv.v[k];
      acc += (float)yn.v[k] * (float)zv.v[k];
    }
    reinterpret_cast<VT*>(yo)[i] = yn;
  }
  const long long i = nvec * V + t;
  if (i < n) {
    const T yn = y[i] + a * x[i];
    yo[i] = yn;
    acc += (float)yn * (float)z[i];
  }
  finish(acc, partial, counter, out);
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// The launch shared by both kernels: `vec` is 1 or 16 / sizeof(T) (then
// every operand in `ptrs` must be 16-byte aligned), `blocks` at least 1.
template <typename T, typename K1, typename KV, typename... Args>
int launch(K1 scalar_kernel, KV vector_kernel, int vec, int blocks,
           std::initializer_list<const void*> ptrs, int device, void* stream,
           Args... args) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int V = 16 / sizeof(T);
  if (blocks < 1 || (vec != 1 && vec != V)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec == V) {
    for (const void* q : ptrs)
      if (!aligned16(q)) return (int)cudaErrorInvalidValue;
    vector_kernel<<<blocks, kThreads, 0, s>>>(args...);
  } else {
    scalar_kernel<<<blocks, kThreads, 0, s>>>(args...);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int cg_update(const void* alpha_p, int alpha_kind, double alpha_value, const T* x,
              const T* r, const T* p, const T* ap, T* xo, T* ro, float* partial,
              unsigned int* counter, float* out, long long n, int vec, int blocks,
              int device, void* stream) {
  constexpr int V = 16 / sizeof(T);
  return launch<T>(cg_update_kernel<T, 1>, cg_update_kernel<T, V>, vec, blocks,
                   {x, r, p, ap, xo, ro}, device, stream, alpha_p, alpha_kind,
                   (T)alpha_value, x, r, p, ap, xo, ro, partial, counter, out, n);
}

template <typename T>
int axpy_dot(const void* alpha_p, int alpha_kind, double alpha_value, const T* x,
             const T* y, const T* z, T* yo, float* partial, unsigned int* counter,
             float* out, long long n, int vec, int blocks, int device,
             void* stream) {
  constexpr int V = 16 / sizeof(T);
  return launch<T>(axpy_dot_kernel<T, 1>, axpy_dot_kernel<T, V>, vec, blocks,
                   {x, y, z, yo}, device, stream, alpha_p, alpha_kind,
                   (T)alpha_value, x, y, z, yo, partial, counter, out, n);
}

}  // namespace

extern "C" {

int gt_cg_update_f32(const void* alpha_p, int alpha_kind, double alpha_value,
                     const float* x, const float* r, const float* p, const float* ap,
                     float* xo, float* ro, float* partial,
                     unsigned int* counter, float* out, long long n, int vec,
                     int blocks, int device, void* stream) {
  return cg_update<float>(alpha_p, alpha_kind, alpha_value, x, r, p, ap, xo, ro,
                          partial, counter, out, n, vec, blocks, device, stream);
}

int gt_cg_update_f64(const void* alpha_p, int alpha_kind, double alpha_value,
                     const double* x, const double* r, const double* p, const double* ap,
                     double* xo, double* ro, float* partial,
                     unsigned int* counter, float* out, long long n, int vec,
                     int blocks, int device, void* stream) {
  return cg_update<double>(alpha_p, alpha_kind, alpha_value, x, r, p, ap, xo, ro,
                           partial, counter, out, n, vec, blocks, device, stream);
}

int gt_axpy_dot_f32(const void* alpha_p, int alpha_kind, double alpha_value,
                    const float* x, const float* y, const float* z, float* yo,
                    float* partial, unsigned int* counter, float* out,
                    long long n, int vec, int blocks, int device, void* stream) {
  return axpy_dot<float>(alpha_p, alpha_kind, alpha_value, x, y, z, yo, partial,
                         counter, out, n, vec, blocks, device, stream);
}

int gt_axpy_dot_f64(const void* alpha_p, int alpha_kind, double alpha_value,
                    const double* x, const double* y, const double* z,
                    double* yo, float* partial, unsigned int* counter,
                    float* out, long long n, int vec, int blocks, int device,
                    void* stream) {
  return axpy_dot<double>(alpha_p, alpha_kind, alpha_value, x, y, z, yo, partial,
                          counter, out, n, vec, blocks, device, stream);
}

}  // extern "C"
