// Where K7's time goes on an H100 at the strong-scaling shard (304² float64,
// the fused CG update: four vectors read, two written, Σ f32(r')²): the pass
// alone (each block's partial written, no cross-block sum), the pass with
// K7's one-launch ticket sum (csrc/cg_fused.cu) and two variants of its
// ordering, and the pass followed by a second one-block launch that sums the
// partials (K7's design before). An empty kernel gives the launch floor.
// Each time is the slope between CUDA graphs of 20 and 40 launches (or
// launch pairs), replayed 50 times: device µs a call adds to a chain. The
// ticket's grid is also varied. Every variant's sum is printed, so the
// ticket variants can be checked bitwise against the two-launch sum on the
// same grid.
//
// Build and run on the machine with the card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -fmad=false \
//        -o k7_tail_bench scripts/k7_tail_bench.cu
//   ./k7_tail_bench

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdio>
#include <vector>

namespace {

constexpr int kThreads = 256;
constexpr long long kN = 304LL * 304;

enum Tail { kPassOnly, kTicket, kTicketNoAcquire, kTicketAcqRel, kTwoLaunch };

__device__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <int TAIL>
__global__ void __launch_bounds__(kThreads)
pass_kernel(const double2* __restrict__ x, const double2* __restrict__ r,
            const double2* __restrict__ p, const double2* __restrict__ ap, double a,
            double2* __restrict__ xo, double2* __restrict__ ro, float* __restrict__ partial,
            unsigned int* __restrict__ counter, float* __restrict__ out, long long nvec) {
  float acc = 0.0f;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nvec;
       i += (long long)gridDim.x * kThreads) {
    const double2 xv = x[i], rv = r[i], pv = p[i], av = ap[i];
    const double2 xn = {xv.x + a * pv.x, xv.y + a * pv.y};
    const double2 rn = {rv.x - a * av.x, rv.y - a * av.y};
    const float f0 = (float)rn.x, f1 = (float)rn.y;
    acc += f0 * f0;
    acc += f1 * f1;
    xo[i] = xn;
    ro[i] = rn;
  }
  const float s = block_sum(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s;
    if (TAIL == kTicket || TAIL == kTicketNoAcquire) {
      __threadfence();
      last = atomicAdd(counter, 1u) == gridDim.x - 1;
    } else if (TAIL == kTicketAcqRel) {
      cuda::atomic_ref<unsigned int, cuda::thread_scope_device> c(*counter);
      last = c.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
    }
  }
  if (TAIL == kPassOnly || TAIL == kTwoLaunch) return;
  __syncthreads();
  if (!last) return;
  if (TAIL == kTicket) __threadfence();
  float v = 0.0f;
  for (unsigned int i = threadIdx.x; i < gridDim.x; i += kThreads) v += __ldcg(partial + i);
  v = block_sum(v);
  if (threadIdx.x == 0) {
    *out = v;
    *counter = 0u;
  }
}

__global__ void sum_kernel(const float* __restrict__ partial, int count,
                           float* __restrict__ out) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < count; i += kThreads) v += partial[i];
  v = block_sum(v);
  if (threadIdx.x == 0) *out = v;
}

__global__ void empty_kernel() {}

struct Bufs {
  double2 *x, *r, *p, *ap, *xo, *ro;
  float *partial, *out;
  unsigned int* counter;
};

void launch(int tail, int blocks, const Bufs& b, cudaStream_t s) {
  const long long nvec = kN / 2;
  switch (tail) {
    case kPassOnly:
      pass_kernel<kPassOnly><<<blocks, kThreads, 0, s>>>(b.x, b.r, b.p, b.ap, 0.37, b.xo, b.ro,
                                                        b.partial, b.counter, b.out, nvec);
      break;
    case kTicket:
      pass_kernel<kTicket><<<blocks, kThreads, 0, s>>>(b.x, b.r, b.p, b.ap, 0.37, b.xo, b.ro,
                                                      b.partial, b.counter, b.out, nvec);
      break;
    case kTicketNoAcquire:
      pass_kernel<kTicketNoAcquire><<<blocks, kThreads, 0, s>>>(
          b.x, b.r, b.p, b.ap, 0.37, b.xo, b.ro, b.partial, b.counter, b.out, nvec);
      break;
    case kTicketAcqRel:
      pass_kernel<kTicketAcqRel><<<blocks, kThreads, 0, s>>>(
          b.x, b.r, b.p, b.ap, 0.37, b.xo, b.ro, b.partial, b.counter, b.out, nvec);
      break;
    case kTwoLaunch:
      pass_kernel<kTwoLaunch><<<blocks, kThreads, 0, s>>>(b.x, b.r, b.p, b.ap, 0.37, b.xo, b.ro,
                                                         b.partial, b.counter, b.out, nvec);
      sum_kernel<<<1, kThreads, 0, s>>>(b.partial, blocks, b.out);
      break;
    default:
      empty_kernel<<<1, 32, 0, s>>>();
  }
}

// Device µs a call adds to a chain: graphs of 20 and 40 calls, 50 replays.
float slope_us(int tail, int blocks, const Bufs& b, cudaStream_t s) {
  float ms[2];
  const int counts[2] = {20, 40};
  for (int k = 0; k < 2; ++k) {
    cudaGraph_t graph;
    cudaGraphExec_t exec;
    cudaStreamBeginCapture(s, cudaStreamCaptureModeGlobal);
    for (int c = 0; c < counts[k]; ++c) launch(tail, blocks, b, s);
    cudaStreamEndCapture(s, &graph);
    cudaGraphInstantiate(&exec, graph, 0);
    cudaGraphLaunch(exec, s);
    cudaStreamSynchronize(s);
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    cudaEventRecord(e0, s);
    for (int rep = 0; rep < 50; ++rep) cudaGraphLaunch(exec, s);
    cudaEventRecord(e1, s);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms[k], e0, e1);
    ms[k] /= 50;
    cudaGraphExecDestroy(exec);
    cudaGraphDestroy(graph);
    cudaEventDestroy(e0);
    cudaEventDestroy(e1);
  }
  return (ms[1] - ms[0]) / (counts[1] - counts[0]) * 1e3f;
}

}  // namespace

int main() {
  Bufs b;
  double2** vecs[] = {&b.x, &b.r, &b.p, &b.ap, &b.xo, &b.ro};
  std::vector<double> host(kN);
  for (long long i = 0; i < kN; ++i) host[i] = ((i * 7919) % 2003) / 1001.0 - 1.0;
  for (double2** v : vecs) {
    if (cudaMalloc(v, kN * sizeof(double)) != cudaSuccess) return 1;
    cudaMemcpy(*v, host.data(), kN * sizeof(double), cudaMemcpyHostToDevice);
  }
  cudaMalloc(&b.partial, 1024 * sizeof(float));
  cudaMalloc(&b.out, sizeof(float));
  cudaMalloc(&b.counter, sizeof(unsigned int));
  cudaMemset(b.counter, 0, sizeof(unsigned int));
  cudaStream_t s;
  cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  const char* names[] = {"pass only (partials, no sum)", "ticket (K7)",
                         "ticket, no acquire fence", "ticket, acq_rel atomic",
                         "two launches (pass, then sum)", "empty kernel (floor)"};
  printf("304x304 float64, the fused CG update; us a call (chained slope), sum\n");
  for (int round = 0; round < 2; ++round) {
    for (int tail = 0; tail <= 5; ++tail) {
      const float us = slope_us(tail, 181, b, s);
      float sum = 0.0f;
      cudaMemcpy(&sum, b.out, sizeof(float), cudaMemcpyDeviceToHost);
      printf("  round %d  %-32s 181 blocks  %.3f us  sum %.9g\n", round, names[tail], us,
             tail == kPassOnly || tail == 5 ? 0.0f : sum);
    }
    for (int blocks : {91, 132, 264, 528}) {
      const float us = slope_us(kTicket, blocks, b, s);
      printf("  round %d  %-32s %3d blocks  %.3f us\n", round, names[kTicket], blocks, us);
    }
  }
  const cudaError_t err = cudaDeviceSynchronize();
  printf("status: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
