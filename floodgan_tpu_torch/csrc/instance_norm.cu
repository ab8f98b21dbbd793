// Fused InstanceNorm (+ relu / leaky relu) (+ residual add), forward and
// backward, for Hopper (sm_90a).
//
// Forward (K1) replaces the TPU kernel
// floodgan_tpu/ops/pallas_kernels.py:_in_fwd_kernel (launched by
// _in_pallas_fwd_call).  Same contract: per (n, c) plane of H*W values, f32
// statistics mean = sum(x)/HW and inv = rsqrt(sum(x^2)/HW - mean^2 + eps)
// (the E[x^2] - mean^2 form, not Welford, so the port and the JAX package
// compute the same numbers); then y = (x - mean) * inv, then
// where(y >= 0, y, slope * y) when the activation is on, then + residual,
// all in f32, cast to the element type at the store.
//
// Backward (K2) replaces _in_bwd_kernel (launched by _in_pallas_bwd_call).
// From the saved pre-norm x and the incoming g, per plane: the same
// statistics, yhat = (x - mean) * inv, g~ = g * (yhat >= 0 ? 1 : slope) when
// the activation is on, and dx = inv * (g~ - mean(g~) - yhat * mean(g~ *
// yhat)), in f32, cast at the store.  The residual's gradient is g itself
// and takes no kernel.
//
// Layout: NCHW-contiguous, so each (n, c) plane is one contiguous run.  One
// block per plane.  K1 makes two passes: statistics (16-byte loads, sums
// reduced through warp shuffles and shared memory), then the apply.  K2
// makes three: statistics; sum(g~) and sum(g~ * yhat); dx.  A misaligned
// plane (H*W not a multiple of the vector width) takes scalar loads; the
// tail after the last full vector is scalar too.
//
// Bound: memory.  The least traffic is one read of each input and one
// write of the output; the arithmetic is a few operations per element, far
// below the card's rate.  K1 reads x twice and K2 reads x three times and g
// twice, because a 512^2 f32 plane (1 MB) does not fit in a block's 227 KB
// of shared memory.  Keeping the plane on chip (a cluster of blocks per
// plane, or a split reduction), or saving (mean, inv) from the forward for
// K2, is later work; the measured times stand beside the bounds in PERF.md.
//
// The partial forms serve a plane whose rows are split over the ranks of
// the mesh's spatial axis (parallel/spatial.py).  JAX runs the Pallas
// kernels on a gathered tensor there, since a pallas_call cannot be
// partitioned; the port keeps each rank's rows where they are and sums
// per-plane partial sums over the ranks instead:
//   K1s  (sum x, sum x^2) of this rank's rows of each plane, f32;
//   K1a  K1's apply from the summed sums and the global count n;
//   K2s  (sum g~, sum g~ * yhat) of this rank's rows, yhat from the summed
//        statistics;
//   K2a  K2's dx from the summed statistics and gradient sums.
// The arithmetic is K1's and K2's: the same E[x^2] - mean^2 form, the same
// f32 apply, one cast at the store.  Bounds: K1s reads x once and writes 8
// bytes a plane; K1a reads x (and the residual) and writes y; K2s reads x
// and g; K2a reads x and g and writes dx.  K1s + K1a move one read of x
// more than fused K1's least traffic, and K2s + K2a one read of x and g
// more than K2's: the price of the reduction between them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of elements: one vector load or store.
template <typename T>
struct alignas(16) Pack {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// Sum (a, b) over the block; every thread gets the totals.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float sa[kWarps];
  __shared__ float sb[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? sa[lane] : 0.f;
    b = lane < kWarps ? sb[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      sa[0] = a;
      sb[0] = b;
    }
  }
  __syncthreads();
  const float2 tot = make_float2(sa[0], sb[0]);
  __syncthreads();  // every thread has read the totals before a later call writes sa, sb
  return tot;
}

// (sum x, sum x^2) of one plane of hw elements, over the block; every
// thread gets the totals.
template <typename T>
__device__ __forceinline__ float2 plane_sums(const T* __restrict__ xp, long long nvec,
                                             long long tail, long long hw) {
  constexpr int V = Pack<T>::N;
  float s = 0.f, ss = 0.f;
  for (long long i = threadIdx.x; i < nvec; i += kThreads) {
    const Pack<T> p = reinterpret_cast<const Pack<T>*>(xp)[i];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float v = to_float(p.v[j]);
      s += v;
      ss += v * v;
    }
  }
  for (long long i = tail + threadIdx.x; i < hw; i += kThreads) {
    const float v = to_float(xp[i]);
    s += v;
    ss += v * v;
  }
  return block_sum2(s, ss);
}

// (mean, inv) from a plane's (sum, sum of squares) over n elements.
__device__ __forceinline__ float2 stats_from_sums(float sum, float sumsq, float n, float eps) {
  const float mean = sum / n;
  return make_float2(mean, rsqrtf(sumsq / n - mean * mean + eps));
}

template <typename T>
__device__ __forceinline__ float2 plane_stats(const T* __restrict__ xp, long long nvec,
                                              long long tail, long long hw, float eps) {
  const float2 tot = plane_sums(xp, nvec, tail, hw);
  return stats_from_sums(tot.x, tot.y, static_cast<float>(hw), eps);
}

// y = act((x - mean) * inv) (+ res) over one plane.
template <typename T>
__device__ __forceinline__ void apply_plane(const T* __restrict__ xp, const T* __restrict__ rp,
                                            T* __restrict__ yp, long long nvec, long long tail,
                                            long long hw, float mean, float inv, int relu,
                                            float slope) {
  constexpr int V = Pack<T>::N;
  for (long long i = threadIdx.x; i < nvec; i += kThreads) {
    const Pack<T> p = reinterpret_cast<const Pack<T>*>(xp)[i];
    Pack<T> r;
    if (rp != nullptr) r = reinterpret_cast<const Pack<T>*>(rp)[i];
    Pack<T> q;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = (to_float(p.v[j]) - mean) * inv;
      if (relu) v = v >= 0.f ? v : v * slope;
      if (rp != nullptr) v += to_float(r.v[j]);
      q.v[j] = from_float<T>(v);
    }
    reinterpret_cast<Pack<T>*>(yp)[i] = q;
  }
  for (long long i = tail + threadIdx.x; i < hw; i += kThreads) {
    float v = (to_float(xp[i]) - mean) * inv;
    if (relu) v = v >= 0.f ? v : v * slope;
    if (rp != nullptr) v += to_float(rp[i]);
    yp[i] = from_float<T>(v);
  }
}

// (sum g~, sum g~ * yhat) of one plane, over the block.
template <typename T>
__device__ __forceinline__ float2 bwd_sums(const T* __restrict__ xp, const T* __restrict__ gp,
                                           long long nvec, long long tail, long long hw,
                                           float mean, float inv, int relu, float slope) {
  constexpr int V = Pack<T>::N;
  float sg = 0.f, sgy = 0.f;
  for (long long i = threadIdx.x; i < nvec; i += kThreads) {
    const Pack<T> px = reinterpret_cast<const Pack<T>*>(xp)[i];
    const Pack<T> pg = reinterpret_cast<const Pack<T>*>(gp)[i];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float yh = (to_float(px.v[j]) - mean) * inv;
      float gv = to_float(pg.v[j]);
      if (relu) gv = yh >= 0.f ? gv : gv * slope;
      sg += gv;
      sgy += gv * yh;
    }
  }
  for (long long i = tail + threadIdx.x; i < hw; i += kThreads) {
    const float yh = (to_float(xp[i]) - mean) * inv;
    float gv = to_float(gp[i]);
    if (relu) gv = yh >= 0.f ? gv : gv * slope;
    sg += gv;
    sgy += gv * yh;
  }
  return block_sum2(sg, sgy);
}

// dx = inv * (g~ - mg - yhat * mgy) over one plane.
template <typename T>
__device__ __forceinline__ void bwd_apply(const T* __restrict__ xp, const T* __restrict__ gp,
                                          T* __restrict__ dp, long long nvec, long long tail,
                                          long long hw, float mean, float inv, float mg, float mgy,
                                          int relu, float slope) {
  constexpr int V = Pack<T>::N;
  for (long long i = threadIdx.x; i < nvec; i += kThreads) {
    const Pack<T> px = reinterpret_cast<const Pack<T>*>(xp)[i];
    const Pack<T> pg = reinterpret_cast<const Pack<T>*>(gp)[i];
    Pack<T> q;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float yh = (to_float(px.v[j]) - mean) * inv;
      float gv = to_float(pg.v[j]);
      if (relu) gv = yh >= 0.f ? gv : gv * slope;
      q.v[j] = from_float<T>(inv * (gv - mg - yh * mgy));
    }
    reinterpret_cast<Pack<T>*>(dp)[i] = q;
  }
  for (long long i = tail + threadIdx.x; i < hw; i += kThreads) {
    const float yh = (to_float(xp[i]) - mean) * inv;
    float gv = to_float(gp[i]);
    if (relu) gv = yh >= 0.f ? gv : gv * slope;
    dp[i] = from_float<T>(inv * (gv - mg - yh * mgy));
  }
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15u) == 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
in_act_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
              long long hw, int relu, float slope, float eps) {
  constexpr int V = Pack<T>::N;
  const long long base = static_cast<long long>(blockIdx.x) * hw;
  const T* xp = x + base;
  const T* rp = res != nullptr ? res + base : nullptr;
  T* yp = y + base;
  const long long nvec = aligned16(xp, rp, yp) ? hw / V : 0;
  const long long tail = nvec * V;
  // Pass 1: statistics.  Pass 2: normalize, activate, add the residual, store.
  const float2 st = plane_stats(xp, nvec, tail, hw, eps);
  apply_plane(xp, rp, yp, nvec, tail, hw, st.x, st.y, relu, slope);
}

template <typename T>
int launch_in_act(const void* x, const void* res, void* y, long long planes, long long hw,
                  int relu, float slope, float eps, void* stream) {
  in_act_kernel<T><<<static_cast<unsigned int>(planes), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<T*>(y), hw, relu,
      slope, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
in_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
              long long hw, int relu, float slope, float eps) {
  constexpr int V = Pack<T>::N;
  const long long base = static_cast<long long>(blockIdx.x) * hw;
  const T* xp = x + base;
  const T* gp = g + base;
  T* dp = dx + base;
  const long long nvec = aligned16(xp, gp, dp) ? hw / V : 0;
  const long long tail = nvec * V;
  // Pass 1: statistics of x.  Pass 2: sum(g~) and sum(g~ * yhat).  Pass 3: dx.
  const float2 st = plane_stats(xp, nvec, tail, hw, eps);
  const float2 gs = bwd_sums(xp, gp, nvec, tail, hw, st.x, st.y, relu, slope);
  const float n = static_cast<float>(hw);
  bwd_apply(xp, gp, dp, nvec, tail, hw, st.x, st.y, gs.x / n, gs.y / n, relu, slope);
}

template <typename T>
int launch_in_bwd(const void* x, const void* g, void* dx, long long planes, long long hw,
                  int relu, float slope, float eps, void* stream) {
  in_bwd_kernel<T><<<static_cast<unsigned int>(planes), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx), hw, relu, slope,
      eps);
  return static_cast<int>(cudaGetLastError());
}

// ---- the partial forms, for a plane whose rows are split over ranks ----
//
// stats holds 2 * planes + 1 floats: (sum x, sum x^2) of each plane, then
// the plane's row count.  K1s writes this rank's; the caller sums them over
// the ranks; K1a, K2s and K2a read the sums, with n = rows * row_elems.

// K1s: one block per plane; block 0 also writes the row count.
template <typename T>
__global__ void __launch_bounds__(kThreads)
in_stats_kernel(const T* __restrict__ x, float* __restrict__ stats, long long hw,
                long long planes, float rows) {
  constexpr int V = Pack<T>::N;
  const T* xp = x + static_cast<long long>(blockIdx.x) * hw;
  const long long nvec = aligned16(xp, xp, xp) ? hw / V : 0;
  const float2 tot = plane_sums(xp, nvec, nvec * V, hw);
  if (threadIdx.x == 0) {
    stats[2 * blockIdx.x] = tot.x;
    stats[2 * blockIdx.x + 1] = tot.y;
    if (blockIdx.x == 0) stats[2 * planes] = rows;
  }
}

// K1a: K1's pass 2 with the summed statistics.
template <typename T>
__global__ void __launch_bounds__(kThreads)
in_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ stats, T* __restrict__ y, long long hw,
                long long planes, float row_elems, int relu, float slope, float eps) {
  constexpr int V = Pack<T>::N;
  const long long base = static_cast<long long>(blockIdx.x) * hw;
  const T* xp = x + base;
  const T* rp = res != nullptr ? res + base : nullptr;
  T* yp = y + base;
  const long long nvec = aligned16(xp, rp, yp) ? hw / V : 0;
  const float2 st = stats_from_sums(stats[2 * blockIdx.x], stats[2 * blockIdx.x + 1],
                                    stats[2 * planes] * row_elems, eps);
  apply_plane(xp, rp, yp, nvec, nvec * V, hw, st.x, st.y, relu, slope);
}

// K2s: (sum g~, sum g~ * yhat) of this rank's rows, yhat from the summed statistics.
template <typename T>
__global__ void __launch_bounds__(kThreads)
in_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ stats, float* __restrict__ gsums, long long hw,
                    long long planes, float row_elems, int relu, float slope, float eps) {
  constexpr int V = Pack<T>::N;
  const long long base = static_cast<long long>(blockIdx.x) * hw;
  const T* xp = x + base;
  const T* gp = g + base;
  const long long nvec = aligned16(xp, gp, gp) ? hw / V : 0;
  const float2 st = stats_from_sums(stats[2 * blockIdx.x], stats[2 * blockIdx.x + 1],
                                    stats[2 * planes] * row_elems, eps);
  const float2 gs = bwd_sums(xp, gp, nvec, nvec * V, hw, st.x, st.y, relu, slope);
  if (threadIdx.x == 0) {
    gsums[2 * blockIdx.x] = gs.x;
    gsums[2 * blockIdx.x + 1] = gs.y;
  }
}

// K2a: K2's pass 3 with the summed statistics and gradient sums.
template <typename T>
__global__ void __launch_bounds__(kThreads)
in_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ stats, const float* __restrict__ gsums,
                    T* __restrict__ dx, long long hw, long long planes, float row_elems,
                    int relu, float slope, float eps) {
  constexpr int V = Pack<T>::N;
  const long long base = static_cast<long long>(blockIdx.x) * hw;
  const T* xp = x + base;
  const T* gp = g + base;
  T* dp = dx + base;
  const long long nvec = aligned16(xp, gp, dp) ? hw / V : 0;
  const float n = stats[2 * planes] * row_elems;
  const float2 st = stats_from_sums(stats[2 * blockIdx.x], stats[2 * blockIdx.x + 1], n, eps);
  bwd_apply(xp, gp, dp, nvec, nvec * V, hw, st.x, st.y, gsums[2 * blockIdx.x] / n,
            gsums[2 * blockIdx.x + 1] / n, relu, slope);
}

template <typename T>
int launch_in_stats(const void* x, void* stats, long long planes, long long hw, float rows,
                    void* stream) {
  in_stats_kernel<T><<<static_cast<unsigned int>(planes), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<float*>(stats), hw, planes, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_in_apply(const void* x, const void* res, const void* stats, void* y, long long planes,
                    long long hw, float row_elems, int relu, float slope, float eps,
                    void* stream) {
  in_apply_kernel<T><<<static_cast<unsigned int>(planes), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(stats),
      static_cast<T*>(y), hw, planes, row_elems, relu, slope, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_in_bwd_stats(const void* x, const void* g, const void* stats, void* gsums,
                        long long planes, long long hw, float row_elems, int relu, float slope,
                        float eps, void* stream) {
  in_bwd_stats_kernel<T><<<static_cast<unsigned int>(planes), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(stats),
      static_cast<float*>(gsums), hw, planes, row_elems, relu, slope, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_in_bwd_apply(const void* x, const void* g, const void* stats, const void* gsums,
                        void* dx, long long planes, long long hw, float row_elems, int relu,
                        float slope, float eps, void* stream) {
  in_bwd_apply_kernel<T><<<static_cast<unsigned int>(planes), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(stats),
      static_cast<const float*>(gsums), static_cast<T*>(dx), hw, planes, row_elems, relu, slope,
      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, res (may be null), y: planes * hw contiguous elements.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int floodgan_in_act_f32(const void* x, const void* res, void* y, long long planes,
                                   long long hw, int relu, float slope, float eps,
                                   void* stream) {
  return launch_in_act<float>(x, res, y, planes, hw, relu, slope, eps, stream);
}

extern "C" int floodgan_in_act_bf16(const void* x, const void* res, void* y, long long planes,
                                    long long hw, int relu, float slope, float eps,
                                    void* stream) {
  return launch_in_act<__nv_bfloat16>(x, res, y, planes, hw, relu, slope, eps, stream);
}

// x (the forward's input), g (the gradient of its output), dx: planes * hw
// contiguous elements.  Returns the cudaError_t of the launch.
extern "C" int floodgan_in_bwd_f32(const void* x, const void* g, void* dx, long long planes,
                                   long long hw, int relu, float slope, float eps,
                                   void* stream) {
  return launch_in_bwd<float>(x, g, dx, planes, hw, relu, slope, eps, stream);
}

extern "C" int floodgan_in_bwd_bf16(const void* x, const void* g, void* dx, long long planes,
                                    long long hw, int relu, float slope, float eps,
                                    void* stream) {
  return launch_in_bwd<__nv_bfloat16>(x, g, dx, planes, hw, relu, slope, eps, stream);
}

// The partial forms.  stats: 2 * planes + 1 floats (module note above);
// gsums: 2 * planes floats.  rows: this rank's rows of each plane;
// row_elems: the elements of one row (W).  Each returns the cudaError_t of
// its launch.
extern "C" int floodgan_in_stats_f32(const void* x, void* stats, long long planes, long long hw,
                                     float rows, void* stream) {
  return launch_in_stats<float>(x, stats, planes, hw, rows, stream);
}

extern "C" int floodgan_in_stats_bf16(const void* x, void* stats, long long planes, long long hw,
                                      float rows, void* stream) {
  return launch_in_stats<__nv_bfloat16>(x, stats, planes, hw, rows, stream);
}

extern "C" int floodgan_in_apply_f32(const void* x, const void* res, const void* stats, void* y,
                                     long long planes, long long hw, float row_elems, int relu,
                                     float slope, float eps, void* stream) {
  return launch_in_apply<float>(x, res, stats, y, planes, hw, row_elems, relu, slope, eps, stream);
}

extern "C" int floodgan_in_apply_bf16(const void* x, const void* res, const void* stats, void* y,
                                      long long planes, long long hw, float row_elems, int relu,
                                      float slope, float eps, void* stream) {
  return launch_in_apply<__nv_bfloat16>(x, res, stats, y, planes, hw, row_elems, relu, slope, eps,
                                        stream);
}

extern "C" int floodgan_in_bwd_stats_f32(const void* x, const void* g, const void* stats,
                                         void* gsums, long long planes, long long hw,
                                         float row_elems, int relu, float slope, float eps,
                                         void* stream) {
  return launch_in_bwd_stats<float>(x, g, stats, gsums, planes, hw, row_elems, relu, slope, eps,
                                    stream);
}

extern "C" int floodgan_in_bwd_stats_bf16(const void* x, const void* g, const void* stats,
                                          void* gsums, long long planes, long long hw,
                                          float row_elems, int relu, float slope, float eps,
                                          void* stream) {
  return launch_in_bwd_stats<__nv_bfloat16>(x, g, stats, gsums, planes, hw, row_elems, relu,
                                            slope, eps, stream);
}

extern "C" int floodgan_in_bwd_apply_f32(const void* x, const void* g, const void* stats,
                                         const void* gsums, void* dx, long long planes,
                                         long long hw, float row_elems, int relu, float slope,
                                         float eps, void* stream) {
  return launch_in_bwd_apply<float>(x, g, stats, gsums, dx, planes, hw, row_elems, relu, slope,
                                    eps, stream);
}

extern "C" int floodgan_in_bwd_apply_bf16(const void* x, const void* g, const void* stats,
                                          const void* gsums, void* dx, long long planes,
                                          long long hw, float row_elems, int relu, float slope,
                                          float eps, void* stream) {
  return launch_in_bwd_apply<__nv_bfloat16>(x, g, stats, gsums, dx, planes, hw, row_elems, relu,
                                            slope, eps, stream);
}
