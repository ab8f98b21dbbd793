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

template <typename T>
__device__ __forceinline__ float2 plane_stats(const T* __restrict__ xp, long long nvec,
                                              long long tail, long long hw, float eps) {
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
  const float2 tot = block_sum2(s, ss);
  const float n = static_cast<float>(hw);
  const float mean = tot.x / n;
  return make_float2(mean, rsqrtf(tot.y / n - mean * mean + eps));
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
  const bool aligned = ((reinterpret_cast<uintptr_t>(xp) | reinterpret_cast<uintptr_t>(rp) |
                         reinterpret_cast<uintptr_t>(yp)) & 15u) == 0;
  const long long nvec = aligned ? hw / V : 0;
  const long long tail = nvec * V;

  // Pass 1: statistics.
  const float2 st = plane_stats(xp, nvec, tail, hw, eps);
  const float mean = st.x, inv = st.y;

  // Pass 2: normalize, activate, add the residual, store.
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
  const bool aligned = ((reinterpret_cast<uintptr_t>(xp) | reinterpret_cast<uintptr_t>(gp) |
                         reinterpret_cast<uintptr_t>(dp)) & 15u) == 0;
  const long long nvec = aligned ? hw / V : 0;
  const long long tail = nvec * V;

  // Pass 1: statistics of x.
  const float2 st = plane_stats(xp, nvec, tail, hw, eps);
  const float mean = st.x, inv = st.y;

  // Pass 2: sum(g~) and sum(g~ * yhat).
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
  const float2 gs = block_sum2(sg, sgy);
  const float n = static_cast<float>(hw);
  const float mg = gs.x / n, mgy = gs.y / n;

  // Pass 3: dx.
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

template <typename T>
int launch_in_bwd(const void* x, const void* g, void* dx, long long planes, long long hw,
                  int relu, float slope, float eps, void* stream) {
  in_bwd_kernel<T><<<static_cast<unsigned int>(planes), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx), hw, relu, slope,
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
