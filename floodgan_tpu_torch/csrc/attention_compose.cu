// Attention compose, forward and backward: the AttentionGAN output head,
// for Hopper (sm_90a).
//
// Forward (K3) replaces the TPU kernel
// floodgan_tpu/ops/pallas_kernels.py:_compose_kernel (launched by
// _compose_fwd_call).  Per pixel, in f32: a = softmax of the 10 mask logits
// (max-subtracted); out_c = rgb_c * a_9 + sum_{k<9} content[3k + c] * a_k,
// summed in that order; mask = a_9.  Both are cast to the element type at
// the store.
//
// Backward (K4) replaces _compose_bwd_kernel (launched by
// _compose_bwd_call).  Per pixel, in f32, from the forward's inputs and the
// gradients gout (3 planes) and gmask (1 plane, or none: zero): the softmax
// is recomputed, then
//   dcontent[3k + c] = gout_c * a_k
//   da_k = sum_c gout_c * content[3k + c]          (k < 9)
//   da_9 = gmask + sum_c gout_c * rgb_c
//   dlogits = a * (da - sum_j a_j * da_j)
//   drgb_c = gout_c * a_9                           (skipped when drgb is null)
// each cast to the element type at the store.
//
// Layout: NCHW planes.  content (N, 27, H, W) and logits (N, 10, H, W) are
// contiguous; rgb is the first three channels of the generator input, read
// through its batch stride so that the slice x[:, :3] needs no copy (its
// channel stride is H*W).  Every other operand is contiguous.  One thread
// per pixel: each plane access of a warp is one coalesced transaction.
//
// Bound: memory.  The forward reads 40 planes and writes 4; the backward
// reads 43 or 44 and writes 37 or 40, each once.  About a hundred f32
// operations per pixel (ten exponentials, the sums, the multiply-adds) is
// far below the card's rate.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// a = softmax(l[0], l[hw], ..., l[9 hw]), in f32.
template <typename T>
__device__ __forceinline__ void softmax10(const T* l, long long hw, float a[10]) {
  float m = to_float(l[0]);
  a[0] = m;
#pragma unroll
  for (int k = 1; k < 10; ++k) {
    a[k] = to_float(l[k * hw]);
    m = fmaxf(m, a[k]);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    a[k] = expf(a[k] - m);
    s += a[k];
  }
#pragma unroll
  for (int k = 0; k < 10; ++k) a[k] = a[k] / s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
compose_kernel(const T* __restrict__ content, const T* __restrict__ logits,
               const T* __restrict__ rgb, T* __restrict__ out, T* __restrict__ mask,
               long long hw, long long rgb_batch_stride) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= hw) return;
  const long long n = blockIdx.y;
  const T* c = content + n * 27 * hw + p;
  const T* r = rgb + n * rgb_batch_stride + p;

  float a[10];
  softmax10(logits + n * 10 * hw + p, hw, a);

  T* o = out + n * 3 * hw + p;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = to_float(r[ch * hw]) * a[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) acc += to_float(c[(3 * k + ch) * hw]) * a[k];
    o[ch * hw] = from_float<T>(acc);
  }
  mask[n * hw + p] = from_float<T>(a[9]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
compose_bwd_kernel(const T* __restrict__ content, const T* __restrict__ logits,
                   const T* __restrict__ rgb, const T* __restrict__ gout,
                   const T* __restrict__ gmask, T* __restrict__ dcontent,
                   T* __restrict__ dlogits, T* __restrict__ drgb, long long hw,
                   long long rgb_batch_stride) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= hw) return;
  const long long n = blockIdx.y;
  const T* c = content + n * 27 * hw + p;
  const T* r = rgb + n * rgb_batch_stride + p;
  const T* go = gout + n * 3 * hw + p;
  T* dc = dcontent + n * 27 * hw + p;

  float a[10];
  softmax10(logits + n * 10 * hw + p, hw, a);
  float g[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) g[ch] = to_float(go[ch * hw]);

  float da[10];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      dc[(3 * k + ch) * hw] = from_float<T>(g[ch] * a[k]);
      acc += g[ch] * to_float(c[(3 * k + ch) * hw]);
    }
    da[k] = acc;
  }
  float acc9 = gmask != nullptr ? to_float(gmask[n * hw + p]) : 0.f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) acc9 += g[ch] * to_float(r[ch * hw]);
  da[9] = acc9;

  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 10; ++k) s += a[k] * da[k];
  T* dl = dlogits + n * 10 * hw + p;
#pragma unroll
  for (int k = 0; k < 10; ++k) dl[k * hw] = from_float<T>(a[k] * (da[k] - s));

  if (drgb != nullptr) {
    T* dr = drgb + n * 3 * hw + p;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) dr[ch * hw] = from_float<T>(g[ch] * a[9]);
  }
}

dim3 pixel_grid(long long batch, long long hw) {
  return dim3(static_cast<unsigned int>((hw + kThreads - 1) / kThreads),
              static_cast<unsigned int>(batch));
}

template <typename T>
int launch_compose(const void* content, const void* logits, const void* rgb, void* out,
                   void* mask, long long batch, long long hw, long long rgb_batch_stride,
                   void* stream) {
  compose_kernel<T><<<pixel_grid(batch, hw), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(content), static_cast<const T*>(logits),
      static_cast<const T*>(rgb), static_cast<T*>(out), static_cast<T*>(mask), hw,
      rgb_batch_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_compose_bwd(const void* content, const void* logits, const void* rgb,
                       const void* gout, const void* gmask, void* dcontent, void* dlogits,
                       void* drgb, long long batch, long long hw, long long rgb_batch_stride,
                       void* stream) {
  compose_bwd_kernel<T>
      <<<pixel_grid(batch, hw), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(content), static_cast<const T*>(logits),
          static_cast<const T*>(rgb), static_cast<const T*>(gout),
          static_cast<const T*>(gmask), static_cast<T*>(dcontent), static_cast<T*>(dlogits),
          static_cast<T*>(drgb), hw, rgb_batch_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int floodgan_attention_compose_f32(const void* content, const void* logits,
                                              const void* rgb, void* out, void* mask,
                                              long long batch, long long hw,
                                              long long rgb_batch_stride, void* stream) {
  return launch_compose<float>(content, logits, rgb, out, mask, batch, hw, rgb_batch_stride,
                               stream);
}

extern "C" int floodgan_attention_compose_bf16(const void* content, const void* logits,
                                               const void* rgb, void* out, void* mask,
                                               long long batch, long long hw,
                                               long long rgb_batch_stride, void* stream) {
  return launch_compose<__nv_bfloat16>(content, logits, rgb, out, mask, batch, hw,
                                       rgb_batch_stride, stream);
}

// gmask and drgb may be null (no gradient for the mask; rgb needs none).
extern "C" int floodgan_attention_compose_bwd_f32(const void* content, const void* logits,
                                                  const void* rgb, const void* gout,
                                                  const void* gmask, void* dcontent,
                                                  void* dlogits, void* drgb, long long batch,
                                                  long long hw, long long rgb_batch_stride,
                                                  void* stream) {
  return launch_compose_bwd<float>(content, logits, rgb, gout, gmask, dcontent, dlogits, drgb,
                                   batch, hw, rgb_batch_stride, stream);
}

extern "C" int floodgan_attention_compose_bwd_bf16(const void* content, const void* logits,
                                                   const void* rgb, const void* gout,
                                                   const void* gmask, void* dcontent,
                                                   void* dlogits, void* drgb, long long batch,
                                                   long long hw, long long rgb_batch_stride,
                                                   void* stream) {
  return launch_compose_bwd<__nv_bfloat16>(content, logits, rgb, gout, gmask, dcontent,
                                           dlogits, drgb, batch, hw, rgb_batch_stride, stream);
}
