// Attention-compose forward: the AttentionGAN output head, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel floodgan_tpu/ops/pallas_kernels.py:_compose_kernel
// (launched by _compose_fwd_call).  Per pixel, in f32: a = softmax of the 10
// mask logits (max-subtracted); out_c = rgb_c * a_9 + sum_{k<9}
// content[3k + c] * a_k, summed in that order; mask = a_9.
//
// Layout: NCHW planes.  content (N, 27, H, W) and logits (N, 10, H, W) are
// contiguous; rgb is the first three channels of the generator input, read
// through its batch stride so that the slice x[:, :3] needs no copy (its
// channel stride is H*W).  out (N, 3, H, W) and mask (N, H, W) are
// contiguous.  One thread per pixel: each of the 44 plane accesses of a warp
// is one coalesced 128-byte transaction.
//
// Bound: memory.  40 planes read and 4 written per image, each once; about
// a hundred f32 operations per pixel (ten exponentials, the sums, 30 fused
// multiply-adds) is far below the card's rate.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
compose_kernel(const float* __restrict__ content, const float* __restrict__ logits,
               const float* __restrict__ rgb, float* __restrict__ out,
               float* __restrict__ mask, long long hw, long long rgb_batch_stride) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= hw) return;
  const long long n = blockIdx.y;
  const float* c = content + n * 27 * hw + p;
  const float* l = logits + n * 10 * hw + p;
  const float* r = rgb + n * rgb_batch_stride + p;

  float a[10];
  float m = l[0];
  a[0] = m;
#pragma unroll
  for (int k = 1; k < 10; ++k) {
    a[k] = l[k * hw];
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

  float* o = out + n * 3 * hw + p;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = r[ch * hw] * a[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) acc += c[(3 * k + ch) * hw] * a[k];
    o[ch * hw] = acc;
  }
  mask[n * hw + p] = a[9];
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int floodgan_attention_compose_f32(const void* content, const void* logits,
                                              const void* rgb, void* out, void* mask,
                                              long long batch, long long hw,
                                              long long rgb_batch_stride, void* stream) {
  const dim3 grid(static_cast<unsigned int>((hw + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(batch));
  compose_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(content), static_cast<const float*>(logits),
      static_cast<const float*>(rgb), static_cast<float*>(out), static_cast<float*>(mask), hw,
      rgb_batch_stride);
  return static_cast<int>(cudaGetLastError());
}
