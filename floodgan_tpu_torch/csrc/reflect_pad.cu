// The backward of reflect padding on (H, W) (K6), for Hopper (sm_90a).
//
// It has no Pallas counterpart: in the JAX package the reflect pad's
// adjoint is plain XLA, written by hand in
// floodgan_tpu/ops/fused_grads.py:_rp_axis_adjoint and _rp_bwd as interior
// slices plus flipped border blocks added in a fixed order.  PyTorch's own
// backward of F.pad(mode="reflect") on the card scatters with atomics, so
// its sums land in a different order from run to run (and
// torch.use_deterministic_algorithms refuses it).  This kernel is the
// port's deterministic form of JAX's adjoint.
//
// Contract.  g is the gradient of a padded NCHW tensor, (planes, H + top +
// bottom, W + left + right), each pad smaller than the dimension it pads;
// dx is (planes, H, W).  The padded row q reads source row top - q above
// the image (q < top), q - top inside and 2H - 2 + top - q below; so the
// source row h receives the rows h + top, then top - h (1 <= h <= top), then
// 2H - 2 + top - h (H - 1 - bottom <= h <= H - 2).  The H axis is folded
// first, each partial sum rounded to the element type as JAX's .at[].add
// rounds it, then the W axis the same way on the folded rows.  Sums are
// taken in float and rounded to the element type after each add, so the
// result equals the plain version (slice, flip and add in that order) bit
// for bit in f32 and bf16.
//
// Design.  Each dx element gathers its (up to 9) contributions from g and
// is written once: no atomics, no memset, no second pass.  A thread takes
// runs of kVec consecutive elements of one row (kPer runs, kThreads runs
// apart, so a warp covers consecutive stretches of dx); a block covers
// kThreads * kPer runs of one plane (the plane is blockIdx.y, looped past
// the grid's 65535); a run's row comes from a multiply-high division by
// the runs a row holds.  Inside the image dx is the interior of g, a
// cropped copy: a thread loads the kVec values of each of its runs, all
// issued before any is used, folds again the few elements that lie in a
// border row or column (at most 9 reads each), and stores each run as
// 16-byte vectors where the rows allow (W a multiple of kVec).
//
// Bound: memory.  The least traffic is one read of g and one write of dx;
// a few integer operations and at most 8 adds an element are far below the
// card's rates.  The loads of g stay scalar (2 or 4 bytes): a padded row
// (W + left + right) is seldom 16-byte aligned, and the eight loads of a
// run share one address computation and L1 lines.  Runs of kVec elements,
// not one element a thread, keep the index arithmetic and border tests
// off the per-element path.  Measured times and bounds: PERF.md, section 6.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements a run
constexpr int kPer = 2;  // runs a thread
constexpr unsigned kGridY = 65535;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// a + b rounded to T, back in float.
template <typename T>
__device__ __forceinline__ float add_rounded(float a, float b) {
  return to_float(from_float<T>(a + b));
}

// n / d for n, d < 2^31 by a multiply-high and a shift (the divisor's
// magic number is made on the host).
struct Divider {
  unsigned d, magic, shift;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

Divider make_divider(unsigned d) {
  unsigned shift = 0;
  while ((1u << shift) < d) ++shift;
  const uint64_t one = 1;
  const uint64_t magic = ((one << 32) * ((one << shift) - d)) / d + 1;
  return Divider{d, static_cast<unsigned>(magic), shift};
}

struct Geometry {
  int h, w, left, right, top, bottom, wp;
};

// The H-axis adjoint at source row h of the padded column c: the rows of
// g that reflect onto h, added in JAX's order.
template <typename T>
__device__ __forceinline__ float fold_rows(const T* __restrict__ gp, const Geometry& s, int h,
                                           int c) {
  const T* col = gp + c;
  float t = to_float(col[static_cast<long long>(h + s.top) * s.wp]);
  if (h >= 1 && h <= s.top) {
    t = add_rounded<T>(t, to_float(col[static_cast<long long>(s.top - h) * s.wp]));
  }
  if (h >= s.h - 1 - s.bottom && h <= s.h - 2) {
    t = add_rounded<T>(t, to_float(col[static_cast<long long>(2 * s.h - 2 + s.top - h) * s.wp]));
  }
  return t;
}

// dx at (h, w): the W-axis adjoint of the H-folded rows.
template <typename T>
__device__ __forceinline__ T fold(const T* __restrict__ gp, const Geometry& s, int h, int w) {
  float d = fold_rows(gp, s, h, w + s.left);
  if (w >= 1 && w <= s.left) d = add_rounded<T>(d, fold_rows(gp, s, h, s.left - w));
  if (w >= s.w - 1 - s.right && w <= s.w - 2) {
    d = add_rounded<T>(d, fold_rows(gp, s, h, 2 * s.w - 2 + s.left - w));
  }
  return from_float<T>(d);
}

// Whether a reflected row or column adds into (h, w): else dx there is the
// interior value of g alone.
__device__ __forceinline__ bool on_border(const Geometry& s, int h, int w) {
  return (h >= 1 && h <= s.top) || (h >= s.h - 1 - s.bottom && h <= s.h - 2) ||
         (w >= 1 && w <= s.left) || (w >= s.w - 1 - s.right && w <= s.w - 2);
}

// Whether any element of the run at (h, w0..w0 + kVec - 1) is on a border.
__device__ __forceinline__ bool run_on_border(const Geometry& s, int h, int w0) {
  return (h >= 1 && h <= s.top) || (h >= s.h - 1 - s.bottom && h <= s.h - 2) ||
         (w0 <= s.left) || (w0 + kVec - 1 >= s.w - 1 - s.right);
}

template <typename T>
struct alignas(16) Run {
  T v[kVec];
};

// vec_store: W is a multiple of kVec and dx 16-byte aligned, so every run
// of a row is a whole, aligned Run.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reflect_pad_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx, long long planes,
                       Geometry s, Divider by_runs, int vec_store) {
  const unsigned hw = static_cast<unsigned>(s.h) * static_cast<unsigned>(s.w);
  const unsigned runs = static_cast<unsigned>(s.h) * by_runs.d;
  const long long hwp = static_cast<long long>(s.h + s.top + s.bottom) * s.wp;
  const unsigned first = blockIdx.x * (kThreads * kPer) + threadIdx.x;
  for (long long plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const T* gp = g + plane * hwp;
    T* dp = dx + plane * hw;
    Run<T> run[kPer];
    int hs[kPer], w0s[kPer];
    // Every run's interior values first: kPer * kVec independent loads.
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const unsigned r = first + e * kThreads;
      if (r < runs) {
        const unsigned h = by_runs.div(r);
        hs[e] = static_cast<int>(h);
        w0s[e] = static_cast<int>(r - h * by_runs.d) * kVec;
        const T* src = gp + static_cast<long long>(hs[e] + s.top) * s.wp + w0s[e] + s.left;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (w0s[e] + j < s.w) run[e].v[j] = src[j];
        }
      }
    }
    // Then the elements that reflected rows or columns reach.
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const unsigned r = first + e * kThreads;
      if (r < runs && run_on_border(s, hs[e], w0s[e])) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int w = w0s[e] + j;
          if (w < s.w && on_border(s, hs[e], w)) run[e].v[j] = fold(gp, s, hs[e], w);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const unsigned r = first + e * kThreads;
      if (r < runs) {
        T* dst = dp + static_cast<long long>(hs[e]) * s.w + w0s[e];
        if (vec_store) {
          *reinterpret_cast<Run<T>*>(dst) = run[e];
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            if (w0s[e] + j < s.w) dst[j] = run[e].v[j];
          }
        }
      }
    }
  }
}

template <typename T>
int launch_reflect_pad_bwd(const void* g, void* dx, long long planes, int h, int w, int left,
                           int right, int top, int bottom, void* stream) {
  const Geometry s{h, w, left, right, top, bottom, w + left + right};
  const long long runs_per_row = (w + kVec - 1) / kVec;
  const long long runs = static_cast<long long>(h) * runs_per_row;
  const int vec_store = w % kVec == 0 && (reinterpret_cast<uintptr_t>(dx) & 15u) == 0;
  const dim3 grid(static_cast<unsigned>((runs + kThreads * kPer - 1) / (kThreads * kPer)),
                  static_cast<unsigned>(planes < kGridY ? planes : kGridY));
  reflect_pad_bwd_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<T*>(dx), planes, s,
      make_divider(static_cast<unsigned>(runs_per_row)), vec_store);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: planes * (h + top + bottom) * (w + left + right) contiguous elements,
// dx: planes * h * w.  0 <= each pad < the dimension it pads, h * w < 2^31
// (the wrapper checks).  Returns the cudaError_t of the launch.
extern "C" int floodgan_reflect_pad_bwd_f32(const void* g, void* dx, long long planes, int h,
                                            int w, int left, int right, int top, int bottom,
                                            void* stream) {
  return launch_reflect_pad_bwd<float>(g, dx, planes, h, w, left, right, top, bottom, stream);
}

extern "C" int floodgan_reflect_pad_bwd_bf16(const void* g, void* dx, long long planes, int h,
                                             int w, int left, int right, int top, int bottom,
                                             void* stream) {
  return launch_reflect_pad_bwd<__nv_bfloat16>(g, dx, planes, h, w, left, right, top, bottom,
                                               stream);
}
