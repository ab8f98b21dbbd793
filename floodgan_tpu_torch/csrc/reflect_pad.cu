// The backward of reflect padding on (H, W) (K6), for Hopper (sm_90a).
//
// It replaces no Pallas kernel: in the JAX package the reflect pad's
// adjoint is plain XLA, written by hand in
// floodgan_tpu/ops/fused_grads.py:256-278 (_rp_axis_adjoint, _rp_bwd) as
// interior slices plus flipped border blocks added in a fixed order.
// PyTorch's own backward of F.pad(mode="reflect") on the card scatters with
// atomics, so its sums land in a different order from run to run (and
// torch.use_deterministic_algorithms refuses it).  This kernel is the
// port's deterministic form of JAX's adjoint.
//
// Contract.  g is the gradient of a padded NCHW tensor, (planes, H + top +
// bottom, W + left + right), each pad smaller than the dimension it pads,
// aligned to its element; dx is (planes, H, W).  The padded row q reads
// source row top - q above the image (q < top), q - top inside and
// 2H - 2 + top - q below; so the source row h receives the rows h + top,
// then top - h (1 <= h <= top), then 2H - 2 + top - h
// (H - 1 - bottom <= h <= H - 2).  The H axis is folded first, each
// partial sum rounded to the element type as JAX's .at[].add rounds it,
// then the W axis the same way on the folded rows.  Sums are taken in
// float and rounded to the element type after each add, so the result
// equals the plain version (slice, flip and add in that order) bit for bit
// in f32 and bf16.
//
// Bound: memory.  The least traffic is one read of g and one write of dx
// (at the trunk's bf16 site, 8x256x130^2 in and 8x256x128^2 out, 136 MB:
// 0.0407 ms at 3.35 TB/s); a few integer operations and at most 8 adds an
// element are far below the card's rates.  So the design is about bytes in
// flight and the width of each access:
//
// - Tiles are (plane, band of output rows); a band spans the whole width,
//   so every W-axis reflection lies inside the tile.  The host chooses the
//   band height (kernels.py: reflect_pad_bands) so that a band's padded
//   rows fit a stage of about 36 KB, and so that no band boundary cuts a
//   border zone: the first band holds rows 0..top, the last rows
//   H-1-bottom..H-1 (a short remainder joins the last band).  Band
//   [h0, h1) then folds from exactly the padded rows
//   [h0 == 0 ? 0 : h0 + top, h1 == H ? H + top + bottom : h1 + top): one
//   contiguous span of g.  A 130x130 bf16 plane of the trunk is one band.
// - One thread stages each span in shared memory with Hopper's bulk
//   asynchronous copy (cp.async.bulk, completing on an mbarrier): no
//   registers or instructions spent on the load, and 36 KB in flight a
//   copy.  A 2D tensor map cannot serve (its global strides must be
//   multiples of 16 bytes, a padded row is 260, 520, 1036 or 2072); the
//   1D copy needs 16-byte aligned ends, so it copies the enclosing aligned
//   window and the tile indexes into it from the span's start offset.  The
//   window never reaches past the 16-byte chunk that holds g's first or
//   last byte, and such a chunk lies in one page.
// - The grid is persistent (the blocks an SM holds, times the SMs) and
//   walks the tiles; each block has two stages, so the next tile's copy is
//   in flight while this one is folded (one stage where a band of very
//   wide rows fills more than half of a block's shared memory).  Any
//   number of planes takes one launch.
// - A tile is folded in two passes.  Pass A writes every run of 16 bytes
//   of dx (8 bf16 or 4 f32) as the interior of g, with no test of the
//   borders: a thread reads the two aligned 16-byte words of shared memory
//   that hold the run (consecutive threads on consecutive words: no bank
//   conflicts) and shifts them by the row's offset (a multiple of 2 or 4
//   bytes) with selects and funnel shifts.  Runs are stored as 16-byte
//   vectors where W * sizeof(T) is a multiple of 16, else element by
//   element.  Pass B, after a barrier, folds again from the stage only the
//   elements that a reflected row or column reaches (at most 9 terms, in
//   JAX's order), one a thread, and stores them over pass A's values.  A
//   single pass that tested each run for borders made every warp that held
//   a border column (all of them, at the trunk's 128 columns) run the
//   border path: it took the card as long as the scalar loads it replaced
//   (PERF.md, section 6).
//
// Measured times and bounds: PERF.md, section 6.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBarrierBytes = 128;  // the stages' mbarriers, ahead of the first stage
constexpr int kMaxStages = 2;

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

// The band plan: `rows` output rows a band (the last band holds the rest),
// `count` bands a plane, `stage_bytes` of shared memory a stage, `stages`
// stages a block (2, or 1 where two do not fit).
struct Bands {
  int rows, count, stage_bytes, stages;
};

// One tile: a band of one plane, its output rows [h0, h1) and the padded
// rows [q0, q1) that it folds from.
struct Tile {
  long long plane;
  int h0, h1, q0, q1;
};

__device__ __forceinline__ Tile tile_at(long long t, const Geometry& s, const Bands& b) {
  Tile k;
  k.plane = t / b.count;
  const int band = static_cast<int>(t - k.plane * b.count);
  k.h0 = band * b.rows;
  k.h1 = band == b.count - 1 ? s.h : k.h0 + b.rows;
  k.q0 = k.h0 == 0 ? 0 : k.h0 + s.top;
  k.q1 = k.h1 == s.h ? s.h + s.top + s.bottom : k.h1 + s.top;
  return k;
}

// The address of the tile's span in g.
template <typename T>
__device__ __forceinline__ uintptr_t span_start(const T* g, const Tile& k, const Geometry& s) {
  const long long hp = s.h + s.top + s.bottom;
  return reinterpret_cast<uintptr_t>(g + (k.plane * hp + k.q0) * s.wp);
}

// ---- Hopper's bulk copy and mbarrier (PTX ISA: cp.async.bulk, mbarrier).

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Waits until the barrier's phase of the given parity has completed; traps
// (a launch error, not a hung card) if a copy has not landed in ~2^35 cycles.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 35)) __trap();
  } while (!done);
}

// The tile's span, widened to its enclosing 16-byte chunks, copied into the
// stage at `dst`; the barrier's phase completes when its bytes have landed.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* g, const Geometry& s, const Bands& b, long long t,
                                           uint32_t dst, uint32_t bar) {
  const Tile k = tile_at(t, s, b);
  const uintptr_t start = span_start(g, k, s);
  const uintptr_t end = start + static_cast<uintptr_t>(k.q1 - k.q0) * s.wp * sizeof(T);
  const uintptr_t lo = start & ~static_cast<uintptr_t>(15);
  const uint32_t bytes = static_cast<uint32_t>(((end + 15) & ~static_cast<uintptr_t>(15)) - lo);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               :: "r"(dst), "l"(lo), "r"(bytes), "r"(bar) : "memory");
}

// ---- Folding from the staged band.

template <typename T>
struct alignas(16) Run {
  static constexpr int n = 16 / sizeof(T);
  T v[n];
};

// g at padded row q, padded column c, from the stage holding the tile
// whose span starts `head` bytes into it at row q0.
template <typename T>
__device__ __forceinline__ float staged(const unsigned char* st, int head, int q0, const Geometry& s,
                                        int q, int c) {
  return to_float(*reinterpret_cast<const T*>(st + head + ((q - q0) * s.wp + c) * int(sizeof(T))));
}

// The H-axis adjoint at source row h of the padded column c: the rows of
// g that reflect onto h, added in JAX's order.
template <typename T>
__device__ __forceinline__ float fold_rows(const unsigned char* st, int head, int q0, const Geometry& s,
                                           int h, int c) {
  float t = staged<T>(st, head, q0, s, h + s.top, c);
  if (h >= 1 && h <= s.top) t = add_rounded<T>(t, staged<T>(st, head, q0, s, s.top - h, c));
  if (h >= s.h - 1 - s.bottom && h <= s.h - 2) {
    t = add_rounded<T>(t, staged<T>(st, head, q0, s, 2 * s.h - 2 + s.top - h, c));
  }
  return t;
}

// dx at (h, w): the W-axis adjoint of the H-folded rows.
template <typename T>
__device__ __forceinline__ T fold(const unsigned char* st, int head, int q0, const Geometry& s, int h,
                                  int w) {
  float d = fold_rows<T>(st, head, q0, s, h, w + s.left);
  if (w >= 1 && w <= s.left) d = add_rounded<T>(d, fold_rows<T>(st, head, q0, s, h, s.left - w));
  if (w >= s.w - 1 - s.right && w <= s.w - 2) {
    d = add_rounded<T>(d, fold_rows<T>(st, head, q0, s, h, 2 * s.w - 2 + s.left - w));
  }
  return from_float<T>(d);
}

__device__ __forceinline__ bool row_on_border(const Geometry& s, int h) {
  return (h >= 1 && h <= s.top) || (h >= s.h - 1 - s.bottom && h <= s.h - 2);
}

// The 16 bytes at byte `off` of the stage: the two aligned words that hold
// them, shifted by off % 16 (a multiple of the element size).  The second
// word may lie past the span, inside the stage's 16 bytes of slack.
template <typename T>
__device__ __forceinline__ Run<T> window(const unsigned char* st, int off) {
  const uint4 a = *reinterpret_cast<const uint4*>(st + (off & ~15));
  const uint4 b = *reinterpret_cast<const uint4*>(st + (off & ~15) + 16);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int words = (off & 15) >> 2, bits = (off & 3) * 8;
  uint32_t x[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const uint32_t even = (words & 1) ? w[j + 1] : w[j];
    const uint32_t odd = (words & 1) ? w[j + 3] : w[j + 2];
    x[j] = (words & 2) ? odd : even;
  }
  uint32_t out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = __funnelshift_r(x[j], x[j + 1], bits);
  Run<T> run;
  memcpy(&run, out, sizeof(run));
  return run;
}

// Pass A of a tile: every run of dx as the interior of g (a cropped copy),
// 16 bytes at a time, with no test of the borders.
template <typename T>
__device__ __forceinline__ void copy_runs(const unsigned char* st, int head, T* __restrict__ dx,
                                          const Geometry& s, const Tile& k, const Divider& by_runs,
                                          bool vec_store) {
  constexpr int n = Run<T>::n;
  const unsigned runs = static_cast<unsigned>(k.h1 - k.h0) * by_runs.d;
  for (unsigned r = threadIdx.x; r < runs; r += kThreads) {
    const unsigned hr = by_runs.div(r);
    const int h = k.h0 + static_cast<int>(hr);
    const int w0 = static_cast<int>(r - hr * by_runs.d) * n;
    const Run<T> run = window<T>(st, head + ((h + s.top - k.q0) * s.wp + w0 + s.left) * int(sizeof(T)));
    T* dst = dx + (k.plane * s.h + h) * static_cast<long long>(s.w) + w0;
    if (vec_store) {
      *reinterpret_cast<Run<T>*>(dst) = run;
    } else {
#pragma unroll
      for (int j = 0; j < n; ++j) {
        if (w0 + j < s.w) dst[j] = run.v[j];
      }
    }
  }
}

// Pass B of a tile: the elements that a reflected row or column reaches,
// folded again from the stage and stored over pass A's values, one a
// thread: first the border columns of the band's other rows, then every
// column of its border rows.  On an axis of n padded by (p1, p2) the border
// zones are 1..p1 and n-1-p2..n-2; their union is walked once, as index 0
// (where p2 = n - 1), then 1..p1, then max(n-1-p2, p1+1)..n-2.
template <typename T>
__device__ __forceinline__ void fold_borders(const unsigned char* st, int head, T* __restrict__ dx,
                                             const Geometry& s, const Tile& k) {
  T* const plane = dx + k.plane * s.h * static_cast<long long>(s.w);
  const int col0 = s.w >= 2 && s.w - 1 - s.right == 0, right0 = max(s.w - 1 - s.right, s.left + 1);
  const int cols = col0 + s.left + max(0, s.w - 1 - right0);
  if (cols > 0) {
    const int n = (k.h1 - k.h0) * cols;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / cols, j = i - r * cols, h = k.h0 + r;
      if (row_on_border(s, h)) continue;
      const int w = j < col0 ? 0 : j < col0 + s.left ? 1 + j - col0 : right0 + j - col0 - s.left;
      plane[static_cast<long long>(h) * s.w + w] = fold<T>(st, head, k.q0, s, h, w);
    }
  }
  const int row0 = s.h >= 2 && s.h - 1 - s.bottom == 0 && k.h0 == 0;
  const int top0 = max(1, k.h0), tops = max(0, min(s.top, k.h1 - 1) - top0 + 1);
  const int bottom0 = max(max(s.h - 1 - s.bottom, s.top + 1), k.h0);
  const int rows = row0 + tops + max(0, min(s.h - 2, k.h1 - 1) - bottom0 + 1);
  for (int i = threadIdx.x; i < rows * s.w; i += kThreads) {
    const int r = i / s.w, w = i - r * s.w;
    const int h = r < row0 ? 0 : r < row0 + tops ? top0 + r - row0 : bottom0 + r - row0 - tops;
    plane[static_cast<long long>(h) * s.w + w] = fold<T>(st, head, k.q0, s, h, w);
  }
}

// vec_store: W * sizeof(T) is a multiple of 16 and dx 16-byte aligned, so
// every run of a row is a whole, aligned Run.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reflect_pad_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx, long long planes, Geometry s,
                       Bands b, Divider by_runs, int vec_store) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = shared_addr(smem);
  unsigned char* const stages = smem + kBarrierBytes;
  const long long tiles = planes * b.count;
  if (threadIdx.x == 0) {
    for (int i = 0; i < b.stages; ++i) mbar_init(bars + 8 * i);
    mbar_init_fence();
    for (int i = 0; i < b.stages; ++i) {
      const long long t = blockIdx.x + static_cast<long long>(i) * gridDim.x;
      if (t < tiles) stage_tile(g, s, b, t, shared_addr(stages + i * b.stage_bytes), bars + 8 * i);
    }
  }
  __syncthreads();
  int use = 0;  // tiles this block has folded
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++use) {
    const int i = b.stages == 1 ? 0 : (use & 1);
    const uint32_t parity = static_cast<uint32_t>(b.stages == 1 ? use : use >> 1) & 1u;
    unsigned char* const st = stages + i * b.stage_bytes;
    mbar_wait(bars + 8 * i, parity);
    const Tile k = tile_at(t, s, b);
    const int head = static_cast<int>(span_start(g, k, s) & 15);
    copy_runs<T>(st, head, dx, s, k, by_runs, vec_store != 0);
    __syncthreads();  // pass A's stores before pass B's over them
    fold_borders<T>(st, head, dx, s, k);
    __syncthreads();  // every thread is done with the stage
    if (threadIdx.x == 0) {
      const long long next = t + static_cast<long long>(b.stages) * gridDim.x;
      if (next < tiles) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        stage_tile(g, s, b, next, shared_addr(st), bars + 8 * i);
      }
    }
  }
}

// The plan as kernels.py:reflect_pad_bands makes it: checked here, since
// the kernel reads only the spans that it describes.
bool plan_fits(const Geometry& s, const Bands& b, int elem) {
  if (b.rows < 1 || b.count < 1 || b.stages < 1 || b.stages > kMaxStages || b.stage_bytes % 128 != 0) {
    return false;
  }
  if (b.count != s.h / b.rows + (s.h % b.rows > s.bottom ? 1 : 0)) return false;
  if (b.count > 1 && b.rows <= (s.top > s.bottom ? s.top : s.bottom)) return false;
  // The widest span: the first band's or the last's (the middle ones hold rows only).
  const int last = s.h - (b.count - 1) * b.rows;
  const int first_rows = (b.count == 1 ? s.h + s.top + s.bottom : b.rows + s.top);
  const int last_rows = last + s.bottom;
  const long long span = static_cast<long long>(first_rows > last_rows ? first_rows : last_rows) * s.wp * elem;
  return (span + 30) / 16 * 16 + 16 <= b.stage_bytes;
}

template <typename T>
int launch_reflect_pad_bwd(const void* g, void* dx, long long planes, int h, int w, int left,
                           int right, int top, int bottom, int band_rows, int bands, int stage_bytes,
                           int stages, void* stream) {
  const Geometry s{h, w, left, right, top, bottom, w + left + right};
  const Bands b{band_rows, bands, stage_bytes, stages};
  if (!plan_fits(s, b, sizeof(T))) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kBarrierBytes + stages * stage_bytes;
  auto kernel = reflect_pad_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = planes * bands;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int vec_store = (static_cast<long long>(w) * sizeof(T)) % 16 == 0 &&
                        (reinterpret_cast<uintptr_t>(dx) & 15u) == 0;
  const unsigned runs_per_row = static_cast<unsigned>((w + Run<T>::n - 1) / Run<T>::n);
  kernel<<<static_cast<unsigned>(tiles < resident ? tiles : resident), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(g), static_cast<T*>(dx), planes, s,
                                                b, make_divider(runs_per_row), vec_store);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: planes * (h + top + bottom) * (w + left + right) contiguous elements,
// dx: planes * h * w.  0 <= each pad < the dimension it pads, h * w < 2^31
// (the wrapper checks); band_rows, bands, stage_bytes and stages are
// kernels.py:reflect_pad_bands' plan (checked again here: a plan that does
// not fit returns cudaErrorInvalidValue).  Returns the cudaError_t of the
// launch.
extern "C" int floodgan_reflect_pad_bwd_f32(const void* g, void* dx, long long planes, int h,
                                            int w, int left, int right, int top, int bottom,
                                            int band_rows, int bands, int stage_bytes, int stages,
                                            void* stream) {
  return launch_reflect_pad_bwd<float>(g, dx, planes, h, w, left, right, top, bottom, band_rows,
                                       bands, stage_bytes, stages, stream);
}

extern "C" int floodgan_reflect_pad_bwd_bf16(const void* g, void* dx, long long planes, int h,
                                             int w, int left, int right, int top, int bottom,
                                             int band_rows, int bands, int stage_bytes, int stages,
                                             void* stream) {
  return launch_reflect_pad_bwd<__nv_bfloat16>(g, dx, planes, h, w, left, right, top, bottom,
                                               band_rows, bands, stage_bytes, stages, stream);
}
