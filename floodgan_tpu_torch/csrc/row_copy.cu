// Row copy (K5): a fresh copy of a contiguous tensor, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/microbench_head.py:copy_kernel (launched by
// head_raw_pallasfence), the identity copy o_ref[...] = x_ref[...] over a
// grid (n, h) of (1, 1, W, C) row blocks.  On the TPU it pinned its operand
// and its result to the row-major tiled layout in front of the content-head
// conv: a "layout fence".  A contiguous tensor is one flat stretch of bytes,
// so this kernel copies bytes and knows no dtype or shape.
//
// Design: one 16-byte vector per thread, loaded through the read-only path
// (__ldg), in a grid-stride loop whose grid covers the tensor: each block
// copies one contiguous 4 KB stretch, and the loop goes round again only
// beyond 2^31 - 1 blocks.  On the H100 this beat a persistent grid of a few
// blocks per SM and tiles of two to eight vectors per thread.  The vector is
// 16 bytes when source and destination lie at the same distance from a
// 16-byte boundary (always for a fresh output and a tensor that starts its
// storage); else the widest of 8, 4, 2 and 1 bytes for which they do.  A
// scalar head copies the bytes before the destination reaches that
// alignment (the source reaches it at the same byte), and a scalar tail the
// bytes after the last whole vector.
//
// Bound: memory.  Every byte is read once and written once; there is no
// arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
row_copy_bytes(const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
               long long head, long long nvec, long long tail) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (tid < head) dst[tid] = src[tid];

  const V* __restrict__ s = reinterpret_cast<const V*>(src + head);
  V* __restrict__ d = reinterpret_cast<V*>(dst + head);
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = tid; i < nvec; i += step) d[i] = __ldg(s + i);

  const long long t0 = head + nvec * static_cast<long long>(sizeof(V));
  if (tid < tail) dst[t0 + tid] = src[t0 + tid];
}

template <typename V>
int launch(const void* src, void* dst, long long nbytes, cudaStream_t stream) {
  constexpr long long width = sizeof(V);
  const long long misalign = static_cast<long long>(reinterpret_cast<uintptr_t>(dst) % width);
  long long head = misalign == 0 ? 0 : width - misalign;
  if (head > nbytes) head = nbytes;
  const long long nvec = (nbytes - head) / width;
  const long long tail = nbytes - head - nvec * width;

  long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  if (blocks < 1) blocks = 1;  // the head and tail threads
  row_copy_bytes<V><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), head, nvec, tail);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Copies nbytes from src to dst (the two must not overlap) on the stream.
// Returns the cudaError_t of the launch (0 on success; 0 with no launch for
// nbytes <= 0).
extern "C" int floodgan_row_copy(const void* src, void* dst, long long nbytes, void* stream) {
  if (nbytes <= 0) return 0;
  const uintptr_t apart = reinterpret_cast<uintptr_t>(src) ^ reinterpret_cast<uintptr_t>(dst);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (apart % 16 == 0) return launch<uint4>(src, dst, nbytes, s);
  if (apart % 8 == 0) return launch<uint2>(src, dst, nbytes, s);
  if (apart % 4 == 0) return launch<unsigned int>(src, dst, nbytes, s);
  if (apart % 2 == 0) return launch<unsigned short>(src, dst, nbytes, s);
  return launch<unsigned char>(src, dst, nbytes, s);
}
