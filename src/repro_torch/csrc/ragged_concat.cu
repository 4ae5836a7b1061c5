// Ragged concatenation for Hopper (sm_90a): N variable-length sources packed
// into one contiguous, zero-filled buffer, in one launch.
//
// Replaces the Pallas TPU kernel `ragged_concat_kernel` / `_kernel` in
// src/repro/kernels/ragged_concat/kernel.py.  Same function: source i's
// first min(len_i, Lmax) rows of (Lmax, C) land at rows
// [off_i, off_i + len_i) of a (capacity, C) buffer, off the exclusive prefix
// sum of the lengths; every other row is 0, and rows at or past capacity are
// dropped.  The offsets and the total are outputs too.
//
// What bounds it on the H100: bytes.  It does no arithmetic: the valid
// source rows are read once and the whole output written once.  At the
// concatenate node's size (three LiDAR clouds, about 506k points of 4 f32
// fields) that is about 16 MB, 4.8 us at 3.35 TB/s; a launch and one
// dependent round trip to memory cost about 1-2 us of that again.
//
// Design, and what it does about that:
//  * one launch per call: every block scans the N lengths itself (in
//    chunks of 256 in shared memory, warp shuffles inside a chunk) until it
//    reaches the first source that covers its first output row; block 0
//    scans them all and writes the offsets and the total.  No prefix sum,
//    fill or concatenation runs before the kernel, and no call reads
//    `total` back to the host;
//  * each block owns a contiguous range of output rows (16 KB of output)
//    and walks it as runs: the rows of one source inside the range are one
//    contiguous byte range in the source as well, so a run is a flat copy
//    in 16-byte vectors (8, 4, 2 or 1 bytes when the row width or the
//    pointers do not allow 16), four independent loads in flight per thread
//    and no division per vector; rows past a source's Lmax and past `total`
//    are written as zeros in the same pass, so every output byte is written
//    exactly once;
//  * the source lookup is per block, not per vector, and the index
//    arithmetic inside a run is 32-bit; the kernel is dtype-free (f32,
//    bf16, int32 and uint8 all move as bytes) and reads int32 or int64
//    lengths as they are.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                    // independent vectors in flight per thread
constexpr int kBlockBytes = 16384;            // output bytes a block owns (at least one row)

template <typename V>
__device__ __forceinline__ void copy_run(const V* __restrict__ s, V* __restrict__ d, int nv) {
  for (int base = 0; base < nv; base += kThreads * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < nv) v[u] = __ldg(s + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < nv) d[i] = v[u];
    }
  }
}

template <typename V>
__device__ __forceinline__ void zero_run(V* __restrict__ d, int nv) {
  const V zero{};
  for (int i = threadIdx.x; i < nv; i += kThreads) d[i] = zero;
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
ragged_concat(const unsigned char* __restrict__ src, const L* __restrict__ lengths,
              int* __restrict__ offsets, int* __restrict__ total,
              unsigned char* __restrict__ out, int n, int lmax, int row_bytes,
              long long capacity, long long rows_per_block) {
  __shared__ int incl_s[kThreads];
  __shared__ int len_s[kThreads];
  __shared__ int warp_s[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(capacity, r0 + rows_per_block);
  const bool writer = blockIdx.x == 0;

  // The first source i whose rows reach past r0 (inclusive prefix > r0):
  // the prefixes never fall, so the sources below r0 are a prefix of each
  // chunk and __syncthreads_count finds where it ends.
  int carry = 0, first = n, first_off = 0, first_len = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const int len = i < n ? static_cast<int>(lengths[i]) : 0;
    int v = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_s[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += warp_s[w];
    const int incl = carry + v;
    if (writer && i < n) offsets[i] = incl - len;
    incl_s[tid] = incl;
    len_s[tid] = len;
    const int below = __syncthreads_count(i < n && (long long)incl <= r0);
    carry = incl_s[kThreads - 1];
    if (first == n && below < min(kThreads, n - base)) {
      first = base + below;
      first_len = len_s[below];
      first_off = incl_s[below] - first_len;
      if (!writer) break;                     // the same in every thread of the block
    }
  }
  if (writer && tid == 0) {
    *total = carry;
    if (n == 0) offsets[0] = 0;               // as the reference: offsets (1,) = [0] at N = 0
  }

  long long cur = r0, off = first_off;
  int i = first, len = first_len;
  while (cur < r1) {
    if (i >= n) {                             // past the last source: zeros
      zero_run(reinterpret_cast<V*>(out + cur * row_bytes),
               static_cast<int>((r1 - cur) * row_bytes / (int)sizeof(V)));
      break;
    }
    const long long end = min(r1, off + len);
    const long long vend = min(end, off + min(len, lmax));
    if (cur < vend)
      copy_run(reinterpret_cast<const V*>(src + ((long long)i * lmax + (cur - off)) * row_bytes),
               reinterpret_cast<V*>(out + cur * row_bytes),
               static_cast<int>((vend - cur) * row_bytes / (int)sizeof(V)));
    const long long zb = max(cur, vend);
    if (zb < end)                             // rows past this source's Lmax
      zero_run(reinterpret_cast<V*>(out + zb * row_bytes),
               static_cast<int>((end - zb) * row_bytes / (int)sizeof(V)));
    cur = max(cur, end);
    off += len;
    if (++i < n) len = static_cast<int>(lengths[i]);
  }
}

template <typename V, typename L>
cudaError_t launch(const void* src, const L* lengths, int* offsets, int* total, void* out,
                   int n, int lmax, int row_bytes, long long capacity, cudaStream_t stream) {
  const long long rows_per_block = row_bytes > 0 && row_bytes < kBlockBytes
                                       ? kBlockBytes / row_bytes : 1;
  const long long rows = row_bytes > 0 ? capacity : 0;   // zero-width rows: nothing to write
  long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks < 1) blocks = 1;                 // block 0 still writes offsets and total
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ragged_concat<V, L><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(src), lengths, offsets, total,
      static_cast<unsigned char*>(out), n, lmax, row_bytes, rows, rows_per_block);
  return cudaGetLastError();
}

template <typename L>
cudaError_t dispatch(const void* src, const L* lengths, int* offsets, int* total, void* out,
                     int n, int lmax, int row_bytes, long long capacity, cudaStream_t st) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0)
    return launch<uint4>(src, lengths, offsets, total, out, n, lmax, row_bytes, capacity, st);
  if (align % 8 == 0)
    return launch<uint2>(src, lengths, offsets, total, out, n, lmax, row_bytes, capacity, st);
  if (align % 4 == 0)
    return launch<unsigned int>(src, lengths, offsets, total, out, n, lmax, row_bytes,
                                capacity, st);
  if (align % 2 == 0)
    return launch<unsigned short>(src, lengths, offsets, total, out, n, lmax, row_bytes,
                                  capacity, st);
  return launch<unsigned char>(src, lengths, offsets, total, out, n, lmax, row_bytes,
                               capacity, st);
}

}  // namespace

// src (N, Lmax, row_bytes) and out (capacity, row_bytes), contiguous;
// lengths (N,) int32 (len64 = 0) or int64 (len64 = 1) on the card; offsets
// (max(N, 1),) and total (a single int32) are written by the kernel.  One launch,
// also when N, capacity or row_bytes is 0.  Returns 0, a cudaError_t, or -1
// for arguments outside what the kernel takes.
extern "C" int ragged_concat_fwd(const void* src, const void* lengths, int len64, int* offsets,
                                 int* total, void* out, int n, int lmax, int row_bytes,
                                 long long capacity, void* stream) {
  if (n < 0 || lmax < 0 || row_bytes < 0 || capacity < 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      len64 ? dispatch(src, static_cast<const long long*>(lengths), offsets, total, out, n,
                       lmax, row_bytes, capacity, st)
            : dispatch(src, static_cast<const int*>(lengths), offsets, total, out, n, lmax,
                       row_bytes, capacity, st);
  return static_cast<int>(e);
}
