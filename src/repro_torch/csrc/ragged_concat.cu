// Ragged concatenation for Hopper (sm_90a): N variable-length sources packed
// into one contiguous, zero-filled buffer.
//
// Replaces the Pallas TPU kernel `ragged_concat_kernel` / `_kernel` in
// src/repro/kernels/ragged_concat/kernel.py.  Same function: source i's
// first min(len_i, Lmax) rows of (Lmax, C) land at rows
// [off_i, off_i + len_i) of a (capacity, C) buffer, off the exclusive prefix
// sum of the lengths (computed by the wrapper); every other row is 0, and
// rows at or past capacity are dropped.
//
// What bounds it on the H100: bytes.  It does no arithmetic: the valid
// source rows are read once and the whole output written once.  At the
// concatenate node's size (three LiDAR clouds, about 506k points of 4 f32
// fields) that is about 16 MB, a few microseconds at 3.35 TB/s.
//
// Design, and what it does about that:
//  * the TPU kernel read-modify-writes a shared Lmax-row window of the
//    output on every grid step, which is race-free only because its grid is
//    sequential; here blocks run in any order, so each output row is
//    written exactly once, by the thread that owns it: a grid-stride loop
//    over the output in 16-byte vectors (8, 4, 2 or 1 bytes when the row
//    width does not allow 16) finds the row's source by a binary search
//    over the N offsets, copies the vector or writes 0;
//  * so the zero fill of rows past `total` (and of any row past a source's
//    Lmax) is part of the same pass: no byte is written twice, and no
//    data-dependent grid size needs the host to read `total` back;
//  * neighbouring threads take neighbouring vectors of one row, then of
//    the next rows, so reads and writes are coalesced; the kernel is
//    dtype-free (f32, bf16, int32 and uint8 all move as bytes).
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The source whose window holds row r: the last i with off[i] <= r.
__device__ __forceinline__ int source_of(const int* off, int n, long long r) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if ((long long)off[mid] <= r) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
ragged_concat(const unsigned char* __restrict__ src, const int* __restrict__ lengths,
              const int* __restrict__ off, unsigned char* __restrict__ out, int n, int lmax,
              long long row_bytes, long long capacity) {
  const long long per_row = row_bytes / sizeof(V);
  const long long total_vecs = capacity * per_row;
  const V zero{};
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < total_vecs;
       v += (long long)gridDim.x * kThreads) {
    const long long r = v / per_row, w = v % per_row;
    V val = zero;
    if (n > 0 && r >= off[0]) {
      const int i = source_of(off, n, r);
      const long long local = r - off[i];
      if (local < lengths[i] && local < lmax)
        val = reinterpret_cast<const V*>(src + ((long long)i * lmax + local) * row_bytes)[w];
    }
    reinterpret_cast<V*>(out + r * row_bytes)[w] = val;
  }
}

template <typename V>
void launch(const void* src, const int* lengths, const int* off, void* out, int n, int lmax,
            long long row_bytes, long long capacity, int sms, cudaStream_t stream) {
  const long long vecs = capacity * (row_bytes / (long long)sizeof(V));
  const long long want = (vecs + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
  ragged_concat<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(src), lengths, off, static_cast<unsigned char*>(out),
      n, lmax, row_bytes, capacity);
}

}  // namespace

// src (N, Lmax, row_bytes) and out (capacity, row_bytes), contiguous;
// lengths and offsets (N,) int32 on the card.  Returns 0, a cudaError_t,
// or -1 for arguments outside what the kernel takes.
extern "C" int ragged_concat_fwd(const void* src, const int* lengths, const int* offsets,
                                 void* out, int n, int lmax, long long row_bytes,
                                 long long capacity, void* stream) {
  if (n < 0 || lmax < 0 || row_bytes < 1 || capacity < 0) return -1;
  if (capacity == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0)
    launch<uint4>(src, lengths, offsets, out, n, lmax, row_bytes, capacity, sms, st);
  else if (align % 8 == 0)
    launch<uint2>(src, lengths, offsets, out, n, lmax, row_bytes, capacity, sms, st);
  else if (align % 4 == 0)
    launch<unsigned int>(src, lengths, offsets, out, n, lmax, row_bytes, capacity, sms, st);
  else if (align % 2 == 0)
    launch<unsigned short>(src, lengths, offsets, out, n, lmax, row_bytes, capacity, sms, st);
  else
    launch<unsigned char>(src, lengths, offsets, out, n, lmax, row_bytes, capacity, sms, st);
  return static_cast<int>(cudaGetLastError());
}
