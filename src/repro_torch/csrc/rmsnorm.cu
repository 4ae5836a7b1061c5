// Fused residual add + RMSNorm for Hopper (sm_90a): one block per row.
//
// Replaces the Pallas TPU kernel `rmsnorm_kernel` / `_kernel` in
// src/repro/kernels/rmsnorm/kernel.py, and covers the norm-only and Gemma
// cases of `rms_norm` in src/repro/models/common.py as well.  Per row of D:
//   h = x + r in f32 (h = x where no r is given),
//   y = h * rsqrt(mean(h^2) + eps) * s, with s = scale or, for Gemma, 1 + scale (f32);
// y, and h where it is asked for, are stored in x's type (f32 or bf16).
//
// What bounds it on the H100: bytes, and on the decode path the launch
// itself.  Per element it reads x and r and writes y and h (and reads the
// D-wide f32 scale once per row, from L2 after the first row) and does about
// six flops: far below the ~295 flops a byte at which the card turns
// compute-bound.  At decode (R = 4 rows of D = 1536-4096) a call moves 25-130
// KB, 0.01-0.04 us at 3.35 TB/s, so its time is a launch and one dependent
// round trip to memory; at prefill (R up to 384) it is the bytes.
//
// Design, and what it does about that:
//  * one block per row, the row in registers: each thread holds VPT 16-byte
//    vectors (8 bf16 or 4 f32 values) of x, r and the scale, and issues all
//    of those loads before any arithmetic that depends on them, so a row
//    costs one dependent trip to memory and nothing is read twice;
//  * h is stored as soon as it is formed, before the reduction;
//  * the sum of squares is taken in f32: a shuffle tree in each warp, one
//    shared slot per warp, one barrier, then every thread adds the warp sums
//    itself in the same order, so no second barrier is needed and every
//    thread holds the same 1/rms;
//  * y and h leave in 16-byte stores;
//  * a row whose D is not a multiple of the vector, or whose pointers or row
//    strides are not 16-byte aligned, takes the scalar instantiation of the
//    same kernel: the same threads and registers, element by element;
//  * x and r each take a row stride, so a (B, 1, D) slice of a (B, S, D)
//    tensor (prefill's last position) is normed where it lies, without a
//    copy.  y and h are contiguous.
// A row is 3-8 KB per tensor on the served models' paths: splitting it over
// several blocks or a cluster would only add a second round trip.
//
// Backward (`rmsnorm_bwd`, no TPU counterpart: the reference's training
// forward differentiates the plain norm in XLA).  Per row, with h = x + r
// in f32, rstd = rsqrt(mean(h^2) + eps), xhat = h * rstd and g = s * dy:
//   dx = dh + rstd * (g - xhat * mean(g * xhat))   (the grad of x and of r;
//        dh is the grad of the residual output h, or 0),
//   dscale = sum over rows of dy * xhat            (f32; Gemma's 1 + scale
//        has the same derivative).
// h is formed again from x and r in f32, as the plain version does.  It is
// bound by bytes: it reads x, r, dy, dh and writes dx (five row tensors).
// Design: a row is held in registers by a group of threads, the whole
// block (D > 256) or one warp (D <= 256, 8 rows to a block: qk_norm's
// rows of head_dim); each block walks its rows with a grid stride and
// keeps its threads' dscale sums in registers; they leave as one partial
// row a block (`part`, nb x D f32), which a second kernel sums over the
// blocks in block order.  No atomics: a call's result depends only on its
// shapes, so repeated steps are bit-stable.  Loads are scalar (coalesced,
// 2 or 4 bytes a lane): a simple first version.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;              // a block; VPT grows before the block does
constexpr int kWantThreads = 256;             // D = 1536-4096 fit here in both types

// Eight bf16 or four f32 values in one 16-byte word, unpacked to f32 and back.
template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& p, float* f) {
    f[0] = __uint_as_float(p.x); f[1] = __uint_as_float(p.y);
    f[2] = __uint_as_float(p.z); f[3] = __uint_as_float(p.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int N = 8;
  // element 2i is the low half of word i: a bf16's bits are the top half of its f32
  __device__ static void unpack2(unsigned w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static void unpack(const uint4& p, float* f) {
    unpack2(p.x, f); unpack2(p.y, f + 2); unpack2(p.z, f + 4); unpack2(p.w, f + 6);
  }
  __device__ static unsigned pack2(float lo, float hi) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

// The first element of this thread's k-th vector: vectors are dealt to the
// threads in turn, so a warp's loads of one k are contiguous.
__device__ __forceinline__ int vec_base(int k, int n) {
  return (k * static_cast<int>(blockDim.x) + static_cast<int>(threadIdx.x)) * n;
}

template <typename T, int VPT, bool VEC>
__device__ __forceinline__ void store_row(T* __restrict__ out, const float (&v)[VPT][Elem<T>::N],
                                          int d) {
  constexpr int N = Elem<T>::N;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int base = vec_base(k, N);
    if constexpr (VEC) {
      if (base < d) *reinterpret_cast<uint4*>(out + base) = Elem<T>::pack(v[k]);
    } else {
#pragma unroll
      for (int u = 0; u < N; ++u)
        if (base + u < d) out[base + u] = from_f32<T>(v[k][u]);
    }
  }
}

template <typename T, int VPT, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const float* __restrict__ scale, T* __restrict__ y, T* __restrict__ h,
                   int d, long long sx, long long sr, float eps, int gemma) {
  constexpr int N = Elem<T>::N;
  __shared__ float warp_ss[kMaxThreads / 32];
  const long long row = blockIdx.x;
  const bool has_r = r != nullptr;
  x += row * sx;
  if (has_r) r += row * sr;

  float hf[VPT][N], sf[VPT][N];
  if constexpr (VEC) {
    uint4 xw[VPT], rw[VPT], sw[VPT][N / 4];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {             // every load in flight first
      const int base = vec_base(k, N);
      if (base < d) {
        xw[k] = *reinterpret_cast<const uint4*>(x + base);
        if (has_r) rw[k] = *reinterpret_cast<const uint4*>(r + base);
#pragma unroll
        for (int q = 0; q < N / 4; ++q)
          sw[k][q] = *reinterpret_cast<const uint4*>(scale + base + 4 * q);
      }
    }
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int base = vec_base(k, N);
      if (base < d) {
        Elem<T>::unpack(xw[k], hf[k]);
        if (has_r) {
          float rf[N];
          Elem<T>::unpack(rw[k], rf);
#pragma unroll
          for (int u = 0; u < N; ++u) hf[k][u] += rf[u];
        }
#pragma unroll
        for (int q = 0; q < N / 4; ++q) Elem<float>::unpack(sw[k][q], sf[k] + 4 * q);
      } else {
#pragma unroll
        for (int u = 0; u < N; ++u) hf[k][u] = sf[k][u] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int base = vec_base(k, N);
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const int e = base + u;
        hf[k][u] = sf[k][u] = 0.f;
        if (e < d) {
          hf[k][u] = to_f32(x[e]);
          if (has_r) hf[k][u] += to_f32(r[e]);
          sf[k][u] = scale[e];
        }
      }
    }
  }

  if (h != nullptr) store_row<T, VPT, VEC>(h + row * d, hf, d);

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k)
#pragma unroll
    for (int u = 0; u < N; ++u) ss += hf[k][u] * hf[k][u];
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) warp_ss[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += warp_ss[w];
  const float rstd = rsqrtf(total / static_cast<float>(d) + eps);

  const float add = gemma ? 1.f : 0.f;         // (1 + scale) formed in f32, as the reference
#pragma unroll
  for (int k = 0; k < VPT; ++k)
#pragma unroll
    for (int u = 0; u < N; ++u) hf[k][u] = hf[k][u] * rstd * (sf[k][u] + add);
  store_row<T, VPT, VEC>(y + row * d, hf, d);
}

template <typename T, int VPT, bool VEC>
cudaError_t launch(const void* x, const void* r, const float* scale, void* y, void* h,
                   long long rows, int d, long long sx, long long sr, float eps, int gemma,
                   int threads, cudaStream_t st) {
  rmsnorm_fwd_kernel<T, VPT, VEC><<<static_cast<unsigned>(rows), threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), scale, static_cast<T*>(y),
      static_cast<T*>(h), d, sx, sr, eps, gemma);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* r, const float* scale, void* y, void* h,
             long long rows, int d, long long sx, long long sr, float eps, int gemma,
             cudaStream_t st) {
  constexpr int N = Elem<T>::N;
  const long long nvec = (d + N - 1) / N;
  int vpt = 1;
  while (vpt < 4 && (nvec + vpt - 1) / vpt > kWantThreads) vpt *= 2;
  long long threads = (nvec + vpt - 1) / vpt;
  if (threads > kMaxThreads) return -1;       // D beyond a block's registers
  threads = (threads + 31) / 32 * 32;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(h) |
                         static_cast<uintptr_t>(sx * sizeof(T)) |
                         static_cast<uintptr_t>(sr * sizeof(T)) |
                         static_cast<uintptr_t>(static_cast<long long>(d) * sizeof(T));
  const bool vec = bits % 16 == 0;
  const int t = static_cast<int>(threads);
#define RMSNORM_LAUNCH(V, VEC_)                                                              \
  return static_cast<int>(launch<T, V, VEC_>(x, r, scale, y, h, rows, d, sx, sr, eps, gemma, \
                                              t, st))
  if (vpt == 1) { if (vec) RMSNORM_LAUNCH(1, true); RMSNORM_LAUNCH(1, false); }
  if (vpt == 2) { if (vec) RMSNORM_LAUNCH(2, true); RMSNORM_LAUNCH(2, false); }
  if (vec) RMSNORM_LAUNCH(4, true);
  RMSNORM_LAUNCH(4, false);
#undef RMSNORM_LAUNCH
}

// ---- backward --------------------------------------------------------------

constexpr int kBwdMaxThreads = 512;
constexpr int kWarpRowsMaxD = 256;            // at or below: one warp a row, 8 rows a block

// Sum of v over the row group: the warp (WARP_ROWS) or the whole block, in a
// fixed order; every thread of the group gets the same sum.
template <bool WARP_ROWS>
__device__ __forceinline__ float group_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (WARP_ROWS) return v;
  __syncthreads();                            // the previous sum's readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) t += red[w];
  return t;
}

template <typename T, int EPT, bool WARP_ROWS>
__global__ void __launch_bounds__(kBwdMaxThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const float* __restrict__ scale, const T* __restrict__ dy,
                   const T* __restrict__ dh, T* __restrict__ dx, float* __restrict__ part,
                   long long rows, int d, long long sx, long long sr, float eps, int gemma) {
  __shared__ float red[kBwdMaxThreads / 32];
  extern __shared__ float slab[];             // WARP_ROWS: each warp's dscale sums, (rpb, d)
  const int tpr = WARP_ROWS ? 32 : static_cast<int>(blockDim.x);
  const int group = WARP_ROWS ? static_cast<int>(threadIdx.x >> 5) : 0;
  const int rpb = WARP_ROWS ? static_cast<int>(blockDim.x >> 5) : 1;
  const int li = static_cast<int>(threadIdx.x) - group * tpr;
  const float add = gemma ? 1.f : 0.f;
  float s[EPT], ds[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int e = li + k * tpr;
    s[k] = e < d ? scale[e] + add : 0.f;
    ds[k] = 0.f;
  }
  for (long long row = static_cast<long long>(blockIdx.x) * rpb + group; row < rows;
       row += static_cast<long long>(gridDim.x) * rpb) {
    const T* xr = x + row * sx;
    const T* rr = r == nullptr ? nullptr : r + row * sr;
    float h[EPT], dyf[EPT];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int e = li + k * tpr;
      h[k] = dyf[k] = 0.f;
      if (e < d) {
        h[k] = to_f32(xr[e]);
        if (rr != nullptr) h[k] += to_f32(rr[e]);
        dyf[k] = to_f32(dy[row * d + e]);
      }
      ss += h[k] * h[k];
    }
    const float rstd = rsqrtf(group_sum<WARP_ROWS>(ss, red) / static_cast<float>(d) + eps);
    float c = 0.f;                            // sum of s * dy * h over the row
#pragma unroll
    for (int k = 0; k < EPT; ++k) c += s[k] * dyf[k] * h[k];
    c = group_sum<WARP_ROWS>(c, red) * rstd * rstd / static_cast<float>(d);   // mean(g xhat) rstd
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int e = li + k * tpr;
      if (e < d) {
        const float xhat = h[k] * rstd;
        float v = rstd * (s[k] * dyf[k]) - xhat * c;
        if (dh != nullptr) v += to_f32(dh[row * d + e]);
        dx[row * d + e] = from_f32<T>(v);
        ds[k] += dyf[k] * xhat;
      }
    }
  }
  float* out = part + static_cast<long long>(blockIdx.x) * d;
  if constexpr (!WARP_ROWS) {
#pragma unroll
    for (int k = 0; k < EPT; ++k)
      if (li + k * tpr < d) out[li + k * tpr] = ds[k];
  } else {                                    // the warps' sums, added in warp order
#pragma unroll
    for (int k = 0; k < EPT; ++k)
      if (li + k * tpr < d) slab[group * d + li + k * tpr] = ds[k];
    __syncthreads();
    for (int e = threadIdx.x; e < d; e += blockDim.x) {
      float t = 0.f;
      for (int w = 0; w < rpb; ++w) t += slab[w * d + e];
      out[e] = t;
    }
  }
}

// dscale[e] = sum over the nb partial rows of part[i][e], in row order: 32
// columns a block, warp w adding rows w, w + 8, ..., then the 8 warp sums in
// warp order.
__global__ void __launch_bounds__(256)
rmsnorm_dscale_kernel(const float* __restrict__ part, float* __restrict__ dscale, int nb,
                      int d) {
  __shared__ float sums[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float t = 0.f;
  if (e < d)
    for (int i = warp; i < nb; i += 8) t += part[static_cast<long long>(i) * d + e];
  sums[warp][lane] = t;
  __syncthreads();
  if (warp == 0 && e < d) {
    float total = 0.f;
    for (int w = 0; w < 8; ++w) total += sums[w][lane];
    dscale[e] = total;
  }
}

template <typename T, int EPT, bool WARP_ROWS>
cudaError_t launch_bwd(const void* x, const void* r, const float* scale, const void* dy,
                       const void* dh, void* dx, float* part, float* dscale, long long rows,
                       int d, long long sx, long long sr, float eps, int gemma, int threads,
                       int nb, cudaStream_t st) {
  const int smem = WARP_ROWS ? threads / 32 * d * 4 : 0;
  rmsnorm_bwd_kernel<T, EPT, WARP_ROWS><<<nb, threads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), scale, static_cast<const T*>(dy),
      static_cast<const T*>(dh), static_cast<T*>(dx), part, rows, d, sx, sr, eps, gemma);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dscale_kernel<<<(d + 31) / 32, 256, 0, st>>>(part, dscale, nb, d);
  return cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* x, const void* r, const float* scale, const void* dy,
                 const void* dh, void* dx, float* part, float* dscale, long long rows, int d,
                 long long sx, long long sr, float eps, int gemma, int nb, cudaStream_t st) {
#define RMSNORM_BWD(EPT_, WR_, THREADS_)                                                     \
  return static_cast<int>(launch_bwd<T, EPT_, WR_>(x, r, scale, dy, dh, dx, part, dscale,   \
                                                    rows, d, sx, sr, eps, gemma, THREADS_,  \
                                                    nb, st))
  if (d <= 128) RMSNORM_BWD(4, true, 256);
  if (d <= kWarpRowsMaxD) RMSNORM_BWD(8, true, 256);
  const int ept = d <= 4096 ? 8 : 16;
  const int threads = ((d + ept - 1) / ept + 31) / 32 * 32;
  if (ept == 8) RMSNORM_BWD(8, false, threads);
  RMSNORM_BWD(16, false, threads);
#undef RMSNORM_BWD
}

}  // namespace

// Backward of `rmsnorm_fwd` over the same x, r (may be null), scale and row
// strides: dy (rows, d) contiguous, dh (rows, d) contiguous or null (the
// grad of the residual output), dx (rows, d) contiguous out, part (nb, d)
// f32 scratch, dscale (d,) f32 out.  nb = min(ceil(rows / rpb), ...) blocks
// with rpb = 8 rows a block for d <= 256, else 1 (the wrapper's
// `rmsnorm_bwd_blocks` rule); nb must be >= 1 and each block's rows are
// rpb-strided from blockIdx.x * rpb.  Two launches; none for rows = 0.
// Returns 0, a cudaError_t, or -1 for arguments outside what it takes
// (d < 1 or d > 8192, nb < 1).
extern "C" int rmsnorm_bwd(const void* x, const void* r, const float* scale, const void* dy,
                           const void* dh, void* dx, float* part, float* dscale,
                           long long rows, int d, long long sx, long long sr, float eps,
                           int gemma, int bf16, int nb, void* stream) {
  if (rows < 0 || d < 1 || d > 8192 || nb < 1 || nb > 0x7fffffff) return -1;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_bwd<__nv_bfloat16>(x, r, scale, dy, dh, dx, part, dscale, rows, d,
                                            sx, sr, eps, gemma, nb, st)
              : dispatch_bwd<float>(x, r, scale, dy, dh, dx, part, dscale, rows, d, sx, sr,
                                    eps, gemma, nb, st);
}

// x (rows, d) with row stride sx elements, r likewise with sr (r may be
// null: the norm alone), scale (d,) f32, y (rows, d) contiguous and h (rows,
// d) contiguous or null (h = x + r is then not stored); bf16 = 1 for
// __nv_bfloat16 tensors, 0 for float.  One launch; none for rows = 0.
// Returns 0, a cudaError_t, or -1 for arguments outside what the kernel
// takes (d < 1, or d above 512 threads of 4 vectors: 16384 bf16, 8192 f32).
extern "C" int rmsnorm_fwd(const void* x, const void* r, const float* scale, void* y, void* h,
                           long long rows, int d, long long sx, long long sr, float eps,
                           int gemma, int bf16, void* stream) {
  if (rows < 0 || rows > 0x7fffffffLL || d < 1) return -1;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(x, r, scale, y, h, rows, d, sx, sr, eps, gemma, st)
              : dispatch<float>(x, r, scale, y, h, rows, d, sx, sr, eps, gemma, st);
}
