// Decode attention (flash-decoding) for Hopper (sm_90a): one new query per
// request against its KV cache, with per-request lengths.
//
// Replaces the Pallas TPU kernel `decode_attention_kernel` / `_kernel` in
// src/repro/kernels/decode_attention/kernel.py.  Same function: the G =
// H/KV query rows of each KV head attend to the first `len[b]` cache
// positions with an f32 online softmax, and a row with length 0 gives 0
// (the TPU kernel's `l` clamp).  Lengths above S are bounded by S.
//
// What bounds it on the H100: bytes.  Each cached key and value is read
// once and used for G = 6 dot products (about 1.5 flops/byte in bf16), far
// below the card's ~295 flops/byte, so the least time is the cache bytes
// of the valid positions over the memory rate.  At the main path's shapes
// (4 slots x 2 KV heads x <= 512 positions x 128 dims) that is under a
// microsecond per layer, so in practice the launch itself dominates.
//
// Design, and what it does about that:
//  * the TPU kernel walks the sequence axis in order inside one grid cell;
//    on the GPU that would leave most SMs idle at B x KV = 8 cells, so the
//    sequence is split: one block of 4 warps per (128-position split, KV
//    head, request), each computing its G rows' partial (m, l, acc), and a
//    second small kernel merges the partials of the splits a request uses;
//  * the loop is bounded by min(len, S): splits past a request's length
//    exit at once and are never read, so the bytes moved follow the data;
//  * lane j of warp w scores key s0 + 32w + j against all G rows (q staged
//    once in shared memory, read as a broadcast); the P.V step reads each V
//    row coalesced across lanes, one head_dim/32 slice per lane;
//  * the cache is read in place through its strides: the model passes one
//    layer of its (B, Smax, KV, hd) cache viewed as (B, KV, Smax, hd).
#include "common.cuh"

namespace {

constexpr int kSplit = 128;                   // cache positions per block
constexpr int kWarps = kSplit / 32;
constexpr int kMaxG = 8;                      // query rows per KV head

__device__ __forceinline__ int valid_len(const int* lengths, int b, int S) {
  return min(max(lengths[b], 0), S);
}

// Partial (m, l, acc) of one split.  Scratch layout: m/l (B, KV, NS, G),
// acc (B, KV, NS, G, HD), all f32.
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
decode_partial(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ lengths, float* __restrict__ pm,
               float* __restrict__ pl, float* __restrict__ pacc, int KV, int G, int S,
               int NS, Strides qs, Strides ks, Strides vs, float scale) {
  constexpr int DPL = HD / 32;
  __shared__ float sQ[kMaxG][HD];
  __shared__ float sM[kWarps][kMaxG], sL[kWarps][kMaxG];
  __shared__ float sAcc[kWarps][kMaxG][HD];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n = valid_len(lengths, b, S);
  const int s0 = split * kSplit;
  if (s0 >= n) return;                        // never read by the combine
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* qb = q + b * qs.b + (long long)kvh * G * qs.h;
  for (int i = tid; i < kMaxG * HD; i += kWarps * 32) {
    const int g = i / HD, d = i % HD;
    sQ[g][d] = g < G ? to_f32(qb[g * qs.h + d]) : 0.f;
  }
  __syncthreads();

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  const int w0 = s0 + 32 * warp;              // this warp's first position
  const int kpos = w0 + lane;
  const bool valid = kpos < n;

  float s[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
  if (valid) {
    const T* kr = kb + kpos * ks.s;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = to_f32(kr[d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] += sQ[g][d] * kd;
    }
  }

  float m[kMaxG], l[kMaxG], p[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    const float sg = valid ? s[g] * scale : kNeg;
    m[g] = warp_max(sg);                      // kNeg when no position is valid
    p[g] = valid ? expf(sg - m[g]) : 0.f;
    l[g] = warp_sum(p[g]);
  }

  float acc[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  const int jend = min(32, n - w0);           // warp-uniform
  for (int j = 0; j < jend; ++j) {
    const T* vr = vb + (w0 + j) * vs.s;
    float vv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) vv[i] = to_f32(vr[lane + 32 * i]);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      const float pj = __shfl_sync(0xffffffffu, p[g], j);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] += pj * vv[i];
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (lane == 0) {
      sM[warp][g] = m[g];
      sL[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) sAcc[warp][g][lane + 32 * i] = acc[g][i];
  }
  __syncthreads();

  // merge the warps' partials into this split's (m, l, acc)
  const long long row0 = ((long long)(b * KV + kvh) * NS + split) * G;
  for (int i = tid; i < G * HD; i += kWarps * 32) {
    const int g = i / HD, d = i % HD;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sM[w][g]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sM[w][g] - mx);
      a += sAcc[w][g][d] * e;
      lsum += sL[w][g] * e;
    }
    pacc[(row0 + g) * HD + d] = a;
    if (d == 0) {
      pm[row0 + g] = mx;
      pl[row0 + g] = lsum;
    }
  }
}

// One block of HD threads per (head, request): merge the used splits.
template <typename T>
__global__ void decode_combine(const float* __restrict__ pm, const float* __restrict__ pl,
                               const float* __restrict__ pacc,
                               const int* __restrict__ lengths, T* __restrict__ o, int KV,
                               int G, int S, int NS, int HD, long long osb, long long osh) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int kvh = h / G, g = h % G;
  const int used = (valid_len(lengths, b, S) + kSplit - 1) / kSplit;
  const long long base = (long long)(b * KV + kvh) * NS;
  float mx = kNeg;
  for (int s = 0; s < used; ++s) mx = fmaxf(mx, pm[(base + s) * G + g]);
  float a = 0.f, lsum = 0.f;
  for (int s = 0; s < used; ++s) {
    const long long r = (base + s) * G + g;
    const float e = expf(pm[r] - mx);
    a += pacc[r * HD + d] * e;
    lsum += pl[r] * e;
  }
  o[b * osb + h * osh + d] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const int* lengths, void* o,
            float* pm, float* pl, float* pacc, int B, int H, int KV, int S, Strides qs,
            Strides ks, Strides vs, long long osb, long long osh, float scale,
            cudaStream_t stream) {
  const int G = H / KV, NS = (S + kSplit - 1) / kSplit;
  decode_partial<T, HD><<<dim3(NS, KV, B), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      pm, pl, pacc, KV, G, S, NS, qs, ks, vs, scale);
  decode_combine<T><<<dim3(H, B), HD, 0, stream>>>(pm, pl, pacc, lengths,
                                                    static_cast<T*>(o), KV, G, S, NS, HD,
                                                    osb, osh);
}

}  // namespace

// Scratch the caller allocates: m and l of B*KV*NS*G floats each and acc of
// B*KV*NS*G*hd floats, NS = ceil(S / 128).
extern "C" int decode_attention_splits(int S) { return (S + kSplit - 1) / kSplit; }

// dtype: 0 = float32, 1 = bfloat16.  Returns 0, a cudaError_t from the
// launches, or -1 when the arguments are outside what the kernel takes.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* lengths, void* o, float* pm,
    float* pl, float* pacc, int dtype, int B, int H, int KV, int S, int hd, long long qsb,
    long long qsh, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, float scale,
    void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxG || B > 65535 ||
      KV > 65535 || H > 65535)
    return -1;
  const Strides qs{qsb, qsh, 0}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    launch<float, 64>(q, k, v, lengths, o, pm, pl, pacc, B, H, KV, S, qs, ks, vs, osb, osh,
                      scale, st);
  else if (dtype == 0 && hd == 128)
    launch<float, 128>(q, k, v, lengths, o, pm, pl, pacc, B, H, KV, S, qs, ks, vs, osb, osh,
                       scale, st);
  else if (dtype == 1 && hd == 64)
    launch<__nv_bfloat16, 64>(q, k, v, lengths, o, pm, pl, pacc, B, H, KV, S, qs, ks, vs,
                              osb, osh, scale, st);
  else if (dtype == 1 && hd == 128)
    launch<__nv_bfloat16, 128>(q, k, v, lengths, o, pm, pl, pacc, B, H, KV, S, qs, ks, vs,
                               osb, osh, scale, st);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}
