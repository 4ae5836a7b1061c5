// Causal GQA flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` / `_kernel` in
// src/repro/kernels/flash_attention/kernel.py.  Same function: online
// softmax (m, l, acc) in f32 over key tiles, causal key tiles past the
// diagonal skipped, keys >= Sk masked, and the TOP-LEFT causal convention
// of the TPU kernel (query i sees keys 0..i, whatever Sq and Sk are), which
// differs from the bottom-right convention of GPU attention libraries when
// Sq != Sk.
//
// What bounds it on the H100: at the main path's prefill shapes (one
// prompt of 16-384 tokens, 12 heads, head_dim 128) the work is a few
// hundred MFLOP over a few MB, so the card's memory is not the limit; this
// first version does its products with f32 FMAs on the CUDA cores, so it is
// bound by operations at the non-tensor f32 rate (and by shared-memory
// bandwidth feeding them), not by the tensor cores.  wgmma/TMA are left to
// a later version.
//
// Design, and what it does about that:
//  * one block of 4 warps per (q-tile of 16 rows, head, batch); the Pallas
//    grid's sequential K axis becomes a loop inside the block, so nothing
//    carries across blocks;
//  * each key tile (32 keys) of K and V is staged once in shared memory as
//    f32 and reused by all 16 query rows; K rows are padded by one float so
//    that lane j reading key j's column d hits a distinct bank;
//  * lane j scores key j against the warp's 4 rows (q read as a shared-
//    memory broadcast), the row max and sum are warp shuffles, and the P.V
//    product reads p from shared memory (broadcast) and V row j coalesced,
//    each lane owning head_dim/32 output columns in registers;
//  * q/k/v/o are read and written through their strides, so the model's
//    (B, S, H, hd) activations need no transpose, and the ragged edges
//    (Sq, Sk not multiples of the tiles) are masked here, so nothing is
//    padded.
#include "common.cuh"

namespace {

constexpr int kBQ = 16;                       // query rows per block
constexpr int kBK = 32;                       // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;           // query rows per warp

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int G, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
          Strides os, int causal, float scale) {
  constexpr int DPL = HD / 32;                // output columns per lane
  __shared__ float sQ[kBQ][HD];
  __shared__ float sK[kBK][HD + 1];
  __shared__ float sV[kBK][HD];
  __shared__ float sP[kBQ][kBK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * HD; i += kWarps * 32) {
    const int r = i / HD, d = i % HD, qpos = q0 + r;
    sQ[r][d] = qpos < Sq ? to_f32(qb[qpos * qs.s + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  // top-left causal: the block's last row q0+kBQ-1 sees keys up to itself
  const int kend = causal ? min(Sk, min(Sq, q0 + kBQ)) : Sk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                          // sQ written / previous tile consumed
    for (int i = tid; i < kBK * HD; i += kWarps * 32) {
      const int j = i / HD, d = i % HD, kpos = k0 + j;
      const bool ok = kpos < Sk;
      sK[j][d] = ok ? to_f32(kb[kpos * ks.s + d]) : 0.f;
      sV[j][d] = ok ? to_f32(vb[kpos * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = sK[lane][d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] += sQ[warp * kRows + r][d] * kd;
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r;
      const bool valid = kpos < Sk && (!causal || kpos <= qpos);
      const float sr = valid ? s[r] * scale : kNeg;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = valid ? expf(sr - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      sP[warp * kRows + r][lane] = p;
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) vv[i] = sV[j][lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = sP[warp * kRows + r][j];
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] += pj * vv[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      ob[qpos * os.s + lane + 32 * i] = from_f32<T>(acc[r][i] * inv);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
            int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os, int causal,
            float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, HD><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H / KV, Sq, Sk, qs, ks, vs, os, causal, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns 0, a cudaError_t from the
// launch, or -1 when the arguments are outside what the kernel takes.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B, int H, int KV,
    int Sq, int Sk, int hd, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, int causal, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || B > 65535 || H > 65535)
    return -1;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    launch<float, 64>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, scale, st);
  else if (dtype == 0 && hd == 128)
    launch<float, 128>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, scale, st);
  else if (dtype == 1 && hd == 64)
    launch<__nv_bfloat16, 64>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, scale, st);
  else if (dtype == 1 && hd == 128)
    launch<__nv_bfloat16, 128>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, scale, st);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}
