// Backward of the GQA flash attention (csrc/flash_attention.cu) for Hopper
// (sm_90a): FlashAttention-2's backward, on the CUDA cores.
//
// No TPU kernel has a backward: the reference trains through XLA attention,
// and `flash_attention_kernel` (src/repro/kernels/flash_attention/kernel.py)
// is forward only.  This is the gradient of that function, with its
// top-left causal mask (query i sees keys 0..i whatever Sq and Sk are) and
// its rounding of p to v's type before P.V:
//   P = exp(scale * Q.K^T - lse)      (lse from the forward, per row)
//   dV = P~^T dO                      (P~: P rounded to the input type)
//   dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O)
//   dQ = scale * dS K,  dK = scale * dS^T Q
// with dK and dV of a KV head summed over its G query heads.  Everything
// is f32 inside; the gradients leave in the input type.
//
// What bounds it on the H100: operations.  A causal call does about 3.5x
// the forward's products (S and dP twice, dV, dK, dQ), 2.5 GFLOP a layer
// for qwen2-1.5b at B = 8, S = 1024; its inputs and outputs are tens of MB.
// This first version keeps every product on the CUDA cores in f32 (bf16
// inputs widened), so it runs far from the tensor cores' rate: making it
// fast (`mma.sync` or `wgmma` for bf16) is later work.
//
// Design, three launches, no atomics (the result depends only on shapes):
//  * `bwd_delta`: delta = rowsum(dO * O) in f32, one warp a row;
//  * `bwd_dkdv`: one block of 128 threads per (key tile, KV head, batch),
//    the heaviest tiles (the first keys, which every causal query sees)
//    first; K and V of the tile stay in shared memory while the block walks
//    the G query heads and, for each, the query tiles that can see the
//    tile; per query tile it forms S, P, dP and dS in shared memory and
//    adds P~^T dO and dS^T Q into dV and dK held in registers (each thread
//    a key row's strided columns);
//  * `bwd_dq`: one block per (query tile, head, batch), heaviest (last)
//    query tiles first: Q, dO, lse and delta stay in shared memory while
//    the block walks the key tiles its rows see, forming S, P, dP and dS
//    again and adding dS K into dQ held in registers.
// Tiles: 16 queries by 32 keys (16 keys at hd 256, for registers); rows in
// shared memory are padded by one float, so a warp reading one column of
// several rows hits distinct banks.  Every input is read through its
// strides; rows past Sq or Sk are zero and masked.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 16;                       // query rows per tile

template <int HD>
struct BwdPlan {
  static constexpr int kBK = HD > 128 ? 16 : 32;          // keys per tile
  static constexpr int kLd = HD + 1;                       // padded row, floats
  static constexpr int kPd = kBK + 1;                      // padded row of sP / sdS
  static constexpr int kScores = kBQ * kBK / kThreads;     // S entries per thread
  static constexpr int kKTpr = kThreads / kBK;             // dK/dV: threads per key row
  static constexpr int kKCols = (HD + kKTpr - 1) / kKTpr;  // dK/dV columns per thread
  static constexpr int kQTpr = kThreads / kBQ;             // dQ: threads per query row
  static constexpr int kQCols = (HD + kQTpr - 1) / kQTpr;  // dQ columns per thread
  // sK, sV (kBK rows), sQ, sdO (kBQ rows), sP, sdS (kBQ x kBK), lse, delta (kBQ)
  static constexpr int kSmem = (2 * kBK * kLd + 2 * kBQ * kLd + 2 * kBQ * kPd + 2 * kBQ) * 4;
  static_assert(kBQ * kBK % kThreads == 0 && kSmem <= 232448, "tile plan");
};

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device, the opt-in attribute set once per device (`ready`).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&ready)[64]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && ready[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) ready[dev] = true;
  return err;
}

// Rows [r0, r0 + R) of one (S, HD) matrix into a padded f32 tile, zeros past `rows`.
template <typename T, int HD, int R>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long rs, int r0,
                                          int rows) {
  for (int i = threadIdx.x; i < R * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    dst[r * (HD + 1) + c] = r0 + r < rows ? to_f32(src[(r0 + r) * rs + c]) : 0.f;
  }
}

struct Shapes {
  int G, Sq, Sk;
  int causal;
  float scale;
};

// One (query tile, key tile) pair: P into sP (rounded to T), dS into sdS.
// Entry (i, j) of the 16 x BK tile is thread tid's for j = tid % BK and
// i = tid / BK + (128 / BK) e, e < kScores.
template <typename T, int HD>
__device__ __forceinline__ void scores(const float* sQ, const float* sdO, const float* sK,
                                       const float* sV, const float* sLse, const float* sDelta,
                                       float* sP, float* sdS, int q0, int k0, const Shapes& sh) {
  using Plan = BwdPlan<HD>;
  constexpr int BK = Plan::kBK, LD = Plan::kLd, NS = Plan::kScores;
  const int j = threadIdx.x % BK, i0 = threadIdx.x / BK;
  float s[NS], dp[NS];
#pragma unroll
  for (int e = 0; e < NS; ++e) s[e] = dp[e] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float kd = sK[j * LD + d], vd = sV[j * LD + d];
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const int i = i0 + (kThreads / BK) * e;
      s[e] += sQ[i * LD + d] * kd;
      dp[e] += sdO[i * LD + d] * vd;
    }
  }
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    const int i = i0 + (kThreads / BK) * e;
    const int qpos = q0 + i, kpos = k0 + j;
    const bool valid = qpos < sh.Sq && kpos < sh.Sk && (!sh.causal || kpos <= qpos);
    const float p = valid ? expf(s[e] * sh.scale - sLse[i]) : 0.f;
    sP[i * Plan::kPd + j] = to_f32(from_f32<T>(p));  // the forward's p.astype(v.dtype)
    sdS[i * Plan::kPd + j] = p * (dp[e] - sDelta[i]);
  }
}

// delta[b, h, i] = sum_d dO[b, h, i, d] * O[b, h, i, d]: one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
          int H, int Sq, int hd, Strides os, Strides ds) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= Sq) return;
  const T* orow = o + b * os.b + h * os.h + row * os.s;
  const T* drow = dout + b * ds.b + h * ds.h + row * ds.s;
  float t = 0.f;
  for (int c = lane; c < hd; c += 32) t += to_f32(orow[c]) * to_f32(drow[c]);
  t = warp_sum(t);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * Sq + row] = t;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
         Shapes sh, Strides qs, Strides ks, Strides vs, Strides ds, Strides dks, Strides dvs) {
  using Plan = BwdPlan<HD>;
  constexpr int BK = Plan::kBK, LD = Plan::kLd, TPR = Plan::kKTpr, NC = Plan::kKCols;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sdO = sQ + kBQ * LD;
  float* sP = sdO + kBQ * LD;
  float* sdS = sP + kBQ * Plan::kPd;
  float* sLse = sdS + kBQ * Plan::kPd;
  float* sDelta = sLse + kBQ;

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  load_rows<T, HD, BK>(sK, k + b * ks.b + kvh * ks.h, ks.s, k0, sh.Sk);
  load_rows<T, HD, BK>(sV, v + b * vs.b + kvh * vs.h, vs.s, k0, sh.Sk);
  const int jr = threadIdx.x / TPR, c0 = threadIdx.x % TPR;   // this thread's key row, column
  float acc_k[NC], acc_v[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc_k[c] = acc_v[c] = 0.f;

  // top-left causal: query rows below k0 see none of these keys
  const int qstart = sh.causal ? k0 / kBQ * kBQ : 0;
  for (int g = 0; g < sh.G; ++g) {
    const int h = kvh * sh.G + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * ds.b + h * ds.h;
    const long long lrow = (static_cast<long long>(b) * H + h) * sh.Sq;
    for (int q0 = qstart; q0 < sh.Sq; q0 += kBQ) {
      __syncthreads();                        // the previous tile is consumed
      load_rows<T, HD, kBQ>(sQ, qb, qs.s, q0, sh.Sq);
      load_rows<T, HD, kBQ>(sdO, db, ds.s, q0, sh.Sq);
      if (threadIdx.x < kBQ) {
        const bool ok = q0 + threadIdx.x < sh.Sq;
        sLse[threadIdx.x] = ok ? lse[lrow + q0 + threadIdx.x] : 0.f;
        sDelta[threadIdx.x] = ok ? delta[lrow + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      scores<T, HD>(sQ, sdO, sK, sV, sLse, sDelta, sP, sdS, q0, k0, sh);
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < kBQ; ++i) {
        const float p = sP[i * Plan::kPd + jr], dsv = sdS[i * Plan::kPd + jr];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = c0 + TPR * c;
          if (HD % TPR == 0 || col < HD) {
            acc_v[c] += p * sdO[i * LD + col];
            acc_k[c] += dsv * sQ[i * LD + col];
          }
        }
      }
    }
  }
  const int kpos = k0 + jr;
  if (kpos >= sh.Sk) return;
  T* dkrow = dk + b * dks.b + kvh * dks.h + kpos * dks.s;
  T* dvrow = dv + b * dvs.b + kvh * dvs.h + kpos * dvs.s;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = c0 + TPR * c;
    if (HD % TPR == 0 || col < HD) {
      dkrow[col] = from_f32<T>(acc_k[c] * sh.scale);
      dvrow[col] = from_f32<T>(acc_v[c]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, T* __restrict__ dq, int H, Shapes sh, Strides qs,
       Strides ks, Strides vs, Strides ds, Strides dqs) {
  using Plan = BwdPlan<HD>;
  constexpr int BK = Plan::kBK, LD = Plan::kLd, TPR = Plan::kQTpr, NC = Plan::kQCols;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sdO = sQ + kBQ * LD;
  float* sP = sdO + kBQ * LD;
  float* sdS = sP + kBQ * Plan::kPd;
  float* sLse = sdS + kBQ * Plan::kPd;
  float* sDelta = sLse + kBQ;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / sh.G;
  const long long lrow = (static_cast<long long>(b) * H + h) * sh.Sq;
  load_rows<T, HD, kBQ>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sh.Sq);
  load_rows<T, HD, kBQ>(sdO, dout + b * ds.b + h * ds.h, ds.s, q0, sh.Sq);
  if (threadIdx.x < kBQ) {
    const bool ok = q0 + threadIdx.x < sh.Sq;
    sLse[threadIdx.x] = ok ? lse[lrow + q0 + threadIdx.x] : 0.f;
    sDelta[threadIdx.x] = ok ? delta[lrow + q0 + threadIdx.x] : 0.f;
  }
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  const int ir = threadIdx.x / TPR, c0 = threadIdx.x % TPR;   // this thread's query row, column
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;

  // top-left causal: the tile's last row sees keys up to itself
  const int kend = sh.causal ? min(sh.Sk, q0 + kBQ) : sh.Sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                          // Q/dO loaded, or the previous tile consumed
    load_rows<T, HD, BK>(sK, kb, ks.s, k0, sh.Sk);
    load_rows<T, HD, BK>(sV, vb, vs.s, k0, sh.Sk);
    __syncthreads();
    scores<T, HD>(sQ, sdO, sK, sV, sLse, sDelta, sP, sdS, q0, k0, sh);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float dsv = sdS[ir * Plan::kPd + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = c0 + TPR * c;
        if (HD % TPR == 0 || col < HD) acc[c] += dsv * sK[j * LD + col];
      }
    }
  }
  const int qpos = q0 + ir;
  if (qpos >= sh.Sq) return;
  T* dqrow = dq + b * dqs.b + h * dqs.h + qpos * dqs.s;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = c0 + TPR * c;
    if (HD % TPR == 0 || col < HD) dqrow[col] = from_f32<T>(acc[c] * sh.scale);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, H, KV, hd;
  Shapes sh;
  Strides qs, ks, vs, os, ds, dqs, dks, dvs;
};

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t st) {
  using Plan = BwdPlan<HD>;
  static bool ready_kv[64] = {}, ready_q[64] = {};
  cudaError_t err = allow_smem(bwd_dkdv<T, HD>, Plan::kSmem, ready_kv);
  if (err == cudaSuccess) err = allow_smem(bwd_dq<T, HD>, Plan::kSmem, ready_q);
  if (err != cudaSuccess) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  bwd_delta<T><<<dim3((a.sh.Sq + 3) / 4, a.H, a.B), kThreads, 0, st>>>(
      static_cast<const T*>(a.o), dout, a.delta, a.H, a.sh.Sq, HD, a.os, a.ds);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dkdv<T, HD><<<dim3((a.sh.Sk + Plan::kBK - 1) / Plan::kBK, a.KV, a.B), kThreads,
                    Plan::kSmem, st>>>(q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
                                       static_cast<T*>(a.dv), a.H, a.sh, a.qs, a.ks, a.vs, a.ds,
                                       a.dks, a.dvs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dq<T, HD><<<dim3((a.sh.Sq + kBQ - 1) / kBQ, a.H, a.B), kThreads, Plan::kSmem, st>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.H, a.sh, a.qs, a.ks, a.vs, a.ds,
      a.dqs);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, cudaStream_t st) {
  switch (a.hd) {
    case 64: return static_cast<int>(launch<T, 64>(a, st));
    case 80: return static_cast<int>(launch<T, 80>(a, st));
    case 128: return static_cast<int>(launch<T, 128>(a, st));
    case 256: return static_cast<int>(launch<T, 256>(a, st));
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout, dq (B, H, Sq, hd); k, v,
// dk, dv (B, KV, Sk, hd), each through its (b, h, s) strides in elements
// with the head dim contiguous; lse (B, H, Sq) f32 from the forward;
// delta (B, H, Sq) f32 scratch.  Three launches.  Returns 0, a cudaError_t,
// or -1 for arguments outside what it takes (hd not 64/80/128/256).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype, int B, int H,
    int KV, int Sq, int Sk, int hd, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, long long dsb, long long dsh, long long dss,
    long long dqsb, long long dqsh, long long dqss, long long dksb, long long dksh,
    long long dkss, long long dvsb, long long dvsh, long long dvss, int causal, float scale,
    void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || B > 65535 || H > 65535 ||
      (dtype != 0 && dtype != 1))
    return -1;
  Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KV, hd,
         Shapes{H / KV, Sq, Sk, causal, scale},
         Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss}, Strides{vsb, vsh, vss},
         Strides{osb, osh, oss}, Strides{dsb, dsh, dss}, Strides{dqsb, dqsh, dqss},
         Strides{dksb, dksh, dkss}, Strides{dvsb, dvsh, dvss}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(a, st) : dispatch<__nv_bfloat16>(a, st);
}
