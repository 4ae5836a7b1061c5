// Backward of the GQA flash attention (csrc/flash_attention.cu) for Hopper
// (sm_90a): FlashAttention-2's backward, on the tensor cores for bf16.
//
// No TPU kernel has a backward: the reference trains through XLA attention,
// and `flash_attention_kernel` (src/repro/kernels/flash_attention/kernel.py)
// is forward only.  This is the gradient of that function, with its
// top-left causal mask (query i sees keys 0..i whatever Sq and Sk are) and
// its rounding of p to v's type before P.V:
//   P = exp(scale * Q.K^T - lse)      (lse from the forward, per row)
//   dV = P~^T dO                      (P~: P rounded to the input type)
//   dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O)
//   dQ = scale dS K,  dK = scale dS^T Q
// with dK and dV of a KV head summed over its G query heads.  Sums are f32;
// the gradients leave in the input type.
//
// What bounds it on the H100: operations.  A causal call is 5 products of
// the forward's size (S, dP, dV, dK, dQ): 64.5 GFLOP at qwen2-1.5b's
// training shape (B 8, S 1024, 12 heads over 2, hd 128), 0.065 ms at the
// bf16 tensor cores' 989 TFLOP/s, against about 0.2 GB of inputs and
// outputs (0.06 ms).  So the products have to run on the tensor cores, fed
// from shared memory without stalls; the CUDA-core first version of this
// file formed them as f32 dot loops over padded shared memory, loaded its
// tiles by scalar loops between barriers, and took 11 ms there.
//
// Design, bf16 at head dims 64, 80 and 128 (`mma.sync` m16n8k16 and the
// other primitives of mma.cuh that the forward uses).  Three launches, and
// no block adds into memory another block writes, so a call's result
// depends only on its shapes:
//  * `bwd_delta_vec`: delta = rowsum(dO * O) in f32, 16-byte loads, half a
//    warp a row;
//  * `bwd_dkdv_mma`: one block of 4 warps per (64-key tile, KV head,
//    batch); each warp owns 16 key rows.  K and V of the tile are copied
//    once with `cp.async` into XOR-swizzled shared memory; the block walks
//    the G query heads and, for each, the 64-query tiles from the diagonal
//    on, whose Q, dO, lse and delta come through a 2-stage `cp.async` ring
//    (the next tile loads while this one is multiplied).  Per query tile,
//    in passes of 32 query columns (64 at hd 64): S^T = K.Q^T (K the A
//    operand, Q through `ldmatrix`); P^T = 2^(S^T scale log2(e) - lse
//    log2(e)) with `ex2`; dV += P~^T.dO, P^T's accumulator fragments
//    packed to bf16 in registers as the A operand (dO through
//    `ldmatrix.trans`); dP^T = V.dO^T; dS^T = P^T (dP^T - delta) from the
//    f32 P; dK += dS^T.Q (Q through `ldmatrix.trans`).  The GQA sum stays
//    in the block's registers, so dK and dV leave once, scaled, in bf16;
//  * `bwd_dq_mma`: one block of 4 warps per (64-query tile, head, batch),
//    the last (heaviest) tiles first; each warp owns 16 query rows.  Q and
//    dO stay in shared memory (their fragments are read at each k-step:
//    registers hold dQ's 64 accumulators and S and dP), K and V tiles come
//    through a 2-stage `cp.async` ring; per key tile S = Q.K^T, P, dP =
//    dO.V^T, dS = P (dP - delta), dQ += dS~.K (dS rounded to bf16, K
//    through `ldmatrix.trans`).  This pass forms S and dP again: 7
//    products where FlashAttention-2 does 5.  That is the price of a
//    result that depends only on the shapes: summing dQ over the key tiles
//    inside the dK/dV blocks would take adds from many blocks into one f32
//    buffer at once, whose order, and so whose bits, change from run to
//    run (or a key tiles x Sq x hd f32 buffer).  The bound stays 5
//    products.
//  * Rounding: dQ takes dS rounded to bf16, as the library's backward does
//    (each dQ row sums its P-weighted terms, whose weights add to 1).  dK
//    sums G Sq terms of dS^T Q a key, unweighted, and with a once-rounded
//    dS missed the 2e-2 bf16 bound there (at Sq 384, Sk 15, G 8 on an
//    H100): so dK's product takes dS as two bf16 terms, dS~ and the
//    rounded remainder dS - dS~, two `mma.sync` on the same Q fragments
//    (about 16 bits of dS).
//  * Registers: dK's and dV's accumulators are hd / 2 f32 a lane each (128
//    at hd 128), so a pass takes 32 query columns there (S^T and dP^T 16
//    registers each), the passes stay a loop (unrolled, the dK/dV kernel
//    ran slower on an H100),
//    and K's and V's A fragments are read from shared memory at each
//    k-step, not held.  ptxas puts `bwd_dkdv_mma<128>` at 255 registers
//    with a 32-byte spill; the others spill nothing.
//  * Balance: under the causal mask key tile 0 walks every query tile and
//    the last tile one, and at qwen2-1.5b's shape all 256 dK/dV blocks are
//    resident at once (two a SM).  The blocks are ranked heaviest first and
//    dealt in waves of one a SM, every other wave reversed, so an SM whose
//    first block is heavy takes a light one next (on an H100 at that
//    shape the heaviest-first order alone was slower).
//  * The element mask is applied only on a tile that straddles the causal
//    diagonal or the Sq / Sk edge; rows past Sq or Sk are zero-filled by
//    the copy (source size 0), so nothing is padded.  Every tensor is read
//    through its strides (16-byte aligned, checked by the wrapper), so the
//    model's (B, S, H, hd) layout needs no transpose.  At hd 80 the tiles
//    are laid out in rows of 128 columns, as the forward's, so the swizzle
//    stays in the row.  Shared memory: 6 tiles of 64 rows, 96 KB at hd 80
//    and 128, 48 KB at hd 64 (two blocks a SM).
//
// Head dim 256 in bf16, and f32 at every head dim, keep the CUDA-core
// kernels (`bwd_delta`, `bwd_dkdv`, `bwd_dq`): at hd 256 the dK and dV
// accumulators alone would be 256 f32 a lane, so that plan would have to
// split their columns over warp groups and form S and dP twice more; no
// training path runs hd 256.  f32 follows the forward's rule: on the tensor
// cores an f32 product is TF32 and would miss the 3e-5 f32 bound, and f32
// is the parity path only.  Those kernels: one block of 128 threads per
// (key tile, KV head, batch) or (query tile, head, batch), tiles of 16
// queries by 32 keys (16 at hd 256), S, P, dP and dS formed in padded f32
// shared memory and the products as per-thread column sums; dS stays f32.
#include "common.cuh"
#include "mma.cuh"

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

// ---- bf16 at hd 64, 80, 128: tensor cores (mma.sync), cp.async rings ------

constexpr int kMmaThreads = 128;              // 4 warps, 16 rows of a 64-row tile each
constexpr int kTile = 64;                     // rows of a query or key tile
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// A tile row holds kPitch elements: HD, or at a head dim of a chunk count
// that is not a power of two (80: 10 chunks) the next power of two of
// chunks, so the swizzle stays in the row (the forward's MmaPlan).  Both
// kernels keep 6 tiles: dK/dV K, V and 2 stages of (Q, dO), with 2 stages
// of 64 lse and 64 delta after them; dQ Q, dO and 2 stages of (K, V).
template <int HD>
struct MmaPlan {
  static_assert(HD % 16 == 0 && HD <= 128, "whole k-steps; dK and dV fit a lane's registers");
  static constexpr int kPitch = 8 * pow2_at_least(HD / 8);
  static constexpr int kRB = kPitch * 2;                 // bytes a tile row
  static constexpr int kTB = kTile * kRB;                // bytes a tile
  static constexpr int kSmem = 6 * kTB + 2 * 2 * kTile * 4;
  static constexpr int kQN = HD > 64 ? 32 : kTile;       // dK/dV: query columns a pass
  static_assert(kTile % kQN == 0 && kQN % 16 == 0 && kSmem <= 232448, "tile plan");
};

// 4 bytes global -> shared; with `pred` false nothing is read and the 4
// shared bytes are zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

// Rows [r0, r0 + 64) of one (S, HD) bf16 matrix (row stride `rs` elements)
// into a swizzled tile at `dst`, by the block's 128 threads; rows >= `rows`
// zero-filled.  Only the HD / 8 real chunks of a row are copied.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, long long rs,
                                          int r0, int rows, int tid) {
  constexpr int CH = HD / 8, N = kTile * CH;
  static_assert(N % kMmaThreads == 0, "whole copy rounds");
#pragma unroll
  for (int it = 0; it < N / kMmaThreads; ++it) {
    const int i = tid + it * kMmaThreads, r = i / CH, c = i % CH;
    const bool ok = r0 + r < rows;
    cp_async16(dst + swz(r, c, MmaPlan<HD>::kRB), ok ? src + (r0 + r) * rs + c * 8 : src, ok);
  }
}

// The A fragment of rows r..r+15, k-step ks of a swizzled tile (row major).
template <int RB>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], uint32_t tile, int r, int ks, int lane) {
  ldmatrix_x4(a, tile + swz(r + (lane & 15), 2 * ks + (lane >> 4), RB));
}
// B fragments of two n-tiles (rows n..n+15 of the tile are the n index),
// k-step ks: b[0], b[1] for rows n..n+7, b[2], b[3] for n+8..n+15.
template <int RB>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], uint32_t tile, int n, int ks, int lane) {
  ldmatrix_x4(b, tile + swz(n + (lane & 7) + ((lane >> 4) << 3), 2 * ks + ((lane >> 3) & 1), RB));
}
// B fragments of two n-tiles of 8 columns (chunks 2 c2, 2 c2 + 1) where the
// tile's rows kr..kr+15 are the k index (`ldmatrix.trans`).
template <int RB>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], uint32_t tile, int kr, int c2,
                                        int lane) {
  ldmatrix_x4_trans(b, tile + swz(kr + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * c2 + (lane >> 4),
                                  RB));
}
// Accumulator fragments of n-tiles 2 kc and 2 kc + 1 (16 columns), rounded
// to bf16: the A fragment of k-step kc of the next product.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}
// The same fragments as two bf16 terms, a ~= big + small: big rounded to
// bf16, small the remainder rounded, so big + small keeps about 16 bits.
__device__ __forceinline__ void split_a(uint32_t (&big)[4], uint32_t (&small)[4],
                                        const float (&lo)[4], const float (&hi)[4]) {
  pack_a(big, lo, hi);
  const float* src[2] = {lo, hi};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* f = src[i >> 1] + 2 * (i & 1);
    small[i] = pack_bf16(f[0] - __uint_as_float(big[i] << 16),
                         f[1] - __uint_as_float(big[i] & 0xffff0000u));
  }
}

// delta[b, h, i] = sum_d dO[b, h, i, d] * O[b, h, i, d]: half a warp a row,
// one 16-byte chunk a lane.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
bwd_delta_vec(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
              float* __restrict__ delta, int H, int Sq, Strides os, Strides ds) {
  static_assert(HD / 8 <= 16, "a row's chunks in half a warp");
  const int row = blockIdx.x * (kMmaThreads / 16) + (threadIdx.x >> 4), c = threadIdx.x & 15;
  const int h = blockIdx.y, b = blockIdx.z;
  float t = 0.f;
  if (row < Sq && c < HD / 8) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * os.b + h * os.h + row * os.s + 8 * c);
    const uint4 dv =
        *reinterpret_cast<const uint4*>(dout + b * ds.b + h * ds.h + row * ds.s + 8 * c);
    const unsigned ow[4] = {ov.x, ov.y, ov.z, ov.w}, dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)    // a bf16's bits are the top half of its f32
      t += __uint_as_float(ow[j] << 16) * __uint_as_float(dw[j] << 16) +
           __uint_as_float(ow[j] & 0xffff0000u) * __uint_as_float(dw[j] & 0xffff0000u);
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  if (row < Sq && c == 0) delta[(static_cast<long long>(b) * H + h) * Sq + row] = t;
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 2)
bwd_dkdv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, Shapes sh,
             Strides qs, Strides ks, Strides vs, Strides ds, Strides dks, Strides dvs,
             int B, int sms) {
  using Plan = MmaPlan<HD>;
  constexpr int RB = Plan::kRB, TB = Plan::kTB, KS = HD / 16, NO = HD / 8;
  constexpr int QN = Plan::kQN, NQ = QN / 8;
  extern __shared__ __align__(128) unsigned char tiles[];
  // K | V | stage 0: Q dO | stage 1: Q dO | lse, delta of stage 0 | of stage 1
  const uint32_t sK = smem_u32(tiles), sV = sK + TB;
  float* const sRow = reinterpret_cast<float*>(tiles + 6 * TB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  // The blocks in order of work, heaviest (key tile 0) first, dealt in
  // waves of `sms`, one a SM: every other wave runs the other way, so an SM
  // whose first block is heavy takes a light one next (all of them are
  // resident at once when there are at most two a SM).
  const int nblk = static_cast<int>(gridDim.x), L = static_cast<int>(blockIdx.x);
  const int wave = L / sms, in_wave = min(sms, nblk - wave * sms);
  const int rank = wave * sms + (wave & 1 ? in_wave - 1 - L % sms : L % sms);
  const int KV = H / sh.G;                    // rank: key tile, then batch, then KV head
  const int k0 = rank / (KV * B) * kTile, kvh = rank % KV, b = rank / KV % B;
  const int kr = 16 * warp;                   // the warp's first key row in the tile
  const float sl2 = sh.scale * kLog2e;
  // top-left causal: query rows below k0 see none of these keys
  const int qstart = sh.causal ? k0 : 0;
  const int nq = qstart < sh.Sq ? (sh.Sq - qstart + kTile - 1) / kTile : 0;
  const int n = sh.G * nq;                    // (head, query tile) steps

  load_tile<HD>(sK, k + b * ks.b + kvh * ks.h, ks.s, k0, sh.Sk, tid);
  load_tile<HD>(sV, v + b * vs.b + kvh * vs.h, vs.s, k0, sh.Sk, tid);
  cp_async_commit();
  // step i's Q, dO, lse and delta into stage st (threads 0-63 copy lse, 64-127 delta)
  auto fetch = [&](int i, int st) {
    const int h = kvh * sh.G + i / nq, q0 = qstart + (i % nq) * kTile;
    const uint32_t sQ = sK + (2 + 2 * st) * TB;
    load_tile<HD>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sh.Sq, tid);
    load_tile<HD>(sQ + TB, dout + b * ds.b + h * ds.h, ds.s, q0, sh.Sq, tid);
    const int r = tid & (kTile - 1);
    const bool ok = q0 + r < sh.Sq;
    const long long row = (static_cast<long long>(b) * H + h) * sh.Sq + (ok ? q0 + r : 0);
    cp_async4(smem_u32(sRow + (2 * st + (tid >> 6)) * kTile + r), (tid < kTile ? lse : delta) + row,
              ok);
  };
  if (n > 0) fetch(0, 0);
  cp_async_commit();                          // possibly empty: keeps the group count

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    if (i + 1 < n) {                          // the next step into the other stage
      fetch(i + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qstart + (i % nq) * kTile;
    const uint32_t sQ = sK + (2 + 2 * st) * TB, sdO = sQ + TB;
    const float* sL = sRow + 2 * st * kTile;
    const float* sD = sL + kTile;
    // mask only where a key of this warp may follow a query, or rows pass Sq
    const bool edge = (sh.causal && k0 + kr + 15 > q0) || q0 + kTile > sh.Sq;
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += QN) {
      // S^T = K.Q^T: the warp's 16 keys x QN queries
      float s[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        frag_a<RB>(a, sK, kr, kk, lane);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bq[4];
          frag_b<RB>(bq, sQ, c0 + 16 * np, kk, lane);
          mma_bf16_16816(s[2 * np], a, bq[0], bq[1]);
          mma_bf16_16816(s[2 * np + 1], a, bq[2], bq[3]);
        }
      }
      // P^T = 2^(S^T scale log2(e) - lse log2(e)); entry (key g + 8 (e / 2),
      // query 8 j + 2 t + e % 2)
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int col = c0 + 8 * j + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(sL + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[j][e], sl2, -((e & 1) ? l.y : l.x) * kLog2e));
          if (edge) {
            const int qp = q0 + col + (e & 1), kp = k0 + kr + g + 8 * (e >> 1);
            if (qp >= sh.Sq || (sh.causal && kp > qp)) p = 0.f;
          }
          s[j][e] = p;
        }
      }
      // dV += P~^T.dO
#pragma unroll
      for (int kc = 0; kc < QN / 16; ++kc) {
        uint32_t pa[4];
        pack_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
        for (int c2 = 0; c2 < HD / 16; ++c2) {
          uint32_t bo[4];
          frag_bt<RB>(bo, sdO, c0 + 16 * kc, c2, lane);
          mma_bf16_16816(dva[2 * c2], pa, bo[0], bo[1]);
          mma_bf16_16816(dva[2 * c2 + 1], pa, bo[2], bo[3]);
        }
      }
      // dP^T = V.dO^T
      float dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        frag_a<RB>(a, sV, kr, kk, lane);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bo[4];
          frag_b<RB>(bo, sdO, c0 + 16 * np, kk, lane);
          mma_bf16_16816(dp[2 * np], a, bo[0], bo[1]);
          mma_bf16_16816(dp[2 * np + 1], a, bo[2], bo[3]);
        }
      }
      // dS^T = P^T (dP^T - delta), P in f32
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(sD + c0 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - ((e & 1) ? d.y : d.x));
      }
      // dK += dS^T.Q, dS^T as two bf16 terms (dK sums G Sq of them)
#pragma unroll
      for (int kc = 0; kc < QN / 16; ++kc) {
        uint32_t da[4], dl[4];
        split_a(da, dl, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
        for (int c2 = 0; c2 < HD / 16; ++c2) {
          uint32_t bq[4];
          frag_bt<RB>(bq, sQ, c0 + 16 * kc, c2, lane);
          mma_bf16_16816(dka[2 * c2], da, bq[0], bq[1]);
          mma_bf16_16816(dka[2 * c2 + 1], da, bq[2], bq[3]);
          mma_bf16_16816(dka[2 * c2], dl, bq[0], bq[1]);
          mma_bf16_16816(dka[2 * c2 + 1], dl, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();                          // this stage is refilled two steps on
  }
  cp_async_wait<0>();                         // with no step, K and V were still in flight

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = k0 + kr + g + 8 * r;
    if (kp >= sh.Sk) continue;
    __nv_bfloat16* krow = dk + b * dks.b + kvh * dks.h + kp * dks.s + 2 * t;
    __nv_bfloat16* vrow = dv + b * dvs.b + kvh * dvs.h + kp * dvs.s + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j) =
          __floats2bfloat162_rn(dka[j][2 * r] * sh.scale, dka[j][2 * r + 1] * sh.scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j) =
          __floats2bfloat162_rn(dva[j][2 * r], dva[j][2 * r + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 2)
bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dq, int H, Shapes sh, Strides qs, Strides ks, Strides vs,
           Strides ds, Strides dqs) {
  using Plan = MmaPlan<HD>;
  constexpr int RB = Plan::kRB, TB = Plan::kTB, KS = HD / 16, NO = HD / 8;
  extern __shared__ __align__(128) unsigned char tiles[];
  // Q | dO | stage 0: K V | stage 1: K V
  const uint32_t sQ = smem_u32(tiles), sdO = sQ + TB;
  auto sK = [&](int st) { return sQ + (2 + 2 * st) * TB; };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / sh.G;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;   // heaviest tiles first
  const int qr = 16 * warp, row0 = q0 + qr + g;   // this lane's rows: row0, row0 + 8
  const float sl2 = sh.scale * kLog2e;
  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;

  load_tile<HD>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sh.Sq, tid);
  load_tile<HD>(sdO, dout + b * ds.b + h * ds.h, ds.s, q0, sh.Sq, tid);
  cp_async_commit();
  // top-left causal: the tile's last row sees keys up to itself
  const int kend = sh.causal ? min(sh.Sk, q0 + kTile) : sh.Sk;
  const int nk = (kend + kTile - 1) / kTile;    // >= 1
  load_tile<HD>(sK(0), kb, ks.s, 0, sh.Sk, tid);
  load_tile<HD>(sK(0) + TB, vb, vs.s, 0, sh.Sk, tid);
  cp_async_commit();
  float l2[2], dl[2];
  const long long lrow = (static_cast<long long>(b) * H + h) * sh.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row0 + 8 * r < sh.Sq;
    l2[r] = ok ? lse[lrow + row0 + 8 * r] * kLog2e : 0.f;
    dl[r] = ok ? delta[lrow + row0 + 8 * r] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int st = i & 1, k0 = i * kTile;
    if (i + 1 < nk) {                         // the next tile into the other stage
      load_tile<HD>(sK(st ^ 1), kb, ks.s, k0 + kTile, sh.Sk, tid);
      load_tile<HD>(sK(st ^ 1) + TB, vb, vs.s, k0 + kTile, sh.Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t tK = sK(st), tV = tK + TB;
    // S = Q.K^T: the warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      frag_a<RB>(a, sQ, qr, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        frag_b<RB>(bk, tK, 16 * np, kk, lane);
        mma_bf16_16816(s[2 * np], a, bk[0], bk[1]);
        mma_bf16_16816(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    // P; mask only a tile that straddles the diagonal or the Sk edge
    const bool edge = (sh.causal && k0 + kTile - 1 > q0 + qr) || k0 + kTile > sh.Sk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[j][e], sl2, -l2[e >> 1]));
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
          if (key >= sh.Sk || (sh.causal && key > row)) p = 0.f;
        }
        s[j][e] = p;
      }
    // dP = dO.V^T
    float dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      frag_a<RB>(a, sdO, qr, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bv[4];
        frag_b<RB>(bv, tV, 16 * np, kk, lane);
        mma_bf16_16816(dp[2 * np], a, bv[0], bv[1]);
        mma_bf16_16816(dp[2 * np + 1], a, bv[2], bv[3]);
      }
    }
    // dS = P (dP - delta); dQ += dS~.K
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dl[e >> 1]);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t da[4];
      pack_a(da, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int c2 = 0; c2 < HD / 16; ++c2) {
        uint32_t bk[4];
        frag_bt<RB>(bk, tK, 16 * kc, c2, lane);
        mma_bf16_16816(acc[2 * c2], da, bk[0], bk[1]);
        mma_bf16_16816(acc[2 * c2 + 1], da, bk[2], bk[3]);
      }
    }
    __syncthreads();                          // this stage is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sh.Sq) continue;
    __nv_bfloat16* qrow = dq + b * dqs.b + h * dqs.h + row * dqs.s + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * r] * sh.scale, acc[j][2 * r + 1] * sh.scale);
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

template <int HD>
cudaError_t launch_mma(const Args& a, cudaStream_t st) {
  using Plan = MmaPlan<HD>;
  static bool ready_kv[64] = {}, ready_q[64] = {};
  cudaError_t err = allow_smem(bwd_dkdv_mma<HD>, Plan::kSmem, ready_kv);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_mma<HD>, Plan::kSmem, ready_q);
  if (err != cudaSuccess) return err;
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  bwd_delta_vec<HD><<<dim3((a.sh.Sq + 7) / 8, a.H, a.B), kMmaThreads, 0, st>>>(
      static_cast<const bf16*>(a.o), dout, a.delta, a.H, a.sh.Sq, a.os, a.ds);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dq_mma<HD><<<dim3(a.H, a.B, (a.sh.Sq + kTile - 1) / kTile), kMmaThreads, Plan::kSmem,
                   st>>>(q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dq), a.H, a.sh,
                         a.qs, a.ks, a.vs, a.ds, a.dqs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  static int sms[64] = {};                    // multiprocessors, per device
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  int& n_sm = sms[dev < 64 ? dev : 63];
  if (n_sm == 0 &&
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long nblk = static_cast<long long>(a.KV) * a.B * ((a.sh.Sk + kTile - 1) / kTile);
  if (nblk > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bwd_dkdv_mma<HD><<<static_cast<unsigned>(nblk), kMmaThreads, Plan::kSmem, st>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H,
      a.sh, a.qs, a.ks, a.vs, a.ds, a.dks, a.dvs, a.B, n_sm);
  return cudaGetLastError();
}

int dispatch_f32(const Args& a, cudaStream_t st) {
  switch (a.hd) {
    case 64: return static_cast<int>(launch<float, 64>(a, st));
    case 80: return static_cast<int>(launch<float, 80>(a, st));
    case 128: return static_cast<int>(launch<float, 128>(a, st));
    case 256: return static_cast<int>(launch<float, 256>(a, st));
    default: return -1;
  }
}

int dispatch_bf16(const Args& a, cudaStream_t st) {
  switch (a.hd) {
    case 64: return static_cast<int>(launch_mma<64>(a, st));
    case 80: return static_cast<int>(launch_mma<80>(a, st));
    case 128: return static_cast<int>(launch_mma<128>(a, st));
    case 256: return static_cast<int>(launch<__nv_bfloat16, 256>(a, st));
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout, dq (B, H, Sq, hd); k, v,
// dk, dv (B, KV, Sk, hd), each through its (b, h, s) strides in elements
// with the head dim contiguous; lse (B, H, Sq) f32 from the forward;
// delta (B, H, Sq) f32 scratch.  Three launches.  For bf16 at hd 64, 80
// and 128 the pointers and the strides of q, k, v, o, dout, dq, dk and dv
// must be 16-byte aligned (the wrapper checks).
// Returns 0, a cudaError_t, or -1 for arguments outside what it takes (hd
// not 64/80/128/256, more than 65535 tiles of 64 rows).
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
      (dtype != 0 && dtype != 1) || (Sq + kTile - 1) / kTile > 65535 ||
      (Sk + kTile - 1) / kTile > 65535)
    return -1;
  Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KV, hd,
         Shapes{H / KV, Sq, Sk, causal, scale},
         Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss}, Strides{vsb, vsh, vss},
         Strides{osb, osh, oss}, Strides{dsb, dsh, dss}, Strides{dqsb, dqsh, dqss},
         Strides{dksb, dksh, dkss}, Strides{dvsb, dvsh, dvss}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch_f32(a, st) : dispatch_bf16(a, st);
}
