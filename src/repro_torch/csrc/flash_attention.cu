// Causal GQA flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` / `_kernel` in
// src/repro/kernels/flash_attention/kernel.py.  Same function: online
// softmax (m, l, acc) in f32 over key tiles, causal key tiles past the
// diagonal skipped, keys >= Sk masked, p rounded to v's dtype before P.V
// (the TPU kernel's `p.astype(v.dtype)`), and the TOP-LEFT causal
// convention of the TPU kernel (query i sees keys 0..i, whatever Sq and Sk
// are), which differs from the bottom-right convention of GPU attention
// libraries when Sq != Sk.
//
// What bounds it on the H100: at the main path's prefill shapes (one
// prompt of 16-384 tokens, 12 heads over 2 KV heads, head_dim 128) a call
// is at most 0.45 GFLOP over about 2.8 MB, so the least time is set by the
// bytes (0.8 us) and the tensor cores could do the products in 0.5 us
// (gemma-2b, 8 heads over 1 KV head at head_dim 256: 0.6 GFLOP over 1.8 MB).
// What binds in practice is each block's serial walk over its key tiles
// (load, two products, the softmax), the K/V tiles every block re-reads
// from L2 (each query tile and each head reads its own copy), and the
// issue rate of one or two warps per scheduler.
//
// Design, bf16 (the served type), FlashAttention-2 on `mma.sync`:
//  * one block of 8 warps per (64-query tile, head, batch), the heaviest
//    (last) query tiles first; each warp owns 16 query rows, and the
//    Pallas grid's sequential K axis becomes a loop inside the block;
//  * at head_dim <= 128 the warps form two sets of 4 that take every
//    other 64-key tile, so each warp's serial chain is half the tiles; the
//    two softmax states of each row merge once, at the end, through shared
//    memory;
//  * the Q tile is copied once with 16-byte `cp.async` and moved with
//    `ldmatrix` into A fragments that stay in registers for the key loop;
//  * at head_dim 256 that plan needs 288 KB of shared memory (above the
//    227 KB a block may have) and 16 x 256 f32 of O per warp, 128
//    registers a lane on top of Q's 64: so one set walks every key tile
//    (Q + 2 stages x (K + V) = 160 KB), the two groups of 4 warps split
//    the O columns of the same query rows (each computes the rows' whole
//    S = Q.K^T and the same softmax, bit for bit, and multiplies P by its
//    half of V), and Q's fragments are read from shared memory at each
//    k-step instead of held in registers;
//  * each set streams its K and V tiles through its own 2-stage
//    `cp.async` ring, so its next tile loads while this one is multiplied;
//    rows past Sq / Sk are zero-filled by the copy (source size 0), so
//    nothing is padded;
//  * shared memory rows are XOR-swizzled in 16-byte chunks (mma.cuh), so
//    `ldmatrix` (K) and `ldmatrix.trans` (V) are free of bank conflicts;
//    Q + 2 sets x 2 stages x (K + V) is 144 KB at hd 128, dynamic shared
//    memory, one block per SM (see MmaPlan);
//  * S = Q.K^T and O += P.V are `mma.sync` m16n8k16 bf16 -> f32; the
//    online softmax runs on the accumulator fragments (row max and sum
//    over the 4 lanes of a quad, `ex2.approx` with scale*log2(e) folded
//    into one FMA, -inf for a masked key), and P is rounded to bf16 in
//    registers to become the A operand of P.V;
//  * a head dim whose rows are not a power-of-two count of 16-byte chunks
//    (80: zamba2-2.7b, 10 chunks) lays its tiles out in rows of the next
//    power of two (128 columns, 256 bytes), so the swizzle, whose XOR
//    reaches chunk 15, stays inside the row; only the real chunks are
//    copied, and no instruction reads the spare ones; hd 80 takes the
//    two-set plan with Q in registers (5 k-steps, 10 n-tiles of O) and the
//    hd-128 plan's 144 KB of shared memory;
//  * the element mask is applied only on a tile that straddles the
//    diagonal or the Sk edge; q/k/v/o are read and written through their
//    strides (16-byte aligned, checked by the wrapper), so the model's
//    (B, S, H, hd) activations need no transpose.
//
// Each row's logsumexp (natural log, of the scaled scores) is stored in
// `lse` (B, H, Sq) f32 when the caller passes one: the backward kernel
// (flash_attention_bwd.cu) rebuilds the probabilities from it.  With a null
// `lse` nothing else changes: the serving path passes null.
//
// Design, f32 (parity checks only; the server runs bf16): on the tensor
// cores an f32 product is TF32 (10-bit mantissa) and would miss the 3e-5
// f32 bound, so f32 keeps a CUDA-core kernel: 16 query rows per block,
// 32-key tiles staged in shared memory as f32, lane j scoring key j, the
// P.V product reading V rows coalesced, each lane owning ceil(hd/32)
// columns (at hd 80 lanes 16-31 own two: their third is past the row and
// neither read nor written); the tiles sit in dynamic shared memory (84 KB
// at hd 256, above the 48 KB a static array may take).
#include "common.cuh"
#include "mma.cuh"

namespace {

// ---- f32: CUDA cores ------------------------------------------------------

constexpr int kBQ = 16;                       // query rows per block
constexpr int kBK = 32;                       // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;           // query rows per warp

// Dynamic shared memory of the f32 kernel: sQ[kBQ][HD], sK[kBK][HD + 1]
// (padded: lane j reads row j), sV[kBK][HD], sP[kBQ][kBK], all f32.
template <int HD>
constexpr int f32_smem() { return (kBQ * HD + kBK * (HD + 1) + kBK * HD + kBQ * kBK) * 4; }

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, float* __restrict__ lse, int G, int Sq, int Sk, Strides qs,
          Strides ks, Strides vs, Strides os, int causal, float scale) {
  constexpr int DPL = (HD + 31) / 32;         // output columns per lane; at hd 80 the
                                              // third of lanes 16-31 is past the row
  extern __shared__ __align__(128) unsigned char smem[];
  float* const base = reinterpret_cast<float*>(smem);
  auto sQ = reinterpret_cast<float (*)[HD]>(base);
  auto sK = reinterpret_cast<float (*)[HD + 1]>(base + kBQ * HD);
  auto sV = reinterpret_cast<float (*)[HD]>(base + kBQ * HD + kBK * (HD + 1));
  auto sP = reinterpret_cast<float (*)[kBK]>(base + kBQ * HD + kBK * (HD + 1) + kBK * HD);

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
      for (int i = 0; i < DPL; ++i) {
        if constexpr (HD % 32 == 0)
          vv[i] = sV[j][lane + 32 * i];
        else
          vv[i] = lane + 32 * i < HD ? sV[j][lane + 32 * i] : 0.f;
      }
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
    if (lse != nullptr && lane == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qpos] = m[r] + logf(l[r]);
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (HD % 32 == 0 || lane + 32 * i < HD)
        ob[qpos * os.s + lane + 32 * i] = from_f32<T>(acc[r][i] * inv);
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device: above 48 KB a block gets it only through the opt-in attribute,
// set once per device (`ready`, one array per kernel).
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

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int H,
                       int KV, int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                       int causal, float scale, cudaStream_t stream) {
  constexpr int kSmem = f32_smem<HD>();
  static bool ready[64] = {};
  const cudaError_t err = allow_smem(flash_fwd<float, HD>, kSmem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd<float, HD><<<grid, kWarps * 32, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H / KV, Sq, Sk, qs, ks, vs,
      os, causal, scale);
  return cudaGetLastError();
}

// ---- bf16: tensor cores (mma.sync), cp.async rings -------------------------

constexpr int kQ = 16 * kWarps;               // query rows per block, 16 per warp
constexpr int kK = 64;                        // keys per tile
constexpr int kThreads = 2 * kWarps * 32;     // two groups of 4 warps
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// What the two groups of 4 warps share out, by head dim.  hd <= 128: two
// warp sets on every other key tile, each warp with all of O's columns, Q's
// fragments in registers.  hd 256: one set on every tile, O's columns split
// over the two groups, Q's fragments read from shared memory per k-step.
// A tile row holds kPitch elements: HD, or at a head dim of a chunk count
// that is not a power of two (80: 10 chunks) the next power of two of
// chunks, so the swizzle stays in the row.
template <int HD>
struct MmaPlan {
  static_assert(HD % 16 == 0, "whole k-steps of 16 and n-tile pairs of O");
  static constexpr int kSets = HD > 128 ? 1 : 2;       // warp sets over the key tiles
  static constexpr int kCols = 3 - kSets;              // groups sharing O's columns
  static constexpr bool kQRegs = kSets == 2;
  static constexpr int kPitch = 8 * pow2_at_least(HD / 8);      // elements per tile row
  static constexpr int kSmem = (kQ + kSets * 4 * kK) * kPitch * 2;   // Q + each set's ring
  static_assert(kPitch >= 64 && kSmem <= 232448, "a block's shared memory on the H100");
};

// Copy rows [r0, r0 + R) of one (S, HD) bf16 matrix (row stride `rs`
// elements) into a swizzled tile at `dst` whose rows are `MmaPlan<HD>::
// kPitch` elements, with the NT threads of index `tid`; rows >= `rows` are
// zero-filled.  Only the HD / 8 real chunks of a row are copied.
template <int HD, int R, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, long long rs,
                                          int r0, int rows, int tid) {
  constexpr int CH = HD / 8;                  // 16-byte chunks per row
  constexpr int N = R * CH;                   // chunks per tile
  constexpr int RB = MmaPlan<HD>::kPitch * 2;
#pragma unroll
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    const int i = tid + it * NT, r = i / CH, c = i % CH;
    if (N % NT != 0 && i >= N) break;         // the last round is partial (hd 80's Q tile)
    const bool ok = r0 + r < rows;
    cp_async16(dst + swz(r, c, RB), ok ? src + (r0 + r) * rs + c * 8 : src, ok);
  }
}

// Barrier over the threads of one warp set: the 128 of the set (ids 1, 2;
// 0 is __syncthreads) with two sets, the whole block with one.
template <int SETS>
__device__ __forceinline__ void set_sync(int set) {
  if constexpr (SETS == 1)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + set), "r"(kWarps * 32) : "memory");
}

// Warp w of each group of 4 owns query rows 16 w .. 16 w + 15 of the block.
// Two sets (hd <= 128): group `set` walks key tiles set, set + 2, ... and
// the two sets' softmax states of each row merge once, at the end.  One set
// (hd 256): both groups walk every tile, group c owning O's columns
// c HD/2 .. (c + 1) HD/2 - 1.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int G, int Sq, int Sk, Strides qs, Strides ks,
              Strides vs, Strides os, int causal, float scale_log2) {
  using Plan = MmaPlan<HD>;
  constexpr int SETS = Plan::kSets;
  constexpr int RB = Plan::kPitch * 2;        // bytes per tile row
  constexpr int TB = kK * RB;                 // bytes per Q, K or V tile (kQ == kK)
  constexpr int KS = HD / 16;                 // k-steps of Q.K^T over head_dim
  constexpr int OC = HD / Plan::kCols;        // O columns per warp
  constexpr int NO = OC / 8;                  // 8-column n-tiles of O
  constexpr int LT = kThreads / SETS;         // threads loading one set's tiles
  const float kInf = __int_as_float(0x7f800000);
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & (kWarps - 1);
  const int group = tid >> 7;                 // 0 or 1
  const int set = SETS == 2 ? group : 0, stid = tid % LT;
  const int c0 = Plan::kCols == 2 ? group * OC : 0;   // this warp's first O column
  // Q | set 0: K0 K1 V0 V1 | set 1: K0 K1 V0 V1 (with two sets)
  const uint32_t sQ = smem_u32(smem), sS = sQ + TB + set * 4 * TB;
  auto sK = [&](int st) { return sS + TB * st; };
  auto sV = [&](int st) { return sS + TB * (2 + st); };

  const int g = lane >> 2, t = lane & 3;     // mma fragment coordinates
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;

  // top-left causal: the block's last row sees keys up to itself
  const int kend = causal ? min(Sk, min(Sq, q0 + kQ)) : Sk;
  const int ntiles = (kend + kK - 1) / kK;
  const int nloc = (ntiles - set + SETS - 1) / SETS;   // this set's tiles

  load_tile<HD, kQ, kThreads>(sQ, qb, qs.s, q0, Sq, tid);
  cp_async_commit();
  if (nloc > 0) {
    load_tile<HD, kK, LT>(sK(0), kb, ks.s, set * kK, Sk, stid);
    load_tile<HD, kK, LT>(sV(0), vb, vs.s, set * kK, Sk, stid);
  }
  cp_async_commit();                          // possibly empty: keeps the group count
  cp_async_wait<1>();                         // this thread's share of Q
  __syncthreads();
  // Q's A fragment of k-step ks_: held in registers, or read again each time
  auto q_frag = [&](uint32_t (&a)[4], int ks_) {
    ldmatrix_x4(a, sQ + swz(16 * warp + (lane & 15), 2 * ks_ + (lane >> 4), RB));
  };
  uint32_t qf[Plan::kQRegs ? KS : 1][4];
  if constexpr (Plan::kQRegs) {
#pragma unroll
    for (int ks_ = 0; ks_ < KS; ++ks_) q_frag(qf[ks_], ks_);
  }

  // rows g and g + 8 of the warp: m in log2 units (-inf before any key), l
  // this lane's share of the row sum
  float m[2] = {-kInf, -kInf}, l[2] = {0.f, 0.f}, acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int row0 = q0 + 16 * warp + g;

  for (int i = 0; i < nloc; ++i) {
    const int st = i & 1, k0 = (set + SETS * i) * kK;
    if (i + 1 < nloc) {                       // this set's next tile into the other stage
      load_tile<HD, kK, LT>(sK(st ^ 1), kb, ks.s, k0 + SETS * kK, Sk, stid);
      load_tile<HD, kK, LT>(sV(st ^ 1), vb, vs.s, k0 + SETS * kK, Sk, stid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    set_sync<SETS>(set);

    // S = Q.K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks_ = 0; ks_ < KS; ++ks_) {
      uint32_t qa[4];
      if constexpr (Plan::kQRegs) {
        qa[0] = qf[ks_][0];
        qa[1] = qf[ks_][1];
        qa[2] = qf[ks_][2];
        qa[3] = qf[ks_][3];
      } else {
        q_frag(qa, ks_);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, sK(st) + swz(16 * np + (lane & 7) + ((lane >> 4) << 3),
                                     2 * ks_ + ((lane >> 3) & 1), RB));
        mma_bf16_16816(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16_16816(s[2 * np + 1], qa, bk[2], bk[3]);
      }
    }
    // mask (to -inf) only a tile that straddles the diagonal or the Sk edge
    if (k0 + kK > Sk || (causal && k0 + kK - 1 > q0 + 16 * warp)) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * t + (e & 1), row = row0 + (e >> 1) * 8;
          if (key >= Sk || (causal && key > row)) s[n][e] = -kInf;
        }
    }
    // online softmax on the fragments: each row lives in one quad of lanes;
    // scores stay unscaled, and scale*log2(e) > 0 folds into one FMA
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(s[0][2 * r], s[0][2 * r + 1]);
#pragma unroll
      for (int n = 1; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[r], mx * scale_log2);
      const float mu = mn == -kInf ? 0.f : mn;   // no key yet: 2^(-inf - 0) = 0
      const float alpha = ex2(m[r] - mu);
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[n][e] = ex2(fmaf(s[n][e], scale_log2, -mu));
          sum += s[n][e];
        }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
    // O += P.V: P (16 x 64) in bf16 as the A operand, V (this warp's OC
    // columns) through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < OC / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sV(st) + swz(16 * kc + (lane & 7) + (((lane >> 3) & 1) << 3),
                                           c0 / 8 + 2 * dp + (lane >> 4), RB));
        mma_bf16_16816(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    set_sync<SETS>(set);                      // this stage is refilled two tiles on
  }

  if constexpr (SETS == 1) {                  // no second state: normalise and store
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      const float inv = 1.f / fmaxf(lr, 1e-30f);
      if (lse != nullptr && group == 0 && t == 0)   // m in log2 units of the scaled scores
        lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + row] =
            (m[r] + log2f(lr)) * kLn2;
      __nv_bfloat16* orow = ob + row * os.s + c0 + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
    return;
  }

  // set 1 hands its (m, l, acc) to the thread of set 0 that owns the same
  // rows and columns, through set 1's own (now idle) stages
  constexpr int NX = 4 + 4 * NO;              // floats per thread
  static_assert(SETS == 1 || NX * 128 * 4 <= 4 * TB, "the exchange fits in a set's stages");
  float* xch = reinterpret_cast<float*>(smem + 5 * TB) + stid;
  if (set == 1) {
    xch[0] = m[0];
    xch[128] = m[1];
    xch[2 * 128] = l[0];
    xch[3 * 128] = l[1];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[(4 + 4 * n + e) * 128] = acc[n][e];
  }
  __syncthreads();
  if (set == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mo = xch[r * 128], mn = fmaxf(m[r], mo);
    const float mu = mn == -kInf ? 0.f : mn;
    const float e0 = ex2(m[r] - mu), e1 = ex2(mo - mu);
    float lr = l[r] * e0 + xch[(2 + r) * 128] * e1;
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    if (lse != nullptr && t == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + row] = (mn + log2f(lr)) * kLn2;
    __nv_bfloat16* orow = ob + row * os.s + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float a0 = acc[n][2 * r] * e0 + xch[(4 + 4 * n + 2 * r) * 128] * e1;
      const float a1 = acc[n][2 * r + 1] * e0 + xch[(5 + 4 * n + 2 * r) * 128] * e1;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(a0 * inv, a1 * inv);
    }
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int H,
                        int KV, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                        Strides os, int causal, float scale, cudaStream_t stream) {
  constexpr int kSmem = MmaPlan<HD>::kSmem;
  static bool ready[64] = {};                 // attribute set, per device
  const cudaError_t err = allow_smem(flash_fwd_mma<HD>, kSmem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kQ - 1) / kQ, H, B);
  flash_fwd_mma<HD><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, H / KV, Sq,
      Sk, qs, ks, vs, os, causal, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse: null, or (B, H, Sq) f32 contiguous,
// each row's logsumexp of its scaled scores.  Returns 0, a cudaError_t from the
// launch, or -1 when the arguments are outside what the kernel takes.  For
// bf16 the pointers and the strides of q, k, v and o must be 16-byte
// aligned (the wrapper checks) and the scale positive; f32 reads scalars
// and takes any stride and any scale.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int dtype, int B, int H,
    int KV,
    int Sq, int Sk, int hd, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, int causal, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || B > 65535 || H > 65535 ||
      (dtype == 1 && !(scale > 0.f)))
    return -1;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && hd == 64)
    err = launch_f32<64>(q, k, v, o, lse, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, scale, st);
  else if (dtype == 0 && hd == 80)
    err = launch_f32<80>(q, k, v, o, lse, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, scale, st);
  else if (dtype == 1 && hd == 80)
    err = launch_bf16<80>(q, k, v, o, lse, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, scale, st);
  else if (dtype == 0 && hd == 128)
    err = launch_f32<128>(q, k, v, o, lse, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, scale, st);
  else if (dtype == 1 && hd == 64)
    err = launch_bf16<64>(q, k, v, o, lse, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, scale, st);
  else if (dtype == 0 && hd == 256)
    err = launch_f32<256>(q, k, v, o, lse, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, scale, st);
  else if (dtype == 1 && hd == 128)
    err = launch_bf16<128>(q, k, v, o, lse, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, scale, st);
  else if (dtype == 1 && hd == 256)
    err = launch_bf16<256>(q, k, v, o, lse, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, scale, st);
  else
    return -1;
  return static_cast<int>(err);
}
