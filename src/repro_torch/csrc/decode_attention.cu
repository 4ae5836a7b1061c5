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
// (4 slots x 2 KV heads x <= 512 positions x 128 dims, lengths 397, 250,
// 130, 17) that is 0.25 us, so what a call costs in practice is one
// dependent round trip to memory per block plus the launch.
//
// Design, and what it does about that:
//  * every load is 16 bytes a lane (8 bf16 or 4 f32): hd/8 (bf16) lanes
//    cover a cache row, so at hd 128 bf16 one warp instruction reads two
//    whole rows, and each lane issues U = 1-4 such rows of K and of V
//    before it uses any, so a block has all of its bytes in flight at once;
//    a row wider than a warp's 32 loads (f32 at hd 256: 64 chunks) gives
//    each lane C = 2 chunks of it, 128 elements apart, so every shuffle
//    stays within the warp; a row whose chunk count is not a power of two
//    (hd 80: 10 chunks in bf16, 20 in f32) takes the next power of two of
//    lanes (16, or the whole warp), and the spare lanes load nothing, hold
//    zeros (so they add 0 to each dot product) and store nothing, which
//    keeps the xor-shuffle sums and the row-slot merge on power-of-two lane
//    counts;
//  * each lane keeps its C x 8 (or 4) columns of the G query rows in
//    registers; a row's dot products are reduced over its lanes with xor
//    shuffles and scaled by scale*log2(e), the online softmax (exp2)
//    runs per row slot, and P.V reuses the same lane-to-columns map, so
//    each lane accumulates G x C x 8 f32; G is a template parameter, so
//    every loop runs over the actual G: 1, 2, 4, 6 and 8 are built, and an odd
//    G of 3, 5 or 7 runs in the next even build with its last row slot's
//    q read as 0 and its output never written (20 instantiations of one
//    row group, not 32);
//  * more than 8 query rows per KV head (qwen3-moe: 64 heads over 4, G =
//    16) would need 2 x G x EL f32 of a lane's registers for q and acc
//    alone (256 at hd 128 bf16), so such a G runs as RG = ceil(G / 8) row
//    groups of Gr = ceil(G / RG) rows (the last may hold fewer), each a
//    block of its own on the grid's y axis beside its KV head, running the
//    6- or 8-slot build for Gr rows.  The row groups of a KV head read the
//    same cache rows (the second read mostly from L2) and keep their own
//    partials and ticket counter.  RG is a template parameter: the RG = 1
//    builds (G <= 8) compute the block's rows as a kernel without row
//    groups would (Gr, last among the parameters, unread), and RG = 2 is
//    built for 6 and 8 slots only;
//  * the sequence is split among blocks of 4 warps: one block per (split,
//    KV head and row group, request).  The wrapper chooses the positions
//    per block P (a multiple of 32): P = 32 * ceil(S / (32 * ceil(SMs /
//    (B*KV*RG)))) gives about one block per SM over the whole grid; at
//    B=4 KV=2 S=512 on 132 SMs that is P = 32, 16 splits, 128 blocks, of
//    which 54 hold valid positions at lengths 397/250/130/17 (the valid
//    positions are only 1588 rows of 512 bytes, 27 blocks of 32 per KV
//    head; gemma-2b's B=4 KV=1 hd 256 also gets P = 32 and 16 splits;
//    qwen3-moe's B=4 KV=4 RG=2 gets P = 128 and 4 splits).  Splits past a
//    request's length exit at once, so the bytes moved follow the data;
//  * the warps of a block merge their (m, l, acc) in shared memory; when a
//    request uses one split the block writes the output itself, otherwise
//    each working split writes its partial to scratch, fences, and takes a
//    ticket from a per-(request, KV head, row group) counter; the block
//    that takes the last ticket merges the used splits, writes the group's
//    output rows and sets the counter back to 0.  One launch per call, no
//    combine kernel;
//  * a length-0 request has no working split: split 0 writes its zeros;
//  * the cache is read in place through its strides: the model passes one
//    layer of its (B, Smax, KV, hd) cache viewed as (B, KV, Smax, hd).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 8;                      // query rows a block runs
constexpr int kMaxGroups = 2;                 // row groups per KV head: G <= 16
constexpr int kMaxSplits = 256;               // splits one request may use

// Row slots the kernel runs for Gq query rows of a row group: Gq when it is
// 1 or even, else Gq + 1 (the wrapper sizes the scratch by the same rule).
__host__ __device__ constexpr int row_slots(int Gq) { return Gq == 1 ? 1 : Gq + Gq % 2; }

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

__device__ __forceinline__ int valid_len(const int* lengths, int b, int S) {
  return min(max(lengths[b], 0), S);
}

// The E = 16 / sizeof(T) elements of one 16-byte vector, as f32.
template <typename T> __device__ __forceinline__ void widen(const uint4& u, float* f);
template <> __device__ __forceinline__ void widen<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// The row groups for Gt query rows per KV head: RG = ceil(Gt / kMaxG)
// groups of Gr = ceil(Gt / RG) rows, the last holding Gt - (RG - 1) * Gr.
__host__ __device__ constexpr int row_groups(int Gt) { return (Gt + kMaxG - 1) / kMaxG; }
__host__ __device__ constexpr int group_rows(int Gt) {
  return (Gt + row_groups(Gt) - 1) / row_groups(Gt);
}

// One block per (split, unit, request), unit = KV head * RG + row group;
// G row slots, of which the first Gq (at most Gr) are the group's query
// rows.  Scratch, used only when a request spans several splits: m/l (B,
// units, NS, G) and acc (B, units, NS, G, HD), f32, units = KV * RG;
// tickets (B, units) int32, all 0 between calls.
template <typename T, int HD, int G, int RG>
__global__ void __launch_bounds__(kWarps * 32)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ lengths, T* __restrict__ o, float* __restrict__ pm,
           float* __restrict__ pl, float* __restrict__ pacc, int* __restrict__ tickets,
           int units, int Gt, int S, int P, int NS, Strides qs, Strides ks, Strides vs,
           long long osb, long long osh, float scale_log2, int Gr) {
  constexpr int E = 16 / sizeof(T);           // elements per 16-byte lane load
  constexpr int CH = HD / E;                  // 16-byte chunks per cache row
  constexpr int LPR = CH < 32 ? pow2_at_least(CH) : 32;   // lanes per cache row
  constexpr int C = (CH + LPR - 1) / LPR;     // 16-byte chunks of a row per lane
  constexpr int EL = C * E;                   // elements of a row per lane
  constexpr int RPW = 32 / LPR;               // rows per warp load instruction
  constexpr bool kSpare = LPR * C != CH;      // lanes past the row's chunks (hd 80)
  static_assert(HD % E == 0 && (!kSpare || C == 1) && RPW * LPR == 32,
                "a warp's lanes cover whole rows");
  constexpr int U = G * EL <= 48 ? 4 : (C == 1 ? 2 : 1);   // rows each lane has in flight
  constexpr int PB = kWarps * RPW * U;        // positions per block iteration
  __shared__ float sM[kWarps][G], sL[kWarps][G];
  __shared__ float sAcc[kWarps][G][HD];
  __shared__ bool sLast;

  const int split = blockIdx.x, unit = blockIdx.y, b = blockIdx.z;
  const int kvh = unit / RG, rg = unit % RG;  // RG is 1 or 2: no division
  const long long head0 = (long long)kvh * Gt + rg * Gr;   // this block's first query row
  const int Gq = RG == 1 ? Gt : min(Gr, Gt - rg * Gr);   // and its query rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = valid_len(lengths, b, S);
  T* ob = o + b * osb + head0 * osh;
  if (n == 0) {                               // no keys: the output is 0
    if (split == 0)
      for (int i = tid; i < Gq * HD; i += kWarps * 32)
        ob[(i / HD) * osh + i % HD] = from_f32<T>(0.f);
    return;
  }
  const int s0 = split * P;
  if (s0 >= n) return;                        // past the length: never read
  const int used = (n + P - 1) / P, send = min(s0 + P, n);
  // chunk c of this lane holds columns col + c * LPR * E .. + E - 1
  const int slot = lane / LPR, col = (lane % LPR) * E;
  const bool live = !kSpare || col < HD;      // a spare lane reads and writes nothing

  float qv[G][EL];
  const T* qb = q + b * qs.b + head0 * qs.h + col;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < C; ++c)
      widen<T>(g < Gq && live
                   ? __ldg(reinterpret_cast<const uint4*>(qb + g * qs.h + c * LPR * E))
                   : make_uint4(0u, 0u, 0u, 0u),
               qv[g] + c * E);

  float m[G], l[G], acc[G][EL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[g][e] = 0.f;
  }

  const T* kb = k + b * ks.b + kvh * ks.h + col;
  const T* vb = v + b * vs.b + kvh * vs.h + col;
  // warp-uniform loop: the shuffles below need every lane of the warp
  for (int base = s0 + warp * RPW * U; base < send; base += PB) {
    uint4 kr[U][C], vr[U][C];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {             // all of this lane's loads first
      const int pos = base + u * RPW + slot;
      ok[u] = pos < send;
      const bool ld = ok[u] && live;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int at = c * LPR * E;
        kr[u][c] = ld ? __ldg(reinterpret_cast<const uint4*>(kb + pos * ks.s + at)) : zero;
        vr[u][c] = ld ? __ldg(reinterpret_cast<const uint4*>(vb + pos * vs.s + at)) : zero;
      }
    }
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EL];
#pragma unroll
      for (int c = 0; c < C; ++c) widen<T>(kr[u][c], kf + c * E);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EL; ++e) d += qv[g][e] * kf[e];
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u][g] = ok[u] ? d * scale_log2 : kNeg;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float alpha = exp2f(m[g] - mx);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EL; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[EL];
#pragma unroll
      for (int c = 0; c < C; ++c) widen<T>(vr[u][c], vf + c * E);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = ok[u] ? exp2f(s[u][g] - m[g]) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EL; ++e) acc[g][e] += p * vf[e];
      }
    }
  }

  // merge the row slots of the warp (lanes LPR apart), then the warps
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo), e1 = exp2f(m[g] - mx), e2 = exp2f(mo - mx);
      l[g] = l[g] * e1 + lo * e2;
#pragma unroll
      for (int e = 0; e < EL; ++e)
        acc[g][e] = acc[g][e] * e1 + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * e2;
      m[g] = mx;
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (live)
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int e = 0; e < E; ++e) sAcc[warp][g][col + c * LPR * E + e] = acc[g][c * E + e];
      if (lane == 0) {
        sM[warp][g] = m[g];
        sL[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  const long long row0 = ((long long)(b * units + unit) * NS + split) * G;
  for (int i = tid; i < G * HD; i += kWarps * 32) {
    const int g = i / HD, d = i % HD;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sM[w][g]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = exp2f(sM[w][g] - mx);
      a += sAcc[w][g][d] * e;
      ls += sL[w][g] * e;
    }
    if (used == 1) {
      if (g < Gq) ob[g * osh + d] = from_f32<T>(a / fmaxf(ls, 1e-30f));
    } else {
      pacc[(row0 + g) * HD + d] = a;
      if (d == 0) {
        pm[row0 + g] = mx;
        pl[row0 + g] = ls;
      }
    }
  }
  if (used == 1) return;

  // the block that draws the last ticket merges the used splits
  __threadfence();
  __syncthreads();
  int* ticket = tickets + b * units + unit;
  if (tid == 0) sLast = atomicAdd(ticket, 1) == used - 1;
  __syncthreads();
  if (!sLast) return;
  __threadfence();
  // each split's weight exp2(m - max) per row, in shared memory, all loads
  // in parallel; then 1 / l per row; then the weighted sums of acc, 16
  // bytes a thread and several splits in flight
  __shared__ float sW[kMaxSplits * G], sInv[G];
  const long long base0 = (long long)(b * units + unit) * NS * G;
  for (int i = tid; i < used * G; i += kWarps * 32) sW[i] = __ldcg(pm + base0 + i);
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {
    float mx = kNeg, ls = 0.f;
    for (int sp = lane; sp < used; sp += 32) mx = fmaxf(mx, sW[sp * G + g]);
    mx = warp_max(mx);
    for (int sp = lane; sp < used; sp += 32) {
      const float w = exp2f(sW[sp * G + g] - mx);
      sW[sp * G + g] = w;
      ls += w * __ldcg(pl + base0 + sp * G + g);
    }
    ls = warp_sum(ls);
    if (lane == 0) sInv[g] = 1.f / fmaxf(ls, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < Gq * HD / 4; i += kWarps * 32) {
    const int g = i / (HD / 4), d = 4 * (i % (HD / 4));
    const float4* src = reinterpret_cast<const float4*>(pacc + (base0 + g) * HD + d);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < used; ++sp) {
      const float w = sW[sp * G + g];
      const float4 x = __ldcg(src + (long long)sp * G * HD / 4);
      a.x += w * x.x;
      a.y += w * x.y;
      a.z += w * x.z;
      a.w += w * x.w;
    }
    const float inv = sInv[g];
    T* out = ob + g * osh + d;
    out[0] = from_f32<T>(a.x * inv);
    out[1] = from_f32<T>(a.y * inv);
    out[2] = from_f32<T>(a.z * inv);
    out[3] = from_f32<T>(a.w * inv);
  }
  if (tid == 0) *ticket = 0;                  // ready for the next call on this stream
}

struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* o;
  float *pm, *pl, *pacc;
  int* tickets;
  int B, units, Gt, Gr, S, P, NS;
  Strides qs, ks, vs;
  long long osb, osh;
  float scale_log2;
};

template <typename T, int HD, int G, int RG>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  decode_fwd<T, HD, G, RG><<<dim3(a.NS, a.units, a.B), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.lengths, static_cast<T*>(a.o), a.pm, a.pl, a.pacc, a.tickets, a.units, a.Gt, a.S,
      a.P, a.NS, a.qs, a.ks, a.vs, a.osb, a.osh, a.scale_log2, a.Gr);
  return cudaGetLastError();
}

// the build for a row group of a.Gr query rows: Gr itself, or the next even
// G; two row groups (G of 9-16) run in 5-8 rows, the 6- or 8-slot build
template <typename T, int HD>
cudaError_t launch_g(const Args& a, cudaStream_t st) {
  if (a.Gt > kMaxG)
    return row_slots(a.Gr) == 6 ? launch<T, HD, 6, 2>(a, st) : launch<T, HD, 8, 2>(a, st);
  switch (row_slots(a.Gr)) {
    case 1: return launch<T, HD, 1, 1>(a, st);
    case 2: return launch<T, HD, 2, 1>(a, st);
    case 4: return launch<T, HD, 4, 1>(a, st);
    case 6: return launch<T, HD, 6, 1>(a, st);
    default: return launch<T, HD, 8, 1>(a, st);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  H / KV <= 16 query rows per KV head.
// P: cache positions per block, a multiple of 32; the grid has NS =
// ceil(S / P) <= 256 splits.  Scratch the caller allocates, with N = KV *
// row_groups(H / KV) units and R = row_slots(group_rows(H / KV)): acc of
// B*N*NS*R*hd floats (16-byte aligned), m and l of B*N*NS*R floats each,
// and B*N int32 tickets that are 0 before the first call (each call leaves
// them 0).  q, the caches and their strides must be 16-byte aligned.
// Returns 0, a cudaError_t from the launch, or -1 when the arguments are
// outside what the kernel takes.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* lengths, void* o, float* pm,
    float* pl, float* pacc, int* tickets, int dtype, int B, int H, int KV, int S, int hd,
    int P, long long qsb, long long qsh, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh, float scale,
    void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxG * kMaxGroups ||
      B > 65535 || KV * kMaxGroups > 65535 || P < 32 || P % 32 != 0)
    return -1;
  const int NS = (S + P - 1) / P;
  if (NS > kMaxSplits) return -1;
  const int Gt = H / KV, RG = row_groups(Gt);
  const Args a{q, k, v, lengths, o, pm, pl, pacc, tickets, B, KV * RG, Gt, group_rows(Gt),
               S, P, NS,
               Strides{qsb, qsh, 0}, Strides{ksb, ksh, kss}, Strides{vsb, vsh, vss},
               osb, osh, scale * 1.4426950408889634f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && hd == 64)
    err = launch_g<float, 64>(a, st);
  else if (dtype == 0 && hd == 80)
    err = launch_g<float, 80>(a, st);
  else if (dtype == 1 && hd == 80)
    err = launch_g<__nv_bfloat16, 80>(a, st);
  else if (dtype == 0 && hd == 128)
    err = launch_g<float, 128>(a, st);
  else if (dtype == 0 && hd == 256)
    err = launch_g<float, 256>(a, st);
  else if (dtype == 1 && hd == 64)
    err = launch_g<__nv_bfloat16, 64>(a, st);
  else if (dtype == 1 && hd == 128)
    err = launch_g<__nv_bfloat16, 128>(a, st);
  else if (dtype == 1 && hd == 256)
    err = launch_g<__nv_bfloat16, 256>(a, st);
  else
    return -1;
  return static_cast<int>(err);
}
