// sLSTM time scan for Hopper (sm_90a): the whole recurrence over S steps in
// one launch, as one thread-block cluster per head where the head's w_hh
// fits the cluster's shared memory, else as one cooperative grid.
//
// Replaces the Pallas TPU kernel `slstm_scan_kernel` / `_kernel` in
// src/repro/kernels/slstm_scan/kernel.py.  Same function: from pre-projected
// gates xg (B, S, 4D), a block-diagonal recurrent weight w_hh (H, dh, 4dh)
// and a bias (4D,), step the stabilised exponential-gating recurrence
//   g = (xg_t + h_{t-1} . w_hh[head]) + b, laid out per head as [i|f|z|o]
//   m = max(log_sigmoid(f) + m', i);  i' = exp(i - m);  f' = exp(log_sigmoid(f) + m' - m)
//   c = f' c' + i' tanh(z);  n = f' n' + i';  h = sigmoid(o) c / max(n, 1e-6)
// from a given state (h0, c0, n0, m0), writing hs (B, S, D) and the final
// state, all f32; in "save" mode (training) the same launch also writes
// every step's gates g (B, S, 4D) and c, n and m ((B, S, D) each), all f32,
// which the backward kernel (slstm_scan_bwd.cu) reads instead of running
// the recurrence or its product again.
// m0 = -inf makes f' = exp(-inf) = 0 on the first step, so the file is
// built without --use_fast_math (gate_step picks its own approximations).
//
// What bounds it on the H100: the serial chain.  Step t needs the whole
// h_{t-1} of a head, so the S steps are S dependent rounds; the bytes
// (xg, w_hh and hs once each) take a few microseconds and the f32 products
// (2 B 4D dh flops a step) well under a microsecond a step at full width,
// while every step must pass h between SMs.  At D = 2048 one head's w_hh is
// (512, 2048), 2 MiB in bf16: no SM holds it, so a head is spread over
// several SMs that must meet every step.
//
// Cluster kernel (`slstm_scan_cluster`), and what it does about that:
//  * the heads are independent, so each head is one thread-block cluster
//    of cs blocks (the smallest of 1, 2, 4, 8, 16 whose shared memory holds
//    the head's w_hh: 16 blocks of 128 KiB at full width in bf16) and the
//    H clusters never wait for each other: no grid-wide barrier and no
//    cooperative launch;
//  * block r of a cluster owns J = dh / cs hidden indices (rounded up to 8)
//    for all B rows: its slice of w_hh (the 4 gate columns of its indices)
//    is copied into shared memory once, with 16-byte cp.async, in the
//    layout the product reads, and stays there for all S steps, as do its
//    (c, n, m) and the bias;
//  * 16 warps: each owns 16 of the block's 4J gate columns and one half of
//    the k range; its lanes split that half, read w as 16-byte vectors
//    (8 bf16, conflict-free) and h from shared memory, keep 16 independent
//    f32 accumulators per row, and reduce across lanes with shuffles (no
//    partial-sum pass; the gate math adds the two halves);
//  * xg[t+1] (the block's 4J columns of every row) is copied with cp.async
//    into a shared double buffer while the block waits for h_t and
//    computes step t+1's product;
//  * the warps that ran the gate math send h_t straight into every peer's
//    shared memory (distributed shared memory: `st.async`, 16 bytes a
//    store), into the half of a double buffer that nobody reads in step t,
//    and each store counts its bytes on the receiving block's mbarrier.  A
//    block starts step t+1 once its barrier has all of h_t: one block-wide
//    __syncthreads a step and no cluster-wide barrier.  At S = 1 nothing is
//    sent and nothing waited for.
// Grid kernel (`slstm_scan_grid`), for what no cluster can hold (f32 w_hh
// at full width: 4 MiB per head, more than 16 x 227 KB): one persistent
// cooperative launch; each block keeps a slice of w_hh in shared memory,
// passes h through a double buffer in device memory and meets the whole
// grid at a grid barrier per step.  It is refused (not hung) when the grid
// cannot be resident.  The choice between the two is made from the dtypes
// and the shape alone, and cached per (device, dtypes, B, D, H) with the
// rest of the plan, so a call makes no attribute or occupancy query.
// The outputs must not alias the inputs: other blocks read h0 and the
// state across their barriers.  The products run on CUDA cores in f32.
#include "common.cuh"
#include "mma.cuh"  // smem_u32, cp_async16, cp_async_commit, cp_async_wait
#include "cluster.cuh"  // cluster_rank/size/barrier, mbar_*, st_async_peer, cp_async4

#include <cooperative_groups.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRowChunk = 4;                  // batch rows per pass of a product
constexpr int kClusterSizes[] = {1, 2, 4, 8, 16};

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// One step of the gate math for one (row, hidden index); updates c, n, m
// in place and returns h.  It is the one serial stretch of a step that no
// other thread shares, so it uses the hardware's exp2 / log2 / reciprocal
// (__expf, __logf, __fdividef: a few ulp each) rather than the libm
// versions, about 40% shorter; the states stay within 3e-5 of the plain
// version over 384 steps (the card tests hold them there).  -inf in m
// gives exp(-inf) = 0 as before; tanh(z) = 1 - 2 / (e^2z + 1) and the
// sigmoid's division go to 1 and 0 without a NaN when e^x overflows.
__device__ __forceinline__ float gate_step(float gi, float gf, float gz, float go, float& c,
                                           float& n, float& m) {
  const float logf = fminf(gf, 0.f) - __logf(1.f + __expf(-fabsf(gf)));   // log sigmoid(f)
  const float mn = fmaxf(logf + m, gi);
  const float ip = __expf(gi - mn), fp = __expf(logf + m - mn);
  c = fp * c + ip * (1.f - __fdividef(2.f, __expf(2.f * gz) + 1.f));
  n = fp * n + ip;
  m = mn;
  return __fdividef(c, (1.f + __expf(-go)) * fmaxf(n, 1e-6f));
}

// ---------------------------------------------------------------------------
// Grid kernel
// ---------------------------------------------------------------------------

// Shared memory of one grid block: w slice (dh x 4J, TW), h of the head
// (B x dh), gates (B x 4J), partial sums (parts x kRowChunk x 4J) and the
// state (3 x B x J), all f32 but the w slice.
template <typename TW>
__host__ __device__ size_t grid_smem(int B, int dh, int J) {
  const int W = 4 * J, parts = kThreads / W;
  return align16((size_t)dh * W * sizeof(TW)) + (size_t)B * dh * 4 + (size_t)B * W * 4 +
         (size_t)parts * kRowChunk * W * 4 + (size_t)3 * B * J * 4;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
slstm_scan_grid(const TX* __restrict__ xg, const TW* __restrict__ whh,
                const float* __restrict__ bias, const float* __restrict__ h0,
                const float* __restrict__ c0, const float* __restrict__ n0,
                const float* __restrict__ m0, float* __restrict__ hs, float* __restrict__ hN,
                float* __restrict__ cN, float* __restrict__ nN, float* __restrict__ mN,
                float* __restrict__ gS, float* __restrict__ cS, float* __restrict__ nS,
                float* __restrict__ mS, float* hbuf, int B, int S, int D, int H, int J) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = D / H, W = 4 * J, parts = kThreads / W;
  const int per_head = (dh + J - 1) / J;
  const int head = blockIdx.x / per_head, j0 = (blockIdx.x % per_head) * J;
  const int tid = threadIdx.x;

  TW* w_s = reinterpret_cast<TW*>(smem);
  float* h_s = reinterpret_cast<float*>(smem + align16((size_t)dh * W * sizeof(TW)));
  float* g_s = h_s + B * dh;
  float* red = g_s + B * W;
  float* c_s = red + parts * kRowChunk * W;
  float* n_s = c_s + B * J;
  float* m_s = n_s + B * J;

  // w_s[k][g*J + jl] = w_hh[head, k, g*dh + j0 + jl]; columns past dh are 0
  const TW* wh = whh + (size_t)head * dh * 4 * dh;
  for (int i = tid; i < dh * W; i += kThreads) {
    const int k = i / W, col = i % W, g = col / J, j = j0 + col % J;
    w_s[i] = j < dh ? wh[(size_t)k * 4 * dh + g * dh + j] : from_f32<TW>(0.f);
  }
  for (int i = tid; i < B * J; i += kThreads) {
    const int b = i / J, j = j0 + i % J;
    if (j < dh) {
      const size_t o = (size_t)b * D + head * dh + j;
      c_s[i] = c0[o];
      n_s[i] = n0[o];
      m_s[i] = m0[o];
    }
  }

  const int col = tid % W, part = tid / W;
  const int kper = (dh + parts - 1) / parts;
  const int kb = min(dh, part * kper), ke = min(dh, kb + kper);
  for (int t = 0; t < S; ++t) {
    const float* hsrc = t == 0 ? h0 : hbuf + (size_t)((t - 1) & 1) * B * D;
    float* hdst = hbuf + (size_t)(t & 1) * B * D;
    for (int i = tid; i < B * dh; i += kThreads) {
      const int b = i / dh, k = i % dh;
      h_s[i] = __ldcg(hsrc + (size_t)b * D + head * dh + k);
    }
    __syncthreads();

    // g_s[b][col] = sum_k h[b][k] * w_s[k][col], the k range split in parts
    for (int r0 = 0; r0 < B; r0 += kRowChunk) {
      float acc[kRowChunk];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r) acc[r] = 0.f;
      if (part < parts) {
        for (int k = kb; k < ke; ++k) {
          const float w = to_f32(w_s[k * W + col]);
#pragma unroll
          for (int r = 0; r < kRowChunk; ++r)
            if (r0 + r < B) acc[r] = fmaf(h_s[(r0 + r) * dh + k], w, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kRowChunk; ++r) red[(part * kRowChunk + r) * W + col] = acc[r];
      }
      __syncthreads();
      for (int i = tid; i < kRowChunk * W; i += kThreads) {
        const int r = i / W, c = i % W;
        if (r0 + r < B) {
          float s = 0.f;
          for (int p = 0; p < parts; ++p) s += red[(p * kRowChunk + r) * W + c];
          g_s[(r0 + r) * W + c] = s;
        }
      }
      __syncthreads();
    }

    for (int i = tid; i < B * J; i += kThreads) {
      const int b = i / J, jl = i % J, j = j0 + jl;
      if (j >= dh) continue;
      const TX* x = xg + ((size_t)b * S + t) * 4 * D + (size_t)head * 4 * dh + j;
      const float* bb = bias + (size_t)head * 4 * dh + j;
      const float* gr = g_s + b * W + jl;
      float c = c_s[i], n = n_s[i], m = m_s[i];
      const float gi = (to_f32(x[0]) + gr[0]) + bb[0];
      const float gf = (to_f32(x[dh]) + gr[J]) + bb[dh];
      const float gz = (to_f32(x[2 * dh]) + gr[2 * J]) + bb[2 * dh];
      const float go = (to_f32(x[3 * dh]) + gr[3 * J]) + bb[3 * dh];
      const float h = gate_step(gi, gf, gz, go, c, n, m);
      c_s[i] = c;
      n_s[i] = n;
      m_s[i] = m;
      const size_t o = (size_t)b * D + head * dh + j;
      const size_t ot = ((size_t)b * S + t) * D + head * dh + j;
      hs[ot] = h;
      if (cS) {                               // save mode: every step's gates and state
        float* g = gS + ((size_t)b * S + t) * 4 * D + (size_t)head * 4 * dh + j;
        g[0] = gi;
        g[dh] = gf;
        g[2 * dh] = gz;
        g[3 * dh] = go;
        cS[ot] = c;
        nS[ot] = n;
        mS[ot] = m;
      }
      hdst[o] = h;
      if (t == S - 1) {
        hN[o] = h;
        cN[o] = c;
        nN[o] = n;
        mN[o] = m;
      }
    }
    if (t + 1 < S) grid.sync();               // h_t complete in every block
  }
}

// S grid barriers and nothing else: the serial chain's floor for this grid.
__global__ void grid_sync_loop(int steps) {
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < steps; ++t) grid.sync();
}

// ---------------------------------------------------------------------------
// Cluster kernel
// ---------------------------------------------------------------------------

constexpr int kClusterThreads = 512;
constexpr int kColWarps = 8;                  // warps over the 16-column groups ...
constexpr int kKSets = 2;                     // ... times the halves of the k range
constexpr int kClusterRows = 2;               // batch rows per pass of its product

// Sum a[c] over the 32 lanes for each of the 16 columns c: a reduce-scatter
// in 16 + 8 + 4 + 2 + 1 shuffles.  Lanes 2i and 2i+1 end with column
// col16(lane).
__device__ __forceinline__ int col16(int lane) {
  return ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 + ((lane >> 2) & 1) * 2 +
         ((lane >> 1) & 1);
}
__device__ __forceinline__ float reduce16(const float (&a)[16], int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  const bool u4 = lane & 16, u3 = lane & 8, u2 = lane & 4, u1 = lane & 2;
  float b[8], c[4], d[2];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    b[i] = (u4 ? a[i + 8] : a[i]) + __shfl_xor_sync(kAll, u4 ? a[i] : a[i + 8], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    c[i] = (u3 ? b[i + 4] : b[i]) + __shfl_xor_sync(kAll, u3 ? b[i] : b[i + 4], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    d[i] = (u2 ? c[i + 2] : c[i]) + __shfl_xor_sync(kAll, u2 ? c[i] : c[i + 2], 4);
  const float e = (u1 ? d[1] : d[0]) + __shfl_xor_sync(kAll, u1 ? d[0] : d[1], 2);
  return e + __shfl_xor_sync(kAll, e, 1);
}

// Batch rows as the cluster kernel pads them: 1, or a multiple of kClusterRows.
__host__ __device__ __forceinline__ int padded_rows(int B) {
  return B == 1 ? 1 : (B + kClusterRows - 1) / kClusterRows * kClusterRows;
}

// Shared memory of one cluster block (W = 4J gate columns, Bp padded rows,
// cs blocks): two barriers (16 bytes), the w slice (4J/V chunks of dh x 16
// bytes), the h double buffer (2 x Bp rows of cs J f32: every block's J
// indices, the last block's past dh too), the xg double buffer (2 x Bp x
// 4J, TX), then f32: the gates' two k-halves (2 x Bp x 4J), c, n, m (Bp x
// J each) and the bias (4J).
template <typename TX, typename TW>
__host__ __device__ size_t cluster_smem(int B, int dh, int J, int cs) {
  const size_t W = 4 * (size_t)J, Bp = padded_rows(B);
  return 16 + align16(dh * W * sizeof(TW)) + 8 * Bp * cs * J + 2 * Bp * W * sizeof(TX) +
         4 * (kKSets * Bp * W + 3 * Bp * J + W);
}

// g_s[kset][b][col] = sum over this k-half of h[b][k] w[k][col], for the
// block's 4J columns: warp w takes the 16-column groups w % 8, w % 8 + 8, ...
// and the k-half w / 8; its lane l the k = l + 32 (w / 8) + 64 i.
template <typename TW, int RB>
__device__ __forceinline__ void cluster_product(const TW* w_s, const float* h, float* g_s,
                                                int dh, int hstride, int W, int Bp) {
  constexpr int V = 16 / sizeof(TW), NC = 16 / V;     // 16-byte chunks per 16 columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kset = warp / kColWarps, k0 = lane + 32 * kset;
  float* gk = g_s + (size_t)kset * Bp * W;
  const uint4* w4 = reinterpret_cast<const uint4*>(w_s);
  for (int grp = warp % kColWarps; grp < W / 16; grp += kColWarps) {
    const uint4* wg = w4 + (size_t)grp * NC * dh;
    for (int r0 = 0; r0 < Bp; r0 += RB) {
      float acc[RB][16];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;
#pragma unroll 2
      for (int k = k0; k < dh; k += 32 * kKSets) {
        float hv[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) hv[r] = h[(r0 + r) * hstride + k];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          float wv[V];
          unpack16<TW>(wg[cc * dh + k], wv);
#pragma unroll
          for (int e = 0; e < V; ++e)
#pragma unroll
            for (int r = 0; r < RB; ++r) acc[r][cc * V + e] = fmaf(hv[r], wv[e], acc[r][cc * V + e]);
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float v = reduce16(acc[r], lane);
        if (!(lane & 1)) gk[(r0 + r) * W + grp * 16 + col16(lane)] = v;
      }
    }
  }
}

// The block's 4J xg columns of every row at step t into buffer `buf`:
// 16-byte cp.async where the layout allows (vec), else element by element.
template <typename TX>
__device__ __forceinline__ void load_x(const TX* __restrict__ xg, TX* x_s, int buf, int t,
                                       int B, int Bp, int S, int D, int dh, int head, int j0,
                                       int J, bool vec) {
  constexpr int V = 16 / sizeof(TX);
  const int W = 4 * J, per_gate = J / V, nc = W / V;
  for (int idx = threadIdx.x; idx < B * nc; idx += kClusterThreads) {
    const int b = idx / nc, c = idx - b * nc, g = c / per_gate;
    const int j = j0 + (c - g * per_gate) * V;
    TX* dst = x_s + ((size_t)buf * Bp + b) * W + c * V;
    const TX* src = xg + ((size_t)b * S + t) * 4 * D + (size_t)head * 4 * dh + g * dh + j;
    if (vec) {
      if (j < dh) cp_async16(smem_u32(dst), src, true);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (j + e < dh) dst[e] = src[e];
    }
  }
  cp_async_commit();
}

template <typename TX, typename TW, int RB>
__global__ void __launch_bounds__(kClusterThreads, 1)
slstm_scan_cluster(const TX* __restrict__ xg, const TW* __restrict__ whh,
                   const float* __restrict__ bias, const float* __restrict__ h0,
                   const float* __restrict__ c0, const float* __restrict__ n0,
                   const float* __restrict__ m0, float* __restrict__ hs,
                   float* __restrict__ hN, float* __restrict__ cN, float* __restrict__ nN,
                   float* __restrict__ mN, float* __restrict__ gS, float* __restrict__ cS,
                   float* __restrict__ nS, float* __restrict__ mS, int B, int S, int D, int H,
                   int J, int vec_w, int vec_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VW = 16 / sizeof(TW);
  const unsigned cs = cluster_size(), rank = cluster_rank();
  const int dh = D / H, W = 4 * J, Bp = padded_rows(B), hstride = cs * J;
  const int head = blockIdx.x / cs, j0 = rank * J;
  const int tid = threadIdx.x;

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);    // bar[b]: h_t has landed in buffer b
  TW* w_s = reinterpret_cast<TW*>(smem + 16);
  float* h_s = reinterpret_cast<float*>(smem + 16 + align16((size_t)dh * W * sizeof(TW)));
  TX* x_s = reinterpret_cast<TX*>(h_s + (size_t)2 * Bp * hstride);
  float* g_s = reinterpret_cast<float*>(x_s + (size_t)2 * Bp * W);
  float* c_s = g_s + kKSets * Bp * W;
  float* n_s = c_s + Bp * J;
  float* m_s = n_s + Bp * J;
  float* b_s = m_s + Bp * J;

  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // w slice: chunk c (16 bytes: V columns of one gate) holds block columns
  // [cV, cV + V) for every k, at w_s[(c dh + k) V]; columns past dh are 0.
  // Thread tid copies chunk (tid + i T) % nc of row (tid + i T) / nc.
  {
    const int per_gate = J / VW, nc = W / VW;
    const TW* wh = whh + (size_t)head * dh * 4 * dh;
    int c = tid % nc, k = tid / nc;
    const int dc = kClusterThreads % nc, dk = kClusterThreads / nc;
    for (; k < dh; k += dk) {
      const int g = c / per_gate, j = j0 + (c - g * per_gate) * VW;
      TW* dst = w_s + ((size_t)c * dh + k) * VW;
      const TW* src = wh + (size_t)k * 4 * dh + g * dh + j;
      if (vec_w) {
        cp_async16(smem_u32(dst), j < dh ? src : wh, j < dh);   // past dh: zero-filled
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e) dst[e] = j + e < dh ? src[e] : from_f32<TW>(0.f);
      }
      c += dc;
      if (c >= nc) {
        c -= nc;
        ++k;
      }
    }
  }
  // h0 (buffer 0; columns past dh are never read), the state and the bias,
  // all asynchronous too, so the prologue waits for memory once
  for (int b = 0; b < B; ++b)
    for (int k = tid; k < dh; k += kClusterThreads)
      cp_async4(&h_s[b * hstride + k], &h0[(size_t)b * D + head * dh + k]);
  for (int i = tid; i < B * J; i += kClusterThreads) {
    const int b = i / J, j = j0 + i % J;
    if (j < dh) {
      const size_t o = (size_t)b * D + head * dh + j;
      cp_async4(&c_s[i], &c0[o]);
      cp_async4(&n_s[i], &n0[o]);
      cp_async4(&m_s[i], &m0[o]);
    }
  }
  for (int i = tid; i < W; i += kClusterThreads) {
    const int g = i / J, j = j0 + i % J;
    if (j < dh) cp_async4(&b_s[i], &bias[(size_t)head * 4 * dh + g * dh + j]);
    else b_s[i] = 0.f;
  }
  load_x(xg, x_s, 0, 0, B, Bp, S, D, dh, head, j0, J, vec_x);   // commits all of the above
  cp_async_wait<0>();
  if (S > 1) cluster_barrier();               // every peer has started and set its barriers
  else __syncthreads();

  const unsigned round_bytes = cs * B * J * 4;  // h_t from every block of the cluster
  for (int t = 0; t < S; ++t) {
    const int cur = t & 1;
    const bool send = t + 1 < S;
    if (t > 0) mbar_wait(&bar[cur], ((t - 1) >> 1) & 1);   // h_{t-1} is complete
    // this block's own gate warps have sent h_{t-1}, so g_s and x_s[cur ^ 1]
    // are free; buffer cur ^ 1 of h is read by no block until round t lands
    if (tid == 0 && send) mbar_expect(&bar[cur ^ 1], round_bytes);
    cluster_product<TW, RB>(w_s, h_s + (size_t)cur * Bp * hstride, g_s, dh, hstride, W, Bp);
    cp_async_wait<0>();                      // xg[t], prefetched a step ago
    __syncthreads();

    // gate math, whole warps at a time; then each group of 4 lanes (4
    // neighbouring indices of one row) sends its h_t as 16 bytes to every
    // peer's (and its own) h buffer cur ^ 1, lane p of the group to peers
    // p, p + 4, ...; each store counts its bytes on that block's bar[cur ^ 1]
    const TX* xr = x_s + (size_t)cur * Bp * W;
    float* dst = h_s + (size_t)(cur ^ 1) * Bp * hstride + j0;
    const int lane = tid & 31;
    for (int base = tid - lane; base < B * J; base += kClusterThreads) {
      const int i = base + lane, b = i / J, jl = i - b * J, j = j0 + jl;
      const bool live = i < B * J;
      float h = 0.f;                          // indices past dh are sent as 0
      if (live && j < dh) {
        const TX* x = xr + b * W + jl;
        const float* g0 = g_s + b * W + jl;
        const float* g1 = g0 + Bp * W;
        float c = c_s[i], n = n_s[i], m = m_s[i];
        const float gi = (to_f32(x[0]) + (g0[0] + g1[0])) + b_s[jl];
        const float gf = (to_f32(x[J]) + (g0[J] + g1[J])) + b_s[J + jl];
        const float gz = (to_f32(x[2 * J]) + (g0[2 * J] + g1[2 * J])) + b_s[2 * J + jl];
        const float go = (to_f32(x[3 * J]) + (g0[3 * J] + g1[3 * J])) + b_s[3 * J + jl];
        h = gate_step(gi, gf, gz, go, c, n, m);
        c_s[i] = c;
        n_s[i] = n;
        m_s[i] = m;
        const size_t o = (size_t)b * D + head * dh + j;
        const size_t ot = ((size_t)b * S + t) * D + head * dh + j;
        hs[ot] = h;
        if (cS) {                             // save mode: every step's gates and state
          float* g = gS + ((size_t)b * S + t) * 4 * D + (size_t)head * 4 * dh + j;
          g[0] = gi;
          g[dh] = gf;
          g[2 * dh] = gz;
          g[3 * dh] = go;
          cS[ot] = c;
          nS[ot] = n;
          mS[ot] = m;
        }
        if (!send) {
          hN[o] = h;
          cN[o] = c;
          nN[o] = n;
          mN[o] = m;
        }
      }
      if (send) {
        const int g4 = lane & ~3;
        const float4 v = make_float4(__shfl_sync(0xffffffffu, h, g4),
                                     __shfl_sync(0xffffffffu, h, g4 + 1),
                                     __shfl_sync(0xffffffffu, h, g4 + 2),
                                     __shfl_sync(0xffffffffu, h, g4 + 3));
        if (live)
          for (int peer = lane & 3; peer < (int)cs; peer += 4)
            st_async_peer(dst + (size_t)b * hstride + (jl & ~3), &bar[cur ^ 1], peer, v);
      }
    }
    if (send) load_x(xg, x_s, cur ^ 1, t + 1, B, Bp, S, D, dh, head, j0, J, vec_x);
  }
}

// `steps` rounds of the cluster kernel's exchange and nothing else: each
// block sends `floats` f32 (16-byte st.async) to every peer, which waits on
// its barrier for all of them before the next round.  The new chain's floor.
__global__ void __launch_bounds__(kClusterThreads)
cluster_sync_loop(int steps, int floats) {
  extern __shared__ __align__(16) unsigned char smem[];  // 2 barriers, 2 x cs x floats, floats
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* buf = reinterpret_cast<float*>(smem + 16);
  const unsigned cs = cluster_size(), rank = cluster_rank();
  float* stage = buf + 2 * cs * floats;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < floats; i += kClusterThreads) stage[i] = (float)i;
  cluster_barrier();
  const int q4 = floats / 4;
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    if (t > 0) mbar_wait(&bar[cur], ((t - 1) >> 1) & 1);
    if (threadIdx.x == 0) mbar_expect(&bar[cur ^ 1], cs * floats * 4);
    __syncthreads();
    const float* dst = buf + (size_t)(cur ^ 1) * cs * floats + rank * floats;
    for (int i = threadIdx.x; i < (int)cs * q4; i += kClusterThreads) {
      const int peer = i / q4, q = i - peer * q4;
      st_async_peer(dst + 4 * q, &bar[cur ^ 1], peer,
                    *reinterpret_cast<const float4*>(stage + 4 * q));
    }
  }
  if (steps > 0) mbar_wait(&bar[steps & 1], ((steps - 1) >> 1) & 1);   // nothing in flight
}

// ---------------------------------------------------------------------------
// Plans, cached on the host
// ---------------------------------------------------------------------------

enum Variant { kCluster = 0, kGrid = 1 };

struct Plan {
  int variant, J, blocks, cluster, active;    // active: co-resident clusters (grid: blocks)
  size_t smem;
};

std::mutex g_mu;
std::map<std::tuple<int, int, int, int, int, int>, Plan> g_plans;

template <typename TX, typename TW>
const void* cluster_kernel(int B) {
  return B == 1 ? (const void*)slstm_scan_cluster<TX, TW, 1>
                : (const void*)slstm_scan_cluster<TX, TW, kClusterRows>;
}

// The cluster kernel where a cluster's shared memory holds a head's w_hh
// (the smallest such cluster), else the grid kernel.  Returns 0, a
// cudaError_t, -2 when no grid of this shape can be resident, or -3 when
// the chosen cluster cannot be scheduled on this card.  Called under g_mu.
template <typename TX, typename TW>
int make_plan(int dev, int B, int D, int H, Plan* p) {
  const int dh = D / H;
  int sms = 0, max_smem = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int cs : kClusterSizes) {
    const int J = ((dh + cs - 1) / cs + 7) / 8 * 8;
    const size_t smem = cluster_smem<TX, TW>(B, dh, J, cs);
    if (smem > (size_t)max_smem) continue;
    const void* kernel = cluster_kernel<TX, TW>(B);
    e = prepare(dev, kernel, max_smem, true);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(H * cs, cs, kClusterThreads, smem, 0, &attr);
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (active < 1) return -3;
    *p = {kCluster, J, H * cs, cs, active, smem};
    return 0;
  }
  // 16 indices per block first (128 blocks at full width); then fewer,
  // larger blocks if the grid is too large, or smaller ones if shared
  // memory is short
  const void* kernel = (const void*)slstm_scan_grid<TX, TW>;
  e = prepare(dev, kernel, max_smem, false);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int J : {16, 32, 8, 64}) {
    const size_t smem = grid_smem<TW>(B, dh, J);
    if (smem > (size_t)max_smem) continue;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int grid = H * ((dh + J - 1) / J);
    if (grid <= per_sm * sms) {
      *p = {kGrid, J, grid, 0, per_sm * sms, smem};
      return 0;
    }
  }
  return -2;
}

int get_plan(int x_bf16, int w_bf16, int B, int D, int H, Plan* p) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto key = std::make_tuple(dev, x_bf16, w_bf16, B, D, H);
  std::lock_guard<std::mutex> lock(g_mu);
  const auto it = g_plans.find(key);
  if (it != g_plans.end()) {
    *p = it->second;
    return 0;
  }
  int code;
  if (!x_bf16 && !w_bf16) code = make_plan<float, float>(dev, B, D, H, p);
  else if (!x_bf16) code = make_plan<float, __nv_bfloat16>(dev, B, D, H, p);
  else if (!w_bf16) code = make_plan<__nv_bfloat16, float>(dev, B, D, H, p);
  else code = make_plan<__nv_bfloat16, __nv_bfloat16>(dev, B, D, H, p);
  if (code == 0) g_plans[key] = *p;
  return code;
}

template <typename TX, typename TW>
int launch(const Plan& p, const void* xg, const void* whh, const float* bias, const float* h0,
           const float* c0, const float* n0, const float* m0, float* hs, float* hN,
           float* cN, float* nN, float* mN, float* gS, float* cS, float* nS, float* mS,
           float* hbuf, int B, int S, int D, int H, cudaStream_t stream) {
  const TX* x = static_cast<const TX*>(xg);
  const TW* w = static_cast<const TW*>(whh);
  int J = p.J;
  cudaError_t e;
  if (p.variant == kCluster) {
    const int dh = D / H;
    const int vec_w = reinterpret_cast<uintptr_t>(whh) % 16 == 0 && dh * sizeof(TW) % 16 == 0;
    const int vec_x = reinterpret_cast<uintptr_t>(xg) % 16 == 0 && dh * sizeof(TX) % 16 == 0;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(p.blocks, p.cluster, kClusterThreads, p.smem, stream, &attr);
    e = B == 1 ? cudaLaunchKernelEx(&cfg, slstm_scan_cluster<TX, TW, 1>, x, w, bias, h0, c0,
                                    n0, m0, hs, hN, cN, nN, mN, gS, cS, nS, mS, B, S, D, H, J,
                                    vec_w, vec_x)
               : cudaLaunchKernelEx(&cfg, slstm_scan_cluster<TX, TW, kClusterRows>, x, w, bias,
                                    h0, c0, n0, m0, hs, hN, cN, nN, mN, gS, cS, nS, mS, B, S, D,
                                    H, J, vec_w, vec_x);
  } else {
    if (hbuf == nullptr) return -1;
    void* args[] = {&x,  &w,  &bias, &h0, &c0, &n0,   &m0, &hs, &hN, &cN, &nN, &mN,
                    &gS, &cS, &nS,   &mS, &hbuf, &B, &S,  &D,  &H,  &J};
    e = cudaLaunchCooperativeKernel((void*)slstm_scan_grid<TX, TW>, dim3(p.blocks),
                                    dim3(kThreads), args, p.smem, stream);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_bf16 / w_bf16: 0 = float32, 1 = bfloat16 for xg / w_hh.  The plan a
// call would take, into out[6]: variant (0 = cluster kernel, 1 = grid
// kernel), J hidden indices per block, blocks, cluster size (0 for the
// grid), dynamic shared memory per block in bytes, and how many clusters
// (grid: blocks) the card holds at once.  Returns 0, a cudaError_t, -1 for
// a bad shape, -2 when no grid of this shape can be resident, or -3 when
// the cluster cannot be scheduled.
extern "C" int slstm_scan_plan(int x_bf16, int w_bf16, int B, int D, int H, int* out) {
  if (B < 1 || H < 1 || D % H != 0) return -1;
  Plan p;
  const int code = get_plan(x_bf16, w_bf16, B, D, H, &p);
  if (code != 0) return code;
  out[0] = p.variant;
  out[1] = p.J;
  out[2] = p.blocks;
  out[3] = p.cluster;
  out[4] = static_cast<int>(p.smem);
  out[5] = p.active;
  return 0;
}

// gS, cS, nS, mS: null, or (B, S, 4D) f32 and (B, S, D) f32 each, into
// which the same launch writes every step's gates (as gate_step receives
// them, in xg's layout) and its c, n and m ("save" mode, for the backward
// kernel in slstm_scan_bwd.cu); hs and the final state are the same either
// way.  hbuf: scratch of 2 * B * D floats, used by the grid kernel only (may
// be null when the plan is the cluster kernel).  Returns 0, a cudaError_t,
// or the codes of slstm_scan_plan.
extern "C" int slstm_scan_fwd(const void* xg, const void* whh, const float* bias,
                              const float* h0, const float* c0, const float* n0,
                              const float* m0, float* hs, float* hN, float* cN, float* nN,
                              float* mN, float* gS, float* cS, float* nS, float* mS,
                              float* hbuf, int x_bf16, int w_bf16, int B, int S, int D, int H,
                              void* stream) {
  if (B < 1 || S < 1 || H < 1 || D % H != 0) return -1;
  Plan p;
  const int code = get_plan(x_bf16, w_bf16, B, D, H, &p);
  if (code != 0) return code;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SLSTM_FWD_ARGS \
  p, xg, whh, bias, h0, c0, n0, m0, hs, hN, cN, nN, mN, gS, cS, nS, mS, hbuf, B, S, D, H, st
  if (!x_bf16 && !w_bf16) return launch<float, float>(SLSTM_FWD_ARGS);
  if (!x_bf16) return launch<float, __nv_bfloat16>(SLSTM_FWD_ARGS);
  if (!w_bf16) return launch<__nv_bfloat16, float>(SLSTM_FWD_ARGS);
  return launch<__nv_bfloat16, __nv_bfloat16>(SLSTM_FWD_ARGS);
#undef SLSTM_FWD_ARGS
}

// `steps` grid barriers over a cooperative grid of `grid` blocks of 256
// threads: what S dependent steps cost the grid kernel before any arithmetic.
extern "C" int slstm_grid_sync_loop(int grid, int steps, void* stream) {
  if (grid < 1 || steps < 0) return -1;
  void* args[] = {&steps};
  const cudaError_t e = cudaLaunchCooperativeKernel((void*)grid_sync_loop, dim3(grid),
                                                    dim3(kThreads), args, 0,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// `steps` rounds of the cluster kernel's h exchange (`floats` f32 from each
// block to each of its `cluster` peers, a multiple of 4) and cluster
// barrier, over `clusters` clusters of 512 threads a block.
extern "C" int slstm_cluster_sync_loop(int cluster, int clusters, int floats, int steps,
                                       void* stream) {
  if (cluster < 1 || cluster > 16 || clusters < 1 || floats < 4 || floats % 4 || steps < 0)
    return -1;
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) {
    std::lock_guard<std::mutex> lock(g_mu);
    e = prepare(dev, (const void*)cluster_sync_loop, max_smem, true);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = 16 + (size_t)(2 * cluster + 1) * floats * 4;
  if (smem > (size_t)max_smem) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster * clusters, cluster, kClusterThreads,
                                                smem, static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, cluster_sync_loop, steps, floats);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
