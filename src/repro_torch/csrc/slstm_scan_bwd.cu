// Backward of the sLSTM time scan for Hopper (sm_90a): the whole reverse
// recurrence over S steps in one launch, as one thread-block cluster per
// (head, group of batch rows) where a cluster's shared memory holds the
// head's w_hh, else as one cooperative grid.
//
// Replaces no TPU kernel: the Pallas kernel `slstm_scan_kernel`
// (src/repro/kernels/slstm_scan/kernel.py) has no VJP, and the reference
// trains through `jax.grad` of its `fori_loop` (src/repro/models/xlstm.py).
// This kernel differentiates the function K5 (`csrc/slstm_scan.cu`)
// computes, step by step in reverse, with torch's derivative rules for
// `slstm_step` in kernels/slstm_scan/ref.py (`slstm_scan_bwd_ref` there is
// its plain version):
//   g_t = (xg_t + h_{t-1} . w_hh[head]) + b            (saved by K5)
//   dh  = dhs_t + dh carried;   so = sigmoid(o), nc = max(n_t, 1e-6)
//   do  = dh c_t / nc . so (1 - so);  dc += dh so / nc;  dn += -dh so c_t / nc^2 if n_t >= 1e-6
//   dz  = dc i' (1 - tanh^2 z);  df' = dc c_{t-1} + dn n_{t-1};  di' = dc tanh z + dn
//   dm  = dm carried - di' i' - df' f';  m = max(a, i), a = log sigmoid(f) + m_{t-1}: dm to
//         the larger, halved on a tie;  di = di' i' + dm [i > a];  da = df' f' + dm [a > i]
//   df  = da sigmoid(-f);  carried to t-1: dc f', dn f', dm_{t-1} = da,
//   dh_{t-1} = dg_t . w_hh[head]^T
// Every m-derivative is a product with f' or with an indicator, never a
// difference of infinities, so at m_{t-1} = -inf (the zero state's first
// step) f' = 0 and the step gives finite gradients and dm_{t-1} = 0, as
// autograd of the plain version does.  Built without --use_fast_math; the
// gate math (`gate_grad`, shared by both kernels) uses the accurate expf /
// log1pf / tanhf (it is short and off the product's path).
//
// K5's save mode writes every step's gates g_t (B, S, 4D) f32, exactly as
// its gate math received them, and c, n, m ((B, S, D) f32 each), so this
// kernel forms no gate again and reads no xg: one recurrent product a step
// is left on the chain.  It writes dg_t (B, S, 4D) f32 (and, for a bf16
// xg, its bf16 rounding: xg's gradient) and the initial state's gradients.
// dw_hh = sum_{b,t} h_{t-1}^T dg_t per head and db = sum dg are plain large
// products outside the recurrence: the wrapper takes them with torch.einsum
// / sum over this f32 dg (no TPU kernel computes them).
//
// What bounds it on the H100: the serial chain.  Step t needs all of dg_t
// of a head before dh_{t-1} exists, so the S steps are S dependent rounds
// that must meet across SMs; each round is one f32 product (2 R 4dh dh
// flops a head for R batch rows) and the exchange of its partial sums.
//
// Cluster kernel (`slstm_scan_bwd_cluster`), the forward's layout:
//  * the batch rows do not depend on each other, so each (head, group of R
//    rows) is one cluster of cs blocks (the smallest of 1, 2, 4, 8, 16
//    whose shared memory holds the head's w_hh: 16 blocks of 128 KiB at
//    full width in bf16), and the clusters never wait for each other: no
//    grid barrier, no cooperative launch, no atomics.  The plan takes as
//    many groups as the card holds clusters at once (at least enough that
//    R rows fit shared memory);
//  * block r owns J = dh / cs hidden indices (rounded up to a power of two,
//    at least 8, so a step divides by shifts): its (dh x 4J) slice of w_hh
//    stays in shared memory in w_hh's own dtype, in the forward's layout
//    (16-byte chunks of one gate's columns, k-major within a chunk), as do
//    the carried dc, dn, dm of its (row, index) pairs;
//  * each step: wait on the block's mbarrier for the cs partial sums of
//    dh_t, add them in rank order (a call repeats bit for bit), run the
//    gate math from the saved gates and c, n, m (copied a step ahead with
//    cp.async into a double buffer), keep dg_t in shared memory; barrier;
//    then the partial dh_{t-1} of the group's rows over all the head's
//    indices from the block's 4J columns (`cluster_product`), f32 FMAs on
//    the CUDA cores: two halves of the columns, 64 threads each (one warp
//    a scheduler), each thread a tile of up to 8 rows x 8 k in registers
//    (a block of 256 threads, so a thread may hold 255 registers); a
//    smaller tile loads more bytes of shared memory per FMA, and more warps
//    on the product ran slower on the H100.  Meanwhile the other 128
//    threads write dg_t (and dxg) to device memory and copy the next step's
//    stage.  Barrier; then the halves are added in order and each owner's
//    share goes to its shared memory as 16-byte st.async into its double
//    buffer, each store counting its bytes on the owner's mbarrier, as the
//    forward sends h.  Two block barriers a step and no cluster-wide one.
// Grid kernel (`slstm_scan_bwd_grid`), for what no cluster holds (f32 w_hh
// at full width: 4 MiB a head): one cooperative grid, block r of a head
// owning J hidden indices with its w slice in shared memory as f32; each
// step the gate math from the saved gates, a partial dh_{t-1} written to a
// double buffer in device memory, one grid barrier, the partials summed in
// block order.  It is refused (code -2), not hung, when the grid cannot be
// resident.  The choice follows the dtype of w_hh and the shape alone.
#include "common.cuh"
#include "mma.cuh"      // smem_u32, cp_async16, cp_async_commit, cp_async_wait
#include "cluster.cuh"  // cluster_rank/size/barrier, mbar_*, st_async_peer, cp_async4

#include <cooperative_groups.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;                 // both kernels
constexpr int kRows = 4;                      // grid product: batch rows per pass
constexpr int kClusterSizes[] = {1, 2, 4, 8, 16};

// The smallest power of two >= n, and at least 8.
__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 8;
  while (p < n) p *= 2;
  return p;
}
__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// The gate math's gradient for one (row, index) at one step, from the gates
// g (i, f, z, o), the state (c, n, m) after the step and (cp, np, mp) before
// it, and the gradient dht reaching h_t.  dc, dn, dm come in as the
// gradients carried from step t+1 and go out as those carried to t-1; dg
// gets the gates' gradients.
__device__ __forceinline__ void gate_grad(float gi, float gf, float gz, float go, float c,
                                          float n, float m, float cprev, float nprev,
                                          float mprev, float dht, float& dc, float& dn,
                                          float& dm, float (&dg)[4]) {
  const float logf_ = fminf(gf, 0.f) - log1pf(expf(-fabsf(gf)));   // log sigmoid(f)
  const float a = logf_ + mprev;
  const float ip = expf(gi - m), fp = expf(a - m);
  const float tz = tanhf(gz);
  const float so = 1.f / (1.f + expf(-go));
  const float nc = fmaxf(n, 1e-6f);
  const float dq = dht / nc;                                     // d(so c)
  const float dgo = dq * c * (so * (1.f - so));
  const float dcv = dc + dq * so;
  const float dnv = dn + (n >= 1e-6f ? -dht * ((so * c) / nc) / nc : 0.f);
  const float dfp = dcv * cprev + dnv * nprev;
  const float dip = dcv * tz + dnv;
  const float dgz = dcv * ip * (1.f - tz * tz);
  const float dxa = dfp * fp;                                    // through f' = exp(a - m)
  const float dgia = dip * ip;                                   // through i' = exp(i - m)
  const float dmv = dm - dgia - dxa;
  float da = dxa, dgi = dgia;
  if (a > gi) {
    da += dmv;
  } else if (a < gi) {
    dgi += dmv;
  } else {                                                       // a tie: half each
    da += 0.5f * dmv;
    dgi += 0.5f * dmv;
  }
  dg[0] = dgi;
  dg[1] = da / (1.f + expf(gf));                                 // d log sigmoid(f) = sigmoid(-f)
  dg[2] = dgz;
  dg[3] = dgo;
  dc = dcv * fp;
  dn = dnv * fp;
  dm = da;
}

// ---------------------------------------------------------------------------
// Grid kernel
// ---------------------------------------------------------------------------

// Partial sums buffer (floats): nq threads an item over the head's blocks.
__host__ __device__ __forceinline__ int red_floats(int B, int J) {
  return B * J > kThreads ? B * J : kThreads;
}

// Shared memory of one grid block (all f32): the w slice (dh x (4J + 1),
// rows padded by one float so the threads that walk neighbouring rows, a k
// each, read different banks), the gates' gradients (B x 4J), the partial
// sums, and the recurrent dh and the carried dc, dn, dm (B x J each).
__host__ __device__ size_t grid_smem(int B, int dh, int J) {
  const size_t W = 4 * (size_t)J;
  return 4 * ((size_t)dh * (W + 1) + (size_t)B * W + red_floats(B, J) + 4 * (size_t)B * J);
}

template <typename TW>
__global__ void __launch_bounds__(kThreads, 1)
slstm_scan_bwd_grid(const TW* __restrict__ whh, const float* __restrict__ c0,
                    const float* __restrict__ n0, const float* __restrict__ m0,
                    const float* __restrict__ gs, const float* __restrict__ cs,
                    const float* __restrict__ ns, const float* __restrict__ ms,
                    const float* __restrict__ dhs, const float* __restrict__ dhT,
                    const float* __restrict__ dcT, const float* __restrict__ dnT,
                    const float* __restrict__ dmT, float* __restrict__ dg,
                    float* __restrict__ dh0, float* __restrict__ dc0, float* __restrict__ dn0,
                    float* __restrict__ dm0, __nv_bfloat16* __restrict__ dxg, float* pbuf, int B,
                    int S, int D, int H, int J) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem_f[];
  const int dh = D / H, W = 4 * J, Wp = W + 1;
  const int per_head = (dh + J - 1) / J;
  const int head = blockIdx.x / per_head, j0 = (blockIdx.x % per_head) * J;
  const int tid = threadIdx.x, BJ = B * J;

  float* w_s = smem_f;                        // w_s[k * Wp + col]
  float* dg_s = w_s + (size_t)dh * Wp;        // dg_s[b * W + col]
  float* red = dg_s + (size_t)B * W;
  float* dhr = red + red_floats(B, J);        // recurrent dh of the block's indices
  float* dc_s = dhr + BJ;
  float* dn_s = dc_s + BJ;
  float* dm_s = dn_s + BJ;

  // column col = g J + jl of the slice is gate g of index j0 + jl; past dh: 0
  const TW* wh = whh + (size_t)head * dh * 4 * dh;
  for (int i = tid; i < dh * W; i += kThreads) {
    const int k = i / W, col = i % W, g = col / J, j = j0 + col % J;
    w_s[k * Wp + col] = j < dh ? to_f32(wh[(size_t)k * 4 * dh + g * dh + j]) : 0.f;
  }
  for (int i = tid; i < BJ; i += kThreads) {
    const int b = i / J, j = j0 + i % J;
    const size_t o = (size_t)b * D + head * dh + j;
    const bool in = j < dh;
    dhr[i] = in && dhT ? dhT[o] : 0.f;
    dc_s[i] = in && dcT ? dcT[o] : 0.f;
    dn_s[i] = in && dnT ? dnT[o] : 0.f;
    dm_s[i] = in && dmT ? dmT[o] : 0.f;
  }
  __syncthreads();

  const int nq = BJ >= kThreads ? 1 : min(per_head, kThreads / BJ);   // partial sums a item
  const size_t pstride = (size_t)B * dh;      // one block's partials

  for (int t = S - 1; t >= 0; --t) {
    // the gate math's gradient for each (row, index) of the block
    for (int i = tid; i < BJ; i += kThreads) {
      const int b = i / J, jl = i % J, j = j0 + jl;
      float* dgr = dg_s + b * W + jl;
      if (j >= dh) {
        dgr[0] = dgr[J] = dgr[2 * J] = dgr[3 * J] = 0.f;
        continue;
      }
      const size_t ot = ((size_t)b * S + t) * D + head * dh + j;
      const size_t op = t > 0 ? ot - D : (size_t)b * D + head * dh + j;
      const float* g = gs + ((size_t)b * S + t) * 4 * D + (size_t)head * 4 * dh + j;
      float d[4], dc = dc_s[i], dn = dn_s[i], dm = dm_s[i];
      gate_grad(g[0], g[dh], g[2 * dh], g[3 * dh], cs[ot], ns[ot], ms[ot],
                (t > 0 ? cs : c0)[op], (t > 0 ? ns : n0)[op], (t > 0 ? ms : m0)[op],
                dhs[ot] + dhr[i], dc, dn, dm, d);
      dc_s[i] = dc;
      dn_s[i] = dn;
      dm_s[i] = dm;
      const size_t o = ((size_t)b * S + t) * 4 * D + (size_t)head * 4 * dh + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dgr[q * J] = d[q];
        dg[o + q * dh] = d[q];
        if (dxg) dxg[o + q * dh] = __float2bfloat16(d[q]);
      }
    }
    __syncthreads();

    // partial dh_{t-1}[b][k] over every k of the head, from this block's 4J
    // columns, into buffer t & 1 (read by the head's blocks after the barrier)
    float* pout = pbuf + ((size_t)(t & 1) * gridDim.x + blockIdx.x) * pstride;
    const int nr = (B + kRows - 1) / kRows;
    for (int idx = tid; idx < dh * nr; idx += kThreads) {
      const int k = idx % dh, r0 = (idx / dh) * kRows;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      const float* wr = w_s + k * Wp;
      for (int c = 0; c < W; c += 4) {
        const float w0 = wr[c], w1 = wr[c + 1], w2 = wr[c + 2], w3 = wr[c + 3];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r0 + r < B) {
            const float4 gv = *reinterpret_cast<const float4*>(&dg_s[(r0 + r) * W + c]);
            acc[r] = fmaf(gv.x, w0, acc[r]);
            acc[r] = fmaf(gv.y, w1, acc[r]);
            acc[r] = fmaf(gv.z, w2, acc[r]);
            acc[r] = fmaf(gv.w, w3, acc[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r0 + r < B) pout[(size_t)(r0 + r) * dh + k] = acc[r];
    }
    grid.sync();                              // every block's partials are written

    // dh_{t-1} of the block's indices: the head's partials summed in block
    // order, nq threads an item over strided blocks, then their sums in order
    const float* pin = pbuf + ((size_t)(t & 1) * gridDim.x + (size_t)head * per_head) * pstride;
    for (int idx = tid; idx < BJ * nq; idx += kThreads) {
      const int item = idx % BJ, qp = idx / BJ, b = item / J, j = j0 + item % J;
      float s = 0.f;
      if (j < dh)
        for (int q = qp; q < per_head; q += nq) s += __ldcg(pin + q * pstride + b * dh + j);
      red[qp * BJ + item] = s;
    }
    __syncthreads();
    for (int i = tid; i < BJ; i += kThreads) {
      float s = 0.f;
      for (int qp = 0; qp < nq; ++qp) s += red[qp * BJ + i];
      if (t > 0) {
        dhr[i] = s;
      } else {
        const int b = i / J, j = j0 + i % J;
        if (j < dh) {
          const size_t o = (size_t)b * D + head * dh + j;
          dh0[o] = s;
          dc0[o] = dc_s[i];
          dn0[o] = dn_s[i];
          dm0[o] = dm_s[i];
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Cluster kernel
// ---------------------------------------------------------------------------

// Floats of one step's stage for the R J (row, index) pairs: the four gates,
// dhs, and c, n, m before the step.
constexpr int kStage = 8;
constexpr int kCThreads = 256;                // cluster kernel
constexpr int kParts = 2;                     // product: halves of the block's columns ...
constexpr int kPartThreads = 64;              // ... 64 threads each ...
constexpr int kThreadK = 8;                   // ... each with 8 indices k
constexpr int kProductThreads = kParts * kPartThreads;   // the rest copy meanwhile

// Rows of one pass of the product: the smallest power of two that covers R,
// at most 8.
__host__ __device__ __forceinline__ int pass_rows(int R) {
  int rb = 1;
  while (rb < R && rb < 8) rb *= 2;
  return rb;
}

// Shared memory of one cluster block (R rows, Rp of them padded to the
// product's pass, W = 4J gate columns, K = cs J indices of the head): two
// barriers (16 bytes), the w slice (dh x 4J, TW), then f32: the partials'
// double buffer (2 x cs x R x J), the stage's double buffer (2 x 8 x R x J),
// c, n, m after the step and the carried dc, dn, dm (R x J each), the gates'
// gradients' double buffer (2 x Rp x 4J) and the product's two half sums
// (2 x Rp x K).
__host__ __device__ size_t cluster_smem(int R, int Rp, int dh, int J, int cs, int w_bytes) {
  const size_t RJ = (size_t)R * J, W = 4 * (size_t)J, K = (size_t)cs * J;
  return 16 + align16((size_t)dh * W * w_bytes) +
         4 * (2 * cs * RJ + 2 * kStage * RJ + 6 * RJ + 2 * (size_t)Rp * W + 2 * (size_t)Rp * K);
}

// Element e of 16 bytes of w as f32 (8 bf16, the low half of each word
// first, or 4 f32); e is a constant once the caller's loops are unrolled.
template <typename TW>
__device__ __forceinline__ float w_at(const uint4& v, int e) {
  const int word = e / (4 / sizeof(TW));
  const unsigned u = word == 0 ? v.x : word == 1 ? v.y : word == 2 ? v.z : v.w;
  if constexpr (sizeof(TW) == 2) return __uint_as_float(e & 1 ? u & 0xffff0000u : u << 16);
  return __uint_as_float(u);
}

// red[h][r][k] = the block's partial dh_{t-1}[r][k] over half h of its 4J
// columns, for every k < K (0 past dh).  Half h is summed by 64 threads
// (one warp a scheduler of the SM), thread q keeping a tile of RB rows x 8
// k (k = q + 64 i) in registers: per 16-byte chunk of V columns it loads 8
// chunks of w (the lanes of a warp read 32 neighbouring ones) and RB V / 4
// runs of dg (16-byte broadcasts), unpacks each w once and does 8 RB FMAs
// with it: 64 independent sums keep the FMA pipe fed from one warp, and
// shared memory delivers 0.75 bytes an FMA, below what the pipes take.
// Run by the block's first kProductThreads threads.
template <typename TW, int RB>
__device__ __forceinline__ void cluster_product(const TW* w_s, const float* dg_s, float* red,
                                                int dh, int K, int W, int Rp) {
  constexpr int V = 16 / sizeof(TW);
  const int part = threadIdx.x / kPartThreads, q = threadIdx.x % kPartThreads;
  const int nch = W / V / kParts, cb = part * nch;
  const uint4* w4 = reinterpret_cast<const uint4*>(w_s);
  float* rh = red + (size_t)part * Rp * K;
  for (int kb = 0; kb < K; kb += kThreadK * kPartThreads) {
    for (int r0 = 0; r0 < Rp; r0 += RB) {
      float a[RB][kThreadK];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int i = 0; i < kThreadK; ++i) a[r][i] = 0.f;
      for (int c = cb; c < cb + nch; ++c) {
        uint4 wv[kThreadK];
#pragma unroll
        for (int i = 0; i < kThreadK; ++i) {
          const int k = kb + q + i * kPartThreads;
          wv[i] = k < dh ? w4[(size_t)c * dh + k] : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int e4 = 0; e4 < V / 4; ++e4) {
          float4 g[RB];
#pragma unroll
          for (int r = 0; r < RB; ++r)
            g[r] = *reinterpret_cast<const float4*>(dg_s + (size_t)(r0 + r) * W + c * V +
                                                    4 * e4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {     // column c V + 4 e4 + e
            float w[kThreadK];
#pragma unroll
            for (int i = 0; i < kThreadK; ++i) w[i] = w_at<TW>(wv[i], 4 * e4 + e);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              const float gv = e == 0 ? g[r].x : e == 1 ? g[r].y : e == 2 ? g[r].z : g[r].w;
#pragma unroll
              for (int i = 0; i < kThreadK; ++i) a[r][i] = fmaf(gv, w[i], a[r][i]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kThreadK; ++i) {
        const int k = kb + q + i * kPartThreads;
        if (k < K)
#pragma unroll
          for (int r = 0; r < RB; ++r) rh[(size_t)(r0 + r) * K + k] = a[r][i];
      }
    }
  }
}

// Step t's stage (the block's pairs: gates, dhs, and c, n, m of step t - 1,
// or the initial state at t = 0) into `st`, asynchronously, and committed,
// by `count` threads from `first` on.  J is a power of two (lj its log).
__device__ __forceinline__ void load_stage(float* st, const float* __restrict__ gs,
                                           const float* __restrict__ dhs,
                                           const float* __restrict__ cs,
                                           const float* __restrict__ ns,
                                           const float* __restrict__ ms,
                                           const float* __restrict__ c0,
                                           const float* __restrict__ n0,
                                           const float* __restrict__ m0, int t, int b0, int R,
                                           int B, int S, int D, int dh, int head, int j0,
                                           int lj, int first, int count) {
  const int RJ = R << lj;
  for (int i = threadIdx.x - first; i < RJ; i += count) {
    const int b = b0 + (i >> lj), j = j0 + (i & ((1 << lj) - 1));
    if (b >= B || j >= dh) continue;
    const size_t ot = ((size_t)b * S + t) * D + head * dh + j;
    const float* g = gs + ((size_t)b * S + t) * 4 * D + (size_t)head * 4 * dh + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) cp_async4(&st[q * RJ + i], g + q * dh);
    cp_async4(&st[4 * RJ + i], dhs + ot);
    const size_t op = t > 0 ? ot - D : (size_t)b * D + head * dh + j;
    cp_async4(&st[5 * RJ + i], (t > 0 ? cs : c0) + op);
    cp_async4(&st[6 * RJ + i], (t > 0 ? ns : n0) + op);
    cp_async4(&st[7 * RJ + i], (t > 0 ? ms : m0) + op);
  }
  cp_async_commit();
}

template <typename TW, int RB>
__global__ void __launch_bounds__(kCThreads, 1)
slstm_scan_bwd_cluster(const TW* __restrict__ whh, const float* __restrict__ c0,
                       const float* __restrict__ n0, const float* __restrict__ m0,
                       const float* __restrict__ gs, const float* __restrict__ cs,
                       const float* __restrict__ ns, const float* __restrict__ ms,
                       const float* __restrict__ dhs, const float* __restrict__ dhT,
                       const float* __restrict__ dcT, const float* __restrict__ dnT,
                       const float* __restrict__ dmT, float* __restrict__ dg,
                       float* __restrict__ dh0, float* __restrict__ dc0,
                       float* __restrict__ dn0, float* __restrict__ dm0,
                       __nv_bfloat16* __restrict__ dxg, int B, int S, int D, int H, int J, int R,
                       int vec_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = 16 / sizeof(TW);
  const unsigned csz = cluster_size(), rank = cluster_rank();
  const int lj = __ffs(J) - 1;                // J is a power of two
  const int dh = D / H, W = 4 * J, K = csz * J, RJ = R * J;
  const int lw = lj + 2, lk4 = lj + __ffs(csz) - 3;   // logs of W and K / 4
  const int Rp = (R + RB - 1) / RB * RB;     // RB = pass_rows(R)
  const int cluster = blockIdx.x / csz, groups = (B + R - 1) / R;
  const int head = cluster / groups, b0 = (cluster % groups) * R, j0 = rank * J;
  const int tid = threadIdx.x;

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // bar[n & 1]: round n has landed
  TW* w_s = reinterpret_cast<TW*>(smem + 16);          // w_s[(c dh + k) V + e]
  float* pb = reinterpret_cast<float*>(smem + 16 + align16((size_t)dh * W * sizeof(TW)));
  float* st = pb + (size_t)2 * csz * RJ;       // st[buf][q][i]: the stage of step t, buf t & 1
  float* cur = st + (size_t)2 * kStage * RJ;   // c, n, m after the step
  float* car = cur + 3 * RJ;                   // dc, dn, dm carried
  float* dgb = car + 3 * RJ;                   // dg of step t, dgb[t & 1][r][col]
  float* red = dgb + (size_t)2 * Rp * W;       // red[h][r][k]

  // Round n (n = 0 .. S-1) carries the partials of dh_{S-2-n}, sent at step
  // S-1-n and read at step S-2-n (the last, dh_{-1}, is dh0), into buffer and
  // barrier n & 1 of every owner, each block's R x J floats at pb[n & 1][rank].
  const unsigned round_bytes = csz * RJ * 4;
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(&bar[0], round_bytes);
    if (S > 1) mbar_expect(&bar[1], round_bytes);
  }
  // w slice: chunk c (16 bytes: V block columns) holds columns [cV, cV + V)
  // for every k, at w_s[(c dh + k) V]; columns past dh are 0
  {
    const TW* wh = whh + (size_t)head * dh * 4 * dh;
    const int nc = W / V;
    for (int i = tid; i < nc * dh; i += kCThreads) {
      const int c = i / dh, k = i - c * dh;
      TW* dst = w_s + (size_t)i * V;
      if (vec_w) {
        const int g = c * V / J, j = j0 + c * V - g * J;
        cp_async16(smem_u32(dst), j < dh ? wh + (size_t)k * 4 * dh + g * dh + j : wh, j < dh);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int col = c * V + e, g = col / J, j = j0 + col - g * J;
          dst[e] = j < dh ? wh[(size_t)k * 4 * dh + g * dh + j] : from_f32<TW>(0.f);
        }
      }
    }
  }
  for (int i = tid; i < RJ; i += kCThreads) {
    const int b = b0 + (i >> lj), j = j0 + (i & (J - 1));
    const bool in = b < B && j < dh;
    const size_t o = (size_t)b * D + head * dh + j;
    const size_t ot = ((size_t)b * S + S - 1) * D + head * dh + j;
    car[i] = in && dcT ? dcT[o] : 0.f;
    car[RJ + i] = in && dnT ? dnT[o] : 0.f;
    car[2 * RJ + i] = in && dmT ? dmT[o] : 0.f;
    cur[i] = in ? cs[ot] : 0.f;
    cur[RJ + i] = in ? ns[ot] : 0.f;
    cur[2 * RJ + i] = in ? ms[ot] : 0.f;
  }
  for (int i = tid; i < 2 * Rp * W; i += kCThreads) dgb[i] = 0.f;   // rows past R stay 0
  load_stage(st + (size_t)((S - 1) & 1) * kStage * RJ, gs, dhs, cs, ns, ms, c0, n0, m0, S - 1,
             b0, R, B, S, D, dh, head, j0, lj, 0, kCThreads);   // commits the w slice too
  cp_async_wait<0>();
  cluster_barrier();                          // every peer has started and set its barriers

  for (int t = S - 1; t >= 0; --t) {
    const int nread = S - 2 - t, nsend = S - 1 - t;   // the rounds read and sent
    if (t < S - 1) {
      mbar_wait(&bar[nread & 1], (nread >> 1) & 1);
      if (tid == 0 && nread + 2 <= S - 1) mbar_expect(&bar[nread & 1], round_bytes);
    }

    const float* sg = st + (size_t)(t & 1) * kStage * RJ;
    const float* pin = pb + (size_t)(nread & 1) * csz * RJ;
    float* dgt = dgb + (size_t)(t & 1) * Rp * W;
    for (int i = tid; i < RJ; i += kCThreads) {
      const int r = i >> lj, b = b0 + r, jl = i & (J - 1), j = j0 + jl;
      if (b >= B || j >= dh) continue;        // their dg stays 0
      float rec = 0.f;
      if (t < S - 1) {
#pragma unroll 4
        for (unsigned p = 0; p < csz; ++p) rec += pin[(size_t)p * RJ + i];   // in rank order
      } else if (dhT) {
        rec = dhT[(size_t)b * D + head * dh + j];
      }
      float d[4], dc = car[i], dn = car[RJ + i], dm = car[2 * RJ + i];
      gate_grad(sg[i], sg[RJ + i], sg[2 * RJ + i], sg[3 * RJ + i], cur[i], cur[RJ + i],
                cur[2 * RJ + i], sg[5 * RJ + i], sg[6 * RJ + i], sg[7 * RJ + i],
                sg[4 * RJ + i] + rec, dc, dn, dm, d);
      car[i] = dc;
      car[RJ + i] = dn;
      car[2 * RJ + i] = dm;
      cur[i] = sg[5 * RJ + i];                // step t-1's state, after it
      cur[RJ + i] = sg[6 * RJ + i];
      cur[2 * RJ + i] = sg[7 * RJ + i];
#pragma unroll
      for (int q = 0; q < 4; ++q) dgt[(r << lw) + (q << lj) + jl] = d[q];
    }
    __syncthreads();                          // dg_t is whole
    if (tid < kProductThreads) {
      cluster_product<TW, RB>(w_s, dgt, red, dh, K, W, Rp);
    } else {
      // meanwhile, off the chain: step t's dg (and dxg) to device memory,
      // and the copy of step t-1's stage, complete before the barrier
      const size_t base = (size_t)t * 4 * D + (size_t)head * 4 * dh + j0;
      for (int idx = tid - kProductThreads; idx < R << lw; idx += kCThreads - kProductThreads) {
        const int r = idx >> lw, g = (idx >> lj) & 3, j = idx & (J - 1), b = b0 + r;
        if (b < B && j0 + j < dh) {
          const size_t o = base + (size_t)b * S * 4 * D + g * dh + j;
          dg[o] = dgt[idx];
          if (dxg) dxg[o] = __float2bfloat16(dgt[idx]);
        }
      }
      if (t > 0)
        load_stage(st + (size_t)((t - 1) & 1) * kStage * RJ, gs, dhs, cs, ns, ms, c0, n0, m0,
                   t - 1, b0, R, B, S, D, dh, head, j0, lj, kProductThreads,
                   kCThreads - kProductThreads);
      cp_async_wait<0>();
    }
    __syncthreads();                          // red and the next stage are whole

    // the two halves added in order; each owner's 4 neighbouring indices of
    // a row as one 16-byte st.async into its buffer nsend & 1
    float* dst = pb + ((size_t)(nsend & 1) * csz + rank) * RJ;
    for (int idx = tid; idx < R << lk4; idx += kCThreads) {
      const int r = idx >> lk4, k = (idx & ((1 << lk4) - 1)) << 2;
      const float4 x = *reinterpret_cast<const float4*>(red + (size_t)r * K + k);
      const float4 y = *reinterpret_cast<const float4*>(red + ((size_t)Rp + r) * K + k);
      st_async_peer(dst + (r << lj) + (k & (J - 1)), &bar[nsend & 1], k >> lj,
                    make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w));
    }
  }

  // round S-1: dh0, summed in rank order; and the carried dc, dn, dm
  mbar_wait(&bar[(S - 1) & 1], ((S - 1) >> 1) & 1);
  const float* pin = pb + (size_t)((S - 1) & 1) * csz * RJ;
  for (int i = tid; i < RJ; i += kCThreads) {
    const int b = b0 + (i >> lj), j = j0 + (i & (J - 1));
    if (b >= B || j >= dh) continue;
    float s = 0.f;
    for (unsigned p = 0; p < csz; ++p) s += pin[(size_t)p * RJ + i];
    const size_t o = (size_t)b * D + head * dh + j;
    dh0[o] = s;
    dc0[o] = car[i];
    dn0[o] = car[RJ + i];
    dm0[o] = car[2 * RJ + i];
  }
}

// ---------------------------------------------------------------------------
// Plans, cached on the host
// ---------------------------------------------------------------------------

enum Variant { kCluster = 0, kGrid = 1 };

struct Plan {
  int variant, J, blocks, cluster, rows, active;   // active: co-resident clusters (grid: blocks)
  size_t smem;
};

std::mutex g_mu;
std::map<std::tuple<int, int, int, int, int>, Plan> g_plans;

template <typename TW>
const void* cluster_kernel(int R) {
  switch (pass_rows(R)) {
    case 1: return (const void*)slstm_scan_bwd_cluster<TW, 1>;
    case 2: return (const void*)slstm_scan_bwd_cluster<TW, 2>;
    case 4: return (const void*)slstm_scan_bwd_cluster<TW, 4>;
    default: return (const void*)slstm_scan_bwd_cluster<TW, 8>;
  }
}

__host__ size_t cluster_smem_rows(int R, int dh, int J, int cs, int w_bytes) {
  const int RB = pass_rows(R);
  return cluster_smem(R, (R + RB - 1) / RB * RB, dh, J, cs, w_bytes);
}

// The cluster kernel where a cluster's shared memory holds the head's w_hh
// (the smallest such cluster; then as many groups of rows as the card holds
// clusters of it at once, and at least enough that a group's rows fit),
// else the grid kernel.  Returns 0, a cudaError_t, -2 when no grid of this
// shape can be resident, or -3 when the cluster cannot be scheduled.
// Called under g_mu.
template <typename TW>
int make_plan(int dev, int B, int D, int H, Plan* p) {
  const int dh = D / H;
  int sms = 0, max_smem = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int wb = sizeof(TW);
  for (int cs : kClusterSizes) {
    const int J = pow2_at_least((dh + cs - 1) / cs);
    if (cluster_smem_rows(1, dh, J, cs, wb) > (size_t)max_smem) continue;
    int rmax = 1;
    while (rmax < B && cluster_smem_rows(rmax + 1, dh, J, cs, wb) <= (size_t)max_smem) ++rmax;
    const int fit = (B + rmax - 1) / rmax;    // the fewest groups whose rows fit
    int R = (B + fit - 1) / fit, groups = (B + R - 1) / R;
    size_t smem = cluster_smem_rows(R, dh, J, cs, wb);
    const void* kernel = cluster_kernel<TW>(R);
    e = prepare(dev, kernel, max_smem, true);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(H * groups * cs, cs, kCThreads, smem, 0, &attr);
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (active < 1) return -3;
    const int fill = B < active / H ? B : active / H;   // groups that fill the card's clusters
    if (fill > groups) {
      R = (B + fill - 1) / fill;
      groups = (B + R - 1) / R;
      smem = cluster_smem_rows(R, dh, J, cs, wb);
      e = prepare(dev, cluster_kernel<TW>(R), max_smem, true);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    *p = {kCluster, J, H * groups * cs, cs, R, active, smem};
    return 0;
  }
  // 16 indices per block first (128 blocks at full width); then fewer,
  // larger blocks if the grid is too large, or smaller ones if shared
  // memory is short
  const void* kernel = (const void*)slstm_scan_bwd_grid<TW>;
  e = prepare(dev, kernel, max_smem, false);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int J : {16, 32, 8, 64}) {
    if (4 * J > kThreads) continue;
    const size_t smem = grid_smem(B, dh, J);
    if (smem > (size_t)max_smem) continue;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int grid = H * ((dh + J - 1) / J);
    if (grid <= per_sm * sms) {
      *p = {kGrid, J, grid, 0, B, per_sm * sms, smem};
      return 0;
    }
  }
  return -2;
}

int get_plan(int w_bf16, int B, int D, int H, Plan* p) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto key = std::make_tuple(dev, w_bf16, B, D, H);
  std::lock_guard<std::mutex> lock(g_mu);
  const auto it = g_plans.find(key);
  if (it != g_plans.end()) {
    *p = it->second;
    return 0;
  }
  const int code = w_bf16 ? make_plan<__nv_bfloat16>(dev, B, D, H, p)
                          : make_plan<float>(dev, B, D, H, p);
  if (code == 0) g_plans[key] = *p;
  return code;
}

template <typename TW>
int launch(const Plan& p, const void* whh, const float* c0, const float* n0, const float* m0,
           const float* gs, const float* cs, const float* ns, const float* ms,
           const float* dhs, const float* dhT, const float* dcT, const float* dnT,
           const float* dmT, float* dg, float* dh0, float* dc0, float* dn0, float* dm0,
           void* dxg_, float* pbuf, int B, int S, int D, int H, cudaStream_t stream) {
  __nv_bfloat16* dxg = static_cast<__nv_bfloat16*>(dxg_);
  const TW* w = static_cast<const TW*>(whh);
  int J = p.J;
  cudaError_t e;
  if (p.variant == kCluster) {
    constexpr int V = 16 / sizeof(TW);
    const int dh = D / H, R = p.rows;
    const int vec_w = reinterpret_cast<uintptr_t>(whh) % 16 == 0 && dh % V == 0 && J % V == 0;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(p.blocks, p.cluster, kCThreads, p.smem, stream, &attr);
#define SLSTM_BWD_CLUSTER(RB)                                                                  \
  cudaLaunchKernelEx(&cfg, slstm_scan_bwd_cluster<TW, RB>, w, c0, n0, m0, gs, cs, ns, ms, dhs, \
                     dhT, dcT, dnT, dmT, dg, dh0, dc0, dn0, dm0, dxg, B, S, D, H, J, R, vec_w)
    switch (pass_rows(R)) {
      case 1: e = SLSTM_BWD_CLUSTER(1); break;
      case 2: e = SLSTM_BWD_CLUSTER(2); break;
      case 4: e = SLSTM_BWD_CLUSTER(4); break;
      default: e = SLSTM_BWD_CLUSTER(8); break;
    }
#undef SLSTM_BWD_CLUSTER
  } else {
    if (pbuf == nullptr) return -1;
    void* args[] = {&w,   &c0,  &n0,  &m0,  &gs,  &cs,   &ns,  &ms, &dhs, &dhT, &dcT, &dnT,
                    &dmT, &dg,  &dh0, &dc0, &dn0, &dm0, &dxg, &pbuf, &B, &S,  &D,   &H,   &J};
    e = cudaLaunchCooperativeKernel((const void*)slstm_scan_bwd_grid<TW>, dim3(p.blocks),
                                    dim3(kThreads), args, p.smem, stream);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w_bf16: 0 = float32, 1 = bfloat16 for w_hh.  The plan a call would take,
// into out[7]: variant (0 = cluster kernel, 1 = grid kernel), J hidden
// indices per block, blocks, cluster size (0 for the grid), batch rows per
// cluster (the grid: B), dynamic shared memory per block in bytes, and how
// many clusters (grid: blocks) the card holds at once.  Returns 0, a
// cudaError_t, -1 for a bad shape, -2 when no grid of this shape can be
// resident, or -3 when the cluster cannot be scheduled.
extern "C" int slstm_scan_bwd_plan(int w_bf16, int B, int D, int H, int* out) {
  if (B < 1 || H < 1 || D % H != 0) return -1;
  Plan p;
  const int code = get_plan(w_bf16, B, D, H, &p);
  if (code != 0) return code;
  out[0] = p.variant;
  out[1] = p.J;
  out[2] = p.blocks;
  out[3] = p.cluster;
  out[4] = p.rows;
  out[5] = static_cast<int>(p.smem);
  out[6] = p.active;
  return 0;
}

// gs (B, S, 4D), cs, ns, ms (B, S, D): K5's saved gates and states, f32.
// dhT, dcT, dnT, dmT may be null (a zero cotangent on the final state).
// pbuf: scratch of 2 * blocks * B * (D / H) floats for the grid kernel (may
// be null when the plan is the cluster kernel).  Writes dg (B, S, 4D) and
// dh0, dc0, dn0, dm0 (B, D), all f32, and, unless dxg is null, dg rounded
// to bf16 into dxg (B, S, 4D) (xg's gradient when xg is bf16).  Returns 0,
// a cudaError_t, or the codes of slstm_scan_bwd_plan.
extern "C" int slstm_scan_bwd(const void* whh, const float* c0, const float* n0,
                              const float* m0, const float* gs, const float* cs,
                              const float* ns, const float* ms, const float* dhs,
                              const float* dhT, const float* dcT, const float* dnT,
                              const float* dmT, float* dg, float* dh0, float* dc0, float* dn0,
                              float* dm0, void* dxg, float* pbuf, int w_bf16, int B, int S,
                              int D, int H, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D % H != 0) return -1;
  Plan p;
  const int code = get_plan(w_bf16, B, D, H, &p);
  if (code != 0) return code;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SLSTM_BWD_ARGS                                                                        \
  p, whh, c0, n0, m0, gs, cs, ns, ms, dhs, dhT, dcT, dnT, dmT, dg, dh0, dc0, dn0, dm0, dxg, pbuf, \
      B, S, D, H, st
  if (w_bf16) return launch<__nv_bfloat16>(SLSTM_BWD_ARGS);
  return launch<float>(SLSTM_BWD_ARGS);
#undef SLSTM_BWD_ARGS
}
