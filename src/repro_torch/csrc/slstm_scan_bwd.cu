// Backward of the sLSTM time scan for Hopper (sm_90a): the whole reverse
// recurrence over S steps in one cooperative launch.
//
// Replaces no TPU kernel: the Pallas kernel `slstm_scan_kernel`
// (src/repro/kernels/slstm_scan/kernel.py) has no VJP, and the reference
// trains through `jax.grad` of its `fori_loop` (src/repro/models/xlstm.py).
// This kernel differentiates the function K5 (`csrc/slstm_scan.cu`)
// computes, step by step in reverse, with torch's derivative rules for
// `slstm_step` in kernels/slstm_scan/ref.py (`slstm_scan_bwd_ref` there is
// its plain version):
//   g_t = (xg_t + h_{t-1} . w_hh[head]) + b            (recomputed here)
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
// gate math uses the accurate expf / log1pf / tanhf (it is off the products'
// path and short).
//
// The forward saves c, n and m of every step ((B, S, D) f32 each, K5's
// "save" mode); this kernel recomputes only the gates g_t, from hs.  It
// writes dg_t (B, S, 4D) f32 and the initial state's gradients.  dw_hh =
// sum_{b,t} h_{t-1}^T dg_t per head and db = sum dg are plain large
// products outside the recurrence: the wrapper takes them with
// torch.einsum / sum over this f32 dg (no TPU kernel computes them).
//
// What bounds it on the H100: the serial chain, as in the forward.  Step t
// needs all of dg_t of a head before dh_{t-1} exists, so the S steps are S
// dependent rounds that must meet across SMs; the products (2 x 2 B 4D dh
// flops a step: the recomputed gates and dh_{t-1}) are small.  This is the
// simple design: one cooperative grid for both dtypes (as the forward's
// `slstm_scan_grid`), blocks of 512 threads, block r of a head owning J
// hidden indices (its 4J gate columns):
//  * its (dh x 4J) slice of w_hh stays in shared memory for all S steps as
//    f32, rows padded by one float, so the gates' product (threads over the
//    columns) and dh's product (threads over the rows) both read it without
//    bank conflicts;
//  * each step: load h_{t-1} of the head, recompute the block's gates, run
//    the gate math for its (row, index) pairs, then a partial dh_{t-1} over
//    every index of the head from its own 4J columns, written to a double
//    buffer in device memory; one grid barrier; then each block sums the
//    partials for its J indices over the head's blocks in block order
//    (deterministic: no atomics; a call repeats bit for bit).
// It is refused (code -2), not hung, when the grid cannot be resident.
// The products run on CUDA cores in f32.  A faster design (the forward's
// cluster layout with the partials passed by distributed shared memory,
// tensor cores for the products) is later work.
#include "common.cuh"

#include <cooperative_groups.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 4;                      // batch rows per pass of a product

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }

// Partial sums buffer (floats): the gates' product keeps parts x kRows x W,
// the partials' reduction up to kThreads (or B J, when that is more).
__host__ __device__ __forceinline__ int red_floats(int B, int J) {
  const int W = 4 * J, parts = kThreads / W;
  int n = parts * kRows * W;
  if (n < kThreads) n = kThreads;
  if (n < B * J) n = B * J;
  return n;
}

// Shared memory of one block (all f32): the w slice (dh x (4J + 1)), h_{t-1}
// of the head (B x dh; dh is a multiple of 4, so its rows are 16-byte
// aligned), the gates and their gradients (B x 4J each), the partial sums,
// the recurrent dh and the carried dc, dn, dm (B x J each), and the bias.
__host__ __device__ size_t bwd_smem(int B, int dh, int J) {
  const size_t W = 4 * (size_t)J;
  return 4 * ((size_t)dh * (W + 1) + (size_t)B * dh + 2 * (size_t)B * W +
              red_floats(B, J) + 4 * (size_t)B * J + W);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
slstm_scan_bwd_grid(const TX* __restrict__ xg, const TW* __restrict__ whh,
                    const float* __restrict__ bias, const float* __restrict__ h0,
                    const float* __restrict__ c0, const float* __restrict__ n0,
                    const float* __restrict__ m0, const float* __restrict__ hs,
                    const float* __restrict__ cs, const float* __restrict__ ns,
                    const float* __restrict__ ms, const float* __restrict__ dhs,
                    const float* __restrict__ dhT, const float* __restrict__ dcT,
                    const float* __restrict__ dnT, const float* __restrict__ dmT,
                    float* __restrict__ dg, float* __restrict__ dh0, float* __restrict__ dc0,
                    float* __restrict__ dn0, float* __restrict__ dm0, float* pbuf, int B,
                    int S, int D, int H, int J) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem_f[];
  const int dh = D / H, W = 4 * J, Wp = W + 1;
  const int per_head = (dh + J - 1) / J;
  const int head = blockIdx.x / per_head, j0 = (blockIdx.x % per_head) * J;
  const int tid = threadIdx.x, BJ = B * J;

  float* w_s = smem_f;                        // w_s[k * Wp + col]
  float* h_s = w_s + (size_t)dh * Wp;         // h_s[b * dh + k], 16-byte rows
  float* g_s = h_s + (size_t)B * dh;         // g_s[b * W + col]
  float* dg_s = g_s + (size_t)B * W;          // dg_s[b * W + col]
  float* red = dg_s + (size_t)B * W;
  float* dhr = red + red_floats(B, J);        // recurrent dh of the block's indices
  float* dc_s = dhr + BJ;
  float* dn_s = dc_s + BJ;
  float* dm_s = dn_s + BJ;
  float* b_s = dm_s + BJ;

  // column col = g J + jl of the slice is gate g of index j0 + jl; past dh: 0
  const TW* wh = whh + (size_t)head * dh * 4 * dh;
  for (int i = tid; i < dh * W; i += kThreads) {
    const int k = i / W, col = i % W, g = col / J, j = j0 + col % J;
    w_s[k * Wp + col] = j < dh ? to_f32(wh[(size_t)k * 4 * dh + g * dh + j]) : 0.f;
  }
  for (int i = tid; i < W; i += kThreads) {
    const int g = i / J, j = j0 + i % J;
    b_s[i] = j < dh ? bias[(size_t)head * 4 * dh + g * dh + j] : 0.f;
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

  const int parts = kThreads / W, kper = round4((dh + parts - 1) / parts);
  const int col = tid % W, part = tid / W;
  const int kb = min(dh, part * kper), ke = min(dh, kb + kper);   // multiples of 4
  const int nq = BJ >= kThreads ? 1 : min(per_head, kThreads / BJ);   // partial sums a item
  const size_t pstride = (size_t)B * dh;      // one block's partials

  for (int t = S - 1; t >= 0; --t) {
    // h_{t-1} of the head (h0 at t = 0)
    for (int i = tid; i < B * dh; i += kThreads) {
      const int b = i / dh, k = i % dh;
      h_s[i] = t > 0 ? hs[((size_t)b * S + t - 1) * D + head * dh + k]
                               : h0[(size_t)b * D + head * dh + k];
    }
    __syncthreads();

    // g_s[b][col] = sum_k h[b][k] w[k][col]: the k range split in parts
    for (int r0 = 0; r0 < B; r0 += kRows) {
      if (part < parts) {
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
        for (int k = kb; k < ke; k += 4) {
          const float w0 = w_s[k * Wp + col], w1 = w_s[(k + 1) * Wp + col];
          const float w2 = w_s[(k + 2) * Wp + col], w3 = w_s[(k + 3) * Wp + col];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r0 + r < B) {
              const float4 hv = *reinterpret_cast<const float4*>(&h_s[(r0 + r) * dh + k]);
              acc[r] = fmaf(hv.x, w0, acc[r]);
              acc[r] = fmaf(hv.y, w1, acc[r]);
              acc[r] = fmaf(hv.z, w2, acc[r]);
              acc[r] = fmaf(hv.w, w3, acc[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) red[(part * kRows + r) * W + col] = acc[r];
      }
      __syncthreads();
      for (int i = tid; i < kRows * W; i += kThreads) {
        const int r = i / W, c = i % W;
        if (r0 + r < B) {
          float s = 0.f;
          for (int p = 0; p < parts; ++p) s += red[(p * kRows + r) * W + c];
          g_s[(r0 + r) * W + c] = s;
        }
      }
      __syncthreads();
    }

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
      const float* cp_ = t > 0 ? cs : c0;
      const float* np_ = t > 0 ? ns : n0;
      const float* mp_ = t > 0 ? ms : m0;
      const TX* x = xg + ((size_t)b * S + t) * 4 * D + (size_t)head * 4 * dh + j;
      const float* gr = g_s + b * W + jl;
      const float gi = (to_f32(x[0]) + gr[0]) + b_s[jl];
      const float gf = (to_f32(x[dh]) + gr[J]) + b_s[J + jl];
      const float gz = (to_f32(x[2 * dh]) + gr[2 * J]) + b_s[2 * J + jl];
      const float go = (to_f32(x[3 * dh]) + gr[3 * J]) + b_s[3 * J + jl];
      const float c = cs[ot], n = ns[ot], m = ms[ot];
      const float cprev = cp_[op], nprev = np_[op], mprev = mp_[op];
      const float dht = dhs[ot] + dhr[i];

      const float logf_ = fminf(gf, 0.f) - log1pf(expf(-fabsf(gf)));   // log sigmoid(f)
      const float a = logf_ + mprev;
      const float ip = expf(gi - m), fp = expf(a - m);
      const float tz = tanhf(gz);
      const float so = 1.f / (1.f + expf(-go));
      const float nc = fmaxf(n, 1e-6f);
      const float dq = dht / nc;                                   // d(so c)
      const float dgo = dq * c * (so * (1.f - so));
      const float dc = dc_s[i] + dq * so;
      const float dn = dn_s[i] + (n >= 1e-6f ? -dht * ((so * c) / nc) / nc : 0.f);
      const float dfp = dc * cprev + dn * nprev;
      const float dip = dc * tz + dn;
      const float dgz = dc * ip * (1.f - tz * tz);
      const float dxa = dfp * fp;                                  // through f' = exp(a - m)
      const float dgia = dip * ip;                                 // through i' = exp(i - m)
      const float dm = dm_s[i] - dgia - dxa;
      float da = dxa, dgi = dgia;
      if (a > gi) {
        da += dm;
      } else if (a < gi) {
        dgi += dm;
      } else {                                                     // a tie: half each
        da += 0.5f * dm;
        dgi += 0.5f * dm;
      }
      const float dgf = da / (1.f + expf(gf));                     // d log sigmoid(f) = sigmoid(-f)
      dc_s[i] = dc * fp;
      dn_s[i] = dn * fp;
      dm_s[i] = da;
      dgr[0] = dgi;
      dgr[J] = dgf;
      dgr[2 * J] = dgz;
      dgr[3 * J] = dgo;
      float* out = dg + ((size_t)b * S + t) * 4 * D + (size_t)head * 4 * dh + j;
      out[0] = dgi;
      out[dh] = dgf;
      out[2 * dh] = dgz;
      out[3 * dh] = dgo;
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
// Plans, cached on the host
// ---------------------------------------------------------------------------

struct Plan {
  int J, blocks, active;
  size_t smem;
};

std::mutex g_mu;
std::map<std::tuple<int, int, int, int, int, int>, Plan> g_plans;
std::set<std::pair<int, const void*>> g_ready;   // (device, kernel) with attributes set

template <typename TX, typename TW>
const void* bwd_kernel() {
  return (const void*)slstm_scan_bwd_grid<TX, TW>;
}

// 16 indices per block first (128 blocks at full width), then 32, 8, 64:
// the first whose shared memory fits and whose grid the card holds at once.
// Returns 0, a cudaError_t, -1 for a shape the kernel does not take, or -2
// when no grid of this shape can be resident.  Called under g_mu.
template <typename TX, typename TW>
int make_plan(int dev, int B, int D, int H, Plan* p) {
  const int dh = D / H;
  if (dh % 4) return -1;                      // 16-byte rows of h in shared memory
  int sms = 0, max_smem = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* kernel = bwd_kernel<TX, TW>();
  if (!g_ready.count({dev, kernel})) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_ready.insert({dev, kernel});
  }
  for (int J : {16, 32, 8, 64}) {
    if (4 * J > kThreads) continue;
    const size_t smem = bwd_smem(B, dh, J);
    if (smem > (size_t)max_smem) continue;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int grid = H * ((dh + J - 1) / J);
    if (grid <= per_sm * sms) {
      *p = {J, grid, per_sm * sms, smem};
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
           const float* c0, const float* n0, const float* m0, const float* hs, const float* cs,
           const float* ns, const float* ms, const float* dhs, const float* dhT,
           const float* dcT, const float* dnT, const float* dmT, float* dg, float* dh0,
           float* dc0, float* dn0, float* dm0, float* pbuf, int B, int S, int D, int H,
           cudaStream_t stream) {
  const TX* x = static_cast<const TX*>(xg);
  const TW* w = static_cast<const TW*>(whh);
  int J = p.J;
  void* args[] = {&x,   &w,   &bias, &h0,  &c0,  &n0,  &m0,  &hs,  &cs,   &ns, &ms,
                  &dhs, &dhT, &dcT,  &dnT, &dmT, &dg,  &dh0, &dc0, &dn0,  &dm0, &pbuf,
                  &B,   &S,   &D,    &H,   &J};
  const cudaError_t e = cudaLaunchCooperativeKernel(bwd_kernel<TX, TW>(), dim3(p.blocks),
                                                    dim3(kThreads), args, p.smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan a call would take, into out[4]: J hidden indices per block,
// blocks, dynamic shared memory per block in bytes, and how many blocks the
// card holds at once.  Returns 0, a cudaError_t, -1 for a bad shape, or -2
// when no grid of this shape can be resident.
extern "C" int slstm_scan_bwd_plan(int x_bf16, int w_bf16, int B, int D, int H, int* out) {
  if (B < 1 || H < 1 || D % H != 0) return -1;
  Plan p;
  const int code = get_plan(x_bf16, w_bf16, B, D, H, &p);
  if (code != 0) return code;
  out[0] = p.J;
  out[1] = p.blocks;
  out[2] = static_cast<int>(p.smem);
  out[3] = p.active;
  return 0;
}

// dhT, dcT, dnT, dmT may be null (a zero cotangent on the final state).
// pbuf: scratch of 2 * blocks * B * (D / H) floats (blocks from the plan).
// Writes dg (B, S, 4D) and dh0, dc0, dn0, dm0 (B, D), all f32.  Returns 0, a
// cudaError_t, or the codes of slstm_scan_bwd_plan.
extern "C" int slstm_scan_bwd(const void* xg, const void* whh, const float* bias,
                              const float* h0, const float* c0, const float* n0,
                              const float* m0, const float* hs, const float* cs,
                              const float* ns, const float* ms, const float* dhs,
                              const float* dhT, const float* dcT, const float* dnT,
                              const float* dmT, float* dg, float* dh0, float* dc0, float* dn0,
                              float* dm0, float* pbuf, int x_bf16, int w_bf16, int B, int S,
                              int D, int H, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D % H != 0) return -1;
  Plan p;
  const int code = get_plan(x_bf16, w_bf16, B, D, H, &p);
  if (code != 0) return code;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SLSTM_BWD_ARGS                                                                      \
  p, xg, whh, bias, h0, c0, n0, m0, hs, cs, ns, ms, dhs, dhT, dcT, dnT, dmT, dg, dh0, dc0, \
      dn0, dm0, pbuf, B, S, D, H, st
  if (!x_bf16 && !w_bf16) return launch<float, float>(SLSTM_BWD_ARGS);
  if (!x_bf16) return launch<float, __nv_bfloat16>(SLSTM_BWD_ARGS);
  if (!w_bf16) return launch<__nv_bfloat16, float>(SLSTM_BWD_ARGS);
  return launch<__nv_bfloat16, __nv_bfloat16>(SLSTM_BWD_ARGS);
#undef SLSTM_BWD_ARGS
}
