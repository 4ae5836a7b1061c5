// sLSTM time scan for Hopper (sm_90a): the whole recurrence over S steps in
// one cooperative launch.
//
// Replaces the Pallas TPU kernel `slstm_scan_kernel` / `_kernel` in
// src/repro/kernels/slstm_scan/kernel.py.  Same function: from pre-projected
// gates xg (B, S, 4D), a block-diagonal recurrent weight w_hh (H, dh, 4dh)
// and a bias (4D,), step the stabilised exponential-gating recurrence
//   g = (xg_t + h_{t-1} . w_hh[head]) + b, laid out per head as [i|f|z|o]
//   m = max(log_sigmoid(f) + m', i);  i' = exp(i - m);  f' = exp(log_sigmoid(f) + m' - m)
//   c = f' c' + i' tanh(z);  n = f' n' + i';  h = sigmoid(o) c / max(n, 1e-6)
// from a given state (h0, c0, n0, m0), writing hs (B, S, D) and the final
// state, all f32.  m0 = -inf makes f' = exp(-inf) = 0 on the first step, so
// the file is built without --use_fast_math.
//
// What bounds it on the H100: the serial chain.  Step t needs the whole
// h_{t-1} of a head, so the S steps are S dependent rounds; the bytes
// (xg, w_hh and hs once each) take a few microseconds and the f32 products
// (2 B 4D dh flops a step) well under a microsecond a step at full width,
// while every step must pass h between SMs.  At D = 2048 one block's w_hh
// is (4, 512, 2048), 8.4 MB in bf16: no SM holds it, and one block per
// (row, head), as the TPU's grid is, would stream 2 MB through one SM a
// step while the other SMs idle.
//
// Design, and what it does about that:
//  * one persistent cooperative launch per call, never one per step: block
//    x owns J hidden indices of one head for all B rows (J = 16 gives
//    4 x 512 / 16 = 128 blocks at full width, one per SM); its slice of
//    w_hh (the 4 gate columns of its J indices, dh x 4J values, 64 KB in
//    bf16) is loaded into shared memory once and stays there for all S
//    steps, so w_hh is read from device memory once per call;
//  * its (c, n, m) stay in shared memory across the steps;
//  * h lives in a double buffer (2, B, D) in device memory: each step a
//    block reads its head's h_{t-1} through L2 (__ldcg: other SMs wrote
//    it), forms its 4J gate pre-activations for every row with the dot
//    products split over 256 threads and summed in shared memory (f32),
//    updates its state, writes its slice of h_t and hs[:, t], and then the
//    whole grid meets at cooperative_groups' grid barrier;
//  * the launch is refused (not hung) when the grid cannot be resident:
//    the entry point checks cudaOccupancyMaxActiveBlocksPerMultiprocessor x
//    SM count before cudaLaunchCooperativeKernel.
// The outputs must not alias the inputs: other blocks read h0 across the
// barrier.  The recurrent product runs on CUDA cores; tensor cores and
// cluster-shared h are later work.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRowChunk = 4;                  // batch rows per pass of the product

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared memory of one block: w slice (dh x 4J, TW), h of the head
// (B x dh), gates (B x 4J), partial sums (parts x kRowChunk x 4J) and the
// state (3 x B x J), all f32 but the w slice.
template <typename TW>
__host__ __device__ size_t smem_bytes(int B, int dh, int J) {
  const int W = 4 * J, parts = kThreads / W;
  return align16((size_t)dh * W * sizeof(TW)) + (size_t)B * dh * 4 + (size_t)B * W * 4 +
         (size_t)parts * kRowChunk * W * 4 + (size_t)3 * B * J * 4;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
slstm_scan(const TX* __restrict__ xg, const TW* __restrict__ whh, const float* __restrict__ bias,
           const float* __restrict__ h0, const float* __restrict__ c0,
           const float* __restrict__ n0, const float* __restrict__ m0, float* __restrict__ hs,
           float* __restrict__ hN, float* __restrict__ cN, float* __restrict__ nN,
           float* __restrict__ mN, float* hbuf, int B, int S, int D, int H, int J) {
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
      const float gi = (to_f32(x[0]) + gr[0]) + bb[0];
      const float gf = (to_f32(x[dh]) + gr[J]) + bb[dh];
      const float gz = (to_f32(x[2 * dh]) + gr[2 * J]) + bb[2 * dh];
      const float go = (to_f32(x[3 * dh]) + gr[3 * J]) + bb[3 * dh];
      const float logf = log_sigmoid(gf);
      const float mp = m_s[i];
      const float m = fmaxf(logf + mp, gi);
      const float ip = expf(gi - m), fp = expf(logf + mp - m);
      const float c = fp * c_s[i] + ip * tanhf(gz);
      const float n = fp * n_s[i] + ip;
      const float h = (1.f / (1.f + expf(-go))) * c / fmaxf(n, 1e-6f);
      c_s[i] = c;
      n_s[i] = n;
      m_s[i] = m;
      const size_t o = (size_t)b * D + head * dh + j;
      hs[((size_t)b * S + t) * D + head * dh + j] = h;
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

template <typename TX, typename TW>
int plan(int B, int D, int H, int* J_out, int* grid_out, size_t* smem_out) {
  const int dh = D / H;
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // 16 indices per block first (128 blocks at full width); then fewer,
  // larger blocks if the grid is too large, or smaller ones if shared
  // memory is short
  const int candidates[] = {16, 32, 8, 64};
  for (int J : candidates) {
    const size_t smem = smem_bytes<TW>(B, dh, J);
    if (smem > (size_t)max_smem) continue;
    e = cudaFuncSetAttribute(slstm_scan<TX, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, slstm_scan<TX, TW>, kThreads,
                                                      smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int grid = H * ((dh + J - 1) / J);
    if (grid <= per_sm * sms) {
      *J_out = J;
      *grid_out = grid;
      *smem_out = smem;
      return 0;
    }
  }
  return -2;                                  // no grid of this shape can be resident
}

template <typename TX, typename TW>
int launch(const void* xg, const void* whh, const float* bias, const float* h0,
           const float* c0, const float* n0, const float* m0, float* hs, float* hN,
           float* cN, float* nN, float* mN, float* hbuf, int B, int S, int D, int H,
           cudaStream_t stream) {
  int J = 0, grid = 0;
  size_t smem = 0;
  const int p = plan<TX, TW>(B, D, H, &J, &grid, &smem);
  if (p != 0) return p;
  const TX* x = static_cast<const TX*>(xg);
  const TW* w = static_cast<const TW*>(whh);
  void* args[] = {&x, &w, &bias, &h0, &c0, &n0, &m0, &hs, &hN, &cN, &nN, &mN, &hbuf,
                  &B, &S, &D, &H, &J};
  const cudaError_t e = cudaLaunchCooperativeKernel((void*)slstm_scan<TX, TW>, dim3(grid),
                                                    dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_bf16 / w_bf16: 0 = float32, 1 = bfloat16 for xg / w_hh.  The grid the
// call would use: J hidden indices per block and the block count.  Returns
// 0, a cudaError_t, or -2 when no such grid can be resident on the card.
extern "C" int slstm_scan_plan(int x_bf16, int w_bf16, int B, int D, int H, int* J,
                               int* grid) {
  if (B < 1 || H < 1 || D % H != 0) return -1;
  size_t smem = 0;
  if (!x_bf16 && !w_bf16) return plan<float, float>(B, D, H, J, grid, &smem);
  if (!x_bf16 && w_bf16) return plan<float, __nv_bfloat16>(B, D, H, J, grid, &smem);
  if (x_bf16 && !w_bf16) return plan<__nv_bfloat16, float>(B, D, H, J, grid, &smem);
  return plan<__nv_bfloat16, __nv_bfloat16>(B, D, H, J, grid, &smem);
}

// hbuf: scratch of 2 * B * D floats.  Returns 0, a cudaError_t, -1 for
// arguments outside what the kernel takes, or -2 when the grid cannot be
// resident (the cooperative launch is then not attempted).
extern "C" int slstm_scan_fwd(const void* xg, const void* whh, const float* bias,
                              const float* h0, const float* c0, const float* n0,
                              const float* m0, float* hs, float* hN, float* cN, float* nN,
                              float* mN, float* hbuf, int x_bf16, int w_bf16, int B, int S,
                              int D, int H, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D % H != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!x_bf16 && !w_bf16)
    return launch<float, float>(xg, whh, bias, h0, c0, n0, m0, hs, hN, cN, nN, mN, hbuf, B,
                                S, D, H, st);
  if (!x_bf16 && w_bf16)
    return launch<float, __nv_bfloat16>(xg, whh, bias, h0, c0, n0, m0, hs, hN, cN, nN, mN,
                                        hbuf, B, S, D, H, st);
  if (x_bf16 && !w_bf16)
    return launch<__nv_bfloat16, float>(xg, whh, bias, h0, c0, n0, m0, hs, hN, cN, nN, mN,
                                        hbuf, B, S, D, H, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(xg, whh, bias, h0, c0, n0, m0, hs, hN, cN, nN,
                                              mN, hbuf, B, S, D, H, st);
}

// `steps` grid barriers over a cooperative grid of `grid` blocks of 256
// threads: what S dependent steps cost this design before any arithmetic.
extern "C" int slstm_grid_sync_loop(int grid, int steps, void* stream) {
  if (grid < 1 || steps < 0) return -1;
  void* args[] = {&steps};
  const cudaError_t e = cudaLaunchCooperativeKernel((void*)grid_sync_loop, dim3(grid),
                                                    dim3(kThreads), args, 0,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
