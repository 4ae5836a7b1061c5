// PTX wrappers for a thread-block cluster that passes data between its
// blocks' shared memory (sm_90), shared by the sLSTM scan (slstm_scan.cu)
// and its backward (slstm_scan_bwd.cu): the block's rank and the cluster's
// size, a cluster-wide barrier, shared-memory mbarriers that count bytes,
// the 16-byte `st.async` that writes into a peer block's shared memory and
// completes its bytes on the peer's mbarrier, a 4-byte `cp.async`, the
// unpacking of 16 bytes of w into f32, and on the host the launch
// configuration of a 1-D grid of clusters and the once-per-kernel
// attributes it needs.
//
// `_build.py` hashes every `.cuh` into every library's name, so an edit
// here rebuilds them all.
#pragma once

#include <cstdint>
#include <set>
#include <utility>

#include "mma.cuh"  // smem_u32

namespace {

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster: its earlier shared-memory
// writes are seen by every thread of the cluster after.
__device__ __forceinline__ void cluster_barrier() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(bar)) : "memory");
}
// One arrival that also expects `bytes` more to be written into this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile("{\n"
               ".reg .pred done;\n"
               "WAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
               "@!done bra WAIT;\n"
               "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// 16 bytes into the shared memory of block `rank` of this cluster, at the
// place `local` has in this block's; the write completes its bytes on that
// block's barrier at the place of `bar`.
__device__ __forceinline__ void st_async_peer(const float* local, uint64_t* bar, unsigned rank,
                                              float4 v) {
  uint32_t a, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_u32(local)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(b) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
               "{%1, %2, %3, %4}, [%5];"
               :: "r"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(b) : "memory");
}
// 4 bytes global -> shared, asynchronously (committed with the 16-byte copies).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// 16 bytes of w as f32: 8 bf16 (the low half of each word first) or 4 f32.
template <typename TW>
__device__ __forceinline__ void unpack16(const uint4& r, float* w) {
  const unsigned u[4] = {r.x, r.y, r.z, r.w};
  if constexpr (sizeof(TW) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[2 * i] = __uint_as_float(u[i] << 16);
      w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __uint_as_float(u[i]);
  }
}

// A 1-D grid of `blocks` blocks in clusters of `cs`; `attr` must outlive the
// returned configuration.
cudaLaunchConfig_t cluster_config(int blocks, int cs, int threads, size_t smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

std::set<std::pair<int, const void*>> g_ready;  // (device, kernel) with attributes set

// Once per device and kernel: the opt-in shared memory (and, for a cluster
// kernel, clusters of up to 16 blocks).  Called under the file's plan lock.
cudaError_t prepare(int dev, const void* kernel, int max_smem, bool cluster) {
  if (g_ready.count({dev, kernel})) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       max_smem);
  if (e == cudaSuccess && cluster)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) g_ready.insert({dev, kernel});
  return e;
}

}  // namespace
