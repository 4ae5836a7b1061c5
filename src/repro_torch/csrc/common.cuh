// Helpers shared by the kernels in this directory.
//
// Each `.cu` file here is compiled on its own into its own shared library,
// so the C entry point below is defined once per library.  `_build.py`
// hashes this header with every source, so an edit here rebuilds them all.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kNeg = -2.0e38f;              // stands in for -inf in f32 softmax state

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Strides { long long b, h, s; };        // in elements; the last dim is contiguous

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
