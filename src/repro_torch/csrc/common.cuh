// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel is exported through a plain C function that launches on
// the stream it is given and returns the cudaError_t of the launch
// (cudaGetLastError), so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// dtype codes shared with the Python wrappers (kernels/_lib.py)
enum Dtype : int { F32 = 0, BF16 = 1 };

using bf16 = __nv_bfloat16;

// the reference's masking constant (models/attention.py NEG_INF)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
// round to nearest even, as torch's and XLA's f32 -> bf16 casts do
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace rt
