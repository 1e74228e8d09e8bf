// Fused RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (rmsnorm / _rmsnorm_kernel), which the port's model calls wherever the
// JAX model calls the oracle in models/layers.py apply_norm.
//
// Bound: bytes.  Each row is read once and written once (2 * d * sizeof(T)
// bytes) for ~4 operations per element, far below the card's ~295
// operations per byte, so the kernel can only be as fast as device memory.
// Design: one block per row, 16-byte vector loads (8 bf16 or 4 f32 per
// thread per load) sized so each thread holds about one vector, a float
// sum of squares reduced by warp shuffles and then across warps through
// shared memory.  The row is read twice from global memory; the second
// read hits L2/L1 (a 2560-wide bf16 row is 5 KB).
#include "common.cuh"

using namespace rt;

template <typename TX, typename TW>
__global__ void rmsnorm_kernel(const TX* __restrict__ x,
                               const TW* __restrict__ w,
                               TX* __restrict__ y, int d, float eps,
                               int vec) {
  constexpr int V = 16 / sizeof(TX);
  const size_t row = blockIdx.x;
  const TX* xr = x + row * d;
  TX* yr = y + row * d;

  float ss = 0.f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      uint4 u = xv[i];
      const TX* e = reinterpret_cast<const TX*>(&u);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float f = to_f(e[k]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      float f = to_f(xr[i]);
      ss += f * f;
    }
  }

  __shared__ float partial[32];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float s = lane < nwarps ? partial[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) inv_rms = rsqrtf(s / d + eps);
  }
  __syncthreads();
  const float inv = inv_rms;

  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      uint4 u = xv[i], o;
      const TX* e = reinterpret_cast<const TX*>(&u);
      TX* oe = reinterpret_cast<TX*>(&o);
#pragma unroll
      for (int k = 0; k < V; ++k)
        oe[k] = from_f<TX>(to_f(e[k]) * inv * to_f(w[i * V + k]));
      yv[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      yr[i] = from_f<TX>(to_f(xr[i]) * inv * to_f(w[i]));
  }
}

template <typename TX, typename TW>
static void launch(const void* x, const void* w, void* y, int rows, int d,
                   float eps, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  const int per_thread = vec ? V : 1;
  int threads = (d / per_thread + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  rmsnorm_kernel<TX, TW><<<rows, threads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), d, eps, vec);
}

extern "C" int rt_rmsnorm(const void* x, const void* w, void* y, int rows,
                          int d, float eps, int x_dtype, int w_dtype,
                          int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == BF16 && w_dtype == BF16)
    launch<bf16, bf16>(x, w, y, rows, d, eps, vec, s);
  else if (x_dtype == BF16 && w_dtype == F32)
    launch<bf16, float>(x, w, y, rows, d, eps, vec, s);
  else if (x_dtype == F32 && w_dtype == F32)
    launch<float, float>(x, w, y, rows, d, eps, vec, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
