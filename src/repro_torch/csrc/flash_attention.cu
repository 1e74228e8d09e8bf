// Causal / full GQA flash attention (prefill) for Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py (flash_attention /
// _flash_kernel); the port's model calls it wherever the JAX model runs
// the oracle models/attention.py blockwise_attention on the prefill
// branch.
//
// Bound: at the prefill shapes of the main path (S = 32..512, D = 128)
// the work is 4 * S^2/2 * D flops per head against 4 * S * D * 2 bytes of
// q/k/v/o, i.e. S/4 operations per byte (~128 at S = 512): below the
// card's ~295, so on the tensor cores this kernel would be bound by bytes.
// This first version does its products with plain float FMAs out of shared
// memory, so in practice it is bound by shared-memory bandwidth and the
// FP32 pipe, well above either bound; moving the two products to
// mma.sync / wgmma is later work.
//
// Design: one block of 256 threads per (batch*head, 64-row query tile).
// The query tile and each 64-row K/V tile are staged in shared memory as
// float (rows padded by one float so column walks hit distinct banks).
// Four threads share a query row: each computes 16 of the 64 scores of a
// tile, the row max and sum are combined with two shuffles, and each
// thread keeps D/4 output columns (interleaved, so V reads are
// conflict-free) in registers.  The online-softmax state (m, l, acc) is
// float.  Tiles wholly above the causal diagonal or past kv_len are never
// loaded.  Query head h reads KV head h / G.  As in the oracle, the
// probabilities are rounded to the input type before the PV product
// (blockwise_attention feeds p.astype(v.dtype)), while l sums them in
// float.  q, k, v and o are addressed through (batch, head, seq) strides,
// so the model's (B, S, H, D) layout is read in place; D is contiguous.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int NT = 256;       // threads per block: 4 per query row
constexpr int JPT = BK / 4;   // scores per thread per tile

struct Strides {
  long long b, h, s;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
          size_t(BQ) * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int G, int Sq, int Skv, int kv_len, int causal,
                     float scale, Strides qs, Strides ks, Strides vs,
                     Strides os) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 4;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x DP
  float* Ks = Qs + BQ * DP;     // BK x DP
  float* Vs = Ks + BK * DP;     // BK x D
  float* Ps = Vs + BK * D;      // BQ x (BK + 1)

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kvh = h / G;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;
  const int qrow = q0 + r;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, dd = i % D, qp = q0 + rr;
    Qs[rr * DP + dd] = qp < Sq ? to_f(qb[qp * qs.s + dd]) : 0.f;
  }

  float m = NEG_INF, l = 0.f;
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;

  // kv positions at or past `limit` are masked for every row of the tile
  int limit = min(Skv, kv_len);
  if (causal) limit = min(limit, q0 + BQ);
  const int ntiles = (limit + BK - 1) / BK;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // previous tile's readers are done with Ks/Vs
    for (int i = tid; i < BK * D; i += NT) {
      const int rr = i / D, dd = i % D, kp = k0 + rr;
      const bool ok = kp < Skv;
      Ks[rr * DP + dd] = ok ? to_f(kb[kp * ks.s + dd]) : 0.f;
      Vs[rr * D + dd] = ok ? to_f(vb[kp * vs.s + dd]) : 0.f;
    }
    __syncthreads();

    float s[JPT];
#pragma unroll
    for (int j = 0; j < JPT; ++j) s[j] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      const float qv = Qs[r * DP + dd];
#pragma unroll
      for (int j = 0; j < JPT; ++j) s[j] += qv * Ks[(sub + 4 * j) * DP + dd];
    }

    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < JPT; ++j) {
      const int kp = k0 + sub + 4 * j;
      const bool valid =
          kp < Skv && kp < kv_len && (!causal || kp <= qrow);
      s[j] = valid ? s[j] * scale : NEG_INF;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < JPT; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      Ps[r * (BK + 1) + sub + 4 * j] = to_f(from_f<T>(p));
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the four writers of row r are the four readers

#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[r * (BK + 1) + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[cc] += p * Vs[c * D + sub + 4 * cc];
    }
  }

  if (qrow < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = o + b * os.b + h * os.h + qrow * os.s;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) ob[sub + 4 * cc] = from_f<T>(acc[cc] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Skv, int kv_len, int causal,
           float scale, Strides qs, Strides ks, Strides vs, Strides os,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / KV, Sq, Skv,
      kv_len, causal, scale, qs, ks, vs, os);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int H, int KV, int Sq, int Skv, int kv_len,
               int causal, float scale, Strides qs, Strides ks, Strides vs,
               Strides os, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, KV, Sq, Skv, kv_len, causal,
                           scale, qs, ks, vs, os, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Skv, kv_len, causal,
                           scale, qs, ks, vs, os, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Skv, kv_len, causal,
                           scale, qs, ks, vs, os, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Skv, kv_len, causal,
                            scale, qs, ks, vs, os, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, int B, int H, int KV, int Sq, int Skv,
                            int D, int kv_len, int causal, float scale,
                            int dtype, long long qsb, long long qsh,
                            long long qss, long long ksb, long long ksh,
                            long long kss, long long vsb, long long vsh,
                            long long vss, long long osb, long long osh,
                            long long oss, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BF16)
    return dispatch_d<bf16>(D, q, k, v, o, B, H, KV, Sq, Skv, kv_len, causal,
                            scale, qs, ks, vs, os, s);
  if (dtype == F32)
    return dispatch_d<float>(D, q, k, v, o, B, H, KV, Sq, Skv, kv_len,
                             causal, scale, qs, ks, vs, os, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
