// Paged multi-query attention for Hopper: the T newest tokens of each
// sequence attend causally through a block table (speculative verify), over
// a bf16/f32 pool or an int8 pool with per-block-per-head scales.  The int8
// decode kernel is the T == 1 case of the int8 kernel.
//
// Replaces the Pallas TPU kernels of
// src/repro/kernels/paged_attention/kernel.py:
//   paged_verify_attention       (_paged_verify_kernel)
//   paged_decode_attention_int8  (_paged_decode_kernel_int8)
//   paged_verify_attention_int8  (_paged_verify_kernel_int8)
// The port's model calls them where the JAX model runs the oracles
// models/attention.py paged_verify_attention (S > 1, bf16 pool) and
// paged_{decode,verify}_attention_int8 (int8 pool).
//
// Bound: bytes.  Every live K and V row is read once per (sequence, KV
// head) for about 4 * T * G * D flops per row: with T * G = 5 that is
// about 5 operations per byte of bf16 (10 per byte of int8), far below
// the ~295 the tensor cores need, so the kernels stream memory.  int8
// pools halve the bytes of a bf16 pool; the scales add 8 bytes per
// (pool block, head).
// Design: one block of 128 threads per (sequence, KV head), holding its
// T * G query rows (row (t, g) is query t of head kvh * G + g, at position
// len - T + t).  As in csrc/paged_attention.cu, the block reads its own
// table row and walks only j < ceil(len / blk), so null tail entries are
// never dereferenced.  For each pool block it first copies the live K and
// V rows into shared memory as float, with 16-byte loads where the row is
// 16-byte aligned (16 int8 codes, 8 bf16 or 4 f32 values a load), scaling
// int8 codes by the block's k_scale / v_scale as they land (each scale is
// read once per pool block); then warps split the (row, token) score
// pairs with lanes across D, one thread per row updates the float online
// softmax (key positions past the row's own get p = 0), and threads across
// (row, column) fold p * V into float accumulators.  p stays float (the
// oracle rounds the normalised p to the value type, which an online
// softmax cannot do); the output is float.  The arithmetic of one row is
// the decode kernel's, in the same order, so T == 1 over a bf16 pool gives
// csrc/paged_attention.cu's bits.
#include "common.cuh"

namespace rt {
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
}  // namespace rt

using namespace rt;

namespace {

constexpr int NT = 128;

// Copy `rows` rows of D elements (row stride `stride` elements) into dst
// (rows x D floats), multiplied by `mul` when SCALED.
template <typename P, bool SCALED>
__device__ __forceinline__ void load_tile(const P* __restrict__ src,
                                          size_t stride, int rows, int D,
                                          float mul, bool vec,
                                          float* __restrict__ dst) {
  constexpr int N = 16 / sizeof(P);  // elements per 16-byte load
  if (vec) {
    const int per_row = D / N;
    for (int i = threadIdx.x; i < rows * per_row; i += NT) {
      const int r = i / per_row, c = (i % per_row) * N;
      const uint4 u = *reinterpret_cast<const uint4*>(src + r * stride + c);
      const P* e = reinterpret_cast<const P*>(&u);
      float* o = dst + r * D + c;
#pragma unroll
      for (int k = 0; k < N; ++k) o[k] = SCALED ? to_f(e[k]) * mul : to_f(e[k]);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += NT) {
      const int r = i / D, c = i % D;
      const float x = to_f(src[r * stride + c]);
      dst[i] = SCALED ? x * mul : x;
    }
  }
}

// Q: query type; P: pool type (int8_t when SCALED).
template <typename Q, typename P, bool SCALED>
__global__ void __launch_bounds__(NT)
    paged_verify_kernel(const Q* __restrict__ q, const P* __restrict__ kpool,
                        const P* __restrict__ vpool,
                        const float* __restrict__ kscale,
                        const float* __restrict__ vscale,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        float* __restrict__ out, int T, int H, int KV, int D,
                        int blk, int W, float scale, bool vec) {
  const int G = H / KV, R = T * G;
  extern __shared__ float smem[];
  float* qs = smem;              // R x D
  float* acc = qs + R * D;       // R x D
  float* kt = acc + R * D;       // blk x D  (this pool block's K, float)
  float* vt = kt + blk * D;      // blk x D
  float* sc = vt + blk * D;      // R x blk scores, then probabilities
  float* mrow = sc + R * blk;    // R
  float* lrow = mrow + R;        // R
  float* crow = lrow + R;        // R

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = NT / 32;
  const size_t tok = static_cast<size_t>(KV) * D;  // pool row stride

  // row r = t * G + g  <-  q[b, t, kvh * G + g, :]
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, d = i % D, t = r / G, g = r % G;
    qs[i] = to_f(q[((static_cast<size_t>(b) * T + t) * H + kvh * G + g) * D +
                   d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += NT) {
    mrow[r] = NEG_INF;
    lrow[r] = 0.f;
  }

  const int len = lengths[b];
  const int npages = (len + blk - 1) / blk;
  for (int j = 0; j < npages; ++j) {
    const int pid = tables[static_cast<size_t>(b) * W + j];
    const size_t base = static_cast<size_t>(pid) * blk * tok + kvh * D;
    const int live = min(blk, len - j * blk);  // tokens of this block
    float ks = 1.f, vs = 1.f;
    if (SCALED) {
      ks = kscale[static_cast<size_t>(pid) * KV + kvh];
      vs = vscale[static_cast<size_t>(pid) * KV + kvh];
    }
    __syncthreads();  // init done / previous block's readers done
    load_tile<P, SCALED>(kpool + base, tok, live, D, ks, vec, kt);
    load_tile<P, SCALED>(vpool + base, tok, live, D, vs, vec, vt);
    __syncthreads();

    for (int pr = warp; pr < R * live; pr += nwarps) {
      const int r = pr / live, t = pr % live;
      const float* kr = kt + t * D;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += qs[r * D + d] * kr[d];
      dot = warp_sum(dot);
      if (lane == 0) sc[r * blk + t] = dot * scale;
    }
    __syncthreads();

    for (int r = tid; r < R; r += NT) {
      // keys at positions <= len - T + t are visible to row r
      const int last = len - T + r / G - j * blk;  // last visible in block
      float* sg = sc + r * blk;
      const float mp = mrow[r];
      float mx = mp;
      for (int t = 0; t < live && t <= last; ++t) mx = fmaxf(mx, sg[t]);
      const float c = expf(mp - mx);
      float sum = 0.f;
      for (int t = 0; t < live; ++t) {
        const float p = t <= last ? expf(sg[t] - mx) : 0.f;
        sg[t] = p;
        sum += p;
      }
      lrow[r] = lrow[r] * c + sum;
      mrow[r] = mx;
      crow[r] = c;
    }
    __syncthreads();

    for (int i = tid; i < R * D; i += NT) {
      const int r = i / D, d = i % D;
      const float* pg = sc + r * blk;
      float a = acc[i] * crow[r];
      for (int t = 0; t < live; ++t) a += pg[t] * vt[t * D + d];
      acc[i] = a;
    }
  }
  __syncthreads();

  // out[b, t, kvh * G + g, :]
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, d = i % D, t = r / G, g = r % G;
    out[((static_cast<size_t>(b) * T + t) * H + kvh * G + g) * D + d] =
        acc[i] / fmaxf(lrow[r], 1e-30f);
  }
}

template <typename Q, typename P, bool SCALED>
int launch(const void* q, const void* kpool, const void* vpool,
           const float* kscale, const float* vscale, const int* tables,
           const int* lengths, float* out, int B, int T, int H, int KV,
           int D, int blk, int W, float scale, cudaStream_t stream) {
  const int R = T * (H / KV);
  const size_t smem =
      sizeof(float) * (2 * size_t(R) * D + 2 * size_t(blk) * D +
                       size_t(R) * blk + 3 * size_t(R));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_verify_kernel<Q, P, SCALED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 16-byte loads when every pool row starts on a 16-byte boundary
  const bool vec = (D * sizeof(P)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(kpool) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vpool) % 16 == 0;
  dim3 grid(KV, B);
  paged_verify_kernel<Q, P, SCALED><<<grid, NT, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const P*>(kpool),
      static_cast<const P*>(vpool), kscale, vscale, tables, lengths, out, T,
      H, KV, D, blk, W, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, T, H, D) in the pool's type; pools (nb, blk, KV, D) bf16 or f32.
extern "C" int rt_paged_verify(const void* q, const void* kpool,
                               const void* vpool, const void* tables,
                               const void* lengths, void* out, int B, int T,
                               int H, int KV, int D, int blk, int W,
                               float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  if (dtype == BF16)
    return launch<bf16, bf16, false>(q, kpool, vpool, nullptr, nullptr, tb,
                                     ln, o, B, T, H, KV, D, blk, W, scale, s);
  if (dtype == F32)
    return launch<float, float, false>(q, kpool, vpool, nullptr, nullptr, tb,
                                       ln, o, B, T, H, KV, D, blk, W, scale,
                                       s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q: (B, T, H, D) bf16 or f32 (qdtype); pools (nb, blk, KV, D) int8;
// scales (nb, KV) f32.  T == 1 is the int8 decode kernel.
extern "C" int rt_paged_int8(const void* q, const void* kpool,
                             const void* vpool, const void* kscale,
                             const void* vscale, const void* tables,
                             const void* lengths, void* out, int B, int T,
                             int H, int KV, int D, int blk, int W,
                             float scale, int qdtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ksc = static_cast<const float*>(kscale);
  const float* vsc = static_cast<const float*>(vscale);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  if (qdtype == BF16)
    return launch<bf16, int8_t, true>(q, kpool, vpool, ksc, vsc, tb, ln, o,
                                      B, T, H, KV, D, blk, W, scale, s);
  if (qdtype == F32)
    return launch<float, int8_t, true>(q, kpool, vpool, ksc, vsc, tb, ln, o,
                                       B, T, H, KV, D, blk, W, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
