// Paged flash-decode for Hopper: one query token per sequence against a
// paged KV pool, GQA.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/kernel.py (paged_decode_attention /
// _paged_decode_kernel); the port's model calls it wherever the JAX model
// runs the oracle models/attention.py paged_decode_attention on the S == 1
// decode branch.
//
// Bound: bytes.  Every live K and V row of every sequence is read once
// (2 * len * D * sizeof(T) bytes per (sequence, KV head)) for ~4 * G * D
// flops, i.e. about G operations per byte: decode attention is a pure
// memory stream.
// Design: one block of 128 threads per (sequence, KV head), holding that
// head's G query rows.  The block reads block_tables[b, j] itself and
// walks only j < ceil(len / blk), so table entries past the length (the
// null block 0 in the serving layer) are never dereferenced, and the tail
// block stops at the last live token.  For each pool block: warps split
// the (query row, token) score pairs with lanes across D, one thread per
// query row updates the float online-softmax state, then threads across
// (row, column) fold p * V into float accumulators in shared memory.  The
// output is written as float, as the oracle's PV product accumulates in
// float before the model casts it.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int NT = 128;

template <typename T>
__global__ void __launch_bounds__(NT)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                        const T* __restrict__ vpool,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        float* __restrict__ out, int H, int KV, int D,
                        int blk, int W, float scale) {
  const int G = H / KV;
  extern __shared__ float smem[];
  float* qs = smem;              // G x D
  float* acc = qs + G * D;       // G x D
  float* sc = acc + G * D;       // G x blk scores, then probabilities
  float* mrow = sc + G * blk;    // G
  float* lrow = mrow + G;        // G
  float* crow = lrow + G;        // G

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = NT / 32;
  const size_t tok = static_cast<size_t>(KV) * D;  // pool row stride

  const T* qb = q + (static_cast<size_t>(b) * H + kvh * G) * D;
  for (int i = tid; i < G * D; i += NT) {
    qs[i] = to_f(qb[i]);
    acc[i] = 0.f;
  }
  if (tid < G) {
    mrow[tid] = NEG_INF;
    lrow[tid] = 0.f;
  }

  const int len = lengths[b];
  const int npages = (len + blk - 1) / blk;
  for (int j = 0; j < npages; ++j) {
    const int pid = tables[static_cast<size_t>(b) * W + j];
    const size_t base = static_cast<size_t>(pid) * blk * tok + kvh * D;
    const T* kb = kpool + base;
    const T* vb = vpool + base;
    const int live = min(blk, len - j * blk);  // tokens of this block
    __syncthreads();  // init done / previous block's readers of sc done

    for (int pr = warp; pr < G * live; pr += nwarps) {
      const int g = pr / live, t = pr % live;
      const T* kr = kb + t * tok;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += qs[g * D + d] * to_f(kr[d]);
      dot = warp_sum(dot);
      if (lane == 0) sc[g * blk + t] = dot * scale;
    }
    __syncthreads();

    if (tid < G) {
      float* sg = sc + tid * blk;
      const float mp = mrow[tid];
      float mx = mp;
      for (int t = 0; t < live; ++t) mx = fmaxf(mx, sg[t]);
      const float c = expf(mp - mx);
      float sum = 0.f;
      for (int t = 0; t < live; ++t) {
        const float p = expf(sg[t] - mx);
        sg[t] = p;
        sum += p;
      }
      lrow[tid] = lrow[tid] * c + sum;
      mrow[tid] = mx;
      crow[tid] = c;
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D, d = i % D;
      const float* pg = sc + g * blk;
      float a = acc[i] * crow[g];
      for (int t = 0; t < live; ++t) a += pg[t] * to_f(vb[t * tok + d]);
      acc[i] = a;
    }
  }
  __syncthreads();

  float* ob = out + (static_cast<size_t>(b) * H + kvh * G) * D;
  for (int i = tid; i < G * D; i += NT)
    ob[i] = acc[i] / fmaxf(lrow[i / D], 1e-30f);
}

template <typename T>
int launch(const void* q, const void* kpool, const void* vpool,
           const int* tables, const int* lengths, float* out, int B, int H,
           int KV, int D, int blk, int W, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = sizeof(float) * (2 * size_t(G) * D + size_t(G) * blk +
                                       3 * size_t(G));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(KV, B);
  paged_decode_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), tables, lengths, out, H, KV, D, blk, W,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_paged_decode(const void* q, const void* kpool,
                               const void* vpool, const void* tables,
                               const void* lengths, void* out, int B, int H,
                               int KV, int D, int blk, int W, float scale,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  if (dtype == BF16)
    return launch<bf16>(q, kpool, vpool, tb, ln, o, B, H, KV, D, blk, W,
                        scale, s);
  if (dtype == F32)
    return launch<float>(q, kpool, vpool, tb, ln, o, B, H, KV, D, blk, W,
                         scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
