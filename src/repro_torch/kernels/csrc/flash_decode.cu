// Batched ragged decode attention for Hopper, fp32.
//
// Replaces: repro/kernels/flash_attention.py, flash_decode /
// _decode_kernel (the Pallas TPU kernel that advances a whole decode
// batch's attention segment in one launch).
//
// For request b: out[b] = softmax(q[b] k[b, :len_b]^T * scale) v[b, :len_b],
// by the online-softmax recurrence over KV blocks with running
// (max, sum, acc); positions at or past len_b are masked, a masked score
// contributes p = 0 (also when a whole block is masked), and there is no
// default d**-0.5 scale (the GEMM stream's score GEMM carries none).
//
// What bounds it on an H100: every q, k and v element is read once and
// used for 2 flops, so the bytes bound it; at the main path's shapes
// (4 requests x 16 positions x 256 wide) the whole launch moves ~130 KB
// and takes a few microseconds, so launch latency dominates.
//
// What the design does about it: one block per request walks its own KV
// blocks with the running state in shared memory (no cross-block
// reduction, one launch for the batch); K and V blocks are staged in
// shared memory with coalesced loads, each score is one warp's dot
// product, and each softmax row is one warp's max and sum.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockKV = 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ lengths,
                        float* __restrict__ o, int sq, int skv, int d,
                        int dv, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [sq, d]
  float* ks = qs + sq * d;             // [kBlockKV, d]
  float* vs = ks + kBlockKV * d;       // [kBlockKV, dv]
  float* ps = vs + kBlockKV * dv;      // [sq, kBlockKV]
  float* acc = ps + sq * kBlockKV;     // [sq, dv]
  float* m_run = acc + sq * dv;        // [sq]
  float* l_run = m_run + sq;           // [sq]
  float* alpha = l_run + sq;           // [sq]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int len = lengths[b];
  const float* qb = q + (size_t)b * sq * d;
  const float* kb = k + (size_t)b * skv * d;
  const float* vb = v + (size_t)b * skv * dv;

  for (int i = tid; i < sq * d; i += kThreads) qs[i] = qb[i];
  for (int i = tid; i < sq * dv; i += kThreads) acc[i] = 0.0f;
  for (int i = tid; i < sq; i += kThreads) {
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
  }

  for (int kv0 = 0; kv0 < skv; kv0 += kBlockKV) {
    __syncthreads();
    for (int i = tid; i < kBlockKV * d; i += kThreads) {
      const int j = kv0 + i / d;
      ks[i] = j < skv ? kb[(size_t)kv0 * d + i] : 0.0f;
    }
    for (int i = tid; i < kBlockKV * dv; i += kThreads) {
      const int j = kv0 + i / dv;
      vs[i] = j < skv ? vb[(size_t)kv0 * dv + i] : 0.0f;
    }
    __syncthreads();
    // scores: one warp per (row, position) dot product
    for (int p = warp; p < sq * kBlockKV; p += kWarps) {
      const int i = p / kBlockKV, j = p % kBlockKV;
      float s = 0.0f;
      for (int c = lane; c < d; c += 32) s = fmaf(qs[i * d + c], ks[j * d + c], s);
      s = warp_sum(s) * scale;
      if (lane == 0) ps[p] = (kv0 + j < len) ? s : kNegInf;
    }
    __syncthreads();
    // online softmax: one warp per row
    for (int i = warp; i < sq; i += kWarps) {
      const float s = lane < kBlockKV ? ps[i * kBlockKV + lane] : kNegInf;
      const float m_prev = m_run[i];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = (lane < kBlockKV && s > kNegInf / 2) ? expf(s - m_new)
                                                           : 0.0f;
      const float psum = warp_sum(p);
      if (lane < kBlockKV) ps[i * kBlockKV + lane] = p;
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[i] = a;
        l_run[i] = l_run[i] * a + psum;
        m_run[i] = m_new;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < sq * dv; idx += kThreads) {
      const int i = idx / dv, c = idx % dv;
      float pv = 0.0f;
#pragma unroll
      for (int j = 0; j < kBlockKV; ++j)
        pv = fmaf(ps[i * kBlockKV + j], vs[j * dv + c], pv);
      acc[idx] = acc[idx] * alpha[i] + pv;
    }
  }
  __syncthreads();
  float* ob = o + (size_t)b * sq * dv;
  for (int idx = tid; idx < sq * dv; idx += kThreads)
    ob[idx] = acc[idx] / fmaxf(l_run[idx / dv], 1e-30f);
}

}  // namespace

// q [B, sq, d], k [B, skv, d], v [B, skv, dv], lengths [B] int32, all
// contiguous on the device; o [B, sq, dv].  Returns the launch's
// cudaError_t (shared memory above 48 KB is opted into first).
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, int B, int sq,
                                int skv, int d, int dv, float scale,
                                void* stream) {
  if (B <= 0 || sq <= 0 || dv <= 0) return 0;
  const size_t smem = sizeof(float) *
                      ((size_t)sq * d + (size_t)kBlockKV * (d + dv) +
                       (size_t)sq * kBlockKV + (size_t)sq * dv + 3 * (size_t)sq);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_decode_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(o), sq, skv, d, dv, scale);
  return static_cast<int>(cudaGetLastError());
}
