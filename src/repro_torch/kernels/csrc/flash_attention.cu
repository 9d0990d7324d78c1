// Prefill flash attention (causal or full) for Hopper: fp32, or bf16
// inputs with fp32 sums.
//
// Replaces: repro/kernels/flash_attention.py, flash_attention /
// _flash_kernel (the Pallas TPU kernel on grid (BH, q blocks, KV
// blocks), KV innermost and sequential).
//
// For each of the BH folded heads: o = softmax(q k^T * scale) v over
// [S, d], by the online-softmax recurrence over KV blocks with running
// (max, sum, acc) per query row.  As in the TPU kernel: KV blocks that
// lie strictly after a causal query block are skipped; key positions at
// or past kv_len are masked whether or not kv_len falls on a block edge
// (the padded-KV leak the reference fixed); a masked score contributes
// p = 0, not exp(0); with bf16 inputs p is rounded to bf16 before the PV
// product, and the output takes the inputs' dtype.
//
// What bounds it on an H100: operations.  At the smoke shape (16 heads
// of 256, S 4096, causal) the launch does ~1.4e11 flops on ~0.2 GB, far
// above the ~20 flops/byte where fp32 FFMA (67 TFLOP/s) overtakes HBM.
//
// What the design does about it (a simple FFMA kernel; tensor cores are
// later work): the TPU kernel's sequential KV grid axis becomes a loop
// inside one block per (head, 64-row query block).  The query block and
// one 32-row K and V block sit in shared memory as fp32 (bf16 widened on
// the way in); each of 256 threads owns 2 query rows x 4 key columns of
// the score tile and 2 rows x d/8 columns of the output accumulator, in
// registers, so a row's max and sum are 8-lane shuffles.  K rows are
// padded by 4 floats so the float4 score loads are free of bank
// conflicts.  head_dim up to 256 (zero-padded to a multiple of 32 in
// shared memory); ragged S and S_kv are masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                  // query rows per block
constexpr int kBKV = 32;                 // key rows per KV block
constexpr int kPtStride = kBQ + 2;       // p^T row stride (float2-aligned)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p as the PV product sees it: rounded to v's dtype
template <typename T>
__device__ __forceinline__ float pv_round(float p) {
  return to_f(from_f<T>(p));
}

template <typename T, int DQ>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int SK, int d, int kv_len, int causal,
                           float scale) {
  constexpr int DP = DQ * 32;            // padded head_dim
  constexpr int QS = DP + 4;             // q/k row stride
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [kBQ, QS]
  float* ks = qs + kBQ * QS;             // [kBKV, QS]
  float* vs = ks + kBKV * QS;            // [kBKV, DP]
  float* pt = vs + kBKV * DP;            // [kBKV, kPtStride]: p^T

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;  // rows 2ty, 2ty+1; lanes of a row
  const T* qb = q + (size_t)bh * S * d;
  const T* kb = k + (size_t)bh * SK * d;
  const T* vb = v + (size_t)bh * SK * d;

  for (int idx = tid; idx < kBQ * DP; idx += kThreads) {
    const int i = idx / DP, c = idx % DP;
    qs[i * QS + c] =
        (q0 + i < S && c < d) ? to_f(qb[(size_t)(q0 + i) * d + c]) : 0.0f;
  }

  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};
  float acc[2][DQ * 4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int e = 0; e < DQ * 4; ++e) acc[r][e] = 0.0f;

  // causal: KV blocks from the first one past the query block's last row
  // on lie strictly after it and are skipped
  const int kv_end = causal ? min(SK, q0 + kBQ) : SK;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBKV) {
    __syncthreads();                     // ks/vs/pt free; qs staged
    for (int idx = tid; idx < kBKV * DP; idx += kThreads) {
      const int j = idx / DP, c = idx % DP;
      const bool in = kv0 + j < SK && c < d;
      const size_t g = (size_t)(kv0 + j) * d + c;
      ks[j * QS + c] = in ? to_f(kb[g]) : 0.0f;
      vs[j * DP + c] = in ? to_f(vb[g]) : 0.0f;
    }
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[r][jj] = 0.0f;
    for (int c = 0; c < DP; c += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(&qs[(2 * ty) * QS + c]);
      const float4 qc =
          *reinterpret_cast<const float4*>(&qs[(2 * ty + 1) * QS + c]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&ks[(tx + 8 * jj) * QS + c]);
        s[0][jj] = fmaf(qa.x, kk.x, s[0][jj]);
        s[0][jj] = fmaf(qa.y, kk.y, s[0][jj]);
        s[0][jj] = fmaf(qa.z, kk.z, s[0][jj]);
        s[0][jj] = fmaf(qa.w, kk.w, s[0][jj]);
        s[1][jj] = fmaf(qc.x, kk.x, s[1][jj]);
        s[1][jj] = fmaf(qc.y, kk.y, s[1][jj]);
        s[1][jj] = fmaf(qc.z, kk.z, s[1][jj]);
        s[1][jj] = fmaf(qc.w, kk.w, s[1][jj]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + 2 * ty + r;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = kv0 + tx + 8 * jj;
        const bool keep = kpos < kv_len && (!causal || kpos <= qpos);
        s[r][jj] = keep ? s[r][jj] * scale : kNegInf;
        mx = fmaxf(mx, s[r][jj]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[r], mx);
      float psum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p =
            s[r][jj] > kNegInf / 2 ? expf(s[r][jj] - m_new) : 0.0f;
        psum += p;
        pt[(tx + 8 * jj) * kPtStride + 2 * ty + r] = pv_round<T>(p);
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      const float alpha = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha + psum;
      m_run[r] = m_new;
#pragma unroll
      for (int e = 0; e < DQ * 4; ++e) acc[r][e] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < kBKV; ++j) {
      const float2 pp =
          *reinterpret_cast<const float2*>(&pt[j * kPtStride + 2 * ty]);
#pragma unroll
      for (int qq = 0; qq < DQ; ++qq) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[j * DP + qq * 32 + tx * 4]);
        acc[0][qq * 4 + 0] = fmaf(pp.x, vv.x, acc[0][qq * 4 + 0]);
        acc[0][qq * 4 + 1] = fmaf(pp.x, vv.y, acc[0][qq * 4 + 1]);
        acc[0][qq * 4 + 2] = fmaf(pp.x, vv.z, acc[0][qq * 4 + 2]);
        acc[0][qq * 4 + 3] = fmaf(pp.x, vv.w, acc[0][qq * 4 + 3]);
        acc[1][qq * 4 + 0] = fmaf(pp.y, vv.x, acc[1][qq * 4 + 0]);
        acc[1][qq * 4 + 1] = fmaf(pp.y, vv.y, acc[1][qq * 4 + 1]);
        acc[1][qq * 4 + 2] = fmaf(pp.y, vv.z, acc[1][qq * 4 + 2]);
        acc[1][qq * 4 + 3] = fmaf(pp.y, vv.w, acc[1][qq * 4 + 3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 2 * ty + r;
    if (qi >= S) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    T* orow = o + ((size_t)bh * S + qi) * d;
#pragma unroll
    for (int qq = 0; qq < DQ; ++qq)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = qq * 32 + tx * 4 + e;
        if (c < d) orow[c] = from_f<T>(acc[r][qq * 4 + e] / l);
      }
  }
}

template <typename T, int DQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int S, int SK, int d, int kv_len, int causal,
                   float scale, cudaStream_t stream) {
  constexpr int DP = DQ * 32;
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + kBKV) * (DP + 4) + (size_t)kBKV * DP +
                       (size_t)kBKV * kPtStride);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(BH, (S + kBQ - 1) / kBQ);
  flash_attention_kernel<T, DQ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, SK, d, kv_len, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int BH, int S, int SK, int d, int kv_len, int causal,
                     float scale, cudaStream_t s) {
  switch ((d + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, BH, S, SK, d, kv_len, causal, scale, s);
    case 2: return launch<T, 2>(q, k, v, o, BH, S, SK, d, kv_len, causal, scale, s);
    case 3: return launch<T, 3>(q, k, v, o, BH, S, SK, d, kv_len, causal, scale, s);
    case 4: return launch<T, 4>(q, k, v, o, BH, S, SK, d, kv_len, causal, scale, s);
    case 5: return launch<T, 5>(q, k, v, o, BH, S, SK, d, kv_len, causal, scale, s);
    case 6: return launch<T, 6>(q, k, v, o, BH, S, SK, d, kv_len, causal, scale, s);
    case 7: return launch<T, 7>(q, k, v, o, BH, S, SK, d, kv_len, causal, scale, s);
    case 8: return launch<T, 8>(q, k, v, o, BH, S, SK, d, kv_len, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [BH, S, d], k and v [BH, SK, d], o [BH, S, d], contiguous on the
// device, fp32 (bf16 = 0) or bf16 (bf16 = 1); 1 <= d <= 256 and
// 0 <= kv_len <= SK.  Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int BH, int S,
                                   int SK, int d, int kv_len, int causal,
                                   int bf16, float scale, void* stream) {
  if (BH <= 0 || S <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, BH, S, SK, d, kv_len, causal,
                                     scale, s)
           : dispatch<float>(q, k, v, o, BH, S, SK, d, kv_len, causal, scale,
                             s);
  return static_cast<int>(err);
}
