// The backward of prefill flash attention (causal or full) for Hopper,
// fp32 or bf16 inputs, every product and sum in fp32 on the FMA pipes.
//
// Replaces: the gradient of repro/kernels/flash_attention.py's
// flash_attention.  The TPU kernel has no backward of its own: the JAX
// package differentiates the plain attention of its train path
// (repro/models/attention.py, _attend_full) by XLA autodiff.  This
// computes the same gradients from the forward's saved output o and
// log-sum-exp lse (flash_attention.cu writes lse when a gradient is
// wanted):
//
//   P  = exp(S * scale - lse)      on the kept (query, key) pairs, else 0
//   D  = rowsum(dO * O)
//   dV = P^T dO                    dP = dO V^T
//   dS = P * (dP - D)
//   dQ = dS K * scale              dK = dS^T Q * scale
//
// Masking is the forward's: keys at or past kv_len, and with causal keys
// after the query; a masked pair has P = 0 (never exp of a sentinel), so a
// row with every key masked (lse = +inf) gives zero gradients, not NaN.
//
// Two launches on the caller's stream, each sum in one block in a fixed
// order (no atomics, so two runs give the same bits):
//   dq_kernel   one block per (head, 32 query rows): D from dO and O
//               (kept in a [BH, S] scratch for the second launch), then
//               the key tiles up to the causal edge, dQ in registers;
//   dkv_kernel  one block per (head, 32 keys): the query tiles from the
//               causal edge down, dK and dV in registers.
// Each recomputes S and dP for its pairs (five products in all, two of
// them twice).
//
// What bounds it on an H100: operations.  At zamba2-1.2b's shared
// attention in training (64 heads of 64, S 1024, causal) the five
// products are 1.1e10 flops; the kernel does seven (S and dP twice) on
// FFMA (67 TFLOP/s): 0.23 ms at best, where bf16 tensor cores would take
// 0.011 ms.  A tile is staged in shared memory (rows padded by one word,
// so the dot products' column reads hit distinct banks) and each thread
// reads an operand per FMA: the shared-memory pipe, not FFMA, is the
// limit of this first version.  mma.sync or wgmma tiles are later work
// (ROADMAP B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;                  // query rows a tile
constexpr int kBK = 32;                  // keys a tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [r0, r0 + kBQ) of a [n_rows, d] matrix into shared memory as fp32,
// rows DP + 1 floats apart, zero past n_rows and past d
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int n_rows, int d) {
  for (int i = threadIdx.x; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    const bool in = r0 + r < n_rows && c < d;
    dst[r * (DP + 1) + c] = in ? to_f32(src[(size_t)(r0 + r) * d + c]) : 0.0f;
  }
}

// S = A B^T and dP = C E^T for a thread's 2 x 2 pairs: rows ty and ty + 16
// of A and C, rows tx and tx + 16 of B and E (all [32, DP + 1] in shared
// memory), each dot product summed over the columns in order
template <int DP>
__device__ __forceinline__ void pair_products(const float* a, const float* b,
                                              const float* c, const float* e,
                                              int ty, int tx, float (*s)[2],
                                              float (*dp)[2]) {
  constexpr int R = DP + 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < DP; ++k) {
    const float a0 = a[ty * R + k], a1 = a[(ty + 16) * R + k];
    const float b0 = b[tx * R + k], b1 = b[(tx + 16) * R + k];
    const float c0 = c[ty * R + k], c1 = c[(ty + 16) * R + k];
    const float e0 = e[tx * R + k], e1 = e[(tx + 16) * R + k];
    s[0][0] = fmaf(a0, b0, s[0][0]);
    s[0][1] = fmaf(a0, b1, s[0][1]);
    s[1][0] = fmaf(a1, b0, s[1][0]);
    s[1][1] = fmaf(a1, b1, s[1][1]);
    dp[0][0] = fmaf(c0, e0, dp[0][0]);
    dp[0][1] = fmaf(c0, e1, dp[0][1]);
    dp[1][0] = fmaf(c1, e0, dp[1][0]);
    dp[1][1] = fmaf(c1, e1, dp[1][1]);
  }
}

// ------------------------------------------------------- dQ (and D) ----

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const float* __restrict__ lse, const T* __restrict__ dout,
              T* __restrict__ dq, float* __restrict__ dsum, int BH, int S,
              int SK, int d, int kv_len, int causal, float scale) {
  constexpr int R = DP + 1;
  constexpr int kPer = kBQ * DP / kThreads;        // dQ entries a thread
  extern __shared__ float smem[];
  float* qs = smem;                                // [kBQ, R]
  float* dos = qs + kBQ * R;                       // [kBQ, R]
  float* ks = dos + kBQ * R;                       // [kBK, R]
  float* vs = ks + kBK * R;                        // [kBK, R]
  float* dss = vs + kBK * R;                       // [kBQ, kBK + 1]
  float* lse2 = dss + kBQ * (kBK + 1);             // [kBQ], base 2
  float* dd = lse2 + kBQ;                          // [kBQ]

  const int n_qb = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / n_qb;
  const int q0 = (blockIdx.x % n_qb) * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * S * d, koff = (size_t)bh * SK * d;

  stage<T, DP>(qs, q + qoff, q0, S, d);
  stage<T, DP>(dos, dout + qoff, q0, S, d);
  // D = rowsum(dO * O), a warp a row, lanes over the columns then a
  // shuffle tree: the same order in every run
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const int row = q0 + r;
    float acc = 0.0f;
    if (row < S)
      for (int c = lane; c < d; c += 32)
        acc = fmaf(to_f32(dout[qoff + (size_t)row * d + c]),
                   to_f32(o[qoff + (size_t)row * d + c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      dd[r] = acc;
      lse2[r] = row < S ? lse[(size_t)bh * S + row] * kLog2e
                        : __int_as_float(0x7f800000);
      if (row < S) dsum[(size_t)bh * S + row] = acc;
    }
  }

  float acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = 0.0f;

  const int kv_end = min(kv_len, causal ? min(SK, q0 + kBQ) : SK);
  const float scale_log2 = scale * kLog2e;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();                   // the last tile's dS and K are used
    stage<T, DP>(ks, k + koff, kv0, SK, d);
    stage<T, DP>(vs, v + koff, kv0, SK, d);
    __syncthreads();
    float s[2][2], dp[2][2];
    pair_products<DP>(qs, ks, dos, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, col = tx + 16 * j;
        const int row = q0 + r, key = kv0 + col;
        const bool keep = row < S && key < kv_len && (!causal || key <= row);
        const float p = keep ? exp2f(s[i][j] * scale_log2 - lse2[r]) : 0.0f;
        dss[r * (kBK + 1) + col] = p * (dp[i][j] - dd[r]);
      }
    __syncthreads();
    // dQ[r][c] += sum_j dS[r][j] K[j][c]
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int r = idx / DP, c = idx % DP;
      float a = acc[e];
#pragma unroll 8
      for (int j = 0; j < kBK; ++j)
        a = fmaf(dss[r * (kBK + 1) + j], ks[j * R + c], a);
      acc[e] = a;
    }
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int r = idx / DP, c = idx % DP;
    if (q0 + r < S && c < d)
      dq[qoff + (size_t)(q0 + r) * d + c] = from_f32<T>(acc[e] * scale);
  }
}

// ------------------------------------------------------------ dK, dV ----

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ lse,
               const T* __restrict__ dout, const float* __restrict__ dsum,
               T* __restrict__ dk, T* __restrict__ dv, int BH, int S, int SK,
               int d, int kv_len, int causal, float scale) {
  constexpr int R = DP + 1;
  constexpr int kPer = kBK * DP / kThreads;        // entries of dK (and dV)
  extern __shared__ float smem[];
  float* ks = smem;                                // [kBK, R]
  float* vs = ks + kBK * R;                        // [kBK, R]
  float* qs = vs + kBK * R;                        // [kBQ, R]
  float* dos = qs + kBQ * R;                       // [kBQ, R]
  float* ps = dos + kBQ * R;                       // [kBQ, kBK + 1]
  float* dss = ps + kBQ * (kBK + 1);               // [kBQ, kBK + 1]
  float* lse2 = dss + kBQ * (kBK + 1);             // [kBQ]
  float* dd = lse2 + kBQ;                          // [kBQ]

  const int n_kb = (SK + kBK - 1) / kBK;
  const int bh = blockIdx.x / n_kb;
  const int kv0 = (blockIdx.x % n_kb) * kBK;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * S * d, koff = (size_t)bh * SK * d;

  float gk[kPer], gv[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) gk[e] = gv[e] = 0.0f;

  if (kv0 < kv_len) {                  // else every pair is masked: zeros
    stage<T, DP>(ks, k + koff, kv0, SK, d);
    stage<T, DP>(vs, v + koff, kv0, SK, d);
    const float scale_log2 = scale * kLog2e;
    // a causal key tile meets no query row before its first key
    const int q_start = causal ? (kv0 / kBQ) * kBQ : 0;
    for (int q0 = q_start; q0 < S; q0 += kBQ) {
      __syncthreads();                 // the last tile's P, dS, Q, dO used
      stage<T, DP>(qs, q + qoff, q0, S, d);
      stage<T, DP>(dos, dout + qoff, q0, S, d);
      if (threadIdx.x < kBQ) {
        const int row = q0 + threadIdx.x;
        lse2[threadIdx.x] = row < S ? lse[(size_t)bh * S + row] * kLog2e
                                    : __int_as_float(0x7f800000);
        dd[threadIdx.x] = row < S ? dsum[(size_t)bh * S + row] : 0.0f;
      }
      __syncthreads();
      float s[2][2], dp[2][2];
      pair_products<DP>(qs, ks, dos, vs, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = ty + 16 * i, col = tx + 16 * j;
          const int row = q0 + r, key = kv0 + col;
          const bool keep = row < S && key < kv_len && (!causal || key <= row);
          const float p = keep ? exp2f(s[i][j] * scale_log2 - lse2[r]) : 0.0f;
          ps[r * (kBK + 1) + col] = p;
          dss[r * (kBK + 1) + col] = p * (dp[i][j] - dd[r]);
        }
      __syncthreads();
      // dV[j][c] += sum_r P[r][j] dO[r][c];  dK[j][c] += sum_r dS[r][j] Q[r][c]
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int idx = threadIdx.x + e * kThreads;
        const int j = idx / DP, c = idx % DP;
        float a = gv[e], b = gk[e];
#pragma unroll 8
        for (int r = 0; r < kBQ; ++r) {
          a = fmaf(ps[r * (kBK + 1) + j], dos[r * R + c], a);
          b = fmaf(dss[r * (kBK + 1) + j], qs[r * R + c], b);
        }
        gv[e] = a;
        gk[e] = b;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int j = idx / DP, c = idx % DP;
    if (kv0 + j < SK && c < d) {
      const size_t at = koff + (size_t)(kv0 + j) * d + c;
      dk[at] = from_f32<T>(gk[e] * scale);
      dv[at] = from_f32<T>(gv[e]);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* dsum, int BH, int S,
                   int SK, int d, int kv_len, int causal, float scale,
                   cudaStream_t stream) {
  constexpr int R = DP + 1;
  const size_t smem_q =
      sizeof(float) * ((size_t)4 * kBQ * R + kBQ * (kBK + 1) + 2 * kBQ);
  const size_t smem_kv =
      sizeof(float) * ((size_t)4 * kBQ * R + 2 * kBQ * (kBK + 1) + 2 * kBQ);
  auto kq = dq_kernel<T, DP>;
  auto kkv = dkv_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  kq<<<BH * ((S + kBQ - 1) / kBQ), kThreads, smem_q, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), lse, dot, static_cast<T*>(dq),
      dsum, BH, S, SK, d, kv_len, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (SK > 0)
    kkv<<<BH * ((SK + kBK - 1) / kBK), kThreads, smem_kv, stream>>>(
        qt, kt, vt, lse, dot, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
        BH, S, SK, d, kv_len, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const float* lse, const void* dout,
                     void* dq, void* dk, void* dv, float* dsum, int BH, int S,
                     int SK, int d, int kv_len, int causal, float scale,
                     cudaStream_t s) {
#define FA_BWD_LAUNCH(DP)                                                    \
  return launch<T, DP>(q, k, v, o, lse, dout, dq, dk, dv, dsum, BH, S, SK, d, \
                       kv_len, causal, scale, s)
  switch ((d + 31) / 32) {
    case 1: FA_BWD_LAUNCH(32);
    case 2: FA_BWD_LAUNCH(64);
    case 3: FA_BWD_LAUNCH(96);
    case 4: FA_BWD_LAUNCH(128);
    case 5:
    case 6: FA_BWD_LAUNCH(192);
    case 7:
    case 8: FA_BWD_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef FA_BWD_LAUNCH
}

}  // namespace

// q, o, dout, dq [BH, S, d], k, v, dk, dv [BH, SK, d], contiguous on the
// device, all fp32 (bf16 = 0) or all bf16 (bf16 = 1); lse [BH, S] fp32
// (the forward's, natural log) and dsum [BH, S] fp32 scratch (D, written
// by the first launch, read by the second); 1 <= d <= 256 and
// 0 <= kv_len <= SK.  Returns the launches' cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* dsum,
                                   int BH, int S, int SK, int d, int kv_len,
                                   int causal, int bf16, float scale,
                                   void* stream) {
  if (BH <= 0 || S <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, l, dout, dq, dk, dv, ds, BH,
                                     S, SK, d, kv_len, causal, scale, s)
           : dispatch<float>(q, k, v, o, l, dout, dq, dk, dv, ds, BH, S, SK,
                             d, kv_len, causal, scale, s);
  return static_cast<int>(err);
}
