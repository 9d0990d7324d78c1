// NEST GEMM for Hopper: O = act(X[M, K] @ W[K, N]) in full fp32.
//
// Replaces: repro/kernels/nest_gemm.py, nest_gemm / _nest_gemm_kernel
// (the Pallas TPU kernel behind every Program launch of the compiled
// backend).
//
// What bounds it on an H100: at the decode shapes of the main path
// (M <= 8 stacked rows against a 3072..256000-wide weight) every weight
// element is used by at most 8 rows, so the kernel does at most 16 flops
// per 4 weight bytes -- far below the ~20 flops/byte at which fp32 FFMA
// (67 TFLOP/s) instead of HBM (3.35 TB/s) would become the limit.  The
// weight bytes are the bound.
//
// What the design does about it:
//   * one block covers a strip of W columns -- 16 (4 column threads x one
//     float4) where N is a 3072..4096-wide projection, so even those
//     spread over 192+ blocks, or 32 (two float4 per thread) where N is
//     wide enough to fill the card -- and up to 8 rows of X, so every
//     weight byte is read from HBM once for the whole decode batch;
//   * each thread keeps 8 float4 weight loads in flight, issued before
//     the X chunk they multiply is staged in shared memory, so one HBM
//     latency (not two) is paid per chunk;
//   * no split-K across blocks and no atomics: the 64 K groups of a block
//     each sum k = g, g+64, g+128, ... in ascending order, a warp's 8
//     groups are added by a fixed shuffle tree and the 8 warps in warp
//     order.  That order depends on K alone -- not on M, on the row's
//     position, on the strip width or on the caller's block sizes -- so
//     a row stacked into a decode batch is bit-equal to the same row
//     launched alone;
//   * the activation (relu / tanh-gelu / silu) is applied at the store,
//     and ``out_t`` stores the (N, M) transposed output directly (the
//     IO-S / BIRRD output relayout of the TPU kernel's ``out_block_t``).
// No tensor cores: fp32 operands would need TF32, whose ~1e-3 relative
// error sits at the serving checksum's quantum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 64;                      // K groups per block
constexpr int kColThreads = 4;                   // threads across columns
constexpr int kThreads = kGroups * kColThreads;  // 256
constexpr int kWarps = kThreads / 32;            // 8 groups per warp
constexpr int kWideN = 8192;                     // 32-column strips from here

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case 1:
      return fmaxf(v, 0.0f);
    case 2: {  // tanh approximation, jax.nn.gelu's default
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return v * (0.5f * (1.0f + tanhf(c * (v + 0.044715f * v * v * v))));
    }
    case 3:
      return v / (1.0f + expf(-v));
    default:
      return v;
  }
}

// SUB consecutive columns of row k from column n0 (zero past the edges)
template <int SUB>
__device__ __forceinline__ void load_w(const float* __restrict__ w, int k,
                                       int n0, int K, int N, float* out) {
  if (SUB == 4) {
    if (k < K && n0 < N) {
      const float4 t =
          __ldg(reinterpret_cast<const float4*>(w + (size_t)k * N + n0));
      out[0] = t.x;
      out[1] = t.y;
      out[2] = t.z;
      out[3] = t.w;
    } else {
      out[0] = out[1] = out[2] = out[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int v = 0; v < SUB; ++v)
      out[v] = (k < K && n0 + v < N) ? __ldg(w + (size_t)k * N + n0 + v)
                                     : 0.0f;
  }
}

// VEC columns per thread: VEC / SUB loads of SUB columns, the loads of
// one thread kColThreads * SUB columns apart
template <int BM, int VEC>
__global__ void __launch_bounds__(kThreads)
    nest_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ o, int M, int K, int N, int out_t,
                     int act) {
  constexpr int SUB = VEC >= 4 ? 4 : 1;
  constexpr int kLoads = VEC / SUB;
  constexpr int kStride = kColThreads * SUB;     // columns between loads
  constexpr int kCols = kColThreads * VEC;       // columns of one block
  constexpr int kUnroll = 8 / kLoads;            // 8 loads in flight
  constexpr int kChunk = kGroups * kUnroll;      // k per staged X chunk
  __shared__ float xs[BM][kChunk];
  __shared__ float red[kWarps][BM][kCols];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int tc = tid % kColThreads;
  const int g = tid / kColThreads;
  const int col0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * BM;

  float acc[BM][VEC];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.0f;

  for (int kc = 0; kc < K; kc += kChunk) {
    float wv[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < kLoads; ++j)
        load_w<SUB>(w, kc + g + u * kGroups, col0 + j * kStride + tc * SUB,
                    K, N, &wv[u][j * SUB]);
    for (int i = tid; i < BM * kChunk; i += kThreads) {
      const int r = i / kChunk, c = i % kChunk;
      const int m = m0 + r, k = kc + c;
      xs[r][c] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float xv = xs[r][g + u * kGroups];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(xv, wv[u][v], acc[r][v]);
      }
    }
    __syncthreads();
  }

  // the warp's 8 K groups (lanes tc, tc+4, ..., tc+28) by a fixed tree
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float s = acc[r][v];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < kColThreads)
        red[warp][r][(v / SUB) * kStride + tc * SUB + v % SUB] = s;
    }
  __syncthreads();

  for (int i = tid; i < BM * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    const int m = m0 + r, n = col0 + c;
    if (m >= M || n >= N) continue;
    float s = red[0][r][c];
#pragma unroll
    for (int ww = 1; ww < kWarps; ++ww) s += red[ww][r][c];
    s = apply_act(s, act);
    if (out_t)
      o[(size_t)n * M + m] = s;
    else
      o[(size_t)m * N + n] = s;
  }
}

template <int BM, int VEC>
cudaError_t launch(const float* x, const float* w, float* o, int M, int K,
                   int N, int out_t, int act, cudaStream_t stream) {
  constexpr int kCols = kColThreads * VEC;
  dim3 grid((N + kCols - 1) / kCols, (M + BM - 1) / BM);
  nest_gemm_kernel<BM, VEC>
      <<<grid, kThreads, 0, stream>>>(x, w, o, M, K, N, out_t, act);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch_rows(const float* x, const float* w, float* o, int M,
                          int K, int N, int out_t, int act,
                          cudaStream_t stream) {
  if (M <= 1) return launch<1, VEC>(x, w, o, M, K, N, out_t, act, stream);
  if (M <= 2) return launch<2, VEC>(x, w, o, M, K, N, out_t, act, stream);
  if (M <= 4) return launch<4, VEC>(x, w, o, M, K, N, out_t, act, stream);
  return launch<8, VEC>(x, w, o, M, K, N, out_t, act, stream);
}

}  // namespace

// x [M, K], w [K, N] row-major contiguous fp32 on the device; o is
// [M, N], or [N, M] when out_t.  act: 0 none, 1 relu, 2 gelu (tanh),
// 3 silu.  Launches on ``stream``; returns the launch's cudaError_t.
extern "C" int nest_gemm_f32(const void* x, const void* w, void* o, int M,
                             int K, int N, int out_t, int act, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 =
      (N % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  if (!vec4)
    return static_cast<int>(dispatch_rows<1>(xf, wf, of, M, K, N, out_t, act, s));
  if (N >= kWideN)
    return static_cast<int>(dispatch_rows<8>(xf, wf, of, M, K, N, out_t, act, s));
  return static_cast<int>(dispatch_rows<4>(xf, wf, of, M, K, N, out_t, act, s));
}
