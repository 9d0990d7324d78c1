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
// weight bytes are the bound.  At prefill (M = 32 rows) the two bounds
// meet -- lm_head has 0.94 ms of bytes and 0.75 ms of FFMA -- so the
// weight must be read once for all 32 rows and the FFMA kept fed; there
// the FFMA loop, fed from shared memory at one block an SM, is the limit
// (lm_head: about 1.6 ms of compute beside 1.1 ms of weight stream when
// each runs alone, on an H100 80GB HBM3 at 700 W).
//
// What the design does about it, by rows:
//   * up to 8 rows (nest_gemm_kernel, the decode tick): one block covers
//     a strip of W columns -- 16 (4 column threads x one float4) where N
//     is a 3072..4096-wide projection, so even those spread over 192+
//     blocks, or 32 (two float4 per thread) where N is wide enough to
//     fill the card -- and up to 8 rows of X, so every weight byte is
//     read from HBM once for the whole decode batch; each thread keeps 8
//     float4 weight loads in flight, issued before the X chunk they
//     multiply is staged in shared memory;
//   * 9 to 16 rows (on the main path only prefill's small attention
//     GEMMs): the same kernel, two row blocks of 8 along grid y;
//   * past 16 rows on a weight narrower than 8192 columns
//     (nest_gemm_tall_kernel): row blocks of 32 on 16-column strips (a
//     thread holds 16 rows x 4 columns; the block is two 256-thread
//     halves on the same W chunk), one block an SM: the blocks are
//     persistent, and W and X chunks both arrive by 16-byte cp.async
//     into a 3-deep ring in shared memory, two chunks ahead of the FFMA
//     and across tiles;
//   * past 16 rows on a wide weight (nest_gemm_wide_kernel: lm_head,
//     mlp.up): 32 rows x 256 columns a block, the K groups one after
//     another and folded into the same tree (below), so each weight byte
//     is read once for 32 rows and X once for 256 columns; a first
//     kernel (group_rows) lays X out group-major, so such a call is two
//     launches;
//   * past 32 rows the row blocks of 32 are more tiles: grid y on the
//     wide path, the persistent blocks' tile walk on the tall one;
//   * no split-K across blocks and no atomics: each of the 64 K groups
//     sums k = g, g+64, g+128, ... in ascending order, a warp's 8 groups
//     are added by a fixed shuffle tree and the 8 warps in warp order.
//     That order depends on K alone -- not on M, on the row block, on the
//     row's position, on the strip width or on the caller's block sizes
//     -- so a row stacked into a decode or prefill batch is bit-equal to
//     the same row launched alone;
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Row blocks of 32: the same 64 K groups, 4 column threads and
// reduction as nest_gemm_kernel, so the same sums; VEC 4 (16-column
// strips) or 1 (N not a multiple of 4).  A thread holds 16 rows x VEC
// columns of accumulators; the row block is two halves of 256 threads
// on the same W chunk, 16 warps at 128 registers.  That
// leaves one block an SM, so nothing else would hide a load or a block's
// start and end: the blocks are persistent, one an SM, each walking tiles
// (row block, strip) blockIdx.x, + gridDim.x, ... while W and X chunks of
// kTallChunk k arrive by 16-byte cp.async into a ring of kStages buffers,
// two chunks ahead of the one computed and across tile boundaries.  X
// stays row-major: a warp's 8 K groups read 8 neighbouring floats of one
// row, one shared-memory wavefront.
constexpr int kTallChunk = 256;
constexpr int kStages = 3;
constexpr int kHalfRows = 16;

template <int BM, int VEC>
struct Tall {
  static constexpr int kHalves = BM / kHalfRows;
  static constexpr int kBlock = kThreads * kHalves;
  static constexpr int kCols = kColThreads * VEC;
  static constexpr int kXs = BM * kTallChunk;     // floats of an X stage
  static constexpr int kWs = kTallChunk * kCols;  // floats of a W stage
  static constexpr int kRed = kWarps * BM * kCols;
  static constexpr size_t kSmem =
      sizeof(float) * (kStages * (kXs + kWs) + kRed);
};

template <int BM, int VEC>
__global__ void __launch_bounds__(Tall<BM, VEC>::kBlock)
    nest_gemm_tall_kernel(const float* __restrict__ x,
                          const float* __restrict__ w, float* __restrict__ o,
                          int M, int K, int N, int out_t, int act) {
  using T = Tall<BM, VEC>;
  constexpr int kCols = T::kCols, kBlock = T::kBlock;
  constexpr int kU = kTallChunk / kGroups;  // k of a group per chunk
  extern __shared__ float4 dyn4[];
  float* xs = reinterpret_cast<float*>(dyn4);  // [kStages][BM][chunk]
  float* ws = xs + kStages * T::kXs;           // [kStages][chunk][kCols]
  float* red = ws + kStages * T::kWs;          // [kWarps][BM][kCols]

  const int tid = threadIdx.x;
  const int half = tid / kThreads, ht = tid % kThreads;
  const int lane = ht % 32, warp = ht / 32;
  const int tc = ht % kColThreads;
  const int g = ht / kColThreads;
  const int row0 = half * kHalfRows;  // this thread's rows in the block
  const int n_chunks = K > 0 ? (K + kTallChunk - 1) / kTallChunk : 1;
  const int n_rb = (M + BM - 1) / BM;
  const int n_tiles = n_rb * ((N + kCols - 1) / kCols);
  const int my_tiles = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int total = my_tiles * n_chunks;  // chunks this block computes

  const bool xvec =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

  // the row blocks of a strip are neighbouring tiles, so they run at
  // once and the second reads W from L2
  auto tile_of = [&](int i, int& m0, int& col0) {
    const int t = blockIdx.x + i * gridDim.x;
    m0 = (t % n_rb) * BM;
    col0 = (t / n_rb) * kCols;
  };

  auto stage = [&](int p) {
    int m0, col0;
    tile_of(p / n_chunks, m0, col0);
    float* xd = xs + (p % kStages) * T::kXs;
    float* wd = ws + (p % kStages) * T::kWs;
    const int kc = (p % n_chunks) * kTallChunk;
    if (xvec) {
#pragma unroll
      for (int e = tid; e < BM * kTallChunk / 4; e += kBlock) {
        const int r = e / (kTallChunk / 4), c = 4 * (e % (kTallChunk / 4));
        const bool ok = m0 + r < M && kc + c < K;
        cp_async16(xd + r * kTallChunk + c,
                   ok ? x + (size_t)(m0 + r) * K + kc + c : x, ok);
      }
    } else {
      for (int e = tid; e < BM * kTallChunk; e += kBlock) {
        const int r = e / kTallChunk, c = e % kTallChunk;
        const bool ok = m0 + r < M && kc + c < K;
        cp_async4(xd + r * kTallChunk + c,
                  ok ? x + (size_t)(m0 + r) * K + kc + c : x, ok);
      }
    }
    if constexpr (VEC == 4) {
#pragma unroll
      for (int e = tid; e < kTallChunk * kColThreads; e += kBlock) {
        const int kk = e / kColThreads, c = 4 * (e % kColThreads);
        const bool ok = kc + kk < K && col0 + c < N;
        cp_async16(wd + kk * kCols + c,
                   ok ? w + (size_t)(kc + kk) * N + col0 + c : w, ok);
      }
    } else {
#pragma unroll
      for (int e = tid; e < kTallChunk * kCols; e += kBlock) {
        const int kk = e / kCols, c = e % kCols;
        const bool ok = kc + kk < K && col0 + c < N;
        cp_async4(wd + kk * kCols + c,
                  ok ? w + (size_t)(kc + kk) * N + col0 + c : w, ok);
      }
    }
  };

  float acc[kHalfRows][VEC];
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) stage(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int p = 0; p < total; ++p) {
    // this thread's copies of chunk p have landed; the barrier makes
    // everyone's visible and frees the stage chunk p - 1 used
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    if (p + kStages - 1 < total) stage(p + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int ch = p % n_chunks;
    if (ch == 0) {
#pragma unroll
      for (int r = 0; r < kHalfRows; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] = 0.0f;
    }
    const float* xk = xs + (p % kStages) * T::kXs + row0 * kTallChunk;
    const float* wk = ws + (p % kStages) * T::kWs;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kk = g + u * kGroups;
      float wv[VEC];
      if constexpr (VEC == 4) {
        const float4 t =
            *reinterpret_cast<const float4*>(wk + kk * kCols + 4 * tc);
        wv[0] = t.x;
        wv[1] = t.y;
        wv[2] = t.z;
        wv[3] = t.w;
      } else {
        wv[0] = wk[kk * kCols + tc];
      }
#pragma unroll
      for (int r = 0; r < kHalfRows; ++r) {
        const float xv = xk[r * kTallChunk + kk];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(xv, wv[v], acc[r][v]);
      }
    }
    if (ch != n_chunks - 1) continue;

    // the tile's last chunk: nest_gemm_kernel's tree over a warp's 8 K
    // groups, then the 8 warps of the half in order, while the next
    // tile's first chunks are in flight
    int m0, col0;
    tile_of(p / n_chunks, m0, col0);
#pragma unroll
    for (int r = 0; r < kHalfRows; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float s = acc[r][v];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane < kColThreads)
          red[(warp * BM + row0 + r) * kCols + tc * VEC + v] = s;
      }
    __syncthreads();
    for (int i = tid; i < BM * kCols; i += kBlock) {
      const int r = i / kCols, c = i % kCols;
      const int m = m0 + r, n = col0 + c;
      if (m >= M || n >= N) continue;
      float s = red[r * kCols + c];
#pragma unroll
      for (int ww = 1; ww < kWarps; ++ww)
        s += red[(ww * BM + r) * kCols + c];
      s = apply_act(s, act);
      if (out_t)
        o[(size_t)n * M + m] = s;
      else
        o[(size_t)m * N + n] = s;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int BM, int VEC>
cudaError_t launch_tall(const float* x, const float* w, float* o, int M,
                        int K, int N, int out_t, int act,
                        cudaStream_t stream) {
  constexpr size_t smem = Tall<BM, VEC>::kSmem;
  // once per instance: the opt-in past 48 KB (the kernel has no static
  // shared memory, so the dynamic bytes are all of it), and how many
  // blocks the card holds at once
  static int resident = 0;
  static const cudaError_t ready = [] {
    cudaError_t err = cudaFuncSetAttribute(
        nest_gemm_tall_kernel<BM, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, nest_gemm_tall_kernel<BM, VEC>, Tall<BM, VEC>::kBlock,
          smem);
    if (err == cudaSuccess && per_sm < 1) err = cudaErrorLaunchOutOfResources;
    resident = sms * per_sm;
    return err;
  }();
  if (ready != cudaSuccess) return ready;
  constexpr int kCols = Tall<BM, VEC>::kCols;
  const long long tiles = (long long)((M + BM - 1) / BM) *
                          ((N + kCols - 1) / kCols);
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  nest_gemm_tall_kernel<BM, VEC><<<grid, Tall<BM, VEC>::kBlock, smem,
                                   stream>>>(x, w, o, M, K, N, out_t, act);
  return cudaGetLastError();
}

// Past 16 rows on a wide weight (N >= kWideN, N % 4 == 0): the same sums
// in another loop order.  A block covers 32 rows x 256 columns, a thread
// 8 rows x 4 columns, and the 64 K groups run one after another instead
// of side by side: group g's chain over k = g, g + 64, ... is summed in
// full, then folded into nest_gemm_kernel's tree -- pairs of groups, then
// pairs of pairs, then the two quads of a warp's 8 groups, then the 8
// warps' sums in order -- by a stack of 4 partials.  5 registers an
// output instead of 64 let one block hold 16x the outputs, so every
// weight byte feeds 32 rows straight from shared memory and X is read
// once for 256 columns.  X is first laid out group-major (group_rows),
// so a chunk of J k of one group is contiguous; W and X chunks arrive by
// 16-byte cp.async into a ring of kStages buffers.  J is 48 where a
// group's k divide by it (K = 3072 or 24576: a third as many barriers),
// else 16.
constexpr int kWideRows = 32;
constexpr int kWideCols = 256;

template <int J>
struct Wide {
  static constexpr int kStages = J == 16 ? 6 : 4;
  static constexpr int kXs = J * kWideRows;  // floats of an X stage
  static constexpr int kWs = J * kWideCols;  // floats of a W stage
  static constexpr size_t kSmem = sizeof(float) * kStages * (kXs + kWs);
};

// a chunk's k for this K, and the k of a group padded to whole chunks
inline int wide_j(int K) {
  const int jg = (K + kGroups - 1) / kGroups;
  return jg > 0 && jg % 48 == 0 ? 48 : 16;
}
inline int wide_jp(int K) {
  const int jg = (K + kGroups - 1) / kGroups, j = wide_j(K);
  return (jg > 0 ? (jg + j - 1) / j : 1) * j;
}

// xg[row block][g][j][r] = x[32 rb + r][g + 64 j], zero outside x
__global__ void group_rows(const float* __restrict__ x, float* __restrict__ xg,
                           int M, int K, int jp, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int r = i % kWideRows;
  const long long rest = i / kWideRows;
  const int j = rest % jp;
  const long long gb = rest / jp;
  const int g = gb % kGroups;
  const int m = (int)(gb / kGroups) * kWideRows + r;
  const int k = g + kGroups * j;
  xg[i] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.0f;
}

template <int J>
__global__ void __launch_bounds__(kThreads)
    nest_gemm_wide_kernel(const float* __restrict__ xg,
                          const float* __restrict__ w, float* __restrict__ o,
                          int M, int K, int N, int jp, int out_t, int act) {
  using T = Wide<J>;
  constexpr int kRing = T::kStages;
  extern __shared__ float4 dyn4[];
  float* xs = reinterpret_cast<float*>(dyn4);  // [kRing][J][32]
  float* ws = xs + kRing * T::kXs;             // [kRing][J][256]
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int rg = warp / 2;                // rows 8 rg .. 8 rg + 7
  const int cg = (warp % 2) * 32 + lane;  // columns 4 cg .. 4 cg + 3
  const int col0 = blockIdx.x * kWideCols;
  const int m0 = blockIdx.y * kWideRows;
  const int cpg = jp / J;  // chunks of a group
  const int total = kGroups * cpg;
  const float* xb = xg + (size_t)blockIdx.y * kGroups * jp * kWideRows;

  auto stage = [&](int p) {
    const int g = p / cpg, j0 = (p % cpg) * J;
    float* xd = xs + (p % kRing) * T::kXs;
    float* wd = ws + (p % kRing) * T::kWs;
    const float* xsrc = xb + ((size_t)g * jp + j0) * kWideRows;
#pragma unroll
    for (int e = tid; e < T::kXs / 4; e += kThreads)
      cp_async16(xd + 4 * e, xsrc + 4 * e, true);
#pragma unroll
    for (int e = tid; e < T::kWs / 4; e += kThreads) {
      const int jj = e / (kWideCols / 4), c = 4 * (e % (kWideCols / 4));
      const int k = g + kGroups * (j0 + jj);
      const bool ok = k < K && col0 + c < N;
      cp_async16(wd + 4 * e, ok ? w + (size_t)k * N + col0 + c : w, ok);
    }
  };

  // P: the current group's chain; A, B: the pairs of a quad; Q: the first
  // quad of the warp's 8 groups; S: the sum over warps so far
  float P[8][4], A[8][4], B[8][4], Q[8][4], S[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) P[r][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < total) stage(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int p = 0; p < total; ++p) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
    __syncthreads();
    if (p + kRing - 1 < total) stage(p + kRing - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* xk = xs + (p % kRing) * T::kXs + 8 * rg;
    const float* wk = ws + (p % kRing) * T::kWs + 4 * cg;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const float4 x0 = *reinterpret_cast<const float4*>(xk + jj * kWideRows);
      const float4 x1 =
          *reinterpret_cast<const float4*>(xk + jj * kWideRows + 4);
      const float4 t = *reinterpret_cast<const float4*>(wk + jj * kWideCols);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float wv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) P[r][c] = fmaf(xv[r], wv[c], P[r][c]);
    }
    if (p % cpg != cpg - 1) continue;
    // group g's chain is complete: fold it into the tree
    const int g = p / cpg, g8 = g % 8;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = P[r][c];
        P[r][c] = 0.0f;
        if (g8 == 0 || g8 == 4) {
          A[r][c] = v;
        } else if (g8 == 1 || g8 == 5) {
          A[r][c] = A[r][c] + v;
        } else if (g8 == 2 || g8 == 6) {
          B[r][c] = v;
        } else if (g8 == 3) {
          Q[r][c] = A[r][c] + (B[r][c] + v);
        } else {
          const float t = Q[r][c] + (A[r][c] + (B[r][c] + v));
          S[r][c] = g < 8 ? t : S[r][c] + t;
        }
      }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = m0 + 8 * rg + r, n = col0 + 4 * cg + c;
      if (m >= M || n >= N) continue;
      const float v = apply_act(S[r][c], act);
      if (out_t)
        o[(size_t)n * M + m] = v;
      else
        o[(size_t)m * N + n] = v;
    }
}

template <int J>
cudaError_t launch_wide_j(dim3 grid, const float* xg, const float* w,
                          float* o, int M, int K, int N, int jp, int out_t,
                          int act, cudaStream_t stream) {
  constexpr size_t smem = Wide<J>::kSmem;
  static const cudaError_t ready = cudaFuncSetAttribute(
      nest_gemm_wide_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (ready != cudaSuccess) return ready;
  nest_gemm_wide_kernel<J><<<grid, kThreads, smem, stream>>>(
      xg, w, o, M, K, N, jp, out_t, act);
  return cudaGetLastError();
}

cudaError_t launch_wide(const float* x, const float* w, float* o, int M,
                        int K, int N, int out_t, int act, float* scratch,
                        long long scratch_floats, cudaStream_t stream) {
  const int jp = wide_jp(K);
  const int row_blocks = (M + kWideRows - 1) / kWideRows;
  const long long total = (long long)row_blocks * kGroups * jp * kWideRows;
  if (scratch == nullptr || scratch_floats < total)
    return cudaErrorInvalidValue;
  group_rows<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
               stream>>>(x, scratch, M, K, jp, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((N + kWideCols - 1) / kWideCols, row_blocks);
  return wide_j(K) == 48
             ? launch_wide_j<48>(grid, scratch, w, o, M, K, N, jp, out_t, act,
                                 stream)
             : launch_wide_j<16>(grid, scratch, w, o, M, K, N, jp, out_t, act,
                                 stream);
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
// 3 silu.  Where the wide-weight path runs (M > 16, N >= 8192, N % 4 ==
// 0 and w 16-byte aligned), scratch holds X group-major:
// ceil(M / 32) * 64 * wide_jp(K) * 32 floats; elsewhere it is unused.
// Launches on ``stream`` (two launches on the wide path); returns the
// first failing launch's cudaError_t.
extern "C" int nest_gemm_f32(const void* x, const void* w, void* o, int M,
                             int K, int N, int out_t, int act, void* scratch,
                             long long scratch_floats, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 =
      (N % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  if (M > 16 && vec4 && N >= kWideN)
    return static_cast<int>(launch_wide(xf, wf, of, M, K, N, out_t, act,
                                        static_cast<float*>(scratch),
                                        scratch_floats, s));
  if (M > 16)  // row blocks of 32, tiled along the persistent grid
    return static_cast<int>(
        vec4 ? launch_tall<32, 4>(xf, wf, of, M, K, N, out_t, act, s)
             : launch_tall<32, 1>(xf, wf, of, M, K, N, out_t, act, s));
  if (!vec4)
    return static_cast<int>(dispatch_rows<1>(xf, wf, of, M, K, N, out_t, act, s));
  if (N >= kWideN)
    return static_cast<int>(dispatch_rows<8>(xf, wf, of, M, K, N, out_t, act, s));
  return static_cast<int>(dispatch_rows<4>(xf, wf, of, M, K, N, out_t, act, s));
}
