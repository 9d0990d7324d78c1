// The backward of the selective scan (mamba_scan.cu) for Hopper, fp32.
//
// Replaces: the gradient of repro/kernels/mamba_scan.py's mamba_scan.  The
// TPU kernel has no backward of its own: the JAX package differentiates
// its chunked scan (repro/models/ssm.py, _ssm_scan_fused) by XLA
// autodiff.  Given the forward's inputs, the states it stored every 16
// steps, and the gradients of its outputs (dy [B, L, D], dh_last [B, D,
// N] or none), with g_t the gradient that reaches h_t:
//
//   g_t    = c_t * dy_t + da_{t+1} * g_{t+1}    (g_L = c_L * dy_L + dh_last)
//   ddbx_t = g_t        dda_t = g_t * h_{t-1}
//   dc_t   = sum_d dy_t[d] * h_t[d, :]          dh0 = da_1 * g_1
//
// What bounds it on an H100: bytes.  At zamba2-1.2b's folded Mamba-2 scan
// in training ([2 * 64, 1024, 64, 64]) da, dbx, dda and ddbx are 2.15 GB
// each: the function must move 8.6 GB, 2.6 ms at 3.35 TB/s.
//
// What the design does about it:
// - h_{t-1} cannot be had by dividing by da (it underflows to 0), and
//   keeping every h would write another 2.15 GB.  The forward stores the
//   state each chunk of kChunk steps starts from ([B, L / kChunk, D, N],
//   1/16 of da; mamba_scan.cu), and this kernel walks the chunks last to
//   first: it recomputes a chunk's kChunk + 1 states into registers from
//   the stored one, with the forward's rounded multiply then rounded add,
//   so they are bit-equal to the forward's, and runs the reverse
//   recurrence over them.  da and dbx are read once: the 4 tensors of
//   the bound move, and the states, c, dy and dc's partials besides
//   (~0.5 GB at the shape above).
// - A block owns kThreads / min(N, 32) channels (a channel on min(N, 32)
//   lanes, two elements a lane at N = 64), a contiguous run of each step.
//   A chunk's da, dbx, state, c and dy are staged in shared memory by
//   cp.async in a ring of three stages (two where three do not fit in
//   227 KB): the next two chunks load while the block computes one, so
//   that bytes stay in flight through the arithmetic and the stores.
// - dc crosses channels, so blocks.  A thread writes its dc terms where
//   its own dbx elements were (read already), the block sums them over
//   its channels in channel order, and writes one partial a block ([B, D
//   blocks, L, N]); a second launch adds the partials in block order.  No
//   float atomics: two runs give the same bits.
// - g, dda and dh0 are rounded multiplies and adds in the plain version's
//   order (no FMA), so dda, ddbx and dh0 are bit-equal to it; only dc's
//   sum order differs.
//
// What limits it now (H100 80GB HBM3, 700 W; PERF.md): 3.28-3.38 ms at
// the shape above, 78-80% of its bound counted with the states it reads
// (2.63 ms); dc's partials (268 MB written and read back) are most of what
// moves beyond the bound's tensors.  Forming da and dbx in registers
// from Mamba-2's per-head dt and A, x and B (ROADMAP B.3) is the next
// step: it would not read them at all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;               // steps between stored states
constexpr size_t kSmemLimit = 232448;    // 227 KB, a block's most

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared; zero-filled when src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A block's layout at state width N: kW floats of each step (its
// channels' state elements); a stage holds a chunk's da and dbx [kChunk,
// kW], its starting state [kW], c [kChunk, N] and dy [kChunk, channels].
template <int N>
struct Plan {
  static constexpr int kLanes = N < 32 ? N : 32;   // lanes of one channel
  static constexpr int kPer = N / kLanes;          // state elements a lane
  static constexpr int kChannels = kThreads / kLanes;
  static constexpr int kW = kChannels * N;
  static constexpr int kStageFloats =
      2 * kChunk * kW + kW + kChunk * N + kChunk * kChannels;
  static constexpr int kStages =
      sizeof(float) * 3 * kStageFloats <= kSmemLimit ? 3 : 2;
  static constexpr size_t kSmem = sizeof(float) * kStages * kStageFloats;
};

template <int N>
__global__ void __launch_bounds__(kThreads)
    scan_bwd_kernel(const float* __restrict__ da,
                    const float* __restrict__ dbx,
                    const float* __restrict__ c,
                    const float* __restrict__ states,
                    const float* __restrict__ dy,
                    const float* __restrict__ dh_last,
                    float* __restrict__ dda, float* __restrict__ ddbx,
                    float* __restrict__ dc_part, float* __restrict__ dh0,
                    int L, int D, int vec) {
  using P = Plan<N>;
  constexpr int kLanes = P::kLanes, kPer = P::kPer;
  constexpr int kChannels = P::kChannels, kW = P::kW;
  extern __shared__ __align__(16) float smem[];

  const int b = blockIdx.y;
  const int ch = threadIdx.x / kLanes;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + ch;
  const int lane = threadIdx.x % kLanes;
  const bool live = d < D;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const size_t step = (size_t)D * N;               // one time step of da
  const size_t base = (size_t)b * L * step + (size_t)d * N + lane;
  const size_t hbase = ((size_t)b * D + d) * N + lane;
  const int my = ch * N + lane;                    // + j * kLanes: mine
  // the block's run of a step (kW floats, zero past D) in each tensor
  const int w_valid = min(kW, (D - d0) * N);
  const int ch_valid = min(kChannels, D - d0);
  const float* dab = da + (size_t)b * L * step + (size_t)d0 * N;
  const float* dbxb = dbx + (size_t)b * L * step + (size_t)d0 * N;
  const float* stb = states + (size_t)b * n_chunks * step + (size_t)d0 * N;
  const float* cb = c + (size_t)b * L * N;
  const float* dyb = dy + (size_t)b * L * D + d0;

  // chunk k into stage s; steps past L are zero-filled
  auto stage = [&](int s, int k) {
    float* sa = smem + s * P::kStageFloats;
    float* sx = sa + kChunk * kW;
    float* sh = sx + kChunk * kW;
    float* sc = sh + kW;
    float* sy = sc + kChunk * N;
    const int t0 = k * kChunk;
    const int steps = min(kChunk, L - t0);
    if (vec) {
      constexpr int kQ = kW / 4;
      for (int i = threadIdx.x; i < kChunk * kQ; i += kThreads) {
        const int u = i / kQ, f = (i % kQ) * 4;
        const bool in = u < steps && f < w_valid;
        const size_t at = in ? (size_t)(t0 + u) * step + f : 0;
        cp_async16(sa + u * kW + f, dab + at, in ? 16 : 0);
        cp_async16(sx + u * kW + f, dbxb + at, in ? 16 : 0);
      }
      for (int f = threadIdx.x * 4; f < kW; f += kThreads * 4) {
        const bool in = f < w_valid;
        cp_async16(sh + f, stb + (in ? (size_t)k * step + f : 0),
                   in ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < kChunk * kW; i += kThreads) {
        const int u = i / kW, f = i % kW;
        const bool in = u < steps && f < w_valid;
        const size_t at = in ? (size_t)(t0 + u) * step + f : 0;
        cp_async4(sa + i, dab + at, in ? 4 : 0);
        cp_async4(sx + i, dbxb + at, in ? 4 : 0);
      }
      for (int f = threadIdx.x; f < kW; f += kThreads) {
        const bool in = f < w_valid;
        cp_async4(sh + f, stb + (in ? (size_t)k * step + f : 0),
                  in ? 4 : 0);
      }
    }
    for (int i = threadIdx.x; i < kChunk * N; i += kThreads) {
      const bool in = i / N < steps;
      cp_async4(sc + i, cb + (in ? (size_t)t0 * N + i : 0), in ? 4 : 0);
    }
    for (int i = threadIdx.x; i < kChunk * kChannels; i += kThreads) {
      const int u = i / kChannels, cx = i % kChannels;
      const bool in = u < steps && cx < ch_valid;
      cp_async4(sy + i, dyb + (in ? (size_t)(t0 + u) * D + cx : 0),
                in ? 4 : 0);
    }
  };

  float gn[kPer];                                  // da_{t+1} * g_{t+1}
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    gn[j] = (live && dh_last != nullptr) ? dh_last[hbase + j * kLanes] : 0.0f;

  // chunk i of the walk is chunk n_chunks - 1 - i, in stage i % kStages
  for (int s = 0; s < P::kStages - 1; ++s) {
    if (s < n_chunks) stage(s, n_chunks - 1 - s);
    cp_async_commit();
  }
  for (int i = 0; i < n_chunks; ++i) {
    const int ahead = i + P::kStages - 1;
    if (ahead < n_chunks) stage(ahead % P::kStages, n_chunks - 1 - ahead);
    cp_async_commit();
    cp_async_wait<P::kStages - 1>();
    __syncthreads();

    const float* sa = smem + (i % P::kStages) * P::kStageFloats;
    float* sx = smem + (i % P::kStages) * P::kStageFloats + kChunk * kW;
    const float* sh = sx + kChunk * kW;
    const float* sc = sh + kW;
    const float* sy = sc + kChunk * N;
    const int t0 = (n_chunks - 1 - i) * kChunk;

    // the chunk's kChunk + 1 states, as the forward computed them
    float hs[kChunk + 1][kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) hs[0][j] = sh[my + j * kLanes];
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = u * kW + my + j * kLanes;
        hs[u + 1][j] = __fadd_rn(__fmul_rn(sa[e], hs[u][j]), sx[e]);
      }

    // the reverse recurrence; dc's terms dy_t[d] * h_t[d, n] (0 past L
    // and for dead channels) overwrite the thread's own dbx elements
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      const int t = t0 + u;
      const float dyv = sy[u * kChannels + ch];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = u * kW + my + j * kLanes;
        sx[e] = __fmul_rn(dyv, hs[u + 1][j]);
        if (t < L) {
          const float g =
              __fadd_rn(__fmul_rn(sc[u * N + lane + j * kLanes], dyv), gn[j]);
          if (live) {
            const size_t at = base + (size_t)t * step + j * kLanes;
            __stcs(ddbx + at, g);
            __stcs(dda + at, __fmul_rn(g, hs[u][j]));
          }
          gn[j] = __fmul_rn(sa[e], g);
        }
      }
    }
    __syncthreads();
    // the block's partial of dc over (step, n), its channels in order
    for (int x = threadIdx.x; x < kChunk * N; x += kThreads) {
      const int u = x / N, n = x % N;
      if (t0 + u >= L) continue;
      const float* r = sx + u * kW + n;
      float s = r[0];
#pragma unroll
      for (int cx = 1; cx < kChannels; ++cx) s = __fadd_rn(s, r[cx * N]);
      dc_part[(((size_t)b * gridDim.x + blockIdx.x) * L + t0 + u) * N + n] = s;
    }
    __syncthreads();                               // the stage is reused
  }
  cp_async_wait<0>();
  if (live) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) dh0[hbase + j * kLanes] = gn[j];
  }
}

// dc[b, t, n] = the D blocks' partials added in block order
__global__ void __launch_bounds__(kThreads)
    dc_sum_kernel(const float* __restrict__ dc_part, float* __restrict__ dc,
                  int B, int n_blocks, int L, int N) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t per_b = (size_t)L * N;
  if (i >= (size_t)B * per_b) return;
  const size_t b = i / per_b, tn = i % per_b;
  const float* p = dc_part + b * n_blocks * per_b + tn;
  float s = p[0];
  for (int k = 1; k < n_blocks; ++k) s = __fadd_rn(s, p[(size_t)k * per_b]);
  dc[i] = s;
}

template <int N>
cudaError_t launch(const float* da, const float* dbx, const float* c,
                   const float* states, const float* dy,
                   const float* dh_last, float* dda, float* ddbx, float* dc,
                   float* dh0, float* dc_part, int B, int L, int D, int vec,
                   cudaStream_t stream) {
  using P = Plan<N>;
  static_assert(P::kSmem <= kSmemLimit, "stages exceed shared memory");
  const int n_blocks = (D + P::kChannels - 1) / P::kChannels;
  auto kernel = scan_bwd_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_blocks, B), kThreads, P::kSmem, stream>>>(
      da, dbx, c, states, dy, dh_last, dda, ddbx, dc_part, dh0, L, D, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)B * L * N;
  if (total == 0) return cudaSuccess;
  dc_sum_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                  stream>>>(dc_part, dc, B, n_blocks, L, N);
  return cudaGetLastError();
}

}  // namespace

// The D blocks the first launch runs (the dc_part scratch is [B, this, L,
// N]), for the wrapper to size its scratch.
extern "C" int mamba_scan_bwd_blocks(int D, int N) {
  const int lanes = N < 32 ? N : 32;
  const int per_block = kThreads / lanes;
  return (D + per_block - 1) / per_block;
}

// The steps between stored states (states is [B, ceil(L / this), D, N]).
extern "C" int mamba_scan_bwd_chunk() { return kChunk; }

// da, dbx, dda, ddbx [B, L, D, N], c, dc [B, L, N], states [B, ceil(L /
// 16), D, N] (the forward's), dy [B, L, D], dh_last [B, D, N] or null
// (zero), dh0 [B, D, N], dc_part scratch as mamba_scan_bwd_blocks sizes
// it; contiguous fp32 on the device, N a power of two up to 64.  Returns
// the launches' cudaError_t.
extern "C" int mamba_scan_bwd_f32(const void* da, const void* dbx,
                                  const void* c, const void* states,
                                  const void* dy, const void* dh_last,
                                  void* dda, void* ddbx, void* dc, void* dh0,
                                  void* dc_part, int B, int L, int D, int N,
                                  void* stream) {
  if (B <= 0 || D <= 0) return 0;
  const float* a = static_cast<const float*>(da);
  const float* x = static_cast<const float*>(dbx);
  const float* cf = static_cast<const float*>(c);
  const float* st = static_cast<const float*>(states);
  const float* g = static_cast<const float*>(dy);
  const float* gl = static_cast<const float*>(dh_last);
  float* oa = static_cast<float*>(dda);
  float* ox = static_cast<float*>(ddbx);
  float* oc = static_cast<float*>(dc);
  float* oh = static_cast<float*>(dh0);
  float* part = static_cast<float*>(dc_part);
  // 16-byte copies of the block's runs: aligned rows of whole chunks
  const int vec = (D * N) % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(da) |
                    reinterpret_cast<uintptr_t>(dbx) |
                    reinterpret_cast<uintptr_t>(states)) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SCAN_BWD_LAUNCH(NN)                                                  \
  err = launch<NN>(a, x, cf, st, g, gl, oa, ox, oc, oh, part, B, L, D, vec, \
                   s);                                                       \
  break
  switch (N) {
    case 1: SCAN_BWD_LAUNCH(1);
    case 2: SCAN_BWD_LAUNCH(2);
    case 4: SCAN_BWD_LAUNCH(4);
    case 8: SCAN_BWD_LAUNCH(8);
    case 16: SCAN_BWD_LAUNCH(16);
    case 32: SCAN_BWD_LAUNCH(32);
    case 64: SCAN_BWD_LAUNCH(64);
    default: err = cudaErrorInvalidValue;
  }
#undef SCAN_BWD_LAUNCH
  return static_cast<int>(err);
}
