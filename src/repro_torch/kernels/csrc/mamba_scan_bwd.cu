// The backward of the selective scan (mamba_scan.cu) for Hopper, fp32.
//
// Replaces: the gradient of repro/kernels/mamba_scan.py's mamba_scan.  The
// TPU kernel has no backward of its own: the JAX package differentiates
// its chunked scan (repro/models/ssm.py, _ssm_scan_fused) by XLA
// autodiff.  Given the forward's inputs and the gradients of its outputs
// (dy [B, L, D], dh_last [B, D, N] or none), with g_t the gradient that
// reaches h_t:
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
// - A thread holds a channel's state elements as the forward does (a
//   channel on min(N, 32) lanes, two elements a lane at N = 64), in
//   registers for the whole of L.
// - h_{t-1} cannot be had by dividing by da (it underflows to 0), and
//   keeping every h would write another 2.15 GB.  So the kernel first
//   replays the forward, storing h every kChunk steps (a [B, L / kChunk,
//   D, N] scratch, 1/16 of da), then walks the chunks last to first: it
//   recomputes a chunk's kChunk + 1 states into registers from its
//   checkpoint, with the forward's rounded multiply then rounded add, so
//   they are bit-equal to the forward's, and runs the reverse recurrence
//   over them.  Each chunk's loads are issued together before its
//   arithmetic, which keeps bytes in flight as the forward's 8 steps
//   ahead do.  da and dbx are read twice: 6 tensors of 2.15 GB move,
//   where the bound counts 4.
// - dc crosses channels, so blocks.  A block sums its own channels' terms
//   of each (step, n) through shared memory in channel order, and writes
//   one partial a block ([B, D blocks, L, N]); a second launch adds the
//   partials in block order.  No float atomics: two runs give the same
//   bits.
// - g, dda and dh0 are rounded multiplies and adds in the plain version's
//   order (no FMA), so dda, ddbx and dh0 are bit-equal to it; only dc's
//   sum order differs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;               // steps between stored states

template <int N>
__global__ void __launch_bounds__(kThreads)
    scan_bwd_kernel(const float* __restrict__ da,
                    const float* __restrict__ dbx,
                    const float* __restrict__ c,
                    const float* __restrict__ h0,
                    const float* __restrict__ dy,
                    const float* __restrict__ dh_last,
                    float* __restrict__ dda, float* __restrict__ ddbx,
                    float* __restrict__ dc_part, float* __restrict__ dh0,
                    float* __restrict__ ckpt, int L, int D) {
  constexpr int kLanes = N < 32 ? N : 32;          // lanes of one channel
  constexpr int kPer = N / kLanes;                 // state elements a lane
  constexpr int kChannels = kThreads / kLanes;     // channels per block
  __shared__ float red[kChunk][kChannels][N];      // dc terms of a chunk

  const int b = blockIdx.y;
  const int ch = threadIdx.x / kLanes;
  const int d = blockIdx.x * kChannels + ch;
  const int lane = threadIdx.x % kLanes;
  const bool live = d < D;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const size_t step = (size_t)D * N;               // one time step of da
  const size_t base = (size_t)b * L * step + (size_t)d * N + lane;
  const float* cb = c + (size_t)b * L * N + lane;
  const size_t hbase = ((size_t)b * D + d) * N + lane;
  // checkpoint k holds h_{k * kChunk - 1}, the state a chunk starts from
  const size_t cbase = (size_t)b * n_chunks * step + (size_t)d * N + lane;

  // ---- forward replay, a state stored every kChunk steps ----
  float h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) h[j] = live ? h0[hbase + j * kLanes] : 0.0f;
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * kChunk;
    float a[kChunk][kPer], x[kChunk][kPer];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const bool ok = live && t0 + u < L;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const size_t at = base + (size_t)(t0 + u) * step + j * kLanes;
        a[u][j] = ok ? __ldg(da + at) : 1.0f;
        x[u][j] = ok ? __ldg(dbx + at) : 0.0f;
      }
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        ckpt[cbase + (size_t)k * step + j * kLanes] = h[j];
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        h[j] = __fadd_rn(__fmul_rn(a[u][j], h[j]), x[u][j]);
  }

  // ---- the chunks last to first ----
  float gn[kPer];                                  // da_{t+1} * g_{t+1}
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    gn[j] = (live && dh_last != nullptr) ? dh_last[hbase + j * kLanes] : 0.0f;
  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    float a[kChunk][kPer], hs[kChunk + 1][kPer], cc[kChunk][kPer];
    float dyv[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const bool in = t0 + u < L;
      const bool ok = live && in;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const size_t at = base + (size_t)(t0 + u) * step + j * kLanes;
        a[u][j] = ok ? __ldg(da + at) : 1.0f;
        hs[u + 1][j] = ok ? __ldg(dbx + at) : 0.0f;   // dbx, then h
        cc[u][j] = in ? __ldg(cb + (size_t)(t0 + u) * N + j * kLanes) : 0.0f;
      }
      dyv[u] = ok ? __ldg(dy + ((size_t)b * L + t0 + u) * D + d) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      hs[0][j] = live ? ckpt[cbase + (size_t)k * step + j * kLanes] : 0.0f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        hs[u + 1][j] = __fadd_rn(__fmul_rn(a[u][j], hs[u][j]), hs[u + 1][j]);
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      const int t = t0 + u;
      const bool ok = live && t < L;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        // dc's terms: dy_t[d] * h_t[d, n] (0 past L and for dead channels)
        red[u][ch][lane + j * kLanes] = __fmul_rn(dyv[u], hs[u + 1][j]);
        if (t < L) {
          const float g = __fadd_rn(__fmul_rn(cc[u][j], dyv[u]), gn[j]);
          if (ok) {
            const size_t at = base + (size_t)t * step + j * kLanes;
            ddbx[at] = g;
            dda[at] = __fmul_rn(g, hs[u][j]);
          }
          gn[j] = __fmul_rn(a[u][j], g);
        }
      }
    }
    __syncthreads();
    // the block's partial of dc over (step, n), its channels in order
    for (int i = threadIdx.x; i < kChunk * N; i += kThreads) {
      const int u = i / N, n = i % N;
      if (t0 + u >= L) continue;
      float s = red[u][0][n];
#pragma unroll
      for (int cx = 1; cx < kChannels; ++cx) s = __fadd_rn(s, red[u][cx][n]);
      dc_part[(((size_t)b * gridDim.x + blockIdx.x) * L + t0 + u) * N + n] = s;
    }
    __syncthreads();                               // red is reused
  }
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
constexpr int channels_per_block() {
  return kThreads / (N < 32 ? N : 32);
}

template <int N>
cudaError_t launch(const float* da, const float* dbx, const float* c,
                   const float* h0, const float* dy, const float* dh_last,
                   float* dda, float* ddbx, float* dc, float* dh0,
                   float* ckpt, float* dc_part, int B, int L, int D,
                   cudaStream_t stream) {
  const int n_blocks = (D + channels_per_block<N>() - 1) /
                       channels_per_block<N>();
  dim3 grid(n_blocks, B);
  scan_bwd_kernel<N><<<grid, kThreads, 0, stream>>>(
      da, dbx, c, h0, dy, dh_last, dda, ddbx, dc_part, dh0, ckpt, L, D);
  cudaError_t err = cudaGetLastError();
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

// The steps between stored states (the ckpt scratch is [B, ceil(L /
// this), D, N]).
extern "C" int mamba_scan_bwd_chunk() { return kChunk; }

// da, dbx, dda, ddbx [B, L, D, N], c, dc [B, L, N], h0, dh0 [B, D, N], dy
// [B, L, D], dh_last [B, D, N] or null (zero), ckpt and dc_part scratch
// as the two functions above size them; contiguous fp32 on the device, N
// a power of two up to 64.  Returns the launches' cudaError_t.
extern "C" int mamba_scan_bwd_f32(const void* da, const void* dbx,
                                  const void* c, const void* h0,
                                  const void* dy, const void* dh_last,
                                  void* dda, void* ddbx, void* dc, void* dh0,
                                  void* ckpt, void* dc_part, int B, int L,
                                  int D, int N, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  const float* a = static_cast<const float*>(da);
  const float* x = static_cast<const float*>(dbx);
  const float* cf = static_cast<const float*>(c);
  const float* h = static_cast<const float*>(h0);
  const float* g = static_cast<const float*>(dy);
  const float* gl = static_cast<const float*>(dh_last);
  float* oa = static_cast<float*>(dda);
  float* ox = static_cast<float*>(ddbx);
  float* oc = static_cast<float*>(dc);
  float* oh = static_cast<float*>(dh0);
  float* ck = static_cast<float*>(ckpt);
  float* part = static_cast<float*>(dc_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SCAN_BWD_LAUNCH(NN)                                                    \
  err = launch<NN>(a, x, cf, h, g, gl, oa, ox, oc, oh, ck, part, B, L, D, s); \
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
