// Selective scan (the Mamba-1 and Mamba-2 inner recurrence) for Hopper,
// fp32.
//
// Replaces: repro/kernels/mamba_scan.py, mamba_scan / _scan_kernel (the
// Pallas TPU kernel on grid (batch, channel blocks, L chunks) that carries
// the state in VMEM across the sequential chunk axis).
//
//   h_t = da_t * h_{t-1} + dbx_t        elementwise over [D, N]
//   y_t = sum_n c_t[n] * h_t[:, n]
//
// da, dbx [B, L, D, N], c [B, L, N], h0 [B, D, N]; y [B, L, D] and
// h_last [B, D, N].  Mamba-2 calls it with its heads folded into B and
// a head's channels as D (zamba2-1.2b: [B * 64, L, 64, 64]).  When a
// gradient is wanted the caller also passes states [B, ceil(L / 16), D,
// N]: the state each chunk of 16 steps starts from (h0, then h_15,
// h_31, ...), which mamba_scan_bwd.cu reads instead of replaying the
// scan.  They are one store of the registers every 16 steps; y and
// h_last are the same with or without.
//
// What bounds it on an H100: bytes.  Each da and dbx element is read once
// and used for 3 flops; at falcon-mamba-7b's d_inner 8192, N 16 and
// L 4096 da and dbx are 2.15 GB each, ~1.3 ms at 3.35 TB/s.
//
// What the design does about it: the TPU kernel's L chunks exist only to
// fit VMEM and have no counterpart.  Each thread holds its state elements
// in registers for the whole of L, so the state never touches memory.  A
// channel's N elements lie on min(N, 32) adjacent lanes: at N <= 32 one
// element a lane, at N = 64 two, n and n + 32, so that each load of a
// warp is one contiguous run along (d, n).  y's sum over n is a lane's own
// products added, then a shuffle tree among the channel's lanes.  Each
// thread issues its loads 8 time steps ahead of the recurrence, which
// keeps enough bytes in flight to cover HBM latency with one block per
// 256 lanes.  The update is a rounded multiply, then a rounded add (no
// FMA), as the plain version computes it, so the state is bit-equal to
// the plain version's and only y's sum order differs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;                // time steps loaded ahead
constexpr int kChunk = 16;               // steps between stored states
static_assert(kChunk % kAhead == 0, "a chunk starts a load group");

template <int N>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const float* __restrict__ da,
                      const float* __restrict__ dbx,
                      const float* __restrict__ c,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last,
                      float* __restrict__ states, int L, int D) {
  constexpr int kLanes = N < 32 ? N : 32;          // lanes of one channel
  constexpr int kPer = N / kLanes;                 // state elements a lane
  constexpr int kChannels = kThreads / kLanes;     // channels per block
  const int b = blockIdx.y;
  const int d = blockIdx.x * kChannels + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const bool live = d < D;
  const size_t step = (size_t)D * N;               // one time step of da
  const size_t base = (size_t)b * L * step + (size_t)d * N + lane;
  const float* cb = c + (size_t)b * L * N + lane;
  const size_t hbase = ((size_t)b * D + d) * N + lane;
  float h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    h[j] = live ? h0[hbase + j * kLanes] : 0.0f;

  // state k is the one chunk k starts from
  const size_t sbase = (size_t)b * ((L + kChunk - 1) / kChunk) * step +
                       (size_t)d * N + lane;

  for (int t0 = 0; t0 < L; t0 += kAhead) {
    if (states != nullptr && live && t0 % kChunk == 0) {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        states[sbase + (size_t)(t0 / kChunk) * step + j * kLanes] = h[j];
    }
    float a[kAhead][kPer], x[kAhead][kPer], cc[kAhead][kPer];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + u;
      const bool ok = live && t < L;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const size_t at = base + (size_t)t * step + j * kLanes;
        a[u][j] = ok ? __ldg(da + at) : 0.0f;
        x[u][j] = ok ? __ldg(dbx + at) : 0.0f;
        cc[u][j] = t < L ? __ldg(cb + (size_t)t * N + j * kLanes) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u >= L) break;                      // uniform across the block
      float yv = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        h[j] = __fadd_rn(__fmul_rn(a[u][j], h[j]), x[u][j]);
        const float p = __fmul_rn(cc[u][j], h[j]);
        yv = j == 0 ? p : __fadd_rn(yv, p);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        yv += __shfl_xor_sync(0xffffffffu, yv, off);
      if (lane == 0 && live) y[((size_t)b * L + t0 + u) * D + d] = yv;
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) h_last[hbase + j * kLanes] = h[j];
  }
}

template <int N>
cudaError_t launch(const float* da, const float* dbx, const float* c,
                   const float* h0, float* y, float* h_last, float* states,
                   int B, int L, int D, cudaStream_t stream) {
  constexpr int kChannels = kThreads / (N < 32 ? N : 32);
  dim3 grid((D + kChannels - 1) / kChannels, B);
  mamba_scan_kernel<N><<<grid, kThreads, 0, stream>>>(da, dbx, c, h0, y,
                                                       h_last, states, L, D);
  return cudaGetLastError();
}

}  // namespace

// The steps between stored states (states is [B, ceil(L / this), D, N]).
extern "C" int mamba_scan_chunk() { return kChunk; }

// da, dbx [B, L, D, N], c [B, L, N], h0 [B, D, N], y [B, L, D], h_last
// [B, D, N], states as mamba_scan_chunk() sizes it or null (not
// written), contiguous fp32 on the device; N a power of two up to 64.
// Returns the launch's cudaError_t.
extern "C" int mamba_scan_f32(const void* da, const void* dbx, const void* c,
                              const void* h0, void* y, void* h_last,
                              void* states, int B, int L, int D, int N,
                              void* stream) {
  if (B <= 0 || D <= 0) return 0;
  const float* a = static_cast<const float*>(da);
  const float* x = static_cast<const float*>(dbx);
  const float* cf = static_cast<const float*>(c);
  const float* h = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hl = static_cast<float*>(h_last);
  float* st = static_cast<float*>(states);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 1: err = launch<1>(a, x, cf, h, yf, hl, st, B, L, D, s); break;
    case 2: err = launch<2>(a, x, cf, h, yf, hl, st, B, L, D, s); break;
    case 4: err = launch<4>(a, x, cf, h, yf, hl, st, B, L, D, s); break;
    case 8: err = launch<8>(a, x, cf, h, yf, hl, st, B, L, D, s); break;
    case 16: err = launch<16>(a, x, cf, h, yf, hl, st, B, L, D, s); break;
    case 32: err = launch<32>(a, x, cf, h, yf, hl, st, B, L, D, s); break;
    case 64: err = launch<64>(a, x, cf, h, yf, hl, st, B, L, D, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
