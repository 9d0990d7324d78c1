// Fused chained GEMM for Hopper: one launch for a whole chained segment,
// act_{L-1}(... act_0(X @ W_0) ... @ W_{L-1}), in fp32.
//
// Replaces: repro/kernels/fused_chain.py, fused_chain /
// _fused_chain_jit / _fused_kernel (the Pallas TPU megakernel that keeps
// every interior activation on chip).
//
// Per layer l the block sums its K tiles of bk_l into the accumulator
// (acc[:, :n_l] += h[:, tile] @ W_l[tile], one partial per tile, as the
// TPU kernel does per grid step), applies the layer's activation at the
// last tile -- elementwise (relu, tanh-gelu, silu) or row-wise (softmax
// with max subtraction, rmsnorm, layernorm; eps 1e-6, population
// variance) -- and commits the result to the activation slab the next
// layer reads, zero-padded.  ``adapt[l+1]`` commits instead the runtime's
// head-split/merge glue as a static index map: the true (m_l, n_l) region
// raveled row-major, cycled to m' * k' elements and reshaped.
//
// What bounds it on an H100: the segments that fuse are small (the
// FUSED_VMEM_BUDGET legality rule admits them only at reduced width:
// bm <= 32 rows, layers of a few hundred columns), and one block works
// through the whole chain alone, layer after layer, with scalar FFMA
// inner loops.  So serial compute in a single block bounds it (about
// 0.085 ms for the reduced decode segment on an H100, some 15 launch
// latencies), not launch latency, bytes or the card's flops; spreading a
// layer's columns over several blocks is later work.  What the design
// does: the whole chain is one launch with one block per M block (an
// adapt boundary forces a single block, since the permutation needs
// every row), so no interior activation round-trips; the slab (bm, k_slab)
// and accumulator (bm, n_max) live in shared memory when
// 4 * bm * (k_slab + n_max) fits the 200 KB this kernel allows itself,
// and otherwise in a global scratch buffer the wrapper allocates (the
// same code through a generic pointer).  Interior activations never
// leave the block.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 16;

enum Act { kNone = 0, kRelu, kGelu, kSilu, kSoftmax, kRmsnorm, kLayernorm };

struct Layer {
  const float* w;  // [k, n] row-major
  int m, k, n;     // true extents
  int bk;          // K tile
  int act;
  int adapt;       // the glue before this layer
};

struct Params {
  Layer layers[kMaxLayers];
  int n_layers;
  const float* x;  // [m0, k0]
  float* out;      // [m_out, n_out]
  float* scratch;  // per-block slab + acc when not in shared memory
  int bm, k_slab, n_max, m_out, use_smem;
};

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

__device__ __forceinline__ float elementwise(float v, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(v, 0.0f);
    case kGelu: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return v * (0.5f * (1.0f + tanhf(c * (v + 0.044715f * v * v * v))));
    }
    case kSilu:
      return v / (1.0f + expf(-v));
    default:
      return v;
  }
}

// row-wise activation of row ``row`` (n columns), one warp
__device__ void rowwise(float* row, int n, int act, int lane) {
  if (act == kSoftmax) {
    float mx = -3.402823466e38f;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, row[c]);
    mx = warp_max(mx);
    float s = 0.0f;
    for (int c = lane; c < n; c += 32) {
      const float e = expf(row[c] - mx);
      row[c] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int c = lane; c < n; c += 32) row[c] = row[c] / s;
  } else if (act == kRmsnorm) {
    float s = 0.0f;
    for (int c = lane; c < n; c += 32) s += row[c] * row[c];
    const float denom = sqrtf(warp_sum(s) / n + 1e-6f);
    for (int c = lane; c < n; c += 32) row[c] = row[c] / denom;
  } else if (act == kLayernorm) {
    float s = 0.0f;
    for (int c = lane; c < n; c += 32) s += row[c];
    const float mu = warp_sum(s) / n;
    float var = 0.0f;
    for (int c = lane; c < n; c += 32) var += (row[c] - mu) * (row[c] - mu);
    const float denom = sqrtf(warp_sum(var) / n + 1e-6f);
    for (int c = lane; c < n; c += 32) row[c] = (row[c] - mu) / denom;
  }
}

__global__ void __launch_bounds__(kThreads) fused_chain_kernel(Params p) {
  extern __shared__ float smem[];
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bm = p.bm, k_slab = p.k_slab, n_max = p.n_max;
  float* slab = p.use_smem
                    ? smem
                    : p.scratch + (size_t)blk * bm * (k_slab + n_max);
  float* acc = slab + (size_t)bm * k_slab;
  const int row0 = blk * bm;

  for (int l = 0; l < p.n_layers; ++l) {
    const Layer L = p.layers[l];
    const int n = L.n, k = L.k, bk = L.bk;
    for (int idx = tid; idx < bm * n; idx += kThreads)
      acc[(idx / n) * n_max + idx % n] = 0.0f;
    // each thread owns the same (r, c) outputs across every K tile
    for (int k0 = 0; k0 < k; k0 += bk) {
      const int k1 = min(k0 + bk, k);
      for (int idx = tid; idx < bm * n; idx += kThreads) {
        const int r = idx / n, c = idx % n;
        float s = 0.0f;
        if (l == 0) {
          const int gr = row0 + r;  // rows past m0 are zero padding
          if (gr < L.m) {
            const float* xr = p.x + (size_t)gr * k;
            for (int kk = k0; kk < k1; ++kk)
              s = fmaf(xr[kk], L.w[(size_t)kk * n + c], s);
          }
        } else {
          const float* hr = slab + (size_t)r * k_slab;
          for (int kk = k0; kk < k1; ++kk)
            s = fmaf(hr[kk], L.w[(size_t)kk * n + c], s);
        }
        acc[r * n_max + c] += s;
      }
    }
    __syncthreads();
    if (L.act >= kSoftmax) {
      for (int r = warp; r < bm; r += kWarps)
        rowwise(acc + (size_t)r * n_max, n, L.act, lane);
    } else if (L.act != kNone) {
      for (int idx = tid; idx < bm * n; idx += kThreads) {
        float* a = acc + (idx / n) * n_max + idx % n;
        *a = elementwise(*a, L.act);
      }
    }
    __syncthreads();
    if (l == p.n_layers - 1) {
      for (int idx = tid; idx < bm * n; idx += kThreads) {
        const int r = idx / n, c = idx % n;
        if (row0 + r < p.m_out)
          p.out[(size_t)(row0 + r) * n + c] = acc[r * n_max + c];
      }
      return;
    }
    const Layer next = p.layers[l + 1];
    if (next.adapt) {
      // ravel acc[:m_l, :n_l] row-major, cycle, reshape to (m', k')
      const int size = L.m * n;
      for (int idx = tid; idx < bm * k_slab; idx += kThreads) {
        const int r = idx / k_slab, c = idx % k_slab;
        float val = 0.0f;
        if (r < next.m && c < next.k && size > 0) {
          const int f = (r * next.k + c) % size;
          val = acc[(f / n) * n_max + f % n];
        }
        slab[idx] = val;
      }
    } else {
      for (int idx = tid; idx < bm * k_slab; idx += kThreads) {
        const int r = idx / k_slab, c = idx % k_slab;
        slab[idx] = c < n ? acc[r * n_max + c] : 0.0f;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// One launch of the chain.  ws[l] is layer l's [k, n] weight; dims holds
// (m, k, n) per layer, bks the K tiles, acts the activation codes
// (0 none, 1 relu, 2 gelu, 3 silu, 4 softmax, 5 rmsnorm, 6 layernorm),
// adapts the glue flags.  x is [m0, k0], out [m_out, n_out]; n_blocks
// blocks of bm rows; scratch holds n_blocks * bm * (k_slab + n_max)
// floats when use_smem is 0.  Returns the launch's cudaError_t.
extern "C" int fused_chain_f32(const void* x, const void* const* ws,
                               const int* dims, const int* bks,
                               const int* acts, const int* adapts,
                               int n_layers, void* out, void* scratch,
                               int n_blocks, int bm, int k_slab, int n_max,
                               int m_out, int use_smem, void* stream) {
  if (n_layers <= 0 || n_layers > kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks <= 0) return 0;
  Params p;
  p.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    p.layers[l].w = static_cast<const float*>(ws[l]);
    p.layers[l].m = dims[3 * l];
    p.layers[l].k = dims[3 * l + 1];
    p.layers[l].n = dims[3 * l + 2];
    p.layers[l].bk = bks[l];
    p.layers[l].act = acts[l];
    p.layers[l].adapt = adapts[l];
  }
  p.x = static_cast<const float*>(x);
  p.out = static_cast<float*>(out);
  p.scratch = static_cast<float*>(scratch);
  p.bm = bm;
  p.k_slab = k_slab;
  p.n_max = n_max;
  p.m_out = m_out;
  p.use_smem = use_smem;
  size_t smem = 0;
  if (use_smem) {
    smem = sizeof(float) * (size_t)bm * (k_slab + n_max);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          fused_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  fused_chain_kernel<<<n_blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
