// Fused chained GEMM for Hopper: one launch for a whole chained segment,
// act_{L-1}(... act_0(X @ W_0) ... @ W_{L-1}), in fp32.
//
// Replaces: repro/kernels/fused_chain.py, fused_chain /
// _fused_chain_jit / _fused_kernel (the Pallas TPU megakernel that keeps
// every interior activation on chip).
//
// Per layer l every output sums its K tiles of bk_l in ascending order,
// each tile an ascending fmaf chain added to the output's accumulator in
// turn (the TPU kernel's per-grid-step partials), then takes the layer's
// activation -- elementwise (relu, tanh-gelu, silu) or row-wise (softmax
// with max subtraction, rmsnorm, layernorm; eps 1e-6, population
// variance) -- and is committed to the activation slab the next layer
// reads.  ``adapt[l+1]`` commits instead the runtime's head-split/merge
// glue as a static index map: the true (m_l, n_l) region raveled
// row-major, cycled to m' * k' elements and reshaped.
//
// What bounds it on an H100: the segments that fuse are small (the
// FUSED_VMEM_BUDGET legality rule admits them only at reduced width:
// tens of rows, layers of a few hundred columns), so neither HBM bytes
// nor the card's flops bound it but latency: each output's dependent
// fmaf chain (K steps a layer), the two cluster barriers and the
// exchange between layers, and the launch.  What the design does:
//   * one thread-block cluster of ``cs`` blocks (the ranks) per M block
//     of bm rows; rank r owns a contiguous slice of ``chunk_l`` columns of
//     every layer and computes only those, one thread per 4 columns of a
//     row (a small layer's groups one a warp, so every scheduler runs a
//     chain), so a layer's outputs spread over up to 16 SMs;
//   * every rank keeps a full copy of the slab (bm rows of the layer
//     input).  After a layer, a cluster barrier (nobody still reads the
//     slab), each rank writes its output slice into every rank's slab
//     through distributed shared memory, one float4 a thread, and a
//     second barrier publishes it.  A row-wise activation or an adapt
//     needs whole rows: those layers gather the pre-activation slices
//     into a ``rows`` buffer in every rank instead, and each rank runs
//     the same row code and index map on its own copy, so every rank
//     holds identical bits;
//   * the plan (kernels/fused_chain.py:plan) puts a rank's slab, rows,
//     accumulator and its weight slices of every layer in shared memory
//     ("shared"; the weights arrive by cp.async while layer 0 computes),
//     or the buffers and one layer's slice at a time, the next one's
//     arriving while the ranks exchange ("shared-slab"), or, when the slab
//     fits no block, every buffer in a global scratch per rank and the
//     weights through L1 ("global", the same code through generic
//     pointers).  Interior activations never go to HBM in the first two.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 16;
constexpr int kMaxCluster = 16;
constexpr int kLayerInts = 8;  // m, k, n, bk, act, adapt, chunk, w_off

enum Act { kNone = 0, kRelu, kGelu, kSilu, kSoftmax, kRmsnorm, kLayernorm };

struct Layer {
  const float* w;  // [k, n] row-major
  int m, k, n;     // true extents
  int bk;          // K tile
  int act;
  int adapt;       // the glue before this layer
  int chunk;       // columns per rank (a multiple of 4)
  int w_off;       // this layer's staged slice in the weight stage
};

struct Params {
  Layer layers[kMaxLayers];
  int n_layers;
  const float* x;  // [m0, k0]
  float* out;      // [m_out, n_out]
  float* scratch;  // the ranks' buffers in the global plan
  int bm, m_out;
  int slab_ld, rows_ld, acc_ld;              // row strides, floats
  int slab_off, rows_off, acc_off, wst_off;  // in a rank's buffer
  int rank_floats;                           // one rank's buffer
  int use_smem;
  int stage;  // weights in shared memory: kStageNone, kStageAll, kStageLayer
};

enum Stage { kStageNone = 0, kStageAll, kStageLayer };

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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// wait until at most ``pending`` cp.async groups are in flight (more
// than 7 waits for 7: stricter, never wrong)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// 4 consecutive weights of row kk from column c (zero at and past n)
__device__ __forceinline__ float4 load_w4(const float* __restrict__ w, int kk,
                                          int c, int n, bool vec) {
  const float* p = w + (size_t)kk * n + c;
  if (vec && c + 3 < n) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v;
  v.x = c < n ? __ldg(p) : 0.0f;
  v.y = c + 1 < n ? __ldg(p + 1) : 0.0f;
  v.z = c + 2 < n ? __ldg(p + 2) : 0.0f;
  v.w = c + 3 < n ? __ldg(p + 3) : 0.0f;
  return v;
}

// issue the cp.async copies of rank ``rank``'s slice of layer L into
// dst ([k][chunk], zero past the layer's last column)
__device__ void stage_layer(const Layer& L, int rank, float* dst, int tid) {
  const int c0 = min(L.n, rank * L.chunk);
  const int nl = min(L.chunk, L.n - c0);
  const bool vec =
      (L.n % 4 == 0) && (reinterpret_cast<uintptr_t>(L.w) % 16 == 0);
  const int quads = L.chunk / 4;
  for (int i = tid; i < L.k * quads; i += kThreads) {
    const int kk = i / quads, cl = 4 * (i % quads);
    const float* src = L.w + (size_t)kk * L.n + c0 + cl;
    float* d = dst + kk * L.chunk + cl;
    if (vec && cl + 4 <= nl) {
      cp_async16(d, src);
    } else {
      for (int j = 0; j < 4; ++j) {
        if (cl + j < nl)
          cp_async4(d + j, src + j);
        else
          d[j] = 0.0f;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One K tile [k0, k1) of a 4-column group: s += h[kk] * W[kk, c..c+3]
// in ascending kk, one fmaf chain per column.  The loads of 8 steps are
// issued before their FMAs, so a step waits on the FMA before it, not on
// a load.
template <bool Staged>
__device__ __forceinline__ float4 w_row(const Layer& L, const float* wst,
                                        int kk, int c, int cl, bool vec) {
  if (Staged)
    return *reinterpret_cast<const float4*>(wst + kk * L.chunk + cl);
  return load_w4(L.w, kk, c, L.n, vec);
}

template <bool Staged>
__device__ __forceinline__ float4 tile_sum(const float* h, const Layer& L,
                                           const float* wst, int c, int cl,
                                           bool vec, int k0, int k1) {
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int kk = k0;
  for (; kk + 8 <= k1; kk += 8) {
    float xv[8];
    float4 wv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xv[j] = h[kk + j];
      wv[j] = w_row<Staged>(L, wst, kk + j, c, cl, vec);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s.x = fmaf(xv[j], wv[j].x, s.x);
      s.y = fmaf(xv[j], wv[j].y, s.y);
      s.z = fmaf(xv[j], wv[j].z, s.z);
      s.w = fmaf(xv[j], wv[j].w, s.w);
    }
  }
  for (; kk < k1; ++kk) {
    const float xv = h[kk];
    const float4 wv = w_row<Staged>(L, wst, kk, c, cl, vec);
    s.x = fmaf(xv, wv.x, s.x);
    s.y = fmaf(xv, wv.y, s.y);
    s.z = fmaf(xv, wv.z, s.z);
    s.w = fmaf(xv, wv.w, s.w);
  }
  return s;
}

// kShared: the plan keeps the rank's buffers and its weight slices in
// shared memory, so the compiler addresses them as such; otherwise every
// buffer is in the global scratch and the weights are read through L1
template <bool kShared>
__global__ void __launch_bounds__(kThreads) fused_chain_kernel(Params p) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int mblk = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bm = p.bm;
  float* own = kShared
                   ? reinterpret_cast<float*>(smem4)
                   : p.scratch + ((size_t)mblk * cs + rank) * p.rank_floats;
  float* slab = own + p.slab_off;
  float* rows = own + p.rows_off;
  float* acc = own + p.acc_off;
  const int row0 = mblk * bm;

  // weight slices by cp.async, in flight while the x rows are staged and
  // layer 0 computes: every layer's, one group a layer, or layer 0's (the
  // next layer's follows each layer's compute)
  if (p.stage == kStageAll) {
    for (int l = 0; l < p.n_layers; ++l)
      stage_layer(p.layers[l], rank, own + p.wst_off + p.layers[l].w_off,
                  tid);
  } else if (p.stage == kStageLayer) {
    stage_layer(p.layers[0], rank, own + p.wst_off, tid);
  }
  {  // the M block's x rows into the slab, zero past m0
    const Layer L = p.layers[0];
    for (int i = tid; i < bm * L.k; i += kThreads) {
      const int r = i / L.k, c = i % L.k;
      slab[r * p.slab_ld + c] =
          row0 + r < L.m ? p.x[(size_t)(row0 + r) * L.k + c] : 0.0f;
    }
  }

  for (int l = 0; l < p.n_layers; ++l) {
    const Layer L = p.layers[l];
    const int n = L.n, k = L.k, bk = L.bk;
    const int c0 = min(n, rank * L.chunk);
    const int nl = min(L.chunk, n - c0);  // this rank's columns
    const int gpr = (nl + 3) / 4;         // 4-column groups per row
    if (kShared)
      cp_async_wait(p.stage == kStageAll ? p.n_layers - 1 - l : 0);
    __syncthreads();

    const float* wst = own + p.wst_off + L.w_off;
    const bool vec = (n % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(L.w) % 16 == 0);
    const bool elem = L.act != kNone && L.act < kSoftmax;
    // fewer groups than threads: one a warp in turn, so that the FMA
    // chains of a small layer run on every scheduler
    const int i0 = bm * gpr < kThreads ? lane * kWarps + warp : tid;
    for (int i = i0; i < bm * gpr; i += kThreads) {
      const int r = i / gpr, cl = 4 * (i % gpr);
      const float* h = slab + (size_t)r * p.slab_ld;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      for (int k0 = 0; k0 < k; k0 += bk) {
        const int k1 = min(k0 + bk, k);
        const float4 s =
            tile_sum<kShared>(h, L, wst, c0 + cl, cl, vec, k0, k1);
        a0 += s.x;
        a1 += s.y;
        a2 += s.z;
        a3 += s.w;
      }
      if (elem) {
        a0 = elementwise(a0, L.act);
        a1 = elementwise(a1, L.act);
        a2 = elementwise(a2, L.act);
        a3 = elementwise(a3, L.act);
      }
      *reinterpret_cast<float4*>(acc + (size_t)r * p.acc_ld + cl) =
          make_float4(a0, a1, a2, a3);
    }

    const bool last = l == p.n_layers - 1;
    const bool gather = L.act >= kSoftmax || (!last && p.layers[l + 1].adapt);
    if (last && !gather) {
      __syncthreads();
      for (int i = tid; i < bm * nl; i += kThreads) {
        const int r = i / nl, c = i % nl;
        if (row0 + r < p.m_out)
          p.out[(size_t)(row0 + r) * n + c0 + c] = acc[r * p.acc_ld + c];
      }
      break;
    }

    // every rank has finished reading the buffer this layer writes (and
    // the weight stage, which the next layer's slice may now fill)
    cluster.sync();
    if (p.stage == kStageLayer && !last)
      stage_layer(p.layers[l + 1], rank, own + p.wst_off, tid);
    // one float4 store a thread: (rank q, row, group) over every thread
    const int off = gather ? p.rows_off : p.slab_off;
    const int ld = gather ? p.rows_ld : p.slab_ld;
    for (int i = tid; i < cs * bm * gpr; i += kThreads) {
      const int q = i / (bm * gpr), j = i % (bm * gpr);
      const int r = j / gpr, cl = 4 * (j % gpr);
      float* dst = (kShared ? cluster.map_shared_rank(own, q)
                            : p.scratch + ((size_t)mblk * cs + q) *
                                              p.rank_floats) + off;
      const float4 v =
          *reinterpret_cast<const float4*>(acc + (size_t)r * p.acc_ld + cl);
      float* d = dst + (size_t)r * ld + c0 + cl;
      if (cl + 4 <= nl) {
        *reinterpret_cast<float4*>(d) = v;
      } else {
        d[0] = v.x;
        if (cl + 1 < nl) d[1] = v.y;
        if (cl + 2 < nl) d[2] = v.z;
      }
    }
    cluster.sync();
    if (!gather) continue;

    // whole rows in every rank: the row-wise act, then the output, the
    // adapt's index map or a plain copy into the slab
    if (L.act >= kSoftmax) {
      for (int r = warp; r < bm; r += kWarps)
        rowwise(rows + (size_t)r * p.rows_ld, n, L.act, lane);
      __syncthreads();
    }
    if (last) {
      for (int i = tid; i < bm * nl; i += kThreads) {
        const int r = i / nl, c = i % nl;
        if (row0 + r < p.m_out)
          p.out[(size_t)(row0 + r) * n + c0 + c] =
              rows[r * p.rows_ld + c0 + c];
      }
      break;
    }
    const Layer next = p.layers[l + 1];
    if (next.adapt) {
      // ravel rows[:m_l, :n_l] row-major, cycle, reshape to (m', k')
      const int size = L.m * n;
      for (int i = tid; i < bm * next.k; i += kThreads) {
        const int r = i / next.k, c = i % next.k;
        float val = 0.0f;
        if (r < next.m && size > 0) {
          const int f = (r * next.k + c) % size;
          val = rows[(f / n) * p.rows_ld + f % n];
        }
        slab[r * p.slab_ld + c] = val;
      }
    } else {
      for (int i = tid; i < bm * n; i += kThreads) {
        const int r = i / n, c = i % n;
        slab[r * p.slab_ld + c] = rows[r * p.rows_ld + c];
      }
    }
  }
  // no rank leaves while another may still write into its shared memory
  cluster.sync();
}

// The host checks before a launch, made once per configuration: the
// shared-memory opt-in (raised, never lowered, per device and kernel),
// the non-portable cluster opt-in, and whether one cluster of cs blocks
// with smem bytes each fits the card.  Later launches of a configuration
// that passed skip them.
cudaError_t check_once(void (*kernel)(Params), bool use_smem,
                       cudaLaunchConfig_t* cfg, int cs, size_t smem) {
  struct Fits {
    int dev;
    bool use_smem;
    int cs;
    size_t smem;
  };
  struct OptIn {
    int dev;
    bool use_smem;
    size_t smem;
  };
  static std::mutex mu;
  static std::vector<Fits> fits;
  static std::vector<OptIn> opted;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Fits& f : fits)
    if (f.dev == dev && f.use_smem == use_smem && f.cs == cs &&
        f.smem == smem)
      return cudaSuccess;
  OptIn* o = nullptr;
  for (OptIn& e : opted)
    if (e.dev == dev && e.use_smem == use_smem) o = &e;
  if (o == nullptr) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    opted.push_back({dev, use_smem, 0});
    o = &opted.back();
  }
  if (smem > o->smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    o->smem = smem;
  }
  // the chosen cluster must fit the card as it is; never shrink it
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  fits.push_back({dev, use_smem, cs, smem});
  return cudaSuccess;
}

}  // namespace

// One launch of the chain.  ws[l] is layer l's [k, n] weight; layers
// holds 8 ints per layer: m, k, n, bk, act (0 none, 1 relu, 2 gelu,
// 3 silu, 4 softmax, 5 rmsnorm, 6 layernorm), adapt, chunk (columns per
// rank) and w_off (the layer's offset in the weight stage).  plan holds
// n_m, cs, bm, m_out, slab_ld, rows_ld, acc_ld, slab_off, rows_off,
// acc_off, wst_off, rank_floats, use_smem and stage (0: weights read from
// device memory, 1: every layer's slice staged at the start, 2: one
// layer's slice at a time, at wst_off).
// n_m clusters of cs blocks; scratch holds n_m * cs * rank_floats floats
// when use_smem is 0.  Shrinks no size quietly: a cluster that cannot
// be resident returns cudaErrorLaunchOutOfResources.  Returns the
// launch's cudaError_t.
extern "C" int fused_chain_f32(const void* x, const void* const* ws,
                               const int* layers, int n_layers,
                               const int* plan, void* out, void* scratch,
                               void* stream) {
  if (n_layers <= 0 || n_layers > kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_m = plan[0], cs = plan[1];
  if (n_m <= 0) return 0;
  if (cs < 1 || cs > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    const int* li = layers + kLayerInts * l;
    p.layers[l].w = static_cast<const float*>(ws[l]);
    p.layers[l].m = li[0];
    p.layers[l].k = li[1];
    p.layers[l].n = li[2];
    p.layers[l].bk = li[3];
    p.layers[l].act = li[4];
    p.layers[l].adapt = li[5];
    p.layers[l].chunk = li[6];
    p.layers[l].w_off = li[7];
  }
  p.x = static_cast<const float*>(x);
  p.out = static_cast<float*>(out);
  p.scratch = static_cast<float*>(scratch);
  p.bm = plan[2];
  p.m_out = plan[3];
  p.slab_ld = plan[4];
  p.rows_ld = plan[5];
  p.acc_ld = plan[6];
  p.slab_off = plan[7];
  p.rows_off = plan[8];
  p.acc_off = plan[9];
  p.wst_off = plan[10];
  p.rank_floats = plan[11];
  p.use_smem = plan[12];
  p.stage = plan[13];
  const size_t smem =
      p.use_smem ? sizeof(float) * static_cast<size_t>(p.rank_floats) : 0;

  void (*kernel)(Params) = p.use_smem ? fused_chain_kernel<true>
                                      : fused_chain_kernel<false>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_m * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = check_once(kernel, p.use_smem != 0, &cfg, cs, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
