// Block-fused batched decode attention + output projection for Hopper, fp32.
//
// Replaces: repro/kernels/flash_attention.py, flash_decode_proj /
// _decode_proj_kernel (the Pallas TPU kernel that folds the output
// projection Wo into batched decode attention's last KV step).
//
// For request b with context ctx_b = softmax(q_b k_b[:len_b]^T * scale)
// v_b[:len_b] ([sq, dv], by the online-softmax recurrence over KV blocks,
// a request of length 0 giving zeros), the runtime's adapt head-merge
// ravels ctx_b row-major, cycles it to m_out * k_out elements and refolds
// it to h_b [m_out, k_out]; out[b] = h_b @ wo, with wo [k_out, n_out]
// shared by every request.
//
// What bounds it on an H100: the bytes of wo.  At the main path's shapes
// (gemma-7b, 4 requests, skv 16, head_dim 256, wo 4096 x 3072) wo is
// 50.3 MB of fp32 and everything else ~0.2 MB: ~0.015 ms at 3.35 TB/s.
// The attention is four tiny dot products and the projection ~0.1 GFLOP,
// so the kernel stays on fp32 FFMA and spends its design on keeping the
// wo stream at the card's rate:
//   * the grid is a column strip of wo (64 columns) x a K slice: one
//     thread-block cluster of kCluster ranks per strip, rank r owning K
//     rows [r * ks, (r + 1) * ks).  At the main shape that is 48 clusters
//     of 4, 192 blocks of 256 KB of wo each, two a SM: the whole grid is
//     resident at once (clusters of 8 left 3 of 48 for a second wave);
//   * wo reaches shared memory through a ring of kStages chunks of
//     kChunk rows by cp.async, kStages - 1 chunks (64 KB) ahead of the
//     FMAs.  The first kLead chunks leave while the rank's first
//     request's length loads, then its q and first K/V tile (16-byte
//     copies, queued behind 16 KB of wo, not 64 KB), then the rest, so
//     the HBM stream runs under the attention; each chunk's one barrier
//     waits for that chunk only, with the next ones in flight;
//   * each request's context is computed once per cluster: rank r takes
//     requests r, r + kCluster, ... of the group, loading only the first
//     len_b rows of K and V, and keeps it in its shared memory; after a
//     cluster barrier every rank stages the adapted rows it needs,
//     h_b[i][c] = ctx_b[(i * k_out + c) mod (sq * dv)], from the owners'
//     shared memory, 16 bytes a load (the index map is applied there: h
//     is never materialised in device memory).  The attention's scratch
//     and the h window share one region, so the ring can be deeper;
//   * a pass multiplies ROWS rows of h (1, 2, 4 or 8, the fewest that hold
//     the group's rows), and the K slices' partial sums meet in
//     distributed shared memory: each rank sums the 8 warps' partials in
//     order and writes each into the inbox of the rank that owns the
//     output (1/kCluster of the strip's outputs each), one cluster
//     barrier, then each owner adds the kCluster partials in rank order
//     and stores them.
// The summation order of an output depends on k_out alone: each thread
// sums k = g, g + kGroups, ... of its rank's slice in ascending order,
// then a fixed shuffle, the warps in order, the ranks in order.  So a
// request's rows are bit-equal whatever else the launch holds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 4;                  // ranks (K slices) a strip
constexpr int kCols = 64;                    // wo columns a strip
constexpr int kQuads = kCols / 4;            // threads across a strip
constexpr int kGroups = kThreads / kQuads;   // K groups a block
constexpr int kChunk = 32;                   // wo rows a ring stage
constexpr int kStages = 9;                   // ring depth
constexpr int kLead = 2;                     // chunks before q, K and V
constexpr int kBlockKV = 16;                 // most keys a K/V tile
constexpr float kNegInf = -1e30f;
static_assert(kChunk % kGroups == 0, "a thread's rows of a chunk");
static_assert(kLead < kStages - 1, "the q/K/V group is in the prologue");

// shared memory of a block, in floats: the ring, then a scratch that the
// attention (q rows, a K/V tile, scores, stats) and then the projection
// (the h window, which the warps' partials reuse, and the block's partial
// sums) take in turn, then the rank's contexts
// (kernels/flash_attention.py:proj_group sizes the group from the same
// layout; the entry refuses a group that would not fit kSmemLimit)
constexpr int kRingFloats = kStages * kChunk * kCols;
constexpr int kWinFloats = 4096;              // the h window
constexpr int kPartFloats = 2 * 8 * kCols;    // two inboxes of 8 rows
constexpr size_t kSmemLimit = 200 * 1024;     // PROJ_SMEM_LIMIT

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* lengths;
  const float* wo;
  float* o;
  int B, sq, skv, d, dv, m_out, k_out, n_out, group;
  float scale;
  int ks;            // K rows a rank (a multiple of kChunk)
  int own;           // contexts a rank holds: ceil(group / kCluster)
  int bkv;           // keys a K/V tile (tile_keys)
  int scratch;       // floats of the scratch (scratch_floats)
  bool vec_kv;       // q, k and v by 16-byte copies
};

// keys a K/V tile: up to kBlockKV, the tile within 32 KB of shared memory
// (kernels/flash_attention.py:_proj_tile_keys says the same)
int tile_keys(int d, int dv) {
  return std::max(1, std::min(kBlockKV, 8192 / (d + dv)));
}

// the scratch: the larger of the attention's and the projection's parts,
// rounded to 16 bytes (kernels/flash_attention.py:proj_group says the same)
int scratch_floats(int sq, int d, int dv, int bkv) {
  const int attn = sq * d + bkv * (d + dv) + sq * (kBlockKV + 3);
  return (std::max(attn, kWinFloats + kPartFloats) + 3) / 4 * 4;
}

// chunk `c` of this rank's K slice, columns [col0, col0 + kCols), into
// `dst` ([kChunk][kCols]); rows past k_end and columns past n_out are
// zero.  VEC4: 16-byte copies (n_out % 4 == 0, wo 16-byte aligned).
template <bool VEC4>
__device__ __forceinline__ void issue_chunk(const Params& p, float* dst,
                                            int k0, int k_end, int col0,
                                            int tid) {
  if (VEC4) {
#pragma unroll
    for (int i = tid; i < kChunk * kQuads; i += kThreads) {
      const int r = i / kQuads, c = 4 * (i % kQuads);
      const int kr = k0 + r, n = col0 + c;
      const bool in = kr < k_end && n < p.n_out;
      const float* src = in ? p.wo + (size_t)kr * p.n_out + n : p.wo;
      cp_async16(dst + r * kCols + c, src, in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = tid; i < kChunk * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      const int kr = k0 + r, n = col0 + c;
      const bool in = kr < k_end && n < p.n_out;
      const float* src = in ? p.wo + (size_t)kr * p.n_out + n : p.wo;
      cp_async4(dst + r * kCols + c, src, in ? 4 : 0);
    }
  }
}

// Request b's q rows (with_q) and its keys and values kv0 .. kv0 + bkv
// into shared memory by cp.async, one commit group; rows at or past len
// are zero (never read from device memory).  16-byte copies where d and
// dv are multiples of 4 (vec_kv).
__device__ void stage_kv(const Params& p, int b, int kv0, int len,
                         bool with_q, float* qs, float* ks, float* vs) {
  const int tid = threadIdx.x;
  const int n = min(p.bkv, len - kv0);             // rows in the tile
  const float* qb = p.q + (size_t)b * p.sq * p.d;
  const float* kb = p.k + ((size_t)b * p.skv + kv0) * p.d;
  const float* vb = p.v + ((size_t)b * p.skv + kv0) * p.dv;
  if (p.vec_kv) {
    if (with_q)
      for (int i = 4 * tid; i < p.sq * p.d; i += 4 * kThreads)
        cp_async16(qs + i, qb + i, 16);
    for (int i = 4 * tid; i < p.bkv * p.d; i += 4 * kThreads)
      cp_async16(ks + i, i < n * p.d ? kb + i : p.k, i < n * p.d ? 16 : 0);
    for (int i = 4 * tid; i < p.bkv * p.dv; i += 4 * kThreads)
      cp_async16(vs + i, i < n * p.dv ? vb + i : p.v,
                 i < n * p.dv ? 16 : 0);
  } else {
    if (with_q)
      for (int i = tid; i < p.sq * p.d; i += kThreads)
        cp_async4(qs + i, qb + i, 4);
    for (int i = tid; i < p.bkv * p.d; i += kThreads)
      cp_async4(ks + i, i < n * p.d ? kb + i : p.k, i < n * p.d ? 4 : 0);
    for (int i = tid; i < p.bkv * p.dv; i += kThreads)
      cp_async4(vs + i, i < n * p.dv ? vb + i : p.v, i < n * p.dv ? 4 : 0);
  }
  cp_async_commit();
}

// The normalised context of request b, [sq, dv], into ctx (this block's
// shared memory), by the online-softmax recurrence over KV tiles of bkv
// keys, the first len keys only.  ``staged``: q and the first tile were
// staged (stage_kv) in the group after the ring's first kLead chunks.
// All threads call it (it holds block barriers) and it ends with one.
__device__ void decode_context(const Params& p, int b, int len, bool staged,
                               float* qs, float* ks, float* vs, float* ps,
                               float* stats, float* ctx) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float* m_run = stats;
  float* l_run = stats + p.sq;
  float* alpha = stats + 2 * p.sq;
  // q and the first tile, staged before the ring's last kStages - 1 -
  // kLead prologue chunks, have landed (even for len 0: the scratch is
  // reused after)
  if (staged) cp_async_wait<kStages - 1 - kLead>();
  __syncthreads();                        // the scratch is free
  for (int i = tid; i < p.sq * p.dv; i += kThreads) ctx[i] = 0.0f;
  for (int i = tid; i < p.sq; i += kThreads) {
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
  }
  for (int kv0 = 0; kv0 < len; kv0 += p.bkv) {
    if (!staged || kv0 > 0) {
      __syncthreads();                    // the last tile is read
      stage_kv(p, b, kv0, len, kv0 == 0, qs, ks, vs);
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int pi = warp; pi < p.sq * p.bkv; pi += kWarps) {
      const int i = pi / p.bkv, j = pi % p.bkv;
      float s = 0.0f;
      for (int c = lane; c < p.d; c += 32)
        s = fmaf(qs[i * p.d + c], ks[j * p.d + c], s);
      s = warp_sum(s) * p.scale;
      if (lane == 0) ps[i * kBlockKV + j] = (kv0 + j < len) ? s : kNegInf;
    }
    __syncthreads();
    for (int i = warp; i < p.sq; i += kWarps) {
      const float s = lane < p.bkv ? ps[i * kBlockKV + lane] : kNegInf;
      const float m_prev = m_run[i];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float e = (lane < p.bkv && s > kNegInf / 2) ? expf(s - m_new)
                                                        : 0.0f;
      const float psum = warp_sum(e);
      if (lane < p.bkv) ps[i * kBlockKV + lane] = e;
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[i] = a;
        l_run[i] = l_run[i] * a + psum;
        m_run[i] = m_new;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < p.sq * p.dv; idx += kThreads) {
      const int i = idx / p.dv, c = idx % p.dv;
      float pv = 0.0f;
      for (int j = 0; j < p.bkv; ++j)
        pv = fmaf(ps[i * kBlockKV + j], vs[j * p.dv + c], pv);
      ctx[idx] = ctx[idx] * alpha[i] + pv;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < p.sq * p.dv; idx += kThreads)
    ctx[idx] = ctx[idx] / fmaxf(l_run[idx / p.dv], 1e-30f);
  __syncthreads();
}

// ROWS: h rows a pass (1, 2, 4 or 8, the fewest that hold a group's
// rows); the h window holds ROWS x (kWinFloats / ROWS) of them
template <bool VEC4, int ROWS>
__global__ void __launch_bounds__(kThreads, 2)
    decode_proj_kernel(const Params p) {
  constexpr int kWindow = kWinFloats / ROWS;        // h columns a window
  constexpr int kRowThreads = kThreads / ROWS;      // threads staging a row
  static_assert(kWindow % kChunk == 0, "a window holds whole chunks");
  static_assert(kWarps * ROWS * kCols <= kWinFloats,
                "the warps' partials fit the h window they replace");
  static_assert(ROWS * kCols % kCluster == 0 &&
                    ROWS * kCols / kCluster <= kThreads,
                "one output a thread in the cross-rank sum");
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [kStages][kChunk][kCols]
  float* win = ring + kRingFloats;                   // [ROWS][kWindow]
  float* part = win + kWinFloats;                    // [2][kCluster][..]
  float* qs = win;                                   // [sq][d]
  float* ks = qs + p.sq * p.d;                       // [bkv][d]
  float* vs = ks + p.bkv * p.d;                      // [bkv][dv]
  float* ps = vs + p.bkv * p.dv;                     // [sq][kBlockKV]
  float* stats = ps + p.sq * kBlockKV;               // [3][sq]
  float* ctx = win + p.scratch;                      // [own][sq * dv]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int col0 = (blockIdx.x / kCluster) * kCols;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int quad = tid % kQuads, g = tid / kQuads;
  const int S = p.sq * p.dv;                         // one context, raveled
  const int k_lo = rank * p.ks;
  const int k_end = min(k_lo + p.ks, p.k_out);
  const int cps = p.ks / kChunk;                     // chunks a pass

  // the chunks of every pass, in order: a pass is ROWS rows of a group
  int passes = 0;
  for (int b0 = 0; b0 < p.B; b0 += p.group)
    passes += (min(p.group, p.B - b0) * p.m_out + ROWS - 1) / ROWS;
  const int total = passes * cps;
  int issued = 0;
  auto issue_next = [&]() {
    if (issued < total) {
      const int c = issued % cps;
      issue_chunk<VEC4>(p, ring + (issued % kStages) * (kChunk * kCols),
                        k_lo + c * kChunk, k_end, col0, tid);
    }
    cp_async_commit();                   // empty groups keep the count
    ++issued;
  };
  // the rank's first request's length loads while the first kLead wo
  // chunks leave; then its q and first K/V tile, then the rest of the
  // ring: the attention's few loads wait behind 16 KB of wo, not 64 KB
  const bool staged = rank < min(p.group, p.B);
  const int len_in = staged ? p.lengths[rank] : 0;
  for (int s = 0; s < kLead; ++s) issue_next();
  const int len0 = min(max(len_in, 0), p.skv);
  if (staged) stage_kv(p, rank, 0, len0, true, qs, ks, vs);
  for (int s = kLead; s < kStages - 1; ++s) issue_next();

  int consumed = 0, pass = 0;
  for (int b0 = 0; b0 < p.B; b0 += p.group) {
    const int nb = min(p.group, p.B - b0);
    // this rank's requests of the group: b0 + rank + j * kCluster
    for (int j = 0; j < p.own; ++j) {
      const int r = rank + j * kCluster;
      if (r >= nb) break;
      const int b = b0 + r;
      const bool first = b0 == 0 && j == 0;
      decode_context(p, b, first ? len0 : min(max(p.lengths[b], 0), p.skv),
                     first && staged, qs, ks, vs, ps, stats,
                     ctx + (size_t)j * S);
    }
    cluster.sync();                      // every context of the group is in

    const int rows = nb * p.m_out;
    for (int r0 = 0; r0 < rows; r0 += ROWS) {
      float acc[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;

      for (int w0 = 0; w0 < p.ks; w0 += kWindow) {
        const int wn = min(kWindow, p.ks - w0);
        __syncthreads();                 // the last window is read
        {
          // h row r0 + r of the group, K columns k_lo + w0 + c .. c + 3,
          // through the adapt's index map from its owner's shared memory
          // (one 16-byte load where the 4 do not wrap): the raveled index
          // f = (hi * k_out + col) mod S advances by 4 * kRowThreads a step
          const int r = tid / kRowThreads, c1 = 4 * (tid % kRowThreads);
          const int row = r0 + r;
          const bool live = row < rows;
          const float* src = ctx;
          int f = 0;
          if (live) {
            const int req = row / p.m_out, hi = row % p.m_out;
            src = cluster.map_shared_rank(
                ctx + (size_t)(req / kCluster) * S, req % kCluster);
            f = static_cast<int>(
                ((long long)hi * p.k_out + k_lo + w0 + c1) % S);
          }
          const int step = 4 * kRowThreads % S;
#pragma unroll 4
          for (int c = c1; c < wn; c += 4 * kRowThreads) {
            const int col = k_lo + w0 + c;
            float4 h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (live && S % 4 == 0 && f % 4 == 0 && col + 3 < k_end) {
              h = *reinterpret_cast<const float4*>(src + f);
            } else if (live) {
              float t[4];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                t[e] = col + e < k_end ? src[(f + e) % S] : 0.0f;
              h = make_float4(t[0], t[1], t[2], t[3]);
            }
            *reinterpret_cast<float4*>(win + r * kWindow + c) = h;
            f += step;
            if (f >= S) f -= S;
          }
        }
        // (the chunk loop's first barrier publishes the window)
        for (int c0 = 0; c0 < wn; c0 += kChunk) {
          cp_async_wait<kStages - 2>();  // this thread's copies of the chunk
          __syncthreads();               // everyone's; the oldest slot is free
          issue_next();
          const float* w =
              ring + (consumed % kStages) * (kChunk * kCols) + 4 * quad;
#pragma unroll
          for (int u = 0; u < kChunk / kGroups; ++u) {
            const int kr = g + u * kGroups;
            const float4 wv =
                *reinterpret_cast<const float4*>(w + kr * kCols);
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              const float xv = win[r * kWindow + c0 + kr];
              acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
              acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
              acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
              acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
            }
          }
          ++consumed;
        }
      }

      // the warp's two K groups (lanes q and q + 16) by one shuffle, the
      // warps in order, each output's partial into its owner rank's inbox
      // (the one of this pass's parity); after one cluster barrier the
      // owner adds the kCluster ranks' partials in rank order
      __syncthreads();                   // the window is read: reuse it
      float* red = win;                  // [kWarps][ROWS][kCols]
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = acc[r][e] + __shfl_xor_sync(0xffffffffu,
                                                      acc[r][e], 16);
          if (lane < kQuads) red[(warp * ROWS + r) * kCols + 4 * quad + e] = s;
        }
      __syncthreads();
      constexpr int kPerRank = ROWS * kCols / kCluster;
      float* inbox = part + (pass & 1) * (kCluster * kPerRank);
      for (int i = tid; i < ROWS * kCols; i += kThreads) {
        float s = red[i];
#pragma unroll
        for (int ww = 1; ww < kWarps; ++ww) s += red[ww * ROWS * kCols + i];
        cluster.map_shared_rank(inbox, i / kPerRank)[rank * kPerRank +
                                                     i % kPerRank] = s;
      }
      cluster.sync();                    // every rank's partials are in
      if (tid < kPerRank) {
        const int i = rank * kPerRank + tid;
        const int r = i / kCols, c = i % kCols;
        const int row = r0 + r, n = col0 + c;
        if (row < rows && n < p.n_out) {
          float s = 0.0f;
#pragma unroll
          for (int rr = 0; rr < kCluster; ++rr)
            s += inbox[rr * kPerRank + tid];
          p.o[((size_t)b0 * p.m_out + row) * p.n_out + n] = s;
        }
      }
      ++pass;
    }
  }
  cp_async_wait<0>();
}

template <bool VEC4>
void (*pick(int rows))(Params) {
  if (rows <= 1) return decode_proj_kernel<VEC4, 1>;
  if (rows <= 2) return decode_proj_kernel<VEC4, 2>;
  if (rows <= 4) return decode_proj_kernel<VEC4, 4>;
  return decode_proj_kernel<VEC4, 8>;
}

// The shared-memory opt-in, made once per device and size
cudaError_t opt_in(void (*kernel)(Params), size_t smem) {
  struct OptIn {
    void (*kernel)(Params);
    int dev;
    size_t smem;
  };
  static std::mutex mu;
  static std::vector<OptIn> opted;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const OptIn& o : opted)
    if (o.kernel == kernel && o.dev == dev && o.smem >= smem)
      return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  opted.push_back({kernel, dev, smem});
  return cudaSuccess;
}

}  // namespace

// q [B, sq, d], k [B, skv, d], v [B, skv, dv], lengths [B] int32, wo
// [k_out, n_out], all contiguous fp32 on the device; o [B, m_out, n_out].
// ``group`` requests' contexts are held in the clusters' shared memory at
// once, ceil(group / kCluster) a rank (the wrapper sizes it to fit; a
// group past kSmemLimit is refused).  Returns the launch's cudaError_t.
extern "C" int flash_decode_proj_f32(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     const void* wo, void* o, int B, int sq,
                                     int skv, int d, int dv, int m_out,
                                     int k_out, int n_out, int group,
                                     float scale, void* stream) {
  if (B <= 0 || m_out <= 0 || n_out <= 0) return 0;
  if (group <= 0 || sq <= 0 || dv <= 0 || d <= 0 || k_out <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.lengths = static_cast<const int*>(lengths);
  p.wo = static_cast<const float*>(wo);
  p.o = static_cast<float*>(o);
  p.B = B;
  p.sq = sq;
  p.skv = skv;
  p.d = d;
  p.dv = dv;
  p.m_out = m_out;
  p.k_out = k_out;
  p.n_out = n_out;
  p.group = group;
  p.scale = scale;
  // the K slice depends on k_out alone
  const int per_rank = (k_out + kCluster - 1) / kCluster;
  p.ks = (per_rank + kChunk - 1) / kChunk * kChunk;
  p.own = (group + kCluster - 1) / kCluster;
  p.bkv = tile_keys(d, dv);
  p.scratch = scratch_floats(sq, d, dv, p.bkv);
  p.vec_kv = d % 4 == 0 && dv % 4 == 0 &&
             (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const size_t smem =
      sizeof(float) * ((size_t)kRingFloats + p.scratch +
                       (size_t)p.own * sq * dv);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 =
      (n_out % 4 == 0) && (reinterpret_cast<uintptr_t>(wo) % 16 == 0);
  const int rows = std::min(group, B) * m_out;      // the largest pass
  void (*kernel)(Params) = vec4 ? pick<true>(rows) : pick<false>(rows);
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n_out + kCols - 1) / kCols) * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
