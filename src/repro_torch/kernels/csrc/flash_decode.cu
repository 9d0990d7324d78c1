// Batched ragged decode attention for Hopper, fp32 or bf16 operands:
// an fp32 route shaped for latency and a bf16 route shaped for long
// caches and many query rows.
//
// Replaces: repro/kernels/flash_attention.py, flash_decode /
// _decode_kernel (the Pallas TPU kernel that advances a whole decode
// batch's attention segment in one launch).
//
// For request b: out[b] = softmax(q[b] k[b, :len_b]^T * scale) v[b, :len_b],
// by the online-softmax recurrence over KV tiles with running
// (max, sum, acc); positions at or past len_b are masked, a masked score
// contributes p = 0 (a request of length 0 gives zeros), and there is no
// default d**-0.5 scale (the GEMM stream's score GEMM carries none).
//
// Operand types, as the TPU kernel (which is generic over them): q, k and
// v are all fp32 or all bf16.  Scores, the running max and sum and the
// P V accumulator are fp32; p is rounded to v's type before the P V
// product (the sum l takes p unrounded) and the output is stored in q's
// type.
//
// ---- The fp32 route (flash_decode_f32), the MINISA serve's ----
//
// It does the same operations in the same order as the kernel before the
// bf16 route was added (chip_smoke.py holds it bit-equal).
//
// What bounds it on an H100: every q, k and v element is read once and
// used for 2 flops, so the bytes bound it; but at the serve's shapes (up
// to 4 requests x 1 query row x 16 positions x 256 wide at full width, up
// to 5 x 1 x 16 x 16 reduced) a launch moves at most ~130 KB, a few
// hundredths of a microsecond at 3.35 TB/s: the launch, one memory round
// trip and the chain of dependent steps in a block set its time.
//
// What the design does about it:
// - Spread: a block per (strip of 64 columns of v, group of 16 query
//   rows, request), so the serve's launch runs on 16 SMs, not 4.
//   Each block recomputes its rows' scores over the whole d (sq * len * d
//   flops, tiny) and keeps only its strip of the output.
// - One round trip: q, the first KV tile's K rows and V strip go out as
//   16-byte cp.async together with the load of the request's length, and
//   are waited for once; later tiles (longer than 16 positions) are
//   fetched while the previous one is computed.
// - Short chains: all 128 threads score a query row at once (16
//   positions x 8 segments of d, joined by three shuffles), then every
//   warp runs the softmax of each row by shuffles and the P V product for
//   its own columns of the strip.  Two barriers a KV tile: one for the
//   tile's loads, one for the scores.  With one barrier (each warp
//   scoring every row itself, no scores in shared memory) the four
//   warps read K from shared memory four times over, which costs more
//   than the barrier it saves: 0.0073 against 0.0070 ms at the serve's
//   shape on an H100 (compare_kernels.py).
//
// ---- The bf16 route (flash_decode_bf16), the model zoo's ----
//
// The zoo hands it whisper-base's cross attention (32 rows of one query
// against 1500 frames of 64), MLA's absorbed decode (128 heads as query
// rows, d 576, dv 512, ~50 keys) and GQA's self attention (1-8 rows,
// d 256, a cache that grows with the context).  What bounds it: the
// bytes of K and V (4 flops a key and a row per d); at 1500 keys the
// fp32 route's grid (32 blocks) left most of the card idle with each
// block walking 94 tiles in series, and at MLA's 128 rows its 8 strips
// each recomputed the same scores on FFMA.
//
// What the design does about it:
// - Keys split across a thread-block cluster: a block takes one
//   (request, group of 16 query rows, strip of v's columns, range of
//   keys).  The ranges (`plan`) depend on skv alone: up to kMaxSplits
//   ranges of at least kSplitMin keys, a multiple of 64, so a row's
//   result is the same whatever the batch it arrives in.  At whisper's
//   1500 keys that is 8 ranges of 192: 256 blocks.  A strip is all of dv
//   up to 512 columns where a block has 16 query rows to share its
//   scores; below 16 rows (GQA's groups, a single query) it is 128
//   columns, each strip scoring its few rows again, for more blocks.
// - A block streams its range in chunks of 64 keys (32 where d + dv is
//   wide), as many chunks in flight at once as fit in shared memory
//   (cp.async, a ring of `stages`): the whole range of a short one.
// - Both products on the tensor cores, mma.sync m16n8k16 bf16 with fp32
//   sums (flash_attention.cu's fragments): a query-row group is one m16
//   tile.  Each warp scores a quarter of a chunk's keys over all of d
//   (two chains of k steps, q's and K's fragments by ldmatrix); the row
//   max goes through shared memory, p is rounded to bf16 into shared
//   memory and its unrounded row sum beside it; then each warp
//   multiplies P by its quarter of the strip's columns, V's fragments by
//   ldmatrix.trans.  The scores of a row group are computed once,
//   whatever dv.  Rows of the tile past sq are zeros: at these shapes the
//   bytes, not the tensor cores, bound the route.
// - The combine: each block leaves its fp32 partial output, running max
//   and sum in its shared memory; after a cluster barrier, rank r reads
//   every rank's (distributed shared memory, all loads in flight at
//   once) for its share of the output elements and merges them in rank
//   order: m = max m_i, l = sum l_i 2^(m_i - m), o = sum acc_i
//   2^(m_i - m) / l.  A range with no valid key has m_i = -1e30, l_i = 0,
//   acc_i = 0 and adds nothing; a row with none at all gives zeros.  A
//   range alone stores acc / l.  Scores run in base 2 (scale * log2 e
//   folded into the scale).
// - Its times on an H100 beside the fp32 kernel's template that it
//   replaced: chip_smoke.py phase 2 and compare_kernels.py (PERF.md §6).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;                // KV positions a tile
constexpr int kSeg = kThreads / kTile;   // segments of d a score is cut into
constexpr int kRows = 16;                // query rows a block
constexpr int kStrip = 64;               // columns of v a block
constexpr int kWarpCols = kStrip / kWarps;  // 16: a lane's column and half
constexpr int kKeys = kTile / 2;         // positions in a half
constexpr float kNegInf = -1e30f;

// An operand type: elements in 16 bytes, the fp32 value of an element,
// an fp32 value stored as one, and p as it enters P V (rounded to v's
// type).
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ static float get(float x) { return x; }
  __device__ static float put(float x) { return x; }
  __device__ static float round(float p) { return p; }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static __nv_bfloat16 put(float x) { return __float2bfloat16(x); }
};

// s + a . b over one 16-byte chunk of each row, in element order
__device__ __forceinline__ float dot16(const float* a, const float* b,
                                       float s) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  s = fmaf(x.x, y.x, s);
  s = fmaf(x.y, y.y, s);
  s = fmaf(x.z, y.z, s);
  s = fmaf(x.w, y.w, s);
  return s;
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + rows) of a row-major [n_rows, width] matrix, columns
// [c0, c0 + cols), into shared memory rows of `stride` elements; columns
// past `width` and rows past n_rows are zero.  VEC: 16-byte cp.async
// (width, c0 and the base 16-byte aligned); else element copies.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(T* dst, int stride, const T* src,
                                      int width, int r0, int rows,
                                      int n_rows, int c0, int cols) {
  if constexpr (VEC) {
    constexpr int kVec = Elem<T>::kVec;
    const int chunks = cols / kVec;
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      const int r = i / chunks, c = (i % chunks) * kVec;
      const bool in = r0 + r < n_rows && c0 + c < width;
      const T* g = in ? src + (size_t)(r0 + r) * width + c0 + c : src;
      cp_async16(dst + r * stride + c, g, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i % cols;
      const bool in = r0 + r < n_rows && c0 + c < width;
      dst[r * stride + c] = in ? src[(size_t)(r0 + r) * width + c0 + c]
                               : Elem<T>::put(0.0f);
    }
  }
}

// grid (strips of kStrip columns of dv, groups of kRows query rows,
// requests)
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths,
                        T* __restrict__ o, int sq, int skv, int d, int dv,
                        int dp, int qrows, float scale) {
  // dp: d padded to a multiple of 8; rows of q and k are dp elements and
  // 16 bytes more; qrows = min(sq, kRows) rows of q
  using E = Elem<T>;
  extern __shared__ __align__(16) float smem[];
  const int ds = dp + E::kVec;
  const int n_chunks = dp / E::kVec;             // 16-byte chunks a row
  T* qs = reinterpret_cast<T*>(smem);            // [qrows, ds]
  T* ks = qs + qrows * ds;                       // [2][kTile, ds]
  T* vs = ks + 2 * kTile * ds;                   // [2][kTile, kStrip]
  float* ss = reinterpret_cast<float*>(vs + 2 * kTile * kStrip);
                                                 // [kRows, kTile] scores

  const int c0 = blockIdx.x * kStrip;
  const int row0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + (size_t)b * sq * d;
  const T* kb = k + (size_t)b * skv * d;
  const T* vb = v + (size_t)b * skv * dv;
  const int rows = min(kRows, sq - row0);

  // everything the first tile needs, in flight together with the length
  stage<T, VEC>(qs, ds, qb, d, row0, qrows, sq, 0, dp);
  stage<T, VEC>(ks, ds, kb, d, 0, kTile, skv, 0, dp);
  stage<T, VEC>(vs, kStrip, vb, dv, 0, kTile, skv, c0, kStrip);
  cp_async_commit();
  const int len = min(max(lengths[b], 0), skv);
  const int n_tiles = (len + kTile - 1) / kTile;

  // scoring: a thread takes position `pos` over every kSeg-th 16-byte
  // chunk of d
  const int pos = threadIdx.x / kSeg, seg = threadIdx.x % kSeg;
  // P V: a lane's column of the strip and half of the positions
  const int col = warp * kWarpCols + lane % kWarpCols;
  const int half = lane / kWarpCols;
  float m_run[kRows], l_run[kRows], acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.0f;
    acc[r] = 0.0f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    const T* kt = ks + buf * kTile * ds;
    const T* vt = vs + buf * kTile * kStrip;
    cp_async_wait<0>();
    __syncthreads();                     // tile in; tile - 1 read by all
    if (tile + 1 < n_tiles) {
      const int nxt = (tile + 1) * kTile;
      stage<T, VEC>(ks + (buf ^ 1) * kTile * ds, ds, kb, d, nxt, kTile, skv,
                    0, dp);
      stage<T, VEC>(vs + (buf ^ 1) * kTile * kStrip, kStrip, vb, dv, nxt,
                    kTile, skv, c0, kStrip);
      cp_async_commit();
    }
    const int n_valid = min(kTile, len - tile * kTile);

    const T* kr = kt + pos * ds;
    for (int i = 0; i < rows; ++i) {
      const T* qr = qs + i * ds;
      // two independent chains over alternate chunks, each in element
      // order
      float s0 = 0.0f, s1 = 0.0f;
      int c = seg;
      for (; c + kSeg < n_chunks; c += 2 * kSeg) {
        s0 = dot16(qr + c * E::kVec, kr + c * E::kVec, s0);
        s1 = dot16(qr + (c + kSeg) * E::kVec, kr + (c + kSeg) * E::kVec, s1);
      }
      if (c < n_chunks) s0 = dot16(qr + c * E::kVec, kr + c * E::kVec, s0);
      float s = s0 + s1;
#pragma unroll
      for (int off = kSeg / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (seg == 0) ss[i * kTile + pos] = pos < n_valid ? s * scale : kNegInf;
    }
    __syncthreads();                     // the tile's scores are in

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) break;
      const float x = ss[r * kTile + lane % kTile];
      float mx = x;
#pragma unroll
      for (int off = kTile / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[r], mx);
      const float p = x > kNegInf / 2 ? expf(x - m_new) : 0.0f;
      const float pr = E::round(p);      // p as it enters P V
      float psum = p;
#pragma unroll
      for (int off = kTile / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha + psum;
      m_run[r] = m_new;
      float pv = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        const int j = half * kKeys + jj;
        pv = fmaf(__shfl_sync(0xffffffffu, pr, j), E::get(vt[j * kStrip + col]),
                  pv);
      }
      pv += __shfl_xor_sync(0xffffffffu, pv, 16);
      acc[r] = acc[r] * alpha + pv;
    }
  }
  cp_async_wait<0>();

  if (half != 0) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= rows) break;
    const float inv = 1.0f / fmaxf(l_run[r], 1e-30f);
    if (c0 + col < dv)
      o[((size_t)b * sq + row0 + r) * dv + c0 + col] = E::put(acc[r] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* o, int B, int sq, int skv,
                   int d, int dv, float scale, cudaStream_t stream) {
  constexpr int kVec = Elem<T>::kVec;
  const int dp = (d + 7) / 8 * 8;
  const int qrows = sq < kRows ? sq : kRows;
  const size_t smem =
      sizeof(T) * ((size_t)(qrows + 2 * kTile) * (dp + kVec) +
                   (size_t)2 * kTile * kStrip) +
      sizeof(float) * (size_t)kRows * kTile;
  const bool vec = d % kVec == 0 && dv % kVec == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  auto kernel = vec ? flash_decode_kernel<T, true>
                    : flash_decode_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((dv + kStrip - 1) / kStrip, (sq + kRows - 1) / kRows, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(o), sq, skv, d, dv, dp, qrows, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// The bf16 route
// ------------------------------------------------------------------------

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kMaxSplits = 8;        // ranks a cluster (the portable size)
constexpr int kSplitMin = 128;       // keys a range at least, when split
constexpr int kSplitAlign = 64;      // a range is a multiple of this
constexpr int kMaxStrip = 512;       // columns of v a block
constexpr int kFewRowsStrip = 128;   // ... where sq < 16 (no scores shared)
constexpr int kStageBudget = 96 * 1024;   // a chunk of 64 keys at most
constexpr int kSmemBudget = 200 * 1024;   // a block's shared memory
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 232448;          // what a block can opt into
constexpr float kLog2e = 1.4426950408889634f;

// How a launch cuts its work: the ranges a function of skv alone, the
// rest of (skv, d, dv, sq), never of B.
struct Plan {
  int split;     // keys a range
  int n_split;   // ranges (cluster ranks)
  int chunk;     // keys a chunk (64, or 32 where d + dv is wide)
  int stages;    // chunks in flight at once
  int dp;        // d padded to 16 (a k step)
  int dvp;       // a strip's columns padded to 64, 128, 256 or 512
  int strip;     // columns of v a block
  int strips;    // strips of v's columns
  size_t smem;   // bytes of shared memory a block
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline size_t stage_bytes(int chunk, int dp, int dvp) {
  return sizeof(bf16) * (size_t)chunk * ((dp + 8) + (dvp + 8));
}

Plan plan(int skv, int d, int dv, int sq) {
  Plan p;
  p.dp = cdiv(d > 0 ? d : 1, 16) * 16;
  p.strip = sq < kRows ? kFewRowsStrip : kMaxStrip;
  p.strips = cdiv(dv, p.strip);
  const int cols = dv < p.strip ? dv : p.strip;
  p.dvp = cols <= 64 ? 64 : cols <= 128 ? 128 : cols <= 256 ? 256 : 512;
  int n = skv > 0 ? cdiv(skv, kSplitMin) : 1;
  n = n < kMaxSplits ? n : kMaxSplits;
  p.split = cdiv(cdiv(skv > 0 ? skv : 1, n), kSplitAlign) * kSplitAlign;
  p.n_split = skv > 0 ? cdiv(skv, p.split) : 1;
  p.chunk = stage_bytes(64, p.dp, p.dvp) <= (size_t)kStageBudget ? 64 : 32;
  const size_t fixed = sizeof(bf16) * (size_t)kRows * ((p.dp + 8) +
                                                       (p.chunk + 8)) +
                       sizeof(float) * 2 * kWarps * kRows;
  const size_t stage = stage_bytes(p.chunk, p.dp, p.dvp);
  const int chunks = p.split / p.chunk;
  long fit = ((long)kSmemBudget - (long)fixed) / (long)stage;
  fit = fit < 1 ? 1 : fit;
  p.stages = (int)(chunks < fit ? chunks : fit);
  p.stages = p.stages < kMaxStages ? p.stages : kMaxStages;
  size_t ring = stage * p.stages;
  const size_t combine = sizeof(float) * ((size_t)kRows * p.dvp + 2 * kRows);
  p.smem = fixed + (ring > combine ? ring : combine);
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// wait until at most n groups of cp.async are pending (n < 2 kMaxStages)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    case 12: cp_async_wait<12>(); break;
    case 13: cp_async_wait<13>(); break;
    default: cp_async_wait<14>(); break;
  }
}

struct Bf16Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* lengths;
  bf16* o;
  int sq, skv, d, dv, dp, split, n_split, stages, strip, strips, vec;
  float scale_log2;   // scale * log2(e)
};

// grid (ranges, row groups x strips, requests); a cluster is the ranges
// of one (request, row group, strip).  KC keys a chunk; NT 8-column
// tiles of v a warp (the strip is kWarps * NT * 8 = DVP columns).
template <int KC, int NT>
__global__ void __launch_bounds__(kThreads)
    decode_bf16_kernel(const Bf16Args a) {
  constexpr int DVP = kWarps * NT * 8;
  constexpr int VS = DVP + 8;        // a V row in shared memory
  constexpr int PS = KC + 8;         // a P row
  constexpr int KW = KC / kWarps;    // keys a warp scores
  constexpr int NS = KW / 8;         // 8-key tiles a warp scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ds = a.dp + 8;           // a q or K row
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);          // [kRows][ds]
  bf16* ps = qs + kRows * ds;                            // [kRows][PS]
  float* red = reinterpret_cast<float*>(ps + kRows * PS);  // [2][kWarps][16]
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      red + 2 * kWarps * kRows);
  const size_t k_bytes = sizeof(bf16) * (size_t)KC * ds;
  const size_t slot_bytes = k_bytes + sizeof(bf16) * (size_t)KC * VS;

  const int range = blockIdx.x;
  const int strip = blockIdx.y % a.strips;
  const int row0 = (blockIdx.y / a.strips) * kRows;
  const int b = blockIdx.z;
  const int c0 = strip * a.strip;
  const int rows = min(kRows, a.sq - row0);
  const int cols = min(DVP, a.dv - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* qb = a.q + (size_t)b * a.sq * a.d;
  const bf16* kb = a.k + (size_t)b * a.skv * a.d;
  const bf16* vb = a.v + (size_t)b * a.skv * a.dv;
  const int k_lo = range * a.split;
  const int k_hi = min(k_lo + a.split, a.skv);
  const int max_chunks = k_hi > k_lo ? (k_hi - k_lo + KC - 1) / KC : 0;

  // chunk c of the range into slot s, as two groups of cp.async: KC keys
  // of K (all of d, zero past d and past the range), then of V (the
  // strip, zero past dv), so that the scores start before V is in
  auto load = [&](int c, int s) {
    bf16* kd = reinterpret_cast<bf16*>(ring + s * slot_bytes);
    bf16* vd = reinterpret_cast<bf16*>(ring + s * slot_bytes + k_bytes);
    const int key0 = k_lo + c * KC;
    if (a.vec) {
      stage<bf16, true>(kd, ds, kb, a.d, key0, KC, k_hi, 0, a.dp);
      cp_async_commit();
      stage<bf16, true>(vd, VS, vb, a.dv, key0, KC, k_hi, c0, DVP);
    } else {
      stage<bf16, false>(kd, ds, kb, a.d, key0, KC, k_hi, 0, a.dp);
      cp_async_commit();
      stage<bf16, false>(vd, VS, vb, a.dv, key0, KC, k_hi, c0, DVP);
    }
    cp_async_commit();
  };

  // the first `stages` chunks go out with q, before the length is known
  if (a.vec)
    stage<bf16, true>(qs, ds, qb, a.d, row0, kRows, a.sq, 0, a.dp);
  else
    stage<bf16, false>(qs, ds, qb, a.d, row0, kRows, a.sq, 0, a.dp);
  for (int s = 0; s < a.stages; ++s) {
    if (s < max_chunks) {
      load(s, s);
    } else {
      cp_async_commit();
      cp_async_commit();
    }
  }
  const int len = min(max(a.lengths[b], 0), a.skv);
  const int end = min(len, k_hi);
  const int n_chunks = end > k_lo ? (end - k_lo + KC - 1) / KC : 0;

  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  uint32_t* pw = reinterpret_cast<uint32_t*>(ps);
  const int psw = PS / 2;
  float* red_max = red;                  // [kWarps][16]
  float* red_sum = red + kWarps * kRows;

  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c % a.stages;
    if (c > 0) {
      // chunk c - 1 + stages into the slot chunk c - 1 left; chunk j's K
      // is always the (2j)-th group committed and its V the next
      if (c - 1 + a.stages < n_chunks) {
        __syncthreads();                 // every warp is done with it
        load(c - 1 + a.stages, (c - 1) % a.stages);
      } else {
        cp_async_commit();
        cp_async_commit();
      }
    }
    cp_async_wait_n(2 * a.stages - 1);
    __syncthreads();                     // chunk c's K (and q) is in
    const bf16* kt = reinterpret_cast<const bf16*>(ring + slot * slot_bytes);
    const bf16* vt = reinterpret_cast<const bf16*>(ring + slot * slot_bytes +
                                                   k_bytes);
    const int key0 = k_lo + c * KC;

    // ---- S = q K^T: 16 rows x KW keys a warp, two chains over d ----
    float s[NS][4], s2[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s2[n][e] = 0.0f;
    // lane l's rows for ldmatrix: q's row l % 16 at column (l / 16) * 8
    // (the A fragment); the warp's key (l % 8) + (l / 16) * 8 at column
    // ((l / 8) % 2) * 8 (B fragments of two 8-key tiles, or one)
    const bf16* qrow = qs + (lane % 16) * ds + (lane / 16) * 8;
    const bf16* krow = kt + (warp * KW + lane % 8 + (lane / 16) * 8) * ds +
                       ((lane / 8) % 2) * 8;
    const int n_k = a.dp / 16;
    // k steps kk (into s) and kk + 1 (into s2): two independent chains
    auto k_step = [&](int kk, float (*acc_s)[4]) {
      uint32_t af[4], bf[4];
      ldmatrix_x4(af, qrow + kk * 16);
      if constexpr (NS == 2) {
        ldmatrix_x4(bf, krow + kk * 16);
      } else {
        ldmatrix_x2(bf, krow + kk * 16);
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) mma_bf16(acc_s[n], af, bf + 2 * n);
    };
    for (int kk = 0; kk < n_k; kk += 2) {
      k_step(kk, s);
      if (kk + 1 < n_k) k_step(kk + 1, s2);
    }

    // ---- the chunk's row max, over the warps ----
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + warp * KW + n * 8 + 2 * t + (e & 1);
        const float x = key < end ? (s[n][e] + s2[n][e]) * a.scale_log2
                                  : kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (t == 0) red_max[warp * kRows + g + 8 * r] = mx[r];
    }
    __syncthreads();                     // every warp's row max is in

    // ---- p (bf16 into P, its unrounded sum beside it) ----
    float alpha[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m_new = m_run[r];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        m_new = fmaxf(m_new, red_max[w * kRows + g + 8 * r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        p[e] = x > kNegInf / 2 ? exp2f(x - m_run[e >> 1]) : 0.0f;
        psum[e >> 1] += p[e];
      }
      const int col = (warp * KW + n * 8 + 2 * t) / 2;
      pw[g * psw + col] = pack_bf16(p[0], p[1]);
      pw[(g + 8) * psw + col] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      if (t == 0) red_sum[warp * kRows + g + 8 * r] = psum[r];
    }
    cp_async_wait_n(2 * a.stages - 2);
    __syncthreads();                     // P, the row sums and V are in

    // ---- l, and O += P V on the warp's NT * 8 columns ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red_sum[w * kRows + g + 8 * r];
      l_run[r] = l_run[r] * alpha[r] + sum;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      const uint32_t* pa = pw + g * psw + kk * 8 + t;
      const uint32_t af[4] = {pa[0], pa[8 * psw], pa[4], pa[8 * psw + 4]};
      // lanes 0-15: keys kk*16 + 0..15 at columns c..c+7, lanes 16-31
      // the same keys at c+8..c+15
      const bf16* vrow = vt + (kk * 16 + (lane & 15)) * VS +
                         warp * NT * 8 + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vrow + n * 8);
        mma_bf16(acc[n], af, bf);
        mma_bf16(acc[n + 1], af, bf + 2);
      }
    }
  }
  cp_async_wait<0>();

  bf16* ob = a.o + ((size_t)b * a.sq + row0) * a.dv + c0;
  if (a.n_split == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row >= rows) continue;
      const float l = fmaxf(l_run[r], 1e-30f);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = warp * NT * 8 + n * 8 + 2 * t;
        if (col < cols) ob[(size_t)row * a.dv + col] =
            __float2bfloat16(acc[n][2 * r] / l);
        if (col + 1 < cols) ob[(size_t)row * a.dv + col + 1] =
            __float2bfloat16(acc[n][2 * r + 1] / l);
      }
    }
    return;
  }

  // ---- the combine over the cluster's ranges ----
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();                       // the ring is free
  float* part = reinterpret_cast<float*>(ring);   // [kRows][DVP]
  float* ml = part + kRows * DVP;                 // [2][kRows]: m, l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = warp * NT * 8 + n * 8 + 2 * t;
      part[row * DVP + col] = acc[n][2 * r];
      part[row * DVP + col + 1] = acc[n][2 * r + 1];
    }
    if (warp == 0 && t == 0) {
      ml[row] = m_run[r];
      ml[kRows + row] = l_run[r];
    }
  }
  cluster.sync();                        // every range's part is in
  const int rank = static_cast<int>(cluster.block_rank());
  const int total = rows * DVP;
  const int share = (total + a.n_split - 1) / a.n_split;
  const int lo = rank * share, hi = min(total, lo + share);
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const int row = i / DVP, col = i % DVP;
    if (col >= cols) continue;
    // every rank's (m, l, acc) of the element, all loads in flight at once
    float mj[kMaxSplits], lj[kMaxSplits], oj[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      if (j < a.n_split) {
        const float* mlj = cluster.map_shared_rank(ml, j);
        mj[j] = mlj[row];
        lj[j] = mlj[kRows + row];
        oj[j] = cluster.map_shared_rank(part, j)[i];
      }
    }
    float m = kNegInf;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < a.n_split) m = fmaxf(m, mj[j]);
    float l = 0.0f, o = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      if (j < a.n_split) {
        const float w = exp2f(mj[j] - m);
        l += lj[j] * w;
        o += oj[j] * w;
      }
    }
    ob[(size_t)row * a.dv + col] = __float2bfloat16(o / fmaxf(l, 1e-30f));
  }
  cluster.sync();                        // no rank leaves while read
}

template <int KC, int NT>
cudaError_t launch_bf16(const Bf16Args& args, const Plan& p, int B, int sq,
                        cudaStream_t stream) {
  auto kernel = decode_bf16_kernel<KC, NT>;
  if (p.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(p.n_split, cdiv(sq, kRows) * p.strips, B);
  if (p.n_split == 1) {
    kernel<<<grid, kThreads, p.smem, stream>>>(args);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int KC>
cudaError_t launch_bf16_kc(const Bf16Args& args, const Plan& p, int B,
                           int sq, cudaStream_t stream) {
  switch (p.dvp) {
    case 64: return launch_bf16<KC, 2>(args, p, B, sq, stream);
    case 128: return launch_bf16<KC, 4>(args, p, B, sq, stream);
    case 256: return launch_bf16<KC, 8>(args, p, B, sq, stream);
    default: return launch_bf16<KC, 16>(args, p, B, sq, stream);
  }
}

cudaError_t launch_bf16_route(const void* q, const void* k, const void* v,
                              const void* lengths, void* o, int B, int sq,
                              int skv, int d, int dv, float scale,
                              cudaStream_t stream) {
  const Plan p = plan(skv, d, dv, sq);
  if (p.smem > (size_t)kSmemMax)
    return cudaErrorInvalidValue;      // d too wide for one chunk
  Bf16Args args;
  args.q = static_cast<const bf16*>(q);
  args.k = static_cast<const bf16*>(k);
  args.v = static_cast<const bf16*>(v);
  args.lengths = static_cast<const int*>(lengths);
  args.o = static_cast<bf16*>(o);
  args.sq = sq;
  args.skv = skv;
  args.d = d;
  args.dv = dv;
  args.dp = p.dp;
  args.split = p.split;
  args.n_split = p.n_split;
  args.stages = p.stages;
  args.strip = p.strip;
  args.strips = p.strips;
  args.vec = d % 8 == 0 && dv % 8 == 0 &&
             ((reinterpret_cast<uintptr_t>(q) |
               reinterpret_cast<uintptr_t>(k) |
               reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  args.scale_log2 = scale * kLog2e;
  return p.chunk == 64 ? launch_bf16_kc<64>(args, p, B, sq, stream)
                       : launch_bf16_kc<32>(args, p, B, sq, stream);
}

}  // namespace

// q [B, sq, d], k [B, skv, d], v [B, skv, dv], lengths [B] int32, all
// contiguous on the device; o [B, sq, dv], in the operands' type (fp32 or
// bf16).  Returns the launch's cudaError_t (shared memory above 48 KB is
// opted into first; the bf16 route refuses a d whose one chunk does not
// fit a block's shared memory).
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, int B, int sq,
                                int skv, int d, int dv, float scale,
                                void* stream) {
  if (B <= 0 || sq <= 0 || dv <= 0) return 0;
  return static_cast<int>(launch<float>(
      q, k, v, lengths, o, B, sq, skv, d, dv, scale,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_decode_bf16(const void* q, const void* k,
                                 const void* v, const void* lengths, void* o,
                                 int B, int sq, int skv, int d, int dv,
                                 float scale, void* stream) {
  if (B <= 0 || sq <= 0 || dv <= 0) return 0;
  return static_cast<int>(launch_bf16_route(
      q, k, v, lengths, o, B, sq, skv, d, dv, scale,
      static_cast<cudaStream_t>(stream)));
}

// The bf16 route's plan at (skv, d, dv, sq), for the wrapper's logs and
// the tests: out[0..8] = keys a range, ranges, keys a chunk, chunks in
// flight, padded d, padded strip, a strip's columns, strips, shared bytes
// a block.
extern "C" void flash_decode_bf16_plan(int skv, int d, int dv, int sq,
                                       int* out) {
  const Plan p = plan(skv, d, dv, sq);
  out[0] = p.split;
  out[1] = p.n_split;
  out[2] = p.chunk;
  out[3] = p.stages;
  out[4] = p.dp;
  out[5] = p.dvp;
  out[6] = p.strip;
  out[7] = p.strips;
  out[8] = static_cast<int>(p.smem);
}
