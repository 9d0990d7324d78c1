// Batched ragged decode attention for Hopper, fp32 or bf16 operands,
// shaped for latency.
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
// type.  A 16-byte cp.async carries 4 fp32 or 8 bf16 elements; the fp32
// instance does the same operations in the same order as the kernel
// before the bf16 route was added (chip_smoke.py holds it bit-equal).
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
  __device__ static float get(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 put(float x) { return __float2bfloat16(x); }
  __device__ static float round(float p) {
    return __bfloat162float(__float2bfloat16(p));
  }
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
__device__ __forceinline__ float dot16(const __nv_bfloat16* a,
                                       const __nv_bfloat16* b, float s) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(xp[i]), w = __bfloat1622float2(yp[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
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

}  // namespace

// q [B, sq, d], k [B, skv, d], v [B, skv, dv], lengths [B] int32, all
// contiguous on the device; o [B, sq, dv], in the operands' type (fp32 or
// bf16).  Returns the launch's cudaError_t (shared memory above 48 KB is
// opted into first).
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
  return static_cast<int>(launch<__nv_bfloat16>(
      q, k, v, lengths, o, B, sq, skv, d, dv, scale,
      static_cast<cudaStream_t>(stream)));
}
