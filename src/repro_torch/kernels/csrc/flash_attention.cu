// Prefill flash attention (causal or full) for Hopper's tensor cores:
// fp32 inputs at fp32 accuracy by 3xTF32, bf16 inputs by bf16 MMAs, both
// with fp32 sums.
//
// Replaces: repro/kernels/flash_attention.py, flash_attention /
// _flash_kernel (the Pallas TPU kernel on grid (BH, q blocks, KV
// blocks), KV innermost and sequential).
//
// For each of the BH folded heads: o = softmax(q k^T * scale) v over
// [S, d], by the online-softmax recurrence over KV tiles with running
// (max, sum, acc) per query row.  As in the TPU kernel: KV tiles that lie
// strictly after a causal query block are skipped; key positions at or
// past kv_len are masked whether or not kv_len falls on a tile edge (the
// padded-KV leak the reference fixed); a masked score contributes p = 0,
// not exp(0), and a row with every key masked ends at 0 (l floored at
// 1e-30); with bf16 inputs p is rounded to bf16 before the PV product,
// and the output takes the inputs' dtype.  When the caller wants a
// gradient it passes lse: each row's log-sum-exp of its scaled scores
// ([BH, S] fp32, natural log; +inf for a row with every key masked),
// which flash_attention_bwd.cu reads instead of recomputing the row
// statistics.  Only that store is added: o is the same with or without.
//
// What bounds it on an H100: operations.  At gemma-7b's prefill (16
// heads of 256, S 4096, causal) the launch does 1.37e11 flops on 0.27
// GB.  On FFMA (67 TFLOP/s) that is 2.05 ms; on the tensor cores it is
// 0.83 ms at fp32 accuracy (three TF32 products, 495 TFLOP/s) and 0.14 ms
// in bf16 (989 TFLOP/s).
//
// What the design does about it:
// - Both products, S = Q K^T and O += P V, run on the tensor cores as
//   warp-level mma.sync (m16n8k8 tf32, m16n8k16 bf16).  For fp32 every
//   operand is split at its fragment load, a = hi + lo with
//   hi = tf32(a) and lo = tf32(a - hi), tf32() rounding as cvt.rna.tf32
//   does (to nearest, ties away) but by an integer add and mask, and each
//   product is lo*hi + hi*lo + hi*hi accumulated in fp32 (lo*lo dropped):
//   ~2^-21 relative per product, where one TF32 pass would give ~2^-11.
//   The three products of a pass run over 4 independent tiles, so no MMA
//   waits on the one before it.  Not wgmma: it takes tf32 operands only
//   K-major, and V in P V is MN-major, so it would need a transposed copy
//   of V in shared memory (later work).
// - A block is 8 warps over 128 query rows; each warp owns 16 rows, so a
//   row's max and sum are quad shuffles within the accumulator layout.
//   For P V the tf32 A fragment is taken straight from the S accumulator
//   by permuting the 8 keys of a k step (A's k column t is key 2t, column
//   t+4 is key 2t+1; V's rows are read in the same order); in bf16 the
//   two layouts already agree, and V's B fragments come by
//   ldmatrix.trans.
// - Plan at d = 256, fp32: Q 128 x 260, one K and one V tile of 32 x 260
//   floats, 199,680 bytes of shared memory (rows padded by 4 words, so
//   every fragment load is free of bank conflicts), one block (8 warps)
//   an SM; a thread keeps 128 fp32 output accumulators and 16 scores
//   (ptxas's registers and spills are in PERF.md).  K(t+1) is fetched by
//   cp.async while the warps run softmax and P V on tile t, V(t+1) while
//   they run S on tile t+1: loads overlap the MMAs with one buffer each.
// - Softmax in base 2 (scores scaled by scale * log2(e), exp2f), the
//   running max and sum in registers.
// - Causal: blockIdx runs over the query blocks last-first, so the
//   longest blocks start in the first wave; a warp skips a tile that
//   lies wholly after its rows, and masks only the tiles that straddle
//   its diagonal or kv_len.
// head_dim 1..256 is zero-padded to a multiple of 32 in shared memory;
// ragged S and S_kv are zero-filled by the loads and masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * 16;         // query rows per block
constexpr int kBKV = 32;                 // keys per KV tile
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past src_bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
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

// cvt.rna.tf32.f32 by integer ops on the bits (round to nearest, ties
// away from zero, 10 mantissa bits kept): an add and a mask on the
// integer pipes, where the conversion instruction is not a full-rate one
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

// register-only MMAs are not volatile: the compiler may interleave
// independent ones with the loads around them
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[n] += a*b[n] for N independent tiles at fp32 accuracy: the three TF32
// products, small ones first, each pass over all N tiles, so that no MMA
// waits on the one just before it
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*c)[4], const uint32_t* ahi,
                                           const uint32_t* alo,
                                           const uint32_t (*bhi)[2],
                                           const uint32_t (*blo)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], alo, bhi[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ahi, blo[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ahi, bhi[n]);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------ layout ----

// Shared-memory rows of a tile: DP (head_dim padded to 32) elements of T,
// then 16 bytes of padding, so a row is 4 words past a multiple of 32
// (fp32) or of 8 (bf16) and fragment loads hit distinct banks.
template <typename T, int DP>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);            // elements a chunk
  static constexpr int kStride = DP + kVec;              // elements a row
  static constexpr int kWords = kStride * sizeof(T) / 4;  // words a row
};

// rows [r0, r0 + rows) of a [n_rows, d] matrix into shared memory, zero
// past n_rows and past d.  VEC: 16-byte cp.async (d a multiple of a
// chunk, 16-byte aligned rows); else element loads and stores.
template <typename T, int DP, bool VEC>
__device__ __forceinline__ void stage(T* dst, const T* src, int r0,
                                      int rows, int n_rows, int d) {
  using L = Tile<T, DP>;
  if constexpr (VEC) {
    constexpr int kChunks = DP / L::kVec;
    for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * L::kVec;
      const bool in = r0 + r < n_rows && c < d;
      const T* g = in ? src + (size_t)(r0 + r) * d + c : src;
      cp_async16(dst + r * L::kStride + c, g, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const bool in = r0 + r < n_rows && c < d;
      dst[r * L::kStride + c] =
          in ? src[(size_t)(r0 + r) * d + c] : T(0.0f);
    }
  }
}

// ------------------------------------------------------------ kernel ----

template <typename T, int DP, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int BH, int S, int SK,
                           int d, int kv_len, int causal, float scale) {
  using L = Tile<T, DP>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kNT = DP / 8;            // 8-column tiles of the output
  // scores in base 2: exp(s * scale - m) = exp2(s * scale * log2(e) - m')
  const float scale_log2 = scale * 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);                // [kBQ, stride]
  T* ks = qs + kBQ * L::kStride;                         // [kBKV, stride]
  T* vs = ks + kBKV * L::kStride;                        // [kBKV, stride]
  const uint32_t* qw = reinterpret_cast<const uint32_t*>(qs);
  const uint32_t* kw = reinterpret_cast<const uint32_t*>(ks);

  // last query block first: the longest causal blocks start in wave one
  const int n_qb = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qb - 1 - blockIdx.x / BH) * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;              // the warp's rows in the block
  const int row_lo = q0 + r0;            // its first query position
  const T* qb = q + (size_t)bh * S * d;
  const T* kb = k + (size_t)bh * SK * d;
  const T* vb = v + (size_t)bh * SK * d;

  // keys past the causal block or past kv_len are all masked: skip them
  const int kv_end = min(kv_len, causal ? min(SK, q0 + kBQ) : SK);
  const int n_tiles = (kv_end + kBKV - 1) / kBKV;

  stage<T, DP, VEC>(qs, qb, q0, kBQ, S, d);
  if (n_tiles > 0) stage<T, DP, VEC>(ks, kb, 0, kBKV, SK, d);
  cp_async_commit();
  if (n_tiles > 0) stage<T, DP, VEC>(vs, vb, 0, kBKV, SK, d);
  cp_async_commit();

  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};
  float acc[kNT][4];
#pragma unroll
  for (int c = 0; c < kNT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kBKV;
    const bool more = tile + 1 < n_tiles;
    // a tile wholly after the warp's last row adds nothing to its rows
    const bool active = !causal || kv0 <= row_lo + 15;
    const bool masked = kv0 + kBKV > kv_len ||
                        (causal && kv0 + kBKV - 1 > row_lo);

    cp_async_wait<1>();                  // Q and K(tile) are in
    __syncthreads();

    // ---- S = Q K^T: 16 rows x 32 keys a warp ----
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    if (active) {
      if constexpr (kF32) {
#pragma unroll 2
        for (int kk = 0; kk < DP / 8; ++kk) {
          const float* qa = qs + (r0 + g) * L::kStride + kk * 8 + t;
          uint32_t ahi[4], alo[4];
          split(qa[0], ahi[0], alo[0]);
          split(qa[8 * L::kStride], ahi[1], alo[1]);
          split(qa[4], ahi[2], alo[2]);
          split(qa[8 * L::kStride + 4], ahi[3], alo[3]);
          uint32_t bhi[4][2], blo[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float* kp = ks + (n * 8 + g) * L::kStride + kk * 8 + t;
            split(kp[0], bhi[n][0], blo[n][0]);
            split(kp[4], bhi[n][1], blo[n][1]);
          }
          mma_3xtf32<4>(s, ahi, alo, bhi, blo);
        }
      } else {
#pragma unroll 2
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t* qa = qw + (r0 + g) * L::kWords + kk * 8 + t;
          const uint32_t a[4] = {qa[0], qa[8 * L::kWords], qa[4],
                                 qa[8 * L::kWords + 4]};
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const uint32_t* kp = kw + (n * 8 + g) * L::kWords + kk * 8 + t;
            const uint32_t b[2] = {kp[0], kp[4]};
            mma_bf16(s[n], a, b);
          }
        }
      }
    }
    __syncthreads();                     // every warp is done with K(tile)
    if (more) stage<T, DP, VEC>(ks, kb, kv0 + kBKV, kBKV, SK, d);
    cp_async_commit();

    // ---- online softmax on the warp's rows g and g + 8 ----
    if (active) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (masked) {
            const int key = kv0 + n * 8 + 2 * t + (e & 1);
            const int row = row_lo + g + 8 * (e >> 1);
            if (key >= kv_len || (causal && key > row)) x = kNegInf;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
      }
      float psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[n][e];
          const float p = x > kNegInf / 2 ? exp2f(x - m_run[e >> 1]) : 0.0f;
          s[n][e] = p;
          psum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        l_run[r] = l_run[r] * alpha[r] + psum[r];
      }
#pragma unroll
      for (int c = 0; c < kNT; ++c) {
        acc[c][0] *= alpha[0];
        acc[c][1] *= alpha[0];
        acc[c][2] *= alpha[1];
        acc[c][3] *= alpha[1];
      }
    }

    if (more) cp_async_wait<1>();        // V(tile) is in; K(tile+1) may not be
    else cp_async_wait<0>();
    __syncthreads();

    // ---- O += P V ----
    if (active) {
      if constexpr (kF32) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          // A's column t is key 2t, column t + 4 key 2t + 1
          uint32_t ahi[4], alo[4];
          split(s[n][0], ahi[0], alo[0]);
          split(s[n][2], ahi[1], alo[1]);
          split(s[n][1], ahi[2], alo[2]);
          split(s[n][3], ahi[3], alo[3]);
          const float* vp = vs + (n * 8 + 2 * t) * L::kStride + g;
#pragma unroll
          for (int c = 0; c < kNT; c += 4) {   // 4 column tiles a pass
            uint32_t bhi[4][2], blo[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              split(vp[(c + j) * 8], bhi[j][0], blo[j][0]);
              split(vp[L::kStride + (c + j) * 8], bhi[j][1], blo[j][1]);
            }
            mma_3xtf32<4>(acc + c, ahi, alo, bhi, blo);
          }
        }
      } else {
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {   // 16 keys a k step
          const uint32_t a[4] = {
              pack_bf16(s[2 * kc][0], s[2 * kc][1]),
              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
          // lanes 0-7: keys 0-7, 8-15: keys 8-15 (columns c0..c0+7);
          // lanes 16-31 the same for columns c0+8..c0+15
          const int key = kc * 16 + (lane & 15);
          const T* vrow = vs + key * L::kStride + (lane >> 4) * 8;
#pragma unroll
          for (int c = 0; c < kNT; c += 2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vrow + c * 8);
            mma_bf16(acc[c], a, b);
            mma_bf16(acc[c + 1], a, b + 2);
          }
        }
      }
    }
    __syncthreads();                     // every warp is done with V(tile)
    if (more) stage<T, DP, VEC>(vs, vb, kv0 + kBKV, kBKV, SK, d);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // ---- o = acc / l ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_lo + g + 8 * r;
    if (qi >= S) continue;
    const float inv = 1.0f / fmaxf(l_run[r], 1e-30f);
    if (lse != nullptr && t == 0)        // a quad's lanes hold the same sums
      lse[(size_t)bh * S + qi] =
          l_run[r] > 0.0f ? (m_run[r] + log2f(l_run[r])) * 0.6931471805599453f
                          : __int_as_float(0x7f800000);
    T* orow = o + ((size_t)bh * S + qi) * d;
#pragma unroll
    for (int c = 0; c < kNT; ++c) {
      const int col = c * 8 + 2 * t;
      const float x0 = acc[c][2 * r] * inv, x1 = acc[c][2 * r + 1] * inv;
      if constexpr (kF32) {
        if (col < d) orow[col] = x0;
        if (col + 1 < d) orow[col + 1] = x1;
      } else {
        if (col < d) orow[col] = __float2bfloat16(x0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <typename T, int DP, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int S, int SK, int d, int kv_len,
                   int causal, float scale, cudaStream_t stream) {
  using L = Tile<T, DP>;
  const size_t smem = sizeof(T) * (size_t)(kBQ + 2 * kBKV) * L::kStride;
  auto kernel = flash_attention_kernel<T, DP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = BH * ((S + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, BH, S, SK, d,
      kv_len, causal, scale);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int BH, int S, int SK, int d, int kv_len,
                     int causal, float scale, cudaStream_t s) {
  switch ((d + 31) / 32) {
    case 1: return launch<T, 32, VEC>(q, k, v, o, lse, BH, S, SK, d, kv_len, causal, scale, s);
    case 2: return launch<T, 64, VEC>(q, k, v, o, lse, BH, S, SK, d, kv_len, causal, scale, s);
    case 3: return launch<T, 96, VEC>(q, k, v, o, lse, BH, S, SK, d, kv_len, causal, scale, s);
    case 4: return launch<T, 128, VEC>(q, k, v, o, lse, BH, S, SK, d, kv_len, causal, scale, s);
    case 5:
    case 6: return launch<T, 192, VEC>(q, k, v, o, lse, BH, S, SK, d, kv_len, causal, scale, s);
    case 7:
    case 8: return launch<T, 256, VEC>(q, k, v, o, lse, BH, S, SK, d, kv_len, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_vec(const void* q, const void* k, const void* v,
                         void* o, float* lse, int BH, int S, int SK, int d,
                         int kv_len, int causal, float scale,
                         cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  if (aligned && d % kVec == 0)
    return dispatch<T, true>(q, k, v, o, lse, BH, S, SK, d, kv_len, causal, scale, s);
  return dispatch<T, false>(q, k, v, o, lse, BH, S, SK, d, kv_len, causal, scale, s);
}

}  // namespace

// q [BH, S, d], k and v [BH, SK, d], o [BH, S, d], contiguous on the
// device, fp32 (bf16 = 0) or bf16 (bf16 = 1); lse [BH, S] fp32 or null
// (not written); 1 <= d <= 256 and 0 <= kv_len <= SK.  Returns the
// launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int BH, int S, int SK, int d, int kv_len,
                                   int causal, int bf16, float scale,
                                   void* stream) {
  if (BH <= 0 || S <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch_vec<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse),
                                         BH, S, SK, d, kv_len, causal,
                                         scale, s)
           : dispatch_vec<float>(q, k, v, o, static_cast<float*>(lse), BH, S,
                                 SK, d, kv_len, causal, scale, s);
  return static_cast<int>(err);
}
