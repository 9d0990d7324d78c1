// The backward of prefill flash attention (causal or full) for Hopper's
// tensor cores: fp32 inputs at fp32 accuracy by 3xTF32, bf16 inputs by
// bf16 MMAs, every sum in fp32.
//
// Replaces: the gradient of repro/kernels/flash_attention.py's
// flash_attention.  The TPU kernel has no backward of its own: the JAX
// package differentiates the plain attention of its train path
// (repro/models/attention.py, _attend_full) by XLA autodiff.  This
// computes the same gradients from the forward's saved output o and
// log-sum-exp lse (flash_attention.cu writes lse when a gradient is
// wanted):
//
//   P  = exp(S * scale - lse)      on the kept (query, key) pairs, else 0
//   D  = rowsum(dO * O)
//   dV = P^T dO                    dP = dO V^T
//   dS = P * (dP - D)
//   dQ = dS K * scale              dK = dS^T Q * scale
//
// Masking is the forward's: keys at or past kv_len, and with causal keys
// after the query; a masked pair has P = 0 (never exp of a sentinel), so a
// row with every key masked (lse = +inf) gives zero gradients, not NaN.
//
// Two launches on the caller's stream, each sum in one block in a fixed
// order (no atomics, so two runs give the same bits):
//   dq_kernel   a block per (head, 64 query rows): D from dO and O (kept
//               in a [BH, S] scratch for the second launch), then the key
//               tiles up to the causal edge, dQ in registers;
//   dkv_kernel  a block per (head, 64 keys): the query tiles from the
//               causal edge down, dK and dV in registers.
// Each recomputes S and dP for its pairs: seven products in all.
//
// What bounds it on an H100: operations.  At zamba2-1.2b's shared
// attention in training (64 heads of 64, S 1024, causal) the five
// products are 2.15e10 flops, 0.022 ms on the bf16 tensor cores at their
// peak; the kernel does seven (S and dP in both launches), three of them
// twice in bf16 (P and dS as hi + lo, below): 4.3e10 flops, 0.043 ms.
//
// What the design does about it:
// - Every product is a warp-level mma.sync on the tensor cores (bf16
//   m16n8k16; for fp32 m16n8k8 tf32, each operand split hi + lo and three
//   products lo*hi + hi*lo + hi*hi, as flash_attention.cu does).  A warp
//   owns 16 rows of the block (queries in dq_kernel, keys in dkv_kernel)
//   and computes S and dP for them against a whole tile (S^T and dP^T in
//   dkv_kernel, K Q^T and V dO^T, so that P^T and dS^T come out in the
//   accumulator layout).  P and dS are formed in registers in fp32 and
//   enter the next product as the A operand straight from the
//   accumulators.  In bf16 each goes in as a bf16 pair hi + lo (two MMAs):
//   one rounding to bf16 would put a 2^-9 error on every term of dV, dQ
//   and dK; the pair leaves ~2^-17.  q, k, v and dO are exact bf16
//   operands, so S and dP are exact products in fp32 sums.
// - bf16 fragments come from shared memory by ldmatrix (.trans for the
//   B operand of P^T dO, dS K and dS^T Q, whose rows are the sum's
//   index); fp32 ones by word loads.  Rows are padded by 16 bytes, so
//   neither hits a bank twice.
// - The block's own rows (Q and dO, or K and V) stay in shared memory;
//   the tiles it walks (K and V, or Q and dO, 64 rows, 32 past d 64) are
//   staged by cp.async in two buffers, the next tile loading while the
//   warps multiply the current one (one buffer for fp32 at d 256, where
//   two do not fit in 227 KB).
// - The output columns a block sums are at most 128 (registers: a thread
//   holds dK and dV, 16 x 128 each, as 128 floats); at d 192 and 256 two
//   blocks share a row block, one half of the columns each, and each
//   recomputes S and dP.
// - Causal: blockIdx runs over the longest blocks first (the last query
//   blocks, the first key blocks); a warp skips a tile that lies wholly
//   on the masked side of its rows, and masks only the tiles that
//   straddle the diagonal or kv_len.
// head_dim 1..256 is zero-padded to a multiple of 32 in shared memory;
// ragged S and S_kv are zero-filled by the loads and masked.
//
// What limits it now (H100 80GB HBM3, 700 W; PERF.md): at the shape above
// 0.255-0.257 ms in bf16, ~170 TFLOP/s counted as its ten products, 2.1x
// cuDNN's backward; 0.73-0.75 ms in fp32.  Neither launch is bound by the tensor
// cores, shared memory's bandwidth or occupancy: blocks of 2 or 8 warps,
// walked tiles of 32 rows, a 128-register cap and the largest shared
// carveout all ran as fast or slower.  A warp's tile is a chain (S, then
// P, dP, dS, then the sums), which mma.sync leaves the warp to wait out;
// wgmma with TMA-fed, warp-specialised stages is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBR = kWarps * 16;         // rows a block owns
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kSmemLimit = 232448;    // 227 KB, a block's most

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
// 4 bytes global -> shared; zero-filled when src_bytes is 0
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

// cvt.rna.tf32.f32 by integer ops on the bits (round to nearest, ties
// away from zero, 10 mantissa bits kept)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, both TF32
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[n] += a*b[n] for N independent tiles at fp32 accuracy: the three TF32
// products, small ones first, each pass over all N tiles
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// (x0, x1) = hi + lo, each a packed pair of bf16: hi rounds x, lo rounds
// what hi leaves
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// two adjacent outputs of a row
__device__ __forceinline__ void store2(float* p, float x0, float x1,
                                       bool both) {
  p[0] = x0;
  if (both) p[1] = x1;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1,
                                       bool both) {
  p[0] = __float2bfloat16(x0);
  if (both) p[1] = __float2bfloat16(x1);
}

// ------------------------------------------------------------ layout ----

// Shared-memory rows of a tile: DP (head_dim padded to 32) elements of T,
// then 16 bytes, so a row is 4 words past a multiple of 32 (fp32) or of 8
// (bf16).  DC: the output columns a block sums (at most 128); BN: the rows
// of a walked tile; kStages: its buffers (two where they fit).
template <typename T, int DP>
struct Cfg {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kStride = DP + kVec;
  static constexpr int kDC = DP <= 128 ? DP : DP / 2;
  static constexpr int kSplit = DP / kDC;
  static constexpr int kBN = kDC <= 64 ? 64 : 32;
  // the block's rows (two tiles) and dq_kernel's D of them; a stage: the
  // walked tiles (two) and dkv_kernel's lse and D of their rows
  static constexpr size_t kFixed =
      sizeof(T) * kStride * 2 * kBR + sizeof(float) * kBR;
  static constexpr size_t kPerStage =
      sizeof(T) * kStride * 2 * kBN + sizeof(float) * 2 * kBN;
  static constexpr int kStages = kFixed + 2 * kPerStage <= kSmemLimit ? 2 : 1;
  static constexpr size_t kSmem = kFixed + kStages * kPerStage;
};

// rows [r0, r0 + rows) of a [n_rows, d] matrix into shared memory, zero
// past n_rows and past d: 16-byte cp.async when vec (d a multiple of a
// chunk, 16-byte aligned rows), else element loads and stores
template <typename T, int DP>
__device__ __forceinline__ void stage(T* dst, const T* src, int r0,
                                      int rows, int n_rows, int d,
                                      bool vec) {
  using C = Cfg<T, DP>;
  if (vec) {
    constexpr int kChunks = DP / C::kVec;
    for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * C::kVec;
      const bool in = r0 + r < n_rows && c < d;
      const T* g = in ? src + (size_t)(r0 + r) * d + c : src;
      cp_async16(dst + r * C::kStride + c, g, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const bool in = r0 + r < n_rows && c < d;
      dst[r * C::kStride + c] =
          in ? src[(size_t)(r0 + r) * d + c] : T(0.0f);
    }
  }
}

// ---------------------------------------------------------- products ----

// c[n] = A B^T over DP columns for a warp's 16 rows of A (a: its first
// row) against the NB rows of B, c in the accumulator layout (n-tile n:
// B's rows 8n .. 8n + 7)
template <typename T, int DP, int NB>
__device__ __forceinline__ void nt_product(float (*c)[4], const T* a,
                                           const T* b, int lane) {
  constexpr int S = Cfg<T, DP>::kStride;
#pragma unroll
  for (int n = 0; n < NB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.0f;
  if constexpr (sizeof(T) == 4) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll 2
    for (int kk = 0; kk < DP / 8; ++kk) {
      const float* ap = a + g * S + kk * 8 + t;
      uint32_t ahi[4], alo[4];
      split(ap[0], ahi[0], alo[0]);
      split(ap[8 * S], ahi[1], alo[1]);
      split(ap[4], ahi[2], alo[2]);
      split(ap[8 * S + 4], ahi[3], alo[3]);
#pragma unroll
      for (int n0 = 0; n0 < NB / 8; n0 += 4) {
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* bp = b + ((n0 + j) * 8 + g) * S + kk * 8 + t;
          split(bp[0], bhi[j][0], blo[j][0]);
          split(bp[4], bhi[j][1], blo[j][1]);
        }
        mma_3xtf32<4>(c + n0, ahi, alo, bhi, blo);
      }
    }
  } else {
    // A: lanes 0-15 rows 0-15 at column 0, lanes 16-31 at column 8;
    // B: lanes 0-7 rows 0-7 at column 0, 8-15 at 8, 16-31 rows 8-15
    const T* ap = a + (lane & 15) * S + (lane >> 4) * 8;
    const T* bp = b + ((lane & 7) + ((lane >> 4) << 3)) * S +
                  ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, ap + kk * 16);
#pragma unroll
      for (int n = 0; n < NB / 8; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, bp + n * 8 * S + kk * 16);
        mma_bf16(c[n], af, bf);
        mma_bf16(c[n + 1], af, bf + 2);
      }
    }
  }
}

// acc[c] += P B over the NB rows of B (b: its first row, at the block's
// first output column): P a warp's 16 x NB operand in the accumulator
// layout (n-tile n: B's rows 8n .. 8n + 7), acc DC columns wide
template <typename T, int DP, int NB>
__device__ __forceinline__ void nn_product(float (*acc)[4],
                                           const float (*p)[4], const T* b,
                                           int lane) {
  constexpr int S = Cfg<T, DP>::kStride;
  constexpr int DC = Cfg<T, DP>::kDC;
  if constexpr (sizeof(T) == 4) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int n = 0; n < NB / 8; ++n) {
      // A's column t is B's row 2t, column t + 4 row 2t + 1
      uint32_t ahi[4], alo[4];
      split(p[n][0], ahi[0], alo[0]);
      split(p[n][2], ahi[1], alo[1]);
      split(p[n][1], ahi[2], alo[2]);
      split(p[n][3], ahi[3], alo[3]);
      const float* bp = b + (n * 8 + 2 * t) * S + g;
#pragma unroll
      for (int c = 0; c < DC / 8; c += 4) {
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split(bp[(c + j) * 8], bhi[j][0], blo[j][0]);
          split(bp[S + (c + j) * 8], bhi[j][1], blo[j][1]);
        }
        mma_3xtf32<4>(acc + c, ahi, alo, bhi, blo);
      }
    }
  } else {
    // lanes 0-15: B's rows 0-15 at column c0, lanes 16-31 at c0 + 8
    const T* bp = b + (lane & 15) * S + (lane >> 4) * 8;
#pragma unroll
    for (int kc = 0; kc < NB / 16; ++kc) {
      uint32_t hi[4], lo[4];
      split_bf16(p[2 * kc][0], p[2 * kc][1], hi[0], lo[0]);
      split_bf16(p[2 * kc][2], p[2 * kc][3], hi[1], lo[1]);
      split_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1], hi[2], lo[2]);
      split_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int c = 0; c < DC / 8; c += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, bp + kc * 16 * S + c * 8);
        mma_bf16(acc[c], lo, bf);
        mma_bf16(acc[c + 1], lo, bf + 2);
        mma_bf16(acc[c], hi, bf);
        mma_bf16(acc[c + 1], hi, bf + 2);
      }
    }
  }
}

// a warp's DC-column accumulators times mul into rows row0 (g) and row0 + 8
// of a [n_rows, d] output, columns col0 ..
template <typename T, int DC>
__device__ __forceinline__ void store_rows(T* out, const float (*acc)[4],
                                           float mul, int row0, int n_rows,
                                           int col0, int d, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < DC / 8; ++c) {
      const int col = col0 + c * 8 + 2 * t;
      if (col < d)
        store2(out + (size_t)row * d + col, acc[c][2 * r] * mul,
               acc[c][2 * r + 1] * mul, col + 1 < d);
    }
  }
}

// ------------------------------------------------------- dQ (and D) ----

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const float* __restrict__ lse, const T* __restrict__ dout,
              T* __restrict__ dq, float* __restrict__ dsum, int BH, int S,
              int SK, int d, int kv_len, int causal, float scale,
              int vec) {
  using C = Cfg<T, DP>;
  constexpr int ST = C::kStride, BN = C::kBN, DC = C::kDC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);              // [kBR, ST]
  T* dos = qs + kBR * ST;                              // [kBR, ST]
  T* kvs = dos + kBR * ST;                  // [stages][K, V][BN, ST]
  float* dd = reinterpret_cast<float*>(kvs + C::kStages * 2 * BN * ST);

  // the last query block first: the longest causal blocks start first
  const int n_qb = (S + kBR - 1) / kBR;
  const int q0 = (n_qb - 1 - (int)blockIdx.x / (BH * C::kSplit)) * kBR;
  const int bh = ((int)blockIdx.x / C::kSplit) % BH;
  const int col0 = ((int)blockIdx.x % C::kSplit) * DC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16, row_lo = q0 + r0;
  const size_t qoff = (size_t)bh * S * d, koff = (size_t)bh * SK * d;
  const T* kb = k + koff;
  const T* vb = v + koff;

  const int kv_end = min(kv_len, causal ? min(SK, q0 + kBR) : SK);
  const int n_tiles = (kv_end + BN - 1) / BN;

  stage<T, DP>(qs, q + qoff, q0, kBR, S, d, vec);
  stage<T, DP>(dos, dout + qoff, q0, kBR, S, d, vec);
  if (n_tiles > 0) {
    stage<T, DP>(kvs, kb, 0, BN, SK, d, vec);
    stage<T, DP>(kvs + BN * ST, vb, 0, BN, SK, d, vec);
  }
  cp_async_commit();

  // D = rowsum(dO * O) of the warp's 16 rows, two lanes a row (even and
  // odd columns, then one shuffle): the same order in every run; the
  // loop unrolled whole, so that its loads are all in flight at once
  {
    const int r = r0 + lane / 2, row = q0 + r;
    float acc = 0.0f;
    if (row < S) {
      const T* dr = dout + qoff + (size_t)row * d;
      const T* orow = o + qoff + (size_t)row * d;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) {
        const int c = 2 * i + (lane & 1);
        if (c < d) acc = fmaf(to_f32(dr[c]), to_f32(orow[c]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0) {
      dd[r] = acc;
      if (row < S && col0 == 0) dsum[(size_t)bh * S + row] = acc;
    }
  }
  __syncwarp();
  float l2[2], dl[2];                    // rows g and g + 8: lse (base 2), D
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + g + 8 * r;
    l2[r] = row < S ? lse[(size_t)bh * S + row] * kLog2e
                    : __int_as_float(0x7f800000);
    dl[r] = dd[r0 + g + 8 * r];
  }

  float acc[DC / 8][4];
#pragma unroll
  for (int c = 0; c < DC / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;

  const float scale_log2 = scale * kLog2e;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = C::kStages == 2 ? tile & 1 : 0;
    if constexpr (C::kStages == 2) {
      if (tile + 1 < n_tiles) {
        T* nk = kvs + (buf ^ 1) * 2 * BN * ST;
        stage<T, DP>(nk, kb, (tile + 1) * BN, BN, SK, d, vec);
        stage<T, DP>(nk + BN * ST, vb, (tile + 1) * BN, BN, SK, d, vec);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int kv0 = tile * BN;
    // a tile wholly after the warp's last row adds nothing to its rows
    const bool active = !causal || kv0 <= row_lo + 15;
    const bool masked = kv0 + BN > kv_len ||
                        (causal && kv0 + BN - 1 > row_lo);
    if (active) {
      const T* kt = kvs + buf * 2 * BN * ST;
      const T* vt = kt + BN * ST;
      float s[BN / 8][4], dp[BN / 8][4];
      nt_product<T, DP, BN>(s, qs + r0 * ST, kt, lane);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool keep = true;
          if (masked) {
            const int key = kv0 + n * 8 + 2 * t + (e & 1);
            const int row = row_lo + g + 8 * (e >> 1);
            keep = key < kv_len && (!causal || key <= row);
          }
          s[n][e] = keep ? exp2f(fmaf(s[n][e], scale_log2, -l2[e >> 1]))
                         : 0.0f;
        }
      nt_product<T, DP, BN>(dp, dos + r0 * ST, vt, lane);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = s[n][e] * (dp[n][e] - dl[e >> 1]);     // dS
      nn_product<T, DP, BN>(acc, s, kt + col0, lane);
    }
    __syncthreads();                     // every warp is done with the tile
    if constexpr (C::kStages == 1) {
      if (tile + 1 < n_tiles) {
        stage<T, DP>(kvs, kb, (tile + 1) * BN, BN, SK, d, vec);
        stage<T, DP>(kvs + BN * ST, vb, (tile + 1) * BN, BN, SK, d, vec);
      }
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  store_rows<T, DC>(dq + qoff, acc, scale, row_lo, S, col0, d, lane);
}

// ------------------------------------------------------------ dK, dV ----

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ lse,
               const T* __restrict__ dout, const float* __restrict__ dsum,
               T* __restrict__ dk, T* __restrict__ dv, int BH, int S, int SK,
               int d, int kv_len, int causal, float scale, int vec) {
  using C = Cfg<T, DP>;
  constexpr int ST = C::kStride, BN = C::kBN, DC = C::kDC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);              // [kBR, ST]
  T* vs = ks + kBR * ST;                               // [kBR, ST]
  T* qds = vs + kBR * ST;                  // [stages][Q, dO][BN, ST]
  float* lds = reinterpret_cast<float*>(qds + C::kStages * 2 * BN * ST);
                                           // [stages][lse, D][BN]

  // the first key block first: the longest causal blocks start first
  const int k0 = ((int)blockIdx.x / (BH * C::kSplit)) * kBR;
  const int bh = ((int)blockIdx.x / C::kSplit) % BH;
  const int col0 = ((int)blockIdx.x % C::kSplit) * DC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16, key_lo = k0 + r0;
  const size_t qoff = (size_t)bh * S * d, koff = (size_t)bh * SK * d;
  const T* qb = q + qoff;
  const T* db = dout + qoff;

  float gk[DC / 8][4], gv[DC / 8][4];
#pragma unroll
  for (int c = 0; c < DC / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[c][e] = gv[c][e] = 0.0f;

  // keys at or past kv_len have every pair masked: zeros
  if (k0 < kv_len) {
    // a causal key block meets no query row before its first key
    const int q_start = causal ? (k0 / BN) * BN : 0;
    const int n_tiles = S > q_start ? (S - q_start + BN - 1) / BN : 0;
    // the lse and D of a tile's rows (0 past S, where every pair is
    // masked), by cp.async with the tile
    auto stage_rows = [&](int buf, int qt0) {
      if (threadIdx.x < BN) {
        const int row = qt0 + threadIdx.x;
        const int bytes = row < S ? 4 : 0;
        const size_t at = (size_t)bh * S + (row < S ? row : 0);
        float* l = lds + buf * 2 * BN;
        cp_async4(l + threadIdx.x, lse + at, bytes);
        cp_async4(l + BN + threadIdx.x, dsum + at, bytes);
      }
    };
    stage<T, DP>(ks, k + koff, k0, kBR, SK, d, vec);
    stage<T, DP>(vs, v + koff, k0, kBR, SK, d, vec);
    if (n_tiles > 0) {
      stage<T, DP>(qds, qb, q_start, BN, S, d, vec);
      stage<T, DP>(qds + BN * ST, db, q_start, BN, S, d, vec);
      stage_rows(0, q_start);
    }
    cp_async_commit();

    const float scale_log2 = scale * kLog2e;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int buf = C::kStages == 2 ? tile & 1 : 0;
      const int qt0 = q_start + tile * BN;
      if constexpr (C::kStages == 2) {
        if (tile + 1 < n_tiles) {
          T* nq = qds + (buf ^ 1) * 2 * BN * ST;
          stage<T, DP>(nq, qb, qt0 + BN, BN, S, d, vec);
          stage<T, DP>(nq + BN * ST, db, qt0 + BN, BN, S, d, vec);
          stage_rows(buf ^ 1, qt0 + BN);
        }
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      // a tile wholly before the warp's first key adds nothing to its keys
      const bool active = !causal || qt0 + BN - 1 >= key_lo;
      const bool masked = key_lo + 16 > kv_len || qt0 + BN > S ||
                          (causal && qt0 < key_lo + 15);
      if (active) {
        const T* qt = qds + buf * 2 * BN * ST;
        const T* dt = qt + BN * ST;
        const float* ls = lds + buf * 2 * BN;
        const float* dl = ls + BN;
        // P^T and dS^T: the warp's 16 keys (rows) x the tile's queries
        float st[BN / 8][4], dpt[BN / 8][4];
        nt_product<T, DP, BN>(st, ks + r0 * ST, qt, lane);
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n * 8 + 2 * t + (e & 1);
            bool keep = true;
            if (masked) {
              const int key = key_lo + g + 8 * (e >> 1);
              const int row = qt0 + col;
              keep = key < kv_len && row < S && (!causal || key <= row);
            }
            const float l2 = ls[col] * kLog2e;
            st[n][e] = keep ? exp2f(fmaf(st[n][e], scale_log2, -l2)) : 0.0f;
          }
        nn_product<T, DP, BN>(gv, st, dt + col0, lane);       // dV += P^T dO
        nt_product<T, DP, BN>(dpt, vs + r0 * ST, dt, lane);
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[n][e] = st[n][e] * (dpt[n][e] - dl[n * 8 + 2 * t + (e & 1)]);
        nn_product<T, DP, BN>(gk, st, qt + col0, lane);       // dK += dS^T Q
      }
      __syncthreads();                   // every warp is done with the tile
      if constexpr (C::kStages == 1) {
        if (tile + 1 < n_tiles) {
          stage<T, DP>(qds, qb, qt0 + BN, BN, S, d, vec);
          stage<T, DP>(qds + BN * ST, db, qt0 + BN, BN, S, d, vec);
          stage_rows(0, qt0 + BN);
        }
        cp_async_commit();
      }
    }
    cp_async_wait<0>();
  }
  store_rows<T, DC>(dk + koff, gk, scale, key_lo, SK, col0, d, lane);
  store_rows<T, DC>(dv + koff, gv, 1.0f, key_lo, SK, col0, d, lane);
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* dsum, int BH, int S,
                   int SK, int d, int kv_len, int causal, float scale,
                   int vec, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  static_assert(C::kSmem <= kSmemLimit, "tiles exceed shared memory");
  auto kq = dq_kernel<T, DP>;
  auto kkv = dkv_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  kq<<<BH * ((S + kBR - 1) / kBR) * C::kSplit, kThreads, C::kSmem, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), lse, dot, static_cast<T*>(dq),
      dsum, BH, S, SK, d, kv_len, causal, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (SK > 0)
    kkv<<<BH * ((SK + kBR - 1) / kBR) * C::kSplit, kThreads, C::kSmem,
          stream>>>(qt, kt, vt, lse, dot, dsum, static_cast<T*>(dk),
                    static_cast<T*>(dv), BH, S, SK, d, kv_len, causal, scale,
                    vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const float* lse, const void* dout,
                     void* dq, void* dk, void* dv, float* dsum, int BH, int S,
                     int SK, int d, int kv_len, int causal, float scale,
                     cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  const int vec = aligned && d % kVec == 0;
#define FA_BWD_LAUNCH(DP)                                                    \
  return launch<T, DP>(q, k, v, o, lse, dout, dq, dk, dv, dsum, BH, S, SK, d, \
                       kv_len, causal, scale, vec, s)
  switch ((d + 31) / 32) {
    case 1: FA_BWD_LAUNCH(32);
    case 2: FA_BWD_LAUNCH(64);
    case 3: FA_BWD_LAUNCH(96);
    case 4: FA_BWD_LAUNCH(128);
    case 5:
    case 6: FA_BWD_LAUNCH(192);
    case 7:
    case 8: FA_BWD_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef FA_BWD_LAUNCH
}

}  // namespace

// q, o, dout, dq [BH, S, d], k, v, dk, dv [BH, SK, d], contiguous on the
// device, all fp32 (bf16 = 0) or all bf16 (bf16 = 1); lse [BH, S] fp32
// (the forward's, natural log) and dsum [BH, S] fp32 scratch (D, written
// by the first launch, read by the second); 1 <= d <= 256 and
// 0 <= kv_len <= SK.  Returns the launches' cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* dsum,
                                   int BH, int S, int SK, int d, int kv_len,
                                   int causal, int bf16, float scale,
                                   void* stream) {
  if (BH <= 0 || S <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, l, dout, dq, dk, dv, ds, BH,
                                     S, SK, d, kv_len, causal, scale, s)
           : dispatch<float>(q, k, v, o, l, dout, dq, dk, dv, ds, BH, S, SK,
                             d, kv_len, causal, scale, s);
  return static_cast<int>(err);
}
