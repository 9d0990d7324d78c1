// Block-fused batched decode attention + output projection for Hopper, fp32.
//
// Replaces: repro/kernels/flash_attention.py, flash_decode_proj /
// _decode_proj_kernel (the Pallas TPU kernel that folds the output
// projection Wo into batched decode attention's last KV step).
//
// For request b with context ctx_b = softmax(q_b k_b[:len_b]^T * scale)
// v_b[:len_b] ([sq, dv], by the online-softmax recurrence of
// flash_decode.cu, masked scores contributing p = 0), the runtime's adapt
// head-merge ravels ctx_b row-major, cycles it to m_out * k_out elements
// and refolds it to h_b [m_out, k_out]; out[b] = h_b @ wo, with wo
// [k_out, n_out] shared by every request.
//
// What bounds it on an H100: wo.  At the main path's shapes (gemma-7b,
// 4 requests, skv 16, head_dim 256, wo 4096 x 3072) wo is 50.3 MB of
// fp32 and everything else ~0.2 MB, so the bytes of wo bound the launch
// (~0.015 ms at 3.35 TB/s).
//
// What the design does about it: the TPU kernel runs one grid step per
// request and pins wo in VMEM; here one block per request would stream
// wo once per request (4 x 50 MB against a 50 MB L2).  Instead the grid
// runs over column strips of wo (32 columns a block where n_out allows
// float4 loads), and every block recomputes the few tiny contexts
// itself -- cheap at skv 16, and ~0.1 MB of K/V per block from L2 -- so
// each wo element is read from HBM once for the whole batch.  The
// contexts stay in shared memory (requests are taken in groups that fit
// it, the wrapper picks the group); the adapt is an index map
// h_b[i][c] = ctx_b[(i * k_out + c) mod (sq * dv)] applied while a chunk
// of h is staged, so the adapted rows are never materialised.  The
// projection is nest_gemm.cu's scheme: 64 K groups per block each
// summing k = g, g + 64, ... in ascending order, a fixed shuffle tree and
// the 8 warps in order, so each output's K order depends on k_out alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockKV = 16;
constexpr int kGroups = 64;                      // K groups per block
constexpr int kColThreads = 4;                   // threads across columns
constexpr int kRows = 8;                         // h rows per projection pass
constexpr float kNegInf = -1e30f;

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

// The normalised context of request b, [sq, dv], into ctx (shared).
// qs/ks/vs/ps/stats are shared scratch; ends with a barrier.
__device__ void decode_context(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v, int len, int b,
                               int sq, int skv, int d, int dv, float scale,
                               float* qs, float* ks, float* vs, float* ps,
                               float* stats, float* ctx) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float* m_run = stats;
  float* l_run = stats + sq;
  float* alpha = stats + 2 * sq;
  const float* qb = q + (size_t)b * sq * d;
  const float* kb = k + (size_t)b * skv * d;
  const float* vb = v + (size_t)b * skv * dv;

  __syncthreads();                      // scratch free from the last call
  for (int i = tid; i < sq * d; i += kThreads) qs[i] = qb[i];
  for (int i = tid; i < sq * dv; i += kThreads) ctx[i] = 0.0f;
  for (int i = tid; i < sq; i += kThreads) {
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
  }
  for (int kv0 = 0; kv0 < skv; kv0 += kBlockKV) {
    __syncthreads();
    for (int i = tid; i < kBlockKV * d; i += kThreads)
      ks[i] = kv0 + i / d < skv ? kb[(size_t)kv0 * d + i] : 0.0f;
    for (int i = tid; i < kBlockKV * dv; i += kThreads)
      vs[i] = kv0 + i / dv < skv ? vb[(size_t)kv0 * dv + i] : 0.0f;
    __syncthreads();
    for (int p = warp; p < sq * kBlockKV; p += kWarps) {
      const int i = p / kBlockKV, j = p % kBlockKV;
      float s = 0.0f;
      for (int c = lane; c < d; c += 32) s = fmaf(qs[i * d + c], ks[j * d + c], s);
      s = warp_sum(s) * scale;
      if (lane == 0) ps[p] = (kv0 + j < len) ? s : kNegInf;
    }
    __syncthreads();
    for (int i = warp; i < sq; i += kWarps) {
      const float s = lane < kBlockKV ? ps[i * kBlockKV + lane] : kNegInf;
      const float m_prev = m_run[i];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = (lane < kBlockKV && s > kNegInf / 2) ? expf(s - m_new)
                                                           : 0.0f;
      const float psum = warp_sum(p);
      if (lane < kBlockKV) ps[i * kBlockKV + lane] = p;
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[i] = a;
        l_run[i] = l_run[i] * a + psum;
        m_run[i] = m_new;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < sq * dv; idx += kThreads) {
      const int i = idx / dv, c = idx % dv;
      float pv = 0.0f;
#pragma unroll
      for (int j = 0; j < kBlockKV; ++j)
        pv = fmaf(ps[i * kBlockKV + j], vs[j * dv + c], pv);
      ctx[idx] = ctx[idx] * alpha[i] + pv;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < sq * dv; idx += kThreads)
    ctx[idx] = ctx[idx] / fmaxf(l_run[idx / dv], 1e-30f);
  __syncthreads();
}

// SUB consecutive columns of row c from column n0 (zero past the edges)
template <int SUB>
__device__ __forceinline__ void load_w(const float* __restrict__ w, int c,
                                       int n0, int K, int N, float* out) {
  if (SUB == 4) {
    if (c < K && n0 < N) {
      const float4 t =
          __ldg(reinterpret_cast<const float4*>(w + (size_t)c * N + n0));
      out[0] = t.x;
      out[1] = t.y;
      out[2] = t.z;
      out[3] = t.w;
    } else {
      out[0] = out[1] = out[2] = out[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < SUB; ++e)
      out[e] = (c < K && n0 + e < N) ? __ldg(w + (size_t)c * N + n0 + e)
                                     : 0.0f;
  }
}

// VEC columns per thread, as in nest_gemm.cu
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    decode_proj_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ lengths,
                       const float* __restrict__ wo, float* __restrict__ o,
                       int B, int sq, int skv, int d, int dv, int m_out,
                       int k_out, int n_out, int group, float scale) {
  constexpr int SUB = VEC >= 4 ? 4 : 1;
  constexpr int kLoads = VEC / SUB;
  constexpr int kStride = kColThreads * SUB;     // columns between loads
  constexpr int kCols = kColThreads * VEC;       // columns of one block
  constexpr int kUnroll = 8 / kLoads;            // 8 loads in flight
  constexpr int kChunk = kGroups * kUnroll;      // k per staged h chunk
  __shared__ float xs[kRows][kChunk];
  __shared__ float red[kWarps][kRows][kCols];
  extern __shared__ float smem[];
  float* qs = smem;                              // [sq, d]
  float* ks = qs + sq * d;                       // [kBlockKV, d]
  float* vs = ks + kBlockKV * d;                 // [kBlockKV, dv]
  float* ps = vs + kBlockKV * dv;                // [sq, kBlockKV]
  float* stats = ps + sq * kBlockKV;             // [3, sq]
  float* ctx = stats + 3 * sq;                   // [group, sq * dv]

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int tc = tid % kColThreads;
  const int g = tid / kColThreads;
  const int col0 = blockIdx.x * kCols;
  const int S = sq * dv;                         // one context, raveled

  for (int b0 = 0; b0 < B; b0 += group) {
    const int nb = min(group, B - b0);
    for (int r = 0; r < nb; ++r)
      decode_context(q, k, v, lengths[b0 + r], b0 + r, sq, skv, d, dv,
                     scale, qs, ks, vs, ps, stats, ctx + (size_t)r * S);
    const int rows = nb * m_out;
    for (int r0 = 0; r0 < rows; r0 += kRows) {
      float acc[kRows][VEC];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = 0.0f;

      for (int kc = 0; kc < k_out; kc += kChunk) {
        float wv[kUnroll][VEC];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int j = 0; j < kLoads; ++j)
            load_w<SUB>(wo, kc + g + u * kGroups,
                        col0 + j * kStride + tc * SUB, k_out, n_out,
                        &wv[u][j * SUB]);
        // stage h[r0 .. r0 + kRows)[kc .. kc + kChunk) through the adapt
        // index map
        for (int i = tid; i < kRows * kChunk; i += kThreads) {
          const int r = i / kChunk, c = i % kChunk;
          const int row = r0 + r, col = kc + c;
          float hv = 0.0f;
          if (row < rows && col < k_out) {
            const int req = row / m_out, hi = row % m_out;
            const long long f = ((long long)hi * k_out + col) % S;
            hv = ctx[(size_t)req * S + f];
          }
          xs[r][c] = hv;
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float xv = xs[r][g + u * kGroups];
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[r][e] = fmaf(xv, wv[u][e], acc[r][e]);
          }
        }
        __syncthreads();
      }

      // the warp's 8 K groups (lanes tc, tc+4, ..., tc+28) by a fixed tree
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float s = acc[r][e];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          if (lane < kColThreads)
            red[warp][r][(e / SUB) * kStride + tc * SUB + e % SUB] = s;
        }
      __syncthreads();
      for (int i = tid; i < kRows * kCols; i += kThreads) {
        const int r = i / kCols, c = i % kCols;
        const int row = r0 + r, n = col0 + c;
        if (row >= rows || n >= n_out) continue;
        float s = red[0][r][c];
#pragma unroll
        for (int ww = 1; ww < kWarps; ++ww) s += red[ww][r][c];
        o[((size_t)b0 * m_out + row) * n_out + n] = s;
      }
      __syncthreads();
    }
  }
}

template <int VEC>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* lengths, const float* wo, float* o, int B,
                   int sq, int skv, int d, int dv, int m_out, int k_out,
                   int n_out, int group, float scale, size_t smem,
                   cudaStream_t stream) {
  constexpr int kCols = kColThreads * VEC;
  constexpr int kLoads = VEC >= 4 ? VEC / 4 : VEC;
  constexpr size_t kStatic =
      sizeof(float) * ((size_t)kRows * kGroups * (8 / kLoads) +
                       (size_t)kWarps * kRows * kCols);
  // the 48 KB default covers static and dynamic shared memory together
  if (kStatic + smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_proj_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((n_out + kCols - 1) / kCols);
  decode_proj_kernel<VEC><<<grid, kThreads, smem, stream>>>(
      q, k, v, lengths, wo, o, B, sq, skv, d, dv, m_out, k_out, n_out, group,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, sq, d], k [B, skv, d], v [B, skv, dv], lengths [B] int32, wo
// [k_out, n_out], all contiguous fp32 on the device; o [B, m_out, n_out].
// ``group`` requests' contexts are held in shared memory at once (the
// wrapper sizes it to fit).  Returns the launch's cudaError_t.
extern "C" int flash_decode_proj_f32(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     const void* wo, void* o, int B, int sq,
                                     int skv, int d, int dv, int m_out,
                                     int k_out, int n_out, int group,
                                     float scale, void* stream) {
  if (B <= 0 || m_out <= 0 || n_out <= 0) return 0;
  if (group <= 0 || sq <= 0 || dv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * ((size_t)sq * d + (size_t)kBlockKV * (d + dv) +
                       (size_t)sq * kBlockKV + 3 * (size_t)sq +
                       (size_t)group * sq * dv);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const int* lf = static_cast<const int*>(lengths);
  const float* wf = static_cast<const float*>(wo);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 =
      (n_out % 4 == 0) && (reinterpret_cast<uintptr_t>(wo) % 16 == 0);
  const cudaError_t err =
      vec4 ? launch<8>(qf, kf, vf, lf, wf, of, B, sq, skv, d, dv, m_out,
                       k_out, n_out, group, scale, smem, s)
           : launch<1>(qf, kf, vf, lf, wf, of, B, sq, skv, d, dv, m_out,
                       k_out, n_out, group, scale, smem, s);
  return static_cast<int>(err);
}
