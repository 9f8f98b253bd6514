// Forward flash attention (GQA, causal, optional sliding window) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_pallas
// and computes the same function: for q [B, S, K, G, hd] and k, v
// [B, T, K, hd] (float32 or bfloat16),
//   s[q, t]  = (q * hd^-0.5) . k[t]           (q scaled in fp32 first)
//   masked   : causal kv_pos > q_pos, or window q_pos - kv_pos >= window
//   s        = -1e30 where masked              (finite, never -inf)
//   out[q]   = sum_t softmax(s[q])[t] v[t]     (online softmax in fp32)
//   out      = acc / max(l, 1e-30), cast to q's type
// with positions 0..S-1 for the queries and 0..T-1 for the keys.
//
// Bound.  Each visible (query, key) pair costs 2*hd multiply-adds (the
// score and the value product): 4*hd operations.  At prefill shapes this
// is far above the bytes it moves (q, k, v read once, out written once),
// so the kernel is bound by operations.  Its products run as fp32 FMAs on
// the CUDA cores (67 TFLOP/s on an H100 SXM): the reference's numerics are
// fp32, and TF32 or bf16 tensor-core products would break its 2e-5
// tolerance.  Tensor cores (wgmma), TMA and warp specialisation are left
// to a later change.
//
// Design.  One block of 256 threads takes one (batch, kv head, query
// tile): BQ = 64 / G query positions times all G query heads of that kv
// head, 64 rows in all, so each K/V tile read from memory serves the G
// heads (the Pallas grid's (b, h, i) with the G axis inside the block).
// K/V tiles of 64 keys stream through shared memory, converted to fp32.
// The two products are register-tiled: thread (ty, tx) of a 16 x 16 grid
// owns rows ty + 16i and keys tx + 16j (i, j < 4) of the 64 x 64 score
// tile, and rows ty + 16i and dims tx + 16e (e < hd/16) of the
// accumulator.  The 16 threads of one row group are one half-warp, so a
// row's max and sum are four xor-shuffles.  The running max, normaliser
// and accumulator stay in fp32 registers.  Shared-memory rows are padded
// to hd + 4 floats so the 16-byte reads of 16 different key rows fall in
// distinct banks.
//
// Masked tiles.  A masked score is the finite -1e30 of the reference, so
// a tile that is wholly masked for a row before its first visible key
// adds weights of 1 that the next tile's alpha = exp(-1e30 - m) = 0
// wipes out exactly.  Key tiles outside every row's visible band (above
// the diagonal, or before the window of the tile's first query) are
// skipped; that changes nothing when every row of the block sees at
// least one key, which each block checks before it skips.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;    // query rows (position, head) per block
constexpr int kKeys = 64;    // keys per K/V tile
constexpr int kLdP = 80;     // padded row of the probability tile
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// padded row (floats) of the q, k and v tiles in shared memory
__host__ __device__ constexpr int ld(int hd) { return hd + 4; }

__host__ __device__ constexpr size_t smem_bytes(int hd) {
  return (size_t)(3 * kRows * ld(hd) + kRows * kLdP) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int S, int T_len, int K, int G, float scale,
                       int causal, int window) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = ld(HD);
  constexpr int E = HD / 16;  // accumulator dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [kRows][LD]
  float* Ks = Qs + kRows * LD;      // [kKeys][LD]
  float* Vs = Ks + kKeys * LD;      // [kKeys][LD]
  float* Ps = Vs + kKeys * LD;      // [kRows][kLdP]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int BQ = kRows / G;
  const int R = BQ * G;             // live rows of this block
  const int q0 = blockIdx.x * BQ;
  const int q_last = min(q0 + BQ, S) - 1;

  // q rows of (b, q0 .. q0+BQ-1, h, 0..G-1): G*HD contiguous elements per position
  const int64_t q_pos_stride = (int64_t)K * G * HD;
  const T* q_base = q + ((int64_t)b * S * K + h) * (int64_t)G * HD;
  for (int idx = tid; idx < kRows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int qp = q0 + r / G;
    float x = 0.f;
    if (r < R && qp < S) x = to_f32(q_base[(int64_t)qp * q_pos_stride + (r % G) * HD + d]) * scale;
    Qs[r * LD + d] = x;
  }

  // Key tiles that hold a visible key of some row of the block.  Row q
  // sees [max(0, q - window + 1), causal ? min(T-1, q) : T-1]; if the
  // last row sees a key, so does every row (both ends grow with q), and
  // the block's band runs from its first row's start to its last row's
  // end.  Otherwise (a window of 0, or rows past the keys' window) every
  // tile is kept, as in the reference.
  int kv_lo = 0, kv_hi = T_len - 1;
  const bool has_window = window >= 0;
  {
    const int lo = has_window ? max(0, q_last - window + 1) : 0;
    const int hi = causal ? min(T_len - 1, q_last) : T_len - 1;
    if (lo <= hi) {
      kv_lo = has_window ? max(0, q0 - window + 1) : 0;
      kv_hi = hi;
    }
  }

  float m[4], l[4], acc[4][E];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }
  int row_pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) row_pos[i] = q0 + (ty + 16 * i) / G;

  const int64_t kv_pos_stride = (int64_t)K * HD;
  const T* k_base = k + ((int64_t)b * T_len * K + h) * HD;
  const T* v_base = v + ((int64_t)b * T_len * K + h) * HD;

  for (int t0 = (kv_lo / kKeys) * kKeys; t0 <= kv_hi; t0 += kKeys) {
    __syncthreads();  // Qs written / previous tile's Ks, Vs, Ps read
    for (int idx = tid; idx < kKeys * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD;
      const int64_t off = (int64_t)(t0 + j) * kv_pos_stride + d;
      Ks[j * LD + d] = to_f32(k_base[off]);
      Vs[j * LD + d] = to_f32(v_base[off]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = t0 + tx + 16 * j;
        const bool masked = (causal && kp > row_pos[i]) ||
                            (has_window && row_pos[i] - kp >= window);
        if (masked) s[i][j] = kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kLdP + j];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float x = Vs[j * LD + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(p[i], x, acc[i][e]);
      }
    }
  }

  T* o_base = out + ((int64_t)b * S * K + h) * (int64_t)G * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= R || row_pos[i] >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o_row = o_base + (int64_t)row_pos[i] * q_pos_stride + (r % G) * HD;
#pragma unroll
    for (int e = 0; e < E; ++e) store(o_row + tx + 16 * e, acc[i][e] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int S, int T_len, int K, int G, float scale, int causal,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(HD);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int BQ = kRows / G;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)K, (unsigned)B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, T_len, K, G, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* out,
                        int B, int S, int T_len, int K, int G, int hd, float scale,
                        int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, T_len, K, G, scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, T_len, K, G, scale, causal, window, stream);
    case 80: return launch<T, 80>(q, k, v, out, B, S, T_len, K, G, scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, T_len, K, G, scale, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, bound with ctypes (src/repro_torch/kernels/flash_attention.py).
// dtype: 0 = float32, 1 = bfloat16.  window: -1 for none, else >= 0.
// Needs contiguous q [B,S,K,G,hd], k/v [B,T,K,hd], out like q; hd in
// {32, 64, 80, 128}; 1 <= G <= 64; T a multiple of 64.  Returns the
// cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int S, int T_len, int K,
                                      int G, int hd, float scale, int causal,
                                      int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || G <= 0 || G > kRows ||
      T_len % kKeys != 0 || window < -1 || K > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_hd<float>(q, k, v, out, B, S, T_len, K, G, hd, scale, causal, window, s);
    case 1: return (int)dispatch_hd<__nv_bfloat16>(q, k, v, out, B, S, T_len, K, G, hd, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
