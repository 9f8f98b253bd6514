// mLSTM / gated linear-attention scan (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mlstm_scan.py::mlstm_scan_pallas
// and computes the same function: for q, k, v [B, S, H, hd] (float32 or
// bfloat16) and float32 log-gates log_i, log_f [B, S, H], every head
// carries a float32 [hd, hd] state
//   S_t = exp(log_f_t) S_{t-1} + exp(log_i_t) k_t v_t^T,   h_t = q_t . S_t
// from S_0 = 0, and h is written in q's type.  Chunkwise, as the Pallas
// kernel: within a chunk of C tokens, with g the cumulative log_f,
//   h[c]  = e^{g[c]} (q[c] . S) + sum_{t<=c} (q[c].k[t]) e^{g[c]-g[t]+li[t]} v[t]
//   S    <- e^{g[C-1]} S + sum_t e^{g[C-1]-g[t]+li[t]} k[t] v[t]^T
// Every exponent is <= 0 where it is used (log_f <= 0 makes g fall, and
// log_i <= 0 for a sigmoid gate).  The gate above the diagonal (t > c),
// whose exponent g[c] - g[t] is positive and passes float32's exp limit
// over a long chunk with unbiased forget gates, is never evaluated: the
// score is set to 0 there instead.  The chunk length changes the result
// only by rounding; this kernel uses C = 64 whatever the caller's chunk.
//
// Bound.  The reference's work at its chunk of 128 is 2 (128*129*hd +
// 2*128*hd^2) operations per (batch, head, chunk): the q.k^T tile, the
// inter-chunk q.S and the state update.  At xlstm-350m's hd = 512 this is
// far above the bytes moved (q, k, v read once, h written once), so the
// kernel is bound by operations.  Its products run as float32 FMAs on the
// CUDA cores (67 TFLOP/s on an H100 SXM): the reference's numerics are
// float32, and TF32 or bf16 tensor-core products would need another
// tolerance.  Tensor cores, TMA and overlap are left to a later change.
//
// Design.  The Pallas kernel keeps the whole [hd, hd] state of one head
// in VMEM (1 MiB at hd 512); an H100 block has at most 227 KB of shared
// memory.  So the state is split along its value dimension: a block takes
// one (batch, head) and E = 32 value columns, keeps the float32 slice
// S[:, e0:e0+E] in shared memory (64 KB at hd 512, 105 KB in all, so two
// blocks share an SM), and walks the chunks in order.  The grid is
// (hd/E, H, B): 256 blocks for xlstm-350m's forward at batch 4.  One E
// serves every hd that is a multiple of 32.  Per chunk:
//   1. warp 0 scans log_f into g (two entries a lane, shuffles), and the
//      block forms e^{g} and the state-update weights w[t];
//   2. q and k stream through shared memory in slices of 32 of hd
//      (transposed, rows padded to C + 1 floats), accumulating the
//      [C, C] score tile q.k^T and the [C, E] inter-chunk q.S in
//      registers (a 16 x 16 thread grid, 4 x 4 scores and 4 x 2 outputs
//      a thread);
//   3. the scores are gated into P (0 above the diagonal) and the [C, E]
//      slice of v is loaded; h = e^{g} (q.S) + P.v is written out;
//   4. k streams through again, scaled by w, and the state slice is
//      updated in place, 32 rows of hd at a time.
// Each of the hd/E blocks of a head recomputes the same q.k^T tile: at hd
// 512 and C 64 that is about four fifths more work than the bound counts
// (7.1e10 operations against 3.9e10 at xlstm-350m's forward shape); a
// shorter chunk keeps that share small.  One launch does the whole scan;
// there is no second kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kE = 32;        // value columns of the state a block carries
constexpr int kC = 64;        // tokens per chunk
constexpr int kD = 32;        // slice of hd streamed through shared memory
constexpr int kLd = kC + 1;   // padded row of the transposed slices and of P
constexpr int kMaxHd = 512;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

size_t smem_bytes(int hd) {
  return ((size_t)hd * kE + 2 * kD * kLd + kC * kLd + kC * kE + 4 * kC) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ log_i,
                  const float* __restrict__ log_f, T* __restrict__ out,
                  int S, int H, int hd) {
  constexpr int E = kE;
  constexpr int EJ = E / 16;  // value columns a thread owns
  extern __shared__ float smem[];
  float* St = smem;               // [hd][E]  state slice S[:, e0:e0+E]
  float* Qt = St + hd * E;        // [kD][kLd] q slice, transposed
  float* Kt = Qt + kD * kLd;      // [kD][kLd] k slice (times w in step 4), transposed
  float* P = Kt + kD * kLd;       // [kC][kLd] gated scores
  float* Vs = P + kC * kLd;       // [kC][E]  v[:, e0:e0+E]
  float* g = Vs + kC * E;         // [kC] cumulative log forget
  float* li = g + kC;             // [kC] log input gate
  float* eg = li + kC;            // [kC] e^{g}
  float* w = eg + kC;             // [kC] e^{g_total - g + li}

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int e0 = blockIdx.x * E;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t tok = (int64_t)H * hd;  // elements between consecutive tokens
  const int64_t base = ((int64_t)b * S * H + h) * hd;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base + e0;
  T* ob = out + base + e0;
  const float* lib = log_i + (int64_t)b * S * H + h;  // stride H between tokens
  const float* lfb = log_f + (int64_t)b * S * H + h;

  for (int i = tid; i < hd * E; i += kThreads) St[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += kC) {
    const int len = min(kC, S - c0);  // a ragged last chunk is padded with zeros
    __syncthreads();  // the previous chunk is done with g, w, P, Vs and Kt

    // 1. gates: inclusive scan of log_f; padded tokens add 0
    if (tid < 32) {
      float lo = tid < len ? lfb[(int64_t)(c0 + tid) * H] : 0.f;
      float hi = tid + 32 < len ? lfb[(int64_t)(c0 + tid + 32) * H] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float a = __shfl_up_sync(0xffffffffu, lo, o);
        const float c = __shfl_up_sync(0xffffffffu, hi, o);
        if (tid >= o) {
          lo += a;
          hi += c;
        }
      }
      hi += __shfl_sync(0xffffffffu, lo, 31);
      g[tid] = lo;
      g[tid + 32] = hi;
      li[tid] = tid < len ? lib[(int64_t)(c0 + tid) * H] : 0.f;
      li[tid + 32] = tid + 32 < len ? lib[(int64_t)(c0 + tid + 32) * H] : 0.f;
    }
    __syncthreads();
    const float g_total = g[kC - 1];
    if (tid < kC) {
      eg[tid] = expf(g[tid]);
      w[tid] = expf(g_total - g[tid] + li[tid]);
    }

    // 2. scores q.k^T [C, C] and inter-chunk q.S [C, E], over slices of hd
    float att[4][4], acc[4][EJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) att[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < EJ; ++j) acc[i][j] = 0.f;
    }
    for (int d0 = 0; d0 < hd; d0 += kD) {
      for (int idx = tid; idx < kC * kD; idx += kThreads) {
        const int t = idx / kD, d = idx % kD;
        float qv = 0.f, kv = 0.f;
        if (t < len) {
          const int64_t off = (int64_t)(c0 + t) * tok + d0 + d;
          qv = to_f32(qb[off]);
          kv = to_f32(kb[off]);
        }
        Qt[d * kLd + t] = qv;
        Kt[d * kLd + t] = kv;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kD; ++d) {
        float a[4], bk[4], s[EJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qt[d * kLd + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = Kt[d * kLd + tx + 16 * j];
#pragma unroll
        for (int j = 0; j < EJ; ++j) s[j] = St[(d0 + d) * E + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) att[i][j] = fmaf(a[i], bk[j], att[i][j]);
#pragma unroll
          for (int j = 0; j < EJ; ++j) acc[i][j] = fmaf(a[i], s[j], acc[i][j]);
        }
      }
      __syncthreads();
    }

    // 3. gate the scores (never exp above the diagonal), load v, write h
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = tx + 16 * j;
        float p = 0.f;
        if (t <= c) p = att[i][j] * expf(g[c] - g[t] + li[t]);
        P[c * kLd + t] = p;
      }
    }
    for (int idx = tid; idx < kC * E; idx += kThreads) {
      const int t = idx / E, e = idx % E;
      Vs[idx] = t < len ? to_f32(vb[(int64_t)(c0 + t) * tok + e]) : 0.f;
    }
    __syncthreads();
    {
      float o[4][EJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float scale = eg[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < EJ; ++j) o[i][j] = scale * acc[i][j];
      }
#pragma unroll 4
      for (int t = 0; t < kC; ++t) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * kLd + t];
#pragma unroll
        for (int j = 0; j < EJ; ++j) {
          const float x = Vs[t * E + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][j] = fmaf(p[i], x, o[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = ty + 16 * i;
        if (c >= len) continue;
        T* row = ob + (int64_t)(c0 + c) * tok;
#pragma unroll
        for (int j = 0; j < EJ; ++j) store(row + tx + 16 * j, o[i][j]);
      }
    }

    // 4. state update, 32 rows of hd at a time: rows ty and ty + 16 of the
    //    slice, columns tx + 16j
    const float e_total = expf(g_total);
    for (int d0 = 0; d0 < hd; d0 += kD) {
      __syncthreads();  // Kt free (step 2 or the previous slice)
      for (int idx = tid; idx < kC * kD; idx += kThreads) {
        const int t = idx / kD, d = idx % kD;
        Kt[d * kLd + t] = t < len ? to_f32(kb[(int64_t)(c0 + t) * tok + d0 + d]) * w[t] : 0.f;
      }
      __syncthreads();
      float u[2][EJ];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < EJ; ++j) u[i][j] = 0.f;
#pragma unroll 4
      for (int t = 0; t < kC; ++t) {
        const float k0 = Kt[ty * kLd + t];
        const float k1 = Kt[(ty + 16) * kLd + t];
#pragma unroll
        for (int j = 0; j < EJ; ++j) {
          const float x = Vs[t * E + tx + 16 * j];
          u[0][j] = fmaf(k0, x, u[0][j]);
          u[1][j] = fmaf(k1, x, u[1][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* row = St + (d0 + ty + 16 * i) * E;
#pragma unroll
        for (int j = 0; j < EJ; ++j) {
          const int e = tx + 16 * j;
          row[e] = fmaf(e_total, row[e], u[i][j]);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* log_i,
                   const float* log_f, void* out, int B, int S, int H, int hd,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(mlstm_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(hd / kE), (unsigned)H, (unsigned)B);
  mlstm_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      log_i, log_f, static_cast<T*>(out), S, H, hd);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (src/repro_torch/kernels/mlstm_scan.py).
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out); the log gates are
// float32.  Needs contiguous q, k, v, out [B,S,H,hd] and log_i, log_f
// [B,S,H]; hd a multiple of 32 up to 512.  Returns the cudaError_t of the
// launch.
extern "C" int mlstm_scan_launch(const void* q, const void* k, const void* v,
                                 const void* log_i, const void* log_f, void* out,
                                 int B, int S, int H, int hd, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd % kD != 0 || hd > kMaxHd ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* li = static_cast<const float*>(log_i);
  const float* lf = static_cast<const float*>(log_f);
  switch (dtype) {
    case 0: return (int)launch<float>(q, k, v, li, lf, out, B, S, H, hd, s);
    case 1: return (int)launch<__nv_bfloat16>(q, k, v, li, lf, out, B, S, H, hd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mlstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
