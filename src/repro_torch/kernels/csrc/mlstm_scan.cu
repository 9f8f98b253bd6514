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
// only by rounding.
//
// Bound.  The reference's work at its chunk of 128 is 2 (128*129*hd +
// 2*128*hd^2) operations per (batch, head, chunk): the q.k^T tile, the
// inter-chunk q.S and the state update.  At xlstm-350m's hd = 512 this is
// far above the bytes moved (q, k, v read once, h written once), so the
// kernel is bound by operations.
//
// Two entries.  mlstm_scan_launch runs the tensor-core kernels below, the
// path the port takes.  mlstm_scan_simt_launch runs the earlier kernel,
// whose products are float32 FMAs on the CUDA cores; nothing on the model's
// path calls it, it is kept to be timed beside the first.
//
// Precision of the tensor-core kernels, as in csrc/flash_attention.cu:
// each float32 operand x is split into hi = tf32(x) and lo = tf32(x - hi),
// rounded to nearest with ties away from zero, and a product is
// hi.lo + lo.hi + hi.hi in float32 accumulators (3xTF32, three passes at
// the 495 TFLOP/s TF32 rate).  A bf16 value is exact in TF32, so q.k^T on
// bf16 inputs is one pass, and a product with one float32 operand (the
// gated scores P, the state, w * k) two.  TF32 wgmma reads both operands
// K-major only: the state update sums over tokens, so k and v are
// transposed as they are converted, and P.v transposes v.
//
// Design of the tensor-core kernels: one chunk-state pass and a parallel
// output pass, C = 128 tokens a chunk.  The grid carries the chunk
// sequence only where it must (the state), and each product is computed
// once:
//  1. mlstm_scores_kernel, one block per (batch, head, chunk): the gated
//     scores P = (q_c k_c^T) * exp(g[c] - g[t] + li[t]) for t <= c, 0
//     above the diagonal (masked before exp), into a [B, H, n, C, C]
//     float32 scratch.  Two warpgroups, 64 query rows each; the upper
//     warpgroup's right half of the tile lies above the diagonal and is
//     skipped.
//  2. mlstm_state_kernel, one block per (batch, head, 64 x 128 tile of the
//     transposed state), walks the chunks in order.  Per chunk it scales
//     its tile S^T by e^{g_total} and adds dS^T = v_c^T (w * k_c)
//     (w = e^{g_total - g + li}) slice by slice, in float32 registers, and
//     writes the state after chunk c into a [B, H, n - 1, hd, hd] scratch,
//     stored transposed ([value dim][key dim]) so that the output pass
//     reads it K-major as it stands.  The last chunk's state is never
//     needed.
//  3. mlstm_output_kernel, one block per (batch, head, chunk, 128 value
//     columns), fully parallel: h = e^{g} * (q_c . S_{c-1}) + P . v_c, the
//     first product over the key dimension, then the rows scaled in
//     registers, then P . v added.
// Every product runs as wgmma (m64n64k8 or m64n128k8) over 32-deep operand
// slices in shared memory, in wgmma's layout without swizzle (8-row x
// 16-byte core matrices), and each slice's product lands in a fresh
// accumulator that is added to the running sum in float32 registers:
// chained through the tensor core's accumulator over hd = 512 (192 wgmma
// deep) the sums drifted far enough that xlstm-350m's logits left the
// whole-model check.  The operands arrive as raw tiles by cp.async, in a
// two-stage ring (slice s + 2 in flight while slice s is used), and all
// threads of the block convert them shared-to-shared into the hi/lo
// planes, transposing where needed; conversion and products then run in
// series within a block, and several blocks share an SM.  A ragged last
// chunk and head dims that are not a multiple of the tile are zero-filled
// as they are copied, and the rows and columns past the end are not
// written.  The kernel allocates nothing: the wrapper passes both
// scratches in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---------------------------------------------------------------------------
// The CUDA-core kernel, kept to be timed beside the tensor-core kernels.
//
// The state is split along its value dimension: a block takes one (batch,
// head) and E = 32 value columns, keeps the float32 slice S[:, e0:e0+E] in
// shared memory (64 KB at hd 512, 105 KB in all, so two blocks share an
// SM), and walks the chunks of 64 tokens in order.  The grid is (hd/E, H,
// B).  Per chunk:
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
// Each of the hd/E blocks of a head recomputes the same q.k^T tile.

constexpr int kThreads = 256;       // CUDA-core kernel
constexpr int kE = 32;        // value columns of the state a block carries
constexpr int kCs = 64;       // tokens per chunk (CUDA-core kernel)
constexpr int kD = 32;        // slice of hd streamed through shared memory
constexpr int kLd = kCs + 1;   // padded row of the transposed slices and of P
constexpr int kMaxHd = 512;


size_t smem_bytes_simt(int hd) {
  return ((size_t)hd * kE + 2 * kD * kLd + kCs * kLd + kCs * kE + 4 * kCs) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_scan_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ log_i,
                  const float* __restrict__ log_f, T* __restrict__ out,
                  int S, int H, int hd) {
  constexpr int E = kE;
  constexpr int EJ = E / 16;  // value columns a thread owns
  extern __shared__ float smem_simt[];
  float* St = smem_simt;          // [hd][E]  state slice S[:, e0:e0+E]
  float* Qt = St + hd * E;        // [kD][kLd] q slice, transposed
  float* Kt = Qt + kD * kLd;      // [kD][kLd] k slice (times w in step 4), transposed
  float* P = Kt + kD * kLd;       // [kCs][kLd] gated scores
  float* Vs = P + kCs * kLd;       // [kCs][E]  v[:, e0:e0+E]
  float* g = Vs + kCs * E;         // [kCs] cumulative log forget
  float* li = g + kCs;             // [kCs] log input gate
  float* eg = li + kCs;            // [kCs] e^{g}
  float* w = eg + kCs;             // [kCs] e^{g_total - g + li}

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

  for (int c0 = 0; c0 < S; c0 += kCs) {
    const int len = min(kCs, S - c0);  // a ragged last chunk is padded with zeros
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
    const float g_total = g[kCs - 1];
    if (tid < kCs) {
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
      for (int idx = tid; idx < kCs * kD; idx += kThreads) {
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
    for (int idx = tid; idx < kCs * E; idx += kThreads) {
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
      for (int t = 0; t < kCs; ++t) {
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
      for (int idx = tid; idx < kCs * kD; idx += kThreads) {
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
      for (int t = 0; t < kCs; ++t) {
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
cudaError_t launch_simt(const void* q, const void* k, const void* v, const float* log_i,
                   const float* log_f, void* out, int B, int S, int H, int hd,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes_simt(hd);
  cudaError_t err = cudaFuncSetAttribute(mlstm_scan_simt_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(hd / kE), (unsigned)H, (unsigned)B);
  mlstm_scan_simt_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      log_i, log_f, static_cast<T*>(out), S, H, hd);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The tensor-core kernels (wgmma, 3xTF32)

constexpr int kChunk = 128;    // tokens per chunk
constexpr int kSlice = 32;     // depth of a staged operand slice (tokens or key dims)
constexpr int kTile = 64;      // rows of a wgmma (M) and columns (N)
constexpr int kWarpgroup = 128;
constexpr int kSliceFloats = kTile * kSlice;  // one 64-row slice plane

// Float offset of element (r, c) of an operand slice whose rows are kSlice
// elements deep (c runs along the reduction), in wgmma's layout without
// swizzle: core matrices of 8 rows x 4 floats (128 bytes), depth-adjacent
// ones contiguous, 8-row groups kSlice/4 core matrices apart.
__device__ __forceinline__ int cm(int r, int c) {
  return ((r >> 3) * (kSlice / 4) + (c >> 2)) * 32 + (r & 7) * 4 + (c & 3);
}

// wgmma shared-memory descriptor of such a slice: start address, leading
// (depth) byte offset 128, stride byte offset kSlice * 32, no swizzle.  A
// depth step of 8 (two core matrices, 256 bytes) adds 16 to it.
__device__ __forceinline__ uint64_t slice_desc(const float* tile) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((kSlice * 32) >> 4) << 32);
}

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero.
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Four consecutive-depth values (r, c..c+3) into a slice: hi plane at
// `hi`, lo plane `lo_off` floats further when split.
__device__ __forceinline__ void put4(float* hi, int lo_off, int off, float4 x, bool split) {
  if (split) {
    const float4 h = make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
    const float4 l = make_float4(tf32(x.x - h.x), tf32(x.y - h.y), tf32(x.z - h.z),
                                 tf32(x.w - h.w));
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(hi + lo_off + off) = l;
  } else {
    *reinterpret_cast<float4*>(hi + off) = x;
  }
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, fp32, the wgmma accumulator layout) += A . B^T over a depth of
// 8, A (64 rows) and B (N rows) TF32 slices in shared memory given by their
// descriptors; scale_d = 0 overwrites d instead.  Thread (warp w of the
// warpgroup, lane 4g + t) holds rows 16w + g and 16w + g + 8, columns
// 8c + 2t and 8c + 2t + 1, as d[4c + 2h + j] for row 16w + g + 8h and
// column 8c + 2t + j.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t a, uint64_t b,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint64_t a, uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], uint64_t a, uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d = A . B^T over one 32-deep slice (four depth steps), into a fresh
// accumulator: the caller adds it to its running sum in float32 registers,
// rounded to nearest, so that no long sum is chained through the tensor
// core's accumulator.  A split operand has a lo plane (`a_lo`, `b_lo`: its
// offset from the hi plane in descriptor units, 16 bytes); an exact one
// (bf16) has none.  Both split: a_hi.b_lo + a_lo.b_hi + a_hi.b_hi; one
// split: x.y_lo + x.y_hi; neither: one pass.  The small terms go first.
template <int N>
__device__ __forceinline__ void slice_product(float (&d)[N / 2], uint64_t a, uint64_t a_lo,
                                              bool a_split, uint64_t b, uint64_t b_lo,
                                              bool b_split) {
  int scale = 0;
  if (b_split) {
#pragma unroll
    for (int st = 0; st < kSlice / 8; ++st, scale = 1)
      wgmma_tf32<N>(d, a + 16 * st, b + b_lo + 16 * st, scale);
  }
  if (a_split) {
#pragma unroll
    for (int st = 0; st < kSlice / 8; ++st, scale = 1)
      wgmma_tf32<N>(d, a + a_lo + 16 * st, b + 16 * st, scale);
  }
#pragma unroll
  for (int st = 0; st < kSlice / 8; ++st, scale = 1)
    wgmma_tf32<N>(d, a + 16 * st, b + 16 * st, scale);
}

// sum += part, element by element (float32, rounded to nearest).
template <int R>
__device__ __forceinline__ void add_into(float (&sum)[R], const float (&part)[R]) {
#pragma unroll
  for (int e = 0; e < R; ++e) sum[e] += part[e];
}

// The chunk's gates, by the block's first 128 threads (every thread of the
// block calls it): g[t] = sum_{s <= t} log_f[c0 + s] and li[t] =
// log_i[c0 + t], both 0 past the chunk's `len` tokens.  Warp-level scans
// joined through `wsum`.
__device__ __forceinline__ void chunk_gates(const float* __restrict__ lfb,
                                            const float* __restrict__ lib, int H, int c0,
                                            int len, float* g, float* li, float* wsum) {
  const int tid = threadIdx.x;
  float x = 0.f;
  if (tid < kChunk) {
    x = tid < len ? lfb[(int64_t)(c0 + tid) * H] : 0.f;
    li[tid] = tid < len ? lib[(int64_t)(c0 + tid) * H] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float a = __shfl_up_sync(0xffffffffu, x, o);
      if ((tid & 31) >= o) x += a;
    }
    if ((tid & 31) == 31) wsum[tid >> 5] = x;
  }
  __syncthreads();
  if (tid < kChunk) {
    for (int w = 0; w < (tid >> 5); ++w) x += wsum[w];
    g[tid] = x;
  }
  __syncthreads();
}

// ---- staging: asynchronous raw copies, converted shared-to-shared --------
//
// Each operand slice arrives as a raw tile (16-byte cp.async copies,
// coalesced, zero-filled past the valid rows and columns) in a two-stage
// ring, so slice s + 2 is in flight while slice s is converted and
// multiplied.  The conversion reads the raw tile and writes the hi (and lo)
// planes in wgmma's layout, transposing where the operand needs it.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Every group but the most recent one has landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Raw row stride of a kSlice-deep tile in shared memory: 16 bytes of pad,
// so that eight rows read at one depth fall in distinct banks.
template <typename T>
__host__ __device__ constexpr int raw_ld() { return kSlice + 16 / (int)sizeof(T); }

// R rows x L elements of a row-major global operand (`ld` apart) into a
// raw tile (`dld` apart); rows >= rows_valid and columns >= cols_valid
// read as 0.
template <int R, int L, int kThreads, typename T>
__device__ __forceinline__ void copy_raw(T* dst, int dld, const T* src, int64_t ld,
                                         int rows_valid, int cols_valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPer = L / kVec;
  static_assert((R * kPer) % kThreads == 0, "copy_raw tiling");
#pragma unroll
  for (int it = 0; it < R * kPer / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kPer, c = (i % kPer) * kVec;
    const bool ok = r < rows_valid && c < cols_valid;
    cp_async16(dst + r * dld + c, ok ? src + r * ld + c : src, ok);
  }
}

// Raw rows (depth contiguous, `ld` apart) -> slice rows [0, R): float4
// reads of eight padded rows and float4 writes of eight slice rows, both
// free of bank conflicts.
template <int R, int kThreads, typename T>
__device__ __forceinline__ void convert_rows(float* hi, int lo_off, const T* raw, int ld,
                                             bool split) {
#pragma unroll
  for (int it = 0; it < R * kSlice / 4 / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = (idx & 7) + 8 * ((idx >> 3) / (kSlice / 4));
    const int c = 4 * ((idx >> 3) % (kSlice / 4));
    put4(hi, lo_off, cm(r, c), load4(raw + r * ld + c), split);
  }
}

// A raw [kSlice tokens][R] tile -> the R-row slice of its transpose:
// slice (r, c) = raw[c][r] (times scale[c] when given).  Lanes take
// consecutive r: scalar reads of consecutive words, float4 writes of eight
// slice rows.
template <int R, int kThreads, typename T>
__device__ __forceinline__ void convert_transposed(float* hi, int lo_off, const T* raw,
                                                   const float* scale, bool split) {
#pragma unroll
  for (int it = 0; it < R * kSlice / 4 / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx % R;
    const int c = 4 * (idx / R);
    float4 x = make_float4(to_f32(raw[c * R + r]), to_f32(raw[(c + 1) * R + r]),
                           to_f32(raw[(c + 2) * R + r]), to_f32(raw[(c + 3) * R + r]));
    if (scale != nullptr)
      x = make_float4(x.x * scale[c], x.y * scale[c + 1], x.z * scale[c + 2], x.w * scale[c + 3]);
    put4(hi, lo_off, cm(r, c), x, split);
  }
}

// ---- 1. gated scores -------------------------------------------------------

constexpr int kScoreThreads = 2 * kWarpgroup;
constexpr size_t kScorePlane = (size_t)kChunk * kSlice;  // floats of one 128-row plane

template <typename T>
struct ScoreSmem {
  static constexpr size_t kRaw = (size_t)kChunk * raw_ld<T>() * sizeof(T);  // one raw q or k tile
  static constexpr size_t off_conv = 4 * kRaw;   // [stage][q, k] raw tiles first
  static constexpr size_t off_gates = off_conv + 4 * kScorePlane * sizeof(float);
  static constexpr size_t bytes = off_gates + (2 * kChunk + 8) * sizeof(float);
  static_assert(kRaw % 128 == 0 && bytes <= 232448, "scores layout");
};

template <typename T>
__global__ void __launch_bounds__(kScoreThreads)
mlstm_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const float* __restrict__ log_i, const float* __restrict__ log_f,
                    float* __restrict__ scores, int S, int H, int hd, int n_chunks) {
  using P = ScoreSmem<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kLd = raw_ld<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem);                          // [stage][q, k][128 x kLd]
  float* Qs = reinterpret_cast<float*>(smem + P::off_conv);     // [hi, lo][128 x 32]: rows c
  float* Ks = Qs + 2 * kScorePlane;                             // [hi, lo][128 x 32]: rows t
  float* g = reinterpret_cast<float*>(smem + P::off_gates);
  float* li = g + kChunk;
  float* wsum = li + kChunk;

  const int chunk = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int c0 = chunk * kChunk;
  const int len = min(kChunk, S - c0);
  const int64_t tok = (int64_t)H * hd;
  const int64_t base = ((int64_t)b * S + c0) * tok + (int64_t)h * hd;
  const int n_slices = hd / kSlice;
  auto fetch = [&](int s) {
    if (s < n_slices) {
      T* dst = raw + (s & 1) * 2 * kChunk * kLd;
      copy_raw<kChunk, kSlice, kScoreThreads>(dst, kLd, q + base + s * kSlice, tok, len, kSlice);
      copy_raw<kChunk, kSlice, kScoreThreads>(dst + kChunk * kLd, kLd, k + base + s * kSlice, tok,
                                              len, kSlice);
    }
    cp_async_commit();
  };
  fetch(0);
  fetch(1);
  chunk_gates(log_f + (int64_t)b * S * H + h, log_i + (int64_t)b * S * H + h, H, c0, len, g,
              li, wsum);

  const int tid = threadIdx.x;
  const int wg = tid / kWarpgroup;
  float acc[2][32];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[n][e] = 0.f;
  const uint64_t lo = kScorePlane * 4 / 16;
  const uint64_t dq = slice_desc(Qs + wg * kSliceFloats);

  for (int s = 0; s < n_slices; ++s) {
    cp_async_wait_prior();
    __syncthreads();
    const T* rs = raw + (s & 1) * 2 * kChunk * kLd;
    convert_rows<kChunk, kScoreThreads>(Qs, kScorePlane, rs, kLd, kF32);
    convert_rows<kChunk, kScoreThreads>(Ks, kScorePlane, rs + kChunk * kLd, kLd, kF32);
    fence_async_smem();
    __syncthreads();
    fetch(s + 2);
    float part[2][32];
    wgmma_fence();
    slice_product<kTile>(part[0], dq, lo, kF32, slice_desc(Ks), lo, kF32);
    if (wg == 1) slice_product<kTile>(part[1], dq, lo, kF32, slice_desc(Ks + kSliceFloats), lo, kF32);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < 2; ++n) fence_regs(part[n]);
    add_into(acc[0], part[0]);
    if (wg == 1) add_into(acc[1], part[1]);
  }

  // Gate, 0 above the diagonal (never exp there), and write P [128 x 128].
  const int warp = (tid % kWarpgroup) >> 5;
  const int lane = tid & 31;
  float* out = scores + ((int64_t)bh * n_chunks + chunk) * kChunk * kChunk;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wg * kTile + warp * 16 + (lane >> 2) + 8 * hh;
    const float gr = g[r];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int t = n * kTile + 8 * cc + 2 * (lane & 3);
        float p[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          p[j] = t + j <= r ? acc[n][4 * cc + 2 * hh + j] * expf(gr - g[t + j] + li[t + j]) : 0.f;
        store2(out + r * kChunk + t, p[0], p[1]);
      }
  }
}

// ---- 2. chunk states -------------------------------------------------------

constexpr int kStateThreads = kWarpgroup;
constexpr int kWide = 128;   // N of the state and output passes' products (columns a block holds)

template <typename T>
struct StateSmem {
  // raw tiles of a stage: v [32 tokens][64 value dims], k [32][128 key dims]
  static constexpr size_t kRawV = (size_t)kSlice * kTile * sizeof(T);
  static constexpr size_t kStage = kRawV + (size_t)kSlice * kWide * sizeof(T);
  static constexpr size_t off_conv = 2 * kStage;
  static constexpr size_t kConvA = 2 * (size_t)kSliceFloats;   // floats: v^T hi, lo
  static constexpr size_t off_gates = off_conv + (kConvA + 2 * (size_t)kWide * kSlice) * 4;
  static constexpr size_t bytes = off_gates + (3 * kChunk + 8) * sizeof(float);
  static_assert(kStage % 128 == 0 && bytes <= 232448, "state layout");
};

template <typename T>
__global__ void __launch_bounds__(kStateThreads)
mlstm_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ log_i, const float* __restrict__ log_f,
                   float* __restrict__ states, int S, int H, int hd, int n_chunks) {
  using P = StateSmem<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kParts = kChunk / kSlice;  // slices of a chunk
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem + P::off_conv);  // [hi, lo][64 x 32]: v^T
  float* Bs = As + P::kConvA;                                // [hi, lo][128 x 32]: (w k)^T
  float* g = reinterpret_cast<float*>(smem + P::off_gates);
  float* li = g + kChunk;
  float* w = li + kChunk;                // state-update weights e^{g_total - g + li}
  float* wsum = w + kChunk;

  const int e0 = blockIdx.x * kTile;
  const int d0 = blockIdx.y * kWide;
  const int bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int64_t tok = (int64_t)H * hd;
  const float* lfb = log_f + (int64_t)b * S * H + h;
  const float* lib = log_i + (int64_t)b * S * H + h;
  const T* vb = v + (int64_t)b * S * tok + (int64_t)h * hd + e0;
  const T* kb = k + (int64_t)b * S * tok + (int64_t)h * hd + d0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint64_t a_lo = kSliceFloats * 4 / 16, b_lo = kWide * kSlice * 4 / 16;
  const uint64_t da = slice_desc(As), db = slice_desc(Bs);
  const int n_slices = (n_chunks - 1) * kParts;  // full chunks only: the last state is unused
  auto fetch = [&](int s) {  // slice s: tokens 32 s .. 32 s + 31
    if (s < n_slices) {
      T* dst = reinterpret_cast<T*>(smem + (s & 1) * P::kStage);
      const int64_t off = (int64_t)s * kSlice * tok;
      copy_raw<kSlice, kTile, kStateThreads>(dst, kTile, vb + off, tok, kSlice, hd - e0);
      copy_raw<kSlice, kWide, kStateThreads>(dst + kSlice * kTile, kWide, kb + off, tok, kSlice,
                                             hd - d0);
    }
    cp_async_commit();
  };
  fetch(0);
  fetch(1);

  // S^T[e0 + row, d0 + col] in the accumulator layout: at each chunk scaled
  // by e^{g_total}, then each 32-token slice's products added
  float st[kWide / 2];
#pragma unroll
  for (int e = 0; e < kWide / 2; ++e) st[e] = 0.f;

  for (int s = 0; s < n_slices; ++s) {
    const int sub = s % kParts;  // slice within the chunk
    if (sub == 0) {
      chunk_gates(lfb, lib, H, (s / kParts) * kChunk, kChunk, g, li, wsum);
      const float g_total = g[kChunk - 1];
      const float e_total = expf(g_total);
#pragma unroll
      for (int e = 0; e < kWide / 2; ++e) st[e] *= e_total;
      w[tid] = expf(g_total - g[tid] + li[tid]);
    }
    cp_async_wait_prior();
    __syncthreads();  // slice s has landed; w is written
    const T* rs = reinterpret_cast<const T*>(smem + (s & 1) * P::kStage);
    convert_transposed<kTile, kStateThreads>(As, kSliceFloats, rs, nullptr, kF32);
    convert_transposed<kWide, kStateThreads>(Bs, kWide * kSlice, rs + kSlice * kTile,
                                             w + sub * kSlice, true);
    fence_async_smem();
    __syncthreads();  // converted; the raw stage is free
    fetch(s + 2);
    float part[kWide / 2];
    wgmma_fence();
    slice_product<kWide>(part, da, a_lo, kF32, db, b_lo, true);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    add_into(st, part);
    if (sub == kParts - 1) {
      // the state after this chunk, [e][d], for the next chunk's output
      float* slot = states + ((int64_t)bh * (n_chunks - 1) + s / kParts) * hd * hd;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = e0 + warp * 16 + (lane >> 2) + 8 * hh;
        if (e >= hd) continue;
#pragma unroll
        for (int cc = 0; cc < kWide / 8; ++cc) {
          const int d = d0 + 8 * cc + 2 * (lane & 3);
          if (d < hd)
            store2(slot + (int64_t)e * hd + d, st[4 * cc + 2 * hh], st[4 * cc + 2 * hh + 1]);
        }
      }
    }
  }
}

// ---- 3. output -------------------------------------------------------------

constexpr int kOutThreads = 2 * kWarpgroup;
constexpr int kLdF = raw_ld<float>();

template <typename T>
struct OutSmem {
  // A raw: q rows (T) or P rows (float), 128 x kLd; B raw: S^T rows (float,
  // 128 x kLdF) or v's tokens (T, 32 x 128).
  static constexpr size_t kRawA = (size_t)kChunk * kLdF * sizeof(float);
  static constexpr size_t kRawB = (size_t)kWide * kLdF * sizeof(float);
  static constexpr size_t kStage = kRawA + kRawB;
  static constexpr size_t off_conv = 2 * kStage;
  static constexpr size_t off_gates = off_conv + (2 * kScorePlane + 2 * (size_t)kWide * kSlice) *
                                                     sizeof(float);
  static constexpr size_t bytes = off_gates + (2 * kChunk + 8) * sizeof(float);
  static_assert(kChunk * raw_ld<T>() * sizeof(T) <= kRawA && kSlice * kWide * sizeof(T) <= kRawB,
                "output raw tiles");
  static_assert(kStage % 128 == 0 && bytes <= 232448, "output layout");
};

template <typename T>
__global__ void __launch_bounds__(kOutThreads)
mlstm_output_kernel(const T* __restrict__ q, const T* __restrict__ v,
                    const float* __restrict__ log_i, const float* __restrict__ log_f,
                    const float* __restrict__ states, const float* __restrict__ scores,
                    T* __restrict__ out, int S, int H, int hd, int n_chunks) {
  using P = OutSmem<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kLdT = raw_ld<T>();
  constexpr int kPlaneB = kWide * kSlice;
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem + P::off_conv);  // [hi, lo][128 x 32]: q or P, rows c
  float* Bs = As + 2 * kScorePlane;                          // [hi, lo][128 x 32]: S^T or v^T, rows e
  float* g = reinterpret_cast<float*>(smem + P::off_gates);
  float* li = g + kChunk;
  float* wsum = li + kChunk;

  const int e0 = blockIdx.x * kWide;
  const int chunk = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int c0 = chunk * kChunk;
  const int len = min(kChunk, S - c0);
  const int64_t tok = (int64_t)H * hd;
  const int64_t base = ((int64_t)b * S + c0) * tok + (int64_t)h * hd;
  // the state before this chunk (none before the first), [e][d] rows e0..
  const float* slot = states + ((int64_t)bh * (n_chunks - 1) + chunk - 1) * hd * hd +
                      (int64_t)e0 * hd;
  const float* p_tile = scores + ((int64_t)bh * n_chunks + chunk) * kChunk * kChunk;
  const int n_state = chunk > 0 ? hd / kSlice : 0;      // slices of q . S_{c-1}
  const int n_slices = n_state + (len + kSlice - 1) / kSlice;  // then slices of P . v
  auto fetch = [&](int s) {
    if (s < n_slices) {
      unsigned char* stage = smem + (s & 1) * P::kStage;
      if (s < n_state) {
        copy_raw<kChunk, kSlice, kOutThreads>(reinterpret_cast<T*>(stage), kLdT,
                                              q + base + s * kSlice, tok, len, kSlice);
        copy_raw<kWide, kSlice, kOutThreads>(reinterpret_cast<float*>(stage + P::kRawA), kLdF,
                                             slot + s * kSlice, hd, hd - e0, kSlice);
      } else {
        const int t0 = (s - n_state) * kSlice;
        copy_raw<kChunk, kSlice, kOutThreads>(reinterpret_cast<float*>(stage), kLdF, p_tile + t0,
                                              kChunk, kChunk, kSlice);
        copy_raw<kSlice, kWide, kOutThreads>(reinterpret_cast<T*>(stage + P::kRawA), kWide,
                                             v + base + (int64_t)t0 * tok + e0, tok, len - t0,
                                             hd - e0);
      }
    }
    cp_async_commit();
  };
  fetch(0);
  fetch(1);
  chunk_gates(log_f + (int64_t)b * S * H + h, log_i + (int64_t)b * S * H + h, H, c0, len, g,
              li, wsum);

  const int tid = threadIdx.x;
  const int wg = tid / kWarpgroup;
  const int warp = (tid % kWarpgroup) >> 5;
  const int lane = tid & 31;
  const uint64_t a_lo = kScorePlane * 4 / 16, b_lo = kPlaneB * 4 / 16;
  const uint64_t da = slice_desc(As + wg * kSliceFloats), db = slice_desc(Bs);
  float acc[kWide / 2];
#pragma unroll
  for (int e = 0; e < kWide / 2; ++e) acc[e] = 0.f;

  for (int s = 0; s < n_slices; ++s) {
    cp_async_wait_prior();
    __syncthreads();
    const unsigned char* stage = smem + (s & 1) * P::kStage;
    const bool state_part = s < n_state;
    if (state_part) {
      convert_rows<kChunk, kOutThreads>(As, kScorePlane, reinterpret_cast<const T*>(stage), kLdT,
                                        kF32);
      convert_rows<kWide, kOutThreads>(Bs, kPlaneB,
                                       reinterpret_cast<const float*>(stage + P::kRawA), kLdF,
                                       true);
    } else {
      convert_rows<kChunk, kOutThreads>(As, kScorePlane, reinterpret_cast<const float*>(stage),
                                        kLdF, true);
      convert_transposed<kWide, kOutThreads>(Bs, kPlaneB,
                                             reinterpret_cast<const T*>(stage + P::kRawA),
                                             nullptr, kF32);
    }
    fence_async_smem();
    __syncthreads();
    fetch(s + 2);
    // the lower warpgroup's rows see no token past 63
    if (state_part || wg == 1 || s - n_state < kTile / kSlice) {
      float part[kWide / 2];
      wgmma_fence();
      if (state_part)
        slice_product<kWide>(part, da, a_lo, kF32, db, b_lo, true);   // q . S^T
      else
        slice_product<kWide>(part, da, a_lo, true, db, b_lo, kF32);   // P . v
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
      add_into(acc, part);
    }
    if (s == n_state - 1) {  // h = e^{g} * (q . S_{c-1}), then + P . v
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float eg = expf(g[wg * kTile + warp * 16 + (lane >> 2) + 8 * hh]);
#pragma unroll
        for (int cc = 0; cc < kWide / 8; ++cc) {
          acc[4 * cc + 2 * hh] *= eg;
          acc[4 * cc + 2 * hh + 1] *= eg;
        }
      }
    }
  }

  T* ob = out + base + e0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wg * kTile + warp * 16 + (lane >> 2) + 8 * hh;
    if (r >= len) continue;
#pragma unroll
    for (int cc = 0; cc < kWide / 8; ++cc) {
      const int e = 8 * cc + 2 * (lane & 3);
      if (e0 + e < hd) store2(ob + r * tok + e, acc[4 * cc + 2 * hh], acc[4 * cc + 2 * hh + 1]);
    }
  }
}

template <typename T>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const float* log_i,
                      const float* log_f, void* out, float* states, float* scores, int B,
                      int S, int H, int hd, cudaStream_t stream) {
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const unsigned bh = (unsigned)(B * H);
  const unsigned tiles = (unsigned)((hd + kTile - 1) / kTile);
  const unsigned wide = (unsigned)((hd + kWide - 1) / kWide);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  cudaError_t err = cudaFuncSetAttribute(mlstm_scores_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)ScoreSmem<T>::bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)StateSmem<T>::bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_output_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)OutSmem<T>::bytes);
  if (err != cudaSuccess) return err;
  mlstm_scores_kernel<T><<<dim3((unsigned)n_chunks, bh), kScoreThreads, ScoreSmem<T>::bytes,
                           stream>>>(qt, kt, log_i, log_f, scores, S, H, hd, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n_chunks > 1) {
    mlstm_state_kernel<T><<<dim3(tiles, wide, bh), kStateThreads, StateSmem<T>::bytes,
                            stream>>>(kt, vt, log_i, log_f, states, S, H, hd, n_chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  mlstm_output_kernel<T><<<dim3(wide, (unsigned)n_chunks, bh), kOutThreads, OutSmem<T>::bytes,
                           stream>>>(qt, vt, log_i, log_f, states, scores, static_cast<T*>(out),
                                     S, H, hd, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (src/repro_torch/kernels/mlstm_scan.py).
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out); the log gates are
// float32.  Needs contiguous q, k, v, out [B,S,H,hd] and log_i, log_f
// [B,S,H]; hd a multiple of 32 up to 512; B * H at most 65535.

// The tensor-core kernels.  states: float32 scratch of B*H*(n-1)*hd*hd
// and scores: float32 scratch of B*H*n*128*128, n = ceil(S / 128); q, k,
// v and out 16-byte aligned.  Makes three launches (two when S <= 128) on
// `stream`.  Returns the cudaError_t of the launches.
extern "C" int mlstm_scan_launch(const void* q, const void* k, const void* v,
                                 const void* log_i, const void* log_f, void* out,
                                 void* states, void* scores, int B, int S, int H, int hd,
                                 int dtype, void* stream) {
  const uintptr_t misaligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out |
                                (uintptr_t)scores) & 15;
  const int n_chunks = S > 0 ? (S + kChunk - 1) / kChunk : 0;
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd % kSlice != 0 || hd > kMaxHd ||
      (int64_t)B * H > 65535 || n_chunks > 65535 || misaligned ||
      (n_chunks > 1 && ((uintptr_t)states & 15)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* li = static_cast<const float*>(log_i);
  const float* lf = static_cast<const float*>(log_f);
  float* st = static_cast<float*>(states);
  float* sc = static_cast<float*>(scores);
  switch (dtype) {
    case 0: return (int)launch_tc<float>(q, k, v, li, lf, out, st, sc, B, S, H, hd, s);
    case 1: return (int)launch_tc<__nv_bfloat16>(q, k, v, li, lf, out, st, sc, B, S, H, hd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The CUDA-core kernel (timing only): one launch, no scratch.
extern "C" int mlstm_scan_simt_launch(const void* q, const void* k, const void* v,
                                      const void* log_i, const void* log_f, void* out,
                                      int B, int S, int H, int hd, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd % kD != 0 || hd > kMaxHd ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* li = static_cast<const float*>(log_i);
  const float* lf = static_cast<const float*>(log_f);
  switch (dtype) {
    case 0: return (int)launch_simt<float>(q, k, v, li, lf, out, B, S, H, hd, s);
    case 1: return (int)launch_simt<__nv_bfloat16>(q, k, v, li, lf, out, B, S, H, hd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mlstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
