// DPASGD gossip mix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gossip_mix.py::gossip_mix_pallas
// and computes the same function:
//   out[n] = sum_k lambda[k] * blocks[k, n]
// for blocks [K, N] in float32 or bfloat16 and lambda [K] in float32,
// accumulated in float32 by fmaf from k = 0 upward and cast back to the
// input type (round to nearest even for bfloat16).
//
// Bound.  The kernel moves (K+1) * N * sizeof(T) bytes (each block row
// read once, the output written once) and does 2 * K * N flops: 2/sizeof(T)
// flop per byte, far below the H100's ~20 f32 flop per byte of device
// memory bandwidth (67 TFLOP/s over 3.35 TB/s).  It is memory-bound: the
// design only has to keep enough bytes in flight and stay out of the way.
//
// Two entries.  gossip_mix_launch runs the streaming kernel: each thread
// starts U 16-byte loads per row before it uses any, and the grid is exactly
// the blocks that are resident at once.  K is a template parameter for the
// K = 2 of ring plans and of the designed Gaia and AWS plans, with U = 8
// (16 loads in flight; U in {1, 2, 4, 8}, with and without evict-first
// hints, measured at K = 2 and U = 8 without hints was fastest); every
// other K takes a run-time loop over the rows at U = 4.
// gossip_mix_grid_stride_launch runs the earlier kernel (one vector per
// row per iteration of a grid-stride loop, a run-time K loop, at most 8
// blocks an SM); nothing on the training path calls it, it is kept to be
// timed beside the first.  Both accumulate in the same order, so their
// outputs are bit-identical.
//
// Sizes.  One DPASGD round mixes n_silos * P elements at once
// (4 x 630,736,896 = 2,522,947,584 for internlm2-1.8b at 4 layers), which
// exceeds 2^31, so every element index and row offset is 64-bit.
//
// Ragged sizes.  The vector paths need every row start 16-byte aligned:
// pointers aligned and N a multiple of the vector width (or K == 1).  The
// elements after the last full vector are masked by the kernel itself;
// rows that are not aligned take the scalar grid-stride path.  No padding
// copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 8 x 256 threads = 2048, one full wave

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Unpack one 16-byte vector into W floats (W = 4 for float, 8 for bf16).
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4]) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&a)[4]) {
  return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]),
                    __float_as_uint(a[2]), __float_as_uint(a[3]));
}

__device__ __forceinline__ uint4 pack(const float (&a)[8]) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(a[2 * j], a[2 * j + 1]);
  return r;
}

// Element-wise mix of element i: sum over the K rows in f32.
template <typename T>
__device__ __forceinline__ void mix_one(const T* __restrict__ blocks,
                                        const float* s_lam, T* __restrict__ out,
                                        int K, int64_t N, int64_t i) {
  float acc = 0.f;
  for (int k = 0; k < K; ++k) acc = fmaf(s_lam[k], to_f32(blocks[(int64_t)k * N + i]), acc);
  store_f32(out + i, acc);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
gossip_mix_kernel(const T* __restrict__ blocks, const float* __restrict__ lam,
                  T* __restrict__ out, int K, int64_t N) {
  extern __shared__ float s_lam[];
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_lam[k] = lam[k];
  __syncthreads();

  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if constexpr (kVec) {
    constexpr int W = 16 / sizeof(T);
    const int64_t n_vec = N / W;
    for (int64_t v = tid; v < n_vec; v += stride) {
      float acc[W];
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] = 0.f;
      for (int k = 0; k < K; ++k) {
        const uint4 r = reinterpret_cast<const uint4*>(blocks + (int64_t)k * N)[v];
        float x[W];
        unpack(r, x);
        const float l = s_lam[k];
#pragma unroll
        for (int j = 0; j < W; ++j) acc[j] = fmaf(l, x[j], acc[j]);
      }
      reinterpret_cast<uint4*>(out)[v] = pack(acc);
    }
    // ragged tail: fewer than W elements after the last full vector
    const int64_t i = n_vec * W + tid;
    if (i < N) mix_one(blocks, s_lam, out, K, N, i);
  } else {
    for (int64_t i = tid; i < N; i += stride) mix_one(blocks, s_lam, out, K, N, i);
  }
}

// The streaming kernel.  Thread tid of the grid takes vectors
// v0 + u * threads (u < U) of every row, v0 = tid + i * U * threads at
// iteration i: each of the U sweeps is coalesced, and all K * U loads of an
// iteration are started before the first is used.  KT > 0 fixes K; KT == 0
// reads K at run time, still U vectors in flight per row.
template <typename T, int KT, int U>
__global__ void __launch_bounds__(kThreads)
gossip_mix_stream_kernel(const T* __restrict__ blocks, const float* __restrict__ lam,
                         T* __restrict__ out, int K, int64_t N) {
  constexpr int W = 16 / sizeof(T);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t threads = (int64_t)gridDim.x * blockDim.x;
  const int64_t n_vec = N / W;
  const uint4* rows = reinterpret_cast<const uint4*>(blocks);
  uint4* o = reinterpret_cast<uint4*>(out);
  const int64_t row_vecs = N / W;  // N % W == 0 whenever K > 1 (checked by the launcher)
  const int k_rows = KT > 0 ? KT : K;
  for (int64_t v0 = tid; v0 < n_vec; v0 += threads * U) {
    float acc[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < W; ++j) acc[u][j] = 0.f;
    if constexpr (KT > 0) {
      uint4 r[KT][U];
#pragma unroll
      for (int k = 0; k < KT; ++k)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t v = v0 + u * threads;
          if (v < n_vec) r[k][u] = rows[(int64_t)k * row_vecs + v];
        }
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const float l = __ldg(lam + k);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float x[W];
          unpack(r[k][u], x);
#pragma unroll
          for (int j = 0; j < W; ++j) acc[u][j] = fmaf(l, x[j], acc[u][j]);
        }
      }
    } else {
      for (int k = 0; k < k_rows; ++k) {
        uint4 r[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t v = v0 + u * threads;
          if (v < n_vec) r[u] = rows[(int64_t)k * row_vecs + v];
        }
        const float l = __ldg(lam + k);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float x[W];
          unpack(r[u], x);
#pragma unroll
          for (int j = 0; j < W; ++j) acc[u][j] = fmaf(l, x[j], acc[u][j]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t v = v0 + u * threads;
      if (v < n_vec) o[v] = pack(acc[u]);
    }
  }
  // ragged tail: fewer than W elements after the last full vector
  const int64_t i = n_vec * W + tid;
  if (i < N) {
    float a = 0.f;
    for (int k = 0; k < k_rows; ++k) a = fmaf(__ldg(lam + k), to_f32(blocks[(int64_t)k * N + i]), a);
    store_f32(out + i, a);
  }
}

bool vector_rows(const void* blocks, const void* out, int K, int64_t N, int W) {
  return (reinterpret_cast<uintptr_t>(blocks) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(out) % 16 == 0) && (K == 1 || N % W == 0);
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// The earlier kernel: a grid-stride loop, at most one wave of 8 blocks an SM.
template <typename T>
cudaError_t launch_grid_stride(const void* blocks, const void* lam, void* out, int K,
                               int64_t N, cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const bool vec = vector_rows(blocks, out, K, N, W);
  const int64_t work = vec ? (N / W > 0 ? N / W : 1) : N;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  int64_t grid = (work + kThreads - 1) / kThreads;
  const int64_t wave = (int64_t)sms * kBlocksPerSm;
  if (grid > wave) grid = wave;
  const size_t smem = (size_t)K * sizeof(float);
  const T* b = static_cast<const T*>(blocks);
  const float* l = static_cast<const float*>(lam);
  T* o = static_cast<T*>(out);
  if (vec) {
    gossip_mix_kernel<T, true><<<(unsigned)grid, kThreads, smem, stream>>>(b, l, o, K, N);
  } else {
    gossip_mix_kernel<T, false><<<(unsigned)grid, kThreads, smem, stream>>>(b, l, o, K, N);
  }
  return cudaGetLastError();
}

// One streaming instantiation, its grid the blocks resident at once (and
// no more than the work needs: U vectors a thread).
template <typename T, int KT, int U>
cudaError_t launch_stream_as(const T* b, const float* l, T* o, int K, int64_t N,
                             cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gossip_mix_stream_kernel<T, KT, U>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t per_block = (int64_t)kThreads * U;
  int64_t grid = (N / W + per_block - 1) / per_block;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > resident) grid = resident;
  if (grid < 1) grid = 1;  // N < W: the tail alone
  gossip_mix_stream_kernel<T, KT, U><<<(unsigned)grid, kThreads, 0, stream>>>(
      b, l, o, K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stream(const void* blocks, const void* lam, void* out, int K, int64_t N,
                          cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  if (!vector_rows(blocks, out, K, N, W))
    return launch_grid_stride<T>(blocks, lam, out, K, N, stream);  // the scalar path
  const T* b = static_cast<const T*>(blocks);
  const float* l = static_cast<const float*>(lam);
  T* o = static_cast<T*>(out);
  if (K == 2) return launch_stream_as<T, 2, 8>(b, l, o, K, N, stream);
  return launch_stream_as<T, 0, 4>(b, l, o, K, N, stream);
}

template <bool kStream>
int entry(const void* blocks, const void* lam, void* out, int K, int64_t N, int dtype,
          void* stream) {
  if (K <= 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)(kStream ? launch_stream<float>(blocks, lam, out, K, N, s)
                           : launch_grid_stride<float>(blocks, lam, out, K, N, s));
    case 1:
      return (int)(kStream ? launch_stream<__nv_bfloat16>(blocks, lam, out, K, N, s)
                           : launch_grid_stride<__nv_bfloat16>(blocks, lam, out, K, N, s));
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, bound with ctypes (src/repro_torch/kernels/gossip_mix.py).
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int gossip_mix_launch(const void* blocks, const void* lam, void* out,
                                 int K, int64_t N, int dtype, void* stream) {
  return entry<true>(blocks, lam, out, K, N, dtype, stream);
}

// The earlier grid-stride kernel, same arguments (timing only).
extern "C" int gossip_mix_grid_stride_launch(const void* blocks, const void* lam, void* out,
                                             int K, int64_t N, int dtype, void* stream) {
  return entry<false>(blocks, lam, out, K, N, dtype, stream);
}

extern "C" const char* gossip_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
