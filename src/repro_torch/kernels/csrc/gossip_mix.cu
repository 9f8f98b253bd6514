// DPASGD gossip mix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gossip_mix.py::gossip_mix_pallas
// and computes the same function:
//   out[n] = sum_k lambda[k] * blocks[k, n]
// for blocks [K, N] in float32 or bfloat16 and lambda [K] in float32,
// accumulated in float32 and cast back to the input type (round to
// nearest even for bfloat16).
//
// Bound.  The kernel moves (K+1) * N * sizeof(T) bytes (each block row
// read once, the output written once) and does 2 * K * N flops: 2/sizeof(T)
// flop per byte, far below the H100's ~20 f32 flop per byte of device
// memory bandwidth (67 TFLOP/s over 3.35 TB/s).  It is memory-bound, so the
// design only has to stream: every thread walks a grid-stride loop over
// 16-byte vectors, loads the K rows at its vector, accumulates in
// registers and stores once.  Independent 16-byte loads from one full wave
// of resident blocks keep enough bytes in flight to approach the memory
// rate; TMA staging and persistent scheduling are left to a later change.
//
// Sizes.  One DPASGD round mixes n_silos * P elements at once
// (4 x 630,736,896 = 2,522,947,584 for internlm2-1.8b at 4 layers), which
// exceeds 2^31, so every element index and row offset is 64-bit.
//
// Ragged sizes.  The vector path needs every row start 16-byte aligned:
// pointers aligned and N a multiple of the vector width (or K == 1).  The
// elements after the last full vector are masked by the kernel itself;
// rows that are not aligned take the scalar path.  No padding copy.

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

template <typename T>
cudaError_t launch(const void* blocks, const void* lam, void* out, int K,
                   int64_t N, cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const bool vec = (reinterpret_cast<uintptr_t>(blocks) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                   (K == 1 || N % W == 0);
  const int64_t work = vec ? (N / W > 0 ? N / W : 1) : N;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
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

}  // namespace

// C interface, bound with ctypes (src/repro_torch/kernels/gossip_mix.py).
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int gossip_mix_launch(const void* blocks, const void* lam, void* out,
                                 int K, int64_t N, int dtype, void* stream) {
  if (K <= 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(blocks, lam, out, K, N, s);
    case 1: return (int)launch<__nv_bfloat16>(blocks, lam, out, K, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gossip_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
