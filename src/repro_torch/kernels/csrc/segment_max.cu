// Row-wise segment max over an edge batch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_max.py::edge_segment_max_pallas
// and computes the same function:
//   out[b, s] = max vals[b, e]  over e with ids[b, e] == s
// for vals [B, E] (float32, float64, float16 or bfloat16) and int32 ids
// [B, E] into out [B, S] of the values' type.  Empty segments give -inf,
// ids outside [0, S) are dropped, and a NaN in a segment gives NaN (as
// jnp.maximum in the Pallas body does).
//
// Design.  The TPU kernel compares every edge tile with every segment
// tile, O(E * S) dense vector work, because its VPU cannot scatter.  Here
// one block per (row b, tile of segments) keeps the tile's running maxima
// in shared memory and folds every edge of the row into it with one
// shared-memory atomicMax: O(E) work per row.  atomicMax exists for
// unsigned integers only, so each value is mapped to an order-preserving
// unsigned key (flip all bits of a negative float, set the sign bit of a
// non-negative one): a < b as floats iff key(a) < key(b) as unsigned.  NaN
// is first made the canonical quiet NaN, whose key lies above +inf's, so
// it wins every max.  -0.0 keys just below +0.0: the two differ only in
// sign, and max(-0, +0) = +0 here while the plain version may return
// either.  16-bit inputs are widened to float32 keys (exact: max only
// picks a value) and the pick is narrowed back exactly.  Max is exact and
// order-free, so the result does not depend on the atomics' order.
//
// Bound.  The kernel reads each value and id once and writes each output
// once, (B*E*(sizeof(T) + 4) + B*S*sizeof(T)) bytes, with one compare per
// edge: memory-bound on paper.  At the design climb's shape (B = 16,
// E = 261, S = 87) those are a few tens of kilobytes, far below what one
// launch costs, so the kernel sits at launch latency; fusing the Karp
// level's gather and add into it, or running all N levels in one
// persistent launch, is left to a later change.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;  // no opt-in attribute needed below 48 KB

__device__ __forceinline__ unsigned int encode_f32(float x) {
  unsigned int b = (x != x) ? 0x7fc00000u : __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float decode_f32(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ unsigned long long encode_f64(double x) {
  unsigned long long b = (x != x) ? 0x7ff8000000000000ull
                                  : (unsigned long long)__double_as_longlong(x);
  return (b & 0x8000000000000000ull) ? ~b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ double decode_f64(unsigned long long k) {
  const unsigned long long b =
      (k & 0x8000000000000000ull) ? (k & 0x7fffffffffffffffull) : ~k;
  return __longlong_as_double((long long)b);
}

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  using Key = unsigned int;
  __device__ static Key encode(float x) { return encode_f32(x); }
  __device__ static float decode(Key k) { return decode_f32(k); }
  __device__ static Key neg_inf() { return encode_f32(__uint_as_float(0xff800000u)); }
};

template <>
struct Traits<double> {
  using Key = unsigned long long;
  __device__ static Key encode(double x) { return encode_f64(x); }
  __device__ static double decode(Key k) { return decode_f64(k); }
  __device__ static Key neg_inf() {
    return encode_f64(__longlong_as_double((long long)0xfff0000000000000ull));
  }
};

template <>
struct Traits<__half> {
  using Key = unsigned int;
  __device__ static Key encode(__half x) { return encode_f32(__half2float(x)); }
  __device__ static __half decode(Key k) { return __float2half_rn(decode_f32(k)); }
  __device__ static Key neg_inf() { return encode_f32(__uint_as_float(0xff800000u)); }
};

template <>
struct Traits<__nv_bfloat16> {
  using Key = unsigned int;
  __device__ static Key encode(__nv_bfloat16 x) { return encode_f32(__bfloat162float(x)); }
  __device__ static __nv_bfloat16 decode(Key k) { return __float2bfloat16_rn(decode_f32(k)); }
  __device__ static Key neg_inf() { return encode_f32(__uint_as_float(0xff800000u)); }
};

// grid = (B, ceil(S / tile)); block (b, y) owns segments [y*tile, y*tile + n).
template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_max_kernel(const T* __restrict__ vals, const int32_t* __restrict__ ids,
                   T* __restrict__ out, int64_t E, int64_t S, int tile) {
  using Key = typename Traits<T>::Key;
  extern __shared__ __align__(8) unsigned char smem_raw[];
  Key* smax = reinterpret_cast<Key*>(smem_raw);

  const int64_t b = blockIdx.x;
  const int64_t s0 = (int64_t)blockIdx.y * tile;
  const int n = (int)((S - s0) < tile ? (S - s0) : tile);
  const Key init = Traits<T>::neg_inf();
  for (int i = threadIdx.x; i < n; i += blockDim.x) smax[i] = init;
  __syncthreads();

  const T* v = vals + b * E;
  const int32_t* id = ids + b * E;
  for (int64_t e = threadIdx.x; e < E; e += blockDim.x) {
    // unsigned compare drops ids below s0 (and negative ids) and ids past the tile
    const int64_t s = (int64_t)id[e] - s0;
    if ((uint64_t)s < (uint64_t)n) atomicMax(&smax[s], Traits<T>::encode(v[e]));
  }
  __syncthreads();

  T* o = out + b * S + s0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = Traits<T>::decode(smax[i]);
}

template <typename T>
cudaError_t launch(const void* vals, const void* ids, void* out, int64_t B, int64_t E,
                   int64_t S, cudaStream_t stream) {
  using Key = typename Traits<T>::Key;
  const int64_t max_tile = kSmemBytes / (int64_t)sizeof(Key);
  const int tile = (int)(S < max_tile ? S : max_tile);
  const int64_t tiles = (S + tile - 1) / tile;
  if (B > 0x7fffffffLL || tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)B, (unsigned)tiles);
  const size_t smem = (size_t)tile * sizeof(Key);
  segment_max_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const int32_t*>(ids), static_cast<T*>(out),
      E, S, tile);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (src/repro_torch/kernels/segment_max.py).
// dtype: 0 = float32, 1 = float64, 2 = float16, 3 = bfloat16.  vals and ids
// are contiguous [B, E], out is contiguous [B, S].  Returns the cudaError_t
// of the launch (nothing is launched when B or S is 0).
extern "C" int segment_max_launch(const void* vals, const void* ids, void* out, int64_t B,
                                  int64_t E, int64_t S, int dtype, void* stream) {
  if (B < 0 || E < 0 || S < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(vals, ids, out, B, E, S, s);
    case 1: return (int)launch<double>(vals, ids, out, B, E, S, s);
    case 2: return (int)launch<__half>(vals, ids, out, B, E, S, s);
    case 3: return (int)launch<__nv_bfloat16>(vals, ids, out, B, E, S, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* segment_max_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
