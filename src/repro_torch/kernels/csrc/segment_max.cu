// Row-wise segment max over an edge batch, and the three persistent
// recursions built on it, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_max.py::edge_segment_max_pallas
// and the per-level loops around it in the reference: the rewire climb's
// (src/repro/core/maxplus_sparse.py::batched_cycle_time_sparse_jax, one
// segment max per Karp level, and the reach body of
// src/repro/core/topologies.py::_rewire_climb_fn, one per hop) and
// MATCHA pricing's (maxplus_sparse.py::timing_recursion_time_varying_sparse_jax,
// one segment max per round).  Four entry points:
//
// segment_max_launch computes the standalone segment max
//   out[b, s] = max vals[b, e]  over e with ids[b, e] == s
// for vals [B, E] (float32, float64, float16 or bfloat16) and int32 ids
// [B, E] into out [B, S] of the values' type.  Empty segments give -inf,
// ids outside [0, S) are dropped, and a NaN in a segment gives NaN (as
// jnp.maximum in the Pallas body does).
//
// karp_cycle_time_launch computes a batch of Karp max cycle means: for
// edge lists (src, dst, w) [B, E] over N nodes, D_0 = 0,
//   D_k[v] = max over arcs (u -> v) of D_{k-1}[u] + w   (k = 1..N)
// and out[b] = max_v min_k (D_N[v] - D_k[v]) / (N - k), a NaN ratio read
// as +inf and a node with D_N = -inf as -inf.
//
// reach_launch computes, for the same arc lists and a present mask, the
// vertices reachable from vertex 0 along present arcs forward (src ->
// dst) and backward (dst -> src): out [2, B, N] of 0/1 bytes.
//
// timing_recursion_launch computes the round-varying Eq. 4 recursion of
// C Monte-Carlo chains over one arc pool (src, dst) [E] (int32) whose
// weights change by round: row ids[c, k] of w [U, E] (float32 or float64;
// -inf marks an arc absent that round) weights round k of chain c, and
//   t_v(k+1) = max( max over arcs (u -> v) of t_u(k) + w[ids[c, k], e],
//                   carry_v )
// where carry_v is t_v(k) when row ids[c, k] has no present self-loop at
// v and -inf otherwise; out [C, R+1, N] holds t(0) = t0 (or 0) .. t(R).
// It is what src/repro/core/maxplus_sparse.py::
// timing_recursion_unique_rounds_sparse computes on the host.
//
// Design.  The TPU kernel compares every edge tile with every segment
// tile, O(E * S) dense vector work, because its VPU cannot scatter.  Here
// a block keeps a row's running maxima in shared memory and folds every
// edge of the row into it with one shared-memory atomicMax: O(E) work per
// row.  atomicMax exists for unsigned integers only, so each value is
// mapped to an order-preserving unsigned key (flip all bits of a negative
// float, set the sign bit of a non-negative one): a < b as floats iff
// key(a) < key(b) as unsigned.  NaN is first made the canonical quiet NaN,
// whose key lies above +inf's, so it wins every max.  -0.0 keys just below
// +0.0: the two differ only in sign, and max(-0, +0) = +0 here while the
// plain version may return either.  16-bit inputs are widened to float32
// keys (exact: max only picks a value) and the pick is narrowed back
// exactly.  Max is exact and order-free, so the result does not depend on
// the atomics' order.
//
// The two recursions are one launch each: one block per graph row (grid
// (B, 2) for reachability, a block per direction) runs every level of the
// chain.  The row's arcs are staged in shared memory once (read from
// global memory each level when they do not fit), the running level lives
// in shared memory as keys, and a block barrier stands where the
// per-level path launched a kernel.  Karp rotates three key buffers (read
// D_{k-1}, fold into D_k, reset the third), so a level costs one pass over
// the arcs and one barrier; each finished level goes to a [B, N, N]
// scratch in global memory (L2-resident at the climb's sizes) for the
// final formula, which the same block evaluates.  Each add, subtraction
// and division is done in the input type, round-to-nearest, with
// explicit __fadd_rn/__fdiv_rn-style intrinsics so nothing contracts;
// 16-bit inputs compute in float and round once to their type, as torch
// does, so the result equals the plain version bit for bit.
// Reachability sets a byte per vertex, in place, and stops at the first
// hop that changes nothing (__syncthreads_or): r only grows, so the
// fixpoint is the same set that N - 1 synchronous hops reach.  The timing
// recursion runs one block per chain over all R rounds, one barrier a
// round where the reference has a lax.scan step: t lives in shared memory
// as keys in three rotating buffers (read t(k), fold t(k+1), reset the
// third), each round is one pass over the E arcs reading their ids and
// weight row ids[c, k] from global memory (L1- and L2-resident at MATCHA's
// sizes), and the carry is one more atomicMax of t_v(k) into t_v(k+1), so
// it needs no barrier of its own.  Whether a row has a present self-loop at v is
// known before its round: the pass of round k also stamps, for round
// k + 1's row, each v with a present self-loop (two stamp buffers by
// parity, so a stamp is written only while nobody reads it), and round
// 0's stamps are set before the rounds.  Every add is __dadd_rn (or
// __fadd_rn) and max is exact, so the result is the plain version's and
// the reference's numpy host engine's bit for bit.  An id outside [0, N)
// in any recursion, or a round id outside [0, U), stops the kernel
// (__trap), which the caller sees as a CUDA error at the next synchronise,
// as with torch's own indexing kernels.
//
// Bound.  The standalone kernel reads each value and id once and writes
// each output once, (B*E*(sizeof(T) + 4) + B*S*sizeof(T)) bytes, with one
// compare per edge: memory-bound on paper, and at the design climb's
// shape (B = 16, E = 261, S = 87) far below what a launch costs.  The
// Karp score's least time is the larger of its bytes (B*E*(sizeof(T) + 8)
// read, B*sizeof(T) written) and its operations (2*B*N*E adds and maxima
// plus 3*B*N*N for the final formula); its real floor is the chain of N
// dependent levels, one barrier and one pass over the row's arcs each,
// which no amount of parallelism across rows removes.  A wide row could
// spread over a thread-block cluster, sharing the level through
// distributed shared memory; that is left to a later change.  The timing
// recursion's least time is the larger of its bytes (the U*E*sizeof(T)
// distinct weight rows, E*8 arc ids and C*R*4 round ids read once,
// C*(R+1)*N*sizeof(T) written) and its operations (2*C*R*E adds and
// maxima); its real floor is the chain of R dependent rounds, one barrier
// and one pass over the arcs each.  C is 24 to 64 chains at MATCHA's
// sizes, so most of the 132 SMs idle: spreading a chain over a cluster is
// later work too.

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

// ---------------------------------------------------------------------------
// Persistent recursions: Karp's max cycle mean and reachability from vertex 0

constexpr int kMaxThreads = 1024;
constexpr size_t kDefaultSmem = 48 * 1024;

// Arithmetic in the input type: C is the type a value is computed in, and
// round() narrows a C result to T's precision (and widens it back), once.
template <typename T>
struct Arith;

template <>
struct Arith<float> {
  using C = float;
  __device__ static C load(float x) { return x; }
  __device__ static float store(C x) { return x; }
  __device__ static C round(C x) { return x; }
  __device__ static C add(C a, C b) { return __fadd_rn(a, b); }
  __device__ static C sub(C a, C b) { return __fsub_rn(a, b); }
  __device__ static C div(C a, C b) { return __fdiv_rn(a, b); }
};

template <>
struct Arith<double> {
  using C = double;
  __device__ static C load(double x) { return x; }
  __device__ static double store(C x) { return x; }
  __device__ static C round(C x) { return x; }
  __device__ static C add(C a, C b) { return __dadd_rn(a, b); }
  __device__ static C sub(C a, C b) { return __dsub_rn(a, b); }
  __device__ static C div(C a, C b) { return __ddiv_rn(a, b); }
};

template <>
struct Arith<__half> {
  using C = float;
  __device__ static C load(__half x) { return __half2float(x); }
  __device__ static __half store(C x) { return __float2half_rn(x); }
  __device__ static C round(C x) { return __half2float(__float2half_rn(x)); }
  __device__ static C add(C a, C b) { return round(__fadd_rn(a, b)); }
  __device__ static C sub(C a, C b) { return round(__fsub_rn(a, b)); }
  __device__ static C div(C a, C b) { return round(__fdiv_rn(a, b)); }
};

template <>
struct Arith<__nv_bfloat16> {
  using C = float;
  __device__ static C load(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 store(C x) { return __float2bfloat16_rn(x); }
  __device__ static C round(C x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  __device__ static C add(C a, C b) { return round(__fadd_rn(a, b)); }
  __device__ static C sub(C a, C b) { return round(__fsub_rn(a, b)); }
  __device__ static C div(C a, C b) { return round(__fdiv_rn(a, b)); }
};

__device__ __forceinline__ unsigned int encode_key(float x) { return encode_f32(x); }
__device__ __forceinline__ unsigned long long encode_key(double x) { return encode_f64(x); }
__device__ __forceinline__ float decode_key(unsigned int k) { return decode_f32(k); }
__device__ __forceinline__ double decode_key(unsigned long long k) { return decode_f64(k); }

template <typename C>
struct Inf;

template <>
struct Inf<float> {
  using Key = unsigned int;
  __device__ static float neg() { return __uint_as_float(0xff800000u); }
  __device__ static float pos() { return __uint_as_float(0x7f800000u); }
};

template <>
struct Inf<double> {
  using Key = unsigned long long;
  __device__ static double neg() { return __longlong_as_double((long long)0xfff0000000000000ull); }
  __device__ static double pos() { return __longlong_as_double(0x7ff0000000000000ll); }
};

template <typename C>
__device__ __forceinline__ C neg_inf_of() { return Inf<C>::neg(); }
template <typename C>
__device__ __forceinline__ C pos_inf_of() { return Inf<C>::pos(); }

template <typename T>
using KeyOf = typename Inf<typename Arith<T>::C>::Key;

// One block per row b.  kStaged: the row's arcs sit in shared memory
// (else they are read from global memory at every level).
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
karp_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
            const T* __restrict__ w, T* __restrict__ levels, T* __restrict__ out,
            int E, int N) {
  using A = Arith<T>;
  using C = typename A::C;
  using Key = KeyOf<T>;
  extern __shared__ __align__(8) unsigned char smem_raw[];
  Key* keys = reinterpret_cast<Key*>(smem_raw);  // 3 level buffers of N keys
  Key* red = keys + 3 * N;                         // the row's max over v
  C* s_w = reinterpret_cast<C*>(red + 1);
  int32_t* s_src = reinterpret_cast<int32_t*>(s_w + (kStaged ? E : 0));
  int32_t* s_dst = s_src + (kStaged ? E : 0);

  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t b = blockIdx.x;
  const int32_t* g_src = src + b * E;
  const int32_t* g_dst = dst + b * E;
  const T* g_w = w + b * E;
  const C ninf = neg_inf_of<C>();
  const Key kneg = encode_key(ninf);
  const Key kzero = encode_key(C(0));

  for (int v = tid; v < N; v += nt) {
    keys[v] = kzero;  // D_0 = 0
    keys[N + v] = kneg;
    keys[2 * N + v] = kneg;
  }
  if (tid == 0) *red = kneg;
  for (int e = tid; e < E; e += nt) {
    const int32_t s = g_src[e], d = g_dst[e];
    if ((unsigned)s >= (unsigned)N || (unsigned)d >= (unsigned)N) __trap();
    if (kStaged) {
      s_src[e] = s;
      s_dst[e] = d;
      s_w[e] = A::load(g_w[e]);
    }
  }
  __syncthreads();

  // Level k reads D_{k-1} from cur, folds D_k into nxt, resets spare (read
  // at level k-1, so free since the last barrier) and stores D_{k-1} to the
  // scratch (row k-2 holds D_{k-1}; D_0 = 0 and D_N stay out of it).
  Key* cur = keys;
  Key* nxt = keys + N;
  Key* spare = keys + 2 * N;
  T* lev = levels + b * (int64_t)N * N;
  for (int k = 1; k <= N; ++k) {
    for (int e = tid; e < E; e += nt) {
      const int32_t s = kStaged ? s_src[e] : g_src[e];
      const int32_t d = kStaged ? s_dst[e] : g_dst[e];
      const C we = kStaged ? s_w[e] : A::load(g_w[e]);
      const C x = A::add(decode_key(cur[s]), we);
      if (!(x == ninf)) atomicMax(&nxt[d], encode_key(x));
    }
    for (int v = tid; v < N; v += nt) {
      spare[v] = kneg;
      if (k >= 2) lev[(int64_t)(k - 2) * N + v] = A::store(decode_key(cur[v]));
    }
    __syncthreads();
    Key* t = cur;
    cur = nxt;
    nxt = spare;
    spare = t;
  }

  // cur holds D_N.  min over k of (D_N - D_k) / (N - k), NaN -> +inf,
  // -inf where D_N is -inf, then the max over v.
  for (int v = tid; v < N; v += nt) {
    const C dn = decode_key(cur[v]);
    C m = pos_inf_of<C>();
    for (int k = 0; k < N; ++k) {
      const C dk = k == 0 ? C(0) : A::load(lev[(int64_t)(k - 1) * N + v]);
      C r = A::div(A::sub(dn, dk), A::round(C(N - k)));
      if (r != r) r = pos_inf_of<C>();
      m = r < m ? r : m;
    }
    if (dn == ninf) m = ninf;
    atomicMax(red, encode_key(m));
  }
  __syncthreads();
  if (tid == 0) out[b] = A::store(decode_key(*red));
}

// grid (B, 2): y = 0 follows arcs src -> dst, y = 1 dst -> src.
template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
reach_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
             const uint8_t* __restrict__ present, uint8_t* __restrict__ out,
             int B, int E, int N) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  int32_t* s_take = reinterpret_cast<int32_t*>(smem_raw);
  int32_t* s_seg = s_take + (kStaged ? E : 0);  // -1 marks an absent arc
  volatile uint8_t* r = reinterpret_cast<volatile uint8_t*>(s_seg + (kStaged ? E : 0));

  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t b = blockIdx.x;
  const bool backward = blockIdx.y == 1;
  const int32_t* g_take = (backward ? dst : src) + b * E;
  const int32_t* g_seg = (backward ? src : dst) + b * E;
  const uint8_t* g_p = present + b * E;

  for (int v = tid; v < N; v += nt) r[v] = v == 0;
  for (int e = tid; e < E; e += nt) {
    const int32_t t = g_take[e], s = g_seg[e];
    if ((unsigned)t >= (unsigned)N || (unsigned)s >= (unsigned)N) __trap();
    if (kStaged) {
      s_take[e] = t;
      s_seg[e] = g_p[e] ? s : -1;
    }
  }
  __syncthreads();

  // In place: a hop may already see vertices set earlier in the same hop,
  // which only reaches the fixpoint sooner.
  for (int hop = 0; hop < N - 1; ++hop) {
    int changed = 0;
    for (int e = tid; e < E; e += nt) {
      const int32_t s = kStaged ? s_seg[e] : (g_p[e] ? g_seg[e] : -1);
      if (s < 0) continue;
      const int32_t t = kStaged ? s_take[e] : g_take[e];
      if (r[t] && !r[s]) {
        r[s] = 1;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  __syncthreads();
  uint8_t* o = out + ((int64_t)blockIdx.y * B + b) * N;
  for (int v = tid; v < N; v += nt) o[v] = r[v];
}

int threads_for(int64_t work) {
  const int64_t t = ((work + 31) / 32) * 32;
  return (int)(t < 64 ? 64 : (t > kMaxThreads ? kMaxThreads : t));
}

// The opt-in shared-memory limit of the current device.  Nothing here is
// cached across calls: the limit and a kernel's granted size belong to a
// device, and a process may launch on more than one card.
size_t max_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return kDefaultSmem;
  return (size_t)bytes;
}

// Allow `bytes` of dynamic shared memory for `kernel` on the current
// device (needed above 48 KB), at every launch that needs it, as K3 and K4
// do: the attribute is per device, so a size remembered from one card
// would skip it on another.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
cudaError_t launch_karp(const void* src, const void* dst, const void* w, void* levels, void* out,
                        int64_t B, int64_t E, int64_t N, cudaStream_t stream) {
  using C = typename Arith<T>::C;
  using Key = KeyOf<T>;
  const size_t level_bytes = (size_t)(3 * N + 1) * sizeof(Key);
  const size_t staged_bytes = level_bytes + (size_t)E * (sizeof(C) + 2 * sizeof(int32_t));
  const size_t cap = max_smem_optin();
  if (level_bytes > cap) return cudaErrorInvalidValue;
  const bool staged = staged_bytes <= cap;
  const size_t smem = staged ? staged_bytes : level_bytes;
  auto kernel = staged ? &karp_kernel<T, true> : &karp_kernel<T, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)B, threads_for(E > N ? E : N), smem, stream>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const T*>(w), static_cast<T*>(levels), static_cast<T*>(out), (int)E, (int)N);
  return cudaGetLastError();
}

// One block per chain c.  src and dst are read from global memory every
// round (L1-resident at MATCHA's sizes): staging them in shared memory
// measured 1.5 % faster at Ebone's design shape and 1.6 % slower at the
// engine shape on an H100 (scripts/port_timing_ab.py), so it is not kept.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
timing_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
              const T* __restrict__ w, const int32_t* __restrict__ ids,
              const T* __restrict__ t0, T* __restrict__ out, int R, int U, int E, int N) {
  using A = Arith<T>;
  using C = typename A::C;
  using Key = KeyOf<T>;
  extern __shared__ __align__(8) unsigned char smem_raw[];
  Key* keys = reinterpret_cast<Key*>(smem_raw);      // 3 buffers of N keys
  int* stamp = reinterpret_cast<int*>(keys + 3 * N);  // 2 buffers of N rounds

  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t c = blockIdx.x;
  const int32_t* g_ids = ids + c * R;
  T* o = out + c * (int64_t)(R + 1) * N;
  const C ninf = neg_inf_of<C>();
  const Key kneg = encode_key(ninf);

  for (int v = tid; v < N; v += nt) {
    const C x = t0 ? A::load(t0[c * N + v]) : C(0);
    keys[v] = encode_key(x);
    keys[N + v] = kneg;
    keys[2 * N + v] = kneg;
    stamp[v] = -1;
    stamp[N + v] = -1;
    o[v] = A::store(x);
  }
  for (int e = tid; e < E; e += nt)
    if ((unsigned)src[e] >= (unsigned)N || (unsigned)dst[e] >= (unsigned)N) __trap();
  for (int k = tid; k < R; k += nt)
    if ((unsigned)g_ids[k] >= (unsigned)U) __trap();
  __syncthreads();
  // round 0's self-loop stamps
  if (R > 0) {
    const T* w0 = w + (int64_t)g_ids[0] * E;
    for (int e = tid; e < E; e += nt) {
      const int32_t s = src[e], d = dst[e];
      if (s == d && A::load(w0[e]) > ninf) stamp[d] = 0;
    }
  }
  __syncthreads();

  // Round k reads t(k) from cur, folds t(k+1) into nxt, resets spare (read
  // in round k-1, so free since the last barrier), stores t(k) to out
  // (row 0 is stored above) and stamps round k+1's self-loops.
  Key* cur = keys;
  Key* nxt = keys + N;
  Key* spare = keys + 2 * N;
  for (int k = 0; k < R; ++k) {
    const T* wk = w + (int64_t)g_ids[k] * E;
    const int* st = stamp + (k & 1) * N;
    int* st_next = stamp + ((k + 1) & 1) * N;
    const T* wn = k + 1 < R ? w + (int64_t)g_ids[k + 1] * E : nullptr;
    for (int e = tid; e < E; e += nt) {
      const int32_t s = src[e], d = dst[e];
      const C x = A::add(decode_key(cur[s]), A::load(wk[e]));
      if (!(x == ninf)) atomicMax(&nxt[d], encode_key(x));
      if (wn && s == d && A::load(wn[e]) > ninf) st_next[d] = k + 1;
    }
    for (int v = tid; v < N; v += nt) {
      if (st[v] != k) atomicMax(&nxt[v], cur[v]);  // no present self-loop: carry t_v(k)
      spare[v] = kneg;
      if (k >= 1) o[(int64_t)k * N + v] = A::store(decode_key(cur[v]));
    }
    __syncthreads();
    Key* t = cur;
    cur = nxt;
    nxt = spare;
    spare = t;
  }
  if (R > 0)
    for (int v = tid; v < N; v += nt) o[(int64_t)R * N + v] = A::store(decode_key(cur[v]));
}

template <typename T>
size_t timing_level_bytes(int64_t N) {
  return (size_t)N * (3 * sizeof(KeyOf<T>) + 2 * sizeof(int));
}

template <typename T>
cudaError_t launch_timing(const void* src, const void* dst, const void* w, const void* ids,
                          const void* t0, void* out, int64_t C, int64_t R, int64_t U, int64_t E,
                          int64_t N, cudaStream_t stream) {
  const size_t smem = timing_level_bytes<T>(N);
  if (smem > max_smem_optin()) return cudaErrorInvalidValue;
  auto kernel = &timing_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)C, threads_for(E > N ? E : N), smem, stream>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const T*>(w), static_cast<const int32_t*>(ids), static_cast<const T*>(t0),
      static_cast<T*>(out), (int)R, (int)U, (int)E, (int)N);
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

// levels is a contiguous [B, N, N] scratch of w's type (rows 0..N-2 of
// each batch row are written), out is [B]; src and dst are int32 in [0, N).
extern "C" int karp_cycle_time_launch(const void* src, const void* dst, const void* w,
                                      void* levels, void* out, int64_t B, int64_t E,
                                      int64_t N, int dtype, void* stream) {
  if (B < 0 || E < 0 || N < 1 || E > 0x7fffffffLL || N > 0x7fffffffLL / N ||
      B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_karp<float>(src, dst, w, levels, out, B, E, N, s);
    case 1: return (int)launch_karp<double>(src, dst, w, levels, out, B, E, N, s);
    case 2: return (int)launch_karp<__half>(src, dst, w, levels, out, B, E, N, s);
    case 3: return (int)launch_karp<__nv_bfloat16>(src, dst, w, levels, out, B, E, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// src, dst are int32 [B, E] in [0, N), present is [B, E] bytes (non-zero
// for a present arc), out is [2, B, N] bytes: forward, then backward.
extern "C" int reach_launch(const void* src, const void* dst, const void* present, void* out,
                            int64_t B, int64_t E, int64_t N, void* stream) {
  if (B < 0 || E < 0 || N < 1 || E > 0x7fffffffLL || N > 0x7fffffffLL || B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const size_t flag_bytes = (size_t)N;
  const size_t staged_bytes = (size_t)E * 2 * sizeof(int32_t) + flag_bytes;
  const size_t cap = max_smem_optin();
  if (flag_bytes > cap) return (int)cudaErrorInvalidValue;
  const bool staged = staged_bytes <= cap;
  const size_t smem = staged ? staged_bytes : flag_bytes;
  auto kernel = staged ? &reach_kernel<true> : &reach_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)B, 2);
  kernel<<<grid, threads_for(E > N ? E : N), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const uint8_t*>(present), static_cast<uint8_t*>(out), (int)B, (int)E, (int)N);
  return (int)cudaGetLastError();
}

// w is contiguous [U, E] (dtype 0 = float32, 1 = float64), src and dst are
// int32 [E] in [0, N), ids int32 [C, R] in [0, U), t0 [C, N] of w's type
// or null for zeros, out [C, R+1, N] of w's type.  Nothing is launched
// when C is 0.
extern "C" int timing_recursion_launch(const void* src, const void* dst, const void* w,
                                       const void* ids, const void* t0, void* out, int64_t C,
                                       int64_t R, int64_t U, int64_t E, int64_t N, int dtype,
                                       void* stream) {
  if (C < 0 || R < 0 || U < 0 || E < 1 || N < 1 || C > 0x7fffffffLL || R > 0x7fffffffLL ||
      U > 0x7fffffffLL || E > 0x7fffffffLL || N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_timing<float>(src, dst, w, ids, t0, out, C, R, U, E, N, s);
    case 1: return (int)launch_timing<double>(src, dst, w, ids, t0, out, C, R, U, E, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The most nodes a timing recursion of this dtype can hold in the current
// device's shared memory (its three key buffers and two stamp buffers).
extern "C" int64_t timing_recursion_max_nodes(int dtype) {
  const size_t per_node = dtype == 1 ? timing_level_bytes<double>(1) : timing_level_bytes<float>(1);
  return (int64_t)(max_smem_optin() / per_node);
}

extern "C" const char* segment_max_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
