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
// dst) and backward (dst -> src): out [2, B, N] of 0/1 bytes, in one
// launch laid out by segment_max.py::reach_plan (adjacency bitsets for
// N <= 1024, the hop kernel past that).
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
// a row's running maxima are folded with atomicMax: O(E) work per row.
// atomicMax exists for unsigned integers only, so each value is mapped to
// an order-preserving unsigned key (flip all bits of a negative float, set
// the sign bit of a non-negative one): a < b as floats iff key(a) < key(b)
// as unsigned.  NaN is first made the canonical quiet NaN, whose key lies
// above +inf's, so it wins every max.  -0.0 keys just below +0.0: the two
// differ only in sign, and max(-0, +0) = +0 here while the plain version
// may return either.  16-bit inputs key their own 16 bits the same way
// (exact: max only picks a value, and decoding gives the pick's bits
// back).  Max is exact and order-free, so the result depends neither on
// the atomics' order nor on how the edges are split.
//
// The standalone segment max (segment_max_kernel) spreads a row over a
// thread-block cluster of 1, 2, 4 or 8 CTAs (segment_max.py::
// segment_max_plan: B * cs within one wave of the SMs, at least 512 edges
// a CTA), each folding a contiguous slice of the row, four edges a thread
// by 16-byte vector loads where the slice is long (an edge a thread
// else).  While a row has no more segments than edges and its S keys fit
// a CTA's shared memory, every CTA folds into its own copy with
// shared-memory atomics, and after one cluster barrier each reduces its
// 1/cs of the segments over its peers' copies (DSMEM) and writes them
// once; otherwise the keys live in `out` itself (native u32 and u64
// global atomicMax, a CAS loop for a 16-bit word), set before and decoded
// after the fold, each side of a cluster barrier, and a warp aggregates
// its lanes' runs of equal ids before the global atomics.  Either way
// each edge is read once.
//
// The Karp recursion is one launch: one block per graph row runs every
// level of the chain.  The row's arcs are staged in shared memory once
// (read from global memory each level when they do not fit), the running
// level lives in shared memory as keys, and a block barrier stands where
// the per-level path launched a kernel.  Karp rotates three key buffers (read
// D_{k-1}, fold into D_k, reset the third), so a level costs one pass over
// the arcs and one barrier; each finished level goes to a [B, N, N]
// scratch in global memory (L2-resident at the climb's sizes) for the
// final formula, which the same block evaluates.  Each add, subtraction
// and division is done in the input type, round-to-nearest, with
// explicit __fadd_rn/__fdiv_rn-style intrinsics so nothing contracts;
// 16-bit inputs compute in float and round once to their type, as torch
// does, so the result equals the plain version bit for bit.
//
// Reachability is one launch too, with two layouts (segment_max.py::
// reach_plan).  For N <= 1024 (every main-path call: Ebone's 87 nodes,
// Gaia's 11, the WAN's clusters) a row and direction's out-adjacency is N
// bitsets of W = ceil(N / 32) words in shared memory (N^2 / 8 bytes, 128
// KB at N = 1024), built with one shared-memory atomicOr a present arc
// after the arcs are read once from global memory, so any E takes it;
// then one warp traverses, lane l holding word l of the reached set R and
// of the pending set P, as a worklist: each step pops the highest pending
// vertex v (bfind a lane, redux.max over the warp), ORs word l of v's
// row into R and its new vertices into P, until no lane pends.  Every
// reached vertex is expanded once, each row read once, and a step is a
// few warp instructions with no block barrier, where the hop kernel (kept
// for N > 1024) walks every arc of the row and meets a 32-warp barrier at
// each hop.  Where two sets of bitsets fit, a CTA holds both directions
// of a row (two traversals, a warp each) and reads its arcs once for
// both.  The hop kernel sets a byte per vertex, in place, and stops at
// the first hop that changes nothing (__syncthreads_or).  R only grows
// either way, so the fixpoint is the same set that N - 1 synchronous hops
// reach.  An id outside [0, N) in any recursion, or a round id outside
// [0, U), stops the kernel (__trap), which the caller sees as a CUDA
// error at the next synchronise, as with torch's own indexing kernels.
//
// The timing recursion spreads each chain over a thread-block cluster of
// cs CTAs (cs in {1, 2, 4, 8} and the split of the arcs come from
// segment_max.py::timing_plan: C * cs up to the card's SMs while each CTA
// keeps at least 256 arcs and its inbox fits).  CTA r folds a contiguous
// 1/cs of the arcs, which it groups by dst once, with a counting sort in
// shared memory.  The weights of round k+1 do not depend on t(k), so the
// block's last warp (the producer) fetches the CTA's slice of each round's
// weight row `stages` rounds ahead (2 to 4) into a shared-memory ring: one
// bulk copy (TMA, cp.async.bulk) of the 16-byte-aligned window around the
// slice, on one mbarrier a slot, plus a cp.async of the last elements
// where the window would pass the end of w (a row of odd E in float64
// starts 8 bytes off a 16-byte boundary; the window is rounded out, and
// the slice's offset in it is kept beside the slot).  The producer also
// writes the CTA's 1/cs of the nodes of each t(k) to out.  The other warps
// (the consumers) fold: a group of G lanes per dst (G the power of two up
// to 32 below the CTA's mean arcs a dst) takes its arcs' t_u(k) + w, a
// running max of order-preserving keys a lane, then the group's max and
// the OR of its present self-loops by redux or shuffles: the CTA's partial
// for that dst, with no atomic.  With cs > 1 the group's first lane pushes
// {partial, flag} into every CTA's inbox with st.async, which completes
// its bytes on the receiving CTA's inbox mbarrier; each CTA arms that
// barrier for the round's bytes, waits on it, and reduces its inbox into
// its own copy of t(k+1): the max of the cs partials, with the carry
// t_v(k) when no CTA flagged v.  A round thus needs no cluster barrier and
// no fence: the barrier.cluster round (a release in every warp is a
// GPU-scope MEMBAR that also waits for the stores to out) and the DSMEM
// reads after it cost more than the fold.  Inboxes alternate by round
// parity; a CTA pushes round k+2 only after it received every CTA's round
// k+1, which each sent after reducing round k, so no slot is overwritten
// before it is read.  With cs = 1 the partials stay in shared memory
// behind a block barrier.  A plan whose slice does not fit shared memory
// (E past about 9,000 arcs a CTA in float64, or N near its limit) reads
// arcs and weights from global memory in the fold instead, one
// shared-memory atomicMax an arc, and pushes every node's partial after a
// consumer barrier (stages = 0).  Every add is __dadd_rn (or __fadd_rn)
// and max is exact and order-free, so any split or order of the arcs gives
// the plain version's and the reference's numpy host engine's bits.
//
// Bound.  The standalone kernel reads each value and id once and writes
// each output once, (B*E*(sizeof(T) + 4) + B*S*sizeof(T)) bytes, with one
// compare per edge: memory-bound on paper, and at the design climb's
// shape (B = 16, E = 261, S = 87) far below what a launch costs.  The
// Karp score's least time is the larger of its bytes (B*E*(sizeof(T) + 8)
// read, B*sizeof(T) written) and its operations (2*B*N*E adds and maxima
// plus 3*B*N*N for the final formula); its real floor is the chain of N
// dependent levels, one barrier and one pass over the row's arcs each,
// which no amount of parallelism across rows removes.  Reachability's
// least time is its bytes, src, dst and present read once (9 bytes an
// arc: one copy on chip serves both directions and every step) and
// 2*B*N flags written; its real floor is the bitset kernel's chain of
// steps, one a reached vertex (N at most), each a dependent shared-memory
// load, lop3, bfind and redux (PERF.md has the measured ns a step).  The
// timing recursion's least time is the larger of its bytes (the U*E*sizeof(T)
// distinct weight rows, E*8 arc ids and C*R*4 round ids read once,
// C*(R+1)*N*sizeof(T) written) and its operations (2*C*R*E adds and
// maxima).  Its weights are not cache-resident (U*E*8 is 190.8 MB at
// Ebone's design shape, past the 50 MB L2), which is why they are fetched
// ahead of the chain; what the chain itself costs is R times one cluster
// barrier, one block barrier, one pass over a CTA's arcs in shared memory
// and the DSMEM reduce of N nodes (PERF.md has the measured ms a round).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// The hop layout of reachability (N > 1024, or forced): grid (B, 2), y = 0
// follows arcs src -> dst, y = 1 dst -> src.
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

// The bitset layout of reachability (N <= 1024): a traversal's out-
// adjacency as N bitsets of W = ceil(N / 32) words in shared memory, and
// one warp a traversal, lane l holding word l of the reached set R and of
// the pending set P (reached, not yet expanded).  rows == 1: grid (B, 2),
// CTA (b, y) holds direction y of row b.  rows == 2: grid B, CTA b holds
// both directions of row b (each arc read once for both), warp y
// traversing direction y.
constexpr int kReachMaxBitsetNodes = 1024;  // one 32-bit word a lane
constexpr int kReachArcsPerThread = 4;      // arc loads in flight a thread

__global__ void __launch_bounds__(kMaxThreads)
reach_bitset_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
                    const uint8_t* __restrict__ present, uint8_t* __restrict__ out,
                    int B, int E, int N, int rows) {
  extern __shared__ __align__(16) unsigned int adj[];  // rows x N x W words
  const int W = (N + 31) >> 5;
  const int per = N * W;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x;
  const int y0 = rows == 1 ? (int)blockIdx.y : 0;

  // Build: zero the bitsets (16 bytes a store), one barrier, then one
  // shared-memory atomicOr a present arc and direction, each thread's
  // next four arcs loaded before any is used.
  const int total = rows * per;
  uint4* adj4 = reinterpret_cast<uint4*>(adj);
  for (int i = tid; i < (total >> 2); i += nt) adj4[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = (total & ~3) + tid; i < total; i += nt) adj[i] = 0u;
  __syncthreads();
  const int64_t off = (int64_t)b * E;
  for (int e0 = tid; e0 < E; e0 += kReachArcsPerThread * nt) {
    int32_t s[kReachArcsPerThread], d[kReachArcsPerThread];
    uint8_t p[kReachArcsPerThread];
#pragma unroll
    for (int k = 0; k < kReachArcsPerThread; ++k) {
      const int e = e0 + k * nt;
      s[k] = e < E ? src[off + e] : 0;
      d[k] = e < E ? dst[off + e] : 0;
      p[k] = e < E ? present[off + e] : 0;
    }
#pragma unroll
    for (int k = 0; k < kReachArcsPerThread; ++k) {
      if ((unsigned)s[k] >= (unsigned)N || (unsigned)d[k] >= (unsigned)N) __trap();
      if (!p[k]) continue;
      if (rows == 1) {
        const int t = y0 ? d[k] : s[k], g = y0 ? s[k] : d[k];  // the arc t -> g
        atomicOr(&adj[t * W + (g >> 5)], 1u << (g & 31));
      } else {
        atomicOr(&adj[s[k] * W + (d[k] >> 5)], 1u << (d[k] & 31));
        atomicOr(&adj[per + d[k] * W + (s[k] >> 5)], 1u << (s[k] & 31));
      }
    }
  }
  __syncthreads();

  // Traverse: no block barrier from here on, so the other warps leave.
  const int warp = tid >> 5, lane = tid & 31;
  if (warp >= rows) return;
  const int y = rows == 1 ? y0 : warp;
  // A worklist, one vertex a step: pop the highest pending vertex v (each
  // lane's highest pending bit by bfind, the warp's maximum by redux), OR
  // word l of v's row into R and its new vertices into P.  Every reached
  // vertex is expanded once, in whatever order, so R ends at the same
  // fixpoint as N - 1 synchronous hops; a step is one dependent chain of a
  // shared-memory load, a lop3, a bfind and a redux, with no vote or
  // shuffle.  (A level at a time, its vertices enumerated by ballot,
  // shuffle and __ffs, cost twice as much a level on a path.)  Lanes past
  // W read a copy of word W - 1 (in bounds) and hold R full, so they never
  // pend.  The load and the three-input lop3 are PTX: the compiler would
  // split P & m | row & ~R into two dependent logic ops on the chain.
  const uint32_t base = static_cast<uint32_t>(
      __cvta_generic_to_shared(adj + warp * per + (lane < W ? lane : W - 1)));
  const uint32_t stride = static_cast<uint32_t>(W) * 4u;
  const unsigned int hi = static_cast<unsigned int>(lane) << 5;
  unsigned int reached = lane < W ? (lane == 0 ? 1u : 0u) : 0xffffffffu;
  unsigned int pending = lane == 0 ? 1u : 0u;
  int v = 0;
  while (v >= 0) {
    const unsigned int pm = pending & (lane == (v >> 5) ? ~(1u << (v & 31)) : 0xffffffffu);
    unsigned int row, top;
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(row) : "r"(base + (uint32_t)v * stride));
    asm("lop3.b32 %0, %1, %2, %3, 0xF4;" : "=r"(pending) : "r"(pm), "r"(row), "r"(reached));
    reached |= row;
    asm("bfind.u32 %0, %1;" : "=r"(top) : "r"(pending));  // 0xffffffff: nothing pends
    v = __reduce_max_sync(0xffffffffu, static_cast<int>(top | hi));
  }

  // Write: a word at a time, one byte a lane (32 consecutive bytes a store).
  uint8_t* o = out + ((int64_t)y * B + b) * N;
  for (int c = 0; c < W; ++c) {
    const unsigned int word = __shfl_sync(0xffffffffu, reached, c);
    const int u = (c << 5) + lane;
    if (u < N) o[u] = (uint8_t)((word >> lane) & 1u);
  }
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

// ---------------------------------------------------------------------------
// The round-varying Eq. 4 timing recursion: one thread-block cluster a chain

constexpr int kMaxStages = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Spin until the barrier has completed its phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Arrive on the barrier (release) and add `bytes` to the transfer count its
// current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// A bulk copy (TMA, no tensor map) of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from global to shared memory, completing on
// the barrier's transfer count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One element from global to shared memory, asynchronously (4 or 8 bytes).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(kBytes)
               : "memory");
}

// The barrier's current phase counts this thread's arrival once every
// cp.async it has issued so far has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// The address that `addr` of this CTA's shared memory has in CTA `rank`'s
// (distributed shared memory).
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ int ld_cluster(uint32_t a) {
  int x;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(x) : "r"(a));
  return x;
}

// The barrier across the cluster, used once before the rounds and once
// after them: the block barrier orders every thread's shared-memory
// accesses before thread 0's cluster-scope fence, whose cumulativity
// publishes them to the cluster before its relaxed arrival.
__device__ __forceinline__ void cluster_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Store {key, flag} into another CTA's shared memory (both addresses in
// the cluster's window); the store completes its bytes on that CTA's
// mbarrier, which is what orders it for the reader: no fence, no barrier.
__device__ __forceinline__ void push(uint32_t slot, unsigned long long key, unsigned long long flag,
                                     uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u64 [%0], {%1, %2}, [%3];\n" ::"r"(
          slot),
      "l"(key), "l"(flag), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void push(uint32_t slot, unsigned int key, unsigned int flag,
                                     uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];\n" ::"r"(
          slot),
      "r"(key), "r"(flag), "r"(bar)
      : "memory");
}

// Wait for the phase of the given parity, acquiring what completed it.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The largest key of a whole warp: redux on the high 32 bits, then on the
// low 32 bits of the lanes that hold the high maximum.
__device__ __forceinline__ unsigned long long warp_max(unsigned long long key) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned mhi = __reduce_max_sync(0xffffffffu, hi);
  const unsigned mlo = __reduce_max_sync(0xffffffffu, hi == mhi ? lo : 0u);
  return ((unsigned long long)mhi << 32) | mlo;
}

__device__ __forceinline__ unsigned int warp_max(unsigned int key) {
  return __reduce_max_sync(0xffffffffu, key);
}

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared memory of one CTA (segment_max.py::timing_smem_bytes mirrors it).
// The head: `stages` ring mbarriers, two inbox mbarriers, `stages` slot
// offsets and three counts.  The nodes: with cs > 1 an inbox of two
// rounds x cs CTAs x N {key, flag} slots (every CTA's partials of a round,
// pushed by the CTAs themselves), then two start-time buffers, and one
// partial-key and one flag buffer of N each.  With stages > 0: the CTA's
// arcs grouped by dst (N + 2 offsets, the N nodes they reach, (src, slice
// index) pairs) and a ring of `stages` slots, each the slice's
// 16-byte-aligned window of a weight row.
__host__ __device__ constexpr size_t timing_head_bytes(int stages) {
  return align16(12 * (size_t)stages + 16 + 12);
}

template <typename T>
__host__ __device__ size_t timing_node_bytes(int64_t N, int64_t cs) {
  using Key = KeyOf<T>;
  const size_t inbox = cs > 1 ? (size_t)4 * cs * N * sizeof(Key) : 0;
  return align16(inbox + (size_t)N * (2 * sizeof(typename Arith<T>::C) + sizeof(Key) + 1));
}

template <typename T>
__host__ __device__ size_t timing_slot_bytes(int64_t A) {
  return align16((size_t)A * sizeof(T)) + 16;
}

__host__ __device__ constexpr size_t timing_csr_bytes(int64_t N) {
  return align16((size_t)(2 * N + 2) * 4);
}

template <typename T>
size_t timing_smem_bytes(int64_t N, int64_t A, int stages, int64_t cs) {
  size_t b = timing_head_bytes(stages) + timing_node_bytes<T>(N, cs);
  if (stages > 0)
    b += timing_csr_bytes(N) + align16((size_t)A * 8) + (size_t)stages * timing_slot_bytes<T>(A);
  return b;
}

// One cluster of cs CTAs per chain (cs is the cluster's size, chosen by the
// caller); CTA `rank` folds arcs [rank*A, rank*A + A) of every round.
// kStaged: its arcs sit in shared memory grouped by dst, each round's
// weight slice is prefetched `stages` rounds ahead into a ring, and a group
// of G lanes folds each dst's arcs into one partial key with no atomic;
// else arcs and weights are read from global memory in the fold, one
// atomicMax an arc (shapes whose slice does not fit).  With cs > 1 each
// CTA pushes its partials into every CTA's inbox with st.async, and waits
// on its own inbox mbarrier for the cluster's: a round needs no cluster
// barrier.  The last warp of the block is the producer: its lane 0 copies
// each round's slice into the ring, and the warp stores each finished t(k)
// to out for this CTA's share of the nodes, off the chain.  The other
// warps, the consumers, fold and reduce.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
timing_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
              const T* __restrict__ w, const int32_t* __restrict__ ids,
              const T* __restrict__ t0, T* __restrict__ out, int R, int U, int E, int N, int A,
              int stages) {
  using Ar = Arith<T>;
  using C = typename Ar::C;
  using Key = KeyOf<T>;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char timing_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  uint64_t* bar = reinterpret_cast<uint64_t*>(timing_smem);  // the ring's
  uint64_t* ibar = bar + stages;                             // the inbox's, by round parity
  int* shift = reinterpret_cast<int*>(ibar + 2);             // where slot j's slice starts
  int* n_dst = shift + stages;                               // the nodes this CTA's arcs reach
  int* sends = n_dst + 1;                                    // the partials it pushes a round
  int* expect = sends + 1;                                   // the bytes its inbox takes a round
  unsigned char* nodes = timing_smem + timing_head_bytes(stages);
  Key* inbox = reinterpret_cast<Key*>(nodes);  // [2][cs][N] {key, flag}, with cs > 1
  C* tv = reinterpret_cast<C*>(nodes + (cs > 1 ? (size_t)4 * cs * N * sizeof(Key) : 0));
  Key* part = reinterpret_cast<Key*>(tv + 2 * N);         // N partial keys
  uint8_t* pflag = reinterpret_cast<uint8_t*>(part + N);  // N flags
  // dst v's arcs are s_arc[beg[v+1] .. beg[v+2]) once grouped; vlist
  // holds the *n_dst nodes that have any
  int* beg = reinterpret_cast<int*>(nodes + timing_node_bytes<T>(N, cs));
  int* vlist = beg + N + 2;
  int2* s_arc = reinterpret_cast<int2*>(reinterpret_cast<unsigned char*>(beg) +
                                        timing_csr_bytes(N));
  unsigned char* ring = reinterpret_cast<unsigned char*>(s_arc) + align16((size_t)A * 8);
  const size_t slot_bytes = timing_slot_bytes<T>(A);

  const int tid = threadIdx.x, lane = tid & 31;
  const int nc = blockDim.x - 32;  // consumer threads; the last warp is the producer
  const bool producer = tid >= nc;
  const int64_t c = blockIdx.x / cs;
  const int64_t lo64 = (int64_t)rank * A, hi64 = lo64 + A;
  const int lo = (int)(lo64 < E ? lo64 : E);
  const int n = (int)(hi64 < E ? hi64 : E) - lo;  // this CTA's arcs
  const int ns = (N + cs - 1) / cs;               // the nodes it writes out
  const int v_lo = rank * ns < N ? rank * ns : N;
  const int v_hi = v_lo + ns < N ? v_lo + ns : N;
  const int32_t* g_ids = ids + c * R;
  T* o = out + c * (int64_t)(R + 1) * N;
  const C ninf = neg_inf_of<C>();
  const Key kneg = encode_key(ninf);

  if (tid == 0) {
    for (int j = 0; j < stages; ++j) mbar_init(&bar[j], 2);
    mbar_init(&ibar[0], 1);
    mbar_init(&ibar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int v = tid; v < N; v += blockDim.x) {
    tv[v] = t0 ? Ar::load(t0[c * N + v]) : C(0);
    part[v] = kneg;
    pflag[v] = 0;
  }
  if (cs > 1)
    for (int i = tid; i < 2 * cs * N; i += blockDim.x) {
      inbox[2 * i] = kneg;
      inbox[2 * i + 1] = 0;
    }
  if (kStaged)
    for (int v = tid; v < N + 2; v += blockDim.x) beg[v] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) {
    const int32_t s = src[lo + i], d = dst[lo + i];
    if ((unsigned)s >= (unsigned)N || (unsigned)d >= (unsigned)N) __trap();
    if (kStaged) atomicAdd(&beg[d + 1], 1);
  }
  __syncthreads();
  // Group the arcs by dst (a counting sort, once a call): warp 0 turns the
  // counts into each dst's end and lists the nodes that have arcs, then
  // each arc takes a place by counting its dst's end down, which leaves
  // beg[v+1] at dst v's start.  The order within a dst does not matter.
  if (tid < 32) {
    int total = 0, listed = 0;
    for (int v0 = 0; kStaged && v0 < N; v0 += 32) {
      const int v = v0 + lane;
      const int cnt = v < N ? beg[v + 1] : 0;
      int x = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (v < N) beg[v + 1] = total + x;
      const unsigned has = __ballot_sync(0xffffffffu, cnt > 0);
      if (cnt > 0) vlist[listed + __popc(has & ((1u << lane) - 1))] = v;
      total += __shfl_sync(0xffffffffu, x, 31);
      listed += __popc(has);
    }
    if (lane == 0) {
      *n_dst = listed;
      *sends = kStaged ? listed : N;  // read in place, every node's partial is pushed
      if (kStaged) beg[N + 1] = n;
    }
  }
  __syncthreads();
  if (kStaged)
    for (int i = tid; i < n; i += blockDim.x) {
      const int d = dst[lo + i];
      s_arc[atomicSub(&beg[d + 1], 1) - 1] = make_int2(src[lo + i], i);
    }

  // Round j's slice of row ids[c, j] into ring slot j % stages, by the
  // producer's lane 0: the 16-byte-aligned window around it by one bulk
  // copy, and where the window would pass the end of w (a last row whose
  // bytes are not a multiple of 16), those last elements by cp.async.  The
  // slot's barrier completes a phase once both have landed.
  const size_t w_end16 = ((size_t)U * E * sizeof(T)) & ~size_t(15);
  auto prefetch = [&](int j, int32_t u) {
    if ((unsigned)u >= (unsigned)U) __trap();
    const int sl = j % stages;
    unsigned char* slot = ring + sl * slot_bytes;
    const size_t b0 = ((size_t)u * E + lo) * sizeof(T), b1 = b0 + (size_t)n * sizeof(T);
    const size_t a0 = b0 & ~size_t(15);
    const size_t a1 = align16(b1) < w_end16 ? align16(b1) : (w_end16 > a0 ? w_end16 : a0);
    const unsigned char* wb = reinterpret_cast<const unsigned char*>(w);
    shift[sl] = (int)((b0 - a0) / sizeof(T));
    for (size_t b = a1 > b0 ? a1 : b0; b < b1; b += sizeof(T))
      cp_async<sizeof(T)>(slot + (b - a0), wb + b);
    mbar_arrive_expect_tx(&bar[sl], (uint32_t)(a1 - a0));
    if (a1 > a0) bulk_copy(slot, wb + a0, (uint32_t)(a1 - a0), &bar[sl]);
    cp_async_arrive(&bar[sl]);
  };
  int32_t u_ahead = 0;  // the round id of the next prefetch, read a round before it
  if (kStaged && producer && lane == 0) {
    for (int j = 0; j < stages && j < R; ++j) prefetch(j, g_ids[j]);
    if (stages < R) u_ahead = g_ids[stages];
  }
  if (cs > 1) {
    cluster_barrier();  // every CTA has started, set its inbox and counted its pushes
    if (tid == 0) {
      int bytes = 0;
      for (int r = 0; r < cs; ++r)
        bytes += ld_cluster(map_rank(smem_addr(sends), r)) * (int)(2 * sizeof(Key));
      *expect = bytes;
    }
  }
  __syncthreads();

  // G: the lanes a dst, the power of two up to 32 nearest below the
  // CTA's mean arcs a dst (grouped arcs only)
  const int m = *n_dst;
  int G = 1;
  while (G < 32 && 2 * G * (m > 0 ? m : 1) <= n) G *= 2;
  // a partial (key, flag) for node v of round k: with cs > 1 into slot
  // [k&1][rank][v] of every CTA's inbox, else into part and pflag
  auto deliver = [&](int k, int v, Key key, Key flag) {
    if (cs > 1) {
      const uint32_t slot = smem_addr(inbox + 2 * (((size_t)(k & 1) * cs + rank) * N + v));
      const uint32_t b = smem_addr(&ibar[k & 1]);
      for (int r = 0; r < cs; ++r) push(map_rank(slot, r), key, flag, map_rank(b, r));
    } else {
      part[v] = key;
      pflag[v] = (uint8_t)flag;
    }
  };

  // Round k: the consumers fold this CTA's arcs of t(k) (cur) into
  // partials, flagging present self-loops, while the producer refills
  // round k-1's slot with round k-1+stages and stores t(k) to out.  With
  // cs > 1 each partial goes to every CTA's inbox and a consumer waits for
  // its own inbox's round; with cs = 1 a block barrier.  Then the consumers
  // reduce every node's partials and flags into t(k+1) (nxt), with the
  // carry t_v(k) where no CTA saw a present self-loop at v; one block
  // barrier.
  C* cur = tv;
  C* nxt = tv + N;
  for (int k = 0; k < R; ++k) {
    if (cs > 1 && tid == 0) mbar_arrive_expect_tx(&ibar[k & 1], (uint32_t)*expect);
    if (producer) {
      // round k-1's slot is free (every consumer folded round k-1 before
      // the last barrier): fill it with round k-1+stages, while the
      // consumers fold round k
      if (kStaged && lane == 0 && k >= 1 && k - 1 + stages < R) {
        const int32_t u = u_ahead;
        if (k + stages < R) u_ahead = g_ids[k + stages];
        prefetch(k - 1 + stages, u);
      }
      for (int v = v_lo + lane; v < v_hi; v += 32) o[(int64_t)k * N + v] = Ar::store(cur[v]);
    } else if (kStaged) {
      const int sl = k % stages;
      mbar_wait(&bar[sl], (k / stages) & 1);
      const T* wk = reinterpret_cast<const T*>(ring + sl * slot_bytes) + shift[sl];
      // a group of G lanes a dst: each lane folds every G-th of its arcs,
      // the group's max by redux (a whole warp) or shuffles, and its first
      // lane delivers the CTA's partial (the whole CTA's max at v)
      for (int q0 = 0; q0 < m; q0 += nc / G) {  // whole warps, for the shuffles
        const int q = q0 + tid / G;
        int v = -1;
        Key key = kneg;
        unsigned present = 0;
        if (q < m) {
          v = vlist[q];
          for (int j = beg[v + 1] + (tid & (G - 1)); j < beg[v + 2]; j += G) {
            const int2 a = s_arc[j];
            const C wv = Ar::load(wk[a.y]);
            const Key x = encode_key(Ar::add(cur[a.x], wv));
            key = x > key ? x : key;
            present |= a.x == v && wv > ninf;
          }
        }
        if (G == 32) {
          key = warp_max(key);
          present = __any_sync(0xffffffffu, present);
        } else {
          for (int o = 1; o < G; o <<= 1) {
            const Key k2 = __shfl_xor_sync(0xffffffffu, key, o);
            key = k2 > key ? k2 : key;
            present |= __shfl_xor_sync(0xffffffffu, present, o);
          }
        }
        if (q < m && (tid & (G - 1)) == 0) deliver(k, v, key, present);
      }
    } else {
      const int32_t u = g_ids[k];
      if ((unsigned)u >= (unsigned)U) __trap();
      const T* wk = w + (int64_t)u * E + lo;
      for (int i = tid; i < n; i += nc) {
        const int s = src[lo + i], d = dst[lo + i];
        const C wv = Ar::load(wk[i]);
        const Key key = encode_key(Ar::add(cur[s], wv));
        if (key != kneg) atomicMax(&part[d], key);
        if (s == d && wv > ninf) pflag[d] = 1;
      }
      if (cs > 1) {  // every node's accumulated partial, once all are in
        asm volatile("bar.sync 1, %0;\n" ::"r"(nc) : "memory");
        for (int v = tid; v < N; v += nc) {
          deliver(k, v, part[v], pflag[v]);
          part[v] = kneg;
          pflag[v] = 0;
        }
      }
    }
    if (cs > 1) {
      if (!producer) mbar_wait_cluster(&ibar[k & 1], (k >> 1) & 1);
    } else {
      __syncthreads();
    }
    if (!producer)
      for (int v = tid; v < N; v += nc) {
        Key best;
        uint32_t has_self;
        if (cs > 1) {
          const Key* slot = inbox + 2 * ((size_t)(k & 1) * cs * N + v);
          best = slot[0];
          has_self = (uint32_t)slot[1];
          for (int r = 1; r < cs; ++r) {
            const Key x = slot[2 * (size_t)r * N];
            best = x > best ? x : best;
            has_self |= (uint32_t)slot[2 * (size_t)r * N + 1];
          }
        } else {
          best = part[v];
          has_self = pflag[v];
          part[v] = kneg;
          pflag[v] = 0;
        }
        if (!has_self) {
          const Key kc = encode_key(cur[v]);
          best = kc > best ? kc : best;
        }
        nxt[v] = decode_key(best);
      }
    __syncthreads();
    C* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (producer)
    for (int v = v_lo + lane; v < v_hi; v += 32) o[(int64_t)R * N + v] = Ar::store(cur[v]);
  if (cs > 1) cluster_barrier();  // no CTA leaves while another may still push to it
}

template <typename T>
cudaError_t launch_timing(const void* src, const void* dst, const void* w, const void* ids,
                          const void* t0, void* out, int64_t C, int64_t R, int64_t U, int64_t E,
                          int64_t N, int64_t cs, int64_t A, int stages, cudaStream_t stream) {
  if (!(cs == 1 || cs == 2 || cs == 4 || cs == 8) || A < 1 || A > E || A * cs < E ||
      stages < 0 || stages == 1 || stages > kMaxStages || C > 0x7fffffffLL / cs ||
      (stages > 0 && reinterpret_cast<uintptr_t>(w) % 16 != 0))
    return cudaErrorInvalidValue;
  const size_t smem = timing_smem_bytes<T>(N, A, stages, cs);
  if (smem > max_smem_optin()) return cudaErrorInvalidValue;
  auto kernel = stages > 0 ? &timing_kernel<T, true> : &timing_kernel<T, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * cs));
  const int consumers = threads_for(A > N ? A : N);
  cfg.blockDim = dim3((consumers < kMaxThreads - 32 ? consumers : kMaxThreads - 32) + 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const int32_t*>(src),
                           static_cast<const int32_t*>(dst), static_cast<const T*>(w),
                           static_cast<const int32_t*>(ids), static_cast<const T*>(t0),
                           static_cast<T*>(out), (int)R, (int)U, (int)E, (int)N, (int)A, stages);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The standalone segment max: one thread-block cluster of cs CTAs a row

constexpr int kSegThreads = 256;
constexpr int kMaxDevices = 64;

// Order-preserving keys of the four value types.  Shared memory holds a
// 32-bit key for float and for the 16-bit types (their 16-bit key,
// widened) and a 64-bit key for double; in the global-memory layout `out`
// itself holds the keys, as Word, and is decoded in place.
__device__ __forceinline__ unsigned int encode_16(unsigned short b, unsigned int inf,
                                                  unsigned int qnan) {
  const unsigned int x = ((b & 0x7fffu) > inf) ? qnan : b;
  return (x & 0x8000u) ? (~x & 0xffffu) : (x | 0x8000u);
}

__device__ __forceinline__ unsigned short decode_16(unsigned int k) {
  return (unsigned short)((k & 0x8000u) ? (k & 0x7fffu) : (~k & 0xffffu));
}

// Raise the 16-bit key at p to at least k (there is no 16-bit atomicMax).
__device__ __forceinline__ void cas_max_16(unsigned short* p, unsigned int k) {
  unsigned short old = __ldcg(p);
  while (old < k) {
    const unsigned short seen = atomicCAS(p, old, (unsigned short)k);
    if (seen == old) break;
    old = seen;
  }
}

template <typename T>
struct SegKey;

template <>
struct SegKey<float> {
  using Key = unsigned int;
  using Word = unsigned int;
  __device__ static Key encode(float x) { return encode_f32(x); }
  __device__ static float decode(Key k) { return decode_f32(k); }
  __device__ static Key neg_inf() { return 0x007fffffu; }  // encode_f32(-inf)
  __device__ static void global_max(Word* p, Key k) { atomicMax(p, k); }
};

template <>
struct SegKey<double> {
  using Key = unsigned long long;
  using Word = unsigned long long;
  __device__ static Key encode(double x) { return encode_f64(x); }
  __device__ static double decode(Key k) { return decode_f64(k); }
  __device__ static Key neg_inf() { return 0x000fffffffffffffull; }  // encode_f64(-inf)
  __device__ static void global_max(Word* p, Key k) { atomicMax(p, k); }
};

template <>
struct SegKey<__half> {
  using Key = unsigned int;
  using Word = unsigned short;
  __device__ static Key encode(__half x) { return encode_16(__half_as_ushort(x), 0x7c00u, 0x7e00u); }
  __device__ static __half decode(Key k) { return __ushort_as_half(decode_16(k)); }
  __device__ static Key neg_inf() { return 0x03ffu; }  // -inf is 0xfc00
  __device__ static void global_max(Word* p, Key k) { cas_max_16(p, k); }
};

template <>
struct SegKey<__nv_bfloat16> {
  using Key = unsigned int;
  using Word = unsigned short;
  __device__ static Key encode(__nv_bfloat16 x) {
    return encode_16(__bfloat16_as_ushort(x), 0x7f80u, 0x7fc0u);
  }
  __device__ static __nv_bfloat16 decode(Key k) { return __ushort_as_bfloat16(decode_16(k)); }
  __device__ static Key neg_inf() { return 0x007fu; }  // -inf is 0xff80
  __device__ static void global_max(Word* p, Key k) { cas_max_16(p, k); }
};

// Four consecutive values by one load: 16 bytes (two for double, 8 for the
// 16-bit types); p is aligned to four elements.
template <typename T>
struct alignas(4 * sizeof(T) < 16 ? 4 * sizeof(T) : 16) Four {
  T v[4];
};

// Fold a lane's W consecutive edges (W = 4 or 1; id -1: none) into the
// row's maxima.  First inside the lane: an edge whose id repeats the next
// one's hands its key on to it.  Then, into shared memory (kGlobal false),
// one atomicMax an edge: the shared-memory atomics resolve lanes that
// collide faster than any exchange between the lanes does (a match.any and
// shuffle aggregation measured slower at every shape, S = 1 included).  Into
// `out` (kGlobal), warp-aggregated: for each of the W places, a lane holding the same id
// as the lane before it joins that lane's run, a segmented max-scan of five
// shuffles gives each run's maximum to its last lane, and only that lane
// issues the global atomic (a native u32/u64 atomicMax, or a 16-bit CAS):
// one a run instead of one an edge where the ids come in runs (sorted or
// repeated ids).  Called by whole warps.  An id outside [0, S) or a -inf
// value (the identity) issues nothing.
template <typename T, bool kGlobal, int W>
__device__ __forceinline__ void fold(int32_t (&id)[W], typename SegKey<T>::Key (&key)[W], int S,
                                     typename SegKey<T>::Key* keys,
                                     typename SegKey<T>::Word* words) {
  using Key = typename SegKey<T>::Key;
  const Key kneg = SegKey<T>::neg_inf();
#pragma unroll
  for (int j = 0; j + 1 < W; ++j)
    if (id[j] == id[j + 1]) {
      key[j + 1] = key[j] > key[j + 1] ? key[j] : key[j + 1];
      id[j] = -1;
    }
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const bool valid = (unsigned)id[j] < (unsigned)S && key[j] != kneg;
    if (!kGlobal) {
      if (valid) atomicMax(keys + id[j], key[j]);
      continue;
    }
    const int sid = valid ? id[j] : -1;
    const int lane = (int)(threadIdx.x & 31);
    const int prev = __shfl_up_sync(0xffffffffu, sid, 1);
    const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != sid);
    const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));  // the run's first lane
    Key best = key[j];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Key x = __shfl_up_sync(0xffffffffu, best, d);
      if (lane - d >= start) best = x > best ? x : best;
    }
    const int next = __shfl_down_sync(0xffffffffu, sid, 1);
    if (valid && (lane == 31 || next != sid)) SegKey<T>::global_max(words + sid, best);
  }
}

// grid (B * cs), clusters of cs CTAs (a plain launch when cs == 1): CTA
// `rank` of row b folds edges [rank * per, rank * per + per) of the row.
// Shared layout (kGlobal false): every CTA keeps all S keys of the row in
// its shared memory; after one cluster barrier CTA `rank` reduces its 1/cs
// of the segments over its peers' shared memory (DSMEM), decodes them and
// writes them; a last arrive/wait keeps its shared memory alive until the
// peers have read it.  Global layout: CTA `rank` sets its 1/cs of the row's
// `out` to the -inf key, a cluster barrier, the fold into `out`, a cluster
// barrier, then it decodes its 1/cs in place.  kVec: the slice goes in
// one pass of four edges a thread, its aligned body by one vector load each
// of ids and values, its head and tail (at most three edges each) by
// further threads of the same pass; else an edge a thread.
template <typename T, bool kGlobal, bool kVec>
__global__ void __launch_bounds__(kSegThreads)
segment_max_kernel(const T* __restrict__ vals, const int32_t* __restrict__ ids,
                   T* __restrict__ out, int64_t E, int S, int64_t per, int cs) {
  using Key = typename SegKey<T>::Key;
  using Word = typename SegKey<T>::Word;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char seg_smem[];
  Key* keys = reinterpret_cast<Key*>(seg_smem);

  const int tid = threadIdx.x, nt = blockDim.x;
  const int rank = (int)(blockIdx.x % cs);  // the CTA's rank in its 1-D cluster
  const int64_t b = blockIdx.x / cs;
  const int ns = (S + cs - 1) / cs;  // the segments a CTA writes
  const int s_lo = rank * ns < S ? rank * ns : S;
  const int s_hi = s_lo + ns < S ? s_lo + ns : S;
  T* o = out + b * (int64_t)S;
  Word* words = reinterpret_cast<Word*>(o);
  const Key kneg = SegKey<T>::neg_inf();

  if (kGlobal) {
    for (int s = s_lo + tid; s < s_hi; s += nt) words[s] = (Word)kneg;
    if (cs > 1)
      cluster_barrier();  // the whole row is set before any CTA folds into it
    else
      __syncthreads();
  } else {
    for (int s = tid; s < S; s += nt) keys[s] = kneg;
    __syncthreads();
  }

  const int64_t lo = (int64_t)rank * per < E ? (int64_t)rank * per : E;
  const int64_t hi = lo + per < E ? lo + per : E;
  const int64_t g0 = b * E + lo, g1 = b * E + hi;  // the slice, as flat indices
  // with kVec: the aligned body [a0, a1) in nvec slots of four edges, then
  // the head [g0, a0) and the tail [a1, g1) a slot an edge; else a slot an
  // edge from g0
  int64_t a0 = g0, a1 = g0;
  if (kVec) {
    const int64_t up = (g0 + 3) & ~int64_t(3), down = g1 & ~int64_t(3);
    a0 = up < g1 ? up : g1;
    a1 = down > a0 ? down : a0;
  }
  const int nvec = (int)((a1 - a0) >> 2);
  const int nh = (int)(a0 - g0);
  const int nslots = kVec ? nvec + nh + (int)(g1 - a1) : (int)(g1 - g0);
  // the same trip count in every thread, so whole warps reach the shuffles
  for (int base = 0; base < nslots; base += nt) {
    const int slot = base + tid;
    if (kVec) {
      int32_t id[4] = {-1, -1, -1, -1};
      Key key[4] = {kneg, kneg, kneg, kneg};
      if (slot < nvec) {
        const int64_t e = a0 + 4 * (int64_t)slot;
        const int4 i4 = __ldg(reinterpret_cast<const int4*>(ids + e));
        const Four<T> x = *reinterpret_cast<const Four<T>*>(vals + e);
        id[0] = i4.x;
        id[1] = i4.y;
        id[2] = i4.z;
        id[3] = i4.w;
#pragma unroll
        for (int j = 0; j < 4; ++j) key[j] = SegKey<T>::encode(x.v[j]);
      } else if (slot < nslots) {
        const int k = slot - nvec;
        const int64_t e = k < nh ? g0 + k : a1 + (k - nh);
        id[0] = ids[e];
        key[0] = SegKey<T>::encode(vals[e]);
      }
      fold<T, kGlobal, 4>(id, key, S, keys, words);
    } else {
      int32_t id[1] = {-1};
      Key key[1] = {kneg};
      if (slot < nslots) {
        id[0] = ids[g0 + slot];
        key[0] = SegKey<T>::encode(vals[g0 + slot]);
      }
      fold<T, kGlobal, 1>(id, key, S, keys, words);
    }
  }

  if (cs > 1)
    cluster_barrier();  // every fold of the row is done and visible in the cluster
  else
    __syncthreads();
  if (kGlobal) {
    for (int s = s_lo + tid; s < s_hi; s += nt) o[s] = SegKey<T>::decode((Key)__ldcg(words + s));
  } else if (cs == 1) {
    for (int s = tid; s < S; s += nt) o[s] = SegKey<T>::decode(keys[s]);
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    for (int s = s_lo + tid; s < s_hi; s += nt) {
      Key best = keys[s];
#pragma unroll
      for (int r = 1; r < 8; ++r)
        if (r < cs) {
          const Key x = *cluster.map_shared_rank(keys + s, (rank + r) % cs);
          best = x > best ? x : best;
        }
      o[s] = SegKey<T>::decode(best);
    }
    // no CTA leaves (freeing its shared memory) while a peer may still read it
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }
}

// The layout for the card's SM count and shared-memory grant.  This mirrors
// segment_max.py::segment_max_plan rule for rule (the C entry keeps its
// contract, so it plans for itself; change the two together, the GPU tests
// hold them equal through segment_max_plan_of).  The maxima go to `out` when a row has
// more segments than edges (a CTA's copy of all S keys would cost more to
// set and merge than the edges to fold) or its S keys pass a CTA's grant,
// else to shared memory.  A row takes the largest cluster of 8, 4 or 2 CTAs
// whose B * cs CTAs fit one wave of the SMs and whose CTAs keep at least
// kSegMinWork edges each (edges and segments in the global layout, whose
// CTAs also set and decode their share of the row), else 1; a CTA's slice
// is ceil(E / cs) edges rounded up to four.
constexpr int64_t kSegMinWork = 512;

struct SegPlan {
  int64_t cluster, per, global;
};

SegPlan segmax_plan(int64_t B, int64_t E, int64_t S, int64_t key_bytes, int64_t sms,
                    int64_t cap) {
  const int64_t global = (S > E || S * key_bytes > cap) ? 1 : 0;
  const int64_t work = global ? E + S : E;
  int64_t cs = 1;
  for (int64_t k = 8; k >= 2; k /= 2)
    if (B * k <= sms && (work + k - 1) / k >= kSegMinWork) {
      cs = k;
      break;
    }
  const int64_t per = ((E + cs - 1) / cs + 3) / 4 * 4;
  return SegPlan{cs, per, global};
}

// The current device's SM count and opt-in shared memory, read once a
// device (a process may launch on more than one card).
void device_limits(int64_t* sms, int64_t* cap) {
  static int s_sms[kMaxDevices];
  static size_t s_cap[kMaxDevices];
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kMaxDevices && s_sms[dev] > 0) {
    *sms = s_sms[dev];
    *cap = (int64_t)s_cap[dev];
    return;
  }
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  *sms = n;
  *cap = (int64_t)max_smem_optin();
  if (dev >= 0 && dev < kMaxDevices) {
    s_cap[dev] = (size_t)*cap;
    s_sms[dev] = n;
  }
}

int64_t seg_key_bytes(int dtype) { return dtype == 1 ? 8 : 4; }

template <typename T>
cudaError_t launch_segment_max(const void* vals, const void* ids, void* out, int64_t B, int64_t E,
                               int64_t S, SegPlan plan, cudaStream_t stream) {
  using Key = typename SegKey<T>::Key;
  const int64_t cs = plan.cluster;
  if (!(cs == 1 || cs == 2 || cs == 4 || cs == 8) || plan.per < (E > 0 ? 1 : 0) ||
      plan.per > 0x7fffffffLL || plan.per * cs < E || B > 0x7fffffffLL / cs ||
      S > 0x7fffffffLL || !(plan.global == 0 || plan.global == 1))
    return cudaErrorInvalidValue;
  const size_t smem = plan.global ? 0 : (size_t)S * sizeof(Key);
  // (the device's grant is asked only past the 48 KB every block has: the
  // query costs the host more than the rest of a small launch)
  if (smem > kDefaultSmem && smem > max_smem_optin()) return cudaErrorInvalidValue;
  // four edges a thread where a CTA's slice fills two passes of its
  // threads that way and the rows allow vector loads; else an edge a thread
  const bool vec = plan.per >= 2 * kSegThreads && reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ids) % 16 == 0;
  auto kernel = plan.global ? (vec ? &segment_max_kernel<T, true, true>
                                   : &segment_max_kernel<T, true, false>)
                            : (vec ? &segment_max_kernel<T, false, true>
                                   : &segment_max_kernel<T, false, false>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // threads: a slot each (four edges, or one), or the segments a CTA sets,
  // whichever is more, in whole warps, 64 to 256
  const int64_t set = plan.global ? (S + cs - 1) / cs : S;
  const int64_t slots = vec ? plan.per / 4 + 8 : plan.per;
  int64_t want = slots > set ? slots : set;
  want = (want + 31) / 32 * 32;
  const int threads = (int)(want < 64 ? 64 : (want > kSegThreads ? kSegThreads : want));
  const T* v = static_cast<const T*>(vals);
  const int32_t* i = static_cast<const int32_t*>(ids);
  T* o = static_cast<T*>(out);
  if (cs == 1) {
    kernel<<<(unsigned)B, threads, smem, stream>>>(v, i, o, E, (int)S, plan.per, 1);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * cs));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, v, i, o, E, (int)S, plan.per, (int)cs);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int segment_max_dispatch(const void* vals, const void* ids, void* out, int64_t B, int64_t E,
                         int64_t S, int dtype, const SegPlan& plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_segment_max<float>(vals, ids, out, B, E, S, plan, s);
    case 1: return (int)launch_segment_max<double>(vals, ids, out, B, E, S, plan, s);
    case 2: return (int)launch_segment_max<__half>(vals, ids, out, B, E, S, plan, s);
    case 3: return (int)launch_segment_max<__nv_bfloat16>(vals, ids, out, B, E, S, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Reachability's layout (segment_max.py::reach_plan mirrors it).  layout 0:
// the bitsets, `rows` traversals a CTA; 1: the hop kernel with the row's
// arcs staged in shared memory; 2: the hop kernel reading them from global
// memory.  The bitsets take every N <= 1024 whose N x W words fit the
// card's shared memory, both directions of a row in one CTA (rows 2: the
// arcs read once for both) where two sets of bitsets fit, else one (at N
// = 1024).  Past that the hop kernel, staged where E * 8 + N bytes fit.
struct ReachPlan {
  int64_t layout, rows, smem;
};

int64_t reach_bitset_bytes(int64_t N) { return N * ((N + 31) / 32) * 4; }

ReachPlan reach_plan(int64_t E, int64_t N, int64_t cap) {
  const int64_t bits = reach_bitset_bytes(N);
  if (N <= kReachMaxBitsetNodes && bits <= cap) {
    const int64_t rows = 2 * bits <= cap ? 2 : 1;
    return ReachPlan{0, rows, rows * bits};
  }
  const int64_t staged = E * 2 * (int64_t)sizeof(int32_t) + N;
  return staged <= cap ? ReachPlan{1, 1, staged} : ReachPlan{2, 1, N};
}

int reach_dispatch(const void* src, const void* dst, const void* present, void* out, int64_t B,
                   int64_t E, int64_t N, int64_t layout, int64_t rows, cudaStream_t stream) {
  if (B < 0 || E < 0 || N < 1 || E > 0x7fffffffLL || N > 0x7fffffffLL || B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int32_t* s = static_cast<const int32_t*>(src);
  const int32_t* d = static_cast<const int32_t*>(dst);
  const uint8_t* p = static_cast<const uint8_t*>(present);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (layout == 0) {
    if (N > kReachMaxBitsetNodes || (rows != 1 && rows != 2)) return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    const size_t smem = (size_t)(rows * reach_bitset_bytes(N));
    // (the device's grant is asked only past the 48 KB every block has)
    if (smem > kDefaultSmem && smem > max_smem_optin()) return (int)cudaErrorInvalidValue;
    cudaError_t err = allow_smem(&reach_bitset_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)B, rows == 1 ? 2 : 1);
    // threads: four arcs each, or four bitset words each to zero, in whole
    // warps, 64 to 1024
    const int64_t words = rows * reach_bitset_bytes(N) / 16;
    const int64_t arcs = (E + kReachArcsPerThread - 1) / kReachArcsPerThread;
    const int64_t work = arcs > words ? arcs : words;
    int64_t want = (work + 31) / 32 * 32;
    want = want < 64 ? 64 : (want > kMaxThreads ? kMaxThreads : want);
    reach_bitset_kernel<<<grid, (unsigned)want, smem, stream>>>(s, d, p, o, (int)B, (int)E,
                                                                (int)N, (int)rows);
    return (int)cudaGetLastError();
  }
  if ((layout != 1 && layout != 2) || rows != 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const bool staged = layout == 1;
  const size_t smem = staged ? (size_t)E * 2 * sizeof(int32_t) + (size_t)N : (size_t)N;
  if (smem > kDefaultSmem && smem > max_smem_optin()) return (int)cudaErrorInvalidValue;
  auto kernel = staged ? &reach_kernel<true> : &reach_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)B, 2), threads_for(E > N ? E : N), smem, stream>>>(s, d, p, o, (int)B,
                                                                            (int)E, (int)N);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (src/repro_torch/kernels/segment_max.py).
// dtype: 0 = float32, 1 = float64, 2 = float16, 3 = bfloat16.  vals and ids
// are contiguous [B, E], out is contiguous [B, S].  Returns the cudaError_t
// of the launch (nothing is launched when B or S is 0).  The layout is
// segmax_plan's for the current device.
extern "C" int segment_max_launch(const void* vals, const void* ids, void* out, int64_t B,
                                  int64_t E, int64_t S, int dtype, void* stream) {
  if (B < 0 || E < 0 || S < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  int64_t sms = 0, cap = 0;
  device_limits(&sms, &cap);
  return segment_max_dispatch(vals, ids, out, B, E, S, dtype,
                              segmax_plan(B, E, S, seg_key_bytes(dtype), sms, cap), stream);
}

// The same under a given layout: cluster (1, 2, 4 or 8 CTAs a row),
// edges_per_cta (cluster * edges_per_cta >= E) and global (0: the segments
// in shared memory, 1: in out).  A layout the card cannot take returns an
// error and launches nothing.
extern "C" int segment_max_launch_plan(const void* vals, const void* ids, void* out, int64_t B,
                                       int64_t E, int64_t S, int dtype, int64_t cluster,
                                       int64_t edges_per_cta, int64_t global, void* stream) {
  if (B < 0 || E < 0 || S < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  return segment_max_dispatch(vals, ids, out, B, E, S, dtype,
                              SegPlan{cluster, edges_per_cta, global}, stream);
}

// The layout segment_max_launch takes on the current device:
// plan[0..2] = {cluster, edges_per_cta, global}.  Only the tests call it,
// to hold segmax_plan to segment_max_plan.
extern "C" void segment_max_plan_of(int64_t B, int64_t E, int64_t S, int dtype, int64_t* plan) {
  int64_t sms = 0, cap = 0;
  device_limits(&sms, &cap);
  const SegPlan p = segmax_plan(B, E, S, seg_key_bytes(dtype), sms, cap);
  plan[0] = p.cluster;
  plan[1] = p.per;
  plan[2] = p.global;
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
// for a present arc), out is [2, B, N] bytes: forward, then backward.  The
// layout is reach_plan's for the current device; nothing is launched when
// B is 0.
extern "C" int reach_launch(const void* src, const void* dst, const void* present, void* out,
                            int64_t B, int64_t E, int64_t N, void* stream) {
  int64_t sms = 0, cap = 0;
  device_limits(&sms, &cap);
  const ReachPlan p = reach_plan(E, N, cap);
  return reach_dispatch(src, dst, present, out, B, E, N, p.layout, p.rows,
                        static_cast<cudaStream_t>(stream));
}

// The same under a given layout (0: bitsets, 1: hops over staged arcs, 2:
// hops over arcs in global memory) and rows (traversals a CTA: 1 or 2 for
// the bitsets, 1 for the hops).  A layout the card cannot take returns an
// error and launches nothing.
extern "C" int reach_launch_plan(const void* src, const void* dst, const void* present,
                                 void* out, int64_t B, int64_t E, int64_t N, int64_t layout,
                                 int64_t rows, void* stream) {
  return reach_dispatch(src, dst, present, out, B, E, N, layout, rows,
                        static_cast<cudaStream_t>(stream));
}

// The layout reach_launch takes on the current device: plan[0..2] =
// {layout, rows, shared-memory bytes a CTA}.  Only the tests call it, to
// hold reach_plan to segment_max.py::reach_plan.
extern "C" void reach_plan_of(int64_t E, int64_t N, int64_t* plan) {
  int64_t sms = 0, cap = 0;
  device_limits(&sms, &cap);
  const ReachPlan p = reach_plan(E, N, cap);
  plan[0] = p.layout;
  plan[1] = p.rows;
  plan[2] = p.smem;
}

// w is contiguous [U, E] (dtype 0 = float32, 1 = float64), src and dst are
// int32 [E] in [0, N), ids int32 [C, R] in [0, U), t0 [C, N] of w's type
// or null for zeros, out [C, R+1, N] of w's type.  cluster (1, 2, 4 or 8
// CTAs a chain), arcs_per_cta (cluster * arcs_per_cta >= E) and stages (0:
// weights read in place; 2 to 4: rounds in flight in the ring) come from
// segment_max.py::timing_plan; a plan the card cannot take (its shared
// memory, or a cluster the card refuses) returns an error and launches
// nothing.  Nothing is launched when C is 0.
extern "C" int timing_recursion_launch(const void* src, const void* dst, const void* w,
                                       const void* ids, const void* t0, void* out, int64_t C,
                                       int64_t R, int64_t U, int64_t E, int64_t N,
                                       int64_t cluster, int64_t arcs_per_cta, int stages,
                                       int dtype, void* stream) {
  if (C < 0 || R < 0 || U < 0 || E < 1 || N < 1 || C > 0x7fffffffLL || R > 0x7fffffffLL ||
      U > 0x7fffffffLL || E > 0x7fffffffLL || N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_timing<float>(src, dst, w, ids, t0, out, C, R, U, E, N, cluster,
                                       arcs_per_cta, stages, s);
    case 1:
      return (int)launch_timing<double>(src, dst, w, ids, t0, out, C, R, U, E, N, cluster,
                                        arcs_per_cta, stages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The most nodes a timing recursion of this dtype can hold in the current
// device's shared memory (its start-time, partial-key and flag buffers, on
// one CTA a chain, with the arcs and weights read in place).
extern "C" int64_t timing_recursion_max_nodes(int dtype) {
  const size_t per_node = dtype == 1 ? 3 * sizeof(double) + 1 : 3 * sizeof(float) + 1;
  return (int64_t)(((max_smem_optin() & ~size_t(15)) - timing_head_bytes(0)) / per_node);
}

// Shared memory a CTA of the timing recursion takes under a plan (an input
// of timing_plan).
extern "C" int64_t timing_recursion_smem_bytes(int64_t N, int64_t arcs_per_cta, int stages,
                                               int64_t cluster, int dtype) {
  return (int64_t)(dtype == 1 ? timing_smem_bytes<double>(N, arcs_per_cta, stages, cluster)
                              : timing_smem_bytes<float>(N, arcs_per_cta, stages, cluster));
}

// The most shared memory the current device grants a block (an input of
// timing_plan and of segment_max_plan).
extern "C" int64_t smem_cap_optin() { return (int64_t)max_smem_optin(); }

extern "C" const char* segment_max_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
