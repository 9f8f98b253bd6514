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
// Two entries.  flash_attention_launch is the tensor-core kernel that the
// port runs.  flash_attention_simt_launch is the earlier kernel whose
// products are fp32 FMAs on the CUDA cores; nothing on the serving path
// calls it, it is kept to be timed beside the first in one run.
//
// Bound.  Each visible (query, key) pair costs 2*hd multiply-adds (the
// score and the value product): 4*hd operations.  At prefill shapes this
// is far above the bytes it moves (q, k, v read once, out written once),
// so the kernel is bound by operations.  The reference's numerics are
// fp32 (2e-5 against the plain version), which one TF32 product (about
// three decimal digits) cannot hold.  So each fp32 operand x is split
// into hi = tf32(x) and lo = tf32(x - hi), rounded to nearest with ties
// away from zero (cvt.rna.tf32.f32's rounding, done with an integer add
// and mask), and a product is hi*hi + hi*lo + lo*hi in fp32 accumulators
// (3xTF32): three passes at the H100's 495 TFLOP/s TF32 rate, about 165
// TFLOP/s of fp32-accurate products against 67 on the CUDA cores.  A
// bf16 value is exact in TF32, so with bf16 inputs q.k is one pass (on q
// as given; the fp32 score is then scaled by hd^-0.5, which differs from
// scaling q first by one fp32 rounding) and P.V two (P_hi.V + P_lo.V).
//
// Design of the tensor-core kernel.  One block takes one (batch, kv
// head, query tile): BQ = 128 / G query positions times all G query heads
// of that kv head, 128 rows in all, so each K/V tile read from memory
// serves the G heads and two 64-row consumer warpgroups.  384 threads in
// three warpgroups with separate roles (warp specialisation); the
// producer gives registers back (setmaxnreg) so that each consumer thread
// holds 216:
//  - The producer warpgroup keeps the next K tile's and the next V tile's
//    copy in flight (one TMA tensor copy each, BN key rows of hd
//    elements, into raw staging tiles, completing on mbarriers; each is
//    started as soon as the current tile has been read out of its staging
//    tile), and converts the arrived tiles to fp32 hi/lo planes in the
//    layout wgmma reads: K as rows of keys; V transposed, since TF32
//    wgmma takes both operands K-major only and P.V reduces over keys.  K
//    and V have one buffer each with their own full/empty mbarriers, so K
//    of tile i+1 is converted while the consumers run the softmax and P.V
//    of tile i, and V of tile i+1 while they run Q.K^T of tile i+1.
//  - Each consumer warpgroup runs S = Q.K^T for its 64 rows as
//    wgmma.m64n{BN}k8 over hd/8 depth steps per pass, then the online
//    softmax on the accumulator registers (each thread holds two rows and
//    a quarter of their columns; a row's max and sum are two
//    xor-shuffles).  P stays in registers as the A operand of P.V (wgmma
//    with A from registers): in each group of 8 keys a thread holds keys
//    2t and 2t+1 of its rows, which TF32's A fragment reads as columns t
//    and t+4, so V's rows are stored in that order (keys 0, 2, 4, 6, 1, 3,
//    5, 7 of each group).  P.V runs as wgmma.m64n{hd}k8 over BN/8 depth
//    steps per pass into a fresh accumulator that is added to O in fp32
//    registers (so the sum over key tiles is rounded to nearest, not
//    chained through the tensor core's accumulator).  The two consumer
//    warpgroups interleave on the tensor cores: one's softmax runs while
//    the other's products do.
//  - Operand tiles use wgmma's layout without swizzle: 8 rows x 16 bytes
//    core matrices, 128 bytes each, depth-adjacent core matrices 128
//    bytes apart and 8-row groups hd*32 (or BN*32) bytes apart, so hd =
//    80 (ten depth steps of 8, not a multiple of a swizzle span) needs no
//    special case.
//  - Shared memory is the budget: at hd 80, fp32, with BN = 64 keys a
//    tile, Q hi/lo 80 KB + K hi/lo 40 KB + V^T hi/lo 40 KB + the raw K and
//    V tiles 42 KB = 202 KB of 227 KB, one block an SM.  At hd 128 the
//    same tiling would need 288 KB, so hd 128 takes BN = 32 keys a tile
//    (225 KB).
//
// Masked tiles.  A masked score is the finite -1e30 of the reference, so
// a tile that is wholly masked for a row before its first visible key
// adds weights of 1 that the next tile's alpha = exp(-1e30 - m) = 0
// wipes out exactly.  Key tiles outside every row's visible band (above
// the diagonal, or before the window of the tile's first query) are
// skipped; that changes nothing when every row of the block sees at
// least one key, which each block checks before it skips.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 64;    // query rows (position, head) of a wgmma M, and of a CUDA-core block
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The visible band of a block: key tiles that hold a visible key of some
// row.  Row q sees [max(0, q - window + 1), causal ? min(T-1, q) : T-1];
// if the last row sees a key, so does every row (both ends grow with q),
// and the block's band runs from its first row's start to its last row's
// end.  Otherwise (a window of 0, or rows past the keys' window) every
// tile is kept, as in the reference.
__device__ __forceinline__ void visible_band(int q0, int q_last, int T_len, int causal,
                                             int window, int& kv_lo, int& kv_hi) {
  kv_lo = 0;
  kv_hi = T_len - 1;
  const bool has_window = window >= 0;
  const int lo = has_window ? max(0, q_last - window + 1) : 0;
  const int hi = causal ? min(T_len - 1, q_last) : T_len - 1;
  if (lo <= hi) {
    kv_lo = has_window ? max(0, q0 - window + 1) : 0;
    kv_hi = hi;
  }
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (wgmma, 3xTF32)

constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2;                  // consumer warpgroups, 64 query rows each
constexpr int kBlockRows = kConsumers * kRows; // query rows of a block
constexpr int kProducer = kWarpgroup;          // producer threads (one warpgroup)
constexpr int kThreadsTC = kConsumers * kWarpgroup + kProducer;
// Registers a thread holds after the warpgroups trade them (setmaxnreg).
// A thread starts with kStartRegs (168 at 384 threads); the trade keeps
// the block's total, since one that asked for all 65536 of the SM's
// registers (64 and 224) never completed.
constexpr int kStartRegs = (65536 / kThreadsTC) & ~7;
constexpr int kProducerRegs = 72;
constexpr int kConsumerRegs = 216;
static_assert(kProducer * kProducerRegs + kConsumers * kWarpgroup * kConsumerRegs <=
                  kThreadsTC * kStartRegs,
              "setmaxnreg trade above the block's registers");

template <typename T, int HD>
struct Plan {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int BN = HD == 128 ? 32 : 64;          // keys per K/V tile
  static constexpr int kPlanes = kF32 ? 2 : 1;            // hi (and lo) planes of Q, K, V
  // Raw fp32 K and V tiles land with rows of LDR = hd + 4 elements: the TMA
  // box runs 16 bytes past hd, and those columns, outside the tensor, are
  // filled with zeros.  The pad puts the 8 key rows that one 16-byte read
  // phase touches in distinct banks, which measured faster; bf16 rows stay
  // unpadded, since padded they measured slower.
  static constexpr int LDR = kF32 ? HD + 4 : HD;
  static constexpr uint32_t kTileBytes = BN * LDR * sizeof(T);  // one raw K or V tile
  static constexpr size_t kQ = (size_t)kBlockRows * HD;   // floats of one Q plane
  static constexpr size_t kKV = (size_t)BN * HD;          // of one K or V plane
  static constexpr size_t off_k = kPlanes * kQ * 4;       // byte offsets
  static constexpr size_t off_v = off_k + kPlanes * kKV * 4;
  static constexpr size_t off_raw = off_v + kPlanes * kKV * 4;  // raw K tile, then raw V tile
  static constexpr size_t off_bar = off_raw + 2 * (size_t)kTileBytes;
  static constexpr size_t smem = off_bar + 6 * sizeof(uint64_t);
  static_assert(HD % 8 == 0 && off_raw % 128 == 0 && kTileBytes % 128 == 0, "layout");
  static_assert(smem <= 232448, "shared memory above the H100's 227 KB");
};

// Float offset of element (r, c) of an operand tile whose rows are `C`
// elements deep (c runs along the reduction), in wgmma's layout without
// swizzle: core matrices of 8 rows x 4 floats (128 bytes), depth-adjacent
// ones contiguous, 8-row groups C/4 core matrices apart.
template <int C>
__device__ __forceinline__ int cm(int r, int c) {
  return ((r >> 3) * (C / 4) + (c >> 2)) * 32 + (r & 7) * 4 + (c & 3);
}

// wgmma shared-memory descriptor of such a tile: start address, leading
// (depth) byte offset 128, stride byte offset C * 32, no swizzle.  A depth
// step of 8 (two core matrices, 256 bytes) adds 16 to it.
template <int C>
__device__ __forceinline__ uint64_t tile_desc(const float* tile) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((C * 32) >> 4) << 32);
}

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero.
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32(x);
  lo = tf32(x - hi);
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

// Store x into the hi plane, and its lo part into the lo plane when the
// operand is split (fp32 inputs); bf16 values are exact in TF32.
template <bool kSplit>
__device__ __forceinline__ void put4(float* hi_plane, size_t plane, int off, float4 x) {
  if constexpr (kSplit) {
    float4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<float4*>(hi_plane + off) = h;
    *reinterpret_cast<float4*>(hi_plane + plane + off) = l;
  } else {
    *reinterpret_cast<float4*>(hi_plane + off) = x;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: copy the box at (0, kv head h, row) of `map` (BN key rows of hd
// elements) to shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int h, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(h), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier of kThreads threads alone (named barrier kId).
template <int kId, int kThreads>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kId), "n"(kThreads) : "memory");
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, fp32, the wgmma accumulator layout) += A . B^T over a depth of
// 8, A and B TF32 tiles in shared memory given by their descriptors;
// scale_d = 0 overwrites d instead.  N is the key tile: 64, or 32 at hd 128.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t a, uint64_t b,
                                           int scale_d);

// The same with A (64 x 8) in registers: each warp holds 16 rows, thread
// (lane 4g + t) the TF32 values (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], uint64_t a, uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

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
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<80>(float (&d)[40], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_attention_kernel(const T* __restrict__ q, const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, T* __restrict__ out,
                       int S, int T_len, int K, int G, float scale,
                       int causal, int window) {
  using P = Plan<T, HD>;
  constexpr int BN = P::BN;
  constexpr bool kF32 = P::kF32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);                // [planes][kBlockRows x HD]
  float* Ks = reinterpret_cast<float*>(smem + P::off_k);     // [planes][BN x HD]
  float* Vs = reinterpret_cast<float*>(smem + P::off_v);     // [planes][HD x BN], V^T
  T* raw_k = reinterpret_cast<T*>(smem + P::off_raw);        // [BN][LDR]
  T* raw_v = raw_k + BN * P::LDR;                            // [BN][LDR]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P::off_bar);
  uint64_t* raw_k_full = bars;        // the raw K tile has landed
  uint64_t* raw_v_full = bars + 1;    // the raw V tile has landed
  uint64_t* k_full = bars + 2;        // the K planes hold tile i
  uint64_t* k_empty = bars + 3;       // the consumers are done reading them
  uint64_t* v_full = bars + 4;        // likewise for V
  uint64_t* v_empty = bars + 5;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int BQ = kBlockRows / G;
  const int R = BQ * G;             // live rows of this block
  const int q0 = blockIdx.x * BQ;
  const int q_last = min(q0 + BQ, S) - 1;
  int kv_lo, kv_hi;
  visible_band(q0, q_last, T_len, causal, window, kv_lo, kv_hi);
  const int t_begin = (kv_lo / BN) * BN;

  if (tid == 0) {
    mbar_init(raw_k_full, 1);
    mbar_init(raw_v_full, 1);
    mbar_init(k_full, kProducer);
    mbar_init(k_empty, kConsumers * kWarpgroup);
    mbar_init(v_full, kProducer);
    mbar_init(v_empty, kConsumers * kWarpgroup);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers * kWarpgroup) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers * kWarpgroup;
    const int row0 = b * T_len;  // k and v as rows (b, t) of K heads
    if (pt == 0) {
      mbar_arrive_expect_tx(raw_k_full, P::kTileBytes);
      tma_load(raw_k, &k_map, h, row0 + t_begin, raw_k_full);
      mbar_arrive_expect_tx(raw_v_full, P::kTileBytes);
      tma_load(raw_v, &v_map, h, row0 + t_begin, raw_v_full);
    }
    int i = 0;
    for (int t0 = t_begin; t0 <= kv_hi; t0 += BN, ++i) {
      const bool more = t0 + BN <= kv_hi;
      // K: rows of keys, hd deep, once the consumers are done with tile i-1's.
      mbar_wait(raw_k_full, i & 1);
      if (i > 0) mbar_wait(k_empty, (i - 1) & 1);
#pragma unroll
      for (int it = 0; it < BN * HD / 4 / kProducer; ++it) {
        const int idx = pt + it * kProducer;
        const int j = (idx & 7) + 8 * ((idx >> 3) / (HD / 4));
        const int c = 4 * ((idx >> 3) % (HD / 4));
        put4<kF32>(Ks, P::kKV, cm<HD>(j, c), load4(raw_k + j * P::LDR + c));
      }
      fence_async_smem();
      mbar_arrive(k_full);
      named_sync<2, kProducer>();  // the raw K tile has been read: fetch the next
      if (pt == 0 && more) {
        mbar_arrive_expect_tx(raw_k_full, P::kTileBytes);
        tma_load(raw_k, &k_map, h, row0 + t0 + BN, raw_k_full);
      }
      // V transposed: rows of head dims, keys deep, in the A fragment's order.
      mbar_wait(raw_v_full, i & 1);
      if (i > 0) mbar_wait(v_empty, (i - 1) & 1);
#pragma unroll
      for (int it = 0; it < BN * HD / 4 / kProducer; ++it) {
        const int idx = pt + it * kProducer;
        const int d = idx % HD;
        const int j = 4 * (idx / HD);  // columns j..j+3: keys 8(j/8) + (j/4)%2 + 0, 2, 4, 6
        const T* col = raw_v + ((j & ~7) + ((j >> 2) & 1)) * P::LDR + d;
        const float4 x = make_float4(to_f32(col[0]), to_f32(col[2 * P::LDR]),
                                     to_f32(col[4 * P::LDR]), to_f32(col[6 * P::LDR]));
        put4<kF32>(Vs, P::kKV, cm<BN>(d, j), x);
      }
      fence_async_smem();
      mbar_arrive(v_full);
      named_sync<2, kProducer>();
      if (pt == 0 && more) {
        mbar_arrive_expect_tx(raw_v_full, P::kTileBytes);
        tma_load(raw_v, &v_map, h, row0 + t0 + BN, raw_v_full);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  // The consumer warpgroups: warpgroup wg holds block rows 64 wg .. 64 wg
  // + 63.  Accumulator layout of wgmma m64nN: thread (warp w of the
  // warpgroup, lane 4g + t) holds its rows 16w + g and 16w + g + 8,
  // columns 8c + 2t and 8c + 2t + 1 of each 8-column group c, as
  // d[4c + 2h + j] for row 16w + g + 8h and column 8c + 2t + j.
  const int wg = tid / kWarpgroup;
  const int warp = (tid % kWarpgroup) >> 5;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const int r0 = wg * kRows + warp * 16 + (lane >> 2);  // block row
  const int64_t q_pos_stride = (int64_t)K * G * HD;
  const T* q_base = q + ((int64_t)b * S * K + h) * (int64_t)G * HD;

  // Q: rows (q0 + r / G, head r % G), fp32 inputs scaled and split.
#pragma unroll
  for (int it = 0; it < kBlockRows * HD / 4 / (kConsumers * kWarpgroup); ++it) {
    const int idx = tid + it * kConsumers * kWarpgroup;
    const int r = (idx & 7) + 8 * ((idx >> 3) / (HD / 4));
    const int c = 4 * ((idx >> 3) % (HD / 4));
    const int qp = q0 + r / G;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < R && qp < S) x = load4(q_base + (int64_t)qp * q_pos_stride + (r % G) * HD + c);
    if constexpr (kF32) x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    put4<kF32>(Qs, P::kQ, cm<HD>(r, c), x);
  }
  fence_async_smem();
  named_sync<1, kConsumers * kWarpgroup>();

  const uint64_t dq = tile_desc<HD>(Qs + wg * kRows * HD);  // this warpgroup's 64 rows
  const uint64_t dk = tile_desc<HD>(Ks);
  const uint64_t dv = tile_desc<BN>(Vs);
  // descriptor offsets of the lo planes (16-byte units)
  constexpr uint64_t q_lo = P::kQ * 4 / 16, kv_lo_plane = P::kKV * 4 / 16;

  // o: the running output; ot: one tile's P.V, added to o in fp32 registers
  // so that the long sum over key tiles is rounded to nearest.
  float o[HD / 2], ot[HD / 2], s[BN / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = ot[e] = 0.f;
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) s[e] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const int row_pos[2] = {q0 + r0 / G, q0 + (r0 + 8) / G};
  const bool has_window = window >= 0;

  int i = 0;
  for (int t0 = t_begin; t0 <= kv_hi; t0 += BN, ++i) {
    // S = Q . K^T: hi.lo, lo.hi, then hi.hi (fp32); one pass (bf16).
    mbar_wait(k_full, i & 1);
    fence_regs(s);
    wgmma_fence();
    if constexpr (kF32) {
#pragma unroll
      for (int st = 0; st < HD / 8; ++st)
        wgmma_tf32<BN>(s, dq + 16 * st, dk + kv_lo_plane + 16 * st, st > 0);
#pragma unroll
      for (int st = 0; st < HD / 8; ++st)
        wgmma_tf32<BN>(s, dq + q_lo + 16 * st, dk + 16 * st, 1);
#pragma unroll
      for (int st = 0; st < HD / 8; ++st) wgmma_tf32<BN>(s, dq + 16 * st, dk + 16 * st, 1);
    } else {
#pragma unroll
      for (int st = 0; st < HD / 8; ++st) wgmma_tf32<BN>(s, dq + 16 * st, dk + 16 * st, st > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    mbar_arrive(k_empty);

    // Mask, online softmax, P = exp(s - m) split into hi/lo A fragments:
    // the fragment of depth step c is (s[4c], s[4c+2], s[4c+1], s[4c+3]).
    // The mask is compiled into a second copy, taken only by tiles that
    // cross some row's band, so that the common tile's loops have no
    // branches (a run-time test inside them measured far slower).
    const bool edge = (causal && t0 + BN - 1 > q0) ||
                      (has_window && q0 + BQ - 1 - t0 >= window);
    uint32_t ph[BN / 8][4], pl[BN / 8][4];
    float alpha[2];
    auto softmax = [&](auto masked) {
      constexpr bool kMask = decltype(masked)::value;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = kMasked;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = s[4 * c + 2 * hh + j];
            if constexpr (!kF32) x *= scale;
            if constexpr (kMask) {
              const int kp = t0 + 8 * c + 2 * t4 + j;
              if ((causal && kp > row_pos[hh]) || (has_window && row_pos[hh] - kp >= window))
                x = kMasked;
            }
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        alpha[hh] = expf(m[hh] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float p = expf(s[4 * c + 2 * hh + j] - m_new);
            sum += p;
            float hi, lo;
            split(p, hi, lo);
            ph[c][hh + 2 * j] = __float_as_uint(hi);
            pl[c][hh + 2 * j] = __float_as_uint(lo);
          }
        l[hh] = l[hh] * alpha[hh] + sum;
        m[hh] = m_new;
      }
    };
    if (edge)
      softmax(std::true_type{});
    else
      softmax(std::false_type{});

    // ot = P . V: P_hi.V_lo, P_lo.V_hi, P_hi.V_hi (fp32); P_lo.V, P_hi.V (bf16).
    mbar_wait(v_full, i & 1);
    fence_regs(ot);
    wgmma_fence();
    if constexpr (kF32) {
#pragma unroll
      for (int st = 0; st < BN / 8; ++st)
        wgmma_tf32_rs<HD>(ot, ph[st], dv + kv_lo_plane + 16 * st, st > 0);
#pragma unroll
      for (int st = 0; st < BN / 8; ++st) wgmma_tf32_rs<HD>(ot, pl[st], dv + 16 * st, 1);
    } else {
#pragma unroll
      for (int st = 0; st < BN / 8; ++st) wgmma_tf32_rs<HD>(ot, pl[st], dv + 16 * st, st > 0);
    }
#pragma unroll
    for (int st = 0; st < BN / 8; ++st) wgmma_tf32_rs<HD>(ot, ph[st], dv + 16 * st, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(ot);
    mbar_arrive(v_empty);
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * c + e] = fmaf(o[4 * c + e], alpha[e >> 1], ot[4 * c + e]);
  }

  T* o_base = out + ((int64_t)b * S * K + h) * (int64_t)G * HD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = r0 + 8 * hh;
    if (r >= R || row_pos[hh] >= S) continue;
    const float denom = fmaxf(sum, 1e-30f);
    T* o_row = o_base + (int64_t)row_pos[hh] * q_pos_stride + (r % G) * HD;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      store2(o_row + 8 * c + 2 * t4, o[4 * c + 2 * hh] / denom, o[4 * c + 2 * hh + 1] / denom);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; it is looked up through the
// runtime's entry-point query, so the library needs no -lcuda.  The
// pointer is the same for every device.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of k or v [B, T, K, hd] as B*T rows of K heads of hd
// elements, with boxes of BN rows of one head, LDR elements wide (columns
// past hd are out of bounds and read as zeros).
template <typename T, int HD>
cudaError_t kv_map(CUtensorMap* map, const void* base, int B, int T_len, int K) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)K, (cuuint64_t)B * T_len};
  const cuuint64_t strides[2] = {HD * sizeof(T), (cuuint64_t)K * HD * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)Plan<T, HD>::LDR, 1, (cuuint32_t)Plan<T, HD>::BN};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, Plan<T, HD>::kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(base), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int B, int S,
                      int T_len, int K, int G, float scale, int causal, int window,
                      cudaStream_t stream) {
  constexpr size_t smem = Plan<T, HD>::smem;
  CUtensorMap k_map, v_map;
  cudaError_t err = kv_map<T, HD>(&k_map, k, B, T_len, K);
  if (err == cudaSuccess) err = kv_map<T, HD>(&v_map, v, B, T_len, K);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int BQ = kBlockRows / G;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)K, (unsigned)B);
  flash_attention_kernel<T, HD><<<grid, kThreadsTC, smem, stream>>>(
      static_cast<const T*>(q), k_map, v_map, static_cast<T*>(out), S, T_len, K, G, scale,
      causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The CUDA-core kernel (fp32 FMAs), kept to be timed beside the first.
//
// One block of 256 threads per (batch, kv head, query tile) as above.  K/V
// tiles of 64 keys stream through shared memory, converted to fp32.  The
// two products are register-tiled: thread (ty, tx) of a 16 x 16 grid owns
// rows ty + 16i and keys tx + 16j (i, j < 4) of the 64 x 64 score tile,
// and rows ty + 16i and dims tx + 16e (e < hd/16) of the accumulator.  The
// 16 threads of one row group are one half-warp, so a row's max and sum
// are four xor-shuffles.  Shared-memory rows are padded to hd + 4 floats
// so the 16-byte reads of 16 different key rows fall in distinct banks.

constexpr int kThreadsSimt = 256;
constexpr int kKeysSimt = 64;   // keys per K/V tile
constexpr int kLdP = 80;        // padded row of the probability tile

// padded row (floats) of the q, k and v tiles in shared memory
__host__ __device__ constexpr int ld(int hd) { return hd + 4; }

__host__ __device__ constexpr size_t smem_bytes_simt(int hd) {
  return (size_t)(3 * kRows * ld(hd) + kRows * kLdP) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreadsSimt)
flash_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            int S, int T_len, int K, int G, float scale,
                            int causal, int window) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = ld(HD);
  constexpr int E = HD / 16;  // accumulator dims per thread
  extern __shared__ float smem_simt[];
  float* Qs = smem_simt;            // [kRows][LD]
  float* Ks = Qs + kRows * LD;      // [kKeysSimt][LD]
  float* Vs = Ks + kKeysSimt * LD;  // [kKeysSimt][LD]
  float* Ps = Vs + kKeysSimt * LD;  // [kRows][kLdP]

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
  for (int idx = tid; idx < kRows * HD; idx += kThreadsSimt) {
    const int r = idx / HD, d = idx % HD;
    const int qp = q0 + r / G;
    float x = 0.f;
    if (r < R && qp < S) x = to_f32(q_base[(int64_t)qp * q_pos_stride + (r % G) * HD + d]) * scale;
    Qs[r * LD + d] = x;
  }

  int kv_lo, kv_hi;
  visible_band(q0, q_last, T_len, causal, window, kv_lo, kv_hi);
  const bool has_window = window >= 0;

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

  for (int t0 = (kv_lo / kKeysSimt) * kKeysSimt; t0 <= kv_hi; t0 += kKeysSimt) {
    __syncthreads();  // Qs written / previous tile's Ks, Vs, Ps read
    for (int idx = tid; idx < kKeysSimt * HD; idx += kThreadsSimt) {
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
    for (int j = 0; j < kKeysSimt; ++j) {
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
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* out, int B,
                        int S, int T_len, int K, int G, float scale, int causal,
                        int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_simt(HD);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_simt_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int BQ = kRows / G;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)K, (unsigned)B);
  flash_attention_simt_kernel<T, HD><<<grid, kThreadsSimt, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, T_len, K, G, scale, causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------

template <bool kTensorCores, typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                   int T_len, int K, int G, float scale, int causal, int window,
                   cudaStream_t stream) {
  if constexpr (kTensorCores)
    return launch_tc<T, HD>(q, k, v, out, B, S, T_len, K, G, scale, causal, window, stream);
  else
    return launch_simt<T, HD>(q, k, v, out, B, S, T_len, K, G, scale, causal, window, stream);
}

template <bool kTensorCores, typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* out, int B, int S,
                        int T_len, int K, int G, int hd, float scale, int causal, int window,
                        cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<kTensorCores, T, 32>(q, k, v, out, B, S, T_len, K, G, scale, causal, window, stream);
    case 64: return launch<kTensorCores, T, 64>(q, k, v, out, B, S, T_len, K, G, scale, causal, window, stream);
    case 80: return launch<kTensorCores, T, 80>(q, k, v, out, B, S, T_len, K, G, scale, causal, window, stream);
    case 128: return launch<kTensorCores, T, 128>(q, k, v, out, B, S, T_len, K, G, scale, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kTensorCores>
int entry(const void* q, const void* k, const void* v, void* out, int B, int S, int T_len,
          int K, int G, int hd, float scale, int causal, int window, int dtype, void* stream) {
  const uintptr_t any_misaligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15;
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || G <= 0 || G > kRows || T_len % 64 != 0 ||
      window < -1 || K > 65535 || B > 65535 || (int64_t)B * T_len > 0x7fffffffLL ||
      any_misaligned)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_hd<kTensorCores, float>(q, k, v, out, B, S, T_len, K, G, hd, scale, causal, window, s);
    case 1: return (int)dispatch_hd<kTensorCores, __nv_bfloat16>(q, k, v, out, B, S, T_len, K, G, hd, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, bound with ctypes (src/repro_torch/kernels/flash_attention.py).
// dtype: 0 = float32, 1 = bfloat16.  window: -1 for none, else >= 0.
// Needs contiguous q [B,S,K,G,hd], k/v [B,T,K,hd], out like q, each
// 16-byte aligned; hd in {32, 64, 80, 128}; 1 <= G <= 64; T a multiple of
// 64.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int S, int T_len, int K,
                                      int G, int hd, float scale, int causal,
                                      int window, int dtype, void* stream) {
  return entry<true>(q, k, v, out, B, S, T_len, K, G, hd, scale, causal, window, dtype, stream);
}

// The CUDA-core kernel, same arguments.
extern "C" int flash_attention_simt_launch(const void* q, const void* k, const void* v,
                                           void* out, int B, int S, int T_len, int K,
                                           int G, int hd, float scale, int causal,
                                           int window, int dtype, void* stream) {
  return entry<false>(q, k, v, out, B, S, T_len, K, G, hd, scale, causal, window, dtype, stream);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
