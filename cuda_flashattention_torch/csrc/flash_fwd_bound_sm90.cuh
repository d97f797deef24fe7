// The Hopper body of the forward kernels: the online Q-major walk of
// flash_fwd.cu (K1), the score-bound Q-major walk of flash_fwd_bound.cu
// (K1b), the score-bound key-split walk of flash_fwd_kmajor.cu (K5), and
// the FA1 walk of fa1.cu (K8).
//
// Replaces: cuda_flashattention_tpu/ops/flash_fwd.py::_fwd_kernel (both
// softmax forms) and ::_fwd_kernel_kmajor, in what they have in common: the
// tile loads with their dequantising casts, Q·Kᵀ and P·V, the element
// mask (causal with kv_offset, window, ragged tail, segment ids), the
// online step with its running max, the bound step p = 2^(s − c) and the
// loose-bound test. A walk decides which (Q tile, key tile) pairs a CTA
// visits and where its sums go; what a pair computes is here, so the
// kernels cannot drift apart.
//
// The machine this is written for (sm_90a):
//   - TMA (cp.async.bulk.tensor) brings Q and K/V tiles into shared memory,
//     128-byte swizzled, behind mbarriers; one producer thread issues them
//     (its warp also loads a key tile's per-token scales and segment ids).
//   - Two consumer warpgroups each own 64 query rows of a 128-row tile and
//     run wgmma.mma_async: S = Q·Kᵀ from shared memory (bf16, or s8 with
//     int32 accumulation under quantize_q), then P·V with P as the A
//     operand from registers and V from shared memory (MN-major B). S, P,
//     m, l and the O accumulator stay in registers for the whole walk.
//   - setmaxnreg gives the producer warpgroup 40 registers and the
//     consumers 232 (56 and 224 where the producer converts V).
//   - int8 or e4m3 K/V come in as codes (half the bytes of bf16) and are
//     converted once per tile into a bf16 tile (or, under quantize_q, an
//     int8 tile: fp8 keys re-gridded), written in the same swizzle wgmma
//     reads: by the consumers; in K1b's walk under a 2-byte or int8 Q at
//     d <= 128 (VSPLIT) the consumers convert K alone and the producer
//     warpgroup's three other warps convert V into a ring of its own
//     meanwhile (`convert_tile`, the storage types template arguments);
//     at d = 256 under a 2-byte or int8 Q once per call into device
//     memory instead (PRE, below).
//   - A 128-row tile packs the Gp query heads of one KV head that the host
//     chose (Gp rows blocks of R = 128 / Gp positions): each K/V tile, and
//     each conversion of one, serves Gp heads.
//   - fp32 Q, K and V (the F32 builds of K1, K1b, K5, and of K2/K4 in
//     flash_bwd_kv.cu): the producer warpgroup's 128 threads read each
//     tile from device memory and write it as two bf16 tiles, hi = bf16(x)
//     and lo = bf16(x − hi), in the swizzle TMA would have left
//     (split_rows); every product is three bf16 wgmmas with fp32 sums,
//     lo·hi + hi·lo + hi·hi, and P is split the same way in registers:
//     about 16 significant bits per operand where one bf16 rounding
//     leaves 8, within 1e-4 of the fp32 plain version where bf16 P alone
//     moves O by ~1e-3. Split tiles take twice the shared memory, so the
//     F32 builds keep fewer stages (and K5 a shorter span).
//   - an fp32 Q over bf16 K/V (the BF16KV builds of K1, K1b and K5: an
//     fp32 model reading a bf16 cache): Q is split as above, the K and V
//     tiles come by TMA as the bf16 slabs of the bf16 builds and are
//     exact bf16 operands as they stand (their lo parts are 0), so each
//     product is two wgmmas, lo·k + hi·k, and P is split as under F32.
//   - head dim 256: a tile is four 64-column slabs (a 128-row bf16 Q tile
//     64 KB, a bf16 K + V stage 64 KB) and O takes 128 registers a
//     consumer thread (acc[4][32]), so each walk runs a key tile's S,
//     softmax and P·V in order. A 2-byte (or int8) Q over one-byte K/V has
//     them converted before the walk, in one pass per call (PRE,
//     `convert_pass`), and reads the copies as bf16 K/V. An fp32 Q's
//     split tile is 128 KB, which leaves one stage beside it: one bf16
//     K + V stage (BF16KV), one code stage and one converted pair (231 KB
//     of the 232,448 bytes), and over fp32 K/V one stage of 32-key tiles
//     (BN32: their split pair is 64 KB, where a 64-key one, 128 KB, does
//     not fit); K5 keeps a ring of one Q tile beside a span of one tile.
//
// Numerics (those of the plain version, ops/flash_fwd.py::_forward_plain):
//   s = (q̂ · k_q) · k_scale[col]     fp32; under quantize_q the int32 dot
//       of the int8 Q and K times k_scale[col] · factor[h] (the host's
//       per-head factor, with 448/127 folded in for the fp8 → int8 re-grid)
//   masked pairs (causal with kv_offset, window, ragged tail, segment ids)
//       have p = 0
//   bound (K1b, K5): p = 2^(s − c_row) against the host's bound c
//   online (K1), per key tile on each row: m_new = max(m, max over the
//       tile's visible s), α = 2^(m − m_new), acc and l scaled by α,
//       p = 2^(s − m_new); a row none of whose keys is visible yet keeps
//       m = NEG_INF and p = 0
//   l sums the unrounded p
//   acc += bf16(p · v_scale[col]) · v_q     rounded AFTER the scale (F32:
//       acc += p · v from the split products, no rounding of p to bf16)
//   O = acc / l in fp32, bf16 or fp16 (out_type), LSE = ref·ln2 + ln l
//   (ref: c bound, m online); O = 0, LSE = NEG_INF (−1e30) where l = 0.
// FA1 (K8) has numerics of its own, in fa1.cu.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The 2-byte element type of a translation unit's native builds: bf16, or
// fp16 in a unit compiled with CFA_F16 (the csrc/*_f16.cu files, each of
// which includes its bf16 source whole). fp16 has bf16's width, so the
// tiles, TMA boxes, swizzles and walks are the same; the wgmma operand
// type, the packing of P (and dS) and the conversion of one-byte codes
// change. Such a unit builds the 2-byte forms only (no fp32 builds, no
// int8 Q: quantize_q's int8 Q runs the bf16 unit's build, which computes
// P·V in bf16 whatever Q's type, as the JAX kernel does), has its own copy
// of this namespace (its host helpers differ), and names its C entry
// points with the suffix _f16 (the *_f16.cu file defines each name so).
#ifdef CFA_F16
#define cfa_bound cfa_bound_f16
#define CFA_AB "f16.f16"
#else
#define CFA_AB "bf16.bf16"
#endif

namespace cfa_bound {

typedef __nv_bfloat16 bf16;
#ifdef CFA_F16
typedef __half elem;
constexpr bool kHalf = true;
#else
typedef __nv_bfloat16 elem;
constexpr bool kHalf = false;
#endif

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int BM = 128;        // query rows of a tile (two warpgroups)
constexpr int BN = 64;         // keys of a tile
// K1's and K1b's second key tile (bf16 Q and K/V only): `block_k` = 128
// selects it; every other kernel and form keeps BN
constexpr int BN2 = 128;
// the key tile of fp32 K/V under an fp32 Q at d = 256 (K1, K1b, K5, K8)
constexpr int BN32 = 32;
constexpr int NTHREADS = 384;  // two consumer warpgroups and the producer's
constexpr int NCONSUMER = 256;
constexpr int kBf16 = 0, kInt8 = 1, kFp8 = 2, kF32 = 3;  // storage codes
constexpr int kOutBf16 = 0, kOutF32 = 1, kOutF16 = 2;     // O's type codes
// a row with visible keys whose l < 2^-96 has a loose bound
constexpr float kLooseBound = 0x1p-96f;
constexpr float kRegrid = (float)(127.0 / 448.0);  // fp8 → int8 code units

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase with this parity has completed. A wait
// of more than ~2^32 cycles (seconds) is a protocol fault: it traps, so
// the launch ends in a CUDA error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 32)) {
      __trap();
    }
  }
}

// One 4-D TMA box (coordinates innermost first) into shared memory.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// Threads' shared-memory stores become visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The two consumer warpgroups only (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NCONSUMER) : "memory");
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
// all but the most recent group
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keep the compiler from moving reads of wgmma results above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// Keep registers an in-flight wgmma reads (P) from being reused before
// its wait.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, and the swizzle (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) |
         ((uint64_t)swizzle << 62);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of `rb`-byte
// rows (128 or 64) as TMA's 128 B / 64 B swizzle lays it out (the tile
// starts on a 1024-byte boundary).
__device__ __forceinline__ uint32_t swz(int row, int chunk, int rb) {
  const int x = rb == 128 ? (row & 7) : ((row >> 1) & 3);
  return (uint32_t)(row * rb + ((chunk ^ x) << 4));
}

#define CFA_D32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define CFA_I32(d)                                                        \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), \
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),        \
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),    \
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),    \
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),    \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),    \
      "+r"(d[31])
#define CFA_REGS32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"

// D[64x64] (+)= A[64x16] · B[16x64], bf16 from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." CFA_AB " " CFA_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : CFA_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

#define CFA_D16(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define CFA_REGS16                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// D[64x32] (+)= A[64x16] · B[16x32], bf16 from shared memory, both K-major
// (K3's 32-key tiles; the d = 256 backward's half of a 64-row Q tile).
__device__ __forceinline__ void wgmma_ss_bf16_n32(float (&d)[16], uint64_t da,
                                                  uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." CFA_AB " " CFA_REGS16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : CFA_D16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64x16] (+)= A[64x16] · B[16x16], bf16 from shared memory, both K-major
// (the fp32 d = 256 backward's 16-key tiles of K3 and 16-query halves of a
// K2/K4 tile).
__device__ __forceinline__ void wgmma_ss_bf16_n16(float (&d)[8], uint64_t da,
                                                  uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." CFA_AB " "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

#define CFA_D32_HI(d)                                                     \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),        \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),    \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),    \
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),    \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),    \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),    \
      "+f"(d[62]), "+f"(d[63])
#define CFA_REGS64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// D[64x128] (+)= A[64x16] · B[16x128], bf16 from shared memory, both
// K-major (the 128-key tile's S: d[j] is row (j >> 1) & 1 of the thread's
// pair, column 8·(j >> 2) + 2·(lane & 3) + (j & 1), as two m64n64 halves
// side by side would hold it).
__device__ __forceinline__ void wgmma_ss_bf16_n128(float (&d)[64], uint64_t da,
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." CFA_AB " " CFA_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : CFA_D32(d), CFA_D32_HI(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64x64] (+)= A[64x32] · B[32x64], s8 from shared memory, int32 sums.
__device__ __forceinline__ void wgmma_ss_s8(int (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " CFA_REGS32
      ", %32, %33, p;\n}\n"
      : CFA_I32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64x64] += A[64x16] · B[16x64], A (bf16 pairs) from registers, B bf16
// MN-major (transposed) from shared memory.
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[32],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." CFA_AB " " CFA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : CFA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// What both walks are given, and the host's TMA descriptors
// ---------------------------------------------------------------------------

struct Args {
  const float* k_scale;   // [B,Hkv,Nk] or null (bf16 K/V)
  const float* v_scale;   // [B,Hkv,Nk] or null
  const float* q_factor;  // [B,H] under quantize_q: the int8 Q to log2 units
  const float* c;         // [B,H,Nq] log2 score bound (bound forms)
  int* n_loose;           // count of loose-bound rows (bound forms)
  float* l_acc;           // K5: [B,H,Nq] fp32, zeroed
  float* o_acc;           // K5: [B,H,Nq,D] fp32, zeroed
  void* o;                // [B,H,Nq,D] out_type, contiguous
  float* lse;             // [B,H,Nq]
  int H, Hkv, Nq, Nk;
  int G, Gp, R;           // group size, heads packed in a tile, rows per head
  int k_type, v_type;
  int causal, window, kv_offset, out_type;  // out_type: kOut*
  int span;               // K5: key tiles per CTA
};

// Bytes of the tiles in shared memory; every tile starts on 1024 bytes.
// Under quantize_q (QQ) the int8 Q and K tiles hold a row in one slab of D
// bytes up to D = 128 (64 B or 128 B swizzle), and at D = 256 in two slabs
// of 128 bytes, as a bf16 tile holds its 64-column slabs.
template <int D, bool QQ>
struct Tiles {
  static constexpr int SLABS = D / 64;            // bf16 slabs of 64 columns
  static constexpr int Q = QQ ? BM * D : BM * D * 2;
  static constexpr int KV16 = BN * D * 2;          // a bf16 K or V tile
  static constexpr int CODES = BN * D;             // one-byte codes
  static constexpr int KC = QQ ? CODES : KV16;     // a K tile wgmma reads
  static constexpr int QROW = QQ && D < 128 ? D : 128;  // row bytes per slab
  static constexpr int QSLABS = QQ ? D / QROW : SLABS;  // slabs of a Q row
  static constexpr int QCOL = QQ ? QROW : 64;      // elements of a Q slab row
  static constexpr int QSWZ = QROW == 128 ? 1 : 2;
  static_assert(D == 64 || D == 128 || D == 256, "head dims 64, 128, 256");
};

__host__ __device__ constexpr int align1k(int x) { return (x + 1023) & ~1023; }
__host__ __device__ constexpr int align8(int x) { return (x + 7) & ~7; }

// The key tile of a forward build that takes the 64-key tile's place: BN32
// for an fp32 Q over fp32 K/V at d = 256, BN everywhere else.
__host__ __device__ constexpr int key_tile(int D, bool f32, int k_type) {
  return D == 256 && f32 && k_type == kF32 ? BN32 : BN;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so that
// the library needs no link against libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 4-D map over [n3][n2][n1][n0] (n0 innermost, unit stride; s1..s3 the
// outer strides in bytes) read in boxes of b0 x b1 x b2 x 1. Past n1 (the
// live rows) TMA fills zeros.
inline bool encode4(CUtensorMap* map, const void* base, bool one_byte,
                    long long n0, long long n1, long long n2, long long n3,
                    long long s1, long long s2, long long s3, int b0, int b1,
                    int b2, int swizzle_bytes) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const long long n[4] = {n0, n1, n2, n3};
  const long long s[3] = {s1, s2, s3};
  cuuint64_t dims[4], strides[3];
  for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)(n[i] > 0 ? n[i] : 1);
  // a stride of 0 (a broadcast dimension of size 1) is never stepped
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)(s[i] > 0 ? s[i] : 16);
  const cuuint32_t box[4] = {(cuuint32_t)b0, (cuuint32_t)b1, (cuuint32_t)b2,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_NONE;
  return fn(map,
            one_byte ? CU_TENSOR_MAP_DATA_TYPE_UINT8
            : kHalf  ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap q, k, v;
};

// The maps of one call. Q [B,H,Nq,D] (bf16, or int8 under quantize_q) in
// boxes of a slab's columns x R positions x Gp heads; K and V
// [B,Hkv,Nk,D] in boxes of kn keys (BN, or BN2 for the 128-key builds of
// K1 and K1b): bf16 as 64-column slabs, 128 B
// swizzled, one-byte codes whole rows unswizzled (the consumers convert
// them); no Q map when q is null (an fp32 Q, which the producer
// warpgroup reads and splits). strides: q, k, v, each (batch, head, row),
// in elements.
inline bool make_maps(Maps* m, const void* q, const void* k, const void* v,
                      int B, int H, int Hkv, int Nq, int Nk, int D,
                      const long long* st, int k_type, int v_type, int qq,
                      int Gp, int R, int kn = BN) {
  const int qe = qq ? 1 : 2;
  // an int8 Q row is one slab of up to 128 bytes (two at D = 256, Tiles)
  const int q_row = D < 128 ? D : 128;
  bool ok = q == nullptr ||
            encode4(&m->q, q, qq, D, Nq, H, B, st[2] * qe, st[1] * qe,
                    st[0] * qe, qq ? q_row : 64, R, Gp, qq ? q_row : 128);
  const void* kv[2] = {k, v};
  const int types[2] = {k_type, v_type};
  CUtensorMap* maps[2] = {&m->k, &m->v};
  for (int i = 0; i < 2; ++i) {
    const bool byte = types[i] != kBf16;
    const int e = byte ? 1 : 2;
    const long long* s = st + 3 * (i + 1);
    ok = ok && encode4(maps[i], kv[i], byte, D, Nk, Hkv, B, s[2] * e,
                       s[1] * e, s[0] * e, byte ? D : 64, kn, 1,
                       byte ? 0 : 128);
  }
  return ok;
}

// Query heads of one KV head packed into a 128-row tile: the largest
// divisor of the group size up to 16 (R = 128 / Gp positions each).
inline int packed_heads(int G) {
  int gp = 1;
  for (int d = 1; d <= 16 && d <= G; ++d) {
    if (G % d == 0) gp = d;
  }
  return gp;
}

// ---------------------------------------------------------------------------
// Device parts of a tile pair
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 fp8x2_to_float2(unsigned short pair) {
  const __half2_raw raw = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair), __NV_E4M3);
  return __half22float2(__half2(raw));
}

// 16 stored one-byte values (int8 or e4m3) as floats; both embed in fp32.
__device__ __forceinline__ void cvt16(const uint4& raw, int type, float* out) {
  const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (type == kInt8) {
      out[4 * i + 0] = (float)(signed char)(w[i] & 0xffu);
      out[4 * i + 1] = (float)(signed char)((w[i] >> 8) & 0xffu);
      out[4 * i + 2] = (float)(signed char)((w[i] >> 16) & 0xffu);
      out[4 * i + 3] = (float)(signed char)(w[i] >> 24);
    } else {
      const float2 fa = fp8x2_to_float2((unsigned short)(w[i] & 0xffffu));
      const float2 fb = fp8x2_to_float2((unsigned short)(w[i] >> 16));
      out[4 * i + 0] = fa.x; out[4 * i + 1] = fa.y;
      out[4 * i + 2] = fb.x; out[4 * i + 3] = fb.y;
    }
  }
}

// Four one-byte codes (a 32-bit word) as two 2-byte pairs (bf16, or fp16
// in the fp16 unit), exactly:
//   int8, bf16: byte b ^ 0x80 = b + 128 goes in the low mantissa bits of
//         2^23, 2^23 + 128 is subtracted in fp32, and the bf16 is the
//         fp32's upper half (at most 8 significant bits). A bf16x2 fma on
//         the sign-split code, fewer instructions, ran K1 over int8 4%
//         slower than this (PERF.md §6);
//   int8, fp16: b ^ 0x80 = b + 128 in the mantissa of 1024 (0x6400), 1152
//         subtracted, a pair at a time in the halves of one register;
//   e4m3: the hardware's cvt to an fp16 pair (exact: 3 mantissa bits,
//         e4m3's least subnormal 2^-9 a normal fp16), and for bf16 the
//         fp16's exponent and top 7 mantissa bits moved down 3 bits (the
//         fp16 exponent field read as bf16's, off by 127 − 15 = 112) and
//         one multiply by 2^112 (every nonzero value is a normal fp16, so
//         a normal bf16; zero stays zero; NaN codes, which no quantizer
//         writes, come out as finite values). It replaced a move of the
//         bits into an fp32 and a multiply by 2^120 a code (~6.5
//         instructions a code against 2.5; PERF.md §6).
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Codes 0 and 1 (sel 0x4140) or 2 and 3 (sel 0x4342) of w as one pair,
// but int8 codes into bf16 (codes4_to_elem_t)
template <int TYPE>
__device__ __forceinline__ uint32_t codes2_to_elem(uint32_t w, uint32_t sel) {
  if constexpr (TYPE == kInt8) {
    static_assert(kHalf || TYPE != kInt8, "int8 into bf16: four at a time");
    const uint32_t h = __byte_perm(w ^ 0x80808080u, 0x64646464u, sel);
    const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&h),
                              __half2(__float2half(1152.f),
                                      __float2half(1152.f)));
    return *reinterpret_cast<const uint32_t*>(&r);
  } else {
    const __half2_raw raw = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(sel == 0x4140u ? w & 0xFFFFu
                                                         : w >> 16),
        __NV_E4M3);
    const uint32_t h = static_cast<uint32_t>(raw.x) |
                       (static_cast<uint32_t>(raw.y) << 16);
    if constexpr (kHalf) {
      return h;
    } else {
      // 0x7780 is 2^112 in bf16; -0 added keeps a product's sign and bits
      return bf16x2_fma(((h >> 3) & 0x0FFF0FFFu) | (h & 0x80008000u),
                        0x77807780u, 0x80008000u);
    }
  }
}

template <int TYPE>
__device__ __forceinline__ void codes4_to_elem_t(uint32_t w, uint32_t& lo,
                                                 uint32_t& hi) {
  if constexpr (TYPE == kInt8 && !kHalf) {
    const uint32_t u = w ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + k)) -
             8388736.0f;
    }
    lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  } else {
    lo = codes2_to_elem<TYPE>(w, 0x4140u);  // codes 0, 1
    hi = codes2_to_elem<TYPE>(w, 0x4342u);  // codes 2, 3
  }
}

// (the storage type known at run time)
__device__ __forceinline__ void codes4_to_elem(uint32_t w, int type,
                                               uint32_t& lo, uint32_t& hi) {
  if (type == kInt8) {
    codes4_to_elem_t<kInt8>(w, lo, hi);
  } else {
    codes4_to_elem_t<kFp8>(w, lo, hi);
  }
}

// 16 e4m3 codes re-gridded onto int8 codes, clip(round_half_even(k ·
// 127/448), ±127): quantize_q's int8 K over fp8 keys.
__device__ __forceinline__ uint4 regrid16(const uint4& codes) {
  float f[16];
  cvt16(codes, kFp8, f);
  unsigned int q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q[i] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int code =
          max(-127, min(127, __float2int_rn(f[4 * i + e] * kRegrid)));
      q[i] |= ((unsigned int)code & 0xffu) << (8 * e);
    }
  }
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// One tile of 64 rows of D one-byte codes (dense, as TMA left them) into
// the tile wgmma reads: a 2-byte tile (D/64 slabs of 64 rows x 128 B, 128
// B swizzled) of codes of storage type TYPE, or under S8 quantize_q's int8
// tile (rows of QROW bytes in slabs; int8 codes copied, e4m3 re-gridded).
// NT threads, tid the thread's index among them, U 16-code chunks in
// flight a thread: the types are template arguments, so that no branch
// separates one word's conversion from the next and the compiler can
// interleave them (with the type a run-time value, a branch and a
// divergence barrier a word cost a lone warp most of its issue rate).
template <int D, int TYPE, bool S8, int NT>
__device__ __forceinline__ void convert_tile(uint8_t* dst,
                                             const uint8_t* raw, int tid) {
  constexpr int CPR = D / 16;      // 16-code chunks of a row
  constexpr int N1 = BN * CPR;     // chunks of the tile
  constexpr int U = 4;
  constexpr int QROW = Tiles<D, true>::QROW;
  constexpr int CPS = QROW / 16;   // chunks of an s8 row in one slab
  for (int w0 = tid; w0 < N1; w0 += U * NT) {
    uint4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = w0 + u * NT;
      x[u] = w < N1 ? *reinterpret_cast<const uint4*>(raw + w * 16)
                    : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = w0 + u * NT;
      if (w >= N1) continue;  // (no break: x stays in registers)
      const int row = w / CPR, j = w % CPR;
      if constexpr (S8) {
        const uint4 c = TYPE == kFp8 ? regrid16(x[u]) : x[u];
        *reinterpret_cast<uint4*>(dst + (j / CPS) * (BN * QROW) +
                                  swz(row, j % CPS, QROW)) = c;
      } else {
        uint32_t h[8];
        codes4_to_elem_t<TYPE>(x[u].x, h[0], h[1]);
        codes4_to_elem_t<TYPE>(x[u].y, h[2], h[3]);
        codes4_to_elem_t<TYPE>(x[u].z, h[4], h[5]);
        codes4_to_elem_t<TYPE>(x[u].w, h[6], h[7]);
        // 2-byte columns 16j .. 16j + 15: slab j / 4, chunks 2(j % 4), + 1
        uint8_t* slab = dst + (j >> 2) * (BN * 128);
        *reinterpret_cast<uint4*>(slab + swz(row, 2 * (j & 3), 128)) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(slab + swz(row, 2 * (j & 3) + 1, 128)) =
            make_uint4(h[4], h[5], h[6], h[7]);
      }
    }
  }
}

// A key tile's codes (K's or V's, dense, as TMA left them) into the tile
// wgmma reads, as convert_tile lays it out: a 2-byte tile, or under S8
// quantize_q's int8 K tile; `type` the storage type (int8 or e4m3: K and
// V may differ). Every int8 and e4m3 value is a bf16 and an fp16 value,
// so the conversion is exact. NT threads, tid the thread's index among
// them; the caller fences the stores (fence_proxy_async) before wgmma
// may read them.
template <int D, bool S8, int NT>
__device__ __forceinline__ void convert_codes(uint8_t* dst, const uint8_t* raw,
                                              int type, int tid) {
  if (type == kInt8) {
    convert_tile<D, kInt8, S8, NT>(dst, raw, tid);
  } else {
    convert_tile<D, kFp8, S8, NT>(dst, raw, tid);
  }
}

// One key tile's per-token K scales then V scales, sc[0..2·BN) (0 past the
// ragged end, where every pair is masked), by NT threads. Plain loads: a
// scale row is not 16-byte aligned for every Nk.
template <int NT>
__device__ __forceinline__ void load_scales(float* sc, const Args& a, int b,
                                            int hk, int c0, int tid) {
  const long long base = (long long)(b * a.Hkv + hk) * a.Nk;
  for (int i = tid; i < 2 * BN; i += NT) {
    const int c = c0 + (i & (BN - 1));
    const float* src = i < BN ? a.k_scale : a.v_scale;
    sc[i] = c < a.Nk ? src[base + c] : 0.f;
  }
}

// One key tile's segment ids, ids[0..KN) (past the ragged end the pair is
// masked by the column test), by NT threads; kv_seg is [B,Nk].
template <int NT, int KN = BN>
__device__ __forceinline__ void load_ids(int* ids, const int* kv_seg,
                                         const Args& a, int b, int c0,
                                         int tid) {
  for (int i = tid; i < KN; i += NT) {
    const int c = c0 + i;
    ids[i] = c < a.Nk ? kv_seg[(long long)b * a.Nk + c] : -1;
  }
}

// The (Q tile, head group, batch) of this CTA of a Q-major grid (Q tiles,
// head groups, batches). Under causal the linear block index walks the Q
// tiles from the last to the first, all head groups and batches of one
// tile together: the last tiles see the most keys, so the longest walks
// start in the first wave and the short ones fill the tail (K1, K8).
__device__ __forceinline__ void cta_tile(const Args& a, int& qt, int& hg,
                                         int& b) {
  qt = blockIdx.x;
  hg = blockIdx.y;
  b = blockIdx.z;
  if (a.causal) {
    const long long per_tile = (long long)gridDim.y * gridDim.z;
    const long long lin =
        blockIdx.x + (long long)gridDim.x * (blockIdx.y + (long long)gridDim.y *
                                                              blockIdx.z);
    qt = gridDim.x - 1 - (int)(lin / per_tile);
    const int rest = (int)(lin % per_tile);
    hg = rest % gridDim.y;
    b = rest / gridDim.y;
  }
}

// The two rows a consumer thread holds in wgmma's accumulator layout
// (warp w of warpgroup g: rows 64g + 16w + lane/4 and that + 8), as
// (query head, position) of the packed tile.
struct Rows {
  int pos[2];    // position, or -1 past the tile
  int head[2];   // query head
  int qp[2];     // position + kv_offset
  float c[2];    // the bound (bound forms); the online walk puts its
                 // running max here before the epilogue: the LSE's reference
  float f[2];    // quantize_q's factor, else 1
};

template <bool BOUND = true>
__device__ __forceinline__ Rows row_info(const Args& a, int b, int h0, int q0,
                                         int tid) {
  Rows r;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 +
                    ((tid & 31) >> 2) + 8 * hr;
    const int g = row / a.R;
    const int pos = q0 + row - g * a.R;
    const bool ok = g < a.Gp && pos < a.Nq;
    r.pos[hr] = ok ? pos : -1;
    r.head[hr] = h0 + (ok ? g : 0);
    r.qp[hr] = pos + a.kv_offset;
    if (BOUND) {
      r.c[hr] = ok ? a.c[(long long)(b * a.H + r.head[hr]) * a.Nq + pos] : 0.f;
    } else {
      r.c[hr] = kNegInf;
    }
    r.f[hr] = ok && a.q_factor != nullptr ? a.q_factor[b * a.H + r.head[hr]]
                                          : 1.f;
  }
  return r;
}

// Key tiles [t_begin, t_end) of KN keys within [t_lo, t_hi) that positions
// q_lo..q_hi can see: causal rows see keys <= pos + kv_offset, windowed
// ones keys > pos + kv_offset − window.
template <int KN = BN>
__device__ __forceinline__ void visible_tiles(const Args& a, int q_lo, int q_hi,
                                              int t_lo, int t_hi, int& t_begin,
                                              int& t_end) {
  t_begin = t_lo;
  t_end = t_hi;
  if (a.causal) {
    const int kv_end = min(a.Nk, max(0, q_hi + a.kv_offset + 1));
    t_end = min(t_end, (kv_end + KN - 1) / KN);
    if (a.window > 0) {
      t_begin = max(t_begin, max(0, q_lo + a.kv_offset - a.window + 1) / KN);
    }
  }
}

// Whether every (position in q_lo..q_hi, key of the KN-key tile at c0)
// pair is visible, so that the element mask can be skipped.
template <int KN = BN>
__device__ __forceinline__ bool interior(const Args& a, int c0, int q_lo,
                                         int q_hi) {
  if (c0 + KN > a.Nk) return false;
  if (a.causal) {
    if (c0 + KN - 1 > q_lo + a.kv_offset) return false;
    if (a.window > 0 && c0 <= q_hi + a.kv_offset - a.window) return false;
  }
  return true;
}

// The two products of a tile pair, issued without a fence, a commit or a
// wait: S = Q·Kᵀ of this warpgroup's rows (bf16; ACC adds into s) over a
// K tile of KN keys (BN, or BN2: one m64n128 wgmma a step, s holding 64
// columns a thread's row pair more) and acc += P·V. qk() and pv() wait for
// each; the online walk overlaps them.
template <int D, bool ACC = false, int KN = BN>
__device__ __forceinline__ void qk_issue(float (&s)[KN / 2], uint32_t q,
                                         uint32_t k, int wg) {
  static_assert(KN == BN || KN == BN2 || KN == BN32,
                "key tiles of 32, 64 or 128");
#pragma unroll
  for (int sl = 0; sl < D / 64; ++sl) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da =
          make_desc(q + sl * BM * 128 + wg * 64 * 128 + kk * 32, 16, 1024, 1);
      const uint64_t db = make_desc(k + sl * KN * 128 + kk * 32, 16, 1024, 1);
      if constexpr (KN == BN2) {
        wgmma_ss_bf16_n128(s, da, db, ACC || sl + kk > 0);
      } else if constexpr (KN == BN32) {
        wgmma_ss_bf16_n32(s, da, db, ACC || sl + kk > 0);
      } else {
        wgmma_ss_bf16(s, da, db, ACC || sl + kk > 0);
      }
    }
  }
}

// (KN: the keys of the V tile, 64, 32 (K3's fp32 and BN32 tiles) or the
// 128-key builds' BN2; P holds KN / 4 pairs)
template <int D, int KN = BN>
__device__ __forceinline__ void pv_issue(float (&acc)[D / 64][32],
                                         const uint32_t (&p)[KN / 4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk) {
#pragma unroll
    for (int sl = 0; sl < D / 64; ++sl) {
      wgmma_rs_bf16(acc[sl], &p[4 * kk],
                    make_desc(v + sl * KN * 128 + kk * 16 * 128, 1024, 1024,
                              1));
    }
  }
}

// The fp32 forms' products on split tiles: an fp32 operand x is held as
// two bf16 tiles, hi = bf16(x) and lo = bf16(x − hi), lo right after hi
// (a BM-row tile's lo BM·D·2 bytes on, a BN-row tile's BN·D·2), and a
// product as three bf16 wgmmas with fp32 sums, lo·hi + hi·lo + hi·hi: x =
// hi + lo to 2^-17 relatively, and the dropped lo·lo term is ~2^-16 of a
// product, where one bf16 rounding costs 2^-9.
//
// EXACT_KV: the K (V) tile is one bf16 tile that holds its values exactly
// (one-byte codes converted under an fp32 Q: every int8 code and every
// e4m3 value is a bf16 value), so its lo part is 0 and the product is two
// wgmmas, lo·k + hi·k.
template <int D, bool EXACT_KV = false, int KN = BN>
__device__ __forceinline__ void qk_issue_f32(float (&s)[KN / 2], uint32_t q,
                                             uint32_t k, int wg) {
  qk_issue<D, false, KN>(s, q + BM * D * 2, k, wg);
  if (!EXACT_KV) qk_issue<D, true, KN>(s, q, k + KN * D * 2, wg);
  qk_issue<D, true, KN>(s, q, k, wg);
}

// acc += P·V with P = p + p_lo in registers and V split in shared memory
// (EXACT_KV: V one exact bf16 tile; KN as pv_issue's).
template <int D, bool EXACT_KV = false, int KN = BN>
__device__ __forceinline__ void pv_issue_f32(float (&acc)[D / 64][32],
                                             const uint32_t (&p)[KN / 4],
                                             const uint32_t (&p_lo)[KN / 4],
                                             uint32_t v) {
  pv_issue<D, KN>(acc, p_lo, v);
  if (!EXACT_KV) pv_issue<D, KN>(acc, p, v + KN * D * 2);
  pv_issue<D, KN>(acc, p, v);
}

// qk_issue or, under F32, qk_issue_f32; pv_issue or pv_issue_f32.
template <int D, bool F32, bool EXACT_KV = false, int KN = BN>
__device__ __forceinline__ void qk_issue_any(float (&s)[KN / 2], uint32_t q,
                                             uint32_t k, int wg) {
  if constexpr (F32) {
    qk_issue_f32<D, EXACT_KV, KN>(s, q, k, wg);
  } else {
    qk_issue<D, false, KN>(s, q, k, wg);
  }
}
template <int D, bool F32, bool EXACT_KV = false, int KN = BN>
__device__ __forceinline__ void pv_issue_any(float (&acc)[D / 64][32],
                                             const uint32_t (&p)[KN / 4],
                                             const uint32_t (&p_lo)[KN / 4],
                                             uint32_t v) {
  if constexpr (F32) {
    pv_issue_f32<D, EXACT_KV, KN>(acc, p, p_lo, v);
  } else {
    pv_issue<D, KN>(acc, p, v);
  }
}

// Two fp32 values as bf16 pairs hi = bf16(x), lo = bf16(x − hi).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Two floats rounded to the unit's element type, packed as one pair (a in
// the low half): P and dS as the 2-byte builds' wgmma operands.
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  if constexpr (kHalf) {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// Rounding codes of the fp32 builds' mixed-type forms (F32Src::round): x
// as it is (0), rounded to bf16 (1) or to fp16 (2). JAX computes a product
// of two float types on exactly upcast operands, except where it first
// casts P (or dS) to a narrower type: the fp32 builds hold the upcast
// operands and round P (dS) to that type before they split it, which is
// then exact (an fp16 has 11 significant bits, hi + lo hold 16).
__device__ __forceinline__ float round_to(float x, int mode) {
  if (mode == 1) return __bfloat162float(__float2bfloat16_rn(x));
  if (mode == 2) return __half2float(__float2half_rn(x));
  return x;
}

// split2 of the two values rounded first (round_to's codes).
__device__ __forceinline__ void split2r(float a, float b, int mode,
                                        uint32_t& hi, uint32_t& lo) {
  split2(round_to(a, mode), round_to(b, mode), hi, lo);
}

// An fp32 tile of `rows` rows x D from device memory into its bf16 hi and
// lo tiles as wgmma reads them: D/64 slabs of `rows` rows x 128 B, 128 B
// swizzled as TMA lays out a bf16 tile. Tile row r is position pos0 + r %
// R of head h0 + r / R (zeros for heads from h0 + heads on, or positions
// from n on); src is the operand at this batch, s_head and s_row its
// strides in elements (rows 16-byte aligned). NT threads share the work;
// tid is the thread's index among them. Each thread issues its loads four
// at a time before it splits and stores them: one load in flight per
// thread leaves the producer waiting out device-memory latency per 16
// bytes. The caller fences the stores (fence_proxy_async) before wgmma may
// read them.
template <int D, int NT>
__device__ __forceinline__ void split_rows(uint8_t* hi, uint8_t* lo, int rows,
                                          const float* src, long long s_head,
                                          long long s_row, int h0, int heads,
                                          int R, int pos0, int n, int tid) {
  constexpr int C4 = D / 4;  // float4s in a row
  constexpr int U = 4;       // loads in flight per thread
  const int total = rows * C4;
  for (int w0 = tid; w0 < total; w0 += U * NT) {
    float4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = w0 + u * NT;
      const int r = w / C4, c = w % C4;
      const int g = r / R, pos = pos0 + r - g * R;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (w < total && g < heads && pos < n) {
        x[u] = __ldg(reinterpret_cast<const float4*>(
                         src + (h0 + g) * s_head + (long long)pos * s_row) +
                     c);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = w0 + u * NT;
      if (w >= total) break;
      const int r = w / C4, c = w % C4;
      uint2 h, l;
      split2(x[u].x, x[u].y, h.x, l.x);
      split2(x[u].z, x[u].w, h.y, l.y);
      // columns 4c .. 4c + 3: slab c / 16, 16-byte chunk (c % 16) / 2,
      // half c % 2 of it
      const uint32_t off =
          (c >> 4) * rows * 128 + swz(r, (c & 15) >> 1, 128) + (c & 1) * 8;
      *reinterpret_cast<uint2*>(hi + off) = h;
      *reinterpret_cast<uint2*>(lo + off) = l;
    }
  }
}

// The fp32 operands of a call: base pointers (q, k, v and, for the
// backward, dO) and their (batch, head, row) strides in elements. A
// kernel parameter of the fp32 builds beside Args, which it leaves as the
// other forms compile it.
struct F32Src {
  const float* p[4];
  long long st[12];
  // round_to's codes: [0] P before P·V (the forward; dV's Pᵀ·dO in the
  // backward), [1] dS before dSᵀ·Q and dS·K (the backward). 0 where every
  // operand was fp32; a mixed-type call upcasts its 2-byte operands and
  // rounds where JAX rounds.
  int round[2];
};

// A forward entry point's q, k, v pointers and their nine strides; q_f32
// is the entry points' code: 1 an fp32 Q, 2 / 3 an fp32 Q whose P is
// rounded to bf16 / fp16 before P·V (round_to's 1 / 2).
inline F32Src f32_src(void* const* ptrs, const long long* strides,
                      int q_f32) {
  F32Src f = {};
  for (int i = 0; i < 3; ++i) f.p[i] = static_cast<const float*>(ptrs[i]);
  for (int i = 0; i < 9; ++i) f.st[i] = strides[i];
  f.round[0] = q_f32 > 1 ? q_f32 - 1 : 0;
  return f;
}

// S[64xKN] of this warpgroup's rows = Q · Kᵀ. q: the Q tile, k: the K
// tile (shared-memory addresses; split tiles under F32; KN as qk_issue's,
// 64 under QQ).
template <int D, bool QQ, bool F32 = false, bool EXACT_KV = false,
          int KN = BN>
__device__ __forceinline__ void qk(float (&s)[KN / 2], uint32_t q, uint32_t k,
                                   int wg) {
  using T = Tiles<D, QQ>;
  if constexpr (QQ) {
    static_assert(KN == BN && !F32, "quantize_q: 64-key tiles, int8 Q");
    int si[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      // 32 bytes of depth a step: slab sl of the rows, offset `off` in it
      const int sl = kk * 32 / T::QROW, off = kk * 32 % T::QROW;
      wgmma_ss_s8(si,
                  make_desc(q + sl * BM * T::QROW + wg * 64 * T::QROW + off,
                            16, 8 * T::QROW, T::QSWZ),
                  make_desc(k + sl * BN * T::QROW + off, 16, 8 * T::QROW,
                            T::QSWZ),
                  kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(si);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = (float)si[i];
  } else {
    wgmma_fence();
    qk_issue_any<D, F32, EXACT_KV, KN>(s, q, k, wg);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
  }
}

// acc[64xD] += P[64xKN] · V[KNxD]: P from registers (bf16 pairs in the A
// layout, which is S's accumulator layout), V MN-major from shared memory;
// under F32 P = p + p_lo and V split (EXACT_KV: V one exact bf16 tile).
template <int D, bool F32 = false, bool EXACT_KV = false, int KN = BN>
__device__ __forceinline__ void pv(float (&acc)[D / 64][32],
                                   const uint32_t (&p)[KN / 4], uint32_t v,
                                   const uint32_t* p_lo = nullptr) {
  wgmma_fence();
  if constexpr (F32) {
    pv_issue_f32<D, EXACT_KV, KN>(
        acc, p, *reinterpret_cast<const uint32_t(*)[KN / 4]>(p_lo), v);
  } else {
    pv_issue<D, KN>(acc, p, v);
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int sl = 0; sl < D / 64; ++sl) fence_regs(acc[sl]);
}

// Copies of wgmma results, read after their wait: the volatile moves keep
// the reads below the wait, and the accumulator registers are not written
// while a later group is still in flight (ptxas would serialize the
// groups).
template <int N>
__device__ __forceinline__ void copy_after_wait(float (&dst)[N],
                                                const float (&src)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    asm volatile("mov.b32 %0, %1;" : "=f"(dst[i]) : "f"(src[i]) : "memory");
  }
}

template <int D>
__device__ __forceinline__ void scale_acc(float (&acc)[D / 64][32],
                                          const float (&f)[2]) {
#pragma unroll
  for (int sl = 0; sl < D / 64; ++sl) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[sl][i] *= f[(i >> 1) & 1];
  }
}

// The bound step on this thread's KN / 2 scores of a tile pair (32, or 64
// over a BN2 tile): p = 2^(s − c) (0 where masked), l += p, P = bf16(p ·
// v_scale) packed in pairs (under F32 split: P = p + p_lo, P rounded
// first by p_round, round_to's code). With MASKED false every pair is
// visible and no element is tested.
template <bool QUANT, bool QQ, bool MASKED, bool F32 = false, int KN = BN>
__device__ __forceinline__ void bound_step(const Args& a, const Rows& r,
                                           const float (&s)[KN / 2],
                                           const float* ksc, const float* vsc,
                                           int c0, float (&l)[2],
                                           uint32_t (&p)[KN / 4],
                                           uint32_t* p_lo = nullptr,
                                           int p_round = 0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < KN / 2; i += 2) {
    float pr[2];
    // the pair's two columns are adjacent: their scales in one 8-byte load
    // each (the scale rows start on 8 bytes)
    float ks[2] = {1.f, 1.f}, vs[2] = {1.f, 1.f};
    if (QUANT) {
      const int pair = 8 * (i >> 2) + 2 * (lane & 3);
      const float2 k2 = *reinterpret_cast<const float2*>(ksc + pair);
      const float2 v2 = *reinterpret_cast<const float2*>(vsc + pair);
      ks[0] = k2.x; ks[1] = k2.y; vs[0] = v2.x; vs[1] = v2.y;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = i + e;
      const int col = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      const int hr = (j >> 1) & 1;
      float x = s[j];
      // the scaled score rounded before the bound is taken off, as the
      // plain version rounds it: contracted into one fma with the
      // subtraction below, it would round (or not) by each kernel's code
      // layout, and K1b and K5 flip different bf16 roundings of P
      if (QUANT) {
        x = __fmul_rn(x, QQ ? __fmul_rn(ks[e], r.f[hr]) : ks[e]);
      }
      bool ok = true;
      if (MASKED) {
        const int cg = c0 + col;
        ok = cg < a.Nk;
        if (a.causal) {
          ok = ok && cg <= r.qp[hr] &&
               (a.window <= 0 || cg > r.qp[hr] - a.window);
        }
      }
      const float pe = ok ? exp2f(x - r.c[hr]) : 0.f;
      l[hr] += pe;
      pr[e] = QUANT ? pe * vs[e] : pe;
    }
    if (F32) {
      split2r(pr[0], pr[1], p_round, p[i >> 1], p_lo[i >> 1]);
    } else {
      p[i >> 1] = pack2(pr[0], pr[1]);
    }
  }
}

// The online step on this thread's KN / 2 scores of a tile pair (its two
// rows' columns in wgmma's accumulator layout; the four lanes of a quad
// share a row): the tile's row max over visible pairs, m_new = max(m, it),
// α = 2^(m − m_new) applied to l and returned for acc (which the caller
// scales once the P·V before it has landed), p = 2^(s − m_new) (0 where
// masked), l += p, P = bf16(p · v_scale) packed in pairs (under F32
// split: P = p + p_lo). With MASKED false every pair is visible and no
// element is tested; SEG adds the segment-id test (kseg: the tile's key
// ids, qseg: the two rows' ids).
template <bool QUANT, bool SEG, bool MASKED, bool F32 = false, int KN = BN>
__device__ __forceinline__ void online_step(
    const Args& a, const Rows& r, float (&s)[KN / 2], const float* ksc,
    const float* vsc, const int* kseg, const int (&qseg)[2], int c0,
    float (&m)[2], float (&l)[2], float (&alpha)[2], uint32_t (&p)[KN / 4],
    uint32_t* p_lo = nullptr, int p_round = 0) {
  const int lane = threadIdx.x & 31;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < KN / 2; ++j) {
    const int col = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
    const int hr = (j >> 1) & 1;
    float x = s[j];
    if (QUANT) x = __fmul_rn(x, ksc[col]);  // rounded, as in bound_step
    if (MASKED) {
      const int cg = c0 + col;
      bool ok = cg < a.Nk;
      if (a.causal) {
        ok = ok && cg <= r.qp[hr] &&
             (a.window <= 0 || cg > r.qp[hr] - a.window);
      }
      if (SEG) ok = ok && kseg[col] == qseg[hr];
      x = ok ? x : kNegInf;
    }
    s[j] = x;
    mx[hr] = fmaxf(mx[hr], x);
  }
  float m_new[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    m_new[hr] = fmaxf(m[hr], mx[hr]);
    alpha[hr] = exp2f(m[hr] - m_new[hr]);
    m[hr] = m_new[hr];
    l[hr] *= alpha[hr];
  }
#pragma unroll
  for (int i = 0; i < KN / 2; i += 2) {
    float pr[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = i + e;
      const int col = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      const int hr = (j >> 1) & 1;
      // a masked pair of a row with no visible key so far has s = m_new
      // = NEG_INF: its p is forced to 0
      const float pe = !MASKED || s[j] > kNegInf * 0.5f
                           ? exp2f(s[j] - m_new[hr])
                           : 0.f;
      l[hr] += pe;
      pr[e] = QUANT ? pe * vsc[col] : pe;
    }
    if (F32) {
      split2r(pr[0], pr[1], p_round, p[i >> 1], p_lo[i >> 1]);
    } else {
      p[i >> 1] = pack2(pr[0], pr[1]);
    }
  }
}

// Each row's l summed over the four lanes that hold its columns.
__device__ __forceinline__ void quad_sum(float (&l)[2]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
}

// Whether query position `pos` provably has a visible key (the loose-bound
// test applies to such rows only; an empty row's l = 0 is legitimate).
__device__ __forceinline__ bool provably_visible(const Args& a, int pos) {
  if (!a.causal) return true;
  const int g = pos + a.kv_offset;
  return g >= 0 && (a.window <= 0 || g - a.window + 1 <= a.Nk - 1);
}

// One row's LSE and, for the bound forms, the loose-bound test (by one
// lane).
template <bool BOUND = true>
__device__ __forceinline__ void finish_row(const Args& a, long long row,
                                           int pos, float l, float c) {
  a.lse[row] = l == 0.f ? kNegInf : c * kLn2 + logf(l);
  if (BOUND && l < kLooseBound && provably_visible(a, pos)) {
    atomicAdd(a.n_loose, 1);
  }
}

// O elements e and e + 1 (e even) in O's type.
__device__ __forceinline__ void store_pair(const Args& a, long long e,
                                           float v0, float v1) {
  if (a.out_type == kOutF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(a.o) + e) =
        make_float2(v0, v1);
  } else if (a.out_type == kOutF16) {
    *reinterpret_cast<__half2*>(static_cast<__half*>(a.o) + e) =
        __floats2half2_rn(v0, v1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.o) + e) =
        __floats2bfloat162_rn(v0, v1);
  }
}

// O element e in O's type.
__device__ __forceinline__ void store_one(const Args& a, long long e,
                                          float v) {
  if (a.out_type == kOutF32) {
    static_cast<float*>(a.o)[e] = v;
  } else if (a.out_type == kOutF16) {
    static_cast<__half*>(a.o)[e] = __float2half_rn(v);
  } else {
    static_cast<bf16*>(a.o)[e] = __float2bfloat16(v);
  }
}

// The Q-major epilogue of this thread's rows: O = acc / l (0 where l = 0),
// LSE against r.c, the loose-bound count (bound forms).
template <int D, bool BOUND = true>
__device__ __forceinline__ void store_rows(const Args& a, const Rows& r,
                                           const float (&acc)[D / 64][32],
                                           float (&l)[2], int b) {
  quad_sum(l);
  const int lane = threadIdx.x & 31;
  float inv[2];
  long long row[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    inv[hr] = l[hr] == 0.f ? 0.f : 1.f / l[hr];
    row[hr] = (long long)(b * a.H + r.head[hr]) * a.Nq + r.pos[hr];
  }
#pragma unroll
  for (int sl = 0; sl < D / 64; ++sl) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hr = (i >> 1) & 1;
      if (r.pos[hr] < 0) continue;
      const int col = sl * 64 + 8 * (i >> 2) + 2 * (lane & 3);
      const float v0 = acc[sl][i] * inv[hr], v1 = acc[sl][i + 1] * inv[hr];
      store_pair(a, row[hr] * D + col, v0, v1);
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (r.pos[hr] >= 0) {
        finish_row<BOUND>(a, row[hr], r.pos[hr], l[hr], r.c[hr]);
      }
    }
  }
}

// The key-split epilogue: this (Q tile, span) pair's l and unnormalised
// acc added into the fp32 buffers, once per row that saw a key of the
// span, the accumulator two columns to a vector atomic.
template <int D>
__device__ __forceinline__ void add_rows(const Args& a, const Rows& r,
                                         const float (&acc)[D / 64][32],
                                         float (&l)[2], int b) {
  quad_sum(l);
  const int lane = threadIdx.x & 31;
  long long row[2];
  bool live[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    row[hr] = (long long)(b * a.H + r.head[hr]) * a.Nq + r.pos[hr];
    live[hr] = r.pos[hr] >= 0 && l[hr] != 0.f;
  }
  // Lanes t and t ^ 1 of a quad swap half their pairs, so that each holds
  // four adjacent columns of one row: even lanes of row r0 (columns 2t ..
  // 2t + 3 of each 8-column block), odd lanes of row r0 + 8 (2t − 2 ..
  // 2t + 1); one 16-byte atomic instead of two 8-byte ones.
  const bool odd = lane & 1;
  const int mine = odd ? 1 : 0;
  const int shift = odd ? -2 : 0;
#pragma unroll
  for (int sl = 0; sl < D / 64; ++sl) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* x = &acc[sl][4 * j];
      const float s0 = odd ? x[0] : x[2], s1 = odd ? x[1] : x[3];
      const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      if (!live[mine]) continue;
      const float4 v = odd ? make_float4(r0, r1, x[2], x[3])
                           : make_float4(x[0], x[1], r0, r1);
      const int col = sl * 64 + 8 * j + 2 * (lane & 3) + shift;
      atomicAdd(reinterpret_cast<float4*>(a.o_acc + row[mine] * D + col), v);
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (live[hr]) atomicAdd(a.l_acc + row[hr], l[hr]);
    }
  }
}

// ---------------------------------------------------------------------------
// One-byte K/V converted before the walk (PRE)
// ---------------------------------------------------------------------------

// A 2-byte (or quantize_q's int8) Q at d = 256 over one-byte K/V: a tile
// converted in shared memory beside its walk costs the consumers ~2 µs a
// key tile (32 KB of codes read and 64 KB of 2-byte values written in
// shared memory, which the products' own reads already nearly fill, and one
// converted pair that both warpgroups must finish before the next tile can
// be written into it: 2.2x the bf16 walk at the Gemma prefix). So a pass of
// its own converts the call's codes once, in device memory, into exact
// 2-byte copies ([B,Hkv,Nk,D] contiguous, scratch of the host's), and the
// walk reads them by TMA as it reads bf16 K/V, with the scales applied as
// before: V always; K unless quantize_q reads int8 keys as they are (its
// int8 K tile is the codes), and under quantize_q over e4m3 keys re-gridded
// onto int8 codes. The pass moves 3 bytes per code (the codes read, the
// copy written), once per call, where the in-walk conversion repeated its
// work for every Q tile of a KV head.
struct ConvArgs {
  const uint8_t* src[2];  // K, V codes
  uint8_t* dst[2];        // their converted copies, or null: not converted
  long long st[6];        // K's, then V's (batch, head, row) strides, bytes
  int type[2];            // storage codes (kInt8, kFp8)
  int s8[2];              // 1: re-grid e4m3 onto int8 codes (else 2-byte)
  int Hkv, Nk;
};

// Tensor blockIdx.z (0 K, 1 V) of (batch, KV head) blockIdx.y: its Nk
// rows in 16-code chunks, four loads in flight a thread, each 16 codes
// into 16 2-byte values (or int8 codes).
template <int D>
__device__ __forceinline__ void convert_pass(const ConvArgs& c) {
  // K's or V's fields, chosen without indexing the parameter by a
  // run-time value (which would copy it to local memory)
  const bool v = blockIdx.z != 0;
  const int bh = blockIdx.y;
  uint8_t* dst = v ? c.dst[1] : c.dst[0];
  if (dst == nullptr) return;
  constexpr int CPR = D / 16;  // chunks of a row
  constexpr int U = 4;
  const long long st0 = v ? c.st[3] : c.st[0], st1 = v ? c.st[4] : c.st[1];
  const long long st2 = v ? c.st[5] : c.st[2];
  const int type = v ? c.type[1] : c.type[0];
  const bool s8 = v ? c.s8[1] : c.s8[0];
  const uint8_t* src =
      (v ? c.src[1] : c.src[0]) + (bh / c.Hkv) * st0 + (bh % c.Hkv) * st1;
  const int chunks = c.Nk * CPR;
  dst += (long long)bh * chunks * (s8 ? 16 : 32);
  const int step = gridDim.x * blockDim.x;
  for (int w0 = blockIdx.x * blockDim.x + threadIdx.x; w0 < chunks;
       w0 += U * step) {
    uint4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = w0 + u * step;
      x[u] = w < chunks ? __ldg(reinterpret_cast<const uint4*>(
                              src + (w / CPR) * st2 + (w % CPR) * 16))
                        : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = w0 + u * step;
      if (w >= chunks) continue;  // (no break: x stays in registers)
      if (s8) {
        *reinterpret_cast<uint4*>(dst + (long long)w * 16) = regrid16(x[u]);
      } else {
        uint32_t h[8];
        codes4_to_elem(x[u].x, type, h[0], h[1]);
        codes4_to_elem(x[u].y, type, h[2], h[3]);
        codes4_to_elem(x[u].z, type, h[4], h[5]);
        codes4_to_elem(x[u].w, type, h[6], h[7]);
        uint4* out = reinterpret_cast<uint4*>(dst + (long long)w * 32);
        out[0] = make_uint4(h[0], h[1], h[2], h[3]);
        out[1] = make_uint4(h[4], h[5], h[6], h[7]);
      }
    }
  }
}

// Whether a bound-forward build converts its K/V in a pass of its own
// (PRE): one-byte K/V under a 2-byte or int8 Q at d = 256.
__host__ __device__ constexpr bool pre_converted(int D, bool f32,
                                                 int k_type) {
  return D == 256 && !f32 && k_type != kBf16 && k_type != kF32;
}

// The pass of one call (kernel: the unit's __global__ around convert_pass)
// and the maps of its walk: Q as make_maps's; K as the 2-byte slabs of the
// bf16 builds or, under quantize_q, as the int8 Q's slabs (q_row bytes,
// swizzled as convert_tile lays a tile out; the codes themselves for int8
// keys); V as 2-byte slabs. kc, vc: the host's scratch for the copies, kc
// unused (may be null) for int8 keys under qq. q_st: Q's strides; k_st:
// the codes' (both in elements).
template <int D, typename Kernel>
cudaError_t convert_and_map(Kernel kernel, Maps* m, const void* q,
                            const void* k, const void* v, void* kc, void* vc,
                            int B, int H, int Hkv, int Nq, int Nk,
                            const long long* st, int k_type, int v_type,
                            int qq, int Gp, int R, cudaStream_t stream) {
  const bool copy_k = !(qq && k_type == kInt8);
  if (vc == nullptr || (copy_k && kc == nullptr)) return cudaErrorInvalidValue;
  ConvArgs c = {};
  c.src[0] = static_cast<const uint8_t*>(k);
  c.src[1] = static_cast<const uint8_t*>(v);
  c.dst[0] = copy_k ? static_cast<uint8_t*>(kc) : nullptr;
  c.dst[1] = static_cast<uint8_t*>(vc);
  for (int i = 0; i < 6; ++i) c.st[i] = st[3 + i];  // one-byte: bytes
  c.type[0] = k_type;
  c.type[1] = v_type;
  c.s8[0] = qq;
  c.Hkv = Hkv;
  c.Nk = Nk;
  const int chunks = Nk * (D / 16);  // of one (batch, KV head)
  if (chunks > 0 && B * Hkv > 0) {
    const dim3 grid((chunks + 4 * 256 - 1) / (4 * 256), B * Hkv, 2);
    kernel<<<grid, 256, 0, stream>>>(c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // the copies are [B,Hkv,Nk,D] contiguous
  const long long kce = copy_k && !qq ? 2 : 1;  // bytes of a K element
  const long long cst[3] = {(long long)Hkv * Nk * D, (long long)Nk * D, D};
  const long long* ks = copy_k ? cst : st + 3;
  const void* kt = copy_k ? kc : k;
  const int q_row = D < 128 ? D : 128;
  bool ok = encode4(&m->q, q, qq, D, Nq, H, B, st[2] * (qq ? 1 : 2),
                    st[1] * (qq ? 1 : 2), st[0] * (qq ? 1 : 2),
                    qq ? q_row : 64, R, Gp, qq ? q_row : 128);
  ok = ok && encode4(&m->k, kt, qq, D, Nk, Hkv, B, ks[2] * kce, ks[1] * kce,
                     ks[0] * kce, qq ? q_row : 64, BN, 1, qq ? q_row : 128);
  ok = ok && encode4(&m->v, vc, false, D, Nk, Hkv, B, cst[2] * 2, cst[1] * 2,
                     cst[0] * 2, 64, BN, 1, 128);
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The score-bound Q-major walk: K1b (flash_fwd_bound.cu). The host sends
// K5's calls under a 2-byte or int8 Q here too, through K1b's entry point,
// wherever this walk's grid fills the card (ops/common.py::kmajor_q_walk:
// always at d = 256)
// ---------------------------------------------------------------------------

// key-tile stages in flight: a one-byte stage is half the bytes, and its
// scales come in by plain loads, so it keeps one more ahead (not at d =
// 256, whose 64 KB Q tile leaves room for two; an fp32 Q's split one for
// one)
template <int D, bool QUANT, bool F32>
constexpr int walk_stages() {
  return D == 256 && F32 ? 1 : QUANT && D != 256 ? 3 : 2;
}

// Shared memory of one CTA (byte offsets from a 1024-aligned base): the Q
// tile (under F32 its hi and lo tiles); NST stages of K and V as TMA
// writes them (bf16 slabs, or one-byte codes followed by the tile's K and
// V scales; under F32 over fp32 K/V the producer warpgroup's hi and lo
// tiles of each, over bf16 K/V (BF16KV) the bf16 slabs; under PRE the
// converted copies' 2-byte slabs, or quantize_q's int8 K slabs, and V's,
// followed by the scales); under QUANT but not PRE the converted K/V pairs
// (exact 2-byte tiles, or an s8 K tile under QQ), used in turn, or one at
// d = 256 over bf16 tiles (231,448 bytes under an fp32 Q); under a 2-byte
// or int8 Q at d <= 128 (VSPLIT) those pairs hold K alone, and a ring of
// three converted V tiles follows them; barriers (VSPLIT: a full and an
// empty one per converted V tile after the stages'). At d = 128 under
// VSPLIT: the 32 KB Q tile, three 17 KB code stages, two 16 KB K tiles
// and three 16 KB V tiles, 168,040 bytes (quantize_q: a 16 KB int8 Q tile
// and 8 KB s8 K tiles, 135,272; d = 64: 86,120). At d = 256 under PRE:
// the 64 KB Q tile and two 65 KB stages (a 32 KB K tile, a 32 KB V tile,
// 512 B of scales), 199,720 bytes (quantize_q: a 32 KB int8 Q tile and
// two 49 KB stages, 134,184).
template <int D, bool QUANT, bool QQ, bool F32, int KN, bool BF16KV,
          bool PRE>
struct WalkLayout {
  using T = Tiles<D, QQ>;
  static constexpr bool SPLIT_KV = F32 && !QUANT && !BF16KV;  // fp32 K/V
  static_assert(KN != BN2 || (!QUANT && !F32 && D != 256),
                "128 keys: bf16 K/V at d <= 128 only");
  static_assert((KN == BN32) == (D == 256 && SPLIT_KV),
                "32 keys: fp32 K/V at d = 256 (and there only)");
  static_assert(!BF16KV || (F32 && !QUANT), "BF16KV: an fp32 Q");
  static_assert(!PRE || (QUANT && !F32), "PRE: converted one-byte K/V");
  // one-byte K/V under a 2-byte or int8 Q at d <= 128: the consumers
  // convert K before their Q·Kᵀ, and the producer warpgroup's three other
  // warps convert V meanwhile (VSPLIT; d = 256 converts before the walk,
  // PRE; under an fp32 Q, whose producer warpgroup splits Q, the consumers
  // convert both)
  static constexpr bool VSPLIT = QUANT && !PRE && !F32;
  static_assert(!VSPLIT || D != 256, "VSPLIT: d <= 128");
  static constexpr int NST = walk_stages<D, QUANT, F32>();
  static constexpr int NCV = D == 256 && !QQ ? 1 : 2;  // converted pairs
  static constexpr int NVC = 3;                        // VSPLIT: V tiles
  static constexpr int kv16 = KN * D * 2;              // a bf16 K or V tile
  static constexpr int kvh =                          // K, then V
      PRE ? T::KC : QUANT ? T::CODES : SPLIT_KV ? 2 * kv16 : kv16;
  static constexpr int tma_bytes = PRE ? T::KC + T::KV16 : 2 * kvh;
  static constexpr int stage = align1k(tma_bytes + (QUANT ? 2 * BN * 4 : 0));
  static constexpr int st_off = align1k(F32 ? 2 * T::Q : T::Q);
  static constexpr int cv_v = align1k(T::KC);          // V in a converted pair
  static constexpr int cv_stride =
      VSPLIT ? align1k(T::KC) : align1k(cv_v + T::KV16);
  static constexpr int cv_off = st_off + NST * stage;
  static constexpr int vc_off = cv_off + (QUANT && !PRE ? NCV * cv_stride : 0);
  static constexpr int bar_off = vc_off + (VSPLIT ? NVC * T::KV16 : 0);
  static constexpr int n_bars = 2 * NST + 1 + (VSPLIT ? 2 * NVC : 0);
  static constexpr int bytes = bar_off + 8 * n_bars + 1024;
  static_assert(bytes <= 232448, "the CTA's shared memory");
};

// The producer warpgroup's converting warps under VSPLIT: warps 1-3 (warp
// 0 issues the TMA loads and brings the scales)
constexpr int NCONVERT = 96;

// The walk of one CTA (a kernel's whole body; tm_*: its __grid_constant__
// maps): a 128-row tile of packed query heads over the key tiles its rows
// can see, p = 2^(s − c) with no running max, O written at the end. Under
// causal without a window the Q tiles are issued heaviest first
// (cta_tile); under a window the first rows may be the heavy ones, and the
// grid's own order keeps a KV head's Q tiles together in L2.
template <int D, bool QUANT, bool QQ, bool F32, int KN, bool BF16KV,
          bool PRE>
__device__ __forceinline__ void q_walk(const CUtensorMap* tm_q,
                                       const CUtensorMap* tm_k,
                                       const CUtensorMap* tm_v, const Args& a,
                                       const F32Src& f) {
  static_assert(QUANT || !QQ, "quantize_q reads quantized K/V");
  static_assert(!(QQ && F32), "quantize_q's Q is int8");
  using T = Tiles<D, QQ>;
  using L = WalkLayout<D, QUANT, QQ, F32, KN, BF16KV, PRE>;
  constexpr int NST = L::NST;
  constexpr int NVC = L::NVC;
  constexpr bool SPLIT_KV = L::SPLIT_KV;
  constexpr bool VSPLIT = L::VSPLIT;
  // K/V tiles that are exact bf16 operands under an fp32 Q
  constexpr bool EXACT = QUANT || BF16KV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::bar_off;     // + 8 * stage
  const uint32_t empty = full + 8 * NST;       // + 8 * stage
  const uint32_t q_bar = empty + 8 * NST;
  // VSPLIT: a converted V tile is written (vc_full) and read (vc_empty)
  const uint32_t vc_full = q_bar + 8;           // + 8 * tile
  const uint32_t vc_empty = vc_full + 8 * NVC;  // + 8 * tile

  int qt = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  if (a.window <= 0) cta_tile(a, qt, hg, b);
  const int q0 = qt * a.R;
  const int h0 = hg * a.Gp;
  const int hk = h0 / a.G;
  const int q_hi = min(q0 + a.R, a.Nq) - 1;
  int t_begin, t_end;
  visible_tiles<KN>(a, q0, q_hi, 0, (a.Nk + KN - 1) / KN, t_begin, t_end);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      // the TMA issue, and under QUANT the 32 lanes that load the scales;
      // over fp32 K/V the producer warpgroup's 128 threads
      mbar_init(full + 8 * s, SPLIT_KV ? 128 : QUANT ? 33 : 1);
      // lane 0 of each consumer warp, and under VSPLIT of each converting
      // warp
      mbar_init(empty + 8 * s, VSPLIT ? 8 + NCONVERT / 32 : 8);
    }
    mbar_init(q_bar, F32 ? 128 : 1);
    for (int c = 0; VSPLIT && c < NVC; ++c) {
      mbar_init(vc_full + 8 * c, NCONVERT / 32);
      mbar_init(vc_empty + 8 * c, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // the producer: one thread issues every load; under QUANT its warp
    // also brings each tile's scales beside the codes, and under VSPLIT
    // its other three warps convert V (56 registers: 128 · 56 + 256 · 224
    // is the 384 · 168 the CTA is launched with)
    if constexpr (VSPLIT) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    }
    const int lane = threadIdx.x & 31;
    const int pt = threadIdx.x - 2 * 128;
    const long long* st = f.st;
    if (F32) {
      // an fp32 Q: the warpgroup's 128 threads read the tile from device
      // memory and write its hi and lo tiles (split_rows)
      split_rows<D, 128>(smem, smem + T::Q, BM, f.p[0] + b * st[0], st[1],
                         st[2], h0, a.Gp, a.R, q0, a.Nq, pt);
      fence_proxy_async();
      mbar_arrive(q_bar);
    }
    if (SPLIT_KV) {
      // fp32 K/V: split in the same way, a stage at a time
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int st_i = i % NST;
        mbar_wait(empty + 8 * st_i, ((i / NST) & 1) ^ 1);
        uint8_t* stage = smem + L::st_off + st_i * L::stage;
        split_rows<D, 128>(stage, stage + L::kv16, KN, f.p[1] + b * st[3],
                           st[4], st[5], hk, 1, KN, t * KN, a.Nk, pt);
        split_rows<D, 128>(stage + L::kvh, stage + L::kvh + L::kv16, KN,
                           f.p[2] + b * st[6], st[7], st[8], hk, 1, KN,
                           t * KN, a.Nk, pt);
        fence_proxy_async();
        mbar_arrive(full + 8 * st_i);
      }
    } else if (threadIdx.x < 2 * 128 + (QUANT ? 32 : 1)) {
      if (!F32 && lane == 0) {
        mbar_expect_tx(q_bar, a.Gp * a.R * D * (QQ ? 1 : 2));
        for (int sl = 0; sl < T::QSLABS; ++sl) {
          tma_load_4d(base + sl * BM * 128, tm_q, q_bar, sl * T::QCOL, q0,
                      h0, b);
        }
      }
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int st = i % NST;
        mbar_wait(empty + 8 * st, ((i / NST) & 1) ^ 1);
        const uint32_t dst = base + L::st_off + st * L::stage;
        if (lane == 0) {
          mbar_expect_tx(full + 8 * st, L::tma_bytes);
          if (QUANT && !PRE) {
            tma_load_4d(dst, tm_k, full + 8 * st, 0, t * BN, hk, b);
            tma_load_4d(dst + L::kvh, tm_v, full + 8 * st, 0, t * BN, hk, b);
          } else {
            // K's slabs: 2-byte, or quantize_q's int8 rows of QROW bytes
            constexpr int KSL = PRE && QQ ? T::QSLABS : T::SLABS;
            constexpr int KROW = PRE && QQ ? T::QROW : 128;
            constexpr int KCOL = PRE && QQ ? T::QCOL : 64;
            for (int sl = 0; sl < KSL; ++sl) {
              tma_load_4d(dst + sl * KN * KROW, tm_k, full + 8 * st,
                          sl * KCOL, t * KN, hk, b);
            }
            for (int sl = 0; sl < T::SLABS; ++sl) {
              tma_load_4d(dst + L::kvh + sl * KN * 128, tm_v, full + 8 * st,
                          sl * 64, t * KN, hk, b);
            }
          }
        }
        // the scales, while the codes are in flight
        if (QUANT) {
          load_scales<32>(reinterpret_cast<float*>(smem + L::st_off +
                                                   st * L::stage +
                                                   L::tma_bytes),
                          a, b, hk, t * BN, lane);
          mbar_arrive(full + 8 * st);
        }
      }
    } else if constexpr (VSPLIT) {
      // warps 1-3: each code stage's V into the next free V tile, while
      // the consumers convert its K; one lane a warp arrives, after the
      // warp's stores
      const int ct = threadIdx.x - (2 * 128 + 32);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int st = i % NST, vs = i % NVC;
        mbar_wait(vc_empty + 8 * vs, ((i / NVC) & 1) ^ 1);
        mbar_wait(full + 8 * st, (i / NST) & 1);
        convert_codes<D, false, NCONVERT>(
            smem + L::vc_off + vs * T::KV16,
            smem + L::st_off + st * L::stage + L::kvh, a.v_type, ct);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(empty + 8 * st);
          mbar_arrive(vc_full + 8 * vs);
        }
      }
    }
  } else {
    // two consumer warpgroups, 64 rows each
    if constexpr (VSPLIT) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    }
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const Rows r = row_info(a, b, h0, q0, tid);
    float acc[D / 64][32];
#pragma unroll
    for (int sl = 0; sl < D / 64; ++sl) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[sl][i] = 0.f;
    }
    float l[2] = {0.f, 0.f};
    mbar_wait(q_bar, 0);
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int st = i % NST;
      const int c0 = t * KN;
      mbar_wait(full + 8 * st, (i / NST) & 1);
      const int stage_off = L::st_off + st * L::stage;
      uint32_t kt = base + stage_off, vt = kt + L::kvh;
      const float* ksc = nullptr;
      const float* vsc = nullptr;
      if (PRE) {
        ksc = reinterpret_cast<const float*>(smem + stage_off + L::tma_bytes);
        vsc = ksc + BN;
      } else if (QUANT) {
        // both warpgroups convert the tile once for the CTA's Gp heads,
        // into the pair used two tiles ago: each warpgroup finished that
        // tile's P·V before the barrier of the tile in between. With one
        // pair both first finish the previous tile's P·V, which reads it.
        // Under VSPLIT only K (the producer warpgroup converts V).
        if (L::NCV == 1 && i > 0) consumer_sync();
        uint8_t* cv = smem + L::cv_off + (i % L::NCV) * L::cv_stride;
        const uint8_t* raw = smem + stage_off;
        convert_codes<D, QQ, NCONSUMER>(cv, raw, a.k_type, tid);
        if constexpr (!VSPLIT) {
          convert_codes<D, false, NCONSUMER>(cv + L::cv_v, raw + L::kvh,
                                             a.v_type, tid);
        }
        fence_proxy_async();
        consumer_sync();
        kt = smem_u32(cv);
        vt = kt + L::cv_v;
        ksc = reinterpret_cast<const float*>(smem + stage_off + L::tma_bytes);
        vsc = ksc + BN;
      }
      float s[KN / 2];
      qk<D, QQ, F32, EXACT, KN>(s, base, kt, wg);
      uint32_t p[KN / 4], p_lo[KN / 4];  // under F32 P = p + p_lo
      if (interior<KN>(a, c0, q0, q0 + a.R - 1)) {
        bound_step<QUANT, QQ, false, F32, KN>(a, r, s, ksc, vsc, c0, l, p,
                                              p_lo, f.round[0]);
      } else {
        bound_step<QUANT, QQ, true, F32, KN>(a, r, s, ksc, vsc, c0, l, p,
                                             p_lo, f.round[0]);
      }
      // the stage is read: its codes and scales (QUANT) or its K (bf16;
      // V is read by the P·V below, which completes before the next wait)
      constexpr bool CONVERTED = QUANT && !PRE;  // K/V in a converted pair
      if (CONVERTED && lane == 0) mbar_arrive(empty + 8 * st);
      if constexpr (VSPLIT) {  // V converted by the producer warpgroup
        mbar_wait(vc_full + 8 * (i % NVC), (i / NVC) & 1);
        vt = base + L::vc_off + (i % NVC) * T::KV16;
      }
      pv<D, F32, EXACT, KN>(acc, p, vt, p_lo);
      if (!CONVERTED && lane == 0) mbar_arrive(empty + 8 * st);
      if (VSPLIT && lane == 0) mbar_arrive(vc_empty + 8 * (i % NVC));
    }
    store_rows<D>(a, r, acc, l, b);
  }
}

// The grid of a walk (Q tiles, head groups, batches) and its launch;
// kernel: the unit's __global__ around q_walk with these parameters.
template <int D, bool QUANT, bool QQ, bool F32, int KN, bool BF16KV,
          bool PRE, typename Kernel>
cudaError_t launch_walk(Kernel kernel, const Maps& m, const Args& a,
                        const F32Src& f, int B, cudaStream_t stream) {
  const int smem = WalkLayout<D, QUANT, QQ, F32, KN, BF16KV, PRE>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + a.R - 1) / a.R, a.H / a.Gp, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(m.q, m.k, m.v, a, f);
  return cudaGetLastError();
}

}  // namespace cfa_bound
