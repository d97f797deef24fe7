// FlashAttention-2 backward, key-parallel, for Hopper: dK/dV (K2) and
// dQ/dK/dV in one pass (K4), bf16 in, or fp32 in and dK/dV out (the F32
// build), fp32 accumulation.
//
// Replaces: cuda_flashattention_tpu/ops/flash_bwd.py::_bwd_dkdv_kernel
// (flash_bwd.py:117, K2) and ::_bwd_fused_kernel (flash_bwd.py:252, K4).
// The Q-parallel dQ kernel (K3, ::_bwd_dq_kernel) is the forward's Q-major
// walk in flash_bwd.cu: it runs only on the split path (fused=False),
// which no training step takes.
//
// What bounds it on the H100: per visible (64-query, 128-key) pair K2 does
// 4 and K4 5 products of 2·64·128·d operations (Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ,
// dV += Pᵀ·dO, dK += dSᵀ·Q, and K4's dQ = dS·K) on tiles read once per
// pair: at N = 4096, d = 128 that is ~9 operations per byte of L2 traffic
// per pair and far above the card's ~295 per byte of device memory, so it
// is bound by the tensor cores, and in practice by how much of the
// elementwise work (exp2, the masks, the dS → shared-memory store) and of
// K4's dQ reduction hides under them.
//
// What this design does about it (after FlashAttention-3's backward,
// arXiv 2407.08608 §3 and Appendix B), on the forward's PTX helpers
// (flash_fwd_bound_sm90.cuh; nothing there changes):
//   - One CTA per (128-key tile, KV head, batch), heaviest tiles first
//     under causal (key tile 0 sees the most queries; in ascending order
//     K4 takes 19% and K2 17% longer at N = 4096). A producer warp
//     brings K_j and V_j in once by TMA, then streams each visited (query
//     head g, 64-row Q tile i)'s Q_i and dO_i by TMA, and LSE_i (in log2
//     units, +inf for dead or absent rows) and D_i by plain loads, through
//     a ring of NST mbarrier stages.
//   - Two consumer warpgroups each own 64 of the 128 keys (setmaxnreg:
//     240 registers, the producer 24). Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are SS
//     wgmma (K, V the K-major A; Q, dO the K-major B: the forward's Q·Kᵀ
//     with the roles swapped); P's exp2 runs while dPᵀ is on the tensor
//     cores. Pᵀ and dSᵀ stay in registers and are the bf16 A operands of
//     RS wgmma for dV += Pᵀ·dO and dK += dSᵀ·Q (dO, Q MN-major: the
//     forward's P·V). dK and dV accumulate in registers for the CTA's
//     whole walk (its group's query heads and Q tiles) and are written
//     once.
//   - K4: each warpgroup stores its dSᵀ into shared memory as dS (query
//     rows, key columns, 128 B swizzled) with stmatrix.trans; at d = 128
//     each warpgroup then computes dQ_i for its half of d over all 128 keys
//     (dS·K, SS wgmma, K MN-major), so no sum across warpgroups is needed;
//     at d = 64 each computes all of d over its own 64 keys. The fp32 dQ_i
//     part goes into a staging tile in shared memory, and one thread of
//     the warpgroup adds it into the zeroed fp32 [B,H,Nq,d] buffer with
//     TMA reduces (cp.reduce.async.bulk.tensor .add; rows past Nq are
//     clipped), which run while the warpgroup goes on to the next pair:
//     32 KB per pair, half of what 64-key tiles would send. Against
//     16-byte red.global.add.v4.f32 from the registers K4 takes 15-21%
//     less time at every shape timed (one H100, utils/bwd_variants.py).
//     Either way the adds land in no fixed order, so dQ's last bits vary
//     from run to run; dK and dV do not.
//   - A (warpgroup, Q tile) pair wholly inside the causal/window band takes
//     the unmasked step; segment ids are a build of their own (SEG), whose
//     pairs always take the masked step.
// Budget at d = 128: shared memory K and V 64 KB, K4's two dS tiles 32 KB
// and two dQ staging tiles 32 KB, NST = 2 stages of Q, dO (32 KB) and the
// rows' LSE, D and ids: 195 KB of 227 KB (K2 131 KB), one CTA (384
// threads) per SM (a third stage measured no faster); registers per
// consumer thread: dK and dV 128, Sᵀ and dPᵀ 64, dQ 32 (live after Sᵀ and
// dPᵀ are spent), within setmaxnreg's 240.
//
// Numerics are those of flash_attention_backward_plain (and the TPU
// kernels): S from the raw q in fp32 times scale·log2e; P = exp2(S −
// LSE·log2e), 0 where masked (ragged tail, causal with kv_offset, window,
// segment ids) and on rows whose LSE < NEG_INF/2; dS = P ⊙ (dP − D)·scale;
// P rounded to bf16 before dV += Pᵀ·dO, dS before dK += dSᵀ·Q and dQ +=
// dS·K; all sums in fp32; GQA sums dK/dV over the group in fp32. A key tile
// that no query sees writes zeros.
// The F32 build (fp32 Q, K, V, dO): the producer warpgroup's 128 threads
// read every tile and split it into bf16 hi and lo tiles (split_rows), P
// and dS are split in registers (dS's lo tile stored beside its hi tile),
// and each of the five products is three bf16 wgmmas (lo·hi + hi·lo +
// hi·hi), so P and dS keep ~16 significant bits where the bf16 build
// rounds them to 8; dK and dV are stored fp32. Split tiles double the
// bytes: one dS tile (at d = 128 the warpgroups sync before overwriting
// it), one Q/dO stage at d = 128, and there dQ goes into dq_acc by 8-byte
// atomics from the registers, the staging tiles of the TMA reduce not
// fitting (225 KB); at d = 64 it keeps both stages and the TMA reduce.
//
// The d = 256 builds. Kept as at d = 128, a 128-key CTA would
// hold dK and dV in 256 fp32 registers a thread (past the 255 a thread
// has) and K, V, a Q + dO stage, the dS and staging tiles in ~390 KB. So:
//   - A CTA owns 64 keys (K + V 64 KB), and the two warpgroups split the
//     work instead of the keys: each computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
//     for all 64 keys over its 32 of the tile's 64 query columns (SS
//     wgmma m64n32, so neither product is computed twice), P and dS in
//     registers, and stores Pᵀ and dSᵀ (keys x queries) and, in K4, dS
//     (queries x keys) into shared memory with stmatrix: three 8 KB
//     tiles, 128 B swizzled.
//   - After a barrier of both warpgroups, each owns 128 of the 256
//     columns: dV += Pᵀ·dO and dK += dSᵀ·Q by SS wgmma (A = the Pᵀ / dSᵀ
//     tile, K-major; B = dO / Q, MN-major), and K4's dQ_i = dS·K over the
//     CTA's 64 keys, added into dq_acc by 8-byte atomics from the
//     registers (the staging tiles of a TMA reduce do not fit beside two
//     stages; 16-byte atomics measured no faster, utils/bwd_variants.py
//     --d 256).
// Budget at d = 256: shared memory K and V 64 KB, Pᵀ, dSᵀ and (K4) dS 24
// KB, NST = 2 stages of Q, dO (64 KB) and the rows: 219 KB of 227 KB (K2
// 211 KB); registers per consumer thread: dK and dV 128 (64 keys x 128
// columns each), Sᵀ and dPᵀ 32, dQ 64 (live after Sᵀ and dPᵀ are spent).
//
// The F32 build at d = 256 (wide_f32_consumer). Split K + V of a 64-key CTA
// take 128 KB, and a 64-row split Q + dO stage another 128 KB: 256 KB, past
// the 232,448 bytes. So a stage streams 32 query rows (QR; 64 KB split),
// and there is one stage:
//   - Each warpgroup computes Sᵀ and dPᵀ for the CTA's 64 keys over its 16
//     of the tile's 32 query columns (wgmma m64n16, keys as M), P and dS in
//     registers, split, and stores Pᵀ and dSᵀ (keys x queries, hi in
//     query columns 0-31 and lo in 32-63 of one 128 B swizzled 64 x 64
//     tile) and, in K4, dS (queries x keys: the hi rows 0-31, lo rows
//     32-63) with stmatrix.
//   - Then each owns 128 of the 256 columns: dV += Pᵀ·dO and dK += dSᵀ·Q
//     over the tile's 32 queries (two k16 steps, three wgmmas each), and
//     K4's dQ as dQᵀ = Kᵀ·dSᵀ over the CTA's 64 keys, M = its two
//     64-column slabs of d (K MN-major as A, dS K-major as B; a 32-row dQ
//     tile is below wgmma's M of 64), added into dq_acc by 4-byte atomics.
//   - With one stage the producer's split of the next Q / dO tile waits
//     for the consumers to release this one.
// Budget: shared memory split K and V 128 KB, Pᵀ, dSᵀ and (K4) dS 24 KB
// (8 KB each, both planes), one stage of split Q and dO (64 KB) and the
// rows: 218 KB of 227 KB (K2 210 KB); registers per consumer thread: dK and
// dV 128, Sᵀ and dPᵀ 16, dQᵀ 32 (64-column slabs x 32 queries, two slabs),
// within setmaxnreg's 232.

#include <math.h>

#include "flash_fwd_bound_sm90.cuh"

namespace {

using cfa_bound::bf16;
using cfa_bound::elem;
using cfa_bound::kHalf;
using cfa_bound::pack2;
using cfa_bound::split2r;
using cfa_bound::consumer_sync;
using cfa_bound::copy_after_wait;
using cfa_bound::fence_proxy_async;
using cfa_bound::fence_regs;
using cfa_bound::F32Src;
using cfa_bound::kNegInf;
using cfa_bound::make_desc;
using cfa_bound::mbar_arrive;
using cfa_bound::mbar_expect_tx;
using cfa_bound::mbar_init;
using cfa_bound::mbar_wait;
using cfa_bound::smem_u32;
using cfa_bound::split2;
using cfa_bound::split_rows;
using cfa_bound::swz;
using cfa_bound::tma_load_4d;
using cfa_bound::wgmma_commit;
using cfa_bound::wgmma_fence;
using cfa_bound::wgmma_ss_bf16_n16;
using cfa_bound::wgmma_ss_bf16_n32;
using cfa_bound::wgmma_wait_all;
using cfa_bound::wgmma_wait_one;

constexpr double kLog2e = 1.4426950408889634;
constexpr int BK = 128;        // keys of a CTA (two warpgroups of 64)
constexpr int BK_WIDE = 64;    // keys of a CTA at d = 256
constexpr int BQ = 64;         // query rows of a streamed tile
constexpr int BQ_WIDE_F32 = 32;  // of a streamed tile in the F32 d = 256 build
constexpr int NTHREADS = 384;  // two consumer warpgroups and the producer's
static_assert(BK == cfa_bound::BM && BQ == cfa_bound::BN,
              "the forward's qk_issue / pv_issue tile shapes");

// What the kernel is given besides its five TMA maps (its own struct: the
// forward's Args is left exactly as the forward kernels compile it).
struct BwdArgs {
  const float* lse;    // [B,H,Nq], natural log
  const float* delta;  // [B,H,Nq], rowsum(dO ⊙ O)
  const int* q_seg;    // [B,Nq] (SEG)
  const int* kv_seg;   // [B,Nk] (SEG)
  void* dk;            // [B,Hkv,Nk,D] contiguous, bf16 (fp32 under F32)
  void* dv;
  float* dq_acc;       // [B,H,Nq,D] fp32, zeroed (K4)
  int B, H, Hkv, Nq, Nk;
  float scale_log2e, scale;
  int causal, window, kv_offset;
};

// Shared memory (byte offsets from a 1024-aligned base): K and V (D/64
// slabs of 128 rows x 128 B each); K4's dS tiles (2 slabs of 64 query
// rows x 64 keys; NDS used in turn), and a dQ staging tile per warpgroup
// (64 rows x 64 fp32) where dQ goes by TMA reduce (RED); NST stages of Q
// and dO (D/64 slabs of 64 rows) and their rows' LSE (log2), D and segment
// ids; barriers. Under F32 each of K, V, dS, Q and dO is a hi tile and a
// lo tile (lo right after hi), twice the bytes: one dS tile, and at d =
// 128 one stage and dQ added by vector atomics from the registers
// (130 + 32 + 65 KB of the 227). At d = 256 (WIDE) K and V hold 64 keys,
// and the dS tiles are the Pᵀ, dSᵀ and (K4) dS tiles of 64 x 64, in that
// order; dQ goes by atomics. Under F32 at d = 256 a stage holds QR = 32
// query rows and each of those three tiles holds both planes of a 32-wide
// tile (hi then lo, in columns or rows); one stage: 218 KB.
template <int D, bool FUSED, bool F32>
struct Layout {
  static constexpr bool WIDE = D == 256;
  static constexpr int KB = WIDE ? BK_WIDE : BK;  // keys of a CTA
  static constexpr int QR = WIDE && F32 ? BQ_WIDE_F32 : BQ;  // rows a stage
  static constexpr int PL = F32 ? 2 : 1;  // planes of a tile: hi (and lo)
  static constexpr int NST = F32 && D >= 128 ? 1 : 2;  // Q/dO stages
  static constexpr int NDS = F32 ? 1 : 2;              // dS tiles
  static constexpr bool RED = !WIDE && (!F32 || D == 64);  // dQ by TMA
  static constexpr int KV = KB * D * 2;  // a bf16 K or V tile (or plane)
  static constexpr int QT = QR * D * 2;
  static constexpr int DS = BQ * KB * 2;
  static constexpr int k_off = 0;
  static constexpr int v_off = PL * KV;
  static constexpr int ds_off = 2 * PL * KV;
  static constexpr int NT = WIDE ? (FUSED ? 3 : 2) : FUSED ? NDS * PL : 0;
  static constexpr int pt_off = ds_off;        // WIDE: Pᵀ
  static constexpr int dst_off = ds_off + DS;  // WIDE: dSᵀ
  static constexpr int dsw_off = ds_off + 2 * DS;  // WIDE: dS (K4)
  static constexpr int STG = BQ * 64 * 4;  // a warpgroup's dQ staging
  static constexpr int stg_off = ds_off + NT * DS;
  static constexpr int st_off = stg_off + (FUSED && RED ? 2 * STG : 0);
  static constexpr int rows_off = 2 * PL * QT;  // within a stage
  static constexpr int stage = cfa_bound::align1k(rows_off + 3 * QR * 4);
  static constexpr int bar_off = st_off + NST * stage;
  static constexpr int bytes = bar_off + 8 * (2 * NST + 1) + 1024;
  static_assert(bytes <= 232448, "the CTA's shared memory");
};

// D[64x64] (+)= A[64x16] · B[16x64], bf16 from shared memory: A K-major,
// B MN-major (dS·K: K's rows are the reduction).
__device__ __forceinline__ void wgmma_ss_bf16_tb(float (&d)[32], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." CFA_AB " " CFA_REGS32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : CFA_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64x32] (+)= A[64x16] · B[16x32], bf16 from shared memory: A MN-major,
// B K-major (the F32 d = 256 build's dQᵀ = Kᵀ·dSᵀ: A is K's tile as it
// lies, keys the reduction).
__device__ __forceinline__ void wgmma_ss_bf16_n32_ta(float (&d)[16],
                                                     uint64_t da, uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." CFA_AB " " CFA_REGS16
      ", %16, %17, p, 1, 1, 1, 0;\n}\n"
      : CFA_D16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// Four 8x8 bf16 matrices of this warp's fragments, stored as they are.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::
          "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// Four 8x8 bf16 matrices of this warp's fragments, stored transposed.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0,
                                                  uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};" ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// The CTA's (key tile, KV head, batch): key tiles slowest, so that under
// causal the heaviest (tile 0) start in the first wave
// (ops/flash_bwd.py::_bwd_cta_order states the same order).
__device__ __forceinline__ void cta_tile(const BwdArgs& a, int& kt, int& hk,
                                         int& b) {
  const int per_tile = a.Hkv * a.B;
  kt = blockIdx.x / per_tile;
  const int rest = blockIdx.x % per_tile;
  hk = rest % a.Hkv;
  b = rest / a.Hkv;
}

// The Q tiles [first, last] of QR rows that can see keys c0 .. c0 + KB − 1
// (ops/flash_bwd.py::_bwd_q_tiles states the same walk): causal rows see
// keys <= row + kv_offset, so none when the first row that sees key c0
// lies past Nq; with a window the last row that reaches the tile's last
// key is that key − kv_offset + window − 1.
template <int KB, int QR>
__device__ __forceinline__ void q_tiles(const BwdArgs& a, int c0, int& first,
                                        int& last) {
  first = 0;
  last = (a.Nq + QR - 1) / QR - 1;
  if (a.causal) {
    const int row0 = max(0, c0 - a.kv_offset);
    first = row0 / QR;
    if (row0 >= a.Nq) last = -1;
    if (a.window > 0) {
      const int last_row = min(a.Nk, c0 + KB) - 2 + a.window - a.kv_offset;
      last = last_row < 0 ? -1 : min(last, last_row / QR);
    }
  }
}

// Whether every (key of the 64 at kc0, query of the QN at q0) pair is
// visible, so that the element mask can be skipped (rows past Nq have LSE
// +inf: their P is 0 either way).
template <int QN = BQ>
__device__ __forceinline__ bool interior(const BwdArgs& a, int kc0, int q0,
                                         int window) {
  if (kc0 + 64 > a.Nk) return false;
  if (a.causal) {
    if (kc0 + 63 > q0 + a.kv_offset) return false;
    if (window > 0 && kc0 <= q0 + QN - 1 + a.kv_offset - window) return false;
  }
  return true;
}

// P on this thread's N entries of Sᵀ (two key rows kr[0..1], N / 2 query
// columns from q0 in wgmma's accumulator layout: 64 at N = 32, the d =
// 256 build's 32 at N = 16): in place, p = exp2(s · scale·log2e −
// lse2[col]), 0 where masked. With MASKED false no element is tested.
template <bool MASKED, bool SEG, int N = 32>
__device__ __forceinline__ void probs(const BwdArgs& a, float (&s)[N],
                                      const float* lse2, const int* qseg,
                                      const int (&kr)[2], const int (&kseg)[2],
                                      int q0, int window) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    const int col = 8 * (j >> 2) + 2 * (lane & 3);
    const int hr = (j >> 1) & 1;
    const float2 l = *reinterpret_cast<const float2*>(lse2 + col);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bool ok = true;
      if (MASKED) {
        const int qp = q0 + col + e + a.kv_offset;
        ok = kr[hr] < a.Nk;
        if (a.causal) {
          ok = ok && kr[hr] <= qp && (window <= 0 || kr[hr] > qp - window);
        }
        if (SEG) ok = ok && qseg[col + e] == kseg[hr];
      }
      s[j + e] = ok ? exp2f(fmaf(s[j + e], a.scale_log2e, e ? -l.y : -l.x))
                    : 0.f;
    }
  }
}

// dQ_i (this warpgroup's part) = dS · K: at d = 128 columns 64·wg.. over
// all 128 keys, at d = 64 all columns over the warpgroup's own 64 keys. ds:
// the dS tile (2 slabs of 64 keys, K-major), k: the K tile; ACC adds into
// d.
template <int D, bool ACC = false>
__device__ __forceinline__ void dq_issue(float (&d)[32], uint32_t ds,
                                         uint32_t k, int wg) {
  constexpr int NKK = D == 128 ? BK / 16 : 4;
  const int key0 = D == 128 ? 0 : 64 * wg;
  const int slab = D == 128 ? wg : 0;
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk) {
    const int kb = key0 + 16 * kk;
    wgmma_ss_bf16_tb(
        d, make_desc(ds + (kb >> 6) * BQ * 128 + ((kb & 63) >> 4) * 32, 16,
                     1024, 1),
        make_desc(k + slab * BK * 128 + kb * 128, 1024, 1024, 1),
        ACC || kk > 0);
  }
}

// The same on split tiles (F32): dS_lo·K + dS·K_lo + dS·K (the dS lo tile
// DS bytes after its hi tile, K's lo tile KV bytes after K's).
template <int D>
__device__ __forceinline__ void dq_issue_f32(float (&d)[32], uint32_t ds,
                                             uint32_t k, int wg) {
  dq_issue<D>(d, ds + BQ * BK * 2, k, wg);
  dq_issue<D, true>(d, ds, k + BK * D * 2, wg);
  dq_issue<D, true>(d, ds, k, wg);
}

// One 4-D box of fp32 from shared memory added into device memory by TMA
// (coordinates innermost first), in the thread's current bulk group.
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map,
                                                  uint32_t src, int c0, int c1,
                                                  int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Until this thread's bulk groups have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// Until this thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// The 128 threads of consumer warpgroup wg (barriers 2 and 3).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
}
// This warpgroup's dQ part into its staging tile: two boxes of 32 fp32
// columns x 64 rows, 128 B swizzled, as the TMA reduce reads them.
__device__ __forceinline__ void stage_dq(uint8_t* stg, const float (&d)[32]) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    const int jb = j >> 2, hr = (j >> 1) & 1;
    uint8_t* dst = stg + (jb >> 2) * (BQ * 128) +
                   swz(r + 8 * hr, 2 * (jb & 3) + (t >> 1), 128) + (t & 1) * 8;
    *reinterpret_cast<float2*>(dst) = make_float2(d[j], d[j + 1]);
  }
}

// This warpgroup's 64 rows of dK (or dV) as bf16 (fp32 under F32), past
// Nk skipped.
// (NS slabs of 64 columns from col0: all D of them, or at d = 256 the
// warpgroup's 128)
template <int D, bool F32, int NS = D / 64>
__device__ __forceinline__ void store_kv(void* out, const float (&acc)[NS][32],
                                         const int (&kr)[2], int Nk,
                                         long long kv_base, int col0 = 0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int sl = 0; sl < NS; ++sl) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hr = (i >> 1) & 1;
      if (kr[hr] >= Nk) continue;
      const int col = col0 + sl * 64 + 8 * (i >> 2) + 2 * (lane & 3);
      const long long at = (kv_base + kr[hr]) * D + col;
      if (F32) {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
            make_float2(acc[sl][i], acc[sl][i + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<elem*>(out) + at) =
            pack2(acc[sl][i], acc[sl][i + 1]);
      }
    }
  }
}

// This warpgroup's dQ part (64 rows x 64 columns from col0) added into
// dq_acc by 8-byte atomics, rows past Nq skipped: K4's fp32 build at d =
// 128 and its d = 256 build, which have no room for the staging tiles of
// the TMA reduce.
template <int D>
__device__ __forceinline__ void add_dq(float* dq_acc, const float (&d)[32],
                                       int q0, int Nq, long long row_base,
                                       int col0) {
  const int lane = threadIdx.x & 31;
  const int r = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    const int q = q0 + r + 8 * ((j >> 1) & 1);
    if (q >= Nq) continue;
    const int col = col0 + 8 * (j >> 2) + 2 * (lane & 3);
    atomicAdd(reinterpret_cast<float2*>(dq_acc + (row_base + q) * D + col),
              make_float2(d[j], d[j + 1]));
  }
}

// Sᵀ[64 keys x 32 queries] = K·Qᵀ at d = 256 (or dPᵀ = V·dOᵀ): k the
// 64-key K (V) tile, q the first of 32 rows of the Q (dO) tile, both
// K-major in four 64-column slabs.
__device__ __forceinline__ void kq_issue_wide(float (&s)[16], uint32_t k,
                                              uint32_t q) {
#pragma unroll
  for (int sl = 0; sl < 4; ++sl) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss_bf16_n32(s, make_desc(k + sl * BK_WIDE * 128 + kk * 32, 16,
                                     1024, 1),
                        make_desc(q + sl * BQ * 128 + kk * 32, 16, 1024, 1),
                        sl + kk > 0);
    }
  }
}

// The d = 256 build's consumer warpgroups: both hold the CTA's 64 keys.
// Per (query head, Q tile) pair warpgroup wg computes Sᵀ and dPᵀ over the
// tile's query columns 32·wg .. 32·wg + 31, P and dS, and stores its
// columns of Pᵀ, dSᵀ and (K4) dS; then, the tiles whole, dV and dK over
// its 128 columns 128·wg .. and K4's dQ over the same columns.
template <bool FUSED, bool SEG>
__device__ __forceinline__ void wide_consumer(const BwdArgs& a, uint8_t* smem,
                                              uint32_t full, uint32_t empty,
                                              uint32_t kv_bar, int c0, int hk,
                                              int b, int G, int first,
                                              int per_head) {
  using L = Layout<256, FUSED, false>;
  constexpr int NST = L::NST;
  const uint32_t base = smem_u32(smem);
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  const int wp = (threadIdx.x >> 5) & 3;
  const int window = a.causal ? a.window : 0;
  int kr[2], kseg[2] = {0, 0};  // the thread's key rows and their ids
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    kr[hr] = c0 + 16 * wp + (lane >> 2) + 8 * hr;
    if (SEG) {
      kseg[hr] = kr[hr] < a.Nk ? a.kv_seg[(long long)b * a.Nk + kr[hr]] : -2;
    }
  }
  float dk[2][32], dv[2][32];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      dk[sl][j] = 0.f;
      dv[sl][j] = 0.f;
    }
  }
  const uint32_t k_tile = base + L::k_off;
  const uint32_t v_tile = base + L::v_off;
  const uint32_t pt_tile = base + L::pt_off;
  const uint32_t dst_tile = base + L::dst_off;
  const uint32_t ds_tile = base + L::dsw_off;
  if (per_head > 0) mbar_wait(kv_bar, 0);

  int i = 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int it = first; it < first + per_head; ++it, ++i) {
      const int st = i % NST;
      const int q0 = it * BQ;
      mbar_wait(full + 8 * st, (i / NST) & 1);
      const uint32_t q_tile = base + L::st_off + st * L::stage;
      const uint32_t do_tile = q_tile + L::QT;
      const float* rows = reinterpret_cast<const float*>(
          smem + L::st_off + st * L::stage + L::rows_off);

      // Sᵀ = K·Qᵀ, then dPᵀ = V·dOᵀ, over this warpgroup's 32 query
      // columns (rows 32·wg .. of the Q and dO slabs); P while dPᵀ is on
      // the tensor cores
      float s_acc[16], dp_acc[16];
      wgmma_fence();
      kq_issue_wide(s_acc, k_tile, q_tile + wg * 32 * 128);
      wgmma_commit();
      kq_issue_wide(dp_acc, v_tile, do_tile + wg * 32 * 128);
      wgmma_commit();
      wgmma_wait_one();
      float p[16];
      copy_after_wait(p, s_acc);
      const int qc = 32 * wg;  // this warpgroup's first query column
      if (!SEG && interior(a, c0, q0, window)) {
        probs<false, false, 16>(a, p, rows + qc, nullptr, kr, kseg, q0 + qc,
                                window);
      } else {
        probs<true, SEG, 16>(
            a, p, rows + qc, reinterpret_cast<const int*>(rows) + 2 * BQ + qc,
            kr, kseg, q0 + qc, window);
      }
      wgmma_wait_all();
      float dp[16];
      copy_after_wait(dp, dp_acc);

      // dS = P ⊙ (dP − D)·scale; P and dS as bf16 pairs in the accumulator
      // layout (pair 2·c + hr: key row hr, query columns 8·c + 2·(lane & 3))
      uint32_t pk[8], dsk[8];
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const int col = qc + 8 * (j >> 2) + 2 * (lane & 3);
        const float2 dl = *reinterpret_cast<const float2*>(rows + BQ + col);
        pk[j >> 1] = pack2(p[j], p[j + 1]);
        dsk[j >> 1] = pack2(p[j] * (dp[j] - dl.x) * a.scale,
                            p[j + 1] * (dp[j + 1] - dl.y) * a.scale);
      }
      // the tiles are free once both warpgroups' products of the previous
      // pair have landed
      consumer_sync();
      // Pᵀ and dSᵀ (key rows, query columns): matrix m of a stmatrix is
      // key rows 16·warp + 8·(m & 1), query chunk qc / 8 + 2·c + (m >> 1);
      // dS (query rows, key columns) the same matrices transposed
      const int m = lane >> 3;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t at = swz(16 * wp + 8 * (m & 1) + (lane & 7),
                                qc / 8 + 2 * c + (m >> 1), 128);
        stmatrix_x4(pt_tile + at, pk[4 * c], pk[4 * c + 1], pk[4 * c + 2],
                    pk[4 * c + 3]);
        stmatrix_x4(dst_tile + at, dsk[4 * c], dsk[4 * c + 1],
                    dsk[4 * c + 2], dsk[4 * c + 3]);
        if (FUSED) {
          stmatrix_x4_trans(
              ds_tile + swz(qc + 8 * (2 * c + (m >> 1)) + (lane & 7),
                            2 * wp + (m & 1), 128),
              dsk[4 * c], dsk[4 * c + 1], dsk[4 * c + 2], dsk[4 * c + 3]);
        }
      }
      fence_proxy_async();
      consumer_sync();

      // dV += Pᵀ·dO and dK += dSᵀ·Q over this warpgroup's columns
      // (slabs 2·wg, 2·wg + 1 of dO and Q, MN-major), and K4's dQ_i = dS·K
      // over the same columns of K
      float dq[2][32];
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        const int slab = 2 * wg + sl;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = make_desc(pt_tile + kk * 32, 16, 1024, 1);
          const uint64_t dsa = make_desc(dst_tile + kk * 32, 16, 1024, 1);
          wgmma_ss_bf16_tb(dv[sl], da,
                           make_desc(do_tile + slab * BQ * 128 + kk * 2048,
                                     1024, 1024, 1),
                           1);
          wgmma_ss_bf16_tb(dk[sl], dsa,
                           make_desc(q_tile + slab * BQ * 128 + kk * 2048,
                                     1024, 1024, 1),
                           1);
          if (FUSED) {
            wgmma_ss_bf16_tb(
                dq[sl], make_desc(ds_tile + kk * 32, 16, 1024, 1),
                make_desc(k_tile + slab * L::KB * 128 + kk * 2048, 1024,
                          1024, 1),
                kk > 0);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        fence_regs(dk[sl]);
        fence_regs(dv[sl]);
        if (FUSED) fence_regs(dq[sl]);
      }
      // Q, dO and the rows are read
      if (lane == 0) mbar_arrive(empty + 8 * st);
      if (FUSED) {
        const long long row_base = (long long)(b * a.H + h) * a.Nq;
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) {
          add_dq<256>(a.dq_acc, dq[sl], q0, a.Nq, row_base,
                      128 * wg + 64 * sl);
        }
      }
    }
  }
  // dK, dV cast once; a key tile that no query sees writes its zeros
  const long long kv_base = (long long)(b * a.Hkv + hk) * a.Nk;
  store_kv<256, false, 2>(a.dk, dk, kr, a.Nk, kv_base, 128 * wg);
  store_kv<256, false, 2>(a.dv, dv, kr, a.Nk, kv_base, 128 * wg);
}

// Sᵀ[64 keys x 16 queries] (+)= K·Qᵀ at d = 256 on one plane of each: k the
// 64-key K (or V) tile, q the first of 16 rows of a 32-row Q (or dO) tile,
// both K-major in four 64-column slabs.
template <bool ACC>
__device__ __forceinline__ void kq16_issue(float (&s)[8], uint32_t k,
                                           uint32_t q) {
#pragma unroll
  for (int sl = 0; sl < 4; ++sl) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss_bf16_n16(
          s, make_desc(k + sl * BK_WIDE * 128 + kk * 32, 16, 1024, 1),
          make_desc(q + sl * BQ_WIDE_F32 * 128 + kk * 32, 16, 1024, 1),
          ACC || sl + kk > 0);
    }
  }
}

// The same on split tiles: K_lo·Qᵀ + K·Q_loᵀ + K·Qᵀ (each lo plane right
// after its hi plane).
__device__ __forceinline__ void kq16_issue_f32(float (&s)[8], uint32_t k,
                                               uint32_t q) {
  constexpr int KV = BK_WIDE * 256 * 2, QT = BQ_WIDE_F32 * 256 * 2;
  kq16_issue<false>(s, k + KV, q);
  kq16_issue<true>(s, k, q + QT);
  kq16_issue<true>(s, k, q);
}

// The F32 d = 256 build's consumer warpgroups: both hold the CTA's 64 keys.
// Per (query head, 32-row Q tile) pair warpgroup wg computes Sᵀ and dPᵀ
// over the tile's query columns 16·wg .. 16·wg + 15, P and dS split, and
// stores its columns of Pᵀ, dSᵀ and (K4) dS; then, the tiles whole, dV and
// dK over its 128 columns 128·wg .. and K4's dQᵀ over the same columns.
template <bool FUSED, bool SEG>
__device__ __forceinline__ void wide_f32_consumer(
    const BwdArgs& a, uint8_t* smem, uint32_t full, uint32_t empty,
    uint32_t kv_bar, int c0, int hk, int b, int G, int first, int per_head,
    const F32Src& f) {
  using L = Layout<256, FUSED, true>;
  static_assert(L::NST == 1 && L::QR == 32, "one stage of 32 rows");
  constexpr int QR = L::QR;
  const uint32_t base = smem_u32(smem);
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  const int wp = (threadIdx.x >> 5) & 3;
  const int window = a.causal ? a.window : 0;
  int kr[2], kseg[2] = {0, 0};  // the thread's key rows and their ids
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    kr[hr] = c0 + 16 * wp + (lane >> 2) + 8 * hr;
    if (SEG) {
      kseg[hr] = kr[hr] < a.Nk ? a.kv_seg[(long long)b * a.Nk + kr[hr]] : -2;
    }
  }
  float dk[2][32], dv[2][32];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      dk[sl][j] = 0.f;
      dv[sl][j] = 0.f;
    }
  }
  const uint32_t k_tile = base + L::k_off;
  const uint32_t v_tile = base + L::v_off;
  const uint32_t pt_tile = base + L::pt_off;
  const uint32_t dst_tile = base + L::dst_off;
  const uint32_t ds_tile = base + L::dsw_off;
  const uint32_t q_tile = base + L::st_off;
  const uint32_t do_tile = q_tile + 2 * L::QT;
  const float* rows =
      reinterpret_cast<const float*>(smem + L::st_off + L::rows_off);
  const int qc = 16 * wg;  // this warpgroup's first query column
  if (per_head > 0) mbar_wait(kv_bar, 0);

  int i = 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int it = first; it < first + per_head; ++it, ++i) {
      const int q0 = it * QR;
      mbar_wait(full, i & 1);

      // Sᵀ = K·Qᵀ, then dPᵀ = V·dOᵀ, over this warpgroup's 16 query
      // columns; P while dPᵀ is on the tensor cores
      float s_acc[8], dp_acc[8];
      wgmma_fence();
      kq16_issue_f32(s_acc, k_tile, q_tile + qc * 128);
      wgmma_commit();
      kq16_issue_f32(dp_acc, v_tile, do_tile + qc * 128);
      wgmma_commit();
      wgmma_wait_one();
      float p[8];
      copy_after_wait(p, s_acc);
      if (!SEG && interior<16>(a, c0, q0 + qc, window)) {
        probs<false, false, 8>(a, p, rows + qc, nullptr, kr, kseg, q0 + qc,
                               window);
      } else {
        probs<true, SEG, 8>(
            a, p, rows + qc, reinterpret_cast<const int*>(rows) + 2 * QR + qc,
            kr, kseg, q0 + qc, window);
      }
      wgmma_wait_all();
      float dp[8];
      copy_after_wait(dp, dp_acc);

      // dS = P ⊙ (dP − D)·scale; P and dS split into bf16 pairs in the
      // accumulator layout (pair 2·c + hr: key row hr, query columns
      // qc + 8·c + 2·(lane & 3))
      uint32_t pk[4], pk_lo[4], dsk[4], dsk_lo[4];
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const int col = qc + 8 * (j >> 2) + 2 * (lane & 3);
        const float2 dl = *reinterpret_cast<const float2*>(rows + QR + col);
        split2r(p[j], p[j + 1], f.round[0], pk[j >> 1], pk_lo[j >> 1]);
        split2r(p[j] * (dp[j] - dl.x) * a.scale,
                p[j + 1] * (dp[j + 1] - dl.y) * a.scale, f.round[1],
                dsk[j >> 1], dsk_lo[j >> 1]);
      }
      // the tiles are free once both warpgroups' products of the previous
      // pair have landed
      consumer_sync();
      // Pᵀ and dSᵀ (key rows; hi in query chunks 0-3, lo in 4-7): matrix m
      // of a stmatrix is key rows 16·warp + 8·(m & 1), query chunk qc / 8 +
      // (m >> 1); dS (query rows, hi 0-31 and lo 32-63; key columns) the
      // same matrices transposed
      const int m = lane >> 3;
      const int kt_row = 16 * wp + 8 * (m & 1) + (lane & 7);
      const uint32_t at_hi = swz(kt_row, qc / 8 + (m >> 1), 128);
      const uint32_t at_lo = swz(kt_row, 4 + qc / 8 + (m >> 1), 128);
      stmatrix_x4(pt_tile + at_hi, pk[0], pk[1], pk[2], pk[3]);
      stmatrix_x4(pt_tile + at_lo, pk_lo[0], pk_lo[1], pk_lo[2], pk_lo[3]);
      stmatrix_x4(dst_tile + at_hi, dsk[0], dsk[1], dsk[2], dsk[3]);
      stmatrix_x4(dst_tile + at_lo, dsk_lo[0], dsk_lo[1], dsk_lo[2],
                  dsk_lo[3]);
      if (FUSED) {
        const uint32_t at =
            swz(qc + 8 * (m >> 1) + (lane & 7), 2 * wp + (m & 1), 128);
        stmatrix_x4_trans(ds_tile + at, dsk[0], dsk[1], dsk[2], dsk[3]);
        stmatrix_x4_trans(ds_tile + QR * 128 + at, dsk_lo[0], dsk_lo[1],
                          dsk_lo[2], dsk_lo[3]);
      }
      fence_proxy_async();
      consumer_sync();

      // dV += Pᵀ·dO and dK += dSᵀ·Q over this warpgroup's columns (slabs
      // 2·wg, 2·wg + 1 of dO and Q, MN-major; the 32 queries in two k16
      // steps), and K4's dQᵀ = Kᵀ·dSᵀ over the same columns of K; each
      // product lo·hi + hi·lo + hi·hi
      float dqt[2][16];
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        const int slab = 2 * wg + sl;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t p_hi = make_desc(pt_tile + kk * 32, 16, 1024, 1);
          const uint64_t p_lo = make_desc(pt_tile + 64 + kk * 32, 16, 1024, 1);
          const uint64_t s_hi = make_desc(dst_tile + kk * 32, 16, 1024, 1);
          const uint64_t s_lo =
              make_desc(dst_tile + 64 + kk * 32, 16, 1024, 1);
          const uint32_t dob = do_tile + slab * QR * 128 + kk * 2048;
          const uint32_t qb = q_tile + slab * QR * 128 + kk * 2048;
          wgmma_ss_bf16_tb(dv[sl], p_lo, make_desc(dob, 1024, 1024, 1), 1);
          wgmma_ss_bf16_tb(dv[sl], p_hi,
                           make_desc(dob + L::QT, 1024, 1024, 1), 1);
          wgmma_ss_bf16_tb(dv[sl], p_hi, make_desc(dob, 1024, 1024, 1), 1);
          wgmma_ss_bf16_tb(dk[sl], s_lo, make_desc(qb, 1024, 1024, 1), 1);
          wgmma_ss_bf16_tb(dk[sl], s_hi, make_desc(qb + L::QT, 1024, 1024, 1),
                           1);
          wgmma_ss_bf16_tb(dk[sl], s_hi, make_desc(qb, 1024, 1024, 1), 1);
        }
        if (FUSED) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t kb = k_tile + slab * L::KB * 128 + kk * 2048;
            const uint64_t d_hi = make_desc(ds_tile + kk * 32, 16, 1024, 1);
            const uint64_t d_lo =
                make_desc(ds_tile + QR * 128 + kk * 32, 16, 1024, 1);
            wgmma_ss_bf16_n32_ta(dqt[sl],
                                 make_desc(kb + L::KV, 1024, 1024, 1), d_hi,
                                 kk > 0);
            wgmma_ss_bf16_n32_ta(dqt[sl], make_desc(kb, 1024, 1024, 1), d_lo,
                                 1);
            wgmma_ss_bf16_n32_ta(dqt[sl], make_desc(kb, 1024, 1024, 1), d_hi,
                                 1);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        fence_regs(dk[sl]);
        fence_regs(dv[sl]);
        if (FUSED) fence_regs(dqt[sl]);
      }
      // Q, dO and the rows are read
      if (lane == 0) mbar_arrive(empty);
      if (FUSED) {
        // dQᵀ element j of slab sl: column 64·(2·wg + sl) + the thread's
        // row, query q0 + its column
        const long long row_base = (long long)(b * a.H + h) * a.Nq;
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int q = q0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
            const int col =
                64 * (2 * wg + sl) + 16 * wp + (lane >> 2) + 8 * ((j >> 1) & 1);
            if (q < a.Nq) atomicAdd(a.dq_acc + (row_base + q) * 256 + col,
                                    dqt[sl][j]);
          }
        }
      }
    }
  }
  // dK, dV stored fp32 once; a key tile that no query sees writes its zeros
  const long long kv_base = (long long)(b * a.Hkv + hk) * a.Nk;
  store_kv<256, true, 2>(a.dk, dk, kr, a.Nk, kv_base, 128 * wg);
  store_kv<256, true, 2>(a.dv, dv, kr, a.Nk, kv_base, 128 * wg);
}

// K2 (FUSED = false) and K4 (FUSED = true); F32: fp32 Q, K, V, dO read
// through f and split by the producer warpgroup, dK and dV stored fp32.
template <int D, bool FUSED, bool SEG, bool F32>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_kv_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_dq,
                        const BwdArgs a, const F32Src f) {
  using L = Layout<D, FUSED, F32>;
  constexpr int NST = L::NST;
  constexpr int SLABS = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::bar_off;  // + 8 * stage
  const uint32_t empty = full + 8 * NST;    // + 8 * stage
  const uint32_t kv_bar = empty + 8 * NST;

  constexpr int KB = L::KB;
  int kt, hk, b;
  cta_tile(a, kt, hk, b);
  const int c0 = kt * KB;
  const int G = a.H / a.Hkv;
  constexpr int QR = L::QR;
  int first, last;
  q_tiles<KB, QR>(a, c0, first, last);
  const int per_head = max(0, last - first + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      // the TMA issue and the warp's row loads, or under F32 the producer
      // warpgroup's 128 threads
      mbar_init(full + 8 * s, F32 ? 128 : 33);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    mbar_init(kv_bar, F32 ? 128 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if (wg == 2) {
    // the producer: under F32 its 128 threads read and split every tile
    // (split_rows), else one thread issues the TMA and its warp loads the
    // rows' LSE, D and ids
    if (F32) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
      if (threadIdx.x >= 2 * 128 + 32) return;
    }
    const int pt = F32 ? threadIdx.x - 2 * 128 : lane;  // among the loaders
    constexpr int NL = F32 ? 128 : 32;
    const long long* fs = f.st;
    if (F32 && per_head > 0) {
      split_rows<D, 128>(smem + L::k_off, smem + L::k_off + L::KV, KB,
                         f.p[1] + b * fs[3], fs[4], fs[5], hk, 1, KB, c0,
                         a.Nk, pt);
      split_rows<D, 128>(smem + L::v_off, smem + L::v_off + L::KV, KB,
                         f.p[2] + b * fs[6], fs[7], fs[8], hk, 1, KB, c0,
                         a.Nk, pt);
      fence_proxy_async();
      mbar_arrive(kv_bar);
    } else if (!F32 && lane == 0 && per_head > 0) {
      mbar_expect_tx(kv_bar, 2 * L::KV);
      for (int sl = 0; sl < SLABS; ++sl) {
        tma_load_4d(base + L::k_off + sl * KB * 128, &tm_k, kv_bar, sl * 64,
                    c0, hk, b);
        tma_load_4d(base + L::v_off + sl * KB * 128, &tm_v, kv_bar, sl * 64,
                    c0, hk, b);
      }
    }
    int i = 0;
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      const long long row_base = (long long)(b * a.H + h) * a.Nq;
      for (int it = first; it < first + per_head; ++it, ++i) {
        const int st = i % NST;
        const int q0 = it * QR;
        mbar_wait(empty + 8 * st, ((i / NST) & 1) ^ 1);
        const uint32_t dst = base + L::st_off + st * L::stage;
        if (F32) {
          uint8_t* stage = smem + L::st_off + st * L::stage;
          split_rows<D, 128>(stage, stage + L::QT, QR, f.p[0] + b * fs[0],
                             fs[1], fs[2], h, 1, QR, q0, a.Nq, pt);
          split_rows<D, 128>(stage + 2 * L::QT, stage + 3 * L::QT, QR,
                             f.p[3] + b * fs[9], fs[10], fs[11], h, 1, QR, q0,
                             a.Nq, pt);
        } else if (lane == 0) {
          mbar_expect_tx(full + 8 * st, 2 * L::QT);
          for (int sl = 0; sl < SLABS; ++sl) {
            tma_load_4d(dst + sl * BQ * 128, &tm_q, full + 8 * st, sl * 64,
                        q0, h, b);
            tma_load_4d(dst + L::QT + sl * BQ * 128, &tm_do, full + 8 * st,
                        sl * 64, q0, h, b);
          }
        }
        // the rows' LSE in log2 units (+inf past Nq or on a row that saw
        // no key, so that its P is 0), D, segment ids (-1 past Nq)
        float* rows = reinterpret_cast<float*>(smem + L::st_off +
                                               st * L::stage + L::rows_off);
        for (int r = pt; r < QR; r += NL) {
          const int qi = q0 + r;
          const float l = qi < a.Nq ? a.lse[row_base + qi] : kNegInf;
          rows[r] = l < kNegInf * 0.5f ? INFINITY : l * (float)kLog2e;
          rows[QR + r] = qi < a.Nq ? a.delta[row_base + qi] : 0.f;
          if (SEG) {
            reinterpret_cast<int*>(rows)[2 * QR + r] =
                qi < a.Nq ? a.q_seg[(long long)b * a.Nq + qi] : -1;
          }
        }
        if (F32) fence_proxy_async();
        mbar_arrive(full + 8 * st);
      }
    }
    return;
  }

  // two consumer warpgroups, 64 keys each (at d = 256 both on the CTA's
  // 64 keys, wide_consumer and wide_f32_consumer)
  if (F32) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  }
  if constexpr (L::WIDE && F32) {
    wide_f32_consumer<FUSED, SEG>(a, smem, full, empty, kv_bar, c0, hk, b, G,
                                  first, per_head, f);
    return;
  } else if constexpr (L::WIDE) {
    wide_consumer<FUSED, SEG>(a, smem, full, empty, kv_bar, c0, hk, b, G,
                              first, per_head);
    return;
  }
  // d <= 128: each warpgroup on its own 64 keys
  const int window = a.causal ? a.window : 0;
  const int kc0 = c0 + 64 * wg;
  int kr[2], kseg[2] = {0, 0};  // the thread's key rows and their ids
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    kr[hr] = kc0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2) + 8 * hr;
    if (SEG) {
      kseg[hr] = kr[hr] < a.Nk ? a.kv_seg[(long long)b * a.Nk + kr[hr]] : -2;
    }
  }
  float dk[SLABS][32], dv[SLABS][32];
#pragma unroll
  for (int sl = 0; sl < SLABS; ++sl) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      dk[sl][j] = 0.f;
      dv[sl][j] = 0.f;
    }
  }
  const uint32_t k_tile = base + L::k_off;
  const uint32_t v_tile = base + L::v_off;
  if (per_head > 0) mbar_wait(kv_bar, 0);

  int i = 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int it = first; it < first + per_head; ++it, ++i) {
      const int st = i % NST;
      const int q0 = it * BQ;
      mbar_wait(full + 8 * st, (i / NST) & 1);
      const uint32_t q_tile = base + L::st_off + st * L::stage;
      const float* rows = reinterpret_cast<const float*>(
          smem + L::st_off + st * L::stage + L::rows_off);

      // Sᵀ = K·Qᵀ, then dPᵀ = V·dOᵀ; P while dPᵀ is on the tensor cores
      float s_acc[32], dp_acc[32];
      const uint32_t do_tile = q_tile + L::PL * L::QT;
      wgmma_fence();
      if (F32) {
        cfa_bound::qk_issue_f32<D>(s_acc, k_tile, q_tile, wg);
        wgmma_commit();
        cfa_bound::qk_issue_f32<D>(dp_acc, v_tile, do_tile, wg);
      } else {
        cfa_bound::qk_issue<D>(s_acc, k_tile, q_tile, wg);
        wgmma_commit();
        cfa_bound::qk_issue<D>(dp_acc, v_tile, do_tile, wg);
      }
      wgmma_commit();
      wgmma_wait_one();
      float p[32];
      copy_after_wait(p, s_acc);
      if (!SEG && interior(a, kc0, q0, window)) {
        probs<false, false>(a, p, rows, nullptr, kr, kseg, q0, window);
      } else {
        probs<true, SEG>(a, p, rows, reinterpret_cast<const int*>(rows) +
                                         2 * BQ,
                         kr, kseg, q0, window);
      }
      wgmma_wait_all();
      float dp[32];
      copy_after_wait(dp, dp_acc);

      // dS = P ⊙ (dP − D)·scale; P and dS as bf16 A fragments (under F32
      // each split: P = pk + pk_lo, dS = dsk + dsk_lo)
      uint32_t pk[16], dsk[16], pk_lo[16], dsk_lo[16];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int col = 8 * (j >> 2) + 2 * (lane & 3);
        const float2 dl = *reinterpret_cast<const float2*>(rows + BQ + col);
        const float ds0 = p[j] * (dp[j] - dl.x) * a.scale;
        const float ds1 = p[j + 1] * (dp[j + 1] - dl.y) * a.scale;
        if (F32) {
          split2r(p[j], p[j + 1], f.round[0], pk[j >> 1], pk_lo[j >> 1]);
          split2r(ds0, ds1, f.round[1], dsk[j >> 1], dsk_lo[j >> 1]);
        } else {
          pk[j >> 1] = pack2(p[j], p[j + 1]);
          dsk[j >> 1] = pack2(ds0, ds1);
        }
      }
      const uint32_t ds_tile =
          base + L::ds_off + (L::NDS == 2 ? (i & 1) : 0) * L::PL * L::DS;
      if (FUSED) {
        // one dS tile (F32): at d = 128 the other warpgroup may still be
        // reading this one for the previous pair's dQ
        if (L::NDS == 1 && D == 128) consumer_sync();
        // dSᵀ (keys x queries) into the dS tile (queries x keys): slab wg,
        // key chunk 2·warp + hr; lane l addresses row l % 8 of matrix l / 8
        const int wp = (threadIdx.x >> 5) & 3;
        const int m = lane >> 3;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q = 8 * (2 * c + (m >> 1)) + (lane & 7);
          const uint32_t at =
              ds_tile + wg * BQ * 128 + swz(q, 2 * wp + (m & 1), 128);
          stmatrix_x4_trans(at, dsk[4 * c], dsk[4 * c + 1], dsk[4 * c + 2],
                            dsk[4 * c + 3]);
          if (F32) {
            stmatrix_x4_trans(at + L::DS, dsk_lo[4 * c], dsk_lo[4 * c + 1],
                              dsk_lo[4 * c + 2], dsk_lo[4 * c + 3]);
          }
        }
        fence_proxy_async();
      }

      // dV += Pᵀ·dO, dK += dSᵀ·Q. Waiting for them here, before dQ's
      // product, frees P's and dS's registers for dQ's accumulator (else
      // ptxas spills at d = 128, and up to 3% slower), and the stage: Q,
      // dO and the rows are read
      wgmma_fence();
      if (F32) {
        cfa_bound::pv_issue_f32<D>(dv, pk, pk_lo, do_tile);
        cfa_bound::pv_issue_f32<D>(dk, dsk, dsk_lo, q_tile);
      } else {
        cfa_bound::pv_issue<D>(dv, pk, do_tile);
        cfa_bound::pv_issue<D>(dk, dsk, q_tile);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pk);
      fence_regs(dsk);
      if (F32) {
        fence_regs(pk_lo);
        fence_regs(dsk_lo);
      }
      if (lane == 0) mbar_arrive(empty + 8 * st);
      if (FUSED) {
        // the staging tile is free once this warpgroup's last reduce has
        // read it; at d = 128 each warpgroup reads the other's dS slab
        const bool leader = (threadIdx.x & 127) == 0;
        if (L::RED && leader) bulk_wait_read();
        if (D == 128) {
          consumer_sync();
        } else {
          wg_sync(wg);
        }
        float dq[32];
        wgmma_fence();
        if (F32) {
          dq_issue_f32<D>(dq, ds_tile, k_tile, wg);
        } else {
          dq_issue<D>(dq, ds_tile, k_tile, wg);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dq);
        if (!L::RED) {
          add_dq<D>(a.dq_acc, dq, q0, a.Nq, (long long)(b * a.H + h) * a.Nq,
                    64 * wg);
        } else {
          // dQ_i's part into the staging tile, then added into dq_acc by
          // one TMA reduce per 32 columns, issued by the warpgroup's first
          // thread
          uint8_t* stg = smem + L::stg_off + wg * L::STG;
          stage_dq(stg, dq);
          fence_proxy_async();
          wg_sync(wg);
          if (leader) {
            const int col = D == 128 ? 64 * wg : 0;
            tma_reduce_add_4d(&tm_dq, smem_u32(stg), col, q0, h, b);
            tma_reduce_add_4d(&tm_dq, smem_u32(stg) + BQ * 128, col + 32, q0,
                              h, b);
            bulk_commit();
          }
        }
      }
    }
  }
#pragma unroll
  for (int sl = 0; sl < SLABS; ++sl) {
    fence_regs(dk[sl]);
    fence_regs(dv[sl]);
  }

  // the last reduces complete before the CTA's shared memory goes
  if (FUSED && L::RED && (threadIdx.x & 127) == 0) bulk_wait();
  // dK, dV cast once; a key tile that no query sees writes its zeros
  const long long kv_base = (long long)(b * a.Hkv + hk) * a.Nk;
  store_kv<D, F32>(a.dk, dk, kr, a.Nk, kv_base);
  store_kv<D, F32>(a.dv, dv, kr, a.Nk, kv_base);
}

template <int D, bool FUSED, bool SEG, bool F32>
cudaError_t launch(const CUtensorMap (&m)[5], const BwdArgs& a,
                   const F32Src& f, cudaStream_t stream) {
  const int smem = Layout<D, FUSED, F32>::bytes;
  auto kernel = flash_bwd_kv_kernel<D, FUSED, SEG, F32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int KB = Layout<D, FUSED, F32>::KB;
  const int grid = ((a.Nk + KB - 1) / KB) * a.Hkv * a.B;
  kernel<<<grid, NTHREADS, smem, stream>>>(m[0], m[1], m[2], m[3], m[4], a,
                                           f);
  return cudaGetLastError();
}

template <int D, bool F32>
cudaError_t launch_form(const CUtensorMap (&m)[5], const BwdArgs& a,
                        const F32Src& f, cudaStream_t stream) {
  const bool fused = a.dq_acc != nullptr;
  if (a.q_seg != nullptr) {
    return fused ? launch<D, true, true, F32>(m, a, f, stream)
                 : launch<D, false, true, F32>(m, a, f, stream);
  }
  return fused ? launch<D, true, false, F32>(m, a, f, stream)
               : launch<D, false, false, F32>(m, a, f, stream);
}

// The 2-byte build, or (the bf16 unit only) the fp32 one.
template <int D>
cudaError_t launch_type(const CUtensorMap (&m)[5], const BwdArgs& a,
                        const F32Src& f, int f32, cudaStream_t stream) {
  if constexpr (!kHalf) {
    if (f32) return launch_form<D, true>(m, a, f, stream);
  }
  return launch_form<D, false>(m, a, f, stream);
}

}  // namespace

// K2 when dq_acc is null, else K4 (which also adds dQ into dq_acc).
// f32: q, k, v, dO (and dk, dv) fp32, else bf16 (fp16 in the fp16 unit,
// cfa_flash_bwd_kv_f16, which takes f32 = 0 only); f32 = 1 + r_p + 3·r_ds
// rounds P before dV and dS before dK (and K4's dQ) by round_to's codes
// r_p, r_ds (a mixed-type call's upcast operands: P to dO's type, dS to
// q's). strides: q, k, v, dO,
// each (batch, head, row), in elements, every one a multiple of 16 bytes'
// elements and the bases 16-byte aligned (TMA; fp32 rows are read as
// float4). q_seg [B, Nq] and kv_seg [B, Nk] are int32 segment ids, or both
// null. dk, dv [B,Hkv,Nk,D] contiguous; lse, delta [B,H,Nq] contiguous
// fp32.
extern "C" int cfa_flash_bwd_kv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* q_seg,
                                const void* kv_seg, void* dk, void* dv,
                                void* dq_acc, int B, int H, int Hkv, int Nq,
                                int Nk, int D, const long long* strides,
                                double scale, int causal, int window,
                                int kv_offset, int f32, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (kv_seg == nullptr)) return cudaErrorInvalidValue;
  if (f32 < 0 || f32 > 9 || (kHalf && f32)) return cudaErrorInvalidValue;
  if (B == 0 || Nk == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 0 || Nq == 0) {
    // no query: dK and dV are zeros (and Q's maps would have no memory)
    const size_t bytes =
        (size_t)B * Hkv * Nk * D * (f32 ? sizeof(float) : sizeof(bf16));
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, st);
    return err;
  }
  BwdArgs a = {};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.q_seg = static_cast<const int*>(q_seg);
  a.kv_seg = static_cast<const int*>(kv_seg);
  a.dk = dk;
  a.dv = dv;
  a.dq_acc = static_cast<float*>(dq_acc);
  a.B = B; a.H = H; a.Hkv = Hkv; a.Nq = Nq; a.Nk = Nk;
  a.scale_log2e = (float)(scale * kLog2e);
  a.scale = (float)scale;
  a.causal = causal; a.window = window; a.kv_offset = kv_offset;
  // Q and dO [B,H,Nq,D] in boxes of 64 columns x BQ rows; K and V
  // [B,Hkv,Nk,D] in boxes of 64 columns x BK rows (BK_WIDE at d = 256);
  // 128 B swizzled, zeros past the live rows
  // (the fp32 build reads them through F32Src instead)
  CUtensorMap m[5] = {};
  F32Src f = {};
  const void* ptr[4] = {q, k, v, dout};
  const int heads[4] = {H, Hkv, Hkv, H};
  const int rows[4] = {Nq, Nk, Nk, Nq};
  const int kb = D == 256 ? BK_WIDE : BK;
  const int box[4] = {BQ, kb, kb, BQ};
  if (f32) {
    f.round[0] = (f32 - 1) % 3;  // P, before dV = Pᵀ·dO
    f.round[1] = (f32 - 1) / 3;  // dS, before dK = dSᵀ·Q (and K4's dQ)
  }
  for (int t = 0; t < 4; ++t) {
    const long long* s = strides + 3 * t;
    if (f32) {
      f.p[t] = static_cast<const float*>(ptr[t]);
      for (int j = 0; j < 3; ++j) f.st[3 * t + j] = s[j];
    } else if (!cfa_bound::encode4(&m[t], ptr[t], false, D, rows[t],
                                   heads[t], B, s[2] * 2, s[1] * 2, s[0] * 2,
                                   64, box[t], 1, 128)) {
      return cudaErrorInvalidValue;
    }
  }
  if (dq_acc != nullptr) {
    // dq_acc [B,H,Nq,D] fp32 in boxes of 32 columns x BQ rows, 128 B
    // swizzled; rows past Nq are not written
    const cfa_bound::EncodeTiled fn = cfa_bound::encode_tiled();
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Nq, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t str[3] = {(cuuint64_t)D * 4, (cuuint64_t)Nq * D * 4,
                               (cuuint64_t)H * Nq * D * 4};
    const cuuint32_t boxd[4] = {32, BQ, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    if (fn == nullptr ||
        fn(&m[4], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dq_acc, dims,
           str, boxd, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
           CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 64:
      return launch_type<64>(m, a, f, f32, st);
    case 128:
      return launch_type<128>(m, a, f, f32, st);
    case 256:
      return launch_type<256>(m, a, f, f32, st);
    default:
      return cudaErrorInvalidValue;
  }
}

#ifndef CFA_F16  // the prologue is built once, in the bf16 unit
// ---------------------------------------------------------------------------
// The backward's prologue: D and the zeroed dQ accumulator
// ---------------------------------------------------------------------------
//
// Replaces: the `_delta` and `_init_dq` steps of
// cuda_flashattention_tpu/ops/flash_bwd.py::_bwd_fused_kernel (its
// `fuse_delta` form, flash_bwd.py:289-296, :322, :330-337): D[b,h,i] =
// Σ_c dO[b,h,i,c] · O[b,h,i,c] in fp32 from O and dO in their storage
// types, and K4's fp32 dQ accumulator set to zero. The TPU kernel computes
// D in a first pass over the KV grid of each row tile it owns; K2 and K4
// here are key-parallel (every one of the Nk / 128 CTAs streams every Q
// tile), so D inside them would read O Nk / 128 times. One launch before
// them reads each row of O and dO once, for every window and for the
// split path alike (K2 and K3 read the same D; there it zeroes nothing).
//
// What bounds it on the H100: bytes. It reads O and dO once (2 · B·H·Nq·D
// elements), writes D (4 bytes a row) and, for K4, writes the fp32
// accumulator (4 · B·H·Nq·D bytes): ~1.5 operations a byte, far under
// the card's ~295. What the design does about it: D / 8 lanes own a row,
// 8 elements each (16 bytes of bf16, two float4 of fp32), and a thread
// issues the loads of 4 rows before it sums any, so that each lane keeps
// four 16-byte loads of O and four of dO in flight; the row's sum is a
// shuffle reduction over its lanes (its order is not PyTorch's: D differs
// from the plain version's in its last fp32 bits).

namespace {

constexpr int kDeltaThreads = 256;
constexpr int kDeltaRows = 4;  // rows a thread loads before it sums

// the prologue's type codes of O and dO
constexpr int kDeltaBf16 = 0, kDeltaF32 = 1, kDeltaF16 = 2;

// 8 elements at p (of type code T) as floats; p 16-byte aligned.
template <int T>
__device__ __forceinline__ void load8(const void* p, float (&x)[8]) {
  if constexpr (T == kDeltaF32) {
    const float4 a = __ldg(static_cast<const float4*>(p));
    const float4 b = __ldg(static_cast<const float4*>(p) + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else if constexpr (T == kDeltaF16) {
    const uint4 w = __ldg(static_cast<const uint4*>(p));
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __half22float2(*reinterpret_cast<const __half2*>(&u[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
    const uint4 w = __ldg(static_cast<const uint4*>(p));
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(u[i] << 16);
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

// The (batch, head, row) strides of O and dO, in elements.
struct DeltaStrides {
  long long o[3], d[3];
};

template <int D, int OT, int DT>
__global__ void __launch_bounds__(kDeltaThreads)
    bwd_delta_kernel(const void* __restrict__ o, const void* __restrict__ dout,
                     float* __restrict__ delta, float* __restrict__ dq_acc,
                     long long rows, int H, int Nq, const DeltaStrides st) {
  constexpr int LPR = D / 8;                  // lanes of a row
  constexpr int RPP = kDeltaThreads / LPR;    // rows of a block's pass
  const int part = threadIdx.x % LPR;
  const long long r0 =
      (long long)blockIdx.x * RPP * kDeltaRows + threadIdx.x / LPR;
  float x[kDeltaRows][8], y[kDeltaRows][8];
#pragma unroll
  for (int u = 0; u < kDeltaRows; ++u) {
    const long long r = r0 + (long long)u * RPP;
    if (r < rows) {
      const long long b = r / ((long long)H * Nq);
      const int h = (int)(r / Nq % H), i = (int)(r % Nq);
      const long long oo = b * st.o[0] + h * st.o[1] + i * st.o[2] + part * 8;
      const long long od = b * st.d[0] + h * st.d[1] + i * st.d[2] + part * 8;
      load8<OT>(static_cast<const char*>(o) + oo * (OT == kDeltaF32 ? 4 : 2),
                x[u]);
      load8<DT>(static_cast<const char*>(dout) +
                    od * (DT == kDeltaF32 ? 4 : 2),
                y[u]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[u][e] = y[u][e] = 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < kDeltaRows; ++u) {
    const long long r = r0 + (long long)u * RPP;
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) sum = fmaf(x[u][e], y[u][e], sum);
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (r < rows) {
      if (part == 0) delta[r] = sum;
      if (dq_acc != nullptr) {
        float4* row = reinterpret_cast<float4*>(dq_acc + r * D);
#pragma unroll
        for (int c = part; c < D / 4; c += LPR) {
          row[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
  }
}

template <int D, int OT, int DT>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         float* dq_acc, long long rows, int H, int Nq,
                         const DeltaStrides& st, cudaStream_t stream) {
  constexpr long long per_block = kDeltaThreads / (D / 8) * kDeltaRows;
  const long long blocks = (rows + per_block - 1) / per_block;
  bwd_delta_kernel<D, OT, DT><<<(unsigned)blocks, kDeltaThreads, 0,
                                stream>>>(o, dout, delta, dq_acc, rows, H, Nq,
                                          st);
  return cudaGetLastError();
}

template <int D, int OT>
cudaError_t launch_delta_do(const void* o, const void* dout, float* delta,
                            float* dq_acc, long long rows, int H, int Nq,
                            const DeltaStrides& st, int do_type,
                            cudaStream_t s) {
  switch (do_type) {
    case kDeltaF32:
      return launch_delta<D, OT, kDeltaF32>(o, dout, delta, dq_acc, rows, H,
                                            Nq, st, s);
    case kDeltaF16:
      return launch_delta<D, OT, kDeltaF16>(o, dout, delta, dq_acc, rows, H,
                                            Nq, st, s);
    default:
      return launch_delta<D, OT, kDeltaBf16>(o, dout, delta, dq_acc, rows, H,
                                             Nq, st, s);
  }
}

template <int D>
cudaError_t launch_delta_types(const void* o, const void* dout, float* delta,
                               float* dq_acc, long long rows, int H, int Nq,
                               const DeltaStrides& st, int o_type, int do_type,
                               cudaStream_t s) {
  switch (o_type) {
    case kDeltaF32:
      return launch_delta_do<D, kDeltaF32>(o, dout, delta, dq_acc, rows, H,
                                           Nq, st, do_type, s);
    case kDeltaF16:
      return launch_delta_do<D, kDeltaF16>(o, dout, delta, dq_acc, rows, H,
                                           Nq, st, do_type, s);
    default:
      return launch_delta_do<D, kDeltaBf16>(o, dout, delta, dq_acc, rows, H,
                                            Nq, st, do_type, s);
  }
}

}  // namespace

// The backward's prologue, before K4 (or K2 + K3): delta [B,H,Nq] fp32 =
// rowsum(dO ⊙ O), and dq_acc [B,H,Nq,D] fp32 contiguous set to zero when it
// is not null (K4). o, dout [B,H,Nq,D], each of its own type: o_type,
// do_type 0 bf16, 1 fp32, 2 fp16;
// strides: o then dO, each (batch, head, row), in elements, rows of unit
// stride and 16-byte aligned.
extern "C" int cfa_bwd_delta(const void* o, const void* dout, void* delta,
                             void* dq_acc, int B, int H, int Nq, int D,
                             const long long* strides, int o_type,
                             int do_type, void* stream) {
  const long long rows = (long long)B * H * Nq;
  if (rows == 0) return cudaSuccess;
  if (o_type < 0 || o_type > 2 || do_type < 0 || do_type > 2) {
    return cudaErrorInvalidValue;
  }
  DeltaStrides st;
  for (int i = 0; i < 3; ++i) {
    st.o[i] = strides[i];
    st.d[i] = strides[3 + i];
  }
  float* dl = static_cast<float*>(delta);
  float* dq = static_cast<float*>(dq_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_delta_types<64>(o, dout, dl, dq, rows, H, Nq, st, o_type,
                                    do_type, s);
    case 128:
      return launch_delta_types<128>(o, dout, dl, dq, rows, H, Nq, st, o_type,
                                     do_type, s);
    case 256:
      return launch_delta_types<256>(o, dout, dl, dq, rows, H, Nq, st, o_type,
                                     do_type, s);
    default:
      return cudaErrorInvalidValue;
  }
}
#endif  // CFA_F16
