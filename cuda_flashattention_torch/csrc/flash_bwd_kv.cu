// FlashAttention-2 backward, key-parallel, for Hopper: dK/dV (K2) and
// dQ/dK/dV in one pass (K4), bf16 in, fp32 accumulation.
//
// Replaces: cuda_flashattention_tpu/ops/flash_bwd.py::_bwd_dkdv_kernel
// (flash_bwd.py:117, K2) and ::_bwd_fused_kernel (flash_bwd.py:252, K4).
// The Q-parallel dQ kernel (K3, ::_bwd_dq_kernel) stays in flash_bwd.cu on
// 16x16 wmma fragments: it runs only on the split path (fused=False),
// which no training step takes, and it is the next kernel to rebuild.
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

#include <math.h>

#include "flash_fwd_bound_sm90.cuh"

namespace {

using cfa_bound::bf16;
using cfa_bound::consumer_sync;
using cfa_bound::copy_after_wait;
using cfa_bound::fence_proxy_async;
using cfa_bound::fence_regs;
using cfa_bound::kNegInf;
using cfa_bound::make_desc;
using cfa_bound::mbar_arrive;
using cfa_bound::mbar_expect_tx;
using cfa_bound::mbar_init;
using cfa_bound::mbar_wait;
using cfa_bound::smem_u32;
using cfa_bound::swz;
using cfa_bound::tma_load_4d;
using cfa_bound::wgmma_commit;
using cfa_bound::wgmma_fence;
using cfa_bound::wgmma_wait_all;
using cfa_bound::wgmma_wait_one;

constexpr double kLog2e = 1.4426950408889634;
constexpr int BK = 128;        // keys of a CTA (two warpgroups of 64)
constexpr int BQ = 64;         // query rows of a streamed tile
constexpr int NST = 2;         // Q/dO stages in flight
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
  bf16* dk;            // [B,Hkv,Nk,D] contiguous
  bf16* dv;
  float* dq_acc;       // [B,H,Nq,D] fp32, zeroed (K4)
  int B, H, Hkv, Nq, Nk;
  float scale_log2e, scale;
  int causal, window, kv_offset;
};

// Shared memory (byte offsets from a 1024-aligned base): K and V (D/64
// slabs of 128 rows x 128 B each); K4's two dS tiles (2 slabs of 64 query
// rows x 64 keys), used in turn, and a dQ staging tile per warpgroup (64
// rows x 64 fp32); NST stages of Q and dO (D/64 slabs of 64 rows) and
// their rows' LSE (log2), D and segment ids; barriers.
template <int D, bool FUSED>
struct Layout {
  static constexpr int KV = BK * D * 2;
  static constexpr int QT = BQ * D * 2;
  static constexpr int DS = BQ * BK * 2;
  static constexpr int k_off = 0;
  static constexpr int v_off = KV;
  static constexpr int ds_off = 2 * KV;
  static constexpr int STG = BQ * 64 * 4;  // a warpgroup's dQ staging
  static constexpr int stg_off = ds_off + (FUSED ? 2 * DS : 0);
  static constexpr int st_off = stg_off + (FUSED ? 2 * STG : 0);
  static constexpr int rows_off = 2 * QT;  // within a stage
  static constexpr int stage = cfa_bound::align1k(rows_off + 3 * BQ * 4);
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
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CFA_REGS32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : CFA_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
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

// The Q tiles [first, last] that can see keys c0 .. c0 + BK − 1
// (ops/flash_bwd.py::_bwd_q_tiles states the same walk): causal rows see
// keys <= row + kv_offset; with a window the last row that reaches the
// tile's last key is that key − kv_offset + window − 1.
__device__ __forceinline__ void q_tiles(const BwdArgs& a, int c0, int& first,
                                        int& last) {
  first = 0;
  last = (a.Nq + BQ - 1) / BQ - 1;
  if (a.causal) {
    first = max(0, c0 - a.kv_offset) / BQ;
    if (a.window > 0) {
      const int last_row = min(a.Nk, c0 + BK) - 2 + a.window - a.kv_offset;
      last = last_row < 0 ? -1 : min(last, last_row / BQ);
    }
  }
}

// Whether every (key of this warpgroup's 64 at kc0, query of the tile at
// q0) pair is visible, so that the element mask can be skipped (rows past
// Nq have LSE +inf: their P is 0 either way).
__device__ __forceinline__ bool interior(const BwdArgs& a, int kc0, int q0,
                                         int window) {
  if (kc0 + 64 > a.Nk) return false;
  if (a.causal) {
    if (kc0 + 63 > q0 + a.kv_offset) return false;
    if (window > 0 && kc0 <= q0 + BQ - 1 + a.kv_offset - window) return false;
  }
  return true;
}

// P on this thread's 32 entries of Sᵀ (two key rows kr[0..1], the tile's
// query columns in wgmma's accumulator layout): in place, p = exp2(s ·
// scale·log2e − lse2[col]), 0 where masked. With MASKED false no element
// is tested.
template <bool MASKED, bool SEG>
__device__ __forceinline__ void probs(const BwdArgs& a, float (&s)[32],
                                      const float* lse2, const int* qseg,
                                      const int (&kr)[2], const int (&kseg)[2],
                                      int q0, int window) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
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
// the dS tile (2 slabs of 64 keys, K-major), k: the K tile.
template <int D>
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
        make_desc(k + slab * BK * 128 + kb * 128, 1024, 1024, 1), kk > 0);
  }
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

// This warpgroup's 64 rows of dK (or dV) as bf16, past Nk skipped.
template <int D>
__device__ __forceinline__ void store_kv(bf16* out,
                                         const float (&acc)[D / 64][32],
                                         const int (&kr)[2], int Nk,
                                         long long kv_base) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int sl = 0; sl < D / 64; ++sl) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hr = (i >> 1) & 1;
      if (kr[hr] >= Nk) continue;
      const int col = sl * 64 + 8 * (i >> 2) + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(out + (kv_base + kr[hr]) * D + col) =
          __floats2bfloat162_rn(acc[sl][i], acc[sl][i + 1]);
    }
  }
}

// K2 (FUSED = false) and K4 (FUSED = true).
template <int D, bool FUSED, bool SEG>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_kv_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_dq,
                        const BwdArgs a) {
  using L = Layout<D, FUSED>;
  constexpr int SLABS = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::bar_off;  // + 8 * stage
  const uint32_t empty = full + 8 * NST;    // + 8 * stage
  const uint32_t kv_bar = empty + 8 * NST;

  int kt, hk, b;
  cta_tile(a, kt, hk, b);
  const int c0 = kt * BK;
  const int G = a.H / a.Hkv;
  int first, last;
  q_tiles(a, c0, first, last);
  const int per_head = max(0, last - first + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full + 8 * s, 33);  // the TMA issue and the warp's row loads
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x >= 2 * 128 + 32) return;
    if (lane == 0 && per_head > 0) {
      mbar_expect_tx(kv_bar, 2 * L::KV);
      for (int sl = 0; sl < SLABS; ++sl) {
        tma_load_4d(base + L::k_off + sl * BK * 128, &tm_k, kv_bar, sl * 64,
                    c0, hk, b);
        tma_load_4d(base + L::v_off + sl * BK * 128, &tm_v, kv_bar, sl * 64,
                    c0, hk, b);
      }
    }
    int i = 0;
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      const long long row_base = (long long)(b * a.H + h) * a.Nq;
      for (int it = first; it < first + per_head; ++it, ++i) {
        const int st = i % NST;
        const int q0 = it * BQ;
        mbar_wait(empty + 8 * st, ((i / NST) & 1) ^ 1);
        const uint32_t dst = base + L::st_off + st * L::stage;
        if (lane == 0) {
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
        for (int r = lane; r < BQ; r += 32) {
          const int qi = q0 + r;
          const float l = qi < a.Nq ? a.lse[row_base + qi] : kNegInf;
          rows[r] = l < kNegInf * 0.5f ? INFINITY : l * (float)kLog2e;
          rows[BQ + r] = qi < a.Nq ? a.delta[row_base + qi] : 0.f;
          if (SEG) {
            reinterpret_cast<int*>(rows)[2 * BQ + r] =
                qi < a.Nq ? a.q_seg[(long long)b * a.Nq + qi] : -1;
          }
        }
        mbar_arrive(full + 8 * st);
      }
    }
    return;
  }

  // two consumer warpgroups, 64 keys each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
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
      const uint32_t do_tile = q_tile + L::QT;
      const float* rows = reinterpret_cast<const float*>(
          smem + L::st_off + st * L::stage + L::rows_off);

      // Sᵀ = K·Qᵀ, then dPᵀ = V·dOᵀ; P while dPᵀ is on the tensor cores
      float s_acc[32], dp_acc[32];
      wgmma_fence();
      cfa_bound::qk_issue<D>(s_acc, k_tile, q_tile, wg);
      wgmma_commit();
      cfa_bound::qk_issue<D>(dp_acc, v_tile, do_tile, wg);
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

      // dS = P ⊙ (dP − D)·scale; P and dS as bf16 A fragments
      uint32_t pk[16], dsk[16];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int col = 8 * (j >> 2) + 2 * (lane & 3);
        const float2 dl = *reinterpret_cast<const float2*>(rows + BQ + col);
        const float ds0 = p[j] * (dp[j] - dl.x) * a.scale;
        const float ds1 = p[j + 1] * (dp[j + 1] - dl.y) * a.scale;
        __nv_bfloat162 pp = __floats2bfloat162_rn(p[j], p[j + 1]);
        __nv_bfloat162 dd = __floats2bfloat162_rn(ds0, ds1);
        pk[j >> 1] = *reinterpret_cast<uint32_t*>(&pp);
        dsk[j >> 1] = *reinterpret_cast<uint32_t*>(&dd);
      }
      const uint32_t ds_tile = base + L::ds_off + (i & 1) * L::DS;
      if (FUSED) {
        // dSᵀ (keys x queries) into the dS tile (queries x keys): slab wg,
        // key chunk 2·warp + hr; lane l addresses row l % 8 of matrix l / 8
        const int wp = (threadIdx.x >> 5) & 3;
        const int m = lane >> 3;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q = 8 * (2 * c + (m >> 1)) + (lane & 7);
          stmatrix_x4_trans(ds_tile + wg * BQ * 128 + swz(q, 2 * wp + (m & 1),
                                                          128),
                            dsk[4 * c], dsk[4 * c + 1], dsk[4 * c + 2],
                            dsk[4 * c + 3]);
        }
        fence_proxy_async();
      }

      // dV += Pᵀ·dO, dK += dSᵀ·Q. Waiting for them here, before dQ's
      // product, frees P's and dS's registers for dQ's accumulator (else
      // ptxas spills at d = 128, and up to 3% slower), and the stage: Q,
      // dO and the rows are read
      wgmma_fence();
      cfa_bound::pv_issue<D>(dv, pk, do_tile);
      cfa_bound::pv_issue<D>(dk, dsk, q_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pk);
      fence_regs(dsk);
      if (lane == 0) mbar_arrive(empty + 8 * st);
      if (FUSED) {
        // the staging tile is free once this warpgroup's last reduce has
        // read it; at d = 128 each warpgroup reads the other's dS slab
        const bool leader = (threadIdx.x & 127) == 0;
        if (leader) bulk_wait_read();
        if (D == 128) {
          consumer_sync();
        } else {
          wg_sync(wg);
        }
        float dq[32];
        wgmma_fence();
        dq_issue<D>(dq, ds_tile, k_tile, wg);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dq);
        // dQ_i's part into the staging tile, then added into dq_acc by one
        // TMA reduce per 32 columns, issued by the warpgroup's first thread
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
#pragma unroll
  for (int sl = 0; sl < SLABS; ++sl) {
    fence_regs(dk[sl]);
    fence_regs(dv[sl]);
  }

  // the last reduces complete before the CTA's shared memory goes
  if (FUSED && (threadIdx.x & 127) == 0) bulk_wait();
  // dK, dV cast once; a key tile that no query sees writes its zeros
  const long long kv_base = (long long)(b * a.Hkv + hk) * a.Nk;
  store_kv<D>(a.dk, dk, kr, a.Nk, kv_base);
  store_kv<D>(a.dv, dv, kr, a.Nk, kv_base);
}

template <int D, bool FUSED, bool SEG>
cudaError_t launch(const CUtensorMap (&m)[5], const BwdArgs& a,
                   cudaStream_t stream) {
  const int smem = Layout<D, FUSED>::bytes;
  auto kernel = flash_bwd_kv_kernel<D, FUSED, SEG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = ((a.Nk + BK - 1) / BK) * a.Hkv * a.B;
  kernel<<<grid, NTHREADS, smem, stream>>>(m[0], m[1], m[2], m[3], m[4], a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_form(const CUtensorMap (&m)[5], const BwdArgs& a,
                        cudaStream_t stream) {
  const bool fused = a.dq_acc != nullptr;
  if (a.q_seg != nullptr) {
    return fused ? launch<D, true, true>(m, a, stream)
                 : launch<D, false, true>(m, a, stream);
  }
  return fused ? launch<D, true, false>(m, a, stream)
               : launch<D, false, false>(m, a, stream);
}

}  // namespace

// K2 when dq_acc is null, else K4 (which also adds dQ into dq_acc).
// strides: q, k, v, dO, each (batch, head, row), in elements, every one a
// multiple of 8 and the bases 16-byte aligned (TMA). q_seg [B, Nq] and
// kv_seg [B, Nk] are int32 segment ids, or both null. dk, dv [B,Hkv,Nk,D]
// contiguous; lse, delta [B,H,Nq] contiguous fp32.
extern "C" int cfa_flash_bwd_kv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* q_seg,
                                const void* kv_seg, void* dk, void* dv,
                                void* dq_acc, int B, int H, int Hkv, int Nq,
                                int Nk, int D, const long long* strides,
                                double scale, int causal, int window,
                                int kv_offset, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (kv_seg == nullptr)) return cudaErrorInvalidValue;
  if (B == 0 || Nk == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 0 || Nq == 0) {
    // no query: dK and dV are zeros (and Q's maps would have no memory)
    const size_t bytes = (size_t)B * Hkv * Nk * D * sizeof(bf16);
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, st);
    return err;
  }
  BwdArgs a = {};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.q_seg = static_cast<const int*>(q_seg);
  a.kv_seg = static_cast<const int*>(kv_seg);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dq_acc = static_cast<float*>(dq_acc);
  a.B = B; a.H = H; a.Hkv = Hkv; a.Nq = Nq; a.Nk = Nk;
  a.scale_log2e = (float)(scale * kLog2e);
  a.scale = (float)scale;
  a.causal = causal; a.window = window; a.kv_offset = kv_offset;
  // Q and dO [B,H,Nq,D] in boxes of 64 columns x BQ rows; K and V
  // [B,Hkv,Nk,D] in boxes of 64 columns x BK rows; 128 B swizzled, zeros
  // past the live rows
  CUtensorMap m[5] = {};
  const void* ptr[4] = {q, k, v, dout};
  const int heads[4] = {H, Hkv, Hkv, H};
  const int rows[4] = {Nq, Nk, Nk, Nq};
  const int box[4] = {BQ, BK, BK, BQ};
  for (int t = 0; t < 4; ++t) {
    const long long* s = strides + 3 * t;
    if (!cfa_bound::encode4(&m[t], ptr[t], false, D, rows[t], heads[t], B,
                            s[2] * 2, s[1] * 2, s[0] * 2, 64, box[t], 1,
                            128)) {
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
      return launch_form<64>(m, a, st);
    case 128:
      return launch_form<128>(m, a, st);
    default:
      return cudaErrorInvalidValue;
  }
}
