// FlashAttention-2 backward's Q-parallel dQ kernel (K3), for Hopper: bf16
// in, fp32 accumulation, bf16 dQ; or fp32 in and out (the F32 build).
//
// Replaces: cuda_flashattention_tpu/ops/flash_bwd.py::_bwd_dq_kernel (K3).
// Its key-parallel partners, dK/dV (K2) and the fused pass (K4), are the
// kernel of flash_bwd_kv.cu; K3 runs only beside K2 on the split path
// (fused=False).
//
// What bounds it on the H100: per visible (query, key) pair it does three
// products of 2·d operations (S = Q·Kᵀ, dP = dO·Vᵀ, dQ += dS·K) on tiles
// read once per pair, so at the training shapes (N = 4096, d = 128) it is
// compute-bound like the forward, and in practice bound by how much of the
// elementwise work between the products (exp2, the masks, dS) hides under
// them.
//
// What this design does about it: K3 is the forward's Q-major walk with
// one product more, on the forward's Hopper helpers
// (flash_fwd_bound_sm90.cuh; nothing there changes, and K3 has its own
// argument struct, so the forward kernels compile as before):
//   - One CTA per 128-row query tile of packed heads (the Gp query heads of
//     one KV head that K1 packs, R = 128 / Gp positions each), heaviest
//     tiles first under causal, as K1's `cta_tile` orders them. Q and dO
//     come in once by TMA, 128 B swizzled, and stay resident; a producer
//     warp streams the visible K/V tiles (64 keys) through NST mbarrier
//     stages, with each tile's key segment ids beside them (SEG).
//   - Two consumer warpgroups own 64 query rows each. Per key tile each
//     issues S = Q·Kᵀ and dP = dO·Vᵀ (SS wgmma: `qk_issue` with dO in Q's
//     place and V in K's), computes P while dP is on the tensor cores,
//     then dS in registers, rounded to bf16 into wgmma's A layout, and
//     issues dQ += dS·K (RS wgmma: `pv_issue` with K in V's place, a K
//     tile [keys, d] having V's layout). That product is left in flight
//     under the next tile's S and dP, whose wait also releases its stage.
//   - S, dP, dS and the dQ accumulator never leave registers (dQ 64 of
//     setmaxnreg's 240 at d = 128); results are copied out of the
//     accumulators after their waits, so ptxas keeps the groups async.
//   - A warpgroup whose 64 rows see every key of a tile takes the unmasked
//     step; segment ids are a build of their own (SEG), whose tiles always
//     take the masked step.
// Budget at d = 128: shared memory Q and dO 64 KB, NST = 4 stages of K
// and V 128 KB (132 KB with the ids): 193-197 KB of 227 KB, one CTA (384
// threads) per SM (on one H100 a fourth stage was 1-3% faster than three,
// two stages 1-7% slower); registers per consumer thread: dQ 64, S and dP
// 64 (and their copies read after the waits), dS 16, within setmaxnreg's
// 240, with no spill.
//
// Numerics follow the TPU kernels (flash_bwd.py:53-114) and
// flash_attention_backward_plain: S from the raw q as fp32 q·kᵀ times
// scale·log2(e); P = exp2(S − LSE·log2e) with P = 0 for masked pairs
// (ragged tail, causal with kv_offset, sliding window, segment ids) and
// for rows whose LSE < NEG_INF/2; dP = dO·Vᵀ and dS = P ⊙ (dP − D)·scale
// in fp32; dS is rounded to bf16 before dQ += dS·K. A Q tile that sees no
// key writes zeros.
//
// The F32 build (fp32 Q, K, V, dO and dQ) is the split of K2/K4's fp32
// build: the producer warpgroup's 128 threads read every tile and write it
// as bf16 hi and lo tiles (split_rows), each of the three products is
// three bf16 wgmmas (lo·hi + hi·lo + hi·hi), dS is split in registers and
// not rounded, and dQ is stored fp32. Its budget at d = 128: Q and dO
// resident as hi + lo take 128 KB, and a 64-key stage of K and V as hi +
// lo 64 KB, so 64-key tiles leave room for one stage, whose split by the
// producer could then never overlap the products. The F32 build walks
// 32-key tiles instead (wgmma m64n32 for S and dP, two k16 steps for dQ):
// a stage is 32 KB and three fit (226 KB; two under SEG, whose ids push a
// stage past 32 KB), with Q, dO and the 128-row CTA of the bf16 build
// unchanged. A 64-row CTA with two 64-key stages would fit as well, but
// with one consumer warpgroup and every K/V tile split once per 64 rows
// instead of per 128.
//
// The d = 256 build (bf16) has the F32 d = 128 build's bytes: Q and dO
// resident take 128 KB (four 64-column slabs of 128 rows each), so it
// walks 32-key tiles too (wgmma m64n32 for S and dP, dQ += dS·K two k16
// steps): a K + V stage is 32 KB, three stages (two under SEG) beside Q
// and dO, 226 KB. Registers per consumer thread: dQ 128 (acc[4][32]), S
// and dP 16 each (and their copies), dS 8, within setmaxnreg's 240.
//
// The F32 build at d = 256 (W1). A 128-row CTA's split Q and dO alone take
// 256 KB, past the 232,448 bytes. So its CTA holds 64 query rows of packed
// heads (R = 64 / Gp positions each) with ONE consumer warpgroup (the
// second exits at once): split Q and dO resident, 128 KB, and 16-key split
// K + V tiles, 32 KB a stage, three stages (two under SEG), 225 KB. S and
// dP are wgmma m64n16 (three per k16 step and slab), dQ += dS·K one k16
// step of RS wgmma per plane pair. Every K/V tile is read and split once
// per 64 rows, twice as often as per 128; a 32-key stage (64 KB) would
// leave room for one stage, whose split could never overlap the products.
// Registers per consumer thread: dQ 128, S and dP 8 each (and their
// copies), dS 8, within setmaxnreg's 232.

#include <math.h>

#include "flash_fwd_bound_sm90.cuh"

namespace {

using cfa_bound::align1k;
using cfa_bound::bf16;
using cfa_bound::elem;
using cfa_bound::kHalf;
using cfa_bound::pack2;
using cfa_bound::split2r;
using cfa_bound::copy_after_wait;
using cfa_bound::F32Src;
using cfa_bound::fence_proxy_async;
using cfa_bound::fence_regs;
using cfa_bound::kBf16;
using cfa_bound::kNegInf;
using cfa_bound::mbar_arrive;
using cfa_bound::mbar_expect_tx;
using cfa_bound::mbar_init;
using cfa_bound::mbar_wait;
using cfa_bound::make_desc;
using cfa_bound::smem_u32;
using cfa_bound::split2;
using cfa_bound::split_rows;
using cfa_bound::tma_load_4d;
using cfa_bound::wgmma_commit;
using cfa_bound::wgmma_fence;
using cfa_bound::wgmma_ss_bf16_n16;
using cfa_bound::wgmma_ss_bf16_n32;
using cfa_bound::wgmma_wait_all;
using cfa_bound::wgmma_wait_one;

constexpr double kLog2e = 1.4426950408889634;
constexpr int BM = cfa_bound::BM;  // query rows of a CTA (two warpgroups)
constexpr int BN = cfa_bound::BN;  // keys of a tile (F32, d = 256: 32)
constexpr int NTHREADS = 384;      // two consumer warpgroups and the producer's

// What the kernel is given besides its four TMA maps (its own struct: the
// forward's Args is left exactly as the forward kernels compile it).
struct DqArgs {
  const float* lse;    // [B,H,Nq], natural log
  const float* delta;  // [B,H,Nq], rowsum(dO ⊙ O)
  const int* q_seg;    // [B,Nq] (SEG)
  const int* kv_seg;   // [B,Nk] (SEG)
  void* dq;            // [B,H,Nq,D] contiguous, bf16 (fp32 under F32)
  int H, Nq, Nk;
  int G, Gp, R;        // group size, heads packed in a tile, rows per head
  float scale_log2e, scale;
  int causal, window, kv_offset;
};

// Shared memory (byte offsets from a 1024-aligned base): the Q and dO tiles
// (D/64 slabs of 128 rows x 128 B each); NST stages of K and V (D/64 slabs
// of KN rows x 128 B each) and the tile's key segment ids (SEG); barriers.
// Under F32 each tile is a hi tile and a lo tile (lo right after hi) and a
// key tile is 32 keys, as at d = 256; under F32 at d = 256 (W1) the CTA
// holds ROWS = 64 query rows and a key tile is 16 keys.
template <int D, bool SEG, bool F32>
struct Layout {
  static constexpr int PL = F32 ? 2 : 1;   // planes of a tile: hi (and lo)
  static constexpr bool W1 = F32 && D == 256;  // one consumer warpgroup
  static constexpr int ROWS = W1 ? 64 : BM;    // query rows of a CTA
  static constexpr int NWG = W1 ? 1 : 2;       // consumer warpgroups
  static constexpr bool K32 = !W1 && (F32 || D == 256);
  static constexpr int KN = W1 ? 16 : K32 ? 32 : BN;  // keys of a tile
  static constexpr int NST =
      !W1 && (!K32 || D == 64) ? 4 : SEG ? 2 : 3;  // stages
  static constexpr int QT = ROWS * D * 2;  // the Q (or dO) tile (a plane)
  static constexpr int KV = KN * D * 2;    // a K (or V) tile (a plane)
  static constexpr int do_off = PL * QT;
  static constexpr int st_off = 2 * PL * QT;
  static constexpr int v_off = PL * KV;    // V within a stage
  static constexpr int ids = 2 * PL * KV;  // within a stage
  static constexpr int stage = align1k(ids + (SEG ? KN * 4 : 0));
  static constexpr int bar_off = st_off + NST * stage;
  static constexpr int bytes = bar_off + 8 * (2 * NST + 1) + 1024;
  static_assert(bytes <= 232448, "the CTA's shared memory");
};

// The (Q tile, head group, batch) of this CTA: under causal the linear
// block index walks the Q tiles from the last to the first, all head groups
// and batches of one tile together, so the longest walks start in the
// first wave (K1's order; ops/flash_bwd.py::_dq_cta_order states it).
__device__ __forceinline__ void cta_tile(const DqArgs& a, int& qt, int& hg,
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

// Key tiles [t_begin, t_end) of KN keys that positions q_lo..q_hi can see
// (ops/flash_bwd.py::_dq_key_tiles states the same walk): causal rows see
// keys <= pos + kv_offset, windowed ones keys > pos + kv_offset − window.
template <int KN>
__device__ __forceinline__ void key_tiles(const DqArgs& a, int q_lo, int q_hi,
                                          int& t_begin, int& t_end) {
  t_begin = 0;
  t_end = (a.Nk + KN - 1) / KN;
  if (a.causal) {
    const int kv_end = min(a.Nk, max(0, q_hi + a.kv_offset + 1));
    t_end = min(t_end, (kv_end + KN - 1) / KN);
    if (a.window > 0) {
      // a window that starts past the last key leaves nothing to see
      const int lo_key = q_lo + a.kv_offset - a.window + 1;
      t_begin = max(0, lo_key) / KN;
      if (lo_key >= a.Nk) t_end = min(t_end, t_begin);
    }
  }
}

// Whether every (position in q_lo..q_hi, key of the KN-key tile at c0)
// pair is visible, so that the element mask can be skipped.
template <int KN>
__device__ __forceinline__ bool interior(const DqArgs& a, int c0, int q_lo,
                                         int q_hi) {
  if (c0 + KN > a.Nk) return false;
  if (a.causal) {
    if (c0 + KN - 1 > q_lo + a.kv_offset) return false;
    if (a.window > 0 && c0 <= q_hi + a.kv_offset - a.window) return false;
  }
  return true;
}

// P in place on this thread's N scores of a tile pair (its two rows'
// columns in wgmma's accumulator layout; N = 32 for 64 keys, 16 for 32):
// p = exp2(s · scale·log2e − lse2[row]), 0 where masked. With MASKED false
// no element is tested.
template <bool MASKED, bool SEG, int N>
__device__ __forceinline__ void probs(const DqArgs& a, float (&s)[N],
                                      const float (&lse2)[2],
                                      const int (&qp)[2], const int* kseg,
                                      const int (&qseg)[2], int c0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int col = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
    const int hr = (j >> 1) & 1;
    bool ok = true;
    if (MASKED) {
      const int cg = c0 + col;
      ok = cg < a.Nk;
      if (a.causal) {
        ok = ok && cg <= qp[hr] && (a.window <= 0 || cg > qp[hr] - a.window);
      }
      if (SEG) ok = ok && kseg[col] == qseg[hr];
    }
    s[j] = ok ? exp2f(fmaf(s[j], a.scale_log2e, -lse2[hr])) : 0.f;
  }
}

// S (or dP) [64 x 32] of this warpgroup's rows = Q · Kᵀ on a 32-key tile
// (the F32 build's and the d = 256 build's), as wgmma m64n32k16; dQ += dS
// · K is the body's pv_issue (pv_issue_f32) over 32 keys; F32: split
// tiles, a lo tile right after its hi tile.
template <int D, bool ACC>
__device__ __forceinline__ void qk32_issue(float (&s)[16], uint32_t q,
                                           uint32_t k, int wg) {
#pragma unroll
  for (int sl = 0; sl < D / 64; ++sl) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss_bf16_n32(
          s,
          make_desc(q + sl * BM * 128 + wg * 64 * 128 + kk * 32, 16, 1024,
                    1),
          make_desc(k + sl * 32 * 128 + kk * 32, 16, 1024, 1),
          ACC || sl + kk > 0);
    }
  }
}

template <int D>
__device__ __forceinline__ void qk32_issue_f32(float (&s)[16], uint32_t q,
                                               uint32_t k, int wg) {
  qk32_issue<D, false>(s, q + BM * D * 2, k, wg);
  qk32_issue<D, true>(s, q, k + 32 * D * 2, wg);
  qk32_issue<D, true>(s, q, k, wg);
}

// S (or dP) [64 x 16] = Q · Kᵀ of the W1 build (64-row Q tile, 16-key K
// tile, d = 256) on one plane of each, as wgmma m64n16k16; the split form
// lo·hi + hi·lo + hi·hi.
template <bool ACC>
__device__ __forceinline__ void qk16_issue(float (&s)[8], uint32_t q,
                                           uint32_t k) {
#pragma unroll
  for (int sl = 0; sl < 4; ++sl) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss_bf16_n16(s, make_desc(q + sl * 64 * 128 + kk * 32, 16, 1024, 1),
                        make_desc(k + sl * 16 * 128 + kk * 32, 16, 1024, 1),
                        ACC || sl + kk > 0);
    }
  }
}

__device__ __forceinline__ void qk16_issue_f32(float (&s)[8], uint32_t q,
                                               uint32_t k) {
  qk16_issue<false>(s, q + 64 * 256 * 2, k);
  qk16_issue<true>(s, q, k + 16 * 256 * 2);
  qk16_issue<true>(s, q, k);
}

template <int D, bool SEG, bool F32>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_q_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const DqArgs a, const F32Src f) {
  using L = Layout<D, SEG, F32>;
  constexpr int NST = L::NST;
  constexpr int KN = L::KN;
  constexpr int SLABS = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::bar_off;  // + 8 * stage
  const uint32_t empty = full + 8 * NST;    // + 8 * stage
  const uint32_t q_bar = empty + 8 * NST;

  int qt, hg, b;
  cta_tile(a, qt, hg, b);
  const int q0 = qt * a.R;
  const int h0 = hg * a.Gp;
  const int hk = h0 / a.G;
  const int q_hi = min(q0 + a.R, a.Nq) - 1;
  int t_begin, t_end;
  key_tiles<KN>(a, q0, q_hi, t_begin, t_end);
  const int n = t_end - t_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      // the TMA issue, and with SEG the 32 lanes of the id loads; under
      // F32 the producer warpgroup's 128 threads
      mbar_init(full + 8 * s, F32 ? 128 : SEG ? 33 : 1);
      mbar_init(empty + 8 * s, 4 * L::NWG);  // lane 0 of each consumer warp
    }
    mbar_init(q_bar, F32 ? 128 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if (F32 && wg == 2) {
    // the producer of the F32 build: its 128 threads read Q and dO, then
    // each key tile's K and V, from device memory and write their hi and
    // lo tiles (split_rows), and the tile's key ids (SEG)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (n <= 0) return;
    const int pt = threadIdx.x - 2 * 128;
    const long long* fs = f.st;
    split_rows<D, 128>(smem, smem + L::QT, L::ROWS, f.p[0] + b * fs[0],
                       fs[1], fs[2], h0, a.Gp, a.R, q0, a.Nq, pt);
    split_rows<D, 128>(smem + L::do_off, smem + L::do_off + L::QT, L::ROWS,
                       f.p[3] + b * fs[9], fs[10], fs[11], h0, a.Gp, a.R, q0,
                       a.Nq, pt);
    fence_proxy_async();
    mbar_arrive(q_bar);
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int st = i % NST;
      mbar_wait(empty + 8 * st, ((i / NST) & 1) ^ 1);
      uint8_t* stage = smem + L::st_off + st * L::stage;
      split_rows<D, 128>(stage, stage + L::KV, KN, f.p[1] + b * fs[3], fs[4],
                         fs[5], hk, 1, KN, t * KN, a.Nk, pt);
      split_rows<D, 128>(stage + L::v_off, stage + L::v_off + L::KV, KN,
                         f.p[2] + b * fs[6], fs[7], fs[8], hk, 1, KN, t * KN,
                         a.Nk, pt);
      if (SEG) {
        int* ids = reinterpret_cast<int*>(stage + L::ids);
        for (int c = pt; c < KN; c += 128) {
          const int key = t * KN + c;
          ids[c] = key < a.Nk ? a.kv_seg[(long long)b * a.Nk + key] : -2;
        }
      }
      fence_proxy_async();
      mbar_arrive(full + 8 * st);
    }
    return;
  }
  if (wg == 2) {
    // the producer: one thread issues every load; with SEG its warp also
    // brings each tile's key segment ids beside the TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x >= 2 * 128 + (SEG ? 32 : 1) || n <= 0) return;
    if (lane == 0) {
      mbar_expect_tx(q_bar, 2 * a.Gp * a.R * D * 2);
      for (int sl = 0; sl < SLABS; ++sl) {
        tma_load_4d(base + sl * BM * 128, &tm_q, q_bar, sl * 64, q0, h0, b);
        tma_load_4d(base + L::do_off + sl * BM * 128, &tm_do, q_bar, sl * 64,
                    q0, h0, b);
      }
    }
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int st = i % NST;
      mbar_wait(empty + 8 * st, ((i / NST) & 1) ^ 1);
      const uint32_t dst = base + L::st_off + st * L::stage;
      if (lane == 0) {
        mbar_expect_tx(full + 8 * st, 2 * L::KV);
        for (int sl = 0; sl < SLABS; ++sl) {
          tma_load_4d(dst + sl * KN * 128, &tm_k, full + 8 * st, sl * 64,
                      t * KN, hk, b);
          tma_load_4d(dst + L::KV + sl * KN * 128, &tm_v, full + 8 * st,
                      sl * 64, t * KN, hk, b);
        }
      }
      if (SEG) {
        int* ids = reinterpret_cast<int*>(smem + L::st_off + st * L::stage +
                                          L::ids);
        for (int c = lane; c < KN; c += 32) {
          const int key = t * KN + c;
          ids[c] = key < a.Nk ? a.kv_seg[(long long)b * a.Nk + key] : -2;
        }
        mbar_arrive(full + 8 * st);
      }
    }
    return;
  }

  // two consumer warpgroups, 64 query rows each (one under W1)
  if (wg >= L::NWG) return;
  if (F32) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  }
  // the thread's two rows (wgmma's accumulator layout) as (head, position):
  // their LSE in log2 units (+inf past the tile or Nq, or on a row that saw
  // no key, so that its P is 0), D, causal position and segment id
  float lse2[2], dl[2];
  int qp[2], qseg[2], pos[2], head[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2) +
                    8 * hr;
    const int g = row / a.R;
    const int p = q0 + row - g * a.R;
    const bool ok = g < a.Gp && p < a.Nq;
    pos[hr] = ok ? p : -1;
    head[hr] = h0 + (ok ? g : 0);
    qp[hr] = p + a.kv_offset;
    const long long r = (long long)(b * a.H + head[hr]) * a.Nq + p;
    const float l = ok ? a.lse[r] : kNegInf;
    lse2[hr] = l < kNegInf * 0.5f ? INFINITY : l * (float)kLog2e;
    dl[hr] = ok ? a.delta[r] : 0.f;
    qseg[hr] = SEG && ok ? a.q_seg[(long long)b * a.Nq + p] : -1;
  }
  // this warpgroup's positions, for the unmasked-step test
  const int w_lo = a.R == L::ROWS ? q0 + 64 * wg : q0;
  const int w_hi = min(w_lo + min(a.R, 64), a.Nq) - 1;

  float dq[SLABS][32];
#pragma unroll
  for (int sl = 0; sl < SLABS; ++sl) {
#pragma unroll
    for (int j = 0; j < 32; ++j) dq[sl][j] = 0.f;
  }
  if (n > 0) {
    constexpr int NS = KN / 2;  // a thread's scores of a tile: 32, F32 16
    const uint32_t q_tile = base;
    const uint32_t do_tile = base + L::do_off;
    // dS as bf16 pairs: the A operand of dQ's product (F32: dS = dsk +
    // dsk_lo)
    uint32_t dsk[NS / 2], dsk_lo[NS / 2];
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) dsk[j] = dsk_lo[j] = 0;
    mbar_wait(q_bar, 0);
    uint32_t k_tile = 0;
    for (int i = 0; i < n; ++i) {
      const int st = i % NST;
      const int c0 = (t_begin + i) * KN;
      mbar_wait(full + 8 * st, (i / NST) & 1);
      k_tile = base + L::st_off + st * L::stage;
      const uint32_t v_tile = k_tile + L::v_off;

      // S = Q·Kᵀ, then dP = dO·Vᵀ, behind the previous tile's dQ product;
      // P while dP is on the tensor cores
      float s_acc[NS], dp_acc[NS];
      wgmma_fence();
      if constexpr (L::W1) {
        qk16_issue_f32(s_acc, q_tile, k_tile);
        wgmma_commit();
        qk16_issue_f32(dp_acc, do_tile, v_tile);
      } else if constexpr (F32) {
        qk32_issue_f32<D>(s_acc, q_tile, k_tile, wg);
        wgmma_commit();
        qk32_issue_f32<D>(dp_acc, do_tile, v_tile, wg);
      } else if constexpr (L::K32) {
        qk32_issue<D, false>(s_acc, q_tile, k_tile, wg);
        wgmma_commit();
        qk32_issue<D, false>(dp_acc, do_tile, v_tile, wg);
      } else {
        cfa_bound::qk_issue<D>(s_acc, q_tile, k_tile, wg);
        wgmma_commit();
        cfa_bound::qk_issue<D>(dp_acc, do_tile, v_tile, wg);
      }
      wgmma_commit();
      wgmma_wait_one();
      // the previous tile's dQ product has landed: its dS registers and
      // its stage are free
      fence_regs(dsk);
      if (F32) fence_regs(dsk_lo);
      if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % NST));
      float p[NS];
      copy_after_wait(p, s_acc);
      if (!SEG && interior<KN>(a, c0, w_lo, w_hi)) {
        probs<false, false>(a, p, lse2, qp, nullptr, qseg, c0);
      } else {
        const int* kseg = SEG ? reinterpret_cast<const int*>(
                                    smem + L::st_off + st * L::stage + L::ids)
                              : nullptr;
        probs<true, SEG>(a, p, lse2, qp, kseg, qseg, c0);
      }
      wgmma_wait_all();
      float dp[NS];
      copy_after_wait(dp, dp_acc);

      // dS = P ⊙ (dP − D)·scale, rounded to the element type in wgmma's A
      // layout (F32: split, dS = dsk + dsk_lo, first rounded by f.round[1])
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        const int hr = (j >> 1) & 1;
        const float ds0 = p[j] * (dp[j] - dl[hr]) * a.scale;
        const float ds1 = p[j + 1] * (dp[j + 1] - dl[hr]) * a.scale;
        if (F32) {
          split2r(ds0, ds1, f.round[1], dsk[j >> 1], dsk_lo[j >> 1]);
        } else {
          dsk[j >> 1] = pack2(ds0, ds1);
        }
      }
      // dQ += dS·K, left in flight under the next tile's S and dP
      wgmma_fence();
      if constexpr (F32) {
        cfa_bound::pv_issue_f32<D, false, KN>(dq, dsk, dsk_lo, k_tile);
      } else if constexpr (L::K32) {
        cfa_bound::pv_issue<D, KN>(dq, dsk, k_tile);
      } else {
        cfa_bound::pv_issue<D>(dq, dsk, k_tile);
      }
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(dsk);
    if (F32) fence_regs(dsk_lo);
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) fence_regs(dq[sl]);
    if (lane == 0) mbar_arrive(empty + 8 * ((n - 1) % NST));
  }

  // dQ cast once (F32: stored fp32); rows past Nq are skipped, a tile
  // that saw no key writes its zeros
#pragma unroll
  for (int sl = 0; sl < SLABS; ++sl) {
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int hr = (j >> 1) & 1;
      if (pos[hr] < 0) continue;
      const int col = sl * 64 + 8 * (j >> 2) + 2 * (lane & 3);
      const long long row = (long long)(b * a.H + head[hr]) * a.Nq + pos[hr];
      if (F32) {
        *reinterpret_cast<float2*>(static_cast<float*>(a.dq) + row * D +
                                   col) = make_float2(dq[sl][j], dq[sl][j + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<elem*>(a.dq) + row * D +
                                     col) = pack2(dq[sl][j], dq[sl][j + 1]);
      }
    }
  }
}

template <int D, bool SEG, bool F32>
cudaError_t launch(const CUtensorMap (&m)[4], const DqArgs& a,
                   const F32Src& f, int B, cudaStream_t stream) {
  const int smem = Layout<D, SEG, F32>::bytes;
  auto kernel = flash_bwd_q_kernel<D, SEG, F32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + a.R - 1) / a.R, a.H / a.Gp, B);  // R: ROWS / Gp
  kernel<<<grid, NTHREADS, smem, stream>>>(m[0], m[1], m[2], m[3], a, f);
  return cudaGetLastError();
}

template <int D, bool F32>
cudaError_t launch_form(const CUtensorMap (&m)[4], const DqArgs& a,
                        const F32Src& f, int B, cudaStream_t stream) {
  return a.q_seg != nullptr ? launch<D, true, F32>(m, a, f, B, stream)
                            : launch<D, false, F32>(m, a, f, B, stream);
}

// The 2-byte build, or (the bf16 unit only) the fp32 one.
template <int D>
cudaError_t launch_type(const CUtensorMap (&m)[4], const DqArgs& a,
                        const F32Src& f, int f32, int B, cudaStream_t stream) {
  if constexpr (!kHalf) {
    if (f32) return launch_form<D, true>(m, a, f, B, stream);
  }
  return launch_form<D, false>(m, a, f, B, stream);
}

}  // namespace

// K3. f32: q, k, v, dO and dq fp32 (the F32 build), else bf16 (fp16 in
// the fp16 unit, cfa_flash_bwd_q_f16, which takes f32 = 0 only); f32 = 1 +
// 3·r_ds rounds dS before dQ = dS·K by round_to's code r_ds (a mixed-type
// call's upcast operands: dS to k's type; K2 / K4's packing of the codes,
// whose P code K3 ignores). strides: q,
// k, v, dO, each (batch, head, row), in elements, every one a multiple of
// 16 bytes' elements and the bases 16-byte aligned (TMA; fp32 rows are
// read as float4). q_seg [B, Nq] and kv_seg [B, Nk] are int32 segment ids,
// or both null. dq [B,H,Nq,D] contiguous; lse, delta [B,H,Nq] contiguous
// fp32.
extern "C" int cfa_flash_bwd_q(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* q_seg,
                               const void* kv_seg, void* dq, int B, int H,
                               int Hkv, int Nq, int Nk, int D,
                               const long long* strides, double scale,
                               int causal, int window, int kv_offset, int f32,
                               void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (kv_seg == nullptr)) return cudaErrorInvalidValue;
  if (f32 < 0 || f32 > 9 || (kHalf && f32)) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Nq == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Nk == 0) {
    // no key: dQ is zeros (and K/V's maps would have no memory)
    return cudaMemsetAsync(
        dq, 0, (size_t)B * H * Nq * D * (f32 ? sizeof(float) : sizeof(bf16)),
        st);
  }
  DqArgs a = {};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.q_seg = static_cast<const int*>(q_seg);
  a.kv_seg = static_cast<const int*>(kv_seg);
  a.dq = dq;
  a.H = H; a.Nq = Nq; a.Nk = Nk;
  a.G = H / Hkv;
  a.Gp = cfa_bound::packed_heads(a.G);
  a.R = (f32 && D == 256 ? 64 : BM) / a.Gp;  // Layout::ROWS / Gp
  a.scale_log2e = (float)(scale * kLog2e);
  a.scale = (float)scale;
  a.causal = causal;
  a.window = causal ? window : 0;
  a.kv_offset = kv_offset;
  // Q and dO [B,H,Nq,D] in boxes of 64 columns x R positions x Gp heads, K
  // and V [B,Hkv,Nk,D] in boxes of 64 columns x 64 keys (32 at d = 256),
  // 128 B swizzled, zeros past the live rows
  // (the fp32 build reads them through F32Src instead)
  cfa_bound::Maps mp = {};
  CUtensorMap m[4] = {};
  F32Src f = {};
  const long long* sd = strides + 9;
  if (f32) {
    f.round[1] = (f32 - 1) / 3;
    const void* ptr[4] = {q, k, v, dout};
    for (int t = 0; t < 4; ++t) {
      f.p[t] = static_cast<const float*>(ptr[t]);
      for (int j = 0; j < 3; ++j) f.st[3 * t + j] = strides[3 * t + j];
    }
  } else if (!cfa_bound::make_maps(&mp, q, k, v, B, H, Hkv, Nq, Nk, D,
                                   strides, kBf16, kBf16, 0, a.Gp, a.R,
                                   D == 256 ? 32 : BN) ||
             !cfa_bound::encode4(&m[3], dout, false, D, Nq, H, B, sd[2] * 2,
                                 sd[1] * 2, sd[0] * 2, 64, a.R, a.Gp, 128)) {
    return cudaErrorInvalidValue;
  }
  m[0] = mp.q;
  m[1] = mp.k;
  m[2] = mp.v;
  switch (D) {
    case 64:
      return launch_type<64>(m, a, f, f32, B, st);
    case 128:
      return launch_type<128>(m, a, f, f32, B, st);
    case 256:
      return launch_type<256>(m, a, f, f32, B, st);
    default:
      return cudaErrorInvalidValue;
  }
}
