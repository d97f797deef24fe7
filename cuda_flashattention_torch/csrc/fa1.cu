// FlashAttention-1 forward for Hopper, bf16 in and out, or fp32 in and out
// (the F32 build): the ladder rung whose O is renormalised after every
// K/V block instead of once at the end. Forward only, O only, no GQA.
//
// Replaces: cuda_flashattention_tpu/ops/fa1.py::_fa1_kernel.
//
// What bounds it on the H100: operations, as the FA2 forward — 4·N²·d
// operations of products over 4·N·d bytes per head — and how well the
// softmax and the per-block renormalisation hide under them. It is kept
// for what it computes, not for its speed.
//
// What this design does about it: the Q-major walk of the forward's
// Hopper body (flash_fwd_bound_sm90.cuh): a CTA owns 128 query rows of one
// head (two consumer warpgroups of 64 rows, wgmma with S, P and O in
// registers), and a producer thread streams K and V through a ring of TMA
// stages. The TPU kernel holds a head's whole K and V in VMEM; here a
// renormalising block is `n_sub` 64-key tiles (block_k = 64·n_sub ≤ 256
// keys), and FA1 needs the block's row max over all its columns before any
// of its P. A block's S is 64 x 256 fp32 per warpgroup at block_k = 256:
// 128 registers a thread beside O's 64 and P's 16, over the 232 the
// consumers have once addresses and row state are counted. So the block is
// walked twice: a first pass of Q·Kᵀ over its K tiles keeps only the row
// max, a second recomputes each tile's S (the same wgmma on the same
// tiles gives the same bits), forms P and runs P·V. That is 1.5x the
// products, but the registers are those of the FA2 walk (no spills) and the
// ring needs no room for a whole block: a first-pass stage carries K alone,
// a second-pass stage K and V. A causal walk stops at the CTA's last
// visible key, and its Q tiles are issued heaviest first (cta_tile).
//
// Numerics follow the TPU kernel: Q arrives pre-scaled by `scale` (rounded
// in bf16 by the host), s = q·k in fp32 is brought into log2 units
// (s·log2 e, fp32) for exp2, masked pairs (causal, ragged tail) have p = 0,
// P is rounded to bf16 before P·V, and per block, with m the running max,
// l the running sum and o the normalised output of the blocks before:
//   o = (l_prev · α · o_prev + P·V) / max(l_new, 1e-30),
//   α = 2^(m_prev − m_new),  l_new = l_prev · α + Σ p.
// The F32 build (the reference's own precision: fp32 Q, K, V and O) keeps
// the walk and the renormalisation in fp32 registers; the producer
// warpgroup's 128 threads read each Q, K and V tile from device memory and
// write it as bf16 hi and lo tiles (split_rows), each product is three
// bf16 wgmmas (lo·hi + hi·lo + hi·hi), and P is split in registers, not
// rounded (the TPU kernel's p.astype(v.dtype) is fp32 there). Split tiles
// take twice the shared memory: two stages at d = 128.
//
// At d = 256 O takes 128 registers a consumer thread and a tile 64 KB a
// bf16 K + V stage: the bf16 build keeps two stages beside its 64 KB Q
// tile (three would need 256 KB). The F32 build's split Q tile is 128 KB
// and a 64-key split K + V stage another 128 KB, which does not fit: it
// walks 32-key tiles (BN32, two to each 64-key tile of a block, a split
// stage of 64 KB) through one stage.

#include "flash_fwd_bound_sm90.cuh"

using namespace cfa_bound;

namespace {

constexpr int MAX_SUB = 4;  // 64-key tiles per renormalising block, at most
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one CTA (byte offsets from a 1024-aligned base): the Q
// tile; NST stages of a K tile and a V tile (bf16 slabs, of KN keys);
// barriers. Under F32 each tile is a hi tile and a lo tile (lo right after
// hi).
template <int D, bool F32>
struct Layout {
  using T = Tiles<D, false>;
  static constexpr int KN = key_tile(D, F32, F32 ? kF32 : kBf16);
  static constexpr int PL = F32 ? 2 : 1;   // planes of a tile: hi (and lo)
  static constexpr int NST = D == 256 ? (F32 ? 1 : 2)
                             : F32 && D == 128 ? 2 : 3;  // K/V stages
  static constexpr int kv16 = KN * D * 2;  // a bf16 K or V tile
  static constexpr int st_off = align1k(PL * T::Q);
  static constexpr int v_off = PL * kv16;     // V within a stage
  static constexpr int stage = 2 * PL * kv16;  // K, then V
  static constexpr int bar_off = st_off + NST * stage;
  static constexpr int bytes = bar_off + 8 * (2 * NST + 1) + 1024;
  static_assert(bytes <= 232448, "the CTA's shared memory");
};

// The thread's KN / 2 scores of a tile in log2 units, NEG_INF where
// masked, and each row's max over them folded into mx.
template <bool MASKED, int KN>
__device__ __forceinline__ void scores(const Args& a, const Rows& r,
                                       float (&s)[KN / 2], int c0,
                                       float (&mx)[2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < KN / 2; ++j) {
    const int col = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
    const int hr = (j >> 1) & 1;
    float x = s[j] * kLog2e;
    if (MASKED) {
      const int cg = c0 + col;
      const bool ok = cg < a.Nk && (!a.causal || cg <= r.qp[hr]);
      x = ok ? x : kNegInf;
    }
    s[j] = x;
    mx[hr] = fmaxf(mx[hr], x);
  }
}

// p = 2^(s − m) (0 where masked) into P, 2-byte pairs (F32: split, P = p +
// p_lo, p first rounded by p_round, round_to's code); each row's sum of the
// unrounded p added to sum.
template <bool F32, int KN>
__device__ __forceinline__ void probs(const float (&s)[KN / 2],
                                      const float (&m)[2], float (&sum)[2],
                                      uint32_t (&p)[KN / 4],
                                      uint32_t (&p_lo)[KN / 4],
                                      int p_round) {
#pragma unroll
  for (int i = 0; i < KN / 2; i += 2) {
    float pr[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int hr = ((i + e) >> 1) & 1;
      const float x = s[i + e];
      pr[e] = x > kNegInf * 0.5f ? exp2f(x - m[hr]) : 0.f;
      sum[hr] += pr[e];
    }
    if (F32) {
      split2r(pr[0], pr[1], p_round, p[i >> 1], p_lo[i >> 1]);
    } else {
      p[i >> 1] = pack2(pr[0], pr[1]);
    }
  }
}

template <int D, bool F32>
__global__ void __launch_bounds__(NTHREADS, 1)
    fa1_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const Args a,
               int n_sub, const F32Src f) {
  using T = Tiles<D, false>;
  using L = Layout<D, F32>;
  constexpr int NST = L::NST;
  constexpr int KN = L::KN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::bar_off;  // + 8 * stage
  const uint32_t empty = full + 8 * NST;    // + 8 * stage
  const uint32_t q_bar = empty + 8 * NST;

  int qt, h, b;
  cta_tile(a, qt, h, b);
  const int q0 = qt * BM;
  const int q_hi = min(q0 + BM, a.Nq) - 1;
  int t_begin, t_end;
  visible_tiles<KN>(a, q0, q_hi, 0, (a.Nk + KN - 1) / KN, t_begin, t_end);
  // a block's tiles: n_sub 64-key tiles, each BN / KN tiles of KN keys
  const int per_block = n_sub * (BN / KN);
  const int n_blocks = (t_end + per_block - 1) / per_block;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      // the TMA issue, or under F32 the producer warpgroup's 128 threads
      mbar_init(full + 8 * s, F32 ? 128 : 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    mbar_init(q_bar, F32 ? 128 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // the producer: per block, its K tiles for the first pass, then its K
    // and V tiles for the second
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (F32) {
      // fp32 Q/K/V: the warpgroup's 128 threads split each tile into its
      // hi and lo tiles (split_rows)
      const int pt = threadIdx.x - 2 * 128;
      const long long* st = f.st;
      split_rows<D, 128>(smem, smem + T::Q, BM, f.p[0] + b * st[0] +
                         h * st[1], 0, st[2], 0, 1, BM, q0, a.Nq, pt);
      fence_proxy_async();
      mbar_arrive(q_bar);
      int i = 0;
      for (int blk = 0; blk < n_blocks; ++blk) {
        const int t_last = min(t_end, (blk + 1) * per_block);
        for (int pass = 0; pass < 2; ++pass) {
          for (int t = blk * per_block; t < t_last; ++t, ++i) {
            const int s = i % NST;
            mbar_wait(empty + 8 * s, ((i / NST) & 1) ^ 1);
            uint8_t* stage = smem + L::st_off + s * L::stage;
            split_rows<D, 128>(stage, stage + L::kv16, KN,
                               f.p[1] + b * st[3] + h * st[4], 0, st[5], 0,
                               1, KN, t * KN, a.Nk, pt);
            if (pass == 1) {
              split_rows<D, 128>(stage + L::v_off,
                                 stage + L::v_off + L::kv16, KN,
                                 f.p[2] + b * st[6] + h * st[7], 0, st[8], 0,
                                 1, KN, t * KN, a.Nk, pt);
            }
            fence_proxy_async();
            mbar_arrive(full + 8 * s);
          }
        }
      }
    } else if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_bar, BM * D * 2);
      for (int sl = 0; sl < T::SLABS; ++sl) {
        tma_load_4d(base + sl * BM * 128, &tm_q, q_bar, sl * 64, q0, h, b);
      }
      int i = 0;
      for (int blk = 0; blk < n_blocks; ++blk) {
        const int t_last = min(t_end, (blk + 1) * per_block);
        for (int pass = 0; pass < 2; ++pass) {
          for (int t = blk * per_block; t < t_last; ++t, ++i) {
            const int st = i % NST;
            mbar_wait(empty + 8 * st, ((i / NST) & 1) ^ 1);
            const uint32_t dst = base + L::st_off + st * L::stage;
            mbar_expect_tx(full + 8 * st, (pass + 1) * T::KV16);
            for (int sl = 0; sl < T::SLABS; ++sl) {
              tma_load_4d(dst + sl * BN * 128, &tm_k, full + 8 * st, sl * 64,
                          t * BN, h, b);
              if (pass == 1) {
                tma_load_4d(dst + T::KV16 + sl * BN * 128, &tm_v,
                            full + 8 * st, sl * 64, t * BN, h, b);
              }
            }
          }
        }
      }
    }
  } else {
    // two consumer warpgroups, 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const Rows r = row_info<false>(a, b, h, q0, tid);
    float acc[D / 64][32];
#pragma unroll
    for (int sl = 0; sl < D / 64; ++sl) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[sl][i] = 0.f;
    }
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    mbar_wait(q_bar, 0);
    int i = 0;
    for (int blk = 0; blk < n_blocks; ++blk) {
      const int t_last = min(t_end, (blk + 1) * per_block);
      // first pass: the block's row max
      float mx[2] = {kNegInf, kNegInf};
      for (int t = blk * per_block; t < t_last; ++t, ++i) {
        const int st = i % NST;
        mbar_wait(full + 8 * st, (i / NST) & 1);
        float s[KN / 2];
        qk<D, false, F32, false, KN>(s, base, base + L::st_off + st * L::stage,
                                     wg);
        if (lane == 0) mbar_arrive(empty + 8 * st);
        if (interior<KN>(a, t * KN, q0, q_hi)) {
          scores<false, KN>(a, r, s, t * KN, mx);
        } else {
          scores<true, KN>(a, r, s, t * KN, mx);
        }
      }
      float m_new[2], back[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        m_new[hr] = fmaxf(m[hr], mx[hr]);
        // o_prev is normalised: weight it back by l_prev · α
        back[hr] = l[hr] * exp2f(m[hr] - m_new[hr]);
      }
      scale_acc<D>(acc, back);
      // second pass: P against the block's max, P·V
      float sum[2] = {0.f, 0.f};
      for (int t = blk * per_block; t < t_last; ++t, ++i) {
        const int st = i % NST;
        mbar_wait(full + 8 * st, (i / NST) & 1);
        const uint32_t kt = base + L::st_off + st * L::stage;
        float s[KN / 2];
        qk<D, false, F32, false, KN>(s, base, kt, wg);
        float unused[2] = {kNegInf, kNegInf};
        if (interior<KN>(a, t * KN, q0, q_hi)) {
          scores<false, KN>(a, r, s, t * KN, unused);
        } else {
          scores<true, KN>(a, r, s, t * KN, unused);
        }
        uint32_t p[KN / 4], p_lo[KN / 4];  // under F32 P = p + p_lo
        probs<F32, KN>(s, m_new, sum, p, p_lo, f.round[0]);
        pv<D, F32, false, KN>(acc, p, kt + L::v_off, p_lo);
        if (lane == 0) mbar_arrive(empty + 8 * st);
      }
      // the FA1 step: O is divided by the new l after every block
      float inv[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
        sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
        l[hr] = back[hr] + sum[hr];
        m[hr] = m_new[hr];
        inv[hr] = 1.f / fmaxf(l[hr], 1e-30f);
      }
      scale_acc<D>(acc, inv);
    }
    // O in the element type (F32: fp32); rows past Nq are not written
#pragma unroll
    for (int sl = 0; sl < D / 64; ++sl) {
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int hr = (j >> 1) & 1;
        if (r.pos[hr] < 0) continue;
        const int col = sl * 64 + 8 * (j >> 2) + 2 * (lane & 3);
        const long long row = (long long)(b * a.H + h) * a.Nq + r.pos[hr];
        if (F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(a.o) + row * D +
                                     col) = make_float2(acc[sl][j],
                                                        acc[sl][j + 1]);
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<elem*>(a.o) + row * D +
                                       col) =
              pack2(acc[sl][j], acc[sl][j + 1]);
        }
      }
    }
  }
}

template <int D, bool F32>
cudaError_t launch(const Maps& mp, const Args& a, int B, int n_sub,
                   const F32Src& f, cudaStream_t stream) {
  const int smem = Layout<D, F32>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fa1_kernel<D, F32>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + BM - 1) / BM, a.H, B);
  fa1_kernel<D, F32><<<grid, NTHREADS, smem, stream>>>(mp.q, mp.k, mp.v, a,
                                                       n_sub, f);
  return cudaGetLastError();
}

// The 2-byte build, or (the bf16 unit only) the fp32 one.
template <int D>
cudaError_t launch_type(const Maps& mp, const Args& a, int B, int n_sub,
                        const F32Src& f, int f32, cudaStream_t stream) {
  if constexpr (!kHalf) {
    if (f32) return launch<D, true>(mp, a, B, n_sub, f, stream);
  }
  return launch<D, false>(mp, a, B, n_sub, f, stream);
}

}  // namespace

// q/k/v [B, H, N, D] bf16 (fp16 in the fp16 unit, cfa_fa1_f16; fp32 under
// f32, 2 / 3 with P rounded to bf16 / fp16 before P·V: a mixed-type call
// upcast, JAX's P in v's type) with unit stride on D and
// 16-byte aligned rows; `strides` holds the (batch, head, row) strides of
// q, k and v in elements; o [B, H, Nq, D] contiguous, bf16 (fp32 under
// f32). A renormalising block is n_sub (1..4) tiles of 64 keys. D: 64,
// 128 or 256.
extern "C" int cfa_fa1(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int Nq, int Nk, int D,
                       const long long* strides, int causal, int n_sub,
                       int f32, void* stream) {
  if (B == 0 || H == 0 || Nq == 0) return cudaSuccess;
  if (n_sub < 1 || n_sub > MAX_SUB) return cudaErrorInvalidValue;
  if (f32 < 0 || f32 > 3 || (kHalf && f32)) return cudaErrorInvalidValue;
  Args a = {};
  a.o = o;
  a.H = H; a.Hkv = H; a.Nq = Nq; a.Nk = Nk;
  a.G = 1; a.Gp = 1; a.R = BM;
  a.causal = causal;
  // the fp32 build reads its operands through F32Src, not through TMA
  Maps mp = {};
  F32Src fs = {};
  if (f32) {
    void* const ptrs[3] = {const_cast<void*>(q), const_cast<void*>(k),
                           const_cast<void*>(v)};
    fs = f32_src(ptrs, strides, f32);
  } else if (!make_maps(&mp, q, k, v, B, H, H, Nq, Nk, D, strides, kBf16,
                        kBf16, 0, 1, BM)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_type<64>(mp, a, B, n_sub, fs, f32, s);
    case 128:
      return launch_type<128>(mp, a, B, n_sub, fs, f32, s);
    case 256:
      return launch_type<256>(mp, a, B, n_sub, fs, f32, s);
    default:
      return cudaErrorInvalidValue;
  }
}
