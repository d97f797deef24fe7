// FlashAttention-2 forward with the online softmax on a Q-major walk (K1),
// for Hopper: bf16 Q, K/V in bf16, int8 or fp8 e4m3 with per-token scales,
// or an fp32 Q over fp32, bf16 or those one-byte K/V (the F32 builds: fp32
// tiles split into bf16 hi and lo, flash_fwd_bound_sm90.cuh), fp32, bf16
// or fp16 out, with the natural-log LSE per query row.
//
// Replaces: cuda_flashattention_tpu/ops/flash_fwd.py::_fwd_kernel with
// bound=False, with the causal band of its compact grid, its window and
// segment masks and its folded dequantisation. Its bound=True form (K1b)
// is flash_fwd_bound.cu; both run on flash_fwd_bound_sm90.cuh.
//
// What bounds it on the H100: at the prefill and training shapes (N =
// 512..4096, d = 128) the two products are ~4·N²·d operations against
// 4·N·d bytes per head, far above the card's ~295 operations per byte, so
// it is bound by the tensor cores, and in practice by how well the softmax
// between the two products (here with a running max and a rescale of the
// accumulator) hides under them. Quantized K/V halves the bytes and leaves
// the operations as they were, plus one conversion per key tile.
//
// What this design does about it (flash_fwd_bound_sm90.cuh): the walk of
// K1b with the online step in place of the bound step. A CTA owns a
// 128-row tile of packed query heads (two consumer warpgroups of 64 rows,
// all Gp heads of one KV head when the group allows) and walks the key
// tiles its rows can see, from the window's frontier to the causal one. A
// producer thread keeps the next key tiles' TMA loads in flight in a ring
// of 3 stages (its warp brings one-byte K/V's scales and a tile's segment
// ids in beside them) while the consumers run wgmma; S, P, m, l and O
// never leave registers. Each warpgroup issues a tile's Q·Kᵀ and then the
// previous tile's P·V, and runs the tile's softmax while the P·V is on the
// tensor cores; the rescale of O waits for it. One-byte K/V tiles are
// converted once per CTA and key tile, for all Gp heads. Interior tiles
// skip the element mask; a call with segment ids is a build of its own
// (SEG), and its tiles always take the masked step. Under causal the Q
// tiles are issued heaviest first (cta_tile).
//
// The 128-key build (KN = BN2, bf16 Q and K/V, every mask; `block_k` =
// 128 on the host selects it) walks key tiles of 128: one m64n128 wgmma a
// step for S, half the steps, barriers and softmax passes of the 64-key
// walk. Its S (64 registers a thread) leaves no room for the overlap of
// one tile's P·V under the next tile's softmax, which keeps a second S and
// P live, so its steps run in order: S, the softmax, P·V. At d = 128 a K+V
// stage is 64 KB: two stages beside the 32 KB Q tile.
//
// At d = 256 O alone takes 128 registers a consumer thread, so the walk
// runs in the same order, without the overlap. A bf16 Q's 64 KB tile
// leaves room for two stages and, over one-byte K/V, one converted pair,
// which both warpgroups finish reading before it is overwritten. An fp32
// Q's split tile (128 KB) leaves room for one stage: a bf16 K + V stage
// (BF16KV), or a code stage and one converted pair (231,192 of the
// 232,448 bytes with segment ids), or, over fp32 K/V, one stage of 32-key
// tiles (BN32: hi and lo of K and V, 64 KB, where a 64-key split pair
// would take 128 KB). The
// alternatives were a 64-row Q tile, which halves what each K/V tile
// serves and leaves the two warpgroups one 64-row tile to share (each
// recomputing S, or exchanging it through shared memory), or 32-key tiles
// for every fp32 form; one stage keeps the CTA, its rows and the host's
// plan as they are at d <= 128, at the price of the producer's loads (or
// its split of fp32 K/V) no longer running ahead of the consumers.
//
// The kernel can be launched behind a device-side guard: it then exits
// before anything else unless the bound form before it counted a loose
// row, which is how the loose-bound fallback runs without a host round
// trip. The guard and the segment ids are parameters of this kernel
// beside the body's Args, which holds what the four forms share.

#include "flash_fwd_bound_sm90.cuh"

using namespace cfa_bound;

namespace {

// Shared memory of one CTA (byte offsets from a 1024-aligned base): the Q
// tile (under F32 its hi and lo tiles); NST stages of K and V as TMA
// writes them (bf16 slabs, or one-byte codes; under F32 over fp32 K/V the
// producer warpgroup's hi and lo tiles of each), each followed by the
// tile's K and V scales (QUANT) and key segment ids (SEG); under QUANT NCV
// converted K/V pairs (exact bf16, so one tile each under F32 too);
// barriers. Split K/V tiles take twice the bytes: at d = 128 two stages
// fit, else three (an fp32 Q over codes: 212 KB at d = 128); so do the
// 128-key build's bf16 tiles (KN keys a tile). An fp32 Q over bf16 K/V
// (BF16KV) keeps three bf16 stages beside its split Q: 161 KB at d = 128.
// At d = 256 a bf16 Q (the 64 KB Q tile) keeps two stages and one
// converted pair: 192 KB over bf16 K/V, 195 KB over one-byte codes; an
// fp32 Q (128 KB split) one stage (of BN32 keys over fp32 K/V). The
// converted pairs come before the stages and the barriers right after the
// last stage's bytes: the fp32 Q over codes with segment ids fits by 1 KB.
template <int D, bool QUANT, bool SEG, bool F32, int KN, bool BF16KV>
struct Layout {
  using T = Tiles<D, false>;
  static constexpr bool SPLIT_KV = F32 && !QUANT && !BF16KV;  // fp32 K/V
  static_assert(KN != BN2 || (!QUANT && !F32 && D != 256),
                "128 keys: bf16 K/V at d <= 128 only");
  static_assert((KN == BN32) == (D == 256 && SPLIT_KV),
                "32 keys: fp32 K/V at d = 256 (and there only)");
  static_assert(!BF16KV || (F32 && !QUANT), "BF16KV: an fp32 Q");
  static constexpr int NST = D == 256 ? (F32 ? 1 : 2)
                             : SPLIT_KV || KN == BN2 ? (D == 128 ? 2 : 3)
                                                     : 3;  // stages
  // converted K/V pairs (one-byte K/V), used in turn
  static constexpr int NCV = D == 256 ? 1 : 3;
  static constexpr int kv16 = KN * D * 2;             // a bf16 K or V tile
  static constexpr int kvh =                          // K, then V
      QUANT ? T::CODES : SPLIT_KV ? 2 * kv16 : kv16;
  static constexpr int tma_bytes = 2 * kvh;
  static constexpr int ids = tma_bytes + (QUANT ? 2 * BN * 4 : 0);
  static constexpr int used = ids + (SEG ? KN * 4 : 0);  // bytes of a stage
  static constexpr int stage = align1k(used);
  static constexpr int cv_off = align1k(F32 ? 2 * T::Q : T::Q);
  static constexpr int cv_v = align1k(T::KV16);        // V in a converted pair
  static constexpr int cv_stride = align1k(cv_v + T::KV16);
  static constexpr int st_off = cv_off + (QUANT ? NCV * cv_stride : 0);
  static constexpr int bar_off = st_off + (NST - 1) * stage + align8(used);
  static constexpr int bytes = bar_off + 8 * (2 * NST + 1) + 1024;
  static_assert(bytes <= 232448, "the CTA's shared memory");
};

template <int D, bool QUANT, bool SEG, bool F32, int KN, bool BF16KV>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Args a,
                     const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg, const int* guard,
                     const F32Src f) {
  // the guard (a bound form's loose-row count) is read before anything
  if (guard != nullptr && *guard == 0) return;
  using T = Tiles<D, false>;
  using L = Layout<D, QUANT, SEG, F32, KN, BF16KV>;
  constexpr int NST = L::NST;
  constexpr bool SPLIT_KV = L::SPLIT_KV;
  // K/V tiles that are exact bf16 operands under an fp32 Q: two wgmmas a
  // product (converted codes, or bf16 K/V as TMA left them)
  constexpr bool EXACT = QUANT || BF16KV;
  // the producer warp's per-tile loads beside the TMA: scales, segment ids
  constexpr bool SIDE = QUANT || SEG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::bar_off;     // + 8 * stage
  const uint32_t empty = full + 8 * NST;       // + 8 * stage
  const uint32_t q_bar = empty + 8 * NST;

  int qt, hg, b;
  cta_tile(a, qt, hg, b);
  const int q0 = qt * a.R;
  const int h0 = hg * a.Gp;
  const int hk = h0 / a.G;
  const int q_hi = min(q0 + a.R, a.Nq) - 1;
  int t_begin, t_end;
  visible_tiles<KN>(a, q0, q_hi, 0, (a.Nk + KN - 1) / KN, t_begin, t_end);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      // the TMA issue, and with SIDE the 32 lanes of the side loads; over
      // fp32 K/V the producer warpgroup's 128 threads
      mbar_init(full + 8 * s, SPLIT_KV ? 128 : SIDE ? 33 : 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    mbar_init(q_bar, F32 ? 128 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // the producer: one thread issues every load; with SIDE its warp also
    // brings each tile's scales and segment ids beside the TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
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
        if (SEG) {
          load_ids<128, KN>(reinterpret_cast<int*>(stage + L::ids), kv_seg,
                            a, b, t * KN, pt);
        }
        fence_proxy_async();
        mbar_arrive(full + 8 * st_i);
      }
    } else if (threadIdx.x < 2 * 128 + (SIDE ? 32 : 1)) {
      if (!F32 && lane == 0) {
        mbar_expect_tx(q_bar, a.Gp * a.R * D * 2);
        for (int sl = 0; sl < T::SLABS; ++sl) {
          tma_load_4d(base + sl * BM * 128, &tm_q, q_bar, sl * 64, q0, h0,
                      b);
        }
      }
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int st = i % NST;
        mbar_wait(empty + 8 * st, ((i / NST) & 1) ^ 1);
        const uint32_t dst = base + L::st_off + st * L::stage;
        if (lane == 0) {
          mbar_expect_tx(full + 8 * st, L::tma_bytes);
          if (QUANT) {
            tma_load_4d(dst, &tm_k, full + 8 * st, 0, t * BN, hk, b);
            tma_load_4d(dst + L::kvh, &tm_v, full + 8 * st, 0, t * BN, hk,
                        b);
          } else {
            for (int sl = 0; sl < T::SLABS; ++sl) {
              tma_load_4d(dst + sl * KN * 128, &tm_k, full + 8 * st, sl * 64,
                          t * KN, hk, b);
              tma_load_4d(dst + L::kvh + sl * KN * 128, &tm_v, full + 8 * st,
                          sl * 64, t * KN, hk, b);
            }
          }
        }
        // the side loads, while the tiles are in flight
        if (SIDE) {
          uint8_t* stage = smem + L::st_off + st * L::stage;
          if (QUANT) {
            load_scales<32>(reinterpret_cast<float*>(stage + L::tma_bytes), a,
                            b, hk, t * BN, lane);
          }
          if (SEG) {
            load_ids<32, KN>(reinterpret_cast<int*>(stage + L::ids), kv_seg,
                             a, b, t * KN, lane);
          }
          mbar_arrive(full + 8 * st);
        }
      }
    }
  } else {
    // two consumer warpgroups, 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    Rows r = row_info<false>(a, b, h0, q0, tid);
    int qseg[2] = {0, 0};  // the rows' segment ids
    if (SEG) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (r.pos[hr] >= 0) {
          qseg[hr] = q_seg[(long long)b * a.Nq + r.pos[hr]];
        }
      }
    }
    float acc[D / 64][32];
#pragma unroll
    for (int sl = 0; sl < D / 64; ++sl) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[sl][i] = 0.f;
    }
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    mbar_wait(q_bar, 0);

    // Step i's key tile (t_begin + i): where wgmma reads its K and V (its
    // codes converted first under QUANT), its scales and key ids.
    auto tile = [&](int i, uint32_t& kt, uint32_t& vt, const float*& ksc,
                    const float*& vsc, const int*& kseg) {
      const int st = i % NST;
      mbar_wait(full + 8 * st, (i / NST) & 1);
      const int stage_off = L::st_off + st * L::stage;
      kt = base + stage_off;
      vt = kt + L::kvh;
      kseg = SEG ? reinterpret_cast<const int*>(smem + stage_off + L::ids)
                 : nullptr;
      if (QUANT) {
        // both warpgroups convert the tile once for the CTA's Gp heads,
        // into the pair of three tiles ago: each warpgroup waited for that
        // tile's P·V before the barrier of the tile after it. With one
        // pair (d = 256, whose walk runs in order) both first finish the
        // previous tile's P·V, which reads it.
        if (L::NCV == 1 && i > 0) consumer_sync();
        uint8_t* cv = smem + L::cv_off + (i % L::NCV) * L::cv_stride;
        const uint8_t* raw = smem + stage_off;
        convert_codes<D, false, NCONSUMER>(cv, raw, a.k_type, tid);
        convert_codes<D, false, NCONSUMER>(cv + L::cv_v, raw + L::kvh,
                                           a.v_type, tid);
        fence_proxy_async();
        consumer_sync();
        kt = smem_u32(cv);
        vt = kt + L::cv_v;
        ksc = reinterpret_cast<const float*>(smem + stage_off + L::tma_bytes);
        vsc = ksc + BN;
      }
    };
    // Step i's online step on its scores s; under QUANT the stage is then
    // read (codes, scales, ids) and released. A bf16 stage is released
    // once its V has gone through the P·V, in the next step.
    auto softmax = [&](int i, float (&s)[32], const float* ksc,
                       const float* vsc, const int* kseg, float (&alpha)[2],
                       uint32_t (&pn)[16], uint32_t* pn_lo) {
      const int c0 = (t_begin + i) * BN;
      if (!SEG && interior(a, c0, q0, q0 + a.R - 1)) {
        online_step<QUANT, false, false, F32>(a, r, s, ksc, vsc, kseg, qseg,
                                              c0, m, l, alpha, pn, pn_lo,
                                              f.round[0]);
      } else {
        online_step<QUANT, SEG, true, F32>(a, r, s, ksc, vsc, kseg, qseg, c0,
                                           m, l, alpha, pn, pn_lo,
                                           f.round[0]);
      }
      if (QUANT && lane == 0) mbar_arrive(empty + 8 * (i % NST));
    };

    const int n = t_end - t_begin;
    if constexpr (KN != BN || D == 256) {
      // in order: S, its softmax, P·V. The 128-key walk's S, and at d =
      // 256 O's 128 registers, leave no room for a second S and P live
      // across the overlap below (under F32 P = p + p_lo, the products on
      // split tiles).
      for (int i = 0; i < n; ++i) {
        uint32_t kt, vt;
        const float* ksc = nullptr;
        const float* vsc = nullptr;
        const int* kseg;
        if constexpr (KN != BN) {
          mbar_wait(full + 8 * (i % NST), (i / NST) & 1);
          const int stage_off = L::st_off + (i % NST) * L::stage;
          kt = base + stage_off;
          vt = kt + L::kvh;
          kseg = SEG ? reinterpret_cast<const int*>(smem + stage_off + L::ids)
                     : nullptr;
        } else {
          tile(i, kt, vt, ksc, vsc, kseg);
        }
        float s[KN / 2], alpha[2];
        uint32_t p[KN / 4], p_lo[KN / 4];
        wgmma_fence();
        qk_issue_any<D, F32, EXACT, KN>(s, base, kt, wg);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        const int c0 = (t_begin + i) * KN;
        if (!SEG && interior<KN>(a, c0, q0, q0 + a.R - 1)) {
          online_step<QUANT, false, false, F32, KN>(
              a, r, s, ksc, vsc, kseg, qseg, c0, m, l, alpha, p, p_lo,
              f.round[0]);
        } else {
          online_step<QUANT, SEG, true, F32, KN>(
              a, r, s, ksc, vsc, kseg, qseg, c0, m, l, alpha, p, p_lo,
              f.round[0]);
        }
        // under QUANT the stage's codes, scales and ids are read
        if (QUANT && lane == 0) mbar_arrive(empty + 8 * (i % NST));
        scale_acc<D>(acc, alpha);
        wgmma_fence();
        pv_issue_any<D, F32, EXACT, KN>(acc, p, p_lo, vt);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int sl = 0; sl < D / 64; ++sl) fence_regs(acc[sl]);
        // the stage's K, V and ids are read
        if (!QUANT && lane == 0) mbar_arrive(empty + 8 * (i % NST));
      }
    } else if (n > 0) {
      uint32_t kt, vt;
      const float* ksc = nullptr;
      const float* vsc = nullptr;
      const int* kseg;
      float s_acc[32], s[32], alpha[2];
      // the P whose P·V is the next to issue (under F32 P = p + p_lo; the
      // products on split tiles)
      uint32_t p[16], p_lo[16];
      // the first tile: S and its softmax, no P·V before it (acc is 0)
      tile(0, kt, vt, ksc, vsc, kseg);
      wgmma_fence();
      qk_issue_any<D, F32, EXACT>(s_acc, base, kt, wg);
      wgmma_commit();
      wgmma_wait_all();
      copy_after_wait(s, s_acc);
      softmax(0, s, ksc, vsc, kseg, alpha, p, p_lo);
      uint32_t v_prev = vt;
      for (int i = 1; i < n; ++i) {
        // this tile's Q·Kᵀ, then the previous tile's P·V: the softmax runs
        // while the tensor cores do the P·V, the rescale of O after it
        tile(i, kt, vt, ksc, vsc, kseg);
        wgmma_fence();
        qk_issue_any<D, F32, EXACT>(s_acc, base, kt, wg);
        wgmma_commit();
        pv_issue_any<D, F32, EXACT>(acc, p, p_lo, v_prev);
        wgmma_commit();
        wgmma_wait_one();
        copy_after_wait(s, s_acc);
        uint32_t p_next[16], p_lo_next[16];
        softmax(i, s, ksc, vsc, kseg, alpha, p_next, p_lo_next);
        wgmma_wait_all();
        fence_regs(p);
        if (F32) fence_regs(p_lo);
#pragma unroll
        for (int sl = 0; sl < D / 64; ++sl) fence_regs(acc[sl]);
        if (!QUANT && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % NST));
        scale_acc<D>(acc, alpha);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          p[j] = p_next[j];
          if (F32) p_lo[j] = p_lo_next[j];
        }
        v_prev = vt;
      }
      wgmma_fence();
      pv_issue_any<D, F32, EXACT>(acc, p, p_lo, v_prev);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int sl = 0; sl < D / 64; ++sl) fence_regs(acc[sl]);
      if (!QUANT && lane == 0) mbar_arrive(empty + 8 * ((n - 1) % NST));
    }
    // the LSE's reference is the running max
    r.c[0] = m[0];
    r.c[1] = m[1];
    store_rows<D, false>(a, r, acc, l, b);
  }
}

// The segment ids and the guard of one launch (each null when absent).
struct Extra {
  const int* q_seg;
  const int* kv_seg;
  const int* guard;
};

template <int D, bool QUANT, bool SEG, bool F32, int KN = BN,
          bool BF16KV = false>
cudaError_t launch(const Maps& mp, const Args& a, const Extra& x,
                   const F32Src& f, int B, cudaStream_t stream) {
  const int smem = Layout<D, QUANT, SEG, F32, KN, BF16KV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, QUANT, SEG, F32, KN, BF16KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + a.R - 1) / a.R, a.H / a.Gp, B);
  flash_fwd_kernel<D, QUANT, SEG, F32, KN, BF16KV>
      <<<grid, NTHREADS, smem, stream>>>(mp.q, mp.k, mp.v, a, x.q_seg,
                                         x.kv_seg, x.guard, f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_form(const Maps& mp, const Args& a, const Extra& x,
                        const F32Src& f, int B, bool f32, int kn,
                        cudaStream_t stream) {
  const bool seg = x.q_seg != nullptr;
  if constexpr (kHalf) {  // the fp16 unit: 2-byte Q (the entry point checked)
    const bool quant = a.k_type != kBf16;
    if constexpr (D != 256) {
      if (kn == BN2) {
        return seg ? launch<D, false, true, false, BN2>(mp, a, x, f, B, stream)
                   : launch<D, false, false, false, BN2>(mp, a, x, f, B,
                                                         stream);
      }
    }
    if (seg) {
      return quant ? launch<D, true, true, false>(mp, a, x, f, B, stream)
                   : launch<D, false, true, false>(mp, a, x, f, B, stream);
    }
    return quant ? launch<D, true, false, false>(mp, a, x, f, B, stream)
                 : launch<D, false, false, false>(mp, a, x, f, B, stream);
  } else if constexpr (D == 256) {
    // 64-key tiles, or BN32 over fp32 K/V (the entry point checked kn)
    if (f32 && a.k_type == kF32) {
      return seg ? launch<D, false, true, true, BN32>(mp, a, x, f, B, stream)
                 : launch<D, false, false, true, BN32>(mp, a, x, f, B,
                                                       stream);
    }
    if (f32 && a.k_type == kBf16) {  // an fp32 Q over bf16 K/V
      return seg ? launch<D, false, true, true, BN, true>(mp, a, x, f, B,
                                                          stream)
                 : launch<D, false, false, true, BN, true>(mp, a, x, f, B,
                                                           stream);
    }
    if (f32) {  // an fp32 Q over one-byte K/V
      return seg ? launch<D, true, true, true>(mp, a, x, f, B, stream)
                 : launch<D, true, false, true>(mp, a, x, f, B, stream);
    }
    const bool quant = a.k_type != kBf16;
    if (seg) {
      return quant ? launch<D, true, true, false>(mp, a, x, f, B, stream)
                   : launch<D, false, true, false>(mp, a, x, f, B, stream);
    }
    return quant ? launch<D, true, false, false>(mp, a, x, f, B, stream)
                 : launch<D, false, false, false>(mp, a, x, f, B, stream);
  } else {
    if (kn == BN2) {  // bf16 Q and K/V (the entry point checked)
      return seg ? launch<D, false, true, false, BN2>(mp, a, x, f, B, stream)
                 : launch<D, false, false, false, BN2>(mp, a, x, f, B, stream);
    }
    if (f32 && a.k_type == kF32) {
      return seg ? launch<D, false, true, true>(mp, a, x, f, B, stream)
                 : launch<D, false, false, true>(mp, a, x, f, B, stream);
    }
    if (f32 && a.k_type == kBf16) {  // an fp32 Q over bf16 K/V
      return seg ? launch<D, false, true, true, BN, true>(mp, a, x, f, B,
                                                          stream)
                 : launch<D, false, false, true, BN, true>(mp, a, x, f, B,
                                                           stream);
    }
    if (f32) {  // an fp32 Q over one-byte K/V
      return seg ? launch<D, true, true, true>(mp, a, x, f, B, stream)
                 : launch<D, true, false, true>(mp, a, x, f, B, stream);
    }
    const bool quant = a.k_type != kBf16;
    if (seg) {
      return quant ? launch<D, true, true, false>(mp, a, x, f, B, stream)
                   : launch<D, false, true, false>(mp, a, x, f, B, stream);
    }
    return quant ? launch<D, true, false, false>(mp, a, x, f, B, stream)
                 : launch<D, false, false, false>(mp, a, x, f, B, stream);
  }
}

}  // namespace

// K1, behind `guard` when that is not null. ptrs: q (prescaled: bf16, or
// fp32 under q_f32), k, v, k_scale, v_scale ([B,Hkv,Nk] fp32 or NULL),
// q_seg ([B,Nq] int32 or NULL), kv_seg ([B,Nk]), guard (int32 or NULL), o
// ([B,H,Nq,D] contiguous), lse ([B,H,Nq]). strides: q, k, v, each (batch,
// head, row), in elements, rows 16-byte aligned. k_type/v_type: 0 bf16, 1
// int8, 2 fp8 e4m3, 3 fp32 (K and V both bf16, both one-byte or, with an
// fp32 Q, both fp32). q_f32: an fp32 Q (over fp32, bf16 or one-byte K/V),
// 2 / 3 one whose P is rounded to bf16 / fp16 before P·V (a mixed-type
// call's upcast operands); not in the fp16 unit (cfa_flash_fwd_f16: fp16
// Q, storage code 0 fp16 K/V).
// out_type: O in bf16 (0), fp32 (1) or fp16 (2). kn: keys of a tile, 64,
// or 128 (bf16 Q and K/V at d <= 128), and 32 for an fp32 Q over fp32 K/V
// at d = 256 (that build's only tile). D: 64, 128, or 256.
extern "C" int cfa_flash_fwd(void* const* ptrs, int B, int H, int Hkv, int Nq,
                             int Nk, int D, const long long* strides,
                             int k_type, int v_type, int q_f32, int causal,
                             int window, int kv_offset, int out_type, int kn,
                             void* stream) {
  if (B == 0 || H == 0 || Nq == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  if ((k_type == kBf16) != (v_type == kBf16)) return cudaErrorInvalidValue;
  if ((k_type == kF32) != (v_type == kF32)) return cudaErrorInvalidValue;
  const bool f32 = q_f32 != 0;
  if (q_f32 < 0 || q_f32 > 3 || (kHalf && f32)) return cudaErrorInvalidValue;
  if (!f32 && k_type == kF32) return cudaErrorInvalidValue;
  if (out_type < kOutBf16 || out_type > kOutF16) return cudaErrorInvalidValue;
  if (kn != key_tile(D, f32, k_type) &&
      (kn != BN2 || f32 || k_type != kBf16 || D == 256)) {
    return cudaErrorInvalidValue;
  }
  Args a = {};
  a.k_scale = static_cast<const float*>(ptrs[3]);
  a.v_scale = static_cast<const float*>(ptrs[4]);
  const Extra x = {static_cast<const int*>(ptrs[5]),
                   static_cast<const int*>(ptrs[6]),
                   static_cast<const int*>(ptrs[7])};
  a.o = ptrs[8];
  a.lse = static_cast<float*>(ptrs[9]);
  a.H = H; a.Hkv = Hkv; a.Nq = Nq; a.Nk = Nk;
  a.G = H / Hkv;
  a.Gp = packed_heads(a.G);
  a.R = BM / a.Gp;
  a.k_type = k_type; a.v_type = v_type;
  a.causal = causal; a.window = window; a.kv_offset = kv_offset;
  a.out_type = out_type;
  if (k_type != kBf16 && k_type != kF32 &&
      (a.k_scale == nullptr || a.v_scale == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if ((x.q_seg == nullptr) != (x.kv_seg == nullptr)) {
    return cudaErrorInvalidValue;
  }
  // the fp32 builds read fp32 operands through F32Src, not through TMA
  // (one-byte K/V still come by TMA)
  Maps mp = {};
  F32Src f = {};
  if (f32) f = f32_src(ptrs, strides, q_f32);
  if (k_type != kF32 &&
      !make_maps(&mp, f32 ? nullptr : ptrs[0], ptrs[1], ptrs[2], B, H, Hkv,
                 Nq, Nk, D, strides, k_type, v_type, 0, a.Gp, a.R, kn)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_form<64>(mp, a, x, f, B, f32, kn, s);
    case 128:
      return launch_form<128>(mp, a, x, f, B, f32, kn, s);
    case 256:
      return launch_form<256>(mp, a, x, f, B, f32, kn, s);
    default:
      return cudaErrorInvalidValue;
  }
}

#ifndef CFA_F16
extern "C" const char* cfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif
