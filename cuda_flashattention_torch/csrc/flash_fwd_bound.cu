// FlashAttention-2 forward with the score-bound softmax on a Q-major walk
// (K1b), for Hopper: bf16 Q, K/V in bf16, int8 or fp8 e4m3 with per-token
// scales (or int8 Q and K under quantize_q), or an fp32 Q over fp32, bf16
// or those one-byte K/V (the F32 builds: fp32 tiles split into bf16 hi and
// lo), fp32, bf16 or fp16 out, the natural-log LSE and the count of
// loose-bound rows.
//
// Replaces: cuda_flashattention_tpu/ops/flash_fwd.py::_fwd_kernel with
// bound=True: p = 2^(s − c) against the host's per-row bound c, no running
// max and no rescale, so l and acc simply add over key tiles.
//
// What bounds it on the H100: at the chunked-prefill prefix (512 query rows
// over 3584 keys, d = 128) and the ring's 4096 x 4096 steps the two
// products are ~4·Nq·Nk·d operations against (Nq + 2·Nk)·d elements per
// head: far above the card's ~295 operations per byte, so it is bound by
// the tensor cores, and in practice by how well the softmax between the
// two products hides under them. Quantized K/V halves the bytes and leaves
// the operations as they were, plus one conversion per key tile.
//
// What this design does about it (flash_fwd_bound_sm90.cuh): a CTA owns a
// 128-row tile of packed query heads (two consumer warpgroups of 64 rows,
// all Gp heads of one KV head when the group allows), and walks the key
// tiles its rows can see, from the window's frontier to the causal one.
// A producer thread keeps the next key tiles' TMA loads in flight in a
// ring of 2 stages (3 for one-byte K/V, whose scales its warp brings in
// beside them) while the consumers run wgmma; S, P, l and O never leave
// registers. One-byte K/V tiles are converted once per CTA and key tile,
// into a double-buffered bf16 (or s8) tile, for all Gp heads at once.
// Interior tiles skip the element mask. The 128-key build (KN = BN2, bf16
// Q and K/V; `block_k` = 128 on the host selects it) walks key tiles of
// 128 with one m64n128 wgmma a step for S: half the steps, barriers and
// bound passes; two stages of 64 KB at d = 128. At d = 256 (bf16 or
// quantize_q's int8 Q) one-byte K/V keep two stages, and over bf16 tiles
// one converted pair, which both warpgroups finish reading before it is
// overwritten. An fp32 Q at d = 256 (its split tile 128 KB) keeps one
// stage, as K1 does and for the same reasons (flash_fwd.cu): a bf16 K + V
// stage, or a code stage and one converted pair (231,448 of the 232,448
// bytes), or over fp32 K/V one stage of 32-key split tiles (BN32).

#include "flash_fwd_bound_sm90.cuh"

using namespace cfa_bound;

namespace {

// key-tile stages in flight: a one-byte stage is half the bytes, and its
// scales come in by plain loads, so it keeps one more ahead (not at d =
// 256, whose 64 KB Q tile leaves room for two; an fp32 Q's split one for
// one)
template <int D, bool QUANT, bool F32>
constexpr int stages() {
  return D == 256 && F32 ? 1 : QUANT && D != 256 ? 3 : 2;
}

// Shared memory of one CTA (byte offsets from a 1024-aligned base): the Q
// tile (under F32 its hi and lo tiles); NST stages of K and V as TMA
// writes them (bf16 slabs, or one-byte codes followed by the tile's K and
// V scales; under F32 over fp32 K/V the producer warpgroup's hi and lo
// tiles of each, over bf16 K/V (BF16KV) the bf16 slabs); under QUANT two
// converted K/V pairs (exact bf16 tiles, or an s8 K tile under QQ), used
// in turn, or one at d = 256 over bf16 tiles (195 KB with it; 231,448
// bytes under an fp32 Q); barriers.
template <int D, bool QUANT, bool QQ, bool F32, int KN, bool BF16KV>
struct Layout {
  using T = Tiles<D, QQ>;
  static constexpr bool SPLIT_KV = F32 && !QUANT && !BF16KV;  // fp32 K/V
  static_assert(KN != BN2 || (!QUANT && !F32 && D != 256),
                "128 keys: bf16 K/V at d <= 128 only");
  static_assert((KN == BN32) == (D == 256 && SPLIT_KV),
                "32 keys: fp32 K/V at d = 256 (and there only)");
  static_assert(!BF16KV || (F32 && !QUANT), "BF16KV: an fp32 Q");
  static constexpr int NST = stages<D, QUANT, F32>();
  static constexpr int NCV = D == 256 && !QQ ? 1 : 2;  // converted pairs
  static constexpr int kv16 = KN * D * 2;              // a bf16 K or V tile
  static constexpr int kvh =                          // K, then V
      QUANT ? T::CODES : SPLIT_KV ? 2 * kv16 : kv16;
  static constexpr int tma_bytes = 2 * kvh;
  static constexpr int stage = align1k(tma_bytes + (QUANT ? 2 * BN * 4 : 0));
  static constexpr int st_off = align1k(F32 ? 2 * T::Q : T::Q);
  static constexpr int cv_v = align1k(T::KC);          // V in a converted pair
  static constexpr int cv_stride = align1k(cv_v + T::KV16);
  static constexpr int cv_off = st_off + NST * stage;
  static constexpr int bar_off = cv_off + (QUANT ? NCV * cv_stride : 0);
  static constexpr int bytes = bar_off + 8 * (2 * NST + 1) + 1024;
  static_assert(bytes <= 232448, "the CTA's shared memory");
};

template <int D, bool QUANT, bool QQ, bool F32, int KN, bool BF16KV>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_bound_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const Args a, const F32Src f) {
  static_assert(QUANT || !QQ, "quantize_q reads quantized K/V");
  static_assert(!(QQ && F32), "quantize_q's Q is int8");
  using T = Tiles<D, QQ>;
  using L = Layout<D, QUANT, QQ, F32, KN, BF16KV>;
  constexpr int NST = L::NST;
  constexpr bool SPLIT_KV = L::SPLIT_KV;
  // K/V tiles that are exact bf16 operands under an fp32 Q
  constexpr bool EXACT = QUANT || BF16KV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::bar_off;     // + 8 * stage
  const uint32_t empty = full + 8 * NST;       // + 8 * stage
  const uint32_t q_bar = empty + 8 * NST;

  const int q0 = blockIdx.x * a.R;
  const int h0 = blockIdx.y * a.Gp;
  const int b = blockIdx.z;
  const int hk = h0 / a.G;
  const int q_hi = min(q0 + a.R, a.Nq) - 1;
  int t_begin, t_end;
  visible_tiles<KN>(a, q0, q_hi, 0, (a.Nk + KN - 1) / KN, t_begin, t_end);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      // the TMA issue, and under QUANT the 32 lanes that load the scales;
      // over fp32 K/V the producer warpgroup's 128 threads
      mbar_init(full + 8 * s, SPLIT_KV ? 128 : QUANT ? 33 : 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    mbar_init(q_bar, F32 ? 128 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // the producer: one thread issues every load; under QUANT its warp
    // also brings each tile's scales beside the codes
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
        fence_proxy_async();
        mbar_arrive(full + 8 * st_i);
      }
    } else if (threadIdx.x < 2 * 128 + (QUANT ? 32 : 1)) {
      if (!F32 && lane == 0) {
        mbar_expect_tx(q_bar, a.Gp * a.R * D * (QQ ? 1 : 2));
        for (int sl = 0; sl < T::QSLABS; ++sl) {
          tma_load_4d(base + sl * BM * 128, &tm_q, q_bar, sl * T::QCOL, q0,
                      h0, b);
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
        // the scales, while the codes are in flight
        if (QUANT) {
          load_scales<32>(reinterpret_cast<float*>(smem + L::st_off +
                                                   st * L::stage +
                                                   L::tma_bytes),
                          a, b, hk, t * BN, lane);
          mbar_arrive(full + 8 * st);
        }
      }
    }
  } else {
    // two consumer warpgroups, 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
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
      if (QUANT) {
        // both warpgroups convert the tile once for the CTA's Gp heads,
        // into the pair used two tiles ago: each warpgroup finished that
        // tile's P·V before the barrier of the tile in between. With one
        // pair both first finish the previous tile's P·V, which reads it.
        if (L::NCV == 1 && i > 0) consumer_sync();
        uint8_t* cv = smem + L::cv_off + (i % L::NCV) * L::cv_stride;
        const uint8_t* raw = smem + stage_off;
        if (QQ) {
          codes_to_s8<D, NCONSUMER>(cv, raw, a.k_type, tid);
        } else {
          codes_to_elem<D, NCONSUMER>(cv, raw, a.k_type, tid);
        }
        codes_to_elem<D, NCONSUMER>(cv + L::cv_v, raw + L::kvh, a.v_type,
                                    tid);
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
      if (QUANT && lane == 0) mbar_arrive(empty + 8 * st);
      pv<D, F32, EXACT, KN>(acc, p, vt, p_lo);
      if (!QUANT && lane == 0) mbar_arrive(empty + 8 * st);
    }
    store_rows<D>(a, r, acc, l, b);
  }
}

template <int D, bool QUANT, bool QQ, bool F32, int KN = BN,
          bool BF16KV = false>
cudaError_t launch(const Maps& m, const Args& a, const F32Src& f, int B,
                   cudaStream_t stream) {
  const int smem = Layout<D, QUANT, QQ, F32, KN, BF16KV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bound_kernel<D, QUANT, QQ, F32, KN, BF16KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + a.R - 1) / a.R, a.H / a.Gp, B);
  flash_fwd_bound_kernel<D, QUANT, QQ, F32, KN, BF16KV>
      <<<grid, NTHREADS, smem, stream>>>(m.q, m.k, m.v, a, f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_form(const Maps& m, const Args& a, const F32Src& f, int B,
                        int qq, bool f32, int kn, cudaStream_t stream) {
  if constexpr (kHalf) {  // the fp16 unit: fp16 Q (the entry point checked)
    if constexpr (D != 256) {
      if (kn == BN2) {
        return launch<D, false, false, false, BN2>(m, a, f, B, stream);
      }
    }
    return a.k_type == kBf16 ? launch<D, false, false, false>(m, a, f, B,
                                                              stream)
                             : launch<D, true, false, false>(m, a, f, B,
                                                             stream);
  } else if constexpr (D == 256) {
    // 64-key tiles, or BN32 over fp32 K/V (the entry point checked kn)
    if (f32) {  // an fp32 Q over fp32, bf16 or one-byte K/V
      if (a.k_type == kF32) {
        return launch<D, false, false, true, BN32>(m, a, f, B, stream);
      }
      if (a.k_type == kBf16) {
        return launch<D, false, false, true, BN, true>(m, a, f, B, stream);
      }
      return launch<D, true, false, true>(m, a, f, B, stream);
    }
    if (a.k_type == kBf16) {
      return launch<D, false, false, false>(m, a, f, B, stream);
    }
    return qq ? launch<D, true, true, false>(m, a, f, B, stream)
              : launch<D, true, false, false>(m, a, f, B, stream);
  } else {
    if (kn == BN2) {  // bf16 Q and K/V (the entry point checked)
      return launch<D, false, false, false, BN2>(m, a, f, B, stream);
    }
    if (f32) {  // an fp32 Q over fp32, bf16 or one-byte K/V
      if (a.k_type == kF32) {
        return launch<D, false, false, true>(m, a, f, B, stream);
      }
      if (a.k_type == kBf16) {
        return launch<D, false, false, true, BN, true>(m, a, f, B, stream);
      }
      return launch<D, true, false, true>(m, a, f, B, stream);
    }
    if (a.k_type == kBf16) {
      return launch<D, false, false, false>(m, a, f, B, stream);
    }
    return qq ? launch<D, true, true, false>(m, a, f, B, stream)
              : launch<D, true, false, false>(m, a, f, B, stream);
  }
}

}  // namespace

// K1b. ptrs: q (bf16 prescaled, or int8 under qq), k, v, k_scale, v_scale
// ([B,Hkv,Nk] fp32 or NULL), q_factor ([B,H] fp32 under qq, else NULL), c
// ([B,H,Nq]), n_loose (int32, zeroed), o ([B,H,Nq,D] contiguous), lse
// ([B,H,Nq]). strides: q, k, v, each (batch, head, row), in elements, rows
// 16-byte aligned. k_type/v_type: 0 bf16, 1 int8, 2 fp8 e4m3, 3 fp32 (K
// and V both bf16, both one-byte or, with an fp32 Q, both fp32). q_f32:
// an fp32 Q (over fp32, bf16 or one-byte K/V; not with qq, whose Q is
// int8), 2 / 3 one whose P is rounded to bf16 / fp16 before P·V; neither
// q_f32 nor qq in the fp16 unit (cfa_flash_fwd_bound_f16: fp16 Q, code 0
// fp16 K/V). out_type: O in bf16 (0), fp32 (1) or fp16 (2). kn: keys of a
// tile, 64, or 128 (bf16 Q and K/V at d <= 128), and 32 for an fp32 Q
// over fp32 K/V at d = 256 (that build's only tile). D: 64, 128, or 256.
extern "C" int cfa_flash_fwd_bound(void* const* ptrs, int B, int H, int Hkv,
                                   int Nq, int Nk, int D,
                                   const long long* strides, int k_type,
                                   int v_type, int q_f32, int qq, int causal,
                                   int window, int kv_offset, int out_type,
                                   int kn, void* stream) {
  if (B == 0 || H == 0 || Nq == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  if ((k_type == kBf16) != (v_type == kBf16)) return cudaErrorInvalidValue;
  if ((k_type == kF32) != (v_type == kF32)) return cudaErrorInvalidValue;
  const bool f32 = q_f32 != 0;
  if (q_f32 < 0 || q_f32 > 3) return cudaErrorInvalidValue;
  if (kHalf && (f32 || qq)) return cudaErrorInvalidValue;
  if (!f32 && k_type == kF32) return cudaErrorInvalidValue;
  if (out_type < kOutBf16 || out_type > kOutF16) return cudaErrorInvalidValue;
  if (qq && (k_type == kBf16 || f32)) return cudaErrorInvalidValue;
  if (kn != key_tile(D, f32, k_type) &&
      (kn != BN2 || f32 || k_type != kBf16 || D == 256)) {
    return cudaErrorInvalidValue;
  }
  Args a = {};
  a.k_scale = static_cast<const float*>(ptrs[3]);
  a.v_scale = static_cast<const float*>(ptrs[4]);
  a.q_factor = qq ? static_cast<const float*>(ptrs[5]) : nullptr;
  a.c = static_cast<const float*>(ptrs[6]);
  a.n_loose = static_cast<int*>(ptrs[7]);
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
  // the fp32 builds read fp32 operands through F32Src, not through TMA
  // (one-byte K/V still come by TMA)
  Maps m = {};
  F32Src f = {};
  if (f32) f = f32_src(ptrs, strides, q_f32);
  if (k_type != kF32 &&
      !make_maps(&m, f32 ? nullptr : ptrs[0], ptrs[1], ptrs[2], B, H, Hkv,
                 Nq, Nk, D, strides, k_type, v_type, qq, a.Gp, a.R, kn)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_form<64>(m, a, f, B, qq, f32, kn, s);
    case 128:
      return launch_form<128>(m, a, f, B, qq, f32, kn, s);
    case 256:
      return launch_form<256>(m, a, f, B, qq, f32, kn, s);
    default:
      return cudaErrorInvalidValue;
  }
}
