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
// for all Gp heads at once, into a 2-byte (or s8) tile. At d <= 128 under
// a 2-byte or int8 Q the consumers convert K into one of two K tiles
// before their Q·Kᵀ, and the producer warpgroup's three other warps
// convert V into a ring of three V tiles meanwhile (VSPLIT): the whole
// conversion on the consumers' path took K1b over int8 to 1.8x its bf16
// time (PERF.md §6), the whole of it on the producer warpgroup, even on
// all four of its warps, fell behind the consumers' step and ran slower
// still, and the split runs the two halves side by side.
// Under an fp32 Q the consumers convert both, into two pairs. Interior
// tiles skip the element mask. The 128-key build (KN = BN2, bf16
// Q and K/V; `block_k` = 128 on the host selects it) walks key tiles of
// 128 with one m64n128 wgmma a step for S: half the steps, barriers and
// bound passes; two stages of 64 KB at d = 128. At d = 256 (a 2-byte or
// quantize_q's int8 Q) one-byte K/V are converted before the walk, once
// per call, into exact 2-byte copies in device memory (the PRE builds:
// `convert_pass`, whose comment says why), which the walk reads by TMA as
// it reads bf16 K/V, two stages beside the Q tile, scales as before. The
// walk itself is in the header (`q_walk`); the host sends K5's calls under
// a 2-byte or int8 Q here wherever this walk's grid fills the card.
// An fp32 Q at d = 256 (its split tile 128 KB) keeps one
// stage, as K1 does and for the same reasons (flash_fwd.cu): a bf16 K + V
// stage, or a code stage and one converted pair (231,448 of the 232,448
// bytes), or over fp32 K/V one stage of 32-key split tiles (BN32).

#include "flash_fwd_bound_sm90.cuh"

using namespace cfa_bound;

namespace {

template <int D, bool QUANT, bool QQ, bool F32, int KN, bool BF16KV,
          bool PRE>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_bound_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const Args a, const F32Src f) {
  q_walk<D, QUANT, QQ, F32, KN, BF16KV, PRE>(&tm_q, &tm_k, &tm_v, a, f);
}

// the conversion pass of the PRE builds (flash_fwd_bound_sm90.cuh)
template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_bound_convert_kernel(const ConvArgs c) {
  convert_pass<D>(c);
}

template <int D, bool QUANT, bool QQ, bool F32, int KN = BN,
          bool BF16KV = false, bool PRE = false>
cudaError_t launch(const Maps& m, const Args& a, const F32Src& f, int B,
                   cudaStream_t stream) {
  return launch_walk<D, QUANT, QQ, F32, KN, BF16KV, PRE>(
      flash_fwd_bound_kernel<D, QUANT, QQ, F32, KN, BF16KV, PRE>, m, a, f, B,
      stream);
}

template <int D>
cudaError_t launch_form(const Maps& m, const Args& a, const F32Src& f, int B,
                        int qq, bool f32, int kn, cudaStream_t stream) {
  if constexpr (kHalf) {  // the fp16 unit: fp16 Q (the entry point checked)
    if constexpr (D != 256) {
      if (kn == BN2) {
        return launch<D, false, false, false, BN2>(m, a, f, B, stream);
      }
      return a.k_type == kBf16
                 ? launch<D, false, false, false>(m, a, f, B, stream)
                 : launch<D, true, false, false>(m, a, f, B, stream);
    } else {
      // one-byte K/V converted before the walk (PRE)
      return a.k_type == kBf16
                 ? launch<D, false, false, false>(m, a, f, B, stream)
                 : launch<D, true, false, false, BN, false, true>(m, a, f, B,
                                                                  stream);
    }
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
    // one-byte K/V converted before the walk (PRE)
    return qq ? launch<D, true, true, false, BN, false, true>(m, a, f, B,
                                                              stream)
              : launch<D, true, false, false, BN, false, true>(m, a, f, B,
                                                               stream);
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
// ([B,H,Nq]), kc, vc (pre_converted builds: the host's scratch for the
// converted copies of K and V, [B,Hkv,Nk,D] contiguous, 2-byte, K int8
// under qq over fp8 keys and unused (NULL) under qq over int8 keys; else
// NULL). strides: q, k, v, each (batch, head, row), in elements, rows
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pre_converted(D, f32, k_type)) {
    const cudaError_t err = convert_and_map<256>(
        flash_fwd_bound_convert_kernel<256>, &m, ptrs[0], ptrs[1], ptrs[2],
        ptrs[10], ptrs[11], B, H, Hkv, Nq, Nk, strides, k_type, v_type, qq,
        a.Gp, a.R, s);
    if (err != cudaSuccess) return err;
  } else if (k_type != kF32 &&
             !make_maps(&m, f32 ? nullptr : ptrs[0], ptrs[1], ptrs[2], B, H,
                        Hkv, Nq, Nk, D, strides, k_type, v_type, qq, a.Gp,
                        a.R, kn)) {
    return cudaErrorInvalidValue;
  }
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
