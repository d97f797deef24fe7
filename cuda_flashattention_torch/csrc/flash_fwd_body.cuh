// The tile pair of the online FlashAttention-2 forward (K1,
// flash_fwd.cu).
//
// Replaces: the parts of cuda_flashattention_tpu/ops/flash_fwd.py::
// _fwd_kernel (bound=False) that a (Q tile, K/V tile) pair computes: the
// tile loads with their dequantising casts, the Q·Kᵀ and P·V products and
// the element mask. The bound forms (K1b, K5) have their own Hopper body,
// flash_fwd_bound_sm90.cuh.
//
// Tiles are 64 query rows by 64 keys, four warps, each warp owning 16
// query rows end to end. K and V may be stored as bf16, int8 or fp8 e4m3
// (converted by the hardware's cvt), the one-byte types with one fp32
// scale per token; a tile is converted to bf16 ONCE when it is copied into
// shared memory (every int8 and e4m3 value is a bf16 value), so the
// products run on the same bf16 tensor-core fragments whatever the
// storage.
//
// Numerics follow the TPU kernel:
//   s = (q̂ · k_q) · k_scale[col]          fp32; q̂ is Q·scale·log2e rounded
//       to bf16 by the host
//   masked s = NEG_INF, p = 0
//   acc += bf16(p · v_scale[col]) · v_q    rounded AFTER the scale
//   l sums the unrounded p.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace cfa_fwd_body {

using namespace nvcuda;

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int NWARPS = 4;    // each warp owns BQ / NWARPS = 16 rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS_PER_WARP = BQ / NWARPS;
static_assert(BQ == BK, "the per-tile vectors are sized for either");

// storage type codes of the C interface
constexpr int kBf16 = 0, kInt8 = 1, kFp8 = 2;


// What the kernel is given.
struct Args {
  const void* q;         // [B,H,Nq,D] bf16 prescaled
  const void* k;         // [B,Hkv,Nk,D] in k_type
  const void* v;         // [B,Hkv,Nk,D] in v_type
  const float* k_scale;  // [B,Hkv,Nk] or null
  const float* v_scale;  // [B,Hkv,Nk] or null
  const int* q_seg;      // [B,Nq] or null
  const int* kv_seg;     // [B,Nk] or null
  const int* guard;      // run only when *guard != 0 (or null)
  void* o;               // [B,H,Nq,D] fp32 or bf16
  float* lse;            // [B,H,Nq]
  int H, Hkv, Nq, Nk;
  long long sqb, sqh, sqn, skb, skh, skn, svb, svh, svn;  // in elements
  int k_type, v_type;
  int causal, window, kv_offset, out_f32;
};

template <int D>
struct Smem {
  // padded leading dimensions (elements); every wmma tile pointer stays
  // 32-byte aligned and rows fall on different banks
  static constexpr int LDH = D + 8;    // bf16 Q, K, V tiles
  static constexpr int LDS = BK + 4;   // fp32 (or int32) scores
  static constexpr int LDP = BK + 8;   // bf16 probabilities
  static constexpr int LDO = D + 4;    // fp32 accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(bf16) * BQ * LDH;
  static constexpr size_t v_off = k_off + sizeof(bf16) * BK * LDH;
  static constexpr size_t p_off = v_off + sizeof(bf16) * BK * LDH;
  static constexpr size_t s_off = p_off + sizeof(bf16) * BQ * LDP;
  static constexpr size_t o_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t m_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t ksc_off = l_off + sizeof(float) * BQ;
  static constexpr size_t vsc_off = ksc_off + sizeof(float) * BK;
  static constexpr size_t qseg_off = vsc_off + sizeof(float) * BK;
  static constexpr size_t kseg_off = qseg_off + sizeof(int) * BQ;
  static constexpr size_t bytes = kseg_off + sizeof(int) * BK;
};

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

// Copy ROWS rows of D bf16 (row stride `stride` elements) into a padded
// shared tile; rows at or past `valid` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long stride, int row0,
                                          int valid) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// The same from int8 or e4m3 storage, converted exactly to bf16.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_cvt(bf16* dst, int ld,
                                              const uint8_t* src, int type,
                                              long long stride, int row0,
                                              int valid) {
  constexpr int VPR = D / 16;  // 16-byte vectors per stored row
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 16;
    unsigned int w[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // 16 bf16, in pairs
    if (row0 + r < valid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
      float f[16];
      cvt16(raw, type, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat162 pair =
            __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
        w[j] = *reinterpret_cast<const unsigned int*>(&pair);
      }
    }
    uint4* d4 = reinterpret_cast<uint4*>(dst + r * ld + c);
    d4[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d4[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// A K or V tile in whatever type it is stored, as bf16.
template <int D>
__device__ __forceinline__ void load_kv(bf16* dst, const void* src, int type,
                                        long long stride, int row0,
                                        int valid) {
  using S = Smem<D>;
  if (type == kBf16) {
    load_tile<D, BK>(dst, S::LDH, static_cast<const bf16*>(src), stride, row0,
                     valid);
  } else {
    load_tile_cvt<D, BK>(dst, S::LDH, static_cast<const uint8_t*>(src), type,
                         stride, row0, valid);
  }
}

// One tile's per-token scales (1 past the ragged end) into shared memory.
__device__ __forceinline__ void load_scales(float* dst, const float* src,
                                            int c0, int Nk) {
  for (int i = threadIdx.x; i < BK; i += NTHREADS) {
    dst[i] = c0 + i < Nk ? src[c0 + i] : 1.f;
  }
}

// One tile's segment ids; past the end `pad`, which matches no real id.
__device__ __forceinline__ void load_ids(int* dst, const int* src, int i0,
                                         int n, int pad) {
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    dst[i] = i0 + i < n ? src[i0 + i] : pad;
  }
}

// S[r0:r0+16, :] = Q[r0:r0+16, :] · Kᵀ, bf16 fragments, fp32 accumulation.
template <int D>
__device__ __forceinline__ void qk_bf16(const bf16* qs, const bf16* ks,
                                        float* ss, int r0) {
  using S = Smem<D>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
  for (int nb = 0; nb < BK / 16; ++nb) wmma::fill_fragment(acc[nb], 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, qs + r0 * S::LDH + kk * 16, S::LDH);
#pragma unroll
    for (int nb = 0; nb < BK / 16; ++nb) {
      // Kᵀ as a column-major B: element (kk, n) sits at K[n][kk]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, ks + nb * 16 * S::LDH + kk * 16, S::LDH);
      wmma::mma_sync(acc[nb], fa, fb, acc[nb]);
    }
  }
#pragma unroll
  for (int nb = 0; nb < BK / 16; ++nb) {
    wmma::store_matrix_sync(ss + r0 * S::LDS + nb * 16, acc[nb], S::LDS,
                            wmma::mem_row_major);
  }
}

// O[r0:r0+16, :] (+)= P[r0:r0+16, :] · V. With `fresh` the previous
// contents of `os` are ignored.
template <int D>
__device__ __forceinline__ void pv(float* os, const bf16* ps, const bf16* vs,
                                   int r0, bool fresh) {
  using S = Smem<D>;
#pragma unroll
  for (int nb = 0; nb < D / 16; ++nb) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (fresh) {
      wmma::fill_fragment(acc, 0.f);
    } else {
      wmma::load_matrix_sync(acc, os + r0 * S::LDO + nb * 16, S::LDO,
                             wmma::mem_row_major);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, ps + r0 * S::LDP + kk * 16, S::LDP);
      wmma::load_matrix_sync(fb, vs + kk * 16 * S::LDH + nb * 16, S::LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(os + r0 * S::LDO + nb * 16, acc, S::LDO,
                            wmma::mem_row_major);
  }
}

// The options of one call that most calls do not use, resolved once per
// kernel: quantized K/V, segment ids, a sliding window. The kernels are
// built twice; with EXTRA false a call has none of them and every test of
// them folds away at compile time, so the plain causal forward pays
// nothing for the forms beside it.
template <bool EXTRA>
struct Extras {
  bool quant, seg;
  int window;
  __device__ __forceinline__ explicit Extras(const Args& a)
      : quant(EXTRA && a.k_scale != nullptr),
        seg(EXTRA && a.q_seg != nullptr),
        window(EXTRA ? a.window : 0) {}
};

// Whether query position `qpos` (row index + kv_offset) sees key `col`.
// qseg/kseg: the row's and the key's segment ids (ignored unless x.seg).
template <bool EXTRA>
__device__ __forceinline__ bool visible(const Args& a, const Extras<EXTRA>& x,
                                        int qpos, int col, int qseg,
                                        int kseg) {
  bool ok = col < a.Nk;
  if (a.causal) {
    ok = ok && col <= qpos;
    if (x.window > 0) ok = ok && col > qpos - x.window;
  }
  if (x.seg) ok = ok && qseg == kseg;
  return ok;
}

// Whether every pair of a warp's 16 rows (the first at position
// `qpos_first`) and a tile's BK keys (from c0) is visible, so that the
// element test can be skipped: an interior tile of the causal band.
template <bool EXTRA>
__device__ __forceinline__ bool all_visible(const Args& a,
                                            const Extras<EXTRA>& x,
                                            int qpos_first, int c0) {
  if (x.seg || c0 + BK > a.Nk) return false;
  if (a.causal) {
    if (c0 + BK - 1 > qpos_first) return false;
    if (x.window > 0 && c0 <= qpos_first + ROWS_PER_WARP - 1 - x.window) {
      return false;
    }
  }
  return true;
}

// The score of (row, column c of the tile) in log2 units, dequantised.
template <int D>
__device__ __forceinline__ float score(const float* ss, int row, int c,
                                       bool quant, const float* kscs) {
  using S = Smem<D>;
  const float s = ss[row * S::LDS + c];
  return quant ? s * kscs[c] : s;
}

}  // namespace cfa_fwd_body
