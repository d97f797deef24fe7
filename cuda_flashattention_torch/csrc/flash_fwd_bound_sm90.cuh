// The Hopper body of the two score-bound forward kernels: the Q-major walk
// of flash_fwd_bound.cu (K1b) and the key-split walk of flash_fwd_kmajor.cu
// (K5).
//
// Replaces: cuda_flashattention_tpu/ops/flash_fwd.py::_fwd_kernel
// (bound=True) and ::_fwd_kernel_kmajor, in what they have in common: the
// tile loads with their dequantising casts, Q·Kᵀ and P·V, the element
// mask, the bound step p = 2^(s − c) and the loose-bound test. A walk decides
// which (Q tile, key tile) pairs a CTA visits and where its sums go; what a
// pair computes is here, so the two kernels cannot drift apart.
//
// The machine this is written for (sm_90a):
//   - TMA (cp.async.bulk.tensor) brings Q and K/V tiles into shared memory,
//     128-byte swizzled, behind mbarriers; one producer thread issues them.
//   - Two consumer warpgroups each own 64 query rows of a 128-row tile and
//     run wgmma.mma_async: S = Q·Kᵀ from shared memory (bf16, or s8 with
//     int32 accumulation under quantize_q), then P·V with P as the A
//     operand from registers and V from shared memory (MN-major B). S, P,
//     l and the O accumulator stay in registers for the whole walk.
//   - setmaxnreg gives the producer warpgroup 40 registers and the
//     consumers 232.
//   - int8 or e4m3 K/V come in as codes (half the bytes of bf16) and are
//     converted once per tile by the consumers into a bf16 tile (or, under
//     quantize_q, an int8 tile: fp8 keys re-gridded), written in the same
//     swizzle wgmma reads.
//   - A 128-row tile packs the Gp query heads of one KV head that the host
//     chose (Gp rows blocks of R = 128 / Gp positions): each K/V tile, and
//     each conversion of one, serves Gp heads.
//
// Numerics (those of the plain version, ops/flash_fwd.py::_forward_plain):
//   s = (q̂ · k_q) · k_scale[col]     fp32; under quantize_q the int32 dot
//       of the int8 Q and K times k_scale[col] · factor[h] (the host's
//       per-head factor, with 448/127 folded in for the fp8 → int8 re-grid)
//   p = 2^(s − c_row), 0 where masked (causal with kv_offset, window,
//       ragged tail); l sums the unrounded p
//   acc += bf16(p · v_scale[col]) · v_q     rounded AFTER the scale
//   O = acc / l, LSE = c·ln2 + ln l; O = 0, LSE = NEG_INF where l = 0.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cfa_bound {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int BM = 128;        // query rows of a tile (two warpgroups)
constexpr int BN = 64;         // keys of a tile
constexpr int NTHREADS = 384;  // two consumer warpgroups and the producer's
constexpr int NCONSUMER = 256;
constexpr int kBf16 = 0, kInt8 = 1, kFp8 = 2;  // storage codes
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
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CFA_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : CFA_D32(d)
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
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CFA_REGS32
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
  const float* c;         // [B,H,Nq] log2 score bound
  int* n_loose;           // count of loose-bound rows
  float* l_acc;           // K5: [B,H,Nq] fp32, zeroed
  float* o_acc;           // K5: [B,H,Nq,D] fp32, zeroed
  void* o;                // [B,H,Nq,D] fp32 or bf16, contiguous
  float* lse;             // [B,H,Nq]
  int H, Hkv, Nq, Nk;
  int G, Gp, R;           // group size, heads packed in a tile, rows per head
  int k_type, v_type;
  int causal, window, kv_offset, out_f32;
  int span;               // K5: key tiles per CTA
};

// Bytes of the tiles in shared memory; every tile starts on 1024 bytes.
template <int D, bool QQ>
struct Tiles {
  static constexpr int SLABS = D / 64;            // bf16 slabs of 64 columns
  static constexpr int Q = QQ ? BM * D : BM * D * 2;
  static constexpr int KV16 = BN * D * 2;          // a bf16 K or V tile
  static constexpr int CODES = BN * D;             // one-byte codes
  static constexpr int KC = QQ ? CODES : KV16;     // a K tile wgmma reads
  static constexpr int QROW = QQ ? D : 128;        // Q row bytes per slab
  static constexpr int QSWZ = QROW == 128 ? 1 : 2;
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
};

__host__ __device__ constexpr int align1k(int x) { return (x + 1023) & ~1023; }

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
// [B,Hkv,Nk,D] in boxes of 64 keys: bf16 as 64-column slabs, 128 B
// swizzled, one-byte codes whole rows unswizzled (the consumers convert
// them). strides: q, k, v, each (batch, head, row), in elements.
inline bool make_maps(Maps* m, const void* q, const void* k, const void* v,
                      int B, int H, int Hkv, int Nq, int Nk, int D,
                      const long long* st, int k_type, int v_type, int qq,
                      int Gp, int R) {
  const int qe = qq ? 1 : 2;
  bool ok = encode4(&m->q, q, qq, D, Nq, H, B, st[2] * qe, st[1] * qe,
                    st[0] * qe, qq ? D : 64, R, Gp, qq ? D : 128);
  const void* kv[2] = {k, v};
  const int types[2] = {k_type, v_type};
  CUtensorMap* maps[2] = {&m->k, &m->v};
  for (int i = 0; i < 2; ++i) {
    const bool byte = types[i] != kBf16;
    const int e = byte ? 1 : 2;
    const long long* s = st + 3 * (i + 1);
    ok = ok && encode4(maps[i], kv[i], byte, D, Nk, Hkv, B, s[2] * e,
                       s[1] * e, s[0] * e, byte ? D : 64, BN, 1,
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

// Four one-byte codes (a 32-bit word) as two bf16 pairs, exactly, on the
// integer and fp32 pipes (the hardware's cvt instructions issue at a
// fraction of their rate):
//   int8: byte b ^ 0x80 = b + 128 goes in the low mantissa bits of 2^23,
//         and 2^23 + 128 is subtracted;
//   e4m3: the sign, exponent and mantissa bits move into an fp32 (the
//         exponent's bias off by 120, subnormals onto fp32 subnormals),
//         and one multiply by 2^120 restores the value (NaN codes, which
//         no quantizer writes, come out as 480).
// The values have at most 8 significant bits: a bf16 is the fp32's upper
// half.
__device__ __forceinline__ void codes4_to_bf16(uint32_t w, int type,
                                               uint32_t& lo, uint32_t& hi) {
  float f[4];
  if (type == kInt8) {
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + k)) -
             8388736.0f;
    }
  } else {
    f[0] = __uint_as_float(((w & 0x7Fu) << 20) | ((w & 0x80u) << 24));
    f[1] = __uint_as_float(((w & 0x7F00u) << 12) | ((w & 0x8000u) << 16));
    f[2] = __uint_as_float(((w & 0x7F0000u) << 4) | ((w & 0x800000u) << 8));
    f[3] = __uint_as_float(((w & 0x7F000000u) >> 4) | (w & 0x80000000u));
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] *= 0x1p120f;
  }
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// A tile of 64 rows of D one-byte codes (dense, as TMA left them) into the
// bf16 tile wgmma reads: D/64 slabs of 64 rows x 128 B, 128 B swizzled.
// Every int8 and e4m3 value is a bf16 value: the conversion is exact.
// NT threads share the work; tid is the thread's index among them.
template <int D, int NT>
__device__ __forceinline__ void codes_to_bf16(uint8_t* dst, const uint8_t* raw,
                                              int type, int tid) {
  constexpr int CPR = D / 16;  // 16-code chunks per row
  for (int w = tid; w < BN * CPR; w += NT) {
    const int row = w / CPR, j = w % CPR;
    const uint4 codes = *reinterpret_cast<const uint4*>(raw + row * D + j * 16);
    uint32_t h[8];
    codes4_to_bf16(codes.x, type, h[0], h[1]);
    codes4_to_bf16(codes.y, type, h[2], h[3]);
    codes4_to_bf16(codes.z, type, h[4], h[5]);
    codes4_to_bf16(codes.w, type, h[6], h[7]);
    // bf16 columns 16j .. 16j + 15: slab j / 4, chunks 2(j % 4) and + 1
    uint8_t* slab = dst + (j >> 2) * (BN * 128);
    *reinterpret_cast<uint4*>(slab + swz(row, 2 * (j & 3), 128)) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(slab + swz(row, 2 * (j & 3) + 1, 128)) =
        make_uint4(h[4], h[5], h[6], h[7]);
  }
}

// The int8 K tile of quantize_q (rows of D bytes, swizzled as TMA would):
// int8 codes are copied, e4m3 codes re-gridded onto int8,
// clip(round_half_even(k · 127/448), ±127).
template <int D, int NT>
__device__ __forceinline__ void codes_to_s8(uint8_t* dst, const uint8_t* raw,
                                            int type, int tid) {
  constexpr int CPR = D / 16;
  for (int w = tid; w < BN * CPR; w += NT) {
    const int row = w / CPR, j = w % CPR;
    uint4 codes = *reinterpret_cast<const uint4*>(raw + row * D + j * 16);
    if (type == kFp8) {
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
      codes = make_uint4(q[0], q[1], q[2], q[3]);
    }
    *reinterpret_cast<uint4*>(dst + swz(row, j, D)) = codes;
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

// The two rows a consumer thread holds in wgmma's accumulator layout
// (warp w of warpgroup g: rows 64g + 16w + lane/4 and that + 8), as
// (query head, position) of the packed tile.
struct Rows {
  int pos[2];    // position, or -1 past the tile
  int head[2];   // query head
  int qp[2];     // position + kv_offset
  float c[2];    // the bound
  float f[2];    // quantize_q's factor, else 1
};

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
    r.c[hr] = ok ? a.c[(long long)(b * a.H + r.head[hr]) * a.Nq + pos] : 0.f;
    r.f[hr] = ok && a.q_factor != nullptr ? a.q_factor[b * a.H + r.head[hr]]
                                          : 1.f;
  }
  return r;
}

// Key tiles [t_begin, t_end) within [t_lo, t_hi) that positions q_lo..q_hi
// can see: causal rows see keys <= pos + kv_offset, windowed ones keys
// > pos + kv_offset − window.
__device__ __forceinline__ void visible_tiles(const Args& a, int q_lo, int q_hi,
                                              int t_lo, int t_hi, int& t_begin,
                                              int& t_end) {
  t_begin = t_lo;
  t_end = t_hi;
  if (a.causal) {
    const int kv_end = min(a.Nk, max(0, q_hi + a.kv_offset + 1));
    t_end = min(t_end, (kv_end + BN - 1) / BN);
    if (a.window > 0) {
      t_begin = max(t_begin, max(0, q_lo + a.kv_offset - a.window + 1) / BN);
    }
  }
}

// Whether every (position in q_lo..q_hi, key of the tile at c0) pair is
// visible, so that the element mask can be skipped.
__device__ __forceinline__ bool interior(const Args& a, int c0, int q_lo,
                                         int q_hi) {
  if (c0 + BN > a.Nk) return false;
  if (a.causal) {
    if (c0 + BN - 1 > q_lo + a.kv_offset) return false;
    if (a.window > 0 && c0 <= q_hi + a.kv_offset - a.window) return false;
  }
  return true;
}

// S[64x64] of this warpgroup's rows = Q · Kᵀ. q: the Q tile, k: the K tile
// (shared-memory addresses).
template <int D, bool QQ>
__device__ __forceinline__ void qk(float (&s)[32], uint32_t q, uint32_t k,
                                   int wg) {
  using T = Tiles<D, QQ>;
  if (QQ) {
    int si[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      wgmma_ss_s8(si,
                  make_desc(q + wg * 64 * D + kk * 32, 16, 8 * D, T::QSWZ),
                  make_desc(k + kk * 32, 16, 8 * D, T::QSWZ), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(si);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = (float)si[i];
  } else {
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < T::SLABS; ++sl) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_bf16(
            s,
            make_desc(q + sl * BM * 128 + wg * 64 * 128 + kk * 32, 16, 1024,
                      1),
            make_desc(k + sl * BN * 128 + kk * 32, 16, 1024, 1),
            sl + kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
  }
}

// acc[64xD] += P[64x64] · V[64xD]: P from registers (bf16 pairs in the A
// layout, which is S's accumulator layout), V MN-major from shared memory.
template <int D>
__device__ __forceinline__ void pv(float (&acc)[D / 64][32],
                                   const uint32_t (&p)[16], uint32_t v) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int sl = 0; sl < D / 64; ++sl) {
      wgmma_rs_bf16(acc[sl], &p[4 * kk],
                    make_desc(v + sl * BN * 128 + kk * 16 * 128, 1024, 1024,
                              1));
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int sl = 0; sl < D / 64; ++sl) fence_regs(acc[sl]);
}

// The bound step on this thread's 32 scores of a tile pair: p = 2^(s − c)
// (0 where masked), l += p, P = bf16(p · v_scale) packed in pairs. With
// MASKED false every pair is visible and no element is tested.
template <bool QUANT, bool QQ, bool MASKED>
__device__ __forceinline__ void bound_step(const Args& a, const Rows& r,
                                           const float (&s)[32],
                                           const float* ksc, const float* vsc,
                                           int c0, float (&l)[2],
                                           uint32_t (&p)[16]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    float pr[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = i + e;
      const int col = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      const int hr = (j >> 1) & 1;
      float x = s[j];
      if (QUANT) x *= QQ ? ksc[col] * r.f[hr] : ksc[col];
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
      pr[e] = QUANT ? pe * vsc[col] : pe;
    }
    __nv_bfloat162 pair = __floats2bfloat162_rn(pr[0], pr[1]);
    p[i >> 1] = *reinterpret_cast<uint32_t*>(&pair);
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

// One row's LSE and loose-bound test (by one lane).
__device__ __forceinline__ void finish_row(const Args& a, long long row,
                                           int pos, float l, float c) {
  a.lse[row] = l == 0.f ? kNegInf : c * kLn2 + logf(l);
  if (l < kLooseBound && provably_visible(a, pos)) atomicAdd(a.n_loose, 1);
}

// The Q-major epilogue of this thread's rows: O = acc / l (0 where l = 0),
// LSE, the loose-bound count.
template <int D>
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
      if (a.out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(a.o) + row[hr] * D +
                                   col) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.o) +
                                           row[hr] * D + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (r.pos[hr] >= 0) finish_row(a, row[hr], r.pos[hr], l[hr], r.c[hr]);
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

}  // namespace cfa_bound
