// The body shared by the two one-token decode kernels: the contiguous
// cache walk of decode.cu (K6) and the page-table walk of paged.cu (K7).
//
// Replaces: cuda_flashattention_tpu/ops/decode.py::attend_block (the
// per-block online-softmax update) and ::decode_epilogue, which the TPU
// package shares between _decode_kernel and ops/paged.py::_paged_kernel
// in the same way. A walk decides WHICH keys a CTA visits and where they
// lie; everything a key does to the softmax state is here, so the two
// kernels cannot drift apart.
//
// A CTA serves a tile of R query rows that share one KV head (the H/Hkv
// heads of a GQA group, or group x chunk rows when a prefill chunk is
// folded into the row dimension) over one split of the context; more rows
// are more CTAs over the same keys. R is 1, 4 or 8, the smallest that
// holds min(rows, 8); a tile's rows past the last live one carry q = 0
// through the walk and are dropped at the write.
//
// What bounds the kernels on the H100: bytes. A step reads the visible K
// and V of each (batch, KV head) once, 2·len·d·bytes, for 4·R·len·d flops:
// a few flops per byte, two orders of magnitude under the card's balance
// point, so the walk has to keep ~25 KB in flight per SM (Little's law at
// 3.35 TB/s and ~1 µs of latency) and spend little per key. What holds
// the tile walk back today (PERF.md §6): the consumers' latency
// within a tile (three steps and two barriers a tile, each a chain of
// shared-memory loads, shuffles and exps), which three CTAs an SM hide
// only in part, and each CTA's fixed costs (its launch, q, the partial's
// write and the merge).
//
// The split (flash-decoding): the host (ops/decode.py::split_size, from B,
// Hkv, the row tiles and d alone) cuts the context into splits of C keys:
// split s covers keys [s·C, (s+1)·C) ∩ [first, length), whatever the grid,
// the cache's capacity or the page size, so the contiguous and the paged
// walks sum the same keys in the same order and K7 gives K6's bits. A row
// tile with one live split writes O and LSE itself. With more, each
// split's CTA writes its (m, l, acc) to the call's scratch and takes a
// ticket; the last to arrive merges the live splits (below). No other
// atomic: the result does not depend on the arrival order.
//
// The tile walk (TileWalk, the rule): a CTA walks its split in key tiles
// of T keys that sit at multiples of T in the key index (tile k holds keys
// [k·T, (k+1)·T) ∩ [lo, hi)), T = 8 KB of K (32 keys at d = 128 in bf16,
// 16 at d = 256; 128 keys for rows of 64 bytes or less). One producer warp
// fills a ring of NSTAGE = 3 shared-memory stages (K, V and their scales)
// whose full barriers the copies complete, and eight consumer warps free
// each stage on its empty barrier: three CTAs an SM (≤ ~70 KB each), so up
// to ~150 KB in flight per SM against the ~25 KB Little's law asks at 3.35
// TB/s and ~1 µs of latency.
//   The copies. K6: one TMA box per tile and column part, over the cache
// viewed as [B][Hkv][max_n][d] (rows past max_n come in as zeros). K7: the
// same boxes over the pools [n_pages][Hkv][page][d], g = gcd(page, T) rows
// each, at multiples of g, so a box lies inside one page and one tile and
// a tile is the boxes of its runs of keys inside pages. A box is 16 bytes
// wider than its part of the row: TMA fills the overhang with zeros (or
// the next part's columns), which pads each key slot by one bank group so
// that the eight keys a quarter-warp reads at one column lie in eight bank
// groups. Rows whose bytes are not a multiple of 16 (d = 90 or 100 in
// bf16), bases off 16 bytes, and pages whose g slots are not a multiple of
// TMA's 128-byte alignment are copied by cp.async at 16, 8 or 4 bytes into
// the same layout; the scales always are (4 bytes a key). Rows no cp.async
// can take (their bytes not a multiple of 4: an odd d over a 2-byte cache,
// d not a multiple of 4 over a one-byte one; or a base off 4 bytes, a view
// into a cache) come in by the same warp's aligned 4-byte loads, shifted
// into place 16 bytes at a time (`copy_shifted`) and stored into the same
// slots before it arrives on the full barrier:
// the consumers see the same bytes in the same places whichever copy
// brought them, so a misaligned view gives its aligned copy's bits and K7
// stays K6's. Why boxes and
// not cp.async or one bulk copy per row: measured on the H100 (PERF.md §6),
// 16-byte cp.async copies and 64 row-sized bulk copies a tile both capped
// the copies near 15 GB/s per SM; one box a tile and part moves a lone
// CTA's tiles at ~100 GB/s (utils/decode_parts.py).
//   A key tile is scored, softmaxed and added as attend_block adds a block:
//   1. scores: the key index runs across the threads, each taking the dot
//      of its share (256 / T threads a key, summed in a fixed order in
//      step 2) of its key's 16-byte chunks from shared memory, q read as
//      warp-wide broadcasts of an fp32 copy (the int8 codes and __dp4a
//      under QQ). No shuffle chain per key; no tensor cores either: the
//      walk moves bytes, and one build serves fp32, int8 and fp8 K alike;
//   2. softmax: one warp a row takes the tile's max, one exp pass and the
//      rescale factor, l += the unrounded p, and P rounded as below;
//   3. P·V: each thread owns two of the D columns and one of 512 / D key
//      slices, reads V rows from shared memory and P as broadcasts, after
//      one rescale of its accumulator per tile.
// The key slices' accumulators add in slice order at the end of the walk.
// The merge of the splits: the last CTA loads every live split's (m, l)
// once (while they fit in shared memory), takes each row's maximum M and
// each split's weight e^(m_s − M) once per row, and each thread then sums
// its elements' partials in split order, every load independent of the
// last: two round trips to L2 instead of one CTA walking the splits for
// each element.
//

// Query and output type QT: bf16, fp16 or fp32, one per translation unit
// (decode.cu / paged.cu bf16, the *_f16.cu units fp16, the *_f32.cu units
// fp32: DecodeQ). Storage types, per array: bf16 or fp16 (under a q of the
// same type, or an fp32 q), fp32 (under an fp32 q), int8, or fp8 e4m3
// (converted by the hardware's cvt, no bit surgery), the quantized ones
// with one fp32 scale per cached token. A 2-byte cache under an fp32 q (an
// fp32 model serving over a half-size cache) widens each key and value
// exactly to fp32 and keeps P unrounded, as the JAX body computes in q's
// dtype; a bf16 or fp16 q over a cache of another float type (fp32, or the
// other 2-byte type) runs the fp32-q build on the q upcast on the host,
// exact, with P rounded to q's type (Args.p_round), which is what JAX's
// promotion computes. Numerics follow the TPU body, whose compute dtype is
// q's, or bf16 under QQ:
//   s = (q . k_q) * scale * k_scale[j]            (fp32 sum of exact products)
//   s = float(int32 q8 . k8) * (sigma_q*scale)[row] * k_scale[j]   under QQ,
//       where the int8 dot runs on __dp4a and is exact
//   per tile: m' = max(m, max_j s), alpha = e^(m − m'), p = e^(s − m'),
//   l = l·alpha + sum p (unrounded), acc = acc·alpha + sum cd(p·v_scale[j])·v_q
//       (cd: bf16 or fp16 rounds AFTER the scale; an fp32 q without QQ
//       leaves p as it is, unless p_round)
//   O = acc / l in QT, LSE = m + ln l; l = 0 gives O = 0, LSE = NEG_INF.
// Head dims: any d from 1 to 256, on the build D in {16, 32, 64, 128,
// 256} that is the smallest not below d; the cache, q and o are
// read and written at their own row width d, in place (no padded copy).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cfa_decode_body {

constexpr float kNegInf = -1e30f;
// the tile walk: consumer warps and threads, one producer warp beside
// them, ring stages
constexpr int NCW = 8;
constexpr int NCONS = NCW * 32;
constexpr int TILE_THREADS = NCONS + 32;
constexpr int NSTAGE = 3;

// Rows per CTA for `rows` query rows per KV head: 1, 4 or 8.
inline int tile_rows(int rows) { return rows == 1 ? 1 : rows <= 4 ? 4 : 8; }

// storage type codes of the C interface: fp32 pairs with an fp32 q only,
// bf16 (fp16) with a bf16 (fp16) or fp32 q, the one-byte codes with any
constexpr int kBf16 = 0, kInt8 = 1, kFp8 = 2, kF32 = 3, kF16 = 4;

// What both kernels are given besides their cache.
struct Args {
  const void* q;         // [B, Hkv*rows, d] in QT, or int8 under QQ
  const float* q_sigma;  // [B, Hkv*rows] sigma_q * scale, QQ only
  const float* k_scale;  // one fp32 per cached token, quantized only
  const float* v_scale;
  const int* lengths;    // [B]
  const int* windows;    // [B] or nullptr
  void* o;               // [B, Hkv*rows, d] in QT
  float* lse;            // [B, Hkv*rows]
  int rows;              // query rows per KV head
  int Hkv;
  float scale;
  int window;            // 0: none; with `windows`, a cap on each of them
  int split;             // C, keys per split
  int nsplit;            // splits per row tile in the grid
  float* part;           // [row tiles, nsplit, R, d + 2] fp32, or null
  int* tickets;          // [row tiles], zero before the launch, or null
  int d;                 // the row width of q, o and the cache (<= D)
  int p_round;           // fp32 q only: P rounded to bf16 (1) or fp16 (2)
  int gran;              // bytes a cp.async may copy (16, 8, 4), or 0:
                         // aligned loads shifted into place
  int tma;               // rows come in as TMA boxes (else cp.async at
                         // `gran`, or shifted loads)
  int box_rows;          // TMA: keys a box holds
};

// The build a row width d runs on: the smallest of 16, 32, 64, 128 and 256
// not below it; 0 where there is none.
__host__ __device__ constexpr int build_dim(int d) {
  return d <= 0 ? 0 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64
       : d <= 128 ? 128 : d <= 256 ? 256 : 0;
}

// The tile walk's geometry at the build D over elements of eb bytes: T keys
// a tile (128 while a row of D elements holds at most 64 bytes, else 8 KB
// of K); a row cut into np column parts of pw columns (two where a box
// of D columns and 16 bytes more would pass TMA's 256 elements), each
// landing as bw columns a row: the 16 bytes past a part (zeros past d, or
// the next part's first columns) pad its slot by one bank group, so that
// eight consecutive slots' chunk c lie in eight bank groups (a part of 16
// bytes, one bank group already, is not padded).
struct Geom {
  int T, np, pw, bw;
};
__host__ __device__ constexpr int part_cols(int D, int eb) {
  return D + 16 / eb <= 256 ? D : D / 2;
}
__host__ __device__ constexpr Geom geom(int D, int eb) {
  return Geom{D * eb <= 64 ? 128 : 8192 / (D * eb), D / part_cols(D, eb),
              part_cols(D, eb),
              part_cols(D, eb) +
                  (part_cols(D, eb) * eb / 16 % 2 == 0 ? 16 / eb : 0)};
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query so
// that the library needs no link against libcuda.
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

// A 4-D map over [n3][n2][n1] rows of d elements of eb bytes (rows d·eb
// bytes apart, a multiple of 16, the base 16-byte aligned), read in boxes
// of bw columns x `rows` rows: past d and past n1 TMA fills zeros.
inline bool encode_rows(CUtensorMap* map, const void* base, int eb,
                        long long d, long long n1, long long n2, long long n3,
                        int bw, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || d <= 0 || n1 <= 0 || n2 <= 0 || n3 <= 0) return false;
  const long long rb = d * eb;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)n1, (cuuint64_t)n2,
                              (cuuint64_t)n3};
  const cuuint64_t strides[3] = {(cuuint64_t)rb, (cuuint64_t)(rb * n1),
                                 (cuuint64_t)(rb * n1 * n2)};
  const cuuint32_t box[4] = {(cuuint32_t)bw, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map,
            eb == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
            : eb == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                      : CU_TENSOR_MAP_DATA_TYPE_UINT32,
            4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Bytes of one stored element of a storage type code.
inline int elem_bytes(int type) {
  return type == kBf16 || type == kF16 ? 2 : type == kF32 ? 4 : 1;
}

// The bytes one cp.async of the tile walk copies, for rows of d elements
// of the storage types over the bases k and v: 16, 8 or 4, the largest
// that divides the row's bytes and both bases' addresses; 0 where none
// does (the rows the producer warp copies by shifted loads).
inline int copy_granularity(int d, const void* k, int k_type, const void* v,
                            int v_type) {
  const int eb = elem_bytes(k_type);
  if (elem_bytes(v_type) != eb) return 0;
  const long long rb = (long long)d * eb;
  for (int g = 16; g >= 4; g /= 2) {
    if (rb % g == 0 && reinterpret_cast<uintptr_t>(k) % g == 0 &&
        reinterpret_cast<uintptr_t>(v) % g == 0)
      return g;
  }
  return 0;
}

// First visible key of sequence b: max(0, length - win), where win is the
// static window, the sequence's own, or the smaller of the two.
__device__ __forceinline__ int first_key(const Args& a, int b, int length) {
  if (a.windows == nullptr && a.window <= 0) return 0;
  int win = a.windows != nullptr ? a.windows[b] : a.window;
  if (a.windows != nullptr && a.window > 0) win = min(win, a.window);
  win = min(max(win, 0), length);
  return length - win;
}

// The keys [lo, hi) of split s of a walk over [first, length), and the
// live splits [s_first, s_last] (ops/decode.py::decode_splits states the
// same partition). False when this CTA has nothing to do: its split holds
// no key, unless no split does, in which case split 0 writes the empty
// rows' O = 0 and LSE = NEG_INF.
__device__ __forceinline__ bool split_keys(const Args& a, int first,
                                           int length, int s, int& lo,
                                           int& hi, int& s_first,
                                           int& s_last) {
  if (first >= length) {
    lo = hi = s_first = s_last = 0;
    return s == 0;
  }
  s_first = first / a.split;
  s_last = (length - 1) / a.split;
  if (s < s_first || s > s_last) return false;
  const long long s0 = (long long)s * a.split;
  lo = (int)max((long long)first, s0);
  hi = (int)min((long long)length, s0 + a.split);
  return true;
}

// One stored value as a float (every conversion is exact: bf16, fp16,
// int8 and e4m3 all embed in fp32).
__device__ __forceinline__ float load_val(const float* p) { return *p; }
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_val(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ float load_val(const int8_t* p) {
  return (float)*p;
}
__device__ __forceinline__ float load_val(const __nv_fp8_e4m3* p) {
  const __half_raw raw = __nv_cvt_fp8_to_halfraw(
      *reinterpret_cast<const __nv_fp8_storage_t*>(p), __NV_E4M3);
  return __half2float(__half(raw));
}

__device__ __forceinline__ float2 fp8x2_to_float2(unsigned short pair) {
  const __half2_raw raw = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair), __NV_E4M3);
  return __half22float2(__half2(raw));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// ---------------------------------------------------------------------------
// The tile walk
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
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

// One asynchronous copy of G bytes from device into shared memory: .cg
// (past L1) for 16 bytes, .ca for 8 and 4.
template <int G>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (G == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                 "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst),
                 "l"(src), "n"(G) : "memory");
  }
}

// One 4-D TMA box (coordinates innermost first) into shared memory,
// completing on `bar`.
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

// One arrival on the barrier that also expects `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

// One of the barrier's expected arrivals, made once every copy this
// thread has issued so far has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// 16 bytes into shared memory (dst 16-byte aligned).
__device__ __forceinline__ void st_shared_v4(uint32_t dst, const uint32_t* w) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(dst),
               "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]) : "memory");
}

// The consumer warps alone (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NCONS) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Byte i of w (its bits flipped by 0x80 first) as a float: 2^23 + (b ^
// 0x80) − (2^23 + 128) is the signed byte b, exactly, without an I2F.
__device__ __forceinline__ float s8_flipped(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + i)) -
         8388736.f;
}

// The 16 bytes of a K chunk as 16 / sizeof(T) floats (exact).
template <typename T>
__device__ __forceinline__ void chunk_vals(const uint4& raw, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      out[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else if constexpr (std::is_same<T, __half>::value) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    } else if constexpr (std::is_same<T, int8_t>::value) {
      const uint32_t f = w[i] ^ 0x80808080u;
#pragma unroll
      for (int e = 0; e < 4; ++e) out[4 * i + e] = s8_flipped(f, e);
    } else {
      const float2 lo = fp8x2_to_float2((unsigned short)(w[i] & 0xffffu));
      const float2 hi = fp8x2_to_float2((unsigned short)(w[i] >> 16));
      out[4 * i] = lo.x; out[4 * i + 1] = lo.y;
      out[4 * i + 2] = hi.x; out[4 * i + 3] = hi.y;
    }
  }
}

// Two consecutive stored values (an even column) as floats (exact).
__device__ __forceinline__ void pair_vals(const float* p, float& x, float& y) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  x = f.x;
  y = f.y;
}
__device__ __forceinline__ void pair_vals(const __nv_bfloat16* p, float& x,
                                          float& y) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  x = __uint_as_float(w << 16);
  y = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void pair_vals(const __half* p, float& x,
                                          float& y) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(p));
  x = f.x;
  y = f.y;
}
__device__ __forceinline__ void pair_vals(const int8_t* p, float& x,
                                          float& y) {
  const uint32_t f = *reinterpret_cast<const unsigned short*>(p) ^ 0x8080u;
  x = s8_flipped(f, 0);
  y = s8_flipped(f, 1);
}
__device__ __forceinline__ void pair_vals(const __nv_fp8_e4m3* p, float& x,
                                          float& y) {
  const float2 f = fp8x2_to_float2(*reinterpret_cast<const unsigned short*>(p));
  x = f.x;
  y = f.y;
}

// Element c of row r of the row tile starting at flat row row0: O =
// osum / lsum (0 where lsum = 0) and, once per row, LSE = mx + ln lsum
// (NEG_INF where lsum = 0).
template <typename QT>
__device__ __forceinline__ void put_out(const Args& a, long long row0, int r,
                                        int c, float mx, float lsum,
                                        float osum) {
  store(static_cast<QT*>(a.o) + (row0 + r) * a.d + c,
        lsum > 0.f ? osum / lsum : 0.f);
  if (c == 0) a.lse[row0 + r] = lsum > 0.f ? mx + logf(lsum) : kNegInf;
}

// One CTA of the tile walk (see the top of this file): its shared-memory
// layout, the producer's copies and the consumers' steps.
template <int D, typename QT, typename KT, typename VT, bool QQ, int R>
struct TileWalk {
  static constexpr int EK = sizeof(KT);
  static_assert(EK == sizeof(VT), "K and V elements of one width");
  static constexpr Geom G = geom(D, EK);
  static constexpr int T = G.T;      // keys a tile
  static constexpr int NP = G.np;    // column parts of a row
  static constexpr int PW = G.pw;    // columns of a part
  static constexpr int SP = G.bw * EK;  // bytes of a slot's part
  static constexpr int CPP = PW * EK / 16;  // 16-byte chunks of a part
  static constexpr int NCH = NP * CPP;      // chunks of a row slot
  static constexpr int E = 16 / EK;         // elements of a chunk
  static constexpr int SUB = NCONS / T;     // score threads a key
  static constexpr int KS = 2 * NCONS / D;  // key slices of P.V
  static constexpr int NK = (T + 31) / 32;  // keys a lane in the softmax
  static constexpr int OWN = (R + NCW - 1) / NCW;  // rows a warp owns
  static constexpr int EPT = (R * D + NCONS - 1) / NCONS;  // merged elements
  static constexpr bool kQuant =
      std::is_same<KT, int8_t>::value || std::is_same<KT, __nv_fp8_e4m3>::value;
  static constexpr bool kF32Q = std::is_same<QT, float>::value && !QQ;
  static constexpr bool kHalfP = !QQ && std::is_same<QT, __half>::value;
  // a stage: K, V (each [NP][T][SP]: a box of one part lands as T rows of
  // SP bytes), the keys' K and V scales
  static constexpr int ARR = NP * T * SP;
  static constexpr int SCB = 4 * T < 64 ? 64 : 4 * T;  // a scale array
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = ARR;
  static constexpr int KSC_OFF = 2 * ARR;
  static constexpr int VSC_OFF = KSC_OFF + SCB;
  static constexpr int STAGE = VSC_OFF + SCB;
  static constexpr int RING = NSTAGE * STAGE;
  // bytes the boxes of K and V bring per key they hold (all parts)
  static constexpr int TX_ROW = 2 * NP * SP;
  // then q (fp32, or the int8 codes under QQ) [R][D], the scores' partial
  // dots [SUB][R][T], P [T][R], the rows' alpha, m, l and q sigma, the
  // merge's flag, the barriers (full, then empty)
  static constexpr int Q_OFF = RING;
  static constexpr int SP_OFF = Q_OFF + (QQ ? R * D : 4 * R * D);
  static constexpr int P_OFF = SP_OFF + 4 * SUB * R * T;
  static constexpr int ROW_OFF = P_OFF + 4 * T * R;
  static constexpr int BAR_OFF = (ROW_OFF + 16 * R + 16 + 7) / 8 * 8;
  // (and 128 bytes to align the base to)
  static constexpr int BYTES = BAR_OFF + 16 * NSTAGE + 128;
  // splits whose merge weights fit at once over what the walk no longer
  // needs (the ring, q, the partial dots and P)
  static constexpr int WCH = ROW_OFF / (8 * R);
  static_assert(STAGE % 128 == 0 && (T * SP) % 128 == 0 && SP % 16 == 0 &&
                    SP_OFF % 16 == 0,
                "TMA destinations 128-byte aligned, rows 16");
  static_assert(4 * KS * R * D <= ROW_OFF, "the key slices' sums fit");
  static_assert(T * SUB == NCONS && KS * D == 2 * NCONS, "thread maps");

  // The dynamic shared memory, its base 128-byte aligned (TMA's boxes).
  static __device__ __forceinline__ unsigned char* smem_base() {
    extern __shared__ unsigned char smem_raw[];
    return smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  }

  // Where byte o of key slot j's row lies in an array of a stage.
  static __device__ __forceinline__ int at(int j, int o) {
    const int part = o / (PW * EK);
    return part * T * SP + j * SP + (o - part * PW * EK);
  }

  // The boxes of `rows` keys starting at slot `slot` (TMA, lane 0): for
  // each part, K's and V's box at coordinates (part·PW, c1, c2, c3).
  static __device__ __forceinline__ void boxes(const CUtensorMap* mk,
                                               const CUtensorMap* mv,
                                               uint32_t st, uint32_t bar,
                                               int slot, int c1, int c2,
                                               int c3) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const uint32_t off = p * T * SP + slot * SP;
      tma_load_4d(st + K_OFF + off, mk, bar, p * PW, c1, c2, c3);
      tma_load_4d(st + V_OFF + off, mv, bar, p * PW, c1, c2, c3);
    }
  }

  // n rows of rb bytes (a multiple of G), consecutive in device memory
  // from kp / vp, into key slots slot0.. of the stage at st, G bytes a
  // cp.async, the lanes over (row, piece) pairs: rows the boxes cannot
  // take (their bytes not a multiple of 16, a base off 16, pages whose
  // boxes would land off TMA's 128-byte alignment).
  template <int G>
  static __device__ __forceinline__ void copy_rows(uint32_t st, int slot0,
                                                   int n, const char* kp,
                                                   const char* vp, int rb,
                                                   int lane) {
    const int ppr = rb / G;
    int row = lane / ppr, piece = lane - row * ppr;
    const int rstep = 32 / ppr, pstep = 32 - rstep * ppr;
    for (int i = lane; i < n * ppr; i += 32) {
      const int o = piece * G;
      const int dst = at(slot0 + row, o);
      const long long src = (long long)row * rb + o;
      cp_async<G>(st + K_OFF + dst, kp + src);
      cp_async<G>(st + V_OFF + dst, vp + src);
      piece += pstep;
      row += rstep;
      if (piece >= ppr) {
        piece -= ppr;
        ++row;
      }
    }
  }

  // n rows of rb bytes, consecutive in device memory from src, into key
  // slots slot0.. of the array at arr, for rows no cp.async can take
  // (their bytes not a multiple of 4, or a base off 4 bytes): the lanes
  // over (row, 16-byte chunk of the row) pairs, four pairs a lane in
  // flight; a chunk's bytes are read as the five aligned words that cover
  // them (none past the run's last aligned 16 bytes, so no read leaves the
  // pages the run lies in), funnel-shifted into place, the bytes past the
  // row's end zeroed, and stored as one 16-byte word: the slot then holds
  // what TMA or cp.async would have put there.
  static __device__ __forceinline__ void copy_shifted(uint32_t arr,
                                                      int slot0, int n,
                                                      const char* src,
                                                      int rb, int lane) {
    constexpr int U = 4;
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(src);
    const uintptr_t lim = (a0 + (uintptr_t)n * rb + 15) & ~(uintptr_t)15;
    const int cpr = (rb + 15) / 16;  // chunks a row
    const int total = n * cpr;
    for (int i0 = lane; i0 < total; i0 += 32 * U) {
      uint32_t w[U][5];
      int sh[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + 32 * u;
        const int r = i / cpr, c = i - r * cpr;
        const uintptr_t at0 = a0 + (uintptr_t)r * rb + 16 * c;
        const uintptr_t a4 = at0 & ~(uintptr_t)3;
        sh[u] = (int)(at0 & 3) * 8;
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const uintptr_t q = a4 + 4 * k;
          w[u][k] = i < total && q < lim
                        ? __ldg(reinterpret_cast<const unsigned int*>(q))
                        : 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + 32 * u;
        if (i < total) {
          const int r = i / cpr, c = i - r * cpr;
          const int valid = rb - 16 * c;  // bytes of the row from here
          uint32_t o[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            o[k] = __funnelshift_r(w[u][k], w[u][k + 1], sh[u]);
            const int vb = valid - 4 * k;
            if (vb <= 0) {
              o[k] = 0u;
            } else if (vb < 4) {
              o[k] &= (1u << (8 * vb)) - 1u;
            }
          }
          st_shared_v4(arr + at(slot0 + r, 16 * c), o);
        }
      }
    }
  }

  // A run of n keys, contiguous in device memory (rows kr / vr, scales ks
  // / vs), into key slots slot0.. of the stage at st (the producer warp):
  // the rows by cp.async at `gran` bytes, or by aligned loads shifted into
  // place where `gran` is 0, unless they come as TMA boxes (`tma`); the
  // scales always by cp.async.
  static __device__ __forceinline__ void copy_run(const Args& a, uint32_t st,
                                                  int slot0, int n,
                                                  const KT* kr, const VT* vr,
                                                  const float* ks,
                                                  const float* vs, int lane) {
    const char* kp = reinterpret_cast<const char*>(kr);
    const char* vp = reinterpret_cast<const char*>(vr);
    const int rb = a.d * EK;
    if (!a.tma) {
      if (a.gran == 16) {
        copy_rows<16>(st, slot0, n, kp, vp, rb, lane);
      } else if (a.gran == 8) {
        copy_rows<8>(st, slot0, n, kp, vp, rb, lane);
      } else if (a.gran == 4) {
        copy_rows<4>(st, slot0, n, kp, vp, rb, lane);
      } else {
        copy_shifted(st + K_OFF, slot0, n, kp, rb, lane);
        copy_shifted(st + V_OFF, slot0, n, vp, rb, lane);
      }
    }
    if constexpr (kQuant) {
      for (int i = lane; i < n; i += 32) {
        cp_async<4>(st + KSC_OFF + 4 * (slot0 + i), ks + i);
        cp_async<4>(st + VSC_OFF + 4 * (slot0 + i), vs + i);
      }
    }
  }

  // The CTA's walk over keys [lo, hi) of its split and its writes (O and
  // LSE, or the split's partial and, for the last split to arrive, the
  // merge). produce(st, bar, j0, j1, t0, lane): the producer warp's copies
  // of keys [j0, j1) of the tile starting at key t0 into the stage at st,
  // completing on its full barrier bar.
  template <class Produce>
  static __device__ __forceinline__ void run(const Args& a, int b, int hk,
                                             int tile, int lo, int hi,
                                             long long tile_id, int s,
                                             int s_first, int s_last,
                                             Produce& produce) {
    unsigned char* smem = smem_base();
    const int tid = threadIdx.x;
    const int d = a.d;
    const uint32_t sbase = smem_u32(smem);
    const uint32_t full0 = sbase + BAR_OFF, empty0 = full0 + 8 * NSTAGE;
    const int nrows = min(R, a.rows - tile * R);
    const long long row0 =
        ((long long)b * a.Hkv + hk) * a.rows + (long long)tile * R;
    const int k0 = lo / T;
    const int ntiles = lo < hi ? (hi - 1) / T - k0 + 1 : 0;
    float* rowm = reinterpret_cast<float*>(smem + ROW_OFF);
    float* rowl = rowm + R;
    float* alpha_s = rowl + R;
    float* qsig = alpha_s + R;
    int* flag = reinterpret_cast<int*>(qsig + R);

    if (tid == 0) {
      for (int i = 0; i < NSTAGE; ++i) {
        mbar_init(full0 + 8 * i, 33);  // the 32 lanes' arrivals + expect_tx
        mbar_init(empty0 + 8 * i, NCW);
      }
    }
    // a row that ends inside a chunk: the chunk's bytes past it stay zero
    // in every stage (no copy writes them), so they add nothing to a dot
    if ((d * EK) % 16 != 0) {
      for (int i = tid; i < NSTAGE * ARR / 16; i += TILE_THREADS) {
        const int st = i / (ARR / 16);
        *reinterpret_cast<uint4*>(smem + st * STAGE + K_OFF +
                                  16 * (i - st * ARR / 16)) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __syncthreads();

    if (tid >= NCONS) {  // the producer warp: its copies start at once
      const int lane = tid - NCONS;
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % NSTAGE;
        if (t >= NSTAGE) mbar_wait(empty0 + 8 * st, (t / NSTAGE - 1) & 1);
        const int t0 = (k0 + t) * T;
        produce(sbase + st * STAGE, full0 + 8 * st, max(lo, t0),
                min(hi, t0 + T), t0, lane);
        if (a.gran != 0) {
          cp_async_arrive(full0 + 8 * st);
        } else {
          // shifted copies: the lane's stores and its scales' cp.async
          // land before its arrival, which releases them to the consumers
          cp_async_wait_all();
          mbar_arrive(full0 + 8 * st);
        }
      }
      cp_async_wait_all();
      return;
    }

    // q in shared memory, zeros past d and past the live rows
    for (int i = tid; i < R * D; i += NCONS) {
      const int r = i / D, c = i % D;
      const bool in = r < nrows && c < d;
      if constexpr (QQ) {
        reinterpret_cast<int8_t*>(smem + Q_OFF)[i] =
            in ? static_cast<const int8_t*>(a.q)[(row0 + r) * d + c] : 0;
      } else {
        reinterpret_cast<float*>(smem + Q_OFF)[i] =
            in ? load_val(static_cast<const QT*>(a.q) + (row0 + r) * d + c)
               : 0.f;
      }
    }
    if (tid < R) qsig[tid] = QQ && tid < nrows ? a.q_sigma[row0 + tid] : 0.f;
    consumer_sync();

    const int warp = tid / 32, lane = tid % 32;
    const int nch = (d * EK + 15) / 16;
    const float* qf = reinterpret_cast<const float*>(smem + Q_OFF);
    const int8_t* q8 = reinterpret_cast<const int8_t*>(smem + Q_OFF);
    float* sp = reinterpret_cast<float*>(smem + SP_OFF);
    float* pm = reinterpret_cast<float*>(smem + P_OFF);
    float m_own[OWN], l_own[OWN];
#pragma unroll
    for (int o = 0; o < OWN; ++o) {
      m_own[o] = kNegInf;
      l_own[o] = 0.f;
    }
    // P.V: this thread's two columns and key slice
    const int cpair = tid % (D / 2), ksl = tid / (D / 2);
    const int c2 = 2 * cpair;
    float acc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;
    // scores: this thread's key slot and share of its chunks
    const int js = tid % T, qsl = tid / T;

    for (int t = 0; t < ntiles; ++t) {
      const int st = t % NSTAGE;
      mbar_wait(full0 + 8 * st, (t / NSTAGE) & 1);
      const int t0 = (k0 + t) * T;
      const int ja = max(lo, t0) - t0, jb = min(hi, t0 + T) - t0;
      const unsigned char* stage = smem + st * STAGE;

      // 1. partial dots of the live keys
      if (js >= ja && js < jb) {
        const unsigned char* kst = stage + K_OFF + js * SP;
        if constexpr (QQ) {
          int part[R];
#pragma unroll
          for (int r = 0; r < R; ++r) part[r] = 0;
#pragma unroll
          for (int i = 0; i < (NCH + SUB - 1) / SUB; ++i) {
            const int c = qsl + SUB * i;
            if (c < nch) {
              const uint4 raw = *reinterpret_cast<const uint4*>(
                  kst + (c / CPP) * T * SP + 16 * (c % CPP));
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const int4 qw =
                    *reinterpret_cast<const int4*>(q8 + r * D + 16 * c);
                part[r] = __dp4a(qw.x, (int)raw.x, part[r]);
                part[r] = __dp4a(qw.y, (int)raw.y, part[r]);
                part[r] = __dp4a(qw.z, (int)raw.z, part[r]);
                part[r] = __dp4a(qw.w, (int)raw.w, part[r]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < R; ++r)
            reinterpret_cast<int*>(sp)[(qsl * R + r) * T + js] = part[r];
        } else {
          float part[R];
#pragma unroll
          for (int r = 0; r < R; ++r) part[r] = 0.f;
#pragma unroll
          for (int i = 0; i < (NCH + SUB - 1) / SUB; ++i) {
            const int c = qsl + SUB * i;
            if (c < nch) {
              float kv[E];
              chunk_vals<KT>(*reinterpret_cast<const uint4*>(
                                 kst + (c / CPP) * T * SP + 16 * (c % CPP)),
                             kv);
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const float4* qp =
                    reinterpret_cast<const float4*>(qf + r * D + E * c);
#pragma unroll
                for (int e = 0; e < E / 4; ++e) {
                  const float4 qv = qp[e];
                  part[r] = fmaf(qv.x, kv[4 * e], part[r]);
                  part[r] = fmaf(qv.y, kv[4 * e + 1], part[r]);
                  part[r] = fmaf(qv.z, kv[4 * e + 2], part[r]);
                  part[r] = fmaf(qv.w, kv[4 * e + 3], part[r]);
                }
              }
            }
          }
#pragma unroll
          for (int r = 0; r < R; ++r) sp[(qsl * R + r) * T + js] = part[r];
        }
      }
      consumer_sync();

      // 2. one max, one exp pass and the rescale factor per row
      const float* ksc = reinterpret_cast<const float*>(stage + KSC_OFF);
      const float* vsc = reinterpret_cast<const float*>(stage + VSC_OFF);
#pragma unroll
      for (int o = 0; o < OWN; ++o) {
        const int rr = warp + NCW * o;
        if (rr < R) {
          float sv[NK];
          float mx = kNegInf;
#pragma unroll
          for (int i = 0; i < NK; ++i) {
            const int j = lane + 32 * i;
            float sc = kNegInf;
            if (j < T && j >= ja && j < jb) {
              if constexpr (QQ) {
                int dot = 0;
#pragma unroll
                for (int q = 0; q < SUB; ++q)
                  dot += reinterpret_cast<const int*>(sp)[(q * R + rr) * T + j];
                sc = (float)dot * qsig[rr];
              } else {
                float dsum = 0.f;
#pragma unroll
                for (int q = 0; q < SUB; ++q) dsum += sp[(q * R + rr) * T + j];
                sc = dsum * a.scale;
              }
              if constexpr (kQuant) sc *= ksc[j];
            }
            sv[i] = sc;
            mx = fmaxf(mx, sc);
          }
          mx = warp_max(mx);
          const float m_next = fmaxf(m_own[o], mx);
          const float alpha = __expf(m_own[o] - m_next);
          float psum = 0.f;
#pragma unroll
          for (int i = 0; i < NK; ++i) {
            const int j = lane + 32 * i;
            if (j < T && j >= ja && j < jb) {
              const float p = __expf(sv[i] - m_next);
              psum += p;
              // P weights V in the compute dtype, after the V scale
              const float pv = kQuant ? p * vsc[j] : p;
              float pr;
              if constexpr (kF32Q) {
                pr = a.p_round == 1   ? __bfloat162float(__float2bfloat16(pv))
                     : a.p_round == 2 ? __half2float(__float2half_rn(pv))
                                      : pv;
              } else if constexpr (kHalfP) {
                pr = __half2float(__float2half_rn(pv));
              } else {
                pr = __bfloat162float(__float2bfloat16(pv));
              }
              pm[j * R + rr] = pr;
            }
          }
          psum = warp_sum(psum);
          l_own[o] = l_own[o] * alpha + psum;
          m_own[o] = m_next;
          if (lane == 0) alpha_s[rr] = alpha;
        }
      }
      consumer_sync();

      // 3. acc = acc * alpha + P.V over this thread's key slice
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float al = alpha_s[r];
        acc[r][0] *= al;
        acc[r][1] *= al;
      }
      if (c2 < d) {
        const unsigned char* vcol = stage + V_OFF + at(0, c2 * EK);
        // unrolled: four keys' loads in flight, the sums in key order
#pragma unroll 4
        for (int j = ja + ((ksl - ja) & (KS - 1)); j < jb; j += KS) {
          float v0, v1;
          pair_vals(reinterpret_cast<const VT*>(vcol + j * SP), v0, v1);
          float p[R];
          if constexpr (R % 4 == 0) {
#pragma unroll
            for (int r = 0; r < R; r += 4) {
              const float4 f = *reinterpret_cast<const float4*>(pm + j * R + r);
              p[r] = f.x; p[r + 1] = f.y; p[r + 2] = f.z; p[r + 3] = f.w;
            }
          } else {
#pragma unroll
            for (int r = 0; r < R; ++r) p[r] = pm[j * R + r];
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][0] = fmaf(p[r], v0, acc[r][0]);
            acc[r][1] = fmaf(p[r], v1, acc[r][1]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
    consumer_sync();  // every stage consumed: the ring is free

    // the rows' (m, l); the key slices' sums over the ring
#pragma unroll
    for (int o = 0; o < OWN; ++o) {
      const int rr = warp + NCW * o;
      if (rr < R && lane == 0) {
        rowm[rr] = m_own[o];
        rowl[rr] = l_own[o];
      }
    }
    float* buf = reinterpret_cast<float*>(smem);  // [KS][R][D], over the ring
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (c2 < d) buf[(ksl * R + r) * D + c2] = acc[r][0];
      if (c2 + 1 < d) buf[(ksl * R + r) * D + c2 + 1] = acc[r][1];
    }
    consumer_sync();
    const bool alone = s_first == s_last;
    float* mine =
        alone ? nullptr : a.part + (tile_id * a.nsplit + s) * R * (d + 2);
    for (int i = tid; i < nrows * d; i += NCONS) {
      const int r = i / d, c = i - r * d;
      float osum = 0.f;
#pragma unroll
      for (int k = 0; k < KS; ++k) osum += buf[(k * R + r) * D + c];
      if (alone) {
        put_out<QT>(a, row0, r, c, rowm[r], rowl[r], osum);
      } else {
        mine[r * (d + 2) + 2 + c] = osum;
        if (c == 0) {
          mine[r * (d + 2)] = rowm[r];
          mine[r * (d + 2) + 1] = rowl[r];
        }
      }
    }
    if (alone) return;
    merge(a, tile_id, s_first, s_last, nrows, row0, flag, rowm, rowl);
  }

  // The split's partial is visible before its ticket is taken; the last of
  // the live splits to take one merges them: the rows' maxima M (warps
  // over rows, lanes over splits), each split's weight e^(m_s − M) once
  // per row into shared memory, l = the weighted l_s added in split order
  // by one thread a row, and each thread's elements summed over the
  // splits in split order, their loads independent of one another.
  static __device__ __forceinline__ void merge(const Args& a,
                                               long long tile_id,
                                               int s_first, int s_last,
                                               int nrows, long long row0,
                                               int* flag, float* rowm,
                                               float* rowl) {
    unsigned char* smem = smem_base();
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int d = a.d;
    __threadfence();
    consumer_sync();
    if (tid == 0) *flag = atomicAdd(a.tickets + tile_id, 1) == s_last - s_first;
    consumer_sync();
    if (!*flag) return;
    __threadfence();
    const float* parts = a.part + tile_id * a.nsplit * R * (d + 2) +
                         (long long)s_first * R * (d + 2);
    const int ns = s_last - s_first + 1;
    // (m, l) of a chunk of splits, then their weights and weighted l, in
    // place: [WCH][R] each, over what the walk no longer needs
    float* w = reinterpret_cast<float*>(smem);
    float* wl = w + WCH * R;
    auto load = [&](int base, int n) {
      for (int i = tid; i < n * nrows; i += NCONS) {
        const int t = i / nrows, r = i - t * nrows;
        const float* p = parts + ((long long)(base + t) * R + r) * (d + 2);
        w[t * R + r] = __ldcg(p);
        wl[t * R + r] = __ldcg(p + 1);
      }
    };
    // the rows' maxima: from the loaded (m, l) when every split fits at
    // once (one round trip for both), else from device memory
    const bool whole = ns <= WCH;
    if (whole) {
      load(0, ns);
      consumer_sync();
    }
    for (int r = warp; r < nrows; r += NCW) {
      float mx = kNegInf;
      for (int t = lane; t < ns; t += 32)
        mx = fmaxf(mx, whole ? w[t * R + r]
                             : __ldcg(parts + ((long long)t * R + r) *
                                                  (d + 2)));
      mx = warp_max(mx);
      if (lane == 0) {
        rowm[r] = mx;
        rowl[r] = 0.f;
      }
    }
    consumer_sync();
    float osum[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) osum[e] = 0.f;
    for (int base = 0; base < ns; base += WCH) {
      const int n = min(WCH, ns - base);
      if (!whole) {
        load(base, n);
        consumer_sync();
      }
      for (int i = tid; i < n * nrows; i += NCONS) {
        const int t = i / nrows, r = i - t * nrows;
        const float lt = wl[t * R + r];
        // a split that saw no key has l = 0 and contributes nothing
        const float wt = lt > 0.f ? __expf(w[t * R + r] - rowm[r]) : 0.f;
        w[t * R + r] = wt;
        wl[t * R + r] = lt * wt;
      }
      consumer_sync();
      if (tid < nrows) {
        float l = rowl[tid];
        for (int t = 0; t < n; ++t) l += wl[t * R + tid];
        rowl[tid] = l;
      }
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int i = tid + NCONS * e;
        if (i < nrows * d) {
          const int r = i / d, c = i - r * d;
          const float* p =
              parts + ((long long)base * R + r) * (d + 2) + 2 + c;
          float o = osum[e];
#pragma unroll 8
          for (int t = 0; t < n; ++t)
            o += __ldcg(p + (long long)t * R * (d + 2)) * w[t * R + r];
          osum[e] = o;
        }
      }
      consumer_sync();
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = tid + NCONS * e;
      if (i < nrows * d) {
        const int r = i / d, c = i - r * d;
        put_out<QT>(a, row0, r, c, rowm[r], rowl[r], osum[e]);
      }
    }
    if (tid == 0) a.tickets[tile_id] = 0;  // for the next launch
  }
};

// Raises a kernel's dynamic shared memory limit to `bytes` once per
// device: `done`, the caller's own static for that kernel, holds a bit per
// device already set (two host threads racing set it twice, harmlessly).
template <typename K>
inline cudaError_t allow_smem(K* kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit != 0 && (__atomic_load_n(&done, __ATOMIC_ACQUIRE) & bit)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) __atomic_fetch_or(&done, bit, __ATOMIC_RELEASE);
  return err;
}

// The split of a call over a cache of `cap` tokens per sequence: C keys a
// split, ceil(cap / C) splits per row tile in the grid (the partition is
// C's alone; cap only sizes the grid), and the scratch with its tickets
// zeroed on the stream when there is more than one.
inline cudaError_t prepare_split(Args* a, int B, long long cap, int split,
                                 void* part, void* tickets,
                                 cudaStream_t stream) {
  if (split <= 0) return cudaErrorInvalidValue;
  const long long n = cap > 0 ? (cap + split - 1) / split : 1;
  const int r = tile_rows(a->rows);
  const long long tiles = (a->rows + r - 1) / r;
  if (n * tiles > 0x7fffffffll) return cudaErrorInvalidValue;
  a->split = split;
  a->nsplit = (int)n;
  a->part = static_cast<float*>(part);
  a->tickets = static_cast<int*>(tickets);
  if (n == 1) return cudaSuccess;
  if (part == nullptr || tickets == nullptr) return cudaErrorInvalidValue;
  return cudaMemsetAsync(tickets, 0, (size_t)B * a->Hkv * tiles * sizeof(int),
                         stream);
}

// The (K, V) storage pairs built for q type QT: one type for both arrays,
// or int8 K with fp8 V; a float cache of q's own type, or under an fp32 q
// any float cache; QQ on int8 K only.
template <typename QT>
inline bool valid_types(int kt, int vt, int qq) {
  const bool f32q = std::is_same<QT, float>::value;
  const int own = std::is_same<QT, __half>::value ? kF16
                  : f32q                          ? kF32
                                                  : kBf16;
  const bool pair = (kt == vt && (kt == own || kt == kInt8 || kt == kFp8 ||
                                  (f32q && (kt == kBf16 || kt == kF16)))) ||
                    (kt == kInt8 && vt == kFp8);
  return pair && (!qq || kt == kInt8);
}

// The cache types a translation unit builds: the int8-K caches (int8, and
// int8 K with fp8 V, each with and without QQ) in the *_i8.cu units
// (CFA_DECODE_I8, entry points `..._i8`), the float and fp8 caches in the
// others. Two units a q type, so that no unit's nvcc holds the build up.
#if defined(CFA_DECODE_I8)
constexpr bool kI8Unit = true;
#else
constexpr bool kI8Unit = false;
#endif

// Calls L<D, QT, KT, VT, QQ, R>::run(args...) for the q type, storage
// types, head dim and row tile asked for; cudaErrorInvalidValue for a
// combination that is not built (in this unit).
template <template <int, typename, typename, typename, bool, int> class L,
          int D, typename QT, int R, typename... A>
cudaError_t dispatch_types(int kt, int vt, int qq, A... args) {
  using bf16 = __nv_bfloat16;
  using fp8 = __nv_fp8_e4m3;
  if constexpr (kI8Unit) {
    if (kt != kInt8) return cudaErrorInvalidValue;
    if (vt == kInt8)
      return qq ? L<D, QT, int8_t, int8_t, true, R>::run(args...)
                : L<D, QT, int8_t, int8_t, false, R>::run(args...);
    return qq ? L<D, QT, int8_t, fp8, true, R>::run(args...)
              : L<D, QT, int8_t, fp8, false, R>::run(args...);
  } else {
    if constexpr (std::is_same<QT, float>::value) {
      if (kt == kF32) return L<D, QT, float, float, false, R>::run(args...);
      if (kt == kF16) return L<D, QT, __half, __half, false, R>::run(args...);
      if (kt == kBf16) return L<D, QT, bf16, bf16, false, R>::run(args...);
    } else if constexpr (std::is_same<QT, __half>::value) {
      if (kt == kF16) return L<D, QT, __half, __half, false, R>::run(args...);
    } else {
      if (kt == kBf16) return L<D, QT, bf16, bf16, false, R>::run(args...);
    }
    if (kt == kFp8) return L<D, QT, fp8, fp8, false, R>::run(args...);
    return cudaErrorInvalidValue;
  }
}

template <template <int, typename, typename, typename, bool, int> class L,
          int D, typename QT, typename... A>
cudaError_t dispatch_rows(int rows, int kt, int vt, int qq, A... args) {
  switch (tile_rows(rows)) {
    case 1: return dispatch_types<L, D, QT, 1>(kt, vt, qq, args...);
    case 4: return dispatch_types<L, D, QT, 4>(kt, vt, qq, args...);
    default: return dispatch_types<L, D, QT, 8>(kt, vt, qq, args...);
  }
}

template <template <int, typename, typename, typename, bool, int> class L,
          typename QT, typename... A>
cudaError_t dispatch_dim(int d, int rows, int kt, int vt, int qq,
                         A... args) {
  switch (build_dim(d)) {
    case 16: return dispatch_rows<L, 16, QT>(rows, kt, vt, qq, args...);
    case 32: return dispatch_rows<L, 32, QT>(rows, kt, vt, qq, args...);
    case 64: return dispatch_rows<L, 64, QT>(rows, kt, vt, qq, args...);
    case 128: return dispatch_rows<L, 128, QT>(rows, kt, vt, qq, args...);
    case 256: return dispatch_rows<L, 256, QT>(rows, kt, vt, qq, args...);
    default: return cudaErrorInvalidValue;
  }
}

// d: the row width, 1 to 256 (the build is build_dim(d)); QT: the
// translation unit's q type.
template <template <int, typename, typename, typename, bool, int> class L,
          typename QT, typename... A>
cudaError_t dispatch(int d, int rows, int kt, int vt, int qq, A... args) {
  if (!valid_types<QT>(kt, vt, qq)) return cudaErrorInvalidValue;
  return dispatch_dim<L, QT>(d, rows, kt, vt, qq, args...);
}

// The q type of this translation unit (decode.cu, paged.cu and their
// *_i8.cu units: bf16; the *_f16*.cu units fp16, the *_f32*.cu units
// fp32).
#if defined(CFA_DECODE_F32)
typedef float DecodeQ;
#elif defined(CFA_DECODE_F16)
typedef __half DecodeQ;
#else
typedef __nv_bfloat16 DecodeQ;
#endif

}  // namespace cfa_decode_body
