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
// are more CTAs over the same keys. The row count is a run-time value; R is
// 1, 4 or 8, the smallest that holds min(rows, 8). The row loops are fully
// unrolled over R with no branch inside them, so the state stays in
// registers and the rows' shuffle chains overlap: a tile's rows past the
// last live one carry q = 0 through the walk and are dropped at the write.
// Why three tiles and not the 8-row one alone, on an H100 at 700 W with a
// cold L2 (before the split): for one row per KV head the 1-row tile walked
// 640 contiguous keys in 0.084 ms where the 8-row tile took 0.125; for four
// rows (the serving model's GQA group) the paged walk over 4224 keys took
// 0.79 ms with the 4-row tile and 0.98 ms with the 8-row one. Each of the
// CTA's NWARPS warps visits its own share of the split's keys; a lane owns
// max(1, D/32) consecutive elements of the head dim, a score is a
// warp-shuffle sum of the lanes' partial dots, and the warps' partial
// (m, l, acc) states merge once in shared memory.
//
// The split (flash-decoding): at a serving batch B·Hkv·row tiles CTAs leave
// most of the card's 132 SMs idle and each warp's walk is latency-bound,
// so the host (ops/decode.py::split_size, from B, Hkv, the row tiles and d
// alone) may cut the context into splits of C keys: split s covers keys
// [s·C, (s+1)·C) ∩ [first, length), and key j of it goes to warp (j − lo)
// mod NWARPS, lo being the split's first live key. The partition depends
// on the key index only, never on the grid, the cache's capacity or the
// order in which CTAs run, so the contiguous and the paged walks sum the
// same keys in the same order. A row tile with one live split writes O and
// LSE itself. With more, each split's CTA writes its merged (m, l, acc) to
// the call's scratch and takes a ticket; the last to arrive merges the
// live splits in split order with the weights of the warps' merge, writes
// O and LSE, and resets the ticket. No other atomic: the result does not
// depend on the arrival order.

// Query and output type QT: bf16, fp16 or fp32, one per translation unit
// (decode.cu / paged.cu bf16, the *_f16.cu units fp16, the *_f32.cu units
// fp32: DECODE_QT). Storage types, per array: bf16 or fp16 (under a q of
// the same type, or an fp32 q), fp32 (under an fp32 q), int8, or fp8 e4m3
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
//   p = exp(s - m); l sums the unrounded p
//   acc += cd(p * v_scale[j]) * v_q  (cd: bf16 or fp16 rounds AFTER the
//                                     scale; an fp32 q without QQ leaves p
//                                     as it is, unless p_round)
//   O = acc / l in QT, LSE = m + ln l; l = 0 gives O = 0, LSE = NEG_INF.
// Head dims: any d from 1 to 256, run on the build D in {16, 32, 64, 128,
// 256} that is the smallest not below d. A lane owns N = max(1, D/32)
// consecutive elements of [0, D), and only those below d are real: the
// cache, q and o are read and written at their own row width d, in place
// (no padded copy), so a lane whose elements all lie at or past d (at D =
// 16 lanes 16-31 always) never loads, carries zeros through the shuffle
// sums and writes nothing. Where d is a multiple of N and every array is
// aligned to N elements (`Args.vec`) a lane reads its elements in one
// vector load; otherwise (d = 90 in bf16, say) one element at a time, each
// tested against d.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cfa_decode_body {

constexpr float kNegInf = -1e30f;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

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
  int vec;               // whole-vector loads of a lane's N elements
  int p_round;           // fp32 q only: P rounded to bf16 (1) or fp16 (2)
};

// The build a row width d runs on: the smallest of 16, 32, 64, 128 and 256
// not below it; 0 where there is none.
__host__ __device__ constexpr int build_dim(int d) {
  return d <= 0 ? 0 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64
       : d <= 128 ? 128 : d <= 256 ? 256 : 0;
}

// Bytes of one stored element of a storage type code.
inline int elem_bytes(int type) {
  return type == kBf16 || type == kF16 ? 2 : type == kF32 ? 4 : 1;
}

// Whether a lane's N elements of every row may be read in one vector load:
// d a multiple of N (so a lane's elements lie all below d or all past it)
// and each array's base aligned to N of its elements (rows of d elements
// then keep that alignment).
inline int vector_loads(int d, const void* q, int q_bytes, const void* k,
                        int k_type, const void* v, int v_type) {
  const int D = build_dim(d);
  const int n = D >= 32 ? D / 32 : 1;
  auto aligned = [n](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % (uintptr_t)(n * bytes) == 0;
  };
  return d % n == 0 && aligned(q, q_bytes) && aligned(k, elem_bytes(k_type)) &&
         aligned(v, elem_bytes(v_type));
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

// N consecutive stored values (N = 1, 2, 4 or 8) as floats, in one load
// (two float4s for eight fp32). Every conversion is exact: bf16, int8 and
// e4m3 all embed in fp32.
template <int N>
__device__ __forceinline__ void load_vals(const float* p, float* out) {
  if constexpr (N == 8) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    const float4 g = *reinterpret_cast<const float4*>(p + 4);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
    out[4] = g.x; out[5] = g.y; out[6] = g.z; out[7] = g.w;
  } else if constexpr (N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    out[0] = f.x; out[1] = f.y;
  } else {
    out[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 fa =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 fb =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = fa.x; out[1] = fa.y; out[2] = fb.x; out[3] = fb.y;
  } else if constexpr (N == 2) {
    const float2 fa =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = fa.x; out[1] = fa.y;
  } else {
    out[0] = __bfloat162float(*p);
  }
}

template <int N>
__device__ __forceinline__ void load_vals(const __half* p, float* out) {
  if constexpr (N == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 fa =
        __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
    const float2 fb =
        __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
    out[0] = fa.x; out[1] = fa.y; out[2] = fb.x; out[3] = fb.y;
  } else if constexpr (N == 2) {
    const float2 fa = __half22float2(*reinterpret_cast<const __half2*>(p));
    out[0] = fa.x; out[1] = fa.y;
  } else {
    out[0] = __half2float(*p);
  }
}

template <int N>
__device__ __forceinline__ void load_vals(const int8_t* p, float* out) {
  if constexpr (N == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const unsigned int w[2] = {raw.x, raw.y};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      out[i] = (float)(signed char)((w[i >> 2] >> (8 * (i & 3))) & 0xffu);
    }
  } else if constexpr (N == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = (float)c.x; out[1] = (float)c.y;
    out[2] = (float)c.z; out[3] = (float)c.w;
  } else if constexpr (N == 2) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    out[0] = (float)c.x; out[1] = (float)c.y;
  } else {
    out[0] = (float)*p;
  }
}

__device__ __forceinline__ float2 fp8x2_to_float2(unsigned short pair) {
  const __half2_raw raw = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair), __NV_E4M3);
  return __half22float2(__half2(raw));
}

template <int N>
__device__ __forceinline__ void load_vals(const __nv_fp8_e4m3* p, float* out) {
  if constexpr (N == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const unsigned int w[2] = {raw.x, raw.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 fa = fp8x2_to_float2((unsigned short)(w[i] & 0xffffu));
      const float2 fb = fp8x2_to_float2((unsigned short)(w[i] >> 16));
      out[4 * i + 0] = fa.x; out[4 * i + 1] = fa.y;
      out[4 * i + 2] = fb.x; out[4 * i + 3] = fb.y;
    }
  } else if constexpr (N == 4) {
    const unsigned int w = *reinterpret_cast<const unsigned int*>(p);
    const float2 fa = fp8x2_to_float2((unsigned short)(w & 0xffffu));
    const float2 fb = fp8x2_to_float2((unsigned short)(w >> 16));
    out[0] = fa.x; out[1] = fa.y; out[2] = fb.x; out[3] = fb.y;
  } else if constexpr (N == 2) {
    const float2 fa =
        fp8x2_to_float2(*reinterpret_cast<const unsigned short*>(p));
    out[0] = fa.x; out[1] = fa.y;
  } else {
    const __half_raw raw = __nv_cvt_fp8_to_halfraw(
        *reinterpret_cast<const __nv_fp8_storage_t*>(p), __NV_E4M3);
    out[0] = __half2float(__half(raw));
  }
}

// N consecutive int8 (N <= 4) packed into the low bytes of a word (for
// __dp4a; the bytes above N are zero and add nothing to the dot).
template <int N>
__device__ __forceinline__ int load_word(const int8_t* p) {
  if constexpr (N == 4) {
    return *reinterpret_cast<const int*>(p);
  } else if constexpr (N == 2) {
    return (int)*reinterpret_cast<const unsigned short*>(p);
  } else {
    return (int)*reinterpret_cast<const unsigned char*>(p);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// The online-softmax state of one warp for the CTA's row tile.
template <int D, typename QT, typename KT, typename VT, bool QQ, int ROWS>
struct Body {
  static constexpr int N = D >= 32 ? D / 32 : 1;  // d-elements a lane owns
  static constexpr int NW = (N + 3) / 4;  // words of a lane's int8 codes
  static constexpr int WN = N < 4 ? N : 4;  // codes in each word
  static constexpr bool kQuant =
      std::is_same<KT, int8_t>::value || std::is_same<KT, __nv_fp8_e4m3>::value;
  // P is rounded to the compute dtype before P.V: bf16 for a bf16 q and
  // under QQ, fp16 for an fp16 q; an fp32 q keeps it unless p_round says
  // (a 2-byte q upcast)
  static constexpr bool kF32Q = std::is_same<QT, float>::value && !QQ;
  static constexpr bool kHalfP = !QQ && std::is_same<QT, __half>::value;
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "head dim");
  static_assert(std::is_same<QT, float>::value ||
                    std::is_same<QT, __nv_bfloat16>::value ||
                    std::is_same<QT, __half>::value,
                "q is bf16, fp16 or fp32");
  static_assert(!QQ || std::is_same<KT, int8_t>::value,
                "the int8 Q.K dot needs int8 keys");
  static_assert(!std::is_same<KT, float>::value ||
                    std::is_same<QT, float>::value,
                "an fp32 cache is read under an fp32 q");

  float qf[ROWS][N];  // the rows' q slices (unused under QQ)
  int q8[ROWS][NW];   // the same as packed int8 (QQ)
  float qs[ROWS];     // sigma_q * scale per row (QQ)
  float m[ROWS], l[ROWS], acc[ROWS][N];
  int nrows;          // live rows of this tile
  long long row0;     // flat index of the tile's first row in q, o, lse
  int c0;             // this lane's first d-element
  int d;              // the row width (Args.d)
  bool vec;           // whole-vector loads (Args.vec)
  int p_round;        // Args.p_round (fp32 q)

  // Whether this lane owns elements below d.
  __device__ __forceinline__ bool owns() const { return c0 < d; }

  // This lane's N elements of a row (zeros past d).
  template <typename T>
  __device__ __forceinline__ void load(const T* row, float* out) const {
    if (vec) {
      load_vals<N>(row + c0, out);
    } else {
#pragma unroll
      for (int c = 0; c < N; ++c) {
        out[c] = 0.f;
        if (c0 + c < d) load_vals<1>(row + c0 + c, out + c);
      }
    }
  }

  // This lane's N int8 codes of a row, WN to a word (zero bytes past d).
  __device__ __forceinline__ void load_words(const int8_t* row,
                                             int (&w)[NW]) const {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int c = c0 + 4 * i;
      if (vec) {
        w[i] = load_word<WN>(row + c);
      } else {
        w[i] = 0;
#pragma unroll
        for (int e = 0; e < WN; ++e) {
          if (c + e < d) w[i] |= (int)(unsigned char)row[c + e] << (8 * e);
        }
      }
    }
  }

  __device__ __forceinline__ void init(const Args& a, int b, int hk,
                                       int tile) {
    const int lane = threadIdx.x % 32;
    c0 = lane * N;
    d = a.d;
    vec = a.vec != 0;
    p_round = a.p_round;
    nrows = min(ROWS, a.rows - tile * ROWS);
    row0 = ((long long)b * a.Hkv + hk) * a.rows + (long long)tile * ROWS;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
      qs[r] = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) q8[r][w] = 0;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        acc[r][c] = 0.f;
        qf[r][c] = 0.f;
      }
      if (r < nrows) {
        if constexpr (QQ) {
          if (owns())
            load_words(static_cast<const int8_t*>(a.q) + (row0 + r) * d,
                       q8[r]);
          qs[r] = a.q_sigma[row0 + r];
        } else if (owns()) {
          load(static_cast<const QT*>(a.q) + (row0 + r) * d, qf[r]);
        }
      }
    }
  }

  // One key: krow/vrow point at the key's d stored values, ks/vs are its
  // scales (ignored for a bf16 cache).
  __device__ __forceinline__ void attend(const KT* krow, const VT* vrow,
                                         float ks, float vs, float scale) {
    float kf[N], vf[N];
    int kw[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) kw[w] = 0;
    if (owns()) {
      if constexpr (QQ) {
        load_words(krow, kw);
      } else {
        load(krow, kf);
      }
      load(vrow, vf);
    } else {
#pragma unroll
      for (int c = 0; c < N; ++c) kf[c] = vf[c] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float s;
      if constexpr (QQ) {
        int dot = 0;
#pragma unroll
        for (int w = 0; w < NW; ++w) dot = __dp4a(q8[r][w], kw[w], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s = (float)dot * qs[r];
      } else {
        s = 0.f;
#pragma unroll
        for (int c = 0; c < N; ++c) s = fmaf(qf[r][c], kf[c], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        s *= scale;
      }
      if constexpr (kQuant) s *= ks;
      const float m_next = fmaxf(m[r], s);
      const float alpha = __expf(m[r] - m_next);
      const float p = __expf(s - m_next);
      l[r] = l[r] * alpha + p;
      m[r] = m_next;
      // P weights V in the compute dtype, after the V scale is folded in
      const float pv = kQuant ? p * vs : p;
      float pr;
      if constexpr (kF32Q) {
        pr = p_round == 1   ? __bfloat162float(__float2bfloat16(pv))
             : p_round == 2 ? __half2float(__float2half_rn(pv))
                            : pv;
      } else if constexpr (kHalfP) {
        pr = __half2float(__float2half_rn(pv));
      } else {
        pr = __bfloat162float(__float2bfloat16(pv));
      }
#pragma unroll
      for (int c = 0; c < N; ++c) acc[r][c] = acc[r][c] * alpha + pr * vf[c];
    }
  }

  // Merge the warps' states; then write O and LSE of the tile's rows when
  // this is the tile's only live split, else this split's partial, and
  // the last split to arrive merges the partials. tile_id: the row tile's
  // flat index (b, hk, tile); s: this split.
  __device__ __forceinline__ void finish(const Args& a, long long tile_id,
                                         int s, int s_first, int s_last) {
    __shared__ float part_m[NWARPS][ROWS];
    __shared__ float part_l[NWARPS][ROWS];
    __shared__ float part_o[NWARPS][ROWS][D];
    __shared__ int merges;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (lane == 0) {
        part_m[warp][r] = m[r];
        part_l[warp][r] = l[r];
      }
      if (owns()) {
#pragma unroll
        for (int c = 0; c < N; ++c) part_o[warp][r][c0 + c] = acc[r][c];
      }
    }
    __syncthreads();
    const bool alone = s_first == s_last;
    float* mine =
        alone ? nullptr : a.part + (tile_id * a.nsplit + s) * ROWS * (d + 2);
    for (int i = threadIdx.x; i < nrows * d; i += NTHREADS) {
      const int r = i / d;
      const int c = i % d;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, part_m[w][r]);
      float lsum = 0.f, osum = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        // a warp that saw no key has l = 0 and contributes nothing
        const float wgt = part_l[w][r] > 0.f ? __expf(part_m[w][r] - mx) : 0.f;
        lsum += part_l[w][r] * wgt;
        osum += part_o[w][r][c] * wgt;
      }
      if (alone) {
        put(a, r, c, mx, lsum, osum);
      } else {
        mine[r * (d + 2) + 2 + c] = osum;
        if (c == 0) {
          mine[r * (d + 2)] = mx;
          mine[r * (d + 2) + 1] = lsum;
        }
      }
    }
    if (alone) return;
    // the partial is visible before the ticket is taken; the last of the
    // live splits to take one merges
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      merges = atomicAdd(a.tickets + tile_id, 1) == s_last - s_first;
    }
    __syncthreads();
    if (!merges) return;
    __threadfence();
    const float* parts = a.part + tile_id * a.nsplit * ROWS * (d + 2);
    for (int i = threadIdx.x; i < nrows * d; i += NTHREADS) {
      const int r = i / d;
      const int c = i % d;
      // unrolled: the partials' loads go out eight at a time, the sums
      // stay in split order
      float mx = kNegInf;
#pragma unroll 8
      for (int t = s_first; t <= s_last; ++t) {
        mx = fmaxf(mx, __ldcg(parts + (t * ROWS + r) * (d + 2)));
      }
      float lsum = 0.f, osum = 0.f;
#pragma unroll 8
      for (int t = s_first; t <= s_last; ++t) {
        const float* p = parts + (t * ROWS + r) * (d + 2);
        const float lt = __ldcg(p + 1);
        const float wgt = lt > 0.f ? __expf(__ldcg(p) - mx) : 0.f;
        lsum += lt * wgt;
        osum += __ldcg(p + 2 + c) * wgt;
      }
      put(a, r, c, mx, lsum, osum);
    }
    if (threadIdx.x == 0) a.tickets[tile_id] = 0;  // for the next launch
  }

  // Element c of row r: O = osum / lsum (0 where lsum = 0) and, once per
  // row, LSE = mx + ln lsum (NEG_INF where lsum = 0).
  __device__ __forceinline__ void put(const Args& a, int r, int c, float mx,
                                        float lsum, float osum) {
    store(static_cast<QT*>(a.o) + (row0 + r) * d + c,
          lsum > 0.f ? osum / lsum : 0.f);
    if (c == 0) a.lse[row0 + r] = lsum > 0.f ? mx + logf(lsum) : kNegInf;
  }
};

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

// Calls L<D, QT, KT, VT, QQ, R>::run(args...) for the q type, storage
// types, head dim and row tile asked for; cudaErrorInvalidValue for a
// combination that is not built.
template <template <int, typename, typename, typename, bool, int> class L,
          int D, typename QT, int R, typename... A>
cudaError_t dispatch_types(int kt, int vt, int qq, A... args) {
  using bf16 = __nv_bfloat16;
  using fp8 = __nv_fp8_e4m3;
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
  if (vt == kInt8)
    return qq ? L<D, QT, int8_t, int8_t, true, R>::run(args...)
              : L<D, QT, int8_t, int8_t, false, R>::run(args...);
  return qq ? L<D, QT, int8_t, fp8, true, R>::run(args...)
            : L<D, QT, int8_t, fp8, false, R>::run(args...);
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

// The q type of this translation unit (decode.cu, paged.cu: bf16; the
// *_f16.cu units fp16, the *_f32.cu units fp32).
#if defined(CFA_DECODE_F32)
typedef float DecodeQ;
#elif defined(CFA_DECODE_F16)
typedef __half DecodeQ;
#else
typedef __nv_bfloat16 DecodeQ;
#endif

}  // namespace cfa_decode_body
