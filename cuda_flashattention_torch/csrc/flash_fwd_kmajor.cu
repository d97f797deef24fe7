// FlashAttention-2 forward with the score-bound softmax on a key-split walk
// (K5), for Hopper: a span of key tiles is made resident and converted
// once, and the Q tiles of every query head of its group stream past. Its
// F32 builds read an fp32 Q and hold each Q tile split into bf16 hi and lo
// tiles, over fp32 K and V split the same way (a span of one key tile at
// d = 128, four at d = 64), or over bf16 K/V, exact tiles as TMA leaves
// them, or one-byte K/V converted to exact bf16 tiles (three at d = 128,
// eight at d = 64). At d = 256 a span is one key tile: a bf16 Q's (or
// quantize_q's int8 Q's) ring of two 64 KB Q tiles beside its 64 KB K + V
// pair, and an fp32 Q's ring of one split 128 KB Q tile beside a bf16 (or
// converted) 64 KB pair, or beside the 64 KB split pair of a 32-key tile
// over fp32 K/V (BN32: a 64-key split pair, 128 KB, does not fit), so
// that the producer's split of the next Q tile waits for the consumers.
//
// Replaces: cuda_flashattention_tpu/ops/flash_fwd.py::_fwd_kernel_kmajor.
// What that kernel computes is the bound forward's result (K1b) on a
// K-outer walk: because p = 2^(s − c) needs no running max, the partial
// sums l and acc of a query row simply add across key tiles. Its TPU
// reasons (one sequential grid axis, the full-sequence state in on-chip
// memory) do not carry over; its function does.
//
// What bounds it on the H100: the products of the Q-major forward (the
// tensor cores), plus the reduction of every (Q tile, span) pair's partial
// l and acc into [B,H,Nq(,D)] fp32 buffers. What it saves is the
// conversion of one-byte K/V (int8 → bf16, e4m3 → bf16 or, under
// quantize_q, e4m3 → int8): once per key tile and KV head, not once per Q
// tile. And where Q-major gives fewer CTAs than the card has SMs (the
// chunked-prefill prefix: 8 x 4 x 4 = 128 tiles of 128 rows), the split
// over keys fills it.
//
// What this design does about it (flash_fwd_bound_sm90.cuh): blocks carry
// nothing between them, so the sequential K-outer grid becomes one CTA per
// (span of key tiles, KV head, batch); the host picks the span so that the
// grid holds at least two waves. The producer thread brings the span in
// (as bf16, or as codes that the consumers convert into the resident tiles
// while the codes' space is then reused for the Q ring), then streams the
// 128-row packed Q tiles of the group's heads, from the causal frontier to
// the window's, through a 2-stage TMA ring. Each pair's l and acc are
// added once per span with vector fp32 atomics (not once per 64-key tile);
// a second small kernel finalises O = acc / l, LSE = c·ln2 + ln l, the
// loose-bound count, and O = 0, LSE = NEG_INF for rows nothing touched.
// The order of the atomic adds changes from run to run, so O does in its
// last fp32 bits.

#include "flash_fwd_bound_sm90.cuh"

using namespace cfa_bound;

namespace {

constexpr int NQS = 2;  // Q tiles in flight (one under an fp32 Q at d = 256)

// the most key tiles a CTA keeps resident (what fits beside the Q ring);
// fp32 K/V tiles are held split, at twice the bytes, and an fp32 Q's ring
// is split too (ops/flash_fwd.py::_KMAJOR_MAX_SPAN*); `exact`: K/V held as
// exact bf16 tiles (bf16 or one-byte K/V)
// (d = 256: one tile, of 64 keys or, over fp32 K/V, of BN32)
__host__ __device__ constexpr int max_span(int D, bool f32, bool exact) {
  return D == 256 ? 1
         : f32    ? (exact ? (D == 128 ? 3 : 8) : (D == 128 ? 1 : 4))
                  : (D == 128 ? 4 : 8);
}

// Shared memory of one CTA (byte offsets from a 1024-aligned base): the
// span's K and V tiles as wgmma reads them (under F32 over fp32 K/V the hi
// and lo tiles of each); the Q ring (F32: split), whose space first holds
// the span's codes under QUANT; the span's scales; barriers. An fp32 Q
// over bf16 K/V (BF16KV) keeps the bf16 build's tiles beside a split ring.
template <int D, bool QUANT, bool QQ, bool F32, bool BF16KV>
struct Layout {
  using T = Tiles<D, QQ>;
  static_assert(!BF16KV || (F32 && !QUANT), "BF16KV: an fp32 Q");
  static constexpr int SPAN = max_span(D, F32, QUANT || BF16KV);
  static constexpr bool SPLIT_KV = F32 && !QUANT && !BF16KV;
  static constexpr int KN = key_tile(D, F32, SPLIT_KV ? kF32 : kBf16);
  static constexpr int NQ = D == 256 && F32 ? 1 : NQS;  // Q tiles in flight
  static constexpr int kv16 = KN * D * 2;  // a bf16 K or V tile
  // V after K in a tile pair; split K/V are each hi then lo
  static constexpr int tile_v = SPLIT_KV ? 2 * kv16 : align1k(T::KC);
  static constexpr int tile_stride = tile_v + (SPLIT_KV ? 2 : 1) * kv16;
  static constexpr int q_stride = align1k(F32 ? 2 * T::Q : T::Q);
  static constexpr int q_off = SPAN * tile_stride;
  static constexpr int raw_pair = 2 * T::CODES;  // one key tile's codes
  static constexpr int q_region = NQ * q_stride > (QUANT ? SPAN * raw_pair : 0)
                                      ? NQ * q_stride
                                      : SPAN * raw_pair;
  static constexpr int sc_off = q_off + align1k(q_region);
  static constexpr int bar_off = sc_off + (QUANT ? SPAN * 2 * BN * 4 : 0);
  static constexpr int bytes = bar_off + 8 * (2 * NQ + 2) + 1024;
  static_assert(bytes <= 232448, "the CTA's shared memory");
};

template <int D, bool QUANT, bool QQ, bool F32, bool BF16KV>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_kmajor_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const Args a, const F32Src f) {
  static_assert(QUANT || !QQ, "quantize_q reads quantized K/V");
  static_assert(!(QQ && F32), "quantize_q's Q is int8");
  using T = Tiles<D, QQ>;
  using L = Layout<D, QUANT, QQ, F32, BF16KV>;
  constexpr int KN = L::KN;  // keys of a tile
  constexpr int NQ = L::NQ;
  // K/V tiles that are exact bf16 operands under an fp32 Q
  constexpr bool EXACT = QUANT || BF16KV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t q_full = base + L::bar_off;  // + 8 * stage
  const uint32_t q_empty = q_full + 8 * NQ;   // + 8 * stage
  const uint32_t span_bar = q_empty + 8 * NQ;
  const uint32_t free_bar = span_bar + 8;     // the codes are converted

  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int t_lo = blockIdx.x * a.span;
  const int t_hi = min((a.Nk + KN - 1) / KN, t_lo + a.span);
  const int nt = t_hi - t_lo;
  // Q tiles that see a key of the span: causal rows see keys <= pos +
  // kv_offset, so from position span_c0 − kv_offset on; windowed rows up
  // to the last position whose window reaches the span's last key
  const int n_q_tiles = (a.Nq + a.R - 1) / a.R;
  int first = 0, last = n_q_tiles - 1;
  if (a.causal) {
    first = max(0, t_lo * KN - a.kv_offset) / a.R;
    if (a.window > 0) {
      const int last_pos =
          min(a.Nk, t_hi * KN) - 1 + a.window - 1 - a.kv_offset;
      last = last_pos < 0 ? -1 : min(last, last_pos / a.R);
    }
  }
  const int per_pack = max(0, last - first + 1);
  const int n_items = (a.G / a.Gp) * per_pack;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NQ; ++s) {
      // the TMA issue, or under F32 the producer warpgroup's 128 threads
      mbar_init(q_full + 8 * s, F32 ? 128 : 1);
      mbar_init(q_empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    mbar_init(span_bar, L::SPLIT_KV ? 128 : 1);
    mbar_init(free_bar, 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int pt = threadIdx.x - 2 * 128;
    const long long* st = f.st;
    // an fp32 Q: the warpgroup's 128 threads read each Q tile from device
    // memory and write its hi and lo tiles into the ring
    auto split_q_ring = [&]() {
      for (int item = 0; item < n_items; ++item) {
        const int qs = item % NQ;
        const int h0 = hk * a.G + (item / per_pack) * a.Gp;
        const int q0 = (first + item % per_pack) * a.R;
        mbar_wait(q_empty + 8 * qs, ((item / NQ) & 1) ^ 1);
        uint8_t* dst = smem + L::q_off + qs * L::q_stride;
        split_rows<D, 128>(dst, dst + T::Q, BM, f.p[0] + b * st[0], st[1],
                           st[2], h0, a.Gp, a.R, q0, a.Nq, pt);
        fence_proxy_async();
        mbar_arrive(q_full + 8 * qs);
      }
    };
    if (L::SPLIT_KV) {
      // fp32 K/V: the span split the same way, then the Q tiles
      for (int j = 0; j < nt; ++j) {
        const int t = t_lo + j;
        uint8_t* dst = smem + j * L::tile_stride;
        split_rows<D, 128>(dst, dst + L::kv16, KN, f.p[1] + b * st[3], st[4],
                           st[5], hk, 1, KN, t * KN, a.Nk, pt);
        split_rows<D, 128>(dst + L::tile_v, dst + L::tile_v + L::kv16, KN,
                           f.p[2] + b * st[6], st[7], st[8], hk, 1, KN,
                           t * KN, a.Nk, pt);
      }
      fence_proxy_async();
      mbar_arrive(span_bar);
      split_q_ring();
    } else if (BF16KV) {
      // bf16 K/V under an fp32 Q: the span by TMA straight into its
      // resident tiles, then the Q tiles
      if (threadIdx.x == 2 * 128) {
        mbar_expect_tx(span_bar, nt * 2 * T::KV16);
        for (int j = 0; j < nt; ++j) {
          const uint32_t dst = base + j * L::tile_stride;
          for (int sl = 0; sl < T::SLABS; ++sl) {
            tma_load_4d(dst + sl * BN * 128, &tm_k, span_bar, sl * 64,
                        (t_lo + j) * BN, hk, b);
            tma_load_4d(dst + L::tile_v + sl * BN * 128, &tm_v, span_bar,
                        sl * 64, (t_lo + j) * BN, hk, b);
          }
        }
      }
      split_q_ring();
    } else if (F32) {
      // one-byte K/V under an fp32 Q: the span's codes by TMA into the Q
      // ring's space; once the consumers have converted them, the Q tiles
      if (threadIdx.x == 2 * 128) {
        mbar_expect_tx(span_bar, nt * L::raw_pair);
        for (int j = 0; j < nt; ++j) {
          const uint32_t dst = base + L::q_off + j * L::raw_pair;
          tma_load_4d(dst, &tm_k, span_bar, 0, (t_lo + j) * BN, hk, b);
          tma_load_4d(dst + T::CODES, &tm_v, span_bar, 0, (t_lo + j) * BN,
                      hk, b);
        }
      }
      mbar_wait(free_bar, 0);
      split_q_ring();
    } else if (threadIdx.x == 2 * 128) {
      // the span: bf16 straight into its resident tiles, codes into the
      // Q ring's space for the consumers to convert
      mbar_expect_tx(span_bar, nt * (QUANT ? L::raw_pair : 2 * T::KV16));
      for (int j = 0; j < nt; ++j) {
        const int t = t_lo + j;
        if (QUANT) {
          const uint32_t dst = base + L::q_off + j * L::raw_pair;
          tma_load_4d(dst, &tm_k, span_bar, 0, t * BN, hk, b);
          tma_load_4d(dst + T::CODES, &tm_v, span_bar, 0, t * BN, hk, b);
        } else {
          const uint32_t dst = base + j * L::tile_stride;
          for (int sl = 0; sl < T::SLABS; ++sl) {
            tma_load_4d(dst + sl * BN * 128, &tm_k, span_bar, sl * 64, t * BN,
                        hk, b);
            tma_load_4d(dst + L::tile_v + sl * BN * 128, &tm_v, span_bar,
                        sl * 64, t * BN, hk, b);
          }
        }
      }
      if (QUANT) mbar_wait(free_bar, 0);
      for (int item = 0; item < n_items; ++item) {
        const int st = item % NQ;
        const int h0 = hk * a.G + (item / per_pack) * a.Gp;
        const int q0 = (first + item % per_pack) * a.R;
        mbar_wait(q_empty + 8 * st, ((item / NQ) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * st, a.Gp * a.R * D * (QQ ? 1 : 2));
        const uint32_t dst = base + L::q_off + st * L::q_stride;
        for (int sl = 0; sl < T::QSLABS; ++sl) {
          tma_load_4d(dst + sl * BM * 128, &tm_q, q_full + 8 * st,
                      sl * T::QCOL, q0, h0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const float* scales = reinterpret_cast<const float*>(smem + L::sc_off);
    mbar_wait(span_bar, 0);
    if (QUANT) {
      for (int j = 0; j < nt; ++j) {
        const uint8_t* raw = smem + L::q_off + j * L::raw_pair;
        uint8_t* dst = smem + j * L::tile_stride;
        if (QQ) {
          codes_to_s8<D, NCONSUMER>(dst, raw, a.k_type, tid);
        } else {
          codes_to_elem<D, NCONSUMER>(dst, raw, a.k_type, tid);
        }
        codes_to_elem<D, NCONSUMER>(dst + L::tile_v, raw + T::CODES,
                                    a.v_type, tid);
        float* sc = reinterpret_cast<float*>(smem + L::sc_off) + j * 2 * BN;
        load_scales<NCONSUMER>(sc, a, b, hk, (t_lo + j) * BN, tid);
      }
      fence_proxy_async();
      consumer_sync();
      if (lane == 0) mbar_arrive(free_bar);
    }
    // the rows' bounds and factors are read one Q tile ahead, so that their
    // loads do not stall the tile's products
    Rows r_next = row_info(a, b, hk * a.G, first * a.R, tid);
    for (int item = 0; item < n_items; ++item) {
      const int st = item % NQ;
      const int q0 = (first + item % per_pack) * a.R;
      const Rows r = r_next;
      if (item + 1 < n_items) {
        r_next = row_info(a, b, hk * a.G + ((item + 1) / per_pack) * a.Gp,
                          (first + (item + 1) % per_pack) * a.R, tid);
      }
      int t_begin, t_end;
      visible_tiles<KN>(a, q0, min(q0 + a.R, a.Nq) - 1, t_lo, t_hi, t_begin,
                        t_end);
      float acc[D / 64][32];
#pragma unroll
      for (int sl = 0; sl < D / 64; ++sl) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[sl][i] = 0.f;
      }
      float l[2] = {0.f, 0.f};
      const uint32_t q = base + L::q_off + st * L::q_stride;
      mbar_wait(q_full + 8 * st, (item / NQ) & 1);
      for (int t = t_begin; t < t_end; ++t) {
        const int j = t - t_lo;
        const uint32_t kt = base + j * L::tile_stride;
        const float* ksc = QUANT ? scales + j * 2 * BN : nullptr;
        const float* vsc = QUANT ? ksc + BN : nullptr;
        float s[KN / 2];
        qk<D, QQ, F32, EXACT, KN>(s, q, kt, wg);
        uint32_t p[KN / 4], p_lo[KN / 4];  // under F32 P = p + p_lo
        if (interior<KN>(a, t * KN, q0, q0 + a.R - 1)) {
          bound_step<QUANT, QQ, false, F32, KN>(a, r, s, ksc, vsc, t * KN, l,
                                                p, p_lo, f.round[0]);
        } else {
          bound_step<QUANT, QQ, true, F32, KN>(a, r, s, ksc, vsc, t * KN, l,
                                               p, p_lo, f.round[0]);
        }
        pv<D, F32, EXACT, KN>(acc, p, kt + L::tile_v, p_lo);
      }
      if (lane == 0) mbar_arrive(q_empty + 8 * st);  // Q is read
      add_rows<D>(a, r, acc, l, b);
    }
  }
}

// One warp per query row: O, LSE and the loose-bound count from the
// accumulated l and acc.
template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_kmajor_finalize(const Args a, long long n_rows) {
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const float l = a.l_acc[row];
  const float inv = l == 0.f ? 0.f : 1.f / l;
  for (int c = lane; c < D; c += 32) {
    store_one(a, row * D + c, a.o_acc[row * D + c] * inv);
  }
  if (lane == 0) finish_row(a, row, (int)(row % a.Nq), l, a.c[row]);
}

template <int D, bool QUANT, bool QQ, bool F32, bool BF16KV = false>
cudaError_t launch(const Maps& m, const Args& a, const F32Src& f, int B,
                   cudaStream_t stream) {
  if (a.Nk > 0) {
    using L = Layout<D, QUANT, QQ, F32, BF16KV>;
    const int smem = L::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kmajor_kernel<D, QUANT, QQ, F32, BF16KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int n_tiles = (a.Nk + L::KN - 1) / L::KN;
    const dim3 grid((n_tiles + a.span - 1) / a.span, a.Hkv, B);
    flash_fwd_kmajor_kernel<D, QUANT, QQ, F32, BF16KV>
        <<<grid, NTHREADS, smem, stream>>>(m.q, m.k, m.v, a, f);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long n_rows = (long long)B * a.H * a.Nq;
  flash_fwd_kmajor_finalize<D>
      <<<(unsigned int)((n_rows + 3) / 4), 128, 0, stream>>>(a, n_rows);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_form(const Maps& m, const Args& a, const F32Src& f, int B,
                        int qq, bool f32, cudaStream_t stream) {
  if constexpr (kHalf) {  // the fp16 unit: fp16 Q (the entry point checked)
    return a.k_type == kBf16 ? launch<D, false, false, false>(m, a, f, B,
                                                              stream)
                             : launch<D, true, false, false>(m, a, f, B,
                                                             stream);
  } else {
    if (f32) {  // an fp32 Q over fp32, bf16 or one-byte K/V
      if (a.k_type == kF32) {
        return launch<D, false, false, true>(m, a, f, B, stream);
      }
      if (a.k_type == kBf16) {
        return launch<D, false, false, true, true>(m, a, f, B, stream);
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

// K5. ptrs: q, k, v, k_scale, v_scale, q_factor, c, l_acc ([B,H,Nq] fp32,
// zeroed), o_acc ([B,H,Nq,D] fp32, zeroed), n_loose, o, lse; the rest as
// cfa_flash_fwd_bound's (q_f32's codes and the fp16 unit's
// cfa_flash_fwd_kmajor_f16 too), and span: key tiles of 64 per CTA, 1 to
// max_span(D, q_f32, K/V not fp32) (ops/flash_fwd.py::_KMAJOR_MAX_SPAN*);
// its tiles are of key_tile(D, q_f32, k_type) keys (32 for an fp32 Q over
// fp32 K/V at d = 256). D: 64, 128, or 256 (span 1).
extern "C" int cfa_flash_fwd_kmajor(void* const* ptrs, int B, int H, int Hkv,
                                    int Nq, int Nk, int D,
                                    const long long* strides, int k_type,
                                    int v_type, int q_f32, int qq, int causal,
                                    int window, int kv_offset, int out_type,
                                    int span, void* stream) {
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
  if (D != 64 && D != 128 && D != 256) return cudaErrorInvalidValue;
  const bool quant = k_type != kBf16 && k_type != kF32;
  if (span < 1 || span > max_span(D, f32, k_type != kF32)) {
    return cudaErrorInvalidValue;
  }
  Args a = {};
  a.k_scale = static_cast<const float*>(ptrs[3]);
  a.v_scale = static_cast<const float*>(ptrs[4]);
  a.q_factor = qq ? static_cast<const float*>(ptrs[5]) : nullptr;
  a.c = static_cast<const float*>(ptrs[6]);
  a.l_acc = static_cast<float*>(ptrs[7]);
  a.o_acc = static_cast<float*>(ptrs[8]);
  a.n_loose = static_cast<int*>(ptrs[9]);
  a.o = ptrs[10];
  a.lse = static_cast<float*>(ptrs[11]);
  a.H = H; a.Hkv = Hkv; a.Nq = Nq; a.Nk = Nk;
  a.G = H / Hkv;
  a.Gp = packed_heads(a.G);
  a.R = BM / a.Gp;
  a.k_type = k_type; a.v_type = v_type;
  a.causal = causal; a.window = window; a.kv_offset = kv_offset;
  a.out_type = out_type;
  a.span = span;
  if (quant && (a.k_scale == nullptr || a.v_scale == nullptr)) {
    return cudaErrorInvalidValue;
  }
  // the fp32 builds read fp32 operands through F32Src, not through TMA
  // (one-byte K/V still come by TMA)
  Maps m = {};
  F32Src f = {};
  if (f32) f = f32_src(ptrs, strides, q_f32);
  if (k_type != kF32 &&
      !make_maps(&m, f32 ? nullptr : ptrs[0], ptrs[1], ptrs[2], B, H, Hkv,
                 Nq, Nk, D, strides, k_type, v_type, qq, a.Gp, a.R)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_form<64>(m, a, f, B, qq, f32, s);
    case 128:
      return launch_form<128>(m, a, f, B, qq, f32, s);
    case 256:
      return launch_form<256>(m, a, f, B, qq, f32, s);
    default:
      return cudaErrorInvalidValue;
  }
}
