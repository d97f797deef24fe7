// FlashAttention-2 forward with the score-bound softmax on a Q-major walk
// (K1b), for Hopper: bf16 Q, K/V in bf16, int8 or fp8 e4m3 with per-token
// scales (or int8 Q and K under quantize_q), fp32 or bf16 out, the
// natural-log LSE and the count of loose-bound rows.
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
// Interior tiles skip the element mask.

#include "flash_fwd_bound_sm90.cuh"

using namespace cfa_bound;

namespace {

// key-tile stages in flight: a one-byte stage is half the bytes, and its
// scales come in by plain loads, so it keeps one more ahead
template <bool QUANT>
constexpr int stages() { return QUANT ? 3 : 2; }

// Shared memory of one CTA (byte offsets from a 1024-aligned base): the Q
// tile; NST stages of K and V as TMA writes them (bf16 slabs, or one-byte
// codes followed by the tile's K and V scales); under QUANT two converted
// K/V pairs, used in turn; barriers.
template <int D, bool QUANT, bool QQ>
struct Layout {
  using T = Tiles<D, QQ>;
  static constexpr int NST = stages<QUANT>();
  static constexpr int kvh = QUANT ? T::CODES : T::KV16;  // K, then V
  static constexpr int tma_bytes = 2 * kvh;
  static constexpr int stage = align1k(tma_bytes + (QUANT ? 2 * BN * 4 : 0));
  static constexpr int st_off = align1k(T::Q);
  static constexpr int cv_v = align1k(T::KC);          // V in a converted pair
  static constexpr int cv_stride = align1k(cv_v + T::KV16);
  static constexpr int cv_off = st_off + NST * stage;
  static constexpr int bar_off = cv_off + (QUANT ? 2 * cv_stride : 0);
  static constexpr int bytes = bar_off + 8 * (2 * NST + 1) + 1024;
};

template <int D, bool QUANT, bool QQ>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_bound_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const Args a) {
  static_assert(QUANT || !QQ, "quantize_q reads quantized K/V");
  using T = Tiles<D, QQ>;
  using L = Layout<D, QUANT, QQ>;
  constexpr int NST = L::NST;
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
  visible_tiles(a, q0, q_hi, 0, (a.Nk + BN - 1) / BN, t_begin, t_end);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      // the TMA issue, and under QUANT the 32 lanes that load the scales
      mbar_init(full + 8 * s, QUANT ? 33 : 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // the producer: one thread issues every load; under QUANT its warp
    // also brings each tile's scales beside the codes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 2 * 128 + (QUANT ? 32 : 1)) {
      if (lane == 0) {
        const int q_slabs = QQ ? 1 : T::SLABS;
        mbar_expect_tx(q_bar, a.Gp * a.R * D * (QQ ? 1 : 2));
        for (int sl = 0; sl < q_slabs; ++sl) {
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
              tma_load_4d(dst + sl * BN * 128, &tm_k, full + 8 * st, sl * 64,
                          t * BN, hk, b);
              tma_load_4d(dst + L::kvh + sl * BN * 128, &tm_v, full + 8 * st,
                          sl * 64, t * BN, hk, b);
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
      const int c0 = t * BN;
      mbar_wait(full + 8 * st, (i / NST) & 1);
      const int stage_off = L::st_off + st * L::stage;
      uint32_t kt = base + stage_off, vt = kt + L::kvh;
      const float* ksc = nullptr;
      const float* vsc = nullptr;
      if (QUANT) {
        // both warpgroups convert the tile once for the CTA's Gp heads,
        // into the pair used two tiles ago: each warpgroup finished that
        // tile's P·V before the barrier of the tile in between
        uint8_t* cv = smem + L::cv_off + (i & 1) * L::cv_stride;
        const uint8_t* raw = smem + stage_off;
        if (QQ) {
          codes_to_s8<D, NCONSUMER>(cv, raw, a.k_type, tid);
        } else {
          codes_to_bf16<D, NCONSUMER>(cv, raw, a.k_type, tid);
        }
        codes_to_bf16<D, NCONSUMER>(cv + L::cv_v, raw + L::kvh, a.v_type,
                                    tid);
        fence_proxy_async();
        consumer_sync();
        kt = smem_u32(cv);
        vt = kt + L::cv_v;
        ksc = reinterpret_cast<const float*>(smem + stage_off + L::tma_bytes);
        vsc = ksc + BN;
      }
      float s[32];
      qk<D, QQ>(s, base, kt, wg);
      uint32_t p[16];
      if (interior(a, c0, q0, q0 + a.R - 1)) {
        bound_step<QUANT, QQ, false>(a, r, s, ksc, vsc, c0, l, p);
      } else {
        bound_step<QUANT, QQ, true>(a, r, s, ksc, vsc, c0, l, p);
      }
      // the stage is read: its codes and scales (QUANT) or its K (bf16;
      // V is read by the P·V below, which completes before the next wait)
      if (QUANT && lane == 0) mbar_arrive(empty + 8 * st);
      pv<D>(acc, p, vt);
      if (!QUANT && lane == 0) mbar_arrive(empty + 8 * st);
    }
    store_rows<D>(a, r, acc, l, b);
  }
}

template <int D, bool QUANT, bool QQ>
cudaError_t launch(const Maps& m, const Args& a, int B, cudaStream_t stream) {
  const int smem = Layout<D, QUANT, QQ>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bound_kernel<D, QUANT, QQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + a.R - 1) / a.R, a.H / a.Gp, B);
  flash_fwd_bound_kernel<D, QUANT, QQ>
      <<<grid, NTHREADS, smem, stream>>>(m.q, m.k, m.v, a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_form(const Maps& m, const Args& a, int B, int qq,
                        cudaStream_t stream) {
  if (a.k_type == kBf16) return launch<D, false, false>(m, a, B, stream);
  return qq ? launch<D, true, true>(m, a, B, stream)
            : launch<D, true, false>(m, a, B, stream);
}

}  // namespace

// K1b. ptrs: q (bf16 prescaled, or int8 under qq), k, v, k_scale, v_scale
// ([B,Hkv,Nk] fp32 or NULL), q_factor ([B,H] fp32 under qq, else NULL), c
// ([B,H,Nq]), n_loose (int32, zeroed), o ([B,H,Nq,D] contiguous), lse
// ([B,H,Nq]). strides: q, k, v, each (batch, head, row), in elements, rows
// 16-byte aligned. k_type/v_type: 0 bf16, 1 int8, 2 fp8 e4m3 (K and V both
// bf16 or both one-byte).
extern "C" int cfa_flash_fwd_bound(void* const* ptrs, int B, int H, int Hkv,
                                   int Nq, int Nk, int D,
                                   const long long* strides, int k_type,
                                   int v_type, int qq, int causal, int window,
                                   int kv_offset, int out_f32, void* stream) {
  if (B == 0 || H == 0 || Nq == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  if ((k_type == kBf16) != (v_type == kBf16)) return cudaErrorInvalidValue;
  if (qq && k_type == kBf16) return cudaErrorInvalidValue;
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
  a.out_f32 = out_f32;
  if (k_type != kBf16 && (a.k_scale == nullptr || a.v_scale == nullptr)) {
    return cudaErrorInvalidValue;
  }
  Maps m;
  if (!make_maps(&m, ptrs[0], ptrs[1], ptrs[2], B, H, Hkv, Nq, Nk, D, strides,
                 k_type, v_type, qq, a.Gp, a.R)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_form<64>(m, a, B, qq, s);
    case 128:
      return launch_form<128>(m, a, B, qq, s);
    default:
      return cudaErrorInvalidValue;
  }
}
