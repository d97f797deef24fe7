// FlashAttention-2 forward with the score-bound softmax on a K-major walk
// (K5): a K/V tile is made resident and dequantised once, and every Q tile
// that can see it streams past.
//
// Replaces: cuda_flashattention_tpu/ops/flash_fwd.py::_fwd_kernel_kmajor.
// What that kernel computes is the bound forward's result (K1b) on a
// K-outer walk: because p = 2^(s − c) needs no running max, the partial
// sums l and acc of a query row commute and simply add across K/V tiles.
// Its TPU reasons (one flat sequential grid axis, the full-sequence state
// in on-chip memory, the cost of a Q-block transition) do not carry over;
// its function does.
//
// What bounds it on the H100: the same products as the Q-major forward,
// plus one fp32 atomic add per (row, column of d) and visible tile pair
// into the [B,H,Nq,d] accumulator. What it saves is the conversion of K/V:
// int8 → bf16, e4m3 → bf16 or, under quantize_q, e4m3 → int8 happens once
// per key tile and KV head, not once per Q tile and query head. Measured
// on an H100 at 700 W, 512 query rows over 3584 keys (B=8, H=16, Hkv=4,
// d=128): the atomics cost less than that conversion (this walk 4-6%
// under the Q-major bound form and 7-8% under the online one over int8,
// fp8 and mixed K/V) and more than nothing (13% over the bound form on
// bf16 K/V, which needs no conversion).
//
// What this design does about it: blocks run in parallel and carry
// nothing between them, so the sequential K-outer grid becomes one CTA per
// (key tile, KV head, batch), the walk the fused backward already uses.
// The CTA converts its K/V tile into shared memory, loops over the query
// heads of its GQA group and over the Q tiles that can see the tile
// (causal: from (c0 − kv_offset) / 64 on; window: up to the last row whose
// window reaches c0), and adds each pair's l and acc into zeroed fp32
// buffers with atomicAdd. A second small kernel finalises O = acc / l,
// LSE = c·ln2 + ln l and the loose-bound count, and writes O = 0,
// LSE = NEG_INF for rows that nothing touched. The order of the atomic
// adds differs from run to run, so O does in its last fp32 bits.

#include "flash_fwd_body.cuh"

using namespace cfa_fwd_body;

namespace {

template <int D, bool QQ, bool EXTRA>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kmajor_kernel(Args a) {
  static_assert(EXTRA || !QQ, "quantize_q reads quantized K/V");
  using S = Smem<D>;
  const Extras<EXTRA> x(a);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + S::q_off);
  bf16* ks = reinterpret_cast<bf16*>(smem + S::k_off);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::v_off);
  bf16* ps = reinterpret_cast<bf16*>(smem + S::p_off);
  float* ss = reinterpret_cast<float*>(smem + S::s_off);
  float* os = reinterpret_cast<float*>(smem + S::o_off);
  float* cs = reinterpret_cast<float*>(smem + S::m_off);  // the rows' c
  float* ls = reinterpret_cast<float*>(smem + S::l_off);  // this pair's l
  float* kscs = reinterpret_cast<float*>(smem + S::ksc_off);
  float* vscs = reinterpret_cast<float*>(smem + S::vsc_off);

  const int c0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.H / a.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * ROWS_PER_WARP;
  const bool quant = x.quant;
  const int k_type = EXTRA ? a.k_type : kBf16;
  const int v_type = EXTRA ? a.v_type : kBf16;

  // the resident tile, converted once
  const uint8_t* kb = static_cast<const uint8_t*>(a.k) +
                      (b * a.skb + hk * a.skh) * (k_type == kBf16 ? 2 : 1);
  const uint8_t* vb = static_cast<const uint8_t*>(a.v) +
                      (b * a.svb + hk * a.svh) * (v_type == kBf16 ? 2 : 1);
  if (QQ) {
    load_tile_s8<D, BK>(reinterpret_cast<signed char*>(ks), kb, k_type, a.skn,
                        c0, a.Nk);
  } else {
    load_kv<D>(ks, kb, k_type, a.skn, c0, a.Nk);
  }
  load_kv<D>(vs, vb, v_type, a.svn, c0, a.Nk);
  if (quant) {
    load_scales(vscs, a.v_scale + (long long)(b * a.Hkv + hk) * a.Nk, c0,
                a.Nk);
    if (!QQ) {
      load_scales(kscs, a.k_scale + (long long)(b * a.Hkv + hk) * a.Nk, c0,
                  a.Nk);
    }
  }

  // Q tiles that can see this key tile: causal rows see keys <= row +
  // kv_offset, so from row c0 − kv_offset on; with a window the last row
  // that reaches the tile's last key is c0 + BK − 2 + window − kv_offset
  const int n_q_tiles = (a.Nq + BQ - 1) / BQ;
  int first = 0;
  int last = n_q_tiles - 1;
  if (a.causal) {
    first = max(0, c0 - a.kv_offset) / BQ;
    if (x.window > 0) {
      const int last_row = c0 + BK - 2 + x.window - a.kv_offset;
      last = last_row < 0 ? -1 : min(last, last_row / BQ);
    }
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long row_base = (long long)(b * a.H + h) * a.Nq;
    for (int it = first; it <= last; ++it) {
      const int q0 = it * BQ;
      __syncthreads();  // the previous pair's readers are done
      if (QQ) {
        load_tile_s8<D, BQ>(reinterpret_cast<signed char*>(qs),
                            static_cast<const uint8_t*>(a.q) + b * a.sqb +
                                h * a.sqh,
                            kInt8, a.sqn, q0, a.Nq);
        // under quantize_q the K scale rows are per query head
        load_scales(kscs, a.k_scale + (long long)(b * a.H + h) * a.Nk, c0,
                    a.Nk);
      } else {
        load_tile<D, BQ>(qs, S::LDH,
                         static_cast<const bf16*>(a.q) + b * a.sqb + h * a.sqh,
                         a.sqn, q0, a.Nq);
      }
      for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
        cs[i] = q0 + i < a.Nq ? a.c[row_base + q0 + i] : 0.f;
      }
      __syncthreads();

      if (QQ) {
        qk_s8<D>(reinterpret_cast<const signed char*>(qs),
                 reinterpret_cast<const signed char*>(ks),
                 reinterpret_cast<int*>(ss), r0);
      } else {
        qk_bf16<D>(qs, ks, ss, r0);
      }
      __syncwarp();
      bound_probs<D, QQ, EXTRA>(a, x, ss, cs, kscs, vscs, nullptr, nullptr,
                                ps, r0, q0, c0, ls, false);
      __syncwarp();
      pv<D>(os, ps, vs, r0, true);
      __syncwarp();

      // the warp's rows: add this pair's l and acc to device memory; a
      // row that saw nothing in this tile adds nothing
      for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
        const int row = r0 + rr;
        const int qi = q0 + row;
        if (qi >= a.Nq) break;
        const float l = ls[row];
        if (l == 0.f) continue;
        if (lane == 0) atomicAdd(a.l_acc + row_base + qi, l);
        float* dst = a.o_acc + (row_base + qi) * D;
        for (int c = lane; c < D; c += 32) {
          atomicAdd(dst + c, os[row * S::LDO + c]);
        }
      }
    }
  }
}

// One warp per query row: O, LSE and the loose-bound count from the
// accumulated l and acc.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kmajor_finalize(Args a, long long n_rows) {
  const long long row =
      (long long)blockIdx.x * NWARPS + threadIdx.x / 32;  // over B·H·Nq
  if (row >= n_rows) return;
  const int qi = (int)(row % a.Nq);
  const int bh = (int)(row / a.Nq);
  bound_epilogue_row<D>(a, a.o_acc + row * D, a.l_acc[row], a.c[row],
                        bh / a.H, bh % a.H, qi);
}

template <int D, bool QQ, bool EXTRA>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kmajor_kernel<D, QQ, EXTRA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a.Nk > 0) {
    dim3 grid((a.Nk + BK - 1) / BK, a.Hkv, B);
    flash_fwd_kmajor_kernel<D, QQ, EXTRA>
        <<<grid, NTHREADS, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long n_rows = (long long)B * a.H * a.Nq;
  const unsigned int blocks = (unsigned int)((n_rows + NWARPS - 1) / NWARPS);
  flash_fwd_kmajor_finalize<D><<<blocks, NTHREADS, 0, stream>>>(a, n_rows);
  return cudaGetLastError();
}

}  // namespace

// K5. ptrs: q, k, v, k_scale, v_scale, c, l_acc, o_acc, n_loose, o, lse;
// l_acc [B,H,Nq] and o_acc [B,H,Nq,D] are fp32 and zeroed by the caller.
// strides: q, k, v, each (batch, head, row), in elements. k_type/v_type:
// 0 bf16, 1 int8, 2 fp8 e4m3; qq: int8 Q (quantize_q).
extern "C" int cfa_flash_fwd_kmajor(void* const* ptrs, int B, int H, int Hkv,
                                    int Nq, int Nk, int D,
                                    const long long* strides, int k_type,
                                    int v_type, int qq, int causal,
                                    int window, int kv_offset, int out_f32,
                                    void* stream) {
  if (B == 0 || H == 0 || Nq == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  if (qq && k_type == kBf16) return cudaErrorInvalidValue;
  Args a = {};
  a.q = ptrs[0];
  a.k = ptrs[1];
  a.v = ptrs[2];
  a.k_scale = static_cast<const float*>(ptrs[3]);
  a.v_scale = static_cast<const float*>(ptrs[4]);
  a.c = static_cast<const float*>(ptrs[5]);
  a.l_acc = static_cast<float*>(ptrs[6]);
  a.o_acc = static_cast<float*>(ptrs[7]);
  a.n_loose = static_cast<int*>(ptrs[8]);
  a.o = ptrs[9];
  a.lse = static_cast<float*>(ptrs[10]);
  a.H = H; a.Hkv = Hkv; a.Nq = Nq; a.Nk = Nk;
  a.sqb = strides[0]; a.sqh = strides[1]; a.sqn = strides[2];
  a.skb = strides[3]; a.skh = strides[4]; a.skn = strides[5];
  a.svb = strides[6]; a.svh = strides[7]; a.svn = strides[8];
  a.k_type = k_type; a.v_type = v_type;
  a.causal = causal; a.window = window; a.kv_offset = kv_offset;
  a.out_f32 = out_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the build without the extras serves a call that uses none of them
  const bool extra = a.k_scale != nullptr || window > 0;
  switch (D) {
    case 64:
      return qq      ? launch<64, true, true>(a, B, s)
             : extra ? launch<64, false, true>(a, B, s)
                     : launch<64, false, false>(a, B, s);
    case 128:
      return qq      ? launch<128, true, true>(a, B, s)
             : extra ? launch<128, false, true>(a, B, s)
                     : launch<128, false, false>(a, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}
