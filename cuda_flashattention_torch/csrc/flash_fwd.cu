// FlashAttention-2 forward for Hopper on a Q-major walk with the online
// softmax (K1): bf16 Q, K/V in bf16, int8 or fp8 e4m3 with per-token
// scales, fp32 or bf16 out, with the natural-log LSE per query row.
//
// Replaces: cuda_flashattention_tpu/ops/flash_fwd.py::_fwd_kernel with
// bound=False, with the causal band of its compact grid, its window and
// segment masks and its folded dequantisation. Its bound=True form (K1b)
// is flash_fwd_bound.cu.
//
// What bounds it on the H100: at the prefill shapes (N = 512..4096,
// d = 128) the two products are ~4·N²·d flops against 4·N·d bytes per
// head, far above the card's ~295 flop/byte balance point, so the kernel
// is compute-bound — on the tensor cores for Q·Kᵀ and P·V and, in this
// version, as much on the fp32 softmax and the shared-memory round trips
// of S, P and the accumulator. A quantized K/V halves the bytes and leaves
// the operations as they were.
//
// What this design does about it: the products run on the tensor cores
// through nvcuda::wmma bf16 (or int8) fragments; one CTA holds a 64-row Q
// tile in shared memory for its whole walk over K/V, so Q is read from
// device memory once and K/V once per Q tile. For causal calls the walk
// stops at the tile's last visible key and, with a window, starts at the
// first row's first visible key, which replaces the TPU kernel's
// host-enumerated band grid. Each warp owns 16 query rows end to end
// (scores, softmax, accumulator), so the only block-wide barriers are the
// two around each K/V tile load. Later work: wgmma, TMA and a producer
// warp, as the bound forms have them (flash_fwd_bound_sm90.cuh).
//
// Numerics follow the TPU kernel (see flash_fwd_body.cuh for what a tile
// pair computes): m, l carried per row, O = acc / l, LSE = m·ln2 + ln l; a
// row with no visible key gets O = 0 and LSE = NEG_INF. The kernel can be
// launched behind a device-side guard: it then exits at once unless the
// bound form before it counted a loose row, which is how the loose-bound
// fallback runs without a host round trip.

#include "flash_fwd_body.cuh"

using namespace cfa_fwd_body;

namespace {

// The online-softmax step for the warp's 16 rows of one tile pair; lane
// owns columns lane and lane + 32. With MASKED false every pair is visible
// and no element is tested.
template <int D, bool EXTRA, bool MASKED>
__device__ __forceinline__ void online_rows(
    const Args& a, const Extras<EXTRA>& x, const float* ss, const float* kscs,
    const float* vscs, const int* qsegs, const int* ksegs, bf16* ps,
    float* os, float* ms, float* ls, int r0, int q0, int c0) {
  using S = Smem<D>;
  const int lane = threadIdx.x % 32;
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int row = r0 + rr;
    const int qpos = q0 + row + a.kv_offset;
    float s[BK / 32];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      const int c = lane + 32 * j;
      const bool ok = !MASKED || visible(a, x, qpos, c0 + c,
                                         x.seg ? qsegs[row] : 0,
                                         x.seg ? ksegs[c] : 0);
      s[j] = ok ? score<D>(ss, row, c, x.quant, kscs) : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_prev = ms[row];
    const float m_next = fmaxf(m_prev, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      const int c = lane + 32 * j;
      // a fully masked row has m_next = NEG_INF: force its p to 0
      const float p = !MASKED || s[j] > kNegInf * 0.5f
                          ? exp2f(s[j] - m_next) : 0.f;
      sum += p;
      ps[row * S::LDP + c] = __float2bfloat16(x.quant ? p * vscs[c] : p);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float alpha = exp2f(m_prev - m_next);
#pragma unroll
    for (int c = lane; c < D; c += 32) os[row * S::LDO + c] *= alpha;
    __syncwarp();
    if (lane == 0) {
      ms[row] = m_next;
      ls[row] = ls[row] * alpha + sum;
    }
  }
}

template <int D, bool EXTRA>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(Args a) {
  if (a.guard != nullptr && *a.guard == 0) return;
  const Extras<EXTRA> x(a);

  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + S::q_off);
  bf16* ks = reinterpret_cast<bf16*>(smem + S::k_off);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::v_off);
  bf16* ps = reinterpret_cast<bf16*>(smem + S::p_off);
  float* ss = reinterpret_cast<float*>(smem + S::s_off);
  float* os = reinterpret_cast<float*>(smem + S::o_off);
  float* ms = reinterpret_cast<float*>(smem + S::m_off);
  float* ls = reinterpret_cast<float*>(smem + S::l_off);
  float* kscs = reinterpret_cast<float*>(smem + S::ksc_off);
  float* vscs = reinterpret_cast<float*>(smem + S::vsc_off);
  int* qsegs = reinterpret_cast<int*>(smem + S::qseg_off);
  int* ksegs = reinterpret_cast<int*>(smem + S::kseg_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);  // GQA: KV head shared by a group
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * ROWS_PER_WARP;  // this warp's first row in the tile
  const bool quant = x.quant;
  const bool seg = x.seg;
  const int k_type = EXTRA ? a.k_type : kBf16;
  const int v_type = EXTRA ? a.v_type : kBf16;
  const long long row_base = (long long)(b * a.H + h) * a.Nq;

  load_tile<D, BQ>(qs, S::LDH,
                   static_cast<const bf16*>(a.q) + b * a.sqb + h * a.sqh,
                   a.sqn, q0, a.Nq);
  for (int i = threadIdx.x; i < BQ * S::LDO; i += NTHREADS) os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }
  if (seg) load_ids(qsegs, a.q_seg + (long long)b * a.Nq, q0, a.Nq, -1);

  const float* ksc_g =
      quant ? a.k_scale + (long long)(b * a.Hkv + hk) * a.Nk : nullptr;
  const float* vsc_g =
      quant ? a.v_scale + (long long)(b * a.Hkv + hk) * a.Nk : nullptr;
  const uint8_t* kb = static_cast<const uint8_t*>(a.k) +
                      (b * a.skb + hk * a.skh) * (k_type == kBf16 ? 2 : 1);
  const uint8_t* vb = static_cast<const uint8_t*>(a.v) +
                      (b * a.svb + hk * a.svh) * (v_type == kBf16 ? 2 : 1);

  // KV tiles this Q tile can see: causal rows see keys <= row + kv_offset
  // and, with a window, keys > row + kv_offset − window
  int kv_end = a.Nk;
  int t_begin = 0;
  if (a.causal) {
    kv_end = min(a.Nk, max(0, q0 + BQ + a.kv_offset));
    if (x.window > 0) {
      t_begin = max(0, q0 + a.kv_offset - x.window + 1) / BK;
    }
  }
  const int n_tiles = (kv_end + BK - 1) / BK;

  for (int t = t_begin; t < n_tiles; ++t) {
    const int c0 = t * BK;
    __syncthreads();  // previous tile's K/V reads are done (and Q/O init)
    load_kv<D>(ks, kb, k_type, a.skn, c0, a.Nk);
    load_kv<D>(vs, vb, v_type, a.svn, c0, a.Nk);
    if (quant) {
      load_scales(kscs, ksc_g, c0, a.Nk);
      load_scales(vscs, vsc_g, c0, a.Nk);
    }
    if (seg) load_ids(ksegs, a.kv_seg + (long long)b * a.Nk, c0, a.Nk, -2);
    __syncthreads();

    qk_bf16<D>(qs, ks, ss, r0);
    __syncwarp();

    if (all_visible(a, x, q0 + r0 + a.kv_offset, c0)) {
      online_rows<D, EXTRA, false>(a, x, ss, kscs, vscs, qsegs, ksegs, ps, os,
                                   ms, ls, r0, q0, c0);
    } else {
      online_rows<D, EXTRA, true>(a, x, ss, kscs, vscs, qsegs, ksegs, ps, os,
                                  ms, ls, r0, q0, c0);
    }
    __syncwarp();

    pv<D>(os, ps, vs, r0, false);
    __syncwarp();
  }
  __syncthreads();  // Q/O init is visible when no tile ran

  // epilogue; the ragged Q tail is skipped
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int row = r0 + rr;
    const int qi = q0 + row;
    if (qi >= a.Nq) break;
    const float l = ls[row];
    const float inv = l == 0.f ? 0.f : 1.f / l;
    for (int c = lane; c < D; c += 32) {
      const float val = os[row * S::LDO + c] * inv;
      if (a.out_f32) {
        static_cast<float*>(a.o)[(row_base + qi) * D + c] = val;
      } else {
        static_cast<bf16*>(a.o)[(row_base + qi) * D + c] =
            __float2bfloat16(val);
      }
    }
    if (lane == 0) {
      a.lse[row_base + qi] = l == 0.f ? kNegInf : ms[row] * kLn2 + logf(l);
    }
  }
}

template <int D, bool EXTRA>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, EXTRA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Nq + BQ - 1) / BQ, a.H, B);
  flash_fwd_kernel<D, EXTRA><<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_extra(const Args& a, int B, cudaStream_t stream) {
  // the build without the extras serves a call that uses none of them
  const bool extra =
      a.k_scale != nullptr || a.q_seg != nullptr || a.window > 0;
  return extra ? launch<D, true>(a, B, stream)
               : launch<D, false>(a, B, stream);
}

}  // namespace

// K1, behind `guard` when that is not null. ptrs: q, k, v, k_scale,
// v_scale, q_seg, kv_seg, guard, o, lse (null where a call has no use for
// one). strides: q, k, v, each (batch, head, row), in elements.
// k_type/v_type: 0 bf16, 1 int8, 2 fp8 e4m3.
extern "C" int cfa_flash_fwd(void* const* ptrs, int B, int H, int Hkv, int Nq,
                             int Nk, int D, const long long* strides,
                             int k_type, int v_type, int causal, int window,
                             int kv_offset, int out_f32, void* stream) {
  if (B == 0 || H == 0 || Nq == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  Args a = {};
  a.q = ptrs[0];
  a.k = ptrs[1];
  a.v = ptrs[2];
  a.k_scale = static_cast<const float*>(ptrs[3]);
  a.v_scale = static_cast<const float*>(ptrs[4]);
  a.q_seg = static_cast<const int*>(ptrs[5]);
  a.kv_seg = static_cast<const int*>(ptrs[6]);
  a.guard = static_cast<const int*>(ptrs[7]);
  a.o = ptrs[8];
  a.lse = static_cast<float*>(ptrs[9]);
  a.H = H; a.Hkv = Hkv; a.Nq = Nq; a.Nk = Nk;
  a.sqb = strides[0]; a.sqh = strides[1]; a.sqn = strides[2];
  a.skb = strides[3]; a.skh = strides[4]; a.skn = strides[5];
  a.svb = strides[6]; a.svh = strides[7]; a.svn = strides[8];
  a.k_type = k_type; a.v_type = v_type;
  a.causal = causal; a.window = window; a.kv_offset = kv_offset;
  a.out_f32 = out_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_extra<64>(a, B, s);
    case 128:
      return launch_extra<128>(a, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* cfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
