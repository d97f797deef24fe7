// FlashAttention-2 forward (online softmax) for Hopper, bf16 in, fp32 or
// bf16 out, with the natural-log LSE per query row.
//
// Replaces: cuda_flashattention_tpu/ops/flash_fwd.py::_fwd_kernel, online
// form (bound=False), with the causal band of its compact grid.
//
// What bounds it on the H100: at the prefill shapes (N = 512..4096,
// d = 128) the two products are ~4·N²·d flops against 4·N·d bytes per
// head, far above the card's ~295 flop/byte balance point, so the kernel
// is compute-bound — on the tensor cores for Q·Kᵀ and P·V and, in this
// first version, as much on the fp32 softmax and the shared-memory round
// trips of S, P and the accumulator.
//
// What this design does about it: the products run on the tensor cores
// through nvcuda::wmma bf16 fragments with fp32 accumulation; one CTA
// holds a 64-row Q tile in shared memory for its whole walk over K/V, so
// Q is read from device memory once and K/V once per Q tile. For causal
// calls the walk stops at the tile's last visible key, which replaces the
// TPU kernel's host-enumerated band grid. Each warp owns 16 query rows
// end to end (scores, softmax, accumulator), so the only block-wide
// barriers are the two around each K/V tile load. Later work: wgmma, TMA
// and a producer warp that prefetches the next tile.
//
// Numerics follow the TPU kernel: Q arrives pre-scaled by scale·log2(e)
// (rounded in Q's dtype by the host), scores are in log2 units and use
// exp2; masked scores are NEG_INF and their probabilities are forced to 0;
// P is rounded to bf16 before P·V; O = acc / l; LSE = m·ln2 + ln l, and a
// row with no visible key gets O = 0 and LSE = NEG_INF.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per K/V tile
constexpr int NWARPS = 4;    // each warp owns BQ / NWARPS = 16 rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS_PER_WARP = BQ / NWARPS;

template <int D>
struct Smem {
  // padded leading dimensions (elements); every wmma tile pointer stays
  // 32-byte aligned and rows fall on different banks
  static constexpr int LDH = D + 8;    // bf16 Q, K, V tiles
  static constexpr int LDS = BK + 4;   // fp32 scores
  static constexpr int LDP = BK + 8;   // bf16 probabilities
  static constexpr int LDO = D + 4;    // fp32 accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(__nv_bfloat16) * BQ * LDH;
  static constexpr size_t v_off = k_off + sizeof(__nv_bfloat16) * BK * LDH;
  static constexpr size_t p_off = v_off + sizeof(__nv_bfloat16) * BK * LDH;
  static constexpr size_t s_off = p_off + sizeof(__nv_bfloat16) * BQ * LDP;
  static constexpr size_t o_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t m_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t bytes = l_off + sizeof(float) * BQ;
};

// Copy `rows` rows of D bf16 (row stride `stride` elements) into a padded
// shared tile of BQ/BK rows; rows at or past `valid` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
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

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 void* __restrict__ o, float* __restrict__ lse,
                 int H, int group, int Nq, int Nk,
                 long long sqb, long long sqh, long long sqn,
                 long long skb, long long skh, long long skn,
                 long long svb, long long svh, long long svn,
                 int causal, int kv_offset, int out_f32) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + S::q_off);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + S::k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + S::v_off);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + S::p_off);
  float* ss = reinterpret_cast<float*>(smem + S::s_off);
  float* os = reinterpret_cast<float*>(smem + S::o_off);
  float* ms = reinterpret_cast<float*>(smem + S::m_off);
  float* ls = reinterpret_cast<float*>(smem + S::l_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;  // GQA: KV head shared by `group` q heads
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * ROWS_PER_WARP;  // this warp's first row in the tile

  const __nv_bfloat16* qb = q + b * sqb + h * sqh;
  const __nv_bfloat16* kb = k + b * skb + hk * skh;
  const __nv_bfloat16* vb = v + b * svb + hk * svh;

  load_tile<D, BQ>(qs, S::LDH, qb, sqn, q0, Nq);
  for (int i = threadIdx.x; i < BQ * S::LDO; i += NTHREADS) os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }

  // KV extent this Q tile can see: causal rows see keys <= row + kv_offset
  int kv_end = Nk;
  if (causal) {
    const int last_row = q0 + BQ - 1 + kv_offset;
    kv_end = min(Nk, max(0, last_row + 1));
  }
  const int n_tiles = (kv_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * BK;
    __syncthreads();  // previous tile's K/V reads are done (and Q/O init)
    load_tile<D, BK>(ks, S::LDH, kb, skn, c0, Nk);
    load_tile<D, BK>(vs, S::LDH, vb, svn, c0, Nk);
    __syncthreads();

    // S[r0:r0+16, :] = Q[r0:r0+16, :] · Kᵀ (fp32 accumulate)
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int nb = 0; nb < BK / 16; ++nb) wmma::fill_fragment(acc[nb], 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, qs + r0 * S::LDH + kk * 16, S::LDH);
#pragma unroll
        for (int nb = 0; nb < BK / 16; ++nb) {
          // Kᵀ as a column-major B: element (kk, n) sits at K[n][kk]
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fb;
          wmma::load_matrix_sync(fb, ks + nb * 16 * S::LDH + kk * 16,
                                 S::LDH);
          wmma::mma_sync(acc[nb], fa, fb, acc[nb]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < BK / 16; ++nb) {
        wmma::store_matrix_sync(ss + r0 * S::LDS + nb * 16, acc[nb], S::LDS,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();

    // online softmax over this warp's rows; lane owns columns lane, lane+32
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int row = r0 + rr;
      const int qrow = q0 + row + kv_offset;  // causal position of the row
      float s[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int col = c0 + lane + 32 * j;
        const bool ok = col < Nk && (!causal || col <= qrow);
        s[j] = ok ? ss[row * S::LDS + lane + 32 * j] : kNegInf;
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
        const float p = s[j] > kNegInf * 0.5f ? exp2f(s[j] - m_next) : 0.f;
        sum += p;
        ps[row * S::LDP + lane + 32 * j] = __float2bfloat16(p);
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
    __syncwarp();

    // O[r0:r0+16, :] += P[r0:r0+16, :] · V
#pragma unroll
    for (int nb = 0; nb < D / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, os + r0 * S::LDO + nb * 16, S::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fa, ps + r0 * S::LDP + kk * 16, S::LDP);
        wmma::load_matrix_sync(fb, vs + kk * 16 * S::LDH + nb * 16, S::LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(os + r0 * S::LDO + nb * 16, acc, S::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();  // Q/O init is visible when no tile ran

  // epilogue: O = acc / l, LSE = m·ln2 + ln l; the ragged Q tail is skipped
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int row = r0 + rr;
    const int qi = q0 + row;
    if (qi >= Nq) break;
    const float l = ls[row];
    const float inv = l == 0.f ? 0.f : 1.f / l;
    const long long orow = ((long long)(b * H + h) * Nq + qi) * D;
    for (int c = lane; c < D; c += 32) {
      const float val = os[row * S::LDO + c] * inv;
      if (out_f32) {
        static_cast<float*>(o)[orow + c] = val;
      } else {
        static_cast<__nv_bfloat16*>(o)[orow + c] = __float2bfloat16(val);
      }
    }
    if (lane == 0) {
      lse[(long long)(b * H + h) * Nq + qi] =
          l == 0.f ? kNegInf : ms[row] * kLn2 + logf(l);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Hkv, int Nq, int Nk,
                   long long sqb, long long sqh, long long sqn,
                   long long skb, long long skh, long long skn,
                   long long svb, long long svh, long long svn,
                   int causal, int kv_offset, int out_f32,
                   cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), o, static_cast<float*>(lse), H,
      H / Hkv, Nq, Nk, sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, causal,
      kv_offset, out_f32);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cfa_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Hkv,
                             int Nq, int Nk, int D, long long sqb,
                             long long sqh, long long sqn, long long skb,
                             long long skh, long long skn, long long svb,
                             long long svh, long long svn, int causal,
                             int kv_offset, int out_f32, void* stream) {
  if (B == 0 || H == 0 || Nq == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, H, Hkv, Nq, Nk, sqb, sqh, sqn,
                        skb, skh, skn, svb, svh, svn, causal, kv_offset,
                        out_f32, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, H, Hkv, Nq, Nk, sqb, sqh, sqn,
                         skb, skh, skn, svb, svh, svn, causal, kv_offset,
                         out_f32, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* cfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
