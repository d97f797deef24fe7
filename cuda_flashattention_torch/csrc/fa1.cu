// FlashAttention-1 forward for Hopper, bf16 in and out: the ladder rung
// whose O is renormalised after every K/V block instead of once at the
// end. Forward only, O only, no GQA.
//
// Replaces: cuda_flashattention_tpu/ops/fa1.py::_fa1_kernel.
//
// What bounds it on the H100: operations, as the FA2 forward — 4·N²·d
// flops of products over 4·N·d bytes per head — and in this form as much
// the fp32 softmax and the shared-memory round trips of S, P and O as the
// tensor cores. It is kept for what it computes, not for its speed.
//
// What this design does about it: the TPU kernel holds a head's whole K
// and V in VMEM, which 227 KB of shared memory cannot and need not: one
// CTA per (batch, head, 64-row Q tile) streams K and V through one shared
// 64-key buffer. A renormalising block is `n_sub` such sub-tiles (block_k
// = 64·n_sub ≤ 256 keys): first every K sub-tile of the block gives its
// 64 columns of S (wmma bf16, fp32 accumulate), then the block's softmax
// runs over all its columns at once, as the TPU kernel's does, then every
// V sub-tile adds its share of P·V. Each warp owns 16 query rows end to
// end, so the only block-wide barriers are those around a sub-tile load.
// A causal Q tile stops at the block that holds its last visible key.
//
// Numerics follow the TPU kernel: Q arrives pre-scaled by `scale`
// (rounded in Q's dtype by the host), natural exp, masked scores at
// NEG_INF with probability 0, P rounded to bf16 before P·V, and per block
//   o = (l_prev · alpha · o_prev + P·V) / max(l_new, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;       // query rows per CTA
constexpr int BKS = 64;      // keys per streamed sub-tile
constexpr int MAX_SUB = 4;   // sub-tiles per renormalising block, at most
constexpr int BK_MAX = BKS * MAX_SUB;
constexpr int NWARPS = 4;    // each warp owns BQ / NWARPS = 16 rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS_PER_WARP = BQ / NWARPS;

template <int D>
struct Smem {
  // padded leading dimensions (elements); every wmma tile pointer stays
  // 32-byte aligned
  static constexpr int LDH = D + 8;        // bf16 Q tile and K/V sub-tile
  static constexpr int LDS = BK_MAX + 4;   // fp32 scores of a block
  static constexpr int LDP = BK_MAX + 8;   // bf16 probabilities of a block
  static constexpr int LDO = D + 4;        // fp32 normalised output
  static constexpr size_t q_off = 0;
  static constexpr size_t kv_off = q_off + sizeof(__nv_bfloat16) * BQ * LDH;
  static constexpr size_t p_off = kv_off + sizeof(__nv_bfloat16) * BKS * LDH;
  static constexpr size_t s_off = p_off + sizeof(__nv_bfloat16) * BQ * LDP;
  static constexpr size_t o_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t m_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t bytes = l_off + sizeof(float) * BQ;
};

// Copy ROWS rows of D bf16 (row stride `stride` elements) into a padded
// shared tile; rows at or past `valid` are zero-filled.
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
fa1_kernel(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           __nv_bfloat16* __restrict__ o, int H, int Nq, int Nk,
           long long sqb, long long sqh, long long sqn,
           long long skb, long long skh, long long skn,
           long long svb, long long svh, long long svn,
           int causal, int n_sub) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + S::q_off);
  __nv_bfloat16* kvs = reinterpret_cast<__nv_bfloat16*>(smem + S::kv_off);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + S::p_off);
  float* ss = reinterpret_cast<float*>(smem + S::s_off);
  float* os = reinterpret_cast<float*>(smem + S::o_off);
  float* ms = reinterpret_cast<float*>(smem + S::m_off);
  float* ls = reinterpret_cast<float*>(smem + S::l_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * ROWS_PER_WARP;  // this warp's first row in the tile

  const __nv_bfloat16* qb = q + b * sqb + h * sqh;
  const __nv_bfloat16* kb = k + b * skb + h * skh;
  const __nv_bfloat16* vb = v + b * svb + h * svh;

  load_tile<D, BQ>(qs, S::LDH, qb, sqn, q0, Nq);
  for (int i = threadIdx.x; i < BQ * S::LDO; i += NTHREADS) os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }

  // causal rows see keys <= row: the tile's last row bounds its walk
  const int kv_end = causal ? min(Nk, q0 + BQ) : Nk;
  const int block_k = n_sub * BKS;
  const int n_blocks = (kv_end + block_k - 1) / block_k;

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int c0 = blk * block_k;

    // S[r0:r0+16, block] = Q[r0:r0+16, :] · Kᵀ, one K sub-tile at a time
    for (int sub = 0; sub < n_sub; ++sub) {
      const int cs = c0 + sub * BKS;
      if (cs >= kv_end) break;  // the same for every thread of the CTA
      __syncthreads();  // earlier reads of the buffer are done
      load_tile<D, BKS>(kvs, S::LDH, kb, skn, cs, Nk);
      __syncthreads();
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BKS / 16];
#pragma unroll
      for (int nb = 0; nb < BKS / 16; ++nb) wmma::fill_fragment(acc[nb], 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, qs + r0 * S::LDH + kk * 16, S::LDH);
#pragma unroll
        for (int nb = 0; nb < BKS / 16; ++nb) {
          // Kᵀ as a column-major B: element (kk, n) sits at K[n][kk]
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fb;
          wmma::load_matrix_sync(fb, kvs + nb * 16 * S::LDH + kk * 16,
                                 S::LDH);
          wmma::mma_sync(acc[nb], fa, fb, acc[nb]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < BKS / 16; ++nb) {
        wmma::store_matrix_sync(ss + r0 * S::LDS + sub * BKS + nb * 16,
                                acc[nb], S::LDS, wmma::mem_row_major);
      }
    }
    __syncwarp();

    // the block's softmax over this warp's rows; lane owns columns
    // lane + 32·j. Columns of sub-tiles that were not computed are masked
    // (they lie at or past kv_end), so their stale scores are never used.
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int row = r0 + rr;
      const int qrow = q0 + row;
      float s[2 * MAX_SUB];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2 * MAX_SUB; ++j) {
        s[j] = kNegInf;
        if (j < 2 * n_sub) {
          const int col = c0 + lane + 32 * j;
          const bool ok = col < kv_end && (!causal || col <= qrow);
          if (ok) s[j] = ss[row * S::LDS + lane + 32 * j];
        }
        mx = fmaxf(mx, s[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ms[row];
      const float l_prev = ls[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * MAX_SUB; ++j) {
        if (j < 2 * n_sub) {
          const float p = s[j] > kNegInf * 0.5f ? __expf(s[j] - m_new) : 0.f;
          sum += p;
          ps[row * S::LDP + lane + 32 * j] = __float2bfloat16(p);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = __expf(m_prev - m_new);
      // o_prev is normalised: weight it back by l_prev · alpha
      const float back = l_prev * alpha;
#pragma unroll
      for (int c = lane; c < D; c += 32) os[row * S::LDO + c] *= back;
      __syncwarp();
      if (lane == 0) {
        ms[row] = m_new;
        ls[row] = l_prev * alpha + sum;
      }
    }
    __syncwarp();

    // O[r0:r0+16, :] += P[r0:r0+16, block] · V, one V sub-tile at a time
    for (int sub = 0; sub < n_sub; ++sub) {
      const int cs = c0 + sub * BKS;
      if (cs >= kv_end) break;
      __syncthreads();
      load_tile<D, BKS>(kvs, S::LDH, vb, svn, cs, Nk);
      __syncthreads();
#pragma unroll
      for (int nb = 0; nb < D / 16; ++nb) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, os + r0 * S::LDO + nb * 16, S::LDO,
                               wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BKS / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(fa, ps + r0 * S::LDP + sub * BKS + kk * 16,
                                 S::LDP);
          wmma::load_matrix_sync(fb, kvs + kk * 16 * S::LDH + nb * 16,
                                 S::LDH);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(os + r0 * S::LDO + nb * 16, acc, S::LDO,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();

    // the FA1 step: O is divided by the new l after every block
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int row = r0 + rr;
      const float inv = 1.f / fmaxf(ls[row], 1e-30f);
#pragma unroll
      for (int c = lane; c < D; c += 32) os[row * S::LDO + c] *= inv;
    }
    __syncwarp();
  }
  __syncthreads();  // the O init is visible when no block ran

  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int row = r0 + rr;
    const int qi = q0 + row;
    if (qi >= Nq) break;
    const long long orow = ((long long)(b * H + h) * Nq + qi) * D;
    for (int c = lane; c < D; c += 32) {
      o[orow + c] = __float2bfloat16(os[row * S::LDO + c]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Nq, int Nk, const long long* st,
                   int causal, int n_sub, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fa1_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + BQ - 1) / BQ, H, B);
  fa1_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      Nq, Nk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      causal, n_sub);
  return cudaGetLastError();
}

}  // namespace

// q/k/v [B, H, N, D] bf16 with unit stride on D; `strides` holds the
// (batch, head, row) strides of q, k and v in elements; o [B, H, Nq, D]
// contiguous bf16. A renormalising block is n_sub (1..4) sub-tiles of 64
// keys.
extern "C" int cfa_fa1(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int Nq, int Nk, int D,
                       const long long* strides, int causal, int n_sub,
                       void* stream) {
  if (B == 0 || H == 0 || Nq == 0) return cudaSuccess;
  if (n_sub < 1 || n_sub > MAX_SUB) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, B, H, Nq, Nk, strides, causal, n_sub, s);
    case 128:
      return launch<128>(q, k, v, o, B, H, Nq, Nk, strides, causal, n_sub, s);
    default:
      return cudaErrorInvalidValue;
  }
}
