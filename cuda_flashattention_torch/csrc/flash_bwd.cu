// FlashAttention-2 backward for Hopper, bf16 in, fp32 accumulation:
// dK/dV (K2), dQ (K3), and dQ/dK/dV in one pass (K4).
//
// Replaces: cuda_flashattention_tpu/ops/flash_bwd.py::_bwd_dkdv_kernel
// (K2), ::_bwd_dq_kernel (K3) and ::_bwd_fused_kernel (K4).
//
// What bounds them on the H100: per visible (Q tile, K/V tile) pair the
// backward does 4 (K2), 3 (K3) or 5 (K4) products of 2·64·64·d flops on
// tiles that are read once per pair, so at the training shapes (N = 4096,
// d = 128) they are compute-bound like the forward. In this first version
// the tensor-core products are not the limit: the fp32 round trips of S,
// dP and the accumulators through shared memory, the block barriers
// around every tile, and (K4) the fp32 atomics into dQ are.
//
// What this design does about it: the products run on the tensor cores
// through nvcuda::wmma bf16 fragments with fp32 accumulation, and each CTA
// keeps its resident operands in shared memory for its whole walk.
//  - K2: one CTA per (batch, KV head, 64-key tile). K_j and V_j stay
//    resident; the CTA walks the G query heads of its group and the Q
//    tiles that can see tile j (causal: from (j·BK − kv_offset) / BQ on,
//    which replaces the TPU host's block clamping). dK and dV accumulate
//    in fp32 shared memory across the whole group and are cast once.
//  - K4: K2's walk plus dQ_i += dS·K_j, added with fp32 atomicAdd into a
//    zeroed fp32 [B,H,Nq,d] buffer. The TPU kernel keeps the full-sequence
//    gradient state in VMEM; 227 KB of shared memory cannot, so this is the
//    GPU form (the reference CUDA backward's own design). It is K2's body
//    with one template parameter.
//  - K3: one CTA per (batch, head, 64-row Q tile), walking the visible
//    K/V tiles of head h // G; each warp owns 16 rows end to end, so only
//    the K/V tile loads need block barriers.
// Shared memory at d = 128: four bf16 tiles (Q, dO, K, V) 68 KB, fp32 S
// and dP 34 KB, bf16 P and dS 18 KB, two fp32 accumulators 66 KB: about
// 187 KB, one CTA per SM. K4's dQ partial reuses the S/dP space.
//
// Numerics follow the TPU kernels (flash_bwd.py:53-114): S is recomputed
// from the raw q as fp32 q·kᵀ times scale·log2(e); P = exp2(S − LSE·log2e)
// with P = 0 for masked entries and for rows whose LSE < NEG_INF/2;
// dP = dO·Vᵀ and dS = P ⊙ (dP − D)·scale in fp32; P is rounded to bf16
// before dV += Pᵀ·dO and dS before dK += dSᵀ·Q and dQ += dS·K. A K/V tile
// that no query sees, or a Q tile that sees no key, writes zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr double kLog2e = 1.4426950408889634;
constexpr int BQ = 64;      // query rows per tile
constexpr int BK = 64;      // keys per tile
constexpr int NWARPS = 4;   // each warp owns 16 rows of a tile
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS = 16;
static_assert(BQ == NWARPS * ROWS && BK == NWARPS * ROWS,
              "a warp owns 16 query rows and 16 key rows");

template <int D>
struct Smem {
  // padded leading dimensions (elements); every wmma tile pointer stays
  // 32-byte aligned and rows fall on different banks
  static constexpr int LDH = D + 8;   // bf16 Q, dO, K, V tiles
  static constexpr int LDS = BK + 4;  // fp32 S and dP
  static constexpr int LDP = BK + 8;  // bf16 P and dS
  static constexpr int LDA = D + 4;   // fp32 accumulators
  static constexpr size_t tile_h = sizeof(bf16) * BQ * LDH;
  static constexpr size_t tile_s = sizeof(float) * BQ * LDS;
  static constexpr size_t tile_p = sizeof(bf16) * BQ * LDP;
  static constexpr size_t tile_a = sizeof(float) * BQ * LDA;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + tile_h;
  static constexpr size_t q_off = v_off + tile_h;
  static constexpr size_t do_off = q_off + tile_h;
  static constexpr size_t s_off = do_off + tile_h;
  static constexpr size_t dp_off = s_off + tile_s;
  static constexpr size_t p_off = dp_off + tile_s;
  static constexpr size_t ds_off = p_off + tile_p;
  static constexpr size_t acc_off = ds_off + tile_p;   // dK (K2/K4), dQ (K3)
  static constexpr size_t acc2_off = acc_off + tile_a; // dV (K2/K4)
  static constexpr size_t lse_off = acc2_off + tile_a;
  static constexpr size_t delta_off = lse_off + sizeof(float) * BQ;
  static constexpr size_t bytes = delta_off + sizeof(float) * BQ;
  // K4's per-tile dQ partial reuses S and dP once dS is formed
  static_assert(tile_a <= 2 * tile_s, "dQ scratch must fit in S + dP");
  static_assert(bytes <= 232448, "over the 227 KB a CTA may use");
};

// Copy `ROWS_` rows of D bf16 (row stride `stride` elements) into a padded
// shared tile; rows at or past `valid` are zero-filled.
template <int D, int ROWS_>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long stride, int row0,
                                          int valid) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < ROWS_ * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// The Q tile's LSE in log2 units (+inf for rows past Nq or with no visible
// key, so that their P is 0, as the TPU kernel's `lse_safe`) and its D.
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, int q0,
                                          int Nq) {
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    const int qi = q0 + r;
    const float l = qi < Nq ? lse[qi] : kNegInf;
    lse_s[r] = l < kNegInf * 0.5f ? INFINITY : l * (float)kLog2e;
    delta_s[r] = qi < Nq ? delta[qi] : 0.f;
  }
}

// S = Q·Kᵀ and dP = dO·Vᵀ for the warp's 16 query rows r0.. (fp32).
template <int D>
__device__ __forceinline__ void scores(const bf16* qs, const bf16* dos,
                                       const bf16* ks, const bf16* vs,
                                       float* ss, float* dps, int r0) {
  using S = Smem<D>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> s[BK / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dp[BK / 16];
#pragma unroll
  for (int nb = 0; nb < BK / 16; ++nb) {
    wmma::fill_fragment(s[nb], 0.f);
    wmma::fill_fragment(dp[nb], 0.f);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq, fdo;
    wmma::load_matrix_sync(fq, qs + r0 * S::LDH + kk * 16, S::LDH);
    wmma::load_matrix_sync(fdo, dos + r0 * S::LDH + kk * 16, S::LDH);
#pragma unroll
    for (int nb = 0; nb < BK / 16; ++nb) {
      // Kᵀ (and Vᵀ) as a column-major B: element (kk, n) sits at K[n][kk]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, ks + nb * 16 * S::LDH + kk * 16, S::LDH);
      wmma::mma_sync(s[nb], fq, fb, s[nb]);
      wmma::load_matrix_sync(fb, vs + nb * 16 * S::LDH + kk * 16, S::LDH);
      wmma::mma_sync(dp[nb], fdo, fb, dp[nb]);
    }
  }
#pragma unroll
  for (int nb = 0; nb < BK / 16; ++nb) {
    wmma::store_matrix_sync(ss + r0 * S::LDS + nb * 16, s[nb], S::LDS,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(dps + r0 * S::LDS + nb * 16, dp[nb], S::LDS,
                            wmma::mem_row_major);
  }
}

// P and dS for the warp's 16 rows, rounded to bf16. q0/c0: first query
// row and first key of the tiles; lane owns columns lane and lane + 32.
template <int D>
__device__ __forceinline__ void probs_and_ds(
    const float* ss, const float* dps, const float* lse_s,
    const float* delta_s, bf16* ps, bf16* dss, int r0, int q0, int c0,
    int Nk, int causal, int kv_offset, float scale_log2e, float scale) {
  using S = Smem<D>;
  const int lane = threadIdx.x % 32;
  for (int rr = 0; rr < ROWS; ++rr) {
    const int row = r0 + rr;
    const int qpos = q0 + row + kv_offset;  // causal position of the row
    const float lse2 = lse_s[row];
    const float dl = delta_s[row];
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      const int c = lane + 32 * j;
      const int col = c0 + c;
      const bool ok = col < Nk && (!causal || col <= qpos);
      const float p =
          ok ? exp2f(ss[row * S::LDS + c] * scale_log2e - lse2) : 0.f;
      const float ds = p * (dps[row * S::LDS + c] - dl) * scale;
      ps[row * S::LDP + c] = __float2bfloat16(p);
      dss[row * S::LDP + c] = __float2bfloat16(ds);
    }
  }
}

// acc[r0:r0+16, :] += Aᵀ · B for a bf16 [BQ, BK] A (P or dS) and a bf16
// [BQ, D] B (dO or Q): the warp's 16 key rows of dV or dK.
template <int D>
__device__ __forceinline__ void accumulate_t(float* acc, const bf16* a,
                                             const bf16* b, int r0) {
  using S = Smem<D>;
#pragma unroll
  for (int nb = 0; nb < D / 16; ++nb) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> f;
    wmma::load_matrix_sync(f, acc + r0 * S::LDA + nb * 16, S::LDA,
                           wmma::mem_row_major);
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      // Aᵀ as a column-major A: element (m, k) sits at A[k][r0 + m]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a + kq * 16 * S::LDP + r0, S::LDP);
      wmma::load_matrix_sync(fb, b + kq * 16 * S::LDH + nb * 16, S::LDH);
      wmma::mma_sync(f, fa, fb, f);
    }
    wmma::store_matrix_sync(acc + r0 * S::LDA + nb * 16, f, S::LDA,
                            wmma::mem_row_major);
  }
}

// out[r0:r0+16, :] (+)= dS[r0:r0+16, :] · K: the warp's 16 rows of dQ.
// With `fresh` the previous contents of `out` are ignored.
template <int D>
__device__ __forceinline__ void accumulate_dq(float* out, const bf16* dss,
                                              const bf16* ks, int r0,
                                              bool fresh) {
  using S = Smem<D>;
#pragma unroll
  for (int nb = 0; nb < D / 16; ++nb) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> f;
    if (fresh) {
      wmma::fill_fragment(f, 0.f);
    } else {
      wmma::load_matrix_sync(f, out + r0 * S::LDA + nb * 16, S::LDA,
                             wmma::mem_row_major);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, dss + r0 * S::LDP + kk * 16, S::LDP);
      wmma::load_matrix_sync(fb, ks + kk * 16 * S::LDH + nb * 16, S::LDH);
      wmma::mma_sync(f, fa, fb, f);
    }
    wmma::store_matrix_sync(out + r0 * S::LDA + nb * 16, f, S::LDA,
                            wmma::mem_row_major);
  }
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // [B, H, Nq], natural log
  const float* delta;  // [B, H, Nq], rowsum(dO ⊙ O)
  bf16* dq;            // [B, H, Nq, D] (K3)
  bf16* dk;            // [B, Hkv, Nk, D] (K2, K4)
  bf16* dv;
  float* dq_acc;       // [B, H, Nq, D] fp32, zeroed (K4)
  int H, Hkv, Nq, Nk;
  long long sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob, soh, son;
  float scale_log2e, scale;
  int causal, kv_offset;
};

// K2 (FUSED = false) and K4 (FUSED = true): one CTA per (key tile, KV
// head, batch).
template <int D, bool FUSED>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_kv_kernel(Args a) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + S::k_off);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::v_off);
  bf16* qs = reinterpret_cast<bf16*>(smem + S::q_off);
  bf16* dos = reinterpret_cast<bf16*>(smem + S::do_off);
  float* ss = reinterpret_cast<float*>(smem + S::s_off);
  float* dps = reinterpret_cast<float*>(smem + S::dp_off);
  bf16* ps = reinterpret_cast<bf16*>(smem + S::p_off);
  bf16* dss = reinterpret_cast<bf16*>(smem + S::ds_off);
  float* dk_acc = reinterpret_cast<float*>(smem + S::acc_off);
  float* dv_acc = reinterpret_cast<float*>(smem + S::acc2_off);
  float* lse_s = reinterpret_cast<float*>(smem + S::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + S::delta_off);
  float* dq_part = ss;  // K4: this tile pair's dQ, once S/dP are spent

  const int c0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.H / a.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;

  load_tile<D, BK>(ks, S::LDH, a.k + b * a.skb + hk * a.skh, a.skn, c0,
                   a.Nk);
  load_tile<D, BK>(vs, S::LDH, a.v + b * a.svb + hk * a.svh, a.svn, c0,
                   a.Nk);
  for (int i = threadIdx.x; i < BK * S::LDA; i += NTHREADS) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  const int n_q_tiles = (a.Nq + BQ - 1) / BQ;
  // causal: Q tile i sees this key tile iff (i+1)·BQ − 1 + kv_offset ≥ c0
  const int first = a.causal ? max(0, c0 - a.kv_offset) / BQ : 0;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const bf16* qb = a.q + b * a.sqb + h * a.sqh;
    const bf16* dob = a.dout + b * a.sob + h * a.soh;
    const long long row_base = (long long)(b * a.H + h) * a.Nq;
    for (int it = first; it < n_q_tiles; ++it) {
      const int q0 = it * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<D, BQ>(qs, S::LDH, qb, a.sqn, q0, a.Nq);
      load_tile<D, BQ>(dos, S::LDH, dob, a.son, q0, a.Nq);
      load_rows(lse_s, delta_s, a.lse + row_base, a.delta + row_base, q0,
                a.Nq);
      __syncthreads();

      scores<D>(qs, dos, ks, vs, ss, dps, r0);
      __syncwarp();
      probs_and_ds<D>(ss, dps, lse_s, delta_s, ps, dss, r0, q0, c0, a.Nk,
                      a.causal, a.kv_offset, a.scale_log2e, a.scale);
      __syncthreads();  // P and dS of every row are in place

      // the warp's 16 keys: dV += Pᵀ·dO, dK += dSᵀ·Q
      accumulate_t<D>(dv_acc, ps, dos, r0);
      accumulate_t<D>(dk_acc, dss, qs, r0);

      if (FUSED) {
        // the warp's 16 query rows: dQ += dS·K, added to device memory
        accumulate_dq<D>(dq_part, dss, ks, r0, true);
        __syncwarp();
        for (int rr = 0; rr < ROWS; ++rr) {
          const int qi = q0 + r0 + rr;
          if (qi >= a.Nq) break;
          float* dst = a.dq_acc + (row_base + qi) * D;
          for (int c = lane; c < D; c += 32) {
            atomicAdd(dst + c, dq_part[(r0 + rr) * S::LDA + c]);
          }
        }
      }
    }
  }
  __syncthreads();  // accumulator init is visible when no Q tile ran

  // epilogue: dK, dV cast once; the ragged key tail is skipped, and a key
  // tile that no query sees writes its zeros
  const long long kv_base = (long long)(b * a.Hkv + hk) * a.Nk;
  for (int i = threadIdx.x; i < BK * D; i += NTHREADS) {
    const int r = i / D;
    const int c = i % D;
    if (c0 + r >= a.Nk) break;
    const long long o = (kv_base + c0 + r) * D + c;
    a.dk[o] = __float2bfloat16(dk_acc[r * S::LDA + c]);
    a.dv[o] = __float2bfloat16(dv_acc[r * S::LDA + c]);
  }
}

// K3: one CTA per (query tile, head, batch).
template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_q_kernel(Args a) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + S::k_off);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::v_off);
  bf16* qs = reinterpret_cast<bf16*>(smem + S::q_off);
  bf16* dos = reinterpret_cast<bf16*>(smem + S::do_off);
  float* ss = reinterpret_cast<float*>(smem + S::s_off);
  float* dps = reinterpret_cast<float*>(smem + S::dp_off);
  bf16* ps = reinterpret_cast<bf16*>(smem + S::p_off);
  bf16* dss = reinterpret_cast<bf16*>(smem + S::ds_off);
  float* dq_acc = reinterpret_cast<float*>(smem + S::acc_off);
  float* lse_s = reinterpret_cast<float*>(smem + S::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + S::delta_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;
  const long long row_base = (long long)(b * a.H + h) * a.Nq;

  load_tile<D, BQ>(qs, S::LDH, a.q + b * a.sqb + h * a.sqh, a.sqn, q0, a.Nq);
  load_tile<D, BQ>(dos, S::LDH, a.dout + b * a.sob + h * a.soh, a.son, q0,
                   a.Nq);
  load_rows(lse_s, delta_s, a.lse + row_base, a.delta + row_base, q0, a.Nq);
  for (int i = threadIdx.x; i < BQ * S::LDA; i += NTHREADS) dq_acc[i] = 0.f;

  // keys this Q tile can see: causal rows see keys <= row + kv_offset
  int kv_end = a.Nk;
  if (a.causal) kv_end = min(a.Nk, max(0, q0 + BQ + a.kv_offset));
  const int n_tiles = (kv_end + BK - 1) / BK;
  const bf16* kb = a.k + b * a.skb + hk * a.skh;
  const bf16* vb = a.v + b * a.svb + hk * a.svh;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * BK;
    __syncthreads();  // the previous tile's K/V reads are done (and init)
    load_tile<D, BK>(ks, S::LDH, kb, a.skn, c0, a.Nk);
    load_tile<D, BK>(vs, S::LDH, vb, a.svn, c0, a.Nk);
    __syncthreads();

    scores<D>(qs, dos, ks, vs, ss, dps, r0);
    __syncwarp();
    probs_and_ds<D>(ss, dps, lse_s, delta_s, ps, dss, r0, q0, c0, a.Nk,
                    a.causal, a.kv_offset, a.scale_log2e, a.scale);
    __syncwarp();
    accumulate_dq<D>(dq_acc, dss, ks, r0, false);
    __syncwarp();
  }
  __syncthreads();  // accumulator init is visible when no tile ran

  // epilogue: the warp's rows, cast once; the ragged Q tail is skipped
  for (int rr = 0; rr < ROWS; ++rr) {
    const int qi = q0 + r0 + rr;
    if (qi >= a.Nq) break;
    for (int c = lane; c < D; c += 32) {
      a.dq[(row_base + qi) * D + c] =
          __float2bfloat16(dq_acc[(r0 + rr) * S::LDA + c]);
    }
  }
}

cudaError_t launch(void (*kernel)(Args), dim3 grid, size_t smem,
                   const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int H, int Hkv, int Nq,
               int Nk, const long long* strides, double scale, int causal,
               int kv_offset) {
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.H = H;
  a.Hkv = Hkv;
  a.Nq = Nq;
  a.Nk = Nk;
  a.sqb = strides[0]; a.sqh = strides[1]; a.sqn = strides[2];
  a.skb = strides[3]; a.skh = strides[4]; a.skn = strides[5];
  a.svb = strides[6]; a.svh = strides[7]; a.svn = strides[8];
  a.sob = strides[9]; a.soh = strides[10]; a.son = strides[11];
  a.scale_log2e = (float)(scale * kLog2e);
  a.scale = (float)scale;
  a.causal = causal;
  a.kv_offset = kv_offset;
  return a;
}

}  // namespace

// K2 when dq_acc is null, else K4 (which also adds dQ into dq_acc).
// strides: q, k, v, dO, each (batch, head, row), in elements.
extern "C" int cfa_flash_bwd_kv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                void* dq_acc, int B, int H, int Hkv, int Nq,
                                int Nk, int D, const long long* strides,
                                double scale, int causal, int kv_offset,
                                void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  if (B == 0 || Nk == 0) return cudaSuccess;
  Args a = make_args(q, k, v, dout, lse, delta, H, Hkv, Nq, Nk, strides,
                     scale, causal, kv_offset);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dq_acc = static_cast<float*>(dq_acc);
  const dim3 grid((Nk + BK - 1) / BK, Hkv, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fused = dq_acc != nullptr;
  switch (D) {
    case 64:
      return fused ? launch(flash_bwd_kv_kernel<64, true>, grid,
                            Smem<64>::bytes, a, s)
                   : launch(flash_bwd_kv_kernel<64, false>, grid,
                            Smem<64>::bytes, a, s);
    case 128:
      return fused ? launch(flash_bwd_kv_kernel<128, true>, grid,
                            Smem<128>::bytes, a, s)
                   : launch(flash_bwd_kv_kernel<128, false>, grid,
                            Smem<128>::bytes, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// K3. strides as for cfa_flash_bwd_kv.
extern "C" int cfa_flash_bwd_q(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int H,
                               int Hkv, int Nq, int Nk, int D,
                               const long long* strides, double scale,
                               int causal, int kv_offset, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Nq == 0) return cudaSuccess;
  Args a = make_args(q, k, v, dout, lse, delta, H, Hkv, Nq, Nk, strides,
                     scale, causal, kv_offset);
  a.dq = static_cast<bf16*>(dq);
  const dim3 grid((Nq + BQ - 1) / BQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch(flash_bwd_q_kernel<64>, grid, Smem<64>::bytes, a, s);
    case 128:
      return launch(flash_bwd_q_kernel<128>, grid, Smem<128>::bytes, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
