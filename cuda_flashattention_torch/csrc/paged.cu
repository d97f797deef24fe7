// One-token decode attention over a paged KV cache for Hopper: the keys of
// sequence b live in fixed-size pages of a pool shared by all sequences,
// and row b of a page table names the pages in order.
//
// Replaces: cuda_flashattention_tpu/ops/paged.py::_paged_kernel. As there,
// the arithmetic is the contiguous decode's (decode_body.cuh); only the
// walk differs. The TPU kernel gathers through scalar-prefetched index
// maps; here each CTA reads its own table entries.
//
// What bounds it on the H100: bytes, as for the contiguous decode — the
// visible pages of each (sequence, KV head) are read once, 2·len·d·bytes
// plus 4 bytes of table per page — and, at a serving batch, the latency
// of each warp's walk. With a prefill chunk folded into the rows
// (paged_prefix_attention) there are thousands of CTAs and the kernel is
// bound by its CUDA-core dots and the re-read of K/V per 8-row tile; that
// form is written down as slow.
//
// What this design does about it: grid (split of the context, row tile,
// KV head, sequence), the splits those of the contiguous walk
// (decode_body.cuh: the same C from the host's rule, the same partition of
// [first, length) by key index, the same merge). A CTA walks the logical
// pages that hold its split's keys, reads each page's physical id from the
// table and streams that page's keys in the split. It never reads a table
// entry at or past ceil(length/page): those may hold anything. A sequence
// of length 0 reads no page. A page is only a stride, so any page size ≥ 1
// works. Key j of a split starting at lo goes to warp (j − lo) mod
// NWARPS, exactly as in the contiguous walk, so the two kernels sum the
// same keys in the same order and give the same bits on the same cache
// contents.

#include "decode_body.cuh"

namespace {

using namespace cfa_decode_body;

template <int D, typename QT, typename KT, typename VT, bool QQ,
          int R>
__global__ void __launch_bounds__(NTHREADS)
paged_kernel(Args a,
             const KT* __restrict__ k_pages,  // [n_pages, Hkv, page, d]
             const VT* __restrict__ v_pages,
             const int* __restrict__ table,   // [B, max_pages]
             int page, int max_pages) {
  const int s = blockIdx.x % a.nsplit;
  const int tile = blockIdx.x / a.nsplit;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const long long cap = (long long)page * max_pages;
  const int length = (int)min((long long)max(a.lengths[b], 0), cap);
  const int first = first_key(a, b, length);
  int lo, hi, s_first, s_last;
  if (!split_keys(a, first, length, s, lo, hi, s_first, s_last)) return;

  Body<D, QT, KT, VT, QQ, R> body;
  body.init(a, b, hk, tile);
  if (lo < hi) {
    const int last_page = (hi - 1) / page;
    for (int ip = lo / page; ip <= last_page; ++ip) {
      const int pid = table[(long long)b * max_pages + ip];
      const int page0 = ip * page;  // first logical token of the page
      const int p_lo = max(lo, page0);
      const int p_hi = min(hi, page0 + page);
      // first key of this page that belongs to this warp
      int j = p_lo + ((warp - (p_lo - lo)) & (NWARPS - 1));
      const long long base = ((long long)pid * a.Hkv + hk) * page - page0;
      // unrolled as the contiguous walk: four keys' loads in flight
#pragma unroll 4
      for (; j < p_hi; j += NWARPS) {
        const long long t = base + j;  // token slot in the pools
        float ks = 1.f, vs = 1.f;
        if constexpr (Body<D, QT, KT, VT, QQ, R>::kQuant) {
          ks = a.k_scale[t];
          vs = a.v_scale[t];
        }
        body.attend(k_pages + t * a.d, v_pages + t * a.d, ks, vs, a.scale);
      }
    }
  }
  const int tiles = gridDim.x / a.nsplit;
  body.finish(a, ((long long)b * a.Hkv + hk) * tiles + tile, s, s_first,
              s_last);
}

template <int D, typename QT, typename KT, typename VT, bool QQ,
          int R>
struct Launch {
  static cudaError_t run(const Args& a, const void* k, const void* v,
                         const int* table, int B, int page, int max_pages,
                         cudaStream_t stream) {
    dim3 grid(a.nsplit * ((a.rows + R - 1) / R), a.Hkv, B);
    paged_kernel<D, QT, KT, VT, QQ, R><<<grid, NTHREADS, 0, stream>>>(
        a, static_cast<const KT*>(k), static_cast<const VT*>(v), table, page,
        max_pages);
    return cudaGetLastError();
  }
};

}  // namespace

// Pools [n_pages, Hkv, page, D] (D: any row width from 1 to 256, read as
// the pools lie); scale pools [n_pages, Hkv, page] fp32 or
// null; page_table [B, max_pages] int32. The other arguments are those of
// cfa_decode, with page·max_pages in max_n's place for the split's grid
// and scratch (the q type as there: paged_f16.cu's cfa_paged_decode_f16,
// paged_f32.cu's cfa_paged_decode_f32).
extern "C" int cfa_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* k_scale,
                                const void* v_scale, const void* q_sigma,
                                const void* page_table, const void* lengths,
                                const void* windows, void* o, void* lse,
                                void* part, void* tickets, int B, int H,
                                int Hkv, int page, int max_pages, int D,
                                int k_type, int v_type, int qq,
                                int p_round, float scale, int window,
                                int split, void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || page <= 0 || max_pages < 0)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.q_sigma = static_cast<const float*>(q_sigma);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.lengths = static_cast<const int*>(lengths);
  a.windows = static_cast<const int*>(windows);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.rows = H / Hkv;
  a.Hkv = Hkv;
  a.scale = scale;
  a.window = window;
  a.d = D;
  a.p_round = p_round;
  a.vec = vector_loads(D, q, qq ? 1 : (int)sizeof(DecodeQ), k_pages, k_type,
                       v_pages, v_type);
  if (build_dim(D) == 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = prepare_split(&a, B, (long long)page * max_pages, split,
                                  part, tickets, st);
  if (err != cudaSuccess) return err;
  return dispatch<Launch, DecodeQ>(D, a.rows, k_type, v_type, qq, a, k_pages,
                                   v_pages,
                                   static_cast<const int*>(page_table), B,
                                   page, max_pages, st);
}
