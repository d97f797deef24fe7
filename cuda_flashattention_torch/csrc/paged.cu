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
// plus 4 bytes of table per page. With a prefill chunk folded into the
// rows (paged_prefix_attention) there are thousands of CTAs and the kernel
// is bound by its CUDA-core dots and the re-read of K/V per 8-row tile;
// that form is written down as slow.
//
// What this design does about it: grid (split of the context, row tile,
// KV head, sequence), the splits those of the contiguous walk
// (decode_body.cuh: the same C from the host's rule, the same partition of
// [first, length) by key index, the same key tiles at multiples of T, the
// same merge). The producer warp copies each key tile as the runs of keys
// that lie in one page each: a (page, KV head) is one contiguous [page, d]
// slab of the pools, and a run comes in as TMA boxes of g = gcd(page, T)
// rows at multiples of g, so a box never leaves its page or its tile,
// whatever the page size (1 and up; a tile may span many pages, a page
// many tiles); where a box would land off TMA's alignment (g · the slot
// not a multiple of 128 bytes: pages of 1, 2, 4, ... tokens), or the rows
// are not a multiple of 16 bytes, the run comes in by cp.async (or element
// loads). The lanes
// hold a window of 32 table entries, read together and refreshed as the
// walk passes it; no entry at or past ceil(length/page) is read, since
// those may hold anything. A sequence of length 0 reads no page.
// The consumers run TileWalk's steps on the same key slots as the
// contiguous walk, so the two kernels sum the same keys in the same order
// and give the same bits on the same cache contents; rows no cp.async can
// take come in by shifted loads, as in decode.cu.

#include "decode_body.cuh"

namespace {

using namespace cfa_decode_body;

template <int D, typename QT, typename KT, typename VT, bool QQ,
          int R>
__global__ void __launch_bounds__(TILE_THREADS, 3)
paged_kernel(const __grid_constant__ CUtensorMap mk,  // over the pools (tma)
             const __grid_constant__ CUtensorMap mv, Args a,
             const KT* __restrict__ k_pages,  // [n_pages, Hkv, page, d]
             const VT* __restrict__ v_pages,
             const int* __restrict__ table,   // [B, max_pages]
             int page, int max_pages) {
  using W = TileWalk<D, QT, KT, VT, QQ, R>;
  const int s = blockIdx.x % a.nsplit;
  const int tile = blockIdx.x / a.nsplit;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const long long cap = (long long)page * max_pages;
  const int length = (int)min((long long)max(a.lengths[b], 0), cap);
  const int first = first_key(a, b, length);
  int lo, hi, s_first, s_last;
  if (!split_keys(a, first, length, s, lo, hi, s_first, s_last)) return;
  const int live_pages = (length + page - 1) / page;
  const int* row_table = table + (long long)b * max_pages;
  // the producer's window of table entries: entry tw_base + lane
  int tw_base = -64, tw_val = 0;
  // boxes of g = box_rows keys at multiples of g (g divides the page and
  // T, so a box lies in one page and one tile): the boxes over each run
  const int g = a.box_rows;
  auto produce = [&](uint32_t st, uint32_t bar, int j0, int j1, int t0,
                     int lane) {
    const int ip0 = j0 / page, ip1 = (j1 - 1) / page;
    if (lane == 0) {
      int n = 0;
      if (a.tma) {
        for (int ip = ip0; ip <= ip1; ++ip) {
          const int r0 = max(j0, ip * page), r1 = min(j1, (ip + 1) * page);
          n += (r1 + g - 1) / g - r0 / g;
        }
      }
      mbar_expect_tx(bar, n * g * W::TX_ROW);
    }
    for (int ip = ip0; ip <= ip1; ++ip) {
      if (ip >= tw_base + 32) {
        tw_base = ip;
        tw_val = ip + lane < live_pages ? row_table[ip + lane] : 0;
      }
      const int pid = __shfl_sync(0xffffffffu, tw_val, ip - tw_base);
      const int r0 = max(j0, ip * page), r1 = min(j1, (ip + 1) * page);
      if (a.tma && lane == 0) {
        for (int kb = r0 / g * g; kb < r1; kb += g)
          W::boxes(&mk, &mv, st, bar, kb - t0, kb - ip * page, hk, pid);
      }
      // the run's first row in the pools
      const long long row =
          ((long long)pid * a.Hkv + hk) * page + (r0 - ip * page);
      W::copy_run(a, st, r0 - t0, r1 - r0, k_pages + row * a.d,
                  v_pages + row * a.d, a.k_scale + row, a.v_scale + row,
                  lane);
    }
  };
  const int tiles = gridDim.x / a.nsplit;
  W::run(a, b, hk, tile, lo, hi, ((long long)b * a.Hkv + hk) * tiles + tile,
         s, s_first, s_last, produce);
}

template <int D, typename QT, typename KT, typename VT, bool QQ,
          int R>
struct Launch {
  static cudaError_t run(Args a, const void* k, const void* v,
                         const int* table, int B, int page, int max_pages,
                         int n_pages, cudaStream_t stream) {
    using W = TileWalk<D, QT, KT, VT, QQ, R>;
    const dim3 grid(a.nsplit * ((a.rows + R - 1) / R), a.Hkv, B);
    // the maps over the pools' [n_pages][Hkv][page] rows, boxes of g =
    // gcd(page, T) rows; a box lands g slots on, so TMA takes the pages
    // whose g slots are a multiple of 128 bytes (its alignment), and
    // cp.async the others, into the same layout
    int g = W::T, r = page;
    while (r != 0) {
      const int t = g % r;
      g = r;
      r = t;
    }
    CUtensorMap mk{}, mv{};
    a.box_rows = g;
    a.tma = a.gran == 16 && n_pages > 0 && (g * W::SP) % 128 == 0;
    if (a.tma && !(encode_rows(&mk, k, W::EK, a.d, page, a.Hkv, n_pages,
                               W::G.bw, g) &&
                   encode_rows(&mv, v, W::EK, a.d, page, a.Hkv, n_pages,
                               W::G.bw, g)))
      return cudaErrorInvalidValue;
    static unsigned smem_set = 0;
    const cudaError_t err =
        allow_smem(paged_kernel<D, QT, KT, VT, QQ, R>, W::BYTES, smem_set);
    if (err != cudaSuccess) return err;
    paged_kernel<D, QT, KT, VT, QQ, R>
        <<<grid, TILE_THREADS, W::BYTES, stream>>>(
            mk, mv, a, static_cast<const KT*>(k), static_cast<const VT*>(v),
            table, page, max_pages);
    return cudaGetLastError();
  }
};

}  // namespace

// Pools [n_pages, Hkv, page, D] (D: any row width from 1 to 256, read as
// the pools lie; n_pages bounds the TMA maps); scale pools [n_pages, Hkv,
// page] fp32 or
// null; page_table [B, max_pages] int32. The other arguments are those of
// cfa_decode, with page·max_pages in max_n's place for the split's grid
// and scratch (the q type as there: paged_f16.cu's cfa_paged_decode_f16,
// paged_f32.cu's cfa_paged_decode_f32; the int8-K pools through the
// *_i8.cu units' cfa_paged_decode_i8, _f16_i8 and _f32_i8).
extern "C" int cfa_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* k_scale,
                                const void* v_scale, const void* q_sigma,
                                const void* page_table, const void* lengths,
                                const void* windows, void* o, void* lse,
                                void* part, void* tickets, int B, int H,
                                int Hkv, int page, int max_pages,
                                int n_pages, int D,
                                int k_type, int v_type, int qq,
                                int p_round, float scale, int window,
                                int split, void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || page <= 0 || max_pages < 0 || n_pages < 0)
    return cudaErrorInvalidValue;
  Args a{};
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
  a.gran = copy_granularity(D, k_pages, k_type, v_pages, v_type);
  if (build_dim(D) == 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = prepare_split(&a, B, (long long)page * max_pages, split,
                                  part, tickets, st);
  if (err != cudaSuccess) return err;
  const int* table = static_cast<const int*>(page_table);
  return dispatch<Launch, DecodeQ>(D, a.rows, k_type, v_type, qq, a, k_pages,
                                   v_pages, table, B, page, max_pages,
                                   n_pages, st);
}
