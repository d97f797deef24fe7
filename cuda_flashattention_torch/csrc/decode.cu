// One-token decode attention over a contiguous KV cache for Hopper: each
// query row attends the live, in-window keys of its KV head. The cache is
// bf16, int8, fp8 e4m3, or mixed (int8 K, fp8 V), the quantized ones with
// per-token fp32 scales, under a bf16 q; or fp32, bf16, int8, fp8 or mixed
// under an fp32 q; under `qq` Q arrives as per-head int8 and Q.K runs as an
// exact integer dot. Any head dim d from 1 to 256, read in place at its
// own row width on the build for the next of 16, 32, 64, 128 and 256.
//
// Replaces: cuda_flashattention_tpu/ops/decode.py::_decode_kernel. The
// per-tile update and the epilogue (attend_block, decode_epilogue there)
// are in decode_body.cuh, shared with the paged walk of paged.cu.
//
// What bounds it on the H100: bytes. Every step reads the visible K and V
// of each (batch, KV head) once — 2·len·d·bytes — for 4·G·len·d flops,
// about G flops per byte in bf16 (G = H/Hkv query heads per KV head, 4 in
// the serving model), two orders of magnitude under the card's balance
// point. A quantized cache halves those bytes (plus 8 bytes of scales per
// token).
//
// What this design does about it: one CTA per (split of the context, row
// tile of up to 8 query rows, KV head, batch) serves all the rows of the
// tile, so K/V are read from device memory once per tile rather than once
// per query head, and the splits (their size C from the host's rule,
// ops/decode.py::split_size) put B·Hkv·tiles·length/C CTAs on the card.
// A CTA walks its split in key tiles: a producer warp brings each tile in
// as one TMA box a column part (K and V, over the cache viewed as [B][Hkv]
// [max_n][d]) into a ring of shared-memory stages while eight consumer
// warps score, softmax and add the tile before (decode_body.cuh,
// TileWalk); the splits merge in the same launch. A window is a loop
// bound: the walk starts at the tile of max(0, length − window), so at
// most T − 1 keys before the window are copied (and never attended), and
// splits outside it exit at once. Rows whose bytes are not a multiple of
// 16 come in by cp.async instead, and rows no cp.async can take (their
// bytes not a multiple of 4, or a base off 4 bytes) by the producer warp's
// shifted loads, into the same slots: one walk for every shape.

#include "decode_body.cuh"

namespace {

using namespace cfa_decode_body;

template <int D, typename QT, typename KT, typename VT, bool QQ,
          int R>
__global__ void __launch_bounds__(TILE_THREADS, 3)
decode_kernel(const __grid_constant__ CUtensorMap mk,  // over k, v (tma)
              const __grid_constant__ CUtensorMap mv, Args a,
              const KT* __restrict__ k,  // [B, Hkv, max_n, d]
              const VT* __restrict__ v, int max_n) {
  using W = TileWalk<D, QT, KT, VT, QQ, R>;
  const int s = blockIdx.x % a.nsplit;
  const int tile = blockIdx.x / a.nsplit;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int length = min(max(a.lengths[b], 0), max_n);
  const int first = first_key(a, b, length);
  int lo, hi, s_first, s_last;
  if (!split_keys(a, first, length, s, lo, hi, s_first, s_last)) return;
  const long long base = ((long long)b * a.Hkv + hk) * max_n;  // in tokens
  // a tile is one box of T rows at the tile's first key (rows past max_n
  // come in as zeros), or its live keys as one run of cp.async copies (or
  // shifted loads)
  auto produce = [&](uint32_t st, uint32_t bar, int j0, int j1, int t0,
                     int lane) {
    if (lane == 0) {
      mbar_expect_tx(bar, a.tma ? W::T * W::TX_ROW : 0);
      if (a.tma) W::boxes(&mk, &mv, st, bar, 0, t0, hk, b);
    }
    const long long row = base + j0;
    W::copy_run(a, st, j0 - t0, j1 - j0, k + row * a.d, v + row * a.d,
                a.k_scale + row, a.v_scale + row, lane);
  };
  const int tiles = gridDim.x / a.nsplit;
  W::run(a, b, hk, tile, lo, hi, ((long long)b * a.Hkv + hk) * tiles + tile,
         s, s_first, s_last, produce);
}

template <int D, typename QT, typename KT, typename VT, bool QQ,
          int R>
struct Launch {
  static cudaError_t run(Args a, const void* k, const void* v, int B,
                         int max_n, cudaStream_t stream) {
    using W = TileWalk<D, QT, KT, VT, QQ, R>;
    const dim3 grid(a.nsplit * ((a.rows + R - 1) / R), a.Hkv, B);
    // the maps over [B][Hkv][max_n] rows, boxes of T rows
    CUtensorMap mk{}, mv{};
    a.tma = a.gran == 16 && max_n > 0;
    a.box_rows = W::T;
    if (a.tma && !(encode_rows(&mk, k, W::EK, a.d, max_n, a.Hkv, B,
                               W::G.bw, W::T) &&
                   encode_rows(&mv, v, W::EK, a.d, max_n, a.Hkv, B,
                               W::G.bw, W::T)))
      return cudaErrorInvalidValue;
    static unsigned smem_set = 0;
    const cudaError_t err =
        allow_smem(decode_kernel<D, QT, KT, VT, QQ, R>, W::BYTES, smem_set);
    if (err != cudaSuccess) return err;
    decode_kernel<D, QT, KT, VT, QQ, R>
        <<<grid, TILE_THREADS, W::BYTES, stream>>>(
            mk, mv, a, static_cast<const KT*>(k), static_cast<const VT*>(v),
            max_n);
    return cudaGetLastError();
  }
};

}  // namespace

// q and o [B, H, D] are bf16 (fp16 in cfa_decode_f16, decode_f16.cu; fp32
// in cfa_decode_f32, decode_f32.cu); the cache is [B, Hkv, max_n, D] (D:
// any row width from 1 to 256, read as it lies). k_type / v_type: 0 bf16,
// 1 int8, 2 fp8 e4m3, 3 fp32 (fp32 q), 4 fp16 (a 2-byte cache under a q
// of its type or an fp32 q). p_round (fp32 q): P rounded to bf16 (1) or
// fp16 (2) before P·V, for a 2-byte q upcast over a cache of another float
// type; 0 elsewhere. k_scale / v_scale [B, Hkv, max_n] fp32 for a
// quantized cache, else null. With qq != 0, q is int8 and q_sigma [B, H]
// holds sigma_q * scale per row; o keeps the unit's q type. windows [B] or
// null; window 0 for none. split: C, keys per split of the context (the
// host's rule); with more than one split of max_n, part [B·Hkv·row tiles
// · ceil(max_n / C) · R · (D + 2)] fp32 and tickets [B·Hkv·row tiles]
// int32 are the call's scratch (tickets are zeroed here, on the stream).
// The int8-K caches (k_type 1) run the entry points of the *_i8.cu units
// (cfa_decode_i8, cfa_decode_f16_i8, cfa_decode_f32_i8), the others these;
// each refuses the other's with cudaErrorInvalidValue.
extern "C" int cfa_decode(const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale,
                          const void* q_sigma, const void* lengths,
                          const void* windows, void* o, void* lse,
                          void* part, void* tickets, int B, int H, int Hkv,
                          int max_n, int D, int k_type, int v_type, int qq,
                          int p_round, float scale, int window, int split,
                          void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || max_n < 0) return cudaErrorInvalidValue;
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
  a.gran = copy_granularity(D, k, k_type, v, v_type);
  if (build_dim(D) == 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = prepare_split(&a, B, max_n, split, part, tickets, st);
  if (err != cudaSuccess) return err;
  return dispatch<Launch, DecodeQ>(D, a.rows, k_type, v_type, qq, a, k, v, B,
                                   max_n, st);
}
