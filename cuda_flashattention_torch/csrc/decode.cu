// One-token decode attention over a bf16 KV cache for Hopper: each query
// head attends the first lengths[b] cached keys of its KV head.
//
// Replaces: cuda_flashattention_tpu/ops/decode.py::_decode_kernel (body
// attend_block, epilogue decode_epilogue), for unquantized caches and no
// window.
//
// What bounds it on the H100: bytes. Every step reads the live K and V of
// each (batch, KV head) once — 2·len·d·2 bytes — for 4·G·len·d flops, about
// G flops per byte (G = H/Hkv query heads per KV head, 4 in the serving
// model), two orders of magnitude under the card's balance point. At small
// batch the grid is also small: B·Hkv CTAs (32 at B=8, Hkv=4) on 132 SMs,
// so one step cannot reach the card's memory bandwidth; it is bound by the
// latency of each CTA's walk over its cache.
//
// What this design does about it: one CTA per (batch, KV head) serves all
// G query heads of the group, so K/V are read from device memory once per
// group rather than once per query head. Each warp walks its own
// interleaved share of the keys with coalesced 8-byte-per-lane loads and
// keeps a private online softmax (m, l and the output row in registers);
// the warps' partial states merge once, in shared memory, at the end.
// Split-K across CTAs (flash-decoding), to fill the card at small batch,
// is later work.
//
// Numerics follow the TPU kernel: scores are fp32 sums of bf16 products
// times `scale`, with natural exp; probabilities are rounded to bf16
// before they weight V; O is written in bf16 and LSE = m + ln l in fp32; a
// sequence with no live key gets O = 0 and LSE = NEG_INF.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

template <int D>
struct LaneSlice {
  static constexpr int N = D / 32;  // d-elements each lane owns
};

// Load N consecutive bf16 (N = 2 or 4) as floats.
template <int N>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    const float2 fa = __bfloat1622float2(a);
    const float2 fb = __bfloat1622float2(b);
    out[0] = fa.x; out[1] = fa.y; out[2] = fb.x; out[3] = fb.y;
  } else {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
    const float2 fa = __bfloat1622float2(a);
    out[0] = fa.x; out[1] = fa.y;
  }
}

template <int D, int G>
__global__ void __launch_bounds__(NTHREADS)
decode_kernel(const __nv_bfloat16* __restrict__ q,  // [B, H, D]
              const __nv_bfloat16* __restrict__ k,  // [B, Hkv, max_n, D]
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ lengths,      // [B]
              __nv_bfloat16* __restrict__ o,        // [B, H, D]
              float* __restrict__ lse,              // [B, H]
              int Hkv, int max_n, float scale) {
  constexpr int N = LaneSlice<D>::N;
  __shared__ float part_m[NWARPS][G];
  __shared__ float part_l[NWARPS][G];
  __shared__ float part_o[NWARPS][G][D];

  const int b = blockIdx.y;
  const int hk = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = lane * N;
  const int length = min(max(lengths[b], 0), max_n);

  // the group's G query rows, this lane's slice of each
  float qf[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_bf16<N>(q + ((long long)b * Hkv * G + hk * G + g) * D + c0, qf[g]);
  }
  float m[G], l[G], acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < N; ++c) acc[g][c] = 0.f;
  }

  const long long base = ((long long)b * Hkv + hk) * max_n * D;
  const __nv_bfloat16* kb = k + base + c0;
  const __nv_bfloat16* vb = v + base + c0;
  for (int j = warp; j < length; j += NWARPS) {
    float kf[N], vf[N];
    load_bf16<N>(kb + (long long)j * D, kf);
    load_bf16<N>(vb + (long long)j * D, vf);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < N; ++c) s = fmaf(qf[g][c], kf[c], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      s *= scale;
      const float m_next = fmaxf(m[g], s);
      const float alpha = __expf(m[g] - m_next);
      const float p = __expf(s - m_next);
      l[g] = l[g] * alpha + p;
      m[g] = m_next;
      // P·V runs on P rounded to the input dtype, as in the TPU kernel
      const float pr = __bfloat162float(__float2bfloat16(p));
#pragma unroll
      for (int c = 0; c < N; ++c) acc[g][c] = acc[g][c] * alpha + pr * vf[c];
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      part_m[warp][g] = m[g];
      part_l[warp][g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < N; ++c) part_o[warp][g][c0 + c] = acc[g][c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += NTHREADS) {
    const int g = i / D;
    const int c = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, part_m[w][g]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      // a warp that saw no key has l = 0 and contributes nothing
      const float wgt = part_l[w][g] > 0.f ? __expf(part_m[w][g] - mx) : 0.f;
      lsum += part_l[w][g] * wgt;
      osum += part_o[w][g][c] * wgt;
    }
    const long long row = (long long)b * Hkv * G + hk * G + g;
    o[row * D + c] = __float2bfloat16(lsum > 0.f ? osum / lsum : 0.f);
    if (c == 0) lse[row] = lsum > 0.f ? mx + logf(lsum) : kNegInf;
  }
}

template <int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* o, void* lse, int B, int Hkv,
                   int max_n, float scale, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  decode_kernel<D, G><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Hkv, max_n, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int G, const void* q, const void* k, const void* v,
                     const void* lengths, void* o, void* lse, int B, int Hkv,
                     int max_n, float scale, cudaStream_t s) {
  switch (G) {
    case 1: return launch<D, 1>(q, k, v, lengths, o, lse, B, Hkv, max_n, scale, s);
    case 2: return launch<D, 2>(q, k, v, lengths, o, lse, B, Hkv, max_n, scale, s);
    case 4: return launch<D, 4>(q, k, v, lengths, o, lse, B, Hkv, max_n, scale, s);
    case 8: return launch<D, 8>(q, k, v, lengths, o, lse, B, Hkv, max_n, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int cfa_decode(const void* q, const void* k, const void* v,
                          const void* lengths, void* o, void* lse, int B,
                          int H, int Hkv, int max_n, int D, float scale,
                          void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  const int G = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_d<64>(G, q, k, v, lengths, o, lse, B, Hkv, max_n, scale, s);
    case 128: return launch_d<128>(G, q, k, v, lengths, o, lse, B, Hkv, max_n, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
