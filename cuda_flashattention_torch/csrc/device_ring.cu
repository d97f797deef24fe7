// Device-initiated ring for Hopper: every rank holds a shard x_i [L, D]
// bf16 and W [D, D] bf16; the kernel itself pushes the shard it holds into
// its right neighbour's double buffer while it computes o += shard @ W
// (fp32 accumulate). After n steps every rank holds (sum_i x_i) @ W in
// o [L, D] fp32. No host copy, no collective library: the kernel's own
// stores move the data and device-side flags order the steps.
//
// Replaces: examples/07_device_ring.py::_ring_kernel (the Pallas kernel
// that starts a remote DMA into the neighbour's VMEM buffer, multiplies the
// resident shard, and waits for the DMA).
//
// What bounds it on the H100: neither bytes nor operations. Per rank the
// work is n·2·L·D² flops and about (2n − 1)·L·D·2 bytes (its shard read,
// n − 1 shards pushed and read back, W, o written): microseconds of
// either at the example's shape. What it waits for is n − 1 flag round
// trips between CTAs (a store that must reach L2, or the peer card over
// NVLink, then a polling load that must see it): the kernel is bound by
// that latency, and the design keeps everything else off that path.
//
// What this design does about it:
//  * Addressing is a table of per-rank pointers passed by value (shard,
//    W, double buffer, flag words, output). On one card the neighbours'
//    buffers are other allocations of the same card and all ranks run in
//    ONE launch (rank = local[blockIdx.y]); across cards they are
//    peer-mapped allocations and each card launches its own ranks. The
//    kernel, the flags and the pushes are the same code.
//  * Rows of o depend only on the same rows of the shards, so CTA t of a
//    rank owns a 64-row tile and talks only to CTA t of its neighbours:
//    flags per (rank, tile), no grid-wide barrier. A CTA walks the tiles
//    t, t + gridDim.x, ... so that the grid can be capped at what is
//    resident at once; the launch is cooperative, which refuses a grid
//    that is not (a spin-wait on a CTA that never starts would hang).
//  * Protocol per tile, as the TPU kernel's: a barrier with both
//    neighbours; then per step: read the resident tile (the rank's own x
//    at step 0, else buf[step % 2]) into registers and shared memory;
//    unless it is the last step, store it into the right neighbour's
//    buf[(step + 1) % 2] (16-byte stores), fence at system scope, and
//    after a block barrier one thread release-stores the step count into
//    the neighbour's receive flag; multiply the tile from shared memory
//    (wmma bf16, W resident in shared memory, o in registers until the
//    end); then one thread spins on the own receive flag with an acquire
//    load at system scope. Flags are monotonic counters, never reset.
//  * A hazard the TPU kernel leaves open: at step s + 1 the left
//    neighbour overwrites the slot this rank read at step s − 1, and
//    "the data landed" does not say "the reader is done". TPU cores run
//    in near lockstep; CTAs do not. So the reader publishes a second
//    counter, "steps consumed", into its LEFT neighbour's credit word once
//    the tile is in its shared memory, and a writer awaits that credit
//    before it pushes into the slot.
//  * Received data is read with ld.global.cg (L2 only): the same
//    addresses were read two steps earlier, and an L1 line could be stale.
//  * Every spin has a cycle cap that traps, so a protocol fault fails the
//    run instead of hanging the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int MAX_RANKS = 32;
constexpr int BM = 64;        // rows of o per CTA tile
constexpr int NWARPS = 4;     // each warp owns BM / NWARPS = 16 rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int FLAG_WORDS = 4;  // per (rank, tile): barrier, recv, credit, -
constexpr int F_BARRIER = 0;
constexpr int F_RECV = 1;
constexpr int F_CREDIT = 2;
// a spin gives up (and traps) after this many clock cycles: seconds, where
// a hop takes microseconds
constexpr long long SPIN_CYCLES = 6000000000LL;

struct RingTable {
  const __nv_bfloat16* x[MAX_RANKS];    // the rank's shard [L, D]
  const __nv_bfloat16* w[MAX_RANKS];    // W [D, D] on the rank's card
  __nv_bfloat16* buf[MAX_RANKS];        // double buffer [2, L, D]
  unsigned* flags[MAX_RANKS];           // [L / BM, FLAG_WORDS], zeroed
  float* out[MAX_RANKS];                // o [L, D]
  int local[MAX_RANKS];                 // blockIdx.y -> rank of this launch
};

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void signal_add_sys(unsigned* p) {
  asm volatile("red.release.sys.global.add.u32 [%0], 1;" ::"l"(p)
               : "memory");
}

// One thread waits until the counter at p has reached `target`.
__device__ __forceinline__ void spin_until(const unsigned* p,
                                           unsigned target) {
  const long long t0 = clock64();
  while (ld_acquire_sys(p) < target) {
    if (clock64() - t0 > SPIN_CYCLES) __trap();
  }
}

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // padded rows, 32-byte aligned tiles
  static constexpr size_t w_off = 0;
  static constexpr size_t x_off = w_off + sizeof(__nv_bfloat16) * D * LD;
  static constexpr size_t bytes = x_off + sizeof(__nv_bfloat16) * BM * LD;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
device_ring_kernel(const RingTable t, int n_shards, int L) {
  using S = Smem<D>;
  constexpr int VPR = D / 8;                    // 16-byte vectors per row
  constexpr int VPT = BM * VPR / NTHREADS;      // vectors per thread
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + S::w_off);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + S::x_off);

  const int rank = t.local[blockIdx.y];
  const int right = (rank + 1) % n_shards;
  const int left = (rank + n_shards - 1) % n_shards;
  const int warp = threadIdx.x / 32;
  const int n_tiles = L / BM;

  // W stays in shared memory for the whole kernel
  for (int i = threadIdx.x; i < D * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    *reinterpret_cast<uint4*>(ws + r * S::LD + c) =
        *reinterpret_cast<const uint4*>(t.w[rank] + r * D + c);
  }

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    unsigned* mine = t.flags[rank] + tile * FLAG_WORDS;
    unsigned* rflags = t.flags[right] + tile * FLAG_WORDS;
    unsigned* lflags = t.flags[left] + tile * FLAG_WORDS;
    const long long tile_off = static_cast<long long>(tile) * BM * D;
    const long long slot_elems = static_cast<long long>(L) * D;

    // Barrier with both neighbours: nobody pushes into a buffer whose
    // owner has not started this tile.
    if (threadIdx.x == 0) {
      signal_add_sys(lflags + F_BARRIER);
      signal_add_sys(rflags + F_BARRIER);
      spin_until(mine + F_BARRIER, 2u);
    }
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

    for (int step = 0; step < n_shards; ++step) {
      const bool push = step < n_shards - 1;
      const __nv_bfloat16* src =
          step == 0 ? t.x[rank] + tile_off
                    : t.buf[rank] + (step & 1) * slot_elems + tile_off;
      // the resident tile: to registers (L2 loads), then to shared memory
      uint4 vals[VPT];
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int e = threadIdx.x + i * NTHREADS;
        vals[i] = __ldcg(reinterpret_cast<const uint4*>(
            src + (e / VPR) * D + (e % VPR) * 8));
      }
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int e = threadIdx.x + i * NTHREADS;
        *reinterpret_cast<uint4*>(xs + (e / VPR) * S::LD + (e % VPR) * 8) =
            vals[i];
      }
      if (push) {
        if (step > 0) {
          // the right neighbour must have consumed what this slot held
          if (threadIdx.x == 0) spin_until(mine + F_CREDIT, step);
          __syncthreads();
        }
        __nv_bfloat16* dst =
            t.buf[right] + ((step + 1) & 1) * slot_elems + tile_off;
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
          const int e = threadIdx.x + i * NTHREADS;
          __stcg(reinterpret_cast<uint4*>(dst + (e / VPR) * D +
                                          (e % VPR) * 8),
                 vals[i]);
        }
        __threadfence_system();
      }
      __syncthreads();  // the tile is in shared memory; the pushes fenced
      if (threadIdx.x == 0) {
        if (push) st_release_sys(rflags + F_RECV, step + 1);
        // This rank's read of its slot is done: credit to the writer,
        // which awaits credit >= s before its push of step s <= n - 2.
        // Later credits would be awaited by nobody and could land after
        // the neighbour's kernel (on another card) has ended, so none is
        // sent: every remote store is one its target waits for.
        if (step + 1 <= n_shards - 2) {
          st_release_sys(lflags + F_CREDIT, step + 1);
        }
      }

      // o += tile @ W while the push is in flight
      const __nv_bfloat16* a_base = xs + warp * 16 * S::LD;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, a_base + kk * 16, S::LD);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b;
          wmma::load_matrix_sync(b, ws + kk * 16 * S::LD + j * 16, S::LD);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }

      // wait for the next shard to have landed in the other slot
      if (push && threadIdx.x == 0) spin_until(mine + F_RECV, step + 1);
      __syncthreads();
    }

    float* o = t.out[rank] + tile_off + warp * 16 * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::store_matrix_sync(o + j * 16, acc[j], D, wmma::mem_row_major);
    }
  }
}

template <int D>
cudaError_t launch(const RingTable& table, int n_shards, int n_local, int L,
                   int device, cudaStream_t stream, int* grid_out) {
  using S = Smem<D>;
  // CTAs of this kernel the card holds at once, found on the first launch
  // on each card (with the shared-memory opt-in it needs there)
  constexpr int MAX_CARDS = 64;
  static int resident[MAX_CARDS] = {0};
  if (device < 0 || device >= MAX_CARDS) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSuccess;
  if (resident[device] == 0) {
    err = cudaFuncSetAttribute(
        device_ring_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::bytes));
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, device_ring_kernel<D>, NTHREADS, S::bytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    resident[device] = per_sm * sms;
  }
  // every CTA of every rank of this launch must be resident at once
  int grid_x = resident[device] / n_local;
  if (grid_x > L / BM) grid_x = L / BM;
  if (grid_x < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (grid_out) *grid_out = grid_x;
  RingTable t = table;
  void* args[] = {&t, &n_shards, &L};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(device_ring_kernel<D>), dim3(grid_x, n_local),
      dim3(NTHREADS), args, S::bytes, stream);
}

}  // namespace

// x, w, buf, flags, out: n_shards device pointers each (per rank); local:
// the n_local ranks this launch runs, all on card `device`; L rows per
// shard (a multiple of 64), D in {64, 128}; grid_out (may be NULL)
// receives the CTAs per rank. Launches on `stream` and does not
// synchronise.
extern "C" int cfa_device_ring(void* const* x, void* const* w,
                               void* const* buf, void* const* flags,
                               void* const* out, int n_shards,
                               const int* local, int n_local, int L, int D,
                               int device, int* grid_out, void* stream) {
  if (n_shards < 1 || n_shards > MAX_RANKS || n_local < 1 ||
      n_local > n_shards || L < BM || L % BM != 0 || (D != 64 && D != 128)) {
    return cudaErrorInvalidValue;
  }
  RingTable table;
  for (int r = 0; r < n_shards; ++r) {
    table.x[r] = static_cast<const __nv_bfloat16*>(x[r]);
    table.w[r] = static_cast<const __nv_bfloat16*>(w[r]);
    table.buf[r] = static_cast<__nv_bfloat16*>(buf[r]);
    table.flags[r] = static_cast<unsigned*>(flags[r]);
    table.out[r] = static_cast<float*>(out[r]);
  }
  for (int i = 0; i < n_local; ++i) table.local[i] = local[i];
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    err = launch<64>(table, n_shards, n_local, L, device, s, grid_out);
  } else {
    err = launch<128>(table, n_shards, n_local, L, device, s, grid_out);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  cudaSetDevice(prev);
  return err;
}

// Let kernels on card `device` store into allocations of card `peer`.
extern "C" int cfa_enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the sticky code: it is not a failure
    err = cudaSuccess;
  }
  cudaSetDevice(prev);
  return err;
}
