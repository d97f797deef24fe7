// Device-initiated ring for Hopper: every rank holds a shard x_i [L, D]
// and W [D, D], both bf16 or both fp32 (the F32 build); the kernel itself
// moves the shard it holds into its right neighbour's double buffer while
// it computes o += shard @ W (fp32 accumulate). After n steps every rank
// holds (sum_i x_i) @ W in o [L, D] fp32. No host copy, no collective
// library: the kernel's own bulk copies move the data and device-side
// flags order the steps.
//
// Replaces: examples/07_device_ring.py::_ring_kernel (the Pallas kernel
// that starts a remote DMA into the neighbour's VMEM buffer, multiplies the
// resident shard, and waits for the DMA).
//
// What bounds it on the H100: per rank the work is n·2·L·D² flops and,
// to memory, its shard read once, W read and o written in fp32; the
// n − 1 shards it pushes stay in L2 when the ring shares a card, and
// cross NVLink only where a neighbour is on another card. At L = 8192,
// n = 8 on one card that is 0.017 ms of products against 0.015 ms of
// bytes. Below that, each of the n − 1 hops is a latency chain (the
// pushes complete, a release, an acquire that sees it, the next loads
// land), which sets the floor at small L.
//
// What this design does about it:
//  * Scope is a build parameter (SYS). When every rank of the ring is on
//    one card the flags are .gpu-scope release / acquire: the neighbours
//    are other allocations of the same L2. Only a ring with a neighbour on
//    another card builds .sys. No thread fences: one thread releases after
//    the CTA's barrier and the completion of its bulk stores.
//  * A step-outer walk over a span. CTA c of EVERY rank owns the same
//    span of 64-row tiles (the partition is a function of L and the grid,
//    and the host passes one grid to every launch of the ring), and talks
//    only to CTA c of its two neighbours. A span is walked in rounds of G
//    tiles whose o stays in registers (G = 2 at D = 128, 4 at D = 64, 1
//    at 256); per round the CTA runs the whole n-step ring: per step it
//    loads its G tiles, pushes them on and multiplies them, then signals
//    ONE flag for the (rank, CTA, round, step). So the n − 1 hop latencies are paid
//    once per round, not once per tile, and the two CTAs on an SM hide
//    each other's hops under their products (registers are sized for two:
//    with three, at 168 registers, they spill, and the kernel took 19%
//    longer at L = 8192, n = 8 on an H100).
//  * Copies by the bulk-copy engine, products by wgmma. The double buffers
//    hold each tile's shared-memory image in the 128 B swizzle wgmma reads,
//    so every step after the first brings a tile in with ONE 1-D bulk copy
//    (cp.async.bulk, completing on an mbarrier) and pushes it on with one
//    bulk store from shared memory (cp.async.bulk.global.shared::cta) into
//    the neighbour's buffer: no tensor map, so nothing is encoded per call.
//    Step 0's tile (the caller's x) and W, once per CTA, come in by 16-byte
//    loads that the threads write in the swizzle. o += tile @ W is
//    wgmma m64n64k16 (SS: the tile K-major, W MN-major), two n64 halves at
//    D = 128, tile j's products in flight while tile j + 1 lands.
//  * Flags are 64-bit epoch words, never zeroed after the workspace's
//    first call: a value is (epoch << 32) | count, count = round·n + step,
//    written by one writer with a release and read with an acquire, so a
//    later epoch's values exceed every earlier target. Per (rank, CTA):
//      RECV   the left neighbour's pushes for (round, step) are complete;
//      CREDIT the right neighbour has taken what its slot held (a writer
//             awaits it before overwriting a slot its reader may still be
//             loading from: "the data landed" does not say "the reader is
//             done", and CTAs do not run in lockstep);
//      START  (SYS only) the right neighbour's kernel of this epoch has
//             started, so its previous call, on another card and not
//             ordered with ours, no longer reads its buffers.
//    Every remote store is one its target waits for in the same epoch.
//  * The proxies: a generic-proxy write to shared memory read by a bulk
//    store or wgmma is followed by fence.proxy.async.shared::cta; a bulk
//    load issued after an acquire of data another SM or card wrote is
//    preceded by fence.proxy.async.global; a bulk store is waited for in
//    full (cp.async.bulk.wait_group 0, not .read) before the release that
//    publishes it.
//  * The launch is cooperative (it refuses a grid that is not resident at
//    once: a spin on a CTA that never starts would hang), and every spin
//    and mbarrier wait traps after seconds, so a protocol fault fails the
//    run instead of hanging the card. A spin's bound is wall time (the
//    global timer, SPIN_NS), not SM cycles: a CTA that another process's
//    context preempts may resume on another SM, whose cycle counter is
//    not its first SM's.
//
//  * Ranks in several processes. Each process allocates its ranks'
//    double buffers and flag words in one cudaMalloc (cfa_ipc_alloc: the
//    caching allocator's blocks are sub-allocations, and an IPC handle
//    names a whole allocation), exports it with cudaIpcGetMemHandle, and
//    opens the other processes' handles (cfa_ipc_open). The pointer table
//    then holds this process's pointers for its own ranks and the mapped
//    ones for the others': the kernel and its protocol are the same. A
//    neighbour in another process writes the flags from another context,
//    even on the same card, so such a ring runs the SYS build.
//
//  * fp32 x and W (the F32 build): every value is held as two bf16 halves,
//    hi = bf16(x) and lo = bf16(x − hi), and o += shard @ W is three bf16
//    wgmmas (lo·W_hi + hi·W_lo + hi·W_hi) with fp32 sums. The threads
//    split W and the caller's step-0 rows once, as they write them in the
//    swizzle; what is pushed around the ring is the split tile image, hi
//    image then lo image (PL = 2 planes): 4 bytes an element, the bytes of
//    raw fp32, but every later step lands in wgmma's layout by its one bulk
//    copy with no work on arrival, where a raw fp32 push would be split by
//    the threads at every hop. W hi + lo is 64 KB at D = 128, so a round
//    there is one tile (G = 1), which keeps two CTAs per SM.
//
//  * D = 256. A tile's o is 128 fp32 registers a thread, so a round is one
//    tile (G = 1; two would take 256, past the 255 a thread has). bf16: W
//    128 KB and one 32 KB tile image, 160 KB, one CTA per SM. fp32: W's hi
//    + lo images take 256 KB, past the 232,448 bytes, so W is cut into NH =
//    2 column halves and a CTA holds one, split (128 KB), beside one split
//    tile image (64 KB): 192 KB. The grid is spans x halves: CTA 2·c + p
//    walks span c for o's columns 128·p .., and the two CTAs of a span are
//    two rings that share nothing, each pushing its own copy of the tiles
//    through its own half of the double buffers, with its own flags (the
//    host allocates both: buffers [NH, 2, 2·L, D], flags [NH·grid, 4]).
//    The host pads any d up to 256 with zero columns (and W with zero rows
//    and columns) to the next of 64, 128, 256 and slices o back.
//
// The designs that measured slower (o in fp32 in device memory, the push
// as 16-byte stores, one tile per round, registers for three CTAs per SM)
// are text patches of a copy of this source in utils/ring_variants.py.

#include <cstring>

#include "flash_fwd_bound_sm90.cuh"

namespace {

using cfa_bound::bf16;
using cfa_bound::fence_proxy_async;
using cfa_bound::fence_regs;
using cfa_bound::make_desc;
using cfa_bound::mbar_expect_tx;
using cfa_bound::mbar_init;
using cfa_bound::mbar_wait;
using cfa_bound::smem_u32;
using cfa_bound::split2;
using cfa_bound::swz;
using cfa_bound::wgmma_commit;
using cfa_bound::wgmma_fence;
using cfa_bound::wgmma_wait_all;

typedef unsigned long long u64;

constexpr int MAX_RANKS = 32;
constexpr int BM = 64;          // rows of o per tile
constexpr int NTHREADS = 128;   // one warpgroup
constexpr int FLAG_WORDS = 4;   // per (rank, CTA): RECV, CREDIT, START, -
constexpr int F_RECV = 0;
constexpr int F_CREDIT = 1;
constexpr int F_START = 2;
constexpr int MIN_BLOCKS = 2;   // CTAs per SM the registers are sized for
// a spin gives up (and traps) after this many nanoseconds of the global
// timer: seconds, where a hop takes microseconds
constexpr unsigned long long SPIN_NS = 10000000000ULL;

struct RingTable {
  const void* x;               // this launch's shards [n_local, L, D]
  const void* w;               // W [D, D] on this launch's card
  float* out;                  // o [n_local, L, D]
  bf16* buf[MAX_RANKS];        // per rank: tile images [2, L / BM, PL·BM·D]
  u64* flags[MAX_RANKS];       // per rank: [grid, FLAG_WORDS]
  int local[MAX_RANKS];        // blockIdx.y -> rank of this launch
};

// PL: the planes of an image, hi (and lo under F32); NH: the column parts
// of W (and of o), one CTA each, WC columns apiece
template <int D, bool F32>
struct Geo {
  static constexpr int PL = F32 ? 2 : 1;
  static constexpr int NH = D == 256 && F32 ? 2 : 1;
  static constexpr int WC = D / NH;
  static constexpr int G = D == 64 ? 4 : D == 128 && !F32 ? 2 : 1;  // tiles
  static constexpr int TILE = PL * BM * D * 2;  // bytes of a tile image
  static constexpr int W_BYTES = PL * D * WC * 2;
  static constexpr int st_off = W_BYTES;    // both multiples of 1024
  static constexpr int bar_off = st_off + G * TILE;
  static constexpr int bytes = bar_off + 8 * G + 1024;  // + alignment
};

// ---------------------------------------------------------------------------
// Flags at the ring's scope
// ---------------------------------------------------------------------------

template <bool SYS>
__device__ __forceinline__ void st_release(u64* p, u64 v) {
  if (SYS) {
    asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
  } else {
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
  }
}

template <bool SYS>
__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  if (SYS) {
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
  } else {
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
  }
  return v;
}

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One thread waits until the word at p has reached `target`.
template <bool SYS>
__device__ __forceinline__ void spin_until(const u64* p, u64 target) {
  const u64 t0 = global_ns();
  while (ld_acquire<SYS>(p) < target) {
    if (global_ns() - t0 > SPIN_NS) __trap();
  }
}

// Global memory written through the generic proxy (the flags' acquire)
// ordered against this thread's bulk copies, both ways.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// ---------------------------------------------------------------------------
// Bulk copies of tile images
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until this thread's bulk stores are complete (written, not only read).
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---------------------------------------------------------------------------
// The product
// ---------------------------------------------------------------------------

// D[64x64] (+)= A[64x16] · B[16x64], bf16 from shared memory, A K-major, B
// MN-major (W [k][n], n contiguous, as TMA's 128 B swizzle lays out V).
__device__ __forceinline__ void wgmma_ss_bf16_bmn(float (&d)[32], uint64_t da,
                                                  uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CFA_REGS32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : CFA_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// acc (+)= the tile image at shared address `a` @ W's image at `wa` (its
// WC columns: WC / 64 slabs of D rows).
template <int D, int WC>
__device__ __forceinline__ void tile_issue(float (&acc)[WC / 64][32],
                                           uint32_t a, uint32_t wa,
                                           bool accumulate) {
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt) {
    const uint64_t da =
        make_desc(a + (kt / 4) * BM * 128 + (kt % 4) * 32, 16, 1024, 1);
#pragma unroll
    for (int h = 0; h < WC / 64; ++h) {
      wgmma_ss_bf16_bmn(
          acc[h], da, make_desc(wa + h * D * 128 + kt * 16 * 128, 1024, 1024,
                                1),
          accumulate || kt > 0);
    }
  }
}

// acc (+)= the tile at shared address `a` @ W at `wa`, issued and
// committed, not waited for; under F32 both split (each lo image right
// after its hi image): lo·W_hi + hi·W_lo + hi·W_hi.
template <int D, bool F32, int WC>
__device__ __forceinline__ void tile_product(float (&acc)[WC / 64][32],
                                             uint32_t a, uint32_t wa,
                                             bool accumulate) {
  wgmma_fence();
  if (F32) {
    tile_issue<D, WC>(acc, a + BM * D * 2, wa, accumulate);
    tile_issue<D, WC>(acc, a, wa + D * WC * 2, true);
    tile_issue<D, WC>(acc, a, wa, true);
  } else {
    tile_issue<D, WC>(acc, a, wa, accumulate);
  }
  wgmma_commit();
}

// 16-byte chunk `e` of `rows` (D columns) into an image at `img` (its lo
// plane `lo_off` bytes on): a bf16 chunk as it is, or, under F32, eight
// fp32 values (two 16-byte loads) split into a hi and a lo chunk. Loads
// first (ld), stores after (st), so that a thread keeps several in flight.
template <bool F32>
struct Chunk {
  uint4 v[F32 ? 2 : 1];
};
template <int D, bool F32>
__device__ __forceinline__ void ld_chunk(Chunk<F32>& c, const void* rows,
                                         int e) {
  constexpr int CH = D / 8;
  if constexpr (F32) {
    const float* src = static_cast<const float*>(rows) + (e / CH) * D +
                       (e % CH) * 8;
    c.v[0] = __ldg(reinterpret_cast<const uint4*>(src));
    c.v[1] = __ldg(reinterpret_cast<const uint4*>(src) + 1);
  } else {
    c.v[0] = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const bf16*>(rows) + (e / CH) * D + (e % CH) * 8));
  }
}
template <bool F32>
__device__ __forceinline__ void st_chunk(uint8_t* img, uint32_t off,
                                         uint32_t lo_off,
                                         const Chunk<F32>& c) {
  if constexpr (F32) {
    uint4 hi, lo;
    const uint4 a = c.v[0], b = c.v[1];
    split2(__uint_as_float(a.x), __uint_as_float(a.y), hi.x, lo.x);
    split2(__uint_as_float(a.z), __uint_as_float(a.w), hi.y, lo.y);
    split2(__uint_as_float(b.x), __uint_as_float(b.y), hi.z, lo.z);
    split2(__uint_as_float(b.z), __uint_as_float(b.w), hi.w, lo.w);
    *reinterpret_cast<uint4*>(img + off) = hi;
    *reinterpret_cast<uint4*>(img + lo_off + off) = lo;
  } else {
    *reinterpret_cast<uint4*>(img + off) = c.v[0];
  }
}

// Byte offset of 16-byte chunk `ch` of row `row` in a tile image of
// 64-column slabs of `rows` rows (the layout of TMA's 128 B swizzle).
__device__ __forceinline__ uint32_t image_off(int row, int ch, int rows) {
  return (uint32_t)((ch / 8) * rows * 128) + swz(row, ch % 8, 128);
}

// This thread's element (i, i + 1) of accumulator half h: its row of the
// 64-row tile and its column.
__device__ __forceinline__ int acc_row(int i) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int h, int i) {
  return h * 64 + 8 * (i >> 2) + 2 * (threadIdx.x & 3);
}

// (acc: o's WC columns from col0)
template <int D, int WC>
__device__ __forceinline__ void store_acc(float* o,
                                          const float (&acc)[WC / 64][32],
                                          int col0) {
#pragma unroll
  for (int h = 0; h < WC / 64; ++h) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      *reinterpret_cast<float2*>(o + acc_row(i) * D + col0 + acc_col(h, i)) =
          make_float2(acc[h][i], acc[h][i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// grid (CTAs per rank, ranks of this launch); CTA c of every rank owns the
// same span of tiles (with NH column parts, CTA NH·c + p its part p).
// epoch_hi = epoch << 32.
template <int D, bool SYS, bool F32>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
device_ring_kernel(const RingTable t, int n, int L, u64 epoch_hi) {
  using S = Geo<D, F32>;
  constexpr int G = S::G;
  constexpr int PL = S::PL;
  constexpr int NH = S::NH;
  constexpr int WC = S::WC;
  constexpr int CH = D / 8;                      // 16-byte chunks per row
  constexpr int TILE_VECS = BM * CH / NTHREADS;  // per thread: 4, 8, 16
  static_assert(TILE_VECS % 4 == 0, "tile loads in fours");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t wa = base;
  const uint32_t stages = base + S::st_off;
  const uint32_t full = base + S::bar_off;       // + 8 * stage
  const int tid = threadIdx.x;

  const int rank = t.local[blockIdx.y];
  const int right = (rank + 1) % n;
  const int left = (rank + n - 1) % n;
  const int part = blockIdx.x % NH;  // W's and o's columns WC·part ..
  const int c = blockIdx.x / NH;
  const int spans = gridDim.x / NH;
  // the span: tiles [start, start + cnt), the same on every rank
  const int tiles = L / BM;
  const int per = tiles / spans, extra = tiles % spans;
  const int start = c * per + min(c, extra);
  const int cnt = per + (c < extra ? 1 : 0);
  const long long slot = (long long)tiles * BM * D * PL;  // bf16 per slot
  const long long ring_off = (long long)part * 2 * slot;  // this part's

  u64* mine = t.flags[rank] + blockIdx.x * FLAG_WORDS;
  u64* rflags = t.flags[right] + blockIdx.x * FLAG_WORDS;
  u64* lflags = t.flags[left] + blockIdx.x * FLAG_WORDS;
  const uint8_t* x = static_cast<const uint8_t*>(t.x) +
                     (long long)blockIdx.y * L * D * (F32 ? 4 : 2);
  float* out = t.out + (long long)blockIdx.y * L * D;

  if (tid == 0) {
    for (int j = 0; j < G; ++j) mbar_init(full + 8 * j, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // tell the left neighbour that this rank's call has started
    if (SYS && n > 1) st_release<SYS>(lflags + F_START, epoch_hi);
  }
  // W, once: row k of W's WC columns from WC·part is row k of the MN-major
  // B image (F32: its hi image, then its lo image)
  constexpr int WCH = WC / 8;
  for (int e = tid; e < D * WCH; e += NTHREADS) {
    Chunk<F32> c;
    ld_chunk<D, F32>(c, t.w, (e / WCH) * CH + part * WCH + e % WCH);
    st_chunk<F32>(smem, image_off(e / WCH, e % WCH, D), D * WC * 2, c);
  }
  fence_proxy_async();
  __syncthreads();

  uint32_t phase = 0;  // bit j: the parity of stage j's next wait
  const int rounds = (cnt + G - 1) / G;
  for (int r = 0; r < rounds; ++r) {
    const int t0 = start + r * G;  // the round's first tile
    const int m = min(G, cnt - r * G);
    float acc[G][WC / 64][32];
    for (int s = 0; s < n; ++s) {
      const bool push = s < n - 1;
      const u64 ctr = epoch_hi | (u64)(r * n + s);
      if (tid == 0 && s > 0) {
        // the left neighbour's pushes of step s - 1 are complete
        spin_until<SYS>(mine + F_RECV, ctr);
        fence_proxy_async_global();
      }
      const bf16* src = t.buf[rank] + ring_off + (s & 1) * slot;
      bf16* dst = t.buf[right] + ring_off + ((s + 1) & 1) * slot;
      if (s == 0) {
        // the caller's rows, written in the swizzle by the threads (F32:
        // split), four chunks' loads in flight per thread (the o of the
        // round is live in registers beside them)
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j >= m) break;
          const uint8_t* rows = x + (long long)(t0 + j) * BM * D *
                                        (F32 ? 4 : 2);
#pragma unroll
          for (int i0 = 0; i0 < TILE_VECS; i0 += 4) {
            Chunk<F32> v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ld_chunk<D, F32>(v[i], rows, tid + (i0 + i) * NTHREADS);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int e = tid + (i0 + i) * NTHREADS;
              st_chunk<F32>(smem + S::st_off + j * S::TILE,
                            image_off(e / CH, e % CH, BM), BM * D * 2, v[i]);
            }
          }
        }
        fence_proxy_async();
      } else if (tid == 0) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j >= m) break;
          mbar_expect_tx(full + 8 * j, S::TILE);
          bulk_load(stages + j * S::TILE,
                    src + (long long)(t0 + j) * BM * D * PL, S::TILE,
                    full + 8 * j);
        }
      }
      if (tid == 0 && push && (s >= 2 || (SYS && r == 0 && s == 0))) {
        // the right neighbour has taken its slot's previous tiles (and,
        // across cards, has started this call)
        spin_until<SYS>(mine + (s >= 2 ? F_CREDIT : F_START),
                        s >= 2 ? ctr - 1 : epoch_hi);
        fence_proxy_async_global();
      }
      __syncthreads();  // thread 0's waits are over; step 0's tiles in
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j >= m) break;
        if (s > 0) {
          mbar_wait(full + 8 * j, (phase >> j) & 1);
          phase ^= 1u << j;
        }
        const uint32_t st = stages + j * S::TILE;
        if (push && tid == 0) {
          bulk_store(dst + (long long)(t0 + j) * BM * D * PL, st, S::TILE);
          bulk_commit();
        }
        tile_product<D, F32, WC>(acc[j], st, wa, s > 0);
      }
      if (tid == 0) {
        // The step's tiles are in (and its pushes issued) while its
        // products run. This rank has taken its slot of step s: credit to
        // the writer, which awaits it before its push of step s + 1
        // (<= n - 2). Then publish the pushes once they are complete.
        if (s >= 1 && s <= n - 3) st_release<SYS>(lflags + F_CREDIT, ctr);
        if (push) {
          bulk_wait_all();
          fence_proxy_async_global();
          st_release<SYS>(rflags + F_RECV, ctr + 1);
        }
      }
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int h = 0; h < WC / 64; ++h) fence_regs(acc[j][h]);
      }
      if (s == n - 1) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j >= m) break;
          store_acc<D, WC>(out + (long long)(t0 + j) * BM * D, acc[j],
                           part * WC);
        }
      }
      // the stages are free once every thread's products are done with
      // them and thread 0's bulk stores have read them
      if (tid == 0 && push) {
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      __syncthreads();
    }
  }
}

// CTAs of one build the card holds at once, in spans (NH CTAs each; with
// the shared-memory opt-in it needs, set once per card on its first
// query).
template <int D, bool SYS, bool F32>
cudaError_t resident(int device, int* out) {
  constexpr int MAX_CARDS = 64;
  static int cached[MAX_CARDS] = {0};
  if (device < 0 || device >= MAX_CARDS) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        device_ring_kernel<D, SYS, F32>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<D, F32>::bytes);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, device_ring_kernel<D, SYS, F32>, NTHREADS,
        Geo<D, F32>::bytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    cached[device] = per_sm * sms / Geo<D, F32>::NH;
  }
  *out = cached[device];
  return cudaSuccess;
}

template <int D, bool SYS, bool F32>
cudaError_t launch(const RingTable& table, int n, int n_local, int L,
                   int grid, unsigned long long epoch, int device,
                   cudaStream_t stream) {
  int cap = 0;
  cudaError_t err = resident<D, SYS, F32>(device, &cap);
  if (err != cudaSuccess) return err;
  // every CTA of every rank of this launch must be resident at once (grid
  // and cap in spans of NH CTAs)
  if (grid * n_local > cap) return cudaErrorCooperativeLaunchTooLarge;
  RingTable t = table;
  u64 epoch_hi = (u64)epoch << 32;
  void* args[] = {&t, &n, &L, &epoch_hi};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(device_ring_kernel<D, SYS, F32>),
      dim3(grid * Geo<D, F32>::NH, n_local), dim3(NTHREADS), args,
      Geo<D, F32>::bytes, stream);
}

template <bool SYS, bool F32>
cudaError_t resident_for(int D, int device, int* out) {
  return D == 64    ? resident<64, SYS, F32>(device, out)
         : D == 128 ? resident<128, SYS, F32>(device, out)
                    : resident<256, SYS, F32>(device, out);
}

template <bool SYS, bool F32>
cudaError_t launch_d(const RingTable& t, int n, int n_local, int L, int D,
                     int grid, unsigned long long epoch, int device,
                     cudaStream_t s) {
  return D == 64    ? launch<64, SYS, F32>(t, n, n_local, L, grid, epoch,
                                           device, s)
         : D == 128 ? launch<128, SYS, F32>(t, n, n_local, L, grid, epoch,
                                            device, s)
                    : launch<256, SYS, F32>(t, n, n_local, L, grid, epoch,
                                            device, s);
}

// launch<D, SYS, F32> for run-time D, sys and f32.
cudaError_t launch_any(const RingTable& t, int n, int n_local, int L, int D,
                       int grid, unsigned long long epoch, int sys, int f32,
                       int device, cudaStream_t s) {
  if (f32) {
    return sys ? launch_d<true, true>(t, n, n_local, L, D, grid, epoch,
                                      device, s)
               : launch_d<false, true>(t, n, n_local, L, D, grid, epoch,
                                       device, s);
  }
  return sys ? launch_d<true, false>(t, n, n_local, L, D, grid, epoch,
                                     device, s)
             : launch_d<false, false>(t, n, n_local, L, D, grid, epoch,
                                      device, s);
}

// Runs f with `device` current, restoring the caller's card only where it
// had to be changed.
template <typename F>
cudaError_t on_device(int device, F f) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  if (prev == device) return f();
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = f();
  cudaSetDevice(prev);
  return err;
}

}  // namespace

// Spans (CTAs, or at D = 256 in fp32 pairs of CTAs, one per column half)
// of the (D, sys, f32) build that card `device` holds at once. The ring's
// common grid is the least, over its cards, of this over the card's ranks.
extern "C" int cfa_device_ring_resident(int D, int sys, int f32, int device,
                                        int* out) {
  if (D != 64 && D != 128 && D != 256) return cudaErrorInvalidValue;
  return on_device(device, [&]() {
    if (f32) {
      return sys ? resident_for<true, true>(D, device, out)
                 : resident_for<false, true>(D, device, out);
    }
    return sys ? resident_for<true, false>(D, device, out)
               : resident_for<false, false>(D, device, out);
  });
}

// x, w, out: this launch's shards [n_local, L, D] and W [D, D], bf16 (fp32
// under f32), and o [n_local, L, D] fp32, all on card `device`; buf, flags:
// n_shards device pointers each (per rank: its tile images [2, L, D] bf16,
// [2, 2·L, D] under f32 (hi and lo images), at D = 256 under f32 [2, 2, 2·L,
// D] (one double buffer per column half); its 64-bit flag words [grid,
// 4] ([2·grid, 4] there), zeroed once when allocated); local: the n_local
// ranks this launch runs; L rows per shard (a multiple of 64), D in {64,
// 128, 256}; grid: spans per rank (CTAs, or pairs of CTAs at D = 256 under
// f32), the same for every launch of the ring; epoch: this
// call's number on these flags, from 1, increasing by one per call and
// below 2^32; sys: 1 where a neighbour is on another card; f32: fp32 x
// and W. Launches on `stream` and does not synchronise.
extern "C" int cfa_device_ring(const void* x, const void* w, void* out,
                               void* const* buf, void* const* flags,
                               int n_shards, const int* local, int n_local,
                               int L, int D, int grid,
                               unsigned long long epoch, int sys, int f32,
                               int device, void* stream) {
  if (n_shards < 1 || n_shards > MAX_RANKS || n_local < 1 ||
      n_local > n_shards || L < BM || L % BM != 0 ||
      (D != 64 && D != 128 && D != 256) ||
      grid < 1 || grid > L / BM || epoch < 1 || epoch >= (1ull << 32)) {
    return cudaErrorInvalidValue;
  }
  // the count round·n + step stays below 2^32
  if ((unsigned long long)(L / BM) * n_shards >= (1ull << 31)) {
    return cudaErrorInvalidValue;
  }
  RingTable table;
  table.x = x;
  table.w = w;
  table.out = static_cast<float*>(out);
  for (int r = 0; r < n_shards; ++r) {
    table.buf[r] = static_cast<bf16*>(buf[r]);
    table.flags[r] = static_cast<u64*>(flags[r]);
  }
  for (int i = 0; i < n_local; ++i) table.local[i] = local[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = on_device(device, [&]() {
    return launch_any(table, n_shards, n_local, L, D, grid, epoch, sys, f32,
                      device, s);
  });
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

// Let kernels on card `device` store into allocations of card `peer`.
extern "C" int cfa_enable_peer_access(int device, int peer) {
  return on_device(device, [&]() {
    cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear the sticky code: it is not a failure
      err = cudaSuccess;
    }
    return err;
  });
}

// -- workspaces shared between processes ----------------------------------

// One allocation of `bytes` on card `device`, zeroed (the flag words start
// at 0) and finished before this returns, and its IPC handle (64 bytes,
// cudaIpcMemHandle_t) written to `handle`.
extern "C" int cfa_ipc_alloc(int device, long long bytes, void** ptr,
                             void* handle) {
  return on_device(device, [&]() {
    cudaError_t err = cudaMalloc(ptr, (size_t)bytes);
    if (err != cudaSuccess) return err;
    err = cudaMemset(*ptr, 0, (size_t)bytes);
    if (err == cudaSuccess) err = cudaDeviceSynchronize();
    if (err == cudaSuccess) {
      err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle),
                                *ptr);
    }
    if (err != cudaSuccess) cudaFree(*ptr);
    return err;
  });
}

// Another process's allocation, by its handle, mapped for card `device`
// (peer access to the allocation's card enabled where it is another).
extern "C" int cfa_ipc_open(int device, const void* handle, void** ptr) {
  return on_device(device, [&]() {
    cudaIpcMemHandle_t h;
    memcpy(&h, handle, sizeof(h));
    return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  });
}

// Unmap what cfa_ipc_open mapped.
extern "C" int cfa_ipc_close(int device, void* ptr) {
  return on_device(device, [&]() { return cudaIpcCloseMemHandle(ptr); });
}

// Free what cfa_ipc_alloc allocated, once every importer has closed it.
extern "C" int cfa_ipc_free(int device, void* ptr) {
  return on_device(device, [&]() { return cudaFree(ptr); });
}
