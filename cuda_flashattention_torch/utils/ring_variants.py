"""Time the device ring's design choices (K9, csrc/device_ring.cu) beside
the source as it stands, in one process.

    python3 cuda_flashattention_torch/utils/ring_variants.py [name ...]

Each variant is the kernel's source with a few text substitutions (as in
`utils/bwd_variants.py`: the kernel keeps only the design it ships), built
by nvcc into a library of its own and driven through the same C entry
points and workspace as `parallel/device_ring.py`. Names:
  as_is        the source as it stands (o in registers, 2 tiles per round
               at d = 128, registers for 2 CTAs per SM; the push one bulk
               store per tile)
  group1       one tile per round in registers
  o_l2         o accumulated in fp32 in device memory (L2-resident), one
               round per span, walked in chunks of the stages
  push_stores  the push as 16-byte stores by every thread from shared
               memory, published after the CTA's barrier and a fence, in
               place of the bulk store
  three_per_sm registers sized for 3 CTAs per SM (168: it spills)
Default: all five. Prints each build's registers and spills, then for each
variant, on one card, the largest |diff| against tile((Σ x_i) @ W) in fp32
and the kernel's ms per launch (torch.profiler over 20 calls: device time,
without the host's launch latency, which CUDA events around one call of a
kernel this short would measure instead) at n=4 L=1024 and n=8 L=8192
with the .gpu-scope flags and with the .sys-scope build; then the round
trip of one hop at each scope: kernel ms at L=64 (one tile, one CTA per
rank) for n=1 and n=8, (n8 − n1) / 7; and the host's µs per call of the
C entry point at n=4 L=1024 (50 calls enqueued without a wait). The
variants run in turn and then in reverse. With two or more cards visible
it repeats the shapes and the round trip over the cards (rank i on card
i % cards, .sys scope; the mean of the cards' launches). Needs a CUDA
device and nvcc.
"""

import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_PUSH_BULK = """        if (push && tid == 0) {
          bulk_store(dst + (long long)(t0 + j) * BM * D * PL, st, S::TILE);
          bulk_commit();
        }
"""
_PUSH_STORES = """        if (push) {
          bf16* to = dst + (long long)(t0 + j) * BM * D * PL;
          for (int e = tid; e < S::TILE / 16; e += NTHREADS) {
            uint4 v;
            asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                         : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                         : "r"(st + 16 * e));
            __stcg(reinterpret_cast<uint4*>(to) + e, v);
          }
        }
"""
_PUBLISH_BULK = """        if (push) {
          bulk_wait_all();
          fence_proxy_async_global();
          st_release<SYS>(rflags + F_RECV, ctr + 1);
        }
"""
_STAGES_FREE = """      if (tid == 0 && push) {
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      __syncthreads();
"""
# every thread's stores are behind the barrier, then one fence and release
_PUBLISH_STORES = """      __syncthreads();
      if (tid == 0 && push) {
        if (SYS) {
          asm volatile("fence.acq_rel.sys;" ::: "memory");
        } else {
          asm volatile("fence.acq_rel.gpu;" ::: "memory");
        }
        st_release<SYS>(rflags + F_RECV, ctr + 1);
      }
"""
_LOAD_ACC = """template <int D, int WC>
__device__ __forceinline__ void load_acc(float (&acc)[WC / 64][32],
                                         const float* o, int col0) {
#pragma unroll
  for (int h = 0; h < WC / 64; ++h) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(
          o + acc_row(i) * D + col0 + acc_col(h, i));
      acc[h][i] = v.x;
      acc[h][i + 1] = v.y;
    }
  }
}

"""
_KERNEL_RULE = """// ---------------------------------------------------------------------------
// The kernel
"""
_ROUND = """    const int t0 = start + r * G;  // the round's first tile
    const int m = min(G, cnt - r * G);
"""
_DST = ("      bf16* dst = t.buf[right] + ring_off + ((s + 1) & 1) * "
        "slot;\n")
# o in L2: every step walks the whole span in chunks of the G stages,
# reading o back before a chunk's products and writing it after them; the
# credit is awaited before the first chunk, the flags signalled after the
# last
_CHUNK = """      for (int c0 = 0; c0 < cnt; c0 += G) {
      const int t0 = start + c0;
      const int m = min(G, cnt - c0);
"""
_BARRIER = ("      __syncthreads();  // thread 0's waits are over; step 0's "
            "tiles in\n")
_READ_O = """      if (s > 0) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j < m) {
            load_acc<D, WC>(acc[j], out + (long long)(t0 + j) * BM * D,
                            part * WC);
          }
        }
      }
"""
_STEP_END = "      __syncthreads();\n    }\n  }\n}\n"

VARIANTS = {
    "as_is": [],
    "group1": [("  static constexpr int G = D == 64 ? 4 : D == 128 && !F32 "
                "? 2 : 1;", "  static constexpr int G = D == 64 ? 2 : 1;")],
    "o_l2": [
        (_KERNEL_RULE, _LOAD_ACC + _KERNEL_RULE),
        ("  const int rounds = (cnt + G - 1) / G;\n",
         "  const int rounds = 1;\n"),
        (_ROUND, ""),
        (_DST, _DST + _CHUNK),
        ("      if (tid == 0 && push && (s >= 2",
         "      if (tid == 0 && c0 == 0 && push && (s >= 2"),
        (_BARRIER, _READ_O + _BARRIER),
        ("      if (tid == 0) {\n        // The step's tiles",
         "      if (tid == 0 && c0 + G >= cnt) {\n        // The step's tiles"),
        ("      if (s == n - 1) {\n", "      {\n"),
        (_STEP_END, "      __syncthreads();\n      }\n    }\n  }\n}\n"),
    ],
    "push_stores": [(_PUSH_BULK, _PUSH_STORES), (_PUBLISH_BULK, ""),
                    (_STAGES_FREE, _PUBLISH_STORES)],
    "three_per_sm": [("constexpr int MIN_BLOCKS = 2;",
                      "constexpr int MIN_BLOCKS = 3;")],
}
SHAPES = [(4, 1024), (8, 8192)]
HOP_ROWS = 64


def main(names) -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from cuda_flashattention_torch import _build
    from cuda_flashattention_torch.parallel import device_ring as dr
    from cuda_flashattention_torch.utils.bwd_variants import variant_source
    from cuda_flashattention_torch.utils.profiling import kernel_times

    src = (_build.CSRC / "device_ring.cu").read_text()
    nvcc = _build.find_nvcc()
    tmp = tempfile.TemporaryDirectory()
    libs, procs = {}, []
    for name in names:
        cu = Path(tmp.name) / f"{name}.cu"
        cu.write_text(variant_source(src, name, VARIANTS))
        out = cu.with_suffix(".so")
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-shared",
               "-Xptxas", "-v", f"-I{_build.CSRC}", "-o", str(out), str(cu)]
        procs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for name, out, proc in procs:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{text}")
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in text.splitlines() if "Used " in line})
        spills = sorted({line.strip() for line in text.splitlines()
                         if "spill" in line and " 0 bytes spill" not in line})
        serial = "C7515" in text
        print(f"{name}: built; registers {regs}; spills {spills or 'none'}"
              f"{'; wgmma serialized (C7515)' if serial else ''}", flush=True)
        lib = ctypes.CDLL(str(out))
        for fn in ("cfa_device_ring", "cfa_device_ring_resident",
                   "cfa_enable_peer_access"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    card = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda:0").manual_seed(0)

    def mk(*shape):
        return (torch.rand(shape, generator=gen, device="cuda:0")
                - 0.5).to(torch.bfloat16)

    def ring(lib, devs, rows, sys_scope, d=128):
        """A launcher of one call over `devs` (one rank each) on a fresh
        workspace of `lib`, its output, and the fp32 reference."""
        n = len(devs)
        ws = dr._Workspace(lib, tuple(devs), rows, d)
        ws.sys = sys_scope
        x, w = mk(n * rows, d), mk(d, d)
        ref = (x.float().view(n, rows, d).sum(0) @ w.float()).repeat(n, 1)
        per_card = {}
        for dev, idxs in ws.cards.items():
            x_dev = torch.cat([x[i * rows:(i + 1) * rows]
                               for i in idxs]).to(dev)
            out = torch.empty((len(idxs) * rows, d), dtype=torch.float32,
                              device=dev)
            per_card[dev] = (idxs, x_dev, w.to(dev), out)

        def run():
            epoch = ws.next_epoch()
            for dev, (_, x_dev, w_dev, out) in per_card.items():
                dr._launch(lib, ws, dev, x_dev, w_dev, out, epoch,
                           torch.cuda.current_stream(dev))

        def result():
            o = torch.empty_like(ref)
            for idxs, _, _, out in per_card.values():
                for j, i in enumerate(idxs):
                    o[i * rows:(i + 1) * rows] = out[j * rows:(j + 1) * rows]
            return o
        return run, result, ref

    def ms(run, devs, iters=20, attempts=3):
        """Device ms per launch of the ring's kernel over `iters` calls (a
        window that lost its launches is profiled again)."""
        for _ in range(attempts):
            run()
            for d in dict.fromkeys(devs):
                torch.cuda.synchronize(d)
            prof = kernel_times(run, iters=iters)
            names = [k for k in prof.ms if "device_ring_kernel" in k]
            count = sum(prof.count[k] for k in names)
            if count:
                return sum(prof.ms[k] for k in names) / count
        return float("nan")

    def host_us(run, devs, calls=50):
        run()
        for d in dict.fromkeys(devs):
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        t = (time.perf_counter() - t0) / calls * 1e6
        for d in dict.fromkeys(devs):
            torch.cuda.synchronize(d)
        return t

    def layouts():
        one = torch.device("cuda", 0)
        yield "one card", lambda n: [one] * n, (0, 1)
        cards = torch.cuda.device_count()
        if cards > 1:
            yield (f"{cards} cards", lambda n: [torch.device("cuda", i % cards)
                                              for i in range(n)], (1,))

    for where, devs_of, scopes in layouts():
        for name, lib in libs.items():
            for n, rows in SHAPES:
                for sc in scopes:
                    run, result, ref = ring(lib, devs_of(n), rows, sc)
                    run()
                    torch.cuda.synchronize()
                    err = (result() - ref).abs().max().item()
                    print(f"{name} ({where}) n={n} L={rows} "
                          f"{'sys' if sc else 'gpu'}: max|diff| {err:.3e} "
                          f"(max|ref| {ref.abs().max().item():.3e})",
                          flush=True)
        order = list(libs.items())
        for rep in (order, order[::-1]):
            for n, rows in SHAPES:
                for sc in scopes:
                    row = []
                    for name, lib in rep:
                        run, _, _ = ring(lib, devs_of(n), rows, sc)
                        row.append(f"{name} {ms(run, devs_of(n)):.4f}")
                    print(f"K9 kernel ({where}) n={n} L={rows} "
                          f"{'sys' if sc else 'gpu'}: " + ", ".join(row)
                          + f" ms ({card})", flush=True)
            for sc in scopes:
                row = []
                for name, lib in rep:
                    t = {n: ms(ring(lib, devs_of(n), HOP_ROWS, sc)[0],
                               devs_of(n), iters=40) for n in (1, 8)}
                    row.append(f"{name} {(t[8] - t[1]) / 7 * 1e3:.2f} "
                               f"(n=1 {t[1]:.4f}, n=8 {t[8]:.4f} ms)")
                print(f"K9 round trip of one hop ({where}, "
                      f"{'sys' if sc else 'gpu'} scope, L={HOP_ROWS}), µs: "
                      + ", ".join(row) + f" ({card})", flush=True)
            row = []
            for name, lib in rep:
                n, rows = SHAPES[0]
                run = ring(lib, devs_of(n), rows, scopes[0])[0]
                row.append(f"{name} {host_us(run, devs_of(n)):.1f}")
            print(f"K9 host µs per call of the C entry point ({where}) "
                  f"n={SHAPES[0][0]} L={SHAPES[0][1]}: " + ", ".join(row),
                  flush=True)
    tmp.cleanup()


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
