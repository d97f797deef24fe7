"""Time variants of the key-parallel backward kernel (K2 and K4,
csrc/flash_bwd_kv.cu) beside the source as it stands, in one process on
one card.

    python3 cuda_flashattention_torch/utils/bwd_variants.py [name ...]

Each variant is the kernel's source with a few text substitutions (so the
design choices its source note reports can be measured again), built by
nvcc into a library of its own and called through the same C entry point
as `ops/flash_bwd.py`. Names (join several with "+"):
  as_is       the source as it stands
  red_v4      dQ added from the registers with 16-byte vector atomics
              (red.global.add.v4.f32) in place of the staging tile and
              the TMA reduces
  no_reduce   the staging tile written, the TMA reduces not issued (dQ
              wrong: what the reduce traffic costs)
  no_dq_add   neither (dQ wrong: a ceiling)
  late_wait   dV/dK's wgmma waited for together with dQ's
  ascending   key tiles fastest in the CTA order, not heaviest first
  stages3     three Q/dO stages (fits only beside red_v4)
Default: as_is red_v4 no_reduce no_dq_add late_wait ascending
red_v4+stages3. Prints each variant's largest relative error of dQ, dK and
dV against `flash_attention_backward_plain` at the training shape, then
K4's and K2's kernel ms (one launch between CUDA events, median of 30)
at the shapes of `utils/ab_kernels.py` plus GQA (Hkv=4), the variants in
turn and then in reverse. Needs a CUDA device and nvcc.
"""

import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

# dQ from the registers: lanes t and t ^ 1 swap half their pairs so that
# each sends four adjacent columns of one row as one 16-byte atomic
_ADD_DQ = """
template <int D>
__device__ __forceinline__ void add_dq(const BwdArgs& a, const float (&d)[32],
                                       long long row_base, int q0, int wg) {
  const int lane = threadIdx.x & 31;
  const int r = q0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const bool odd = lane & 1;
  const int mine = odd ? r + 8 : r;
  const int col0 = (D == 128 ? 64 * wg : 0) + 2 * (lane & 3) - (odd ? 2 : 0);
  float* dst = a.dq_acc + (row_base + mine) * D + col0;
  const bool live = mine < a.Nq;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float* x = &d[4 * j];
    const float s0 = odd ? x[0] : x[2], s1 = odd ? x[1] : x[3];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    if (!live) continue;
    const float4 v = odd ? make_float4(r0, r1, x[2], x[3])
                         : make_float4(x[0], x[1], r0, r1);
    atomicAdd(reinterpret_cast<float4*>(dst + 8 * j), v);
  }
}

// This warpgroup's 64 rows of dK (or dV) as bf16, past Nk skipped."""

_STAGING = """        // dQ_i's part into the staging tile, then added into dq_acc by one
        // TMA reduce per 32 columns, issued by the warpgroup's first thread
        uint8_t* stg = smem + L::stg_off + wg * L::STG;
        stage_dq(stg, dq);
        fence_proxy_async();
        wg_sync(wg);
        if (leader) {
          const int col = D == 128 ? 64 * wg : 0;
          tma_reduce_add_4d(&tm_dq, smem_u32(stg), col, q0, h, b);
          tma_reduce_add_4d(&tm_dq, smem_u32(stg) + BQ * 128, col + 32, q0,
                            h, b);
          bulk_commit();
        }
"""

_EARLY_WAIT = """      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pk);
      fence_regs(dsk);
      if (lane == 0) mbar_arrive(empty + 8 * st);
      if (FUSED) {"""

# (old, new) substitutions of each variant
VARIANTS = {
    "as_is": [],
    "red_v4": [
        ("\n// This warpgroup's 64 rows of dK (or dV) as bf16, past Nk skipped.",
         _ADD_DQ),
        (_STAGING,
         "        add_dq<D>(a, dq, (long long)(b * a.H + h) * a.Nq, q0, wg);\n"),
        ("  static constexpr int st_off = stg_off + (FUSED ? 2 * STG : 0);",
         "  static constexpr int st_off = stg_off;"),
    ],
    "no_reduce": [
        ("        if (leader) {\n          const int col",
         "        if (leader && q0 < 0) {\n          const int col"),
    ],
    "no_dq_add": [(_STAGING, "")],
    "late_wait": [
        (_EARLY_WAIT, """      wgmma_commit();
      if (!FUSED) {
        wgmma_wait_all();
        fence_regs(pk);
        fence_regs(dsk);
        if (lane == 0) mbar_arrive(empty + 8 * st);
      }
      if (FUSED) {"""),
        ("        wgmma_wait_all();\n        fence_regs(dq);\n",
         "        wgmma_wait_all();\n        fence_regs(dq);\n"
         "        fence_regs(pk);\n        fence_regs(dsk);\n"
         "        if (lane == 0) mbar_arrive(empty + 8 * st);\n"),
    ],
    "ascending": [
        ("  kt = blockIdx.x / per_tile;\n"
         "  const int rest = blockIdx.x % per_tile;",
         "  kt = blockIdx.x % ((a.Nk + BK - 1) / BK);\n"
         "  const int rest = blockIdx.x / ((a.Nk + BK - 1) / BK);"),
    ],
    "stages3": [("constexpr int NST = 2;", "constexpr int NST = 3;")],
}
DEFAULT = ["as_is", "red_v4", "no_reduce", "no_dq_add", "late_wait",
           "ascending", "red_v4+stages3"]


def variant_source(src: str, name: str) -> str:
    """The kernel's source with the substitutions of each part of `name`;
    raises if the source no longer holds a text a substitution needs."""
    for part in name.split("+"):
        for old, new in VARIANTS[part]:
            if src.count(old) != 1:
                raise ValueError(f"{part}: the source holds {old[:40]!r} "
                                 f"{src.count(old)} times, not once")
            src = src.replace(old, new)
    return src


def main(names) -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from cuda_flashattention_torch import _build
    from cuda_flashattention_torch.ops.flash_bwd import (
        flash_attention_backward_plain)
    from cuda_flashattention_torch.ops.flash_fwd import (
        flash_attention_forward)

    src = (_build.CSRC / "flash_bwd_kv.cu").read_text()
    nvcc = _build.find_nvcc()
    tmp = tempfile.TemporaryDirectory()
    libs, procs = {}, []
    for name in names:
        cu = Path(tmp.name) / f"{name.replace('+', '_')}.cu"
        cu.write_text(variant_source(src, name))
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
        spills = sorted({line.strip() for line in text.splitlines()
                         if "spill" in line and " 0 bytes spill" not in line})
        print(f"{name}: built; spills: {spills or 'none'}", flush=True)
        lib = ctypes.CDLL(str(out))
        lib.cfa_flash_bwd_kv.argtypes = _build.SIGNATURES["cfa_flash_bwd_kv"]
        lib.cfa_flash_bwd_kv.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def mk(*shape):
        return (torch.rand(shape, generator=gen, device=dev) - 0.5).to(
            torch.bfloat16)

    def launcher(lib, q, k, v, o, lse, do, fused, causal=True, window=0):
        """A call of the C entry point as `_bwd_cuda` makes it, on fresh
        outputs (dq_acc zeroed before each launch, outside the timing)."""
        b, h, nq, d = q.shape
        h_kv, nk = k.shape[1], k.shape[2]
        delta = (do.float() * o.float()).sum(-1)
        strides = (ctypes.c_longlong * 12)(
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3])
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        dq = (torch.zeros((b, h, nq, d), dtype=torch.float32, device=dev)
              if fused else None)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), None, None, dk.data_ptr(),
                dv.data_ptr(), None if dq is None else dq.data_ptr(), b, h,
                h_kv, nq, nk, d, strides, d ** -0.5, int(causal), window, 0,
                torch.cuda.current_stream().cuda_stream)

        def run():
            if lib.cfa_flash_bwd_kv(*args) != 0:
                raise RuntimeError("launch failed")
        return run, (dq, dk, dv, delta)

    def kernel_ms(run, out, iters=30):
        times = []
        for i in range(iters + 3):
            if out[0] is not None:
                out[0].zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
        return statistics.median(times)

    shapes = [("train causal", (1, 16, 16, 4096), dict(causal=True)),
              ("train GQA Hkv=4 causal", (1, 16, 4, 4096), dict(causal=True)),
              ("train window 1024", (1, 16, 16, 4096),
               dict(causal=True, window=1024)),
              ("train no mask", (1, 16, 16, 4096), dict(causal=False)),
              ("prefill", (8, 16, 4, 512), dict(causal=True))]
    cases = []
    for label, (b, h, h_kv, n), kw in shapes:
        q, do = mk(b, h, n, 128), mk(b, h, n, 128)
        k, v = mk(b, h_kv, n, 128), mk(b, h_kv, n, 128)
        o, lse = flash_attention_forward(q, k, v, **kw)
        cases.append((label, (q, k, v, o, lse, do), kw))
    card = torch.cuda.get_device_name(0)
    _, args, kw = cases[0]
    want = flash_attention_backward_plain(*args, **kw)
    for name, lib in libs.items():
        run, out = launcher(lib, *args, fused=True, **kw)
        run()
        torch.cuda.synchronize()
        errs = [((g.float() - w.float()).abs().max()
                 / w.float().abs().max()).item()
                for g, w in zip(out[:3], want)]
        print(f"{name}: max|diff|/max|plain| dQ {errs[0]:.2e} dK "
              f"{errs[1]:.2e} dV {errs[2]:.2e} (training shape)", flush=True)
    order = list(libs.items())
    for rep in (order, order[::-1]):
        for label, args, kw in cases:
            for fused in (True, False):
                if not fused and label != "train causal":
                    continue
                row = []
                for name, lib in rep:
                    ms = kernel_ms(*launcher(lib, *args, fused=fused, **kw))
                    row.append(f"{name} {ms:.4f}")
                print(f"{'K4' if fused else 'K2'} {label}: "
                      + ", ".join(row) + f" ms ({card})", flush=True)
    tmp.cleanup()


if __name__ == "__main__":
    main(sys.argv[1:] or DEFAULT)
