"""What bounds K6's tile walk: the contiguous decode (csrc/decode.cu over
csrc/decode_body.cuh, `TileWalk`) timed with parts of its work switched off.

    python -m cuda_flashattention_torch.utils.decode_parts

Compiles a copy of `csrc/decode.cu` and `csrc/decode_body.cuh` into a
temporary directory (the library `_build` loads is left as it is), with
one build (bf16, D = 128, 4-row tiles) and a run-time switch in `Args`
that leaves out: the copies (the producer only arrives on each stage's
barrier), the scores, the softmax, P·V, all three consumer steps, the
merge of the splits, and the load of q. Then, at B=8, H=16, Hkv=4, d=128
over 640 and 4224 live bf16 keys, under the host's split size and
unsplit, it prints each variant's ms per call (CUDA events around the C
entry point, the tickets' memset included, a 256 MiB write before each
call so that the L2 cache is cold) and the full walk's max |O − plain O|.
Left out, a part's time is the full time less the variant's, where the
parts do not overlap. Needs nvcc and a card, so it runs on the machine
with the card.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from cuda_flashattention_torch import _build
from cuda_flashattention_torch.ops import decode as dec
from cuda_flashattention_torch.utils.timing import cuda_time_ms

# switch bits of the probe build's Args.probe
NO_COPIES, NO_SCORES, NO_SOFTMAX, NO_PV, NO_MERGE, NO_Q = 1, 2, 4, 8, 16, 32
VARIANTS = (
    (0, "all"),
    (NO_COPIES, "no copies"),
    (NO_SCORES, "no scores"),
    (NO_SOFTMAX, "no softmax"),
    (NO_PV, "no P.V"),
    (NO_MERGE, "no merge"),
    (NO_SCORES | NO_SOFTMAX | NO_PV, "no consumer steps"),
    (NO_COPIES | NO_SCORES | NO_SOFTMAX | NO_PV, "nothing"),
    (NO_COPIES | NO_SCORES | NO_SOFTMAX | NO_PV | NO_MERGE | NO_Q,
     "nothing, no merge, no q"),
)


def probe_sources(out: Path) -> None:
    """The probe's decode.cu and decode_body.cuh in `out`."""
    body = (_build.CSRC / "decode_body.cuh").read_text()
    edits = (
        (r"  int gran;[^\n]*\n", "  int gran;\n  int probe;\n"),
        (r"\n(\s*)produce\(sbase \+ st \* STAGE, full0 \+ 8 \* st,",
         r"\n\1if (a.probe & 1) { if (lane == 0) mbar_expect_tx(full0 + 8 * "
         r"st, 0); } else produce(sbase + st * STAGE, full0 + 8 * st,"),
        (r"if \(js >= ja && js < jb\) \{",
         "if (!(a.probe & 2) && js >= ja && js < jb) {"),
        (r"if \(rr < R\) \{(\s*)float sv\[NK\];",
         r"if (rr < R && !(a.probe & 4)) {\1float sv[NK];"),
        (r"if \(c2 < d\) \{(\s*)const unsigned char\* vcol",
         r"if (c2 < d && !(a.probe & 8)) {\1const unsigned char* vcol"),
        (r"    if \(alone\) return;\n    merge\(",
         "    if (alone || (a.probe & 16)) return;\n    merge("),
        (r"for \(int i = tid; i < R \* D; i \+= NCONS\) \{",
         "for (int i = tid; i < ((a.probe & 32) ? 0 : R * D); i += NCONS) {"),
    )
    for pattern, repl in edits:
        body, n = re.subn(pattern, repl, body, count=1)
        if n != 1:
            raise RuntimeError(f"decode_parts: the body no longer has "
                               f"{pattern!r}")
    (out / "decode_body.cuh").write_text(body)
    src = (_build.CSRC / "decode.cu").read_text()
    # the dispatch becomes the one probe build
    call = re.search(r"  return dispatch<Launch, DecodeQ>\(.*?max_n, st\);\n",
                     src, re.S)
    if call is None:
        raise RuntimeError("decode_parts: cfa_decode's dispatch moved")
    src = (src[:call.start()]
           + "  a.probe = probe_mode;\n  return Launch<128, __nv_bfloat16, "
             "__nv_bfloat16, __nv_bfloat16, false, 4>::run(a, k, v, B, "
             "max_n, st);\n" + src[call.end():])
    src = src.replace('extern "C" int cfa_decode(',
                      'static int probe_mode = 0;\nextern "C" void '
                      'cfa_probe(int m) { probe_mode = m; }\n'
                      'extern "C" int cfa_decode(', 1)
    (out / "decode.cu").write_text(src)


def build(out: Path) -> ctypes.CDLL:
    probe_sources(out)
    lib = out / "libprobe.so"
    subprocess.run([_build.find_nvcc(), *_build.ARCH_FLAGS,
                    *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                    str(out / "decode.cu")], check=True)
    so = ctypes.CDLL(str(lib))
    so.cfa_decode.argtypes = _build.SIGNATURES["cfa_decode"]
    so.cfa_decode.restype = ctypes.c_int
    so.cfa_probe.argtypes = [ctypes.c_int]
    return so


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("decode_parts times the kernel on a card")
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def mk(*shape, peak=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) - 0.5)
                * peak).to(torch.bfloat16)

    b, h, hkv, d = 8, 16, 4, 128
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp))
        q = mk(b, h, d, peak=8)
        rule = dec.split_size(b, hkv, 1, d)
        for live, split in ((640, rule), (4224, rule), (4224, dec.NO_SPLIT)):
            k, v = mk(b, hkv, live, d, peak=4), mk(b, hkv, live, d)
            lens = torch.full((b,), live, dtype=torch.int32, device=dev)
            o = torch.empty_like(q)
            lse = torch.empty(b, h, device=dev)
            split = min(split, live)
            _, part, tickets = dec.split_scratch(b, hkv, h // hkv, d, live,
                                                 dev, split)

            def call():
                err = lib.cfa_decode(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
                    None, lens.data_ptr(), None, o.data_ptr(),
                    lse.data_ptr(), dec.optional_ptr(part),
                    dec.optional_ptr(tickets), b, h, hkv, live, d, 0, 0, 0,
                    0, d ** -0.5, 0, split,
                    torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"decode_parts: CUDA error {err}")

            ref = dec.decode_attention_plain(q, k, v, lens)[0].float()
            for mode, name in VARIANTS:
                lib.cfa_probe(mode)
                ms = cuda_time_ms(call, iters=30, before=flush.zero_)
                line = (f"[decode_parts] {live} live, split {split}, "
                        f"{name}: {ms:.4f} ms")
                if mode == 0:
                    torch.cuda.synchronize()
                    line += (f", max|O - plain| "
                             f"{(o.float() - ref).abs().max().item():.2e}")
                print(f"{line} ({card})", flush=True)


if __name__ == "__main__":
    main()
