"""The ladder, stage by stage:

    python -m cuda_flashattention_torch.examples [--cpu] [stage ...]

runs the stages in order (all of them when none is named): 00
psum_vecadd, 01 ppermute_verify, 02 overlap, 03 attention_1chip, 04
ring_attention, 05 generate, 06 paged_serving and 07 device_ring, each
through its `main` with `--cpu` when given. A stage is named by its
number or its module name. Prints each stage's pass line and exits
non-zero if any stage failed. The counterpart of scripts/run_ladder.sh
and scripts/test_examples.sh.
"""

from __future__ import annotations

import argparse
import importlib
import sys

STAGES = (("00", "psum_vecadd"), ("01", "ppermute_verify"),
          ("02", "overlap"), ("03", "attention_1chip"),
          ("04", "ring_attention"), ("05", "generate"),
          ("06", "paged_serving"), ("07", "device_ring"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="*",
                    help="stage numbers or names (default: all)")
    ap.add_argument("--cpu", action="store_true",
                    help="run every stage on CPU tensors")
    args = ap.parse_args(argv)
    chosen = [(num, name) for num, name in STAGES
              if not args.stages or num in args.stages
              or name in args.stages]
    unknown = set(args.stages) - {x for s in STAGES for x in s}
    if unknown:
        ap.error(f"unknown stages {sorted(unknown)}")
    failed = []
    for num, name in chosen:
        print(f"=== ladder stage {num}: {name} ===", flush=True)
        stage = importlib.import_module(
            f"cuda_flashattention_torch.examples.{name}")
        if stage.main(["--cpu"] if args.cpu else []) != 0:
            failed.append(f"{num} {name}")
    print(f"ladder: {len(chosen) - len(failed)} of {len(chosen)} stages "
          f"passed" + (f"; failed: {', '.join(failed)}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
