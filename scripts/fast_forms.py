#!/usr/bin/env python3
"""Time every fast column-tile form against its strict form on one card,
for one checkout, and list the fast kernels' registers and spills.

    python3 scripts/fast_forms.py [--root DIR] [--n 4096] [--only REGEX]

--root names the checkout whose port (DIR/xlab_fftbarotropic_torch) is
built from its own csrc/ and run; the inputs come from this repository's
chip_smoke.py case functions (numpy-seeded), so two checkouts time the
same inputs: every fast form of phases 5o-5q (fast_cases,
fast_sw_cases, fast_arm_cases, fast_xfirst_cases, fast_rest_cases) and
ky_all's with split off (fast_split_off_cases) at
n^2, each with CUDA events in turns with its strict form (fast, strict,
strict, fast: chip_smoke._turns), and the sum over the forms. To compare
two checkouts, run it for each in one call, in turns (parent, change,
change, parent). --only times the forms whose names match REGEX alone.
Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--only", default=None, metavar="REGEX")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("fast_forms: no CUDA device")
    from fast_bits import FAMILIES, load
    smoke, _build = load(root)
    print(f"{root.name}: {smoke.nvidia_smi()}")
    log = (Path(_build.LAST_BUILD["path"]).parent / "build.log").read_text()
    for fn, body in re.findall(r"Compiling entry function '(\w+)'"
                               r"(.*?)Compile time", log, re.S):
        kernel = re.search(r"\d(\w+?_kernel)I", fn)
        if kernel is None or "fast" not in smoke.ptxas_tag(kernel.group(1),
                                                           fn):
            continue
        regs = re.search(r"Used (\d+) registers", body).group(1)
        st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", body).groups()
        print(f"{root.name}: ptxas {smoke.ptxas_tag(kernel.group(1), fn)}: "
              f"{regs} registers, spill stores {st} B, loads {ld} B")
    dev = torch.device("cuda", torch.cuda.current_device())
    total_fast = total_strict = 0.0
    for family in FAMILIES:
        cases = getattr(smoke, family)(args.n, None, dev, args.n)
        for name, case in cases.items():
            if args.only and not re.search(args.only, name):
                continue
            fast, strict = smoke._turns(case.kern, case.strict)
            total_fast += fast
            total_strict += strict
            print(f"{root.name}: {name:22s} {args.n}^2 fast {fast:.4f} ms, "
                  f"strict {strict:.4f} ms ({fast / strict:.3f}x)",
                  flush=True)
        del cases
        torch.cuda.empty_cache()
    print(f"{root.name}: every fast form {total_fast:.4f} ms, their strict "
          f"forms {total_strict:.4f} ms ({total_fast / total_strict:.3f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
