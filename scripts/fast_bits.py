#!/usr/bin/env python3
"""Fingerprint the bits of every fast column-tile kernel, and of the strict
forms beside them, so that two checkouts can be compared bit for bit on
one card.

    python3 scripts/fast_bits.py --root DIR --out A.json   # one checkout
    python3 scripts/fast_bits.py --compare A.json B.json   # exit 1 if any
                                                           # output differs

--only REGEX fingerprints the forms whose names match REGEX alone.

--root names the checkout whose port (DIR/xlab_fftbarotropic_torch) is
built from its own csrc/ and run. The inputs come from the case functions
of this repository's chip_smoke.py (numpy-seeded), so two checkouts run
on the same inputs: every fast form of phases 5o-5q (fast_cases,
fast_sw_cases, fast_arm_cases, fast_xfirst_cases, fast_rest_cases) and
ky_all's with split off (fast_split_off_cases, phase 5v) on
its random inputs, its exact-integer inputs and its strict form, at
SHAPES. Each output tensor is recorded as the sha256 of its bytes. Needs
one CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
# (transform length, columns or None for the n x n grid): the main paths'
# 4096^2, ragged tiles at K = 2 (kb_adv's tiles of C/2 at m = 512), K = 1,
# and m = 1024 (8192, C = 8)
SHAPES = ((4096, None), (1024, 33), (256, 200), (8192, 24))
FAMILIES = ("fast_cases", "fast_sw_cases", "fast_arm_cases",
            "fast_xfirst_cases", "fast_rest_cases", "fast_split_off_cases")


def _digest(tensors) -> list:
    import torch
    out = []
    for t in tensors:
        t = t.detach().contiguous().cpu()
        out.append(hashlib.sha256(t.view(torch.uint8).numpy().tobytes())
                   .hexdigest()[:24] + f" {tuple(t.shape)} {t.dtype}")
    return out


def load(root: Path):
    """The port of `root` (imported from there, its kernels built) and
    this repository's chip_smoke.py as a module."""
    sys.path.insert(0, str(root))
    import xlab_fftbarotropic_torch as port
    from xlab_fftbarotropic_torch.ops import _build

    if Path(port.__file__).resolve().parent.parent != root.resolve():
        raise SystemExit(f"the port came from {port.__file__}, not {root}")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _build.lib()
    return smoke, _build


def fingerprint(root: Path, only=None) -> dict:
    import torch
    t0 = time.perf_counter()
    smoke, _ = load(root)
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"root": str(root), "card": smoke.nvidia_smi(),
           "build_s": time.perf_counter() - t0, "outputs": {}}
    for n, cols in SHAPES:
        for family in FAMILIES:
            cases = getattr(smoke, family)(n, cols, dev, n + (cols or 0))
            for name, case in cases.items():
                if only and not re.search(only, name):
                    continue
                for kind in ("kern", "exact_kern", "strict"):
                    outs = case.fields(getattr(case, kind)())
                    out["outputs"][f"{n} {cols} {name} {kind}"] = _digest(
                        outs)
            del cases
            torch.cuda.empty_cache()
        print(f"{root}: {n} x {cols} done, {len(out['outputs'])} results",
              flush=True)
    return out


def compare(a: dict, b: dict) -> int:
    keys = sorted(set(a["outputs"]) | set(b["outputs"]))
    differ = [k for k in keys if a["outputs"].get(k) != b["outputs"].get(k)]
    fast = [k for k in keys if not k.endswith(" strict")]
    print(f"{len(keys)} results ({len(fast)} fast, {len(keys) - len(fast)} "
          f"strict) on {a['card']}: {len(differ)} differ")
    for k in differ:
        print(f"  differs: {k}: {a['outputs'].get(k)} vs "
              f"{b['outputs'].get(k)}")
    return 1 if differ else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--compare", nargs=2, type=Path, metavar="JSON")
    ap.add_argument("--only", default=None, metavar="REGEX")
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (json.loads(p.read_text()) for p in args.compare)
        return compare(a, b)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("fast_bits: no CUDA device")
    result = fingerprint(args.root, args.only)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
