#!/usr/bin/env python3
"""Which float32 sum the tensor cores form in the fast column tile's
radix-16 pass: the fast forward x-stage kernel (kx_fwd on the fast tile,
csrc/xtile.cuh FAST: two mma.sync.m16n8k16 bf16 products per output, the
second accumulating into the first's float32 result) against
ops/fast_tile.py's fast_dft with its DFT-16 sums (dot16) formed under
several models, on random inputs; per model the share of output values
equal bit for bit to the kernel's and the rel-L2; with --cases, the
same for chip_smoke.py's fast cases (fast_cases, fast_arm_cases, seeded by
the length as the card tests seed them) at a (length, columns) shape:
each fast kernel against its plain version on
random inputs under each model (the largest rel-L2 of its outputs).

    python3 scripts/fast_sum_order.py [--n 256 1024 4096] [--seed 0]
        [--cases 1024x33 ...]

Models (each product of bf16 values is exact): "exact": the 32 products
of an output summed exactly, rounded once to float32 (fast_dft's own
dot16); "mma-rn", "mma-rz": each mma's 16 products and its accumulator
summed exactly and rounded to float32, to nearest or toward zero;
"k8-rn", "k8-rz": the same in chunks of 8 products; "align-F-rz" for F =
23..26: each mma's terms (accumulator included) truncated toward zero to
F bits below the largest term's leading bit, summed, the sum rounded
toward zero; its variants "-floor" (the terms truncated toward minus
infinity, as a two's complement shift does; "-floor-rd" the sum rounded
toward minus infinity too), "-k8" (in chunks of 8
products), "-acc" (the accumulator kept whole), "-prod" (the largest
product's leading bit, not the accumulator's, sets the alignment) and
"-rn" (the sum rounded to nearest). --models picks models by name.
Ends with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _rz(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _rd(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward minus infinity."""
    r = x.float()
    over = r.double() > x
    return torch.where(over, torch.nextafter(r, torch.full_like(r, -1e38)),
                       r)


def _round(x: torch.Tensor, mode: str) -> torch.Tensor:
    return {"rn": lambda v: v.float(), "rz": _rz, "rd": _rd}[mode](
        x).double()


def _align(terms: list, bits: int, cut=torch.trunc, keep_first=False,
           by_products=False) -> torch.Tensor:
    """sum of the terms, each cut (trunc: toward zero; floor: toward
    minus infinity) to a multiple of 2^(e - bits), e the largest term's
    exponent (by_products: the largest of all but the first); keep_first:
    the first term (the accumulator) added whole."""
    ref = terms[1:] if by_products else terms
    mag = torch.stack([t.abs() for t in ref]).amax(0)
    e = torch.floor(torch.log2(torch.where(mag > 0, mag,
                                           torch.ones_like(mag))))
    q = torch.exp2(e - bits)
    cuts = [cut(t / q) * q for t in terms[1 if keep_first else 0:]]
    return sum(cuts) + (terms[0] if keep_first else 0)


def make_dot16(chunk: int, mode: str, bits: int = 0, **align):
    """A dot16 (ops/fast_tile.py's signature) under one sum model."""
    def dot16(a, x, b, y):
        acc = torch.zeros((16,) + tuple(x.shape[1:]), dtype=torch.float64,
                          device=x.device)
        for m, v in ((a, x), (b, y)):
            for k0 in range(0, 16, chunk):
                terms = [acc] + [m[:, t:t + 1] * v[t]
                                 for t in range(k0, k0 + chunk)]
                s = _align(terms, bits, **align) if bits else sum(terms)
                acc = _round(s, mode)
        return acc.float()
    return dot16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[256, 1024, 4096])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", nargs="*", default=[], metavar="NxC",
                    help="shapes of chip_smoke.py's fast cases to hold "
                         "under each model")
    ap.add_argument("--models", nargs="*", default=None,
                    help="the models to try (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("fast_sum_order: no CUDA device visible")
    from xlab_fftbarotropic_torch.ops import fast_tile as fst
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    dev = torch.device("cuda", torch.cuda.current_device())
    own = fst.dot16
    models = {"exact": own, "mma-rn": make_dot16(16, "rn"),
              "mma-rz": make_dot16(16, "rz"), "k8-rn": make_dot16(8, "rn"),
              "k8-rz": make_dot16(8, "rz"),
              **{f"align-{b}-rz": make_dot16(16, "rz", b)
                 for b in (23, 24, 25, 26)}}
    for b in (24, 25, 26):
        models.update({
            f"align-{b}-floor": make_dot16(16, "rz", b, cut=torch.floor),
            f"align-{b}-floor-rd": make_dot16(16, "rd", b, cut=torch.floor),
            f"align-{b}-k8": make_dot16(8, "rz", b),
            f"align-{b}-acc": make_dot16(16, "rz", b, keep_first=True),
            f"align-{b}-prod": make_dot16(16, "rz", b, by_products=True),
            f"align-{b}-rn": make_dot16(16, "rn", b)})
    if args.models:
        models = {k: models[k] for k in args.models}
    rng = np.random.default_rng(args.seed)
    for n in args.n:
        cols = n // 2 + 1 if n <= 1024 else 257
        fr, fi = (torch.from_numpy(rng.standard_normal(
            (1, n, cols)).astype(np.float32)).to(dev) for _ in range(2))
        got = fs.kx_fwd(fr, fi, fast=True)
        torch.cuda.synchronize()
        for name, dot in models.items():
            fst.dot16 = dot
            want = fst.fast_dft(fr, fi, -1, dim=-2)
            same = sum(int(torch.equal(g, w)) for g, w in zip(got, want))
            eq = float(torch.cat([(g == w).flatten() for g, w in
                                  zip(got, want)]).float().mean())
            num = sum(float(torch.linalg.vector_norm((g - w).double()) ** 2)
                      for g, w in zip(got, want))
            den = sum(float(torch.linalg.vector_norm(w.double()) ** 2)
                      for w in want)
            print(f"n {n:5d} x {cols:4d} columns, model {name:12s}: "
                  f"{100 * eq:8.4f} % of values equal (planes equal: "
                  f"{same} of 2), rel-L2 {(num / den) ** 0.5:.3e}",
                  flush=True)
        fst.dot16 = own
    if args.cases:
        import chip_smoke as cs
    for shape in args.cases:
        n, cols = (int(v) for v in shape.split("x"))
        cases = {**cs.fast_cases(n, cols, dev, n),
                 **cs.fast_arm_cases(n, cols, dev, n)}
        got = {k: c.fields(c.kern()) for k, c in cases.items()}
        torch.cuda.synchronize()
        for name, dot in models.items():
            fst.dot16 = dot
            for k, c in cases.items():
                want = c.fields(c.plain())
                rel = max(float(torch.linalg.vector_norm((g - w).double())
                                / torch.linalg.vector_norm(w.double()))
                          for g, w in zip(got[k], want))
                eq = float(torch.cat([(g == w).flatten() for g, w in
                                      zip(got[k], want)]).float().mean())
                print(f"{n} x {cols} {k:20s} model {name:12s}: "
                      f"{100 * eq:8.4f} % equal, rel-L2 {rel:.3e}",
                      flush=True)
        fst.dot16 = own
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
