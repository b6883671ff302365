#!/usr/bin/env python3
"""The ensemble's chunk-width sweep on one CUDA card: the measurement
behind models/ensemble.py:auto_vmap_width.

    python3 scripts/ensemble_sweep.py [--sizes 256 512 1024 2048]
        [--members 8 32] [--steps 10] [--rounds 3] [--json PATH]

At each n^2 (the gaussian IC, the default configuration): the solo rate
of BarotropicModel under `auto` (the plane stepper's kernels), then for
each ensemble size M the EnsembleModel at chunk widths 1 (member by
member on the kernels), 8 and M (one batched state per chunk on
torch.fft), amplitude 0.02. Each timing is a segment of --steps steps
(one warm-up segment first), CUDA events around each of --rounds
segments, the median kept; the grid-points per second of all members
together (aggregate gp/s) beside the solo rate. The last lines: for each
n the best width per M, the threshold the sweep gives auto_vmap_width
(FULL_WIDTH_MAX_N: the largest n at which width M is best for every M
and at every smaller n), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def segment_ms(run, steps: int, rounds: int) -> float:
    """Median ms per step of run() (one segment of `steps` steps)."""
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / steps)
    return statistics.median(times)


def full_width_max_n(best: dict, sizes, members) -> int:
    """auto_vmap_width's threshold from the best width per (n, M): the
    largest n up to which width M is best for every M at every measured
    size (0: none)."""
    full = 0
    for n in sorted(sizes):
        if any(best[(n, m)] != m for m in members):
            break
        full = n
    return full


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[256, 512, 1024, 2048])
    ap.add_argument("--members", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ensemble_sweep: no CUDA device visible")
    sys.path.insert(0, str(HERE))
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.models.ensemble import EnsembleModel
    from xlab_fftbarotropic_torch.ops import _build

    _build.lib()
    dev = torch.device("cuda", torch.cuda.current_device())
    rows, best = [], {}
    for n in args.sizes:
        cfg = ModelConfig(nx=n, ny=n)
        v0 = makefields.gaussian(cfg)
        solo = BarotropicModel.build(cfg, dev)
        z0, src = solo.init_state(v0), solo.zero_source()
        ms = segment_ms(lambda: solo.segment(z0, src, args.steps),
                        args.steps, args.rounds)
        solo_gps = n * n / ms * 1e3
        print(f"n={n} solo ({solo.backend}): {ms:.4f} ms/step, "
              f"{solo_gps:.4e} gp/s", flush=True)
        del solo, z0
        for m in args.members:
            rates = {}
            for w in sorted({1, min(8, m), m}):
                e = EnsembleModel.build(cfg, dev, m, vmap_width=w)
                s0 = e.init_from_physical(v0, amplitude=0.02, seed=0)
                ms = segment_ms(lambda: e.segment(s0, src, args.steps),
                                args.steps, args.rounds)
                gps = m * n * n / ms * 1e3
                rates[w] = gps
                rows.append(dict(n=n, members=m, width=w,
                                 backend=e.inner.backend,
                                 batched=e.batched, ms_per_step=ms,
                                 aggregate_gps=gps, solo_gps=solo_gps,
                                 vs_solo=gps / solo_gps,
                                 peak_gib=torch.cuda.max_memory_allocated(
                                     dev) / 2 ** 30))
                print(f"n={n} M={m} width={w} ({e.inner.backend}, "
                      f"{'batched' if e.batched else 'member by member'}): "
                      f"{ms:.4f} ms per ensemble step, {gps:.4e} gp/s, "
                      f"{gps / solo_gps:.3f}x solo, peak "
                      f"{rows[-1]['peak_gib']:.2f} GiB", flush=True)
                del e, s0
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            best[(n, m)] = max(rates, key=rates.get)
        print(f"n={n} best width: "
              f"{ {m: best[(n, m)] for m in args.members} }", flush=True)
    thr = {"FULL_WIDTH_MAX_N": full_width_max_n(best, args.sizes,
                                                args.members)}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(dict(rows=rows,
                                                   thresholds=thr),
                                              indent=1))
    print(json.dumps({"thresholds": thr}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
