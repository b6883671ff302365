#!/usr/bin/env python3
"""Time the sharded barotropic model's paths on one CUDA card: four
shards stacked on the card (parallel/model.py ShardedBarotropicModel,
make_mesh(4)), slab and x-pencil, each with the library transposes
(xla), the a2a transpose kernels (pallas, csrc/a2a.cu) and the fused
x-stage kernels (overlap, csrc/xstage.cu), and the 2-D pencil on a 2x2
mesh (pencil.make_pencil_mesh((2, 2)), xla only; where the checkout has
it), at n^2 from the gaussian IC.

    python3 scripts/shard_steps.py [--root DIR] [--n 4096] [--steps 20]
        [--rounds 2]

Per path: ms/step from CUDA events over a segment of --steps steps after
one such segment as warm-up (chip_smoke.py's cuda_ms), the paths in
turns (forward, then reverse order, --rounds times; the mean and every
run printed); then a torch.profiler
trace of 5 steps (chip_smoke.py's profile_run): the device ms per step
of each of the port's kernels (a2a_kernel, xstage_kernel), cuFFT and
the torch elementwise ops, and the device's busy share of the
synchronized wall time (profiler on). --root takes the port from
another checkout (an unpacked older commit) for a comparison in the
same run. Ends with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

PATHS = tuple(f"{d}-{i}" for d in ("slab", "xpencil")
              for i in ("xla", "pallas", "overlap")) + ("pencil-xla",)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("shard_steps: no CUDA device visible")
    # chip_smoke.py of this checkout (its profile_run), then the port of
    # --root
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    sys.path.insert(0, str(Path(args.root).resolve()))
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.ops import _build
    from xlab_fftbarotropic_torch.parallel import (ShardedBarotropicModel,
                                                   make_mesh)

    _build.lib()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = ModelConfig(nx=args.n, ny=args.n)
    mesh = make_mesh(4, dev)
    v0 = makefields.gaussian(cfg)
    try:
        from xlab_fftbarotropic_torch.parallel.pencil import make_pencil_mesh
    except ImportError:           # a checkout from before the pencil
        make_pencil_mesh = None
    runs = {}
    for name in PATHS:
        decomp, impl = name.split("-")
        if decomp == "pencil":
            if make_pencil_mesh is None:
                continue
            m = ShardedBarotropicModel.build(
                cfg, make_pencil_mesh((2, 2), dev), impl, decomp)
        else:
            m = ShardedBarotropicModel.build(cfg, mesh, impl, decomp)
        runs[name] = (m, m.init_state(v0), m.zero_source())
    times = {k: [] for k in runs}
    for _ in range(args.rounds):
        for k in list(runs) + list(reversed(list(runs))):
            m, s0, src = runs[k]
            times[k].append(chip_smoke.cuda_ms(
                lambda: m.segment(s0, src, args.steps), iters=1, warmup=1)
                / args.steps)
    for k, ts in times.items():
        print(f"{args.root} {args.n}^2 shard4-{k:16s} "
              f"{sum(ts) / len(ts):.3f} ms/step "
              f"({', '.join(f'{t:.3f}' for t in ts)})", flush=True)
    for k, (m, s0, src) in runs.items():
        m.segment(s0, src, 1)
        torch.cuda.synchronize()
        chip_smoke.profile_run(f"{args.root} shard4-{k}",
                               lambda: m.segment(s0, src, 5), 5)
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
