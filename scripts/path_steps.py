#!/usr/bin/env python3
"""Time the single-card main paths of one or more checkouts of the port,
in turns, in one call: ms/step at n^2 of the barotropic, tracer and
shallow-water plane steppers' kernel paths (the barotropic one also in
its FUSEKB=half arm, each also under ETDRK4, the shallow-water one at
dt 7.5 s, and each in fast mode where the checkout has it), of the
barotropic (also QUAD_MODE quad) and shallow-water x-first order (RK4,
SW ETDRK4 too, and in fast mode where the checkout has it) and of the
barotropic and shallow-water torch.fft library paths (bench.py's
configurations, as chip_smoke.py's build_models makes them).

    python3 scripts/path_steps.py [--root DIR ...] [--n 4096]
        [--steps 20] [--rounds 2]

Each --root (default: this checkout; give an unpacked parent commit and
this checkout as, for example, --root P --root . --root . --root P) runs
in a process of its own, so each imports its own port; per path one
warm-up segment of --steps steps, then --rounds segments timed with CUDA
events, every run printed with its mean. Ends with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
PATHS = ("barotropic", "barotropic-half", "barotropic-fast",
         "barotropic-etdrk4", "barotropic-fast-etdrk4",
         "barotropic-library", "tracer", "tracer-fast", "tracer-etdrk4",
         "tracer-fast-etdrk4", "shallow-water", "shallow-water-fast",
         "shallow-water-etdrk4", "shallow-water-fast-etdrk4",
         "shallow-water-library", "barotropic-xfirst",
         "barotropic-xfirst-fast", "barotropic-quad", "barotropic-quad-fast",
         "shallow-water-xfirst", "shallow-water-xfirst-fast",
         "shallow-water-xfirst-etdrk4", "shallow-water-xfirst-fast-etdrk4")


def one_root(root: str, n: int, steps: int, rounds: int) -> dict:
    """ms/step of every path of the port under `root`."""
    import os

    import torch
    os.environ["XFB_ETD_CACHE"] = "0"       # the ETD tables built here
    sys.path.insert(0, str(Path(root).resolve()))
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel, max_stable_dt)
    from xlab_fftbarotropic_torch.models.tracer import TracerModel, tracer_ic
    from xlab_fftbarotropic_torch.ops import _build

    _build.lib()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = ModelConfig(nx=n, ny=n)
    lib = cfg.replace(fft_backend="xla")
    sw_dt = min(3.0, max_stable_dt(cfg))
    v0 = makefields.gaussian(cfg)
    bt = BarotropicModel.build(cfg, dev)
    zero = bt.zero_source()
    tr = TracerModel.build(cfg, dev, kappa=50.0)
    sw = ShallowWaterModel.build(cfg.replace(dt=sw_dt), dev)
    swl = ShallowWaterModel.build(lib.replace(dt=sw_dt), dev)
    sw0 = sw.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5))
    models = {
        "barotropic": (bt, bt.init_state(v0), zero),
        "barotropic-half": (BarotropicModel.build(cfg, dev, fusekb="half"),
                            bt.init_state(v0), zero),
        "barotropic-library": (BarotropicModel.build(lib, dev),
                               bt.init_state(v0), zero),
        "tracer": (tr, tr.init_state(v0, tracer_ic(cfg, "gaussian")), zero),
        "shallow-water": (sw, sw0, None),
        "shallow-water-library": (swl, sw0, None)}
    etd = cfg.replace(time_scheme="etdrk4", dt=7.5)
    models["shallow-water-etdrk4"] = (ShallowWaterModel.build(etd, dev),
                                      sw0, None)
    # bench.py's barotropic and tracer configurations under ETDRK4 (dt 3 s)
    bte = cfg.replace(time_scheme="etdrk4")
    tr0 = tr.init_state(v0, tracer_ic(cfg, "gaussian"))
    models["barotropic-etdrk4"] = (BarotropicModel.build(bte, dev),
                                   bt.init_state(v0), zero)
    models["tracer-etdrk4"] = (TracerModel.build(bte, dev, kappa=50.0),
                               tr0, zero)
    if "fast" in inspect.signature(BarotropicModel.build).parameters:
        models["barotropic-fast"] = (BarotropicModel.build(cfg, dev,
                                                           fast=True),
                                     bt.init_state(v0), zero)
    if "fast" in inspect.signature(TracerModel.build).parameters:
        models["barotropic-fast-etdrk4"] = (BarotropicModel.build(
            bte, dev, fast=True), bt.init_state(v0), zero)
        models["tracer-fast"] = (TracerModel.build(cfg, dev, kappa=50.0,
                                                   fast=True), tr0, zero)
        models["tracer-fast-etdrk4"] = (TracerModel.build(
            bte, dev, kappa=50.0, fast=True), tr0, zero)
    if "fast" in inspect.signature(ShallowWaterModel.build).parameters:
        models["shallow-water-fast"] = (ShallowWaterModel.build(
            cfg.replace(dt=sw_dt), dev, fast=True), sw0, None)
        models["shallow-water-fast-etdrk4"] = (ShallowWaterModel.build(
            etd, dev, fast=True), sw0, None)
    # the x-first order, strict and (where the checkout runs it) fast
    xfirst = {"barotropic-xfirst": (BarotropicModel, cfg,
                                    dict(yfirst=False), bt.init_state(v0),
                                    zero),
              "barotropic-quad": (BarotropicModel, cfg,
                                  dict(quad_mode="quad"), bt.init_state(v0),
                                  zero),
              "shallow-water-xfirst": (ShallowWaterModel,
                                       cfg.replace(dt=sw_dt),
                                       dict(yfirst=False), sw0, None),
              "shallow-water-xfirst-etdrk4": (ShallowWaterModel, etd,
                                              dict(yfirst=False), sw0,
                                              None)}
    for name, (cls, c, kw, s0, src) in xfirst.items():
        models[name] = (cls.build(c, dev, **kw), s0, src)
        fast = name.replace("-etdrk4", "") + "-fast" + (
            "-etdrk4" if name.endswith("etdrk4") else "")
        try:
            models[fast] = (cls.build(c, dev, fast=True, **kw), s0, src)
        except (TypeError, ValueError):     # not in this checkout
            pass
    out = {}
    for name in (p for p in PATHS if p in models):
        m, s0, src = models[name]
        m.segment(s0, src, steps)
        torch.cuda.synchronize()
        runs = []
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m.segment(s0, src, steps)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / steps)
        out[name] = runs
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=None)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one_root(args.one, args.n, args.steps,
                                  args.rounds)))
        return 0
    import torch
    if not torch.cuda.is_available():
        sys.exit("path_steps: no CUDA device visible")
    roots = args.root or [str(HERE)]
    results = []
    for root in roots:
        proc = subprocess.run(
            [sys.executable, __file__, "--one", str(Path(root).resolve()),
             "--n", str(args.n), "--steps", str(args.steps), "--rounds",
             str(args.rounds)],
            capture_output=True, text=True, check=True, cwd=HERE)
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"ran {root}", flush=True)
    for name in PATHS:
        cells = [f"{sum(r[name]) / len(r[name]):.3f} ("
                 + ", ".join(f"{v:.3f}" for v in r[name]) + ")"
                 if name in r else "not in this checkout" for r in results]
        print(f"{name:26s} ms/step at {args.n}^2: " + " | ".join(
            f"{root}: {c}" for root, c in zip(roots, cells)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
