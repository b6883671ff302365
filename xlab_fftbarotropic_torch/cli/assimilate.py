"""`xfb-torch-assimilate` — 4DVar initial-condition estimation (adjoint.py),
the PyTorch / CUDA port's counterpart of xlab_fftbarotropic_tpu.cli.
assimilate.

Given an observed final vorticity field and a first-guess initial
vorticity, recover the initial condition that reproduces the
observation after --steps RK4 steps, by Adam descent on the final-state
misfit with gradients through the checkpointed rollout:

    python -m xlab_fftbarotropic_torch.cli.assimilate --nx 4096 --ny 4096 \
        --steps 10 --target output/vort_step_10.bin \
        --guess input/initial_vorticity.bin \
        --out input/recovered_vorticity.bin --iters 80 --lr 1e-5

Writes the recovered field (the reference's raw float32 layout) and
`<out>.loss.txt`, the cost history. `--forcing F.bin` gives the constant
vorticity source of a forced run (default zero). `--device cuda` (the
default) runs the per-transform CUDA kernels in both sweeps (on the
square power-of-two grids they take; elsewhere torch.fft) and stops with
an error when no GPU is visible; `--device cpu` runs the kernels' plain
torch versions.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    import numpy as np
    import torch

    from ..config import add_config_args, config_from_args

    ap = argparse.ArgumentParser(prog="xfb-torch-assimilate")
    add_config_args(ap)
    ap.add_argument("--target", required=True,
                    help="observed final vorticity field (.bin)")
    ap.add_argument("--guess", required=True,
                    help="first-guess initial vorticity (.bin)")
    ap.add_argument("--out", required=True,
                    help="recovered initial vorticity output path")
    ap.add_argument("--steps", type=int, required=True,
                    help="rollout length between IC and observation")
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--lr", type=float, default=2e-6,
                    help="Adam learning rate, in vorticity units "
                         "(~1-10%% of the IC amplitude)")
    ap.add_argument("--forcing", default=None,
                    help="constant vorticity source field (.bin)")
    ap.add_argument("--segment", type=int, default=None,
                    help="checkpoint segment length (default ~sqrt(steps))")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default): the hand-written CUDA kernels, "
                         "error if no GPU is visible; cpu: their plain "
                         "torch versions")
    ap.add_argument("--fast-transforms", action="store_true",
                    help="not ported yet")
    args = ap.parse_args(argv)
    if args.fast_transforms:
        ap.error("--fast-transforms is not ported yet (ROADMAP.md queue A, "
                 "item 4); the port runs the strict float32 mode")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is visible; pass --device "
                 "cpu to run the kernels' plain torch versions on the CPU")
    cfg = config_from_args(args)

    from .. import adjoint
    from ..io.fieldio import read_field, write_field

    target = read_field(args.target, cfg.grid_shape)
    guess = read_field(args.guess, cfg.grid_shape)
    src = (read_field(args.forcing, cfg.grid_shape) if args.forcing
           else np.zeros(cfg.grid_shape, np.float32))

    ic, losses = adjoint.fit_initial_condition(
        cfg, target, args.steps, guess, src=src, iters=args.iters,
        learning_rate=args.lr, segment=args.segment, device=args.device)

    write_field(args.out, ic.cpu().numpy())
    np.savetxt(f"{args.out}.loss.txt", losses)
    print(f"misfit J: {losses[0]:.6e} -> {losses[-1]:.6e} "
          f"over {args.iters} iterations", file=sys.stderr)
    print(f"recovered IC -> {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
