"""`xfb-torch-draw` — record-step PNGs from a run's output directory, the
counterpart of xlab_fftbarotropic_tpu.cli.draw:

    python -m xlab_fftbarotropic_torch.cli.draw -O output \\
        --fig-dir output_fig --nx 768 --ny 768 --wind streamline \\
        --start-step 0

Replaces the reference's test/01-runtest/draw.sh + plot/draw_figs.py
pair (viz/plots.py). `--spectra` draws the spectrum_step_N.txt files of
`xfb-torch-diagnose -d spectrum` instead. Drawing is numpy and
matplotlib on the host, with no device; without matplotlib the command
stops with an error.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys


def main(argv=None):
    from ..config import add_config_args, config_from_args
    from ..viz.plots import draw_run, draw_spectra

    ap = argparse.ArgumentParser(prog="xfb-torch-draw")
    add_config_args(ap)
    ap.add_argument("--fig-dir", default="output_fig")
    ap.add_argument("--wind", choices=["streamline", "barb", "none"],
                    default="streamline")
    ap.add_argument("--start-step", type=int, default=0)
    ap.add_argument("--dpi", type=int, default=100)
    ap.add_argument("--spectra", action="store_true",
                    help="render spectrum_step_*.txt (xfb-torch-diagnose "
                         "-d spectrum output) as log-log E(k)/Z(k) PNGs "
                         "instead of field figures")
    args = ap.parse_args(argv)
    if importlib.util.find_spec("matplotlib") is None:
        ap.error("drawing needs matplotlib, which is not installed")
    cfg = config_from_args(args)
    if args.spectra:
        made = draw_spectra(args.output_dir, args.fig_dir, dpi=args.dpi,
                            progress=True)
        if not made:
            raise SystemExit(
                f"no spectrum_step_*.txt found in {args.output_dir}")
        return 0
    made = draw_run(cfg, args.output_dir, args.fig_dir,
                    start_step=args.start_step, wind=args.wind,
                    dpi=args.dpi, progress=True)
    if not made:
        raise SystemExit(f"no record steps found in {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
