"""`xfb-torch-invert-pres` — the batch pressure inversion of the PyTorch /
CUDA port, the counterpart of xlab_fftbarotropic_tpu.cli.invert_pres.

    grep psi_step log | sed 's/psi/pres/' | paste -d'@' \
        <(grep psi_step log) - | sed 's/@/=>/' \
        | python -m xlab_fftbarotropic_torch.cli.invert_pres --nx 256 \
            --ny 256 [--device cuda|cpu]

Drop-in for invert_pres.out (the reference's src/invert_pres.cpp:
114-188): reads "psi_in=>pres_out" lines from stdin, inverts the nonlinear
balance equation for each (diagnostics/invert_pres.py) and writes the raw
float32 pressure field. -x/-y select the anchor grid point
(invert_pres.cpp:71-80). `--device cuda` (the default) runs the
per-transform CUDA kernels ka, kb and kc on the square power-of-two grids
they take (elsewhere torch.fft on the card) and stops with an error when
no GPU is visible; `--device cpu` runs the kernels' plain torch versions.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    import torch

    from ..config import add_config_args, config_from_args
    from ..diagnostics.invert_pres import PressureInverter
    from ..io.fieldio import read_field, write_field

    p = argparse.ArgumentParser(prog="xfb-torch-invert-pres")
    p.add_argument("-x", dest="ref_x", type=int, default=0)
    p.add_argument("-y", dest="ref_y", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the hand-written CUDA kernels, "
                        "error if no GPU is visible; cpu: their plain "
                        "torch versions")
    add_config_args(p)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device is visible; pass --device "
                "cpu to run the kernels' plain torch versions on the CPU")
    cfg = config_from_args(args)

    inverter = PressureInverter(cfg, args.device, ref_x=args.ref_x,
                                ref_y=args.ref_y)
    for raw in sys.stdin:
        line = raw.strip()
        if not line:
            continue
        if "=>" not in line:
            # the reference prints and continues (invert_pres.cpp:127-129)
            print(f"Error reading input: {line}. Continue next line...",
                  file=sys.stderr)
            continue
        from_file, to_file = (s.strip() for s in line.split("=>", 1))
        psi = read_field(from_file, cfg.grid_shape)
        write_field(to_file, inverter(psi).cpu().numpy())
    print("Program ends. Congrats!", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
