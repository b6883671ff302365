"""`xfb-torch-diagnose` — batch diagnostics over recorded vorticity fields,
the counterpart of xlab_fftbarotropic_tpu.cli.diagnose.

    ls -v output | grep vort_step | awk '{print "output/" $1}' | \\
        python -m xlab_fftbarotropic_torch.cli.diagnose --nx 768 \\
            --ny 768 -d filamentation -O output [--device cuda|cpu]

The three README-advertised diagnostics the reference never implemented
(README.md:4-7; SURVEY.md §5.10-7), filamentation time, deformation
factor and effective eddy diffusivity, plus Okubo-Weiss and the E(k)/Z(k)
spectrum, computed from vort_step_*.bin files named on stdin, one output
per input and diagnostic: output/filamentation_step_N.bin (okuboweiss_,
deformation_, eddydiff_; raw float32, inf written as 0) or
spectrum_step_N.txt (k [1/m], E(k), Z(k)), and a summary line on stdout,
as the JAX command writes them. `--device cuda` (the default) runs the
transforms on the per-transform CUDA kernels ka, kb and kc on the square
power-of-two grids they take (elsewhere torch.fft on the card;
`--fft-backend xla` asks for torch.fft) and stops with an error when no
GPU is visible; `--device cpu` runs the kernels' plain torch versions.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

DIAGNOSTICS = ("filamentation", "okubo-weiss", "deformation",
               "eddy-diffusivity", "spectrum")
OUTNAME = {"filamentation": "filamentation", "okubo-weiss": "okuboweiss",
           "deformation": "deformation", "eddy-diffusivity": "eddydiff"}


def launches_per_field(diagnostics) -> dict:
    """Kernel launches of one field on the kernel path: its forward
    transform (ka + kc), then each diagnostic's."""
    from ..diagnostics import eddy_diffusivity as ed
    from ..diagnostics import kinematics as kin
    out = {"ka": 1, "kb": 0, "kc": 1}
    for d in diagnostics:
        per = {"spectrum": {}, "eddy-diffusivity": ed.LAUNCHES_PER_CALL
               }.get(d, kin.LAUNCHES_PER_CALL)
        for k, v in per.items():
            out[k] += v
    return out


class Diagnoser:
    """The diagnostics of one configuration on one device: the spectral
    tables built once there, the transform triple of cfg.fft_backend
    (models/barotropic.resolve_fft_backend)."""

    def __init__(self, cfg, device):
        from ..models.barotropic import resolve_device, resolve_fft_backend
        from ..ops.spectral import SpectralTables
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tables = SpectralTables.from_config(cfg, self.device)
        self.transforms = resolve_fft_backend(cfg.fft_backend,
                                              cfg.grid_shape)

    def __call__(self, vort, diagnostics) -> dict:
        """vort (nx, ny), numpy or a tensor -> {diagnostic: result} on the
        device: a (nx, ny) float32 field, the (nbins,) kappa_ratio
        profile for eddy-diffusivity, a Spectrum for spectrum."""
        import torch

        from ..diagnostics import eddy_diffusivity as ed
        from ..diagnostics import kinematics as kin
        from ..diagnostics.spectra import energy_enstrophy_spectrum
        cfg, t, tr = self.cfg, self.tables, self.transforms
        g = cfg.grid_shape
        vort = torch.as_tensor(vort, dtype=torch.float32,
                               device=self.device).contiguous()
        zeta_hat = tr[0](vort)
        fields = {
            "spectrum": lambda: energy_enstrophy_spectrum(t, zeta_hat, cfg),
            "filamentation": lambda: kin.filamentation_time(
                t, zeta_hat, g, transforms=tr),
            "okubo-weiss": lambda: kin.okubo_weiss(t, zeta_hat, g,
                                                   transforms=tr),
            "deformation": lambda: kin.deformation_factor(
                t, zeta_hat, g, transforms=tr),
            "eddy-diffusivity": lambda: ed.effective_diffusivity(
                t, vort, cfg.dx, cfg.dy, transforms=tr).kappa_ratio,
        }
        return {d: fields[d]() for d in diagnostics}


def main(argv=None):
    import torch

    from ..config import add_config_args, config_from_args
    from ..io.fieldio import read_field, write_field

    ap = argparse.ArgumentParser(prog="xfb-torch-diagnose")
    add_config_args(ap)
    ap.add_argument("-d", "--diagnostic", action="append", required=True,
                    choices=list(DIAGNOSTICS),
                    help="may be given multiple times; 'spectrum' writes "
                         "a 3-column text file (k [1/m], E(k), Z(k): "
                         "isotropic shell-summed energy/enstrophy, "
                         "diagnostics/spectra.py) instead of a .bin field")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default): the hand-written CUDA kernels, "
                         "error if no GPU is visible; cpu: their plain "
                         "torch versions")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is visible; pass --device "
                 "cpu to run the kernels' plain torch versions on the CPU")
    cfg = config_from_args(args)
    diagnose = Diagnoser(cfg, args.device)
    outdir = Path(cfg.output_dir)
    outdir.mkdir(parents=True, exist_ok=True)

    for raw in sys.stdin:
        path = raw.strip()
        if not path or path.startswith("#"):
            continue
        vort = read_field(path, cfg.grid_shape)
        step = Path(path).name.rsplit("_", 1)[-1].replace(".bin", "")
        results = diagnose(vort, args.diagnostic)
        for d in args.diagnostic:
            if d == "spectrum":
                sp_ = results[d]
                e = sp_.energy.cpu().numpy()
                out = outdir / f"spectrum_step_{step}.txt"
                np.savetxt(out, np.column_stack([sp_.k.cpu().numpy(), e,
                                                 sp_.enstrophy.cpu().numpy()]),
                           header="k[1/m] E(k) Z(k)")
                print(f"{d} {path} -> {out} summary={float(e.sum()):.6e}")
                continue
            field = results[d].cpu().numpy()
            if d == "filamentation":
                finite = field[np.isfinite(field)]
                summary = float(np.median(finite)) if finite.size else np.inf
            elif d == "okubo-weiss":
                summary = float(field.min())
            elif d == "deformation":
                summary = float(field.max())
            else:   # eddy-diffusivity: the per-level profile (nbins,)
                summary = float(np.nanmean(field))
            out = outdir / f"{OUTNAME[d]}_step_{step}.bin"
            write_field(out, np.where(np.isfinite(field), field,
                                      0.0).astype(np.float32))
            print(f"{d} {path} -> {out} summary={summary:.6e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
