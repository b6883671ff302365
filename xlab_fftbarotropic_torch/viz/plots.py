"""Visualization: the counterpart of xlab_fftbarotropic_tpu/viz/plots.py,
a numpy/matplotlib copy that reads through the port's io/fieldio.py.

The reference's plotting toolchain (test/01-runtest/plot/{draw_figs.py,
config.py, mycolormap.py}) as a library + CLI:
  * fields loaded little-endian float32, reshaped (nx, ny), TRANSPOSED so y
    is the image row axis (draw_figs.py:103-105);
  * filled contours of vorticity * 1000 with the custom gray colormap
    (mycolormap.py:6-12; levels config.py:22-25);
  * wind overlay: 'streamline' or 'barb' with the reference's 0.5144 kt
    conversion and skip stride (draw_figs.py:128-131);
  * HH:MM:SS stamp, x/y in km, one PNG per record step (draw_figs.py:133-139).
As in the JAX package, the coordinate axes use i*dx (periodic, no endpoint
duplication) instead of linspace(0, L, n) (SURVEY.md §5.1 quirk), and the
grid/time constants come from ModelConfig (SURVEY.md §5.10-5).

matplotlib is imported lazily, inside the drawing functions, so the rest
of the port never needs it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..config import ModelConfig
from ..io.fieldio import read_field

# default contour levels: config.py:22-25 (cb_max=2, 41 levels)
DEFAULT_LEVELS = np.linspace(-2.0, 2.0, 41)


def cmap_vorticity():
    """The custom gray colormap (mycolormap.py:6-12)."""
    from matplotlib.colors import LinearSegmentedColormap
    gray = [(0.0, 1.0, 1.0), (0.15, 0.5, 0.5), (1.0, 0.0, 0.0)]
    return LinearSegmentedColormap("vorticity",
                                   {"red": gray, "green": gray, "blue": gray})


def load_step(cfg: ModelConfig, in_dir, step: int, names=("vort", "u", "v")):
    """Load record-step fields, transposed to (y, x) for plotting
    (draw_figs.py:103-105)."""
    out = {}
    for name in names:
        path = Path(in_dir) / f"{name}_step_{step}.bin"
        out[name] = read_field(path, cfg.grid_shape).T
    return out


def draw_step(cfg: ModelConfig, in_dir, step: int, out_path,
              wind: str = "streamline", barb_skip: int = 15,
              levels: Optional[Sequence[float]] = None, dpi: int = 100):
    """Render one record step to a PNG (draw_figs.py:95-141)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    f = load_step(cfg, in_dir, step)
    x, y = cfg.coords()
    x_km, y_km = x / 1000.0, y / 1000.0
    lv = DEFAULT_LEVELS if levels is None else levels

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_axes([0.1, 0.1, 0.7, 0.8], autoscale_on=False)
    ax.set_xlim([x_km[0], x_km[-1]])
    ax.set_ylim([y_km[0], y_km[-1]])
    ax.set_xlabel(r"x [$\mathrm{km}$]")
    ax.set_ylabel(r"y [$\mathrm{km}$]")
    ax.set_aspect(1)
    cax = fig.add_axes([0.85, 0.1, 0.05, 0.8])

    m = ax.contourf(x_km, y_km, f["vort"] * 1000.0, lv,
                    cmap=cmap_vorticity(), extend="both")
    fig.colorbar(m, cax=cax, orientation="vertical")
    if wind == "streamline":
        ax.streamplot(x_km, y_km, f["u"], f["v"], linewidth=2)
    elif wind == "barb":
        s = barb_skip
        ax.barbs(x_km[::s], y_km[::s],
                 f["u"][::s, ::s] * 0.5144, f["v"][::s, ::s] * 0.5144,
                 length=8)
    elif wind != "none":
        raise ValueError(f"unknown wind overlay {wind!r}")

    t = step * cfg.dt
    ax.text(1.1, 0.5, r"$\zeta$ [$\times\,10^{-3}\,\mathrm{s}^{-1}$]",
            rotation=90, ha="left", va="center",
            transform=ax.transAxes, fontsize=20)
    ax.text(0.03, 0.03,
            "%02d:%02d:%02d" % (int(t / 3600), int(t / 60) % 60, int(t) % 60),
            transform=ax.transAxes)

    fig.savefig(out_path, dpi=dpi, format="png")
    plt.close(fig)
    return out_path


def draw_spectrum(txt_path, out_path, dpi: int = 100):
    """Log-log E(k)/Z(k) figure from a `xfb-torch-diagnose -d spectrum`
    text file (k [1/m], E(k), Z(k) columns), with a k^-3 guide slope (the
    2-D enstrophy-cascade prediction) anchored at the energy peak."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.loadtxt(txt_path)
    k, e, z = data[1:, 0], data[1:, 1], data[1:, 2]   # skip the mean mode
    fig, ax = plt.subplots(figsize=(6, 4.5))
    ax.loglog(k, np.maximum(e, 1e-300), label="E(k)")
    ax.loglog(k, np.maximum(z, 1e-300), label="Z(k)", ls="--")
    if e.max() > 0:
        i0 = int(np.argmax(e))
        if k[i0] > 0:
            guide = e[i0] * (k / k[i0]) ** -3.0
            ax.loglog(k, guide, color="0.6", lw=0.8, label=r"$k^{-3}$")
    ax.set_xlabel("k [1/m]")
    ax.set_ylabel("shell-integrated density")
    ax.legend(frameon=False)
    ax.set_title(Path(txt_path).name)
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)
    return Path(out_path)


def draw_spectra(in_dir, out_dir, dpi: int = 100, progress: bool = False):
    """Render every spectrum_step_*.txt in in_dir to PNG."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    made = []
    for txt in sorted(Path(in_dir).glob("spectrum_step_*.txt"),
                      key=lambda p: int(p.stem.rsplit("_", 1)[-1])):
        p = draw_spectrum(txt, out / (txt.stem + ".png"), dpi=dpi)
        made.append(p)
        if progress:
            print(f"Output image: {p}")
    return made


def draw_run(cfg: ModelConfig, in_dir, out_dir,
             start_step: int = 0, wind: str = "streamline",
             dpi: int = 100, progress: bool = False):
    """Render every available record step (draw_figs.py main loop)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    made = []
    first = (start_step // cfg.record_step) * cfg.record_step
    for step in range(first, cfg.total_steps, cfg.record_step):
        if not (Path(in_dir) / f"vort_step_{step}.bin").exists():
            continue
        p = draw_step(cfg, in_dir, step, out / f"step_{step}.png",
                      wind=wind, dpi=dpi)
        made.append(p)
        if progress:
            print(f"Output image: {p}")
    return made
