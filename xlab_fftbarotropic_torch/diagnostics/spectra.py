"""Isotropic energy / enstrophy spectra E(k), Z(k): the counterpart of
xlab_fftbarotropic_tpu/diagnostics/spectra.py.

The standard 2-D turbulence companion to the recorded vorticity (the
reference records only physical fields): the spectral densities summed
over integer isotropic wavenumber shells s = round(sqrt(i^2 + j^2))
(index space; the physical wavenumber of shell s is s * 2*pi/L on the
square domain).

The bookkeeping is exact-Parseval by construction:

    sum_s Z(s) = 0.5 * mean(zeta^2)          (enstrophy, StepStats parity)
    sum_s E(s) = 0.5 * mean(u^2 + v^2)       (energy,   StepStats parity)

with the unnormalized-forward state convention (SURVEY.md §5.2:
zeta_hat = rfft2(zeta), so mean(zeta^2) = sum_k w_k |zeta_hat_k|^2 / N^4
with half-spectrum multiplicity w = 2 except the self-represented j = 0
and j = ny/2 columns), |u_hat|^2 + |v_hat|^2 = |zeta_hat|^2 / k^2 (the
mean mode excluded: it carries no velocity), and enough shells to cover
the spectral corner so no mode is dropped.

Nyquist caveat (measured in the JAX package, tests/test_spectra.py): the
ENERGY identity holds exactly only for fields without Nyquist-row
content. The reference's positive-Nyquist gradient convention (SURVEY.md
§5.3, fftwfop.cpp:15-19) makes u_hat, v_hat non-Hermitian on the
self-reflected x-Nyquist row, and the c2r transform behind the
physical-space StepStats energy projects that sliver away, so for a
field with Nyquist content the spectral sum here is the faithful
quadratic-form total and exceeds the physical mean by
O(|zeta_hat(Nyq)|^2/k^2) (1.7e-4 relative on a 10-step Kuo2004 field at
64^2; 1e-7 once the Nyquist row and column are zeroed). Enstrophy is
unaffected (it never passes through the gradient convention).

The shell sums are torch.bincount over float64 densities, cast to
float32 once summed: on the card bincount adds with atomics in an order
that changes from run to run, and float64 sums keep that order out of
the float32 result.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.spectral import SpectralTables


class Spectrum(NamedTuple):
    k: torch.Tensor          # (nshells,) physical wavenumber of each shell
    energy: torch.Tensor     # (nshells,) E(s): sum = 0.5*mean(u^2+v^2)
    enstrophy: torch.Tensor  # (nshells,) Z(s): sum = 0.5*mean(zeta^2)


def shell_tables(cfg: ModelConfig) -> Tuple[np.ndarray, np.ndarray, int]:
    """(shell index, half-spectrum multiplicity, n_shells) as numpy
    constants, built once per configuration."""
    nx, ny = cfg.grid_shape
    hny = ny // 2 + 1
    ix = np.minimum(np.arange(nx), nx - np.arange(nx))[:, None]  # |i|
    jy = np.arange(hny)[None, :]
    shell = np.rint(np.hypot(ix, jy)).astype(np.int32)
    w = np.full((nx, hny), 2.0, np.float32)
    w[:, 0] = 1.0
    if ny % 2 == 0:
        w[:, hny - 1] = 1.0
    n_shells = int(shell.max()) + 1
    return np.broadcast_to(shell, (nx, hny)).copy(), w, n_shells


@functools.lru_cache(maxsize=4)
def _shells_on(cfg: ModelConfig, device: torch.device):
    """shell_tables on `device`: (flat int64 shell index, multiplicity,
    n_shells), built in numpy and copied to the device once per
    configuration and device, not once per field."""
    shell, w, n_shells = shell_tables(cfg)
    return (torch.from_numpy(shell.reshape(-1).astype(np.int64)).to(device),
            torch.from_numpy(w).to(device), n_shells)


def energy_enstrophy_spectrum(t: SpectralTables, zeta_hat: torch.Tensor,
                              cfg: ModelConfig) -> Spectrum:
    """E(k), Z(k) of the half-spectrum zeta_hat (nx, ny//2+1) complex64,
    on its device; the densities in float32 as in the JAX module, the
    shell sums in float64."""
    dev = zeta_hat.device
    flat, w, n_shells = _shells_on(cfg, dev)
    nx, ny = cfg.grid_shape
    norm = 1.0 / (float(nx) * ny) ** 2
    dens_z = 0.5 * norm * w * (zeta_hat.real ** 2 + zeta_hat.imag ** 2)
    # |u|^2+|v|^2 = |zeta_hat|^2 / k^2; rlap = 1/lap with the mean mode
    # passed through (SURVEY.md §5.4): masked out explicitly
    dens_e = dens_z * torch.abs(t.rlap)
    dens_e[0, 0] = 0.0

    def shells(dens):
        return torch.bincount(flat, weights=dens.reshape(-1).double(),
                              minlength=n_shells).float()

    k = torch.arange(n_shells, dtype=torch.float32,
                     device=dev) * np.float32(2.0 * np.pi / cfg.lx)
    return Spectrum(k=k, energy=shells(dens_e), enstrophy=shells(dens_z))
