"""Nonlinear-balance pressure inversion: the counterpart of
xlab_fftbarotropic_tpu/diagnostics/invert_pres.py.

Equivalent of invert_pres.out (the reference's src/invert_pres.cpp:
132-187): from a streamfunction field psi, solve

    lap(p) = rho * ( f * lap(psi) + 2 * (psi_xx * psi_yy - psi_xy^2) )

spectrally, with the circular dealias mask on the three second
derivatives (invert_pres.cpp:148-150), the mean mode passed through the
inverse Laplacian, the forward transforms unnormalized and the inverses
scaled by 1/(nx ny); then anchored by subtracting the value at flat index
ref_x + nx * ref_y (invert_pres.cpp:182-185), the reference's own formula,
inconsistent with its IDX(i, j) = ny i + j (SURVEY.md §5.8), kept for
parity.

The transforms are models/barotropic.resolve_fft_backend's triple for
cfg.fft_backend: under `auto`, on a square power-of-two grid from 64 to
8192, the per-transform kernels (ops/fused_fft.py: rfft2 = ka + kc,
irfft2 = ka + kb, inverse_pair = two ka + kb; their plain versions on a
CPU tensor), elsewhere torch.fft (ops/fft.py). psi_xx and psi_yy go
through one inverse_pair, so one inverted field takes two forward
transforms and three inverse ones: LAUNCHES_PER_FIELD on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelConfig
from ..models.barotropic import resolve_device, resolve_fft_backend
from ..ops import spectral as sp
from ..ops.spectral import SpectralTables

# kernel launches of one inverted field on the kernel path: two rfft2
# (ka + kc), one inverse_pair (2 ka + kb), two irfft2 (ka + kb)
LAUNCHES_PER_FIELD = {"ka": 6, "kb": 3, "kc": 2}


def invert_pressure(t: SpectralTables, psi: torch.Tensor, rho: float,
                    f: float, grid_shape, ref_x: int = 0, ref_y: int = 0,
                    transforms=None) -> torch.Tensor:
    """psi (nx, ny) float32 -> pressure anomaly (nx, ny) float32, on psi's
    device. `transforms`: the (forward, inverse, inverse_pair) triple,
    torch.fft's (ops/fft.py) when None."""
    if transforms is None:
        transforms = resolve_fft_backend("xla", grid_shape)
    forward, inverse, inverse_pair = transforms
    psi_hat = forward(psi)                           # invert_pres.cpp:135
    gx = sp.gradx(t, psi_hat)
    gy = sp.grady(t, psi_hat)
    psi_xx_hat = sp.gradx(t, gx)                     # invert_pres.cpp:139-140
    psi_yy_hat = sp.grady(t, gy)                     # invert_pres.cpp:142-143
    psi_xy_hat = sp.gradx(t, gy)                     # invert_pres.cpp:145
    psi_xx, psi_yy = inverse_pair(sp.dealias(t, psi_xx_hat),
                                  sp.dealias(t, psi_yy_hat), grid_shape)
    psi_xy = inverse(sp.dealias(t, psi_xy_hat), grid_shape)
    gaus_curv = psi_xx * psi_yy - psi_xy * psi_xy    # invert_pres.cpp:159
    lap_pres_hat = forward(gaus_curv)                # invert_pres.cpp:161
    lap_pres_hat = rho * (f * sp.laplacian(t, psi_hat)
                          + 2.0 * lap_pres_hat)      # invert_pres.cpp:164-169
    pres = inverse(sp.invert_laplacian(t, lap_pres_hat), grid_shape)
    # the reference's anchor: flat index ref_x + nx*ref_y
    flat = ref_x + grid_shape[0] * ref_y
    return pres - pres.reshape(-1)[flat]


class PressureInverter:
    """The inverter of one configuration on one device: the spectral
    tables built once there, the transform triple of cfg.fft_backend."""

    def __init__(self, cfg: ModelConfig, device, ref_x: int = 0,
                 ref_y: int = 0, tables: Optional[SpectralTables] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tables = (tables if tables is not None
                       else SpectralTables.from_config(cfg, self.device))
        self.transforms = resolve_fft_backend(cfg.fft_backend,
                                              cfg.grid_shape)
        self.ref_x, self.ref_y = ref_x, ref_y

    def __call__(self, psi) -> torch.Tensor:
        """psi (nx, ny), a numpy array or a tensor -> the pressure anomaly
        (nx, ny) float32 on the inverter's device."""
        psi = torch.as_tensor(psi, dtype=torch.float32, device=self.device)
        return invert_pressure(self.tables, psi.contiguous(),
                               float(self.cfg.rho), float(self.cfg.f),
                               self.cfg.grid_shape, self.ref_x, self.ref_y,
                               self.transforms)

    def batch(self, psis) -> torch.Tensor:
        """(B, nx, ny) -> (B, nx, ny): each field inverted on its own, so
        each gives its single call's result bit for bit (the JAX
        package's vmap; the kernels take one field per launch)."""
        psis = torch.as_tensor(psis, dtype=torch.float32, device=self.device)
        return torch.stack([self(p) for p in psis])
