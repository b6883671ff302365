"""Spectral operator library: the counterpart of
xlab_fftbarotropic_tpu/ops/spectral.py.

The coefficient tables are float32 buffers of an nn.Module built from the
same float64 numpy functions as the JAX package (copied here: that module
imports jax), so the tables are bit-identical to its SpectralTables. The
operators are plain functions of (tables, complex64 half-spectrum).

Reference contract (SURVEY.md §5.3-5.6): positive-Nyquist kx, half-axis
ky, lap = -(kx^2 + ky^2), inv_lap with the mean mode passed through
(entry (0, 0) = 1), rlap = 1/inv_lap for the multiply-form inversion of
the fused kernels, and the circular dealias mask of the reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn


def wavenumbers_x(nx: int, lx: float) -> np.ndarray:
    """Full-axis x wavenumbers with positive Nyquist (fftwfop.cpp:14-19)."""
    k = np.empty(nx, dtype=np.float64)
    half = nx // 2 + 1
    k[:half] = 2.0 * np.pi * np.arange(half) / lx
    for i in range(half, nx):
        k[i] = -k[nx - i]
    return k.astype(np.float32)


def wavenumbers_y(ny: int, ly: float) -> np.ndarray:
    """Half-axis y wavenumbers, all positive (fftwfop.cpp:22-24)."""
    half = ny // 2 + 1
    return (2.0 * np.pi * np.arange(half) / ly).astype(np.float32)


def dealias_mask(nx: int, ny: int, rule: str = "circular") -> np.ndarray:
    """Dealiasing mask over the half-spectrum (fftwfop.cpp:56-68):
    'circular' kills i'^2 + j^2 >= ceil(nx/3)^2 + ceil(ny/3)^2 with i'
    the reflected x index; 'twothirds' is the tensor-product rule."""
    kcx = int(np.ceil(nx / 3.0))
    kcy = int(np.ceil(ny / 3.0))
    half_ny = ny // 2 + 1
    i = np.arange(nx)
    i_refl = np.minimum(i, nx - i)
    j = np.arange(half_ny)
    ii = i_refl[:, None].astype(np.float64)
    jj = j[None, :].astype(np.float64)
    if rule == "circular":
        kill = (ii**2 + jj**2) >= (float(kcx) ** 2 + float(kcy) ** 2)
    elif rule == "twothirds":
        kill = (ii >= kcx) | (jj >= kcy)
    else:
        raise ValueError(f"unknown dealias rule: {rule!r}")
    return np.where(kill, 0.0, 1.0).astype(np.float32)


def build_numpy(nx: int, ny: int, lx: float, ly: float,
                rule: str = "circular") -> dict:
    """The six float32 tables as numpy arrays (ops/spectral.py:99-118)."""
    kx = wavenumbers_x(nx, lx)
    ky = wavenumbers_y(ny, ly)
    lap = -(kx[:, None].astype(np.float64) ** 2
            + ky[None, :].astype(np.float64) ** 2)
    lap = lap.astype(np.float32)
    inv = lap.copy()
    inv[0, 0] = 1.0
    rlap = (1.0 / inv).astype(np.float32)
    return dict(kx=kx, ky=ky, lap=lap, inv_lap=inv,
                mask=dealias_mask(nx, ny, rule), rlap=rlap)


class SpectralTables(nn.Module):
    """Coefficient tables as float32 buffers: kx (nx,), ky (hny,) and
    lap, inv_lap, mask, rlap (nx, hny)."""

    NAMES = ("kx", "ky", "lap", "inv_lap", "mask", "rlap")

    def __init__(self, tables: dict, device):
        """`tables` maps each name to a numpy array or a tensor; tensors
        already float32 on `device` are shared, not copied."""
        super().__init__()
        for name in self.NAMES:
            t = tables[name]
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.array(t, dtype=np.float32))
            t = t.to(device=device, dtype=torch.float32)
            self.register_buffer(name, t.contiguous())

    @classmethod
    def build(cls, nx: int, ny: int, lx: float, ly: float,
              rule: str = "circular", *, device) -> "SpectralTables":
        return cls(build_numpy(nx, ny, lx, ly, rule), device)

    @classmethod
    def from_config(cls, cfg, device) -> "SpectralTables":
        return cls.build(cfg.nx, cfg.ny, cfg.lx, cfg.ly, cfg.dealias_rule,
                         device=device)

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name in self.NAMES}


# ---- operators: pointwise functions on the complex64 half-spectrum ----

def _i_times(k: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.zeros_like(k), k)


def gradx(t: SpectralTables, a: torch.Tensor) -> torch.Tensor:
    """d/dx: multiply by i*k_x (fftwfop.cpp:87-94). kx may carry leading
    axes (a shard axis), which broadcast against a's."""
    return a * _i_times(t.kx)[..., :, None]


def grady(t: SpectralTables, a: torch.Tensor) -> torch.Tensor:
    """d/dy: multiply by i*k_y (fftwfop.cpp:96-103); ky may carry leading
    axes, as kx in gradx."""
    return a * _i_times(t.ky)[..., None, :]


def laplacian(t: SpectralTables, a: torch.Tensor) -> torch.Tensor:
    """nabla^2: multiply by -(k^2) (fftwfop.cpp:105-110)."""
    return a * t.lap


def invert_laplacian(t: SpectralTables, a: torch.Tensor) -> torch.Tensor:
    """nabla^{-2}: divide by -(k^2); the mean mode passes through
    (inv_lap[0, 0] == 1, fftwfop.cpp:43,112-117)."""
    return a / t.inv_lap


def dealias(t: SpectralTables, a: torch.Tensor) -> torch.Tensor:
    """Apply the dealias mask (fftwfop.cpp:119-124)."""
    return a * t.mask


def velocities(t: SpectralTables, psi_hat: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u = -dpsi/dy, v = +dpsi/dx in spectral space (main.cpp:198-214)."""
    return -grady(t, psi_hat), gradx(t, psi_hat)
