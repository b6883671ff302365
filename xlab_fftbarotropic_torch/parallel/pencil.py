"""Half-axis padding helpers of the column-sharded spectral layouts: the
counterparts of padded_half, pad_tables, pad_spectral and strip_spectral
in xlab_fftbarotropic_tpu/parallel/pencil.py:60-200.

A column-sharded half-spectrum pads its half axis ny//2+1 (odd) with
zero columns to a multiple of the shard count; the coefficient tables pad
alongside so that the pad columns stay exact zeros forever (the dealias
mask is zero there, hence every tendency vanishes on the pad). The 2-D
pencil decomposition itself is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.spectral import SpectralTables


def padded_half(hny: int, n_shards: int) -> int:
    """Smallest multiple of n_shards >= hny."""
    return -(-hny // n_shards) * n_shards


def pad_tables(t: SpectralTables, hpad: int) -> SpectralTables:
    """The tables with the half axis padded to hpad: ky, lap and mask with
    zeros, inv_lap and rlap with ones (a zero there would put 0/0 = NaN
    into invert_laplacian on the pad); kx unchanged."""
    extra = hpad - t.lap.shape[-1]
    if extra == 0:
        return t

    def pad(a, value):
        return F.pad(a, (0, extra), value=value)

    return SpectralTables(dict(kx=t.kx, ky=pad(t.ky, 0.0),
                               lap=pad(t.lap, 0.0),
                               inv_lap=pad(t.inv_lap, 1.0),
                               mask=pad(t.mask, 0.0),
                               rlap=pad(t.rlap, 1.0)), t.lap.device)


def pad_spectral(z: torch.Tensor, hpad: int) -> torch.Tensor:
    """(..., hny) -> (..., hpad) with zero pad columns."""
    hny = z.shape[-1]
    if hpad == hny:
        return z
    return torch.cat([z, z.new_zeros(z.shape[:-1] + (hpad - hny,))], dim=-1)


def strip_spectral(z: torch.Tensor, hny: int) -> torch.Tensor:
    """(..., hpad) -> (..., hny)."""
    return z[..., :hny]
