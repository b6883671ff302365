"""x-pencil spectral layout on row-sharded physical fields: the
counterpart of xlab_fftbarotropic_tpu/parallel/xpencil.py:53-151.

The spectral state stays column-sharded, (P, nx, hpad/P): shard t holds
half-axis columns [t w, (t+1) w) of every row, w = hpad/P, hpad the
smallest multiple of P >= ny//2+1. Physical fields stay row shards
(P, nx/P, ny), as in the slab (parallel/dfft.py). Every spectral operator
is pointwise, so it runs on column-sharded tables (shard_tables: kx whole,
ky and the 2-D tables column-sharded, the pad as pencil.pad_tables makes
it), and each transform needs one transpose instead of the slab's two:

    forward:  rfft(y) -> rows -> columns -> fft(x)         (x-pencil)
    inverse:  ifft(x) -> columns -> rows -> irfft(y)

Three impls of the transpose and x-stage, as the JAX package's:
'xla' the library transposes (dfft.transpose_to_*), 'pallas' the a2a
kernels (fused_transpose.a2a_*), both with torch.fft along x; 'overlap'
the x-stage halves xstage_gather / xstage_scatter (fused_overlap). The
pad is the same for the three (the JAX overlap impl's 128-lane chunk
plan is a TPU tiling rule, not carried over).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.spectral import SpectralTables
from . import dfft
from .pencil import pad_spectral, pad_tables, padded_half, strip_spectral

IMPLS = ("xla", "pallas", "overlap")


def hpad_for(hny: int, n_shards: int) -> int:
    """The padded half-axis width of the x-pencil state, for every impl."""
    return padded_half(hny, n_shards)


def shard_state(z: torch.Tensor, n_shards: int) -> torch.Tensor:
    """A global (nx, hny) or (nx, hpad) half-spectrum -> (P, nx, hpad/P)
    x-pencil shards (padded with zeros)."""
    nx, h = z.shape
    hpad = hpad_for(h, n_shards)
    z = pad_spectral(z, hpad)
    return z.reshape(nx, n_shards, hpad // n_shards).permute(
        1, 0, 2).contiguous()


def unshard_state(z: torch.Tensor, hny: int) -> torch.Tensor:
    """(P, nx, w) x-pencil shards -> the global (nx, hny), pad stripped."""
    p, nx, w = z.shape
    return strip_spectral(z.permute(1, 0, 2).reshape(nx, p * w), hny)


def shard_tables(t: SpectralTables, n_shards: int) -> SpectralTables:
    """Global tables -> the x-pencil's: kx (nx,) whole, ky (P, w) and the
    2-D tables (P, nx, w), padded to hpad."""
    hpad = hpad_for(t.lap.shape[-1], n_shards)
    tp = pad_tables(t, hpad)
    w = hpad // n_shards
    out = {"kx": tp.kx, "ky": tp.ky.reshape(n_shards, w)}
    for name in ("lap", "inv_lap", "mask", "rlap"):
        out[name] = shard_state(getattr(tp, name), n_shards)
    return SpectralTables(out, t.lap.device)


def rfft2_local(field: torch.Tensor, fft_impl: str) -> torch.Tensor:
    """Row shards (P, nx/P, ny) float32 -> x-pencil (P, nx, hpad/P)
    complex64, unnormalized."""
    spec = torch.fft.rfft(field, dim=-1)
    if fft_impl == "overlap":
        from . import fused_overlap as fo
        return fo.xstage_gather(spec, forward=True)
    to_cols, _ = dfft._transposes(fft_impl == "pallas")
    return torch.fft.fft(to_cols(spec), dim=1)


def irfft2_local(spec_cols: torch.Tensor,
                 grid_shape: Optional[Tuple[int, int]], hny: int,
                 fft_impl: str) -> torch.Tensor:
    """x-pencil (P, nx, hpad/P) complex64 -> row shards (P, nx/P, ny)
    float32, scaled by 1/(nx*ny)."""
    nx = spec_cols.shape[1]
    ny = grid_shape[1] if grid_shape is not None else 2 * (hny - 1)
    if fft_impl == "overlap":
        from . import fused_overlap as fo
        rows = fo.xstage_scatter(spec_cols, hny, forward=False,
                                 scale=1.0 / nx)
    else:
        _, to_rows = dfft._transposes(fft_impl == "pallas")
        rows = to_rows(torch.fft.ifft(spec_cols, dim=1), hny)
    return dfft.irfft_rows(rows, ny)


def make_fft_pair(hny: int, fft_impl: str = "xla"):
    """(forward, inverse) with the ops/fft.py signatures for the x-pencil
    layout."""
    if fft_impl not in IMPLS:
        raise ValueError(f"unknown fft_impl: {fft_impl!r}")

    def fwd(field):
        return rfft2_local(field, fft_impl)

    def inv(spec, grid_shape=None):
        return irfft2_local(spec, grid_shape, hny, fft_impl)

    return fwd, inv
