"""Distributed 2-D real FFT over row shards (slab decomposition): the
counterpart of xlab_fftbarotropic_tpu/parallel/dfft.py.

P shards of an (nx, ny) field sit on one card stacked on a leading axis:
physical (P, nx/P, ny) float32, half-spectrum (P, nx/P, ny//2+1)
complex64, shard s holding global rows [s nx/P, (s+1) nx/P). The 2-D
transform is

    local r2c along y -> transpose rows -> columns (P, nx, hpad/P)
    -> full-length c2c along x -> transpose back to rows,

with the half axis zero-padded to hpad, the smallest multiple of P >=
ny//2+1, between the two transposes (the pad never reaches the rows).
The inverse mirrors it. Normalization as ops/fft.py: forward
unnormalized, inverse scaled by 1/(nx*ny).

The transposes here are the library path (`fft_impl="xla"`): torch copies
of the stacked tensor, the counterpart of lax.all_to_all. With
use_pallas=True the pair runs the a2a kernels instead
(parallel/fused_transpose.py, TPU row 23); the x-stage DFT is
torch.fft.fft either way, as jnp.fft.fft is in the JAX package, so the
two give the same bits.

Before the y c2r the self-conjugate bins ky = 0 and ky = ny/2 of every
row get their imaginary parts zeroed (the positive-Nyquist convention
leaves content there, ops/fft.py): pocketfft drops it, cuFFT is not
bound to, so the projection is explicit and the CPU and the card get the
same input.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .pencil import padded_half


def shard_rows(a: torch.Tensor, n_shards: int, lead: int = 0
               ) -> torch.Tensor:
    """(nx, ...) -> (P, nx/P, ...): the row shards, a view; with `lead`
    leading axes kept, (L..., nx, ...) -> (L..., P, nx/P, ...) (a stack
    of tables that broadcasts against a sharded state)."""
    nx = a.shape[lead]
    if nx % n_shards:
        raise ValueError(f"{nx} rows do not split into {n_shards} shards")
    return a.reshape(a.shape[:lead] + (n_shards, nx // n_shards)
                     + a.shape[lead + 1:])


def unshard_rows(a: torch.Tensor) -> torch.Tensor:
    """(P, nx/P, ...) -> (nx, ...)."""
    return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])


def transpose_to_columns(spec_rows: torch.Tensor) -> torch.Tensor:
    """(P, nx/P, hny) row shards -> (P, nx, hpad/P) column shards, the
    half axis zero-padded: shard t holds columns [t w, (t+1) w) of every
    row, in global row order."""
    p, rows_l, hny = spec_rows.shape
    w = padded_half(hny, p) // p
    x = spec_rows
    if p * w != hny:
        x = torch.cat([x, x.new_zeros((p, rows_l, p * w - hny))], dim=-1)
    return x.reshape(p, rows_l, p, w).permute(2, 0, 1, 3).contiguous(
    ).reshape(p, p * rows_l, w)


def transpose_to_rows(spec_cols: torch.Tensor, hny: int) -> torch.Tensor:
    """(P, nx, hpad/P) column shards -> (P, nx/P, hny) row shards, the
    pad stripped."""
    p, nx, w = spec_cols.shape
    rows = spec_cols.reshape(p, p, nx // p, w).permute(1, 2, 0, 3)
    return rows.reshape(p, nx // p, p * w)[..., :hny].contiguous()


def _transposes(use_pallas: bool):
    """(to_columns, to_rows): the library copies or the a2a kernels,
    looked up at each call."""
    if use_pallas:
        from . import fused_transpose as ft
        return ft.a2a_cols, ft.a2a_rows
    return transpose_to_columns, transpose_to_rows


def irfft_rows(rows: torch.Tensor, ny: int) -> torch.Tensor:
    """The y c2r of row shards (P, nx/P, hny) -> (P, nx/P, ny), 1/ny, with
    the imaginary parts of bins 0 and ny/2 zeroed first, in place: `rows`
    is a temporary of the caller's."""
    rows[..., 0] = rows[..., 0].real
    if ny % 2 == 0:
        rows[..., ny // 2] = rows[..., ny // 2].real
    return torch.fft.irfft(rows, n=ny, dim=-1)


def rfft2_local(field: torch.Tensor, use_pallas: bool = False
                ) -> torch.Tensor:
    """Row shards (P, nx/P, ny) float32 -> (P, nx/P, ny//2+1) complex64,
    unnormalized: the distributed counterpart of ops/fft.py:forward."""
    to_cols, to_rows = _transposes(use_pallas)
    hny = field.shape[-1] // 2 + 1
    spec = torch.fft.rfft(field, dim=-1)
    return to_rows(torch.fft.fft(to_cols(spec), dim=1), hny)


def irfft2_local(spec: torch.Tensor,
                 grid_shape: Optional[Tuple[int, int]] = None,
                 use_pallas: bool = False) -> torch.Tensor:
    """(P, nx/P, hny) complex64 -> (P, nx/P, ny) float32, scaled by
    1/(nx*ny); grid_shape is the global (nx, ny), as ops/fft.py:inverse
    takes it (None: ny = 2 (hny - 1))."""
    to_cols, to_rows = _transposes(use_pallas)
    hny = spec.shape[-1]
    ny = grid_shape[1] if grid_shape is not None else 2 * (hny - 1)
    rows = to_rows(torch.fft.ifft(to_cols(spec), dim=1), hny)
    return irfft_rows(rows, ny)


def make_fft_pair(use_pallas: bool = False):
    """(forward, inverse) with the ops/fft.py signatures on row shards."""
    def fwd(field):
        return rfft2_local(field, use_pallas)

    def inv(spec, grid_shape=None):
        return irfft2_local(spec, grid_shape, use_pallas)

    return fwd, inv
