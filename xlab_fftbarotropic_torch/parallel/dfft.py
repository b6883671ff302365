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

On a distributed group (one shard per torch.distributed rank,
parallel/model.py ShardGroup with a rank) each rank holds the stacked
layout's shard of its rank with a leading axis of 1, and the transposes
are collectives: dist.all_to_all_single over the group (xla), or the a2a
kernels' ranked launches on the exchange buffers' pointer tables
(pallas, parallel/peer.py). fft_x transforms a rank's shard as rows of
a contiguous copy, the layout torch's FFT takes for two or more stacked
shards, so a rank's bits are its stacked shard's.

Before the y c2r the self-conjugate bins ky = 0 and ky = ny/2 of every
row get their imaginary parts zeroed (the positive-Nyquist convention
leaves content there, ops/fft.py): pocketfft drops it, cuFFT is not
bound to, so the projection is explicit and the CPU and the card get the
same input.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import multihost
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


def all_to_all_columns(spec_rows: torch.Tensor, group) -> torch.Tensor:
    """transpose_to_columns over a distributed group: the rank's row
    shard (1, nx/P, hny) -> its column shard (1, nx, hpad/P), one
    dist.all_to_all_single."""
    p = group.n_shards
    _, rows_l, hny = spec_rows.shape
    w = padded_half(hny, p) // p
    x = spec_rows[0]
    if p * w != hny:
        x = torch.cat([x, x.new_zeros((rows_l, p * w - hny))], dim=-1)
    got = multihost.all_to_all(x.reshape(rows_l, p, w).transpose(0, 1),
                               group.process_group)
    return got.reshape(1, p * rows_l, w)


def all_to_all_rows(spec_cols: torch.Tensor, hny: int,
                    group) -> torch.Tensor:
    """transpose_to_rows over a distributed group: the rank's column
    shard (1, nx, hpad/P) -> its row shard (1, nx/P, hny)."""
    p = group.n_shards
    _, nx, w = spec_cols.shape
    got = multihost.all_to_all(spec_cols.reshape(p, nx // p, w),
                               group.process_group)
    return got.transpose(0, 1).reshape(1, nx // p, p * w)[..., :hny
                                                          ].contiguous()


def _transposes(use_pallas: bool, group=None, exchange=None):
    """(to_columns, to_rows): the library copies or the a2a kernels,
    looked up at each call; on a distributed group (group.rank set) the
    collectives or the a2a kernels' ranked launches on `exchange`."""
    from . import fused_transpose as ft
    if group is not None and group.rank is not None:
        if use_pallas:
            return (lambda x: ft.a2a_cols_ranked(x, exchange),
                    lambda x, hny: ft.a2a_rows_ranked(x, hny, exchange))
        return (lambda x: all_to_all_columns(x, group),
                lambda x, hny: all_to_all_rows(x, hny, group))
    if use_pallas:
        return ft.a2a_cols, ft.a2a_rows
    return transpose_to_columns, transpose_to_rows


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on its cotangent contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def fft_x(x: torch.Tensor, inverse: bool = False,
          ranked: bool = False) -> torch.Tensor:
    """The unnormalized length-nx DFT along axis 1 of (P, nx, w) shards
    (inverse: ifft, scaled 1/nx). `ranked`: x is a rank's one shard on a
    distributed group, whose columns torch would transform in place with
    a stride; it is transformed as the contiguous rows of its transpose,
    as torch lays out two or more stacked shards, so the ranks give the
    stacked model's bits. A stacked group (one shard too) takes torch's
    own layout. Under autograd the backward transforms its cotangent
    made contiguous in the forward's layout, whatever layout it came in:
    so a rank's gradient has its stacked shard's bits too."""
    fn = torch.fft.ifft if inverse else torch.fft.fft
    if ranked:
        y = fn(x.transpose(1, 2).contiguous(), dim=-1)
    else:
        y = fn(x, dim=1)
    if y.requires_grad:
        y = _ContiguousGrad.apply(y)
    return y.transpose(1, 2) if ranked else y


def irfft_rows(rows: torch.Tensor, ny: int) -> torch.Tensor:
    """The y c2r of row shards (P, nx/P, hny) -> (P, nx/P, ny), 1/ny, with
    the imaginary parts of bins 0 and ny/2 zeroed first, in place: `rows`
    is a temporary of the caller's."""
    rows[..., 0] = rows[..., 0].real
    if ny % 2 == 0:
        rows[..., ny // 2] = rows[..., ny // 2].real
    return torch.fft.irfft(rows, n=ny, dim=-1)


def _ranked(group) -> bool:
    return group is not None and group.rank is not None


def rfft2_local(field: torch.Tensor, use_pallas: bool = False,
                group=None, exchange=None) -> torch.Tensor:
    """Row shards (P, nx/P, ny) float32 -> (P, nx/P, ny//2+1) complex64,
    unnormalized: the distributed counterpart of ops/fft.py:forward (on a
    distributed group, the rank's shard, P = 1 locally)."""
    to_cols, to_rows = _transposes(use_pallas, group, exchange)
    hny = field.shape[-1] // 2 + 1
    spec = torch.fft.rfft(field, dim=-1)
    return to_rows(fft_x(to_cols(spec), ranked=_ranked(group)), hny)


def irfft2_local(spec: torch.Tensor,
                 grid_shape: Optional[Tuple[int, int]] = None,
                 use_pallas: bool = False, group=None,
                 exchange=None) -> torch.Tensor:
    """(P, nx/P, hny) complex64 -> (P, nx/P, ny) float32, scaled by
    1/(nx*ny); grid_shape is the global (nx, ny), as ops/fft.py:inverse
    takes it (None: ny = 2 (hny - 1))."""
    to_cols, to_rows = _transposes(use_pallas, group, exchange)
    hny = spec.shape[-1]
    ny = grid_shape[1] if grid_shape is not None else 2 * (hny - 1)
    rows = to_rows(fft_x(to_cols(spec), True, _ranked(group)), hny)
    return irfft_rows(rows, ny)


def make_fft_pair(use_pallas: bool = False, group=None, exchange=None):
    """(forward, inverse) with the ops/fft.py signatures on row shards
    (on a distributed group and its exchange buffers, the rank's)."""
    def fwd(field):
        return rfft2_local(field, use_pallas, group, exchange)

    def inv(spec, grid_shape=None):
        return irfft2_local(spec, grid_shape, use_pallas, group, exchange)

    return fwd, inv
