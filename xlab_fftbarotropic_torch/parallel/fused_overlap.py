"""The distributed x-stage as one CUDA kernel (csrc/xstage.cu): the
counterpart of xlab_fftbarotropic_tpu/parallel/pallas_overlap.py (TPU
rows 21 and 22).

On the stacked shards (P, nx/P, hny) of parallel/dfft.py:

  xstage          row shards -> length-nx DFT along x -> row shards:
                  transpose_to_rows(fft(transpose_to_columns(.)));
  xstage_gather   row shards -> DFT -> x-pencil (P, nx, w), w = ceil(hny
                  / P), the pad columns zero: fft(transpose_to_columns(.));
  xstage_scatter  x-pencil -> DFT -> row shards, the pad dropped:
                  transpose_to_rows(fft(.)).

Each takes the sign (`forward`) and a `scale` of its output; the inverse
is unnormalized before it. Beside each wrapper is its plain version, the
composition above of the plain transposes (parallel/fused_transpose.py)
and torch.fft; a CPU tensor takes it, a CUDA tensor launches the kernel
(nx a power of two from 64 to 8192, the column-tile plan of ops/xtile.py)
or raises. `fast` (the JAX package's fast mode, whose overlap x-stages
run their DFT as bf16 matmuls) launches the kernel's fast form,
xfb_xstage_fast, counted as xstage_fast, xstage_gather_fast and
xstage_scatter_fast; its plain versions take ops/fast_tile.py's fast_dft
along axis 1 in place of torch.fft. rfft2_local, irfft2_local
and make_fft_pair are the slab transform pair on `xstage` (the JAX
package's fft_impl="overlap"); the x-pencil pair on the halves is in
parallel/xpencil.py. The kernels take no chunk plan: the pad is the
smallest multiple of P >= hny, as for the other impls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops import fused_fft as ff
from . import dfft
from . import fused_transpose as ft
from .pencil import padded_half

_MODES = {"xstage": 0, "xstage_gather": 1, "xstage_scatter": 2}


def _dft(x: torch.Tensor, forward: bool, scale: float,
         fast: bool = False) -> torch.Tensor:
    """Length-nx DFT along axis 1, unnormalized, times scale; `fast`: the
    fast tile's DFT, each part times scale in one rounded product (the
    kernel's store)."""
    if fast:
        from ..ops.fast_tile import fast_dft
        yr, yi = fast_dft(x.real.contiguous(), x.imag.contiguous(),
                          -1 if forward else 1, dim=1)
        return torch.complex(yr * scale, yi * scale)
    y = (torch.fft.fft(x, dim=1) if forward
         else torch.fft.ifft(x, dim=1, norm="forward"))
    return y if scale == 1.0 else y * scale


def _launch(name: str, x: torch.Tensor, out: torch.Tensor, nx: int,
            hny: int, w: int, forward: bool, scale: float,
            fast: bool) -> None:
    p = x.shape[0]
    ptrs = ft.shard_pointers(name, x, out)
    columns = p * w if name == "xstage_gather" else hny
    from ..ops._build import lib
    ff._launch(name + "_fast" if fast else name,
               lib().xfb_xstage_fast if fast else lib().xfb_xstage, ptrs,
               ff._twiddles(nx, x.device).data_ptr(), p, nx // p, hny, w,
               _MODES[name], int(forward), float(scale),
               *ff._xtile_args(nx, columns, 8), x.device.index,
               ff._stream(x))


def xstage_plain(x, forward: bool, scale: float = 1.0, fast: bool = False):
    return ft.a2a_rows_plain(_dft(ft.a2a_cols_plain(x), forward, scale,
                                  fast), x.shape[-1])


def xstage(x: torch.Tensor, forward: bool, scale: float = 1.0,
           fast: bool = False) -> torch.Tensor:
    """Row shards (P, nx/P, hny) complex64 -> the same, with the length-nx
    DFT applied along the sharded x axis; `fast`: on the fast column
    tile. Counterpart of pallas_overlap.xstage."""
    x = ft._check("xstage", x)
    p, rows_l, hny = x.shape
    if ff._takes_plain("xstage", x, p * rows_l):
        return xstage_plain(x, forward, scale, fast)
    out = torch.empty_like(x)
    _launch("xstage", x, out, p * rows_l, hny, padded_half(hny, p) // p,
            forward, scale, fast)
    return out


def xstage_gather_plain(x, forward: bool = True, scale: float = 1.0,
                        fast: bool = False):
    return _dft(ft.a2a_cols_plain(x), forward, scale, fast)


def xstage_gather(x: torch.Tensor, forward: bool = True,
                  scale: float = 1.0, fast: bool = False) -> torch.Tensor:
    """Row shards (P, nx/P, hny) complex64 -> x-pencil (P, nx, w) with the
    DFT applied, the pad columns zero; `fast`: on the fast column tile.
    Counterpart of pallas_overlap.xstage_gather."""
    x = ft._check("xstage_gather", x)
    p, rows_l, hny = x.shape
    if ff._takes_plain("xstage_gather", x, p * rows_l):
        return xstage_gather_plain(x, forward, scale, fast)
    w = padded_half(hny, p) // p
    out = torch.empty((p, p * rows_l, w), dtype=x.dtype, device=x.device)
    _launch("xstage_gather", x, out, p * rows_l, hny, w, forward, scale,
            fast)
    return out


def xstage_scatter_plain(x, hny: int, forward: bool = False,
                         scale: float = 1.0, fast: bool = False):
    return ft.a2a_rows_plain(_dft(x, forward, scale, fast), hny)


def xstage_scatter(x: torch.Tensor, hny: int, forward: bool = False,
                   scale: float = 1.0, fast: bool = False) -> torch.Tensor:
    """x-pencil (P, nx, w) complex64 -> row shards (P, nx/P, hny) with the
    DFT applied, the pad dropped; `fast`: on the fast column tile.
    Counterpart of pallas_overlap.xstage_scatter."""
    x = ft._check("xstage_scatter", x)
    p, nx, w = x.shape
    if nx % p or padded_half(hny, p) != p * w:
        raise ValueError(f"xstage_scatter: ({p}, {nx}, {w}) x-pencil "
                         f"shards do not hold a half axis of {hny}")
    if ff._takes_plain("xstage_scatter", x, nx):
        return xstage_scatter_plain(x, hny, forward, scale, fast)
    out = torch.empty((p, nx // p, hny), dtype=x.dtype, device=x.device)
    _launch("xstage_scatter", x, out, nx, hny, w, forward, scale, fast)
    return out


def rfft2_local(field: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """dfft.rfft2_local with the x-stage in one xstage launch (`fast`: its
    fast form; the y-stage stays torch.fft.rfft, as the JAX overlap
    impl's stays jnp.fft)."""
    return xstage(torch.fft.rfft(field, dim=-1), forward=True, fast=fast)


def irfft2_local(spec: torch.Tensor,
                 grid_shape: Optional[Tuple[int, int]] = None,
                 fast: bool = False) -> torch.Tensor:
    """dfft.irfft2_local with the x-stage in one xstage launch (scaled by
    1/nx there; `fast`: its fast form)."""
    p, rows_l, hny = spec.shape
    ny = grid_shape[1] if grid_shape is not None else 2 * (hny - 1)
    rows = xstage(spec, forward=False, scale=1.0 / (p * rows_l), fast=fast)
    return dfft.irfft_rows(rows, ny)


def make_fft_pair(fast: bool = False):
    """(forward, inverse) with the ops/fft.py signatures on row shards,
    each transform's x-stage one xstage launch (`fast`: its fast form)."""
    def fwd(field):
        return rfft2_local(field, fast)

    def inv(spec, grid_shape=None):
        return irfft2_local(spec, grid_shape, fast)

    return fwd, inv
