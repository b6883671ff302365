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

On a distributed group (one shard per rank) xstage_ranked,
xstage_gather_ranked and xstage_scatter_ranked take the rank's shard
(1, ...) and the model's exchange buffers (parallel/peer.py, the protocol
of fused_transpose.a2a_cols_ranked): the rank launches the tiles of its
own w columns, pulling from and pushing to its peers' buffers through the
pointer table; the plain versions beside them transform the rank's
columns [rank w, (rank + 1) w) as the stacked plain versions transform
its shard, and write them through the same table.
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
         fast: bool = False, ranked: bool = False) -> torch.Tensor:
    """Length-nx DFT along axis 1, unnormalized, times scale; `fast`: the
    fast tile's DFT, each part times scale in one rounded product (the
    kernel's store). `ranked`: a rank's one shard, transformed as rows of
    its contiguous transpose, as dfft.fft_x(ranked=True) does, for the
    stacked model's bits."""
    if fast:
        from ..ops.fast_tile import fast_dft
        yr, yi = fast_dft(x.real.contiguous(), x.imag.contiguous(),
                          -1 if forward else 1, dim=1)
        return torch.complex(yr * scale, yi * scale)
    if ranked:
        x = x.transpose(1, 2).contiguous()
    dim = -1 if ranked else 1
    y = (torch.fft.fft(x, dim=dim) if forward
         else torch.fft.ifft(x, dim=dim, norm="forward"))
    if ranked:
        y = y.transpose(1, 2)
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
               *ff._xtile_args(nx, columns, 8), -1, x.device.index,
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


# the exchange buffers of each mode: (source, destination) shape names
_BUFFERS = {"xstage": ("rows", "rows"), "xstage_gather": ("rows", "cols"),
            "xstage_scatter": ("cols", "rows")}


def xstage_ranked_plain(name: str, srcs: list, dsts: list, rank: int,
                        hny: int, forward: bool, scale: float,
                        fast: bool) -> None:
    """The rank's columns of the x-stage `name` on the CPU: its x-pencil
    block [rank w, (rank + 1) w) gathered from every rank's row shard
    (xstage, gather) or its own (scatter), transformed, and written into
    its own x-pencil (gather) or every rank's row shard (xstage,
    scatter), through the pointer table srcs, dsts."""
    p = len(srcs)
    w = -(-hny // p)
    if name == "xstage_scatter":
        block = srcs[rank]
        rows_l = block.shape[1] // p
    else:
        rows_l = srcs[0].shape[1]
        block = srcs[0].new_zeros((1, p * rows_l, w))
    c0, c1 = rank * w, min((rank + 1) * w, hny)
    if name != "xstage_scatter":
        for s, src in enumerate(srcs):
            block[0, s * rows_l:(s + 1) * rows_l, :c1 - c0] = src[0, :,
                                                                  c0:c1]
    y = _dft(block, forward, scale, fast, ranked=True)
    if name == "xstage_gather":
        dsts[rank].copy_(y)
        return
    for s, dst in enumerate(dsts):
        dst[0, :, c0:c1] = y[0, s * rows_l:(s + 1) * rows_l, :c1 - c0]


def _ranked(name: str, x: torch.Tensor, ex, hny: int, forward: bool,
            scale: float, fast: bool) -> torch.Tensor:
    """The protocol of one ranked x-stage (fused_transpose.a2a_cols_ranked):
    put, the rank's tiles (or their plain version), take."""
    x = ft._check(name, x)
    src_name, dst_name = _BUFFERS[name]
    if tuple(x.shape[1:]) != tuple(ex.shapes[src_name]) or \
            ex.shapes["rows"][1] != hny:
        raise ValueError(f"{name}: a {tuple(x.shape)} shard does not fit "
                         f"the exchange buffers {ex.shapes} of a half axis "
                         f"of {hny}")
    nx, w = ex.shapes["cols"]
    ex.put(src_name, x)
    srcs, dsts = ex.views(src_name, "src"), ex.views(dst_name, "dst")
    if ff._takes_plain(name, x, nx):
        xstage_ranked_plain(name, srcs, dsts, ex.rank, hny, forward, scale,
                            fast)
    else:
        columns = ex.n * w if name == "xstage_gather" else hny
        from ..ops._build import lib
        ff._launch(name + "_fast" if fast else name,
                   lib().xfb_xstage_fast if fast else lib().xfb_xstage,
                   ft.table_pointers(name, srcs, dsts),
                   ff._twiddles(nx, x.device).data_ptr(), ex.n, nx // ex.n,
                   hny, w, _MODES[name], int(forward), float(scale),
                   *ff._xtile_args(nx, columns, 8), ex.rank,
                   x.device.index, ff._stream(x))
    return ex.take(dst_name)


def xstage_ranked(x: torch.Tensor, ex, forward: bool, scale: float = 1.0,
                  fast: bool = False) -> torch.Tensor:
    """xstage on a distributed group: the rank's row shard (1, nx/P, hny)
    -> the same with the DFT along x, through the exchange buffers."""
    return _ranked("xstage", x, ex, x.shape[-1], forward, scale, fast)


def xstage_gather_ranked(x: torch.Tensor, ex, forward: bool = True,
                         scale: float = 1.0,
                         fast: bool = False) -> torch.Tensor:
    """xstage_gather on a distributed group: the rank's row shard
    (1, nx/P, hny) -> its x-pencil (1, nx, w) with the DFT applied."""
    return _ranked("xstage_gather", x, ex, x.shape[-1], forward, scale,
                   fast)


def xstage_scatter_ranked(x: torch.Tensor, hny: int, ex,
                          forward: bool = False, scale: float = 1.0,
                          fast: bool = False) -> torch.Tensor:
    """xstage_scatter on a distributed group: the rank's x-pencil
    (1, nx, w) -> its row shard (1, nx/P, hny) with the DFT applied."""
    return _ranked("xstage_scatter", x, ex, hny, forward, scale, fast)


def rfft2_local(field: torch.Tensor, fast: bool = False,
                exchange=None) -> torch.Tensor:
    """dfft.rfft2_local with the x-stage in one xstage launch (`fast`: its
    fast form; the y-stage stays torch.fft.rfft, as the JAX overlap
    impl's stays jnp.fft); with `exchange`, the rank's shard over a
    distributed group (xstage_ranked)."""
    spec = torch.fft.rfft(field, dim=-1)
    if exchange is not None:
        return xstage_ranked(spec, exchange, forward=True, fast=fast)
    return xstage(spec, forward=True, fast=fast)


def irfft2_local(spec: torch.Tensor,
                 grid_shape: Optional[Tuple[int, int]] = None,
                 fast: bool = False, exchange=None) -> torch.Tensor:
    """dfft.irfft2_local with the x-stage in one xstage launch (scaled by
    1/nx there; `fast`: its fast form; `exchange`: the rank's shard)."""
    p, rows_l, hny = spec.shape
    ny = grid_shape[1] if grid_shape is not None else 2 * (hny - 1)
    if exchange is not None:
        rows = xstage_ranked(spec, exchange, forward=False,
                             scale=1.0 / exchange.shapes["cols"][0],
                             fast=fast)
    else:
        rows = xstage(spec, forward=False, scale=1.0 / (p * rows_l),
                      fast=fast)
    return dfft.irfft_rows(rows, ny)


def make_fft_pair(fast: bool = False, exchange=None):
    """(forward, inverse) with the ops/fft.py signatures on row shards,
    each transform's x-stage one xstage launch (`fast`: its fast form;
    `exchange`: the rank's shard over a distributed group)."""
    def fwd(field):
        return rfft2_local(field, fast, exchange)

    def inv(spec, grid_shape=None):
        return irfft2_local(spec, grid_shape, fast, exchange)

    return fwd, inv
