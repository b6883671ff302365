"""The 2-D pencil decomposition of the distributed 2-D FFT, and the
half-axis padding helpers of the column-sharded spectral layouts: the
counterpart of xlab_fftbarotropic_tpu/parallel/pencil.py.

A (Px, Py) shard group (make_pencil_mesh) holds P = Px Py shards of
every field on one card, stacked on a leading axis:

  physical fields : tiles (P, nx/Px, ny/Py), in mesh order d = i Py + j
                    for the shard at (i, j) on the (px, py) mesh (tile
                    rows [i nx/Px, ...), columns [j ny/Py, ...)): the JAX
                    package's phys_spec P(px, py);
  spectral state  : x-pencils (P, nx, hpad/P), in block order b: stacked
                    shard b holds half-axis columns [b w, (b+1) w),
                    w = hpad/P, which the JAX package's state_spec
                    P(None, (py, px)) hands to mesh position (i, j) with
                    b = j Px + i.

The spectral side is therefore the x-pencil layout at P = Px Py
(parallel/xpencil.py: its tables, state and padding), and only the
physical tiles and the transform pair are new. The forward transform
runs the JAX module's three stages, each an all-to-all within one mesh
row (py) or one mesh column (px):

  tiles (nx/Px, ny/Py)
    --tiles_to_rows (py)-->     rows (nx/P, ny), row block i Py + j
    --rfft along y, pad hny -> hpad
    --rows_to_blocks (py)-->    (nx/Px, hpad/Py)
    --blocks_to_pencils (px)--> (nx, hpad/P), stacked in block order
    --fft along x

and the inverse mirrors it (pencils_to_blocks, blocks_to_rows, the pad
stripped, dfft.irfft_rows, rows_to_tiles). Each stage is a torch copy of
the stacked tensor (all_to_all: lax.all_to_all(tiled=True) over one mesh
axis). On a distributed group (one rank per shard, make_pencil_mesh on an
initialized runtime: rank d holds tile d and spectral block b(d) =
j Px + i) each stage is one dist.all_to_all_single over the rank's mesh
row (py) or mesh column (px) sub-group. The decomposition takes the
library impl only ('xla'), as the JAX package's: no kernel runs on it.

On the CPU: ShardedBarotropicModel.build(cfg, make_pencil_mesh((2, 4),
"cpu"), decomp="pencil") (tests/test_torch_pencil.py,
test_torch_pencil_run.py), or over 4 ranks
(tests/test_torch_multihost_model.py); on the card `python3
chip_smoke.py --phase 5s`, and over ranks `--phase 5t`.

A column-sharded half-spectrum pads its half axis ny//2+1 (odd) with
zero columns to a multiple of the shard count; the coefficient tables pad
alongside so that the pad columns stay exact zeros forever (the dealias
mask is zero there, hence every tendency vanishes on the pad).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.spectral import SpectralTables
from . import multihost

PX, PY = 0, 1  # the mesh axes: px (mesh rows i), py (mesh columns j)


def padded_half(hny: int, n_shards: int) -> int:
    """Smallest multiple of n_shards >= hny."""
    return -(-hny // n_shards) * n_shards


def check_grid(nx: int, ny: int, px: int, py: int) -> None:
    if nx % (px * py) != 0:
        raise ValueError(
            f"pencil decomposition needs nx divisible by Px*Py: "
            f"nx={nx}, Px*Py={px * py}")
    if ny % py != 0:
        raise ValueError(
            f"pencil decomposition needs ny divisible by Py: "
            f"ny={ny}, Py={py}")


def make_pencil_mesh(shape: Tuple[int, int], device=None):
    """The 2-D (Px, Py) shard group, model.make_mesh2d (the JAX package's
    name). Put the direction that would cross hosts on px: two of the
    three stages of a transform run within mesh rows (py)."""
    from .model import make_mesh2d

    return make_mesh2d(shape, device)


def all_to_all_ranked(x: torch.Tensor, group, axis: int, split_axis: int,
                      concat_axis: int) -> torch.Tensor:
    """all_to_all on a distributed group: the rank's shard (1, ...) splits
    its local axis `split_axis` into shape[axis] chunks, one
    dist.all_to_all_single over its mesh row (PY) or mesh column (PX)
    sends chunk k to position k, and what comes is concatenated along
    `concat_axis` in the senders' order. The stacking orders (mesh, block)
    are which rank holds which shard, so they change nothing here."""
    n = group.shape[axis]
    y = x[0]
    local = y.shape
    chunks = y.unflatten(split_axis, (n, local[split_axis] // n)
                         ).movedim(split_axis, 0)
    got = multihost.all_to_all(chunks, group.row_group if axis == PY
                               else group.col_group)
    return got.movedim(0, concat_axis).flatten(concat_axis,
                                               concat_axis + 1)[None]


def all_to_all(x: torch.Tensor, shape: Tuple[int, int], axis: int,
               split_axis: int, concat_axis: int, blocks_in: bool = False,
               blocks_out: bool = False, group=None) -> torch.Tensor:
    """lax.all_to_all(tiled=True) over mesh axis `axis` (PX or PY) of the
    shards x (P, ...): each shard splits its local axis `split_axis` into
    n = shape[axis] chunks and sends chunk k to the shard at position k
    along `axis` in its own mesh row (PY) or column (PX), which
    concatenates what it gets along `concat_axis`, in the senders' order.
    The shards are stacked in mesh order d = i Py + j, or in block order
    b = j Px + i (the spectral column block mesh position (i, j) holds)
    where blocks_in / blocks_out say so. One copy (a view where the
    layout allows). On a distributed `group`: all_to_all_ranked."""
    if group is not None and group.rank is not None:
        return all_to_all_ranked(x, group, axis, split_axis, concat_axis)
    n = shape[axis]
    local = x.shape[1:]
    a = (x.reshape(shape[1], shape[0], *local).transpose(0, 1) if blocks_in
         else x.reshape(*shape, *local))
    a = a.unflatten(split_axis + 2, (n, local[split_axis] // n))
    chunk = split_axis + 2
    cat = concat_axis + 2 + (concat_axis > split_axis)
    dims = [d for d in range(2, a.ndim) if d != chunk]
    dims.insert(dims.index(cat), axis)
    lead = [chunk if d == axis else d for d in (PX, PY)]
    out = list(local)
    out[split_axis] //= n
    out[concat_axis] *= n
    return a.permute(lead[::-1] + dims if blocks_out else lead + dims
                     ).reshape(-1, *out)


def tiles_to_rows(tiles: torch.Tensor, shape: Tuple[int, int],
                  group=None) -> torch.Tensor:
    """Stage 1 of the forward transform (py): tiles (P, nx/Px, ny/Py) ->
    rows (P, nx/P, ny), shard i Py + j holding global row block
    i Py + j, full y (the slab layout)."""
    return all_to_all(tiles, shape, PY, 0, 1, group=group)


def rows_to_blocks(rows: torch.Tensor, shape: Tuple[int, int],
                   group=None) -> torch.Tensor:
    """Stage 2 (py): padded half-spectrum rows (P, nx/P, hpad) ->
    (P, nx/Px, hpad/Py), shard (i, j) holding rows [i nx/Px, ...) and
    columns [j hpad/Py, ...)."""
    return all_to_all(rows, shape, PY, 1, 0, group=group)


def blocks_to_pencils(blocks: torch.Tensor, shape: Tuple[int, int],
                      group=None) -> torch.Tensor:
    """Stage 3 (px): (P, nx/Px, hpad/Py) -> x-pencils (P, nx, hpad/P),
    full x, stacked in block order."""
    return all_to_all(blocks, shape, PX, 1, 0, blocks_out=True, group=group)


def pencils_to_blocks(cols: torch.Tensor, shape: Tuple[int, int],
                      group=None) -> torch.Tensor:
    """Stage 3 of the inverse (px): x-pencils in block order ->
    (P, nx/Px, hpad/Py) in mesh order."""
    return all_to_all(cols, shape, PX, 0, 1, blocks_in=True, group=group)


def blocks_to_rows(blocks: torch.Tensor, shape: Tuple[int, int],
                   group=None) -> torch.Tensor:
    """Stage 2 of the inverse (py): (P, nx/Px, hpad/Py) -> rows
    (P, nx/P, hpad)."""
    return all_to_all(blocks, shape, PY, 0, 1, group=group)


def rows_to_tiles(rows: torch.Tensor, shape: Tuple[int, int],
                  group=None) -> torch.Tensor:
    """Stage 1 of the inverse (py): rows (P, nx/P, ny) -> tiles
    (P, nx/Px, ny/Py)."""
    return all_to_all(rows, shape, PY, 1, 0, group=group)


def shard_tiles(field: torch.Tensor, shape: Tuple[int, int]
                ) -> torch.Tensor:
    """A global (nx, ny) field -> its tiles (P, nx/Px, ny/Py)."""
    (px, py), (nx, ny) = shape, field.shape
    return field.reshape(px, nx // px, py, ny // py).transpose(1, 2
                                                                ).reshape(
        px * py, nx // px, ny // py)


def unshard_tiles(tiles: torch.Tensor, shape: Tuple[int, int]
                  ) -> torch.Tensor:
    """Tiles (P, nx/Px, ny/Py) -> the global (nx, ny) field."""
    (px, py), (_, mx, my) = shape, tiles.shape
    return tiles.reshape(px, py, mx, my).transpose(1, 2).reshape(
        px * mx, py * my)


def rfft2_local(field: torch.Tensor, shape: Tuple[int, int],
                hny: int, group=None) -> torch.Tensor:
    """Tiles (P, nx/Px, ny/Py) float32 -> x-pencils (P, nx, hpad/P)
    complex64 in block order, unnormalized (on a distributed group, the
    rank's tile and block)."""
    from .dfft import _ranked, fft_x

    spec = torch.fft.rfft(tiles_to_rows(field, shape, group), dim=-1)
    spec = pad_spectral(spec, padded_half(hny, shape[0] * shape[1]))
    cols = blocks_to_pencils(rows_to_blocks(spec, shape, group), shape,
                             group)
    return fft_x(cols, ranked=_ranked(group))


def irfft2_local(spec: torch.Tensor,
                 grid_shape: Optional[Tuple[int, int]],
                 shape: Tuple[int, int], hny: int,
                 group=None) -> torch.Tensor:
    """x-pencils (P, nx, hpad/P) complex64 in block order -> tiles
    (P, nx/Px, ny/Py) float32, scaled by 1/(nx*ny)."""
    from .dfft import _ranked, fft_x, irfft_rows

    ny = grid_shape[1] if grid_shape is not None else 2 * (hny - 1)
    cols = pencils_to_blocks(fft_x(spec, True, _ranked(group)), shape,
                             group)
    rows = blocks_to_rows(cols, shape, group)[..., :hny].contiguous()
    return rows_to_tiles(irfft_rows(rows, ny), shape, group)


def make_fft_pair(shape: Tuple[int, int], hny: int, group=None):
    """(forward, inverse) with the ops/fft.py signatures for the pencil
    layout of a (Px, Py) shard group (distributed: the rank's)."""
    shape = tuple(shape)

    def fwd(field):
        return rfft2_local(field, shape, hny, group)

    def inv(spec, grid_shape=None):
        return irfft2_local(spec, grid_shape, shape, hny, group)

    return fwd, inv


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
