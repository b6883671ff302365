"""The launch plan of the column-tile transform (csrc/xtile.cuh).

kx_visc.cu and xstage.cu transform along the x axis of a half spectrum
whose column axis is the contiguous one, and so do ka, ka_adv and ka_fwd
(ka_kc.cu), the field x-stages ka_diag, ka6 and ka_quad (ka_diag.cu: one
field per cluster) and ka_sw (ka_sw.cu), each with a transposed store;
kc (ka_kc.cu: kc, kc_sw, kc_visc), kb_pair and kb (kb_pair.cu), ky_adv
(ky_adv.cu), ky_all (ky_all.cu: one product per cluster), kb_adv
(kb_adv.cu: its inverse, then its forward transform, in tiles of C/2
columns and half the threads) and kb_adv_tracer (kb_adv_tracer.cu:
kb_adv's launch shape, two forward transforms) along the y axis of
(ny, nx) or (hny, nx) planes, whose nx columns are contiguous, kb_pair
with the natural store, the others with a transposed one (their output
rows are the tile's columns). Each gives a tile of C adjacent
columns to a thread block cluster of K blocks: block r of the cluster
loads rows r, r + K, r + 2K, ... of the tile (row segments of C
elements, consecutive lanes on consecutive columns), runs the length
n/K sub-DFTs of its rows in its shared memory (self-sorting radix-8/4/2
passes, `radices`), and after a cluster barrier computes its slice of
the outputs as length-K DFTs over the K blocks' results, read through
distributed shared memory, twiddled by W_n^(r k2) on the way in.

The plan depends on the transform length alone (the column count only
sets the grid), so every form of a kernel (any epilogue, any number of
stacked fields) runs the same transform and gives the same bits.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

from .fused_fft import MAX_N, MIN_N, supported_length

# complex values each thread holds in registers (csrc/xtile.cuh kElems)
ELEMS = 16
# the portable cluster size limit of Hopper
MAX_CLUSTER = 8
# the widest tile, and the shared memory a block's tile may take: three
# blocks of 64 KB (and their twiddles) fit one SM's 227 KB
MAX_COLUMNS = 16
TILE_BYTES = 64 * 1024
MAX_SMEM = 227 * 1024
# a row segment must fill at least one 32-byte sector
SECTOR = 32
COMPLEX_BYTES = 8


class XTilePlan(NamedTuple):
    n: int              # transform length
    columns: int        # columns transformed (the last tile ragged)
    c: int              # columns per tile
    k: int              # blocks per cluster
    threads: int        # threads per block
    smem: int           # dynamic shared bytes per block
    tiles: int          # ceil(columns / c)
    radices: Tuple[int, ...]   # the sub-DFT's passes, first to last

    @property
    def m(self) -> int:
        """The sub-DFT length n / k of each block."""
        return self.n // self.k

    @property
    def grid(self) -> int:
        """Blocks along x: k per tile (times the stacked fields along y)."""
        return self.tiles * self.k


def sub_radices(m: int) -> Tuple[int, ...]:
    """The radix of each pass of a length-m sub-DFT: radix 8 while 8
    divides what is left, then one radix-4 or radix-2 pass
    (csrc/xtile.cuh subdft)."""
    out, p = [], 1
    while p < m:
        r = min(8, m // p)
        out.append(r)
        p *= r
    return tuple(out)


@lru_cache(maxsize=None)
def xtile_plan(n: int, columns: int, elem_bytes: int) -> XTilePlan:
    """The tile plan of a length-n transform over `columns` columns whose
    elements in device memory are `elem_bytes` wide (4: float planes of
    kx_visc, ka, kc and kb, 8: the complex64 shards of xstage). Raises on a
    shape the kernels do not take."""
    if not supported_length(n):
        raise ValueError(f"xtile: the kernels take power-of-two lengths "
                         f"{MIN_N}..{MAX_N}, got {n}")
    if columns < 1:
        raise ValueError(f"xtile: no columns to transform ({columns})")
    if elem_bytes not in (4, 8):
        raise ValueError(f"xtile: elements of 4 or 8 bytes, got "
                         f"{elem_bytes}")
    c, k = MAX_COLUMNS, 1
    while n * c * COMPLEX_BYTES // k > TILE_BYTES and k < MAX_CLUSTER:
        k *= 2
    while n * c * COMPLEX_BYTES // k > TILE_BYTES:
        c //= 2
    if c * elem_bytes < SECTOR:
        raise ValueError(f"xtile: {c} columns of {elem_bytes} bytes fill "
                         f"less than a {SECTOR}-byte sector")
    m = n // k
    smem = (m * c + m) * COMPLEX_BYTES     # the tile and the W_m table
    if smem > MAX_SMEM:
        raise ValueError(f"xtile: {smem} shared bytes per block at n = {n}")
    return XTilePlan(n=n, columns=columns, c=c, k=k,
                     threads=m * c // ELEMS, smem=smem,
                     tiles=-(-columns // c), radices=sub_radices(m))
