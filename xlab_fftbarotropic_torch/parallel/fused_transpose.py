"""The all-to-all transposes as a CUDA kernel (csrc/a2a.cu): the
counterpart of xlab_fftbarotropic_tpu/parallel/pallas_transpose.py (TPU
row 23, _a2a_cols_kernel and _a2a_rows_kernel).

Same contract as the library transposes of parallel/dfft.py on the
stacked shards: a2a_cols (P, nx/P, hny) -> (P, nx, hpad/P) zero-padded,
a2a_rows the inverse with the pad stripped. Complex64 moves as float2.
A CPU tensor takes the plain version beside each wrapper; a CUDA tensor
launches the kernel, which reaches the shards through their base
pointers, passed to it by value (shard_pointers): a call allocates its
output and queues the kernel, nothing else.

On a distributed group (one shard per rank) a2a_cols_ranked and
a2a_rows_ranked take the rank's shard (1, ...) and the model's exchange
buffers (parallel/peer.py): the rank writes its source buffer, and after
the barrier launches only its own runs (rank >= 0), the pointer table
holding every rank's peer-mapped buffers; after the second barrier it
copies its destination out. The plain versions beside them read the
peers' buffers through the same table, on the CPU's /dev/shm mappings.
Each rank counts its own launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import fused_fft as ff
from .pencil import padded_half


def _check(name: str, x: torch.Tensor) -> torch.Tensor:
    """x as contiguous complex64 (P, rows, cols) shards (a transform
    along axis 1 may hand over another memory order), or raise."""
    if x.dtype != torch.complex64:
        raise TypeError(f"{name}: expected complex64, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name}: expected (P, rows, cols) shards, got "
                         f"{tuple(x.shape)}")
    return x.contiguous()


# csrc/shards.cuh kMaxShards: the shard pointers the kernels take by value
MAX_SHARDS = 32


def shard_pointers(name: str, src: torch.Tensor, dst: torch.Tensor):
    """The host array of the kernels' 2 P shard base pointers: src's P
    shards (its leading axis), then dst's. Raises past MAX_SHARDS."""
    p = src.shape[0]
    if not 1 <= p <= MAX_SHARDS:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_SHARDS} shards "
                         f"(csrc/shards.cuh kMaxShards), got {p}")
    ptrs = [t.data_ptr() + k * t.stride(0) * t.element_size()
            for t in (src, dst) for k in range(p)]
    return (ctypes.c_void_p * (2 * p))(*ptrs)


def table_pointers(name: str, srcs: list, dsts: list):
    """The host array of the kernels' 2 P pointers from a pointer table:
    every rank's source buffer, then every rank's destination buffer
    (parallel/peer.py Exchange.views). Raises past MAX_SHARDS."""
    p = len(srcs)
    if not 1 <= p <= MAX_SHARDS or len(dsts) != p:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_SHARDS} shards "
                         f"(csrc/shards.cuh kMaxShards), got {p}")
    return (ctypes.c_void_p * (2 * p))(*[t.data_ptr() for t in srcs + dsts])


def a2a_cols_plain(x: torch.Tensor) -> torch.Tensor:
    p, rows_l, hny = x.shape
    w = padded_half(hny, p) // p
    pad = x.new_zeros((p, rows_l, p * w))
    pad[..., :hny] = x
    return torch.stack([torch.cat([pad[s][:, t * w:(t + 1) * w]
                                   for s in range(p)])
                        for t in range(p)])


def a2a_cols(x: torch.Tensor) -> torch.Tensor:
    """Row shards (P, nx/P, hny) complex64 -> column shards (P, nx, w),
    w = ceil(hny/P): out[t][s nx/P + r][j] = x[s][r][t w + j], zero on the
    pad. Counterpart of pallas_transpose.transpose_to_columns."""
    x = _check("a2a_cols", x)
    if ff._takes_plain("a2a_cols", x):
        return a2a_cols_plain(x)
    p, rows_l, hny = x.shape
    w = padded_half(hny, p) // p
    out = torch.empty((p, p * rows_l, w), dtype=x.dtype, device=x.device)
    ptrs = shard_pointers("a2a_cols", x, out)
    from ..ops._build import lib
    ff._launch("a2a_cols", lib().xfb_a2a, ptrs, p, rows_l, hny, w, 1, -1,
               x.device.index, ff._stream(x))
    return out


def a2a_rows_plain(x: torch.Tensor, hny: int) -> torch.Tensor:
    p, nx, w = x.shape
    rows_l = nx // p
    return torch.stack([torch.cat([x[t][s * rows_l:(s + 1) * rows_l]
                                   for t in range(p)], dim=1)[:, :hny]
                        for s in range(p)])


def a2a_rows(x: torch.Tensor, hny: int) -> torch.Tensor:
    """Column shards (P, nx, w) complex64 -> row shards (P, nx/P, hny),
    the pad stripped: the inverse of a2a_cols. Counterpart of
    pallas_transpose.transpose_to_rows."""
    x = _check("a2a_rows", x)
    p, nx, w = x.shape
    if nx % p or not (p * (w - 1) < hny <= p * w):
        raise ValueError(f"a2a_rows: ({p}, {nx}, {w}) column shards do not "
                         f"hold a half axis of {hny}")
    if ff._takes_plain("a2a_rows", x):
        return a2a_rows_plain(x, hny)
    out = torch.empty((p, nx // p, hny), dtype=x.dtype, device=x.device)
    ptrs = shard_pointers("a2a_rows", x, out)
    from ..ops._build import lib
    ff._launch("a2a_rows", lib().xfb_a2a, ptrs, p, nx // p, hny, w, 0, -1,
               x.device.index, ff._stream(x))
    return out


def a2a_cols_ranked_plain(srcs: list, dst: torch.Tensor, rank: int) -> None:
    """The rank's runs of a2a_cols on the CPU: its column shard dst
    (1, nx, w), pulled from every rank's row shard srcs[s] (1, nx/P,
    hny), zero on the pad."""
    p, (_, rows_l, hny), w = len(srcs), srcs[0].shape, dst.shape[-1]
    c0, c1 = rank * w, min((rank + 1) * w, hny)
    dst[..., c1 - c0:] = 0
    for s, src in enumerate(srcs):
        dst[0, s * rows_l:(s + 1) * rows_l, :c1 - c0] = src[0, :, c0:c1]


def a2a_rows_ranked_plain(srcs: list, dst: torch.Tensor, rank: int) -> None:
    """The rank's runs of a2a_rows on the CPU: its row shard dst
    (1, nx/P, hny), pulled from every rank's column shard srcs[t]
    (1, nx, w), the pad dropped."""
    (_, rows_l, hny), w = dst.shape, srcs[0].shape[-1]
    for t, src in enumerate(srcs):
        c0, c1 = t * w, min((t + 1) * w, hny)
        dst[0, :, c0:c1] = src[0, rank * rows_l:(rank + 1) * rows_l,
                               :c1 - c0]


def a2a_cols_ranked(x: torch.Tensor, ex) -> torch.Tensor:
    """a2a_cols on a distributed group: the rank's row shard (1, nx/P, hny)
    -> its column shard (1, nx, w), through the exchange buffers `ex`
    (parallel/peer.py): the kernel's runs with t = rank, or their plain
    version on the CPU."""
    x = _check("a2a_cols", x)
    _, rows_l, hny = x.shape
    ex.put("rows", x)
    srcs, dsts = ex.views("rows", "src"), ex.views("cols", "dst")
    if ff._takes_plain("a2a_cols", x):
        a2a_cols_ranked_plain(srcs, dsts[ex.rank], ex.rank)
    else:
        from ..ops._build import lib
        ff._launch("a2a_cols", lib().xfb_a2a,
                   table_pointers("a2a_cols", srcs, dsts), ex.n, rows_l,
                   hny, dsts[0].shape[-1], 1, ex.rank, x.device.index,
                   ff._stream(x))
    return ex.take("cols")


def a2a_rows_ranked(x: torch.Tensor, hny: int, ex) -> torch.Tensor:
    """a2a_rows on a distributed group: the rank's column shard (1, nx, w)
    -> its row shard (1, nx/P, hny), through the exchange buffers `ex`:
    the kernel's runs with s = rank, or their plain version on the
    CPU."""
    x = _check("a2a_rows", x)
    _, nx, w = x.shape
    if tuple(ex.shapes["cols"]) != (nx, w) or ex.shapes["rows"][1] != hny:
        raise ValueError(f"a2a_rows: (1, {nx}, {w}) column shards do not "
                         f"hold a half axis of {hny} over {ex.n} ranks")
    ex.put("cols", x)
    srcs, dsts = ex.views("cols", "src"), ex.views("rows", "dst")
    if ff._takes_plain("a2a_rows", x):
        a2a_rows_ranked_plain(srcs, dsts[ex.rank], ex.rank)
    else:
        from ..ops._build import lib
        ff._launch("a2a_rows", lib().xfb_a2a,
                   table_pointers("a2a_rows", srcs, dsts), ex.n,
                   nx // ex.n, hny, w, 0, ex.rank, x.device.index,
                   ff._stream(x))
    return ex.take("rows")
