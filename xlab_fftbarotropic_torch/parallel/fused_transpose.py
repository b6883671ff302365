"""The all-to-all transposes as a CUDA kernel (csrc/a2a.cu): the
counterpart of xlab_fftbarotropic_tpu/parallel/pallas_transpose.py (TPU
row 23, _a2a_cols_kernel and _a2a_rows_kernel).

Same contract as the library transposes of parallel/dfft.py on the
stacked shards: a2a_cols (P, nx/P, hny) -> (P, nx, hpad/P) zero-padded,
a2a_rows the inverse with the pad stripped. Complex64 moves as float2.
A CPU tensor takes the plain version beside each wrapper; a CUDA tensor
launches the kernel, which reaches the shards through tables of their
base pointers (_pointer_table).
"""

from __future__ import annotations

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


def _pointer_table(x: torch.Tensor) -> torch.Tensor:
    """The base pointers of x's P shards (its leading axis) as an int64
    tensor on x's card, made there (one arange launch, no copy from the
    host that would wait for the stream); the caller holds it until the
    launch is queued."""
    step = x.stride(0) * x.element_size()
    base = x.data_ptr()
    return torch.arange(base, base + x.shape[0] * step, step,
                        dtype=torch.int64, device=x.device)


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
    src, dst = _pointer_table(x), _pointer_table(out)
    from ..ops._build import lib
    ff._launch("a2a_cols", lib().xfb_a2a, src.data_ptr(), dst.data_ptr(), p,
               rows_l, hny, w, 1, x.device.index, ff._stream(x))
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
    src, dst = _pointer_table(x), _pointer_table(out)
    from ..ops._build import lib
    ff._launch("a2a_rows", lib().xfb_a2a, src.data_ptr(), dst.data_ptr(), p,
               nx // p, hny, w, 0, x.device.index, ff._stream(x))
    return out
