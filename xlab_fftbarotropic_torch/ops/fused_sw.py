"""RK4 plane arithmetic: the counterpart of the plane-arithmetic part of
xlab_fftbarotropic_tpu/ops/pallas_sw.py.

plane_rk4_combine is the RK4 tail of every plane stepper, one launch of
the hand-written csrc/rk4_combine.cu over all planes of the state. Same
dispatch rule as ops/fused_fft.py: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise; launches count in
fused_fft.LAUNCHES["rk4_combine"].
"""

from __future__ import annotations

import ctypes

import torch

from .fused_fft import _check, _launch, _ptrs, _stream, _takes_plain

MAX_PLANES = 8   # csrc/rk4_combine.cu kMaxPlanes


def plane_rk4_combine_plain(s0, r1, r2, r3, r4, c: float):
    return tuple(s + (a + 2.0 * b + 2.0 * d + e) * c
                 for s, a, b, d, e in zip(s0, r1, r2, r3, r4))


def plane_rk4_combine(s0, r1, r2, r3, r4, c: float):
    """out_p = s0_p + (r1_p + 2 r2_p + 2 r3_p + r4_p) * c (c = dt/6),
    the RK4 tail (main.cpp:309-312), over tuples of same-shape float32
    planes, in that grouping. Counterpart of pallas_sw.plane_rk4_combine
    (_rk4_combine_kernel)."""
    groups = (s0, r1, r2, r3, r4)
    n = len(s0)
    if not 1 <= n <= MAX_PLANES or any(len(g) != n for g in groups):
        raise ValueError(f"plane_rk4_combine: expected five tuples of "
                         f"1..{MAX_PLANES} planes each, got "
                         f"{[len(g) for g in groups]}")
    planes = [p for g in groups for p in g]
    _check("rk4_combine", tuple(s0[0].shape), *planes)
    if _takes_plain("rk4_combine", s0[0]):
        return plane_rk4_combine_plain(s0, r1, r2, r3, r4, c)
    from ._build import lib
    outs = [torch.empty_like(p) for p in s0]
    table = (ctypes.c_void_p * (6 * n))(*_ptrs(*planes, *outs))
    _launch("rk4_combine", lib().xfb_rk4_combine, ctypes.addressof(table),
            n, s0[0].numel(), float(c), s0[0].device.index, _stream(s0[0]))
    return tuple(outs)
