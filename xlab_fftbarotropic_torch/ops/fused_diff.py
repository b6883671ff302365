"""Differentiable per-transform kernels: the counterpart of
xlab_fftbarotropic_tpu/ops/pallas_diff.py.

The hand-written kernels have no autograd rules, so the three transform
entry points of ops/fused_fft.py (rfft2, irfft2, inverse_pair) get
torch.autograd.Functions whose backward passes run the same kernels:
the differentiable rollout (adjoint.py) then runs ka, kb and kc in both
sweeps, and no library transform.

The rules, for real-linear maps with torch's complex gradient
convention (the gradient of a real loss L at z = x + iy is
dL/dx + i dL/dy, the conjugate of JAX's cotangent, so the conj of
pallas_diff.py does not carry over):

* forward (unnormalized rfft2):
    x_bar = (nx*ny) * irfft2(w * g_bar),  w[ky] = 1/2 on the interior
    columns, 1 on the self-conjugate columns ky = 0 and ny/2
  (the Hermitian-extended inverse weighs interior columns twice, the
  half-weights cancel it);
* inverse (irfft2, scaled by 1/(nx*ny)):
    S_bar = (c / (nx*ny)) * rfft2(u_bar),  c[ky] = 2 interior, 1 at the
    self-conjugate columns;
* inverse_pair: the inverse rule for each field.

Each is the exact transpose of the map as implemented, the projection
of the self-conjugate rows to their real part included. The
half-spectrum is redundant on the self-conjugate columns, so
intermediate gradients may leave the Hermitian subspace and differ from
those of torch.fft's autograd there; composed gradients (with respect to
physical fields) agree to float32 round-off (tests/test_torch_adjoint.py).

The Functions save no tensors: ctx holds the grid as Python ints only.
"""

from __future__ import annotations

import torch

from . import fused_fft as ff

_WEIGHTS: dict = {}


def _col_weights(ny: int, device: torch.device):
    """(w, c) over the ky columns (ny//2 + 1,), float32: w = 1/2 and
    c = 2 on the interior columns, both 1 at ky = 0 and ny/2; one pair
    per (ny, device)."""
    key = (ny, device)
    if key not in _WEIGHTS:
        w = torch.full((ny // 2 + 1,), 0.5, dtype=torch.float32,
                       device=device)
        c = torch.full_like(w, 2.0)
        for t in (w, c):
            t[0] = 1.0
            t[-1] = 1.0
        _WEIGHTS[key] = (w, c)
    return _WEIGHTS[key]


class _Forward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.grid = tuple(x.shape)
        return ff.rfft2(x)

    @staticmethod
    def backward(ctx, g):
        nx, ny = ctx.grid
        w, _ = _col_weights(ny, g.device)
        return (nx * ny) * ff.irfft2(g * w, (nx, ny))


class _Inverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, nx: int, ny: int):
        ctx.grid = (nx, ny)
        return ff.irfft2(spec, (nx, ny))

    @staticmethod
    def backward(ctx, u):
        nx, ny = ctx.grid
        _, c = _col_weights(ny, u.device)
        return ff.rfft2(u) * (c / (nx * ny)), None, None


class _InversePair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec_a, spec_b, nx: int, ny: int):
        ctx.grid = (nx, ny)
        return ff.inverse_pair(spec_a, spec_b, (nx, ny))

    @staticmethod
    def backward(ctx, ua, ub):
        nx, ny = ctx.grid
        _, c = _col_weights(ny, ua.device)
        c = c / (nx * ny)
        return ff.rfft2(ua) * c, ff.rfft2(ub) * c, None, None


def forward(x: torch.Tensor) -> torch.Tensor:
    """Differentiable rfft2 on the kernels (ops/fft.py contract)."""
    return _Forward.apply(x)


def inverse(spec: torch.Tensor, grid_shape) -> torch.Tensor:
    """Differentiable irfft2 on the kernels, scaled by 1/(nx*ny)."""
    nx, ny = grid_shape
    return _Inverse.apply(spec, int(nx), int(ny))


def inverse_pair(spec_a: torch.Tensor, spec_b: torch.Tensor,
                 grid_shape) -> tuple:
    """Differentiable pair inverse on the kernels (two ka, one kb)."""
    nx, ny = grid_shape
    return _InversePair.apply(spec_a, spec_b, int(nx), int(ny))
