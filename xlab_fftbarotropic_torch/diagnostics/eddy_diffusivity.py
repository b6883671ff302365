"""Effective eddy diffusivity (Nakamura's equivalent-length diagnostic):
the counterpart of xlab_fftbarotropic_tpu/diagnostics/eddy_diffusivity.py.

Advertised in the reference README (README.md:6) but never implemented
there (SURVEY.md §5.10-7); the JAX package designed it from Hendricks &
Schubert 2009 (JAS 66), who apply Nakamura's (1996) tracer-coordinate
formalism to the 2-D barotropic vortex. For a tracer q (the vorticity
itself, the natural tracer of barotropic flow), with A(Q) the area where
q >= Q:

    L_e^2(Q) = <|grad q|^2>_Q * (dA/dQ)^2      (equivalent length)
    kappa_eff / kappa = L_e^2 / L_min^2,  L_min(A) = 2*sqrt(pi*A)

kappa_eff >= kappa always (isoperimetric inequality); the excess
measures the filamentary stretching of the tracer contours.

Discretization, as in the JAX module: cells binned by tracer value into
`nbins` levels, reverse cumulative sums over the bins for A(Q) and the
integral of |grad q|^2, centered differences in Q for the derivatives.
The bin index is formed in float32 in the JAX module's operation order
(a cell in another bin would move the whole profile). The histograms are
torch.bincount in float64, cast to float32 once summed, so the atomics'
run-to-run order on the card does not show; the rest is float32 as in
the JAX module. The gradients are spectral: one forward transform and
one inverse_pair of the (forward, inverse, inverse_pair) triple
(models/barotropic.resolve_fft_backend; torch.fft when None), on the
kernels LAUNCHES_PER_CALL per call.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.barotropic import resolve_fft_backend
from ..ops import spectral as sp
from ..ops.spectral import SpectralTables

# kernel launches of one effective_diffusivity on the kernel path: one
# rfft2 (ka + kc) and one inverse_pair (2 ka + kb)
LAUNCHES_PER_CALL = {"ka": 3, "kb": 1, "kc": 1}


class EffectiveDiffusivity(NamedTuple):
    levels: torch.Tensor         # (nbins,) tracer levels Q (bin centers)
    area: torch.Tensor           # (nbins,) A(Q) = area with q >= Q [m^2]
    equiv_length2: torch.Tensor  # (nbins,) L_e^2(Q)                [m^2]
    min_length2: torch.Tensor    # (nbins,) L_min^2 = 4*pi*A        [m^2]
    kappa_ratio: torch.Tensor    # (nbins,) max(Le^2/Lmin^2, 1): clipped
    kappa_ratio_raw: torch.Tensor  # (nbins,) unclipped Le^2/Lmin^2;
    #                                values below 1 flag under-resolved
    #                                bins


def _shift(a: torch.Tensor) -> torch.Tensor:
    """a[i+1], with 0 past the end."""
    return torch.cat([a[1:], a.new_zeros(1)])


def effective_diffusivity(t: SpectralTables, q: torch.Tensor, dx: float,
                          dy: float, nbins: int = 64,
                          transforms=None) -> EffectiveDiffusivity:
    """Nakamura effective-diffusivity profile of tracer field q (nx, ny)
    float32, on its device.

    `kappa_ratio` is clipped below at 1 for downstream consumers;
    `kappa_ratio_raw` keeps the unclipped value, where a ratio well
    below 1 means the bin is under-resolved. Analytic pins (the JAX
    package's tests/test_postproc.py): a radially symmetric tracer gives
    ratio 1; a stripe tracer cos(2*pi*(a*x/lx + b*y/ly)) gives
    L_e^2 = 4*(a^2*ly^2 + b^2*lx^2) at every interior level.
    """
    q = q.to(torch.float32)
    grid_shape = tuple(q.shape)
    if transforms is None:
        transforms = resolve_fft_backend("xla", grid_shape)
    forward, _, inverse_pair = transforms
    cell = dx * dy
    q_hat = forward(q.contiguous())
    gx, gy = inverse_pair(sp.gradx(t, q_hat), sp.grady(t, q_hat),
                          grid_shape)
    grad2 = gx * gx + gy * gy

    qmin = torch.min(q)
    qmax = torch.max(q)
    span = torch.clamp(qmax - qmin, min=1e-30)
    # bin index per cell (eddy_diffusivity.py:84-85 of the JAX package);
    # levels are bin centers
    ib = torch.clamp(((q - qmin) / span * nbins).to(torch.int32), 0,
                     nbins - 1).reshape(-1).long()
    levels = qmin + (torch.arange(nbins, dtype=torch.float32,
                                  device=q.device) + 0.5) / nbins * span

    count = torch.bincount(ib, minlength=nbins).float()
    g2sum = torch.bincount(ib, weights=grad2.reshape(-1).double(),
                           minlength=nbins).float()

    # A(Q): area with q >= Q, reverse cumulative sums (high bins first);
    # A[i] counts bins i..nbins-1, A at the LOWER EDGE of bin i, so at
    # the bin-center level Q[i] the half-bin offset is the i/i+1 average
    area_edge = torch.cumsum(count.flip(0), 0).flip(0) * cell
    g2int_edge = torch.cumsum(g2sum.flip(0), 0).flip(0) * cell
    area = 0.5 * (area_edge + _shift(area_edge))

    dQ = span / nbins
    # centered differences of the cumulative functions at bin centers
    dA_dQ = (_shift(area_edge) - area_edge) / dQ       # = -count*cell/dQ
    dG_dQ = (_shift(g2int_edge) - g2int_edge) / dQ
    # <|grad q|^2>_Q = dG/dA = dG_dQ / dA_dQ
    safe = torch.abs(dA_dQ) > 0
    mean_grad2 = torch.where(safe, dG_dQ / torch.where(safe, dA_dQ, 1.0),
                             0.0)
    le2 = mean_grad2 * dA_dQ * dA_dQ
    lmin2 = 4.0 * math.pi * area
    raw = torch.where((le2 > 0) & (lmin2 > 0),
                      le2 / torch.clamp(lmin2, min=1e-30), 1.0)
    return EffectiveDiffusivity(levels=levels, area=area,
                                equiv_length2=le2, min_length2=lmin2,
                                kappa_ratio=torch.clamp(raw, min=1.0),
                                kappa_ratio_raw=raw)
