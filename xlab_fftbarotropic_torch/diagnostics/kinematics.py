"""Kinematic flow diagnostics, filamentation time and deformation factor:
the counterpart of xlab_fftbarotropic_tpu/diagnostics/kinematics.py.

These two (and the effective eddy diffusivity, eddy_diffusivity.py) are
advertised in the reference README (README.md:4-7) but implemented
nowhere in the reference code (SURVEY.md §5.10-7); the JAX package
designed them from the cited literature. With u = -psi_y, v = +psi_x:

    S1 = u_x - v_y   (stretching deformation)
    S2 = v_x + u_y   (shearing deformation)
    zeta = v_x - u_y (relative vorticity)

* Filamentation time (Rozoff, Schubert, McNoldy & Kossin 2006, JAS 63,
  eq. 12): tau_fil = 2 / sqrt(S1^2 + S2^2 - zeta^2) where the flow is
  strain-dominated (S1^2 + S2^2 > zeta^2), +inf elsewhere.
* Deformation factor (Hsu; no public spec): the strain-to-vorticity
  ratio D = sqrt(S1^2 + S2^2) / (|zeta| + eps); D^2 - 1 has the sign of
  the Okubo-Weiss parameter OW = S1^2 + S2^2 - zeta^2, also exposed.

Every function takes the spectral vorticity state (nx, ny//2+1) complex64
and returns physical (nx, ny) float32 fields on its device. The inverse
transforms are a (forward, inverse, inverse_pair) triple,
models/barotropic.resolve_fft_backend's (the per-transform kernels under
`auto` on the grids they take, their plain versions on a CPU tensor;
torch.fft when None). The JAX module inverts the four gradients one by
one (kinematics.py:62-67); here they go as two inverse_pairs, (u_x, u_y)
and (v_x, v_y): the same values to float32 rounding (the test holds them
to the JAX module within 1e-5 of the field's largest magnitude), and on
the kernels LAUNCHES_PER_CALL per call.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..models.barotropic import resolve_fft_backend
from ..ops import spectral as sp
from ..ops.spectral import SpectralTables

# kernel launches of one velocity_gradients (and so of one okubo_weiss,
# filamentation_time or deformation_factor) on the kernel path: two
# inverse_pair (2 ka + kb each)
LAUNCHES_PER_CALL = {"ka": 4, "kb": 2, "kc": 0}


class VelocityGradients(NamedTuple):
    u_x: torch.Tensor
    u_y: torch.Tensor
    v_x: torch.Tensor
    v_y: torch.Tensor


def velocity_gradients(t: SpectralTables, zeta_hat: torch.Tensor,
                       grid_shape, transforms=None) -> VelocityGradients:
    """u_x, u_y, v_x, v_y from the spectral vorticity via psi = lap^-1
    zeta."""
    if transforms is None:
        transforms = resolve_fft_backend("xla", grid_shape)
    inverse_pair = transforms[2]
    psi_hat = sp.invert_laplacian(t, zeta_hat)
    u_hat, v_hat = sp.velocities(t, psi_hat)
    u_x, u_y = inverse_pair(sp.gradx(t, u_hat), sp.grady(t, u_hat),
                            grid_shape)
    v_x, v_y = inverse_pair(sp.gradx(t, v_hat), sp.grady(t, v_hat),
                            grid_shape)
    return VelocityGradients(u_x=u_x, u_y=u_y, v_x=v_x, v_y=v_y)


def strain_vorticity(g: VelocityGradients
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(S1, S2, zeta) from velocity gradients."""
    s1 = g.u_x - g.v_y
    s2 = g.v_x + g.u_y
    zeta = g.v_x - g.u_y
    return s1, s2, zeta


def okubo_weiss(t: SpectralTables, zeta_hat: torch.Tensor, grid_shape,
                transforms=None) -> torch.Tensor:
    """OW = S1^2 + S2^2 - zeta^2 (> 0: strain-dominated)."""
    s1, s2, zeta = strain_vorticity(
        velocity_gradients(t, zeta_hat, grid_shape, transforms))
    return s1 * s1 + s2 * s2 - zeta * zeta


def filamentation_time(t: SpectralTables, zeta_hat: torch.Tensor,
                       grid_shape, transforms=None) -> torch.Tensor:
    """Rozoff et al. 2006 eq. 12: tau_fil = 2/sqrt(S^2 - zeta^2) where
    S^2 > zeta^2; +inf elsewhere (vorticity-dominated)."""
    ow = okubo_weiss(t, zeta_hat, grid_shape, transforms)
    strain = ow > 0.0
    return torch.where(strain,
                       2.0 / torch.sqrt(torch.where(strain, ow, 1.0)),
                       torch.inf)


def deformation_factor(t: SpectralTables, zeta_hat: torch.Tensor,
                       grid_shape, eps: float = 1e-12,
                       transforms=None) -> torch.Tensor:
    """D = sqrt(S1^2+S2^2) / (|zeta| + eps); strain-to-vorticity ratio."""
    s1, s2, zeta = strain_vorticity(
        velocity_gradients(t, zeta_hat, grid_shape, transforms))
    return torch.sqrt(s1 * s1 + s2 * s2) / (torch.abs(zeta) + eps)
