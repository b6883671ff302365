"""Finite-difference barotropic core, the cross-check path: the
counterpart of xlab_fftbarotropic_tpu/models/fd_core.py.

The capability of the reference's main-jacobian.cpp (C16 in SURVEY.md
§2), which does not build there (a missing external header,
main-jacobian.cpp:4): an Arakawa-Jacobian advection core with a Poisson
solver and RK4, an independent numerical path to cross-validate the
spectral core. As in the JAX package, the boundaries are periodic
(torch.roll; the reference clamps edges), so the FD core solves the
same problem as the spectral core and converges to it under grid
refinement.

Numerics:
  * Arakawa (1966) 9-point Jacobian J(zeta, psi) / (12 dx dy), the
    energy- and enstrophy-conserving (J1+J2+J3)/3 form of
    main-jacobian.cpp:218-243;
  * 5-point Laplacian (main-jacobian.cpp:172-198, periodic here);
  * d zeta/dt = -J(psi, zeta) + nu lap(zeta) + S; u = -psi_y, v = psi_x;
  * the Poisson solve: poisson_fft, the exact inverse of the 5-point
    Laplacian through torch.fft (the JAX module's jnp.fft, outside any
    kernel), or poisson_jacobi, the reference's Jacobi relaxation with
    its relative-residual stopping rule (main-jacobian.cpp:137-170).

The JAX module runs the relaxation as a lax.while_loop on the device.
Here the sweeps run in chunks of JACOBI_CHUNK: each sweep is computed,
and once the stopping rule holds a device-side `done` flag freezes the
iterate, the residual and the sweep count through torch.where, so the
host reads one flag per chunk instead of syncing every sweep, and the
stopping sweep, and so the result, are the while_loop's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..config import ModelConfig
from .barotropic import resolve_device

# Jacobi sweeps between two host reads of the stopping flag
JACOBI_CHUNK = 64


def _roll(a: torch.Tensor, dx_: int, dy_: int) -> torch.Tensor:
    return torch.roll(a, shifts=(dx_, dy_), dims=(0, 1))


def laplacian5(a: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    """Periodic 5-point Laplacian."""
    return ((_roll(a, 1, 0) + _roll(a, -1, 0) - 2.0 * a) / (dx * dx)
            + (_roll(a, 0, 1) + _roll(a, 0, -1) - 2.0 * a) / (dy * dy))


def arakawa_jacobian(z: torch.Tensor, p: torch.Tensor, dx: float,
                     dy: float) -> torch.Tensor:
    """Arakawa's conserving J(z, p) = z_x p_y - z_y p_x: the (J1+J2+J3)/3
    form over the 9-point stencil, the reference's expanded expression
    divided by 12 dx dy (main-jacobian.cpp:218-243, 272-273)."""
    zp1 = _roll(z, -1, 0)   # z[i+1, j]
    zm1 = _roll(z, 1, 0)    # z[i-1, j]
    zq1 = _roll(z, 0, -1)   # z[i, j+1]
    zr1 = _roll(z, 0, 1)    # z[i, j-1]
    zpq = _roll(z, -1, -1)  # z[i+1, j+1]
    zpr = _roll(z, -1, 1)   # z[i+1, j-1]
    zmq = _roll(z, 1, -1)   # z[i-1, j+1]
    zmr = _roll(z, 1, 1)    # z[i-1, j-1]
    pp1 = _roll(p, -1, 0)
    pm1 = _roll(p, 1, 0)
    pq1 = _roll(p, 0, -1)
    pr1 = _roll(p, 0, 1)
    ppq = _roll(p, -1, -1)
    ppr = _roll(p, -1, 1)
    pmq = _roll(p, 1, -1)
    pmr = _roll(p, 1, 1)

    j1 = ((zp1 - zm1) * (pq1 - pr1) - (zq1 - zr1) * (pp1 - pm1))
    j2 = (zp1 * (ppq - ppr) - zm1 * (pmq - pmr)
          - zq1 * (ppq - pmq) + zr1 * (ppr - pmr))
    j3 = (zpq * (pq1 - pp1) - zmr * (pm1 - pr1)
          - zmq * (pq1 - pm1) + zpr * (pp1 - pr1))
    return (j1 + j2 + j3) / (12.0 * dx * dy)


def poisson_jacobi(rhs: torch.Tensor, dx: float, dy: float,
                   tol: float = 1e-6, max_iter: int = 10_000,
                   x0: Optional[torch.Tensor] = None,
                   chunk: int = JACOBI_CHUNK
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve lap(x) = rhs (periodic) by Jacobi relaxation; returns
    (x, sweeps), sweeps an int32 scalar tensor on rhs's device.

    The reference's jacobi_relaxation with its relative-residual
    stopping rule (main-jacobian.cpp:137-170): sweep while
    sweeps < max_iter and rms(lap x - rhs) / rms(rhs) > tol. The
    periodic problem needs mean(rhs) = 0: the mean is removed and the
    solution returned with zero mean. A NaN residual stops, as in the
    JAX loop's condition."""
    rhs = rhs - torch.mean(rhs)
    cx, cy = 1.0 / (dx * dx), 1.0 / (dy * dy)
    denom = 2.0 * (cx + cy)
    rhs_norm = torch.clamp(torch.sqrt(torch.mean(rhs * rhs)), min=1e-30)
    x = torch.zeros_like(rhs) if x0 is None else x0 - torch.mean(x0)
    sweeps = torch.zeros((), dtype=torch.int32, device=rhs.device)
    res = torch.full((), math.inf, dtype=rhs.dtype, device=rhs.device)
    done = torch.full((), max_iter <= 0, device=rhs.device)
    ran = 0
    while ran < max_iter and not bool(done):
        for _ in range(min(chunk, max_iter - ran)):
            nbr = (cx * (_roll(x, 1, 0) + _roll(x, -1, 0))
                   + cy * (_roll(x, 0, 1) + _roll(x, 0, -1)))
            xn = (nbr - rhs) / denom
            xn = xn - torch.mean(xn)
            r = laplacian5(xn, dx, dy) - rhs
            x = torch.where(done, x, xn)
            res = torch.where(done, res,
                              torch.sqrt(torch.mean(r * r)) / rhs_norm)
            sweeps = sweeps + (~done).to(torch.int32)
            done = (sweeps >= max_iter) | ~(res > tol)
        ran += chunk
    return x, sweeps


def poisson_fft(rhs: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    """The exact inverse of the periodic 5-point Laplacian through
    torch.fft: the stencil is diagonal in the DFT basis with eigenvalues
    -4 sin^2(pi i / nx)/dx^2 - 4 sin^2(pi j / ny)/dy^2, so one rfft2 /
    irfft2 pair inverts laplacian5 to round-off. The mean mode comes
    back zero."""
    nx, ny = rhs.shape
    dev = rhs.device
    i = torch.arange(nx, dtype=torch.float32, device=dev)
    j = torch.arange(ny // 2 + 1, dtype=torch.float32, device=dev)
    lam = ((-4.0 * torch.sin(math.pi * i / nx) ** 2 / (dx * dx))[:, None]
           + (-4.0 * torch.sin(math.pi * j / ny) ** 2 / (dy * dy))[None, :])
    lam[0, 0] = 1.0
    x_hat = torch.fft.rfft2(rhs) / lam
    x_hat[0, 0] = 0.0
    return torch.fft.irfft2(x_hat, s=(nx, ny)).to(rhs.dtype)


def gradients(psi: torch.Tensor, dx: float, dy: float):
    """Centered first derivatives; u = -psi_y, v = +psi_x."""
    psi_x = (_roll(psi, -1, 0) - _roll(psi, 1, 0)) / (2.0 * dx)
    psi_y = (_roll(psi, 0, -1) - _roll(psi, 0, 1)) / (2.0 * dy)
    return -psi_y, psi_x


class FDBarotropicModel:
    """RK4 FD stepper on one device; the state is the PHYSICAL vorticity
    (nx, ny) float32 and the carried psi.

    `step`:    zeta, psi_guess, src -> (zeta, psi) after ONE step;
    `segment`: the same after n steps, a Python loop.
    Each tendency solves Poisson (poisson_fft, or poisson_jacobi warm-
    started from the carried psi), forms the Arakawa Jacobian and adds
    5-point viscosity, as main-jacobian.cpp's evolution (:248-279) with
    periodic BCs. With solver 'jacobi' `sweeps` lists the sweep count of
    every solve so far (int32 tensors on the device).
    """

    def __init__(self, cfg: ModelConfig, device, tol: float = 1e-6,
                 max_iter: int = 10_000, solver: str = "fft"):
        if solver not in ("fft", "jacobi"):
            raise ValueError(f"unknown solver {solver!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tol = tol
        self.max_iter = max_iter
        self.solver = solver
        self.sweeps = []

    @classmethod
    def build(cls, cfg: ModelConfig, device, tol: float = 1e-6,
              max_iter: int = 10_000,
              solver: str = "fft") -> "FDBarotropicModel":
        """solver 'fft' (default): the exact FD inversion, poisson_fft;
        'jacobi': the reference's iterative relaxation."""
        return cls(cfg, device, tol, max_iter, solver)

    def _solve(self, rhs_z, guess):
        dx, dy = float(self.cfg.dx), float(self.cfg.dy)
        if self.solver == "fft":
            return poisson_fft(rhs_z, dx, dy)
        x, sweeps = poisson_jacobi(rhs_z, dx, dy, self.tol, self.max_iter,
                                   guess)
        self.sweeps.append(sweeps)
        return x

    def _rhs(self, zeta, psi):
        cfg = self.cfg
        dx, dy, nu = float(cfg.dx), float(cfg.dy), float(cfg.nu)
        r_drag, beta, nu4 = float(cfg.r_drag), float(cfg.beta), \
            float(cfg.nu4)
        out = -arakawa_jacobian(psi, zeta, dx, dy) \
            + nu * laplacian5(zeta, dx, dy)
        if r_drag != 0.0:
            # the same linear spin-down as the spectral cores
            out = out - r_drag * zeta
        if beta != 0.0:
            # beta-plane: -beta*v with v = psi_x, centered FD
            v = (torch.roll(psi, -1, dims=0) - torch.roll(psi, 1, dims=0)
                 ) / (2.0 * dx)
            out = out - beta * v
        if nu4 != 0.0:
            # biharmonic hyperviscosity: the iterated 5-point Laplacian
            out = out - nu4 * laplacian5(laplacian5(zeta, dx, dy), dx, dy)
        return out

    def _rk4(self, zeta, psi_guess, src):
        dt = float(self.cfg.dt)
        psi1 = self._solve(zeta, psi_guess)
        k1 = self._rhs(zeta, psi1) + src
        z = zeta + k1 * (dt * 0.5)
        psi2 = self._solve(z, psi1)
        k2 = self._rhs(z, psi2) + src
        z = zeta + k2 * (dt * 0.5)
        psi3 = self._solve(z, psi2)
        k3 = self._rhs(z, psi3) + src
        z = zeta + k3 * dt
        psi4 = self._solve(z, psi3)
        k4 = self._rhs(z, psi4) + src
        z_new = zeta + (k1 + 2 * k2 + 2 * k3 + k4) * (dt / 6.0)
        return z_new, psi4

    def step(self, zeta, psi_guess, src):
        return self._rk4(zeta, psi_guess, src)

    def segment(self, zeta, psi_guess, src, n_steps: int):
        z, p = zeta, psi_guess
        for _ in range(n_steps):
            z, p = self._rk4(z, p, src)
        return z, p

    def init_psi(self, zeta) -> torch.Tensor:
        return torch.zeros_like(torch.as_tensor(zeta, dtype=torch.float32,
                                                device=self.device))

    def zero_source(self) -> torch.Tensor:
        return torch.zeros(self.cfg.grid_shape, dtype=torch.float32,
                           device=self.device)
