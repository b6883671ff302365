"""Passive-tracer barotropic family: the counterpart of
xlab_fftbarotropic_tpu/models/tracer.py.

A scalar q is co-advected with the barotropic flow:

    d zeta/dt = -u.grad(zeta) + S + nu    * lap(zeta)   (main.cpp:225-243)
    d q   /dt = -u.grad(q)        + kappa * lap(q)      (passive: no feedback)

with drag, beta and hyperviscosity on the flow only. Both tendencies
follow the reference numerics contract (SURVEY.md §5): spectral
gradients with positive-Nyquist tables, advection products in physical
space, forward transform, spectral diffusion from the stage state,
dealiased tendencies, classic RK4 with the forcing fixed across stages.

Two stepping paths, chosen by cfg.fft_backend as for the barotropic
family ("auto" takes the same shape gate):

* "pallas", the plane stepper (ops/fused_tracer.py): the state moves as
  stacked float32 planes (2, nx, hny) through ka6, two kb_pair,
  kb_adv_tracer and kx_visc per stage, plus one rk4_combine per step.
  Diffusion, drag and hyperviscosity ride the stacked table
  lap2 = [nu*lap - r_drag - nu4*lap^2 | kappa*lap].
* "xla", the library path (tendency / rk4_step) on torch.fft.

The diagnostics always use the library path. cfg.time_scheme "etdrk4"
integrates the flow operator (nu lap - r_drag - nu4 lap^2, the beta term
in complex tables) and kappa lap exactly (models/etdrk4.py, stacked
tables (2, nx, hny)); N is the joint advection-only tendency, on the
plane stepper's kernels with a zero lap2 or on torch.fft.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import fft
from ..ops import fused_tracer as ft
from ..ops import spectral as sp
from ..ops.spectral import SpectralTables
from . import etdrk4 as etd
from .barotropic import (_paired, check_time_scheme, resolve_device,
                         resolve_fft_backend_name)


class TracerState(NamedTuple):
    zeta_hat: torch.Tensor   # (nx, hny) complex64, unnormalized (FFTW fwd)
    q_hat: torch.Tensor      # (nx, hny) complex64


class TracerDiagFields(NamedTuple):
    vort: torch.Tensor
    psi: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    q: torch.Tensor


class TracerStats(NamedTuple):
    max_abs_vort: torch.Tensor
    energy: torch.Tensor
    enstrophy: torch.Tensor
    cfl: torch.Tensor
    q_mean: torch.Tensor     # conserved by advection + diffusion
    q_var: torch.Tensor      # population variance, as jnp.var


def tendency(t: SpectralTables, state: TracerState, src: torch.Tensor,
             nu: float, kappa: float, grid_shape: Tuple[int, int],
             fwd: Callable = fft.forward, inv: Callable = fft.inverse,
             inv_pair: Optional[Callable] = fft.inverse_pair,
             r_drag: float = 0.0, beta: float = 0.0,
             nu4: float = 0.0) -> TracerState:
    """Un-dealiased joint tendency: six inverse transforms paired into
    three, two forward, through `fwd`, `inv`,
    `inv_pair` (torch.fft by default; models/barotropic.py:
    resolve_fft_backend). Zero nu, kappa, r_drag, beta and nu4 skip their
    terms."""
    pair = _paired(inv, inv_pair)
    zeta_hat, q_hat = state
    lvort_hat = (sp.laplacian(t, zeta_hat)
                 if nu != 0.0 or nu4 != 0.0 else None)
    lq_hat = sp.laplacian(t, q_hat) if kappa != 0.0 else None
    psi_hat = sp.invert_laplacian(t, zeta_hat)
    dvdx, dvdy = pair(sp.gradx(t, zeta_hat), sp.grady(t, zeta_hat),
                      grid_shape)
    u, v = pair(-sp.grady(t, psi_hat), sp.gradx(t, psi_hat), grid_shape)
    dqdx, dqdy = pair(sp.gradx(t, q_hat), sp.grady(t, q_hat), grid_shape)
    if beta != 0.0:
        # -beta*v on the flow, folded into the advection product; the
        # tracer is advected by the beta-plane flow with no planetary term
        dvdy = dvdy + beta
    dzeta = fwd(-u * dvdx - v * dvdy + src)
    if nu != 0.0:
        dzeta = dzeta + lvort_hat * nu
    if r_drag != 0.0:
        dzeta = dzeta - zeta_hat * r_drag
    if nu4 != 0.0:
        dzeta = dzeta - sp.laplacian(t, lvort_hat) * nu4
    dq = fwd(-u * dqdx - v * dqdy)
    if kappa != 0.0:
        dq = dq + lq_hat * kappa
    return TracerState(dzeta, dq)


def rk4_step(t: SpectralTables, state: TracerState, src: torch.Tensor,
             dt: float, nu: float, kappa: float,
             grid_shape: Tuple[int, int], fwd: Callable = fft.forward,
             inv: Callable = fft.inverse,
             inv_pair: Optional[Callable] = fft.inverse_pair,
             r_drag: float = 0.0, beta: float = 0.0,
             nu4: float = 0.0) -> TracerState:
    """Joint RK4 (main.cpp:286-317 structure) on `tendency`; both stage
    tendencies dealiased, the states never; src fixed."""
    def dl(s):
        r = tendency(t, s, src, nu, kappa, grid_shape, fwd=fwd, inv=inv,
                     inv_pair=inv_pair, r_drag=r_drag, beta=beta, nu4=nu4)
        return TracerState(sp.dealias(t, r.zeta_hat),
                           sp.dealias(t, r.q_hat))

    def axpy(a, r, c):
        return TracerState(a.zeta_hat + r.zeta_hat * c,
                           a.q_hat + r.q_hat * c)

    r1 = dl(state)
    r2 = dl(axpy(state, r1, dt * 0.5))
    r3 = dl(axpy(state, r2, dt * 0.5))
    r4 = dl(axpy(state, r3, dt))
    c = dt / 6.0
    return TracerState(
        state.zeta_hat + (r1.zeta_hat + 2 * r2.zeta_hat
                          + 2 * r3.zeta_hat + r4.zeta_hat) * c,
        state.q_hat + (r1.q_hat + 2 * r2.q_hat
                       + 2 * r3.q_hat + r4.q_hat) * c)


def etd_step(t: SpectralTables, tabs, state: TracerState,
             src: torch.Tensor, grid_shape: Tuple[int, int]) -> TracerState:
    """One ETDRK4 step on the library path: N is the joint dealiased
    advection-only tendency, the stacked tables apply per field."""
    def N(s):
        d = tendency(t, s, src, 0.0, 0.0, grid_shape)
        return TracerState(sp.dealias(t, d.zeta_hat), sp.dealias(t, d.q_hat))

    def mul(T, s):
        return TracerState(T[0] * s.zeta_hat, T[1] * s.q_hat)
    return etd.etd_scheme(N, mul, tabs, state)


def etd_step_planes(t: SpectralTables, tabs, sr2: torch.Tensor,
                    si2: torch.Tensor, src_y: torch.Tensor):
    """One ETDRK4 step on the stacked planes (2, nx, hny) through the
    tracer plane stepper's kernels, with a zero diffusion table (every
    linear term lives in the ETD tables) and beta = 0."""
    lap2z = torch.zeros_like(sr2)

    def N(q):
        return ft.tendency_tracer_planes(q[0], q[1], src_y, t.kx, t.ky,
                                         t.rlap, lap2z, t.mask)
    return etd.etd_scheme(N, lambda T, q: etd.smul_planes(T, *q), tabs,
                          (sr2, si2))


def tracer_ic(cfg, kind: str, vort0: Optional[np.ndarray] = None
              ) -> np.ndarray:
    """Built-in tracer initial conditions (smooth and periodic), numpy
    float32 (nx, ny), bit-identical to the JAX package's tracer_ic:

    vorticity   q0 = the initial vorticity itself
    zonal       q0 = sin(2 pi x / Lx)
    meridional  q0 = sin(2 pi y / Ly)
    gaussian    q0 = exp(-(r/60km)^2), a blob at the domain centre
    """
    x, y = cfg.coords()
    X = np.asarray(x)[:, None]
    Y = np.asarray(y)[None, :]
    if kind == "vorticity":
        if vort0 is None:
            raise ValueError("tracer_ic('vorticity') needs vort0")
        return np.asarray(vort0, np.float32)
    if kind == "zonal":
        q = np.sin(2 * np.pi * X / cfg.lx) * np.ones_like(Y)
    elif kind == "meridional":
        q = np.sin(2 * np.pi * Y / cfg.ly) * np.ones_like(X)
    elif kind == "gaussian":
        r2 = (X - cfg.lx / 2) ** 2 + (Y - cfg.ly / 2) ** 2
        q = np.exp(-r2 / 60e3 ** 2)
    else:
        raise ValueError(f"unknown tracer IC {kind!r}")
    return q.astype(np.float32)


class TracerModel(nn.Module):
    """The joint stepper for one configuration on one device.

    `step`:    state, src -> state after ONE step (RK4 or ETDRK4).
    `segment`: state, src -> state after n steps, a Python loop with
               the forcing fixed (and, on the plane stepper, transposed
               to y-major once).
    `diags`:   state -> TracerDiagFields;  `stats`: state -> TracerStats.

    `tables` (buffers) serve both paths; `lap2` (a buffer, (2, nx, hny))
    is the plane stepper's stacked diffusion table.
    """

    def __init__(self, cfg, device, kappa: float = 0.0,
                 tables: SpectralTables = None):
        super().__init__()
        check_time_scheme(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = resolve_fft_backend_name(cfg.fft_backend,
                                                cfg.grid_shape)
        self.tables = (tables if tables is not None
                       else SpectralTables.from_config(cfg, self.device))
        self.dt = float(cfg.dt)
        self.nu = float(cfg.nu)
        self.kappa = float(kappa)
        self.r_drag = float(cfg.r_drag)
        self.beta = float(cfg.beta)
        self.nu4 = float(cfg.nu4)
        lap = self.tables.lap
        self.register_buffer("lap2", torch.stack(
            [lap * self.nu - self.r_drag - self.nu4 * lap * lap,
             lap * self.kappa]))
        self.etd_tables = (etd.build_scalar_tables(
            cfg, self.dt, kind="tracer", kappa=self.kappa,
            device=self.device) if cfg.time_scheme == "etdrk4" else None)

    @classmethod
    def build(cls, cfg, device, kappa: float = 0.0,
              tables: SpectralTables = None) -> "TracerModel":
        return cls(cfg, device, kappa, tables)

    def _check_state(self, state: TracerState) -> None:
        for z in state:
            if (z.dtype != torch.complex64
                    or tuple(z.shape) != self.cfg.spectral_shape
                    or z.device != self.device):
                raise ValueError(
                    f"state fields must be complex64 "
                    f"{self.cfg.spectral_shape} on {self.device}, got "
                    f"{z.dtype} {tuple(z.shape)} on {z.device}")

    def segment(self, state: TracerState, src: torch.Tensor,
                n_steps: int) -> TracerState:
        self._check_state(state)
        t, et, g = self.tables, self.etd_tables, self.cfg.grid_shape
        if self.backend == "pallas":
            sr2 = torch.stack([state.zeta_hat.real, state.q_hat.real])
            si2 = torch.stack([state.zeta_hat.imag, state.q_hat.imag])
            src_y = src.t().contiguous()
            for _ in range(n_steps):
                if et is not None:
                    sr2, si2 = etd_step_planes(t, et, sr2, si2, src_y)
                else:
                    sr2, si2 = ft.rk4_step_tracer_planes(
                        t, sr2, si2, src_y, self.dt, self.lap2,
                        beta=self.beta)
            return TracerState(torch.complex(sr2[0], si2[0]),
                               torch.complex(sr2[1], si2[1]))
        for _ in range(n_steps):
            if et is not None:
                state = etd_step(t, et, state, src, g)
            else:
                state = rk4_step(t, state, src, self.dt, self.nu,
                                 self.kappa, g, r_drag=self.r_drag,
                                 beta=self.beta, nu4=self.nu4)
        return state

    def step(self, state: TracerState, src: torch.Tensor) -> TracerState:
        return self.segment(state, src, 1)

    def diags(self, state: TracerState) -> TracerDiagFields:
        t, g = self.tables, self.cfg.grid_shape
        psi_hat = sp.invert_laplacian(t, state.zeta_hat)
        u_hat, v_hat = sp.velocities(t, psi_hat)
        return TracerDiagFields(
            vort=fft.inverse(state.zeta_hat, g), psi=fft.inverse(psi_hat, g),
            u=fft.inverse(u_hat, g), v=fft.inverse(v_hat, g),
            q=fft.inverse(state.q_hat, g))

    def stats(self, state: TracerState) -> TracerStats:
        cfg, t, g = self.cfg, self.tables, self.cfg.grid_shape
        psi_hat = sp.invert_laplacian(t, state.zeta_hat)
        u_hat, v_hat = sp.velocities(t, psi_hat)
        u, v = fft.inverse(u_hat, g), fft.inverse(v_hat, g)
        vort = fft.inverse(state.zeta_hat, g)
        q = fft.inverse(state.q_hat, g)
        return TracerStats(
            max_abs_vort=torch.max(torch.abs(vort)),
            energy=0.5 * torch.mean(u * u + v * v),
            enstrophy=0.5 * torch.mean(vort * vort),
            cfl=torch.max(torch.abs(u) / cfg.dx + torch.abs(v) / cfg.dy)
            * self.dt,
            q_mean=torch.mean(q),
            q_var=torch.var(q, correction=0))

    def init_state(self, vort0, q0) -> TracerState:
        """Physical initial vorticity and tracer -> spectral state."""
        def spec(a):
            return fft.forward(torch.as_tensor(a, dtype=torch.float32,
                                               device=self.device))
        return TracerState(spec(vort0), spec(q0))

    def zero_source(self) -> torch.Tensor:
        return torch.zeros(self.cfg.grid_shape, dtype=torch.float32,
                           device=self.device)
