"""Rotating shallow-water model: the counterpart of
xlab_fftbarotropic_tpu/models/shallow_water.py, with its two time
schemes: classic RK4 and ETDRK4 (models/etdrk4.py), chosen by
cfg.time_scheme.

Vorticity-divergence-height form on the doubly-periodic f-plane, with
q = zeta + f, h = H + eta (eta, the depth perturbation, is prognostic)
and Phi = g*eta + (u^2 + v^2)/2:

    d zeta / dt = -div(q u_vec)            + nu lap(zeta) + S
    d delta/ dt =  curl_z(q u_vec) - lap(Phi) + nu lap(delta)
    d eta  / dt = -H delta - div(eta u_vec)

with u = -psi_y + chi_x, v = psi_x + chi_y, lap(psi) = zeta,
lap(chi) = delta. Half-spectrum state (zeta_hat, div_hat, eta_hat),
complex64 (nx, ny//2+1); each stage tendency is dealiased, the state
never; the forcing S feeds the vorticity equation only and is fixed
across the stages.

Three stepping paths, chosen once when the model is built:

* "pallas", the plane stepper (rk4_step_planes): the state moves as six
  float32 planes through ka_sw, two kb_pair, ky_all, kx_fwd and
  sw_combine per stage (ops/fused_sw.py), the stage axpy fused into
  sw_combine for stages 1-3 and the RK4 tail one rk4_combine: 25
  launches per step, plus ka and kc once per segment for the forcing
  spectrum. fused_rk=False is the unfused form (the JAX package's
  XFB_SW_FUSED_RK=0): sw_combine without its axpy and three plane_axpy
  launches per step. yfirst=False is the x-first order (the JAX
  package's XFB_SW_YFIRST=0): two kb (x-major fields), ka_fwd and kc_sw
  in place of the two kb_pair, ky_all and kx_fwd, in both RK4 forms and
  under ETDRK4. On a CUDA device they are the hand-written kernels; on
  the CPU, their plain torch versions.
* "pallas" under RK4 with r_drag or nu4 != 0, the per-transform path:
  the plane stepper carries neither (its lap table also serves the
  pressure term and the mean-mode guard, so the barotropic fold would
  corrupt it), so the library tendency runs on the per-transform
  kernels (ops/fused_fft.py rfft2, irfft2, inverse_pair: ka, kb, kc),
  as the JAX package falls back to its per-transform pipeline there,
  with the same warning: per stage two inverse_pair and six forward
  transforms (five products and the forcing), 10 ka, 2 kb and 6 kc.
* "xla", the library path (tendency / rk4_step) on torch.fft.

"auto" takes "pallas" on the square power-of-two grids the kernels take
(64..8192), else "xla". Under ETDRK4 drag and hyperviscosity live in the
linear tables, so the plane path takes them (etdrk4_step_planes: 4
ka_sw, 8 kb_pair, 4 ky_all, 4 kx_fwd and 4 sw_combine_mv per step in the
default fused form).
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import fft
from ..ops import fused_sw as fs
from ..ops import spectral as sp
from ..ops.spectral import SpectralTables
from . import etdrk4 as etd
from .barotropic import (DebugFields, _paired, check_time_scheme,
                         resolve_device, resolve_fft_backend,
                         resolve_fft_backend_name)

# the library path pairs the forward transforms up to this size, as the
# JAX package does (its XFB_FORWARD_PAIR_MAX default, a TPU measurement)
FORWARD_PAIR_MAX = 1024


class SWState(NamedTuple):
    """Half-spectrum prognostic state, all complex64 (nx, ny//2+1)."""
    zeta_hat: torch.Tensor
    div_hat: torch.Tensor
    eta_hat: torch.Tensor     # depth perturbation about cfg.mean_depth


class SWDiagFields(NamedTuple):
    vort: torch.Tensor
    div: torch.Tensor
    h: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    psi: torch.Tensor


class SWStats(NamedTuple):
    mass: torch.Tensor
    energy: torch.Tensor
    pot_enstrophy: torch.Tensor
    max_abs_div: torch.Tensor
    cfl: torch.Tensor


def sw_velocities(t: SpectralTables, zeta_hat: torch.Tensor,
                  div_hat: torch.Tensor):
    """Helmholtz: u_hat = -i ky psi_hat + i kx chi_hat, v_hat mirrored."""
    psi_hat = sp.invert_laplacian(t, zeta_hat)
    chi_hat = sp.invert_laplacian(t, div_hat)
    u_hat = -sp.grady(t, psi_hat) + sp.gradx(t, chi_hat)
    v_hat = sp.gradx(t, psi_hat) + sp.grady(t, chi_hat)
    return u_hat, v_hat


def tendency(t: SpectralTables, s: SWState, src, f: float, g: float,
             nu: float, mean_depth: float, grid_shape: Tuple[int, int],
             fwd: Callable = fft.forward, inv: Callable = fft.inverse,
             inv_pair: Optional[Callable] = fft.inverse_pair,
             fwd_pair: bool = False, split: bool = False,
             r_drag: float = 0.0, nu4: float = 0.0) -> SWState:
    """Un-dealiased spectral tendencies of (zeta, delta, eta): the four
    inverse transforms paired into two, through `fwd`, `inv`, `inv_pair`
    (torch.fft by default, or the per-transform kernels); with fwd_pair
    (torch.fft only) the flux pairs (qu, qv) and (eta u, eta v) go
    through one complex fft2 each. split applies the exactly linear
    f0/gravity terms as spectral multiplies instead of through the
    transforms. Zero r_drag and nu4 skip their terms; src None skips the
    forcing."""
    pair = _paired(inv, inv_pair)
    u_hat, v_hat = sw_velocities(t, s.zeta_hat, s.div_hat)
    u, v = pair(u_hat, v_hat, grid_shape)
    zeta, eta = pair(s.zeta_hat, s.eta_hat, grid_shape)
    q = zeta if split else zeta + f
    if fwd_pair:
        qu_hat, qv_hat = fft.forward_pair(q * u, q * v)
        eu_hat, ev_hat = fft.forward_pair(eta * u, eta * v)
    else:
        qu_hat, qv_hat = fwd(q * u), fwd(q * v)
        eu_hat, ev_hat = fwd(eta * u), fwd(eta * v)
    ke = 0.5 * (u * u + v * v)
    phi_hat = fwd(ke if split else g * eta + ke)

    dzeta = -(sp.gradx(t, qu_hat) + sp.grady(t, qv_hat)) \
        + nu * sp.laplacian(t, s.zeta_hat)
    if src is not None:
        dzeta = dzeta + fwd(src)
    ddiv = (sp.gradx(t, qv_hat) - sp.grady(t, qu_hat)) \
        - sp.laplacian(t, phi_hat) + nu * sp.laplacian(t, s.div_hat)
    deta = -(sp.gradx(t, eu_hat) + sp.grady(t, ev_hat)) \
        - mean_depth * s.div_hat
    if split:
        # zero at the mean mode, where curl_z and div of f*u_vec vanish
        fz = f * (t.lap != 0.0).to(t.lap.dtype)
        dzeta = dzeta - fz * s.div_hat
        ddiv = ddiv + fz * s.zeta_hat - g * sp.laplacian(t, s.eta_hat)
    if r_drag != 0.0:
        dzeta = dzeta - r_drag * s.zeta_hat
        ddiv = ddiv - r_drag * s.div_hat
    if nu4 != 0.0:
        l2 = t.lap * t.lap
        dzeta = dzeta - nu4 * l2 * s.zeta_hat
        ddiv = ddiv - nu4 * l2 * s.div_hat
    return SWState(zeta_hat=dzeta, div_hat=ddiv, eta_hat=deta)


def _dealias_state(t: SpectralTables, s: SWState) -> SWState:
    return SWState(*(sp.dealias(t, a) for a in s))


def _axpy(s0: SWState, k: SWState, a: float) -> SWState:
    return SWState(*(x + y * a for x, y in zip(s0, k)))


def rk4_step(t: SpectralTables, s: SWState, src, dt: float, f: float,
             g: float, nu: float, mean_depth: float,
             grid_shape: Tuple[int, int], fwd: Callable = fft.forward,
             inv: Callable = fft.inverse,
             inv_pair: Optional[Callable] = fft.inverse_pair,
             fwd_pair: bool = False, split: bool = False,
             r_drag: float = 0.0, nu4: float = 0.0) -> SWState:
    """Classic RK4 with per-stage dealiased tendencies (main.cpp:286-317)
    on `tendency`, the library path or the per-transform kernels."""
    def d(x):
        return _dealias_state(t, tendency(
            t, x, src, f, g, nu, mean_depth, grid_shape, fwd=fwd, inv=inv,
            inv_pair=inv_pair, fwd_pair=fwd_pair, split=split,
            r_drag=r_drag, nu4=nu4))

    k1 = d(s)
    k2 = d(_axpy(s, k1, dt * 0.5))
    k3 = d(_axpy(s, k2, dt * 0.5))
    k4 = d(_axpy(s, k3, dt))
    comb = SWState(*(a + 2.0 * b + 2.0 * c + e
                     for a, b, c, e in zip(k1, k2, k3, k4)))
    return _axpy(s, comb, dt / 6.0)


def rk4_step_planes(t: SpectralTables, planes, src_planes, dt: float,
                    f: float, g: float, nu: float, mean_depth: float,
                    eta_scale: float, fused_rk: bool = True,
                    yfirst: bool = True):
    """RK4 on the state as six float32 planes (zr, zi, dr, di, er, ei)
    through the SW kernels, in the y-first order or, yfirst False, the
    x-first one. fused_rk=True, the JAX default (XFB_SW_FUSED_RK=1):
    stages 1-3 take the next stage state from sw_combine's axpy;
    fused_rk=False: from a plane_axpy launch. Either way the tail is one
    plane_rk4_combine, and the two forms give the same bits. src_planes
    is the forcing spectrum (or None), eta_scale the pairing equalizer,
    both fixed across the stages."""
    def d(p, axpy=None):
        u, v, zeta, eta_s = fs.inverse_quad_planes(*p, t.kx, t.ky, t.rlap,
                                                   eta_scale, yfirst)
        return fs.forward_tendencies(u, v, zeta, eta_s, p, src_planes,
                                     t.kx, t.ky, t.lap, t.mask, f, g, nu,
                                     mean_depth, eta_scale, axpy=axpy,
                                     yfirst=yfirst)

    h = dt * 0.5
    if fused_rk:
        r1, s2 = d(planes, axpy=(planes, h))
        r2, s3 = d(s2, axpy=(planes, h))
        r3, s4 = d(s3, axpy=(planes, dt))
    else:
        r1 = d(planes)
        r2 = d(fs.plane_axpy(planes, r1, h))
        r3 = d(fs.plane_axpy(planes, r2, h))
        s4 = fs.plane_axpy(planes, r3, dt)
    r4 = d(s4)
    return fs.plane_rk4_combine(planes, r1, r2, r3, r4, dt / 6.0)


def state_to_planes(s: SWState):
    return tuple(p.contiguous() for z in s for p in (z.real, z.imag))


def planes_to_state(p) -> SWState:
    return SWState(torch.complex(p[0], p[1]), torch.complex(p[2], p[3]),
                   torch.complex(p[4], p[5]))


def max_stable_dt(cfg) -> float:
    """The RK4 gravity-wave bound with a 0.9 safety factor:
    |omega_max dt| <= 2 sqrt(2) for omega_max = sqrt(g H) k_max,
    k_max = pi hypot(nx/lx, ny/ly) (positive Nyquist). 0.847 s at 4096²
    with the defaults, where dt = 3 s NaNs."""
    c = math.sqrt(float(cfg.gravity) * float(cfg.mean_depth))
    k_max = math.pi * math.hypot(cfg.nx / float(cfg.lx),
                                 cfg.ny / float(cfg.ly))
    return 0.9 * 2.0 * math.sqrt(2.0) / (c * k_max)


def per_transform(cfg, backend: str) -> bool:
    """True where the SW kernels run the per-transform path: RK4 with
    r_drag or nu4 != 0 on the kernel backend."""
    return backend == "pallas" and cfg.time_scheme != "etdrk4" and (
        float(cfg.r_drag) != 0.0 or float(cfg.nu4) != 0.0)


def resolve_sw_backend(cfg, warn: bool = True) -> str:
    """The stepping backend for a SW configuration, decided once: the
    barotropic shape gate. Under RK4 with r_drag or nu4 != 0 the kernel
    backend takes the per-transform path, with the JAX package's
    warning."""
    name = resolve_fft_backend_name(cfg.fft_backend, cfg.grid_shape)
    if warn and per_transform(cfg, name):
        warnings.warn(
            "r_drag/nu4 != 0: the fused SW plane stepper does not carry "
            "these terms — falling back to the per-transform pipeline for "
            "this run", stacklevel=3)
    return name


class ShallowWaterModel(nn.Module):
    """The SW stepper for one configuration on one device.

    `step`:    state, src -> state after ONE step (RK4 or ETDRK4).
    `segment`: state, src -> state after n steps, a Python loop; on
               the plane stepper the forcing spectrum (src None: no
               forcing) and the pairing equalizer eta_scale are computed
               once per call, eta_scale read to the host.
    `diags`:   state -> SWDiagFields;  `stats`: state -> SWStats;
    `debug`:   state, src -> DebugFields.

    `tables` (buffers) serve every path. `backend` is decided once
    (resolve_sw_backend); on "pallas" under RK4 with r_drag or nu4 != 0
    `per_transform` is set and the steps run rk4_step on the
    per-transform kernels, with a warning. `fused_rk` picks the plane
    stepper's RK4 form (rk4_step_planes; True the JAX default), `yfirst`
    its transform order under both schemes (True the JAX default,
    XFB_SW_YFIRST=1). beta != 0
    raises; under RK4 dt above max_stable_dt warns, as in the JAX
    package.

    time_scheme "etdrk4": `etd_tables` (models/etdrk4.py, through its
    disk cache, built on `device`) and a step of etdrk4_step_planes
    (plane path; `etd_fuse` picks its form, True the JAX default
    XFB_SW_ETD_FUSE=1) or etdrk4_step (library path).
    """

    def __init__(self, cfg, device, tables: SpectralTables = None,
                 etd_fuse: bool = True, fused_rk: bool = True,
                 yfirst: bool = True):
        super().__init__()
        check_time_scheme(cfg)
        if float(cfg.beta) != 0.0:
            raise NotImplementedError(
                "beta-plane is barotropic/tracer-only: the SW equations "
                "need the spatially varying f inside curl(f u)/div(f u) "
                "(config.py beta note)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dt = float(cfg.dt)
        self.nu = float(cfg.nu)
        self.f = float(cfg.f)
        self.g = float(cfg.gravity)
        self.H = float(cfg.mean_depth)
        self.r_drag = float(cfg.r_drag)
        self.nu4 = float(cfg.nu4)
        self.etd_fuse = etd_fuse
        self.fused_rk = fused_rk
        self.yfirst = yfirst
        dt_max = max_stable_dt(cfg)
        if self.dt > dt_max and cfg.time_scheme != "etdrk4":
            warnings.warn(
                f"SW gravity-wave CFL violated: dt={self.dt:g} s exceeds the "
                f"RK4 stability bound {dt_max:.3g} s for c=sqrt(gH)="
                f"{(self.g * self.H) ** 0.5:.1f} m/s at {cfg.nx}x{cfg.ny} — "
                "the run will blow up; reduce dt (verified NaN at 4096^2 "
                "with dt=3), or use --time-scheme etdrk4 (exact linear "
                "waves; only the advective CFL remains)", stacklevel=2)
        self.backend = resolve_sw_backend(cfg)
        self.per_transform = per_transform(cfg, self.backend)
        self.fwd_pair = (self.backend == "xla"
                         and max(cfg.grid_shape) <= FORWARD_PAIR_MAX)
        self.tables = (tables if tables is not None
                       else SpectralTables.from_config(cfg, self.device))
        mean_mask = np.ones(cfg.spectral_shape, np.float32)
        mean_mask[0, 0] = 0.0
        self.register_buffer("mean_mask",
                             torch.from_numpy(mean_mask).to(self.device))
        self.etd_tables = (etd.build_tables_cached(cfg, self.dt, self.device)
                           if cfg.time_scheme == "etdrk4" else None)

    @classmethod
    def build(cls, cfg, device, tables: SpectralTables = None,
              etd_fuse: bool = True, fused_rk: bool = True,
              yfirst: bool = True) -> "ShallowWaterModel":
        return cls(cfg, device, tables, etd_fuse, fused_rk, yfirst)

    def _check_state(self, s: SWState) -> None:
        for z in s:
            if (z.dtype != torch.complex64
                    or tuple(z.shape) != self.cfg.spectral_shape
                    or z.device != self.device):
                raise ValueError(
                    f"state fields must be complex64 "
                    f"{self.cfg.spectral_shape} on {self.device}, got "
                    f"{z.dtype} {tuple(z.shape)} on {z.device}")

    def segment(self, s: SWState, src, n_steps: int) -> SWState:
        self._check_state(s)
        t, et = self.tables, self.etd_tables
        if self.per_transform:
            fwd, inv, inv_pair = resolve_fft_backend("pallas",
                                                     self.cfg.grid_shape)
            for _ in range(n_steps):
                s = rk4_step(t, s, src, self.dt, self.f, self.g, self.nu,
                             self.H, self.cfg.grid_shape, fwd=fwd, inv=inv,
                             inv_pair=inv_pair, r_drag=self.r_drag,
                             nu4=self.nu4)
            return s
        if self.backend == "pallas":
            src_planes = None if src is None else fs.forward_planes(src)
            p = state_to_planes(s)
            eta_scale = float(fs.eta_pair_scale(p))   # once per segment
            for _ in range(n_steps):
                if et is not None:
                    p = etd.etdrk4_step_planes(t, et, p, src_planes,
                                               eta_scale, fuse=self.etd_fuse,
                                               yfirst=self.yfirst)
                else:
                    p = rk4_step_planes(t, p, src_planes, self.dt, self.f,
                                        self.g, self.nu, self.H, eta_scale,
                                        fused_rk=self.fused_rk,
                                        yfirst=self.yfirst)
            return planes_to_state(p)
        if et is not None:
            for _ in range(n_steps):
                s = etd.etdrk4_step(t, et, s, src, self.cfg.grid_shape,
                                    fwd_pair=self.fwd_pair)
            return s
        for _ in range(n_steps):
            s = rk4_step(t, s, src, self.dt, self.f, self.g, self.nu,
                         self.H, self.cfg.grid_shape,
                         fwd_pair=self.fwd_pair, r_drag=self.r_drag,
                         nu4=self.nu4)
        return s

    def step(self, s: SWState, src) -> SWState:
        return self.segment(s, src, 1)

    def diags(self, s: SWState) -> SWDiagFields:
        t, g = self.tables, self.cfg.grid_shape
        u_hat, v_hat = sw_velocities(t, s.zeta_hat, s.div_hat)
        psi_hat = sp.invert_laplacian(t, s.zeta_hat)
        return SWDiagFields(
            vort=fft.inverse(s.zeta_hat, g), div=fft.inverse(s.div_hat, g),
            h=self.cfg.mean_depth + fft.inverse(s.eta_hat, g),
            u=fft.inverse(u_hat, g), v=fft.inverse(v_hat, g),
            psi=fft.inverse(psi_hat, g))

    def stats(self, s: SWState) -> SWStats:
        cfg = self.cfg
        d = self.diags(s)
        q_pot = (d.vort + self.f) / d.h
        ke = 0.5 * d.h * (d.u * d.u + d.v * d.v)
        pe = 0.5 * self.g * d.h * d.h
        return SWStats(
            mass=torch.mean(d.h), energy=torch.mean(ke + pe),
            pot_enstrophy=torch.mean(0.5 * d.h * q_pot * q_pot),
            max_abs_div=torch.max(torch.abs(d.div)),
            cfl=torch.max(torch.abs(d.u) / cfg.dx + torch.abs(d.v) / cfg.dy)
            * self.dt)

    def debug(self, s: SWState, src) -> DebugFields:
        """Step-start zeta gradients and this model's full vorticity
        tendency (flux form + viscosity + forcing, with the drag term as
        in the JAX package) in physical space: the SW equations have no
        bare advection stage to dump."""
        t, g = self.tables, self.cfg.grid_shape
        dz = tendency(t, s, src, self.f, self.g, self.nu, self.H, g,
                      r_drag=self.r_drag).zeta_hat
        return DebugFields(dvortdx=fft.inverse(sp.gradx(t, s.zeta_hat), g),
                           dvortdy=fft.inverse(sp.grady(t, s.zeta_hat), g),
                           dvortdt=fft.inverse(dz, g))

    def _physical(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def init_state(self, vort0, div0=None, h0=None) -> SWState:
        """Physical fields -> spectral state. Defaults: no divergence,
        flat depth; h0 (if given) is the FULL depth."""
        z = self._physical(vort0)
        d = torch.zeros_like(z) if div0 is None else self._physical(div0)
        eta = (torch.zeros_like(z) if h0 is None
               else self._physical(h0) - self.cfg.mean_depth)
        return SWState(fft.forward(z), fft.forward(d), fft.forward(eta))

    def geostrophic_init(self, vort0) -> SWState:
        """Balanced start: zero divergence and eta_hat = (f/g) psi_hat
        with the mean mode zeroed (g grad(eta) = -f z x u_vec)."""
        zeta_hat = fft.forward(self._physical(vort0))
        psi_hat = sp.invert_laplacian(self.tables, zeta_hat)
        fg = self.f / self.g
        return SWState(zeta_hat, torch.zeros_like(zeta_hat),
                       fg * psi_hat * self.mean_mask)

    def zero_source(self) -> torch.Tensor:
        return torch.zeros(self.cfg.grid_shape, dtype=torch.float32,
                           device=self.device)
