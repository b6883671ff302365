"""Barotropic vorticity model: the counterpart of
xlab_fftbarotropic_tpu/models/barotropic.py.

Equation (main.cpp:225-243):
    d zeta / dt = -u * zeta_x - v * zeta_y + S + nu * lap(zeta)
with u = -psi_y, v = +psi_x, lap(psi) = zeta, advanced by classic RK4 on
the half-spectrum state zeta_hat (complex64, (nx, ny//2+1)); each stage
tendency is dealiased (main.cpp:296-306), the state never is.

Two stepping paths, chosen by cfg.fft_backend:

* "pallas", the plane stepper (rk4_step_planes): the state moves as
  float32 (re, im) planes through the four transform kernels of
  ops/fused_fft.py, five launches per RK stage, with the RK stage update
  fused into kx_visc's epilogue for stages 1-3 and the RK4 tail one
  rk4_combine launch (ops/fused_sw.py): 21 launches per step. That is
  the y-first order in its default fusion arm; the JAX package's other
  arms are fusekb "full"/"half" (XFB_BT_FUSEKB: kb_adv_full, or kb_pair
  + kb_adv_half, in place of two kb_pair + ky_adv), fusekx=False
  (XFB_BT_FUSEKX=0: kx_fwd + visc in place of kx_visc) and fusetail
  (XFB_BT_FUSETAIL=1: the RK4 tail in stage 4's kx_visc_tail in place
  of rk4_combine), each giving the default arm's values. The x-first
  order (yfirst=False, the JAX package's XFB_BT_YFIRST=0, or quad_mode
  "quad"/"split") runs ka_diag (or ka_quad) + two kb + ka_adv + kc_visc
  per stage, with the stage updates in torch, and no fusion arm. On a
  CUDA device they are the hand-written kernels; on the CPU, their plain
  torch versions.
* "xla", the library path (tendency / rk4_step) on torch.fft.

tendency / rk4_step also run on the per-transform kernels
(resolve_fft_backend): the differentiable rollout (adjoint.py) takes
them there.

"auto" takes "pallas" for power-of-two square grids the kernels take
(64..8192), else "xla". The diagnostics always use the library path.

cfg.time_scheme "etdrk4" swaps RK4 for the exponential scheme of
models/etdrk4.py: nu lap - r_drag - nu4 lap^2 (and the beta term, in
complex tables) integrated exactly, N the advection-only tendency on the
same kernels (or on torch.fft) with nu = 0 and no drag fold.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops import fft
from ..ops import fused_fft as ff
from ..ops import fused_sw as fs
from ..ops import spectral as sp
from ..ops.spectral import SpectralTables
from . import etdrk4 as etd


def resolve_device(device) -> torch.device:
    """torch.device with the index filled in ('cuda' -> the current
    'cuda:N'), so that it compares equal to the device of the tensors
    made on it."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def check_time_scheme(cfg) -> None:
    if cfg.time_scheme not in ("rk4", "etdrk4"):
        raise ValueError(f"unknown time_scheme {cfg.time_scheme!r}")


def plane_stepper_ok(grid_shape) -> bool:
    nx, ny = grid_shape
    return nx == ny and ff.supported_length(nx)


def resolve_fft_backend_name(name: str, grid_shape) -> str:
    """'auto' -> 'pallas' on square power-of-two grids from 64 to 8192,
    else 'xla': a deterministic shape gate. An explicit 'pallas' on a
    grid the kernels do not take raises."""
    if name == "mxu":
        raise NotImplementedError(
            "fft_backend='mxu' is not ported (ROADMAP.md queue A, 'Not to "
            "port': torch.fft fills the library role); use 'xla' or "
            "'pallas'")
    if name == "auto":
        return "pallas" if plane_stepper_ok(grid_shape) else "xla"
    if name == "pallas" and not plane_stepper_ok(grid_shape):
        raise ValueError(
            f"fft_backend='pallas' needs a square power-of-two grid from "
            f"{ff.MIN_N} to {ff.MAX_N}, got {tuple(grid_shape)}")
    if name not in ("pallas", "xla"):
        raise ValueError(f"unknown fft_backend: {name!r}")
    return name


def resolve_fft_backend(name: str, grid_shape, differentiable: bool = False):
    """The transform triple (forward, inverse, inverse_pair) of the
    library tendencies for a fft_backend name: 'xla' is torch.fft
    (ops/fft.py), 'pallas' the per-transform kernels (ops/fused_fft.py:
    rfft2, irfft2, inverse_pair), with their adjoints when
    `differentiable` (ops/fused_diff.py); 'auto' as
    resolve_fft_backend_name. Counterpart of the JAX package's
    resolve_fft_backend without its derivative_quad (the plane steppers
    are picked by the models)."""
    if resolve_fft_backend_name(name, grid_shape) == "xla":
        return fft.forward, fft.inverse, fft.inverse_pair
    if differentiable:
        from ..ops import fused_diff as fd
        return fd.forward, fd.inverse, fd.inverse_pair
    return ff.rfft2, ff.irfft2, ff.inverse_pair


class DiagFields(NamedTuple):
    """Physical-space fields recorded every record_step (SURVEY.md §5.9)."""
    vort: torch.Tensor
    psi: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


class DebugFields(NamedTuple):
    """The reference's OUTPUT_GRAD_VORT / OUTPUT_DVORTDT dumps
    (main.cpp:156-176, 216-222): the first RK stage's zeta gradients and
    the advective tendency before the forward transform."""
    dvortdx: torch.Tensor
    dvortdy: torch.Tensor
    dvortdt: torch.Tensor


class StepStats(NamedTuple):
    max_abs_vort: torch.Tensor
    energy: torch.Tensor      # 0.5 * mean(u^2 + v^2)
    enstrophy: torch.Tensor   # 0.5 * mean(zeta^2)
    cfl: torch.Tensor         # max(|u|/dx + |v|/dy) * dt


def _paired(inv, inv_pair):
    """inv_pair, or two calls of inv when there is none."""
    if inv_pair is not None:
        return inv_pair
    return lambda a, b, g: (inv(a, g), inv(b, g))


def tendency(t: SpectralTables, zeta_hat: torch.Tensor, src: torch.Tensor,
             nu: float, grid_shape: Tuple[int, int],
             fwd: Callable = fft.forward, inv: Callable = fft.inverse,
             inv_pair: Optional[Callable] = fft.inverse_pair,
             r_drag: float = 0.0, beta: float = 0.0,
             nu4: float = 0.0) -> torch.Tensor:
    """getDvortdt (main.cpp:146-244): the un-dealiased spectral tendency,
    four inverse transforms paired into two, one forward. `fwd`, `inv`,
    `inv_pair` are the transforms (resolve_fft_backend): torch.fft by
    default, or the per-transform kernels; inv_pair None pairs through
    two calls of inv. Zero r_drag, beta and nu4 skip their terms,
    leaving the reference expression."""
    pair = _paired(inv, inv_pair)
    lvort_hat = (sp.laplacian(t, zeta_hat) if nu != 0.0 or nu4 != 0.0
                 else None)                                # main.cpp:148
    psi_hat = sp.invert_laplacian(t, zeta_hat)             # main.cpp:179
    dvdx, dvdy = pair(sp.gradx(t, zeta_hat), sp.grady(t, zeta_hat),
                      grid_shape)
    u, v = pair(-sp.grady(t, psi_hat), sp.gradx(t, psi_hat), grid_shape)
    if beta != 0.0:
        # -u*zx - v*zy - beta*v = -u*zx - v*(zy + beta)
        dvdy = dvdy + beta
    dvortdt = -u * dvdx - v * dvdy + src                   # main.cpp:225-227
    out = fwd(dvortdt)                                     # main.cpp:237
    if nu != 0.0:
        out = out + lvort_hat * nu                         # main.cpp:240-243
    if r_drag != 0.0:
        out = out - zeta_hat * r_drag
    if nu4 != 0.0:
        out = out - sp.laplacian(t, lvort_hat) * nu4
    return out


def rk4_step(t: SpectralTables, zeta_hat: torch.Tensor, src: torch.Tensor,
             dt: float, nu: float, grid_shape: Tuple[int, int],
             fwd: Callable = fft.forward, inv: Callable = fft.inverse,
             inv_pair: Optional[Callable] = fft.inverse_pair,
             r_drag: float = 0.0, beta: float = 0.0,
             nu4: float = 0.0) -> torch.Tensor:
    """One RK4 step on zeta_hat (main.cpp:286-317); src is held fixed
    across the four stages."""
    def d(z):
        return sp.dealias(t, tendency(t, z, src, nu, grid_shape, fwd=fwd,
                                      inv=inv, inv_pair=inv_pair,
                                      r_drag=r_drag, beta=beta, nu4=nu4))
    rk1 = d(zeta_hat)
    rk2 = d(zeta_hat + rk1 * (dt * 0.5))
    rk3 = d(zeta_hat + rk2 * (dt * 0.5))
    rk4 = d(zeta_hat + rk3 * dt)
    return zeta_hat + (rk1 + 2.0 * rk2 + 2.0 * rk3 + rk4) * (dt / 6.0)


def plane_tendency(t: SpectralTables, src_l: torch.Tensor, nu: float,
                   beta: float = 0.0, yfirst: bool = True,
                   quad_mode: str = "grid", fusekb: str = "",
                   fusekx: bool = True) -> Callable:
    """The plane stepper's dealiased stage tendency, d(sr, si[, axpy,
    tail]) -> (re, im) planes. y-first: derivative_quad_planes (ka_diag +
    2 kb_pair) and forward_tendency_yfirst (ky_adv + forward_tail:
    kx_visc, or with fusekx False kx_fwd + visc, viscous and dealiased in
    the epilogue; axpy=(z0r, z0i, coef) also returns the next stage
    state, tail=(z0r, z0i, r1r, r1i, r2r, r2i, r3r, r3i, c) the stepped
    state instead), or with fusekb "full"/"half" tendency_yfirst_fusedkb;
    `src_l` the forcing y-major (ny, nx). x-first (yfirst False; quad_mode
    "quad" or "split" requires it): the x-major derivative_quad_planes
    (ka_diag or ka_quad + 2 kb) and forward_tendency (ka_adv + kc_visc),
    `src_l` x-major (nx, ny), no axpy or tail, fusekb and fusekx
    ignored (as in the JAX package)."""
    def d(sr, si, axpy=None, tail=None):
        if yfirst and fusekb:
            return ff.tendency_yfirst_fusedkb(
                sr, si, src_l, t.kx, t.ky, t.rlap, t.lap, t.mask, nu, axpy,
                fusekb, beta, tail, fusekx)
        zx, zy, u, v = ff.derivative_quad_planes(sr, si, t.kx, t.ky, t.rlap,
                                                 ymajor=yfirst,
                                                 quad_mode=quad_mode)
        if yfirst:
            return ff.forward_tendency_yfirst(u, zx, v, zy, src_l, t.lap,
                                              t.mask, sr, si, nu, beta, axpy,
                                              tail, fusekx)
        if axpy is not None or tail is not None:
            raise ValueError("the x-first tendency takes no stage axpy or "
                             "tail")
        return ff.forward_tendency(u, zx, v, zy, src_l, t.lap, t.mask, sr,
                                   si, nu, beta)
    return d


def rk4_step_planes(t: SpectralTables, zr: torch.Tensor, zi: torch.Tensor,
                    src_l: torch.Tensor, dt: float, nu: float,
                    beta: float = 0.0, fused_rk: bool = True,
                    yfirst: bool = True, quad_mode: str = "grid",
                    fusekb: str = "", fusekx: bool = True,
                    fusetail: bool = False):
    """RK4 on the state as float32 (re, im) planes through the transform
    kernels, a plane_tendency per stage (yfirst and quad_mode pick the
    order and the x-stage, fusekb and fusekx the y-first fusion arm;
    `src_l` is the forcing in that order's layout).

    fused_rk=True (the JAX default, XFB_BT_FUSED_RK=1), y-first only:
    stages 1-3 return the next stage state from the forward tail's axpy
    epilogue, and the tail is one plane_rk4_combine, or with fusetail
    (XFB_BT_FUSETAIL=1, which needs fusekx, as the JAX package's :302)
    stage 4's kx_visc_tail. Otherwise (fused_rk=False, or the x-first
    order, which the JAX package never fuses): the stage updates and the
    tail are torch elementwise arithmetic in the same grouping; every
    form and arm gives the same bits."""
    h = dt * 0.5
    d = plane_tendency(t, src_l, nu, beta, yfirst, quad_mode, fusekb,
                       fusekx)
    c = dt / 6.0
    if fused_rk and yfirst:
        r1r, r1i, s2r, s2i = d(zr, zi, axpy=(zr, zi, h))
        r2r, r2i, s3r, s3i = d(s2r, s2i, axpy=(zr, zi, h))
        r3r, r3i, s4r, s4i = d(s3r, s3i, axpy=(zr, zi, dt))
        if fusetail and fusekx:
            return d(s4r, s4i, tail=(zr, zi, r1r, r1i, r2r, r2i, r3r, r3i,
                                     c))
        r4r, r4i = d(s4r, s4i)
        return fs.plane_rk4_combine((zr, zi), (r1r, r1i), (r2r, r2i),
                                    (r3r, r3i), (r4r, r4i), c)
    r1r, r1i = d(zr, zi)
    r2r, r2i = d(zr + r1r * h, zi + r1i * h)
    r3r, r3i = d(zr + r2r * h, zi + r2i * h)
    r4r, r4i = d(zr + r3r * dt, zi + r3i * dt)
    return (zr + (r1r + 2.0 * r2r + 2.0 * r3r + r4r) * c,
            zi + (r1i + 2.0 * r2i + 2.0 * r3i + r4i) * c)


def fusion_arm(fused_rk: bool = True, fusekb: str = "", fusekx: bool = True,
               fusetail: bool = False, etd: bool = False) -> str:
    """The y-first plane stepper's kernels in a fusion arm, by stage part
    (the CLI banner's line)."""
    parts = [{"": "kb_pair x2 + ky_adv", "half": "kb_pair + kb_adv_half",
              "full": "kb_adv_full"}[fusekb],
             "kx_visc" if fusekx else "kx_fwd + visc"]
    if not etd:
        parts.append("torch stage updates" if not fused_rk
                     else "kx_visc_tail" if fusetail and fusekx
                     else "rk4_combine")
    return ", ".join(parts)


def etd_step(t: SpectralTables, tabs, zeta_hat: torch.Tensor,
             src: torch.Tensor, grid_shape: Tuple[int, int]) -> torch.Tensor:
    """One ETDRK4 step on the library path: N is the dealiased
    advection-only tendency (every linear coefficient zero)."""
    def N(z):
        return sp.dealias(t, tendency(t, z, src, 0.0, grid_shape))
    return etd.etd_scheme(N, lambda T, z: T * z, tabs, zeta_hat)


def etd_step_planes(t: SpectralTables, tabs, zr: torch.Tensor,
                    zi: torch.Tensor, src_l: torch.Tensor,
                    yfirst: bool = True, quad_mode: str = "grid",
                    fusekb: str = "", fusekx: bool = True):
    """One ETDRK4 step on the (re, im) planes through the plane
    stepper's kernels: N is plane_tendency with nu = 0 and beta = 0
    (beta, drag and hyperviscosity live in the tables, nothing folds
    into lap), in either order and any y-first fusion arm (the JAX
    package's _eplane_step: tendency_yfirst_fusedkb with nu = 0, no
    beta)."""
    d = plane_tendency(t, src_l, 0.0, 0.0, yfirst, quad_mode, fusekb,
                       fusekx)
    return etd.etd_scheme(lambda q: d(*q),
                          lambda T, q: etd.smul_planes(T, *q), tabs,
                          (zr, zi))


def diag_fields(t: SpectralTables, zeta_hat: torch.Tensor,
                grid_shape: Tuple[int, int],
                inv: Callable = fft.inverse) -> DiagFields:
    """Step-start physical fields: the record block (main.cpp:266-282)
    plus the first stage's psi/u/v dumps (main.cpp:181-222); `inv` the
    inverse transform (the sharded model passes its distributed one)."""
    psi_hat = sp.invert_laplacian(t, zeta_hat)
    u_hat, v_hat = sp.velocities(t, psi_hat)
    return DiagFields(vort=inv(zeta_hat, grid_shape),
                      psi=inv(psi_hat, grid_shape),
                      u=inv(u_hat, grid_shape),
                      v=inv(v_hat, grid_shape))


def debug_fields(t: SpectralTables, zeta_hat: torch.Tensor,
                 src: torch.Tensor, grid_shape: Tuple[int, int],
                 beta: float = 0.0) -> DebugFields:
    """Step-start debug intermediates (main.cpp:156-176, 216-222)."""
    dvdx = fft.inverse(sp.gradx(t, zeta_hat), grid_shape)
    dvdy = fft.inverse(sp.grady(t, zeta_hat), grid_shape)
    psi_hat = sp.invert_laplacian(t, zeta_hat)
    u = -fft.inverse(sp.grady(t, psi_hat), grid_shape)
    v = fft.inverse(sp.gradx(t, psi_hat), grid_shape)
    adv_y = dvdy + beta if beta != 0.0 else dvdy
    return DebugFields(dvortdx=dvdx, dvortdy=dvdy,
                       dvortdt=-u * dvdx - v * adv_y + src)


def step_stats(t: SpectralTables, zeta_hat: torch.Tensor, cfg) -> StepStats:
    g = cfg.grid_shape
    psi_hat = sp.invert_laplacian(t, zeta_hat)
    u_hat, v_hat = sp.velocities(t, psi_hat)
    u = fft.inverse(u_hat, g)
    v = fft.inverse(v_hat, g)
    vort = fft.inverse(zeta_hat, g)
    return StepStats(
        max_abs_vort=torch.max(torch.abs(vort)),
        energy=0.5 * torch.mean(u * u + v * v),
        enstrophy=0.5 * torch.mean(vort * vort),
        cfl=torch.max(torch.abs(u) / cfg.dx + torch.abs(v) / cfg.dy)
        * cfg.dt)


class BarotropicModel(nn.Module):
    """The stepper for one configuration on one device.

    `step`:    zeta_hat, src -> zeta_hat after ONE step (RK4 or ETDRK4).
    `segment`: zeta_hat, src -> zeta_hat after n steps, a Python loop
               with the forcing fixed (and, on the plane stepper,
               transposed to y-major once).
    `diags`:   zeta_hat -> DiagFields;  `stats`: zeta_hat -> StepStats;
    `debug`:   zeta_hat, src -> DebugFields.

    `tables` (buffers) serve the diagnostics; `step_tables` step.
    `fused_rk` picks the plane stepper's form (rk4_step_planes; True is
    the JAX default, XFB_BT_FUSED_RK=1; y-first only). `yfirst` its
    transform order (True the JAX default, XFB_BT_YFIRST=1) and
    `quad_mode` its derivative x-stage (pallas_fft.QUAD_MODE: "grid",
    the default, or "quad" or "split", which run the x-first order);
    `self.yfirst` is the order that runs. `fusekb` ("", "half" or
    "full"; XFB_BT_FUSEKB), `fusekx` (XFB_BT_FUSEKX) and `fusetail`
    (XFB_BT_FUSETAIL; RK4 with fused_rk and fusekx only) pick the
    y-first fusion arm, defaults as the JAX package's in strict float32;
    the x-first order ignores them. On the RK4 plane stepper, drag
    and hyperviscosity fold into the stepping lap:
    lap := nu*lap - r_drag - nu4*lap^2 with nu := 1, since the kernels'
    only linear term is nu*lap*Z (models/barotropic.py:526-539 of the JAX
    package); the diagnostics keep the original tables. Under ETDRK4
    they live in `etd_tables` instead, and nothing folds.
    """

    def __init__(self, cfg, device, tables: SpectralTables = None,
                 fused_rk: bool = True, yfirst: bool = True,
                 quad_mode: str = "grid", fusekb: str = "",
                 fusekx: bool = True, fusetail: bool = False):
        super().__init__()
        check_time_scheme(cfg)
        if quad_mode not in ff.QUAD_MODES:
            raise ValueError(f"unknown quad_mode {quad_mode!r}, not one of "
                             f"{ff.QUAD_MODES}")
        if fusekb not in ff.FUSEKB_MODES:
            raise ValueError(f"unknown fusekb {fusekb!r}, not one of "
                             f"{ff.FUSEKB_MODES}")
        for name, flag in (("fused_rk", fused_rk), ("fusekx", fusekx),
                           ("fusetail", fusetail)):
            if not isinstance(flag, bool):
                raise TypeError(f"{name} must be a bool, got {flag!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = resolve_fft_backend_name(cfg.fft_backend,
                                                cfg.grid_shape)
        self.fused_rk = fused_rk
        self.yfirst = yfirst and quad_mode == "grid"
        self.quad_mode = quad_mode
        self.fusion = dict(fusekb=fusekb, fusekx=fusekx)
        self.fusetail = fusetail
        t = (tables if tables is not None
             else SpectralTables.from_config(cfg, self.device))
        self.tables = t
        self.dt = float(cfg.dt)
        self.nu = float(cfg.nu)
        self.r_drag = float(cfg.r_drag)
        self.beta = float(cfg.beta)
        self.nu4 = float(cfg.nu4)
        self.step_nu = self.nu
        lap = t.lap
        etd_on = cfg.time_scheme == "etdrk4"
        if self.backend == "pallas" and not etd_on and (
                self.r_drag != 0.0 or self.nu4 != 0.0):
            lap = t.lap * self.nu - self.r_drag - self.nu4 * t.lap * t.lap
            self.step_nu = 1.0
        self.step_tables = SpectralTables({**t.as_dict(), "lap": lap},
                                          self.device)
        self.etd_tables = (etd.build_scalar_tables(
            cfg, self.dt, kind="barotropic", device=self.device)
            if etd_on else None)

    @classmethod
    def build(cls, cfg, device, tables: SpectralTables = None,
              fused_rk: bool = True, yfirst: bool = True,
              quad_mode: str = "grid", fusekb: str = "",
              fusekx: bool = True,
              fusetail: bool = False) -> "BarotropicModel":
        return cls(cfg, device, tables, fused_rk, yfirst, quad_mode, fusekb,
                   fusekx, fusetail)

    def _check_state(self, zeta_hat: torch.Tensor) -> None:
        if (zeta_hat.dtype != torch.complex64
                or tuple(zeta_hat.shape) != self.cfg.spectral_shape
                or zeta_hat.device != self.device):
            raise ValueError(
                f"state must be complex64 {self.cfg.spectral_shape} on "
                f"{self.device}, got {zeta_hat.dtype} "
                f"{tuple(zeta_hat.shape)} on {zeta_hat.device}")

    def segment(self, zeta_hat: torch.Tensor, src: torch.Tensor,
                n_steps: int) -> torch.Tensor:
        self._check_state(zeta_hat)
        t, g, et = self.step_tables, self.cfg.grid_shape, self.etd_tables
        if self.backend == "pallas":
            zr = zeta_hat.real.contiguous()
            zi = zeta_hat.imag.contiguous()
            # the forcing in the order's layout, once per segment
            src_l = (src.t() if self.yfirst else src).contiguous()
            order = dict(yfirst=self.yfirst, quad_mode=self.quad_mode,
                         **self.fusion)
            for _ in range(n_steps):
                if et is not None:
                    zr, zi = etd_step_planes(t, et, zr, zi, src_l, **order)
                else:
                    zr, zi = rk4_step_planes(t, zr, zi, src_l, self.dt,
                                             self.step_nu, beta=self.beta,
                                             fused_rk=self.fused_rk,
                                             fusetail=self.fusetail, **order)
            return torch.complex(zr, zi)
        z = zeta_hat
        for _ in range(n_steps):
            if et is not None:
                z = etd_step(t, et, z, src, g)
            else:
                z = rk4_step(t, z, src, self.dt, self.nu, g,
                             r_drag=self.r_drag, beta=self.beta,
                             nu4=self.nu4)
        return z

    def step(self, zeta_hat: torch.Tensor, src: torch.Tensor
             ) -> torch.Tensor:
        return self.segment(zeta_hat, src, 1)

    def diags(self, zeta_hat: torch.Tensor) -> DiagFields:
        return diag_fields(self.tables, zeta_hat, self.cfg.grid_shape)

    def stats(self, zeta_hat: torch.Tensor) -> StepStats:
        return step_stats(self.tables, zeta_hat, self.cfg)

    def debug(self, zeta_hat: torch.Tensor, src: torch.Tensor
              ) -> DebugFields:
        return debug_fields(self.tables, zeta_hat, src,
                            self.cfg.grid_shape, beta=self.beta)

    def init_state(self, vort0) -> torch.Tensor:
        """Physical initial vorticity -> spectral state (main.cpp:256)."""
        v = torch.as_tensor(vort0, dtype=torch.float32, device=self.device)
        return fft.forward(v)

    def zero_source(self) -> torch.Tensor:
        """The reference never initializes vort_src (SURVEY.md §5.10-1);
        it is zeroed explicitly here."""
        return torch.zeros(self.cfg.grid_shape, dtype=torch.float32,
                           device=self.device)
