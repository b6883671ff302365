"""Sharded models: the counterparts of ShardedBarotropicModel,
ShardedShallowWaterModel and ShardedTracerModel in
xlab_fftbarotropic_tpu/parallel/model.py:174-743.

One process holds the P shards of every state, table and field on one
card, stacked on a leading axis, and steps them with the single-device
models' own functions (models/barotropic.py, shallow_water.py,
tracer.py: rk4_step and tendency; models/etdrk4.py: etd_scheme,
etdrk4_step) on the decomposition's distributed transforms:

  decomp 'slab'     spectral (P, nx/P, hny) and physical (P, nx/P, ny)
                    row shards; kx row-sharded, ky whole
                    (parallel/dfft.py);
  decomp 'xpencil'  spectral (P, nx, hpad/P) column shards, physical row
                    shards; kx whole, ky column-sharded
                    (parallel/xpencil.py);
  decomp 'pencil'   on a 2-D (Px, Py) group (pencil.make_pencil_mesh):
                    the x-pencil's spectral shards at P = Px Py, physical
                    tiles (P, nx/Px, ny/Py) (parallel/pencil.py);

and fft_impl 'xla' (library transposes), 'pallas' (the a2a kernels, TPU
row 23) or 'overlap' (the xstage kernels, rows 21 and 22); the pencil
takes 'xla' only, as the JAX package's. fast=True (the
JAX package's fast mode) runs the overlap x-stages on their fast forms;
on 'xla' and 'pallas' the x-stage is torch.fft and the transposes hold no
matmul, so fast mode changes nothing there, as in the JAX package (its
jnp.fft x-stage and DMA all-to-all). Every spectral operator is
pointwise and broadcasts over the shard axis; the ETDRK4 tables shard
like lap with their leading axes kept (SW (3, 3, ...), tracer (2, ...)).
The inverse transforms run unpaired (inv_pair=None): the single-device
paired inverse (ops/fft.py:inverse_pair) is not a distributed transform.
Per stage the barotropic model runs four inverses and one forward, the
shallow-water model four inverses and six forwards (the five products
and the forcing, as the JAX sharded model passes a zero source), the
tracer six inverses and two forwards. The sharded shallow-water model
runs without the split-linear formulation in either mode, as the JAX
one does.

The one-process-per-card executor (torch.distributed ranks, the kernels
given peer-mapped pointer tables; ROADMAP.md queue A, item 5.2) is not
ported; with it go the JAX package's tuple-axis meshes (make_mesh2d),
which place the slab and x-pencil on several hosts, so slab and x-pencil
take a 1-D group here.

On the CPU: build(cfg, make_mesh(4, "cpu"), ...) or build(cfg,
pencil.make_pencil_mesh((2, 4), "cpu"), decomp="pencil"); on the card
`python3 chip_smoke.py --phase 5r` (slab and x-pencil) and `--phase 5s`
(the pencil).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..models import barotropic
from ..models import etdrk4 as etd
from ..models import shallow_water as sw
from ..models import tracer as tr
from ..models.barotropic import check_time_scheme, resolve_device
from ..ops import spectral as sp
from ..ops.spectral import SpectralTables
from . import dfft, pencil, xpencil

DECOMPS = ("slab", "xpencil", "pencil")
IMPLS = ("xla", "pallas", "overlap")
_LATER = "ROADMAP.md queue A, item 5"


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """A group of shards: how many, the card that holds them all and the
    mesh shape, (n_shards,) for a 1-D group (the counterpart of a 1-D
    jax.sharding.Mesh) or (Px, Py) for a 2-D one (pencil.make_pencil_mesh:
    the JAX package's pencil mesh)."""
    n_shards: int
    device: torch.device
    shape: tuple = ()

    def __post_init__(self):
        if not self.shape:
            object.__setattr__(self, "shape", (self.n_shards,))
        if math.prod(self.shape) != self.n_shards:
            raise ValueError(f"mesh shape {self.shape} does not hold "
                             f"{self.n_shards} shards")


def make_mesh(n_shards: Optional[int] = None, device=None) -> ShardGroup:
    """The 1-D shard group: n_shards shards on `device` (default: the
    current CUDA device). n_shards None takes one shard per visible
    card, which is one: more than one card needs the one-process-per-card
    executor, which is not ported."""
    device = "cuda" if device is None else device
    if n_shards is None:
        if (torch.device(device).type == "cuda"
                and torch.cuda.device_count() > 1):
            raise NotImplementedError(
                f"{torch.cuda.device_count()} CUDA devices are visible: "
                f"sharding over several cards needs the one-process-per-"
                f"card executor, which is not ported yet ({_LATER}.2); "
                f"make one card visible (CUDA_VISIBLE_DEVICES) to hold "
                f"every shard on it")
        n_shards = 1
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return ShardGroup(int(n_shards), resolve_device(device))


def _slab_tables(t: SpectralTables, n: int) -> SpectralTables:
    """Row-sharded tables: kx (P, nx/P), ky whole, the 2-D ones
    (P, nx/P, hny)."""
    out = {name: dfft.shard_rows(getattr(t, name), n)
           for name in SpectralTables.NAMES if name != "ky"}
    return SpectralTables({**out, "ky": t.ky}, t.lap.device)


def _slab_pair(fft_impl: str, fast: bool):
    if fft_impl == "overlap":
        from . import fused_overlap
        return fused_overlap.make_fft_pair(fast)
    return dfft.make_fft_pair(use_pallas=fft_impl == "pallas")


def check_decomp(cfg, mesh: ShardGroup, fft_impl: str, decomp: str) -> None:
    """Raise what a decomposition refuses, with the JAX package's texts
    (parallel/model.py:_decomp_setup there): the pencil takes 'xla' and a
    2-D group whose grid passes pencil.check_grid; slab and x-pencil a
    1-D group (a 2-D one places them on several hosts: item 5.2)."""
    if decomp not in DECOMPS:
        raise ValueError(f"unknown decomp: {decomp!r}")
    if decomp == "pencil":
        if fft_impl != "xla":
            raise ValueError(
                "decomp='pencil' currently supports fft_impl='xla' only "
                "(the a2a and xstage kernels serve the slab and x-pencil "
                "layouts, as the JAX package's Pallas DMA kernels do)")
        if len(mesh.shape) != 2:
            raise ValueError(
                f"decomp='pencil' needs a 2-D mesh, got shape {mesh.shape} "
                f"(pencil.make_pencil_mesh((Px, Py)))")
        pencil.check_grid(cfg.nx, cfg.ny, *mesh.shape)
        return
    if fft_impl not in IMPLS:
        raise ValueError(f"unknown fft_impl: {fft_impl!r}")
    if len(mesh.shape) != 1:
        raise NotImplementedError(
            f"decomp={decomp!r} on the {mesh.shape} mesh: the JAX package's "
            f"tuple-axis meshes (make_mesh2d) place the slab and x-pencil "
            f"on several hosts, which needs the one-process-per-card "
            f"executor ({_LATER}.2); use make_mesh(n_shards), or "
            f"decomp='pencil' on this mesh")
    if cfg.nx % mesh.n_shards:
        raise ValueError(f"nx={cfg.nx} not divisible by {mesh.n_shards} "
                         f"shards")


def _decomp_setup(cfg, mesh: ShardGroup, fft_impl: str, decomp: str,
                  fast: bool = False):
    """(sharded tables, fwd, inv, hpad) of a decomposition; hpad None for
    the slab, whose spectral state is not padded; `fast`: the overlap
    x-stages' fast forms."""
    check_decomp(cfg, mesh, fft_impl, decomp)
    n = mesh.n_shards
    t = SpectralTables.from_config(cfg, mesh.device)
    hny = cfg.ny // 2 + 1
    if decomp == "pencil":
        return (xpencil.shard_tables(t, n),
                *pencil.make_fft_pair(mesh.shape, hny),
                xpencil.hpad_for(hny, n))
    if decomp == "xpencil":
        return (xpencil.shard_tables(t, n),
                *xpencil.make_fft_pair(hny, fft_impl, fast),
                xpencil.hpad_for(hny, n))
    return (_slab_tables(t, n), *_slab_pair(fft_impl, fast), None)


class _ShardedModel(nn.Module):
    """What the sharded families share: the decomposition's tables and
    transform pair, and the layout of spectral states and physical
    fields. `fast`: the fast mode, `self.fast` whether it changes what
    runs (the overlap impl's fast x-stages; module note)."""

    def __init__(self, cfg, mesh: ShardGroup, fft_impl: str, decomp: str,
                 fast: bool):
        super().__init__()
        check_time_scheme(cfg)
        if not isinstance(fast, bool):
            raise TypeError(f"fast must be a bool, got {fast!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device
        self.n_shards = mesh.n_shards
        self.fft_impl = fft_impl
        self.decomp = decomp
        self.fast = fast and fft_impl == "overlap"
        (self.tables, self._fwd, self._inv,
         self.hpad) = _decomp_setup(cfg, mesh, fft_impl, decomp, self.fast)
        self.dt = float(cfg.dt)
        self.nu = float(cfg.nu)
        self.r_drag = float(cfg.r_drag)
        self.nu4 = float(cfg.nu4)
        self.etd_tables = None

    @property
    def spectral_shape(self) -> tuple:
        n, (nx, ny) = self.n_shards, self.cfg.grid_shape
        if self.hpad is not None:
            return (n, nx, self.hpad // n)
        return (n, nx // n, ny // 2 + 1)

    @property
    def physical_shape(self) -> tuple:
        """The physical shards: tiles (P, nx/Px, ny/Py) for the pencil,
        else row shards (P, nx/P, ny)."""
        n, (nx, ny) = self.n_shards, self.cfg.grid_shape
        if self.decomp == "pencil":
            px, py = self.mesh.shape
            return (n, nx // px, ny // py)
        return (n, nx // n, ny)

    def _etd_hpad(self) -> int:
        """The ETD tables' pad: hpad where the x-pencil pads, else 0 (the
        JAX sharded models' cache key)."""
        hny = self.cfg.ny // 2 + 1
        return self.hpad if self.hpad and self.hpad > hny else 0

    def _shard_table(self, a: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """A global spectral table (L..., nx, hny[pad]) with `lead`
        leading axes -> the state's layout, leading axes kept."""
        if self.hpad is not None:
            return xpencil.shard_state(a, self.n_shards)
        return dfft.shard_rows(a, self.n_shards, lead)

    def _shard_etd(self, tabs: etd.EtdTables, lead: int) -> etd.EtdTables:
        return etd.EtdTables(*(self._shard_table(a, lead) for a in tabs))

    def _check_field(self, z: torch.Tensor) -> None:
        if (z.dtype != torch.complex64
                or tuple(z.shape) != self.spectral_shape
                or z.device != self.device):
            raise ValueError(
                f"state must be complex64 {self.spectral_shape} on "
                f"{self.device}, got {z.dtype} {tuple(z.shape)} on "
                f"{z.device}")

    def segment(self, state, src: torch.Tensor, n_steps: int):
        """n_steps of the family's step from `state` (the sharded spectrum,
        or a tuple of them), the forcing fixed: global (nx, ny) or its
        physical shards (physical_shape)."""
        for z in (state if isinstance(state, tuple) else (state,)):
            self._check_field(z)
        if tuple(src.shape) == self.cfg.grid_shape:
            src = self.shard_physical(src)
        elif tuple(src.shape) != self.physical_shape:
            raise ValueError(
                f"forcing must be global {self.cfg.grid_shape} or its "
                f"shards {self.physical_shape}, got {tuple(src.shape)}")
        for _ in range(n_steps):
            state = self._step(state, src)
        return state

    def step(self, state, src: torch.Tensor):
        return self.segment(state, src, 1)

    # ----- carrying states and fields across the shard layout -----

    def shard_spectral(self, zeta_hat) -> torch.Tensor:
        """A global (nx, hny) half-spectrum (numpy or tensor; a wider,
        padded one is stripped to hny first) -> the sharded state."""
        if isinstance(zeta_hat, np.ndarray):
            zeta_hat = torch.from_numpy(np.array(zeta_hat, np.complex64))
        z = zeta_hat.to(self.device, torch.complex64)[:, :self.cfg.ny // 2
                                                      + 1]
        if self.hpad is not None:
            return xpencil.shard_state(z, self.n_shards)
        return dfft.shard_rows(z, self.n_shards).contiguous()

    def unshard_spectral(self, zeta_hat: torch.Tensor) -> torch.Tensor:
        """The sharded state -> the global (nx, hny) on the card."""
        if self.hpad is not None:
            return xpencil.unshard_state(zeta_hat, self.cfg.ny // 2 + 1)
        return dfft.unshard_rows(zeta_hat)

    def shard_physical(self, field) -> torch.Tensor:
        """A global (nx, ny) field -> its physical shards: tiles for the
        pencil, else row shards."""
        f = torch.as_tensor(field, dtype=torch.float32, device=self.device)
        if self.decomp == "pencil":
            return pencil.shard_tiles(f, self.mesh.shape)
        return dfft.shard_rows(f, self.n_shards).contiguous()

    def unshard_physical(self, field: torch.Tensor) -> torch.Tensor:
        if self.decomp == "pencil":
            return pencil.unshard_tiles(field, self.mesh.shape)
        return dfft.unshard_rows(field)

    def zero_source(self) -> torch.Tensor:
        return torch.zeros(self.physical_shape, dtype=torch.float32,
                           device=self.device)

    def _global_tables(self) -> SpectralTables:
        """The unpadded global tables of the single-device model (for the
        initial states: a one-time cost, as in the JAX package)."""
        return SpectralTables.from_config(self.cfg, self.device)


class ShardedBarotropicModel(_ShardedModel):
    """The barotropic stepper over a shard group.

    `step`:    (zeta_hat, src) -> zeta_hat after one step (RK4 or ETDRK4);
    `segment`: (zeta_hat, src, n_steps) -> zeta_hat after n_steps, the
               forcing fixed (src global (nx, ny) or its physical shards);
    `diags`:   zeta_hat -> DiagFields, each as physical shards.

    The state is the decomposition's sharded spectrum (shard_spectral /
    unshard_spectral carry it from and to the global (nx, hny)). Under
    ETDRK4 the scalar tables (nu lap - r_drag - nu4 lap^2, and beta in
    complex tables) shard like lap, the x-pencil pad with identity
    propagators and zero weights, so the pad stays zero. `fast`: the
    fast mode, `self.fast` whether it changes what runs (the overlap
    impl's fast x-stages; module note).
    """

    def __init__(self, cfg, mesh: ShardGroup, fft_impl: str = "xla",
                 decomp: str = "slab", fast: bool = False):
        super().__init__(cfg, mesh, fft_impl, decomp, fast)
        self.beta = float(cfg.beta)
        if cfg.time_scheme == "etdrk4":
            self.etd_tables = self._shard_etd(etd.build_scalar_tables(
                cfg, self.dt, kind="barotropic", device=self.device,
                hpad=self.hpad or 0), 0)

    @classmethod
    def build(cls, cfg, mesh: ShardGroup, fft_impl: str = "xla",
              decomp: str = "slab",
              fast: bool = False) -> "ShardedBarotropicModel":
        return cls(cfg, mesh, fft_impl, decomp, fast)

    def _step(self, z: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        t, g = self.tables, self.cfg.grid_shape
        if self.etd_tables is not None:
            def N(x):
                return sp.dealias(t, barotropic.tendency(
                    t, x, src, 0.0, g, fwd=self._fwd, inv=self._inv,
                    inv_pair=None))
            return etd.etd_scheme(N, lambda T, x: T * x, self.etd_tables, z)
        return barotropic.rk4_step(t, z, src, self.dt, self.nu, g,
                                   fwd=self._fwd, inv=self._inv,
                                   inv_pair=None, r_drag=self.r_drag,
                                   beta=self.beta, nu4=self.nu4)

    def diags(self, zeta_hat: torch.Tensor) -> barotropic.DiagFields:
        return barotropic.diag_fields(self.tables, zeta_hat,
                                      self.cfg.grid_shape, inv=self._inv)

    def init_state(self, vort0) -> torch.Tensor:
        """Physical IC -> the sharded state, through the library transform
        of the decomposition (a one-time cost, as in the JAX package)."""
        f = self.shard_physical(vort0)
        if self.decomp == "pencil":
            return self._fwd(f)
        if self.decomp == "xpencil":
            return xpencil.rfft2_local(f, "xla")
        return dfft.rfft2_local(f)


class ShardedShallowWaterModel(_ShardedModel):
    """The shallow-water stepper over a shard group (JAX
    parallel/model.py:389-575).

    `step`, `segment`: an SWState of sharded spectra and the forcing
    (global (nx, ny) or its physical shards, fixed across the segment) ->
    the SWState after one step or n_steps, RK4 (drag and hyperviscosity
    through rk4_step) or ETDRK4 (the (3, 3, ...) tables sharded like lap
    with two leading axes; the x-pencil and pencil pad gets identity
    propagators, so the pad stays zero); `diags`: SWDiagFields, each as
    physical shards. shard_state / unshard_state carry an SWState of global
    (nx, hny) spectra to and from the shards; init_state and
    geostrophic_init build it through the single-device model's
    functions on unpadded tables, then shard it. No split-linear form,
    as in the JAX sharded model; beta != 0 raises, as there.
    """

    def __init__(self, cfg, mesh: ShardGroup, fft_impl: str = "xla",
                 decomp: str = "slab", fast: bool = False):
        if float(cfg.beta) != 0.0:
            raise NotImplementedError(
                "beta-plane is barotropic/tracer-only: shallow water "
                "needs the spatially varying f inside curl(f u)/div(f u) "
                "(config.py beta note)")
        super().__init__(cfg, mesh, fft_impl, decomp, fast)
        self.f = float(cfg.f)
        self.g = float(cfg.gravity)
        self.H = float(cfg.mean_depth)
        if cfg.time_scheme == "etdrk4":
            self.etd_tables = self._shard_etd(etd.build_tables_cached(
                cfg, self.dt, self.device, self._etd_hpad()), 2)

    @classmethod
    def build(cls, cfg, mesh: ShardGroup, fft_impl: str = "xla",
              decomp: str = "slab",
              fast: bool = False) -> "ShardedShallowWaterModel":
        return cls(cfg, mesh, fft_impl, decomp, fast)

    def _step(self, s: sw.SWState, src: torch.Tensor) -> sw.SWState:
        t, g = self.tables, self.cfg.grid_shape
        if self.etd_tables is not None:
            return etd.etdrk4_step(t, self.etd_tables, s, src, g,
                                   fwd=self._fwd, inv=self._inv)
        return sw.rk4_step(t, s, src, self.dt, self.f, self.g, self.nu,
                           self.H, g, fwd=self._fwd, inv=self._inv,
                           inv_pair=None, r_drag=self.r_drag, nu4=self.nu4)

    def diags(self, s: sw.SWState) -> sw.SWDiagFields:
        t, g, inv = self.tables, self.cfg.grid_shape, self._inv
        u_hat, v_hat = sw.sw_velocities(t, s.zeta_hat, s.div_hat)
        psi_hat = sp.invert_laplacian(t, s.zeta_hat)
        return sw.SWDiagFields(
            vort=inv(s.zeta_hat, g), div=inv(s.div_hat, g),
            h=self.H + inv(s.eta_hat, g), u=inv(u_hat, g), v=inv(v_hat, g),
            psi=inv(psi_hat, g))

    def shard_state(self, s) -> sw.SWState:
        """An SWState of global (nx, hny[pad]) spectra (numpy or tensors)
        -> the sharded SWState."""
        return sw.SWState(*(self.shard_spectral(a) for a in s))

    def unshard_state(self, s: sw.SWState) -> sw.SWState:
        """The sharded SWState -> global (nx, hny) spectra on the card."""
        return sw.SWState(*(self.unshard_spectral(a) for a in s))

    def init_state(self, vort0, div0=None, h0=None) -> sw.SWState:
        return self.shard_state(sw.initial_state(self.cfg, self.device,
                                                 vort0, div0, h0))

    def geostrophic_init(self, vort0) -> sw.SWState:
        return self.shard_state(sw.geostrophic_state(
            self._global_tables(), self.cfg, self.device, vort0,
            sw.mean_mode_mask(self.cfg, self.device)))


class ShardedTracerModel(_ShardedModel):
    """The passive-tracer stepper over a shard group (JAX
    parallel/model.py:578-743): the joint state (zeta_hat, q_hat), two
    identically sharded spectra; RK4 (drag, beta, hyperviscosity on the
    flow, kappa on q) or ETDRK4 (the stacked (2, ...) tables sharded like
    lap with one leading axis). `diags`: TracerDiagFields as physical
    shards; shard_state, unshard_state, init_state as the shallow-water
    model's.
    """

    def __init__(self, cfg, mesh: ShardGroup, fft_impl: str = "xla",
                 decomp: str = "slab", fast: bool = False,
                 kappa: float = 0.0):
        super().__init__(cfg, mesh, fft_impl, decomp, fast)
        self.kappa = float(kappa)
        self.beta = float(cfg.beta)
        if cfg.time_scheme == "etdrk4":
            self.etd_tables = self._shard_etd(etd.build_scalar_tables(
                cfg, self.dt, kind="tracer", kappa=self.kappa,
                device=self.device, hpad=self._etd_hpad()), 1)

    @classmethod
    def build(cls, cfg, mesh: ShardGroup, fft_impl: str = "xla",
              decomp: str = "slab", fast: bool = False,
              kappa: float = 0.0) -> "ShardedTracerModel":
        return cls(cfg, mesh, fft_impl, decomp, fast, kappa)

    def _step(self, s: tr.TracerState, src: torch.Tensor
              ) -> tr.TracerState:
        t, g = self.tables, self.cfg.grid_shape
        if self.etd_tables is not None:
            return tr.etd_step(t, self.etd_tables, s, src, g, fwd=self._fwd,
                               inv=self._inv, inv_pair=None)
        return tr.rk4_step(t, s, src, self.dt, self.nu, self.kappa, g,
                           fwd=self._fwd, inv=self._inv, inv_pair=None,
                           r_drag=self.r_drag, beta=self.beta, nu4=self.nu4)

    def diags(self, s: tr.TracerState) -> tr.TracerDiagFields:
        t, g, inv = self.tables, self.cfg.grid_shape, self._inv
        psi_hat = sp.invert_laplacian(t, s.zeta_hat)
        u_hat, v_hat = sp.velocities(t, psi_hat)
        return tr.TracerDiagFields(
            vort=inv(s.zeta_hat, g), psi=inv(psi_hat, g), u=inv(u_hat, g),
            v=inv(v_hat, g), q=inv(s.q_hat, g))

    def shard_state(self, s) -> tr.TracerState:
        """A TracerState of global (nx, hny[pad]) spectra -> the sharded
        one."""
        return tr.TracerState(*(self.shard_spectral(a) for a in s))

    def unshard_state(self, s: tr.TracerState) -> tr.TracerState:
        return tr.TracerState(*(self.unshard_spectral(a) for a in s))

    def init_state(self, vort0, q0) -> tr.TracerState:
        return self.shard_state(tr.initial_state(self.device, vort0, q0))
