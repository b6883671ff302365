"""Sharded barotropic model: the counterpart of ShardedBarotropicModel in
xlab_fftbarotropic_tpu/parallel/model.py:174-386.

One process holds the P shards of every state, table and field on one
card, stacked on a leading axis, and steps them with the single-device
model's own functions (models/barotropic.py: rk4_step and tendency;
models/etdrk4.py: etd_scheme) on the decomposition's distributed
transforms:

  decomp 'slab'     spectral (P, nx/P, hny) and physical (P, nx/P, ny)
                    row shards; kx row-sharded, ky whole
                    (parallel/dfft.py);
  decomp 'xpencil'  spectral (P, nx, hpad/P) column shards, physical row
                    shards; kx whole, ky column-sharded
                    (parallel/xpencil.py);

and fft_impl 'xla' (library transposes), 'pallas' (the a2a kernels, TPU
row 23) or 'overlap' (the xstage kernels, rows 21 and 22). Every spectral
operator is pointwise and broadcasts over the shard axis. The inverse
transforms run unpaired (inv_pair=None): the single-device paired inverse
(ops/fft.py:inverse_pair) is not a distributed transform, so a stage
runs four inverses and one forward, as the JAX sharded model does.

The one-process-per-card executor (torch.distributed ranks, the kernels
given peer-mapped pointer tables), the 2-D pencil decomposition and the
sharded shallow-water and tracer families are not ported (ROADMAP.md
queue A, item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..models import barotropic
from ..models import etdrk4 as etd
from ..models.barotropic import check_time_scheme, resolve_device
from ..ops import spectral as sp
from ..ops.spectral import SpectralTables
from . import dfft, xpencil

DECOMPS = ("slab", "xpencil")
IMPLS = ("xla", "pallas", "overlap")
_LATER = "ROADMAP.md queue A, item 5"


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """A 1-D group of shards: how many, and the card that holds them all
    (the counterpart of a 1-D jax.sharding.Mesh)."""
    n_shards: int
    device: torch.device


def make_mesh(n_shards: Optional[int] = None, device=None) -> ShardGroup:
    """The shard group: n_shards shards on `device` (default: the current
    CUDA device). n_shards None takes one shard per visible card, which
    is one: more than one card needs the one-process-per-card executor,
    which is not ported."""
    device = "cuda" if device is None else device
    if n_shards is None:
        if (torch.device(device).type == "cuda"
                and torch.cuda.device_count() > 1):
            raise NotImplementedError(
                f"{torch.cuda.device_count()} CUDA devices are visible: "
                f"sharding over several cards needs the one-process-per-"
                f"card executor, which is not ported yet ({_LATER}); make "
                f"one card visible (CUDA_VISIBLE_DEVICES) to hold every "
                f"shard on it")
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


def _slab_pair(fft_impl: str):
    if fft_impl == "overlap":
        from . import fused_overlap
        return fused_overlap.make_fft_pair()
    return dfft.make_fft_pair(use_pallas=fft_impl == "pallas")


def _decomp_setup(cfg, mesh: ShardGroup, fft_impl: str, decomp: str):
    """(sharded tables, fwd, inv, hpad) of a decomposition; hpad None for
    the slab, whose spectral state is not padded."""
    if decomp == "pencil":
        raise NotImplementedError(
            f"decomp='pencil' (the 2-D pencil decomposition) is not ported "
            f"yet ({_LATER}); use 'slab' or 'xpencil'")
    if decomp not in DECOMPS:
        raise ValueError(f"unknown decomp: {decomp!r}")
    if fft_impl not in IMPLS:
        raise ValueError(f"unknown fft_impl: {fft_impl!r}")
    n = mesh.n_shards
    if cfg.nx % n:
        raise ValueError(f"nx={cfg.nx} not divisible by {n} shards")
    t = SpectralTables.from_config(cfg, mesh.device)
    if decomp == "xpencil":
        hny = cfg.ny // 2 + 1
        return (xpencil.shard_tables(t, n),
                *xpencil.make_fft_pair(hny, fft_impl),
                xpencil.hpad_for(hny, n))
    return (_slab_tables(t, n), *_slab_pair(fft_impl), None)


class ShardedBarotropicModel(nn.Module):
    """The barotropic stepper over a shard group.

    `step`:    (zeta_hat, src) -> zeta_hat after one step (RK4 or ETDRK4);
    `segment`: (zeta_hat, src, n_steps) -> zeta_hat after n_steps, the
               forcing fixed (src global (nx, ny) or its row shards);
    `diags`:   zeta_hat -> DiagFields, each as physical row shards.

    The state is the decomposition's sharded spectrum (shard_spectral /
    unshard_spectral carry it from and to the global (nx, hny)). Under
    ETDRK4 the scalar tables (nu lap - r_drag - nu4 lap^2, and beta in
    complex tables) shard like lap, the x-pencil pad with identity
    propagators and zero weights, so the pad stays zero.
    """

    def __init__(self, cfg, mesh: ShardGroup, fft_impl: str = "xla",
                 decomp: str = "slab"):
        super().__init__()
        check_time_scheme(cfg)
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device
        self.n_shards = mesh.n_shards
        self.fft_impl = fft_impl
        self.decomp = decomp
        (self.tables, self._fwd, self._inv,
         self.hpad) = _decomp_setup(cfg, mesh, fft_impl, decomp)
        self.dt = float(cfg.dt)
        self.nu = float(cfg.nu)
        self.r_drag = float(cfg.r_drag)
        self.beta = float(cfg.beta)
        self.nu4 = float(cfg.nu4)
        self.etd_tables = None
        if cfg.time_scheme == "etdrk4":
            tabs = etd.build_scalar_tables(cfg, self.dt, kind="barotropic",
                                           device=self.device,
                                           hpad=self.hpad or 0)
            self.etd_tables = etd.EtdTables(*(self._shard_spectral_table(a)
                                              for a in tabs))

    @classmethod
    def build(cls, cfg, mesh: ShardGroup, fft_impl: str = "xla",
              decomp: str = "slab") -> "ShardedBarotropicModel":
        return cls(cfg, mesh, fft_impl, decomp)

    @property
    def spectral_shape(self) -> tuple:
        n, (nx, ny) = self.n_shards, self.cfg.grid_shape
        if self.decomp == "xpencil":
            return (n, nx, self.hpad // n)
        return (n, nx // n, ny // 2 + 1)

    def _shard_spectral_table(self, a: torch.Tensor) -> torch.Tensor:
        if self.decomp == "xpencil":
            return xpencil.shard_state(a, self.n_shards)
        return dfft.shard_rows(a, self.n_shards)

    def _check_state(self, z: torch.Tensor) -> None:
        if (z.dtype != torch.complex64
                or tuple(z.shape) != self.spectral_shape
                or z.device != self.device):
            raise ValueError(
                f"state must be complex64 {self.spectral_shape} on "
                f"{self.device}, got {z.dtype} {tuple(z.shape)} on "
                f"{z.device}")

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

    def segment(self, zeta_hat: torch.Tensor, src: torch.Tensor,
                n_steps: int) -> torch.Tensor:
        self._check_state(zeta_hat)
        if tuple(src.shape) == self.cfg.grid_shape:
            src = self.shard_physical(src)
        z = zeta_hat
        for _ in range(n_steps):
            z = self._step(z, src)
        return z

    def step(self, zeta_hat: torch.Tensor, src: torch.Tensor
             ) -> torch.Tensor:
        return self.segment(zeta_hat, src, 1)

    def diags(self, zeta_hat: torch.Tensor) -> barotropic.DiagFields:
        return barotropic.diag_fields(self.tables, zeta_hat,
                                      self.cfg.grid_shape, inv=self._inv)

    # ----- carrying states and fields across the shard layout -----

    def shard_spectral(self, zeta_hat) -> torch.Tensor:
        """A global (nx, hny) half-spectrum (numpy or tensor; a wider,
        padded one is stripped to hny first) -> the sharded state."""
        if isinstance(zeta_hat, np.ndarray):
            zeta_hat = torch.from_numpy(np.array(zeta_hat, np.complex64))
        z = zeta_hat.to(self.device, torch.complex64)[:, :self.cfg.ny // 2
                                                      + 1]
        if self.decomp == "xpencil":
            return xpencil.shard_state(z, self.n_shards)
        return dfft.shard_rows(z, self.n_shards).contiguous()

    def unshard_spectral(self, zeta_hat: torch.Tensor) -> torch.Tensor:
        """The sharded state -> the global (nx, hny) on the card."""
        if self.decomp == "xpencil":
            return xpencil.unshard_state(zeta_hat, self.cfg.ny // 2 + 1)
        return dfft.unshard_rows(zeta_hat)

    def shard_physical(self, field) -> torch.Tensor:
        """A global (nx, ny) field -> its row shards (P, nx/P, ny)."""
        f = torch.as_tensor(field, dtype=torch.float32, device=self.device)
        return dfft.shard_rows(f, self.n_shards).contiguous()

    def unshard_physical(self, field: torch.Tensor) -> torch.Tensor:
        return dfft.unshard_rows(field)

    def init_state(self, vort0) -> torch.Tensor:
        """Physical IC -> the sharded state, through the library transform
        of the decomposition (a one-time cost, as in the JAX package)."""
        f = self.shard_physical(vort0)
        if self.decomp == "xpencil":
            return xpencil.rfft2_local(f, "xla")
        return dfft.rfft2_local(f)

    def zero_source(self) -> torch.Tensor:
        n, (nx, ny) = self.n_shards, self.cfg.grid_shape
        return torch.zeros((n, nx // n, ny), dtype=torch.float32,
                           device=self.device)
