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

The same models run one shard per process: on an initialized
torch.distributed runtime (parallel/multihost.py) make_mesh(None) and
make_mesh2d(shape) give a distributed group, one rank per shard. A rank's
tensors keep the stacked layout with a leading shard axis of 1 and hold
the shard the stacked model holds at the rank's index (tiles in mesh
order d = i Py + j, pencil spectra in block order b = j Px + i), so every
pointwise operator, table and step function runs unchanged; only the
transposes (collectives for 'xla'; the a2a and xstage kernels' ranked
launches on the exchange buffers of parallel/peer.py for 'pallas' and
'overlap'), shard/unshard (the rank's slice; multihost.gather_to_host)
and the gathered diagnostics differ. make_mesh2d's tuple-axis group
places the slab and the x-pencil over the flattened pair, as the JAX
package's make_mesh2d, and is the pencil's (Px, Py) mesh.

On the CPU: build(cfg, make_mesh(4, "cpu"), ...) or build(cfg,
pencil.make_pencil_mesh((2, 4), "cpu"), decomp="pencil"); over ranks,
`XFB_COORDINATOR=... XFB_NUM_PROCESSES=4 XFB_PROCESS_ID=r` or torchrun
with make_mesh(None, "cpu") (tests/test_torch_multihost_model.py); on
the card `python3 chip_smoke.py --phase 5r` (slab and x-pencil), `--phase
5s` (the pencil) and `--phase 5t` (4 ranks sharing the card).
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
from . import dfft, multihost, pencil, xpencil

DECOMPS = ("slab", "xpencil", "pencil")
IMPLS = ("xla", "pallas", "overlap")


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """A group of shards: how many, the device that holds them and the
    mesh shape, (n_shards,) for a 1-D group (the counterpart of a 1-D
    jax.sharding.Mesh) or (Px, Py) for a 2-D one (make_mesh2d: the JAX
    package's tuple-axis and pencil meshes).

    rank None: the stacked one-process form, every shard on `device`.
    Otherwise the distributed form: this process is rank `rank` of the
    torch.distributed `process_group` (None: the default group), holds
    shard `rank` on `device` (its card, or the CPU), and on a 2-D group
    reaches its mesh row (same i, the py axis) and mesh column (same j,
    px) through `row_group` and `col_group`."""
    n_shards: int
    device: torch.device
    shape: tuple = ()
    rank: Optional[int] = None
    process_group: object = dataclasses.field(default=None, compare=False)
    row_group: object = dataclasses.field(default=None, compare=False)
    col_group: object = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if not self.shape:
            object.__setattr__(self, "shape", (self.n_shards,))
        if math.prod(self.shape) != self.n_shards:
            raise ValueError(f"mesh shape {self.shape} does not hold "
                             f"{self.n_shards} shards")

    @property
    def distributed(self) -> bool:
        return self.rank is not None

    @property
    def local_shards(self) -> int:
        """The shards this process holds: 1 on a distributed group."""
        return 1 if self.distributed else self.n_shards


def _distributed_group(device, shape: tuple) -> ShardGroup:
    """One shard per rank of the initialized runtime, on the rank's card
    (or the CPU); a 2-D shape also makes every mesh row's and column's
    sub-group (a collective of every rank, in the same order)."""
    world, r = multihost.world_size(), multihost.rank()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                         f"ranks, the runtime has {world}")
    dev = multihost.rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rows = cols = None
    if len(shape) == 2:
        px, py = shape
        rows = [multihost.subgroup(tuple(i * py + j for j in range(py)))
                for i in range(px)]
        cols = [multihost.subgroup(tuple(i * py + j for i in range(px)))
                for j in range(py)]
        rows, cols = rows[r // py], cols[r % py]
    return ShardGroup(world, dev, tuple(shape), r, None, rows, cols)


def make_mesh(n_shards: Optional[int] = None, device=None) -> ShardGroup:
    """The 1-D shard group: n_shards shards stacked on `device` (default:
    the current CUDA device). n_shards None takes one shard per process
    on an initialized torch.distributed runtime (parallel/multihost.py:
    the distributed group), else the one visible card's one shard; more
    than one visible card without the runtime is refused: start one
    process per card (torchrun, or the XFB_* contract of
    multihost.initialize)."""
    device = "cuda" if device is None else device
    if n_shards is None:
        if multihost.is_initialized():
            return _distributed_group(device, (multihost.world_size(),))
        if (torch.device(device).type == "cuda"
                and torch.cuda.device_count() > 1):
            raise NotImplementedError(
                f"{torch.cuda.device_count()} CUDA devices are visible and "
                f"no torch.distributed runtime is up: run one process per "
                f"card (torchrun --nproc-per-node N, or XFB_COORDINATOR, "
                f"XFB_NUM_PROCESSES and XFB_PROCESS_ID with "
                f"multihost.initialize), or make one card visible "
                f"(CUDA_VISIBLE_DEVICES) to hold every shard on it")
        n_shards = 1
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return ShardGroup(int(n_shards), resolve_device(device))


def make_mesh2d(shape, device=None) -> ShardGroup:
    """The 2-D (A, B) shard group (the JAX package's make_mesh2d, hosts x
    chips, and its pencil mesh): on an initialized torch.distributed
    runtime one shard per rank (A B ranks, with the mesh-row and
    mesh-column sub-groups), else A B shards stacked on `device`. Slab
    and x-pencil run their transposes over the flattened pair; the
    pencil over its rows and columns (pencil.py)."""
    shape = tuple(shape)
    if (len(shape) != 2 or not all(isinstance(s, int) for s in shape)
            or min(shape) < 1):
        raise ValueError(f"a 2-D mesh shape is two positive ints "
                         f"(Px, Py), got {shape!r}")
    device = "cuda" if device is None else device
    if multihost.is_initialized():
        return _distributed_group(device, shape)
    return ShardGroup(shape[0] * shape[1], resolve_device(device), shape)


def _slab_tables(t: SpectralTables, n: int) -> SpectralTables:
    """Row-sharded tables: kx (P, nx/P), ky whole, the 2-D ones
    (P, nx/P, hny)."""
    out = {name: dfft.shard_rows(getattr(t, name), n)
           for name in SpectralTables.NAMES if name != "ky"}
    return SpectralTables({**out, "ky": t.ky}, t.lap.device)


def _slab_pair(fft_impl: str, fast: bool, group=None, exchange=None):
    if fft_impl == "overlap":
        from . import fused_overlap
        return fused_overlap.make_fft_pair(fast, exchange)
    return dfft.make_fft_pair(fft_impl == "pallas", group, exchange)


def check_decomp(cfg, mesh: ShardGroup, fft_impl: str, decomp: str) -> None:
    """Raise what a decomposition refuses, with the JAX package's texts
    (parallel/model.py:_decomp_setup there): the pencil takes 'xla' and a
    2-D group whose grid passes pencil.check_grid; slab and x-pencil any
    group (a 2-D one over the flattened pair, as the JAX make_mesh2d).
    The kernel impls over ranks take the ranks of one host (their
    exchange buffers are mapped by CUDA IPC or /dev/shm, and their
    barrier is in shared memory), at most MAX_SHARDS of them (the pointer
    table the kernels take by value)."""
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
    if mesh.distributed and fft_impl != "xla":
        from .fused_transpose import MAX_SHARDS
        hosts = multihost.host_count()
        if hosts > 1:
            raise ValueError(
                f"fft_impl={fft_impl!r} over ranks on {hosts} hosts: the "
                f"kernels reach their peers' buffers by CUDA IPC (or "
                f"/dev/shm) and a shared-memory barrier, within one host "
                f"only; use fft_impl='xla'")
        if mesh.n_shards > MAX_SHARDS:
            raise ValueError(
                f"fft_impl={fft_impl!r} over {mesh.n_shards} ranks: the "
                f"kernels take 1..{MAX_SHARDS} shards (csrc/shards.cuh "
                f"kMaxShards); use fft_impl='xla'")
    if cfg.nx % mesh.n_shards:
        raise ValueError(f"nx={cfg.nx} not divisible by {mesh.n_shards} "
                         f"shards")


def spectral_index(mesh: ShardGroup, decomp: str) -> Optional[int]:
    """The stacked index of the spectral shard a distributed group's rank
    holds (None on a stacked group): its rank, or for the pencil its
    block b = j Px + i at mesh position (i, j)."""
    if not mesh.distributed:
        return None
    if decomp == "pencil":
        px, py = mesh.shape
        return (mesh.rank % py) * px + mesh.rank // py
    return mesh.rank


def _local(a: torch.Tensor, k: Optional[int], lead: int = 0
           ) -> torch.Tensor:
    """The stacked shards a (L..., P, ...) -> the rank's (L..., 1, ...)
    at index k, a copy of its own; a itself when k is None."""
    if k is None:
        return a
    return a.narrow(lead, k, 1).clone()


def _local_tables(t: SpectralTables, mesh: ShardGroup, decomp: str
                  ) -> SpectralTables:
    """A stacked group's sharded tables -> the rank's, every sharded
    table sliced to its shard (kx of the x-pencil and pencil and ky of
    the slab are whole)."""
    k = spectral_index(mesh, decomp)
    if k is None:
        return t
    whole = "ky" if decomp == "slab" else "kx"
    out = {name: getattr(t, name) if name == whole else
           _local(getattr(t, name), k) for name in SpectralTables.NAMES}
    return SpectralTables(out, t.lap.device)


def exchange_shapes(cfg, n_shards: int) -> dict:
    """The exchange buffers' shapes of the kernel impls over ranks: the
    row shards (nx/P, hny) and the column shards (nx, hpad/P)."""
    hny = cfg.ny // 2 + 1
    return {"rows": (cfg.nx // n_shards, hny),
            "cols": (cfg.nx, xpencil.hpad_for(hny, n_shards) // n_shards)}


def _decomp_setup(cfg, mesh: ShardGroup, fft_impl: str, decomp: str,
                  fast: bool = False):
    """(sharded tables, fwd, inv, hpad, exchange) of a decomposition; hpad
    None for the slab, whose spectral state is not padded; `fast`: the
    overlap x-stages' fast forms. On a distributed group the tables are
    the rank's, the pair its collectives or ranked kernels, and exchange
    the kernel impls' buffers (parallel/peer.py; else None)."""
    check_decomp(cfg, mesh, fft_impl, decomp)
    n = mesh.n_shards
    t = SpectralTables.from_config(cfg, mesh.device)
    hny = cfg.ny // 2 + 1
    group = mesh if mesh.distributed else None
    ex = None
    if group is not None and fft_impl != "xla":
        from .peer import Exchange
        ex = Exchange(mesh, exchange_shapes(cfg, n))
    if decomp == "pencil":
        out = (xpencil.shard_tables(t, n),
               *pencil.make_fft_pair(mesh.shape, hny, group),
               xpencil.hpad_for(hny, n))
    elif decomp == "xpencil":
        out = (xpencil.shard_tables(t, n),
               *xpencil.make_fft_pair(hny, fft_impl, fast, group, ex),
               xpencil.hpad_for(hny, n))
    else:
        out = (_slab_tables(t, n), *_slab_pair(fft_impl, fast, group, ex),
               None)
    return (_local_tables(out[0], mesh, decomp), *out[1:], ex)


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
        (self.tables, self._fwd, self._inv, self.hpad,
         self.exchange) = _decomp_setup(cfg, mesh, fft_impl, decomp,
                                        self.fast)
        # the stacked indices of this rank's spectral and physical shards
        # (None on a stacked group)
        self._k = spectral_index(mesh, decomp)
        self._d = mesh.rank
        self.dt = float(cfg.dt)
        self.nu = float(cfg.nu)
        self.r_drag = float(cfg.r_drag)
        self.nu4 = float(cfg.nu4)
        self.etd_tables = None

    @property
    def spectral_shape(self) -> tuple:
        """The spectral shards this process holds: P stacked, or the
        rank's one on a distributed group."""
        n, (nx, ny) = self.n_shards, self.cfg.grid_shape
        lead = self.mesh.local_shards
        if self.hpad is not None:
            return (lead, nx, self.hpad // n)
        return (lead, nx // n, ny // 2 + 1)

    @property
    def physical_shape(self) -> tuple:
        """The physical shards: tiles (P, nx/Px, ny/Py) for the pencil,
        else row shards (P, nx/P, ny); the rank's one on a distributed
        group."""
        n, (nx, ny) = self.n_shards, self.cfg.grid_shape
        lead = self.mesh.local_shards
        if self.decomp == "pencil":
            px, py = self.mesh.shape
            return (lead, nx // px, ny // py)
        return (lead, nx // n, ny)

    def _etd_hpad(self) -> int:
        """The ETD tables' pad: hpad where the x-pencil pads, else 0 (the
        JAX sharded models' cache key)."""
        hny = self.cfg.ny // 2 + 1
        return self.hpad if self.hpad and self.hpad > hny else 0

    def _shard_table(self, a: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """A global spectral table (L..., nx, hny[pad]) with `lead`
        leading axes -> the state's layout, leading axes kept."""
        if self.hpad is not None:
            return _local(xpencil.shard_state(a, self.n_shards), self._k,
                          lead)
        return _local(dfft.shard_rows(a, self.n_shards, lead), self._k,
                      lead)

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
                f"{'rank' if self.mesh.distributed else 'stacked'} shards "
                f"{self.physical_shape}, got {tuple(src.shape)}")
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
            return _local(xpencil.shard_state(z, self.n_shards), self._k)
        return _local(dfft.shard_rows(z, self.n_shards).contiguous(),
                      self._k)

    def _gather(self, shard: torch.Tensor, spectral: bool) -> torch.Tensor:
        """The stacked shards from every rank's (a collective,
        multihost.gather_to_host), in the stacked order: the pencil's
        spectra from mesh order to block order."""
        got = multihost.gather_to_host(shard).to(self.device)
        if spectral and self.decomp == "pencil":
            px, py = self.mesh.shape
            got = got.unflatten(0, (px, py)).transpose(0, 1).flatten(0, 1)
        return got

    def unshard_spectral(self, zeta_hat: torch.Tensor) -> torch.Tensor:
        """The sharded state -> the global (nx, hny) on the card; on a
        distributed group a collective, every rank getting it."""
        if self.mesh.distributed:
            zeta_hat = self._gather(zeta_hat, True)
        if self.hpad is not None:
            return xpencil.unshard_state(zeta_hat, self.cfg.ny // 2 + 1)
        return dfft.unshard_rows(zeta_hat)

    def shard_physical(self, field) -> torch.Tensor:
        """A global (nx, ny) field -> its physical shards: tiles for the
        pencil, else row shards (the rank's on a distributed group)."""
        f = torch.as_tensor(field, dtype=torch.float32, device=self.device)
        if self.decomp == "pencil":
            return _local(pencil.shard_tiles(f, self.mesh.shape), self._d)
        return _local(dfft.shard_rows(f, self.n_shards).contiguous(),
                      self._d)

    def unshard_physical(self, field: torch.Tensor) -> torch.Tensor:
        """The physical shards -> the global (nx, ny); on a distributed
        group a collective."""
        if self.mesh.distributed:
            field = self._gather(field, False)
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
        group = self.mesh if self.mesh.distributed else None
        if self.decomp == "pencil":
            return self._fwd(f)
        if self.decomp == "xpencil":
            return xpencil.rfft2_local(f, "xla", group=group)
        return dfft.rfft2_local(f, group=group)


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
