"""Run orchestration: the counterpart of xlab_fftbarotropic_tpu/runner.py
for the barotropic, tracer and shallow-water families.

The time loop of main.cpp / main-shallow-water.cpp: the model advances
in segments between record, checkpoint and forcing-recipe boundaries;
host work (field records, the `log` manifest, per-record scalars,
checkpoints, forcing updates) happens only at those boundaries. Records,
manifest, checkpoints and forcing streams go through the port's copies
of the JAX package's numpy-only modules (io/, forcing/), so the output
files are byte-compatible with its runner's and a checkpoint from either
resumes in the other. Under ETDRK4 each record's cfl stat is held to the
scheme's advective limit (utils/guards.py:check_etd_cfl), as the JAX
runner does. A --shard run steps any of the three families on its
sharded model (parallel/model.py), whose records and checkpoints are the
global fields; it has no per-record stats, as in the JAX runner. On an
initialized torch.distributed runtime (parallel/multihost.py) a --shard
run holds one shard per rank: every rank gathers the records and the
checkpoint state (collectives), and rank 0 alone writes the manifest,
the records and the checkpoints (the JAX runner's multi-process rule); a
checkpoint holds the global state, so any number of ranks resumes it.
An --ensemble run steps M perturbed members (models/ensemble.py) and
records each into its own tree (output/m00/...); -m fd (or jacobian)
steps the finite-difference core (models/fd_core.py).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time as _time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import convert
from .models.barotropic import BarotropicModel
from .models.shallow_water import ShallowWaterModel, SWState
from .config import ModelConfig
from .forcing.source import SourceReader, make_reader
from .io.checkpoint import load_checkpoint, save_checkpoint
from .io.fieldio import FieldRecorder, Manifest, read_field
from .models.tracer import TracerModel, TracerState, tracer_ic
from .parallel.multihost import is_primary
from .utils.guards import check_etd_cfl, check_finite



@dataclasses.dataclass
class RunResult:
    zeta_hat: torch.Tensor    # the state: tracer runs hold a TracerState
    steps_run: int
    wall_time: float
    stats_history: list


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _gather_fields(fields: dict, only=None) -> dict:
    """The requested subset of record fields as host numpy; unknown
    names are an error so a typo cannot silently drop a record stream."""
    if only is not None:
        want = set(only) - {"vort_src"}
        unknown = want - set(fields)
        if unknown:
            raise ValueError(
                f"--record-fields: unknown field(s) {sorted(unknown)}; "
                f"this model records {sorted(fields)} (+ vort_src)")
        fields = {k: v for k, v in fields.items() if k in want}
    return {k: _host(v) for k, v in fields.items()}


def _global(model, diags) -> dict:
    """A model's diagnostic fields by name, a sharded model's as global
    fields."""
    d = diags._asdict()
    if hasattr(model, "unshard_physical"):
        d = {k: model.unshard_physical(v) for k, v in d.items()}
    return d


class _BarotropicAdapter:
    """The facade the run loop drives: step/segment/diags/stats and state
    (de)hydration for checkpoints (complex64 numpy, as in the JAX
    package). `model` a ShardedBarotropicModel in place of the
    single-device one: records, checkpoints and stats then go through
    its unsharded global fields, and it has no debug fields or stats
    (as the JAX runner's sharded models)."""

    kind = "barotropic"

    def __init__(self, cfg: ModelConfig, device, yfirst: bool = True,
                 model=None, **fusion):
        self.cfg = cfg
        self.model = (model if model is not None else
                      BarotropicModel.build(cfg, device, yfirst=yfirst,
                                            **fusion))
        self.sharded = hasattr(self.model, "unshard_spectral")
        self.device = self.model.device

    def init_from_physical(self, vort0):
        return self.model.init_state(vort0)

    def step(self, state, src):
        return self.model.step(state, src)

    def segment(self, state, src, n):
        return self.model.segment(state, src, n)

    def record_fields(self, state, only=None):
        return _gather_fields(_global(self.model, self.model.diags(state)),
                              only)

    def debug_record_fields(self, state, src):
        """--debug-fields dumps (main.cpp OUTPUT_GRAD_VORT/OUTPUT_DVORTDT)."""
        if self.sharded:
            raise ValueError("--debug-fields is not supported with --shard "
                             "(the sharded model has no debug diagnostics)")
        return {k: _host(v) for k, v in
                self.model.debug(state, src)._asdict().items()}

    def stats(self, state):
        if self.sharded:
            return {}
        return {k: float(v) for k, v in
                self.model.stats(state)._asdict().items()}

    def pack(self, state):
        if self.sharded:
            state = self.model.unshard_spectral(state)
        return _host(state)

    def unpack(self, packed):
        if self.sharded:
            return self.model.shard_spectral(np.asarray(packed,
                                                        np.complex64))
        return torch.from_numpy(np.asarray(packed, np.complex64)).to(
            self.device)


class _TracerAdapter:
    """Passive-tracer family (models/tracer.py): barotropic dynamics plus
    a co-advected scalar q with its own diffusivity; records q_step_N.bin
    beside the reference field set. The checkpoint state is the stacked
    complex64 (2, nx, hny) [zeta_hat, q_hat], as in the JAX package.
    `model` a ShardedTracerModel in place of the single-device one:
    records and checkpoints go through its global fields, and it has no
    stats (as the JAX runner's sharded models)."""

    kind = "tracer"

    def __init__(self, cfg: ModelConfig, device, kappa: float = 0.0,
                 ic: str = "vorticity", fast: bool = False, model=None):
        self.cfg = cfg
        self.ic = ic
        self.model = (model if model is not None else
                      TracerModel.build(cfg, device, kappa=kappa, fast=fast))
        self.sharded = hasattr(self.model, "unshard_state")
        self.device = self.model.device

    def init_from_physical(self, vort0):
        return self.model.init_state(vort0, tracer_ic(self.cfg, self.ic,
                                                      vort0))

    def step(self, state, src):
        return self.model.step(state, src)

    def segment(self, state, src, n):
        return self.model.segment(state, src, n)

    def record_fields(self, state, only=None):
        return _gather_fields(_global(self.model, self.model.diags(state)),
                              only)

    def stats(self, state):
        if self.sharded:
            return {}
        return {k: float(v) for k, v in
                self.model.stats(state)._asdict().items()}

    def pack(self, state):
        if self.sharded:
            state = self.model.unshard_state(state)
        return convert.tracer_state_to_numpy(state)

    def unpack(self, packed):
        state = convert.tracer_state_from_numpy(
            np.asarray(packed, np.complex64), self.device)
        return self.model.shard_state(state) if self.sharded else state


class _ShallowWaterAdapter:
    """Rotating shallow water (models/shallow_water.py): starts from the
    geostrophically balanced state, records vort, psi, u, v, div and
    h = H + eta. The checkpoint state is the stacked complex64
    (3, nx, hny) [zeta_hat, div_hat, eta_hat], as in the JAX package.
    `model` a ShardedShallowWaterModel as the tracer adapter's: no stats
    and no debug fields (as the JAX runner's sharded models)."""

    kind = "shallow-water"

    def __init__(self, cfg: ModelConfig, device, yfirst: bool = True,
                 model=None, **form):
        self.cfg = cfg
        self.model = (model if model is not None else
                      ShallowWaterModel.build(cfg, device, yfirst=yfirst,
                                              **form))
        self.sharded = hasattr(self.model, "unshard_state")
        self.device = self.model.device

    def init_from_physical(self, vort0):
        return self.model.geostrophic_init(vort0)

    def step(self, state, src):
        return self.model.step(state, src)

    def segment(self, state, src, n):
        return self.model.segment(state, src, n)

    def record_fields(self, state, only=None):
        d = _global(self.model, self.model.diags(state))
        return _gather_fields({k: d[k] for k in ("vort", "psi", "u", "v",
                                                 "div", "h")}, only)

    def debug_record_fields(self, state, src):
        """--debug-fields dumps: step-start zeta gradients and the full
        vorticity tendency (models/shallow_water.py:debug)."""
        if self.sharded:
            raise ValueError("--debug-fields is not supported with --shard "
                             "(the sharded model has no debug diagnostics)")
        return {k: _host(v) for k, v in
                self.model.debug(state, src)._asdict().items()}

    def stats(self, state):
        if self.sharded:
            return {}
        return {k: float(v) for k, v in
                self.model.stats(state)._asdict().items()}

    def pack(self, state):
        if self.sharded:
            state = self.model.unshard_state(state)
        return convert.sw_state_to_numpy(state)

    def unpack(self, packed):
        state = convert.sw_state_from_numpy(np.asarray(packed, np.complex64),
                                            self.device)
        return self.model.shard_state(state) if self.sharded else state


class _EnsembleAdapter:
    """An M-member perturbed-IC ensemble (models/ensemble.py). Each
    member's fields record into a per-member subdirectory
    (output/m00/vort_step_N.bin, ...), so every member tree keeps the
    reference output contract; forcing is shared across members. The
    stats are each family scalar's member mean and standard deviation,
    and the spread. The checkpoint state is the member-stacked complex64
    (M, nx, hny) of the barotropic family, (3, M, nx, hny) of the
    shallow-water and (2, M, nx, hny) of the tracer family, as in the
    JAX package."""

    def __init__(self, cfg: ModelConfig, device, model_kind: str,
                 n_members: int, amplitude: float = 0.05, seed: int = 0,
                 tracer_kappa: float = 0.0, vmap_width=None, **build_kw):
        from .models.ensemble import EnsembleModel
        self.cfg = cfg
        self.amplitude = amplitude
        self.seed = seed
        self.model = EnsembleModel.build(cfg, device, n_members,
                                         model_kind=model_kind,
                                         tracer_kappa=tracer_kappa,
                                         vmap_width=vmap_width, **build_kw)
        self.device = self.model.device
        self._w = max(2, len(str(n_members - 1)))
        self.kind = f"ensemble-{type(self.model.inner).__name__}"

    def _prefix(self, k: int) -> str:
        return f"m{k:0{self._w}d}"

    def init_from_physical(self, vort0):
        return self.model.init_from_physical(vort0,
                                             amplitude=self.amplitude,
                                             seed=self.seed)

    def step(self, state, src):
        return self.model.step(state, src)

    def segment(self, state, src, n):
        return self.model.segment(state, src, n)

    def record_fields(self, state, only=None):
        batched = _gather_fields(self.model.diags(state)._asdict(), only)
        return {f"{self._prefix(k)}/{name}": batched[name][k]
                for k in range(self.model.n_members) for name in batched}

    def stats(self, state):
        d = {}
        for name, arr in self.model.stats(state)._asdict().items():
            vals = _host(arr).astype(np.float64)
            d[f"{name}_mean"] = float(vals.mean())
            d[f"{name}_std"] = float(vals.std())
        d["spread"] = float(self.model.spread(state))
        return d

    def pack(self, state):
        if isinstance(state, torch.Tensor):
            return _host(state)
        return np.stack([_host(a) for a in state])

    def unpack(self, packed):
        packed = np.asarray(packed, np.complex64)
        fields = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                  for a in (packed if packed.ndim == 4 else [packed])]
        kind = self.model.model_kind
        if kind in ("shallow-water", "sw"):
            return SWState(*fields)
        if kind == "tracer":
            return TracerState(*fields)
        return fields[0]


class _FDAdapter:
    """The finite-difference cross-check core (models/fd_core.py): the
    state is (physical zeta, carried psi), recorded as vort, psi, u and v
    with psi from poisson_fft, as in the JAX package; the checkpoint
    state is the stacked float32 (2, nx, ny)."""

    kind = "fd"

    def __init__(self, cfg: ModelConfig, device):
        from .models.fd_core import FDBarotropicModel
        self.cfg = cfg
        self.model = FDBarotropicModel.build(cfg, device)
        self.device = self.model.device

    def init_from_physical(self, vort0):
        z = torch.as_tensor(vort0, dtype=torch.float32, device=self.device)
        return (z, self.model.init_psi(z))

    def step(self, state, src):
        return self.model.step(state[0], state[1], src)

    def segment(self, state, src, n):
        return self.model.segment(state[0], state[1], src, n)

    def record_fields(self, state, only=None):
        from .models.fd_core import gradients, poisson_fft
        z = state[0]
        psi = poisson_fft(z, self.cfg.dx, self.cfg.dy)
        u, v = gradients(psi, self.cfg.dx, self.cfg.dy)
        return _gather_fields(dict(vort=z, psi=psi, u=u, v=v), only)

    def stats(self, state):
        z = _host(state[0])
        return dict(max_abs_vort=float(np.abs(z).max()),
                    enstrophy=float(0.5 * np.mean(z * z)))

    def pack(self, state):
        return np.stack([_host(a) for a in state])

    def unpack(self, packed):
        packed = np.asarray(packed, np.float32)
        return tuple(torch.from_numpy(a).to(self.device) for a in packed)


def shard_mesh(device, decomp: str = "slab", mesh_shape=None):
    """The shard group of a --shard run. On an initialized torch.distributed
    runtime (parallel/multihost.py) one shard per rank: the 1-D group, or
    for decomp 'pencil' the (Px, Py) group of `mesh_shape` (None: hosts
    on px, the ranks of a host on py, as the JAX runner's default).
    Without it one shard on the visible card (or the CPU; more than one
    visible card is refused by make_mesh), or the pencil's (1, 1) group;
    a pencil mesh_shape of more shards is refused. mesh_shape is ignored
    outside the pencil, as in the JAX runner."""
    from .parallel import make_mesh, make_mesh2d, multihost

    if multihost.is_initialized():
        if decomp != "pencil":
            return make_mesh(None, device)
        if mesh_shape is None:
            hosts = multihost.host_count()
            mesh_shape = (hosts, multihost.world_size() // hosts)
        return make_mesh2d(tuple(mesh_shape), device)
    mesh = make_mesh(None, device)
    if decomp != "pencil":
        return mesh
    shape = tuple(mesh_shape or (1, 1))
    n = math.prod(shape)
    if n != mesh.n_shards:
        raise NotImplementedError(
            f"mesh shape {shape} needs {n} ranks, got {mesh.n_shards}: run "
            f"one process per shard (torchrun --nproc-per-node {n} -m "
            f"xlab_fftbarotropic_torch.cli.run --shard ..., or "
            f"XFB_COORDINATOR, XFB_NUM_PROCESSES and XFB_PROCESS_ID; "
            f"ROADMAP.md queue A, item 5.2); "
            f"parallel.pencil.make_pencil_mesh({shape}) stacks the shards "
            f"in one process")
    return make_mesh2d(shape, device)


def make_adapter(cfg: ModelConfig, device, model_kind: str = "barotropic",
                 shard: bool = False, ensemble: int = 0,
                 tracer_kappa: float = 0.0, tracer_ic: str = "vorticity",
                 yfirst: bool = True, bt_fusion: Optional[dict] = None,
                 shard_fft: str = "xla", decomp: str = "slab",
                 ensemble_amp: float = 0.05, ensemble_seed: int = 0,
                 ensemble_width=None, sw_form: Optional[dict] = None,
                 tracer_fast: bool = False, mesh_shape=None):
    if ensemble and ensemble > 1:
        if shard:
            raise ValueError("--ensemble and --shard are mutually "
                             "exclusive (batch within a card, shard "
                             "across cards)")
        build_kw = {}
        if model_kind in ("barotropic", "bt"):
            build_kw = dict(yfirst=yfirst, **(bt_fusion or {}))
        elif model_kind in ("shallow-water", "sw"):
            build_kw = dict(yfirst=yfirst, **(sw_form or {}))
        elif model_kind == "tracer":
            build_kw = dict(fast=tracer_fast)
        else:
            raise ValueError(f"ensemble is not supported for model kind "
                             f"{model_kind!r}")
        return _EnsembleAdapter(cfg, device, model_kind, ensemble,
                                amplitude=ensemble_amp, seed=ensemble_seed,
                                tracer_kappa=tracer_kappa,
                                vmap_width=ensemble_width, **build_kw)
    if shard:
        # each family over the visible card (one shard, or the pencil's
        # 1 x 1 group; the CPU too); shard_mesh refuses more cards (item
        # 5.2); fast mode is the family's fast flag (the overlap
        # x-stages')
        from .parallel import (ShardedBarotropicModel,
                               ShardedShallowWaterModel, ShardedTracerModel)
        mesh = shard_mesh(device, decomp, mesh_shape)
        how = dict(fft_impl=shard_fft, decomp=decomp)
        if model_kind in ("barotropic", "bt"):
            return _BarotropicAdapter(cfg, device, model=(
                ShardedBarotropicModel.build(
                    cfg, mesh, **how,
                    fast=(bt_fusion or {}).get("fast", False))))
        if model_kind in ("shallow-water", "sw"):
            return _ShallowWaterAdapter(cfg, device, model=(
                ShardedShallowWaterModel.build(
                    cfg, mesh, **how,
                    fast=bool((sw_form or {}).get("fast", False)))))
        if model_kind == "tracer":
            return _TracerAdapter(cfg, device, ic=tracer_ic, model=(
                ShardedTracerModel.build(cfg, mesh, **how, fast=tracer_fast,
                                         kappa=tracer_kappa)))
        raise ValueError(
            f"--shard is not supported for model kind {model_kind!r}")
    if model_kind in ("barotropic", "bt"):
        return _BarotropicAdapter(cfg, device, yfirst, **(bt_fusion or {}))
    if model_kind == "tracer":
        return _TracerAdapter(cfg, device, kappa=tracer_kappa, ic=tracer_ic,
                              fast=tracer_fast)
    if model_kind in ("shallow-water", "sw"):
        return _ShallowWaterAdapter(cfg, device, yfirst, **(sw_form or {}))
    if model_kind in ("fd", "jacobian"):
        return _FDAdapter(cfg, device)
    raise ValueError(f"unknown model kind {model_kind!r}")


def run(cfg: ModelConfig,
        device,
        vort0: Optional[np.ndarray] = None,
        recipe: str = "empty",
        src_path=None,
        record: bool = True,
        manifest_path: str = "log",
        progress: bool = False,
        resume_from=None,
        model_kind: str = "barotropic",
        shard: bool = False,
        ensemble: int = 0,
        debug_fields: bool = False,
        step_banners: bool = False,
        record_only=None,
        tracer_kappa: float = 0.0,
        tracer_ic: str = "vorticity",
        yfirst: bool = True,
        bt_fusion: Optional[dict] = None,
        shard_fft: str = "xla",
        decomp: str = "slab",
        ensemble_amp: float = 0.05,
        ensemble_seed: int = 0,
        ensemble_width=None,
        sw_form: Optional[dict] = None,
        tracer_fast: bool = False,
        mesh_shape=None) -> RunResult:
    """Integrate cfg.total_steps of the chosen model family on `device`
    (runner.py:399 of the JAX package): model_kind 'barotropic',
    'tracer' (tracer_kappa: its diffusivity; tracer_ic: its initial
    condition, models/tracer.py:tracer_ic) or 'shallow-water' ('sw').

    vort0: physical initial vorticity; if None, read from
    cfg.input_dir/cfg.init_file (main.cpp:143-144). recipe 'empty',
    'script' (src_path: '<time> <field.bin>' lines) or 'fifo' (the
    per-step flag-byte protocol). record_only: field names to record
    (None = all); 'vort_src' gates the forcing dump. debug_fields also
    dumps dvortdx/dvortdy/dvortdt at record steps. step_banners prints
    the reference's '# Step N' line for every step (in a burst per
    segment). yfirst: the plane stepper's transform order of the
    barotropic and shallow-water families (False: x-first); the tracer
    family has one. bt_fusion: the barotropic plane stepper's fusion arm
    and RK form, BarotropicModel.build's fused_rk, fusekb, fusekx and
    fusetail (None: the defaults). sw_form: the shallow-water plane
    stepper's fast, split and pstore (ShallowWaterModel.build's; None:
    the defaults). tracer_fast: the tracer plane stepper in fast mode
    (TracerModel.build's fast; each width-1 ensemble member's too). shard:
    the family on its sharded model (parallel/model.py) over the visible
    card, with shard_fft its transform impl ('xla', 'pallas',
    'overlap'; 'xla' only for the pencil), decomp its decomposition
    ('slab', 'xpencil', 'pencil'; mesh_shape the pencil's (Px, Py), see
    shard_mesh) and
    bt_fusion's "fast", sw_form's "fast" or tracer_fast its fast mode
    (the overlap x-stages'). model_kind
    'fd' (or 'jacobian'): the finite-difference core. ensemble M > 1: M members
    (barotropic, tracer or shallow-water; not with shard) from vort0
    perturbed by ensemble_amp * rms(vort0) of band-limited noise drawn
    from ensemble_seed, member 0 the control, ensemble_width members per
    chunk (None: models/ensemble.py:auto_vmap_width).
    """
    adapter = make_adapter(cfg, device, model_kind, shard=shard,
                           ensemble=ensemble, tracer_kappa=tracer_kappa,
                           tracer_ic=tracer_ic, yfirst=yfirst,
                           bt_fusion=bt_fusion, shard_fft=shard_fft,
                           decomp=decomp, ensemble_amp=ensemble_amp,
                           ensemble_seed=ensemble_seed,
                           ensemble_width=ensemble_width, sw_form=sw_form,
                           tracer_fast=tracer_fast, mesh_shape=mesh_shape)
    if debug_fields and not hasattr(adapter, "debug_record_fields"):
        raise ValueError(
            f"--debug-fields is not supported for model kind {model_kind!r}")
    device = adapter.device

    start_step = 0
    if resume_from is not None:
        state_np, start_step, _ = load_checkpoint(resume_from, cfg,
                                                  kind=adapter.kind)
        state = adapter.unpack(state_np)
    else:
        if vort0 is None:
            vort0 = read_field(Path(cfg.input_dir) / cfg.init_file,
                               cfg.grid_shape)
        state = adapter.init_from_physical(vort0)

    src_np = np.zeros(cfg.grid_shape, dtype=np.float32)
    src = torch.tensor(src_np, device=device)
    reader: SourceReader = make_reader(cfg, recipe, src_path)

    # host file I/O belongs to rank 0 alone; the gathers (record fields,
    # the checkpoint state) are collectives and run on every rank
    primary = is_primary()
    manifest = Manifest(manifest_path) if (record and primary) else None
    recorder = (FieldRecorder(cfg.output_dir, manifest)
                if (record and primary) else None)

    stats_history = []
    t0 = _time.perf_counter()
    step = start_step

    def do_record(step, state, src_np, src):
        fields = adapter.record_fields(state, only=record_only)
        check_finite(step, **fields)
        if recorder is None:
            return
        want_src = record_only is None or "vort_src" in record_only
        recorder.record(step, vort_src=src_np if want_src else None,
                        **fields)
        if debug_fields:
            recorder.record(step, **adapter.debug_record_fields(state, src))

    etd = cfg.time_scheme == "etdrk4"
    per_step = recipe == "fifo"
    try:
        while step < cfg.total_steps:
            if record and step % cfg.record_step == 0:
                do_record(step, state, src_np, src)
                st = adapter.stats(state)
                stats_history.append(dict(step=step, **st))
                if etd and "cfl" in st:
                    # the big-dt scheme's one stability limit left: a
                    # warning at the initial record, AdvectiveCflError at
                    # the first violating later one
                    check_etd_cfl(step, st["cfl"], cfg,
                                  at_start=(step == start_step))
                if (progress or step_banners) and primary:
                    print(f"# Step {step}, time = {step * cfg.dt:.2f}, "
                          f"record now!", file=sys.stderr)
                if progress and "spread" in st:
                    print(f"# Ensemble spread = {st['spread']:.6e}",
                          file=sys.stderr)
            elif step_banners and primary:
                print(f"# Step {step}, time = {step * cfg.dt:.2f}",
                      file=sys.stderr)
            if cfg.checkpoint_step and step % cfg.checkpoint_step == 0 and \
                    step > start_step:
                packed = adapter.pack(state)   # a gather: every rank
                if primary:
                    save_checkpoint(
                        Path(cfg.output_dir) / f"ckpt_step_{step}.npz",
                        cfg, packed, step, kind=adapter.kind)

            if per_step:
                # main-shallow-water.cpp:304: the source read precedes
                # the step
                changed, field = reader.read(step * cfg.dt)
                if changed:
                    src_np = np.asarray(field, dtype=np.float32)
                    src = torch.tensor(src_np, device=device)
                state = adapter.step(state, src)
                step += 1
            else:
                boundaries = [
                    cfg.total_steps,
                    ((step // cfg.record_step) + 1) * cfg.record_step]
                if cfg.checkpoint_step:
                    boundaries.append(
                        ((step // cfg.checkpoint_step) + 1)
                        * cfg.checkpoint_step)
                if recipe == "script":
                    changed, field = reader.read(step * cfg.dt)
                    if changed:
                        src_np = np.asarray(field, dtype=np.float32)
                        src = torch.tensor(src_np, device=device)
                    nxt = _next_recipe_step(reader, cfg, step)
                    if nxt is not None:
                        boundaries.append(nxt)
                n = max(1, min(boundaries) - step)
                state = adapter.segment(state, src, n)
                if step_banners and primary:
                    for k in range(step + 1, step + n):
                        print(f"# Step {k}, time = {k * cfg.dt:.2f}",
                              file=sys.stderr)
                step += n
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        if manifest is not None:
            manifest.close()
        reader.close()
    wall = _time.perf_counter() - t0
    return RunResult(zeta_hat=state, steps_run=step - start_step,
                     wall_time=wall, stats_history=stats_history)


def _next_recipe_step(reader, cfg, step):
    """First future step at which a SCRIPT recipe fires, or None."""
    if not hasattr(reader, "recipes") or reader._next >= len(reader.recipes):
        return None
    t_next = reader.recipes[reader._next][0]
    return max(step + 1, int(math.ceil(t_next / cfg.dt)))
