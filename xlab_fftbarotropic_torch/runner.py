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
runner does. A --shard run steps the barotropic family on the sharded
model (parallel/model.py), whose records and checkpoints are the global
fields; it has no per-record stats, as in the JAX runner.
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
from .models.shallow_water import ShallowWaterModel
from .config import ModelConfig
from .forcing.source import SourceReader, make_reader
from .io.checkpoint import load_checkpoint, save_checkpoint
from .io.fieldio import FieldRecorder, Manifest, read_field
from .models.tracer import TracerModel, tracer_ic
from .utils.guards import check_etd_cfl, check_finite

# what is not ported yet, by ROADMAP.md queue A item
_NOT_PORTED = {"fd": 3, "jacobian": 3}


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
        d = self.model.diags(state)._asdict()
        if self.sharded:
            d = {k: self.model.unshard_physical(v) for k, v in d.items()}
        return _gather_fields(d, only)

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
    complex64 (2, nx, hny) [zeta_hat, q_hat], as in the JAX package."""

    kind = "tracer"

    def __init__(self, cfg: ModelConfig, device, kappa: float = 0.0,
                 ic: str = "vorticity"):
        self.cfg = cfg
        self.ic = ic
        self.model = TracerModel.build(cfg, device, kappa=kappa)
        self.device = self.model.device

    def init_from_physical(self, vort0):
        return self.model.init_state(vort0, tracer_ic(self.cfg, self.ic,
                                                      vort0))

    def step(self, state, src):
        return self.model.step(state, src)

    def segment(self, state, src, n):
        return self.model.segment(state, src, n)

    def record_fields(self, state, only=None):
        return _gather_fields(self.model.diags(state)._asdict(), only)

    def stats(self, state):
        return {k: float(v) for k, v in
                self.model.stats(state)._asdict().items()}

    def pack(self, state):
        return convert.tracer_state_to_numpy(state)

    def unpack(self, packed):
        return convert.tracer_state_from_numpy(
            np.asarray(packed, np.complex64), self.device)


class _ShallowWaterAdapter:
    """Rotating shallow water (models/shallow_water.py): starts from the
    geostrophically balanced state, records vort, psi, u, v, div and
    h = H + eta. The checkpoint state is the stacked complex64
    (3, nx, hny) [zeta_hat, div_hat, eta_hat], as in the JAX package."""

    kind = "shallow-water"

    def __init__(self, cfg: ModelConfig, device, yfirst: bool = True):
        self.cfg = cfg
        self.model = ShallowWaterModel.build(cfg, device, yfirst=yfirst)
        self.device = self.model.device

    def init_from_physical(self, vort0):
        return self.model.geostrophic_init(vort0)

    def step(self, state, src):
        return self.model.step(state, src)

    def segment(self, state, src, n):
        return self.model.segment(state, src, n)

    def record_fields(self, state, only=None):
        d = self.model.diags(state)
        return _gather_fields(dict(vort=d.vort, psi=d.psi, u=d.u, v=d.v,
                                   div=d.div, h=d.h), only)

    def debug_record_fields(self, state, src):
        """--debug-fields dumps: step-start zeta gradients and the full
        vorticity tendency (models/shallow_water.py:debug)."""
        return {k: _host(v) for k, v in
                self.model.debug(state, src)._asdict().items()}

    def stats(self, state):
        return {k: float(v) for k, v in
                self.model.stats(state)._asdict().items()}

    def pack(self, state):
        return convert.sw_state_to_numpy(state)

    def unpack(self, packed):
        return convert.sw_state_from_numpy(np.asarray(packed, np.complex64),
                                           self.device)


def make_adapter(cfg: ModelConfig, device, model_kind: str = "barotropic",
                 shard: bool = False, ensemble: int = 0,
                 tracer_kappa: float = 0.0, tracer_ic: str = "vorticity",
                 yfirst: bool = True, bt_fusion: Optional[dict] = None,
                 shard_fft: str = "xla", decomp: str = "slab"):
    if ensemble and ensemble > 1:
        raise NotImplementedError(
            "ensemble runs are not ported yet (ROADMAP.md queue A, item 3)")
    if shard:
        # the barotropic family over the visible card (one shard; the CPU
        # too); make_mesh and build refuse what waits (item 5)
        from .parallel import ShardedBarotropicModel, make_mesh
        if model_kind not in ("barotropic", "bt"):
            raise NotImplementedError(
                f"--shard for model kind {model_kind!r} is not ported yet "
                f"(ROADMAP.md queue A, item 5): the barotropic family "
                f"shards")
        return _BarotropicAdapter(cfg, device, model=(
            ShardedBarotropicModel.build(cfg, make_mesh(None, device),
                                         fft_impl=shard_fft, decomp=decomp)))
    if model_kind in ("barotropic", "bt"):
        return _BarotropicAdapter(cfg, device, yfirst, **(bt_fusion or {}))
    if model_kind == "tracer":
        return _TracerAdapter(cfg, device, kappa=tracer_kappa, ic=tracer_ic)
    if model_kind in ("shallow-water", "sw"):
        return _ShallowWaterAdapter(cfg, device, yfirst)
    if model_kind in _NOT_PORTED:
        raise NotImplementedError(
            f"model kind {model_kind!r} is not ported yet (ROADMAP.md "
            f"queue A, item {_NOT_PORTED[model_kind]})")
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
        decomp: str = "slab") -> RunResult:
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
    fusetail (None: the defaults). shard: the barotropic family on the
    sharded model (parallel/model.py) over the visible card, with
    shard_fft its transform impl ('xla', 'pallas', 'overlap') and decomp
    its decomposition ('slab', 'xpencil').
    """
    adapter = make_adapter(cfg, device, model_kind, shard=shard,
                           ensemble=ensemble, tracer_kappa=tracer_kappa,
                           tracer_ic=tracer_ic, yfirst=yfirst,
                           bt_fusion=bt_fusion, shard_fft=shard_fft,
                           decomp=decomp)
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

    manifest = Manifest(manifest_path) if record else None
    recorder = FieldRecorder(cfg.output_dir, manifest) if record else None

    stats_history = []
    t0 = _time.perf_counter()
    step = start_step

    def do_record(step, state, src_np, src):
        fields = adapter.record_fields(state, only=record_only)
        check_finite(step, **fields)
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
                if progress or step_banners:
                    print(f"# Step {step}, time = {step * cfg.dt:.2f}, "
                          f"record now!", file=sys.stderr)
            elif step_banners:
                print(f"# Step {step}, time = {step * cfg.dt:.2f}",
                      file=sys.stderr)
            if cfg.checkpoint_step and step % cfg.checkpoint_step == 0 and \
                    step > start_step:
                save_checkpoint(
                    Path(cfg.output_dir) / f"ckpt_step_{step}.npz",
                    cfg, adapter.pack(state), step, kind=adapter.kind)

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
                if step_banners:
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
