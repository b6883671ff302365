"""The port runs without jax and without the JAX package: in a fresh
interpreter (no GPU visible), it imports every module, steps the
barotropic (also in a fusion arm), tracer and shallow-water models
twice on the CPU in both time schemes (RK4 and ETDRK4), on the plane
stepper and on the library path, the SW model with drag on the
per-transform path, takes a gradient through the adjoint rollout on
both transform triples, steps the sharded barotropic model in every
decomposition and transform impl, and ends with no
jax and no xlab_fftbarotropic_tpu module loaded; and its CLIs refuse to
run without a GPU unless told --device cpu."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = """
import sys
import numpy as np
import torch
import xlab_fftbarotropic_torch
from xlab_fftbarotropic_torch import adjoint, config, convert, runner
from xlab_fftbarotropic_torch.cli import assimilate, run
from xlab_fftbarotropic_torch.forcing import source
from xlab_fftbarotropic_torch.io import checkpoint, fieldio, native_stream
from xlab_fftbarotropic_torch.ops import (_build, fft, fused_diff, fused_fft,
                                          fused_sw, fused_tracer, spectral)
from xlab_fftbarotropic_torch.models import etdrk4
from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
from xlab_fftbarotropic_torch.models.shallow_water import ShallowWaterModel
from xlab_fftbarotropic_torch.models.tracer import TracerModel, tracer_ic
from xlab_fftbarotropic_torch.parallel import (dfft, fused_overlap,
                                               fused_transpose, model,
                                               pencil, xpencil)
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.ic import makefields
from xlab_fftbarotropic_torch.utils import guards

cpu = torch.device("cpu")
for scheme in ("rk4", "etdrk4"):
    for backend in ("pallas", "xla"):
        cfg = ModelConfig(nx=64, ny=64, time_scheme=scheme,
                          fft_backend=backend)
        m = BarotropicModel.build(cfg, cpu)
        assert m.backend == backend
        z = m.segment(m.init_state(makefields.gaussian(cfg)),
                      m.zero_source(), 2)
        assert bool(torch.isfinite(m.diags(z).vort).all())
        arm = BarotropicModel.build(cfg, cpu, fusekb="full", fusekx=False,
                                    fusetail=True)
        assert torch.equal(arm.segment(m.init_state(makefields.gaussian(cfg)),
                                       m.zero_source(), 2), z)
        tm = TracerModel.build(cfg, cpu, kappa=50.0)
        assert tm.backend == backend
        s = tm.segment(tm.init_state(makefields.gaussian(cfg),
                                     tracer_ic(cfg, "gaussian")),
                       tm.zero_source(), 2)
        assert bool(torch.isfinite(tm.diags(s).q).all())
        sm = ShallowWaterModel.build(cfg, cpu)
        assert sm.backend == backend
        w = sm.segment(sm.geostrophic_init(makefields.gaussian(cfg,
                                                               zeta0=1e-5)),
                       sm.zero_source(), 2)
        assert bool(torch.isfinite(sm.diags(w).h).all())
    cfg = ModelConfig(nx=64, ny=64, fft_backend=backend, r_drag=2e-4)
    sm = ShallowWaterModel.build(cfg, cpu, fused_rk=False)
    assert sm.per_transform == (backend == "pallas")
    w = sm.segment(sm.geostrophic_init(makefields.gaussian(cfg,
                                                           zeta0=1e-5)),
                   sm.zero_source(), 2)
    assert bool(torch.isfinite(sm.diags(w).h).all())
    loss = adjoint.final_state_misfit(cfg, np.zeros((64, 64), np.float32), 2,
                                      device="cpu")
    _, g = adjoint.loss_and_grad(loss, device="cpu")(
        makefields.gaussian(cfg), np.zeros((64, 64), np.float32))
    assert bool(torch.isfinite(g).all())
for scheme in ("rk4", "etdrk4"):
    cfg = ModelConfig(nx=64, ny=64, time_scheme=scheme)
    for decomp in ("slab", "xpencil"):
        for impl in ("xla", "pallas", "overlap"):
            m = model.ShardedBarotropicModel.build(
                cfg, model.make_mesh(4, cpu), impl, decomp)
            z = m.segment(m.init_state(makefields.gaussian(cfg)),
                          m.zero_source(), 2)
            assert bool(torch.isfinite(m.diags(z).vort).all())
assert "jax" not in sys.modules, sorted(k for k in sys.modules if "jax" in k)
tpu = sorted(k for k in sys.modules if k.startswith("xlab_fftbarotropic_tpu"))
assert not tpu, tpu
print("NOJAX-OK")
"""


def _env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def test_port_imports_and_steps_without_jax():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX-OK" in proc.stdout


@pytest.mark.parametrize("family", [[], ["-m", "tracer"], ["-m", "sw"]])
def test_cli_without_gpu_stops_unless_told_cpu(tmp_path, family):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "xlab_fftbarotropic_torch.cli.run", "-O",
         str(out), "--nx", "64", "--ny", "64", "--total-steps", "1"]
        + family, cwd=tmp_path, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not out.exists()


def test_assimilate_cli_without_gpu_stops(tmp_path):
    out = tmp_path / "rec.bin"
    proc = subprocess.run(
        [sys.executable, "-m", "xlab_fftbarotropic_torch.cli.assimilate",
         "--nx", "64", "--ny", "64", "--target", "t.bin", "--guess",
         "g.bin", "--out", str(out), "--steps", "2"], cwd=tmp_path,
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not out.exists()
