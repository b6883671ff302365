"""The port runs without jax: in a fresh interpreter (no GPU visible), it
imports, steps the barotropic, tracer and shallow-water models twice on
the CPU and ends with no jax module loaded; and its CLI refuses to run
without a GPU unless told --device cpu."""

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
from xlab_fftbarotropic_torch import convert, reused, runner
from xlab_fftbarotropic_torch.cli import run
from xlab_fftbarotropic_torch.ops import (_build, fft, fused_fft, fused_sw,
                                          fused_tracer, spectral)
from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
from xlab_fftbarotropic_torch.models.shallow_water import ShallowWaterModel
from xlab_fftbarotropic_torch.models.tracer import TracerModel, tracer_ic
from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic import makefields

cfg = ModelConfig(nx=64, ny=64)
m = BarotropicModel.build(cfg, torch.device("cpu"))
assert m.backend == "pallas"
z = m.segment(m.init_state(makefields.gaussian(cfg)), m.zero_source(), 2)
assert bool(torch.isfinite(m.diags(z).vort).all())
tm = TracerModel.build(cfg, torch.device("cpu"), kappa=50.0)
assert tm.backend == "pallas"
s = tm.segment(tm.init_state(makefields.gaussian(cfg),
                             tracer_ic(cfg, "gaussian")),
               tm.zero_source(), 2)
assert bool(torch.isfinite(tm.diags(s).q).all())
sm = ShallowWaterModel.build(cfg, torch.device("cpu"))
assert sm.backend == "pallas"
w = sm.segment(sm.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5)),
               sm.zero_source(), 2)
assert bool(torch.isfinite(sm.diags(w).h).all())
assert "jax" not in sys.modules, sorted(k for k in sys.modules if "jax" in k)
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
