"""The port against the independent C++ oracle (native/ref_oracle.cpp: its
own radix-2 float32 FFT, nothing shared with numpy, torch or XLA) on
BASELINE config #1: 256^2 gaussian, 100 RK4 steps, both stepping paths of
the port on the CPU. Bar: rel-L2 < 3e-6 on the final vorticity, the bar
tests/test_c_oracle.py holds the JAX model to."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.io.fieldio import read_field, write_field
from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel

REPO = Path(__file__).resolve().parents[1]
ORACLE = REPO / "native" / "ref_oracle.out"


def _oracle_available() -> bool:
    if ORACLE.exists():
        return True
    if shutil.which("make") is None:
        return False
    r = subprocess.run(["make", "-C", str(REPO / "native"), "ref_oracle.out"],
                       capture_output=True, text=True)
    return r.returncode == 0 and ORACLE.exists()


@pytest.fixture(scope="module")
def c_final(tmp_path_factory):
    if not _oracle_available():
        pytest.skip("no C++ toolchain to build native/ref_oracle.out")
    d = tmp_path_factory.mktemp("c_oracle_torch")
    cfg = ModelConfig(nx=256, ny=256, dt=3.0, total_steps=100,
                      record_step=50)
    vort0 = makefields.gaussian(cfg)
    write_field(d / "init.bin", vort0)
    (d / "out").mkdir()
    subprocess.run([str(ORACLE), "256", "256", str(cfg.lx), str(cfg.ly),
                    "3.0", str(cfg.nu), "100", "50", str(d / "init.bin"),
                    str(d / "out")], check=True, timeout=300)
    return cfg, vort0, read_field(d / "out" / "vort_final.bin",
                                  cfg.grid_shape)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_port_matches_c_oracle(c_final, backend):
    cfg, vort0, want = c_final
    m = BarotropicModel.build(cfg.replace(fft_backend=backend),
                              torch.device("cpu"))
    z = m.segment(m.init_state(vort0), m.zero_source(), 100)
    got = m.diags(z).vort.numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 3e-6, rel
