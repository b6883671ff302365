"""Examples 10 (Rossby wave), 11 (ETDRK4 big step) and 12 (hyperviscous
ETDRK4) through the port's commands: each example_torch.sh on the CPU
(DEVICE=cpu) at NX = 32 and a few steps, in a copy of the example's
folder, its outputs finite and its own checks passed (examples 03, 08,
09: tests/test_torch_examples_tracer_drag.py)."""

import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
N = 32


def _run(tmp_path, example, **env):
    work = tmp_path / "examples" / example
    shutil.copytree(REPO / "examples" / example, work)
    # the ETD tables go to the example's own cache (out_etd/etd_cache)
    base = {k: v for k, v in os.environ.items() if k != "XFB_ETD_CACHE"}
    env = dict(base, NX=str(N), DEVICE="cpu", PYTHONPATH=str(REPO),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", **env)
    proc = subprocess.run(["bash", str(work / "example_torch.sh")], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return work, proc.stdout


def _field(path) -> np.ndarray:
    a = np.fromfile(path, np.float32)
    assert a.size == N * N and np.isfinite(a).all(), path
    return a


def test_example_10_rossby_wave(tmp_path):
    """The single zonal mode under beta: its measured phase is the
    analytic one and its amplitude the viscous decay's."""
    work, out = _run(tmp_path, "10-rossby-wave", STEPS="20", REC="10")
    for step in (0, 10):
        _field(work / "out" / f"vort_step_{step}.bin")
    rows = [[float(v) for v in line.split()] for line in out.splitlines()
            if line.strip() and not line.startswith("#")]
    assert [r[0] for r in rows] == [0, 10]
    for _, phase, want, amp, decay in rows:
        assert abs(phase - want) <= 1e-3 and abs(amp - decay) <= 1e-3


def test_example_11_etdrk4_bigstep(tmp_path):
    """SW ETDRK4 at 4.5x the RK4 bound against RK4 at 0.9x it (the
    script's own check), and RK4 at the big dt caught by the guard."""
    work, out = _run(tmp_path, "11-etdrk4-bigstep", REC="4")
    for d, step in (("out_etd", 4), ("out_rk4", 0)):
        for name in ("vort", "h", "div"):
            _field(work / d / f"{name}_step_{step}.bin")
    assert "OK: big-step ETDRK4 matches" in out
    assert "caught by the NaN guard" in out


def test_example_12_hyperviscous_etd(tmp_path):
    """Barotropic ETDRK4 at 6x the hyperviscous RK4 bound against RK4 at
    0.9x it (the script's own check), and RK4 at the big dt caught."""
    work, out = _run(tmp_path, "12-hyperviscous-etd")
    _field(work / "out_rk4" / "vort_step_40.bin")
    _field(work / "out_etd" / "vort_step_6.bin")
    assert any((work / "out_etd" / "etd_cache").iterdir())
    assert "OK: big-step scalar ETDRK4 matches" in out
    assert "caught by the NaN guard" in out
