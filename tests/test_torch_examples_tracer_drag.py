"""Examples 03 (tracer mixing), 08 (adjoint 4DVar) and 09 (drag
spin-down) through the port's commands: each example_torch.sh on the CPU
(DEVICE=cpu) at NX = 32 and a few steps, in a copy of the example's
folder, its outputs finite (examples 10-12:
tests/test_torch_examples_beta_etd.py)."""

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


def test_example_03_tracer_mixing(tmp_path):
    """The Kuo2004-stirred gaussian tracer, then eddy diffusivity of each
    q record and the spectrum of each vorticity record."""
    work, out = _run(tmp_path, "03-tracer-mixing", STEPS="20", REC="10")
    for step in (0, 10):
        q = _field(work / "output" / f"q_step_{step}.bin")
        assert q.any()
        _field(work / "output" / f"vort_step_{step}.bin")
        eddy = np.fromfile(work / "output" / f"eddydiff_step_{step}.bin",
                           np.float32)
        assert eddy.size and np.isfinite(eddy).all()
        spec = np.loadtxt(work / "output" / f"spectrum_step_{step}.txt")
        assert spec.size and np.isfinite(spec).all()
    assert out.count("eddy-diffusivity output/q_step_") == 2
    assert out.count("spectrum output/vort_step_") == 2


def test_example_08_adjoint_4dvar(tmp_path):
    """The twin experiment: a few Adam iterations lower the misfit."""
    work, out = _run(tmp_path, "08-adjoint-4dvar", STEPS="5", ITERS="10")
    losses = np.loadtxt(work / "output" / "loss_history.txt")
    assert losses.shape == (11,) and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    for name in ("truth", "guess", "recovered"):
        _field(work / "output" / f"vort_{name}.bin")
    assert "misfit J:" in out and "IC error" in out


def test_example_09_drag_spindown(tmp_path):
    """Free and dragged Kuo2004 runs and the spin-down table: the drag
    run's max |zeta| under the free run's after the first record."""
    work, out = _run(tmp_path, "09-drag-spindown", STEPS="20", REC="10")
    for d in ("out_free", "out_drag"):
        for step in (0, 10):
            _field(work / d / f"vort_step_{step}.bin")
    rows = [line.split() for line in out.splitlines()
            if line.strip() and not line.startswith("#")]
    assert [int(r[0]) for r in rows] == [0, 10]
    assert float(rows[0][3]) == 1.0 and float(rows[1][3]) < 1.0
