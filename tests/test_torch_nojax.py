"""The port runs without jax and without the JAX package: in a fresh
interpreter (no GPU visible), it imports every module, runs the numpy
oracle and holds the barotropic model to it, steps the
barotropic (also in a fusion arm), tracer and shallow-water models
twice on the CPU in both time schemes (RK4 and ETDRK4), on the plane
stepper and on the library path, the SW model with drag on the
per-transform path, takes a gradient through the adjoint rollout on
both transform triples, steps the sharded barotropic model in every
decomposition and transform impl (the 2-D pencil on a 2x2 group) and,
on a one-rank torch.distributed runtime (parallel/multihost.py, gloo),
the sharded model of each impl on the ranked transposes (the exchange
buffers of parallel/peer.py for the kernel impls) within rel-L2 1e-7
of its stacked one-shard form, imports the multi-process tests' worker, runs
the post-processing pipeline's four commands (makefield, vort_src_input, invert_pres, find_min), the
diagnose and draw commands, -m fd, two ensembles, fast mode (also
through the model) and a --profile-dir run through the run command, and
ends with no jax and no xlab_fftbarotropic_tpu module loaded; and its
CLIs refuse to run without a GPU unless told --device cpu (draw has no
device: it draws with numpy and matplotlib)."""

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
# one intra-op thread: the 64^2 work is many small ops, and a test
# worker's subprocess shares the cores with the other workers
torch.set_num_threads(1)
import xlab_fftbarotropic_torch
from xlab_fftbarotropic_torch import adjoint, config, convert, runner
from xlab_fftbarotropic_torch.cli import assimilate, run
from xlab_fftbarotropic_torch.forcing import source
from xlab_fftbarotropic_torch.io import checkpoint, fieldio, native_stream
from xlab_fftbarotropic_torch.ops import (_build, fast_tile, fft, fused_diff,
                                          fused_fft, fused_sw, fused_tracer,
                                          spectral, xtile)
from xlab_fftbarotropic_torch.models import etdrk4
from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
from xlab_fftbarotropic_torch.models.shallow_water import ShallowWaterModel
from xlab_fftbarotropic_torch.models.tracer import TracerModel, tracer_ic
from xlab_fftbarotropic_torch.parallel import (dfft, fused_overlap,
                                               fused_transpose, model,
                                               pencil, xpencil)
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.ic import makefields
from xlab_fftbarotropic_torch.oracle import reference_cpu
from xlab_fftbarotropic_torch.utils import guards

cpu = torch.device("cpu")
# the numpy oracle, and the model on its trajectory
cfg = ModelConfig(nx=64, ny=64)
want = reference_cpu.OracleBarotropic(cfg).run(makefields.gaussian(cfg), 2)
m = BarotropicModel.build(cfg, cpu)
got = m.diags(m.segment(m.init_state(makefields.gaussian(cfg)),
                        m.zero_source(), 2)).vort.numpy()
assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6
assert np.isfinite(reference_cpu.oracle_invert_pressure(cfg, want)).all()
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
# fast mode (the fast column tile's plain versions), through the model
# and the run command
cfg = ModelConfig(nx=64, ny=64, beta=1e-11)
fm = BarotropicModel.build(cfg, cpu, fast=True)
z = fm.segment(fm.init_state(makefields.gaussian(cfg)), fm.zero_source(), 2)
assert fm.fast and bool(torch.isfinite(fm.diags(z).vort).all())
for scheme in ("rk4", "etdrk4"):
    cfg = ModelConfig(nx=64, ny=64, time_scheme=scheme)
    for decomp in ("slab", "xpencil"):
        for impl in ("xla", "pallas", "overlap"):
            m = model.ShardedBarotropicModel.build(
                cfg, model.make_mesh(4, cpu), impl, decomp)
            z = m.segment(m.init_state(makefields.gaussian(cfg)),
                          m.zero_source(), 2)
            assert bool(torch.isfinite(m.diags(z).vort).all())
    # the 2-D pencil decomposition (xla only)
    m = model.ShardedBarotropicModel.build(
        cfg, pencil.make_pencil_mesh((2, 2), cpu), decomp="pencil")
    z = m.segment(m.init_state(makefields.gaussian(cfg)), m.zero_source(), 2)
    assert bool(torch.isfinite(m.unshard_physical(m.diags(z).vort)).all())
# the post-processing pipeline through its four commands
import io, os, tempfile
from xlab_fftbarotropic_torch.cli import (find_min, invert_pres, makefield,
                                          vort_src_input)
from xlab_fftbarotropic_torch.diagnostics import invert_pres as dinv, tracks
tmp = tempfile.mkdtemp()
grid = ["--nx", "64", "--ny", "64"]
assert makefield.main(["kuo2004", "-I", tmp] + grid) == 0
saved = sys.stdout
sys.stdout = io.TextIOWrapper(io.BytesIO())
assert vort_src_input.main(grid + ["--dt", "900", "--total-steps", "24"]) == 0
sys.stdout.flush()
stream = sys.stdout.buffer.getvalue()
sys.stdout = saved
assert len(stream) == 23 + 2 * 4 * 64 * 64
psi = os.path.join(tmp, "initial_vorticity.bin")
pres = os.path.join(tmp, "pres_step_0.bin")
sys.stdin = io.StringIO(f"{psi}=>{pres}")
assert invert_pres.main(grid + ["--device", "cpu"]) == 0
sys.stdin = io.StringIO(pres)
assert find_min.main(grid + ["--device", "cpu", "--tracks",
                             os.path.join(tmp, "tracks.txt")]) == 0
assert os.path.getsize(os.path.join(tmp, "tracks.txt")) > 0
# the diagnostics and plots, the FD core, the ensemble, a profiled run
from xlab_fftbarotropic_torch.cli import diagnose, draw
from xlab_fftbarotropic_torch.diagnostics import (eddy_diffusivity,
                                                  kinematics, spectra)
from xlab_fftbarotropic_torch.models import ensemble, fd_core
from xlab_fftbarotropic_torch.viz import plots
vort = os.path.join(tmp, "vort_step_0.bin")
fieldio.write_field(vort, makefields.gaussian(ModelConfig(nx=64, ny=64)))
sys.stdin = io.StringIO(vort)
assert diagnose.main(grid + ["--device", "cpu", "-O", tmp] + [
    a for d in diagnose.DIAGNOSTICS for a in ("-d", d)]) == 0
assert os.path.exists(os.path.join(tmp, "spectrum_step_0.txt"))
assert draw.main(grid + ["-O", tmp, "--fig-dir", os.path.join(tmp, "fig"),
                         "--spectra"]) == 0
for extra in (["-m", "fd"], ["--ensemble", "2", "--ensemble-width", "1"],
              ["--ensemble", "2", "-m", "sw"], ["--fast-transforms"],
              ["--profile-dir", os.path.join(tmp, "prof")]):
    assert run.main(grid + ["-I", tmp, "-O", os.path.join(tmp, "o"),
                            "-i", "vort_step_0.bin", "--total-steps", "2",
                            "--record-step", "1", "--device", "cpu",
                            "--manifest", os.path.join(tmp, "log")]
                    + extra) == 0
assert os.path.exists(os.path.join(tmp, "prof", run.TRACE_NAME))
# one rank of the one-process-per-card runtime, and the multi-process
# tests' worker script
import socket
from xlab_fftbarotropic_torch.parallel import multihost, peer
sys.path.insert(0, "tests")
import torch_multihost_worker
sock = socket.socket()
sock.bind(("127.0.0.1", 0))
port = sock.getsockname()[1]
sock.close()
assert multihost.initialize(f"127.0.0.1:{port}", 1, 0, "cpu") is False
group = model.make_mesh(None, cpu)
assert group.distributed and group.rank == 0 and group.local_shards == 1
cfg = ModelConfig(nx=64, ny=64)
for decomp in ("slab", "xpencil"):
    for impl in ("xla", "pallas", "overlap"):
        ms = [model.ShardedBarotropicModel.build(cfg, g, impl, decomp)
              for g in (group, model.make_mesh(1, cpu))]
        zs = [m.unshard_spectral(m.segment(
            m.init_state(makefields.gaussian(cfg)), m.zero_source(), 2))
            for m in ms]
        # the rank's x-DFT runs on contiguous rows (dfft.fft_x ranked),
        # the stacked one shard's strided: equal up to round-off
        rel = float((zs[0] - zs[1]).norm() / zs[1].norm())
        print("ONE-RANK", decomp, impl, rel)
        assert rel <= 1e-7, (decomp, impl, rel)
        assert (ms[0].exchange is None) == (impl == "xla")
torch.distributed.destroy_process_group()
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
    assert "NOJAX-OK" in proc.stdout, proc.stdout


@pytest.mark.parametrize("family", [[], ["-m", "tracer"], ["-m", "sw"],
                                    ["-m", "fd"], ["--ensemble", "2"],
                                    ["--fast-transforms"]])
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


@pytest.mark.parametrize("cli", ["invert_pres", "find_min"])
def test_postproc_clis_without_gpu_stop_unless_told_cpu(tmp_path, cli):
    """Neither post-processing command falls back to the CPU: without a
    card and without --device cpu each stops before reading its input."""
    field = tmp_path / "f.bin"
    field.write_bytes(bytes(4 * 64 * 64))
    line = f"{field}=>{tmp_path / 'p.bin'}" if cli == "invert_pres" \
        else str(field)
    for device, rc in (([], 2), (["--device", "cpu"], 0)):
        proc = subprocess.run(
            [sys.executable, "-m", f"xlab_fftbarotropic_torch.cli.{cli}",
             "--nx", "64", "--ny", "64"] + device, input=line + "\n",
            cwd=tmp_path, env=_env(), capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == rc, proc.stderr
        assert ("no CUDA device" in proc.stderr) == (rc != 0)
        assert (tmp_path / "p.bin").exists() == (cli == "invert_pres"
                                                  and rc == 0)


def test_diagnose_cli_without_gpu_stops_unless_told_cpu(tmp_path):
    """xfb-torch-diagnose falls back to the CPU neither: without a card
    and without --device cpu it stops before writing anything."""
    field = tmp_path / "vort_step_0.bin"
    field.write_bytes(bytes(4 * 64 * 64))
    out = tmp_path / "okuboweiss_step_0.bin"
    for device, rc in (([], 2), (["--device", "cpu"], 0)):
        proc = subprocess.run(
            [sys.executable, "-m", "xlab_fftbarotropic_torch.cli.diagnose",
             "--nx", "64", "--ny", "64", "-O", str(tmp_path), "-d",
             "okubo-weiss"] + device, input=f"{field}\n", cwd=tmp_path,
            env=_env(), capture_output=True, text=True, timeout=300)
        assert proc.returncode == rc, proc.stderr
        assert ("no CUDA device" in proc.stderr) == (rc != 0)
        assert out.exists() == (rc == 0)


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


def test_port_files_and_scripts_import_no_jax():
    """No module of the port, no port script of the examples, not
    chip_smoke.py and not the multi-process tests' worker imports jax or
    the JAX package, or runs one of its commands."""
    import re

    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|xlab_fftbarotropic_"
                         r"tpu)\b|-m\s+xlab_fftbarotropic_tpu\b", re.M)
    files = (sorted((REPO / "xlab_fftbarotropic_torch").rglob("*.py"))
             + sorted((REPO / "examples").glob("*/*_torch.*"))
             + [REPO / "chip_smoke.py",
                REPO / "tests" / "torch_multihost_worker.py"])
    assert len([f for f in files if f.parent.parent.name == "examples"]
               ) >= 13
    for f in files:
        assert not pattern.search(f.read_text()), f
