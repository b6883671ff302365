"""The port's post-processing pipeline (diagnostics/, the makefield,
vort_src_input, invert_pres and find_min commands) against the JAX
package's on the CPU, on numpy-seeded inputs at 64^2:

- invert_pressure on both of the port's transform triples (torch.fft,
  and the per-transform kernels' plain versions) against the JAX
  PressureInverter, max |d| <= 1e-5 max |p| (float32 transforms in
  another order: a few float32 epsilons of the largest term); against the
  numpy transcription of invert_pres.cpp at the JAX test's 1e-3; the
  anchor; batch against single calls bit for bit;
- find_min_n equal to the JAX function (x, y and values), also with ties;
- tracks equal to the JAX module's on tests/test_tracks.py's records;
- the commands' outputs byte-identical to the JAX commands' (makefield,
  the FIFO stream, find_min's stdout and --tracks file) or, for the
  pressure, within 1e-5 of max |p|;
- example 02 through the port's commands (examples/02-invert-pressure/
  example_torch.sh at NX = 64, STEPS = 20, REC = 10, DEVICE = cpu).
"""

import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.cli import find_min as jcli_find_min
from xlab_fftbarotropic_tpu.cli import invert_pres as jcli_invert
from xlab_fftbarotropic_tpu.cli import makefield as jcli_makefield
from xlab_fftbarotropic_tpu.cli import vort_src_input as jcli_vsi
from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig
from xlab_fftbarotropic_tpu.diagnostics import find_min as jfm
from xlab_fftbarotropic_tpu.diagnostics import tracks as jtracks
from xlab_fftbarotropic_tpu.diagnostics.invert_pres import (
    PressureInverter as JInverter)
from xlab_fftbarotropic_tpu.oracle.reference_cpu import oracle_invert_pressure
from xlab_fftbarotropic_torch.cli import find_min as cli_find_min
from xlab_fftbarotropic_torch.cli import invert_pres as cli_invert
from xlab_fftbarotropic_torch.cli import makefield as cli_makefield
from xlab_fftbarotropic_torch.cli import vort_src_input as cli_vsi
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.diagnostics import find_min as fm
from xlab_fftbarotropic_torch.diagnostics import tracks
from xlab_fftbarotropic_torch.diagnostics.invert_pres import (
    LAUNCHES_PER_FIELD, PressureInverter, invert_pressure)
from xlab_fftbarotropic_torch.io.fieldio import read_field, write_field
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from torch_threads import _one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
N = 64
TOL = 1e-5
GRID = ["--nx", str(N), "--ny", str(N)]


def _psi(seed: int) -> np.ndarray:
    """A streamfunction at 64^2: a gaussian vortex's (the inverse
    Laplacian of its vorticity) plus seeded smooth noise."""
    from xlab_fftbarotropic_torch.ic import makefields
    cfg = ModelConfig(nx=N, ny=N)
    k = 2 * np.pi * np.fft.fftfreq(N, cfg.dx)
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    inv = np.where(k2 > 0, -1.0 / np.where(k2 > 0, k2, 1.0), 0.0)
    psi = np.fft.ifft2(np.fft.fft2(makefields.gaussian(cfg)) * inv).real
    rng = np.random.default_rng(seed)
    noise = np.fft.ifft2(np.fft.fft2(rng.standard_normal((N, N)))
                         * np.exp(-k2 / k2.max() * 40)).real
    return (psi + 0.2 * np.abs(psi).max() * noise / np.abs(noise).max()
            ).astype(np.float32)


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("anchor", [(0, 0), (5, 7)])
def test_invert_pressure_matches_the_jax_inverter(backend, anchor):
    """Both transform triples against the JAX PressureInverter, max |d| <=
    1e-5 max |p|; the kernel triple on the CPU runs ka, kb and kc's plain
    versions and counts no launch; the anchor value is exactly 0."""
    psi = _psi(1)
    want = np.asarray(JInverter(JConfig(nx=N, ny=N), *anchor)(psi))
    ff.reset_launches()
    got = PressureInverter(ModelConfig(nx=N, ny=N, fft_backend=backend),
                           "cpu", *anchor)(psi)
    assert got.dtype == torch.float32 and got.shape == (N, N)
    assert _rel(got.numpy(), want) <= TOL
    assert got.reshape(-1)[anchor[0] + N * anchor[1]] == 0.0
    assert not any(ff.LAUNCHES.values())


def test_invert_pressure_matches_the_numpy_oracle():
    """Against the transcription of invert_pres.cpp, at the JAX test's bar
    (tests/test_postproc.py: 1e-3)."""
    cfg = ModelConfig(nx=N, ny=N)
    psi = _psi(2)
    got = PressureInverter(cfg, "cpu")(psi).numpy()
    assert _rel(got, oracle_invert_pressure(JConfig(nx=N, ny=N), psi)) < 1e-3
    # a cyclonic vortex has its pressure minimum at its centre (within
    # the two cells the seeded noise moves it)
    x, y = np.unravel_index(got.argmin(), got.shape)
    assert abs(x - N // 2) <= 2 and abs(y - N // 2) <= 2


def test_the_triples_differ_only_in_their_transforms():
    """invert_pressure with the torch.fft triple given explicitly equals
    the xla inverter's call, and the plain kernel triple (the 'auto'
    choice on this grid) agrees with it within the transforms' rounding."""
    from xlab_fftbarotropic_torch.models.barotropic import resolve_fft_backend
    from xlab_fftbarotropic_torch.ops.spectral import SpectralTables

    cfg = ModelConfig(nx=N, ny=N)
    t = SpectralTables.from_config(cfg, "cpu")
    psi = torch.from_numpy(_psi(3))
    lib = invert_pressure(t, psi, cfg.rho, cfg.f, cfg.grid_shape)
    assert torch.equal(lib, PressureInverter(
        cfg.replace(fft_backend="xla"), "cpu")(psi))
    kern = invert_pressure(t, psi, cfg.rho, cfg.f, cfg.grid_shape,
                           transforms=resolve_fft_backend("auto",
                                                          cfg.grid_shape))
    assert _rel(kern.numpy(), lib.numpy()) <= TOL
    assert LAUNCHES_PER_FIELD == {"ka": 6, "kb": 3, "kc": 2}


def test_batch_equals_single_calls_bit_for_bit():
    inv = PressureInverter(ModelConfig(nx=N, ny=N), "cpu", 3, 4)
    psis = np.stack([_psi(s) for s in (4, 5, 6)])
    batch = inv.batch(psis)
    assert batch.shape == (3, N, N)
    for k in range(3):
        assert torch.equal(batch[k], inv(psis[k]))


@pytest.mark.parametrize("kind", ["random", "ties", "few values"])
def test_find_min_n_equals_the_jax_function(kind):
    """x, y and values equal to lax.top_k's, ties broken by the lower flat
    index (a field of five values ties at every place)."""
    rng = np.random.default_rng(7)
    if kind == "random":
        field = rng.standard_normal((N, N + 8)).astype(np.float32)
    elif kind == "ties":
        field = rng.standard_normal((N, N)).astype(np.float32)
        field[rng.integers(0, N, 40), rng.integers(0, N, 40)] = -5.0
    else:
        field = rng.integers(0, 5, (N, N)).astype(np.float32)
    for n in (1, 30, 100):
        got = fm.find_min_n(field, n)
        want = jfm.find_min_n(field, n)
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert fm.format_minima(*got) == jfm.format_minima(*want)


def _track_records():
    """The records of tests/test_tracks.py's track tests."""
    def rec(step, pts):
        xs, ys, vs = zip(*pts)
        return (step, np.array(xs), np.array(ys), np.array(vs))
    return [
        ([rec(0, [(60, 8, -9.0), (30, 30, -4.0)]),
          rec(10, [(63, 8, -9.1), (30, 31, -4.1)]),
          rec(20, [(2, 8, -9.2), (31, 30, -4.2)])], 64, 4.0, 8.0),
        ([rec(0, [(10, 10, -5.0)]), rec(10, [(40, 40, -5.0)]),
          rec(20, [(41, 40, -5.1), (10, 10, -3.0)])], 128, 4.0, 8.0),
        ([rec(0, [(10, 10, -9.0), (14, 10, -8.0)]),
          rec(1, [(15, 10, -8.1), (9, 10, -9.1)])], 64, 2.0, 8.0),
        ([(0, [0, 6], [0, 0], [-10.0, -9.0]),
          (1, [5, 8], [0, 0], [-10.0, -9.0])], 64, 1.0, 5.0),
        ([rec(0, [(10, 10, -9.0), (11, 10, -8.5), (10, 11, -8.0),
                  (9, 10, -7.5), (12, 12, -7.0), (40, 40, -5.0),
                  (41, 41, -4.5), (40, 39, -4.0)]),
          rec(5, [(1, 0, -2.0), (63, 0, -1.5)])], 64, 8.0, 64.0),
    ]


@pytest.mark.parametrize("case", range(5))
def test_tracks_equal_the_jax_module(case):
    records, n, radius, jump = _track_records()[case]
    got = tracks.build_tracks(records, n, n, radius, jump)
    want = jtracks.build_tracks(records, n, n, radius, jump)
    assert [vars(t) for t in got] == [vars(t) for t in want]
    assert tracks.format_tracks(got) == jtracks.format_tracks(want)
    for step, xs, ys, vs in records:
        assert (tracks.cluster_minima(xs, ys, vs, n, n, radius)
                == jtracks.cluster_minima(xs, ys, vs, n, n, radius))
    cost = np.random.default_rng(case).uniform(0, 10, (6, 6))
    np.testing.assert_array_equal(tracks._hungarian(cost),
                                  jtracks._hungarian(cost))


@pytest.mark.parametrize("name", ["gaussian", "const-vortex",
                                  "elliptic-vortex", "kuo2004"])
def test_makefield_writes_the_jax_commands_bytes(tmp_path, name):
    assert cli_makefield.main([name, "-I", str(tmp_path / "t")] + GRID) == 0
    assert jcli_makefield.main([name, "-I", str(tmp_path / "j")] + GRID) == 0
    got = (tmp_path / "t" / "initial_vorticity.bin").read_bytes()
    assert len(got) == 4 * N * N
    assert got == (tmp_path / "j" / "initial_vorticity.bin").read_bytes()


def _stdout_bytes(monkeypatch, main, argv) -> bytes:
    out = io.TextIOWrapper(io.BytesIO())
    monkeypatch.setattr(sys, "stdout", out)
    assert main(argv) == 0
    out.flush()
    return out.buffer.getvalue()


def test_vort_src_input_streams_the_jax_commands_bytes(monkeypatch):
    """dt = 900 s over 24 steps puts the Kuo2004 pulse at steps 8 (on) and
    20 (off): 23 flag bytes, two of them followed by a field."""
    argv = GRID + ["--dt", "900", "--total-steps", "24"]
    got = _stdout_bytes(monkeypatch, cli_vsi.main, argv)
    assert got == _stdout_bytes(monkeypatch, jcli_vsi.main, argv)
    assert len(got) == 23 + 2 * 4 * N * N
    assert got[:7] == b"\x00" * 7 and got[7:8] == b"\x01"


def _pres_files(tmp_path, steps=(0, 10, 20)) -> list:
    """Pressure-like fields: two wells, one drifting, on seeded noise."""
    rng = np.random.default_rng(9)
    x = np.arange(N)[:, None]
    y = np.arange(N)[None, :]
    files = []
    for k, step in enumerate(steps):
        f = 0.05 * rng.standard_normal((N, N))
        f -= 3.0 * np.exp(-((x - 10 - 2 * k) ** 2 + (y - 20) ** 2) / 8.0)
        f -= 2.0 * np.exp(-((x - 45) ** 2 + (y - 40) ** 2) / 8.0)
        path = tmp_path / f"pres_step_{step}.bin"
        write_field(path, f.astype(np.float32))
        files.append(str(path))
    return files


def test_find_min_cli_writes_the_jax_commands_output(tmp_path, monkeypatch,
                                                     capsys):
    files = _pres_files(tmp_path)
    outs = []
    for main, dev, tag in ((cli_find_min.main, ["--device", "cpu"], "t"),
                           (jcli_find_min.main, ["--cpu"], "j")):
        monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(files)))
        trk = tmp_path / f"tracks_{tag}.txt"
        assert main(GRID + dev + ["-n", "20", "--tracks", str(trk),
                                  "--cluster-radius", "4"]) == 0
        cap = capsys.readouterr()
        outs.append((cap.out, cap.err, trk.read_bytes()))
    assert outs[0][0] == outs[1][0]
    assert outs[0][0].count("\n") == 3 * 20
    assert outs[0][1].replace("tracks_t", "tracks_j") == outs[1][1]
    assert outs[0][2] == outs[1][2]
    assert len(outs[0][2].splitlines()) == 6     # two tracks, three steps


def test_invert_pres_cli_matches_the_jax_command(tmp_path, monkeypatch,
                                                 capsys):
    """The same psi=>pres lines through both commands (anchor -x 3 -y 2):
    the port's pressure within 1e-5 of max |p| of the JAX command's; a line
    without '=>' is reported and skipped by both."""
    lines = []
    for k, seed in enumerate((10, 11)):
        src = tmp_path / f"psi_step_{k}.bin"
        write_field(src, _psi(seed))
        lines.append(f"{src}=>{tmp_path / f'pres_step_{k}.bin'}")
    lines.insert(1, "not a mapping")
    outs = []
    for main, dev, tag in ((cli_invert.main, ["--device", "cpu"], "t"),
                           (jcli_invert.main, ["--cpu"], "j")):
        text = "\n".join(lines).replace("pres_step", f"pres_{tag}_step")
        monkeypatch.setattr(sys, "stdin", io.StringIO(text))
        assert main(GRID + dev + ["-x", "3", "-y", "2"]) == 0
        cap = capsys.readouterr()
        outs.append((cap.out, cap.err))
    assert outs[0] == outs[1]
    assert "Error reading input: not a mapping" in outs[0][1]
    for k in range(2):
        got = read_field(tmp_path / f"pres_t_step_{k}.bin", (N, N))
        want = read_field(tmp_path / f"pres_j_step_{k}.bin", (N, N))
        assert _rel(got, want) <= TOL
        assert got.reshape(-1)[3 + N * 2] == 0.0


def test_example_02_runs_through_the_ports_commands(tmp_path):
    """examples/02-invert-pressure/example_torch.sh at NX = 64, STEPS = 20,
    REC = 10 on the CPU, in a copy of the example's folder: makefield, the
    FIFO-forced run, the inversion of every psi record and the minima
    time series."""
    work = tmp_path / "examples" / "02-invert-pressure"
    shutil.copytree(REPO / "examples" / "02-invert-pressure", work)
    env = dict(os.environ, NX="64", STEPS="20", REC="10", DEVICE="cpu",
               PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(["bash", str(work / "example_torch.sh")], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for step in (0, 10):
        pres = read_field(work / "output" / f"pres_step_{step}.bin", (N, N))
        assert np.isfinite(pres).all() and pres.reshape(-1)[0] == 0.0
    series = (work / "output" / "pres_timeseries.txt").read_text()
    assert len(series.splitlines()) == 2 * 30
