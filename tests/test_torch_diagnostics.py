"""The port's diagnostics (diagnostics/spectra.py, kinematics.py,
eddy_diffusivity.py), the xfb-torch-diagnose and xfb-torch-draw commands
against the JAX package's on the CPU, on numpy-seeded inputs at 64^2
(the analytic pins at the JAX tests' 256^2 and 256 x 250):

- E(k), Z(k) per shell within 1e-5 of the largest shell's value, their
  sums within 1e-5 of each other and of the physical-space Parseval
  totals, on both of the port's transform triples (torch.fft and the
  per-transform kernels' plain versions);
- Okubo-Weiss within 1e-5 of max |OW|; the deformation factor and the
  filamentation time held where they are conditioned. D = S / |zeta|
  (S the strain magnitude) carries in S and |zeta| a few float32
  epsilons of the largest velocity gradient G, so
  |dD| / D <= 1e-5 G (1/S + 1/|zeta|), held where S and |zeta| exceed
  1e-3 G (the first-order bound holds there; the vortex core, S ~ 0,
  and the far field, zeta ~ 0, are left out); tau = 2 / sqrt(OW) has
  |dtau| / tau * OW <= 1e-5 G^2 where OW > 1e-3 G^2, and every cell
  with |OW| > 1e-3 G^2 is finite (strain-dominated) on both or neither;
- the effective-diffusivity profile: levels and areas equal (the same
  bins), L_e^2 and the ratios within 1e-5 of their largest values; the
  stripe and radial pins of the JAX package's tests/test_postproc.py;
- the commands' files and stdout against the JAX commands' with the same
  bounds; the PNGs of xfb-torch-draw byte-identical to xfb-draw's on the
  same records.
"""

import io
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.cli import diagnose as jcli_diagnose
from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig
from xlab_fftbarotropic_tpu.diagnostics import eddy_diffusivity as jed
from xlab_fftbarotropic_tpu.diagnostics import kinematics as jkin
from xlab_fftbarotropic_tpu.diagnostics import spectra as jspectra
from xlab_fftbarotropic_tpu.ops import fft as jfft
from xlab_fftbarotropic_tpu.ops.spectral import SpectralTables as JTables
from xlab_fftbarotropic_torch.cli import diagnose as cli_diagnose
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.diagnostics import eddy_diffusivity as ed
from xlab_fftbarotropic_torch.diagnostics import kinematics as kin
from xlab_fftbarotropic_torch.diagnostics import spectra
from xlab_fftbarotropic_torch.io.fieldio import read_field, write_field
from xlab_fftbarotropic_torch.models.barotropic import (BarotropicModel,
                                                        resolve_fft_backend,
                                                        step_stats)
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.ops.spectral import SpectralTables
from torch_threads import _one_thread  # noqa: F401

N = 64
TOL = 1e-5
COND = 1e-3     # the conditioned cells: S, |zeta| > COND G; OW > COND G^2
GRID = ["--nx", str(N), "--ny", str(N)]
BACKENDS = ["xla", "pallas"]


def _vort(seed: int, n: int = N) -> np.ndarray:
    """A gaussian vortex plus seeded smooth noise (a fifth of its peak)."""
    from xlab_fftbarotropic_torch.ic import makefields
    cfg = ModelConfig(nx=n, ny=n)
    k = np.fft.fftfreq(n) * n
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    rng = np.random.default_rng(seed)
    noise = np.fft.ifft2(np.fft.fft2(rng.standard_normal((n, n)))
                         * np.exp(-k2 / 40.0)).real
    v = makefields.gaussian(cfg)
    return (v + 0.2 * np.abs(v).max() * noise / np.abs(noise).max()
            ).astype(np.float32)


def _setup(backend: str, seed: int = 1):
    """(port tables, triple, zeta_hat; JAX tables, zeta_hat; vort)."""
    v = _vort(seed)
    tr = resolve_fft_backend(backend, (N, N))
    return (SpectralTables.from_config(ModelConfig(nx=N, ny=N), "cpu"), tr,
            tr[0](torch.from_numpy(v)), JTables.from_config(
                JConfig(nx=N, ny=N)), jfft.forward(jnp.asarray(v)), v)


def _gradient_scale(jt, jz):
    """(S, zeta, G): the JAX module's strain magnitude, vorticity and
    largest velocity gradient magnitude."""
    g = jkin.velocity_gradients(jt, jz, (N, N))
    s1, s2, zeta = (np.asarray(a) for a in jkin.strain_vorticity(g))
    return (np.hypot(s1, s2), zeta,
            max(float(np.abs(np.asarray(a)).max()) for a in g))


def _check_deformation(got, want, strain, zeta, big_g):
    """|dD| / D <= TOL G (1/S + 1/|zeta|) where S and |zeta| exceed
    COND G."""
    m = (strain > COND * big_g) & (np.abs(zeta) > COND * big_g)
    assert m.mean() > 0.1
    err = (np.abs(got - want) / want)[m] / (
        big_g * (1.0 / strain[m] + 1.0 / np.abs(zeta[m])))
    assert float(err.max()) <= TOL, float(err.max())


def _check_filamentation(got, want, ow, big_g):
    """The finite (strain-dominated) cells agree wherever OW is decided
    (|OW| > COND G^2), and |dtau| / tau * OW <= TOL G^2 where
    OW > COND G^2."""
    decided = np.abs(ow) > COND * big_g ** 2
    assert np.array_equal(np.isfinite(got)[decided],
                          np.isfinite(want)[decided])
    m = ow > COND * big_g ** 2
    assert m.any()
    err = np.abs(got[m] - want[m]) / want[m] * ow[m]
    assert float(err.max()) <= TOL * big_g ** 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_spectrum_matches_the_jax_module_and_parseval(backend):
    t, tr, z, jt, jz, v = _setup(backend)
    cfg = ModelConfig(nx=N, ny=N)
    got = spectra.energy_enstrophy_spectrum(t, z, cfg)
    want = jspectra.energy_enstrophy_spectrum(jt, jz, JConfig(nx=N, ny=N))
    shell, w, n_shells = spectra.shell_tables(cfg)
    jshell, jw, jn = jspectra.shell_tables(JConfig(nx=N, ny=N))
    assert n_shells == jn and np.array_equal(shell, jshell) \
        and np.array_equal(w, jw)
    assert np.array_equal(got.k.numpy(), np.asarray(want.k))
    for name in ("energy", "enstrophy"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == np.float32 and a.shape == (n_shells,)
        assert np.abs(a - b).max() <= TOL * np.abs(b).max()
        assert abs(float(a.sum()) - float(b.sum())) <= TOL * float(b.sum())
    # Parseval: the enstrophy sum is the physical-space 0.5*mean(zeta^2)
    assert abs(float(got.enstrophy.sum()) - 0.5 * float(np.mean(
        v.astype(np.float64) ** 2))) <= TOL * float(got.enstrophy.sum())


def test_spectrum_sums_are_the_step_stats():
    """sum E and sum Z against StepStats' physical-space energy and
    enstrophy after 10 steps (the JAX package's test_spectra bar)."""
    from xlab_fftbarotropic_torch.ic import makefields
    cfg = ModelConfig(nx=N, ny=N)
    m = BarotropicModel.build(cfg, "cpu")
    z = m.segment(m.init_state(makefields.gaussian(cfg)), m.zero_source(),
                  10)
    sp_ = spectra.energy_enstrophy_spectrum(m.tables, z, cfg)
    st = step_stats(m.tables, z, cfg)
    np.testing.assert_allclose(float(sp_.enstrophy.sum()),
                               float(st.enstrophy), rtol=1e-5)
    np.testing.assert_allclose(float(sp_.energy.sum()), float(st.energy),
                               rtol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_kinematics_match_the_jax_module(backend):
    t, tr, z, jt, jz, _ = _setup(backend)
    strain, zeta, big_g = _gradient_scale(jt, jz)
    ff.reset_launches()
    ow = kin.okubo_weiss(t, z, (N, N), transforms=tr).numpy()
    jow = np.asarray(jkin.okubo_weiss(jt, jz, (N, N)))
    assert ow.dtype == np.float32 and ow.shape == (N, N)
    assert np.abs(ow - jow).max() <= TOL * np.abs(jow).max()
    _check_deformation(
        kin.deformation_factor(t, z, (N, N), transforms=tr).numpy(),
        np.asarray(jkin.deformation_factor(jt, jz, (N, N))), strain, zeta,
        big_g)
    fil = kin.filamentation_time(t, z, (N, N), transforms=tr).numpy()
    jfil = np.asarray(jkin.filamentation_time(jt, jz, (N, N)))
    _check_filamentation(fil, jfil, jow, big_g)
    # a gaussian core is rotation-dominated, its flanks strain-dominated
    assert not np.isfinite(fil).all() and np.isfinite(fil).any()
    # the plain versions count no launch
    assert not any(ff.LAUNCHES.values())


def test_velocity_gradients_take_two_inverse_pairs():
    """The four gradients of the JAX module's four inverses, through two
    inverse_pairs; both triples agree with it within TOL of G."""
    for backend in BACKENDS:
        t, tr, z, jt, jz, _ = _setup(backend, seed=2)
        got = kin.velocity_gradients(t, z, (N, N), transforms=tr)
        want = jkin.velocity_gradients(jt, jz, (N, N))
        big_g = max(float(np.abs(np.asarray(a)).max()) for a in want)
        for a, b in zip(got, want):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL * big_g
    assert kin.LAUNCHES_PER_CALL == {"ka": 4, "kb": 2, "kc": 0}
    assert ed.LAUNCHES_PER_CALL == {"ka": 3, "kb": 1, "kc": 1}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nbins", [16, 64])
def test_eddy_diffusivity_matches_the_jax_module(backend, nbins):
    t, tr, _, jt, _, v = _setup(backend, seed=3)
    cfg = ModelConfig(nx=N, ny=N)
    got = ed.effective_diffusivity(t, torch.from_numpy(v), cfg.dx, cfg.dy,
                                   nbins=nbins, transforms=tr)
    want = jed.effective_diffusivity(jt, jnp.asarray(v), cfg.dx, cfg.dy,
                                     nbins=nbins)
    for name in ("levels", "area", "min_length2"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name))), name
    for name in ("equiv_length2", "kappa_ratio", "kappa_ratio_raw"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == np.float32 and a.shape == (nbins,)
        assert np.abs(a - b).max() <= TOL * np.abs(b).max(), name
    assert float(got.kappa_ratio.min()) >= 1.0


@pytest.mark.parametrize("a,b", [(3, 3), (2, 3)])
def test_eddy_diffusivity_stripe_pin(a, b):
    """The JAX package's stripe pin (tests/test_postproc.py:157-187):
    straight-line contours of total length 2*hypot(a*ly, b*lx), so
    L_e^2 = 4*(a^2*ly^2 + b^2*lx^2) at every interior level."""
    cfg = ModelConfig(nx=256, ny=250, lx=600_000.0, ly=450_000.0)
    t = SpectralTables.from_config(cfg, "cpu")
    x, y = cfg.coords()
    X, Y = np.meshgrid(x, y, indexing="ij")
    q = np.cos(2 * np.pi * (a * X / cfg.lx + b * Y / cfg.ly)
               ).astype(np.float32)
    e = ed.effective_diffusivity(t, torch.from_numpy(q), cfg.dx, cfg.dy,
                                 nbins=64)
    expected = 4.0 * ((a * cfg.ly) ** 2 + (b * cfg.lx) ** 2)
    interior = np.abs(e.levels.numpy()) < 0.85
    err = np.abs(e.equiv_length2.numpy()[interior] / expected - 1.0)
    assert np.median(err) < 0.02, np.median(err)
    assert err.max() < 0.05, err.max()


def test_eddy_diffusivity_radial_pin():
    """The JAX package's radial pin (tests/test_postproc.py:189-215):
    circular contours give L_e = L_min, the unclipped ratio near 1."""
    cfg = ModelConfig(nx=256, ny=256)
    t = SpectralTables.from_config(cfg, "cpu")
    x, y = cfg.coords()
    X, Y = np.meshgrid(x, y, indexing="ij")
    r2 = (X - cfg.lx / 2) ** 2 + (Y - cfg.ly / 2) ** 2
    q = np.exp(-r2 / (cfg.lx / 8) ** 2).astype(np.float32)
    e = ed.effective_diffusivity(t, torch.from_numpy(q), cfg.dx, cfg.dy,
                                 nbins=32)
    area, raw = e.area.numpy(), e.kappa_ratio_raw.numpy()
    interior = (area > 0.005 * cfg.lx * cfg.ly) & \
               (area < 0.2 * cfg.lx * cfg.ly)
    assert interior.sum() > 5
    err = np.abs(raw[interior] - 1.0)
    assert abs(np.median(raw[interior]) - 1.0) < 0.03
    assert np.median(err) < 0.08, np.median(err)
    assert err.max() < 0.3, err.max()
    assert float(e.kappa_ratio.min()) >= 1.0


def _summaries(stdout: str) -> dict:
    """{(diagnostic, input name): summary} of the commands' stdout."""
    out = {}
    for line in stdout.splitlines():
        d, path, arrow, dest, summary = line.split()
        assert arrow == "->" and summary.startswith("summary=")
        out[(d, Path(path).name)] = (Path(dest).name,
                                     float(summary[len("summary="):]))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_diagnose_cli_matches_the_jax_command(tmp_path, monkeypatch, capsys,
                                              backend):
    """Both commands on the same two records, all five diagnostics: the
    same file names and stdout lines, the files and summaries within the
    module tests' bounds."""
    inputs = []
    for seed in (4, 5):
        p = tmp_path / "in" / f"vort_step_{10 * seed}.bin"
        p.parent.mkdir(exist_ok=True)
        write_field(p, _vort(seed))
        inputs.append(p)
    every = [a for d in cli_diagnose.DIAGNOSTICS for a in ("-d", d)]
    outs = {}
    for name, main, extra in (
            ("jax", jcli_diagnose.main, []),
            ("port", cli_diagnose.main, ["--device", "cpu", "--fft-backend",
                                         backend])):
        monkeypatch.setattr(sys, "stdin", io.StringIO(
            "\n".join(str(p) for p in inputs) + "\n"))
        main(GRID + ["-O", str(tmp_path / name)] + every + extra)
        outs[name] = _summaries(capsys.readouterr().out)
    assert outs["port"].keys() == outs["jax"].keys()
    assert len(outs["port"]) == 2 * len(cli_diagnose.DIAGNOSTICS)
    for (d, src), (dest, got) in outs["port"].items():
        jdest, want = outs["jax"][(d, src)]
        assert dest == jdest
        a, b = tmp_path / "port" / dest, tmp_path / "jax" / dest
        if d == "spectrum":
            x, y = np.loadtxt(a), np.loadtxt(b)
            assert x.shape == y.shape and np.abs(x - y).max() <= \
                TOL * np.abs(y).max()
            assert a.read_text().splitlines()[0] == \
                b.read_text().splitlines()[0]
        elif d == "eddy-diffusivity":
            x, y = read_field(a), read_field(b)
            assert np.abs(x - y).max() <= TOL * np.abs(y).max()
        else:
            x, y = read_field(a, (N, N)), read_field(b, (N, N))
            vort = read_field(tmp_path / "in" / src, (N, N))
            jz = jfft.forward(jnp.asarray(vort))
            jt = JTables.from_config(JConfig(nx=N, ny=N))
            strain, zeta, big_g = _gradient_scale(jt, jz)
            ow = np.asarray(jkin.okubo_weiss(jt, jz, (N, N)))
            if d == "okubo-weiss":
                assert np.abs(x - y).max() <= TOL * np.abs(y).max()
            elif d == "deformation":
                # the summary, max D, sits where |zeta| is at round-off:
                # it is each command's own file's largest value
                _check_deformation(x, y, strain, zeta, big_g)
                assert got == float(f"{x.max():.6e}")
                assert want == float(f"{y.max():.6e}")
                continue
            else:   # filamentation: inf is written as 0
                x = np.where(x == 0, np.inf, x)
                y = np.where(y == 0, np.inf, y)
                _check_filamentation(x, y, ow, big_g)
        assert abs(got - want) <= TOL * abs(want), (d, got, want)


def test_diagnose_cli_counts_launches_per_field():
    """launches_per_field: the forward transform, then each diagnostic's
    (all five: 16 ka, 7 kb, 2 kc)."""
    every = cli_diagnose.DIAGNOSTICS
    assert cli_diagnose.launches_per_field(every) == {"ka": 16, "kb": 7,
                                                      "kc": 2}
    assert cli_diagnose.launches_per_field(["spectrum"]) == {
        "ka": 1, "kb": 0, "kc": 1}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A port run's records at 32^2 (steps 0 and 10) and a spectrum."""
    from xlab_fftbarotropic_torch import runner
    from xlab_fftbarotropic_torch.ic import makefields
    d = tmp_path_factory.mktemp("drawrun")
    cfg = ModelConfig(nx=32, ny=32, total_steps=20, record_step=10,
                      output_dir=str(d / "output"))
    runner.run(cfg, "cpu", vort0=makefields.gaussian(cfg),
               manifest_path=str(d / "log"))
    np.savetxt(d / "output" / "spectrum_step_10.txt",
               np.column_stack([np.arange(8.0), np.exp(-np.arange(8.0)),
                                np.exp(-np.arange(8.0) / 2)]),
               header="k[1/m] E(k) Z(k)")
    return d / "output"


@pytest.mark.parametrize("flags", [["--wind", "streamline"],
                                   ["--wind", "barb"], ["--spectra"]])
def test_draw_cli_writes_the_jax_commands_pngs(records, tmp_path, flags):
    pytest.importorskip("matplotlib")
    from xlab_fftbarotropic_tpu.cli import draw as jcli_draw
    from xlab_fftbarotropic_torch.cli import draw as cli_draw
    argv = ["-O", str(records), "--nx", "32", "--ny", "32",
            "--total-steps", "20", "--record-step", "10", "--dpi",
            "40"] + flags
    assert cli_draw.main(argv + ["--fig-dir", str(tmp_path / "port")]) == 0
    jcli_draw.main(argv + ["--fig-dir", str(tmp_path / "jax")])
    made = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert made == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert made == (["spectrum_step_10.png"] if "--spectra" in flags
                    else ["step_0.png", "step_10.png"])
    for name in made:
        png = (tmp_path / "port" / name).read_bytes()
        assert png[:4] == b"\x89PNG"
        assert png == (tmp_path / "jax" / name).read_bytes()


def test_draw_cli_without_matplotlib_stops(records, tmp_path, monkeypatch):
    """No quiet skip: without matplotlib the command stops with an
    error and draws nothing."""
    import importlib.util

    from xlab_fftbarotropic_torch.cli import draw as cli_draw
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else real(name, *a))
    with pytest.raises(SystemExit) as e:
        cli_draw.main(["-O", str(records), "--fig-dir",
                       str(tmp_path / "f"), "--nx", "32", "--ny", "32"])
    assert e.value.code == 2
    assert not (tmp_path / "f").exists()
