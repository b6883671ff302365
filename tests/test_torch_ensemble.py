"""The port's ensemble (models/ensemble.py, runner --ensemble) against the
JAX package's on the CPU at 64^2:

- perturb_from_noise fed with the JAX package's noise
  (jax.random.normal(PRNGKey(seed), (M-1, nx, ny))) against its
  perturb_vorticity, within 1e-6 of the largest value (float32 transforms
  in another order); the port's own draw: control member exact, unit RMS
  perturbations scaled by amplitude * rms(vort0) (rtol 1e-4, the JAX
  test's), zero mean, deterministic in the seed;
- zero-amplitude members equal to the solo model: bit for bit in chunks
  of width 1 (the plane stepper's kernels' plain versions, as the solo
  run), within 1e-6 of max |zeta| in one batched chunk on torch.fft (a
  batched transform rounds otherwise than a single one); chunked widths
  equal to the full width within the same 1e-6; the SW and tracer
  families too;
- the runner end to end against the JAX runner's member files (the port
  fed the JAX noise), within 1e-6 of each field's largest value, with the
  member-aggregated stats; checkpoint resume bit for bit; forcing shared
  across members; the refusals (--shard, -m fd).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu import runner as jrunner
from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig
from xlab_fftbarotropic_tpu.models import ensemble as jens
from xlab_fftbarotropic_torch import runner
from xlab_fftbarotropic_torch.cli import run as cli_run
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.ic import makefields
from xlab_fftbarotropic_torch.io.fieldio import read_field, write_field
from xlab_fftbarotropic_torch.models import ensemble as ens
from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
from xlab_fftbarotropic_torch.models.shallow_water import ShallowWaterModel
from xlab_fftbarotropic_torch.models.tracer import TracerModel
from torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")
N = 64
TOL = 1e-6


def _cfg(**kw) -> ModelConfig:
    return ModelConfig(nx=N, ny=N, **kw)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _jax_noise(m: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(seed), (m - 1, N, N), dtype=jnp.float32)))


@pytest.mark.parametrize("m,amp,seed", [(4, 0.1, 7), (3, 0.02, 1)])
def test_perturb_from_noise_matches_the_jax_perturbation(m, amp, seed):
    v0 = makefields.kuo2004(_cfg())
    got = ens.perturb_from_noise(_cfg(), v0, _jax_noise(m, seed), amp)
    want = np.asarray(jens.perturb_vorticity(JConfig(nx=N, ny=N), v0, m,
                                             amplitude=amp, seed=seed))
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    assert np.array_equal(got[0].numpy(), want[0])


def test_perturbation_batch_properties():
    cfg = _cfg()
    v0 = makefields.gaussian(cfg, zeta0=2e-3)
    batch = ens.perturb_vorticity(cfg, v0, 4, amplitude=0.1, seed=7).numpy()
    assert batch.shape == (4, N, N)
    assert np.array_equal(batch[0], v0)
    rms0 = np.sqrt(np.mean(v0.astype(np.float64) ** 2))
    for k in range(1, 4):
        delta = batch[k] - batch[0]
        np.testing.assert_allclose(np.sqrt(np.mean(delta ** 2)), 0.1 * rms0,
                                   rtol=1e-4)
        assert abs(delta.mean()) < 1e-3 * 0.1 * rms0
    assert np.array_equal(batch, ens.perturb_vorticity(
        cfg, v0, 4, amplitude=0.1, seed=7).numpy())
    other = ens.perturb_vorticity(cfg, v0, 4, amplitude=0.1, seed=8).numpy()
    assert np.abs(other[1] - batch[1]).max() > 0
    flat = ens.perturb_vorticity(cfg, v0, 3, amplitude=0.0).numpy()
    assert all(np.array_equal(f, v0) for f in flat)


@pytest.mark.parametrize("width,backend", [(1, "pallas"), (3, "xla")])
def test_zero_amp_members_match_solo_barotropic(width, backend):
    """Width 1 under auto: the plane stepper (its plain versions here),
    member by member, each member the solo run bit for bit. Width 3:
    one batched chunk on torch.fft, within TOL of the solo library run."""
    cfg = _cfg(dt=10.0)
    v0 = makefields.gaussian(cfg, zeta0=2e-3)
    e = ens.EnsembleModel.build(cfg, CPU, 3, vmap_width=width)
    assert e.inner.backend == backend and e.batched == (width > 1)
    solo = BarotropicModel.build(cfg.replace(fft_backend=backend), CPU)
    want = solo.segment(solo.init_state(v0), solo.zero_source(), 20)
    out = e.segment(e.init_from_physical(v0, amplitude=0.0),
                    solo.zero_source(), 20)
    assert out.shape == (3,) + cfg.spectral_shape
    for k in range(3):
        if width == 1:
            assert torch.equal(out[k], want)
        else:
            _close(torch.view_as_real(out[k]).numpy(),
                   torch.view_as_real(want).numpy())


def test_control_member_tracks_solo_and_members_spread():
    cfg = _cfg(dt=10.0)
    v0 = makefields.kuo2004(cfg)
    solo = BarotropicModel.build(cfg, CPU)
    want = solo.segment(solo.init_state(v0), solo.zero_source(), 10)
    e = ens.EnsembleModel.build(cfg, CPU, 3, vmap_width=1)
    final = e.segment(e.init_from_physical(v0, amplitude=0.02, seed=1),
                      solo.zero_source(), 10)
    assert torch.equal(final[0], want)
    assert not torch.equal(final[1], want)
    assert float(e.spread(final)) > 0.0


def test_chunked_width_matches_full_width():
    cfg = _cfg(dt=10.0, fft_backend="xla")
    v0 = makefields.kuo2004(cfg)
    full = ens.EnsembleModel.build(cfg, CPU, 4, vmap_width=4)
    state = full.init_from_physical(v0, amplitude=0.05, seed=2)
    src = torch.zeros(cfg.grid_shape)
    want = torch.view_as_real(full.segment(state, src, 10)).numpy()
    for width in (1, 2):
        chunked = ens.EnsembleModel.build(cfg, CPU, 4, vmap_width=width)
        assert chunked.vmap_width == width
        got = chunked.segment(state, src, 10)
        _close(torch.view_as_real(got).numpy(), want)
    with pytest.raises(ValueError, match="divide"):
        ens.EnsembleModel.build(cfg, CPU, 4, vmap_width=3)


@pytest.mark.parametrize("family,width", [("sw", 1), ("sw", 2),
                                          ("tracer", 1), ("tracer", 2)])
def test_zero_amp_members_match_solo_sw_and_tracer(family, width):
    cfg = _cfg(dt=3.0)
    v0 = makefields.gaussian(cfg, zeta0=2e-3)
    e = ens.EnsembleModel.build(cfg, CPU, 2, model_kind=family,
                                tracer_kappa=50.0, vmap_width=width)
    icfg = e.cfg
    if family == "sw":
        solo = ShallowWaterModel.build(icfg, CPU)
        s0 = solo.geostrophic_init(v0)
    else:
        solo = TracerModel.build(icfg, CPU, kappa=50.0)
        s0 = solo.init_state(v0, v0)
    want = solo.segment(s0, solo.zero_source(), 5)
    out = e.segment(e.init_from_physical(v0, amplitude=0.0),
                    solo.zero_source(), 5)
    assert type(out) is type(want)
    for got_f, want_f in zip(out, want):
        for k in range(2):
            if width == 1:
                assert torch.equal(got_f[k], want_f)
            else:
                _close(torch.view_as_real(got_f[k]).numpy(),
                       torch.view_as_real(want_f).numpy())
    stats = e.stats(out)
    assert all(v.shape == (2,) for v in stats)


def test_auto_vmap_width_thresholds(monkeypatch):
    """The H100 sweep's threshold (models/ensemble.py): every member up to
    512^2, width 1 above; XFB_ENSEMBLE_WIDTH overrides it, snapped down
    to a divisor of M."""
    monkeypatch.delenv("XFB_ENSEMBLE_WIDTH", raising=False)
    assert ens.FULL_WIDTH_MAX_N == 512
    assert ens.auto_vmap_width(ModelConfig(nx=256, ny=256), 32) == 32
    assert ens.auto_vmap_width(ModelConfig(nx=512, ny=512), 12) == 12
    assert ens.auto_vmap_width(ModelConfig(nx=1024, ny=1024), 8) == 1
    monkeypatch.setenv("XFB_ENSEMBLE_WIDTH", "4")
    assert ens.auto_vmap_width(ModelConfig(nx=1024, ny=1024), 6) == 3
    assert ens.auto_vmap_width(ModelConfig(nx=256, ny=256), 8) == 4


def test_member_backend_gate_is_width_aware():
    def resolved(n, width, backend="auto"):
        return ens._resolve_member_backend(
            ModelConfig(nx=n, ny=n, fft_backend=backend), width).fft_backend
    assert resolved(4096, 1) == "auto"
    assert resolved(64, 1) == "auto"
    assert resolved(96, 1) == "xla"       # a grid the kernels do not take
    assert resolved(4096, 8) == "xla"
    assert resolved(256, 8, "pallas") == "pallas"
    # an explicit kernel backend: chunks run member by member
    e = ens.EnsembleModel.build(_cfg(fft_backend="pallas"), CPU, 4,
                                vmap_width=2)
    assert e.inner.backend == "pallas" and not e.batched


def _jax_fed(monkeypatch):
    """The port's perturb_vorticity drawing the JAX package's noise."""
    def draw(cfg, vort0, n_members, amplitude=0.05, seed=0, k_frac=0.5,
             device="cpu"):
        return ens.perturb_from_noise(cfg, vort0, _jax_noise(n_members,
                                                             seed),
                                      amplitude, k_frac)
    monkeypatch.setattr(ens, "perturb_vorticity", draw)


def _write_ic(tmp_path: Path) -> ModelConfig:
    cfg = _cfg(dt=10.0, record_step=5, total_steps=10,
               input_dir=str(tmp_path / "input"))
    Path(cfg.input_dir).mkdir(parents=True)
    write_field(Path(cfg.input_dir) / cfg.init_file,
                makefields.gaussian(cfg, zeta0=2e-3))
    return cfg


@pytest.mark.parametrize("width", [1, 2])
def test_runner_ensemble_matches_the_jax_runner(tmp_path, monkeypatch,
                                                width):
    _jax_fed(monkeypatch)
    cfg = _write_ic(tmp_path)
    res = runner.run(cfg.replace(output_dir=str(tmp_path / "port")), CPU,
                     manifest_path=str(tmp_path / "log"), ensemble=2,
                     ensemble_amp=0.05, ensemble_seed=3,
                     ensemble_width=width)
    jcfg = JConfig(nx=N, ny=N, dt=10.0, record_step=5, total_steps=10,
                   input_dir=cfg.input_dir, output_dir=str(tmp_path / "jax"))
    jres = jrunner.run(jcfg, manifest_path=str(tmp_path / "jlog"),
                       ensemble=2, ensemble_amp=0.05, ensemble_seed=3)
    assert res.steps_run == 10
    for k in ("m00", "m01"):
        names = sorted(p.name for p in (tmp_path / "port" / k).iterdir())
        assert names == sorted(p.name
                               for p in (tmp_path / "jax" / k).iterdir())
        assert len(names) == 8
        for name in names:
            _close(read_field(tmp_path / "port" / k / name, (N, N)),
                   read_field(tmp_path / "jax" / k / name, (N, N)))
    lines = (tmp_path / "log").read_text().replace(str(tmp_path / "port"),
                                                   "OUT")
    assert lines == (tmp_path / "jlog").read_text().replace(
        str(tmp_path / "jax"), "OUT")
    for a, b in zip(res.stats_history, jres.stats_history):
        assert a.keys() == b.keys()
        assert "energy_mean" in a and "energy_std" in a and "spread" in a
        for key in ("energy_mean", "enstrophy_mean", "spread"):
            assert abs(a[key] - b[key]) <= 1e-5 * abs(b[key]), key


def test_runner_ensemble_checkpoint_resume(tmp_path):
    cfg = _write_ic(tmp_path).replace(record_step=20, checkpoint_step=5,
                                      output_dir=str(tmp_path / "out"))
    full = runner.run(cfg, CPU, manifest_path=str(tmp_path / "log"),
                      ensemble=2, ensemble_amp=0.05, model_kind="sw")
    ckpt = Path(cfg.output_dir) / "ckpt_step_5.npz"
    assert ckpt.exists()
    resumed = runner.run(cfg, CPU, manifest_path=str(tmp_path / "log2"),
                         resume_from=ckpt, ensemble=2, ensemble_amp=0.05,
                         model_kind="sw")
    assert resumed.steps_run == 5
    for a, b in zip(resumed.zeta_hat, full.zeta_hat):
        assert torch.equal(a, b)


def test_ensemble_script_forcing_shared_across_members(tmp_path):
    cfg = _write_ic(tmp_path).replace(dt=3.0,
                                      output_dir=str(tmp_path / "out"))
    src = (0.1 * read_field(Path(cfg.input_dir) / cfg.init_file, (N, N))
           ).astype(np.float32)
    write_field(tmp_path / "s.bin", src)
    script = tmp_path / "recipe.txt"
    script.write_text(f"9.0 {tmp_path}/s.bin\n")    # fires at step 3
    runner.run(cfg, CPU, recipe="script", src_path=str(script),
               manifest_path=str(tmp_path / "log"), ensemble=2,
               ensemble_amp=0.0, ensemble_width=1)
    runner.run(cfg.replace(output_dir=str(tmp_path / "solo")), CPU,
               recipe="script", src_path=str(script),
               manifest_path=str(tmp_path / "solo_log"))
    for k in ("m00", "m01"):
        assert (read_field(tmp_path / "out" / k / "vort_step_5.bin")
                == read_field(tmp_path / "solo" / "vort_step_5.bin")).all()


def test_ensemble_through_the_cli(tmp_path, capsys):
    cfg = _write_ic(tmp_path)
    assert cli_run.main(["-I", cfg.input_dir, "-O", str(tmp_path / "out"),
                         "--nx", str(N), "--ny", str(N), "--total-steps",
                         "4", "--record-step", "2", "--device", "cpu",
                         "--ensemble", "4", "--ensemble-amp", "0.02",
                         "--ensemble-width", "2", "--record-fields", "vort",
                         "--manifest", str(tmp_path / "log")]) == 0
    err = capsys.readouterr().err
    assert "Ensemble              : 4 members, chunks of 2" in err
    assert err.count("# Ensemble spread = ") == 2
    for k in range(4):
        assert (tmp_path / "out" / f"m0{k}" / "vort_step_2.bin").exists()
    with pytest.raises(SystemExit):
        cli_run.main(["-O", str(tmp_path / "o"), "--device", "cpu",
                      "--ensemble", "4", "--ensemble-width", "3"])


def test_ensemble_refuses_shard_and_fd():
    cfg = _cfg()
    with pytest.raises(ValueError, match="mutually exclusive"):
        runner.make_adapter(cfg, CPU, "barotropic", shard=True, ensemble=2)
    with pytest.raises(ValueError, match="not supported"):
        runner.make_adapter(cfg, CPU, "fd", ensemble=2)
