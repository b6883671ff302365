"""The port's runner and CLI against the JAX package's, on the CPU:
byte-compatible record files and `log` manifest, checkpoints that resume
across the two packages, and the forced (script and fifo) paths.

Records agree to a max relative error of 1e-6 (max |a - b| / max |a| per
file): the two packages run different transform paths (the JAX CLI the
XLA core on the CPU, the port the plane stepper's plain versions) that
agree to float32 round-off over these short runs. The tracer family's
records are held to rel-L2 2e-6 per file, its own bar
(tests/test_pallas_tracer.py:79-80); the shallow-water family's to 1e-5
of max |record| (div: of max(|div|, |vort|)), the JAX package's bar for
its two SW paths after one step (tests/test_pallas_sw.py:141-155).
"""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu import runner as jrunner
from xlab_fftbarotropic_tpu.cli import run as jcli
from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.forcing import source as fsrc
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.io.fieldio import read_field, write_field
from xlab_fftbarotropic_torch import runner as trunner
from xlab_fftbarotropic_torch.cli import run as tcli

CPU = torch.device("cpu")


def _rel(a, b):
    scale = np.max(np.abs(a))
    return 0.0 if scale == 0 else np.max(np.abs(a - b)) / scale


def _records(out_dir):
    return {p: np.fromfile(os.path.join(out_dir, p), dtype="<f4")
            for p in sorted(os.listdir(out_dir)) if p.endswith(".bin")}


def _cfg(tmp_path, **kw):
    base = dict(nx=64, ny=64, dt=3.0, record_step=5, total_steps=10,
                input_dir=str(tmp_path / "input"),
                output_dir=str(tmp_path / "output"))
    base.update(kw)
    return ModelConfig(**base)


def test_cli_matches_jax_cli(tmp_path, capsys):
    """The same CLI invocation through both packages: identical manifest
    text, the same record files, values within 1e-6."""
    cfg = ModelConfig(nx=64, ny=64)
    inp, out = tmp_path / "in", tmp_path / "out"
    inp.mkdir()
    write_field(inp / "init.bin", makefields.kuo2004(cfg))
    common = ["-I", str(inp), "-O", str(out), "-i", "init.bin", "--nx",
              "64", "--ny", "64", "--total-steps", "20", "--record-step",
              "10"]
    assert jcli.main(common + ["--cpu", "--manifest",
                               str(tmp_path / "log_jax")]) == 0
    want = _records(out)
    assert tcli.main(common + ["--device", "cpu", "--manifest",
                               str(tmp_path / "log_torch")]) == 0
    err = capsys.readouterr().err
    assert "FFT backend           : pallas" in err
    got = _records(out)
    assert (tmp_path / "log_jax").read_text() == \
        (tmp_path / "log_torch").read_text()
    assert sorted(want) == sorted(got) and len(got) == 10
    for name in want:
        assert got[name].size == 64 * 64, name
        assert _rel(want[name], got[name]) < 1e-6, name


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    cfg = _cfg(tmp_path, checkpoint_step=5, record_step=100)
    vort0 = makefields.gaussian(cfg)
    ck = os.path.join(cfg.output_dir, "ckpt_step_5.npz")
    if writer == "jax":
        full = np.asarray(jrunner.run(cfg, vort0, record=False).zeta_hat)
        resumed = trunner.run(cfg, CPU, record=False, resume_from=ck)
        got = resumed.zeta_hat.numpy()
    else:
        full = trunner.run(cfg, CPU, vort0, record=False).zeta_hat.numpy()
        resumed = jrunner.run(cfg, record=False, resume_from=ck)
        got = np.asarray(resumed.zeta_hat)
    assert resumed.steps_run == 5
    assert _rel(np.fft.irfft2(full), np.fft.irfft2(got)) < 1e-6


def test_torch_checkpoint_resume_is_exact(tmp_path):
    cfg = _cfg(tmp_path, checkpoint_step=5, record_step=100)
    vort0 = makefields.gaussian(cfg)
    full = trunner.run(cfg, CPU, vort0, record=False)
    ck = os.path.join(cfg.output_dir, "ckpt_step_5.npz")
    resumed = trunner.run(cfg, CPU, record=False, resume_from=ck)
    assert torch.equal(full.zeta_hat, resumed.zeta_hat)


def test_script_forced_run_matches_jax(tmp_path):
    """SCRIPT forcing fires at its recipe time (t = 9 s -> step 3) in
    both runners; records and the forcing dumps agree."""
    src_field = (1e-8 * makefields.gaussian(_cfg(tmp_path)) / 1e-3).astype(
        np.float32)
    write_field(tmp_path / "s.bin", src_field)
    script = tmp_path / "recipe.txt"
    script.write_text(f"9.0 {tmp_path}/s.bin\n")
    outs = {}
    for pkg in ("jax", "torch"):
        cfg = _cfg(tmp_path, output_dir=str(tmp_path / pkg))
        vort0 = makefields.gaussian(cfg)
        log = str(tmp_path / f"log_{pkg}")
        if pkg == "jax":
            res = jrunner.run(cfg, vort0, recipe="script",
                              src_path=str(script), manifest_path=log)
        else:
            res = trunner.run(cfg, CPU, vort0, recipe="script",
                              src_path=str(script), manifest_path=log)
        assert res.steps_run == 10
        outs[pkg] = _records(cfg.output_dir)
    rec = read_field(tmp_path / "torch" / "vort_src_input_step_5.bin",
                     (64, 64))
    np.testing.assert_array_equal(rec, src_field)
    assert sorted(outs["jax"]) == sorted(outs["torch"])
    for name, a in outs["jax"].items():
        assert _rel(a, outs["torch"][name]) < 1e-6, name


def test_fifo_forced_run_matches_constant_source(tmp_path):
    """A FIFO delivering S at t = 0 reproduces a constant-source segment."""
    cfg = _cfg(tmp_path, total_steps=4)
    vort0 = makefields.gaussian(cfg)
    src_field = (1e-8 * makefields.gaussian(cfg) / 1e-3).astype(np.float32)
    fifo = tmp_path / "fifo"
    os.mkfifo(fifo)

    def producer():
        with open(fifo, "wb") as w:
            fsrc.write_step(w, src_field)
            for _ in range(cfg.total_steps - 1):
                fsrc.write_step(w, None)

    th = threading.Thread(target=producer)
    th.start()
    res = trunner.run(cfg, CPU, vort0, recipe="fifo", src_path=str(fifo),
                      record=False)
    th.join(timeout=60)
    assert not th.is_alive()
    from xlab_fftbarotropic_tpu.models.barotropic import BarotropicModel
    m = BarotropicModel.build(cfg)
    z = np.asarray(m.segment(m.init_state(vort0), jnp.asarray(src_field), 4))
    assert _rel(np.fft.irfft2(z), np.fft.irfft2(res.zeta_hat.numpy())) < 1e-6


def test_debug_fields_and_record_subset(tmp_path):
    cfg = _cfg(tmp_path, total_steps=5)
    res = trunner.run(cfg, CPU, makefields.gaussian(cfg),
                      manifest_path=str(tmp_path / "log"),
                      debug_fields=True, record_only=["vort", "vort_src"])
    assert res.stats_history[0]["step"] == 0
    names = sorted(os.listdir(cfg.output_dir))
    assert names == ["dvortdt_step_0.bin", "dvortdx_step_0.bin",
                     "dvortdy_step_0.bin", "vort_src_input_step_0.bin",
                     "vort_step_0.bin"]
    with pytest.raises(ValueError, match="unknown field"):
        trunner.run(cfg, CPU, makefields.gaussian(cfg),
                    manifest_path=str(tmp_path / "log2"),
                    record_only=["vorticity"])


def test_runner_refuses_what_is_not_ported(tmp_path):
    cfg = _cfg(tmp_path)
    v0 = makefields.gaussian(cfg)
    for kw in (dict(model_kind="jacobian"), dict(model_kind="fd"),
               dict(shard=True, decomp="pencil"),
               dict(shard=True, model_kind="sw"), dict(ensemble=4)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            trunner.run(cfg, CPU, v0, record=False, **kw)


@pytest.mark.parametrize("flags", [
    ["--fast-transforms"], ["--shard", "--decomp", "pencil"],
    ["--ensemble", "4"],
    ["-m", "sw", "--time-scheme", "etdrk4", "--beta", "1e-11"],
    ["-m", "shallow-water", "--fft-backend", "pallas", "--nu4", "1e5",
     "--shard"],
    ["-m", "fd"], ["-m", "jacobian"],
    ["-m", "tracer", "--time-scheme", "etdrk4", "--shard"], ["-m", "climate"],
    ["--time-scheme", "etdrk4", "--fast-transforms"], ["--fft-backend", "mxu"],
    ["--fft-backend", "pallas", "--nx", "96", "--ny", "96"],
    ["-m", "sw", "--beta", "1e-11"]])
def test_cli_stops_on_flags_outside_the_slice(tmp_path, flags):
    with pytest.raises(SystemExit) as e:
        tcli.main(["-O", str(tmp_path / "o"), "--device", "cpu",
                   "--total-steps", "1"] + flags)
    assert e.value.code != 0


@pytest.mark.parametrize("n", [32, 64])
def test_blowup_guard_fires_and_closes_the_manifest(tmp_path, n):
    """A CFL-violating run fails at a record boundary with BlowUpError,
    on the library path (32^2) and on the plane stepper (64^2), and the
    manifest keeps the records written before."""
    from xlab_fftbarotropic_torch.utils.guards import BlowUpError

    cfg = ModelConfig(nx=n, ny=n, dt=1e6, nu=0.0, total_steps=40,
                      record_step=10, output_dir=str(tmp_path / "out"))
    with pytest.raises(BlowUpError):
        trunner.run(cfg, CPU, makefields.kuo2004(cfg),
                    manifest_path=str(tmp_path / "log"))
    assert (tmp_path / "log").read_text().splitlines()[0].endswith(
        "vort_src_input_step_0.bin")


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(a)


def test_tracer_cli_matches_jax_cli(tmp_path, capsys):
    """-m tracer --tracer-kappa 50 --tracer-ic gaussian through both
    CLIs: identical manifest text, the same record files (q_step_N.bin
    among them), values within rel-L2 2e-6."""
    cfg = ModelConfig(nx=64, ny=64)
    inp, out = tmp_path / "in", tmp_path / "out"
    inp.mkdir()
    write_field(inp / "init.bin", makefields.gaussian(cfg))
    common = ["-I", str(inp), "-O", str(out), "-i", "init.bin", "--nx",
              "64", "--ny", "64", "--total-steps", "20", "--record-step",
              "10", "-m", "tracer", "--tracer-kappa", "50", "--tracer-ic",
              "gaussian"]
    assert jcli.main(common + ["--cpu", "--manifest",
                               str(tmp_path / "log_jax")]) == 0
    want = _records(out)
    assert tcli.main(common + ["--device", "cpu", "--manifest",
                               str(tmp_path / "log_torch")]) == 0
    err = capsys.readouterr().err
    assert "Model family          : tracer (kappa = 50" in err
    assert "FFT backend           : pallas" in err
    got = _records(out)
    assert (tmp_path / "log_jax").read_text() == \
        (tmp_path / "log_torch").read_text()
    assert sorted(want) == sorted(got) and len(got) == 12
    assert "q_step_10.bin" in got
    for name in want:
        assert got[name].size == 64 * 64, name
        if name.startswith("vort_src"):
            np.testing.assert_array_equal(want[name], got[name])
        else:
            assert _rel_l2(want[name], got[name]) < 2e-6, name


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tracer_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    cfg = _cfg(tmp_path, checkpoint_step=5, record_step=100)
    vort0 = makefields.gaussian(cfg)
    kw = dict(model_kind="tracer", tracer_kappa=50.0, tracer_ic="zonal")
    ck = os.path.join(cfg.output_dir, "ckpt_step_5.npz")
    if writer == "jax":
        full = jrunner.run(cfg, vort0, record=False, **kw).zeta_hat
        full = [np.asarray(z) for z in full]
        resumed = trunner.run(cfg, CPU, record=False, resume_from=ck, **kw)
        got = [z.numpy() for z in resumed.zeta_hat]
    else:
        full = trunner.run(cfg, CPU, vort0, record=False, **kw).zeta_hat
        full = [z.numpy() for z in full]
        resumed = jrunner.run(cfg, record=False, resume_from=ck, **kw)
        got = [np.asarray(z) for z in resumed.zeta_hat]
    assert resumed.steps_run == 5
    for a, b in zip(full, got):
        assert _rel_l2(np.fft.irfft2(a), np.fft.irfft2(b)) < 2e-6


def test_tracer_run_records_stats_and_resumes_exactly(tmp_path):
    cfg = _cfg(tmp_path, checkpoint_step=5)
    vort0 = makefields.gaussian(cfg)
    kw = dict(model_kind="tracer", tracer_kappa=50.0, tracer_ic="gaussian")
    full = trunner.run(cfg, CPU, vort0, manifest_path=str(tmp_path / "log"),
                       **kw)
    assert set(full.stats_history[0]) >= {"step", "q_mean", "q_var",
                                          "energy", "cfl"}
    assert (tmp_path / "output" / "q_step_5.bin").exists()
    resumed = trunner.run(cfg, CPU, record=False, **kw,
                          resume_from=os.path.join(cfg.output_dir,
                                                   "ckpt_step_5.npz"))
    for a, b in zip(full.zeta_hat, resumed.zeta_hat):
        assert torch.equal(a, b)


def test_debug_fields_refused_for_the_tracer(tmp_path):
    cfg = _cfg(tmp_path)
    with pytest.raises(ValueError, match="--debug-fields"):
        trunner.run(cfg, CPU, makefields.gaussian(cfg), record=False,
                    model_kind="tracer", debug_fields=True)
    with pytest.raises(ValueError, match="--debug-fields"):
        tcli.main(["-O", str(tmp_path / "o"), "-I", str(tmp_path / "i"),
                   "--device", "cpu", "--total-steps", "1", "-m", "tracer",
                   "--debug-fields"])


# ---------------------------------------------------------- shallow water

def _sw_close(want, got, bar):
    """Each record within `bar` of its max |JAX|; div within `bar` of
    max(|div|, |vort|) of the same step, as the JAX package normalizes
    it (tests/test_pallas_sw.py:126-138): a balanced flow's divergence is
    the residual of cancelling zeta-scale terms."""
    for name, a in want.items():
        b = got[name]
        assert b.size == a.size, name
        if name.startswith("div_"):
            vort = want[name.replace("div_", "vort_")]
            scale = max(np.max(np.abs(a)), np.max(np.abs(vort)))
        else:
            scale = np.max(np.abs(a))
        assert np.max(np.abs(a - b)) <= bar * scale, name


def test_sw_cli_matches_jax_cli(tmp_path, capsys):
    """-m sw through both CLIs from bench.py's vortex (zeta0 = 1e-5):
    identical manifest text (vort, psi, u, v, div, h and the forcing
    dump, in the JAX runner's order), values within 1e-5."""
    cfg = ModelConfig(nx=64, ny=64)
    inp, out = tmp_path / "in", tmp_path / "out"
    inp.mkdir()
    write_field(inp / "init.bin", makefields.gaussian(cfg, zeta0=1e-5))
    common = ["-I", str(inp), "-O", str(out), "-i", "init.bin", "--nx",
              "64", "--ny", "64", "--total-steps", "20", "--record-step",
              "10", "-m", "sw"]
    assert jcli.main(common + ["--cpu", "--manifest",
                               str(tmp_path / "log_jax")]) == 0
    want = _records(out)
    assert tcli.main(common + ["--device", "cpu", "--manifest",
                               str(tmp_path / "log_torch")]) == 0
    err = capsys.readouterr().err
    assert "Model family          : shallow-water (f = " in err
    assert "FFT backend           : pallas" in err
    got = _records(out)
    log = (tmp_path / "log_torch").read_text()
    assert (tmp_path / "log_jax").read_text() == log
    assert [p.rsplit("/", 1)[-1] for p in log.splitlines()[:7]] == [
        f"{k}_step_0.bin" for k in ("vort_src_input", "vort", "psi", "u",
                                    "v", "div", "h")]
    assert sorted(want) == sorted(got) and len(got) == 14
    assert float(np.min(got["h_step_10.bin"])) > 0.9 * cfg.mean_depth
    _sw_close(want, got, 1e-5)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sw_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    cfg = _cfg(tmp_path, checkpoint_step=5, record_step=100)
    vort0 = makefields.gaussian(cfg, zeta0=1e-5)
    ck = os.path.join(cfg.output_dir, "ckpt_step_5.npz")
    if writer == "jax":
        full = jrunner.run(cfg, vort0, record=False, model_kind="sw")
        full = [np.asarray(z) for z in full.zeta_hat]
        resumed = trunner.run(cfg, CPU, record=False, resume_from=ck,
                              model_kind="sw")
        got = [z.numpy() for z in resumed.zeta_hat]
    else:
        full = trunner.run(cfg, CPU, vort0, record=False, model_kind="sw")
        full = [z.numpy() for z in full.zeta_hat]
        resumed = jrunner.run(cfg, record=False, resume_from=ck,
                              model_kind="sw")
        got = [np.asarray(z) for z in resumed.zeta_hat]
    assert resumed.steps_run == 5
    want = {f"{k}_": np.fft.irfft2(a) for k, a in zip(("vort", "div", "eta"),
                                                       full)}
    _sw_close(want, {f"{k}_": np.fft.irfft2(b) for k, b in
                     zip(("vort", "div", "eta"), got)}, 1e-5)


def test_sw_run_records_stats_debug_and_resumes_exactly(tmp_path):
    cfg = _cfg(tmp_path, checkpoint_step=5)
    vort0 = makefields.gaussian(cfg, zeta0=1e-5)
    full = trunner.run(cfg, CPU, vort0, manifest_path=str(tmp_path / "log"),
                       model_kind="shallow-water", debug_fields=True,
                       record_only=["vort", "div", "h"])
    assert list(full.stats_history[0]) == ["step", "mass", "energy",
                                           "pot_enstrophy", "max_abs_div",
                                           "cfl"]
    assert abs(full.stats_history[1]["mass"] - cfg.mean_depth) \
        < 1e-6 * cfg.mean_depth
    names = sorted(os.listdir(cfg.output_dir))
    assert "h_step_5.bin" in names and "dvortdt_step_5.bin" in names
    assert "psi_step_5.bin" not in names
    resumed = trunner.run(cfg, CPU, record=False, model_kind="sw",
                          resume_from=os.path.join(cfg.output_dir,
                                                   "ckpt_step_5.npz"))
    assert resumed.steps_run == 5
    for a, b in zip(full.zeta_hat, resumed.zeta_hat):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- ETDRK4

@pytest.mark.parametrize("family", [
    ["-m", "sw", "--dt", "60"],
    ["--nu4", "1e14"],
    ["-m", "tracer", "--tracer-kappa", "50", "--tracer-ic", "gaussian",
     "--beta", "1.6e-11"]])
def test_etd_cli_matches_jax_cli(tmp_path, capsys, family):
    """--time-scheme etdrk4 through both CLIs (the port on the CPU plane
    path, the JAX package on its xla path): identical manifests, records
    within the port's bars (barotropic 1e-6 of max |record|, tracer
    rel-L2 2e-6, shallow water 1e-5 as above)."""
    cfg = ModelConfig(nx=64, ny=64)
    inp, out = tmp_path / "in", tmp_path / "out"
    inp.mkdir()
    sw = family[:2] == ["-m", "sw"]
    write_field(inp / "init.bin",
                makefields.gaussian(cfg, zeta0=1e-5 if sw else 1e-3))
    common = ["-I", str(inp), "-O", str(out), "-i", "init.bin", "--nx",
              "64", "--ny", "64", "--total-steps", "20", "--record-step",
              "10", "--time-scheme", "etdrk4"] + family
    assert jcli.main(common + ["--cpu", "--manifest",
                               str(tmp_path / "log_jax")]) == 0
    want = _records(out)
    assert tcli.main(common + ["--device", "cpu", "--manifest",
                               str(tmp_path / "log_torch")]) == 0
    err = capsys.readouterr().err
    assert "Time scheme           : etdrk4" in err
    assert "FFT backend           : pallas" in err
    got = _records(out)
    assert (tmp_path / "log_jax").read_text() == \
        (tmp_path / "log_torch").read_text()
    assert sorted(want) == sorted(got)
    if sw:
        _sw_close({k: v for k, v in want.items()
                   if not k.startswith("vort_src")}, got, 1e-5)
        return
    for name in want:
        if name.startswith("vort_src"):
            np.testing.assert_array_equal(want[name], got[name])
        elif family[:2] == ["-m", "tracer"]:
            assert _rel_l2(want[name], got[name]) < 2e-6, name
        else:
            assert _rel(want[name], got[name]) < 1e-6, name


def test_etd_cfl_guard_trips_through_the_runner(tmp_path):
    """An ETDRK4 run over its advective limit warns at the initial record
    and stops with AdvectiveCflError at the first violating later one
    (tests/test_etd_scalar.py:429-450)."""
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel)
    from xlab_fftbarotropic_torch.utils.guards import AdvectiveCflError
    cfg = _cfg(tmp_path, time_scheme="etdrk4", record_step=1,
               total_steps=5)
    base = makefields.gaussian(cfg)
    m = ShallowWaterModel.build(cfg, CPU)
    cfl0 = float(m.stats(m.geostrophic_init(base)).cfl)
    amp = 1.5 * (2.8 / np.pi) / cfl0
    with pytest.warns(UserWarning, match="advective CFL"), \
            pytest.raises(AdvectiveCflError):
        trunner.run(cfg, CPU, amp * base, model_kind="sw",
                    manifest_path=str(tmp_path / "log"))
    res = trunner.run(cfg.replace(total_steps=2), CPU, base, model_kind="sw",
                      manifest_path=str(tmp_path / "log2"))
    assert all(s["cfl"] < 2.8 / np.pi for s in res.stats_history)


@pytest.mark.parametrize("model_kind", ["barotropic", "tracer", "sw"])
def test_resume_across_schemes_is_refused(tmp_path, model_kind):
    cfg = _cfg(tmp_path, checkpoint_step=5, record_step=100)
    vort0 = makefields.gaussian(cfg, zeta0=1e-5)
    trunner.run(cfg, CPU, vort0, record=False, model_kind=model_kind)
    ck = os.path.join(cfg.output_dir, "ckpt_step_5.npz")
    with pytest.raises(ValueError, match="config mismatch"):
        trunner.run(cfg.replace(time_scheme="etdrk4"), CPU, record=False,
                    resume_from=ck, model_kind=model_kind)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sw_etd_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    cfg = _cfg(tmp_path, checkpoint_step=5, record_step=100,
               time_scheme="etdrk4", dt=60.0)
    vort0 = makefields.gaussian(cfg, zeta0=1e-5)
    ck = os.path.join(cfg.output_dir, "ckpt_step_5.npz")
    if writer == "jax":
        full = jrunner.run(cfg, vort0, record=False, model_kind="sw")
        full = [np.asarray(z) for z in full.zeta_hat]
        resumed = trunner.run(cfg, CPU, record=False, resume_from=ck,
                              model_kind="sw")
        got = [z.numpy() for z in resumed.zeta_hat]
    else:
        full = trunner.run(cfg, CPU, vort0, record=False, model_kind="sw")
        full = [z.numpy() for z in full.zeta_hat]
        resumed = jrunner.run(cfg, record=False, resume_from=ck,
                              model_kind="sw")
        got = [np.asarray(z) for z in resumed.zeta_hat]
    assert resumed.steps_run == 5
    want = {f"{k}_": np.fft.irfft2(a) for k, a in zip(("vort", "div", "eta"),
                                                       full)}
    _sw_close(want, {f"{k}_": np.fft.irfft2(b) for k, b in
                     zip(("vort", "div", "eta"), got)}, 1e-5)
