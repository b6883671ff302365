"""The port's runner and CLI against the JAX package's, on the CPU, for
the barotropic family (the tracer, shallow-water and ETDRK4 runs:
tests/test_torch_runner_families.py): byte-compatible record files and
`log` manifest, checkpoints that resume across the two packages, and the
forced (script and fifo) paths.

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
from torch_threads import _one_thread  # noqa: F401

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
    # the 2-D pencil decomposition, refused before it was ported, runs on
    # the 1x1 mesh; a mesh of more shards than the one process needs one
    # process per shard (torchrun or the XFB_* contract, item 5.2); its
    # impl is xla only
    res = trunner.run(cfg, CPU, v0, record=False, shard=True,
                      decomp="pencil")
    assert res.steps_run == 10 and bool(torch.isfinite(res.zeta_hat).all())
    with pytest.raises(NotImplementedError, match="torchrun"):
        trunner.run(cfg, CPU, v0, record=False, shard=True, decomp="pencil",
                    mesh_shape=(2, 2))
    with pytest.raises(ValueError, match="fft_impl='xla' only"):
        trunner.run(cfg, CPU, v0, record=False, shard=True, decomp="pencil",
                    shard_fft="pallas")
    # the sharded shallow-water model, refused before it was ported, runs
    res = trunner.run(cfg, CPU, v0, record=False, shard=True,
                      model_kind="sw")
    assert res.steps_run == 10 and res.stats_history == []
    assert all(torch.isfinite(z).all() for z in res.zeta_hat)
    # what the JAX runner refuses too (runner.py:348-352 there)
    for kw, match in ((dict(ensemble=4, shard=True), "mutually exclusive"),
                      (dict(ensemble=4, model_kind="fd"), "not supported"),
                      (dict(ensemble=4, model_kind="jacobian"),
                       "not supported")):
        with pytest.raises(ValueError, match=match):
            trunner.run(cfg, CPU, v0, record=False, **kw)


@pytest.mark.parametrize("flags", [
    ["-m", "sw", "--fast-transforms", "--shard", "--nx", "64", "--ny",
     "64"],
    ["--shard", "--decomp", "pencil"],
    ["--ensemble", "4", "--shard"],
    ["-m", "sw", "--time-scheme", "etdrk4", "--beta", "1e-11"],
    ["-m", "shallow-water", "--fft-backend", "pallas", "--nu4", "1e5",
     "--shard"],
    ["-m", "fd", "--ensemble", "2"], ["-m", "jacobian", "--shard"],
    ["-m", "tracer", "--time-scheme", "etdrk4", "--shard"], ["-m", "climate"],
    ["-m", "tracer", "--fast-transforms", "--shard"],
    ["--fft-backend", "mxu"],
    ["--fft-backend", "pallas", "--nx", "96", "--ny", "96"],
    ["-m", "sw", "--beta", "1e-11"]])
def test_cli_stops_on_flags_outside_the_slice(tmp_path, flags):
    """Each flag set stops before the run, but --shard with -m sw or -m
    tracer, which stopped until the sharded families were ported, and
    --shard --decomp pencil, until the pencil was: those run now (at
    64^2) and write their family's records."""
    if "--shard" in flags and ("sw" in flags or "tracer" in flags
                               or "pencil" in flags):
        inp = tmp_path / "in"
        inp.mkdir()
        cfg = ModelConfig(nx=64, ny=64)
        write_field(str(inp / cfg.init_file), makefields.gaussian(cfg))
        assert tcli.main(["-I", str(inp), "-O", str(tmp_path / "o"),
                          "--device", "cpu", "--total-steps", "1",
                          "--manifest", str(tmp_path / "log")] + flags
                         + ["--nx", "64", "--ny", "64"]) == 0
        name = ("div" if "sw" in flags else "q" if "tracer" in flags
                else "vort")
        assert (tmp_path / "o" / f"{name}_step_0.bin").stat().st_size == (
            64 * 64 * 4)
        return
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
