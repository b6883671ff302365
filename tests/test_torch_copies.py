"""The port's own copies of the JAX package's numpy-only modules (config,
ic/makefields, io/fieldio, io/checkpoint, io/native_stream,
forcing/source, utils/guards) against the originals, on the CPU: the
same configuration fields, defaults, JSON and hash; bit-identical
initial conditions; byte-identical records and manifests; checkpoints
that load in either package; the same forcing streams and guards; and
the native libraries found at the same paths.
"""

import dataclasses
import argparse
from pathlib import Path

import numpy as np
import pytest

from xlab_fftbarotropic_tpu import config as jconfig
from xlab_fftbarotropic_tpu.forcing import source as jsource
from xlab_fftbarotropic_tpu.ic import makefields as jmf
from xlab_fftbarotropic_tpu.io import checkpoint as jckpt
from xlab_fftbarotropic_tpu.io import fieldio as jfio
from xlab_fftbarotropic_tpu.io import native_stream as jnative
from xlab_fftbarotropic_tpu.utils import guards as jguards
from xlab_fftbarotropic_torch import config as tconfig
from xlab_fftbarotropic_torch.forcing import source as tsource
from xlab_fftbarotropic_torch.ic import makefields as tmf
from xlab_fftbarotropic_torch.io import checkpoint as tckpt
from xlab_fftbarotropic_torch.io import fieldio as tfio
from xlab_fftbarotropic_torch.io import native_stream as tnative
from xlab_fftbarotropic_torch.utils import guards as tguards

CONFIGS = [dict(), dict(nx=64, ny=32, dt=7.5, time_scheme="etdrk4"),
           dict(nu4=1e13, r_drag=1e-5, beta=1.6e-11, output_dir="o"),
           dict(f=2e-5, gravity=9.8, mean_depth=500.0,
                dealias_rule="twothirds", fft_backend="xla")]


def test_config_fields_and_defaults_are_the_jax_ones():
    def fields(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]
    assert fields(tconfig.ModelConfig) == fields(jconfig.ModelConfig)
    assert tconfig.ModelConfig._PATH_FIELDS == jconfig.ModelConfig._PATH_FIELDS


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_json_and_hash_are_the_jax_ones(kw):
    t, j = tconfig.ModelConfig(**kw), jconfig.ModelConfig(**kw)
    assert t.to_json() == j.to_json()
    assert t.config_hash() == j.config_hash()
    assert tconfig.ModelConfig.from_json(j.to_json()) == t
    assert (t.spectral_shape, t.grid_shape, t.dx, t.dealias_kx) == \
        (j.spectral_shape, j.grid_shape, j.dx, j.dealias_kx)
    for a, b in zip(t.coords(), j.coords()):
        np.testing.assert_array_equal(a, b)


def test_cli_arguments_give_the_same_config():
    argv = ["--nx", "128", "--ny", "64", "--dt", "7.5", "--time-scheme",
            "etdrk4", "--nu4", "1e13", "-O", "out", "--coriolis-f", "2e-5"]
    got = []
    for mod in (tconfig, jconfig):
        p = argparse.ArgumentParser()
        mod.add_config_args(p)
        got.append(mod.config_from_args(p.parse_args(argv)).to_json())
    assert got[0] == got[1]


@pytest.mark.parametrize("name", sorted(jmf.GENERATORS))
@pytest.mark.parametrize("shape", [(64, 64), (96, 48)])
def test_makefields_are_bit_identical(name, shape):
    kw = dict(nx=shape[0], ny=shape[1])
    a = tmf.make(name, tconfig.ModelConfig(**kw))
    b = jmf.make(name, jconfig.ModelConfig(**kw))
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    cfg = tconfig.ModelConfig(**kw)
    np.testing.assert_array_equal(
        tmf.cake_kuo2004(cfg, 3e5, 2e5, 1e-3, 4e4),
        jmf.cake_kuo2004(jconfig.ModelConfig(**kw), 3e5, 2e5, 1e-3, 4e4))


def test_records_and_manifest_are_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    fields = {k: rng.standard_normal((32, 32)).astype(np.float32)
              for k in ("vort", "psi", "u", "v", "div", "h", "q")}
    src = rng.standard_normal((32, 32)).astype(np.float32)
    for name, mod in (("torch", tfio), ("jax", jfio)):
        with mod.Manifest(tmp_path / f"log_{name}") as man:
            rec = mod.FieldRecorder(tmp_path / name, man)
            rec.record(5, vort_src=src, **fields)
    want = (tmp_path / "log_jax").read_text().replace("/jax/", "/torch/")
    assert (tmp_path / "log_torch").read_text() == want
    for f in sorted((tmp_path / "jax").iterdir()):
        assert (tmp_path / "torch" / f.name).read_bytes() == f.read_bytes()
        np.testing.assert_array_equal(
            tfio.read_field(f, (32, 32)), jfio.read_field(f, (32, 32)))
    with pytest.raises(FileNotFoundError):
        tfio.read_field(tmp_path / "missing.bin")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_load_in_either_package(tmp_path, writer):
    kw = dict(nx=32, ny=32, time_scheme="etdrk4", dt=7.5)
    rng = np.random.default_rng(1)
    state = (rng.standard_normal((3, 32, 17))
             + 1j * rng.standard_normal((3, 32, 17))).astype(np.complex64)
    w, r = (jckpt, tckpt) if writer == "jax" else (tckpt, jckpt)
    wcfg = (jconfig if writer == "jax" else tconfig).ModelConfig(**kw)
    rcfg = (tconfig if writer == "jax" else jconfig).ModelConfig(**kw)
    path = tmp_path / "ck.npz"
    w.save_checkpoint(path, wcfg, state, 7, kind="sw")
    got, step, saved = r.load_checkpoint(path, rcfg, kind="sw")
    np.testing.assert_array_equal(got, state)
    assert step == 7 and saved.to_json() == rcfg.to_json()
    with pytest.raises(ValueError, match="config mismatch"):
        r.load_checkpoint(path, rcfg.replace(time_scheme="rk4"), kind="sw")
    with pytest.raises(ValueError, match="model family"):
        r.load_checkpoint(path, rcfg, kind="tracer")


def test_forcing_streams_are_the_jax_ones(tmp_path):
    cfg_t = tconfig.ModelConfig(nx=32, ny=32, dt=600.0, total_steps=40)
    cfg_j = jconfig.ModelConfig(nx=32, ny=32, dt=600.0, total_steps=40)
    field = np.arange(32 * 32, dtype=np.float32).reshape(32, 32)
    tfio.write_field(tmp_path / "s.bin", field)
    recipe = tmp_path / "recipe.txt"
    recipe.write_text("# comment\n9.0 s.bin\n3.0 s.bin\n")
    rt = tsource.make_reader(cfg_t, "script", recipe)
    rj = jsource.make_reader(cfg_j, "script", recipe)
    assert [r for r, _ in rt.recipes] == [r for r, _ in rj.recipes]
    for time in (0.0, 3.0, 5.0, 9.0):
        (ct, ft), (cj, fj) = rt.read(time), rj.read(time)
        assert ct == cj
        if ct:
            np.testing.assert_array_equal(ft, fj)
    assert type(tsource.make_reader(cfg_t)) is tsource.SourceReader
    # a flag-byte stream written by the JAX package's producer reads the
    # same through both packages' FIFO readers
    with open(tmp_path / "stream", "wb") as fh:
        jsource.write_step(fh, field)
        jsource.write_step(fh, None)
    rt = tsource.FifoSourceReader(cfg_t, tmp_path / "stream")
    rj = jsource.FifoSourceReader(cfg_j, tmp_path / "stream")
    for _ in range(3):                   # field, keep, missing flag byte
        (ct, ft), (cj, fj) = rt.read(0.0), rj.read(0.0)
        assert ct == cj
        if ct:
            np.testing.assert_array_equal(ft, field)
            np.testing.assert_array_equal(ft, fj)
    rt.close()
    rj.close()


def test_native_libraries_are_found_where_the_jax_package_finds_them():
    assert tnative.NATIVE_DIR == jnative.NATIVE_DIR
    assert Path(tfio.__file__).resolve().parents[2] == \
        Path(jfio.__file__).resolve().parents[2]
    assert tnative.available() == jnative.available()


def test_guards_are_the_jax_ones():
    assert tguards.ETD_CFL_LIMIT == jguards.ETD_CFL_LIMIT
    bad = np.array([1.0, np.nan, np.inf], np.float32)
    for mod in (tguards, jguards):
        mod.check_finite(3, vort=np.ones(4, np.float32), psi=None)
        with pytest.raises(mod.BlowUpError, match="2 non-finite"):
            mod.check_finite(3, vort=bad)
