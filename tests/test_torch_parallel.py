"""The port's sharded barotropic model in the slab decomposition
(parallel/model.py, parallel/dfft.py), on the CPU, against the JAX
package's ShardedBarotropicModel (fft_impl="xla", decomp="slab") on 4 of
the 8 virtual CPU devices, and against the port's single-device model:
the same numpy-made initial state, carried across by
convert.sharded_state_from_numpy. For each of the port's impls (the
library transposes, and the plain versions of the a2a and xstage
kernels) rel-L2 of the physical vorticity <= 1e-6 after 3 RK4 steps and
2 ETDRK4 steps at 64^2; also P = 1 against P = 4, the distributed
transform pair against the JAX one (with a non-Hermitian ky = 0 and ny/2
column), the transforms per step (the unpaired inverses), the CLI's
--shard run against its unsharded run, and the refusals."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig
from xlab_fftbarotropic_tpu.ic import makefields as jmakefields
from xlab_fftbarotropic_tpu.parallel import dfft as jdfft
from xlab_fftbarotropic_tpu.parallel.model import (
    ShardedBarotropicModel as JSharded)
from xlab_fftbarotropic_torch import convert
from xlab_fftbarotropic_torch.cli import run as tcli
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.io.checkpoint import load_checkpoint
from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
from xlab_fftbarotropic_torch.parallel import (ShardedBarotropicModel, dfft,
                                               fused_overlap, make_mesh)
from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

CPU = torch.device("cpu")
NS = 4
IMPLS = ["xla", "pallas", "overlap"]
STEPS = {"rk4": 3, "etdrk4": 2}
TOL = 1e-6


def _cfg(scheme="rk4", **kw):
    return dict(nx=64, ny=64, time_scheme=scheme, **kw)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:NS]), ("x",))


@pytest.fixture(scope="module")
def jax_runs(mesh):
    """scheme -> (initial global state, physical vorticity after STEPS)
    of the JAX slab model on the library collectives."""
    out = {}
    for scheme, n in STEPS.items():
        cfg = JConfig(**_cfg(scheme))
        m = JSharded.build(cfg, mesh, fft_impl="xla", decomp="slab")
        z0 = m.init_state(jmakefields.gaussian(cfg))
        z = m.segment(z0, m.zero_source(), n)
        out[scheme] = (np.asarray(z0), np.asarray(m.diags(z).vort))
    return out


def _port_vort(scheme, impl, z0, n_shards=NS, decomp="slab"):
    m = ShardedBarotropicModel.build(ModelConfig(**_cfg(scheme)),
                                     make_mesh(n_shards, CPU), impl, decomp)
    z = m.segment(convert.sharded_state_from_numpy(z0, m), m.zero_source(),
                  STEPS[scheme])
    return m.unshard_physical(m.diags(z).vort).numpy(), m, z


@pytest.mark.parametrize("scheme", ["rk4", "etdrk4"])
@pytest.mark.parametrize("impl", IMPLS)
def test_slab_model_matches_jax_and_the_single_device_model(
        jax_runs, scheme, impl):
    z0, want = jax_runs[scheme]
    got, m, z = _port_vort(scheme, impl, z0)
    assert z.shape == (NS, 16, 33) and z.dtype == torch.complex64
    assert _rel(got, want) <= TOL
    single = BarotropicModel.build(
        ModelConfig(**_cfg(scheme, fft_backend="xla")), CPU)
    zs = single.segment(torch.from_numpy(z0.copy()), single.zero_source(),
                        STEPS[scheme])
    assert _rel(got, single.diags(zs).vort) <= TOL
    # the global state round trip
    assert np.array_equal(convert.sharded_state_to_numpy(
        convert.sharded_state_from_numpy(z0, m), m), z0)


@pytest.mark.parametrize("impl", IMPLS)
def test_one_shard_matches_four(jax_runs, impl):
    z0, _ = jax_runs["rk4"]
    one, _, _ = _port_vort("rk4", impl, z0, n_shards=1)
    four, _, _ = _port_vort("rk4", impl, z0)
    assert _rel(one, four) <= TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_inverse_reads_the_self_conjugate_bins_as_jax_does(mesh, impl):
    """A half-spectrum whose ky = 0 and ky = ny/2 columns are not
    Hermitian along x (the positive-Nyquist convention's content): the
    distributed inverse projects it out, as the JAX one (and pocketfft's
    c2r) does."""
    rng = np.random.default_rng(11)
    s = (rng.standard_normal((64, 33))
         + 1j * rng.standard_normal((64, 33))).astype(np.complex64)
    want = np.asarray(jax.jit(shard_map(
        lambda a: jdfft.irfft2_local(a, (64, 64), "x", NS), mesh=mesh,
        in_specs=P("x", None), out_specs=P("x", None)))(jnp.asarray(s)))
    _, inv = (fused_overlap.make_fft_pair() if impl == "overlap"
              else dfft.make_fft_pair(use_pallas=impl == "pallas"))
    got = dfft.unshard_rows(inv(dfft.shard_rows(torch.from_numpy(s), NS),
                                (64, 64))).numpy()
    assert _rel(got, want) <= TOL
    # and the forward transform is rfft2's
    fwd, _ = dfft.make_fft_pair(use_pallas=impl == "pallas")
    f = rng.standard_normal((64, 64)).astype(np.float32)
    got = dfft.unshard_rows(fwd(dfft.shard_rows(torch.from_numpy(f), NS)))
    ref = np.fft.rfft2(f)
    assert float(np.abs(got.numpy() - ref).max() / np.abs(ref).max()) < 1e-6


@pytest.mark.parametrize("impl,counts", [
    ("pallas", {"a2a_cols_plain": 20, "a2a_rows_plain": 20}),
    ("overlap", {"xstage_plain": 20})])
def test_a_step_runs_five_unpaired_transforms_per_stage(
        monkeypatch, impl, counts):
    """Four stages of four inverse transforms (inv_pair is None on the
    shards) and one forward, each two transposes or one x-stage: 20 of
    each per step, 4 forward x-stages and 16 inverse ones."""
    calls = {k: [] for k in counts}
    for name in counts:
        mod = fused_overlap if name == "xstage_plain" else ftr
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name].append(a[1] if _name == "xstage_plain" else None)
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    cfg = ModelConfig(**_cfg())
    m = ShardedBarotropicModel.build(cfg, make_mesh(NS, CPU), impl)
    z = m.init_state(np.ones((64, 64), np.float32))
    for k in calls:
        calls[k].clear()
    m.step(z, m.zero_source())
    assert {k: len(v) for k, v in calls.items()} == counts
    if impl == "overlap":
        assert calls["xstage_plain"].count(True) == 4


def test_tables_are_row_sharded_and_the_mean_mode_sits_on_shard_0():
    m = ShardedBarotropicModel.build(ModelConfig(**_cfg()),
                                     make_mesh(NS, CPU))
    t = m.tables
    assert t.kx.shape == (NS, 16) and t.ky.shape == (33,)
    assert t.lap.shape == t.inv_lap.shape == (NS, 16, 33)
    assert float(t.inv_lap[0, 0, 0]) == 1.0
    assert all(float(t.inv_lap[s, 0, 0]) < 0.0 for s in range(1, NS))
    z = torch.zeros(m.spectral_shape, dtype=torch.complex64)
    z[0, 0, 0] = 3.0
    psi = m.unshard_physical(m.diags(z).psi)
    assert torch.allclose(psi, torch.full((64, 64), 3.0 / 64 ** 2))


def _cli(tmp_path, name, extra):
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.io.fieldio import write_field

    inp = tmp_path / "in"
    inp.mkdir(exist_ok=True)
    cfg = ModelConfig(nx=64, ny=64)
    write_field(inp / cfg.init_file, makefields.gaussian(cfg))
    out = tmp_path / name
    rc = tcli.main(["-I", str(inp), "-O", str(out), "--nx", "64", "--ny",
                    "64", "--total-steps", "6", "--record-step", "3",
                    "--device", "cpu", "--manifest", str(tmp_path / name)
                    + ".log", "--checkpoint-step", "3"] + extra)
    assert rc == 0
    return out


@pytest.mark.parametrize("decomp,impl", [("slab", "pallas"),
                                         ("xpencil", "overlap")])
def test_cli_shard_run_matches_the_unsharded_run(tmp_path, decomp, impl):
    ref = _cli(tmp_path, "ref", [])
    out = _cli(tmp_path, "shard", ["--shard", "--shard-fft", impl,
                                   "--decomp", decomp])
    names = sorted(p.name for p in ref.iterdir())
    assert names == sorted(p.name for p in out.iterdir())
    for name in names:
        if name.endswith(".bin"):
            a = np.fromfile(ref / name, np.float32)
            b = np.fromfile(out / name, np.float32)
            assert np.isfinite(b).all()
            assert (a.any() and _rel(b, a) <= TOL) or np.array_equal(a, b)
    a, step, _ = load_checkpoint(ref / "ckpt_step_3.npz")
    b, _, _ = load_checkpoint(out / "ckpt_step_3.npz")
    assert step == 3 and b.shape == (64, 33) and b.dtype == np.complex64
    assert float(np.abs(b - a).max() / np.abs(a).max()) <= TOL


@pytest.mark.parametrize("flags", [
    ["--shard", "-m", "sw"], ["--shard", "-m", "tracer"],
    ["--shard", "--decomp", "pencil"], ["--shard", "--mesh-shape", "2x2"]])
def test_cli_refuses_what_waits(tmp_path, flags, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["-O", str(tmp_path / "o"), "--device", "cpu",
                   "--total-steps", "1"] + flags)
    assert e.value.code != 0
    assert "item 5" in capsys.readouterr().err


def test_more_than_one_card_is_refused(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 5"):
        make_mesh(None, "cuda")
    assert make_mesh(None, CPU).n_shards == 1
    assert make_mesh(3, CPU).n_shards == 3
    with pytest.raises(NotImplementedError, match="item 5"):
        ShardedBarotropicModel.build(ModelConfig(**_cfg()),
                                     make_mesh(NS, CPU), decomp="pencil")
    with pytest.raises(ValueError):
        ShardedBarotropicModel.build(ModelConfig(**_cfg()),
                                     make_mesh(NS, CPU), fft_impl="mpi")
    with pytest.raises(ValueError):
        make_mesh(0, CPU)
    # the CLI stops before it reads anything
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "x")
    with pytest.raises(SystemExit):
        tcli.main(["-O", str(tmp_path / "o"), "--total-steps", "1",
                   "--shard"])
    assert "item 5" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "o")
