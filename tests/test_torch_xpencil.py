"""The port's sharded barotropic model in the x-pencil decomposition
(parallel/xpencil.py), on the CPU, against the JAX package's
ShardedBarotropicModel (fft_impl="xla", decomp="xpencil") on 4 of the 8
virtual CPU devices and against the port's single-device model, for each
of the port's impls: rel-L2 of the physical vorticity <= 1e-6 after 3
RK4 and 2 ETDRK4 steps at 64^2, the JAX state carried across with its
pad stripped and the port's put back (convert.sharded_state_*). Also:
the pad columns stay exactly zero, the transform pair against rfft2, the
transforms per step, and the tables' layout."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig
from xlab_fftbarotropic_tpu.ic import makefields as jmakefields
from xlab_fftbarotropic_tpu.parallel.model import (
    ShardedBarotropicModel as JSharded)
from xlab_fftbarotropic_torch import convert
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
from xlab_fftbarotropic_torch.parallel import (ShardedBarotropicModel, dfft,
                                               fused_overlap, make_mesh,
                                               xpencil)
from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr
from torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")
NS = 4
IMPLS = ["xla", "pallas", "overlap"]
STEPS = {"rk4": 3, "etdrk4": 2}
TOL = 1e-6
HNY, HPAD = 33, 36


def _cfg(scheme="rk4", **kw):
    return dict(nx=64, ny=64, time_scheme=scheme, **kw)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def jax_runs():
    """scheme -> (initial global x-pencil state, its pad, physical
    vorticity after STEPS) of the JAX x-pencil model."""
    mesh = Mesh(np.array(jax.devices()[:NS]), ("x",))
    out = {}
    for scheme, n in STEPS.items():
        cfg = JConfig(**_cfg(scheme))
        m = JSharded.build(cfg, mesh, fft_impl="xla", decomp="xpencil")
        z0 = m.init_state(jmakefields.gaussian(cfg))
        z = m.segment(z0, m.zero_source(), n)
        out[scheme] = (np.asarray(z0), m.hpad, np.asarray(m.diags(z).vort))
    return out


def _model(scheme, impl, n_shards=NS):
    return ShardedBarotropicModel.build(ModelConfig(**_cfg(scheme)),
                                        make_mesh(n_shards, CPU), impl,
                                        "xpencil")


@pytest.mark.parametrize("scheme", ["rk4", "etdrk4"])
@pytest.mark.parametrize("impl", IMPLS)
def test_xpencil_model_matches_jax_and_the_single_device_model(
        jax_runs, scheme, impl):
    z0, jax_hpad, want = jax_runs[scheme]
    m = _model(scheme, impl)
    assert m.hpad == HPAD and m.spectral_shape == (NS, 64, HPAD // NS)
    s0 = convert.sharded_state_from_numpy(z0, m)
    z = m.segment(s0, m.zero_source(), STEPS[scheme])
    got = m.unshard_physical(m.diags(z).vort).numpy()
    assert _rel(got, want) <= TOL
    single = BarotropicModel.build(
        ModelConfig(**_cfg(scheme, fft_backend="xla")), CPU)
    zs = single.segment(torch.from_numpy(z0[:, :HNY].copy()),
                        single.zero_source(), STEPS[scheme])
    assert _rel(got, single.diags(zs).vort) <= TOL
    # the pad columns are exact zeros, before and after the segment
    for state in (s0, z):
        padded = state.permute(1, 0, 2).reshape(64, HPAD)
        assert not padded[:, HNY:].any()
    # back to the JAX layout, its pad put back
    back = convert.sharded_state_to_numpy(s0, m, hpad=jax_hpad)
    assert np.array_equal(back, z0)


@pytest.mark.parametrize("impl", IMPLS)
def test_one_shard_matches_four(jax_runs, impl):
    z0, _, _ = jax_runs["rk4"]
    vort = []
    for n in (1, NS):
        m = _model("rk4", impl, n)
        z = m.segment(convert.sharded_state_from_numpy(z0, m),
                      m.zero_source(), STEPS["rk4"])
        vort.append(m.unshard_physical(m.diags(z).vort))
    assert _rel(vort[0], vort[1]) <= TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_transform_pair_is_rfft2_with_a_zero_pad(impl):
    rng = np.random.default_rng(5)
    f = rng.standard_normal((64, 64)).astype(np.float32)
    fwd, inv = xpencil.make_fft_pair(HNY, impl)
    spec = fwd(dfft.shard_rows(torch.from_numpy(f), NS))
    assert spec.shape == (NS, 64, HPAD // NS)
    full = spec.permute(1, 0, 2).reshape(64, HPAD)
    assert not full[:, HNY:].any()
    ref = np.fft.rfft2(f)
    assert float(np.abs(full[:, :HNY].numpy() - ref).max()
                 / np.abs(ref).max()) < 1e-6
    back = dfft.unshard_rows(inv(spec, (64, 64))).numpy()
    assert float(np.abs(back - f).max()) < 1e-5


@pytest.mark.parametrize("impl,counts", [
    ("pallas", {"a2a_cols_plain": 4, "a2a_rows_plain": 16}),
    ("overlap", {"xstage_gather_plain": 4, "xstage_scatter_plain": 16})])
def test_a_step_runs_one_transpose_per_unpaired_transform(
        monkeypatch, impl, counts):
    """Per step 4 forward transforms (one gather each) and 16 unpaired
    inverse ones (one scatter each)."""
    calls = {k: 0 for k in counts}
    for name in counts:
        mod = ftr if name.startswith("a2a") else fused_overlap
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    m = _model("rk4", impl)
    z = m.init_state(np.ones((64, 64), np.float32))
    for k in calls:
        calls[k] = 0
    m.step(z, m.zero_source())
    assert calls == counts


def test_tables_are_column_sharded_and_padded():
    t = _model("rk4", "xla").tables
    w = HPAD // NS
    assert t.kx.shape == (64,) and t.ky.shape == (NS, w)
    assert t.lap.shape == t.mask.shape == (NS, 64, w)
    assert float(t.inv_lap[0, 0, 0]) == 1.0
    glob = {k: getattr(t, k).permute(1, 0, 2).reshape(64, HPAD)
            for k in ("lap", "inv_lap", "mask", "rlap")}
    assert not glob["mask"][:, HNY:].any() and not glob["lap"][:, HNY:].any()
    assert bool((glob["inv_lap"][:, HNY:] == 1).all())
    assert bool((glob["rlap"][:, HNY:] == 1).all())
    assert not t.ky.reshape(-1)[HNY:].any()
    # the ETD tables pad with identity propagators and zero weights
    e = _model("etdrk4", "xla").etd_tables
    for name, pad in zip(e._fields, (1, 1, 0, 0, 0, 0)):
        g = getattr(e, name).permute(1, 0, 2).reshape(64, HPAD)
        assert bool((g[:, HNY:] == pad).all()), name
