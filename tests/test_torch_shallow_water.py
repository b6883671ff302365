"""The port's shallow-water family (xlab_fftbarotropic_torch.models.
shallow_water) against the JAX package's, on the CPU.

The port runs on CPU tensors here, so its "pallas" backend is the plane
stepper through the kernels' plain torch versions; the JAX pallas plane
stepper runs in interpret mode, as the JAX package's own tests run it.

Bars, the JAX package's own for its two SW paths
(tests/test_pallas_sw.py:126-183): one step within 1e-5 and a 20-step
segment within 2e-4 of max |field| in physical space, div normalized by
max(|div|, |zeta|) (_phys_err below); forward_pair within 1e-6 relative;
the initial states and the records within 1e-6 of max |JAX|, the stats
within 1e-5 relative; max_stable_dt and the state conversion exact.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.models import shallow_water as jsw
from xlab_fftbarotropic_tpu.ops import fft as jfft
from xlab_fftbarotropic_tpu.ops import pallas_sw as psw
from xlab_fftbarotropic_tpu.ops.spectral import SpectralTables as JT
from xlab_fftbarotropic_torch import convert
from xlab_fftbarotropic_torch.models import shallow_water as tsw
from xlab_fftbarotropic_torch.ops import fft as tfft
from xlab_fftbarotropic_torch.ops import fused_sw as fs
from xlab_fftbarotropic_torch.ops.spectral import SpectralTables as TT
from torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")
N = 128
STEPS = 20


def _cfg(**kw):
    kw.setdefault("nx", N)
    kw.setdefault("ny", N)
    kw.setdefault("dt", 1.0)
    return ModelConfig(**kw)


def _np_state(s):
    return tuple(np.asarray(z) if not isinstance(z, torch.Tensor)
                 else z.numpy() for z in s)


def _phys_err(want, got, g):
    """Max abs error of zeta, div and eta in physical space over the
    norms of the JAX package's _assert_close_phys: max |zeta|,
    max(|div|, |zeta|) and max |eta| of `want`."""
    a = [np.fft.irfft2(z, s=g) for z in _np_state(want)]
    b = [np.fft.irfft2(z, s=g) for z in _np_state(got)]
    nz = np.max(np.abs(a[0]))
    norms = (nz, max(np.max(np.abs(a[1])), nz), np.max(np.abs(a[2])))
    return [np.max(np.abs(x - y)) / max(m, 1e-12)
            for x, y, m in zip(a, b, norms)]


def _random_state(seed):
    """zeta 1e-4, div 1e-6, eta 5 m (tests/test_pallas_sw.py:38-48), as
    complex64 numpy half-spectra."""
    rng = np.random.default_rng(seed)
    g = _cfg().grid_shape
    return tuple(np.asarray(jfft.forward(jnp.asarray(
        (amp * rng.standard_normal(g)).astype(np.float32))))
        for amp in (1e-4, 1e-6, 5.0))


def _t_state(s):
    return tsw.SWState(*(torch.from_numpy(np.array(z)) for z in s))


@pytest.mark.parametrize("shape", [(64, 64), (64, 96), (128, 32)])
@pytest.mark.parametrize("amps", [(1.0, 1.0), (1e-3, 3e-3)])
def test_forward_pair_matches_jax(shape, amps):
    """Partners of like size, as the library path pairs them (q u with
    q v, eta u with eta v): each takes the other's round-off."""
    rng = np.random.default_rng(shape[1])
    a, b = ((amp * rng.standard_normal(shape)).astype(np.float32)
            for amp in amps)
    want = jfft.forward_pair(jnp.asarray(a), jnp.asarray(b))
    got = tfft.forward_pair(torch.from_numpy(a), torch.from_numpy(b))
    for w, g, x in zip(want, got, (a, b)):
        w = np.asarray(w)
        assert g.shape == w.shape == (shape[0], shape[1] // 2 + 1)
        assert np.max(np.abs(w - g.numpy())) < 1e-6 * np.max(np.abs(w))
        r = np.fft.rfft2(x)
        assert np.max(np.abs(r - g.numpy())) < 1e-5 * np.max(np.abs(r))


@pytest.mark.parametrize("kw", [{}, dict(nx=4096, ny=4096),
                                dict(nx=2048, ny=1024, lx=1e6),
                                dict(gravity=3.7, mean_depth=250.0)])
def test_max_stable_dt_is_the_jax_bound(kw):
    cfg = ModelConfig(**kw)
    assert tsw.max_stable_dt(cfg) == jsw.max_stable_dt(cfg)


@pytest.fixture(scope="module")
def jax_segments():
    """The JAX SW model on both of its backends: a 20-step segment from
    the balanced gaussian vortex."""
    out = {}
    vort = makefields.gaussian(_cfg())
    for backend in ("pallas", "xla"):
        m = jsw.ShallowWaterModel.build(_cfg(fft_backend=backend))
        out[backend] = _np_state(
            m.segment(m.geostrophic_init(vort), m.zero_source(), STEPS))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """One forced plane step and one library step of the JAX SW model
    from a random state."""
    out = {}
    cfg = _cfg()
    jt = JT.from_config(cfg)
    s = _random_state(2)
    src = (1e-9 * np.random.default_rng(3).standard_normal(
        cfg.grid_shape)).astype(np.float32)
    js = jsw.SWState(*(jnp.asarray(z) for z in s))
    phys = (float(cfg.f), float(cfg.gravity), float(cfg.nu),
            float(cfg.mean_depth))
    out["state"], out["src"] = s, src
    out["planes_step"] = _np_state(jsw._planes_to_state(jsw.rk4_step_planes(
        jt, jsw._state_to_planes(js), psw.forward_planes(jnp.asarray(src)),
        float(cfg.dt), *phys, cfg.grid_shape)))
    out["lib_step"] = _np_state(jsw.rk4_step(
        jt, js, jnp.asarray(src), float(cfg.dt), *phys, cfg.grid_shape,
        fwd_pair=jfft.forward_pair))
    return out


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("jax_backend", ["pallas", "xla"])
def test_segment_matches_jax(jax_segments, backend, jax_backend):
    """20 steps of each port path against each JAX path, from the
    balanced vortex the runner starts from."""
    cfg = _cfg(fft_backend=backend)
    m = tsw.ShallowWaterModel.build(cfg, CPU)
    assert m.backend == backend
    got = m.segment(m.geostrophic_init(makefields.gaussian(cfg)),
                    m.zero_source(), STEPS)
    assert max(_phys_err(jax_segments[jax_backend], got,
                         cfg.grid_shape)) < 2e-4


def test_rk4_step_planes_matches_jax(jax_runs):
    """One forced step of the plane stepper (the forcing spectrum from
    ka + kc, the pairing equalizer from the start state) against JAX's
    rk4_step_planes in interpret mode."""
    cfg = _cfg()
    tt = TT.from_config(cfg, CPU)
    s = _t_state(jax_runs["state"])
    planes = tsw.state_to_planes(s)
    es = float(fs.eta_pair_scale(planes))
    got = tsw.planes_to_state(tsw.rk4_step_planes(
        tt, planes, fs.forward_planes(torch.from_numpy(jax_runs["src"])),
        float(cfg.dt), float(cfg.f), float(cfg.gravity), float(cfg.nu),
        float(cfg.mean_depth), es))
    assert max(_phys_err(jax_runs["planes_step"], got,
                         cfg.grid_shape)) < 1e-5


def test_library_rk4_step_matches_jax(jax_runs):
    cfg = _cfg()
    tt = TT.from_config(cfg, CPU)
    got = tsw.rk4_step(tt, _t_state(jax_runs["state"]),
                       torch.from_numpy(jax_runs["src"]), float(cfg.dt),
                       float(cfg.f), float(cfg.gravity), float(cfg.nu),
                       float(cfg.mean_depth), cfg.grid_shape, fwd_pair=True)
    assert max(_phys_err(jax_runs["lib_step"], got, cfg.grid_shape)) < 1e-5


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_forced_step_lands_and_matches_the_other_path(jax_runs, backend):
    """The model's step with a forcing field: it differs from the
    unforced step and agrees with the JAX plane step."""
    cfg = _cfg(fft_backend=backend)
    m = tsw.ShallowWaterModel.build(cfg, CPU)
    s = _t_state(jax_runs["state"])
    src = torch.from_numpy(jax_runs["src"])
    forced = m.step(s, src)
    assert max(_phys_err(jax_runs["planes_step"], forced,
                         cfg.grid_shape)) < 1e-5
    unforced = m.step(s, m.zero_source())
    assert not torch.equal(forced.zeta_hat, unforced.zeta_hat)
    assert torch.equal(m.step(s, None).zeta_hat, unforced.zeta_hat)


def test_library_split_and_unpaired_forms_agree():
    """The split-linear tendency and the unpaired forward transforms are
    reformulations: one step agrees with the default to 1e-5."""
    cfg = _cfg()
    tt = TT.from_config(cfg, CPU)
    s = _t_state(_random_state(4))
    src = torch.zeros(cfg.grid_shape)
    args = (tt, s, src, 1.0, float(cfg.f), float(cfg.gravity),
            float(cfg.nu), float(cfg.mean_depth), cfg.grid_shape)
    base = tsw.rk4_step(*args)
    for kw in (dict(split=True), dict(fwd_pair=True)):
        assert max(_phys_err(base, tsw.rk4_step(*args, **kw),
                             cfg.grid_shape)) < 1e-5, kw


@pytest.mark.parametrize("drag", [dict(r_drag=1e-5), dict(nu4=1e5),
                                  dict(r_drag=1e-5, nu4=1e5)])
def test_drag_and_hyperviscosity_on_the_library_path(drag):
    """r_drag and nu4 on the library path (fft_backend "xla") track the
    JAX library path; "auto" takes the per-transform kernels there
    (tests/test_torch_per_transform.py)."""
    cfg = _cfg(nx=64, ny=64, fft_backend="xla", **drag)
    vort = makefields.gaussian(cfg)
    jm = jsw.ShallowWaterModel.build(cfg)
    want = jm.segment(jm.geostrophic_init(vort), jm.zero_source(), 5)
    m = tsw.ShallowWaterModel.build(cfg, CPU)
    assert m.backend == "xla" and not m.per_transform
    got = m.segment(m.geostrophic_init(vort), m.zero_source(), 5)
    assert max(_phys_err(want, got, cfg.grid_shape)) < 1e-5
    plain = tsw.ShallowWaterModel.build(_cfg(nx=64, ny=64), CPU)
    undamped = plain.segment(plain.geostrophic_init(vort),
                             plain.zero_source(), 5)
    assert not torch.equal(undamped.zeta_hat, got.zeta_hat)


def test_builds_what_is_ported_and_refuses_the_rest():
    m = tsw.ShallowWaterModel.build(_cfg(nx=64, ny=64), CPU)
    assert m.backend == "pallas" and not m.fwd_pair
    assert "mean_mask" in dict(m.named_buffers())
    lib = tsw.ShallowWaterModel.build(_cfg(nx=96, ny=96), CPU)
    assert lib.backend == "xla" and lib.fwd_pair
    assert not tsw.ShallowWaterModel.build(
        _cfg(nx=2048, ny=2048, fft_backend="xla"), CPU).fwd_pair
    with pytest.raises(NotImplementedError, match="beta-plane"):
        tsw.ShallowWaterModel.build(_cfg(beta=1e-11), CPU)
    with pytest.raises(ValueError, match="time_scheme"):
        tsw.ShallowWaterModel.build(_cfg(time_scheme="rk3"), CPU)
    etd = tsw.ShallowWaterModel.build(_cfg(nx=64, ny=64,
                                           time_scheme="etdrk4"), CPU)
    assert etd.etd_tables.Q.shape == (3, 3, 64, 33)
    with pytest.warns(UserWarning, match="per-transform"):
        drag = tsw.ShallowWaterModel.build(_cfg(fft_backend="pallas",
                                                nu4=1e5), CPU)
    assert drag.backend == "pallas" and drag.per_transform
    with pytest.raises(ValueError):
        m.segment(tsw.SWState(*(torch.zeros((64, 33)),) * 3), None, 1)


def test_dt_above_the_bound_warns_with_the_jax_text():
    cfg = _cfg(nx=2048, ny=2048, dt=3.0)
    with pytest.warns(UserWarning) as want:
        jsw.ShallowWaterModel.build(cfg)
    with pytest.warns(UserWarning) as got:
        tsw.ShallowWaterModel.build(cfg, CPU)
    texts = [str(w.message) for w in got]
    assert any("SW gravity-wave CFL violated" in t for t in texts)
    assert [str(w.message) for w in want
            if "CFL" in str(w.message)] == [t for t in texts if "CFL" in t]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tsw.ShallowWaterModel.build(
            _cfg(nx=64, ny=64, dt=tsw.max_stable_dt(_cfg(nx=64, ny=64))),
            CPU)


def test_initial_states_diags_and_stats_match_jax():
    cfg = _cfg(nx=64, ny=96, lx=500_000.0)
    rng = np.random.default_rng(9)
    g = cfg.grid_shape
    vort = makefields.gaussian(cfg)
    div0 = (1e-6 * rng.standard_normal(g)).astype(np.float32)
    h0 = (cfg.mean_depth + rng.standard_normal(g)).astype(np.float32)
    jm = jsw.ShallowWaterModel.build(cfg)
    tm = tsw.ShallowWaterModel.build(cfg, CPU)
    for want, got in ((jm.geostrophic_init(vort), tm.geostrophic_init(vort)),
                      (jm.init_state(vort, div0, h0),
                       tm.init_state(vort, div0, h0)),
                      (jm.init_state(vort), tm.init_state(vort))):
        for w, x in zip(_np_state(want), _np_state(got)):
            scale = max(np.max(np.abs(w)), 1e-30)
            assert np.max(np.abs(w - x)) <= 1e-6 * scale
    assert float(tm.geostrophic_init(vort).eta_hat[0, 0].abs()) == 0.0
    js = jm.segment(jm.init_state(vort, div0, h0), jm.zero_source(), 3)
    ts = _t_state(_np_state(js))
    jd, td = jm.diags(js), tm.diags(ts)
    assert td._fields == jd._fields
    for name in jd._fields:
        a, b = np.asarray(getattr(jd, name)), getattr(td, name).numpy()
        assert np.max(np.abs(a - b)) <= 1e-6 * np.max(np.abs(a)), name
    jst, tst = jm.stats(js), tm.stats(ts)
    assert tst._fields == jst._fields
    for name in jst._fields:
        a, b = float(getattr(jst, name)), float(getattr(tst, name))
        assert abs(a - b) <= 1e-5 * abs(a), name


def test_debug_fields_match_jax():
    """The step-start zeta gradients within 1e-6 of max |JAX|; the full
    vorticity tendency within 1e-4: the library tendency pairs zeta
    (1e-4) with eta (0.1 m here) in one inverse transform without the
    plane stepper's equalizer, as the JAX package does, so each package's
    zeta carries its own FFT's cross-talk of about eps * max |eta|."""
    cfg = _cfg(nx=64, ny=96, lx=500_000.0)
    rng = np.random.default_rng(10)
    vort = (1e-4 * rng.standard_normal(cfg.grid_shape)).astype(np.float32)
    src = (1e-9 * rng.standard_normal(cfg.grid_shape)).astype(np.float32)
    jm = jsw.ShallowWaterModel.build(cfg)
    tm = tsw.ShallowWaterModel.build(cfg, CPU)
    js = jm.segment(jm.geostrophic_init(vort), jm.zero_source(), 3)
    want = jm.debug(js, jnp.asarray(src))
    got = tm.debug(_t_state(_np_state(js)), torch.from_numpy(src))
    assert got._fields == want._fields
    for name, bar in zip(want._fields, (1e-6, 1e-6, 1e-4)):
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert np.max(np.abs(a - b)) <= bar * np.max(np.abs(a)), name


def test_step_equals_one_step_segment():
    cfg = _cfg(nx=64, ny=64)
    m = tsw.ShallowWaterModel.build(cfg, CPU)
    s0 = m.geostrophic_init(makefields.gaussian(cfg))
    src = m.zero_source()
    a, b = m.step(s0, src), m.segment(s0, src, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_convert_sw_state_round_trip():
    cfg = _cfg(nx=64, ny=64)
    jm = jsw.ShallowWaterModel.build(cfg)
    js = jm.geostrophic_init(makefields.gaussian(cfg))
    packed = np.stack([np.asarray(z) for z in js])
    st = convert.sw_state_from_numpy(packed, CPU)
    assert isinstance(st, tsw.SWState)
    assert all(z.dtype == torch.complex64 for z in st)
    np.testing.assert_array_equal(convert.sw_state_to_numpy(st), packed)
    with pytest.raises(ValueError):
        convert.sw_state_from_numpy(packed[:2], CPU)
    with pytest.raises(ValueError):
        convert.sw_state_from_numpy(packed.astype(np.complex128), CPU)
