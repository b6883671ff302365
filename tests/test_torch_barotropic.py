"""The port's barotropic model (xlab_fftbarotropic_torch.models) against
the JAX package and the numpy oracle, on the CPU.

The port runs on CPU tensors here, so its "pallas" backend is the plane
stepper through the kernels' plain torch versions. The JAX pallas plane
stepper runs in interpret mode, as the JAX package's own tests run it.

Bars: max |a - b| < 1e-6 * max(1, max |a|) on the physical vorticity for
trajectories against JAX (tests/test_pallas_fft.py:82); max-norm relative
error < 1e-6 against the numpy oracle (tests/test_model_parity.py:144).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.models import barotropic as jbt
from xlab_fftbarotropic_tpu.oracle.reference_cpu import OracleBarotropic
from xlab_fftbarotropic_torch import convert
from xlab_fftbarotropic_torch.models import barotropic as tbt
from torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")


def _vort(z, cfg):
    return np.fft.irfft2(np.asarray(z), s=cfg.grid_shape)


def _close(a, b, bar=1e-6):
    err = np.max(np.abs(a - b))
    assert err < bar * max(1.0, np.max(np.abs(a))), err


def _port_segment(cfg, v0, n, src=None):
    m = tbt.BarotropicModel.build(cfg, CPU)
    s = m.zero_source() if src is None else torch.from_numpy(src)
    return m, m.segment(m.init_state(v0), s, n).numpy()


def _jax_segment(cfg, v0, n, src=None):
    m = jbt.BarotropicModel.build(cfg)
    s = m.zero_source() if src is None else jnp.asarray(src)
    return np.asarray(m.segment(m.init_state(v0), s, n))


@pytest.fixture(scope="module")
def kuo128():
    cfg = ModelConfig(nx=128, ny=128)
    v0 = makefields.kuo2004(cfg)
    return cfg, v0, {
        "pallas": _jax_segment(cfg.replace(fft_backend="pallas"), v0, 20),
        "xla": _jax_segment(cfg.replace(fft_backend="xla"), v0, 20)}


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("jax_backend", ["pallas", "xla"])
def test_kuo2004_20_steps_match_jax(kuo128, backend, jax_backend):
    """20 RK4 steps at 128^2: each port path against the JAX plane
    stepper as it ships and against the JAX XLA core."""
    cfg, v0, ref = kuo128
    m, z = _port_segment(cfg.replace(fft_backend=backend), v0, 20)
    assert m.backend == backend
    _close(_vort(ref[jax_backend], cfg), _vort(z, cfg))


def test_auto_picks_plane_stepper_for_square_powers_of_two():
    assert tbt.resolve_fft_backend_name("auto", (128, 128)) == "pallas"
    assert tbt.resolve_fft_backend_name("auto", (8192, 8192)) == "pallas"
    for g in ((96, 96), (128, 64), (32, 32), (16384, 16384)):
        assert tbt.resolve_fft_backend_name("auto", g) == "xla"
    with pytest.raises(ValueError):
        tbt.resolve_fft_backend_name("pallas", (96, 96))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbt.resolve_fft_backend_name("mxu", (128, 128))
    with pytest.raises(ValueError, match="time_scheme"):
        tbt.BarotropicModel.build(ModelConfig(nx=64, ny=64,
                                              time_scheme="rk3"), CPU)
    etd = tbt.BarotropicModel.build(ModelConfig(nx=64, ny=64,
                                                time_scheme="etdrk4"), CPU)
    assert etd.backend == "pallas" and etd.etd_tables.E.shape == (64, 33)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_matches_numpy_oracle(backend):
    """64^2 kuo2004, 20 steps, against the statement-level numpy
    transcription of the reference (the bar of the JAX package's
    paired-FFT regression)."""
    cfg = ModelConfig(nx=64, ny=64, fft_backend=backend)
    v0 = makefields.kuo2004(cfg)
    m, z = _port_segment(cfg, v0, 20)
    mine = m.diags(torch.from_numpy(z)).vort.numpy()
    want = OracleBarotropic(cfg).run(v0, 20)
    rel = np.abs(mine - want).max() / np.abs(want).max()
    assert rel < 1e-6, rel


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("extra", [dict(r_drag=2e-3), dict(beta=1e-8),
                                   dict(nu4=2e13),
                                   dict(r_drag=2e-3, beta=1e-8, nu4=2e13)])
def test_drag_beta_nu4_match_jax(backend, extra):
    """Non-zero drag, beta and hyperviscosity (folded into the stepping
    lap on the plane stepper) with a forcing field, 5 steps at 64^2."""
    cfg = ModelConfig(nx=64, ny=64, fft_backend=backend, **extra)
    v0 = makefields.gaussian(cfg)
    rng = np.random.default_rng(5)
    src = (1e-8 * rng.standard_normal(cfg.grid_shape)).astype(np.float32)
    want = _jax_segment(cfg, v0, 5, src)
    _, got = _port_segment(cfg, v0, 5, src)
    _close(_vort(want, cfg), _vort(got, cfg))


def test_step_equals_one_step_segment():
    cfg = ModelConfig(nx=64, ny=64)
    m = tbt.BarotropicModel.build(cfg, CPU)
    z = m.init_state(makefields.gaussian(cfg))
    src = m.zero_source()
    assert torch.equal(m.step(z, src), m.segment(z, src, 1))


def test_diags_and_stats_match_jax():
    cfg = ModelConfig(nx=64, ny=64, beta=1e-8)
    v0 = makefields.kuo2004(cfg)
    jm = jbt.BarotropicModel.build(cfg)
    tm = tbt.BarotropicModel.build(cfg, CPU)
    jz = jm.segment(jm.init_state(v0), jm.zero_source(), 3)
    tz = torch.from_numpy(np.array(jz))
    jd, td = jm.diags(jz), tm.diags(tz)
    for name in jd._fields:
        a, b = np.asarray(getattr(jd, name)), getattr(td, name).numpy()
        assert np.max(np.abs(a - b)) < 2e-6 * np.max(np.abs(a)), name
    rng = np.random.default_rng(3)
    src = (1e-8 * rng.standard_normal(cfg.grid_shape)).astype(np.float32)
    jg = jm.debug(jz, jnp.asarray(src))
    tg = tm.debug(tz, torch.from_numpy(src))
    for name in jg._fields:
        a, b = np.asarray(getattr(jg, name)), getattr(tg, name).numpy()
        assert np.max(np.abs(a - b)) < 2e-6 * np.max(np.abs(a)), name
    js, ts = jm.stats(jz), tm.stats(tz)
    for name in js._fields:
        a, b = float(getattr(js, name)), float(getattr(ts, name))
        assert abs(a - b) <= 1e-5 * abs(a), name


def test_convert_round_trip():
    """JAX tables and state cross to the port and back bit for bit, and a
    model built on the converted tables steps exactly like one built on
    its own."""
    from xlab_fftbarotropic_tpu.ops.spectral import SpectralTables

    cfg = ModelConfig(nx=64, ny=64)
    jt = SpectralTables.from_config(cfg)
    d = {n: np.asarray(getattr(jt, n)) for n in
         ("kx", "ky", "lap", "inv_lap", "mask", "rlap")}
    tt = convert.tables_from_numpy(d, CPU)
    back = convert.tables_to_numpy(tt)
    for n, a in d.items():
        np.testing.assert_array_equal(a, back[n])

    jm = jbt.BarotropicModel.build(cfg)
    z = np.asarray(jm.init_state(makefields.gaussian(cfg)))
    zr, zi = convert.state_from_numpy(z, CPU)
    assert zr.dtype == torch.float32 and zr.shape == cfg.spectral_shape
    np.testing.assert_array_equal(convert.state_to_numpy(zr, zi), z)

    m1 = tbt.BarotropicModel.build(cfg, CPU, tables=tt)
    m2 = tbt.BarotropicModel.build(cfg, CPU)
    zc = torch.complex(zr, zi)
    assert torch.equal(m1.segment(zc, m1.zero_source(), 2),
                       m2.segment(zc, m2.zero_source(), 2))
    with pytest.raises(ValueError):
        convert.state_from_numpy(z.astype(np.complex128), CPU)


@pytest.mark.parametrize("jax_fused_rk", ["1", "0"])
@pytest.mark.parametrize("fused_rk", [True, False])
def test_fused_rk_forms_match_jax(monkeypatch, jax_fused_rk, fused_rk):
    """The port's two plane-stepper forms against the JAX plane stepper
    with XFB_BT_FUSED_RK set to 1 (its default: kx_visc axpy epilogue +
    plane_rk4_combine) and to 0 (elementwise stage updates and tail),
    with drag, beta, hyperviscosity and forcing, 5 steps at 64^2."""
    monkeypatch.setenv("XFB_BT_FUSED_RK", jax_fused_rk)
    cfg = ModelConfig(nx=64, ny=64, fft_backend="pallas", r_drag=2e-3,
                      beta=1e-8, nu4=2e13)
    v0 = makefields.kuo2004(cfg)
    rng = np.random.default_rng(8)
    src = (1e-8 * rng.standard_normal(cfg.grid_shape)).astype(np.float32)
    want = _jax_segment(cfg, v0, 5, src)
    m = tbt.BarotropicModel.build(cfg, CPU, fused_rk=fused_rk)
    got = m.segment(m.init_state(v0), torch.from_numpy(src), 5).numpy()
    _close(_vort(want, cfg), _vort(got, cfg))


@pytest.mark.parametrize("extra", [{}, dict(r_drag=2e-3, beta=1e-8,
                                            nu4=2e13)])
def test_fused_rk_is_bit_identical_to_unfused_on_cpu(extra):
    """On the CPU the plain versions round the fused axpy and combine
    exactly as the elementwise form does: 10 steps agree bit for bit."""
    cfg = ModelConfig(nx=64, ny=64, **extra)
    v0 = makefields.gaussian(cfg)
    rng = np.random.default_rng(9)
    src = torch.from_numpy(
        (1e-8 * rng.standard_normal(cfg.grid_shape)).astype(np.float32))
    fused = tbt.BarotropicModel.build(cfg, CPU)
    unfused = tbt.BarotropicModel.build(cfg, CPU, fused_rk=False)
    assert fused.fused_rk and not unfused.fused_rk
    z = fused.init_state(v0)
    assert torch.equal(fused.segment(z, src, 10), unfused.segment(z, src, 10))
