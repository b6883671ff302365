"""The port's tracer family (xlab_fftbarotropic_torch.models.tracer)
against the JAX package's, on the CPU.

The port runs on CPU tensors here, so its "pallas" backend is the plane
stepper through the kernels' plain torch versions; the JAX pallas plane
stepper runs in interpret mode, as the JAX package's own tests run it.

Bars: rel-L2 <= 2e-6 per spectral field (zeta_hat, q_hat) after 3 steps
at 128^2, the JAX package's own tracer bar (tests/test_pallas_tracer.py:
79-80); diagnostics to 2e-6 of max |JAX| and stats to 1e-5 relative;
tracer_ic and the state conversion bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.models import tracer as jtr
from xlab_fftbarotropic_torch import convert
from xlab_fftbarotropic_torch.models import tracer as ttr
from torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")
N = 128
STEPS = 3
CASES = {
    "kappa0": dict(kappa=0.0, cfg={}),
    "kappa50": dict(kappa=50.0, cfg={}),
    "forced": dict(kappa=10.0, cfg=dict(r_drag=1e-5, beta=1e-11, nu4=1e5)),
}


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    return np.linalg.norm(want - got) / np.linalg.norm(want)


def _inputs(case):
    """Random 1e-4 vorticity (the JAX package's tracer-test recipe), the
    gaussian tracer, and a forcing field for the forced case."""
    cfg = ModelConfig(nx=N, ny=N, **CASES[case]["cfg"])
    rng = np.random.default_rng(len(case))
    vort = (1e-4 * rng.standard_normal(cfg.grid_shape)).astype(np.float32)
    q = jtr.tracer_ic(cfg, "gaussian")
    src = np.zeros(cfg.grid_shape, np.float32)
    if case == "forced":
        src = (1e-9 * rng.standard_normal(cfg.grid_shape)).astype(np.float32)
    return cfg, vort, q, src


@pytest.fixture(scope="module")
def jax_runs():
    """Each case through the JAX TracerModel on both of its backends."""
    out = {}
    for case in CASES:
        cfg, vort, q, src = _inputs(case)
        for backend in ("pallas", "xla"):
            m = jtr.TracerModel.build(cfg.replace(fft_backend=backend),
                                      kappa=CASES[case]["kappa"])
            s = m.segment(m.init_state(vort, q), jnp.asarray(src), STEPS)
            out[case, backend] = tuple(np.asarray(z) for z in s)
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("jax_backend", ["pallas", "xla"])
def test_tracer_model_matches_jax(jax_runs, case, backend, jax_backend):
    cfg, vort, q, src = _inputs(case)
    m = ttr.TracerModel.build(cfg.replace(fft_backend=backend), CPU,
                              kappa=CASES[case]["kappa"])
    assert m.backend == backend
    s = m.segment(m.init_state(vort, q), torch.from_numpy(src), STEPS)
    for want, got in zip(jax_runs[case, jax_backend], s):
        assert _rel(want, got.numpy()) < 2e-6


@pytest.mark.parametrize("kind", ["vorticity", "zonal", "meridional",
                                  "gaussian"])
def test_tracer_ic_is_bit_identical(kind):
    cfg = ModelConfig(nx=64, ny=96, lx=500_000.0)
    vort0 = np.random.default_rng(1).standard_normal(cfg.grid_shape)
    want = jtr.tracer_ic(cfg, kind, vort0)
    got = ttr.tracer_ic(cfg, kind, vort0)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(want, got)
    with pytest.raises(ValueError):
        ttr.tracer_ic(cfg, "ramp")


def test_diags_and_stats_match_jax():
    """Records and stats of a stepped state; q_var is the population
    variance, as jnp.var."""
    cfg, vort, q, src = _inputs("forced")
    jm = jtr.TracerModel.build(cfg.replace(fft_backend="xla"), kappa=10.0)
    tm = ttr.TracerModel.build(cfg, CPU, kappa=10.0)
    js = jm.segment(jm.init_state(vort, q), jnp.asarray(src), 2)
    ts = ttr.TracerState(*(torch.from_numpy(np.array(z)) for z in js))
    jd, td = jm.diags(js), tm.diags(ts)
    assert td._fields == jd._fields
    for name in jd._fields:
        a, b = np.asarray(getattr(jd, name)), getattr(td, name).numpy()
        assert np.max(np.abs(a - b)) < 2e-6 * np.max(np.abs(a)), name
    jst, tst = jm.stats(js), tm.stats(ts)
    assert tst._fields == jst._fields
    for name in jst._fields:
        a, b = float(getattr(jst, name)), float(getattr(tst, name))
        assert abs(a - b) <= 1e-5 * abs(a), name
    qp = td.q.double()
    assert abs(float(tst.q_var) - float(qp.var(correction=0))) \
        < 1e-6 * float(tst.q_var)


def test_step_equals_one_step_segment_and_kappa_decays_variance():
    cfg, vort, q, _ = _inputs("kappa50")
    cfg = cfg.replace(nx=64, ny=64)
    m = ttr.TracerModel.build(cfg, CPU, kappa=5e4)
    s0 = m.init_state(vort[:64, :64], q[::2, ::2])
    src = m.zero_source()
    a, b = m.step(s0, src), m.segment(s0, src, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    s = m.segment(s0, src, 10)
    assert float(m.stats(s).q_var) < float(m.stats(s0).q_var)
    assert abs(float(m.stats(s).q_mean) - float(m.stats(s0).q_mean)) \
        < 1e-6 * abs(float(m.stats(s0).q_mean))


def test_builds_what_is_ported_and_refuses_the_rest():
    m = ttr.TracerModel.build(ModelConfig(nx=64, ny=64), CPU, kappa=3.0)
    assert m.backend == "pallas"
    assert m.lap2.shape == (2, 64, 33)
    assert "lap2" in dict(m.named_buffers())
    assert ttr.TracerModel.build(ModelConfig(nx=96, ny=96), CPU).backend \
        == "xla"
    with pytest.raises(ValueError, match="time_scheme"):
        ttr.TracerModel.build(ModelConfig(nx=64, ny=64,
                                          time_scheme="rk3"), CPU)
    etd = ttr.TracerModel.build(ModelConfig(nx=64, ny=64,
                                            time_scheme="etdrk4"), CPU)
    assert etd.etd_tables.F3.shape == (2, 64, 33)
    with pytest.raises(ValueError):
        m.segment(ttr.TracerState(*(torch.zeros((64, 33)),) * 2),
                  m.zero_source(), 1)


def test_stacked_table_is_the_jax_fold():
    """lap2 = [nu*lap - r_drag - nu4*lap^2 | kappa*lap], bit for bit the
    table the JAX plane path builds."""
    from xlab_fftbarotropic_tpu.ops.spectral import SpectralTables

    cfg, *_ = _inputs("forced")
    t = SpectralTables.from_config(cfg)
    want = jnp.stack([t.lap * float(cfg.nu) - float(cfg.r_drag)
                      - float(cfg.nu4) * t.lap * t.lap, t.lap * 10.0])
    m = ttr.TracerModel.build(cfg, CPU, kappa=10.0)
    np.testing.assert_array_equal(np.asarray(want), m.lap2.numpy())


def test_convert_tracer_state_round_trip():
    cfg, vort, q, _ = _inputs("kappa0")
    jm = jtr.TracerModel.build(cfg.replace(fft_backend="xla"))
    js = jm.init_state(vort, q)
    packed = np.stack([np.asarray(z) for z in js])
    st = convert.tracer_state_from_numpy(packed, CPU)
    assert isinstance(st, ttr.TracerState)
    assert st.q_hat.dtype == torch.complex64
    np.testing.assert_array_equal(convert.tracer_state_to_numpy(st), packed)
    with pytest.raises(ValueError):
        convert.tracer_state_from_numpy(packed[0], CPU)
