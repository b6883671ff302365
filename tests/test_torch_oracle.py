"""The port's CPU oracle (xlab_fftbarotropic_torch/oracle/reference_cpu.py,
numpy only, on the port's own tables and ModelConfig) against the JAX
package's (xlab_fftbarotropic_tpu/oracle/reference_cpu.py), bit for bit:
OracleBarotropic.run over 5 steps at 32^2 and 64^2 under both dealias
rules (and a forced run), with every field its record callback gets, the
tables, one tendency and one RK4 step, and oracle_invert_pressure. The
port's oracle against the independent C++ oracle is a case of
tests/test_torch_c_oracle.py."""

import numpy as np
import pytest

from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig
from xlab_fftbarotropic_tpu.oracle import reference_cpu as joracle
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.ic import makefields
from xlab_fftbarotropic_torch.oracle import reference_cpu as oracle

STEPS = 5
FIELDS = ("vort", "psi", "u", "v", "vort_src")


def _cfgs(n, rule, **kw):
    kw = dict(nx=n, ny=n, dealias_rule=rule, record_step=2, **kw)
    return ModelConfig(**kw), JConfig(**kw)


def _run(cls, cfg, v0, src=None):
    records = {}
    o = cls(cfg)
    if src is not None:
        o.vort_src = src
    out = o.run(v0, STEPS, record=lambda s, f: records.update({s: f}))
    return out, records


def _equal(a, b) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b), float(np.abs(a - b).max())


@pytest.mark.parametrize("forced", [False, True], ids=["free", "forced"])
@pytest.mark.parametrize("rule", ["circular", "twothirds"])
@pytest.mark.parametrize("n", [32, 64])
def test_run_is_the_jax_oracles_bit_for_bit(n, rule, forced):
    cfg, jcfg = _cfgs(n, rule)
    v0 = makefields.kuo2004(cfg)
    src = None
    if forced:
        rng = np.random.default_rng(3)
        src = (1e-9 * rng.standard_normal(cfg.grid_shape)).astype(np.float32)
    got, got_rec = _run(oracle.OracleBarotropic, cfg, v0, src)
    want, want_rec = _run(joracle.OracleBarotropic, jcfg, v0, src)
    _equal(got, want)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert sorted(got_rec) == sorted(want_rec) == [0, 2, 4]
    for step in want_rec:
        assert sorted(got_rec[step]) == sorted(FIELDS)
        for name in FIELDS:
            _equal(got_rec[step][name], want_rec[step][name])


@pytest.mark.parametrize("rule", ["circular", "twothirds"])
def test_tables_rhs_and_step_are_the_jax_oracles(rule):
    cfg, jcfg = _cfgs(64, rule, nu=6.5)
    t = oracle.OracleTables(cfg.nx, cfg.ny, cfg.lx, cfg.ly, rule)
    jt = joracle.OracleTables(cfg.nx, cfg.ny, cfg.lx, cfg.ly, rule)
    for name in ("kx", "ky", "lap", "inv_lap", "mask"):
        _equal(getattr(t, name), getattr(jt, name))
    z = np.fft.rfft2(makefields.gaussian(cfg)).astype(np.complex64)
    for a, b in zip(oracle.OracleBarotropic(cfg).rhs(z),
                    joracle.OracleBarotropic(jcfg).rhs(z)):
        _equal(a, b)
    _equal(oracle.OracleBarotropic(cfg).rk4_step(z),
           joracle.OracleBarotropic(jcfg).rk4_step(z))


@pytest.mark.parametrize("n,ref", [(32, (0, 0)), (64, (5, 11))])
def test_invert_pressure_is_the_jax_oracles(n, ref):
    cfg, jcfg = _cfgs(n, "circular")
    _, rec = _run(oracle.OracleBarotropic, cfg, makefields.kuo2004(cfg))
    psi = rec[4]["psi"]
    got = oracle.oracle_invert_pressure(cfg, psi, *ref)
    want = joracle.oracle_invert_pressure(jcfg, psi, *ref)
    _equal(got, want)
    assert got.ravel()[ref[0] + n * ref[1]] == 0.0
    assert np.abs(got).max() > 0
