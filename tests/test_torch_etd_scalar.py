"""The port's scalar-family ETDRK4 (barotropic and tracer,
xlab_fftbarotropic_torch/models/etdrk4.py) against the JAX package, on
the CPU.

- Tables: the port's torch build against the JAX host build, real
  and complex (beta), barotropic and stacked tracer: max |d| <= 1e-6 of
  each table's max (measured: bit-identical at 64^2).
- Cache: the key equals the JAX package's, including its pinned bench
  key; a stack cached by either package loads in the other.
- Trajectories: 5 steps of the port's plane path (the barotropic and
  tracer kernels' plain versions, nu = 0) and library path against the
  JAX xla-path ETDRK4, at the port's RK4 bars: rel-L2 < 1e-6 barotropic,
  2e-6 tracer (measured <= 1.8e-7 and 4.3e-8).
- Exactness the scheme promises: a single decaying mode, a Rossby mode
  under beta, modes outside the mask frozen; the advective-CFL guard.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.models import barotropic as jbt
from xlab_fftbarotropic_tpu.models import etdrk4 as jetd
from xlab_fftbarotropic_tpu.models import tracer as jtr
from xlab_fftbarotropic_torch.models import barotropic as tbt
from xlab_fftbarotropic_torch.models import etdrk4 as tetd
from xlab_fftbarotropic_torch.models import tracer as ttr
from xlab_fftbarotropic_torch.ops import spectral as tsp
from xlab_fftbarotropic_torch.utils import guards as tguards
from torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")
N = 64
CFG = ModelConfig(nx=N, ny=N, time_scheme="etdrk4")


def example12_nu4(n: int) -> float:
    """The hyperviscosity of examples/12-hyperviscous-etd/example.sh:
    RK4's viscous bound at 1 s for the modes the mask keeps, so dt = 3 s
    is three times past it."""
    kc = math.ceil(n / 3.0)
    k2cut = (2.0 * math.pi / CFG.lx) ** 2 * 2.0 * kc * kc
    return 2.785 / k2cut ** 2


NU4 = example12_nu4(N)
TABLE_CASES = [("barotropic", {"nu4": NU4}),
               ("barotropic", {"beta": 1.6e-11, "r_drag": 1e-5}),
               ("tracer", {}), ("tracer", {"beta": 1.6e-11, "nu4": NU4})]
KAPPA = 50.0


def _rel_l2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(a)


@pytest.mark.parametrize("kind,extra", TABLE_CASES)
def test_scalar_tables_match_the_jax_host_build(kind, extra):
    cfg = CFG.replace(**extra)
    want = jetd._build_scalar_tables_host(cfg, 3.0, kind, KAPPA)
    got = tetd.build_scalar_tables_stack(cfg, 3.0, kind, KAPPA).numpy()
    assert got.dtype == want.dtype
    assert got.dtype == (np.complex64 if "beta" in extra else np.float32)
    assert got.shape == want.shape
    for name, w, g in zip(tetd._TABLE_NAMES, want, got):
        assert np.max(np.abs(w - g)) <= 1e-6 * np.max(np.abs(w)), name


@pytest.mark.parametrize("kind", ["sw", "barotropic", "tracer"])
@pytest.mark.parametrize("hpad", [0, 40])
def test_cache_key_equals_the_jax_key(kind, hpad):
    cfg = CFG.replace(nu4=NU4, beta=1e-11, output_dir="elsewhere")
    assert tetd.tables_cache_key(cfg, 7.5, hpad, kind, KAPPA) == \
        jetd.tables_cache_key(cfg, 7.5, hpad, kind, KAPPA)


def test_bench_cache_key_is_pinned():
    """The key of bench.py's sw-etdrk4 configuration, pinned by the JAX
    package (tests/test_etd_scalar.py:396)."""
    from xlab_fftbarotropic_torch.config import ModelConfig as PortConfig
    cfg = PortConfig(nx=4096, ny=4096, dt=7.5, time_scheme="etdrk4")
    assert tetd.tables_cache_key(cfg, 7.5, kind="sw") == "78d5353e25b4bfb7"


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kind", ["barotropic", "tracer"])
def test_scalar_cache_file_is_shared(tmp_path, monkeypatch, writer, kind):
    monkeypatch.setenv("XFB_ETD_CACHE", str(tmp_path))
    cfg = CFG.replace(beta=1.6e-11)

    def boom(*args, **kwargs):
        raise AssertionError("cache miss: the tables were built again")

    if writer == "jax":
        want = [np.asarray(a) for a in
                jetd.build_scalar_tables(cfg, 3.0, kind, KAPPA)]
        monkeypatch.setattr(tetd, "build_scalar_tables_stack", boom)
        got = [a.numpy() for a in
               tetd.build_scalar_tables(cfg, 3.0, kind, KAPPA)]
    else:
        want = [a.numpy() for a in
                tetd.build_scalar_tables(cfg, 3.0, kind, KAPPA)]
        monkeypatch.setattr(jetd, "_build_scalar_tables_host", boom)
        got = [np.asarray(a) for a in
               jetd.build_scalar_tables(cfg, 3.0, kind, KAPPA)]
    assert len(list(tmp_path.glob(f"{kind}_etd_*.npy"))) == 1
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_cache_disabled_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv("XFB_ETD_CACHE", "0")
    tbt.BarotropicModel.build(CFG.replace(output_dir=str(tmp_path)), CPU)
    assert list(tmp_path.iterdir()) == []


# ----------------------------------------------------------- trajectories

@pytest.fixture(scope="module")
def jax_runs():
    """5 steps of the JAX xla-path ETDRK4 at 64^2 for each case."""
    out = {}
    for kind, extra in TABLE_CASES:
        cfg = CFG.replace(**extra)
        v0 = jnp.asarray(makefields.gaussian(cfg))
        if kind == "barotropic":
            m = jbt.BarotropicModel.build(cfg.replace(fft_backend="xla"))
            out[kind, str(extra)] = [np.asarray(
                m.segment(m.init_state(v0), m.zero_source(), 5))]
        else:
            m = jtr.TracerModel.build(cfg.replace(fft_backend="xla"),
                                      kappa=KAPPA)
            q0 = jnp.asarray(jtr.tracer_ic(cfg, "gaussian"))
            s0 = jtr.TracerState(jnp.fft.rfft2(v0), jnp.fft.rfft2(q0))
            out[kind, str(extra)] = [np.asarray(x) for x in m.segment(
                s0, jnp.zeros(cfg.grid_shape, jnp.float32), 5)]
    return out


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("kind,extra", TABLE_CASES)
def test_trajectory_matches_jax(jax_runs, kind, extra, backend):
    cfg = CFG.replace(fft_backend=backend, **extra)
    v0 = makefields.gaussian(cfg)
    if kind == "barotropic":
        m = tbt.BarotropicModel.build(cfg, CPU)
        got = [m.segment(m.init_state(v0), m.zero_source(), 5)]
        bar = 1e-6
    else:
        m = ttr.TracerModel.build(cfg, CPU, kappa=KAPPA)
        s0 = m.init_state(v0, ttr.tracer_ic(cfg, "gaussian"))
        got = list(m.segment(s0, m.zero_source(), 5))
        bar = 2e-6
    assert m.backend == backend
    for w, g in zip(jax_runs[kind, str(extra)], got):
        assert _rel_l2(np.fft.irfft2(w), np.fft.irfft2(g.numpy())) < bar


def test_no_drag_fold_under_etd():
    """The RK4 plane stepper folds drag and nu4 into its lap; ETDRK4 keeps
    the original lap (the tables carry them)."""
    cfg = CFG.replace(r_drag=1e-5, nu4=NU4)
    m = tbt.BarotropicModel.build(cfg, CPU)
    assert torch.equal(m.step_tables.lap, m.tables.lap)
    rk = tbt.BarotropicModel.build(cfg.replace(time_scheme="rk4"), CPU)
    assert not torch.equal(rk.step_tables.lap, rk.tables.lap)


# ------------------------------------------------- what the scheme promises

@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_single_mode_decay_is_exact(backend):
    """exp((nu lap - r - nu4 lap^2) t) at a dt far past RK4's viscous
    bound (tests/test_etd_scalar.py:122-141)."""
    cfg = CFG.replace(nu=200.0, r_drag=1e-5, nu4=1e13, dt=600.0,
                      fft_backend=backend)
    m = tbt.BarotropicModel.build(cfg, CPU)
    x, y = cfg.coords()
    X, Y = np.asarray(x)[:, None], np.asarray(y)[None, :]
    v0 = (1e-9 * np.cos(2 * np.pi * (3 * X / cfg.lx + 2 * Y / cfg.ly))
          ).astype(np.float32)
    s0 = m.init_state(v0)
    out = m.segment(s0, m.zero_source(), 8)
    kx = tsp.wavenumbers_x(N, cfg.lx)
    ky = tsp.wavenumbers_y(N, cfg.ly)
    lap = -(kx[3] ** 2 + ky[2] ** 2)
    lam = cfg.nu * lap - cfg.r_drag - cfg.nu4 * lap * lap
    want = complex(s0[3, 2]) * np.exp(lam * 8 * cfg.dt)
    assert abs(complex(out[3, 2]) - want) < 1e-5 * abs(want)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_rossby_mode_under_beta_is_exact(backend):
    cfg = CFG.replace(beta=1e-9, nu=200.0, dt=500.0, fft_backend=backend)
    m = tbt.BarotropicModel.build(cfg, CPU)
    assert m.etd_tables.E.is_complex()
    x, y = cfg.coords()
    X, Y = np.asarray(x)[:, None], np.asarray(y)[None, :]
    v0 = (1e-9 * np.cos(2 * np.pi * (2 * X / cfg.lx + Y / cfg.ly))
          ).astype(np.float32)
    s0 = m.init_state(v0)
    out = m.segment(s0, m.zero_source(), 10)
    kx = tsp.wavenumbers_x(N, cfg.lx)
    ky = tsp.wavenumbers_y(N, cfg.ly)
    lap = -(kx[2] ** 2 + ky[1] ** 2)
    lam = cfg.nu * lap - 1j * cfg.beta * kx[2] / lap
    want = complex(s0[2, 1]) * np.exp(lam * 10 * cfg.dt)
    assert abs(complex(out[2, 1]) - want) < 1e-5 * abs(want)


@pytest.mark.parametrize("family", ["barotropic", "tracer"])
def test_above_mask_modes_frozen(family):
    cfg = CFG
    v0 = makefields.gaussian(cfg)
    if family == "barotropic":
        m = tbt.BarotropicModel.build(cfg, CPU)
        z = m.init_state(v0)
        z[30, 30] = 7.0 + 3.0j
        out = [m.segment(z, m.zero_source(), 10)]
    else:
        m = ttr.TracerModel.build(cfg, CPU, kappa=KAPPA)
        s = m.init_state(v0, ttr.tracer_ic(cfg, "gaussian"))
        for z in s:
            z[30, 30] = 7.0 + 3.0j
        out = list(m.segment(s, m.zero_source(), 10))
    assert float(m.tables.mask[30, 30]) == 0.0
    for z in out:
        assert complex(z[30, 30]) == 7.0 + 3.0j


def test_smul_planes_is_the_complex_product():
    rng = np.random.default_rng(3)
    shape = (2, N, N // 2 + 1)
    T = torch.complex(*(torch.from_numpy(rng.standard_normal(shape)
                                         .astype(np.float32))
                        for _ in range(2)))
    pr, pi = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              for _ in range(2))
    gr, gi = tetd.smul_planes(T, pr, pi)
    want = T * torch.complex(pr, pi)
    torch.testing.assert_close(torch.complex(gr, gi), want, rtol=1e-6,
                               atol=1e-6)
    gr, gi = tetd.smul_planes(T.real.contiguous(), pr, pi)
    assert torch.equal(gr, T.real * pr) and torch.equal(gi, T.real * pi)


# ------------------------------------------------------- the CFL guard

def test_max_advective_dt_matches_jax():
    for u in (0.5, 10.0, 80.0):
        assert tetd.max_advective_dt(CFG, u) == jetd.max_advective_dt(CFG, u)
    k_max = math.pi * math.hypot(N / CFG.lx, N / CFG.ly)
    assert abs(tetd.max_advective_dt(CFG, 10.0) - 2.8 / (10.0 * k_max)) \
        < 1e-12


def test_check_etd_cfl_warns_then_raises():
    cfg = CFG.replace(dt=100.0)
    tguards.check_etd_cfl(0, 0.5 * tguards.ETD_CFL_LIMIT, cfg,
                          at_start=True)
    with pytest.warns(UserWarning, match="advective CFL"):
        tguards.check_etd_cfl(0, 2.0, cfg, at_start=True)
    with pytest.raises(tguards.AdvectiveCflError, match="reduce dt below"):
        tguards.check_etd_cfl(300, 2.0, cfg, at_start=False)
    assert issubclass(tguards.AdvectiveCflError, tguards.BlowUpError)
    tguards.check_etd_cfl(300, float("nan"), cfg, at_start=False)
    tguards.check_etd_cfl(300, None, cfg, at_start=False)
