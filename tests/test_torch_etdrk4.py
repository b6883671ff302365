"""The port's shallow-water ETDRK4 (xlab_fftbarotropic_torch/models/
etdrk4.py) and its stage-matvec combine (ops/fused_sw.py:sw_combine_mv)
against the JAX package, on the CPU.

- Tables: the port's torch build against the JAX host build: max |d|
  <= 1e-6 of each table's max (measured: bit-identical at 64^2, with
  and without drag and hyperviscosity). Cache key and file shared.
- sw_combine_mv's plain version against JAX forward_tendencies(...,
  mv_axpy=...) in interpret mode, at the 2e-5 bar of the forward
  pipeline (tests/test_torch_fused_sw.py); its tendencies bit-identical
  to sw_combine's.
- One plane step against JAX etdrk4_step_planes (interpret mode), fused
  and unfused: whole-state rel-L2 < 1e-5, the JAX package's bar for its
  two forms of the step (tests/test_etdrk4.py:272). Measured 1.7e-6:
  the balanced state is a near-steady point of L, so each stage sums
  table terms that cancel, which amplifies the transforms' float32
  round-off (the JAX package's own xla and plane paths differ by 8.6e-5
  in eta after one step here).
- 5-step trajectories of the port's plane and library paths against the
  JAX xla-path ETDRK4 at the bars of tests/test_etdrk4.py:195-197 (3e-4
  zeta, 3e-3 div, 3e-4 eta: float32 transform round-off amplified over
  the geostrophic-adjustment transient at twice the RK4 bound); with
  r_drag on the plane path too.
- The port against itself: fused against unfused (whole-state rel-L2
  < 1e-5, tests/test_etdrk4.py:272), a mode outside the mask frozen over
  10 steps, drag and hyperviscosity on the plane path.

Each JAX interpret-mode call runs once, in a module-scoped fixture.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.models import etdrk4 as jetd
from xlab_fftbarotropic_tpu.models import shallow_water as jsw
from xlab_fftbarotropic_tpu.ops import fft as jfft
from xlab_fftbarotropic_tpu.ops import pallas_sw as psw
from xlab_fftbarotropic_tpu.ops.spectral import SpectralTables as JT
from xlab_fftbarotropic_torch.models import etdrk4 as tetd
from xlab_fftbarotropic_torch.models import shallow_water as tsw
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.ops import fused_sw as fs
from xlab_fftbarotropic_torch.ops.spectral import SpectralTables as TT

CPU = torch.device("cpu")
N = 64
CFG = ModelConfig(nx=N, ny=N, time_scheme="etdrk4")
DT = 2.0 * jsw.max_stable_dt(CFG)            # twice the RK4 bound
MV_CASES = [(emit, scale, src) for emit in (True, False)
            for scale in (1.0, 2.0) for src in (False, True)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
            for a in arrays]


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    return np.max(np.abs(want - got)) / np.max(np.abs(want))


def _rel_l2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(a)


def _state_rel_l2(want, got):
    """Whole-state rel-L2 over every plane (a symmetric IC leaves some
    imaginary planes near zero, where per-plane metrics are round-off)."""
    num = sum(np.linalg.norm(np.asarray(a) - np.asarray(b)) ** 2
              for a, b in zip(want, got)) ** 0.5
    return num / sum(np.linalg.norm(np.asarray(a)) ** 2
                     for a in want) ** 0.5


def _complex_fields(planes):
    p = [np.asarray(x) for x in planes]
    return [p[i] + 1j * p[i + 1] for i in range(0, len(p), 2)]


def _random_planes(seed, amps=(1e-4, 1e-6, 5.0)):
    rng = np.random.default_rng(seed)
    out = []
    for amp in amps:
        f = (amp * rng.standard_normal(CFG.grid_shape)).astype(np.float32)
        z = np.asarray(jfft.forward(jnp.asarray(f)))
        out += [np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)]
    return tuple(out)


def _balanced_planes(cfg):
    m = jsw.ShallowWaterModel.build(cfg.replace(fft_backend="xla",
                                                time_scheme="rk4",
                                                dt=1.0))
    s = m.geostrophic_init(jnp.asarray(makefields.gaussian(cfg)))
    return tuple(np.asarray(p) for p in jsw._state_to_planes(s))


@pytest.fixture(scope="module")
def jax_etd():
    """Every JAX interpret-mode call the tests hold the port against,
    once: the stage-matvec combines and one plane step in both forms."""
    jt = JT.from_config(CFG)
    jtabs = jetd.build_tables(CFG, DT)
    planes = _random_planes(0)
    jp = tuple(jnp.asarray(p) for p in planes)
    es = psw.eta_pair_scale(jp)
    rng = np.random.default_rng(7)
    src = (1e-9 * rng.standard_normal(CFG.grid_shape)).astype(np.float32)
    jsrc = psw.forward_planes(jnp.asarray(src))
    z0 = _random_planes(1)
    u, v, zeta, eta_s = psw.inverse_quad_planes(
        *jp, jt.kx, jt.ky, jt.rlap, CFG.grid_shape, eta_scale=es)
    out = dict(planes=planes, es=float(es), z0=z0,
               src_planes=tuple(np.asarray(x) for x in jsrc),
               fields=tuple(np.asarray(x) for x in (u, v, zeta, eta_s)))
    for emit, scale, with_src in MV_CASES:
        tend, stage = psw.forward_tendencies(
            u, v, zeta, eta_s, jp, jsrc if with_src else None, jt.kx,
            jt.ky, jt.lap, jt.mask, 0.0, 0.0, 0.0, 0.0, CFG.grid_shape,
            eta_scale=es,
            mv_axpy=(tuple(jnp.asarray(p) for p in z0), jtabs.Q, scale,
                     emit))
        out["mv", emit, scale, with_src] = (
            None if tend is None else tuple(np.asarray(x) for x in tend),
            tuple(np.asarray(x) for x in stage))
    bal = _balanced_planes(CFG)
    jb = tuple(jnp.asarray(p) for p in bal)
    ebal = psw.eta_pair_scale(jb)
    out["bal"], out["bal_es"] = bal, float(ebal)
    for fuse in (True, False):
        out["step", fuse] = tuple(np.asarray(x) for x in
                                  jetd.etdrk4_step_planes(
                                      jt, jtabs, jb, None, CFG.grid_shape,
                                      ebal, fuse=fuse))
    return out


@pytest.fixture(scope="module")
def port():
    return (TT.from_config(CFG, CPU),
            tetd.EtdTables(*tetd.build_tables_stack(CFG, DT)))


# ----------------------------------------------------------------- tables

@pytest.mark.parametrize("extra", [{}, {"r_drag": 1e-4},
                                   {"nu4": 1e8, "nu": 0.0}])
def test_tables_match_the_jax_host_build(extra):
    cfg = CFG.replace(**extra)
    want = jetd._build_tables_host(cfg, DT)
    got = tetd.build_tables_stack(cfg, DT).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (6, 3, 3, N, N // 2 + 1)
    for name, w, g in zip(tetd._TABLE_NAMES, want, got):
        assert np.max(np.abs(w - g)) <= 1e-6 * np.max(np.abs(w)), name


def test_linear_matrix_matches_jax():
    cfg = CFG.replace(r_drag=1e-4, nu4=1e8)
    want = jetd.sw_linear_matrix(cfg, hpad=40)
    got = tetd.sw_linear_matrix(cfg, hpad=40).numpy()
    np.testing.assert_array_equal(got, want)


def test_tables_are_identity_and_zero_outside_the_mask(port):
    tt, tabs = port
    out = (tt.mask == 0.0).numpy()
    eye = np.eye(3)
    for name, tab in zip(tetd._TABLE_NAMES, tabs):
        for i in range(3):
            for j in range(3):
                want = eye[i, j] if name in ("E", "E2") else 0.0
                assert np.all(tab[i, j].numpy()[out] == want), name


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_table_cache_file_is_shared(tmp_path, monkeypatch, writer):
    """A stack cached by either package loads in the other, bit for bit,
    without building (the build function is made to raise)."""
    monkeypatch.setenv("XFB_ETD_CACHE", str(tmp_path))

    def boom(*args, **kwargs):
        raise AssertionError("cache miss: the tables were built again")

    if writer == "jax":
        want = [np.asarray(a) for a in jetd.build_tables_cached(CFG, DT)]
        monkeypatch.setattr(tetd, "build_tables_stack", boom)
        got = [a.numpy() for a in tetd.build_tables_cached(CFG, DT)]
    else:
        want = [a.numpy() for a in tetd.build_tables_cached(CFG, DT)]
        monkeypatch.setattr(jetd, "_build_tables_host", boom)
        got = [np.asarray(a) for a in jetd.build_tables_cached(CFG, DT)]
    files = list(tmp_path.glob("sw_etd_*.npy"))
    assert [f.name for f in files] == [
        f"sw_etd_{tetd.tables_cache_key(CFG, DT)}.npy"]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- sw_combine_mv

@pytest.mark.parametrize("emit,scale,with_src", MV_CASES)
def test_sw_combine_mv_matches_jax(jax_etd, port, emit, scale, with_src):
    tt, tabs = port
    u, v, zeta, eta_s = _t(*jax_etd["fields"])
    state = tuple(_t(*jax_etd["planes"]))
    src = tuple(_t(*jax_etd["src_planes"])) if with_src else None
    z0 = tuple(_t(*jax_etd["z0"]))
    tend, stage = fs.forward_tendencies(
        u, v, zeta, eta_s, state, src, tt.kx, tt.ky, tt.lap, tt.mask, 0.0,
        0.0, 0.0, 0.0, eta_scale=jax_etd["es"],
        mv_axpy=(z0, tabs.Q, scale, emit))
    want_t, want_s = jax_etd["mv", emit, scale, with_src]
    assert (tend is None) == (not emit) == (want_t is None)
    for w, g in zip(_complex_fields(want_s),
                    _complex_fields([x.numpy() for x in stage])):
        assert _rel(w, g) < 2e-5
    plain_t = fs.forward_tendencies(
        u, v, zeta, eta_s, state, src, tt.kx, tt.ky, tt.lap, tt.mask, 0.0,
        0.0, 0.0, 0.0, eta_scale=jax_etd["es"])
    if emit:
        for w, g in zip(_complex_fields(want_t),
                        _complex_fields([x.numpy() for x in tend])):
            assert _rel(w, g) < 2e-5
        for a, b in zip(tend, plain_t):
            assert torch.equal(a, b)
    # the stage is z0 + (scale q_i0) t_z + (scale q_i1) t_d + (scale q_i2)
    # t_e in that grouping, from sw_combine's tendencies
    q = tabs.Q
    for i in range(3):
        for c in range(2):
            want = (z0[2 * i + c] + (scale * q[i, 0]) * plain_t[c]
                    + (scale * q[i, 1]) * plain_t[2 + c]
                    + (scale * q[i, 2]) * plain_t[4 + c])
            assert torch.equal(stage[2 * i + c], want)


def test_sw_combine_mv_wrapper_checks_and_counts_nothing(port):
    tt, tabs = port
    planes = tuple(_t(*_random_planes(3)))
    p5 = torch.zeros((5, N, N // 2 + 1))
    args = (p5, p5, planes, None, tt.kx, tt.ky, tt.lap, tt.mask, 0.0, 0.0,
            0.0, 0.0)
    ff.reset_launches()
    fs.sw_combine_mv(*args, planes, tabs.Q, 1.0, False)
    assert set(ff.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):          # six base planes
        fs.sw_combine_mv(*args, planes[:5], tabs.Q, 1.0)
    with pytest.raises(ValueError):          # a (3, 3, nx, hny) table
        fs.sw_combine_mv(*args, planes, tabs.Q[:2].contiguous(), 1.0)
    with pytest.raises(ValueError):          # contiguous planes
        fs.sw_combine_mv(*args, planes, tabs.Q.transpose(0, 1), 1.0)
    fields = fs.inverse_quad_planes(*planes, tt.kx, tt.ky, tt.rlap, 1.0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        fs.forward_tendencies(*fields, planes, None, tt.kx, tt.ky, tt.lap,
                              tt.mask, 0.0, 0.0, 0.0, 0.0,
                              axpy=(planes, 0.5),
                              mv_axpy=(planes, tabs.Q, 1.0, True))


# ----------------------------------------------------------- one step

@pytest.mark.parametrize("fuse", [True, False])
def test_one_plane_step_matches_jax(jax_etd, port, fuse):
    tt, tabs = port
    got = tetd.etdrk4_step_planes(tt, tabs, tuple(_t(*jax_etd["bal"])),
                                  None, jax_etd["bal_es"], fuse=fuse)
    err = _state_rel_l2(jax_etd["step", fuse], [x.numpy() for x in got])
    print(f"one plane step, fuse={fuse}: whole-state rel-L2 {err:.3e}")
    assert err < 1e-5


# ------------------------------------------------------- trajectories

@pytest.fixture(scope="module")
def trajectories():
    """5 steps of the JAX xla-path ETDRK4 at 128^2, dt twice the RK4
    bound, from the balanced gaussian (tests/test_etdrk4.py:177-214),
    without and with drag, and the port's plane and library paths."""
    out = {}
    for drag in (0.0, 1e-4):
        cfg = ModelConfig(nx=128, ny=128, r_drag=drag,
                          time_scheme="etdrk4")
        cfg = cfg.replace(dt=2.0 * jsw.max_stable_dt(cfg))
        jm = jsw.ShallowWaterModel.build(cfg.replace(fft_backend="xla"))
        s0 = jm.geostrophic_init(jnp.asarray(makefields.gaussian(cfg)))
        out["jax", drag] = [np.asarray(x) for x in jm.segment(s0, None, 5)]
        ts0 = tsw.SWState(*(torch.from_numpy(np.array(x)) for x in s0))
        for backend in ("pallas", "xla"):
            m = tsw.ShallowWaterModel.build(cfg.replace(fft_backend=backend),
                                            CPU)
            assert m.backend == backend
            out[backend, drag] = [x.numpy() for x in m.segment(ts0, None, 5)]
    return out


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("drag", [0.0, 1e-4])
def test_trajectory_matches_jax(trajectories, backend, drag):
    want, got = trajectories["jax", drag], trajectories[backend, drag]
    for name, w, g, bar in zip(("zeta", "div", "eta"), want, got,
                               (3e-4, 3e-3, 3e-4)):
        assert _rel_l2(w, g) < bar, name


def test_fused_matches_unfused():
    cfg = ModelConfig(nx=128, ny=128, time_scheme="etdrk4")
    cfg = cfg.replace(dt=2.0 * jsw.max_stable_dt(cfg))
    tt = TT.from_config(cfg, CPU)
    tabs = tetd.EtdTables(*tetd.build_tables_stack(cfg, cfg.dt))
    p = tuple(_t(*_balanced_planes(cfg)))
    es = float(fs.eta_pair_scale(p))
    a = tetd.etdrk4_step_planes(tt, tabs, p, None, es, fuse=False)
    b = tetd.etdrk4_step_planes(tt, tabs, p, None, es, fuse=True)
    assert _state_rel_l2([x.numpy() for x in a], [x.numpy() for x in b]) \
        < 1e-5


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_above_mask_mode_stays_frozen(backend):
    m = tsw.ShallowWaterModel.build(CFG.replace(dt=DT, fft_backend=backend),
                                    CPU)
    s0 = m.init_state(makefields.gaussian(CFG))
    assert float(m.tables.mask[30, 30]) == 0.0
    z = s0.zeta_hat.clone()
    z[30, 30] = 7.0 + 3.0j
    out = m.segment(s0._replace(zeta_hat=z), None, 10)
    assert complex(out.zeta_hat[30, 30]) == 7.0 + 3.0j


@pytest.mark.parametrize("extra", [{"r_drag": 1e-4}, {"nu4": 1e8}])
def test_drag_and_hyperviscosity_take_the_plane_path(extra):
    """Under ETDRK4 drag and nu4 live in the tables: "auto" and an
    explicit "pallas" take the plane path, with no warning, and no
    gravity-wave warning at twice the RK4 bound."""
    cfg = CFG.replace(dt=DT, **extra)
    for backend in ("auto", "pallas"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            m = tsw.ShallowWaterModel.build(cfg.replace(fft_backend=backend),
                                            CPU)
        assert m.backend == "pallas"
        assert tsw.resolve_sw_backend(cfg.replace(fft_backend=backend)) \
            == "pallas"
    with pytest.warns(UserWarning, match="per-transform pipeline"):
        assert tsw.resolve_sw_backend(cfg.replace(
            time_scheme="rk4", fft_backend="pallas")) == "pallas"
    with pytest.warns(UserWarning, match="gravity-wave CFL"):
        tsw.ShallowWaterModel.build(cfg.replace(time_scheme="rk4",
                                                fft_backend="xla"), CPU)


def test_forced_plane_path_matches_library_path():
    """The forcing spectrum enters N on both paths alike (the plane path
    through ka + kc and sw_combine_mv's source planes), at the trajectory
    bars (measured zeta 3.4e-7, div 1.4e-4, eta 1.8e-6: div is the
    residual of a near-balanced flow)."""
    cfg = CFG.replace(dt=DT)
    rng = np.random.default_rng(11)
    src = torch.from_numpy((1e-9 * rng.standard_normal(cfg.grid_shape))
                           .astype(np.float32))
    out = {}
    for backend in ("pallas", "xla"):
        m = tsw.ShallowWaterModel.build(cfg.replace(fft_backend=backend),
                                        CPU)
        s0 = m.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5))
        out[backend] = m.segment(s0, src, 3)
    for name, a, b, bar in zip(("zeta", "div", "eta"), out["xla"],
                               out["pallas"], (3e-4, 3e-3, 3e-4)):
        err = _rel_l2(np.fft.irfft2(a.numpy()), np.fft.irfft2(b.numpy()))
        print(f"forced, 3 steps: {name} rel-L2 {err:.3e}")
        assert err < bar, name
