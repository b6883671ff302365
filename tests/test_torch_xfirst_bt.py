"""The barotropic plane stepper's x-first order in the port
(xlab_fftbarotropic_torch: ka_adv + kc_visc, the x-major kb_stacked,
ka_quad for QUAD_MODE "quad" and "split") against the JAX package's
x-first forms, run in interpret mode on the CPU with pf.FWD_YFIRST and
pf.QUAD_MODE set by monkeypatch, and the order's selection through the
CLI.

Bars, max error over max |JAX| (tests/test_pallas_fft.py): 2e-6 for the
inverse stages (kb_stacked, derivative_quad_planes in every quad mode),
2e-5 for the forward tendency (:128), 1e-5 for 2-step trajectories of
the physical vorticity (:295), and the same 1e-5 for the port's x-first
forms against its y-first one over 5 steps (no JAX).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.models import barotropic as jbt
from xlab_fftbarotropic_tpu.ops import pallas_fft as pf
from xlab_fftbarotropic_tpu.ops.spectral import SpectralTables as JT
from xlab_fftbarotropic_torch.models import barotropic as tbt
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.ops.spectral import SpectralTables as TT

N = 64
# "pallas": the JAX package's "auto" takes its library path on the CPU
CFG = ModelConfig(nx=N, ny=N, fft_backend="pallas")


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    return np.max(np.abs(want - got)) / np.max(np.abs(want))


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
            for a in arrays]


@pytest.fixture(scope="module")
def state():
    rng = np.random.default_rng(11)
    z = np.fft.rfft2(rng.standard_normal((N, N))).astype(np.complex64)
    zr, zi = np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)
    return JT.from_config(CFG), TT.from_config(CFG, "cpu"), zr, zi


@pytest.mark.parametrize("beta", [0.0, 0.7])
def test_forward_tendency_matches_jax(state, beta):
    """ka_adv + kc_visc against pallas_fft.forward_tendency (_ka_adv +
    _kc_visc) from the same x-major fields, beta a static branch."""
    jt, tt, zr, zi = state
    rng = np.random.default_rng(12)
    fields = [rng.standard_normal((N, N)).astype(np.float32)
              for _ in range(5)]
    nu = 6.5e9          # nu*lap of order one on this grid
    want = pf.forward_tendency(
        *(jnp.asarray(f) for f in fields), jt.lap, jt.mask,
        jnp.asarray(zr), jnp.asarray(zi), nu, CFG.grid_shape, beta=beta)
    got = ff.forward_tendency(*_t(*fields), tt.lap, tt.mask, *_t(zr, zi),
                              nu, beta)
    for w, g in zip(want, got):
        assert g.shape == (N, N // 2 + 1)
        assert _rel(w, g.numpy()) < 2e-5


@pytest.mark.parametrize("pair", [(0, 1), (2, 3)])
def test_kb_stacked_matches_kb_call_stacked(state, pair):
    """The x-major kb on the stack's field planes against
    _kb_call_stacked(..., transpose_out=True); junk in the imaginary part
    of the self-conjugate rows 0 and ny/2 leaves its bits unchanged."""
    jt, _, zr, zi = state
    wr, wi = pf.derivative_xstage_planes(jnp.asarray(zr), jnp.asarray(zi),
                                         jt.kx, jt.ky, jt.rlap,
                                         CFG.grid_shape)
    scale = 1.0 / (N * N)
    want = pf._kb_call_stacked(wr, wi, *pair, N, scale, transpose_out=True)
    twr, twi = _t(wr, wi)
    got = ff.kb_stacked(twr, twi, *pair, scale)
    for w, g in zip(want, got):
        assert g.shape == (N, N)
        assert _rel(w, g.numpy()) < 2e-6
    poisoned = twi.clone()
    poisoned[:, 0] = 10.0 * twi[:, 0] + 1.0
    poisoned[:, N // 2] = -7.0 * twi[:, N // 2]
    dirty = ff.kb_stacked(twr, poisoned, *pair, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, dirty))


@pytest.mark.parametrize("quad_mode", ["grid", "quad", "split"])
def test_xmajor_derivative_quad_planes_match_jax(state, monkeypatch,
                                                 quad_mode):
    """The x-major (zeta_x, zeta_y, u, v): ka_diag ("grid") or ka_quad
    (psi first: _ka4 in one call, _ka2 in two) + two kb_stacked against
    derivative_quad_planes(ymajor=False) under that QUAD_MODE."""
    jt, tt, zr, zi = state
    monkeypatch.setattr(pf, "QUAD_MODE", quad_mode)
    want = pf.derivative_quad_planes(jnp.asarray(zr), jnp.asarray(zi),
                                     jt.kx, jt.ky, jt.rlap, CFG.grid_shape)
    got = ff.derivative_quad_planes(*_t(zr, zi), tt.kx, tt.ky, tt.rlap,
                                    ymajor=False, quad_mode=quad_mode)
    for name, w, g in zip(("zx", "zy", "u", "v"), want, got):
        assert g.shape == (N, N)
        assert _rel(w, g.numpy()) < 2e-6, name


def test_ka_quad_is_ka_diag_in_another_grouping(state):
    """ka_quad's fields are ka_diag's (the psi ones rounded apart), and
    the split calls are the quad call's halves bit for bit."""
    _, tt, zr, zi = state
    tzr, tzi = _t(zr, zi)
    quad = ff.ka_quad(tzr, tzi, tt.rlap, tt.kx, tt.ky)
    diag = ff.ka_diag(tzr, tzi, tt.rlap, tt.kx, tt.ky)
    for q, d in zip(quad, diag):
        assert q.shape == (4, N // 2 + 1, N)
        for f in range(4):
            assert _rel(d[f].numpy(), q[f].numpy()) < 1e-6, f
    halves = [ff.ka_quad(tzr, tzi, tt.rlap, tt.kx, tt.ky, first, 2)
              for first in (0, 2)]
    for p in range(2):
        assert torch.equal(torch.cat([h[p] for h in halves]), quad[p])


def _port_segment(cfg, v0, src, n, **kw):
    m = tbt.BarotropicModel.build(cfg, "cpu", **kw)
    z = m.segment(m.init_state(v0), torch.from_numpy(src), n)
    return np.fft.irfft2(z.numpy(), s=cfg.grid_shape), m


def _src():
    rng = np.random.default_rng(23)
    return (1e-9 * rng.standard_normal(CFG.grid_shape)).astype(np.float32)


@pytest.mark.parametrize("form", ["rk4", "etdrk4", "quad", "split"])
def test_xfirst_trajectory_matches_jax(monkeypatch, form):
    """2 forced steps of the port's x-first plane stepper against the
    JAX one in the same form (RK4 with beta, ETDRK4 with
    hyperviscosity, RK4 under QUAD_MODE quad and split); the forcing is
    not transposed on this order, so a nonzero one pins the layout."""
    quad_mode = form if form in ("quad", "split") else "grid"
    cfg = (CFG.replace(time_scheme="etdrk4", nu4=1e9) if form == "etdrk4"
           else CFG.replace(beta=1e-11))
    v0 = makefields.gaussian(cfg)
    src = _src()
    monkeypatch.setattr(pf, "FWD_YFIRST", False)
    monkeypatch.setattr(pf, "QUAD_MODE", quad_mode)
    jm = jbt.BarotropicModel.build(cfg)
    want = np.fft.irfft2(np.asarray(jm.segment(jm.init_state(v0),
                                               jnp.asarray(src), 2)),
                         s=cfg.grid_shape)
    got, m = _port_segment(cfg, v0, src, 2, yfirst=False,
                           quad_mode=quad_mode)
    assert not m.yfirst and m.backend == "pallas"
    assert _rel(want, got) < 1e-5


@pytest.mark.parametrize("form", [dict(yfirst=False), dict(quad_mode="quad"),
                                  dict(quad_mode="split"),
                                  dict(yfirst=False, etd=True)])
def test_xfirst_matches_yfirst(form):
    """5 forced steps, the port's x-first forms against its y-first one
    (as the JAX package's own A/B test, test_bt_yfirst_matches_xfirst)."""
    kw = dict(form)
    cfg = CFG.replace(time_scheme="etdrk4") if kw.pop("etd", False) else CFG
    v0 = makefields.gaussian(cfg)
    src = _src()
    want, _ = _port_segment(cfg, v0, src, 5)
    got, m = _port_segment(cfg, v0, src, 5, **kw)
    assert not m.yfirst
    assert _rel(want, got) < 1e-5


@pytest.mark.parametrize("env", [None, "1", "0"])
def test_cli_reads_xfb_bt_yfirst(tmp_path, monkeypatch, capsys, env):
    """XFB_BT_YFIRST=0 selects the x-first order in xfb-torch-run, as it
    does in the JAX package: 4 stages x 2 steps of forward_tendency."""
    from xlab_fftbarotropic_torch.cli import run as cli_run
    from xlab_fftbarotropic_torch.io.fieldio import write_field

    if env is None:
        monkeypatch.delenv("XFB_BT_YFIRST", raising=False)
    else:
        monkeypatch.setenv("XFB_BT_YFIRST", env)
    calls = []
    real = ff.forward_tendency
    monkeypatch.setattr(ff, "forward_tendency",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    inp = tmp_path / "in"
    inp.mkdir()
    write_field(inp / CFG.init_file, makefields.gaussian(CFG))
    rc = cli_run.main(["-I", str(inp), "-O", str(tmp_path / "out"), "--nx",
                       str(N), "--ny", str(N), "--total-steps", "2",
                       "--record-step", "2", "--manifest",
                       str(tmp_path / "log"), "--device", "cpu"])
    assert rc == 0
    xfirst = env == "0"
    assert len(calls) == (8 if xfirst else 0)
    order = "x-first" if xfirst else "y-first"
    assert f"Transform order       : {order}" in capsys.readouterr().err


def test_wrappers_reject_what_the_kernels_do_not_take(state):
    _, tt, zr, zi = state
    tzr, tzi = _t(zr, zi)
    for first, count in ((1, 2), (0, 3), (2, 4)):
        with pytest.raises(ValueError):
            ff.ka_quad(tzr, tzi, tt.rlap, tt.kx, tt.ky, first, count)
    with pytest.raises(ValueError):
        ff.ka_quad(tzr, tzi, tt.rlap[:, :-1].contiguous(), tt.kx, tt.ky)
    w = torch.zeros((4, N // 2 + 1, N))
    with pytest.raises(ValueError):          # a stack, not a plane
        ff.kb_stacked(w[0], w[0], 0, 1, 1.0)
    with pytest.raises(ValueError):
        ff.kb_stacked(w, w, 0, 4, 1.0)
    with pytest.raises(ValueError):          # wr, wi of one shape
        ff.kb_stacked(w, w[:2], 0, 1, 1.0)
    x = torch.zeros((N, N))
    with pytest.raises(ValueError):
        ff.ka_adv(x, x, x, x, torch.zeros((N, N // 2)))
    with pytest.raises(ValueError):
        ff.ka_adv(x.t(), x, x, x, x)          # not contiguous
    with pytest.raises(TypeError):
        ff.ka_adv(x.double(), x, x, x, x)
    with pytest.raises(ValueError):
        ff.ka_adv(w, w, w, w, w)
    with pytest.raises(ValueError):          # the tables are (nx, hny)
        ff.kc_visc(x, x, tt.lap.t().contiguous(), tt.mask, tzr, tzi, 1.0)
    with pytest.raises(ValueError):
        ff.kc_visc(w, w, tt.lap, tt.mask, tzr, tzi, 1.0)
    meta = torch.zeros((N, N), device="meta")
    with pytest.raises(ValueError):
        ff.ka_adv(meta, meta, meta, meta, meta)
    with pytest.raises(ValueError):
        ff.derivative_quad_planes(tzr, tzi, tt.kx, tt.ky, tt.rlap,
                                  quad_mode="tiles")
    with pytest.raises(NotImplementedError):  # as pallas_fft (:826-827)
        ff.derivative_quad_planes(tzr, tzi, tt.kx, tt.ky, tt.rlap,
                                  ymajor=True, quad_mode="quad")
    with pytest.raises(ValueError):
        tbt.BarotropicModel.build(CFG, "cpu", quad_mode="tiles")
    with pytest.raises(NotImplementedError):
        tbt.plane_tendency(tt, x, 1.0, quad_mode="split")(tzr, tzi)
    d = tbt.plane_tendency(tt, x, 1.0, yfirst=False)
    with pytest.raises(ValueError):          # the x-first order has no axpy
        d(tzr, tzi, (tzr, tzi, 0.5))


def test_cpu_tensors_take_the_plain_versions_and_count_nothing(state):
    _, tt, zr, zi = state
    tzr, tzi = _t(zr, zi)
    ff.reset_launches()
    got = ff.ka_quad(tzr, tzi, tt.rlap, tt.kx, tt.ky)
    want = ff.ka_quad_plain(tzr, tzi, tt.rlap, tt.kx, tt.ky)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    zx, zy, u, v = ff.derivative_quad_planes(tzr, tzi, tt.kx, tt.ky, tt.rlap,
                                             ymajor=False, quad_mode="split")
    ff.forward_tendency(u, zx, v, zy, zx, tt.lap, tt.mask, tzr, tzi, 1.0)
    assert set(ff.LAUNCHES.values()) == {0}
