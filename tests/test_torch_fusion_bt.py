"""The barotropic y-first plane stepper's fusion arms in the port
(xlab_fftbarotropic_torch: kb_adv_full, kb_adv_half, kx_fwd + visc,
kx_visc_tail) against the JAX package's forms, run in interpret mode on
the CPU with pf.FUSEKB, pf.FUSEKX and pf.FUSETAIL set by monkeypatch;
each arm against the port's default arm; and the arms' selection through
the CLI.

Bars, max error over max |JAX| (tests/test_pallas_fft.py): 2e-5 for the
forward tendency stages (:128), 1e-5 for 2-step trajectories of the
physical vorticity (:295). The port's arms give its default arm's bits
(the plain versions compose the unfused ones), as the JAX package's own
A/B tests require of its arms (tests/test_pallas_fft.py:323-364,
tests/test_pallas_store.py:162-197).
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
from torch_threads import _one_thread  # noqa: F401

N = 64
HNY = N // 2 + 1
# "pallas": the JAX package's "auto" takes its library path on the CPU
CFG = ModelConfig(nx=N, ny=N, fft_backend="pallas")
NU = 6.5e9          # nu*lap of order one on this grid


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    return np.max(np.abs(want - got)) / np.max(np.abs(want))


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
            for a in arrays]


@pytest.fixture(scope="module")
def stage():
    """Tables of both packages, a state, the JAX x-stage stack of it and
    y-major fields, from one seed."""
    rng = np.random.default_rng(31)
    z = np.fft.rfft2(rng.standard_normal((N, N))).astype(np.complex64)
    zr, zi = np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)
    jt = JT.from_config(CFG)
    wr, wi = pf.derivative_xstage_planes(jnp.asarray(zr), jnp.asarray(zi),
                                         jt.kx, jt.ky, jt.rlap,
                                         CFG.grid_shape)
    zx, zy, src = (rng.standard_normal((N, N)).astype(np.float32)
                   for _ in range(3))
    zx, zy = zx * 1e-3, zy * 1e-3       # the size of the stack's fields
    return dict(jt=jt, tt=TT.from_config(CFG, "cpu"), zr=zr, zi=zi,
                wr=np.asarray(wr), wi=np.asarray(wi), zx=zx, zy=zy,
                src=1e-6 * src, rng=rng)


def _kb_adv(mode, wr, wi, zx, zy, src, beta, jax=False):
    if jax:
        a = [jnp.asarray(x) for x in (wr, wi, zx, zy, src)]
        if mode == "full":
            return pf.kb_adv_full(a[0], a[1], a[4], CFG.grid_shape, beta)
        return pf.kb_adv_half(a[2], a[3], a[0], a[1], a[4], CFG.grid_shape,
                              beta)
    twr, twi, tzx, tzy, tsrc = _t(wr, wi, zx, zy, src)
    if mode == "full":
        return ff.kb_adv_full(twr, twi, tsrc, beta)
    return ff.kb_adv_half(tzx, tzy, twr, twi, tsrc, beta)


@pytest.mark.parametrize("mode", ["full", "half"])
@pytest.mark.parametrize("beta", [0.0, 1e-3])
def test_kb_adv_matches_jax(stage, mode, beta):
    """kb_adv_full / kb_adv_half against pallas_fft.kb_adv_full /
    kb_adv_half on ka_diag's stack of one state, beta a static branch."""
    s = stage
    args = (s["wr"], s["wi"], s["zx"], s["zy"], s["src"], beta)
    want = _kb_adv(mode, *args, jax=True)
    got = _kb_adv(mode, *args)
    for w, g in zip(want, got):
        assert g.shape == (N, HNY)
        assert _rel(w, g.numpy()) < 2e-5


@pytest.mark.parametrize("mode", ["full", "half"])
def test_kb_adv_leak_guard(stage, mode):
    """Non-Hermitian content in the self-conjugate rows 0 and ny/2 of the
    stack (their imaginary parts) is projected out, by the port bit for
    bit and by the JAX function alike."""
    s = stage
    wi = s["wi"].copy()
    wi[:, 0] = 10.0 * wi[:, 0] + 1e-3
    wi[:, N // 2] = -7.0 * wi[:, N // 2] - 1e-3
    args = (s["wr"], wi, s["zx"], s["zy"], s["src"], 0.0)
    clean = _kb_adv(mode, s["wr"], s["wi"], *args[2:])
    dirty = _kb_adv(mode, *args)
    want = _kb_adv(mode, *args, jax=True)
    for c, d, w in zip(clean, dirty, want):
        assert torch.equal(c, d)
        assert _rel(w, d.numpy()) < 2e-5


@pytest.mark.parametrize("form", ["visc", "visc_axpy", "tail"])
def test_forward_tail_matches_jax(stage, monkeypatch, form):
    """forward_tail's unfused form (kx_fwd + visc, with and without the
    stage axpy) against pallas_fft.forward_tail under FUSEKX=0, and its
    tail form (kx_visc_tail) against forward_tail(tail=...)."""
    s, rng = stage, stage["rng"]
    jt, tt = s["jt"], s["tt"]
    fr, fi = (N * rng.standard_normal((N, HNY)).astype(np.float32)
              for _ in range(2))
    extra = [rng.standard_normal((N, HNY)).astype(np.float32)
             for _ in range(8)]
    jx = [jnp.asarray(x) for x in (fr, fi, s["zr"], s["zi"])]
    kw, tkw = {}, {}
    if form == "tail":
        kw["tail"] = (*(jnp.asarray(x) for x in extra), 0.5)
        tkw["tail"] = (*_t(*extra), 0.5)
    else:
        monkeypatch.setattr(pf, "FUSEKX", "0")
        tkw["fusekx"] = False
        if form == "visc_axpy":
            kw["axpy"] = (*(jnp.asarray(x) for x in extra[:2]), 1.5)
            tkw["axpy"] = (*_t(*extra[:2]), 1.5)
    want = pf.forward_tail(jx[0], jx[1], jt.lap, jt.mask, jx[2], jx[3], NU,
                           CFG.grid_shape, **kw)
    got = ff.forward_tail(*_t(fr, fi), tt.lap, tt.mask,
                          *_t(s["zr"], s["zi"]), NU, **tkw)
    assert len(got) == len(want) == (4 if form == "visc_axpy" else 2)
    for w, g in zip(want, got):
        assert _rel(w, g.numpy()) < 2e-5


def _src():
    rng = np.random.default_rng(37)
    return (1e-9 * rng.standard_normal(CFG.grid_shape)).astype(np.float32)


def _port_segment(cfg, v0, src, n, **kw):
    m = tbt.BarotropicModel.build(cfg, "cpu", **kw)
    return m.segment(m.init_state(v0), torch.from_numpy(src), n)


@pytest.mark.parametrize("arm", [dict(fusekb="full"), dict(fusekb="half"),
                                 dict(fusekx=False), dict(fusetail=True),
                                 dict(fusekb="full", etd=True)])
def test_fusion_trajectory_matches_jax(monkeypatch, arm):
    """2 forced steps of the port's plane stepper in a fusion arm against
    the JAX one in the same arm (RK4 on the beta-plane; ETDRK4 with
    hyperviscosity for kb_adv_full under N)."""
    kw = dict(arm)
    etd = kw.pop("etd", False)
    cfg = (CFG.replace(time_scheme="etdrk4", nu4=1e9) if etd
           else CFG.replace(beta=1e-11))
    v0 = makefields.gaussian(cfg)
    src = _src()
    monkeypatch.setattr(pf, "FUSEKB", kw.get("fusekb", "0"))
    monkeypatch.setattr(pf, "FUSEKX", "1" if kw.get("fusekx", True) else "0")
    monkeypatch.setattr(pf, "FUSETAIL", "1" if kw.get("fusetail") else "0")
    jm = jbt.BarotropicModel.build(cfg)
    want = np.fft.irfft2(np.asarray(jm.segment(jm.init_state(v0),
                                               jnp.asarray(src), 2)),
                         s=cfg.grid_shape)
    got = np.fft.irfft2(_port_segment(cfg, v0, src, 2, **kw).numpy(),
                        s=cfg.grid_shape)
    assert _rel(want, got) < 1e-5


@pytest.mark.parametrize("arm", [dict(fusekb="full"), dict(fusekb="half"),
                                 dict(fusekx=False), dict(fusetail=True),
                                 dict(fusekb="full", fusetail=True),
                                 dict(fusekb="half", fusekx=False),
                                 dict(fused_rk=False, fusekx=False),
                                 dict(fusekb="full", etd=True),
                                 dict(fusekx=False, etd=True)])
def test_fusion_arm_gives_the_default_bits(arm):
    """5 forced beta-plane steps of each arm equal the default arm's of
    the same RK form (or ETDRK4) bit for bit."""
    kw = dict(arm)
    cfg = (CFG.replace(time_scheme="etdrk4") if kw.pop("etd", False)
           else CFG.replace(beta=1e-11))
    v0 = makefields.gaussian(cfg)
    src = _src()
    want = _port_segment(cfg, v0, src, 5,
                         fused_rk=kw.get("fused_rk", True))
    assert torch.equal(_port_segment(cfg, v0, src, 5, **kw), want)


def test_tail_needs_the_fused_kx_visc():
    """fusetail without fusekx steps through rk4_combine, as the JAX
    package does (:302); forward_tail refuses the pair outright."""
    v0 = makefields.gaussian(CFG)
    src = _src()
    want = _port_segment(CFG, v0, src, 2, fusekx=False)
    got = _port_segment(CFG, v0, src, 2, fusekx=False, fusetail=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("env,want", [
    ({}, dict(fused_rk=True, fusekb="", fusekx=True, fusetail=False)),
    ({"XFB_BT_FUSEKB": "full", "XFB_BT_FUSETAIL": "1"},
     dict(fused_rk=True, fusekb="full", fusekx=True, fusetail=True)),
    ({"XFB_BT_FUSEKB": "half", "XFB_BT_FUSEKX": "0"},
     dict(fused_rk=True, fusekb="half", fusekx=False, fusetail=False)),
    ({"XFB_BT_FUSEKB": "auto", "XFB_BT_FUSEKX": "auto",
      "XFB_BT_FUSETAIL": "auto", "XFB_BT_FUSED_RK": "0"},
     dict(fused_rk=False, fusekb="", fusekx=True, fusetail=False)),
])
def test_cli_reads_the_fusion_switches(tmp_path, monkeypatch, capsys, env,
                                       want):
    """xfb-torch-run reads XFB_BT_FUSEKB / FUSEKX / FUSETAIL / FUSED_RK as
    the JAX package does (auto: the strict float32 default), builds the
    model in that arm and prints it beside the transform order."""
    from xlab_fftbarotropic_torch import runner
    from xlab_fftbarotropic_torch.cli import run as cli_run
    from xlab_fftbarotropic_torch.io.fieldio import write_field

    for k in ("XFB_BT_FUSEKB", "XFB_BT_FUSEKX", "XFB_BT_FUSETAIL",
              "XFB_BT_FUSED_RK", "XFB_BT_YFIRST"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    built = []
    real = runner.BarotropicModel.build
    monkeypatch.setattr(runner.BarotropicModel, "build",
                        lambda *a, **k: built.append(k) or real(*a, **k))
    inp = tmp_path / "in"
    inp.mkdir()
    write_field(inp / CFG.init_file, makefields.gaussian(CFG))
    rc = cli_run.main(["-I", str(inp), "-O", str(tmp_path / "out"), "--nx",
                       str(N), "--ny", str(N), "--total-steps", "2",
                       "--record-step", "2", "--manifest",
                       str(tmp_path / "log"), "--device", "cpu"])
    assert rc == 0
    assert built == [dict(yfirst=True, **want)]
    arm = tbt.fusion_arm(**want)
    assert f"Fusion arm            : {arm}" in capsys.readouterr().err


@pytest.mark.parametrize("name,value", [("XFB_BT_FUSEKB", "quarter"),
                                        ("XFB_BT_FUSEKB", "1")])
def test_cli_rejects_an_unknown_fusekb(tmp_path, monkeypatch, capsys, name,
                                       value):
    from xlab_fftbarotropic_torch.cli import run as cli_run

    monkeypatch.setenv(name, value)
    with pytest.raises(SystemExit) as e:
        cli_run.main(["-O", str(tmp_path / "out"), "--nx", str(N), "--ny",
                      str(N), "--total-steps", "1", "--device", "cpu"])
    assert e.value.code == 2
    assert "XFB_BT_FUSEKB" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_wrappers_reject_what_the_kernels_do_not_take(stage):
    tt = stage["tt"]
    w = torch.zeros((4, HNY, N))
    f = torch.zeros((N, N))
    p = torch.zeros((N, HNY))
    with pytest.raises(ValueError):          # ka_diag's four fields
        ff.kb_adv_full(w[:3], w[:3], f)
    with pytest.raises(ValueError):          # src y-major (ny, nx)
        ff.kb_adv_full(w, w, p)
    with pytest.raises(ValueError):
        ff.kb_adv_half(f[:-1], f, w, w, f)
    with pytest.raises(TypeError):
        ff.kb_adv_half(f, f, w.double(), w.double(), f)
    meta = torch.zeros((4, HNY, N), device="meta")
    with pytest.raises(ValueError):
        ff.kb_adv_full(meta, meta, torch.zeros((N, N), device="meta"))
    with pytest.raises(ValueError):          # planes, not a stack
        ff.visc(w, w, w, w, w, w, 1.0)
    with pytest.raises(ValueError):          # the mask is (nx, hny)
        ff.visc(p, p, p, p[:, :-1].contiguous(), p, p, 1.0)
    tail = (p,) * 8 + (0.5,)
    with pytest.raises(ValueError):
        ff.kx_visc_tail(p, p, tt.lap, tt.mask, p, p, 1.0, tail[1:])
    with pytest.raises(ValueError):
        ff.kx_visc_tail(p, p, tt.lap, tt.mask, p, p, 1.0,
                        (p[:-1],) + tail[1:])
    with pytest.raises(ValueError):          # as pallas_fft (:1723)
        ff.forward_tail(p, p, tt.lap, tt.mask, p, p, 1.0, tail=tail,
                        fusekx=False)
    with pytest.raises(ValueError):
        ff.forward_tail(p, p, tt.lap, tt.mask, p, p, 1.0, axpy=(p, p, 1.0),
                        tail=tail)
    with pytest.raises(ValueError):
        ff.tendency_yfirst_fusedkb(p, p, f, tt.kx, tt.ky, tt.rlap, tt.lap,
                                   tt.mask, 1.0, mode="quarter")
    with pytest.raises(ValueError):
        tbt.BarotropicModel.build(CFG, "cpu", fusekb="quarter")
    with pytest.raises(TypeError):
        tbt.BarotropicModel.build(CFG, "cpu", fusekx="0")
    d = tbt.plane_tendency(tt, f, 1.0, yfirst=False, fusekb="full")
    with pytest.raises(ValueError):          # the x-first order: no tail
        d(p, p, tail=tail)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing(stage):
    s, tt = stage, stage["tt"]
    twr, twi, tzx, tzy, tsrc = _t(s["wr"], s["wi"], s["zx"], s["zy"],
                                  s["src"])
    tzr, tzi = _t(s["zr"], s["zi"])
    ff.reset_launches()
    got = ff.kb_adv_full(twr, twi, tsrc, 0.3)
    want = ff.kb_adv_full_plain(twr, twi, tsrc, 0.3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ff.kb_adv_half(tzx, tzy, twr, twi, tsrc)
    ff.visc(tzr, tzi, tt.lap, tt.mask, tzr, tzi, 1.0, (tzr, tzi, 0.5))
    ff.kx_visc_tail(tzr, tzi, tt.lap, tt.mask, tzr, tzi, 1.0,
                    (tzr, tzi) * 4 + (0.5,))
    for mode in ("full", "half"):
        ff.tendency_yfirst_fusedkb(tzr, tzi, tsrc, tt.kx, tt.ky, tt.rlap,
                                   tt.lap, tt.mask, 1.0, mode=mode,
                                   fusekx=False)
    assert set(ff.LAUNCHES.values()) == {0}
