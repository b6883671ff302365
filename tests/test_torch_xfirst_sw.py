"""The shallow-water plane stepper's x-first order in the port
(xlab_fftbarotropic_torch: ka_sw + two kb_stacked, ka_fwd + kc_sw + the
unchanged combines) against the JAX package's x-first form, run in
interpret mode on the CPU with psw.YFIRST set by monkeypatch, and the
order's selection through the CLI.

Bars, the JAX package's own for these functions and paths
(tests/test_pallas_sw.py, as tests/test_torch_fused_sw.py holds the
y-first order to them): 3e-6 of max |JAX| for the inverse pipeline,
2e-5 for the forward tendencies; trajectories in physical space over
the norms of _assert_close_phys (max |zeta|, max(|div|, |zeta|),
max |eta|): 1e-5 for 2 steps against JAX and for 5 steps against the
port's y-first order (the JAX A/B test, test_yfirst_matches_xfirst).
"""

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
from xlab_fftbarotropic_torch.models import shallow_water as tsw
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.ops import fused_sw as fs
from xlab_fftbarotropic_torch.ops.spectral import SpectralTables as TT
from torch_threads import _one_thread  # noqa: F401

N = 64
# "pallas": the JAX package's "auto" takes its library path on the CPU
CFG = ModelConfig(nx=N, ny=N, dt=1.0, fft_backend="pallas")
PHYS = (float(CFG.f), float(CFG.gravity), float(CFG.nu),
        float(CFG.mean_depth))
COEF = 0.5


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    return np.max(np.abs(want - got)) / np.max(np.abs(want))


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
            for a in arrays]


def _state_planes(seed, amps=(1e-4, 1e-6, 5.0)):
    """Six float32 planes of a random SW state at the bench's magnitudes
    (tests/test_pallas_sw.py:_random_state)."""
    rng = np.random.default_rng(seed)
    out = []
    for amp in amps:
        f = (amp * rng.standard_normal(CFG.grid_shape)).astype(np.float32)
        z = np.asarray(jfft.forward(jnp.asarray(f)))
        out += [np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)]
    return tuple(out)


def _complex_fields(planes):
    p = [np.asarray(x) for x in planes]
    return [p[i] + 1j * p[i + 1] for i in range(0, len(p), 2)]


def _phys_err(want, got):
    """Max abs error of zeta, div and eta in physical space over the
    JAX package's _assert_close_phys norms."""
    a = [np.fft.irfft2(np.asarray(z), s=CFG.grid_shape) for z in want]
    b = [np.fft.irfft2(np.asarray(z), s=CFG.grid_shape) for z in got]
    nz = np.max(np.abs(a[0]))
    norms = (nz, max(np.max(np.abs(a[1])), nz), np.max(np.abs(a[2])))
    return [np.max(np.abs(x - y)) / m for x, y, m in zip(a, b, norms)]


@pytest.fixture(scope="module")
def jax_xfirst():
    """The JAX x-first pipelines, once: the x-major fields and the
    tendencies (plain, with the forcing spectrum and the stage axpy,
    split-linear)."""
    jt = JT.from_config(CFG)
    planes = _state_planes(0)
    jp = tuple(jnp.asarray(p) for p in planes)
    es = psw.eta_pair_scale(jp)
    rng = np.random.default_rng(7)
    src = (1e-9 * rng.standard_normal(CFG.grid_shape)).astype(np.float32)
    src_planes = tuple(np.asarray(x) for x in
                       psw.forward_planes(jnp.asarray(src)))
    base = _state_planes(1)
    out = dict(planes=planes, es=float(es), src_planes=src_planes,
               base=base)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(psw, "YFIRST", False)
        mp.setattr(psw, "SPLIT_LINEAR", "0")
        out["inv"] = tuple(np.asarray(x) for x in psw.inverse_quad_planes(
            *jp, jt.kx, jt.ky, jt.rlap, CFG.grid_shape, eta_scale=es))
        fields = tuple(jnp.asarray(x) for x in out["inv"])

        def tend(src_p, axpy=None):
            return psw.forward_tendencies(
                *fields, jp, src_p, jt.kx, jt.ky, jt.lap, jt.mask, *PHYS,
                CFG.grid_shape, eta_scale=es, axpy=axpy)
        jsrc = tuple(jnp.asarray(x) for x in src_planes)
        out["fwd"] = tend(None)
        out["fwd_axpy"] = tend(jsrc, axpy=(tuple(jnp.asarray(p)
                                                 for p in base), COEF))
        mp.setattr(psw, "SPLIT_LINEAR", "1")
        out["fwd_split"] = tend(jsrc)
    return out


@pytest.fixture(scope="module")
def tt():
    return TT.from_config(CFG, "cpu")


def _port_fields(tt, jax_xfirst):
    return fs.inverse_quad_planes(*_t(*jax_xfirst["planes"]), tt.kx, tt.ky,
                                  tt.rlap, jax_xfirst["es"], yfirst=False)


def test_inverse_quad_planes_xfirst_matches_jax(jax_xfirst, tt):
    """u, v, zeta and the equalized eta x-major: ka_sw + two kb_stacked
    (zeta paired with eta_scale * eta, as in y-first's kb_pair)."""
    got = _port_fields(tt, jax_xfirst)
    for name, w, g in zip(("u", "v", "zeta", "eta_s"), jax_xfirst["inv"],
                          got):
        assert g.shape == (N, N)
        assert _rel(w, g.numpy()) < 3e-6, name


@pytest.mark.parametrize("form", ["plain", "src_axpy", "split"])
def test_forward_tendencies_xfirst_match_jax(jax_xfirst, tt, form):
    """ka_fwd + kc_sw + sw_combine against KA_FWD + KC_SW + COMBINE from
    the same x-major fields: no forcing; the forcing spectrum with the
    stage axpy from a BASE state; split-linear (f0, g eta left out)."""
    fields = _t(*jax_xfirst["inv"])
    planes = tuple(_t(*jax_xfirst["planes"]))
    src = tuple(_t(*jax_xfirst["src_planes"]))
    kw = dict(eta_scale=jax_xfirst["es"], yfirst=False)
    if form == "plain":
        got, want = fs.forward_tendencies(
            *fields, planes, None, tt.kx, tt.ky, tt.lap, tt.mask, *PHYS,
            **kw), jax_xfirst["fwd"]
    elif form == "split":
        got, want = fs.forward_tendencies(
            *fields, planes, src, tt.kx, tt.ky, tt.lap, tt.mask, *PHYS,
            split=True, **kw), jax_xfirst["fwd_split"]
    else:
        base = tuple(_t(*jax_xfirst["base"]))
        tend, nxt = fs.forward_tendencies(
            *fields, planes, src, tt.kx, tt.ky, tt.lap, tt.mask, *PHYS,
            axpy=(base, COEF), **kw)
        for z0, t, n in zip(base, tend, nxt):
            assert torch.equal(n, z0 + COEF * t)
        got, want = (*tend, *nxt), (*jax_xfirst["fwd_axpy"][0],
                                    *jax_xfirst["fwd_axpy"][1])
    assert len(got) == len(want)
    for w, g in zip(_complex_fields(want),
                    _complex_fields([x.numpy() for x in got])):
        assert _rel(w, g) < 2e-5


def test_ka_fwd_and_kc_sw_are_the_transposed_forward_pipeline(tt):
    """ka_fwd + kc_sw give ky_all + kx_fwd's product spectra from the
    same fields (x-major against y-major): the two orders of one rfft2,
    to 1e-5 of each product's max."""
    rng = np.random.default_rng(3)
    u, v, zeta, eta_s = (a * p for a, p in zip(
        (3.0, 3.0, 1e-4, 1e-4), _t(*(rng.standard_normal((N, N))
                                     for _ in range(4)))))
    args = (2.0 ** 15, 1e-4, 9.81)
    xr, xi = fs.kc_sw(*fs.ka_fwd(u, v, zeta, eta_s, *args))
    yr, yi = fs.kx_fwd(*fs.ky_all(u.t().contiguous(), v.t().contiguous(),
                                  zeta.t().contiguous(),
                                  eta_s.t().contiguous(), *args))
    assert xr.shape == (5, N, N // 2 + 1)
    for p in range(5):
        w = torch.complex(yr[p], yi[p]).numpy()
        assert _rel(w, torch.complex(xr[p], xi[p]).numpy()) < 1e-5, p


def test_self_conjugate_rows_do_not_leak_through_kb_stacked(tt):
    """Junk in the imaginary part of rows 0 and ny/2 of the SW x-stage
    stack leaves the x-major paired outputs bit-identical."""
    planes = _t(*_state_planes(6))
    wr, wi = fs.ka_sw(*planes, tt.rlap, tt.kx, tt.ky,
                      float(fs.eta_pair_scale(planes)))
    clean = wi.clone()
    clean[:, 0] = 0.0
    clean[:, N // 2] = 0.0
    poisoned = clean.clone()
    poisoned[:, 0] = 10.0 * wi[:, 0] + 1.0
    poisoned[:, N // 2] = -7.0 * wi[:, N // 2]
    for pair in ((0, 1), (2, 3)):
        a = ff.kb_stacked(wr, clean, *pair, 1.0 / (N * N))
        b = ff.kb_stacked(wr, poisoned, *pair, 1.0 / (N * N))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), pair


def _src():
    rng = np.random.default_rng(17)
    return (1e-9 * rng.standard_normal(CFG.grid_shape)).astype(np.float32)


def _port_segment(cfg, n, **kw):
    m = tsw.ShallowWaterModel.build(cfg, "cpu", **kw)
    s0 = m.geostrophic_init(makefields.gaussian(cfg))
    return m.segment(s0, torch.from_numpy(_src()), n), m


@pytest.mark.parametrize("scheme", ["rk4", "etdrk4"])
def test_xfirst_trajectory_matches_jax(monkeypatch, scheme):
    """2 forced steps of the port's x-first SW plane stepper (fused RK4;
    fused ETDRK4 at 8.85 times the RK4 bound) against the JAX one with
    YFIRST off."""
    cfg = CFG
    if scheme == "etdrk4":
        cfg = cfg.replace(time_scheme="etdrk4",
                          dt=8.85 * tsw.max_stable_dt(cfg))
    monkeypatch.setattr(psw, "YFIRST", False)
    jm = jsw.ShallowWaterModel.build(cfg)
    want = jm.segment(jm.geostrophic_init(makefields.gaussian(cfg)),
                      jnp.asarray(_src()), 2)
    got, m = _port_segment(cfg, 2, yfirst=False)
    assert not m.yfirst and m.backend == "pallas"
    assert max(_phys_err(want, got)) < 1e-5


@pytest.mark.parametrize("form", ["rk4", "rk4_unfused", "etdrk4"])
def test_xfirst_matches_yfirst(form):
    """5 forced steps, the port's x-first order against its y-first one
    in each form."""
    cfg = CFG
    kw = {}
    if form == "etdrk4":
        cfg = cfg.replace(time_scheme="etdrk4",
                          dt=8.85 * tsw.max_stable_dt(cfg))
    if form == "rk4_unfused":
        kw = dict(fused_rk=False)
    want, _ = _port_segment(cfg, 5, **kw)
    got, _ = _port_segment(cfg, 5, yfirst=False, **kw)
    assert max(_phys_err(want, got)) < 1e-5


@pytest.mark.parametrize("env", [None, "0"])
def test_cli_reads_xfb_sw_yfirst(tmp_path, monkeypatch, capsys, env):
    """XFB_SW_YFIRST=0 selects the x-first order in xfb-torch-run -m sw,
    as in the JAX package: 4 stages x 2 steps of ka_fwd; XFB_BT_YFIRST
    does not touch the SW family."""
    from xlab_fftbarotropic_torch.cli import run as cli_run
    from xlab_fftbarotropic_torch.io.fieldio import write_field

    monkeypatch.setenv("XFB_BT_YFIRST", "0")
    if env is None:
        monkeypatch.delenv("XFB_SW_YFIRST", raising=False)
    else:
        monkeypatch.setenv("XFB_SW_YFIRST", env)
    calls = []
    real = fs.ka_fwd
    monkeypatch.setattr(fs, "ka_fwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    inp = tmp_path / "in"
    inp.mkdir()
    write_field(inp / CFG.init_file, makefields.gaussian(CFG))
    rc = cli_run.main(["-m", "sw", "-I", str(inp), "-O",
                       str(tmp_path / "out"), "--nx", str(N), "--ny",
                       str(N), "--dt", "1.0", "--total-steps", "2",
                       "--record-step", "2", "--manifest",
                       str(tmp_path / "log"), "--device", "cpu"])
    assert rc == 0
    xfirst = env == "0"
    assert len(calls) == (8 if xfirst else 0)
    order = "x-first" if xfirst else "y-first"
    assert f"Transform order       : {order}" in capsys.readouterr().err


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((N, N))
    with pytest.raises(ValueError):          # four fields of one shape
        fs.ka_fwd(x, x, x, torch.zeros((N, N // 2)), 1.0, 0.0, 9.81)
    with pytest.raises(ValueError):          # planes, not a stack
        fs.ka_fwd(*(torch.zeros((5, N, N)),) * 4, 1.0, 0.0, 9.81)
    with pytest.raises(TypeError):
        fs.ka_fwd(x.double(), x, x, x, 1.0, 0.0, 9.81)
    with pytest.raises(ValueError):          # a stack, not a plane
        fs.kc_sw(x, x)
    with pytest.raises(ValueError):
        fs.kc_sw(torch.zeros((5, N, N)), torch.zeros((4, N, N)))
    meta = torch.zeros((5, N, N), device="meta")
    with pytest.raises(ValueError):
        fs.kc_sw(meta, meta)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing(tt):
    planes = tuple(_t(*_state_planes(4)))
    ff.reset_launches()
    fields = fs.inverse_quad_planes(*planes, tt.kx, tt.ky, tt.rlap, 0.5,
                                    yfirst=False)
    got = fs.ka_fwd(*fields, 2.0, 1e-4, 9.81)
    want = fs.ka_fwd_plain(*fields, 2.0, 1e-4, 9.81)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = fs.kc_sw(*want)
    assert all(torch.equal(g, w) for g, w in zip(got, fs.kc_sw_plain(*want)))
    assert set(ff.LAUNCHES.values()) == {0}
