"""Fast mode on the x-first order of the port's plane steppers (the JAX
package's --fast-transforms with pallas_fft.FWD_YFIRST = False,
QUAD_MODE "quad"/"split" and pallas_sw.YFIRST = False).

- The x-first fast plain versions (ka_quad, the x-major kb, ka_adv,
  kc_visc, ka_fwd, kc_sw: the strict plain versions' loads and epilogues
  around ops/fast_tile.py's emulation of the fast column tile) against
  float64: rel-L2 in 1e-4 .. 1e-2, the strict plain version below 1e-6;
  and the smallest JAX unit that holds each kernel (the x-major kb alone;
  ka_quad in derivative_quad_planes under QUAD_MODE "quad"; ka_adv and
  kc_visc in forward_tendency; ka_fwd and kc_sw in the x-first
  forward_tendencies) under MM_MODE = "bf16" in interpret mode against
  the same float64 function, the port's unit within a factor of 5 of it.
- One step of each x-first fast segment (barotropic grid, quad, split;
  RK4 and ETDRK4; shallow water's: tests/test_torch_fast_xfirst_sw.py)
  against the port's strict x-first run:
  the rel-L2 within a factor of 5 of the JAX package's fast run against
  its strict run in the same order and QUAD_MODE, and above 1e-7 (fast
  is not quietly strict); split bit for bit quad.
- Shallow-water x-first fast mode stores its products in float32 and
  runs the float32 combines, whatever XFB_SW_PSTORE says, as the JAX
  package's x-first branch does (pallas_sw.py's KC_SW out_shape).

64^2, one step, one intra-op thread (the fast plain versions run many
small torch ops). Each segment case is a test of its own: its JAX
compiles are most of its time, so `-n 6` spreads them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.models import barotropic as jbt
from xlab_fftbarotropic_tpu.ops import fft as jfft
from xlab_fftbarotropic_tpu.ops import pallas_fft as pf
from xlab_fftbarotropic_tpu.ops import pallas_sw as psw
from xlab_fftbarotropic_tpu.ops.spectral import SpectralTables as JT
from xlab_fftbarotropic_torch.models import barotropic as tbt
from xlab_fftbarotropic_torch.models import shallow_water as tsw
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.ops import fused_sw as fs
from xlab_fftbarotropic_torch.ops.spectral import SpectralTables as TT
from torch_threads import _one_thread  # noqa: F401

N = 64
HNY = N // 2 + 1
# "pallas": the JAX package's "auto" takes its library path on the CPU
CFG = ModelConfig(nx=N, ny=N, fft_backend="pallas", beta=1e-11)
SW = ModelConfig(nx=N, ny=N, fft_backend="pallas", dt=1.0)
CPU = torch.device("cpu")
FACTOR = 5.0
NU, BETA = 6.5, 0.3


def _rel(got, want) -> float:
    got = np.concatenate([np.asarray(g, np.complex128).ravel() for g in got])
    want = np.concatenate([np.asarray(w, np.complex128).ravel()
                           for w in want])
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
            for a in arrays]


def _pairs(planes):
    """(re, im, re, im, ...) -> the complex planes."""
    p = [np.asarray(x, np.float64) for x in planes]
    return [p[i] + 1j * p[i + 1] for i in range(0, len(p), 2)]


# ------------------------------------------------ the fast forms, one by one

def _inputs(seed):
    rng = np.random.default_rng(seed)

    def f(*shape, size=1.0):
        return (size * rng.standard_normal(shape)).astype(np.float32)
    return dict(zr=f(N, HNY), zi=f(N, HNY), kx=f(N), ky=f(HNY),
                rlap=f(N, HNY), wr=f(4, HNY, N, size=N * 8.0),
                wi=f(4, HNY, N, size=N * 8.0), u=f(N, N), zx=f(N, N),
                v=f(N, N), zy=f(N, N), src=f(N, N), xr=f(N, N), xi=f(N, N),
                lap=f(N, HNY), mask=(f(N, HNY) > -0.5).astype(np.float32),
                zsr=f(N, HNY), zsi=f(N, HNY),
                fu=3.0 * f(N, N), fv=3.0 * f(N, N), fz=1e-4 * f(N, N),
                fe=1e-4 * f(N, N), gr=f(5, N, N), gi=f(5, N, N))


def _fields64(d, quad):
    """The four derivative fields' spectra (i kx Z, i ky Z, -i ky psi,
    i kx psi) in float64, (N, HNY)."""
    z = d["zr"].astype(np.float64) + 1j * d["zi"]
    k = d["kx"].astype(np.float64)[:, None]
    q = d["ky"].astype(np.float64)[None, :]
    psi = z * d["rlap"]
    return [1j * k * z, 1j * q * z, -1j * q * psi, 1j * k * psi][:quad]


def _kb64(ar, ai, br, bi, scale):
    """The paired c2r y-stage in float64, the self-conjugate rows'
    imaginary parts dropped, written x-major: [a, b] (nx, ny)."""
    out = []
    for re_, im in ((ar, ai), (br, bi)):
        c = re_.astype(np.float64) + 1j * im
        c[0].imag = 0.0
        c[-1].imag = 0.0
        out.append((np.fft.irfft(c, n=N, axis=0) * N * scale).T)
    return out


def _sw_products64(u, v, zeta, eta):
    return [zeta * u, zeta * v, eta * u, eta * v, 0.5 * (u * u + v * v)]


def _reference(name, d):
    """The float64 function each x-first fast form computes."""
    if name in ("ka_quad", "ka_quad_split"):
        out = np.stack([np.fft.ifft(f, axis=0).T * N
                        for f in _fields64(d, 4)])
        return [out.real, out.imag]
    if name == "kb":
        return _kb64(d["wr"][2], d["wi"][2], d["wr"][3], d["wi"][3],
                     1.0 / (N * N))
    if name == "ka_adv":
        adv = (-d["u"].astype(np.float64) * d["zx"]
               - d["v"] * (d["zy"] + BETA) + d["src"])
        y = np.fft.fft(adv, axis=0).T
        return [y.real, y.imag]
    if name == "kc_visc":
        y = np.fft.fft(d["xr"].astype(np.float64) + 1j * d["xi"],
                       axis=0)[:HNY].T
        r = d["mask"] * (y + NU * d["lap"] * (d["zsr"].astype(np.float64)
                                              + 1j * d["zsi"]))
        return [r.real, r.imag]
    if name == "ka_fwd":
        fields = [d[k].astype(np.float64) for k in ("fu", "fv", "fz", "fe")]
        fields[3] = fields[3] * 0.5           # eta = eta_s * ies
        y = np.stack([np.fft.fft(p, axis=0).T
                      for p in _sw_products64(*fields)])
        return [y.real, y.imag]
    y = np.fft.fft(d["gr"].astype(np.float64) + 1j * d["gi"],
                   axis=1)[:, :HNY].transpose(0, 2, 1)
    return [y.real, y.imag]


def _port(name, d, fast):
    t = dict(zip(d, _t(*d.values())))
    tab = (t["rlap"], t["kx"], t["ky"])
    if name == "ka_quad":
        return ff.ka_quad(t["zr"], t["zi"], *tab, fast=fast)
    if name == "ka_quad_split":
        a = ff.ka_quad(t["zr"], t["zi"], *tab, 0, 2, fast=fast)
        b = ff.ka_quad(t["zr"], t["zi"], *tab, 2, 2, fast=fast)
        return [torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]])]
    if name == "kb":
        return ff.kb_stacked(t["wr"], t["wi"], 2, 3, 1.0 / (N * N),
                             fast=fast)
    if name == "ka_adv":
        return ff.ka_adv(t["u"], t["zx"], t["v"], t["zy"], t["src"], BETA,
                         fast=fast)
    if name == "kc_visc":
        return ff.kc_visc(t["xr"], t["xi"], t["lap"], t["mask"], t["zsr"],
                          t["zsi"], NU, fast=fast)
    if name == "ka_fwd":
        return fs.ka_fwd(t["fu"], t["fv"], t["fz"], t["fe"], 0.5, 0.0, 0.0,
                         True, fast=fast)
    return fs.kc_sw(t["gr"], t["gi"], fast=fast)


# each form's JAX unit: the smallest JAX function that runs its kernel
UNIT = {"kb": "kb", "ka_quad": "quad", "ka_quad_split": "quad",
        "ka_adv": "tendency", "kc_visc": "tendency", "ka_fwd": "sw",
        "kc_sw": "sw"}


def _sw_unit_inputs():
    """A SW state at the bench's magnitudes (zeta 1e-4, div 1e-6, eta
    5 m) as float32 planes, its pairing equalizer, and the strict x-major
    fields of inverse_quad_planes from it."""
    rng = np.random.default_rng(11)
    planes = []
    for amp in (1e-4, 1e-6, 5.0):
        f = (amp * rng.standard_normal(SW.grid_shape)).astype(np.float32)
        z = np.asarray(jfft.forward(jnp.asarray(f)))
        planes += [np.ascontiguousarray(z.real),
                   np.ascontiguousarray(z.imag)]
    es = float(psw.eta_pair_scale(tuple(jnp.asarray(p) for p in planes)))
    tt = TT.from_config(SW, "cpu")
    fields = fs.inverse_quad_planes(*_t(*planes), tt.kx, tt.ky, tt.rlap, es,
                                    yfirst=False)
    return planes, es, tt, fields


@pytest.fixture(scope="module")
def units():
    """Each JAX unit in fast mode (MM_MODE = "bf16", interpret mode), the
    port's x-first fast counterpart from the same inputs and their
    float64 function: name -> (port, jax, ref) lists of complex planes."""
    d = _inputs(5)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = dict(zip(d, _t(*d.values())))
    scale = 1.0 / (N * N)
    planes, es, tt, fields = _sw_unit_inputs()
    jt = JT.from_config(SW)
    jp = tuple(jnp.asarray(p) for p in planes)
    jf = tuple(jnp.asarray(f.numpy()) for f in fields)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pf, "MM_MODE", "bf16")
        mp.setattr(pf, "QUAD_MODE", "quad")
        mp.setattr(psw, "YFIRST", False)
        assert psw.split_linear()
        jax = {
            "kb": pf._kb_call_stacked(j["wr"], j["wi"], 2, 3, N, scale,
                                      transpose_out=True),
            "quad": pf.derivative_quad_planes(j["zr"], j["zi"], j["kx"],
                                              j["ky"], j["rlap"], (N, N)),
            "tendency": pf.forward_tendency(
                j["u"], j["zx"], j["v"], j["zy"], j["src"], j["lap"],
                j["mask"], j["zsr"], j["zsi"], NU, (N, N), BETA),
            "sw": psw.forward_tendencies(
                *jf, jp, None, jt.kx, jt.ky, jt.lap, jt.mask, 0.0, 0.0, 0.0,
                0.0, SW.grid_shape, eta_scale=es)}
    port = {
        "kb": ff.kb_stacked(t["wr"], t["wi"], 2, 3, scale, fast=True),
        "quad": ff.derivative_quad_planes(t["zr"], t["zi"], t["kx"],
                                          t["ky"], t["rlap"], ymajor=False,
                                          quad_mode="quad", fast=True),
        "tendency": ff.forward_tendency(
            t["u"], t["zx"], t["v"], t["zy"], t["src"], t["lap"], t["mask"],
            t["zsr"], t["zsi"], NU, BETA, fast=True),
        "sw": fs.forward_tendencies(
            *fields, tuple(_t(*planes)), None, tt.kx, tt.ky, tt.lap,
            tt.mask, 0.0, 0.0, 0.0, 0.0, es, split=True, yfirst=False,
            fast=True)}
    # float64: the x-major physical fields of the four spectra; the
    # forward tendency; the SW tendencies with every linear term zero
    refs = {"kb": _kb64(d["wr"][2], d["wi"][2], d["wr"][3], d["wi"][3],
                        scale),
            "quad": [np.fft.irfft2(f, s=(N, N)) for f in _fields64(d, 4)]}
    adv = (-d["u"].astype(np.float64) * d["zx"]
           - d["v"] * (d["zy"] + BETA) + d["src"])
    z = d["zsr"].astype(np.float64) + 1j * d["zsi"]
    refs["tendency"] = [d["mask"] * (np.fft.rfft2(adv) + NU * d["lap"] * z)]
    k = tt.kx.double().numpy()[:, None]
    q = tt.ky.double().numpy()[None, :]
    u, v, zeta, eta_s = (f.double().numpy() for f in fields)
    qu, qv, eu, ev, ph = (np.fft.rfft2(p) for p in _sw_products64(
        u, v, zeta, eta_s / es))
    m = tt.mask.double().numpy()
    lap = tt.lap.double().numpy()
    refs["sw"] = [m * (-1j * k * qu - 1j * q * qv),
                  m * (1j * k * qv - 1j * q * qu - lap * ph),
                  m * (-1j * k * eu - 1j * q * ev)]
    for name in port:
        p, jx = port[name], jax[name]
        if name in ("tendency", "sw"):
            p, jx = _pairs(p), _pairs(jx)
        out[name] = (list(p), list(jx), refs[name])
    return out


@pytest.mark.parametrize("name", list(UNIT))
def test_fast_form_rounds_in_the_jax_bf16_class(units, name):
    """Each x-first fast plain version against float64: rel-L2 in 1e-4
    .. 1e-2 (the strict plain version below 1e-6); its JAX unit in fast
    mode and the port's counterpart against their float64 function, the
    port within a factor of 5 either way of the JAX package."""
    d = _inputs(list(UNIT).index(name) + 20)
    want = _reference(name, d)
    fast = _rel(_port(name, d, True), want)
    strict = _rel(_port(name, d, False), want)
    assert 1e-4 < fast < 1e-2, fast
    assert strict < 1e-6, strict
    port, jax, ref = units[UNIT[name]]
    p, j = _rel(port, ref), _rel(jax, ref)
    assert 1e-4 < p < 1e-2, p
    assert 1.0 / FACTOR < p / j < FACTOR, (p, j)


# ------------------------------------------------- one step of each segment

def _jax_bt(cfg, v0, src, quad_mode, fast, monkeypatch):
    monkeypatch.setattr(pf, "FWD_YFIRST", False)
    monkeypatch.setattr(pf, "QUAD_MODE", quad_mode)
    monkeypatch.setattr(pf, "MM_MODE", "bf16" if fast else "fp32")
    m = jbt.BarotropicModel.build(cfg)
    z = m.segment(m.init_state(v0), jnp.asarray(src), 1)
    return np.fft.irfft2(np.asarray(z), s=cfg.grid_shape)


def _port_bt(cfg, v0, src, **kw):
    m = tbt.BarotropicModel.build(cfg, CPU, yfirst=False, **kw)
    z = m.segment(m.init_state(v0), torch.from_numpy(src), 1)
    return z, np.fft.irfft2(z.numpy(), s=cfg.grid_shape)


def _split_is_quad_in_jax(monkeypatch):
    """JAX's QUAD_MODE "split" x-stage (two _ka2 calls) gives its "quad"
    derivative planes (one _ka4 call) bit for bit, strict and fast, so
    every later kernel of its step sees the same inputs: its split step
    is its quad step."""
    d = {k: jnp.asarray(v) for k, v in _inputs(9).items()}
    for mode in ("fp32", "bf16"):
        monkeypatch.setattr(pf, "MM_MODE", mode)
        planes = {}
        for q in ("quad", "split"):
            monkeypatch.setattr(pf, "QUAD_MODE", q)
            planes[q] = pf.derivative_quad_planes(d["zr"], d["zi"], d["kx"],
                                                  d["ky"], d["rlap"], (N, N))
        assert all(np.array_equal(a, b)
                   for a, b in zip(planes["quad"], planes["split"])), mode


@pytest.mark.parametrize("scheme", ["rk4", "etdrk4"])
@pytest.mark.parametrize("quad_mode", ["grid", "quad", "split"])
def test_bt_xfirst_fast_error_matches_the_jax_fast_mode(monkeypatch,
                                                        quad_mode, scheme):
    """One forced beta-plane step at 64^2 of the barotropic x-first order
    in fast mode: the port's vorticity against its strict x-first run of
    the same quad_mode, rel-L2 within a factor of 5 of the JAX package's
    (FWD_YFIRST = False, QUAD_MODE, MM_MODE = "bf16" against "fp32") and
    above 1e-7. split: its fast and strict steps are quad's bit for bit
    in the port, as the JAX package's split step is its quad step (its
    split derivative planes are its quad ones, bit for bit), so quad's
    case holds split's error to the JAX package's."""
    monkeypatch.setenv("XFB_ETD_CACHE", "0")
    cfg = CFG.replace(time_scheme=scheme)
    v0 = makefields.gaussian(cfg)
    src = (1e-9 * np.random.default_rng(3).standard_normal(
        cfg.grid_shape)).astype(np.float32)
    if quad_mode == "split":
        if scheme == "rk4":
            _split_is_quad_in_jax(monkeypatch)
        for fast in (True, False):
            assert torch.equal(
                _port_bt(cfg, v0, src, quad_mode="split", fast=fast)[0],
                _port_bt(cfg, v0, src, quad_mode="quad", fast=fast)[0])
        return
    jax = _rel([_jax_bt(cfg, v0, src, quad_mode, True, monkeypatch)],
               [_jax_bt(cfg, v0, src, quad_mode, False, monkeypatch)])
    fast = _port_bt(cfg, v0, src, quad_mode=quad_mode, fast=True)[1]
    port = _rel([fast], [_port_bt(cfg, v0, src, quad_mode=quad_mode)[1]])
    assert port > 1e-7, port
    assert 1.0 / FACTOR < port / jax < FACTOR, (port, jax)


# --------------------------------------- the SW x-first float32 product store

@pytest.mark.parametrize("pstore", [None, "bf16"], ids=["auto", "bf16"])
def test_sw_xfirst_fast_stores_float32_and_runs_the_float32_combines(
        monkeypatch, pstore):
    """x-first fast mode: pstore resolves to "f32" whatever is asked (the
    JAX package's x-first branch stores KC_SW in float32), kc_sw's fast
    form returns float32 planes, and a stage runs the float32 sw_combine
    and sw_combine_mv (their bf16 forms would raise on float32 input:
    none is called), giving the bits of the same stage with the product
    store named "f32"."""
    planes, es, tt, fields = _sw_unit_inputs()
    m = tsw.ShallowWaterModel.build(SW, CPU, yfirst=False, fast=True,
                                    pstore=pstore)
    assert m.pstore == "f32"
    assert tsw.ShallowWaterModel.build(SW, CPU, fast=True,
                                       pstore=pstore).pstore == "bf16"
    pr, pi = fs.kc_sw(*fs.ka_fwd(*fields, 1.0 / es, 1e-4, 9.81, True,
                                 fast=True), fast=True)
    assert pr.dtype == pi.dtype == torch.float32
    calls = {"sw_combine": 0, "sw_combine_mv": 0}
    for name in calls:
        real = getattr(fs, name)

        def spy(pr, *a, _real=real, _name=name, **k):
            assert pr.dtype == torch.float32
            calls[_name] += 1
            return _real(pr, *a, **k)
        monkeypatch.setattr(fs, name, spy)
    state = tuple(_t(*planes))
    args = (*fields, state, None, tt.kx, tt.ky, tt.lap, tt.mask, 1e-4,
            9.81, 6.5, 4000.0, es)
    q = torch.ones((3, 3, N, HNY))
    for store in ("bf16", "f32"):
        a = fs.forward_tendencies(*args, split=True, yfirst=False, fast=True,
                                  pstore=store)
        b = fs.forward_tendencies(*args, split=True, yfirst=False, fast=True,
                                  pstore=store,
                                  mv_axpy=(state, q, 0.5, True))
        if store == "bf16":
            first = (a, b)
    assert all(torch.equal(x, y) for x, y in zip(first[0], a))
    assert all(torch.equal(x, y) for x, y in zip(first[1][1], b[1]))
    assert calls == {"sw_combine": 2, "sw_combine_mv": 2}
