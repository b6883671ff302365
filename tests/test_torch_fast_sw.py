"""Shallow-water fast mode in the port (the JAX package's
--fast-transforms for -m sw): the fast plain versions of ka_sw, ky_all
and kx_fwd (the strict plain versions' loads around ops/fast_tile.py's
emulation of the fast column tile) and the bf16 product store between
kx_fwd and the combines, against float64 and against the JAX package's
own fast mode (pallas_fft.MM_MODE = "bf16" in interpret mode, set by
monkeypatch, as tests/test_torch_fast.py does, under which
pallas_sw.split_linear() and pstore_dtype() resolve to on and bf16);
fast RK4 and ETDRK4 segments of each package against its own strict
run; the split and pstore resolution; the converters; the model's and
the CLI's fast selection, and the flag sets fast mode once refused
(ROADMAP.md queue A, item 4), which run now. 64^2, zero forcing, a few
steps.

Bars: a fast stage's rel-L2 against float64 lies in 1e-4 .. 1e-2 and
within a factor of 5 either way of the JAX package's; a fast segment's
zeta and eta rel-L2 against its strict run lies within a factor of 5 of
the JAX package's and above 1e-7 (div is noise-dominated at 64^2 in
both packages, tests/test_pallas_sw.py:305-354, and has no bar). The
bf16 store is the rounding of the float32 result, and the combines on
bf16 products their float32 forms on the upcast, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.models import shallow_water as jsw
from xlab_fftbarotropic_tpu.ops import fft as jfft
from xlab_fftbarotropic_tpu.ops import pallas_fft as pf
from xlab_fftbarotropic_tpu.ops import pallas_sw as psw
from xlab_fftbarotropic_tpu.ops.spectral import SpectralTables as JT
from xlab_fftbarotropic_torch import convert
from xlab_fftbarotropic_torch.models import shallow_water as tsw
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.ops import fused_sw as fs
from xlab_fftbarotropic_torch.ops.spectral import SpectralTables as TT
from torch_threads import _one_thread  # noqa: F401

N = 64
# "pallas": the JAX package's "auto" takes its library path on the CPU
CFG = ModelConfig(nx=N, ny=N, dt=1.0, fft_backend="pallas")
ETD = CFG.replace(time_scheme="etdrk4", dt=7.5)
CPU = torch.device("cpu")
FACTOR = 5.0
RK4_STEPS, ETD_STEPS = 3, 2


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.complex128), np.asarray(want,
                                                           np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
            for a in arrays]


def _state_planes(seed):
    """Six float32 planes of a random SW state at the bench's magnitudes
    (zeta 1e-4, div 1e-6, eta 5 m)."""
    rng = np.random.default_rng(seed)
    out = []
    for amp in (1e-4, 1e-6, 5.0):
        f = (amp * rng.standard_normal(CFG.grid_shape)).astype(np.float32)
        z = np.asarray(jfft.forward(jnp.asarray(f)))
        out += [np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)]
    return tuple(out)


def _complex(planes):
    p = [np.asarray(x, np.float64) for x in planes]
    return [p[i] + 1j * p[i + 1] for i in range(0, len(p), 2)]


@pytest.fixture(scope="module")
def stage():
    """One fast stage of each package from the same state, and its
    float64 function: the y-major fields of inverse_quad_planes, and
    forward_tendencies' dealiased tendencies from the strict fields
    with every linear coefficient zero (ETDRK4's N, where the products
    carry the whole tendency)."""
    jt = JT.from_config(CFG)
    tt = TT.from_config(CFG, "cpu")
    planes = _state_planes(11)
    jp = tuple(jnp.asarray(p) for p in planes)
    es = float(psw.eta_pair_scale(jp))
    fields = fs.inverse_quad_planes(*_t(*planes), tt.kx, tt.ky, tt.rlap, es)
    jf = tuple(jnp.asarray(f.numpy()) for f in fields)
    out = dict(es=es)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pf, "MM_MODE", "bf16")
        assert psw.split_linear() and psw.pstore_dtype() == jnp.bfloat16
        out["jax_inv"] = [np.asarray(x) for x in psw.inverse_quad_planes(
            *jp, jt.kx, jt.ky, jt.rlap, CFG.grid_shape, eta_scale=es)]
        out["jax_fwd"] = [np.asarray(x) for x in psw.forward_tendencies(
            *jf, jp, None, jt.kx, jt.ky, jt.lap, jt.mask, 0.0, 0.0, 0.0,
            0.0, CFG.grid_shape, eta_scale=es)]
    out["port_inv"] = [x.numpy() for x in fs.inverse_quad_planes(
        *_t(*planes), tt.kx, tt.ky, tt.rlap, es, fast=True)]
    out["port_fwd"] = [x.numpy() for x in fs.forward_tendencies(
        *fields, tuple(_t(*planes)), None, tt.kx, tt.ky, tt.lap, tt.mask,
        0.0, 0.0, 0.0, 0.0, es, split=True, fast=True, pstore="bf16")]
    # float64: the fields' spectra, inverse rfft2 (x-major) transposed
    k = tt.kx.double().numpy()[:, None]
    q = tt.ky.double().numpy()[None, :]
    r = tt.rlap.double().numpy()
    z, d, e = _complex(planes)
    hats = (-1j * q * r * z + 1j * k * r * d, 1j * k * r * z + 1j * q * r * d,
            z, es * e)
    out["ref_inv"] = [np.fft.irfft2(h, s=CFG.grid_shape).T for h in hats]
    u, v, zeta, eta_s = (f.double().numpy().T for f in fields)
    eta = eta_s / es
    prods = [np.fft.rfft2(p) for p in (zeta * u, zeta * v, eta * u, eta * v,
                                        0.5 * (u * u + v * v))]
    qu, qv, eu, ev, ph = prods
    lap = tt.lap.double().numpy()
    m = tt.mask.double().numpy()
    out["ref_fwd"] = [m * (-1j * k * qu - 1j * q * qv),
                      m * (1j * k * qv - 1j * q * qu - lap * ph),
                      m * (-1j * k * eu - 1j * q * ev)]
    return out


@pytest.mark.parametrize("part", ["inv", "fwd"])
def test_fast_stage_rounds_in_the_jax_bf16_class(stage, part):
    """inverse_quad_planes (ka_sw + 2 kb_pair: u, v, zeta, eta_s) and
    forward_tendencies (ky_all + kx_fwd with the bf16 store +
    sw_combine_bf16, split: dzeta, ddiv, deta) of each package in fast
    mode against float64: each field's rel-L2 in 1e-4 .. 1e-2, within a
    factor of 5 of the JAX package's."""
    port, jax, ref = (stage[f"{w}_{part}"] for w in ("port", "jax", "ref"))
    if part == "fwd":
        port, jax = _complex(port), _complex(jax)
    for i, want in enumerate(ref):
        p, j = _rel(port[i], want), _rel(jax[i], want)
        assert 1e-4 < p < 1e-2, (i, p)
        assert 1.0 / FACTOR < p / j < FACTOR, (i, p, j)


def test_bf16_store_is_the_float32_result_rounded():
    """kx_fwd's bf16 product store, fast and strict: .to(torch.bfloat16)
    of its float32 store, bit for bit."""
    pr, pi = _t(*np.random.default_rng(3).standard_normal((2, 5, N, 33)))
    for fast in (False, True):
        a = fs.kx_fwd(pr, pi, fast=fast, pstore="bf16")
        b = fs.kx_fwd(pr, pi, fast=fast)
        assert all(x.dtype == torch.bfloat16 for x in a)
        assert all(torch.equal(x, y.to(torch.bfloat16))
                   for x, y in zip(a, b))
    with pytest.raises(ValueError, match="pstore"):
        fs.kx_fwd(pr, pi, pstore="f16")


def test_combines_on_bf16_products_are_their_float32_forms():
    """sw_combine (with and without the axpy, split with no forcing) and
    sw_combine_mv (with and without the tendency) on bf16 product
    spectra: their float32 forms on the upcast products, bit for bit."""
    tt = TT.from_config(CFG, "cpu")
    rng = np.random.default_rng(4)
    p16 = tuple(x.to(torch.bfloat16) for x in _t(*rng.standard_normal(
        (2, 5, N, N // 2 + 1))))
    up = tuple(x.float() for x in p16)
    state = tuple(_t(*_state_planes(5)))
    base = tuple(_t(*_state_planes(6)))
    src = tuple(_t(*(1e-9 * rng.standard_normal((2, N, N // 2 + 1)))))
    q = torch.from_numpy(rng.standard_normal((3, 3, N, N // 2 + 1)).astype(
        np.float32))
    tabs = (tt.kx, tt.ky, tt.lap, tt.mask)
    calls = [lambda p: fs.sw_combine(*p, state, src, *tabs, 1e-4, 9.81, 6.5,
                                     4000.0, axpy=(base, 0.4235)),
             lambda p: fs.sw_combine(*p, state, None, *tabs, 1e-4, 9.81,
                                     6.5, 4000.0, True),
             lambda p: fs.sw_combine_mv(*p, state, src, *tabs, 0.0, 0.0,
                                        0.0, 0.0, base, q, 1.0, True),
             lambda p: fs.sw_combine_mv(*p, state, None, *tabs, 0.0, 0.0,
                                        0.0, 0.0, base, q, 2.0, False)]

    def flat(out):
        return [x for o in out if o is not None
                for x in (o if isinstance(o, tuple) else (o,))]
    for call in calls:
        a, b = flat(call(p16)), flat(call(up))
        assert len(a) in (6, 12) and all(torch.equal(x, y)
                                          for x, y in zip(a, b))


def _phys(state, g=CFG.grid_shape):
    return [np.fft.irfft2(np.asarray(z), s=g) for z in state]


def _jax_segment(cfg, v0, steps):
    m = jsw.ShallowWaterModel.build(cfg)
    return _phys(m.segment(m.geostrophic_init(v0), m.zero_source(), steps))


def _port_model(cfg, **kw):
    return tsw.ShallowWaterModel.build(cfg, CPU, **kw)


def _port_segment(cfg, v0, steps, **kw):
    m = _port_model(cfg, **kw)
    s = m.segment(m.geostrophic_init(v0), m.zero_source(), steps)
    return _phys([z.numpy() for z in s])


@pytest.fixture(scope="module")
def jax_segments():
    """scheme -> each package's strict and fast run of that scheme (the
    gaussian vortex, balanced, zero forcing), computed once, when a test
    first asks for the scheme (its four JAX compiles are most of the
    time); the strict RK4 runs with the split-linear formulation (the
    JAX package's SPLIT_LINEAR="1", the port's split=True), which strict
    float32 takes at round-off (one JAX compile fewer: each takes
    seconds in interpret mode), beside the port's RK4 run without it."""
    v0 = makefields.gaussian(CFG)
    out = {}

    def segments(scheme):
        if scheme in out:
            return out[scheme]
        cfg, steps = (CFG, RK4_STEPS) if scheme == "rk4" else (ETD,
                                                              ETD_STEPS)
        split = scheme == "rk4"
        runs = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(psw, "SPLIT_LINEAR", "1" if split else "auto")
            runs["jax", False] = _jax_segment(cfg, v0, steps)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pf, "MM_MODE", "bf16")
            runs["jax", True] = _jax_segment(cfg, v0, steps)
        runs["port", False] = _port_segment(cfg, v0, steps, split=split)
        runs["port", True] = _port_segment(cfg, v0, steps, fast=True)
        if split:
            runs["port-no-split"] = _port_segment(cfg, v0, steps)
        out[scheme] = runs
        return runs
    return segments


@pytest.mark.parametrize("scheme", ["rk4", "etdrk4"])
def test_fast_segment_error_matches_the_jax_fast_mode(jax_segments,
                                                      scheme, tmp_path,
                                                      monkeypatch):
    """3 RK4 steps (2 ETDRK4 steps at dt 7.5 s) at 64^2: the port's fast
    run against its strict run, rel-L2 of zeta and eta within a factor
    of 5 of the JAX package's fast run against its strict one, and above
    1e-7 (fast is not quietly strict)."""
    monkeypatch.setenv("XFB_ETD_CACHE", str(tmp_path))
    runs = jax_segments(scheme)
    for i, name in ((0, "zeta"), (2, "eta")):
        jax = _rel(runs["jax", True][i], runs["jax", False][i])
        port = _rel(runs["port", True][i], runs["port", False][i])
        assert port > 1e-7, (name, port)
        assert 1.0 / FACTOR < port / jax < FACTOR, (name, port, jax)


@pytest.mark.parametrize("scheme", ["rk4", "etdrk4"])
def test_fast_forms_of_the_stepper(scheme, tmp_path, monkeypatch):
    """Fast RK4: the unfused form (plane_axpy stage updates) gives the
    fused form's bits; fast ETDRK4's unfused form (elementwise matvecs)
    stays within rel-L2 1e-5 of its fused form; on the CPU no launch is
    counted."""
    monkeypatch.setenv("XFB_ETD_CACHE", str(tmp_path))
    cfg = ETD if scheme == "etdrk4" else CFG
    kw = {"etd_fuse": False} if scheme == "etdrk4" else {"fused_rk": False}
    m = _port_model(cfg, fast=True)
    s0 = m.geostrophic_init(makefields.gaussian(cfg))
    ff.reset_launches()
    a = m.segment(s0, m.zero_source(), 2)
    assert set(ff.LAUNCHES.values()) == {0}
    b = _port_model(cfg, fast=True, **kw).segment(s0, m.zero_source(), 2)
    if scheme == "rk4":
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    else:
        assert _rel(a.zeta_hat.numpy(), b.zeta_hat.numpy()) < 1e-5


def test_split_and_pstore_resolve_as_the_jax_package():
    """None (auto): split-linear and the bf16 store exactly in fast mode;
    explicit values win in either mode; the library path takes neither,
    and fast mode there stays float32."""
    cases = [(dict(), (False, False, "f32")),
             (dict(fast=True), (True, True, "bf16")),
             (dict(fast=True, split=False), (True, False, "bf16")),
             (dict(fast=True, pstore="f32"), (True, True, "f32")),
             (dict(split=True), (False, True, "f32")),
             (dict(pstore="bf16"), (False, False, "bf16"))]
    for kw, want in cases:
        m = _port_model(CFG, **kw)
        assert (m.fast, m.split, m.pstore) == want, kw
    lib = _port_model(CFG.replace(fft_backend="xla"), fast=True, split=True,
                      pstore="bf16")
    assert (lib.fast, lib.split, lib.pstore) == (False, False, "f32")
    with pytest.raises(ValueError, match="pstore"):
        _port_model(CFG, pstore="fp8")


def test_strict_split_matches_the_jax_split_linear_formulation(
        jax_segments):
    """Strict float32 with split=True tracks split=False and the JAX
    package's SPLIT_LINEAR="1" run at float32 round-off over 3 steps
    (tests/test_pallas_sw.py:208): a reformulation, not a new scheme."""
    runs = jax_segments("rk4")
    split = runs["port", False]
    plain = runs["port-no-split"]
    jax = runs["jax", False]
    for i in (0, 2):
        scale = np.abs(plain[i]).max()
        assert np.abs(split[i] - plain[i]).max() / scale < 1e-5, i
        assert np.abs(split[i] - jax[i]).max() / scale < 1e-5, i
        assert not np.array_equal(split[i], plain[i]), i


def test_strict_bf16_store_drifts_boundedly():
    """Strict float32 with the bf16 product store (XFB_SW_PSTORE=bf16):
    pstore "f32" is the default's bits, "bf16" a bounded bf16-class
    drift, 1e-9 .. 5e-2, finite (tests/test_pallas_sw.py:409)."""
    tt = TT.from_config(CFG, "cpu")
    p = tuple(_t(*_state_planes(7)))
    es = float(fs.eta_pair_scale(p))

    def run(**kw):
        q = p
        for _ in range(2):
            q = tsw.rk4_step_planes(tt, q, None, 1.0, float(CFG.f),
                                    float(CFG.gravity), float(CFG.nu),
                                    float(CFG.mean_depth), es, split=True,
                                    **kw)
        return q
    ref = run()
    same = run(pstore="f32")
    assert all(torch.equal(a, b) for a, b in zip(ref, same))
    got = run(pstore="bf16")
    for i in (0, 2, 4):
        err = float(torch.linalg.vector_norm(ref[i] - got[i])
                    / torch.linalg.vector_norm(ref[i]))
        assert 1e-9 < err < 5e-2, (i, err)
        assert bool(torch.isfinite(got[i]).all())


def test_converters_carry_a_jax_state_into_the_fast_run():
    """A JAX SW state carried across as numpy (convert.py) is the port's
    bit for bit, and the fast run from it is the fast run from the
    port's own state."""
    jm = jsw.ShallowWaterModel.build(CFG)
    v0 = makefields.gaussian(CFG)
    packed = np.stack([np.asarray(z) for z in jm.geostrophic_init(v0)])
    state = convert.sw_state_from_numpy(packed, CPU)
    np.testing.assert_array_equal(convert.sw_state_to_numpy(state), packed)
    m = _port_model(CFG, fast=True)
    own = m.geostrophic_init(v0)
    for a, b in zip(state, own):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))
    a = m.segment(state, m.zero_source(), 1)
    b = m.segment(tsw.SWState(*(z.clone() for z in state)),
                  m.zero_source(), 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(bool(torch.isfinite(torch.view_as_real(x)).all()) for x in a)


@pytest.mark.parametrize("kw", [dict(yfirst=False), dict(r_drag=2e-4),
                                dict(nu4=1e-10)], ids=str)
def test_fast_model_refuses_what_waits(kw):
    """Nothing waits: the x-first order (item 4.4) runs fast, split-linear,
    on the float32 product store; RK4 with drag or hyperviscosity (item
    4.5) runs fast on the per-transform path, split-linear, one finite
    step on the fast ka, kb and kc; ETDRK4 carries drag and nu4 in its
    tables and runs the fast plane stepper."""
    kw = dict(kw)
    yfirst = kw.pop("yfirst", True)
    v0 = makefields.gaussian(CFG)
    if not yfirst:
        m = _port_model(CFG, fast=True, yfirst=False)
        assert (m.fast, m.yfirst, m.split, m.pstore) == (True, False, True,
                                                         "f32")
    else:
        with pytest.warns(UserWarning, match="per-transform"):
            m = _port_model(CFG.replace(**kw), fast=True)
        assert (m.fast, m.per_transform, m.split) == (True, True, True)
        assert _port_model(ETD.replace(**kw), fast=True).fast
    ff.reset_launches()
    s = m.segment(m.geostrophic_init(v0), m.zero_source(), 1)
    assert all(bool(torch.isfinite(torch.view_as_real(z)).all())
               for z in s)
    assert sum(ff.LAUNCHES.values()) == 0      # CPU: the plain versions


def _run_cli(tmp_path, *extra):
    from xlab_fftbarotropic_torch.cli import run as cli_run
    from xlab_fftbarotropic_torch.io.fieldio import write_field

    inp = tmp_path / "in"
    inp.mkdir(exist_ok=True)
    write_field(inp / CFG.init_file, makefields.gaussian(CFG))
    return cli_run.main(["-I", str(inp), "-O", str(tmp_path / "out"),
                         "--nx", str(N), "--ny", str(N), "--total-steps",
                         "2", "--record-step", "2", "--manifest",
                         str(tmp_path / "log"), "--device", "cpu", "-m",
                         "sw", "--dt", "1", "--fast-transforms", *extra])


@pytest.mark.parametrize("extra,env,form", [
    ([], {}, dict(fast=True, split=None, pstore=None)),
    (["--time-scheme", "etdrk4"], {"XFB_SW_PSTORE": "f32"},
     dict(fast=True, split=None, pstore="f32")),
    ([], {"XFB_SW_SPLIT": "0", "XFB_SW_PSTORE": "bfloat16"},
     dict(fast=True, split=False, pstore="bf16"))], ids=["rk4", "etd",
                                                         "env"])
def test_cli_runs_sw_fast_mode_and_prints_its_banner(tmp_path, monkeypatch,
                                                     capsys, extra, env,
                                                     form):
    """xfb-torch-run -m sw --fast-transforms --device cpu builds the
    model with fast=True and XFB_SW_SPLIT / XFB_SW_PSTORE as the JAX
    package reads them, writes the records and prints the shallow-water
    fast banner."""
    from xlab_fftbarotropic_torch import runner

    monkeypatch.setenv("XFB_ETD_CACHE", "0")
    for k in ("XFB_SW_SPLIT", "XFB_SW_PSTORE", "XFB_SW_YFIRST"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    built = []
    real = runner.ShallowWaterModel.build
    monkeypatch.setattr(runner.ShallowWaterModel, "build",
                        lambda *a, **k: built.append(k) or real(*a, **k))
    assert _run_cli(tmp_path, *extra) == 0
    assert built == [dict(yfirst=True, **form)]
    err = capsys.readouterr().err
    assert "shallow-water fast mode runs the split-linear" in err
    assert "SW formulation        : fast" in err
    for name in ("vort", "div", "h"):
        f = tmp_path / "out" / f"{name}_step_0.bin"
        assert f.stat().st_size == N * N * 4


@pytest.mark.parametrize("extra,env", [
    (["-m", "fd"], {}), (["--shard"], {}), (["--ensemble", "2"], {}),
    ([], {"XFB_SW_YFIRST": "0"}), (["--r-drag", "2e-4"], {}),
    (["--nu4", "1e-10"], {})],
    ids=lambda v: " ".join(v) if isinstance(v, list) else str(v))
def test_cli_sw_fast_mode_refuses_what_waits(tmp_path, monkeypatch, capsys,
                                             extra, env):
    """What fast mode once refused runs now, each with its banner and
    records: XFB_SW_YFIRST=0 (the x-first banner, the float32 product
    store), --r-drag and --nu4 (the per-transform pipeline's fast ka, kb
    and kc, split-linear, no product store), --ensemble 2 (one batched
    chunk at 64^2, float32 on torch.fft) and -m fd (the last -m wins: the
    FD core on torch.fft); -m sw --shard, which once stopped naming item
    5.1, runs too: on the overlap impl with the fast x-stages' banner and
    the note that the sharded model has no split-linear formulation."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if extra == ["--shard"]:
        assert _run_cli(tmp_path, *extra, "--shard-fft", "overlap") == 0
        err = capsys.readouterr().err
        assert "in the overlap x-stages (xstage)" in err
        assert "runs without the split-linear formulation" in err
        for name in ("vort", "div", "h"):
            f = tmp_path / "out" / f"{name}_step_0.bin"
            assert f.stat().st_size == N * N * 4
        return
    monkeypatch.setenv("XFB_ETD_CACHE", "0")
    assert _run_cli(tmp_path, *extra) == 0
    err = capsys.readouterr().err
    out = tmp_path / "out"
    if extra == ["-m", "fd"]:
        assert "the FD core (Arakawa Jacobian, FFT Poisson solve)" in err
        assert (out / "vort_step_0.bin").stat().st_size == N * N * 4
        return
    if extra == ["--ensemble", "2"]:
        assert "batched ensemble chunks (width > 1)" in err
        assert (out / "m01" / "h_step_0.bin").stat().st_size == N * N * 4
        return
    if env:
        assert "in ka_sw, kb, ka_fwd and kc_sw (the x-first order)" in err
        assert "Transform order       : x-first" in err
        assert "product store" not in err
    else:
        assert "in ka, kb and kc of the per-transform pipeline" in err
        assert "SW formulation        : fast (bf16 tensor-core sub-DFTs), " \
               "split-linear on\n" in err
    assert "SW formulation        : fast" in err
    assert (out / "h_step_0.bin").stat().st_size == N * N * 4
