"""Fast mode in the port (the JAX package's --fast-transforms): the fast
plain versions of ka_diag, kb_pair, kb_adv_half, kx_visc, ky_adv,
kb_adv_full and kx_visc_tail (the strict plain versions' loads and
epilogues around ops/fast_tile.py's emulation of the fast column tile:
bf16 radix-16 sub-DFT passes, float32 between) against float64 DFTs and
against the JAX package's own bf16 rounding (pallas_fft.MM_MODE = "bf16"
in interpret mode, set by monkeypatch, as tests/test_pallas_sw.py:339
does); a 64^2 barotropic segment of each package's fast mode against its
own strict run; every other y-first arm (FUSEKB "" and full, FUSEKX=0,
FUSETAIL, the unfused RK form) bit for bit the fast half arm, and
ETDRK4's fast error against the JAX package's; the converters carrying a
JAX state into the port's fast run; the model's and the CLI's fast
selection, each arm's banner, and the flag sets fast mode once refused
(ROADMAP.md queue A, item 4), which run now.

Bars: a fast transform's rel-L2 against float64 lies in 1e-4 .. 1e-2
(it rounds to bf16, and stays in class), within a factor of 5 either way
of the JAX package's bf16 error on the same input; the strict plain
version's stays below 1e-6. The port's fast segment's rel-L2 against its
strict run is within a factor of 5 of the JAX package's and above 1e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.models import barotropic as jbt
from xlab_fftbarotropic_tpu.ops import pallas_fft as pf
from xlab_fftbarotropic_torch import convert
from xlab_fftbarotropic_torch.models import barotropic as tbt
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from torch_threads import _one_thread  # noqa: F401

N = 64
HNY = N // 2 + 1
# "pallas": the JAX package's "auto" takes its library path on the CPU
CFG = ModelConfig(nx=N, ny=N, fft_backend="pallas")
CPU = torch.device("cpu")
FACTOR = 5.0


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
            for a in arrays]


@pytest.fixture
def bf16(monkeypatch):
    """The JAX package in fast mode's bf16 rounding (interpret mode)."""
    monkeypatch.setattr(pf, "MM_MODE", "bf16")
    monkeypatch.setattr(pf, "FUSEKB", "auto")


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def f(*shape, size=1.0):
        return (size * rng.standard_normal(shape)).astype(np.float32)
    return dict(zr=f(N, HNY), zi=f(N, HNY), kx=f(N), ky=f(HNY),
                rlap=f(N, HNY), wr=f(4, HNY, N, size=N * 8.0),
                wi=f(4, HNY, N, size=N * 8.0), zx=f(N, N), zy=f(N, N),
                src=f(N, N), fr=f(N, HNY), fi=f(N, HNY), lap=f(N, HNY),
                mask=(f(N, HNY) > -0.5).astype(np.float32), zsr=f(N, HNY),
                zsi=f(N, HNY), z0r=f(N, HNY), z0i=f(N, HNY), u=f(N, N),
                v=f(N, N), r1r=f(N, HNY), r1i=f(N, HNY), r2r=f(N, HNY),
                r2i=f(N, HNY), r3r=f(N, HNY), r3i=f(N, HNY))


def _hermitian64(ar, ai, br, bi):
    """The paired c2r y-stage's column a + i b in float64, the
    self-conjugate rows' imaginary parts dropped."""
    a = ar.astype(np.float64) + 1j * ai
    b = br.astype(np.float64) + 1j * bi
    for x in (a, b):
        x[0].imag = 0.0
        x[-1].imag = 0.0
    full = np.concatenate([a, np.conj(a[-2:0:-1])])
    return full + 1j * np.concatenate([b, np.conj(b[-2:0:-1])])


def _c64(d, re, im):
    return d[re].astype(np.float64) + 1j * d[im]


def _ky_adv64(u, zx, v, zy, src, beta):
    adv = -u.astype(np.float64) * zx - v * (zy + beta) + src
    f = np.fft.rfft(adv, axis=0).T
    return [f.real, f.imag]


def _reference(name, d):
    """The float64 function each fast kernel computes."""
    if name == "ky_adv":
        return _ky_adv64(d["u"], d["zx"], d["v"], d["zy"], d["src"], 0.3)
    if name == "ka_diag":
        z = d["zr"].astype(np.float64) + 1j * d["zi"]
        k = d["kx"].astype(np.float64)[:, None]
        q = d["ky"].astype(np.float64)[None, :]
        psi = z * d["rlap"]
        fields = [1j * k * z, 1j * q * z, -1j * q * psi, 1j * k * psi]
        out = np.stack([np.fft.ifft(f, axis=0).T * N for f in fields])
        return [out.real, out.imag]
    scale = 1.0 / (N * N)
    if name == "kb_pair":
        c = _hermitian64(d["wr"][2], d["wi"][2], d["wr"][3], d["wi"][3])
        y = np.fft.ifft(c, axis=0) * N * scale
        return [y.real, y.imag]
    if name in ("kb_adv_half", "kb_adv_full"):
        c = _hermitian64(d["wr"][2], d["wi"][2], d["wr"][3], d["wi"][3])
        y = np.fft.ifft(c, axis=0) * N * scale
        zx, zy = d["zx"], d["zy"]
        if name == "kb_adv_full":
            g = _hermitian64(d["wr"][0], d["wi"][0], d["wr"][1], d["wi"][1])
            g = np.fft.ifft(g, axis=0) * N * scale
            zx, zy = g.real, g.imag
        return _ky_adv64(y.real, zx, y.imag, zy, d["src"], 0.3)
    f = np.fft.fft(_c64(d, "fr", "fi"), axis=0)
    r = d["mask"] * (f + 6.5 * d["lap"] * _c64(d, "zsr", "zsi"))
    z0 = _c64(d, "z0r", "z0i")
    if name == "kx_visc_tail":
        n = z0 + (_c64(d, "r1r", "r1i") + 2.0 * _c64(d, "r2r", "r2i")
                  + 2.0 * _c64(d, "r3r", "r3i") + r) * 1.5
        return [n.real, n.imag]
    n = z0 + 1.5 * r
    return [r.real, r.imag, n.real, n.imag]


TAIL = ("z0r", "z0i", "r1r", "r1i", "r2r", "r2i", "r3r", "r3i")


def _port(name, d, fast):
    t = dict(zip(d, _t(*d.values())))
    if name == "ky_adv":
        return ff.ky_adv(t["u"], t["zx"], t["v"], t["zy"], t["src"], 0.3,
                         fast=fast)
    if name == "kb_adv_full":
        return ff.kb_adv_full(t["wr"], t["wi"], t["src"], 0.3, fast=fast)
    if name == "kx_visc_tail":
        return ff.kx_visc_tail(t["fr"], t["fi"], t["lap"], t["mask"],
                               t["zsr"], t["zsi"], 6.5,
                               (*(t[k] for k in TAIL), 1.5), fast=fast)
    if name == "ka_diag":
        return ff.ka_diag(t["zr"], t["zi"], t["rlap"], t["kx"], t["ky"],
                          fast=fast)
    if name == "kb_pair":
        return ff.kb_pair(t["wr"], t["wi"], 2, 3, 1.0 / (N * N), fast=fast)
    if name == "kb_adv_half":
        return ff.kb_adv_half(t["zx"], t["zy"], t["wr"], t["wi"], t["src"],
                              0.3, fast=fast)
    return ff.kx_visc(t["fr"], t["fi"], t["lap"], t["mask"], t["zsr"],
                      t["zsi"], 6.5, (t["z0r"], t["z0i"], 1.5), fast=fast)


def _jax(name, d):
    j = {k: jnp.asarray(v) for k, v in d.items()}
    if name == "ky_adv":
        # the JAX ky_adv kernel's transform is _kc_body of (adv, 0): kc
        adv = ff.advection(*_t(d["u"], d["zx"], d["v"], d["zy"], d["src"]),
                           0.3).numpy()
        return pf._kc_call((jnp.asarray(adv), jnp.zeros_like(adv)), N)
    if name == "kb_adv_full":
        return pf.kb_adv_full(j["wr"], j["wi"], j["src"], (N, N), 0.3)
    if name == "kx_visc_tail":
        return pf.forward_tail(j["fr"], j["fi"], j["lap"], j["mask"],
                               j["zsr"], j["zsi"], 6.5, (N, N),
                               tail=(*(j[k] for k in TAIL), 1.5))
    if name == "ka_diag":
        return pf.derivative_xstage_planes(j["zr"], j["zi"], j["kx"],
                                           j["ky"], j["rlap"], (N, N))
    if name == "kb_pair":
        return pf._kb_call_stacked(j["wr"], j["wi"], 2, 3, N, 1.0 / (N * N),
                                   transpose_out=False)
    if name == "kb_adv_half":
        return pf.kb_adv_half(j["zx"], j["zy"], j["wr"], j["wi"], j["src"],
                              (N, N), 0.3)
    return pf.forward_tail(j["fr"], j["fi"], j["lap"], j["mask"], j["zsr"],
                           j["zsi"], 6.5, (N, N),
                           axpy=(j["z0r"], j["z0i"], 1.5))


def _error(out, want) -> float:
    got = np.concatenate([np.asarray(o, np.float64).ravel() for o in out])
    ref = np.concatenate([np.asarray(w).ravel() for w in want])
    return _rel(got, ref)


@pytest.mark.parametrize("name", ["ka_diag", "kb_pair", "kb_adv_half",
                                  "kx_visc", "ky_adv", "kb_adv_full",
                                  "kx_visc_tail"])
def test_fast_transform_rounds_in_the_jax_bf16_class(bf16, name):
    """Each fast plain version against float64: rel-L2 in 1e-4 .. 1e-2,
    within a factor of 5 of the JAX kernel's under MM_MODE = "bf16" on
    the same input; the strict plain version below 1e-6."""
    d = _inputs(list(ff.LAUNCHES).index(name + "_fast"))
    want = _reference(name, d)
    fast = _error(_port(name, d, True), want)
    strict = _error(_port(name, d, False), want)
    jax = _error(_jax(name, d), want)
    assert 1e-4 < fast < 1e-2, fast
    assert 1.0 / FACTOR < fast / jax < FACTOR, (fast, jax)
    assert strict < 1e-6, strict


def _jax_segment(cfg, v0, src, steps):
    m = jbt.BarotropicModel.build(cfg)
    z = m.segment(m.init_state(v0), jnp.asarray(src), steps)
    return np.fft.irfft2(np.asarray(z), s=cfg.grid_shape)


def _port_segment(cfg, v0, src, steps, **kw):
    m = tbt.BarotropicModel.build(cfg, CPU, **kw)
    z = m.segment(m.init_state(v0), torch.from_numpy(src), steps)
    return np.fft.irfft2(z.numpy(), s=cfg.grid_shape)


def test_fast_segment_error_matches_the_jax_fast_mode(monkeypatch):
    """3 forced beta-plane steps at 64^2: the port's fast run against its
    strict run, rel-L2 of the vorticity within a factor of 5 of the JAX
    package's fast run (MM_MODE = "bf16", FUSEKB auto: half) against its
    strict one, and above 1e-7 (fast is not quietly strict)."""
    cfg = CFG.replace(beta=1e-11)
    v0 = makefields.gaussian(cfg)
    src = (1e-9 * np.random.default_rng(3).standard_normal(
        cfg.grid_shape)).astype(np.float32)
    monkeypatch.setattr(pf, "FUSEKB", "auto")
    j_strict = _jax_segment(cfg, v0, src, 3)
    monkeypatch.setattr(pf, "MM_MODE", "bf16")
    assert pf.fusekb_mode() == "half"
    j_fast = _jax_segment(cfg, v0, src, 3)
    p_strict = _port_segment(cfg, v0, src, 3)
    p_fast = _port_segment(cfg, v0, src, 3, fast=True)
    jax, port = _rel(j_fast, j_strict), _rel(p_fast, p_strict)
    assert port > 1e-7, port
    assert 1.0 / FACTOR < port / jax < FACTOR, (port, jax)


def test_converters_carry_a_jax_state_into_the_fast_run():
    """A JAX state and tables carried across as numpy (convert.py) are the
    port's bit for bit, and the fast run from them is the fast run from
    the port's own."""
    from xlab_fftbarotropic_tpu.ops.spectral import SpectralTables as JT

    cfg = CFG.replace(beta=1e-11)
    jm = jbt.BarotropicModel.build(cfg)
    z = np.asarray(jm.init_state(makefields.gaussian(cfg)))
    jt = JT.from_config(cfg)
    tables = convert.tables_from_numpy(
        {k: np.asarray(getattr(jt, k)) for k in ("kx", "ky", "lap",
                                                 "inv_lap", "mask", "rlap")},
        CPU)
    zr, zi = convert.state_from_numpy(z, CPU)
    np.testing.assert_array_equal(convert.state_to_numpy(zr, zi), z)
    carried = tbt.BarotropicModel.build(cfg, CPU, tables=tables, fast=True)
    own = tbt.BarotropicModel.build(cfg, CPU, fast=True)
    for k in ("kx", "ky", "lap", "mask", "rlap"):
        assert torch.equal(getattr(carried.step_tables, k),
                           getattr(own.step_tables, k)), k
    src = own.zero_source()
    state = torch.complex(zr, zi)
    assert torch.equal(carried.segment(state, src, 2),
                       own.segment(state, src, 2))


def test_fast_model_selects_the_half_arm_and_counts_nothing_on_the_cpu():
    """fast=True resolves fusekb to "half" and runs the four fast forms
    (their plain versions on the CPU: no launch counted), differing from
    the strict half arm; on the library path fast changes nothing."""
    cfg = CFG.replace(beta=1e-11)
    m = tbt.BarotropicModel.build(cfg, CPU, fast=True)
    assert m.fast and m.fusion == dict(fusekb="half", fusekx=True)
    assert tbt.BarotropicModel.build(cfg, CPU).fusion["fusekb"] == ""
    z = m.init_state(makefields.gaussian(cfg))
    ff.reset_launches()
    a = m.segment(z, m.zero_source(), 1)
    assert set(ff.LAUNCHES.values()) == {0}
    half = tbt.BarotropicModel.build(cfg, CPU, fusekb="half")
    assert not torch.equal(a, half.segment(z, m.zero_source(), 1))
    lib = cfg.replace(fft_backend="xla")
    fl = tbt.BarotropicModel.build(lib, CPU, fast=True)
    assert not fl.fast
    assert torch.equal(fl.segment(z, m.zero_source(), 1),
                       tbt.BarotropicModel.build(lib, CPU).segment(
                           z, m.zero_source(), 1))
    assert "fast" in tbt.fusion_arm(fusekb="half", fast=True)


@pytest.mark.parametrize("kw", [dict(yfirst=False), dict(quad_mode="quad")],
                         ids=str)
def test_fast_model_refuses_what_waits(kw):
    """The x-first order and QUAD_MODE quad, which waited for item 4.4,
    now build in fast mode and step once on the x-first fast forms (their
    plain versions on the CPU), apart from the strict x-first run."""
    m = tbt.BarotropicModel.build(CFG, CPU, fast=True, **kw)
    assert m.fast and not m.yfirst
    assert "fast: " in tbt.fusion_arm(fast=True, yfirst=m.yfirst,
                                      quad_mode=m.quad_mode)
    z = m.init_state(makefields.gaussian(CFG))
    a = m.segment(z, m.zero_source(), 1)
    assert bool(torch.isfinite(m.diags(a).vort).all())
    strict = tbt.BarotropicModel.build(CFG, CPU, **kw)
    assert not torch.equal(a, strict.segment(z, m.zero_source(), 1))


ARM_CFG = CFG.replace(beta=1e-11)


def _arm_state(cfg, steps=2, **kw):
    m = tbt.BarotropicModel.build(cfg, CPU, fast=True, **kw)
    src = torch.from_numpy((1e-9 * np.random.default_rng(5).standard_normal(
        cfg.grid_shape)).astype(np.float32))
    return m.segment(m.init_state(makefields.gaussian(cfg)), src, steps)


@pytest.fixture(scope="module")
def fast_half():
    """The fast FUSEKB=half arm's 2-step 64^2 state (forced, beta-plane),
    RK4 and ETDRK4."""
    return {"rk4": _arm_state(ARM_CFG),
            "etdrk4": _arm_state(ARM_CFG.replace(time_scheme="etdrk4"))}


@pytest.mark.parametrize("kw", [dict(fusekb=""), dict(fusekb="full"),
                                dict(fusekx=False), dict(fusetail=True),
                                dict(fused_rk=False), dict(etd=True)],
                         ids=str)
def test_fast_arm_is_the_half_arm_bit_for_bit(fast_half, monkeypatch, kw):
    """Every other y-first arm in fast mode gives the fast half arm's bits
    after 2 steps at 64^2, as every strict arm gives the strict default's
    (each fast form shares its transform and rounding with the half
    arm's). ETDRK4 (its "" and full arms the half arm's bits too): the
    port's fast run against its strict run within a factor of 5 of the
    JAX package's fast ETDRK4 (MM_MODE = "bf16") against its strict one,
    and above 1e-7."""
    kw = dict(kw)
    if not kw.pop("etd", False):
        assert torch.equal(_arm_state(ARM_CFG, **kw), fast_half["rk4"])
        return
    cfg = ARM_CFG.replace(time_scheme="etdrk4")
    for arm in ("", "full"):
        assert torch.equal(_arm_state(cfg, fusekb=arm), fast_half["etdrk4"])
    v0 = makefields.gaussian(cfg)
    src = (1e-9 * np.random.default_rng(5).standard_normal(
        cfg.grid_shape)).astype(np.float32)
    monkeypatch.setattr(pf, "FUSEKB", "auto")
    j_strict = _jax_segment(cfg, v0, src, 2)
    monkeypatch.setattr(pf, "MM_MODE", "bf16")
    j_fast = _jax_segment(cfg, v0, src, 2)
    p_fast = np.fft.irfft2(fast_half["etdrk4"].numpy(), s=cfg.grid_shape)
    p_strict = _port_segment(cfg, v0, src, 2)
    jax, port = _rel(j_fast, j_strict), _rel(p_fast, p_strict)
    assert port > 1e-7, port
    assert 1.0 / FACTOR < port / jax < FACTOR, (port, jax)


def _run_cli(tmp_path, *extra):
    from xlab_fftbarotropic_torch.cli import run as cli_run
    from xlab_fftbarotropic_torch.io.fieldio import write_field

    inp = tmp_path / "in"
    inp.mkdir(exist_ok=True)
    write_field(inp / CFG.init_file, makefields.gaussian(CFG))
    return cli_run.main(["-I", str(inp), "-O", str(tmp_path / "out"),
                         "--nx", str(N), "--ny", str(N), "--total-steps",
                         "2", "--record-step", "2", "--manifest",
                         str(tmp_path / "log"), "--device", "cpu",
                         "--fast-transforms", *extra])


def test_cli_runs_fast_mode_and_prints_its_banner(tmp_path, monkeypatch,
                                                  capsys):
    """xfb-torch-run --fast-transforms --device cpu builds the model with
    fast=True (FUSEKB=auto: half), writes the records and the manifest in
    the reference's format and prints the fast banner."""
    from xlab_fftbarotropic_torch import runner

    for k in ("XFB_BT_FUSEKB", "XFB_BT_FUSEKX", "XFB_BT_FUSETAIL",
              "XFB_BT_FUSED_RK", "XFB_BT_YFIRST"):
        monkeypatch.delenv(k, raising=False)
    built = []
    real = runner.BarotropicModel.build
    monkeypatch.setattr(runner.BarotropicModel, "build",
                        lambda *a, **k: built.append(k) or real(*a, **k))
    assert _run_cli(tmp_path) == 0
    assert built == [dict(yfirst=True, fused_rk=True, fusekb="half",
                          fusekx=True, fusetail=False, fast=True)]
    err = capsys.readouterr().err
    assert "# fast transforms: bf16 tensor-core sub-DFTs" in err
    assert "Fusion arm            : fast: ka_diag, kb_pair + kb_adv_half" \
        in err
    for name in ("vort", "psi", "u", "v"):
        for step in (0,):
            f = tmp_path / "out" / f"{name}_step_{step}.bin"
            assert f.stat().st_size == N * N * 4
    lines = (tmp_path / "log").read_text().splitlines()
    assert lines and all(line.split()[0].endswith(".bin") or "step" in line
                         for line in lines)


def test_cli_fast_mode_on_the_library_path_stays_float32(tmp_path, capsys):
    assert _run_cli(tmp_path, "--fft-backend", "xla") == 0
    assert "library path in float32" in capsys.readouterr().err


# each arm's CLI run, its environment and the banner line it prints
CLI_ARMS = [
    (["-m", "tracer"], {}, "# tracer fast mode: ka6, kb_pair, "
                           "kb_adv_tracer and kx_visc on the fast tile"),
    (["--time-scheme", "etdrk4"], {},
     "Fusion arm            : fast: ka_diag, kb_pair + kb_adv_half, "
     "kx_visc (bf16"),
    ([], {"XFB_BT_FUSEKB": "0"},
     "Fusion arm            : fast: ka_diag, kb_pair x2 + ky_adv, kx_visc, "
     "rk4_combine"),
    ([], {"XFB_BT_FUSEKB": "full"},
     "Fusion arm            : fast: ka_diag, kb_adv_full, kx_visc, "
     "rk4_combine"),
    ([], {"XFB_BT_FUSEKX": "0"},
     "Fusion arm            : fast: ka_diag, kb_pair + kb_adv_half, "
     "kx_fwd + visc, rk4_combine"),
    ([], {"XFB_BT_FUSETAIL": "1"},
     "Fusion arm            : fast: ka_diag, kb_pair + kb_adv_half, "
     "kx_visc, kx_visc_tail"),
    ([], {"XFB_BT_FUSED_RK": "0"},
     "Fusion arm            : fast: ka_diag, kb_pair + kb_adv_half, "
     "kx_visc, torch stage updates")]


@pytest.mark.parametrize("extra,env,line", CLI_ARMS,
                         ids=lambda v: " ".join(v) if isinstance(v, list)
                         else str(v) if isinstance(v, dict) else "")
def test_cli_fast_mode_runs_every_arm(tmp_path, monkeypatch, capsys, extra,
                                      env, line):
    """-m tracer, --time-scheme etdrk4 and the five XFB_BT_* arms run in
    fast mode through the CLI, write their records and print their arm's
    banner line."""
    for k in ("XFB_BT_FUSEKB", "XFB_BT_FUSEKX", "XFB_BT_FUSETAIL",
              "XFB_BT_FUSED_RK", "XFB_BT_YFIRST"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert _run_cli(tmp_path, *extra) == 0
    err = capsys.readouterr().err
    assert line in err
    assert "# fast transforms: bf16 tensor-core sub-DFTs" in err
    f = tmp_path / "out" / "vort_step_0.bin"
    assert f.stat().st_size == N * N * 4


@pytest.mark.parametrize("extra,env", [
    (["-m", "sw"], {"XFB_SW_YFIRST": "0"}), (["-m", "fd"], {}),
    (["--shard"], {}), (["--ensemble", "2"], {}),
    ([], {"XFB_BT_YFIRST": "0"}), (["-m", "tracer", "--ensemble", "2"], {}),
    (["-m", "tracer", "--shard"], {})],
    ids=lambda v: " ".join(v) if isinstance(v, list) else str(v))
def test_cli_fast_mode_refuses_what_waits(tmp_path, monkeypatch, capsys,
                                          extra, env):
    """Every flag set fast mode once refused runs now (the x-first order,
    -m fd, --shard, --ensemble, for the tracer too), with the banner of
    what it runs on the fast tile or of what fast mode leaves as it is,
    and writes its records; the sharded tracer, which once stopped
    naming item 5.1, runs too: on the overlap impl with the fast
    x-stages' banner and the sharded tracer's line."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if extra == ["-m", "tracer", "--shard"]:
        assert _run_cli(tmp_path, *extra, "--shard-fft", "overlap") == 0
        err = capsys.readouterr().err
        assert "in the overlap x-stages (xstage)" in err
        assert "# sharded tracer: 20-step rel-L2" in err
        f = tmp_path / "out" / "q_step_0.bin"
        assert f.stat().st_size == N * N * 4
        return
    sw = "XFB_SW_YFIRST" in env
    assert _run_cli(tmp_path, *extra, *(["--dt", "1"] if sw else [])) == 0
    err = capsys.readouterr().err
    if "0" in (env.get("XFB_BT_YFIRST"), env.get("XFB_SW_YFIRST")):
        assert "# fast transforms: bf16 tensor-core sub-DFTs" in err
        assert "Transform order       : x-first" in err
        assert ("SW formulation        : fast" if sw else
                "Fusion arm            : fast: ka_diag, kb x2, ka_adv, "
                "kc_visc, torch stage updates") in err
    elif "--ensemble" in extra:
        # 64^2 takes one batched chunk of both members (auto width)
        assert "batched ensemble chunks (width > 1) run the torch.fft" in err
    elif "--shard" in extra:
        assert "--shard-fft xla runs torch.fft x-stages" in err
    else:
        assert "# fast transforms: bf16 tensor-core sub-DFTs" in err
        assert "the FD core (Arakawa Jacobian, FFT Poisson solve) runs " \
               "torch.fft" in err
    out = tmp_path / "out"
    records = ([out / k / "vort_step_0.bin" for k in ("m00", "m01")]
               if "--ensemble" in extra else [out / "vort_step_0.bin"])
    for f in records:
        assert f.stat().st_size == N * N * 4


def test_assimilate_refuses_fast_mode(tmp_path, capsys):
    """xfb-torch-assimilate --fast-transforms, which waited for item 4.5,
    runs: the JAX CLI's banner, the recovered field and a finite cost
    history whose last cost is below the first (a 64^2 twin problem on
    the fast plain versions, 2 steps, 3 Adam iterations)."""
    from xlab_fftbarotropic_torch import adjoint as tadj
    from xlab_fftbarotropic_torch.cli import assimilate
    from xlab_fftbarotropic_torch.io.fieldio import read_field, write_field

    truth = makefields.gaussian(CFG)
    target = tadj.make_rollout(CFG, 2, device=CPU)(truth, np.zeros(
        (N, N), np.float32)).detach().numpy()
    write_field(tmp_path / "t.bin", target)
    write_field(tmp_path / "g.bin", 0.9 * truth)
    out = tmp_path / "o.bin"
    assert assimilate.main(["--nx", str(N), "--ny", str(N), "--dt", "3",
                            "--target", str(tmp_path / "t.bin"), "--guess",
                            str(tmp_path / "g.bin"), "--out", str(out),
                            "--steps", "2", "--iters", "3", "--lr", "1e-5",
                            "--device", "cpu", "--fast-transforms"]) == 0
    err = capsys.readouterr().err
    assert "# fast transforms: bf16 tensor-core sub-DFTs" in err
    assert "in both sweeps" in err
    assert read_field(out, (N, N)).shape == (N, N)
    losses = np.loadtxt(f"{out}.loss.txt")
    assert losses.shape == (4,) and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
