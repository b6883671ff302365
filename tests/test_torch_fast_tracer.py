"""The tracer's fast mode in the port (the JAX package's --fast-transforms
for -m tracer): the fast plain versions of ka6 and kb_adv_tracer (the
strict plain versions' loads and epilogues around ops/fast_tile.py's
emulation of the fast column tile) against float64 and against the JAX
package's own bf16 rounding (pallas_fft.MM_MODE = "bf16" in interpret
mode, set by monkeypatch, as tests/test_torch_fast.py does); fast RK4 and
ETDRK4 segments of each package against its own strict run, zeta and q
held apart (q's tendency is about 1e4 smaller in bench.py's
configuration); the converters carrying a JAX tracer state into the fast
run; the model's and the CLI's fast selection. 64^2, a few steps.

Bars: a fast form's rel-L2 against float64 lies in 1e-4 .. 1e-2 and
within a factor of 5 either way of the JAX package's, each output plane
apart; a fast segment's zeta and q rel-L2 against its strict run lie
within a factor of 5 of the JAX package's and above 1e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.models import tracer as jtr
from xlab_fftbarotropic_tpu.ops import pallas_fft as pf
from xlab_fftbarotropic_tpu.ops import pallas_tracer as pt
from xlab_fftbarotropic_tpu.ops.spectral import SpectralTables as JT
from xlab_fftbarotropic_torch import convert
from xlab_fftbarotropic_torch.models import tracer as ttr
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.ops import fused_tracer as ft
from torch_threads import _one_thread  # noqa: F401

N = 64
HNY = N // 2 + 1
# bench.py's tracer configuration at 64^2 ("pallas": the JAX package's
# "auto" takes its library path on the CPU): kappa 50, dt 3 s
CFG = ModelConfig(nx=N, ny=N, fft_backend="pallas")
ETD = CFG.replace(time_scheme="etdrk4")
KAPPA = 50.0
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


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def f(*shape, size=1.0):
        return (size * rng.standard_normal(shape)).astype(np.float32)
    return dict(sr2=f(2, N, HNY), si2=f(2, N, HNY), kx=f(N), ky=f(HNY),
                rlap=f(N, HNY), wr=f(6, HNY, N, size=N * 8.0),
                wi=f(6, HNY, N, size=N * 8.0), zx=f(N, N), zy=f(N, N),
                qx=f(N, N), qy=f(N, N), src=f(N, N))


def _hermitian64(ar, ai, br, bi):
    a = ar.astype(np.float64) + 1j * ai
    b = br.astype(np.float64) + 1j * bi
    for x in (a, b):
        x[0].imag = 0.0
        x[-1].imag = 0.0
    full = np.concatenate([a, np.conj(a[-2:0:-1])])
    return full + 1j * np.concatenate([b, np.conj(b[-2:0:-1])])


def _reference(name, d):
    """The float64 function of each fast form, one complex plane per
    output field."""
    if name == "ka6":
        k = d["kx"].astype(np.float64)[:, None]
        q = d["ky"].astype(np.float64)[None, :]
        z, s = (d["sr2"][i].astype(np.float64) + 1j * d["si2"][i]
                for i in (0, 1))
        psi = z * d["rlap"]
        fields = [1j * k * z, 1j * q * z, -1j * q * psi, 1j * k * psi,
                  1j * k * s, 1j * q * s]
        return [np.fft.ifft(f, axis=0).T * N for f in fields]
    c = _hermitian64(d["wr"][2], d["wi"][2], d["wr"][3], d["wi"][3])
    y = np.fft.ifft(c, axis=0) / N
    u, v = y.real, y.imag
    adv_z = -u * d["zx"] - v * (d["zy"] + 0.3) + d["src"]
    adv_q = -u * d["qx"] - v * d["qy"]
    return [np.fft.rfft(a, axis=0).T for a in (adv_z, adv_q)]


def _planes(out):
    """A stacked (re, im) result as one complex plane per field."""
    re, im = (np.asarray(x, np.float64) for x in out)
    return [re[f] + 1j * im[f] for f in range(re.shape[0])]


def _port(name, d, fast):
    t = dict(zip(d, _t(*d.values())))
    if name == "ka6":
        return ft.tracer_xstage_planes(t["sr2"], t["si2"], t["kx"], t["ky"],
                                       t["rlap"], fast=fast)
    return ft.kb_adv_tracer(t["zx"], t["zy"], t["qx"], t["qy"], t["wr"],
                            t["wi"], t["src"], 0.3, fast=fast)


def _jax(name, d):
    j = {k: jnp.asarray(v) for k, v in d.items()}
    if name == "ka6":
        return pt.tracer_xstage_planes(j["sr2"], j["si2"], j["kx"], j["ky"],
                                       j["rlap"], (N, N))
    return pt.kb_adv_tracer(j["zx"], j["zy"], j["qx"], j["qy"], j["wr"],
                            j["wi"], j["src"], (N, N), 0.3)


@pytest.mark.parametrize("name", ["ka6", "kb_adv_tracer"])
def test_fast_tracer_form_rounds_in_the_jax_bf16_class(monkeypatch, name):
    """Each fast tracer form against float64, output field by output
    field (kb_adv_tracer's zeta and q planes apart): rel-L2 in
    1e-4 .. 1e-2, within a factor of 5 of the JAX kernel's under
    MM_MODE = "bf16" on the same input; the strict plain version below
    1e-6."""
    monkeypatch.setattr(pf, "MM_MODE", "bf16")
    d = _inputs(list(ff.LAUNCHES).index(name + "_fast"))
    want = _reference(name, d)
    fast = _planes(_port(name, d, True))
    strict = _planes(_port(name, d, False))
    jax = _planes(_jax(name, d))
    for f, w in enumerate(want):
        e_fast, e_jax = _rel(fast[f], w), _rel(jax[f], w)
        assert 1e-4 < e_fast < 1e-2, (f, e_fast)
        assert 1.0 / FACTOR < e_fast / e_jax < FACTOR, (f, e_fast, e_jax)
        assert _rel(strict[f], w) < 1e-6, f


def _ic(cfg):
    return makefields.gaussian(cfg), jtr.tracer_ic(cfg, "gaussian")


def _jax_segment(cfg, steps):
    m = jtr.TracerModel.build(cfg, kappa=KAPPA)
    s = m.segment(m.init_state(*_ic(cfg)),
                  jnp.zeros(cfg.grid_shape, jnp.float32), steps)
    return [np.fft.irfft2(np.asarray(z), s=cfg.grid_shape) for z in s]


def _port_segment(cfg, steps, **kw):
    m = ttr.TracerModel.build(cfg, CPU, kappa=KAPPA, **kw)
    s = m.segment(m.init_state(*_ic(cfg)), m.zero_source(), steps)
    return [np.fft.irfft2(z.numpy(), s=cfg.grid_shape) for z in s]


@pytest.fixture(scope="module")
def segments():
    """Each package's strict and fast tracer run of both schemes (the
    gaussian flow and tracer, zero forcing), once: physical (zeta, q)."""
    out = {}
    for cfg, steps in ((CFG, RK4_STEPS), (ETD, ETD_STEPS)):
        scheme = cfg.time_scheme
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pf, "FUSEKB", "auto")
            out["jax", scheme, False] = _jax_segment(cfg, steps)
            mp.setattr(pf, "MM_MODE", "bf16")
            out["jax", scheme, True] = _jax_segment(cfg, steps)
        out["port", scheme, False] = _port_segment(cfg, steps)
        out["port", scheme, True] = _port_segment(cfg, steps, fast=True)
    return out


@pytest.mark.parametrize("scheme", ["rk4", "etdrk4"])
def test_fast_tracer_segment_error_matches_the_jax_fast_mode(segments,
                                                             scheme):
    """3 RK4 steps (2 ETDRK4 steps) of bench.py's tracer configuration at
    64^2: the port's fast run against its strict run, rel-L2 of zeta and
    of q each within a factor of 5 of the JAX package's fast run against
    its strict one, and above 1e-7 (fast is not quietly strict)."""
    for i, name in enumerate(("zeta", "q")):
        jax = _rel(segments["jax", scheme, True][i],
                   segments["jax", scheme, False][i])
        port = _rel(segments["port", scheme, True][i],
                    segments["port", scheme, False][i])
        assert port > 1e-7, (name, port)
        assert 1.0 / FACTOR < port / jax < FACTOR, (name, port, jax)


def test_converters_carry_a_jax_tracer_state_into_the_fast_run():
    """A JAX tracer state and tables carried across as numpy (convert.py)
    are the port's bit for bit, and the fast run from them is the fast
    run from the port's own."""
    jm = jtr.TracerModel.build(CFG, kappa=KAPPA)
    packed = np.stack([np.asarray(z) for z in jm.init_state(*_ic(CFG))])
    jt = JT.from_config(CFG)
    tables = convert.tables_from_numpy(
        {k: np.asarray(getattr(jt, k)) for k in ("kx", "ky", "lap",
                                                 "inv_lap", "mask", "rlap")},
        CPU)
    state = convert.tracer_state_from_numpy(packed, CPU)
    np.testing.assert_array_equal(convert.tracer_state_to_numpy(state),
                                  packed)
    carried = ttr.TracerModel.build(CFG, CPU, kappa=KAPPA, tables=tables,
                                    fast=True)
    own = ttr.TracerModel.build(CFG, CPU, kappa=KAPPA, fast=True)
    assert torch.equal(carried.lap2, own.lap2)
    src = own.zero_source()
    a, b = carried.segment(state, src, 2), own.segment(state, src, 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_fast_tracer_model_counts_nothing_on_the_cpu(segments):
    """fast=True runs the four fast forms (their plain versions on the
    CPU: no launch counted) and differs from the strict run; on the
    library path fast changes nothing."""
    m = ttr.TracerModel.build(CFG, CPU, kappa=KAPPA, fast=True)
    assert m.fast
    ff.reset_launches()
    got = [np.fft.irfft2(z.numpy(), s=CFG.grid_shape) for z in m.segment(
        m.init_state(*_ic(CFG)), m.zero_source(), RK4_STEPS)]
    assert set(ff.LAUNCHES.values()) == {0}
    for g, w in zip(got, segments["port", "rk4", True]):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[1], segments["port", "rk4", False][1])
    lib = CFG.replace(fft_backend="xla")
    fl = ttr.TracerModel.build(lib, CPU, kappa=KAPPA, fast=True)
    assert not fl.fast
    s0 = fl.init_state(*_ic(lib))
    a = fl.segment(s0, fl.zero_source(), 1)
    b = ttr.TracerModel.build(lib, CPU, kappa=KAPPA).segment(
        s0, fl.zero_source(), 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(TypeError):
        ttr.TracerModel.build(CFG, CPU, fast=1)


@pytest.mark.parametrize("scheme", ["rk4", "etdrk4"])
def test_cli_runs_tracer_fast_mode_and_prints_its_banner(tmp_path,
                                                         monkeypatch,
                                                         capsys, scheme):
    """xfb-torch-run -m tracer --fast-transforms --device cpu builds
    TracerModel with fast=True, writes the vort and q records and the
    manifest, and prints the fast banner and its tracer line."""
    from xlab_fftbarotropic_torch import runner
    from xlab_fftbarotropic_torch.cli import run as cli_run
    from xlab_fftbarotropic_torch.io.fieldio import write_field

    built = []
    real = runner.TracerModel.build
    monkeypatch.setattr(runner.TracerModel, "build",
                        lambda *a, **k: built.append(k) or real(*a, **k))
    inp = tmp_path / "in"
    inp.mkdir()
    write_field(inp / CFG.init_file, makefields.gaussian(CFG))
    assert cli_run.main([
        "-I", str(inp), "-O", str(tmp_path / "out"), "--nx", str(N),
        "--ny", str(N), "--total-steps", "2", "--record-step", "2",
        "--manifest", str(tmp_path / "log"), "--device", "cpu", "-m",
        "tracer", "--tracer-kappa", "50", "--tracer-ic", "gaussian",
        "--time-scheme", scheme, "--fast-transforms"]) == 0
    assert built == [dict(kappa=50.0, fast=True)]
    err = capsys.readouterr().err
    assert "# fast transforms: bf16 tensor-core sub-DFTs" in err
    assert "# tracer fast mode: ka6, kb_pair, kb_adv_tracer" in err
    assert "Fusion arm" not in err
    for name in ("vort", "psi", "u", "v", "q"):
        f = tmp_path / "out" / f"{name}_step_0.bin"
        assert f.stat().st_size == N * N * 4
    lines = (tmp_path / "log").read_text().splitlines()
    assert len(lines) == 6 and lines[-1].endswith("q_step_0.bin")
