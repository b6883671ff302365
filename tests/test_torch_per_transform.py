"""The port's per-transform kernel pipeline (ops/fused_fft.py: kb, rfft2,
inverse_pair, irfft2), its adjoints (ops/fused_diff.py), the shallow-water
RK4 step with drag or hyperviscosity on it and the unfused SW RK4 form
(plane_axpy), against the JAX package on the CPU.

The port runs on CPU tensors, so the kernels' plain torch versions run;
the JAX Pallas functions run in interpret mode, as the JAX package's own
tests run them.

Bars: 2e-6 rel-L2 for kb and the transforms (tests/test_pallas_fft.py's
transform bars); 1e-5 rel-L2 for the vector-Jacobian products (as
tests/test_pallas_diff.py); the SW bars, 1e-5 after one step and 2e-4
after 20 of max |field| in physical space, div over max(|div|, |zeta|)
(tests/test_pallas_sw.py:126-183); plane_axpy bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.models import shallow_water as jsw
from xlab_fftbarotropic_tpu.ops import fft as jfft
from xlab_fftbarotropic_tpu.ops import pallas_diff as pd
from xlab_fftbarotropic_tpu.ops import pallas_fft as pf
from xlab_fftbarotropic_tpu.ops.spectral import SpectralTables as JT
from xlab_fftbarotropic_torch.models import barotropic as tbt
from xlab_fftbarotropic_torch.models import shallow_water as tsw
from xlab_fftbarotropic_torch.ops import fft as tfft
from xlab_fftbarotropic_torch.ops import fused_diff as fd
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.ops import fused_sw as fs
from xlab_fftbarotropic_torch.ops.spectral import SpectralTables as TT
from torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")
SIZES = [64, 128]
STEPS = 20


def _rel(got, want):
    got, want = np.ravel(np.asarray(got)), np.ravel(np.asarray(want))
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _c64(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ---------------------------------------------------------------- kb

@pytest.mark.parametrize("n", SIZES)
def test_kb_plain_matches_kb_call(n):
    """Random x-stage planes: the self-conjugate rows 0 and n/2 carry
    imaginary junk (not Hermitian), which both project out."""
    rng = np.random.default_rng(n)
    w = [_f32(rng, (n // 2 + 1, n)) for _ in range(4)]
    scale = 1.0 / (n * n)
    want = pf._kb_call((jnp.asarray(w[0]), jnp.asarray(w[1])),
                       (jnp.asarray(w[2]), jnp.asarray(w[3])), n, scale)
    got = ff.kb(*(torch.from_numpy(a) for a in w), scale)
    for g, x in zip(got, want):
        assert g.shape == (n, n)
        assert _rel(g, x) < 2e-6
    single, none = ff.kb(torch.from_numpy(w[0]), torch.from_numpy(w[1]),
                         None, None, scale)
    assert none is None
    want_a = pf._kb_call((jnp.asarray(w[0]), jnp.asarray(w[1])),
                         (jnp.zeros_like(w[2]), jnp.zeros_like(w[3])), n,
                         scale)[0]
    assert _rel(single, want_a) < 2e-6


def test_kb_leak_guard_and_dispatch():
    """Junk in the self-conjugate rows' imaginary part changes nothing;
    a CPU tensor counts no launch; wrong shapes and a lone b plane
    raise."""
    n = 64
    rng = np.random.default_rng(7)
    w = [torch.from_numpy(_f32(rng, (n // 2 + 1, n))) for _ in range(4)]
    poisoned = [a.clone() for a in w]
    for k in (1, 3):
        poisoned[k][0] *= 10.0
        poisoned[k][n // 2] *= -7.0
    ff.reset_launches()
    for a, b in zip(ff.kb(*w, 1.0), ff.kb(*poisoned, 1.0)):
        assert torch.equal(a, b)
    assert ff.LAUNCHES["kb"] == 0
    with pytest.raises(ValueError):
        ff.kb(w[0], w[1], w[2][:-1], w[3][:-1], 1.0)
    with pytest.raises(ValueError, match="both"):
        ff.kb(w[0], w[1], w[2], None, 1.0)


# ------------------------------------------------------- the composites

@pytest.mark.parametrize("n", SIZES)
def test_transforms_match_pallas(n):
    """rfft2, inverse_pair and irfft2 on the kernels' plain versions
    against pallas_fft's (interpret mode), on non-Hermitian spectra."""
    rng = np.random.default_rng(n + 1)
    g = (n, n)
    x = _f32(rng, g)
    sa, sb = _c64(rng, (n, n // 2 + 1)), _c64(rng, (n, n // 2 + 1))
    assert _rel(ff.rfft2(torch.from_numpy(x)), pf.rfft2(jnp.asarray(x))) \
        < 2e-6
    want = pf.inverse_pair(jnp.asarray(sa), jnp.asarray(sb), g)
    got = ff.inverse_pair(torch.from_numpy(sa), torch.from_numpy(sb), g)
    for a, b in zip(got, want):
        assert a.shape == g and _rel(a, b) < 2e-6
    assert _rel(ff.irfft2(torch.from_numpy(sa), g),
                pf.irfft2(jnp.asarray(sa), g)) < 2e-6


def test_transforms_match_the_library():
    """The composites are the ops/fft.py functions (torch.fft)."""
    n = 64
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_f32(rng, (n, n)))
    sa, sb = (torch.from_numpy(_c64(rng, (n, n // 2 + 1))) for _ in range(2))
    assert _rel(ff.rfft2(x), tfft.forward(x)) < 2e-6
    for a, b in zip(ff.inverse_pair(sa, sb, (n, n)),
                    tfft.inverse_pair(sa, sb, (n, n))):
        assert _rel(a, b) < 2e-6
    assert _rel(ff.irfft2(sa, (n, n)), tfft.inverse(sa, (n, n))) < 2e-6


def test_tendency_pairs_through_inv_without_inv_pair():
    """inv_pair None pairs the inverse transforms through two calls of
    inv (the JAX tendencies' rule), to round-off of the paired form."""
    cfg = ModelConfig(nx=64, ny=64)
    t = TT.from_config(cfg, CPU)
    rng = np.random.default_rng(9)
    z = tfft.forward(torch.from_numpy(1e-4 * _f32(rng, (64, 64))))
    src = torch.zeros(64, 64)
    for fwd, inv, pair in (tbt.resolve_fft_backend("xla", (64, 64)),
                           tbt.resolve_fft_backend("pallas", (64, 64))):
        want = tbt.tendency(t, z, src, 6.5, (64, 64), fwd=fwd, inv=inv,
                            inv_pair=pair)
        got = tbt.tendency(t, z, src, 6.5, (64, 64), fwd=fwd, inv=inv,
                           inv_pair=None)
        assert _rel(got, want) < 2e-6


def test_resolve_fft_backend():
    g = (64, 64)
    assert tbt.resolve_fft_backend("xla", g) == (
        tfft.forward, tfft.inverse, tfft.inverse_pair)
    assert tbt.resolve_fft_backend("auto", g) == (
        ff.rfft2, ff.irfft2, ff.inverse_pair)
    assert tbt.resolve_fft_backend("pallas", g, differentiable=True) == (
        fd.forward, fd.inverse, fd.inverse_pair)
    assert tbt.resolve_fft_backend("auto", (96, 96))[0] is tfft.forward


# ------------------------------------------------------------- adjoints

def _vjp_inputs(seed):
    n = 64
    rng = np.random.default_rng(seed)
    x = _f32(rng, (n, n))
    ct = _c64(rng, (n, n // 2 + 1))
    spec = [np.asarray(jfft.forward(jnp.asarray(_f32(rng, (n, n)))))
            for _ in range(2)]
    u = [_f32(rng, (n, n)) for _ in range(2)]
    return (n, n), x, ct, spec, u


def _torch_vjp(fn, inputs, cts):
    ins = [torch.from_numpy(np.array(a)).requires_grad_(True)
           for a in inputs]
    out = fn(*ins)
    out = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(out, ins, [torch.from_numpy(np.array(c))
                                          for c in cts])


def test_vjps_match_pallas_diff():
    """torch's complex gradient is the conjugate of JAX's cotangent: the
    port's VJP under g equals pallas_diff's under conj(g), and its
    gradient for a complex input is the conjugate of JAX's."""
    g, x, ct, spec, u = _vjp_inputs(0)
    _, vjp = jax.vjp(pd.forward, jnp.asarray(x))
    want = vjp(jnp.conj(jnp.asarray(ct)))[0]
    assert _rel(_torch_vjp(fd.forward, [x], [ct])[0], want) < 1e-5

    _, vjp = jax.vjp(lambda s: pd.inverse(s, g), jnp.asarray(spec[0]))
    want = np.conj(np.asarray(vjp(jnp.asarray(u[0]))[0]))
    got = _torch_vjp(lambda s: fd.inverse(s, g), spec[:1], u[:1])[0]
    assert _rel(got, want) < 1e-5

    _, vjp = jax.vjp(lambda a, b: pd.inverse_pair(a, b, g),
                     *(jnp.asarray(s) for s in spec))
    want = vjp(tuple(jnp.asarray(a) for a in u))
    got = _torch_vjp(lambda a, b: fd.inverse_pair(a, b, g), spec, u)
    for a, b in zip(got, want):
        assert _rel(a, np.conj(np.asarray(b))) < 1e-5


def test_vjps_match_torch_fft_autograd():
    g, x, ct, spec, u = _vjp_inputs(1)
    for mine, lib, ins, cts in (
            (fd.forward, tfft.forward, [x], [ct]),
            (lambda s: fd.inverse(s, g), lambda s: tfft.inverse(s, g),
             spec[:1], u[:1]),
            (lambda a, b: fd.inverse_pair(a, b, g),
             lambda a, b: tfft.inverse_pair(a, b, g), spec, u)):
        for a, b in zip(_torch_vjp(mine, ins, cts),
                        _torch_vjp(lib, ins, cts)):
            assert _rel(a, b) < 1e-5
    # no tensor is saved for the backward sweep
    s = torch.from_numpy(np.array(spec[0])).requires_grad_(True)
    out = fd.inverse(s, g)
    assert out.grad_fn.saved_tensors == ()
    ff.reset_launches()
    out.sum().backward()
    assert sum(ff.LAUNCHES.values()) == 0     # CPU: the plain versions


# ------------------------------------------ shallow water, drag and nu4

N_SW = 64


def _sw_cfg(**kw):
    kw.setdefault("nx", N_SW)
    kw.setdefault("ny", N_SW)
    kw.setdefault("dt", 1.0)
    return ModelConfig(**kw)


def _np_state(s):
    return tuple(z.numpy() if isinstance(z, torch.Tensor) else np.asarray(z)
                 for z in s)


def _phys_err(want, got, g):
    """Max abs error of zeta, div and eta in physical space over max
    |zeta|, max(|div|, |zeta|) and max |eta| of `want`."""
    a = [np.fft.irfft2(z, s=g) for z in _np_state(want)]
    b = [np.fft.irfft2(z, s=g) for z in _np_state(got)]
    nz = np.max(np.abs(a[0]))
    norms = (nz, max(np.max(np.abs(a[1])), nz), np.max(np.abs(a[2])))
    return [np.max(np.abs(x - y)) / max(m, 1e-12)
            for x, y, m in zip(a, b, norms)]


DRAG = {"drag": dict(r_drag=2e-4), "nu4": dict(nu4=1e9),
        "both": dict(r_drag=2e-4, nu4=1e9)}


def _one_and_more(m, s0, src):
    """The states after one step and after STEPS steps."""
    s1 = m.segment(s0, src, 1)
    return s1, m.segment(s1, src, STEPS - 1)


@pytest.fixture(scope="module")
def jax_drag_runs():
    """The JAX SW model on its library (xla) path with drag or
    hyperviscosity: the states after one and 20 steps from the balanced
    gaussian vortex, the runner's zero forcing held."""
    out = {}
    for name, kw in DRAG.items():
        m = jsw.ShallowWaterModel.build(_sw_cfg(fft_backend="xla", **kw))
        s0 = m.geostrophic_init(makefields.gaussian(_sw_cfg()))
        out[name] = [_np_state(s) for s in _one_and_more(m, s0,
                                                          m.zero_source())]
    return out


@pytest.mark.parametrize("name", list(DRAG))
def test_sw_drag_runs_the_per_transform_kernels(jax_drag_runs, name):
    """RK4 with r_drag or nu4 on the kernel backend, "auto" or an
    explicit "pallas": the per-transform path (no NotImplementedError,
    no library fallback) with the JAX warning, and the JAX library
    path's trajectory at the SW bars."""
    for backend in ("pallas", "auto"):
        cfg = _sw_cfg(fft_backend=backend, **DRAG[name])
        with pytest.warns(UserWarning, match="per-transform pipeline"):
            m = tsw.ShallowWaterModel.build(cfg, CPU)
        assert m.backend == "pallas" and m.per_transform
    s0 = m.geostrophic_init(makefields.gaussian(cfg))
    got = _one_and_more(m, s0, m.zero_source())
    for want, g, bar in zip(jax_drag_runs[name], got, (1e-5, 2e-4)):
        assert max(_phys_err(want, g, cfg.grid_shape)) < bar


def test_sw_drag_kernels_match_the_port_library_path():
    cfg = _sw_cfg(**DRAG["both"])
    with pytest.warns(UserWarning):
        m = tsw.ShallowWaterModel.build(cfg, CPU)
    lib = tsw.ShallowWaterModel.build(cfg.replace(fft_backend="xla"), CPU)
    assert lib.backend == "xla" and not lib.per_transform
    s0 = m.geostrophic_init(makefields.gaussian(cfg))
    src = m.zero_source()
    for want, got, bar in zip(_one_and_more(lib, s0, src),
                              _one_and_more(m, s0, src), (1e-5, 2e-4)):
        assert max(_phys_err(want, got, cfg.grid_shape)) < bar
    # the forcing reaches the per-transform path, and None skips it
    forced = m.step(s0, 1e-9 * torch.ones(cfg.grid_shape))
    unforced = m.step(s0, src)
    assert not torch.equal(forced.zeta_hat, unforced.zeta_hat)
    assert torch.equal(m.step(s0, None).zeta_hat, unforced.zeta_hat)


def test_sw_drag_through_the_cli(tmp_path, capsys):
    """-m sw --nu4 on the kernel backend through the run CLI: the
    per-transform path, records written."""
    from xlab_fftbarotropic_torch.cli import run as tcli
    from xlab_fftbarotropic_torch.io.fieldio import write_field

    inp, out = tmp_path / "in", tmp_path / "out"
    inp.mkdir()
    write_field(inp / "initial_vorticity.bin",
                makefields.gaussian(_sw_cfg(), zeta0=1e-5))
    assert tcli.main(["-I", str(inp), "-O", str(out), "--nx", "64",
                      "--ny", "64",
                      "--total-steps", "2", "--record-step", "1", "-m",
                      "sw", "--fft-backend", "pallas", "--nu4", "1e9",
                      "--r-drag", "2e-4", "--device", "cpu", "--manifest",
                      str(tmp_path / "log")]) == 0
    assert "FFT backend           : pallas" in capsys.readouterr().err
    assert (out / "div_step_1.bin").stat().st_size == 64 * 64 * 4


def test_sw_without_drag_keeps_the_plane_stepper():
    m = tsw.ShallowWaterModel.build(_sw_cfg(), CPU)
    assert m.backend == "pallas" and not m.per_transform
    etd = tsw.ShallowWaterModel.build(_sw_cfg(time_scheme="etdrk4",
                                              r_drag=2e-4), CPU)
    assert etd.backend == "pallas" and not etd.per_transform


# ----------------------------------------------------- SW unfused form

def test_plane_axpy_plain_is_s_plus_coef_r_bit_for_bit():
    rng = np.random.default_rng(5)
    for n_planes in (1, 2, 6):
        s = [_f32(rng, (64, 33)) for _ in range(n_planes)]
        r = [_f32(rng, (64, 33)) for _ in range(n_planes)]
        coef = 0.4235
        got = fs.plane_axpy(tuple(torch.from_numpy(a) for a in s),
                            tuple(torch.from_numpy(a) for a in r), coef)
        assert len(got) == n_planes
        for g, a, b in zip(got, s, r):
            assert np.array_equal(g.numpy(),
                                  a + np.float32(coef) * b)
    with pytest.raises(ValueError):
        fs.plane_axpy(tuple(torch.zeros(4, 4) for _ in range(9)),
                      tuple(torch.zeros(4, 4) for _ in range(9)), 1.0)


def test_sw_unfused_form_matches_the_fused_form():
    """fused_rk=False (three plane_axpy per step): the fused form's bits
    over 20 steps, on the CPU."""
    cfg = _sw_cfg()
    fused = tsw.ShallowWaterModel.build(cfg, CPU)
    unfused = tsw.ShallowWaterModel.build(cfg, CPU, fused_rk=False)
    assert not unfused.fused_rk and not unfused.per_transform
    s0 = fused.geostrophic_init(makefields.gaussian(cfg))
    a = fused.segment(s0, fused.zero_source(), STEPS)
    b = unfused.segment(s0, unfused.zero_source(), STEPS)
    assert max(_phys_err(a, b, cfg.grid_shape)) < 2e-4
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_sw_unfused_step_matches_jax_library_step():
    """One unfused plane step from a random forced state against the JAX
    library rk4_step."""
    cfg = _sw_cfg()
    rng = np.random.default_rng(2)
    s = tuple(np.asarray(jfft.forward(jnp.asarray(_f32(rng, cfg.grid_shape)
                                                  * amp)))
              for amp in (1e-4, 1e-6, 5.0))
    src = (1e-9 * rng.standard_normal(cfg.grid_shape)).astype(np.float32)
    want = jsw.rk4_step(JT.from_config(cfg),
                        jsw.SWState(*(jnp.asarray(z) for z in s)),
                        jnp.asarray(src), float(cfg.dt), float(cfg.f),
                        float(cfg.gravity), float(cfg.nu),
                        float(cfg.mean_depth), cfg.grid_shape)
    m = tsw.ShallowWaterModel.build(cfg, CPU, fused_rk=False)
    got = m.step(tsw.SWState(*(torch.from_numpy(np.array(z)) for z in s)),
                 torch.from_numpy(src))
    assert max(_phys_err(want, got, cfg.grid_shape)) < 1e-5
