"""The plain torch versions of the shallow-water plane stepper's kernels
(xlab_fftbarotropic_torch/ops/fused_sw.py) and of the per-transform
x- and y-stages ka and kc (ops/fused_fft.py) against the JAX Pallas
functions they replace, run in interpret mode on the CPU, and the
wrappers' dispatch rules.

Bars (max |JAX - port| / max |JAX|, per field, the JAX package's own
bars for these functions, tests/test_pallas_sw.py): 3e-6 for the
inverse pipeline (ka_sw + 2 kb_pair) against inverse_quad_planes, 2e-5
for the forward pipeline (ky_all + kx_fwd + sw_combine) against
forward_tendencies, 1e-6 for ka, kc and the forcing spectrum;
eta_pair_scale bit for bit. Each JAX interpret call runs once, in a
module-scoped fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ops import fft as jfft
from xlab_fftbarotropic_tpu.ops import pallas_fft as pf
from xlab_fftbarotropic_tpu.ops import pallas_sw as psw
from xlab_fftbarotropic_tpu.ops.spectral import SpectralTables as JT
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.ops import fused_sw as fs
from xlab_fftbarotropic_torch.ops.spectral import SpectralTables as TT

N = 128
CFG = ModelConfig(nx=N, ny=N, dt=1.0)
PHYS = (float(CFG.f), float(CFG.gravity), float(CFG.nu),
        float(CFG.mean_depth))
KY_MODES = ("0", "1", "loop")        # _ky_fwd, _ky_all, _ky_all_loop
COEF = 0.5


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    return np.max(np.abs(want - got)) / np.max(np.abs(want))


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
            for a in arrays]


def _state_planes(seed, amps=(1e-4, 1e-6, 5.0)):
    """Six float32 planes of a random SW state at the bench's magnitudes
    (tests/test_pallas_sw.py:_random_state): zeta 1e-4, div 1e-6,
    eta 5 m."""
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


@pytest.fixture(scope="module")
def jax_sw():
    """Every JAX Pallas call the tests hold the port against, once."""
    jt = JT.from_config(CFG)
    planes = _state_planes(0)
    jp = tuple(jnp.asarray(p) for p in planes)
    es = psw.eta_pair_scale(jp)
    rng = np.random.default_rng(7)
    src = (1e-9 * rng.standard_normal(CFG.grid_shape)).astype(np.float32)
    src_planes = tuple(np.asarray(x) for x in
                       psw.forward_planes(jnp.asarray(src)))
    out = dict(planes=planes, es=float(es), src=src, src_planes=src_planes)
    with pytest.MonkeyPatch.context() as mp:
        for split in ("0", "1"):
            mp.setenv("XFB_SW_KA_SPLIT", split)
            out["inv", split] = tuple(np.asarray(x) for x in
                                      psw.inverse_quad_planes(
                                          *jp, jt.kx, jt.ky, jt.rlap,
                                          CFG.grid_shape, eta_scale=es))
    u, v, zeta, eta_s = (jnp.asarray(x) for x in out["inv", "0"])
    jsrc = tuple(jnp.asarray(x) for x in src_planes)

    def tend(src_p, axpy=None):
        return psw.forward_tendencies(
            u, v, zeta, eta_s, jp, src_p, jt.kx, jt.ky, jt.lap, jt.mask,
            *PHYS, CFG.grid_shape, eta_scale=es, axpy=axpy)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(psw, "SPLIT_LINEAR", "0")
        for mode in KY_MODES:
            mp.setattr(psw, "KY_ALL", mode)
            for with_src in (False, True):
                out["fwd", mode, with_src] = tend(jsrc if with_src
                                                  else None)
        mp.setattr(psw, "KY_ALL", "auto")
        base = tuple(jnp.asarray(p) for p in _state_planes(1))
        out["fwd_axpy", "base"] = tuple(np.asarray(p) for p in base)
        out["fwd_axpy"] = tend(jsrc, axpy=(base, COEF))
        mp.setattr(psw, "SPLIT_LINEAR", "1")
        out["fwd_split"] = tend(jsrc)
    return out


@pytest.fixture(scope="module")
def tt():
    return TT.from_config(CFG, "cpu")


def _port_inverse(tt, jax_sw):
    return fs.inverse_quad_planes(*_t(*jax_sw["planes"]), tt.kx, tt.ky,
                                  tt.rlap, jax_sw["es"])


@pytest.mark.parametrize("ka_split", ["0", "1"])
def test_inverse_quad_planes_matches_jax(jax_sw, tt, ka_split):
    """u, v, zeta and the scaled eta, y-major, against both forms of the
    TPU x-stage (_ka_sw_kernel and its two-call split _ka_sw2_kernel);
    zeta (1e-4) and eta (5 m) share one kb_pair, equalized."""
    got = _port_inverse(tt, jax_sw)
    want = jax_sw["inv", ka_split]
    for name, w, g in zip(("u", "v", "zeta", "eta_s"), want, got):
        assert g.shape == (N, N)
        assert _rel(w, g.numpy()) < 3e-6, name


def test_ka_sw_fields_are_the_diagonal_scalings(tt):
    """The four x-stage inputs are u, v, zeta and eta_scale*eta of the
    spectral state, as sw_velocities forms them."""
    from xlab_fftbarotropic_torch.models import shallow_water as tsw

    planes = _t(*_state_planes(2))
    re, im = fs.sw_fields(*planes, tt.rlap, tt.kx, tt.ky, 0.25)
    z, d, e = (torch.complex(planes[i], planes[i + 1]) for i in (0, 2, 4))
    u_hat, v_hat = tsw.sw_velocities(tt, z, d)
    for w, r, i in zip((u_hat, v_hat, z, 0.25 * e), re, im):
        np.testing.assert_allclose(torch.complex(r, i).numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-6 * float(
                                       w.abs().max()))


@pytest.mark.parametrize("ky_mode", KY_MODES)
@pytest.mark.parametrize("with_src", [False, True])
def test_forward_tendencies_match_jax(jax_sw, tt, ky_mode, with_src):
    """ky_all + kx_fwd + sw_combine against the three TPU schedules of
    the KY stage (per product, all five unrolled, all five in a loop),
    from the same y-major fields."""
    u, v, zeta, eta_s = _t(*jax_sw["inv", "0"])
    src = tuple(_t(*jax_sw["src_planes"])) if with_src else None
    got = fs.forward_tendencies(u, v, zeta, eta_s,
                                tuple(_t(*jax_sw["planes"])), src, tt.kx,
                                tt.ky, tt.lap, tt.mask, *PHYS,
                                eta_scale=jax_sw["es"])
    want = jax_sw["fwd", ky_mode, with_src]
    assert len(got) == 6
    for name, w, g in zip(("zeta", "div", "eta"), _complex_fields(want),
                          _complex_fields([x.numpy() for x in got])):
        assert _rel(w, g) < 2e-5, name


def test_self_conjugate_rows_of_the_sw_stack_do_not_leak(tt):
    """Junk in the imaginary part of rows 0 and ny/2 of the SW x-stage
    stack (zeta pairs with the equalized eta there) leaves the paired
    c2r outputs bit-identical."""
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
        a = ff.kb_pair(wr, clean, *pair, 1.0 / (N * N))
        b = ff.kb_pair(wr, poisoned, *pair, 1.0 / (N * N))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), pair


def test_forward_tendencies_with_axpy_match_jax(jax_sw, tt):
    """The fused stage update reads the BASE state z0 (another state
    than the stage state the viscosity and -H D read)."""
    u, v, zeta, eta_s = _t(*jax_sw["inv", "0"])
    base = tuple(_t(*jax_sw["fwd_axpy", "base"]))
    tend, nxt = fs.forward_tendencies(
        u, v, zeta, eta_s, tuple(_t(*jax_sw["planes"])),
        tuple(_t(*jax_sw["src_planes"])), tt.kx, tt.ky, tt.lap, tt.mask,
        *PHYS, eta_scale=jax_sw["es"], axpy=(base, COEF))
    want_t, want_n = jax_sw["fwd_axpy"]
    for w, g in zip(_complex_fields(want_t),
                    _complex_fields([x.numpy() for x in tend])):
        assert _rel(w, g) < 2e-5
    for w, g in zip(_complex_fields(want_n),
                    _complex_fields([x.numpy() for x in nxt])):
        assert _rel(w, g) < 2e-5
    for z0, t, n in zip(base, tend, nxt):
        assert torch.equal(n, z0 + COEF * t)


def test_split_linear_matches_jax(jax_sw, tt):
    """split: the products leave out f0 and g*eta, and sw_combine adds
    the exact linear terms (with the mean-mode guard), as pallas_sw does
    with SPLIT_LINEAR on."""
    u, v, zeta, eta_s = _t(*jax_sw["inv", "0"])
    args = (u, v, zeta, eta_s, tuple(_t(*jax_sw["planes"])),
            tuple(_t(*jax_sw["src_planes"])), tt.kx, tt.ky, tt.lap,
            tt.mask, *PHYS)
    got = fs.forward_tendencies(*args, eta_scale=jax_sw["es"], split=True)
    for w, g in zip(_complex_fields(jax_sw["fwd_split"]),
                    _complex_fields([x.numpy() for x in got])):
        assert _rel(w, g) < 2e-5
    plain = fs.forward_tendencies(*args, eta_scale=jax_sw["es"])
    for a, b in zip(_complex_fields([x.numpy() for x in plain]),
                    _complex_fields([x.numpy() for x in got])):
        assert _rel(a, b) < 2e-5


def test_forward_planes_matches_jax(jax_sw):
    got = fs.forward_planes(_t(jax_sw["src"])[0])
    for w, g in zip(jax_sw["src_planes"], got):
        assert g.shape == (N, N // 2 + 1)
        assert _rel(w, g.numpy()) < 1e-6


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("real_input", [True, False])
@pytest.mark.parametrize("shape", [(128, 128), (128, 64), (64, 256)])
def test_ka_matches_jax_in_every_mode(forward, real_input, shape):
    n, m = shape
    rng = np.random.default_rng(n + m)
    xr, xi = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    want = pf._ka_call(jnp.asarray(xr), None if real_input
                       else jnp.asarray(xi), n, forward=forward,
                       real_input=real_input, scale=0.25)
    got = ff.ka(*_t(xr), None if real_input else _t(xi)[0], forward, 0.25)
    for w, g in zip(want, got):
        assert g.shape == (m, n)
        assert _rel(w, g.numpy()) < 1e-6


@pytest.mark.parametrize("shape", [(128, 128), (128, 64), (256, 128)])
def test_kc_matches_jax(shape):
    ny, nx = shape
    rng = np.random.default_rng(ny + nx)
    xr, xi = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    want = pf._kc_call((jnp.asarray(xr), jnp.asarray(xi)), ny)
    got = ff.kc(*_t(xr, xi))
    for w, g in zip(want, got):
        assert g.shape == (nx, ny // 2 + 1)
        assert _rel(w, g.numpy()) < 1e-6


@pytest.mark.parametrize("case", ["random", "zero_eta", "zero_zeta",
                                  "huge_eta", "tiny_eta"])
def test_eta_pair_scale_is_bit_identical(case):
    """An exact power of two from the exponent bits, 1 where either
    field is zero, clamped to 2^-126..2^126."""
    amps = {"random": (1e-4, 1e-6, 5.0), "zero_eta": (1e-4, 1e-6, 0.0),
            "zero_zeta": (0.0, 1e-6, 5.0), "huge_eta": (1e-30, 1.0, 1e30),
            "tiny_eta": (1e3, 1.0, 1e-30)}[case]
    planes = _state_planes(3, amps)
    want = np.asarray(psw.eta_pair_scale(tuple(jnp.asarray(p)
                                               for p in planes)))
    got = fs.eta_pair_scale(_t(*planes)).numpy()
    assert got.dtype == np.float32
    assert want.view(np.int32) == got.view(np.int32)
    m = np.frexp(float(got))[0]
    assert m == 0.5                    # a power of two
    if case.startswith("zero"):
        assert float(got) == 1.0


def test_cpu_tensors_take_the_plain_versions_and_count_nothing(tt):
    planes = _t(*_state_planes(4))
    ff.reset_launches()
    got = fs.ka_sw(*planes, tt.rlap, tt.kx, tt.ky, 0.5)
    want = fs.ka_sw_plain(*planes, tt.rlap, tt.kx, tt.ky, 0.5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    fields = fs.inverse_quad_planes(*planes, tt.kx, tt.ky, tt.rlap, 0.5)
    pr, pi = fs.kx_fwd(*fs.ky_all(*fields, 2.0, 1e-4, 9.81))
    fs.sw_combine(pr, pi, tuple(planes), fs.forward_planes(fields[0]),
                  tt.kx, tt.ky, tt.lap, tt.mask, *PHYS,
                  axpy=(tuple(planes), 0.5))
    assert set(ff.LAUNCHES.values()) == {0}


def test_wrappers_reject_what_the_kernels_do_not_take(tt):
    planes = _t(*_state_planes(5))
    with pytest.raises(ValueError):          # rlap of the wrong shape
        fs.ka_sw(*planes, tt.rlap[:, :-1].contiguous(), tt.kx, tt.ky, 1.0)
    with pytest.raises(TypeError):
        fs.ka_sw(planes[0].double(), *planes[1:], tt.rlap, tt.kx, tt.ky,
                 1.0)
    x = torch.zeros((N, N))
    with pytest.raises(ValueError):          # four fields of one shape
        fs.ky_all(x, x, x, torch.zeros((N, N // 2)), 1.0, 0.0, 9.81)
    with pytest.raises(ValueError):          # a stack, not a plane
        fs.kx_fwd(x, x)
    p5 = torch.zeros((5, N, N // 2 + 1))
    with pytest.raises(ValueError):          # six state planes
        fs.sw_combine(p5, p5, tuple(planes[:5]), None, tt.kx, tt.ky,
                      tt.lap, tt.mask, *PHYS)
    with pytest.raises(ValueError):          # six base planes
        fs.sw_combine(p5, p5, tuple(planes), None, tt.kx, tt.ky, tt.lap,
                      tt.mask, *PHYS, axpy=(tuple(planes[:2]), 0.5))
    with pytest.raises(ValueError):          # four product spectra
        fs.sw_combine(p5[:4], p5[:4], tuple(planes), None, tt.kx, tt.ky,
                      tt.lap, tt.mask, *PHYS)
    with pytest.raises(ValueError):
        ff.ka(torch.zeros((2, N, N)), None, True)
    with pytest.raises(ValueError):          # xr, xi of one shape
        ff.kc(x, torch.zeros((N, N // 2)))
    meta = torch.zeros((N, N), device="meta")
    with pytest.raises(ValueError):
        ff.kc(meta, meta)
