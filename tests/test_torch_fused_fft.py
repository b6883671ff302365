"""The plain torch versions of the four CUDA kernels
(xlab_fftbarotropic_torch/ops/fused_fft.py) against the JAX Pallas
functions they replace, run in interpret mode on the CPU, and the
wrappers' dispatch rules.

Bars: 2e-6 for the inverse stages (derivative_xstage_planes and
_kb_call_stacked, like tests/test_pallas_fft.py's transform bars), 2e-5
for the forward tendency (tests/test_pallas_fft.py:128), as max error
over max |JAX|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ops import pallas_fft as pf
from xlab_fftbarotropic_tpu.ops.spectral import SpectralTables as JT
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.ops.spectral import SpectralTables as TT

SIZES = [64, 128]


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    return np.max(np.abs(want - got)) / np.max(np.abs(want))


def _setup(n, seed):
    cfg = ModelConfig(nx=n, ny=n)
    rng = np.random.default_rng(seed)
    z = np.fft.rfft2(rng.standard_normal((n, n))).astype(np.complex64)
    zr, zi = np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)
    return cfg, JT.from_config(cfg), TT.from_config(cfg, "cpu"), zr, zi, rng


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
            for a in arrays]


@pytest.mark.parametrize("n", SIZES)
def test_ka_diag_matches_derivative_xstage_planes(n):
    cfg, jt, tt, zr, zi, _ = _setup(n, 1)
    want = pf.derivative_xstage_planes(jnp.asarray(zr), jnp.asarray(zi),
                                       jt.kx, jt.ky, jt.rlap, cfg.grid_shape)
    got = ff.ka_diag(*_t(zr, zi), tt.rlap, tt.kx, tt.ky)
    for w, g in zip(want, got):
        assert g.shape == (4, n // 2 + 1, n)
        assert _rel(w, g.numpy()) < 2e-6


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("pair", [(0, 1), (2, 3)])
def test_kb_pair_matches_kb_call_stacked(n, pair):
    cfg, jt, _, zr, zi, _ = _setup(n, 2)
    wr, wi = pf.derivative_xstage_planes(jnp.asarray(zr), jnp.asarray(zi),
                                         jt.kx, jt.ky, jt.rlap,
                                         cfg.grid_shape)
    scale = 1.0 / (n * n)
    want = pf._kb_call_stacked(wr, wi, *pair, n, scale, transpose_out=False)
    got = ff.kb_pair(*_t(wr, wi), *pair, scale)
    for w, g in zip(want, got):
        assert g.shape == (n, n)
        assert _rel(w, g.numpy()) < 2e-6


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("beta", [0.0, 0.7])
def test_forward_tendency_yfirst_matches_jax(n, beta):
    """ky_adv + kx_visc against the y-first forward pipeline, with the
    JAX package's stage-axpy epilogue off (axpy=None)."""
    cfg, jt, tt, zr, zi, rng = _setup(n, 3)
    fields = [rng.standard_normal((n, n)).astype(np.float32)
              for _ in range(5)]
    nu = 6.5e9          # nu*lap of order one on this grid
    want = pf.forward_tendency_yfirst(
        *(jnp.asarray(f) for f in fields), jt.lap, jt.mask,
        jnp.asarray(zr), jnp.asarray(zi), nu, cfg.grid_shape, beta=beta)
    got = ff.forward_tendency_yfirst(*_t(*fields), tt.lap, tt.mask,
                                     *_t(zr, zi), nu, beta)
    for w, g in zip(want, got):
        assert _rel(w, g.numpy()) < 2e-5


@pytest.mark.parametrize("n", SIZES)
def test_kx_visc_matches_forward_tail(n):
    cfg, jt, tt, zr, zi, rng = _setup(n, 4)
    fr, fi = (rng.standard_normal((n, n // 2 + 1)).astype(np.float32) * n
              for _ in range(2))
    nu = 6.5e9
    want = pf.forward_tail(jnp.asarray(fr), jnp.asarray(fi), jt.lap,
                           jt.mask, jnp.asarray(zr), jnp.asarray(zi), nu,
                           cfg.grid_shape)
    got = ff.kx_visc(*_t(fr, fi), tt.lap, tt.mask, *_t(zr, zi), nu)
    for w, g in zip(want, got):
        assert _rel(w, g.numpy()) < 2e-5


@pytest.mark.parametrize("beta", [0.0, 1e-8])
def test_one_stage_tendency_matches_jax(beta):
    """All four kernels chained as one RK stage of the plane stepper,
    on a real state (kuo2004), against the JAX stage."""
    from xlab_fftbarotropic_tpu.ic import makefields

    n = 128
    cfg = ModelConfig(nx=n, ny=n)
    jt, tt = JT.from_config(cfg), TT.from_config(cfg, "cpu")
    z = np.fft.rfft2(makefields.kuo2004(cfg)).astype(np.complex64)
    zr, zi = np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)
    src = (1e-8 * np.random.default_rng(6).standard_normal((n, n))
           ).astype(np.float32)
    jzx, jzy, ju, jv = pf.derivative_quad_planes(
        jnp.asarray(zr), jnp.asarray(zi), jt.kx, jt.ky, jt.rlap,
        cfg.grid_shape, ymajor=True)
    want = pf.forward_tendency_yfirst(
        ju, jzx, jv, jzy, jnp.asarray(src.T), jt.lap, jt.mask,
        jnp.asarray(zr), jnp.asarray(zi), cfg.nu, cfg.grid_shape, beta=beta)
    tzr, tzi = _t(zr, zi)
    zx, zy, u, v = ff.derivative_quad_planes(tzr, tzi, tt.kx, tt.ky, tt.rlap)
    for w, g in zip((jzx, jzy, ju, jv), (zx, zy, u, v)):
        assert _rel(w, g.numpy()) < 2e-6
    got = ff.forward_tendency_yfirst(u, zx, v, zy, _t(src.T)[0], tt.lap,
                                     tt.mask, tzr, tzi, cfg.nu, beta)
    for w, g in zip(want, got):
        assert _rel(w, g.numpy()) < 2e-5


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    n = 64
    _, _, tt, zr, zi, _ = _setup(n, 5)
    ff.reset_launches()
    tzr, tzi = _t(zr, zi)
    got = ff.ka_diag(tzr, tzi, tt.rlap, tt.kx, tt.ky)
    want = ff.ka_diag_plain(tzr, tzi, tt.rlap, tt.kx, tt.ky)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ff.derivative_quad_planes(tzr, tzi, tt.kx, tt.ky, tt.rlap)
    assert ff.LAUNCHES == {"ka_diag": 0, "kb_pair": 0, "ky_adv": 0,
                           "kx_visc": 0, "ka6": 0, "kb_adv_tracer": 0,
                           "rk4_combine": 0, "ka_sw": 0, "ky_all": 0,
                           "kx_fwd": 0, "sw_combine": 0, "sw_combine_mv": 0,
                           "ka": 0, "kc": 0, "kb": 0, "plane_axpy": 0,
                           "ka_adv": 0, "kc_visc": 0, "ka_quad": 0,
                           "ka_fwd": 0, "kc_sw": 0, "kb_adv_full": 0,
                           "kb_adv_half": 0, "kx_visc_tail": 0, "visc": 0,
                           "a2a_cols": 0, "a2a_rows": 0, "xstage": 0,
                           "xstage_gather": 0, "xstage_scatter": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    n = 64
    _, _, tt, zr, zi, _ = _setup(n, 6)
    tzr, tzi = _t(zr, zi)
    with pytest.raises(TypeError):
        ff.ka_diag(tzr.double(), tzi, tt.rlap, tt.kx, tt.ky)
    with pytest.raises(ValueError):
        ff.ka_diag(tzr[:, :-1], tzi, tt.rlap, tt.kx, tt.ky)
    x = torch.zeros((n, n))
    with pytest.raises(ValueError):
        ff.ky_adv(x.t(), x, x, x, x)          # not contiguous
    with pytest.raises(ValueError):
        ff.kb_pair(torch.zeros((33, n)), torch.zeros((33, n)), 0, 1, 1.0)
    with pytest.raises(ValueError):
        ff.kb_pair(torch.zeros((4, 33, n)), torch.zeros((4, 33, n)), 0, 4,
                   1.0)
    with pytest.raises(ValueError):
        ff.kb_pair(torch.zeros((6, 33, n)), torch.zeros((6, 33, n)), 4, 6,
                   1.0)
    meta = torch.zeros((n, n), device="meta")
    with pytest.raises(ValueError):
        ff.ky_adv(meta, meta, meta, meta, meta)
    assert ff.supported_length(64) and ff.supported_length(8192)
    assert not any(ff.supported_length(k) for k in (32, 96, 16384))


@pytest.mark.parametrize("n", SIZES)
def test_kx_visc_axpy_matches_forward_tail(n):
    """The stage-axpy epilogue (the coef form of _kx_visc_kernel)
    against pallas_fft.forward_tail(axpy=...), and forward_tendency_yfirst
    passing the axpy through."""
    cfg, jt, tt, zr, zi, rng = _setup(n, 7)
    fr, fi = (rng.standard_normal((n, n // 2 + 1)).astype(np.float32) * n
              for _ in range(2))
    z0r, z0i = (rng.standard_normal((n, n // 2 + 1)).astype(np.float32)
                for _ in range(2))
    nu = 6.5e9
    want = pf.forward_tail(jnp.asarray(fr), jnp.asarray(fi), jt.lap,
                           jt.mask, jnp.asarray(zr), jnp.asarray(zi), nu,
                           cfg.grid_shape,
                           axpy=(jnp.asarray(z0r), jnp.asarray(z0i), 1.5))
    got = ff.kx_visc(*_t(fr, fi), tt.lap, tt.mask, *_t(zr, zi), nu,
                     (*_t(z0r, z0i), 1.5))
    assert len(want) == len(got) == 4
    for w, g in zip(want, got):
        assert _rel(w, g.numpy()) < 2e-5
    fields = [rng.standard_normal((n, n)).astype(np.float32)
              for _ in range(5)]
    tf = _t(*fields)
    a = ff.forward_tendency_yfirst(*tf, tt.lap, tt.mask, *_t(zr, zi), nu,
                                   0.5, (*_t(z0r, z0i), 1.5))
    fr2, fi2 = ff.ky_adv(*tf, 0.5)
    b = ff.kx_visc(fr2, fi2, tt.lap, tt.mask, *_t(zr, zi), nu,
                   (*_t(z0r, z0i), 1.5))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n", SIZES)
def test_kb_pair_on_the_six_field_stack(n):
    """kb_pair on the tracer's (6, hny, nx) stack, fields (4, 5), against
    _kb_call_stacked on the same stack."""
    from xlab_fftbarotropic_tpu.ops import pallas_tracer as pt

    cfg, jt, _, zr, zi, _ = _setup(n, 8)
    sr2 = np.stack([zr, 2.0 * zi])
    si2 = np.stack([zi, -zr])
    wr, wi = pt.tracer_xstage_planes(jnp.asarray(sr2), jnp.asarray(si2),
                                     jt.kx, jt.ky, jt.rlap, cfg.grid_shape)
    scale = 1.0 / (n * n)
    want = pf._kb_call_stacked(wr, wi, 4, 5, n, scale, transpose_out=False)
    got = ff.kb_pair(*_t(wr, wi), 4, 5, scale)
    for w, g in zip(want, got):
        assert _rel(w, g.numpy()) < 2e-6


def test_kx_visc_stack_equals_its_fields():
    """A stacked (F, nx, hny) call is its fields' one-field calls: the
    per-field tables and the shared mask line up. Bar 1e-6 of max |part|:
    torch.fft's batched CPU transform rounds apart from its single one."""
    n = 64
    _, _, tt, zr, zi, rng = _setup(n, 9)
    planes = [rng.standard_normal((3, n, n // 2 + 1)).astype(np.float32)
              for _ in range(6)]
    fr, fi, lap, zsr, zsi, z0 = _t(*planes)
    whole = ff.kx_visc(fr, fi, lap, tt.mask, zsr, zsi, 0.7, (z0, z0, 0.3))
    for f in range(3):
        part = ff.kx_visc(fr[f], fi[f], lap[f], tt.mask, zsr[f], zsi[f],
                          0.7, (z0[f], z0[f], 0.3))
        for w, p in zip(whole, part):
            assert _rel(p.numpy(), w[f].numpy()) < 1e-6
