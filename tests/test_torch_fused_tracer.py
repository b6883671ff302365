"""The plain torch versions of the tracer family's kernels and of the RK4
combine (xlab_fftbarotropic_torch/ops/fused_tracer.py, fused_sw.py)
against the JAX Pallas functions they replace, run in interpret mode on
the CPU, and the wrappers' dispatch rules.

Bars, rel-L2 per output field against JAX: 1e-6 for the inverse x-stage
(tracer_xstage_planes) and the y-stage products (kb_adv_tracer), 2e-6
for the forward x-stage with its epilogue (forward_tail_tracer, like the
tracer family's own bar, tests/test_pallas_tracer.py:79-80), 2e-6 for a
whole RK stage and a whole step; plane_rk4_combine is the same float32
arithmetic in the same grouping, so it is held bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ops import pallas_sw as psw
from xlab_fftbarotropic_tpu.ops import pallas_tracer as pt
from xlab_fftbarotropic_tpu.ops.spectral import SpectralTables as JT
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.ops import fused_sw as fs
from xlab_fftbarotropic_torch.ops import fused_tracer as ft
from xlab_fftbarotropic_torch.ops.spectral import SpectralTables as TT
from torch_threads import _one_thread  # noqa: F401

SIZES = [64, 128]


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    return np.linalg.norm(want - got) / np.linalg.norm(want)


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
            for a in arrays]


def _setup(n, seed):
    cfg = ModelConfig(nx=n, ny=n)
    rng = np.random.default_rng(seed)
    hny = n // 2 + 1
    sr2, si2 = (rng.standard_normal((2, n, hny)).astype(np.float32)
                for _ in range(2))
    return cfg, JT.from_config(cfg), TT.from_config(cfg, "cpu"), sr2, si2, rng


def _per_field(want, got, bar):
    for w, g in zip(want, got):
        w, g = np.asarray(w), np.asarray(g)
        assert w.shape == g.shape
        for f in range(w.shape[0]):
            assert _rel(w[f], g[f]) < bar, f


@pytest.mark.parametrize("n", SIZES)
def test_ka6_matches_tracer_xstage_planes(n):
    cfg, jt, tt, sr2, si2, _ = _setup(n, 1)
    want = pt.tracer_xstage_planes(jnp.asarray(sr2), jnp.asarray(si2),
                                   jt.kx, jt.ky, jt.rlap, cfg.grid_shape)
    got = ft.tracer_xstage_planes(*_t(sr2, si2), tt.kx, tt.ky, tt.rlap)
    assert got[0].shape == (6, n // 2 + 1, n)
    _per_field(want, [g.numpy() for g in got], 1e-6)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("with_src", [True, False])
@pytest.mark.parametrize("beta", [0.0, 0.7])
def test_kb_adv_tracer_matches_jax(n, with_src, beta):
    cfg, jt, _, sr2, si2, rng = _setup(n, 2)
    wr, wi = pt.tracer_xstage_planes(jnp.asarray(sr2), jnp.asarray(si2),
                                     jt.kx, jt.ky, jt.rlap, cfg.grid_shape)
    zx, zy, qx, qy, src = (rng.standard_normal((n, n)).astype(np.float32)
                           for _ in range(5))
    want = pt.kb_adv_tracer(
        *(jnp.asarray(a) for a in (zx, zy, qx, qy)), wr, wi,
        jnp.asarray(src) if with_src else None, cfg.grid_shape, beta=beta)
    tsrc = _t(src)[0] if with_src else None
    got = ft.kb_adv_tracer(*_t(zx, zy, qx, qy, wr, wi), tsrc, beta)
    assert got[0].shape == (2, n, n // 2 + 1)
    _per_field(want, [g.numpy() for g in got], 1e-6)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("coef", [None, 1.5])
def test_forward_tail_tracer_matches_jax(n, coef):
    """The stacked KX+VISC: two fields, the stacked diffusion table, with
    and without the RK stage axpy."""
    cfg, jt, tt, sr2, si2, rng = _setup(n, 3)
    hny = n // 2 + 1
    fr, fi, z0r, z0i = (n * rng.standard_normal((2, n, hny)).astype(
        np.float32) for _ in range(4))
    lap2 = np.stack([6.5e9 * np.asarray(jt.lap) - 0.3,
                     5e9 * np.asarray(jt.lap)]).astype(np.float32)
    jax_axpy = None if coef is None else (jnp.asarray(z0r),
                                          jnp.asarray(z0i), coef)
    want = pt.forward_tail_tracer(
        jnp.asarray(fr), jnp.asarray(fi), jnp.asarray(lap2), jt.mask,
        jnp.asarray(sr2), jnp.asarray(si2), cfg.grid_shape, axpy=jax_axpy)
    t_axpy = None if coef is None else (*_t(z0r, z0i), coef)
    got = ft.forward_tail_tracer(*_t(fr, fi, lap2), tt.mask,
                                 *_t(sr2, si2), t_axpy)
    assert len(got) == len(want) == (2 if coef is None else 4)
    _per_field(want, [g.numpy() for g in got], 2e-6)


@pytest.mark.parametrize("n", SIZES)
def test_plane_rk4_combine_matches_pallas_sw(n):
    rng = np.random.default_rng(4)
    shape = (2 * n, n // 2 + 1)      # the tracer's (2*nx, hny) views
    groups = [tuple(rng.standard_normal(shape).astype(np.float32)
                    for _ in range(2)) for _ in range(5)]
    want = psw.plane_rk4_combine(*[tuple(jnp.asarray(p) for p in g)
                                   for g in groups], 0.5)
    got = fs.plane_rk4_combine(*[tuple(_t(*g)) for g in groups], 0.5)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _tracer_stage_inputs(n, seed):
    """A real joint state (kuo2004 vorticity, gaussian tracer) on
    stacked planes, a forcing field and a stacked diffusion table."""
    from xlab_fftbarotropic_tpu.ic import makefields
    from xlab_fftbarotropic_tpu.models.tracer import tracer_ic

    cfg = ModelConfig(nx=n, ny=n)
    z = np.fft.rfft2(makefields.kuo2004(cfg)).astype(np.complex64)
    q = np.fft.rfft2(tracer_ic(cfg, "gaussian")).astype(np.complex64)
    sr2 = np.ascontiguousarray(np.stack([z.real, q.real]))
    si2 = np.ascontiguousarray(np.stack([z.imag, q.imag]))
    src = (1e-8 * np.random.default_rng(seed).standard_normal((n, n))
           ).astype(np.float32)
    jt = JT.from_config(cfg)
    lap = np.asarray(jt.lap)
    lap2 = np.stack([lap * cfg.nu - 1e-5 - 1e5 * lap * lap,
                     lap * 50.0]).astype(np.float32)
    return cfg, jt, TT.from_config(cfg, "cpu"), sr2, si2, src, lap2


@pytest.mark.parametrize("beta", [0.0, 1e-11])
def test_one_tracer_stage_matches_jax(beta):
    """ka6 -> kb_pair x2 -> kb_adv_tracer -> kx_visc with the axpy, on a
    real state, against the JAX stage."""
    cfg, jt, tt, sr2, si2, src, lap2 = _tracer_stage_inputs(128, 5)
    want = pt.tendency_tracer_planes(
        jnp.asarray(sr2), jnp.asarray(si2), jnp.asarray(src.T), jt.kx,
        jt.ky, jt.rlap, jnp.asarray(lap2), jt.mask, cfg.grid_shape,
        axpy=(jnp.asarray(sr2), jnp.asarray(si2), 1.5), beta=beta)
    tsr2, tsi2 = _t(sr2, si2)
    got = ft.tendency_tracer_planes(tsr2, tsi2, _t(src.T)[0], tt.kx, tt.ky,
                                    tt.rlap, _t(lap2)[0], tt.mask,
                                    axpy=(tsr2, tsi2, 1.5), beta=beta)
    _per_field(want, [g.numpy() for g in got], 2e-6)


def test_rk4_step_tracer_planes_matches_jax():
    """One whole plane-stepper step (three fused stages, a fourth, the
    combine) with forcing, drag, beta and hyperviscosity folded in."""
    cfg, jt, tt, sr2, si2, src, lap2 = _tracer_stage_inputs(128, 6)
    want = pt.rk4_step_tracer_planes(
        jt, jnp.asarray(sr2), jnp.asarray(si2), jnp.asarray(src.T),
        float(cfg.dt), jnp.asarray(lap2), cfg.grid_shape, beta=1e-11)
    got = ft.rk4_step_tracer_planes(tt, *_t(sr2, si2), _t(src.T)[0],
                                    float(cfg.dt), _t(lap2)[0], beta=1e-11)
    _per_field(want, [g.numpy() for g in got], 2e-6)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    cfg, jt, tt, sr2, si2, src, lap2 = _tracer_stage_inputs(64, 7)
    tsr2, tsi2 = _t(sr2, si2)
    ff.reset_launches()
    got = ft.tracer_xstage_planes(tsr2, tsi2, tt.kx, tt.ky, tt.rlap)
    want = ft.ka6_plain(tsr2, tsi2, tt.rlap, tt.kx, tt.ky)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ft.rk4_step_tracer_planes(tt, tsr2, tsi2, _t(src.T)[0], 3.0,
                              _t(lap2)[0])
    assert set(ff.LAUNCHES.values()) == {0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    n = 64
    _, _, tt, sr2, si2, _ = _setup(n, 8)
    tsr2, tsi2 = _t(sr2, si2)
    with pytest.raises(ValueError):          # one state, not two
        ft.tracer_xstage_planes(tsr2[:1], tsi2[:1], tt.kx, tt.ky, tt.rlap)
    with pytest.raises(TypeError):
        ft.tracer_xstage_planes(tsr2.double(), tsi2, tt.kx, tt.ky, tt.rlap)
    x = torch.zeros((n, n))
    w = torch.zeros((4, n // 2 + 1, n))      # a 4-stack: no fields 4, 5
    with pytest.raises(ValueError):
        ft.kb_adv_tracer(x, x, x, x, w, w, None)
    with pytest.raises(ValueError):          # a lap table per field
        ff.kx_visc(tsr2, tsi2, tt.lap, tt.mask, tsr2, tsi2, 1.0)
    with pytest.raises(ValueError):          # the axpy state's shape
        ff.kx_visc(tsr2, tsi2, tsr2, tt.mask, tsr2, tsi2, 1.0,
                   (tsr2[0], tsi2[0], 0.5))
    p = tuple(_t(sr2[0], si2[0]))
    with pytest.raises(ValueError):          # five tuples of equal length
        fs.plane_rk4_combine(p, p, p, p, p[:1], 0.5)
    with pytest.raises(ValueError):
        fs.plane_rk4_combine(*[(x,) * 9] * 5, 0.5)
    meta = torch.zeros((2, n, n), device="meta")
    with pytest.raises(ValueError):
        fs.plane_rk4_combine(*[(meta,)] * 5, 0.5)
