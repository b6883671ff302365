"""The hand-written CUDA kernels against their plain torch versions on
the card, at the transform lengths 64, 256, 4096 and 8192, plus
non-square stacks that pin every stride, and the launch counts of the
plane steppers in both transform orders; the distributed path's kernels
on 1, 2, 4 and 8 shards (the transposes bit for bit), and the sharded
model's segments against the single-device library path.

Marked `gpu`: each test skips where torch sees no CUDA device. This file
imports no jax, so on a machine without it run it alone, past the test
directory's jax-pinning conftest:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerance: max |kernel - plain| / max |plain| <= 1e-5. The kernels' radix-2
float32 sums (radix 8 in the column-tile x-stages of kx_visc and xstage,
csrc/xtile.cuh) run in another order than cuFFT's, and the rounding error
grows with log2(n); 1e-5 is float32 epsilon times a margin for n = 4096.
"""

import numpy as np
import pytest
import torch

from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.ops import fused_sw as fs
from xlab_fftbarotropic_torch.ops import fused_tracer as ft
from xlab_fftbarotropic_torch.ops.spectral import SpectralTables

pytestmark = pytest.mark.gpu

TOL = 1e-5
SIZES = [64, 256, 4096, 8192]   # 8192: the column tile narrows to C = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _planes(rng, shape, k, dev):
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dev) for _ in range(k)]


def _tables(n, dev, ny=None):
    return SpectralTables.build(n, ny or n, 600_000.0, 600_000.0,
                                device=dev)


@pytest.mark.parametrize("n", SIZES)
def test_ka_diag_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    t = _tables(n, cuda)
    zr, zi = _planes(rng, (n, n // 2 + 1), 2, cuda)
    got = ff.ka_diag(zr, zi, t.rlap, t.kx, t.ky)
    want = ff.ka_diag_plain(zr, zi, t.rlap, t.kx, t.ky)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (4, n // 2 + 1, n)
        for f in range(4):        # the psi fields dwarf the zeta ones
            assert _rel(g[f], w[f]) < TOL, f


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("pair", [(0, 1), (2, 3)])
def test_kb_pair_matches_plain(cuda, n, pair):
    rng = np.random.default_rng(n + 1)
    wr, wi = _planes(rng, (4, n // 2 + 1, n), 2, cuda)
    scale = 1.0 / (n * n)
    got = ff.kb_pair(wr, wi, *pair, scale)
    want = ff.kb_pair_plain(wr, wi, *pair, scale)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (n, n)
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("n", SIZES)
def test_kb_pair_leak_guard(cuda, n):
    """Junk in the imaginary part of the self-conjugate rows 0 and ny/2
    must be projected out, not leaked into the paired field."""
    rng = np.random.default_rng(n + 2)
    wr, wi = _planes(rng, (4, n // 2 + 1, n), 2, cuda)
    clean = wi.clone()
    clean[:, 0] = 0.0
    clean[:, n // 2] = 0.0
    poisoned = clean.clone()
    poisoned[:, 0] = 10.0 * wi[:, 0]
    poisoned[:, n // 2] = -7.0 * wi[:, n // 2]
    a0, b0 = ff.kb_pair(wr, clean, 0, 1, 1.0)
    a1, b1 = ff.kb_pair(wr, poisoned, 0, 1, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(a0, a1) and torch.equal(b0, b1)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("beta", [0.0, 1.6])
def test_ky_adv_matches_plain(cuda, n, beta):
    rng = np.random.default_rng(n + 3)
    u, zx, v, zy, src = _planes(rng, (n, n), 5, cuda)
    got = ff.ky_adv(u, zx, v, zy, src, beta)
    want = ff.ky_adv_plain(u, zx, v, zy, src, beta)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (n, n // 2 + 1)
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("n", SIZES)
def test_kx_visc_matches_plain(cuda, n):
    rng = np.random.default_rng(n + 4)
    t = _tables(n, cuda)
    fr, fi, zsr, zsi = _planes(rng, (n, n // 2 + 1), 4, cuda)
    lap = t.lap / t.lap.abs().max()      # order-one viscous term
    got = ff.kx_visc(fr, fi, lap, t.mask, zsr, zsi, 6.5)
    want = ff.kx_visc_plain(fr, fi, lap, t.mask, zsr, zsi, 6.5)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("shape", [(1, 64, 64), (1, 4096, 4096),
                                   (2, 64, 64), (2, 4096, 4096),
                                   (2, 8192, 8192), (3, 256, 64)])
def test_kx_visc_stack_with_axpy_matches_plain(cuda, shape):
    """The stacked epilogue with the RK stage axpy: F fields with a lap
    table each, a shared mask, and a non-square stack (nx != ny)."""
    nf, nx, ny = shape
    hny = ny // 2 + 1
    rng = np.random.default_rng(nx + nf)
    t = _tables(nx, cuda, ny)
    fr, fi, zsr, zsi, z0r, z0i = _planes(rng, (nf, nx, hny), 6, cuda)
    lap = torch.stack([t.lap * (f + 1) for f in range(nf)])
    lap = lap / lap.abs().max()
    axpy = (z0r, z0i, 0.37)
    got = ff.kx_visc(fr, fi, lap, t.mask, zsr, zsi, 1.0, axpy)
    want = ff.kx_visc_plain(fr, fi, lap, t.mask, zsr, zsi, 1.0, axpy)
    torch.cuda.synchronize()
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.shape == (nf, nx, hny)
        for f in range(nf):
            assert _rel(g[f], w[f]) < TOL, f


@pytest.mark.parametrize("n", SIZES)
def test_kx_visc_axpy_uses_the_unfused_roundings(cuda, n):
    """The axpy outputs equal z0 + coef*r computed by torch from the
    kernel's own r, bit for bit: no FMA contraction in the epilogue."""
    rng = np.random.default_rng(n + 5)
    t = _tables(n, cuda)
    fr, fi, zsr, zsi, z0r, z0i = _planes(rng, (n, n // 2 + 1), 6, cuda)
    rr, ri, nr, ni = ff.kx_visc(fr, fi, t.lap, t.mask, zsr, zsi, 6.5e-9,
                                (z0r, z0i, 1.5))
    assert torch.equal(nr, z0r + 1.5 * rr)
    assert torch.equal(ni, z0i + 1.5 * ri)


@pytest.mark.parametrize("shape", [(64, 64), (4096, 2049), (256, 33)])
@pytest.mark.parametrize("n_planes", [1, 2, 6])
def test_rk4_combine_matches_plain_bit_for_bit(cuda, shape, n_planes):
    rng = np.random.default_rng(shape[0] + n_planes)
    groups = [tuple(_planes(rng, shape, n_planes, cuda)) for _ in range(5)]
    got = fs.plane_rk4_combine(*groups, 0.5)
    want = fs.plane_rk4_combine_plain(*groups, 0.5)
    torch.cuda.synchronize()
    assert len(got) == n_planes
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(64, 64), (4096, 4096), (8192, 8192),
                                   (256, 128)])
def test_ka6_matches_plain(cuda, shape):
    n, ny = shape
    hny = ny // 2 + 1
    rng = np.random.default_rng(n + 6)
    t = _tables(n, cuda, ny)
    sr2, si2 = _planes(rng, (2, n, hny), 2, cuda)
    sr2[1] *= 1e4                      # the tracer dwarfs the vorticity
    si2[1] *= 1e4
    got = ft.tracer_xstage_planes(sr2, si2, t.kx, t.ky, t.rlap)
    want = ft.ka6_plain(sr2, si2, t.rlap, t.kx, t.ky)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (6, hny, n)
        for f in range(6):
            assert _rel(g[f], w[f]) < TOL, f


@pytest.mark.parametrize("shape", [(6, 64, 64), (6, 4096, 4096),
                                   (6, 8192, 8192), (3, 128, 256),
                                   (5, 256, 64)])
def test_kb_pair_on_other_stacks(cuda, shape):
    """F != 4 stacks (the tracer's six fields), the last pair, and
    non-square fields (nx != ny)."""
    nf, ny, nx = shape
    rng = np.random.default_rng(ny + nf)
    wr, wi = _planes(rng, (nf, ny // 2 + 1, nx), 2, cuda)
    scale = 1.0 / (nx * ny)
    for pair in ((nf - 2, nf - 1), (0, nf - 1)):
        got = ff.kb_pair(wr, wi, *pair, scale)
        want = ff.kb_pair_plain(wr, wi, *pair, scale)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == (ny, nx)
            assert _rel(g, w) < TOL, pair


@pytest.mark.parametrize("shape", [(64, 64), (4096, 4096), (8192, 8192),
                                   (256, 128)])
@pytest.mark.parametrize("with_src", [True, False])
@pytest.mark.parametrize("beta", [0.0, 1.6])
def test_kb_adv_tracer_matches_plain(cuda, shape, with_src, beta):
    ny, nx = shape
    hny = ny // 2 + 1
    rng = np.random.default_rng(ny + nx + int(with_src))
    zx, zy, qx, qy, src = _planes(rng, (ny, nx), 5, cuda)
    qx *= 1e4                          # tendencies of very different size
    qy *= 1e4
    wr, wi = _planes(rng, (6, hny, nx), 2, cuda)
    s = src if with_src else None
    got = ft.kb_adv_tracer(zx, zy, qx, qy, wr, wi, s, beta)
    want = ft.kb_adv_tracer_plain(zx, zy, qx, qy, wr, wi, s, beta)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (2, nx, hny)
        for f in range(2):
            assert _rel(g[f], w[f]) < TOL, f


@pytest.mark.parametrize("n", SIZES)
def test_kb_adv_tracer_leak_guard(cuda, n):
    """Junk in the imaginary part of the self-conjugate rows of the u and
    v x-stages is projected out, as in kb_pair."""
    rng = np.random.default_rng(n + 7)
    zx, zy, qx, qy = _planes(rng, (n, n), 4, cuda)
    wr, wi = _planes(rng, (6, n // 2 + 1, n), 2, cuda)
    clean = wi.clone()
    clean[:, 0] = 0.0
    clean[:, n // 2] = 0.0
    poisoned = clean.clone()
    poisoned[:, 0] = 10.0 * wi[:, 0]
    poisoned[:, n // 2] = -7.0 * wi[:, n // 2]
    a = ft.kb_adv_tracer(zx, zy, qx, qy, wr, clean, None, 0.3)
    b = ft.kb_adv_tracer(zx, zy, qx, qy, wr, poisoned, None, 0.3)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("shape", [(256, 256), (4096, 4096), (256, 200),
                                   (1024, 33), (64, 15)])
def test_kb_adv_tracer_is_kb_pair_and_ky_adv_bit_for_bit(cuda, shape):
    """kb_adv_tracer runs kb_pair's inverse and ky_adv's forward transform
    in one cluster, so its zeta plane is ky_adv of kb_pair's u, v and the
    zeta gradients (src given and not) and its q plane ky_adv of the q
    gradients and a zero src, bit for bit, square and on (ny, nx) grids
    whose last tile of C/2 columns is ragged: chip_smoke.py's
    tracer_pins, the one list of them."""
    from chip_smoke import tracer_pins

    ny, nx = shape
    pins = tracer_pins(ny, nx, cuda, np.random.default_rng(ny + nx + 29))
    for name, (got, want) in pins.items():
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name


def test_kb_adv_tracer_refuses_a_plan_it_does_not_take(cuda):
    """kb_adv_tracer checks the plan it is handed: one that is not
    ops/xtile.py's for the length fails the launch."""
    from xlab_fftbarotropic_torch.ops._build import lib

    n = 256
    x = torch.zeros((n, n), device=cuda)
    w = torch.zeros((6, n // 2 + 1, n), device=cuda)
    y = torch.empty((2, n, n // 2 + 1), device=cuda)
    tw = ff._twiddles(n, cuda)
    c, k, threads, smem = ff._xtile_args(n, n, 4)
    for plan in ((c, k, threads + 32, smem), (c, k, threads, smem - 8),
                 (c, 3, threads, smem)):
        assert lib().xfb_kb_adv_tracer(*ff._ptrs(x, x, x, x, w, w, x, tw, y,
                                                 y), n, n, 1.0, 0.0, *plan,
                                       cuda.index, ff._stream(x)) != 0


def test_unsupported_length_raises(cuda):
    x = torch.zeros((96, 96), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):
        ff.ky_adv(x, x, x, x, x)


def test_launch_counts_of_a_segment(cuda):
    """Two steps of the plane stepper launch 4 stages x (1 ka_diag,
    2 kb_pair, 1 ky_adv, 1 kx_visc) and 1 rk4_combine per step, and
    nothing else. The model is built on the bare "cuda" device name."""
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields

    cfg = ModelConfig(nx=64, ny=64)
    m = BarotropicModel.build(cfg, "cuda")
    assert m.device == cuda
    assert m.backend == "pallas"
    z = m.init_state(makefields.gaussian(cfg))
    ff.reset_launches()
    z = m.segment(z, m.zero_source(), 2)
    torch.cuda.synchronize()
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), "ka_diag": 8,
                           "kb_pair": 16, "ky_adv": 8, "kx_visc": 8,
                           "rk4_combine": 2}
    assert bool(torch.isfinite(torch.view_as_real(z)).all())


@pytest.mark.parametrize("n", [64, 1024])
def test_fused_rk_matches_unfused(cuda, n):
    """The fused-RK form (kx_visc axpy + rk4_combine) against the
    unfused one (torch elementwise) on the card: both round every
    product and sum on its own, so 3 steps agree bit for bit."""
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields

    cfg = ModelConfig(nx=n, ny=n, beta=1e-11, r_drag=1e-6)
    fused = BarotropicModel.build(cfg, cuda)
    unfused = BarotropicModel.build(cfg, cuda, fused_rk=False)
    z = fused.init_state(makefields.gaussian(cfg))
    src = fused.zero_source()
    a = fused.segment(z, src, 3)
    b = unfused.segment(z, src, 3)
    assert torch.equal(a, b)


def test_tracer_launch_counts_and_library_agreement(cuda):
    """Two tracer steps launch 4 stages x (1 ka6, 2 kb_pair,
    1 kb_adv_tracer, 1 kx_visc) and 1 rk4_combine per step, and agree
    with the torch.fft library path to rel-L2 1e-5 per field."""
    from xlab_fftbarotropic_torch.models.tracer import TracerModel, tracer_ic
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields

    cfg = ModelConfig(nx=256, ny=256)
    m = TracerModel.build(cfg, "cuda", kappa=50.0)
    lib = TracerModel.build(cfg.replace(fft_backend="xla"), cuda,
                            kappa=50.0)
    assert m.backend == "pallas" and lib.backend == "xla"
    v0 = makefields.gaussian(cfg)
    s0 = m.init_state(v0, tracer_ic(cfg, "gaussian"))
    ff.reset_launches()
    s = m.segment(s0, m.zero_source(), 2)
    torch.cuda.synchronize()
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), "kb_pair": 16,
                           "kx_visc": 8, "ka6": 8, "kb_adv_tracer": 8,
                           "rk4_combine": 2}
    ref = lib.segment(s0, lib.zero_source(), 2)
    for got, want in zip(s, ref):
        rel = float(torch.linalg.vector_norm(got - want)
                    / torch.linalg.vector_norm(want))
        assert rel < TOL


# ------------------------------------------------------ shallow-water kernels

def _sw_state(rng, nx, ny, dev):
    """Six state planes at the bench's magnitudes: zeta 1e-4, div 1e-6,
    eta 5 m (the spectra of such fields, up to a common factor)."""
    hny = ny // 2 + 1
    amps = (1e-4, 1e-4, 1e-6, 1e-6, 5.0, 5.0)
    return [a * p for a, p in zip(amps, _planes(rng, (nx, hny), 6, dev))]


@pytest.mark.parametrize("shape", [(64, 64), (256, 256), (4096, 4096),
                                   (8192, 8192), (256, 128), (128, 512)])
def test_ka_sw_matches_plain(cuda, shape):
    nx, ny = shape
    rng = np.random.default_rng(nx + ny + 8)
    t = _tables(nx, cuda, ny)
    state = _sw_state(rng, nx, ny, cuda)
    es = float(fs.eta_pair_scale(state))
    got = fs.ka_sw(*state, t.rlap, t.kx, t.ky, es)
    want = fs.ka_sw_plain(*state, t.rlap, t.kx, t.ky, es)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (4, ny // 2 + 1, nx)
        for f in range(4):
            assert _rel(g[f], w[f]) < TOL, f


@pytest.mark.parametrize("n", [64, 4096])
def test_ka_sw_then_kb_pair_leak_guard(cuda, n):
    """Junk in the imaginary part of the self-conjugate rows of the SW
    x-stage stack is projected out by the kb_pair that follows ka_sw."""
    rng = np.random.default_rng(n + 9)
    t = _tables(n, cuda)
    state = _sw_state(rng, n, n, cuda)
    wr, wi = fs.ka_sw(*state, t.rlap, t.kx, t.ky,
                      float(fs.eta_pair_scale(state)))
    clean = wi.clone()
    clean[:, 0] = 0.0
    clean[:, n // 2] = 0.0
    poisoned = clean.clone()
    poisoned[:, 0] = 10.0 * wi[:, 0] + 1.0
    poisoned[:, n // 2] = -7.0 * wi[:, n // 2]
    for pair in ((0, 1), (2, 3)):
        a = ff.kb_pair(wr, clean, *pair, 1.0 / (n * n))
        b = ff.kb_pair(wr, poisoned, *pair, 1.0 / (n * n))
        torch.cuda.synchronize()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), pair


@pytest.mark.parametrize("shape", [(64, 64), (256, 256), (4096, 4096),
                                   (8192, 8192), (256, 128), (128, 512)])
@pytest.mark.parametrize("split", [False, True])
def test_ky_all_matches_plain(cuda, shape, split):
    """Each of the five products to 1e-5 of its own max, at the bench's
    magnitudes (q u about 1e-3, phi about 50): no product may take
    another's round-off. 8192: the column tile's C = 8, K = 8 plan."""
    ny, nx = shape
    rng = np.random.default_rng(ny + nx + int(split))
    u, v, zeta, eta_s = _planes(rng, (ny, nx), 4, cuda)
    u *= 3.0
    v *= 3.0
    zeta *= 1e-4
    eta_s *= 1e-4                      # eta * eta_scale, eta_scale 2^-15
    args = (u, v, zeta, eta_s, 2.0 ** 15, 1e-4, 9.81, split)
    got = fs.ky_all(*args)
    want = fs.ky_all_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (5, nx, ny // 2 + 1)
        for p in range(5):
            assert _rel(g[p], w[p]) < TOL, p


@pytest.mark.parametrize("shape", [(5, 64, 64), (5, 4096, 4096),
                                   (5, 8192, 8192), (5, 256, 128),
                                   (3, 128, 512), (1, 64, 256)])
def test_kx_fwd_matches_plain(cuda, shape):
    nf, nx, ny = shape
    hny = ny // 2 + 1
    rng = np.random.default_rng(nx + ny + nf)
    fr, fi = _planes(rng, (nf, nx, hny), 2, cuda)
    fr[0] *= 1e5                       # fields of very different size
    got = fs.kx_fwd(fr, fi)
    want = fs.kx_fwd_plain(fr, fi)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (nf, nx, hny)
        for f in range(nf):
            assert _rel(g[f], w[f]) < TOL, f


def _combine_inputs(rng, nx, ny, dev):
    hny = ny // 2 + 1
    t = _tables(nx, dev, ny)
    pr, pi = _planes(rng, (5, nx, hny), 2, dev)
    state = _sw_state(rng, nx, ny, dev)
    src = _planes(rng, (nx, hny), 2, dev)
    z0 = _sw_state(rng, nx, ny, dev)   # base state, not the stage state
    return t, pr, pi, state, src, z0


@pytest.mark.parametrize("shape", [(64, 64), (4096, 4096), (8192, 8192),
                                   (256, 128), (128, 512)])
@pytest.mark.parametrize("with_src", [True, False])
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("coef", [None, 0.4235])
def test_sw_combine_matches_plain_bit_for_bit(cuda, shape, with_src, split,
                                              coef):
    """Every product and sum rounds on its own in the plain version's
    order, so the kernel gives its bits; with the axpy the next stage
    state reads the BASE state z0, which differs from the stage state."""
    nx, ny = shape
    rng = np.random.default_rng(nx + ny + 11)
    t, pr, pi, state, src, z0 = _combine_inputs(rng, nx, ny, cuda)
    args = (pr, pi, state, src if with_src else None, t.kx, t.ky, t.lap,
            t.mask, 1e-4, 9.81, 6.5e-9 * 1e4, 4000.0, split,
            None if coef is None else (z0, coef))
    got = fs.sw_combine(*args)
    want = fs.sw_combine_plain(*args)
    torch.cuda.synchronize()
    if coef is None:
        got, want = (got,), (want,)
    else:
        nxt = got[1]
        for c in range(6):
            assert torch.equal(nxt[c], z0[c] + coef * got[0][c]), c
            assert not torch.equal(nxt[c], state[c] + coef * got[0][c]), c
    for gs, ws in zip(got, want):
        assert len(gs) == 6
        for c, (g, w) in enumerate(zip(gs, ws)):
            assert g.shape == (nx, ny // 2 + 1)
            assert torch.equal(g, w), c


@pytest.mark.parametrize("shape", [(64, 64), (4096, 4096), (8192, 64),
                                   (256, 128), (64, 512)])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("real_input", [True, False])
def test_ka_matches_plain(cuda, shape, forward, real_input):
    n, m = shape
    rng = np.random.default_rng(n + m + 2 * forward + real_input)
    xr, xi = _planes(rng, (n, m), 2, cuda)
    xi = None if real_input else xi
    got = ff.ka(xr, xi, forward, 0.37)
    want = ff.ka_plain(xr, xi, forward, 0.37)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (m, n)
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("shape", [(64, 64), (4096, 4096), (8192, 8192),
                                   (256, 128), (64, 512)])
def test_kc_matches_plain(cuda, shape):
    ny, nx = shape
    rng = np.random.default_rng(ny + nx + 12)
    xr, xi = _planes(rng, (ny, nx), 2, cuda)
    got = ff.kc(xr, xi)
    want = ff.kc_plain(xr, xi)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (nx, ny // 2 + 1)
        assert _rel(g, w) < TOL


def test_forward_planes_is_the_rfft2(cuda):
    rng = np.random.default_rng(13)
    src = _planes(rng, (256, 128), 1, cuda)[0]
    got = fs.forward_planes(src)
    want = torch.fft.rfft2(src)
    torch.cuda.synchronize()
    assert _rel(got[0], want.real) < TOL and _rel(got[1], want.imag) < TOL


def _phys_err(a, b, n):
    """Max abs error of zeta, div and eta over the JAX package's norms
    (tests/test_pallas_sw.py:_assert_close_phys): div by max(|div|,
    |zeta|)."""
    pa = [torch.fft.irfft2(z, s=(n, n)) for z in a]
    pb = [torch.fft.irfft2(z, s=(n, n)) for z in b]
    nz = float(pb[0].abs().max())
    norms = (nz, max(float(pb[1].abs().max()), nz), float(pb[2].abs().max()))
    return [float((x - y).abs().max()) / m for x, y, m in zip(pa, pb, norms)]


def test_sw_launch_counts_and_library_agreement(cuda):
    """Two SW steps launch 4 stages x (1 ka_sw, 2 kb_pair, 1 ky_all,
    1 kx_fwd, 1 sw_combine) and 1 rk4_combine per step, and 1 ka and 1 kc
    for the forcing spectrum of the segment; they agree with the
    torch.fft library path to 1e-5 (the JAX package's bar for its two SW
    paths after one step)."""
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel, max_stable_dt)
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields

    cfg = ModelConfig(nx=256, ny=256)
    cfg = cfg.replace(dt=min(3.0, max_stable_dt(cfg)))
    m = ShallowWaterModel.build(cfg, "cuda")
    lib = ShallowWaterModel.build(cfg.replace(fft_backend="xla"), cuda)
    assert m.backend == "pallas" and lib.backend == "xla"
    s0 = m.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5))
    ff.reset_launches()
    s = m.segment(s0, m.zero_source(), 2)
    torch.cuda.synchronize()
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), "ka_sw": 8,
                           "kb_pair": 16, "ky_all": 8, "kx_fwd": 8,
                           "sw_combine": 8, "rk4_combine": 2, "ka": 1,
                           "kc": 1}
    ref = lib.segment(s0, lib.zero_source(), 2)
    assert max(_phys_err(s, ref, 256)) < TOL


@pytest.mark.parametrize("shape", [(64, 64), (4096, 4096), (8192, 8192),
                                   (256, 128), (128, 512)])
@pytest.mark.parametrize("with_src", [True, False])
@pytest.mark.parametrize("emit_tend", [True, False])
@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_sw_combine_mv_matches_plain_bit_for_bit(cuda, shape, with_src,
                                                 emit_tend, scale):
    """The ETDRK4 stage z0 + scale (Q @ tendency) in the plain version's
    grouping, bit for bit, with tendencies that are sw_combine's bits."""
    nx, ny = shape
    rng = np.random.default_rng(nx + ny + 21)
    t, pr, pi, state, src, z0 = _combine_inputs(rng, nx, ny, cuda)
    q = torch.stack(_planes(rng, (3, nx, ny // 2 + 1), 3, cuda)) * 10.0
    args = (pr, pi, state, src if with_src else None, t.kx, t.ky, t.lap,
            t.mask, 0.0, 0.0, 0.0, 0.0, z0, q, scale, emit_tend)
    got_t, got_s = fs.sw_combine_mv(*args)
    want_t, want_s = fs.sw_combine_mv_plain(*args)
    tend = fs.sw_combine(*args[:12])
    torch.cuda.synchronize()
    assert (got_t is None) == (not emit_tend)
    for c in range(6):
        assert torch.equal(got_s[c], want_s[c]), c
        if emit_tend:
            assert torch.equal(got_t[c], tend[c]), c


def test_sw_etd_launch_counts_and_library_agreement(cuda):
    """Two SW ETDRK4 steps launch 4 stages x (1 ka_sw, 2 kb_pair,
    1 ky_all, 1 kx_fwd, 1 sw_combine_mv) per step and no sw_combine or
    rk4_combine, 1 ka and 1 kc per segment; fused and unfused forms and
    the library path agree to 1e-5 over the JAX norms."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel, max_stable_dt)

    cfg = ModelConfig(nx=256, ny=256, time_scheme="etdrk4")
    cfg = cfg.replace(dt=8.85 * max_stable_dt(cfg))
    m = ShallowWaterModel.build(cfg, cuda)
    unfused = ShallowWaterModel.build(cfg, cuda, etd_fuse=False)
    lib = ShallowWaterModel.build(cfg.replace(fft_backend="xla"), cuda)
    s0 = m.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5))
    ff.reset_launches()
    s = m.segment(s0, m.zero_source(), 2)
    torch.cuda.synchronize()
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), "ka_sw": 8,
                           "kb_pair": 16, "ky_all": 8, "kx_fwd": 8,
                           "sw_combine_mv": 8, "ka": 1, "kc": 1}
    for other in (unfused, lib):
        ref = other.segment(s0, other.zero_source(), 2)
        assert max(_phys_err(s, ref, 256)) < TOL


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("paired", [True, False])
def test_kb_matches_plain(cuda, n, paired):
    """The x-major paired c2r y-stage (and its single form, no partner)
    against its plain version."""
    rng = np.random.default_rng(n + 31)
    w = _planes(rng, (n // 2 + 1, n), 4, cuda)
    if not paired:
        w[2:] = [None, None]
    scale = 1.0 / (n * n)
    got = ff.kb(*w, scale)
    want = ff.kb_plain(*w, scale)
    torch.cuda.synchronize()
    assert got[0].shape == (n, n) and _rel(got[0], want[0]) < TOL
    if paired:
        assert _rel(got[1], want[1]) < TOL
    else:
        assert got[1] is None


@pytest.mark.parametrize("n", SIZES)
def test_kb_leak_guard(cuda, n):
    """Junk in the imaginary part of the self-conjugate rows 0 and ny/2
    is projected out, not leaked into the paired field."""
    rng = np.random.default_rng(n + 32)
    war, wai, wbr, wbi = _planes(rng, (n // 2 + 1, n), 4, cuda)
    for w in (wai, wbi):
        w[0] = 0.0
        w[n // 2] = 0.0
    clean = ff.kb(war, wai, wbr, wbi, 1.0)
    pai, pbi = wai.clone(), wbi.clone()
    pai[0] = 10.0
    pbi[n // 2] = -7.0
    dirty = ff.kb(war, pai, wbr, pbi, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(clean[0], dirty[0]) and torch.equal(clean[1], dirty[1])


@pytest.mark.parametrize("shape", [(64, 64), (4096, 2049), (256, 33)])
@pytest.mark.parametrize("n_planes", [1, 2, 6])
def test_plane_axpy_matches_plain_bit_for_bit(cuda, shape, n_planes):
    rng = np.random.default_rng(shape[0] + n_planes + 40)
    s = tuple(_planes(rng, shape, n_planes, cuda))
    r = tuple(_planes(rng, shape, n_planes, cuda))
    got = fs.plane_axpy(s, r, 0.4235)
    want = fs.plane_axpy_plain(s, r, 0.4235)
    torch.cuda.synchronize()
    assert len(got) == n_planes
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_sw_drag_and_unfused_launch_counts_and_agreement(cuda):
    """Two SW RK4 steps with drag and hyperviscosity on the per-transform
    kernels launch 4 stages x (10 ka, 2 kb, 6 kc) per step and agree with
    the library path to 1e-5 over the JAX norms; the unfused plane form
    launches 3 plane_axpy per step beside the fused form's kernels less
    its axpy, and gives the fused form's bits."""
    import warnings

    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel, max_stable_dt)

    cfg = ModelConfig(nx=256, ny=256)
    cfg = cfg.replace(dt=max_stable_dt(cfg))
    drag = cfg.replace(r_drag=2e-4, nu4=1e9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = ShallowWaterModel.build(drag, cuda)
    lib = ShallowWaterModel.build(drag.replace(fft_backend="xla"), cuda)
    assert m.per_transform and not lib.per_transform
    s0 = m.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5))
    ff.reset_launches()
    s = m.segment(s0, m.zero_source(), 2)
    torch.cuda.synchronize()
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), "ka": 80,
                           "kb": 16, "kc": 48}
    assert max(_phys_err(s, lib.segment(s0, lib.zero_source(), 2),
                         256)) < TOL
    fused = ShallowWaterModel.build(cfg, cuda)
    unfused = ShallowWaterModel.build(cfg, cuda, fused_rk=False)
    ff.reset_launches()
    b = unfused.segment(s0, unfused.zero_source(), 2)
    torch.cuda.synchronize()
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), "ka_sw": 8,
                           "kb_pair": 16, "ky_all": 8, "kx_fwd": 8,
                           "sw_combine": 8, "plane_axpy": 6,
                           "rk4_combine": 2, "ka": 1, "kc": 1}
    a = fused.segment(s0, fused.zero_source(), 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_adjoint_gradient_on_the_kernels(cuda):
    """A 3-step barotropic rollout gradient at 256² through the
    per-transform kernels against the torch.fft path's, rel-L2 <= 5e-4,
    with the launches of both sweeps: the forward 4 stages x (5 ka,
    2 kb, 1 kc) per step, run twice (once more when the checkpointed
    segments are recomputed), the backward 4 x (5 ka, 1 kb, 4 kc), and
    the transforms at the ends (forward of the IC, inverse of the final
    state) and their adjoints: 60n + 4 ka, 20n + 2 kb, 24n + 2 kc."""
    from xlab_fftbarotropic_torch import adjoint
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields

    n = 3
    cfg = ModelConfig(nx=256, ny=256)
    truth = makefields.gaussian(cfg)
    src = torch.zeros(cfg.grid_shape, device=cuda)
    with torch.no_grad():
        target = adjoint.make_rollout(cfg, n, device=cuda)(truth, src)
    grads = {}
    for backend in ("xla", "pallas"):
        loss = adjoint.final_state_misfit(cfg.replace(fft_backend=backend),
                                          target, n, device=cuda)
        ff.reset_launches()
        _, grads[backend] = adjoint.loss_and_grad(loss, device=cuda)(
            0.9 * truth, src)
        torch.cuda.synchronize()
        if backend == "pallas":
            assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0),
                                   "ka": 60 * n + 4, "kb": 20 * n + 2,
                                   "kc": 24 * n + 2}
    a, b = grads["pallas"], grads["xla"]
    assert float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b)) < 5e-4


# ------------------------------------------------------- the x-first order

@pytest.mark.parametrize("shape", [(64, 64), (4096, 4096), (8192, 8192),
                                   (256, 128), (128, 512)])
@pytest.mark.parametrize("beta", [0.0, 1.6])
def test_ka_adv_matches_plain(cuda, shape, beta):
    nx, ny = shape
    rng = np.random.default_rng(nx + ny + 50)
    u, zx, v, zy, src = _planes(rng, (nx, ny), 5, cuda)
    got = ff.ka_adv(u, zx, v, zy, src, beta)
    want = ff.ka_adv_plain(u, zx, v, zy, src, beta)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (ny, nx)
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("shape", [(64, 64), (4096, 4096), (8192, 8192),
                                   (256, 128), (64, 512)])
def test_kc_visc_matches_plain(cuda, shape):
    ny, nx = shape
    rng = np.random.default_rng(ny + nx + 51)
    t = _tables(nx, cuda, ny)
    xr, xi = _planes(rng, (ny, nx), 2, cuda)
    zr, zi = _planes(rng, (nx, ny // 2 + 1), 2, cuda)
    lap = t.lap / t.lap.abs().max()      # order-one viscous term
    got = ff.kc_visc(xr, xi, lap, t.mask, zr, zi, 6.5)
    want = ff.kc_visc_plain(xr, xi, lap, t.mask, zr, zi, 6.5)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (nx, ny // 2 + 1)
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("shape", [(64, 64), (4096, 4096), (8192, 8192),
                                   (256, 128)])
@pytest.mark.parametrize("fields", [(0, 4), (0, 2), (2, 2)])
def test_ka_quad_matches_plain(cuda, shape, fields):
    """The psi-first x-stage, quad (four fields) and each split half."""
    n, ny = shape
    hny = ny // 2 + 1
    rng = np.random.default_rng(n + ny + 52)
    t = _tables(n, cuda, ny)
    zr, zi = _planes(rng, (n, hny), 2, cuda)
    got = ff.ka_quad(zr, zi, t.rlap, t.kx, t.ky, *fields)
    want = ff.ka_quad_plain(zr, zi, t.rlap, t.kx, t.ky, *fields)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (fields[1], hny, n)
        for f in range(fields[1]):     # the psi fields dwarf the zeta ones
            assert _rel(g[f], w[f]) < TOL, f


@pytest.mark.parametrize("n", SIZES)
def test_kb_stacked_matches_plain_and_guards_leaks(cuda, n):
    """The x-major kb on fields of a (4, hny, nx) stack against its plain
    version, and junk in the imaginary part of the self-conjugate rows 0
    and ny/2 projected out, not leaked into the paired field."""
    rng = np.random.default_rng(n + 53)
    wr, wi = _planes(rng, (4, n // 2 + 1, n), 2, cuda)
    clean = wi.clone()
    clean[:, 0] = 0.0
    clean[:, n // 2] = 0.0
    poisoned = clean.clone()
    poisoned[:, 0] = 10.0 * wi[:, 0] + 1.0
    poisoned[:, n // 2] = -7.0 * wi[:, n // 2]
    scale = 1.0 / (n * n)
    for pair in ((0, 1), (2, 3)):
        got = ff.kb_stacked(wr, wi, *pair, scale)
        want = ff.kb_plain(wr[pair[0]], wi[pair[0]], wr[pair[1]],
                           wi[pair[1]], scale)
        a = ff.kb_stacked(wr, clean, *pair, scale)
        b = ff.kb_stacked(wr, poisoned, *pair, scale)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == (n, n) and _rel(g, w) < TOL, pair
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), pair


@pytest.mark.parametrize("shape", [(64, 64), (256, 256), (4096, 4096),
                                   (8192, 8192), (256, 128), (128, 512)])
@pytest.mark.parametrize("split", [False, True])
def test_ka_fwd_matches_plain(cuda, shape, split):
    """Each of the five x-first products to 1e-5 of its own max, at the
    bench's magnitudes (the ky_all test's)."""
    nx, ny = shape
    rng = np.random.default_rng(nx + ny + 54 + int(split))
    u, v, zeta, eta_s = _planes(rng, (nx, ny), 4, cuda)
    u *= 3.0
    v *= 3.0
    zeta *= 1e-4
    eta_s *= 1e-4
    args = (u, v, zeta, eta_s, 2.0 ** 15, 1e-4, 9.81, split)
    got = fs.ka_fwd(*args)
    want = fs.ka_fwd_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (5, ny, nx)
        for p in range(5):
            assert _rel(g[p], w[p]) < TOL, p


@pytest.mark.parametrize("shape", [(5, 64, 64), (5, 4096, 4096),
                                   (5, 8192, 8192), (5, 256, 128),
                                   (3, 128, 512), (1, 64, 256)])
def test_kc_sw_matches_plain(cuda, shape):
    nf, ny, nx = shape
    rng = np.random.default_rng(nx + ny + nf + 55)
    xr, xi = _planes(rng, (nf, ny, nx), 2, cuda)
    xr[0] *= 1e5                       # fields of very different size
    got = fs.kc_sw(xr, xi)
    want = fs.kc_sw_plain(xr, xi)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (nf, nx, ny // 2 + 1)
        for f in range(nf):
            assert _rel(g[f], w[f]) < TOL, f


@pytest.mark.parametrize("form", ["xfirst", "quad", "split", "etdrk4"])
def test_xfirst_launch_counts_and_yfirst_agreement(cuda, form):
    """Two barotropic x-first steps launch per stage the x-stage (ka_diag,
    or ka_quad once for quad and twice for split), 2 kb, 1 ka_adv and
    1 kc_visc, and nothing else (the stage updates are torch); they agree
    with the y-first kernel path to rel-L2 1e-5."""
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields

    cfg = ModelConfig(nx=256, ny=256, beta=1e-11)
    if form == "etdrk4":
        cfg = cfg.replace(beta=0.0, time_scheme="etdrk4")
    quad_mode = form if form in ("quad", "split") else "grid"
    m = BarotropicModel.build(cfg, cuda, yfirst=False, quad_mode=quad_mode)
    ref = BarotropicModel.build(cfg, cuda)
    z = m.init_state(makefields.gaussian(cfg))
    src = 1e-9 * torch.randn(cfg.grid_shape, device=cuda)
    ff.reset_launches()
    a = m.segment(z, src, 2)
    torch.cuda.synchronize()
    xstage = {"grid": {"ka_diag": 8}, "quad": {"ka_quad": 8},
              "split": {"ka_quad": 16}}[quad_mode]
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), **xstage,
                           "kb": 16, "ka_adv": 8, "kc_visc": 8}
    b = ref.segment(z, src, 2)
    assert float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b)) < TOL


@pytest.mark.parametrize("scheme", ["rk4", "etdrk4"])
def test_sw_xfirst_launch_counts_and_yfirst_agreement(cuda, scheme):
    """Two SW x-first steps launch per stage 1 ka_sw, 2 kb, 1 ka_fwd,
    1 kc_sw and the combine of the scheme (sw_combine, with 1
    rk4_combine per step, or sw_combine_mv), and 1 ka and 1 kc per
    segment; they agree with the y-first kernel path to 1e-5 over the
    JAX norms."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel, max_stable_dt)

    cfg = ModelConfig(nx=256, ny=256, time_scheme=scheme)
    cfg = cfg.replace(dt=(8.85 if scheme == "etdrk4" else 1.0)
                      * max_stable_dt(cfg))
    m = ShallowWaterModel.build(cfg, cuda, yfirst=False)
    ref = ShallowWaterModel.build(cfg, cuda)
    s0 = m.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5))
    ff.reset_launches()
    s = m.segment(s0, m.zero_source(), 2)
    torch.cuda.synchronize()
    combine = ({"sw_combine": 8, "rk4_combine": 2} if scheme == "rk4"
               else {"sw_combine_mv": 8})
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), "ka_sw": 8,
                           "kb": 16, "ka_fwd": 8, "kc_sw": 8, **combine,
                           "ka": 1, "kc": 1}
    assert max(_phys_err(s, ref.segment(s0, ref.zero_source(), 2),
                         256)) < TOL


# ------------------------------------------- the barotropic fusion arms

# per step, each arm's kernels of the fused-RK y-first stepper: ka_diag 4
# and (default) kb_pair 8 + ky_adv 4, kx_visc 4, rk4_combine 1
_ARM_FIRST = {"": {"kb_pair": 8, "ky_adv": 4}, "full": {"kb_adv_full": 4},
              "half": {"kb_pair": 4, "kb_adv_half": 4}}


def _arm_launches(fusekb="", fusekx=True, fusetail=False, fused_rk=True,
                  etd=False):
    """Launches per step of an arm: the first forward stage
    by fusekb, kx_visc or kx_fwd + visc, and the tail's kernel."""
    out = {"ka_diag": 4, **_ARM_FIRST[fusekb]}
    out.update({"kx_visc": 4} if fusekx else {"kx_fwd": 4, "visc": 4})
    if not etd and fused_rk:
        if fusetail and fusekx:
            out.update(kx_visc=3, kx_visc_tail=1)
        else:
            out["rk4_combine"] = 1
    return out


def _kb_adv_inputs(rng, ny, nx, dev):
    """ka_diag's stack at a size that makes the physical fields, after
    the 1/(nx ny) scale, of order one, as src and the y-major zx, zy."""
    wr, wi = (w * nx * ny ** 0.5
              for w in _planes(rng, (4, ny // 2 + 1, nx), 2, dev))
    zx, zy, src = _planes(rng, (ny, nx), 3, dev)
    return wr, wi, zx, zy, src


@pytest.mark.parametrize("shape", [(64, 64), (4096, 4096), (8192, 8192),
                                   (256, 128)])
@pytest.mark.parametrize("mode", ["full", "half"])
@pytest.mark.parametrize("beta", [0.0, 1.6])
def test_kb_adv_matches_plain(cuda, shape, mode, beta):
    """kb_adv_full / kb_adv_half against their plain versions (kb_pair x2
    or x1 + ky_adv in torch), square and non-square (ny, nx)."""
    ny, nx = shape
    rng = np.random.default_rng(ny + nx + int(beta))
    wr, wi, zx, zy, src = _kb_adv_inputs(rng, ny, nx, cuda)
    if mode == "full":
        got = ff.kb_adv_full(wr, wi, src, beta)
        want = ff.kb_adv_full_plain(wr, wi, src, beta)
    else:
        got = ff.kb_adv_half(zx, zy, wr, wi, src, beta)
        want = ff.kb_adv_half_plain(zx, zy, wr, wi, src, beta)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (nx, ny // 2 + 1)
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode", ["full", "half"])
def test_kb_adv_is_kb_pair_and_ky_adv_bit_for_bit(cuda, n, mode):
    """The fused kernels give the bits of the kernels they replace
    (kb_pair x2 or x1 + ky_adv on the card), beta on, and junk in the
    imaginary part of the self-conjugate rows changes nothing."""
    rng = np.random.default_rng(n + 8)
    wr, wi, _, _, src = _kb_adv_inputs(rng, n, n, cuda)
    scale = 1.0 / (n * n)
    zx, zy = ff.kb_pair(wr, wi, 0, 1, scale)
    u, v = ff.kb_pair(wr, wi, 2, 3, scale)
    want = ff.ky_adv(u, zx, v, zy, src, 1.6)
    fused = (lambda w: ff.kb_adv_full(wr, w, src, 1.6) if mode == "full"
             else ff.kb_adv_half(zx, zy, wr, w, src, 1.6))
    got = fused(wi)
    poisoned = wi.clone()
    poisoned[:, 0] = 10.0 * wi[:, 0] + 1.0
    poisoned[:, n // 2] = -7.0 * wi[:, n // 2]
    dirty = fused(poisoned)
    torch.cuda.synchronize()
    for g, d, w in zip(got, dirty, want):
        assert torch.equal(g, w)
        assert torch.equal(d, w)


@pytest.mark.parametrize("shape", [(64, 64), (4096, 4096), (8192, 8192),
                                   (2, 256, 64)])
def test_kx_visc_tail_matches_plain_and_the_unfused_kernels(cuda, shape):
    """kx_visc_tail against its plain version (kx_visc + rk4_combine in
    torch) to 1e-5, and bit for bit against the kernels it replaces
    (kx_visc, then rk4_combine over each field's planes)."""
    nx, ny = shape[-2:]
    hny = ny // 2 + 1
    pshape = shape[:-2] + (nx, hny)
    rng = np.random.default_rng(nx + len(shape))
    t = _tables(nx, cuda, ny)
    fr, fi, zsr, zsi = _planes(rng, pshape, 4, cuda)
    tail = (*_planes(rng, pshape, 8, cuda), 0.5)
    lap = (t.lap / t.lap.abs().max()).expand(pshape).contiguous()
    got = ff.kx_visc_tail(fr, fi, lap, t.mask, zsr, zsi, 6.5, tail)
    want = ff.kx_visc_tail_plain(fr, fi, lap, t.mask, zsr, zsi, 6.5, tail)
    r4 = ff.kx_visc(fr, fi, lap, t.mask, zsr, zsi, 6.5)
    z0, r1, r2, r3 = (tail[k:k + 2] for k in range(0, 8, 2))
    unfused = fs.plane_rk4_combine(z0, r1, r2, r3, r4, 0.5)
    torch.cuda.synchronize()
    for g, w, u in zip(got, want, unfused):
        assert g.shape == pshape
        assert _rel(g, w) < TOL
        assert torch.equal(g, u)


@pytest.mark.parametrize("shape", [(64, 64), (4096, 4096), (8192, 8192),
                                   (256, 64)])
@pytest.mark.parametrize("coef", [None, 0.4235])
def test_visc_matches_plain_and_kx_visc_bit_for_bit(cuda, shape, coef):
    """visc against its plain version bit for bit (both round every
    product and sum), and kx_fwd + visc against kx_visc's fused
    epilogue bit for bit."""
    nx, ny = shape
    hny = ny // 2 + 1
    rng = np.random.default_rng(nx + ny + (coef is None))
    t = _tables(nx, cuda, ny)
    fr, fi, zsr, zsi, z0r, z0i = _planes(rng, (nx, hny), 6, cuda)
    lap = t.lap / t.lap.abs().max()
    axpy = None if coef is None else (z0r, z0i, coef)
    got = ff.visc(fr, fi, lap, t.mask, zsr, zsi, 6.5, axpy)
    want = ff.visc_plain(fr, fi, lap, t.mask, zsr, zsi, 6.5, axpy)
    gr, gi = fs.kx_fwd(fr[None], fi[None])
    split = ff.visc(gr[0], gi[0], lap, t.mask, zsr, zsi, 6.5, axpy)
    fused = ff.kx_visc(fr, fi, lap, t.mask, zsr, zsi, 6.5, axpy)
    torch.cuda.synchronize()
    assert len(got) == (2 if coef is None else 4)
    for g, w, s, f in zip(got, want, split, fused):
        assert torch.equal(g, w)
        assert torch.equal(s, f)


def test_fusion_kernels_refuse_what_they_do_not_take(cuda):
    w = torch.zeros((4, 49, 96), device=cuda)
    f = torch.zeros((96, 96), device=cuda)
    with pytest.raises(ValueError):          # ny = 96: not a power of two
        ff.kb_adv_full(w, w, f)
    with pytest.raises(ValueError):
        ff.kb_adv_half(f, f, w, w, f)


@pytest.mark.parametrize("arm", [dict(fusekb="full"), dict(fusekb="half"),
                                 dict(fusekx=False), dict(fusetail=True),
                                 dict(fusekb="full", fusetail=True),
                                 dict(fused_rk=False, fusekx=False),
                                 dict(fusekb="full", etd=True),
                                 dict(fusekx=False, etd=True)])
def test_fusion_arm_launch_counts_and_default_bits(cuda, arm):
    """Three forced steps of each fusion arm (RK4 on the beta-plane, or
    ETDRK4) launch exactly its kernels, and give the bits of the default
    arm of the same form."""
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields

    kw = dict(arm)
    etd = kw.pop("etd", False)
    cfg = (ModelConfig(nx=256, ny=256, time_scheme="etdrk4")
           if etd else ModelConfig(nx=256, ny=256, beta=1e-11))
    m = BarotropicModel.build(cfg, cuda, **kw)
    ref = BarotropicModel.build(cfg, cuda, fused_rk=kw.get("fused_rk", True))
    z = m.init_state(makefields.gaussian(cfg))
    src = 1e-9 * torch.randn(cfg.grid_shape, device=cuda)
    ff.reset_launches()
    a = m.segment(z, src, 3)
    torch.cuda.synchronize()
    want = {k: 3 * v for k, v in _arm_launches(etd=etd, **kw).items()}
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), **want}
    assert torch.equal(a, ref.segment(z, src, 3))


# ----- fast mode: rows 1, 2, 9, 4 on the fast column tile -----

FAST_NAMES = ["ka_diag_fast", "kb_pair_fast", "kb_adv_half_fast",
              "kx_visc_fast", "ka_sw_fast", "ky_all_fast", "kx_fwd_fast",
              "kx_fwd_fast_f32", "ka6_fast", "kb_adv_tracer_fast",
              "kx_visc_tracer_fast", "ky_adv_fast", "kb_adv_full_fast",
              "kx_visc_tail_fast", "kx_fwd_bt_fast", "kx_visc_none_fast",
              "ka_quad_fast", "ka_quad_split_fast", "kb_xmajor_fast",
              "ka_adv_fast", "kc_visc_fast", "ka_fwd_fast", "kc_sw_fast",
              "ka_fast", "ka_inverse_fast", "kc_fast", "kb_single_fast",
              "xstage_fast", "xstage_gather_fast", "xstage_scatter_fast",
              "ky_all_nosplit_fast"]
# (transform length, columns): None the n x n grid's (chip_smoke.py
# FAST_SHAPES); 200 and 33 columns end in ragged tiles
FAST_SHAPES = [(64, None), (256, None), (4096, None), (256, 200),
               (1024, 33)]


@pytest.mark.parametrize("shape", FAST_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1] or 'grid'}")
@pytest.mark.parametrize("name", FAST_NAMES)
def test_fast_kernel_matches_plain_and_strict(cuda, name, shape):
    """Each fast kernel equals its plain version bit for bit on
    exact-arithmetic inputs (small integers whose tensor-core sums are
    exact: the fragment layouts), lies within rel-L2 1e-4 of it on random
    inputs, and within rel-L2 1e-4 .. 1e-2 of the strict kernel (it
    really rounds to bf16, and stays in class): chip_smoke.py's
    fast_check on its fast_cases."""
    from chip_smoke import FAST_ARM_KERNELS, FAST_SW_KERNELS, fast_cases
    from chip_smoke import FAST_REST_KERNELS, fast_rest_cases
    from chip_smoke import FAST_XFIRST_KERNELS, fast_xfirst_cases
    from chip_smoke import fast_arm_cases, fast_check, fast_sw_cases
    from chip_smoke import fast_split_off_cases

    n, cols = shape
    cases = (fast_sw_cases if name in FAST_SW_KERNELS
             else fast_split_off_cases if name == "ky_all_nosplit_fast"
             else fast_arm_cases if name in FAST_ARM_KERNELS
             else fast_xfirst_cases if name in FAST_XFIRST_KERNELS
             else fast_rest_cases if name in FAST_REST_KERNELS
             else fast_cases)
    fast_check(name, cases(n, cols, cuda, n)[name], f"{shape}")


@pytest.mark.parametrize("shape", FAST_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1] or 'grid'}")
def test_fast_kx_fwd_bf16_store_is_its_float32_store_rounded(cuda, shape):
    """kx_fwd's bf16 product store on the fast tile gives the bits of
    its float32 store rounded once to bf16 (.to(torch.bfloat16)), ragged
    tiles included."""
    from chip_smoke import fast_sw_cases

    n, cols = shape
    cases = fast_sw_cases(n, cols, cuda, n)
    a = cases["kx_fwd_fast"].kern()
    b = cases["kx_fwd_fast_f32"].kern()
    assert all(torch.equal(x, y.to(torch.bfloat16)) for x, y in zip(a, b))


BF16_NAMES = ["kx_fwd_bf16", "sw_combine_bf16", "sw_combine_bf16_no_axpy",
              "sw_combine_bf16_split_no_src", "sw_combine_mv_bf16",
              "sw_combine_mv_bf16_no_tend", "sw_combine_mv_bf16_scale2"]


@pytest.mark.parametrize("n", [256, 4096])
@pytest.mark.parametrize("name", BF16_NAMES)
def test_bf16_forms_are_their_float32_forms(cuda, name, n):
    """The strict tile's bf16 product store is its float32 store rounded,
    and the combines on bf16 product spectra are their float32 forms on
    the upcast products, bit for bit, every form: chip_smoke.py's
    bf16_check on its bf16_cases."""
    from chip_smoke import bf16_cases, bf16_check

    bf16_check(name, bf16_cases(n, cuda, n)[name], f"{n}^2")


@pytest.mark.parametrize("scheme", ["rk4", "etdrk4"])
def test_fast_sw_launches_and_error_class(cuda, scheme):
    """Three steps of shallow-water fast mode at 256^2 (the balanced
    vortex, zero forcing) launch exactly the fast forms and the
    bf16-product combine per step (and ka_fast, kc_fast once for the
    forcing spectrum); the unfused RK form gives the fused one's bits (ETDRK4's
    unfused form, which reorders its stage sums, is within rel-L2 1e-5);
    zeta and eta stay within rel-L2 1e-7 .. 1e-2 of the strict kernel
    path (div has no bar)."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel)

    etd = scheme == "etdrk4"
    cfg = ModelConfig(nx=256, ny=256, time_scheme=scheme,
                      dt=7.5 if etd else 3.0)
    fast = ShallowWaterModel.build(cfg, cuda, fast=True)
    other = ShallowWaterModel.build(cfg, cuda, fast.tables, fast=True,
                                    **({"etd_fuse": False} if etd
                                       else {"fused_rk": False}))
    strict = ShallowWaterModel.build(cfg, cuda, fast.tables)
    s0 = fast.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5))
    src = fast.zero_source()
    ff.reset_launches()
    a = fast.segment(s0, src, 3)
    torch.cuda.synchronize()
    comb = ({"sw_combine_mv_bf16": 12} if etd
            else {"sw_combine_bf16": 12, "rk4_combine": 3})
    want = {"ka_sw_fast": 12, "kb_pair_fast": 24, "ky_all_fast": 12,
            "kx_fwd_fast": 12, "ka_fast": 1, "kc_fast": 1, **comb}
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), **want}
    def rel(x, y):
        fx, fy = (torch.fft.irfft2(z, s=(256, 256)) for z in (x, y))
        return float(torch.linalg.vector_norm(fx - fy)
                     / torch.linalg.vector_norm(fy))

    b = other.segment(s0, src, 3)
    if etd:
        assert rel(a.zeta_hat, b.zeta_hat) < 1e-5
    else:
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    ref = strict.segment(s0, src, 3)
    for x, y in ((a.zeta_hat, ref.zeta_hat), (a.eta_hat, ref.eta_hat)):
        assert 1e-7 < rel(x, y) < 1e-2


def test_fast_path_launches_and_error_class(cuda):
    """Three forced steps of fast mode at 256^2 launch exactly the four
    fast forms and rk4_combine per step, and stay within rel-L2 1e-7 ..
    1e-3 of the strict kernel path's vorticity."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel

    cfg = ModelConfig(nx=256, ny=256, beta=1e-11)
    fast = BarotropicModel.build(cfg, cuda, fast=True)
    strict = BarotropicModel.build(cfg, cuda)
    z = fast.init_state(makefields.gaussian(cfg))
    src = 1e-9 * torch.randn(cfg.grid_shape, device=cuda)
    ff.reset_launches()
    a = fast.segment(z, src, 3)
    torch.cuda.synchronize()
    want = {"ka_diag_fast": 12, "kb_pair_fast": 12, "kb_adv_half_fast": 12,
            "kx_visc_fast": 12, "rk4_combine": 3}
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), **want}
    va, vb = fast.diags(a).vort, strict.diags(strict.segment(z, src, 3)).vort
    rel = float(torch.linalg.vector_norm(va - vb)
                / torch.linalg.vector_norm(vb))
    assert 1e-7 < rel < 1e-3, rel


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_fast_pins_bit_for_bit(cuda, n):
    """Each fast form gives the bits of its fast constituents
    (chip_smoke.py fast_pins): kb_adv_tracer, kb_adv_half and kb_adv_full
    of kb_pair then ky_adv, ka6 of ka_diag per state, kx_visc_tail of
    kx_visc then rk4_combine, kx_fwd then visc of kx_visc, the stacked
    kx_visc of one call per field."""
    from chip_smoke import fast_pins

    for name, (got, want) in fast_pins(n, cuda, n + 3).items():
        torch.cuda.synchronize()
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), (name, i)


@pytest.mark.parametrize("scheme", ["rk4", "etdrk4"])
def test_fast_tracer_launches_and_error_class(cuda, scheme):
    """Three steps of the tracer's fast mode at 256^2 (bench.py's tracer
    configuration: gaussian flow and tracer, kappa 50) launch exactly 4
    ka6_fast, 8 kb_pair_fast, 4 kb_adv_tracer_fast and 4 kx_visc_fast per
    step, and 1 rk4_combine under RK4; zeta and q each stay within rel-L2
    1e-7 .. 1e-3 of the strict kernel path."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.tracer import TracerModel, tracer_ic

    cfg = ModelConfig(nx=256, ny=256, time_scheme=scheme)
    fast = TracerModel.build(cfg, cuda, kappa=50.0, fast=True)
    strict = TracerModel.build(cfg, cuda, 50.0, fast.tables)
    s0 = fast.init_state(makefields.gaussian(cfg),
                         tracer_ic(cfg, "gaussian"))
    src = fast.zero_source()
    ff.reset_launches()
    a = fast.segment(s0, src, 3)
    torch.cuda.synchronize()
    want = {"ka6_fast": 12, "kb_pair_fast": 24, "kb_adv_tracer_fast": 12,
            "kx_visc_fast": 12}
    if scheme == "rk4":
        want["rk4_combine"] = 3
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), **want}
    da, db = fast.diags(a), strict.diags(strict.segment(s0, src, 3))
    for f in ("vort", "q"):
        x, y = getattr(da, f), getattr(db, f)
        rel = float(torch.linalg.vector_norm(x - y)
                    / torch.linalg.vector_norm(y))
        assert 1e-7 < rel < 1e-3, (f, rel)


def _poisoned(rng, shape, dev):
    """A stack of x-stage planes (wr, clean wi, poisoned wi): the
    imaginary parts of the self-conjugate rows 0 and ny/2 zero in clean,
    junk in poisoned."""
    wr, wi = _planes(rng, shape, 2, dev)
    half = shape[-2] - 1
    clean = wi.clone()
    clean[..., 0, :] = 0.0
    clean[..., half, :] = 0.0
    poisoned = clean.clone()
    poisoned[..., 0, :] = 10.0 * wi[..., 0, :] + 1.0
    poisoned[..., half, :] = -7.0 * wi[..., half, :]
    return wr, clean, poisoned


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", ["kb_pair", "kb", "kb_stacked",
                                  "kb_adv_half", "kb_adv_full",
                                  "kb_adv_tracer", "kb_single"])
def test_fast_leak_guard(cuda, name, n):
    """The fast forms of the paired c2r y-stages project the junk in the
    imaginary parts of the self-conjugate rows 0 and ny/2 out, as the
    strict ones do: the poisoned stack gives the clean stack's bits;
    kb_single is kb's single form as the fast irfft2 runs it, on the
    x-stage planes of ka_fast's complex inverse of a half spectrum."""
    rng = np.random.default_rng(n + 71)
    fields = 6 if name == "kb_adv_tracer" else 4
    wr, clean, poisoned = _poisoned(rng, (fields, n // 2 + 1, n), cuda)
    zx, zy, qx, qy, src = _planes(rng, (n, n), 5, cuda)
    scale = 1.0 / (n * n)
    run = {
        "kb_pair": lambda w: ff.kb_pair(wr, w, 0, 1, scale, fast=True),
        "kb": lambda w: ff.kb(wr[2], w[2], wr[3], w[3], scale, fast=True),
        "kb_stacked": lambda w: ff.kb_stacked(wr, w, 2, 3, scale,
                                              fast=True),
        "kb_adv_half": lambda w: ff.kb_adv_half(zx, zy, wr, w, src, 0.3,
                                                fast=True),
        "kb_adv_full": lambda w: ff.kb_adv_full(wr, w, src, 0.3, fast=True),
        "kb_adv_tracer": lambda w: ft.kb_adv_tracer(zx, zy, qx, qy, wr, w,
                                                    src, 0.3, fast=True),
        "kb_single": lambda w: ff.kb(xr, w, None, None, scale,
                                     fast=True)[:1],
    }[name]
    if name == "kb_single":
        spec = torch.complex(*_planes(rng, (n, n // 2 + 1), 2, cuda))
        xr, xi = ff.ka(spec.real.contiguous(), spec.imag.contiguous(), False,
                       fast=True)
        clean, poisoned = xi.clone(), xi.clone()
        clean[0], clean[-1] = 0.0, 0.0
        poisoned[0], poisoned[-1] = 10.0 * xi[0] + 1.0, -7.0 * xi[-1]
        assert torch.equal(run(clean)[0], run(xi)[0])
    a, b = run(clean), run(poisoned)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the single inverse (no partner) too
    if name == "kb":
        a = ff.kb(wr[2], clean[2], None, None, scale, fast=True)[0]
        b = ff.kb(wr[2], poisoned[2], None, None, scale, fast=True)[0]
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["xfirst", "quad", "split", "etdrk4",
                                  "quad-etdrk4"])
def test_fast_xfirst_launches_and_error_class(cuda, form):
    """Three forced beta-plane steps of the barotropic x-first order in
    fast mode at 256^2 launch per stage the x-stage's fast form (ka_diag,
    or ka_quad once for quad and twice for split), 2 kb, 1 ka_adv and
    1 kc_visc, all fast, and nothing else (the stage updates are torch);
    the vorticity stays within rel-L2 1e-7 .. 1e-3 of the strict x-first
    kernel path of its quad_mode and within 1e-3 of the y-first fast
    path; split gives quad's bits."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel

    etd = form.endswith("etdrk4")
    quad_mode = form.split("-")[0] if form.startswith(("quad", "split")) \
        else "grid"
    cfg = ModelConfig(nx=256, ny=256, beta=0.0 if etd else 1e-11,
                      time_scheme="etdrk4" if etd else "rk4")
    kw = dict(yfirst=False, quad_mode=quad_mode)
    fast = BarotropicModel.build(cfg, cuda, fast=True, **kw)
    strict = BarotropicModel.build(cfg, cuda, fast.tables, **kw)
    yfast = BarotropicModel.build(cfg, cuda, fast.tables, fast=True)
    z = fast.init_state(makefields.gaussian(cfg))
    src = 1e-9 * torch.randn(cfg.grid_shape, device=cuda)
    ff.reset_launches()
    a = fast.segment(z, src, 3)
    torch.cuda.synchronize()
    xstage = {"grid": {"ka_diag_fast": 12}, "quad": {"ka_quad_fast": 12},
              "split": {"ka_quad_fast": 24}}[quad_mode]
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), **xstage,
                           "kb_fast": 24, "ka_adv_fast": 12,
                           "kc_visc_fast": 12}

    def rel(m):
        x, y = fast.diags(a).vort, m.diags(m.segment(z, src, 3)).vort
        return float(torch.linalg.vector_norm(x - y)
                     / torch.linalg.vector_norm(y))
    assert 1e-7 < rel(strict) < 1e-3
    assert rel(yfast) < 1e-3
    if quad_mode == "split":
        quad = BarotropicModel.build(cfg, cuda, fast.tables, fast=True,
                                     yfirst=False, quad_mode="quad")
        assert torch.equal(a, quad.segment(z, src, 3))


@pytest.mark.parametrize("scheme", ["rk4", "etdrk4"])
def test_fast_sw_xfirst_launches_and_error_class(cuda, scheme):
    """Three steps of shallow-water fast mode in the x-first order at
    256^2 launch per stage 1 ka_sw, 2 kb, 1 ka_fwd and 1 kc_sw, all fast,
    and the float32 combine of the scheme (the product store is float32,
    as in the JAX package), and ka_fast, kc_fast once for the forcing
    spectrum;
    zeta and eta stay within rel-L2 1e-7 .. 1e-2 of the strict x-first
    kernel path and within 1e-2 of the y-first fast path."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel)

    etd = scheme == "etdrk4"
    cfg = ModelConfig(nx=256, ny=256, time_scheme=scheme,
                      dt=7.5 if etd else 3.0)
    fast = ShallowWaterModel.build(cfg, cuda, fast=True, yfirst=False)
    strict = ShallowWaterModel.build(cfg, cuda, fast.tables, yfirst=False)
    yfast = ShallowWaterModel.build(cfg, cuda, fast.tables, fast=True)
    assert fast.split and fast.pstore == "f32" and yfast.pstore == "bf16"
    s0 = fast.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5))
    src = fast.zero_source()
    ff.reset_launches()
    a = fast.segment(s0, src, 3)
    torch.cuda.synchronize()
    comb = ({"sw_combine_mv": 12} if etd
            else {"sw_combine": 12, "rk4_combine": 3})
    want = {"ka_sw_fast": 12, "kb_fast": 24, "ka_fwd_fast": 12,
            "kc_sw_fast": 12, "ka_fast": 1, "kc_fast": 1, **comb}
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), **want}

    def rel(x, y):
        fx, fy = (torch.fft.irfft2(z, s=(256, 256)) for z in (x, y))
        return float(torch.linalg.vector_norm(fx - fy)
                     / torch.linalg.vector_norm(fy))
    ref = strict.segment(s0, src, 3)
    other = yfast.segment(s0, src, 3)
    for x, y, w in ((a.zeta_hat, ref.zeta_hat, other.zeta_hat),
                    (a.eta_hat, ref.eta_hat, other.eta_hat)):
        assert 1e-7 < rel(x, y) < 1e-2
        assert rel(x, w) < 1e-2


@pytest.mark.parametrize("arm", [dict(fusekb=""), dict(fusekb="full"),
                                 dict(fusekx=False), dict(fusetail=True),
                                 dict(fused_rk=False),
                                 dict(etd=True, fusekb=""),
                                 dict(etd=True, fusekb="half"),
                                 dict(etd=True, fusekb="full")], ids=str)
def test_fast_arm_is_the_half_arm_bit_for_bit(cuda, arm):
    """Three forced beta-plane steps of every barotropic fast arm at 256^2
    give the fast FUSEKB=half arm's bits (ETDRK4's arms: the fast half
    arm's under ETDRK4, the half arm itself against fusekb None), with
    exactly their fast forms' launches."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel

    kw = dict(arm)
    etd = kw.pop("etd", False)
    cfg = ModelConfig(nx=256, ny=256, beta=1e-11,
                      time_scheme="etdrk4" if etd else "rk4")
    ref = BarotropicModel.build(cfg, cuda, fast=True)
    m = BarotropicModel.build(cfg, cuda, ref.tables, fast=True, **kw)
    z = ref.init_state(makefields.gaussian(cfg))
    src = 1e-9 * torch.randn(cfg.grid_shape, device=cuda)
    ff.reset_launches()
    a = m.segment(z, src, 3)
    torch.cuda.synchronize()
    first = {"": {"kb_pair_fast": 8, "ky_adv_fast": 4},
             "full": {"kb_adv_full_fast": 4},
             "half": {"kb_pair_fast": 4, "kb_adv_half_fast": 4}}[
        kw.get("fusekb", "half")]
    second = ({"kx_fwd_fast_f32": 4, "visc": 4}
              if not kw.get("fusekx", True)
              else {"kx_visc_fast": 3, "kx_visc_tail_fast": 1}
              if kw.get("fusetail") else {"kx_visc_fast": 4})
    tail = ({} if etd or not kw.get("fused_rk", True) or kw.get("fusetail")
            else {"rk4_combine": 1})
    want = {k: 3 * v for k, v in {"ka_diag_fast": 4, **first, **second,
                                  **tail}.items()}
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), **want}
    assert torch.equal(a, ref.segment(z, src, 3))


# ----- the distributed path's kernels (TPU rows 21-23) -----

def _shards(rng, shape, dev):
    """Complex64 shards from numpy, on the card."""
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(x.astype(np.complex64)).to(dev)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [64, 256])
def test_a2a_transposes_equal_plain_bit_for_bit(cuda, p, n):
    from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr

    rng = np.random.default_rng(n + p)
    hny = n // 2 + 1
    w = -(-hny // p)
    rows = _shards(rng, (p, n // p, hny), cuda)
    cols = _shards(rng, (p, n, w), cuda)
    got_c, got_r = ftr.a2a_cols(rows), ftr.a2a_rows(cols, hny)
    torch.cuda.synchronize()
    assert torch.equal(got_c, ftr.a2a_cols_plain(rows))
    assert torch.equal(got_r, ftr.a2a_rows_plain(cols, hny))
    assert torch.equal(ftr.a2a_rows(got_c, hny), rows)


@pytest.mark.parametrize("p, nx, hny", [(4, 4096, 2049), (8, 256, 129),
                                        (8, 64, 17), (3, 48, 7),
                                        (32, 64, 33)])
def test_a2a_ragged_half_axes_equal_plain_bit_for_bit(cuda, p, nx, hny):
    """Half axes that P does not divide (the pad P w - hny of 3, 7, 7, 2
    and 31 columns; at (8, 64, 17) and (32, 64, 33) whole runs are pad),
    up to the cap of 32 shards."""
    from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr

    rng = np.random.default_rng(nx + hny + p)
    w = -(-hny // p)
    rows = _shards(rng, (p, nx // p, hny), cuda)
    cols = _shards(rng, (p, nx, w), cuda)
    got_c, got_r = ftr.a2a_cols(rows), ftr.a2a_rows(cols, hny)
    torch.cuda.synchronize()
    assert torch.equal(got_c, ftr.a2a_cols_plain(rows))
    assert torch.equal(got_r, ftr.a2a_rows_plain(cols, hny))
    assert torch.equal(ftr.a2a_rows(got_c, hny), rows)


@pytest.mark.parametrize("to_cols", [True, False])
def test_a2a_call_allocates_its_output_and_launches_once(cuda, to_cols):
    """A call makes one allocation on the card (the output) and queues one
    kernel: the shard pointers go to the kernel by value."""
    from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr

    p, n = 4, 256
    hny = n // 2 + 1
    rng = np.random.default_rng(11)
    x = (_shards(rng, (p, n // p, hny), cuda) if to_cols
         else _shards(rng, (p, n, -(-hny // p)), cuda))

    def call():
        return ftr.a2a_cols(x) if to_cols else ftr.a2a_rows(x, hny)

    call()                                  # the build, the first launch
    torch.cuda.synchronize()
    ff.reset_launches()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = call()
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats()["allocation.all.allocated"]
    assert after - before == 1
    name = "a2a_cols" if to_cols else "a2a_rows"
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), name: 1}
    assert torch.equal(call(), out)
    # the device's view: one kernel queued per call, seen by a
    # torch.profiler session alone in its own process (a second session
    # in one process has seen no device events)
    kernels = _device_kernels_of_one_call(to_cols)
    assert len(kernels) == 1 and "a2a_kernel" in kernels[0], kernels


_ONE_CALL = """
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr
to_cols = sys.argv[2] == "1"
p, n = 4, 256
hny = n // 2 + 1
rng = np.random.default_rng(11)
shape = (p, n // p, hny) if to_cols else (p, n, -(-hny // p))
x = torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(
    shape)).astype(np.complex64)).cuda()
def call():
    return ftr.a2a_cols(x) if to_cols else ftr.a2a_rows(x, hny)
call()
torch.cuda.synchronize()
with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    call()
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


def _device_kernels_of_one_call(to_cols: bool) -> list:
    """The device kernels torch.profiler sees for one a2a call, traced in
    a process of its own."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    done = subprocess.run([sys.executable, "-c", _ONE_CALL, root,
                           "1" if to_cols else "0"], capture_output=True,
                          text=True, timeout=600, check=True)
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_a2a_refuses_more_shards_than_its_cap(cuda):
    """P above csrc/shards.cuh kMaxShards (32) is refused by the wrapper
    with a clear error, and by the launcher itself (cudaErrorInvalidValue)
    when called past the wrapper."""
    import ctypes

    from xlab_fftbarotropic_torch.ops._build import lib
    from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr

    p = ftr.MAX_SHARDS + 1
    x = torch.zeros((p, 1, 40), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="1..32 shards"):
        ftr.a2a_cols(x)
    with pytest.raises(ValueError, match="1..32 shards"):
        ftr.a2a_rows(torch.zeros((p, p, 2), dtype=torch.complex64,
                                 device=cuda), 40)
    ff.reset_launches()
    ptrs = (ctypes.c_void_p * (2 * p))(*[x.data_ptr()] * (2 * p))
    assert lib().xfb_a2a(ptrs, p, 1, 40, 2, 1, -1, cuda.index,
                         ff._stream(x)) == 1   # cudaErrorInvalidValue
    assert ff.LAUNCHES["a2a_cols"] == ff.LAUNCHES["a2a_rows"] == 0


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("kind", ["xstage", "xstage_inverse", "gather",
                                  "scatter"])
def test_xstages_match_plain(cuda, p, n, kind):
    from xlab_fftbarotropic_torch.parallel import fused_overlap as fo

    rng = np.random.default_rng(3 * n + p)
    hny = n // 2 + 1
    w = -(-hny // p)
    rows = _shards(rng, (p, n // p, hny), cuda)
    cols = _shards(rng, (p, n, w), cuda)
    if kind == "scatter":
        got = fo.xstage_scatter(cols, hny, False, 1.0 / n)
        want = fo.xstage_scatter_plain(cols, hny, False, 1.0 / n)
    elif kind == "gather":
        got = fo.xstage_gather(rows)
        want = fo.xstage_gather_plain(rows)
    else:
        fwd = kind == "xstage"
        got = fo.xstage(rows, fwd, 1.0 if fwd else 0.5)
        want = fo.xstage_plain(rows, fwd, 1.0 if fwd else 0.5)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert _rel(got, want) < TOL
    if kind == "gather":
        assert not got.permute(1, 0, 2).reshape(n, p * w)[:, hny:].any()


def test_xstage_refuses_lengths_it_does_not_take(cuda):
    from xlab_fftbarotropic_torch.parallel import fused_overlap as fo

    x = torch.zeros((4, 24, 49), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="power-of-two"):
        fo.xstage(x, True)


@pytest.mark.parametrize("decomp", ["slab", "xpencil"])
@pytest.mark.parametrize("impl", ["xla", "pallas", "overlap"])
def test_sharded_segment_matches_the_library_path(cuda, decomp, impl):
    """A 256^2 sharded segment on four shards against the single-device
    torch.fft path (rel-L2 of vorticity <= 1e-5); exact launches per
    step; pallas equal to xla bit for bit."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.parallel import (ShardedBarotropicModel,
                                                   make_mesh)

    cfg = ModelConfig(nx=256, ny=256)
    v0 = makefields.gaussian(cfg)
    lib = BarotropicModel.build(cfg.replace(fft_backend="xla"), cuda)
    ref = lib.diags(lib.segment(lib.init_state(v0), lib.zero_source(), 4))

    def run(fft_impl):
        m = ShardedBarotropicModel.build(cfg, make_mesh(4, cuda), fft_impl,
                                         decomp)
        z = m.init_state(v0)
        ff.reset_launches()
        z = m.segment(z, m.zero_source(), 4)
        torch.cuda.synchronize()
        return m, z, dict(ff.LAUNCHES)

    m, z, launches = run(impl)
    want = {("slab", "pallas"): {"a2a_cols": 20, "a2a_rows": 20},
            ("slab", "overlap"): {"xstage": 20},
            ("xpencil", "pallas"): {"a2a_cols": 4, "a2a_rows": 16},
            ("xpencil", "overlap"): {"xstage_gather": 4,
                                     "xstage_scatter": 16},
            }.get((decomp, impl), {})
    assert launches == {k: 4 * want.get(k, 0) for k in ff.LAUNCHES}
    vort = m.unshard_physical(m.diags(z).vort)
    assert float((vort - ref.vort).norm() / ref.vort.norm()) <= TOL
    if impl == "pallas":
        assert torch.equal(z, run("xla")[1])


@pytest.mark.parametrize("family", ["barotropic", "sw", "tracer"])
def test_pencil_runs_no_kernel(cuda, family, monkeypatch):
    """The 2-D pencil (xla only) on a 2x2 group at 256^2, 4 steps: no
    kernel launches and no kernel's plain twin runs (each raises), and
    the vorticity lies within rel-L2 1e-5 of the single-device torch.fft
    path."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel)
    from xlab_fftbarotropic_torch.models.tracer import TracerModel, tracer_ic
    from xlab_fftbarotropic_torch.parallel import (ShardedBarotropicModel,
                                                   ShardedShallowWaterModel,
                                                   ShardedTracerModel)
    from xlab_fftbarotropic_torch.parallel import fused_overlap as fo
    from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr
    from xlab_fftbarotropic_torch.parallel.pencil import make_pencil_mesh

    cfg = ModelConfig(nx=256, ny=256, dt=0.5 if family == "sw" else 3.0)
    v0 = makefields.gaussian(cfg, zeta0=1e-5 if family == "sw" else 1e-4)
    lib_cfg = cfg.replace(fft_backend="xla")
    mesh = make_pencil_mesh((2, 2), cuda)
    if family == "barotropic":
        lib = BarotropicModel.build(lib_cfg, cuda)
        m = ShardedBarotropicModel.build(cfg, mesh, decomp="pencil")
        s0, z0 = lib.init_state(v0), m.init_state(v0)
    elif family == "sw":
        lib = ShallowWaterModel.build(lib_cfg, cuda)
        m = ShardedShallowWaterModel.build(cfg, mesh, decomp="pencil")
        s0, z0 = lib.geostrophic_init(v0), m.geostrophic_init(v0)
    else:
        q0 = tracer_ic(cfg, "gaussian")
        lib = TracerModel.build(lib_cfg, cuda, kappa=50.0)
        m = ShardedTracerModel.build(cfg, mesh, decomp="pencil", kappa=50.0)
        s0, z0 = lib.init_state(v0, q0), m.init_state(v0, q0)
    ref = lib.diags(lib.segment(s0, lib.zero_source(), 4)).vort

    def refuse(*args, **kwargs):
        raise AssertionError("a plain twin ran on the pencil path")

    for mod in (ff, fs, ft, fo, ftr):
        for name in dir(mod):
            if (name.endswith("_plain") and not name.startswith("_")
                    and callable(getattr(mod, name))):
                monkeypatch.setattr(mod, name, refuse)
    ff.reset_launches()
    z = m.segment(z0, m.zero_source(), 4)
    torch.cuda.synchronize()
    assert not any(ff.LAUNCHES.values()), ff.LAUNCHES
    vort = m.unshard_physical(m.diags(z).vort)
    assert float((vort - ref).norm() / ref.norm()) <= TOL


# ----- the column-tile x-stages (csrc/xtile.cuh: kx_visc.cu, xstage.cu) -----

XTILE_LENGTHS = [64, 128, 256, 512, 1024, 2048, 4096, 8192]
KX_FORMS = ["kx_fwd", "kx_fwd_stack", "visc", "coef", "tail", "tracer"]


def _randn(seed, shape, k, dev):
    """Seeded planes made on the card (the 8192 stacks are gigabytes)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev) for _ in range(k)]


def _kx_form(form, n, hny, dev, seed, transform_only=False):
    """(kernel call, plain call, (fr, fi)) of a kx_visc.cu form on (nx,
    hny) planes; transform_only: lap 0, mask 1 and a zero stage state, so that every
    form's output is the forward x-DFT itself, bit for bit."""
    nf = {"kx_fwd_stack": 5, "tracer": 2}.get(form, 1)
    shape = (nf, n, hny) if form in ("kx_fwd_stack", "tracer") else (n, hny)
    fr, fi, lap, zsr, zsi, *rest = _randn(seed, shape, 13, dev)
    mask = (_randn(seed + 1, (n, hny), 1, dev)[0] > -0.5).float()
    if transform_only:
        lap, mask = torch.zeros_like(lap), torch.ones_like(mask)
        rest = [torch.zeros_like(r) for r in rest]
    axpy = (rest[0], rest[1], 1.0 if transform_only else 0.37)
    tail = (*rest[:8], 1.0 if transform_only else 0.5)
    if form in ("kx_fwd", "kx_fwd_stack"):
        a, b = (fr, fi) if form == "kx_fwd_stack" else (fr[None], fi[None])
        return (lambda: fs.kx_fwd(a, b)), (lambda: fs.kx_fwd_plain(a, b)), \
            (fr, fi)
    if form == "tail":
        return (lambda: ff.kx_visc_tail(fr, fi, lap, mask, zsr, zsi, 6.5,
                                        tail),
                lambda: ff.kx_visc_tail_plain(fr, fi, lap, mask, zsr, zsi,
                                              6.5, tail), (fr, fi))
    ax = None if form == "visc" else axpy
    return (lambda: ff.kx_visc(fr, fi, lap, mask, zsr, zsi, 6.5, ax),
            lambda: ff.kx_visc_plain(fr, fi, lap, mask, zsr, zsi, 6.5, ax),
            (fr, fi))


def _assert_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("form", KX_FORMS)
@pytest.mark.parametrize("n", XTILE_LENGTHS)
def test_kx_visc_forms_at_every_length(cuda, n, form):
    """Every form of kx_visc.cu (no epilogue on one and five fields, visc,
    the stage axpy, the RK4 tail, the tracer's two fields) against its
    plain version at every length the column-tile plan takes."""
    kern, plain, _ = _kx_form(form, n, n // 2 + 1, cuda, n)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    _assert_close(got, want)


@pytest.mark.parametrize("form", ["kx_fwd_stack", "coef", "tail"])
@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_kx_visc_ragged_last_tile(cuda, n, form):
    """A last tile of one column: hny = n/2 + 1, and one column past a
    whole number of tiles on a narrower plane."""
    from xlab_fftbarotropic_torch.ops.xtile import xtile_plan

    c = xtile_plan(n, 1, 4).c
    for hny in (n // 2 + 1, 3 * c + 1):
        assert hny % c == 1
        kern, plain, _ = _kx_form(form, n, hny, cuda, n + hny)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        _assert_close(got, want)


@pytest.mark.parametrize("mode", ["xstage", "gather", "scatter"])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1024, 4096])
def test_xstage_tiles_straddling_shards(cuda, n, p, mode):
    """The three xstage modes at P = 1, 2, 4, 8 where the x-pencil width
    w is no multiple of the tile (w = 513 at 4096, P = 4): a tile's
    columns then live in two shards, each reached through the pointer
    tables."""
    from xlab_fftbarotropic_torch.ops.xtile import xtile_plan
    from xlab_fftbarotropic_torch.parallel import fused_overlap as fo

    hny = n // 2 + 1
    w = -(-hny // p)
    assert p == 1 or w % xtile_plan(n, p * w, 8).c
    rng = np.random.default_rng(n + 7 * p)
    rows = _shards(rng, (p, n // p, hny), cuda)
    cols = _shards(rng, (p, n, w), cuda)
    if mode == "scatter":
        got = fo.xstage_scatter(cols, hny, False, 1.0 / n)
        want = fo.xstage_scatter_plain(cols, hny, False, 1.0 / n)
    elif mode == "gather":
        got = fo.xstage_gather(rows)
        want = fo.xstage_gather_plain(rows)
    else:
        got = fo.xstage(rows, True)
        want = fo.xstage_plain(rows, True)
    torch.cuda.synchronize()
    _assert_close([got], [want])
    if mode == "gather":            # the pad columns written as zeros
        assert not got.permute(1, 0, 2).reshape(n, p * w)[:, hny:].any()


@pytest.mark.parametrize("form", KX_FORMS + ["xstage", "xstage_inverse",
                                             "gather", "scatter"])
def test_xtile_kernels_against_torch_fft_at_4096(cuda, form):
    """Each redesigned form against torch.fft.fft (cuFFT) itself at 4096:
    kx_visc's epilogues with lap 0, mask 1 and a zero stage state hand the
    transform through unchanged; the x-stages of the shards against the
    DFT of the gathered half spectrum."""
    n, hny = 4096, 2049
    if form in KX_FORMS:
        kern, _, (fr, fi) = _kx_form(form, n, hny, cuda, 11,
                                     transform_only=True)
        want = torch.fft.fft(torch.complex(fr, fi), dim=-2)
        got = kern()
        torch.cuda.synchronize()
        g = torch.complex(got[-2 if form in ("coef", "tail") else 0],
                          got[-1 if form in ("coef", "tail") else 1])
        assert _rel(g.reshape(want.shape), want) < TOL
        return
    from xlab_fftbarotropic_torch.parallel import fused_overlap as fo
    from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr

    p = 4
    rng = np.random.default_rng(12)
    rows = _shards(rng, (p, n // p, hny), cuda)
    gathered = rows.reshape(n, hny)
    if form == "scatter":
        cols = ftr.a2a_cols_plain(rows)
        got = fo.xstage_scatter(cols, hny, True).reshape(n, hny)
        want = torch.fft.fft(gathered, dim=0)
    elif form == "gather":
        got = fo.xstage_gather(rows).permute(1, 0, 2).reshape(n, -1)[:, :hny]
        want = torch.fft.fft(gathered, dim=0)
    else:
        fwd = form == "xstage"
        got = fo.xstage(rows, fwd).reshape(n, hny)
        want = (torch.fft.fft(gathered, dim=0) if fwd
                else torch.fft.ifft(gathered, dim=0, norm="forward"))
    torch.cuda.synchronize()
    assert _rel(got, want) < TOL


# ----- the column-tile y-stages (csrc/xtile.cuh's transposed store:
# kc_kernel for kc, kc_sw, kc_visc; kb_kernel for kb and the x-major kb) -----

KCKB_FORMS = ["kc", "kc_sw", "kc_visc", "kb", "kb_single", "kb_xmajor"]


def _kckb_form(form, ny, nx, dev, seed, transform_only=False):
    """(kernel call, plain call, torch.fft call) of a y-stage form on a
    (ny, nx) grid, each a list of planes: kc forms (nx, ny/2 + 1) (five
    fields for kc_sw), kb forms x-major (nx, ny) (a alone for the single
    inverse). transform_only: kc_visc with lap 0, mask 1 and a zero
    stage state, which hands the transform through unchanged."""
    hny = ny // 2 + 1
    if form.startswith("kc"):
        shape = (5, ny, nx) if form == "kc_sw" else (ny, nx)
        xr, xi = _randn(seed, shape, 2, dev)

        def lib():
            y = torch.fft.fft(torch.complex(xr, xi), dim=-2)[..., :hny, :]
            y = y.transpose(-1, -2)
            return [y.real, y.imag]
        if form == "kc":
            return ((lambda: ff.kc(xr, xi)), (lambda: ff.kc_plain(xr, xi)),
                    lib)
        if form == "kc_sw":
            return ((lambda: fs.kc_sw(xr, xi)),
                    (lambda: fs.kc_sw_plain(xr, xi)), lib)
        lap, zr, zi = _randn(seed + 1, (nx, hny), 3, dev)
        mask = (_randn(seed + 2, (nx, hny), 1, dev)[0] > -0.5).float()
        if transform_only:
            lap, zr, zi = (torch.zeros_like(t) for t in (lap, zr, zi))
            mask = torch.ones_like(mask)
        args = (xr, xi, lap, mask, zr, zi, 6.5)
        return ((lambda: ff.kc_visc(*args)),
                (lambda: ff.kc_visc_plain(*args)), lib)
    scale = 1.0 / (nx * ny)
    k = 1 if form == "kb_single" else 2
    if form == "kb_xmajor":
        wr, wi = _randn(seed, (4, hny, nx), 2, dev)
        w = [wr[2], wi[2], wr[3], wi[3]]

        def kern():
            return ff.kb_stacked(wr, wi, 2, 3, scale)
    else:
        w = _randn(seed, (hny, nx), 4, dev)
        if form == "kb_single":
            w[2:] = [None, None]

        def kern():
            return ff.kb(*w, scale)[:k]

    def lib():
        out = []
        for re_, im in ((w[0], w[1]), (w[2], w[3]))[:k]:
            im = im.clone()
            im[0] = 0.0
            im[ny // 2] = 0.0
            spec = torch.complex(re_, im)
            out.append(torch.fft.irfft(spec, n=ny, dim=0, norm="forward")
                       .t() * scale)
        return out
    return kern, (lambda: ff.kb_plain(*w, scale)[:k]), lib


@pytest.mark.parametrize("form", KCKB_FORMS)
@pytest.mark.parametrize("n", XTILE_LENGTHS)
def test_kc_kb_forms_at_every_length(cuda, n, form):
    """Every form of kc_kernel (kc, the five stacked fields of kc_sw,
    kc_visc's epilogue) and of kb_kernel (paired, the single inverse, the
    x-major kb on a stack) against its plain version at every length the
    column-tile plan takes."""
    kern, plain, _ = _kckb_form(form, n, n, cuda, n)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    _assert_close(got, want)


@pytest.mark.parametrize("form", KCKB_FORMS)
@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_kc_kb_ragged_last_tile(cuda, n, form):
    """nx no multiple of the tile: one column past three whole tiles, and
    a single tile with one dead column."""
    from xlab_fftbarotropic_torch.ops.xtile import xtile_plan

    c = xtile_plan(n, 1, 4).c
    for nx in (3 * c + 1, c - 1):
        kern, plain, _ = _kckb_form(form, n, nx, cuda, n + nx)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert got[0].shape[-2] == nx          # (F,) nx, hny or nx, ny
        _assert_close(got, want)


@pytest.mark.parametrize("form", KCKB_FORMS)
def test_kc_kb_against_torch_fft_at_4096(cuda, form):
    """Each redesigned y-stage form against torch.fft (cuFFT) itself at
    4096: kc's against torch.fft.fft along y, rows k <= ny/2, transposed;
    kb's against torch.fft.irfft of the half spectrum with the
    self-conjugate rows' imaginary parts dropped, transposed."""
    kern, _, lib = _kckb_form(form, 4096, 4096, cuda, 13,
                              transform_only=True)
    got, want = kern(), lib()
    torch.cuda.synchronize()
    _assert_close(got, want)


def test_kc_kb_refuse_a_plan_they_do_not_take(cuda):
    """The tile kernels check the plan they are handed: one that is not
    ops/xtile.py's for the length fails the launch (no other path)."""
    from xlab_fftbarotropic_torch.ops._build import lib

    n = 256
    x = torch.zeros((n, n), device=cuda)
    y = torch.empty((n, n // 2 + 1), device=cuda)
    tw = ff._twiddles(n, cuda)
    c, k, threads, smem = ff._xtile_args(n, n, 4)
    stream = ff._stream(x)
    for plan in ((c, k, threads + 32, smem), (c, k, threads, smem - 8),
                 (c, 3, threads, smem)):
        assert lib().xfb_kc(*ff._ptrs(x, x, tw, y, y), n, n, *plan,
                            cuda.index, stream) != 0
        assert lib().xfb_kb(*ff._ptrs(y, y), None, None,
                            *ff._ptrs(tw, x), None, n, n, 1.0, *plan,
                            cuda.index, stream) != 0


# ----- the y-first pair on the column tile: kb_pair_kernel (the natural
# store), ky_adv_kernel and kb_adv_kernel (the transposed half store) -----

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("stack", [(4, 2, 3), (6, 4, 5)],
                         ids=["ka_diag", "ka6"])
def test_kb_pair_is_kb_stacked_transposed_bit_for_bit(cuda, n, stack):
    """kb_pair (the y-major store) and kb_stacked (the x-major store of
    the same load and transform) give the same values bit for bit."""
    f, fa, fb = stack
    rng = np.random.default_rng(n + f)
    wr, wi = _planes(rng, (f, n // 2 + 1, n), 2, cuda)
    scale = 1.0 / (n * n)
    got = ff.kb_pair(wr, wi, fa, fb, scale)
    want = ff.kb_stacked(wr, wi, fa, fb, scale)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w.t())


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("beta", [0.0, 1.6])
def test_ky_adv_is_kc_of_the_advection_bit_for_bit(cuda, n, beta):
    """ky_adv equals kc of (adv, 0) bit for bit, adv formed by torch on
    the card in xfb::advection's order (each op rounded apart): the same
    transform behind another load."""
    rng = np.random.default_rng(n + 11)
    u, zx, v, zy, src = _planes(rng, (n, n), 5, cuda)
    adv = -(u * zx) - v * (zy + beta if beta != 0.0 else zy) + src
    got = ff.ky_adv(u, zx, v, zy, src, beta)
    want = ff.kc(adv, torch.zeros_like(adv))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(256, 200), (64, 15), (4096, 49),
                                   (1024, 33)])
def test_y_first_pair_ragged_last_tile(cuda, shape):
    """(ny, nx) with nx no multiple of the tile's C: kb_pair, ky_adv,
    kb_adv_full and kb_adv_half against their plain versions, and the
    fused forms bit for bit against kb_pair + ky_adv."""
    ny, nx = shape
    rng = np.random.default_rng(ny + nx)
    wr, wi, _, _, src = _kb_adv_inputs(rng, ny, nx, cuda)
    u, zx, v, zy = _planes(rng, (ny, nx), 4, cuda)
    scale = 1.0 / (nx * ny)
    pairs = [(ff.kb_pair(wr, wi, fa, fb, scale),
              ff.kb_pair_plain(wr, wi, fa, fb, scale))
             for fa, fb in ((0, 1), (2, 3))]
    adv = (ff.ky_adv(u, zx, v, zy, src, 1.6),
           ff.ky_adv_plain(u, zx, v, zy, src, 1.6))
    full = (ff.kb_adv_full(wr, wi, src, 1.6),
            ff.kb_adv_full_plain(wr, wi, src, 1.6))
    (kzx, kzy), (ku, kv) = pairs[0][0], pairs[1][0]
    half = (ff.kb_adv_half(kzx, kzy, wr, wi, src, 1.6),
            ff.kb_adv_half_plain(kzx, kzy, wr, wi, src, 1.6))
    unfused = ff.ky_adv(ku, kzx, kv, kzy, src, 1.6)
    torch.cuda.synchronize()
    for got, want in pairs + [adv, full, half]:
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _rel(g, w) < TOL
    for g, w in zip(full[0] + half[0], unfused + unfused):
        assert torch.equal(g, w)


def test_y_first_pair_refuses_a_plan_it_does_not_take(cuda):
    """kb_pair, ky_adv and kb_adv check the plan they are handed: one that
    is not ops/xtile.py's for the length fails the launch."""
    from xlab_fftbarotropic_torch.ops._build import lib

    n = 256
    x = torch.zeros((n, n), device=cuda)
    w = torch.zeros((4, n // 2 + 1, n), device=cuda)
    y = torch.empty((n, n // 2 + 1), device=cuda)
    tw = ff._twiddles(n, cuda)
    c, k, threads, smem = ff._xtile_args(n, n, 4)
    stream = ff._stream(x)
    for plan in ((c, k, threads + 32, smem), (c, k, threads, smem - 8),
                 (c, 3, threads, smem)):
        assert lib().xfb_kb_pair(*ff._ptrs(w, w), 0, 1,
                                 *ff._ptrs(tw, x, x), n, n, 1.0, *plan,
                                 cuda.index, stream) != 0
        assert lib().xfb_ky_adv(*ff._ptrs(x, x, x, x, x, tw, y, y), n, n,
                                0.0, *plan, cuda.index, stream) != 0
        assert lib().xfb_kb_adv_full(*ff._ptrs(w, w, x, tw, y, y), n, n,
                                     1.0, 0.0, *plan, cuda.index,
                                     stream) != 0
        assert lib().xfb_kb_adv_half(*ff._ptrs(x, x, w, w, x, tw, y, y), n,
                                     n, 1.0, 0.0, *plan, cuda.index,
                                     stream) != 0


# ----- the ka x-stages on the column tile: ka_kernel (ka, every mode)
# and ka_fields_kernel (ka_diag, ka6, ka_quad), the full transposed store -----

KA_FORMS = ["ka", "ka_real_inverse", "ka_complex_forward",
            "ka_complex_inverse", "ka_diag", "ka6", "ka_quad",
            "ka_quad_split"]
# ka's modes (forward, real input) at scale 0.37
_KA_MODES = {"ka": (True, True), "ka_real_inverse": (False, True),
             "ka_complex_forward": (True, False),
             "ka_complex_inverse": (False, False)}
# the field forms: states, (first, count) of each call, and each output
# field's (state, diagonal kind)
_FIELD_FORMS = {"ka_diag": (1, [(0, 4)]), "ka6": (2, [(0, 6)]),
                "ka_quad": (1, [(0, 4)]),
                "ka_quad_split": (1, [(0, 2), (2, 2)])}


def _per_field(out):
    """(re, im) stacks (F, m, n) or planes (m, n) -> [re_0, im_0, ...]."""
    re_, im = out
    if re_.dim() == 2:
        return [re_, im]
    return [p[f] for f in range(re_.shape[0]) for p in (re_, im)]


def _ka_form(form, n, m, dev, seed):
    """(kernel call, plain call, torch.fft call) of a ka x-stage form on
    (n, m) planes, each a list of (m, n) planes, re and im of each field:
    ka at scale 0.37; the field forms on states (F, n, m) with the kx, ky
    and rlap tables of an n x 2(m - 1) grid (m = its hny). The torch.fft
    call runs the transform along the last axis of the transposed input
    (ifft times n for the inverse)."""
    if form in _KA_MODES:
        forward, real = _KA_MODES[form]
        xr, xi = _randn(seed, (n, m), 2, dev)
        xi = None if real else xi

        def lib():
            x = (xr if xi is None else torch.complex(xr, xi)).t()
            y = (torch.fft.fft(x, dim=1) * 0.37 if forward
                 else torch.fft.ifft(x, dim=1) * (n * 0.37))
            return [y.real, y.imag]
        return (lambda: _per_field(ff.ka(xr, xi, forward, 0.37)),
                lambda: _per_field(ff.ka_plain(xr, xi, forward, 0.37)), lib)
    states, calls = _FIELD_FORMS[form]
    t = _tables(n, dev, 2 * (m - 1))
    sr, si = _randn(seed, (states, n, m), 2, dev)
    if states == 2:
        sr[1] *= 1e4                      # the tracer dwarfs the vorticity
        si[1] *= 1e4
    tab = (t.rlap, t.kx, t.ky)
    if form == "ka6":
        kern = [lambda: ft.tracer_xstage_planes(sr, si, t.kx, t.ky, t.rlap)]
        plain = [lambda: ft.ka6_plain(sr, si, *tab)]
        kinds = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1)]
        psi_first = False
    elif form == "ka_diag":
        kern = [lambda: ff.ka_diag(sr[0], si[0], *tab)]
        plain = [lambda: ff.ka_diag_plain(sr[0], si[0], *tab)]
        kinds, psi_first = [(0, k) for k in range(4)], False
    else:
        kern = [lambda a=a, b=b: ff.ka_quad(sr[0], si[0], *tab, a, b)
                for a, b in calls]
        plain = [lambda a=a, b=b: ff.ka_quad_plain(sr[0], si[0], *tab, a, b)
                 for a, b in calls]
        kinds, psi_first = [(0, k) for k in range(4)], True

    def lib():
        out = []
        for s, k in kinds:
            re_, im = ff.diagonal_fields(sr[s], si[s], *tab, [k], psi_first)
            y = torch.fft.ifft(torch.complex(re_[0], im[0]).t(), dim=1) * n
            out += [y.real, y.imag]
        return out
    return (lambda: [p for c in kern for p in _per_field(c())],
            lambda: [p for c in plain for p in _per_field(c())], lib)


def _assert_fields_close(got, want):
    """Each output plane on its own (the psi fields dwarf the others)."""
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("form", KA_FORMS)
@pytest.mark.parametrize("n", XTILE_LENGTHS)
def test_ka_forms_at_every_length(cuda, n, form):
    """Every form of ka_kernel (real forward on ny = n columns, the other
    modes on hny) and of ka_fields_kernel (ka_diag, ka6, ka_quad, split
    on hny) against its plain version at every length the column-tile
    plan takes."""
    m = n if form == "ka" else n // 2 + 1
    kern, plain, _ = _ka_form(form, n, m, cuda, n)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    assert len(got) == len(want)
    _assert_fields_close(got, want)


@pytest.mark.parametrize("form", KA_FORMS)
@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_ka_ragged_last_tile(cuda, n, form):
    """m no multiple of the tile: one column past three whole tiles (as
    hny), and a single tile with one dead column; no store lands past the
    m rows of a field (the next field's plane stays the plain one's)."""
    from xlab_fftbarotropic_torch.ops.xtile import xtile_plan

    c = xtile_plan(n, 1, 4).c
    for m in (3 * c + 1, c - 1):
        kern, plain, _ = _ka_form(form, n, m, cuda, n + m)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert got[0].shape == (m, n)
        _assert_fields_close(got, want)


@pytest.mark.parametrize("form", KA_FORMS)
def test_ka_forms_against_torch_fft_at_4096(cuda, form):
    """Each redesigned ka form against torch.fft (cuFFT) itself at 4096:
    ka's modes against torch.fft.fft / ifft along the rows of the
    transposed planes, the field forms against torch.fft.ifft of each
    field formed in torch."""
    n = 4096
    kern, _, lib = _ka_form(form, n, n if form == "ka" else n // 2 + 1,
                            cuda, 17)
    got, want = kern(), lib()
    torch.cuda.synchronize()
    _assert_fields_close(got, want)


def test_ka_forms_refuse_a_plan_they_do_not_take(cuda):
    """ka, ka_diag, ka6 and ka_quad check the plan they are handed: one
    that is not ops/xtile.py's for the length fails the launch."""
    from xlab_fftbarotropic_torch.ops._build import lib

    n = 256
    hny = n // 2 + 1
    x = torch.zeros((2, n, hny), device=cuda)
    y = torch.empty((6, hny, n), device=cuda)
    tw = ff._twiddles(n, cuda)
    c, k, threads, smem = ff._xtile_args(n, hny, 4)
    stream = ff._stream(x)
    for plan in ((c, k, threads + 32, smem), (c, k, threads, smem - 8),
                 (c, 3, threads, smem)):
        assert lib().xfb_ka(*ff._ptrs(x, x, tw, y, y), n, hny, 1, 1.0,
                            *plan, cuda.index, stream) != 0
        assert lib().xfb_ka_diag(*ff._ptrs(x, x, x, x, x, tw, y, y), n, hny,
                                 *plan, cuda.index, stream) != 0
        assert lib().xfb_ka6(*ff._ptrs(x, x, x, x, x, tw, y, y), n, hny,
                             *plan, cuda.index, stream) != 0
        assert lib().xfb_ka_quad(*ff._ptrs(x, x, x, x, x, tw, y, y), n, hny,
                                 0, 4, *plan, cuda.index, stream) != 0


@pytest.mark.parametrize("n", SIZES)
def test_ka_pins_bit_for_bit(cuda, n):
    """The ka kernels (ka_kernel, ka_fields_kernel, ka_adv_kernel) run
    one plan and one rounded arithmetic, so the pins between their forms
    hold bit for bit, ka_adv = ka of the advection formed in torch among
    them: chip_smoke.py's ka_pins, the one list of them."""
    from chip_smoke import ka_pins

    pins = ka_pins(n, cuda, np.random.default_rng(n + 19))
    for name, (got, want) in pins.items():
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name


# ----- the shallow-water x-stages on the column tile: ka_sw_kernel
# (csrc/ka_sw.cu) and ka_fwd_kernel (csrc/ka_kc.cu), the full transposed
# store -----

SW_XSTAGES = ["ka_sw", "ka_fwd", "ka_fwd_split"]


def _sw_xstage(form, n, m, dev, seed):
    """(kernel call, plain call) of a SW x-stage on n-long columns, m of
    them, at the bench's magnitudes: ka_sw on the state (n, m) with the
    tables of an n x 2(m - 1) grid, ka_fwd (split off or on) on x-major
    (n, m) fields; each a list of (m, n) planes, re and im of each field
    or product."""
    rng = np.random.default_rng(seed)
    if form == "ka_sw":
        t = _tables(n, dev, 2 * (m - 1))
        amps = (1e-4, 1e-4, 1e-6, 1e-6, 5.0, 5.0)
        state = [a * p for a, p in zip(amps, _planes(rng, (n, m), 6, dev))]
        args = (*state, t.rlap, t.kx, t.ky, float(fs.eta_pair_scale(state)))
        return (lambda: _per_field(fs.ka_sw(*args)),
                lambda: _per_field(fs.ka_sw_plain(*args)))
    u, v, zeta, eta_s = (a * p for a, p in zip(
        (3.0, 3.0, 1e-4, 1e-4), _planes(rng, (n, m), 4, dev)))
    args = (u, v, zeta, eta_s, 2.0 ** 15, 1e-4, 9.81, form == "ka_fwd_split")
    return (lambda: _per_field(fs.ka_fwd(*args)),
            lambda: _per_field(fs.ka_fwd_plain(*args)))


@pytest.mark.parametrize("form", SW_XSTAGES)
@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_sw_xstages_ragged_last_tile(cuda, n, form):
    """m no multiple of the tile: one column past three whole tiles (as
    ka_sw's hny, whose last tile always holds one column), and a single
    tile with one dead column; no store lands past the m rows of a field
    or product (the next one's plane stays the plain one's)."""
    from xlab_fftbarotropic_torch.ops.xtile import xtile_plan

    c = xtile_plan(n, 1, 4).c
    for m in (3 * c + 1, c - 1):
        kern, plain = _sw_xstage(form, n, m, cuda, n + m)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert got[0].shape == (m, n)
        _assert_fields_close(got, want)


def test_sw_xstages_refuse_a_plan_they_do_not_take(cuda):
    """ka_sw and ka_fwd check the plan they are handed: one that is not
    ops/xtile.py's for the length fails the launch."""
    from xlab_fftbarotropic_torch.ops._build import lib

    n = 256
    hny = n // 2 + 1
    x = torch.zeros((n, n), device=cuda)
    y = torch.empty((5, n, n), device=cuda)
    tw = ff._twiddles(n, cuda)
    c, k, threads, smem = ff._xtile_args(n, n, 4)
    stream = ff._stream(x)
    for plan in ((c, k, threads + 32, smem), (c, k, threads, smem - 8),
                 (c, 3, threads, smem)):
        assert lib().xfb_ka_sw(*ff._ptrs(*[x] * 9, tw, y, y), n, hny, 1.0,
                               *plan, cuda.index, stream) != 0
        assert lib().xfb_ka_fwd(*ff._ptrs(x, x, x, x, tw, y, y), n, n, 1.0,
                                1e-4, 9.81, 0, *plan, cuda.index,
                                stream) != 0


@pytest.mark.parametrize("n", SIZES)
def test_sw_pins_bit_for_bit(cuda, n):
    """ka_sw and ka_fwd run ka's plan and transform behind their loads,
    ky_all kc's, so ka (kc for ky_all) of the fields and products formed
    in torch gives their bits: chip_smoke.py's sw_pins, the one list of
    them."""
    from chip_smoke import sw_pins

    pins = sw_pins(n, cuda, np.random.default_rng(n + 23))
    for name, (got, want) in pins.items():
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name


# ----- the last one-column forward stages on the column tile:
# ky_all_kernel (csrc/ky_all.cu, the transposed half store) and
# ka_adv_kernel (csrc/ka_kc.cu, the full transposed store) -----

def _ky_all_ka_adv(shape, dev, seed):
    """(kernel, plain) call pairs of ky_all (split off and on) on y-major
    (ny, nx) fields at the bench's magnitudes and ka_adv (beta 0 and 1.6)
    on x-major (nx, ny) fields, shape = (transform length, columns); each
    call a list of re and im planes per product."""
    n, m = shape
    rng = np.random.default_rng(seed)
    u, v, zeta, eta_s = (a * p for a, p in zip(
        (3.0, 3.0, 1e-4, 1e-4), _planes(rng, (n, m), 4, dev)))
    adv = _planes(rng, (n, m), 5, dev)
    calls = []
    for split in (False, True):
        args = (u, v, zeta, eta_s, 2.0 ** 15, 1e-4, 9.81, split)
        calls.append((lambda a=args: _per_field(fs.ky_all(*a)),
                      lambda a=args: _per_field(fs.ky_all_plain(*a))))
    for beta in (0.0, 1.6):
        calls.append((lambda b=beta: _per_field(ff.ka_adv(*adv, b)),
                      lambda b=beta: _per_field(ff.ka_adv_plain(*adv, b))))
    return calls


@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_ky_all_and_ka_adv_ragged_last_tile(cuda, n):
    """Columns no multiple of the tile: one past three whole tiles and a
    single tile with one dead column, at a transform length n other than
    the column count (ky_all plans on ny and tiles nx, ka_adv plans on nx
    and tiles ny); no store lands past the last column of a product's
    plane (the next product's plane stays the plain one's)."""
    from xlab_fftbarotropic_torch.ops.xtile import xtile_plan

    c = xtile_plan(n, 1, 4).c
    for m in (3 * c + 1, c - 1):
        for kern, plain in _ky_all_ka_adv((n, m), cuda, n + m):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            assert got[0].shape[0] == m
            _assert_fields_close(got, want)


def test_ky_all_and_ka_adv_refuse_a_plan_they_do_not_take(cuda):
    """ky_all and ka_adv check the plan they are handed: one that is not
    ops/xtile.py's for the length fails the launch."""
    from xlab_fftbarotropic_torch.ops._build import lib

    n = 256
    x = torch.zeros((n, n), device=cuda)
    y = torch.empty((5, n, n), device=cuda)
    tw = ff._twiddles(n, cuda)
    c, k, threads, smem = ff._xtile_args(n, n, 4)
    stream = ff._stream(x)
    for plan in ((c, k, threads + 32, smem), (c, k, threads, smem - 8),
                 (c, 3, threads, smem)):
        assert lib().xfb_ky_all(*ff._ptrs(x, x, x, x, tw, y, y), n, n, 1.0,
                                1e-4, 9.81, 0, *plan, cuda.index,
                                stream) != 0
        assert lib().xfb_ka_adv(*ff._ptrs(x, x, x, x, x, tw, y, y), n, n,
                                0.0, *plan, cuda.index, stream) != 0


# ---------------------------------------- the diagnostics, ensemble, FD


@pytest.mark.parametrize("n", [64, 256])
def test_diagnose_launches_and_matches_the_library_path(cuda, n):
    """One field through the Diagnoser, all five diagnostics: exactly
    launches_per_field on the kernels, none on torch.fft; OW within TOL
    of max |OW| and E(k), Z(k) within TOL of their largest shells."""
    from xlab_fftbarotropic_torch.cli import diagnose
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields

    cfg = ModelConfig(nx=n, ny=n)
    vort = makefields.gaussian(cfg)
    out = {}
    for backend in ("pallas", "xla"):
        ff.reset_launches()
        out[backend] = diagnose.Diagnoser(cfg.replace(fft_backend=backend),
                                          cuda)(vort, diagnose.DIAGNOSTICS)
        torch.cuda.synchronize()
        want = (diagnose.launches_per_field(diagnose.DIAGNOSTICS)
                if backend == "pallas" else {})
        assert {k: v for k, v in ff.LAUNCHES.items() if v} == {
            k: v for k, v in want.items() if v}
    got, lib = out["pallas"], out["xla"]
    assert _rel(got["okubo-weiss"], lib["okubo-weiss"]) < TOL
    for a, b in zip(got["spectrum"][1:], lib["spectrum"][1:]):
        assert _rel(a, b) < TOL


def test_ensemble_width_one_members_are_solo_bit_for_bit(cuda):
    """Width-1 chunks on the plane stepper's kernels: each zero-amplitude
    member's state is the solo model's bit for bit, at 4 times its
    launches."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.models.ensemble import EnsembleModel

    cfg = ModelConfig(nx=256, ny=256)
    v0 = makefields.gaussian(cfg)
    solo = BarotropicModel.build(cfg, cuda)
    ff.reset_launches()
    want = solo.segment(solo.init_state(v0), solo.zero_source(), 4)
    per_solo = dict(ff.LAUNCHES)
    e = EnsembleModel.build(cfg, cuda, 4, vmap_width=1)
    s0 = e.init_from_physical(v0, amplitude=0.0)
    ff.reset_launches()
    got = e.segment(s0, solo.zero_source(), 4)
    torch.cuda.synchronize()
    assert ff.LAUNCHES == {k: 4 * v for k, v in per_solo.items()}
    for k in range(4):
        assert torch.equal(got[k], want)


@pytest.mark.parametrize("solver", ["fft", "jacobi"])
def test_fd_core_on_the_card_matches_the_cpu(cuda, solver):
    """The FD core's torch ops on the card against the CPU at 64^2 after
    3 steps, warm-started at the IC's FD streamfunction, rel-L2 <= TOL,
    the Jacobi sweep counts within one (chip_smoke.py phase 5m: near
    float32's residual floor a cold start's counts are round-off's)."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.fd_core import (FDBarotropicModel,
                                                         poisson_fft)

    cfg = ModelConfig(nx=64, ny=64)
    v0 = makefields.gaussian(cfg)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        m = FDBarotropicModel.build(cfg, dev, tol=1e-3, max_iter=2000,
                                    solver=solver)
        z = torch.from_numpy(v0).to(dev)
        runs.append((m.segment(z, poisson_fft(z, cfg.dx, cfg.dy),
                               m.zero_source(), 3)[0],
                     [int(s) for s in m.sweeps]))
    (zd, kd), (zc, kc) = runs
    assert float((zd.cpu() - zc).norm() / zc.norm()) <= TOL
    assert len(kd) == len(kc) and all(abs(a - b) <= 1
                                      for a, b in zip(kd, kc))


@pytest.mark.parametrize("tol", [1e-3, 1e-4, 1e-5])
def test_jacobi_stops_at_the_cpus_sweep(cuda, tol):
    """poisson_jacobi from zero on the 5-point Laplacian of a (4, 2) wave
    at 64^2: the card's stopping sweep within one of the CPU's, the
    solutions within TOL."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.models.fd_core import (laplacian5,
                                                         poisson_jacobi)

    cfg = ModelConfig(nx=64, ny=64)
    x, y = cfg.coords()
    wave = torch.from_numpy((np.sin(2 * np.pi * 4 * x / cfg.lx)[:, None]
                             * np.cos(2 * np.pi * 2 * y[None, :] / cfg.ly)
                             ).astype(np.float32))
    rhs = laplacian5(wave, cfg.dx, cfg.dy)
    (xd, kd), (xc, kc) = (poisson_jacobi(rhs.to(d), cfg.dx, cfg.dy, tol=tol)
                          for d in (cuda, torch.device("cpu")))
    assert 1 < int(kc) < 10_000 and abs(int(kd) - int(kc)) <= 1
    assert _rel(xd.cpu(), xc) <= TOL


# ----- fast mode, the last forms: rows 12, 13 single, 14, 21 and 22 -----

@pytest.mark.parametrize("p", [1, 2, 8])
def test_fast_xstages_on_other_shard_counts(cuda, p):
    """The fast x-stage's three modes at 256^2 on 1, 2 and 8 shards,
    held as test_fast_kernel_matches_plain_and_strict holds them on 4."""
    from chip_smoke import FAST_XSTAGES, fast_check, fast_rest_cases

    cases = fast_rest_cases(256, None, cuda, 300 + p, p)
    for name in FAST_XSTAGES:
        fast_check(name, cases[name], f"256^2 on {p} shards")


def test_fast_sw_drag_launches_and_error_class(cuda):
    """Two SW RK4 steps with drag and hyperviscosity in fast mode at 256^2
    launch 4 stages x (10 ka_fast, 2 kb_fast, 6 kc_fast) per step and
    nothing else, and stay within rel-L2 1e-7 .. 1e-2 of the strict drag
    path in zeta and eta (div has no bar)."""
    import warnings

    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel, max_stable_dt)

    cfg = ModelConfig(nx=256, ny=256)
    drag = cfg.replace(dt=max_stable_dt(cfg), r_drag=2e-4, nu4=1e9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fast = ShallowWaterModel.build(drag, cuda, fast=True)
        strict = ShallowWaterModel.build(drag, cuda, fast.tables)
    assert fast.per_transform and fast.fast and fast.split
    s0 = fast.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5))
    ff.reset_launches()
    a = fast.segment(s0, fast.zero_source(), 2)
    torch.cuda.synchronize()
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), "ka_fast": 80,
                           "kb_fast": 16, "kc_fast": 48}
    b = strict.segment(s0, strict.zero_source(), 2)
    for x, y in ((a.zeta_hat, b.zeta_hat), (a.eta_hat, b.eta_hat)):
        fx, fy = (torch.fft.irfft2(z, s=(256, 256)) for z in (x, y))
        rel = float(torch.linalg.vector_norm(fx - fy)
                    / torch.linalg.vector_norm(fy))
        assert 1e-7 < rel < 1e-2, rel


def test_fast_adjoint_gradient_launches_and_bar(cuda):
    """A 3-step barotropic rollout gradient at 256^2 in fast mode launches
    the strict gradient's counts under the fast names (60n + 4 ka_fast,
    20n + 2 kb_fast, 24n + 2 kc_fast) and lies within rel-L2 1e-1 of the
    strict kernels' gradient, above 1e-7 (chip_smoke.py FAST_GRAD_BAR)."""
    from xlab_fftbarotropic_torch import adjoint
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields

    n = 3
    cfg = ModelConfig(nx=256, ny=256)
    truth = makefields.gaussian(cfg)
    src = torch.zeros(cfg.grid_shape, device=cuda)
    with torch.no_grad():
        target = adjoint.make_rollout(cfg, n, device=cuda)(truth, src)
    grads = {}
    for fast in (False, True):
        loss = adjoint.final_state_misfit(cfg, target, n, device=cuda,
                                          fast=fast)
        ff.reset_launches()
        _, grads[fast] = adjoint.loss_and_grad(loss, device=cuda)(
            0.9 * truth, src)
        torch.cuda.synchronize()
        sfx = "_fast" if fast else ""
        assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0),
                               "ka" + sfx: 60 * n + 4, "kb" + sfx: 20 * n + 2,
                               "kc" + sfx: 24 * n + 2}
    rel = float(torch.linalg.vector_norm(grads[True] - grads[False])
                / torch.linalg.vector_norm(grads[False]))
    assert 1e-7 < rel <= 1e-1, rel


@pytest.mark.parametrize("decomp", ["slab", "xpencil"])
def test_fast_sharded_overlap_launches_and_error_class(cuda, decomp):
    """Three RK4 steps of the overlap impl in fast mode on four shards at
    256^2 launch the strict overlap path's x-stages under their fast
    names (slab: 20 xstage_fast per step; x-pencil: 4 xstage_gather_fast
    and 16 xstage_scatter_fast), and the vorticity (the state through the
    library inverse) lies within rel-L2 1e-7 .. 1e-4 of the strict
    overlap run's; the xla and pallas impls with fast=True step bit for
    bit as without."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.parallel import (ShardedBarotropicModel,
                                                   make_mesh)

    n = 256
    cfg = ModelConfig(nx=n, ny=n)
    mesh = make_mesh(4, cuda)
    fast = ShardedBarotropicModel.build(cfg, mesh, "overlap", decomp,
                                        fast=True)
    strict = ShardedBarotropicModel.build(cfg, mesh, "overlap", decomp)
    z0 = fast.init_state(makefields.gaussian(cfg))
    src = fast.zero_source()
    ff.reset_launches()
    a = fast.segment(z0, src, 3)
    torch.cuda.synchronize()
    want = ({"xstage_fast": 60} if decomp == "slab"
            else {"xstage_gather_fast": 12, "xstage_scatter_fast": 48})
    assert ff.LAUNCHES == {**dict.fromkeys(ff.LAUNCHES, 0), **want}
    b = strict.segment(z0, src, 3)
    va, vb = (torch.fft.irfft2(m.unshard_spectral(z), s=(n, n))
              for m, z in ((fast, a), (strict, b)))
    rel = float(torch.linalg.vector_norm(va - vb)
                / torch.linalg.vector_norm(vb))
    assert 1e-7 < rel <= 1e-4, rel
    for impl in ("xla", "pallas"):
        runs = [ShardedBarotropicModel.build(cfg, mesh, impl, decomp,
                                             fast=f) for f in (True, False)]
        assert not runs[0].fast
        assert torch.equal(*(r.segment(z0, src, 2) for r in runs))
