"""The four hand-written CUDA kernels against their plain torch versions
on the card, at the transform lengths 64, 256, 4096 and 8192.

Marked `gpu`: each test skips where torch sees no CUDA device. This file
imports no jax, so on a machine without it run it alone, past the test
directory's jax-pinning conftest:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerance: max |kernel - plain| / max |plain| <= 1e-5. The kernels' radix-2
float32 sums run in another order than cuFFT's, and the rounding error
grows with log2(n); 1e-5 is float32 epsilon times a margin for n = 4096.
"""

import numpy as np
import pytest
import torch

from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.ops.spectral import SpectralTables

pytestmark = pytest.mark.gpu

TOL = 1e-5
SIZES = [64, 256, 4096, 8192]   # 8192: 64 KB of shared memory per column


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


def _tables(n, dev):
    return SpectralTables.build(n, n, 600_000.0, 600_000.0, device=dev)


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


def test_unsupported_length_raises(cuda):
    x = torch.zeros((96, 96), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):
        ff.ky_adv(x, x, x, x, x)


def test_launch_counts_of_a_segment(cuda):
    """Two steps of the plane stepper launch 4 stages x (1 ka_diag,
    2 kb_pair, 1 ky_adv, 1 kx_visc) per step, and nothing else. The
    model is built on the bare "cuda" device name."""
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.reused import ModelConfig, makefields

    cfg = ModelConfig(nx=64, ny=64)
    m = BarotropicModel.build(cfg, "cuda")
    assert m.device == cuda
    assert m.backend == "pallas"
    z = m.init_state(makefields.gaussian(cfg))
    ff.reset_launches()
    z = m.segment(z, m.zero_source(), 2)
    torch.cuda.synchronize()
    assert ff.LAUNCHES == {"ka_diag": 8, "kb_pair": 16, "ky_adv": 8,
                           "kx_visc": 8}
    assert bool(torch.isfinite(torch.view_as_real(z)).all())
