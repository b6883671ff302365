"""The port's torch.fft library path (xlab_fftbarotropic_torch/ops/fft.py)
against the JAX package's ops/fft.py on the CPU, at a max relative error
of 2e-6 (float32 round-off of two FFT libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.ops import fft as jfft
from xlab_fftbarotropic_torch.ops import fft as tfft

BAR = 2e-6


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    return np.max(np.abs(want - got)) / np.max(np.abs(want))


def _field(kind, n, seed):
    if kind == "gaussian":
        return makefields.gaussian(ModelConfig(nx=n, ny=n))
    return np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)


def _spec(n, seed, amp=1.0):
    """A half-spectrum with non-Hermitian content in the self-conjugate
    columns, like the gradient spectra of the positive-Nyquist
    convention; its physical field has a standard deviation of about
    amp/3."""
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((n, n // 2 + 1))
         + 1j * rng.standard_normal((n, n // 2 + 1))) * (n * amp / 3.0)
    return s.astype(np.complex64)


@pytest.mark.parametrize("kind", ["random", "gaussian"])
@pytest.mark.parametrize("n", [64, 128])
def test_forward_and_inverse_match_jax(kind, n):
    x = _field(kind, n, n)
    want = jfft.forward(jnp.asarray(x))
    got = tfft.forward(torch.from_numpy(x))
    assert got.dtype == torch.complex64
    assert _rel(want, got.numpy()) < BAR
    s = np.array(want)
    assert _rel(jfft.inverse(want, (n, n)),
                tfft.inverse(torch.from_numpy(s), (n, n)).numpy()) < BAR
    assert _rel(x, tfft.inverse(torch.from_numpy(s)).numpy()) < BAR


@pytest.mark.parametrize("kind", ["random", "gaussian"])
@pytest.mark.parametrize("n", [64, 128])
def test_inverse_pair_matches_jax(kind, n):
    a = _field(kind, n, 1)
    sa = np.fft.rfft2(a).astype(np.complex64)
    # the pair partner at the same scale: round-off of the packed
    # transform is relative to the larger of the two fields
    sb = _spec(n, 2, amp=np.abs(a).max())
    want = jfft.inverse_pair(jnp.asarray(sa), jnp.asarray(sb), (n, n))
    got = tfft.inverse_pair(torch.from_numpy(sa), torch.from_numpy(sb),
                            (n, n))
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        assert _rel(w, g.numpy()) < BAR


def test_non_hermitian_inverse_matches_jax():
    n = 64
    s = _spec(n, 3)
    assert _rel(jfft.inverse(jnp.asarray(s), (n, n)),
                tfft.inverse(torch.from_numpy(s), (n, n)).numpy()) < BAR


def test_poisoned_self_conjugate_columns():
    """Non-Hermitian junk in columns 0 and ny/2 is projected out, not
    leaked into the paired field (tests/test_pallas_fft.py:49-66)."""
    n = 128
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n)).astype(np.float32)
    sa = np.fft.rfft2(a).astype(np.complex64)
    sa_p = sa.copy()
    sa_p[:, 0] += (0.3 + 0.7j) * rng.standard_normal(n).astype(np.float32)
    sa_p[:, n // 2] += (0.1 - 0.4j) * rng.standard_normal(n).astype(
        np.float32)
    before = sa_p.copy()
    ref = np.fft.irfft2(sa_p, s=(n, n))
    ga, gb = tfft.inverse_pair(torch.from_numpy(sa_p),
                               torch.from_numpy(np.zeros_like(sa_p)), (n, n))
    assert _rel(ref, ga.numpy()) < 2e-5
    assert np.max(np.abs(gb.numpy())) < 1e-5 * np.max(np.abs(ref))
    assert _rel(ref, tfft.inverse(torch.from_numpy(sa_p), (n, n)).numpy()) \
        < 2e-5
    # the symmetrization works on a copy: the caller's spectrum is intact
    np.testing.assert_array_equal(sa_p, before)
