"""The port's spectral tables and operators against the JAX package's
(xlab_fftbarotropic_tpu/ops/spectral.py), on the CPU. The tables come
from the same float64 numpy functions, so they must be bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.ops import spectral as jsp
from xlab_fftbarotropic_torch.ops import spectral as tsp

L = 600_000.0


@pytest.mark.parametrize("n", [64, 128, 768])
@pytest.mark.parametrize("rule", ["circular", "twothirds"])
def test_tables_bit_identical(n, rule):
    jt = jsp.SpectralTables.build(n, n, L, L, rule)
    tt = tsp.SpectralTables.build(n, n, L, L, rule, device="cpu")
    for name in tsp.SpectralTables.NAMES:
        t = getattr(tt, name)
        assert t.dtype == torch.float32, name
        np.testing.assert_array_equal(np.asarray(getattr(jt, name)),
                                      t.numpy(), err_msg=name)


def test_tables_are_buffers_on_the_device():
    tt = tsp.SpectralTables.build(64, 64, L, L, device="cpu")
    assert {n for n, _ in tt.named_buffers()} == set(tt.NAMES)
    assert all(b.device.type == "cpu" and b.is_contiguous()
               for b in tt.buffers())
    with pytest.raises(ValueError):
        tsp.dealias_mask(64, 64, "square")


def test_operators_match_jax():
    n = 64
    jt = jsp.SpectralTables.build(n, n, L, L)
    tt = tsp.SpectralTables.build(n, n, L, L, device="cpu")
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((n, n // 2 + 1))
         + 1j * rng.standard_normal((n, n // 2 + 1))).astype(np.complex64)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    for name in ("gradx", "grady", "laplacian", "invert_laplacian",
                 "dealias"):
        want = np.asarray(getattr(jsp, name)(jt, ja))
        got = getattr(tsp, name)(tt, ta)
        assert got.dtype == torch.complex64, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0,
                                   err_msg=name)
    for w, g in zip(jsp.velocities(jt, ja), tsp.velocities(tt, ta)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
