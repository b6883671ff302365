"""Fast mode on the shallow-water x-first order (the JAX package's
--fast-transforms with pallas_sw.YFIRST = False): one step of the port's
x-first fast segment, RK4 and ETDRK4, against its strict x-first run,
the rel-L2 of zeta and eta within a factor of 5 of the JAX package's
fast run against its strict run in the same order, and above 1e-7 (fast
is not quietly strict). The barotropic x-first order and the fast forms
one by one: tests/test_torch_fast_xfirst.py.

64^2, one step, one intra-op thread. Each scheme is a test of its own:
its JAX compiles are most of its time, so `-n 6` spreads them.
"""

import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.models import shallow_water as jsw
from xlab_fftbarotropic_tpu.ops import pallas_fft as pf
from xlab_fftbarotropic_tpu.ops import pallas_sw as psw
from xlab_fftbarotropic_torch.models import shallow_water as tsw
from torch_threads import _one_thread  # noqa: F401

N = 64
SW = ModelConfig(nx=N, ny=N, fft_backend="pallas", dt=1.0)
CPU = torch.device("cpu")
FACTOR = 5.0


def _rel(got, want) -> float:
    got = np.concatenate([np.asarray(g, np.complex128).ravel() for g in got])
    want = np.concatenate([np.asarray(w, np.complex128).ravel()
                           for w in want])
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_sw(cfg, v0, fast, monkeypatch):
    monkeypatch.setattr(psw, "YFIRST", False)
    monkeypatch.setattr(pf, "MM_MODE", "bf16" if fast else "fp32")
    # strict RK4 runs split-linear as fast mode does (strict float32
    # takes it at round-off); strict ETDRK4 runs it off, as by default
    monkeypatch.setattr(psw, "SPLIT_LINEAR", "1" if cfg.time_scheme == "rk4"
                        else "auto")
    m = jsw.ShallowWaterModel.build(cfg)
    s = m.segment(m.geostrophic_init(v0), m.zero_source(), 1)
    return [np.fft.irfft2(np.asarray(z), s=cfg.grid_shape) for z in s]


def _port_sw(cfg, v0, **kw):
    m = tsw.ShallowWaterModel.build(cfg, CPU, yfirst=False, **kw)
    s = m.segment(m.geostrophic_init(v0), m.zero_source(), 1)
    return m, [np.fft.irfft2(z.numpy(), s=cfg.grid_shape) for z in s]


@pytest.mark.parametrize("scheme", ["rk4", "etdrk4"])
def test_sw_xfirst_fast_error_matches_the_jax_fast_mode(monkeypatch,
                                                        scheme):
    """One step of shallow water's x-first order in fast mode at 64^2
    (the balanced gaussian vortex; RK4 at dt 1 s, ETDRK4 at 7.5 s): the
    port's zeta and eta against its strict x-first run, rel-L2 within a
    factor of 5 of the JAX package's (pallas_sw.YFIRST = False, MM_MODE
    "bf16" against "fp32") and above 1e-7 (div is noise-dominated at
    64^2 in both packages and has no bar)."""
    monkeypatch.setenv("XFB_ETD_CACHE", "0")
    etd = scheme == "etdrk4"
    cfg = SW.replace(time_scheme=scheme, dt=7.5 if etd else 1.0)
    v0 = makefields.gaussian(cfg)
    j_fast = _jax_sw(cfg, v0, True, monkeypatch)
    j_strict = _jax_sw(cfg, v0, False, monkeypatch)
    m, p_fast = _port_sw(cfg, v0, fast=True)
    assert m.split and m.pstore == "f32"
    p_strict = _port_sw(cfg, v0, split=not etd)[1]
    for i, name in ((0, "zeta"), (2, "eta")):
        jax = _rel([j_fast[i]], [j_strict[i]])
        port = _rel([p_fast[i]], [p_strict[i]])
        assert port > 1e-7, (name, port)
        assert 1.0 / FACTOR < port / jax < FACTOR, (name, port, jax)
