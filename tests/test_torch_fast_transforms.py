"""Fast mode on the per-transform pipeline (the JAX package's
--fast-transforms for rfft2, irfft2 and inverse_pair, their custom VJPs
and what runs on them): the port's fast forms (ops/fused_fft.py ka, kc
and kb with fast=True; on CPU tensors their plain versions, the strict
plain versions' loads and stores around ops/fast_tile.py's emulation of
the fast column tile) against float64 and against the JAX package's own
bf16 rounding (pallas_fft.MM_MODE = "bf16" in interpret mode, set by
monkeypatch, as tests/test_torch_fast_xfirst.py does); the fast VJPs of
ops/fused_diff.py against pallas_diff's; one shallow-water RK4 step with
drag and hyperviscosity (the per-transform path) in each package's fast
mode against its strict step; the fast adjoint rollout's gradient
against the strict one, beside the JAX package's fast gradient, its
segmentation invariance and a directional finite-difference check.
64^2, one intra-op thread.

Bars: a fast transform's or VJP's rel-L2 against float64 lies within a
factor of 5 either way of the JAX package's bf16 error on the same
input, and in 1e-4 .. 1e-2; the fast form differs from the strict one by
more than 1e-7 (fast is not quietly strict). The SW drag step's rel-L2
of zeta and eta against its strict step is above 1e-7, within a factor
of 5 of the port's fast plane-stepper step, and at most 5 times the JAX
package's: the JAX fast inverse_pair leaks eta (about 1e4 times zeta)
into zeta at bf16, where the port pairs them at one magnitude (the plane
stepper's equalizer), so its step is far closer to strict. The fast
gradient lies within a factor of 5 of the JAX package's fast gradient's
rel-L2 against the strict one (both in one class on this twin problem:
the guess's misfit is a tenth of the field, so the two end transforms'
bf16 error shows about ten times in it), below 1e-1 and above 1e-7; the segmented fast rollout as
tightly as the strict one (tests/test_torch_adjoint.py: atol 1e-7
outputs, rtol 1e-4 gradients); the finite difference of the fast loss
at rtol 1e-1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.models import shallow_water as jsw
from xlab_fftbarotropic_tpu.ops import pallas_diff as pd
from xlab_fftbarotropic_tpu.ops import pallas_fft as pf
from xlab_fftbarotropic_torch import adjoint as tadj
from xlab_fftbarotropic_torch.models import shallow_water as tsw
from xlab_fftbarotropic_torch.ops import fused_diff as fd
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from torch_threads import _one_thread  # noqa: F401

N = 64
G = (N, N)
CPU = torch.device("cpu")
FACTOR = 5.0
CLASS = (1e-4, 1e-2)
FLOOR = 1e-7


@pytest.fixture
def bf16(monkeypatch):
    """The JAX package in fast mode's bf16 rounding (interpret mode). MM_MODE
    is read at trace time, and pallas_diff jits at import: the caches are
    cleared on both sides, so no strict trace made earlier in the process
    serves this mode, nor this mode's a later strict call."""
    import jax

    jax.clear_caches()
    monkeypatch.setattr(pf, "MM_MODE", "bf16")
    yield
    jax.clear_caches()


def _rel(got, want) -> float:
    got = np.asarray(got, np.complex128).ravel()
    want = np.asarray(want, np.complex128).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(seed):
    """A real field, and two half-spectra of real fields (Hermitian on
    the self-conjugate columns, so every inverse is the same map)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(G).astype(np.float32)
    specs = [np.fft.rfft2(rng.standard_normal(G)).astype(np.complex64)
             for _ in range(2)]
    return x, specs


def _held(port, jax, ref, strict):
    """The port's fast result and the JAX fast one against float64 ref:
    each in CLASS, within FACTOR of each other, the port's off strict."""
    e_port, e_jax = _rel(port, ref), _rel(jax, ref)
    assert CLASS[0] < e_port < CLASS[1], e_port
    assert 1.0 / FACTOR < e_port / e_jax < FACTOR, (e_port, e_jax)
    assert _rel(port, strict) > FLOOR
    return e_port, e_jax


@pytest.mark.parametrize("fn", ["rfft2", "irfft2", "inverse_pair"])
def test_fast_transforms_match_the_jax_fast_mode(bf16, fn):
    """ff.rfft2 (ka_fast + kc_fast), irfft2 (ka_fast + the single
    kb_fast) and inverse_pair (two ka_fast + the paired kb_fast) against
    float64, beside pallas_fft's under MM_MODE bf16."""
    x, (sa, sb) = _inputs(7)
    ta, tb = torch.from_numpy(sa), torch.from_numpy(sb)
    if fn == "rfft2":
        port = ff.rfft2(torch.from_numpy(x), fast=True)
        strict = ff.rfft2(torch.from_numpy(x))
        _held(port.numpy(), pf.rfft2(jnp.asarray(x)),
              np.fft.rfft2(x.astype(np.float64)), strict.numpy())
    elif fn == "irfft2":
        port = ff.irfft2(ta, G, fast=True)
        assert port.shape == G
        _held(port.numpy(), pf.irfft2(jnp.asarray(sa), G),
              np.fft.irfft2(sa.astype(np.complex128), s=G),
              ff.irfft2(ta, G).numpy())
    else:
        port = ff.inverse_pair(ta, tb, G, fast=True)
        strict = ff.inverse_pair(ta, tb, G)
        jax = pf.inverse_pair(jnp.asarray(sa), jnp.asarray(sb), G)
        for p, j, s, z in zip(port, jax, strict, (sa, sb)):
            _held(p.numpy(), j, np.fft.irfft2(z.astype(np.complex128),
                                              s=G), s.numpy())
    # a CPU tensor takes the plain versions: no launch is counted
    ff.reset_launches()
    ff.rfft2(torch.from_numpy(x), fast=True)
    assert sum(ff.LAUNCHES.values()) == 0


def test_fast_ka_and_kc_are_their_plain_versions():
    """ka(fast=True) in each mode, scale 0.37, and kc(fast=True) on CPU
    tensors are ka_fast_plain's and kc_fast_plain's bits; ka's scale is
    one rounded product after the fast transform."""
    rng = np.random.default_rng(3)
    xr, xi = (torch.from_numpy(rng.standard_normal(G).astype(np.float32))
              for _ in range(2))
    for forward in (True, False):
        for im in (None, xi):
            got = ff.ka(xr, im, forward, 0.37, fast=True)
            want = ff.ka_fast_plain(xr, im, forward, 0.37)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            one = ff.ka_fast_plain(xr, im, forward)
            assert torch.equal(got[0], one[0] * 0.37)
    got = ff.kc(xr, xi, fast=True)
    assert got[0].shape == (N, N // 2 + 1)
    assert all(torch.equal(a, b) for a, b in zip(got,
                                                 ff.kc_fast_plain(xr, xi)))


def _torch_vjp(fn, inputs, cts, dtype=torch.float32):
    ins = [torch.from_numpy(np.array(a)).to(dtype).requires_grad_(True)
           if not np.iscomplexobj(a) else
           torch.from_numpy(np.array(a)).to(
               torch.complex128 if dtype == torch.float64
               else torch.complex64).requires_grad_(True) for a in inputs]
    out = fn(*ins)
    out = out if isinstance(out, tuple) else (out,)
    cts = [torch.from_numpy(np.array(c)).to(o.dtype) for c, o in zip(cts,
                                                                      out)]
    return [g.detach().numpy() for g in torch.autograd.grad(out, ins, cts)]


def _library64():
    """The float64 reference maps on torch.fft (autograd for the VJPs)."""
    def fwd(x):
        return torch.fft.rfft2(x)

    def inv(s):
        return torch.fft.irfft2(s, s=G)

    return fwd, inv


def test_fast_vjps_match_pallas_diff(bf16):
    """The fast VJPs of ops/fused_diff.py (both sweeps on the fast forms)
    against float64 (torch.fft's autograd), beside pallas_diff's custom
    VJPs under MM_MODE bf16, in torch's conjugate convention (the port's
    VJP under g is pallas_diff's under conj(g); a complex input's
    gradient is the conjugate of JAX's)."""
    import jax

    rng = np.random.default_rng(11)
    x, (sa, sb) = _inputs(11)
    ct = (rng.standard_normal((N, N // 2 + 1))
          + 1j * rng.standard_normal((N, N // 2 + 1))).astype(np.complex64)
    u = [rng.standard_normal(G).astype(np.float32) for _ in range(2)]
    f64, i64 = _library64()
    # forward
    _, vjp = jax.vjp(pd.forward, jnp.asarray(x))
    jx = np.asarray(vjp(jnp.conj(jnp.asarray(ct)))[0])
    port = _torch_vjp(lambda a: fd.forward(a, fast=True), [x], [ct])[0]
    strict = _torch_vjp(fd.forward, [x], [ct])[0]
    ref = _torch_vjp(f64, [x], [ct], torch.float64)[0]
    _held(port, jx, ref, strict)
    # inverse
    _, vjp = jax.vjp(lambda s: pd.inverse(s, G), jnp.asarray(sa))
    js = np.conj(np.asarray(vjp(jnp.asarray(u[0]))[0]))
    port = _torch_vjp(lambda s: fd.inverse(s, G, fast=True), [sa],
                      u[:1])[0]
    strict = _torch_vjp(lambda s: fd.inverse(s, G), [sa], u[:1])[0]
    ref = _torch_vjp(i64, [sa], u[:1], torch.float64)[0]
    _held(port, js, ref, strict)
    # inverse_pair
    _, vjp = jax.vjp(lambda a, b: pd.inverse_pair(a, b, G),
                     jnp.asarray(sa), jnp.asarray(sb))
    jp = [np.conj(np.asarray(g)) for g in vjp(tuple(jnp.asarray(a)
                                                    for a in u))]
    port = _torch_vjp(lambda a, b: fd.inverse_pair(a, b, G, fast=True),
                      [sa, sb], u)
    strict = _torch_vjp(lambda a, b: fd.inverse_pair(a, b, G), [sa, sb], u)
    ref = _torch_vjp(lambda a, b: (i64(a), i64(b)), [sa, sb], u,
                     torch.float64)
    for p, j, r, s in zip(port, jp, ref, strict):
        _held(p, j, r, s)


def test_fast_vjps_save_no_tensor_and_keep_fast_in_ctx():
    """fast rides in ctx as a Python bool: the backward sweep runs the
    fast forms (on the CPU the plain versions: nothing is counted) and
    no tensor is saved."""
    x, (sa, _) = _inputs(5)
    u = torch.from_numpy(x)
    s = torch.from_numpy(sa).requires_grad_(True)
    out = fd.inverse(s, G, fast=True)
    assert out.grad_fn.saved_tensors == () and out.grad_fn.fast is True
    ff.reset_launches()
    out.backward(u)
    assert sum(ff.LAUNCHES.values()) == 0
    slow = torch.from_numpy(sa).requires_grad_(True)
    fd.inverse(slow, G).backward(u)
    assert _rel(s.grad.numpy(), slow.grad.numpy()) > FLOOR


# ------------------------------------------ shallow water, drag and nu4

SW = ModelConfig(nx=N, ny=N, dt=1.0, fft_backend="pallas", r_drag=2e-4,
                 nu4=1e9)


def _phys(state):
    return [np.fft.irfft2(np.asarray(z), s=G) for z in state]


def test_fast_sw_drag_step_matches_the_jax_fast_mode():
    """One RK4 step with r_drag and nu4 on the per-transform path, in each
    package's fast mode (the JAX package's pallas_fft under MM_MODE bf16,
    split-linear on, as pallas_sw.split_linear resolves it there; the
    port's fast ka, kb and kc, split-linear by default in fast mode, eta
    paired at zeta's magnitude) against its own strict step (the JAX
    package's on its library path, which its strict per-transform step
    matches at float32 round-off, tests/test_torch_per_transform.py):
    rel-L2 of zeta and eta above 1e-7, at most 5 times the JAX package's,
    and within a factor of 5 of the port's fast plane-stepper step (the
    same state, no drag)."""
    import jax

    v0 = makefields.gaussian(SW)
    runs = {}
    for fast in (False, True):
        jax.clear_caches()
        with pytest.MonkeyPatch.context() as mp:
            if fast:
                mp.setattr(pf, "MM_MODE", "bf16")
                with pytest.warns(UserWarning, match="per-transform"):
                    jm = jsw.ShallowWaterModel.build(SW)
            else:
                jm = jsw.ShallowWaterModel.build(SW.replace(
                    fft_backend="xla"))
            runs["jax", fast] = _phys(jm.step(jm.geostrophic_init(v0),
                                              jm.zero_source()))
        with pytest.warns(UserWarning, match="per-transform"):
            m = tsw.ShallowWaterModel.build(SW, CPU, fast=fast)
        assert m.per_transform and m.fast == fast and m.split == fast
        runs["port", fast] = _phys([z.numpy() for z in m.step(
            m.geostrophic_init(v0), m.zero_source())])
        plane = tsw.ShallowWaterModel.build(SW.replace(r_drag=0.0, nu4=0.0),
                                            CPU, fast=fast)
        assert not plane.per_transform
        runs["plane", fast] = _phys([z.numpy() for z in plane.step(
            plane.geostrophic_init(v0), plane.zero_source())])
    jax.clear_caches()
    for i, name in ((0, "zeta"), (2, "eta")):
        jax_e = _rel(runs["jax", True][i], runs["jax", False][i])
        port = _rel(runs["port", True][i], runs["port", False][i])
        plane = _rel(runs["plane", True][i], runs["plane", False][i])
        assert port > FLOOR, (name, port)
        assert port < FACTOR * jax_e, (name, port, jax_e)
        assert 1.0 / FACTOR < port / plane < FACTOR, (name, port, plane)


def test_fast_pair_keeps_zeta_apart_from_eta():
    """The fast inverse_pair of (zeta_hat, eta_hat) of a balanced state
    (eta about 1e4 times zeta) leaks eta into zeta at bf16 (a + i b is
    rounded as one value), and the equalizer eta_scale removes it: zeta
    from the scaled pair is in the fast class of zeta alone."""
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    m = tsw.ShallowWaterModel.build(SW.replace(r_drag=0.0, nu4=0.0), CPU)
    s = m.geostrophic_init(makefields.gaussian(SW))
    ref = np.fft.irfft2(s.zeta_hat.numpy().astype(np.complex128), s=G)
    es = float(fs.eta_pair_scale(tsw.state_to_planes(s)))
    assert es < 1e-2 and es == 2.0 ** round(np.log2(es))
    leak = ff.inverse_pair(s.zeta_hat, s.eta_hat, G, fast=True)[0]
    fixed, eta_s = ff.inverse_pair(s.zeta_hat, s.eta_hat * es, G, fast=True)
    alone = ff.irfft2(s.zeta_hat, G, fast=True)
    assert _rel(leak.numpy(), ref) > 0.1
    assert _rel(fixed.numpy(), ref) < FACTOR * _rel(alone.numpy(), ref)
    eta = eta_s * (1.0 / es)
    want = np.fft.irfft2(s.eta_hat.numpy().astype(np.complex128), s=G)
    assert CLASS[0] < _rel(eta.numpy(), want) < CLASS[1]


def test_fast_sw_forcing_spectrum_takes_the_fast_forms():
    """The forcing spectrum of the plane stepper in fast mode is the fast
    rfft2's (forward_planes on ka_fast and kc_fast), and the strict one
    in strict mode."""
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    src = torch.from_numpy(np.random.default_rng(9).standard_normal(
        G).astype(np.float32))
    fast = torch.complex(*fs.forward_planes(src, True))
    assert torch.equal(fast, ff.rfft2(src, fast=True))
    assert torch.equal(torch.complex(*fs.forward_planes(src)),
                       ff.rfft2(src))
    assert not torch.equal(fast, ff.rfft2(src))


# ------------------------------------------------------------- adjoint

ADJ = ModelConfig(nx=N, ny=N, dt=3.0, nu=6.5)


def _smooth_ic(seed=0):
    """Band-limited random IC (tests/test_adjoint.py:_smooth_ic)."""
    rng = np.random.default_rng(seed)
    x = np.arange(N)[:, None] / N
    y = np.arange(N)[None, :] / N
    z = np.zeros(G, np.float32)
    for kx in range(1, 4):
        for ky in range(1, 4):
            ph = rng.uniform(0, 2 * np.pi, size=2)
            z += np.float32(rng.standard_normal() * 1e-5) * np.float32(
                np.sin(2 * np.pi * (kx * x + ky * y) + ph[0])
                * np.cos(2 * np.pi * (ky * x - kx * y) + ph[1]))
    return torch.from_numpy(z)


def _grad(fast, steps=2, segment=None, target=None):
    ic, src = _smooth_ic(), torch.zeros(G)
    if target is None:
        with torch.no_grad():
            target = 0.9 * tadj.make_rollout(ADJ, steps, device=CPU)(ic, src)
    loss = tadj.final_state_misfit(ADJ, target, steps, segment=segment,
                                   device=CPU, fast=fast)
    return tadj.loss_and_grad(loss, device=CPU)(ic, src)[1].numpy(), target


def _jax_fast_gradient(target):
    """The JAX package's gradient of the same loss through pallas_diff's
    custom VJPs under MM_MODE bf16 (interpret mode)."""
    import jax

    from xlab_fftbarotropic_tpu import adjoint as jadj

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pf, "MM_MODE", "bf16")
        roll = jadj.make_rollout(ADJ.replace(fft_backend="pallas"), 2)
        src = jnp.zeros(G, jnp.float32)
        tgt = jnp.asarray(target.numpy())

        def loss(ic):
            return 0.5 * jnp.mean(jnp.square(roll(ic, src) - tgt))
        g = np.asarray(jax.grad(loss)(jnp.asarray(_smooth_ic().numpy())))
    jax.clear_caches()
    return g


def test_fast_gradient_is_within_the_bar_of_the_strict_one():
    """The fast rollout's gradient (both sweeps on the fast forms) against
    the strict gradient: above 1e-7, below 1e-1, and within a factor of
    5 of the JAX package's fast gradient against the same strict one."""
    strict, target = _grad(False)
    fast, _ = _grad(True, target=target)
    rel = _rel(fast, strict)
    jax_rel = _rel(_jax_fast_gradient(target), strict)
    assert FLOOR < rel < 1e-1, rel
    assert 1.0 / FACTOR < rel / jax_rel < FACTOR, (rel, jax_rel)


def test_fast_segmented_rollout_matches_unsegmented():
    """torch.utils.checkpoint recomputes each segment in the backward
    sweep on the same deterministic fast forms: outputs and gradients
    of segments 1, 2 and 3 of a 3-step window agree as the strict
    ones do."""
    ic, src = _smooth_ic(), torch.zeros(G)
    with torch.no_grad():
        outs = [tadj.make_rollout(ADJ, 3, segment=s, device=CPU,
                                  fast=True)(ic, src) for s in (1, 2, 3)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=0,
                                   atol=1e-7)
    target = 0.9 * outs[0]
    grads = [_grad(True, 3, s, target)[0] for s in (1, 2, 3)]
    for g in grads[1:]:
        np.testing.assert_allclose(g, grads[0], rtol=1e-4, atol=1e-12)


def test_fast_gradient_matches_finite_difference():
    """The fast gradient along a band-limited random direction against a
    central finite difference of the fast loss (tests/test_adjoint.py:
    44-88), far from the optimum (a zero target) and with a step of 0.2
    of the IC's norm: the fast loss is the strict one plus bf16 rounding,
    which is not smooth at the scale of a small step, and the loss is
    nearly quadratic over two steps of this weak flow. The bar is rtol
    1e-1, twice the strict check's: the rounding's share of the
    difference varies with the direction."""
    ic, src = _smooth_ic(), torch.zeros(G)
    loss = tadj.final_state_misfit(ADJ, torch.zeros(G), 2, device=CPU,
                                   fast=True)
    _, grad = tadj.loss_and_grad(loss, device=CPU)(ic, src)
    d = _smooth_ic(1)
    d = d / torch.linalg.vector_norm(d)
    ad = float(torch.sum(grad * d))
    eps = 0.2 * float(torch.linalg.vector_norm(ic))
    with torch.no_grad():
        fdiff = (float(loss(ic + eps * d, src))
                 - float(loss(ic - eps * d, src))) / (2 * eps)
    assert fdiff != 0.0
    assert abs(ad - fdiff) <= 1e-1 * max(abs(fdiff), abs(ad)), (ad, fdiff)


@pytest.mark.parametrize("kind", ["barotropic", "sw", "tracer"])
def test_fast_rollout_of_each_family_stays_in_class(kind):
    """make_rollout(..., fast=True) for the three families (shallow water
    with drag and hyperviscosity, its (zeta, eta) pair equalized; the
    tracer with kappa): each final field within rel-L2 1e-2 of the strict
    rollout's and above 1e-7 (the SW divergence, noise-dominated against
    a balanced flow's near-zero divergence, has no bar)."""
    cfg = ADJ.replace(dt=0.5, r_drag=2e-5, nu4=1e9) if kind == "sw" else ADJ
    ic = _smooth_ic()
    ic = (ic, _smooth_ic(2)) if kind == "tracer" else ic
    with torch.no_grad():
        outs = [tadj.make_rollout(cfg, 2, kind, tracer_kappa=5.0, device=CPU,
                                  fast=fast)(ic, torch.zeros(G))
                for fast in (False, True)]
    strict, fast = ([o] if kind == "barotropic" else list(o) for o in outs)
    for i, (a, b) in enumerate(zip(fast, strict)):
        if kind == "sw" and i == 1:
            continue
        assert FLOOR < _rel(a.numpy(), b.numpy()) < 1e-2, (kind, i)
