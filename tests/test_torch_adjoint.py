"""The port's differentiable rollout (xlab_fftbarotropic_torch.adjoint)
against the JAX package's (xlab_fftbarotropic_tpu.adjoint), on the CPU.

The JAX side runs its "xla" backend (jnp.fft and its autodiff rules):
its rollout gradient through the Pallas kernels in interpret mode is a
slow-tier test there. The port runs both of its transform triples, the
library one (torch.fft autograd) and the per-transform kernels with
their adjoints (ops/fused_diff.py; on CPU tensors the kernels' plain
versions).

Bars: rollout outputs within 1e-6 (rel-L2; the SW divergence over
max(|div|, |zeta|)) of JAX; gradients within
5e-4 (rel-L2) of jax.grad, the JAX package's own bar between its pallas
and xla gradients (tests/test_pallas_diff.py); the directional
finite-difference check at rtol 5e-2 and the segmentation invariance at
atol 1e-7 (outputs) and rtol 1e-4 (gradients), as tests/test_adjoint.py;
the twin problem: the misfit falls 100x and the IC error below 0.2 of
the first guess's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu import adjoint as jadj
from xlab_fftbarotropic_tpu.config import ModelConfig
from xlab_fftbarotropic_tpu.ic.makefields import gaussian
from xlab_fftbarotropic_tpu.models.tracer import tracer_ic
from xlab_fftbarotropic_torch import adjoint as tadj

CPU = "cpu"
N = 64
STEPS = 3
# the cases the gradients are held on: family, config changes, kappa
# (drag and hyperviscosity on shallow water, all three terms on the
# tracer family's flow)
CASES = {
    "barotropic": ("barotropic", {}, 0.0),
    "sw-drag-nu4": ("sw", dict(dt=0.5, r_drag=2e-5, nu4=1e9), 0.0),
    "tracer-drag-beta-nu4": ("tracer",
                             dict(r_drag=2e-5, beta=1.6e-11, nu4=1e9), 5.0),
}


def _rel(a, b):
    a, b = np.ravel(np.asarray(a)), np.ravel(np.asarray(b))
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cfg(nx=N, **kw):
    kw.setdefault("dt", 1.0)
    return ModelConfig(nx=nx, ny=nx, **kw)


def _ic(kind, cfg, seed=2):
    rng = np.random.default_rng(seed)
    vort = (1e-4 * rng.standard_normal(cfg.grid_shape)).astype(np.float32)
    return (vort, tracer_ic(cfg, "gaussian")) if kind == "tracer" else vort


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(a) for a in x]
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _jax_value_and_grad(kind, cfg, kappa, ic, src):
    roll = jadj.make_rollout(cfg.replace(fft_backend="xla"), STEPS,
                             model_kind=kind, tracer_kappa=kappa)

    def loss(ic, src):
        out = jax.tree_util.tree_leaves(roll(ic, src))
        return 0.5 * sum(jnp.mean(jnp.square(a)) for a in out)

    ic_j = jax.tree_util.tree_map(jnp.asarray, ic)
    out = roll(ic_j, jnp.asarray(src))
    return ([np.asarray(a) for a in jax.tree_util.tree_leaves(out)],
            [np.asarray(a) for a in jax.tree_util.tree_leaves(
                jax.grad(loss)(ic_j, jnp.asarray(src)))])


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX xla rollout's final fields and jax.grad of the half mean
    square of them with respect to the IC, for every case."""
    out = {}
    for name, (kind, kw, kappa) in CASES.items():
        cfg = _cfg(**kw)
        ic = _ic(kind, cfg)
        src = np.zeros(cfg.grid_shape, np.float32)
        out[name] = (ic, src) + _jax_value_and_grad(kind, cfg, kappa, ic,
                                                    src)
    return out


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_rollout_and_gradient_match_jax(jax_refs, case, backend):
    kind, kw, kappa = CASES[case]
    cfg = _cfg(fft_backend=backend, **kw)
    ic, src, want_out, want_grad = jax_refs[case]
    roll = tadj.make_rollout(cfg, STEPS, model_kind=kind,
                             tracer_kappa=kappa, device=CPU)
    with torch.no_grad():
        got = _np(roll(ic, src))
    got = got if isinstance(got, list) else [got]
    # SW div, a residual far below zeta, over max(|div|, |zeta|) as the
    # JAX package's SW bars take it
    norms = [max(np.linalg.norm(w), np.linalg.norm(want_out[0]))
             if kind == "sw" and i == 1 else np.linalg.norm(w)
             for i, w in enumerate(want_out)]
    for g, w, m in zip(got, want_out, norms):
        assert np.linalg.norm(np.ravel(g - w)) / m < 1e-6

    def loss(ic, src):
        out = roll(ic, src)
        out = out if isinstance(out, tuple) else (out,)
        return 0.5 * sum(torch.mean(torch.square(a)) for a in out)

    vg = tadj.loss_and_grad(loss, device=CPU)
    _, grad = vg(ic, src)
    grad = _np(grad)
    grad = grad if isinstance(grad, list) else [grad]
    assert len(grad) == len(want_grad)
    for g, w in zip(grad, want_grad):
        assert np.isfinite(g).all() and np.abs(g).max() > 0
        assert _rel(g, w) < 5e-4


def _smooth_ic(cfg, amp=1e-4):
    """Band-limited random IC (tests/test_adjoint.py:_smooth_ic)."""
    rng = np.random.default_rng(0)
    nx, ny = cfg.grid_shape
    z = np.zeros((nx, ny), np.float32)
    x = np.arange(nx)[:, None] / nx
    y = np.arange(ny)[None, :] / ny
    for kx in range(1, 4):
        for ky in range(1, 4):
            ph = rng.uniform(0, 2 * np.pi, size=2)
            z += np.float32(rng.standard_normal() * amp) * np.float32(
                np.sin(2 * np.pi * (kx * x + ky * y) + ph[0])
                * np.cos(2 * np.pi * (ky * x - kx * y) + ph[1]))
    return z


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("wrt", ["ic", "src"])
def test_gradient_matches_finite_difference(backend, wrt):
    """The gradient along a random direction against a central finite
    difference of the same loss (tests/test_adjoint.py:44-88)."""
    cfg = _cfg(dt=3.0, nu=6.5, fft_backend=backend)
    ic = torch.from_numpy(_smooth_ic(cfg))
    src = torch.zeros(cfg.grid_shape)
    with torch.no_grad():
        target = tadj.make_rollout(cfg, STEPS, device=CPU)(
            0.9 * ic if wrt == "ic" else ic, src)
    if wrt == "src":
        target = 0.5 * target
    loss = tadj.final_state_misfit(cfg, target, STEPS, device=CPU)
    _, grad = tadj.loss_and_grad(loss, wrt=wrt, device=CPU)(ic, src)
    rng = np.random.default_rng(1)
    d = torch.from_numpy(rng.standard_normal(grad.shape).astype(np.float32))
    d = d / torch.linalg.vector_norm(d)
    ad = float(torch.sum(grad * d))
    base = ic if wrt == "ic" else src
    eps = 1e-3 * max(float(base.abs().max()), 1e-3)
    with torch.no_grad():
        if wrt == "ic":
            lp, lm = loss(ic + eps * d, src), loss(ic - eps * d, src)
        else:
            lp, lm = loss(ic, src + eps * d), loss(ic, src - eps * d)
    fd = (float(lp) - float(lm)) / (2 * eps)
    assert fd != 0.0
    assert abs(ad - fd) <= 5e-2 * max(abs(fd), abs(ad)), (ad, fd)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_segmented_rollout_matches_unsegmented(backend):
    cfg = _cfg(dt=3.0, nu=6.5, fft_backend=backend)
    ic = torch.from_numpy(_smooth_ic(cfg))
    src = torch.zeros(cfg.grid_shape)
    with torch.no_grad():
        outs = [tadj.make_rollout(cfg, 5, segment=s, device=CPU)(ic, src)
                for s in (1, 2, 5)]                # 2: 2 * 2 + 1
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=0,
                                   atol=1e-7)
    target = 0.9 * outs[0]
    grads = [tadj.loss_and_grad(tadj.final_state_misfit(
        cfg, target, 5, segment=s, device=CPU), device=CPU)(ic, src)[1]
        .numpy() for s in (1, 2, 5)]
    for g in grads[1:]:
        np.testing.assert_allclose(g, grads[0], rtol=1e-4, atol=1e-12)


def test_both_controls_and_the_tracer_pair():
    """wrt="both" gives (grad_ic, grad_src), each as wrt alone; a tracer
    IC gives a pair, and the q0 gradient flows."""
    cfg = _cfg(nx=32, dt=3.0)
    ic = _smooth_ic(cfg)
    src = np.zeros(cfg.grid_shape, np.float32)
    with torch.no_grad():
        target = 0.5 * tadj.make_rollout(cfg, 2, device=CPU)(ic, src)
    loss = tadj.final_state_misfit(cfg, target, 2, device=CPU)
    v, (g_ic, g_src) = tadj.loss_and_grad(loss, "both", device=CPU)(ic, src)
    assert torch.equal(g_ic, tadj.loss_and_grad(loss, "ic", device=CPU)(
        ic, src)[1])
    assert torch.equal(g_src, tadj.loss_and_grad(loss, "src", device=CPU)(
        ic, src)[1])
    tr_ic = (ic, np.abs(ic))
    with torch.no_grad():
        tgt = tadj.make_rollout(cfg, 2, "tracer", device=CPU)(
            (0.9 * ic, 0.8 * np.abs(ic)), src)
    loss = tadj.final_state_misfit(cfg, tgt, 2, "tracer", device=CPU)
    _, g = tadj.loss_and_grad(loss, device=CPU)(tr_ic, src)
    assert isinstance(g, tuple) and len(g) == 2
    assert all(bool(torch.isfinite(a).all()) for a in g)
    assert float(g[1].abs().max()) > 0
    with pytest.raises(ValueError, match="wrt"):
        tadj.loss_and_grad(loss, "state")


def _twin(cfg, n):
    truth = (0.1 * gaussian(cfg)).astype(np.float32)     # peak zeta 1e-4
    with torch.no_grad():
        target = tadj.make_rollout(cfg, n, device=CPU)(
            truth, np.zeros(cfg.grid_shape, np.float32)).numpy()
    return truth, target


def test_fit_initial_condition_recovers_truth():
    """The 32² twin problem of tests/test_adjoint.py:193-208: Adam from
    half the truth; the cost history has iters + 1 entries."""
    cfg = _cfg(nx=32, dt=3.0, nu=6.5)
    truth, target = _twin(cfg, 6)
    guess = 0.5 * truth
    ic, losses = tadj.fit_initial_condition(cfg, target, 6, guess,
                                            iters=80, learning_rate=1e-5,
                                            device=CPU)
    assert losses.shape == (81,)
    assert losses[-1] < 1e-2 * losses[0], losses[[0, -1]]
    e0 = np.linalg.norm(guess - truth)
    assert np.linalg.norm(ic.numpy() - truth) < 0.2 * e0


def test_assimilate_cli_on_the_cpu(tmp_path):
    """xfb-torch-assimilate --device cpu: target and corrupted guess
    files -> the recovered IC file and its cost history
    (tests/test_adjoint.py:165-190)."""
    from xlab_fftbarotropic_torch.cli import assimilate
    from xlab_fftbarotropic_torch.io.fieldio import read_field, write_field

    cfg = _cfg(nx=32, dt=3.0, nu=6.5)
    truth, target = _twin(cfg, 5)
    write_field(tmp_path / "target.bin", target)
    write_field(tmp_path / "guess.bin", 0.5 * truth)
    rc = assimilate.main([
        "--nx", "32", "--ny", "32", "--lx", "600000", "--ly", "600000",
        "--dt", "3.0", "--nu", "6.5", "--target",
        str(tmp_path / "target.bin"), "--guess", str(tmp_path / "guess.bin"),
        "--out", str(tmp_path / "recovered.bin"), "--steps", "5", "--iters",
        "60", "--lr", "1e-5", "--device", "cpu"])
    assert rc == 0
    rec = read_field(tmp_path / "recovered.bin", cfg.grid_shape)
    losses = np.loadtxt(tmp_path / "recovered.bin.loss.txt")
    assert losses.shape == (61,)
    assert losses[-1] < 1e-2 * losses[0]
    assert (np.linalg.norm(rec - truth)
            < 0.2 * np.linalg.norm(0.5 * truth - truth))


def test_what_is_not_ported_raises(tmp_path):
    from xlab_fftbarotropic_torch.cli import assimilate

    with pytest.raises(NotImplementedError, match="item 5"):
        tadj.make_sharded_rollout(_cfg(), 3, None)
    with pytest.raises(NotImplementedError, match="beta-plane"):
        tadj.make_rollout(_cfg(beta=1e-11), 3, "sw", device=CPU)
    with pytest.raises(ValueError, match="model_kind"):
        tadj.make_rollout(_cfg(), 3, "ensemble", device=CPU)
    with pytest.raises(SystemExit):
        assimilate.main(["--target", "t", "--guess", "g", "--out", "o",
                         "--steps", "2", "--fast-transforms", "--device",
                         "cpu"])
