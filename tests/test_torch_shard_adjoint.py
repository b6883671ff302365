"""The port's sharded differentiable rollout (adjoint.make_sharded_rollout:
the barotropic RK4 loop on the stacked shards of a shard group, the
library transposes and torch.fft under autograd), on the CPU, slab and
x-pencil, 3 steps at 32^2 on 4 shards: its output against the JAX
package's make_sharded_rollout on 4 of the 8 virtual CPU devices (rel-L2
<= 1e-6), and the gradient of a final-state misfit in both arguments
against the port's single-device make_rollout gradient, within 1e-5 of
its largest entry (the JAX package holds its own sharded gradient at
1e-4, tests/test_adjoint.py:133-162); segments and the pencil's refusal
on a 1-D group."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from xlab_fftbarotropic_tpu import adjoint as jadj
from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig
from xlab_fftbarotropic_torch import adjoint as tadj
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.parallel import make_mesh
from torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")
NS, N, STEPS = 4, 32, 3
DECOMPS = ["slab", "xpencil"]
KW = dict(nx=N, ny=N, dt=3.0, nu=6.5, r_drag=2e-5, beta=1.6e-11)


def _inputs():
    rng = np.random.default_rng(5)
    x = np.arange(N) / N
    smooth = (np.sin(2 * np.pi * x)[:, None] * np.cos(4 * np.pi * x)[None]
              + 0.1 * rng.standard_normal((N, N)))
    return ((1e-4 * smooth).astype(np.float32),
            (1e-9 * rng.standard_normal((N, N))).astype(np.float32))


@pytest.fixture(scope="module")
def jax_out():
    mesh = Mesh(np.array(jax.devices()[:NS]), ("x",))
    v0, src = _inputs()
    return {d: np.asarray(jadj.make_sharded_rollout(
        JConfig(**KW), STEPS, mesh, decomp=d)(jnp.asarray(v0),
                                              jnp.asarray(src)))
            for d in DECOMPS}


def _grads(roll, target):
    v0, src = (torch.from_numpy(a).requires_grad_(True) for a in _inputs())
    out = roll(v0, src)
    loss = 0.5 * torch.mean(torch.square(out - target))
    loss.backward()
    return out.detach(), v0.grad, src.grad


@pytest.mark.parametrize("decomp", DECOMPS)
def test_forward_matches_jax_and_gradient_matches_single_device(
        jax_out, decomp):
    cfg = ModelConfig(**KW)
    roll = tadj.make_sharded_rollout(cfg, STEPS, make_mesh(NS, CPU), decomp)
    v0, src = (torch.from_numpy(a) for a in _inputs())
    out = roll(v0, src)
    assert out.shape == (N, N) and out.dtype == torch.float32
    want = jax_out[decomp]
    assert (np.linalg.norm(out.numpy() - want) / np.linalg.norm(want)
            <= 1e-6)
    target = 0.9 * out
    single = _grads(tadj.make_rollout(cfg, STEPS, device=CPU), target)
    got = _grads(roll, target)
    for a, b in zip(got, single):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_segments_and_one_shard_give_the_same_gradient():
    cfg = ModelConfig(**KW)
    target = torch.zeros(N, N)
    g = [_grads(tadj.make_sharded_rollout(cfg, STEPS, make_mesh(p, CPU),
                                          segment=s), target)
         for p, s in ((NS, 1), (NS, 3), (1, None))]
    for other in g[1:]:
        for a, b in zip(other, g[0]):
            assert float((a - b).abs().max()) <= 1e-6 * float(
                b.abs().max())


def test_pencil_is_refused():
    """On a 1-D group, as in the JAX package (the pencil's rollout on a
    2-D group: tests/test_torch_pencil_run.py); slab and x-pencil on a
    stacked 2-D group run over the flattened pair (the JAX make_mesh2d),
    the 1-D group's rollout bit for bit (over ranks:
    tests/test_torch_multihost_rollout.py)."""
    from xlab_fftbarotropic_torch.parallel.pencil import make_pencil_mesh

    with pytest.raises(ValueError, match="needs a 2-D mesh"):
        tadj.make_sharded_rollout(ModelConfig(**KW), STEPS,
                                  make_mesh(NS, CPU), decomp="pencil")
    rng = np.random.default_rng(5)
    v0, src = (torch.from_numpy(rng.standard_normal((N, N)).astype(
        np.float32) * s) for s in (1e-5, 1e-9))
    for decomp in DECOMPS:
        got, want = (tadj.make_sharded_rollout(ModelConfig(**KW), STEPS, g,
                                               decomp=decomp)(v0, src)
                     for g in (make_pencil_mesh((2, 2), CPU),
                               make_mesh(NS, CPU)))
        assert torch.equal(got, want)
