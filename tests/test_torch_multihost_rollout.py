"""adjoint.make_sharded_rollout over 4 torch.distributed ranks on the CPU
(gloo; tests/torch_multihost_worker.py rollout, one spawn of 4 processes
for every case): the slab and the x-pencil on make_mesh(None), the 2-D
pencil on make_pencil_mesh((2, 2)), 3 steps at 32^2. Each rank takes its
shard of the global inputs and returns its shard of the final vorticity;
the loss is each rank's part of the half mean-square misfit, and every
rank runs backward together (the transposes' collectives and the
checkpointed segments' recomputation inside the backward sweep).

For each decomposition: the gathered value bit for bit the stacked
rollout's at P = 4 and within rel-L2 1e-6 of the JAX package's
make_sharded_rollout on 4 of the 8 virtual CPU devices; the gathered
gradients (wrt the initial vorticity, the source and both; the default
segments, 2 and a remainder of 1, and segment=1) bit for bit the stacked
rollout's (the CPU's ranks run the stacked shards' transforms, dfft.fft_x
in both sweeps), each rank's gradient zero off its own rows or tile; and
the gradients within 1e-4 of their max of the JAX gradients
(tests/test_adjoint.py:155-163's bar). Also the adjoint identity of
multihost.all_to_all over the 4 ranks, exact on integer-valued float32
and complex64: its backward is the permutation back."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_multihost_worker as worker
from xlab_fftbarotropic_tpu import adjoint as jadj
from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig
from xlab_fftbarotropic_tpu.parallel import pencil as jpencil
from xlab_fftbarotropic_tpu.parallel.model import make_mesh as jmake_mesh
from xlab_fftbarotropic_torch import adjoint
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.parallel import make_mesh
from xlab_fftbarotropic_torch.parallel.pencil import make_pencil_mesh
from torch_threads import _one_thread  # noqa: F401

NS = 4
TOL = 1e-6
JAX_GRAD_TOL = 1e-4
DECOMPS = ("slab", "xpencil", "pencil")
NAMES = [worker.rollout_name(c) for c in worker.ROLLOUT_CASES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' run of every case: name -> its JSON line."""
    d = tmp_path_factory.mktemp("rollout")
    outs = worker.launch(NS, ["rollout", d], timeout=300)
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{err[-4000:]}"
        assert f"DONE {rank}" in out
    return {line["case"]: line for line in worker.lines(outs[0][1])}


def _mesh(decomp):
    return (make_pencil_mesh((2, 2), "cpu") if decomp == "pencil"
            else make_mesh(NS, "cpu"))


def _stacked(case) -> dict:
    """The stacked rollout's value and gradients of the summed misfit."""
    decomp, wrt, segment = case
    v0, src, target = (torch.from_numpy(a) for a in worker.rollout_inputs())
    roll = adjoint.make_sharded_rollout(ModelConfig(**worker.ROLLOUT_KW),
                                        worker.ROLLOUT_STEPS, _mesh(decomp),
                                        decomp, segment)
    x, s = (a.clone().requires_grad_(wrt in (w, "both"))
            for a, w in ((v0, "ic"), (src, "src")))
    out = roll(x, s)
    inputs = [a for a in (x, s) if a.requires_grad]
    grads = torch.autograd.grad(worker.misfit(out, target), inputs)
    got = {"value": out.detach().numpy()}
    for a, g in zip(inputs, grads):
        got["grad_ic" if a is x else "grad_src"] = g.numpy()
    return got


@pytest.fixture(scope="module")
def jax_runs():
    """decomp -> the JAX make_sharded_rollout's value and gradients (wrt
    both inputs) of the same misfit on 4 virtual CPU devices."""
    v0, src, target = (jnp.asarray(a) for a in worker.rollout_inputs())
    cache = {}

    def run(decomp):
        if decomp not in cache:
            devs = jax.devices()[:NS]
            mesh = (jpencil.make_pencil_mesh((2, 2), devs)
                    if decomp == "pencil" else jmake_mesh(devs))
            roll = jadj.make_sharded_rollout(
                JConfig(**worker.ROLLOUT_KW), worker.ROLLOUT_STEPS, mesh,
                decomp=decomp)

            def loss(v, s):
                n = worker.N * worker.N
                return 0.5 * jnp.sum(jnp.square(roll(v, s) - target)) / n

            g_ic, g_src = jax.grad(loss, argnums=(0, 1))(v0, src)
            cache[decomp] = {"value": np.asarray(roll(v0, src)),
                             "grad_ic": np.asarray(g_ic),
                             "grad_src": np.asarray(g_src)}
        return cache[decomp]

    return run


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("case", worker.ROLLOUT_CASES, ids=NAMES)
def test_ranks_match_the_stacked_rollout(ranks, case):
    decomp, wrt, _ = case
    line = ranks[worker.rollout_name(case)]
    n = worker.N
    # the rank's shard of the final vorticity, a leading axis of 1
    assert line["shape"] == ([1, n // 2, n // 2] if decomp == "pencil"
                             else [1, n // NS, n])
    # each rank's gradient lives on its own rows or tile only
    assert line["off_shard_zero"] == [True] * NS
    want = _stacked(case)
    keys = {"ic": ["grad_ic"], "src": ["grad_src"],
            "both": ["grad_ic", "grad_src"]}[wrt]
    assert sorted(line["paths"]) == sorted(["value"] + keys)
    for what, path in line["paths"].items():
        got = np.load(path)
        assert got.dtype == np.float32 and got.shape == (n, n)
        assert np.isfinite(got).all() and np.abs(got).max() > 0
        assert _rel(got, want[what]) <= TOL, (what, _rel(got, want[what]))
        assert np.array_equal(got, want[what]), (
            f"{what} not bit for bit the stacked rollout's: rel-L2 "
            f"{_rel(got, want[what]):.3e}")


@pytest.mark.parametrize("decomp", DECOMPS)
def test_ranks_match_the_jax_rollout(ranks, jax_runs, decomp):
    line = ranks[worker.rollout_name((decomp, "both", None))]
    want = jax_runs(decomp)
    value = np.load(line["paths"]["value"])
    assert _rel(value, want["value"]) <= TOL
    for what in ("grad_ic", "grad_src"):
        got, ref = np.load(line["paths"][what]), want[what]
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        assert err <= JAX_GRAD_TOL, (what, err)


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_all_to_all_is_its_own_adjoint(ranks, dtype):
    line = ranks[f"a2a-{dtype}"]
    # sum over ranks of <a2a(x), y> == of <x, a2a^T(y)>, exactly
    assert line["lhs"] == line["rhs"] and line["lhs"] != 0.0
    assert line["permutation"]
    assert line["grad_dtype"] == f"torch.{dtype}"
