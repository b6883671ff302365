"""The sharded models over 4 torch.distributed ranks on the CPU (gloo;
tests/torch_multihost_worker.py models, one spawn of 4 processes for
every case): each family (barotropic, shallow water, tracer) on slab and
x-pencil under each impl (the library collectives, and the plain
versions of the a2a and xstage kernels on the /dev/shm exchange buffers'
pointer tables) and on the 2x2 pencil (xla), RK4 for 3 steps at 32^2;
ETDRK4 for 2 steps on one impl a family; slab and x-pencil on
make_mesh2d((2, 2)); the overlap slab in fast mode at 64^2. Each rank's
gathered state is bit for bit the stacked one-process port model of the
same decomposition and impl at P = 4, and within rel-L2 1e-6 of the JAX
package's sharded model (slab, xla) on 4 of the 8 virtual CPU devices
from the same numpy-seeded initial fields (SW: zeta and eta rel-L2, div
within 1e-6 of max |zeta|, as tests/test_torch_shard_sw.py; fast mode:
within the fast class, 1e-4, of the strict JAX run). Also the refusals:
the pencil with a kernel impl, more ranks than the kernels' pointer
table holds, a kernel impl over ranks on more than one host; and
make_sharded_rollout, which runs over ranks and returns the rank's
shard."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_multihost_worker as worker
from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig
from xlab_fftbarotropic_tpu.parallel import model as jmodel
from xlab_fftbarotropic_torch.parallel import make_mesh, make_mesh2d
from torch_threads import _one_thread  # noqa: F401

NS = 4
TOL = 1e-6
FAST_TOL = 1e-4
NAMES = [worker.case_name(c) for c in worker.CASES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' run of every case: name -> its JSON line, and the
    refusals' line."""
    d = tmp_path_factory.mktemp("ranks")
    outs = worker.launch(NS, ["models", d], timeout=300)
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{err[-4000:]}"
        assert f"DONE {rank}" in out
    got = {}
    for line in worker.lines(outs[0][1]):
        got[line.get("case", "refusals")] = line
    return got


def _stacked(case) -> np.ndarray:
    family, decomp, impl, scheme, shape, fast = case
    cfg = worker.config(scheme, worker.grid(case))
    mesh = (make_mesh2d((2, 2), "cpu") if shape == "2d"
            else make_mesh(NS, "cpu"))
    m = worker.build(family, cfg, mesh, impl, decomp, fast)
    s = m.segment(worker.initial_state(m, family), m.zero_source(),
                  worker.STEPS[scheme])
    return worker.packed(m, family, s)


@pytest.fixture(scope="module")
def jax_runs():
    """(family, scheme, n) -> the JAX sharded model's packed state (slab,
    xla) from the worker's initial fields."""
    mesh = Mesh(np.array(jax.devices()[:NS]), ("x",))
    cache = {}

    def run(family, scheme, n):
        key = (family, scheme, n)
        if key not in cache:
            c = worker.config(scheme, n)
            cfg = JConfig(nx=n, ny=n, time_scheme=scheme, dt=c.dt,
                          r_drag=c.r_drag)
            fields = worker.initial_fields(family, n)
            kw = dict(fft_impl="xla", decomp="slab")
            if family == "sw":
                m = jmodel.ShardedShallowWaterModel.build(cfg, mesh, **kw)
                s0 = m.geostrophic_init(fields[0])
            elif family == "tracer":
                m = jmodel.ShardedTracerModel.build(cfg, mesh,
                                                    kappa=worker.KAPPA, **kw)
                s0 = m.init_state(*fields)
            else:
                m = jmodel.ShardedBarotropicModel.build(cfg, mesh, **kw)
                s0 = m.init_state(fields[0])
            s = m.segment(s0, m.zero_source(), worker.STEPS[scheme])
            cache[key] = (np.asarray(m.unshard_spectral(s))
                          if family == "barotropic" else
                          np.stack([np.asarray(a)
                                    for a in m.unshard_state(s)]))
        return cache[key]

    return run


def _phys(a: np.ndarray, n: int) -> np.ndarray:
    return np.fft.irfft2(np.asarray(a, np.complex128), s=(n, n))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _errors(family: str, got: np.ndarray, want: np.ndarray, n: int
            ) -> dict:
    """Physical errors: rel-L2 of each field (SW div: max abs over
    max |zeta|)."""
    if family == "barotropic":
        return {"zeta": _rel(_phys(got, n), _phys(want, n))}
    g = [_phys(a, n) for a in got]
    w = [_phys(a, n) for a in want]
    if family == "tracer":
        return {"zeta": _rel(g[0], w[0]), "q": _rel(g[1], w[1])}
    return {"zeta": _rel(g[0], w[0]), "eta": _rel(g[2], w[2]),
            "div": float(np.abs(g[1] - w[1]).max() / np.abs(w[0]).max())}


@pytest.mark.parametrize("case", worker.CASES, ids=NAMES)
def test_ranks_match_the_stacked_model_and_jax(ranks, jax_runs, case):
    family, decomp, impl, scheme, shape, fast = case
    line = ranks[worker.case_name(case)]
    got = np.load(line["path"])
    # the rank's local layout: a leading shard axis of 1
    assert line["shape"][0] == 1
    if impl == "xla":
        assert line["barriers"] == 0
    else:
        # two host barriers an exchange: the transforms of every step
        assert line["barriers"] > 0 and line["barriers"] % 2 == 0
    want = _stacked(case)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want), (
        f"not bit for bit the stacked model: max |d| "
        f"{np.abs(got - want).max():.3e} of {np.abs(want).max():.3e}")
    n = worker.grid(case)
    errs = _errors(family, got, jax_runs(family, scheme, n), n)
    bar = FAST_TOL if fast else TOL
    assert max(errs.values()) <= bar, errs


def test_tuple_axis_groups_are_the_flattened_ones(ranks):
    """make_mesh2d((2, 2)) places slab and x-pencil over the flattened
    pair: bit for bit the 1-D group of 4 ranks."""
    for decomp, impl in (("slab", "xla"), ("xpencil", "pallas")):
        two = np.load(ranks[f"barotropic-{decomp}-{impl}-rk4-2d"]["path"])
        one = np.load(ranks[f"barotropic-{decomp}-{impl}-rk4-1d"]["path"])
        assert np.array_equal(two, one)


def test_refusals(ranks):
    got = ranks["refusals"]["refusals"]
    assert got["pencil-pallas"].startswith("ValueError") and (
        "fft_impl='xla' only" in got["pencil-pallas"])
    # make_sharded_rollout builds over ranks: the rank's shard of the
    # final vorticity (tests/test_torch_multihost_rollout.py)
    assert got["rollout"] == [1, worker.N // NS, worker.N]
    assert got["max-shards"].startswith("ValueError") and (
        "kMaxShards" in got["max-shards"])
    assert got["hosts"].startswith("ValueError") and (
        "on 2 hosts" in got["hosts"] and "fft_impl='xla'" in got["hosts"])
