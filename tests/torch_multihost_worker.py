"""One rank of the port's multi-process CPU tests
(tests/test_torch_multihost*.py): started once per rank with the
XFB_COORDINATOR, XFB_NUM_PROCESSES and XFB_PROCESS_ID contract, it brings
up torch.distributed (gloo) through parallel/multihost.py, runs every case
of its mode and prints one JSON line per case (rank 0), then `DONE <rank>`.
It imports no jax and runs torch on one intra-op thread.

    python tests/torch_multihost_worker.py smoke WORKDIR
    python tests/torch_multihost_worker.py models WORKDIR
    python tests/torch_multihost_worker.py rollout WORKDIR
    python tests/torch_multihost_worker.py cli WORKDIR -- ARGS...

smoke   is_primary, gather_to_host, the /dev/shm exchange buffers (each
        rank's written source read by its peers through the pointer
        table, the names gone once mapped) and the ranked a2a plain
        versions against the stacked ones;
models  every case of CASES: the sharded model of a family, decomposition
        and impl over the ranks from the numpy-seeded initial state of
        initial_fields, its global state after the steps saved by rank 0
        as WORKDIR/<case>.npy (the JSON line says where), and the
        refusals (the two-host one with the ranks' host count set to 2);
rollout adjoint.make_sharded_rollout over the ranks, every case of
        ROLLOUT_CASES: the gathered final vorticity and gradients of the
        summed final-state misfit saved by rank 0 as
        WORKDIR/<case>-<what>.npy, whether each rank's gradient is zero
        off its own shard; and the adjoint identity of
        multihost.all_to_all on integer-valued float32 and complex64;
cli     xlab_fftbarotropic_torch.cli.run.main(ARGS) on every rank.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from xlab_fftbarotropic_torch import convert
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.ic import makefields
from xlab_fftbarotropic_torch.parallel import (
    ShardedBarotropicModel, ShardedShallowWaterModel, ShardedTracerModel,
    make_mesh, make_mesh2d, multihost)

REPO = Path(__file__).resolve().parents[1]

N = 32
SEED = 7
STEPS = {"rk4": 3, "etdrk4": 2}
FAMILIES = ("barotropic", "sw", "tracer")
KAPPA = 50.0
# (family, decomp, impl, scheme, mesh, fast): every family on slab and
# x-pencil under each impl and the pencil on 2x2, RK4; ETDRK4 on one impl
# a family; the slab and x-pencil on make_mesh2d((2, 2)); one fast case
CASES = ([(f, d, i, "rk4", "1d", False) for f in FAMILIES
          for d in ("slab", "xpencil") for i in ("xla", "pallas", "overlap")]
         + [(f, "pencil", "xla", "rk4", "2d", False) for f in FAMILIES]
         + [("barotropic", "slab", "overlap", "etdrk4", "1d", False),
            ("sw", "xpencil", "pallas", "etdrk4", "1d", False),
            ("tracer", "xpencil", "overlap", "etdrk4", "1d", False),
            ("barotropic", "slab", "xla", "rk4", "2d", False),
            ("barotropic", "xpencil", "pallas", "rk4", "2d", False),
            ("barotropic", "slab", "overlap", "rk4", "1d", True)])


# make_sharded_rollout over the ranks: (decomp, wrt, segment), 3 steps at
# N^2 from rollout_inputs (segment None: round(sqrt(3)) = 2 and a
# remainder of 1)
ROLLOUT_STEPS = 3
ROLLOUT_KW = dict(nx=N, ny=N, dt=3.0, nu=6.5, r_drag=2e-5, beta=1.6e-11)
ROLLOUT_CASES = [(d, w, s) for d in ("slab", "xpencil", "pencil")
                 for w, s in (("ic", None), ("src", None), ("both", None),
                              ("both", 1))]


def rollout_name(case) -> str:
    decomp, wrt, segment = case
    return f"{decomp}-{wrt}-seg{segment or 'auto'}"


def rollout_inputs() -> tuple:
    """The numpy-seeded (vort0, src, target) of the rollout cases."""
    rng = np.random.default_rng(5)
    x = np.arange(N) / N
    smooth = (np.sin(2 * np.pi * x)[:, None] * np.cos(4 * np.pi * x)[None]
              + 0.1 * rng.standard_normal((N, N)))
    v0 = (1e-4 * smooth).astype(np.float32)
    src = (1e-9 * rng.standard_normal((N, N))).astype(np.float32)
    target = (0.9 * v0 + 1e-6 * rng.standard_normal((N, N))).astype(
        np.float32)
    return v0, src, target


def misfit(out, target) -> "torch.Tensor":
    """Half the squared misfit over the global point count: on a rank's
    shard, its part of the stacked rollout's misfit (the ranks' sum)."""
    return 0.5 * torch.sum(torch.square(out - target)) / (N * N)


def case_name(case) -> str:
    family, decomp, impl, scheme, mesh, fast = case
    return (f"{family}-{decomp}-{impl}-{scheme}-{mesh}"
            + ("-fast" if fast else ""))


def grid(case) -> int:
    """The case's grid: N, or 64 in fast mode (the fast tile's shortest
    length)."""
    return 64 if case[-1] else N


def config(scheme: str, n: int = N) -> ModelConfig:
    return ModelConfig(nx=n, ny=n, time_scheme=scheme,
                       dt=3.0 if scheme == "rk4" else 20.0,
                       r_drag=2e-5 if scheme == "rk4" else 0.0)


def initial_fields(family: str, n: int = N) -> tuple:
    """The numpy-seeded physical initial fields of a family: a gaussian
    vortex with seeded noise, and for the tracer a seeded q."""
    cfg = config("rk4", n)
    rng = np.random.default_rng(SEED)
    zeta0 = 1e-5 if family == "sw" else 1e-4
    vort = np.asarray(makefields.gaussian(cfg, zeta0=zeta0), np.float32)
    vort = (vort + 0.05 * zeta0 * rng.standard_normal(vort.shape)
            ).astype(np.float32)
    if family != "tracer":
        return (vort,)
    q = rng.standard_normal(vort.shape).astype(np.float32)
    return vort, q


def build(family: str, cfg, mesh, impl: str, decomp: str, fast: bool):
    kw = dict(fft_impl=impl, decomp=decomp, fast=fast)
    if family == "sw":
        return ShardedShallowWaterModel.build(cfg, mesh, **kw)
    if family == "tracer":
        return ShardedTracerModel.build(cfg, mesh, kappa=KAPPA, **kw)
    return ShardedBarotropicModel.build(cfg, mesh, **kw)


def initial_state(model, family: str):
    fields = initial_fields(family, model.cfg.nx)
    if family == "sw":
        return model.geostrophic_init(fields[0])
    return model.init_state(*fields)


def packed(model, family: str, state) -> np.ndarray:
    """The global state (a gather on every rank), as the runner packs it."""
    if family == "sw":
        return convert.sw_state_to_numpy(model.unshard_state(state))
    if family == "tracer":
        return convert.tracer_state_to_numpy(model.unshard_state(state))
    return model.unshard_spectral(state).cpu().numpy()


def say(**kw) -> None:
    if multihost.is_primary():
        print(json.dumps(kw), flush=True)


def run_models(workdir: Path) -> None:
    rank = multihost.rank()
    for case in CASES:
        family, decomp, impl, scheme, shape, fast = case
        cfg = config(scheme, grid(case))
        mesh = (make_mesh2d((2, 2), "cpu") if shape == "2d"
                else make_mesh(None, "cpu"))
        m = build(family, cfg, mesh, impl, decomp, fast)
        assert m.mesh.rank == rank and m.mesh.local_shards == 1
        s = m.segment(initial_state(m, family), m.zero_source(),
                      STEPS[scheme])
        out = packed(m, family, s)
        path = workdir / f"{case_name(case)}.npy"
        if multihost.is_primary():
            np.save(path, out)
        barriers = m.exchange.stats["barriers"] if m.exchange else 0
        say(case=case_name(case), path=str(path), barriers=barriers,
            shape=list(m.spectral_shape))
    refusals(workdir)


def refusals(workdir: Path) -> None:
    """What the ranks refuse, each a JSON line with the error's text."""
    from xlab_fftbarotropic_torch import adjoint
    from xlab_fftbarotropic_torch.parallel import fused_transpose

    cfg = config("rk4")
    got = {}
    tries = {
        "pencil-pallas": lambda: build("barotropic", cfg,
                                       make_mesh2d((2, 2), "cpu"),
                                       "pallas", "pencil", False),
    }
    cap = fused_transpose.MAX_SHARDS
    hosts = multihost._STATE["hosts"]

    def capped():
        fused_transpose.MAX_SHARDS = multihost.world_size() - 1
        build("barotropic", cfg, make_mesh(None, "cpu"), "overlap", "slab",
              False)

    def two_hosts():
        # the ranks as if on two hosts: no peer mapping reaches across
        multihost._STATE["hosts"] = 2
        build("barotropic", cfg, make_mesh(None, "cpu"), "pallas",
              "xpencil", False)

    tries.update({"max-shards": capped, "hosts": two_hosts})
    # the rollout over ranks runs: the rank's shard of the final vorticity
    got["rollout"] = list(adjoint.make_sharded_rollout(
        cfg, 2, make_mesh(None, "cpu"))(*rollout_inputs()[:2]).shape)
    for name, fn in tries.items():
        try:
            fn()
            got[name] = None
        except (ValueError, NotImplementedError) as e:
            got[name] = f"{type(e).__name__}: {e}"
        finally:
            fused_transpose.MAX_SHARDS = cap
            multihost._STATE["hosts"] = hosts
    say(refusals=got)


def _rollout_mesh(decomp: str):
    from xlab_fftbarotropic_torch.parallel.pencil import make_pencil_mesh

    return (make_pencil_mesh((2, 2), "cpu") if decomp == "pencil"
            else make_mesh(None, "cpu"))


def _own(a: torch.Tensor, decomp: str, rank: int) -> torch.Tensor:
    """The rank's shard (1, ...) of a global (N, N) field."""
    from xlab_fftbarotropic_torch.parallel import dfft, pencil

    s = (pencil.shard_tiles(a, (2, 2)) if decomp == "pencil"
         else dfft.shard_rows(a, multihost.world_size()))
    return s[rank:rank + 1]


def _unshard(a: torch.Tensor, decomp: str) -> torch.Tensor:
    from xlab_fftbarotropic_torch.parallel import dfft, pencil

    return (pencil.unshard_tiles(a, (2, 2)) if decomp == "pencil"
            else dfft.unshard_rows(a))


def run_rollout(workdir: Path) -> None:
    from xlab_fftbarotropic_torch import adjoint

    rank = multihost.rank()
    cfg = ModelConfig(**ROLLOUT_KW)
    v0, src, target = (torch.from_numpy(a) for a in rollout_inputs())
    for case in ROLLOUT_CASES:
        decomp, wrt, segment = case
        roll = adjoint.make_sharded_rollout(cfg, ROLLOUT_STEPS,
                                            _rollout_mesh(decomp), decomp,
                                            segment)
        x, s = (a.clone().requires_grad_(wrt in (w, "both"))
                for a, w in ((v0, "ic"), (src, "src")))
        out = roll(x, s)
        loss = misfit(out, _own(target, decomp, rank))
        inputs = [a for a in (x, s) if a.requires_grad]
        grads = torch.autograd.grad(loss, inputs)
        saved = {"value": out.detach()}
        off_zero = True
        for a, g in zip(inputs, grads):
            mine = _own(g, decomp, rank)
            off_zero &= int(torch.count_nonzero(g)) == int(
                torch.count_nonzero(mine))
            saved["grad_ic" if a is x else "grad_src"] = mine
        paths = {}
        for what, a in saved.items():
            full = _unshard(multihost.gather_to_host(a), decomp).numpy()
            paths[what] = str(workdir / f"{rollout_name(case)}-{what}.npy")
            if multihost.is_primary():
                np.save(paths[what], full)
        zeros = [None] * multihost.world_size()
        torch.distributed.all_gather_object(zeros, off_zero)
        say(case=rollout_name(case), paths=paths, shape=list(out.shape),
            off_shard_zero=zeros)
    a2a_identity()


def a2a_identity() -> None:
    """multihost.all_to_all's backward is its transpose: for integer-valued
    x and y (every product and sum exact) the ranks' summed <a2a(x), y>
    equals their summed <x, a2a^T(y)>, and a2a^T(y) is the permutation
    back (rank j's chunk r is rank r's chunk j of y)."""
    rank, n = multihost.rank(), multihost.world_size()
    for dtype in (torch.float32, torch.complex64):
        rng = np.random.default_rng(100 + rank)

        def draw():
            a = rng.integers(-8, 9, (n, 3, 5)).astype(np.float32)
            if dtype.is_complex:
                a = a + 1j * rng.integers(-8, 9, (n, 3, 5))
            return torch.from_numpy(a).to(dtype)

        x, y = draw().requires_grad_(True), draw()
        out = multihost.all_to_all(x)
        (back,) = torch.autograd.grad(out, x, grad_outputs=y)
        lhs = torch.sum(out.detach().conj() * y).real.double()
        rhs = torch.sum(x.detach().conj() * back).real.double()
        sums = torch.stack([lhs, rhs])
        torch.distributed.all_reduce(sums)
        ys = multihost.gather_to_host(y[None])
        backs = multihost.gather_to_host(back[None])
        perm = all(torch.equal(backs[j, r], ys[r, j])
                   for j in range(n) for r in range(n))
        say(case=f"a2a-{str(dtype).split('.')[-1]}", lhs=float(sums[0]),
            rhs=float(sums[1]), permutation=perm,
            grad_dtype=str(back.dtype))


def run_smoke(workdir: Path) -> None:
    from xlab_fftbarotropic_torch.parallel import fused_transpose as ft
    from xlab_fftbarotropic_torch.parallel import peer

    rank, n = multihost.rank(), multihost.world_size()
    flags = [None] * n
    torch.distributed.all_gather_object(flags, multihost.is_primary())
    say(case="is_primary", flags=flags)
    x = torch.arange(6, dtype=torch.float32).reshape(1, 2, 3) + 100 * rank
    g = multihost.gather_to_host(x)
    want = torch.cat([torch.arange(6, dtype=torch.float32).reshape(1, 2, 3)
                      + 100 * r for r in range(n)])
    z = torch.complex(x, -x)
    gz = multihost.gather_to_host(z)
    say(case="gather", exact=bool(torch.equal(g, want)),
        complex_exact=bool(torch.equal(gz, torch.complex(want, -want))),
        shape=list(g.shape))
    mesh = make_mesh(None, "cpu")
    rows_l, hny = 4, 5
    w = -(-hny // n)
    ex = peer.Exchange(mesh, {"rows": (rows_l, hny), "cols": (n * rows_l,
                                                              w)})
    # each rank unlinks its own names once every rank has mapped them;
    # wait for every rank to have done so before looking
    torch.distributed.barrier()
    left = sorted(p.name for p in peer.SHM_DIR.glob(f"{ex.tag}*"))
    mine = torch.complex(torch.full((1, rows_l, hny), float(rank + 1)),
                         torch.full((1, rows_l, hny), -float(rank)))
    ex.put("rows", mine)
    seen = [float(v[0, 0, 0].real) for v in ex.views("rows", "src")]
    ex.barrier()
    rng = np.random.default_rng(3)
    stacked = torch.from_numpy(
        (rng.standard_normal((n, rows_l, hny))
         + 1j * rng.standard_normal((n, rows_l, hny))).astype(np.complex64))
    cols = ft.a2a_cols_ranked(stacked[rank:rank + 1], ex)
    rows = ft.a2a_rows_ranked(cols, hny, ex)
    cols_all = multihost.gather_to_host(cols)
    rows_all = multihost.gather_to_host(rows)
    say(case="exchange", tag=ex.tag, names_left=left, seen=seen,
        barriers=ex.stats["barriers"],
        cols_exact=bool(torch.equal(cols_all, ft.a2a_cols_plain(stacked))),
        rows_exact=bool(torch.equal(rows_all, stacked)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(n: int, args: list, timeout: float = 240.0,
           env: dict = None) -> list:
    """Run this script on n ranks (the XFB_* contract on a free localhost
    port) with `args`; returns each rank's (exit code, stdout, stderr).
    Every rank is killed if one outlives the timeout."""
    port = free_port()
    procs = []
    for rank in range(n):
        e = dict(os.environ, **(env or {}))
        for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                     "LOCAL_RANK", "LOCAL_WORLD_SIZE", "XLA_FLAGS"):
            e.pop(name, None)
        e.update(XFB_COORDINATOR=f"127.0.0.1:{port}",
                 XFB_NUM_PROCESSES=str(n), XFB_PROCESS_ID=str(rank),
                 PYTHONPATH=str(REPO) + os.pathsep + e.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, *map(str, args)], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def lines(out: str) -> list:
    """The JSON lines of a rank's stdout."""
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def main(argv) -> int:
    mode, workdir = argv[0], Path(argv[1])
    torch.set_num_threads(1)
    assert "jax" not in sys.modules
    assert multihost.initialize(device="cpu") is True
    rank = multihost.rank()
    if mode == "smoke":
        run_smoke(workdir)
    elif mode == "models":
        run_models(workdir)
    elif mode == "rollout":
        run_rollout(workdir)
    elif mode == "cli":
        from xlab_fftbarotropic_torch.cli import run as cli_run
        cli_run.main(argv[argv.index("--") + 1:])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    assert "jax" not in sys.modules
    assert not any(m.startswith("xlab_fftbarotropic_tpu")
                   for m in sys.modules)
    torch.distributed.barrier()
    print(f"DONE {rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
