"""The port's finite-difference core (models/fd_core.py) and its -m fd
runs against the JAX package's on the CPU, on numpy-seeded inputs at
32^2-64^2:

- laplacian5 and gradients equal to the JAX operators bit for bit (the
  same float32 rolls and sums); arakawa_jacobian within 1e-6 of its
  largest value (its nine-term sums in another order); poisson_fft within
  1e-5 of the largest value on white noise (float32 sines and transforms
  in another order, amplified by 1/lambda of the smallest eigenvalues;
  the JAX test's bar for the inverse itself); the Arakawa conservation
  properties of the JAX test;
- poisson_jacobi's solution within 1e-6 of the JAX loop's largest value
  and its sweep count the JAX lax.while_loop's: the JAX solver capped
  at that count gives its uncapped result, capped one sweep earlier it
  does not;
- 5 RK4 steps of FDBarotropicModel.segment against the JAX segment, FFT
  solver within 1e-6 of max |zeta| and Jacobi within 1e-5;
- the -m fd runner's records (vort, psi, u, v) against the JAX runner's
  within 1e-6 of each field's largest value, checkpoint resume bit for
  bit, and the command through cli.run.main.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu import runner as jrunner
from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig
from xlab_fftbarotropic_tpu.models import fd_core as jfd
from xlab_fftbarotropic_torch import runner
from xlab_fftbarotropic_torch.cli import run as cli_run
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.ic import makefields
from xlab_fftbarotropic_torch.io.fieldio import read_field, write_field
from xlab_fftbarotropic_torch.models import fd_core as fd
from torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")
TOL = 1e-6


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _fields(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, n)).astype(np.float32)
            for _ in range(2)]


def _wave(cfg, kx, ky) -> np.ndarray:
    x, y = cfg.coords()
    return (np.sin(2 * np.pi * kx * x / cfg.lx)[:, None]
            * np.cos(2 * np.pi * ky * y[None, :] / cfg.ly)
            ).astype(np.float32)


@pytest.mark.parametrize("n", [32, 64])
def test_operators_match_the_jax_module(n):
    cfg = ModelConfig(nx=n, ny=n)
    z, p = _fields(n, n)
    tz, tp = torch.from_numpy(z), torch.from_numpy(p)
    jz, jp = jnp.asarray(z), jnp.asarray(p)
    assert np.array_equal(fd.laplacian5(tz, cfg.dx, cfg.dy).numpy(),
                          np.asarray(jfd.laplacian5(jz, cfg.dx, cfg.dy)))
    for got, want in zip(fd.gradients(tp, cfg.dx, cfg.dy),
                         jfd.gradients(jp, cfg.dx, cfg.dy)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert _rel(fd.arakawa_jacobian(tz, tp, cfg.dx, cfg.dy).numpy(),
                jfd.arakawa_jacobian(jz, jp, cfg.dx, cfg.dy)) <= TOL
    rhs = np.asarray(jfd.laplacian5(jp, cfg.dx, cfg.dy))
    got = fd.poisson_fft(torch.from_numpy(rhs.copy()), cfg.dx, cfg.dy)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), jfd.poisson_fft(jnp.asarray(rhs), cfg.dx,
                                             cfg.dy)) <= 1e-5
    # the exact inverse of laplacian5, to round-off, mean zero
    assert _rel(got.numpy(), p - p.mean()) <= 1e-5


def test_arakawa_conserves_enstrophy_and_energy():
    """sum(z * J(p, z)) = 0 and sum(p * J(p, z)) = 0 (the JAX test's
    bar)."""
    cfg = ModelConfig(nx=64, ny=64)
    z, p = _fields(64, 7)
    J = fd.arakawa_jacobian(torch.from_numpy(p), torch.from_numpy(z),
                            cfg.dx, cfg.dy).numpy().astype(np.float64)
    scale = np.abs(J).max() * 64 * 64
    assert abs((z.astype(np.float64) * J).sum()) < 1e-5 * scale
    assert abs((p.astype(np.float64) * J).sum()) < 1e-5 * scale


@pytest.mark.parametrize("tol,chunk", [(1e-3, 64), (1e-5, 7)])
def test_jacobi_stops_at_the_jax_loops_sweep(tol, chunk):
    """The same stopping sweep as the JAX lax.while_loop, whatever the
    chunk between two host reads, and the same solution within TOL."""
    cfg = ModelConfig(nx=32, ny=32)
    rhs = np.asarray(jfd.laplacian5(jnp.asarray(_wave(cfg, 2, 1)), cfg.dx,
                                    cfg.dy))
    x, sweeps = fd.poisson_jacobi(torch.from_numpy(rhs.copy()), cfg.dx,
                                  cfg.dy, tol=tol, chunk=chunk)
    k = int(sweeps)
    assert sweeps.dtype == torch.int32 and 0 < k < 10_000
    want = np.asarray(jfd.poisson_jacobi(jnp.asarray(rhs), cfg.dx, cfg.dy,
                                         tol=tol))
    assert _rel(x.numpy(), want) <= TOL

    def capped(m):
        return np.asarray(jfd.poisson_jacobi(jnp.asarray(rhs), cfg.dx,
                                             cfg.dy, tol=tol, max_iter=m))
    assert np.array_equal(capped(k), want)
    assert not np.array_equal(capped(k - 1), want)


def test_jacobi_cap_and_warm_start():
    """max_iter caps the sweeps (the JAX loop's count too), and a warm
    start at the solution stops after one sweep."""
    cfg = ModelConfig(nx=32, ny=32)
    rhs = np.asarray(jfd.laplacian5(jnp.asarray(_wave(cfg, 1, 2)), cfg.dx,
                                    cfg.dy))
    x, sweeps = fd.poisson_jacobi(torch.from_numpy(rhs.copy()), cfg.dx,
                                  cfg.dy, tol=1e-12, max_iter=50)
    assert int(sweeps) == 50
    assert _rel(x.numpy(), jfd.poisson_jacobi(
        jnp.asarray(rhs), cfg.dx, cfg.dy, tol=1e-12, max_iter=50)) <= TOL
    solved, _ = fd.poisson_jacobi(torch.from_numpy(rhs.copy()), cfg.dx,
                                  cfg.dy, tol=1e-4)
    _, again = fd.poisson_jacobi(torch.from_numpy(rhs.copy()), cfg.dx,
                                 cfg.dy, tol=1e-4, x0=solved)
    assert int(again) == 1


@pytest.mark.parametrize("solver,kw,tol", [
    ("fft", {}, TOL), ("jacobi", dict(tol=1e-4, max_iter=300), 1e-5)])
def test_segment_matches_the_jax_segment(solver, kw, tol):
    cfg = ModelConfig(nx=32, ny=32, r_drag=1e-5, beta=1e-11, nu4=1e8)
    jcfg = JConfig(nx=32, ny=32, r_drag=1e-5, beta=1e-11, nu4=1e8)
    v = makefields.gaussian(cfg).astype(np.float32)
    m = fd.FDBarotropicModel.build(cfg, CPU, solver=solver, **kw)
    z, p = m.segment(torch.from_numpy(v.copy()), m.init_psi(v),
                     m.zero_source(), 5)
    jm = jfd.FDBarotropicModel.build(jcfg, solver=solver, **kw)
    jz, jp = jm.segment(jnp.asarray(v), jm.init_psi(v), jm.zero_source(), 5)
    assert _rel(z.numpy(), jz) <= tol
    assert _rel(p.numpy(), jp) <= tol
    assert len(m.sweeps) == (20 if solver == "jacobi" else 0)
    assert all(0 < int(s) <= 300 for s in m.sweeps)


def _fd_run(tmp_path: Path, port: bool, name: str, **kw):
    cfg = (ModelConfig if port else JConfig)(
        nx=32, ny=32, dt=10.0, total_steps=10, record_step=5,
        output_dir=str(tmp_path / name), **kw)
    v0 = makefields.kuo2004(ModelConfig(nx=32, ny=32))
    log = str(tmp_path / f"log_{name}")
    if port:
        return cfg, runner.run(cfg, CPU, v0, model_kind="fd",
                               manifest_path=log)
    return cfg, jrunner.run(cfg, vort0=v0, model_kind="fd",
                            manifest_path=log)


def test_fd_runner_records_match_the_jax_runner(tmp_path):
    _, res = _fd_run(tmp_path, True, "port")
    _, jres = _fd_run(tmp_path, False, "jax")
    assert res.steps_run == 10
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 10     # vort_src, vort, psi, u, v at steps 0, 5
    for name in names:
        got = read_field(tmp_path / "port" / name, (32, 32))
        want = read_field(tmp_path / "jax" / name, (32, 32))
        if not np.abs(want).max():
            assert not np.abs(got).max()
            continue
        assert _rel(got, want) <= TOL, name
    assert ((tmp_path / "log_port").read_text().replace("port", "jax")
            == (tmp_path / "log_jax").read_text())
    for a, b in zip(res.stats_history, jres.stats_history):
        assert a.keys() == b.keys()
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), k


def test_fd_checkpoint_resume_is_bit_for_bit(tmp_path):
    cfg, full = _fd_run(tmp_path, True, "full", checkpoint_step=5)
    ckpt = Path(cfg.output_dir) / "ckpt_step_5.npz"
    assert ckpt.exists()
    resumed = runner.run(cfg, CPU, model_kind="fd", resume_from=ckpt,
                         manifest_path=str(tmp_path / "log2"))
    assert resumed.steps_run == 5
    for a, b in zip(resumed.zeta_hat, full.zeta_hat):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["fd", "jacobian"])
def test_fd_through_the_cli(tmp_path, kind):
    cfg = ModelConfig(nx=32, ny=32)
    inp = tmp_path / "in"
    inp.mkdir()
    write_field(inp / cfg.init_file, makefields.gaussian(cfg))
    assert cli_run.main(["-I", str(inp), "-O", str(tmp_path / "out"),
                         "--nx", "32", "--ny", "32", "--total-steps", "4",
                         "--record-step", "2", "-m", kind, "--device", "cpu",
                         "--manifest", str(tmp_path / "log")]) == 0
    for s in (0, 2):
        for name in ("vort", "psi", "u", "v"):
            f = read_field(tmp_path / "out" / f"{name}_step_{s}.bin",
                           (32, 32))
            assert np.isfinite(f).all()
