"""The port's 2-D pencil decomposition through its entry points, on the
CPU: adjoint.make_sharded_rollout(decomp="pencil") on a 2x4 group at
32^2 against the JAX package's make_sharded_rollout on its 2x4 pencil
mesh (rel-L2 <= 1e-6), its gradient in both arguments against the
port's single-device make_rollout gradient (within 1e-5 of its largest
entry, tests/test_torch_shard_adjoint.py's bars); and `xfb-torch-run
--shard --decomp pencil` (the 1x1 mesh of the one device) for the
barotropic, shallow-water and tracer families: its records and
checkpoints against the unsharded run within 1e-6, and each run resumed
from the other's checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu import adjoint as jadj
from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig
from xlab_fftbarotropic_tpu.parallel import pencil as jpencil
from xlab_fftbarotropic_torch import adjoint as tadj
from xlab_fftbarotropic_torch.cli import run as tcli
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.ic import makefields
from xlab_fftbarotropic_torch.io.checkpoint import load_checkpoint
from xlab_fftbarotropic_torch.io.fieldio import write_field
from xlab_fftbarotropic_torch.parallel.pencil import make_pencil_mesh
from torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")
SHAPE, N, STEPS = (2, 4), 32, 3
KW = dict(nx=N, ny=N, dt=3.0, nu=6.5, r_drag=2e-5, beta=1.6e-11)
TOL = 1e-6
NC = 64
H = ModelConfig().mean_depth
FAMILY_ARGS = {"barotropic": (),
               "sw": ("-m", "sw"),
               "tracer": ("-m", "tracer", "--tracer-kappa", "50",
                          "--tracer-ic", "gaussian")}
RECORDS = {"barotropic": ("vort", "psi", "u", "v"),
           "sw": ("vort", "psi", "u", "v", "h", "div"),
           "tracer": ("vort", "psi", "u", "v", "q")}


def _inputs():
    rng = np.random.default_rng(5)
    x = np.arange(N) / N
    smooth = (np.sin(2 * np.pi * x)[:, None] * np.cos(4 * np.pi * x)[None]
              + 0.1 * rng.standard_normal((N, N)))
    return ((1e-4 * smooth).astype(np.float32),
            (1e-9 * rng.standard_normal((N, N))).astype(np.float32))


def _grads(roll, target):
    v0, src = (torch.from_numpy(a).requires_grad_(True) for a in _inputs())
    out = roll(v0, src)
    loss = 0.5 * torch.mean(torch.square(out - target))
    loss.backward()
    return out.detach(), v0.grad, src.grad


def test_pencil_rollout_matches_jax_and_gradient_matches_single_device():
    mesh = jpencil.make_pencil_mesh(SHAPE, jax.devices()[:8])
    v0, src = _inputs()
    want = np.asarray(jadj.make_sharded_rollout(
        JConfig(**KW), STEPS, mesh, decomp="pencil")(jnp.asarray(v0),
                                                     jnp.asarray(src)))
    cfg = ModelConfig(**KW)
    roll = tadj.make_sharded_rollout(cfg, STEPS,
                                     make_pencil_mesh(SHAPE, CPU), "pencil")
    out = roll(torch.from_numpy(v0), torch.from_numpy(src))
    assert out.shape == (N, N) and out.dtype == torch.float32
    assert (np.linalg.norm(out.numpy() - want) / np.linalg.norm(want)
            <= 1e-6)
    target = 0.9 * out
    single = _grads(tadj.make_rollout(cfg, STEPS, device=CPU), target)
    for a, b in zip(_grads(roll, target), single):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    # segments of one step give the same gradient
    seg = _grads(tadj.make_sharded_rollout(
        cfg, STEPS, make_pencil_mesh(SHAPE, CPU), "pencil", segment=1),
        target)
    for a, b in zip(seg, single):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def _cli(tmp_path, family, name, *extra):
    inp = tmp_path / "in"
    if not inp.exists():
        inp.mkdir()
        cfg = ModelConfig(nx=NC, ny=NC)
        write_field(inp / cfg.init_file, makefields.gaussian(
            cfg, zeta0=1e-5) if family == "sw" else makefields.gaussian(cfg))
    out = tmp_path / name
    assert tcli.main([*FAMILY_ARGS[family], "-I", str(inp), "-O", str(out),
                      "--nx", str(NC), "--ny", str(NC), "--total-steps",
                      "9", "--record-step", "3", "--checkpoint-step", "3",
                      "--device", "cpu", "--manifest",
                      str(tmp_path / name) + ".log", *extra]) == 0
    return out


def _records_close(family, a_dir, b_dir, steps) -> None:
    """Each record of b within 1e-6 of a's: rel-L2, h - H for h, SW div
    over max |vort| at its step; an all-zero record equal."""
    for step in steps:
        def rd(d, f):
            return np.fromfile(d / f"{f}_step_{step}.bin",
                               np.float32).astype(np.float64)
        for f in RECORDS[family]:
            a, b = rd(a_dir, f), rd(b_dir, f)
            assert np.isfinite(b).all() and b.size == NC * NC
            if f == "h":
                a, b = a - H, b - H
            if not a.any():
                assert not b.any(), (f, step)
                continue
            err = (np.abs(a - b).max() / np.abs(rd(a_dir, "vort")).max()
                   if f == "div" else
                   np.linalg.norm(a - b) / np.linalg.norm(a))
            assert err <= TOL, (f, step, err)


def _ckpt_close(family, a_path, b_path, step) -> None:
    """Two checkpoints' packed global spectra: each field's physical
    rel-L2 within 1e-6 (SW div over max |zeta|)."""
    a, sa, _ = load_checkpoint(a_path)
    b, sb, _ = load_checkpoint(b_path)
    assert sa == sb == step and a.shape == b.shape
    a, b = (np.fft.irfft2(np.asarray(x, np.complex128).reshape(
        -1, NC, NC // 2 + 1), s=(NC, NC)) for x in (a, b))
    for k, (x, y) in enumerate(zip(a, b)):
        err = (np.abs(x - y).max() / np.abs(a[0]).max()
               if family == "sw" and k == 1 else
               np.linalg.norm(x - y) / np.linalg.norm(x))
        assert err <= TOL, (k, err)


@pytest.mark.parametrize("family", list(FAMILY_ARGS))
def test_cli_pencil_run_matches_the_unsharded_run_and_resumes(
        tmp_path, family, capsys):
    """--shard --decomp pencil writes the unsharded run's record files
    within 1e-6, and checkpoints each run resumes from in the other."""
    shard = ("--shard", "--decomp", "pencil")
    ref = _cli(tmp_path, family, "ref")
    out = _cli(tmp_path, family, "pencil", *shard, "--mesh-shape", "1x1")
    assert ("decomp pencil, 1x1 mesh, shard-fft xla"
            in capsys.readouterr().err)
    assert (sorted(p.name for p in ref.iterdir())
            == sorted(p.name for p in out.iterdir()))
    _records_close(family, ref, out, (0, 3, 6))
    _ckpt_close(family, ref / "ckpt_step_3.npz", out / "ckpt_step_3.npz",
                3)
    r1 = _cli(tmp_path, family, "resume-unsharded", "--resume-from",
              str(out / "ckpt_step_3.npz"))
    r2 = _cli(tmp_path, family, "resume-pencil", *shard, "--resume-from",
              str(ref / "ckpt_step_3.npz"))
    for r in (r1, r2):
        _records_close(family, ref, r, (6,))
        _ckpt_close(family, ref / "ckpt_step_6.npz", r / "ckpt_step_6.npz",
                    6)
