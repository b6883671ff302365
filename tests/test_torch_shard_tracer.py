"""The port's sharded tracer model (parallel/model.py ShardedTracerModel),
on the CPU, against the JAX package's ShardedTracerModel (fft_impl="xla")
on 4 of the 8 virtual CPU devices and against the port's single-device
library model: the gaussian vortex and tracer, kappa = 50, the JAX state
carried across by convert.sharded_tracer_state_from_numpy. For each of
the port's impls (the library transposes, the plain versions of the a2a
and xstage kernels), RK4 in slab and x-pencil and ETDRK4 in slab at
32^2: rel-L2 of zeta and q <= 1e-6. Also P = 1 against P = 4, pallas bit
for bit xla, the transforms per step, beta and drag on the flow, fast
mode on the overlap impl, and the CLI's --shard -m tracer run against
the unsharded run with resumes across the two."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig
from xlab_fftbarotropic_tpu.ic import makefields as jmakefields
from xlab_fftbarotropic_tpu.parallel.model import (
    ShardedTracerModel as JShardedTracer)
from xlab_fftbarotropic_torch import convert
from xlab_fftbarotropic_torch.cli import run as tcli
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.io.checkpoint import load_checkpoint
from xlab_fftbarotropic_torch.models.tracer import TracerModel, tracer_ic
from xlab_fftbarotropic_torch.parallel import (ShardedTracerModel,
                                               fused_overlap, make_mesh)
from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr
from torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")
NS, N = 4, 32
KAPPA = 50.0
IMPLS = ["xla", "pallas", "overlap"]
CASES = [("rk4", "slab"), ("rk4", "xpencil"), ("etdrk4", "slab")]
STEPS = {"rk4": 3, "etdrk4": 2}
TOL = 1e-6


def _kw(scheme, n=N, **extra):
    return dict(nx=n, ny=n, time_scheme=scheme, **extra)


def _ic(n=N):
    cfg = ModelConfig(nx=n, ny=n)
    return (np.asarray(jmakefields.gaussian(JConfig(nx=n, ny=n))),
            tracer_ic(cfg, "gaussian"))


def _rel(got, want) -> dict:
    """Packed (2, nx, hny) spectra -> rel-L2 of physical zeta and q."""
    out = {}
    for k, a, b in zip(("zeta", "q"), got, want):
        a, b = (np.fft.irfft2(np.asarray(x, np.complex128),
                              s=(x.shape[0], x.shape[0])) for x in (a, b))
        out[k] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    return out


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:NS]), ("x",))


@pytest.fixture(scope="module")
def jax_runs(mesh):
    """(scheme, decomp) -> (packed initial state, packed state after
    STEPS) of the JAX sharded tracer on the library collectives."""
    out = {}
    v0, q0 = _ic()
    for scheme, decomp in CASES:
        m = JShardedTracer.build(JConfig(**_kw(scheme)), mesh,
                                 fft_impl="xla", decomp=decomp,
                                 kappa=KAPPA)
        s0 = m.init_state(v0, q0)
        s = m.segment(s0, m.zero_source(), STEPS[scheme])
        out[(scheme, decomp)] = (np.stack(list(m.unshard_state(s0))),
                                 np.stack(list(m.unshard_state(s))))
    return out


def _port(scheme, decomp, impl, s0, n_shards=NS, **extra):
    m = ShardedTracerModel.build(ModelConfig(**_kw(scheme)),
                                 make_mesh(n_shards, CPU), impl, decomp,
                                 kappa=KAPPA, **extra)
    s = m.segment(convert.sharded_tracer_state_from_numpy(s0, m),
                  m.zero_source(), STEPS[scheme])
    return m, s


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("scheme,decomp", CASES)
def test_sharded_tracer_matches_jax_and_the_single_device_model(
        jax_runs, scheme, decomp, impl):
    s0, want = jax_runs[(scheme, decomp)]
    m, s = _port(scheme, decomp, impl, s0)
    assert all(z.shape == m.spectral_shape for z in s)
    got = convert.sharded_tracer_state_to_numpy(s, m)
    err = _rel(got, want)
    assert max(err.values()) <= TOL, err
    single = TracerModel.build(ModelConfig(fft_backend="xla",
                                           **_kw(scheme)), CPU, kappa=KAPPA)
    ss = single.segment(convert.tracer_state_from_numpy(s0, CPU),
                        single.zero_source(), STEPS[scheme])
    err = _rel(got, convert.tracer_state_to_numpy(ss))
    assert max(err.values()) <= TOL, err
    h = m.hpad or N // 2 + 1
    back = convert.sharded_tracer_state_to_numpy(
        convert.sharded_tracer_state_from_numpy(s0, m), m, hpad=h)
    assert back.shape == (2, N, h)
    assert np.array_equal(back[..., :N // 2 + 1], s0)


@pytest.mark.parametrize("scheme,decomp", CASES)
def test_one_shard_matches_four_and_pallas_is_xla(jax_runs, scheme, decomp):
    s0, _ = jax_runs[(scheme, decomp)]
    one = convert.sharded_tracer_state_to_numpy(
        *reversed(_port(scheme, decomp, "overlap", s0, n_shards=1)))
    four = convert.sharded_tracer_state_to_numpy(
        *reversed(_port(scheme, decomp, "overlap", s0)))
    assert max(_rel(one, four).values()) <= TOL
    a = _port(scheme, decomp, "pallas", s0)[1]
    b = _port(scheme, decomp, "xla", s0)[1]
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("decomp,impl,counts", [
    ("slab", "pallas", {"a2a_cols_plain": 32, "a2a_rows_plain": 32}),
    ("slab", "overlap", {"xstage_plain": 32}),
    ("xpencil", "pallas", {"a2a_cols_plain": 8, "a2a_rows_plain": 24}),
    ("xpencil", "overlap", {"xstage_gather_plain": 8,
                            "xstage_scatter_plain": 24})])
def test_a_step_runs_eight_unpaired_transforms_per_stage(
        monkeypatch, decomp, impl, counts):
    """Four stages of six inverse transforms (the zeta and q gradients and
    u, v; unpaired) and two forward ones (the forcing rides zeta's), per
    transform two transposes, one xstage, or one x-stage half; the same
    per ETDRK4 N."""
    calls = {k: 0 for k in counts}
    for name in counts:
        mod = ftr if name.startswith("a2a") else fused_overlap
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    for scheme in ("rk4", "etdrk4"):
        m = ShardedTracerModel.build(ModelConfig(**_kw(scheme)),
                                     make_mesh(NS, CPU), impl, decomp,
                                     kappa=KAPPA)
        s = m.init_state(*_ic())
        for k in calls:
            calls[k] = 0
        m.step(s, m.zero_source())
        assert calls == counts, scheme


@pytest.mark.parametrize("scheme", ["rk4", "etdrk4"])
def test_beta_drag_and_hyperviscosity_ride_the_flow(scheme):
    """beta, r_drag and nu4 on the flow (RK4 terms, or the ETD tables,
    complex under beta) and a nonzero forcing: the x-pencil overlap
    model against the single-device library model, rel-L2 <= 1e-6."""
    extra = dict(beta=1.6e-11, r_drag=2e-5, nu4=1e9)
    cfg = ModelConfig(**_kw(scheme, **extra))
    v0, q0 = _ic()
    src = 1e-9 * np.cos(np.arange(N * N, dtype=np.float32)).reshape(N, N)
    m = ShardedTracerModel.build(cfg, make_mesh(NS, CPU), "overlap",
                                 "xpencil", kappa=KAPPA)
    s = m.segment(m.init_state(v0, q0), torch.from_numpy(src), 2)
    single = TracerModel.build(cfg.replace(fft_backend="xla"), CPU,
                               kappa=KAPPA)
    ss = single.segment(single.init_state(v0, q0), torch.from_numpy(src), 2)
    err = _rel(convert.sharded_tracer_state_to_numpy(s, m),
               convert.tracer_state_to_numpy(ss))
    assert max(err.values()) <= TOL, err


def test_fast_overlap_rounds_only_the_x_stages():
    """fast=True on the overlap impl: one RK4 step at 64^2 within the fast
    x-stages' class of the strict overlap step, above 1e-7."""
    cfg = ModelConfig(**_kw("rk4", 64))
    v0, q0 = _ic(64)
    runs = {}
    for fast in (True, False):
        m = ShardedTracerModel.build(cfg, make_mesh(NS, CPU), "overlap",
                                     "xpencil", fast=fast, kappa=KAPPA)
        assert m.fast == fast
        runs[fast] = convert.sharded_tracer_state_to_numpy(
            m.step(m.init_state(v0, q0), m.zero_source()), m)
    err = _rel(runs[True], runs[False])
    assert all(1e-7 < e <= 1e-4 for e in err.values()), err


def _cli(tmp_path, name, *extra):
    from xlab_fftbarotropic_torch.io.fieldio import write_field

    inp = tmp_path / "in"
    if not inp.exists():
        inp.mkdir()
        write_field(inp / ModelConfig().init_file, _ic(64)[0])
    out = tmp_path / name
    assert tcli.main(["-m", "tracer", "--tracer-kappa", str(KAPPA),
                      "--tracer-ic", "gaussian", "-I", str(inp), "-O",
                      str(out), "--nx", "64", "--ny", "64", "--total-steps",
                      "9", "--record-step", "3", "--checkpoint-step", "3",
                      "--device", "cpu", "--manifest",
                      str(tmp_path / name) + ".log", *extra]) == 0
    return out


def _records_close(a_dir, b_dir, steps) -> None:
    for step in steps:
        for f in ("vort", "psi", "u", "v", "q"):
            a, b = (np.fromfile(d / f"{f}_step_{step}.bin",
                                np.float32).astype(np.float64)
                    for d in (a_dir, b_dir))
            assert np.isfinite(b).all()
            err = np.linalg.norm(a - b) / np.linalg.norm(a)
            assert err <= TOL, (f, step, err)


@pytest.mark.parametrize("decomp,impl,scheme", [
    ("slab", "overlap", "rk4"), ("xpencil", "pallas", "etdrk4")])
def test_cli_shard_tracer_run_matches_the_unsharded_run_and_resumes(
        tmp_path, decomp, impl, scheme):
    """-m tracer --shard writes the unsharded run's record files within
    rel-L2 1e-6, and checkpoints each run resumes from in the other."""
    common = ("--time-scheme", scheme)
    shard = ("--shard", "--shard-fft", impl, "--decomp", decomp) + common
    ref = _cli(tmp_path, "ref", *common)
    out = _cli(tmp_path, "shard", *shard)
    assert (sorted(p.name for p in ref.iterdir())
            == sorted(p.name for p in out.iterdir()))
    _records_close(ref, out, (0, 3, 6))
    a, step, _ = load_checkpoint(ref / "ckpt_step_3.npz")
    b, _, _ = load_checkpoint(out / "ckpt_step_3.npz")
    assert step == 3 and b.shape == (2, 64, 33)
    assert max(_rel(b, a).values()) <= TOL
    r1 = _cli(tmp_path, "resume-unsharded", *common, "--resume-from",
              str(out / "ckpt_step_3.npz"))
    r2 = _cli(tmp_path, "resume-sharded", *shard, "--resume-from",
              str(ref / "ckpt_step_3.npz"))
    a6, _, _ = load_checkpoint(ref / "ckpt_step_6.npz")
    for r in (r1, r2):
        _records_close(ref, r, (6,))
        b6, _, _ = load_checkpoint(r / "ckpt_step_6.npz")
        assert max(_rel(b6, a6).values()) <= TOL
