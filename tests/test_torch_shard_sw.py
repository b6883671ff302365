"""The port's sharded shallow-water model (parallel/model.py
ShardedShallowWaterModel), on the CPU, against the JAX package's
ShardedShallowWaterModel (fft_impl="xla") on 4 of the 8 virtual CPU
devices and against the port's single-device model on unpaired torch.fft
(rk4_step / etdrk4_step with inv_pair None: the sharded models pair no
inverse, and the single-device library pair would put eps max|eta| into
zeta): the same balanced vortex, the JAX state carried across by
convert.sharded_sw_state_from_numpy. For each of the port's impls (the
library transposes, the plain versions of the a2a and xstage kernels),
RK4 in slab and x-pencil and ETDRK4 in slab at 32^2: zeta, div and eta
within 1e-6 of the state's largest norm (the JAX package's common-scale
form, tests/test_parallel.py:136-147), zeta and eta also within rel-L2
1e-6, div within 1e-6 of max |zeta| (div starts at zero). Also P = 1
against P = 4, pallas bit for bit xla, the transforms per step, fast
mode on the overlap impl, the CLI's --shard -m sw run against the
unsharded run with resumes across the two, and the refusals."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig
from xlab_fftbarotropic_tpu.ic import makefields as jmakefields
from xlab_fftbarotropic_tpu.parallel.model import (
    ShardedShallowWaterModel as JShardedSW)
from xlab_fftbarotropic_torch import convert
from xlab_fftbarotropic_torch.cli import run as tcli
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.io.checkpoint import load_checkpoint
from xlab_fftbarotropic_torch.models import etdrk4 as etd
from xlab_fftbarotropic_torch.models import shallow_water as sw
from xlab_fftbarotropic_torch.ops import fft
from xlab_fftbarotropic_torch.parallel import (ShardedShallowWaterModel,
                                               fused_overlap, make_mesh)
from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr
from xlab_fftbarotropic_torch.parallel.pencil import make_pencil_mesh
from torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")
NS, N = 4, 32
IMPLS = ["xla", "pallas", "overlap"]
CASES = [("rk4", "slab"), ("rk4", "xpencil"), ("etdrk4", "slab")]
STEPS = {"rk4": 3, "etdrk4": 2}
TOL = 1e-6


def _kw(scheme, n=N):
    return dict(nx=n, ny=n, time_scheme=scheme,
                dt=3.0 if scheme == "rk4" else 20.0)


def _phys(packed) -> list:
    """Packed (3, nx, hny) spectra -> physical zeta, div, eta (float64)."""
    return [np.fft.irfft2(np.asarray(a, np.complex128), s=(a.shape[0],
                                                            a.shape[0]))
            for a in packed]


def _errors(got, want) -> dict:
    g, w = _phys(got), _phys(want)
    scale = max(np.linalg.norm(a) for a in w)
    out = {f"{k}_common": float(np.linalg.norm(a - b) / scale)
           for k, a, b in zip(("zeta", "div", "eta"), g, w)}
    for k, i in (("zeta", 0), ("eta", 2)):
        out[f"{k}_rel"] = float(np.linalg.norm(g[i] - w[i])
                                / np.linalg.norm(w[i]))
    out["div_max"] = float(np.abs(g[1] - w[1]).max()
                           / max(np.abs(w[1]).max(), np.abs(w[0]).max()))
    return out


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:NS]), ("x",))


@pytest.fixture(scope="module")
def jax_runs(mesh):
    """(scheme, decomp) -> (packed initial state, packed state after
    STEPS) of the JAX sharded model on the library collectives."""
    out = {}
    for scheme, decomp in CASES:
        cfg = JConfig(**_kw(scheme))
        m = JShardedSW.build(cfg, mesh, fft_impl="xla", decomp=decomp)
        s0 = m.geostrophic_init(jmakefields.gaussian(cfg, zeta0=1e-5))
        s = m.segment(s0, m.zero_source(), STEPS[scheme])
        out[(scheme, decomp)] = (np.stack(list(m.unshard_state(s0))),
                                 np.stack(list(m.unshard_state(s))))
    return out


@pytest.fixture(scope="module")
def single_runs(jax_runs):
    """scheme -> the port's single-device library path, unpaired, from
    the same initial state."""
    out = {}
    for scheme in STEPS:
        cfg = ModelConfig(fft_backend="xla", **_kw(scheme))
        m = sw.ShallowWaterModel.build(cfg, CPU)
        s = sw.SWState(*(torch.from_numpy(a.copy())
                         for a in jax_runs[(scheme, "slab")][0]))
        src, g = m.zero_source(), cfg.grid_shape
        for _ in range(STEPS[scheme]):
            if scheme == "etdrk4":
                s = etd.etdrk4_step(m.tables, m.etd_tables, s, src, g,
                                    fwd=fft.forward, inv=fft.inverse)
            else:
                s = sw.rk4_step(m.tables, s, src, m.dt, m.f, m.g, m.nu, m.H,
                                g, inv_pair=None)
        out[scheme] = convert.sw_state_to_numpy(s)
    return out


def _port(scheme, decomp, impl, s0, n_shards=NS, fast=False, n=N):
    m = ShardedShallowWaterModel.build(ModelConfig(**_kw(scheme, n)),
                                       make_mesh(n_shards, CPU), impl,
                                       decomp, fast=fast)
    s = m.segment(convert.sharded_sw_state_from_numpy(s0, m),
                  m.zero_source(), STEPS[scheme])
    return m, s


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("scheme,decomp", CASES)
def test_sharded_sw_matches_jax_and_the_single_device_model(
        jax_runs, single_runs, scheme, decomp, impl):
    s0, want = jax_runs[(scheme, decomp)]
    m, s = _port(scheme, decomp, impl, s0)
    assert all(z.shape == m.spectral_shape and z.dtype == torch.complex64
               for z in s)
    got = convert.sharded_sw_state_to_numpy(s, m)
    for ref in (want, single_runs[scheme]):
        err = _errors(got, ref)
        assert max(err.values()) <= TOL, err
    # the packed state's round trip, the x-pencil pad included
    h = m.hpad or N // 2 + 1
    back = convert.sharded_sw_state_to_numpy(
        convert.sharded_sw_state_from_numpy(s0, m), m, hpad=h)
    assert back.shape == (3, N, h)
    assert np.array_equal(back[..., :N // 2 + 1], s0)
    assert not back[..., N // 2 + 1:].any()


@pytest.mark.parametrize("scheme,decomp", CASES)
def test_one_shard_matches_four_and_pallas_is_xla(jax_runs, scheme, decomp):
    s0, _ = jax_runs[(scheme, decomp)]
    one = convert.sharded_sw_state_to_numpy(
        *reversed(_port(scheme, decomp, "overlap", s0, n_shards=1)))
    four = convert.sharded_sw_state_to_numpy(
        *reversed(_port(scheme, decomp, "overlap", s0)))
    err = _errors(one, four)
    assert max(err.values()) <= TOL, err
    a = _port(scheme, decomp, "pallas", s0)[1]
    b = _port(scheme, decomp, "xla", s0)[1]
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("decomp,impl,counts", [
    ("slab", "pallas", {"a2a_cols_plain": 40, "a2a_rows_plain": 40}),
    ("slab", "overlap", {"xstage_plain": 40}),
    ("xpencil", "pallas", {"a2a_cols_plain": 24, "a2a_rows_plain": 16}),
    ("xpencil", "overlap", {"xstage_gather_plain": 24,
                            "xstage_scatter_plain": 16})])
def test_a_step_runs_ten_unpaired_transforms_per_stage(
        monkeypatch, decomp, impl, counts):
    """Four stages of four inverse transforms (u, v, zeta, eta; unpaired)
    and six forward ones (qu, qv, eu, ev, phi and the zero forcing, as
    the JAX sharded model runs it), per transform two transposes, one
    xstage, or one x-stage half; the same per ETDRK4 N."""
    calls = {k: 0 for k in counts}
    for name in counts:
        mod = ftr if name.startswith("a2a") else fused_overlap
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    for scheme in ("rk4", "etdrk4"):
        m = ShardedShallowWaterModel.build(ModelConfig(**_kw(scheme)),
                                           make_mesh(NS, CPU), impl, decomp)
        s = m.geostrophic_init(np.ones((N, N), np.float32))
        for k in calls:
            calls[k] = 0
        m.step(s, m.zero_source())
        assert calls == counts, scheme


def test_fast_overlap_rounds_only_the_x_stages(jax_runs):
    """fast=True on the overlap impl: one RK4 step at 64^2 lies within the
    fast x-stages' class of the strict overlap step, above 1e-7 (the fast
    forms ran); on xla and pallas fast mode changes nothing."""
    cfg = ModelConfig(**_kw("rk4", 64))
    v0 = np.asarray(jmakefields.gaussian(JConfig(**_kw("rk4", 64)),
                                         zeta0=1e-5))
    runs = {}
    for impl, fast in (("overlap", True), ("overlap", False),
                       ("pallas", True), ("pallas", False)):
        m = ShardedShallowWaterModel.build(cfg, make_mesh(NS, CPU), impl,
                                           fast=fast)
        assert m.fast == (fast and impl == "overlap")
        runs[(impl, fast)] = convert.sharded_sw_state_to_numpy(
            m.step(m.geostrophic_init(v0), m.zero_source()), m)
    err = _errors(runs[("overlap", True)], runs[("overlap", False)])
    assert 1e-7 < err["zeta_rel"] <= 1e-3, err
    assert err["eta_rel"] <= 1e-3, err
    assert np.array_equal(runs[("pallas", True)], runs[("pallas", False)])


def test_refusals():
    mesh = make_mesh(NS, CPU)
    with pytest.raises(NotImplementedError, match="beta-plane"):
        ShardedShallowWaterModel.build(ModelConfig(nx=N, ny=N, beta=1e-11),
                                       mesh)
    # the pencil (ported since) refuses a 1-D group and the kernel impls,
    # with the JAX package's texts
    with pytest.raises(ValueError, match="needs a 2-D mesh"):
        ShardedShallowWaterModel.build(ModelConfig(nx=N, ny=N), mesh,
                                       decomp="pencil")
    with pytest.raises(ValueError, match="fft_impl='xla' only"):
        ShardedShallowWaterModel.build(ModelConfig(nx=N, ny=N),
                                       make_pencil_mesh((2, 2), CPU),
                                       "overlap", "pencil")
    m = ShardedShallowWaterModel.build(ModelConfig(nx=N, ny=N), mesh)
    s = m.geostrophic_init(np.ones((N, N), np.float32))
    with pytest.raises(ValueError, match="complex64"):
        m.step(sw.SWState(s.zeta_hat, s.div_hat, s.eta_hat[:, :2]),
               m.zero_source())


# the CLI's grid: the unsharded run takes the plane stepper there (its
# pairing equalizer keeps zeta apart from eta; below 64^2 the library
# path pairs zeta with the unequalized eta)
NC = 64


def _cli(tmp_path, name, *extra):
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.io.fieldio import write_field

    inp = tmp_path / "in"
    if not inp.exists():
        inp.mkdir()
        cfg = ModelConfig(nx=NC, ny=NC)
        write_field(inp / cfg.init_file, makefields.gaussian(cfg,
                                                             zeta0=1e-5))
    out = tmp_path / name
    assert tcli.main(["-m", "sw", "-I", str(inp), "-O", str(out), "--nx",
                      str(NC), "--ny", str(NC), "--total-steps", "9",
                      "--record-step", "3", "--checkpoint-step", "3",
                      "--device", "cpu", "--manifest",
                      str(tmp_path / name) + ".log", *extra]) == 0
    return out


def _records_close(a_dir, b_dir, steps) -> None:
    """Each record of b within 1e-6 of a's: rel-L2 for vort, psi, u, v;
    h - H rel-L2; div over max |vort| at its step."""
    H = ModelConfig().mean_depth
    for step in steps:
        def rd(d, f):
            return np.fromfile(d / f"{f}_step_{step}.bin",
                               np.float32).astype(np.float64)
        for f in ("vort", "psi", "u", "v", "h", "div"):
            a, b = rd(a_dir, f), rd(b_dir, f)
            assert np.isfinite(b).all()
            if f == "h":
                a, b = a - H, b - H
            if f == "div":
                err = np.abs(a - b).max() / np.abs(rd(a_dir, "vort")).max()
            else:
                err = np.linalg.norm(a - b) / np.linalg.norm(a)
            assert err <= TOL, (f, step, err)


@pytest.mark.parametrize("decomp,impl", [("slab", "pallas"),
                                         ("xpencil", "overlap")])
def test_cli_shard_sw_run_matches_the_unsharded_run_and_resumes(
        tmp_path, decomp, impl):
    """-m sw --shard writes the unsharded run's record files, within 1e-6
    of them, and checkpoints the unsharded run resumes from (and the
    other way round), each resumed run's later records and checkpoint
    within 1e-6 of the unsharded run's."""
    shard = ("--shard", "--shard-fft", impl, "--decomp", decomp)
    ref = _cli(tmp_path, "ref")
    out = _cli(tmp_path, "shard", *shard)
    assert (sorted(p.name for p in ref.iterdir())
            == sorted(p.name for p in out.iterdir()))
    _records_close(ref, out, (0, 3, 6))
    a, step, _ = load_checkpoint(ref / "ckpt_step_3.npz")
    b, _, _ = load_checkpoint(out / "ckpt_step_3.npz")
    assert step == 3 and b.shape == (3, NC, NC // 2 + 1)
    assert max(_errors(b, a).values()) <= TOL
    r1 = _cli(tmp_path, "resume-unsharded", "--resume-from",
              str(out / "ckpt_step_3.npz"))
    r2 = _cli(tmp_path, "resume-sharded", *shard, "--resume-from",
              str(ref / "ckpt_step_3.npz"))
    a6, _, _ = load_checkpoint(ref / "ckpt_step_6.npz")
    for r in (r1, r2):
        _records_close(ref, r, (6,))
        b6, step, _ = load_checkpoint(r / "ckpt_step_6.npz")
        assert step == 6 and max(_errors(b6, a6).values()) <= TOL
