"""Fast mode off the single-device plane stepper: the distributed x-stages
(parallel/fused_overlap.py xstage, xstage_gather, xstage_scatter with
fast=True; on CPU tensors their plain versions, the plain transposes
around ops/fast_tile.py's fast DFT along x) against the JAX package's
pallas_overlap kernels in fast mode (pallas_fft.MM_MODE = "bf16",
interpret mode, n_chunks = 1, so that its pad is the port's); one RK4
step of the sharded barotropic model on the overlap impl in fast mode,
slab and x-pencil, against the JAX sharded model (its strict library
impl: its overlap impl in fast mode takes minutes in interpret mode); the
sharded xla and pallas impls, which fast mode leaves as they are; the
ensemble's width-1 members in fast mode against solo fast runs and its
batched chunks against their strict runs; -m fd --fast-transforms
against -m fd.

Shapes: nx = ny = 64 (hny = 33, hpad = 36) on P = 4 of the 8 virtual CPU
devices (the kernels' shortest transform, 64: the sharded kernel tests'
nx = 32 is below it), one intra-op thread.

Bars: a fast x-stage's rel-L2 against float64 lies in 1e-4 .. 1e-2,
within a factor of 5 either way of the JAX kernel's, and more than 1e-7
from the strict plain version; the gather's pad columns are zeros. The
fast sharded step's rel-L2 of physical vorticity against the JAX strict
step lies in 1e-7 .. 1e-4, the port's strict step within 1e-6. The
ensemble and FD cases are bit for bit (byte for byte for records).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig
from xlab_fftbarotropic_tpu.ic import makefields as jmakefields
from xlab_fftbarotropic_tpu.ops import pallas_fft as pf
from xlab_fftbarotropic_tpu.parallel import pallas_overlap as po
from xlab_fftbarotropic_tpu.parallel.model import (
    ShardedBarotropicModel as JSharded)
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.ic import makefields
from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
from xlab_fftbarotropic_torch.models.ensemble import EnsembleModel
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.parallel import (ShardedBarotropicModel, dfft,
                                               make_mesh)
from xlab_fftbarotropic_torch.parallel import fused_overlap as fo
from torch_threads import _one_thread  # noqa: F401

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

NS, NX, HNY, HPAD = 4, 64, 33, 36
ROWS, COLS = P("x", None), P(None, "x")
CPU = torch.device("cpu")
FACTOR = 5.0
CLASS = (1e-4, 1e-2)
FLOOR = 1e-7


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:NS]), ("x",))


def _local(mesh, fn, in_spec, out_spec):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_spec,
                             out_specs=out_spec, check_vma=False))


def _spec(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rows(g):
    return dfft.shard_rows(torch.from_numpy(g), NS)


def _cols(g):
    nx, h = g.shape
    return torch.from_numpy(g).reshape(nx, NS, h // NS).permute(
        1, 0, 2).contiguous()


def _global_cols(c):
    p, nx, w = c.shape
    return c.permute(1, 0, 2).reshape(nx, p * w).numpy()


def _rel(got, want) -> float:
    got = np.asarray(got, np.complex128).ravel()
    want = np.asarray(want, np.complex128).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("kind", ["xstage", "xstage_inverse",
                                  "xstage_gather", "xstage_scatter"])
def test_fast_xstages_match_the_jax_fast_kernels(mesh, monkeypatch, kind):
    """Each fast x-stage mode (forward, inverse at scale 1/nx, the gather
    with its pad, the scatter) against float64, beside pallas_overlap's
    under MM_MODE bf16; the fast plain version more than 1e-7 from the
    strict one."""
    jax.clear_caches()
    monkeypatch.setattr(pf, "MM_MODE", "bf16")
    scale = 1.0 / NX
    if kind == "xstage_scatter":
        x = _spec(2, (NX, HPAD))
        x[:, HNY:] = 0.0
        jax_out = _local(mesh, lambda a: po.xstage_scatter(
            a, "x", NS, hny=HNY, forward=False, n_chunks=1,
            interpret=True, scale=scale), COLS, ROWS)(jnp.asarray(x))
        got, strict = (dfft.unshard_rows(fo.xstage_scatter_plain(
            _cols(x), HNY, False, scale, fast)).numpy()
            for fast in (True, False))
        ref = np.fft.ifft(x[:, :HNY].astype(np.complex128), axis=0)
    elif kind == "xstage_gather":
        x = _spec(3, (NX, HNY))
        jax_out = _local(mesh, lambda a: po.xstage_gather(
            a, "x", NS, forward=True, n_chunks=1, interpret=True),
            ROWS, COLS)(jnp.asarray(x))
        got, strict = (_global_cols(fo.xstage_gather_plain(
            _rows(x), True, 1.0, fast)) for fast in (True, False))
        assert got.shape == (NX, HPAD) and not got[:, HNY:].any()
        got, strict = got[:, :HNY], strict[:, :HNY]
        jax_out = np.asarray(jax_out)[:, :HNY]
        ref = np.fft.fft(x.astype(np.complex128), axis=0)
    else:
        forward = kind == "xstage"
        s = 1.0 if forward else scale
        x = _spec(4, (NX, HNY))
        jax_out = _local(mesh, lambda a: po.xstage(
            a, "x", NS, forward=forward, n_chunks=1, interpret=True,
            scale=s), ROWS, ROWS)(jnp.asarray(x))
        got, strict = (dfft.unshard_rows(fo.xstage_plain(
            _rows(x), forward, s, fast)).numpy() for fast in (True, False))
        x64 = x.astype(np.complex128)
        ref = (np.fft.fft(x64, axis=0) if forward
               else np.fft.ifft(x64, axis=0))
    jax.clear_caches()
    jax_out = np.asarray(jax_out)
    assert got.shape == jax_out.shape == ref.shape
    e_port, e_jax = _rel(got, ref), _rel(jax_out, ref)
    assert CLASS[0] < e_port < CLASS[1], e_port
    assert 1.0 / FACTOR < e_port / e_jax < FACTOR, (e_port, e_jax)
    assert _rel(got, strict) > FLOOR


def test_fast_xstage_wrappers_take_their_plain_versions_on_the_cpu():
    """fast=True on CPU tensors: the fast plain versions' bits, no launch
    counted, at P = 1, 2, 4 and 8; the fast forward x-stage of one shard
    is ops/fast_tile.py's DFT of the global array."""
    from xlab_fftbarotropic_torch.ops.fast_tile import fast_dft

    for p in (1, 2, 4, 8):
        x = dfft.shard_rows(torch.from_numpy(_spec(p, (NX, HNY))), p)
        ff.reset_launches()
        a = fo.xstage(x, True, fast=True)
        b = fo.xstage_gather(x, True, 0.5, fast=True)
        c = fo.xstage_scatter(b, HNY, False, 0.25, fast=True)
        assert sum(ff.LAUNCHES.values()) == 0
        assert torch.equal(a, fo.xstage_plain(x, True, 1.0, True))
        assert torch.equal(b, fo.xstage_gather_plain(x, True, 0.5, True))
        assert torch.equal(c, fo.xstage_scatter_plain(b, HNY, False, 0.25,
                                                      True))
    g = dfft.unshard_rows(x)
    want = torch.complex(*fast_dft(g.real.contiguous(),
                                   g.imag.contiguous(), -1))
    assert torch.equal(dfft.unshard_rows(fo.xstage(x, True, fast=True)), want)


def _cfg(**kw):
    return dict(nx=NX, ny=NX, **kw)


@pytest.fixture(scope="module")
def jax_steps(mesh):
    """decomp -> (initial global state, physical vorticity after one RK4
    step) of the JAX sharded model on its strict library impl (xla). Its
    overlap impl in fast mode is not run: in interpret mode on the CPU
    mesh one step takes minutes per decomposition at 64^2, so the fast
    x-stages are held to the JAX fast kernels one by one (above) and the
    fast step to the JAX strict step here."""
    out = {}
    cfg = JConfig(**_cfg())
    for decomp in ("slab", "xpencil"):
        m = JSharded.build(cfg, mesh, fft_impl="xla", decomp=decomp)
        z0 = m.init_state(jmakefields.gaussian(cfg))
        out[decomp] = (np.asarray(z0),
                       np.asarray(m.diags(m.step(z0, m.zero_source())).vort))
    return out


def _port_step(decomp, impl, z0, fast):
    m = ShardedBarotropicModel.build(ModelConfig(**_cfg()),
                                     make_mesh(NS, CPU), impl, decomp,
                                     fast=fast)
    z = m.step(m.shard_spectral(z0[:, :HNY]), m.zero_source())
    # the state through the library inverse: the model's own diags run
    # the (fast) distributed inverse, one more transform's rounding
    vort = torch.fft.irfft2(m.unshard_spectral(z), s=(NX, NX))
    return vort.numpy(), m


@pytest.mark.parametrize("decomp", ["slab", "xpencil"])
def test_fast_sharded_step_matches_the_jax_sharded_model(jax_steps, decomp):
    """One RK4 step of the overlap impl in fast mode on four shards (the
    fast xstage, or xstage_gather and xstage_scatter) against the JAX
    sharded model's strict step: rel-L2 of the physical vorticity above
    1e-7 and below 1e-4 (the fast stage's rounding enters through dt
    times the tendency), where the port's strict overlap step lies
    within 1e-6."""
    z0, strict = jax_steps[decomp]
    got, m = _port_step(decomp, "overlap", z0, True)
    assert m.fast
    own, _ = _port_step(decomp, "overlap", z0, False)
    assert _rel(own, strict) < 1e-6
    assert FLOOR < _rel(got, strict) < 1e-4, _rel(got, strict)
    assert _rel(got, own) > FLOOR


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_fast_mode_leaves_the_other_impls_as_they_are(impl):
    """On the xla and pallas impls the x-stage is torch.fft and the
    transposes are copies: fast=True builds the same model (fast False)
    and steps bit for bit the strict one."""
    cfg = ModelConfig(**_cfg())
    z0 = BarotropicModel.build(cfg.replace(fft_backend="xla"),
                               CPU).init_state(makefields.gaussian(cfg))
    runs = []
    for fast in (False, True):
        m = ShardedBarotropicModel.build(cfg, make_mesh(NS, CPU), impl,
                                         "slab", fast=fast)
        assert not m.fast
        runs.append(m.step(m.shard_spectral(z0), m.zero_source()))
    assert torch.equal(*runs)


def test_fast_ensemble_members_are_solo_fast_runs():
    """Width-1 members in fast mode, barotropic and tracer: each member's
    state after two steps is the solo fast run's from its IC, bit for bit;
    a batched chunk (width 2, the float32 library path) equals its strict
    run bit for bit."""
    from xlab_fftbarotropic_torch.models.tracer import TracerModel

    cfg = ModelConfig(**_cfg())
    v0 = makefields.gaussian(cfg)
    for kind, solo in (("barotropic", lambda: BarotropicModel.build(
            cfg, CPU, fast=True)), ("tracer", lambda: TracerModel.build(
                cfg, CPU, kappa=5.0, fast=True))):
        e = EnsembleModel.build(cfg, CPU, 2, kind, tracer_kappa=5.0,
                                vmap_width=1, fast=True)
        assert e.inner.fast and not e.batched
        s0 = e.init_from_physical(v0, amplitude=0.02, seed=3)
        s = e.segment(s0, e.inner.zero_source(), 2)
        ref = solo()
        for k in range(2):
            mk = (s0[k] if isinstance(s0, torch.Tensor)
                  else type(s0)(*(a[k] for a in s0)))
            want = ref.segment(mk, ref.zero_source(), 2)
            got = s[k] if isinstance(s, torch.Tensor) else type(s)(
                *(a[k] for a in s))
            for a, b in zip((got,) if kind == "barotropic" else got,
                            (want,) if kind == "barotropic" else want):
                assert torch.equal(a, b), (kind, k)
    runs = []
    for fast in (False, True):
        e = EnsembleModel.build(cfg, CPU, 2, vmap_width=2, fast=fast)
        assert e.batched and not e.inner.fast
        s0 = e.init_from_physical(v0, amplitude=0.02, seed=3)
        runs.append(e.segment(s0, e.inner.zero_source(), 2))
    assert torch.equal(*runs)


def _cli(tmp_path, name, *extra):
    from xlab_fftbarotropic_torch.cli import run as tcli
    from xlab_fftbarotropic_torch.io.fieldio import write_field

    inp = tmp_path / "in"
    inp.mkdir(exist_ok=True)
    cfg = ModelConfig(**_cfg())
    write_field(inp / cfg.init_file, makefields.gaussian(cfg))
    out = tmp_path / name
    assert tcli.main(["-I", str(inp), "-O", str(out), "--nx", str(NX),
                      "--ny", str(NX), "--total-steps", "4",
                      "--record-step", "2", "--manifest",
                      str(tmp_path / f"{name}.log"), "--device", "cpu",
                      *extra]) == 0
    return out


def test_fd_fast_records_are_the_strict_records(tmp_path, capsys):
    """-m fd --fast-transforms: the FD core runs torch.fft unchanged, so
    every record is byte for byte the strict run's; the banner says
    so."""
    strict = _cli(tmp_path, "strict", "-m", "fd")
    fast = _cli(tmp_path, "fast", "-m", "fd", "--fast-transforms")
    assert "the FD core (Arakawa Jacobian, FFT Poisson solve) runs " \
           "torch.fft" in capsys.readouterr().err
    names = sorted(p.name for p in strict.glob("*.bin"))
    assert names and names == sorted(p.name for p in fast.glob("*.bin"))
    for n in names:
        assert (strict / n).read_bytes() == (fast / n).read_bytes(), n


def test_cli_ensemble_width_one_fast_members_are_solo_fast_runs(tmp_path):
    """--ensemble 2 --ensemble-width 1 --ensemble-amp 0 --fast-transforms:
    each member's records are the solo fast run's, byte for byte."""
    solo = _cli(tmp_path, "solo", "--fast-transforms")
    ens = _cli(tmp_path, "ens", "--fast-transforms", "--ensemble", "2",
               "--ensemble-width", "1", "--ensemble-amp", "0")
    names = sorted(p.name for p in solo.glob("vort_step_*.bin"))
    assert names
    for k in ("m00", "m01"):
        for n in names:
            assert (solo / n).read_bytes() == (ens / k / n).read_bytes()


def test_cli_shard_overlap_fast_runs_its_fast_xstages(tmp_path, capsys):
    """--shard --shard-fft overlap --fast-transforms (one shard, slab and
    x-pencil): the fast banner of the overlap x-stages, the fast impl on
    the model-setting line, and records within the fast class of the
    strict overlap run's (rel-L2 above 1e-7, below 1e-2 after 4 steps:
    the records pass the fast distributed inverse)."""
    from xlab_fftbarotropic_torch.io.fieldio import read_field

    for decomp, halves in (("slab", "xstage"),
                           ("xpencil", "xstage_gather, xstage_scatter")):
        args = ("--shard", "--shard-fft", "overlap", "--decomp", decomp)
        strict = _cli(tmp_path, f"strict-{decomp}", *args)
        fast = _cli(tmp_path, f"fast-{decomp}", *args, "--fast-transforms")
        err = capsys.readouterr().err
        assert f"in the overlap x-stages ({halves})" in err
        assert "shard-fft overlap (plain torch versions of the fast fused " \
               "transpose + x-DFT kernels)" in err
        a = read_field(fast / "vort_step_2.bin", (NX, NX))
        b = read_field(strict / "vort_step_2.bin", (NX, NX))
        assert FLOOR < _rel(a, b) < CLASS[1]
