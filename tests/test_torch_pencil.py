"""The port's 2-D pencil decomposition (parallel/pencil.py, the pencil
branch of parallel/model.py), on the CPU, against the JAX package's
pencil (xlab_fftbarotropic_tpu/parallel/pencil.py and its sharded
models, decomp="pencil") on the 2x4 mesh of the 8 virtual CPU devices:
the tests of tests/test_pencil.py, each held within 1e-6. The transform
pair against rfft2, the JAX pair and the slab transform (hny = 33 padded
to hpad = 40 over P = 8), the round trip; the barotropic, shallow-water
and tracer models one step at 32^2 and 64^2 under RK4 and ETDRK4
against the JAX pencil models from the same state, and against the
port's single-device library path; the diagnostics; the state round trip
that strips the pad; the refusals with the JAX texts. Also the (1, 4)
and (4, 1) meshes, and each of the three stages moving data only within
its mesh row (py) or column (px)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig
from xlab_fftbarotropic_tpu.ic import makefields as jmakefields
from xlab_fftbarotropic_tpu.parallel import pencil as jpencil
from xlab_fftbarotropic_tpu.parallel.model import (
    ShardedBarotropicModel as JBarotropic,
    ShardedShallowWaterModel as JShallowWater,
    ShardedTracerModel as JTracer)
from xlab_fftbarotropic_torch import convert
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.models import barotropic as bt
from xlab_fftbarotropic_torch.models import etdrk4 as etd
from xlab_fftbarotropic_torch.models import shallow_water as sw
from xlab_fftbarotropic_torch.models import tracer as tr
from xlab_fftbarotropic_torch.ops import fft
from xlab_fftbarotropic_torch.parallel import (ShardedBarotropicModel,
                                               ShardedShallowWaterModel,
                                               ShardedTracerModel, dfft,
                                               make_mesh, pencil)
from torch_threads import _one_thread  # noqa: F401

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

CPU = torch.device("cpu")
SHAPE = (2, 4)
SHAPES = [(2, 4), (1, 4), (4, 1)]
TOL = 1e-6
KAPPA = 50.0
FAMILIES = {"barotropic": (ShardedBarotropicModel, JBarotropic),
            "sw": (ShardedShallowWaterModel, JShallowWater),
            "tracer": (ShardedTracerModel, JTracer)}


def _jmesh(shape):
    return jpencil.make_pencil_mesh(
        shape, jax.devices()[:shape[0] * shape[1]])


def _jax_pair(shape, nx, ny):
    """The JAX pencil transform pair on a mesh of `shape`, global arrays
    in and out."""
    mesh = _jmesh(shape)
    axes = tuple(mesh.axis_names)
    fwd_l, inv_l = jpencil.make_fft_pair(axes, shape, ny // 2 + 1)
    fwd = jax.jit(shard_map(fwd_l, mesh=mesh,
                            in_specs=jpencil.phys_spec(axes),
                            out_specs=jpencil.state_spec(axes)))
    inv = jax.jit(shard_map(lambda s: inv_l(s, (nx, ny)), mesh=mesh,
                            in_specs=jpencil.state_spec(axes),
                            out_specs=jpencil.phys_spec(axes)))
    return fwd, inv


def _global_spectrum(spec: torch.Tensor) -> np.ndarray:
    """x-pencil shards (P, nx, w) in block order -> (nx, P w)."""
    p, nx, w = spec.shape
    return spec.permute(1, 0, 2).reshape(nx, p * w).numpy()


def _maxrel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("shape", SHAPES)
def test_pencil_forward_matches_rfft2(shape):
    """The x-pencil spectrum (pad stripped) is np.fft.rfft2's and the JAX
    pencil's on the same mesh; the pad columns are exact zeros."""
    nx = ny = 64
    f = np.random.default_rng(3).standard_normal((nx, ny)).astype(
        np.float32)
    fwd, _ = pencil.make_fft_pair(shape, ny // 2 + 1)
    tiles = pencil.shard_tiles(torch.from_numpy(f), shape)
    assert tiles.shape == (8 if shape == SHAPE else 4, nx // shape[0],
                           ny // shape[1])
    got = _global_spectrum(fwd(tiles))
    p = shape[0] * shape[1]
    assert got.shape == (nx, pencil.padded_half(33, p))
    assert not got[:, 33:].any()
    assert _maxrel(got[:, :33], np.fft.rfft2(f)) <= TOL
    want = np.asarray(_jax_pair(shape, nx, ny)[0](jnp.asarray(f)))
    assert want.shape == got.shape
    assert _maxrel(got, want) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_pencil_roundtrip(shape):
    nx = ny = 64
    rng = np.random.default_rng(4)
    f = rng.standard_normal((nx, ny)).astype(np.float32)
    fwd, inv = pencil.make_fft_pair(shape, ny // 2 + 1)
    back = inv(fwd(pencil.shard_tiles(torch.from_numpy(f), shape)),
               (nx, ny))
    assert back.shape == (shape[0] * shape[1], nx // shape[0],
                          ny // shape[1])
    assert float(np.abs(pencil.unshard_tiles(back, shape).numpy()
                        - f).max()) < 1e-5
    # the inverse of a spectrum with non-Hermitian ky = 0 and ny/2
    # columns reads them as the JAX inverse (and pocketfft's c2r) does
    p = shape[0] * shape[1]
    s = np.zeros((nx, pencil.padded_half(33, p)), np.complex64)
    s[:, :33] = (rng.standard_normal((nx, 33))
                 + 1j * rng.standard_normal((nx, 33)))
    got = pencil.unshard_tiles(inv(
        pencil.pad_spectral(torch.from_numpy(s[:, :33]), s.shape[1])
        .reshape(nx, p, -1).permute(1, 0, 2).contiguous(), (nx, ny)), shape)
    want = np.asarray(_jax_pair(shape, nx, ny)[1](jnp.asarray(s)))
    assert _rel(got, want) <= TOL


def test_pencil_matches_slab_fft():
    """The pencil and slab forward transforms agree on the same data."""
    nx = ny = 64
    f = np.random.default_rng(5).standard_normal((nx, ny)).astype(
        np.float32)
    fwd, _ = pencil.make_fft_pair(SHAPE, ny // 2 + 1)
    got = _global_spectrum(fwd(pencil.shard_tiles(torch.from_numpy(f),
                                                  SHAPE)))[:, :33]
    slab_fwd, _ = dfft.make_fft_pair()
    want = dfft.unshard_rows(slab_fwd(dfft.shard_rows(torch.from_numpy(f),
                                                      8))).numpy()
    assert _maxrel(got, want) <= TOL


def test_each_stage_moves_data_within_its_mesh_row_or_column():
    """Each shard marked with its mesh position: after tiles_to_rows and
    rows_to_blocks every shard holds only marks of its own mesh row i
    (the py stages), after blocks_to_pencils only of its own mesh column
    j (the px stage; output in block order b = j Px + i), and the inverse
    stages the same; the shards are the JAX layout's at every stage."""
    px, py = SHAPE
    p, nx, ny = px * py, 16, 16
    hpad = 16

    def mesh_of(d):
        return divmod(d, py)

    def marks(shape_local):
        return torch.arange(p, dtype=torch.float32).reshape(
            p, *([1] * len(shape_local))).expand(p, *shape_local).clone()

    def check(out, same, block_order=False):
        for k in range(p):
            i, j = (k % px, k // px) if block_order else mesh_of(k)
            for d in torch.unique(out[k]).int().tolist():
                assert mesh_of(d)[same] == (i, j)[same], (k, d)

    rows = pencil.tiles_to_rows(marks((nx // px, ny // py)), SHAPE)
    assert rows.shape == (p, nx // p, ny)
    check(rows, 0)
    blocks = pencil.rows_to_blocks(marks((nx // p, hpad)), SHAPE)
    assert blocks.shape == (p, nx // px, hpad // py)
    check(blocks, 0)
    cols = pencil.blocks_to_pencils(marks((nx // px, hpad // py)), SHAPE)
    assert cols.shape == (p, nx, hpad // p)
    check(cols, 1, block_order=True)
    back = pencil.pencils_to_blocks(marks((nx, hpad // p)), SHAPE)
    for k in range(p):
        i, j = mesh_of(k)
        assert set(torch.unique(back[k]).int().tolist()) == {
            j * px + i2 for i2 in range(px)}
    check(pencil.blocks_to_rows(marks((nx // px, hpad // py)), SHAPE), 0)
    check(pencil.rows_to_tiles(marks((nx // p, ny)), SHAPE), 0)
    # the stages compose to the global layouts: tiles -> rows is the slab
    g = torch.arange(nx * ny, dtype=torch.float32).reshape(nx, ny)
    assert torch.equal(pencil.tiles_to_rows(pencil.shard_tiles(g, SHAPE),
                                            SHAPE), dfft.shard_rows(g, p))
    h = torch.arange(nx * hpad, dtype=torch.float32).reshape(nx, hpad)
    out = pencil.blocks_to_pencils(pencil.rows_to_blocks(
        dfft.shard_rows(h, p), SHAPE), SHAPE)
    assert torch.equal(out, h.reshape(nx, p, hpad // p).permute(1, 0, 2))
    assert torch.equal(pencil.blocks_to_rows(pencil.pencils_to_blocks(
        out, SHAPE), SHAPE), dfft.shard_rows(h, p))


def _cfgs(family, scheme, n):
    kw = dict(nx=n, ny=n, time_scheme=scheme)
    if family == "sw":
        kw["dt"] = 3.0 if scheme == "rk4" else 20.0
    return JConfig(**kw), ModelConfig(**kw)


def _build(family, cfg, mesh, **kw):
    port, jax_cls = FAMILIES[family]
    cls = jax_cls if isinstance(cfg, JConfig) else port
    if family == "tracer":
        kw["kappa"] = KAPPA
    return cls.build(cfg, mesh, decomp="pencil", **kw)


def _fields(family, packed) -> dict:
    """Packed global spectra -> physical fields (float64)."""
    names = {"barotropic": ("zeta",), "sw": ("zeta", "div", "eta"),
             "tracer": ("zeta", "q")}[family]
    n = packed.shape[-2]
    return {k: np.fft.irfft2(np.asarray(a, np.complex128), s=(n, n))
            for k, a in zip(names, packed)}


def _errors(family, got, want) -> dict:
    """rel-L2 of each physical field; SW div's max abs error over
    max(|div|, |zeta|), as tests/test_pencil.py holds it."""
    g, w = _fields(family, got), _fields(family, want)
    out = {k: _rel(g[k], w[k]) for k in w if k != "div"}
    if "div" in w:
        out["div"] = float(np.abs(g["div"] - w["div"]).max() / max(
            np.abs(w["div"]).max(), np.abs(w["zeta"]).max()))
    return out


@functools.lru_cache(maxsize=None)
def _jax_model(family, scheme, n, shape=SHAPE):
    """The JAX pencil model of a family on a mesh of `shape` and its
    packed initial and one-step states (built once per worker: the
    segment and diagnostics tests share them)."""
    jcfg = _cfgs(family, scheme, n)[0]
    jm = _build(family, jcfg, _jmesh(shape))
    return (jm, *_jax_run(family, jcfg, jm))


def _jax_run(family, jcfg, jm):
    """The JAX pencil model's packed initial and one-step states, global
    (nx, hny) spectra (its unshard strips the pad)."""
    if family == "barotropic":
        z0 = jm.init_state(jmakefields.gaussian(jcfg))
        z1 = jm.segment(z0, jm.zero_source(), 1)
        return tuple(np.asarray(jm.unshard_spectral(z))[None]
                     for z in (z0, z1))
    if family == "sw":
        s0 = jm.geostrophic_init(jmakefields.gaussian(jcfg, zeta0=1e-5))
    else:
        from xlab_fftbarotropic_tpu.models.tracer import tracer_ic
        s0 = jm.init_state(jmakefields.gaussian(jcfg),
                           tracer_ic(jcfg, "gaussian"))
    s1 = jm.segment(s0, jm.zero_source(), 1)
    return tuple(np.stack(list(jm.unshard_state(s))) for s in (s0, s1))


def _port_state(family, m, packed):
    if family == "barotropic":
        return convert.sharded_state_from_numpy(packed[0], m)
    if family == "sw":
        return convert.sharded_sw_state_from_numpy(packed, m)
    return convert.sharded_tracer_state_from_numpy(packed, m)


def _port_packed(family, m, state) -> np.ndarray:
    if family == "barotropic":
        return convert.sharded_state_to_numpy(state, m)[None]
    if family == "sw":
        return convert.sharded_sw_state_to_numpy(state, m)
    return convert.sharded_tracer_state_to_numpy(state, m)


def _single_step(family, cfg, packed) -> np.ndarray:
    """One step of the port's single-device library path (SW unpaired,
    as the sharded inverses are) from a packed global state."""
    cfg = cfg.replace(fft_backend="xla")
    if family == "barotropic":
        m = bt.BarotropicModel.build(cfg, CPU)
        z = torch.from_numpy(packed[0].copy())
        return m.segment(z, m.zero_source(), 1).numpy()[None]
    if family == "tracer":
        m = tr.TracerModel.build(cfg, CPU, kappa=KAPPA)
        s = convert.tracer_state_from_numpy(packed, CPU)
        return convert.tracer_state_to_numpy(m.segment(s, m.zero_source(),
                                                       1))
    m = sw.ShallowWaterModel.build(cfg, CPU)
    s = sw.SWState(*(torch.from_numpy(a.copy()) for a in packed))
    if cfg.time_scheme == "etdrk4":
        s = etd.etdrk4_step(m.tables, m.etd_tables, s, m.zero_source(),
                            cfg.grid_shape, fwd=fft.forward,
                            inv=fft.inverse)
    else:
        s = sw.rk4_step(m.tables, s, m.zero_source(), m.dt, m.f, m.g, m.nu,
                        m.H, cfg.grid_shape, inv_pair=None)
    return convert.sw_state_to_numpy(s)


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("scheme", ["rk4", "etdrk4"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_pencil_segment_matches_jax_and_single(family, scheme, n):
    """One step of each family on the 2x4 pencil from the JAX pencil
    model's initial state: the JAX pencil's state and the single-device
    library path's, within 1e-6; the pad stays zero."""
    cfg = _cfgs(family, scheme, n)[1]
    _, s0, want = _jax_model(family, scheme, n)
    m = _build(family, cfg, pencil.make_pencil_mesh(SHAPE, CPU))
    hny = n // 2 + 1
    assert m.hpad == pencil.padded_half(hny, 8) and s0.shape[-1] == hny
    state = m.segment(_port_state(family, m, s0), m.zero_source(), 1)
    for z in (state if isinstance(state, tuple) else (state,)):
        assert z.shape == m.spectral_shape == (8, n, m.hpad // 8)
        assert not torch.from_numpy(_global_spectrum(z))[:, hny:].any()
    got = _port_packed(family, m, state)
    for ref in (want, _single_step(family, cfg, s0)):
        err = _errors(family, got, ref)
        assert max(err.values()) <= TOL, err


@pytest.mark.parametrize("shape", [(1, 4), (4, 1)])
def test_one_row_and_one_column_meshes_match_jax(shape):
    """The barotropic pencil on a (1, 4) and a (4, 1) mesh (only py, or
    only px, moves data) against the JAX pencil on the same mesh."""
    cfg = _cfgs("barotropic", "rk4", 32)[1]
    _, s0, want = _jax_model("barotropic", "rk4", 32, shape)
    m = _build("barotropic", cfg, pencil.make_pencil_mesh(shape, CPU))
    assert m.mesh.shape == shape and m.physical_shape == (
        4, 32 // shape[0], 32 // shape[1])
    z = m.segment(_port_state("barotropic", m, s0), m.zero_source(), 1)
    err = _errors("barotropic", _port_packed("barotropic", m, z), want)
    assert max(err.values()) <= TOL, err


@pytest.mark.parametrize("family", list(FAMILIES))
def test_pencil_diags_match(family):
    """Each family's diagnostics as tiles, unsharded, against the JAX
    pencil model's (global) diagnostics from the same state."""
    cfg = _cfgs(family, "rk4", 64)[1]
    jm, s0, _ = _jax_model(family, "rk4", 64)
    if family == "barotropic":
        jd = jm.diags(jm.shard_spectral(s0[0]))
    else:
        jd = jm.diags(jm.shard_state(list(s0)))
    m = _build(family, cfg, pencil.make_pencil_mesh(SHAPE, CPU))
    d = m.diags(_port_state(family, m, s0))
    for name in d._fields:
        tiles = getattr(d, name)
        assert tiles.shape == (8, 32, 16)
        a = np.asarray(getattr(jd, name))
        b = m.unshard_physical(tiles).numpy()
        scale = max(1.0, np.abs(a).max()) if name != "h" else np.abs(
            a - cfg.mean_depth).max()
        assert float(np.abs(a - b).max()) <= TOL * scale, name


def test_pencil_state_roundtrip_strips_pad():
    cfg = ModelConfig(nx=64, ny=64)
    m = ShardedBarotropicModel.build(cfg, pencil.make_pencil_mesh(SHAPE,
                                                                  CPU),
                                     decomp="pencil")
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((64, 33))
         + 1j * rng.standard_normal((64, 33))).astype(np.complex64)
    sharded = m.shard_spectral(z)
    assert sharded.shape == (8, 64, 5)
    out = m.unshard_spectral(sharded)
    assert out.shape == (64, 33)
    assert np.array_equal(out.numpy(), z)
    f = rng.standard_normal((64, 64)).astype(np.float32)
    tiles = m.shard_physical(f)
    assert tiles.shape == (8, 32, 16)
    assert np.array_equal(tiles[5].numpy(), f[32:, 16:32])
    assert np.array_equal(m.unshard_physical(tiles).numpy(), f)


def _jax_error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_pencil_validation_errors():
    """The JAX package's refusals, with its texts: a grid that fails
    check_grid (nx, then ny), a kernel impl, a 1-D mesh; and a forcing
    in the wrong layout."""
    mesh = pencil.make_pencil_mesh(SHAPE, CPU)
    jmesh = _jmesh(SHAPE)
    for kw in (dict(nx=60, ny=64), dict(nx=64, ny=66)):
        want = _jax_error(lambda: JBarotropic.build(
            JConfig(**kw), jmesh, decomp="pencil"))
        with pytest.raises(ValueError, match="divisible") as e:
            ShardedBarotropicModel.build(ModelConfig(**kw), mesh,
                                         decomp="pencil")
        assert str(e.value) == want
    cfg = ModelConfig(nx=64, ny=64)
    for impl in ("pallas", "overlap"):
        want = _jax_error(lambda: JBarotropic.build(
            JConfig(nx=64, ny=64), jmesh, decomp="pencil", fft_impl=impl))
        with pytest.raises(ValueError, match="fft_impl") as e:
            ShardedBarotropicModel.build(cfg, mesh, impl, "pencil")
        assert str(e.value).split(" (")[0] == want.split(" (")[0]
    want = _jax_error(lambda: JBarotropic.build(
        JConfig(nx=64, ny=64), jax.sharding.Mesh(
            np.array(jax.devices()), ("x",)), decomp="pencil"))
    with pytest.raises(ValueError, match="2-D mesh") as e:
        ShardedBarotropicModel.build(cfg, make_mesh(8, CPU),
                                     decomp="pencil")
    assert str(e.value).split(", got")[0] == want.split(", got")[0]
    for bad in ((2,), (2, 0), (2.0, 4), (1, 2, 4)):
        with pytest.raises(ValueError, match="two positive ints"):
            pencil.make_pencil_mesh(bad, CPU)
    m = ShardedBarotropicModel.build(cfg, mesh, decomp="pencil")
    with pytest.raises(ValueError, match="forcing must be"):
        m.step(m.init_state(np.ones((64, 64), np.float32)),
               torch.zeros(8, 8, 64))
