"""The distributed path's kernels, by their plain versions, against the
JAX package's (TPU rows 21-23) on the same numpy-seeded inputs: the
all-to-all transposes (parallel/fused_transpose.py) exactly against
dfft.transpose_to_* (lax.all_to_all) and pallas_transpose (the remote-DMA
kernels, interpret mode); the x-stages (parallel/fused_overlap.py)
within 1e-5 of max |ref| against pallas_overlap (interpret mode,
n_chunks = 1, so that its pad is the port's: the smallest multiple of P);
and the wrappers' dispatch and checks on the CPU.

Shapes: nx = 32, ny = 32 (hny = 17, hpad = 20) on P = 4 of the 8
virtual CPU devices. The JAX functions are shard_map-local; the port's
take the stacked shards, carried across as global arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from xlab_fftbarotropic_tpu.parallel import dfft as jdfft
from xlab_fftbarotropic_tpu.parallel import pallas_overlap as po
from xlab_fftbarotropic_tpu.parallel import pallas_transpose as pt
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.parallel import dfft
from xlab_fftbarotropic_torch.parallel import fused_overlap as fo
from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

NS, NX, HNY = 4, 32, 17
HPAD = 20
ROWS, COLS = P("x", None), P(None, "x")
TOL = 1e-5
KERNELS = ("a2a_cols", "a2a_rows", "xstage", "xstage_gather",
           "xstage_scatter")


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
    """A global (nx, hny) array -> the port's row shards."""
    return dfft.shard_rows(torch.from_numpy(g), NS)


def _cols(g):
    """A global (nx, hpad) column-sharded array -> the port's (P, nx, w)."""
    nx, h = g.shape
    return torch.from_numpy(g).reshape(nx, NS, h // NS).permute(
        1, 0, 2).contiguous()


def _global_cols(c):
    p, nx, w = c.shape
    return c.permute(1, 0, 2).reshape(nx, p * w).numpy()


def _rel(got, ref) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("jax_impl", ["all_to_all", "pallas"])
def test_transposes_equal_the_jax_ones_exactly(mesh, jax_impl):
    if jax_impl == "pallas":
        to_cols = lambda a: pt.transpose_to_columns(a, "x", NS,  # noqa
                                                     interpret=True)
        to_rows = lambda a: pt.transpose_to_rows(a, "x", NS, HNY,  # noqa
                                                 interpret=True)
    else:
        to_cols = lambda a: jdfft.transpose_to_columns(a, "x", NS)  # noqa
        to_rows = lambda a: jdfft.transpose_to_rows(a, "x", NS, HNY)  # noqa
    rows = _spec(0, (NX, HNY))
    cols = _spec(1, (NX, HPAD))
    cols[:, HNY:] = 0.0
    want_cols = np.asarray(_local(mesh, to_cols, ROWS, COLS)(
        jnp.asarray(rows)))
    want_rows = np.asarray(_local(mesh, to_rows, COLS, ROWS)(
        jnp.asarray(cols)))
    assert want_cols.shape == (NX, HPAD)
    got_cols = ftr.a2a_cols_plain(_rows(rows))
    got_rows = ftr.a2a_rows_plain(_cols(cols), HNY)
    assert np.array_equal(_global_cols(got_cols), want_cols)
    assert np.array_equal(dfft.unshard_rows(got_rows).numpy(), want_rows)
    # the port's library transposes are the same copies
    assert torch.equal(dfft.transpose_to_columns(_rows(rows)), got_cols)
    assert torch.equal(dfft.transpose_to_rows(_cols(cols), HNY), got_rows)


@pytest.mark.parametrize("kind", ["xstage", "xstage_inverse",
                                  "xstage_gather", "xstage_scatter"])
def test_xstages_match_the_jax_interpret_kernels(mesh, kind):
    scale = 1.0 / NX
    if kind == "xstage_scatter":
        x = _spec(2, (NX, HPAD))
        x[:, HNY:] = 0.0
        want = _local(mesh, lambda a: po.xstage_scatter(
            a, "x", NS, hny=HNY, forward=False, n_chunks=1,
            interpret=True, scale=scale), COLS, ROWS)(jnp.asarray(x))
        got = dfft.unshard_rows(fo.xstage_scatter_plain(
            _cols(x), HNY, False, scale)).numpy()
    elif kind == "xstage_gather":
        x = _spec(3, (NX, HNY))
        want = _local(mesh, lambda a: po.xstage_gather(
            a, "x", NS, forward=True, n_chunks=1, interpret=True),
            ROWS, COLS)(jnp.asarray(x))
        got = _global_cols(fo.xstage_gather_plain(_rows(x), True))
    else:
        forward = kind == "xstage"
        s = 1.0 if forward else scale
        x = _spec(4, (NX, HNY))
        want = _local(mesh, lambda a: po.xstage(
            a, "x", NS, forward=forward, n_chunks=1, interpret=True,
            scale=s), ROWS, ROWS)(jnp.asarray(x))
        got = dfft.unshard_rows(fo.xstage_plain(_rows(x), forward,
                                                s)).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL
    if kind == "xstage_gather":
        assert not got[:, HNY:].any()          # the pad columns


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_transposes_round_trip_at_other_shard_counts(n_shards):
    hny = 33
    x = dfft.shard_rows(torch.from_numpy(_spec(n_shards, (64, hny))),
                        n_shards)
    cols = ftr.a2a_cols_plain(x)
    w = -(-hny // n_shards)
    assert cols.shape == (n_shards, 64, w)
    assert torch.equal(cols, dfft.transpose_to_columns(x))
    assert torch.equal(ftr.a2a_rows_plain(cols, hny), x)
    assert torch.equal(dfft.transpose_to_rows(cols, hny), x)
    # the x-stage is the global transform along x, whatever the shards
    ref = torch.fft.fft(dfft.unshard_rows(x), dim=0)
    got = dfft.unshard_rows(fo.xstage_plain(x, True))
    assert float((got - ref).abs().max() / ref.abs().max()) <= TOL


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    x = _rows(_spec(5, (NX, HNY)))
    c = _cols(_spec(6, (NX, HPAD)))
    ff.reset_launches()
    assert torch.equal(ftr.a2a_cols(x), ftr.a2a_cols_plain(x))
    assert torch.equal(ftr.a2a_rows(c, HNY), ftr.a2a_rows_plain(c, HNY))
    assert torch.equal(fo.xstage(x, False, 0.5),
                       fo.xstage_plain(x, False, 0.5))
    assert torch.equal(fo.xstage_gather(x), fo.xstage_gather_plain(x))
    assert torch.equal(fo.xstage_scatter(c, HNY, scale=0.5),
                       fo.xstage_scatter_plain(c, HNY, scale=0.5))
    # another memory order is taken as its contiguous copy
    assert torch.equal(ftr.a2a_rows(c.transpose(1, 2).contiguous()
                                    .transpose(1, 2), HNY),
                       ftr.a2a_rows_plain(c, HNY))
    assert all(ff.LAUNCHES[k] == 0 for k in KERNELS)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = _rows(_spec(7, (NX, HNY)))
    with pytest.raises(TypeError):
        ftr.a2a_cols(x.real.contiguous())
    with pytest.raises(ValueError):
        ftr.a2a_cols(x[0])
    with pytest.raises(ValueError):
        ftr.a2a_rows(_cols(_spec(8, (NX, HPAD))), HNY + 4)
    with pytest.raises(ValueError):
        fo.xstage_scatter(_cols(_spec(8, (NX, HPAD))), HNY - 4)
    meta = torch.zeros((NS, NX // NS, HNY), dtype=torch.complex64,
                       device="meta")
    for fn in (ftr.a2a_cols, fo.xstage_gather,
               lambda a: fo.xstage(a, True)):
        with pytest.raises(ValueError, match="no kernel for device"):
            fn(meta)
