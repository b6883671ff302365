"""The column-tile x-stage's plan (ops/xtile.py) and, on the CPU, a torch
emulation of the transform csrc/xtile.cuh runs on the card, with the
plan's own C and K and the kernel's index arithmetic: block r of a
cluster of K loads rows r + K j of a tile of C columns, runs the
length-n/K sub-DFT in self-sorting radix-8/4/2 passes (butterfly i of
column c reads rows i + t m/R, twiddles input t by W_(pR)^(t (i mod p))
from the staged W_m table, writes rows (i - k) R + k + t p), and block q
combines k2 in [q m/K, (q+1) m/K) over the K blocks with the W_n^(r k2)
twiddles of the float32 half table and a length-K DFT. Held to
torch.fft.fft, forward and inverse, for every supported length, within
1e-5 of max |fft| (float32 data and twiddles, as on the card).

The plan: for every length 64..8192 and the column counts the kernels
see (hny = n/2 + 1 for kx_visc and xstage, the x-pencil's P w for the
gather at P = 1, 2, 4, 8), every column is covered exactly once, a
block's shared memory fits 227 KB, K <= 8 divides the grid, every row
segment fills a 32-byte sector, and C, K, the threads, the shared bytes
and the passes depend on n alone (never on the field count, the
epilogue or the columns)."""

import re

import numpy as np
import pytest
import torch

from xlab_fftbarotropic_torch.ops import _build
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.ops import xtile
from xlab_fftbarotropic_torch.parallel.pencil import padded_half

LENGTHS = [64, 128, 256, 512, 1024, 2048, 4096, 8192]
SHARDS = [1, 2, 4, 8]
TOL = 1e-5


def _column_counts(n):
    """(columns, bytes per element) of every launch at length n: kx_visc's
    float planes and the three xstage modes' complex64 at each P."""
    hny = n // 2 + 1
    out = [(hny, 4)]
    for p in SHARDS:
        out += [(hny, 8), (padded_half(hny, p), 8)]
    return out


@pytest.mark.parametrize("n", LENGTHS)
def test_plan_covers_every_column_once_within_the_card(n):
    for columns, elem in _column_counts(n):
        p = xtile.xtile_plan(n, columns, elem)
        assert (p.tiles - 1) * p.c < columns <= p.tiles * p.c
        owner = np.arange(p.tiles * p.c) // p.c      # tile of each column
        assert np.bincount(owner[:columns], minlength=p.tiles).sum() \
            == columns
        assert p.k in (1, 2, 4, 8) and p.k <= xtile.MAX_CLUSTER
        assert p.grid % p.k == 0 and p.grid == p.tiles * p.k
        assert p.smem <= xtile.MAX_SMEM
        assert p.smem == (p.m * p.c + p.m) * 8
        assert p.threads * xtile.ELEMS == p.m * p.c
        assert p.threads % 32 == 0 and p.threads <= 1024
        assert p.c * elem >= xtile.SECTOR
        assert int(np.prod(p.radices)) == p.m
        assert all(r in (2, 4, 8) for r in p.radices)
        # each block's output slice holds whole rows of the combine
        assert p.m % p.k == 0 and xtile.ELEMS % p.k == 0


@pytest.mark.parametrize("n", LENGTHS)
def test_plan_depends_on_the_length_alone(n):
    """One transform for every form: C, K, threads, shared bytes and the
    passes are those of n whatever the columns (and so whatever the
    fields, the epilogue or the shard count); the wrappers hand the
    kernels exactly these numbers."""
    plans = {xtile.xtile_plan(n, columns, elem)[2:6]
             + (xtile.xtile_plan(n, columns, elem).radices,)
             for columns, elem in _column_counts(n) + [(1, 8), (16, 4),
                                                       (17, 4)]}
    assert len(plans) == 1
    hny = n // 2 + 1
    p = xtile.xtile_plan(n, hny, 4)
    assert ff._xtile_args(n, hny, 4) == (p.c, p.k, p.threads, p.smem)


def test_plan_refuses_what_the_kernels_do_not_take():
    for n in (32, 96, 100, 16384):
        with pytest.raises(ValueError, match="power-of-two"):
            xtile.xtile_plan(n, 5, 4)
    with pytest.raises(ValueError, match="no columns"):
        xtile.xtile_plan(256, 0, 4)
    with pytest.raises(ValueError, match="4 or 8 bytes"):
        xtile.xtile_plan(256, 5, 2)


def test_plan_agrees_with_the_kernel_source():
    """The CUDA side's constants and its check of a plan are the ones the
    Python plan uses, and both kernels' entry points take the plan."""
    src = (_build.CSRC / "xtile.cuh").read_text()
    assert f"constexpr int kElems = {xtile.ELEMS};" in src
    assert "smem == (m * c + m) * static_cast<int>(sizeof(float2))" in src
    assert "c > 16" in src and xtile.MAX_COLUMNS == 16
    assert "xtile.cuh" in _build.HEADERS
    for name in ("kx_visc.cu", "xstage.cu"):
        text = (_build.CSRC / name).read_text()
        assert '#include "xtile.cuh"' in text
        assert "colfft" not in re.sub(r"//[^\n]*", "", text)
        assert "int tile_c, int cluster_k" in text


# ----- the emulation -----

def _dft_matrix(r: int, sign: int) -> torch.Tensor:
    k = np.arange(r)
    return torch.from_numpy(np.exp(sign * 2j * np.pi * np.outer(k, k) / r)
                            .astype(np.complex64))


def emulate(x: torch.Tensor, forward: bool) -> torch.Tensor:
    """The column-tile transform of x (n, columns) complex64 along axis 0,
    unnormalized, as csrc/xtile.cuh computes it (index for index)."""
    n, columns = x.shape
    p = xtile.xtile_plan(n, columns, 8)
    c, k, m = p.c, p.k, p.m
    logc = c.bit_length() - 1
    sign = -1 if forward else 1
    half = torch.view_as_complex(ff._twiddles(n, torch.device("cpu")))

    def twiddle(idx, fwd):           # W_n^idx, idx < n (xtile.cuh twiddle)
        w = half[idx % (n // 2)]
        w = torch.where(idx >= n // 2, -w, w)
        return w if fwd else w.conj()

    sw = twiddle(torch.arange(m) * k, True)          # begin(): W_m^x
    xp = torch.zeros((n, p.tiles * c), dtype=torch.complex64)
    xp[:, :columns] = x
    out = torch.empty_like(xp)
    for tile in range(p.tiles):
        j0 = tile * c
        blocks = []
        for rank in range(k):
            u = torch.arange(m * c)
            s = xp[rank + k * (u >> logc), j0 + (u & (c - 1))]
            q = 1
            for r in p.radices:                      # pass<R>()
                ub = torch.arange(m * c // r)
                col, i = ub & (c - 1), ub >> logc
                kk = i & (q - 1)
                v = torch.stack([s[(i + t * (m // r)) * c + col]
                                 for t in range(r)])
                if q > 1:
                    for t in range(1, r):
                        w = sw[t * kk * (m // (q * r))]
                        v[t] = v[t] * (w if forward else w.conj())
                v = _dft_matrix(r, sign) @ v
                j = (i - kk) * r + kk
                s = torch.empty_like(s)
                for t in range(r):
                    s[(j + t * q) * c + col] = v[t]
                q *= r
            blocks.append(s)
        y = torch.stack(blocks)                      # (k, m c) Y_r
        for rank in range(k):                        # combine<K>()
            ub = torch.arange(m // k * c)
            col = ub & (c - 1)
            k2 = rank * (m // k) + (ub >> logc)
            z = y[:, k2 * c + col].clone()
            for r in range(1, k):
                z[r] = z[r] * twiddle(r * k2, forward)
            z = _dft_matrix(k, sign) @ z
            for k1 in range(k):
                out[k2 + m * k1, j0 + col] = z[k1]
    return out[:, :columns]


@pytest.mark.parametrize("forward", [True, False],
                         ids=["forward", "inverse"])
@pytest.mark.parametrize("n", LENGTHS)
def test_emulated_cluster_transform_is_the_dft(n, forward):
    p = xtile.xtile_plan(n, 1, 8)
    columns = p.c + 1                        # one column past a tile
    rng = np.random.default_rng(n + forward)
    x = torch.from_numpy((rng.standard_normal((n, columns))
                          + 1j * rng.standard_normal((n, columns)))
                         .astype(np.complex64))
    got = emulate(x, forward)
    want = (torch.fft.fft(x, dim=0) if forward
            else torch.fft.ifft(x, dim=0, norm="forward"))
    assert float((got - want).abs().max() / want.abs().max()) < TOL
