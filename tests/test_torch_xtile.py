"""The column-tile transform's plan (ops/xtile.py) and, on the CPU, a
torch emulation of the transform csrc/xtile.cuh runs on the card, with
the plan's own C and K and the kernel's index arithmetic: block r of a
cluster of K loads rows r + K j of a tile of C columns, runs the
length-n/K sub-DFT in self-sorting radix-8/4/2 passes (butterfly i of
column c reads rows i + t m/R, twiddles input t by W_(pR)^(t (i mod p))
from the staged W_m table, writes rows (i - k) R + k + t p), and block q
combines k2 in [q m/K, (q+1) m/K) over the K blocks with the W_n^(r k2)
twiddles of the float32 half table and a length-K DFT. Held to
torch.fft.fft, forward and inverse, for every supported length, within
1e-5 of max |fft| (float32 data and twiddles, as on the card).

The y-stages kc and kb run the same transform with their own load and
the transposed store (finish_transposed): block q stages its outputs
column-major (stride m + 16/C) in its own tile and hands column c's
values out in k order, only k <= n/2 for kc (the first m/2 staged values
and, on rank 0, the one at m/2); kb builds its tile's row y from input
row min(y, n - y) of its four half planes (the Hermitian load, the
imaginary parts of rows 0 and n/2 dropped). The emulated kc and kb are
held to kc_plain and kb_plain within 1e-5 of max |plain|, and every
output they keep is written exactly once.

The plan: for every length 64..8192 and the column counts the kernels
see (hny = n/2 + 1 for kx_visc and xstage, the x-pencil's P w for the
gather at P = 1, 2, 4, 8, nx for kc and kb), every column is covered
exactly once, a block's shared memory fits 227 KB, K <= 8 divides the
grid, every row segment fills a 32-byte sector, and C, K, the threads,
the shared bytes and the passes depend on n alone (never on the field
count, the epilogue or the columns)."""

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
    float planes, the three xstage modes' complex64 at each P, and the
    nx float columns of kc and kb (square, and half and twice as wide)."""
    hny = n // 2 + 1
    out = [(hny, 4), (n, 4), (n // 2, 4), (2 * n, 4)]
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
    assert ff._xtile_args(n, n, 4) == (p.c, p.k, p.threads, p.smem)


def test_plan_refuses_what_the_kernels_do_not_take():
    for n in (32, 96, 100, 16384):
        with pytest.raises(ValueError, match="power-of-two"):
            xtile.xtile_plan(n, 5, 4)
    with pytest.raises(ValueError, match="no columns"):
        xtile.xtile_plan(256, 0, 4)
    with pytest.raises(ValueError, match="4 or 8 bytes"):
        xtile.xtile_plan(256, 5, 2)


# __global__ functions on the column tile, and those still around colfft
TILE_KERNELS = {"kx_visc.cu": ("kx_visc_kernel",),
                "xstage.cu": ("xstage_kernel",),
                "ka_kc.cu": ("kc_kernel",), "kb_pair.cu": ("kb_kernel",)}
COLFFT_KERNELS = {"ka_kc.cu": ("ka_kernel", "ka_adv_kernel",
                               "ka_fwd_kernel"),
                  "kb_pair.cu": ("kb_pair_kernel",)}
PLAN_ENTRIES = {"kx_visc.cu": ("xfb_kx_visc", "xfb_kx_visc_tail"),
                "xstage.cu": ("xfb_xstage",),
                "ka_kc.cu": ("xfb_kc", "xfb_kc_sw", "xfb_kc_visc"),
                "kb_pair.cu": ("xfb_kb",)}


def _body(text: str, opener: str) -> str:
    """The braced body that follows the regex `opener` in a comment-free
    CUDA source."""
    start = text.index("{", re.search(opener, text).end())
    depth = 0
    for j in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[start:j + 1]
    raise AssertionError(f"unbalanced braces after {opener}")


def _source(name: str) -> str:
    return re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())


def test_plan_agrees_with_the_kernel_source():
    """The CUDA side's constants and its check of a plan are the ones the
    Python plan uses; per __global__ function, the tile kernels run the
    column tile and no colfft (the y-stages through the transposed
    store), the others still colfft; every tile entry point takes the
    plan."""
    src = (_build.CSRC / "xtile.cuh").read_text()
    assert f"constexpr int kElems = {xtile.ELEMS};" in src
    assert "smem == (m * c + m) * static_cast<int>(sizeof(float2))" in src
    assert "c > 16" in src and xtile.MAX_COLUMNS == 16
    # the staged columns (m + 16/C values each) fit the tile and W_m table
    assert "return t.m + (16 >> t.logc);" in src
    assert "xtile.cuh" in _build.HEADERS
    for name, kernels in TILE_KERNELS.items():
        text = _source(name)
        assert '#include "xtile.cuh"' in text
        for fn in kernels:
            body = _body(text, rf"__global__\s+void\s+(__launch_bounds__"
                               rf"\([^)]*\)\s+)?{fn}\s*\(")
            assert "xt::begin(" in body and "colfft" not in body, fn
            store = ("xt::finish_transposed<" if name in ("ka_kc.cu",
                                                          "kb_pair.cu")
                     else "xt::finish<")
            assert store in body, fn
        for entry in PLAN_ENTRIES[name]:
            sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)
            assert "int tile_c, int cluster_k" in " ".join(
                sig.group(1).split()), entry
            assert "plan_ok" in text
    for name, kernels in COLFFT_KERNELS.items():
        text = _source(name)
        for fn in kernels:
            body = _body(text, rf"__global__\s+void\s+{fn}\s*\(")
            assert "colfft<" in body and "xt::" not in body, fn


# ----- the emulation -----

def _dft_matrix(r: int, sign: int) -> torch.Tensor:
    k = np.arange(r)
    return torch.from_numpy(np.exp(sign * 2j * np.pi * np.outer(k, k) / r)
                            .astype(np.complex64))


def _dense(x: torch.Tensor):
    """The load of an (n, columns) complex64 matrix: x[rows, columns]
    (kx_visc's, xstage's and kc's cp.async of the tile's rows)."""
    return lambda rows, cols: x[rows, cols]


def _hermitian(war, wai, wbr, wbi):
    """kb's Hermitian tile load (csrc/kb_pair.cu kb_kernel): row y of
    the tile from input row h = min(y, n - y) of the (n/2 + 1, columns)
    planes, the imaginary parts of the self-conjugate rows 0 and n/2
    never read; c = a + i b for y <= n/2, conj(a) + i conj(b) past it;
    wbr = wbi = None: a zero partner."""
    n = 2 * (war.shape[0] - 1)
    half = n // 2

    def load(y, x):
        h = torch.where(y <= half, y, n - y)
        selfconj = (h == 0) | (h == half)
        zero = torch.zeros(y.shape, dtype=torch.float32)
        ar = war[h, x]
        ai = torch.where(selfconj, zero, wai[h, x])
        br = zero if wbr is None else wbr[h, x]
        bi = zero if wbi is None else torch.where(selfconj, zero, wbi[h, x])
        low = y <= half
        return torch.complex(torch.where(low, ar - bi, ar + bi),
                             torch.where(low, ai + br, br - ai))
    return load


def emulate(load, n: int, columns: int, forward: bool,
            transposed: bool = False, half: bool = False) -> torch.Tensor:
    """The column-tile transform along the length-n axis of `columns`
    columns whose tile rows come from load(rows, columns), unnormalized,
    as csrc/xtile.cuh computes it (index for index). Direct store
    (finish): (n, columns). Transposed store (finish_transposed): (columns,
    n), or (columns, n/2 + 1) with `half`; an output the store never
    writes stays NaN."""
    p = xtile.xtile_plan(n, columns, 4 if transposed else 8)
    c, k, m = p.c, p.k, p.m
    mk = m // k
    logc = c.bit_length() - 1
    sign = -1 if forward else 1
    half_tw = torch.view_as_complex(ff._twiddles(n, torch.device("cpu")))

    def twiddle(idx, fwd):           # W_n^idx, idx < n (xtile.cuh twiddle)
        w = half_tw[idx % (n // 2)]
        w = torch.where(idx >= n // 2, -w, w)
        return w if fwd else w.conj()

    sw = twiddle(torch.arange(m) * k, True)          # begin(): W_m^x
    nan = complex(float("nan"), float("nan"))
    out = torch.full((n, p.tiles * c), nan, dtype=torch.complex64)
    out_t = torch.full((p.tiles * c, n), nan, dtype=torch.complex64)
    for tile in range(p.tiles):
        j0 = tile * c
        blocks = []
        for rank in range(k):
            u = torch.arange(m * c)
            rows, cols = rank + k * (u >> logc), j0 + (u & (c - 1))
            live = cols < columns                    # the ragged tile
            s = torch.where(live, load(rows, cols.clamp(max=columns - 1)),
                            torch.zeros((), dtype=torch.complex64))
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
            ub = torch.arange(mk * c)
            col = ub & (c - 1)
            k2 = rank * mk + (ub >> logc)
            z = y[:, k2 * c + col].clone()
            for r in range(1, k):
                z[r] = z[r] * twiddle(r * k2, forward)
            z = _dft_matrix(k, sign) @ z
            if not transposed:
                for k1 in range(k):
                    out[k2 + m * k1, j0 + col] = z[k1]
                continue
            # combine_staged<K>(): column-major in the block's own tile
            stride = m + 16 // c
            assert c * stride <= m * c + m           # the tile + W_m table
            staged = torch.full((m * c + m,), nan, dtype=torch.complex64)
            for k1 in range(k):
                staged[col * stride + k1 * mk + (ub >> logc)] = z[k1]
            # finish_transposed(): column by column, in k order
            length = m // 2 if half else m
            uo = torch.arange(length * c)
            co, i = uo // length, uo % length
            kout = rank * mk + i % mk + m * (i // mk)
            out_t[j0 + co, kout] = staged[co * stride + i]
            if half and rank == 0:
                co = torch.arange(c)
                out_t[j0 + co, n // 2] = staged[co * stride + m // 2]
    if transposed:
        return out_t[:columns, :n // 2 + 1 if half else n]
    return out[:, :columns]


def _rel(got, want) -> float:
    assert not torch.isnan(got).any()                # every output written
    return float((got - want).abs().max() / want.abs().max())


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
    got = emulate(_dense(x), n, columns, forward)
    want = (torch.fft.fft(x, dim=0) if forward
            else torch.fft.ifft(x, dim=0, norm="forward"))
    assert _rel(got, want) < TOL


def _float_planes(rng, shape, k):
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(k)]


@pytest.mark.parametrize("n", LENGTHS)
def test_emulated_kc_is_kc_plain(n):
    """kc's tile kernel (forward, the transposed half store) on y-major
    (n, nx) planes, nx one column past a tile: kc_plain's (nx, n/2 + 1)
    planes."""
    nx = xtile.xtile_plan(n, 1, 4).c + 1
    xr, xi = _float_planes(np.random.default_rng(n + 2), (n, nx), 2)
    got = emulate(_dense(torch.complex(xr, xi)), n, nx, True,
                  transposed=True, half=True)
    want = torch.complex(*ff.kc_plain(xr, xi))
    assert got.shape == (nx, n // 2 + 1)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
@pytest.mark.parametrize("n", LENGTHS)
def test_emulated_kb_is_kb_plain(n, paired):
    """kb's tile kernel (the Hermitian load, inverse, the transposed
    store, Re * scale to a and Im * scale to b) on (n/2 + 1, nx) planes,
    nx one column past a tile: kb_plain's x-major (nx, n) planes, paired
    and the single inverse; junk in the imaginary parts of rows 0 and
    n/2 (the leak guard) changes no bit."""
    nx = xtile.xtile_plan(n, 1, 4).c + 1
    w = _float_planes(np.random.default_rng(n + 3), (n // 2 + 1, nx), 4)
    if not paired:
        w[2:] = [None, None]
    scale = 1.0 / (n * nx)
    got = emulate(_hermitian(*w), n, nx, False, transposed=True)
    a, b = got.real * scale, got.imag * scale
    want = ff.kb_plain(*w, scale)
    assert got.shape == (nx, n)
    assert _rel(a, want[0]) < TOL
    if paired:
        assert _rel(b, want[1]) < TOL
    dirty = list(w)
    dirty[1] = w[1].clone()
    dirty[1][0] = 10.0
    dirty[1][n // 2] = -7.0
    if paired:
        dirty[3] = w[3].clone()
        dirty[3][n // 2] = 3.0
    assert torch.equal(emulate(_hermitian(*dirty), n, nx, False,
                               transposed=True), got)
