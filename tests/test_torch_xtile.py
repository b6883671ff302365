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

The y-first pair: kb_pair (kb's load, the natural store of row
segments), ky_adv (the advection product computed as the tile loads,
kc's half store) and kb_adv (the inverse of kb_pair, the advection at
the rows block q holds after the combine, each value handed to block
y mod K at slot (y div K) C + c of its tile, every slot written exactly
once, then ky_adv's forward transform; in tiles of C/2 columns), held
to their plain versions, and kb_adv exactly the emulated ky_adv of the
emulated kb_pair's outputs. kb_adv_tracer runs kb_adv's inverse and
exchange with two products, adv_z into the first tile and adv_q into a
second one, and two forward transforms into flat (2 nx, ny/2 + 1)
planes; held to kb_adv_tracer_plain on non-square grids with a ragged
last tile, and exactly the emulated kb_pair followed by the emulated
ky_adv of each product.

The full-length x-stages with the transposed store: ka (every mode) and
the stacked ones, whose cluster index decodes as (tile, field) with the
field fastest and whose load forms each field as the tile loads: the
derivative fields (ka_diag, ka6, ka_quad), the shallow-water fields
(ka_sw, on hny columns: the last tile one column) and products (ka_fwd,
split off and on). Stored as RowOut does into flat (F columns, n)
planes, dead columns skipped, every output written exactly once; held to
their plain versions, and the pins (the stacked kernels equal ka of the
fields and products formed in torch) bit for bit.

The last forward stages moved onto the tile: ky_all (ka_fwd's five
products on ky_adv's y-stage: the plan of ny over nx columns, the half
store into flat (5 nx, ny/2 + 1) planes) and ka_adv (ky_adv's advection
on ka's real forward x-stage: the plan of nx over ny columns), on
non-square grids whose last tile is ragged, held to ky_all_plain and
ka_adv_plain, and pinned bit for bit: ky_all's product p is kc of
(sw_products' product p, 0), ka_adv is ka of the advection formed in
torch.

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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation runs many small torch ops: one intra-op thread for
    them (test workers share the cores), the count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _column_counts(n):
    """(columns, bytes per element) of every launch at length n: the hny
    float columns of kx_visc, ka's complex inverse and the field
    x-stages, the three xstage modes' complex64 at each P, and the nx
    float columns of kc and kb and ny of ka's real forward (square, and
    half and twice as wide)."""
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
        # kb_adv_full's two tiles of C/2 columns: the plan's bytes, and
        # half the threads, a whole number of warps
        assert (2 * p.m * (p.c // 2) + p.m) * 8 == p.smem
        assert p.threads // 2 * xtile.ELEMS == p.m * (p.c // 2)
        assert p.threads // 2 % 32 == 0
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


# __global__ functions on the column tile, each with the store it ends in
# (the natural finish, or the transposed one of the y-stages)
TILE_KERNELS = {"kx_visc.cu": {"kx_visc_kernel": "xt::finish<"},
                "xstage.cu": {"xstage_kernel": "xt::finish<"},
                "ka_kc.cu": {"ka_kernel": "xt::finish_transposed<",
                             "ka_adv_kernel": "xt::finish_transposed<",
                             "ka_fwd_kernel": "xt::finish_transposed<",
                             "kc_kernel": "xt::finish_transposed<"},
                "ka_diag.cu": {"ka_fields_kernel": "xt::finish_transposed<"},
                "ka_sw.cu": {"ka_sw_kernel": "xt::finish_transposed<"},
                "kb_pair.cu": {"kb_pair_kernel": "xt::finish<",
                               "kb_kernel": "xt::finish_transposed<"},
                "ky_adv.cu": {"ky_adv_kernel": "xt::finish_transposed<"},
                "ky_all.cu": {"ky_all_kernel": "xt::finish_transposed<"},
                "kb_adv.cu": {"kb_adv_kernel": "xt::finish_transposed<"},
                "kb_adv_tracer.cu": {
                    "kb_adv_tracer_kernel": "xt::finish_transposed<"}}
PLAN_ENTRIES = {"kx_visc.cu": ("xfb_kx_visc", "xfb_kx_visc_tail"),
                "xstage.cu": ("xfb_xstage",),
                "ka_kc.cu": ("xfb_ka", "xfb_ka_adv", "xfb_ka_fwd", "xfb_kc",
                             "xfb_kc_sw", "xfb_kc_visc"),
                "ka_diag.cu": ("xfb_ka_diag", "xfb_ka6", "xfb_ka_quad"),
                "ka_sw.cu": ("xfb_ka_sw",),
                "kb_pair.cu": ("xfb_kb", "xfb_kb_pair"),
                "ky_adv.cu": ("xfb_ky_adv",),
                "ky_all.cu": ("xfb_ky_all",),
                "kb_adv.cu": ("xfb_kb_adv_full", "xfb_kb_adv_half"),
                "kb_adv_tracer.cu": ("xfb_kb_adv_tracer",)}
# the paired c2r y-stages, whose tile is the Hermitian load
HERMITIAN_KERNELS = ("kb_pair_kernel", "kb_kernel", "kb_adv_kernel",
                     "kb_adv_tracer_kernel")
# the kernels whose tile is formed by the computing load of load_rows
LOAD_ROWS_KERNELS = ("ka_fields_kernel", "ka_sw_kernel", "ka_adv_kernel",
                     "ka_fwd_kernel", "ky_all_kernel")
STORES = ("xt::finish<", "xt::finish_transposed<")


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
    Python plan uses; per __global__ function, the FFT kernels run the
    column tile, each ending in its own store (kb_pair's natural one, the
    transposed one of ka, ka_adv, ka_fwd, the field x-stages, ka_sw, kb,
    kc, ky_adv, ky_all, kb_adv and kb_adv_tracer); every tile entry point
    takes the plan; the paired c2r y-stages share the tile's Hermitian
    load, the computing x-stages and ky_all load_rows; the one-column
    transform colfft.cuh is gone: not built, not on disk, included by no
    source."""
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
        for fn, store in kernels.items():
            body = _body(text, rf"__global__\s+void\s+(__launch_bounds__"
                               rf"\([^)]*\)\s+)?{fn}\s*\(")
            assert "xt::begin(" in body and "colfft" not in body, fn
            assert store in body, fn
            assert all(other not in body for other in STORES
                       if other != store), fn
            if fn in HERMITIAN_KERNELS:
                assert "xt::load_hermitian(" in body, fn
            if fn in LOAD_ROWS_KERNELS:
                assert "xt::load_rows(" in body, fn
        for entry in PLAN_ENTRIES[name]:
            sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)
            assert "int tile_c, int cluster_k" in " ".join(
                sig.group(1).split()), entry
            assert "plan_ok" in text
    assert "colfft.cuh" not in _build.HEADERS
    assert not (_build.CSRC / "colfft.cuh").exists()
    assert not any("colfft" in _source(name)
                   for name in _build.SOURCES + _build.HEADERS)


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
    """The Hermitian tile load of kb, kb_pair and kb_adv (csrc/xtile.cuh
    load_hermitian): row y of the tile from input row h = min(y, n - y)
    of the (n/2 + 1, columns) planes, the imaginary parts of the
    self-conjugate rows 0 and n/2 never read; c = a + i b for y <= n/2,
    conj(a) + i conj(b) past it; wbr = wbi = None: a zero partner."""
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


class _Cluster:
    """The plan and tables of a length-n transform over `columns`
    columns of `elem`-byte elements, and the steps of csrc/xtile.cuh for
    one block of one tile, index for index; `narrow`: tiles of half the
    plan's columns, the same K (kb_adv's)."""

    def __init__(self, n: int, columns: int, elem: int,
                 narrow: bool = False):
        p = xtile.xtile_plan(n, columns, elem)
        self.c = p.c // 2 if narrow else p.c
        self.n, self.columns, self.tiles = n, columns, -(-columns // self.c)
        self.k, self.m, self.radices = p.k, p.m, p.radices
        self.mk = p.m // p.k
        self.logc = self.c.bit_length() - 1
        self.half_tw = torch.view_as_complex(
            ff._twiddles(n, torch.device("cpu")))
        self.sw = self.twiddle(torch.arange(p.m) * p.k, True)  # W_m^x

    def twiddle(self, idx, fwd):         # W_n^idx, idx < n (twiddle())
        w = self.half_tw[idx % (self.n // 2)]
        w = torch.where(idx >= self.n // 2, -w, w)
        return w if fwd else w.conj()

    def load(self, load, tile: int, rank: int) -> torch.Tensor:
        """Block `rank`'s tile: slot u holds row rank + K (u >> log C) of
        column j0 + (u mod C), from load(rows, columns); 0 past the
        columns (the ragged tile)."""
        u = torch.arange(self.m * self.c)
        rows = rank + self.k * (u >> self.logc)
        cols = tile * self.c + (u & (self.c - 1))
        return torch.where(cols < self.columns,
                           load(rows, cols.clamp(max=self.columns - 1)),
                           torch.zeros((), dtype=torch.complex64))

    def subdft(self, s: torch.Tensor, forward: bool) -> torch.Tensor:
        """subdft(): the self-sorting radix passes over the block's tile."""
        c, m = self.c, self.m
        q = 1
        for r in self.radices:                        # pass<R>()
            ub = torch.arange(m * c // r)
            col, i = ub & (c - 1), ub >> self.logc
            kk = i & (q - 1)
            v = torch.stack([s[(i + t * (m // r)) * c + col]
                             for t in range(r)])
            if q > 1:
                for t in range(1, r):
                    w = self.sw[t * kk * (m // (q * r))]
                    v[t] = v[t] * (w if forward else w.conj())
            v = _dft_matrix(r, -1 if forward else 1) @ v
            j = (i - kk) * r + kk
            s = torch.empty_like(s)
            for t in range(r):
                s[(j + t * q) * c + col] = v[t]
            q *= r
        return s

    def combine(self, blocks: torch.Tensor, rank: int, forward: bool):
        """gather() and twiddle_dft() of block `rank` over the K blocks'
        Y_r (blocks: (K, m C)): (k2, column in tile, z) with z[k1] =
        X[k2 + m k1]."""
        ub = torch.arange(self.mk * self.c)
        col = ub & (self.c - 1)
        k2 = rank * self.mk + (ub >> self.logc)
        z = blocks[:, k2 * self.c + col].clone()
        for r in range(1, self.k):
            z[r] = z[r] * self.twiddle(r * k2, forward)
        return k2, col, _dft_matrix(self.k, -1 if forward else 1) @ z

    def transform(self, load, tile: int, forward: bool) -> torch.Tensor:
        """Every block's loaded tile after its sub-DFT: (K, m C)."""
        return torch.stack([self.subdft(self.load(load, tile, r), forward)
                            for r in range(self.k)])

    def store_transposed(self, k2, col, z, tile: int, rank: int,
                         half: bool, out, writes, plane: int = 0) -> None:
        """combine_staged() and finish_transposed(): block `rank` stages
        its outputs column-major (stride m + 16/C) in its own tile and
        hands column c's values out in k order into out[plane + j0 + c,
        k]; with `half` only k <= n/2. Columns past the last are skipped,
        as the kernels' stores skip them."""
        c, m, mk, j0 = self.c, self.m, self.mk, tile * self.c
        stride = m + 16 // c
        assert c * stride <= m * c + m               # the tile + W_m table
        nan = complex(float("nan"), float("nan"))
        staged = torch.full((m * c + m,), nan, dtype=torch.complex64)
        for k1 in range(self.k):
            staged[col * stride + k1 * mk + k2 - rank * mk] = z[k1]
        length = m // 2 if half else m
        uo = torch.arange(length * c)
        co, i = uo // length, uo % length
        kout = rank * mk + i % mk + m * (i // mk)
        live = j0 + co < self.columns
        _put(out, writes, (plane + j0 + co[live], kout[live]),
             staged[(co * stride + i)[live]])
        if half and rank == 0:
            co = torch.arange(c)
            co = co[j0 + co < self.columns]
            _put(out, writes,
                 (plane + j0 + co, torch.full_like(co, self.n // 2)),
                 staged[co * stride + m // 2])


def _put(out, writes, idx, values) -> None:
    """out[idx] = values, counting the writes of each output."""
    out[idx] = values
    writes.index_put_(idx, torch.ones(values.shape, dtype=torch.int64),
                      accumulate=True)


def _outputs(rows: int, cols: int):
    """Every output NaN and unwritten."""
    nan = complex(float("nan"), float("nan"))
    return (torch.full((rows, cols), nan, dtype=torch.complex64),
            torch.zeros((rows, cols), dtype=torch.int64))


def _written_once(out, writes, rows: int, cols: int) -> torch.Tensor:
    """The outputs kept, each of which the store wrote exactly once."""
    assert (writes[:rows, :cols] == 1).all()
    return out[:rows, :cols]


def emulate(load, n: int, columns: int, forward: bool,
            transposed: bool = False, half: bool = False,
            elem: int = 0) -> torch.Tensor:
    """The column-tile transform along the length-n axis of `columns`
    columns whose tile rows come from load(rows, columns), unnormalized,
    as csrc/xtile.cuh computes it (index for index), with the plan of
    `elem`-byte elements (default: 4 for the transposed store, 8 else).
    Natural store (finish): (n, columns). Transposed store
    (finish_transposed): (columns, n), or (columns, n/2 + 1) with
    `half`. Every output kept is written exactly once."""
    e = _Cluster(n, columns, elem or (4 if transposed else 8))
    width = e.tiles * e.c
    out, writes = _outputs(width, n) if transposed else _outputs(n, width)
    for tile in range(e.tiles):
        blocks = e.transform(load, tile, forward)
        for rank in range(e.k):
            k2, col, z = e.combine(blocks, rank, forward)
            if transposed:
                e.store_transposed(k2, col, z, tile, rank, half, out, writes)
                continue
            for k1 in range(e.k):                    # finish()
                _put(out, writes, (k2 + e.m * k1, tile * e.c + col), z[k1])
    if transposed:
        return _written_once(out, writes, columns,
                             n // 2 + 1 if half else n)
    return _written_once(out, writes, n, columns)


def _advection(u, zx, v, zy, src, beta: float):
    """xfb::advection: -(u zx) - v (zy + beta) + src, each product and sum
    rounded on its own in float32, ky_adv_plain's order."""
    if beta != 0.0:
        zy = zy + beta
    return -(u * zx) - v * zy + src


def _scaled(z: torch.Tensor, scale: float):
    """kb_pair's store: Re * scale and Im * scale."""
    return z.real * scale, z.imag * scale


def _advection_load(u, zx, v, zy, src, beta: float):
    """ky_adv's tile load (csrc/ky_adv.cu): (adv, 0) at each row and
    column of the y-major planes."""
    def load(y, x):
        adv = _advection(u[y, x], zx[y, x], v[y, x], zy[y, x], src[y, x],
                         beta)
        return torch.complex(adv, torch.zeros_like(adv))
    return load


def emulate_kb_adv(wr, wi, zx, zy, src, beta: float) -> torch.Tensor:
    """kb_adv_kernel (csrc/kb_adv.cu) on ka_diag's (4, ny/2 + 1, nx)
    stack, in tiles of half the plan's columns: full when zx is None (a
    second tile of fields 0, 1), else half with the y-major zeta planes.
    The Hermitian tiles' inverse
    sub-DFTs and combine; u, v (and zx, zy) times 1/(nx ny); the
    advection at each (y, c) block q holds; every value to block y mod K,
    slot (y div K) C + c of its tile, which must each be written exactly
    once; the forward sub-DFT and the transposed half store: (nx, ny/2 +
    1)."""
    _, hny, nx = wr.shape
    ny = 2 * (hny - 1)
    scale = ff._kb_adv_scale(wr)
    e = _Cluster(ny, nx, 4, narrow=True)
    uv_load = _hermitian(wr[2], wi[2], wr[3], wi[3])
    zz_load = _hermitian(wr[0], wi[0], wr[1], wi[1])
    out, writes = _outputs(e.tiles * e.c, ny)
    for tile in range(e.tiles):
        uv = e.transform(uv_load, tile, False)
        zz = e.transform(zz_load, tile, False) if zx is None else None
        fwd, slots = _outputs(e.k, e.m * e.c)
        for rank in range(e.k):
            k2, col, p = e.combine(uv, rank, False)
            q = None if zz is None else e.combine(zz, rank, False)[2]
            x = tile * e.c + col
            live, xc = x < nx, x.clamp(max=nx - 1)
            for k1 in range(e.k):
                y = k2 + e.m * k1
                u, v = _scaled(p[k1], scale)
                if q is None:
                    zxv, zyv = zx[y, xc], zy[y, xc]
                else:
                    zxv, zyv = _scaled(q[k1], scale)
                adv = torch.where(live, _advection(u, zxv, v, zyv,
                                                   src[y, xc], beta),
                                  torch.zeros(()))
                _put(fwd, slots, (y % e.k, (y // e.k) * e.c + col),
                     torch.complex(adv, torch.zeros_like(adv)))
        assert (slots == 1).all()          # every slot written, once
        blocks = torch.stack([e.subdft(fwd[r], True) for r in range(e.k)])
        for rank in range(e.k):
            k2, col, z = e.combine(blocks, rank, True)
            e.store_transposed(k2, col, z, tile, rank, True, out, writes)
    return _written_once(out, writes, nx, ny // 2 + 1)


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


# the fused y-stages at the plan's own C and K: K = 1 up to 512, 2 at
# 1024, and one case at 4096 (K = 8)
FUSED_LENGTHS = [64, 128, 256, 512, 1024]


def _stack(rng, n, nx, fields, size=1.0):
    return [size * t for t in _float_planes(rng, (fields, n // 2 + 1, nx),
                                            2)]


def _emulated_kb_pair(wr, wi, fa: int, fb: int, scale: float):
    """kb_pair_kernel: the Hermitian tile of fields fa, fb, the inverse
    transform and the natural store, Re * scale and Im * scale: y-major
    (ny, nx)."""
    ny = 2 * (wr.shape[1] - 1)
    got = emulate(_hermitian(wr[fa], wi[fa], wr[fb], wi[fb]), ny,
                  wr.shape[2], False, elem=4)
    return _scaled(got, scale)


@pytest.mark.parametrize("stack", [(4, 0, 1), (6, 4, 5)],
                         ids=["ka_diag", "ka6"])
@pytest.mark.parametrize("n", FUSED_LENGTHS)
def test_emulated_kb_pair_is_kb_pair_plain(n, stack):
    """kb_pair's tile kernel (kb's Hermitian load of fields fa, fb of the
    stacked planes, the inverse, the natural store of row segments) on a
    (F, n/2 + 1, nx) stack, nx one column past a tile: kb_pair_plain's
    y-major (n, nx) planes, every output written once; junk in the
    imaginary parts of rows 0 and n/2 changes no bit."""
    f, fa, fb = stack
    nx = xtile.xtile_plan(n, 1, 4).c + 1
    wr, wi = _stack(np.random.default_rng(n + f), n, nx, f)
    scale = 1.0 / (n * nx)
    a, b = _emulated_kb_pair(wr, wi, fa, fb, scale)
    want = ff.kb_pair_plain(wr, wi, fa, fb, scale)
    assert a.shape == (n, nx)
    assert _rel(a, want[0]) < TOL and _rel(b, want[1]) < TOL
    dirty = wi.clone()
    dirty[:, 0] = 10.0 * wi[:, 0] + 1.0
    dirty[:, n // 2] = -7.0
    da, db = _emulated_kb_pair(wr, dirty, fa, fb, scale)
    assert torch.equal(da, a) and torch.equal(db, b)


@pytest.mark.parametrize("beta", [0.0, 1.6])
@pytest.mark.parametrize("n", FUSED_LENGTHS)
def test_emulated_ky_adv_is_ky_adv_plain(n, beta):
    """ky_adv's tile kernel (the advection load of five y-major (n, nx)
    planes, the forward transform, kc's transposed half store), nx one
    column past a tile: ky_adv_plain's (nx, n/2 + 1) planes, every
    output written once."""
    nx = xtile.xtile_plan(n, 1, 4).c + 1
    f = _float_planes(np.random.default_rng(n + 5), (n, nx), 5)
    got = emulate(_advection_load(*f, beta), n, nx, True, transposed=True,
                  half=True)
    assert got.shape == (nx, n // 2 + 1)
    assert _rel(got, torch.complex(*ff.ky_adv_plain(*f, beta))) < TOL


@pytest.mark.parametrize("n, mode", [(n, mode) for n in FUSED_LENGTHS
                                     for mode in ("full", "half")]
                         + [(4096, "full")])
def test_emulated_kb_adv_is_plain_and_kb_pair_then_ky_adv(n, mode):
    """kb_adv's tile kernel (the Hermitian tiles' inverse, the advection
    at the combine's rows, the redistribution to block y mod K at slot
    (y div K) C + c, the forward transform and half store), nx one column
    past a tile, beta on: kb_adv_full_plain / kb_adv_half_plain within
    1e-5, and exactly the emulated ky_adv of the emulated kb_pair's
    outputs (the same float32 ops in the same order); junk in the
    self-conjugate rows' imaginary parts changes no bit."""
    nx = xtile.xtile_plan(n, 1, 4).c + 1
    rng = np.random.default_rng(n + 7)
    wr, wi = _stack(rng, n, nx, 4, nx * n ** 0.5)    # fields of order one
    zx, zy, src = _float_planes(rng, (n, nx), 3)
    scale = ff._kb_adv_scale(wr)
    u, v = _emulated_kb_pair(wr, wi, 2, 3, scale)
    if mode == "full":
        zx, zy = _emulated_kb_pair(wr, wi, 0, 1, scale)
        got = emulate_kb_adv(wr, wi, None, None, src, 1.6)
        want = ff.kb_adv_full_plain(wr, wi, src, 1.6)
    else:
        got = emulate_kb_adv(wr, wi, zx, zy, src, 1.6)
        want = ff.kb_adv_half_plain(zx, zy, wr, wi, src, 1.6)
    assert got.shape == (nx, n // 2 + 1)
    assert _rel(got, torch.complex(*want)) < TOL
    unfused = emulate(_advection_load(u, zx, v, zy, src, 1.6), n, nx, True,
                      transposed=True, half=True)
    assert torch.equal(got, unfused)
    dirty = wi.clone()
    dirty[:, 0] = 10.0 * wi[:, 0] + 1.0
    dirty[:, n // 2] = -7.0 * wi[:, n // 2]
    zeta = (None, None) if mode == "full" else (zx, zy)
    assert torch.equal(emulate_kb_adv(wr, dirty, *zeta, src, 1.6), got)


# ----- kb_adv_tracer_kernel (csrc/kb_adv_tracer.cu): kb_adv's inverse
# and exchange with two products and two forward transforms -----

def emulate_kb_adv_tracer(zx, zy, qx, qy, wr, wi, src,
                          beta: float) -> torch.Tensor:
    """kb_adv_tracer_kernel on ka6's (6, ny/2 + 1, nx) stack, in tiles of
    half the plan's columns: the Hermitian tile of fields 2, 3, its
    inverse sub-DFT and combine; u, v times 1/(nx ny); adv_z with src (0
    for None) and beta, adv_q with 0 and no beta, at each (y, c) block q
    holds; each product to block y mod K, slot (y div K) C + c of its own
    tile, every slot written exactly once; the forward transform of each
    tile and the half store into flat (2 nx, ny/2 + 1) planes, adv_z at
    row x, adv_q at row nx + x (a store past nx would land in the next
    plane): (2, nx, ny/2 + 1)."""
    _, hny, nx = wr.shape
    ny = 2 * (hny - 1)
    scale = 1.0 / (nx * ny)
    e = _Cluster(ny, nx, 4, narrow=True)
    # the second tile's staged columns fit it and the 16-value pad
    assert e.c * (e.m + 16 // e.c) <= e.m * e.c + 16
    uv_load = _hermitian(wr[2], wi[2], wr[3], wi[3])
    zero = torch.zeros((ny, nx), dtype=torch.float32)
    src = zero if src is None else src
    out, writes = _outputs(2 * nx, ny)
    for tile in range(e.tiles):
        uv = e.transform(uv_load, tile, False)
        tiles = [_outputs(e.k, e.m * e.c) for _ in range(2)]
        for rank in range(e.k):
            k2, col, p = e.combine(uv, rank, False)
            x = tile * e.c + col
            live, xc = x < nx, x.clamp(max=nx - 1)
            for k1 in range(e.k):
                y = k2 + e.m * k1
                u, v = _scaled(p[k1], scale)
                advs = (_advection(u, zx[y, xc], v, zy[y, xc], src[y, xc],
                                   beta),
                        _advection(u, qx[y, xc], v, qy[y, xc], zero[y, xc],
                                   0.0))
                for (fwd, slots), adv in zip(tiles, advs):
                    adv = torch.where(live, adv, torch.zeros(()))
                    _put(fwd, slots, (y % e.k, (y // e.k) * e.c + col),
                         torch.complex(adv, torch.zeros_like(adv)))
        for plane, (fwd, slots) in zip((0, nx), tiles):
            assert (slots == 1).all()      # every slot written, once
            blocks = torch.stack([e.subdft(fwd[r], True)
                                  for r in range(e.k)])
            for rank in range(e.k):
                k2, col, z = e.combine(blocks, rank, True)
                e.store_transposed(k2, col, z, tile, rank, True, out, writes,
                                   plane=plane)
    return _written_once(out, writes, 2 * nx, hny).reshape(2, nx, hny)


# (ny, nx): the tile of C/2 columns ragged, nx over and under ny, K = 1
# and K = 2
TRACER_SHAPES = [(64, 44), (128, 37), (1024, 13)]


def _tracer_inputs(ny, nx, seed):
    """ka6's stack at the stepper's size (the velocities of order one
    after the 1/(nx ny) scale), the y-major gradients zx, zy, qx, qy and
    src."""
    rng = np.random.default_rng(seed)
    wr, wi = (w * nx * ny ** 0.5 for w in _float_planes(
        rng, (6, ny // 2 + 1, nx), 2))
    return [wr, wi] + _float_planes(rng, (ny, nx), 5)


@pytest.mark.parametrize("beta", [0.0, 1.6])
@pytest.mark.parametrize("with_src", [True, False], ids=["src", "no_src"])
@pytest.mark.parametrize("shape", TRACER_SHAPES, ids=str)
def test_emulated_kb_adv_tracer_is_plain(shape, with_src, beta):
    """kb_adv_tracer's tile kernel on non-square (ny, nx) grids with a
    ragged last tile, src given and None, beta 0 and 1.6:
    kb_adv_tracer_plain's (2, nx, ny/2 + 1) planes within 2e-6 of each
    plane's max |plain|."""
    from xlab_fftbarotropic_torch.ops import fused_tracer as ft

    ny, nx = shape
    wr, wi, zx, zy, qx, qy, src = _tracer_inputs(ny, nx, ny + nx + 47)
    src = src if with_src else None
    got = emulate_kb_adv_tracer(zx, zy, qx, qy, wr, wi, src, beta)
    want = torch.complex(*ft.kb_adv_tracer_plain(zx, zy, qx, qy, wr, wi,
                                                 src, beta))
    assert got.shape == (2, nx, ny // 2 + 1)
    for g, w in zip(got, want):
        assert _rel(g, w) < 2e-6


@pytest.mark.parametrize("with_src", [True, False], ids=["src", "no_src"])
@pytest.mark.parametrize("shape", TRACER_SHAPES[:2], ids=str)
def test_emulated_kb_adv_tracer_is_kb_pair_then_ky_adv(shape, with_src):
    """The pin: plane 0 is exactly the emulated ky_adv(u, zx, v, zy, src,
    beta) and plane 1 the emulated ky_adv(u, qx, v, qy, 0, 0), with (u,
    v) the emulated kb_pair of fields 2, 3 at 1/(nx ny) (a None src adds
    a zero plane; beta belongs to zeta alone)."""
    ny, nx = shape
    wr, wi, zx, zy, qx, qy, src = _tracer_inputs(ny, nx, ny + nx + 53)
    zero = torch.zeros_like(zx)
    src = src if with_src else None
    got = emulate_kb_adv_tracer(zx, zy, qx, qy, wr, wi, src, 1.6)
    u, v = _emulated_kb_pair(wr, wi, 2, 3, 1.0 / (nx * ny))
    for plane, load in ((0, _advection_load(u, zx, v, zy,
                                            zero if src is None else src,
                                            1.6)),
                        (1, _advection_load(u, qx, v, qy, zero, 0.0))):
        want = emulate(load, ny, nx, True, transposed=True, half=True)
        assert torch.equal(got[plane], want), plane


@pytest.mark.parametrize("shape", [(64, 44), (256, 9)], ids=str)
def test_emulated_kb_adv_tracer_writes_each_output_once(shape):
    """Into flat (2 nx, ny/2 + 1) planes on a non-square grid whose last
    tile is ragged (one live column at 256 x 9): every output of both
    planes is written exactly once, none past nx into the next plane's
    first rows, and every product slot of both tiles exactly once
    (emulate_kb_adv_tracer asserts both)."""
    ny, nx = shape
    wr, wi, zx, zy, qx, qy, src = _tracer_inputs(ny, nx, ny + nx + 59)
    c = xtile.xtile_plan(ny, nx, 4).c // 2
    assert nx % c                                     # the ragged tile
    got = emulate_kb_adv_tracer(zx, zy, qx, qy, wr, wi, src, 0.0)
    assert got.shape == (2, nx, ny // 2 + 1)
    assert not torch.isnan(got).any()


@pytest.mark.parametrize("shape", [(64, 44), (1024, 13)], ids=str)
def test_emulated_kb_adv_tracer_leak_guard(shape):
    """Dirty imaginary parts of the self-conjugate rows 0 and ny/2 of
    every field (u's and v's among them) change no bit: the Hermitian
    load never reads them."""
    ny, nx = shape
    wr, wi, zx, zy, qx, qy, src = _tracer_inputs(ny, nx, ny + nx + 61)
    clean = emulate_kb_adv_tracer(zx, zy, qx, qy, wr, wi, src, 1.6)
    dirty = wi.clone()
    dirty[:, 0] = 10.0 * wi[:, 0] + 1.0
    dirty[:, ny // 2] = -7.0 * wi[:, ny // 2]
    assert torch.equal(emulate_kb_adv_tracer(zx, zy, qx, qy, wr, dirty, src,
                                             1.6), clean)


# ----- the ka x-stages: ka_kernel (csrc/ka_kc.cu) and ka_fields_kernel
# (csrc/ka_diag.cu), the full transposed store -----

KA_LENGTHS = [64, 128, 256, 512, 1024]
# ka's modes: (forward, real input, columns) with the columns of their
# calls: ny for the real forward of rfft2, hny for the others
KA_MODES = {"real_forward": (True, True, "n"),
            "real_inverse": (False, True, "hny"),
            "complex_forward": (True, False, "hny"),
            "complex_inverse": (False, False, "hny")}


def _cut(n: int, columns: int) -> int:
    """A call's columns cut to two whole tiles and its last one (hny's
    one column; none for ny): the plan and each tile's steps are those of
    n whatever the columns, so three tiles show them all."""
    c = xtile.xtile_plan(n, 1, 4).c
    return min(columns, 2 * c + columns % c)


def emulate_ka(xr, xi, forward: bool, scale: float):
    """ka_kernel: the tile of the (n, m) planes (xi None: zero imaginary
    parts), the transform, the full transposed store of Re * scale and
    Im * scale: (m, n) planes."""
    n, m = xr.shape
    x = torch.complex(xr, torch.zeros_like(xr) if xi is None else xi)
    got = emulate(_dense(x), n, m, forward, transposed=True)
    return _scaled(got, scale)


@pytest.mark.parametrize("mode", list(KA_MODES))
@pytest.mark.parametrize("n", KA_LENGTHS)
def test_emulated_ka_is_ka_plain(n, mode):
    """ka's tile kernel in each mode at scale 0.37 on (n, m) planes, m =
    n or hny cut to three tiles (the last of hny one column): ka_plain's
    (m, n) planes, every output written once."""
    forward, real, cols = KA_MODES[mode]
    m = _cut(n, n if cols == "n" else n // 2 + 1)
    xr, xi = _float_planes(np.random.default_rng(n + 13), (n, m), 2)
    xi = None if real else xi
    got = torch.complex(*emulate_ka(xr, xi, forward, 0.37))
    assert got.shape == (m, n)
    assert _rel(got, torch.complex(*ff.ka_plain(xr, xi, forward, 0.37))) \
        < TOL


def _field_load(sr, si, rlap, kx, ky, kind: int, psi_first: bool):
    """ka_fields_kernel's tile load (csrc/ka_diag.cu): field `kind` of the
    state plane S = sr + i si at row i, column j, each product rounded on
    its own in the kernel's order: i kx S, i ky S, then -i ky psi and
    i kx psi with the diagonal first, or psi = S rlap first (psi_first)."""
    def load(i, j):
        a, b = sr[i, j], si[i, j]
        q = kx[i] if kind in (0, 3) else ky[j]
        if kind < 2:
            return torch.complex(-(b * q), a * q)
        r = rlap[i, j]
        sign = 1.0 if kind == 2 else -1.0
        if psi_first:
            re, im = q * (b * r), -(q * (a * r))
        else:
            re, im = (b * q) * r, -(a * q) * r
        return torch.complex(sign * re, sign * im)
    return load


def _emulate_stack(loads, n: int, columns: int, forward: bool,
                   half: bool = False):
    """A stacked transform with the transposed store (ka_fields_kernel,
    ka_sw_kernel, ka_fwd_kernel, ka_adv_kernel at F = 1; with `half`
    ky_all_kernel): field f of F = len(loads) from loads[f](rows,
    columns), the cluster index decoded as (tile, field) with the field
    fastest, the transform and the transposed store at scale 1 (RowOut,
    or HalfOut's k <= n/2: field f's column x to row f columns + x of the
    flat (F columns, n or n/2 + 1) planes, so a store past the ragged
    edge would land in the next field's): (F, columns, n or n/2 + 1),
    every output written exactly once."""
    count = len(loads)
    width = n // 2 + 1 if half else n
    e = _Cluster(n, columns, 4)
    out, writes = _outputs(count * columns, width)
    for cluster in range(e.tiles * count):               # grid x / K
        f, tile = cluster % count, cluster // count
        blocks = e.transform(loads[f], tile, forward)
        for rank in range(e.k):
            k2, col, z = e.combine(blocks, rank, forward)
            e.store_transposed(k2, col, z, tile, rank, half, out, writes,
                               plane=f * columns)
    return _written_once(out, writes, count * columns, width).reshape(
        count, columns, width)


def emulate_fields(sr, si, rlap, kx, ky, first: int, count: int,
                   psi_first: bool):
    """ka_fields_kernel on the states (nstate, n, hny): fields first ..
    first + count - 1 (field g reads state g div 4, kind g mod 4), the
    inverse transform: (count, hny, n)."""
    _, n, hny = sr.shape
    loads = [_field_load(sr[g // 4], si[g // 4], rlap, kx, ky, g % 4,
                         psi_first) for g in range(first, first + count)]
    return _emulate_stack(loads, n, hny, False)


def _field_inputs(n, states: int):
    """States (states, n, h), rlap and the kx, ky tables of an n x n
    grid (the spectral tables' own, numpy-seeded states), the hny columns
    cut to h = _cut(n, hny) (the last tile one column)."""
    from xlab_fftbarotropic_torch.ops.spectral import SpectralTables

    t = SpectralTables.build(n, n, 600_000.0, 600_000.0,
                             device=torch.device("cpu"))
    h = _cut(n, n // 2 + 1)
    sr, si = _float_planes(np.random.default_rng(n + 17), (states, n, h), 2)
    return sr, si, t.rlap[:, :h].contiguous(), t.kx, t.ky[:h].contiguous()


FIELD_FORMS = {"ka_diag": (1, [(0, 4)], False),
               "ka6": (2, [(0, 6)], False),
               "ka_quad": (1, [(0, 4)], True),
               "ka_quad_split": (1, [(0, 2), (2, 2)], True)}


@pytest.mark.parametrize("form", list(FIELD_FORMS))
@pytest.mark.parametrize("n", KA_LENGTHS)
def test_emulated_field_xstages_are_plain(n, form):
    """ka_fields_kernel as ka_diag, ka6, ka_quad and the split's two
    calls on the states at the plan's own C and K (the hny columns cut to
    three tiles, the last one column): their plain versions' (F, h, n)
    stacks, every output written once."""
    from xlab_fftbarotropic_torch.ops import fused_tracer as ft

    states, calls, psi_first = FIELD_FORMS[form]
    sr, si, rlap, kx, ky = _field_inputs(n, states)
    got = torch.cat([emulate_fields(sr, si, rlap, kx, ky, first, count,
                                    psi_first) for first, count in calls])
    if form == "ka6":
        want = ft.ka6_plain(sr, si, rlap, kx, ky)
    elif form == "ka_diag":
        want = ff.ka_diag_plain(sr[0], si[0], rlap, kx, ky)
    else:
        want = [torch.cat(p) for p in zip(*(
            ff.ka_quad_plain(sr[0], si[0], rlap, kx, ky, first, count)
            for first, count in calls))]
    assert got.shape == (sum(c for _, c in calls), sr.shape[-1], n)
    assert _rel(got, torch.complex(*want)) < TOL


@pytest.mark.parametrize("n", [64, 256])
def test_emulated_field_pins(n):
    """The pins of one transform: ka_quad's fields 0-1 are ka_diag's,
    split is quad, ka6's fields 0-3 are ka_diag of S[0] and 4-5 ka_diag's
    fields 0-1 of S[1], and ka of (-(si kx), sr kx) formed in torch, as
    a complex inverse at scale 1, is ka_diag's field 0, all bit for bit."""
    sr, si, rlap, kx, ky = _field_inputs(n, 2)
    diag0 = emulate_fields(sr[:1], si[:1], rlap, kx, ky, 0, 4, False)
    diag1 = emulate_fields(sr[1:], si[1:], rlap, kx, ky, 0, 4, False)
    quad = emulate_fields(sr[:1], si[:1], rlap, kx, ky, 0, 4, True)
    split = torch.cat([emulate_fields(sr[:1], si[:1], rlap, kx, ky, first,
                                      2, True) for first in (0, 2)])
    six = emulate_fields(sr, si, rlap, kx, ky, 0, 6, False)
    k = kx.reshape(-1, 1)
    ka = torch.complex(*emulate_ka(-(si[0] * k), sr[0] * k, False, 1.0))
    assert torch.equal(quad[:2], diag0[:2])
    assert torch.equal(split, quad)
    assert torch.equal(six[:4], diag0) and torch.equal(six[4:], diag1[:2])
    assert torch.equal(ka, diag0[0])


# ----- the shallow-water x-stages: ka_sw_kernel (csrc/ka_sw.cu) and
# ka_fwd_kernel (csrc/ka_kc.cu), the full transposed store -----

def _sw_load(f: int, zr, zi, dr, di, er, ei, rlap, kx, ky, es: float):
    """ka_sw_kernel's tile load (csrc/ka_sw.cu sw_field): field f of the
    SW state at row i, column j, each product and sum rounded on its own
    in the kernel's order: u, v, zeta, eta_scale * eta."""
    def load(i, j):
        if f == 2:
            return torch.complex(zr[i, j], zi[i, j])
        if f == 3:
            return torch.complex(er[i, j] * es, ei[i, j] * es)
        k, q, r = kx[i], ky[j], rlap[i, j]
        a, b, c, d = zr[i, j], zi[i, j], dr[i, j], di[i, j]
        if f == 0:
            return torch.complex((b * q) * r - (d * k) * r,
                                 -((a * q) * r) + (c * k) * r)
        return torch.complex(-((b * k) * r) - (d * q) * r,
                             (a * k) * r + (c * q) * r)
    return load


def emulate_sw_fields(state, rlap, kx, ky, es: float):
    """ka_sw_kernel on the six state planes (n, hny): the four fields,
    field fastest, the inverse transform: (4, hny, n)."""
    n, hny = state[0].shape
    loads = [_sw_load(f, *state, rlap, kx, ky, es) for f in range(4)]
    return _emulate_stack(loads, n, hny, False)


def _product_load(p: int, u, v, zeta, eta_s, ies: float, f0: float,
                  grav: float, split: bool):
    """ka_fwd_kernel's and ky_all_kernel's tile load (csrc/epilogue.cuh
    sw_product): product p of the fields at row i, column j (x-major for
    ka_fwd, y-major for ky_all), zero imaginary part, each product and
    sum rounded on its own in the kernel's order."""
    def load(i, j):
        a, b = u[i, j], v[i, j]
        if p < 2:
            q = zeta[i, j] if split else zeta[i, j] + f0
            val = q * (a if p == 0 else b)
        elif p < 4:
            val = (eta_s[i, j] * ies) * (a if p == 2 else b)
        else:
            ke = 0.5 * (a * a + b * b)
            val = ke if split else grav * (eta_s[i, j] * ies) + ke
        return torch.complex(val, torch.zeros_like(val))
    return load


def emulate_ka_fwd(fields, ies: float, f0: float, grav: float,
                   split: bool):
    """ka_fwd_kernel on the x-major (nx, ny) u, v, zeta, eta_s: the five
    products, product fastest, the forward transform: (5, ny, nx)."""
    nx, ny = fields[0].shape
    loads = [_product_load(p, *fields, ies, f0, grav, split)
             for p in range(5)]
    return _emulate_stack(loads, nx, ny, True)


def _sw_inputs(n):
    """The six SW state planes at the bench's magnitudes (zeta 1e-4, div
    1e-6, eta 5 m), the hny columns cut to h = _cut(n, hny) (the last
    tile one column), rlap, kx, ky of an n x n grid and the pairing
    equalizer."""
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    _, _, rlap, kx, ky = _field_inputs(n, 1)
    amps = (1e-4, 1e-4, 1e-6, 1e-6, 5.0, 5.0)
    state = [a * p for a, p in zip(amps, _float_planes(
        np.random.default_rng(n + 23), (n, rlap.shape[1]), 6))]
    return state, rlap, kx, ky, float(fs.eta_pair_scale(state))


def _x_fields(n):
    """u, v (3 m/s), zeta and eta_s (1e-4) x-major (n, ny), the ny = n
    columns cut to _cut(n, n), and ies, f0, g of the bench."""
    u, v, zeta, eta_s = _float_planes(np.random.default_rng(n + 29),
                                      (n, _cut(n, n)), 4)
    return [3.0 * u, 3.0 * v, 1e-4 * zeta, 1e-4 * eta_s], 2.0 ** 15, 1e-4, 9.81


def _assert_each_close(got, want):
    """Each field or product on its own (their sizes differ by 1e5)."""
    assert got.shape == want.shape
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("n", KA_LENGTHS)
def test_emulated_ka_sw_is_ka_sw_plain(n):
    """ka_sw's tile kernel on the SW state at the plan's own C and K (the
    hny columns cut to three tiles, the last one column): ka_sw_plain's
    (4, h, n) stack, every output written once."""
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    state, rlap, kx, ky, es = _sw_inputs(n)
    got = emulate_sw_fields(state, rlap, kx, ky, es)
    want = torch.complex(*fs.ka_sw_plain(*state, rlap, kx, ky, es))
    assert got.shape == (4, rlap.shape[1], n)
    _assert_each_close(got, want)


@pytest.mark.parametrize("split", [False, True], ids=["full", "split"])
@pytest.mark.parametrize("n", KA_LENGTHS)
def test_emulated_ka_fwd_is_ka_fwd_plain(n, split):
    """ka_fwd's tile kernel on x-major (n, ny) fields at the plan's own C
    and K (ny cut to two tiles), split off and on: ka_fwd_plain's (5, ny,
    n) stack, every output written once."""
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    fields, ies, f0, grav = _x_fields(n)
    got = emulate_ka_fwd(fields, ies, f0, grav, split)
    want = torch.complex(*fs.ka_fwd_plain(*fields, ies, f0, grav, split))
    assert got.shape == (5, fields[0].shape[1], n)
    _assert_each_close(got, want)


@pytest.mark.parametrize("n", [64, 256])
def test_emulated_sw_pins(n):
    """The pins of one transform: ka_sw's field f is ka (complex inverse,
    scale 1) of sw_fields' field f formed in torch, so field 2 is ka of
    (zr, zi) and field 3 ka of (er, ei) at scale eta_scale (a power of
    two); ka_fwd's product p is ka (real forward, scale 1) of
    sw_products' product p, split off and on; all bit for bit."""
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    state, rlap, kx, ky, es = _sw_inputs(n)
    got = emulate_sw_fields(state, rlap, kx, ky, es)
    re_, im = fs.sw_fields(*state, rlap, kx, ky, es)
    for f in range(4):
        ka = torch.complex(*emulate_ka(re_[f], im[f], False, 1.0))
        assert torch.equal(got[f], ka), f
    zr, zi, _, _, er, ei = state
    assert torch.equal(got[2], torch.complex(*emulate_ka(zr, zi, False,
                                                         1.0)))
    assert torch.equal(got[3], torch.complex(*emulate_ka(er, ei, False, es)))
    fields, ies, f0, grav = _x_fields(n)
    for split in (False, True):
        got = emulate_ka_fwd(fields, ies, f0, grav, split)
        prods = fs.sw_products(*fields, ies, f0, grav, split)
        for p in range(5):
            ka = torch.complex(*emulate_ka(prods[p], None, True, 1.0))
            assert torch.equal(got[p], ka), (split, p)


# ----- the last one-column forward stages on the column tile:
# ky_all_kernel (csrc/ky_all.cu, the transposed half store of five
# products) and ka_adv_kernel (csrc/ka_kc.cu, the full transposed store)
# -----

def emulate_ky_all(fields, ies: float, f0: float, grav: float,
                   split: bool):
    """ky_all_kernel on the y-major (ny, nx) u, v, zeta, eta_s: the five
    products (sw_product's rounding), product fastest, the forward
    transform and the half store into flat (5 nx, ny/2 + 1) planes:
    (5, nx, ny/2 + 1)."""
    ny, nx = fields[0].shape
    loads = [_product_load(p, *fields, ies, f0, grav, split)
             for p in range(5)]
    return _emulate_stack(loads, ny, nx, True, half=True)


def emulate_ka_adv(u, zx, v, zy, src, beta: float):
    """ka_adv_kernel on the x-major (nx, ny) fields: the advection
    (xfb::advection's rounding), the forward transform along x and the
    full transposed store: (ny, nx)."""
    nx, ny = u.shape
    return _emulate_stack([_advection_load(u, zx, v, zy, src, beta)], nx,
                          ny, True)[0]


# (transform length, columns): columns cut to two whole tiles and a ragged
# third (three live columns), and one grid with more columns than the length
FORWARD_SHAPES = [(n, _cut(n, n + 3)) for n in KA_LENGTHS] + [(64, 133)]


def _sw_fields_at(shape, seed):
    """u, v (3 m/s), zeta and eta_s (1e-4) planes of `shape`, and ies,
    f0, g of the bench."""
    u, v, zeta, eta_s = _float_planes(np.random.default_rng(seed), shape, 4)
    return [3.0 * u, 3.0 * v, 1e-4 * zeta, 1e-4 * eta_s], 2.0 ** 15, 1e-4, 9.81


@pytest.mark.parametrize("split", [False, True], ids=["full", "split"])
@pytest.mark.parametrize("shape", FORWARD_SHAPES, ids=str)
def test_emulated_ky_all_is_ky_all_plain(shape, split):
    """ky_all's tile kernel on y-major (ny, nx) fields at the plan of ny
    over the nx columns (the last tile ragged), split off and on:
    ky_all_plain's (5, nx, ny/2 + 1) stack, every output written once
    (a store past nx would land in the next product's plane)."""
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    ny, nx = shape
    fields, ies, f0, grav = _sw_fields_at(shape, ny + nx + 31)
    got = emulate_ky_all(fields, ies, f0, grav, split)
    want = torch.complex(*fs.ky_all_plain(*fields, ies, f0, grav, split))
    assert got.shape == (5, nx, ny // 2 + 1)
    _assert_each_close(got, want)


@pytest.mark.parametrize("beta", [0.0, 1.6])
@pytest.mark.parametrize("shape", FORWARD_SHAPES, ids=str)
def test_emulated_ka_adv_is_ka_adv_plain(shape, beta):
    """ka_adv's tile kernel on x-major (nx, ny) fields at the plan of nx
    over the ny columns (the last tile ragged), beta off and on:
    ka_adv_plain's (ny, nx) planes, every output written once."""
    nx, ny = shape
    f = _float_planes(np.random.default_rng(nx + ny + 37), shape, 5)
    got = emulate_ka_adv(*f, beta)
    assert got.shape == (ny, nx)
    assert _rel(got, torch.complex(*ff.ka_adv_plain(*f, beta))) < TOL


@pytest.mark.parametrize("n", [64, 256])
def test_emulated_ky_all_and_ka_adv_pins(n):
    """The pins of one transform: ky_all's product p is kc (the emulated
    forward y-stage with the half store) of (sw_products' product p, 0),
    split off and on; ka_adv is ka (real forward, scale 1) of the
    advection formed in torch, beta 0 and 1.6; all bit for bit."""
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    fields, ies, f0, grav = _sw_fields_at((n, n), n + 41)
    for split in (False, True):
        got = emulate_ky_all(fields, ies, f0, grav, split)
        prods = fs.sw_products(*fields, ies, f0, grav, split)
        for p in range(5):
            x = torch.complex(prods[p], torch.zeros_like(prods[p]))
            kc = emulate(_dense(x), n, n, True, transposed=True, half=True)
            assert torch.equal(got[p], kc), (split, p)
    f = _float_planes(np.random.default_rng(n + 43), (n, n), 5)
    for beta in (0.0, 1.6):
        adv = _advection(*f, beta)
        ka = torch.complex(*emulate_ka(adv, None, True, 1.0))
        assert torch.equal(emulate_ka_adv(*f, beta), ka), beta
