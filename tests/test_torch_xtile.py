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

The fast tile (csrc/xtile.cuh FAST, fast mode): its tensor-core passes
(pass16_first, pass16_second with m = 512's radix-2 pass folded in)
emulated lane for lane, with the kernel's lane maps, swizzled layout
between the passes and rotated B loads, the A, B and D fragments
placed by the PTX ISA's m16n8k16 layouts, on NaN-started tiles whose
every slot must be written once and none past the tile; bit for bit
ops/fast_tile.py's fast_dft at every length and the fast plain versions
of ka_diag, kb_pair, kb_adv_half and kx_visc on non-square grids with
ragged last tiles, and of the x-first order's ka_quad, x-major kb,
ka_adv, kc (its transposed half store, under kc_visc's epilogue and
over kc_sw's stack) and ka_fwd; and the shared-memory banks each half
warp's loads and stores of the passes hit, from the emulated addresses
(test_fast_passes_hit_distinct_banks). The fast ka, kc, kb and ky_all
run on the plane tile (plane_transposed: rows of a multiple of 4 floats
load as two float planes, by 16-byte copies for ka and kc and by
16-byte stores of four values formed in registers for kb's Hermitian
load and ky_all's products, and the first pass reads them; the half
stores stage only the outputs they keep), emulated in the kernel's
order with every shared word tagged with its last writer
(emulate_planes): bit for bit the fast plain versions at every length,
aligned and not, and the banks of its own accesses.

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
from xlab_fftbarotropic_torch.ops import fast_tile as fst
from xlab_fftbarotropic_torch.ops import fused_fft as ff
from xlab_fftbarotropic_torch.ops import xtile
from xlab_fftbarotropic_torch.parallel.pencil import padded_half
from torch_threads import _one_thread  # noqa: F401

LENGTHS = [64, 128, 256, 512, 1024, 2048, 4096, 8192]
SHARDS = [1, 2, 4, 8]
TOL = 1e-5


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
# (the natural finish, or the transposed one of the y-stages; the fast ka,
# kc, kb and ky_all: the plane tile's, the strict ones finish_transposed)
PLANES = ("xt::finish_transposed<", "xt::plane_transposed<")
TILE_KERNELS = {"kx_visc.cu": {"kx_visc_kernel": "xt::finish<"},
                "xstage.cu": {"xstage_kernel": "xt::finish<"},
                "ka_kc.cu": {"ka_kernel": PLANES,
                             "ka_adv_kernel": "xt::finish_transposed<",
                             "ka_fwd_kernel": "xt::finish_transposed<",
                             "kc_kernel": PLANES},
                "ka_diag.cu": {"ka_fields_kernel": "xt::finish_transposed<"},
                "ka_sw.cu": {"ka_sw_kernel": "xt::finish_transposed<"},
                "kb_pair.cu": {"kb_pair_kernel": "xt::finish<",
                               "kb_kernel": PLANES},
                "ky_adv.cu": {"ky_adv_kernel": "xt::finish_transposed<"},
                "ky_all.cu": {"ky_all_kernel": PLANES},
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
STORES = ("xt::finish<", "xt::finish_transposed<", "xt::plane_transposed<")


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
    takes the plan; the fast ka, kc, kb and ky_all (FAST, the first
    branch) end in the plane tile's store (plane_transposed), the strict
    ones in finish_transposed; the paired c2r y-stages share the tile's
    Hermitian load, the computing x-stages and ky_all load_rows (the
    strict kb and ky_all; their fast forms through the plane tile's
    loads, HermitianLoad and SwProductLoad, which fall back to them off
    16-byte rows); the one-column
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
            stores = store if isinstance(store, tuple) else (store,)
            assert all(one in body for one in stores), fn
            assert all(other not in body for other in STORES
                       if other not in stores), fn
            if isinstance(store, tuple):
                fast, strict = body.split("} else {", 1)
                assert "if constexpr (FAST)" in fast and store[1] in fast
                assert store[0] in strict and store[1] not in strict
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
                 narrow: bool = False, fast: bool = False):
        p = xtile.xtile_plan(n, columns, elem)
        self.fast = fast
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
        if self.fast:
            return self.subdft_fast(s, forward)
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
        X[k2 + m k1]; the fast tile's op for op (its plain version's
        ops/fast_tile.py mul and dft)."""
        ub = torch.arange(self.mk * self.c)
        col = ub & (self.c - 1)
        k2 = rank * self.mk + (ub >> self.logc)
        if self.fast:                         # gather<K, true>
            z = blocks[:, k2 * self.c + (col ^ _out_swizzle(self, k2))]
        else:
            z = blocks[:, k2 * self.c + col].clone()
        if self.fast:
            v = [(z[r].real, z[r].imag) for r in range(self.k)]
            for r in range(1, self.k):
                w = self.twiddle(r * k2, forward)
                v[r] = fst.mul(v[r], (w.real, w.imag))
            return k2, col, torch.stack([torch.complex(*x) for x in
                                         fst.dft(v, -1 if forward else 1)])
        for r in range(1, self.k):
            z[r] = z[r] * self.twiddle(r * k2, forward)
        return k2, col, _dft_matrix(self.k, -1 if forward else 1) @ z

    def subdft_fast(self, s: torch.Tensor, forward: bool,
                    log: list = None) -> torch.Tensor:
        """subdft<SIGN, true>(): the tensor-core passes lane for lane
        (pass16_first, then pass16_second for m >= 256, with m = 512's
        radix-2 pass folded in; the kernel's lane maps, layouts and
        rotated B loads; A, B and D fragments placed where the PTX
        ISA's m16n8k16 layouts put them, each product exact and summed as
        the plain version's dot16 sums it), every slot of each pass's
        output written exactly once and none past the tile, and left in
        out_swizzle's layout at m = 256, 512 (combine reads it back as
        gather<K, true> does); then the float32 pass of the rest (m = 64,
        128, 1024), op for op. `log`
        collects each shared-memory access instruction: (pass, what,
        slot addresses (warps, 32)), what in "load", "store", "table"."""
        sign = -1 if forward else 1
        fl = _FastLanes(self, sign, log)
        x = fl.first((s.real.clone(), s.imag.clone()),
                     swizzled=self.m >= 256)
        return torch.complex(*self.subdft_rest(fl, x))

    def subdft_rest(self, fl, x):
        """subdft<SIGN, true>() (and xtile.cuh subdft_planes) after the
        first pass: the second tensor-core pass (m >= 256), then the
        float32 pass of the rest (m = 64, 128, 1024), on the (re, im)
        tile x."""
        m, sign = self.m, fl.sign
        if m >= 256:
            x = fl.second(x, fold=m == 512)
            if m == 1024:
                x = self._float_pass(x, 4, 256, sign)
        else:
            x = self._float_pass(x, m // 16, 16, sign)
        return x

    def _float_pass(self, x, r: int, p: int, sign: int):
        """pass<R, SIGN>(t, p) of the (re, im) tile, op for op."""
        c, m, logc = self.c, self.m, self.logc
        ub = torch.arange(m * c // r)
        col, i = ub & (c - 1), ub >> logc
        kk = i & (p - 1)
        v = [(x[0][(i + t * (m // r)) * c + col],
              x[1][(i + t * (m // r)) * c + col]) for t in range(r)]
        for t in range(1, r):
            tw = self.sw[t * kk * (m // (p * r))]
            tw = tw if sign < 0 else tw.conj()
            v[t] = fst.mul(v[t], (tw.real, tw.imag))
        v = fst.dft(v, sign)
        j = (i - kk) * r + kk
        new = torch.full((2, m * c), float("nan"))
        for t in range(r):
            new[0, (j + t * p) * c + col] = v[t][0]
            new[1, (j + t * p) * c + col] = v[t][1]
        return new[0], new[1]

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


# The fragment layouts of mma.sync.m16n8k16 with bf16 operands (PTX ISA,
# "Matrix Fragments for mma.m16n8k16"): the (row, column) of register j,
# half h (0 the lower) of lane g * 4 + q in A (16 x 16), B (16 x 8), and
# of accumulator e in C/D (16 x 8).
def _frag_a(g, q, j: int, h: int):
    return g + 8 * (j & 1), 2 * q + h + 8 * (j >> 1)


def _frag_b(g, q, j: int, h: int):
    return 2 * q + h + 8 * j, g


def _frag_d(g, q, e: int):
    return g + 8 * (e >> 1), 2 * q + (e & 1)


def _cos16(x) -> torch.Tensor:
    """csrc/xtile.cuh cos16: cos(2 pi x / 16) as its bf16 literal."""
    x = x & 15
    x = torch.where(x > 8, 16 - x, x)
    neg = x > 4
    x = torch.where(neg, 8 - x, x)
    bits = torch.tensor(xtile.DFT16_COS_BF16, dtype=torch.int32)[x]
    val = (bits << 16).view(torch.float32).double()
    return torch.where(neg, -val, val)


def _lane_matrix(g, q, shift: int, negate: bool) -> torch.Tensor:
    """The 16 x 16 matrix that dft16()'s registers hold across the warp
    (lane g, q, register r: f = g + 8 (r & 1), t = 2q + 8 (r >> 1), the
    values cos16(f t - shift) and cos16(f (t + 1) - shift), negated for
    -S), each placed by _frag_a; every entry held by exactly one lane."""
    a = torch.full((16, 16), float("nan"), dtype=torch.float64)
    for r in range(4):
        f, t = g + 8 * (r & 1), 2 * q + 8 * (r >> 1)
        for h in (0, 1):
            v = _cos16(f * (t + h) - shift)
            a[_frag_a(g, q, r, h)] = -v if negate else v
    assert not a.isnan().any()
    return a


def _out_swizzle(cl, row):
    """out_swizzle(): the layout of the fast sub-DFT's outputs where its
    second pass is its last (m = 256, 512)."""
    if cl.m not in (256, 512):
        return torch.zeros_like(row)
    if cl.logc == 4:
        return ((row >> 4) & 3) << 2
    if cl.logc == 3:
        return ((row >> 4) & 3) << 1
    return torch.zeros_like(row)


class _FastLanes:
    """csrc/xtile.cuh's fast passes on one block's tile, lane for lane:
    warp w (of m C / 512), lane (g, q) as index tensors (warps, 32)."""

    def __init__(self, cl, sign: int, log):
        self.cl, self.sign, self.log = cl, sign, log
        self.lq = cl.logc - 2
        warps = cl.m * cl.c // 512
        lane = torch.arange(32).view(1, 32)
        self.w = torch.arange(warps).view(warps, 1).expand(warps, 32)
        self.g = (lane >> 2).expand(warps, 32)
        self.q = (lane & 3).expand(warps, 32)
        self.warps = warps
        cm, s_, ns = (_lane_matrix(lane[0] >> 2, lane[0] & 3, 0, False),
                      _lane_matrix(lane[0] >> 2, lane[0] & 3, 4, False),
                      _lane_matrix(lane[0] >> 2, lane[0] & 3, 4, True))
        # dft16_group: Wi = -SIGN S
        self.cm, self.wi, self.mwi = ((cm, ns, s_) if sign < 0
                                      else (cm, s_, ns))

    def plain(self, h, n):                   # plain_butterfly(): (i, col)
        cl, lq = self.cl, self.lq
        i = (self.w << (5 - cl.logc)) + (h >> lq) + (n >> 2) * (4 >> lq)
        return i, 4 * (h & ((1 << lq) - 1)) + ((n & 3) ^ (n >> 2))

    def fold(self, h, n):                    # fold_butterfly(): (i, col)
        cl, lq, x = self.cl, self.lq, n >> 1
        if cl.logc == 3:
            k = 2 * self.w + (x & 1)
            c = 4 * (h & 1) + 2 * (h >> 1) + (x >> 1)
        else:
            k = (self.w << (4 - cl.logc)) + (h >> lq)
            c = 4 * (h & ((1 << lq) - 1)) + x
        return k + (n & 1) * (cl.m // 32), c

    def swizzle(self, row):
        logc = self.cl.logc
        if logc == 4:
            return ((row & 3) << 2) | (((row >> 4) & 1) << 1)
        if logc == 3:
            return (((row >> 1) & 1) << 2) | ((row >> 4) & 1)
        return torch.zeros_like(row)

    def out_swizzle(self, row):
        return _out_swizzle(self.cl, row)

    def note(self, what: str, addr) -> None:
        if self.log is not None:
            self.log.append((self.step, what, addr))

    def table(self, idx):
        """W_m^idx of the staged table, conjugated for sign +1."""
        self.note("table", self.cl.m * self.cl.c + idx)
        w = self.cl.sw[idx]
        return w if self.sign < 0 else w.conj()

    @staticmethod
    def put_slots(loaded: list, slots: list) -> list:
        """put_slot() at each step s: the fragment loaded for group
        slots[s] (per lane) into that group's registers, each written
        exactly once."""
        out = [None] * 4
        for x, slot in zip(loaded, slots):
            for h in range(4):
                on = (slot == h).unsqueeze(-1)
                out[h] = torch.where(on, x, out[h] if out[h] is not None
                                     else torch.full_like(x, float("nan")))
        assert not any(o.isnan().any() for o in out)
        return out

    def load_b(self, x, i, col, swz: bool, tw):
        """load_b(): (warps, 32, 8): the bf16 (re x4, im x4) of inputs t
        = 2q, 2q + 1, 2q + 8, 2q + 9, each times tw[e] for t > 0."""
        cl = self.cl
        re, im = [], []
        for e in range(4):
            tt = 2 * self.q + (e & 1) + 8 * (e >> 1)
            row = i + tt * (cl.m // 16)
            c = col ^ self.swizzle(row) if swz else col
            if callable(x):                   # the plane tile's reads
                v = x(row, c)
            else:
                addr = (row << cl.logc) + c
                assert (addr < cl.m * cl.c).all()
                self.note("load", addr)
                v = (x[0][addr], x[1][addr])
            if tw is not None:
                w = tw[e]
                t = fst.mul(v, (w.real, w.imag))
                v = tuple(torch.where(tt > 0, a, b) for a, b in zip(t, v))
            re.append(v[0].to(torch.bfloat16).double())
            im.append(v[1].to(torch.bfloat16).double())
        return torch.stack(re + im, dim=-1)

    def mma(self, b):
        """dft16_group() of one group whose B values b (warps, 32, 8) the
        lanes hold: D (yr, yi), each (warps, 32, 4) in the lane's e order."""
        nan = float("nan")
        br, bi = (torch.full((16, self.warps, 8), nan, dtype=torch.float64)
                  for _ in range(2))
        wv = self.w
        for e in range(4):
            row, cl = _frag_b(self.g, self.q, e >> 1, e & 1)
            br[row, wv, cl] = b[..., e]
            bi[row, wv, cl] = b[..., 4 + e]
        assert not (br.isnan().any() or bi.isnan().any())
        yr = fst.dot16(self.cm, br.view(16, -1), self.mwi,
                       bi.view(16, -1)).view(16, self.warps, 8)
        yi = fst.dot16(self.wi, br.view(16, -1), self.cm,
                       bi.view(16, -1)).view(16, self.warps, 8)
        out = []
        for y in (yr, yi):
            out.append(torch.stack([y[_frag_d(self.g, self.q, e)[0], wv,
                                      _frag_d(self.g, self.q, e)[1]]
                                    for e in range(4)], dim=-1))
        return out

    def _new(self):
        n = self.cl.m * self.cl.c
        return (torch.full((2, n), float("nan")),
                torch.zeros(n, dtype=torch.int64))

    def _store(self, new, writes, addr, re, im) -> None:
        assert (addr < self.cl.m * self.cl.c).all()   # nothing past it
        self.note("store", addr)
        new[0, addr] = re
        new[1, addr] = im
        writes.index_put_((addr.flatten(),),
                          torch.ones(addr.numel(), dtype=torch.int64),
                          accumulate=True)

    def first(self, x, swizzled: bool):
        """pass16_first(): p = 1, the plain map."""
        self.step = "first"
        b = []
        for s in range(4):
            i, col = self.plain((self.q + s) & 3, self.g)
            b.append(self.load_b(x, i, col, False, None))
        b = self.put_slots(b, [(self.q + s) & 3 for s in range(4)])
        new, writes = self._new()
        for h in range(4):
            yr, yi = self.mma(b[h])
            for e in range(4):
                i, col = self.plain(torch.full_like(self.g, h),
                                    2 * self.q + (e & 1))
                row = 16 * i + self.g + 8 * (e >> 1)
                c = col ^ self.swizzle(row) if swizzled else col
                self._store(new, writes, (row << self.cl.logc) + c,
                            yr[..., e].float(), yi[..., e].float())
        assert (writes == 1).all()
        return new[0], new[1]

    def second(self, x, fold: bool):
        """pass16_second<SIGN, FOLD>(): p = 16, from the swizzled layout
        to the tile's rows; FOLD: pass<2> at p = m/2 on the D values."""
        cl, p = self.cl, 16
        self.step = "second"
        b = []
        for s in range(4):
            h = (self.q + s) & 3
            if fold:
                i, col = self.fold(h, self.g)
            else:
                i, col = self.plain(h, self.g)
            kk = i & (p - 1)
            tw = [self.table((2 * self.q + (e & 1) + 8 * (e >> 1)) * kk
                             * (cl.m // 256)) for e in range(4)]
            b.append(self.load_b(x, i, col, True, tw))
        b = self.put_slots(b, [(self.q + s) & 3 for s in range(4)])
        new, writes = self._new()
        for h in range(4):
            yr, yi = self.mma(b[h])
            yr, yi = yr.float(), yi.float()
            if fold:
                k, c = self.fold(torch.full_like(self.g, h), 2 * self.q)
                for fe in range(2):
                    r = k + p * (self.g + 8 * fe)
                    w = self.table(r)
                    x0 = (yr[..., 2 * fe], yi[..., 2 * fe])
                    x1 = fst.mul((yr[..., 2 * fe + 1], yi[..., 2 * fe + 1]),
                                 (w.real, w.imag))
                    r2 = r + cl.m // 2
                    self._store(new, writes, (r << cl.logc)
                                + (c ^ self.out_swizzle(r)),
                                x0[0] + x1[0], x0[1] + x1[1])
                    self._store(new, writes, (r2 << cl.logc)
                                + (c ^ self.out_swizzle(r2)),
                                x0[0] - x1[0], x0[1] - x1[1])
            else:
                for e in range(4):
                    i, col = self.plain(torch.full_like(self.g, h),
                                        2 * self.q + (e & 1))
                    k = i & (p - 1)
                    row = (i - k) * 16 + k + p * (self.g + 8 * (e >> 1))
                    self._store(new, writes, (row << cl.logc)
                                + (col ^ self.out_swizzle(row)),
                                yr[..., e], yi[..., e])
        assert (writes == 1).all()
        return new[0], new[1]


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
            elem: int = 0, fast: bool = False) -> torch.Tensor:
    """The column-tile transform along the length-n axis of `columns`
    columns whose tile rows come from load(rows, columns), unnormalized,
    as csrc/xtile.cuh computes it (index for index), with the plan of
    `elem`-byte elements (default: 4 for the transposed store, 8 else).
    Natural store (finish): (n, columns). Transposed store
    (finish_transposed): (columns, n), or (columns, n/2 + 1) with
    `half`. Every output kept is written exactly once. `fast`: the fast
    tile (subdft_fast)."""
    e = _Cluster(n, columns, elem or (4 if transposed else 8), fast=fast)
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


# the writer of each shared word of the plane tile (_Planes.tag): none
# yet, the loads, a pass's output, the staged outputs
FREE, LOADED, PASS, STAGED = range(4)


class _Planes:
    """One block's shared memory in csrc/xtile.cuh plane_transposed (the
    fast ka_kernel, kc_kernel, kb_kernel and ky_all_kernel), as float
    words: the tile's m C values and the W_m table behind them, each word
    NaN until written and tagged with its last writer, so that every read
    is held to it: the first pass reads only loads, the store only staged
    outputs. `vec` (rows of a multiple of 4 floats): the loads land as
    planes, the tile's m C real parts (row j, column c at word j C + c),
    then (not real) its m C imaginary parts; else in the tile's layout
    (value j C + c, 0 imaginary parts for the real input). `computed`:
    the load forms its values (kb's Hermitian load, ky_all's products:
    load_quads' 16-byte stores of four columns into each plane, or one
    8-byte store per value into the tile's layout) where the others copy
    them (load_planes' cp.async). `log` collects the shared-memory access
    instructions: (step, what, addresses (warps, 32)): words for "copy"
    and "quad store" (each 16-byte access's first word), "word store" and
    "word load", values else."""

    def __init__(self, cl, real: bool, vec: bool, log=None,
                 computed: bool = False):
        m, c = cl.m, cl.c
        self.cl, self.real, self.vec, self.log = cl, real, vec, log
        self.computed = computed
        self.plane = m * c
        self.words = torch.full((2 * (m * c + m),), float("nan"))
        self.tag = torch.full(self.words.shape, FREE, dtype=torch.int64)

    def note(self, step, what, addr) -> None:
        if self.log is not None:
            self.log.append((step, what, addr.reshape(-1, 32)))

    def load(self, load, tile: int, rank: int) -> None:
        """load_planes(), or the computing loads (`computed`): block
        `rank`'s rows rank + K j of columns j0 .. j0 + C from load(rows,
        columns), 0 past the columns; `vec`: thread v's four columns of
        quad v mod C/4 of row v div C/4 (v = e threads + thread, e = 0..3)
        in one 16-byte access per plane (load_planes: a copy, each plane
        in turn; load_quads: a store into each plane); else thread v's
        value of column v mod C of row v div C (load_planes: a float copy
        of re, then of im; load_hermitian, load_rows: one 8-byte store)."""
        cl, lq = self.cl, self.cl.logc - 2
        threads = cl.m * cl.c // 16
        if not self.vec:
            for e in range(16):
                v = e * threads + torch.arange(threads)
                rows = rank + cl.k * (v >> cl.logc)
                cols = tile * cl.c + (v & (cl.c - 1))
                x = torch.where(cols < cl.columns,
                                load(rows, cols.clamp(max=cl.columns - 1)),
                                torch.zeros((), dtype=torch.complex64))
                if self.computed:
                    self.note("load", "store", v)
                else:
                    self.note("load", "word store", 2 * v)
                    if not self.real:
                        self.note("load", "word store", 2 * v + 1)
                self.words[2 * v] = x.real
                self.words[2 * v + 1] = 0.0 if self.real else x.imag
                self.tag[2 * v] = self.tag[2 * v + 1] = LOADED
            return
        planes = 1 if self.real else 2
        steps = ([(e, pl) for e in range(4) for pl in range(planes)]
                 if self.computed else
                 [(e, pl) for pl in range(planes) for e in range(4)])
        for e, pl in steps:
            v = e * threads + torch.arange(threads)
            quad, j = v & ((1 << lq) - 1), v >> lq
            cols = tile * cl.c + 4 * quad
            at = pl * self.plane + (j << cl.logc) + 4 * quad
            self.note("load", "quad store" if self.computed else "copy", at)
            rows = rank + cl.k * j
            for w in range(4):
                x = torch.where(
                    cols + w < cl.columns,
                    load(rows, (cols + w).clamp(max=cl.columns - 1)),
                    torch.zeros((), dtype=torch.complex64))
                self.words[at + w] = x.imag if pl else x.real
                self.tag[at + w] = LOADED

    def __call__(self, row, c):
        """The first pass's read of a B fragment's input (row, column):
        PlaneIn's words from the planes (`vec`), else load_b's value of
        the tile: (re, im)."""
        at = (row << self.cl.logc) + c
        if not self.vec:
            self.note("first", "load", at)
            words = [2 * at, 2 * at + 1]
        elif self.real:
            words = [at]
        else:
            words = [at, at + self.plane]
        for w in words:
            if self.vec:
                self.note("first", "word load", w)
            assert (self.tag[w] == LOADED).all()
        re = self.words[words[0]]
        im = (torch.zeros_like(re) if self.vec and self.real
              else self.words[words[1]])
        return re, im

    def put_tile(self, x) -> None:
        """A pass's (re, im) output into the tile's m C values."""
        n = self.plane
        self.words[0:2 * n:2], self.words[1:2 * n:2] = x
        self.tag[:2 * n] = PASS

    def tile(self) -> torch.Tensor:
        n = self.plane
        assert (self.tag[:2 * n] == PASS).all()
        return torch.complex(self.words[0:2 * n:2], self.words[1:2 * n:2])

    def stage(self, k2, col, z, rank: int, half: bool) -> None:
        """combine_staged (full: every X[k2 + m k1] at c (m + 16/C) + k1
        m/K + k2 - q m/K) or combine_staged_half (half: stride m/2 +
        16/C, only the outputs the half store keeps: staged index < m/2,
        and m/2 on rank 0), thread u = (kk, c) storing its K values in k1
        order; inside the tile and the 16 values of the (dead) table
        behind it."""
        cl = self.cl
        stride = (cl.m // 2 if half else cl.m) + 16 // cl.c
        i0 = k2 - rank * cl.mk
        for k1 in range(cl.k):
            i = k1 * cl.mk + i0
            keep = ((i < cl.m // 2) | ((i == cl.m // 2) & (rank == 0))
                    if half else torch.ones_like(i, dtype=torch.bool))
            slot = col * stride + i
            self.note("stage", "store", torch.where(keep, slot, -1))
            at = 2 * slot[keep]
            assert (at < 2 * (self.plane + 16)).all()
            self.words[at] = z[k1][keep].real
            self.words[at + 1] = z[k1][keep].imag
            self.tag[at] = self.tag[at + 1] = STAGED

    def store(self, tile: int, rank: int, half: bool, out, writes,
              plane: int) -> None:
        """store_staged(): the staged column c's first m/2 values (half;
        and rank 0's at m/2 to k = n/2) or all m, in k order, to out[plane
        + j0 + c, k]; columns past the last skipped."""
        cl = self.cl
        stride = (cl.m // 2 if half else cl.m) + 16 // cl.c
        length = cl.m // 2 if half else cl.m
        u = torch.arange(length * cl.c)
        co, i = u // length, u % length
        kout = rank * cl.mk + i % cl.mk + cl.m * (i // cl.mk)
        slots = [(co, co * stride + i, kout)]
        if half and rank == 0:
            co = torch.arange(cl.c)
            slots.append((co, co * stride + cl.m // 2,
                          torch.full_like(co, cl.n // 2)))
        j0 = tile * cl.c
        for co, slot, kout in slots:
            at = 2 * slot
            assert (self.tag[at] == STAGED).all()
            assert (self.tag[at + 1] == STAGED).all()
            live = j0 + co < cl.columns
            _put(out, writes, (plane + j0 + co[live], kout[live]),
                 torch.complex(self.words[at], self.words[at + 1])[live])


def emulate_planes(load, n: int, columns: int, forward: bool, half: bool,
                   real: bool, out=None, writes=None, plane: int = 0,
                   log=None, computed: bool = False):
    """plane_transposed<SIGN, HALF>() (the fast ka_kernel, kc_kernel;
    `computed`: kb_kernel's Hermitian load, ky_all_kernel's product load)
    over the `columns` columns of a length-n transform whose tile rows
    come from load(rows, columns) (`real`: their real parts alone), in the
    kernel's order: the loads (as planes by 16-byte copies or stores
    where the columns are a multiple of 4, else into the tile's layout),
    the first
    pass from them (its B fragments as PlaneIn or load_b reads them), the
    rest of the sub-DFT, the exchange over the
    K blocks' tiles, the staging (half: only the outputs kept) and the
    store. Written into out, writes (new ones when None): (columns, n/2 +
    1) with `half`, else (columns, n); every output kept is written
    exactly once."""
    cl = _Cluster(n, columns, 4, fast=True)
    width = n // 2 + 1 if half else n
    fresh = out is None
    if fresh:
        out, writes = _outputs(cl.tiles * cl.c, width)
    for tile in range(cl.tiles):
        blocks = [_Planes(cl, real, columns % 4 == 0, log, computed)
                  for _ in range(cl.k)]
        for rank, b in enumerate(blocks):
            b.load(load, tile, rank)
            fl = _FastLanes(cl, -1 if forward else 1, log)
            b.put_tile(fl.first(b, swizzled=cl.m >= 256))
            t = b.tile()
            b.put_tile(cl.subdft_rest(fl, (t.real, t.imag)))
        tiles = torch.stack([b.tile() for b in blocks])
        combined = [cl.combine(tiles, rank, forward)
                    for rank in range(cl.k)]
        for rank, b in enumerate(blocks):
            b.stage(*combined[rank], rank, half)
            b.store(tile, rank, half, out, writes, plane)
    if fresh:
        return _written_once(out, writes, columns, width)
    return None


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


def emulate_kb_adv(wr, wi, zx, zy, src, beta: float,
                   fast: bool = False) -> torch.Tensor:
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
    e = _Cluster(ny, nx, 4, narrow=True, fast=fast)
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


def _emulated_kb_pair(wr, wi, fa: int, fb: int, scale: float,
                      fast: bool = False):
    """kb_pair_kernel: the Hermitian tile of fields fa, fb, the inverse
    transform and the natural store, Re * scale and Im * scale: y-major
    (ny, nx)."""
    ny = 2 * (wr.shape[1] - 1)
    got = emulate(_hermitian(wr[fa], wi[fa], wr[fb], wi[fb]), ny,
                  wr.shape[2], False, elem=4, fast=fast)
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

def emulate_kb_adv_tracer(zx, zy, qx, qy, wr, wi, src, beta: float,
                          fast: bool = False) -> torch.Tensor:
    """kb_adv_tracer_kernel on ka6's (6, ny/2 + 1, nx) stack, in tiles of
    half the plan's columns: the Hermitian tile of fields 2, 3, its
    inverse sub-DFT and combine; u, v times 1/(nx ny); adv_z with src (0
    for None) and beta, adv_q with 0 and no beta, at each (y, c) block q
    holds; each product to block y mod K, slot (y div K) C + c of its own
    tile, every slot written exactly once; the forward transform of each
    tile and the half store into flat (2 nx, ny/2 + 1) planes, adv_z at
    row x, adv_q at row nx + x (a store past nx would land in the next
    plane): (2, nx, ny/2 + 1). `fast`: kb_adv_tracer_kernel<true>, every
    sub-DFT on the fast tile (subdft_fast)."""
    _, hny, nx = wr.shape
    ny = 2 * (hny - 1)
    scale = 1.0 / (nx * ny)
    e = _Cluster(ny, nx, 4, narrow=True, fast=fast)
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


def emulate_ka(xr, xi, forward: bool, scale: float, fast: bool = False):
    """ka_kernel: the tile of the (n, m) planes (xi None: zero imaginary
    parts), the transform, the full transposed store of Re * scale and Im
    * scale: (m, n) planes; `fast`: ka_kernel<SIGN, true>, the plane tile
    (emulate_planes)."""
    n, m = xr.shape
    x = torch.complex(xr, torch.zeros_like(xr) if xi is None else xi)
    if fast:
        got = emulate_planes(_dense(x), n, m, forward, False, xi is None)
    else:
        got = emulate(_dense(x), n, m, forward, transposed=True)
    return _scaled(got, scale)


def emulate_kc_fast(xr, xi):
    """kc_kernel<true> on (F, ny, nx) planes (kc_sw's stack; F = 1: kc,
    kc_visc before its epilogue): each field's plane tiles
    (emulate_planes) with the half store into flat (F nx, ny/2 + 1)
    planes: (F, nx, ny/2 + 1), every output written exactly once."""
    count, n, cols = xr.shape
    width = n // 2 + 1
    out, writes = _outputs(count * cols, width)
    for f in range(count):
        emulate_planes(_dense(torch.complex(xr[f], xi[f])), n, cols, True,
                       True, False, out, writes, plane=f * cols)
    return _written_once(out, writes, count * cols, width).reshape(
        count, cols, width)


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
                   half: bool = False, fast: bool = False):
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
    e = _Cluster(n, columns, 4, fast=fast)
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
                   psi_first: bool, fast: bool = False):
    """ka_fields_kernel on the states (nstate, n, hny): fields first ..
    first + count - 1 (field g reads state g div 4, kind g mod 4), the
    inverse transform: (count, hny, n)."""
    _, n, hny = sr.shape
    loads = [_field_load(sr[g // 4], si[g // 4], rlap, kx, ky, g % 4,
                         psi_first) for g in range(first, first + count)]
    return _emulate_stack(loads, n, hny, False, fast=fast)


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
                   split: bool, fast: bool = False):
    """ka_fwd_kernel on the x-major (nx, ny) u, v, zeta, eta_s: the five
    products, product fastest, the forward transform: (5, ny, nx).
    `fast`: ka_fwd_kernel<true>."""
    nx, ny = fields[0].shape
    loads = [_product_load(p, *fields, ies, f0, grav, split)
             for p in range(5)]
    return _emulate_stack(loads, nx, ny, True, fast=fast)


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


def emulate_ka_adv(u, zx, v, zy, src, beta: float, fast: bool = False):
    """ka_adv_kernel on the x-major (nx, ny) fields: the advection
    (xfb::advection's rounding), the forward transform along x and the
    full transposed store: (ny, nx). `fast`: ka_adv_kernel<true>."""
    nx, ny = u.shape
    return _emulate_stack([_advection_load(u, zx, v, zy, src, beta)], nx,
                          ny, True, fast=fast)[0]


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


# ----- the fast column tile (csrc/xtile.cuh FAST: the radix-16 passes on
# the tensor cores), emulated lane for lane: rows 1, 2, 9, 4 of fast
# mode -----

# (transform length, columns): ragged last tiles, non-square grids
FAST_SHAPES = [(64, 44), (256, 200), (1024, 33)]


def test_fast_plan_and_dft16_agree_with_the_kernel_source():
    """The fast passes are radix 16 while 16 divides what is left, then
    one float32 pass of the rest, from m alone; the DFT-16 matrix's bf16
    literals in csrc/xtile.cuh are cos(2 pi x / 16), x = 0..4, rounded
    once from float64 (the zero exact); the four fast entries exist and
    take the plan."""
    for n in LENGTHS:
        p = xtile.xtile_plan(n, 1, 4)
        r = xtile.fast_radices(p.m)
        assert p.fast_radices == r and int(np.prod(r)) == p.m
        assert all(x == 16 for x in r[:-1]) and r[-1] in (2, 4, 8, 16)
        assert r.count(16) == int(np.log2(p.m)) // 4
    assert xtile.DFT16_COS_BF16 == (0x3F80, 0x3F6D, 0x3F35, 0x3EC4, 0)
    src = _source("xtile.cuh")
    for bits in xtile.DFT16_COS_BF16[:4]:
        assert f"0x{bits:04X}u" in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "__floats2bfloat162_rn" in src
    for name, entry in (("ka_diag.cu", "xfb_ka_diag_fast"),
                        ("kb_pair.cu", "xfb_kb_pair_fast"),
                        ("kb_adv.cu", "xfb_kb_adv_half_fast"),
                        ("kx_visc.cu", "xfb_kx_visc_fast"),
                        ("ka_diag.cu", "xfb_ka6_fast"),
                        ("kb_adv_tracer.cu", "xfb_kb_adv_tracer_fast"),
                        ("ky_adv.cu", "xfb_ky_adv_fast"),
                        ("kb_adv.cu", "xfb_kb_adv_full_fast"),
                        ("kx_visc.cu", "xfb_kx_visc_tail_fast")):
        sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)',
                        _source(name))
        assert "int tile_c, int cluster_k" in " ".join(sig.group(1).split())
        assert entry in _build.SIGNATURES


def test_fast_fragments_hold_the_dft16_matrix():
    """dft16()'s registers, placed by the PTX fragment layout, hold C =
    cos and S = sin of 2 pi f t / 16 rounded to bf16 (f the row), and
    every matrix entry is held by exactly one lane."""
    lane = torch.arange(32)
    g, q = lane >> 2, lane & 3
    c, s = fst.dft16_matrices(torch.device("cpu"))
    assert torch.equal(_lane_matrix(g, q, 0, False), c)
    assert torch.equal(_lane_matrix(g, q, 4, False), s)
    assert torch.equal(_lane_matrix(g, q, 4, True), -s)
    f = np.arange(16)
    exact = np.exp(-2j * np.pi * np.outer(f, f) / 16)
    assert np.abs(c.numpy() - exact.real).max() < 2 ** -8
    assert np.abs(s.numpy() + exact.imag).max() < 2 ** -8
    assert (c.numpy()[np.abs(exact.real) < 1e-12] == 0).all()


@pytest.mark.parametrize("forward", [True, False],
                         ids=["forward", "inverse"])
@pytest.mark.parametrize("n", LENGTHS[:5] + [4096, 8192])
def test_emulated_fast_transform_is_the_fast_plain_transform(n, forward):
    """The fast tile, lane for lane (every slot of each radix-16 pass
    written once, none past the tile), on a ragged tile: ops/fast_tile.py
    fast_dft's bits, and within the bf16 class of the float64 DFT."""
    p = xtile.xtile_plan(n, 1, 8)
    columns = p.c + 1 if n < 4096 else 1
    rng = np.random.default_rng(n + 40 + forward)
    x = rng.standard_normal((n, columns)) + 1j * rng.standard_normal(
        (n, columns))
    xt = torch.from_numpy(x.astype(np.complex64))
    got = emulate(_dense(xt), n, columns, forward, fast=True)
    want = torch.complex(*fst.fast_dft(xt.real.contiguous(),
                                       xt.imag.contiguous(),
                                       -1 if forward else 1))
    assert torch.equal(got, want)
    ref = np.fft.fft(x, axis=0) if forward else np.fft.ifft(x, axis=0) * n
    rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
    assert 1e-4 < rel < 1e-2, rel


def _bank_degree(addr: torch.Tensor) -> int:
    """The worst bank conflict of one 8-byte shared-memory access
    instruction, addr (warps, 32) its float2 slots: per half warp (16
    lanes, 128 bytes, one wavefront without conflict), the most distinct
    slots that fall on one of the 16 bank pairs (a slot read by several
    lanes is one broadcast)."""
    worst = 0
    for half in addr.reshape(-1, 2, 16).reshape(-1, 16):
        slots = torch.unique(half)
        worst = max(worst, int(torch.bincount(slots % 16, minlength=16)
                               .max()))
    return worst


@pytest.mark.parametrize("narrow", [False, True], ids=["plan", "narrow"])
@pytest.mark.parametrize("n", LENGTHS)
def test_fast_passes_hit_distinct_banks(n, narrow):
    """The fast passes' shared-memory accesses, read from the emulated
    word addresses of every half warp's loads and stores (the plan's C,
    and kb_adv's tiles of C/2): where two radix-16 passes run (m >= 256,
    n >= 256) every tile load of both and every store of the first hits
    16 distinct bank pairs, and so does every store of the second at C =
    16 and at m = 512 (n = 512..4096: the main paths' lengths, kb_adv's
    C = 8 too); the second pass's stores at m = 256, C = 8 (kb_adv at
    n = 256) meet 2 lanes on a bank pair, at m = 1024 (n = 8192) 4; the
    only pass of m < 256 reads so and writes its rows C/4 ways deep (the
    radix-16 pass before the redesign: 4 ways at every length); the W_m
    table reads (each lane's four input twiddles, the folded radix-2
    pass's two) at most 5 ways deep."""
    p = xtile.xtile_plan(n, 1, 4)
    cl = _Cluster(n, p.c, 4, narrow=narrow, fast=True)
    rng = np.random.default_rng(n + narrow)
    x = torch.from_numpy((rng.standard_normal(cl.m * cl.c) + 1j
                          * rng.standard_normal(cl.m * cl.c))
                         .astype(np.complex64))
    log = []
    cl.subdft_fast(x, True, log)
    worst = {}
    for step, what, addr in log:
        worst[step, what] = max(worst.get((step, what), 0),
                                _bank_degree(addr))
    if cl.m >= 256:
        last = (1 if cl.c == 16 or cl.m == 512 else
                2 if cl.m == 256 else 4)
        assert {k: v for k, v in worst.items() if k[1] != "table"} == {
            ("first", "load"): 1, ("first", "store"): 1,
            ("second", "load"): 1, ("second", "store"): last}
        assert 1 <= worst["second", "table"] <= 5
    else:
        assert worst == {("first", "load"): 1,
                         ("first", "store"): cl.c // 4}


@pytest.mark.parametrize("shape", FAST_SHAPES, ids=str)
def test_emulated_fast_kernels_are_their_plain_versions(shape):
    """ka_diag, kb_pair, kb_adv_half and kx_visc's transform on the fast
    tile, emulated lane for lane on non-square grids whose last tile is
    ragged (every output written exactly once): their fast plain
    versions' bits."""
    n, cols = shape
    rng = np.random.default_rng(n + cols)
    # ka_diag: the fields' inverse x-stage on (n, cols) planes
    sr, si = _float_planes(rng, (1, n, cols), 2)
    kx, = _float_planes(rng, (n,), 1)
    ky, = _float_planes(rng, (cols,), 1)
    rlap = -1.0 / (1.0 + _float_planes(rng, (n, cols), 1)[0] ** 2)
    got = emulate_fields(sr, si, rlap, kx, ky, 0, 4, False, fast=True)
    want = ff.ka_diag(sr[0], si[0], rlap, kx, ky, fast=True)
    assert torch.equal(got, torch.complex(*want))
    # kb_pair and kb_adv_half on a (4, n/2 + 1, cols) stack
    wr, wi = _stack(rng, n, cols, 4, cols * n ** 0.5)
    scale = ff._kb_adv_scale(wr)
    a, b = _emulated_kb_pair(wr, wi, 0, 1, scale, fast=True)
    want = ff.kb_pair(wr, wi, 0, 1, scale, fast=True)
    assert torch.equal(a, want[0]) and torch.equal(b, want[1])
    zx, zy, src = _float_planes(rng, (n, cols), 3)
    got = emulate_kb_adv(wr, wi, zx, zy, src, 1.6, fast=True)
    want = ff.kb_adv_half(zx, zy, wr, wi, src, 1.6, fast=True)
    assert torch.equal(got, torch.complex(*want))
    # kx_visc: the forward x-stage (its epilogue is visc_plain's)
    fr, fi = _float_planes(rng, (n, cols), 2)
    got = emulate(_dense(torch.complex(fr, fi)), n, cols, True, elem=4,
                  fast=True)
    want = fst.fast_dft(fr, fi, -1)
    assert torch.equal(got, torch.complex(*want))


# (ny, nx) of the tracer's fast checks: ragged tiles of C/2 columns, K
# from 1 to 8 (one live column in the last tile at 64 x 15)
FAST_TRACER_SHAPES = [(256, 200), (1024, 33), (64, 15)]


@pytest.mark.parametrize("shape", FAST_TRACER_SHAPES, ids=str)
def test_emulated_fast_kb_adv_tracer_is_its_plain_version(shape):
    """kb_adv_tracer_kernel<true> emulated lane for lane on a ragged grid,
    every output of both planes starting NaN and written exactly once,
    every exchanged product slot of both tiles exactly once
    (emulate_kb_adv_tracer asserts both): kb_adv_tracer_fast_plain's
    bits, src given, beta 1.6; and plane 0 the emulated fast kb_pair of
    fields 2, 3 followed by the emulated fast ky_adv, bit for bit."""
    from xlab_fftbarotropic_torch.ops import fused_tracer as ft

    ny, nx = shape
    wr, wi, zx, zy, qx, qy, src = _tracer_inputs(ny, nx, ny + nx + 67)
    got = emulate_kb_adv_tracer(zx, zy, qx, qy, wr, wi, src, 1.6, fast=True)
    assert not torch.isnan(got).any()
    want = ft.kb_adv_tracer_fast_plain(zx, zy, qx, qy, wr, wi, src, 1.6)
    assert torch.equal(got, torch.complex(*want))
    if ny > 256:
        return
    u, v = _emulated_kb_pair(wr, wi, 2, 3, 1.0 / (nx * ny), fast=True)
    pin = emulate(_advection_load(u, zx, v, zy, src, 1.6), ny, nx, True,
                  transposed=True, half=True, fast=True)
    assert torch.equal(got[0], pin)


def test_fast_kb_adv_tracer_keeps_its_shared_memory_order():
    """kb_adv_tracer_kernel's FAST instance keeps the strict one's order:
    the second tile's sub-DFT and staged store first, then the first
    tile's sub-DFT, then its staged store, which alone runs into the W_m
    table (16 values, dead by then); the fast pass touches only a tile's
    m C slots (subdft_fast asserts it) and reads the table whole. The
    staged columns fit their tile plus 16 values at every length, and the
    second tile's the pad behind it."""
    body = _body(_source("kb_adv_tracer.cu"), r"kb_adv_tracer_kernel\(")
    order = [body.index(k) for k in (
        "xt::subdft<+1, FAST>(t)", "advect<",
        "xt::finish_transposed<-1, FAST>(tq,",
        "xt::finish_transposed<-1, FAST>(t,")]
    assert order == sorted(order)
    for n in LENGTHS:
        for nx in (n, 33):
            p = xtile.xtile_plan(n, nx, 4)
            c = p.c // 2
            staged = c * (p.m + 16 // c)
            assert staged <= p.m * c + 16 <= p.m * c + p.m


@pytest.mark.parametrize("shape", FAST_SHAPES, ids=str)
def test_emulated_fast_arms_are_their_plain_versions(shape):
    """The other barotropic arms' y-stages on the fast tile, emulated
    lane for lane on ragged grids (every output written once): ky_adv's
    (ky_adv_fast_plain's bits) and kb_adv_full's (kb_adv_full_fast_plain's,
    and the emulated fast ky_adv of the emulated fast kb_pairs' outputs,
    bit for bit); ka6's (the six fields, state f // 4) ka6_fast_plain's."""
    from xlab_fftbarotropic_torch.ops import fused_tracer as ft

    n, cols = shape
    rng = np.random.default_rng(n + cols + 1)
    u, zx, v, zy, src = _float_planes(rng, (n, cols), 5)
    got = emulate(_advection_load(u, zx, v, zy, src, 1.6), n, cols, True,
                  transposed=True, half=True, fast=True)
    want = ff.ky_adv(u, zx, v, zy, src, 1.6, fast=True)
    assert torch.equal(got, torch.complex(*want))
    wr, wi = _stack(rng, n, cols, 4, cols * n ** 0.5)
    scale = ff._kb_adv_scale(wr)
    got = emulate_kb_adv(wr, wi, None, None, src, 1.6, fast=True)
    want = ff.kb_adv_full(wr, wi, src, 1.6, fast=True)
    assert torch.equal(got, torch.complex(*want))
    u, v = _emulated_kb_pair(wr, wi, 2, 3, scale, fast=True)
    zx, zy = _emulated_kb_pair(wr, wi, 0, 1, scale, fast=True)
    pin = emulate(_advection_load(u, zx, v, zy, src, 1.6), n, cols, True,
                  transposed=True, half=True, fast=True)
    assert torch.equal(got, pin)
    sr, si = _float_planes(rng, (2, n, cols), 2)
    kx, = _float_planes(rng, (n,), 1)
    ky, = _float_planes(rng, (cols,), 1)
    rlap = -1.0 / (1.0 + _float_planes(rng, (n, cols), 1)[0] ** 2)
    got = emulate_fields(sr, si, rlap, kx, ky, 0, 6, False, fast=True)
    want = ft.tracer_xstage_planes(sr, si, kx, ky, rlap, fast=True)
    assert torch.equal(got, torch.complex(*want))


# ----- the bf16 product store (csrc/xtile.cuh Bf16Out: kx_visc_kernel
# with BF16, the shallow-water kx_fwd under XFB_SW_PSTORE=bf16), emulated
# on flat planes: rows 17b fast and strict -----

def emulate_bf16_store(fr, fi, fast: bool):
    """kx_visc_kernel<FAST, true> on a (F, n, m) stack: each field's
    forward x-stage (the fast tile or the strict one) and Bf16Out's
    stores, X[k] of tile column c rounded once to bf16 at plane + k m +
    j0 + c of the flat re and im planes, plane = f n m, skipped past m.
    The planes start NaN with one field's slots more behind the last,
    and every store is counted: (re, im, writes)."""
    nf, n, m = fr.shape
    size = nf * n * m
    nan = torch.full((size + n * m,), float("nan"), dtype=torch.bfloat16)
    out_r, out_i = nan.clone(), nan.clone()
    writes = torch.zeros(size + n * m, dtype=torch.int64)
    e = _Cluster(n, m, 4, fast=fast)
    for f in range(nf):
        load = _dense(torch.complex(fr[f], fi[f]))
        for tile in range(e.tiles):
            blocks = e.transform(load, tile, True)
            for rank in range(e.k):
                k2, col, z = e.combine(blocks, rank, True)
                j = tile * e.c + col
                live = j < m                      # the ragged last tile
                for k1 in range(e.k):
                    off = (f * n * m + (k2 + e.m * k1) * m + j)[live]
                    out_r[off] = z[k1].real[live].to(torch.bfloat16)
                    out_i[off] = z[k1].imag[live].to(torch.bfloat16)
                    writes.index_put_((off,), torch.ones_like(off),
                                      accumulate=True)
    return out_r, out_i, writes


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "strict"])
@pytest.mark.parametrize("shape", [(2, 64, 33), (2, 256, 129),
                                   (1, 1024, 21)], ids=str)
def test_emulated_bf16_store_writes_each_value_once(shape, fast):
    """kx_fwd's bf16 store over F planes of (n, m) with m columns ending
    in a ragged tile: every value of every plane written exactly once,
    nothing behind the last plane, each the float32 result of its tile
    rounded once to bf16 (the fast tile's: kx_fwd_fast_plain's bf16
    bits)."""
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    nf, n, m = shape
    fr, fi = _float_planes(np.random.default_rng(n + m + fast), shape, 2)
    out_r, out_i, writes = emulate_bf16_store(fr, fi, fast)
    size = nf * n * m
    assert (writes[:size] == 1).all() and (writes[size:] == 0).all()
    assert out_r[size:].isnan().all() and out_i[size:].isnan().all()
    got = (out_r[:size].view(shape), out_i[:size].view(shape))
    x = torch.stack([emulate(_dense(torch.complex(fr[f], fi[f])), n, m,
                             True, elem=4, fast=fast) for f in range(nf)])
    assert torch.equal(got[0], x.real.to(torch.bfloat16))
    assert torch.equal(got[1], x.imag.to(torch.bfloat16))
    if fast:
        want = fs.kx_fwd_fast_plain(fr, fi, "bf16")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fast_sw_entries_agree_with_the_kernel_source():
    """The shallow-water fast entries and the bf16 forms exist with the
    plan's arguments and their ctypes signatures; Bf16Out rounds with
    __float2bfloat16_rn (round to nearest even) and stores 2-byte
    values one by one (a bf16 half-spectrum row is not 4-byte aligned on
    every row)."""
    for name, entry in (("ka_sw.cu", "xfb_ka_sw_fast"),
                        ("ky_all.cu", "xfb_ky_all_fast"),
                        ("kx_visc.cu", "xfb_kx_fwd_fast"),
                        ("kx_visc.cu", "xfb_kx_fwd_bf16")):
        sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)',
                        _source(name))
        assert "int tile_c, int cluster_k" in " ".join(sig.group(1).split())
        assert entry in _build.SIGNATURES
    for entry in ("xfb_sw_combine_bf16", "xfb_sw_combine_mv_bf16"):
        assert f'extern "C" int {entry}(' in _source("sw_combine.cu")
        assert entry in _build.SIGNATURES
    body = _body(_source("xtile.cuh"), "struct Bf16Out")
    assert "__float2bfloat16_rn(v.x)" in body and "j >= m" in body
    assert "__nv_bfloat162" not in body
    assert "__bfloat162float" in _source("sw_combine.cu")


# ----- the x-first order on the fast tile: rows 11, 2 (x-major), 15, 17d
# (ka_fields_kernel<true, true>, kb_kernel<true>, ka_adv_kernel<true>,
# kc_kernel<true>, ka_fwd_kernel<true>) -----

@pytest.mark.parametrize("shape", FAST_SHAPES, ids=str)
def test_emulated_fast_xfirst_kernels_are_their_plain_versions(shape):
    """The x-first order's kernels on the fast tile, emulated lane for
    lane on non-square grids whose last tile is ragged, every output
    starting NaN and written exactly once (emulate, _emulate_stack): their
    fast plain versions' bits. ka_quad (the psi-first fields, quad and
    split's two calls); the x-major kb (the Hermitian load, the
    transposed full store, Re and Im scaled; paired and single, junk in
    the self-conjugate rows' imaginary parts changing no bit); ka_adv
    (beta 1.6); kc's transposed half store (k <= n/2, rank 0's k = n/2
    write) under kc_visc's epilogue and stacked over kc_sw's five planes;
    ka_fwd (split, as fast mode runs it)."""
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    n, cols = shape
    rng = np.random.default_rng(n + cols + 5)
    # ka_quad on (n, cols) planes: quad, and split's two calls
    sr, si = _float_planes(rng, (1, n, cols), 2)
    kx, = _float_planes(rng, (n,), 1)
    ky, = _float_planes(rng, (cols,), 1)
    rlap = -1.0 / (1.0 + _float_planes(rng, (n, cols), 1)[0] ** 2)
    tab = (rlap, kx, ky)
    got = emulate_fields(sr, si, *tab, 0, 4, True, fast=True)
    assert torch.equal(got, torch.complex(*ff.ka_quad(sr[0], si[0], *tab,
                                                      fast=True)))
    for first in (0, 2):
        got = emulate_fields(sr, si, *tab, first, 2, True, fast=True)
        want = ff.ka_quad(sr[0], si[0], *tab, first, 2, fast=True)
        assert torch.equal(got, torch.complex(*want))
    # the x-major kb on a (n/2 + 1, cols) pair, and a single inverse
    w = [cols * n ** 0.5 * t for t in _float_planes(rng,
                                                    (n // 2 + 1, cols), 4)]
    scale = 1.0 / (n * cols)
    for part in (w, w[:2] + [None, None]):
        z = emulate(_hermitian(*part), n, cols, False, transposed=True,
                    fast=True)
        a, b = _scaled(z, scale)
        want = ff.kb(*part, scale, fast=True)
        assert torch.equal(a, want[0])
        if part[2] is not None:
            assert torch.equal(b, want[1])
    dirty = list(w)
    dirty[1], dirty[3] = w[1].clone(), w[3].clone()
    dirty[1][0], dirty[3][n // 2] = 10.0, -7.0
    assert torch.equal(emulate(_hermitian(*dirty), n, cols, False,
                               transposed=True, fast=True),
                       emulate(_hermitian(*w), n, cols, False,
                               transposed=True, fast=True))
    # ka_adv: the x-major (n, cols) fields, forward along x
    u, zx, v, zy, src = _float_planes(rng, (n, cols), 5)
    got = emulate_ka_adv(u, zx, v, zy, src, 1.6, fast=True)
    want = ff.ka_adv(u, zx, v, zy, src, 1.6, fast=True)
    assert torch.equal(got, torch.complex(*want))
    # kc's half store on y-major (n, cols) planes, under kc_visc's
    # epilogue, and over kc_sw's stack of five
    xr, xi = _float_planes(rng, (n, cols), 2)
    got = emulate_kc_fast(xr[None], xi[None])[0]
    assert got.shape == (cols, n // 2 + 1)
    lap, mask, zr, zi = _float_planes(rng, (cols, n // 2 + 1), 4)
    want = ff.kc_visc(xr, xi, lap, mask, zr, zi, 6.5, fast=True)
    visc = ff.visc_plain(got.real, got.imag, lap, mask, zr, zi, 6.5)
    assert torch.equal(visc[0], want[0]) and torch.equal(visc[1], want[1])
    gr, gi = _float_planes(rng, (5, n, cols), 2)
    got = emulate_kc_fast(gr, gi)
    assert torch.equal(got, torch.complex(*fs.kc_sw(gr, gi, fast=True)))
    # ka_fwd: the five products of x-major (n, cols) fields
    fields = [a * p for a, p in zip((3.0, 3.0, 1e-4, 1e-4),
                                    _float_planes(rng, (n, cols), 4))]
    got = emulate_ka_fwd(fields, 2.0 ** 15, 1e-4, 9.81, True, fast=True)
    want = fs.ka_fwd(*fields, 2.0 ** 15, 1e-4, 9.81, True, fast=True)
    assert torch.equal(got, torch.complex(*want))


def test_fast_xfirst_entries_agree_with_the_kernel_source():
    """The x-first order's fast entries exist with the plan's arguments
    and their ctypes signatures, each an instance of its strict form's
    kernel with FAST set (kc_sw and kc_visc one kernel, kc_kernel<true>)."""
    for name, entry, kernel in (
            ("ka_diag.cu", "xfb_ka_quad_fast", "launch<true, true>"),
            ("kb_pair.cu", "xfb_kb_fast", "launch_kb<true>"),
            ("ka_kc.cu", "xfb_ka_adv_fast", "launch_ka_adv<true>"),
            ("ka_kc.cu", "xfb_kc_visc_fast", "launch_kc<true>"),
            ("ka_kc.cu", "xfb_ka_fwd_fast", "launch_ka_fwd<true>"),
            ("ka_kc.cu", "xfb_kc_sw_fast", "launch_kc<true>")):
        sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)',
                        _source(name))
        assert "int tile_c, int cluster_k" in " ".join(sig.group(1).split())
        assert entry in _build.SIGNATURES
        assert kernel in _body(_source(name), rf'extern "C" int {entry}\(')


# ----- the per-transform pipeline's and the overlap x-stage's fast forms:
# rows 12, 14 and 21-22 (ka_kernel<SIGN, true>, kc_kernel<true> through
# xfb_kc_fast, xstage_kernel<SIGN, SRC, DST, true>) -----

def emulate_xstage(g, hrow: int, columns: int, forward: bool, scale: float,
                   fast: bool):
    """xstage_kernel on the global (nx, hrow) half spectrum g (the shards
    only address it): the natural store of `columns` columns (hrow, or
    the gather's P w) on the plan of 8-byte elements, columns past hrow
    loading zero and storing zeros (the gather's pad), the others times
    `scale` in one rounded product per part: (nx, columns)."""
    nx = g.shape[0]

    def load(rows, cols):
        return torch.where(cols < hrow, g[rows, cols.clamp(max=hrow - 1)],
                           torch.zeros((), dtype=torch.complex64))
    z = emulate(load, nx, columns, forward, elem=8, fast=fast)
    re, im = _scaled(z, scale)
    pad = torch.arange(columns) >= hrow
    return torch.complex(torch.where(pad, 0.0, re), torch.where(pad, 0.0,
                                                                 im))


@pytest.mark.parametrize("shape", FAST_SHAPES, ids=str)
def test_emulated_fast_ka_and_xstage_are_their_plain_versions(shape):
    """ka's four modes at scale 0.37 on (n, cols) planes and the three
    x-stage modes (forward; inverse at scale 1/n; the gather at P = 4
    with its pad) on an (n, cols) half spectrum, on the fast tile,
    emulated lane for lane on ragged last tiles, every output starting
    NaN and written exactly once: ka_fast_plain's and the fast x-stage
    plain versions' bits; the xstage plan's (8-byte elements) C, K and
    passes are the 4-byte plan's."""
    from xlab_fftbarotropic_torch.parallel import dfft
    from xlab_fftbarotropic_torch.parallel import fused_overlap as fo

    n, cols = shape
    rng = np.random.default_rng(n + cols + 9)
    xr, xi = _float_planes(rng, (n, cols), 2)
    for forward in (True, False):
        for im in (None, xi):
            got = emulate_ka(xr, im, forward, 0.37, fast=True)
            want = ff.ka(xr, im, forward, 0.37, fast=True)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    p4, p8 = xtile.xtile_plan(n, cols, 4), xtile.xtile_plan(n, cols, 8)
    assert (p8.c, p8.k, p8.threads, p8.smem, p8.fast_radices) == (
        p4.c, p4.k, p4.threads, p4.smem, p4.fast_radices)
    g = torch.complex(xr, xi)
    p = 4
    w = padded_half(cols, p) // p
    rows = dfft.shard_rows(g, p).contiguous()
    for forward, scale in ((True, 1.0), (False, 1.0 / n)):
        got = emulate_xstage(g, cols, cols, forward, scale, True)
        want = dfft.unshard_rows(fo.xstage(rows, forward, scale, fast=True))
        assert torch.equal(got, want)
    got = emulate_xstage(g, cols, p * w, True, 1.0, True)
    want = fo.xstage_gather(rows, True, fast=True)
    assert torch.equal(got, want.permute(1, 0, 2).reshape(n, p * w))
    scattered = fo.xstage_scatter(want, cols, False, 1.0 / n, fast=True)
    x = want.permute(1, 0, 2).reshape(n, p * w)[:, :cols].contiguous()
    assert torch.equal(emulate_xstage(x, cols, cols, False, 1.0 / n, True),
                       dfft.unshard_rows(scattered))


@pytest.mark.parametrize("extra", [4, 3], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("n", LENGTHS)
def test_emulated_plane_tile_is_the_fast_plain_transform(n, extra):
    """The plane tile of the fast ka_kernel and kc_kernel (emulate_planes)
    on two whole tiles and a ragged third at every length, their rows a
    multiple of 4 floats (16-byte copies) or not (one float each): kc's
    half store kc_fast_plain's bits, ka's real forward and complex
    inverse ka_fast_plain's, every output NaN-started and written exactly
    once; every read of the loads and of the staged outputs held to its
    writer (_Planes)."""
    c = xtile.xtile_plan(n, 1, 4).c
    cols = 2 * c + extra
    rng = np.random.default_rng(n + extra)
    xr, xi = _float_planes(rng, (n, cols), 2)
    got = emulate_kc_fast(xr[None], xi[None])[0]
    assert torch.equal(got, torch.complex(*ff.kc_fast_plain(xr, xi)))
    for forward, im, scale in ((True, None, 1.0), (False, xi, 0.37)):
        got = emulate_ka(xr, im, forward, scale, fast=True)
        want = ff.ka_fast_plain(xr, im, forward, scale)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


def emulate_kb_fast(war, wai, wbr, wbi, scale: float):
    """kb_kernel<true> on (n/2 + 1, nx) plane pairs (wbr None: the single
    inverse): the plane tile (emulate_planes) with the Hermitian load
    (computed), the inverse, the full transposed store of Re * scale and
    Im * scale: x-major (nx, n) planes."""
    n = 2 * (war.shape[0] - 1)
    got = emulate_planes(_hermitian(war, wai, wbr, wbi), n, war.shape[1],
                         False, False, False, computed=True)
    return _scaled(got, scale)


def emulate_ky_all_fast(fields, ies: float, f0: float, grav: float,
                        split: bool):
    """ky_all_kernel<true> on the y-major (ny, nx) u, v, zeta, eta_s: each
    product's plane tiles (emulate_planes) with the product load into the
    real plane (computed), the forward transform and the half store into
    flat (5 nx, ny/2 + 1) planes: (5, nx, ny/2 + 1), every output written
    exactly once (a store past nx would land in the next product's)."""
    ny, nx = fields[0].shape
    width = ny // 2 + 1
    out, writes = _outputs(5 * nx, width)
    for p in range(5):
        emulate_planes(_product_load(p, *fields, ies, f0, grav, split), ny,
                       nx, True, True, True, out, writes, plane=p * nx,
                       computed=True)
    return _written_once(out, writes, 5 * nx, width).reshape(5, nx, width)


# the forms of the fast kb and ky_all on the plane tile, and the lengths
# each is emulated at (ky_all's five products up to K = 2: its half store
# at K = 4, 8 is kc's, held at every length above)
PLANE_FORMS = ["kb_pair", "kb_single", "ky_all_split", "ky_all_full"]
PLANE_CASES = [(n, form) for form in PLANE_FORMS for n in LENGTHS
               if form.startswith("kb") or n <= 1024]


@pytest.mark.parametrize("extra", [4, 3], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("n, form", PLANE_CASES,
                         ids=[f"{n}-{f}" for n, f in PLANE_CASES])
def test_emulated_plane_kb_and_ky_all_are_their_fast_plain_versions(
        n, form, extra):
    """The fast kb_kernel and ky_all_kernel on the plane tile
    (emulate_planes with their computing loads) on two whole tiles and a
    ragged third at every length, the rows a multiple of 4 floats (16-byte
    reads and stores) or not (the tile's own layout): kb, paired and
    single, kb_fast_plain's bits and exactly the emulated fast kb_pair's
    output transposed, junk in the imaginary parts of rows 0 and n/2 (the
    leak guard) changing no bit; ky_all, split on and off,
    ky_all_fast_plain's bits, and product p exactly the emulated fast kc
    of (product p, 0); every output NaN-started and written exactly once,
    every read of the loads and of the staged outputs held to its writer
    (_Planes)."""
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    c = xtile.xtile_plan(n, 1, 4).c
    cols = 2 * c + extra
    rng = np.random.default_rng(n + extra + PLANE_FORMS.index(form))
    if form.startswith("kb"):
        w = [cols * n ** 0.5 * t for t in _float_planes(
            rng, (n // 2 + 1, cols), 4)]
        if form == "kb_single":
            w[2:] = [None, None]
        scale = 1.0 / (n * cols)
        a, b = emulate_kb_fast(*w, scale)
        want = ff.kb_fast_plain(*w, scale)
        assert torch.equal(a, want[0])
        part = [torch.zeros_like(w[0]) if x is None else x for x in w]
        pa, pb = _emulated_kb_pair(torch.stack(part[0::2]),
                                   torch.stack(part[1::2]), 0, 1, scale,
                                   fast=True)
        assert torch.equal(a, pa.t())
        if form == "kb_pair":
            assert torch.equal(b, want[1]) and torch.equal(b, pb.t())
            dirty = [x.clone() for x in w]
            dirty[1][0], dirty[1][n // 2], dirty[3][n // 2] = 10.0, -7.0, 3.0
            da, db = emulate_kb_fast(*dirty, scale)
            assert torch.equal(da, a) and torch.equal(db, b)
        return
    fields, ies, f0, grav = _sw_fields_at((n, cols), n + cols + 47)
    split = form == "ky_all_split"
    got = emulate_ky_all_fast(fields, ies, f0, grav, split)
    want = fs.ky_all_fast_plain(*fields, ies, f0, grav, split)
    assert got.shape == (5, cols, n // 2 + 1)
    assert torch.equal(got, torch.complex(*want))
    prods = torch.stack(fs.sw_products(*fields, ies, f0, grav, split))
    assert torch.equal(got, emulate_kc_fast(prods, torch.zeros_like(prods)))


def test_plane_tile_agrees_with_the_kernel_source():
    """The plane tile's layout in csrc/xtile.cuh is the emulation's
    (_Planes): the imaginary plane m C words behind the real one, in the
    first pass's reads (PlaneIn), the 16-byte copies and the 16-byte
    stores of the computing loads (load_quads: kb's Hermitian load, both
    planes; ky_all's products, the real plane alone; their fallbacks
    load_hermitian and load_rows), the tile's own layout in the one-float
    loads; ky_all's tile the cluster's (tile, product) decoding, product
    fastest; the half staging's stride m/2 + 16/C, whose C columns fit the
    tile's first half and 16 values at every length (the full staging:
    the tile and 16 values, of the W_m table, dead by then); the fast
    ka_kernel, kc_kernel, kb_kernel and ky_all_kernel keep the plan's
    shared bytes and grid (the strict forms' launch)."""
    src = _source("xtile.cuh")
    assert src.count("const int plane = t.m << t.logc;") == 3
    assert "s[plane + off]" in src
    assert "(e >> 2) * plane + (j << t.logc) + 4 * quad" in src
    load = _body(src, r"void load_planes\(")
    assert "cp_async16(" in load and "cp_async4(&d->x, xr + off);" in load
    # the computing loads: a quad v mod C/4 of row v div C/4 per thread
    # and e, one 16-byte store into each plane (the real one alone for
    # ky_all), else load_hermitian's and load_rows' tile layout
    quads = _body(src, r"void load_quads\(")
    assert "float* to = d + (j << t.logc) + 4 * q4;" in quads
    assert "*reinterpret_cast<float4*>(to) = re;" in quads
    assert "if (!real) *reinterpret_cast<float4*>(to + plane) = im;" in quads
    for loader, fallback, real in (("HermitianLoad", "load_hermitian(",
                                    "false"),
                                   ("SwProductLoad", "load_rows(", "true")):
        body = _body(src, rf"struct {loader} ")
        assert "load_quads(t, j0, nx, " + real in body, loader
        assert fallback in body and f"return {real};" in body, loader
    assert "sw_product4(" in _body(src, r"struct SwProductLoad ")
    assert "(blockIdx.x / k) / kSwProducts) << logc" in src
    assert "return (t.m >> 1) + (16 >> t.logc);" in src
    for n in LENGTHS:
        p = xtile.xtile_plan(n, 1, 4)
        assert p.c * (p.m // 2 + 16 // p.c) <= p.m * p.c // 2 + 16
        assert p.c * (p.m + 16 // p.c) <= p.m * p.c + 16 <= p.smem // 8
    for name, launcher, kernel in (
            ("ka_kc.cu", "launch_ka", "ka_kernel<SIGN, FAST>, tiles,"),
            ("ka_kc.cu", "launch_kc", "kc_kernel<FAST>, tiles,"),
            ("kb_pair.cu", "launch_kb", "kb_kernel<FAST>, tiles,"),
            ("ky_all.cu", "launch",
             "ky_all_kernel<FAST>, tiles * xfb::kSwProducts,")):
        body = " ".join(_body(_source(name), rf"int {launcher}\(").split())
        assert f"xfb::xtile::launch( {kernel}" in body
        assert "smem" in body


def _word_bank_degree(addr: torch.Tensor) -> int:
    """The worst bank conflict of one 4-byte shared-memory access
    instruction, addr (warps, 32) its words: per warp (32 lanes, one
    wavefront without conflict), the most distinct words on one of the
    32 banks."""
    return max(int(torch.bincount(torch.unique(w) % 32, minlength=32).max())
               for w in addr)


@pytest.mark.parametrize("n", LENGTHS)
def test_plane_tile_hits_distinct_banks(n):
    """The plane tile's own shared-memory accesses, from the emulated
    addresses of kc's half store, ka's real forward and complex inverse,
    and the computing loads of kb (both planes, the full store) and
    ky_all (the real plane, the half store): on rows of a multiple of 4
    floats each 16-byte copy of the loads and each 16-byte store of the
    computing loads lands on four banks of its own in every quarter warp
    (8 lanes, one wavefront) and the first pass's word reads of the
    planes (PlaneIn) hit 32 distinct banks per warp; on other rows the
    one-float copies into the tile's layout meet 2 lanes on a bank, as
    every other kernel's loads do (their real or imaginary parts, a word
    apart), the computing loads' 8-byte stores of whole values hit 16
    bank pairs per half warp, and the first pass's reads of it (load_b)
    too; the half staging's and the full staging's stores hit 16 distinct
    bank pairs per half warp (the lanes that store)."""
    c = xtile.xtile_plan(n, 1, 4).c
    worst = {}
    for cols in (2 * c, 2 * c - 1):
        rng = np.random.default_rng(n + cols)
        x = torch.complex(*_float_planes(rng, (n, cols), 2))
        # kc, ka real, ka complex; kb's and ky_all's computing loads
        for half, real, computed in ((True, False, False),
                                     (False, True, False),
                                     (False, False, False),
                                     (False, False, True),
                                     (True, True, True)):
            log = []
            emulate_planes(_dense(x), n, cols, True, half, real, log=log,
                           computed=computed)
            for step, what, addr in log:
                if what in ("copy", "quad store"):
                    quads = addr.reshape(-1, 8)          # quarter warps
                    banks = (quads.unsqueeze(-1) + torch.arange(4)) % 32
                    degree = max(int(torch.bincount(b.flatten(),
                                                    minlength=32).max())
                                 for b in banks)
                elif what in ("word load", "word store"):
                    degree = _word_bank_degree(addr)
                elif step == "stage":
                    degree = max(int(torch.bincount(
                        torch.unique(h[h >= 0]) % 16, minlength=16).max())
                        for h in addr.reshape(-1, 16))
                elif (step, what) in (("first", "load"), ("load", "store")):
                    degree = _bank_degree(addr)
                else:
                    continue
                key = (cols % 4 == 0, "stage" if step == "stage" else what)
                worst[key] = max(worst.get(key, 0), degree)
    assert worst == {(True, "copy"): 1, (True, "quad store"): 1,
                     (True, "word load"): 1, (True, "stage"): 1,
                     (False, "word store"): 2, (False, "store"): 1,
                     (False, "load"): 1, (False, "stage"): 1}, worst


def test_fast_per_transform_and_xstage_entries_agree_with_the_source():
    """xfb_ka_fast, xfb_kc_fast and xfb_xstage_fast exist with the plan's
    arguments and their ctypes signatures (each its strict entry's), each
    an instance of its strict form's kernel with FAST set; ka_kernel and
    xstage_kernel pass FAST on to the tile's store."""
    for name, entry, kernel in (
            ("ka_kc.cu", "xfb_ka_fast", "launch_ka<-1, true>"),
            ("ka_kc.cu", "xfb_kc_fast", "launch_kc<true>"),
            ("xstage.cu", "xfb_xstage_fast", "entry<true>")):
        sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)',
                        _source(name))
        assert "int tile_c, int cluster_k" in " ".join(sig.group(1).split())
        assert kernel in _body(_source(name), rf'extern "C" int {entry}\(')
        strict = entry[:-len("_fast")]
        assert _build.SIGNATURES[entry] == _build.SIGNATURES[strict]
    assert "xt::finish_transposed<SIGN, FAST>(" in _body(
        _source("ka_kc.cu"), r"ka_kernel\(")
    assert "xt::finish<SIGN, FAST>(" in _body(_source("xstage.cu"),
                                              r"xstage_kernel\(")

