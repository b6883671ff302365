#!/usr/bin/env python3
"""Check and time the column-tile kernels on one CUDA card: the x-stages of
csrc/kx_visc.cu and csrc/xstage.cu, ka_kernel (csrc/ka_kc.cu: ka in its
four modes), ka_fields_kernel (csrc/ka_diag.cu: ka_diag, ka6, ka_quad
and split), ka_sw_kernel (csrc/ka_sw.cu), ka_fwd_kernel (csrc/ka_kc.cu:
split off and on) and ka_adv_kernel (csrc/ka_kc.cu: beta on and off)
and the y-stages kc_kernel (csrc/ka_kc.cu: kc, kc_sw, kc_visc),
kb_kernel (csrc/kb_pair.cu: kb paired and single, the x-major kb),
kb_pair_kernel (csrc/kb_pair.cu), ky_adv_kernel (csrc/ky_adv.cu),
ky_all_kernel (csrc/ky_all.cu: split off and on), kb_adv_kernel
(csrc/kb_adv.cu: full and half) and kb_adv_tracer_kernel
(csrc/kb_adv_tracer.cu: src on and off, beta on and off), every form
against its plain torch version and against the one torch.fft call of
the same transform, at each grid size asked for; beside them the
unfused composition kb_adv_tracer replaces (kb_pair, then ky_adv of
each product) and the a2a transposes (csrc/a2a.cu, P = 4) against the
library's .contiguous() copies of the same move.

    python3 scripts/xtile_check.py [--root DIR] [--n 256 4096] [--iters 20]

--root takes the port from another checkout (an unpacked older commit,
for a comparison in the same run: its kernels build in its own tree).
Prints one line per form: max |kernel - plain| / max |plain|, a digest
of the output bits (the same seeded inputs in every run, so two
checkouts' lines show whether a kernel's bits moved), the kernel's ms
(CUDA events, mean of --iters back-to-back calls after a warm-up), the
plain version's ms, the bytes bound at 3.35 TB/s and the share of it
reached, and the ms of the torch.fft call: fft along x for the x-stages,
fft or ifft along axis 0 for ka's modes, ifft along x of the stacked
fields for ka_diag, ka6, ka_quad and ka_sw, fft along x of the stacked
products for ka_fwd and of the advection for ka_adv, and rfft along y of
the stacked products for ky_all (the transform alone: the fields,
products and advection formed beforehand), fft along y for kc and
kc_sw, irfft along y for kb and kb_pair, rfft along y of one plane for
ky_adv and kb_adv (the forward transform alone; no torch call computes
their whole function), rfft along y of the two advections stacked for
kb_adv_tracer and its unfused composition (formed beforehand: the
transform alone), and for a2a_cols / a2a_rows the library transposes
(parallel/dfft.py transpose_to_columns / transpose_to_rows: the pad or
the strip, then the .contiguous() copy); "a2a_cols launch" / "a2a_rows
launch" time the kernel launch alone, its pointer tables made once,
where the wrappers make them per call.
Then the card's name and power limit, and the registers and spills of
the tile kernels from the build's -Xptxas -v output. Exits non-zero past
1e-5.
"""

from __future__ import annotations

import argparse
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_S = 3.35e12
TOL = 1e-5


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def cases(n: int, dev):
    """name -> (kernel, plain, inputs read, the torch.fft call) at an n x
    n grid's shapes, numpy-seeded."""
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.ops import fused_sw as fs
    from xlab_fftbarotropic_torch.ops import fused_tracer as ft
    from xlab_fftbarotropic_torch.ops.spectral import SpectralTables
    from xlab_fftbarotropic_torch.parallel import dfft
    from xlab_fftbarotropic_torch.parallel import fused_overlap as fo
    from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr

    rng = np.random.default_rng(n)
    hny = n // 2 + 1

    def planes(shape, k):
        return [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) for _ in range(k)]

    fr, fi, lap, zsr, zsi, z0r, z0i = planes((n, hny), 7)
    mask = (torch.rand((n, hny), generator=torch.Generator().manual_seed(n))
            > 0.3).float().to(dev)
    f2 = planes((2, n, hny), 7)
    p5r, p5i = planes((5, n, hny), 2)
    rk = planes((n, hny), 6)
    tail = (z0r, z0i, *rk, 0.5)
    p, w = 4, -(-hny // 4)

    def shards(shape):
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.complex64)).to(dev)

    rows, cols = shards((p, n // p, hny)), shards((p, n, w))
    fc, f5c = torch.complex(fr, fi), torch.complex(p5r, p5i)
    f2c = torch.complex(f2[0], f2[1])
    gathered = torch.zeros((n, p * w), dtype=torch.complex64, device=dev)
    axpy = (z0r, z0i, 1.5)
    ax2 = (f2[5], f2[6], 1.5)
    # the y-stages: y-major (ny, nx) planes into kc, (hny, nx) into kb
    yr, yi = planes((n, n), 2)
    g5r, g5i = planes((5, n, n), 2)
    hs = list(planes((4, hny, n), 2))
    kbw = [hs[0][0], hs[1][0], hs[0][1], hs[1][1]]
    s = 1.0 / (n * n)

    def fft(x):
        return lambda: torch.fft.fft(x, dim=-2)

    yc, y5c = torch.complex(yr, yi), torch.complex(g5r, g5i)
    kbc = torch.complex(hs[0][:2], hs[1][:2])
    # the y-first pair: ka_diag's stack at the stepper's magnitudes (the
    # fields of order one after the 1/n^2 scale) and five y-major fields
    kar, kai = (h * n * n ** 0.5 for h in hs)
    u, zx, v, zy, src = planes((n, n), 5)
    kpc = torch.complex(kar[2:], kai[2:])
    # the ka x-stages: rfft2's real forward on ny = n columns, the other
    # modes on hny; the field x-stages on one and two states
    t = SpectralTables.build(n, n, 600_000.0, 600_000.0, device=dev)
    tab = (t.rlap, t.kx, t.ky)
    sr, si = planes((2, n, hny), 2)
    cr, ci = planes((n, hny), 2)
    cc = torch.complex(cr, ci)
    # the SW x-stages at the bench's magnitudes: ka_sw on the state (zeta
    # 1e-4, div 1e-6, eta 5 m), ka_fwd on x-major fields (u, v 3 m/s, zeta
    # and eta_s 1e-4); drawn last, so every other form's inputs (and
    # digest) stay those of the checkouts without them
    sw = [a * x for a, x in zip((1e-4, 1e-4, 1e-6, 1e-6, 5.0, 5.0),
                                planes((n, hny), 6))]
    sw_args = (*sw, *tab, float(fs.eta_pair_scale(sw)))
    swc = torch.complex(*(torch.stack(x) for x in fs.sw_fields(*sw_args)))
    xf = [a * x for a, x in zip((3.0, 3.0, 1e-4, 1e-4), planes((n, n), 4))]
    fwd = (*xf, 2.0 ** 15, 1e-4, 9.81)
    prods = {split: torch.stack(fs.sw_products(*fwd, split))
             for split in (False, True)}
    # ky_all on the same planes as y-major fields, ka_adv on the y-first
    # pair's five as x-major ones (no new draws: every other form's inputs
    # and digest stay those of the checkouts without them); the advection
    # written out here, as a --root checkout may predate ff.advection
    advs = {beta: -(u * zx) - v * (zy + beta if beta else zy) + src
            for beta in (0.0, 0.3)}
    # kb_adv_tracer: ka6's stack with kb_adv's fields 2, 3 (u and v at
    # order one after the scale), the y-first pair's zeta gradients and
    # src, and two more planes drawn last for the tracer's gradients
    w6r, w6i = (torch.cat([w, w[:2]]) for w in (kar, kai))
    qx, qy = planes((n, n), 2)
    zero = torch.zeros_like(src)
    uv = ff.kb_pair_plain(w6r, w6i, 2, 3, s)
    tracer_reads = (zx, zy, qx, qy, w6r[2:4], w6i[2:4])

    def tracer(src_, beta):
        def kern():
            return planes_of(ft.kb_adv_tracer(zx, zy, qx, qy, w6r, w6i,
                                              src_, beta))

        def plain():
            return planes_of(ft.kb_adv_tracer_plain(zx, zy, qx, qy, w6r,
                                                    w6i, src_, beta))

        az = -(uv[0] * zx) - uv[1] * (zy + beta if beta else zy)
        advq = torch.stack([az if src_ is None else az + src_,
                            -(uv[0] * qx) - uv[1] * qy])
        reads = tracer_reads + (() if src_ is None else (src_,))
        return kern, plain, reads, lambda: torch.fft.rfft(advq, dim=1)

    fused = tracer(src, 0.3)

    def unfused():                        # kb_pair, then ky_adv twice
        a, b = ff.kb_pair(w6r, w6i, 2, 3, s)
        z = ff.ky_adv(a, zx, b, zy, src, 0.3)
        q = ff.ky_adv(a, qx, b, qy, zero, 0.0)
        return [z[0], q[0], z[1], q[1]]   # the bits of kb_adv_tracer's

    # the a2a transposes at P = 4 on xstage's shards; "launch": the
    # kernel alone, its device pointer tables made once
    from xlab_fftbarotropic_torch.ops._build import lib
    a2a_out = (torch.empty((p, n, w), dtype=rows.dtype, device=dev),
               torch.empty((p, n // p, hny), dtype=rows.dtype, device=dev))
    tables = [ftr._pointer_table(x) for x in (rows, a2a_out[0], cols,
                                               a2a_out[1])]

    def a2a_launch(to_cols):
        src_t, dst_t = tables[:2] if to_cols else tables[2:]
        out = a2a_out[0] if to_cols else a2a_out[1]

        def kern():
            lib().xfb_a2a(src_t.data_ptr(), dst_t.data_ptr(), p, n // p,
                          hny, w, int(to_cols), dev.index, ff._stream(out))
            return out
        return kern

    def fields(states, kinds, psi_first=False):
        re_, im = [], []
        for s_ in range(states):
            a, b = ff.diagonal_fields(sr[s_], si[s_], *tab, kinds[s_],
                                      psi_first)
            re_ += a
            im += b
        return torch.complex(torch.stack(re_), torch.stack(im))

    f4, f6 = fields(1, [range(4)]), fields(2, [range(4), range(2)])
    fq = fields(1, [range(4)], True)

    def ifft_fields(x):
        return lambda: torch.fft.ifft(x, dim=1)

    def split():                          # the two calls of one stage
        return [*ff.ka_quad(sr[0], si[0], *tab, 0, 2),
                *ff.ka_quad(sr[0], si[0], *tab, 2, 2)]

    def split_plain():
        return [*ff.ka_quad_plain(sr[0], si[0], *tab, 0, 2),
                *ff.ka_quad_plain(sr[0], si[0], *tab, 2, 2)]

    return {
        "ka": (lambda: ff.ka(yr, None, True),
               lambda: ff.ka_plain(yr, None, True), (yr,),
               lambda: torch.fft.fft(yr, dim=0)),
        "ka real inverse": (lambda: ff.ka(cr, None, False, 0.5),
                            lambda: ff.ka_plain(cr, None, False, 0.5), (cr,),
                            lambda: torch.fft.ifft(cr, dim=0)),
        "ka complex forward": (lambda: ff.ka(cr, ci, True, 0.5),
                               lambda: ff.ka_plain(cr, ci, True, 0.5),
                               (cr, ci), lambda: torch.fft.fft(cc, dim=0)),
        "ka complex inverse": (lambda: ff.ka(cr, ci, False),
                               lambda: ff.ka_plain(cr, ci, False), (cr, ci),
                               lambda: torch.fft.ifft(cc, dim=0)),
        "ka_diag": (lambda: ff.ka_diag(sr[0], si[0], *tab),
                    lambda: ff.ka_diag_plain(sr[0], si[0], *tab),
                    (sr[0], si[0], t.rlap), ifft_fields(f4)),
        "ka6": (lambda: ft.tracer_xstage_planes(sr, si, t.kx, t.ky, t.rlap),
                lambda: ft.ka6_plain(sr, si, *tab), (sr, si, t.rlap),
                ifft_fields(f6)),
        "ka_quad": (lambda: ff.ka_quad(sr[0], si[0], *tab),
                    lambda: ff.ka_quad_plain(sr[0], si[0], *tab),
                    (sr[0], si[0], t.rlap), ifft_fields(fq)),
        "ka_quad split": (split, split_plain, (sr[0], si[0], t.rlap),
                          ifft_fields(fq)),
        "ka_sw": (lambda: fs.ka_sw(*sw_args),
                  lambda: fs.ka_sw_plain(*sw_args), (*sw, t.rlap),
                  ifft_fields(swc)),
        "ka_fwd": (lambda: fs.ka_fwd(*fwd), lambda: fs.ka_fwd_plain(*fwd),
                   tuple(xf), lambda: torch.fft.fft(prods[False], dim=1)),
        "ka_fwd split": (lambda: fs.ka_fwd(*fwd, True),
                         lambda: fs.ka_fwd_plain(*fwd, True), tuple(xf),
                         lambda: torch.fft.fft(prods[True], dim=1)),
        "ky_all": (lambda: fs.ky_all(*fwd), lambda: fs.ky_all_plain(*fwd),
                   tuple(xf), lambda: torch.fft.rfft(prods[False], dim=1)),
        "ky_all split": (lambda: fs.ky_all(*fwd, True),
                         lambda: fs.ky_all_plain(*fwd, True), tuple(xf),
                         lambda: torch.fft.rfft(prods[True], dim=1)),
        "ka_adv": (lambda: ff.ka_adv(u, zx, v, zy, src, 0.3),
                   lambda: ff.ka_adv_plain(u, zx, v, zy, src, 0.3),
                   (u, zx, v, zy, src),
                   lambda: torch.fft.fft(advs[0.3], dim=0)),
        "ka_adv beta=0": (lambda: ff.ka_adv(u, zx, v, zy, src),
                          lambda: ff.ka_adv_plain(u, zx, v, zy, src),
                          (u, zx, v, zy, src),
                          lambda: torch.fft.fft(advs[0.0], dim=0)),
        "kx_fwd F=1": (lambda: fs.kx_fwd(fr[None], fi[None]),
                       lambda: fs.kx_fwd_plain(fr[None], fi[None]),
                       (fr, fi), fft(fc)),
        "kx_fwd F=5": (lambda: fs.kx_fwd(p5r, p5i),
                       lambda: fs.kx_fwd_plain(p5r, p5i), (p5r, p5i),
                       fft(f5c)),
        "kx_visc": (lambda: ff.kx_visc(fr, fi, lap, mask, zsr, zsi, 6.5),
                    lambda: ff.kx_visc_plain(fr, fi, lap, mask, zsr, zsi,
                                             6.5),
                    (fr, fi, lap, mask, zsr, zsi), fft(fc)),
        "kx_visc coef": (
            lambda: ff.kx_visc(fr, fi, lap, mask, zsr, zsi, 6.5, axpy),
            lambda: ff.kx_visc_plain(fr, fi, lap, mask, zsr, zsi, 6.5, axpy),
            (fr, fi, lap, mask, zsr, zsi, z0r, z0i), fft(fc)),
        "kx_visc tracer F=2": (
            lambda: ff.kx_visc(*f2[:3], mask, *f2[3:5], 1.0, ax2),
            lambda: ff.kx_visc_plain(*f2[:3], mask, *f2[3:5], 1.0, ax2),
            (*f2, mask), fft(f2c)),
        "kx_visc_tail": (
            lambda: ff.kx_visc_tail(fr, fi, lap, mask, zsr, zsi, 6.5, tail),
            lambda: ff.kx_visc_tail_plain(fr, fi, lap, mask, zsr, zsi, 6.5,
                                          tail),
            (fr, fi, lap, mask, zsr, zsi, *tail[:8]), fft(fc)),
        "xstage": (lambda: fo.xstage(rows, False, 1.0 / n),
                   lambda: fo.xstage_plain(rows, False, 1.0 / n), (rows,),
                   fft(gathered)),
        "xstage forward": (lambda: fo.xstage(rows, True),
                           lambda: fo.xstage_plain(rows, True), (rows,),
                           fft(gathered)),
        "xstage_gather": (lambda: fo.xstage_gather(rows),
                          lambda: fo.xstage_gather_plain(rows), (rows,),
                          fft(gathered)),
        "xstage_scatter": (lambda: fo.xstage_scatter(cols, hny, False,
                                                     1.0 / n),
                           lambda: fo.xstage_scatter_plain(cols, hny, False,
                                                           1.0 / n),
                           (cols,), fft(gathered)),
        "kc": (lambda: ff.kc(yr, yi), lambda: ff.kc_plain(yr, yi),
               (yr, yi), fft(yc)),
        "kc_sw F=5": (lambda: fs.kc_sw(g5r, g5i),
                      lambda: fs.kc_sw_plain(g5r, g5i), (g5r, g5i),
                      fft(y5c)),
        "kc_visc": (lambda: ff.kc_visc(yr, yi, lap, mask, zsr, zsi, 6.5),
                    lambda: ff.kc_visc_plain(yr, yi, lap, mask, zsr, zsi,
                                             6.5),
                    (yr, yi, lap, mask, zsr, zsi), fft(yc)),
        "kb paired": (lambda: ff.kb(*kbw, s), lambda: ff.kb_plain(*kbw, s),
                      tuple(kbw),
                      lambda: torch.fft.irfft(kbc, n=n, dim=1)),
        "kb single": (lambda: ff.kb(*kbw[:2], None, None, s)[:1],
                      lambda: ff.kb_plain(*kbw[:2], None, None, s)[:1],
                      tuple(kbw[:2]),
                      lambda: torch.fft.irfft(kbc[0], n=n, dim=0)),
        "kb x-major": (lambda: ff.kb_stacked(hs[0], hs[1], 2, 3, s),
                       lambda: ff.kb_plain(hs[0][2], hs[1][2], hs[0][3],
                                           hs[1][3], s),
                       (hs[0][2:], hs[1][2:]),
                       lambda: torch.fft.irfft(kbc, n=n, dim=1)),
        "kb_pair": (lambda: ff.kb_pair(kar, kai, 2, 3, s),
                    lambda: ff.kb_pair_plain(kar, kai, 2, 3, s),
                    (kar[2:], kai[2:]),
                    lambda: torch.fft.irfft(kpc, n=n, dim=1)),
        "ky_adv": (lambda: ff.ky_adv(u, zx, v, zy, src, 0.3),
                   lambda: ff.ky_adv_plain(u, zx, v, zy, src, 0.3),
                   (u, zx, v, zy, src),
                   lambda: torch.fft.rfft(src, dim=0)),
        "kb_adv_full": (lambda: ff.kb_adv_full(kar, kai, src, 0.3),
                        lambda: ff.kb_adv_full_plain(kar, kai, src, 0.3),
                        (kar, kai, src),
                        lambda: torch.fft.rfft(src, dim=0)),
        "kb_adv_half": (lambda: ff.kb_adv_half(zx, zy, kar, kai, src, 0.3),
                        lambda: ff.kb_adv_half_plain(zx, zy, kar, kai, src,
                                                     0.3),
                        (zx, zy, kar[2:], kai[2:], src),
                        lambda: torch.fft.rfft(src, dim=0)),
        "kb_adv_tracer": fused,
        "kb_adv_tracer no src": tracer(None, 0.3),
        "kb_adv_tracer beta=0": tracer(src, 0.0),
        "kb_adv_tracer b=0 no src": tracer(None, 0.0),
        "kb_pair + 2 ky_adv": (unfused, *fused[1:]),
        "a2a_cols": (lambda: ftr.a2a_cols(rows),
                     lambda: ftr.a2a_cols_plain(rows), (rows,),
                     lambda: dfft.transpose_to_columns(rows)),
        "a2a_cols launch": (a2a_launch(True),
                            lambda: ftr.a2a_cols_plain(rows), (rows,),
                            lambda: dfft.transpose_to_columns(rows)),
        "a2a_rows": (lambda: ftr.a2a_rows(cols, hny),
                     lambda: ftr.a2a_rows_plain(cols, hny), (cols,),
                     lambda: dfft.transpose_to_rows(cols, hny)),
        "a2a_rows launch": (a2a_launch(False),
                            lambda: ftr.a2a_rows_plain(cols, hny), (cols,),
                            lambda: dfft.transpose_to_rows(cols, hny)),
    }


def planes_of(out):
    """kb_adv_tracer's stacked (re, im) (2, nx, hny) planes as [zeta re,
    q re, zeta im, q im]: each plane held to its own plain one (their
    sizes differ), in the byte order of the stack (the same digest)."""
    return [out[0][0], out[0][1], out[1][0], out[1][1]]


def digest(outs) -> str:
    h = hashlib.sha1()
    for t in outs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--n", type=int, nargs="+", default=[256, 4096])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("xtile_check: no CUDA device visible")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from xlab_fftbarotropic_torch.ops import _build
    _build.lib()
    dev = torch.device("cuda", torch.cuda.current_device())
    worst = 0.0
    for n in args.n:
        for name, (kern, plain, reads, lib) in cases(n, dev).items():
            got, want = as_list(kern()), as_list(plain())
            rel = max(float((g - w).abs().max() / w.abs().max())
                      for g, w in zip(got, want))
            worst = max(worst, rel)
            bits = digest(got)
            ms = cuda_ms(kern, args.iters)
            plain_ms = cuda_ms(plain, args.iters)
            lib_ms = cuda_ms(lib, args.iters)
            bound = (nbytes(reads) + nbytes(want)) / HBM_BYTES_S * 1e3
            print(f"{args.root} {n}^2 {name:20s} err {rel:.2e} bits {bits} "
                  f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
                  f"{bound:.4f} ms ({100 * bound / ms:.1f} %)  torch.fft "
                  f"{lib_ms:.4f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    log = Path(_build.LAST_BUILD["path"]).parent / "build.log"
    text = log.read_text() if log.exists() else ""
    for m in re.finditer(r"Compiling entry function '(\w*(?:kx_visc|xstage|"
                         r"ka_kernel|ka_fields_kernel|ka_sw_kernel|"
                         r"ka_adv_kernel|ka_fwd_kernel|kc_kernel|kb_kernel|"
                         r"kb_pair_kernel|ky_adv_kernel|ky_all_kernel|"
                         r"kb_adv_kernel|kb_adv_tracer_kernel)\w*)'"
                         r".*?\n(.*?Used \d+ registers[^\n]*)", text, re.S):
        spill = re.search(r"(\d+) bytes spill stores", m.group(2))
        regs = re.search(r"Used (\d+) registers", m.group(2))
        print(f"ptxas {m.group(1)}: {regs.group(1)} registers, "
              f"{spill.group(1) if spill else '?'} bytes spill stores")
    if worst > TOL:
        print(f"xtile_check: worst error {worst:.2e} > {TOL}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
