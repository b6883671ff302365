"""The shallow-water plane stepper's kernels and the RK4 plane
arithmetic: the counterpart of xlab_fftbarotropic_tpu/ops/pallas_sw.py
in its default form (y-first forward pipeline, fused RK stage axpy,
float32 stores, the split-linear formulation off in strict mode) and in
its x-first order.

The state is six float32 planes (nx, hny): zr, zi, dr, di, er, ei of
(zeta_hat, div_hat, eta_hat). One RK stage runs five launches of four
kernels (csrc/), the FFT ones on the column-tile transform of
csrc/xtile.cuh (ka_sw, kb_pair, ky_all, kx_fwd, and the x-first order's
kb, ka_fwd and kc_sw):

  ka_sw       the four fields u, v, zeta, eta_scale*eta, inverse x-stage,
              written transposed (4, hny, nx)
  kb_pair x2  paired c2r y-stages (ops/fused_fft.py) -> u, v and
              zeta, eta_scale*eta y-major (ny, nx)
  ky_all      the five products q*u, q*v, eta*u, eta*v, phi and their
              real forward y-stages -> (5, nx, hny)
  kx_fwd      the forward x-stage of the five stacked products
              (csrc/kx_visc.cu with no epilogue)
  sw_combine  the three dealiased tendencies, one elementwise pass, with
              the RK stage axpy fused in for stages 1-3

and the RK4 tail is one rk4_combine launch over the six planes. The
x-first order (XFB_SW_YFIRST=0 in the JAX package) writes the four fields
x-major with two kb (kb_stacked) and runs ka_fwd (the five products and
their real forward x-stages, (5, ny, nx)) and kc_sw (their forward
partial y-stages) in place of ky_all and kx_fwd; the combine is the
same. In the
unfused form (XFB_SW_FUSED_RK=0 in the JAX package) sw_combine runs
without its axpy and each stage state is one plane_axpy launch. The
forcing spectrum is ka + kc (ops/fused_fft.py), once per segment. Under
ETDRK4 (models/etdrk4.py) the combine is sw_combine_mv, which also
builds the stage z0 + s (Q @ tendency) from the per-mode 3x3 table Q
(csrc/sw_combine.cu, a second entry point).

eta_scale is the pairing equalizer: zeta (about 1e-4) and eta (about
5 m) share one c2r transform in kb_pair, and float32 cross-talk there is
about eps * max|partner|, so eta is brought to zeta's size by an exact
power of two first and unscaled in ky_all.

Fast mode (the JAX package's --fast-transforms for shallow water) runs
ka_sw, the two kb_pair, ky_all and kx_fwd on the fast column tile
(csrc/xtile.cuh FAST: the radix-16 sub-DFT passes as bf16 tensor-core
products, float32 accumulate), each wrapper's `fast=True`, counted under
its own name (ka_sw_fast, ...), with the split-linear formulation and
the product store `pstore` (pallas_sw.pstore_dtype): "bf16", kx_fwd
rounds its five product spectra once to bf16 and sw_combine and
sw_combine_mv read them widened exactly (their _bf16 forms), or "f32".
On the CPU each fast form takes its plain version: the strict plain
version's load and store around ops/fast_tile.py's emulation of the
fast transform, and `.to(torch.bfloat16)` for the bf16 store. The
x-first order's fast mode runs ka_sw, the two kb, ka_fwd and kc_sw on
the fast tile; its kc_sw stores float32 whatever `pstore` says, and the
float32 combines read it, as in the JAX package, whose product store
lives on the y-first branch alone.

Same dispatch rule as ops/fused_fft.py: CPU tensors take the plain
version beside each wrapper, CUDA tensors launch the kernel or raise;
launches count in fused_fft.LAUNCHES.
"""

from __future__ import annotations

import ctypes

import torch

from .fused_fft import (_check, _launch, _ptrs, _stream, _takes_plain,
                        _twiddles, _xtile_args, inverse_xstage_fast_plain,
                        inverse_xstage_plain, ka, kb_pair, kb_stacked, kc,
                        kc_fast_plain, real_forward_fast_plain)

MAX_PLANES = 8   # csrc/rk4_combine.cu kMaxPlanes
N_PRODUCTS = 5   # q*u, q*v, eta*u, eta*v, phi
# kx_fwd's product store (pallas_sw.pstore_dtype): its dtype by name
PSTORES = {"f32": torch.float32, "bf16": torch.bfloat16}


# ------------------------------------------------------------ rk4_combine

def plane_rk4_combine_plain(s0, r1, r2, r3, r4, c: float):
    return tuple(s + (a + 2.0 * b + 2.0 * d + e) * c
                 for s, a, b, d, e in zip(s0, r1, r2, r3, r4))


def plane_rk4_combine(s0, r1, r2, r3, r4, c: float):
    """out_p = s0_p + (r1_p + 2 r2_p + 2 r3_p + r4_p) * c (c = dt/6),
    the RK4 tail (main.cpp:309-312), over tuples of same-shape float32
    planes, in that grouping. Counterpart of pallas_sw.plane_rk4_combine
    (_rk4_combine_kernel)."""
    groups = (s0, r1, r2, r3, r4)
    n = len(s0)
    if not 1 <= n <= MAX_PLANES or any(len(g) != n for g in groups):
        raise ValueError(f"plane_rk4_combine: expected five tuples of "
                         f"1..{MAX_PLANES} planes each, got "
                         f"{[len(g) for g in groups]}")
    planes = [p for g in groups for p in g]
    _check("rk4_combine", tuple(s0[0].shape), *planes)
    if _takes_plain("rk4_combine", s0[0]):
        return plane_rk4_combine_plain(s0, r1, r2, r3, r4, c)
    from ._build import lib
    outs = [torch.empty_like(p) for p in s0]
    table = (ctypes.c_void_p * (6 * n))(*_ptrs(*planes, *outs))
    _launch("rk4_combine", lib().xfb_rk4_combine, ctypes.addressof(table),
            n, s0[0].numel(), float(c), s0[0].device.index, _stream(s0[0]))
    return tuple(outs)


# ------------------------------------------------------------- plane_axpy

def plane_axpy_plain(s, r, coef: float):
    return tuple(a + coef * b for a, b in zip(s, r))


def plane_axpy(s, r, coef: float):
    """out_p = s_p + coef * r_p over tuples of same-shape float32 planes,
    coef * r_p rounded first, then the sum. Counterpart of
    pallas_sw.plane_axpy (_axpy_kernel)."""
    n = len(s)
    if not 1 <= n <= MAX_PLANES or len(r) != n:
        raise ValueError(f"plane_axpy: expected two tuples of 1..{MAX_PLANES}"
                         f" planes each, got {len(s)} and {len(r)}")
    _check("plane_axpy", tuple(s[0].shape), *s, *r)
    if _takes_plain("plane_axpy", s[0]):
        return plane_axpy_plain(s, r, coef)
    from ._build import lib
    outs = [torch.empty_like(p) for p in s]
    table = (ctypes.c_void_p * (3 * n))(*_ptrs(*s, *r, *outs))
    _launch("plane_axpy", lib().xfb_plane_axpy, ctypes.addressof(table), n,
            s[0].numel(), float(coef), s[0].device.index, _stream(s[0]))
    return tuple(outs)


# ------------------------------------------------------- pairing equalizer

def eta_pair_scale(planes) -> torch.Tensor:
    """The power of two nearest max|zeta_hat| / max|eta_hat| (1 when
    either is zero), a float32 scalar built from the exponent bits, so
    scaling by it and by its inverse is exact (torch.exp2 can land 1 ulp
    off). Counterpart of pallas_sw.eta_pair_scale; the model reads it to
    the host once per segment."""
    zr, zi, _dr, _di, er, ei = planes
    m_z = torch.maximum(zr.abs().max(), zi.abs().max())
    m_e = torch.maximum(er.abs().max(), ei.abs().max())
    ratio = torch.where((m_z > 0) & (m_e > 0),
                        m_z / torch.clamp(m_e, min=1e-30),
                        torch.ones_like(m_z))
    e = torch.clamp(torch.round(torch.log2(ratio)), -126.0, 126.0)
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


# ------------------------------------------------------------------ ka_sw

def sw_fields(zr, zi, dr, di, er, ei, rlap, kx, ky, eta_scale: float):
    """The four diagonal-scaled fields (re, im lists) of the SW state:
    u = -i ky rlap Z + i kx rlap D, v = i kx rlap Z + i ky rlap D,
    zeta = Z, eta_s = eta_scale * E; in csrc/ka_sw.cu's grouping, so ka
    (complex inverse, scale 1) of these fields is ka_sw bit for bit."""
    k = kx.reshape(-1, 1)
    q = ky.reshape(1, -1)
    r = rlap
    re = [(zi * q) * r - (di * k) * r, -((zi * k) * r) - (di * q) * r,
          zr, er * eta_scale]
    im = [-((zr * q) * r) + (dr * k) * r, (zr * k) * r + (dr * q) * r,
          zi, ei * eta_scale]
    return re, im


def ka_sw_plain(zr, zi, dr, di, er, ei, rlap, kx, ky, eta_scale: float):
    return inverse_xstage_plain(*sw_fields(zr, zi, dr, di, er, ei, rlap,
                                           kx, ky, eta_scale))


def ka_sw_fast_plain(zr, zi, dr, di, er, ei, rlap, kx, ky,
                     eta_scale: float):
    """ka_sw_plain's fields through the fast tile's inverse x-DFT."""
    return inverse_xstage_fast_plain(*sw_fields(zr, zi, dr, di, er, ei,
                                                rlap, kx, ky, eta_scale))


def ka_sw(zr, zi, dr, di, er, ei, rlap, kx, ky, eta_scale: float,
          fast: bool = False):
    """(u, v, zeta, eta_scale*eta) of the SW state planes (nx, hny),
    inverse x-DFT (unnormalized), written transposed: (wr, wi)
    (4, hny, nx); `fast`: on the fast column tile. Counterpart of
    pallas_sw.inverse_quad_planes' KA stage (_ka_sw_kernel, and its
    two-call split _ka_sw2_kernel)."""
    n, hny = zr.shape
    _check("ka_sw", (n, hny), zr, zi, dr, di, er, ei, rlap)
    _check("ka_sw", (n,), kx)
    _check("ka_sw", (hny,), ky)
    if kx.device != zr.device or ky.device != zr.device:
        raise ValueError("ka_sw: tables and state on different devices")
    if _takes_plain("ka_sw", zr, n):
        return (ka_sw_fast_plain if fast else ka_sw_plain)(
            zr, zi, dr, di, er, ei, rlap, kx, ky, eta_scale)
    from ._build import lib
    wr = torch.empty((4, hny, n), dtype=torch.float32, device=zr.device)
    wi = torch.empty_like(wr)
    name = "ka_sw_fast" if fast else "ka_sw"
    _launch(name, getattr(lib(), "xfb_" + name),
            *_ptrs(zr, zi, dr, di, er, ei, rlap, kx, ky,
                   _twiddles(n, zr.device), wr, wi),
            n, hny, float(eta_scale), *_xtile_args(n, hny, 4),
            zr.device.index, _stream(zr))
    return wr, wi


def inverse_quad_planes(zr, zi, dr, di, er, ei, kx, ky, rlap,
                        eta_scale: float = 1.0, yfirst: bool = True,
                        fast: bool = False):
    """(u, v, zeta, eta_scale*eta) from the SW state planes: ka_sw + two
    kb_pair, y-major (ny, nx), or with yfirst False ka_sw + two
    kb_stacked, x-major (nx, ny); `fast`: ka_sw and kb_pair (kb) on the
    fast column tile. Counterpart of pallas_sw.inverse_quad_planes
    (YFIRST = yfirst)."""
    nx, hny = zr.shape
    scale = 1.0 / (nx * 2 * (hny - 1))
    pair = kb_pair if yfirst else kb_stacked
    wr, wi = ka_sw(zr, zi, dr, di, er, ei, rlap, kx, ky, eta_scale,
                   fast=fast)
    u, v = pair(wr, wi, 0, 1, scale, fast=fast)
    zeta, eta_s = pair(wr, wi, 2, 3, scale, fast=fast)
    return u, v, zeta, eta_s


# ----------------------------------------------------------------- ky_all

def sw_products(u, v, zeta, eta_s, ies: float, f0: float, grav: float,
                split: bool):
    """q*u, q*v, eta*u, eta*v, phi with eta = eta_s * ies, q = zeta + f0
    and phi = g*eta + (u*u + v*v)/2; split leaves out f0 and g*eta (the
    combine adds those terms exactly). csrc/epilogue.cuh sw_product
    rounds in this order, so ka (real forward, scale 1) of product p is
    ka_fwd's and kc of (product p, 0) is ky_all's, bit for bit."""
    eta = eta_s * ies
    q = zeta if split else zeta + f0
    ke = 0.5 * (u * u + v * v)
    phi = ke if split else grav * eta + ke
    return q * u, q * v, eta * u, eta * v, phi


def ky_all_plain(u, v, zeta, eta_s, ies: float, f0: float, grav: float,
                 split: bool = False):
    prods = torch.stack(sw_products(u, v, zeta, eta_s, ies, f0, grav,
                                    split))
    f = torch.fft.rfft(prods, dim=1).transpose(1, 2)
    return f.real.contiguous(), f.imag.contiguous()


def ky_all_fast_plain(u, v, zeta, eta_s, ies: float, f0: float,
                      grav: float, split: bool = False):
    """ky_all_plain's products, then kc_fast_plain of (products, 0)."""
    prods = torch.stack(sw_products(u, v, zeta, eta_s, ies, f0, grav,
                                    split))
    return kc_fast_plain(prods, torch.zeros_like(prods))


def ky_all(u, v, zeta, eta_s, ies: float, f0: float, grav: float,
           split: bool = False, fast: bool = False):
    """The five SW products of the y-major (ny, nx) fields (eta_s scaled
    by the pairing equalizer, `ies` its inverse), each through the real
    forward y-DFT, rows k <= ny/2 -> stacked (5, nx, hny) planes;
    `fast`: on the fast column tile. Counterpart of
    pallas_sw.forward_tendencies' KY stage (_ky_all_loop_kernel,
    _ky_all_kernel and _ky_fwd_kernel, which compute the same
    function)."""
    ny, nx = u.shape
    _check("ky_all", (ny, nx), u, v, zeta, eta_s)
    if _takes_plain("ky_all", u, ny):
        return (ky_all_fast_plain if fast else ky_all_plain)(
            u, v, zeta, eta_s, ies, f0, grav, split)
    from ._build import lib
    hny = ny // 2 + 1
    outr = torch.empty((N_PRODUCTS, nx, hny), dtype=torch.float32,
                       device=u.device)
    outi = torch.empty_like(outr)
    name = "ky_all_fast" if fast else "ky_all"
    _launch(name, getattr(lib(), "xfb_" + name),
            *_ptrs(u, v, zeta, eta_s, _twiddles(ny, u.device), outr, outi),
            ny, nx, float(ies), float(f0), float(grav), int(split),
            *_xtile_args(ny, nx, 4), u.device.index, _stream(u))
    return outr, outi


# ----------------------------------------------------------------- kx_fwd

def kx_fwd_plain(fr, fi, pstore: str = "f32"):
    f = torch.fft.fft(torch.complex(fr, fi), dim=-2)
    d = PSTORES[pstore]
    return f.real.to(d).contiguous(), f.imag.to(d).contiguous()


def kx_fwd_fast_plain(fr, fi, pstore: str = "f32"):
    """The fast tile's forward x-DFT, stored as `pstore` (bf16: each
    value rounded once, to nearest even)."""
    from .fast_tile import fast_dft
    d = PSTORES[pstore]
    return tuple(x.to(d).contiguous() for x in fast_dft(fr, fi, -1, dim=-2))


def kx_fwd(fr, fi, fast: bool = False, pstore: str = "f32"):
    """Forward x-DFT of stacked (F, nx, hny) planes over the hny columns,
    no epilogue: (F, nx, hny) planes in natural orientation, stored as
    `pstore` ("f32", or "bf16": each value of the float32 result rounded
    once to bf16); `fast`: on the fast column tile. Counterpart of
    pallas_sw.forward_tendencies' KX stage (_kx_fwd_kernel, its output
    dtype pallas_sw.pstore_dtype); the kernel is csrc/kx_visc.cu with a
    null epilogue, or its bf16 store."""
    if fr.dim() != 3:
        raise ValueError(f"kx_fwd: expected (F, nx, hny), got "
                         f"{tuple(fr.shape)}")
    if pstore not in PSTORES:
        raise ValueError(f"kx_fwd: pstore {pstore!r}, not one of "
                         f"{tuple(PSTORES)}")
    nf, nx, hny = fr.shape
    _check("kx_fwd", (nf, nx, hny), fr, fi)
    if _takes_plain("kx_fwd", fr, nx):
        return (kx_fwd_fast_plain if fast else kx_fwd_plain)(fr, fi, pstore)
    from ._build import lib
    rr = torch.empty_like(fr, dtype=PSTORES[pstore])
    ri = torch.empty_like(rr)
    # the LAUNCHES key; the bf16 stores' entry is xfb_<key>
    name = {(False, "f32"): "kx_fwd", (True, "f32"): "kx_fwd_fast_f32",
            (False, "bf16"): "kx_fwd_bf16",
            (True, "bf16"): "kx_fwd_fast"}[(fast, pstore)]
    tw = _twiddles(nx, fr.device)
    if pstore == "bf16":
        _launch(name, getattr(lib(), "xfb_" + name),
                *_ptrs(fr, fi, tw, rr, ri), nf, nx, hny,
                *_xtile_args(nx, hny, 4), fr.device.index, _stream(fr))
        return rr, ri
    entry = lib().xfb_kx_visc_fast if fast else lib().xfb_kx_visc
    _launch(name, entry, fr.data_ptr(), fi.data_ptr(),
            None, None, None, None, None, None,
            *_ptrs(tw, rr, ri), None, None,
            nf, nx, hny, 0.0, 0.0, *_xtile_args(nx, hny, 4),
            fr.device.index, _stream(fr))
    return rr, ri


# ----------------------------------------------------------------- ka_fwd

def ka_fwd_plain(u, v, zeta, eta_s, ies: float, f0: float, grav: float,
                 split: bool = False):
    prods = torch.stack(sw_products(u, v, zeta, eta_s, ies, f0, grav,
                                    split))
    f = torch.fft.fft(prods, dim=1).transpose(1, 2)
    return f.real.contiguous(), f.imag.contiguous()


def ka_fwd_fast_plain(u, v, zeta, eta_s, ies: float, f0: float,
                      grav: float, split: bool = False):
    """ka_fwd_plain's products through the fast tile's real forward
    x-DFT, written transposed."""
    return real_forward_fast_plain(torch.stack(sw_products(
        u, v, zeta, eta_s, ies, f0, grav, split)))


def ka_fwd(u, v, zeta, eta_s, ies: float, f0: float, grav: float,
           split: bool = False, fast: bool = False):
    """The five SW products (ky_all's) of the x-major (nx, ny) fields,
    each through the real forward x-DFT of every y column, written
    transposed: stacked (5, ny, nx) planes; `fast`: on the fast column
    tile. Counterpart of pallas_sw.forward_tendencies' KA_FWD stage
    (_ka_fwd_kernel)."""
    if u.dim() != 2:
        raise ValueError(f"ka_fwd: expected (nx, ny) fields, got "
                         f"{tuple(u.shape)}")
    nx, ny = u.shape
    _check("ka_fwd", (nx, ny), u, v, zeta, eta_s)
    if _takes_plain("ka_fwd", u, nx):
        return (ka_fwd_fast_plain if fast else ka_fwd_plain)(
            u, v, zeta, eta_s, ies, f0, grav, split)
    from ._build import lib
    yr = torch.empty((N_PRODUCTS, ny, nx), dtype=torch.float32,
                     device=u.device)
    yi = torch.empty_like(yr)
    name = "ka_fwd_fast" if fast else "ka_fwd"
    _launch(name, getattr(lib(), "xfb_" + name),
            *_ptrs(u, v, zeta, eta_s, _twiddles(nx, u.device), yr, yi),
            nx, ny, float(ies), float(f0), float(grav), int(split),
            *_xtile_args(nx, ny, 4), u.device.index, _stream(u))
    return yr, yi


# ------------------------------------------------------------------ kc_sw

def kc_sw_plain(xr, xi):
    ny = xr.shape[1]
    y = torch.fft.fft(torch.complex(xr, xi), dim=1)[:, :ny // 2 + 1]
    y = y.transpose(1, 2)
    return y.real.contiguous(), y.imag.contiguous()


def kc_sw(xr, xi, fast: bool = False):
    """kc over a stack: the forward DFT along y of (F, ny, nx) planes,
    rows k <= ny/2, written transposed: (F, nx, hny), stored float32 in
    either mode (pallas_sw's KC_SW store); `fast`: on the fast column
    tile (kc_fast_plain on the CPU). Counterpart of
    pallas_sw.forward_tendencies' KC_SW stage (_kc_sw_kernel)."""
    if xr.dim() != 3:
        raise ValueError(f"kc_sw: expected (F, ny, nx), got "
                         f"{tuple(xr.shape)}")
    nf, ny, nx = xr.shape
    _check("kc_sw", (nf, ny, nx), xr, xi)
    if _takes_plain("kc_sw", xr, ny):
        return (kc_fast_plain if fast else kc_sw_plain)(xr, xi)
    from ._build import lib
    yr = torch.empty((nf, nx, ny // 2 + 1), dtype=torch.float32,
                     device=xr.device)
    yi = torch.empty_like(yr)
    name = "kc_sw_fast" if fast else "kc_sw"
    _launch(name, getattr(lib(), "xfb_" + name),
            *_ptrs(xr, xi, _twiddles(ny, xr.device), yr, yi), nf, ny, nx,
            *_xtile_args(ny, nx, 4), xr.device.index, _stream(xr))
    return yr, yi


# ------------------------------------------------------------- sw_combine

def _products(name: str, pr, pi, nx: int, hny: int) -> str:
    """The product spectra's store ("f32" or "bf16") after checking them:
    (5, nx, hny), contiguous, of one dtype on one device."""
    store = {v: k for k, v in PSTORES.items()}.get(pr.dtype)
    if store is None or pi.dtype != pr.dtype:
        raise TypeError(f"{name}: expected float32 or bfloat16 product "
                        f"planes, got {pr.dtype} and {pi.dtype}")
    for t in (pr, pi):
        if tuple(t.shape) != (N_PRODUCTS, nx, hny):
            raise ValueError(f"{name}: expected shape "
                             f"{(N_PRODUCTS, nx, hny)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.device != pr.device:
            raise ValueError(f"{name}: product planes must be contiguous "
                             f"and on one device")
    return store


def sw_combine_plain(pr, pi, state, src, kx, ky, lap, mask, f0: float,
                     grav: float, nu: float, H: float, split: bool = False,
                     axpy=None):
    # bf16 product spectra (the bf16 store) widen exactly first
    qur, qvr, eur, evr, phr = pr.float().unbind(0)
    qui, qvi, eui, evi, phi_ = pi.float().unbind(0)
    k = kx.reshape(-1, 1)
    q = ky.reshape(1, -1)
    zr, zi, dr, di, er, ei = state
    nulap = nu * lap
    dzr = k * qui + q * qvi + nulap * zr
    dzi = -k * qur - q * qvr + nulap * zi
    ddr = -k * qvi + q * qui - lap * phr + nulap * dr
    ddi = k * qvr - q * qur - lap * phi_ + nulap * di
    if split:
        fz = f0 * (lap != 0.0).to(lap.dtype)
        dzr = dzr - fz * dr
        dzi = dzi - fz * di
        ddr = ddr + fz * zr - grav * (lap * er)
        ddi = ddi + fz * zi - grav * (lap * ei)
    if src is not None:
        dzr = dzr + src[0]
        dzi = dzi + src[1]
    tend = (mask * dzr, mask * dzi, mask * ddr, mask * ddi,
            mask * (k * eui + q * evi - H * dr),
            mask * (-k * eur - q * evr - H * di))
    if axpy is None:
        return tend
    z0, coef = axpy
    return tend, tuple(z + coef * t for z, t in zip(z0, tend))


def sw_combine(pr, pi, state, src, kx, ky, lap, mask, f0: float,
               grav: float, nu: float, H: float, split: bool = False,
               axpy=None):
    """The three dealiased SW tendencies as six (nx, hny) planes from the
    stacked product spectra (pr, pi) (5, nx, hny), the CURRENT stage
    state planes (viscosity, -H*D and the split terms read it) and the
    forcing spectrum planes src (or None):

      dzeta = mask * (-(ikx)QU - (iky)QV + nu lap Z (+ S_hat))
      ddiv  = mask * ( (ikx)QV - (iky)QU - lap PHI + nu lap D)
      deta  = mask * (-(ikx)EU - (iky)EV - H D)

    split adds -f0 D, f0 Z - g lap E where lap != 0 (the products then
    left them out). axpy=(z0_planes, coef) also returns the next stage
    state z0 + coef * tendency from the BASE state z0: (tend, next). The
    product planes may be bf16 (kx_fwd's bf16 store): each value widens
    exactly, then the float32 arithmetic (the sw_combine_bf16 form).
    Counterpart of pallas_sw.forward_tendencies' COMBINE (_combine_kernel,
    _combine_axpy_kernel)."""
    nx, hny = lap.shape
    store = _products("sw_combine", pr, pi, nx, hny)
    planes = (*state, lap, mask) + (() if src is None else tuple(src))
    if len(state) != 6 or (src is not None and len(src) != 2):
        raise ValueError("sw_combine: expected six state planes and two "
                         "source planes (or None)")
    if axpy is not None:
        if len(axpy[0]) != 6:
            raise ValueError("sw_combine: expected six base state planes")
        planes += tuple(axpy[0])
    _check("sw_combine", (nx, hny), *planes)
    _check("sw_combine", (nx,), kx)
    _check("sw_combine", (hny,), ky)
    if any(t.device != pr.device for t in (kx, ky, lap)):
        raise ValueError("sw_combine: tables and planes on different "
                         "devices")
    if _takes_plain("sw_combine", pr):
        return sw_combine_plain(pr, pi, state, src, kx, ky, lap, mask, f0,
                                grav, nu, H, split, axpy)
    from ._build import lib
    tend = [torch.empty_like(lap) for _ in range(6)]
    nxt = [torch.empty_like(lap) for _ in range(6 if axpy else 0)]
    srcp = [None, None] if src is None else _ptrs(*src)
    z0p = [None] * 6 if axpy is None else _ptrs(*axpy[0])
    table = (ctypes.c_void_p * 32)(
        *_ptrs(pr, pi, *state), *srcp, *_ptrs(kx, ky, lap, mask), *z0p,
        *_ptrs(*tend), *(_ptrs(*nxt) if axpy else [None] * 6))
    coef = 0.0 if axpy is None else float(axpy[1])
    name = "sw_combine_bf16" if store == "bf16" else "sw_combine"
    _launch(name, getattr(lib(), "xfb_" + name), ctypes.addressof(table),
            nx, hny, float(f0), float(grav), float(nu), float(H),
            int(split), coef, pr.device.index, _stream(pr))
    return tuple(tend) if axpy is None else (tuple(tend), tuple(nxt))


# ---------------------------------------------------------- sw_combine_mv

def sw_combine_mv_plain(pr, pi, state, src, kx, ky, lap, mask, f0: float,
                        grav: float, nu: float, H: float, z0, q,
                        scale: float, emit_tend: bool = True,
                        split: bool = False):
    tend = sw_combine_plain(pr, pi, state, src, kx, ky, lap, mask, f0,
                            grav, nu, H, split)
    stage = []
    for i in range(3):
        qi0, qi1, qi2 = (scale * q[i, j] for j in range(3))
        stage += [z0[2 * i] + qi0 * tend[0] + qi1 * tend[2] + qi2 * tend[4],
                  z0[2 * i + 1] + qi0 * tend[1] + qi1 * tend[3]
                  + qi2 * tend[5]]
    return (tend if emit_tend else None), tuple(stage)


def sw_combine_mv(pr, pi, state, src, kx, ky, lap, mask, f0: float,
                  grav: float, nu: float, H: float, z0, q, scale: float,
                  emit_tend: bool = True, split: bool = False):
    """sw_combine's tendency planes fused with an ETDRK4 stage: also the
    six planes of stage = z0 + scale * (Q @ tendency), with q the
    per-mode 3x3 table (3, 3, nx, hny) (models/etdrk4.py), per row i
    ((z0 + (scale q_i0) t_zeta) + (scale q_i1) t_div) + (scale q_i2) t_eta
    on the re and the im planes. Returns (tend, stage), tend None when
    emit_tend is False (the last ETDRK4 stage never reads it). The
    product planes may be bf16, as sw_combine's (the sw_combine_mv_bf16
    form). Counterpart of pallas_sw.forward_tendencies' COMBINE with
    mv_axpy (_combine_mv_kernel)."""
    nx, hny = lap.shape
    store = _products("sw_combine_mv", pr, pi, nx, hny)
    if len(state) != 6 or len(z0) != 6 or (src is not None
                                           and len(src) != 2):
        raise ValueError("sw_combine_mv: expected six state planes, six "
                         "base planes and two source planes (or None)")
    planes = (*state, lap, mask, *z0) + (() if src is None else tuple(src))
    _check("sw_combine_mv", (nx, hny), *planes)
    _check("sw_combine_mv", (3, 3, nx, hny), q)
    _check("sw_combine_mv", (nx,), kx)
    _check("sw_combine_mv", (hny,), ky)
    if any(t.device != pr.device for t in (kx, ky, lap, q)):
        raise ValueError("sw_combine_mv: tables and planes on different "
                         "devices")
    if _takes_plain("sw_combine_mv", pr):
        return sw_combine_mv_plain(pr, pi, state, src, kx, ky, lap, mask,
                                   f0, grav, nu, H, z0, q, scale, emit_tend,
                                   split)
    from ._build import lib
    tend = [torch.empty_like(lap) for _ in range(6 if emit_tend else 0)]
    stage = [torch.empty_like(lap) for _ in range(6)]
    srcp = [None, None] if src is None else _ptrs(*src)
    table = (ctypes.c_void_p * 33)(
        *_ptrs(pr, pi, *state), *srcp, *_ptrs(kx, ky, lap, mask, *z0, q),
        *(_ptrs(*tend) if emit_tend else [None] * 6), *_ptrs(*stage))
    name = "sw_combine_mv_bf16" if store == "bf16" else "sw_combine_mv"
    _launch(name, getattr(lib(), "xfb_" + name), ctypes.addressof(table), nx, hny, float(f0), float(grav),
            float(nu), float(H), int(split), float(scale), pr.device.index,
            _stream(pr))
    return (tuple(tend) if emit_tend else None), tuple(stage)


# ------------------------------------------------------- stage composites

def forward_tendencies(u, v, zeta, eta_s, state, src, kx, ky, lap, mask,
                       f0: float, grav: float, nu: float, H: float,
                       eta_scale: float = 1.0, axpy=None,
                       split: bool = False, mv_axpy=None,
                       yfirst: bool = True, fast: bool = False,
                       pstore: str = "f32"):
    """The dealiased SW tendency planes from the fields of
    inverse_quad_planes: y-major, ky_all + kx_fwd + sw_combine; with
    yfirst False x-major, ka_fwd + kc_sw + sw_combine (with axpy: also
    the next stage state). mv_axpy=(z0, q, scale, emit_tend) takes
    sw_combine_mv instead and returns (tend or None, z0 + scale *
    (q @ tend)); it does not combine with axpy. `fast` runs ky_all and
    kx_fwd (ka_fwd and kc_sw) on the fast column tile. `pstore` is the
    y-first kx_fwd's product store; the x-first kc_sw stores float32 in
    either mode, and the float32 combines read it, as in the JAX package
    (pallas_sw.py's KC_SW out_shape). Counterpart of
    pallas_sw.forward_tendencies (YFIRST = yfirst)."""
    if axpy is not None and mv_axpy is not None:
        raise ValueError("forward_tendencies: axpy and mv_axpy are "
                         "mutually exclusive")
    if yfirst:
        pr, pi = kx_fwd(*ky_all(u, v, zeta, eta_s, 1.0 / eta_scale, f0,
                                grav, split, fast=fast),
                        fast=fast, pstore=pstore)
    else:
        pr, pi = kc_sw(*ka_fwd(u, v, zeta, eta_s, 1.0 / eta_scale, f0,
                               grav, split, fast), fast)
    if mv_axpy is not None:
        z0, q, scale, emit_tend = mv_axpy
        return sw_combine_mv(pr, pi, state, src, kx, ky, lap, mask, f0,
                             grav, nu, H, z0, q, scale, emit_tend, split)
    return sw_combine(pr, pi, state, src, kx, ky, lap, mask, f0, grav, nu,
                      H, split, axpy)


def forward_planes(src, fast: bool = False):
    """Forward rfft2 (unnormalized) of the physical (nx, ny) forcing as
    (re, im) planes (nx, hny): ka (real input) + kc; `fast`: both on the
    fast column tile. Counterpart of pallas_sw.forward_planes; computed
    once per segment."""
    return kc(*ka(src, None, forward=True, fast=fast), fast=fast)
