"""The plane stepper's transform kernels: the counterpart of the
plane-stepper part of xlab_fftbarotropic_tpu/ops/pallas_fft.py, and the
launch machinery every kernel wrapper of the port shares.

One RK stage of the barotropic plane stepper runs five launches of four
kernels, each a hand-written CUDA kernel (csrc/) around the column-tile
transform of csrc/xtile.cuh, planned by ops/xtile.py, as is every
other kernel of this module:

  ka_diag   the four derivative fields' inverse x-stage   (stacked out)
  kb_pair   paired c2r y-stage, called for (0, 1) and (2, 3)
  ky_adv    advection product + real forward y-stage
  kx_visc   forward x-stage + viscosity/dealias epilogue, with the RK
            stage axpy fused in for stages 1-3 (stacked over fields:
            the tracer family runs it on two)

and the RK4 tail is one rk4_combine launch per step (ops/fused_sw.py).

That is the y-first order, the JAX package's default, and its default
fusion arm. The others (the JAX package's XFB_BT_FUSEKB, XFB_BT_FUSEKX
and XFB_BT_FUSETAIL) swap kernels in:

  kb_adv_full   both kb_pair and ky_adv in one kernel (FUSEKB=full)
  kb_adv_half   the (u, v) kb_pair and ky_adv in one kernel (=half)
  kx_fwd + visc kx_visc unfused: the raw x-stage (ops/fused_sw.py) and
                an elementwise epilogue pass (FUSEKX=0)
  kx_visc_tail  stage 4's kx_visc with the RK4 tail in its epilogue, in
                place of rk4_combine (FUSETAIL=1)

forward_tail picks the forward x-stage's form and
tendency_yfirst_fusedkb runs a whole stage with FUSEKB. The x-first order
(XFB_BT_YFIRST=0 there) ends the inverse with two kb writing the fields
x-major (kb_stacked) and runs the forward pipeline as

  ka_adv    advection product + real forward x-stage, written transposed
  kc_visc   forward partial y-stage + viscosity/dealias epilogue

and QUAD_MODE "quad" or "split" (x-first only) takes ka_quad, the same
x-stage as ka_diag in the psi-first grouping of the TPU's _ka4/_ka2.

The per-transform pipeline, the counterpart of pallas_fft.rfft2,
inverse_pair and irfft2, is three kernels: ka, the x-stage of any mode
(forward or inverse, real or complex input, scaled) with a transposed
write; kc, the forward partial y-stage; kb, the paired c2r y-stage
written x-major. rfft2 is ka + kc, inverse_pair two ka + one kb, irfft2
one ka + one kb (the zero partner is left out). They serve the
shallow-water forcing spectrum (ops/fused_sw.py:forward_planes), the
shallow-water RK4 step with drag or hyperviscosity, and, with their
adjoints (ops/fused_diff.py), the differentiable rollout (adjoint.py).

Layouts are the TPU kernels' public ones, so the tests compare like with
like: spectral planes (nx, hny) or stacks (F, nx, hny), the stacked
x-stage output (F, hny, nx), physical fields y-major (ny, nx); every
array is float32 (re, im) planes, C-contiguous.

Each wrapper checks its arguments and then dispatches on the tensors'
device alone: a CPU tensor takes the plain version beside it (torch.fft
along one axis), a CUDA tensor launches the kernel on the current stream
or raises. LAUNCHES counts kernel launches per kernel, for every kernel
of the port (the distributed path's in parallel/fused_transpose.py and
parallel/fused_overlap.py too); the plain versions never touch it.
"""

from __future__ import annotations

import numpy as np
import torch

LAUNCHES = {"ka_diag": 0, "kb_pair": 0, "ky_adv": 0, "kx_visc": 0,
            "ka6": 0, "kb_adv_tracer": 0, "rk4_combine": 0,
            "ka_sw": 0, "ky_all": 0, "kx_fwd": 0, "sw_combine": 0,
            "sw_combine_mv": 0, "ka": 0, "kc": 0, "kb": 0,
            "plane_axpy": 0, "ka_adv": 0, "kc_visc": 0, "ka_quad": 0,
            "ka_fwd": 0, "kc_sw": 0, "kb_adv_full": 0, "kb_adv_half": 0,
            "kx_visc_tail": 0, "visc": 0, "a2a_cols": 0, "a2a_rows": 0,
            "xstage": 0, "xstage_gather": 0, "xstage_scatter": 0}

# the KB + advection fusion's arms (pallas_fft.fusekb_mode): "" none
FUSEKB_MODES = ("", "half", "full")

# the derivative x-stage's forms (pallas_fft.QUAD_MODE): "grid" is
# ka_diag; "quad" one ka_quad of four fields, "split" two of two
QUAD_MODES = ("grid", "quad", "split")

# transform lengths the kernels take: powers of two whose column fits
# one block's shared memory (8192 complex64 = 64 KB)
MIN_N, MAX_N = 64, 8192


def supported_length(n: int) -> bool:
    return MIN_N <= n <= MAX_N and n & (n - 1) == 0


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_TWIDDLES: dict = {}


def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """The column-tile kernels' twiddle table exp(-2 pi i k / n), k < n/2,
    as (n/2, 2) float32 (re, im) pairs: computed in float64, rounded once;
    one per (n, device)."""
    key = (n, device)
    if key not in _TWIDDLES:
        w = np.exp(-2j * np.pi * np.arange(n // 2) / n)
        host = np.stack([w.real, w.imag], axis=-1).astype(np.float32)
        _TWIDDLES[key] = torch.from_numpy(host).to(device)
    return _TWIDDLES[key]


def _check(name: str, shape, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is float32, C-contiguous, of `shape`
    and on the first tensor's device."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")


def _takes_plain(name: str, t: torch.Tensor, *lengths: int) -> bool:
    """True for a CPU tensor (the plain version runs). For a CUDA tensor,
    False once the kernel is known to take the transform lengths; any
    other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    for n in lengths:
        if not supported_length(n):
            raise ValueError(f"{name}: the CUDA kernel takes power-of-two "
                             f"lengths {MIN_N}..{MAX_N}, got {n}")
    return False


def _xtile_args(n: int, columns: int, elem_bytes: int) -> tuple:
    """The column-tile plan's launch arguments (tile_c, cluster_k,
    threads, smem) of csrc/xtile.cuh (ops/xtile.py)."""
    from .xtile import xtile_plan
    p = xtile_plan(n, columns, elem_bytes)
    return p.c, p.k, p.threads, p.smem


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{torch.cuda.CudaError(rc)}")
    LAUNCHES[name] += 1


def _ptrs(*tensors: torch.Tensor) -> list:
    return [t.data_ptr() for t in tensors]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------- ka_diag

def diagonal_fields(sr, si, rlap, kx, ky, kinds, psi_first=False):
    """The diagonal-scaled fields (re, im lists) of one state plane S:
    kind 0 i kx S, 1 i ky S, 2 -i ky psi, 3 i kx psi (psi = S*rlap), in
    the kernels' grouping: diagonal first, then rlap (ka_diag, ka6), or
    with psi_first psi = S*rlap first, then the diagonal (ka_quad)."""
    k = kx.reshape(-1, 1)
    q = ky.reshape(1, -1)
    field = {0: lambda: (-(si * k), sr * k),
             1: lambda: (-(si * q), sr * q),
             2: lambda: ((si * q) * rlap, -(sr * q) * rlap),
             3: lambda: (-(si * k) * rlap, (sr * k) * rlap)}
    if psi_first:
        pr, pi = sr * rlap, si * rlap
        field[2] = lambda: (q * pi, -(q * pr))
        field[3] = lambda: (-(k * pi), k * pr)
    pairs = [field[c]() for c in kinds]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def inverse_xstage_plain(re, im):
    """Unnormalized inverse x-DFT of the stacked fields, transposed:
    (F, n, hny) (re, im) -> (F, hny, n) planes."""
    y = torch.fft.ifft(torch.complex(torch.stack(re), torch.stack(im)),
                       dim=1, norm="forward")
    y = y.transpose(1, 2)
    return y.real.contiguous(), y.imag.contiguous()


def ka_diag_plain(zr, zi, rlap, kx, ky):
    return inverse_xstage_plain(*diagonal_fields(zr, zi, rlap, kx, ky,
                                                 range(4)))


def ka_diag(zr, zi, rlap, kx, ky):
    """(i kx Z, i ky Z, -i ky psi, i kx psi) with psi = Z*rlap, inverse
    x-DFT (unnormalized), written transposed: (wr, wi) (4, hny, nx).
    Counterpart of pallas_fft.derivative_xstage_planes."""
    n, hny = zr.shape
    _check("ka_diag", (n, hny), zr, zi, rlap)
    _check("ka_diag", (n,), kx)
    _check("ka_diag", (hny,), ky)
    if kx.device != zr.device or ky.device != zr.device:
        raise ValueError("ka_diag: tables and state on different devices")
    if _takes_plain("ka_diag", zr, n):
        return ka_diag_plain(zr, zi, rlap, kx, ky)
    from ._build import lib
    wr = torch.empty((4, hny, n), dtype=torch.float32, device=zr.device)
    wi = torch.empty_like(wr)
    _launch("ka_diag", lib().xfb_ka_diag,
            *_ptrs(zr, zi, rlap, kx, ky, _twiddles(n, zr.device), wr, wi),
            n, hny, *_xtile_args(n, hny, 4), zr.device.index, _stream(zr))
    return wr, wi


# ---------------------------------------------------------------- ka_quad

def ka_quad_plain(zr, zi, rlap, kx, ky, first: int = 0, count: int = 4):
    return inverse_xstage_plain(*diagonal_fields(
        zr, zi, rlap, kx, ky, range(first, first + count), psi_first=True))


def ka_quad(zr, zi, rlap, kx, ky, first: int = 0, count: int = 4):
    """Fields first .. first+count-1 of ka_diag's four, in the psi-first
    grouping, inverse x-DFT (unnormalized), written transposed: (wr, wi)
    (count, hny, nx). Counterpart of pallas_fft._ka4_kernel (first 0,
    count 4) and _ka2_kernel ("zderiv": 0, 2; "pderiv": 2, 2), whose
    (hny, nx) planes are the stack's fields."""
    n, hny = zr.shape
    if (first, count) not in ((0, 4), (0, 2), (2, 2)):
        raise ValueError(f"ka_quad: fields {first}..{first + count - 1} are "
                         f"not a quad or split call")
    _check("ka_quad", (n, hny), zr, zi, rlap)
    _check("ka_quad", (n,), kx)
    _check("ka_quad", (hny,), ky)
    if kx.device != zr.device or ky.device != zr.device:
        raise ValueError("ka_quad: tables and state on different devices")
    if _takes_plain("ka_quad", zr, n):
        return ka_quad_plain(zr, zi, rlap, kx, ky, first, count)
    from ._build import lib
    wr = torch.empty((count, hny, n), dtype=torch.float32, device=zr.device)
    wi = torch.empty_like(wr)
    _launch("ka_quad", lib().xfb_ka_quad,
            *_ptrs(zr, zi, rlap, kx, ky, _twiddles(n, zr.device), wr, wi),
            n, hny, first, count, *_xtile_args(n, hny, 4), zr.device.index,
            _stream(zr))
    return wr, wi


# ---------------------------------------------------------------- kb_pair

def kb_pair_plain(wr, wi, fa: int, fb: int, scale: float):
    hny = wr.shape[1]
    half = hny - 1
    re = wr[[fa, fb]]
    im = wi[[fa, fb]].clone()
    im[:, 0] = 0.0          # self-conjugate rows: real part only
    im[:, half] = 0.0
    out = torch.fft.irfft(torch.complex(re, im), n=2 * half, dim=1,
                          norm="forward") * scale
    return out[0].contiguous(), out[1].contiguous()


def kb_pair(wr, wi, fa: int, fb: int, scale: float):
    """Paired c2r y-stage of fields fa, fb of a stacked (F, hny, nx)
    x-stage output (F = 4 from ka_diag, 6 from ka6) -> a, b y-major
    (ny, nx), scaled by `scale` (1/(nx*ny) in the stepper). Counterpart
    of pallas_fft._kb_call_stacked(..., transpose_out=False)."""
    if wr.dim() != 3:
        raise ValueError(f"kb_pair: expected (F, hny, nx), got "
                         f"{tuple(wr.shape)}")
    nf, hny, nx = wr.shape
    ny = 2 * (hny - 1)
    _check("kb_pair", (nf, hny, nx), wr, wi)
    if not (0 <= fa < nf and 0 <= fb < nf):
        raise ValueError(f"kb_pair: field indices {fa}, {fb} not in "
                         f"0..{nf - 1}")
    if _takes_plain("kb_pair", wr, ny):
        return kb_pair_plain(wr, wi, fa, fb, scale)
    from ._build import lib
    oa = torch.empty((ny, nx), dtype=torch.float32, device=wr.device)
    ob = torch.empty_like(oa)
    _launch("kb_pair", lib().xfb_kb_pair, *_ptrs(wr, wi), fa, fb,
            *_ptrs(_twiddles(ny, wr.device), oa, ob), ny, nx, float(scale),
            *_xtile_args(ny, nx, 4), wr.device.index, _stream(wr))
    return oa, ob


def kb_stacked(wr, wi, fa: int, fb: int, scale: float):
    """kb_pair's function written x-major: fields fa, fb of a stacked
    (F, hny, nx) x-stage output -> a, b (nx, ny), scaled by `scale`: one
    kb on the stack's field planes (a launch of kb). Counterpart of
    pallas_fft._kb_call_stacked(..., transpose_out=True)."""
    if wr.dim() != 3:
        raise ValueError(f"kb_stacked: expected (F, hny, nx), got "
                         f"{tuple(wr.shape)}")
    nf = wr.shape[0]
    _check("kb_stacked", tuple(wr.shape), wr, wi)
    if not (0 <= fa < nf and 0 <= fb < nf):
        raise ValueError(f"kb_stacked: field indices {fa}, {fb} not in "
                         f"0..{nf - 1}")
    return kb(wr[fa], wi[fa], wr[fb], wi[fb], scale)


# ----------------------------------------------------------------- ky_adv

def advection(u, zx, v, zy, src, beta: float = 0.0):
    """-u*zx - v*(zy + beta) + src, each product and sum rounded on its
    own in csrc/epilogue.cuh advection's order (zy + beta first, and only
    for beta != 0), so kc (ka) of it gives ky_adv's (ka_adv's) bits."""
    if beta != 0.0:
        zy = zy + beta
    return -(u * zx) - v * zy + src


def ky_adv_plain(u, zx, v, zy, src, beta: float = 0.0):
    f = torch.fft.rfft(advection(u, zx, v, zy, src, beta),
                       dim=0).transpose(0, 1)
    return f.real.contiguous(), f.imag.contiguous()


def ky_adv(u, zx, v, zy, src, beta: float = 0.0):
    """-u*zx - v*(zy + beta) + src on y-major (ny, nx) fields, real
    forward y-DFT, rows k <= ny/2 -> (nx, hny) planes. Counterpart of
    the first kernel of pallas_fft.forward_tendency_yfirst."""
    ny, nx = u.shape
    _check("ky_adv", (ny, nx), u, zx, v, zy, src)
    if _takes_plain("ky_adv", u, ny):
        return ky_adv_plain(u, zx, v, zy, src, beta)
    from ._build import lib
    hny = ny // 2 + 1
    outr = torch.empty((nx, hny), dtype=torch.float32, device=u.device)
    outi = torch.empty_like(outr)
    _launch("ky_adv", lib().xfb_ky_adv,
            *_ptrs(u, zx, v, zy, src, _twiddles(ny, u.device), outr, outi),
            ny, nx, float(beta), *_xtile_args(ny, nx, 4), u.device.index,
            _stream(u))
    return outr, outi


# ---------------------------------------------------------------- kx_visc

def kx_visc_plain(fr, fi, lap, mask, zsr, zsi, nu: float, axpy=None):
    f = torch.fft.fft(torch.complex(fr, fi), dim=-2)
    return visc_plain(f.real, f.imag, lap, mask, zsr, zsi, nu, axpy)


def kx_visc(fr, fi, lap, mask, zsr, zsi, nu: float, axpy=None):
    """Forward x-DFT of (fr + i fi) over the hny columns with the epilogue
    mask * (F + nu*lap*Zs) -> (rr, ri); with axpy=(z0r, z0i, coef) also
    the next RK stage state (z0r + coef*rr, z0i + coef*ri).

    fr, fi, lap, zsr, zsi (and z0r, z0i) are one field (nx, hny) or a
    stack (F, nx, hny) with a table per field; mask (nx, hny) is shared.
    Counterpart of pallas_fft.forward_tail (_kx_visc_kernel, with and
    without coef) and of pallas_tracer.forward_tail_tracer
    (_kx_visc_tracer_kernel: F = 2, nu = 1, the stacked table)."""
    shape = tuple(fr.shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"kx_visc: expected (nx, hny) or (F, nx, hny), "
                         f"got {shape}")
    nx, hny = shape[-2:]
    planes = (fr, fi, lap, zsr, zsi) + (() if axpy is None else axpy[:2])
    _check("kx_visc", shape, *planes)
    _check("kx_visc", (nx, hny), mask)
    if mask.device != fr.device:
        raise ValueError("kx_visc: mask and planes on different devices")
    if _takes_plain("kx_visc", fr, nx):
        return kx_visc_plain(fr, fi, lap, mask, zsr, zsi, nu, axpy)
    from ._build import lib
    outs = [torch.empty(shape, dtype=torch.float32, device=fr.device)
            for _ in range(2 if axpy is None else 4)]
    z0 = (None, None) if axpy is None else _ptrs(*axpy[:2])
    nr_ni = (None, None) if axpy is None else _ptrs(*outs[2:])
    coef = 0.0 if axpy is None else float(axpy[2])
    _launch("kx_visc", lib().xfb_kx_visc,
            *_ptrs(fr, fi, lap, mask, zsr, zsi), *z0,
            _twiddles(nx, fr.device).data_ptr(), *_ptrs(*outs[:2]), *nr_ni,
            1 if len(shape) == 2 else shape[0], nx, hny, float(nu), coef,
            *_xtile_args(nx, hny, 4), fr.device.index, _stream(fr))
    return tuple(outs)


# ----------------------------------------------------------- kx_visc_tail

def _tail_planes(tail):
    """(z0, r1, r2, r3) as (re, im) pairs and c from tail=(z0r, z0i, r1r,
    r1i, r2r, r2i, r3r, r3i, c)."""
    if len(tail) != 9:
        raise ValueError(f"tail: expected (z0r, z0i, r1r, r1i, r2r, r2i, "
                         f"r3r, r3i, c), got {len(tail)} items")
    *planes, c = tail
    return [tuple(planes[k:k + 2]) for k in range(0, 8, 2)], float(c)


def kx_visc_tail_plain(fr, fi, lap, mask, zsr, zsi, nu: float, tail):
    from .fused_sw import plane_rk4_combine_plain
    (z0, r1, r2, r3), c = _tail_planes(tail)
    r4 = kx_visc_plain(fr, fi, lap, mask, zsr, zsi, nu)
    return plane_rk4_combine_plain(z0, r1, r2, r3, r4, c)


def kx_visc_tail(fr, fi, lap, mask, zsr, zsi, nu: float, tail):
    """kx_visc with the RK4 tail in its epilogue: the stage-4 tendency
    r = mask * (F + nu*lap*Zs) stays in the kernel, which writes only
    z0 + (r1 + 2 r2 + 2 r3 + r) * c, in rk4_combine's grouping, for
    tail=(z0r, z0i, r1r, r1i, r2r, r2i, r3r, r3i, c) -> (nr, ni). Shapes
    as kx_visc's. Counterpart of pallas_fft.forward_tail(tail=...)
    (_kx_visc_tail_kernel)."""
    shape = tuple(fr.shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"kx_visc_tail: expected (nx, hny) or (F, nx, "
                         f"hny), got {shape}")
    nx, hny = shape[-2:]
    pairs, c = _tail_planes(tail)
    _check("kx_visc_tail", shape, fr, fi, lap, zsr, zsi,
           *(p for pair in pairs for p in pair))
    _check("kx_visc_tail", (nx, hny), mask)
    if mask.device != fr.device:
        raise ValueError("kx_visc_tail: mask and planes on different "
                         "devices")
    if _takes_plain("kx_visc_tail", fr, nx):
        return kx_visc_tail_plain(fr, fi, lap, mask, zsr, zsi, nu, tail)
    from ._build import lib
    nr = torch.empty(shape, dtype=torch.float32, device=fr.device)
    ni = torch.empty_like(nr)
    _launch("kx_visc_tail", lib().xfb_kx_visc_tail,
            *_ptrs(fr, fi, lap, mask, zsr, zsi,
                   *(p for pair in pairs for p in pair),
                   _twiddles(nx, fr.device), nr, ni),
            1 if len(shape) == 2 else shape[0], nx, hny, float(nu), c,
            *_xtile_args(nx, hny, 4), fr.device.index, _stream(fr))
    return nr, ni


# ------------------------------------------------------------------- visc

def visc_plain(fr, fi, lap, mask, zr, zi, nu: float, axpy=None):
    nulap = nu * lap
    rr = mask * (fr + nulap * zr)
    ri = mask * (fi + nulap * zi)
    if axpy is None:
        return rr, ri
    z0r, z0i, coef = axpy
    return rr, ri, z0r + coef * rr, z0i + coef * ri


def visc(fr, fi, lap, mask, zr, zi, nu: float, axpy=None):
    """The viscosity and dealias epilogue mask * (F + nu*lap*Z) as an
    elementwise pass over (nx, hny) planes -> (rr, ri); with axpy=(z0r,
    z0i, coef) also the next RK stage state (z0r + coef*rr, z0i +
    coef*ri). kx_visc's epilogue, rounded alike. Counterpart of
    pallas_fft._visc_kernel and _visc_axpy_kernel."""
    if fr.dim() != 2:
        raise ValueError(f"visc: expected (nx, hny) planes, got "
                         f"{tuple(fr.shape)}")
    planes = (fr, fi, lap, mask, zr, zi) + (() if axpy is None
                                            else tuple(axpy[:2]))
    _check("visc", tuple(fr.shape), *planes)
    if _takes_plain("visc", fr):
        return visc_plain(fr, fi, lap, mask, zr, zi, nu, axpy)
    from ._build import lib
    outs = [torch.empty_like(fr) for _ in range(2 if axpy is None else 4)]
    z0 = (None, None) if axpy is None else _ptrs(*axpy[:2])
    nr_ni = (None, None) if axpy is None else _ptrs(*outs[2:])
    coef = 0.0 if axpy is None else float(axpy[2])
    _launch("visc", lib().xfb_visc, *_ptrs(fr, fi, lap, mask, zr, zi), *z0,
            *_ptrs(*outs[:2]), *nr_ni, fr.numel(), float(nu), coef,
            fr.device.index, _stream(fr))
    return tuple(outs)


# ----------------------------------------------------------------- kb_adv

def _kb_adv_scale(wr) -> float:
    nx = wr.shape[2]
    return 1.0 / (nx * 2 * (wr.shape[1] - 1))


def kb_adv_full_plain(wr, wi, src, beta: float = 0.0):
    scale = _kb_adv_scale(wr)
    zx, zy = kb_pair_plain(wr, wi, 0, 1, scale)
    u, v = kb_pair_plain(wr, wi, 2, 3, scale)
    return ky_adv_plain(u, zx, v, zy, src, beta)


def kb_adv_half_plain(zx, zy, wr, wi, src, beta: float = 0.0):
    u, v = kb_pair_plain(wr, wi, 2, 3, _kb_adv_scale(wr))
    return ky_adv_plain(u, zx, v, zy, src, beta)


def _kb_adv_check(name, wr, wi, *fields):
    if wr.dim() != 3 or wr.shape[0] != 4:
        raise ValueError(f"{name}: expected ka_diag's (4, hny, nx) stack, "
                         f"got {tuple(wr.shape)}")
    _, hny, nx = wr.shape
    ny = 2 * (hny - 1)
    _check(name, (4, hny, nx), wr, wi)
    _check(name, (ny, nx), *fields)
    if fields[0].device != wr.device:
        raise ValueError(f"{name}: fields and stack on different devices")
    return ny, nx


def kb_adv_full(wr, wi, src, beta: float = 0.0):
    """Both paired c2r y-stages of ka_diag's (4, hny, nx) stack (zeta_x,
    zeta_y from fields 0, 1; u, v from 2, 3; scaled by 1/(nx*ny)), then
    -u*zx - v*(zy + beta) + src with the y-major (ny, nx) src, real
    forward y-DFT, rows k <= ny/2 -> (nx, hny) planes; the four physical
    fields never reach memory. kb_pair x2 + ky_adv in one kernel, with
    their bits. Counterpart of pallas_fft.kb_adv_full
    (_kb_adv_full_kernel)."""
    ny, nx = _kb_adv_check("kb_adv_full", wr, wi, src)
    if _takes_plain("kb_adv_full", wr, ny):
        return kb_adv_full_plain(wr, wi, src, beta)
    from ._build import lib
    outr = torch.empty((nx, ny // 2 + 1), dtype=torch.float32,
                       device=wr.device)
    outi = torch.empty_like(outr)
    _launch("kb_adv_full", lib().xfb_kb_adv_full,
            *_ptrs(wr, wi, src, _twiddles(ny, wr.device), outr, outi), ny,
            nx, _kb_adv_scale(wr), float(beta), *_xtile_args(ny, nx, 4),
            wr.device.index, _stream(wr))
    return outr, outi


def kb_adv_half(zx, zy, wr, wi, src, beta: float = 0.0):
    """kb_adv_full with zeta_x, zeta_y given y-major (ny, nx) (one kb_pair
    of fields 0, 1 made them): the (u, v) c2r y-stage of fields 2, 3,
    the advection product and the real forward y-DFT -> (nx, hny)
    planes. kb_pair + ky_adv in one kernel, with their bits. Counterpart
    of pallas_fft.kb_adv_half (_kb_adv_half_kernel)."""
    ny, nx = _kb_adv_check("kb_adv_half", wr, wi, zx, zy, src)
    if _takes_plain("kb_adv_half", wr, ny):
        return kb_adv_half_plain(zx, zy, wr, wi, src, beta)
    from ._build import lib
    outr = torch.empty((nx, ny // 2 + 1), dtype=torch.float32,
                       device=wr.device)
    outi = torch.empty_like(outr)
    _launch("kb_adv_half", lib().xfb_kb_adv_half,
            *_ptrs(zx, zy, wr, wi, src, _twiddles(ny, wr.device), outr,
                   outi), ny, nx, _kb_adv_scale(wr), float(beta),
            *_xtile_args(ny, nx, 4), wr.device.index, _stream(wr))
    return outr, outi


# ----------------------------------------------------------------- ka_adv

def ka_adv_plain(u, zx, v, zy, src, beta: float = 0.0):
    return ka_plain(advection(u, zx, v, zy, src, beta), None, True)


def ka_adv(u, zx, v, zy, src, beta: float = 0.0):
    """-u*zx - v*(zy + beta) + src on x-major (nx, ny) fields, real
    forward x-DFT of each y column, written transposed: (ny, nx) planes.
    Counterpart of pallas_fft.forward_tendency's first kernel
    (_ka_adv_kernel). The kernel rounds the advection as `advection`
    does, so it is ka (real forward, scale 1) of the advection formed in
    torch, bit for bit."""
    if u.dim() != 2:
        raise ValueError(f"ka_adv: expected (nx, ny) fields, got "
                         f"{tuple(u.shape)}")
    nx, ny = u.shape
    _check("ka_adv", (nx, ny), u, zx, v, zy, src)
    if _takes_plain("ka_adv", u, nx):
        return ka_adv_plain(u, zx, v, zy, src, beta)
    from ._build import lib
    yr = torch.empty((ny, nx), dtype=torch.float32, device=u.device)
    yi = torch.empty_like(yr)
    _launch("ka_adv", lib().xfb_ka_adv,
            *_ptrs(u, zx, v, zy, src, _twiddles(nx, u.device), yr, yi),
            nx, ny, float(beta), *_xtile_args(nx, ny, 4), u.device.index,
            _stream(u))
    return yr, yi


# --------------------------------------------------------------------- ka

def ka_plain(xr, xi, forward: bool, scale: float = 1.0):
    x = xr.to(torch.complex64) if xi is None else torch.complex(xr, xi)
    y = (torch.fft.fft(x, dim=0) if forward
         else torch.fft.ifft(x, dim=0, norm="forward")) * scale
    y = y.transpose(0, 1)
    return y.real.contiguous(), y.imag.contiguous()


def ka(xr, xi, forward: bool, scale: float = 1.0):
    """scale * the unnormalized DFT along axis 0 (exp(-2 pi i jk/n) when
    `forward`, exp(+...) else) of (n, m) planes xr + i xi, or of the real
    plane xr when xi is None, written transposed: (m, n) planes (yr, yi).
    Counterpart of pallas_fft._ka_call (_ka_kernel), every mode."""
    if xr.dim() != 2:
        raise ValueError(f"ka: expected (n, m) planes, got {tuple(xr.shape)}")
    n, m = xr.shape
    _check("ka", (n, m), *((xr,) if xi is None else (xr, xi)))
    if _takes_plain("ka", xr, n):
        return ka_plain(xr, xi, forward, scale)
    from ._build import lib
    yr = torch.empty((m, n), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    _launch("ka", lib().xfb_ka, xr.data_ptr(),
            None if xi is None else xi.data_ptr(),
            *_ptrs(_twiddles(n, xr.device), yr, yi), n, m,
            1 if forward else 0, float(scale), *_xtile_args(n, m, 4),
            xr.device.index, _stream(xr))
    return yr, yi


# --------------------------------------------------------------------- kc

def kc_plain(xr, xi):
    ny = xr.shape[0]
    y = torch.fft.fft(torch.complex(xr, xi), dim=0)[:ny // 2 + 1]
    y = y.transpose(0, 1)
    return y.real.contiguous(), y.imag.contiguous()


def kc(xr, xi):
    """Forward DFT along y of the y-major (ny, nx) planes xr + i xi, rows
    k <= ny/2 kept and written transposed: (nx, hny) planes. Counterpart
    of pallas_fft._kc_call (_kc_kernel)."""
    if xr.dim() != 2:
        raise ValueError(f"kc: expected (ny, nx) planes, got "
                         f"{tuple(xr.shape)}")
    ny, nx = xr.shape
    _check("kc", (ny, nx), xr, xi)
    if _takes_plain("kc", xr, ny):
        return kc_plain(xr, xi)
    from ._build import lib
    hny = ny // 2 + 1
    yr = torch.empty((nx, hny), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    _launch("kc", lib().xfb_kc, *_ptrs(xr, xi, _twiddles(ny, xr.device),
                                       yr, yi),
            ny, nx, *_xtile_args(ny, nx, 4), xr.device.index, _stream(xr))
    return yr, yi


# ---------------------------------------------------------------- kc_visc

def kc_visc_plain(xr, xi, lap, mask, zr, zi, nu: float):
    yr, yi = kc_plain(xr, xi)
    nulap = nu * lap
    return mask * (yr + nulap * zr), mask * (yi + nulap * zi)


def kc_visc(xr, xi, lap, mask, zr, zi, nu: float):
    """kc of the (ny, nx) planes with the epilogue mask * (Y + nu*lap*Z)
    on the (nx, hny) tables and current stage state -> (nx, hny) planes.
    Counterpart of pallas_fft.forward_tendency's second kernel
    (_kc_visc_kernel)."""
    if xr.dim() != 2:
        raise ValueError(f"kc_visc: expected (ny, nx) planes, got "
                         f"{tuple(xr.shape)}")
    ny, nx = xr.shape
    hny = ny // 2 + 1
    _check("kc_visc", (ny, nx), xr, xi)
    _check("kc_visc", (nx, hny), lap, mask, zr, zi)
    if lap.device != xr.device:
        raise ValueError("kc_visc: tables and planes on different devices")
    if _takes_plain("kc_visc", xr, ny):
        return kc_visc_plain(xr, xi, lap, mask, zr, zi, nu)
    from ._build import lib
    yr = torch.empty((nx, hny), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    _launch("kc_visc", lib().xfb_kc_visc,
            *_ptrs(xr, xi, lap, mask, zr, zi, _twiddles(ny, xr.device), yr,
                   yi), ny, nx, float(nu), *_xtile_args(ny, nx, 4),
            xr.device.index, _stream(xr))
    return yr, yi


# --------------------------------------------------------------------- kb

def kb_plain(war, wai, wbr, wbi, scale: float):
    half = war.shape[0] - 1
    if wbr is None:
        wbr, wbi = torch.zeros_like(war), torch.zeros_like(wai)
    re = torch.stack([war, wbr])
    im = torch.stack([wai, wbi])
    im[:, 0] = 0.0          # self-conjugate rows: real part only
    im[:, half] = 0.0
    out = torch.fft.irfft(torch.complex(re, im), n=2 * half, dim=1,
                          norm="forward") * scale
    return out[0].t().contiguous(), out[1].t().contiguous()


def kb(war, wai, wbr, wbi, scale: float):
    """Paired c2r y-stage of two (hny, nx) x-stage outputs (war + i wai,
    wbr + i wbi), rows 0..ny/2, the self-conjugate rows 0 and ny/2
    projected to their real part -> a, b x-major (nx, ny), scaled by
    `scale`. wbr = wbi = None is a zero partner: b is neither read nor
    computed, and None is returned in its place. Counterpart of
    pallas_fft._kb_call (_kb_kernel)."""
    if war.dim() != 2:
        raise ValueError(f"kb: expected (hny, nx) planes, got "
                         f"{tuple(war.shape)}")
    if (wbr is None) != (wbi is None):
        raise ValueError("kb: give both b planes or neither")
    hny, nx = war.shape
    ny = 2 * (hny - 1)
    _check("kb", (hny, nx), war, wai, *(() if wbr is None else (wbr, wbi)))
    if _takes_plain("kb", war, ny):
        a, b = kb_plain(war, wai, wbr, wbi, scale)
        return a, (None if wbr is None else b)
    from ._build import lib
    oa = torch.empty((nx, ny), dtype=torch.float32, device=war.device)
    ob = None if wbr is None else torch.empty_like(oa)
    _launch("kb", lib().xfb_kb, *_ptrs(war, wai),
            *((None, None) if wbr is None else _ptrs(wbr, wbi)),
            *_ptrs(_twiddles(ny, war.device), oa),
            None if ob is None else ob.data_ptr(), ny, nx, float(scale),
            *_xtile_args(ny, nx, 4), war.device.index, _stream(war))
    return oa, ob


# --------------------------------------------- per-transform composites

def _planes(spec: torch.Tensor):
    return spec.real.contiguous(), spec.imag.contiguous()


def rfft2(x: torch.Tensor) -> torch.Tensor:
    """Real (nx, ny) float32 -> half-spectrum (nx, ny//2+1) complex64,
    unnormalized (ops/fft.py contract): ka (forward, real input) + kc.
    Counterpart of pallas_fft.rfft2."""
    return torch.complex(*kc(*ka(x.contiguous(), None, forward=True)))


def inverse_pair(spec_a: torch.Tensor, spec_b: torch.Tensor,
                 grid_shape) -> tuple:
    """Two half-spectra -> two real (nx, ny) fields, each scaled by
    1/(nx*ny): two ka (inverse, complex input) + one kb. Counterpart of
    pallas_fft.inverse_pair."""
    nx, ny = grid_shape
    wa = ka(*_planes(spec_a), forward=False)
    wb = ka(*_planes(spec_b), forward=False)
    return kb(*wa, *wb, 1.0 / (nx * ny))


def irfft2(spec: torch.Tensor, grid_shape) -> torch.Tensor:
    """One half-spectrum -> real (nx, ny), scaled by 1/(nx*ny): one ka +
    one kb with no partner. pallas_fft.irfft2 runs inverse_pair with a
    zero partner (two ka); the port leaves the zero partner's ka out,
    with the same result."""
    nx, ny = grid_shape
    return kb(*ka(*_planes(spec), forward=False), None, None,
              1.0 / (nx * ny))[0]


# ------------------------------------------------------- stage composites

def derivative_quad_planes(zr, zi, kx, ky, rlap, ymajor: bool = True,
                           quad_mode: str = "grid"):
    """(zeta_x, zeta_y, u, v) from the spectral state planes, y-major
    (ny, nx) with `ymajor` (ka_diag + two kb_pair), else x-major (nx, ny)
    (the x-stage + two kb_stacked). quad_mode "grid" takes ka_diag for
    the x-stage; "quad" one ka_quad, "split" two, both x-major only.
    Counterpart of pallas_fft.derivative_quad_planes with QUAD_MODE =
    quad_mode."""
    if quad_mode not in QUAD_MODES:
        raise ValueError(f"unknown quad_mode {quad_mode!r}, not one of "
                         f"{QUAD_MODES}")
    if ymajor and quad_mode != "grid":
        raise NotImplementedError("ymajor requires quad_mode='grid'")
    nx, hny = zr.shape
    scale = 1.0 / (nx * 2 * (hny - 1))
    if quad_mode == "split":
        zx, zy = kb_stacked(*ka_quad(zr, zi, rlap, kx, ky, 0, 2), 0, 1,
                            scale)
        u, v = kb_stacked(*ka_quad(zr, zi, rlap, kx, ky, 2, 2), 0, 1, scale)
        return zx, zy, u, v
    wr, wi = (ka_diag(zr, zi, rlap, kx, ky) if quad_mode == "grid"
              else ka_quad(zr, zi, rlap, kx, ky))
    pair = kb_pair if ymajor else kb_stacked
    zx, zy = pair(wr, wi, 0, 1, scale)
    u, v = pair(wr, wi, 2, 3, scale)
    return zx, zy, u, v


def forward_tendency(u, zx, v, zy, src, lap, mask, zr, zi, nu: float,
                     beta: float = 0.0):
    """dealias(rfft2(-u*zx - v*(zy+beta) + src) + nu*lap*Z) as (re, im)
    planes from x-major (nx, ny) fields: ka_adv + kc_visc. Counterpart
    of pallas_fft.forward_tendency (the x-first order)."""
    return kc_visc(*ka_adv(u, zx, v, zy, src, beta), lap, mask, zr, zi, nu)


def forward_tail(fr, fi, lap, mask, zr, zi, nu: float, axpy=None,
                 tail=None, fusekx: bool = True):
    """The y-first forward x-stage with its epilogue, from the forward
    y-stage planes (nx, hny): with `fusekx` one kx_visc (axpy=(z0r, z0i,
    coef): also the next stage state), or with tail=(z0r, z0i, r1r, r1i,
    r2r, r2i, r3r, r3i, c) one kx_visc_tail returning the stepped state;
    without `fusekx`, kx_fwd on the one field and a visc pass.
    Counterpart of pallas_fft.forward_tail with fusekx_on() = fusekx."""
    if tail is not None:
        if not fusekx:      # as pallas_fft.forward_tail (:1723)
            raise ValueError("tail fusion requires the fused kx_visc "
                             "(fusekx)")
        if axpy is not None:
            raise ValueError("give axpy or tail, not both")
        return kx_visc_tail(fr, fi, lap, mask, zr, zi, nu, tail)
    if fusekx:
        return kx_visc(fr, fi, lap, mask, zr, zi, nu, axpy)
    from .fused_sw import kx_fwd
    gr, gi = kx_fwd(fr[None], fi[None])
    return visc(gr[0], gi[0], lap, mask, zr, zi, nu, axpy)


def forward_tendency_yfirst(u, zx, v, zy, src, lap, mask, zr, zi,
                            nu: float, beta: float = 0.0, axpy=None,
                            tail=None, fusekx: bool = True):
    """dealias(rfft2(-u*zx - v*(zy+beta) + src) + nu*lap*Z) as (re, im)
    planes from y-major fields: ky_adv + forward_tail (axpy, tail and
    fusekx as there). Counterpart of pallas_fft.forward_tendency_yfirst."""
    fr, fi = ky_adv(u, zx, v, zy, src, beta)
    return forward_tail(fr, fi, lap, mask, zr, zi, nu, axpy, tail, fusekx)


def tendency_yfirst_fusedkb(sr, si, src, kx, ky, rlap, lap, mask,
                            nu: float, axpy=None, mode: str = "full",
                            beta: float = 0.0, tail=None,
                            fusekx: bool = True):
    """One whole y-first stage tendency with the KB + advection fusion:
    ka_diag, then kb_adv_full ("full"), or kb_pair of (zeta_x, zeta_y)
    and kb_adv_half ("half"), then forward_tail (axpy, tail and fusekx as
    there); `src` y-major (ny, nx). The same values as
    derivative_quad_planes + forward_tendency_yfirst. Counterpart of
    pallas_fft.tendency_yfirst_fusedkb."""
    wr, wi = ka_diag(sr, si, rlap, kx, ky)
    if mode == "full":
        fr, fi = kb_adv_full(wr, wi, src, beta)
    elif mode == "half":
        zx, zy = kb_pair(wr, wi, 0, 1, _kb_adv_scale(wr))
        fr, fi = kb_adv_half(zx, zy, wr, wi, src, beta)
    else:
        raise ValueError(f"unknown fusekb mode {mode!r}")
    return forward_tail(fr, fi, lap, mask, sr, si, nu, axpy, tail, fusekx)
