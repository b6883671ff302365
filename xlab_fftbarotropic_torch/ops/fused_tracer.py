"""The tracer family's plane stepper: the counterpart of
xlab_fftbarotropic_tpu/ops/pallas_tracer.py.

The state is the stacked float32 planes (2, nx, hny) x2 (re, im) of
[zeta_hat | q_hat]. Per RK stage, four kernels (csrc/):

  ka6            the six derivative fields' inverse x-stage: i kx Z,
                 i ky Z, -i ky psi, i kx psi, i kx Q, i ky Q
                 (csrc/ka_diag.cu at F = 6)
  kb_pair x2     paired c2r y-stages -> (zeta_x, zeta_y), (q_x, q_y)
  kb_adv_tracer  the (u, v) y-stage, both advection products and both
                 forward y-stages; the velocities stay in shared memory
  kx_visc        stacked forward x-stage + per-field diffusion epilogue
                 r = mask * (F + lap2 * state) with the stacked table
                 lap2 = [nu*lap - r_drag - nu4*lap^2 | kappa*lap], fused
                 with the RK stage axpy for stages 1-3

and the RK4 tail is one rk4_combine launch (ops/fused_sw.py). Same
numerics contract as models/tracer.py:rk4_step (dealiased tendencies,
state never dealiased, src fixed across stages). Each wrapper dispatches
as in ops/fused_fft.py: CPU tensors take the plain version beside it,
CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from .fused_fft import (_check, _launch, _ptrs, _stream, _takes_plain,
                        _twiddles, _xtile_args, diagonal_fields,
                        inverse_xstage_plain, kb_pair, kb_pair_plain, kx_visc)
from .fused_sw import plane_rk4_combine

# field f of the six reads state f // 4 and takes diagonal kind f % 4
_KINDS = (0, 1, 2, 3, 0, 1)


# -------------------------------------------------------------------- ka6

def ka6_plain(sr2, si2, rlap, kx, ky):
    z = diagonal_fields(sr2[0], si2[0], rlap, kx, ky, _KINDS[:4])
    q = diagonal_fields(sr2[1], si2[1], rlap, kx, ky, _KINDS[4:])
    return inverse_xstage_plain(z[0] + q[0], z[1] + q[1])


def tracer_xstage_planes(sr2, si2, kx, ky, rlap):
    """Stacked states (2, nx, hny) -> (wr, wi) (6, hny, nx), the six
    derivative x-stages (unnormalized inverse x-DFT, transposed).
    Counterpart of pallas_tracer.tracer_xstage_planes (_ka6_kernel)."""
    if sr2.dim() != 3 or sr2.shape[0] != 2:
        raise ValueError(f"ka6: expected (2, nx, hny) states, got "
                         f"{tuple(sr2.shape)}")
    _, n, hny = sr2.shape
    _check("ka6", (2, n, hny), sr2, si2)
    _check("ka6", (n, hny), rlap)
    _check("ka6", (n,), kx)
    _check("ka6", (hny,), ky)
    if any(t.device != sr2.device for t in (rlap, kx, ky)):
        raise ValueError("ka6: tables and state on different devices")
    if _takes_plain("ka6", sr2, n):
        return ka6_plain(sr2, si2, rlap, kx, ky)
    from ._build import lib
    wr = torch.empty((6, hny, n), dtype=torch.float32, device=sr2.device)
    wi = torch.empty_like(wr)
    _launch("ka6", lib().xfb_ka6,
            *_ptrs(sr2, si2, rlap, kx, ky, _twiddles(n, sr2.device), wr, wi),
            n, hny, *_xtile_args(n, hny, 4), sr2.device.index, _stream(sr2))
    return wr, wi


# ---------------------------------------------------------- kb_adv_tracer

def kb_adv_tracer_plain(zx, zy, qx, qy, wr, wi, src, beta: float = 0.0):
    ny, nx = zx.shape
    u, v = kb_pair_plain(wr, wi, 2, 3, 1.0 / (nx * ny))
    if beta != 0.0:
        zy = zy + beta
    adv_z = -(u * zx) - v * zy
    if src is not None:
        adv_z = adv_z + src
    adv_q = -(u * qx) - v * qy
    f = torch.fft.rfft(torch.stack([adv_z, adv_q]), dim=1).transpose(1, 2)
    return f.real.contiguous(), f.imag.contiguous()


def kb_adv_tracer(zx, zy, qx, qy, wr, wi, src, beta: float = 0.0):
    """y-major (ny, nx) gradients zx, zy, qx, qy (+ forcing src, or None)
    and the stacked (6, hny, nx) x-stages, whose fields 2 and 3 are the u
    and v x-stages -> stacked (2, nx, hny) forward y-stage planes of
    -u zx - v (zy + beta) [+ src] and -u qx - v qy. kb_pair of fields 2,
    3 and ky_adv of each product (a zero src for q) in one kernel, with
    their bits. Counterpart of pallas_tracer.kb_adv_tracer
    (_kb_adv_tracer_kernel)."""
    ny, nx = zx.shape
    hny = ny // 2 + 1
    fields = (zx, zy, qx, qy) + (() if src is None else (src,))
    _check("kb_adv_tracer", (ny, nx), *fields)
    _check("kb_adv_tracer", (6, hny, nx), wr, wi)
    if wr.device != zx.device:
        raise ValueError("kb_adv_tracer: x-stages and fields on different "
                         "devices")
    if _takes_plain("kb_adv_tracer", zx, ny):
        return kb_adv_tracer_plain(zx, zy, qx, qy, wr, wi, src, beta)
    from ._build import lib
    outr = torch.empty((2, nx, hny), dtype=torch.float32, device=zx.device)
    outi = torch.empty_like(outr)
    _launch("kb_adv_tracer", lib().xfb_kb_adv_tracer,
            *_ptrs(zx, zy, qx, qy, wr, wi),
            None if src is None else src.data_ptr(),
            *_ptrs(_twiddles(ny, zx.device), outr, outi), ny, nx,
            1.0 / (nx * ny), float(beta), *_xtile_args(ny, nx, 4),
            zx.device.index, _stream(zx))
    return outr, outi


# ------------------------------------------------------- stage composites

def forward_tail_tracer(fr, fi, lap2, mask, sr2, si2, axpy=None):
    """Stacked forward y-stage planes (2, nx, hny) -> dealiased diffusive
    tendencies (rr, ri), and with axpy=(z0r, z0i, coef) the next stage
    state too: kx_visc on two fields with nu = 1 (folded into lap2).
    Counterpart of pallas_tracer.forward_tail_tracer."""
    return kx_visc(fr, fi, lap2, mask, sr2, si2, 1.0, axpy)


def tendency_tracer_planes(sr2, si2, src, kx, ky, rlap, lap2, mask,
                           axpy=None, beta: float = 0.0):
    """One RK-stage tendency of the joint (zeta, q) system on stacked
    planes: ka6 -> kb_pair (0, 1) and (4, 5) -> kb_adv_tracer ->
    kx_visc. `src` is the forcing y-major (ny, nx), or None. Counterpart
    of pallas_tracer.tendency_tracer_planes."""
    nx = sr2.shape[1]
    ny = 2 * (sr2.shape[2] - 1)
    scale = 1.0 / (nx * ny)
    wr, wi = tracer_xstage_planes(sr2, si2, kx, ky, rlap)
    zx, zy = kb_pair(wr, wi, 0, 1, scale)
    qx, qy = kb_pair(wr, wi, 4, 5, scale)
    fr, fi = kb_adv_tracer(zx, zy, qx, qy, wr, wi, src, beta)
    return forward_tail_tracer(fr, fi, lap2, mask, sr2, si2, axpy)


def rk4_step_tracer_planes(t, sr2, si2, src, dt: float, lap2,
                           beta: float = 0.0):
    """RK4 on the stacked tracer state planes: stages 1-3 with the stage
    axpy fused into kx_visc, stage 4 without, then rk4_combine over the
    two stacked planes. Counterpart of
    pallas_tracer.rk4_step_tracer_planes."""
    h = dt * 0.5

    def d(ar, ai, axpy=None):
        return tendency_tracer_planes(ar, ai, src, t.kx, t.ky, t.rlap, lap2,
                                      t.mask, axpy=axpy, beta=beta)

    r1r, r1i, s2r, s2i = d(sr2, si2, axpy=(sr2, si2, h))
    r2r, r2i, s3r, s3i = d(s2r, s2i, axpy=(sr2, si2, h))
    r3r, r3i, s4r, s4i = d(s3r, s3i, axpy=(sr2, si2, dt))
    r4r, r4i = d(s4r, s4i)
    return plane_rk4_combine((sr2, si2), (r1r, r1i), (r2r, r2i),
                             (r3r, r3i), (r4r, r4i), dt / 6.0)
