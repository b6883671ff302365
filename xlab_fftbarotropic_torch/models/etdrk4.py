"""ETDRK4 exponential time integrator: the counterpart of
xlab_fftbarotropic_tpu/models/etdrk4.py, for every family.

The linear part of each family's tendency is a per-mode operator L that
the scheme integrates exactly, from tables of its matrix exponential and
phi-functions; only the advective CFL of the nonlinear terms is left
(utils/guards.py:check_etd_cfl). Cox & Mathews (2002) in the Kassam &
Trefethen (2005) coefficient form:

    an    = E2 u + Q N(u)
    bn    = E2 u + Q N(an)
    cn    = E2 an + Q (2 N(bn) - N(u))
    u_new = E u + F1 N(u) + F2 (N(an)+N(bn)) + F3 N(cn)

with E = exp(L dt), E2 = exp(L dt/2), Q = dt phi1(L dt/2),
F1 = dt (phi1 - 3 phi2 + 4 phi3), F2 = dt (2 phi2 - 4 phi3) and
F3 = dt (4 phi3 - phi2) at L dt. N is the dealiased nonlinear-only
tendency of the family (every linear coefficient zero).

* Shallow water: L is the real 3x3 block per mode acting on
  (zeta, div, eta),

      L(k) = [[ a , -f',   0    ],     a  = nu lap - r_drag - nu4 lap^2
              [ f',  a , -g lap ],     f' = f (0 at the mean mode)
              [ 0 , -H ,   0    ]]

  tables (3, 3, nx, hny) each. The plane path (etdrk4_step_planes) runs
  N through the SW plane stepper's kernels with f = g = nu = H = 0, and
  in its default fused form builds each stage z0 + s (Q @ N) inside the
  combine kernel (ops/fused_sw.py:sw_combine_mv); drag and
  hyperviscosity live in L, so they need no kernel.
* Barotropic: the scalar nu lap - r_drag - nu4 lap^2, with
  - i beta kx rlap (complex tables) under beta; tracer: that and
  kappa lap stacked (2, nx, hny). N runs the barotropic or tracer plane
  stepper's kernels with nu = 0 (etd_scheme, smul_planes).

Dealias contract: E and E2 are the identity outside the dealias mask and
Q, F1..F3 zero there, so modes above the cutoff stay frozen.

The tables are built with torch in float64 on the model's device, by the
JAX package's algorithm (a scaled Taylor series for (exp, phi1, phi2,
phi3) at L dt / 2^s with ||L dt|| / 2^s <= 1/4, then s applications of
the doubling identities), with the same row chunks deciding s, and
rounded to float32 (complex64 under beta) once. A disk cache keyed as in
the JAX package holds them: a stack written by either package loads in
the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import warnings
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..ops import fused_sw as fs
from ..ops import spectral as sp
# re-exported: the JAX package defines max_advective_dt in this module
from ..utils.guards import max_advective_dt  # noqa: F401


class EtdTables(NamedTuple):
    """The six per-mode tables on the model's device, views of one
    stack: SW (3, 3, nx, hny) float32 each; scalar (nx, hny) barotropic
    or (2, nx, hny) stacked (flow, tracer), float32 or complex64 when
    beta != 0. Q and F1..F3 carry the dt factor."""
    E: torch.Tensor
    E2: torch.Tensor
    Q: torch.Tensor
    F1: torch.Tensor
    F2: torch.Tensor
    F3: torch.Tensor


_TABLE_NAMES = EtdTables._fields
# row chunks whose largest norm decides the scaling exponent s: those of
# the JAX package, so that the tables come out the same
SW_ROW_CHUNK, SCALAR_ROW_CHUNK = 256, 1024


def _lap_mask(cfg, hpad: int, device):
    """(lap, mask) float64 (nx, hny[pad]) from the float32 wavenumbers, as
    the JAX package's _host_lap_mask (never from the rounded float32 lap
    table); hpad > hny pads columns with lap = 0, mask = 0."""
    kx = torch.from_numpy(sp.wavenumbers_x(cfg.nx, cfg.lx)).to(
        device, torch.float64)
    ky = torch.from_numpy(sp.wavenumbers_y(cfg.ny, cfg.ly)).to(
        device, torch.float64)
    lap = -(kx[:, None] ** 2 + ky[None, :] ** 2)
    mask = torch.from_numpy(sp.dealias_mask(cfg.nx, cfg.ny,
                                            cfg.dealias_rule)).to(
        device, torch.float64)
    hny = lap.shape[1]
    if hpad and hpad > hny:
        lap = torch.nn.functional.pad(lap, (0, hpad - hny))
        mask = torch.nn.functional.pad(mask, (0, hpad - hny))
    return lap, mask


def _scaling(norm: float) -> int:
    """The s of ||A|| / 2^s <= 1/4, computed as the JAX package does."""
    return max(0, int(np.ceil(np.log2(max(norm, 1e-300) / 0.25))))


# --------------------------------------------------------- shallow water

def sw_linear_matrix(cfg, hpad: int = 0, device="cpu") -> torch.Tensor:
    """The per-mode operator L as (nx, hny[pad], 3, 3) float64, matching
    the split-linear terms of models/shallow_water.py:tendency (f masked
    at the mean mode)."""
    lap, _ = _lap_mask(cfg, hpad, device)
    fz = float(cfg.f) * (lap != 0.0).to(torch.float64)
    a = (float(cfg.nu) * lap - float(cfg.r_drag)
         - float(cfg.nu4) * lap * lap)
    g = float(cfg.gravity)
    H = float(cfg.mean_depth)
    L = torch.zeros(lap.shape + (3, 3), dtype=torch.float64, device=device)
    L[..., 0, 0] = a
    L[..., 0, 1] = -fz
    L[..., 1, 0] = fz
    L[..., 1, 1] = a
    L[..., 1, 2] = -g * lap
    L[..., 2, 1] = -H
    return L


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 products (..., 3, 3) as broadcast products and a sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _phi_series(T: torch.Tensor, mm, one: torch.Tensor, terms: int = 24):
    """(E, phi1, phi2, phi3) of small-norm T by Taylor series:
    phi_j = sum_{k>=0} T^k / (k+j)!, with `mm` the product and `one` the
    identity (3x3 matrices: _mm and eye; scalars: * and ones)."""
    acc = [one.clone(), one / 1.0, one / 2.0, one / 6.0]
    P = one.clone()
    kfact = 1.0
    for k in range(1, terms + 1):
        P = mm(P, T)
        kfact *= k
        d0 = kfact
        d1 = d0 * (k + 1)
        d2 = d1 * (k + 2)
        d3 = d2 * (k + 3)
        acc[0] = acc[0] + P / d0
        acc[1] = acc[1] + P / d1
        acc[2] = acc[2] + P / d2
        acc[3] = acc[3] + P / d3
    return acc


def _phi_functions(A: torch.Tensor, matrix: bool):
    """(exp(A), phi1(A), phi2(A), phi3(A)) of batched 3x3 matrices
    (..., 3, 3) (matrix) or of scalars, float64 or complex128, by scaling
    (the batch's largest row-sum norm, or modulus, decides s) and the
    doubling identities (robust at A = 0, where the closed forms
    (e^z - 1)/z ... cancel)."""
    if matrix:
        mm = _mm
        norm = A.abs().sum(-1).max() if A.numel() else 0.0
        one = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    else:
        mm = torch.mul
        norm = A.abs().max() if A.numel() else 0.0
        one = torch.ones_like(A)
    s = _scaling(float(norm))
    E, p1, p2, p3 = _phi_series(A / (2.0 ** s), mm, one)
    for _ in range(s):
        p3 = (mm(p2, p1 + one) + 2.0 * p3) / 8.0
        p2 = (mm(p1, p1) + 2.0 * p2) / 4.0
        p1 = mm(E + one, p1) / 2.0
        E = mm(E, E)
    return E, p1, p2, p3


def build_tables_stack(cfg, dt: float, device="cpu",
                       hpad: int = 0) -> torch.Tensor:
    """The six SW tables as one float32 stack (6, 3, 3, nx, hny[pad]) in
    (E, E2, Q, F1, F2, F3) order on `device`: the JAX package's
    _build_tables_host in torch float64 there."""
    L = sw_linear_matrix(cfg, hpad, device)
    mask = _lap_mask(cfg, hpad, device)[1][..., None, None]
    nx, ncol = L.shape[:2]
    eye = torch.eye(3, dtype=torch.float64, device=device)
    out = torch.empty((6, 3, 3, nx, ncol), dtype=torch.float32,
                      device=device)
    for i0 in range(0, nx, SW_ROW_CHUNK):
        rows = slice(i0, min(i0 + SW_ROW_CHUNK, nx))
        A = L[rows] * dt
        m = mask[rows]
        E, p1, p2, p3 = _phi_functions(A, matrix=True)
        E2, q1, _, _ = _phi_functions(A * 0.5, matrix=True)
        tabs = (m * E + (1.0 - m) * eye, m * E2 + (1.0 - m) * eye,
                m * dt * 0.5 * q1, m * dt * (p1 - 3.0 * p2 + 4.0 * p3),
                m * dt * (2.0 * p2 - 4.0 * p3), m * dt * (4.0 * p3 - p2))
        for i, t in enumerate(tabs):
            # (rows, hny, 3, 3) -> (3, 3, rows, hny): every matrix entry
            # a contiguous plane
            out[i, :, :, rows] = t.permute(2, 3, 0, 1).to(torch.float32)
    return out


# ------------------------------------------------------------ disk cache
#
# The tables are a pure function of the linear operator's config fields,
# dt and hpad; keyed by an explicit field hash (not cfg.config_hash(),
# which also covers total_steps, time_scheme and the like) and saved as
# one raw .npy stack. XFB_ETD_CACHE: unset -> <output_dir>/etd_cache; a
# path -> that directory; '0' or '' -> no cache. Key, names and format
# are the JAX package's.

_SW_L_FIELDS = ("nx", "ny", "lx", "ly", "f", "nu", "r_drag", "nu4",
                "gravity", "mean_depth", "dealias_rule")
_BT_L_FIELDS = ("nx", "ny", "lx", "ly", "nu", "r_drag", "nu4", "beta",
                "dealias_rule")


def tables_cache_key(cfg, dt: float, hpad: int = 0, kind: str = "sw",
                     kappa: float = 0.0) -> str:
    fields = _SW_L_FIELDS if kind == "sw" else _BT_L_FIELDS
    d = {k: getattr(cfg, k) for k in fields}
    d.update(dt=float(dt), hpad=int(hpad), kind=kind, version=1)
    if kind == "tracer":
        d["kappa"] = float(kappa)
    return hashlib.sha256(
        json.dumps(d, sort_keys=True).encode()).hexdigest()[:16]


def _cache_dir(cfg):
    env = os.environ.get("XFB_ETD_CACHE")
    if env is not None:
        return None if env in ("", "0") else Path(env)
    return Path(cfg.output_dir) / "etd_cache"


def _cached_stack(cfg, path_stem: str, build, device) -> torch.Tensor:
    """The table stack on `device`: loaded from the cache file, or built
    there and saved (a failed save warns: the tables are in hand)."""
    d = _cache_dir(cfg)
    if d is None:
        return build()
    path = d / f"{path_stem}.npy"
    if path.exists():
        return torch.from_numpy(np.load(path)).to(device)
    stack = build()
    try:
        d.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npy")
        os.close(fd)
        np.save(tmp, stack.cpu().numpy())
        os.replace(tmp, path)
    except OSError as e:           # disk full, read-only cache directory
        warnings.warn(f"ETD table cache save failed ({e}); continuing "
                      "with the freshly built tables", stacklevel=2)
    return stack


def build_tables_cached(cfg, dt: float, device="cpu",
                        hpad: int = 0) -> EtdTables:
    """build_tables_stack through the disk cache."""
    key = tables_cache_key(cfg, dt, hpad, kind="sw")
    return EtdTables(*_cached_stack(
        cfg, f"sw_etd_{key}",
        lambda: build_tables_stack(cfg, dt, device, hpad), device))


# ----------------------------------------------------------- SW stepping

def _matvec(T, s):
    """The per-mode real 3x3 table applied to a complex SW state."""
    z, d, e = s
    return type(s)(T[0, 0] * z + T[0, 1] * d + T[0, 2] * e,
                   T[1, 0] * z + T[1, 1] * d + T[1, 2] * e,
                   T[2, 0] * z + T[2, 1] * d + T[2, 2] * e)


def _add(a, b):
    return type(a)(*(x + y for x, y in zip(a, b)))


def etdrk4_step(t, tabs: EtdTables, s, src, grid_shape,
                fwd_pair: bool = False):
    """One SW ETDRK4 step on the library path (torch.fft): N is
    models/shallow_water.py:tendency with every linear coefficient zero
    and split=True, dealiased."""
    from . import shallow_water as swm

    def N(state):
        return swm._dealias_state(t, swm.tendency(
            t, state, src, 0.0, 0.0, 0.0, 0.0, grid_shape,
            fwd_pair=fwd_pair, split=True))

    n1 = N(s)
    e2u = _matvec(tabs.E2, s)
    an = _add(e2u, _matvec(tabs.Q, n1))
    n2 = N(an)
    bn = _add(e2u, _matvec(tabs.Q, n2))
    n3 = N(bn)
    cn = _add(_matvec(tabs.E2, an),
              _matvec(tabs.Q, type(s)(*(2.0 * x - y
                                        for x, y in zip(n3, n1)))))
    n4 = N(cn)
    out = _add(_matvec(tabs.E, s), _matvec(tabs.F1, n1))
    out = _add(out, _matvec(tabs.F2, _add(n2, n3)))
    return _add(out, _matvec(tabs.F3, n4))


def _matvec_planes(T, p):
    """The per-mode 3x3 table applied to the six state planes (zr, zi,
    dr, di, er, ei): the real matvec on the re and im planes apart, as
    elementwise products (no library call)."""
    zr, zi, dr, di, er, ei = p
    return (T[0, 0] * zr + T[0, 1] * dr + T[0, 2] * er,
            T[0, 0] * zi + T[0, 1] * di + T[0, 2] * ei,
            T[1, 0] * zr + T[1, 1] * dr + T[1, 2] * er,
            T[1, 0] * zi + T[1, 1] * di + T[1, 2] * ei,
            T[2, 0] * zr + T[2, 1] * dr + T[2, 2] * er,
            T[2, 0] * zi + T[2, 1] * di + T[2, 2] * ei)


def _addp(a, b):
    return tuple(x + y for x, y in zip(a, b))


def etdrk4_step_planes(t, tabs: EtdTables, p, src_planes,
                       eta_scale: float, fuse: bool = True,
                       yfirst: bool = True):
    """One SW ETDRK4 step on the six float32 state planes through the SW
    plane stepper's kernels (ops/fused_sw.py): N is inverse_quad_planes +
    forward_tendencies with f = g = nu = H = 0, the pairing equalizer
    eta_scale fixed (once per segment), in the y-first order or, yfirst
    False, the x-first one.

    fuse=True (the JAX default, XFB_SW_ETD_FUSE=1) builds each stage
    z0 + s (Q @ N) in the combine kernel (sw_combine_mv): the an, bn and
    cn stages and, with no tendency written, the final one. The cn stage
    takes Q n1 as an - e2u, so cn = (E2 an - an + e2u) + 2 Q n3 rides one
    combine too. fuse=False: plain combines and elementwise matvecs."""
    def N(q, mv=None):
        u, v, zeta, eta_s = fs.inverse_quad_planes(*q, t.kx, t.ky, t.rlap,
                                                   eta_scale, yfirst)
        return fs.forward_tendencies(u, v, zeta, eta_s, q, src_planes,
                                     t.kx, t.ky, t.lap, t.mask, 0.0, 0.0,
                                     0.0, 0.0, eta_scale, mv_axpy=mv,
                                     yfirst=yfirst)

    if fuse:
        e2u = _matvec_planes(tabs.E2, p)
        n1, an = N(p, mv=(e2u, tabs.Q, 1.0, True))
        n2, bn = N(an, mv=(e2u, tabs.Q, 1.0, True))
        z0c = tuple(x - y + z for x, y, z in
                    zip(_matvec_planes(tabs.E2, an), an, e2u))
        n3, cn = N(bn, mv=(z0c, tabs.Q, 2.0, True))
        base = _addp(_matvec_planes(tabs.E, p), _matvec_planes(tabs.F1, n1))
        base = _addp(base, _matvec_planes(tabs.F2, _addp(n2, n3)))
        _, out = N(cn, mv=(base, tabs.F3, 1.0, False))
        return out

    n1 = N(p)
    e2u = _matvec_planes(tabs.E2, p)
    an = _addp(e2u, _matvec_planes(tabs.Q, n1))
    n2 = N(an)
    bn = _addp(e2u, _matvec_planes(tabs.Q, n2))
    n3 = N(bn)
    cn = _addp(_matvec_planes(tabs.E2, an),
               _matvec_planes(tabs.Q, tuple(2.0 * x - y
                                            for x, y in zip(n3, n1))))
    n4 = N(cn)
    out = _addp(_matvec_planes(tabs.E, p), _matvec_planes(tabs.F1, n1))
    out = _addp(out, _matvec_planes(tabs.F2, _addp(n2, n3)))
    return _addp(out, _matvec_planes(tabs.F3, n4))


# ------------------------------------------------------- scalar families

def scalar_linear_operator(cfg, kind: str = "barotropic",
                           kappa: float = 0.0, hpad: int = 0,
                           device="cpu") -> torch.Tensor:
    """The per-mode operator, float64 or complex128: (nx, hny) for
    'barotropic', (2, nx, hny) stacked (flow, q) for 'tracer'; under beta
    the flow gains -i beta kx rlap (the linearized -beta v)."""
    lap, _ = _lap_mask(cfg, hpad, device)
    a = (float(cfg.nu) * lap - float(cfg.r_drag)
         - float(cfg.nu4) * lap * lap)
    beta = float(cfg.beta)
    if beta != 0.0:
        kx = torch.from_numpy(sp.wavenumbers_x(cfg.nx, cfg.lx)).to(
            device, torch.float64)
        # multiply-form inversion, rlap(0, 0) = 1 (kx = 0 there)
        nz = lap != 0.0
        rlap = torch.where(nz, 1.0 / torch.where(nz, lap, 1.0), 1.0)
        a = torch.complex(a, -((beta * kx[:, None]) * rlap))
    if kind == "barotropic":
        return a
    if kind == "tracer":
        return torch.stack([a, (float(kappa) * lap).to(a.dtype)])
    raise ValueError(f"unknown scalar ETD kind {kind!r}")


def build_scalar_tables_stack(cfg, dt: float, kind: str = "barotropic",
                              kappa: float = 0.0, device="cpu",
                              hpad: int = 0) -> torch.Tensor:
    """One stack (6, [2,] nx, hny[pad]) in (E, E2, Q, F1, F2, F3) order,
    float32 or complex64 (beta != 0): the JAX package's
    _build_scalar_tables_host in torch float64 on `device`."""
    L = scalar_linear_operator(cfg, kind, kappa, hpad, device)
    mask = _lap_mask(cfg, hpad, device)[1]
    out_dtype = torch.complex64 if L.is_complex() else torch.float32
    out = torch.empty((6,) + tuple(L.shape), dtype=out_dtype, device=device)
    nx = L.shape[-2]
    for i0 in range(0, nx, SCALAR_ROW_CHUNK):
        rows = slice(i0, min(i0 + SCALAR_ROW_CHUNK, nx))
        A = L[..., rows, :] * dt
        m = mask[rows]
        E, p1, p2, p3 = _phi_functions(A, matrix=False)
        E2, q1, _, _ = _phi_functions(A * 0.5, matrix=False)
        tabs = (m * E + (1.0 - m), m * E2 + (1.0 - m), m * dt * 0.5 * q1,
                m * dt * (p1 - 3.0 * p2 + 4.0 * p3),
                m * dt * (2.0 * p2 - 4.0 * p3), m * dt * (4.0 * p3 - p2))
        for i, t in enumerate(tabs):
            out[i][..., rows, :] = t.to(out_dtype)
    return out


def build_scalar_tables(cfg, dt: float, kind: str = "barotropic",
                        kappa: float = 0.0, device="cpu",
                        hpad: int = 0) -> EtdTables:
    """Scalar-family tables, through the same disk cache as the SW ones."""
    key = tables_cache_key(cfg, dt, hpad, kind=kind, kappa=kappa)
    return EtdTables(*_cached_stack(
        cfg, f"{kind}_etd_{key}",
        lambda: build_scalar_tables_stack(cfg, dt, kind, kappa, device, hpad),
        device))


def _tree_map(fn, *xs):
    """fn over the leaves of tuples (NamedTuples keep their type)."""
    x0 = xs[0]
    if isinstance(x0, tuple):
        items = [_tree_map(fn, *parts) for parts in zip(*xs)]
        return type(x0)(*items) if hasattr(x0, "_fields") else tuple(items)
    return fn(*xs)


def etd_scheme(N, mul, tabs, u):
    """The ETDRK4 update (module docstring) over any state of tensors or
    tuples of them: N maps a state to its dealiased nonlinear tendency,
    mul applies one table to a state. The scalar families' step."""
    def add(a, b):
        return _tree_map(lambda x, y: x + y, a, b)

    n1 = N(u)
    e2u = mul(tabs.E2, u)
    an = add(e2u, mul(tabs.Q, n1))
    n2 = N(an)
    bn = add(e2u, mul(tabs.Q, n2))
    n3 = N(bn)
    cn = add(mul(tabs.E2, an),
             mul(tabs.Q, _tree_map(lambda x, y: 2.0 * x - y, n3, n1)))
    n4 = N(cn)
    out = add(mul(tabs.E, u), mul(tabs.F1, n1))
    out = add(out, mul(tabs.F2, add(n2, n3)))
    return add(out, mul(tabs.F3, n4))


def smul_planes(T, pr, pi):
    """A per-mode scalar table applied to (re, im) float32 planes: a
    complex table rotates, (tr pr - ti pi, tr pi + ti pr); a real one
    scales both planes."""
    if T.is_complex():
        tr, ti = T.real, T.imag
        return tr * pr - ti * pi, tr * pi + ti * pr
    return T * pr, T * pi

