"""The fast column tile in torch: the plain version of the transforms
that csrc/xtile.cuh runs with FAST = true (the barotropic fast mode, the
JAX package's --fast-transforms).

`fast_dft` computes, for every column, the length-n DFT that the fast
tile computes, with the same rounding points:

  * the K-block split of ops/xtile.py's plan (row r + K j to block r);
  * the sub-DFT as `fast_radices`: each radix-16 pass twiddles its inputs
    by W_(16p)^(t k) in float32 (the tile's `mul`: fmaf of a product,
    here rounded once through float64), rounds each input and the DFT-16
    matrix to bf16 (round to nearest even; the matrix from float64 with
    the zeros exact, ops/xtile.py DFT16_COS_BF16) and forms each output
    as the kernel's two mma.sync products do (dot16): each product's 16
    exact terms and its float32 accumulator aligned to the largest
    term's leading bit and cut toward zero 25 bits below it, summed, the
    sum cut toward zero to float32 (the sum the H100's tensor cores form
    for 99.93-99.98 % of the outputs, bit for bit, and within 1e-9 rel-L2
    for the rest: scripts/fast_sum_order.py; where every sum is exact,
    as for small integers, the two agree bit for bit);
  * the float32 radix-8/4/2 pass of the rest and the cross-block K-point
    step (twiddle by W_n^(r k2), then the K-point DFT), op for op as the
    kernel's dft<R>, rot4 and rot8.

The data moves as float32 (re, im) pairs. Nothing here launches a
kernel: ops/fused_fft.py's fast wrappers take these functions for CPU
tensors, and chip_smoke.py holds the kernels against them on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .fused_fft import _twiddles
from .xtile import bf16_bits, dft16_cos, fast_radices, xtile_plan

# 1/sqrt(2) in float32, as the kernel's rot8 holds it
_H = np.float32(0.70710678118654752)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 tensors rounded once (__fmaf_rn): the product
    is exact in float64; the sum is rounded to odd there (its exact error
    from TwoSum), and that rounds to float32 correctly (53 >= 24 + 2)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(fix, bits + step, bits).view(torch.float64).float()


def mul(a, b):
    """The tile's complex product (csrc/xtile.cuh mul) of (re, im) pairs."""
    return (fma(a[0], b[0], -(a[1] * b[1])), fma(a[0], b[1], a[1] * b[0]))


def _add(a, b):
    return a[0] + b[0], a[1] + b[1]


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _rot4(a, sign: int):
    return (a[1], -a[0]) if sign < 0 else (-a[1], a[0])


def _rot8(a, sign: int):
    h = torch.tensor(_H, device=a[0].device)
    if sign < 0:
        return h * (a[0] + a[1]), h * (a[1] - a[0])
    return h * (a[0] - a[1]), h * (a[0] + a[1])


def dft(v: list, sign: int) -> list:
    """The kernel's in-place length-R DFT (R = len(v) in 1, 2, 4, 8) of
    (re, im) pairs, op for op (csrc/xtile.cuh dft<R, SIGN>)."""
    r = len(v)
    if r == 1:
        return list(v)
    if r == 2:
        return [_add(v[0], v[1]), _sub(v[0], v[1])]
    if r == 4:
        t0, t1 = _add(v[0], v[2]), _sub(v[0], v[2])
        t2, t3 = _add(v[1], v[3]), _rot4(_sub(v[1], v[3]), sign)
        return [_add(t0, t2), _add(t1, t3), _sub(t0, t2), _sub(t1, t3)]
    if r == 8:
        e = dft(v[0::2], sign)
        o = dft(v[1::2], sign)
        o[1] = _rot8(o[1], sign)
        o[2] = _rot4(o[2], sign)
        o[3] = _rot8(_rot4(o[3], sign), sign)
        return ([_add(e[k], o[k]) for k in range(4)]
                + [_sub(e[k], o[k]) for k in range(4)])
    raise ValueError(f"dft: no float32 pass of radix {r}")


def _bf16_value(bits: int) -> float:
    return float(np.array(bits << 16, dtype=np.uint32).view(np.float32))


def dft16_matrices(device):
    """(C, S): cos and sin of 2 pi f t / 16 rounded once to bf16 (the
    kernel's A fragments), as float64 (16, 16) tensors."""
    f = np.arange(16)
    ft = np.outer(f, f)
    cos = np.vectorize(lambda x: _bf16_value(bf16_bits(dft16_cos(x))))
    c = torch.from_numpy(cos(ft).astype(np.float64)).to(device)
    s = torch.from_numpy(cos(ft - 4).astype(np.float64)).to(device)
    return c, s


# the tensor core's alignment of an mma's terms: bits kept below the
# largest term's leading bit (scripts/fast_sum_order.py)
MMA_ALIGN_BITS = 25


def _to_f32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _mma(acc: torch.Tensor, m: torch.Tensor, v: torch.Tensor):
    """One m16n8k16 product's float32 result acc + m v (acc (16, N)
    float32, m (16, 16) and v (16, N) of bf16 values in float32, every
    product exact there): each term (the accumulator and the 16
    products) cut toward zero to a multiple of 2^(e - MMA_ALIGN_BITS), e
    the largest term's exponent, their exact sum (float64: the cut terms
    are integers times that power of two, below 2^31 in sum) cut toward
    zero to float32."""
    p = m.t().unsqueeze(-1) * v.unsqueeze(1)        # p[t, f] = m[f, t] v[t]
    mag = torch.maximum(torch.maximum(p.amax(0), -p.amin(0)), acc.abs())
    _, e = torch.frexp(mag)                 # mag = frac 2^e, 0.5 <= frac < 1
    # 2^(bits - floor(log2 mag)), capped below float32's overflow (a
    # term under 2^-100 is cut at 2^-126, still exactly)
    scale = torch.ldexp(torch.ones_like(mag),
                        (MMA_ALIGN_BITS + 1 - e).clamp(max=126))
    p.mul_(scale).trunc_()
    cut = p.sum(0, dtype=torch.float64) + torch.trunc(acc * scale).double()
    return _to_f32_toward_zero(cut / scale.double())


def dot16(a, x, b, y) -> torch.Tensor:
    """sum_t a[f, t] x[t] + b[f, t] y[t] for (16, 16) matrices and (16, N)
    operands of bf16 values held in float64, as the kernel's two
    m16n8k16 products form it: the 16 exact products a x into a zero
    accumulator, then b y into that float32 result, each as _mma forms
    it: (16, N) float32."""
    acc = torch.zeros((16,) + tuple(x.shape[1:]), dtype=torch.float64,
                      device=x.device)
    return _mma(_mma(acc, a, x), b, y).float()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).double()


def _table(tw: torch.Tensor, idx: torch.Tensor, n: int, sign: int):
    """W_n^idx of the sign from the float32 half table (the kernel's
    twiddle<SIGN>): negation and the conjugate are exact."""
    half = n // 2
    w = tw[idx & (half - 1)]
    flip = (idx >= half).unsqueeze(-1)
    w = torch.where(flip, -w, w)
    wr, wi = w[..., 0], w[..., 1]
    return wr, (wi if sign < 0 else -wi)


def _pass(s, m: int, r: int, p: int, sw, sign: int, mats):
    """One self-sorting radix-r pass over the (m, B) pair s: butterfly i
    reads rows i + t m/r, twiddles input t by sw[t k m/(p r)] (k = i mod
    p, the conjugate for sign +1) and writes rows (i - k) r + k + t p."""
    sr, si = (x.view(r, m // r, -1) for x in s)
    v = [(sr[t], si[t]) for t in range(r)]
    if p > 1:
        i = torch.arange(m // r, device=sr.device)
        k = i & (p - 1)
        for t in range(1, r):
            x = t * k * (m // (p * r))
            wi = sw[1][x] if sign < 0 else -sw[1][x]
            v[t] = mul(v[t], (sw[0][x].unsqueeze(-1), wi.unsqueeze(-1)))
    if r == 16:
        c, sn = mats
        mwi = sn if sign < 0 else -sn      # Yr = C xr - Wi xi, Wi = -sign S
        vr = _bf16(torch.stack([x[0] for x in v]))
        vi = _bf16(torch.stack([x[1] for x in v]))
        shape = vr.shape
        vr, vi = vr.reshape(16, -1), vi.reshape(16, -1)
        yr, yi = dot16(c, vr, mwi, vi), dot16(-mwi, vr, c, vi)
        y = [(yr[f].view(shape[1:]), yi[f].view(shape[1:]))
             for f in range(16)]
    else:
        y = dft(v, sign)
    out = []
    for part in (0, 1):
        z = torch.stack([y[t][part] for t in range(r)])   # (r, m/r, B)
        z = z.view(r, m // (r * p), p, -1).permute(1, 0, 2, 3)
        out.append(z.reshape(m, -1))
    return tuple(out)


def fast_dft(xr: torch.Tensor, xi: torch.Tensor, sign: int,
             dim: int = 0):
    """The fast tile's unnormalized DFT (exp(sign 2 pi i jk/n)) along
    `dim` of the float32 pair xr + i xi; returns the (re, im) pair in the
    same layout."""
    n = xr.shape[dim]
    plan = xtile_plan(n, 1, 4)
    kk, m = plan.k, plan.m
    xr, xi = (x.movedim(dim, 0) for x in (xr, xi))
    rest = xr.shape[1:]
    cols = xr.reshape(n, -1).shape[1]
    dev = xr.device
    tw = _twiddles(n, dev)
    # block r's row j is x[r + K j]: (m, K, cols), as (m, K cols) columns
    s = (xr.reshape(m, kk * cols), xi.reshape(m, kk * cols))
    sw = _table(tw, torch.arange(m, device=dev) * kk, n, -1)
    mats = dft16_matrices(dev)
    p = 1
    for r in fast_radices(m):
        s = _pass(s, m, r, p, sw, sign, mats)
        p *= r
    # Y_r[k2] of every block; X[k2 + m k1] = DFT_K over r of
    # Y_r[k2] W_n^(r k2)
    y = [(s[0].view(m, kk, cols)[:, r], s[1].view(m, kk, cols)[:, r])
         for r in range(kk)]
    k2 = torch.arange(m, device=dev)
    for r in range(1, kk):
        wr, wi = _table(tw, r * k2, n, sign)
        y[r] = mul(y[r], (wr.unsqueeze(-1), wi.unsqueeze(-1)))
    z = dft(y, sign)
    out = [torch.stack([z[k1][part] for k1 in range(kk)]).reshape(n, *rest)
           for part in (0, 1)]
    return tuple(o.movedim(0, dim).contiguous() for o in out)
