"""Library FFT path on torch.fft: the counterpart of
xlab_fftbarotropic_tpu/ops/fft.py (the JAX "xla" backend).

Normalization contract (SURVEY.md §5.2): forward unnormalized, inverse
scaled by 1/(nx*ny), exactly torch.fft's rfft2/irfft2 defaults. Layout:
physical (nx, ny) x-major, half-spectrum (nx, ny//2+1) complex64.

Before every c2r transform the self-conjugate columns j = 0 and j = ny/2
are symmetrized explicitly (S[i, j] <- (S[i, j] + conj(S[-i, j]))/2, as
_hermitian_full does in the JAX package). The positive-Nyquist gradient
convention puts non-Hermitian content there; pocketfft's c2r projects it
out implicitly, and making the projection explicit gives the CPU and the
card (cuFFT) the same input by construction.
"""

from __future__ import annotations

import torch


def forward(field: torch.Tensor) -> torch.Tensor:
    """Real (nx, ny) float32 -> half-spectrum (nx, ny//2+1) complex64,
    unnormalized (fftwf_plan_dft_r2c_2d, main.cpp:126-127)."""
    return torch.fft.rfft2(field)


def _sym(col: torch.Tensor) -> torch.Tensor:
    """(col[i] + conj(col[-i mod n]))/2 along the first axis."""
    mirror = torch.conj(torch.roll(torch.flip(col, [0]), 1, 0))
    return 0.5 * (col + mirror)


def symmetrize(spec: torch.Tensor, ny: int) -> torch.Tensor:
    """A copy of the half-spectrum with columns 0 and ny/2 symmetrized."""
    s = spec.clone()
    s[:, 0] = _sym(spec[:, 0])
    s[:, ny // 2] = _sym(spec[:, ny // 2])
    return s


def inverse(spec: torch.Tensor, grid_shape=None) -> torch.Tensor:
    """Half-spectrum complex64 -> real float32, scaled by 1/(nx*ny)
    (c2r + fftwf_backward_normalize, main.cpp:37-41)."""
    if grid_shape is None:
        nx, hny = spec.shape[-2], spec.shape[-1]
        grid_shape = (nx, 2 * (hny - 1))
    return torch.fft.irfft2(symmetrize(spec, grid_shape[1]),
                            s=tuple(grid_shape))


def _hermitian_full(s: torch.Tensor, ny: int) -> torch.Tensor:
    """(nx, ny//2+1) half-spectrum of a real field -> full (nx, ny)
    spectrum by S[-i, -j] = conj(S[i, j]), self-conjugate columns
    symmetrized first (ops/fft.py:52-76 of the JAX package)."""
    s = symmetrize(s, ny)
    body = torch.conj(s[:, 1:ny // 2]).flip(1)     # columns ny/2-1 .. 1
    body = torch.cat([body[:1], body[1:].flip(0)], dim=0)   # row -i mod nx
    return torch.cat([s, body], dim=1)


def inverse_pair(spec_a: torch.Tensor, spec_b: torch.Tensor,
                 grid_shape) -> tuple:
    """Two real inverse transforms for the price of one complex ifft2:
    c = a + i b has spectrum A_full + i B_full. Same 1/(nx*ny) contract
    as `inverse`."""
    _, ny = grid_shape
    c = _hermitian_full(spec_a, ny) + 1j * _hermitian_full(spec_b, ny)
    z = torch.fft.ifft2(c)
    return z.real.contiguous(), z.imag.contiguous()


def forward_pair(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Two real forward transforms for the price of one complex fft2:
    with C = fft2(a + ib), the half-spectra are A = (C(k) + conj(C(-k)))/2
    and B = (C(k) - conj(C(-k)))/(2i) on the half axis. Unnormalized, as
    `forward` (ops/fft.py:96 of the JAX package, same index map)."""
    nx, ny = a.shape
    hny = ny // 2 + 1
    c = torch.fft.fft2(torch.complex(a, b))

    def negk(x):
        # row k -> row (nx - k) mod nx, col j -> col (ny - j) mod ny,
        # keeping the half axis
        x = torch.cat([x[:1], x[1:].flip(0)], dim=0)
        return torch.cat([x[:, :1], x[:, ny - hny + 1:].flip(1)], dim=1)

    c_neg = torch.complex(negk(c.real), -negk(c.imag))
    c = c[:, :hny]
    return 0.5 * (c + c_neg), -0.5j * (c - c_neg)
