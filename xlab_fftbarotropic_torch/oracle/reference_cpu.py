"""CPU oracle: a float32 numpy transcription of the reference pipeline,
the counterpart of xlab_fftbarotropic_tpu/oracle/reference_cpu.py.

It follows the reference C++ code's control flow (src/main.cpp)
statement for statement in numpy float32 (numpy's pocketfft does
single-precision r2c/c2r natively, the same DFT FFTW3f computes), and
each statement as the JAX package's oracle writes it, on the same numpy
tables (ops/spectral.py: wavenumbers_x, wavenumbers_y, dealias_mask), so
its outputs are that oracle's bit for bit. It needs no jax and no card:
it is the reference-parity golden of the port on the H100's machine
(`chip_smoke.py`, rel-L2 < 1e-6 after 20 RK4 steps) and of its tests.

This is test infrastructure, deliberately slow and explicit; the
production path is models/barotropic.py.

Contract points (file:line into the reference code):
  * RHS: main.cpp:146-244: laplacian first, grads of zeta, psi inversion,
    u = -psi_y, v = +psi_x, pointwise tendency, forward FFT, spectral
    viscosity.
  * RK4: main.cpp:286-317: dealias each stage tendency, classic weights.
  * Normalization: main.cpp:37-41: inverse scaled by 1/(nx*ny).
  * vort_src: never written by main.out; zero-initialized here.
"""

from __future__ import annotations

import numpy as np

from ..ops import spectral as sp


class OracleTables:
    """float32 coefficient tables, numpy only (fftwfop.cpp:5-79)."""

    def __init__(self, nx, ny, lx, ly, rule="circular"):
        self.kx = sp.wavenumbers_x(nx, lx)                 # (nx,)
        self.ky = sp.wavenumbers_y(ny, ly)                 # (hny,)
        lap = -(self.kx[:, None].astype(np.float64) ** 2
                + self.ky[None, :].astype(np.float64) ** 2)
        self.lap = lap.astype(np.float32)
        self.inv_lap = self.lap.copy()
        self.inv_lap[0, 0] = np.float32(1.0)               # fftwfop.cpp:43
        self.mask = sp.dealias_mask(nx, ny, rule)

    def gradx(self, a):
        return a * (1j * self.kx.astype(np.complex64))[:, None]

    def grady(self, a):
        return a * (1j * self.ky.astype(np.complex64))[None, :]

    def laplacian(self, a):
        return a * self.lap

    def invert_laplacian(self, a):
        return a / self.inv_lap

    def dealias(self, a):
        return a * self.mask


def _irfft2(spec, shape):
    """c2r + fftwf_backward_normalize (main.cpp:37-41); float32 out."""
    return np.fft.irfft2(spec, s=shape).astype(np.float32)


class OracleBarotropic:
    """Statement-level transcription of main.cpp's time loop."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.t = OracleTables(cfg.nx, cfg.ny, cfg.lx, cfg.ly,
                              cfg.dealias_rule)
        self.vort_src = np.zeros(cfg.grid_shape, dtype=np.float32)

    def rhs(self, vort_c):
        """getDvortdt (main.cpp:146-244). Returns the un-dealiased
        tendency and the physical diagnostics (psi, u, v) of this
        evaluation."""
        cfg, t = self.cfg, self.t
        shape = cfg.grid_shape
        lvort_c = t.laplacian(vort_c)                       # main.cpp:148
        dvortdx = _irfft2(t.gradx(vort_c), shape)           # main.cpp:151-154
        dvortdy = _irfft2(t.grady(vort_c), shape)           # main.cpp:165-168
        psi_c = t.invert_laplacian(vort_c)                  # main.cpp:179
        u = -_irfft2(t.grady(psi_c), shape)                 # main.cpp:198-201
        v = _irfft2(t.gradx(psi_c), shape)                  # main.cpp:212-214
        dvortdt = (-u * dvortdx - v * dvortdy
                   + self.vort_src).astype(np.float32)      # main.cpp:225-227
        dvortdt_c = np.fft.rfft2(dvortdt).astype(np.complex64)  # main.cpp:237
        dvortdt_c += lvort_c * np.float32(cfg.nu)           # main.cpp:240-243
        return dvortdt_c, psi_c, u, v

    def rk4_step(self, vort_c):
        """One RK4 step on the spectral state (main.cpp:286-317)."""
        cfg, t = self.cfg, self.t
        dt = np.float32(cfg.dt)
        vort_c0 = vort_c.copy()                             # main.cpp:286
        rk1 = t.dealias(self.rhs(vort_c)[0])
        vort_c = vort_c0 + rk1 * (dt / np.float32(2.0))
        rk2 = t.dealias(self.rhs(vort_c)[0])
        vort_c = vort_c0 + rk2 * (dt / np.float32(2.0))
        rk3 = t.dealias(self.rhs(vort_c)[0])
        vort_c = vort_c0 + rk3 * dt
        rk4 = t.dealias(self.rhs(vort_c)[0])
        return vort_c0 + (rk1 + np.float32(2.0) * rk2
                          + np.float32(2.0) * rk3 + rk4) * dt / np.float32(6.0)

    def run(self, vort0, n_steps, record=None):
        """Integrate n_steps from the physical vorticity vort0.

        `record(step, fields)` is called every cfg.record_step steps
        before the state update with the step-start fields, as the record
        block at main.cpp:266-282 and the first-stage psi/u/v dumps
        (main.cpp:181-222). Returns the final physical vorticity."""
        cfg = self.cfg
        vort_c = np.fft.rfft2(vort0.astype(np.float32)).astype(np.complex64)
        for step in range(n_steps):
            if record is not None and step % cfg.record_step == 0:
                vort = _irfft2(vort_c, cfg.grid_shape)
                _, psi_c, u, v = self.rhs(vort_c)
                psi = _irfft2(psi_c, cfg.grid_shape)
                record(step, dict(vort=vort, psi=psi, u=u, v=v,
                                  vort_src=self.vort_src.copy()))
            vort_c = self.rk4_step(vort_c).astype(np.complex64)
        return _irfft2(vort_c, cfg.grid_shape)


def oracle_invert_pressure(cfg, psi, ref_x=0, ref_y=0):
    """Transcription of invert_pres.cpp:132-187: solve the nonlinear
    balance equation lap(p) = rho (f lap(psi) + 2 (psi_xx psi_yy -
    psi_xy^2)), anchored by subtracting p at flat index ref_x + nx ref_y
    (the reference's own, IDX-inconsistent, indexing,
    invert_pres.cpp:182-185)."""
    t = OracleTables(cfg.nx, cfg.ny, cfg.lx, cfg.ly, cfg.dealias_rule)
    shape = cfg.grid_shape
    psi_c = np.fft.rfft2(psi.astype(np.float32)).astype(np.complex64)
    dpsidx2_c = t.gradx(t.gradx(psi_c))
    tmp_c = t.grady(psi_c)
    dpsidy2_c = t.grady(tmp_c)
    dpsidxdy_c = t.gradx(tmp_c)
    dpsidx2 = _irfft2(t.dealias(dpsidx2_c), shape)
    dpsidy2 = _irfft2(t.dealias(dpsidy2_c), shape)
    dpsidxdy = _irfft2(t.dealias(dpsidxdy_c), shape)
    gaus_curv = (dpsidx2 * dpsidy2 - dpsidxdy ** 2).astype(np.float32)
    lap_pres_c = np.fft.rfft2(gaus_curv).astype(np.complex64)
    lap_psi_c = t.laplacian(psi_c)
    lap_pres_c = np.float32(cfg.rho) * (np.float32(cfg.f) * lap_psi_c
                                        + np.float32(2.0) * lap_pres_c)
    pres = _irfft2(t.invert_laplacian(lap_pres_c), shape)
    ref_val = pres.ravel()[ref_x + cfg.nx * ref_y]
    return pres - ref_val
