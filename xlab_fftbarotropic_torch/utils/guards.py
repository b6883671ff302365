"""Numerical-health guards: the port's own copy of
xlab_fftbarotropic_tpu/utils/guards.py.

The reference crashes or silently produces NaN fields on blow-up; here the
runner can check each recorded state and fail loudly with the step index —
the stepping hot path stays untouched (checks run only at record boundaries, on
values already fetched for output).
"""

from __future__ import annotations

import math
import warnings

import numpy as np


class BlowUpError(RuntimeError):
    """State became non-finite (CFL violation / instability)."""


class AdvectiveCflError(BlowUpError):
    """ETDRK4 advective stability limit exceeded (caught from the
    recorded per-step cfl scalar BEFORE the state goes non-finite)."""


# ETDRK4 integrates the linear waves exactly, so the only stability
# limit left is the advective CFL of the RK4-structured nonlinear
# stages: max_k |u kx + v ky| * dt <= 2.8 (the imaginary-axis bound).
# The runner's per-record cfl stat is max(|u|/dx + |v|/dy) * dt and
# max_k(|u| kx + |v| ky) = pi * max(|u|/dx + |v|/dy) (positive-Nyquist
# kx_max = pi/dx), so the stat-space limit is 2.8/pi. The a-priori
# isotropic-wind form of the same bound is max_advective_dt (which
# models/etdrk4.py exports, where the JAX package defines it).
ETD_CFL_LIMIT = 2.8 / math.pi


def max_advective_dt(cfg, u_max: float) -> float:
    """Advective stability estimate for ETDRK4 (the linear waves are
    exact, so this is the only CFL left): |u|_max k_max dt <= 2.8 (the
    RK4 imaginary-axis bound)."""
    kx_max = math.pi * cfg.nx / cfg.lx
    ky_max = math.pi * cfg.ny / cfg.ly
    k_max = math.hypot(kx_max, ky_max)
    return 2.8 / max(u_max * k_max, 1e-30)


def check_etd_cfl(step: int, cfl: float, cfg, at_start: bool) -> None:
    """Warn (initial state) or raise AdvectiveCflError (later records)
    when the recorded cfl stat violates the ETDRK4 advective bound —
    the big-dt scheme's one remaining stability limit, surfaced with
    the step index and the implied stable dt instead of a late
    BlowUpError full of NaNs."""
    if cfl is None or not np.isfinite(cfl) or cfl <= ETD_CFL_LIMIT:
        return
    dt = float(cfg.dt)
    dt_sharp = dt * ETD_CFL_LIMIT / cfl
    # conservative isotropic-wind form of the same bound, for the wind
    # speed implied by the stat if it came from one velocity component
    u_impl = cfl / dt * min(cfg.dx, cfg.dy)
    dt_iso = max_advective_dt(cfg, u_impl)
    msg = (f"step {step}: advective CFL stat {cfl:.3f} exceeds the "
           f"ETDRK4 stability limit {ETD_CFL_LIMIT:.3f} "
           f"(= 2.8/pi on max(|u|/dx + |v|/dy)*dt; "
           f"max_advective_dt) — reduce dt below "
           f"~{dt_sharp:.3g} s (isotropic-wind estimate "
           f"{dt_iso:.3g} s)")
    if at_start:
        warnings.warn(msg + "; warning only at the initial state — "
                      "the run aborts at the first violating record",
                      stacklevel=2)
    else:
        raise AdvectiveCflError(msg)


def check_finite(step: int, **fields) -> None:
    """Raise BlowUpError naming the first non-finite recorded field."""
    for name, arr in fields.items():
        if arr is None:
            continue
        a = np.asarray(arr)
        finite = np.isfinite(a)
        if not finite.all():
            bad = int(np.size(a) - finite.sum())
            peak = (f"max |finite| = {np.abs(a[finite]).max():.3e}"
                    if finite.any() else "no finite values left")
            raise BlowUpError(
                f"step {step}: field {name!r} has {bad} non-finite values "
                f"({peak}) — likely CFL violation; reduce dt or increase nu")
