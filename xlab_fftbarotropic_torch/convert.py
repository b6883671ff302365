"""Carry data between the JAX package and the port, both ways.

In this system the "weights" are the spectral coefficient tables and the
state is the complex64 half-spectrum zeta_hat (the tracer family: the
pair zeta_hat, q_hat; shallow water: zeta_hat, div_hat, eta_hat); both
cross as numpy arrays, so neither side
imports the other. A sharded model's state crosses as the global array,
each package's pad stripped and its own put back. Checkpoints need no conversion: both runners write
and read them in one format (io/checkpoint.py, the port's copy of the
JAX package's: the complex64 state as packed below + config hash), so a
checkpoint from either resumes in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.shallow_water import SWState
from .models.tracer import TracerState
from .ops.spectral import SpectralTables


def tables_from_numpy(tables: dict, device) -> SpectralTables:
    """{'kx', 'ky', 'lap', 'inv_lap', 'mask', 'rlap'} numpy arrays (for
    example np.asarray of each field of the JAX SpectralTables) ->
    SpectralTables on `device`."""
    return SpectralTables({n: np.asarray(tables[n], dtype=np.float32)
                           for n in SpectralTables.NAMES}, device)


def tables_to_numpy(t: SpectralTables) -> dict:
    return {n: getattr(t, n).detach().cpu().numpy()
            for n in SpectralTables.NAMES}


def state_from_numpy(zeta_hat: np.ndarray, device):
    """complex64 (nx, hny) -> (zr, zi) float32 planes on `device`."""
    z = np.asarray(zeta_hat)
    if z.dtype != np.complex64 or z.ndim != 2:
        raise ValueError(f"expected a complex64 (nx, hny) state, got "
                         f"{z.dtype} {z.shape}")
    zr = torch.from_numpy(np.ascontiguousarray(z.real)).to(device)
    zi = torch.from_numpy(np.ascontiguousarray(z.imag)).to(device)
    return zr, zi


def state_to_numpy(zr: torch.Tensor, zi: torch.Tensor) -> np.ndarray:
    """(zr, zi) float32 planes -> complex64 (nx, hny) numpy."""
    return torch.complex(zr, zi).detach().cpu().numpy()


def tracer_state_from_numpy(packed: np.ndarray, device) -> TracerState:
    """complex64 (2, nx, hny) = [zeta_hat, q_hat], as the JAX tracer
    adapter packs it for checkpoints -> TracerState on `device`."""
    p = np.asarray(packed)
    if p.dtype != np.complex64 or p.ndim != 3 or p.shape[0] != 2:
        raise ValueError(f"expected a complex64 (2, nx, hny) tracer state, "
                         f"got {p.dtype} {p.shape}")
    return TracerState(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                         for a in p))


def tracer_state_to_numpy(state: TracerState) -> np.ndarray:
    """TracerState -> complex64 (2, nx, hny) numpy [zeta_hat, q_hat]."""
    return np.stack([z.detach().cpu().numpy() for z in state])


def sw_state_from_numpy(packed: np.ndarray, device) -> SWState:
    """complex64 (3, nx, hny) = [zeta_hat, div_hat, eta_hat], as the JAX
    shallow-water adapter packs it for checkpoints -> SWState on
    `device`."""
    p = np.asarray(packed)
    if p.dtype != np.complex64 or p.ndim != 3 or p.shape[0] != 3:
        raise ValueError(f"expected a complex64 (3, nx, hny) shallow-water "
                         f"state, got {p.dtype} {p.shape}")
    return SWState(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in p))


def sw_state_to_numpy(state: SWState) -> np.ndarray:
    """SWState -> complex64 (3, nx, hny) numpy [zeta_hat, div_hat,
    eta_hat]."""
    return np.stack([z.detach().cpu().numpy() for z in state])


def sharded_state_from_numpy(zeta_hat: np.ndarray, model) -> torch.Tensor:
    """The JAX sharded model's global state (np.asarray of its sharded
    array: (nx, hny), or for x-pencil (nx, hpad) padded to the JAX pad)
    -> the port's stacked shards for `model` (a ShardedBarotropicModel),
    the pad stripped and re-padded to the port's."""
    z = np.asarray(zeta_hat)
    if z.dtype != np.complex64 or z.ndim != 2:
        raise ValueError(f"expected a complex64 (nx, hny[pad]) state, got "
                         f"{z.dtype} {z.shape}")
    return model.shard_spectral(z)


def sharded_state_to_numpy(zeta_hat: torch.Tensor, model,
                           hpad: int = 0) -> np.ndarray:
    """The port's stacked shards -> the global complex64 (nx, hny) numpy,
    or (nx, hpad) zero-padded for a JAX x-pencil model of that pad."""
    z = model.unshard_spectral(zeta_hat).detach().cpu().numpy()
    if hpad > z.shape[1]:
        z = np.pad(z, ((0, 0), (0, hpad - z.shape[1])))
    return z
