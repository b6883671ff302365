"""Ensemble integration, M perturbed-IC members in one run: the
counterpart of xlab_fftbarotropic_tpu/models/ensemble.py.

The reference runs one simulation per process (main.cpp: one state, one
time loop), so a perturbed-IC ensemble costs M serial runs. Here the
members advance in chunks of `vmap_width` (the JAX package's vmap chunk
width):

  * width 1: each member is stepped by the solo model, member by member
    (the JAX package's unbatched width-1 chunks). Under `auto` on a grid
    the kernels take, that is the plane stepper's hand-written kernels,
    so each member's state is the solo run's bit for bit.
  * width > 1: a chunk is one batched state with a leading member axis
    on the library path (torch.fft takes leading axes, ops/fft.py), the
    counterpart of jax.vmap; `auto` resolves to "xla" for it, as
    _resolve_member_backend does in the JAX package. The kernels take
    one field per launch, so a chunk on an explicit "pallas" backend
    runs member by member.
  * fast mode (build_kw fast=True, the JAX package's --fast-transforms):
    width-1 members build the plane stepper with it, so each is the solo
    fast run bit for bit; a batched chunk stays float32 on torch.fft, as
    the library path does (and the JAX package's batched chunks on XLA's
    FFT).

Forcing is shared across members (one source field per step, the
reference's one-stream protocol, SURVEY.md §3.2). The IC spread comes
from perturb_vorticity: band-limited spectral noise, member 0 left
unperturbed as the control. jax.random's bits cannot be drawn in torch,
so the draw (a torch.Generator seeded by `seed`, on the CPU, so the
same on every device) is split from its shaping, perturb_from_noise,
which the JAX package's noise can be fed through.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..ops import fft
from .barotropic import resolve_device, resolve_fft_backend_name

# auto_vmap_width's threshold: the largest grid side at which a chunk
# holds every member (above: width 1). From scripts/ensemble_sweep.py on
# an NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md §6): one
# batched chunk of M was the best width at 256^2 and 512^2 for M = 8
# and 32; at 1024^2 width 1 was for M = 8, and at 2048^2 for both; a
# chunk of 8 of 32 members was best nowhere (the TPU's middle tier).
FULL_WIDTH_MAX_N = 512


def _tmap(fn, state):
    """fn on each field of a state: a tensor or a NamedTuple of them."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    return type(state)(*(fn(a) for a in state))


def _tjoin(states, join):
    """Stack (torch.stack) or concatenate (torch.cat) states field by
    field along the member axis."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return join(states, 0)
    return type(first)(*(join(list(f), 0) for f in zip(*states)))


def perturb_from_noise(cfg: ModelConfig, vort0, noise: torch.Tensor,
                       amplitude: float, k_frac: float = 0.5
                       ) -> torch.Tensor:
    """The perturbed batch (M, nx, ny) from white noise (M-1, nx, ny),
    on noise's device: member 0 is vort0; members 1..M-1 add the noise
    restricted to isotropic wavenumber indices 0 < |k_idx| <= k_frac *
    the dealias cutoff (the perturbation lives well inside the resolved
    scales, with zero mean), normalized to unit RMS in physical space and
    scaled by amplitude * rms(vort0) (ensemble.py:70-82 of the JAX
    package, on torch.fft)."""
    dev = noise.device
    nx, ny = cfg.grid_shape
    v0 = torch.as_tensor(vort0, dtype=torch.float32, device=dev)
    kc = k_frac * float(min(cfg.dealias_kx, cfg.dealias_ky))
    ix = np.minimum(np.arange(nx), nx - np.arange(nx))
    jy = np.arange(ny // 2 + 1)
    r2 = ix[:, None] ** 2 + jy[None, :] ** 2
    lowpass = torch.from_numpy(np.where((r2 > 0) & (r2 <= kc * kc), 1.0,
                                        0.0).astype(np.float32)).to(dev)
    smooth = fft.inverse(fft.forward(noise) * lowpass, (nx, ny))
    rms = torch.sqrt(torch.mean(smooth * smooth, dim=(1, 2), keepdim=True))
    smooth = smooth / torch.clamp(rms, min=1e-30)
    scale = amplitude * torch.sqrt(torch.mean(v0 * v0))
    return torch.cat([v0[None], v0[None] + scale * smooth], dim=0)


def perturb_vorticity(cfg: ModelConfig, vort0, n_members: int,
                      amplitude: float = 0.05, seed: int = 0,
                      k_frac: float = 0.5, device="cpu") -> torch.Tensor:
    """The perturbed initial vorticity batch (M, nx, ny) float32 on
    `device`: perturb_from_noise of standard normal noise drawn on the
    CPU from torch.Generator().manual_seed(seed), so the batch is
    deterministic in (seed, n_members, grid) and the same on every
    device. With one member or zero amplitude every member is vort0."""
    if n_members < 1:
        raise ValueError(f"n_members must be >= 1, got {n_members}")
    dev = resolve_device(device)
    nx, ny = cfg.grid_shape
    if n_members == 1 or amplitude == 0.0:
        v0 = torch.as_tensor(vort0, dtype=torch.float32, device=dev)
        return v0[None].expand(n_members, nx, ny).contiguous()
    gen = torch.Generator().manual_seed(int(seed))
    noise = torch.randn((n_members - 1, nx, ny), generator=gen,
                        dtype=torch.float32)
    return perturb_from_noise(cfg, vort0, noise.to(dev), amplitude, k_frac)


def _resolve_member_backend(cfg: ModelConfig, vmap_width: int
                            ) -> ModelConfig:
    """'auto' per chunk width: width-1 chunks run the solo program, so
    they keep 'auto' where it takes the kernels; batched chunks (and
    grids the kernels do not take) pin the library path 'xla'. An
    explicit backend is kept (ensemble.py:87-110 of the JAX package)."""
    if cfg.fft_backend != "auto":
        return cfg
    if (vmap_width == 1
            and resolve_fft_backend_name("auto", cfg.grid_shape)
            == "pallas"):
        return cfg
    return cfg.replace(fft_backend="xla")


def auto_vmap_width(cfg: ModelConfig, n_members: int) -> int:
    """The default chunk width: every member up to FULL_WIDTH_MAX_N, 1
    above (the H100 sweep behind the threshold: PERF.md §6; the JAX
    package's TPU rule was every member to 256^2, 8 to 512^2).
    XFB_ENSEMBLE_WIDTH overrides it. The width is snapped down to a
    divisor of M."""
    env = os.environ.get("XFB_ENSEMBLE_WIDTH")
    if env:
        target = max(1, int(env))
    else:
        target = (n_members if max(cfg.nx, cfg.ny) <= FULL_WIDTH_MAX_N
                  else 1)
    target = min(target, n_members)
    while n_members % target:
        target -= 1
    return target


def _member_model(cfg: ModelConfig, device, model_kind: str,
                  tracer_kappa: float, **build_kw):
    """The inner single-member model of a family."""
    if model_kind in ("barotropic", "bt"):
        from .barotropic import BarotropicModel
        return BarotropicModel.build(cfg, device, **build_kw)
    if model_kind in ("shallow-water", "sw"):
        from .shallow_water import ShallowWaterModel
        return ShallowWaterModel.build(cfg, device, **build_kw)
    if model_kind == "tracer":
        from .tracer import TracerModel
        return TracerModel.build(cfg, device, kappa=tracer_kappa, **build_kw)
    raise ValueError(
        f"ensemble is not supported for model kind {model_kind!r}")


class EnsembleModel:
    """An M-member wrapper around one of the model families on one
    device.

    `step`/`segment`/`diags`/`stats` have the single model's signatures
    with every state field carrying a leading member axis; `src` stays
    unbatched (shared forcing). `diags` returns the family's fields
    stacked to (M, nx, ny), `stats` its scalars stacked to (M,), each
    member's computed as the solo model computes it. `batched` is true
    when the chunks of `vmap_width` > 1 run as one batched state (the
    inner model on the library path).
    """

    def __init__(self, cfg: ModelConfig, device, n_members: int,
                 model_kind: str = "barotropic", tracer_kappa: float = 0.0,
                 vmap_width: Optional[int] = None, **build_kw):
        m = int(n_members)
        if m < 1:
            raise ValueError(f"n_members must be >= 1, got {m}")
        width = auto_vmap_width(cfg, m) if vmap_width is None \
            else int(vmap_width)
        if width < 1 or m % width:
            raise ValueError(f"vmap_width {width} must divide "
                             f"n_members {m}")
        self.cfg = _resolve_member_backend(cfg, width)
        self.n_members = m
        self.model_kind = model_kind
        self.vmap_width = width
        self.inner = _member_model(self.cfg, device, model_kind,
                                   tracer_kappa, **build_kw)
        self.device = self.inner.device
        self.batched = width > 1 and self.inner.backend == "xla"

    @classmethod
    def build(cls, cfg: ModelConfig, device, n_members: int,
              model_kind: str = "barotropic", tracer_kappa: float = 0.0,
              vmap_width: Optional[int] = None,
              **build_kw) -> "EnsembleModel":
        """`build_kw` goes to the family's build (the barotropic
        family's yfirst and fusion arm, the shallow-water family's
        yfirst, split and pstore, and each family's fast: width-1
        members then run the fast plane stepper, batched chunks stay on
        the float32 library path)."""
        return cls(cfg, device, n_members, model_kind, tracer_kappa,
                   vmap_width, **build_kw)

    def _members(self, state):
        return [_tmap(lambda a: a[k], state) for k in range(self.n_members)]

    def _chunked(self, fn, state):
        """fn (a single-member state -> state function) over the
        batch: one call per chunk when batched, else one per member."""
        m, w = self.n_members, self.vmap_width
        if not self.batched:
            return _tjoin([fn(s) for s in self._members(state)],
                          torch.stack)
        if w == m:
            return fn(state)
        return _tjoin([fn(_tmap(lambda a: a[i:i + w], state))
                       for i in range(0, m, w)], torch.cat)

    def step(self, state, src):
        return self._chunked(lambda s: self.inner.step(s, src), state)

    def segment(self, state, src, n_steps: int):
        return self._chunked(lambda s: self.inner.segment(s, src, n_steps),
                             state)

    def diags(self, state):
        return _tjoin([self.inner.diags(s) for s in self._members(state)],
                      torch.stack)

    def stats(self, state):
        return _tjoin([self.inner.stats(s) for s in self._members(state)],
                      torch.stack)

    def init_from_physical(self, vort0, amplitude: float = 0.05,
                           seed: int = 0):
        """The perturbed-IC batch -> the batched state, each member's
        made as the solo runner makes it (the tracer's IC is the
        member's vorticity, as in the JAX package)."""
        batch = perturb_vorticity(self.cfg, vort0, self.n_members,
                                  amplitude=amplitude, seed=seed,
                                  device=self.device)
        if self.model_kind in ("shallow-water", "sw"):
            init = self.inner.geostrophic_init
        elif self.model_kind == "tracer":
            def init(v):
                return self.inner.init_state(v, v)
        else:
            init = self.inner.init_state
        return _tjoin([init(v) for v in batch], torch.stack)

    def spread(self, state) -> torch.Tensor:
        """The ensemble spread: RMS over the grid of the members'
        standard deviation of physical vorticity."""
        vort = self.diags(state).vort            # (M, nx, ny)
        sd = torch.std(vort, dim=0, correction=0)
        return torch.sqrt(torch.mean(sd * sd))
