"""Differentiable simulation: adjoint gradients through the RK4 rollout,
the counterpart of xlab_fftbarotropic_tpu/adjoint.py.

The library steppers (models/*: rk4_step) are plain torch functions of
their inputs, so autograd differentiates the whole integration: 4DVar
initial-condition estimation, forcing inversion, sensitivity analysis,
at the cost of about one more rollout per gradient.

Memory: backpropagating an N-step loop keeps every stage's
activations. make_rollout checkpoints it in segments of `segment` steps
(default round(sqrt(N)), plus the remainder): each segment runs under
torch.utils.checkpoint, so the backward sweep keeps only the segment
boundaries and recomputes one segment's activations at a time (the JAX
package's two-level checkpointed scan). Every step therefore runs twice
in a gradient, once in each sweep.

The transforms follow cfg.fft_backend (models/barotropic.py:
resolve_fft_backend): on "pallas" ("auto" on the square power-of-two
grids the kernels take) they are the per-transform kernels with their
adjoints (ops/fused_diff.py), so both sweeps run ka, kb and kc and no
library transform; on "xla", torch.fft and its autograd. `fast` (the
JAX package's assimilate --fast-transforms) runs both sweeps on the fast
column tile, ka_fast, kb_fast and kc_fast; on "xla" it changes nothing.
Gradients are taken with respect to physical (real float32) inputs; the
spectral transform sits inside the differentiated function.

The three families:

- ``barotropic``: rollout(vort0, src) -> final physical vorticity.
- ``sw``: rollout(vort0, src) -> final physical (zeta, div, eta), from
  the geostrophically balanced state of vort0.
- ``tracer``: rollout((vort0, q0), src) -> final physical (zeta, q).

Entry points run on the card (device "cuda") unless the caller passes
device="cpu", where the kernels' plain versions run. make_sharded_rollout
is the barotropic rollout on a shard group (parallel/model.py), the
device that of the group; over torch.distributed ranks it is rank-local
(its docstring).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .models import barotropic as bt
from .models import shallow_water as sw
from .models import tracer as tr
from .models.barotropic import resolve_device, resolve_fft_backend
from .ops import fused_sw as fs
from .ops import spectral as sp
from .ops.spectral import SpectralTables


def _segment_lengths(n_steps: int, segment: Optional[int]
                     ) -> Tuple[int, int, int]:
    """(segment, n_outer, remainder): n_outer segments of `segment` steps
    and a remainder. Default segment about sqrt(n_steps), where the live
    states of the backward sweep, n_outer + segment, are fewest."""
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    if segment is None:
        segment = max(1, int(round(math.sqrt(n_steps))))
    segment = max(1, min(int(segment), n_steps))
    return segment, n_steps // segment, n_steps % segment


def _checkpointed_loop(step: Callable, state: tuple, n_steps: int,
                       segment: Optional[int]) -> tuple:
    """`step` (a tuple of tensors -> the next) n_steps times, each
    segment under torch.utils.checkpoint when autograd records."""
    seg, n_outer, rem = _segment_lengths(n_steps, segment)

    def run(length, *s):
        for _ in range(length):
            s = step(s)
        return tuple(s)

    for length in [seg] * n_outer + ([rem] if rem else []):
        if torch.is_grad_enabled():
            state = checkpoint(run, length, *state, use_reentrant=False)
        else:
            state = run(length, *state)
    return state


def make_rollout(cfg, n_steps: int, model_kind: str = "barotropic",
                 segment: Optional[int] = None, tracer_kappa: float = 0.0,
                 device="cuda", fast: bool = False) -> Callable:
    """A differentiable n_steps RK4 rollout of one model family:
    ``rollout(ic_phys, src)`` maps physical inputs to the final physical
    fields (module docstring). `src` is the vorticity source held over
    the window (zeros for a free run). Both arguments are
    differentiable; numpy arrays and tensors are taken, as float32 on
    `device`. `fast`: the transforms on the fast column tile in both
    sweeps."""
    dev = resolve_device(device)
    t = SpectralTables.from_config(cfg, dev)
    g = cfg.grid_shape
    dt, nu = float(cfg.dt), float(cfg.nu)
    r_drag, beta, nu4 = float(cfg.r_drag), float(cfg.beta), float(cfg.nu4)
    if beta != 0.0 and model_kind == "sw":
        raise NotImplementedError("beta-plane is barotropic/tracer-only "
                                  "(config.py beta note)")
    fwd, inv, inv_pair = resolve_fft_backend(cfg.fft_backend, g,
                                             differentiable=True, fast=fast)
    kw = dict(fwd=fwd, inv=inv, inv_pair=inv_pair, r_drag=r_drag)

    def phys(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    if model_kind == "barotropic":
        def rollout(vort0, src):
            src = phys(src)
            (z,) = _checkpointed_loop(
                lambda s: (bt.rk4_step(t, s[0], src, dt, nu, g, beta=beta,
                                       nu4=nu4, **kw),),
                (fwd(phys(vort0)),), n_steps, segment)
            return inv(z, g)
    elif model_kind == "sw":
        f, grav, H = float(cfg.f), float(cfg.gravity), float(cfg.mean_depth)
        mean_mask = sw.mean_mode_mask(cfg, dev)   # no tilt of the mean

        def rollout(vort0, src):
            src = phys(src)
            zh = fwd(phys(vort0))
            s0 = (zh, torch.zeros_like(zh),
                  (f / grav) * sp.invert_laplacian(t, zh) * mean_mask)
            # fast mode pairs (zeta, eta) at one magnitude, as the model's
            # per-transform path does (models/shallow_water.py: tendency)
            es = 1.0
            if fast:
                with torch.no_grad():
                    es = float(fs.eta_pair_scale(sw.state_to_planes(
                        sw.SWState(*(z.detach() for z in s0)))))
            s = _checkpointed_loop(
                lambda s: tuple(sw.rk4_step(t, sw.SWState(*s), src, dt, f,
                                            grav, nu, H, g, nu4=nu4,
                                            eta_scale=es, **kw)),
                s0, n_steps, segment)
            return tuple(inv(z, g) for z in s)
    elif model_kind == "tracer":
        kappa = float(tracer_kappa)

        def rollout(ic, src):
            src = phys(src)
            vort0, q0 = ic
            s = _checkpointed_loop(
                lambda s: tuple(tr.rk4_step(t, tr.TracerState(*s), src, dt,
                                            nu, kappa, g, beta=beta,
                                            nu4=nu4, **kw)),
                (fwd(phys(vort0)), fwd(phys(q0))), n_steps, segment)
            return tuple(inv(z, g) for z in s)
    else:
        raise ValueError(f"unknown model_kind {model_kind!r}")
    return rollout


def make_sharded_rollout(cfg, n_steps: int, mesh, decomp: str = "slab",
                         segment: Optional[int] = None) -> Callable:
    """The differentiable n_steps RK4 rollout of the barotropic family on
    a shard group (parallel/model.py make_mesh): the decomposition's
    distributed forward transform, the checkpointed RK4 loop (inverses
    unpaired, as the sharded model's) and the distributed inverse. The
    transforms are the library impl ('xla'), as in the JAX package:
    autograd runs through torch.fft and the transposes' copies or
    collectives (the a2a and xstage kernels have no backward). decomp
    'slab' or 'xpencil' on a 1-D group (make_mesh) or over the flattened
    pair of a 2-D one, 'pencil' on a 2-D one (parallel/pencil.py
    make_pencil_mesh).

    Stacked group (one process): make_rollout's contract,
    ``rollout(vort0, src)`` from the global physical (nx, ny) inputs to
    the global final physical vorticity, differentiable in both.

    Distributed group (one shard per torch.distributed rank:
    make_mesh(None) or make_pencil_mesh on an initialized runtime):
    rank-local.
    Every rank passes the same global physical (nx, ny) inputs; the
    rollout takes the rank's shard of them (its rows, or for the pencil
    its tile in mesh order) and returns the rank's shard of the final
    physical vorticity with a leading axis of 1: (1, nx/P, ny), or
    (1, nx/Px, ny/Py) for the pencil. The transposes are collectives
    whose backward is the same all_to_all (multihost.all_to_all), and
    torch.utils.checkpoint recomputes a segment's collectives inside the
    backward sweep: every rank runs the rollout and calls backward
    together, on the same graph. A loss is the sum over ranks of each
    rank's loss on its shard; the gradient with respect to a global
    input on rank r is then nonzero on rank r's rows or tile only, and
    the sum of the ranks' gradients is the stacked rollout's gradient of
    the summed loss."""
    from .parallel import dfft, pencil
    from .parallel.model import _decomp_setup

    t, fwd, inv, _, _ = _decomp_setup(cfg, mesh, "xla", decomp)
    g = cfg.grid_shape
    dt, nu = float(cfg.dt), float(cfg.nu)
    r_drag, beta, nu4 = float(cfg.r_drag), float(cfg.beta), float(cfg.nu4)
    if decomp == "pencil":
        def to_shards(a):
            return pencil.shard_tiles(a, mesh.shape)

        def unshard(a):
            return pencil.unshard_tiles(a, mesh.shape)
    else:
        def to_shards(a):
            return dfft.shard_rows(a, mesh.n_shards)

        unshard = dfft.unshard_rows
    # the physical shard a rank holds: its rows, or its tile in mesh order
    k = mesh.rank

    def shards(a):
        s = to_shards(torch.as_tensor(a, dtype=torch.float32,
                                      device=mesh.device))
        return s if k is None else s[k:k + 1]

    def rollout(vort0, src):
        src = shards(src)
        (z,) = _checkpointed_loop(
            lambda s: (bt.rk4_step(t, s[0], src, dt, nu, g, fwd=fwd,
                                   inv=inv, inv_pair=None, r_drag=r_drag,
                                   beta=beta, nu4=nu4),),
            (fwd(shards(vort0)),), n_steps, segment)
        out = inv(z, g)
        return out if mesh.distributed else unshard(out)

    return rollout


def _leaves(x) -> list:
    return list(x) if isinstance(x, (tuple, list)) else [x]


def final_state_misfit(cfg, target, n_steps: int,
                       model_kind: str = "barotropic",
                       segment: Optional[int] = None,
                       tracer_kappa: float = 0.0, device="cuda",
                       fast: bool = False) -> Callable:
    """``loss(ic_phys, src) -> scalar``: half the mean-square misfit of
    the rollout's final physical field(s) against `target` (the
    rollout's structure), summed over the fields: the strong-constraint
    4DVar cost with one observation time and the identity observation
    operator. `fast` as make_rollout's."""
    dev = resolve_device(device)
    roll = make_rollout(cfg, n_steps, model_kind=model_kind,
                        segment=segment, tracer_kappa=tracer_kappa,
                        device=dev, fast=fast)
    tgt = [torch.as_tensor(a, dtype=torch.float32, device=dev)
           for a in _leaves(target)]

    def loss(ic, src):
        out = _leaves(roll(ic, src))
        return 0.5 * torch.stack([torch.mean(torch.square(a - b))
                                  for a, b in zip(out, tgt)]).sum()

    return loss


def loss_and_grad(loss: Callable, wrt: str = "ic",
                  device="cuda") -> Callable:
    """``(ic, src) -> (loss, grad)`` for a loss from final_state_misfit.
    `wrt` picks the control: "ic", "src" or "both" (grad is then
    (grad_ic, grad_src)); a tracer ic (vort0, q0) gets a pair of
    gradients. The loss comes back detached."""
    if wrt not in ("ic", "src", "both"):
        raise ValueError(f"wrt must be 'ic', 'src' or 'both', got {wrt!r}")
    dev = resolve_device(device)

    def leaf(a):
        return torch.as_tensor(a, dtype=torch.float32,
                               device=dev).detach().requires_grad_(True)

    def vg(ic, src):
        pair = isinstance(ic, (tuple, list))
        ics = [leaf(a) if wrt != "src" else a for a in _leaves(ic)]
        s = leaf(src) if wrt != "ic" else src
        val = loss(tuple(ics) if pair else ics[0], s)
        inputs = (ics if wrt != "src" else []) + ([s] if wrt != "ic" else [])
        grads = torch.autograd.grad(val, inputs)
        g_ic = (tuple(grads[:len(ics)]) if pair else grads[0]
                ) if wrt != "src" else None
        g_src = grads[-1] if wrt != "ic" else None
        return val.detach(), {"ic": g_ic, "src": g_src,
                              "both": (g_ic, g_src)}[wrt]

    return vg


def fit_initial_condition(cfg, target, n_steps: int, ic0, src=None,
                          model_kind: str = "barotropic", iters: int = 100,
                          learning_rate: float = 0.2,
                          segment: Optional[int] = None,
                          tracer_kappa: float = 0.0,
                          normalize_cost: bool = True, device="cuda",
                          fast: bool = False):
    """4DVar initial-condition estimation: Adam (optax's defaults: b1
    0.9, b2 0.999, eps 1e-8) on the final-state misfit with respect to
    the physical initial condition, from the first guess `ic0`. Returns
    ``(ic_opt, losses)``: the fitted IC (a tensor, or a pair for the
    tracer) and the cost history, a numpy array of length iters + 1 (the
    initial cost first) in physical units.

    normalize_cost (default on) descends the cost over its first-guess
    value: the mean-square misfit scales each gradient element by 1/N,
    and at large grids with small fields Adam's eps then swamps the
    update (the JAX package's finding at 4096²). A first guess already
    at the optimum (a cost under 1e-9 of the target's own) is not
    normalized. `fast`: the rollout's transforms on the fast column tile
    in both sweeps (make_rollout)."""
    dev = resolve_device(device)
    if src is None:
        src = torch.zeros(cfg.grid_shape, dtype=torch.float32, device=dev)
    src = torch.as_tensor(src, dtype=torch.float32, device=dev)
    raw = final_state_misfit(cfg, target, n_steps, model_kind=model_kind,
                             segment=segment, tracer_kappa=tracer_kappa,
                             device=dev, fast=fast)
    pair = isinstance(ic0, (tuple, list))
    ics = [torch.as_tensor(a, dtype=torch.float32, device=dev).clone()
           .requires_grad_(True) for a in _leaves(ic0)]

    def ic():
        return tuple(ics) if pair else ics[0]

    unscale = 1.0
    if normalize_cost:
        with torch.no_grad():
            l0 = float(raw(ic(), src))
        tscale = 0.5 * sum(float(torch.mean(torch.square(torch.as_tensor(
            a, dtype=torch.float32)))) for a in _leaves(target))
        if l0 > max(1e-9 * tscale, 0.0) and l0 > 0.0:
            unscale = l0
    scale = float(np.float32(1.0 / unscale))
    opt = torch.optim.Adam(ics, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = []
    for _ in range(iters):
        opt.zero_grad(set_to_none=True)
        val = raw(ic(), src) * scale
        val.backward()
        opt.step()
        losses.append(float(val.detach()) * unscale)
    with torch.no_grad():
        losses.append(float(raw(ic(), src) * scale) * unscale)
    out = tuple(a.detach() for a in ics)
    return (out if pair else out[0]), np.asarray(losses)
