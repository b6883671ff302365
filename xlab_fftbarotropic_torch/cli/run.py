"""`xfb-torch-run` — the model run command of the PyTorch / CUDA port.

    python -m xlab_fftbarotropic_torch.cli.run -I input -O output \
        -i initial_vorticity.bin --nx 4096 --ny 4096 --total-steps 20 \
        --record-step 10 [--device cuda|cpu]

The flags are those of xlab_fftbarotropic_tpu.cli.run for what the port
covers: the barotropic, tracer (-m tracer, --tracer-ic, --tracer-kappa)
and shallow-water (-m sw or -m shallow-water; --coriolis-f, --gravity,
--mean-depth, and under RK4 a --dt under the gravity-wave bound)
families, each with --time-scheme rk4 (default) or etdrk4 (the linear
terms integrated exactly from phi-function tables, models/etdrk4.py), the
-s script / -f fifo forcing, records, checkpoints and resume, for
each of the three families the sharded model (--shard, with --shard-fft
and --decomp slab, xpencil or pencil with --mesh-shape: one shard on the
one visible card, or one shard per process when the XFB_COORDINATOR,
XFB_NUM_PROCESSES and XFB_PROCESS_ID contract or torchrun starts several,
parallel/multihost.py), the perturbed-IC ensemble (--ensemble M,
--ensemble-amp, --ensemble-seed, --ensemble-width; each member's
records in output/mNN/), the
finite-difference core (-m fd, or -m jacobian) and a torch.profiler
trace of the run (--profile-dir). `--device
cuda` (the default) runs the plane stepper's hand-written CUDA kernels
and stops with an error when no GPU is visible; it never carries on on
the CPU. `--device cpu` runs the kernels' plain torch versions. Flags
the port does not cover yet stop with an error.

As in the JAX package, XFB_BT_YFIRST=0 (barotropic) and XFB_SW_YFIRST=0
(shallow water) in the environment select the plane stepper's x-first
transform order; y-first is the default. The barotropic y-first plane
stepper reads the JAX package's fusion switches the same way:
XFB_BT_FUSEKB (auto, 0 or empty: off, as auto is in strict float32;
half or full: kb_adv_half or kb_adv_full), XFB_BT_FUSEKX (0 or empty:
kx_fwd + visc instead of kx_visc), XFB_BT_FUSETAIL (on unless auto, 0 or
empty: the RK4 tail in stage 4's kx_visc_tail) and XFB_BT_FUSED_RK (0:
the unfused RK form). XFB_FUSEKX_MAX is not read: its 4096 cap is the
TPU's VMEM limit, and the port keeps the fused kx_visc up to 8192^2.

--fast-transforms is the JAX package's fast mode for the barotropic,
tracer and shallow-water families. Barotropic (RK4 or --time-scheme
etdrk4): XFB_BT_FUSEKB=auto resolves to half, and the y-first plane
stepper runs every fusion arm the XFB_BT_* switches pick with the
sub-DFTs of its FFT kernels (ka_diag, kb_pair, ky_adv, kb_adv_half,
kb_adv_full, kx_visc, kx_visc_tail, kx_fwd) as bf16 tensor-core
products (BarotropicModel.build(..., fast=True)); with XFB_BT_YFIRST=0
the x-first one runs ka_diag, kb, ka_adv and kc_visc so. Tracer (-m
tracer, RK4 or --time-scheme etdrk4): ka6, kb_pair, kb_adv_tracer and
kx_visc on the fast tile (TracerModel.build(..., fast=True)). Shallow
water (-m sw, RK4 or --time-scheme etdrk4): the y-first plane stepper
runs ka_sw, kb_pair, ky_all and kx_fwd on the fast tile
(ShallowWaterModel.build(..., fast=True)), with XFB_SW_YFIRST=0 the
x-first one ka_sw, kb, ka_fwd and kc_sw, and XFB_SW_SPLIT=auto and
XFB_SW_PSTORE=auto resolve to the split-linear formulation and the bf16
product store (the y-first kx_fwd's: the x-first kc_sw stores float32,
as in the JAX package); the CLI reads XFB_SW_SPLIT (auto, or 0, off or
empty: off; anything else on) and XFB_SW_PSTORE (auto, bf16 or
bfloat16; anything else f32) as pallas_sw.py does, in strict mode too;
shallow-water RK4 with --r-drag or --nu4 runs the per-transform
pipeline's ka, kb and kc on the fast tile (split-linear; the forcing
spectrum too). --shard (each family): --shard-fft overlap runs the fast
x-stages (xstage, or xstage_gather and xstage_scatter with --decomp
xpencil) and nothing else fast: the sharded shallow-water model has no
split-linear formulation, as the JAX package's; xla and pallas have
torch.fft x-stages and copy transposes, which fast mode leaves as they
are, as in the JAX package, and so has --decomp pencil (xla only).
--ensemble: width-1 members run the fast plane stepper, each the solo
fast run; batched chunks stay on the float32 library path. -m fd runs
its torch.fft core unchanged, as the JAX package's does. --fft-backend
xla keeps the float32 library path.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from pathlib import Path

# the file --profile-dir writes the run's torch.profiler trace into
TRACE_NAME = "xfb-torch-run.trace.json"
# the fast mode's banner: the JAX CLI's (xlab_fftbarotropic_tpu/cli/
# run.py), with the port's kernels and its error on an H100 (chip_smoke.py
# phase 5o: 30 steps of the 4096^2 gaussian, dt 3 s, vorticity against
# the strict kernel path)
FAST_BANNER = ("# fast transforms: bf16 tensor-core sub-DFTs (mma.sync "
               "m16n8k16, float32 accumulate) in every FFT kernel of the "
               "plane stepper (barotropic 30-step vorticity rel-L2 3.2e-5 "
               "at 4096^2 on an H100; reference parity needs the float32 "
               "default)")
# and its tracer line (chip_smoke.py phase 5o: bench.py's tracer
# configuration, 30 RK4 steps at 4096^2 against the strict kernel path)
TRACER_FAST_BANNER = (
    "# tracer fast mode: ka6, kb_pair, kb_adv_tracer and kx_visc on the "
    "fast tile; zeta and q are held apart (q's tendency is about 1e4 "
    "smaller): 30-step rel-L2 zeta 3.2e-5, q 2.9e-5 at 4096^2 on an H100")
# and its shallow-water note: the JAX CLI's, with the port's kernels and
# its figures on an H100 in each transform order (chip_smoke.py phases 5o
# and 5p: bench.py's SW configuration at 4096^2, 20 RK4 steps at dt
# 0.847 s, against the strict kernel path of the same order; the x-first
# order's kc_sw stores float32, as the JAX package's x-first branch does)
SW_FAST_NOTE = (
    "# NOTE: shallow-water fast mode runs the split-linear formulation "
    "(XFB_SW_SPLIT=auto): the f0/gravity balance terms stay exact "
    "float32, only the nonlinear fluxes ride the bf16 transforms. "
    "Measured at 4096^2/20 steps on an H100: {} ms/step (strict float32 "
    "{}), zeta rel-L2 {}, eta {} against the strict kernels. The "
    "recorded div field is noise-dominated RELATIVE to a balanced flow's "
    "near-zero divergence: use the float32 default if div itself is the "
    "diagnostic of interest.")
SW_FAST_BANNER = (
    "# fast transforms: bf16 tensor-core sub-DFTs (mma.sync m16n8k16, "
    "float32 accumulate) in ka_sw, kb_pair, ky_all and kx_fwd, the "
    "product spectra stored in bf16 (XFB_SW_PSTORE=auto)\n"
    + SW_FAST_NOTE.format("13.63", "12.45", "7.5e-5", "4.5e-4"))
# the SW per-transform path's: RK4 with drag or hyperviscosity (chip_smoke.py
# phase 5q: phase 5c's configuration, 20 steps at 4096^2 at dt 0.847 s,
# against the strict per-transform kernels)
SW_DRAG_FAST_BANNER = (
    "# fast transforms: bf16 tensor-core sub-DFTs (mma.sync m16n8k16, "
    "float32 accumulate) in ka, kb and kc of the per-transform pipeline "
    "(shallow-water RK4 with --r-drag/--nu4) and of the forcing spectrum\n"
    + SW_FAST_NOTE.format("37.12", "31.59", "1.3e-5", "5.2e-4"))
# the sharded model's (chip_smoke.py phase 5q: 20 steps at 4096^2 on four
# shards, against the strict overlap path)
SHARD_FAST_BANNER = (
    "# fast transforms: bf16 tensor-core sub-DFTs (mma.sync m16n8k16, "
    "float32 accumulate) in the overlap x-stages ({}); the y-stage stays "
    "torch.fft, as the JAX overlap impl's jnp.fft (20-step vorticity "
    "rel-L2 1.2e-5 at 4096^2 on four shards of an H100 against the strict "
    "overlap path)")
# and the sharded shallow-water and tracer families' lines (chip_smoke.py
# phase 5r: bench.py's SW and tracer configurations, 20 steps at 4096^2
# on four shards, against the strict overlap path)
SHARD_SW_FAST_NOTE = (
    "# NOTE: the sharded shallow-water model runs without the split-"
    "linear formulation in fast mode too, as the JAX package's: the "
    "f0/gravity terms ride the bf16 x-stages (20-step rel-L2 against "
    "the strict overlap path: zeta 1.9e-4, eta 3.3e-3 at 4096^2 on four "
    "shards of an H100)")
SHARD_TRACER_FAST_NOTE = (
    "# sharded tracer: 20-step rel-L2 zeta 1.2e-5, q 1.1e-5 at 4096^2 on "
    "four shards of an H100 against the strict overlap path")
SHARD_FAST_NONE = (
    "# fast transforms: --shard-fft {} runs torch.fft x-stages and copy "
    "transposes, which hold no matmul: fast mode changes nothing there, "
    "as in the JAX package")
PENCIL_FAST_NONE = (
    "# fast transforms: --decomp pencil runs its torch.fft x- and y-stages "
    "and copy transposes (--shard-fft xla only), which fast mode leaves "
    "float32, as in the JAX package")
# -m fd: the JAX CLI's banner, then what the FD core runs
FD_FAST_NOTE = (
    "# fast transforms: the FD core (Arakawa Jacobian, FFT Poisson solve) "
    "runs torch.fft, which fast mode leaves float32, as the JAX package's "
    "core runs jnp.fft: its records are the strict run's")
ENSEMBLE_FAST_NOTE = (
    "# fast transforms: batched ensemble chunks (width > 1) run the "
    "torch.fft library path in float32, as the JAX package's batched "
    "chunks run XLA's FFT")
SW_XFIRST_FAST_BANNER = (
    "# fast transforms: bf16 tensor-core sub-DFTs (mma.sync m16n8k16, "
    "float32 accumulate) in ka_sw, kb, ka_fwd and kc_sw (the x-first "
    "order), the product spectra stored in float32\n"
    + SW_FAST_NOTE.format("16.35", "13.64", "7.4e-5", "4.5e-4"))


def fast_banner(args, sw: bool, fd: bool, yfirst: bool, backend: str,
                width, drag: bool) -> str:
    """The lines --fast-transforms prints: the JAX CLI's banner with the
    kernels this run takes on the fast tile, or what fast mode leaves as
    it is (the library path, -m fd, the sharded xla and pallas impls)."""
    library = ("# fast transforms: --fft-backend xla keeps the torch.fft "
               "library path in float32, as the JAX package's XLA path")
    if fd:
        return FAST_BANNER + "\n" + FD_FAST_NOTE
    if args.shard:
        if args.decomp == "pencil":
            return PENCIL_FAST_NONE
        if args.shard_fft != "overlap":
            return SHARD_FAST_NONE.format(args.shard_fft)
        halves = ("xstage_gather, xstage_scatter" if args.decomp == "xpencil"
                  else "xstage")
        note = (SHARD_SW_FAST_NOTE if sw else SHARD_TRACER_FAST_NOTE
                if args.model == "tracer" else None)
        return SHARD_FAST_BANNER.format(halves) + (
            "\n" + note if note else "")
    if backend != "pallas":
        return ENSEMBLE_FAST_NOTE if width not in (None, 1) else library
    if sw:
        return (SW_DRAG_FAST_BANNER if drag else SW_FAST_BANNER if yfirst
                else SW_XFIRST_FAST_BANNER)
    if args.model == "tracer":
        return FAST_BANNER + "\n" + TRACER_FAST_BANNER
    return FAST_BANNER


def sw_form_from_env(fast: bool = False) -> dict:
    """ShallowWaterModel.build's fast, split and pstore from the
    environment, read as the JAX package reads XFB_SW_SPLIT and
    XFB_SW_PSTORE (ops/pallas_sw.py split_linear, pstore_dtype): "auto"
    (the default) is None, which the model resolves by `fast`."""
    split = os.environ.get("XFB_SW_SPLIT", "auto")
    pstore = os.environ.get("XFB_SW_PSTORE", "auto")
    return dict(fast=fast,
                split=None if split == "auto"
                else split not in ("0", "off", ""),
                pstore=None if pstore == "auto"
                else "bf16" if pstore in ("bf16", "bfloat16") else "f32")


def bt_fusion_from_env(fast: bool = False) -> dict:
    """BarotropicModel.build's fused_rk, fusekb, fusekx, fusetail and
    fast from the environment, read as the JAX package reads them
    (models/barotropic.py:_fused_rk, ops/pallas_fft.py:fusekb_mode,
    fusekx_on, fusetail_on), XFB_BT_FUSEKB=auto off in strict float32 and
    half in fast mode (fast: True only then). Raises ValueError on an
    XFB_BT_FUSEKB the package does not know."""
    fusekb = os.environ.get("XFB_BT_FUSEKB", "auto")
    if fusekb not in ("auto", "0", "", "half", "full"):
        raise ValueError(f"XFB_BT_FUSEKB={fusekb!r}: expected auto, 0, half "
                         f"or full")
    if fusekb == "auto":
        fusekb = "half" if fast else ""
    fusekx = os.environ.get("XFB_BT_FUSEKX", "auto")
    fusetail = os.environ.get("XFB_BT_FUSETAIL", "auto")
    out = dict(fused_rk=os.environ.get("XFB_BT_FUSED_RK", "1") != "0",
               fusekb="" if fusekb == "0" else fusekb,
               fusekx=fusekx not in ("", "0"),
               fusetail=fusetail not in ("auto", "", "0"))
    if fast:
        out["fast"] = True
    return out


def main(argv=None):
    import torch

    from ..config import add_config_args, config_from_args
    from ..models.barotropic import (fusion_arm, resolve_device,
                                     resolve_fft_backend_name)
    from ..models.ensemble import _resolve_member_backend, auto_vmap_width
    from ..models.shallow_water import (per_transform, resolve_pstore,
                                        resolve_split, resolve_sw_backend)
    from ..parallel import initialize_multihost
    from ..parallel.model import check_decomp
    from ..runner import run, shard_mesh

    p = argparse.ArgumentParser(
        prog="xfb-torch-run",
        description="Barotropic vorticity model run (PyTorch / CUDA port)")
    add_config_args(p)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the hand-written CUDA kernels, "
                        "error if no GPU is visible; cpu: their plain "
                        "torch versions")
    p.add_argument("-m", "--model", default="barotropic",
                   help="model family: barotropic (bt), tracer "
                        "(barotropic + co-advected passive scalar q, "
                        "recorded as q_step_N.bin), shallow-water (sw; "
                        "also records div and h) or fd (jacobian: the "
                        "finite-difference core, Arakawa Jacobian and FFT "
                        "Poisson solve)")
    p.add_argument("--tracer-ic", default="vorticity",
                   choices=["vorticity", "zonal", "meridional", "gaussian"],
                   help="tracer initial condition for -m tracer "
                        "(models/tracer.py:tracer_ic)")
    p.add_argument("--tracer-kappa", type=float, default=0.0,
                   help="tracer diffusivity kappa [m^2/s] for -m tracer "
                        "(0 = purely advective)")
    p.add_argument("-s", "--script", default=None, metavar="RECIPE",
                   help="vorticity-source script file "
                        "(lines: '<time> <field.bin>')")
    p.add_argument("-f", "--fifo", default=None, metavar="FIFO",
                   help="vorticity-source FIFO (per-step flag-byte protocol)")
    p.add_argument("--resume-from", default=None,
                   help="checkpoint .npz to resume from (written by either "
                        "package's runner)")
    p.add_argument("--no-record", action="store_true",
                   help="skip field records (benchmarking)")
    p.add_argument("--record-fields", default=None, metavar="NAMES",
                   help="comma list of fields to record (subset of vort, "
                        "psi, u, v, and div, h for -m sw; 'vort_src' for "
                        "the forcing dump). Default: all")
    p.add_argument("--debug-fields", action="store_true",
                   help="also dump dvortdx/dvortdy/dvortdt at record steps")
    p.add_argument("--manifest", default="log",
                   help="manifest path (the reference's `log` file)")
    p.add_argument("--step-banners", action="store_true",
                   help="print the '# Step N' banner for every step")
    p.add_argument("--shard", action="store_true",
                   help="run the family's sharded model (barotropic, "
                        "tracer or sw): one shard on the one visible card "
                        "(or the CPU with --device cpu; --decomp pencil: a "
                        "1x1 mesh), or one shard per process when several "
                        "run (XFB_COORDINATOR, XFB_NUM_PROCESSES, "
                        "XFB_PROCESS_ID, or torchrun --nproc-per-node N: "
                        "gloo on the CPU and for ranks sharing a card, "
                        "NCCL for one card each); rank 0 writes the files")
    p.add_argument("--shard-fft", default="xla",
                   choices=["xla", "pallas", "overlap"],
                   help="distributed-FFT implementation for --shard runs: "
                        "library transposes (default), the all-to-all "
                        "transpose kernels, or the fused transpose + "
                        "x-DFT kernels")
    p.add_argument("--decomp", default="slab",
                   choices=["slab", "xpencil", "pencil"],
                   help="domain decomposition for --shard runs: slab "
                        "(rows, default), xpencil (row-sharded physical + "
                        "column-sharded x-pencil spectral state: one "
                        "transpose per transform instead of two), or 2-D "
                        "pencil (tiles over a PxQ mesh, three transposes "
                        "per transform within mesh rows or columns; "
                        "--shard-fft xla only; see --mesh-shape)")
    p.add_argument("--mesh-shape", default=None, metavar="PxQ",
                   help="2-D mesh shape for --decomp pencil, e.g. 2x4; "
                        "its P*Q is the number of processes (default: "
                        "hosts x processes per host, 1x1 for one "
                        "process). Ignored without --decomp pencil, as in "
                        "the JAX package")
    p.add_argument("--ensemble", type=int, default=0, metavar="M",
                   help="run an M-member perturbed-IC ensemble "
                        "(barotropic, tracer or sw): member 0 is the "
                        "unperturbed control; each member records into "
                        "output/mNN/ with the reference file layout")
    p.add_argument("--ensemble-amp", type=float, default=0.05,
                   help="IC perturbation amplitude relative to rms(vort0) "
                        "(band-limited spectral noise; 0 = identical "
                        "members)")
    p.add_argument("--ensemble-seed", type=int, default=0,
                   help="seed of the ensemble IC perturbations "
                        "(deterministic member set)")
    p.add_argument("--ensemble-width", type=int, default=None,
                   help="members advanced per chunk: 1 steps each member "
                        "on its own (the plane stepper's kernels), more "
                        "steps a chunk as one batched state on torch.fft. "
                        "Default: models/ensemble.py:auto_vmap_width (the "
                        "H100 sweep); must divide M")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="trace the whole run with torch.profiler (CPU "
                        "and, on the card, CUDA activity) into "
                        "DIR/xfb-torch-run.trace.json (a Chrome trace)")
    p.add_argument("--fast-transforms", action="store_true",
                   help="the barotropic, tracer and shallow-water plane "
                        "steppers' sub-DFTs as bf16 tensor-core products, "
                        "float32 accumulate (the JAX package's fast mode), "
                        "in both transform orders (XFB_BT_YFIRST=0 / "
                        "XFB_SW_YFIRST=0: the x-first one); "
                        "XFB_BT_FUSEKB=auto resolves to half; shallow "
                        "water: split-linear, and the bf16 product store "
                        "on the y-first order (the x-first one stores "
                        "float32); shallow-water RK4 with --r-drag/--nu4: "
                        "the per-transform ka, kb, kc; --shard: the "
                        "overlap x-stages (--shard-fft xla and pallas "
                        "hold no matmul and stay as they are); "
                        "--ensemble: width-1 members (batched chunks stay "
                        "float32 on torch.fft); -m fd runs its torch.fft "
                        "core unchanged")
    args = p.parse_args(argv)

    fd = args.model in ("fd", "jacobian")
    sw = args.model in ("shallow-water", "sw")
    if args.ensemble > 1 and (args.shard or fd):
        p.error(f"--ensemble does not combine with "
                f"{'--shard' if args.shard else '-m ' + args.model}: "
                f"ensembles batch members on one card (barotropic, "
                f"tracer or sw)")
    mesh_shape = None
    if args.mesh_shape:
        try:
            mesh_shape = tuple(int(v) for v in
                               args.mesh_shape.lower().split("x"))
        except ValueError:
            mesh_shape = ()
        if len(mesh_shape) != 2:
            p.error(f"--mesh-shape must look like 2x4, got "
                    f"{args.mesh_shape!r}")
    if args.shard and fd:
        p.error(f"--shard with -m {args.model}: the FD core runs on one "
                f"device")
    if args.model not in ("barotropic", "bt", "tracer", "shallow-water",
                          "sw", "fd", "jacobian"):
        p.error(f"-m {args.model}: unknown model family")
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device is visible; pass --device "
                "cpu to run the kernels' plain torch versions on the CPU")
    if args.script and args.fifo:
        p.error("give at most one of -s / -f")

    record_only = None
    if args.record_fields is not None:
        record_only = [s.strip() for s in args.record_fields.split(",")
                       if s.strip()]
        if not record_only:
            p.error("--record-fields got an empty list; name at least one "
                    "field (e.g. vort,psi) or omit the flag")

    cfg = config_from_args(args)
    yfirst = os.environ.get("XFB_SW_YFIRST" if sw else "XFB_BT_YFIRST",
                            "1") != "0"
    bt_fusion = None
    if args.model in ("barotropic", "bt"):
        try:
            bt_fusion = bt_fusion_from_env(args.fast_transforms)
        except ValueError as e:
            p.error(str(e))
    if sw and cfg.beta != 0.0:
        p.error("--beta: the beta-plane is barotropic/tracer-only")
    sw_form = sw_form_from_env(args.fast_transforms) if sw else None
    member_cfg, width = cfg, None
    if args.ensemble > 1:
        width = (auto_vmap_width(cfg, args.ensemble)
                 if args.ensemble_width is None else args.ensemble_width)
        if width < 1 or args.ensemble % width:
            p.error(f"--ensemble-width {width} must divide --ensemble "
                    f"{args.ensemble}")
        member_cfg = _resolve_member_backend(cfg, width)
    try:
        backend = (resolve_sw_backend(member_cfg, warn=False) if sw else
                   resolve_fft_backend_name(member_cfg.fft_backend,
                                            cfg.grid_shape))
    except (NotImplementedError, ValueError) as e:
        p.error(str(e))
    recipe, src_path = "empty", None
    if args.script:
        recipe, src_path = "script", args.script
    if args.fifo:
        recipe, src_path = "fifo", args.fifo

    if args.fast_transforms:
        print(fast_banner(args, sw, fd, yfirst, backend, width,
                          per_transform(member_cfg, backend)),
              file=sys.stderr)
    device = resolve_device(args.device)
    if args.shard:
        # a no-op unless the XFB_* contract or torchrun's env is set
        initialize_multihost(device=args.device)
        try:
            mesh = shard_mesh(device, args.decomp, mesh_shape)
            check_decomp(cfg, mesh, args.shard_fft, args.decomp)
        except (NotImplementedError, ValueError) as e:
            p.error(str(e))
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    how = {("pallas", "cuda"): "hand-written CUDA kernels",
           ("pallas", "cpu"): "plain torch versions of the CUDA kernels",
           }.get((backend, device.type), "torch.fft library path")
    shard_how = {"xla": "library transposes",
                 "pallas": "all-to-all transpose kernels",
                 "overlap": "fused transpose + x-DFT kernels"}[args.shard_fft]
    if args.shard_fft == "overlap" and args.fast_transforms:
        shard_how = f"fast {shard_how}"
    if args.shard_fft != "xla" and device.type == "cpu":
        shard_how = f"plain torch versions of the {shard_how}"

    print("##### Model setting #####", file=sys.stderr)
    print(f"Initial file          : {cfg.init_file}", file=sys.stderr)
    print(f"Input folder          : {cfg.input_dir}", file=sys.stderr)
    print(f"Output folder         : {cfg.output_dir}", file=sys.stderr)
    print(f"Grid                  : {cfg.nx} x {cfg.ny}", file=sys.stderr)
    print(f"Length X              : {cfg.lx:.3f} [m]", file=sys.stderr)
    print(f"Length Y              : {cfg.ly:.3f} [m]", file=sys.stderr)
    print(f"Time Resolution dt    : {cfg.dt:.3f} [s]", file=sys.stderr)
    print(f"Steps                 : {cfg.total_steps}", file=sys.stderr)
    if args.model == "tracer":
        family = (f"tracer (kappa = {args.tracer_kappa:g} m^2/s, IC "
                  f"{args.tracer_ic})")
    elif sw:
        family = (f"shallow-water (f = {cfg.f:g} 1/s, g = {cfg.gravity:g} "
                  f"m/s^2, H = {cfg.mean_depth:g} m)")
    elif fd:
        family = ("finite-difference (Arakawa Jacobian, FFT Poisson solve "
                  "on torch.fft)")
    else:
        family = "barotropic"
    print(f"Model family          : {family}", file=sys.stderr)
    print(f"Time scheme           : {cfg.time_scheme}", file=sys.stderr)
    print(f"Device                : {where}", file=sys.stderr)
    if width is not None:
        chunks = ("one batched state each" if width > 1
                  and backend == "xla" else "member by member")
        print(f"Ensemble              : {args.ensemble} members, chunks of "
              f"{width} ({chunks}), amplitude {args.ensemble_amp:g}, "
              f"seed {args.ensemble_seed}", file=sys.stderr)
    if args.shard:
        grid = ("x".join(map(str, mesh.shape)) + " mesh, "
                if args.decomp == "pencil" else "")
        where_shards = (f"one per rank, this rank {mesh.rank} on "
                        f"{mesh.device}, " if mesh.distributed else "")
        print(f"Sharding              : {mesh.n_shards} shard(s), "
              f"{where_shards}decomp {args.decomp}, {grid}shard-fft "
              f"{args.shard_fft} ({shard_how})", file=sys.stderr)
    elif not fd:
        print(f"FFT backend           : {backend} ({how})", file=sys.stderr)
        if backend == "pallas" and args.model != "tracer":
            print(f"Transform order       : {'y' if yfirst else 'x'}-first",
                  file=sys.stderr)
        if backend == "pallas" and bt_fusion is not None:
            arm = fusion_arm(etd=cfg.time_scheme == "etdrk4", yfirst=yfirst,
                             **bt_fusion)
            print(f"Fusion arm            : {arm}", file=sys.stderr)
        if backend == "pallas" and sw_form is not None:
            fast = sw_form["fast"]
            split = resolve_split(sw_form["split"], fast)
            parts = (["fast (bf16 tensor-core sub-DFTs)"] if fast else []) + [
                f"split-linear {'on' if split else 'off'}"]
            if yfirst and not per_transform(member_cfg, backend):
                parts.append(f"product store "
                             f"{resolve_pstore(sw_form['pstore'], fast)}")
            print(f"SW formulation        : {', '.join(parts)}",
                  file=sys.stderr)
    print("#########################", file=sys.stderr)

    scope = contextlib.nullcontext()
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile
        scope = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
    with scope as prof:
        result = run(cfg, device, recipe=recipe, src_path=src_path,
                     record=not args.no_record, manifest_path=args.manifest,
                     progress=True, resume_from=args.resume_from,
                     model_kind=args.model, debug_fields=args.debug_fields,
                     step_banners=args.step_banners,
                     record_only=record_only,
                     tracer_kappa=args.tracer_kappa,
                     tracer_ic=args.tracer_ic, yfirst=yfirst,
                     bt_fusion=bt_fusion, shard=args.shard,
                     shard_fft=args.shard_fft, decomp=args.decomp,
                     mesh_shape=mesh_shape, ensemble=args.ensemble,
                     ensemble_amp=args.ensemble_amp,
                     ensemble_seed=args.ensemble_seed,
                     ensemble_width=width, sw_form=sw_form,
                     tracer_fast=(args.model == "tracer"
                                  and args.fast_transforms))
    if args.profile_dir:
        trace = Path(args.profile_dir) / TRACE_NAME
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
        print(f"Profile trace         : {trace}", file=sys.stderr)
    sps = result.steps_run / max(result.wall_time, 1e-9)
    print(f"Ran {result.steps_run} steps in {result.wall_time:.2f}s "
          f"({sps:.1f} steps/s, {sps * cfg.grids:.3e} grid-points/s)",
          file=sys.stderr)
    print("Program ends. Congrats!", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
