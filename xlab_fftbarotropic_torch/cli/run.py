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
-s script / -f fifo forcing, records, checkpoints and resume, and for
the barotropic family the sharded model (--shard, with --shard-fft and
--decomp slab or xpencil; every shard on the one visible card). `--device
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
"""

from __future__ import annotations

import argparse
import os
import sys


def bt_fusion_from_env() -> dict:
    """BarotropicModel.build's fused_rk, fusekb, fusekx and fusetail from
    the environment, read as the JAX package reads them
    (models/barotropic.py:_fused_rk, ops/pallas_fft.py:fusekb_mode,
    fusekx_on, fusetail_on in strict float32). Raises ValueError on an
    XFB_BT_FUSEKB the package does not know."""
    fusekb = os.environ.get("XFB_BT_FUSEKB", "auto")
    if fusekb not in ("auto", "0", "", "half", "full"):
        raise ValueError(f"XFB_BT_FUSEKB={fusekb!r}: expected auto, 0, half "
                         f"or full")
    fusekx = os.environ.get("XFB_BT_FUSEKX", "auto")
    fusetail = os.environ.get("XFB_BT_FUSETAIL", "auto")
    return dict(fused_rk=os.environ.get("XFB_BT_FUSED_RK", "1") != "0",
                fusekb="" if fusekb in ("auto", "0") else fusekb,
                fusekx=fusekx not in ("", "0"),
                fusetail=fusetail not in ("auto", "", "0"))


def main(argv=None):
    import torch

    from ..config import add_config_args, config_from_args
    from ..models.barotropic import (fusion_arm, resolve_device,
                                     resolve_fft_backend_name)
    from ..models.shallow_water import resolve_sw_backend
    from ..parallel import make_mesh
    from ..runner import _NOT_PORTED, run

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
                        "recorded as q_step_N.bin) or shallow-water (sw; "
                        "also records div and h)")
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
                   help="run the sharded model (barotropic only): the "
                        "grid's shards stacked on the one visible card "
                        "(or the CPU with --device cpu), one shard")
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
                        "pencil (not ported yet)")
    p.add_argument("--mesh-shape", default=None, metavar="PxQ",
                   help="2-D mesh shape for --decomp pencil (not ported "
                        "yet)")
    # outside the port so far: accepted only to stop with a clear error
    p.add_argument("--fast-transforms", action="store_true",
                   help="not ported yet")
    p.add_argument("--ensemble", type=int, default=0, help="not ported yet")
    args = p.parse_args(argv)

    if args.fast_transforms:
        p.error("--fast-transforms is not ported yet (ROADMAP.md queue A, "
                "item 4); the port runs the strict float32 mode")
    if args.ensemble:
        p.error("--ensemble is not ported yet (ROADMAP.md queue A, item 3)")
    if args.decomp == "pencil" or args.mesh_shape:
        p.error("--decomp pencil and --mesh-shape (the 2-D pencil "
                "decomposition) are not ported yet (ROADMAP.md queue A, "
                "item 5)")
    if args.shard and args.model not in ("barotropic", "bt"):
        p.error(f"--shard with -m {args.model} is not ported yet "
                f"(ROADMAP.md queue A, item 5): the barotropic family "
                f"shards")
    if args.model in _NOT_PORTED:
        p.error(f"-m {args.model} is not ported yet (ROADMAP.md queue A, "
                f"item {_NOT_PORTED[args.model]})")
    if args.model not in ("barotropic", "bt", "tracer", "shallow-water",
                          "sw"):
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
    sw = args.model in ("shallow-water", "sw")
    yfirst = os.environ.get("XFB_SW_YFIRST" if sw else "XFB_BT_YFIRST",
                            "1") != "0"
    bt_fusion = None
    if args.model in ("barotropic", "bt"):
        try:
            bt_fusion = bt_fusion_from_env()
        except ValueError as e:
            p.error(str(e))
    if sw and cfg.beta != 0.0:
        p.error("--beta: the beta-plane is barotropic/tracer-only")
    try:
        backend = (resolve_sw_backend(cfg, warn=False) if sw else
                   resolve_fft_backend_name(cfg.fft_backend, cfg.grid_shape))
    except (NotImplementedError, ValueError) as e:
        p.error(str(e))
    recipe, src_path = "empty", None
    if args.script:
        recipe, src_path = "script", args.script
    if args.fifo:
        recipe, src_path = "fifo", args.fifo

    device = resolve_device(args.device)
    if args.shard:
        try:
            n_shards = make_mesh(None, device).n_shards
        except NotImplementedError as e:
            p.error(str(e))
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    how = {("pallas", "cuda"): "hand-written CUDA kernels",
           ("pallas", "cpu"): "plain torch versions of the CUDA kernels",
           }.get((backend, device.type), "torch.fft library path")
    shard_how = {"xla": "library transposes",
                 "pallas": "all-to-all transpose kernels",
                 "overlap": "fused transpose + x-DFT kernels"}[args.shard_fft]
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
    else:
        family = "barotropic"
    print(f"Model family          : {family}", file=sys.stderr)
    print(f"Time scheme           : {cfg.time_scheme}", file=sys.stderr)
    print(f"Device                : {where}", file=sys.stderr)
    if args.shard:
        print(f"Sharding              : {n_shards} shard(s), decomp "
              f"{args.decomp}, shard-fft {args.shard_fft} ({shard_how})",
              file=sys.stderr)
    else:
        print(f"FFT backend           : {backend} ({how})", file=sys.stderr)
        if backend == "pallas" and args.model != "tracer":
            print(f"Transform order       : {'y' if yfirst else 'x'}-first",
                  file=sys.stderr)
        if backend == "pallas" and bt_fusion is not None and yfirst:
            arm = fusion_arm(etd=cfg.time_scheme == "etdrk4", **bt_fusion)
            print(f"Fusion arm            : {arm}", file=sys.stderr)
    print("#########################", file=sys.stderr)

    result = run(cfg, device, recipe=recipe, src_path=src_path,
                 record=not args.no_record, manifest_path=args.manifest,
                 progress=True, resume_from=args.resume_from,
                 model_kind=args.model, debug_fields=args.debug_fields,
                 step_banners=args.step_banners, record_only=record_only,
                 tracer_kappa=args.tracer_kappa, tracer_ic=args.tracer_ic,
                 yfirst=yfirst, bt_fusion=bt_fusion, shard=args.shard,
                 shard_fft=args.shard_fft, decomp=args.decomp)
    sps = result.steps_run / max(result.wall_time, 1e-9)
    print(f"Ran {result.steps_run} steps in {result.wall_time:.2f}s "
          f"({sps:.1f} steps/s, {sps * cfg.grids:.3e} grid-points/s)",
          file=sys.stderr)
    print("Program ends. Congrats!", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
