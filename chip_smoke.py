#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--n 4096] [--steps 20] [--json PATH]

Run it from the root of a checkout; it needs one CUDA device and nvcc,
and no jax. Phases, each of which raises on failure (the script then
exits non-zero and prints no result):

1. Toolchain: the card's name and power limit, the torch, CUDA and nvcc
   versions; a fresh build of the four kernels from csrc/, timed.
2. Kernels: each CUDA kernel against its plain torch version on the card,
   on numpy-seeded inputs at 256^2 and n^2, max error over max |plain|
   <= 1e-5 per output field (radix-2 float32 sums in another order than
   cuFFT's, with an error that grows with log2 n); each timed at n^2
   with CUDA events.
3. Main path: the gaussian IC at n^2 (bench.py's barotropic config)
   through the CLI entry point, xlab_fftbarotropic_torch.cli.run.main,
   for `steps` steps with vort recorded every steps/2. The records exist
   with n^2 float32 values each and are finite, the launch counters are
   exactly 4 stages x steps (kb_pair twice that), and no jax module is
   loaded.
4. No library transform on the kernel path: torch.fft.* and torch.matmul
   raise while a segment runs.
5. Trajectory: `steps` steps with the kernels and with the torch.fft
   library path on the card; rel-L2 of the physical vorticity <= 1e-5.
6. Time: ms/step and grid-points/s of both paths from CUDA events after a
   warm-up, in turns (kernels, library, library, kernels), with the peak
   device memory of each.

The last three lines of stdout: the per-kernel JSON ({"kernels": [...]}),
the card's name and power limit as nvidia-smi gives them, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
TOL = 1e-5
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "ka_diag": ("xlab_fftbarotropic_torch/csrc/ka_diag.cu",
                "xlab_fftbarotropic_tpu/ops/pallas_fft.py:694"),
    "kb_pair": ("xlab_fftbarotropic_torch/csrc/kb_pair.cu",
                "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1049"),
    "ky_adv": ("xlab_fftbarotropic_torch/csrc/ky_adv.cu",
               "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1506"),
    "kx_visc": ("xlab_fftbarotropic_torch/csrc/kx_visc.cu",
                "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1654"),
}


class SmokeError(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeError(what)


def log(*args) -> None:
    print(*args, flush=True)


def import_port():
    """The port from this checkout, never from elsewhere."""
    sys.path.insert(0, str(HERE))
    import xlab_fftbarotropic_torch as port
    check(Path(port.__file__).resolve().parent.parent == HERE,
          f"the port imported from {port.__file__}, not from {HERE}")
    return port


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases(n: int, dev, seed: int):
    """name -> (kernel call, plain call, output fields) on numpy-seeded
    inputs at the main path's shapes for an n x n grid."""
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.ops.spectral import SpectralTables

    rng = np.random.default_rng(seed)
    hny = n // 2 + 1

    def planes(shape, k):
        return [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) for _ in range(k)]

    t = SpectralTables.build(n, n, 600_000.0, 600_000.0, device=dev)
    zr, zi = planes((n, hny), 2)
    wr, wi = planes((4, hny, n), 2)
    u, zx, v, zy, src = planes((n, n), 5)
    fr, fi, zsr, zsi = planes((n, hny), 4)
    lap = t.lap / t.lap.abs().max()       # order-one viscous term
    scale = 1.0 / (n * n)

    def stacked(out):                     # per field of the (4, ...) stack
        return [p[f] for p in out for f in range(4)]

    return {
        "ka_diag": (lambda: ff.ka_diag(zr, zi, t.rlap, t.kx, t.ky),
                    lambda: ff.ka_diag_plain(zr, zi, t.rlap, t.kx, t.ky),
                    stacked),
        "kb_pair": (lambda: ff.kb_pair(wr, wi, 2, 3, scale),
                    lambda: ff.kb_pair_plain(wr, wi, 2, 3, scale), list),
        "ky_adv": (lambda: ff.ky_adv(u, zx, v, zy, src, 0.3),
                   lambda: ff.ky_adv_plain(u, zx, v, zy, src, 0.3), list),
        "kx_visc": (lambda: ff.kx_visc(fr, fi, lap, t.mask, zsr, zsi, 6.5),
                    lambda: ff.kx_visc_plain(fr, fi, lap, t.mask, zsr, zsi,
                                             6.5), list),
    }


def phase_kernels(n: int, dev) -> dict:
    report = {}
    for size in (256, n):
        for name, (kern, plain, fields) in kernel_cases(size, dev,
                                                        size).items():
            got, want = fields(kern()), fields(plain())
            torch.cuda.synchronize()
            rel = max(float((g - w).abs().max() / w.abs().max())
                      for g, w in zip(got, want))
            abs_err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
            log(f"kernel {name:8s} {size}^2: max err / max|plain| = "
                f"{rel:.3e} (max abs err {abs_err:.3e})")
            check(rel <= TOL, f"{name} at {size}^2 disagrees with its "
                              f"plain version: {rel:.3e} > {TOL}")
            if size == n:
                ms = cuda_ms(kern)
                plain_ms = cuda_ms(plain)
                log(f"kernel {name:8s} {size}^2: {ms:.4f} ms, plain "
                    f"torch.fft version {plain_ms:.4f} ms")
                report[name] = dict(max_abs_err=abs_err, rel_err=rel,
                                    ms=ms, plain_ms=plain_ms)
    return report


def phase_main_path(n: int, steps: int) -> dict:
    from xlab_fftbarotropic_torch.cli import run as cli_run
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.reused import (ModelConfig, makefields,
                                                 read_field, write_field)

    cfg = ModelConfig(nx=n, ny=n)
    rec = steps // 2
    with tempfile.TemporaryDirectory(prefix="xfb_smoke_") as tmp:
        inp, out = Path(tmp) / "input", Path(tmp) / "output"
        inp.mkdir()
        write_field(inp / cfg.init_file, makefields.gaussian(cfg))
        argv = ["-I", str(inp), "-O", str(out), "--nx", str(n), "--ny",
                str(n), "--total-steps", str(steps), "--record-step",
                str(rec), "--record-fields", "vort", "--manifest",
                str(Path(tmp) / "log"), "--device", "cuda"]
        ff.reset_launches()
        t0 = time.perf_counter()
        rc = cli_run.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(ff.LAUNCHES)
        check(rc == 0, f"cli.run.main returned {rc}")
        # the run loop records at the top of each step, so a run of
        # `steps` steps records steps 0 and steps/2 (as the reference)
        for s in (0, rec):
            f = out / f"vort_step_{s}.bin"
            check(f.exists() and f.stat().st_size == n * n * 4,
                  f"record {f.name} missing or of the wrong size")
            check(bool(np.isfinite(read_field(f, cfg.grid_shape)).all()),
                  f"record {f.name} is not finite")
        lines = (Path(tmp) / "log").read_text().splitlines()
        check(len(lines) == 2, f"manifest has {len(lines)} lines, not 2")
    want = {"ka_diag": 4 * steps, "kb_pair": 8 * steps,
            "ky_adv": 4 * steps, "kx_visc": 4 * steps}
    log(f"main path: {steps} steps at {n}^2 through cli.run.main in "
        f"{wall:.2f} s (set-up and records included); launches {launches}")
    check(launches == want, f"launch counts {launches} != {want}")
    check("jax" not in sys.modules, "a jax module was imported")
    return dict(launches=launches, cli_wall_s=wall)


def phase_no_library(n: int, dev) -> None:
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.reused import ModelConfig, makefields

    cfg = ModelConfig(nx=n, ny=n)
    m = BarotropicModel.build(cfg, dev)
    check(m.backend == "pallas", f"backend {m.backend}, not pallas")
    z0, src = m.init_state(makefields.gaussian(cfg)), m.zero_source()

    def refuse(*args, **kwargs):
        raise SmokeError("a library transform ran inside the kernel path")

    names = [k for k in dir(torch.fft)
             if not k.startswith("_") and callable(getattr(torch.fft, k))]
    saved = {k: getattr(torch.fft, k) for k in names}
    saved_matmul = torch.matmul
    try:
        for k in names:
            setattr(torch.fft, k, refuse)
        torch.matmul = refuse
        z = m.segment(z0, src, 2)
        torch.cuda.synchronize()
    finally:
        for k, fn in saved.items():
            setattr(torch.fft, k, fn)
        torch.matmul = saved_matmul
    check(bool(torch.isfinite(torch.view_as_real(z)).all()),
          "kernel-path state not finite")
    log(f"no library transform: 2 steps at {n}^2 ran with torch.fft.* and "
        f"torch.matmul raising")


def phase_trajectory_and_time(n: int, steps: int, dev) -> dict:
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.reused import ModelConfig, makefields

    cfg = ModelConfig(nx=n, ny=n)
    models = {"kernels": BarotropicModel.build(cfg, dev),
              "library": BarotropicModel.build(
                  cfg.replace(fft_backend="xla"), dev)}
    check(models["kernels"].backend == "pallas"
          and models["library"].backend == "xla", "backend selection")
    m0 = models["kernels"]
    z0, src = m0.init_state(makefields.gaussian(cfg)), m0.zero_source()

    vort = {k: m.diags(m.segment(z0, src, steps)).vort
            for k, m in models.items()}
    for k, v in vort.items():
        check(bool(torch.isfinite(v).all()), f"{k} vorticity not finite")
    rel = float(torch.linalg.vector_norm(vort["kernels"] - vort["library"])
                / torch.linalg.vector_norm(vort["library"]))
    log(f"trajectory: {steps} steps at {n}^2, rel-L2 of the vorticity, "
        f"kernels vs torch.fft library path = {rel:.3e}")
    check(rel <= TOL, f"trajectory rel-L2 {rel:.3e} > {TOL}")

    times = {k: [] for k in models}
    peak = {}
    for k in ("kernels", "library", "library", "kernels"):
        m = models[k]
        m.segment(z0, src, 2)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m.segment(z0, src, steps)
        end.record()
        end.synchronize()
        times[k].append(start.elapsed_time(end) / steps)
        peak[k] = torch.cuda.max_memory_allocated(dev)
    out = dict(trajectory_rel_l2=rel)
    for k, ts in times.items():
        ms = sum(ts) / len(ts)
        out[k] = dict(ms_per_step=ms, runs_ms=ts,
                      gp_per_s=n * n / (ms * 1e-3), peak_bytes=peak[k])
        runs = ", ".join(f"{t:.3f}" for t in ts)
        log(f"time {k:8s}: {ms:.3f} ms/step ({runs}), "
            f"{n * n / (ms * 1e-3):.4e} grid-points/s, peak device "
            f"memory {peak[k] / 2**20:.1f} MiB")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096,
                    help="grid size of the main path (default 4096)")
    ap.add_argument("--steps", type=int, default=20,
                    help="steps of the main path and trajectory (even)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the full report as JSON to PATH")
    args = ap.parse_args(argv)
    check(args.steps >= 2 and args.steps % 2 == 0, "--steps must be even")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device visible (torch.cuda."
                 "is_available() is False)")
    import_port()
    from xlab_fftbarotropic_torch.ops import _build

    dev = torch.device("cuda", torch.cuda.current_device())
    smi = nvidia_smi()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    nvcc_version = subprocess.run([_build.nvcc(), "--version"],
                                  capture_output=True, text=True,
                                  check=True, timeout=60).stdout
    log(f"nvcc: {nvcc_version.strip().splitlines()[-1]}")
    shutil.rmtree(_build.BUILD_ROOT / _build.source_hash(),
                  ignore_errors=True)
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    check(_build.LAST_BUILD.get("compiled") is True, "kernels not rebuilt")
    log(f"kernels built from csrc/ in {build_s:.2f} s")

    report = dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
                  nvcc=nvcc_version.strip().splitlines()[-1],
                  build_s=build_s, n=args.n, steps=args.steps)
    report["kernels"] = phase_kernels(args.n, dev)
    report["main_path"] = phase_main_path(args.n, args.steps)
    phase_no_library(args.n, dev)
    report["paths"] = phase_trajectory_and_time(args.n, args.steps, dev)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))

    launches = report["main_path"]["launches"]
    rows = [dict(name=name, route="cuda", source=src, replaces=rep,
                 launches=launches[name],
                 max_abs_err=report["kernels"][name]["max_abs_err"],
                 ms=report["kernels"][name]["ms"],
                 plain_ms=report["kernels"][name]["plain_ms"])
            for name, (src, rep) in KERNELS.items()]
    check(all(math.isfinite(r["ms"]) for r in rows), "kernel times")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
