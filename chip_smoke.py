#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--n 4096] [--steps 20] [--json PATH] [--profile]

Run it from the root of a checkout; it needs one CUDA device and nvcc,
and no jax. Phases, each of which raises on failure (the script then
exits non-zero and prints no result):

1. Toolchain: the card's name and power limit, the torch, CUDA and nvcc
   versions; a fresh build of every kernel from csrc/, timed.
2. Kernels: each CUDA kernel against its plain torch version on the card,
   on numpy-seeded inputs at 256^2 and n^2, max error over max |plain|
   <= 1e-5 per output field (radix-2 float32 sums in another order than
   cuFFT's, with an error that grows with log2 n; the transposes, copies,
   exactly), the distributed ones on 4 shards and at 256^2 on 1, 2 and
   8 too; each timed at n^2 with CUDA events. First the column-tile
   plan (ops/xtile.py: columns per tile C, blocks per cluster K,
   threads, shared bytes) of the x-stages of kx_visc.cu and xstage.cu,
   ka_kernel (ka_kc.cu, on ny and hny columns), ka_fields_kernel
   (ka_diag.cu: ka_diag, ka6, ka_quad), ka_sw_kernel (ka_sw.cu, on hny),
   ka_adv_kernel and ka_fwd_kernel (ka_kc.cu, on ny) and of the y-stages
   kc_kernel (ka_kc.cu: kc, kc_sw, kc_visc), kb_kernel (kb_pair.cu: kb,
   the x-major kb), kb_pair_kernel, ky_adv_kernel, ky_all_kernel,
   kb_adv_kernel (half and full) and kb_adv_tracer_kernel (in tiles of
   C/2 columns) at 256^2 and n^2, and every kernel's registers and
   spills from the build's
   -Xptxas -v; then the pins at 256^2 and n^2, bit for bit: the y-first
   pair's (kb_pair equal to kb_stacked transposed and ky_adv to kc of
   (adv, 0)) and the ka x-stages' (ka_quad's fields 0-1 equal to
   ka_diag's, split to quad, ka6 to ka_diag of each state, ka of (-(zi
   kx), zr kx) at scale 1 to ka_diag's field 0, ka_adv to ka's real
   forward of the advection formed in torch, beta 0 and not) and the SW
   stages' (ka_sw's four fields equal to ka of sw_fields formed in
   torch, zeta to ka of (zr, zi), eta_s to ka of (er, ei) at scale
   eta_scale; ka_fwd's five products, split off and on, to ka's real
   forward of sw_products formed in torch, and ky_all's to kc of
   (sw_products, 0)) and kb_adv_tracer's (its zeta plane equal to ky_adv
   of kb_pair's u, v and the zeta gradients, src given and not, its q
   plane to ky_adv of the q gradients and a zero src).
3. Barotropic main path: the gaussian IC at n^2 (bench.py's barotropic
   config) through the CLI entry point, xlab_fftbarotropic_torch.cli.run
   .main, for `steps` steps with vort recorded every steps/2, in the
   fused-RK form. The records exist with n^2 float32 values each and are
   finite, the launch counters are exactly 4 stages x steps (kb_pair
   twice that) and one rk4_combine per step, and no jax module is loaded.
4. Tracer main path: bench.py's tracer config (n^2, kappa = 50, gaussian
   vorticity and tracer, zero forcing) through the same entry point with
   -m tracer, vort and q recorded; per step exactly 4 ka6, 8 kb_pair,
   4 kb_adv_tracer, 4 kx_visc and 1 rk4_combine launches.
5. Shallow-water main path: bench.py's SW config (n^2, the gaussian
   vortex with zeta0 = 1e-5, geostrophically balanced, dt = the RK4
   gravity-wave bound) through the same entry point with -m sw, vort,
   div and h recorded; per step exactly 4 ka_sw, 8 kb_pair, 4 ky_all,
   4 kx_fwd, 4 sw_combine and 1 rk4_combine launches, and per segment
   1 ka and 1 kc (the forcing spectrum of the runner's zero forcing).
5b. Shallow-water ETDRK4 main path: bench.py's sw-etdrk4 config (the
   same vortex, dt = 7.5 s, 8.85 times the RK4 bound at 4096^2) with
   -m sw --time-scheme etdrk4, the phi-tables built on the card through
   the disk cache (XFB_ETD_CACHE in a temporary directory); per step
   exactly 4 ka_sw, 8 kb_pair, 4 ky_all, 4 kx_fwd and 4 sw_combine_mv
   launches, none of sw_combine or rk4_combine, and per segment 1 ka and
   1 kc.
5c. Shallow-water RK4 with drag and hyperviscosity: the SW configuration
   with --r-drag 2e-4 --nu4 (example 12's) and dt under both RK4 bounds
   (the gravity-wave one, 0.847 s at 4096^2, and 0.9 s, under the 1 s
   viscous bound of that nu4) through the same entry point,
   on the per-transform kernels; per step exactly 40 ka, 8 kb and 24 kc
   launches (4 stages x two inverse pairs and six forward transforms,
   the runner's zero forcing among them) and nothing else.
5d. Shallow-water unfused RK4 form: ShallowWaterModel.build(...,
   fused_rk=False).segment for `steps` steps; per step the plane
   stepper's kernels with sw_combine unfused and 3 plane_axpy launches.
5e. Adjoint: the 4DVar twin experiment (the gaussian truth rolled out a
   10-step window, first guess 0.9 x truth) through
   xlab_fftbarotropic_torch.cli.assimilate.main --device cuda for a few
   Adam iterations at lr 1e-5: the launch counts of both sweeps exactly
   (the checkpointed forward runs twice), the cost falling; the
   kernel-path gradient against the torch.fft path's, rel-L2 <= 5e-4
   (the JAX package's bar between its pallas and xla gradients), with
   torch.fft.* and torch.matmul raising during the kernel path's loss
   and backward(); the forward ms/step, the gradient's ms per window
   step and its peak device memory on both paths.
5f. ETD tables: the build time on the card of the SW, barotropic and
   tracer tables at n^2 with the cache off, and the card-built tables
   against the CPU-built ones at 256^2 (max |d| <= 1e-6 of each table's
   max).
5g. The x-first order through the CLI: phase 3 with XFB_BT_YFIRST=0 (per
   step 4 ka_diag, 8 kb, 4 ka_adv, 4 kc_visc and nothing else: the
   stage updates are torch), phases 5 and 5b with XFB_SW_YFIRST=0 (two
   kb, ka_fwd and kc_sw in place of the two kb_pair, ky_all and kx_fwd).
5h. Barotropic QUAD_MODE "quad" and "split": BarotropicModel.build(...,
   quad_mode=...).segment for `steps` steps (the x-first order with the
   psi-first x-stage); per step 4 ka_quad (8 in split), 8 kb, 4 ka_adv
   and 4 kc_visc launches and nothing else.
5i. The barotropic y-first fusion arms through the CLI, under the JAX
   package's switches: XFB_BT_FUSEKB=full (kb_adv_full in place of two
   kb_pair and ky_adv) and =half (one kb_pair and kb_adv_half),
   XFB_BT_FUSEKX=0 (kx_fwd + visc in place of kx_visc),
   XFB_BT_FUSETAIL=1 alone and with full (stage 4's kx_visc_tail in
   place of rk4_combine), XFB_BT_FUSED_RK=0 with FUSEKX=0, and
   --time-scheme etdrk4 with full and with FUSEKX=0; each with its exact
   launches per step (PER_STEP).
5j. The sharded barotropic model (parallel/model.py): through the CLI
   on one shard (--shard, the one card) for --shard-fft pallas and
   overlap x --decomp slab and xpencil, the gaussian IC, records finite,
   launches exact per step and per record (SHARD_PER_STEP,
   SHARD_PER_RECORD: the a2a transposes, xstage, or its gather and
   scatter halves); and through ShardedBarotropicModel.build(cfg,
   make_mesh(4, dev), ...) on four shards at n^2 for `steps` steps,
   every decomp x impl under RK4 and slab/overlap under ETDRK4 (example
   12's nu4, dt = 3 s), with the library transposes and the kernels'
   plain twins raising in the pallas and overlap segments (and every
   torch.fft function but rfft/irfft, and fft/ifft on pallas): exact
   launches, vorticity within rel-L2 1e-5 of the single-device torch.fft
   path, pallas equal to xla bit for bit, ms/step of each beside the
   library path and FUSEKB=full with FUSEKX=0 (and with --profile the
   four kernel paths' breakdowns).
6. No library transform on the kernel paths: torch.fft.* and torch.matmul
   raise while a barotropic, a tracer and a shallow-water segment run,
   the three families' ETDRK4 segments, the SW drag segment, the
   x-first paths (barotropic RK4, ETDRK4, quad and split; SW RK4 and
   ETDRK4) and the barotropic fusion arms (RK4 and ETDRK4).
7. Barotropic trajectory: `steps` steps with the kernels (fused-RK and
   unfused forms, the x-first order, quad and split, the fusion arms)
   and with the torch.fft library path on the card; rel-L2 of the
   physical vorticity <= 1e-5 against the library path, between the two
   forms, of each x-first form against the y-first kernel path and of
   quad and split against the x-first ka_diag form; each fusion arm's
   state equal to the default arm's bit for bit.
8. Tracer trajectory: `steps` steps, kernels against the library path;
   rel-L2 of the physical vorticity and of q <= 1e-5.
9. Shallow-water trajectory, RK4 (with and without drag) and ETDRK4:
   kernels against the library path (and the unfused forms against the
   fused ones, the x-first order against the y-first one) after one step
   and after `steps` steps; max abs error of
   vort, div and eta = h - H over the JAX package's norms (div over
   max(|div|, |vort|)) <= 1e-5 and <= 2e-4, its bars for its two SW
   paths; the rel-L2 of each field is reported.
9b. Barotropic ETDRK4 (dt = 3 s with the hyperviscosity of example 12,
   three times RK4's viscous bound) and tracer ETDRK4 (kappa = 50):
   kernels against the library path, rel-L2 <= 1e-5 after `steps`,
   barotropic ETDRK4 x-first against it and the y-first kernel path, and
   the ETDRK4 fusion arms (full, FUSEKX=0) bit for bit against the
   default arm.
10. Time: ms/step and grid-points/s of every path from CUDA events after
   a warm-up, in turns, with the peak device memory of each.
11. With --profile: torch.profiler traces of the barotropic (default
   and FUSEKB=full), tracer (RK4 and ETDRK4), SW RK4 and SW ETDRK4
   y-first kernel paths
   (the column-tile kx_visc and kx_fwd), the SW drag, the x-first
   barotropic and SW RK4 paths (the column-tile kc, kc_visc, kc_sw and
   kb), the adjoint gradient (per window step, phase 5e), and (phase 5j)
   the four sharded kernel paths (xstage on the overlap ones), device
   time per step by kernel and the device's busy share.

The last three lines of stdout: the per-kernel JSON ({"kernels": [...]}
with each kernel's launches on the main paths, its max abs error
against its plain version, its time, its plain version's, its bound (the
bytes it must move over 3.35 TB/s, or its FFT flops over 67 TFLOP/s
float32, whichever is larger) and the time of the one torch call that
computes the same function, where there is one), the card's name and
power limit as nvidia-smi gives them, and {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
TOL = 1e-5
# the card's published peaks (H100 SXM data sheet, at a 700 W limit):
# HBM bytes/s and float32 FLOP/s outside the tensor cores
HBM_BYTES_S, FP32_FLOP_S = 3.35e12, 67e12
# bench.py's sw-etdrk4 time step at 4096^2 (8.85 times the RK4 bound)
SW_ETD_DT = 7.5
# row name: (source, the TPU kernel it replaces, LAUNCHES key, paths)
XFIRST_BT = ("barotropic-xfirst", "bt-quad", "bt-split")
XFIRST_SW = ("sw-xfirst", "sw-xfirst-etdrk4")
# the barotropic fusion arms' CLI paths, by the kernel they swap in
BT_FULL = ("bt-fusekb-full", "bt-full-tail", "bt-etdrk4-full")
BT_FUSEKX0 = ("bt-fusekx0", "bt-unfused-fusekx0", "bt-etdrk4-fusekx0")
BT_TAIL = ("bt-fusetail", "bt-full-tail")
# the sharded barotropic paths: through the CLI on one shard
# (shard-<decomp>-<impl>) and through ShardedBarotropicModel.build on
# four (shard4-<decomp>-<impl>, and slab/overlap under ETDRK4)
SHARD_DECOMPS, SHARD_IMPLS = ("slab", "xpencil"), ("xla", "pallas", "overlap")
SHARD_CLI = tuple(f"shard-{d}-{i}" for d in SHARD_DECOMPS
                  for i in SHARD_IMPLS[1:])
SHARD_MODELS = tuple(f"shard4-{d}-{i}" for d in SHARD_DECOMPS
                     for i in SHARD_IMPLS) + ("shard4-slab-overlap-etdrk4",)
SHARD_PALLAS = ("shard-slab-pallas", "shard-xpencil-pallas",
                "shard4-slab-pallas", "shard4-xpencil-pallas")
# the kernels of each sharded path, per step (4 stages of 4 unpaired
# inverse transforms and 1 forward) and per record (the 4 inverses of
# the record's diagnostics)
SHARD_PER_STEP = {("slab", "pallas"): {"a2a_cols": 20, "a2a_rows": 20},
                  ("slab", "overlap"): {"xstage": 20},
                  ("xpencil", "pallas"): {"a2a_cols": 4, "a2a_rows": 16},
                  ("xpencil", "overlap"): {"xstage_gather": 4,
                                           "xstage_scatter": 16}}
SHARD_PER_RECORD = {("slab", "pallas"): {"a2a_cols": 4, "a2a_rows": 4},
                    ("slab", "overlap"): {"xstage": 4},
                    ("xpencil", "pallas"): {"a2a_rows": 4},
                    ("xpencil", "overlap"): {"xstage_scatter": 4}}
KERNELS = {
    "ka_diag": ("xlab_fftbarotropic_torch/csrc/ka_diag.cu",
                "xlab_fftbarotropic_tpu/ops/pallas_fft.py:694",
                "ka_diag", ("barotropic", "barotropic-xfirst")),
    "kb_pair": ("xlab_fftbarotropic_torch/csrc/kb_pair.cu",
                "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1049",
                "kb_pair", ("barotropic", "tracer", "shallow-water",
                            "sw-etdrk4")),
    "ky_adv": ("xlab_fftbarotropic_torch/csrc/ky_adv.cu",
               "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1506",
               "ky_adv", ("barotropic",)),
    "kx_visc": ("xlab_fftbarotropic_torch/csrc/kx_visc.cu",
                "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1654",
                "kx_visc", ("barotropic",)),
    "kx_visc_tracer": ("xlab_fftbarotropic_torch/csrc/kx_visc.cu",
                       "xlab_fftbarotropic_tpu/ops/pallas_tracer.py:206",
                       "kx_visc", ("tracer",)),
    "ka6": ("xlab_fftbarotropic_torch/csrc/ka_diag.cu",
            "xlab_fftbarotropic_tpu/ops/pallas_tracer.py:57",
            "ka6", ("tracer",)),
    "kb_adv_tracer": ("xlab_fftbarotropic_torch/csrc/kb_adv_tracer.cu",
                      "xlab_fftbarotropic_tpu/ops/pallas_tracer.py:132",
                      "kb_adv_tracer", ("tracer",)),
    "rk4_combine": ("xlab_fftbarotropic_torch/csrc/rk4_combine.cu",
                    "xlab_fftbarotropic_tpu/ops/pallas_sw.py:971",
                    "rk4_combine", ("barotropic", "tracer", "shallow-water",
                                    "sw-xfirst")),
    "ka_sw": ("xlab_fftbarotropic_torch/csrc/ka_sw.cu",
              "xlab_fftbarotropic_tpu/ops/pallas_sw.py:217",
              "ka_sw", ("shallow-water", "sw-etdrk4") + XFIRST_SW),
    "ky_all": ("xlab_fftbarotropic_torch/csrc/ky_all.cu",
               "xlab_fftbarotropic_tpu/ops/pallas_sw.py:533",
               "ky_all", ("shallow-water", "sw-etdrk4")),
    "kx_fwd": ("xlab_fftbarotropic_torch/csrc/kx_visc.cu",
               "xlab_fftbarotropic_tpu/ops/pallas_sw.py:565",
               "kx_fwd", ("shallow-water", "sw-etdrk4")),
    "sw_combine": ("xlab_fftbarotropic_torch/csrc/sw_combine.cu",
                   "xlab_fftbarotropic_tpu/ops/pallas_sw.py:679",
                   "sw_combine", ("shallow-water", "sw-xfirst")),
    "sw_combine_mv": ("xlab_fftbarotropic_torch/csrc/sw_combine.cu",
                      "xlab_fftbarotropic_tpu/ops/pallas_sw.py:693",
                      "sw_combine_mv", ("sw-etdrk4", "sw-xfirst-etdrk4")),
    "ka": ("xlab_fftbarotropic_torch/csrc/ka_kc.cu",
           "xlab_fftbarotropic_tpu/ops/pallas_fft.py:549",
           "ka", ("shallow-water", "sw-etdrk4", "sw-drag", "adjoint")
           + XFIRST_SW),
    "kc": ("xlab_fftbarotropic_torch/csrc/ka_kc.cu",
           "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1349",
           "kc", ("shallow-water", "sw-etdrk4", "sw-drag", "adjoint")
           + XFIRST_SW),
    "kb": ("xlab_fftbarotropic_torch/csrc/kb_pair.cu",
           "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1043",
           "kb", ("sw-drag", "adjoint")),
    "plane_axpy": ("xlab_fftbarotropic_torch/csrc/rk4_combine.cu",
                   "xlab_fftbarotropic_tpu/ops/pallas_sw.py:946",
                   "plane_axpy", ("sw-unfused",)),
    # the x-first order (row 2's x-major form, rows 11, 15, 17d)
    "kb_xmajor": ("xlab_fftbarotropic_torch/csrc/kb_pair.cu",
                  "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1049",
                  "kb", XFIRST_BT + XFIRST_SW),
    "ka_adv": ("xlab_fftbarotropic_torch/csrc/ka_kc.cu",
               "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1391",
               "ka_adv", XFIRST_BT),
    "kc_visc": ("xlab_fftbarotropic_torch/csrc/ka_kc.cu",
                "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1412",
                "kc_visc", XFIRST_BT),
    "ka_quad": ("xlab_fftbarotropic_torch/csrc/ka_diag.cu",
                "xlab_fftbarotropic_tpu/ops/pallas_fft.py:605",
                "ka_quad", ("bt-quad",)),
    "ka_quad_split": ("xlab_fftbarotropic_torch/csrc/ka_diag.cu",
                      "xlab_fftbarotropic_tpu/ops/pallas_fft.py:629",
                      "ka_quad", ("bt-split",)),
    "ka_fwd": ("xlab_fftbarotropic_torch/csrc/ka_kc.cu",
               "xlab_fftbarotropic_tpu/ops/pallas_sw.py:450",
               "ka_fwd", XFIRST_SW),
    "kc_sw": ("xlab_fftbarotropic_torch/csrc/ka_kc.cu",
              "xlab_fftbarotropic_tpu/ops/pallas_sw.py:581",
              "kc_sw", XFIRST_SW),
    # the barotropic fusion arms (rows 5, 6, 9, 10)
    "kb_adv_full": ("xlab_fftbarotropic_torch/csrc/kb_adv.cu",
                    "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1158",
                    "kb_adv_full", BT_FULL),
    "kb_adv_half": ("xlab_fftbarotropic_torch/csrc/kb_adv.cu",
                    "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1179",
                    "kb_adv_half", ("bt-fusekb-half",)),
    "kx_visc_tail": ("xlab_fftbarotropic_torch/csrc/kx_visc.cu",
                     "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1677",
                     "kx_visc_tail", BT_TAIL),
    "kx_fwd_bt": ("xlab_fftbarotropic_torch/csrc/kx_visc.cu",
                  "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1521",
                  "kx_fwd", BT_FUSEKX0),
    "visc": ("xlab_fftbarotropic_torch/csrc/visc.cu",
             "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1544",
             "visc", BT_FUSEKX0),
    "visc_axpy": ("xlab_fftbarotropic_torch/csrc/visc.cu",
                  "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1551",
                  "visc", ("bt-fusekx0",)),
    # the distributed path (rows 21-23): the CLI's one-shard runs and the
    # four-shard model runs
    "a2a_cols": ("xlab_fftbarotropic_torch/csrc/a2a.cu",
                 "xlab_fftbarotropic_tpu/parallel/pallas_transpose.py:39",
                 "a2a_cols", SHARD_PALLAS),
    "a2a_rows": ("xlab_fftbarotropic_torch/csrc/a2a.cu",
                 "xlab_fftbarotropic_tpu/parallel/pallas_transpose.py:78",
                 "a2a_rows", SHARD_PALLAS),
    "xstage": ("xlab_fftbarotropic_torch/csrc/xstage.cu",
               "xlab_fftbarotropic_tpu/parallel/pallas_overlap.py:61",
               "xstage", ("shard-slab-overlap", "shard4-slab-overlap",
                          "shard4-slab-overlap-etdrk4")),
    "xstage_gather": ("xlab_fftbarotropic_torch/csrc/xstage.cu",
                      "xlab_fftbarotropic_tpu/parallel/pallas_overlap.py:148",
                      "xstage_gather", ("shard-xpencil-overlap",
                                        "shard4-xpencil-overlap")),
    "xstage_scatter": ("xlab_fftbarotropic_torch/csrc/xstage.cu",
                       "xlab_fftbarotropic_tpu/parallel/pallas_overlap.py:212",
                       "xstage_scatter", ("shard-xpencil-overlap",
                                          "shard4-xpencil-overlap")),
}
# expected launches per step on each main path (every other kernel: 0)
PER_STEP = {
    "barotropic": {"ka_diag": 4, "kb_pair": 8, "ky_adv": 4, "kx_visc": 4,
                   "rk4_combine": 1},
    "tracer": {"kb_pair": 8, "kx_visc": 4, "ka6": 4, "kb_adv_tracer": 4,
               "rk4_combine": 1},
    "shallow-water": {"ka_sw": 4, "kb_pair": 8, "ky_all": 4, "kx_fwd": 4,
                      "sw_combine": 4, "rk4_combine": 1},
    "sw-etdrk4": {"ka_sw": 4, "kb_pair": 8, "ky_all": 4, "kx_fwd": 4,
                  "sw_combine_mv": 4},
    # per stage two inverse_pair (2 ka + kb each) and six rfft2 (ka + kc)
    "sw-drag": {"ka": 40, "kb": 8, "kc": 24},
    "sw-unfused": {"ka_sw": 4, "kb_pair": 8, "ky_all": 4, "kx_fwd": 4,
                   "sw_combine": 4, "plane_axpy": 3, "rk4_combine": 1},
    # the x-first order: the stage updates are torch elementwise
    "barotropic-xfirst": {"ka_diag": 4, "kb": 8, "ka_adv": 4,
                          "kc_visc": 4},
    "bt-quad": {"ka_quad": 4, "kb": 8, "ka_adv": 4, "kc_visc": 4},
    "bt-split": {"ka_quad": 8, "kb": 8, "ka_adv": 4, "kc_visc": 4},
    "sw-xfirst": {"ka_sw": 4, "kb": 8, "ka_fwd": 4, "kc_sw": 4,
                  "sw_combine": 4, "rk4_combine": 1},
    "sw-xfirst-etdrk4": {"ka_sw": 4, "kb": 8, "ka_fwd": 4, "kc_sw": 4,
                         "sw_combine_mv": 4},
    # the barotropic fusion arms (the y-first order)
    "bt-fusekb-full": {"ka_diag": 4, "kb_adv_full": 4, "kx_visc": 4,
                       "rk4_combine": 1},
    "bt-fusekb-half": {"ka_diag": 4, "kb_pair": 4, "kb_adv_half": 4,
                       "kx_visc": 4, "rk4_combine": 1},
    "bt-fusekx0": {"ka_diag": 4, "kb_pair": 8, "ky_adv": 4, "kx_fwd": 4,
                   "visc": 4, "rk4_combine": 1},
    "bt-fusetail": {"ka_diag": 4, "kb_pair": 8, "ky_adv": 4, "kx_visc": 3,
                    "kx_visc_tail": 1},
    "bt-full-tail": {"ka_diag": 4, "kb_adv_full": 4, "kx_visc": 3,
                     "kx_visc_tail": 1},
    # the unfused RK form: torch stage updates and tail
    "bt-unfused-fusekx0": {"ka_diag": 4, "kb_pair": 8, "ky_adv": 4,
                           "kx_fwd": 4, "visc": 4},
    "bt-etdrk4-full": {"ka_diag": 4, "kb_adv_full": 4, "kx_visc": 4},
    "bt-etdrk4-fusekx0": {"ka_diag": 4, "kb_pair": 8, "ky_adv": 4,
                          "kx_fwd": 4, "visc": 4},
}
# and per segment: the shallow-water forcing spectrum (the runner always
# passes a forcing field, zero when the run is unforced)
PER_SEGMENT = {"shallow-water": {"ka": 1, "kc": 1},
               "sw-etdrk4": {"ka": 1, "kc": 1},
               "sw-unfused": {"ka": 1, "kc": 1},
               "sw-xfirst": {"ka": 1, "kc": 1},
               "sw-xfirst-etdrk4": {"ka": 1, "kc": 1}}
# the sharded paths; through the CLI, the records' diagnostics add their
# inverse transforms once per segment
PER_STEP.update({f"shard{k}-{d}-{i}": v
                 for (d, i), v in SHARD_PER_STEP.items() for k in ("", "4")})
PER_STEP["shard4-slab-overlap-etdrk4"] = SHARD_PER_STEP[("slab", "overlap")]
PER_SEGMENT.update({f"shard-{d}-{i}": v
                    for (d, i), v in SHARD_PER_RECORD.items()})
# the main paths driven through cli.run.main, and the environment each
# runs under (the x-first order, as the JAX package reads it)
BT_ARM_ENV = {"bt-fusekb-full": {"XFB_BT_FUSEKB": "full"},
              "bt-fusekb-half": {"XFB_BT_FUSEKB": "half"},
              "bt-fusekx0": {"XFB_BT_FUSEKX": "0"},
              "bt-fusetail": {"XFB_BT_FUSETAIL": "1"},
              "bt-full-tail": {"XFB_BT_FUSEKB": "full",
                               "XFB_BT_FUSETAIL": "1"},
              "bt-unfused-fusekx0": {"XFB_BT_FUSED_RK": "0",
                                     "XFB_BT_FUSEKX": "0"},
              "bt-etdrk4-full": {"XFB_BT_FUSEKB": "full"},
              "bt-etdrk4-fusekx0": {"XFB_BT_FUSEKX": "0"}}
CLI_FAMILIES = ("barotropic", "tracer", "shallow-water", "sw-etdrk4",
                "sw-drag", "barotropic-xfirst", "sw-xfirst",
                "sw-xfirst-etdrk4") + tuple(BT_ARM_ENV) + SHARD_CLI
CLI_ENV = {"barotropic-xfirst": {"XFB_BT_YFIRST": "0"},
           "sw-xfirst": {"XFB_SW_YFIRST": "0"},
           "sw-xfirst-etdrk4": {"XFB_SW_YFIRST": "0"}, **BT_ARM_ENV}
# the same arms as BarotropicModel.build arguments, in the trajectory,
# no-library and time phases, each beside the default arm of its form
# (BT_ARM_REF, else "kernels")
BT_ARMS = {"full": dict(fusekb="full"), "half": dict(fusekb="half"),
           "fusekx0": dict(fusekx=False), "tail": dict(fusetail=True),
           "full-tail": dict(fusekb="full", fusetail=True),
           "full-fusekx0": dict(fusekb="full", fusekx=False),
           "unfused-fusekx0": dict(fused_rk=False, fusekx=False)}
BTE_ARMS = {"full": dict(fusekb="full"), "fusekx0": dict(fusekx=False)}
BT_ARM_REF = {"unfused-fusekx0": "unfused"}
# the main paths driven through a model's entry point
MODEL_PATHS = ("sw-unfused", "bt-quad", "bt-split")
SW_FAMILIES = ("shallow-water", "sw-etdrk4", "sw-drag") + XFIRST_SW
# the SW drag path's drag (examples/09-drag-spindown)
SW_R_DRAG = 2e-4
# and its time step's cap: 0.9 of the 1 s RK4 viscous bound of example
# 12's hyperviscosity (0.847 s, the gravity-wave bound, binds at 4096^2)
SW_DRAG_DT_MAX = 0.9
# the adjoint main path: the JAX package's 4DVar twin experiment
# (scripts/assimilate_demo.py: a 10-step window, guess 0.9 x truth, Adam
# at lr 1e-5), a few iterations of it
ADJ_WINDOW, ADJ_ITERS, ADJ_LR = 10, 3, 1e-5


def adjoint_launches(n: int, gradients: int, forwards: int) -> dict:
    """ka, kb and kc launches of `forwards` forward-only barotropic
    rollouts of n steps and `gradients` gradients through them. A
    forward: 4 stages x (5 ka, 2 kb, 1 kc) per step, plus rfft2 of the
    IC and irfft2 of the final state. A gradient adds the checkpointed
    forward's recomputation, the backward's 4 x (5 ka, 1 kb, 4 kc) per
    step and the adjoints of the two ends."""
    fwd = {"ka": 20 * n + 2, "kb": 8 * n + 1, "kc": 4 * n + 1}
    grad = {"ka": 60 * n + 4, "kb": 20 * n + 2, "kc": 24 * n + 2}
    return {k: forwards * fwd[k] + gradients * grad[k] for k in fwd}
# the shallow-water main path's error bars against its library path,
# the JAX package's for its two SW paths (tests/test_pallas_sw.py)
SW_TOL_ONE_STEP, SW_TOL = 1e-5, 2e-4


class SmokeError(RuntimeError):
    pass


class Case(NamedTuple):
    """One kernel held against its plain version: the two calls, the
    output tensors of a result, the tensors the function reads (each
    counted once for its bound), the complex length-n transforms it
    computes, and the one torch call that computes the same function,
    where there is one (timed beside it, used nowhere in the port)."""
    kern: Callable
    plain: Callable
    fields: Callable
    reads: tuple
    ffts: float = 0.0
    library: Optional[Callable] = None
    exact: bool = False             # a copy: equal to its plain version


def example12_nu4(n: int, lx: float = 600_000.0) -> float:
    """The hyperviscosity of examples/12-hyperviscous-etd/example.sh:
    RK4's viscous bound at 1 s for the modes the dealias mask keeps."""
    kc = math.ceil(n / 3.0)
    k2cut = (2.0 * math.pi / lx) ** 2 * 2.0 * kc * kc
    return 2.785 / k2cut ** 2


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
    """name -> Case on numpy-seeded inputs at the main paths' shapes for
    an n x n grid. The names of the KERNELS rows are the cases the JSON
    line reports; the others are variants (no axpy, no forcing, the
    tracer's stacked planes, the ETD stage without its tendency or at
    scale 2)."""
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.ops import fused_sw as fs
    from xlab_fftbarotropic_torch.ops import fused_tracer as ft
    from xlab_fftbarotropic_torch.ops.spectral import SpectralTables

    rng = np.random.default_rng(seed)
    hny = n // 2 + 1

    def planes(shape, k):
        return [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) for _ in range(k)]

    t = SpectralTables.build(n, n, 600_000.0, 600_000.0, device=dev)
    zr, zi = planes((n, hny), 2)
    sr2, si2 = planes((2, n, hny), 2)
    wr, wi = planes((4, hny, n), 2)
    w6r, w6i = planes((6, hny, n), 2)
    u, zx, v, zy, src, qx, qy = planes((n, n), 7)
    fr, fi, zsr, zsi, z0r, z0i = planes((n, hny), 6)
    f2r, f2i, zs2r, zs2i, z02r, z02i = planes((2, n, hny), 6)
    lap = t.lap / t.lap.abs().max()       # order-one viscous term
    lap2 = torch.stack([lap, 0.5 * lap])
    rk = [tuple(planes((n, hny), 2)) for _ in range(5)]
    rk2 = [tuple(planes((2, n, hny), 2)) for _ in range(5)]
    scale = 1.0 / (n * n)
    # shallow water at the bench's magnitudes: zeta 1e-4, div 1e-6,
    # eta 5 m in the state; u, v 3 m/s, zeta 1e-4 and eta_scale * eta
    # 1e-4 in the y-major fields
    sw = [a * p for a, p in zip((1e-4, 1e-4, 1e-6, 1e-6, 5.0, 5.0),
                                planes((n, hny), 6))]
    sw0 = [a * p for a, p in zip((1e-4, 1e-4, 1e-6, 1e-6, 5.0, 5.0),
                                 planes((n, hny), 6))]
    es = float(fs.eta_pair_scale(sw))
    su, sv, szeta, seta = (a * p for a, p in zip((3.0, 3.0, 1e-4, 1e-4),
                                                 planes((n, n), 4)))
    ky_args = (su, sv, szeta, seta, 2.0 ** 15, 1e-4, 9.81)
    pr, pi = planes((5, n, hny), 2)
    sr, si = planes((n, hny), 2)
    comb = (pr, pi, tuple(sw), (sr, si), t.kx, t.ky, t.lap, t.mask, 1e-4,
            9.81, 6.5, 4000.0)
    # the ETD stage: N's combine has every linear coefficient zero; Q a
    # per-mode 3x3 table of the size of the SW ETD tables' entries
    q = torch.stack(planes((3, n, hny), 3)) * 10.0
    mv = (pr, pi, tuple(sw), (sr, si), t.kx, t.ky, t.lap, t.mask, 0.0, 0.0,
          0.0, 0.0, tuple(sw0), q)
    xr, xi = planes((n, n), 2)
    kbw = planes((hny, n), 4)
    ax_s, ax_r = planes((n, hny), 6), planes((n, hny), 6)
    # the x-first SW forward stage's (5, ny, nx) product x-stages
    gr, gi = planes((5, n, n), 2)
    # ka_diag's stack at the size the stepper gives kb_adv: physical
    # fields of order one after the 1/n^2 scale, as the product's terms
    kar, kai = (w * n * math.sqrt(n) for w in (wr, wi))
    tail = (z0r, z0i, *rk[1], *rk[2], *rk[3], 0.5)
    # complex inputs of the library calls, made once here
    fc = torch.complex(fr, fi)
    xc = torch.complex(xr, xi)
    zc = torch.complex(zr, zi)
    pc = torch.complex(pr, pi)
    gc = torch.complex(gr, gi)
    wc = torch.complex(wr[2:4], wi[2:4])
    kbc = torch.complex(torch.stack(kbw[0::2]), torch.stack(kbw[1::2]))

    def per_field(out):                   # split stacked outputs by field
        return [p[f] for p in out for f in range(p.shape[0])]

    def stage(out):                       # (tendency, next stage state)
        return [*out[0], *out[1]]

    combine_reads = (pr, pi, *sw[:4], sr, si, t.lap, t.mask)
    return {
        "ka_diag": Case(lambda: ff.ka_diag(zr, zi, t.rlap, t.kx, t.ky),
                        lambda: ff.ka_diag_plain(zr, zi, t.rlap, t.kx, t.ky),
                        per_field, (zr, zi, t.rlap), 4 * hny),
        "kb_pair": Case(lambda: ff.kb_pair(wr, wi, 2, 3, scale),
                        lambda: ff.kb_pair_plain(wr, wi, 2, 3, scale), list,
                        (wr[2:4], wi[2:4]), n,
                        lambda: torch.fft.irfft(wc, n=n, dim=1)),
        "ky_adv": Case(lambda: ff.ky_adv(u, zx, v, zy, src, 0.3),
                       lambda: ff.ky_adv_plain(u, zx, v, zy, src, 0.3), list,
                       (u, zx, v, zy, src), 0.5 * n),
        "kx_visc": Case(lambda: ff.kx_visc(fr, fi, lap, t.mask, zsr, zsi, 6.5,
                                           (z0r, z0i, 1.5)),
                        lambda: ff.kx_visc_plain(fr, fi, lap, t.mask, zsr,
                                                 zsi, 6.5, (z0r, z0i, 1.5)),
                        list, (fr, fi, lap, t.mask, zsr, zsi, z0r, z0i), hny),
        "kx_visc_no_axpy": Case(
            lambda: ff.kx_visc(fr, fi, lap, t.mask, zsr, zsi, 6.5),
            lambda: ff.kx_visc_plain(fr, fi, lap, t.mask, zsr, zsi, 6.5),
            list, (fr, fi, lap, t.mask, zsr, zsi), hny),
        "kx_visc_tracer": Case(
            lambda: ft.forward_tail_tracer(f2r, f2i, lap2, t.mask, zs2r,
                                           zs2i, (z02r, z02i, 1.5)),
            lambda: ff.kx_visc_plain(f2r, f2i, lap2, t.mask, zs2r, zs2i,
                                     1.0, (z02r, z02i, 1.5)), per_field,
            (f2r, f2i, lap2, t.mask, zs2r, zs2i, z02r, z02i), 2 * hny),
        "ka6": Case(lambda: ft.tracer_xstage_planes(sr2, si2, t.kx, t.ky,
                                                    t.rlap),
                    lambda: ft.ka6_plain(sr2, si2, t.rlap, t.kx, t.ky),
                    per_field, (sr2, si2, t.rlap), 6 * hny),
        "kb_pair_six": Case(lambda: ff.kb_pair(w6r, w6i, 4, 5, scale),
                            lambda: ff.kb_pair_plain(w6r, w6i, 4, 5, scale),
                            list, (w6r[4:6], w6i[4:6]), n),
        "kb_adv_tracer": Case(
            lambda: ft.kb_adv_tracer(zx, zy, qx, qy, w6r, w6i, src, 0.3),
            lambda: ft.kb_adv_tracer_plain(zx, zy, qx, qy, w6r, w6i, src,
                                           0.3), per_field,
            (zx, zy, qx, qy, w6r[2:4], w6i[2:4], src), 2 * n),
        "kb_adv_tracer_no_src": Case(
            lambda: ft.kb_adv_tracer(zx, zy, qx, qy, w6r, w6i, None, 0.3),
            lambda: ft.kb_adv_tracer_plain(zx, zy, qx, qy, w6r, w6i, None,
                                           0.3), per_field,
            (zx, zy, qx, qy, w6r[2:4], w6i[2:4]), 2 * n),
        "kb_adv_tracer_beta0": Case(
            lambda: ft.kb_adv_tracer(zx, zy, qx, qy, w6r, w6i, src),
            lambda: ft.kb_adv_tracer_plain(zx, zy, qx, qy, w6r, w6i, src),
            per_field, (zx, zy, qx, qy, w6r[2:4], w6i[2:4], src), 2 * n),
        "kb_adv_tracer_beta0_no_src": Case(
            lambda: ft.kb_adv_tracer(zx, zy, qx, qy, w6r, w6i, None),
            lambda: ft.kb_adv_tracer_plain(zx, zy, qx, qy, w6r, w6i, None),
            per_field, (zx, zy, qx, qy, w6r[2:4], w6i[2:4]), 2 * n),
        "rk4_combine": Case(lambda: fs.plane_rk4_combine(*rk, 0.5),
                            lambda: fs.plane_rk4_combine_plain(*rk, 0.5),
                            list, tuple(p for g in rk for p in g)),
        "rk4_combine_tracer": Case(
            lambda: fs.plane_rk4_combine(*rk2, 0.5),
            lambda: fs.plane_rk4_combine_plain(*rk2, 0.5), per_field,
            tuple(p for g in rk2 for p in g)),
        "ka_sw": Case(lambda: fs.ka_sw(*sw, t.rlap, t.kx, t.ky, es),
                      lambda: fs.ka_sw_plain(*sw, t.rlap, t.kx, t.ky, es),
                      per_field, (*sw, t.rlap), 4 * hny),
        "ky_all": Case(lambda: fs.ky_all(*ky_args),
                       lambda: fs.ky_all_plain(*ky_args), per_field,
                       (su, sv, szeta, seta), 2.5 * n),
        "ky_all_split": Case(lambda: fs.ky_all(*ky_args, True),
                             lambda: fs.ky_all_plain(*ky_args, True),
                             per_field, (su, sv, szeta, seta), 2.5 * n),
        "kx_fwd": Case(lambda: fs.kx_fwd(pr, pi),
                       lambda: fs.kx_fwd_plain(pr, pi), per_field, (pr, pi),
                       5 * hny, lambda: torch.fft.fft(pc, dim=-2)),
        "sw_combine": Case(
            lambda: fs.sw_combine(*comb, axpy=(tuple(sw0), 0.4235)),
            lambda: fs.sw_combine_plain(*comb, axpy=(tuple(sw0), 0.4235)),
            stage, combine_reads + tuple(sw0)),
        "sw_combine_no_axpy": Case(lambda: fs.sw_combine(*comb),
                                   lambda: fs.sw_combine_plain(*comb), list,
                                   combine_reads),
        "sw_combine_split_no_src": Case(
            lambda: fs.sw_combine(*comb[:3], None, *comb[4:], True),
            lambda: fs.sw_combine_plain(*comb[:3], None, *comb[4:], True),
            list, (pr, pi, *sw, t.lap, t.mask)),
        "sw_combine_mv": Case(
            lambda: fs.sw_combine_mv(*mv, 1.0, True),
            lambda: fs.sw_combine_mv_plain(*mv, 1.0, True), stage,
            combine_reads + tuple(sw0) + (q,)),
        "sw_combine_mv_no_tend": Case(
            lambda: fs.sw_combine_mv(*mv, 1.0, False),
            lambda: fs.sw_combine_mv_plain(*mv, 1.0, False),
            lambda out: list(out[1]), combine_reads + tuple(sw0) + (q,)),
        "sw_combine_mv_scale2": Case(
            lambda: fs.sw_combine_mv(*mv, 2.0, True),
            lambda: fs.sw_combine_mv_plain(*mv, 2.0, True), stage,
            combine_reads + tuple(sw0) + (q,)),
        "ka": Case(lambda: ff.ka(xr, None, True),
                   lambda: ff.ka_plain(xr, None, True), list, (xr,), n,
                   lambda: torch.fft.fft(xr, dim=0)),
        "ka_real_inverse": Case(lambda: ff.ka(xr, None, False, 0.5),
                                lambda: ff.ka_plain(xr, None, False, 0.5),
                                list, (xr,), n),
        "ka_complex_forward": Case(lambda: ff.ka(xr, xi, True, 0.5),
                                   lambda: ff.ka_plain(xr, xi, True, 0.5),
                                   list, (xr, xi), n),
        # the complex inverse on the hny columns of irfft2 / inverse_pair
        "ka_complex_inverse": Case(lambda: ff.ka(zr, zi, False),
                                   lambda: ff.ka_plain(zr, zi, False), list,
                                   (zr, zi), hny,
                                   lambda: torch.fft.ifft(zc, dim=0)),
        "kc": Case(lambda: ff.kc(xr, xi), lambda: ff.kc_plain(xr, xi), list,
                   (xr, xi), n, lambda: torch.fft.fft(xc, dim=0)),
        "kb": Case(lambda: ff.kb(*kbw, scale), lambda: ff.kb_plain(*kbw, scale),
                   list, tuple(kbw), n,
                   lambda: torch.fft.irfft(kbc, n=n, dim=1)),
        "kb_single": Case(lambda: ff.kb(*kbw[:2], None, None, scale)[:1],
                          lambda: ff.kb_plain(*kbw[:2], None, None,
                                              scale)[:1], list,
                          tuple(kbw[:2]), n),
        "plane_axpy": Case(lambda: fs.plane_axpy(ax_s, ax_r, 0.4235),
                           lambda: fs.plane_axpy_plain(ax_s, ax_r, 0.4235),
                           list, tuple(ax_s + ax_r)),
        "plane_axpy_two": Case(
            lambda: fs.plane_axpy(ax_s[:2], ax_r[:2], 0.4235),
            lambda: fs.plane_axpy_plain(ax_s[:2], ax_r[:2], 0.4235), list,
            tuple(ax_s[:2] + ax_r[:2])),
        "kb_xmajor": Case(lambda: ff.kb_stacked(wr, wi, 2, 3, scale),
                          lambda: ff.kb_plain(wr[2], wi[2], wr[3], wi[3],
                                              scale), list,
                          (wr[2:4], wi[2:4]), n,
                          lambda: torch.fft.irfft(wc, n=n, dim=1)),
        "ka_adv": Case(lambda: ff.ka_adv(u, zx, v, zy, src, 0.3),
                       lambda: ff.ka_adv_plain(u, zx, v, zy, src, 0.3), list,
                       (u, zx, v, zy, src), 0.5 * n),
        "ka_adv_f_plane": Case(lambda: ff.ka_adv(u, zx, v, zy, src),
                               lambda: ff.ka_adv_plain(u, zx, v, zy, src),
                               list, (u, zx, v, zy, src), 0.5 * n),
        "kc_visc": Case(lambda: ff.kc_visc(xr, xi, lap, t.mask, zsr, zsi,
                                           6.5),
                        lambda: ff.kc_visc_plain(xr, xi, lap, t.mask, zsr,
                                                 zsi, 6.5), list,
                        (xr, xi, lap, t.mask, zsr, zsi), n),
        "ka_quad": Case(lambda: ff.ka_quad(zr, zi, t.rlap, t.kx, t.ky),
                        lambda: ff.ka_quad_plain(zr, zi, t.rlap, t.kx, t.ky),
                        per_field, (zr, zi, t.rlap), 4 * hny),
        # the split form's x-stage of one stage: both of its calls
        "ka_quad_split": Case(
            lambda: (*ff.ka_quad(zr, zi, t.rlap, t.kx, t.ky, 0, 2),
                     *ff.ka_quad(zr, zi, t.rlap, t.kx, t.ky, 2, 2)),
            lambda: (*ff.ka_quad_plain(zr, zi, t.rlap, t.kx, t.ky, 0, 2),
                     *ff.ka_quad_plain(zr, zi, t.rlap, t.kx, t.ky, 2, 2)),
            per_field, (zr, zi, t.rlap), 4 * hny),
        "ka_fwd": Case(lambda: fs.ka_fwd(*ky_args),
                       lambda: fs.ka_fwd_plain(*ky_args), per_field,
                       (su, sv, szeta, seta), 2.5 * n),
        "ka_fwd_split": Case(lambda: fs.ka_fwd(*ky_args, True),
                             lambda: fs.ka_fwd_plain(*ky_args, True),
                             per_field, (su, sv, szeta, seta), 2.5 * n),
        "kc_sw": Case(lambda: fs.kc_sw(gr, gi), lambda: fs.kc_sw_plain(gr, gi),
                      per_field, (gr, gi), 5 * n,
                      lambda: torch.fft.fft(gc, dim=1)),
        # the barotropic fusion arms: two inverse and one real forward
        # transform per column (full), one and one (half)
        "kb_adv_full": Case(lambda: ff.kb_adv_full(kar, kai, src, 0.3),
                            lambda: ff.kb_adv_full_plain(kar, kai, src, 0.3),
                            list, (kar, kai, src), 2.5 * n),
        "kb_adv_half": Case(
            lambda: ff.kb_adv_half(zx, zy, kar, kai, src, 0.3),
            lambda: ff.kb_adv_half_plain(zx, zy, kar, kai, src, 0.3), list,
            (zx, zy, kar[2:4], kai[2:4], src), 1.5 * n),
        "kx_visc_tail": Case(
            lambda: ff.kx_visc_tail(fr, fi, lap, t.mask, zsr, zsi, 6.5, tail),
            lambda: ff.kx_visc_tail_plain(fr, fi, lap, t.mask, zsr, zsi, 6.5,
                                          tail), list,
            (fr, fi, lap, t.mask, zsr, zsi, *tail[:8]), hny),
        "kx_fwd_bt": Case(lambda: fs.kx_fwd(fr[None], fi[None]),
                          lambda: fs.kx_fwd_plain(fr[None], fi[None]),
                          per_field, (fr, fi), hny,
                          lambda: torch.fft.fft(fc, dim=-2)),
        "visc": Case(lambda: ff.visc(fr, fi, lap, t.mask, zsr, zsi, 6.5),
                     lambda: ff.visc_plain(fr, fi, lap, t.mask, zsr, zsi,
                                           6.5), list,
                     (fr, fi, lap, t.mask, zsr, zsi)),
        "visc_axpy": Case(
            lambda: ff.visc(fr, fi, lap, t.mask, zsr, zsi, 6.5,
                            (z0r, z0i, 1.5)),
            lambda: ff.visc_plain(fr, fi, lap, t.mask, zsr, zsi, 6.5,
                                  (z0r, z0i, 1.5)), list,
            (fr, fi, lap, t.mask, zsr, zsi, z0r, z0i)),
        **shard_cases(n, 4, dev, seed),
    }


def shard_cases(n: int, p: int, dev, seed: int) -> dict:
    """name -> Case of the distributed path's kernels (rows 21-23) on p
    shards of an n x n grid's half-spectrum, numpy-seeded: the transposes
    (copies, held to their plain versions exactly; the library figure the
    one .contiguous() of the permuted view) and the x-stages (the inverse
    with its 1/n, the form 16 of a step's 20 take; the library figure
    torch.fft.fft of the gathered (n, hpad) array)."""
    from xlab_fftbarotropic_torch.parallel import fused_overlap as fo
    from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr

    rng = np.random.default_rng(seed)
    hny = n // 2 + 1
    w = -(-hny // p)

    def shards(shape):
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.complex64)).to(dev)

    rows, cols = shards((p, n // p, hny)), shards((p, n, w))
    padded = torch.cat([rows, rows.new_zeros((p, n // p, p * w - hny))], -1)
    gathered = padded.reshape(n, p * w)
    s = 1.0 / n

    def one(out):
        return [out]

    def dft():
        return torch.fft.fft(gathered, dim=0)

    return {
        "a2a_cols": Case(
            lambda: ftr.a2a_cols(rows), lambda: ftr.a2a_cols_plain(rows), one,
            (rows,), library=lambda: padded.reshape(
                p, n // p, p, w).permute(2, 0, 1, 3).contiguous(),
            exact=True),
        "a2a_rows": Case(
            lambda: ftr.a2a_rows(cols, hny),
            lambda: ftr.a2a_rows_plain(cols, hny), one, (cols,),
            library=lambda: cols.reshape(p, p, n // p, w).permute(
                1, 2, 0, 3).contiguous(), exact=True),
        "xstage": Case(lambda: fo.xstage(rows, False, s),
                       lambda: fo.xstage_plain(rows, False, s), one, (rows,),
                       hny, dft),
        "xstage_forward": Case(lambda: fo.xstage(rows, True),
                               lambda: fo.xstage_plain(rows, True), one,
                               (rows,), hny, dft),
        "xstage_gather": Case(lambda: fo.xstage_gather(rows),
                              lambda: fo.xstage_gather_plain(rows), one,
                              (rows,), hny, dft),
        "xstage_scatter": Case(
            lambda: fo.xstage_scatter(cols, hny, False, s),
            lambda: fo.xstage_scatter_plain(cols, hny, False, s), one,
            (cols,), hny, dft),
    }


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(case: Case, outputs, n: int):
    """The least time the card could take for the case's work, in ms: the
    bytes it must move (each input read once, each output written once)
    over the HBM rate, or its transforms' flops (5 n log2 n per complex
    length-n transform) over the float32 rate, whichever is larger."""
    t_bytes = (nbytes(case.reads) + nbytes(outputs)) / HBM_BYTES_S
    t_ops = case.ffts * 5.0 * n * math.log2(n) / FP32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compare(name: str, case: Case, where: str):
    """A case's kernel against its plain version: (max err over max
    |plain|, max abs err, the plain version's outputs); raises past TOL,
    or past 0 for a copy."""
    got, want = case.fields(case.kern()), case.fields(case.plain())
    torch.cuda.synchronize()
    rel = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    log(f"kernel {name:24s} {where}: max err / max|plain| = {rel:.3e} "
        f"(max abs err {abs_err:.3e})")
    bar = 0.0 if case.exact else TOL
    check(rel <= bar, f"{name} at {where} disagrees with its plain "
                      f"version: {rel:.3e} > {bar}")
    return rel, abs_err, want


def phase_xtile(n: int) -> dict:
    """The column-tile plans of the x-stages (kx_visc.cu, xstage.cu,
    ka_kernel on the ny columns of rfft2's real forward and the hny of
    the complex inverse, ka_fields_kernel and ka_sw_kernel on hny,
    ka_adv_kernel and ka_fwd_kernel on ny) and the y-stages (kc_kernel,
    kb_kernel, kb_pair_kernel, ky_adv_kernel, ky_all_kernel,
    kb_adv_kernel, kb_adv_tracer_kernel: the nx columns of float planes;
    kb_adv and kb_adv_tracer in tiles of C/2 columns, two of them in
    full and in the tracer's) at 256^2 and n^2, and every kernel's
    registers and spills from the build log."""
    from xlab_fftbarotropic_torch.ops import _build
    from xlab_fftbarotropic_torch.ops.xtile import xtile_plan

    out = {"plans": {}, "ptxas": {}}
    for size in (256, n):
        hny = size // 2 + 1
        for name, columns, elem in (("kx_visc", hny, 4),
                                    ("xstage", hny, 8),
                                    ("xstage_gather P=4",
                                     4 * -(-hny // 4), 8),
                                    ("ka_kernel ny", size, 4),
                                    ("ka_kernel hny", hny, 4),
                                    ("ka_fields_kernel", hny, 4),
                                    ("ka_sw_kernel", hny, 4),
                                    ("ka_adv_kernel", size, 4),
                                    ("ka_fwd_kernel", size, 4),
                                    ("kc_kernel", size, 4),
                                    ("kb_kernel", size, 4),
                                    ("kb_pair_kernel", size, 4),
                                    ("ky_adv_kernel", size, 4),
                                    ("ky_all_kernel", size, 4),
                                    ("kb_adv_kernel half", size, 4),
                                    ("kb_adv_kernel full", size, 4),
                                    ("kb_adv_tracer_kernel", size, 4)):
            p = xtile_plan(size, columns, elem)
            if name.startswith("kb_adv"):   # tiles of C/2 columns
                tile = p.m * p.c // 2 * 8
                # half holds one tile less; the tracer's second tile has
                # 16 values of padding behind it
                extra = {"kb_adv_kernel half": -tile,
                         "kb_adv_tracer_kernel": 16 * 8}.get(name, 0)
                p = p._replace(c=p.c // 2, threads=p.threads // 2,
                               tiles=-(-columns // (p.c // 2)),
                               smem=p.smem + extra)
            log(f"xtile plan {name:18s} {size}^2: C = {p.c} columns, K = "
                f"{p.k} blocks per cluster, {p.threads} threads, {p.smem} "
                f"shared bytes per block, {p.tiles} tiles, passes "
                f"{p.radices}")
            out["plans"][f"{name} {size}"] = p._asdict()
    text = (Path(_build.LAST_BUILD["path"]).parent / "build.log").read_text()
    for fn, body in re.findall(r"Compiling entry function '(\w+)'"
                               r"(.*?)Compile time", text, re.S):
        name = next((k for k in kernel_functions()
                     if re.search(rf"\d{k}(E|I)", fn)), fn)
        regs = int(re.search(r"Used (\d+) registers", body).group(1))
        st, ld = (int(v) for v in re.search(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads",
            body).groups())
        tag = name
        while tag in out["ptxas"]:              # template instances
            tag += "'"
        out["ptxas"][tag] = dict(registers=regs, spill_stores=st,
                                 spill_loads=ld)
        log(f"ptxas {tag:36s}: {regs} registers, spill stores {st} B, "
            f"spill loads {ld} B")
    return out


def ka_pins(n: int, dev, rng) -> dict:
    """The ka x-stages' pins at n^2: name -> (got, want) planes that must
    be equal bit for bit (one plan and one rounded arithmetic in
    ka_kernel, ka_fields_kernel and ka_adv_kernel, whose load rounds the
    advection as fused_fft.advection forms it in torch). The one list of
    these pins: tests/test_torch_cuda_kernels.py checks the same pairs."""
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.ops import fused_tracer as ft
    from xlab_fftbarotropic_torch.ops.spectral import SpectralTables

    hny = n // 2 + 1
    t = SpectralTables.build(n, n, 600_000.0, 600_000.0, device=dev)
    sr, si = (torch.from_numpy(rng.standard_normal((2, n, hny)).astype(
        np.float32)).to(dev) for _ in range(2))
    tab = (t.rlap, t.kx, t.ky)
    diag0 = ff.ka_diag(sr[0], si[0], *tab)
    diag1 = ff.ka_diag(sr[1], si[1], *tab)
    quad = ff.ka_quad(sr[0], si[0], *tab)
    split = [torch.cat(p) for p in zip(ff.ka_quad(sr[0], si[0], *tab, 0, 2),
                                       ff.ka_quad(sr[0], si[0], *tab, 2, 2))]
    six = ft.tracer_xstage_planes(sr, si, t.kx, t.ky, t.rlap)
    k = t.kx.reshape(-1, 1)
    ka = ff.ka(-(si[0] * k), sr[0] * k, False, 1.0)
    pins = {"ka_quad 0-1 = ka_diag 0-1": ([q[:2] for q in quad],
                                          [d[:2] for d in diag0]),
            "split = quad": (split, quad),
            "ka6 0-3 = ka_diag S[0]": ([x[:4] for x in six], diag0),
            "ka6 4-5 = ka_diag S[1] 0-1": ([x[4:] for x in six],
                                           [d[:2] for d in diag1]),
            "ka(-(zi kx), zr kx) = ka_diag 0": (list(ka),
                                                [d[0] for d in diag0])}
    u, zx, v, zy, src = (torch.from_numpy(rng.standard_normal((n, n)).astype(
        np.float32)).to(dev) for _ in range(5))
    for beta in (0.0, 0.3):
        adv = ff.advection(u, zx, v, zy, src, beta)
        pins[f"ka_adv beta={beta} = ka of adv"] = (
            list(ff.ka_adv(u, zx, v, zy, src, beta)),
            list(ff.ka(adv, None, True)))
    return pins


def sw_pins(n: int, dev, rng) -> dict:
    """The shallow-water stages' pins at n^2: name -> (got, want) planes
    that must be equal bit for bit (ka_sw and ka_fwd run ka's plan and
    transform behind their loads, ky_all kc's, and the loads round as
    sw_fields and sw_products do): ka_sw's field f against ka (complex
    inverse, scale 1) of sw_fields' field f formed in torch, field 2
    against ka of (zr, zi) and field 3 against ka of (er, ei) at scale
    eta_scale (a power of two); ka_fwd's product p against ka (real
    forward, scale 1) of sw_products' product p, and ky_all's against kc
    of (product p, 0), split off and on. The one list of these pins:
    tests/test_torch_cuda_kernels.py checks the same pairs."""
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.ops import fused_sw as fs
    from xlab_fftbarotropic_torch.ops.spectral import SpectralTables

    def planes(shape, amps):
        return [a * torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) for a in amps]

    t = SpectralTables.build(n, n, 600_000.0, 600_000.0, device=dev)
    state = planes((n, n // 2 + 1), (1e-4, 1e-4, 1e-6, 1e-6, 5.0, 5.0))
    es = float(fs.eta_pair_scale(state))
    wr, wi = fs.ka_sw(*state, t.rlap, t.kx, t.ky, es)
    re_, im = fs.sw_fields(*state, t.rlap, t.kx, t.ky, es)
    pins = {f"ka_sw {name} = ka of sw_fields": (
        [wr[f], wi[f]], list(ff.ka(re_[f], im[f], False)))
        for f, name in enumerate(("u", "v", "zeta", "eta_s"))}
    zr, zi, _, _, er, ei = state
    pins["ka_sw zeta = ka(zr, zi)"] = ([wr[2], wi[2]],
                                       list(ff.ka(zr, zi, False)))
    pins["ka_sw eta_s = ka(er, ei) x es"] = ([wr[3], wi[3]],
                                             list(ff.ka(er, ei, False, es)))
    fields = planes((n, n), (3.0, 3.0, 1e-4, 1e-4))
    for split in (False, True):
        tag = " split" if split else ""
        yr, yi = fs.ka_fwd(*fields, 2.0 ** 15, 1e-4, 9.81, split)
        # the same planes as y-major (ny, nx) fields
        kr, ki = fs.ky_all(*fields, 2.0 ** 15, 1e-4, 9.81, split)
        prods = fs.sw_products(*fields, 2.0 ** 15, 1e-4, 9.81, split)
        for p in range(len(prods)):
            pins[f"ka_fwd{tag} {p} = ka of sw_products"] = (
                [yr[p], yi[p]], list(ff.ka(prods[p], None, True)))
            pins[f"ky_all{tag} {p} = kc of sw_products"] = (
                [kr[p], ki[p]],
                list(ff.kc(prods[p], torch.zeros_like(prods[p]))))
    return pins


def tracer_pins(ny: int, nx: int, dev, rng) -> dict:
    """kb_adv_tracer's pins on an (ny, nx) grid: name -> (got, want) planes
    that must be equal bit for bit. With (u, v) = kb_pair of fields 2, 3
    of ka6's stack (at the stepper's size: velocities of order one) at
    1/(nx ny), plane 0 = ky_adv(u, zx, v, zy, src, beta) and plane 1 =
    ky_adv(u, qx, v, qy, 0, 0), src given and None (ky_adv of a zero
    plane); beta 0.3 is zeta's alone. The one list of these pins:
    tests/test_torch_cuda_kernels.py checks the same pairs."""
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.ops import fused_tracer as ft

    def planes(shape, k, size=1.0):
        return [size * torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) for _ in range(k)]

    wr, wi = planes((6, ny // 2 + 1, nx), 2, nx * math.sqrt(ny))
    zx, zy, qx, qy, src = planes((ny, nx), 5)
    zero = torch.zeros_like(zx)
    u, v = ff.kb_pair(wr, wi, 2, 3, 1.0 / (nx * ny))
    q = list(ff.ky_adv(u, qx, v, qy, zero, 0.0))
    pins = {}
    for tag, s in (("", src), (" no src", None)):
        fr, fi = ft.kb_adv_tracer(zx, zy, qx, qy, wr, wi, s, 0.3)
        z = ff.ky_adv(u, zx, v, zy, zero if s is None else s, 0.3)
        pins[f"kb_adv_tracer{tag} zeta = kb_pair, ky_adv"] = (
            [fr[0], fi[0]], list(z))
        pins[f"kb_adv_tracer{tag} q = kb_pair, ky_adv"] = ([fr[1], fi[1]], q)
    return pins


def phase_pins(n: int, dev) -> dict:
    """The pins at n^2, bit for bit: the y-first pair's transforms,
    kb_pair (the natural store) equals kb_stacked (the transposed one)
    transposed, on ka_diag's and ka6's stacks, and ky_adv equals kc of
    (adv, 0), adv formed by torch on the card in xfb::advection's order;
    and the ka x-stages' (ka_pins, ka_adv's among them), the SW stages'
    (sw_pins: ka_sw, ka_fwd, ky_all) and kb_adv_tracer's (tracer_pins:
    kb_pair, then ky_adv of each product)."""
    from xlab_fftbarotropic_torch.ops import fused_fft as ff

    rng = np.random.default_rng(n + 11)
    hny = n // 2 + 1

    def planes(shape, k):
        return [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) for _ in range(k)]

    pairs = {}
    for f, fa, fb in ((4, 2, 3), (6, 4, 5)):
        wr, wi = planes((f, hny, n), 2)
        got = ff.kb_pair(wr, wi, fa, fb, 1.0 / (n * n))
        want = ff.kb_stacked(wr, wi, fa, fb, 1.0 / (n * n))
        pairs[f"kb_pair F={f} = kb_stacked^T"] = (got, [w.t() for w in want])
    u, zx, v, zy, src = planes((n, n), 5)
    adv = -(u * zx) - v * (zy + 0.3) + src
    pairs["ky_adv = kc of (adv, 0)"] = (ff.ky_adv(u, zx, v, zy, src, 0.3),
                                        ff.kc(adv, torch.zeros_like(adv)))
    pairs.update(ka_pins(n, dev, rng))
    pairs.update(sw_pins(n, dev, rng))
    pairs.update(tracer_pins(n, n, dev, rng))
    out = {}
    for name, (got, want) in pairs.items():
        same = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
        out[name] = same
        log(f"pin {name:34s} {n}^2: "
            f"{'bit for bit' if same else 'DIFFERS'}")
        check(same, f"pin {name} at {n}^2 does not hold bit for bit")
    return out


def phase_kernels(n: int, dev) -> dict:
    report = {"pins": {size: phase_pins(size, dev) for size in (256, n)}}
    # the distributed kernels at other shard counts (4 comes below)
    for p in (1, 2, 8):
        for name, case in shard_cases(256, p, dev, p).items():
            compare(name, case, f"256^2 P={p}")
    for size in (256, n):
        for name, case in kernel_cases(size, dev, size).items():
            rel, abs_err, want = compare(name, case, f"{size}^2")
            if size == n:
                bound_ms, bound_by = bound(case, want, size)
                ms = cuda_ms(case.kern)
                plain_ms = cuda_ms(case.plain)
                library_ms = (None if case.library is None
                              else cuda_ms(case.library))
                lib = ("" if library_ms is None
                       else f", one torch call {library_ms:.4f} ms")
                log(f"kernel {name:24s} {size}^2: {ms:.4f} ms, plain "
                    f"torch version {plain_ms:.4f} ms{lib}; bound "
                    f"{bound_ms:.4f} ms ({bound_by}; "
                    f"{100.0 * bound_ms / ms:.1f} % of it reached)")
                report[name] = dict(max_abs_err=abs_err, rel_err=rel,
                                    ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    library_ms=library_ms)
    return report


def phase_main_path(family: str, n: int, steps: int) -> dict:
    """One run of a family's main path through cli.run.main (under its
    CLI_ENV), with the launch counters set to 0 just before it and read
    just after."""
    from xlab_fftbarotropic_torch.cli import run as cli_run
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.io.fieldio import read_field, write_field
    from xlab_fftbarotropic_torch.models.shallow_water import max_stable_dt
    from xlab_fftbarotropic_torch.ops import fused_fft as ff

    cfg = ModelConfig(nx=n, ny=n)
    rec = steps // 2
    vort0 = makefields.gaussian(cfg)
    sw_rk4 = ["-m", "sw", "--dt", repr(min(3.0, max_stable_dt(cfg)))]
    sw_etd = ["-m", "sw", "--time-scheme", "etdrk4", "--dt",
              repr(SW_ETD_DT)]
    fields, extra = {
        "barotropic": (["vort"], []),
        "tracer": (["vort", "q"], ["-m", "tracer", "--tracer-kappa", "50",
                                   "--tracer-ic", "gaussian"]),
        # bench.py's SW configuration: the weaker vortex, and dt under
        # the gravity-wave bound (0.847 s at 4096^2, where 3 s NaNs)
        "shallow-water": (["vort", "div", "h"], sw_rk4),
        # bench.py's sw-etdrk4 configuration: the same vortex at 8.85
        # times the RK4 bound
        "sw-etdrk4": (["vort", "div", "h"], sw_etd),
        # the SW configuration with drag (examples/09) and example 12's
        # hyperviscosity: RK4 on the per-transform kernels
        "sw-drag": (["vort", "div", "h"],
                    ["-m", "sw", "--dt",
                     repr(min(SW_DRAG_DT_MAX, max_stable_dt(cfg))),
                     "--r-drag", repr(SW_R_DRAG), "--nu4",
                     repr(example12_nu4(n))]),
        # the same configurations in the x-first order
        "barotropic-xfirst": (["vort"], []),
        "sw-xfirst": (["vort", "div", "h"], sw_rk4),
        "sw-xfirst-etdrk4": (["vort", "div", "h"], sw_etd),
        # the barotropic fusion arms (under their CLI_ENV)
        **{f: (["vort"], ["--time-scheme", "etdrk4"] if "etdrk4" in f
               else []) for f in BT_ARM_ENV},
        # the sharded model on one shard: shard-<decomp>-<impl>
        **{f: (["vort"], ["--shard", "--decomp", f.split("-")[1],
                          "--shard-fft", f.split("-")[2]])
           for f in SHARD_CLI},
    }[family]
    if family in SW_FAMILIES:
        vort0 = makefields.gaussian(cfg, zeta0=1e-5)
    with tempfile.TemporaryDirectory(prefix="xfb_smoke_") as tmp:
        inp, out = Path(tmp) / "input", Path(tmp) / "output"
        inp.mkdir()
        # the phi-table disk cache of an ETD run, in this run's directory
        os.environ["XFB_ETD_CACHE"] = str(Path(tmp) / "etd_cache")
        write_field(inp / cfg.init_file, vort0)
        argv = ["-I", str(inp), "-O", str(out), "--nx", str(n), "--ny",
                str(n), "--total-steps", str(steps), "--record-step",
                str(rec), "--record-fields", ",".join(fields), "--manifest",
                str(Path(tmp) / "log"), "--device", "cuda"] + extra
        env = CLI_ENV.get(family, {})
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            ff.reset_launches()
            t0 = time.perf_counter()
            rc = cli_run.main(argv)
            wall = time.perf_counter() - t0
            launches = dict(ff.LAUNCHES)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        check(rc == 0, f"cli.run.main returned {rc}")
        # the run loop records at the top of each step, so a run of
        # `steps` steps records steps 0 and steps/2 (as the reference)
        for s in (0, rec):
            for name in fields:
                f = out / f"{name}_step_{s}.bin"
                check(f.exists() and f.stat().st_size == n * n * 4,
                      f"record {f.name} missing or of the wrong size")
                check(bool(np.isfinite(read_field(f, cfg.grid_shape)).all()),
                      f"record {f.name} is not finite")
        lines = (Path(tmp) / "log").read_text().splitlines()
        check(len(lines) == 2 * len(fields),
              f"manifest has {len(lines)} lines, not {2 * len(fields)}")
        cached = sorted(p.name for p in (Path(tmp) / "etd_cache").glob("*"))
        if "etdrk4" in family:
            kind = "sw" if family in SW_FAMILIES else "barotropic"
            check(len(cached) == 1 and cached[0].startswith(f"{kind}_etd_"),
                  f"ETD table cache holds {cached}")
    os.environ["XFB_ETD_CACHE"] = "0"
    per_seg = PER_SEGMENT.get(family, {})
    want = {k: PER_STEP[family].get(k, 0) * steps
            + per_seg.get(k, 0) * (steps // rec) for k in ff.LAUNCHES}
    log(f"{family} main path: {steps} steps at {n}^2 through cli.run.main "
        f"{' '.join(f'{k}={v}' for k, v in env.items())} in {wall:.2f} s "
        f"(set-up and records included); launches {launches}")
    check(launches == want, f"launch counts {launches} != {want}")
    check("jax" not in sys.modules, "a jax module was imported")
    check(not any(k.startswith("xlab_fftbarotropic_tpu")
                  for k in sys.modules), "the JAX package was imported")
    return dict(launches=launches, cli_wall_s=wall)


def phase_model_path(path: str, n: int, steps: int) -> dict:
    """A main path the CLI does not select, through its model's entry
    point: the SW unfused RK4 form (ShallowWaterModel.build(...,
    fused_rk=False), the balanced weak vortex) or the barotropic
    QUAD_MODE "quad" or "split" (BarotropicModel.build(..., quad_mode=
    ...), the gaussian IC); one segment of `steps` steps with the
    runner's zero forcing, the launch counters set to 0 just before it
    and read just after."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel, max_stable_dt)
    from xlab_fftbarotropic_torch.ops import fused_fft as ff

    cfg = ModelConfig(nx=n, ny=n)
    if path == "sw-unfused":
        cfg = cfg.replace(dt=min(3.0, max_stable_dt(cfg)))
        m = ShallowWaterModel.build(cfg, "cuda", fused_rk=False)
        s0 = m.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5))
        entry = "ShallowWaterModel(fused_rk=False).segment"
    else:
        mode = path.split("-")[1]
        m = BarotropicModel.build(cfg, "cuda", quad_mode=mode)
        s0 = m.init_state(makefields.gaussian(cfg))
        entry = f"BarotropicModel(quad_mode={mode!r}).segment"
    ff.reset_launches()
    s = m.segment(s0, m.zero_source(), steps)
    torch.cuda.synchronize()
    launches = dict(ff.LAUNCHES)
    check(all(bool(torch.isfinite(torch.view_as_real(z)).all())
              for z in (s if isinstance(s, tuple) else (s,))),
          f"{path} state not finite")
    want = {k: PER_STEP[path].get(k, 0) * steps
            + PER_SEGMENT.get(path, {}).get(k, 0) for k in ff.LAUNCHES}
    log(f"{path} main path: {steps} steps at {n}^2 through {entry}; "
        f"launches {launches}")
    check(launches == want, f"launch counts {launches} != {want}")
    return dict(launches=launches)


@contextlib.contextmanager
def _refusing(targets):
    """Each (module, name) of `targets` raises inside the block."""
    def refuse(*args, **kwargs):
        raise SmokeError("a refused function (a library transform or a "
                         "kernel's plain twin) ran inside a kernel path")

    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    try:
        for mod, name, _ in saved:
            setattr(mod, name, refuse)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _library_functions(keep=()) -> list:
    """(module, name) of every torch.fft function not in `keep`, and
    torch.matmul."""
    return [(torch.fft, k) for k in dir(torch.fft)
            if not k.startswith("_") and callable(getattr(torch.fft, k))
            and k not in keep] + [(torch, "matmul")]


def _refusing_library():
    """torch.fft.* and torch.matmul raise inside the block."""
    return _refusing(_library_functions())


def shard_refused(fft_impl: str) -> list:
    """What must not run in a sharded kernel path's segment: the library
    transposes and every plain twin of the distributed kernels; every
    torch.fft function but rfft/irfft (the y-stage) and, on 'pallas',
    fft/ifft (its x-stage); torch.matmul."""
    from xlab_fftbarotropic_torch.parallel import dfft
    from xlab_fftbarotropic_torch.parallel import fused_overlap as fo
    from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr

    if fft_impl == "xla":
        return []
    keep = {"rfft", "irfft"} | ({"fft", "ifft"} if fft_impl == "pallas"
                                else set())
    return [(dfft, "transpose_to_columns"), (dfft, "transpose_to_rows"),
            (ftr, "a2a_cols_plain"), (ftr, "a2a_rows_plain"),
            (fo, "xstage_plain"), (fo, "xstage_gather_plain"),
            (fo, "xstage_scatter_plain")] + _library_functions(keep)


def phase_sharded(n: int, steps: int, dev, profile: bool) -> dict:
    """Phase 5j's four-shard half: every decomp x impl of
    ShardedBarotropicModel.build(cfg, make_mesh(4, dev), ...) under RK4
    and slab/overlap under ETDRK4 (example 12's nu4, dt = 3 s) at n^2
    for `steps` steps, each segment with the launch counters set to 0
    just before it and read just after, and with shard_refused raising;
    the vorticity against the single-device torch.fft path (rel-L2 <=
    TOL); pallas against xla bit for bit; ms/step of each, in turns with
    the single-device library path and FUSEKB=full with FUSEKX=0; with
    `profile`, torch.profiler breakdowns of the four kernel paths."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.parallel import (ShardedBarotropicModel,
                                                   make_mesh)

    cfg = ModelConfig(nx=n, ny=n)
    ecfg = cfg.replace(time_scheme="etdrk4", nu4=example12_nu4(n))
    v0 = makefields.gaussian(cfg)
    lib = BarotropicModel.build(cfg.replace(fft_backend="xla"), dev)
    elib = BarotropicModel.build(ecfg.replace(fft_backend="xla"), dev)
    z0, src0 = lib.init_state(v0), lib.zero_source()
    ref = {"rk4": lib.diags(lib.segment(z0, src0, steps)).vort,
           "etdrk4": elib.diags(elib.segment(z0, src0, steps)).vort}
    mesh = make_mesh(4, dev)
    runs = {"library": (lib, z0, src0),
            "full-fusekx0": (BarotropicModel.build(cfg, dev, fusekb="full",
                                                   fusekx=False), z0, src0)}
    out = {"main_paths": {}, "trajectories": {}, "time": {}}
    states = {}
    for name in SHARD_MODELS:
        _, decomp, impl, *etd = name.split("-")
        scheme = "etdrk4" if etd else "rk4"
        m = ShardedBarotropicModel.build(ecfg if etd else cfg, mesh, impl,
                                         decomp)
        s0, src = m.init_state(v0), m.zero_source()
        torch.cuda.synchronize()
        ff.reset_launches()
        with _refusing(shard_refused(impl)):
            z = m.segment(s0, src, steps)
            torch.cuda.synchronize()
        launches = dict(ff.LAUNCHES)
        want = {k: PER_STEP.get(name, {}).get(k, 0) * steps
                for k in ff.LAUNCHES}
        log(f"{name} main path: {steps} steps at {n}^2 on 4 shards "
            f"through ShardedBarotropicModel.build(..., {impl!r}, "
            f"{decomp!r}).segment ({scheme}); launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        check(launches == want, f"{name} launch counts {launches} != {want}")
        vort = m.unshard_physical(m.diags(z).vort)
        check(bool(torch.isfinite(vort).all()), f"{name} vort not finite")
        rel = rel_l2(vort, ref[scheme])
        log(f"{name} trajectory: {steps} steps at {n}^2, rel-L2 of vort vs "
            f"the single-device torch.fft library path = {rel:.3e}")
        check(rel <= TOL, f"{name} rel-L2 {rel:.3e} > {TOL}")
        out["main_paths"][name] = dict(launches=launches)
        out["trajectories"][f"{name}_vort_rel_l2"] = rel
        states[name] = z
        runs[name] = (m, s0, src)
    for decomp in SHARD_DECOMPS:
        a, b = (states[f"shard4-{decomp}-{i}"] for i in ("pallas", "xla"))
        same = bool(torch.equal(a, b))
        log(f"shard4-{decomp}: pallas vs xla state after {steps} steps "
            f"bit-identical: {same}")
        check(same, f"shard4-{decomp}: pallas is not xla's bits")
        out["trajectories"][f"shard4-{decomp}_pallas_bit_identical"] = same
    order = list(runs) + list(reversed(list(runs)))
    times = {k: [] for k in runs}
    for k in order:
        m, s0, src = runs[k]
        m.segment(s0, src, 2)                      # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m.segment(s0, src, steps)
        end.record()
        end.synchronize()
        times[k].append(start.elapsed_time(end) / steps)
    for k, ts in times.items():
        ms = sum(ts) / len(ts)
        out["time"][k] = dict(ms_per_step=ms, runs_ms=ts)
        log(f"time sharded {k:27s}: {ms:.3f} ms/step "
            f"({', '.join(f'{t:.3f}' for t in ts)})")
    if profile:
        out["profile"] = {
            name: phase_profile({name: ({"kernels": runs[name][0]},
                                        *runs[name][1:])}, name)
            for name in SHARD_MODELS if "xla" not in name
            and "etdrk4" not in name}
    return out


def phase_adjoint(n: int, dev, profile: bool = False) -> dict:
    """The adjoint main path and its checks (phase 5e); with `profile`
    also the breakdown of a kernel-path gradient per window step."""
    from xlab_fftbarotropic_torch import adjoint
    from xlab_fftbarotropic_torch.cli import assimilate
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.io.fieldio import read_field, write_field
    from xlab_fftbarotropic_torch.ops import fused_fft as ff

    w = ADJ_WINDOW
    cfg = ModelConfig(nx=n, ny=n)
    truth = torch.from_numpy(makefields.gaussian(cfg)).to(dev)
    src = torch.zeros(cfg.grid_shape, device=dev)
    with torch.no_grad():
        target = adjoint.make_rollout(cfg, w, device=dev)(truth, src)
    guess = 0.9 * truth
    out = {}
    with tempfile.TemporaryDirectory(prefix="xfb_smoke_adj_") as tmp:
        tmp = Path(tmp)
        write_field(tmp / "target.bin", target.cpu().numpy())
        write_field(tmp / "guess.bin", guess.cpu().numpy())
        ff.reset_launches()
        t0 = time.perf_counter()
        rc = assimilate.main([
            "--nx", str(n), "--ny", str(n), "--target",
            str(tmp / "target.bin"), "--guess", str(tmp / "guess.bin"),
            "--out", str(tmp / "rec.bin"), "--steps", str(w), "--iters",
            str(ADJ_ITERS), "--lr", repr(ADJ_LR), "--device", "cuda"])
        wall = time.perf_counter() - t0
        launches = dict(ff.LAUNCHES)
        check(rc == 0, f"cli.assimilate.main returned {rc}")
        losses = np.loadtxt(tmp / "rec.bin.loss.txt")
        rec = torch.from_numpy(read_field(tmp / "rec.bin",
                                          cfg.grid_shape)).to(dev)
    # the initial cost and the last one are forward-only rollouts
    want = {**dict.fromkeys(ff.LAUNCHES, 0),
            **adjoint_launches(w, gradients=ADJ_ITERS, forwards=2)}
    ratio = float(losses[-1] / losses[0])
    err = rel_l2(rec, truth) / rel_l2(guess, truth)
    log(f"adjoint main path: the twin experiment at {n}^2 (window {w}, "
        f"guess 0.9 x truth), {ADJ_ITERS} Adam iterations at lr {ADJ_LR} "
        f"through cli.assimilate.main in {wall:.2f} s; cost "
        f"{losses[0]:.6e} -> {losses[-1]:.6e} (ratio {ratio:.4e}), IC "
        f"error {err:.4f} of the first guess's; launches {launches}")
    check(launches == want, f"adjoint launch counts {launches} != {want}")
    check(bool(np.isfinite(losses).all()) and losses.shape == (
        ADJ_ITERS + 1,), f"cost history {losses}")
    check(losses[-1] < losses[0], f"the cost did not fall: {losses}")
    check(bool(torch.isfinite(rec).all()), "recovered IC not finite")
    check("jax" not in sys.modules, "a jax module was imported")
    out.update(launches=launches, cli_wall_s=wall, losses=losses.tolist(),
               cost_ratio=ratio, ic_error_ratio=err)

    # the gradient at the first guess, kernels against torch.fft
    losses_fn = {b: adjoint.final_state_misfit(
        cfg.replace(fft_backend=b), target, w, device=dev)
        for b in ("pallas", "xla")}
    vg = {b: adjoint.loss_and_grad(f, device=dev)
          for b, f in losses_fn.items()}
    with _refusing_library():
        val_k, grad_k = vg["pallas"](guess, src)
        torch.cuda.synchronize()
    val_l, grad_l = vg["xla"](guess, src)
    rel = rel_l2(grad_k, grad_l)
    log(f"adjoint gradient at {n}^2, window {w}: kernels vs torch.fft "
        f"rel-L2 {rel:.3e} (cost {float(val_k):.6e} vs {float(val_l):.6e});"
        f" the kernel path's loss and backward() ran with torch.fft.* and "
        f"torch.matmul raising")
    check(bool(torch.isfinite(grad_k).all()), "kernel gradient not finite")
    check(rel <= 5e-4, f"adjoint gradient kernels vs library {rel:.3e}")
    out["grad_rel_l2"] = rel

    # time: forward ms per step (no graph), gradient ms per window step,
    # peak memory of a gradient, in turns
    rolls = {b: adjoint.make_rollout(cfg.replace(fft_backend=b), w,
                                     device=dev) for b in ("pallas", "xla")}
    times = {b: {"fwd": [], "grad": []} for b in rolls}
    peak = {}
    for b in ("pallas", "xla", "xla", "pallas"):
        with torch.no_grad():
            rolls[b](guess, src)                    # warm-up
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rolls[b](guess, src)
            end.record()
            end.synchronize()
        times[b]["fwd"].append(start.elapsed_time(end) / w)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start.record()
        vg[b](guess, src)
        end.record()
        end.synchronize()
        times[b]["grad"].append(start.elapsed_time(end) / w)
        peak[b] = torch.cuda.max_memory_allocated() - base
    names = {"pallas": "kernels", "xla": "library"}
    for b, ts in times.items():
        fwd = sum(ts["fwd"]) / len(ts["fwd"])
        grad = sum(ts["grad"]) / len(ts["grad"])
        log(f"time adjoint {names[b]:8s}: forward {fwd:.3f} ms/step "
            f"({', '.join(f'{t:.3f}' for t in ts['fwd'])}), gradient "
            f"{grad:.3f} ms per window step ("
            f"{', '.join(f'{t:.3f}' for t in ts['grad'])}; "
            f"{grad / fwd:.2f}x the forward), peak device memory of a "
            f"gradient {peak[b] / 2**20:.1f} MiB above what was resident")
        out[f"time_{names[b]}"] = dict(fwd_ms_per_step=fwd,
                                       grad_ms_per_step=grad,
                                       fwd_runs=ts["fwd"],
                                       grad_runs=ts["grad"],
                                       peak_bytes=peak[b])
    if profile:
        out["profile"] = profile_run("adjoint-gradient",
                                     lambda: vg["pallas"](guess, src), w)
    return out


def build_models(n: int, dev) -> dict:
    """The paths compared and timed, with their initial state and
    forcing: bench.py's barotropic, tracer, shallow-water (fused and
    unfused RK4) and sw-etdrk4 configurations, the barotropic (example
    12's hyperviscosity, dt = 3 s) and tracer ETDRK4 paths, shallow
    water with drag and hyperviscosity (the per-transform kernels), and
    the x-first order of the barotropic (RK4, ETDRK4, quad and split) and
    shallow-water (RK4, ETDRK4) paths, each group beside its y-first
    kernel path ("yfirst"; quad and split also beside the x-first
    ka_diag form, "xfirst"). The ETD tables are built on the card (the
    cache is off here). The barotropic RK4 and ETDRK4 groups also hold
    the fusion arms (BT_ARMS, BTE_ARMS)."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel, max_stable_dt)
    from xlab_fftbarotropic_torch.models.tracer import TracerModel, tracer_ic

    cfg = ModelConfig(nx=n, ny=n)
    lib = cfg.replace(fft_backend="xla")
    v0 = makefields.gaussian(cfg)
    bt = {"kernels": BarotropicModel.build(cfg, dev),
          "unfused": BarotropicModel.build(cfg, dev, fused_rk=False),
          "library": BarotropicModel.build(lib, dev)}
    tr = {"kernels": TracerModel.build(cfg, dev, kappa=50.0),
          "library": TracerModel.build(lib, dev, kappa=50.0)}
    sw_dt = min(3.0, max_stable_dt(cfg))
    sw = {"kernels": ShallowWaterModel.build(cfg.replace(dt=sw_dt), dev),
          "unfused": ShallowWaterModel.build(cfg.replace(dt=sw_dt), dev,
                                             fused_rk=False),
          "library": ShallowWaterModel.build(lib.replace(dt=sw_dt), dev)}
    swd_cfg = cfg.replace(dt=min(sw_dt, SW_DRAG_DT_MAX), r_drag=SW_R_DRAG,
                          nu4=example12_nu4(n))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the per-transform warning
        swd = {"kernels": ShallowWaterModel.build(swd_cfg, dev),
               "library": ShallowWaterModel.build(
                   swd_cfg.replace(fft_backend="xla"), dev)}
    check(swd["kernels"].per_transform, "SW drag: not the per-transform "
                                        "path")
    swe_cfg = cfg.replace(time_scheme="etdrk4", dt=SW_ETD_DT)
    swe = {"kernels": ShallowWaterModel.build(swe_cfg, dev),
           "unfused": ShallowWaterModel.build(swe_cfg, dev, etd_fuse=False),
           "library": ShallowWaterModel.build(
               swe_cfg.replace(fft_backend="xla"), dev)}
    bte_cfg = cfg.replace(time_scheme="etdrk4", nu4=example12_nu4(n))
    bte = {"kernels": BarotropicModel.build(bte_cfg, dev),
           "library": BarotropicModel.build(
               bte_cfg.replace(fft_backend="xla"), dev)}
    tre_cfg = cfg.replace(time_scheme="etdrk4")
    tre = {"kernels": TracerModel.build(tre_cfg, dev, kappa=50.0),
           "library": TracerModel.build(tre_cfg.replace(fft_backend="xla"),
                                        dev, kappa=50.0)}
    for name, arm in BT_ARMS.items():
        bt[name] = BarotropicModel.build(cfg, dev, bt["kernels"].tables, **arm)
    for name, arm in BTE_ARMS.items():
        bte[name] = BarotropicModel.build(bte_cfg, dev, bte["kernels"].tables,
                                          **arm)
    xbt = {"kernels": BarotropicModel.build(cfg, dev, yfirst=False),
           "yfirst": bt["kernels"], "library": bt["library"]}
    quad = {mode: {"kernels": BarotropicModel.build(cfg, dev,
                                                    quad_mode=mode),
                   "xfirst": xbt["kernels"], "yfirst": bt["kernels"],
                   "library": bt["library"]} for mode in ("quad", "split")}
    xbte = {"kernels": BarotropicModel.build(bte_cfg, dev, yfirst=False),
            "yfirst": bte["kernels"], "library": bte["library"]}
    xsw = {"kernels": ShallowWaterModel.build(cfg.replace(dt=sw_dt), dev,
                                              yfirst=False),
           "yfirst": sw["kernels"], "library": sw["library"]}
    xswe = {"kernels": ShallowWaterModel.build(swe_cfg, dev, yfirst=False),
            "yfirst": swe["kernels"], "library": swe["library"]}
    groups = (bt, tr, sw, swe, bte, tre, swd, xbt, *quad.values(), xbte,
              xsw, xswe)
    for m in (p[k] for p in groups for k in p if k != "library"):
        check(m.backend == "pallas", f"backend {m.backend}, not pallas")
    for m in (p["kernels"] for p in (xbt, *quad.values(), xbte, xsw, xswe)):
        check(not m.yfirst, "an x-first path runs the y-first order")
    check(all(p["library"].backend == "xla" for p in groups),
          "library backend selection")
    k = bt["kernels"]
    q0 = tracer_ic(cfg, "gaussian")
    # shallow water as bench.py drives it: the balanced weak vortex, no
    # forcing (src None: the forcing spectrum is skipped)
    sw0 = sw["kernels"].geostrophic_init(makefields.gaussian(cfg,
                                                             zeta0=1e-5))
    return {"barotropic": (bt, k.init_state(v0), k.zero_source()),
            "tracer": (tr, tr["kernels"].init_state(v0, q0),
                       k.zero_source()),
            "shallow-water": (sw, sw0, None),
            "sw-etdrk4": (swe, sw0, None),
            # as the runner drives it: the zero forcing field
            "sw-drag": (swd, sw0, k.zero_source()),
            "barotropic-etdrk4": (bte, k.init_state(v0), k.zero_source()),
            "tracer-etdrk4": (tre, tr["kernels"].init_state(v0, q0),
                              k.zero_source()),
            "barotropic-xfirst": (xbt, k.init_state(v0), k.zero_source()),
            "bt-quad": (quad["quad"], k.init_state(v0), k.zero_source()),
            "bt-split": (quad["split"], k.init_state(v0), k.zero_source()),
            "barotropic-etdrk4-xfirst": (xbte, k.init_state(v0),
                                         k.zero_source()),
            "sw-xfirst": (xsw, sw0, None),
            "sw-xfirst-etdrk4": (xswe, sw0, None)}


def phase_no_library(n: int, models: dict) -> None:
    out = {}
    with _refusing_library():
        for family, (paths, s0, src) in models.items():
            for k in ("kernels", *BT_ARMS):
                if k in paths:
                    name = family if k == "kernels" else f"{family}-{k}"
                    out[name] = paths[k].segment(s0, src, 2)
        torch.cuda.synchronize()
    for family, s in out.items():
        for z in (s if isinstance(s, tuple) else (s,)):
            check(bool(torch.isfinite(torch.view_as_real(z)).all()),
                  f"{family} kernel-path state not finite")
    log(f"no library transform: 2 steps of each of {sorted(out)} at "
        f"{n}^2 ran with torch.fft.* and torch.matmul raising")


def rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def phase_trajectories(n: int, steps: int, models: dict) -> dict:
    """Physical fields after `steps` steps of every path, held against
    the library path (and the fused against the unfused form)."""
    out = {}
    for family, (paths, s0, src) in models.items():
        if family in SW_FAMILIES:
            out.update(sw_trajectory(family, n, steps, paths, s0, src))
            continue
        states = {k: m.segment(s0, src, steps) for k, m in paths.items()}
        diags = {k: paths[k].diags(z) for k, z in states.items()}
        names = ("vort", "q") if family.startswith("tracer") else ("vort",)
        for k, d in diags.items():
            for name in names:
                check(bool(torch.isfinite(getattr(d, name)).all()),
                      f"{family} {k} {name} not finite")
        for k in paths:
            if k == "library":
                continue
            for name in names:
                rel = rel_l2(getattr(diags[k], name),
                             getattr(diags["library"], name))
                log(f"{family} trajectory: {steps} steps at {n}^2, rel-L2 "
                    f"of {name}, {k} vs torch.fft library path = {rel:.3e}")
                check(rel <= TOL, f"{family} {k} {name} rel-L2 {rel:.3e} "
                                  f"> {TOL}")
                out[f"{family}_{k}_{name}_rel_l2"] = rel
        for ref in ("yfirst", "xfirst"):
            if ref not in paths:
                continue
            rel = rel_l2(diags["kernels"].vort, diags[ref].vort)
            log(f"{family} trajectory: {steps} steps at {n}^2, rel-L2 of "
                f"vort, kernels vs the {ref} kernel path = {rel:.3e}")
            check(rel <= TOL, f"{family} vs {ref} rel-L2 {rel:.3e} > {TOL}")
            out[f"{family}_kernels_vs_{ref}_vort_rel_l2"] = rel
        for k in (k for k in BT_ARMS if k in paths):
            ref = BT_ARM_REF.get(k, "kernels")
            same = bool(torch.equal(states[k], states[ref]))
            rel = rel_l2(diags[k].vort, diags[ref].vort)
            log(f"{family} trajectory: {steps} steps at {n}^2, fusion arm "
                f"{k} vs the default arm ({ref}): bit-identical {same}, "
                f"rel-L2 of vort {rel:.3e}")
            check(same, f"{family} fusion arm {k}: not the bits of {ref} "
                        f"(rel-L2 {rel:.3e})")
            out[f"{family}_{k}_bit_identical"] = same
        if "unfused" in paths:
            a, b = diags["kernels"].vort, diags["unfused"].vort
            rel = rel_l2(a, b)
            same = bool(torch.equal(a, b))
            log(f"barotropic fused-RK vs unfused form: rel-L2 {rel:.3e}, "
                f"bit-identical: {same}")
            check(rel <= TOL, f"fused vs unfused rel-L2 {rel:.3e} > {TOL}")
            out["barotropic_fused_vs_unfused"] = dict(rel_l2=rel,
                                                      bit_identical=same)
    return out


def sw_errors(got, want, n: int) -> dict:
    """Max abs error of zeta, div and eta = h - H in physical space over
    the norms of the JAX package's _assert_close_phys (max |zeta|,
    max(|div|, |zeta|), max |eta| of `want`), and the rel-L2 of each."""
    a = [torch.fft.irfft2(z, s=(n, n)) for z in got]
    b = [torch.fft.irfft2(z, s=(n, n)) for z in want]
    nz = float(b[0].abs().max())
    norms = (nz, max(float(b[1].abs().max()), nz), float(b[2].abs().max()))
    out = {}
    for name, x, y, m in zip(("vort", "div", "eta"), a, b, norms):
        check(bool(torch.isfinite(x).all()), f"shallow-water {name} not "
                                             f"finite")
        out[name] = dict(max_abs_err=float((x - y).abs().max()) / m,
                         rel_l2=rel_l2(x, y))
    return out


def sw_trajectory(family: str, n: int, steps: int, paths: dict, s0,
                  src) -> dict:
    """The SW kernel path against its library path (and an unfused form
    or the y-first order against the kernel path) after one step and
    after `steps` steps, at the JAX package's bars for its two SW
    paths."""
    out = {}
    for k, bar in ((1, SW_TOL_ONE_STEP), (steps, SW_TOL)):
        got = paths["kernels"].segment(s0, src, k)
        for other in ("library", "unfused", "yfirst"):
            if other not in paths:
                continue
            errs = sw_errors(got, paths[other].segment(s0, src, k), n)
            for name, e in errs.items():
                log(f"{family} trajectory: {k} steps at {n}^2, {name} "
                    f"kernels vs {other}: max abs err / norm = "
                    f"{e['max_abs_err']:.3e}, rel-L2 {e['rel_l2']:.3e}")
                check(e["max_abs_err"] <= bar,
                      f"{family} {name} after {k} steps, kernels vs "
                      f"{other}: {e['max_abs_err']:.3e} > {bar}")
            key = "" if other == "library" else f"_vs_{other}"
            out[f"{family}_kernels{key}_{k}_steps"] = errs
    return out


def phase_time(n: int, steps: int, models: dict) -> dict:
    """ms/step of every path from CUDA events over a `steps`-step segment
    after a 2-step warm-up, in turns (A B C C B A), with the peak device
    memory (of the whole process: every model built here is resident)
    and the segment's own part of it (the peak less what was allocated
    before the segment)."""
    out = {}
    for family, (paths, s0, src) in models.items():
        order = list(paths) + list(reversed(list(paths)))
        times = {k: [] for k in paths}
        peak, own = {}, {}
        for k in order:
            m = paths[k]
            m.segment(s0, src, 2)                  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m.segment(s0, src, steps)
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / steps)
            peak[k] = torch.cuda.max_memory_allocated()
            own[k] = peak[k] - base
        for k, ts in times.items():
            ms = sum(ts) / len(ts)
            out[f"{family}_{k}"] = dict(ms_per_step=ms, runs_ms=ts,
                                        gp_per_s=n * n / (ms * 1e-3),
                                        peak_bytes=peak[k],
                                        segment_bytes=own[k])
            runs = ", ".join(f"{t:.3f}" for t in ts)
            log(f"time {family:13s} {k:8s}: {ms:.3f} ms/step ({runs}), "
                f"{n * n / (ms * 1e-3):.4e} grid-points/s, peak device "
                f"memory {peak[k] / 2**20:.1f} MiB (the segment's own "
                f"{own[k] / 2**20:.1f} MiB)")
    return out


def phase_tables(n: int, dev) -> dict:
    """The ETD tables: build time on the card at n^2 with the cache off
    (the SW 3x3 stack at bench.py's dt = 7.5 s, the barotropic one with
    example 12's hyperviscosity at dt = 3 s, the tracer one at kappa =
    50), and the card-built tables against the CPU-built ones at 256^2."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.models import etdrk4 as etd

    tables = {
        "sw": lambda c, d: etd.build_tables_stack(c, SW_ETD_DT, d),
        "barotropic": lambda c, d: etd.build_scalar_tables_stack(
            c.replace(nu4=example12_nu4(c.nx)), 3.0, "barotropic", 0.0, d),
        "tracer": lambda c, d: etd.build_scalar_tables_stack(
            c, 3.0, "tracer", 50.0, d),
    }
    out = {}
    for kind, build in tables.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stack = build(ModelConfig(nx=n, ny=n), dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        size = nbytes([stack])
        del stack
        small = ModelConfig(nx=256, ny=256)
        got = build(small, dev).cpu()
        want = build(small, torch.device("cpu"))
        rel = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(got, want))
        same = bool(torch.equal(got, want))
        log(f"ETD tables {kind:10s}: built on the card at {n}^2 in "
            f"{secs:.3f} s ({size / 2**20:.1f} MiB); at 256^2 card vs CPU "
            f"max |d| / max = {rel:.3e}, bit-identical: {same}")
        check(rel <= 1e-6, f"{kind} ETD tables: card vs CPU {rel:.3e}")
        out[kind] = dict(build_s=secs, bytes=size, card_vs_cpu=rel,
                         bit_identical=same)
    return out


def kernel_functions() -> list:
    """The names of the port's __global__ functions, read from csrc/."""
    from xlab_fftbarotropic_torch.ops import _build
    return sorted({m for f in _build.CSRC.glob("*.cu") for m in re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
        f.read_text())})


def phase_profile(models: dict, family: str, path: str = "kernels",
                  steps: int = 5) -> dict:
    """Where a kernel path's time goes: a torch.profiler trace of `steps`
    steps of a family's path, device time per step by kernel (the port's
    by name, the rest lumped as torch elementwise), and the device's busy
    share of the synchronized wall time (profiler on)."""
    paths, s0, src = models[family]
    m = paths[path]
    family = family if path == "kernels" else f"{family}-{path}"
    m.segment(s0, src, 1)
    torch.cuda.synchronize()
    return profile_run(family, lambda: m.segment(s0, src, steps), steps)


def profile_run(family: str, run, steps: int) -> dict:
    """The breakdown of phase_profile for any work: run() traced once,
    device time per step (of `steps`) by kernel and the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = kernel_functions()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_step, calls = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        # demangled ("...::ka_kernel(...") or mangled ("...9ka_kernelE...")
        name = next((k for k in names
                     if re.search(rf"(\b|\d){k}(\b|E)", e.name)),
                    "cuFFT" if re.search("fft|radix", e.name, re.I)
                    else "torch elementwise")
        us = e.time_range.elapsed_us()
        per_step[name] = per_step.get(name, 0.0) + us / 1e3 / steps
        calls[name] = calls.get(name, 0) + 1
    busy = sum(per_step.values()) * steps / (wall * 1e3)
    for name, ms in sorted(per_step.items(), key=lambda kv: -kv[1]):
        log(f"profile {family} kernels: {name:22s} {ms:8.3f} ms/step "
            f"({calls[name] / steps:.0f} launches/step)")
    log(f"profile {family} kernels: device busy {100.0 * busy:.1f} % of "
        f"{wall * 1e3 / steps:.3f} ms/step (profiler on)")
    return dict(ms_per_step=per_step, launches=calls, busy=busy,
                wall_ms_per_step=wall * 1e3 / steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096,
                    help="grid size of the main path (default 4096)")
    ap.add_argument("--steps", type=int, default=20,
                    help="steps of the main path and trajectory (even)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the full report as JSON to PATH")
    ap.add_argument("--profile", action="store_true",
                    help="also trace the y-first barotropic (default and "
                    "FUSEKB=full), tracer (RK4 and ETDRK4), SW RK4 and "
                    "ETDRK4, the SW drag, "
                    "the x-first barotropic and SW RK4, the adjoint "
                    "gradient and the sharded kernel paths with "
                    "torch.profiler (the breakdown of where their time "
                    "goes)")
    args = ap.parse_args(argv)
    check(args.steps >= 2 and args.steps % 2 == 0, "--steps must be even")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device visible (torch.cuda."
                 "is_available() is False)")
    import_port()
    from xlab_fftbarotropic_torch.ops import _build

    # ETD tables are built on the card; only the ETD main path caches them
    # (in its own temporary directory)
    os.environ["XFB_ETD_CACHE"] = "0"
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
    report["xtile"] = phase_xtile(args.n)
    report["kernels"] = phase_kernels(args.n, dev)
    report["main_paths"] = {family: phase_main_path(family, args.n,
                                                    args.steps)
                            for family in CLI_FAMILIES}
    for path in MODEL_PATHS:
        report["main_paths"][path] = phase_model_path(path, args.n,
                                                      args.steps)
    report["main_paths"]["adjoint"] = phase_adjoint(args.n, dev,
                                                    args.profile)
    report["sharded"] = phase_sharded(args.n, args.steps, dev, args.profile)
    report["main_paths"].update(report["sharded"]["main_paths"])
    report["etd_tables"] = phase_tables(args.n, dev)
    models = build_models(args.n, dev)
    phase_no_library(args.n, models)
    report["trajectories"] = phase_trajectories(args.n, args.steps, models)
    report["time"] = phase_time(args.n, args.steps, models)
    if args.profile:
        report["profile"] = {f: phase_profile(models, f)
                             for f in ("barotropic", "tracer",
                                       "tracer-etdrk4",
                                       "shallow-water", "sw-etdrk4",
                                       "sw-drag", "barotropic-xfirst",
                                       "sw-xfirst")}
        report["profile"]["barotropic-full"] = phase_profile(
            models, "barotropic", "full")
        report["profile"]["adjoint-gradient"] = (
            report["main_paths"]["adjoint"]["profile"])
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))

    rows = []
    for name, (src, rep, key, paths) in KERNELS.items():
        launches = sum(report["main_paths"][p]["launches"][key]
                       for p in paths)
        check(launches > 0, f"{name} never launched on its main path")
        k = report["kernels"][name]
        rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         launches=launches, max_abs_err=k["max_abs_err"],
                         ms=k["ms"], plain_ms=k["plain_ms"],
                         bound_ms=k["bound_ms"], bound_by=k["bound_by"],
                         library_ms=k["library_ms"]))
    check(all(math.isfinite(r["ms"]) for r in rows), "kernel times")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
