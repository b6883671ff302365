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
   8 too; each timed at n^2 with CUDA events (the a2a transposes also
   as the bare launch, into an output and shard pointers made once,
   beside the timing through the wrapper). First the column-tile
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
5k. Example 02's post-processing pipeline at n^2 through the commands'
   main functions: cli.makefield (kuo2004); cli.vort_src_input in its
   own process (jax unimportable in it) writing the forcing protocol
   into a FIFO that cli.run reads (-f) for 20 steps at half the RK4
   advective bound of the Kuo2004 core (printed), psi recorded every
   10 steps, with the barotropic launches exact; cli.invert_pres on the
   psi records with torch.fft.* and torch.matmul raising and exactly 6
   ka, 3 kb and 2 kc launches per inverted field; cli.find_min --tracks
   on the pressure files (30 minima lines each, at least one track);
   the pressure within rel-L2 1e-5 of the torch.fft path's on the same
   psi with the same deepest minimum; ms per inverted field on both
   paths and of find_min_n; no jax module loaded.
5l. The diagnostics at n^2: phase 3's run once more with its vort
   records kept (its launches exact), the records through
   cli.diagnose.main with all five -d, on the kernels with torch.fft.*
   and torch.matmul raising (exactly 16 ka, 7 kb and 2 kc per field)
   and with --fft-backend xla (none); the kernels' outputs against the
   library's: Okubo-Weiss rel-L2 <= 1e-5; the deformation factor and the
   filamentation time where they are conditioned (their first-order
   round-off bounds in the largest velocity gradient, DIAG_COND); E(k),
   Z(k) per shell and in sum; the kappa_ratio profile per bin; the
   filamentation medians within DIAG_MEDIAN_TOL, the share of cells
   whose finite mask flips printed; ms per diagnosed field on both
   paths (with --profile their breakdowns).
5m. The finite-difference core: cli.run.main -m fd at n^2 for `steps`
   steps from the same IC (no kernel launch: its Poisson solve is
   torch.fft by design), records finite, its rel-L2 against the spectral
   run printed (an O(dx^2) difference, no bound), ms per FD step; at
   256^2 the card's state after 2 steps against the CPU's for both
   solvers, rel-L2 <= 1e-5, and the Jacobi sweep counts (per solve, and
   of the relaxation alone on a wave's Laplacian at three tolerances)
   within one of the CPU's.
5n. The ensemble: cli.run.main --ensemble 4 --ensemble-amp 0
   --ensemble-width 1 at n^2, every member's records byte-identical to
   the solo run's and the plane stepper's launches exactly 4 times its
   per step; --ensemble-amp 0.02, records in m00..m03 and a nonzero
   spread at each record; at 256^2 one batched chunk of 8 on torch.fft,
   member 0 within rel-L2 1e-6 of the solo library run; a --profile-dir
   run at 256^2 for 4 steps whose trace names ka_diag.
5o. Fast mode (--fast-transforms): the fast forms of ka_diag, kb_pair,
   kb_adv_half and kx_visc (csrc/xtile.cuh FAST: bf16 tensor-core
   radix-16 sub-DFT passes) against their plain versions, bit for bit
   on exact-arithmetic inputs (small integers whose tensor-core sums are
   exact) and within rel-L2 1e-4 on random ones, and against the strict
   kernels within rel-L2 1e-4 .. 1e-2, at 64^2, 256^2, n^2, 256 x 200
   and 1024 x 33; each timed at n^2 beside its bound (its float32 bytes,
   or its bf16 products over 989 TFLOP/s plus its float32 rest), its
   plain version, the strict kernel and one torch.fft call; the CLI's
   --fast-transforms run (exactly 4 of each fast form and 1 rk4_combine
   per step); bench.py's barotropic configuration through
   BarotropicModel.build(..., fast=True) with torch.fft.* and
   torch.matmul raising, its vorticity within rel-L2 1e-4 (and above
   1e-7) of the strict kernel path after 30 steps and within 1e-3 after
   200, finite; ms/step beside the strict FUSEKB=half arm and the strict
   default, in turns. Shallow water (phase_fast_sw): the fast forms of
   ka_sw, ky_all and kx_fwd (its bf16 and float32 product stores) held
   as above, the bf16 store the rounding of the float32 store's bits;
   the strict tile's bf16 store and sw_combine and sw_combine_mv on
   bf16 product spectra bit for bit their float32 forms (on the upcast
   products), each timed at n^2 beside its bound, plain version, strict
   form and torch call; the CLI's -m sw --fast-transforms runs, RK4 and
   --time-scheme etdrk4 (exactly 4 ka_sw_fast, 8 kb_pair_fast, 4
   ky_all_fast, 4 kx_fwd_fast and 4 sw_combine_bf16 with 1 rk4_combine,
   or 4 sw_combine_mv_bf16, per step), the fast float32 store and the
   strict bf16 store through ShallowWaterModel.build; bench.py's SW
   configuration through ShallowWaterModel.build(..., fast=True) with
   torch.fft.* and torch.matmul raising: zeta and eta within rel-L2
   2e-4 and 2e-3 of the strict kernel path after 20 RK4 steps, 2e-3
   and 5e-3 after 200, 1e-3 and 5e-3 after 20 ETDRK4 steps at dt
   7.5 s, each above 1e-7, div's printed; eta's error larger without
   the split-linear formulation; the float32 store within the 20-step
   bars; the unfused RK form bit for bit; ms/step of the fast and strict
   RK4 and ETDRK4 paths, in turns. The tracer and the other barotropic
   arms (phase_fast_arms): the fast forms of ka6, kb_adv_tracer, the
   stacked kx_visc, ky_adv, kb_adv_full, kx_visc_tail, the one-field
   kx_fwd and kx_visc's "none" form (nu = 0, ETDRK4's N) held and timed
   as above; the CLI's -m tracer --fast-transforms runs (RK4 and
   ETDRK4: exactly 4 ka6_fast, 8 kb_pair_fast, 4 kb_adv_tracer_fast and
   4 kx_visc_fast per step, and 1 rk4_combine under RK4), the
   barotropic fast ETDRK4 run and the five arm runs (XFB_BT_FUSEKB=0,
   full, XFB_BT_FUSEKX=0, XFB_BT_FUSETAIL=1, XFB_BT_FUSED_RK=0), exact
   launches; bench.py's tracer configuration through
   TracerModel.build(..., fast=True) with torch.fft.* and torch.matmul
   raising, zeta and q each within rel-L2 1e-4 of the strict kernel
   path after 30 RK4 steps, 1e-3 after 200 and 1e-3 after 20 ETDRK4
   steps, each above 1e-7; barotropic fast ETDRK4 within 1e-3 after 20
   steps; every barotropic fast arm (RK4: FUSEKB "" and full,
   FUSEKX=0, FUSETAIL, unfused; ETDRK4: FUSEKB "" and full) bit for bit
   the fast half arm of its scheme after 3 steps; ms/step of each new
   path beside its strict counterpart, in turns.
5p. Fast mode on the x-first order (phase_fast_xfirst): the CLI's
   --fast-transforms runs with XFB_BT_YFIRST=0 (RK4 and ETDRK4: exactly
   4 ka_diag_fast, 8 kb_fast, 4 ka_adv_fast and 4 kc_visc_fast per
   step) and XFB_SW_YFIRST=0 (4 ka_sw_fast, 8 kb_fast, 4 ka_fwd_fast, 4
   kc_sw_fast and the float32 sw_combine with 1 rk4_combine, or
   sw_combine_mv, per step), QUAD_MODE quad and split through
   BarotropicModel.build(..., fast=True) (4 or 8 ka_quad_fast); with
   torch.fft.* and torch.matmul raising, bench.py's barotropic
   configuration x-first in fast mode (ka_diag and quad) within rel-L2
   1e-4 after 30 RK4 steps, 1e-3 after 200 and 1e-3 after 20 ETDRK4
   steps of the strict x-first kernel path (quad: strict quad; above
   1e-7) and of the y-first fast path, split bit for bit quad; the
   SW configurations x-first in fast mode (split-linear, the float32
   product store) within FAST_SW_BARS' 20-step RK4 and ETDRK4 bars of
   the strict x-first kernel path and of the y-first fast path; ms/step
   of each beside its strict x-first path, in turns; the fast forms of
   ka_quad (quad and split), the x-major kb, ka_adv, kc_visc, ka_fwd and
   kc_sw held to their plain versions and strict kernels as in 5o and
   timed at n^2. The script's total wall time is printed before the
   JSON lines.
5r. The sharded shallow-water and tracer families (phase_sharded_families):
   --shard -m sw (slab, overlap) and --shard -m tracer (x-pencil,
   pallas) through cli.run.main on one shard, records finite, launches
   exact per step and per record; ShardedShallowWaterModel and
   ShardedTracerModel.build(cfg, make_mesh(4, dev), ...) at n^2 for
   `steps` steps, every decomp x impl under RK4, slab/overlap under
   ETDRK4 and slab and x-pencil overlap in fast mode, with shard_refused
   raising: exact launches (SW 40 transforms a step, the tracer 32:
   shard_transform_launches), the fields within rel-L2 1e-5 of the
   single-device torch.fft path (unpaired for SW; SW div's max abs error
   over max(|div|, |zeta|)), pallas bit for bit xla, the fast paths
   within FAST_SHARD_FAMILY_BARS of the strict overlap path; ms/step of
   each in turns with the single-device library and kernel paths;
   make_sharded_rollout's gradient at 1024^2 against the single-device
   gradient (max |d| <= 1e-5 of its max). `--phase 5r` runs the
   toolchain phase and this phase alone.
5s. The 2-D pencil decomposition (phase_pencil; xla only, no kernel):
   --shard --decomp pencil for the barotropic, SW and tracer families
   through cli.run.main on the 1x1 mesh at 256^2, records finite and
   within rel-L2 1e-6 of the one-shard slab run's (bit for bit or not,
   printed); the three families on make_pencil_mesh((2, 2)) at n^2 for
   `steps` steps (RK4; SW and barotropic also ETDRK4) from the
   single-device library state, with the launch counters still and
   every kernel's plain twin and the slab's library transposes raising:
   against the x-pencil xla model at P = 4 (bit for bit or not, and the
   max difference, printed) and within rel-L2 1e-5 of the single-device
   torch.fft path (SW unpaired; div's max abs error over max(|div|,
   |zeta|)); the barotropic model on the (1, 4), (4, 1) and (2, 4)
   meshes at 256^2 (the last pads hny = 129 to 136); make_sharded_rollout
   (decomp="pencil") on (2, 2) at SHARD_ROLLOUT_N^2, its gradient against
   the single-device library gradient (max |d| <= 1e-5 of its max);
   ms/step of each family on (2, 2) in turns with the x-pencil xla and
   slab overlap models at P = 4. `--phase 5s` runs the toolchain phase
   and this phase alone.
5t. The one-process-per-card executor (phase_ranks): RANKS processes
   (rank_worker, this script with --rank-worker, on the XFB_* contract;
   gloo when they share the card, NCCL with a card each) run RANK_CASES
   for RANK_STEPS steps: the barotropic slab pallas and overlap at n^2,
   the overlap fast, SW x-pencil overlap, tracer slab pallas and the
   barotropic 2x2 pencil (xla) at RANK_SMALL_N^2. Each against the
   stacked model at P = RANKS in this process: the gathered state bit
   for bit, each rank's launches exactly the stacked model's, rank 0's
   torch.profiler trace holding its kernels with its own grid only (a2a
   runs of its shard, xstage tiles of its columns); the slowest rank's
   ms/step beside the stacked model's, the host barriers' share of the
   wall, and whether gloo's all_to_all_single takes CUDA tensors. Then
   adjoint.make_sharded_rollout over the ranks (RANK_ROLLOUTS: the slab
   and x-pencil on make_mesh(None), the 2x2 pencil; xla) at
   SHARD_ROLLOUT_N^2 for SHARD_ROLLOUT_STEPS steps from numpy-seeded
   inputs, every rank running the backward sweep of its part of a
   final-state misfit: the gathered value bit for bit the stacked
   rollout's at P = RANKS in this process, the gathered gradients wrt
   vort0 and src bit for bit or within max |d| <= RANK_GRAD_BAR of its
   max (printed which), within SHARD_ROLLOUT_BAR of the single-device
   library gradient, each rank's zero off its own shard, and the slowest
   rank's ms per gradient window step beside the stacked one's. Every
   rank is ended once one fails. `--phase 5t` runs the toolchain phase
   and this phase alone.
5u. Reference parity on the card (phase_parity): the barotropic kernel
   path, strict and y-first, in its default arm and FUSEKB=full (exact
   launches), from the gaussian IC at PARITY_N^2 for PARITY_STEPS RK4
   steps against the port's numpy oracle (oracle/reference_cpu.py, the
   transcription of the reference code) on the same IC: rel-L2 of the
   physical vorticity < PARITY_BAR; the library path's printed.
   `--phase 5u` runs the toolchain phase and this phase alone.
5v. The fast natural-store x-stages and the fast per-transform pair
   alone (phase_fast_xstages; `--phase 5v` only, not in the full run):
   every fast form of kx_visc.cu's kernel (kx_fwd at one field, the
   viscosity epilogue with and without the stage axpy, the RK4 tail, two
   stacked fields, five with the bf16 and the float32 store), of
   xstage.cu's (modes 0 inverse and forward, 1 and 2 on four stacked
   shards), of ka_kc.cu's kc_kernel (kc, kc_visc, kc_sw's five stacked
   planes) and ka_kernel (real forward, complex inverse), of kb_pair.cu's
   kb_kernel (the x-major pair, the single inverse) and of ky_all.cu's
   ky_all_kernel (split on and off) held to its plain version as in 5o at
   FAST_XSTAGE_SHAPES, then timed at n^2 in turns with its strict form
   (fast, strict, strict, fast), beside the one torch.fft call of its
   transform (ky_all: the products formed in torch, then fft.rfft) and
   its bound; the parts of the one-field x-stage from
   csrc/xtile_parts.cu's cuts (loads; first pass; sub-DFT; exchange;
   store), fast and strict, on float planes and complex64, and of the
   transposed store (loads; sub-DFT; exchange; staging; store), fast and
   strict, of kc's half store, ka's real forward, kb's pair and single
   inverse and ky_all's products; the resident clusters, registers and
   spills of the cuts and the registers and spills of the six kernels'
   instances (the build log).
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
   and FUSEKB=full), tracer (RK4 and ETDRK4; phase 5o: fast RK4), SW
   RK4 and SW ETDRK4
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
float32, whichever is larger; for the fast forms their bf16 products
over 989 TFLOP/s plus their float32 rest) and the time of the one torch
call that computes the same function, where there is one), the card's name and
power limit as nvidia-smi gives them, and {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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
# and the dense bf16 tensor-core rate (fast mode's DFT-16 products)
BF16_FLOP_S = 989e12
# bench.py's sw-etdrk4 time step at 4096^2 (8.85 times the RK4 bound)
SW_ETD_DT = 7.5
# row name: (source, the TPU kernel it replaces, LAUNCHES key, paths)
XFIRST_BT = ("barotropic-xfirst", "bt-quad", "bt-split")
XFIRST_SW = ("sw-xfirst", "sw-xfirst-etdrk4")
# the shallow-water fast paths (phase 5o): through the CLI, RK4 and
# ETDRK4, and the fast float32 store through ShallowWaterModel.build
FAST_SW = ("sw-fast", "sw-fast-etdrk4", "sw-fast-f32")
# the x-first order's fast paths (phase 5p): barotropic and SW through the
# CLI, RK4 and ETDRK4 (XFB_BT_YFIRST=0 / XFB_SW_YFIRST=0), and QUAD_MODE
# quad and split through BarotropicModel.build
XFIRST_FAST_CLI = ("bt-xfirst-fast", "bt-xfirst-fast-etdrk4",
                   "sw-xfirst-fast", "sw-xfirst-fast-etdrk4")
XFIRST_FAST_BT = ("bt-xfirst-fast", "bt-xfirst-fast-etdrk4", "bt-quad-fast",
                  "bt-split-fast")
XFIRST_FAST_SW = ("sw-xfirst-fast", "sw-xfirst-fast-etdrk4")
# the barotropic fusion arms' CLI paths, by the kernel they swap in
BT_FULL = ("bt-fusekb-full", "bt-full-tail", "bt-etdrk4-full")
BT_FUSEKX0 = ("bt-fusekx0", "bt-unfused-fusekx0", "bt-etdrk4-fusekx0")
BT_TAIL = ("bt-fusetail", "bt-full-tail")
# the tracer's fast paths and the other barotropic fast arms through the
# CLI (phase 5o): the environment each runs under, as the JAX package
# reads it
FAST_TRACER = ("tracer-fast", "tracer-fast-etdrk4")
BT_FAST_ENV = {"barotropic-fast-etdrk4": {},
               "bt-fast-fusekb0": {"XFB_BT_FUSEKB": "0"},
               "bt-fast-full": {"XFB_BT_FUSEKB": "full"},
               "bt-fast-fusekx0": {"XFB_BT_FUSEKX": "0"},
               "bt-fast-fusetail": {"XFB_BT_FUSETAIL": "1"},
               "bt-fast-unfused": {"XFB_BT_FUSED_RK": "0"}}
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
# phase 5r: the sharded shallow-water and tracer families, through
# ShardedShallowWaterModel / ShardedTracerModel.build on four shards
# (shard4-<family>-<decomp>-<impl>, slab/overlap under ETDRK4, slab and
# x-pencil overlap in fast mode) and through the CLI on one shard
SHARD_FAMILIES = ("sw", "tracer")
SHARD_FAMILY_MODELS = tuple(
    f"shard4-{f}-{d}-{i}" for f in SHARD_FAMILIES for d in SHARD_DECOMPS
    for i in SHARD_IMPLS) + tuple(
    f"shard4-{f}-{k}" for f in SHARD_FAMILIES
    for k in ("slab-overlap-etdrk4", "slab-overlap-fast",
              "xpencil-overlap-fast"))
SHARD_FAMILY_CLI = ("shard-sw-slab-overlap", "shard-tracer-xpencil-pallas")
# inverse and forward transforms per step (4 stages): SW u, v, zeta, eta
# and qu, qv, eu, ev, phi, the zero forcing; tracer the zeta and q
# gradients, u, v and the two advections; and per record (the diags)
SHARD_FAMILY_TRANSFORMS = {"sw": (16, 24), "tracer": (24, 8)}
SHARD_FAMILY_RECORD = {"sw": 6, "tracer": 5}
# the fast overlap paths against the strict overlap path after the
# phase's steps: tracer zeta and q; SW zeta and eta (no split-linear
# formulation, as the JAX sharded model: the f0/gravity terms ride the
# bf16 x-stages)
FAST_SHARD_FAMILY_BARS = {"tracer": {"vort": 1e-4, "q": 1e-4},
                          "sw": {"vort": 2e-4, "eta": 1e-2}}
# make_sharded_rollout's gradient against the single-device one: its
# grid, steps, and the bar on max |d| over the single-device max
SHARD_ROLLOUT_N, SHARD_ROLLOUT_STEPS, SHARD_ROLLOUT_BAR = 1024, 3, 1e-5
# phase 5s: the 2-D pencil decomposition. The families' runs at n^2 on
# PENCIL_MESH (family-scheme), the CLI runs on the 1x1 mesh and the other
# mesh shapes at PENCIL_SMALL_N^2, the bar of the CLI records against the
# one-shard slab run's
PENCIL_MESH = (2, 2)
PENCIL_RUNS = ("barotropic-rk4", "barotropic-etdrk4", "sw-rk4",
               "sw-etdrk4", "tracer-rk4")
PENCIL_SHAPES = ((1, 4), (4, 1), (2, 4))
PENCIL_SMALL_N, PENCIL_CLI_BAR = 256, 1e-6
# phase 5t: the one-process-per-card executor, RANKS ranks sharing the
# card (parallel/multihost.py, peer.py): (path, family, decomp, impl,
# fast, grid), grid "n" the main path's, "small" RANK_SMALL_N; each for
# RANK_STEPS steps from a numpy-seeded state, against the stacked model
# at P = RANKS in the same call
RANKS, RANK_STEPS, RANK_SMALL_N, RANK_SEED, RANK_KAPPA = 4, 3, 256, 11, 50.0
RANK_TIMEOUT = 600
RANK_CASES = (
    ("ranks-bt-slab-pallas", "barotropic", "slab", "pallas", False, "n"),
    ("ranks-bt-slab-overlap", "barotropic", "slab", "overlap", False, "n"),
    ("ranks-bt-slab-overlap-fast", "barotropic", "slab", "overlap", True,
     "small"),
    ("ranks-sw-xpencil-overlap", "sw", "xpencil", "overlap", False,
     "small"),
    ("ranks-tracer-slab-pallas", "tracer", "slab", "pallas", False,
     "small"),
    ("ranks-bt-pencil-xla", "barotropic", "pencil", "xla", False, "small"))
# phase 5t's rollouts over the ranks (adjoint.make_sharded_rollout, xla):
# the slab and x-pencil on make_mesh(None), the pencil on the 2x2 mesh, at
# SHARD_ROLLOUT_N^2 for SHARD_ROLLOUT_STEPS steps; the ranks' gradient
# against the stacked one: bit for bit, or max |d| <= RANK_GRAD_BAR of its
# max
RANK_ROLLOUTS = ("slab", "xpencil", "pencil")
RANK_GRAD_BAR = 1e-6
# the reference-parity bar on the card: the barotropic kernel path
# (strict, y-first; the default arm and FUSEKB=full) against the port's
# numpy oracle, from the gaussian IC at PARITY_N^2 for PARITY_STEPS RK4
# steps, rel-L2 of the physical vorticity
PARITY_N, PARITY_STEPS, PARITY_BAR = 256, 20, 1e-6
PARITY_ARMS = {"barotropic": {}, "bt-fusekb-full": dict(fusekb="full")}


def shard_transform_launches(decomp: str, impl: str, inverse: int,
                             forward: int) -> dict:
    """The kernels `inverse` inverse and `forward` forward distributed
    transforms launch: two transposes (slab) or one (x-pencil) each on
    'pallas', one xstage or one x-stage half on 'overlap', none on
    'xla'."""
    if impl == "xla":
        return {}
    if decomp == "slab":
        t = inverse + forward
        return ({"a2a_cols": t, "a2a_rows": t} if impl == "pallas"
                else {"xstage": t})
    cols, rows = (("a2a_cols", "a2a_rows") if impl == "pallas"
                  else ("xstage_gather", "xstage_scatter"))
    return {k: v for k, v in ((cols, forward), (rows, inverse)) if v}


def family_path_step(path: str) -> dict:
    """The launches per step of a phase 5r path
    (shard[4]-<family>-<decomp>-<impl>[-etdrk4|-fast]): ETDRK4 has the
    transforms of RK4 (4 N per step); fast mode the same counts under
    the fast x-stages' names."""
    _, family, decomp, impl, *mode = path.split("-")
    out = shard_transform_launches(decomp, impl,
                                   *SHARD_FAMILY_TRANSFORMS[family])
    return {f"{k}_fast": v for k, v in out.items()} if mode == ["fast"] \
        else out


def _rank_paths(*kernels) -> tuple:
    """Phase 5t's paths that launch any of `kernels` (each rank the
    stacked model's transforms: shard_transform_launches's kernels)."""
    out = []
    for name, _, decomp, impl, fast, _ in RANK_CASES:
        keys = shard_transform_launches(decomp, impl, 1, 1)
        if {f"{k}_fast" if fast else k for k in keys} & set(kernels):
            out.append(name)
    return tuple(out)


def _family_paths(*kernels) -> tuple:
    """Phase 5r's paths (models and CLI runs) that launch any of
    `kernels`."""
    return tuple(p for p in SHARD_FAMILY_MODELS + SHARD_FAMILY_CLI
                 if any(family_path_step(p).get(k) for k in kernels))


KERNELS = {
    "ka_diag": ("xlab_fftbarotropic_torch/csrc/ka_diag.cu",
                "xlab_fftbarotropic_tpu/ops/pallas_fft.py:694",
                "ka_diag", ("barotropic", "barotropic-xfirst", "ensemble")),
    "kb_pair": ("xlab_fftbarotropic_torch/csrc/kb_pair.cu",
                "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1049",
                "kb_pair", ("barotropic", "tracer", "shallow-water",
                            "sw-etdrk4", "ensemble")),
    "ky_adv": ("xlab_fftbarotropic_torch/csrc/ky_adv.cu",
               "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1506",
               "ky_adv", ("barotropic", "ensemble")),
    "kx_visc": ("xlab_fftbarotropic_torch/csrc/kx_visc.cu",
                "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1654",
                "kx_visc", ("barotropic", "ensemble")),
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
                                    "sw-xfirst", "ensemble")),
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
           "ka", ("shallow-water", "sw-etdrk4", "sw-drag", "adjoint",
                  "postproc", "diagnose") + XFIRST_SW),
    "kc": ("xlab_fftbarotropic_torch/csrc/ka_kc.cu",
           "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1349",
           "kc", ("shallow-water", "sw-etdrk4", "sw-drag", "adjoint",
                  "postproc", "diagnose") + XFIRST_SW),
    "kb": ("xlab_fftbarotropic_torch/csrc/kb_pair.cu",
           "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1043",
           "kb", ("sw-drag", "adjoint", "postproc", "diagnose")),
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
    # fast mode (rows 1, 2, 9, 4 on the fast column tile): the CLI's
    # --fast-transforms run
    "ka_diag_fast": ("xlab_fftbarotropic_torch/csrc/ka_diag.cu",
                     "xlab_fftbarotropic_tpu/ops/pallas_fft.py:694",
                     "ka_diag_fast", ("barotropic-fast", "bt-xfirst-fast",
                                      "bt-xfirst-fast-etdrk4")),
    "kb_pair_fast": ("xlab_fftbarotropic_torch/csrc/kb_pair.cu",
                     "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1049",
                     "kb_pair_fast", ("barotropic-fast",) + FAST_SW),
    "kb_adv_half_fast": ("xlab_fftbarotropic_torch/csrc/kb_adv.cu",
                         "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1179",
                         "kb_adv_half_fast", ("barotropic-fast",)),
    "kx_visc_fast": ("xlab_fftbarotropic_torch/csrc/kx_visc.cu",
                     "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1654",
                     "kx_visc_fast", ("barotropic-fast",)),
    # the tracer's fast mode (rows 18, 19, 20 on the fast column tile) and
    # the other barotropic fast arms (rows 3, 5, 6, 10; row 4's "none"
    # form under ETDRK4): the CLI's runs
    "ka6_fast": ("xlab_fftbarotropic_torch/csrc/ka_diag.cu",
                 "xlab_fftbarotropic_tpu/ops/pallas_tracer.py:57",
                 "ka6_fast", FAST_TRACER),
    "kb_adv_tracer_fast": ("xlab_fftbarotropic_torch/csrc/kb_adv_tracer.cu",
                           "xlab_fftbarotropic_tpu/ops/pallas_tracer.py:132",
                           "kb_adv_tracer_fast", FAST_TRACER),
    "kx_visc_tracer_fast": ("xlab_fftbarotropic_torch/csrc/kx_visc.cu",
                            "xlab_fftbarotropic_tpu/ops/pallas_tracer.py:206",
                            "kx_visc_fast", FAST_TRACER),
    "ky_adv_fast": ("xlab_fftbarotropic_torch/csrc/ky_adv.cu",
                    "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1506",
                    "ky_adv_fast", ("bt-fast-fusekb0",)),
    "kb_adv_full_fast": ("xlab_fftbarotropic_torch/csrc/kb_adv.cu",
                         "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1158",
                         "kb_adv_full_fast", ("bt-fast-full",)),
    "kx_visc_tail_fast": ("xlab_fftbarotropic_torch/csrc/kx_visc.cu",
                          "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1677",
                          "kx_visc_tail_fast", ("bt-fast-fusetail",)),
    "kx_fwd_bt_fast": ("xlab_fftbarotropic_torch/csrc/kx_visc.cu",
                       "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1521",
                       "kx_fwd_fast_f32", ("bt-fast-fusekx0",)),
    "kx_visc_none_fast": ("xlab_fftbarotropic_torch/csrc/kx_visc.cu",
                          "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1654",
                          "kx_visc_fast", ("barotropic-fast-etdrk4",)),
    # shallow-water fast mode (rows 16, 17a, 17b on the fast column tile,
    # 17b's bf16 product store, 17c and 17e on bf16 products): the CLI's
    # -m sw --fast-transforms runs (RK4, ETDRK4) and the two model paths
    # of the stores the modes do not default to
    "ka_sw_fast": ("xlab_fftbarotropic_torch/csrc/ka_sw.cu",
                   "xlab_fftbarotropic_tpu/ops/pallas_sw.py:217",
                   "ka_sw_fast", FAST_SW + XFIRST_FAST_SW),
    "ky_all_fast": ("xlab_fftbarotropic_torch/csrc/ky_all.cu",
                    "xlab_fftbarotropic_tpu/ops/pallas_sw.py:513",
                    "ky_all_fast", FAST_SW),
    "kx_fwd_fast": ("xlab_fftbarotropic_torch/csrc/kx_visc.cu",
                    "xlab_fftbarotropic_tpu/ops/pallas_sw.py:565",
                    "kx_fwd_fast", ("sw-fast", "sw-fast-etdrk4")),
    "kx_fwd_fast_f32": ("xlab_fftbarotropic_torch/csrc/kx_visc.cu",
                        "xlab_fftbarotropic_tpu/ops/pallas_sw.py:565",
                        "kx_fwd_fast_f32", ("sw-fast-f32",)),
    "kx_fwd_bf16": ("xlab_fftbarotropic_torch/csrc/kx_visc.cu",
                    "xlab_fftbarotropic_tpu/ops/pallas_sw.py:565",
                    "kx_fwd_bf16", ("sw-pstore-bf16",)),
    "sw_combine_bf16": ("xlab_fftbarotropic_torch/csrc/sw_combine.cu",
                        "xlab_fftbarotropic_tpu/ops/pallas_sw.py:679",
                        "sw_combine_bf16", ("sw-fast", "sw-pstore-bf16")),
    "sw_combine_mv_bf16": ("xlab_fftbarotropic_torch/csrc/sw_combine.cu",
                           "xlab_fftbarotropic_tpu/ops/pallas_sw.py:693",
                           "sw_combine_mv_bf16", ("sw-fast-etdrk4",)),
    # the x-first order's fast mode (rows 11, 2's x-major form, 15, 17d on
    # the fast column tile): the CLI's runs and QUAD_MODE quad and split
    "ka_quad_fast": ("xlab_fftbarotropic_torch/csrc/ka_diag.cu",
                     "xlab_fftbarotropic_tpu/ops/pallas_fft.py:605",
                     "ka_quad_fast", ("bt-quad-fast",)),
    "ka_quad_split_fast": ("xlab_fftbarotropic_torch/csrc/ka_diag.cu",
                           "xlab_fftbarotropic_tpu/ops/pallas_fft.py:629",
                           "ka_quad_fast", ("bt-split-fast",)),
    "kb_xmajor_fast": ("xlab_fftbarotropic_torch/csrc/kb_pair.cu",
                       "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1049",
                       "kb_fast", XFIRST_FAST_BT + XFIRST_FAST_SW),
    "ka_adv_fast": ("xlab_fftbarotropic_torch/csrc/ka_kc.cu",
                    "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1391",
                    "ka_adv_fast", XFIRST_FAST_BT),
    "kc_visc_fast": ("xlab_fftbarotropic_torch/csrc/ka_kc.cu",
                     "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1412",
                     "kc_visc_fast", XFIRST_FAST_BT),
    "ka_fwd_fast": ("xlab_fftbarotropic_torch/csrc/ka_kc.cu",
                    "xlab_fftbarotropic_tpu/ops/pallas_sw.py:450",
                    "ka_fwd_fast", XFIRST_FAST_SW),
    "kc_sw_fast": ("xlab_fftbarotropic_torch/csrc/ka_kc.cu",
                   "xlab_fftbarotropic_tpu/ops/pallas_sw.py:581",
                   "kc_sw_fast", XFIRST_FAST_SW),
    # the distributed path (rows 21-23): the CLI's one-shard runs, the
    # four-shard model runs and (phase 5t) rank 0's runs over four ranks
    "a2a_cols": ("xlab_fftbarotropic_torch/csrc/a2a.cu",
                 "xlab_fftbarotropic_tpu/parallel/pallas_transpose.py:39",
                 "a2a_cols", SHARD_PALLAS + _family_paths("a2a_cols")
                 + _rank_paths("a2a_cols")),
    "a2a_rows": ("xlab_fftbarotropic_torch/csrc/a2a.cu",
                 "xlab_fftbarotropic_tpu/parallel/pallas_transpose.py:78",
                 "a2a_rows", SHARD_PALLAS + _family_paths("a2a_rows")
                 + _rank_paths("a2a_rows")),
    "xstage": ("xlab_fftbarotropic_torch/csrc/xstage.cu",
               "xlab_fftbarotropic_tpu/parallel/pallas_overlap.py:61",
               "xstage", ("shard-slab-overlap", "shard4-slab-overlap",
                          "shard4-slab-overlap-etdrk4")
               + _family_paths("xstage") + _rank_paths("xstage")),
    "xstage_gather": ("xlab_fftbarotropic_torch/csrc/xstage.cu",
                      "xlab_fftbarotropic_tpu/parallel/pallas_overlap.py:148",
                      "xstage_gather", ("shard-xpencil-overlap",
                                        "shard4-xpencil-overlap")
                      + _family_paths("xstage_gather")
                      + _rank_paths("xstage_gather")),
    "xstage_scatter": ("xlab_fftbarotropic_torch/csrc/xstage.cu",
                       "xlab_fftbarotropic_tpu/parallel/pallas_overlap.py:212",
                       "xstage_scatter", ("shard-xpencil-overlap",
                                          "shard4-xpencil-overlap")
                       + _family_paths("xstage_scatter")
                       + _rank_paths("xstage_scatter")),
    # phase 5q: the per-transform pipeline's fast forms (the SW drag
    # path, the fast adjoint, the forcing spectrum of the fast SW plane
    # stepper) and the overlap x-stages' (the fast sharded paths)
    "ka_fast": ("xlab_fftbarotropic_torch/csrc/ka_kc.cu",
                "xlab_fftbarotropic_tpu/ops/pallas_fft.py:549",
                "ka_fast", ("sw-drag-fast", "adjoint-fast") + FAST_SW),
    "ka_inverse_fast": ("xlab_fftbarotropic_torch/csrc/ka_kc.cu",
                        "xlab_fftbarotropic_tpu/ops/pallas_fft.py:549",
                        "ka_fast", ("sw-drag-fast", "adjoint-fast")),
    "kc_fast": ("xlab_fftbarotropic_torch/csrc/ka_kc.cu",
                "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1349",
                "kc_fast", ("sw-drag-fast", "adjoint-fast") + FAST_SW),
    "kb_single_fast": ("xlab_fftbarotropic_torch/csrc/kb_pair.cu",
                       "xlab_fftbarotropic_tpu/ops/pallas_fft.py:1043",
                       "kb_fast", ("adjoint-fast",)),
    "xstage_fast": ("xlab_fftbarotropic_torch/csrc/xstage.cu",
                    "xlab_fftbarotropic_tpu/parallel/pallas_overlap.py:61",
                    "xstage_fast", ("shard-slab-overlap-fast",
                                    "shard4-slab-overlap-fast",
                                    "shard4-slab-overlap-fast-etdrk4")
                    + _family_paths("xstage_fast")
                    + _rank_paths("xstage_fast")),
    "xstage_gather_fast": (
        "xlab_fftbarotropic_torch/csrc/xstage.cu",
        "xlab_fftbarotropic_tpu/parallel/pallas_overlap.py:148",
        "xstage_gather_fast", ("shard-xpencil-overlap-fast",
                               "shard4-xpencil-overlap-fast",
                               "shard4-xpencil-overlap-fast-etdrk4")
        + _family_paths("xstage_gather_fast")),
    "xstage_scatter_fast": (
        "xlab_fftbarotropic_torch/csrc/xstage.cu",
        "xlab_fftbarotropic_tpu/parallel/pallas_overlap.py:212",
        "xstage_scatter_fast", ("shard-xpencil-overlap-fast",
                                "shard4-xpencil-overlap-fast",
                                "shard4-xpencil-overlap-fast-etdrk4")
        + _family_paths("xstage_scatter_fast")),
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
    # fast mode: the FUSEKB=half arm on the fast column tile
    "barotropic-fast": {"ka_diag_fast": 4, "kb_pair_fast": 4,
                        "kb_adv_half_fast": 4, "kx_visc_fast": 4,
                        "rk4_combine": 1},
    "bt-etdrk4-fusekx0": {"ka_diag": 4, "kb_pair": 8, "ky_adv": 4,
                          "kx_fwd": 4, "visc": 4},
    # the tracer's fast mode (RK4, ETDRK4) and the other barotropic fast
    # arms
    "tracer-fast": {"ka6_fast": 4, "kb_pair_fast": 8,
                    "kb_adv_tracer_fast": 4, "kx_visc_fast": 4,
                    "rk4_combine": 1},
    "tracer-fast-etdrk4": {"ka6_fast": 4, "kb_pair_fast": 8,
                           "kb_adv_tracer_fast": 4, "kx_visc_fast": 4},
    "barotropic-fast-etdrk4": {"ka_diag_fast": 4, "kb_pair_fast": 4,
                               "kb_adv_half_fast": 4, "kx_visc_fast": 4},
    "bt-fast-fusekb0": {"ka_diag_fast": 4, "kb_pair_fast": 8,
                        "ky_adv_fast": 4, "kx_visc_fast": 4,
                        "rk4_combine": 1},
    "bt-fast-full": {"ka_diag_fast": 4, "kb_adv_full_fast": 4,
                     "kx_visc_fast": 4, "rk4_combine": 1},
    "bt-fast-fusekx0": {"ka_diag_fast": 4, "kb_pair_fast": 4,
                        "kb_adv_half_fast": 4, "kx_fwd_fast_f32": 4,
                        "visc": 4, "rk4_combine": 1},
    "bt-fast-fusetail": {"ka_diag_fast": 4, "kb_pair_fast": 4,
                         "kb_adv_half_fast": 4, "kx_visc_fast": 3,
                         "kx_visc_tail_fast": 1},
    "bt-fast-unfused": {"ka_diag_fast": 4, "kb_pair_fast": 4,
                        "kb_adv_half_fast": 4, "kx_visc_fast": 4},
    # shallow-water fast mode: the fast tile, split-linear, the bf16
    # product store (and the two stores the modes do not default to)
    "sw-fast": {"ka_sw_fast": 4, "kb_pair_fast": 8, "ky_all_fast": 4,
                "kx_fwd_fast": 4, "sw_combine_bf16": 4, "rk4_combine": 1},
    "sw-fast-etdrk4": {"ka_sw_fast": 4, "kb_pair_fast": 8,
                       "ky_all_fast": 4, "kx_fwd_fast": 4,
                       "sw_combine_mv_bf16": 4},
    "sw-fast-f32": {"ka_sw_fast": 4, "kb_pair_fast": 8, "ky_all_fast": 4,
                    "kx_fwd_fast_f32": 4, "sw_combine": 4,
                    "rk4_combine": 1},
    "sw-pstore-bf16": {"ka_sw": 4, "kb_pair": 8, "ky_all": 4,
                       "kx_fwd_bf16": 4, "sw_combine_bf16": 4,
                       "rk4_combine": 1},
    # the x-first order's fast mode: torch stage updates (barotropic),
    # the float32 product store and combines (shallow water)
    "bt-xfirst-fast": {"ka_diag_fast": 4, "kb_fast": 8, "ka_adv_fast": 4,
                       "kc_visc_fast": 4},
    "bt-xfirst-fast-etdrk4": {"ka_diag_fast": 4, "kb_fast": 8,
                              "ka_adv_fast": 4, "kc_visc_fast": 4},
    "bt-quad-fast": {"ka_quad_fast": 4, "kb_fast": 8, "ka_adv_fast": 4,
                     "kc_visc_fast": 4},
    "bt-split-fast": {"ka_quad_fast": 8, "kb_fast": 8, "ka_adv_fast": 4,
                      "kc_visc_fast": 4},
    "sw-xfirst-fast": {"ka_sw_fast": 4, "kb_fast": 8, "ka_fwd_fast": 4,
                       "kc_sw_fast": 4, "sw_combine": 4, "rk4_combine": 1},
    "sw-xfirst-fast-etdrk4": {"ka_sw_fast": 4, "kb_fast": 8,
                              "ka_fwd_fast": 4, "kc_sw_fast": 4,
                              "sw_combine_mv": 4},
    # phase 5q: the SW drag path on the fast per-transform kernels
    "sw-drag-fast": {"ka_fast": 40, "kb_fast": 8, "kc_fast": 24},
}
# and per segment: the shallow-water forcing spectrum (the runner always
# passes a forcing field, zero when the run is unforced)
PER_SEGMENT = {"shallow-water": {"ka": 1, "kc": 1},
               "sw-etdrk4": {"ka": 1, "kc": 1},
               "sw-unfused": {"ka": 1, "kc": 1},
               "sw-xfirst": {"ka": 1, "kc": 1},
               "sw-xfirst-etdrk4": {"ka": 1, "kc": 1},
               "sw-pstore-bf16": {"ka": 1, "kc": 1},
               # fast mode takes the forcing spectrum on the fast ka, kc
               **{k: {"ka_fast": 1, "kc_fast": 1} for k in (
                   "sw-fast", "sw-fast-etdrk4", "sw-fast-f32")
                  + XFIRST_FAST_SW}}
# the sharded paths; through the CLI, the records' diagnostics add their
# inverse transforms once per segment
PER_STEP.update({f"shard{k}-{d}-{i}": v
                 for (d, i), v in SHARD_PER_STEP.items() for k in ("", "4")})
PER_STEP["shard4-slab-overlap-etdrk4"] = SHARD_PER_STEP[("slab", "overlap")]
PER_SEGMENT.update({f"shard-{d}-{i}": v
                    for (d, i), v in SHARD_PER_RECORD.items()})
# the overlap impl in fast mode (phase 5q): the same counts under the
# fast x-stages' names, under RK4 and ETDRK4
for _d in SHARD_DECOMPS:
    _fast = {f"{k}_fast": v
             for k, v in SHARD_PER_STEP[(_d, "overlap")].items()}
    for _name in (f"shard-{_d}-overlap-fast", f"shard4-{_d}-overlap-fast",
                  f"shard4-{_d}-overlap-fast-etdrk4"):
        PER_STEP[_name] = _fast
    PER_SEGMENT[f"shard-{_d}-overlap-fast"] = {
        f"{k}_fast": v for k, v in SHARD_PER_RECORD[(_d, "overlap")].items()}
# phase 5r's paths; through the CLI the records' diagnostics add their
# inverse transforms once per segment
PER_STEP.update({p: family_path_step(p)
                 for p in SHARD_FAMILY_MODELS + SHARD_FAMILY_CLI})
PER_SEGMENT.update({p: shard_transform_launches(
    p.split("-")[2], p.split("-")[3], SHARD_FAMILY_RECORD[p.split("-")[1]],
    0) for p in SHARD_FAMILY_CLI})
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
           "sw-xfirst-etdrk4": {"XFB_SW_YFIRST": "0"}, **BT_ARM_ENV,
           **BT_FAST_ENV,
           **{f: {"XFB_BT_YFIRST" if f.startswith("bt") else
                  "XFB_SW_YFIRST": "0"} for f in XFIRST_FAST_CLI}}
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
# the SW model paths' ShallowWaterModel.build arguments (phase 5o runs
# the last two: the product stores fast mode and strict mode do not
# default to)
SW_MODEL_PATHS = {"sw-unfused": dict(fused_rk=False),
                  "sw-fast-f32": dict(fast=True, pstore="f32"),
                  "sw-pstore-bf16": dict(pstore="bf16")}
# the SW fast mode through the CLI (phase 5o)
FAST_SW_CLI = ("sw-fast", "sw-fast-etdrk4")
SW_FAMILIES = ("shallow-water", "sw-etdrk4", "sw-drag") + XFIRST_SW + (
    FAST_SW_CLI) + XFIRST_FAST_SW + ("sw-drag-fast",)
# the SW drag path's drag (examples/09-drag-spindown)
SW_R_DRAG = 2e-4
# and its time step's cap: 0.9 of the 1 s RK4 viscous bound of example
# 12's hyperviscosity (0.847 s, the gravity-wave bound, binds at 4096^2)
SW_DRAG_DT_MAX = 0.9
# the adjoint main path: the JAX package's 4DVar twin experiment
# (scripts/assimilate_demo.py: a 10-step window, guess 0.9 x truth, Adam
# at lr 1e-5), a few iterations of it
ADJ_WINDOW, ADJ_ITERS, ADJ_LR = 10, 3, 1e-5
# phase 5k: example 02's pipeline (the forced run's steps and record
# interval) and the Kuo2004 core's speed, m/s, for its time step
POSTPROC_STEPS, POSTPROC_REC, KUO_U_MAX = 20, 10, 75.0
# phases 5l-5n: the filamentation medians' bound (the finite sets of
# the two paths differ where OW ~ 0); the FD core's card-vs-CPU grid,
# steps and Jacobi stopping rule (the tolerance sits above float32's
# floor for the 5-point residual at 256^2, so a solve warm-started at
# the exact solution stops); the ensemble's members through the CLI, its
# batched chunk's width and that chunk's bar against the solo library
# run (a batched transform may round otherwise than a single one)
DIAG_MEDIAN_TOL = 1e-4
# and the cells where D and tau are held (S, |zeta| > DIAG_COND G; OW >
# DIAG_COND G^2; G the largest velocity gradient): their first-order
# round-off bounds hold there
DIAG_COND = 1e-3
FD_CHECK_N, FD_CHECK_STEPS, JACOBI_TOL, JACOBI_MAX = 256, 2, 1e-3, 1000
ENS_MEMBERS, ENS_BATCH, ENS_BATCH_TOL = 4, 8, 1e-6


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
    launch: Optional[Callable] = None   # the bare launch (a2a), timed too


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
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.ops._build import lib
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

    def launch(x, out, to_cols):
        """xfb_a2a alone, into an output and a host array of shard
        pointers made once (the wrapper makes both per call); it counts
        no launch."""
        ptrs = ftr.shard_pointers("a2a", x, out)

        def kern():
            rc = lib().xfb_a2a(ptrs, p, n // p, hny, w, int(to_cols), -1,
                               dev.index, ff._stream(out))
            check(rc == 0, f"xfb_a2a returned {rc}")
            return out
        return kern

    return {
        "a2a_cols": Case(
            lambda: ftr.a2a_cols(rows), lambda: ftr.a2a_cols_plain(rows), one,
            (rows,), library=lambda: padded.reshape(
                p, n // p, p, w).permute(2, 0, 1, 3).contiguous(),
            exact=True, launch=launch(rows, torch.empty_like(cols), True)),
        "a2a_rows": Case(
            lambda: ftr.a2a_rows(cols, hny),
            lambda: ftr.a2a_rows_plain(cols, hny), one, (cols,),
            library=lambda: cols.reshape(p, p, n // p, w).permute(
                1, 2, 0, 3).contiguous(), exact=True,
            launch=launch(cols, torch.empty_like(rows), False)),
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


# the fast mode's kernels (rows 1, 2, 9, 4 on the fast column tile) and
# the strict rows they are held against; the shapes of their card checks,
# (transform length n, columns): None is the n x n grid's (hny for the
# x-stages, n for the y-stages), else that many columns (ragged tiles)
FAST_KERNELS = {"ka_diag_fast": "ka_diag", "kb_pair_fast": "kb_pair",
                "kb_adv_half_fast": "kb_adv_half",
                "kx_visc_fast": "kx_visc"}
FAST_SHAPES = ((64, None), (256, None), (4096, None), (256, 200),
               (1024, 33))
# the __global__ templates' arguments in order (phase_xtile's tags name
# the fast and bf16 flags set; the combines' product type bf16 tags
# "bf16")
TEMPLATE_FLAGS = {"ka_fields_kernel": ("psi_first", "fast"),
                  "kb_pair_kernel": ("fast",),
                  "kb_adv_kernel": ("full", "fast"),
                  "kx_visc_kernel": ("fast", "bf16"),
                  "ka_sw_kernel": ("fast",), "ky_all_kernel": ("fast",),
                  "ky_adv_kernel": ("fast",),
                  "kb_adv_tracer_kernel": ("fast",), "kb_kernel": ("fast",),
                  "kc_kernel": ("fast",), "ka_adv_kernel": ("fast",),
                  "ka_fwd_kernel": ("fast",), "ka_kernel": ("sign", "fast"),
                  "xstage_kernel": ("sign", "src", "dst", "fast")}
# the fast path's bars: a fast kernel against its plain version on random
# inputs (the plain versions form the tensor cores' measured sum,
# ops/fast_tile.py dot16, for all but 0.01-0.1 % of the outputs, and a
# sum a rounding apart can round to the neighbouring bf16 in the next
# pass), and a fast kernel's error class against the strict one
FAST_TOL = 1e-4
FAST_CLASS = (1e-4, 1e-2)
# the shallow-water fast mode (rows 16, 17a, 17b on the fast column tile,
# 17b with the bf16 product store; 17c, 17e on bf16 products): its fast
# FFT forms and the strict rows they are held against, the strict tile's
# bf16 store and the bf16-product combines beside their float32 forms
FAST_SW_KERNELS = {"ka_sw_fast": "ka_sw", "ky_all_fast": "ky_all_split",
                   "kx_fwd_fast": "kx_fwd", "kx_fwd_fast_f32": "kx_fwd"}
BF16_KERNELS = {"kx_fwd_bf16": "kx_fwd", "sw_combine_bf16": "sw_combine",
                "sw_combine_mv_bf16": "sw_combine_mv"}
# the fast SW paths' bars against the strict kernel path (rel-L2 of the
# physical zeta and eta): (steps, scheme) -> (zeta, eta); every error
# above FAST_FLOOR (fast mode is not quietly strict)
FAST_SW_BARS = {(20, "rk4"): (2e-4, 2e-3), (200, "rk4"): (2e-3, 5e-3),
                (20, "etdrk4"): (1e-3, 5e-3)}
FAST_FLOOR = 1e-7
# the tracer's fast forms (rows 18, 19, 20) and the other barotropic
# arms' (rows 3, 5, 6, 10, and row 4's "none" form, ETDRK4's N), with the
# strict rows they are held against
FAST_ARM_KERNELS = {"ka6_fast": "ka6", "kb_adv_tracer_fast": "kb_adv_tracer",
                    "kx_visc_tracer_fast": "kx_visc_tracer",
                    "ky_adv_fast": "ky_adv", "kb_adv_full_fast": "kb_adv_full",
                    "kx_visc_tail_fast": "kx_visc_tail",
                    "kx_fwd_bt_fast": "kx_fwd_bt",
                    "kx_visc_none_fast": "kx_visc"}
# the tracer's and barotropic ETDRK4's fast paths against the strict
# kernel path (rel-L2 of zeta and q, of vorticity): (steps, scheme) ->
# bar; every error above FAST_FLOOR
FAST_TRACER_BARS = {(30, "rk4"): 1e-4, (200, "rk4"): 1e-3,
                    (20, "etdrk4"): 1e-3}
FAST_BTE_BAR = 1e-3
# the barotropic fast arms (BarotropicModel.build arguments), each held
# bit for bit to the fast FUSEKB=half arm of its scheme after 3 steps
FAST_ARMS = {"fusekb0": dict(fusekb=""), "full": dict(fusekb="full"),
             "fusekx0": dict(fusekx=False), "tail": dict(fusetail=True),
             "unfused": dict(fused_rk=False)}
FAST_ETD_ARMS = {"etd-fusekb0": dict(fusekb=""),
                 "etd-full": dict(fusekb="full")}


class FastCase(NamedTuple):
    """A fast kernel on random inputs (kern, plain, and the strict kernel
    on the same inputs) and on exact-arithmetic ones (exact_kern,
    exact_plain: every tensor-core sum exact, so the two agree bit for
    bit), the outputs of a result, the tensors it reads and its complex
    transforms (for its bound)."""
    kern: Callable
    plain: Callable
    strict: Callable
    exact_kern: Callable
    exact_plain: Callable
    fields: Callable
    reads: tuple
    ffts: float


def exact_rows(n: int) -> np.ndarray:
    """The rows y of a length-n transform whose small-integer values the
    fast tile sums exactly: block r = y mod K's row j = y div K feeds
    butterfly i = j mod (m/16) of the first radix-16 pass, whose outputs
    reach the second one (m >= 256) as its input t = 0 alone (no twiddle,
    one product per sum) only for i < m/256; the float32 passes around
    them round alike in the plain version."""
    from xlab_fftbarotropic_torch.ops.xtile import xtile_plan
    p = xtile_plan(n, 1, 4)
    j = np.arange(n) // p.k
    lim = max(1, p.m // 256) if p.m >= 256 else p.m // 16
    return (j % (p.m // 16)) < lim


def _makers(rng, dev):
    """planes(shape, k, size) -> k float32 planes of normal values times
    size; ints(shape, k, lo, hi, rows) -> k planes of integers in [lo,
    hi], zero off `rows` (a mask of the second-last axis): numpy-seeded,
    on `dev`."""
    def planes(shape, k, size=1.0):
        return [torch.from_numpy((size * rng.standard_normal(shape)).astype(
            np.float32)).to(dev) for _ in range(k)]

    def ints(shape, k, lo=-4, hi=4, rows=None):
        out = []
        for _ in range(k):
            a = rng.integers(lo, hi + 1, shape).astype(np.float32)
            if rows is not None:
                a[..., ~rows, :] = 0.0
            out.append(torch.from_numpy(a).to(dev))
        return out
    return planes, ints


def _fast_tables(n: int, cols, dev, planes):
    """kx, ky, rlap, lap (order one) and mask of the n x n grid (cols
    None), or random ones of (n, cols)."""
    from xlab_fftbarotropic_torch.ops.spectral import SpectralTables
    if cols is None:
        t = SpectralTables.build(n, n, 600_000.0, 600_000.0, device=dev)
        return t.kx, t.ky, t.rlap, t.lap / t.lap.abs().max(), t.mask
    kx, = planes((n,), 1, 1e-4)
    ky, = planes((cols,), 1, 1e-4)
    rlap = -1.0 / (1.0 + planes((n, cols), 1)[0] ** 2)
    lap, = planes((n, cols), 1)
    mask = (planes((n, cols), 1)[0] > -1.0).float()
    return kx, ky, rlap, lap, mask


def fast_cases(n: int, cols, dev, seed: int) -> dict:
    """name -> FastCase of the four fast kernels for a length-n transform
    over `cols` columns (None: the n x n grid's), numpy-seeded: ka_diag
    (the x-stage of (n, hny) planes), kb_pair and kb_adv_half (the
    y-stages of (4, n/2 + 1, nx) stacks), kx_visc (with the stage axpy).
    The exact inputs are small integers on exact_rows (the Hermitian
    stacks on rows 0, n/16, .., n/2, which keep their mirrors there too)
    with integer tables; kb_adv_half's exact case has zeta_x = zeta_y = 0
    and beta = 0, so the advection is src, and u, v constants."""
    from xlab_fftbarotropic_torch.ops import fused_fft as ff

    rng = np.random.default_rng(seed)
    hny = n // 2 + 1
    cx, cy = (hny, n) if cols is None else (cols, cols)
    planes, ints = _makers(rng, dev)
    kx, ky, rlap, lap, mask = _fast_tables(n, cols, dev, planes)
    rows = exact_rows(n)
    herm = np.zeros(hny, bool)
    herm[::n // 16] = True

    # ka_diag
    zr, zi = planes((n, cx), 2)
    ezr, ezi = ints((n, cx), 2, rows=rows)
    ekx, = ints((n,), 1)
    eky, = ints((cx,), 1)
    erl, = ints((n, cx), 1, 1, 2)
    erl = erl * torch.where(ints((n, cx), 1, 0, 1)[0] > 0, 1.0, -1.0)
    # kb_pair and kb_adv_half: the stack at the size the stepper gives
    # kb_adv (physical fields of order one after the 1/(nx ny) scale)
    wr, wi = planes((4, hny, cy), 2, n * math.sqrt(cy))
    ewr, ewi = ints((4, hny, cy), 2, rows=herm)
    scale = 1.0 / (n * cy)
    zx, zy, src = planes((n, cy), 3)
    escale = 1.0 / (n * cy)
    dc = torch.zeros((4, hny, cy), device=dev)
    dc[2:, 0] = torch.stack(ints((cy,), 2)) * float(n * cy)
    ezero = torch.zeros((n, cy), device=dev)
    esrc, = ints((n, cy), 1, rows=rows)
    # kx_visc with the stage axpy
    fr, fi, zsr, zsi, z0r, z0i = planes((n, cx), 6)
    efr, efi = ints((n, cx), 2, rows=rows)
    elap, ezsr, ezsi, ez0r, ez0i = ints((n, cx), 5, -2, 2)
    emask, = ints((n, cx), 1, 0, 1)
    return {
        "ka_diag_fast": FastCase(
            lambda: ff.ka_diag(zr, zi, rlap, kx, ky, fast=True),
            lambda: ff.ka_diag_fast_plain(zr, zi, rlap, kx, ky),
            lambda: ff.ka_diag(zr, zi, rlap, kx, ky),
            lambda: ff.ka_diag(ezr, ezi, erl, ekx, eky, fast=True),
            lambda: ff.ka_diag_fast_plain(ezr, ezi, erl, ekx, eky),
            lambda out: [p[f] for p in out for f in range(4)],
            (zr, zi, rlap), 4 * cx),
        "kb_pair_fast": FastCase(
            lambda: ff.kb_pair(wr, wi, 2, 3, scale, fast=True),
            lambda: ff.kb_pair_fast_plain(wr, wi, 2, 3, scale),
            lambda: ff.kb_pair(wr, wi, 2, 3, scale),
            lambda: ff.kb_pair(ewr, ewi, 0, 1, escale, fast=True),
            lambda: ff.kb_pair_fast_plain(ewr, ewi, 0, 1, escale),
            list, (wr[2:4], wi[2:4]), cy),
        "kb_adv_half_fast": FastCase(
            lambda: ff.kb_adv_half(zx, zy, wr, wi, src, 0.3, fast=True),
            lambda: ff.kb_adv_half_fast_plain(zx, zy, wr, wi, src, 0.3),
            lambda: ff.kb_adv_half(zx, zy, wr, wi, src, 0.3),
            lambda: ff.kb_adv_half(ezero, ezero, dc, dc, esrc, fast=True),
            lambda: ff.kb_adv_half_fast_plain(ezero, ezero, dc, dc, esrc),
            list, (zx, zy, wr[2:4], wi[2:4], src), 1.5 * cy),
        "kx_visc_fast": FastCase(
            lambda: ff.kx_visc(fr, fi, lap, mask, zsr, zsi, 6.5,
                               (z0r, z0i, 1.5), fast=True),
            lambda: ff.kx_visc_fast_plain(fr, fi, lap, mask, zsr, zsi, 6.5,
                                          (z0r, z0i, 1.5)),
            lambda: ff.kx_visc(fr, fi, lap, mask, zsr, zsi, 6.5,
                               (z0r, z0i, 1.5)),
            lambda: ff.kx_visc(efr, efi, elap, emask, ezsr, ezsi, 1.0,
                               (ez0r, ez0i, 0.5), fast=True),
            lambda: ff.kx_visc_fast_plain(efr, efi, elap, emask, ezsr, ezsi,
                                          1.0, (ez0r, ez0i, 0.5)),
            list, (fr, fi, lap, mask, zsr, zsi, z0r, z0i), cx),
    }


def _fields_f32(out):
    """A stacked result's per-field planes, bf16 ones widened (exactly)
    for the norms."""
    return [p[f].float() for p in out for f in range(p.shape[0])]


def fast_sw_cases(n: int, cols, dev, seed: int) -> dict:
    """name -> FastCase of the shallow-water fast FFT forms for a length-n
    transform over `cols` columns (None: the n x n grid's), numpy-seeded:
    ka_sw (the x-stage of (n, hny) state planes at the bench's
    magnitudes: zeta 1e-4, div 1e-6, eta 5 m), ky_all (the y-stage of
    (n, nx) fields u, v 3 m/s, zeta, eta_s 1e-4, split as fast mode runs
    it), kx_fwd with the bf16 and with the float32 product store (the
    x-stage of (5, n, hny) planes). The exact inputs are small integers
    on exact_rows with integer tables, eta_scale 2 and ies 0.5 (exact
    powers of two)."""
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    rng = np.random.default_rng(seed)
    hny = n // 2 + 1
    cx, cy = (hny, n) if cols is None else (cols, cols)
    planes, ints = _makers(rng, dev)
    kx, ky, rlap, _, _ = _fast_tables(n, cols, dev, planes)
    rows = exact_rows(n)
    # ka_sw
    sw = [a * p for a, p in zip((1e-4, 1e-4, 1e-6, 1e-6, 5.0, 5.0),
                                planes((n, cx), 6))]
    es = float(fs.eta_pair_scale(sw))
    esw = ints((n, cx), 6, rows=rows)
    ekx, = ints((n,), 1)
    eky, = ints((cx,), 1)
    erl, = ints((n, cx), 1, 1, 2)
    erl = erl * torch.where(ints((n, cx), 1, 0, 1)[0] > 0, 1.0, -1.0)
    # ky_all, split on (fast mode's default)
    fields = [a * p for a, p in zip((3.0, 3.0, 1e-4, 1e-4),
                                    planes((n, cy), 4))]
    ky_args = (*fields, 2.0 ** 15, 1e-4, 9.81, True)
    eky_args = (*ints((n, cy), 4, rows=rows), 0.5, 1e-4, 9.81, True)
    # kx_fwd of the five stacked product spectra
    pr, pi = planes((5, n, cx), 2)
    epr, epi = ints((5, n, cx), 2, rows=rows)

    def kx_case(store):
        return FastCase(
            lambda: fs.kx_fwd(pr, pi, fast=True, pstore=store),
            lambda: fs.kx_fwd_fast_plain(pr, pi, store),
            lambda: fs.kx_fwd(pr, pi),
            lambda: fs.kx_fwd(epr, epi, fast=True, pstore=store),
            lambda: fs.kx_fwd_fast_plain(epr, epi, store),
            _fields_f32, (pr, pi), 5 * cx)
    return {
        "ka_sw_fast": FastCase(
            lambda: fs.ka_sw(*sw, rlap, kx, ky, es, fast=True),
            lambda: fs.ka_sw_fast_plain(*sw, rlap, kx, ky, es),
            lambda: fs.ka_sw(*sw, rlap, kx, ky, es),
            lambda: fs.ka_sw(*esw, erl, ekx, eky, 2.0, fast=True),
            lambda: fs.ka_sw_fast_plain(*esw, erl, ekx, eky, 2.0),
            _fields_f32, (*sw, rlap), 4 * cx),
        "ky_all_fast": FastCase(
            lambda: fs.ky_all(*ky_args, fast=True),
            lambda: fs.ky_all_fast_plain(*ky_args),
            lambda: fs.ky_all(*ky_args),
            lambda: fs.ky_all(*eky_args, fast=True),
            lambda: fs.ky_all_fast_plain(*eky_args),
            _fields_f32, tuple(fields), 2.5 * cy),
        "kx_fwd_fast": kx_case("bf16"),
        "kx_fwd_fast_f32": kx_case("f32"),
    }


# the bench's ies (the pairing equalizer's inverse), f0 and g of the SW
# products (fast_sw_cases' ky_all, phase 5v)
SW_BENCH = (2.0 ** 15, 1e-4, 9.81)


def fast_split_off_cases(n: int, cols, dev, seed: int) -> dict:
    """name -> FastCase of ky_all's fast form with split off
    (XFB_SW_SPLIT=0 in fast mode; fast_sw_cases holds it split on, as
    fast mode runs it) for a length-n transform over `cols` columns
    (None: the n x n grid's), numpy-seeded as fast_sw_cases makes
    ky_all's. The exact inputs are small integers on exact_rows with ies
    0.5, f0 0 and g 2 (q = zeta + f0 and phi = g eta + ke stay exact)."""
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    rng = np.random.default_rng(seed)
    cy = n if cols is None else cols
    planes, ints = _makers(rng, dev)
    fields = [a * p for a, p in zip((3.0, 3.0, 1e-4, 1e-4),
                                    planes((n, cy), 4))]
    args = (*fields, *SW_BENCH, False)
    eargs = (*ints((n, cy), 4, rows=exact_rows(n)), 0.5, 0.0, 2.0, False)
    return {"ky_all_nosplit_fast": FastCase(
        lambda: fs.ky_all(*args, fast=True),
        lambda: fs.ky_all_fast_plain(*args),
        lambda: fs.ky_all(*args),
        lambda: fs.ky_all(*eargs, fast=True),
        lambda: fs.ky_all_fast_plain(*eargs),
        _fields_f32, tuple(fields), 2.5 * cy)}


def fast_check(name: str, case: FastCase, where: str) -> dict:
    """A fast kernel against its plain version, bit for bit on the exact
    inputs and within FAST_TOL (rel-L2 per output field) on the random
    ones, and against the strict kernel within FAST_CLASS; raises past
    either."""
    got = case.fields(case.exact_kern())
    want = case.fields(case.exact_plain())
    torch.cuda.synchronize()
    same = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    nonzero = all(bool(w.abs().max() > 0) for w in want)
    got = case.fields(case.kern())
    plain = case.fields(case.plain())
    strict = case.fields(case.strict())
    torch.cuda.synchronize()
    fields = [rel_l2(g, w) for g, w in zip(got, plain)]
    rel = max(fields)
    flips = max(float((g != w).float().mean()) for g, w in zip(got, plain))
    cls = [rel_l2(g, w) for g, w in zip(got, strict)]
    log(f"fast {name:18s} {where}: exact inputs bit for bit {same}; random "
        f"rel-L2 vs plain {rel:.3e} (output {fields.index(rel)} of "
        f"{len(fields)}; {100 * flips:.3f} % of values differ), vs the "
        f"strict kernel {min(cls):.3e} .. {max(cls):.3e}")
    check(same and nonzero, f"{name} at {where}: not its plain version's "
                            f"bits on exact inputs")
    check(rel <= FAST_TOL, f"{name} at {where}: rel-L2 {rel:.3e} against "
                           f"its plain version > {FAST_TOL}")
    check(FAST_CLASS[0] <= min(cls) and max(cls) <= FAST_CLASS[1],
          f"{name} at {where}: rel-L2 against the strict kernel "
          f"{min(cls):.3e} .. {max(cls):.3e} outside {FAST_CLASS}")
    return dict(exact_bits=same, rel_l2_plain=rel, differ=flips,
                rel_l2_strict=max(cls), rel_l2_strict_min=min(cls),
                rel_l2_plain_fields=fields)


def fast_bound(case: FastCase, outputs, n: int):
    """A fast kernel's least time in ms and what bounds it: its bytes
    (float32 loads and stores, as the strict row's) over the HBM rate, or
    its operations: the radix-16 passes' bf16 products (a 32 x 32 real
    block per 16 points) over the bf16 tensor-core rate plus the float32
    rest (twiddles, the float32 pass and the K-point step, 5 n log2 n of
    the length they cover) over the float32 rate. Also both parts."""
    from xlab_fftbarotropic_torch.ops.xtile import xtile_plan
    p = xtile_plan(n, 1, 4)
    r16 = p.fast_radices.count(16)
    bf16_flops = case.ffts * r16 * (n // 16) * 2 * 32 * 32
    rest = math.log2(n) - 4 * r16
    fp32_flops = case.ffts * (5.0 * n * rest + 6.0 * n * r16)
    t_bytes = (nbytes(case.reads) + nbytes(outputs)) / HBM_BYTES_S
    t_ops = bf16_flops / BF16_FLOP_S + fp32_flops / FP32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            dict(bytes_ms=t_bytes * 1e3, bf16_ms=bf16_flops / BF16_FLOP_S
                 * 1e3, fp32_ms=fp32_flops / FP32_FLOP_S * 1e3))


def fast_library(name: str, case: FastCase, n: int):
    """The one torch.fft call on the kernel's transform shape (complex64,
    its inputs' size), or None where no one call computes it."""
    if name == "kb_adv_half_fast":
        return None
    x = torch.complex(*case.reads[:2])
    if name == "ka_diag_fast":
        x = torch.stack([x] * 4)
        return lambda: torch.fft.ifft(x, dim=1)
    if name == "kx_visc_fast":
        return lambda: torch.fft.fft(x, dim=0)
    return lambda: torch.fft.irfft(x, n=n, dim=1)


def _timed_turns(paths: dict, s0: dict, src, steps: int) -> dict:
    """ms/step of each path (name -> model), from its state in s0, in
    turns (each path, then each again in the reverse order): CUDA events
    over a `steps`-step segment after a 2-step warm-up."""
    times = {k: [] for k in paths}
    for k in list(paths) + list(reversed(list(paths))):
        m = paths[k]
        m.segment(s0[k], src, 2)                    # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m.segment(s0[k], src, steps)
        end.record()
        end.synchronize()
        times[k].append(start.elapsed_time(end) / steps)
    return times


def phase_fast(n: int, steps: int, dev, profile: bool = False) -> dict:
    """Phase 5o, fast mode: each fast kernel against its plain version
    (bit for bit on exact inputs, FAST_TOL on random ones) and the strict
    kernel (FAST_CLASS) at FAST_SHAPES, timed at n^2 beside its bound,
    its plain version, the strict kernel and one torch.fft call; the
    CLI's --fast-transforms run (phase_main_path); bench.py's barotropic
    configuration through BarotropicModel.build(..., fast=True): with
    torch.fft.* and torch.matmul raising, its vorticity against the
    strict kernel path after 30 and 200 steps, every value finite; and
    ms/step of the fast path beside the strict FUSEKB=half arm and the
    strict default, in turns; with `profile` the fast path's breakdown
    (profile_run)."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel

    out = {"checks": {}, "kernels": {}}
    shapes = [(64, None), (256, None), (n, None)] + [
        s for s in FAST_SHAPES if s[1] is not None]
    for size, cols in dict.fromkeys(shapes):
        cases = fast_cases(size, cols, dev, size + (cols or 0))
        for name, case in cases.items():
            where = f"{size}^2" if cols is None else f"{size} x {cols}"
            out["checks"][f"{name} {where}"] = fast_check(name, case, where)
            if (size, cols) != (n, None):
                continue
            got = case.fields(case.kern())
            want = case.fields(case.plain())
            bound_ms, bound_by, parts = fast_bound(case, want, size)
            ms, plain_ms = cuda_ms(case.kern), cuda_ms(case.plain)
            strict_ms = cuda_ms(case.strict)
            library = fast_library(name, case, size)
            library_ms = None if library is None else cuda_ms(library)
            abs_err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
            lib = ("" if library_ms is None
                   else f", one torch.fft call {library_ms:.4f} ms")
            log(f"kernel {name:24s} {size}^2: {ms:.4f} ms, the strict "
                f"kernel {strict_ms:.4f} ms, plain torch version "
                f"{plain_ms:.4f} ms{lib}; bound {bound_ms:.4f} ms "
                f"({bound_by}: bytes {parts['bytes_ms']:.4f} ms, bf16 "
                f"products {parts['bf16_ms']:.5f} ms + float32 rest "
                f"{parts['fp32_ms']:.5f} ms; {100.0 * bound_ms / ms:.1f} % "
                f"of it reached)")
            out["kernels"][name] = dict(
                max_abs_err=abs_err,
                rel_l2=out["checks"][f"{name} {where}"]["rel_l2_plain"],
                ms=ms, plain_ms=plain_ms, strict_ms=strict_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                **parts)
    out["main_path"] = phase_main_path("barotropic-fast", n, steps)
    # bench.py's barotropic configuration (the gaussian IC, dt = 3 s,
    # nu = 6.5 m^2/s)
    cfg = ModelConfig(nx=n, ny=n)
    fast = BarotropicModel.build(cfg, dev, fast=True)
    strict = BarotropicModel.build(cfg, dev, fast.tables)
    half = BarotropicModel.build(cfg, dev, fast.tables, fusekb="half")
    check(fast.fast and fast.fusion["fusekb"] == "half", "fast model arm")
    z0 = fast.init_state(makefields.gaussian(cfg))
    src = fast.zero_source()
    with _refusing_library():
        z = fast.segment(z0, src, 2)
        torch.cuda.synchronize()
    check(bool(torch.isfinite(torch.view_as_real(z)).all()),
          "fast path state not finite")
    log(f"no library transform: 2 steps of the fast path at {n}^2 ran with "
        f"torch.fft.* and torch.matmul raising")
    for k, bar in ((30, 1e-4), (200, 1e-3)):
        a = fast.diags(fast.segment(z0, src, k)).vort
        b = fast.diags(strict.segment(z0, src, k)).vort
        check(bool(torch.isfinite(a).all()), f"fast vort after {k} steps "
                                             f"not finite")
        rel = rel_l2(a, b)
        log(f"fast trajectory: {k} steps at {n}^2, rel-L2 of vort, fast "
            f"vs the strict kernel path = {rel:.3e} (bar {bar:g})")
        check(1e-7 < rel <= bar, f"fast path after {k} steps: rel-L2 "
                                 f"{rel:.3e} outside (1e-7, {bar:g}]")
        out[f"vort_rel_l2_{k}_steps"] = rel
    paths = {"fast": fast, "strict-half": half, "strict": strict}
    times = _timed_turns(paths, dict.fromkeys(paths, z0), src, steps)
    for k, ts in times.items():
        ms = sum(ts) / len(ts)
        out[f"ms_per_step_{k}"] = ms
        log(f"time barotropic {k:11s}: {ms:.3f} ms/step "
            f"({', '.join(f'{t:.3f}' for t in ts)}), "
            f"{n * n / (ms * 1e-3):.4e} grid-points/s")
    if profile:
        fast.segment(z0, src, 1)
        torch.cuda.synchronize()
        out["profile"] = profile_run("barotropic-fast",
                                     lambda: fast.segment(z0, src, 5), 5)
    return out


def fast_arm_cases(n: int, cols, dev, seed: int) -> dict:
    """name -> FastCase of the tracer's fast forms and the other
    barotropic arms' (FAST_ARM_KERNELS) for a length-n transform over
    `cols` columns (None: the n x n grid's), numpy-seeded: ka6 (the
    x-stage of (2, n, hny) states), kb_adv_tracer (the y-stage of a (6,
    n/2 + 1, nx) stack and four (n, nx) gradients), the stacked kx_visc
    (two fields, nu = 1, the stage axpy), ky_adv, kb_adv_full (of a (4,
    n/2 + 1, nx) stack), kx_visc_tail, the one-field kx_fwd and kx_visc's
    "none" form (nu = 0, no axpy: ETDRK4's N). The exact inputs are small
    integers on exact_rows with integer tables, as fast_cases makes them:
    the inverse y-stages' stacks hold constants (row 0 of fields 2, 3)
    and zero zeta gradients, so each advection is an integer plane on
    exact_rows (kb_adv_tracer's q product -u q_x)."""
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.ops import fused_sw as fs
    from xlab_fftbarotropic_torch.ops import fused_tracer as ft

    rng = np.random.default_rng(seed)
    hny = n // 2 + 1
    cx, cy = (hny, n) if cols is None else (cols, cols)
    planes, ints = _makers(rng, dev)
    kx, ky, rlap, lap, mask = _fast_tables(n, cols, dev, planes)
    rows = exact_rows(n)
    ekx, = ints((n,), 1)
    eky, = ints((cx,), 1)
    erl, = ints((n, cx), 1, 1, 2)
    erl = erl * torch.where(ints((n, cx), 1, 0, 1)[0] > 0, 1.0, -1.0)
    # ka6
    sr2, si2 = planes((2, n, cx), 2)
    esr2, esi2 = ints((2, n, cx), 2, rows=rows)
    # the y-stages: stacks at the size the stepper gives them, and the
    # constant (u, v) stacks of the exact cases
    w6r, w6i = planes((6, hny, cy), 2, n * math.sqrt(cy))
    w4r, w4i = planes((4, hny, cy), 2, n * math.sqrt(cy))
    zx, zy, qx, qy, src, u, v = planes((n, cy), 7)
    ew6 = torch.zeros((6, hny, cy), device=dev)
    ew6[2:4, 0] = torch.stack(ints((cy,), 2)) * float(n * cy)
    ew4 = ew6[:4].contiguous()
    ezero = torch.zeros((n, cy), device=dev)
    eqx, esrc, ezx, ezy = ints((n, cy), 4, rows=rows)
    eu, ev = ints((n, cy), 2, -2, 2)
    # the x-stages: one field (tail, kx_fwd, none) and two (the tracer's)
    fr, fi, zsr, zsi, z0r, z0i, r1r, r1i, r2r, r2i, r3r, r3i = planes(
        (n, cx), 12)
    efr, efi = ints((n, cx), 2, rows=rows)
    elap, ezsr, ezsi, ez0r, ez0i, er1r, er1i, er2r, er2i, er3r, er3i = ints(
        (n, cx), 11, -2, 2)
    emask, = ints((n, cx), 1, 0, 1)
    f2r, f2i, l2, z2r, z2i, a2r, a2i = planes((2, n, cx), 7)
    ef2r, ef2i = ints((2, n, cx), 2, rows=rows)
    el2, ez2r, ez2i, ea2r, ea2i = ints((2, n, cx), 5, -2, 2)
    tail = (z0r, z0i, r1r, r1i, r2r, r2i, r3r, r3i, 1.5)
    etail = (ez0r, ez0i, er1r, er1i, er2r, er2i, er3r, er3i, 0.5)
    return {
        "ka6_fast": FastCase(
            lambda: ft.tracer_xstage_planes(sr2, si2, kx, ky, rlap,
                                            fast=True),
            lambda: ft.ka6_fast_plain(sr2, si2, rlap, kx, ky),
            lambda: ft.tracer_xstage_planes(sr2, si2, kx, ky, rlap),
            lambda: ft.tracer_xstage_planes(esr2, esi2, ekx, eky, erl,
                                            fast=True),
            lambda: ft.ka6_fast_plain(esr2, esi2, erl, ekx, eky),
            _fields_f32, (sr2, si2, rlap), 6 * cx),
        "kb_adv_tracer_fast": FastCase(
            lambda: ft.kb_adv_tracer(zx, zy, qx, qy, w6r, w6i, src, 0.3,
                                     fast=True),
            lambda: ft.kb_adv_tracer_fast_plain(zx, zy, qx, qy, w6r, w6i,
                                                src, 0.3),
            lambda: ft.kb_adv_tracer(zx, zy, qx, qy, w6r, w6i, src, 0.3),
            lambda: ft.kb_adv_tracer(ezero, ezero, eqx, ezero, ew6, ew6,
                                     esrc, fast=True),
            lambda: ft.kb_adv_tracer_fast_plain(ezero, ezero, eqx, ezero,
                                                ew6, ew6, esrc),
            _fields_f32, (zx, zy, qx, qy, w6r[2:4], w6i[2:4], src), 2 * cy),
        "kx_visc_tracer_fast": FastCase(
            lambda: ff.kx_visc(f2r, f2i, l2, mask, z2r, z2i, 1.0,
                               (a2r, a2i, 1.5), fast=True),
            lambda: ff.kx_visc_fast_plain(f2r, f2i, l2, mask, z2r, z2i, 1.0,
                                          (a2r, a2i, 1.5)),
            lambda: ff.kx_visc(f2r, f2i, l2, mask, z2r, z2i, 1.0,
                               (a2r, a2i, 1.5)),
            lambda: ff.kx_visc(ef2r, ef2i, el2, emask, ez2r, ez2i, 1.0,
                               (ea2r, ea2i, 0.5), fast=True),
            lambda: ff.kx_visc_fast_plain(ef2r, ef2i, el2, emask, ez2r,
                                          ez2i, 1.0, (ea2r, ea2i, 0.5)),
            _fields_f32, (f2r, f2i, l2, mask, z2r, z2i, a2r, a2i), 2 * cx),
        "ky_adv_fast": FastCase(
            lambda: ff.ky_adv(u, zx, v, zy, src, 0.3, fast=True),
            lambda: ff.ky_adv_fast_plain(u, zx, v, zy, src, 0.3),
            lambda: ff.ky_adv(u, zx, v, zy, src, 0.3),
            lambda: ff.ky_adv(eu, ezx, ev, ezy, esrc, fast=True),
            lambda: ff.ky_adv_fast_plain(eu, ezx, ev, ezy, esrc),
            list, (u, zx, v, zy, src), 0.5 * cy),
        "kb_adv_full_fast": FastCase(
            lambda: ff.kb_adv_full(w4r, w4i, src, 0.3, fast=True),
            lambda: ff.kb_adv_full_fast_plain(w4r, w4i, src, 0.3),
            lambda: ff.kb_adv_full(w4r, w4i, src, 0.3),
            lambda: ff.kb_adv_full(ew4, ew4, esrc, fast=True),
            lambda: ff.kb_adv_full_fast_plain(ew4, ew4, esrc),
            list, (w4r, w4i, src), 2.5 * cy),
        "kx_visc_tail_fast": FastCase(
            lambda: ff.kx_visc_tail(fr, fi, lap, mask, zsr, zsi, 6.5, tail,
                                    fast=True),
            lambda: ff.kx_visc_tail_plain(fr, fi, lap, mask, zsr, zsi, 6.5,
                                          tail, fast=True),
            lambda: ff.kx_visc_tail(fr, fi, lap, mask, zsr, zsi, 6.5, tail),
            lambda: ff.kx_visc_tail(efr, efi, elap, emask, ezsr, ezsi, 1.0,
                                    etail, fast=True),
            lambda: ff.kx_visc_tail_plain(efr, efi, elap, emask, ezsr, ezsi,
                                          1.0, etail, fast=True),
            list, (fr, fi, lap, mask, zsr, zsi) + tail[:-1], cx),
        "kx_fwd_bt_fast": FastCase(
            lambda: fs.kx_fwd(fr[None], fi[None], fast=True),
            lambda: fs.kx_fwd_fast_plain(fr[None], fi[None]),
            lambda: fs.kx_fwd(fr[None], fi[None]),
            lambda: fs.kx_fwd(efr[None], efi[None], fast=True),
            lambda: fs.kx_fwd_fast_plain(efr[None], efi[None]),
            _fields_f32, (fr, fi), cx),
        "kx_visc_none_fast": FastCase(
            lambda: ff.kx_visc(fr, fi, lap, mask, zsr, zsi, 0.0, fast=True),
            lambda: ff.kx_visc_fast_plain(fr, fi, lap, mask, zsr, zsi, 0.0),
            lambda: ff.kx_visc(fr, fi, lap, mask, zsr, zsi, 0.0),
            lambda: ff.kx_visc(efr, efi, elap, emask, ezsr, ezsi, 0.0,
                               fast=True),
            lambda: ff.kx_visc_fast_plain(efr, efi, elap, emask, ezsr, ezsi,
                                          0.0),
            list, (fr, fi, lap, mask, zsr, zsi), cx),
    }


def fast_arm_library(name: str, case: FastCase):
    """The one torch.fft call that computes a fast arm form's function on
    its inputs (complex64): ka6's ifft of the six formed fields' size
    (the states stacked three times), the stacked kx_visc's and the
    one-field kx_fwd's fft; None where no one call computes it (the
    advections, the epilogues)."""
    x = torch.complex(*case.reads[:2])
    if name == "ka6_fast":
        x = torch.cat([x] * 3)
        return lambda: torch.fft.ifft(x, dim=-2)
    if name in ("kx_visc_tracer_fast", "kx_fwd_bt_fast"):
        return lambda: torch.fft.fft(x, dim=-2)
    return None


def fast_pins(n: int, dev, seed: int) -> dict:
    """The fast forms' pins at n^2: name -> (got, want) lists of planes
    that must be equal bit for bit, the fast forms sharing their
    transforms' and epilogues' arithmetic as the strict ones do (the
    bits depend on K and the passes, not on C): kb_adv_tracer's planes
    and kb_adv_half's and kb_adv_full's output against kb_pair's fast
    form then ky_adv's fast form of each product (a zero src for q), ka6
    against ka_diag's fast form of each state, kx_visc_tail against
    kx_visc's fast form then rk4_combine, the one-field kx_fwd's fast
    form then visc against kx_visc's fast form (with and without the
    stage axpy), and the stacked kx_visc against one call per field; the
    x-first order's: the x-major kb (kb_stacked) of each pair against
    kb_pair's fast form transposed, split's two ka_quad calls against
    quad's fields, and quad's fields 0-1 against ka_diag's fast form's."""
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.ops import fused_sw as fs
    from xlab_fftbarotropic_torch.ops import fused_tracer as ft

    rng = np.random.default_rng(seed)
    hny = n // 2 + 1
    planes, _ = _makers(rng, dev)
    kx, ky, rlap, lap, mask = _fast_tables(n, None, dev, planes)
    scale = 1.0 / (n * n)
    w6r, w6i = planes((6, hny, n), 2, n * math.sqrt(n))
    zx, zy, qx, qy, src = planes((n, n), 5)
    zero = torch.zeros_like(zx)
    sr2, si2 = planes((2, n, hny), 2)
    f2r, f2i, l2, z2r, z2i, a2r, a2i = planes((2, n, hny), 7)
    fr, fi, zsr, zsi, z0r, z0i, r1r, r1i, r2r, r2i, r3r, r3i = planes(
        (n, hny), 12)
    out = {}
    u, v = ff.kb_pair(w6r, w6i, 2, 3, scale, fast=True)
    got = ft.kb_adv_tracer(zx, zy, qx, qy, w6r, w6i, src, 0.3, fast=True)
    out["kb_adv_tracer_fast"] = (
        [got[0][0], got[1][0], got[0][1], got[1][1]],
        list(ff.ky_adv(u, zx, v, zy, src, 0.3, fast=True))
        + list(ff.ky_adv(u, qx, v, qy, zero, 0.0, fast=True)))
    w4r, w4i = w6r[:4].contiguous(), w6i[:4].contiguous()
    out["kb_adv_half_fast"] = (
        list(ff.kb_adv_half(zx, zy, w4r, w4i, src, 0.3, fast=True)),
        list(ff.ky_adv(u, zx, v, zy, src, 0.3, fast=True)))
    gx, gy = ff.kb_pair(w4r, w4i, 0, 1, scale, fast=True)
    out["kb_adv_full_fast"] = (
        list(ff.kb_adv_full(w4r, w4i, src, 0.3, fast=True)),
        list(ff.ky_adv(u, gx, v, gy, src, 0.3, fast=True)))
    got = ft.tracer_xstage_planes(sr2, si2, kx, ky, rlap, fast=True)
    z = ff.ka_diag(sr2[0], si2[0], rlap, kx, ky, fast=True)
    q = ff.ka_diag(sr2[1], si2[1], rlap, kx, ky, fast=True)
    out["ka6_fast"] = ([p[f] for p in got for f in range(6)],
                       [x for p, pq in zip(z, q)
                        for x in (*p, pq[0], pq[1])])
    tail = (z0r, z0i, r1r, r1i, r2r, r2i, r3r, r3i, 1.5)
    r4 = ff.kx_visc(fr, fi, lap, mask, zsr, zsi, 6.5, fast=True)
    out["kx_visc_tail_fast"] = (
        list(ff.kx_visc_tail(fr, fi, lap, mask, zsr, zsi, 6.5, tail,
                             fast=True)),
        list(fs.plane_rk4_combine((z0r, z0i), (r1r, r1i), (r2r, r2i),
                                  (r3r, r3i), r4, 1.5)))
    gr, gi = fs.kx_fwd(fr[None], fi[None], fast=True)
    out["kx_fwd_bt_fast"] = (
        list(ff.visc(gr[0], gi[0], lap, mask, zsr, zsi, 6.5,
                     (z0r, z0i, 0.5))) + list(ff.visc(
                         gr[0], gi[0], lap, mask, zsr, zsi, 6.5)),
        list(ff.kx_visc(fr, fi, lap, mask, zsr, zsi, 6.5, (z0r, z0i, 0.5),
                        fast=True)) + list(r4))
    got = ff.kx_visc(f2r, f2i, l2, mask, z2r, z2i, 1.0, (a2r, a2i, 1.5),
                     fast=True)
    per = [ff.kx_visc(f2r[f], f2i[f], l2[f], mask, z2r[f],
                      z2i[f], 1.0, (a2r[f], a2i[f], 1.5), fast=True)
           for f in range(2)]
    out["kx_visc_tracer_fast"] = ([p[f] for p in got for f in range(2)],
                                  [x[i] for i in range(4) for x in per])
    # the x-first order's: the fast kb_stacked of each pair is the fast
    # kb_pair's output transposed; split's two calls are quad's fields,
    # whose first two are ka_diag's
    w4r, w4i = planes((4, hny, n), 2, n * math.sqrt(n))
    got, want = [], []
    for fa, fb in ((0, 1), (2, 3)):
        got += list(ff.kb_stacked(w4r, w4i, fa, fb, scale, fast=True))
        want += [x.t() for x in ff.kb_pair(w4r, w4i, fa, fb, scale,
                                           fast=True)]
    out["kb_xmajor_fast"] = (got, want)
    zr, zi = sr2[0], si2[0]
    quad = ff.ka_quad(zr, zi, rlap, kx, ky, fast=True)
    split = [torch.cat(p) for p in zip(
        ff.ka_quad(zr, zi, rlap, kx, ky, 0, 2, fast=True),
        ff.ka_quad(zr, zi, rlap, kx, ky, 2, 2, fast=True))]
    diag = ff.ka_diag(zr, zi, rlap, kx, ky, fast=True)
    out["ka_quad_split_fast"] = (split, list(quad))
    out["ka_quad_fast"] = ([q[:2] for q in quad], [d[:2] for d in diag])
    return out


def phase_fast_arms(n: int, steps: int, dev, profile: bool = False) -> dict:
    """Phase 5o, the tracer and the other barotropic arms: each form of
    FAST_ARM_KERNELS against its plain version (bit for bit on exact
    inputs, FAST_TOL on random ones) and its strict kernel (FAST_CLASS)
    at FAST_SHAPES, timed at n^2 beside its bound, its plain version, its
    strict form and one torch call where there is one; the CLI's
    -m tracer --fast-transforms runs (RK4 and ETDRK4) and the barotropic
    fast ETDRK4 and arm runs (BT_FAST_ENV), exact launches; bench.py's
    tracer configuration through TracerModel.build(..., fast=True) with
    torch.fft.* and torch.matmul raising, zeta and q each within
    FAST_TRACER_BARS of the strict kernel path (and above FAST_FLOOR);
    barotropic fast ETDRK4 (bench.py's configuration at dt 3 s) within
    FAST_BTE_BAR after 20 steps; every fast arm (FAST_ARMS; ETDRK4's
    FAST_ETD_ARMS) bit for bit the fast FUSEKB=half arm of its scheme
    after 3 steps; ms/step of each new path beside its strict
    counterpart, in turns; with `profile` the tracer fast path's
    breakdown (profile_run)."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.models.tracer import TracerModel, tracer_ic

    t_phase = time.perf_counter()
    out = {"checks": {}, "kernels": {}, "main_paths": {}}
    for family in FAST_TRACER + tuple(BT_FAST_ENV):
        out["main_paths"][family] = phase_main_path(family, n, steps)
    # bench.py's tracer configuration (gaussian flow and tracer, kappa =
    # 50, dt = 3 s) and its barotropic one, RK4 and ETDRK4
    cfg = ModelConfig(nx=n, ny=n)
    ecfg = cfg.replace(time_scheme="etdrk4")
    tr = TracerModel.build(cfg, dev, kappa=50.0, fast=True)
    t = tr.tables
    tmp = tempfile.TemporaryDirectory(prefix="xfb_smoke_")
    os.environ["XFB_ETD_CACHE"] = tmp.name    # built once, then loaded
    paths = {
        "tracer-fast": tr,
        "tracer": TracerModel.build(cfg, dev, 50.0, t),
        "tracer-fast-etdrk4": TracerModel.build(ecfg, dev, 50.0, t,
                                                fast=True),
        "tracer-etdrk4": TracerModel.build(ecfg, dev, 50.0, t),
        "barotropic-fast-etdrk4": BarotropicModel.build(ecfg, dev, t,
                                                        fast=True),
        "barotropic-etdrk4-half": BarotropicModel.build(ecfg, dev, t,
                                                        fusekb="half"),
        "barotropic-etdrk4": BarotropicModel.build(ecfg, dev, t),
        "barotropic-fast": BarotropicModel.build(cfg, dev, t, fast=True)}
    for name, arm in FAST_ARMS.items():
        paths[f"barotropic-fast-{name}"] = BarotropicModel.build(
            cfg, dev, t, fast=True, **arm)
    for name, arm in FAST_ETD_ARMS.items():
        paths[f"barotropic-fast-{name}"] = BarotropicModel.build(
            ecfg, dev, t, fast=True, **arm)
    os.environ["XFB_ETD_CACHE"] = "0"
    tmp.cleanup()
    check(tr.fast and all(m.fast for k, m in paths.items() if "fast" in k),
          "fast models' selection")
    v0 = makefields.gaussian(cfg)
    ts0 = tr.init_state(v0, tracer_ic(cfg, "gaussian"))
    bs0 = paths["barotropic-fast"].init_state(v0)
    s0 = {k: ts0 if k.startswith("tracer") else bs0 for k in paths}
    src = tr.zero_source()
    for k in ("tracer-fast", "tracer-fast-etdrk4", "barotropic-fast-etdrk4"):
        with _refusing_library():
            z = paths[k].segment(s0[k], src, 2)
            torch.cuda.synchronize()
        check(all(bool(torch.isfinite(torch.view_as_real(x)).all())
                  for x in (z if isinstance(z, tuple) else (z,))),
              f"{k} state not finite")
        log(f"no library transform: 2 steps of the {k} path at {n}^2 ran "
            f"with torch.fft.* and torch.matmul raising")
    for (k_steps, scheme), bar in FAST_TRACER_BARS.items():
        etd = "-etdrk4" if scheme == "etdrk4" else ""
        a = paths["tracer-fast" + etd].diags(
            paths["tracer-fast" + etd].segment(ts0, src, k_steps))
        b = paths["tracer" + etd].diags(
            paths["tracer" + etd].segment(ts0, src, k_steps))
        e = {}
        for f in ("vort", "q"):
            check(bool(torch.isfinite(getattr(a, f)).all()),
                  f"tracer fast {f} not finite")
            e[f] = rel_l2(getattr(a, f), getattr(b, f))
        log(f"fast tracer trajectory: {scheme}, {k_steps} steps at {n}^2, "
            f"rel-L2 against the strict kernel path: zeta {e['vort']:.3e}, "
            f"q {e['q']:.3e} (bar {bar:g})")
        for f, x in e.items():
            check(FAST_FLOOR < x <= bar, f"fast tracer {scheme} after "
                                         f"{k_steps} steps: {f} rel-L2 "
                                         f"{x:.3e} outside ({FAST_FLOOR:g}, "
                                         f"{bar:g}]")
        out[f"tracer_{scheme}_{k_steps}_steps"] = e
    m = paths["barotropic-fast-etdrk4"]
    a = m.diags(m.segment(bs0, src, 20)).vort
    b = m.diags(paths["barotropic-etdrk4"].segment(bs0, src, 20)).vort
    check(bool(torch.isfinite(a).all()), "fast barotropic ETDRK4 not finite")
    rel = rel_l2(a, b)
    log(f"fast barotropic ETDRK4 trajectory: 20 steps at {n}^2, rel-L2 of "
        f"vort against the strict kernel path {rel:.3e} (bar "
        f"{FAST_BTE_BAR:g})")
    check(FAST_FLOOR < rel <= FAST_BTE_BAR, f"fast barotropic ETDRK4: "
                                            f"rel-L2 {rel:.3e}")
    out["bt_etdrk4_20_steps"] = rel
    ref = {s: paths[k].segment(bs0, src, 3) for s, k in (
        ("rk4", "barotropic-fast"), ("etd", "barotropic-fast-etdrk4"))}
    same = {}
    for name in list(FAST_ARMS) + list(FAST_ETD_ARMS):
        z = paths[f"barotropic-fast-{name}"].segment(bs0, src, 3)
        same[name] = bool(torch.equal(
            z, ref["etd" if name.startswith("etd") else "rk4"]))
    log(f"fast barotropic arms, 3 steps at {n}^2, bit for bit the fast "
        f"FUSEKB=half arm of their scheme: {same}")
    check(all(same.values()), f"a fast arm differs from the half arm: "
                              f"{same}")
    out["arms_bit_identical"] = same
    order = ("tracer-fast", "tracer", "tracer-fast-etdrk4", "tracer-etdrk4",
             "barotropic-fast-etdrk4", "barotropic-etdrk4-half",
             "barotropic-etdrk4", "barotropic-fast",
             *(f"barotropic-fast-{a}" for a in FAST_ARMS))
    times = _timed_turns({k: paths[k] for k in order}, s0, src, steps)
    for k, ts in times.items():
        ms = sum(ts) / len(ts)
        out[f"ms_per_step_{k}"] = ms
        log(f"time {k:30s}: {ms:.3f} ms/step "
            f"({', '.join(f'{x:.3f}' for x in ts)}), "
            f"{n * n / (ms * 1e-3):.4e} grid-points/s")
    if profile:
        out["profile"] = profile_run(
            "tracer-fast", lambda: tr.segment(ts0, src, 5), 5)
    log(f"phase 5o (tracer and arms): paths done at "
        f"{time.perf_counter() - t_phase:.1f} s")
    shapes = [(64, None), (256, None), (n, None)] + [
        s for s in FAST_SHAPES if s[1] is not None]
    for size, cols in dict.fromkeys(shapes):
        cases = fast_arm_cases(size, cols, dev, size + (cols or 0) + 2)
        where = f"{size}^2" if cols is None else f"{size} x {cols}"
        for name, case in cases.items():
            out["checks"][f"{name} {where}"] = fast_check(name, case, where)
            if (size, cols) != (n, None):
                continue
            raw = case.plain()
            got, want = case.fields(case.kern()), case.fields(raw)
            bound_ms, bound_by, parts = fast_bound(case, raw, size)
            out["kernels"][name] = time_row(
                name, case.kern, case.plain, case.strict,
                fast_arm_library(name, case), bound_ms, bound_by, size,
                max(float((g - w).abs().max()) for g, w in zip(got, want)),
                plain_iters=3, parts=parts)
            out["kernels"][name]["rel_l2"] = \
                out["checks"][f"{name} {where}"]["rel_l2_plain"]
    for size in dict.fromkeys((256, n)):
        for name, (got, want) in fast_pins(size, dev, size + 3).items():
            same = (len(got) == len(want)
                    and all(bool(torch.equal(g, w)) for g, w in zip(got,
                                                                  want)))
            log(f"fast pin {name:20s} {size}^2: bit for bit its fast "
                f"constituents: {same}")
            check(same, f"fast pin {name} at {size}^2")
            out["checks"][f"pin {name} {size}^2"] = same
    log(f"phase 5o (tracer and arms): kernel checks done at "
        f"{time.perf_counter() - t_phase:.1f} s")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 5o (tracer and arms): {out['wall_s']:.1f} s")
    return out


class Bf16Case(NamedTuple):
    """A bf16 form (kx_fwd's bf16 store, a combine on bf16 products) on
    random inputs: the kernel, its plain version, the float32 form whose
    bits it must give (rounded to bf16 for the store; on the upcast
    products for a combine), the strict float32 kernel on float32
    inputs (timed beside it), the outputs of a result, the tensors it
    reads, its complex transforms and the one torch call that computes
    the same function, where there is one."""
    kern: Callable
    plain: Callable
    ref: Callable
    strict: Callable
    fields: Callable
    reads: tuple
    ffts: float = 0.0
    library: Optional[Callable] = None


def bf16_cases(n: int, dev, seed: int) -> dict:
    """name -> Bf16Case at the n x n grid's shapes: kx_fwd's bf16 store
    on the strict tile, and sw_combine (with the axpy and the forcing;
    without the axpy; split with no forcing) and sw_combine_mv (with and
    without the tendency) on bf16 product spectra, the state at the
    bench's magnitudes. The names of BF16_KERNELS are the rows the JSON
    line reports; the others are variants."""
    from xlab_fftbarotropic_torch.ops import fused_sw as fs
    from xlab_fftbarotropic_torch.ops.spectral import SpectralTables

    rng = np.random.default_rng(seed)
    hny = n // 2 + 1
    planes, _ = _makers(rng, dev)
    t = SpectralTables.build(n, n, 600_000.0, 600_000.0, device=dev)
    pr, pi = planes((5, n, hny), 2)
    pc = torch.complex(pr, pi)
    p16 = (pr.to(torch.bfloat16), pi.to(torch.bfloat16))
    up = tuple(p.float() for p in p16)
    amps = (1e-4, 1e-4, 1e-6, 1e-6, 5.0, 5.0)
    sw = tuple(a * p for a, p in zip(amps, planes((n, hny), 6)))
    sw0 = tuple(a * p for a, p in zip(amps, planes((n, hny), 6)))
    src = tuple(planes((n, hny), 2))
    q = torch.stack(planes((3, n, hny), 3)) * 10.0
    rest = (sw, src, t.kx, t.ky, t.lap, t.mask, 1e-4, 9.81, 6.5, 4000.0)
    mv = (sw, src, t.kx, t.ky, t.lap, t.mask, 0.0, 0.0, 0.0, 0.0, sw0, q)
    reads = (*sw[:4], *src, t.lap, t.mask)
    axpy = dict(axpy=(sw0, 0.4235))

    def stage(out):                       # (tendency, next stage state)
        return [*(out[0] or ()), *out[1]]

    def comb(kw, fields, extra=()):
        def on(p):
            return lambda: fs.sw_combine(*p, *rest, **kw)
        return Bf16Case(on(p16), lambda: fs.sw_combine_plain(*p16, *rest,
                                                             **kw),
                        on(up), on((pr, pi)), fields, (*p16, *reads, *extra))

    def comb_mv(emit, scale=1.0):
        def on(p):
            return lambda: fs.sw_combine_mv(*p, *mv, scale, emit)
        return Bf16Case(on(p16), lambda: fs.sw_combine_mv_plain(
            *p16, *mv, scale, emit), on(up), on((pr, pi)), stage,
            (*p16, *reads, *sw0, q))

    def split_no_src(p):
        return lambda: fs.sw_combine(*p, sw, None, *rest[2:], True)
    return {
        "kx_fwd_bf16": Bf16Case(
            lambda: fs.kx_fwd(pr, pi, pstore="bf16"),
            lambda: fs.kx_fwd_plain(pr, pi, "bf16"),
            lambda: tuple(x.to(torch.bfloat16) for x in fs.kx_fwd(pr, pi)),
            lambda: fs.kx_fwd(pr, pi), _fields_f32, (pr, pi), 5 * hny,
            lambda: torch.fft.fft(pc, dim=-2)),
        "sw_combine_bf16": comb(axpy, stage, sw0),
        "sw_combine_bf16_no_axpy": comb({}, list),
        "sw_combine_bf16_split_no_src": Bf16Case(
            split_no_src(p16), lambda: fs.sw_combine_plain(
                *p16, sw, None, *rest[2:], True), split_no_src(up),
            split_no_src((pr, pi)), list, (*p16, *sw, t.lap, t.mask)),
        "sw_combine_mv_bf16": comb_mv(True),
        "sw_combine_mv_bf16_no_tend": comb_mv(False),
        "sw_combine_mv_bf16_scale2": comb_mv(True, 2.0),
    }


def _flat(out) -> list:
    """The tensors of a result: tuples of them, or of tuples (a stage's
    (tendency, next state)), None left out."""
    return [x for o in out if o is not None
            for x in (o if isinstance(o, tuple) else (o,))]


def bf16_check(name: str, case: Bf16Case, where: str) -> dict:
    """A bf16 form against the float32 form it rounds or widens (bit for
    bit) and its plain version: a combine within TOL (max err over max
    |plain|), kx_fwd's store within FAST_TOL rel-L2 (bf16 neighbours
    where the kernel and the torch call round a float32 apart); raises
    past either."""
    got, ref = case.fields(case.kern()), case.fields(case.ref())
    plain = case.fields(case.plain())
    torch.cuda.synchronize()
    same = all(bool(torch.equal(g, r)) for g, r in zip(got, ref))
    if name.startswith("kx_fwd"):
        err, bar, what = (max(rel_l2(g, w) for g, w in zip(got, plain)),
                          FAST_TOL, "rel-L2")
    else:
        err, bar, what = (max(float((g - w).abs().max() / w.abs().max())
                              for g, w in zip(got, plain)), TOL,
                          "max err / max|plain|")
    log(f"bf16 {name:28s} {where}: bit for bit its float32 form "
        f"({'rounded' if name.startswith('kx_fwd') else 'on the upcast'}"
        f") {same}; {what} vs plain {err:.3e}")
    check(same, f"{name} at {where}: not the bits of its float32 form")
    check(err <= bar, f"{name} at {where}: {what} {err:.3e} against its "
                      f"plain version > {bar}")
    return dict(bits_of_f32_form=same, err_plain=err)


def time_row(name: str, kern, plain, strict, library, bound_ms: float,
             bound_by: str, n: int, abs_err: float, plain_iters: int = 20,
             parts: Optional[dict] = None) -> dict:
    """A kernel's JSON-line numbers at n^2: its time, its plain
    version's (plain_iters calls), the strict kernel's and the torch
    call's (where there is one), beside its bound; logged."""
    ms = cuda_ms(kern)
    plain_ms = cuda_ms(plain, iters=plain_iters, warmup=1)
    strict_ms = cuda_ms(strict)
    library_ms = None if library is None else cuda_ms(library)
    lib = ("" if library_ms is None
           else f", one torch call {library_ms:.4f} ms")
    extra = "" if not parts else (
        f": bytes {parts['bytes_ms']:.4f} ms, bf16 products "
        f"{parts['bf16_ms']:.5f} ms + float32 rest {parts['fp32_ms']:.5f} ms")
    log(f"kernel {name:24s} {n}^2: {ms:.4f} ms, the strict form "
        f"{strict_ms:.4f} ms, plain torch version {plain_ms:.4f} ms{lib}; "
        f"bound {bound_ms:.4f} ms ({bound_by}{extra}; "
        f"{100.0 * bound_ms / ms:.1f} % of it reached)")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                strict_ms=strict_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, **(parts or {}))


def fast_sw_library(name: str, n: int, dev):
    """The one torch.fft call of a fast SW form's transform on its
    formed input at n^2 (complex64): ka_sw's ifft of the four formed
    fields, ky_all's rfft of the five formed products, kx_fwd's fft."""
    hny = n // 2 + 1
    if name == "ka_sw_fast":
        x = torch.complex(*(torch.randn((2, 4, n, hny), device=dev)))
        return lambda: torch.fft.ifft(x, dim=1)
    if name == "ky_all_fast":
        x = torch.randn((5, n, n), device=dev)
        return lambda: torch.fft.rfft(x, dim=1)
    x = torch.complex(*(torch.randn((2, 5, n, hny), device=dev)))
    return lambda: torch.fft.fft(x, dim=-2)


def sw_fields_of(state, n: int) -> dict:
    """The physical zeta, div and eta of a SW state."""
    return {k: torch.fft.irfft2(z, s=(n, n))
            for k, z in zip(("zeta", "div", "eta"), state)}


def phase_fast_sw(n: int, steps: int, dev, profile: bool = False) -> dict:
    """Phase 5o, shallow water: each fast SW form against its plain
    version (bit for bit on exact inputs, FAST_TOL on random ones) and
    its strict kernel (FAST_CLASS) at FAST_SHAPES, kx_fwd's bf16 store
    the rounding of its float32 form bit for bit; the bf16 store of the
    strict tile and the bf16-product combines bit for bit their float32
    forms at 256^2 and n^2; each timed at n^2 beside its bound, its
    plain version, its strict form and one torch call where there is
    one. The CLI's -m sw --fast-transforms runs (RK4 and ETDRK4, exact
    launches), the fast run with the float32 store and the strict run
    with the bf16 store through ShallowWaterModel.build (exact
    launches); bench.py's SW configuration through
    ShallowWaterModel.build(..., fast=True) with torch.fft.* and
    torch.matmul raising, held to the strict kernel path at
    FAST_SW_BARS (RK4 after 20 and 200 steps, ETDRK4 at dt 7.5 s after
    20), div's error printed, the split-linear formulation's eta gain,
    the float32 store within the 20-step bars, the unfused RK form bit
    for bit; ms/step of the fast and strict RK4 and ETDRK4 paths (and
    the float32 store), in turns; with `profile` the fast RK4 path's
    breakdown (profile_run)."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel, max_stable_dt)

    t_phase = time.perf_counter()
    out = {"checks": {}, "kernels": {}, "main_paths": {}}
    shapes = [(64, None), (256, None), (n, None)] + [
        s for s in FAST_SHAPES if s[1] is not None]
    for size, cols in dict.fromkeys(shapes):
        cases = fast_sw_cases(size, cols, dev, size + (cols or 0) + 1)
        where = f"{size}^2" if cols is None else f"{size} x {cols}"
        for name, case in cases.items():
            out["checks"][f"{name} {where}"] = fast_check(name, case, where)
        # the bf16 store is the rounding of the float32 store's bits
        a = cases["kx_fwd_fast"].kern()
        b = cases["kx_fwd_fast_f32"].kern()
        same = all(bool(torch.equal(x, y.to(torch.bfloat16)))
                   for x, y in zip(a, b))
        log(f"fast kx_fwd_fast {where}: the bf16 store is the float32 "
            f"store rounded, bit for bit: {same}")
        check(same, f"kx_fwd_fast at {where}: not its float32 store "
                    f"rounded")
        if (size, cols) != (n, None):
            continue
        for name, case in cases.items():
            raw = case.plain()
            got, want = case.fields(case.kern()), case.fields(raw)
            bound_ms, bound_by, parts = fast_bound(case, raw, size)
            out["kernels"][name] = time_row(
                name, case.kern, case.plain, case.strict,
                fast_sw_library(name, size, dev), bound_ms, bound_by, size,
                max(float((g - w).abs().max()) for g, w in zip(got, want)),
                plain_iters=3, parts=parts)
            out["kernels"][name]["rel_l2"] = \
                out["checks"][f"{name} {where}"]["rel_l2_plain"]
    for size in dict.fromkeys((256, n)):
        for name, case in bf16_cases(size, dev, size + 5).items():
            out["checks"][f"{name} {size}^2"] = bf16_check(name, case,
                                                           f"{size}^2")
            if size != n or name not in BF16_KERNELS:
                continue
            raw = case.plain()
            got, want = case.fields(case.kern()), case.fields(raw)
            bound_ms, bound_by = bound(case, _flat(raw), n)
            out["kernels"][name] = time_row(
                name, case.kern, case.plain, case.strict, case.library,
                bound_ms, bound_by, n,
                max(float((g - w).abs().max()) for g, w in zip(got, want)))
    log(f"phase 5o (shallow water) kernel checks: "
        f"{time.perf_counter() - t_phase:.1f} s")
    for family in ("sw-fast", "sw-fast-etdrk4"):
        out["main_paths"][family] = phase_main_path(family, n, steps)
    for path in ("sw-fast-f32", "sw-pstore-bf16"):
        out["main_paths"][path] = phase_model_path(path, n, steps)
    # bench.py's SW configurations: the balanced weak vortex, dt the RK4
    # gravity-wave bound (0.847 s at 4096^2), and ETDRK4 at 7.5 s
    cfg = ModelConfig(nx=n, ny=n)
    cfg = cfg.replace(dt=min(3.0, max_stable_dt(cfg)))
    ecfg = cfg.replace(time_scheme="etdrk4", dt=SW_ETD_DT)
    with tempfile.TemporaryDirectory(prefix="xfb_smoke_") as tmp:
        os.environ["XFB_ETD_CACHE"] = tmp    # built once, then loaded
        fast = ShallowWaterModel.build(cfg, dev, fast=True)
        t = fast.tables
        models = {
            "fast": fast, "strict": ShallowWaterModel.build(cfg, dev, t),
            "fast-no-split": ShallowWaterModel.build(cfg, dev, t, fast=True,
                                                     split=False),
            "fast-f32": ShallowWaterModel.build(cfg, dev, t, fast=True,
                                                pstore="f32"),
            "fast-unfused": ShallowWaterModel.build(cfg, dev, t, fast=True,
                                                    fused_rk=False),
            "fast-etdrk4": ShallowWaterModel.build(ecfg, dev, t, fast=True),
            "strict-etdrk4": ShallowWaterModel.build(ecfg, dev, t)}
        os.environ["XFB_ETD_CACHE"] = "0"
    check(fast.fast and fast.split and fast.pstore == "bf16",
          "fast SW model form")
    s0 = fast.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5))
    src = fast.zero_source()
    for k in ("fast", "fast-etdrk4"):
        with _refusing_library():
            z = models[k].segment(s0, src, 2)
            torch.cuda.synchronize()
        check(all(bool(torch.isfinite(torch.view_as_real(x)).all())
                  for x in z), f"{k} state not finite")
        log(f"no library transform: 2 steps of the SW {k} path at {n}^2 "
            f"ran with torch.fft.* and torch.matmul raising")

    def errors(k, ref, steps_):
        a = sw_fields_of(models[k].segment(s0, src, steps_), n)
        b = sw_fields_of(models[ref].segment(s0, src, steps_), n)
        for f, x in a.items():
            check(bool(torch.isfinite(x).all()), f"{k} {f} not finite")
        e = {f: rel_l2(a[f], b[f]) for f in a}
        log(f"fast SW trajectory: {k} vs {ref}, {steps_} steps at {n}^2, "
            f"rel-L2 zeta {e['zeta']:.3e}, eta {e['eta']:.3e}, div "
            f"{e['div']:.3e} (div: no bar)")
        out[f"{k}_{steps_}_steps"] = e
        return e

    for (k_steps, scheme), (bz, be) in FAST_SW_BARS.items():
        etd = scheme == "etdrk4"
        e = errors("fast-etdrk4" if etd else "fast",
                   "strict-etdrk4" if etd else "strict", k_steps)
        for f, bar in (("zeta", bz), ("eta", be)):
            check(FAST_FLOOR < e[f] <= bar,
                  f"fast SW {scheme} after {k_steps} steps: {f} rel-L2 "
                  f"{e[f]:.3e} outside ({FAST_FLOOR:g}, {bar:g}]")
    e20 = out["fast_20_steps"]
    ens = errors("fast-no-split", "strict", 20)
    check(ens["eta"] > e20["eta"], f"split-linear did not cut eta's "
                                   f"error: {ens['eta']:.3e} without, "
                                   f"{e20['eta']:.3e} with")
    ef = errors("fast-f32", "strict", 20)
    for f, bar in zip(("zeta", "eta"), FAST_SW_BARS[(20, "rk4")]):
        check(FAST_FLOOR < ef[f] <= bar, f"fast SW float32 store: {f} "
                                         f"rel-L2 {ef[f]:.3e}")
    a = models["fast"].segment(s0, src, steps)
    b = models["fast-unfused"].segment(s0, src, steps)
    same = all(bool(torch.equal(x, y)) for x, y in zip(a, b))
    log(f"fast SW fused-RK vs unfused form, {steps} steps: bit for bit "
        f"{same}")
    check(same, "fast SW fused and unfused RK forms differ")
    out["fused_vs_unfused_bit_identical"] = same
    order = ("fast", "strict", "fast-etdrk4", "strict-etdrk4", "fast-f32")
    times = _timed_turns({k: models[k] for k in order},
                         dict.fromkeys(order, s0), src, steps)
    for k, ts in times.items():
        ms = sum(ts) / len(ts)
        out[f"ms_per_step_{k}"] = ms
        log(f"time shallow-water {k:13s}: {ms:.3f} ms/step "
            f"({', '.join(f'{x:.3f}' for x in ts)}), "
            f"{n * n / (ms * 1e-3):.4e} grid-points/s")
    if profile:
        out["profile"] = profile_run(
            "sw-fast", lambda: models["fast"].segment(s0, src, 5), 5)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 5o (shallow water): {out['wall_s']:.1f} s")
    return out


# the x-first order's fast forms (rows 11, 2's x-major form, 15, 17d on
# the fast column tile) and the strict rows they are held against
FAST_XFIRST_KERNELS = {"ka_quad_fast": "ka_quad",
                       "ka_quad_split_fast": "ka_quad_split",
                       "kb_xmajor_fast": "kb_xmajor",
                       "ka_adv_fast": "ka_adv", "kc_visc_fast": "kc_visc",
                       "ka_fwd_fast": "ka_fwd_split", "kc_sw_fast": "kc_sw"}
# the x-first fast paths' bars (the fast mode's, PERF.md section 2):
# barotropic vorticity after (steps, scheme), each path against the strict
# x-first kernel path and against the y-first fast path; the SW ones are
# FAST_SW_BARS' 20-step bars
FAST_XFIRST_BARS = {(30, "rk4"): 1e-4, (200, "rk4"): 1e-3,
                    (20, "etdrk4"): 1e-3}


def fast_xfirst_cases(n: int, cols, dev, seed: int) -> dict:
    """name -> FastCase of the x-first order's fast forms
    (FAST_XFIRST_KERNELS) for a length-n transform over `cols` columns
    (None: the n x n grid's), numpy-seeded: ka_quad, quad and split's two
    calls (the x-stage of (n, hny) planes), the x-major kb (kb_stacked of
    fields 2, 3 of a (4, n/2 + 1, nx) stack at the stepper's size),
    ka_adv (the x-stage of (n, ny) x-major fields), kc_visc (the y-stage
    of (n, nx) planes, its epilogue on (nx, n/2 + 1) tables), ka_fwd
    (u, v 3 m/s, zeta, eta_s 1e-4, split as fast mode runs it) and kc_sw
    (the y-stages of (5, n, nx) planes). The exact inputs are small
    integers on exact_rows with integer tables (the Hermitian stack on
    rows 0, n/16, .., n/2, ies 0.5), as fast_cases makes them."""
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    rng = np.random.default_rng(seed)
    hny = n // 2 + 1
    cx, cy = (hny, n) if cols is None else (cols, cols)
    planes, ints = _makers(rng, dev)
    kx, ky, rlap, _, _ = _fast_tables(n, cols, dev, planes)
    rows = exact_rows(n)
    herm = np.zeros(hny, bool)
    herm[::n // 16] = True
    # ka_quad
    zr, zi = planes((n, cx), 2)
    ezr, ezi = ints((n, cx), 2, rows=rows)
    ekx, = ints((n,), 1)
    eky, = ints((cx,), 1)
    erl, = ints((n, cx), 1, 1, 2)
    erl = erl * torch.where(ints((n, cx), 1, 0, 1)[0] > 0, 1.0, -1.0)
    tab, etab = (rlap, kx, ky), (erl, ekx, eky)
    # the x-major kb
    wr, wi = planes((4, hny, cy), 2, n * math.sqrt(cy))
    ewr, ewi = ints((4, hny, cy), 2, rows=herm)
    scale = 1.0 / (n * cy)
    # ka_adv: x-major (n, cy) fields
    u, zx, v, zy, src = planes((n, cy), 5)
    eu, ev = ints((n, cy), 2, -2, 2)
    ezx, ezy, esrc = ints((n, cy), 3, rows=rows)
    # kc_visc: (n, cy) planes, (cy, hny) tables and stage state
    xr, xi = planes((n, cy), 2)
    exr, exi = ints((n, cy), 2, rows=rows)
    lap, zsr, zsi = planes((cy, hny), 3)
    mask = (planes((cy, hny), 1)[0] > -1.0).float()
    elap, ezsr, ezsi = ints((cy, hny), 3, -2, 2)
    emask, = ints((cy, hny), 1, 0, 1)
    # ka_fwd, split on (fast mode's default)
    fields = [a * p for a, p in zip((3.0, 3.0, 1e-4, 1e-4),
                                    planes((n, cy), 4))]
    fwd_args = (*fields, 2.0 ** 15, 1e-4, 9.81, True)
    efwd_args = (*ints((n, cy), 4, rows=rows), 0.5, 1e-4, 9.81, True)
    # kc_sw of the five stacked products' x-stages
    gr, gi = planes((5, n, cy), 2)
    egr, egi = ints((5, n, cy), 2, rows=rows)

    def split_call(*a, fast=True):
        return (*ff.ka_quad(*a, 0, 2, fast=fast),
                *ff.ka_quad(*a, 2, 2, fast=fast))

    def split_plain(*a):
        return (*ff.ka_quad_fast_plain(*a, 0, 2),
                *ff.ka_quad_fast_plain(*a, 2, 2))
    return {
        "ka_quad_fast": FastCase(
            lambda: ff.ka_quad(zr, zi, *tab, fast=True),
            lambda: ff.ka_quad_fast_plain(zr, zi, *tab),
            lambda: ff.ka_quad(zr, zi, *tab),
            lambda: ff.ka_quad(ezr, ezi, *etab, fast=True),
            lambda: ff.ka_quad_fast_plain(ezr, ezi, *etab),
            _fields_f32, (zr, zi, rlap), 4 * cx),
        "ka_quad_split_fast": FastCase(
            lambda: split_call(zr, zi, *tab),
            lambda: split_plain(zr, zi, *tab),
            lambda: split_call(zr, zi, *tab, fast=False),
            lambda: split_call(ezr, ezi, *etab),
            lambda: split_plain(ezr, ezi, *etab),
            _fields_f32, (zr, zi, rlap), 4 * cx),
        "kb_xmajor_fast": FastCase(
            lambda: ff.kb_stacked(wr, wi, 2, 3, scale, fast=True),
            lambda: ff.kb_fast_plain(wr[2], wi[2], wr[3], wi[3], scale),
            lambda: ff.kb_stacked(wr, wi, 2, 3, scale),
            lambda: ff.kb_stacked(ewr, ewi, 0, 1, scale, fast=True),
            lambda: ff.kb_fast_plain(ewr[0], ewi[0], ewr[1], ewi[1], scale),
            list, (wr[2:4], wi[2:4]), cy),
        "ka_adv_fast": FastCase(
            lambda: ff.ka_adv(u, zx, v, zy, src, 0.3, fast=True),
            lambda: ff.ka_adv_fast_plain(u, zx, v, zy, src, 0.3),
            lambda: ff.ka_adv(u, zx, v, zy, src, 0.3),
            lambda: ff.ka_adv(eu, ezx, ev, ezy, esrc, fast=True),
            lambda: ff.ka_adv_fast_plain(eu, ezx, ev, ezy, esrc),
            list, (u, zx, v, zy, src), 0.5 * cy),
        "kc_visc_fast": FastCase(
            lambda: ff.kc_visc(xr, xi, lap, mask, zsr, zsi, 6.5, fast=True),
            lambda: ff.kc_visc_fast_plain(xr, xi, lap, mask, zsr, zsi, 6.5),
            lambda: ff.kc_visc(xr, xi, lap, mask, zsr, zsi, 6.5),
            lambda: ff.kc_visc(exr, exi, elap, emask, ezsr, ezsi, 1.0,
                               fast=True),
            lambda: ff.kc_visc_fast_plain(exr, exi, elap, emask, ezsr, ezsi,
                                          1.0),
            list, (xr, xi, lap, mask, zsr, zsi), cy),
        "ka_fwd_fast": FastCase(
            lambda: fs.ka_fwd(*fwd_args, fast=True),
            lambda: fs.ka_fwd_fast_plain(*fwd_args),
            lambda: fs.ka_fwd(*fwd_args),
            lambda: fs.ka_fwd(*efwd_args, fast=True),
            lambda: fs.ka_fwd_fast_plain(*efwd_args),
            _fields_f32, tuple(fields), 2.5 * cy),
        "kc_sw_fast": FastCase(
            lambda: fs.kc_sw(gr, gi, fast=True),
            lambda: ff.kc_fast_plain(gr, gi),
            lambda: fs.kc_sw(gr, gi),
            lambda: fs.kc_sw(egr, egi, fast=True),
            lambda: ff.kc_fast_plain(egr, egi),
            _fields_f32, (gr, gi), 5 * cy),
    }


def fast_xfirst_library(name: str, case: FastCase, n: int):
    """The one torch.fft call that computes an x-first fast form's
    function on its inputs (complex64): the x-major kb's irfft of the
    pair's half spectra, kc_sw's fft of the five planes (its rows k <=
    n/2 and the transpose aside, as the strict row); None where no one
    call computes it (the formed fields, the advection and products, the
    epilogue)."""
    if name == "kb_xmajor_fast":
        x = torch.complex(*case.reads[:2])
        return lambda: torch.fft.irfft(x, n=n, dim=1)
    if name == "kc_sw_fast":
        x = torch.complex(*case.reads[:2])
        return lambda: torch.fft.fft(x, dim=1)
    return None


def phase_fast_xfirst(n: int, steps: int, dev, profile: bool = False) -> dict:
    """Phase 5p, fast mode on the x-first order: the CLI's runs with
    XFB_BT_YFIRST=0 / XFB_SW_YFIRST=0 and --fast-transforms (barotropic
    and SW, RK4 and ETDRK4) and QUAD_MODE quad and split through
    BarotropicModel.build(..., fast=True), exact launches (the SW x-first
    fast path on the float32 product store and combines); bench.py's
    barotropic configuration in fast mode, x-first with ka_diag and with
    quad, with torch.fft.* and torch.matmul raising, its vorticity within
    FAST_XFIRST_BARS of the strict x-first kernel path (quad: the strict
    quad path; above FAST_FLOOR) and of the y-first fast path, split bit
    for bit quad after 3 steps; bench.py's SW configurations (RK4 at the
    gravity-wave bound, ETDRK4 at 7.5 s) x-first in fast mode, zeta and
    eta within FAST_SW_BARS' 20-step bars of the strict x-first kernel
    path and of the y-first fast path; ms/step of each fast path beside
    its strict x-first one, in turns; each fast form of
    FAST_XFIRST_KERNELS against its plain version (bit for bit on exact
    inputs, FAST_TOL on random ones) and its strict kernel (FAST_CLASS)
    at FAST_SHAPES, timed at n^2 beside its bound, its plain version,
    its strict form and one torch call where there is one; with
    `profile` the barotropic and SW x-first fast paths' breakdowns
    (profile_run)."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel, max_stable_dt)

    t_phase = time.perf_counter()
    out = {"checks": {}, "kernels": {}, "main_paths": {}}
    for family in XFIRST_FAST_CLI:
        out["main_paths"][family] = phase_main_path(family, n, steps)
    for path in ("bt-quad-fast", "bt-split-fast"):
        out["main_paths"][path] = phase_model_path(path, n, steps)
    # bench.py's barotropic configuration (dt 3 s) and its SW ones (the
    # balanced weak vortex; RK4 at the gravity-wave bound, ETDRK4 at 7.5 s)
    cfg = ModelConfig(nx=n, ny=n)
    ecfg = cfg.replace(time_scheme="etdrk4")
    scfg = cfg.replace(dt=min(3.0, max_stable_dt(cfg)))
    secfg = scfg.replace(time_scheme="etdrk4", dt=SW_ETD_DT)
    bt, sw = BarotropicModel.build, ShallowWaterModel.build
    with tempfile.TemporaryDirectory(prefix="xfb_smoke_") as tmp:
        os.environ["XFB_ETD_CACHE"] = tmp    # built once, then loaded
        xf = bt(cfg, dev, yfirst=False, fast=True)
        t = xf.tables
        models = {
            "bt-xfirst-fast": xf, "bt-xfirst": bt(cfg, dev, t, yfirst=False),
            "bt-yfirst-fast": bt(cfg, dev, t, fast=True),
            "bt-quad-fast": bt(cfg, dev, t, quad_mode="quad", fast=True),
            "bt-quad": bt(cfg, dev, t, quad_mode="quad"),
            "bt-split-fast": bt(cfg, dev, t, quad_mode="split", fast=True),
            "bt-xfirst-fast-etdrk4": bt(ecfg, dev, t, yfirst=False,
                                        fast=True),
            "bt-xfirst-etdrk4": bt(ecfg, dev, t, yfirst=False),
            "bt-yfirst-fast-etdrk4": bt(ecfg, dev, t, fast=True),
            "bt-quad-fast-etdrk4": bt(ecfg, dev, t, quad_mode="quad",
                                      fast=True),
            "bt-quad-etdrk4": bt(ecfg, dev, t, quad_mode="quad"),
            "sw-xfirst-fast": sw(scfg, dev, t, yfirst=False, fast=True),
            "sw-xfirst": sw(scfg, dev, t, yfirst=False),
            "sw-yfirst-fast": sw(scfg, dev, t, fast=True),
            "sw-xfirst-fast-etdrk4": sw(secfg, dev, t, yfirst=False,
                                        fast=True),
            "sw-xfirst-etdrk4": sw(secfg, dev, t, yfirst=False),
            "sw-yfirst-fast-etdrk4": sw(secfg, dev, t, fast=True)}
        os.environ["XFB_ETD_CACHE"] = "0"
    check(all(m.fast for k, m in models.items() if "fast" in k)
          and not any(m.yfirst for k, m in models.items()
                      if "xfirst" in k or "quad" in k or "split" in k),
          "x-first fast models' selection")
    for k in ("sw-xfirst-fast", "sw-xfirst-fast-etdrk4"):
        m = models[k]
        check(m.split and m.pstore == "f32", f"{k}: split-linear on, the "
                                             f"float32 product store")
    bs0 = xf.init_state(makefields.gaussian(cfg))
    ss0 = models["sw-xfirst-fast"].geostrophic_init(
        makefields.gaussian(scfg, zeta0=1e-5))
    s0 = {k: ss0 if k.startswith("sw") else bs0 for k in models}
    src = xf.zero_source()
    for k in ("bt-xfirst-fast", "bt-quad-fast", "bt-xfirst-fast-etdrk4",
              "sw-xfirst-fast", "sw-xfirst-fast-etdrk4"):
        with _refusing_library():
            z = models[k].segment(s0[k], src, 2)
            torch.cuda.synchronize()
        check(all(bool(torch.isfinite(torch.view_as_real(x)).all())
                  for x in (z if isinstance(z, tuple) else (z,))),
              f"{k} state not finite")
        log(f"no library transform: 2 steps of the {k} path at {n}^2 ran "
            f"with torch.fft.* and torch.matmul raising")

    def vort_rel(a, b, k_steps):
        x = models[a].diags(models[a].segment(bs0, src, k_steps)).vort
        y = models[b].diags(models[b].segment(bs0, src, k_steps)).vort
        check(bool(torch.isfinite(x).all()), f"{a} vort not finite")
        return rel_l2(x, y)

    for (k_steps, scheme), bar in FAST_XFIRST_BARS.items():
        etd = "-etdrk4" if scheme == "etdrk4" else ""
        for a, b in ((f"bt-xfirst-fast{etd}", f"bt-xfirst{etd}"),
                     (f"bt-xfirst-fast{etd}", f"bt-yfirst-fast{etd}"),
                     (f"bt-quad-fast{etd}", f"bt-quad{etd}")):
            rel = vort_rel(a, b, k_steps)
            log(f"fast x-first trajectory: {a} vs {b}, {k_steps} steps at "
                f"{n}^2, rel-L2 of vort {rel:.3e} (bar {bar:g})")
            # the floor holds fast mode off strict; two fast paths may
            # share most of their rounding (the bf16 DFT-16 matrix)
            floor = 0.0 if "fast" in b else FAST_FLOOR
            check(floor < rel <= bar, f"{a} vs {b} after {k_steps} "
                                      f"steps: rel-L2 {rel:.3e}")
            out[f"{a}_vs_{b}_{k_steps}_steps"] = rel
    same = bool(torch.equal(models["bt-split-fast"].segment(bs0, src, 3),
                            models["bt-quad-fast"].segment(bs0, src, 3)))
    log(f"fast split vs quad, 3 steps at {n}^2: bit for bit {same}")
    check(same, "fast split differs from fast quad")
    out["split_vs_quad_bit_identical"] = same
    for scheme in ("rk4", "etdrk4"):
        etd = "-etdrk4" if scheme == "etdrk4" else ""
        bz, be = FAST_SW_BARS[(20, scheme)]
        a = sw_fields_of(models[f"sw-xfirst-fast{etd}"].segment(ss0, src,
                                                                20), n)
        for ref in (f"sw-xfirst{etd}", f"sw-yfirst-fast{etd}"):
            b = sw_fields_of(models[ref].segment(ss0, src, 20), n)
            e = {f: rel_l2(a[f], b[f]) for f in a}
            log(f"fast x-first SW trajectory: sw-xfirst-fast{etd} vs {ref}, "
                f"20 steps at {n}^2, rel-L2 zeta {e['zeta']:.3e}, eta "
                f"{e['eta']:.3e}, div {e['div']:.3e} (div: no bar)")
            floor = 0.0 if "fast" in ref else FAST_FLOOR
            for f, bar in (("zeta", bz), ("eta", be)):
                check(bool(torch.isfinite(a[f]).all()), f"SW {f} not finite")
                check(floor < e[f] <= bar,
                      f"sw-xfirst-fast{etd} vs {ref}: {f} rel-L2 "
                      f"{e[f]:.3e} outside ({floor:g}, {bar:g}]")
            out[f"sw-xfirst-fast{etd}_vs_{ref}_20_steps"] = e
    order = ("bt-xfirst-fast", "bt-xfirst", "bt-quad-fast", "bt-quad",
             "bt-xfirst-fast-etdrk4", "bt-xfirst-etdrk4", "sw-xfirst-fast",
             "sw-xfirst", "sw-xfirst-fast-etdrk4", "sw-xfirst-etdrk4")
    times = _timed_turns({k: models[k] for k in order}, s0, src, steps)
    for k, ts in times.items():
        ms = sum(ts) / len(ts)
        out[f"ms_per_step_{k}"] = ms
        log(f"time {k:22s}: {ms:.3f} ms/step "
            f"({', '.join(f'{x:.3f}' for x in ts)}), "
            f"{n * n / (ms * 1e-3):.4e} grid-points/s")
    if profile:
        out["profile"] = {k: profile_run(
            k, lambda k=k: models[k].segment(s0[k], src, 5), 5)
            for k in ("bt-xfirst-fast", "sw-xfirst-fast")}
    log(f"phase 5p: paths done at {time.perf_counter() - t_phase:.1f} s")
    shapes = [(64, None), (256, None), (n, None)] + [
        s for s in FAST_SHAPES if s[1] is not None]
    for size, cols in dict.fromkeys(shapes):
        cases = fast_xfirst_cases(size, cols, dev, size + (cols or 0) + 4)
        where = f"{size}^2" if cols is None else f"{size} x {cols}"
        for name, case in cases.items():
            out["checks"][f"{name} {where}"] = fast_check(name, case, where)
            if (size, cols) != (n, None):
                continue
            raw = case.plain()
            got, want = case.fields(case.kern()), case.fields(raw)
            bound_ms, bound_by, parts = fast_bound(case, raw, size)
            out["kernels"][name] = time_row(
                name, case.kern, case.plain, case.strict,
                fast_xfirst_library(name, case, size), bound_ms, bound_by,
                size, max(float((g - w).abs().max())
                          for g, w in zip(got, want)),
                plain_iters=3, parts=parts)
            out["kernels"][name]["rel_l2"] = \
                out["checks"][f"{name} {where}"]["rel_l2_plain"]
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 5p: {out['wall_s']:.1f} s")
    return out


# phase 5q: the last fast forms (rows 12, 13 single, 14, 21, 22 on the
# fast column tile) and the strict rows they are held against
FAST_REST_KERNELS = {"ka_fast": "ka", "ka_inverse_fast": "ka_complex_inverse",
                     "kc_fast": "kc", "kb_single_fast": "kb_single",
                     "xstage_fast": "xstage",
                     "xstage_gather_fast": "xstage_gather",
                     "xstage_scatter_fast": "xstage_scatter"}
FAST_XSTAGES = ("xstage_fast", "xstage_gather_fast", "xstage_scatter_fast")
# the fast paths' bars: the sharded overlap run's vorticity against the
# strict overlap run after `steps` steps (a stage's rounding enters
# through dt times the tendency, as on the plane steppers), and the fast
# adjoint gradient against the strict one at the twin's first guess:
# its misfit is a tenth of the field, so the two end transforms' bf16
# error (about 3e-3 each) shows about ten times in the gradient (the JAX
# fast mode's gradient is in the same class at 64^2,
# tests/test_torch_fast_transforms.py)
FAST_SHARD_BAR = 1e-4
FAST_GRAD_BAR = 1e-1
# the fast paths driven through the CLI in phase 5q, and the models
FAST_REST_CLI = ("sw-drag-fast", "shard-slab-overlap-fast",
                 "shard-xpencil-overlap-fast")
FAST_SHARD_MODELS = ("shard4-slab-overlap-fast",
                     "shard4-xpencil-overlap-fast",
                     "shard4-slab-overlap-fast-etdrk4",
                     "shard4-xpencil-overlap-fast-etdrk4")
FAST_ENS_MEMBERS = 4


def fast_rest_cases(n: int, cols, dev, seed: int, p: int = 4) -> dict:
    """name -> FastCase of the per-transform pipeline's and the overlap
    x-stages' fast forms (FAST_REST_KERNELS) for a length-n transform over
    `cols` columns (None: the n x n grid's: ny = n for ka's real forward
    and kc, hny for ka's complex inverse, kb and the x-stages),
    numpy-seeded: ka's real forward at scale 1 (rfft2's) and complex
    inverse at scale 0.37, kc, kb's single form (irfft2's, a zero
    partner), and on p shards the x-stage's inverse at 1/n (the form 16
    of a step's 20 take), the gather (forward) and the scatter (inverse
    at 1/n) of an (n, hny) half spectrum. The exact inputs are small
    integers on exact_rows (kb's on the Hermitian rows 0, n/16, .., n/2)."""
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.parallel import dfft
    from xlab_fftbarotropic_torch.parallel import fused_overlap as fo
    from xlab_fftbarotropic_torch.parallel.pencil import padded_half

    rng = np.random.default_rng(seed)
    hny = n // 2 + 1
    cx, cy = (hny, n) if cols is None else (cols, cols)
    planes, ints = _makers(rng, dev)
    rows = exact_rows(n)
    herm = np.zeros(hny, bool)
    herm[::n // 16] = True
    xr, xi = planes((n, cy), 2)
    exr, exi = ints((n, cy), 2, rows=rows)
    zr, zi = planes((n, cx), 2)
    ezr, ezi = ints((n, cx), 2, rows=rows)
    wr, wi = planes((hny, cy), 2, n * math.sqrt(cy))
    ewr, ewi = ints((hny, cy), 2, rows=herm)
    scale = 1.0 / (n * cy)
    # the x-stages: row shards of an (n, cx) half spectrum, and x-pencil
    # shards of another (its pad columns zero)
    w = padded_half(cx, p) // p

    def pencil(a):
        full = torch.zeros((n, p * w), dtype=a.dtype, device=dev)
        full[:, :cx] = a
        return full.reshape(n, p, w).permute(1, 0, 2).contiguous()

    g, gc = (torch.complex(*planes((n, cx), 2)) for _ in range(2))
    eg, egc = (torch.complex(*ints((n, cx), 2, rows=rows)) for _ in range(2))
    srows, esrows = (dfft.shard_rows(a, p).contiguous() for a in (g, eg))
    scols, escols = pencil(gc), pencil(egc)
    s = 1.0 / n

    def kb1(*a, fast=True):
        return ff.kb(*a, None, None, scale, fast=fast)[:1]

    def cplx(out):
        return [torch.view_as_real(out)]

    return {
        "ka_fast": FastCase(
            lambda: ff.ka(xr, None, True, fast=True),
            lambda: ff.ka_fast_plain(xr, None, True),
            lambda: ff.ka(xr, None, True),
            lambda: ff.ka(exr, None, True, fast=True),
            lambda: ff.ka_fast_plain(exr, None, True),
            list, (xr,), cy),
        "ka_inverse_fast": FastCase(
            lambda: ff.ka(zr, zi, False, 0.37, fast=True),
            lambda: ff.ka_fast_plain(zr, zi, False, 0.37),
            lambda: ff.ka(zr, zi, False, 0.37),
            lambda: ff.ka(ezr, ezi, False, 0.37, fast=True),
            lambda: ff.ka_fast_plain(ezr, ezi, False, 0.37),
            list, (zr, zi), cx),
        "kc_fast": FastCase(
            lambda: ff.kc(xr, xi, fast=True),
            lambda: ff.kc_fast_plain(xr, xi),
            lambda: ff.kc(xr, xi),
            lambda: ff.kc(exr, exi, fast=True),
            lambda: ff.kc_fast_plain(exr, exi),
            list, (xr, xi), cy),
        "kb_single_fast": FastCase(
            lambda: kb1(wr, wi),
            lambda: ff.kb_fast_plain(wr, wi, None, None, scale)[:1],
            lambda: kb1(wr, wi, fast=False),
            lambda: kb1(ewr, ewi),
            lambda: ff.kb_fast_plain(ewr, ewi, None, None, scale)[:1],
            list, (wr, wi), cy),
        "xstage_fast": FastCase(
            lambda: fo.xstage(srows, False, s, fast=True),
            lambda: fo.xstage_plain(srows, False, s, fast=True),
            lambda: fo.xstage(srows, False, s),
            lambda: fo.xstage(esrows, False, s, fast=True),
            lambda: fo.xstage_plain(esrows, False, s, fast=True),
            cplx, (srows,), cx),
        "xstage_gather_fast": FastCase(
            lambda: fo.xstage_gather(srows, fast=True),
            lambda: fo.xstage_gather_plain(srows, fast=True),
            lambda: fo.xstage_gather(srows),
            lambda: fo.xstage_gather(esrows, fast=True),
            lambda: fo.xstage_gather_plain(esrows, fast=True),
            cplx, (srows,), cx),
        "xstage_scatter_fast": FastCase(
            lambda: fo.xstage_scatter(scols, cx, False, s, fast=True),
            lambda: fo.xstage_scatter_plain(scols, cx, False, s, fast=True),
            lambda: fo.xstage_scatter(scols, cx, False, s),
            lambda: fo.xstage_scatter(escols, cx, False, s, fast=True),
            lambda: fo.xstage_scatter_plain(escols, cx, False, s,
                                            fast=True),
            cplx, (scols,), cx),
    }


def fast_rest_library(name: str, case: FastCase, n: int):
    """The one torch.fft call that computes a fast form's transform on its
    inputs (complex64 where the input is complex): ka's fft or ifft along
    x, kc's fft along y (its rows k <= n/2 and the transpose aside, as the
    strict row), kb's irfft along y, the x-stages' fft or ifft along x of
    the global array padded to the x-pencil's P w columns (the transposes
    aside; shard_cases' figure for the strict rows)."""
    if name == "ka_fast":
        x = case.reads[0]
        return lambda: torch.fft.fft(x, dim=0)
    if name in ("ka_inverse_fast", "kc_fast", "kb_single_fast"):
        x = torch.complex(*case.reads[:2])
        if name == "kb_single_fast":
            return lambda: torch.fft.irfft(x, n=n, dim=0)
        return ((lambda: torch.fft.ifft(x, dim=0)) if name ==
                "ka_inverse_fast" else (lambda: torch.fft.fft(x, dim=0)))
    from xlab_fftbarotropic_torch.parallel.pencil import padded_half

    x = case.reads[0]
    if name == "xstage_scatter_fast":
        g = x.permute(1, 0, 2).reshape(x.shape[1], -1)
    else:
        p, _, cx = x.shape
        g = torch.cat([x, x.new_zeros((p, x.shape[1],
                                       padded_half(cx, p) - cx))], -1)
        g = g.reshape(n, -1)
    if name == "xstage_gather_fast":
        return lambda: torch.fft.fft(g, dim=0)
    return lambda: torch.fft.ifft(g, dim=0)


def _shard_vort(m, z, n: int) -> torch.Tensor:
    """A sharded state's physical vorticity through the library inverse
    (the model's own diags run its distributed inverse, fast or not)."""
    return torch.fft.irfft2(m.unshard_spectral(z), s=(n, n))


def _records_equal(a: Path, b: Path) -> bool:
    names = sorted(p.name for p in a.glob("*.bin"))
    return bool(names) and names == sorted(p.name for p in b.glob(
        "*.bin")) and all((a / k).read_bytes() == (b / k).read_bytes()
                          for k in names)


def phase_fast_rest(n: int, steps: int, dev, profile: bool = False) -> dict:
    """Phase 5q, the last fast forms: each of FAST_REST_KERNELS against
    its plain version (bit for bit on exact inputs, FAST_TOL on random
    ones) and its strict form (FAST_CLASS) at 64^2, 256^2, n^2, 256 x 200
    and 1024 x 33 (the x-stages on 4 shards, and at 256^2 on 1, 2 and
    8), timed at n^2 beside its bound, plain version, strict form and
    torch call; the CLI's -m sw --fast-transforms with --r-drag and --nu4
    (phase 5c's configuration: exactly 40 ka_fast, 8 kb_fast and 24
    kc_fast per step) and --shard --shard-fft overlap --fast-transforms
    on one shard, slab and x-pencil; the forcing spectrum once per
    segment on ka_fast and kc_fast on the plane stepper, and the fast
    rfft2's bits; the fast SW drag path through ShallowWaterModel.build
    with torch.fft.* and torch.matmul raising, zeta and eta within
    FAST_SW_BARS' 20-step RK4 bars of the strict drag path, above
    FAST_FLOOR; cli.assimilate.main --fast-transforms (phase 5e's twin
    experiment: exact fast launches, the cost falling), its gradient at
    the first guess against the strict kernels' (FAST_GRAD_BAR, above
    FAST_FLOOR); the four-shard overlap models in fast mode (slab and
    x-pencil, RK4 and ETDRK4: exact launches, vorticity within
    FAST_SHARD_BAR of the strict overlap run after `steps` steps, above
    FAST_FLOOR), the pallas and xla impls with fast=True bit for bit
    their strict runs; --ensemble 4 --ensemble-width 1 --ensemble-amp 0
    --fast-transforms, every member's records the solo fast run's byte
    for byte, and width 2 with --fast-transforms the strict width-2
    run's; -m fd --fast-transforms byte for byte -m fd, and the FD
    core's cold-start Jacobi solve on the card against the CPU's
    (logged); ms/step of each new path beside its strict one, in turns;
    with `profile` the breakdowns of the fast SW drag path, the fast
    adjoint gradient and the fast slab overlap path."""
    from xlab_fftbarotropic_torch import adjoint
    from xlab_fftbarotropic_torch.cli import assimilate
    from xlab_fftbarotropic_torch.cli import run as cli_run
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.io.fieldio import write_field
    from xlab_fftbarotropic_torch.models.fd_core import FDBarotropicModel
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel, max_stable_dt)
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.ops import fused_sw as fs
    from xlab_fftbarotropic_torch.parallel import (ShardedBarotropicModel,
                                                   make_mesh)

    t_phase = time.perf_counter()
    out = {"checks": {}, "kernels": {}, "main_paths": {}}
    # -- the kernels
    shapes = [(64, None), (256, None), (n, None)] + [
        s for s in FAST_SHAPES if s[1] is not None]
    for size, cols in dict.fromkeys(shapes):
        cases = fast_rest_cases(size, cols, dev, size + (cols or 0) + 8)
        where = f"{size}^2" if cols is None else f"{size} x {cols}"
        for name, case in cases.items():
            out["checks"][f"{name} {where}"] = fast_check(name, case, where)
            if (size, cols) != (n, None):
                continue
            raw = case.plain()
            got, want = case.fields(case.kern()), case.fields(raw)
            bound_ms, bound_by, parts = fast_bound(case, want, size)
            out["kernels"][name] = time_row(
                name, case.kern, case.plain, case.strict,
                fast_rest_library(name, case, size), bound_ms, bound_by,
                size, max(float((g - w).abs().max())
                          for g, w in zip(got, want)),
                plain_iters=3, parts=parts)
            out["kernels"][name]["rel_l2"] = \
                out["checks"][f"{name} {where}"]["rel_l2_plain"]
    for p in (1, 2, 8):
        cases = fast_rest_cases(256, None, dev, 300 + p, p)
        for name in FAST_XSTAGES:
            out["checks"][f"{name} 256^2 P={p}"] = fast_check(
                name, cases[name], f"256^2 on {p} shards")
    log(f"phase 5q: kernels done at {time.perf_counter() - t_phase:.1f} s")
    # -- the fast paths through the CLI
    for family in FAST_REST_CLI:
        out["main_paths"][family] = phase_main_path(family, n, steps)
    # -- the forcing spectrum: the fast rfft2's bits, once per segment
    cfg = ModelConfig(nx=n, ny=n)
    scfg = cfg.replace(dt=min(3.0, max_stable_dt(cfg)))
    src = 1e-9 * torch.from_numpy(makefields.gaussian(cfg)).to(dev)
    spec = torch.complex(*fs.forward_planes(src, True))
    same = bool(torch.equal(spec, ff.rfft2(src, fast=True)))
    strict_spec = ff.rfft2(src)
    check(same and not torch.equal(spec, strict_spec),
          "the fast forcing spectrum is not the fast rfft2's bits")
    plane = ShallowWaterModel.build(scfg, dev, fast=True)
    s0 = plane.geostrophic_init(makefields.gaussian(scfg, zeta0=1e-5))
    ff.reset_launches()
    plane.segment(s0, src, 1)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ff.LAUNCHES.items() if v}
    want = {k: v for k, v in PER_STEP["sw-fast"].items()}
    want.update(ka_fast=1, kc_fast=1)
    log(f"forcing spectrum in fast mode: forward_planes(src, fast) is the "
        f"fast rfft2 bit for bit ({same}), rel-L2 "
        f"{rel_l2(spec, strict_spec):.3e} from the strict one; a forced "
        f"plane-stepper step launches {launches}")
    check(launches == want, f"forced fast SW step launches {launches} != "
                            f"{want}")
    # -- the fast SW drag path against the strict one
    dcfg = cfg.replace(dt=min(SW_DRAG_DT_MAX, max_stable_dt(cfg)),
                       r_drag=SW_R_DRAG, nu4=example12_nu4(n))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        drag = {"sw-drag-fast": ShallowWaterModel.build(dcfg, dev,
                                                        fast=True)}
        drag["sw-drag"] = ShallowWaterModel.build(
            dcfg, dev, drag["sw-drag-fast"].tables)
    check(all(m.per_transform for m in drag.values())
          and drag["sw-drag-fast"].fast and drag["sw-drag-fast"].split,
          "the fast SW drag path's selection")
    ds0 = drag["sw-drag"].geostrophic_init(makefields.gaussian(dcfg,
                                                               zeta0=1e-5))
    dsrc = drag["sw-drag"].zero_source()
    with _refusing_library():
        z = drag["sw-drag-fast"].segment(ds0, dsrc, 2)
        torch.cuda.synchronize()
    check(all(bool(torch.isfinite(torch.view_as_real(x)).all()) for x in z),
          "fast SW drag state not finite")
    bz, be = FAST_SW_BARS[(20, "rk4")]
    a, b = (sw_fields_of(drag[k].segment(ds0, dsrc, 20), n)
            for k in ("sw-drag-fast", "sw-drag"))
    e = {f: rel_l2(a[f], b[f]) for f in a}
    log(f"fast SW drag trajectory: 20 steps at {n}^2 (dt {dcfg.dt:.4f} s, "
        f"r_drag {SW_R_DRAG:g}, nu4 {dcfg.nu4:.4g}), rel-L2 vs the strict "
        f"drag path: zeta {e['zeta']:.3e}, eta {e['eta']:.3e}, div "
        f"{e['div']:.3e} (div: no bar)")
    for f, bar in (("zeta", bz), ("eta", be)):
        check(bool(torch.isfinite(a[f]).all()), f"fast SW drag {f}")
        check(FAST_FLOOR < e[f] <= bar, f"fast SW drag {f} rel-L2 "
                                        f"{e[f]:.3e} outside ({FAST_FLOOR:g},"
                                        f" {bar:g}]")
    out["sw_drag_fast_vs_strict_20_steps"] = e
    # -- the adjoint in fast mode
    w = ADJ_WINDOW
    truth = torch.from_numpy(makefields.gaussian(cfg)).to(dev)
    zsrc = torch.zeros(cfg.grid_shape, device=dev)
    with torch.no_grad():
        target = adjoint.make_rollout(cfg, w, device=dev)(truth, zsrc)
    guess = 0.9 * truth
    with tempfile.TemporaryDirectory(prefix="xfb_smoke_adj_") as tmp:
        tmp = Path(tmp)
        write_field(tmp / "target.bin", target.cpu().numpy())
        write_field(tmp / "guess.bin", guess.cpu().numpy())
        rc, _, err, launches = _cli_main(assimilate.main, [
            "--nx", str(n), "--ny", str(n), "--target",
            str(tmp / "target.bin"), "--guess", str(tmp / "guess.bin"),
            "--out", str(tmp / "rec.bin"), "--steps", str(w), "--iters",
            str(ADJ_ITERS), "--lr", repr(ADJ_LR), "--device", "cuda",
            "--fast-transforms"])
        check(rc == 0, f"cli.assimilate.main --fast-transforms returned {rc}")
        check("# fast transforms:" in err, "no fast banner")
        losses = np.loadtxt(tmp / "rec.bin.loss.txt")
    want = {**dict.fromkeys(ff.LAUNCHES, 0),
            **{f"{k}_fast": v for k, v in adjoint_launches(
                w, gradients=ADJ_ITERS, forwards=2).items()}}
    log(f"adjoint-fast main path: cli.assimilate.main --fast-transforms at "
        f"{n}^2 (window {w}), {ADJ_ITERS} Adam iterations: cost "
        f"{losses[0]:.6e} -> {losses[-1]:.6e} (ratio "
        f"{losses[-1] / losses[0]:.4e}); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    check(launches == want, f"fast adjoint launches {launches} != {want}")
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"fast cost history {losses}")
    out["main_paths"]["adjoint-fast"] = dict(launches=launches,
                                             losses=losses.tolist())
    vg = {f: adjoint.loss_and_grad(adjoint.final_state_misfit(
        cfg, target, w, device=dev, fast=f), device=dev)
        for f in (True, False)}
    with _refusing_library():
        _, g_fast = vg[True](guess, zsrc)
        torch.cuda.synchronize()
    _, g_strict = vg[False](guess, zsrc)
    grel = rel_l2(g_fast, g_strict)
    log(f"fast adjoint gradient at {n}^2, window {w}: rel-L2 {grel:.3e} "
        f"against the strict kernels' (bar {FAST_GRAD_BAR:g}); the fast "
        f"loss and backward() ran with torch.fft.* and torch.matmul "
        f"raising")
    check(FAST_FLOOR < grel <= FAST_GRAD_BAR,
          f"fast adjoint gradient rel-L2 {grel:.3e}")
    out["adjoint_grad_fast_vs_strict"] = grel
    gtimes = {True: [], False: []}
    for f in (True, False, False, True):
        vg[f](guess, zsrc)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        vg[f](guess, zsrc)
        end.record()
        end.synchronize()
        gtimes[f].append(start.elapsed_time(end) / w)
    for f, ts in gtimes.items():
        k = "fast" if f else "strict"
        out[f"adjoint_grad_ms_per_window_step_{k}"] = sum(ts) / len(ts)
        log(f"time adjoint gradient {k:6s}: {sum(ts) / len(ts):.3f} ms per "
            f"window step ({', '.join(f'{t:.3f}' for t in ts)})")
    # -- the sharded overlap impl in fast mode on four shards
    mesh = make_mesh(4, dev)
    ecfg = cfg.replace(time_scheme="etdrk4", nu4=example12_nu4(n))
    v0 = makefields.gaussian(cfg)
    shard = {}
    for name in FAST_SHARD_MODELS:
        _, decomp, _, _, *etd = name.split("-")
        c = ecfg if etd else cfg
        m = ShardedBarotropicModel.build(c, mesh, "overlap", decomp,
                                         fast=True)
        ref = ShardedBarotropicModel.build(c, mesh, "overlap", decomp)
        check(m.fast and not ref.fast, f"{name} selection")
        z0, src4 = m.init_state(v0), m.zero_source()
        torch.cuda.synchronize()
        ff.reset_launches()
        with _refusing(shard_refused("overlap")):
            z = m.segment(z0, src4, steps)
            torch.cuda.synchronize()
        launches = dict(ff.LAUNCHES)
        want = {k: PER_STEP[name].get(k, 0) * steps for k in ff.LAUNCHES}
        check(launches == want, f"{name} launches {launches} != {want}")
        zr = ref.segment(z0, src4, steps)
        a, b = _shard_vort(m, z, n), _shard_vort(ref, zr, n)
        check(bool(torch.isfinite(a).all()), f"{name} vort not finite")
        rel = rel_l2(a, b)
        log(f"{name}: {steps} steps at {n}^2 on 4 shards, launches "
            f"{ {k: v for k, v in launches.items() if v} }; rel-L2 of vort "
            f"vs the strict overlap run {rel:.3e} (bar {FAST_SHARD_BAR:g})")
        check(FAST_FLOOR < rel <= FAST_SHARD_BAR,
              f"{name} rel-L2 {rel:.3e} outside ({FAST_FLOOR:g}, "
              f"{FAST_SHARD_BAR:g}]")
        out["main_paths"][name] = dict(launches=launches)
        out[f"{name}_vs_strict"] = rel
        shard[name] = (m, z0, src4)
        if not etd:
            shard[name.replace("-fast", "")] = (ref, z0, src4)
    for decomp in SHARD_DECOMPS:
        for impl in ("xla", "pallas"):
            runs = [ShardedBarotropicModel.build(cfg, mesh, impl, decomp,
                                                 fast=f) for f in (True,
                                                                   False)]
            z0 = runs[0].init_state(v0)
            za, zb = (r.segment(z0, runs[0].zero_source(), 2) for r in runs)
            same = bool(torch.equal(za, zb)) and not runs[0].fast
            log(f"shard4-{decomp}-{impl} with fast=True: 2 steps bit for "
                f"bit the strict run: {same}")
            check(same, f"shard4-{decomp}-{impl}: fast=True changed bits")
    # -- the ensemble and the FD core through the CLI
    with tempfile.TemporaryDirectory(prefix="xfb_smoke_") as tmp:
        tmp = Path(tmp)
        (tmp / "input").mkdir()
        write_field(tmp / "input" / cfg.init_file, v0)

        def run(name, *extra):
            rc, _, err, launches = _cli_main(cli_run.main, _bt_argv(
                n, steps, tmp / "input", tmp / name, tmp / f"{name}.log",
                *extra))
            check(rc == 0, f"cli.run.main {' '.join(extra)} returned {rc}")
            return launches, err

        solo, _ = run("solo", "--fast-transforms")
        ens = ("--ensemble", str(FAST_ENS_MEMBERS), "--ensemble-amp", "0")
        launches, _ = run("ens1", *ens, "--ensemble-width", "1",
                          "--fast-transforms")
        want = {k: FAST_ENS_MEMBERS * v for k, v in solo.items()}
        check(launches == want, f"fast ensemble launches {launches} != "
                                f"{want}")
        members = [f"m{k:02d}" for k in range(FAST_ENS_MEMBERS)]
        same = all(_records_equal(tmp / "solo", tmp / "ens1" / k)
                   for k in members)
        log(f"fast ensemble: {FAST_ENS_MEMBERS} members x {steps} steps at "
            f"{n}^2, width 1, amp 0: every member's records the solo fast "
            f"run's byte for byte: {same}; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        check(same, "a fast width-1 member is not the solo fast run")
        out["main_paths"]["ensemble-fast"] = dict(launches=launches)
        run("ens2-fast", *ens, "--ensemble-width", "2", "--fast-transforms")
        run("ens2", *ens, "--ensemble-width", "2")
        same = all(_records_equal(tmp / "ens2-fast" / k, tmp / "ens2" / k)
                   for k in members)
        log(f"fast ensemble width 2 (batched chunks on torch.fft): records "
            f"the strict width-2 run's byte for byte: {same}")
        check(same, "a fast width-2 chunk is not its strict run")
        run("fd", "-m", "fd")
        launches, err = run("fd-fast", "-m", "fd", "--fast-transforms")
        same = _records_equal(tmp / "fd", tmp / "fd-fast")
        log(f"-m fd --fast-transforms: {steps} steps at {n}^2, records "
            f"byte for byte -m fd's: {same}; no launch: "
            f"{not any(launches.values())}")
        check(same and not any(launches.values())
              and "runs torch.fft" in err, "-m fd in fast mode")
    # the FD core's cold-start Jacobi solve, card against CPU (logged:
    # an open check, not a bar)
    small = ModelConfig(nx=64, ny=64)
    z_small = makefields.gaussian(small)
    cold = []
    for where in (dev, torch.device("cpu")):
        fm = FDBarotropicModel.build(small, where, tol=1e-3, max_iter=2000,
                                     solver="jacobi")
        z = torch.from_numpy(z_small).to(where)
        zz, pp = fm.segment(z, torch.zeros_like(z), fm.zero_source(), 3)
        cold.append((zz.cpu(), pp.cpu(), [int(s) for s in fm.sweeps]))
    out["fd_cold_start"] = dict(
        zeta_rel_l2=rel_l2(cold[0][0], cold[1][0]),
        psi_rel_l2=rel_l2(cold[0][1], cold[1][1]),
        sweeps_card=cold[0][2], sweeps_cpu=cold[1][2])
    log(f"fd cold start (psi guess 0) at 64^2, 3 steps, Jacobi tol 1e-3, "
        f"max 2000 sweeps: card vs CPU rel-L2 zeta "
        f"{out['fd_cold_start']['zeta_rel_l2']:.3e}, psi "
        f"{out['fd_cold_start']['psi_rel_l2']:.3e} (the FD core's bar "
        f"{TOL:g}); sweeps card {cold[0][2]}, CPU {cold[1][2]}")
    # -- time, in turns
    paths = {"sw-drag-fast": drag["sw-drag-fast"], "sw-drag": drag["sw-drag"]}
    s0 = dict.fromkeys(paths, ds0)
    for k in ("shard4-slab-overlap-fast", "shard4-slab-overlap",
              "shard4-xpencil-overlap-fast", "shard4-xpencil-overlap"):
        paths[k] = shard[k][0]
        s0[k] = shard[k][1]
    srcs = {k: (dsrc if k.startswith("sw") else shard[k][2]) for k in paths}
    times = {k: [] for k in paths}
    for k in list(paths) + list(reversed(list(paths))):
        m = paths[k]
        m.segment(s0[k], srcs[k], 2)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m.segment(s0[k], srcs[k], steps)
        end.record()
        end.synchronize()
        times[k].append(start.elapsed_time(end) / steps)
    for k, ts in times.items():
        ms = sum(ts) / len(ts)
        out[f"ms_per_step_{k}"] = ms
        log(f"time {k:28s}: {ms:.3f} ms/step "
            f"({', '.join(f'{x:.3f}' for x in ts)})")
    if profile:
        m = drag["sw-drag-fast"]
        sm, sz, ss = shard["shard4-slab-overlap-fast"]
        out["profile"] = {
            "sw-drag-fast": profile_run(
                "sw-drag-fast", lambda: m.segment(ds0, dsrc, 5), 5),
            "adjoint-gradient-fast": profile_run(
                "adjoint-gradient-fast", lambda: vg[True](guess, zsrc), w),
            "shard4-slab-overlap-fast": profile_run(
                "shard4-slab-overlap-fast", lambda: sm.segment(sz, ss, 5),
                5)}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 5q: {out['wall_s']:.1f} s")
    return out


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
        log(f"xtile fast passes {size}^2: {p.fast_radices} (radix 16 on the "
            f"tensor cores, then float32)")
    text = (Path(_build.LAST_BUILD["path"]).parent / "build.log").read_text()
    for fn, body in re.findall(r"Compiling entry function '(\w+)'"
                               r"(.*?)Compile time", text, re.S):
        name = next((k for k in kernel_functions()
                     if re.search(rf"\d{k}(E|I)", fn)), fn)
        regs = int(re.search(r"Used (\d+) registers", body).group(1))
        st, ld = (int(v) for v in re.search(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads",
            body).groups())
        tag = ptxas_tag(name, fn)
        while tag in out["ptxas"]:              # template instances
            tag += "'"
        out["ptxas"][tag] = dict(registers=regs, spill_stores=st,
                                 spill_loads=ld)
        log(f"ptxas {tag:36s}: {regs} registers, spill stores {st} B, "
            f"spill loads {ld} B")
    return out


def ptxas_tag(name: str, fn: str) -> str:
    """A kernel instance's name in the ptxas lines: the kernel's, and
    "fast" and "bf16" where those template flags are set (the combines:
    "bf16" for the bf16 product type)."""
    args = re.search(rf"\d{name}I((?:L[a-z]+n?\d+E)+)E", fn)
    vals = re.findall(r"L([a-z]+)(n?\d+)E", args.group(1)) if args else []
    set_ = [f for f, (t, v) in zip(TEMPLATE_FLAGS.get(name, ()), vals)
            if t == "b" and v == "1" and f in ("fast", "bf16")]
    if re.search(rf"\d{name}I\d+__nv_bfloat16E", fn):
        set_.append("bf16")
    return " ".join([name] + set_)


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
                if case.launch is not None:
                    out = case.launch()
                    torch.cuda.synchronize()
                    check(torch.equal(out, want[0]), f"{name}: the bare "
                          f"launch is not its plain version's bits")
                    launch_ms = cuda_ms(case.launch)
                    log(f"kernel {name:24s} {size}^2: the bare launch "
                        f"{launch_ms:.4f} ms, through the wrapper "
                        f"{ms:.4f} ms; bound {bound_ms:.4f} ms "
                        f"({100.0 * bound_ms / launch_ms:.1f} % of it "
                        f"reached alone)")
                    report[name]["launch_ms"] = launch_ms
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
    tracer = ["-m", "tracer", "--tracer-kappa", "50", "--tracer-ic",
              "gaussian"]
    fields, extra = {
        "barotropic": (["vort"], []),
        "tracer": (["vort", "q"], tracer),
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
        # fast mode (phase 5o)
        "barotropic-fast": (["vort"], ["--fast-transforms"]),
        "sw-fast": (["vort", "div", "h"], sw_rk4 + ["--fast-transforms"]),
        "sw-fast-etdrk4": (["vort", "div", "h"],
                           sw_etd + ["--fast-transforms"]),
        "tracer-fast": (["vort", "q"], tracer + ["--fast-transforms"]),
        "tracer-fast-etdrk4": (["vort", "q"], tracer + [
            "--time-scheme", "etdrk4", "--fast-transforms"]),
        **{f: (["vort"], ["--fast-transforms"] + (
            ["--time-scheme", "etdrk4"] if "etdrk4" in f else []))
           for f in BT_FAST_ENV},
        # the x-first order's fast mode (phase 5p)
        "bt-xfirst-fast": (["vort"], ["--fast-transforms"]),
        "bt-xfirst-fast-etdrk4": (["vort"], ["--fast-transforms",
                                             "--time-scheme", "etdrk4"]),
        "sw-xfirst-fast": (["vort", "div", "h"],
                           sw_rk4 + ["--fast-transforms"]),
        "sw-xfirst-fast-etdrk4": (["vort", "div", "h"],
                                  sw_etd + ["--fast-transforms"]),
        # the sharded model on one shard: shard-<decomp>-<impl>[-fast]
        **{f: (["vort"], ["--shard", "--decomp", f.split("-")[1],
                          "--shard-fft", f.split("-")[2]]
               + (["--fast-transforms"] if f.endswith("-fast") else []))
           for f in SHARD_CLI + FAST_REST_CLI[1:]},
        # phase 5r: the sharded SW and tracer families on one shard
        "shard-sw-slab-overlap": (["vort", "div", "h"], sw_rk4 + [
            "--shard", "--decomp", "slab", "--shard-fft", "overlap"]),
        "shard-tracer-xpencil-pallas": (["vort", "q"], tracer + [
            "--shard", "--decomp", "xpencil", "--shard-fft", "pallas"]),
        # phase 5q: the SW drag path in fast mode
        "sw-drag-fast": (["vort", "div", "h"],
                         ["-m", "sw", "--dt",
                          repr(min(SW_DRAG_DT_MAX, max_stable_dt(cfg))),
                          "--r-drag", repr(SW_R_DRAG), "--nu4",
                          repr(example12_nu4(n)), "--fast-transforms"]),
    }[family]
    if family in SW_FAMILIES + ("shard-sw-slab-overlap",):
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
            kind = ("sw" if family in SW_FAMILIES else "tracer"
                    if family.startswith("tracer") else "barotropic")
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
    fused_rk=False), the balanced weak vortex), the SW fast mode with the
    float32 product store and the strict SW path with the bf16 one
    (SW_MODEL_PATHS), or the barotropic
    QUAD_MODE "quad" or "split" (BarotropicModel.build(..., quad_mode=
    ...), the gaussian IC; a "-fast" suffix: in fast mode); one segment of `steps` steps with the
    runner's zero forcing, the launch counters set to 0 just before it
    and read just after."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.models.shallow_water import (
        ShallowWaterModel, max_stable_dt)
    from xlab_fftbarotropic_torch.ops import fused_fft as ff

    cfg = ModelConfig(nx=n, ny=n)
    if path in SW_MODEL_PATHS:
        cfg = cfg.replace(dt=min(3.0, max_stable_dt(cfg)))
        kw = SW_MODEL_PATHS[path]
        m = ShallowWaterModel.build(cfg, "cuda", **kw)
        s0 = m.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5))
        entry = (f"ShallowWaterModel("
                 f"{', '.join(f'{k}={v!r}' for k, v in kw.items())})"
                 f".segment")
    else:
        mode = path.split("-")[1]
        fast = path.endswith("-fast")
        m = BarotropicModel.build(cfg, "cuda", quad_mode=mode, fast=fast)
        s0 = m.init_state(makefields.gaussian(cfg))
        entry = f"BarotropicModel(quad_mode={mode!r}, fast={fast}).segment"
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


def _family_state_fields(family: str, state, n: int) -> dict:
    """A global spectral state's physical fields through torch.fft
    (irfft2): SW vort, div, eta (eta from its own spectrum: h - H rounds
    it at H's float32 spacing); tracer vort, q."""
    names = ("vort", "div", "eta") if family == "sw" else ("vort", "q")
    return {k: torch.fft.irfft2(z, s=(n, n)) for k, z in zip(names, state)}


def _family_errors(family: str, got: dict, want: dict) -> dict:
    """rel-L2 of each field; for SW also each field's max abs error over
    the JAX package's norms (div over max(|div|, |zeta|), sw_errors)."""
    out = {f"{k}_rel_l2": rel_l2(got[k], want[k]) for k in want}
    if family == "sw":
        nz = float(want["vort"].abs().max())
        norms = {"vort": nz, "div": max(float(want["div"].abs().max()), nz),
                 "eta": float(want["eta"].abs().max())}
        out.update({f"{k}_max_abs_err": float((got[k] - want[k]).abs().max())
                    / m for k, m in norms.items()})
    return out


def sw_unpaired_fields(m, s0, src, steps: int, n: int) -> dict:
    """`steps` steps of a single-device library SW model `m` (its
    scheme's RK4 or ETDRK4 step) from s0 with every inverse unpaired, as
    the sharded models' are (the paired library inverse puts eps
    max|eta| into zeta), and the physical fields (_family_state_fields)
    of the result."""
    from xlab_fftbarotropic_torch.models import etdrk4 as etd
    from xlab_fftbarotropic_torch.models import shallow_water as sw
    from xlab_fftbarotropic_torch.ops import fft

    g, s = m.cfg.grid_shape, s0
    for _ in range(steps):
        s = (etd.etdrk4_step(m.tables, m.etd_tables, s, src, g,
                             fwd=fft.forward, inv=fft.inverse)
             if m.etd_tables is not None else
             sw.rk4_step(m.tables, s, src, m.dt, m.f, m.g, m.nu, m.H, g,
                         inv_pair=None))
    return _family_state_fields("sw", s, n)


def phase_sharded_families(n: int, steps: int, dev) -> dict:
    """Phase 5r: the sharded shallow-water and tracer families. Each
    family's ShardedShallowWaterModel / ShardedTracerModel.build(cfg,
    make_mesh(4, dev), impl, decomp) at n^2 for `steps` steps, every
    decomp x impl under RK4, slab/overlap under ETDRK4 and slab and
    x-pencil overlap in fast mode (bench.py's SW configuration at the RK4
    bound and at dt 7.5 s under ETDRK4; its tracer configuration, kappa =
    50), each segment with the launch counters set to 0 just before it
    and read just after, with shard_refused raising: exact launches, the
    fields against the single-device torch.fft path (unpaired for SW:
    the paired library inverse puts eps max|eta| into zeta) within
    rel-L2 TOL (SW div: max abs error over max(|div|, |zeta|)), pallas
    bit for bit xla, the fast paths within FAST_SHARD_FAMILY_BARS of the
    strict overlap path; ms/step of each in turns with the single-device
    library and kernel paths; --shard -m sw and -m tracer through
    cli.run.main on one shard; make_sharded_rollout's gradient at
    SHARD_ROLLOUT_N^2 against the single-device library and kernel
    gradients. The SW ETD tables go through the disk cache (built once,
    loaded by the second model)."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models import shallow_water as sw
    from xlab_fftbarotropic_torch.models.tracer import TracerModel, tracer_ic
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.parallel import (ShardedShallowWaterModel,
                                                   ShardedTracerModel,
                                                   make_mesh)

    t_phase = time.perf_counter()
    out = {"main_paths": {}, "trajectories": {}, "time": {}}
    for family in SHARD_FAMILY_CLI:
        out["main_paths"][family] = phase_main_path(family, n, steps)
    cfg = ModelConfig(nx=n, ny=n)
    src = torch.zeros((n, n), dtype=torch.float32, device=dev)
    mesh = make_mesh(4, dev)
    with tempfile.TemporaryDirectory(prefix="xfb_smoke_") as tmp:
        os.environ["XFB_ETD_CACHE"] = tmp
        try:
            for family in SHARD_FAMILIES:
                if family == "sw":
                    rcfg = cfg.replace(dt=min(3.0, sw.max_stable_dt(cfg)))
                    cfgs = {"rk4": rcfg, "etdrk4": cfg.replace(
                        time_scheme="etdrk4", dt=SW_ETD_DT)}
                    v0 = makefields.gaussian(cfg, zeta0=1e-5)
                    libs = {k: sw.ShallowWaterModel.build(
                        c.replace(fft_backend="xla"), dev)
                        for k, c in cfgs.items()}
                    s0 = libs["rk4"].geostrophic_init(v0)
                    ref = {k: sw_unpaired_fields(m, s0, src, steps, n)
                           for k, m in libs.items()}
                    single = {"library": libs["rk4"],
                              "kernels": sw.ShallowWaterModel.build(rcfg,
                                                                    dev)}

                    def build(c, impl, decomp, fast):
                        return ShardedShallowWaterModel.build(
                            c, mesh, impl, decomp, fast=fast)

                    def init(m):
                        return m.geostrophic_init(v0)
                else:
                    cfgs = {"rk4": cfg, "etdrk4": cfg.replace(
                        time_scheme="etdrk4")}
                    v0 = makefields.gaussian(cfg)
                    q0 = tracer_ic(cfg, "gaussian")
                    libs = {k: TracerModel.build(
                        c.replace(fft_backend="xla"), dev, kappa=50.0)
                        for k, c in cfgs.items()}
                    s0 = libs["rk4"].init_state(v0, q0)
                    ref = {k: _family_state_fields(
                        family, m.segment(s0, src, steps), n)
                        for k, m in libs.items()}
                    single = {"library": libs["rk4"],
                              "kernels": TracerModel.build(cfg, dev,
                                                           kappa=50.0)}

                    def build(c, impl, decomp, fast):
                        return ShardedTracerModel.build(
                            c, mesh, impl, decomp, fast=fast, kappa=50.0)

                    def init(m):
                        return m.init_state(v0, q0)
                runs = {f"single-{family}-{k}": m for k, m in single.items()}
                starts = {f"single-{family}-{k}": s0 for k in single}
                fields = {}
                for name in (p for p in SHARD_FAMILY_MODELS
                             if p.split("-")[1] == family):
                    _, _, decomp, impl, *mode = name.split("-")
                    scheme = "etdrk4" if mode == ["etdrk4"] else "rk4"
                    m = build(cfgs[scheme], impl, decomp, mode == ["fast"])
                    s = init(m)
                    torch.cuda.synchronize()
                    ff.reset_launches()
                    with _refusing(shard_refused(impl)):
                        z = m.segment(s, src, steps)
                        torch.cuda.synchronize()
                    launches = dict(ff.LAUNCHES)
                    want = {k: PER_STEP[name].get(k, 0) * steps
                            for k in ff.LAUNCHES}
                    log(f"{name} main path: {steps} steps at {n}^2 on 4 "
                        f"shards through {type(m).__name__}.build(..., "
                        f"{impl!r}, {decomp!r}, fast={m.fast}).segment "
                        f"({scheme}); launches "
                        f"{ {k: v for k, v in launches.items() if v} }")
                    check(launches == want,
                          f"{name} launch counts {launches} != {want}")
                    got = _family_state_fields(family, m.unshard_state(z),
                                               n)
                    for k, f in got.items():
                        check(bool(torch.isfinite(f).all()),
                              f"{name} {k} not finite")
                    fields[name] = got
                    out["main_paths"][name] = dict(launches=launches)
                    runs[name], starts[name] = m, s
                    if mode == ["fast"]:
                        continue
                    err = _family_errors(family, got, ref[scheme])
                    log(f"{name} trajectory: {steps} steps at {n}^2 vs the "
                        f"single-device torch.fft path"
                        f"{' (unpaired)' if family == 'sw' else ''}: "
                        + ", ".join(f"{k} {v:.3e}" for k, v in err.items()))
                    bars = {k: v for k, v in err.items()
                            if not k.startswith("div_rel")}
                    check(max(bars.values()) <= TOL,
                          f"{name} against the library path: {err}")
                    out["trajectories"][name] = err
                for decomp in SHARD_DECOMPS:
                    a, b = (fields[f"shard4-{family}-{decomp}-{i}"]
                            for i in ("pallas", "xla"))
                    same = all(torch.equal(a[k], b[k]) for k in a)
                    log(f"shard4-{family}-{decomp}: pallas vs xla after "
                        f"{steps} steps bit-identical: {same}")
                    check(same, f"shard4-{family}-{decomp}: pallas is not "
                                f"xla's bits")
                    out["trajectories"][
                        f"shard4-{family}-{decomp}_pallas_bit_identical"] = (
                        same)
                    name = f"shard4-{family}-{decomp}-overlap-fast"
                    err = _family_errors(
                        family, fields[name],
                        fields[f"shard4-{family}-{decomp}-overlap"])
                    log(f"{name}: {steps} steps at {n}^2 vs the strict "
                        f"overlap path: "
                        + ", ".join(f"{k} {v:.3e}" for k, v in err.items()))
                    for k, bar in FAST_SHARD_FAMILY_BARS[family].items():
                        check(1e-7 < err[f"{k}_rel_l2"] <= bar,
                              f"{name} {k} rel-L2 {err[f'{k}_rel_l2']:.3e} "
                              f"not in (1e-7, {bar}]")
                    out["trajectories"][name] = err
                times = _timed_turns(runs, starts, src, steps)
                for k, ts in times.items():
                    ms = sum(ts) / len(ts)
                    out["time"][k] = dict(ms_per_step=ms, runs_ms=ts)
                    log(f"time sharded {k:33s}: {ms:.3f} ms/step "
                        f"({', '.join(f'{t:.3f}' for t in ts)})")
                del runs, starts, libs, single, fields, ref
                torch.cuda.empty_cache()
        finally:
            os.environ["XFB_ETD_CACHE"] = "0"
    out["rollout"] = shard_rollout_gradient(dev)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 5r: {out['wall_s']:.1f} s")
    return out


def shard_rollout_gradient(dev) -> dict:
    """make_sharded_rollout (slab and x-pencil, 4 shards, the library
    transposes) at SHARD_ROLLOUT_N^2 for SHARD_ROLLOUT_STEPS steps: the
    gradient of a final-state misfit in vort0 against the single-device
    make_rollout's on torch.fft (bar SHARD_ROLLOUT_BAR of its max) and on
    the kernels (logged)."""
    from xlab_fftbarotropic_torch import adjoint
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.parallel import make_mesh

    n, steps = SHARD_ROLLOUT_N, SHARD_ROLLOUT_STEPS
    cfg = ModelConfig(nx=n, ny=n)
    v0 = torch.as_tensor(makefields.gaussian(cfg), device=dev)
    src = torch.zeros_like(v0)
    target = 0.9 * adjoint.make_rollout(cfg, steps, device=dev)(v0, src)

    def grad(roll):
        x = v0.clone().requires_grad_(True)
        loss = 0.5 * torch.mean(torch.square(roll(x, src) - target))
        (g,) = torch.autograd.grad(loss, [x])
        return g

    singles = {"library": grad(adjoint.make_rollout(
        cfg.replace(fft_backend="xla"), steps, device=dev)),
        "kernels": grad(adjoint.make_rollout(cfg, steps, device=dev))}
    out = {}
    for decomp in SHARD_DECOMPS:
        g = grad(adjoint.make_sharded_rollout(cfg, steps, make_mesh(4, dev),
                                              decomp))
        check(bool(torch.isfinite(g).all()), f"rollout {decomp} gradient")
        for k, ref in singles.items():
            err = float((g - ref).abs().max() / ref.abs().max())
            log(f"make_sharded_rollout {decomp}: {steps} steps at {n}^2, "
                f"gradient vs the single-device {k} gradient: max |d| / "
                f"max = {err:.3e}, rel-L2 {rel_l2(g, ref):.3e}")
            if k == "library":
                check(err <= SHARD_ROLLOUT_BAR,
                      f"make_sharded_rollout {decomp} gradient {err:.3e} > "
                      f"{SHARD_ROLLOUT_BAR}")
            out[f"{decomp}_vs_{k}"] = err
    return out


def pencil_refused() -> list:
    """What must not run on a pencil path: every kernel's plain twin (the
    kernels themselves are read from the launch counters) and the slab's
    library transposes; the pencil's own stages and torch.fft run."""
    from xlab_fftbarotropic_torch.ops import fused_fft, fused_sw, fused_tracer
    from xlab_fftbarotropic_torch.parallel import dfft
    from xlab_fftbarotropic_torch.parallel import fused_overlap as fo
    from xlab_fftbarotropic_torch.parallel import fused_transpose as ftr

    return [(dfft, "transpose_to_columns"), (dfft, "transpose_to_rows")] + [
        (mod, k) for mod in (fused_fft, fused_sw, fused_tracer, fo, ftr)
        for k in dir(mod) if k.endswith("_plain") and not k.startswith("_")
        and callable(getattr(mod, k))]


def _pencil_cli(family: str, n: int, steps: int, extra: list) -> tuple:
    """A --shard run of `family` through cli.run.main at n^2 for `steps`
    steps (records every steps/2), with the launch counters set to 0
    just before it and read just after, and with pencil_refused raising
    on a pencil run: (records by file name, launches, wall s)."""
    from xlab_fftbarotropic_torch.cli import run as cli_run
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.io.fieldio import read_field, write_field
    from xlab_fftbarotropic_torch.models.shallow_water import max_stable_dt
    from xlab_fftbarotropic_torch.ops import fused_fft as ff

    cfg = ModelConfig(nx=n, ny=n)
    args = {"barotropic": [],
            "sw": ["-m", "sw", "--dt", repr(min(3.0, max_stable_dt(cfg)))],
            "tracer": ["-m", "tracer", "--tracer-kappa", "50",
                       "--tracer-ic", "gaussian"]}[family]
    with tempfile.TemporaryDirectory(prefix="xfb_smoke_") as tmp:
        inp, out = Path(tmp) / "input", Path(tmp) / "output"
        inp.mkdir()
        write_field(inp / cfg.init_file, makefields.gaussian(
            cfg, zeta0=1e-5) if family == "sw" else makefields.gaussian(cfg))
        argv = ["-I", str(inp), "-O", str(out), "--nx", str(n), "--ny",
                str(n), "--total-steps", str(steps), "--record-step",
                str(steps // 2), "--manifest", str(Path(tmp) / "log"),
                "--device", "cuda", "--shard"] + args + extra
        ff.reset_launches()
        t0 = time.perf_counter()
        with _refusing(pencil_refused() if "pencil" in extra else []):
            rc = cli_run.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(ff.LAUNCHES)
        check(rc == 0, f"cli.run.main {' '.join(argv)} returned {rc}")
        records = {p.name: read_field(p, cfg.grid_shape)
                   for p in sorted(out.glob("*_step_*.bin"))}
    return records, launches, wall


def phase_pencil(n: int, steps: int, dev) -> dict:
    """Phase 5s: the 2-D pencil decomposition on the card (module note,
    5s): the CLI on the 1x1 mesh, the three families on PENCIL_MESH at
    n^2 against the x-pencil xla model and the single-device torch.fft
    path, the other mesh shapes, make_sharded_rollout's gradient, and
    ms/step in turns with the x-pencil xla and slab overlap models; no
    kernel launches and no plain twin runs (pencil_refused raises) on
    any pencil path."""
    from xlab_fftbarotropic_torch import adjoint
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models import shallow_water as sw
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.models.tracer import TracerModel, tracer_ic
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.parallel import (ShardedBarotropicModel,
                                                   ShardedShallowWaterModel,
                                                   ShardedTracerModel,
                                                   make_mesh)
    from xlab_fftbarotropic_torch.parallel.pencil import (make_pencil_mesh,
                                                          padded_half)

    t_phase = time.perf_counter()
    out = {"main_paths": {}, "trajectories": {}, "time": {}, "cli": {}}
    still = {k: 0 for k in ff.LAUNCHES}

    # the CLI on the 1x1 mesh against the one-shard slab run
    for family in ("barotropic", "sw", "tracer"):
        pen, launches, wall = _pencil_cli(family, PENCIL_SMALL_N, steps, [
            "--decomp", "pencil", "--mesh-shape", "1x1"])
        check(launches == still, f"pencil CLI {family} launched {launches}")
        slab, _, _ = _pencil_cli(family, PENCIL_SMALL_N, steps, [])
        check(sorted(pen) == sorted(slab) and pen,
              f"pencil CLI {family} records {sorted(pen)}")
        worst, same = 0.0, True
        for name, a in slab.items():
            b = pen[name]
            check(bool(np.isfinite(b).all()), f"{name} not finite")
            same = same and np.array_equal(a, b)
            if a.any():
                worst = max(worst, float(np.linalg.norm(
                    (b - a).astype(np.float64)) / np.linalg.norm(a)))
        log(f"pencil CLI -m {family}: {steps} steps at {PENCIL_SMALL_N}^2 "
            f"on the 1x1 mesh through cli.run.main in {wall:.2f} s, "
            f"launches none; its {len(pen)} records against the one-shard "
            f"slab run's: bit-identical {same}, max rel-L2 {worst:.3e}")
        check(worst <= PENCIL_CLI_BAR, f"pencil CLI {family} records "
              f"{worst:.3e} > {PENCIL_CLI_BAR}")
        out["cli"][family] = dict(bit_identical=same, rel_l2=worst,
                                  wall_s=wall)
        out["main_paths"][f"pencil-cli-{family}"] = dict(launches=launches)
    log(f"phase 5s CLI runs: {time.perf_counter() - t_phase:.1f} s in")

    # the three families on PENCIL_MESH at n^2
    cfg = ModelConfig(nx=n, ny=n)
    src = torch.zeros((n, n), dtype=torch.float32, device=dev)
    pmesh, xmesh = make_pencil_mesh(PENCIL_MESH, dev), make_mesh(4, dev)
    # the ETD tables are built on the card for each model (XFB_ETD_CACHE
    # is "0": the SW stack is 1.7 GB, which a disk cache would write out
    # and read back slower than the card builds it)
    for family in ("barotropic", "sw", "tracer"):
        if family == "barotropic":
            cfgs = {"rk4": cfg, "etdrk4": cfg.replace(
                time_scheme="etdrk4", nu4=example12_nu4(n))}
            v0 = makefields.gaussian(cfg)
            libs = {k: BarotropicModel.build(c.replace(fft_backend="xla"),
                                             dev) for k, c in cfgs.items()}
            s0 = libs["rk4"].init_state(v0)
            ref = {k: {"vort": m.diags(m.segment(s0, src, steps)).vort}
                   for k, m in libs.items()}

            def build(c, mesh, impl, decomp):
                return ShardedBarotropicModel.build(c, mesh, impl, decomp)
        elif family == "sw":
            cfgs = {"rk4": cfg.replace(dt=min(3.0, sw.max_stable_dt(cfg))),
                    "etdrk4": cfg.replace(time_scheme="etdrk4",
                                          dt=SW_ETD_DT)}
            v0 = makefields.gaussian(cfg, zeta0=1e-5)
            libs = {k: sw.ShallowWaterModel.build(
                c.replace(fft_backend="xla"), dev) for k, c in cfgs.items()}
            s0 = libs["rk4"].geostrophic_init(v0)
            ref = {k: sw_unpaired_fields(m, s0, src, steps, n)
                   for k, m in libs.items()}

            def build(c, mesh, impl, decomp):
                return ShardedShallowWaterModel.build(c, mesh, impl, decomp)
        else:
            cfgs = {"rk4": cfg}
            v0, q0 = makefields.gaussian(cfg), tracer_ic(cfg, "gaussian")
            libs = {"rk4": TracerModel.build(cfg.replace(fft_backend="xla"),
                                             dev, kappa=50.0)}
            s0 = libs["rk4"].init_state(v0, q0)
            ref = {"rk4": _family_state_fields(
                "tracer", libs["rk4"].segment(s0, src, steps), n)}

            def build(c, mesh, impl, decomp):
                return ShardedTracerModel.build(c, mesh, impl, decomp,
                                                kappa=50.0)

        def shard(m):
            return (m.shard_spectral(s0) if family == "barotropic"
                    else m.shard_state(s0))

        def fields(m, z):
            if family == "barotropic":
                return {"vort": m.unshard_physical(m.diags(z).vort)}
            return _family_state_fields(family, m.unshard_state(z), n)

        turns, starts = {}, {}
        for scheme, c in cfgs.items():
            name = f"pencil-{family}-{scheme}"
            m = build(c, pmesh, "xla", "pencil")
            x = build(c, xmesh, "xla", "xpencil")
            torch.cuda.synchronize()
            ff.reset_launches()
            with _refusing(pencil_refused()):
                z = m.segment(shard(m), m.zero_source(), steps)
                torch.cuda.synchronize()
            launches = dict(ff.LAUNCHES)
            check(launches == still, f"{name} launched {launches}")
            got = fields(m, z)
            for k, f in got.items():
                check(bool(torch.isfinite(f).all()), f"{name} {k} not finite")
            zx = x.segment(shard(x), x.zero_source(), steps)
            same = all(torch.equal(a, b) for a, b in zip(
                z if isinstance(z, tuple) else (z,),
                zx if isinstance(zx, tuple) else (zx,)))
            xf = fields(x, zx)
            dmax = max(float((got[k] - xf[k]).abs().max()
                             / xf[k].abs().max()) for k in got)
            err = _family_errors(family, got, ref[scheme])
            log(f"{name} main path: {steps} steps at {n}^2 on the "
                f"{PENCIL_MESH} mesh through {type(m).__name__}.build(..., "
                f"'xla', 'pencil').segment, launches none, plain twins "
                f"refused; vs the x-pencil xla model at P = 4: "
                f"bit-identical {same}, max |d| / max {dmax:.3e}; vs the "
                f"single-device torch.fft path"
                f"{' (unpaired)' if family == 'sw' else ''}: "
                + ", ".join(f"{k} {v:.3e}" for k, v in err.items()))
            bars = {k: v for k, v in err.items()
                    if not k.startswith("div_rel")}
            check(max(bars.values()) <= TOL,
                  f"{name} against the library path: {err}")
            out["main_paths"][name] = dict(launches=launches)
            out["trajectories"][name] = dict(err, xpencil_bit_identical=same,
                                             xpencil_max_rel=dmax)
            if scheme == "rk4":
                turns[name] = m
                turns[f"xpencil-{family}-xla"] = x
                turns[f"slab-{family}-overlap"] = build(c, xmesh, "overlap",
                                                        "slab")
                for k in list(turns)[-3:]:
                    starts[k] = shard(turns[k])
            del m, x, z, zx
        times = _timed_turns(turns, starts, src, steps)
        for k, ts in times.items():
            ms = sum(ts) / len(ts)
            out["time"][k] = dict(ms_per_step=ms, runs_ms=ts)
            log(f"time pencil {k:27s}: {ms:.3f} ms/step "
                f"({', '.join(f'{t:.3f}' for t in ts)})")
        del turns, starts, libs, ref
        torch.cuda.empty_cache()
        log(f"phase 5s {family}: {time.perf_counter() - t_phase:.1f} s in")

    # the other mesh shapes, barotropic, at PENCIL_SMALL_N^2
    m_n = PENCIL_SMALL_N
    scfg = ModelConfig(nx=m_n, ny=m_n)
    lib = BarotropicModel.build(scfg.replace(fft_backend="xla"), dev)
    z0 = lib.init_state(makefields.gaussian(scfg))
    ref = lib.diags(lib.segment(z0, lib.zero_source(), steps)).vort
    for shape in PENCIL_SHAPES:
        m = ShardedBarotropicModel.build(scfg, make_pencil_mesh(shape, dev),
                                         decomp="pencil")
        check(m.hpad == padded_half(m_n // 2 + 1, shape[0] * shape[1]),
              f"pencil {shape} pads to {m.hpad}")
        ff.reset_launches()
        with _refusing(pencil_refused()):
            z = m.segment(m.shard_spectral(z0), m.zero_source(), steps)
            torch.cuda.synchronize()
        check(dict(ff.LAUNCHES) == still, f"pencil {shape} launched")
        rel = rel_l2(m.unshard_physical(m.diags(z).vort), ref)
        log(f"pencil mesh {shape}: {steps} steps at {m_n}^2 (hny "
            f"{m_n // 2 + 1} padded to {m.hpad}), rel-L2 of vort vs the "
            f"single-device torch.fft path = {rel:.3e}")
        check(rel <= TOL, f"pencil {shape} rel-L2 {rel:.3e} > {TOL}")
        out["trajectories"][f"pencil-{shape[0]}x{shape[1]}"] = rel
    log(f"phase 5s mesh shapes: {time.perf_counter() - t_phase:.1f} s in")

    # make_sharded_rollout on the pencil
    rn, rsteps = SHARD_ROLLOUT_N, SHARD_ROLLOUT_STEPS
    rcfg = ModelConfig(nx=rn, ny=rn)
    v0 = torch.as_tensor(makefields.gaussian(rcfg), device=dev)
    target = 0.9 * adjoint.make_rollout(rcfg, rsteps, device=dev)(
        v0, torch.zeros_like(v0))

    def grad(roll):
        x = v0.clone().requires_grad_(True)
        loss = 0.5 * torch.mean(torch.square(roll(x, torch.zeros_like(v0))
                                             - target))
        (gr,) = torch.autograd.grad(loss, [x])
        return gr

    want = grad(adjoint.make_rollout(rcfg.replace(fft_backend="xla"),
                                     rsteps, device=dev))
    ff.reset_launches()
    with _refusing(pencil_refused()):
        got = grad(adjoint.make_sharded_rollout(
            rcfg, rsteps, make_pencil_mesh(PENCIL_MESH, dev), "pencil"))
    check(dict(ff.LAUNCHES) == still, "pencil rollout launched")
    check(bool(torch.isfinite(got).all()), "pencil rollout gradient")
    err = float((got - want).abs().max() / want.abs().max())
    log(f"make_sharded_rollout pencil {PENCIL_MESH}: {rsteps} steps at "
        f"{rn}^2, gradient vs the single-device library gradient: max |d| "
        f"/ max = {err:.3e}, rel-L2 {rel_l2(got, want):.3e}")
    check(err <= SHARD_ROLLOUT_BAR, f"pencil rollout gradient {err:.3e}")
    out["rollout"] = err
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 5s: {out['wall_s']:.1f} s")
    return out


def postproc_dt(cfg) -> float:
    """Phase 5k's time step: half the RK4 advective bound
    (utils/guards.py max_advective_dt) at the Kuo2004 core's speed."""
    from xlab_fftbarotropic_torch.utils.guards import max_advective_dt
    return 0.5 * max_advective_dt(cfg, KUO_U_MAX)


def _producer(argv, fifo: Path) -> subprocess.Popen:
    """cli.vort_src_input as its own process writing into `fifo`, with jax
    and the JAX package unimportable in it (an import raises)."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = sys.modules['xlab_fftbarotropic_tpu'] = "
            "None\n"
            f"sys.argv = ['vort_src_input'] + {list(argv)!r}\n"
            "runpy.run_module('xlab_fftbarotropic_torch.cli.vort_src_input',"
            " run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(HERE), XFB_FIFO=str(fifo))
    return subprocess.Popen(["sh", "-c", 'exec "$@" > "$XFB_FIFO"', "sh",
                             sys.executable, "-c", code], cwd=HERE, env=env)


def phase_postproc(n: int, dev) -> dict:
    """Phase 5k, example 02's pipeline at n^2 through the port's commands'
    main functions: cli.makefield (kuo2004); cli.vort_src_input in its own
    process, writing the forcing protocol into a FIFO that cli.run reads
    (-f) for POSTPROC_STEPS steps at postproc_dt, psi recorded every
    POSTPROC_REC; cli.invert_pres on the psi records (the launch counters
    set to 0 just before it and read just after: LAUNCHES_PER_FIELD of ka,
    kb and kc per field exactly, with torch.fft.* and torch.matmul
    raising); cli.find_min --tracks on the pressure files. Then the
    kernel-path pressure against the torch.fft path's on the same psi
    (rel-L2 <= TOL, the same deepest minimum), and the ms per inverted
    field on both paths and of find_min_n."""
    import io

    from xlab_fftbarotropic_torch.cli import find_min as cli_find_min
    from xlab_fftbarotropic_torch.cli import invert_pres as cli_invert
    from xlab_fftbarotropic_torch.cli import makefield as cli_makefield
    from xlab_fftbarotropic_torch.cli import run as cli_run
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.diagnostics.find_min import find_min_n
    from xlab_fftbarotropic_torch.diagnostics.invert_pres import (
        LAUNCHES_PER_FIELD, PressureInverter)
    from xlab_fftbarotropic_torch.io.fieldio import read_field
    from xlab_fftbarotropic_torch.ops import fused_fft as ff

    cfg = ModelConfig(nx=n, ny=n)
    dt = postproc_dt(cfg)
    steps, rec = POSTPROC_STEPS, POSTPROC_REC
    records = steps // rec
    grid = ["--nx", str(n), "--ny", str(n)]
    log(f"postproc: dt = {dt!r} s, half the RK4 advective bound at "
        f"{KUO_U_MAX} m/s (the Kuo2004 core) on {n}^2")
    out = {"dt": dt}
    with tempfile.TemporaryDirectory(prefix="xfb_smoke_") as tmp:
        tmp = Path(tmp)
        inp, odir, manifest = tmp / "input", tmp / "output", tmp / "log"
        check(cli_makefield.main(["kuo2004", "-I", str(inp)] + grid) == 0,
              "cli.makefield.main failed")
        fifo = tmp / "vort_src_fifo"
        os.mkfifo(fifo)
        producer = _producer(grid + ["--dt", repr(dt), "--total-steps",
                                     str(steps)], fifo)
        try:
            ff.reset_launches()
            t0 = time.perf_counter()
            rc = cli_run.main(["-I", str(inp), "-O", str(odir), "--dt",
                               repr(dt), "--total-steps", str(steps),
                               "--record-step", str(rec), "-f", str(fifo),
                               "--record-fields", "vort,psi", "--manifest",
                               str(manifest), "--device", "cuda"] + grid)
            wall = time.perf_counter() - t0
            run_launches = dict(ff.LAUNCHES)
        finally:
            try:
                producer_rc = producer.wait(timeout=60)
            except subprocess.TimeoutExpired:
                producer.kill()
                producer.wait()
                raise SmokeError("cli.vort_src_input did not end")
        check(rc == 0, f"cli.run.main returned {rc}")
        check(producer_rc == 0, f"cli.vort_src_input exited {producer_rc}")
        want = {k: PER_STEP["barotropic"].get(k, 0) * steps
                for k in ff.LAUNCHES}
        check(run_launches == want, f"the forced run's launches "
                                    f"{run_launches} != {want}")
        log(f"postproc run: {steps} steps at {n}^2 through cli.run.main -f "
            f"(the FIFO fed by cli.vort_src_input) in {wall:.2f} s")
        psi_files = [line for line in manifest.read_text().split()
                     if "psi_step" in line]
        check(len(psi_files) == records, f"psi records {psi_files}")
        lines = "\n".join(f"{f}=>{f.replace('psi_step', 'pres_step')}"
                          for f in psi_files)
        saved = sys.stdin
        sys.stdin = io.StringIO(lines)
        try:
            ff.reset_launches()
            with _refusing_library():
                rc = cli_invert.main(grid + ["--device", "cuda"])
                torch.cuda.synchronize()
            launches = dict(ff.LAUNCHES)
        finally:
            sys.stdin = saved
        check(rc == 0, f"cli.invert_pres.main returned {rc}")
        want = {k: LAUNCHES_PER_FIELD.get(k, 0) * records
                for k in ff.LAUNCHES}
        log(f"postproc invert: {records} fields at {n}^2 through "
            f"cli.invert_pres.main; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        check(launches == want, f"invert launches {launches} != {want}")
        out["launches"] = launches
        pres_files = [f.replace("psi_step", "pres_step") for f in psi_files]
        for f in pres_files:
            check(Path(f).stat().st_size == n * n * 4, f"{f} size")
            check(bool(np.isfinite(read_field(f, cfg.grid_shape)).all()),
                  f"{f} is not finite")
        tracks_file = tmp / "tracks.txt"
        saved = sys.stdin
        sys.stdin = io.StringIO("\n".join(pres_files))
        stdout = io.StringIO()
        try:
            with contextlib.redirect_stdout(stdout):
                rc = cli_find_min.main(grid + ["--device", "cuda",
                                               "--tracks", str(tracks_file)])
        finally:
            sys.stdin = saved
        check(rc == 0, f"cli.find_min.main returned {rc}")
        minima = stdout.getvalue().splitlines()
        check(len(minima) == 30 * records, f"{len(minima)} minima lines")
        n_tracks = len(tracks_file.read_text().splitlines())
        check(n_tracks >= 1, "no track written")
        log(f"postproc find_min: {len(minima)} minima lines, {n_tracks} "
            f"track lines; deepest of the last record: {minima[-30]}")
        out["track_lines"] = n_tracks
        kern = PressureInverter(cfg, dev)
        lib = PressureInverter(cfg.replace(fft_backend="xla"), dev)
        out["rel_l2"] = []
        for f, g in zip(psi_files, pres_files):
            psi = torch.from_numpy(read_field(f, cfg.grid_shape)).to(dev)
            got = torch.from_numpy(read_field(g, cfg.grid_shape)).to(dev)
            ref = lib(psi)
            rel = rel_l2(got, ref)
            deep_k = find_min_n(got, 1)
            deep_l = find_min_n(ref, 1)
            log(f"postproc {Path(g).name}: rel-L2 vs the torch.fft path "
                f"{rel:.3e}; deepest minimum kernels {deep_k[0][0]} "
                f"{deep_k[1][0]} {deep_k[2][0]:.6e}, torch.fft "
                f"{deep_l[0][0]} {deep_l[1][0]} {deep_l[2][0]:.6e}")
            check(rel <= TOL, f"{g}: rel-L2 {rel:.3e} > {TOL}")
            check((deep_k[0][0], deep_k[1][0]) == (deep_l[0][0],
                                                   deep_l[1][0]),
                  f"{g}: the deepest minimum moved between the paths")
            out["rel_l2"].append(rel)
        check(bool(torch.equal(kern(psi), got)),
              "the inverter is not the CLI's bits")
        p_k, p_l = kern(psi), lib(psi)
        for name, inv, p in (("kernels", kern, p_k), ("library", lib, p_l)):
            ms = cuda_ms(lambda: inv(psi))
            ms_min = cuda_ms(lambda: find_min_n(p, 30))
            log(f"time postproc {name:8s}: {ms:.3f} ms per inverted field, "
                f"find_min_n {ms_min:.3f} ms per field")
            out[f"{name}_ms_per_field"] = ms
            out[f"{name}_find_min_ms"] = ms_min
    check("jax" not in sys.modules, "a jax module was imported")
    check(not any(k.startswith("xlab_fftbarotropic_tpu")
                  for k in sys.modules), "the JAX package was imported")
    return out


def _cli_main(main, argv, stdin: str = "", refuse: bool = False):
    """main(argv) with `stdin` as its standard input, the launch counters
    set to 0 just before it and read just after, torch.fft.* and
    torch.matmul raising inside when `refuse`; returns (rc, stdout,
    stderr, launches)."""
    import io

    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        ff.reset_launches()
        with contextlib.ExitStack() as stack:
            if refuse:
                stack.enter_context(_refusing_library())
            stack.enter_context(contextlib.redirect_stdout(out))
            stack.enter_context(contextlib.redirect_stderr(err))
            rc = main(argv)
            torch.cuda.synchronize()
        launches = dict(ff.LAUNCHES)
    finally:
        sys.stdin = saved
    return rc, out.getvalue(), err.getvalue(), launches


def _bt_argv(n: int, steps: int, inp: Path, out: Path, manifest: Path,
             *extra) -> list:
    """cli.run.main's arguments for phase 3's barotropic run: `steps`
    steps at n^2, vort recorded every steps/2."""
    return ["-I", str(inp), "-O", str(out), "--nx", str(n), "--ny", str(n),
            "--total-steps", str(steps), "--record-step", str(steps // 2),
            "--record-fields", "vort", "--manifest", str(manifest),
            "--device", "cuda", *extra]


def spectral_run(n: int, steps: int, tmp: Path) -> Path:
    """Phase 3's barotropic main path once more, its vort records kept in
    tmp/spectral for phases 5l-5n (the diagnostics' input, the FD core's
    spectral reference, the ensemble members' solo run); launches
    exact."""
    from xlab_fftbarotropic_torch.cli import run as cli_run
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.io.fieldio import write_field

    cfg = ModelConfig(nx=n, ny=n)
    (tmp / "input").mkdir()
    write_field(tmp / "input" / cfg.init_file, makefields.gaussian(cfg))
    out = tmp / "spectral"
    rc, _, _, launches = _cli_main(cli_run.main, _bt_argv(
        n, steps, tmp / "input", out, tmp / "log-spectral"))
    check(rc == 0, f"cli.run.main returned {rc}")
    want = {k: PER_STEP["barotropic"].get(k, 0) * steps for k in launches}
    check(launches == want, f"spectral run launches {launches} != {want}")
    return out


def _summaries(stdout: str) -> dict:
    """{(diagnostic, input file name): (output file name, summary)} of
    cli.diagnose's stdout lines."""
    out = {}
    for line in stdout.splitlines():
        d, src, _, dest, summary = line.split()
        out[(d, Path(src).name)] = (Path(dest).name,
                                    float(summary.split("=", 1)[1]))
    return out


def phase_diagnose(n: int, steps: int, dev, spectral: Path,
                   profile: bool = False) -> dict:
    """Phase 5l: the vort records of the spectral run through
    cli.diagnose.main with all five -d, on the kernels (torch.fft.* and
    torch.matmul raising; launches_per_field exactly per file) and with
    --fft-backend xla (no kernel launch); the kernels' outputs held to
    the library's: OW by rel-L2 <= TOL; the deformation factor D = S /
    |zeta| where S and |zeta| exceed DIAG_COND G (S the strain
    magnitude, G the largest velocity gradient, from the library path):
    |dD| / D <= TOL G (1/S + 1/|zeta|), the round-off of its numerator
    and denominator, with its raw rel-L2 and the share of cells left out
    reported; E(k), Z(k) per shell within TOL of the largest shell and
    in sum; the kappa_ratio profile (the same bins on both paths) per
    bin within TOL max |grad q|^2 / the bin's mean |grad q|^2 of its
    value, its largest error over its largest value reported; the
    filamentation time where OW > DIAG_COND G^2 (|dtau| / tau * OW <=
    TOL G^2), no cell with |OW| > DIAG_COND G^2 finite on one path only,
    the share of cells whose finite/inf mask differs reported (it flips
    where OW ~ 0), the median summaries within DIAG_MEDIAN_TOL. Then ms
    per diagnosed field on both paths (Diagnoser, all five, no file
    I/O), and with `profile` their breakdowns."""
    from xlab_fftbarotropic_torch.cli import diagnose as cli_diagnose
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.diagnostics import kinematics as kin
    from xlab_fftbarotropic_torch.io.fieldio import read_field
    from xlab_fftbarotropic_torch.ops import fft
    from xlab_fftbarotropic_torch.ops import spectral as sp
    from xlab_fftbarotropic_torch.ops.spectral import SpectralTables

    cfg = ModelConfig(nx=n, ny=n)
    files = [spectral / f"vort_step_{s}.bin" for s in (0, steps // 2)]
    every = [a for d in cli_diagnose.DIAGNOSTICS for a in ("-d", d)]
    grid = ["--nx", str(n), "--ny", str(n), "--device", "cuda"]
    per_field = cli_diagnose.launches_per_field(cli_diagnose.DIAGNOSTICS)
    report = {"launches_per_field": per_field}
    with tempfile.TemporaryDirectory(prefix="xfb_smoke_") as tmp:
        runs = {}
        for path, extra in (("kernels", []),
                            ("library", ["--fft-backend", "xla"])):
            out = Path(tmp) / path
            t0 = time.perf_counter()
            rc, stdout, _, launches = _cli_main(
                cli_diagnose.main, grid + ["-O", str(out)] + every + extra,
                "\n".join(map(str, files)), refuse=path == "kernels")
            wall = time.perf_counter() - t0
            check(rc == 0, f"cli.diagnose.main ({path}) returned {rc}")
            runs[path] = (out, _summaries(stdout))
            want = {k: (per_field.get(k, 0) * len(files)
                        if path == "kernels" else 0) for k in launches}
            log(f"diagnose {path}: {len(files)} fields at {n}^2 through "
                f"cli.diagnose.main, all five -d, in {wall:.2f} s; "
                f"launches { {k: v for k, v in launches.items() if v} }")
            check(launches == want, f"diagnose {path} launches {launches} "
                                    f"!= {want}")
            if path == "kernels":
                report["launches"] = launches
        (kout, ksum), (lout, lsum) = runs["kernels"], runs["library"]
        check(ksum.keys() == lsum.keys() and len(ksum) == 5 * len(files),
              "diagnose: the two paths wrote different outputs")
        t = SpectralTables.from_config(cfg, dev)
        worst = {}

        def note(name, value):
            worst[name] = max(worst.get(name, 0.0), value)

        for f in files:
            vort = torch.from_numpy(read_field(f, cfg.grid_shape)).to(dev)
            g = kin.velocity_gradients(t, fft.forward(vort), cfg.grid_shape)
            s1, s2, zeta = kin.strain_vorticity(g)
            strain, zeta = torch.hypot(s1, s2), zeta.abs()
            big_g = max(float(a.abs().max()) for a in g)

            def both(d):
                dest = ksum[(d, f.name)][0]
                return [torch.from_numpy(read_field(o / dest,
                                                    cfg.grid_shape)).to(dev)
                        for o in (kout, lout)]
            ow_k, ow_l = both("okubo-weiss")
            note("okubo-weiss rel-L2", rel_l2(ow_k, ow_l))
            d_k, d_l = both("deformation")
            note("deformation rel-L2 (raw)", rel_l2(d_k, d_l))
            m = (strain > DIAG_COND * big_g) & (zeta > DIAG_COND * big_g)
            note("deformation cells left out", 1.0 - float(
                m.double().mean()))
            note("deformation err / G", float(
                ((d_k - d_l).abs() / d_l / (big_g * (
                    1.0 / strain + 1.0 / zeta)))[m].max()))
            f_k, f_l = both("filamentation")      # inf written as 0
            fin_k, fin_l = f_k != 0, f_l != 0
            note("filamentation mask flips", float(
                (fin_k != fin_l).double().mean()))
            decided = ow_l.abs() > DIAG_COND * big_g ** 2
            note("filamentation decided flips", float(
                (fin_k != fin_l)[decided].double().sum()))
            m = ow_l > DIAG_COND * big_g ** 2
            note("filamentation err / G^2", float(
                ((f_k - f_l).abs() / f_l * ow_l)[m].max()) / big_g ** 2)
            k_k, k_l = (torch.from_numpy(read_field(o / ksum[
                ("eddy-diffusivity", f.name)][0])).to(dev)
                for o in (kout, lout))
            note("kappa_ratio max err", float((k_k - k_l).abs().max()
                                              / k_l.abs().max()))
            # the paths bin alike and differ in |grad q|^2 alone, by a few
            # float32 epsilons of max |grad q|^2 per cell: a bin's ratio
            # moves by its share of the bin's mean |grad q|^2
            gq = fft.inverse_pair(*(op(t, fft.forward(vort))
                                    for op in (sp.gradx, sp.grady)),
                                  cfg.grid_shape)
            grad2 = gq[0] ** 2 + gq[1] ** 2
            qmin = vort.min()
            span = torch.clamp(vort.max() - qmin, min=1e-30)
            ib = torch.clamp(((vort - qmin) / span * k_l.numel()).to(
                torch.int32), 0, k_l.numel() - 1).reshape(-1).long()
            count = torch.bincount(ib, minlength=k_l.numel())
            mean_g2 = (torch.bincount(ib, weights=grad2.reshape(-1).double(),
                                      minlength=k_l.numel())
                       / count.clamp(min=1)).float()
            full = count > 0
            note("kappa_ratio err / G_q^2", float(
                ((k_k - k_l).abs() / k_l * mean_g2)[full].max()
                / grad2.max()))
            dest = ksum[("spectrum", f.name)][0]
            s_k, s_l = (np.loadtxt(o / dest) for o in (kout, lout))
            for col, name in ((1, "E(k)"), (2, "Z(k)")):
                note(f"{name} per shell", float(
                    np.abs(s_k[:, col] - s_l[:, col]).max()
                    / np.abs(s_l[:, col]).max()))
                note(f"{name} sum", abs(s_k[:, col].sum() - s_l[:, col].sum())
                     / s_l[:, col].sum())
            note("filamentation median", abs(
                ksum[("filamentation", f.name)][1]
                - lsum[("filamentation", f.name)][1])
                / lsum[("filamentation", f.name)][1])
        for name, v in worst.items():
            log(f"diagnose kernels vs torch.fft: {name} {v:.3e}")
        report["vs_library"] = worst
        for name in ("okubo-weiss rel-L2", "deformation err / G",
                     "filamentation err / G^2", "kappa_ratio err / G_q^2",
                     "E(k) per shell", "Z(k) per shell", "E(k) sum",
                     "Z(k) sum"):
            check(worst[name] <= TOL, f"diagnose: {name} {worst[name]:.3e} "
                                      f"> {TOL}")
        check(worst["filamentation decided flips"] == 0,
              "diagnose: a cell with |OW| > DIAG_COND G^2 is finite on "
              "one path only")
        check(worst["filamentation median"] <= DIAG_MEDIAN_TOL,
              f"diagnose: filamentation median moved by "
              f"{worst['filamentation median']:.3e}")
        vort = torch.from_numpy(read_field(files[-1], cfg.grid_shape)).to(dev)
        for path, c in (("kernels", cfg), ("library",
                                          cfg.replace(fft_backend="xla"))):
            d = cli_diagnose.Diagnoser(c, dev)
            ms = cuda_ms(lambda: d(vort, cli_diagnose.DIAGNOSTICS), iters=5,
                         warmup=1)
            log(f"time diagnose {path:8s}: {ms:.3f} ms per field (all five "
                f"diagnostics) at {n}^2")
            report[f"{path}_ms_per_field"] = ms
            if profile:
                report[f"{path}_profile"] = profile_run(
                    f"diagnose-{path} (per field)",
                    lambda: d(vort, cli_diagnose.DIAGNOSTICS), 1)
    return report


def phase_fd(n: int, steps: int, dev, spectral: Path) -> dict:
    """Phase 5m: cli.run.main -m fd at n^2 for `steps` steps from the
    spectral run's IC (no kernel launch: the FD core is torch, its
    Poisson solve torch.fft by design), records finite, its vorticity's
    rel-L2 against the spectral kernel path's (an O(dx^2) difference,
    printed, no bound); the ms per FD step; and at FD_CHECK_N^2 the card's
    state after FD_CHECK_STEPS steps (warm-started at the IC's FD
    streamfunction) against the same model on the CPU, rel-L2 <= TOL for
    both solvers, each Jacobi solve's sweep count on the card within one
    of the CPU's; and poisson_jacobi alone from zero on a wave's
    Laplacian at three tolerances, the same."""
    from xlab_fftbarotropic_torch.cli import run as cli_run
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.io.fieldio import read_field
    from xlab_fftbarotropic_torch.models.fd_core import (FDBarotropicModel,
                                                         laplacian5,
                                                         poisson_fft,
                                                         poisson_jacobi)

    cfg = ModelConfig(nx=n, ny=n)
    rec = steps // 2
    report = {}
    with tempfile.TemporaryDirectory(prefix="xfb_smoke_") as tmp:
        out = Path(tmp) / "fd"
        t0 = time.perf_counter()
        rc, _, _, launches = _cli_main(cli_run.main, _bt_argv(
            n, steps, spectral.parent / "input", out, Path(tmp) / "log",
            "-m", "fd"))
        wall = time.perf_counter() - t0
        check(rc == 0, f"cli.run.main -m fd returned {rc}")
        check(not any(launches.values()), f"-m fd launched {launches}")
        report["launches"] = launches
        for s in (0, rec):
            f = out / f"vort_step_{s}.bin"
            check(f.exists() and f.stat().st_size == n * n * 4,
                  f"FD record {f.name} missing or of the wrong size")
            check(bool(np.isfinite(read_field(f, cfg.grid_shape)).all()),
                  f"FD record {f.name} is not finite")
        fd_v, sp_v = (torch.from_numpy(read_field(
            d / f"vort_step_{rec}.bin", cfg.grid_shape)) for d in (out,
                                                                 spectral))
        report["fd_vs_spectral_rel_l2"] = rel_l2(fd_v, sp_v)
        log(f"fd: {steps} steps at {n}^2 through cli.run.main -m fd in "
            f"{wall:.2f} s; vorticity at step {rec} against the spectral "
            f"kernel path: rel-L2 {report['fd_vs_spectral_rel_l2']:.3e} "
            f"(the O(dx^2) difference of the two discretizations)")
    m = FDBarotropicModel.build(cfg, dev)
    z0 = torch.from_numpy(makefields.gaussian(cfg)).to(dev)
    p0, src = m.init_psi(z0), m.zero_source()
    report["ms_per_step"] = cuda_ms(lambda: m.step(z0, p0, src), iters=5,
                                    warmup=1)
    log(f"time fd: {report['ms_per_step']:.3f} ms per step at {n}^2 (FFT "
        f"Poisson solve)")
    small = ModelConfig(nx=FD_CHECK_N, ny=FD_CHECK_N)
    v0 = makefields.gaussian(small)
    cpu = torch.device("cpu")
    for solver in ("fft", "jacobi"):
        states, sweeps = [], []
        for where in (dev, cpu):
            fm = FDBarotropicModel.build(small, where, tol=JACOBI_TOL,
                                         max_iter=JACOBI_MAX, solver=solver)
            z = torch.from_numpy(v0).to(where)
            # warm-started at the IC's FD streamfunction: from zero the
            # relaxation needs more than 20000 sweeps at 256^2
            states.append(fm.segment(z, poisson_fft(z, small.dx, small.dy),
                                     fm.zero_source(), FD_CHECK_STEPS))
            sweeps.append([int(s) for s in fm.sweeps])
        rel = [rel_l2(a.cpu(), b) for a, b in zip(*states)]
        log(f"fd {solver} at {FD_CHECK_N}^2, {FD_CHECK_STEPS} steps: card "
            f"vs CPU rel-L2 zeta {rel[0]:.3e}, psi {rel[1]:.3e}"
            + (f"; Jacobi sweeps card {sweeps[0]}, CPU {sweeps[1]}"
               if solver == "jacobi" else ""))
        check(rel[0] <= TOL, f"fd {solver}: card vs CPU zeta rel-L2 "
                             f"{rel[0]:.3e} > {TOL}")
        check(len(sweeps[0]) == len(sweeps[1]) and all(
            abs(a - b) <= 1 for a, b in zip(*sweeps)),
            f"fd jacobi sweeps card {sweeps[0]} vs CPU {sweeps[1]}")
        report[f"{solver}_card_vs_cpu"] = dict(rel_l2=rel,
                                               sweeps=sweeps)
    # the relaxation alone from zero, on the 5-point Laplacian of a
    # (16, 8) wave: a stopping sweep of order a hundred
    x, y = small.coords()
    wave = torch.from_numpy((np.sin(2 * np.pi * 16 * x / small.lx)[:, None]
                             * np.cos(2 * np.pi * 8 * y[None, :] / small.ly)
                             ).astype(np.float32))
    rhs = laplacian5(wave, small.dx, small.dy)
    for tol in (1e-3, 1e-4, 1e-5):
        (xd, kd), (xc, kc) = (poisson_jacobi(rhs.to(w), small.dx, small.dy,
                                             tol=tol) for w in (dev, cpu))
        rel = rel_l2(xd.cpu(), xc)
        log(f"fd jacobi alone at {FD_CHECK_N}^2, tol {tol:g}: sweeps card "
            f"{int(kd)}, CPU {int(kc)}; solution rel-L2 {rel:.3e}")
        check(abs(int(kd) - int(kc)) <= 1 and 1 < int(kc) < 10_000,
              f"jacobi sweeps card {int(kd)} vs CPU {int(kc)}")
        check(rel <= TOL, f"jacobi card vs CPU rel-L2 {rel:.3e}")
        report[f"jacobi_wave_{tol:g}"] = dict(sweeps=[int(kd), int(kc)],
                                              rel_l2=rel)
    return report


def phase_ensemble(n: int, steps: int, dev, spectral: Path) -> dict:
    """Phase 5n: cli.run.main --ensemble ENS_MEMBERS --ensemble-amp 0
    --ensemble-width 1 at n^2 from the spectral run's IC: every member's
    records byte-identical to the solo run's and the plane stepper's
    launches exactly ENS_MEMBERS times its per step; then
    --ensemble-amp 0.02: every member's records, a nonzero spread at
    every record of the log; at FD_CHECK_N^2 EnsembleModel.build with
    width ENS_BATCH (one batched chunk on torch.fft) at amplitude 0:
    member 0 within rel-L2 ENS_BATCH_TOL of the solo library run; and a
    --profile-dir run at FD_CHECK_N^2 for 4 steps whose trace names
    ka_diag."""
    from xlab_fftbarotropic_torch.cli import run as cli_run
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.models.ensemble import EnsembleModel

    rec = steps // 2
    members = [f"m{k:02d}" for k in range(ENS_MEMBERS)]
    report = {}
    with tempfile.TemporaryDirectory(prefix="xfb_smoke_") as tmp:
        for amp in ("0", "0.02"):
            out = Path(tmp) / f"amp{amp}"
            t0 = time.perf_counter()
            rc, _, err, launches = _cli_main(cli_run.main, _bt_argv(
                n, steps, spectral.parent / "input", out,
                Path(tmp) / f"log{amp}", "--ensemble", str(ENS_MEMBERS),
                "--ensemble-amp", amp, "--ensemble-width", "1"))
            wall = time.perf_counter() - t0
            check(rc == 0, f"cli.run.main --ensemble returned {rc}")
            want = {k: ENS_MEMBERS * PER_STEP["barotropic"].get(k, 0)
                    * steps for k in launches}
            check(launches == want, f"ensemble launches {launches} != "
                                    f"{want}")
            spread = [float(line.rsplit("=", 1)[1])
                      for line in err.splitlines()
                      if line.startswith("# Ensemble spread")]
            log(f"ensemble amp {amp}: {ENS_MEMBERS} members x {steps} "
                f"steps at {n}^2 through cli.run.main, width 1, in "
                f"{wall:.2f} s; spread per record {spread}")
            check(len(spread) == 2, f"spread lines {spread}")
            for k in members:
                for s in (0, rec):
                    got = (out / k / f"vort_step_{s}.bin").read_bytes()
                    check(len(got) == n * n * 4, f"{k} record size")
                    if amp == "0":
                        check(got == (spectral / f"vort_step_{s}.bin"
                                      ).read_bytes(),
                              f"{k}/vort_step_{s}.bin is not the solo "
                              f"run's bit for bit")
            if amp == "0":
                check(spread == [0.0, 0.0], f"zero-amp spread {spread}")
                report["launches"] = launches
            else:
                check(all(s > 0 for s in spread), f"spread {spread}")
                report["spread"] = spread
    small = ModelConfig(nx=FD_CHECK_N, ny=FD_CHECK_N)
    v0 = makefields.gaussian(small)
    e = EnsembleModel.build(small, dev, ENS_BATCH, vmap_width=ENS_BATCH)
    check(e.batched and e.inner.backend == "xla", "the batched chunk is "
                                                  "not on the library path")
    solo = BarotropicModel.build(small.replace(fft_backend="xla"), dev)
    src = solo.zero_source()
    got = e.segment(e.init_from_physical(v0, amplitude=0.0), src, steps)
    want = solo.segment(solo.init_state(v0), src, steps)
    report["batched_rel_l2"] = [rel_l2(torch.view_as_real(g),
                                       torch.view_as_real(want))
                                for g in got]
    log(f"ensemble width {ENS_BATCH} at {FD_CHECK_N}^2 (one batched chunk "
        f"on torch.fft), amplitude 0: members vs the solo library run "
        f"rel-L2 {max(report['batched_rel_l2']):.3e} (member 0 "
        f"{report['batched_rel_l2'][0]:.3e})")
    check(report["batched_rel_l2"][0] <= ENS_BATCH_TOL,
          f"batched member 0 rel-L2 {report['batched_rel_l2'][0]:.3e}")
    with tempfile.TemporaryDirectory(prefix="xfb_smoke_") as tmp:
        from xlab_fftbarotropic_torch.io.fieldio import write_field
        tmp = Path(tmp)
        (tmp / "input").mkdir()
        write_field(tmp / "input" / small.init_file, v0)
        rc, _, _, _ = _cli_main(cli_run.main, _bt_argv(
            FD_CHECK_N, 4, tmp / "input", tmp / "out", tmp / "log",
            "--profile-dir", str(tmp / "prof")))
        check(rc == 0, f"cli.run.main --profile-dir returned {rc}")
        trace = tmp / "prof" / cli_run.TRACE_NAME
        check(trace.exists() and "ka_diag" in trace.read_text(),
              "the --profile-dir trace is missing or names no ka_diag")
        report["trace_bytes"] = trace.stat().st_size
        log(f"profile-dir: {trace.name} {report['trace_bytes']} bytes, "
            f"names ka_diag")
    return report


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

    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    names = kernel_functions()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_step, calls = {}, {}
    for e in prof.events():
        # the wrappers' launch spans (ops/fused_fft.py _launch) mirror on
        # the device's timeline as user annotations: not device work
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.name in ff.LAUNCHES):
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




def _rank_cfg(case, n: int):
    from xlab_fftbarotropic_torch.config import ModelConfig
    size = n if case[5] == "n" else RANK_SMALL_N
    return ModelConfig(nx=size, ny=size)


def _rank_model(case, cfg, mesh):
    from xlab_fftbarotropic_torch.parallel import (ShardedBarotropicModel,
                                                   ShardedShallowWaterModel,
                                                   ShardedTracerModel)
    _, family, decomp, impl, fast, _ = case
    kw = dict(fft_impl=impl, decomp=decomp, fast=fast)
    if family == "sw":
        return ShardedShallowWaterModel.build(cfg, mesh, **kw)
    if family == "tracer":
        return ShardedTracerModel.build(cfg, mesh, kappa=RANK_KAPPA, **kw)
    return ShardedBarotropicModel.build(cfg, mesh, **kw)


def _rank_state0(case, m):
    """The numpy-seeded initial state: a gaussian vortex with seeded
    noise (SW: balanced; the tracer: a gaussian q)."""
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.tracer import tracer_ic
    family, cfg = case[1], m.cfg
    zeta0 = 1e-5 if family == "sw" else 1e-4
    v = np.asarray(makefields.gaussian(cfg, zeta0=zeta0), np.float32)
    rng = np.random.default_rng(RANK_SEED)
    v = (v + 0.05 * zeta0 * rng.standard_normal(v.shape)).astype(
        np.float32)
    if family == "sw":
        return m.geostrophic_init(v)
    if family == "tracer":
        return m.init_state(v, tracer_ic(cfg, "gaussian", v))
    return m.init_state(v)


def _rank_global(case, m, s) -> list:
    """The global state on the host (on a distributed group, a gather on
    every rank)."""
    if case[1] == "barotropic":
        return [m.unshard_spectral(s).cpu()]
    return [a.cpu() for a in m.unshard_state(s)]


def _rank_grids(trace: Path) -> tuple:
    """From a chrome trace: kernel name -> the grid x sizes of its
    launches, and -> its mean device ms per launch."""
    grids, us = {}, {}
    for e in json.loads(trace.read_text()).get("traceEvents", []):
        if e.get("cat") != "kernel":
            continue
        for k in ("a2a_kernel", "xstage_kernel"):
            if re.search(rf"(\b|\d){k}(\b|E|<)", e.get("name", "")):
                grid = e.get("args", {}).get("grid", [None])[0]
                grids.setdefault(k, set()).add(grid)
                us.setdefault(k, []).append(float(e.get("dur", 0.0)))
    return ({k: sorted(v) for k, v in grids.items()},
            {k: sum(v) / len(v) / 1e3 for k, v in us.items()})


def _rank_own_grids(case, m) -> dict:
    """The grid x sizes rank 0's launches must have: its own a2a runs
    (P rows_l), or the tiles of its own w columns times the cluster."""
    from xlab_fftbarotropic_torch.ops.xtile import xtile_plan
    p, nx, hny = RANKS, m.cfg.nx, m.cfg.ny // 2 + 1
    w = -(-hny // p)
    if case[3] == "pallas":
        return {"a2a_kernel": [p * (nx // p)]}
    sizes = set()
    for columns in ((p * w, hny) if case[2] == "xpencil" else (hny,)):
        plan = xtile_plan(nx, columns, 8)
        tiles = min(-(-w // plan.c), -(-columns // plan.c))
        sizes.add(tiles * plan.k)
    return {"xstage_kernel": sorted(sizes)}


def _probe_gloo_cuda(dev) -> dict:
    """Whether the gloo backend takes CUDA tensors in all_to_all_single
    (ranks sharing a card run gloo)."""
    from xlab_fftbarotropic_torch.parallel import multihost
    if multihost.backend() != "gloo":
        return dict(ok=True, backend=multihost.backend())
    p, r = multihost.world_size(), multihost.rank()
    x = torch.arange(2 * p, dtype=torch.float32, device=dev) + 100 * r
    try:
        y = multihost.all_to_all(x.reshape(p, 2))
        want = torch.stack([torch.arange(2 * r, 2 * r + 2, device=dev)
                            + 100 * q for q in range(p)]).float()
        return dict(ok=bool(torch.equal(y, want)), backend="gloo",
                    device=str(y.device))
    except RuntimeError as e:
        return dict(ok=False, backend="gloo", error=str(e)[:400])


def _rollout_mesh(decomp: str, dev, ranked: bool):
    """The rollout's group: the ranks (make_mesh(None), or the 2x2 pencil
    mesh on the runtime) or RANKS stacked shards on `dev`."""
    from xlab_fftbarotropic_torch.parallel import make_mesh
    from xlab_fftbarotropic_torch.parallel.pencil import make_pencil_mesh
    if decomp == "pencil":
        return make_pencil_mesh((2, 2), dev)
    return make_mesh(None if ranked else RANKS, dev)


def _rollout_inputs(dev) -> tuple:
    """The numpy-seeded (vort0, src, target) of phase 5t's rollouts at
    SHARD_ROLLOUT_N^2: the gaussian vortex with seeded noise, a seeded
    source, 0.9 vort0 with seeded noise."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    n = SHARD_ROLLOUT_N
    rng = np.random.default_rng(RANK_SEED)
    v = np.asarray(makefields.gaussian(ModelConfig(nx=n, ny=n)), np.float32)
    v = (v + 5e-6 * rng.standard_normal(v.shape)).astype(np.float32)
    src = (1e-9 * rng.standard_normal(v.shape)).astype(np.float32)
    tgt = (0.9 * v + 1e-6 * rng.standard_normal(v.shape)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (v, src, tgt))


def _rollout_gradient(roll, inputs, own) -> tuple:
    """(value, grad wrt vort0, grad wrt src) of half the mean-square
    misfit of the final vorticity; `own` the rank's shard of a global
    field (the identity when stacked), the loss its part of the global
    one."""
    v0, src, tgt = inputs
    x, s = (a.clone().requires_grad_(True) for a in (v0, src))
    out = roll(x, s)
    loss = 0.5 * torch.sum(torch.square(out - own(tgt))) / tgt.numel()
    gx, gs = torch.autograd.grad(loss, [x, s])
    return out.detach(), gx, gs


def _timed_gradient(roll, inputs, own, barrier=None) -> float:
    """ms per window step of one gradient (forward and backward sweeps),
    after one more untimed one (over ranks the first few run slower)."""
    _rollout_gradient(roll, inputs, own)
    if barrier is not None:
        barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _rollout_gradient(roll, inputs, own)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / SHARD_ROLLOUT_STEPS


def rank_rollouts(workdir: Path, dev) -> None:
    """Phase 5t's rollouts on one rank: for each of RANK_ROLLOUTS the
    rank's value and gradients, gathered (rank 0 saves them as
    DIR/rollout-<decomp>.pt), whether its gradients are zero off its own
    shard, and its ms per gradient window step; one JSON line each."""
    from xlab_fftbarotropic_torch import adjoint
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.parallel import dfft, multihost, pencil

    rank = multihost.rank()
    n = SHARD_ROLLOUT_N
    cfg = ModelConfig(nx=n, ny=n)
    inputs = _rollout_inputs(dev)
    for decomp in RANK_ROLLOUTS:
        mesh = _rollout_mesh(decomp, "cuda", True)
        check(mesh.distributed and mesh.rank == rank, f"{decomp}: {mesh}")
        split, join = ((lambda a: pencil.shard_tiles(a, (2, 2)),
                        lambda a: pencil.unshard_tiles(a, (2, 2)))
                       if decomp == "pencil" else
                       (lambda a: dfft.shard_rows(a, RANKS),
                        dfft.unshard_rows))

        def own(a):
            return split(a)[rank:rank + 1]

        roll = adjoint.make_sharded_rollout(cfg, SHARD_ROLLOUT_STEPS, mesh,
                                            decomp)
        out = _rollout_gradient(roll, inputs, own)
        off = all(int(torch.count_nonzero(g)) == int(torch.count_nonzero(
            own(g))) for g in out[1:])
        gathered = [join(multihost.gather_to_host(a if i == 0 else own(a)))
                    for i, a in enumerate(out)]
        if rank == 0:
            torch.save(gathered, workdir / f"rollout-{decomp}.pt")
        ms = _timed_gradient(roll, inputs, own, torch.distributed.barrier)
        print(json.dumps(dict(rank=rank, case=f"rollout-{decomp}", ms=ms,
                              shape=list(out[0].shape),
                              off_shard_zero=off)), flush=True)
        del roll, out, gathered
        torch.cuda.empty_cache()


def rank_worker(workdir: Path, n: int) -> int:
    """One rank of phase 5t (chip_smoke.py --rank-worker DIR, started by
    phase_ranks with the XFB_* contract): each case of RANK_CASES over the
    ranks, one JSON line each (its launches, ms/step, the host barrier's
    share, rank 0's traced kernel grids); rank 0 saves the gathered
    state as DIR/<path>.pt."""
    import_port()
    from torch.profiler import ProfilerActivity, profile

    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.parallel import (make_mesh, make_mesh2d,
                                                   multihost)

    check(multihost.initialize(device="cuda"), "the runtime did not start")
    rank = multihost.rank()
    dev = multihost.rank_device("cuda")
    torch.cuda.set_device(dev)
    gloo = _probe_gloo_cuda(dev)
    print(f"rank {rank}: gloo all_to_all_single on CUDA tensors: {gloo}",
          file=sys.stderr, flush=True)
    for case in RANK_CASES:
        name, family, decomp, impl = case[:4]
        cfg = _rank_cfg(case, n)
        mesh = (make_mesh2d((2, 2), "cuda") if decomp == "pencil"
                else make_mesh(None, "cuda"))
        check(mesh.distributed and mesh.device == dev, f"{name}: {mesh}")
        m = _rank_model(case, cfg, mesh)
        s0 = _rank_state0(case, m)
        src = m.zero_source()
        torch.cuda.synchronize()
        ff.reset_launches()
        s = m.segment(s0, src, RANK_STEPS)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ff.LAUNCHES.items() if v}
        state = _rank_global(case, m, s)
        if rank == 0:
            torch.save(state, workdir / f"{name}.pt")
        del s, state
        stats = dict(m.exchange.stats) if m.exchange else None
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.segment(s0, src, RANK_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        line = dict(rank=rank, case=name, launches=launches,
                    ms=wall * 1e3 / RANK_STEPS, n=cfg.nx)
        if stats is not None:
            b = m.exchange.stats
            line.update(barriers=b["barriers"] - stats["barriers"],
                        barrier_share=(b["barrier_s"] - stats["barrier_s"])
                        / wall)
            if rank == 0:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    m.segment(s0, src, 1)
                    torch.cuda.synchronize()
                trace = workdir / f"{name}.trace.json"
                prof.export_chrome_trace(str(trace))
                grids, kernel_ms = _rank_grids(trace)
                line.update(grids=grids, kernel_ms=kernel_ms,
                            own_grids=_rank_own_grids(case, m))
                trace.unlink()
            else:
                m.segment(s0, src, 1)
                torch.cuda.synchronize()
            m.exchange.close()
        print(json.dumps(line), flush=True)
        del m, s0, src
        torch.cuda.empty_cache()
    rank_rollouts(workdir, dev)
    print(json.dumps(dict(rank=rank, backend=multihost.backend(),
                          gloo_cuda=gloo, device=str(dev))), flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def _spawn_ranks(workdir: Path, n: int) -> list:
    """RANKS processes of rank_worker on the one card; each rank's
    (exit code, stdout, stderr). Every process is ended by the deadline."""
    sock = __import__("socket").socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    procs = []
    for r in range(RANKS):
        env = dict(os.environ, XFB_COORDINATOR=f"127.0.0.1:{port}",
                   XFB_NUM_PROCESSES=str(RANKS), XFB_PROCESS_ID=str(r),
                   XFB_ETD_CACHE="0")
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), "--rank-worker",
             str(workdir), "--n", str(n)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    # the ranks wait on each other: once one fails or the deadline
    # passes, the others are ended at once
    deadline = time.perf_counter() + RANK_TIMEOUT
    while any(p.poll() is None for p in procs):
        if (time.perf_counter() > deadline
                or any(p.poll() not in (None, 0) for p in procs)):
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.2)
    return [(p.wait(), *p.communicate()) for p in procs]


def phase_ranks(n: int, dev) -> dict:
    """Phase 5t: RANK_CASES over RANKS ranks sharing the card (module
    note, 5t): each against the stacked model at P = RANKS (bit for bit,
    launches per rank exactly the stacked model's), rank 0's kernels in
    its own device trace with its own grid, ms/step of each beside the
    stacked model's, and the host barrier's share."""
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.parallel import make_mesh, make_mesh2d

    t_phase = time.perf_counter()
    out = {"main_paths": {}, "time": {}}
    ref = {}
    for case in RANK_CASES:
        cfg = _rank_cfg(case, n)
        mesh = (make_mesh2d((2, 2), dev) if case[2] == "pencil"
                else make_mesh(RANKS, dev))
        m = _rank_model(case, cfg, mesh)
        s0 = _rank_state0(case, m)
        src = m.zero_source()
        torch.cuda.synchronize()
        ff.reset_launches()
        s = m.segment(s0, src, RANK_STEPS)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ff.LAUNCHES.items() if v}
        state = _rank_global(case, m, s)
        t0 = time.perf_counter()
        m.segment(s0, src, RANK_STEPS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / RANK_STEPS
        ref[case[0]] = dict(state=state, launches=launches, ms=ms)
        del m, s, s0, src
        torch.cuda.empty_cache()
    rollouts = stacked_rollouts(dev)
    log(f"phase 5t stacked references: {time.perf_counter() - t_phase:.1f} "
        f"s in")
    with tempfile.TemporaryDirectory(prefix="xfb_ranks_") as tmp:
        outs = _spawn_ranks(Path(tmp), n)
        for r, (rc, o, e) in enumerate(outs):
            check(rc == 0, f"phase 5t rank {r} exited {rc}:\n{e[-3000:]}")
        lines = [json.loads(x) for _, o, _ in outs for x in o.splitlines()
                 if x.startswith("{")]
        ends = [x for x in lines if "backend" in x]
        check(len(ends) == RANKS, f"phase 5t: {len(ends)} ranks ended")
        gloo = ends[0]["gloo_cuda"]
        devices = sorted({x["device"] for x in ends})
        where = ("sharing one card" if len(devices) == 1
                 else f"one card each ({', '.join(devices)})")
        log(f"phase 5t: {RANKS} ranks {where}, backend "
            f"{ends[0]['backend']}; gloo all_to_all_single on CUDA "
            f"tensors: {gloo}")
        out["gloo_cuda"] = gloo
        for case in RANK_CASES:
            name = case[0]
            per = sorted((x for x in lines if x.get("case") == name),
                         key=lambda x: x["rank"])
            check(len(per) == RANKS, f"{name}: {len(per)} ranks reported")
            want = ref[name]
            got = torch.load(Path(tmp) / f"{name}.pt")
            same = all(torch.equal(a, b) for a, b in zip(got, want["state"]))
            worst = max(float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(got, want["state"]))
            check(all(bool(torch.isfinite(a).all()) for a in got),
                  f"{name} not finite")
            for x in per:
                check(x["launches"] == want["launches"],
                      f"{name} rank {x['rank']} launched {x['launches']}, "
                      f"the stacked model {want['launches']}")
            r0 = per[0]
            if "grids" in r0:
                check(r0["grids"] == r0["own_grids"],
                      f"{name}: rank 0 traced {r0['grids']}, its own "
                      f"blocks are {r0['own_grids']}")
            ms = max(x["ms"] for x in per)
            share = (sum(x["barrier_share"] for x in per) / RANKS
                     if "barrier_share" in r0 else 0.0)
            log(f"{name}: {RANK_STEPS} steps at {r0['n']}^2 on {RANKS} ranks "
                f"{where}: state bit for bit the stacked P = "
                f"{RANKS} model {same} (max |d| {worst:.3e} of max); "
                f"launches per rank {r0['launches']} (the stacked "
                f"model's); rank 0's device trace {r0.get('grids', {})}, "
                f"ms per launch {r0.get('kernel_ms', {})}; "
                f"{ms:.3f} ms/step (slowest rank; stacked "
                f"{want['ms']:.3f}), host barriers "
                f"{r0.get('barriers', 0) // RANK_STEPS}/step, "
                f"{100.0 * share:.1f} % of the wall")
            check(same, f"{name}: not bit for bit the stacked model "
                  f"({worst:.3e})")
            out["main_paths"][name] = dict(launches=r0["launches"])
            out["time"][name] = dict(ms=ms, stacked_ms=want["ms"],
                                     where=where, barrier_share=share,
                                     kernel_ms=r0.get("kernel_ms", {}),
                                     per_rank_ms=[x["ms"] for x in per])
        out["rollouts"] = check_rank_rollouts(Path(tmp), lines, rollouts,
                                              where)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 5t: {out['wall_s']:.1f} s")
    return out


def stacked_rollouts(dev) -> dict:
    """Phase 5t's references of the rollouts: for each of RANK_ROLLOUTS
    the stacked make_sharded_rollout's value and gradients at P = RANKS
    and its ms per gradient window step, and the single-device library
    gradients (make_rollout on torch.fft)."""
    from xlab_fftbarotropic_torch import adjoint
    from xlab_fftbarotropic_torch.config import ModelConfig

    n, steps = SHARD_ROLLOUT_N, SHARD_ROLLOUT_STEPS
    cfg = ModelConfig(nx=n, ny=n)
    inputs = _rollout_inputs(dev)
    out = {"single": _rollout_gradient(adjoint.make_rollout(
        cfg.replace(fft_backend="xla"), steps, device=dev), inputs,
        lambda a: a)}
    for decomp in RANK_ROLLOUTS:
        roll = adjoint.make_sharded_rollout(
            cfg, steps, _rollout_mesh(decomp, dev, False), decomp)
        out[decomp] = dict(
            state=[a.cpu() for a in _rollout_gradient(roll, inputs,
                                                      lambda a: a)],
            ms=_timed_gradient(roll, inputs, lambda a: a))
    out["single"] = [a.cpu() for a in out["single"]]
    return out


def check_rank_rollouts(tmp: Path, lines: list, ref: dict,
                        where: str) -> dict:
    """Phase 5t's rollouts over the ranks against the stacked and the
    single-device references (stacked_rollouts; module note, 5t)."""
    out = {}
    for decomp in RANK_ROLLOUTS:
        name = f"rollout-{decomp}"
        per = sorted((x for x in lines if x.get("case") == name),
                     key=lambda x: x["rank"])
        check(len(per) == RANKS, f"{name}: {len(per)} ranks reported")
        check(all(x["off_shard_zero"] for x in per),
              f"{name}: a rank's gradient is nonzero off its own shard")
        value, *grads = torch.load(tmp / f"{name}.pt")
        want, *want_grads = ref[decomp]["state"]
        check(all(bool(torch.isfinite(a).all()) for a in [value] + grads),
              f"{name} not finite")
        check(torch.equal(value, want), f"{name}: the value is not bit "
              f"for bit the stacked rollout's (max |d| "
              f"{float((value - want).abs().max()):.3e})")
        row = dict(ms=max(x["ms"] for x in per), stacked_ms=ref[decomp]["ms"],
                   per_rank_ms=[x["ms"] for x in per])
        for what, g, w, single in zip(("vort0", "src"), grads, want_grads,
                                      ref["single"][1:]):
            same = torch.equal(g, w)
            err = float((g - w).abs().max() / w.abs().max())
            err1 = float((g - single).abs().max() / single.abs().max())
            log(f"{name}: {SHARD_ROLLOUT_STEPS} steps at {SHARD_ROLLOUT_N}^2 "
                f"on {RANKS} ranks {where}: gradient wrt {what} "
                f"{'bit for bit' if same else 'not bit for bit'} the "
                f"stacked P = {RANKS} rollout's (max |d| / max {err:.3e}, "
                f"rel-L2 {rel_l2(g, w):.3e}); against the single-device "
                f"library gradient max |d| / max {err1:.3e}")
            check(same or err <= RANK_GRAD_BAR,
                  f"{name}: gradient wrt {what} {err:.3e} > {RANK_GRAD_BAR} "
                  f"of the stacked one's max")
            check(err1 <= SHARD_ROLLOUT_BAR,
                  f"{name}: gradient wrt {what} {err1:.3e} > "
                  f"{SHARD_ROLLOUT_BAR} of the single-device one's max")
            row[what] = dict(bit_for_bit=same, vs_stacked=err,
                             vs_single=err1)
        log(f"{name}: value bit for bit the stacked rollout's; "
            f"{row['ms']:.3f} ms per gradient window step (slowest rank; "
            f"stacked {row['stacked_ms']:.3f}; per rank "
            f"{', '.join(f'{m:.3f}' for m in row['per_rank_ms'])})")
        out[decomp] = row
    return out


def phase_parity(dev) -> dict:
    """The reference-parity bar on the card: the barotropic kernel path
    (strict, y-first) in each arm of PARITY_ARMS, and the library path
    (logged), from the gaussian IC at PARITY_N^2 for PARITY_STEPS RK4
    steps against the port's numpy oracle (oracle/reference_cpu.py) on
    the same IC: rel-L2 of the physical vorticity < PARITY_BAR."""
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic import makefields
    from xlab_fftbarotropic_torch.models.barotropic import BarotropicModel
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.oracle.reference_cpu import (
        OracleBarotropic)

    t_phase = time.perf_counter()
    cfg = ModelConfig(nx=PARITY_N, ny=PARITY_N)
    v0 = makefields.gaussian(cfg)
    want = torch.from_numpy(OracleBarotropic(cfg).run(v0, PARITY_STEPS)
                            ).double()
    out = {}
    runs = dict(PARITY_ARMS, library=None)
    for arm, kw in runs.items():
        c = cfg.replace(fft_backend="xla") if kw is None else cfg
        m = BarotropicModel.build(c, dev, **(kw or {}))
        check(m.backend == ("xla" if kw is None else "pallas"),
              f"parity {arm}: backend {m.backend}")
        s0 = m.init_state(v0)
        torch.cuda.synchronize()
        ff.reset_launches()
        z = m.segment(s0, m.zero_source(), PARITY_STEPS)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ff.LAUNCHES.items() if v}
        got = m.diags(z).vort.double().cpu()
        check(bool(torch.isfinite(got).all()), f"parity {arm} not finite")
        err = rel_l2(got, want)
        log(f"reference parity, {arm}: {PARITY_STEPS} RK4 steps at "
            f"{PARITY_N}^2 from the gaussian IC, rel-L2 of the vorticity "
            f"against the numpy oracle {err:.3e} (max |d| / max "
            f"{float((got - want).abs().max() / want.abs().max()):.3e}); "
            f"launches {launches}")
        per_step = PER_STEP.get(arm, {})
        check(launches == {k: v * PARITY_STEPS for k, v in per_step.items()},
              f"parity {arm}: launched {launches}, not {per_step} a step")
        if kw is not None:
            check(err < PARITY_BAR, f"reference parity {arm}: rel-L2 "
                  f"{err:.3e} >= {PARITY_BAR}")
        out[arm] = dict(rel_l2=err, launches=launches)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 5u: {out['wall_s']:.1f} s")
    return out


# the fast x-stages of phase 5v: name -> (case family, its PERF.md row)
FAST_XSTAGE_FORMS = {
    "kx_fwd_bt_fast": ("arm", "6 fast"),
    "kx_visc_fast": ("fast", "4 fast"),
    "kx_visc_none_fast": ("arm", "4 fast none"),
    "kx_visc_tail_fast": ("arm", "5 fast"),
    "kx_visc_tracer_fast": ("arm", "20 fast"),
    "kx_fwd_fast": ("sw", "17b fast"),
    "kx_fwd_fast_f32": ("sw", "17b fast f32"),
    "xstage_fast": ("rest", "21 fast"),
    "xstage_forward_fast": ("rest", "21 fast forward"),
    "xstage_gather_fast": ("rest", "22 fast gather"),
    "xstage_scatter_fast": ("rest", "22 fast scatter"),
    "kc_fast": ("rest", "14 fast"),
    "kc_visc_fast": ("xfirst", "15 fast kc_visc"),
    "kc_sw_fast": ("xfirst", "17d fast kc_sw"),
    "ka_fast": ("rest", "12 fast"),
    "ka_inverse_fast": ("rest", "12 fast inverse"),
    "kb_xmajor_fast": ("xfirst", "2 fast x-major"),
    "kb_single_fast": ("rest", "13 fast"),
    "ky_all_fast": ("sw", "17a fast"),
    "ky_all_nosplit_fast": ("split_off", "17a fast, split off"),
}
# the shapes phase 5v checks the fast x-stages at (ragged last tiles,
# K = 1 .. 8)
FAST_XSTAGE_SHAPES = ((256, 200), (1024, 33), (4096, 70))
# the cuts of csrc/xtile_parts.cu and the part each adds
XTILE_CUTS = ("loads", "first pass", "rest of the sub-DFT", "exchange",
              "store")
# the cuts of the transposed store (xfb_xtile_tparts) and the part each
# adds
XTILE_TCUTS = ("loads", "sub-DFT", "exchange", "staging", "store")
# its forms: name -> (form of xfb_xtile_tparts, kb's single inverse)
XTILE_TFORMS = {"kc": (0, False), "ka real forward": (1, False),
                "kb pair": (2, False), "kb single": (2, True),
                "ky_all": (3, False)}
# the shallow-water constants of ky_all's cut (xtile_parts.cu): the
# bench's, split on
TPARTS_SW = (*SW_BENCH, True)


def _xstage_forms(n: int, cols, dev, seed: int) -> dict:
    """The FastCases of FAST_XSTAGE_FORMS at (n, cols), and each one's
    torch.fft call at n^2 (cols None) or None."""
    from xlab_fftbarotropic_torch.parallel import dfft
    from xlab_fftbarotropic_torch.parallel import fused_overlap as fo

    fam = {"arm": fast_arm_cases(n, cols, dev, seed),
           "fast": fast_cases(n, cols, dev, seed),
           "sw": fast_sw_cases(n, cols, dev, seed),
           "rest": fast_rest_cases(n, cols, dev, seed),
           "xfirst": fast_xfirst_cases(n, cols, dev, seed),
           "split_off": fast_split_off_cases(n, cols, dev, seed)}
    # mode 0 forward at scale 1 on the inverse case's shards, and on
    # small integers on exact_rows (every tensor-core sum exact)
    x = fam["rest"]["xstage_fast"].reads[0]
    rng = np.random.default_rng(seed + 1)
    _, ints = _makers(rng, dev)
    ex = dfft.shard_rows(torch.complex(*ints(
        (n, x.shape[-1]), 2, rows=exact_rows(n))), x.shape[0]).contiguous()
    fam["rest"]["xstage_forward_fast"] = FastCase(
        lambda: fo.xstage(x, True, fast=True),
        lambda: fo.xstage_plain(x, True, fast=True),
        lambda: fo.xstage(x, True),
        lambda: fo.xstage(ex, True, fast=True),
        lambda: fo.xstage_plain(ex, True, fast=True),
        fam["rest"]["xstage_fast"].fields, (x,), x.shape[-1])
    cases = {name: fam[kind][name]
             for name, (kind, _) in FAST_XSTAGE_FORMS.items()}
    libs = {}
    if cols is None:
        for name, (kind, _) in FAST_XSTAGE_FORMS.items():
            case = cases[name]
            if name.startswith("ky_all"):
                libs[name] = ky_all_yardstick(case, kind == "sw")
            elif kind == "arm":
                libs[name] = fast_arm_library(name, case)
            elif kind == "fast":
                libs[name] = fast_library(name, case, n)
            elif kind == "sw":
                libs[name] = fast_sw_library(name, n, dev)
            elif kind == "xfirst":
                libs[name] = fast_xfirst_library(name, case, n)
            elif name == "xstage_forward_fast":
                libs[name] = fast_rest_library("xstage_gather_fast", case,
                                               n)
            else:
                libs[name] = fast_rest_library(name, case, n)
    return cases, libs


def ky_all_yardstick(case: FastCase, split: bool):
    """ky_all's yardstick (no one torch call forms the products): the
    five products of its fields formed in torch (fused_sw.sw_products, the
    bench's ies, f0 and g), then one fft.rfft of them along y."""
    from xlab_fftbarotropic_torch.ops import fused_sw as fs

    def go():
        prods = torch.stack(fs.sw_products(*case.reads, *SW_BENCH, split))
        return torch.fft.rfft(prods, dim=1)
    return go


def _turns(kern, strict, rounds: int = 2) -> tuple:
    """The mean CUDA-event times of kern and strict, in turns (kern,
    strict, strict, kern, ...)."""
    a, b = [], []
    for r in range(rounds):
        for fn, acc in ((kern, a), (strict, b))[::1 if r % 2 == 0 else -1]:
            acc.append(cuda_ms(fn))
    return sum(a) / len(a), sum(b) / len(b)


def xtile_parts(n: int, dev) -> dict:
    """The cuts of csrc/xtile_parts.cu at n^2 (the one-field x-stage over
    hny columns): ms of each cut, fast and strict, on two float planes
    (kx_fwd's load and store) and on complex64 (xstage's), in turns, and
    the part each cut adds; the resident clusters of the full cut."""
    from xlab_fftbarotropic_torch.ops import _build
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.ops import fused_sw as fs
    from xlab_fftbarotropic_torch.ops.xtile import xtile_plan
    from xlab_fftbarotropic_torch.parallel import fused_overlap as fo

    lib = _build.lib()
    hny = n // 2 + 1
    rng = np.random.default_rng(n + 5)
    xr, xi = (torch.from_numpy(rng.standard_normal((n, hny)).astype(
        np.float32)).to(dev) for _ in range(2))
    xc = torch.complex(xr, xi)
    yr, yi = torch.empty_like(xr), torch.empty_like(xr)
    yc = torch.empty_like(xc)
    tw = ff._twiddles(n, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for cplx in (0, 1):
        p = xtile_plan(n, hny, 8 if cplx else 4)
        args = ((xc.data_ptr(), None, yc.data_ptr(), None) if cplx else
                (xr.data_ptr(), xi.data_ptr(), yr.data_ptr(),
                 yi.data_ptr()))
        where = "complex64" if cplx else "float planes"

        def cut(fast, stop):
            def go():
                rc = lib.xfb_xtile_parts(fast, cplx, stop, *args,
                                         tw.data_ptr(), n, hny, p.c, p.k,
                                         p.threads, p.smem, dev.index,
                                         stream)
                check(rc == 0, f"xfb_xtile_parts: {torch.cuda.CudaError(rc)}")
            return go
        ms = {f: [0.0] * len(XTILE_CUTS) for f in (1, 0)}
        for stop in range(len(XTILE_CUTS)):
            ms[1][stop], ms[0][stop] = _turns(cut(1, stop), cut(0, stop))
        # the full cuts are the kernels: their bits against the wrappers'
        for fast in (1, 0):
            cut(fast, 4)()
            if cplx:
                want = [fo.xstage(xc[None], True, fast=bool(fast))[0]]
                got = [yc]
            else:
                want = list(fs.kx_fwd(xr[None], xi[None], fast=bool(fast)))
                got = [yr[None], yi[None]]
            torch.cuda.synchronize()
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"the full {where} cut (fast {fast}) is not its kernel")
        for fast in (1, 0):
            tag = "fast" if fast else "strict"
            adds = [ms[fast][0]] + [ms[fast][i] - ms[fast][i - 1]
                                    for i in range(1, len(XTILE_CUTS))]
            log(f"parts {where:12s} {tag:6s} {n}^2: " + ", ".join(
                f"{name} {t:.4f} ms (+{d:.4f})" for name, t, d in
                zip(XTILE_CUTS, ms[fast], adds)))
            occ = (ctypes.c_int * 4)()
            rc = lib.xfb_xtile_occupancy(fast, p.tiles, p.k, p.threads,
                                         p.smem, dev.index, occ)
            check(rc == 0, f"xfb_xtile_occupancy: {rc}")
            log(f"parts {where:12s} {tag:6s} {n}^2: {occ[0]} clusters of "
                f"{p.k} resident, {occ[1]} blocks per SM, {occ[2]} "
                f"registers, {occ[3]} local bytes; {p.tiles} tiles = "
                f"{p.tiles / max(occ[0], 1):.2f} waves")
            out[f"{where} {tag}"] = dict(
                cuts_ms=ms[fast], adds_ms=adds, clusters=occ[0],
                blocks_per_sm=occ[1], registers=occ[2],
                local_bytes=occ[3], tiles=p.tiles)
    return out


def xtile_tparts(n: int, dev) -> dict:
    """The cuts of the transposed store (csrc/xtile_parts.cu
    xfb_xtile_tparts) at n^2: ms of each cut, fast and strict, in turns,
    and the part each adds, of each form of XTILE_TFORMS: kc's (two (n,
    n) float planes in, the half store), ka's real forward (one plane in,
    the full store), kb's (the Hermitian load of two (n/2 + 1, n) pairs,
    or one for the single inverse, the full x-major store) and ky_all's
    (the five products of four (n, n) planes, the half store); the full
    cuts' outputs are their kernels' bit for bit, strict and fast."""
    from xlab_fftbarotropic_torch.ops import _build
    from xlab_fftbarotropic_torch.ops import fused_fft as ff
    from xlab_fftbarotropic_torch.ops import fused_sw as fs
    from xlab_fftbarotropic_torch.ops.xtile import xtile_plan

    lib = _build.lib()
    rng = np.random.default_rng(n + 6)
    hny = n // 2 + 1
    planes, _ = _makers(rng, dev)
    xr, xi = planes((n, n), 2)
    w = planes((hny, n), 4, n * math.sqrt(n))
    sw = [a * f for a, f in zip((3.0, 3.0, 1e-4, 1e-4), planes((n, n), 4))]
    scale = 1.0 / (n * n)
    tw = ff._twiddles(n, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = xtile_plan(n, n, 4)
    out = {}
    for where, (form, single) in XTILE_TFORMS.items():
        if form == 2:
            ins = w[:2] + [None, None] if single else w
            shape = (n, n)
        elif form == 3:
            ins, shape = sw, (5, n, hny)
        else:
            ins = [xr, xi, None, None]
            shape = (n, n if form == 1 else hny)
        yr = torch.empty(shape, dtype=torch.float32, device=dev)
        yi = None if single else torch.empty_like(yr)
        ptrs = [None if a is None else a.data_ptr() for a in ins]

        def cut(fast, stop):
            def go():
                rc = lib.xfb_xtile_tparts(
                    fast, form, stop, *ptrs, yr.data_ptr(),
                    None if yi is None else yi.data_ptr(), tw.data_ptr(), n,
                    n, scale, p.c, p.k, p.threads, p.smem, dev.index,
                    stream)
                check(rc == 0,
                      f"xfb_xtile_tparts: {torch.cuda.CudaError(rc)}")
            return go
        ms = {f: [0.0] * len(XTILE_TCUTS) for f in (1, 0)}
        for stop in range(len(XTILE_TCUTS)):
            ms[1][stop], ms[0][stop] = _turns(cut(1, stop), cut(0, stop))
        for fast in (1, 0):
            cut(fast, 4)()
            if form == 0:
                want = ff.kc(xr, xi, fast=bool(fast))
            elif form == 1:
                want = ff.ka(xr, None, True, fast=bool(fast))
            elif form == 2:
                want = ff.kb(*ins, scale, fast=bool(fast))
            else:
                want = fs.ky_all(*sw, *TPARTS_SW, fast=bool(fast))
            torch.cuda.synchronize()
            check(torch.equal(yr, want[0]) and
                  (yi is None or torch.equal(yi, want[1])),
                  f"the full {where} cut (fast {fast}) is not its kernel")
        for fast in (1, 0):
            tag = "fast" if fast else "strict"
            adds = [ms[fast][0]] + [ms[fast][i] - ms[fast][i - 1]
                                    for i in range(1, len(XTILE_TCUTS))]
            log(f"transposed parts {where:15s} {tag:6s} {n}^2: " +
                ", ".join(f"{name} {t:.4f} ms (+{d:.4f})" for name, t, d in
                          zip(XTILE_TCUTS, ms[fast], adds)))
            out[f"{where} {tag}"] = dict(cuts_ms=ms[fast], adds_ms=adds)
        del yr, yi
    return out


def phase_fast_xstages(n: int, dev) -> dict:
    """Phase 5v (see the module docstring)."""
    report = {"checks": {}, "forms": {}}
    for shape in FAST_XSTAGE_SHAPES:
        size, cols = shape
        cases, _ = _xstage_forms(size, cols, dev, size + cols)
        for name, case in cases.items():
            report["checks"][f"{name} {shape}"] = fast_check(
                name, case, f"{size} x {cols}")
    cases, libs = _xstage_forms(n, None, dev, n)
    for name, (_, row) in FAST_XSTAGE_FORMS.items():
        case = cases[name]
        outputs = case.fields(case.kern())
        bound_ms, bound_by, parts = fast_bound(case, outputs, n)
        ms, strict_ms = _turns(case.kern, case.strict)
        lib = libs[name]
        library_ms = None if lib is None else cuda_ms(lib)
        libtxt = ("no one torch call" if library_ms is None else
                  f"torch call {library_ms:.4f} ms ({ms / library_ms:.2f}x)")
        log(f"fast x-stage {name:22s} (row {row}) {n}^2: {ms:.4f} ms, "
            f"strict {strict_ms:.4f} ms ({ms / strict_ms:.3f}x), {libtxt}; "
            f"bound {bound_ms:.4f} ms ({bound_by}; {100 * bound_ms / ms:.1f} "
            f"% of it, strict {100 * bound_ms / strict_ms:.1f} %)")
        report["forms"][name] = dict(row=row, ms=ms, strict_ms=strict_ms,
                                     library_ms=library_ms,
                                     bound_ms=bound_ms, bound_by=bound_by,
                                     **parts)
    report["parts"] = xtile_parts(n, dev)
    report["transposed_parts"] = xtile_tparts(n, dev)
    report["ptxas"] = {k: v for k, v in phase_xtile(n)["ptxas"].items()
                       if k.split()[0] in ("kx_visc_kernel", "xstage_kernel",
                                           "ka_kernel", "kc_kernel",
                                           "kb_kernel", "ky_all_kernel")
                       or "parts_kernel" in k}
    return report


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
    ap.add_argument("--rank-worker", default=None, metavar="DIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--phase", choices=["5r", "5s", "5t", "5u", "5v"],
                    default=None,
                    help="run the toolchain phase and this phase alone (a "
                    "quick check of it; no result lines)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    check(args.steps >= 2 and args.steps % 2 == 0, "--steps must be even")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device visible (torch.cuda."
                 "is_available() is False)")
    if args.rank_worker:
        return rank_worker(Path(args.rank_worker), args.n)
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
    if args.phase:
        if args.phase == "5r":
            report["sharded_families"] = phase_sharded_families(
                args.n, args.steps, dev)
        elif args.phase == "5s":
            report["pencil"] = phase_pencil(args.n, args.steps, dev)
        elif args.phase == "5u":
            report["parity"] = phase_parity(dev)
        elif args.phase == "5v":
            report["fast_xstages"] = phase_fast_xstages(args.n, dev)
        else:
            report["ranks"] = phase_ranks(args.n, dev)
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(report, indent=1))
        log(f"phase {args.phase} alone: {time.perf_counter() - t_start:.1f} "
            f"s; {smi}")
        return 0

    def at(what):
        log(f"{what} done at {time.perf_counter() - t_start:.1f} s")

    report["xtile"] = phase_xtile(args.n)
    report["kernels"] = phase_kernels(args.n, dev)
    at("kernels")
    report["main_paths"] = {family: phase_main_path(family, args.n,
                                                    args.steps)
                            for family in CLI_FAMILIES}
    at("main paths")
    for path in MODEL_PATHS:
        report["main_paths"][path] = phase_model_path(path, args.n,
                                                      args.steps)
    at("model paths")
    report["main_paths"]["adjoint"] = phase_adjoint(args.n, dev,
                                                    args.profile)
    at("5e adjoint")
    report["sharded"] = phase_sharded(args.n, args.steps, dev, args.profile)
    report["main_paths"].update(report["sharded"]["main_paths"])
    at("5j sharded")
    report["main_paths"]["postproc"] = phase_postproc(args.n, dev)
    at("5k postproc")
    with tempfile.TemporaryDirectory(prefix="xfb_smoke_") as tmp:
        spectral = spectral_run(args.n, args.steps, Path(tmp))
        report["main_paths"]["diagnose"] = phase_diagnose(
            args.n, args.steps, dev, spectral, args.profile)
        report["main_paths"]["fd"] = phase_fd(args.n, args.steps, dev,
                                              spectral)
        report["main_paths"]["ensemble"] = phase_ensemble(
            args.n, args.steps, dev, spectral)
    at("5l-5n")
    report["fast"] = phase_fast(args.n, args.steps, dev, args.profile)
    report["kernels"].update(report["fast"]["kernels"])
    report["main_paths"]["barotropic-fast"] = report["fast"]["main_path"]
    at("5o fast")
    report["fast_sw"] = phase_fast_sw(args.n, args.steps, dev, args.profile)
    report["kernels"].update(report["fast_sw"]["kernels"])
    report["main_paths"].update(report["fast_sw"]["main_paths"])
    at("5o fast sw")
    report["fast_arms"] = phase_fast_arms(args.n, args.steps, dev,
                                          args.profile)
    report["kernels"].update(report["fast_arms"]["kernels"])
    report["main_paths"].update(report["fast_arms"]["main_paths"])
    at("5o fast arms")
    report["fast_xfirst"] = phase_fast_xfirst(args.n, args.steps, dev,
                                              args.profile)
    report["kernels"].update(report["fast_xfirst"]["kernels"])
    report["main_paths"].update(report["fast_xfirst"]["main_paths"])
    at("5p")
    report["fast_rest"] = phase_fast_rest(args.n, args.steps, dev,
                                          args.profile)
    report["kernels"].update(report["fast_rest"]["kernels"])
    report["main_paths"].update(report["fast_rest"]["main_paths"])
    at("5q")
    report["sharded_families"] = phase_sharded_families(args.n, args.steps,
                                                        dev)
    report["main_paths"].update(report["sharded_families"]["main_paths"])
    at("5r")
    report["pencil"] = phase_pencil(args.n, args.steps, dev)
    report["main_paths"].update(report["pencil"]["main_paths"])
    at("5s")
    report["ranks"] = phase_ranks(args.n, dev)
    report["main_paths"].update(report["ranks"]["main_paths"])
    at("5t")
    report["parity"] = phase_parity(dev)
    at("5u")
    report["etd_tables"] = phase_tables(args.n, dev)
    at("5f tables")
    models = build_models(args.n, dev)
    phase_no_library(args.n, models)
    report["trajectories"] = phase_trajectories(args.n, args.steps, models)
    at("6-9 trajectories")
    report["time"] = phase_time(args.n, args.steps, models)
    at("10 time")
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
        if "launch_ms" in k:
            rows[-1]["launch_ms"] = k["launch_ms"]
    check(all(math.isfinite(r["ms"]) for r in rows), "kernel times")
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s in all "
        f"(the build included)")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
