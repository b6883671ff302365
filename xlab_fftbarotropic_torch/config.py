"""Model configuration: the port's own copy of
xlab_fftbarotropic_tpu/config.py.

Every field, default, the JSON form and config_hash() are those of the
JAX package's ModelConfig, and must stay so: checkpoints store the JSON
and the hash, and the ETDRK4 table cache keys on the fields
(models/etdrk4.py:tables_cache_key), so a checkpoint or a cached table
stack written by either package is read by the other
(tests/test_torch_copies.py holds the two classes field for field).

The reference bakes every physics/grid/time constant into the binary
(its src/configuration.hpp:10-41); here the configuration is a frozen
dataclass that the CLI fills.

Defaults reproduce configuration.hpp exactly:
  rho=1, f=1e-5, L=600 km, nu=6.5 m^2/s, N=768, dt=3 s,
  record_step=100, total_steps=3600/3=1200,
  input/output dirs and initial file names (configuration.hpp:39-41).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static configuration for the barotropic / shallow-water solvers.

    Mirrors the reference's src/configuration.hpp:10-41 field-for-field, plus
    runtime knobs the reference hard-codes or lacks (dealias rule selection,
    precision, checkpointing cadence).
    """

    # --- physics (configuration.hpp:10-17) ---
    rho: float = 1.0            # density [kg/m^3]
    f: float = 1e-5             # Coriolis parameter [1/s]
    nu: float = 6.5             # Laplacian viscosity [m^2/s]
    # Boundary-layer feedback (the reference's unimplemented TODO.md:11
    # "Add boundary layer feedback mechanism"): linear Ekman/Rayleigh
    # spin-down -r_drag*zeta on the vorticity equation (and -r_drag on
    # the SW divergence equation — surface drag on the momentum). 0
    # disables it exactly (default; bit-identical to the reference
    # contract). Units [1/s]; e-folding time = 1/r_drag.
    r_drag: float = 0.0
    # Beta-plane Rossby parameter df/dy [1/(m s)] (new capability; the
    # reference is strictly f-plane, configuration.hpp:11). Adds the
    # planetary-vorticity advection -beta*v to the barotropic vorticity
    # equation (and to the tracer family's flow): with v = psi_x the
    # whole term folds into the existing advection product as
    # -v*(zeta_y + beta) — zero extra transforms on every path,
    # including the fused Pallas plane-stepper kernels. 0 disables it
    # exactly (static trace-time branch; bit-identical f-plane path).
    # Not supported for shallow-water (a true SW beta plane needs the
    # spatially varying f in the curl/divergence of f*u — build() raises).
    beta: float = 0.0
    # Biharmonic hyperviscosity coefficient nu4 [m^4/s] (new capability;
    # the reference has only the plain Laplacian nu, configuration.hpp:
    # 17). Adds -nu4*lap^2(zeta) to the vorticity tendency (and to the
    # tracer family's flow) — the standard scale-selective dissipation
    # for high-resolution turbulence runs, where the reference's nu
    # either underdamps the grid scale or overdamps the inertial range.
    # Spectral: an exact diagonal -nu4*k^4 multiply; on the fused plane
    # stepper it folds into the viscous table like r_drag (zero kernel
    # changes). 0 disables it exactly (static bit-identical branch).
    # Shallow water: applied to zeta and div on the per-transform/XLA
    # paths; the fused SW plane stepper falls back like it does for
    # drag (the lap table doubles as the pressure operator there).
    nu4: float = 0.0

    # --- domain (configuration.hpp:13-16) ---
    lx: float = 600_000.0       # domain length in x [m]
    ly: float = 600_000.0       # domain length in y [m]

    # --- grid (configuration.hpp:18-21) ---
    nx: int = 768
    ny: int = 768

    # --- time stepping (configuration.hpp:34-36) ---
    dt: float = 3.0             # [s]
    record_step: int = 100      # record cadence in steps
    total_steps: int = 1200     # default run length (= 1 h at dt=3 s)

    # --- paths (configuration.hpp:39-41) ---
    input_dir: str = "input"
    output_dir: str = "output"
    init_file: str = "initial_vorticity.bin"

    # --- new framework knobs (no reference equivalent) ---
    # 'circular' replicates the reference's mask (fftwfop.cpp:56-68):
    #   kill modes with i^2+j^2 >= ceil(nx/3)^2 + ceil(ny/3)^2.
    # 'twothirds' is the textbook tensor-product 2/3 rule.
    dealias_rule: str = "circular"
    # shallow-water only: mean fluid depth [m] and gravity [m/s^2]
    gravity: float = 9.81
    mean_depth: float = 1000.0
    # checkpoint cadence in steps; 0 disables
    checkpoint_step: int = 0
    # Time integrator (all spectral families):
    #   'rk4'    — classic explicit RK4, the reference's scheme
    #              (main.cpp:286-317); dt capped by the gravity-wave
    #              CFL sqrt(gH)*k_max for SW (0.847 s at 4096^2
    #              defaults) and by nu/nu4 stiffness for hyperviscous
    #              barotropic/tracer runs.
    #   'etdrk4' — exponential ETDRK4 (models/etdrk4.py): the per-mode
    #              linear operator — the 3x3 Coriolis/gravity/mass/
    #              viscous block for SW, the scalar
    #              nu*lap - r - nu4*lap^2 (+ i*beta*kx*rlap) for
    #              barotropic, plus kappa*lap for the tracer —
    #              integrated EXACTLY via precomputed phi-function
    #              tables; only the advective CFL of the nonlinear
    #              terms remains (utils/guards.py:ETD_CFL_LIMIT).
    #              4th-order in dt on the nonlinear terms.
    time_scheme: str = "rk4"
    # FFT implementation for the single-device hot path:
    #   'auto'   — 'pallas' on TPU for supported grids, else 'xla'
    #   'xla'    — XLA's native FFT lowering (jnp.fft)
    #   'mxu'    — matmul four-step FFT via einsum (ops/mxu_fft.py;
    #              power-of-two grids only)
    #   'pallas' — fused Pallas kernel pipeline, one HBM round-trip per
    #              transform stage (ops/pallas_fft.py; power-of-two
    #              square grids >= 256; measured 1.48x the XLA core at
    #              4096^2 on v5e; interpret-mode on CPU)
    # All satisfy the same normalization contract; trajectories agree to
    # float32 round-off (tests/test_mxu_fft.py, test_pallas_fft.py), so
    # resuming a checkpoint under another backend is legal and the
    # restart hash excludes this.
    fft_backend: str = "auto"

    # ----- derived quantities -----
    @property
    def dx(self) -> float:
        return self.lx / self.nx

    @property
    def dy(self) -> float:
        return self.ly / self.ny

    @property
    def grids(self) -> int:
        return self.nx * self.ny

    @property
    def half_ny(self) -> int:
        """r2c half-spectrum extent of the (contiguous) y axis.

        Matches HALF_YPTS = ny/2 + 1 (configuration.hpp:28). The physical
        layout is x-major / y-contiguous (IDX(i,j) = ny*i + j,
        configuration.hpp:31) so the rfft2 half axis is the last axis.
        """
        return self.ny // 2 + 1

    @property
    def spectral_shape(self) -> Tuple[int, int]:
        return (self.nx, self.half_ny)

    @property
    def grid_shape(self) -> Tuple[int, int]:
        return (self.nx, self.ny)

    @property
    def dealias_kx(self) -> int:
        """Dealias cutoff wavenumber in x: ceil(nx/3) (fftwfop.cpp:11)."""
        return int(math.ceil(self.nx / 3.0))

    @property
    def dealias_ky(self) -> int:
        """Dealias cutoff wavenumber in y: ceil(ny/3) (fftwfop.cpp:12)."""
        return int(math.ceil(self.ny / 3.0))

    def coords(self):
        """Physical grid coordinates x[i]=i*dx, y[j]=j*dy (periodic, no
        endpoint duplication; makefield-gaussian.cpp:15,26-28)."""
        x = np.arange(self.nx, dtype=np.float32) * np.float32(self.dx)
        y = np.arange(self.ny, dtype=np.float32) * np.float32(self.dy)
        return x, y

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ----- (de)serialization for checkpoints / CLI -----
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ModelConfig":
        return cls(**json.loads(s))

    # fields that do NOT affect the numerics — excluded from the restart
    # hash so a resume into a different directory or with different
    # record/checkpoint cadences is legal
    _PATH_FIELDS = ("input_dir", "output_dir", "init_file",
                    "record_step", "checkpoint_step", "fft_backend")

    def config_hash(self) -> str:
        """Stable hash used to stamp checkpoints for restart validation.

        Covers only numerics-relevant fields: resuming with a different
        output directory is fine; resuming with a different grid/dt/nu
        fails loudly.
        """
        d = dataclasses.asdict(self)
        for k in self._PATH_FIELDS:
            d.pop(k, None)
        return hashlib.sha256(
            json.dumps(d, sort_keys=True).encode()).hexdigest()[:16]


def add_config_args(parser, defaults: Optional[ModelConfig] = None):
    """Register ModelConfig fields on an argparse parser.

    Replaces the reference's recompile-to-change-N workflow and its getopt
    flags -I/-O/-i (main.cpp:68-80) with a uniform CLI.
    """
    d = defaults or ModelConfig()
    parser.add_argument("-I", "--input-dir", default=d.input_dir)
    parser.add_argument("-O", "--output-dir", default=d.output_dir)
    parser.add_argument("-i", "--init-file", default=d.init_file)
    parser.add_argument("--nx", type=int, default=d.nx)
    parser.add_argument("--ny", type=int, default=d.ny)
    parser.add_argument("--lx", type=float, default=d.lx)
    parser.add_argument("--ly", type=float, default=d.ly)
    parser.add_argument("--dt", type=float, default=d.dt)
    parser.add_argument("--nu", type=float, default=d.nu)
    parser.add_argument("--r-drag", type=float, default=d.r_drag,
                        dest="r_drag",
                        help="boundary-layer (Ekman/Rayleigh) drag "
                             "coefficient [1/s]; 0 disables")
    parser.add_argument("--nu4", type=float, default=d.nu4,
                        help="biharmonic hyperviscosity coefficient "
                             "[m^4/s]; adds -nu4*lap^2 to the "
                             "vorticity (and SW divergence) tendency; "
                             "0 disables")
    parser.add_argument("--beta", type=float, default=d.beta,
                        help="beta-plane Rossby parameter df/dy "
                             "[1/(m s)]; adds -beta*v to the vorticity "
                             "equation (barotropic/tracer families); "
                             "0 disables")
    parser.add_argument("--coriolis-f", type=float, default=d.f, dest="f")
    parser.add_argument("--rho", type=float, default=d.rho)
    parser.add_argument("--gravity", type=float, default=d.gravity,
                        help="g [m/s^2] (shallow-water family)")
    parser.add_argument("--mean-depth", type=float, default=d.mean_depth,
                        dest="mean_depth",
                        help="mean fluid depth H [m] (shallow-water "
                             "family; gravity-wave speed sqrt(gH) sets "
                             "the CFL bound)")
    parser.add_argument("--total-steps", type=int, default=d.total_steps)
    parser.add_argument("--record-step", type=int, default=d.record_step)
    parser.add_argument("--checkpoint-step", type=int, default=d.checkpoint_step)
    parser.add_argument("--dealias-rule", choices=["circular", "twothirds"],
                        default=d.dealias_rule)
    parser.add_argument("--fft-backend",
                        choices=["auto", "xla", "mxu", "pallas"],
                        default=d.fft_backend)
    parser.add_argument("--time-scheme", choices=["rk4", "etdrk4"],
                        dest="time_scheme", default=d.time_scheme,
                        help="SW integrator: 'etdrk4' integrates the "
                             "linear (gravity-wave/Coriolis/viscous) "
                             "dynamics exactly, lifting the sqrt(gH) "
                             "CFL bound to the advective one "
                             "(models/etdrk4.py)")
    return parser


def config_from_args(args) -> ModelConfig:
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    return ModelConfig(**kw)
