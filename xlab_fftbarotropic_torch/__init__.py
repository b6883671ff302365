"""xlab_fftbarotropic_torch — the PyTorch / CUDA port of
xlab_fftbarotropic_tpu for one NVIDIA H100.

It imports torch and never jax, nor anything of the JAX package. It
keeps its own copies of the JAX package's numpy-only modules (config,
initial conditions, field I/O, checkpoints, forcing streams, guards) at
the same module paths, with the same file formats and config hash; the
spectral tables, the FFT path, the barotropic, tracer and shallow-water
models with their RK4 and ETDRK4 schemes, the runner and the run CLI are
ported, and the plane steppers' TPU kernels are hand-written CUDA
kernels (csrc/, built at first use into _build/).
"""

from .config import ModelConfig

__version__ = "0.1.0"
__all__ = ["ModelConfig"]
