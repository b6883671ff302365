"""xlab_fftbarotropic_torch — the PyTorch / CUDA port of
xlab_fftbarotropic_tpu for one NVIDIA H100.

It imports torch and never jax. The numpy-only modules of the JAX
package (config, initial conditions, field I/O, checkpoints, forcing
streams, guards) are reused by import; the spectral tables, the FFT
path, the barotropic, tracer and shallow-water models, the runner and
the run CLI are ported, and the plane steppers' TPU kernels are hand-written CUDA
kernels (csrc/, built at first use into _build/).
"""

from .reused import ModelConfig

__version__ = "0.1.0"
__all__ = ["ModelConfig"]
