"""Numerical-health guards (the port's copy of
xlab_fftbarotropic_tpu/utils)."""
