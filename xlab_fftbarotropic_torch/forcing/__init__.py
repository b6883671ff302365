"""Vorticity-source forcing streams (the port's copy of
xlab_fftbarotropic_tpu/forcing)."""
