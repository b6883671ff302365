"""Raw field I/O with the `log` manifest, checkpoints and the native
FIFO reader (the port's copies of xlab_fftbarotropic_tpu/io)."""
