"""Spectral operators, the torch.fft library path and the CUDA kernels."""
