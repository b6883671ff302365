"""Post-processing diagnostics of the PyTorch / CUDA port: the pressure
inversion (invert_pres.py), the field minima (find_min.py) and the vortex
tracks across records (tracks.py)."""
