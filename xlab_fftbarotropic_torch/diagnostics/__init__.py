"""Post-processing diagnostics of the PyTorch / CUDA port: the pressure
inversion (invert_pres.py), the field minima (find_min.py), the vortex
tracks across records (tracks.py), the E(k)/Z(k) spectra (spectra.py),
the kinematic diagnostics (kinematics.py: Okubo-Weiss, filamentation
time, deformation factor) and the effective eddy diffusivity
(eddy_diffusivity.py)."""
