"""Figures from a run's records (numpy/matplotlib): viz/plots.py."""
