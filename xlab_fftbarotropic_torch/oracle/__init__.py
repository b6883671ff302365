"""The CPU oracle: a float32 numpy transcription of the reference
pipeline (reference_cpu.py)."""
