"""Checkpoint / resume: the port's own copy of
xlab_fftbarotropic_tpu/io/checkpoint.py, same file format, so a
checkpoint written by either package resumes in the other.

New capability (the reference has none — SURVEY.md §6: a run could only be
restarted implicitly from a recorded vort_step_N.bin with no step-offset
plumbing). A checkpoint stores the EXACT spectral state zeta_hat (complex64)
— not the physical field, whose r2c/c2r roundtrip would perturb dealiased
modes — plus the step index and a config hash so restarts are deterministic
and misconfigured restarts fail loudly.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from ..config import ModelConfig


def save_checkpoint(path, cfg: ModelConfig, state, step: int,
                    kind: str = "barotropic") -> None:
    """`state` is the adapter-packed ndarray (complex spectral for the
    spectral families, float physical for the FD family); `kind` names the
    model family so a resume with the wrong -m fails with a clear error."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path,
             zeta_hat=np.asarray(state),
             step=np.int64(step),
             kind=np.bytes_(kind.encode()),
             config_json=np.bytes_(cfg.to_json().encode()),
             config_hash=np.bytes_(cfg.config_hash().encode()))


def load_checkpoint(path, cfg: ModelConfig = None,
                    kind: str = None) -> Tuple[np.ndarray, int, ModelConfig]:
    """Returns (state, step, saved_cfg). If cfg is given, validates the
    numerics hash; if kind is given, validates the model family."""
    with np.load(Path(path)) as z:
        state = z["zeta_hat"]
        step = int(z["step"])
        saved_cfg = ModelConfig.from_json(bytes(z["config_json"]).decode())
        saved_kind = (bytes(z["kind"]).decode() if "kind" in z
                      else "barotropic")
    if kind is not None and saved_kind != kind:
        raise ValueError(
            f"checkpoint is for model family {saved_kind!r}, "
            f"cannot resume it with {kind!r}")
    if cfg is not None and cfg.config_hash() != saved_cfg.config_hash():
        raise ValueError(
            f"checkpoint config mismatch: saved {saved_cfg.config_hash()} "
            f"!= current {cfg.config_hash()}")
    return state, step, saved_cfg
