"""The numpy-only modules of xlab_fftbarotropic_tpu that the port reuses
instead of copying, gathered in one place: the configuration, the
initial conditions, raw field I/O with the `log` manifest, checkpoints,
the forcing streams and the finite-value guard. None of them imports
jax (tests/test_torch_nojax.py checks it), and sharing them keeps the
record files, manifests and checkpoints of the two packages
interchangeable.
"""

from xlab_fftbarotropic_tpu.config import (ModelConfig, add_config_args,
                                           config_from_args)
from xlab_fftbarotropic_tpu.forcing.source import SourceReader, make_reader
from xlab_fftbarotropic_tpu.ic import makefields
from xlab_fftbarotropic_tpu.io.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
from xlab_fftbarotropic_tpu.io.fieldio import (FieldRecorder, Manifest,
                                               read_field, write_field)
from xlab_fftbarotropic_tpu.utils.guards import check_finite

__all__ = ["ModelConfig", "add_config_args", "config_from_args",
           "SourceReader", "make_reader", "makefields", "load_checkpoint",
           "save_checkpoint", "FieldRecorder", "Manifest", "read_field",
           "write_field", "check_finite"]
