"""Initial-condition generators (the port's copy of
xlab_fftbarotropic_tpu/ic)."""

from . import makefields
