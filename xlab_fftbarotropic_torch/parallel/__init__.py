"""Distributed execution on stacked shards: the counterpart of
xlab_fftbarotropic_tpu/parallel/ for the barotropic, shallow-water and
tracer families (slab, x-pencil and 2-D pencil decompositions, the
library collectives and the kernels of TPU rows 21-23). The
multi-process executor is not ported yet."""

from .dfft import irfft2_local, make_fft_pair, rfft2_local  # noqa: F401
from .model import (  # noqa: F401
    ShardedBarotropicModel,
    ShardedShallowWaterModel,
    ShardedTracerModel,
    ShardGroup,
    make_mesh,
)
