"""Distributed execution on stacked shards: the counterpart of
xlab_fftbarotropic_tpu/parallel/ for the barotropic family (slab and
x-pencil decompositions, the library collectives and the kernels of TPU
rows 21-23). The 2-D pencil decomposition, the multi-process executor
and the sharded shallow-water and tracer models are not ported yet."""

from .dfft import irfft2_local, make_fft_pair, rfft2_local  # noqa: F401
from .model import (  # noqa: F401
    ShardedBarotropicModel,
    ShardGroup,
    make_mesh,
)
