"""Distributed execution: the counterpart of xlab_fftbarotropic_tpu/
parallel/ for the barotropic, shallow-water and tracer families (slab,
x-pencil and 2-D pencil decompositions, the library collectives and the
kernels of TPU rows 21-23), with the shards stacked on one card or one
shard per torch.distributed rank (multihost.py, peer.py)."""

from .dfft import irfft2_local, make_fft_pair, rfft2_local  # noqa: F401
from .model import (  # noqa: F401
    ShardedBarotropicModel,
    ShardedShallowWaterModel,
    ShardedTracerModel,
    ShardGroup,
    make_mesh,
    make_mesh2d,
)
from .multihost import initialize as initialize_multihost  # noqa: F401
from .multihost import is_primary  # noqa: F401
