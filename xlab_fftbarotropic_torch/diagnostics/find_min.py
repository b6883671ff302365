"""Field minima: the counterpart of
xlab_fftbarotropic_tpu/diagnostics/find_min.py.

Equivalent of find_min.out (the reference's src/find_min.cpp): the n
smallest values of a field and their grid coordinates, sorted ascending
by value, ties broken by the lower flat index (as JAX's lax.top_k, which
the JAX package runs). Coordinates decode as find_min.cpp:86-87: for flat
index p, x = p // ny, y = p % ny.

On the field's device: torch.topk of -field gives the n-th smallest
value v; the result is every value below v and, of those equal to v, the
lowest flat indices, in a stable sort by value (torch.topk leaves the
order of ties open).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def find_min_n(field, n: int = 30, device=None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x_idx, y_idx, values) of the n smallest entries of a 2-D field (a
    numpy array or a tensor; on `device` when given), sorted ascending by
    value, ties by flat index; numpy int32, int32 and float32 arrays.
    find_min.cpp's default is n = 30 (find_min.cpp:72)."""
    a = torch.as_tensor(field, dtype=torch.float32, device=device)
    ny = a.shape[-1]
    flat = a.reshape(-1)
    nth = -torch.topk(-flat, n).values[-1]
    below = torch.nonzero(flat < nth).squeeze(1)
    tied = torch.nonzero(flat == nth).squeeze(1)[:n - below.numel()]
    idx = torch.sort(torch.cat([below, tied])).values
    order = torch.sort(flat[idx], stable=True).indices
    idx = idx[order]
    vals = flat[idx]
    x = (idx // ny).to(torch.int32)                  # find_min.cpp:87
    y = (idx % ny).to(torch.int32)                   # find_min.cpp:86
    return x.cpu().numpy(), y.cpu().numpy(), vals.cpu().numpy()


def format_minima(x, y, vals) -> str:
    """The reference's stdout contract: '%zu %zu %.5e' per line
    (find_min.cpp:89)."""
    return "\n".join(f"{int(xi)} {int(yi)} {float(vi):.5e}"
                     for xi, yi, vi in zip(x, y, vals))
