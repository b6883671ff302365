"""ctypes bindings for the native C++ runtime (native/*.cpp): the port's
own copy of xlab_fftbarotropic_tpu/io/native_stream.py.

The reference's native pieces are its libfieldio.so and the in-process FIFO
protocol reader (src/vorticity_source.cpp); ours are native/fieldio.cpp and
native/vort_src.cpp — the latter adds a prefetch thread so the pipe read for
step k+1 overlaps the device compute of step k. Build with `make -C native`;
everything degrades gracefully to the pure-Python implementations when the
.so is absent. Only the reading side is copied.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"

_LIB = None
_TRIED = False


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.environ.get("XFB_LIBVORTSRC",
                          str(NATIVE_DIR / "libvortsrc.so"))
    if os.path.exists(path):
        lib = ctypes.CDLL(path)
        lib.xfb_src_open.restype = ctypes.c_void_p
        lib.xfb_src_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.xfb_src_next.restype = ctypes.c_int
        lib.xfb_src_next.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_size_t]
        lib.xfb_src_close.restype = None
        lib.xfb_src_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def available() -> bool:
    return _lib() is not None


class NativeFifoReader:
    """FIFO protocol reader backed by the C++ prefetch thread.

    Same (changed, field) contract as forcing.source.FifoSourceReader.
    """

    def __init__(self, path, grid_shape: Tuple[int, int]):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native libvortsrc.so not built")
        self._lib = lib
        self._shape = tuple(grid_shape)
        self._n = int(np.prod(self._shape))
        self._buf = np.zeros(self._n, dtype=np.float32)
        self._handle = lib.xfb_src_open(str(path).encode(), self._n)
        if not self._handle:
            raise IOError(f"cannot open FIFO {path}")

    def read(self, time: float) -> Tuple[bool, Optional[np.ndarray]]:
        rc = self._lib.xfb_src_next(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._n)
        if rc < 0:
            raise IOError("vorticity-source FIFO protocol error "
                          "(pipe closed mid-field)")
        if rc == 1:
            return True, self._buf.reshape(self._shape).copy()
        return False, None

    def close(self) -> None:
        if self._handle:
            self._lib.xfb_src_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

