"""Field I/O: reference-byte-compatible raw binary fields + run manifest.
The port's own copy of xlab_fftbarotropic_tpu/io/fieldio.py.

Equivalent of the reference's libfieldio shared library
(the reference's src/fieldio.{hpp,cpp}, built at Makefile:26-27): raw
headerless little-endian float32 dumps of whole fields, x-major/y-contiguous
(IDX(i,j) = ny*i + j, configuration.hpp:31). Files written here are
bit-identical in layout to the reference's, so its downstream tooling
(draw_figs.py's np.fromfile, invert_pres/find_min stdin pipelines) works
unchanged on our outputs and vice versa.

Two backends:
  * a native C++ implementation (native/fieldio.cpp, loaded via ctypes) —
    the analogue of the reference's only shared library, used when built;
  * a numpy fallback (always available).

The Manifest mirrors the reference's flat `log` file of written paths
(main.cpp:97-99,270) which the shell pipelines parse (test/01-runtest/
invert.sh:1); keeping it preserves end-to-end pipeline parity.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_NATIVE = None
_NATIVE_TRIED = False


def _native_lib():
    """Load native/libfieldio.so if built; cache the result."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    here = Path(__file__).resolve().parents[2] / "native" / "libfieldio.so"
    cand = os.environ.get("XFB_LIBFIELDIO", str(here))
    if os.path.exists(cand):
        lib = ctypes.CDLL(cand)
        lib.xfb_write_field.restype = ctypes.c_long
        lib.xfb_write_field.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                        ctypes.c_size_t]
        lib.xfb_read_field.restype = ctypes.c_long
        lib.xfb_read_field.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_size_t]
        _NATIVE = lib
    return _NATIVE


def write_field(filename, data) -> None:
    """writeField (fieldio.cpp:7-19): raw float32 dump, no header."""
    arr = np.ascontiguousarray(np.asarray(data), dtype="<f4")
    lib = _native_lib()
    if lib is not None:
        rc = lib.xfb_write_field(str(filename).encode(),
                                 arr.ctypes.data_as(ctypes.c_void_p), arr.size)
        if rc != arr.size:
            raise IOError(f"native write_field failed for {filename} (rc={rc})")
        return
    arr.tofile(str(filename))


def read_field(filename, shape: Optional[Tuple[int, ...]] = None) -> np.ndarray:
    """readField (fieldio.cpp:21-33) with the missing-file check the
    reference lacks (SURVEY.md §5.10-4)."""
    path = Path(filename)
    if not path.exists():
        raise FileNotFoundError(str(path))
    if shape is not None:
        count = int(np.prod(shape))
        lib = _native_lib()
        if lib is not None:
            out = np.empty(count, dtype="<f4")
            rc = lib.xfb_read_field(str(path).encode(),
                                    out.ctypes.data_as(ctypes.c_void_p), count)
            if rc != count:
                raise IOError(f"native read_field: expected {count} floats, "
                              f"got {rc} from {path}")
            return out.reshape(shape)
        data = np.fromfile(str(path), dtype="<f4", count=count)
        if data.size != count:
            raise IOError(f"{path}: expected {count} float32s, got {data.size}")
        return data.reshape(shape)
    return np.fromfile(str(path), dtype="<f4")


class Manifest:
    """The reference's `log` manifest of written field paths
    (main.cpp:97-99, 270 etc.), flushed per line for live pipelines."""

    def __init__(self, path="log"):
        self.path = str(path)
        self._fd = open(self.path, "w")

    def record(self, filename) -> None:
        self._fd.write(f"{filename}\n")
        self._fd.flush()

    def close(self) -> None:
        self._fd.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FieldRecorder:
    """Writes the per-record-step output contract (SURVEY.md §5.9):
    {vort_src_input,vort,psi,u,v}_step_N.bin into output_dir, each path
    appended to the manifest."""

    def __init__(self, output_dir, manifest: Optional[Manifest] = None):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.manifest = manifest

    def _write(self, name: str, step: int, data) -> Path:
        path = self.dir / f"{name}_step_{step}.bin"
        # ensemble members record into per-member subdirectories
        # ("m00/vort_step_N.bin") so each member's tree keeps the exact
        # reference layout for downstream pipelines
        if path.parent != self.dir:
            path.parent.mkdir(parents=True, exist_ok=True)
        write_field(path, data)
        if self.manifest is not None:
            self.manifest.record(path)
        return path

    # Preferred write order: the reference's order within a record step —
    # vort_src, vort (main.cpp:266-282), then psi, u, v from the first RK
    # stage (main.cpp:181-222) — followed by any new-model fields (div, h).
    ORDER = ("vort_src", "vort", "psi", "u", "v", "div", "h")

    def record(self, step: int, *, vort_src=None, **fields) -> None:
        if vort_src is not None:
            self._write("vort_src_input", step, vort_src)
        ordered = [k for k in self.ORDER[1:] if fields.get(k) is not None]
        ordered += [k for k in fields
                    if k not in self.ORDER and fields[k] is not None]
        for k in ordered:
            self._write(k, step, fields[k])
