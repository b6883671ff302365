"""Build and load the hand-written CUDA kernels.

The stepping kernels (csrc/*.cu, the FFT ones sharing csrc/colfft.cuh) compile
with nvcc for Hopper (sm_90a) into one shared library with a plain C
interface, loaded with ctypes: pointers and the stream pass as
ctypes.c_void_p, each launcher returns cudaGetLastError() as an int.

The build runs at first use, from the sources in the package only, into
xlab_fftbarotropic_torch/_build/<hash>/ where the hash covers every
source and the compiler flags, so a changed source rebuilds and an
unchanged one loads the library already there. The compiler's output
(-Xptxas -v: registers and shared memory per kernel) lands in build.log
beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
HEADERS = ("colfft.cuh",)
SOURCES = ("ka_diag.cu", "kb_pair.cu", "ky_adv.cu", "kx_visc.cu",
           "kb_adv_tracer.cu", "rk4_combine.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libxfb_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES = {
    # zr, zi, rlap, kx, ky, tw, wr, wi, n, hny, device, stream
    "xfb_ka_diag": [_P] * 8 + [_I, _I, _I, _P],
    # sr2, si2, rlap, kx, ky, tw, wr, wi, n, hny, device, stream
    "xfb_ka6": [_P] * 8 + [_I, _I, _I, _P],
    # wr, wi, fa, fb, tw, oa, ob, ny, nx, scale, device, stream
    "xfb_kb_pair": [_P, _P, _I, _I, _P, _P, _P, _I, _I, _F, _I, _P],
    # u, zx, v, zy, src, tw, outr, outi, ny, nx, beta, device, stream
    "xfb_ky_adv": [_P] * 8 + [_I, _I, _F, _I, _P],
    # fr, fi, lap, mask, zsr, zsi, z0r, z0i, tw, rr, ri, nr, ni,
    # nfields, nx, hny, nu, coef, device, stream
    "xfb_kx_visc": [_P] * 13 + [_I, _I, _I, _F, _F, _I, _P],
    # zx, zy, qx, qy, wr, wi, src, tw, outr, outi, ny, nx, scale, beta,
    # device, stream
    "xfb_kb_adv_tracer": [_P] * 10 + [_I, _I, _F, _F, _I, _P],
    # host array of 6 * n_planes pointers, n_planes, numel, c, device,
    # stream
    "xfb_rk4_combine": [_P, _I, _L, _F, _I, _P],
}

_LIB: Optional[ctypes.CDLL] = None
# what the last build() did: library path, seconds, whether it compiled
LAST_BUILD: dict = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or nvcc on PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and "
            "PATH): the CUDA kernels cannot be built")
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless the library for these sources exists;
    returns its path. Raises with the compiler's output on failure."""
    out_dir = BUILD_ROOT / source_hash()
    so = out_dir / LIB_NAME
    if so.exists():
        LAST_BUILD.update(path=str(so), seconds=0.0, compiled=False)
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    # private name, then an atomic rename: concurrent first users
    # (test workers) never load a half-written library
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    LAST_BUILD.update(path=str(so), seconds=seconds, compiled=True)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB
