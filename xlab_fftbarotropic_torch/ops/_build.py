"""Build and load the hand-written CUDA kernels.

The stepping kernels (csrc/*.cu, the FFT ones sharing the column-tile
transform of csrc/xtile.cuh) compile with nvcc for Hopper (sm_90a) into
one shared library with a plain C interface, loaded with ctypes:
pointers and the stream pass as ctypes.c_void_p, each launcher returns
cudaGetLastError() as an int.

The build runs at first use, from the sources in the package only, into
xlab_fftbarotropic_torch/_build/<hash>/ where the hash covers every
source and the compiler flags, so a changed source rebuilds and an
unchanged one loads the library already there. Every source compiles in
its own nvcc process, all started together, and one more nvcc links the
objects. The compiler's output (-Xptxas -v: registers and shared memory
per kernel) lands in build.log beside the library.
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
HEADERS = ("epilogue.cuh", "xtile.cuh")
SOURCES = ("ka_diag.cu", "kb_pair.cu", "ky_adv.cu", "kx_visc.cu",
           "kb_adv_tracer.cu", "rk4_combine.cu", "ka_sw.cu", "ky_all.cu",
           "sw_combine.cu", "ka_kc.cu", "kb_adv.cu", "visc.cu", "a2a.cu",
           "xstage.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v")
LIB_NAME = "libxfb_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES = {
    # zr, zi, rlap, kx, ky, tw, wr, wi, n, hny, tile_c, cluster_k,
    # threads, smem (the ops/xtile.py plan), device, stream
    "xfb_ka_diag": [_P] * 8 + [_I] * 7 + [_P],
    # sr2, si2, rlap, kx, ky, tw, wr, wi, n, hny, tile_c, cluster_k,
    # threads, smem, device, stream
    "xfb_ka6": [_P] * 8 + [_I] * 7 + [_P],
    # wr, wi, fa, fb, tw, oa, ob, ny, nx, scale, tile_c, cluster_k,
    # threads, smem (the ops/xtile.py plan), device, stream
    "xfb_kb_pair": [_P, _P, _I, _I] + [_P] * 3 + [_I, _I, _F] + [_I] * 5
    + [_P],
    # war, wai, wbr, wbi, tw, oa, ob, ny, nx, scale, tile_c, cluster_k,
    # threads, smem (the ops/xtile.py plan), device, stream
    "xfb_kb": [_P] * 7 + [_I, _I, _F] + [_I] * 5 + [_P],
    # u, zx, v, zy, src, tw, outr, outi, ny, nx, beta, tile_c,
    # cluster_k, threads, smem (the ops/xtile.py plan), device, stream
    "xfb_ky_adv": [_P] * 8 + [_I, _I, _F] + [_I] * 5 + [_P],
    # fr, fi, lap, mask, zsr, zsi, z0r, z0i, tw, rr, ri, nr, ni,
    # nfields, nx, hny, nu, coef, tile_c, cluster_k, threads, smem (the
    # ops/xtile.py plan), device, stream
    "xfb_kx_visc": [_P] * 13 + [_I, _I, _I, _F, _F] + [_I] * 5 + [_P],
    # zx, zy, qx, qy, wr, wi, src, tw, outr, outi, ny, nx, scale, beta,
    # tile_c, cluster_k, threads, smem (the ops/xtile.py plan), device,
    # stream
    "xfb_kb_adv_tracer": [_P] * 10 + [_I, _I, _F, _F] + [_I] * 5 + [_P],
    # host array of 6 * n_planes pointers, n_planes, numel, c, device,
    # stream
    "xfb_rk4_combine": [_P, _I, _L, _F, _I, _P],
    # host array of 3 * n_planes pointers, n_planes, numel, coef, device,
    # stream
    "xfb_plane_axpy": [_P, _I, _L, _F, _I, _P],
    # zr, zi, dr, di, er, ei, rlap, kx, ky, tw, wr, wi, n, hny, eta_scale,
    # tile_c, cluster_k, threads, smem (the ops/xtile.py plan), device,
    # stream
    "xfb_ka_sw": [_P] * 12 + [_I, _I, _F] + [_I] * 5 + [_P],
    # u, v, zeta, eta_s, tw, outr, outi, ny, nx, ies, f0, grav, split,
    # tile_c, cluster_k, threads, smem (the ops/xtile.py plan), device,
    # stream
    "xfb_ky_all": [_P] * 7 + [_I, _I, _F, _F, _F, _I] + [_I] * 5 + [_P],
    # host array of 32 pointers, nx, hny, f0, grav, nu, H, split, coef,
    # device, stream
    "xfb_sw_combine": [_P, _I, _I, _F, _F, _F, _F, _I, _F, _I, _P],
    # host array of 33 pointers, nx, hny, f0, grav, nu, H, split, scale,
    # device, stream
    "xfb_sw_combine_mv": [_P, _I, _I, _F, _F, _F, _F, _I, _F, _I, _P],
    # xr, xi, tw, yr, yi, n, m, forward, scale, tile_c, cluster_k,
    # threads, smem (the ops/xtile.py plan), device, stream
    "xfb_ka": [_P] * 5 + [_I, _I, _I, _F] + [_I] * 5 + [_P],
    # xr, xi, tw, yr, yi, ny, nx, tile_c, cluster_k, threads, smem,
    # device, stream
    "xfb_kc": [_P] * 5 + [_I] * 7 + [_P],
    # xr, xi, tw, yr, yi, nfields, ny, nx, tile_c, cluster_k, threads,
    # smem, device, stream
    "xfb_kc_sw": [_P] * 5 + [_I] * 8 + [_P],
    # xr, xi, lap, mask, zr, zi, tw, yr, yi, ny, nx, nu, tile_c,
    # cluster_k, threads, smem, device, stream
    "xfb_kc_visc": [_P] * 9 + [_I, _I, _F] + [_I] * 5 + [_P],
    # u, zx, v, zy, src, tw, yr, yi, nx, ny, beta, tile_c, cluster_k,
    # threads, smem (the ops/xtile.py plan), device, stream
    "xfb_ka_adv": [_P] * 8 + [_I, _I, _F] + [_I] * 5 + [_P],
    # u, v, zeta, eta_s, tw, yr, yi, nx, ny, ies, f0, grav, split, tile_c,
    # cluster_k, threads, smem (the ops/xtile.py plan), device, stream
    "xfb_ka_fwd": [_P] * 7 + [_I, _I, _F, _F, _F, _I] + [_I] * 5 + [_P],
    # zr, zi, rlap, kx, ky, tw, wr, wi, n, hny, first, count, tile_c,
    # cluster_k, threads, smem, device, stream
    "xfb_ka_quad": [_P] * 8 + [_I] * 9 + [_P],
    # fr, fi, lap, mask, zsr, zsi, z0r, z0i, r1r, r1i, r2r, r2i, r3r, r3i,
    # tw, nr, ni, nfields, nx, hny, nu, c, tile_c, cluster_k, threads,
    # smem, device, stream
    "xfb_kx_visc_tail": [_P] * 17 + [_I, _I, _I, _F, _F] + [_I] * 5 + [_P],
    # fr, fi, lap, mask, zr, zi, z0r, z0i, rr, ri, nr, ni, numel, nu, coef,
    # device, stream
    "xfb_visc": [_P] * 12 + [_L, _F, _F, _I, _P],
    # wr, wi, src, tw, outr, outi, ny, nx, scale, beta, tile_c,
    # cluster_k, threads, smem (the ops/xtile.py plan), device, stream
    "xfb_kb_adv_full": [_P] * 6 + [_I, _I, _F, _F] + [_I] * 5 + [_P],
    # zx, zy, wr, wi, src, tw, outr, outi, ny, nx, scale, beta, tile_c,
    # cluster_k, threads, smem, device, stream
    "xfb_kb_adv_half": [_P] * 8 + [_I, _I, _F, _F] + [_I] * 5 + [_P],
    # src table, dst table, p, rows_l, hrow, w, to_cols, device, stream
    "xfb_a2a": [_P, _P] + [_I] * 6 + [_P],
    # src table, dst table, tw, p, rows_l, hrow, w, mode, forward, scale,
    # tile_c, cluster_k, threads, smem, device, stream
    "xfb_xstage": [_P] * 3 + [_I] * 6 + [_F] + [_I] * 5 + [_P],
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


def _run_all(cmds, logs) -> list:
    """Start every command at once, each writing to its own log file;
    wait for all and return their exit codes."""
    procs = []
    for cmd, path in zip(cmds, logs):
        with open(path, "w") as out:
            procs.append(subprocess.Popen(cmd, stdout=out,
                                          stderr=subprocess.STDOUT))
    return [p.wait() for p in procs]


def build() -> Path:
    """Compile the kernels unless the library for these sources exists;
    returns its path. Raises with the compiler's output on failure."""
    out_dir = BUILD_ROOT / source_hash()
    so = out_dir / LIB_NAME
    if so.exists():
        LAST_BUILD.update(path=str(so), seconds=0.0, compiled=False)
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    # private names, then an atomic rename: concurrent first users
    # (test workers) never load a half-written library
    tag = f"{os.getpid()}.tmp"
    objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    logs = [out_dir / f"{Path(s).stem}.{tag}.log" for s in SOURCES]
    cmds = [[nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    rcs = _run_all(cmds, logs)
    if not any(rcs):
        link = [nvcc(), *ARCH, "-shared", "-o", str(tmp),
                *(str(o) for o in objs)]
        cmds.append(link)
        logs.append(out_dir / f"link.{tag}.log")
        rcs += _run_all([link], logs[-1:])
    seconds = time.perf_counter() - t0
    text = "".join(" ".join(c) + "\n" + p.read_text()
                   for c, p in zip(cmds, logs))
    (out_dir / "build.log").write_text(text)
    for p in objs + logs:
        p.unlink(missing_ok=True)
    if any(rcs):
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit codes {rcs}):\n{text}")
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
