"""The exchange buffers of the one-process-per-card executor: the pointer
tables through which the a2a and xstage kernels (TPU rows 21-23,
csrc/a2a.cu, csrc/xstage.cu) reach every rank's shard.

A model on a distributed shard group (parallel/model.py ShardGroup with a
rank) makes one Exchange at build: for each transpose shape (the row
shards (rows_l, hny) and the column shards (nx, w) of the half spectrum)
a source and a destination buffer on every rank, complex64 with a
leading shard axis of 1, each rank's mapped into every other rank:

  on the card  cudaMalloc'd buffers mapped by CUDA IPC (csrc/ipc.cu,
               cudaIpcOpenMemHandle with lazy peer access; the handles
               travel by dist.all_gather_object), whether the ranks share
               one card or hold one each;
  on the CPU   named files under /dev/shm (SHM_DIR), which every rank
               maps (torch.from_file(..., shared=True)); each rank unlinks
               its own as soon as every rank has mapped them, so nothing
               outlives the processes.

`views(name, role)` is the table of every rank's buffer as tensors (the
kernels take their data pointers; the plain versions read and write
them), and one exchange runs the protocol of the kernels' headers:

  put     the rank writes its source buffer, syncs its stream, barrier;
          (the rank launches only its own blocks, or runs their plain
          version)
  take    the rank syncs its stream, barrier, and copies its destination
          out, so no source is written again before every rank is done.

The barrier is a host barrier in shared memory: each rank bumps its own
slot of a /dev/shm flag array and waits until every slot has caught up.
Ranks with peer-mapped buffers share a host, so the flags are as far as
the buffers reach. `stats` counts the barriers and the host seconds spent
in them. A device-side barrier in mapped signal words is not used: with
ranks sharing one card without MPS, a spinning kernel would wait on a
peer that cannot be scheduled. On the card the buffers live until
`close` (a collective: the peers unmap before the owner frees) or the
process ends.
"""

from __future__ import annotations

import ctypes
import os
import time
import uuid
from pathlib import Path
from typing import Dict, Tuple

import torch
import torch.distributed as dist

ROLES = ("src", "dst")
# a host barrier that waits this long has lost a rank
BARRIER_TIMEOUT_S = 600.0


# where the CPU's exchange buffers and every host barrier's flags live
SHM_DIR = Path("/dev/shm")


class _CudaArray:
    """A cudaMalloc'd or IPC-mapped buffer as __cuda_array_interface__, so
    torch.as_tensor wraps it without a copy."""

    def __init__(self, ptr: int, shape: tuple):
        self.__cuda_array_interface__ = {
            "shape": tuple(shape) + (2,), "typestr": "<f4",
            "data": (ptr, False), "version": 3, "strides": None}


def _check_rc(what: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"peer: {what} failed: {torch.cuda.CudaError(rc)}")


class Exchange:
    """The exchange buffers of one distributed shard group (module note).
    `shapes`: name -> (rows, cols) of the complex64 buffers, each
    allocated with a leading shard axis of 1 as a source and a
    destination on every rank. A collective: every rank builds it with the
    same shapes in the same order."""

    def __init__(self, group, shapes: Dict[str, Tuple[int, int]]):
        if group.rank is None:
            raise ValueError("peer.Exchange needs a distributed shard group "
                             "(make_mesh on an initialized runtime)")
        self.rank, self.n = group.rank, group.n_shards
        self.device = group.device
        self.pg = group.process_group
        self.shapes = dict(shapes)
        self.stats = {"barriers": 0, "barrier_s": 0.0}
        self._epoch = 0
        self._files: list = []
        self._opened: list = []
        self._owned: list = []
        names = [None]
        if self.rank == 0:
            names[0] = f"xfb-{os.getpid()}-{uuid.uuid4().hex[:12]}"
        dist.broadcast_object_list(names, src=self._global(0),
                                   group=self.pg)
        self.tag = names[0]
        self._tables = {}
        if self.device.type == "cuda":
            self._map_cuda()
        else:
            self._map_shm()
        self._flags = self._map_flags()
        dist.barrier(group=self.pg)
        # every rank has mapped every file: the names can go
        for path in self._files:
            path.unlink(missing_ok=True)
        self._files = []

    def _global(self, r: int) -> int:
        return (r if self.pg is None else
                dist.get_global_rank(self.pg, r))

    # ----- the buffers -----

    def _keys(self):
        return [(name, role) for name in self.shapes for role in ROLES]

    def _path(self, r: int, what: str) -> Path:
        return SHM_DIR / f"{self.tag}-{r}-{what}"

    def _from_file(self, path: Path, numel: int, dtype) -> torch.Tensor:
        return torch.from_file(str(path), shared=True, size=numel,
                               dtype=dtype)

    def _map_shm(self) -> None:
        sizes = {k: 2 * self.shapes[k[0]][0] * self.shapes[k[0]][1]
                 for k in self._keys()}
        for key in self._keys():
            path = self._path(self.rank, "-".join(key))
            self._files.append(path)
            self._from_file(path, sizes[key], torch.float32).zero_()
        dist.barrier(group=self.pg)
        for key in self._keys():
            rows, cols = self.shapes[key[0]]
            self._tables[key] = [
                torch.view_as_complex(self._from_file(
                    self._path(r, "-".join(key)), sizes[key],
                    torch.float32).view(1, rows, cols, 2))
                for r in range(self.n)]

    def _map_cuda(self) -> None:
        from ..ops._build import lib

        dev = self.device.index
        mine = {}
        handles = {}
        for key in self._keys():
            rows, cols = self.shapes[key[0]]
            ptr = ctypes.c_void_p()
            _check_rc("cudaMalloc", lib().xfb_ipc_alloc(
                8 * rows * cols, dev, ctypes.byref(ptr)))
            self._owned.append(ptr.value)
            handle = ctypes.create_string_buffer(64)
            _check_rc("cudaIpcGetMemHandle",
                      lib().xfb_ipc_handle(ptr.value, handle))
            mine[key] = ptr.value
            handles[key] = handle.raw
        every = [None] * self.n
        dist.all_gather_object(every, handles, group=self.pg)
        for key in self._keys():
            rows, cols = self.shapes[key[0]]
            table = []
            for r in range(self.n):
                if r == self.rank:
                    ptr = mine[key]
                else:
                    out = ctypes.c_void_p()
                    _check_rc(f"cudaIpcOpenMemHandle of rank {r}",
                              lib().xfb_ipc_open(every[r][key], dev,
                                                 ctypes.byref(out)))
                    ptr = out.value
                    self._opened.append(ptr)
                table.append(torch.view_as_complex(torch.as_tensor(
                    _CudaArray(ptr, (1, rows, cols)))))
            if any(t.device != self.device for t in table):
                raise RuntimeError(f"peer: a mapped buffer is not on "
                                   f"{self.device}")
            self._tables[key] = table

    def _map_flags(self):
        """The barrier's flag array: one int64 slot per rank, 64 bytes
        apart, made by rank 0 and mapped by every rank."""
        path = self._path(0, "flags")
        if self.rank == 0:
            self._files.append(path)
            self._from_file(path, 8 * self.n, torch.int64).zero_()
        dist.barrier(group=self.pg)
        return self._from_file(path, 8 * self.n, torch.int64).numpy()[::8]

    def views(self, name: str, role: str) -> list:
        """Every rank's `role` buffer of shape `name`, (1, rows, cols)
        complex64, in rank order: the pointer table."""
        return self._tables[(name, role)]

    def own(self, name: str, role: str) -> torch.Tensor:
        return self._tables[(name, role)][self.rank]

    # ----- the protocol -----

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def barrier(self) -> None:
        """Every rank of the group arrives before any leaves."""
        t0 = time.perf_counter()
        self._epoch += 1
        flags, epoch = self._flags, self._epoch
        flags[self.rank] = epoch
        spins = 0
        while flags.min() < epoch:
            spins += 1
            if spins < 2000:
                os.sched_yield()
            else:
                time.sleep(5e-5)
                if time.perf_counter() - t0 > BARRIER_TIMEOUT_S:
                    raise RuntimeError(
                        f"peer: rank {self.rank} waited "
                        f"{BARRIER_TIMEOUT_S:.0f} s at barrier {epoch} "
                        f"(flags {flags.tolist()}): a rank is lost")
        self.stats["barriers"] += 1
        self.stats["barrier_s"] += time.perf_counter() - t0

    def put(self, name: str, x: torch.Tensor) -> None:
        """Write x into this rank's source buffer `name`, then sync and
        barrier: every rank's sources are complete."""
        self.own(name, "src").copy_(x)
        self._sync()
        self.barrier()

    def take(self, name: str) -> torch.Tensor:
        """Sync and barrier (every rank's blocks are done), then a copy of
        this rank's destination buffer `name`."""
        self._sync()
        self.barrier()
        return self.own(name, "dst").clone()

    def close(self) -> None:
        """Unmap the peers' buffers and free this rank's (a collective)."""
        if self.device.type == "cuda" and (self._opened or self._owned):
            from ..ops._build import lib

            self._sync()
            dist.barrier(group=self.pg)
            self._tables = {}
            for ptr in self._opened:
                lib().xfb_ipc_close(ptr)
            dist.barrier(group=self.pg)
            for ptr in self._owned:
                lib().xfb_ipc_free(ptr, self.device.index)
            self._opened, self._owned = [], []
