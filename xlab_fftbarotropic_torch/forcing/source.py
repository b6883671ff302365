"""Vorticity-source forcing streams: the port's own copy of
xlab_fftbarotropic_tpu/forcing/source.py.

Equivalent of the reference's VORT_SRC_READER subsystem
(the reference's src/vorticity_source.cpp) and the co-process producer
(the reference's src/vort_src_input.cpp). Three recipe modes, matching
enum RECIPE_TYPE {SCRIPT, FIFO, EMPTY} (vorticity_source.cpp:11):

* EMPTY  — no forcing; read() is a no-op (vorticity_source.cpp:73-75).
* FIFO   — per-step wire protocol (vorticity_source.cpp:112-133): one flag
  byte per model step; flag==1 is followed by nx*ny little-endian float32s
  (a whole new source field), flag==0 means keep the previous field. A
  missing flag byte (producer ended/underrun) is treated as flag=0, matching
  the reference's fallback (vorticity_source.cpp:116-119).
* SCRIPT — the mode the reference documents but left as a stub that only
  opens the file (vorticity_source.cpp:13-21, 100-110; doc/index.md:17 marks
  -s TODO). Implemented here per the documented format: lines of
  "[time] [binary filename]", '#' comments stripped; when the model time
  reaches a recipe's time, its field file is loaded as the new source.

Device interaction: the source field changes at most once per step, so the
reader returns (changed, np.ndarray); the run loop uploads to device only on
change, keeping the hot path free of host transfers (SURVEY.md hard-part 4).

Only the reading side is copied: the producer (the flag-byte writer and
the Kuo2004 pulse scenario) stays in the JAX package, which speaks the
same protocol.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..config import ModelConfig
from ..io.fieldio import read_field


class SourceReader:
    """Base: EMPTY recipe. read(time) -> (changed, field|None)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def read(self, time: float) -> Tuple[bool, Optional[np.ndarray]]:
        return False, None

    def close(self) -> None:
        pass


class FifoSourceReader(SourceReader):
    """FIFO wire protocol reader (vorticity_source.cpp:112-133).

    Blocks on the pipe exactly like the reference's fread — the producer
    self-clocks by writing one flag per step (vort_src_input.cpp:43-61).
    """

    # buffered by default; ThreadedFifoReader needs raw fd semantics so
    # close() from the model thread cannot deadlock on the buffer lock
    _BUFFERING = -1

    def __init__(self, cfg: ModelConfig, path):
        super().__init__(cfg)
        # opening a FIFO for reading blocks until a writer connects,
        # same as the reference's fopen(..., "rb") (vorticity_source.cpp:89)
        self._fd = open(path, "rb", buffering=self._BUFFERING)

    def read(self, time: float) -> Tuple[bool, Optional[np.ndarray]]:
        flag = self._fd.read(1)
        if len(flag) != 1:
            # reference: "No flag was detected, assume flag = 0"
            return False, None
        if flag[0] == 1:
            n = self.cfg.grids
            buf = self._read_exact(4 * n)
            field = np.frombuffer(buf, dtype="<f4", count=n).reshape(
                self.cfg.grid_shape)
            return True, field
        return False, None

    def _read_exact(self, nbytes: int) -> bytes:
        chunks = []
        remaining = nbytes
        while remaining > 0:
            c = self._fd.read(remaining)
            if not c:
                raise IOError("FIFO closed mid-field: cannot read "
                              "vorticity source input")
            chunks.append(c)
            remaining -= len(c)
        return b"".join(chunks)

    def close(self) -> None:
        self._fd.close()


class ThreadedFifoReader(FifoSourceReader):
    """Pure-Python fallback with the native reader's one-step-lookahead
    prefetch (native/vort_src.cpp contract): while the device integrates
    step k, a daemon thread already blocks on step k+1's flag byte, so
    pipe I/O overlaps device compute even without the C++ backend
    (VORT_SRC overlap promise in runner.py — previously only true with
    the native reader).

    One-slot handoff (queue maxsize=1) bounds the lookahead to exactly
    one protocol step, matching the native reader and the reference
    producer's per-step self-clocking (vort_src_input.cpp:43-61).
    Unbuffered raw I/O so close() never contends on a buffer lock with a
    thread mid-read; a thread left blocked in read(2) is daemonized and
    dies with the process (same as the native reader's detached exit).
    """

    _BUFFERING = 0

    def __init__(self, cfg: ModelConfig, path):
        super().__init__(cfg, path)
        import queue
        import threading
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name="xfb-fifo-prefetch", daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop:
            try:
                item = FifoSourceReader.read(self, 0.0)
            except Exception as exc:      # surfaced at the next consume
                self._q.put(exc)
                return
            self._q.put(item)

    def read(self, time: float) -> Tuple[bool, Optional[np.ndarray]]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop = True
        # free a producer blocked on the full slot so it can observe _stop
        try:
            self._q.get_nowait()
        except Exception:
            pass
        super().close()


class ScriptSourceReader(SourceReader):
    """Script recipe (format documented at vorticity_source.cpp:13-21,
    implemented here — the reference's readScript is a stub).

    Each line: "<time> <binary filename>"; comments start with '#'.
    At the first read() whose model time >= recipe time, the file is loaded
    (raw float32, grid layout) and returned as the new source field.
    """

    def __init__(self, cfg: ModelConfig, path):
        super().__init__(cfg)
        self.recipes = []
        base = Path(path).parent
        for raw in Path(path).read_text().splitlines():
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split(None, 1)
            if len(parts) != 2:
                raise ValueError(f"bad recipe line in {path}: {raw!r}")
            t, fname = float(parts[0]), parts[1].strip()
            fpath = Path(fname)
            if not fpath.is_absolute():
                fpath = base / fpath
            self.recipes.append((t, fpath))
        self.recipes.sort(key=lambda r: r[0])
        self._next = 0

    def read(self, time: float) -> Tuple[bool, Optional[np.ndarray]]:
        changed = False
        field = None
        while self._next < len(self.recipes) and \
                self.recipes[self._next][0] <= time:
            field = read_field(self.recipes[self._next][1],
                               self.cfg.grid_shape)
            changed = True
            self._next += 1
        return changed, field


def make_reader(cfg: ModelConfig, recipe: str = "empty",
                path=None) -> SourceReader:
    """Factory mirroring vs_reader.init (vorticity_source.cpp:82-96) and the
    -s/-f command-line flags (main-shallow-water.cpp:86-93).

    FIFO mode prefers the native C++ prefetch-thread reader
    (native/vort_src.cpp via io.native_stream) which overlaps the pipe read
    with device compute; the pure-Python reader is the fallback.
    """
    if recipe == "empty":
        return SourceReader(cfg)
    if recipe == "fifo":
        from ..io import native_stream
        if native_stream.available():
            return native_stream.NativeFifoReader(path, cfg.grid_shape)
        return ThreadedFifoReader(cfg, path)
    if recipe == "script":
        return ScriptSourceReader(cfg, path)
    raise ValueError(f"unknown recipe type {recipe!r}")

