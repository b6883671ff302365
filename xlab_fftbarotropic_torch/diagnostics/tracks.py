"""Vortex-center tracking across record steps: the port's own copy of
xlab_fftbarotropic_tpu/diagnostics/tracks.py (numpy only, the same
tracks and lines).

The reference's minima workflow ends at a flat concatenation of per-file
minima (`find_min.out` lines piped into pres_timeseries.txt, the
reference's test/02-test_invert_pressure/example.sh:16) — every
record step contributes its 30 deepest pressure points with no identity
between steps, and the "time series" is disentangled by eye. This module
completes that workflow: it reduces each step's minima to distinct vortex
CORES (non-maximum suppression — the 30 smallest values of a deep vortex
all sit in one well) and associates cores across steps into tracks by
periodic-domain nearest neighbor, giving per-vortex (step, x, y, depth)
trajectories — the quantity the reference pipeline was built to extract
(vortex-merger position/depth evolution).

Host-side numpy on O(30)-point sets per step: there is no device work
worth dispatching here; the heavy part (top-k over the field) already ran
in diagnostics/find_min.py.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


def periodic_delta(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """Signed minimal displacement a-b on a ring of n points."""
    d = (np.asarray(a, np.float64) - np.asarray(b, np.float64)) % n
    return np.where(d > n / 2, d - n, d)


def cluster_minima(x, y, vals, nx: int, ny: int,
                   radius: float) -> List[Tuple[int, int, float]]:
    """Reduce a step's minima list to distinct cores.

    Greedy non-maximum suppression in depth order: the deepest point
    opens a core; every later point within `radius` grid cells
    (periodic) of an accepted core belongs to that core's well and is
    dropped. Returns [(x, y, value), ...] deepest-first."""
    order = np.argsort(np.asarray(vals))
    xs = np.asarray(x)[order]
    ys = np.asarray(y)[order]
    vs = np.asarray(vals)[order]
    cores: List[Tuple[int, int, float]] = []
    for xi, yi, vi in zip(xs, ys, vs):
        keep = True
        for cx, cy, _ in cores:
            dx = periodic_delta(xi, cx, nx)
            dy = periodic_delta(yi, cy, ny)
            if dx * dx + dy * dy <= radius * radius:
                keep = False
                break
        if keep:
            cores.append((int(xi), int(yi), float(vi)))
    return cores


@dataclasses.dataclass
class Track:
    """One vortex trajectory: parallel per-sample lists."""

    track_id: int
    steps: List[int]
    x: List[int]
    y: List[int]
    value: List[float]

    def last(self) -> Tuple[int, int]:
        return self.x[-1], self.y[-1]


def _hungarian(cost: np.ndarray) -> np.ndarray:
    """Minimum-cost perfect matching on a square cost matrix; returns
    the column assigned to each row.

    O(n^3) shortest-augmenting-path algorithm with row/column
    potentials (Jonker-Volgenant style), numpy only; n is O(30 + 30),
    so the cost is negligible next to the device top-k that produced
    the minima."""
    n = cost.shape[0]
    INF = float("inf")
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    p = np.zeros(n + 1, dtype=int)      # p[j]: row matched to col j (1-based)
    way = np.zeros(n + 1, dtype=int)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, INF)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = INF
            j1 = 0
            for j in range(1, n + 1):
                if used[j]:
                    continue
                cur = cost[i0 - 1, j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(n + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    ans = np.zeros(n, dtype=int)
    for j in range(1, n + 1):
        ans[p[j] - 1] = j - 1
    return ans


def _match_heads(live: List[Track], cores, nx: int, ny: int,
                 max_jump: float) -> List[Tuple[int, int]]:
    """Optimal (minimum total squared displacement) assignment of live
    track heads to the new step's cores; pairs farther than max_jump
    are never matched. Returns [(track_idx, core_idx), ...].

    Padded-square formulation: every track also gets a private "die"
    column and every core a private "birth" row, each at cost SKIP just
    above max_jump^2, with the dummy-dummy block free — so any in-range
    pairing beats skipping, and among feasible pairings the matching
    maximizes matched pairs first and minimizes total displacement
    second. This is the optimal-assignment upgrade of the earlier
    greedy sorted-distance heuristic, which could strand a matchable
    (head, core) pair in crowded fields (several cores within max_jump
    of several heads) and mis-associate identities."""
    nt, nc = len(live), len(cores)
    skip = max_jump * max_jump + 1.0
    n = nt + nc
    big = 4.0 * (n + 1) * (skip + 1.0)
    cost = np.zeros((n, n))
    cost[:nt, :] = big
    cost[:, :nc] = big
    cost[nt:, nc:] = 0.0
    for i, t in enumerate(live):
        hx, hy = t.last()
        cost[i, nc + i] = skip           # track i dies
        for j, (cx, cy, _) in enumerate(cores):
            dx = periodic_delta(cx, hx, nx)
            dy = periodic_delta(cy, hy, ny)
            d2 = float(dx * dx + dy * dy)
            if d2 <= max_jump * max_jump:
                cost[i, j] = d2
    for j in range(nc):
        cost[nt + j, j] = skip           # core j starts a new track
    assign = _hungarian(cost)
    return [(i, int(assign[i])) for i in range(nt) if assign[i] < nc]


def build_tracks(records: Sequence[Tuple[int, Sequence, Sequence, Sequence]],
                 nx: int, ny: int, cluster_radius: float = 8.0,
                 max_jump: float = 64.0) -> List[Track]:
    """Associate per-step minima into tracks.

    records: iterable of (step, x_idx, y_idx, values) as produced by
    diagnostics.find_min.find_min_n per record step, in time order.
    cluster_radius: grid-cell radius of one vortex well (see
    cluster_minima). max_jump: largest per-record-step core displacement
    (grid cells, periodic) still treated as the same vortex; cores
    farther than this from every live track start a new track.

    Head-to-core association is an optimal assignment (see
    _match_heads): most matched pairs first, minimum total squared
    displacement second, so a deep new core cannot steal a closer track
    from a shallow one and crowded vortex-merger scenes keep their
    identities where any consistent labeling exists."""
    tracks: List[Track] = []
    live: List[Track] = []
    for step, xs, ys, vs in records:
        cores = cluster_minima(xs, ys, vs, nx, ny, cluster_radius)
        if not live:
            for cx, cy, cv in cores:
                t = Track(len(tracks), [step], [cx], [cy], [cv])
                tracks.append(t)
                live.append(t)
            continue
        matches = _match_heads(live, cores, nx, ny, max_jump)
        used_t = {i for i, _ in matches}
        used_c = {j for _, j in matches}
        for i, j in matches:
            cx, cy, cv = cores[j]
            live[i].steps.append(step)
            live[i].x.append(cx)
            live[i].y.append(cy)
            live[i].value.append(cv)
        next_live = [t for i, t in enumerate(live) if i in used_t]
        for j, (cx, cy, cv) in enumerate(cores):
            if j not in used_c:
                t = Track(len(tracks), [step], [cx], [cy], [cv])
                tracks.append(t)
                next_live.append(t)
        live = next_live
    return tracks


def format_tracks(tracks: Sequence[Track]) -> str:
    """One line per sample: 'track_id step x y value' (value in the
    reference's %.5e format), tracks in id order — a machine-greppable
    extension of the find_min stdout contract."""
    out = []
    for t in tracks:
        for s, x, y, v in zip(t.steps, t.x, t.y, t.value):
            out.append(f"{t.track_id} {s} {x} {y} {v:.5e}")
    return "\n".join(out)
