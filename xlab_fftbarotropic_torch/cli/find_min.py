"""`xfb-torch-find-min` — the field minima of the PyTorch / CUDA port, the
counterpart of xlab_fftbarotropic_tpu.cli.find_min.

    ls -v output | grep pres_step | awk '{print "output/" $1}' \
        | python -m xlab_fftbarotropic_torch.cli.find_min --nx 256 \
            --ny 256 [--tracks tracks.txt] [--device cuda|cpu]

Drop-in for find_min.out (the reference's src/find_min.cpp:67-99): reads
field filenames from stdin (one per line), prints the n (default 30)
smallest values of each as "x y value" lines (diagnostics/find_min.py,
on the device), and with --tracks associates each file's minima into
vortex tracks (diagnostics/tracks.py). The same stdout, stderr and
--tracks file as the JAX package's command. `--device cuda` (the
default) stops with an error when no GPU is visible; `--device cpu`
runs on the CPU.
"""

from __future__ import annotations

import argparse
import re
import sys


def main(argv=None):
    import torch

    from ..config import add_config_args, config_from_args
    from ..diagnostics.find_min import find_min_n, format_minima
    from ..diagnostics.tracks import build_tracks, format_tracks
    from ..io.fieldio import read_field
    from ..models.barotropic import resolve_device

    p = argparse.ArgumentParser(prog="xfb-torch-find-min")
    p.add_argument("-n", "--num", type=int, default=30,
                   help="number of minima (reference default 30)")
    p.add_argument("--tracks", default=None, metavar="FILE",
                   help="also associate each file's minima into vortex "
                        "tracks (periodic nearest-neighbor across files, "
                        "diagnostics/tracks.py) and write 'track_id step "
                        "x y value' lines to FILE; the step index is "
                        "parsed from '*_step_N.bin' filenames")
    p.add_argument("--cluster-radius", type=float, default=8.0,
                   help="grid-cell radius treated as one vortex well "
                        "when clustering a file's minima (--tracks)")
    p.add_argument("--max-jump", type=float, default=64.0,
                   help="largest per-file core displacement (grid "
                        "cells, periodic) still the same track "
                        "(--tracks)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the minima on the card, error if "
                        "no GPU is visible; cpu: on the CPU")
    add_config_args(p)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device is visible; pass --device "
                "cpu to run on the CPU")
    cfg = config_from_args(args)
    device = resolve_device(args.device)

    records = []
    print("Entering find_min program.", file=sys.stderr)
    for raw in sys.stdin:
        fname = raw.strip()
        if not fname:
            continue
        data = read_field(fname, cfg.grid_shape)
        print(f"File {fname} read.", file=sys.stderr)
        x, y, vals = find_min_n(data, args.num, device)
        print(format_minima(x, y, vals))
        if args.tracks is not None:
            m = re.search(r"_step_(\d+)\b", fname)
            step = int(m.group(1)) if m else None
            records.append((step, x, y, vals))
    if args.tracks is not None:
        # Step indices come from the '_step_N' filename convention
        # (SURVEY.md §5.9 output contract). Mixing parsed steps with
        # positional fallbacks would interleave the synthetic indices
        # with real ones and corrupt the track order, so the fallback
        # applies only when no filename parses.
        n_parsed = sum(1 for r in records if r[0] is not None)
        if 0 < n_parsed < len(records):
            bad = [i for i, r in enumerate(records) if r[0] is None]
            print(f"find_min: --tracks needs a '_step_N' step index in "
                  f"every filename or in none; {len(bad)} of "
                  f"{len(records)} record(s) did not parse.",
                  file=sys.stderr)
            return 2
        if n_parsed == 0:       # stdin order defines the time axis
            records = [(i,) + r[1:] for i, r in enumerate(records)]
        records.sort(key=lambda r: r[0])
        tracks = build_tracks(records, cfg.nx, cfg.ny,
                              cluster_radius=args.cluster_radius,
                              max_jump=args.max_jump)
        with open(args.tracks, "w") as f:
            f.write(format_tracks(tracks) + "\n")
        print(f"Wrote {len(tracks)} track(s) to {args.tracks}.",
              file=sys.stderr)
    print("find_min program ends. Congrats!", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
