"""`xfb-torch-makefield` — the initial-condition generator of the PyTorch /
CUDA port, the counterpart of xlab_fftbarotropic_tpu.cli.makefield.

    python -m xlab_fftbarotropic_torch.cli.makefield kuo2004 -I input \
        --nx 4096 --ny 4096

One command for the reference's four makefield-*.out executables
(makefield-{gaussian,const-vortex,elliptic-vortex,Kuo2004}.cpp): writes
input_dir/init_file as raw float32, byte-compatible with the reference's
writeField output and byte-identical to the JAX package's command (the
port's own ic/makefields.py and io/fieldio.py, numpy only).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None):
    from ..config import add_config_args, config_from_args
    from ..ic.makefields import GENERATORS, make
    from ..io.fieldio import write_field

    p = argparse.ArgumentParser(prog="xfb-torch-makefield")
    p.add_argument("name", choices=sorted(GENERATORS),
                   help="which initial condition to generate")
    add_config_args(p)
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    field = make(args.name, cfg)
    out = Path(cfg.input_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / cfg.init_file
    write_field(path, field)
    print(f"Output {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
