"""`xfb-torch-vort-src-input` — the forcing stream producer of the PyTorch
/ CUDA port, the counterpart of xlab_fftbarotropic_tpu.cli.vort_src_input.

    mkfifo vort_src_fifo
    python -m xlab_fftbarotropic_torch.cli.vort_src_input --nx 256 \
        --ny 256 --total-steps 300 > vort_src_fifo &
    python -m xlab_fftbarotropic_torch.cli.run ... -f vort_src_fifo

Writes the per-step flag-byte protocol on stdout (forcing/source.py
write_step), for `xfb-torch-run -f` to read: the reference's
vort_src_input.out scenario, a Kuo2004 cake source pulse over [2 h, 5 h]
(vort_src_input.cpp:35-61). Numpy only; the stream is byte-identical to
the JAX package's command.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from ..config import add_config_args, config_from_args
    from ..forcing.source import kuo2004_pulse_stream, write_step

    p = argparse.ArgumentParser(prog="xfb-torch-vort-src-input")
    add_config_args(p)
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    out = sys.stdout.buffer
    for field in kuo2004_pulse_stream(cfg):
        write_step(out, field)
    print("###### input program ends ######", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
