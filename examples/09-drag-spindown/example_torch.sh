#!/bin/bash
# Example 09 through the PyTorch / CUDA port's commands: twin Kuo2004
# merger runs with and without Ekman drag (--r-drag), then the measured
# spin-down against the analytic e^{-r t} envelope (numpy only; see
# example.sh for what the ratio shows). DEVICE=cpu runs on the CPU (the
# default, cuda, needs a GPU).
set -e
cd "$(dirname "$0")"
NX=${NX:-128}; STEPS=${STEPS:-600}; REC=${REC:-100}; R=${R:-2e-4}
DEVICE=${DEVICE:-cuda}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"

mkdir -p out_free out_drag
python -m xlab_fftbarotropic_torch.cli.makefield kuo2004 -I input \
    --nx $NX --ny $NX
python -m xlab_fftbarotropic_torch.cli.run -I input -O out_free \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC \
    --manifest out_free/log --device $DEVICE
python -m xlab_fftbarotropic_torch.cli.run -I input -O out_drag \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC \
    --r-drag $R --manifest out_drag/log --device $DEVICE

python - "$NX" "$STEPS" "$REC" "$R" <<'PY'
import sys
import numpy as np

nx, steps, rec, r = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), \
    float(sys.argv[4])
dt = 3.0
shape = (nx, nx)


def maxz(d, s):
    a = np.fromfile(f"{d}/vort_step_{s}.bin", "<f4").reshape(shape)
    return float(np.abs(a).max())


print(f"# step   max|z| free   max|z| drag    ratio    exp(-r t)")
for s in range(0, steps, rec):
    f, g = maxz("out_free", s), maxz("out_drag", s)
    print(f"{s:6d}   {f:11.5g}   {g:11.5g}   {g / f:7.4f}   "
          f"{np.exp(-r * s * dt):9.4f}")
PY
