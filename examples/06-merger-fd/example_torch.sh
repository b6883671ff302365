#!/bin/bash
# Example 06 through the PyTorch / CUDA port's commands: the Kuo2004
# merger on the finite-difference core (-m fd: Arakawa Jacobian, FFT
# Poisson solve) and on the spectral core, and the rel-L2 of their last
# recorded vorticity fields. DEVICE=cpu runs on the CPU (the default,
# cuda, needs a GPU).
set -e
cd "$(dirname "$0")"
NX=${NX:-256}; STEPS=${STEPS:-300}; REC=${REC:-100}; DEVICE=${DEVICE:-cuda}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"
python -m xlab_fftbarotropic_torch.cli.makefield kuo2004 -I input \
    --nx $NX --ny $NX
python -m xlab_fftbarotropic_torch.cli.run -m fd -I input -O output-fd \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC \
    --manifest log-fd --device $DEVICE
python -m xlab_fftbarotropic_torch.cli.run -I input -O output-spectral \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC \
    --manifest log-spectral --device $DEVICE
LAST=$(( (STEPS - 1) / REC * REC ))
python - "$LAST" <<'PY'
import sys
import numpy as np
last = int(sys.argv[1])
fd = np.fromfile(f"output-fd/vort_step_{last}.bin", "<f4")
sp = np.fromfile(f"output-spectral/vort_step_{last}.bin", "<f4")
rel = np.linalg.norm(fd - sp) / np.linalg.norm(sp)
print(f"# FD vs spectral vorticity at step {last}: rel-L2 = {rel:.3e} "
      f"(the O(dx^2) difference of the two discretizations)")
PY
