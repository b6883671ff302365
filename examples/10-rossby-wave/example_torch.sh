#!/bin/bash
# Example 10 through the PyTorch / CUDA port's commands: a single zonal
# vorticity mode under --beta, an exact nonlinear solution that must
# travel westward at c = -beta/k1^2 while decaying at nu k1^2; measured
# against analytic phase and amplitude at every record step (numpy
# only). DEVICE=cpu runs on the CPU (the default, cuda, needs a GPU).
set -e
cd "$(dirname "$0")"
NX=${NX:-128}; STEPS=${STEPS:-600}; REC=${REC:-100}; BETA=${BETA:-1e-8}
DEVICE=${DEVICE:-cuda}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"

mkdir -p input out
python - "$NX" <<'PY'
import sys
import numpy as np
nx = int(sys.argv[1])
lx = 600_000.0
x = np.arange(nx, dtype=np.float32) * np.float32(lx / nx)
z = (1e-3 * np.sin(2 * np.pi * x / lx)[:, None]
     * np.ones((1, nx))).astype("<f4")
z.tofile("input/initial_vorticity.bin")
PY
python -m xlab_fftbarotropic_torch.cli.run -I input -O out \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC \
    --beta $BETA --manifest out/log --device $DEVICE

python - "$NX" "$STEPS" "$REC" "$BETA" <<'PY'
import sys
import numpy as np

nx, steps, rec = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
beta = float(sys.argv[4])
lx, dt, nu = 600_000.0, 3.0, 6.5
k1 = 2 * np.pi / lx
omega = -beta / k1          # dispersion: westward for beta > 0

print("# step   phase(measured)  phase(-omega t)   amp ratio   "
      "exp(-nu k1^2 t)")
for s in range(0, steps, rec):
    z = np.fromfile(f"out/vort_step_{s}.bin", "<f4").reshape(nx, nx)
    prof = z.mean(axis=1)
    c = np.fft.rfft(prof)[1]
    # IC is A sin(k1 x) => coefficient -i A nx/2; the mode's phase
    # advance is arg(c / c0)
    phase = float(np.angle(c * 1j))      # 0 at t=0
    amp = float(2 * np.abs(c) / nx / 1e-3)
    print(f"{s:6d}   {phase:15.5f}  {-omega * s * dt:15.5f}   "
          f"{amp:9.5f}   {np.exp(-nu * k1 * k1 * s * dt):11.5f}")
PY
