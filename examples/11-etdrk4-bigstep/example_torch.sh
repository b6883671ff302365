#!/bin/bash
# Example 11 through the PyTorch / CUDA port's commands: rotating shallow
# water under ETDRK4 (--time-scheme etdrk4) at 4.5x the RK4
# gravity-wave bound against RK4 at 0.9x it over the same simulated
# horizon, then the recorded height and vorticity fields and the mass
# compared; a third run shows RK4 at the big dt blowing up (the NaN
# guard). The bound is the port's models/shallow_water.py max_stable_dt.
# DEVICE=cpu runs on the CPU (the default, cuda, needs a GPU).
set -e
cd "$(dirname "$0")"
NX=${NX:-128}; REC=${REC:-40}; DEVICE=${DEVICE:-cuda}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"

python -m xlab_fftbarotropic_torch.cli.makefield gaussian -I input \
    --nx $NX --ny $NX

python - "$NX" <<'PY' > dt.txt
import sys
sys.path.insert(0, "../..")
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.models.shallow_water import max_stable_dt
nx = int(sys.argv[1])
dtg = max_stable_dt(ModelConfig(nx=nx, ny=nx))
print(f"{0.9 * dtg:.6f} {4.5 * dtg:.6f}")
PY
read DT_RK DT_ETD < dt.txt
STEPS_RK=$((REC * 5)); STEPS_ETD=$REC

mkdir -p out_rk4 out_etd
# reference record semantics: records happen at the TOP of a step
# (main.cpp loop), so total-steps must exceed the last record point
python -m xlab_fftbarotropic_torch.cli.run -I input -O out_rk4 -m sw \
    --nx $NX --ny $NX --dt $DT_RK --total-steps $((STEPS_RK + 1)) \
    --record-step $STEPS_RK --manifest out_rk4/log --device $DEVICE
python -m xlab_fftbarotropic_torch.cli.run -I input -O out_etd -m sw \
    --nx $NX --ny $NX --dt $DT_ETD --time-scheme etdrk4 \
    --total-steps $((STEPS_ETD + 1)) --record-step $STEPS_ETD \
    --manifest out_etd/log --device $DEVICE

python - "$NX" "$STEPS_RK" "$STEPS_ETD" <<'PY'
import sys
import numpy as np

nx, n_rk, n_etd = (int(v) for v in sys.argv[1:4])
shape = (nx, nx)


def f(d, name, s):
    return np.fromfile(f"{d}/{name}_step_{s}.bin", "<f4").reshape(shape)


h_rk = f("out_rk4", "h", n_rk)
h_etd = f("out_etd", "h", n_etd)
v_rk = f("out_rk4", "vort", n_rk)
v_etd = f("out_etd", "vort", n_etd)
dh = np.linalg.norm(h_etd - h_rk) / max(
    np.linalg.norm(h_rk - h_rk.mean()), 1e-30)
dv = np.linalg.norm(v_etd - v_rk) / max(np.linalg.norm(v_rk), 1e-30)
print(f"same-horizon ETDRK4(1/5 the steps) vs RK4:")
print(f"  vorticity rel-L2 {dv:.3e}   height-anomaly rel-L2 {dh:.3e}")
print(f"  mass: RK4 {h_rk.mean():.7f}  ETDRK4 {h_etd.mean():.7f}")
# truncation class of a 4.5x-bound step on an unbalanced IC
assert dv < 2e-2 and dh < 5e-3, "trajectories diverged"
print("OK: big-step ETDRK4 matches the explicit reference-scheme run")
PY

echo "# RK4 at the ETDRK4 step size blows up (expected):"
if python -m xlab_fftbarotropic_torch.cli.run -I input -O out_rk4 -m sw \
    --nx $NX --ny $NX --dt $DT_ETD --total-steps $STEPS_ETD \
    --record-step $STEPS_ETD --manifest /dev/null --device $DEVICE 2>&1 \
    | grep -q "blow-up\|NaN\|non-finite"; then
  echo "  caught by the NaN guard, as documented"
else
  echo "  (guard output not matched — inspect manually)"
fi
