#!/bin/bash
# Example 07 through the PyTorch / CUDA port's commands: an M-member
# perturbed-IC Kuo2004 ensemble (xfb-torch-run --ensemble M; member 0
# the control, each member's records in output/mNN/), the pressure
# minima track of each member (xfb-torch-invert-pres, xfb-torch-find-min)
# and their spread (spread.py, numpy only). DEVICE=cpu runs on the CPU
# (the default, cuda, needs a GPU).
set -e
cd "$(dirname "$0")"
NX=${NX:-128}; STEPS=${STEPS:-300}; REC=${REC:-100}; M=${M:-4}
DEVICE=${DEVICE:-cuda}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"
python -m xlab_fftbarotropic_torch.cli.makefield kuo2004 -I input \
    --nx $NX --ny $NX
python -m xlab_fftbarotropic_torch.cli.run -I input -O output \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC \
    --ensemble $M --ensemble-amp 0.02 --ensemble-seed 7 --device $DEVICE
for d in output/m*/; do
    m=$(basename "$d")
    grep "$m/psi_step" log | sed 's/psi/pres/' \
        | paste -d'@' <(grep "$m/psi_step" log) - | sed 's/@/=>/' \
        | python -m xlab_fftbarotropic_torch.cli.invert_pres --nx $NX \
            --ny $NX --device $DEVICE
    ls -v "$d" | grep pres_step | awk -v d="$d" '{print d $1}' \
        | python -m xlab_fftbarotropic_torch.cli.find_min --nx $NX \
            --ny $NX -n 1 --device $DEVICE > "$d/pres_timeseries.txt"
done
python ./spread.py output > output/ensemble_spread.txt
cat output/ensemble_spread.txt
