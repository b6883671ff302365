#!/bin/bash
# invert.sh through the PyTorch / CUDA port's commands: psi records ->
# pressure fields -> minima time series. DEVICE=cpu runs on the CPU.
set -e
cd "$(dirname "$0")"
NX=${NX:-256}; DEVICE=${DEVICE:-cuda}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"
grep psi_step log | sed 's/psi/pres/' | paste -d'@' <(grep psi_step log) - | sed 's/@/=>/' \
    | python -m xlab_fftbarotropic_torch.cli.invert_pres --nx $NX --ny $NX \
        --device $DEVICE
ls -v output | grep pres_step | awk '{print "output/" $1}' \
    | python -m xlab_fftbarotropic_torch.cli.find_min --nx $NX --ny $NX \
        --device $DEVICE > output/pres_timeseries.txt
echo "pressure minima time series -> output/pres_timeseries.txt"
