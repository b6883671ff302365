#!/bin/bash
# Example 02 (the reference's test/02-test_invert_pressure/example.sh)
# through the PyTorch / CUDA port's commands: Kuo2004 merger IC,
# FIFO-forced run, pressure inversion, minima tracking. DEVICE=cpu runs
# the kernels' plain torch versions on the CPU (the default, cuda, needs
# a GPU).
set -e
cd "$(dirname "$0")"
NX=${NX:-256}; STEPS=${STEPS:-300}; REC=${REC:-100}; DEVICE=${DEVICE:-cuda}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"
python -m xlab_fftbarotropic_torch.cli.makefield kuo2004 -I input \
    --nx $NX --ny $NX
rm -f vort_src_fifo; mkfifo vort_src_fifo
python -m xlab_fftbarotropic_torch.cli.vort_src_input \
    --nx $NX --ny $NX --total-steps $STEPS > vort_src_fifo &
PROD=$!
# a producer still blocked on the FIFO goes with the script
trap 'kill $PROD 2>/dev/null || true' EXIT
python -m xlab_fftbarotropic_torch.cli.run -I input -O output \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC \
    -f vort_src_fifo --device $DEVICE
wait $PROD
NX=$NX DEVICE=$DEVICE ./invert_torch.sh
