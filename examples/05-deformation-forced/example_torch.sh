#!/bin/bash
# Example 05 through the PyTorch / CUDA port's commands: the
# elliptic-vortex IC forced through the FIFO protocol, then the
# deformation factor of every recorded state (xfb-torch-diagnose).
# DEVICE=cpu runs on the CPU (the default, cuda, needs a GPU).
set -e
cd "$(dirname "$0")"
NX=${NX:-256}; STEPS=${STEPS:-300}; REC=${REC:-100}; DEVICE=${DEVICE:-cuda}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"
python -m xlab_fftbarotropic_torch.cli.makefield elliptic-vortex -I input \
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
ls -v output | grep '^vort_step' | awk '{print "output/" $1}' | \
    python -m xlab_fftbarotropic_torch.cli.diagnose --nx $NX --ny $NX \
        -O output -d deformation --device $DEVICE
