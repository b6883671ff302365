#!/bin/bash
# Example 04 through the PyTorch / CUDA port's commands: the
# const-vortex run, then the filamentation time, Okubo-Weiss and the
# effective eddy diffusivity of every recorded vorticity field
# (xfb-torch-diagnose). DEVICE=cpu runs on the CPU (the default, cuda,
# needs a GPU).
set -e
cd "$(dirname "$0")"
NX=${NX:-256}; STEPS=${STEPS:-300}; REC=${REC:-100}; DEVICE=${DEVICE:-cuda}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"
python -m xlab_fftbarotropic_torch.cli.makefield const-vortex -I input \
    --nx $NX --ny $NX
python -m xlab_fftbarotropic_torch.cli.run -I input -O output \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC \
    --device $DEVICE
ls -v output | grep '^vort_step' | awk '{print "output/" $1}' | \
    python -m xlab_fftbarotropic_torch.cli.diagnose --nx $NX --ny $NX \
        -O output -d filamentation -d okubo-weiss -d eddy-diffusivity \
        --device $DEVICE
