#!/bin/bash
# Example 03 through the PyTorch / CUDA port's commands: a gaussian
# tracer blob stirred by the Kuo2004 vortex pair (xfb-torch-run -m
# tracer), then the Nakamura effective-diffusivity profile of every
# recorded tracer field and the E(k)/Z(k) spectra of the flow
# (xfb-torch-diagnose). DEVICE=cpu runs on the CPU (the default, cuda,
# needs a GPU).
set -e
cd "$(dirname "$0")"
NX=${NX:-128}; STEPS=${STEPS:-300}; REC=${REC:-100}; DEVICE=${DEVICE:-cuda}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"

python -m xlab_fftbarotropic_torch.cli.makefield kuo2004 -I input \
    --nx $NX --ny $NX
python -m xlab_fftbarotropic_torch.cli.run -m tracer --tracer-ic gaussian \
    --tracer-kappa 0 -I input -O output \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC \
    --device $DEVICE

# Nakamura kappa_eff/kappa profiles of the ADVECTED TRACER records
ls -v output | grep '^q_step' | awk '{print "output/" $1}' | \
    python -m xlab_fftbarotropic_torch.cli.diagnose --nx $NX --ny $NX \
        -O output -d eddy-diffusivity --device $DEVICE

# energy/enstrophy spectra of the flow at the same record steps
ls -v output | grep '^vort_step' | awk '{print "output/" $1}' | \
    python -m xlab_fftbarotropic_torch.cli.diagnose --nx $NX --ny $NX \
        -O output -d spectrum --device $DEVICE
