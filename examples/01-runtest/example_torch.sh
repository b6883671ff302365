#!/bin/bash
# Example 01 (the reference's test/01-runtest/example.sh + draw.sh)
# through the PyTorch / CUDA port's commands: makefield -> model run ->
# figures. DEVICE=cpu runs the kernels' plain torch versions on the CPU
# (the default, cuda, needs a GPU); drawing needs matplotlib.
set -e
cd "$(dirname "$0")"
NX=${NX:-256}; STEPS=${STEPS:-300}; REC=${REC:-100}; DEVICE=${DEVICE:-cuda}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"
python -m xlab_fftbarotropic_torch.cli.makefield gaussian -I input \
    --nx $NX --ny $NX
python -m xlab_fftbarotropic_torch.cli.run -I input -O output \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC \
    --device $DEVICE
python -m xlab_fftbarotropic_torch.cli.draw -O output --fig-dir output_fig \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC
