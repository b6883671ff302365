#!/bin/bash
# Example 08 through the PyTorch / CUDA port: the 4DVar twin experiment
# on the port's differentiable rollout; see example_torch.py. DEVICE=cpu
# runs on the CPU (the default, cuda, needs a GPU); NX, STEPS and ITERS
# size it.
set -e
cd "$(dirname "$0")"
DEVICE=${DEVICE:-cuda} python ./example_torch.py
