#!/usr/bin/env python
"""4DVar-style initial-condition estimation through the PyTorch / CUDA
port (example.py's twin experiment on xlab_fftbarotropic_torch/
adjoint.py).

Integrate a "truth" gaussian vortex N steps to produce the observation
(the final vorticity field), corrupt the truth into a first guess (wrong
amplitude + a displaced spurious vortex), then recover the IC by Adam
descent on the final-state misfit, the gradients from backpropagation
through the checkpointed RK4 rollout (on the card: the per-transform
kernels ka, kb, kc in both sweeps).

Environment: NX (64), STEPS (20), ITERS (150), DEVICE (cuda; cpu runs
the kernels' plain torch versions). Writes output/: loss_history.txt,
truth/guess/recovered .bin fields (reference raw-float32 layout) and,
with matplotlib, a 4-panel PNG.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402


def main():
    import torch

    from xlab_fftbarotropic_torch import adjoint
    from xlab_fftbarotropic_torch.config import ModelConfig
    from xlab_fftbarotropic_torch.ic.makefields import gaussian
    from xlab_fftbarotropic_torch.io.fieldio import write_field

    nx = int(os.environ.get("NX", "64"))
    n_steps = int(os.environ.get("STEPS", "20"))
    iters = int(os.environ.get("ITERS", "150"))
    device = os.environ.get("DEVICE", "cuda")
    cfg = ModelConfig(nx=nx, ny=nx, lx=600_000.0, ly=600_000.0,
                      dt=3.0, nu=6.5)

    truth = torch.as_tensor(0.1 * gaussian(cfg), device=device)  # 1e-4
    src = torch.zeros(cfg.grid_shape, dtype=torch.float32, device=device)
    with torch.no_grad():
        target = adjoint.make_rollout(cfg, n_steps, device=device)(truth,
                                                                   src)

    # corrupted first guess: damped truth + a spurious displaced vortex
    t = truth.cpu().numpy()
    guess = 0.5 * t + np.roll(0.3 * t, (nx // 4, nx // 4), (0, 1))

    ic_opt, losses = adjoint.fit_initial_condition(
        cfg, target, n_steps, guess, iters=iters, learning_rate=2e-6,
        device=device)
    ic_opt = ic_opt.cpu().numpy()

    os.makedirs("output", exist_ok=True)
    np.savetxt("output/loss_history.txt", losses)
    for name, f in [("truth", t), ("guess", guess), ("recovered", ic_opt)]:
        write_field(f"output/vort_{name}.bin", np.asarray(f, np.float32))

    e0 = float(np.linalg.norm(guess - t))
    e1 = float(np.linalg.norm(ic_opt - t))
    print(f"misfit J: {losses[0]:.3e} -> {losses[-1]:.3e} "
          f"({losses[0] / max(losses[-1], 1e-300):.0f}x down)")
    print(f"IC error |dzeta|_2: {e0:.3e} -> {e1:.3e} "
          f"({e0 / max(e1, 1e-300):.1f}x down)")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as e:   # matplotlib optional, like viz/
        print(f"(skipping figure: {e})")
        return

    fig, axes = plt.subplots(2, 2, figsize=(9, 8))
    fields = [("truth IC", t), ("first guess", guess),
              ("recovered IC", ic_opt)]
    vmax = float(np.max(np.abs(t)))
    for ax, (title, f) in zip(axes.flat, fields):
        im = ax.imshow(f.T, origin="lower", cmap="RdBu_r",
                       vmin=-vmax, vmax=vmax)
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=0.8)
    ax = axes.flat[3]
    ax.semilogy(losses)
    ax.set_title("misfit J (adam)")
    ax.set_xlabel("iteration")
    fig.tight_layout()
    fig.savefig("output/adjoint_4dvar.png", dpi=100)
    print("figure -> output/adjoint_4dvar.png")


if __name__ == "__main__":
    main()
