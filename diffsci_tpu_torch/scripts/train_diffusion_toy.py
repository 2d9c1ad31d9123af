"""Train and validate an EDM diffusion model on an analytic toy dataset.

Port of ``scripts/train_diffusion_toy.py``: trains an MLP score net on a
2D Gaussian mixture and checks the sampled distribution against the
analytic law (mode means and balance); ``main()`` returns the samples.
The mixture's draws come from a torch generator (seed 0), so they are
not the JAX script's numbers.

Usage:
    python -m diffsci_tpu_torch.scripts.train_diffusion_toy [--steps 2000]
        [--device cuda]
"""

import argparse

import numpy as np

from diffsci_tpu_torch.scripts._common import add_device_flag, host
from diffsci_tpu_torch.utils import resolve_device


def build(args, device):
    """The recipe's model, EMA tracker (None) and optimizer (None: the
    default): (model, ema, tx)."""
    from diffsci_tpu_torch.models import (KarrasModel, KarrasModelConfig,
                                          MLPUncond)
    model = KarrasModel(MLPUncond(2, [128, 128, 128], device=device),
                        KarrasModelConfig.from_edm(loss_metric="mse"),
                        device=device)
    return model, None, None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=256)
    add_device_flag(ap)
    args = ap.parse_args()

    import torch
    from diffsci_tpu_torch import data
    from diffsci_tpu_torch.models import create_train_state, make_train_step

    device = resolve_device(args.device)
    dataset = data.MixtureOfGaussiansDataset(
        num_samples=args.batch * 64,
        means=[[-2.0, 0.0], [2.0, 0.0]], weights=[0.5, 0.5], scale=0.3)
    xs = dataset.sample(torch.Generator().manual_seed(0)).to(device)

    model, _, tx = build(args, device)
    state, tx = create_train_state(model, (args.batch, 2), seed=1,
                                   optimizer=tx)
    step_fn = make_train_step(model, tx)

    gen = torch.Generator(device).manual_seed(2)
    n = xs.shape[0]
    for i in range(args.steps):
        lo = (i * args.batch) % (n - args.batch)
        state, metrics = step_fn(state, xs[lo:lo + args.batch],
                                 generator=gen)
        if i % 200 == 0:
            print(f"step {i}: loss={float(metrics['train_loss']):.4f}")

    s = host(model.sample(4096, (2,), gen, nsteps=50))
    frac_left = (s[:, 0] < 0).mean()
    print(f"samples: modes at {s[s[:, 0] < 0, 0].mean():.2f} / "
          f"{s[s[:, 0] > 0, 0].mean():.2f} (target -2 / +2), "
          f"balance {frac_left:.2f} (target 0.5)")
    return s


if __name__ == "__main__":
    main()
