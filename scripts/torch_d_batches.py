#!/usr/bin/env python3
"""Configuration D's training on batches drawn with numpy, on one GPU:
which batches make its loss go up.

    python3 scripts/torch_d_batches.py [--seeds 0 1 2 3] [--steps 23]

D is configuration A's network (PUNetG 3D at 32 channels, one 4096-token
flash attention) with circular convolutions, ``cond_drop`` 0.1,
``PorosityEmbedder(32)`` and the EDM batch norm, trained as
``chip_smoke.py``'s phase 15 trains it: batch 4 of 32³ volumes, AdamW at
the port's defaults (lr 1e-3, weight decay 1e-4, clip 0.5), power EMA
every 4 steps, 23 steps (phase 15's 3 warm-up and 20 timed ones). Each
seed's volumes and porosities come from ``chip_smoke.porous_volumes`` and
its σ, ε and condition-keep masks from ``chip_smoke.d_draws``, replayed
into the step, and the weights from ``KarrasModel.init(0)`` (the same on
the CPU), so ``tests/_torch_fault_checks.py d --batch-seed S`` replays
the same run on the CPU through both packages. Each seed runs in bf16
over f32 masters (phase 15's) and in f32. Prints every step's loss and
grad norm and the fixed-draw probe before and after (the batch norm on
the batch's own statistics, ``chip_smoke.batch_statistics_of``); a seed
whose probe goes up is reported as diverging. Prints the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

D_SHAPE = (4, 32, 32, 32, 1)


def d_config():
    from diffsci_tpu_torch import PUNetGConfig
    return PUNetGConfig(dimension=3, model_channels=32, channel_expansion=[2],
                        num_heads=2, attn_backend="flash",
                        convolution_type="circular", cond_drop=0.1)


def run(seed, steps, dtype, device="cuda"):
    """One seed's training: (losses, grad norms, probe before, after)."""
    from diffsci_tpu_torch import (EMATracker, create_train_state,
                                   make_train_step)

    model = chip_smoke.model_d(d_config(), device=device, dtype=dtype)
    model.init(0)
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05],
                         update_every=4)
    state, tx = create_train_state(model, D_SHAPE, seed=None, ema=tracker)
    step = make_train_step(model, tx, ema=tracker)
    x, phi = porous_volumes_on(seed, device)
    y = {"porosity": phi}
    (psig, peps), draws = chip_smoke.d_draws(seed, steps)

    def on(a):
        return torch.from_numpy(a).to(device)

    def probe():
        with torch.no_grad(), chip_smoke.batch_statistics_of(model, x):
            return float(model.loss_fn(x, on(psig), y, eps=on(peps),
                                       train=False))

    before = probe()
    losses, norms = [], []
    for sig, eps, keep in draws:
        met = step(state, x, y, sigma=on(sig), eps=on(eps), keep=on(keep))[1]
        losses.append(float(met["train_loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms, before, probe()


def porous_volumes_on(seed, device):
    x, phi = chip_smoke.porous_volumes(D_SHAPE[0], D_SHAPE[1], seed)
    return torch.from_numpy(x).to(device), torch.from_numpy(phi).to(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--steps", type=int, default=23)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_d_batches: needs a CUDA card", file=sys.stderr)
        return 2
    from diffsci_tpu_torch import kernels
    kernels.load_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    diverged = []
    for seed in args.seeds:
        phi = chip_smoke.porous_volumes(D_SHAPE[0], D_SHAPE[1], seed)[1]
        for dtype in (torch.bfloat16, None):
            losses, norms, before, after = run(seed, args.steps, dtype)
            name = "bf16" if dtype else "f32"
            print(f"seed {seed} {name} porosity "
                  f"{[round(float(p), 4) for p in phi[:, 0]]}: probe "
                  f"{before:.6g} -> {after:.6g}; losses "
                  f"{[round(v, 5) for v in losses]}; grad norms "
                  f"{[round(v, 3) for v in norms]}", flush=True)
            if not after < before:
                diverged.append((seed, name))
    print(f"diverging (probe up): {diverged}")
    print(chip_smoke.smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
