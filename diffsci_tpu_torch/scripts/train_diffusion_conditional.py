"""Class-conditional diffusion with classifier-free guidance, end to end.

Port of ``scripts/train_diffusion_conditional.py``: train a PUNetG with a
class embedding (``nn.Embedding``, flax's ``nn.Embed``) and condition
drop on a 4-class synthetic blob dataset (class = quadrant of the blob),
then sample each class with guidance and report the per-class centroid:
conditioning works iff the centroid lands in the requested quadrant.

Writes ``OUTDIR/metrics.jsonl`` and ``OUTDIR/conditional_samples.png``
(one class a row).

    python -m diffsci_tpu_torch.scripts.train_diffusion_conditional
        [--steps 400] [--guidance 2.0] [--cond-drop 0.1] [--device cuda]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from diffsci_tpu_torch.scripts._common import (add_device_flag, host,
                                               use_weights)
from diffsci_tpu_torch.utils import resolve_device

QUADRANTS = {0: (7, 7), 1: (7, 21), 2: (21, 7), 3: (21, 21)}  # (cy, cx)


def make_dataset(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    xs = np.zeros((n, 28, 28, 1), np.float32)
    ys = rng.integers(0, 4, n).astype(np.int32)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    for i in range(n):
        cy, cx = QUADRANTS[int(ys[i])]
        cy = cy + rng.uniform(-2, 2)
        cx = cx + rng.uniform(-2, 2)
        s = rng.uniform(2.0, 3.5)
        xs[i, :, :, 0] = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                                / (2 * s ** 2))
    return xs * 2.0 - 1.0, ys


def centroid(img: np.ndarray):
    """Intensity-weighted centroid of one [-1,1] image [H, W]."""
    w = np.clip(img + 1.0, 0.0, None)
    w = w / (w.sum() + 1e-9)
    yy, xx = np.mgrid[0:img.shape[0], 0:img.shape[1]]
    return float((w * yy).sum()), float((w * xx).sum())


def build(args, device):
    """The recipe's model, EMA tracker and optimizer (None: the
    default): (model, ema, tx)."""
    import torch.nn as nn
    from diffsci_tpu_torch.models import (EMATracker, KarrasModel,
                                          KarrasModelConfig, PUNetG,
                                          PUNetGConfig)
    cfg = PUNetGConfig(model_channels=args.channels,
                       channel_expansion=[2, 4],
                       cond_drop=args.cond_drop)
    net = PUNetG(cfg, conditional_embedding=nn.Embedding(4, args.channels),
                 device=device)
    model = KarrasModel(net, KarrasModelConfig.from_edm(), conditional=True,
                        device=device)
    ema = EMATracker(ema_type="power", power_function_stds=[0.05])
    return model, ema, None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--guidance", type=float, default=2.0)
    ap.add_argument("--cond-drop", type=float, default=0.1)
    ap.add_argument("--nsamples", type=int, default=16)
    ap.add_argument("--outdir", default="runs/conditional")
    add_device_flag(ap)
    args = ap.parse_args()

    import torch
    from diffsci_tpu_torch.trainer import fit_karras
    from diffsci_tpu_torch.utils import save_image_grid

    device = resolve_device(args.device)
    xs, ys = make_dataset(4096)
    print(f"dataset: {xs.shape}, classes: {np.bincount(ys)}, "
          f"device: {device}")
    model, ema, _ = build(args, device)

    state, trainer = fit_karras(
        model, (xs, ys.astype(np.int64)), batch_size=args.batch,
        max_epochs=max(1, args.steps // max(1, len(xs) // args.batch)),
        max_steps=args.steps, ema=ema, log_dir=args.outdir, device=device)
    tl = trainer.logger.last("train_loss")
    print(f"final train_loss={tl if tl is None else f'{tl:.4f}'} "
          f"(step {int(state.step)})")

    use_weights(model, state.ema_variables(ema))
    outdir = pathlib.Path(args.outdir)
    gen = torch.Generator(device).manual_seed(0)
    all_samples = []
    print(f"guided sampling (guidance={args.guidance}):")
    for cls in range(4):
        y = torch.full((args.nsamples,), cls, dtype=torch.int64,
                       device=device)
        out = host(model.sample(args.nsamples, (28, 28, 1), gen, y=y,
                                guidance=args.guidance, nsteps=18))
        all_samples.append(out)
        cys, cxs = zip(*(centroid(img[:, :, 0]) for img in out))
        ty, tx = QUADRANTS[cls]
        print(f"  class {cls}: centroid ({np.mean(cys):5.1f}, "
              f"{np.mean(cxs):5.1f})  target ({ty}, {tx})")
    save_image_grid(outdir / "conditional_samples.png",
                    np.concatenate(all_samples), nrow=args.nsamples)
    print(f"saved grid (one class per row) to "
          f"{outdir}/conditional_samples.png")


if __name__ == "__main__":
    main()
