"""Inpainting and RePaint: generation that keeps a known region.

Port of ``scripts/inpainting_demo.py``: train on two-blob images, mask
out the right half, and regenerate it conditioned on the visible half.
Reports (a) the round trip of the known region (exact for the plain
inpaint loop; RePaint re-diffuses it to harmonize the seam) and (b) that
the inpainted half holds a plausible blob (a mass check).

Writes ``OUTDIR/metrics.jsonl`` and ``OUTDIR/<mode>.png`` (rows: truth,
masked input, result).

    python -m diffsci_tpu_torch.scripts.inpainting_demo [--steps 1500]
        [--mode repaint] [--device cuda]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from diffsci_tpu_torch.scripts._common import (add_device_flag, host,
                                               use_weights)
from diffsci_tpu_torch.utils import resolve_device


def make_two_blobs(n: int, size: int = 28, seed: int = 0):
    """Always one blob in the left half and one in the right half, so
    that the visible half implies a blob in the hidden half."""
    rng = np.random.default_rng(seed)
    xs = np.zeros((n, size, size, 1), np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for i in range(n):
        for lo, hi in ((4, size // 2 - 3), (size // 2 + 3, size - 4)):
            cx = rng.uniform(lo, hi)
            cy = rng.uniform(6, size - 6)
            s = rng.uniform(1.8, 3.0)
            xs[i, :, :, 0] += np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                                     / (2 * s ** 2))
    return np.clip(xs, 0, 1) * 2.0 - 1.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--nsteps", type=int, default=50)
    ap.add_argument("--mode", default="inpaint",
                    choices=["inpaint", "repaint"])
    ap.add_argument("--neval", type=int, default=16)
    ap.add_argument("--outdir", default="runs/inpaint")
    add_device_flag(ap)
    args = ap.parse_args()

    import torch
    from diffsci_tpu_torch.models import (EMATracker, KarrasModel,
                                          KarrasModelConfig, PUNetG,
                                          PUNetGConfig)
    from diffsci_tpu_torch.trainer import fit_karras
    from diffsci_tpu_torch.utils import save_image_grid

    device = resolve_device(args.device)
    xs = make_two_blobs(4096)
    print(f"two-blob data: {xs.shape}, device: {device}")

    net = PUNetG(PUNetGConfig(model_channels=args.channels,
                              channel_expansion=[2, 4]), device=device)
    model = KarrasModel(net, KarrasModelConfig.from_edm(), device=device)
    ema = EMATracker(ema_type="power", power_function_stds=[0.05])
    state, trainer = fit_karras(
        model, xs, batch_size=args.batch,
        max_epochs=max(1, args.steps // max(1, len(xs) // args.batch)),
        max_steps=args.steps, ema=ema, log_dir=args.outdir, device=device)
    tl = trainer.logger.last("train_loss")
    print(f"trained: loss={tl if tl is None else f'{tl:.4f}'} "
          f"(step {int(state.step)})")

    use_weights(model, state.ema_variables(ema))
    truth = make_two_blobs(args.neval, seed=9)
    size = truth.shape[1]
    # mask: right half unknown (mask == 1 marks the KNOWN region)
    mask = np.zeros_like(truth)
    mask[:, :, :size // 2] = 1.0

    fn = model.repaint if args.mode == "repaint" else model.inpaint
    gen = torch.Generator(device).manual_seed(0)
    with torch.no_grad():
        out = host(fn(torch.from_numpy(truth).to(device),
                      torch.from_numpy(mask).to(device),
                      nsteps=args.nsteps, generator=gen))

    known_err = float(np.abs((out - truth) * mask).max())
    # the hidden half should hold a blob: its mass against the truth's
    hidden = out[:, :, size // 2:]
    mass_gen = float((hidden + 1).sum(axis=(1, 2, 3)).mean())
    mass_true = float((truth[:, :, size // 2:] + 1)
                      .sum(axis=(1, 2, 3)).mean())
    peak = float((hidden.max(axis=(1, 2, 3)) > 0.3).mean())
    note = ("exact round-trip" if args.mode == "inpaint"
            else "approximate: RePaint re-diffuses the known region to "
                 "harmonize the seam")
    print(f"{args.mode}: known-region max |err| = {known_err:.2e} ({note})")
    print(f"  hidden half: mean mass {mass_gen:.1f} vs truth {mass_true:.1f}"
          f"; fraction with a bright blob: {peak:.2f}")

    outdir = pathlib.Path(args.outdir)
    masked_vis = truth * mask + (-1.0) * (1 - mask)
    grid = np.concatenate([truth[:8], masked_vis[:8], out[:8]])
    save_image_grid(outdir / f"{args.mode}.png", grid, nrow=8)
    print(f"saved rows [truth / masked input / {args.mode}ed] to "
          f"{outdir}/{args.mode}.png")


if __name__ == "__main__":
    main()
