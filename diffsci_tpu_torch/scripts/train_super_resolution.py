"""SR3-style conditional super-resolution diffusion.

Port of ``scripts/train_super_resolution.py``: the model learns
p(high-res | low-res) with the low-res image upsampled and concatenated as
a conditioning channel (``PUNetGCond``), under the SR3 preconditioner's
halved skip connections. Synthetic task: 28×28 blobs average-pooled 4× to
7×7 and upsampled back; reports the PSNR of the posterior mean of
``--ndraws`` super-resolved draws, and of one draw, against the naive
upsample's.

The condition goes to the network in its layout, [B, 1, 28, 28]; the
arrays of the task and the image are channels-last.

Writes ``OUTDIR/metrics.jsonl`` and ``OUTDIR/sr3.png`` (rows: truth,
low-res, super-resolved).

    python -m diffsci_tpu_torch.scripts.train_super_resolution
        [--steps 1500] [--factor 4] [--device cuda]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from diffsci_tpu_torch.scripts._common import (add_device_flag, channels_first,
                                               host, use_weights)
from diffsci_tpu_torch.utils import resolve_device


def make_blobs(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    xs = np.zeros((n, 28, 28, 1), np.float32)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    for i in range(n):
        cx, cy = rng.uniform(6, 22, 2)
        s = rng.uniform(1.5, 3.0)
        xs[i, :, :, 0] = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                                / (2 * s ** 2))
    return xs * 2.0 - 1.0


def psnr(a: np.ndarray, b: np.ndarray, rng: float = 2.0) -> float:
    mse = float(np.mean((a - b) ** 2))
    return 10.0 * np.log10(rng ** 2 / max(mse, 1e-12))


def degrade(xs: np.ndarray, f: int) -> np.ndarray:
    """Average-pool by ``f``, then nearest-upsample back to 28²."""
    lo = xs.reshape(-1, 28 // f, f, 28 // f, f, 1).mean(axis=(2, 4))
    return np.repeat(np.repeat(lo, f, axis=1), f, axis=2)


def build(args, device):
    """The recipe's model, EMA tracker and optimizer (None: the
    default): (model, ema, tx)."""
    from diffsci_tpu_torch.models import (EMATracker, KarrasModel,
                                          KarrasModelConfig, PUNetGCond,
                                          PUNetGConfig)
    cfg = PUNetGConfig(model_channels=args.channels,
                       channel_expansion=[2, 4],
                       input_channels=2,  # x + 1 conditioning channel
                       output_channels=1)
    net = PUNetGCond(cfg, channel_conditional_items=("lowres",),
                     device=device)
    model = KarrasModel(net, KarrasModelConfig.conditional_sr3(),
                        conditional=True, device=device)
    ema = EMATracker(ema_type="power", power_function_stds=[0.05])
    return model, ema, None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--factor", type=int, default=4)
    ap.add_argument("--nsamples", type=int, default=32)
    ap.add_argument("--ndraws", type=int, default=8)
    ap.add_argument("--outdir", default="runs/sr3")
    add_device_flag(ap)
    args = ap.parse_args()

    import torch
    from diffsci_tpu_torch.trainer import fit_karras
    from diffsci_tpu_torch.utils import save_image_grid

    device = resolve_device(args.device)
    xs = make_blobs(4096)
    lo_up = degrade(xs, args.factor)
    print(f"dataset: hi {xs.shape}, lo-up {lo_up.shape}, device: {device}")
    model, ema, _ = build(args, device)

    state, trainer = fit_karras(
        model, (xs, {"lowres": channels_first(lo_up)}),
        batch_size=args.batch,
        max_epochs=max(1, args.steps // max(1, len(xs) // args.batch)),
        max_steps=args.steps, ema=ema, log_dir=args.outdir, device=device)
    tl = trainer.logger.last("train_loss")
    print(f"final train_loss={tl if tl is None else f'{tl:.4f}'} "
          f"(step {int(state.step)})")

    use_weights(model, state.ema_variables(ema))
    n = args.nsamples
    y_eval = {"lowres": torch.from_numpy(channels_first(lo_up[:n])).to(
        device)}
    # posterior draws; their mean approximates the MMSE estimate, the
    # right object to compare with the (deterministic) naive upsample on
    # PSNR, since a single draw carries sampling variance
    gen = torch.Generator(device).manual_seed(0)
    draws = [host(model.sample(n, (28, 28, 1), gen, y=y_eval, nsteps=18))
             for _ in range(args.ndraws)]
    out = draws[0]
    post_mean = np.mean(draws, axis=0)
    p_draw = psnr(out, xs[:n])
    p_mean = psnr(post_mean, xs[:n])
    p_naive = psnr(lo_up[:n], xs[:n])
    verdict = "BETTER" if p_mean > p_naive else "WORSE"
    print(f"PSNR: posterior-mean({args.ndraws}) {p_mean:.2f} dB, "
          f"single draw {p_draw:.2f} dB, naive upsample {p_naive:.2f} dB "
          f"({verdict})")
    outdir = pathlib.Path(args.outdir)
    grid = np.concatenate([xs[:8], lo_up[:8], out[:8]])
    save_image_grid(outdir / "sr3.png", grid, nrow=8)
    print(f"saved rows [truth / low-res / super-resolved] to {outdir}/sr3.png")


if __name__ == "__main__":
    main()
