"""Diffusion-based anomaly detection: AnoDDPM and DDAD end to end.

Port of ``scripts/anomaly_detection.py``: train a diffusion model on clean
data (Gaussian blobs), then detect injected anomalies (a bright square) by
partial noising and reconstruction: anomalous regions reconstruct toward
the clean manifold, so the reconstruction error map localizes the defect.
DDAD adds the w·(y − x) guidance term so that normal regions stay
faithful to the input. Reports the separation of AnoDDPM's error on
corrupted against clean images and the localization of both.

Writes ``OUTDIR/metrics.jsonl`` and ``OUTDIR/anomaly.png`` (rows:
corrupted, reconstruction, error map).

    python -m diffsci_tpu_torch.scripts.anomaly_detection [--steps 1500]
        [--noise-step 12] [--device cuda]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from diffsci_tpu_torch.scripts._common import (add_device_flag, host,
                                               use_weights)
from diffsci_tpu_torch.utils import resolve_device


def make_blobs(n: int, size: int = 28, seed: int = 0):
    rng = np.random.default_rng(seed)
    xs = np.zeros((n, size, size, 1), np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for i in range(n):
        cx, cy = rng.uniform(8, size - 8, 2)
        s = rng.uniform(2.0, 4.0)
        xs[i, :, :, 0] = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                                / (2 * s ** 2))
    return xs * 2.0 - 1.0


def inject_square(xs: np.ndarray, size: int = 6, seed: int = 1):
    """Bright square artifact at a random position (the anomaly)."""
    rng = np.random.default_rng(seed)
    out = xs.copy()
    masks = np.zeros(xs.shape, np.float32)
    for i in range(len(out)):
        r = rng.integers(2, xs.shape[1] - size - 2)
        c = rng.integers(2, xs.shape[2] - size - 2)
        out[i, r:r + size, c:c + size, 0] = 1.0
        masks[i, r:r + size, c:c + size, 0] = 1.0
    return out, masks


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--nsteps", type=int, default=18,
                    help="backward grid size")
    ap.add_argument("--noise-step", type=int, default=12,
                    help="partial-noise depth (higher = less noise on the "
                         "EDM grid; step indexes the sigma grid)")
    ap.add_argument("--neval", type=int, default=32)
    ap.add_argument("--outdir", default="runs/anomaly")
    add_device_flag(ap)
    args = ap.parse_args()

    import torch
    from diffsci_tpu_torch.features import DDAD, AnoDDPM
    from diffsci_tpu_torch.models import (EMATracker, KarrasModel,
                                          KarrasModelConfig, PUNetG,
                                          PUNetGConfig)
    from diffsci_tpu_torch.trainer import fit_karras
    from diffsci_tpu_torch.utils import save_image_grid

    device = resolve_device(args.device)
    xs = make_blobs(4096)
    print(f"clean data: {xs.shape}, device: {device}")

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

    @torch.no_grad()
    def score_fn(x, sigma):
        return model.get_score(x, sigma)

    clean = make_blobs(args.neval, seed=7)
    corrupted, masks = inject_square(clean)
    sched = model.config.noisescheduler
    gen = torch.Generator(device).manual_seed(0)

    def on_device(a):
        return torch.from_numpy(a).to(device)

    ano = AnoDDPM(sched)
    rec_bad = host(ano.reconstruct(on_device(corrupted), score_fn,
                                   step=args.noise_step, nsteps=args.nsteps,
                                   generator=gen))
    rec_ok = host(ano.reconstruct(on_device(clean), score_fn,
                                  step=args.noise_step, nsteps=args.nsteps,
                                  generator=gen))
    err_bad = ((corrupted - rec_bad) ** 2)[..., 0]
    err_ok = ((clean - rec_ok) ** 2)[..., 0]
    score_bad = err_bad.mean(axis=(1, 2))
    score_ok = err_ok.mean(axis=(1, 2))
    sep = float(score_bad.mean() / max(score_ok.mean(), 1e-9))
    # localization: error inside the anomaly mask against outside
    m = masks[..., 0] > 0
    in_err = float(err_bad[m].mean())
    out_err = float(err_bad[~m].mean())
    auc_proxy = float((score_bad[:, None] > score_ok[None, :]).mean())
    print(f"AnoDDPM: corrupted score {score_bad.mean():.4f} vs clean "
          f"{score_ok.mean():.4f} (separation x{sep:.1f}, "
          f"pairwise-AUC {auc_proxy:.3f})")
    print(f"  localization: error inside anomaly {in_err:.4f} vs outside "
          f"{out_err:.4f} (x{in_err / max(out_err, 1e-9):.1f})")

    ddad = DDAD(sched)
    rec_g = host(ddad.reconstruct(on_device(corrupted), score_fn,
                                  nsteps=args.nsteps,
                                  initial_step=args.noise_step, w=3.0,
                                  generator=gen))
    err_g = ((corrupted - rec_g) ** 2)[..., 0]
    print(f"DDAD (w=3): error inside anomaly {float(err_g[m].mean()):.4f} "
          f"vs outside {float(err_g[~m].mean()):.4f}")

    outdir = pathlib.Path(args.outdir)
    emax = err_bad[:8].max() or 1.0
    grid = np.concatenate([corrupted[:8], rec_bad[:8],
                           (err_bad[:8, :, :, None] / emax) * 2.0 - 1.0])
    save_image_grid(outdir / "anomaly.png", grid, nrow=8)
    print(f"saved rows [corrupted / reconstruction / error map] to "
          f"{outdir}/anomaly.png")


if __name__ == "__main__":
    main()
