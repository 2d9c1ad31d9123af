"""CIFAR-10-scale diffusion training: PUNetG + VP preconditioning.

Port of ``scripts/train_diffusion_cifar10.py`` (unconditional PUNetG,
``KarrasModelConfig.from_vp()``, AdamW with the NaN guard and clip 0.5,
all inside the graphed train step).

Data: ``--data cifar10.npz`` with array 'x' of shape [N, 32, 32, 3]
(uint8 or [-1, 1] floats). Without --data a synthetic color-blob set (the
JAX script's arrays) keeps the pipeline runnable without downloads.

Writes ``OUTDIR/metrics.jsonl``, ``OUTDIR/ckpt`` and 16 samples as
``OUTDIR/samples.npy`` ([16, 32, 32, 3]) and ``samples.png``.

    python -m diffsci_tpu_torch.scripts.train_diffusion_cifar10
        [--data cifar10.npz] [--steps 2000] [--batch 128] [--channels 64]
        [--bf16] [--device cuda]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from diffsci_tpu_torch.scripts._common import (add_device_flag, host, mesh_of,
                                               use_weights, writes)
from diffsci_tpu_torch.utils import resolve_device

LEARNING_RATE = 1e-3
WEIGHT_DECAY = 1e-4
GRAD_CLIP = 0.5  # train-diffusion-cifar10.py:92
EMA_STDS = [0.05, 0.1]


def load_data(path: str | None, n_synth: int = 2048) -> np.ndarray:
    if path:
        arr = np.load(path)
        xs = arr["x"] if hasattr(arr, "files") else arr
        xs = np.asarray(xs, np.float32)
        if xs.ndim == 3:
            xs = xs[..., None]
        if xs.max() > 2.0:
            xs = xs / 127.5 - 1.0
        return xs
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    cx = rng.uniform(8, 24, (n_synth, 1, 1, 3))
    cy = rng.uniform(8, 24, (n_synth, 1, 1, 3))
    r = rng.uniform(3, 8, (n_synth, 1, 1, 3))
    img = np.exp(-(((xx[..., None] - cx) ** 2 + (yy[..., None] - cy) ** 2)
                   / (2 * r ** 2)))
    return (img * 2.0 - 1.0).astype(np.float32)


def build(args, device):
    """The recipe's model, EMA tracker and optimizer: (model, ema, tx)."""
    import torch
    from diffsci_tpu_torch.models import (EMATracker, KarrasModel,
                                          KarrasModelConfig, PUNetG,
                                          PUNetGConfig, default_optimizer)
    net = PUNetG(PUNetGConfig(model_channels=args.channels,
                              channel_expansion=[2, 4],
                              input_channels=3, output_channels=3,
                              space_to_depth=args.s2d), device=device)
    model = KarrasModel(net, KarrasModelConfig.from_vp(),
                        compute_dtype=torch.bfloat16 if args.bf16 else None,
                        device=device)
    # shadows updated every 4th step with the exact power-profile
    # telescoped decay: the same training trajectory, less memory traffic
    ema = EMATracker(ema_type="power", power_function_stds=EMA_STDS,
                     update_every=4)
    tx = default_optimizer(LEARNING_RATE, WEIGHT_DECAY, grad_clip=GRAD_CLIP)
    return model, ema, tx


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--outdir", default="runs/cifar10-vp")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--s2d", type=int, default=1,
                    help="space_to_depth input folding (opt-in); validate "
                         "quality on your data before adopting")
    ap.add_argument("--n-devices", type=int, default=0)
    add_device_flag(ap)
    args = ap.parse_args()

    from diffsci_tpu_torch.checkpoint import save_checkpoint
    from diffsci_tpu_torch.trainer import fit_karras
    from diffsci_tpu_torch.utils import save_image_grid

    device = resolve_device(args.device)
    xs = load_data(args.data)
    print(f"dataset: {xs.shape}, device: {device}")
    mesh = mesh_of(args.n_devices, device)
    model, ema, tx = build(args, device)

    state, trainer = fit_karras(
        model, xs, batch_size=args.batch,
        max_epochs=max(1, args.steps // max(1, len(xs) // args.batch)),
        max_steps=args.steps, mesh=mesh, ema=ema, optimizer=tx,
        val_fraction=0.05, log_dir=args.outdir, device=device)

    outdir = pathlib.Path(args.outdir)
    save_checkpoint(outdir / "ckpt", state,
                    description=model.export_description())
    tl = trainer.logger.last("train_loss")
    print(f"final train_loss={tl if tl is None else f'{tl:.4f}'} "
          f"valid_loss={trainer.logger.last('valid_loss')} "
          f"(step {int(state.step)})")

    use_weights(model, state.ema_variables(ema))
    gen = torch.Generator(device).manual_seed(0)
    samples = host(model.sample(16, (32, 32, 3), gen, nsteps=18))
    if writes(mesh):
        np.save(outdir / "samples.npy", samples)
        save_image_grid(outdir / "samples.png", samples, nrow=4)
        print(f"saved samples to {outdir}/samples.png")


if __name__ == "__main__":
    main()
