"""Train an unconditional EDM diffusion model on MNIST-scale images.

Port of ``scripts/train_diffusion_mnist.py``: edit the CONFIG block, run
the script. Data: pass ``--data path/to/mnist.npz`` (array 'x' of shape
[N, 28, 28] or [N, 28, 28, 1], values in [0, 255] or [0, 1]); without it
a synthetic blob dataset (the same arrays as the JAX script's) keeps the
pipeline runnable without downloads.

Writes ``OUTDIR/metrics.jsonl``, the checkpoint ``OUTDIR/ckpt`` (with its
``description.json``), and 16 Heun samples of the EMA weights as
``OUTDIR/samples.npy`` ([16, 28, 28, 1]) and ``samples.png``.

Usage:
    python -m diffsci_tpu_torch.scripts.train_diffusion_mnist
        [--data mnist.npz] [--steps 2000] [--batch 256] [--channels 64]
        [--outdir runs/mnist-edm] [--device cuda]
    torchrun --nproc-per-node 4 -m diffsci_tpu_torch.scripts.\\
        train_diffusion_mnist --n-devices 4
"""

import argparse
import pathlib

import numpy as np
import torch

from diffsci_tpu_torch.scripts._common import (add_device_flag, host, mesh_of,
                                               use_weights, writes)
from diffsci_tpu_torch.utils import resolve_device

# ------------------------- CONFIG (edit me) -------------------------------
MODEL_CHANNELS = 64
CHANNEL_EXPANSION = [2, 4]
LEARNING_RATE = 1e-3          # reference default (karrasmodule.py:497)
WEIGHT_DECAY = 1e-4
GRAD_CLIP = 0.5               # reference script (train-diffusion-cifar10.py:92)
EMA_STDS = [0.05, 0.1]        # EDM2 power-function profiles
# --------------------------------------------------------------------------


def load_data(path: str | None, n_synth: int = 4096) -> np.ndarray:
    if path is not None:
        arr = np.load(path)
        x = arr["x"] if "x" in arr else arr[list(arr.keys())[0]]
        x = x.astype(np.float32)
        if x.max() > 2.0:
            x = x / 255.0
        if x.ndim == 3:
            x = x[..., None]
        return x * 2.0 - 1.0  # [-1, 1]
    rng = np.random.default_rng(0)
    # synthetic "digits": gaussian blobs at random positions
    xs = np.zeros((n_synth, 28, 28, 1), np.float32)
    yy, xx = np.mgrid[0:28, 0:28]
    for i in range(n_synth):
        cx, cy = rng.uniform(8, 20, 2)
        s = rng.uniform(2, 5)
        xs[i, :, :, 0] = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                                / (2 * s ** 2))
    return xs * 2.0 - 1.0


def build(args, device):
    """The recipe's model, EMA tracker and optimizer: (model, ema, tx)."""
    from diffsci_tpu_torch.models import (EMATracker, KarrasModel,
                                          KarrasModelConfig, PUNetG,
                                          PUNetGConfig, default_optimizer)
    net = PUNetG(PUNetGConfig(model_channels=args.channels,
                              channel_expansion=CHANNEL_EXPANSION),
                 device=device)
    model = KarrasModel(net, KarrasModelConfig.from_edm(), device=device)
    # every-4th-step shadow update (exact power-profile telescoped decay):
    # the same training trajectory, less memory traffic
    ema = EMATracker(ema_type="power", power_function_stds=EMA_STDS,
                     update_every=4)
    tx = default_optimizer(LEARNING_RATE, WEIGHT_DECAY, grad_clip=GRAD_CLIP)
    return model, ema, tx


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--channels", type=int, default=MODEL_CHANNELS)
    ap.add_argument("--outdir", default="runs/mnist-edm")
    ap.add_argument("--resume", default=None,
                    help="checkpoint dir to resume from (--steps is the TOTAL step budget incl. already-trained steps)")
    ap.add_argument("--n-devices", type=int, default=None,
                    help="data-parallel over this many devices")
    ap.add_argument("--profile", action="store_true",
                    help="capture a torch.profiler trace of steps 10-20 "
                         "into OUTDIR/profile")
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
        val_fraction=0.05, log_dir=args.outdir,
        resume_from=args.resume,
        profile_dir=(pathlib.Path(args.outdir) / "profile"
                     if args.profile else None),
        profile_steps=(10, 20) if args.profile else None, device=device)

    outdir = pathlib.Path(args.outdir)
    save_checkpoint(outdir / "ckpt", state,
                    description=model.export_description())
    tl = trainer.logger.last("train_loss")
    print(f"final train_loss={tl if tl is None else f'{tl:.4f}'} "
          f"valid_loss={trainer.logger.last('valid_loss')} "
          f"(step {int(state.step)})")

    # quick sample grid from the first EMA profile
    use_weights(model, state.ema_variables(ema))
    gen = torch.Generator(device).manual_seed(0)
    samples = host(model.sample(16, (28, 28, 1), gen, nsteps=18))
    if writes(mesh):
        np.save(outdir / "samples.npy", samples)
        save_image_grid(outdir / "samples.png", samples, nrow=4)
        print(f"saved 16 samples to {outdir}/samples.npy (+ samples.png)")

if __name__ == "__main__":
    main()
