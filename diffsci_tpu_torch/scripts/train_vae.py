"""Train a KL-VAE (optionally adversarial) for latent diffusion.

Port of ``scripts/train_vae.py``: produces a checkpoint usable as a
``BoundAutoencoder`` in latent ``KarrasModel`` training. Data: ``--data
vol.npz`` (array 'x', [N, H, W] or [N, H, W, C]); without it standard
normal fields (the JAX script's arrays). The arrays are channels-last and
go to the network as [B, C, H, W].

Writes ``OUTDIR/ckpt`` (the autoencoder's and, with ``--adversarial``, the
discriminator's state; ``description.json`` holds the ``ddconfig``).

Usage:
    python -m diffsci_tpu_torch.scripts.train_vae [--data vol.npz]
        [--steps 2000] [--adversarial] [--outdir runs/vae] [--device cuda]
"""

import argparse
import pathlib

import numpy as np

from diffsci_tpu_torch.scripts._common import add_device_flag, channels_first
from diffsci_tpu_torch.utils import resolve_device


def load_data(path: str | None, resolution: int) -> np.ndarray:
    if path:
        xs = np.load(path)["x"].astype(np.float32)
        if xs.ndim == 3:
            xs = xs[..., None]
        return xs
    rng = np.random.default_rng(0)
    return rng.standard_normal(
        (2048, resolution, resolution, 1)).astype(np.float32)


def build(args, device):
    """The recipe's autoencoder config and model: (ddconfig, model)."""
    from diffsci_tpu_torch.models.nets import AutoencoderKL, DDConfig
    from diffsci_tpu_torch.models.vae import (NLayerDiscriminator, VAEModel,
                                              VAEModelConfig)
    dd = DDConfig(z_channels=4, resolution=args.resolution, ch=32,
                  ch_mult=[1, 2, 4], num_res_blocks=2, has_mid_attn=False)
    config = VAEModelConfig(kl_weight=args.kl_weight,
                            reconstruction_loss="mse",
                            adversarial_weight=0.05 if args.adversarial
                            else 0.0)
    disc = NLayerDiscriminator(device=device) if args.adversarial else None
    model = VAEModel(AutoencoderKL(dd, embed_dim=4, device=device), config,
                     discriminator=disc, device=device)
    return dd, model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--resolution", type=int, default=32)
    ap.add_argument("--adversarial", action="store_true")
    ap.add_argument("--kl-weight", type=float, default=1e-4)
    ap.add_argument("--outdir", default="runs/vae")
    add_device_flag(ap)
    args = ap.parse_args()

    import torch
    from diffsci_tpu_torch.checkpoint import save_checkpoint
    from diffsci_tpu_torch.models.vae import (create_vae_train_state,
                                              make_vae_train_step)

    device = resolve_device(args.device)
    xs = torch.from_numpy(channels_first(load_data(args.data,
                                                   args.resolution)))
    dd, model = build(args, device)
    state, tx, dtx = create_vae_train_state(
        model, (args.batch,) + tuple(xs.shape[1:]), seed=0)
    step_fn = make_vae_train_step(model, tx, dtx)

    gen = torch.Generator(device).manual_seed(1)
    n = (len(xs) // args.batch) * args.batch
    for i in range(args.steps):
        lo = (i * args.batch) % n
        state, metrics = step_fn(state, xs[lo:lo + args.batch].to(device),
                                 generator=gen)
        if i % 100 == 0:
            print(f"step {i}: loss={float(metrics['train_loss']):.4f} "
                  f"nll={float(metrics['nll_loss']):.4f} "
                  f"kl={float(metrics['kl_loss']):.4f}")

    outdir = pathlib.Path(args.outdir)
    save_checkpoint(outdir / "ckpt", state,
                    description={"ddconfig": dd.export_description()})
    print(f"saved checkpoint to {outdir}/ckpt")


if __name__ == "__main__":
    main()
