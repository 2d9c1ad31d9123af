"""Shapes diffusion training and a morphing check.

Port of ``scripts/train_diffusion_shapes.py``: the synthetic
geometric-shapes dataset and a small PUNetG, with bottleneck attention or
without (``--no-attention``), for shape-morphing studies.

Writes ``OUTDIR/metrics.jsonl``, ``OUTDIR/ckpt``, ``OUTDIR/samples.png``
and ``OUTDIR/morph.png`` (two samples joined through noise space).

    python -m diffsci_tpu_torch.scripts.train_diffusion_shapes
        [--mode geometry_test] [--no-attention] [--steps 1000] [--size 64]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import pathlib

import torch

from diffsci_tpu_torch.scripts._common import (add_device_flag, host,
                                               use_weights)
from diffsci_tpu_torch.utils import resolve_device


def build(args, device):
    """The recipe's model, EMA tracker and optimizer (None: the
    default): (model, ema, tx)."""
    from diffsci_tpu_torch.models import (EMATracker, KarrasModel,
                                          KarrasModelConfig, PUNetG,
                                          PUNetGConfig)
    n_attn = 0 if args.no_attention else 1
    net = PUNetG(PUNetGConfig(
        model_channels=args.channels, channel_expansion=[2, 4],
        number_resnet_attn_block=n_attn,
        number_resnet_before_attn_block=1 if args.no_attention else 2,
        number_resnet_after_attn_block=1 if args.no_attention else 2),
        device=device)
    model = KarrasModel(net, KarrasModelConfig.from_edm(), device=device)
    ema = EMATracker(ema_type="power", power_function_stds=[0.05])
    return model, ema, None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="paper_replica",
                    choices=["paper_replica", "geometry_test"])
    ap.add_argument("--no-attention", action="store_true")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--num-samples", type=int, default=2048)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--outdir", default="runs/shapes")
    add_device_flag(ap)
    args = ap.parse_args()

    from diffsci_tpu_torch.checkpoint import save_checkpoint
    from diffsci_tpu_torch.data import ShapesDataset
    from diffsci_tpu_torch.trainer import fit_karras
    from diffsci_tpu_torch.utils import save_image_grid

    device = resolve_device(args.device)
    xs = ShapesDataset(args.num_samples, size=args.size,
                       mode=args.mode).generate()
    print(f"shapes[{args.mode}]: {xs.shape}, device: {device}")
    model, ema, _ = build(args, device)

    state, trainer = fit_karras(
        model, xs, batch_size=args.batch,
        max_epochs=max(1, args.steps // max(1, len(xs) // args.batch)),
        max_steps=args.steps, ema=ema,
        val_fraction=0.1, log_dir=args.outdir, device=device)

    outdir = pathlib.Path(args.outdir)
    save_checkpoint(outdir / "ckpt", state,
                    description=model.export_description())
    tl = trainer.logger.last("train_loss")
    print(f"final train_loss={tl if tl is None else f'{tl:.4f}'} "
          f"(step {int(state.step)})")

    use_weights(model, state.ema_variables(ema))
    shape = (args.size, args.size, 1)
    gen = torch.Generator(device).manual_seed(0)
    samples = model.sample(16, shape, gen, nsteps=18)
    save_image_grid(outdir / "samples.png", host(samples), nrow=4)

    # morphing check (geometry_test): interpolate between two samples in
    # noise space, the reference's shape-morphing experiment
    x1 = model.sample(1, shape, gen, nsteps=18)
    x2 = model.sample(1, shape, gen, nsteps=18)
    morph = host(model.interpolate_images(x1[0], x2[0], ninterp=6,
                                          nsteps=18, generator=gen))
    save_image_grid(outdir / "morph.png", morph, nrow=morph.shape[0])
    print(f"saved samples.png and morph.png to {outdir}")


if __name__ == "__main__":
    main()
