"""End-to-end stochasticity study: reproduce the shape of FID against γ.

Port of ``scripts/stochasticity_study.py``. The reference's stochasticity
paper finds that for an early-training diffusion model sampling
stochasticity improves FID: FID(γ) drops from the near-ODE regime (γ ~
0) to a minimum at moderate stochasticity before it degrades at extreme
churn. Here each γ is one run of one sampler graph on the card (γ a
runtime ``langevin_scale``, filled before each replay), batched on the
device.

Without network access it trains on the in-house ``ShapesDataset``
(``paper_replica`` mode) in place of CIFAR-10 and scores with pixel
features (``metrics.fid``): the curve's shape is the target, not its
numbers, which are not Inception-FID (see ``eval_fid``).
``--classifier-fid`` also scores in the pooled features of a
``MinimalResNet`` trained on the shapes' slot labels
(``sampler_comparison.train_classifier_features``).

Writes ``--out`` (default docs/artifacts/stochasticity_sweep.json) with
the γ grid, FID per γ and a ``shape_ok`` verdict, FID(best γ > γ_min) <
FID(γ_min) (stochasticity helps); after every γ the partial sweep.

Usage:
    python -m diffsci_tpu_torch.scripts.stochasticity_study
        [--steps 1500] [--nsamples 512] [--device cuda]
"""

import argparse
import json
import pathlib

import numpy as np
import torch

from diffsci_tpu_torch.scripts._common import (add_device_flag, host,
                                               use_weights)
from diffsci_tpu_torch.utils import resolve_device


def features(x) -> np.ndarray:
    x = host(x)
    return np.asarray(x, np.float64).reshape(x.shape[0], -1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500,
                    help="training steps (early-training regime)")
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--num-data", type=int, default=4096)
    ap.add_argument("--nsamples", type=int, default=512)
    ap.add_argument("--nfe", type=int, default=100)
    ap.add_argument("--gammas", type=float, nargs="+",
                    default=[0.01, 0.1, 0.3, 0.5, 1.0, 2.0, 3.0, 5.0, 8.0])
    ap.add_argument("--model-channels", type=int, default=32,
                    help="128 = the reference's CIFAR-scale width")
    ap.add_argument("--expansion", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-4,
                    help="reference study trains at 1e-4 (stochasticity_"
                         "paper/scripts/train-diffusion-mnist.py:36); the "
                         "framework's 1e-3 default diverges at 128ch")
    ap.add_argument("--log-dir", default="runs/stochasticity_study")
    ap.add_argument("--classifier-fid", action="store_true",
                    help="also score in trained-classifier feature space "
                         "(MinimalResNet on the slot-occupancy labels)")
    ap.add_argument("--out",
                    default="docs/artifacts/stochasticity_sweep.json")
    add_device_flag(ap)
    args = ap.parse_args()

    from diffsci_tpu_torch import ops
    from diffsci_tpu_torch.data import ShapesDataset
    from diffsci_tpu_torch.metrics import fid
    from diffsci_tpu_torch.models import (EMATracker, KarrasModel,
                                          KarrasModelConfig, PUNetG,
                                          PUNetGConfig, default_optimizer)
    from diffsci_tpu_torch.scripts.sampler_comparison import \
        train_classifier_features
    from diffsci_tpu_torch.trainer import fit_karras

    device = resolve_device(args.device)
    xs, xlabels = ShapesDataset(args.num_data, size=args.size,
                                mode="paper_replica").generate_labeled()
    held_out = ShapesDataset(args.nsamples, size=args.size,
                             mode="paper_replica", seed=123).generate()
    print(f"data {xs.shape}, device {device}")

    net = PUNetG(PUNetGConfig(model_channels=args.model_channels,
                              channel_expansion=list(args.expansion)),
                 device=device)
    model = KarrasModel(net, KarrasModelConfig.from_edm(), device=device)
    ema = EMATracker(ema_type="power", power_function_stds=[0.05])
    state, trainer = fit_karras(
        model, xs, batch_size=args.batch_size,
        max_epochs=args.steps,  # outer bound only; max_steps terminates
        max_steps=args.steps, ema=ema, val_fraction=0.05,
        optimizer=default_optimizer(args.lr),
        log_dir=args.log_dir, device=device)
    print(f"trained to step {int(state.step)}")
    use_weights(model, state.ema_variables(ema))

    cls_feat = None
    if args.classifier_fid:
        cls_feat = train_classifier_features(xs, xlabels, device)

    real_f = features(held_out)
    real_cf = cls_feat(held_out) if cls_feat else None
    results = []
    gen = torch.Generator(device).manual_seed(42)
    out_path = pathlib.Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    # γ rides the sampler as a runtime langevin_scale (langevin_const
    # stays 1), so the whole sweep replays one sampler graph
    model.config.noisescheduler = ops.EDMScheduler(langevin_const=1.0)
    for gamma in args.gammas:
        samples = host(model.sample(
            args.nsamples, (args.size, args.size, 1), gen, nsteps=args.nfe,
            stochastic=True, maximum_batch_size=256, langevin_scale=gamma))
        score = float(fid(real_f, features(samples)))
        row = {"gamma": gamma, "fid": score}
        if cls_feat:
            row["classifier_fid"] = float(fid(real_cf, cls_feat(samples)))
        results.append(row)
        print(f"gamma={gamma}: " + ", ".join(
            f"{k}={v:.4f}" for k, v in row.items() if k != "gamma"),
            flush=True)
        # incremental write: a killed run still leaves partial results
        out_path.write_text(json.dumps({"partial": True,
                                        "sweep": results}, indent=2))

    fids = [r["fid"] for r in results]
    best_i = int(np.argmin(fids))
    shape_ok = bool(best_i > 0 and fids[best_i] < fids[0])
    artifact = {
        "dataset": f"shapes_paper_replica_{args.size}",
        "train_steps": int(state.step),
        "nfe": args.nfe,
        "nsamples": args.nsamples,
        "feature_space": ("pixel + trained-classifier"
                          if args.classifier_fid else
                          "pixel (NOT Inception-comparable; shape only)"),
        "model_channels": args.model_channels,
        "channel_expansion": list(args.expansion),
        "sweep": results,
        "best_gamma": args.gammas[best_i],
        "fid_at_min_gamma": fids[0],
        "fid_at_best_gamma": fids[best_i],
        "shape_ok": shape_ok,
        "finding": ("stochasticity improves early-training FID"
                    if shape_ok else
                    "shape NOT reproduced in this run"),
    }
    out_path.write_text(json.dumps(artifact, indent=2))
    print(f"wrote {out_path}; shape_ok={shape_ok}")


if __name__ == "__main__":
    main()
