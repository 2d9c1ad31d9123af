"""Sampler comparison at matched NFE: Euler vs Heun vs DPM-Solver++(2M).

Port of ``scripts/sampler_comparison.py``: trains the bench-scale model on
the shapes dataset, then scores pixel-FID for each deterministic sampler at
matched network evaluations: Euler and DPM++(2M) spend one a step, Heun
two a step minus one (the endpoint). The claim under test is the
DPM-Solver++ paper's: at low NFE the multistep sampler beats Euler and
matches Heun at half the steps. ``--classifier-fid`` also scores in the
pooled features of a ``MinimalResNet`` trained on the shapes' slot labels
(``train_classifier_features``).

Writes the JSON artifact ``--out`` (default
docs/artifacts/sampler_comparison.json) and the training log under
``--log-dir``.

Usage:
    python -m diffsci_tpu_torch.scripts.sampler_comparison [--steps 1500]
        [--nsamples 512] [--device cuda]
"""

import argparse
import json
import pathlib

import numpy as np
import torch

from diffsci_tpu_torch.scripts._common import (add_device_flag, host,
                                               use_weights)
from diffsci_tpu_torch.utils import resolve_device

# (label, integrator, nsteps, nfe): Heun evaluates 2n-1 times
GRID = [
    ("euler@10", "euler", 10, 10),
    ("dpmpp2m@10", "dpmpp2m", 10, 10),
    ("euler@20", "euler", 20, 20),
    ("heun@10", "heun", 10, 19),
    ("dpmpp2m@20", "dpmpp2m", 20, 20),
    ("heun@25", "heun", 25, 49),
    ("dpmpp2m@50", "dpmpp2m", 50, 50),
]


def features(x) -> np.ndarray:
    x = host(x)
    return np.asarray(x, np.float64).reshape(x.shape[0], -1)


def train_classifier_features(xs, labels, device, steps=600):
    """Train a ``MinimalResNet`` on the slot-occupancy labels (3-way
    multi-label sigmoid, Adam 3e-4, batches of 128 random rows) and return
    its pooled-feature extractor: a non-pixel feature space for FID."""
    import torch
    import torch.nn.functional as F
    from diffsci_tpu_torch.metrics import classifier_features_fn
    from diffsci_tpu_torch.models.nets.classifiers import MinimalResNet
    from diffsci_tpu_torch.models.nets.layers import init_parameters

    net = MinimalResNet(out_classes=3, model_channels=32, n_layers=4,
                        device=device)
    init_parameters(net, 7)
    opt = torch.optim.Adam(net.parameters(), lr=3e-4)
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(xs, -1, 1))).to(
        device)
    y = torch.from_numpy(np.asarray(labels, np.float32)).to(device)
    gen = torch.Generator(device).manual_seed(7)
    for _ in range(steps):
        idx = torch.randint(0, x.shape[0], (128,), generator=gen,
                            device=device)
        loss = F.binary_cross_entropy_with_logits(net(x[idx]), y[idx])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    print(f"classifier trained: final BCE {float(loss.detach()):.4f}")
    net.eval()
    feats = classifier_features_fn(net)

    def extract(imgs, bs=256):
        return np.concatenate([host(feats(imgs[i:i + bs]))
                               for i in range(0, len(imgs), bs)]
                              ).astype(np.float64)
    return extract


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--num-data", type=int, default=4096)
    ap.add_argument("--nsamples", type=int, default=512)
    ap.add_argument("--model-channels", type=int, default=32,
                    help="128 = the reference's CIFAR-scale width")
    ap.add_argument("--expansion", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="use 1e-4 at 128ch (1e-3 diverges there)")
    ap.add_argument("--classifier-fid", action="store_true",
                    help="also score in trained-classifier feature space")
    ap.add_argument("--log-dir", default="runs/sampler_comparison")
    ap.add_argument("--out",
                    default="docs/artifacts/sampler_comparison.json")
    add_device_flag(ap)
    args = ap.parse_args()

    from diffsci_tpu_torch.data import ShapesDataset
    from diffsci_tpu_torch.metrics import fid
    from diffsci_tpu_torch.models import (EMATracker, KarrasModel,
                                          KarrasModelConfig, PUNetG,
                                          PUNetGConfig, default_optimizer)
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
    state, _ = fit_karras(
        model, xs, batch_size=args.batch_size,
        max_epochs=args.steps,  # outer bound only; max_steps terminates
        max_steps=args.steps, ema=ema, val_fraction=0.05,
        optimizer=default_optimizer(args.lr),
        log_dir=args.log_dir, device=device)
    use_weights(model, state.ema_variables(ema))

    cls_feat = None
    if args.classifier_fid:
        cls_feat = train_classifier_features(xs, xlabels, device)

    real_f = features(held_out)
    real_cf = cls_feat(held_out) if cls_feat else None
    results = {}
    gen = torch.Generator(device).manual_seed(11)
    for label, integ, nsteps, nfe in GRID:
        samples = host(model.sample(args.nsamples, (args.size, args.size, 1),
                                    gen, nsteps=nsteps, integrator=integ,
                                    maximum_batch_size=256))
        score = float(fid(real_f, features(samples)))
        results[label] = {"integrator": integ, "nsteps": nsteps,
                          "nfe": nfe, "fid": score}
        if cls_feat:
            results[label]["classifier_fid"] = float(
                fid(real_cf, cls_feat(samples)))
        print(f"{label}: NFE={nfe} " + ", ".join(
            f"{k}={v}" for k, v in results[label].items()
            if k.endswith("fid")), flush=True)

    claims = {
        "dpm_beats_euler_at_10_nfe":
            results["dpmpp2m@10"]["fid"] < results["euler@10"]["fid"],
        "dpm_beats_euler_at_20_nfe":
            results["dpmpp2m@20"]["fid"] < results["euler@20"]["fid"],
        "dpm20_within_10pct_of_heun19":
            results["dpmpp2m@20"]["fid"]
            < results["heun@10"]["fid"] * 1.10,
    }
    artifact = {
        "dataset": f"shapes_paper_replica_{args.size}",
        "train_steps": int(state.step),
        "nsamples": args.nsamples,
        "model_channels": args.model_channels,
        "feature_space": ("pixel + trained-classifier" if cls_feat
                          else "pixel (relative comparison only)"),
        "results": results,
        "claims": claims,
    }
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=2))
    print(f"wrote {out}; claims={claims}")


if __name__ == "__main__":
    main()
