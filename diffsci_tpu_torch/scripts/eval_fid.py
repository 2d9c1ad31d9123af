"""FID/KID evaluation of a trained diffusion checkpoint.

Port of ``scripts/eval_fid.py``: sample the model, embed real and
generated images with a feature network, and compute FID (+ KID) in
feature space; the result is one JSON line on standard output.

Feature network, in priority order:
- ``--inception-weights path/to/pt_inception-2015-12-05.pth``: the
  pytorch-fid InceptionV3 (``metrics_inception``), whose FID numbers are
  comparable with published Inception-FID scores.
- ``--classifier DIR``: a ``MinimalResNet`` checkpoint (``DIR/description.json``
  its keyword arguments, ``DIR/state.pt`` its state dict as
  ``checkpoint.save_checkpoint`` writes a dict of tensors).
- neither: raw-pixel FID (features = flattened images), a consistent
  relative metric across checkpoints of one run, not comparable to
  Inception-FID numbers.

Usage:
    python -m diffsci_tpu_torch.scripts.eval_fid --ckpt runs/mnist-edm/ckpt
        [--data mnist.npz] [--nsamples 500] [--nfe 18] [--batch 100]
        [--seed 42] [--classifier runs/clf/ckpt] [--stochastic --gamma 1.0]
        [--device cuda]

``--gamma`` sets the Langevin churn strength (the scheduler's
``langevin_const``), as the stochasticity study's FID-against-γ grids do.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from diffsci_tpu_torch.scripts._common import (add_device_flag, host,
                                               use_weights)
from diffsci_tpu_torch.utils import resolve_device


def load_real(path: str | None, n: int) -> np.ndarray:
    if path:
        arr = np.load(path)
        xs = arr["x"] if hasattr(arr, "files") else arr
        xs = np.asarray(xs, np.float32)
        if xs.ndim == 3:
            xs = xs[..., None]
        if xs.max() > 2.0:
            xs = xs / 127.5 - 1.0
        return xs[:n]
    # synthetic fallback: blobs (keeps the pipeline runnable end-to-end)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    cx = rng.uniform(8, 20, size=(n, 1, 1))
    cy = rng.uniform(8, 20, size=(n, 1, 1))
    r = rng.uniform(3, 6, size=(n, 1, 1))
    img = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r ** 2)))
    return (img * 2.0 - 1.0)[..., None].astype(np.float32)


def restore(args, device):
    """The checkpoint's model with the weights to evaluate loaded:
    (model, the restored state, a label of the weights)."""
    from diffsci_tpu_torch.checkpoint import (load_description,
                                              restore_checkpoint)
    from diffsci_tpu_torch.models import (EMATracker, KarrasModel,
                                          KarrasModelConfig, PUNetG,
                                          PUNetGConfig, create_train_state)
    desc = load_description(args.ckpt) or {}
    if desc.get("net"):
        # a self-contained description rebuilds the net AND its math (a
        # VP/VE checkpoint scored under an EDM preconditioner is wrong)
        from diffsci_tpu_torch.models import karras_model_from_description
        model = karras_model_from_description(desc, device=device)
    else:
        cfg = PUNetGConfig(model_channels=args.channels,
                           channel_expansion=[2, 4])
        model = KarrasModel(PUNetG(cfg, device=device),
                            KarrasModelConfig.from_edm(), device=device)
    # the template mirrors the training state (train_diffusion_mnist:
    # power EMA [0.05, 0.1])
    tracker = EMATracker(ema_type="power",
                         power_function_stds=args.ema_stds or [0.05])
    template, _ = create_train_state(
        model, (2, 28, 28, 1), seed=None,
        ema=tracker if args.ema_stds else None)
    state = restore_checkpoint(args.ckpt, template, model)
    if args.ema_stds and not args.no_ema:
        use_weights(model, state.ema_variables(tracker))
        weights = f"EMA std={args.ema_stds[0]}"
    else:
        weights = "raw"
    return model, state, weights


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data", default=None)
    ap.add_argument("--nsamples", type=int, default=500)
    ap.add_argument("--nfe", type=int, default=18)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--classifier", default=None,
                    help="MinimalResNet checkpoint for feature-space FID")
    ap.add_argument("--inception-weights", default=None,
                    help="pt_inception-2015-12-05.pth for reference-"
                         "comparable Inception-FID")
    ap.add_argument("--fld", action="store_true",
                    help="also compute the native FLD (metrics.fld): the "
                         "real features are split into fit/test halves, "
                         "mirroring the reference's train/test MNIST split "
                         "(test-diffusion-mnist-fld-fid.py:211-292)")
    ap.add_argument("--stochastic", action="store_true")
    ap.add_argument("--gamma", type=float, default=0.0,
                    help="Langevin churn strength (stochasticity sweep)")
    ap.add_argument("--ema-stds", type=float, nargs="*",
                    default=[0.05, 0.1],
                    help="EMA profiles in the checkpoint (train script "
                         "default); pass none if trained without EMA")
    ap.add_argument("--no-ema", action="store_true",
                    help="evaluate raw weights instead of EMA profile 0")
    add_device_flag(ap)
    args = ap.parse_args()

    from diffsci_tpu_torch import ops
    from diffsci_tpu_torch.metrics import fid, kid

    device = resolve_device(args.device)
    model, state, weights = restore(args, device)
    print(f"restored step {int(state.step)} from {args.ckpt} ({weights})")

    # γ enters through the scheduler's Langevin constant, as in the
    # stochasticity study
    stochastic = args.stochastic or args.gamma > 0
    if args.gamma > 0:
        model.config.noisescheduler = ops.EDMScheduler(
            langevin_const=args.gamma)

    gen_rng = torch.Generator(device).manual_seed(args.seed)
    samples = []
    for i in range(0, args.nsamples, args.batch):
        n = min(args.batch, args.nsamples - i)
        out = model.sample(n, (28, 28, 1), gen_rng, nsteps=args.nfe,
                           stochastic=stochastic)
        samples.append(host(out))
        print(f"  sampled {i + n}/{args.nsamples}", flush=True)
    gen = np.concatenate(samples)[:args.nsamples]
    real = load_real(args.data, args.nsamples)

    if args.inception_weights:
        from diffsci_tpu_torch import metrics_inception as mi
        net = mi.load_weights(args.inception_weights, device=device)
        f_real = mi.inception_fid_features(net, real * 0.5 + 0.5)
        f_gen = mi.inception_fid_features(net, gen * 0.5 + 0.5)
        space = "inception_pool3"
    elif args.classifier:
        from diffsci_tpu_torch.checkpoint import load_description, load_state
        from diffsci_tpu_torch.metrics import classifier_features_fn
        from diffsci_tpu_torch.models.nets.classifiers import MinimalResNet
        ckpt_dir = pathlib.Path(args.classifier).absolute()
        clf = MinimalResNet(**(load_description(ckpt_dir) or {}),
                            device=device)
        clf.load_state_dict(load_state(ckpt_dir))
        feat_fn = classifier_features_fn(clf)
        f_real = host(feat_fn(real))
        f_gen = host(feat_fn(gen))
        space = "classifier"
    else:
        f_real = real.reshape(len(real), -1)
        f_gen = gen.reshape(len(gen), -1)
        space = "pixel"

    result = {
        "fid": float(fid(f_real, f_gen)),
        "kid": float(kid(f_real, f_gen)),
        "feature_space": space,
        "nsamples": args.nsamples,
        "nfe": args.nfe,
        "stochastic": bool(stochastic),
        "gamma": args.gamma,
        "seed": args.seed,
        "gen_mean": float(gen.mean()), "gen_std": float(gen.std()),
        "real_mean": float(real.mean()), "real_std": float(real.std()),
    }
    if args.fld:
        from diffsci_tpu_torch.metrics import fld, fld_generalization_gap
        half = len(f_real) // 2
        result["fld"] = float(fld(f_real[:half], f_real[half:], f_gen,
                                  device=device))
        result["fld_gen_gap"] = float(
            fld_generalization_gap(f_real[:half], f_gen, device=device))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
