"""One-command reproduction of the reference's MNIST FID study.

Port of ``scripts/repro_reference_fid.py``. The reference's published
quality numbers (BASELINE.md; the reference's
scripts/testing/mnist_fld_fid_results_500_samples_seed_42/fid_scores.txt)
come from test-diffusion-mnist-fld-fid.py: PUNetG model_channels=128,
500 samples, seed 42, nsteps=500, the deterministic Heun ODE and an SDE
γ sweep. Targets:

    FID 46.356   ODE (Heun), epoch-199 checkpoint   (fid_scores.txt:16)
    FID 44.694   SDE gamma=3.0, epoch-99 checkpoint (fid_scores.txt:10)
    FID 40.171   SDE gamma=1.0, epoch-499 (best)    (fid_scores.txt:34)

With real MNIST (and optionally the pt_inception weights) the parity
claim is one command:

    python -m diffsci_tpu_torch.scripts.repro_reference_fid --data mnist.npz
        [--inception-weights pt_inception-2015-12-05.pth]
        [--steps 60000] [--outdir runs/repro-fid] [--device cuda]

It (1) trains the reference configuration from scratch (or restores
``--ckpt``), (2) samples 500 images at seed 42 with the ODE sampler and
the SDE at γ in {1.0, 3.0}, (3) scores FID against the real data and
prints each number beside its reference target. ``data/mnist.npz`` and
``data/pt_inception-2015-12-05.pth`` are found under the working
directory or the repository's root without the flags.

Without ``--data`` it runs on synthetic blobs, and without
``--inception-weights`` FID is computed on raw pixels: both keep the
pipeline exercised end to end (``--smoke``) but the numbers are not
comparable to the targets, as the printout says.
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

# reference eval protocol (test-diffusion-mnist-fld-fid.py:372-374)
TARGETS = [
    ("ode_heun", 0.0, 46.356, "epoch-199, fid_scores.txt:16"),
    ("sde_gamma1.0", 1.0, 40.171, "epoch-499 best, fid_scores.txt:34"),
    ("sde_gamma3.0", 3.0, 44.694, "epoch-99, fid_scores.txt:10"),
]
ROOT = pathlib.Path(__file__).resolve().parents[2]


def load_mnist(path: str | None, n_synth: int = 2048) -> np.ndarray:
    if path is not None:
        arr = np.load(path)
        x = arr["x"] if hasattr(arr, "files") and "x" in arr else (
            arr[arr.files[0]] if hasattr(arr, "files") else arr)
        x = np.asarray(x, np.float32)
        if x.ndim == 3:
            x = x[..., None]
        if x.max() > 2.0:
            x = x / 255.0
        return x * 2.0 - 1.0
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    cx = rng.uniform(8, 20, size=(n_synth, 1, 1))
    cy = rng.uniform(8, 20, size=(n_synth, 1, 1))
    r = rng.uniform(3, 6, size=(n_synth, 1, 1))
    img = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r ** 2)))
    return (img * 2.0 - 1.0)[..., None].astype(np.float32)


def build(args, device):
    """The reference training configuration: (model, EMA tracker,
    optimizer). PUNetG at ``--channels`` with expansion [2, 4], EDM;
    AdamW lr 1e-3, weight decay 1e-4 (karrasmodule.py:497-500), clip 0.5
    (train-diffusion-cifar10.py:92); power EMA [0.05, 0.1]."""
    from diffsci_tpu_torch.models import (EMATracker, KarrasModel,
                                          KarrasModelConfig, PUNetG,
                                          PUNetGConfig, default_optimizer)
    cfg = PUNetGConfig(model_channels=args.channels,
                       channel_expansion=[2, 4])
    model = KarrasModel(PUNetG(cfg, device=device),
                        KarrasModelConfig.from_edm(), device=device)
    ema = EMATracker(ema_type="power", power_function_stds=[0.05, 0.1])
    return model, ema, default_optimizer(1e-3, 1e-4, grad_clip=0.5)


def _find(args) -> None:
    """Fill ``--data`` and ``--inception-weights`` from the files' usual
    places when they were not given: the day real data lands, the same
    command produces the numbers."""
    if args.data is None:
        for cand in (pathlib.Path("data/mnist.npz"),
                     ROOT / "data" / "mnist.npz"):
            if cand.exists():
                args.data = str(cand)
                print(f"found real data at {cand}")
                break
    if args.inception_weights is None:
        for cand in (pathlib.Path("data/pt_inception-2015-12-05.pth"),
                     ROOT / "data" / "pt_inception-2015-12-05.pth"):
            if cand.exists():
                args.inception_weights = str(cand)
                print(f"found inception weights at {cand}")
                break


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", default=None, help="mnist.npz (array 'x')")
    ap.add_argument("--ckpt", default=None,
                    help="skip training, evaluate this checkpoint dir")
    ap.add_argument("--steps", type=int, default=60000,
                    help="training budget; the reference's epoch-199 "
                         "checkpoint at batch 64 over 60k MNIST images "
                         "is ~187k steps — more steps, better FID")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--channels", type=int, default=128,
                    help="reference study config "
                         "(test-diffusion-mnist-fld-fid.py:372)")
    ap.add_argument("--nsamples", type=int, default=500)
    ap.add_argument("--nfe", type=int, default=500,
                    help="reference study nsteps "
                         "(test-diffusion-mnist-fld-fid.py:373)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--inception-weights", default=None,
                    help="pt_inception-2015-12-05.pth for "
                         "reference-comparable Inception-FID")
    ap.add_argument("--outdir", default="runs/repro-fid")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny everything (CI smoke: synthetic data, "
                         "8ch net, 50 steps, 16 samples, 6 NFE)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    if args.smoke:
        args.channels, args.steps = 8, 50
        args.nsamples, args.nfe, args.batch = 16, 6, 16
    _find(args)

    from diffsci_tpu_torch import ops
    from diffsci_tpu_torch.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from diffsci_tpu_torch.metrics import fid_from_samples
    from diffsci_tpu_torch.models import (KarrasModel, KarrasModelConfig,
                                          PUNetG, create_train_state)
    from diffsci_tpu_torch.trainer import fit_karras

    device = resolve_device(args.device)
    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    xs = load_mnist(args.data)
    source = args.data or ("SYNTHETIC — numbers not comparable to "
                           "reference targets")
    print(f"data: {xs.shape} (source: {source})")

    model, ema, tx = build(args, device)
    if args.ckpt:
        template, _ = create_train_state(model, (2, 28, 28, 1), seed=None,
                                         ema=ema)
        state = restore_checkpoint(args.ckpt, template, model)
        print(f"restored step {int(state.step)} from {args.ckpt}")
    else:
        state, _ = fit_karras(
            model, xs, batch_size=args.batch,
            max_epochs=max(1, args.steps
                           // max(1, len(xs) // args.batch) + 1),
            max_steps=args.steps, ema=ema, optimizer=tx, log_dir=outdir,
            device=device)
        save_checkpoint(outdir / "ckpt", state,
                        description=model.export_description())
        print(f"trained {int(state.step)} steps -> {outdir}/ckpt")

    use_weights(model, state.ema_variables(ema, profile_index=0))

    # feature space for FID
    if args.inception_weights:
        from diffsci_tpu_torch import metrics_inception as mi
        inception = mi.load_weights(args.inception_weights, device=device)

        def feats_fn(x):
            # the features take [0, 1] images, as eval_fid gives them (the
            # JAX script passes its [-1, 1] images as they are)
            return mi.inception_fid_features(inception, x * 0.5 + 0.5)
        space = "inception (reference-comparable)"
    else:
        def feats_fn(x):
            return np.asarray(x).reshape(x.shape[0], -1)
        space = "raw pixel (NOT comparable to reference targets)"
    print(f"FID feature space: {space}")

    real = xs[np.random.default_rng(args.seed).permutation(len(xs))
              [:max(args.nsamples, 500 if not args.smoke else 16)]]

    results = {}
    for name, gamma, target, src in TARGETS:
        # γ enters through the scheduler's Langevin constant, the
        # reference's sweep knob (its schedulers.py:45,219-240), on a
        # model of its own holding the same weights
        m = model
        if gamma > 0:
            m = KarrasModel(PUNetG(model.net.model.config, device=device),
                            KarrasModelConfig.from_edm(), device=device)
            m.net.load_state_dict(model.net.state_dict())
            m.config.noisescheduler = ops.EDMScheduler(langevin_const=gamma)
        gen = torch.Generator(device).manual_seed(args.seed)
        fake = host(m.sample(args.nsamples, (28, 28, 1), gen,
                             nsteps=args.nfe, stochastic=gamma > 0,
                             maximum_batch_size=100))
        score = fid_from_samples(real, fake, feats_fn)
        results[name] = float(score)
        print(f"{name:14s} FID {score:9.3f}   reference target {target:7.3f}"
              f"  ({src})")

    (outdir / "fid_results.json").write_text(json.dumps({
        "results": results,
        "targets": {n: t for n, _, t, _ in TARGETS},
        "feature_space": space,
        "data": args.data,
        "nsamples": args.nsamples, "nfe": args.nfe, "seed": args.seed,
        "steps_trained": int(state.step)}, indent=1))
    print(f"wrote {outdir}/fid_results.json")
    return results


if __name__ == "__main__":
    main()
