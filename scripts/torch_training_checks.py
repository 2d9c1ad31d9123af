#!/usr/bin/env python3
"""Two checks behind choices in ``chip_smoke.py``'s phases 27 and 29, on
one CUDA card.

1. Distilling configuration B (MNIST PUNetG, bf16 over f32 masters, a
   fixed batch of 256 random images): phase 0's 20 losses (17 student
   steps, Heun teacher) for a teacher of random weights and for the same
   net after 50 and 200 of its train steps on the batch, at learning
   rates 1e-4, 3e-4 and 1e-3. Shows whether Adam's first distill steps
   overshoot, and which teacher phase 27 needs.
2. Training G's autoencoder (``AutoencoderKL(DDConfig())`` with
   ``NLayerDiscriminator(ndf=64, n_layers=3)``, f32, batch 8 of 256²)
   and a small VAENet: three steps of two arms from the same weights and
   z-noise, eager against eager and graphed against eager, with cuDNN's
   default and its deterministic algorithms; prints per step whether the
   metrics, the parameters and the discriminator's parameters agree bit
   for bit.

Run from the repository root: ``python3 scripts/torch_training_checks.py``
(about a minute on an H100; it builds the kernels first).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def distill_losses():
    from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                                   PUNetGConfig, create_train_state,
                                   make_train_step)
    from diffsci_tpu_torch.models.karras import distill

    cfg = PUNetGConfig(model_channels=64, channel_expansion=[2, 4])

    def model_b():
        return KarrasModel(PUNetG(cfg), KarrasModelConfig.from_edm(),
                           compute_dtype=torch.bfloat16)

    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(256, 28, 28, 1, generator=gen, device="cuda")
    trained = model_b()
    teachers = {"untrained": {k: v.clone() for k, v in
                              trained.init(seed=0).items()}}
    state, tx = create_train_state(trained, tuple(x.shape), seed=None)
    step = make_train_step(trained, tx)
    for n in range(1, 201):
        step(state, x, generator=gen)
        if n in (50, 200):
            teachers[f"trained {n} steps"] = {
                k: v.detach().clone()
                for k, v in trained.net.state_dict().items()}

    def batches():
        while True:
            yield x

    for label, weights in teachers.items():
        for lr in (1e-4, 3e-4, 1e-3):
            _, hist = distill.distill_progressive(
                model_b(), weights, batches(),
                torch.Generator("cuda").manual_seed(5), start_nsteps=17,
                final_nsteps=17, steps_per_phase=20, learning_rate=lr)
            losses = np.array(hist[0]["losses"])
            print(f"distill B, teacher {label}, lr {lr:.0e}: mean loss "
                  f"first five {losses[:5].mean():.5g}, last five "
                  f"{losses[-5:].mean():.5g}; losses "
                  f"{np.round(losses, 5).tolist()}", flush=True)


def vae_agreement():
    from diffsci_tpu_torch import (AutoencoderKL, DDConfig,
                                   NLayerDiscriminator, VAEModel,
                                   VAEModelConfig, VAENet, VAENetConfig,
                                   create_vae_train_state,
                                   make_vae_train_step)

    def make(kind):
        if kind == "G's AutoencoderKL":
            return VAEModel(AutoencoderKL(DDConfig(), embed_dim=4),
                            VAEModelConfig(discriminator_frequency=2),
                            discriminator=NLayerDiscriminator(
                                ndf=64, n_layers=3)), (8, 1, 256, 256)
        cfg = VAENetConfig(dimension=2, ch=8, ch_mult=(1, 2),
                           num_res_blocks=1, resolution=16, num_groups=4)
        return VAEModel(VAENet(cfg), VAEModelConfig(
            adversarial_weight=0.05, discriminator_frequency=2,
            loss_preprocessor="edges", total_variation_weight=0.1),
            discriminator=NLayerDiscriminator(ndf=8, n_layers=2)), \
            (2, 1, 16, 16)

    for kind in ("G's AutoencoderKL", "a small VAENet with edges and TV"):
        for graphed in (False, True):
            for deterministic in (False, True):
                torch.backends.cudnn.deterministic = deterministic
                arms = []
                for g in (False, graphed):
                    model, shape = make(kind)
                    x = torch.randn(shape, device="cuda",
                                    generator=torch.Generator("cuda")
                                    .manual_seed(0))
                    st, tx, dtx = create_vae_train_state(model, shape,
                                                         seed=0)
                    arms.append((model, st, make_vae_train_step(
                        model, tx, dtx, _raw=not g), x))
                gen = torch.Generator("cuda").manual_seed(1)
                rows = []
                for _ in range(3):
                    model, _, _, x = arms[0]
                    eps = torch.randn(model.latent_shape(x.shape),
                                      generator=gen, device="cuda")
                    mets = [s(st, x, eps=eps)[1] for _, st, s, x in arms]
                    (_, a, _, _), (_, b, _, _) = arms
                    rows.append((
                        all(torch.equal(mets[0][n], mets[1][n])
                            for n in mets[0]),
                        all(torch.equal(a.params[n], b.params[n])
                            for n in a.params),
                        all(torch.equal(a.disc_params[n], b.disc_params[n])
                            for n in a.disc_params)))
                print(f"VAE {kind}: {'graphed' if graphed else 'eager'} "
                      f"against eager, cudnn.deterministic {deterministic}:"
                      f" (metrics, params, discriminator) equal a step "
                      f"{rows}", flush=True)
    torch.backends.cudnn.deterministic = False


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_training_checks: needs a CUDA card", file=sys.stderr)
        return 2
    from diffsci_tpu_torch import kernels

    kernels.load_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    distill_losses()
    vae_agreement()
    return 0


if __name__ == "__main__":
    sys.exit(main())
