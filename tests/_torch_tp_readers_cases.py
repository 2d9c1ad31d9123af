"""The cases of ``tests/test_torch_tp_readers.py`` that run in each gloo
rank (``tests/_torch_ranks.py``; torch only, no JAX), and the steps they
share with the single-process reference the test computes in its own
process (``mesh`` None there)."""

from __future__ import annotations

import numpy as np
import torch

from diffsci_tpu_torch.checkpoint import gather_state
from diffsci_tpu_torch.models.nets import dasc
from diffsci_tpu_torch.models.nets.layers import init_parameters
from diffsci_tpu_torch.models.nets.vae import AutoencoderKL, DDConfig
from diffsci_tpu_torch.models.nets.vaenet import VAENet, VAENetConfig
from diffsci_tpu_torch.models.vae.module import (VAEModel, VAEModelConfig,
                                                 create_vae_train_state,
                                                 make_vae_train_step)
from diffsci_tpu_torch.parallel import (make_mesh, shard_batch,
                                        shard_state_tensor_parallel)
from diffsci_tpu_torch.parallel.placement import Placement
from diffsci_tpu_torch.parallel.tensor_parallel import \
    shard_params_tensor_parallel
from tests._torch_ranks import cases
from tests._torch_steps import pin_optimizer

# tensor_min_size of the cases: the attention blocks' width (ch 8 ×
# ch_mult[-1] 2 = 16) and DASC's num_videos (8), so the layers that the
# attention and the self-representation read are column-parallel
TP_MIN = 16
DASC_MIN = 8
DASC_CFG = dict(in_channels=1, frame_height=16, frame_width=16,
                frames_per_video=2, latent_dim=8, num_videos=8,
                encoder_channels=(4, 8), vmm_hidden_dim=8, vmm_num_layers=1)


def autoencoder(name: str):
    """A small autoencoder whose attention is 16 channels wide, at its 8²
    level and (LDM's) in its mid block: LDM's with single-head
    (``vanilla``) or linear attention, or VAENet (its 1×1 convolutions
    held in ``_Conv`` wrappers)."""
    if name == "vaenet":
        return VAENet(VAENetConfig(dimension=2, ch=8, ch_mult=(1, 2),
                                   num_res_blocks=1, resolution=16,
                                   num_groups=4, attn_resolutions=(8,)),
                      device="cpu")
    return AutoencoderKL(DDConfig(resolution=16, ch=8, ch_mult=(1, 2),
                                  num_res_blocks=1, attn_type=name,
                                  attn_resolutions=(8,)),
                         embed_dim=4, device="cpu")


def dp_tp_mesh(world: int):
    return make_mesh(axes=("data", "tensor"), shape=(world // 2, 2),
                     device_type="cpu")


def vae_step(q, name: str, mesh=None) -> dict:
    """One VAE train step (MSE reconstruction and KL, the pins' AdamW)
    from seed 0 on q's batch and z-noise; over ``mesh`` the state is
    placed data × tensor parallel at ``TP_MIN``."""
    model = VAEModel(autoencoder(name),
                     VAEModelConfig(reconstruction_loss="mse"),
                     device="cpu")
    x = torch.from_numpy(q["x"])
    eps = torch.from_numpy(np.random.default_rng(1).standard_normal(
        model.latent_shape(x.shape)).astype(np.float32))
    state, tx, _ = create_vae_train_state(model, x.shape, seed=0,
                                          optimizer=pin_optimizer(1e-4, 1.0))
    if mesh is not None:
        shard_state_tensor_parallel(state, mesh, min_size=TP_MIN)
        x = shard_batch(x, mesh)
    state, met = make_vae_train_step(model, tx)(
        state, x, eps=eps)
    specs = state.placement.specs if state.placement is not None else {}
    return {"loss": float(met["train_loss"]),
            "norm": float(met["grad_norm"]) if "grad_norm" in met else None,
            "params": {k[len("params/"):]: v.numpy().copy()
                       for k, v in gather_state(state).items()
                       if k.startswith("params/")},
            "tp": sorted(k for k, s in specs.items() if "tensor" in s)}


def dasc_step(q, mesh=None) -> dict:
    """DASC's second-stage loss over every video (``all_videos_mode``)
    and its gradients, from ``init_parameters(net, 0)``; over ``mesh``
    (data × tensor, the data axis 1: the self-representation couples
    every video, so each rank holds them all) its layers column-parallel
    at ``DASC_MIN``, the gradients gathered whole."""
    cfg = dasc.DASCConfig(**DASC_CFG)
    net = dasc.DASC(cfg, device="cpu")
    init_parameters(net, 0)
    specs = {}
    if mesh is not None:
        specs = shard_params_tensor_parallel(net, mesh, min_size=DASC_MIN)
    x = torch.from_numpy(q["videos"])
    total, _ = dasc.dasc_loss(cfg, net(x, all_videos_mode=True), x)
    total.backward()
    grads = {k: p.grad for k, p in net.named_parameters()}
    if mesh is not None:
        placed = Placement(mesh, (), specs)
        grads = {k: placed.whole(g, specs[k]) for k, g in grads.items()}
    return {"loss": float(total.detach()),
            "grads": {k: g.numpy().copy() for k, g in grads.items()},
            "tp": sorted(k for k, s in specs.items() if s)}


def payload() -> dict:
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((4, 1, 16, 16)).astype(np.float32),
            "videos": rng.standard_normal((8, 2, 1, 16, 16)).astype(
                np.float32)}


def case_vae(name):
    return lambda rank, world, p: vae_step(p, name, dp_tp_mesh(world))


def case_dasc(rank, world, p):
    mesh = make_mesh(axes=("data", "tensor"), shape=(1, world),
                     device_type="cpu")
    return dasc_step(p, mesh)


CASES = {"vae_vanilla": case_vae("vanilla"), "vae_linear": case_vae("linear"),
         "vae_vaenet": case_vae("vaenet"), "dasc": case_dasc}


def run(rank, world, payload):
    return cases(CASES, rank, world, payload)
