"""Steps and services of the port's parallel cases, built the same way in
a gloo rank (``tests/_torch_parallel_cases.py``) and in the test process
(the single-process reference): torch only, no JAX. ``place(state)``
places a fresh state (the identity for one process) and ``shard(a)``
takes this rank's part of a global batch."""

from __future__ import annotations

import copy
import types

import numpy as np
import torch

from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                               PUNetGConfig, create_train_state,
                               make_train_step)
from diffsci_tpu_torch.models.nets.mlp import MLPUncond

ENS_CFG = dict(model_channels=8, channel_expansion=(2,),
               number_resnet_downward_block=1, number_resnet_upward_block=1,
               number_resnet_attn_block=1, number_resnet_before_attn_block=1,
               number_resnet_after_attn_block=1, input_channels=3,
               output_channels=1)
VAE_CFG = dict(dimension=2, ch=8, ch_mult=(1, 2), num_res_blocks=1,
               resolution=16, num_groups=4)
# The pins' AdamW: the default (lr 1e-3, wd 1e-4, clip 0.5) with eps 1e-4.
# Adam's first step is lr·g/(|g| + eps): at eps 1e-8 a gradient that is
# zero but for rounding (the key projection's bias under the softmax, or
# any entry within ~1e-7 of zero) moves its parameter by up to ±lr, so no
# two summation orders agree on the parameters at atol 1e-6; at eps 1e-4
# the step stays proportional to the gradient, and the bound holds it.
PIN_ADAM_EPS = 1e-4


def pin_optimizer(learning_rate: float = 1e-3, grad_clip: float = 0.5):
    """AdamW (weight decay 1e-4) after the clip, at eps PIN_ADAM_EPS: the
    default optimizer, or the VAE's at lr 1e-4 and clip 1.0."""
    from diffsci_tpu_torch.models.karras.train import AdamWClip
    return AdamWClip(learning_rate, 1e-4, 0.9, 0.999, grad_clip,
                     eps=PIN_ADAM_EPS)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _numpy(d: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def _whole(state) -> dict:
    """A train state's parameters, made whole where a mesh shards them
    (every rank calls)."""
    from diffsci_tpu_torch.checkpoint import gather_state
    return {k[len("params/"):]: v.numpy().copy()
            for k, v in gather_state(state).items()
            if k.startswith("params/")}


def ensemble_model():
    """F's ensemble/AR configuration at small widths: PUNetGCond, CRPS over
    E = 2 members, two horizons, a 2-step Heun in-step sampler."""
    from diffsci_tpu_torch import PUNetGCond
    from diffsci_tpu_torch.models.karras import ensemble as ens
    cfg = ens.EnsembleKarrasModelConfig.from_karras_config(
        KarrasModelConfig.from_edm(loss_metric="crps",
                                   autoregressive_loss_steps=2,
                                   autoregressive_loss_diffusion_steps=2),
        ensemble_size_train=2)
    net = PUNetGCond(PUNetGConfig(**ENS_CFG), channel_conditional_items=["y"],
                     device="cpu")
    return ens.EnsembleKarrasModel(net, cfg, conditional=True, device="cpu")


def ensemble_step(q, place, shard) -> dict:
    """One step of ``make_ensemble_train_step`` on q's weights, batch
    (x [B, H, W, 2], the window [B, 2, H, W]) and replayed draws."""
    from diffsci_tpu_torch.models.karras import ensemble as ens
    model = ensemble_model()
    model.net.load_state_dict({k: _t(v) for k, v in q["sd"].items()})
    x = _t(q["x"])
    state, tx = create_train_state(model, tuple(x.shape[:3]) + (3,),
                                   seed=None, optimizer=pin_optimizer())
    state = place(state)
    draws = model.draw_tensors(x, 2)
    for name in ("sigma", "eps", "x_T"):
        draws[name].copy_(_t(q[name]))
    step = ens.make_ensemble_train_step(model, tx)
    state, met = step(state, shard(x), {"y": shard(_t(q["ywin"]))},
                      draws=draws)
    return {"loss": float(met["train_loss"]),
            "horizons": [float(met[f"ar_loss_horizon_{i}"])
                         for i in (1, 2)],
            "norm": float(met["grad_norm"]), "params": _whole(state)}


def distill_step(q, place, shard) -> dict:
    """One ``make_distill_step`` update (a 3-step student of an MLP
    teacher) on replayed interval and ε draws."""
    from diffsci_tpu_torch.models.karras import distill
    from diffsci_tpu_torch.models.karras.train import _new_train_state
    model = KarrasModel(MLPUncond(2, (16,), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.net.load_state_dict({k: _t(v) for k, v in q["sd"].items()})
    teacher = distill._teacher_like(model)
    teacher.net.load_state_dict({k: _t(v) for k, v in
                                 q["teacher"].items()})
    tx = pin_optimizer()
    state = place(_new_train_state(model, tx))
    step = distill.make_distill_step(model, tx, 3)
    state, met = step(state, teacher, shard(_t(q["x"])), idx=_t(q["idx"]),
                      eps=_t(q["eps"]))
    return {"loss": float(met["distill_loss"]),
            "norm": float(met["grad_norm"]), "params": _whole(state)}


def vae_model():
    from diffsci_tpu_torch.models.nets.vaenet import VAENet, VAENetConfig
    from diffsci_tpu_torch.models.vae.module import (NLayerDiscriminator,
                                                     VAEModel, VAEModelConfig)
    # a threshold above 1 keeps the discriminator's gate open at step 0
    return VAEModel(VAENet(VAENetConfig(**VAE_CFG), device="cpu"),
                    VAEModelConfig(loss_preprocessor="edges",
                                   discriminator_threshold=1.5),
                    discriminator=NLayerDiscriminator(ndf=8, n_layers=2,
                                                      device="cpu"),
                    device="cpu")


def vae_step(q, place, shard) -> dict:
    """One ``make_vae_train_step`` with the discriminator on, from seed 0,
    on a replayed z-noise (both networks under the VAE's default AdamW at
    the pins' eps)."""
    from diffsci_tpu_torch.models.vae.module import (create_vae_train_state,
                                                     make_vae_train_step)
    model = vae_model()
    x = _t(q["x"])
    state, tx, dtx = create_vae_train_state(
        model, x.shape, seed=0, optimizer=pin_optimizer(1e-4, 1.0),
        disc_optimizer=pin_optimizer(1e-4, 1.0))
    state = place(state)
    state, met = make_vae_train_step(model, tx, dtx)(state, shard(x),
                                                      eps=_t(q["eps"]))
    return {"loss": float(met["train_loss"]),
            "disc_loss": float(met["discriminator_loss"]),
            "gate": float(met["disc_updated"]),
            "params": _numpy(state.params),
            "disc_params": _numpy(state.disc_params)}


def service_models(q) -> dict:
    """label -> (model, service kwargs with "shape", requests (nsamples,
    seed)): a Karras service plain and with the dispatcher (a request of
    two chunks in each), a 1-NFE service and a DDIM one."""
    from diffsci_tpu_torch.models.ddpm import (ClassicalDDPMScheduler,
                                               DDIMIntegrator, DDPMModel,
                                               DDPMModelConfig)

    def karras():
        model = KarrasModel(MLPUncond(2, (8,), device="cpu"),
                            KarrasModelConfig.from_edm(), device="cpu")
        model.init(0)
        return model
    sch = ClassicalDDPMScheduler(T=50)
    ddpm = DDPMModel(MLPUncond(3, hidden_dims=(16,), device="cpu"),
                     DDPMModelConfig(sch, DDIMIntegrator(sch)), device="cpu")
    ddpm.init(1)
    base = dict(shape=(2,), batch_buckets=(4, 8), nsteps=3)
    return {
        "plain": (karras(), dict(base), [(6, 11), (10, 7), (3, 4)]),
        "batched": (karras(), dict(base, batch_window_ms=5.0),
                    [(6, 11), (3, 4)]),
        "onestep": (karras(), dict(base, nsteps=1), [(5, 2)]),
        "ddpm": (ddpm, dict(shape=(3,), batch_buckets=(4,), nsteps=50),
                 [(4, 3)])}


def spatial_step(q, mesh=None) -> dict:
    """A PUNetG train step (EDM, mse) on q's weights, batch and replayed σ
    and ε, then one from a generator; over ``mesh`` a data × spatial step
    (``shard_state_spatial`` and ``shard_batch``'s slabs), else the
    single-process one."""
    from diffsci_tpu_torch.parallel import shard_batch, shard_state_spatial
    cfg = PUNetGConfig(**q["cfg"])
    model = KarrasModel(PUNetG(cfg, device="cpu"),
                        KarrasModelConfig.from_edm(loss_metric="mse"),
                        device="cpu")
    model.net.load_state_dict({k: _t(v) for k, v in q["sd"].items()})
    x = _t(q["x"])
    state, tx = create_train_state(model, x.shape, seed=None,
                                   optimizer=pin_optimizer())
    if mesh is not None:
        shard_state_spatial(state, mesh, x.shape)
        x = shard_batch(x, mesh)
    step = make_train_step(model, tx)
    state, met = step(state, x, sigma=_t(q["sigma"]), eps=_t(q["eps"]))
    out = {"loss": float(met["train_loss"]), "norm": float(met["grad_norm"]),
           "params": _numpy(state.params)}
    state, met = step(state, x, generator=torch.Generator().manual_seed(3))
    out.update(gen_loss=float(met["train_loss"]),
               gen_params=_numpy(state.params))
    return out


def _spatial_line(mesh):
    from diffsci_tpu_torch.parallel.tensor_parallel import Line
    return Line(mesh, "spatial")


def gathered_attention_check(mesh) -> float:
    """The gathered attention with the kernels' gate lowered (the flash
    path: K4 forward, K5/K6 backward, their plain versions on the CPU) on
    slabs of the tokens, against the whole attention: the largest error
    of O and of dq, dk, dv over their scale."""
    from diffsci_tpu_torch.kernels import flash_attention
    from diffsci_tpu_torch.parallel.spatial import _GatheredAttention
    line = _spatial_line(mesh)
    g = torch.Generator().manual_seed(0)
    q, k, v, w = (torch.randn((2, 2, 32, 8), generator=g) for _ in range(4))
    T = q.shape[2] // line.n
    gate, flash_attention.MIN_TOKENS = flash_attention.MIN_TOKENS, 1
    try:
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        whole = flash_attention.flash_attention(*leaves)
        (whole * w).sum().backward()
        slabs = [t.narrow(2, line.rank * T, T).clone().requires_grad_()
                 for t in (q, k, v)]
        o = _GatheredAttention.apply(*slabs, line, True)
        (o * w.narrow(2, line.rank * T, T)).sum().backward()
    finally:
        flash_attention.MIN_TOKENS = gate
    errs = [float((o - whole.narrow(2, line.rank * T, T)).abs().max()
                  / whole.abs().max())]
    for s, a in zip(slabs, leaves):
        ref = a.grad.narrow(2, line.rank * T, T)
        errs.append(float((s.grad - ref).abs().max() / ref.abs().max()))
    return max(errs)


def plain_norms_check(mesh) -> dict:
    """The plain group-norm path (G < C; not affine) and GroupPix on slabs
    against the whole tensor: name -> the largest error of y, dx and the
    parameters' gradients (summed over the ranks) over their scale."""
    import torch.distributed as dist

    from diffsci_tpu_torch.models.nets.layers import (GroupLNorm,
                                                      GroupPixNorm,
                                                      GroupRMSNorm)
    from diffsci_tpu_torch.parallel.spatial import _norm_forward
    line = _spatial_line(mesh)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 8, 8, 6), generator=g) * 2 + 0.3
    w = torch.randn((2, 8, 8, 6), generator=g)
    L = x.shape[2] // line.n
    out = {}
    for name, norm in (("ln", GroupLNorm(2, 8, fuse_silu=True)),
                       ("rms", GroupRMSNorm(2, 8)),
                       ("ln_plain", GroupLNorm(8, 8, affine=False,
                                               fuse_silu=True)),
                       ("pix", GroupPixNorm(2, 8))):
        if norm.affine:
            with torch.no_grad():
                norm.weight.copy_(torch.randn(8, generator=g) * 0.2 + 1)
                norm.bias.copy_(torch.randn(8, generator=g) * 0.1)
        xw = x.clone().requires_grad_()
        y = norm(xw)
        (y * w).sum().backward()
        ours = copy.deepcopy(norm)
        ours.zero_grad()
        ours._spatial = line
        ours.forward = types.MethodType(_norm_forward, ours)
        xs = x.narrow(2, line.rank * L, L).clone().requires_grad_()
        ys = ours(xs)
        (ys * w.narrow(2, line.rank * L, L)).sum().backward()
        errs = [float((ys - y.narrow(2, line.rank * L, L)).abs().max()
                      / y.abs().max()),
                float((xs.grad - xw.grad.narrow(2, line.rank * L, L))
                      .abs().max() / xw.grad.abs().max())]
        for p, ref in zip(ours.parameters(), norm.parameters()):
            grad = p.grad.clone()
            dist.all_reduce(grad, group=line.group)
            errs.append(float((grad - ref.grad).abs().max()
                              / ref.grad.abs().max()))
        out[name] = max(errs)
    return out
