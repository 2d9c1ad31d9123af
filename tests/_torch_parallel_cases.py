"""The cases of ``tests/test_torch_parallel.py`` that run in each gloo rank
(``tests/_torch_ranks.py``; torch only, no JAX). Weights and inputs come
in the payload as numpy arrays; each case returns numpy results."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig,
                               create_train_state, make_train_step)
from diffsci_tpu_torch.models.nets.mlp import MLPUncond
from diffsci_tpu_torch.parallel import (constrain_batch, fsdp_specs,
                                        gather_batch, initialize_distributed,
                                        make_mesh, replicate, shard_batch,
                                        shard_params_expert_parallel,
                                        shard_state_fsdp,
                                        shard_state_tensor_parallel)
from tests._torch_ranks import cases


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _numpy(d: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def _replay(model, *draws):
    """``model``'s sampler takes ``draws`` (x_T, then its noise: the JAX
    package's) in place of its generator's."""
    values = [_t(a) for a in draws]

    def draw_inputs(inputs, generator, langevin_scale):
        for t in inputs[:2]:
            if t is not None:
                t.copy_(values.pop(0))
        return inputs
    model._draw_inputs = draw_inputs


def _mlp_model(p, hidden, bnorm=False):
    cfg = KarrasModelConfig.from_edm(loss_metric="mse",
                                     has_edm_batch_norm=bnorm)
    model = KarrasModel(MLPUncond(2, hidden, device="cpu"), cfg,
                        device="cpu")
    model.net.load_state_dict({k: _t(v) for k, v in p.items()})
    return model


def _one_step(model, state, tx, p, mesh, axis="data"):
    step = make_train_step(model, tx)
    x = shard_batch(_t(p["x"]), mesh, axis)
    state, met = step(state, x, sigma=_t(p["sigma"]), eps=_t(p["eps"]))
    return state, {"loss": float(met["train_loss"]),
                   "norm": float(met["grad_norm"])}


def case_mesh(rank, world, p):
    mesh = make_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data",) and mesh.shape == (world,)
    assert initialize_distributed() == world      # idempotent
    x = torch.arange(4 * world * 3.0).reshape(4 * world, 3)
    rows = shard_batch({"x": x, "n": x.numpy()}, mesh)
    assert torch.equal(rows["x"], x[4 * rank:4 * rank + 4])
    assert np.array_equal(rows["n"], x.numpy()[4 * rank:4 * rank + 4])
    assert torch.equal(gather_batch(rows["x"], mesh), x)
    try:
        constrain_batch(torch.zeros(4 * world + 1, 2), mesh)
    except ValueError:
        pass
    else:
        raise AssertionError("an indivisible batch did not raise")
    m2 = make_mesh(axes=("data", "tensor"), shape=(world // 2, 2),
                   device_type="cpu")
    assert m2.mesh_dim_names == ("data", "tensor")
    return True


def case_dp_step(rank, world, p):
    mesh = make_mesh(device_type="cpu")
    model = _mlp_model(p["mlp16"], [16])
    state, tx = create_train_state(model, (32, 2), seed=None)
    state = replicate(state, mesh)
    state, out = _one_step(model, state, tx, p, mesh)
    out["params"] = _numpy(state.params)
    return out


def case_bnorm_step(rank, world, p):
    """The EDM batch norm under DP: statistics over every rank's rows."""
    mesh = make_mesh(device_type="cpu")
    model = _mlp_model(p["bnorm"], [16], bnorm=True)
    state, tx = create_train_state(model, (32, 2), seed=None)
    state = replicate(state, mesh)
    pb = dict(p, x=p["x_shifted"])
    state, out = _one_step(model, state, tx, pb, mesh)
    out["params"] = _numpy(state.params)
    out["buffers"] = _numpy(dict(model.net.named_buffers()))
    return out


def _whole(state) -> dict:
    """A placed state's parameters made whole (shards all-gathered)."""
    pl = state.placement
    out = {}
    for name, t in state.params.items():
        spec = pl.specs.get(name, ())
        t = t.detach()
        for d, a in enumerate(spec):
            if a is not None:
                t = gather_batch(t.contiguous(), pl.mesh, a, dim=d)
        out[name] = t.numpy().copy()
    return out


def case_tp_step(rank, world, p):
    mesh = make_mesh(axes=("data", "tensor"), shape=(world // 2, 2),
                     device_type="cpu")
    model = _mlp_model(p["mlp64x2"], [64, 64])
    state, tx = create_train_state(model, (32, 2), seed=None)
    state = shard_state_tensor_parallel(state, mesh, min_size=32)
    assert state.placement.specs["model.net.0.weight"] == ("tensor", None)
    assert tuple(state.params["model.net.0.weight"].shape) == (32, 3)
    state, out = _one_step(model, state, tx, p, mesh)
    out["params"] = _whole(state)
    out["specs"] = dict(state.placement.specs)
    return out


def case_fsdp_step(rank, world, p):
    mesh = make_mesh(device_type="cpu")
    model = _mlp_model(p["mlp64"], [64])
    state, tx = create_train_state(model, (32, 2), seed=None)
    specs = fsdp_specs(state.params, mesh, min_elements=64)
    state = shard_state_fsdp(state, mesh, min_elements=64)
    blocks = {k: state.params[k] for k, s in state.placement.specs.items()
              if "data" in s}
    moment = state.optimizer.state[blocks["model.net.0.weight"]]["exp_avg"]
    assert moment.shape == blocks["model.net.0.weight"].shape
    state, out = _one_step(model, state, tx, p, mesh)
    out["params"] = _whole(state)
    out["specs"] = specs
    out["block_shapes"] = {k: tuple(v.shape) for k, v in blocks.items()}
    return out


def case_tp_conv_step(rank, world, p):
    """dp × tp on a ConVit with strided and transposed convolutions: the
    convolutions' output features (dim 0, a transposed one's dim 1)
    sharded."""
    from diffsci_tpu_torch.models.nets.convit import ConVit, ConVitConfig
    mesh = make_mesh(axes=("data", "tensor"), shape=(world // 2, 2),
                     device_type="cpu")
    model = KarrasModel(ConVit(ConVitConfig(**p["convit_cfg"]),
                               device="cpu"),
                        KarrasModelConfig.from_edm(loss_metric="mse"),
                        device="cpu")
    model.net.load_state_dict({k: _t(v) for k, v in p["convit"].items()})
    state, tx = create_train_state(model, p["conv_x"].shape, seed=None)
    state = shard_state_tensor_parallel(state, mesh, min_size=8)
    step = make_train_step(model, tx)
    x = shard_batch(_t(p["conv_x"]), mesh)
    state, met = step(state, x, sigma=_t(p["conv_sigma"]),
                      eps=_t(p["conv_eps"]))
    return {"loss": float(met["train_loss"]),
            "norm": float(met["grad_norm"]), "params": _whole(state),
            "specs": dict(state.placement.specs)}


def placed_state(p, mode, world):
    """A fresh state of the MLP with an EMA, placed by ``mode`` ("fsdp",
    "tp", or None for one process). Returns (state, tx, model, tracker,
    mesh)."""
    from diffsci_tpu_torch import EMATracker
    model = _mlp_model(p["mlp64x2"], [64, 64])
    tracker = EMATracker(decay=0.5)
    state, tx = create_train_state(model, (32, 2), seed=None, ema=tracker)
    mesh = None
    if mode == "fsdp":
        mesh = make_mesh(device_type="cpu")
        shard_state_fsdp(state, mesh, min_elements=64)
    elif mode == "tp":
        mesh = make_mesh(axes=("data", "tensor"), shape=(world // 2, 2),
                         device_type="cpu")
        shard_state_tensor_parallel(state, mesh, min_size=32)
    return state, tx, model, tracker, mesh


def trained(p, mode, world, directory):
    """``placed_state`` after ``Trainer.fit``'s two steps and its
    validation on the EMA, saved by a ``CheckpointManager`` in
    ``directory`` (at step 2). Returns (the state, the metric log)."""
    from diffsci_tpu_torch import CheckpointManager, Trainer
    from diffsci_tpu_torch.models.karras.train import make_eval_step
    state, tx, model, tracker, mesh = placed_state(p, mode, world)
    x = _t(p["x"])
    trainer = Trainer(max_steps=2, mesh=mesh, seed=3, log_every=1,
                      checkpoint_manager=CheckpointManager(directory),
                      device="cpu")
    state = trainer.fit(state, make_train_step(model, tx, ema=tracker),
                        [x, x.flip(0)],
                        make_eval_step(model, ema=tracker, use_ema=True),
                        [x])
    return state, trainer.logger.history


def whole_state(state) -> dict:
    from diffsci_tpu_torch.checkpoint import gather_state
    return {k: v.numpy().copy() for k, v in gather_state(state).items()}


def case_checkpoint(rank, world, p):
    """``Trainer(mesh=...)`` over an FSDP and a TP state: the EMA
    validation, the checkpoint (whole tensors: the test restores it at
    world size 1), and its restore into a fresh placed state."""
    import os

    from diffsci_tpu_torch.checkpoint import restore_checkpoint
    out = {}
    for mode in ("fsdp", "tp"):
        directory = os.path.join(p["ckpt_dir"], f"{world}", mode)
        state, log = trained(p, mode, world, directory)
        fresh = placed_state(p, mode, world)[0]
        restore_checkpoint(os.path.join(directory, "2"), fresh)
        out[mode] = {"log": log, "live": whole_state(state),
                     "again": whole_state(fresh),
                     "directory": os.path.join(directory, "2")}
    return out


def _moe(p, cf):
    from diffsci_tpu_torch.models.nets.moe import (MoEDiffusionTransformer,
                                                   MoEFeedForward)
    net = MoEDiffusionTransformer(nembed=16, nheads=2, nblocks=2,
                                  patch_size=2, nchannels=1, n_experts=4,
                                  moe_every=2, capacity_factor=cf,
                                  device="cpu")
    net.load_state_dict({k: _t(v) for k, v in p["moe"].items()})
    moe = next(m for m in net.modules() if isinstance(m, MoEFeedForward))
    return net, moe


def case_ep_forward(rank, world, p):
    out = {}
    for cf in (2.0, 0.5):
        mesh = make_mesh(axes=("data", "expert"), shape=(world // 2, 2),
                         device_type="cpu")
        net, moe = _moe(p, cf)
        specs = shard_params_expert_parallel(net, mesh)
        assert sum(1 for s in specs.values() if s) == 4
        assert moe.experts_w1.shape[0] == 2
        axes = ("data", "expert")
        x = shard_batch(_t(p["moe_x"]), mesh, axes)
        t = shard_batch(_t(p["moe_t"]), mesh, axes)
        with torch.no_grad():
            y = gather_batch(net(x, t), mesh, axes)
        out[cf] = {"y": y.numpy(), "dropped": float(moe.dropped_fraction)}
    return out


def case_karras_sampling(rank, world, p):
    mesh = make_mesh(device_type="cpu")
    model = KarrasModel(MLPUncond(3, hidden_dims=(16,), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.init(0)
    out = {}
    for stochastic in (False, True):
        kw = dict(nsteps=8, stochastic=stochastic)
        single = model.sample(16, (3,), torch.Generator().manual_seed(5),
                              **kw)
        sharded = model.sample(16, (3,), torch.Generator().manual_seed(5),
                               mesh=mesh, **kw)
        out[stochastic] = (single.numpy(), sharded.numpy())
    hist = model.sample(16, (3,), torch.Generator().manual_seed(5), nsteps=4,
                        record_history=True, mesh=mesh)
    out["history"] = (model.sample(16, (3,), torch.Generator().manual_seed(5),
                                   nsteps=4, record_history=True).numpy(),
                      hist.numpy())
    try:
        model.sample(9, (3,), nsteps=4, mesh=mesh)
    except ValueError:
        out["raises"] = True
    twin = KarrasModel(MLPUncond(3, hidden_dims=(16,), device="cpu"),
                       KarrasModelConfig.from_edm(), device="cpu")
    twin.net.load_state_dict({k: _t(v) for k, v in p["karras"].items()})
    _replay(twin, p["karras_xT"])
    out["jax"] = twin.sample(16, (3,), nsteps=8, mesh=mesh).numpy()
    return out


class _StubAE:
    """An autoencoder of [B, 3] data: the first two features, and back
    with the first one repeated (the JAX test's ``StubAE``)."""
    sample_posterior = False

    def encode(self, x, eps=None):
        return x[:, :2]

    def decode(self, z):
        return torch.cat([z, z[:, :1]], dim=1)


def case_latent_sampling(rank, world, p):
    """A latent model's ``sample(mesh=...)``, on the JAX package's x_T."""
    mesh = make_mesh(device_type="cpu")
    model = KarrasModel(MLPUncond(2, hidden_dims=(8,), device="cpu"),
                        KarrasModelConfig.from_edm(), autoencoder=_StubAE(),
                        device="cpu")
    model.net.load_state_dict({k: _t(v) for k, v in p["latent"].items()})
    _replay(model, p["latent_xT"])
    sharded = model.sample(16, (3,), nsteps=4, mesh=mesh)
    _replay(model, p["latent_xT"])
    single = model.sample(16, (3,), nsteps=4)
    return single.numpy(), sharded.numpy()


def case_ddpm_sampling(rank, world, p):
    from diffsci_tpu_torch.models.ddpm import (ClassicalDDPMScheduler,
                                               DDIMIntegrator, DDPMModel,
                                               DDPMModelConfig)
    mesh = make_mesh(device_type="cpu")
    sch = ClassicalDDPMScheduler(T=50)
    model = DDPMModel(MLPUncond(3, hidden_dims=(16,), device="cpu"),
                      DDPMModelConfig(sch, DDIMIntegrator(sch)),
                      device="cpu")
    model.init(1)
    single = model.sample(16, (3,), torch.Generator().manual_seed(3))
    sharded = model.sample(16, (3,), torch.Generator().manual_seed(3),
                           mesh=mesh)
    out = {"pair": (single.numpy(), sharded.numpy())}
    try:
        model.sample(9, (3,), mesh=mesh)
    except ValueError:
        out["raises"] = True
    # the JAX package's weights and x_T (DDIM draws no other noise that
    # counts: each step's is scaled by 0)
    from diffsci_tpu_torch.models import ddpm
    model.net.load_state_dict({k: _t(v) for k, v in p["ddpm"].items()})
    x_T = [_t(p["ddpm_xT"])]
    draw = ddpm._draw
    ddpm._draw = lambda t, g: t.copy_(x_T.pop()) if x_T else t.zero_()
    try:
        out["jax"] = model.sample(16, (3,), mesh=mesh).numpy()
    finally:
        ddpm._draw = draw
    return out


def case_si_sampling(rank, world, p):
    from diffsci_tpu_torch.models.si import SIModel, SIModelConfig
    mesh = make_mesh(device_type="cpu")
    si = SIModel(MLPUncond(3, hidden_dims=(16,), device="cpu"),
                 SIModelConfig(scheduler="linear", loss_metric="mse"),
                 device="cpu")
    si.net.model.load_state_dict({k: _t(v) for k, v in p["si"].items()})
    x0 = _t(p["si_x0"])
    out = {"jax_pair": si.sample(16, (3,), nsteps=6, orig_noise=x0,
                                 mesh=mesh).numpy()}
    single = si.sample(16, (3,), torch.Generator().manual_seed(4), nsteps=6,
                       noise_injection=True)
    sharded = si.sample(16, (3,), torch.Generator().manual_seed(4),
                        nsteps=6, noise_injection=True, mesh=mesh)
    out["pair"] = (single.numpy(), sharded.numpy())
    try:
        si.sample(9, (3,), nsteps=2, mesh=mesh)
    except ValueError:
        out["raises"] = True
    return out


def case_onestep(rank, world, p):
    from diffsci_tpu_torch.models.karras.distill import sample_onestep
    mesh = make_mesh(device_type="cpu")
    model = KarrasModel(MLPUncond(3, hidden_dims=(16,), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.init(2)
    single = sample_onestep(model, 8, (3,), torch.Generator().manual_seed(6))
    sharded = sample_onestep(model, 8, (3,),
                             torch.Generator().manual_seed(6), mesh=mesh)
    return single.numpy(), sharded.numpy()


class Decoder(nn.Module):
    """conv 3×3 (2 -> 8), SiLU, 2× nearest upsample, conv 3×3 (8 -> 1),
    zero padding: a receptive radius of 1.5 latent rows, so a halo of 2
    is exact."""

    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        self.w1, self.b1, self.w2, self.b2 = (_t(a) for a in (w1, b1, w2,
                                                              b2))

    def forward(self, z):
        h = F.silu(F.conv2d(z, self.w1, self.b1, padding=1))
        h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return F.conv2d(h, self.w2, self.b2, padding=1)


def case_halo(rank, world, p):
    from diffsci_tpu_torch.extra.chunk_decode import halo_shard_decode
    mesh = make_mesh(axes=("spatial",), device_type="cpu")
    dec = Decoder(*p["decoder"])
    z = _t(p["z"])
    with torch.no_grad():
        out = halo_shard_decode(dec, z, mesh, axis_name="spatial", halo=2,
                                upscale=2)
        ids = torch.arange(-2, z.shape[2] + 2) % z.shape[2]
        full = dec(z.index_select(2, ids))[:, :, 4:-4]
    return out.numpy(), full.numpy()


def case_fit(rank, world, p):
    from diffsci_tpu_torch import fit_karras
    mesh = make_mesh(device_type="cpu")
    model = _mlp_model(p["mlp16"], [16])
    state, trainer = fit_karras(model, p["fit_data"], batch_size=16,
                                max_steps=3, mesh=mesh, seed=3,
                                log_every=1, device="cpu")
    return [row["train_loss"] for row in trainer.logger.history]


CASES = {"mesh": case_mesh, "dp_step": case_dp_step,
         "bnorm_step": case_bnorm_step, "tp_step": case_tp_step,
         "fsdp_step": case_fsdp_step, "ep_forward": case_ep_forward,
         "karras_sampling": case_karras_sampling,
         "ddpm_sampling": case_ddpm_sampling,
         "latent_sampling": case_latent_sampling,
         "tp_conv_step": case_tp_conv_step, "checkpoint": case_checkpoint,
         "si_sampling": case_si_sampling, "onestep": case_onestep,
         "halo": case_halo, "fit": case_fit}


# ---------------------------------------------------------------------------
# every train step synced through its state's placement
# ---------------------------------------------------------------------------
def case_ensemble_step(rank, world, p):
    """F's ensemble/AR step (CRPS over E members, horizon 2, the in-step
    sampler) on a replicated state, on this rank's rows of the replayed
    global draws."""
    from tests._torch_steps import ensemble_step
    mesh = make_mesh(device_type="cpu")
    return ensemble_step(p["ens"], lambda s: replicate(s, mesh),
                         lambda a: shard_batch(a, mesh))


def case_distill_step(rank, world, p):
    from tests._torch_steps import distill_step
    mesh = make_mesh(device_type="cpu")
    return distill_step(p["distill"], lambda s: replicate(s, mesh),
                        lambda a: shard_batch(a, mesh))


def case_vae_step(rank, world, p):
    from tests._torch_steps import vae_step
    mesh = make_mesh(device_type="cpu")
    return vae_step(p["vae"], lambda s: replicate(s, mesh),
                    lambda a: shard_batch(a, mesh))


# ---------------------------------------------------------------------------
# SamplerService(mesh=...)
# ---------------------------------------------------------------------------
def case_mesh_service(rank, world, p):
    """Rank 0 serves, the others follow: plain, dispatcher, 1-NFE, DDPM,
    HTTP, and the JAX service's x_T replayed; the contract's errors."""
    import json
    import threading
    import urllib.request

    from diffsci_tpu_torch.serving import SamplerService, build_server
    from tests._torch_steps import service_models
    mesh = make_mesh(device_type="cpu")
    out = {}
    for label, (model, kw, requests) in service_models(p["svc"]).items():
        svc = SamplerService(model, kw.pop("shape"), mesh=mesh,
                             device="cpu", **kw)
        if rank:
            try:
                svc.sample(2, 1)
            except RuntimeError:
                out["follower_raises"] = True
            svc.follow()
            continue
        svc.warmup()
        out[label] = [svc.sample(n, seed) for n, seed in requests]
        out[label + "_stats"] = dict(svc.stats)
        if label == "plain":
            server = build_server(svc, port=0)
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/sample",
                data=json.dumps({"nsamples": 3, "seed": 5}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                out["http"] = np.asarray(json.loads(r.read())["samples"],
                                         np.float32)
            server.shutdown()
        svc.close()
    # the JAX service's model and x_T (test_serving.py:243-259)
    twin = KarrasModel(MLPUncond(2, hidden_dims=(8,), device="cpu"),
                       KarrasModelConfig.from_edm(), device="cpu")
    twin.net.load_state_dict({k: _t(v) for k, v in p["svc"]["jax"].items()})
    _replay(twin, p["svc"]["jax_xT"])
    svc = SamplerService(twin, (2,), batch_buckets=(8,), nsteps=3, mesh=mesh,
                         device="cpu")
    if rank:
        svc.follow()
    else:
        out["jax"] = svc.sample(8, 11)
        svc.close()
    for kw in ({"batch_buckets": (3, 4)}, {"picard": {"window": 2}}):
        try:
            SamplerService(twin, (2,), nsteps=3, mesh=mesh, device="cpu",
                           **kw)
        except ValueError:
            out[f"raises {sorted(kw)[0]}"] = True
    return out


# ---------------------------------------------------------------------------
# the dp × spatial train step
# ---------------------------------------------------------------------------
def _spatial_case(p, axes, shape):
    from tests._torch_steps import spatial_step
    mesh = make_mesh(axes=axes, shape=shape, device_type="cpu")
    return spatial_step(p, mesh)


def case_spatial_2d(rank, world, p):
    """The JAX test's net (test_parallel.py:170-180) on a (world / 2, 2)
    data × spatial mesh."""
    return _spatial_case(p["sp2d"], ("data", "spatial"), (world // 2, 2))


def case_spatial_attention(rank, world, p):
    """A 3D PUNetG with bottleneck attention on a spatial mesh of every
    rank; then the gathered attention through the flash kernels' path."""
    out = _spatial_case(p["sp3d"], ("spatial",), (world,))
    from tests._torch_steps import gathered_attention_check
    out["flash_path"] = gathered_attention_check(
        make_mesh(axes=("spatial",), device_type="cpu"))
    return out


def case_spatial_circular(rank, world, p):
    """The same 3D net with circular convolutions (the halos wrap)."""
    return _spatial_case(p["sp3dc"], ("spatial",), (world,))


def case_spatial_plain_norms(rank, world, p):
    """The plain group-norm path and GroupPix on slabs against the whole
    tensor, forward and backward."""
    from tests._torch_steps import plain_norms_check
    return plain_norms_check(make_mesh(axes=("spatial",),
                                       device_type="cpu"))


def case_spatial_raises(rank, world, p):
    """What a spatial mesh cannot take raises at placement, or in a step
    other than ``make_train_step``: a network other than PUNetG and
    PUNetGCond (a DiT), an extra residual module, a slab that the
    network's levels do not pool whole, and the distill step on a spatial
    state."""
    from diffsci_tpu_torch import PUNetG, PUNetGConfig
    from diffsci_tpu_torch.models.nets import DiffusionTransformer
    from diffsci_tpu_torch.models.karras import distill
    from diffsci_tpu_torch.parallel import shard_state_spatial
    mesh = make_mesh(axes=("spatial",), device_type="cpu")
    cfg = dict(model_channels=8, channel_expansion=[2])
    shape = (2, 4 * world, 8, 1)

    def state_of(net):
        model = KarrasModel(net, KarrasModelConfig.from_edm(), device="cpu")
        return model, create_train_state(model, shape, seed=0)

    nets = {"dit": DiffusionTransformer(nembed=16, nheads=2, nblocks=1,
                                        patch_size=2, device="cpu"),
            "residual": PUNetG(PUNetGConfig(**cfg),
                               extra_residual=nn.Identity(), device="cpu")}
    out = {}
    for name, net in nets.items():
        _, (state, _) = state_of(net)
        try:
            shard_state_spatial(state, mesh, shape)
        except NotImplementedError:
            out[name] = True
    model, (state, tx) = state_of(PUNetG(PUNetGConfig(**cfg), device="cpu"))
    try:
        shard_state_spatial(state, mesh, (2, world, 8, 1))
    except ValueError:
        out["slab"] = True
    shard_state_spatial(state, mesh, shape)
    x = shard_batch(torch.randn(shape), mesh)
    try:
        distill.make_distill_step(model, tx, 2)(
            state, distill._teacher_like(model), x)
    except NotImplementedError:
        out["distill"] = True
    return out


CASES.update({"ensemble_step": case_ensemble_step,
              "distill_step": case_distill_step,
              "vae_step": case_vae_step, "mesh_service": case_mesh_service,
              "spatial_2d": case_spatial_2d,
              "spatial_attention": case_spatial_attention,
              "spatial_circular": case_spatial_circular,
              "spatial_plain_norms": case_spatial_plain_norms,
              "spatial_raises": case_spatial_raises})


def run(rank, world, payload):
    return cases(CASES, rank, world, payload)
