"""The cases of ``tests/test_torch_fsdp.py`` that run in each gloo rank
(``tests/_torch_ranks.py``; torch only, no JAX), and the steps they share
with the single-process reference the test computes in its own process
(``place`` places a fresh state, the identity for one process; ``shard``
takes this rank's part of a global batch)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                               PUNetGConfig, create_train_state,
                               make_train_step)
from diffsci_tpu_torch.checkpoint import gather_state
from diffsci_tpu_torch.models.nets.mlp import MLPUncond
from diffsci_tpu_torch.parallel import (make_mesh, shard_batch,
                                        shard_state_fsdp)
from tests._torch_ranks import cases

# a small 2D PUNetG with bottleneck attention: convolution weights
# [out, in, k, k], the attention's packed projection and its out_proj
# (read by the attention module's own forward)
PUNET = dict(model_channels=8, channel_expansion=(2,),
             number_resnet_downward_block=1, number_resnet_upward_block=1,
             number_resnet_attn_block=2, number_resnet_before_attn_block=1,
             number_resnet_after_attn_block=1, num_heads=2)
MIN = 64         # min_elements of the cases' FSDP specs


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _numpy(d: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def whole_params(state) -> dict:
    """A state's parameters made whole (every rank calls when placed)."""
    return {k[len("params/"):]: v.numpy().copy()
            for k, v in gather_state(state).items()
            if k.startswith("params/")}


def mlp_model(sd, hidden, compute_dtype=None):
    model = KarrasModel(MLPUncond(2, hidden, device="cpu"),
                        KarrasModelConfig.from_edm(loss_metric="mse"),
                        device="cpu", compute_dtype=compute_dtype)
    model.net.load_state_dict({k: _t(v) for k, v in sd.items()})
    return model


def punet_model(cfg=None, seed=0, **config):
    model = KarrasModel(PUNetG(PUNetGConfig(**(cfg or PUNET)), device="cpu"),
                        KarrasModelConfig.from_edm(**config), device="cpu")
    model.init(seed)
    return model


def fsdp(mesh, **kw):
    return lambda state: shard_state_fsdp(state, mesh, min_elements=MIN,
                                          **kw)


def data_mesh():
    return make_mesh(device_type="cpu")


def rows(mesh):
    return lambda a: shard_batch(a, mesh)


@contextlib.contextmanager
def counted_gathers():
    """Inside it, the all-gathers FSDP makes (``gathers``) and, of those,
    the backward's gathers of a weight autograd kept as its block
    (``regathers``)."""
    from diffsci_tpu_torch.parallel import fsdp as fsdp_module
    counts = {"gathers": 0, "regathers": 0}
    real = fsdp_module._all_gather, fsdp_module._unpack

    def gather(part, dim, line):
        counts["gathers"] += 1
        return real[0](part, dim, line)

    def unpack(packed, outer):
        counts["regathers"] += isinstance(packed, fsdp_module._Saved)
        return real[1](packed, outer)
    fsdp_module._all_gather, fsdp_module._unpack = gather, unpack
    try:
        yield counts
    finally:
        fsdp_module._all_gather, fsdp_module._unpack = real


# ---------------------------------------------------------------------------
# steps run the same way in a rank and in the test process
# ---------------------------------------------------------------------------
def punet_steps(q, place, shard) -> dict:
    """Two steps of the small PUNetG (f32, the pins' AdamW) on q's batch
    and replayed draws; the bytes its network's parameters hold between
    steps; the gathers its forward and backward make."""
    from tests._torch_steps import pin_optimizer
    model = punet_model()
    state, tx = create_train_state(model, q["px"].shape, seed=None,
                                   optimizer=pin_optimizer())
    whole = {k: v.numel() * v.element_size()
             for k, v in state.params.items()}
    state = place(state)
    step = make_train_step(model, tx)
    with counted_gathers() as counts:
        for k in range(2):
            state, met = step(state, shard(_t(q["px"])),
                              sigma=_t(q["psigma"][k]),
                              eps=_t(q["peps"][k]))
    held = sum(p.numel() * p.element_size()
               for p in model.net.parameters())
    specs = state.placement.specs if state.placement is not None else {}
    moments = sum(t.numel() * t.element_size()
                  for slot in state.optimizer.state.values()
                  for t in slot.values() if t.ndim)
    return {"loss": float(met["train_loss"]),
            "norm": float(met["grad_norm"]), "params": whole_params(state),
            "held": held, "moments": moments, "whole": whole, "specs": specs,
            "sharded": sorted(k for k, s in specs.items() if "data" in s),
            **counts}


def order_steps(q, place, shard) -> dict:
    """The MLP with a sharded layer that the loss never reaches, stepped
    with ``remat``, then twice under ``accumulate_gradients(tx, 2)``: every
    rank runs the same gathers and reduce-scatters in the same order.
    Under ``remat`` the backward gathers the weights again: neither the
    forward nor the checkpoint's recomputation kept them whole."""
    from diffsci_tpu_torch.models.karras.train import (accumulate_gradients,
                                                       default_optimizer)
    out = {}
    for label, remat, every in (("remat", True, 1), ("accum", False, 2)):
        model = mlp_model(q["mlp"], [64, 64])
        model.net.model.unused = nn.Linear(64, 64)
        nn.init.ones_(model.net.model.unused.weight)
        nn.init.ones_(model.net.model.unused.bias)
        state, tx = create_train_state(
            model, (32, 2), seed=None,
            optimizer=accumulate_gradients(default_optimizer(), every))
        state = place(state)
        step = make_train_step(model, tx, remat=remat)
        losses = []
        with counted_gathers() as counts:
            for k in range(every):
                state, met = step(state, shard(_t(q["x"])),
                                  sigma=_t(q["sigma"][k]),
                                  eps=_t(q["eps"][k]))
                losses.append(float(met["train_loss"]))
        out[label] = {"losses": losses, "norm": float(met["grad_norm"]),
                      "params": whole_params(state), **counts}
    return out


def sample_and_eval(q, mesh=None) -> dict:
    """Samples (f32 and at a bf16 compute dtype: the cast copy of the
    blocks) and the eval step's loss of the MLP, on one process, or every
    rank of an FSDP state (and ``sample(mesh=...)``'s rows)."""
    from diffsci_tpu_torch.models.karras.train import make_eval_step
    out = {}
    for cd in (None, torch.bfloat16):
        model = mlp_model(q["mlp"], [64, 64], cd)
        state, _ = create_train_state(model, (32, 2), seed=None)
        if mesh is not None:
            fsdp(mesh)(state)
        key = str(cd)
        out[key] = model.sample(8, (2,), torch.Generator().manual_seed(4),
                                nsteps=4).numpy()
        if mesh is not None:
            out[key + " mesh"] = model.sample(
                8, (2,), torch.Generator().manual_seed(4), nsteps=4,
                mesh=mesh).numpy()
        x = _t(q["x"])
        ev = make_eval_step(model)(state, x if mesh is None else
                                   shard_batch(x, mesh),
                                   sigma=_t(q["sigma"][0]),
                                   eps=_t(q["eps"][0]))
        out[key + " eval"] = float(ev["valid_loss"])
        out[key + " service"] = _serve(model, mesh)
    return out


def _serve(model, mesh):
    """``SamplerService`` of the model (over ``mesh``: rank 0 serves, the
    others follow) at bucket 8 and seed 11; None on a follower."""
    from diffsci_tpu_torch.serving import SamplerService
    svc = SamplerService(model, (2,), batch_buckets=(8,), nsteps=3,
                         mesh=mesh, device="cpu")
    if mesh is not None and mesh.get_rank() != 0:
        svc.follow()
        return None
    out = svc.sample(8, 11)
    svc.close()
    return out


def mp_steps(q, place, shard) -> dict:
    """E's options at small width (magnitude-preserving convolutions,
    cosine attention, the dynamic loss weight): one step with the mp
    re-projection, whose blocks normalize alone (dim 0 shards) or sum
    their squares over the ranks (the others)."""
    from tests._torch_steps import pin_optimizer
    model = punet_model(dict(PUNET, convolution_type="mp",
                             attn_type="cosine"), seed=1,
                        dynamic_loss_weight=16)
    state, tx = create_train_state(model, q["px"].shape, seed=None,
                                   optimizer=pin_optimizer())
    state = place(state)
    step = make_train_step(model, tx, has_mp_weights=True)
    state, met = step(state, shard(_t(q["px"])), sigma=_t(q["psigma"][0]),
                      eps=_t(q["peps"][0]))
    specs = state.placement.specs if state.placement is not None else {}
    return {"loss": float(met["train_loss"]),
            "norm": float(met["grad_norm"]), "params": whole_params(state),
            "dims": sorted({s.index("data") for s in specs.values()
                            if "data" in s})}


def checkpoint_run(q, mesh, directory) -> tuple:
    """``Trainer(mesh=)`` over the FSDP∘TP MLP (or one process): two steps,
    the EMA's validation, a checkpoint at step 2. Returns (the state, its
    log, the fresh template placed the same way)."""
    from diffsci_tpu_torch import CheckpointManager, EMATracker, Trainer
    from diffsci_tpu_torch.models.karras.train import make_eval_step

    def fresh():
        model = mlp_model(q["mlp128"], [128, 128])
        tracker = EMATracker(decay=0.5)
        state, tx = create_train_state(model, (32, 2), seed=None,
                                       ema=tracker)
        if mesh is not None:
            shard_state_fsdp(state, mesh, min_elements=MIN,
                             tensor_axis="tensor", tensor_min_size=64)
        return model, tracker, state, tx

    model, tracker, state, tx = fresh()
    x = _t(q["x"])
    trainer = Trainer(max_steps=2, mesh=mesh, seed=3, log_every=1,
                      checkpoint_manager=CheckpointManager(directory),
                      device="cpu")
    state = trainer.fit(state, make_train_step(model, tx, ema=tracker),
                        [x, x.flip(0)],
                        make_eval_step(model, ema=tracker, use_ema=True),
                        [x])
    return state, trainer.logger.history, fresh()[2]


# a small MoE-DiT (4 experts in its second block): experts_w1 [4, 32, 128]
# and experts_w2 [4, 128, 32] over (expert, data), its dense layers over
# data alone
MOE = dict(nembed=32, nheads=2, nblocks=2, patch_size=2, nchannels=1,
           n_experts=4, moe_every=2)
TOKENS = ("data", "expert")


def moe_model(sd):
    from diffsci_tpu_torch.models.nets.moe import MoEDiffusionTransformer
    model = KarrasModel(MoEDiffusionTransformer(**MOE, device="cpu"),
                        KarrasModelConfig.from_edm(loss_metric="mse"),
                        device="cpu")
    model.net.load_state_dict({k: _t(v) for k, v in sd.items()})
    return model


def moe_step(q, place, shard) -> dict:
    """One step of the small MoE-DiT (f32, the pins' AdamW) on q's batch
    and replayed draws; the bytes the network's parameters and AdamW's
    moments hold on this rank after it."""
    from tests._torch_steps import pin_optimizer
    model = moe_model(q["moe"])
    state, tx = create_train_state(model, q["mx"].shape, seed=None,
                                   optimizer=pin_optimizer())
    state = place(state)
    state, met = make_train_step(model, tx)(
        state, shard(_t(q["mx"])), sigma=_t(q["msigma"]),
        eps=_t(q["meps"]))
    held = sum(p.numel() * p.element_size()
               for p in model.net.parameters())
    moments = sum(t.numel() * t.element_size()
                  for slot in state.optimizer.state.values()
                  for t in slot.values() if t.ndim)
    specs = state.placement.specs if state.placement is not None else {}
    return {"loss": float(met["train_loss"]),
            "norm": float(met["grad_norm"]), "params": whole_params(state),
            "held": held, "moments": moments, "specs": dict(specs),
            "state": state}


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------
def case_fsdp_tp(rank, world, p):
    """FSDP composed with tensor parallelism on a (world / 2, 2) data ×
    tensor mesh: the MLP [128, 128] of the JAX test at its sizes."""
    mesh = make_mesh(axes=("data", "tensor"), shape=(world // 2, 2),
                     device_type="cpu")
    model = mlp_model(p["mlp128"], [128, 128])
    state, tx = create_train_state(model, (32, 2), seed=None)
    shard_state_fsdp(state, mesh, min_elements=MIN, tensor_axis="tensor",
                     tensor_min_size=64)
    step = make_train_step(model, tx)
    state, met = step(state, shard_batch(_t(p["x"]), mesh),
                      sigma=_t(p["sigma"][0]), eps=_t(p["eps"][0]))
    return {"loss": float(met["train_loss"]),
            "norm": float(met["grad_norm"]), "params": whole_params(state),
            "specs": dict(state.placement.specs),
            "local": {k: tuple(v.shape) for k, v in state.params.items()}}


def case_punet(rank, world, p):
    mesh = data_mesh()
    return punet_steps(p, fsdp(mesh), rows(mesh))


def case_punet_tp(rank, world, p):
    """FSDP∘TP on the small PUNetG at tensor_min_size 16: its
    convolutions and the attention's ``out_proj`` (a ``Linear`` that the
    attention module calls) column-parallel."""
    mesh = make_mesh(axes=("data", "tensor"), shape=(world // 2, 2),
                     device_type="cpu")
    out = punet_steps(p, fsdp(mesh, tensor_axis="tensor",
                              tensor_min_size=16), rows(mesh))
    specs = out.pop("specs")
    out["tp"] = sorted(k for k, s in specs.items() if "tensor" in s)
    return out


def case_order(rank, world, p):
    mesh = data_mesh()
    return order_steps(p, fsdp(mesh), rows(mesh))


def case_sample(rank, world, p):
    return sample_and_eval(p, data_mesh())


def case_mp(rank, world, p):
    mesh = data_mesh()
    return mp_steps(p, fsdp(mesh), rows(mesh))


def case_mp_renorm(rank, world, p):
    """The mp re-projection of blocks against the whole tensors': raw
    weights off the sphere, re-projected by each rank on its blocks, then
    gathered; and the whole network re-projected in one process."""
    from diffsci_tpu_torch.models.karras.train import renormalize_mp_weights
    out = {}
    for placed in (False, True):
        model = punet_model(dict(PUNET, convolution_type="mp",
                                 attn_type="cosine"), seed=2)
        with torch.no_grad():
            for prm in model.net.parameters():
                prm.mul_(1.7)
        state, _ = create_train_state(model, p["px"].shape, seed=None)
        if placed:
            fsdp(data_mesh())(state)
        renormalize_mp_weights(model.net)
        out[placed] = whole_params(state)
    return out


def case_checkpoint(rank, world, p):
    """``Trainer(mesh=)`` checkpoints of the FSDP∘TP state: whole tensors,
    restored into a fresh placed state at world N (the test restores
    them at world 1)."""
    import os

    from diffsci_tpu_torch.checkpoint import restore_checkpoint
    mesh = make_mesh(axes=("data", "tensor"), shape=(world // 2, 2),
                     device_type="cpu")
    directory = os.path.join(p["ckpt_dir"], f"{world}")
    state, log, fresh = checkpoint_run(p, mesh, directory)
    restore_checkpoint(os.path.join(directory, "2"), fresh)

    def whole(s):
        return {k: v.numpy().copy() for k, v in gather_state(s).items()}
    return {"log": log, "live": whole(state), "again": whole(fresh),
            "directory": os.path.join(directory, "2")}


def case_reads(rank, world, p):
    """A sharded parameter read, or written in place, through its module
    attribute outside the network's forward: each raises (a write would
    land on a gathered copy); the block is ``_parameters``'s."""
    model = punet_model()
    state, _ = create_train_state(model, p["px"].shape, seed=None)
    fsdp(data_mesh())(state)
    conv = next(m for m in model.net.modules()
                if "weight" in m.__dict__.get("_fsdp", {}))
    out = {"block": tuple(conv._parameters["weight"].shape)}
    for label, act in (("read", lambda: conv.weight),
                       ("init", lambda: nn.init.zeros_(conv.weight)),
                       ("model_init", lambda: model.init(3))):
        try:
            act()
            out[label] = "no error"
        except RuntimeError as e:
            out[label] = str(e)
    return out


def case_placed_steps(rank, world, p):
    """The ensemble and distill steps on an FSDP state; the VAE state
    refuses FSDP."""
    from tests._torch_steps import distill_step, ensemble_step, vae_model
    from diffsci_tpu_torch.models.vae.module import create_vae_train_state
    mesh = data_mesh()
    out = {"ensemble_step": ensemble_step(p["ens"], fsdp(mesh), rows(mesh)),
           "distill_step": distill_step(p["distill"], fsdp(mesh),
                                        rows(mesh))}
    state = create_vae_train_state(vae_model(), (4, 1, 16, 16), seed=0)[0]
    try:
        shard_state_fsdp(state, mesh)
    except NotImplementedError:
        out["vae_raises"] = True
    return out


def case_fsdp_ep(rank, world, p):
    """FSDP over an expert-parallel state on a (world / 2, 2) data × expert
    mesh, beside dp × ep alone and ep alone (a 1D expert mesh of the
    world): one step of the small MoE-DiT each; the FSDP∘EP state's
    checkpoint (whole tensors); FSDP over a state placed on an axis it
    does not compose with raises."""
    import os

    from diffsci_tpu_torch.checkpoint import load_state, save_checkpoint
    from diffsci_tpu_torch.parallel import (shard_state_expert_parallel,
                                            shard_state_tensor_parallel)
    mesh = make_mesh(axes=TOKENS, shape=(world // 2, 2), device_type="cpu")
    ep_mesh = make_mesh(axes=("expert",), device_type="cpu")

    def fsdp_ep(state):
        shard_state_expert_parallel(state, mesh)
        return shard_state_fsdp(state, mesh, min_elements=MIN,
                                existing_specs=state.placement.specs)

    out = {}
    for label, place, m in (
            ("fsdp_ep", fsdp_ep, mesh),
            ("ep", lambda s: shard_state_expert_parallel(s, mesh), mesh),
            ("ep_1d", lambda s: shard_state_expert_parallel(
                s, ep_mesh, data_axis=None), ep_mesh)):
        axes = tuple(a for a in TOKENS if a in m.mesh_dim_names)
        out[label] = moe_step(p, place, lambda a: shard_batch(a, m, axes))
    state = out["fsdp_ep"].pop("state")
    out["fsdp_ep"]["local"] = {k: tuple(v.shape)
                               for k, v in state.params.items()}
    directory = os.path.join(p["ckpt_dir"], f"moe{world}")
    save_checkpoint(directory, state)
    dist.barrier()
    out["fsdp_ep"]["saved"] = {k[len("params/"):]: v.numpy()
                               for k, v in load_state(directory).items()
                               if k.startswith("params/")}
    for label in ("ep", "ep_1d"):
        del out[label]["state"]
    tp_mesh = make_mesh(axes=("data", "tensor"), shape=(world // 2, 2),
                        device_type="cpu")
    model = mlp_model(p["mlp128"], [128, 128])
    tp_state, _ = create_train_state(model, (32, 2), seed=None)
    shard_state_tensor_parallel(tp_state, tp_mesh, "tensor", min_size=64)
    try:
        shard_state_fsdp(tp_state, tp_mesh, min_elements=MIN)
    except NotImplementedError as e:
        out["raises"] = str(e)
    return out


CASES = {"fsdp_tp": case_fsdp_tp, "fsdp_ep": case_fsdp_ep,
         "punet": case_punet,
         "punet_tp": case_punet_tp, "order": case_order,
         "sample": case_sample, "mp": case_mp, "mp_renorm": case_mp_renorm,
         "checkpoint": case_checkpoint, "placed_steps": case_placed_steps,
         "reads": case_reads}


def run(rank, world, payload):
    return cases(CASES, rank, world, payload)
