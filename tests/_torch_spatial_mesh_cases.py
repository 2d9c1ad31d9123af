"""The cases of ``tests/test_torch_spatial_mesh.py`` that run in each gloo
rank (``tests/_torch_ranks.py``; torch only, no JAX): the dp × spatial
step of configurations D (the porosity-conditioned 3D PUNetG with
circular convolutions and the EDM batch norm), E (magnitude-preserving
convolutions, cosine attention, the dynamic loss weight) and PUNetGCond
(channel conditions, one broadcast row), at small widths."""

from __future__ import annotations

import numpy as np
import torch

from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                               PUNetGCond, PUNetGConfig, create_train_state,
                               make_train_step)
from diffsci_tpu_torch.parallel import (make_mesh, shard_batch,
                                        shard_state_spatial)
from tests._torch_ranks import cases

# name -> (the KarrasModelConfig.from_edm fields, conditional, the step's
# has_mp_weights)
KINDS = {"d": (dict(has_edm_batch_norm=True), True, False),
         "e": (dict(dynamic_loss_weight=16), False, True),
         "cond": ({}, True, False)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _numpy(d: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def pin_model(name: str, cfg: dict):
    """The port's model of pin ``name`` at the PUNetG fields ``cfg``."""
    from diffsci_tpu_torch.models.nets.embedders import PorosityEmbedder
    config, conditional, _ = KINDS[name]
    pcfg = PUNetGConfig(**cfg)
    if name == "d":
        net = PUNetG(pcfg, conditional_embedding=PorosityEmbedder(8),
                     device="cpu")
    elif name == "cond":
        net = PUNetGCond(pcfg, channel_conditional_items=["c"],
                         device="cpu")
    else:
        net = PUNetG(pcfg, device="cpu")
    return KarrasModel(net, KarrasModelConfig.from_edm(**config),
                       conditional=conditional, device="cpu")


def condition(name: str, q: dict, mesh=None):
    """The pin's condition (the network's layout), this rank's part of it
    over ``mesh``: D's porosity rows, PUNetGCond's channels-first
    condition of one broadcast row."""
    if name == "d":
        y = {"porosity": _t(q["y"])}
        return y if mesh is None else shard_batch(y, mesh)
    if name == "cond":
        y = {"c": _t(q["y"])}
        return y if mesh is None else shard_batch(y, mesh,
                                                  channels_first=True)
    return None


def pin_step(name: str, q: dict, mesh=None) -> dict:
    """One step of pin ``name`` on q's weights, batch and replayed σ and
    ε: the single-process step, or over ``mesh`` the dp × spatial one."""
    from tests._torch_steps import pin_optimizer
    model = pin_model(name, q["cfg"])
    model.net.load_state_dict({k: _t(v) for k, v in q["sd"].items()})
    x = _t(q["x"])
    state, tx = create_train_state(model, x.shape, seed=None,
                                   optimizer=pin_optimizer())
    if mesh is not None:
        shard_state_spatial(state, mesh, x.shape)
        x = shard_batch(x, mesh)
    step = make_train_step(model, tx, has_mp_weights=KINDS[name][2])
    state, met = step(state, x, condition(name, q, mesh),
                      sigma=_t(q["sigma"]), eps=_t(q["eps"]))
    return {"loss": float(met["train_loss"]), "norm": float(met["grad_norm"]),
            "params": _numpy(state.params),
            "buffers": _numpy(dict(model.net.named_buffers())),
            "slab": tuple(x.shape)}


def _mesh(world):
    return make_mesh(axes=("data", "spatial"), shape=(world // 2, 2),
                     device_type="cpu")


def case_d(rank, world, p):
    return pin_step("d", p["d"], _mesh(world))


def case_e(rank, world, p):
    return pin_step("e", p["e"], _mesh(world))


def case_cond(rank, world, p):
    return pin_step("cond", p["cond"], _mesh(world))


def case_channels_first(rank, world, p):
    """``shard_batch(..., channels_first=True)``: the slab of dim 2 of a
    [B, C, *spatial] array, a one-row array's row on every data rank."""
    mesh = _mesh(world)
    a = torch.arange(4 * 3 * 8 * 2.0).reshape(4, 3, 8, 2)
    one = a[:1]
    got = shard_batch({"a": a, "one": one, "n": a.numpy()}, mesh,
                      channels_first=True)
    d, s = mesh.get_local_rank("data"), mesh.get_local_rank("spatial")
    rows = slice(d * 4 // (world // 2), (d + 1) * 4 // (world // 2))
    assert torch.equal(got["a"], a[rows, :, 4 * s:4 * s + 4])
    assert np.array_equal(got["n"], a.numpy()[rows, :, 4 * s:4 * s + 4])
    assert torch.equal(got["one"], one[:, :, 4 * s:4 * s + 4])
    return True


CASES = {"d": case_d, "e": case_e, "cond": case_cond,
         "channels_first": case_channels_first}


def run(rank, world, payload):
    return cases(CASES, rank, world, payload)
